"""ReadIndex results (ref: raft/read_only.go).

Ports the part of ``etcd_tpu/raft/read_only.py`` that ``BatchedNode``
uses: ``ReadState`` and ``ReadOnlyOption``. On the batched path the
ReadIndex ack sets are ``[N, R]`` masks held by the quorum kernel and
the request contexts stay on the host (``batched/node.py``). The scalar
core's ``ReadOnly`` queue waits for the scalar core's own ROADMAP item.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum


class ReadOnlyOption(IntEnum):
    # Linearizable via quorum heartbeat acks (default).
    ReadOnlySafe = 0
    # Linearizable via leader lease; affected by clock drift.
    ReadOnlyLeaseBased = 1


@dataclass
class ReadState:
    """ref: raft/read_only.go:24-27."""

    index: int
    request_ctx: bytes
