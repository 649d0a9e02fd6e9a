"""ReadIndex protocol bookkeeping (ref: raft/read_only.go).

Ports ``etcd_tpu/raft/read_only.py`` whole: ``ReadState``,
``ReadOnlyOption`` and the scalar core's ``ReadOnly`` queue. On the
batched path the ReadIndex ack sets are ``[N, R]`` masks held by the
quorum kernel and the request contexts stay on the host
(``batched/node.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum
from typing import Dict, List, Optional

from .types import Message


class ReadOnlyOption(IntEnum):
    # Linearizable via quorum heartbeat acks (default).
    ReadOnlySafe = 0
    # Linearizable via leader lease; affected by clock drift.
    ReadOnlyLeaseBased = 1


@dataclass
class ReadIndexStatus:
    req: Message
    index: int
    acks: Dict[int, bool] = field(default_factory=dict)


@dataclass
class ReadState:
    """ref: raft/read_only.go:24-27."""

    index: int
    request_ctx: bytes


class ReadOnly:
    def __init__(self, option: ReadOnlyOption):
        self.option = option
        self.pending_read_index: Dict[bytes, ReadIndexStatus] = {}
        self.read_index_queue: List[bytes] = []

    def add_request(self, index: int, m: Message) -> None:
        ctx = bytes(m.entries[0].data)
        if ctx in self.pending_read_index:
            return
        self.pending_read_index[ctx] = ReadIndexStatus(req=m, index=index)
        self.read_index_queue.append(ctx)

    def recv_ack(self, from_id: int, context: bytes) -> Dict[int, bool]:
        rs = self.pending_read_index.get(bytes(context))
        if rs is None:
            return {}
        rs.acks[from_id] = True
        return rs.acks

    def advance(self, m: Message) -> List[ReadIndexStatus]:
        """Dequeue requests up to and including the one matching m.Context
        (ref: read_only.go:81-112)."""
        ctx = bytes(m.context)
        rss: List[ReadIndexStatus] = []
        found = False
        i = 0
        for okctx in self.read_index_queue:
            i += 1
            rs = self.pending_read_index.get(okctx)
            if rs is None:
                raise RuntimeError("cannot find corresponding read state from pending map")
            rss.append(rs)
            if okctx == ctx:
                found = True
                break
        if found:
            self.read_index_queue = self.read_index_queue[i:]
            for rs in rss:
                del self.pending_read_index[bytes(rs.req.entries[0].data)]
            return rss
        return []

    def last_pending_request_ctx(self) -> bytes:
        if not self.read_index_queue:
            return b""
        return self.read_index_queue[-1]
