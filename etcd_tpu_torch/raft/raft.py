"""The Raft state machine's public names (ref: raft/raft.go).

Ports the part of ``etcd_tpu/raft/raft.py`` that ``BatchedNode`` and
raftexample use: ``NONE``, ``StateType`` and ``SoftState``. The scalar
state machine itself (``Raft``, ``Config``) waits for the scalar core's
own ROADMAP item; on the batched path the consensus math is the device
round (``batched/step.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum

NONE = 0  # placeholder node ID when there is no leader


class StateType(IntEnum):
    StateFollower = 0
    StateCandidate = 1
    StateLeader = 2
    StatePreCandidate = 3

    def __str__(self) -> str:
        return self.name


@dataclass
class SoftState:
    """Volatile state useful for logging/debugging (ref: raft/node.go:60-68)."""

    lead: int = NONE
    raft_state: StateType = StateType.StateFollower

    def equal(self, other: "SoftState") -> bool:
        return self.lead == other.lead and self.raft_state == other.raft_state
