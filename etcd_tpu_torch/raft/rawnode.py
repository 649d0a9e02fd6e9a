"""The Ready and Status shapes of the RawNode contract (ref: raft/rawnode.go,
raft/node.go:52-90, raft/status.go).

Ports the part of ``etcd_tpu/raft/rawnode.py`` that ``BatchedNode`` and
raftexample use: ``Ready``, ``must_sync``, ``BasicStatus`` and
``Status``. The scalar ``RawNode`` over the scalar state machine waits
for the scalar core's own ROADMAP item; on the batched path
``batched/node.py`` builds these from the device round.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .raft import SoftState, StateType
from .read_only import ReadState
from .tracker import Progress, TrackerConfig
from .types import (
    Entry,
    HardState,
    Message,
    Snapshot,
    is_empty_hard_state,
    is_empty_snap,
)


@dataclass
class Ready:
    """Outstanding work for the application (ref: raft/node.go:52-90)."""

    soft_state: Optional[SoftState] = None
    hard_state: HardState = field(default_factory=HardState)
    read_states: List[ReadState] = field(default_factory=list)
    # To persist BEFORE messages are sent.
    entries: List[Entry] = field(default_factory=list)
    snapshot: Snapshot = field(default_factory=Snapshot)
    committed_entries: List[Entry] = field(default_factory=list)
    # To send AFTER entries are persisted.
    messages: List[Message] = field(default_factory=list)
    must_sync: bool = False

    def contains_updates(self) -> bool:
        return (
            self.soft_state is not None
            or not is_empty_hard_state(self.hard_state)
            or not is_empty_snap(self.snapshot)
            or bool(self.entries)
            or bool(self.committed_entries)
            or bool(self.messages)
            or bool(self.read_states)
        )

    def applied_cursor(self) -> int:
        """Highest index applied once this Ready is confirmed
        (ref: node.go:112-121)."""
        if self.committed_entries:
            return self.committed_entries[-1].index
        if self.snapshot.metadata.index > 0:
            return self.snapshot.metadata.index
        return 0


def must_sync(st: HardState, prevst: HardState, entsnum: int) -> bool:
    """Synchronous fsync needed? (ref: raft/node.go:588-595): term, vote and
    new entries are the durable Raft state."""
    return entsnum != 0 or st.vote != prevst.vote or st.term != prevst.term


@dataclass
class BasicStatus:
    """ref: raft/status.go:33-42."""

    id: int = 0
    hard_state: HardState = field(default_factory=HardState)
    soft_state: SoftState = field(default_factory=SoftState)
    applied: int = 0
    lead_transferee: int = 0


@dataclass
class Status:
    """ref: raft/status.go:26-30."""

    basic: BasicStatus = field(default_factory=BasicStatus)
    config: TrackerConfig = field(default_factory=TrackerConfig)
    progress: Dict[int, Progress] = field(default_factory=dict)

    @property
    def id(self) -> int:
        return self.basic.id

    @property
    def raft_state(self) -> StateType:
        return self.basic.soft_state.raft_state
