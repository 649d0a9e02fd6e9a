"""RawNode: the synchronous, thread-unsafe facade over the state machine
(ref: raft/rawnode.go), with the Ready and Status shapes of its contract
(ref: raft/node.go:52-90, raft/status.go).

Ports ``etcd_tpu/raft/rawnode.py`` whole. ``BatchedNode`` and raftexample
build the same ``Ready`` and ``Status`` from the device round.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .errors import RaftError, StepLocalMsgError, StepPeerNotFoundError
from .raft import (
    NONE,
    Config,
    Raft,
    SoftState,
    StateType,
    is_local_msg,
    is_response_msg,
)
from .read_only import ReadState
from .tracker import Progress, TrackerConfig, progress_map_str
from .types import (
    ConfChangeV2,
    ConfState,
    Entry,
    EntryType,
    HardState,
    Message,
    MessageType,
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


def new_ready(r: Raft, prev_soft_st: SoftState, prev_hard_st: HardState) -> Ready:
    """ref: raft/node.go:564-584."""
    rd = Ready(
        entries=list(r.raft_log.unstable_entries()),
        committed_entries=r.raft_log.next_ents(),
        messages=r.msgs,
    )
    soft_st = r.soft_state()
    if not soft_st.equal(prev_soft_st):
        rd.soft_state = soft_st
    hard_st = r.hard_state()
    if not (
        hard_st.term == prev_hard_st.term
        and hard_st.vote == prev_hard_st.vote
        and hard_st.commit == prev_hard_st.commit
    ):
        rd.hard_state = hard_st
    if r.raft_log.unstable.snapshot is not None:
        rd.snapshot = r.raft_log.unstable.snapshot
    if r.read_states:
        rd.read_states = r.read_states
    rd.must_sync = must_sync(r.hard_state(), prev_hard_st, len(rd.entries))
    return rd


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


class RawNode:
    """ref: raft/rawnode.go:34-38."""

    def __init__(self, config: Config):
        self.raft = Raft(config)
        self.prev_soft_st = self.raft.soft_state()
        self.prev_hard_st = self.raft.hard_state()

    def tick(self) -> None:
        self.raft.tick()

    def tick_quiesced(self) -> None:
        """Advance only the logical clock (ref: rawnode.go:62-72)."""
        self.raft.election_elapsed += 1

    def campaign(self) -> None:
        self.raft.step(Message(type=MessageType.MsgHup))

    def propose(self, data: bytes) -> None:
        self.raft.step(
            Message(
                type=MessageType.MsgProp,
                from_=self.raft.id,
                entries=[Entry(data=data)],
            )
        )

    def propose_conf_change(self, cc) -> None:
        typ, data = marshal_conf_change(cc)
        self.raft.step(
            Message(type=MessageType.MsgProp, entries=[Entry(type=typ, data=data)])
        )

    def apply_conf_change(self, cc) -> ConfState:
        return self.raft.apply_conf_change(cc.as_v2())

    def step(self, m: Message) -> None:
        # Local messages arriving over the network are invalid.
        if is_local_msg(m.type):
            raise StepLocalMsgError()
        if self.raft.prs.progress.get(m.from_) is not None or not is_response_msg(m.type):
            return self.raft.step(m)
        raise StepPeerNotFoundError()

    def ready(self) -> Ready:
        rd = self.ready_without_accept()
        self.accept_ready(rd)
        return rd

    def ready_without_accept(self) -> Ready:
        return new_ready(self.raft, self.prev_soft_st, self.prev_hard_st)

    def accept_ready(self, rd: Ready) -> None:
        if rd.soft_state is not None:
            self.prev_soft_st = rd.soft_state
        if rd.read_states:
            self.raft.read_states = []
        self.raft.msgs = []

    def has_ready(self) -> bool:
        """Must stay consistent with Ready.contains_updates()
        (ref: rawnode.go:152-170)."""
        r = self.raft
        if not r.soft_state().equal(self.prev_soft_st):
            return True
        hard_st = r.hard_state()
        if not is_empty_hard_state(hard_st) and not (
            hard_st.term == self.prev_hard_st.term
            and hard_st.vote == self.prev_hard_st.vote
            and hard_st.commit == self.prev_hard_st.commit
        ):
            return True
        if r.raft_log.has_pending_snapshot():
            return True
        if r.msgs or r.raft_log.unstable_entries() or r.raft_log.has_next_ents():
            return True
        if r.read_states:
            return True
        return False

    def advance(self, rd: Ready) -> None:
        if not is_empty_hard_state(rd.hard_state):
            self.prev_hard_st = rd.hard_state
        self.raft.advance(rd)

    def status(self) -> Status:
        r = self.raft
        s = Status(basic=self.basic_status())
        if s.basic.soft_state.raft_state == StateType.StateLeader:
            s.progress = {vid: pr.copy() for vid, pr in r.prs.progress.items()}
        s.config = r.prs.config.clone()
        return s

    def basic_status(self) -> BasicStatus:
        r = self.raft
        return BasicStatus(
            id=r.id,
            hard_state=r.hard_state(),
            soft_state=r.soft_state(),
            applied=r.raft_log.applied,
            lead_transferee=r.lead_transferee,
        )

    def report_unreachable(self, vid: int) -> None:
        try:
            self.raft.step(Message(type=MessageType.MsgUnreachable, from_=vid))
        except RaftError:
            pass

    def report_snapshot(self, vid: int, failure: bool) -> None:
        try:
            self.raft.step(
                Message(type=MessageType.MsgSnapStatus, from_=vid, reject=failure)
            )
        except RaftError:
            pass

    def transfer_leader(self, transferee: int) -> None:
        try:
            self.raft.step(Message(type=MessageType.MsgTransferLeader, from_=transferee))
        except RaftError:
            pass

    def read_index(self, rctx: bytes) -> None:
        try:
            self.raft.step(
                Message(type=MessageType.MsgReadIndex, entries=[Entry(data=rctx)])
            )
        except RaftError:
            pass


def marshal_conf_change(cc):
    """(EntryType, data) for a conf change (ref: raftpb/confchange.go:170)."""
    v1, ok = cc.as_v1()
    if ok:
        return EntryType.EntryConfChange, v1.marshal()
    return EntryType.EntryConfChangeV2, cc.as_v2().marshal()
