"""Wire types for the consensus core (ref: raft/raftpb/raft.proto).

Ports the part of ``etcd_tpu/raft/types.py`` that the batched rawnode
and the message codec use: the message and entry type enums, and the
entry, message and snapshot dataclasses. Field names, defaults and enum
values are the reference's (tests/test_torch_msgblock.py pins them), so
an object of either package reads the same through either package's
rawnode. They are plain dataclasses: on the device path messages travel
as structure-of-arrays tensors and payload bytes stay in a host arena,
so the host object model only carries the fields.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from enum import IntEnum
from typing import List


class MessageType(IntEnum):
    """ref: raft/raftpb/raft.pb.go:76-94 (19 message types)."""

    MsgHup = 0
    MsgBeat = 1
    MsgProp = 2
    MsgApp = 3
    MsgAppResp = 4
    MsgVote = 5
    MsgVoteResp = 6
    MsgSnap = 7
    MsgHeartbeat = 8
    MsgHeartbeatResp = 9
    MsgUnreachable = 10
    MsgSnapStatus = 11
    MsgCheckQuorum = 12
    MsgTransferLeader = 13
    MsgTimeoutNow = 14
    MsgReadIndex = 15
    MsgReadIndexResp = 16
    MsgPreVote = 17
    MsgPreVoteResp = 18

    def __str__(self) -> str:
        return self.name


class EntryType(IntEnum):
    EntryNormal = 0
    EntryConfChange = 1
    EntryConfChangeV2 = 2

    def __str__(self) -> str:
        return self.name


def _varint_size(x: int) -> int:
    n = 1
    while x >= 0x80:
        x >>= 7
        n += 1
    return n


@dataclass
class Entry:
    term: int = 0
    index: int = 0
    type: EntryType = EntryType.EntryNormal
    data: bytes = b""

    def size(self) -> int:
        """Marshaled proto size (ref: raftpb/raft.pb.go:1191 Entry.Size)."""
        n = (3 + _varint_size(self.type) + _varint_size(self.term)
             + _varint_size(self.index))
        if self.data:
            n += 1 + len(self.data) + _varint_size(len(self.data))
        return n

    def payload_size(self) -> int:
        """ref: raft/util.go PayloadSize — size of data only."""
        return len(self.data)

    def clone(self) -> "Entry":
        return replace(self)


@dataclass
class ConfState:
    """ref: raftpb/raft.proto ConfState."""

    voters: List[int] = field(default_factory=list)
    learners: List[int] = field(default_factory=list)
    voters_outgoing: List[int] = field(default_factory=list)
    learners_next: List[int] = field(default_factory=list)
    auto_leave: bool = False


@dataclass
class SnapshotMetadata:
    conf_state: ConfState = field(default_factory=ConfState)
    index: int = 0
    term: int = 0


@dataclass
class Snapshot:
    data: bytes = b""
    metadata: SnapshotMetadata = field(default_factory=SnapshotMetadata)


@dataclass
class Message:
    """ref: raftpb/raft.pb.go:384-402 Message fields."""

    type: MessageType = MessageType.MsgHup
    to: int = 0
    from_: int = 0
    term: int = 0
    log_term: int = 0
    index: int = 0
    entries: List[Entry] = field(default_factory=list)
    commit: int = 0
    snapshot: Snapshot = field(default_factory=Snapshot)
    reject: bool = False
    reject_hint: int = 0
    context: bytes = b""
