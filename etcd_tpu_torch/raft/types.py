"""Wire types for the consensus core (ref: raft/raftpb/raft.proto).

Ports ``etcd_tpu/raft/types.py`` whole: the message, entry and
conf-change enums, the entry, message, snapshot and hard-state
dataclasses, and the conf changes with their protobuf-compatible varint
encoding (empty messages marshal to empty bytes, as
raft/raftpb/confchange.go:170 MarshalConfChange does). Field names,
defaults, enum values and encoded bytes are the reference's
(tests/test_torch_msgblock.py and tests/test_torch_raft_host.py pin
them), so an object of either package reads the same through either
package's code. They are plain dataclasses: on the device path messages
travel as structure-of-arrays tensors and payload bytes stay in a host
arena, so the host object model only carries the fields.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from enum import IntEnum
from typing import List, Optional, Tuple


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


class ConfChangeType(IntEnum):
    ConfChangeAddNode = 0
    ConfChangeRemoveNode = 1
    ConfChangeUpdateNode = 2
    ConfChangeAddLearnerNode = 3

    def __str__(self) -> str:
        return self.name


class ConfChangeTransition(IntEnum):
    ConfChangeTransitionAuto = 0
    ConfChangeTransitionJointImplicit = 1
    ConfChangeTransitionJointExplicit = 2

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

    def equivalent(self, other: "ConfState") -> bool:
        """Compare after sorting (ref: raftpb/confstate.go Equivalent)."""
        return (
            sorted(self.voters) == sorted(other.voters)
            and sorted(self.learners) == sorted(other.learners)
            and sorted(self.voters_outgoing) == sorted(other.voters_outgoing)
            and sorted(self.learners_next) == sorted(other.learners_next)
            and self.auto_leave == other.auto_leave
        )

    def clone(self) -> "ConfState":
        return ConfState(
            voters=list(self.voters),
            learners=list(self.learners),
            voters_outgoing=list(self.voters_outgoing),
            learners_next=list(self.learners_next),
            auto_leave=self.auto_leave,
        )


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


@dataclass
class HardState:
    term: int = 0
    vote: int = 0
    commit: int = 0


EMPTY_HARD_STATE = HardState()


def is_empty_hard_state(hs: HardState) -> bool:
    return hs.term == 0 and hs.vote == 0 and hs.commit == 0


def is_empty_snap(s: Snapshot) -> bool:
    return s.metadata.index == 0


# --- Conf changes (ref: raftpb/confchange.go) ---------------------------------


@dataclass
class ConfChangeSingle:
    type: ConfChangeType = ConfChangeType.ConfChangeAddNode
    node_id: int = 0


@dataclass
class ConfChange:
    """V1 conf change: exactly one operation."""

    id: int = 0
    type: ConfChangeType = ConfChangeType.ConfChangeAddNode
    node_id: int = 0
    context: bytes = b""

    def as_v2(self) -> "ConfChangeV2":
        return ConfChangeV2(
            changes=[ConfChangeSingle(self.type, self.node_id)],
            context=self.context,
        )

    def as_v1(self) -> Tuple[Optional["ConfChange"], bool]:
        return self, True

    def marshal(self) -> bytes:
        return _encode_fields(
            (1, self.id), (2, int(self.type)), (3, self.node_id), (4, self.context)
        )

    @staticmethod
    def unmarshal(data: bytes) -> "ConfChange":
        cc = ConfChange()
        for tag, val in _decode_fields(data):
            if tag == 1:
                cc.id = val
            elif tag == 2:
                cc.type = ConfChangeType(val)
            elif tag == 3:
                cc.node_id = val
            elif tag == 4:
                cc.context = val
        return cc

    def go_str(self) -> str:
        """Go %v struct rendering, needed for trace-parity log lines."""
        return "{%d %s %d %s}" % (self.id, self.type, self.node_id,
                                  _go_bytes(self.context))


@dataclass
class ConfChangeV2:
    transition: ConfChangeTransition = ConfChangeTransition.ConfChangeTransitionAuto
    changes: List[ConfChangeSingle] = field(default_factory=list)
    context: bytes = b""

    def as_v2(self) -> "ConfChangeV2":
        return self

    def as_v1(self) -> Tuple[Optional[ConfChange], bool]:
        return None, False

    def enter_joint(self) -> Tuple[bool, bool]:
        """(autoLeave, useJoint) — ref: raftpb/confchange.go EnterJoint."""
        if (
            self.transition != ConfChangeTransition.ConfChangeTransitionAuto
            or len(self.changes) > 1
        ):
            auto_leave = self.transition in (
                ConfChangeTransition.ConfChangeTransitionAuto,
                ConfChangeTransition.ConfChangeTransitionJointImplicit,
            )
            return auto_leave, True
        return False, False

    def leave_joint(self) -> bool:
        """True if this is a zero-change request to leave a joint config."""
        return (
            self.transition == ConfChangeTransition.ConfChangeTransitionAuto
            and not self.changes
        )

    def marshal(self) -> bytes:
        parts = [_encode_fields((1, int(self.transition)))]
        for ch in self.changes:
            sub = _encode_fields((1, int(ch.type)), (2, ch.node_id))
            parts.append(_encode_len_field(2, sub))
        parts.append(_encode_fields((3, self.context)))
        return b"".join(parts)

    @staticmethod
    def unmarshal(data: bytes) -> "ConfChangeV2":
        cc = ConfChangeV2()
        for tag, val in _decode_fields(data):
            if tag == 1:
                cc.transition = ConfChangeTransition(val)
            elif tag == 2:
                single = ConfChangeSingle()
                for stag, sval in _decode_fields(val):
                    if stag == 1:
                        single.type = ConfChangeType(sval)
                    elif stag == 2:
                        single.node_id = sval
                cc.changes.append(single)
            elif tag == 3:
                cc.context = val
        return cc

    def go_str(self) -> str:
        changes = " ".join("{%s %d}" % (c.type, c.node_id)
                           for c in self.changes)
        return "{%s [%s] %s}" % (self.transition, changes,
                                 _go_bytes(self.context))


def _go_bytes(b: bytes) -> str:
    """Go %v of a []byte: space-separated decimal values in brackets."""
    return "[" + " ".join(str(x) for x in b) + "]"


def _encode_varint(x: int) -> bytes:
    out = bytearray()
    while x >= 0x80:
        out.append((x & 0x7F) | 0x80)
        x >>= 7
    out.append(x)
    return bytes(out)


def _encode_fields(*fields_: Tuple[int, object]) -> bytes:
    """Encode (tag, value) pairs, omitting zero/empty values."""
    out = bytearray()
    for tag, val in fields_:
        if isinstance(val, bytes):
            if val:
                out += _encode_varint(tag << 3 | 2)
                out += _encode_varint(len(val))
                out += val
        else:
            if val:
                out += _encode_varint(tag << 3 | 0)
                out += _encode_varint(int(val))
    return bytes(out)


def _encode_len_field(tag: int, payload: bytes) -> bytes:
    return _encode_varint(tag << 3 | 2) + _encode_varint(len(payload)) + payload


def _decode_fields(data: bytes):
    i, n = 0, len(data)
    while i < n:
        key, i = _decode_varint(data, i)
        tag, wire = key >> 3, key & 7
        if wire == 0:
            val, i = _decode_varint(data, i)
            yield tag, val
        elif wire == 2:
            ln, i = _decode_varint(data, i)
            yield tag, data[i : i + ln]
            i += ln
        else:
            raise ValueError(f"unsupported wire type {wire}")


def _decode_varint(data: bytes, i: int) -> Tuple[int, int]:
    shift, val = 0, 0
    while True:
        b = data[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def conf_changes_from_string(s: str) -> List[ConfChangeSingle]:
    """Parse 'v1 l2 r3 u4' notation (ref: raftpb/confchange.go ConfChangesFromString)."""
    ccs: List[ConfChangeSingle] = []
    toks = s.strip().split()
    kinds = {
        "v": ConfChangeType.ConfChangeAddNode,
        "l": ConfChangeType.ConfChangeAddLearnerNode,
        "r": ConfChangeType.ConfChangeRemoveNode,
        "u": ConfChangeType.ConfChangeUpdateNode,
    }
    for tok in toks:
        if len(tok) < 2 or tok[0] not in kinds:
            raise ValueError(f"unknown token {tok}")
        ccs.append(ConfChangeSingle(kinds[tok[0]], int(tok[1:])))
    return ccs


def conf_changes_to_string(ccs: List[ConfChangeSingle]) -> str:
    rev = {
        ConfChangeType.ConfChangeAddNode: "v",
        ConfChangeType.ConfChangeAddLearnerNode: "l",
        ConfChangeType.ConfChangeRemoveNode: "r",
        ConfChangeType.ConfChangeUpdateNode: "u",
    }
    return " ".join(f"{rev[c.type]}{c.node_id}" for c in ccs)
