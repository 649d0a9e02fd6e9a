"""Dataclass wire types <-> reference-wire-compatible protobuf.

Every field the reference declares ``(gogoproto.nullable) = false`` is
set EXPLICITLY (including zeros): gogo's generated marshaler emits
those fields unconditionally (ref: raft/raftpb/raft.pb.go
MarshalToSizedBuffer), and matching that makes our serialization
byte-for-byte identical to Go's for the same logical message — a
property the golden tests pin down.

Ports ``etcd_tpu/pb/convert.py``.
"""

from __future__ import annotations

from ..raft.types import (
    ConfState,
    Entry,
    EntryType,
    HardState,
    Message,
    MessageType,
    Snapshot,
    SnapshotMetadata,
)
from . import raft_pb2 as pb


def entry_to_pb(e: Entry) -> "pb.Entry":
    out = pb.Entry()
    out.Type = int(e.type)
    out.Term = e.term
    out.Index = e.index
    if e.data:
        out.Data = e.data
    return out


def entry_from_pb(p: "pb.Entry") -> Entry:
    return Entry(index=p.Index, term=p.Term, type=EntryType(p.Type),
                 data=p.Data)


def _confstate_to_pb(cs: ConfState) -> "pb.ConfState":
    out = pb.ConfState()
    out.voters.extend(cs.voters)
    out.learners.extend(cs.learners)
    out.voters_outgoing.extend(cs.voters_outgoing)
    out.learners_next.extend(cs.learners_next)
    out.auto_leave = cs.auto_leave
    return out


def _confstate_from_pb(p: "pb.ConfState") -> ConfState:
    return ConfState(
        voters=list(p.voters),
        learners=list(p.learners),
        voters_outgoing=list(p.voters_outgoing),
        learners_next=list(p.learners_next),
        auto_leave=p.auto_leave,
    )


def snapshot_to_pb(s: Snapshot) -> "pb.Snapshot":
    out = pb.Snapshot()
    if s.data:
        out.data = s.data
    out.metadata.conf_state.CopyFrom(
        _confstate_to_pb(s.metadata.conf_state))
    out.metadata.index = s.metadata.index
    out.metadata.term = s.metadata.term
    return out


def snapshot_from_pb(p: "pb.Snapshot") -> Snapshot:
    return Snapshot(
        data=p.data,
        metadata=SnapshotMetadata(
            conf_state=_confstate_from_pb(p.metadata.conf_state),
            index=p.metadata.index,
            term=p.metadata.term,
        ),
    )


def hardstate_to_pb(hs: HardState) -> "pb.HardState":
    out = pb.HardState()
    out.term = hs.term
    out.vote = hs.vote
    out.commit = hs.commit
    return out


def hardstate_from_pb(p: "pb.HardState") -> HardState:
    return HardState(term=p.term, vote=p.vote, commit=p.commit)


def message_to_pb(m: Message) -> "pb.Message":
    out = pb.Message()
    out.type = int(m.type)
    out.to = m.to
    setattr(out, "from", m.from_)  # 'from' is a Python keyword
    out.term = m.term
    out.logTerm = m.log_term
    out.index = m.index
    for e in m.entries:
        out.entries.append(entry_to_pb(e))
    out.commit = m.commit
    out.snapshot.CopyFrom(snapshot_to_pb(m.snapshot))
    out.reject = m.reject
    out.rejectHint = m.reject_hint
    if m.context:
        out.context = m.context
    return out


def message_from_pb(p: "pb.Message") -> Message:
    return Message(
        type=MessageType(p.type),
        to=p.to,
        from_=getattr(p, "from"),
        term=p.term,
        log_term=p.logTerm,
        index=p.index,
        entries=[entry_from_pb(e) for e in p.entries],
        commit=p.commit,
        snapshot=snapshot_from_pb(p.snapshot),
        reject=p.reject,
        reject_hint=p.rejectHint,
        context=p.context,
    )


def message_to_bytes(m: Message) -> bytes:
    return message_to_pb(m).SerializeToString()


def message_from_bytes(b: bytes) -> Message:
    return message_from_pb(pb.Message.FromString(b))


def confchange_to_pb(cc) -> "pb.ConfChange":
    out = pb.ConfChange()
    out.id = cc.id
    out.type = int(cc.type)
    out.node_id = cc.node_id
    if cc.context:
        out.context = cc.context
    return out


def confchange_from_pb(p: "pb.ConfChange"):
    from ..raft.types import ConfChange, ConfChangeType

    return ConfChange(id=p.id, type=ConfChangeType(p.type),
                      node_id=p.node_id, context=p.context)


def confchange_v2_to_pb(cc2) -> "pb.ConfChangeV2":
    out = pb.ConfChangeV2()
    out.transition = int(cc2.transition)
    for ch in cc2.changes:
        out.changes.add(type=int(ch.type), node_id=ch.node_id)
    if cc2.context:
        out.context = cc2.context
    return out


def confchange_v2_from_pb(p: "pb.ConfChangeV2"):
    from ..raft.types import (
        ConfChangeSingle,
        ConfChangeTransition,
        ConfChangeType,
        ConfChangeV2,
    )

    return ConfChangeV2(
        transition=ConfChangeTransition(p.transition),
        changes=[ConfChangeSingle(type=ConfChangeType(c.type),
                                  node_id=c.node_id)
                 for c in p.changes],
        context=p.context,
    )
