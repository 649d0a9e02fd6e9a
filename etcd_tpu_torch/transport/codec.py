"""Binary wire codec for raft messages
(ref: rafthttp "message" codec, server/etcdserver/api/rafthttp/msg_codec.go —
length-prefixed marshaled Message; here a fixed struct header instead of
protobuf, same framing role).

Frame layout (little-endian):

    u32 total_len | header | context | entries... | snapshot?

    header: u8 type | u64 to | u64 from | u64 term | u64 log_term |
            u64 index | u64 commit | u8 reject | u64 reject_hint |
            u32 ctx_len | u32 n_entries | u8 has_snapshot
    entry:  u64 term | u64 index | u8 etype | u32 dlen | data
    snapshot: u64 index | u64 term | conf_state | u32 dlen | data
    conf_state: u32 counts ×4 | u8 auto_leave | u64 ids...

Ports ``etcd_tpu/transport/codec.py`` whole; the port keeps its own copy and
tests/test_torch_hubs.py pins it equal.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

from ..raft.types import (
    ConfState,
    Entry,
    EntryType,
    Message,
    MessageType,
    Snapshot,
    SnapshotMetadata,
    is_empty_snap,
)

_HDR = struct.Struct("<BQQQQQQBQIIB")
_ENT = struct.Struct("<QQBI")
_SNAP = struct.Struct("<QQ")
_CS = struct.Struct("<IIIIB")

MAX_FRAME = 512 << 20  # hard cap (2GiB max recv in the reference gRPC)


def encode_message(m: Message) -> bytes:
    parts = []
    has_snap = not is_empty_snap(m.snapshot)
    parts.append(
        _HDR.pack(
            int(m.type),
            m.to,
            m.from_,
            m.term,
            m.log_term,
            m.index,
            m.commit,
            1 if m.reject else 0,
            m.reject_hint,
            len(m.context),
            len(m.entries),
            1 if has_snap else 0,
        )
    )
    if m.context:
        parts.append(m.context)
    for e in m.entries:
        parts.append(_ENT.pack(e.term, e.index, int(e.type), len(e.data)))
        if e.data:
            parts.append(e.data)
    if has_snap:
        md = m.snapshot.metadata
        cs = md.conf_state
        parts.append(_SNAP.pack(md.index, md.term))
        ids = cs.voters + cs.learners + cs.voters_outgoing + cs.learners_next
        parts.append(
            _CS.pack(
                len(cs.voters),
                len(cs.learners),
                len(cs.voters_outgoing),
                len(cs.learners_next),
                1 if cs.auto_leave else 0,
            )
        )
        if ids:
            parts.append(struct.pack(f"<{len(ids)}Q", *ids))
        parts.append(struct.pack("<I", len(m.snapshot.data)))
        parts.append(m.snapshot.data)
    payload = b"".join(parts)
    return struct.pack("<I", len(payload)) + payload


def decode_message(payload: bytes) -> Message:
    (
        mtype,
        to,
        from_,
        term,
        log_term,
        index,
        commit,
        reject,
        reject_hint,
        ctx_len,
        n_entries,
        has_snap,
    ) = _HDR.unpack_from(payload)
    off = _HDR.size
    context = payload[off : off + ctx_len]
    off += ctx_len
    entries: List[Entry] = []
    for _ in range(n_entries):
        eterm, eindex, etype, dlen = _ENT.unpack_from(payload, off)
        off += _ENT.size
        data = payload[off : off + dlen]
        off += dlen
        entries.append(
            Entry(term=eterm, index=eindex, type=EntryType(etype), data=data)
        )
    snapshot = Snapshot()
    if has_snap:
        sindex, sterm = _SNAP.unpack_from(payload, off)
        off += _SNAP.size
        nv, nl, nvo, nln, auto_leave = _CS.unpack_from(payload, off)
        off += _CS.size
        n = nv + nl + nvo + nln
        ids = list(struct.unpack_from(f"<{n}Q", payload, off))
        off += 8 * n
        (dlen,) = struct.unpack_from("<I", payload, off)
        off += 4
        data = payload[off : off + dlen]
        off += dlen
        snapshot = Snapshot(
            data=data,
            metadata=SnapshotMetadata(
                conf_state=ConfState(
                    voters=ids[:nv],
                    learners=ids[nv : nv + nl],
                    voters_outgoing=ids[nv + nl : nv + nl + nvo],
                    learners_next=ids[nv + nl + nvo :],
                    auto_leave=bool(auto_leave),
                ),
                index=sindex,
                term=sterm,
            ),
        )
    return Message(
        type=MessageType(mtype),
        to=to,
        from_=from_,
        term=term,
        log_term=log_term,
        index=index,
        commit=commit,
        entries=entries,
        snapshot=snapshot,
        reject=bool(reject),
        reject_hint=reject_hint,
        context=context,
    )
