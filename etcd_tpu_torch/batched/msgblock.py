"""SoA message blocks: the hosted fast path for raft traffic.

Ports ``etcd_tpu/batched/msgblock.py`` whole: the same wire format,
byte for byte, so a member of either package reads the other's frames
(tests/test_torch_msgblock.py holds the two codecs equal). Like the
reference it is numpy on the host; only its constants come from the
port's step.py.

A round emits about two messages per group per member; materializing
each as a Python ``Message`` would cost the whole round budget at large
G. Messages instead stay as one packed numpy record array end-to-end:
view-cast straight out of the device outbox (step.pack_outbox emits
records pre-packed at wire widths), shipped as ONE frame per peer per
round, and scattered into the next round's inbox with vectorized
first-wins merging.

Entry payloads ride a **flat arena**, not per-record Python lists: one
``ent_term``/``ent_etype``/``ent_len`` SoA plus a single contiguous
payload buffer, with per-record extents derived from the cumsum of
``n_ents``. Every block operation — codec, split, validate, merge —
is offset math and bulk numpy slices. Entry indexes are implicit
(MsgApp entries are contiguous from ``index+1``). Only MsgSnap
(app-state payloads attached by the hosting layer at send time) takes
the per-message object path. This is the batched analog of the
reference's two rafthttp channels (ref:
server/etcdserver/api/rafthttp/peer.go:337-349).

Wire format (version 2, one frame)::

    u1  version (= WIRE_VERSION)
    u4  n_recs
    n_recs * REC_DTYPE records                 (36 B each)
    u4  n_ents  (must equal sum of rec.n_ents)
    n_ents * ENT_DTYPE entry headers           (9 B each)
    payload bytes (sum of ent_len)

A mismatched version byte, a length that disagrees with the counted
sections, or trailing bytes all raise ``ValueError`` — the transport
counts ``recv_corrupt`` and drops the connection, so a mixed-version
pod degrades to message loss (which raft tolerates) instead of
misparsing frames.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from .step import (
    LANE_OF,
    NUM_WIRE_TYPES,
    T_APP,
    T_SNAP,
)

# Bump on any layout change: a frame whose leading byte disagrees is
# rejected at decode (never misparsed).
WIRE_VERSION = 2

# One wire record per message; packed little-endian, 36 bytes = 9 u32
# words — exactly the rows step.pack_outbox emits, so device outbox ->
# wire records is a view-cast, not a gather.
REC_DTYPE = np.dtype([
    ("row", "<u4"),          # receiver-side row (group id in hosting)
    ("to", "<u1"),           # target slot + 1 (member id)
    ("frm", "<u1"),          # sender slot + 1
    ("lane", "<u1"),         # inbox lane (KIND_*)
    ("type", "<u1"),         # wire type (T_*)
    ("reject", "<u1"),
    ("n_ents", "<u1"),       # entries in the arena section (T_APP);
    # one byte caps E at 255 — BatchedConfig.validate() enforces
    # max_ents_per_msg <= state.MAX_WIRE_ENTS so a config can't wrap it
    ("pad", "<u2"),          # word alignment; always 0 on the wire

    ("term", "<u4"),
    ("log_term", "<u4"),
    ("index", "<u4"),
    ("commit", "<u4"),
    ("reject_hint", "<u4"),
    ("ctx", "<u4"),          # 4-byte context word
])
REC_SIZE = REC_DTYPE.itemsize
assert REC_SIZE == 36 and REC_SIZE % 4 == 0

# Per-entry wire header in the entries section: term, etype, data len.
ENT_DTYPE = np.dtype([("term", "<u4"), ("etype", "<u1"), ("len", "<u4")])
ENT_SIZE = ENT_DTYPE.itemsize
_HEAD = struct.Struct("<BI")
_U4 = struct.Struct("<I")

# One entry as carried by a block: (term, etype, data).
BlockEnt = Tuple[int, int, bytes]

_MAX_T = NUM_WIRE_TYPES  # compat alias (LANE_OF's index range)

_EMPTY_U4 = np.empty(0, "<u4")
_EMPTY_U1 = np.empty(0, "<u1")
_EMPTY_I8 = np.empty(0, np.int64)


def ragged_ranges(starts, lens) -> np.ndarray:
    """Concatenated ``arange(s, s+l)`` for each (start, len) pair — the
    ragged-gather index builder (one repeat + one arange, no Python
    loop)."""
    lens = np.asarray(lens, np.int64)
    total = int(lens.sum())
    if total == 0:
        return _EMPTY_I8
    base = np.asarray(starts, np.int64) - (np.cumsum(lens) - lens)
    return np.repeat(base, lens) + np.arange(total, dtype=np.int64)


class MsgBlock:
    """A batch of messages as one structured record array plus a flat
    entry arena.

    ``ent_term``/``ent_etype``/``ent_len`` hold the entries of every
    record back to back in record order; ``payload`` is their data
    bytes, one contiguous buffer. Record i's entries occupy arena rows
    ``[starts[i], starts[i] + ent_counts[i])`` where ``starts`` is the
    exclusive cumsum of ``ent_counts``. For wire-parsed and
    collect-built blocks ``ent_counts == rec["n_ents"]``; a hand-built
    block whose arena disagrees with its counts is dropped by
    ``validate_block`` (a frame cannot lie — from_bytes enforces the
    totals)."""

    __slots__ = ("rec", "ent_term", "ent_etype", "ent_len", "payload",
                 "ent_counts", "_starts", "_pstarts")

    def __init__(self, rec: np.ndarray,
                 ents: Optional[List[Optional[List[BlockEnt]]]] = None,
                 *, ent_term: Optional[np.ndarray] = None,
                 ent_etype: Optional[np.ndarray] = None,
                 ent_len: Optional[np.ndarray] = None,
                 payload: bytes = b"",
                 ent_counts: Optional[np.ndarray] = None) -> None:
        self.rec = rec
        self._starts = None
        self._pstarts = None
        if ents is not None:
            # Compat constructor from per-record entry lists (tests,
            # hand-built blocks); the hot paths build arenas directly.
            counts = np.zeros(len(rec), np.int64)
            terms: List[int] = []
            etys: List[int] = []
            lens: List[int] = []
            parts: List[bytes] = []
            for i, lst in enumerate(ents):
                if not lst:
                    continue
                counts[i] = len(lst)
                for t, ety, d in lst:
                    terms.append(t)
                    etys.append(ety)
                    lens.append(len(d))
                    parts.append(d)
            self.ent_term = np.asarray(terms, "<u4")
            self.ent_etype = np.asarray(etys, "<u1")
            self.ent_len = np.asarray(lens, "<u4")
            self.payload = b"".join(parts)
            self.ent_counts = counts
            return
        self.ent_term = ent_term if ent_term is not None else _EMPTY_U4
        self.ent_etype = ent_etype if ent_etype is not None else _EMPTY_U1
        self.ent_len = ent_len if ent_len is not None else _EMPTY_U4
        self.payload = payload
        if ent_counts is not None:
            self.ent_counts = np.asarray(ent_counts, np.int64)
        elif len(self.ent_term):
            self.ent_counts = rec["n_ents"].astype(np.int64)
        else:
            self.ent_counts = np.zeros(len(rec), np.int64)

    def __len__(self) -> int:
        return len(self.rec)

    # -- arena offsets ---------------------------------------------------------

    def _ent_starts(self) -> np.ndarray:
        """Per-record exclusive cumsum of ent_counts (arena row of each
        record's first entry)."""
        if self._starts is None:
            self._starts = np.cumsum(self.ent_counts) - self.ent_counts
        return self._starts

    def _pay_starts(self) -> np.ndarray:
        """Per-entry exclusive cumsum of ent_len (payload byte offset
        of each entry's data)."""
        if self._pstarts is None:
            ln = self.ent_len.astype(np.int64)
            self._pstarts = np.cumsum(ln) - ln
        return self._pstarts

    # -- compat accessors ------------------------------------------------------

    def entry_list(self, i: int) -> Optional[List[BlockEnt]]:
        """Record i's entries as (term, etype, data) tuples, or None —
        the object-path shape (low-volume consumers only)."""
        c = int(self.ent_counts[i])
        if c == 0:
            return None
        s = int(self._ent_starts()[i])
        ps = self._pay_starts()
        out: List[BlockEnt] = []
        for j in range(s, s + c):
            a = int(ps[j])
            out.append((int(self.ent_term[j]), int(self.ent_etype[j]),
                        bytes(self.payload[a:a + int(self.ent_len[j])])))
        return out

    @property
    def ents(self) -> List[Optional[List[BlockEnt]]]:
        """Materialized per-record entry lists (compat/debug only —
        never on the hot path)."""
        return [self.entry_list(i) for i in range(len(self.rec))]

    # -- codec -----------------------------------------------------------------

    def to_bytes(self) -> bytes:
        ne = len(self.ent_term)
        hdr = np.empty(ne, ENT_DTYPE)
        hdr["term"] = self.ent_term
        hdr["etype"] = self.ent_etype
        hdr["len"] = self.ent_len
        return b"".join((
            _HEAD.pack(WIRE_VERSION, len(self.rec)),
            self.rec.tobytes(),
            _U4.pack(ne),
            hdr.tobytes(),
            self.payload,
        ))

    @classmethod
    def from_bytes(cls, b: bytes) -> "MsgBlock":
        if len(b) < _HEAD.size:
            raise ValueError("block frame too short")
        ver, n = _HEAD.unpack_from(b)
        if ver != WIRE_VERSION:
            raise ValueError(
                f"block wire version {ver} != {WIRE_VERSION}")
        off = _HEAD.size + n * REC_SIZE
        if len(b) < off + 4:
            raise ValueError(
                f"block frame truncated: {len(b)} < {off + 4} "
                f"for {n} recs")
        rec = np.frombuffer(b, REC_DTYPE, count=n, offset=_HEAD.size)
        (ne,) = _U4.unpack_from(b, off)
        counts = rec["n_ents"].astype(np.int64)
        if ne != int(counts.sum()):
            raise ValueError(
                f"entries section counts {ne} entries, records claim "
                f"{int(counts.sum())}")
        hoff = off + 4
        poff = hoff + ne * ENT_SIZE
        if len(b) < poff:
            raise ValueError("entries section truncated")
        hdr = np.frombuffer(b, ENT_DTYPE, count=ne, offset=hoff)
        pay_len = int(hdr["len"].astype(np.int64).sum())
        if len(b) != poff + pay_len:
            raise ValueError(
                f"block frame has {len(b) - poff - pay_len} bytes "
                "beyond the entry payloads")
        return cls(rec, ent_term=hdr["term"], ent_etype=hdr["etype"],
                   ent_len=hdr["len"], payload=b[poff:],
                   ent_counts=counts)

    # -- subset selection ------------------------------------------------------

    def take(self, sel) -> "MsgBlock":
        """Sub-block of the selected records (bool mask, index array,
        or slice), entries carried along. A contiguous slice keeps the
        arena as pure slices; anything else is one ragged gather."""
        rec = self.rec[sel]
        cnt = self.ent_counts[sel]
        tot = int(cnt.sum())
        if tot == 0:
            return MsgBlock(rec, ent_counts=cnt)
        if isinstance(sel, slice) and (sel.step is None or sel.step == 1):
            st = self._ent_starts()[sel]
            e0 = int(st[0])
            e1 = e0 + tot
            ps = self._pay_starts()
            p0 = int(ps[e0])
            p1 = int(ps[e1 - 1]) + int(self.ent_len[e1 - 1])
            return MsgBlock(
                rec, ent_term=self.ent_term[e0:e1],
                ent_etype=self.ent_etype[e0:e1],
                ent_len=self.ent_len[e0:e1],
                payload=self.payload[p0:p1], ent_counts=cnt)
        eidx = ragged_ranges(self._ent_starts()[sel], cnt)
        lens = self.ent_len[eidx]
        bidx = ragged_ranges(self._pay_starts()[eidx], lens)
        pay = np.frombuffer(self.payload, np.uint8)[bidx].tobytes()
        return MsgBlock(rec, ent_term=self.ent_term[eidx],
                        ent_etype=self.ent_etype[eidx], ent_len=lens,
                        payload=pay, ent_counts=cnt)

    def split_by_target(self) -> Dict[int, "MsgBlock"]:
        """Partition by target member id (slot+1)."""
        tos = np.unique(self.rec["to"])
        if len(tos) == 1:
            return {int(tos[0]): self}
        return {int(to): self.take(self.rec["to"] == to) for to in tos}


def validate_block(blk: "MsgBlock", n_rows: int, num_replicas: int,
                   max_ents: int) -> "MsgBlock":
    """Filter wire-controlled block records down to the well-formed
    subset; the rest are dropped, matching the object path's
    corrupt-frame-drop semantics (hosting.py decode).

    A record is well-formed iff row < n_rows, 1 <= frm <= R,
    lane == LANE_OF[type], n_ents <= max_ents, entries only on T_APP,
    never T_SNAP (snapshots carry app state the hosting layer must
    restore FIRST; a forged one would fast-forward raft state past
    entries whose data never arrived), and the arena actually backs
    the claimed entry count (a hand-built block could lie;
    from_bytes-parsed ones cannot — the totals are enforced at
    decode). Anything else would index the dense inbox out of range
    (crashing the member's round loop) or — worse, for frm=0 — wrap to
    a negative flat index and silently forge a message into a
    DIFFERENT group's inbox slot."""
    rec = blk.rec
    if len(rec) == 0:
        return blk
    typ = rec["type"]
    ok = (
        (rec["row"] < n_rows)
        & (rec["frm"] >= 1) & (rec["frm"] <= num_replicas)
        & (typ < _MAX_T) & (typ != T_SNAP)
        & (rec["lane"] == LANE_OF[np.minimum(typ, _MAX_T - 1)])
        & (rec["n_ents"] <= max_ents)
        & ((rec["n_ents"] == 0) | (typ == T_APP))
        & (rec["n_ents"] == blk.ent_counts)
    )
    # Block-level structural check: ent_counts must be backed by the
    # arena itself (a hand-built block can claim counts its arrays
    # don't hold — ent_counts defaults from rec["n_ents"], so the
    # per-record compare above can't see it). If the totals disagree,
    # per-record attribution is meaningless: keep only payload-free
    # records.
    if (int(blk.ent_counts.sum()) != len(blk.ent_term)
            or int(blk.ent_len.astype(np.int64).sum())
            != len(blk.payload)):
        ok &= rec["n_ents"] == 0
    if ok.all():
        return blk
    return blk.take(ok)


def block_messages(blk: "MsgBlock") -> "list":
    """Compat: materialize a block as (row, Message) tuples — for
    low-volume consumers (single-group nodes, trace harnesses) that
    want the object shape."""
    from ..raft.types import Entry, EntryType, Message, MessageType

    out = []
    for i, rec in enumerate(blk.rec):
        m = Message(
            type=MessageType(int(rec["type"])),
            to=int(rec["to"]),
            from_=int(rec["frm"]),
            term=int(rec["term"]),
            log_term=int(rec["log_term"]),
            index=int(rec["index"]),
            commit=int(rec["commit"]),
            reject=bool(rec["reject"]),
            reject_hint=int(rec["reject_hint"]),
        )
        cw = int(rec["ctx"])
        if cw:
            m.context = cw.to_bytes(4, "little")
        ents = blk.entry_list(i) if rec["n_ents"] else None
        if ents:
            m.entries = [
                Entry(index=int(rec["index"]) + 1 + j, term=term,
                      data=data, type=EntryType(etype))
                for j, (term, etype, data) in enumerate(ents)
            ]
        out.append((int(rec["row"]), m))
    return out


def compact_records(words: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Device-packed word rows -> wire records: one view-cast plus one
    boolean take. `words` is the [M, REC_WORDS] i32 output of
    step.pack_outbox (rows are REC_DTYPE bytes); returns the REC_DTYPE
    records selected by `mask` (a fresh, writable array)."""
    w = np.ascontiguousarray(words)
    rec = w.view(REC_DTYPE).reshape(w.shape[0])
    return rec[mask]


def collect_block(out_valid: np.ndarray, out: "object",
                  slots: np.ndarray) -> "tuple[MsgBlock, np.ndarray]":
    """Reference collect: slice the block-eligible messages out of a
    numpy-materialized outbox with per-field gathers.

    Kept as the differential twin of the packed path (step.pack_outbox
    + compact_records, which the hosted hot path uses) and for callers
    holding an already-materialized outbox. Returns (block,
    complex_mask) where complex_mask marks the slots that still need
    the per-message path (MsgSnap only). MsgApp entry payloads are NOT
    attached here (the arena lives in the caller)."""
    typ = np.asarray(out.type)
    n_ents = np.asarray(out.n_ents)
    simple = out_valid & (typ != T_SNAP)
    rows, tgt, k = np.nonzero(simple)
    rec = np.zeros(len(rows), REC_DTYPE)
    t = typ[rows, tgt, k]
    rec["row"] = rows
    rec["to"] = tgt + 1
    rec["frm"] = slots[rows] + 1
    rec["lane"] = LANE_OF[t]
    rec["type"] = t
    rec["reject"] = np.asarray(out.reject)[rows, tgt, k]
    rec["n_ents"] = np.where(t == T_APP, n_ents[rows, tgt, k], 0)
    rec["term"] = np.asarray(out.term)[rows, tgt, k]
    rec["log_term"] = np.asarray(out.log_term)[rows, tgt, k]
    rec["index"] = np.asarray(out.index)[rows, tgt, k]
    rec["commit"] = np.asarray(out.commit)[rows, tgt, k]
    rec["reject_hint"] = np.asarray(out.reject_hint)[rows, tgt, k]
    rec["ctx"] = np.asarray(out.ctx)[rows, tgt, k]
    return MsgBlock(rec), (out_valid & ~simple)


def _inbox_keys(rec: np.ndarray) -> np.ndarray:
    """Each record's inbox key (row, sender, lane) as one int64."""
    return ((rec["row"].astype(np.int64) << 16)
            | (rec["frm"].astype(np.int64) << 8) | rec["lane"])


def drop_superseded(queued, blk: MsgBlock, types) -> List[MsgBlock]:
    """The queued blocks without each record of a type in `types` whose
    inbox key a record of such a type in `blk` also holds. merge_blocks
    lands one record per key a round, so a receiver that runs fewer
    rounds than its sender would otherwise queue heartbeats without
    bound, each newer one (and the ReadIndex ack it carries) waiting
    behind every older one. A newer heartbeat from the same sender
    carries all an older one does: a term and a commit no lower, the
    pending read's seq; a newer response echoes a newer heartbeat. Raft
    tolerates the loss of the older ones."""
    new = np.isin(blk.rec["type"], types)
    if not new.any() or not queued:
        return list(queued)
    keys = _inbox_keys(blk.rec[new])
    out = []
    for q in queued:
        drop = np.isin(q.rec["type"], types) & np.isin(_inbox_keys(q.rec),
                                                        keys)
        if drop.all():
            continue
        out.append(q.take(~drop) if drop.any() else q)
    return out


def merge_blocks(
    blocks: List[MsgBlock],
    num_replicas: int,
    num_kinds: int,
    dense: Dict[str, np.ndarray],
    land_entries=None,
) -> List[MsgBlock]:
    """Scatter queued block records into the dense inbox arrays.

    `dense` holds the flat-viewable per-field arrays ([n, R, K], plus
    ``ent_terms`` [n, R, K, E]); slots already filled (by the legacy
    per-message path) are respected. Per inbox key (row, sender, lane)
    at most one record lands per round; FIFO order across blocks is
    preserved: once a key has a deferred record, later records for
    that key stay queued behind it. Returns the residual blocks (in
    order).

    ``land_entries(blk, idx)`` is invoked once per block with the
    record indexes (into ``blk``) whose entry-carrying records LAND
    this round — the caller bulk-copies the payload slices into its
    arena at that moment (entries of a deferred record stay with it in
    the residual)."""
    valid = dense["valid"]
    n_keys = valid.size
    flat_valid = valid.reshape(-1)
    barred = np.zeros(n_keys, bool)
    residual: List[MsgBlock] = []
    flat = {f: a.reshape(-1) for f, a in dense.items()
            if f != "ent_terms"}
    ent_terms = dense.get("ent_terms")
    e_cap = ent_terms.shape[-1] if ent_terms is not None else 0
    flat_ents = (
        ent_terms.reshape(-1, e_cap) if ent_terms is not None else None
    )
    for blk in blocks:
        rec = blk.rec
        if len(rec) == 0:
            continue
        key = (
            (rec["row"].astype(np.int64) * num_replicas
             + (rec["frm"].astype(np.int64) - 1)) * num_kinds
            + rec["lane"]
        )
        # First occurrence of each key within this block...
        _, first_idx = np.unique(key, return_index=True)
        firstmask = np.zeros(len(key), bool)
        firstmask[first_idx] = True
        # ...that is neither already filled nor behind a deferred one.
        take = firstmask & ~flat_valid[key] & ~barred[key]
        idx = key[take]
        flat_valid[idx] = True
        flat["type"][idx] = rec["type"][take]
        flat["term"][idx] = rec["term"][take]
        flat["log_term"][idx] = rec["log_term"][take]
        flat["index"][idx] = rec["index"][take]
        flat["commit"][idx] = rec["commit"][take]
        flat["reject"][idx] = rec["reject"][take].astype(bool)
        flat["reject_hint"][idx] = rec["reject_hint"][take]
        flat["ctx"][idx] = rec["ctx"][take]
        if "n_ents" in flat:
            ne = rec["n_ents"][take]
            if ent_terms is not None:
                # The dense inbox carries at most e_cap entry terms per
                # slot; a record claiming more would land a count its
                # own ent_terms row can't back (the terms below are
                # already truncated to e_cap) — clamp so the inbox
                # stays self-consistent for every caller.
                ne = np.minimum(ne, e_cap)
            flat["n_ents"][idx] = ne
        land = np.nonzero(take & (blk.ent_counts > 0))[0]
        if len(land):
            if flat_ents is not None:
                # Bulk ragged scatter of the landing records' entry
                # terms (clamped to the inbox capacity per record).
                cl = np.minimum(blk.ent_counts[land], e_cap)
                rows_rep = np.repeat(key[land], cl)
                offs = ragged_ranges(np.zeros(len(land), np.int64), cl)
                eidx = ragged_ranges(blk._ent_starts()[land], cl)
                flat_ents[rows_rep, offs] = blk.ent_term[eidx]
            if land_entries is not None:
                land_entries(blk, land)
        rest = ~take
        if rest.any():
            barred[key[rest]] = True
            residual.append(blk.take(rest))
    return residual


def validate_records(rec: np.ndarray, n_rows: int,
                     num_replicas: int) -> np.ndarray:
    """Array-level validation (no entries): kept for callers/tests
    that stage payload-free records directly. See validate_block."""
    blk = validate_block(MsgBlock(rec), n_rows, num_replicas, 0)
    return blk.rec
