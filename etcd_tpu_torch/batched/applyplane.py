"""Device-resident apply plane: tensorized MVCC, watch matching and
lease TTL expiry, in PyTorch.

Ports ``etcd_tpu/batched/applyplane.py``. The host forms (the opcodes,
``fnv1a32``, the payload forms and ``PlaneOracle``) are copies, pinned
equal to etcd_tpu's by tests/test_torch_applyplane.py.

The plane is a program of its own beside the round: the round decides
*what committed*; one dispatch folds up to ``A = cfg.apply_records``
committed records per row into a fixed-capacity per-row KV/revision
store. A round that commits more dispatches again with the next chunk.

Byte honesty: the device store holds 31-bit FNV-1a key/value *hashes*
and int32 revision / lease-expiry lanes — the MVCC metadata. Byte truth
stays in the host tier, which keeps applying every payload; rows whose
live keys exceed ``C = cfg.apply_capacity`` set a sticky overflow flag
that routes their reads and snapshot capture back to the host tier.

Semantics of one dispatch (``PlaneOracle`` replays them exactly):

1. ``tick += tick_add`` (the member's staged round ticks).
2. Expiry pass: every slot with ``0 < kv_lease <= tick`` is cleared;
   the row's revision advances by the number of expired slots.
3. The A record lanes in order. put: an exact-hash match updates the
   slot, else the first free slot takes it, else the row overflows;
   the revision always advances. delete: clears the matching slot and
   advances the revision only if the key existed. Each applied
   record's watch bitmap is the OR of exact-key matches against the
   armed watch slots (``WS <= 32`` bits in one int32; slot 31 is the
   sign bit).

The dispatch here is torch ops over an explicit row axis. It updates
the plane's tensors in place (the counterpart of the reference's
donated carry), so an owner that keeps one plane for its lifetime can
capture a dispatch as a CUDA graph and replay it. The chosen slot of
each record is read and written with one gather and one scatter per
lane at ``(row, slot)``; the reference's one-hot ``where`` rewrites all
``C`` slots of every lane per record instead, with the same result.
"""

from __future__ import annotations

import functools
import struct
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..analysis.sentinels import note_compile_key
from .state import BatchedConfig, I32, resolve_device

# Record opcodes (the host-built apply stream).
OP_NONE, OP_PUT, OP_DEL = 0, 1, 2


# -----------------------------------------------------------------------------
# Host-side hashing + payload forms
# -----------------------------------------------------------------------------


def fnv1a32(data: bytes) -> int:
    """31-bit nonzero FNV-1a — the plane's key/value identity. Masked
    to 31 bits so it stays positive in i32 lanes; 0 is reserved for
    'empty slot', so a zero digest maps to 1."""
    h = 2166136261
    for b in data:
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    h &= 0x7FFFFFFF
    return h or 1


def put_payload(key: bytes, value: bytes, lease_ttl: int = 0) -> bytes:
    """Proposal payload for a put; ``lease_ttl`` > 0 (plane ticks)
    makes it an expiring put (payload form ``E``). The non-lease forms
    are byte-identical to GroupKV's (``P``/``D``) — every pre-plane
    WAL/snapshot stays replayable."""
    if lease_ttl > 0:
        return b"E" + struct.pack(">I", lease_ttl) + key + b"\x00" + value
    return b"P" + key + b"\x00" + value


def delete_payload(key: bytes) -> bytes:
    return b"D" + key


def parse_payload(d: bytes) -> Optional[Tuple[int, bytes, bytes, int]]:
    """(op, key, value, lease_ttl) of a KV payload; None for payloads
    the KV tier ignores (conf entries never reach here — the rawnode
    splits on etype first)."""
    if not d:
        return None
    tag = d[:1]
    if tag == b"P":
        k, _, v = d[1:].partition(b"\x00")
        return (OP_PUT, k, v, 0)
    if tag == b"E":
        if len(d) < 5:
            return None
        (ttl,) = struct.unpack(">I", d[1:5])
        k, _, v = d[5:].partition(b"\x00")
        return (OP_PUT, k, v, int(ttl))
    if tag == b"D":
        return (OP_DEL, d[1:], b"", 0)
    return None


# -----------------------------------------------------------------------------
# Device state + frames
# -----------------------------------------------------------------------------


class PlaneState(NamedTuple):
    """Per-row (row = group on the hosting path) MVCC tensors."""

    kv_key: torch.Tensor  # [n, C] i32 key hash; 0 = empty slot
    kv_rev: torch.Tensor  # [n, C] i32 mod-revision of the slot
    kv_val: torch.Tensor  # [n, C] i32 value hash
    kv_lease: torch.Tensor  # [n, C] i32 expiry tick; 0 = no lease
    watch_key: torch.Tensor  # [n, WS] i32 armed exact-key watches; 0 = off
    rev: torch.Tensor  # [n] i32 group revision counter
    tick: torch.Tensor  # [n] i32 plane clock (staged round ticks)
    overflow: torch.Tensor  # [n] bool sticky capacity overflow
    slots_hw: torch.Tensor  # [n] i32 used-slot high-water


class PlaneFrame(NamedTuple):
    """Fixed-shape per-dispatch output the host drains: the watch event
    lanes plus per-row counters."""

    ev_op: torch.Tensor  # [n, A] i32 applied opcode (0 = empty lane)
    ev_key: torch.Tensor  # [n, A] i32 key hash of the applied record
    ev_rev: torch.Tensor  # [n, A] i32 revision assigned (0 = none)
    ev_wmask: torch.Tensor  # [n, A] i32 watch-slot match bitmap
    puts: torch.Tensor  # [n] i32
    dels: torch.Tensor  # [n] i32
    expired: torch.Tensor  # [n] i32 lease expiries this dispatch
    slots_used: torch.Tensor  # [n] i32 live slots after the dispatch
    leases: torch.Tensor  # [n] i32 slots holding an unexpired lease
    overflow: torch.Tensor  # [n] bool (post-dispatch sticky flag)


# The four [n, C] slot lanes, in PlaneState order.
KV_LANES = ("kv_key", "kv_rev", "kv_val", "kv_lease")


def init_plane(cfg: BatchedConfig, n: int, device=None) -> PlaneState:
    c, ws = cfg.apply_capacity, cfg.apply_watch_slots
    dev = resolve_device(device)

    def z(*shape, dtype=I32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return PlaneState(
        kv_key=z(n, c), kv_rev=z(n, c), kv_val=z(n, c), kv_lease=z(n, c),
        watch_key=z(n, ws), rev=z(n), tick=z(n),
        overflow=z(n, dtype=torch.bool), slots_hw=z(n))


@functools.lru_cache(maxsize=None)
def _watch_bits(ws: int, dev: torch.device) -> torch.Tensor:
    """[WS] i32 ``1 << w``, from int32 shifts: bit 31 is -2^31, as the
    reference's int32 shift wraps. Made once per device, by a dispatch
    that runs before any capture of it."""
    return torch.bitwise_left_shift(
        torch.ones(ws, dtype=I32, device=dev),
        torch.arange(ws, dtype=I32, device=dev))


def _count(mask: torch.Tensor) -> torch.Tensor:
    """Per-row count of a [n, X] bool mask, as int32."""
    return mask.sum(dim=1, dtype=I32)


def slot_search(kv_key: torch.Tensor, key: torch.Tensor):
    """Each row's slot for record key `key` [n]: its first exact match,
    else its first free slot. Returns (slot [n] int64, exists [n] bool,
    slot_ok [n] bool). One max over a per-slot score — 2 for a match
    plus 1 for a free slot, on an int cast (torch's argmax takes no
    bool) — whose first maximal index is ``jnp.argmax``'s choice in
    the reference: the first match if any, else the first free slot,
    and 0 for a row with neither (where no write happens)."""
    hit = kv_key == key[:, None]
    # jitlint: waive(narrow-lane-arith) -- a score of 0..3 a slot, built in int8 to halve the [n, C] pass; it cannot wrap
    score = hit.to(torch.int8) * 2 + (kv_key == 0).to(torch.int8)
    best, slot = score.max(dim=1)
    # With key != 0 the score is 0, 1 or 2; with key == 0 a free slot is
    # also a match and scores 3. Either way a match scores >= 2 and a
    # usable slot >= 1.
    return slot, best >= 2, best >= 1


def dispatch(plane: PlaneState, ops: torch.Tensor, keys: torch.Tensor,
             vals: torch.Tensor, ttls: torch.Tensor,
             tick_add: torch.Tensor) -> PlaneFrame:
    """Fold the [n, A] i32 record lanes and the [n] tick advance into
    `plane`, in place; returns the dispatch's PlaneFrame. Every op is
    on the plane's device with no host sync, so an owner of fixed
    buffers can capture it as a CUDA graph."""
    kv_key, kv_rev, kv_val, kv_lease = (getattr(plane, f) for f in KV_LANES)
    # Recompile sentinel: one key per dispatch shape (capacity, watch
    # slots, records, rows), its own program kind beside the round.
    n, c = kv_key.shape
    note_compile_key("apply_plane", f"C={c}|WS={plane.watch_key.shape[1]}"
                     f"|A={ops.shape[1]}|n={n}")
    lanes = (kv_key, kv_rev, kv_val, kv_lease)
    plane.tick.add_(tick_add)
    tick = plane.tick
    # Expiry pass (before new records: a put in this dispatch re-arms
    # its key AFTER the old lease's deadline fires).
    dead = (kv_lease > 0) & (kv_lease <= tick[:, None])
    n_dead = _count(dead)
    for lane in lanes:
        lane.masked_fill_(dead, 0)
    plane.rev.add_(n_dead)
    rev = plane.rev
    overflow = plane.overflow
    bits = _watch_bits(plane.watch_key.shape[1], kv_key.device)
    zero = torch.zeros((), dtype=I32, device=kv_key.device)
    events = []
    for j in range(ops.shape[1]):
        op, key, val, ttl = ops[:, j], keys[:, j], vals[:, j], ttls[:, j]
        slot, exists, slot_ok = slot_search(kv_key, key)
        is_put = op == OP_PUT
        is_del = op == OP_DEL
        # put: the revision always advances (the store of record even
        # when the row overflows — the host tier holds the bytes);
        # del: only if the key existed.
        bump = is_put | (is_del & exists)
        rev.add_(bump.to(I32))
        wr_put = is_put & slot_ok
        wr_del = is_del & exists
        at = slot[:, None]
        lease = torch.where(ttl > 0, tick + ttl, zero)
        for lane, put_v in zip(lanes, (key, rev, val, lease)):
            old = lane.gather(1, at).squeeze(1)
            new = torch.where(wr_put, put_v, torch.where(wr_del, zero, old))
            lane.scatter_(1, at, new[:, None])
        overflow.logical_or_(is_put & ~slot_ok)
        match = (plane.watch_key == key[:, None]) & (key != 0)[:, None]
        wmask = torch.where(match, bits, zero).sum(dim=1, dtype=I32)
        events.append((op, key, torch.where(bump, rev, zero),
                       torch.where(op != OP_NONE, wmask, zero)))
    used = _count(kv_key != 0)
    torch.maximum(plane.slots_hw, used, out=plane.slots_hw)
    ev_op, ev_key, ev_rev, ev_wmask = (torch.stack(x, dim=1)
                                       for x in zip(*events))
    return PlaneFrame(
        ev_op=ev_op, ev_key=ev_key, ev_rev=ev_rev, ev_wmask=ev_wmask,
        puts=_count(ops == OP_PUT), dels=_count(ops == OP_DEL),
        expired=n_dead, slots_used=used, leases=_count(kv_lease > 0),
        overflow=overflow.clone())


def gather_rows(plane: PlaneState, rows) -> Tuple[torch.Tensor, ...]:
    """Batched row gather for snapshot capture: (kv_key, kv_rev,
    kv_val, kv_lease, rev, tick, overflow) of `rows`, one index_select
    per buffer on the plane's device."""
    idx = torch.as_tensor(np.asarray(rows, np.int64)).to(plane.rev.device)
    note_compile_key("apply_plane", f"gather|m={idx.shape[0]}")
    return tuple(getattr(plane, f).index_select(0, idx)
                 for f in KV_LANES + ("rev", "tick", "overflow"))


# -----------------------------------------------------------------------------
# Host-side shadow oracle (tests + smoke reconcile against this, and
# this against the device — exact, not statistical)
# -----------------------------------------------------------------------------


class PlaneOracle:
    """Pure-Python replay of one row's dispatch semantics. Feeding it
    the exact (records, tick_add) stream a member staged must reproduce
    the device tensors bit-for-bit (tests/test_torch_applyplane.py)."""

    def __init__(self, cfg: BatchedConfig):
        self.c = cfg.apply_capacity
        self.ws = cfg.apply_watch_slots
        self.kv_key = [0] * self.c
        self.kv_rev = [0] * self.c
        self.kv_val = [0] * self.c
        self.kv_lease = [0] * self.c
        self.watch_key = [0] * self.ws
        self.rev = 0
        self.tick = 0
        self.overflow = False
        self.slots_hw = 0
        self.events: List[Tuple[int, int, int, int]] = []
        self.expired = 0

    def dispatch(self, records: List[Tuple[int, int, int, int]],
                 tick_add: int) -> None:
        """records: [(op, key_hash, val_hash, ttl)] (<= A per call the
        way the rawnode chunks them, but the oracle takes any length —
        chunking cannot change the fold)."""
        self.tick += tick_add
        for s in range(self.c):
            if 0 < self.kv_lease[s] <= self.tick:
                self.kv_key[s] = self.kv_rev[s] = 0
                self.kv_val[s] = self.kv_lease[s] = 0
                self.rev += 1
                self.expired += 1
        for op, key, val, ttl in records:
            if op == OP_NONE:
                continue
            slot = next(
                (s for s in range(self.c) if self.kv_key[s] == key),
                None)
            if op == OP_PUT:
                self.rev += 1
                if slot is None:
                    slot = next(
                        (s for s in range(self.c)
                         if self.kv_key[s] == 0), None)
                if slot is None:
                    self.overflow = True
                else:
                    self.kv_key[slot] = key
                    self.kv_val[slot] = val
                    self.kv_rev[slot] = self.rev
                    self.kv_lease[slot] = (
                        self.tick + ttl if ttl > 0 else 0)
                ev_rev = self.rev
            else:  # OP_DEL
                if slot is not None:
                    self.rev += 1
                    self.kv_key[slot] = self.kv_rev[slot] = 0
                    self.kv_val[slot] = self.kv_lease[slot] = 0
                    ev_rev = self.rev
                else:
                    ev_rev = 0
            wmask = 0
            if key != 0:
                for w in range(self.ws):
                    if self.watch_key[w] == key:
                        wmask |= 1 << w
            self.events.append((op, key, ev_rev, wmask))
        self.slots_hw = max(
            self.slots_hw, sum(1 for k in self.kv_key if k != 0))

    def state(self) -> Dict[str, object]:
        return {
            "kv_key": list(self.kv_key), "kv_rev": list(self.kv_rev),
            "kv_val": list(self.kv_val),
            "kv_lease": list(self.kv_lease),
            "rev": self.rev, "tick": self.tick,
            "overflow": self.overflow, "slots_hw": self.slots_hw,
        }
