"""Shared-memory ring fabric: the zero-copy peer transport.

Ports ``etcd_tpu/batched/shmfabric.py`` whole (pure host code), pinned
equal by tests/test_torch_hosting.py.

The reference's traced SLO table found its hosted commit path
transport-bound: the ``net_to_peer`` + ``ack_to_commit`` hops took most
of the commit p50. Between co-hosted member processes that loop is
pure overhead: ``step.pack_outbox`` already emits wire-width
``REC_DTYPE`` words on device and the v2 msgblock codec is a pure
buffer view — serializing them into a socket only to ``np.frombuffer``
them back out on the same host is the paper's L3 rafthttp boundary
rebuilt as syscalls.

``ShmFabric`` replaces it with mmap'd SPSC rings:

* **One ordered lane per (src, dst) member pair**, each lane two
  file-backed mmap rings — a LIVE ring for payload-free records
  (heartbeats/acks/votes) and a BULK ring for entry-carrying MsgApp
  frames. Two rings per lane is the rafthttp two-channel discipline
  (ref: server/etcdserver/api/rafthttp/peer.go:337-349): a ring full
  of append payloads must never starve or drop liveness traffic, or
  followers churn leadership under load. The receiver drains every
  LIVE ring dry before taking a bounded batch from any BULK ring.
* **Zero-copy block frames**: the sender writes the block sections
  (REC_DTYPE records, ENT_DTYPE headers, flat payload) straight into
  the ring through numpy views over the mmap — one vectorized copy
  per section, no per-frame ``struct.pack``, no socket syscall, no
  intermediate ``bytes``. The receiver re-ingests with ONE owned copy
  out of the ring (``rn.step_block`` defers blocks to the next round,
  so a view into the ring would be overwritten under it) and
  ``MsgBlock.from_bytes`` over that copy is pure ``np.frombuffer``
  views. Frame bodies reuse the TCP layout (``u4 group-or-sentinel |
  block/message bytes``) so the object path (MsgSnap) rides the same
  rings.
* **SPSC by construction**: per ring, exactly one writing fabric and
  one reading fabric. ``wpos``/``rpos`` are monotone u64 byte counters
  in the ring header page (aligned 8-byte stores — atomic on every
  platform the port runs on); the writer publishes ``wpos`` only after the
  body copy completes, the reader advances ``rpos`` only after its
  copy-out, so neither side ever reads bytes the other may touch.
  Frames never wrap: a frame that would cross the ring end writes a
  wrap marker and restarts at offset 0, keeping every read a single
  contiguous view. (Writer-side entry is serialized by a per-lane
  lock: the member round thread and FaultyFabric's delayed-delivery
  pump both call ``send_block``.)
* **Drop-don't-block with counted losses** (ref:
  etcdserver/raft.go:108-111): ring full, oversize, unroutable and
  corrupt frames count on the shared
  ``etcd_tpu_router_loss_total{transport="shm"}`` registry — the same
  source of truth as InProcRouter/TCPRouter — and ``stats()`` reports
  this instance's deltas, so chaos checkers and the admin 'stats' op
  read all three fabrics identically.
* **Crash/restart composes** with ``FaultyFabric``/``ChaosHarness``
  through the same ``member._send``/``_send_block`` seam and an
  incarnation discipline on the rings themselves: positions are
  monotone and live in the shared header, so a restarted *writer*
  resumes after its crashed incarnation's last published frame
  (partial writes beyond ``wpos`` were never visible), and a
  restarted *reader* RESYNCS — frames addressed to the dead
  incarnation are walked, counted (``stale_drop``) and skipped, never
  delivered to the successor. Frames sent to a crashed peer meanwhile
  fill its rings and count as ``ring_full_drop``; nothing is silent.

Occupancy, high-water, frame and copied-byte counters per lane are
exported as the ``etcd_tpu_shm_*`` metric families and through
``lane_stats()`` (the fleet console's transport column).
"""

from __future__ import annotations

import mmap
import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from .msgblock import (
    ENT_DTYPE,
    ENT_SIZE,
    REC_DTYPE,
    REC_SIZE,
    WIRE_VERSION,
    MsgBlock,
)
from .telemetry import (
    router_loss_counter,
    shm_copy_bytes_counter,
    shm_frames_counter,
    shm_ring_depth_gauge,
    shm_ring_full_counter,
    shm_ring_high_water_gauge,
)

# Group-id sentinel marking SoA block frames — the same value as
# TCPRouter.BLOCK_SENTINEL so a frame body is transport-portable.
BLOCK_SENTINEL = 0xFFFFFFFF
# Ring-level marker: a length word of all-ones means "wrap to offset
# 0" (no frame body follows). Frame lengths are bounded far below it.
_WRAP = 0xFFFFFFFF

_HDR_BYTES = 4096  # one page: u8[cap, wpos, rpos, high_water, frames, bytes]
_IDX_CAP, _IDX_WPOS, _IDX_RPOS, _IDX_HW, _IDX_FRAMES, _IDX_BYTES = range(6)


def _align4(n: int) -> int:
    return (n + 3) & ~3


class ShmRing:
    """One file-backed mmap SPSC byte ring.

    Layout: a 4KiB header page (six u8 counters, see ``_IDX_*``)
    followed by ``capacity`` data bytes. ``wpos``/``rpos`` are monotone
    byte counts (never wrapped); ``pos % capacity`` is the data offset.
    The file is created zero-filled on first touch by either side —
    zero positions are a valid empty ring, so creation needs no
    cross-process handshake. Capacity is written once and verified by
    later openers (a size mismatch between two builds must fail loud,
    not misparse)."""

    def __init__(self, path: str, capacity: int) -> None:
        if capacity <= _HDR_BYTES:
            raise ValueError(f"ring capacity too small: {capacity}")
        self.path = path
        self.cap = int(capacity)
        size = _HDR_BYTES + self.cap
        fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o600)
        try:
            if os.fstat(fd).st_size < size:
                os.ftruncate(fd, size)
            self._mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        buf = np.frombuffer(self._mm, np.uint8)
        self._h = buf[:48].view("<u8")
        self._data = buf[_HDR_BYTES:]
        self._pending = (0, 0, 0)  # writer scratch (wpos, skip, adv)
        self._adv = 0              # reader scratch (next rpos)
        # First toucher stamps the capacity; racing stampers write the
        # same value, so no lock is needed — but a DIFFERENT value
        # means two builds disagree on the ring geometry.
        if int(self._h[_IDX_CAP]) == 0:
            self._h[_IDX_CAP] = self.cap
        elif int(self._h[_IDX_CAP]) != self.cap:
            raise ValueError(
                f"{path}: ring capacity {int(self._h[_IDX_CAP])} != "
                f"configured {self.cap}")

    # -- writer side -----------------------------------------------------------

    def try_reserve(self, blen: int) -> Optional[int]:
        """Claim a contiguous data region for a ``blen``-byte body.
        Returns the data offset to write the body at (its u4 length
        word is already written), or None when the ring lacks space —
        the caller drops and counts. Publish with ``commit``."""
        adv = 4 + _align4(blen)
        if adv > self.cap:
            return None
        wpos = int(self._h[_IDX_WPOS])
        rpos = int(self._h[_IDX_RPOS])
        off = wpos % self.cap
        skip = self.cap - off if self.cap - off < adv else 0
        if adv + skip > self.cap - (wpos - rpos):
            return None
        if skip:
            if skip >= 4:
                self._data[off:off + 4].view("<u4")[0] = _WRAP
            off = 0
        self._pending = (wpos, skip, adv)
        self._data[off:off + 4].view("<u4")[0] = blen
        return off + 4

    def commit(self, blen: int) -> None:
        """Publish the frame reserved by the last ``try_reserve``:
        advance ``wpos`` past the wrap skip + frame in one store (the
        reader never sees a half-written frame — body bytes beyond
        ``wpos`` are invisible until this store lands)."""
        wpos, skip, adv = self._pending
        new = wpos + skip + adv
        self._h[_IDX_WPOS] = new
        depth = new - int(self._h[_IDX_RPOS])
        if depth > int(self._h[_IDX_HW]):
            self._h[_IDX_HW] = depth
        self._h[_IDX_FRAMES] = int(self._h[_IDX_FRAMES]) + 1
        self._h[_IDX_BYTES] = int(self._h[_IDX_BYTES]) + blen

    # -- reader side -----------------------------------------------------------

    def read_view(self) -> Optional[np.ndarray]:
        """Next frame body as a VIEW into the ring (u8 array), or None
        when empty. The view is valid only until ``advance`` — copy
        out anything that outlives this poll step. Corrupt geometry
        (a length the ring cannot hold) raises ValueError after
        resyncing to ``wpos`` so one bad frame costs the backlog, not
        the lane forever (the TCP drop-the-connection analog)."""
        while True:
            wpos = int(self._h[_IDX_WPOS])
            rpos = int(self._h[_IDX_RPOS])
            if rpos >= wpos:
                return None
            off = rpos % self.cap
            if self.cap - off < 4:
                self._h[_IDX_RPOS] = rpos + (self.cap - off)
                continue
            blen = int(self._data[off:off + 4].view("<u4")[0])
            if blen == _WRAP:
                self._h[_IDX_RPOS] = rpos + (self.cap - off)
                continue
            adv = 4 + _align4(blen)
            if adv > self.cap - off or rpos + adv > wpos:
                self._h[_IDX_RPOS] = wpos  # resync: skip the backlog
                raise ValueError(
                    f"{self.path}: corrupt frame length {blen} at "
                    f"rpos {rpos}")
            self._adv = rpos + adv
            return self._data[off + 4:off + 4 + blen]

    def advance(self) -> None:
        """Release the frame returned by the last ``read_view`` (the
        writer may reuse its bytes after this store)."""
        self._h[_IDX_RPOS] = self._adv

    def resync(self) -> Tuple[int, int]:
        """Reader (re)attach: walk the unread region, then skip it.
        Returns (frames, records) skipped — a restarted reader is a
        NEW incarnation, and frames addressed to its predecessor must
        drop *counted*, never deliver to the successor."""
        frames = records = 0
        while True:
            try:
                body = self.read_view()
            except ValueError:
                frames += 1
                break
            if body is None:
                break
            frames += 1
            if len(body) >= 9 and int(
                    body[:4].view("<u4")[0]) == BLOCK_SENTINEL:
                records += int(body[5:9].view("<u4")[0])
            else:
                records += 1
            self.advance()
        return frames, records

    # -- stats -----------------------------------------------------------------

    def depth(self) -> int:
        return int(self._h[_IDX_WPOS]) - int(self._h[_IDX_RPOS])

    def high_water(self) -> int:
        return int(self._h[_IDX_HW])

    def frames(self) -> int:
        return int(self._h[_IDX_FRAMES])

    def bytes_written(self) -> int:
        return int(self._h[_IDX_BYTES])


def lane_path(shm_dir: str, src: int, dst: int, cls: str) -> str:
    return os.path.join(shm_dir, f"lane-{src}-to-{dst}-{cls}.ring")


class ShmFabric:
    """Shared-memory peer fabric for one ``MultiRaftMember``.

    Mirrors the TCPRouter surface — ``add_peer``/``stats``/``stop``,
    programs ``member._send`` + ``member._send_block`` — so the
    hosting layer, AdminServer, FaultyFabric and ChaosHarness treat
    all three transports identically."""

    kind = "shm"
    LIVE, BULK = "live", "bulk"
    # Defaults sized for G<=1024: a round's block frame is ~2*G*36B +
    # entries, so the bulk ring holds tens of rounds of backlog before
    # drop-don't-block engages; the live ring's records are 36B each.
    BULK_BYTES = 4 << 20
    LIVE_BYTES = 1 << 20
    # Bulk frames drained per lane per poll iteration before the live
    # rings are re-checked (liveness-over-bulk on the read side too).
    BULK_BATCH = 8

    def __init__(self, member, shm_dir: str,
                 bulk_bytes: int = BULK_BYTES,
                 live_bytes: int = LIVE_BYTES,
                 poll_interval: float = 0.0005) -> None:
        from ..transport.codec import MAX_FRAME, decode_message, \
            encode_message

        self.member = member
        self.shm_dir = shm_dir
        os.makedirs(shm_dir, exist_ok=True)
        self._bulk_bytes = int(bulk_bytes)
        self._live_bytes = int(live_bytes)
        self._poll = float(poll_interval)
        self._enc, self._dec = encode_message, decode_message
        # Frames bigger than the codec cap or the target ring are
        # chunked/dropped like TCP's oversize discipline (per-ring:
        # a live frame must fit the live ring even when empty).
        self._max_frame = MAX_FRAME
        self._stopped = threading.Event()
        self._lock = threading.Lock()
        # peer id -> (live ring, bulk ring, writer lock): outbound.
        self._out: Dict[int, Tuple[ShmRing, ShmRing,
                                   threading.Lock]] = {}
        # peer id -> (live ring, bulk ring): inbound (this side reads).
        self._in: Dict[int, Tuple[ShmRing, ShmRing]] = {}
        # Loss counters on the shared registry (ONE source of truth
        # across transports); stats() reads per-instance deltas.
        self._loss = router_loss_counter()
        self._children: Dict[str, Tuple[object, float]] = {}
        self._stats_lock = threading.Lock()
        # etcd_tpu_shm_* families: per-lane gauges/counters, label
        # children cached; counters carry per-instance bases so a
        # restarted member's fabric reports its own deltas.
        self._g_depth = shm_ring_depth_gauge()
        self._g_hw = shm_ring_high_water_gauge()
        self._c_frames = shm_frames_counter()
        self._c_copy = shm_copy_bytes_counter()
        self._c_full = shm_ring_full_counter()
        self._lane_children: Dict[Tuple[int, str], Tuple] = {}
        member._send = self.send
        member._send_block = self.send_block
        self._rx = threading.Thread(target=self._recv_loop, daemon=True)
        self._rx_started = False

    # -- wiring ----------------------------------------------------------------

    def add_peer(self, peer_id: int,
                 addr: Optional[Tuple[str, int]] = None) -> None:
        """Open (creating if absent) both directions of the lane to
        ``peer_id``. ``addr`` is accepted and ignored — lanes are
        addressed by member id, which keeps the TCPRouter call shape.
        The inbound side resyncs: anything a prior incarnation of this
        member never drained is counted stale and skipped."""
        me = self.member.id
        with self._lock:
            if peer_id in self._out or peer_id == me:
                return
            out = (
                ShmRing(lane_path(self.shm_dir, me, peer_id, self.LIVE),
                        self._live_bytes),
                ShmRing(lane_path(self.shm_dir, me, peer_id, self.BULK),
                        self._bulk_bytes),
                threading.Lock(),
            )
            inn = (
                ShmRing(lane_path(self.shm_dir, peer_id, me, self.LIVE),
                        self._live_bytes),
                ShmRing(lane_path(self.shm_dir, peer_id, me, self.BULK),
                        self._bulk_bytes),
            )
            stale = 0
            for ring in inn:
                _frames, recs = ring.resync()
                stale += recs
            self._out[peer_id] = out
            self._in[peer_id] = inn
        if stale:
            self._count("stale_drop", stale)
        if not self._rx_started:
            self._rx_started = True
            self._rx.start()

    # -- loss accounting -------------------------------------------------------

    def _count(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            ent = self._children.get(key)
            if ent is None:
                child = self._loss.labels(
                    "shm", str(self.member.id), key)
                ent = (child, child.value())
                self._children[key] = ent
        ent[0].inc(n)

    def stats(self) -> Dict[str, int]:
        """Loss/error counters for this fabric instance — the shm
        analog of TCPRouter.stats(): ring_full_drop, oversize_drop,
        no_route, recv_corrupt, deliver_error, stale_drop. Values are
        read back from the shared registry, scoped to this instance."""
        with self._stats_lock:
            items = list(self._children.items())
        return {k: int(child.value() - base)
                for k, (child, base) in items}

    def _lane_metrics(self, peer: int, cls: str):
        ent = self._lane_children.get((peer, cls))
        if ent is None:
            lab = (str(self.member.id), str(peer), cls)
            ent = (self._g_depth.labels(*lab), self._g_hw.labels(*lab),
                   self._c_frames.labels(*lab), self._c_copy.labels(*lab),
                   self._c_full.labels(*lab))
            self._lane_children[(peer, cls)] = ent
        return ent

    def lane_stats(self) -> Dict[str, Dict[str, int]]:
        """Per-outbound-lane ring occupancy for the fleet console's
        transport column: depth (bytes backed up), high-water, frames
        and body bytes written over the lane's lifetime."""
        with self._lock:
            out = list(self._out.items())
        lanes: Dict[str, Dict[str, int]] = {}
        for peer, (live, bulk, _wl) in out:
            for cls, ring in ((self.LIVE, live), (self.BULK, bulk)):
                lanes[f"{peer}:{cls}"] = {
                    "depth": ring.depth(),
                    "high_water": ring.high_water(),
                    "frames": ring.frames(),
                    "bytes": ring.bytes_written(),
                }
        return lanes

    # -- outbound --------------------------------------------------------------

    def _write_block(self, peer: int, ring: ShmRing, wl, blk,
                     cls: str) -> None:
        """One block frame into the ring: sentinel word + the v2 wire
        sections, each copied through a numpy view over the mmap —
        the packed record array lands with one vectorized copy, no
        struct.pack, no intermediate bytes object."""
        n = len(blk.rec)
        ne = len(blk.ent_term)
        npay = len(blk.payload)
        blen = 4 + 5 + n * REC_SIZE + 4 + ne * ENT_SIZE + npay
        if blen > min(self._max_frame, ring.cap - 8):
            if n > 1:
                half = n // 2
                self._write_block(peer, ring, wl,
                                  blk.take(slice(0, half)), cls)
                self._write_block(peer, ring, wl,
                                  blk.take(slice(half, None)), cls)
            else:
                self._count("oversize_drop")
            return
        depth_g, hw_g, frames_c, copy_c, full_c = \
            self._lane_metrics(peer, cls)
        with wl:
            if self._stopped.is_set():
                return
            o = ring.try_reserve(blen)
            if o is None:
                full_c.inc()
                self._count("ring_full_drop", n)
                return
            data = ring._data
            data[o:o + 4].view("<u4")[0] = BLOCK_SENTINEL
            o += 4
            data[o] = WIRE_VERSION
            data[o + 1:o + 5].view("<u4")[0] = n
            o += 5
            if n:
                data[o:o + n * REC_SIZE].view(REC_DTYPE)[:] = blk.rec
                o += n * REC_SIZE
            data[o:o + 4].view("<u4")[0] = ne
            o += 4
            if ne:
                hdr = data[o:o + ne * ENT_SIZE].view(ENT_DTYPE)
                hdr["term"] = blk.ent_term
                hdr["etype"] = blk.ent_etype
                hdr["len"] = blk.ent_len
                o += ne * ENT_SIZE
            if npay:
                data[o:o + npay] = np.frombuffer(blk.payload, np.uint8)
            ring.commit(blen)
            depth_g.set(ring.depth())
            hw_g.set(ring.high_water())
        frames_c.inc()
        copy_c.inc(blen)

    def send_block(self, _from_id: int, blk) -> None:
        """Ship a SoA block: per target, the payload-free half rides
        the LIVE ring and the entry-carrying half the BULK ring — the
        same two-channel split as TCPRouter.send_block, on rings
        instead of priority queues."""
        if self._stopped.is_set():
            return
        rec = blk.rec
        tos = np.unique(rec["to"]).tolist()
        has_ents = rec["n_ents"] > 0
        any_ents = bool(has_ents.any())
        for to in tos:
            to = int(to)
            with self._lock:
                out = self._out.get(to)
            tmask = rec["to"] == to
            if out is None:
                self._count("no_route", int(tmask.sum()))
                continue
            live_ring, bulk_ring, wl = out
            if any_ents and (tmask & has_ents).any():
                live = blk.take(tmask & ~has_ents)
                bulk = blk.take(tmask & has_ents)
                if len(live):
                    self._write_block(to, live_ring, wl, live,
                                      self.LIVE)
                self._write_block(to, bulk_ring, wl, bulk, self.BULK)
            elif len(tos) == 1:
                self._write_block(to, live_ring, wl, blk, self.LIVE)
            else:
                self._write_block(to, live_ring, wl, blk.take(tmask),
                                  self.LIVE)

    def send(self, _from_id: int, batch: List[Tuple[int, "object"]]) -> None:
        """Object path (MsgSnap and other low-volume traffic): the
        encoded message rides the BULK ring in a TCP-shaped frame
        (``u4 group | codec bytes``). Rare by construction — the hot
        path is send_block — so a per-message encode is fine here."""
        if self._stopped.is_set():
            return
        for group, m in batch:
            to = int(m.to)
            with self._lock:
                out = self._out.get(to)
            if out is None:
                self._count("no_route")
                continue
            _live, bulk_ring, wl = out
            payload = self._enc(m)[4:]  # strip the codec length prefix
            blen = 4 + len(payload)
            if blen > min(self._max_frame, bulk_ring.cap - 8):
                self._count("oversize_drop")
                continue
            _dg, _hg, frames_c, copy_c, full_c = \
                self._lane_metrics(to, self.BULK)
            with wl:
                if self._stopped.is_set():
                    return
                o = bulk_ring.try_reserve(blen)
                if o is None:
                    full_c.inc()
                    self._count("ring_full_drop")
                    continue
                data = bulk_ring._data
                data[o:o + 4].view("<u4")[0] = group
                data[o + 4:o + blen] = np.frombuffer(payload, np.uint8)
                bulk_ring.commit(blen)
            frames_c.inc()
            copy_c.inc(blen)

    # -- inbound ---------------------------------------------------------------

    def _deliver(self, body: np.ndarray) -> None:
        """One frame off a ring. ``body`` is a view into the ring —
        the block path snapshots it ONCE into an owned buffer
        (step_block defers blocks to the next round) and decodes with
        pure frombuffer views over that copy."""
        group = int(body[:4].view("<u4")[0])
        if group == BLOCK_SENTINEL:
            owned = body[4:].tobytes()
            try:
                blk = MsgBlock.from_bytes(owned)
            except ValueError:
                self._count("recv_corrupt")
                return
            try:
                self.member.deliver_block(blk)
            except Exception:  # noqa: BLE001 — lossy-net semantics
                self._count("deliver_error")
            return
        try:
            m = self._dec(body[4:].tobytes())
        except Exception:  # noqa: BLE001 — corrupt frame: drop it
            self._count("recv_corrupt")
            return
        try:
            self.member.deliver(group, m)
        except Exception:  # noqa: BLE001 — lossy-net semantics
            self._count("deliver_error")

    def _drain(self, ring: ShmRing, budget: int) -> int:
        """Up to ``budget`` frames off one ring; returns frames
        delivered. A corrupt length resyncs the ring (read_view) and
        counts the lost backlog as one corrupt event."""
        done = 0
        while done < budget and not self._stopped.is_set():
            try:
                body = ring.read_view()
            except ValueError:
                self._count("recv_corrupt")
                return done + 1
            if body is None:
                return done
            self._deliver(body)
            ring.advance()
            done += 1
        return done

    def _recv_loop(self) -> None:
        """Receiver: every poll iteration drains ALL live rings dry
        first, then a bounded batch per bulk ring — liveness frames
        never queue behind an append backlog (the read-side half of
        the two-channel discipline)."""
        while not self._stopped.is_set():
            with self._lock:
                lanes = list(self._in.items())
            moved = 0
            for _pid, (live, _bulk) in lanes:
                moved += self._drain(live, 1 << 30)
            for _pid, (live, bulk) in lanes:
                moved += self._drain(bulk, self.BULK_BATCH)
                moved += self._drain(live, 1 << 30)
            if not moved:
                self._stopped.wait(self._poll)

    # -- lifecycle -------------------------------------------------------------

    def stop(self) -> None:
        """Stop the receiver and fence writers. The mmaps are left to
        the GC on purpose: numpy views exported to delivered blocks
        may outlive the fabric, and mmap.close() with live exports
        raises. Ring FILES persist — a restarted incarnation reopens
        them, resumes its write positions and resyncs its read
        positions (see add_peer)."""
        self._stopped.set()
        with self._lock:
            out = list(self._out.values())
        # Serialize with in-flight writers so no view write races the
        # teardown; after this, send/send_block return at the gate.
        for _live, _bulk, wl in out:
            with wl:
                pass
        if self._rx_started:
            self._rx.join(timeout=5)
