"""The shared-memory ring fabric's cells (tests/batched/test_shmfabric.py)
on the port's batched/shmfabric.py, plus rings shared across packages.

The ring and fabric contract: ordered SPSC frames, wrap-at-end,
drop-don't-block on full, corrupt-length resync, reopen with monotone
positions, block frames bit-exact through the ring, payload-free
records on the LIVE lane and entry-carrying ones on BULK, loss
accounting on the shared router-loss registry, stop() fencing writers,
and the object path (MsgSnap) on the same rings. A member of one
package writes into the ring files a member of the other package reads:
frames cross unchanged both ways (the file layout is the reference's).
"""

import threading
import time

import numpy as np
import pytest

from etcd_tpu.batched import msgblock as jmsgblock
from etcd_tpu.batched import shmfabric as jshm
from etcd_tpu_torch.batched import msgblock as tmsgblock
from etcd_tpu_torch.batched import shmfabric as tshm
from etcd_tpu_torch.batched.msgblock import REC_DTYPE, MsgBlock
from etcd_tpu_torch.batched.shmfabric import (
    _HDR_BYTES,
    BLOCK_SENTINEL,
    ShmFabric,
    ShmRing,
    lane_path,
)

class FakeMember:
    """Just the surface ShmFabric programs and calls back into."""

    def __init__(self, mid):
        self.id = mid
        self.blocks = []
        self.objs = []
        self._send = None
        self._send_block = None

    def deliver_block(self, blk):
        self.blocks.append(blk)

    def deliver(self, group, m):
        self.objs.append((group, m))


def _wait(pred, timeout=5.0):
    t0 = time.time()
    while not pred():
        if time.time() - t0 > timeout:
            return False
        time.sleep(0.002)
    return True


def _mkblock(to, n=3, ents_on_last=0):
    rec = np.zeros(n, REC_DTYPE)
    rec["to"] = to
    ents = [None] * n
    if ents_on_last:
        rec["n_ents"][-1] = ents_on_last
        ents[-1] = [(7, 0, bytes([65 + i]) * 5)
                    for i in range(ents_on_last)]
    return MsgBlock(rec, ents)


# ---------------------------------------------------------------------------
# ShmRing


class TestShmRing:
    def _ring(self, tmp_path, cap=1 << 16):
        return ShmRing(str(tmp_path / "r.ring"), cap)

    def test_ordered_frames(self, tmp_path):
        r = self._ring(tmp_path)
        for i in range(10):
            body = bytes([i]) * (i + 1)
            off = r.try_reserve(len(body))
            assert off is not None
            r._data[off:off + len(body)] = np.frombuffer(body, np.uint8)
            r.commit(len(body))
        for i in range(10):
            v = r.read_view()
            assert v is not None and bytes(v) == bytes([i]) * (i + 1)
            r.advance()
        assert r.read_view() is None
        assert r.frames() == 10 and r.depth() == 0

    def test_wrap_keeps_frames_contiguous(self, tmp_path):
        # Capacity sized so frames land on awkward offsets and the
        # writer must wrap mid-stream many times.
        r = self._ring(tmp_path, cap=_HDR_BYTES + 1)  # cap must exceed hdr
        r = ShmRing(str(tmp_path / "w.ring"), 8192)
        bodies = [bytes([i % 251]) * (100 + (i * 37) % 500)
                  for i in range(200)]
        got = []
        for b in bodies:
            off = r.try_reserve(len(b))
            assert off is not None
            r._data[off:off + len(b)] = np.frombuffer(b, np.uint8)
            r.commit(len(b))
            v = r.read_view()
            got.append(bytes(v))
            r.advance()
        assert got == bodies

    def test_full_ring_drops_not_blocks(self, tmp_path):
        r = ShmRing(str(tmp_path / "f.ring"), 8192)
        n_in = 0
        while True:
            off = r.try_reserve(1000)
            if off is None:
                break
            r.commit(1000)
            n_in += 1
        assert 0 < n_in < 9  # bounded by capacity
        # Reader frees space; writer can proceed again.
        assert r.read_view() is not None
        r.advance()
        assert r.try_reserve(1000) is not None

    def test_corrupt_length_resyncs(self, tmp_path):
        r = ShmRing(str(tmp_path / "c.ring"), 8192)
        off = r.try_reserve(16)
        r.commit(16)
        # Scribble an impossible length over the committed frame.
        r._data[off - 4:off].view("<u4")[0] = 7_000_000
        with pytest.raises(ValueError):
            r.read_view()
        # Resynced to wpos: ring usable again.
        assert r.read_view() is None
        assert r.try_reserve(16) is not None

    def test_reopen_resumes_positions(self, tmp_path):
        path = str(tmp_path / "p.ring")
        w = ShmRing(path, 8192)
        for i in range(3):
            off = w.try_reserve(8)
            w._data[off:off + 8] = i
            w.commit(8)
        # A second handle (the cross-process case: same file, fresh
        # mmap) sees the same positions and the same frames.
        rd = ShmRing(path, 8192)
        assert rd.depth() == w.depth()
        seen = []
        f, recs = rd.resync()
        assert f == 3 and recs == 3  # non-block frames count 1 each
        assert rd.depth() == 0 and w.depth() == 0
        del seen

    def test_capacity_mismatch_fails_loud(self, tmp_path):
        path = str(tmp_path / "m.ring")
        ShmRing(path, 8192)
        with pytest.raises(ValueError):
            ShmRing(path, 16384)


# ---------------------------------------------------------------------------
# ShmFabric


class TestShmFabric:
    def _pair(self, tmp_path):
        m1, m2 = FakeMember(1), FakeMember(2)
        f1 = ShmFabric(m1, str(tmp_path))
        f2 = ShmFabric(m2, str(tmp_path))
        f1.add_peer(2)
        f2.add_peer(1)
        return m1, m2, f1, f2

    def test_block_roundtrip_and_lane_split(self, tmp_path):
        m1, m2, f1, f2 = self._pair(tmp_path)
        try:
            blk = _mkblock(to=2, n=3, ents_on_last=2)
            m1._send_block(1, blk)
            assert _wait(lambda: len(m2.blocks) == 2)
            # Payload-free half rode LIVE, entry half rode BULK.
            by_ents = sorted(m2.blocks, key=lambda b: len(b.ent_term))
            assert len(by_ents[0].rec) == 2
            assert len(by_ents[0].ent_term) == 0
            assert len(by_ents[1].rec) == 1
            assert bytes(by_ents[1].payload) == b"AAAAABBBBB"
            np.testing.assert_array_equal(
                by_ents[1].rec["n_ents"], [2])
            lanes = f1.lane_stats()
            assert lanes["2:live"]["frames"] == 1
            assert lanes["2:bulk"]["frames"] == 1
            assert lanes["2:live"]["depth"] == 0
            assert f1.stats() == {} and f2.stats() == {}
        finally:
            f1.stop()
            f2.stop()

    def test_ordered_delivery_per_lane(self, tmp_path):
        m1, m2, f1, f2 = self._pair(tmp_path)
        try:
            for i in range(50):
                rec = np.zeros(1, REC_DTYPE)
                rec["to"] = 2
                rec["term"] = i
                m1._send_block(1, MsgBlock(rec))
            assert _wait(lambda: len(m2.blocks) == 50)
            terms = [int(b.rec["term"][0]) for b in m2.blocks]
            assert terms == list(range(50))
        finally:
            f1.stop()
            f2.stop()

    def test_no_route_counts(self, tmp_path):
        m1, m2, f1, f2 = self._pair(tmp_path)
        try:
            m1._send_block(1, _mkblock(to=9, n=4))
            assert f1.stats().get("no_route") == 4
        finally:
            f1.stop()
            f2.stop()

    def test_ring_full_drop_counts_never_blocks(self, tmp_path):
        m1 = FakeMember(1)
        f1 = ShmFabric(m1, str(tmp_path), bulk_bytes=16384,
                       live_bytes=16384)
        # No reader attached for member 2's side reading: peer rings
        # exist but nothing drains them -> fill to drop.
        f1.add_peer(2)
        try:
            blk = _mkblock(to=2, n=64)
            sent = 0
            t0 = time.time()
            while not f1.stats().get("ring_full_drop"):
                m1._send_block(1, blk)
                sent += 1
                assert time.time() - t0 < 5, "never dropped"
            st = f1.stats()
            assert st["ring_full_drop"] % 64 == 0
            assert f1.lane_stats()["2:live"]["high_water"] > 0
        finally:
            f1.stop()

    def test_oversize_chunks_by_halving(self, tmp_path):
        m1, m2, f1, f2 = self._pair(tmp_path)
        try:
            # One block far larger than the live ring: must arrive as
            # several chunked frames, nothing dropped.
            n = 40000  # 40000*36B ≈ 1.4MB > LIVE_BYTES (1MB)
            rec = np.zeros(n, REC_DTYPE)
            rec["to"] = 2
            rec["term"] = np.arange(n, dtype=np.uint32)
            m1._send_block(1, MsgBlock(rec))

            def accounted():
                got = sum(len(b.rec) for b in m2.blocks)
                return got + f1.stats().get("ring_full_drop", 0) == n

            # Every record is either delivered (in order, chunked) or
            # a COUNTED ring-full drop — never an oversize drop, never
            # silent. (A 720KB half can race ring-full against the
            # drain of its sibling; drop-don't-block allows that.)
            assert _wait(accounted)
            assert f1.stats().get("oversize_drop") is None
            assert len(m2.blocks) >= 1  # chunking happened
            assert all(len(b.rec) < n for b in m2.blocks)
            terms = np.concatenate(
                [b.rec["term"] for b in m2.blocks])
            assert np.all(np.diff(terms.astype(np.int64)) > 0)
        finally:
            f1.stop()
            f2.stop()

    def test_restart_resyncs_stale_frames(self, tmp_path):
        m1, m2, f1, f2 = self._pair(tmp_path)
        f2.stop()  # peer 2 "crashes" with frames in flight
        try:
            m1._send_block(1, _mkblock(to=2, n=5))
            time.sleep(0.05)
            # Successor incarnation attaches: the 5 records addressed
            # to the dead incarnation are counted stale, not delivered.
            m2b = FakeMember(2)
            f2b = ShmFabric(m2b, str(tmp_path))
            f2b.add_peer(1)
            try:
                assert f2b.stats().get("stale_drop") == 5
                m1._send_block(1, _mkblock(to=2, n=2))
                assert _wait(
                    lambda: sum(len(b.rec) for b in m2b.blocks) == 2)
                assert not m2.blocks
            finally:
                f2b.stop()
        finally:
            f1.stop()

    def test_object_path_rides_bulk_ring(self, tmp_path):
        from etcd_tpu_torch.raft.types import Message, MessageType

        m1, m2, f1, f2 = self._pair(tmp_path)
        try:
            m = Message(type=MessageType.MsgHeartbeat, to=2, from_=1,
                        term=3)
            m1._send(1, [(4, m)])
            assert _wait(lambda: len(m2.objs) == 1)
            group, got = m2.objs[0]
            assert group == 4
            assert got.type == MessageType.MsgHeartbeat and got.term == 3
            assert f1.lane_stats()["2:bulk"]["frames"] == 1
        finally:
            f1.stop()
            f2.stop()

    def test_stop_fences_writers(self, tmp_path):
        m1, m2, f1, f2 = self._pair(tmp_path)
        f1.stop()
        f2.stop()
        before = f1.lane_stats()["2:live"]["frames"]
        m1._send_block(1, _mkblock(to=2, n=3))
        assert f1.lane_stats()["2:live"]["frames"] == before

    def test_concurrent_writers_one_lane(self, tmp_path):
        # The member round thread and FaultyFabric's delay pump both
        # call send_block; the per-lane writer lock must keep frames
        # whole under that interleaving.
        m1, m2, f1, f2 = self._pair(tmp_path)
        try:
            n_threads, per = 4, 50

            def pump(tid):
                for i in range(per):
                    rec = np.zeros(1, REC_DTYPE)
                    rec["to"] = 2
                    rec["term"] = tid * per + i
                    m1._send_block(1, MsgBlock(rec))

            ts = [threading.Thread(target=pump, args=(t,))
                  for t in range(n_threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            assert _wait(
                lambda: len(m2.blocks) == n_threads * per)
            assert f1.stats().get("recv_corrupt") is None
            assert f2.stats().get("recv_corrupt") is None
            terms = sorted(int(b.rec["term"][0]) for b in m2.blocks)
            assert terms == list(range(n_threads * per))
        finally:
            f1.stop()
            f2.stop()

    def test_lane_path_shape(self, tmp_path):
        assert lane_path("/x", 1, 2, "live") == "/x/lane-1-to-2-live.ring"
        assert BLOCK_SENTINEL == 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Rings shared across packages


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_frames_cross_packages(tmp_path, writer):
    """Member 1 of one package sends a block with entries and a MsgSnap
    object to member 2 of the other package over the same ring files:
    equal records, entry payloads and message fields arrive."""
    from etcd_tpu.raft import types as jtypes
    from etcd_tpu_torch.raft import types as ttypes

    pkgs = {"jax": (jshm, jmsgblock, jtypes),
            "port": (tshm, tmsgblock, ttypes)}
    reader = "port" if writer == "jax" else "jax"
    wshm, wblk, wtypes = pkgs[writer]
    rshm = pkgs[reader][0]
    m1, m2 = FakeMember(1), FakeMember(2)
    f1 = wshm.ShmFabric(m1, str(tmp_path))
    f2 = rshm.ShmFabric(m2, str(tmp_path))
    f1.add_peer(2)
    f2.add_peer(1)
    try:
        rec = np.zeros(4, wblk.REC_DTYPE)
        rec["to"] = 2
        rec["term"] = [5, 6, 7, 8]
        rec["index"] = [10, 11, 12, 13]
        rec["n_ents"][-1] = 2
        ents = [None] * 3 + [[(7, 0, b"alpha"), (7, 2, b"beta")]]
        m1._send_block(1, wblk.MsgBlock(rec, ents))
        snap = wtypes.Message(
            type=wtypes.MessageType.MsgSnap, to=2, from_=1, term=9,
            snapshot=wtypes.Snapshot(data=b"state", metadata=(
                wtypes.SnapshotMetadata(index=40, term=8))))
        m1._send(1, [(3, snap)])
        assert _wait(lambda: sum(len(b.rec) for b in m2.blocks) == 4
                     and len(m2.objs) == 1)
        got = np.concatenate([b.rec for b in m2.blocks])
        got = got[np.argsort(got["term"])]
        assert got.tobytes() == rec.tobytes()
        ent_blk = next(b for b in m2.blocks if len(b.ent_term))
        assert bytes(ent_blk.payload) == b"alphabeta"
        assert ent_blk.ent_term.tolist() == [7, 7]
        assert ent_blk.ent_etype.tolist() == [0, 2]
        group, m = m2.objs[0]
        assert group == 3 and int(m.type) == int(snap.type)
        assert (m.term, m.snapshot.data, m.snapshot.metadata.index,
                m.snapshot.metadata.term) == (9, b"state", 40, 8)
        assert f1.stats() == {} and f2.stats() == {}
    finally:
        f1.stop()
        f2.stop()
