"""The quick log-lifecycle and WAL-pipeline cells on the port
(tests/batched/test_lifecycle.py, tests/batched/test_wal_pipeline.py).

Rotation, cadence snapshots, sealed-segment release and ring
back-pressure; the async group-commit WAL pipeline's crash windows, its
deterministic stop drain, a pipeline-on chaos episode over TCP under the
lock-order sentinel, and the group-commit coverage and metric families.
Every harness episode runs CPU members at test_chaos.CFG's values and
closes strict (run_invariant_checks, invariant_trips() == 0).

Harness members tick every TICK seconds, about one tick per member round
of the port's eager CPU round. MultiRaftCluster members keep hosting's
default 0.02 s (the cluster takes no tick interval); their ticks queue
and each round consumes one.
"""

import os
import time

import pytest

from etcd_tpu_torch.analysis.lockorder import LockOrderRecorder
from etcd_tpu_torch.batched.faults import (
    ChaosHarness,
    FaultSpec,
    LeaderObserver,
    run_invariant_checks,
)
from etcd_tpu_torch.batched.hosting import MultiRaftCluster
from etcd_tpu_torch.batched.state import BatchedConfig
from etcd_tpu_torch.pkg import failpoint
from etcd_tpu_torch.pkg import metrics as pmet

pytestmark = pytest.mark.chaos

G, R = 8, 3
CFG = BatchedConfig(
    num_groups=G, num_replicas=R, window=16, max_ents_per_msg=4,
    max_props_per_round=4, election_timeout=10, heartbeat_timeout=1,
    pre_vote=True, check_quorum=True, auto_compact=True,
    fleet_summary=True,
)
TICK = 0.06
SEEDS = tuple(
    int(s) for s in
    os.environ.get("ETCD_TPU_CHAOS_SEED", "101,202").split(",")
)
MSG_FAULTS = FaultSpec(drop=0.05, dup=0.05, delay=0.08,
                       delay_max_s=0.04, reorder=0.2)
# Snapshot every 2 applied entries, cut the tail past 1 KiB.
SNAP_CADENCE = 2
ROTATE_BYTES = 1024


@pytest.fixture(autouse=True)
def _clean_failpoints():
    yield
    failpoint.disable_all()


def harness(tmp_path, seed, spec=None, **kw):
    return ChaosHarness(str(tmp_path), seed, spec or FaultSpec(),
                        num_members=R, num_groups=G, cfg=CFG,
                        tick_interval=TICK, device="cpu", **kw)


def lifecycle_harness(tmp_path, seed):
    return harness(tmp_path, seed, snap_cadence=SNAP_CADENCE,
                   wal_rotate_bytes=ROTATE_BYTES)


def _wait(pred, timeout=90.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _total(h, stat):
    return sum(int(m.stats.get(stat, 0)) for m in h.members.values())


# -- log lifecycle ------------------------------------------------------------------


def test_rotate_snapshot_release_restart_replay(tmp_path):
    h = lifecycle_harness(tmp_path, SEEDS[0])
    obs = LeaderObserver(h.alive)
    try:
        h.wait_leaders()
        obs.start()
        h.run_workload(24, prefix=b"pre")
        for i in range(3):
            h.touch_all_groups(prefix=b"cad%d" % i)
        _wait(lambda: _total(h, "wal_cuts") > 0, what="a WAL segment cut")
        _wait(lambda: _total(h, "snapshots_built") > 0,
              what="a cadence snapshot build")
        _wait(lambda: _total(h, "wal_segments_released") > 0,
              what="a sealed-segment release")
        m2 = h.members[2]
        built_pre = int(m2.stats.get("snapshots_built", 0))
        hl = m2.health()
        assert hl["lifecycle"]["enabled"]
        assert hl["lifecycle"]["wal_segments"] >= 1
        assert hl["lifecycle"]["snap_files"] >= 1
        snap_root = os.path.join(m2.dir, "snap")
        for sub in os.listdir(snap_root):
            files = [n for n in os.listdir(os.path.join(snap_root, sub))
                     if n.endswith(".snap")]
            assert len(files) <= m2.snap_keep, (sub, files)

        h.crash(2)
        h.run_workload(6, prefix=b"mid")
        m2 = h.restart(2)
        if built_pre:
            assert int(m2._snap_file_idx.max()) > 0
        h.wait_leaders()
        h.touch_all_groups(prefix=b"post")
        run_invariant_checks(h, obs, expect_members=R)
    finally:
        obs.stop()
        h.stop()


def test_wal_segments_plateau_not_monotone(tmp_path):
    h = lifecycle_harness(tmp_path, SEEDS[-1])
    try:
        h.wait_leaders()
        bound = h.members[1].wal_pinned_segments + 2

        def plateaued():
            for m in h.alive():
                hl = m.health()["lifecycle"]
                if not (hl["wal_segments"] <= bound
                        and hl["segments_released"] > 0
                        and hl["wal_cuts"] > hl["wal_segments"]):
                    return False
            return True

        ok = False
        for i in range(24):
            h.touch_all_groups(prefix=b"pump%d" % i)
            if plateaued():
                ok = True
                break
        assert ok, {str(m.id): m.health()["lifecycle"] for m in h.alive()}
    finally:
        h.stop()


def test_ring_full_refusal_is_typed_and_counted(tmp_path):
    h = lifecycle_harness(tmp_path, SEEDS[0])
    try:
        h.wait_leaders()
        h.touch_all_groups(prefix=b"seed")
        h.stop()  # freeze the role/occupancy mirrors
        m = next(mm for mm in h.members.values()
                 if any(mm.rn.is_leader(g) for g in range(G)))
        g = next(gg for gg in range(G) if m.rn.is_leader(gg))
        occ_floor = CFG.window - CFG.max_props_per_round
        m.rn.m_snap[g] = m.rn.m_last[g]
        assert m.propose(g, b"x")
        assert m.stats.get("ring_full_refusals", 0) == 0
        m.rn.m_snap[g] = int(m.rn.m_last[g]) - occ_floor
        assert not m.propose(g, b"x")
        assert m.stats["ring_full_refusals"] == 1
        hl = m.health()
        assert hl["ring"]["full_refusals"] == 1
        assert hl["ring"]["window"] == CFG.window
        assert hl["ring"]["occ_high_water"] >= occ_floor
    finally:
        h.stop()


def test_fence_demand_never_dangles_into_released_segment(tmp_path):
    h = lifecycle_harness(tmp_path, SEEDS[0])
    obs = LeaderObserver(h.alive)
    try:
        h.wait_leaders()
        obs.start()
        for i in range(3):
            h.touch_all_groups(prefix=b"pre%d" % i)
        h.crash(3)
        assert h.torn_tail(3) > 0
        for i in range(3):
            h.touch_all_groups(prefix=b"mid%d" % i)
        _wait(lambda: _total(h, "wal_segments_released") > 0,
              what="release while the torn member is down")
        m3 = h.restart(3)
        if int(m3._fenced.sum()):
            fenced = m3._fenced.copy()
            assert not (m3._snap_file_idx[fenced]
                        > m3._snap_cover[fenced]).any()
        h.wait_leaders()
        h.touch_all_groups(prefix=b"heal")
        _wait(lambda: int(m3._fenced.sum()) == 0,
              what="fence heal on the torn member")
        run_invariant_checks(h, obs, expect_members=R)
    finally:
        obs.stop()
        h.stop()


# -- the async group-commit WAL pipeline --------------------------------------------


@pytest.mark.parametrize("site", ["before_save", "before_fsync_release"])
def test_crash_window_never_loses_acked_writes(tmp_path, site):
    h = harness(tmp_path, 1313, wal_pipeline=True)
    obs = LeaderObserver(h.alive)
    try:
        h.wait_leaders()
        obs.start()
        assert h.run_workload(6, prefix=b"pre") >= 3
        h.crash_on_failpoint(2, site)
        assert h.members[2]._crashed
        assert failpoint.hits(getattr(h.members[2], "_fp_" + {
            "before_save": "before_save",
            "before_fsync_release": "before_release",
        }[site])) > 0
        if site == "before_fsync_release":
            h.torn_tail(2)
        assert h.run_workload(6, prefix=b"mid") >= 3
        h.restart(2)
        h.wait_leaders()
        h.touch_all_groups()
        run_invariant_checks(h, obs, expect_members=R)
    finally:
        obs.stop()
        h.stop()


def test_stop_during_pending_fsync_drains_deterministically(tmp_path):
    c = MultiRaftCluster(str(tmp_path), num_members=R, num_groups=G,
                         cfg=CFG, wal_pipeline=True,
                         wal_group_max_delay=0.05, device="cpu")
    acked = {}
    try:
        leads = c.wait_leaders()
        for g in range(G):
            c.put(g, b"sk", b"sv%d" % g, timeout=30.0)
            acked[g] = b"sv%d" % g
        for m in c.members.values():
            failpoint.enable(m._fp_before_release, "sleep(150)")
        for g in range(G):
            c.members[int(leads[g])].propose(
                g, b"P" + b"late" + b"\x00" + b"x")
        time.sleep(0.05)
    finally:
        t0 = time.monotonic()
        c.stop()
        stop_s = time.monotonic() - t0
        failpoint.disable_all()
    assert stop_s < 30.0, f"stop() wedged for {stop_s:.1f}s"
    for m in c.members.values():
        assert m._wal_closed, f"member {m.id}: WAL left open"
        assert not m._wal_pending, (
            f"member {m.id}: {len(m._wal_pending)} waves undrained")
        assert m._wal_worker is not None
        assert not m._wal_worker.is_alive()
    c2 = MultiRaftCluster(str(tmp_path), num_members=R, num_groups=G,
                          cfg=CFG, wal_pipeline=True, device="cpu")
    try:
        _wait(lambda: all(m.get(g, b"sk") == v
                          for m in c2.members.values()
                          for g, v in acked.items()),
              timeout=30.0, what="acked writes after stop and replay")
    finally:
        c2.stop()


def test_pipeline_msg_faults_crash_restart_lockorder_strict(tmp_path):
    rec = LockOrderRecorder("walpipe-chaos-port",
                            include=lambda p: "etcd_tpu" in p)
    rec.enable()
    try:
        h = harness(tmp_path, SEEDS[0], MSG_FAULTS, transport="tcp",
                    wal_pipeline=True)
        obs = LeaderObserver(h.alive)
        try:
            h.wait_leaders()
            obs.start()
            acked = h.run_workload(8)
            assert acked >= 4, f"only {acked}/8 writes acked"
            h.crash(2)
            h.restart(2)
            h.wait_leaders()
            h.run_workload(4, prefix=b"post")
            h.plan.quiesce()
            run_invariant_checks(h, obs, expect_members=R)
        finally:
            obs.stop()
            h.stop()
    finally:
        rec.disable()
    assert rec.sites, "recorder saw no etcd_tpu locks"
    assert rec.edges, "no nested acquisitions recorded"
    rec.check()


def test_group_commit_coverage_and_metrics(tmp_path):
    """One fsync covers several rounds' batches once the dwell spans
    more than one member round. The reference's cell dwells 0.05 s
    against its ~3 ms CPU rounds; a port member's CPU round takes 60-80
    ms beside two others (more under a loaded box), so the dwell here is
    0.2 s: still under a quarter of the election timeout, which the
    queued ticks make ten member rounds."""
    c = MultiRaftCluster(str(tmp_path), num_members=R, num_groups=G,
                         cfg=CFG, wal_pipeline=True,
                         wal_group_max_delay=0.2, device="cpu")
    try:
        c.wait_leaders()
        for i in range(12):
            c.put(i % G, b"c%d" % i, b"v%d" % i, timeout=30.0)
        hp = c.members[1].health()["wal_pipeline"]
        assert hp["enabled"]
        assert hp["fsyncs"] > 0
        assert hp["rounds_per_fsync"] > 1.0, hp
        text = pmet.DEFAULT.expose()
        for fam in ("etcd_tpu_wal_pipeline_queue_depth",
                    "etcd_tpu_wal_pipeline_batches_per_fsync",
                    "etcd_tpu_wal_pipeline_bytes_per_fsync",
                    "etcd_tpu_wal_pipeline_ack_release_seconds"):
            assert fam in text, f"{fam} not registered"
    finally:
        c.stop()
