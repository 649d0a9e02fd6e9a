"""The quick torn-fence and disk-fault cells on the port
(tests/batched/test_torn_fence.py, tests/batched/test_diskfaults.py).

Each episode runs the port's ChaosHarness with CPU members at
test_chaos.CFG's values and closes strict (run_invariant_checks: KV-hash
parity, committed-never-lost, one leader per term, invariant_trips() ==
0). The WAL tail classifier and salvage cells of those files exercise
native/walog.py alone; tests/test_torch_walog.py holds the port's copy
against etcd_tpu's on the same shapes.

The fsync fail-stop victim is made leader by a transfer from the
current leader, not by campaigning: under pre-vote and check-quorum a
campaign against a live leader cannot win while its lease holds.
"""

import time

import numpy as np
import pytest

from etcd_tpu_torch.batched.faults import (
    ChaosHarness,
    DiskFaultPlan,
    FaultSpec,
    LeaderObserver,
    run_invariant_checks,
)
from etcd_tpu_torch.batched.state import BatchedConfig
from etcd_tpu_torch.pkg import failpoint

pytestmark = pytest.mark.chaos

G, R = 8, 3
SEED = 404
CFG = BatchedConfig(
    num_groups=G, num_replicas=R, window=16, max_ents_per_msg=4,
    max_props_per_round=4, election_timeout=10, heartbeat_timeout=1,
    pre_vote=True, check_quorum=True, auto_compact=True,
    fleet_summary=True,
)
# About one tick per member round of the port's eager CPU round.
TICK = 0.06


@pytest.fixture(autouse=True)
def _clean_failpoints():
    yield
    failpoint.disable_all()


def make_harness(tmp_path, seed=SEED, **kw):
    return ChaosHarness(str(tmp_path), seed, FaultSpec(), num_members=R,
                        num_groups=G, cfg=CFG, tick_interval=TICK,
                        device="cpu", **kw)


# -- fenced boot + auto-lift -------------------------------------------------------


def test_torn_acked_tail_boots_fenced_then_heals(tmp_path):
    """Tear an fsync'd acked entry mid-record: the restarted member
    boots FENCED for that group, never wins an election while fenced,
    re-converges, auto-lifts, and closes strict."""
    h = make_harness(tmp_path, seed=4242)
    obs = LeaderObserver(h.alive)
    try:
        h.wait_leaders()
        obs.start()
        for g in range(G):
            assert h.put(g, b"k-%d" % g, b"v-%d" % g), f"put g{g}"
        h.crash(3)
        chop, torn_g = h.torn_acked_tail(3)
        assert chop > 0 and torn_g >= 0, "no acked entry record to tear"

        m = h.restart(3)
        hl = m.health()
        assert hl["fence_enabled"]
        assert hl["wal_tail"] == "torn"
        assert torn_g in hl["fenced_groups"], hl
        assert hl["catchup_gap"][torn_g] >= 1

        deadline = time.monotonic() + 0.6
        while time.monotonic() < deadline:
            if m._fenced[torn_g]:
                m.campaign(np.array([torn_g]))
                assert not m.is_leader(torn_g), (
                    "fenced member won an election")
            time.sleep(0.05)

        h.touch_all_groups()
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and m._fenced.any():
            time.sleep(0.05)
        assert not m._fenced.any(), f"fence never lifted: {m.health()}"
        assert m.health()["fenced_groups"] == []

        h.plan.quiesce()
        run_invariant_checks(h, obs, expect_members=R)
    finally:
        obs.stop()
        h.stop()


def test_clean_restart_never_fences(tmp_path):
    h = make_harness(tmp_path, seed=4243)
    try:
        h.wait_leaders()
        for g in range(G):
            assert h.put(g, b"c-%d" % g, b"w-%d" % g)
        h.crash(2)
        m = h.restart(2)
        hl = m.health()
        assert hl["wal_tail"] == "clean"
        assert hl["fenced_groups"] == [], hl
        h.wait_leaders()
        run_invariant_checks(h, None, expect_members=R)
    finally:
        h.stop()


# -- disk faults --------------------------------------------------------------------


def _lead_by_transfer(h, mid, timeout=30.0):
    """A group `mid` leads: if it leads none, the leader of some group
    hands that group to it (MsgTimeoutNow), and the call waits until
    `mid` holds it."""
    m = h.members[mid]
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for g in range(G):
            if m.is_leader(g):
                return g
        for g in range(G):
            lead = next((x for x in h.alive() if x.is_leader(g)), None)
            if lead is not None and lead.id != mid:
                lead.transfer_leader(g, mid)
                break
        time.sleep(0.2)
    raise TimeoutError(f"member {mid} never led a group")


def test_fsync_error_failstop_inline(tmp_path):
    """Sticky fsync error on a LEADER: the write riding the failed window
    never applies, the member fail-stops with nothing released (the
    durability envelope holds), the survivors serve, and the healed
    restart closes strict."""
    h = make_harness(tmp_path)
    obs = LeaderObserver(h.alive)
    try:
        h.wait_leaders()
        obs.start()
        assert h.run_workload(6, prefix=b"pre") >= 5
        victim = 2
        g = _lead_by_transfer(h, victim)
        m = h.members[victim]
        h.disk.arm_fsync_error(victim, sticky=True)
        m.propose(g, b"P" + b"doomed\x00never")
        cause = h.wait_fail_stop(victim, timeout=30.0)
        assert cause.startswith("fsync:"), cause
        assert m.get(g, b"doomed") is None, (
            "apply released from the failed fsync window")
        hl = m.health()
        assert hl["fail_stop"] and hl["crashed"]
        h.failstop_envelope(victim)
        assert h.disk.stats().get("fsync_error", 0) >= 1
        assert h.run_workload(4, prefix=b"mid") >= 3
        h.disk.quiesce()
        h.restart(victim)
        h.wait_leaders()
        h.touch_all_groups()
        run_invariant_checks(h, obs, expect_members=R)
    finally:
        obs.stop()
        h.stop()


def test_bit_rot_mid_log_salvage_and_fence(tmp_path):
    """A flipped bit in a mid-log fsync'd record: restart salvages,
    boots fenced, heals by catch-up and closes strict."""
    h = make_harness(tmp_path)
    obs = LeaderObserver(h.alive)
    try:
        h.wait_leaders()
        obs.start()
        assert h.run_workload(8, prefix=b"pre") >= 6
        victim = 3
        h.crash(victim)
        off, _byte = h.bit_rot(victim)
        assert off >= 0, "WAL too short to hold a mid-log record"
        h.run_workload(4, prefix=b"mid")
        m = h.restart(victim)
        hl = m.health()
        assert hl["salvage"] is not None, "salvage never ran"
        assert hl["salvage"]["bytes_dropped"] > 0
        assert hl["wal_tail"] == "corrupt"
        h.wait_leaders()
        h.touch_all_groups()
        run_invariant_checks(h, obs, expect_members=R)
        assert not m.health()["fenced_groups"], "fences never lifted"
    finally:
        obs.stop()
        h.stop()


# -- the snapshotter seam: the port's DiskFaultPlan on storage/snap.py -------------


def _snap(idx=5, term=2):
    from etcd_tpu_torch.raft.types import ConfState, Snapshot, SnapshotMetadata

    return Snapshot(data=b"payload", metadata=SnapshotMetadata(
        conf_state=ConfState(voters=[1, 2, 3]), index=idx, term=term))


def test_snapshotter_enospc_aborts_save_loss_free(tmp_path):
    from etcd_tpu_torch.native.walog import DiskFullError
    from etcd_tpu_torch.storage.snap import Snapshotter

    plan = DiskFaultPlan(seed=SEED)
    s = Snapshotter(str(tmp_path), fault_hook=plan.hook_for(1))
    s.save_snap(_snap(idx=5))
    plan.arm_enospc(1)
    with pytest.raises(DiskFullError):
        s.save_snap(_snap(idx=9))
    assert not [f for f in tmp_path.iterdir() if f.name.endswith(".tmp")]
    assert s.load().metadata.index == 5
    plan.heal_enospc(1)
    s.save_snap(_snap(idx=9))
    assert s.load().metadata.index == 9
    assert plan.stats().get("enospc", 0) == 1


def test_snapshotter_fsync_error_fires_on_snap_fsync(tmp_path):
    from etcd_tpu_torch.native.walog import InjectedIOError
    from etcd_tpu_torch.storage.snap import Snapshotter

    plan = DiskFaultPlan(seed=SEED)
    s = Snapshotter(str(tmp_path), fault_hook=plan.hook_for(1))
    plan.arm_fsync_error(1)  # one-shot
    with pytest.raises(InjectedIOError):
        s.save_snap(_snap())
    s.save_snap(_snap())
    assert s.load().metadata.index == 5


def test_snapshotter_limp_delays_snapshot_ops(tmp_path):
    from etcd_tpu_torch.storage.snap import Snapshotter

    plan = DiskFaultPlan(seed=SEED)
    s = Snapshotter(str(tmp_path), fault_hook=plan.hook_for(1))
    plan.set_limp(1, 0.05, ops=("snap_fsync",))
    t0 = time.perf_counter()
    s.save_snap(_snap())
    assert time.perf_counter() - t0 >= 0.05
    assert plan.stats().get("delay", 0) == 1
