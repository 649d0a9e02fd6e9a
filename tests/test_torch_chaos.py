"""The quick chaos cells of tests/batched/test_chaos.py on the port.

Seeded message faults over the in-process, TCP and shm fabrics, storage
failpoint crashes, a bare-panic failpoint, a torn WAL tail, the
lock-order sentinel and linearizable reads across leader loss — each
episode run by the port's ChaosHarness with CPU members at
test_chaos.CFG's values and closed by the port's invariant checks,
strict, with invariant_trips() == 0 (run_invariant_checks asserts it).

The members tick every TICK seconds: a port member's eager CPU round
takes ~20 ms alone and ~60-80 ms with three members sharing the GIL,
so TICK keeps about one tick per member round (on the card members
run the default 0.02 s).
"""

import importlib
import os
import time

import pytest

from etcd_tpu.analysis.lockorder import LockOrderRecorder
from etcd_tpu_torch.batched import graph
from etcd_tpu_torch.batched.faults import (
    ChaosHarness,
    FaultSpec,
    LeaderObserver,
    run_invariant_checks,
)
from etcd_tpu_torch.batched.state import BatchedConfig
from etcd_tpu_torch.functional import (
    check_sequential_history,
    multiraft_hash_check,
)
from etcd_tpu_torch.pkg import failpoint
from etcd_tpu_torch.pkg.errors import NotLeaderError

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


@pytest.fixture(autouse=True)
def _clean_failpoints():
    yield
    failpoint.disable_all()


def make_harness(tmp_path, seed, spec, transport="inproc"):
    return ChaosHarness(
        str(tmp_path), seed, spec, num_members=R, num_groups=G,
        cfg=CFG, transport=transport, tick_interval=TICK, device="cpu",
    )


def run_checkers(h, obs):
    run_invariant_checks(h, obs, expect_members=R)


MSG_FAULTS = FaultSpec(drop=0.05, dup=0.05, delay=0.08,
                       delay_max_s=0.04, reorder=0.2)


class TestMessageFaults:
    @pytest.mark.parametrize("transport,seed", [
        ("inproc", SEEDS[0]),
        ("inproc", SEEDS[-1]),
        ("tcp", SEEDS[0]),
        ("shm", SEEDS[0]),
    ])
    def test_faulty_links_converge(self, tmp_path, transport, seed):
        h = make_harness(tmp_path, seed, MSG_FAULTS, transport)
        obs = LeaderObserver(h.alive)
        try:
            h.wait_leaders()
            obs.start()
            acked = h.run_workload(20)
            assert acked >= 10, f"only {acked}/20 writes acked"
            h.plan.quiesce()
            run_checkers(h, obs)
            stats = h.fabric.stats()
            assert stats.get("dropped", 0) > 0, stats
            assert stats.get("delayed", 0) > 0, stats
            if transport == "inproc":
                assert isinstance(h.inproc.stats(), dict)
            else:
                for r in h.routers.values():
                    assert isinstance(r.stats(), dict)
        finally:
            obs.stop()
            h.stop()

    def test_asymmetric_partition_heals(self, tmp_path):
        h = make_harness(tmp_path, SEEDS[0], FaultSpec())
        obs = LeaderObserver(h.alive)
        try:
            h.wait_leaders()
            obs.start()
            h.run_workload(6, prefix=b"pre")
            h.plan.partition(1, 2, symmetric=False)
            acked = h.run_workload(8, prefix=b"cut")
            assert acked >= 4
            h.plan.quiesce()
            h.run_workload(3, prefix=b"post")
            run_checkers(h, obs)
            assert h.fabric.stats().get("partitioned", 0) > 0
        finally:
            obs.stop()
            h.stop()


class TestCrashRestart:
    @pytest.mark.parametrize("site", ["before_save", "after_save"])
    def test_failpoint_crash_then_replay(self, tmp_path, site):
        h = make_harness(tmp_path, SEEDS[0], FaultSpec())
        obs = LeaderObserver(h.alive)
        try:
            h.wait_leaders()
            obs.start()
            h.run_workload(6, prefix=b"pre")
            h.crash_on_failpoint(2, site)
            assert h.members[2]._crashed
            acked = h.run_workload(6, prefix=b"mid")
            assert acked >= 3
            h.restart(2)
            h.wait_leaders()
            h.run_workload(3, prefix=b"post")
            run_checkers(h, obs)
        finally:
            obs.stop()
            h.stop()


class TestBarePanicFailpoint:
    def test_default_panic_action_kills_member_cleanly(self, tmp_path):
        h = make_harness(tmp_path, SEEDS[0], FaultSpec())
        try:
            h.wait_leaders()
            victim = h.members[2]
            failpoint.enable(victim._fp_before_save)  # action: panic
            deadline = time.monotonic() + 20.0
            while time.monotonic() < deadline:
                if victim._stopped.is_set():
                    break
                time.sleep(0.01)
            assert victim._stopped.is_set(), "member wedged half-dead"
            assert victim._crashed
            victim._runner.join(timeout=10)
            assert not victim._runner.is_alive()
            h.restart(2)
            h.wait_leaders()
        finally:
            h.stop()


class TestTornTail:
    def test_torn_wal_tail_recovers_prefix(self, tmp_path):
        h = make_harness(tmp_path, SEEDS[0], FaultSpec())
        obs = LeaderObserver(h.alive)
        try:
            h.wait_leaders()
            obs.start()
            h.run_workload(8, prefix=b"pre")
            h.crash(3)
            chop = h.torn_tail(3)
            assert chop > 0, "expected a non-empty WAL tail to tear"
            h.run_workload(4, prefix=b"mid")
            h.restart(3)
            h.wait_leaders()
            h.touch_all_groups()
            run_checkers(h, obs)
        finally:
            obs.stop()
            h.stop()


class TestLockOrder:
    def test_no_lock_order_cycles_across_chaos_threads(self, tmp_path,
                                                       monkeypatch):
        """The lock-order sentinel over the port's thread soup (member
        round threads, drain workers, the delayed-delivery pump, TCP
        sender lanes), the process-wide device lock included: it is
        made at import, before any recorder scope, so the test makes
        it anew inside the scope (graph.py reloaded) and asserts the
        recorder saw it."""
        with open(graph.__file__) as f:
            site = "graph.py:%d" % next(
                i for i, ln in enumerate(f, 1)
                if ln.startswith("_DEVICE_LOCK = "))
        # Restored at teardown: the reloaded module's lock is recorded.
        monkeypatch.setattr(graph, "_DEVICE_LOCK", graph._DEVICE_LOCK)
        rec = LockOrderRecorder(
            "chaos-tcp-port", include=lambda p: "etcd_tpu" in p)
        rec.enable()
        try:
            importlib.reload(graph)
            h = make_harness(tmp_path, SEEDS[0], MSG_FAULTS, "tcp")
            try:
                h.wait_leaders()
                h.run_workload(8)
                h.crash(2)
                h.restart(2)
                h.wait_leaders()
                h.run_workload(4, prefix=b"post")
            finally:
                h.stop()
        finally:
            rec.disable()
        assert rec.sites, "recorder saw no etcd_tpu locks — wiring broken"
        assert rec.edges, "no nested acquisitions recorded"
        assert site in rec.sites, (site, sorted(rec.sites))
        rec.check()


class TestLinearizableFailover:
    def test_reads_never_stale_across_leader_loss(self, tmp_path):
        h = make_harness(tmp_path, SEEDS[0], FaultSpec())
        history = []

        def lread(m, g, key, timeout=2.0):
            try:
                got = m.linearizable_get(g, key, timeout=timeout)
                history.append(("r", key, got, True))
                return got
            except (NotLeaderError, TimeoutError) as e:
                history.append(("r", key, type(e).__name__, False))
                return None

        try:
            leads = h.wait_leaders()
            g = 0
            old = h.members[int(leads[g])]
            assert h.put(g, b"reg", b"v1")
            history.append(("w", b"reg", b"v1"))
            assert lread(old, g, b"reg") == b"v1"

            h.plan.isolate_member(old.id, h.members.keys())
            lread(old, g, b"reg", timeout=1.0)

            assert h.put(g, b"reg", b"v2", timeout=30.0)
            history.append(("w", b"reg", b"v2"))
            deadline = time.monotonic() + 30.0
            new = None
            while time.monotonic() < deadline and new is None:
                for m in h.alive():
                    if m.id != old.id and m.is_leader(g):
                        new = m
                        break
                time.sleep(0.02)
            assert new is not None, "no replacement leader elected"
            assert lread(new, g, b"reg", timeout=10.0) == b"v2"

            h.plan.quiesce()
            deadline = time.monotonic() + 20.0
            while time.monotonic() < deadline:
                if old.get(g, b"reg") == b"v2":
                    break
                time.sleep(0.02)
            lread(old, g, b"reg", timeout=5.0)

            check_sequential_history(history)
            multiraft_hash_check(h.alive(), timeout=45.0)
        finally:
            h.stop()
