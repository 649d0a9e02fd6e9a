"""The cells of tests/batched/test_hosting.py on the port: G groups
served by three port members (CPU rawnodes) with hosting's default
config (W=64, E=8, P=4, pre-vote, check-quorum), the shared native WAL
and per-group KV apply, over the in-process router and real TCP
sockets; pipelined and synchronous Ready drains.

The admin 'stats' cell drives hosting_proc's AdminServer, which comes
with the out-of-process half of the hosting stack (ROADMAP A12).
Members keep hosting's default 0.02 s tick (MultiRaftCluster takes no
tick interval): ticks queue and each round consumes one.

The last two tests rehearse chip_smoke.py's hosting phase on the CPU:
its configs are the repo's, and the phase runs end to end at 24 groups.
"""

import time

import numpy as np
import pytest

from etcd_tpu_torch.batched.hosting import MultiRaftCluster, MultiRaftMember
from etcd_tpu_torch.batched.state import BatchedConfig


def wait_until(pred, timeout=20.0, interval=0.02, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {msg}")


G = 16


@pytest.fixture(params=[True, False], ids=["pipelined", "sync"])
def cluster(tmp_path, request):
    # Both Ready paths stay covered: the pipelined drain worker
    # (production default) and the synchronous persist/apply/send.
    c = MultiRaftCluster(str(tmp_path), num_members=3, num_groups=G,
                         pipeline=request.param, device="cpu")
    yield c
    c.stop()


class TestMultiRaftHosting:
    def test_every_group_elects_and_replicates(self, cluster):
        leads = cluster.wait_leaders()
        assert (leads > 0).all()
        for g in range(0, G, 3):
            cluster.put(g, b"k", b"v%d" % g)
        # Replicated to every member's applied state.
        for g in range(0, G, 3):
            for m in cluster.members.values():
                wait_until(
                    lambda m=m, g=g: m.get(g, b"k") == b"v%d" % g,
                    msg=f"group {g} on member {m.id}",
                )

    def test_quorum_survives_member_loss(self, cluster):
        cluster.wait_leaders()
        cluster.put(0, b"a", b"1")
        victim = 3
        cluster.router.isolate(victim)
        # Groups led by the victim re-elect among survivors.
        t0 = time.monotonic()
        cluster.put(0, b"b", b"2", timeout=30.0)
        cluster.put(5, b"c", b"3", timeout=30.0)
        survivors = [m for mid, m in cluster.members.items() if mid != victim]
        for m in survivors:
            wait_until(lambda m=m: m.get(5, b"c") == b"3",
                       msg=f"member {m.id} catches up")
        # Healed member converges.
        cluster.router.heal(victim)
        vm = cluster.members[victim]
        wait_until(lambda: vm.get(5, b"c") == b"3", timeout=30.0,
                   msg="healed member catch-up")

    def test_wal_restart_recovers_state(self, tmp_path):
        c = MultiRaftCluster(str(tmp_path), num_members=3, num_groups=G,
                             device="cpu")
        try:
            c.wait_leaders()
            for g in range(G):
                c.put(g, b"key", b"val%d" % g)
            for m in c.members.values():
                wait_until(
                    lambda m=m: all(
                        m.get(g, b"key") == b"val%d" % g for g in range(G)
                    ),
                    msg=f"full replication on member {m.id}",
                )
        finally:
            c.stop()
        # Cold restart from the WALs only.
        c2 = MultiRaftCluster(str(tmp_path), num_members=3, num_groups=G,
                             device="cpu")
        try:
            for m in c2.members.values():
                wait_until(
                    lambda m=m: all(
                        m.get(g, b"key") == b"val%d" % g for g in range(G)
                    ),
                    timeout=30.0,
                    msg=f"member {m.id} state after WAL replay",
                )
        finally:
            c2.stop()

    def test_snapshot_catchup_for_lagging_member(self, tmp_path):
        # Small window forces the ring floor past a lagging member's
        # log: catch-up must go through the snapshot path (device
        # T_SNAP + host app-state transfer).
        cfg = BatchedConfig(
            num_groups=4, num_replicas=3, window=16, max_ents_per_msg=4,
            max_props_per_round=4, election_timeout=10, heartbeat_timeout=1,
            pre_vote=True, check_quorum=True, auto_compact=True,
        )
        c = MultiRaftCluster(str(tmp_path), num_members=3, num_groups=4,
                             cfg=cfg, device="cpu")
        try:
            c.wait_leaders()
            victim = 3
            c.router.isolate(victim)
            # Push far more entries than the window holds.
            for i in range(40):
                c.put(0, b"k%d" % i, b"v%d" % i, timeout=30.0)
            c.router.heal(victim)
            vm = c.members[victim]
            wait_until(
                lambda: all(
                    vm.get(0, b"k%d" % i) == b"v%d" % i for i in range(40)
                ),
                timeout=30.0,
                msg="lagging member catches up via snapshot",
            )
        finally:
            c.stop()


class TestTCPFabric:
    def test_cluster_over_real_sockets(self, tmp_path):
        """The same members and deliver() path, but messages ride real
        TCP streams through the rafthttp-shaped codec (group-prefixed
        frames) instead of the in-proc router."""
        from etcd_tpu_torch.batched.hosting import TCPRouter

        g = 4
        members = {
            mid: MultiRaftMember(mid, 3, g, str(tmp_path), device="cpu")
            for mid in (1, 2, 3)
        }
        routers = {mid: TCPRouter(m) for mid, m in members.items()}
        try:
            for mid, r in routers.items():
                for other, r2 in routers.items():
                    if other != mid:
                        r.add_peer(other, r2.addr)
            for m in members.values():
                m.start()

            # Elections converge over the wire.
            deadline = time.monotonic() + 60
            leads = np.zeros(g, np.int64)
            while time.monotonic() < deadline:
                leads[:] = 0
                for m in members.values():
                    mask = m.rn.m_role == 2  # LEADER
                    leads[mask] = m.id
                if (leads > 0).all():
                    break
                time.sleep(0.05)
            assert (leads > 0).all(), "groups without leader over TCP"

            # Propose on each group's leader; all members converge.
            for grp in range(g):
                lead = members[int(leads[grp])]
                assert lead.propose(grp, lead.kvs[grp].put_payload(
                    b"tk", b"tv%d" % grp))
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                if all(
                    m.get(grp, b"tk") == b"tv%d" % grp
                    for m in members.values() for grp in range(g)
                ):
                    break
                time.sleep(0.05)
            for m in members.values():
                for grp in range(g):
                    assert m.get(grp, b"tk") == b"tv%d" % grp, (
                        m.id, grp)

            # Linearizable read off the device ReadIndex path, over TCP.
            lead = members[int(leads[0])]
            assert lead.linearizable_get(0, b"tk") == b"tv0"
        finally:
            for m in members.values():
                m.stop()
            for r in routers.values():
                r.stop()


class TestTCPResilience:
    def test_sender_backoff_and_fast_stop(self, tmp_path):
        """A down peer is redialed with bounded
        exponential backoff (counted, not silently dropped), and stop()
        returns promptly even while a sender lane is inside a backoff
        sleep — shutdown must never serve out a redial."""
        import socket

        from etcd_tpu_torch.batched.hosting import TCPRouter

        # A port with nothing listening: reserve one, then close it.
        probe = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        probe.bind(("127.0.0.1", 0))
        dead_addr = probe.getsockname()
        probe.close()

        m = MultiRaftMember(1, 3, 4, str(tmp_path), device="cpu")
        r = TCPRouter(m)
        r.add_peer(2, dead_addr)
        r.add_peer(3, dead_addr)
        try:
            m.start()
            # Election traffic dials the dead peers; the backoff loop
            # must keep probing (dial_fail counts up) without wedging.
            wait_until(
                lambda: r.stats().get("dial_fail", 0) >= 3,
                timeout=30.0, msg="sender redials counted",
            )
        finally:
            t0 = time.monotonic()
            m.stop()
            r.stop()
            # Stop never waits out a backoff sleep (cap 1s) nor the
            # full redial budget; generous bound for slow CI.
            assert time.monotonic() - t0 < 10.0


class TestLinearizableReads:
    def test_linearizable_get_after_write(self, cluster):
        """A linearizable read through the device ReadIndex batch sees
        the latest committed write (v3_server.go linearizable path on
        the batched backend)."""
        leads = cluster.wait_leaders()
        g = 0
        cluster.put(g, b"lin", b"v1")
        leader = cluster.members[int(leads[g])]
        got = leader.linearizable_get(g, b"lin", timeout=10.0)
        assert got == b"v1"

    def test_linearizable_get_on_follower_raises(self, cluster):
        from etcd_tpu_torch.batched.hosting import NotLeaderError

        cluster.wait_leaders()
        g = 1
        # Startup churn can leave a deposed member still claiming the
        # role briefly; wait for exactly one claimant.
        wait_until(lambda: sum(
            m.rn.is_leader(g) for m in cluster.members.values()) == 1,
            msg="single leader claimant")
        follower = next(m for m in cluster.members.values()
                        if not m.rn.is_leader(g))
        with pytest.raises(NotLeaderError):
            follower.linearizable_get(g, b"x")

    def test_linearizable_reads_many_groups(self, cluster):
        """One read batch per group, all confirmed on device."""
        leads = cluster.wait_leaders()
        for g in range(0, G, 2):
            cluster.put(g, b"m", b"g%d" % g)
        for g in range(0, G, 2):
            leader = cluster.members[int(leads[g])]
            assert leader.linearizable_get(g, b"m", timeout=10.0) \
                == b"g%d" % g


class TestDrainFaultIsolation:
    def test_drain_fault_stops_member_without_wedging(self, tmp_path):
        """A storage fault escaping _process_readys
        on the drain worker must STOP the member (fatal, logged), not
        silently kill the thread and leave run_round blocked forever on
        a full _ready_q — the wedged-member-that-answers-pings shape."""
        c = MultiRaftCluster(str(tmp_path), num_members=3, num_groups=8,
                             pipeline=True, device="cpu")
        try:
            c.wait_leaders()
            victim = c.members[2]

            def boom(batch):
                raise OSError("injected: disk full")

            victim._process_readys = boom
            # Ticks keep rounds (and Readys) flowing; the next drained
            # batch hits the fault.
            wait_until(lambda: victim._stopped.is_set(), timeout=30.0,
                       msg="faulted member self-stop")
            assert victim.stats.get("drain_dead", 0) == 1
            # Round + drain threads exit — no deadlock on the queue.
            victim._runner.join(timeout=10)
            assert not victim._runner.is_alive()
            victim._drainer.join(timeout=10)
            assert not victim._drainer.is_alive()
            # The fault is contained: the other members keep running.
            assert not c.members[1]._stopped.is_set()
            assert not c.members[3]._stopped.is_set()
        finally:
            c.stop()


# -- chip_smoke's hosting phases, rehearsed on the CPU ----------------------------


def test_chip_smoke_configs_are_the_repos():
    """chip_smoke's hosting config is MultiRaftMember's default and its
    chaos config is tests/batched/test_chaos.py's CFG, field for field."""
    import tempfile

    import chip_smoke
    from etcd_tpu.batched.state import BatchedConfig as JConfig

    with tempfile.TemporaryDirectory() as d:
        m = MultiRaftMember(1, 3, 16, d, pipeline=False, device="cpu")
        try:
            assert m.cfg == chip_smoke.hosting_config(16)
        finally:
            m.stop()
    want = JConfig(
        num_groups=8, num_replicas=3, window=16, max_ents_per_msg=4,
        max_props_per_round=4, election_timeout=10, heartbeat_timeout=1,
        pre_vote=True, check_quorum=True, auto_compact=True,
        fleet_summary=True)
    assert chip_smoke.chaos_config()._asdict() == want._asdict()


def test_chip_smoke_hosting_phase_on_the_cpu(monkeypatch):
    """chip_smoke's hosting phase at 24 groups and 120 puts with CPU
    members (the card's checks, with the CPU wrappers counting their
    plain calls as launches): every put read back on every member,
    linearizable reads, a crash and a restart that catches up, the
    strict checkers, and both kernels launched on the path."""
    import torch

    import chip_smoke
    from etcd_tpu_torch.batched import hopper_kernels as hk

    monkeypatch.setattr(chip_smoke, "smi", lambda _q: "cpu")
    for fn, name in (("quorum_commit_vote", "quorum_commit_vote"),
                     ("quorum_commit", "quorum_commit_vote"),
                     ("quorum_vote", "quorum_commit_vote"),
                     ("term_at_batch", "term_at_batch")):
        def counted(*a, _f=getattr(hk, fn), _n=name, **kw):
            hk.LAUNCHES[_n] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(hk, fn, counted)
    out = chip_smoke.run_hosting(torch.device("cpu"), groups=24, puts=120,
                                 tick_interval=0.06, reads=8)
    assert out["rounds"] > 0
    assert all(v > 0 for v in out["launches"].values()), out["launches"]
