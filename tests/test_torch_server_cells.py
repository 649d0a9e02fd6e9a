"""The port's EtcdServer on its batched backend, on the CPU: the cells of
tests/server/test_tpu_backend.py and test_etcdserver.py, run on port
servers (``raft_backend="tpu"``, ``device="cpu"``): linearizable reads
with hash_check and linearizable_check, a restart from the WAL, a
snapshot with a MsgSnap catch-up (snapshot_count 16), a restarted
member serving a snapshot from its snap dir, a member added and
removed, and the lease expiry checker. A tick of 0.05 s (the server's
default) keeps the CPU's node rounds inside the election timeout.
"""

import time

import pytest

from etcd_tpu_torch.functional import (
    Cluster,
    hash_check,
    lease_expire_check,
    linearizable_check,
)
from etcd_tpu_torch.raftexample.transport import InProcNetwork
from etcd_tpu_torch.server import EtcdServer, ServerConfig
from etcd_tpu_torch.pkg.errors import NotLeaderError
from etcd_tpu_torch.server.api import (
    PutRequest,
    RangeRequest,
    RequestOp,
    TxnRequest,
)
from etcd_tpu_torch.server.membership import Member

KW = dict(raft_backend="tpu", device="cpu", tick_interval=0.05,
          request_timeout=25.0)
SNAP_KW = dict(KW, snapshot_count=16, snapshot_catchup_entries=4)


def wait_until(pred, timeout=60.0, interval=0.02, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {msg}")


def put_any(servers, req, timeout=60.0):
    """A put to the current leader, retried across leadership moves (a
    request in flight on a deposed leader times out, as in the
    reference; clients carry the retry)."""
    deadline = time.monotonic() + timeout
    last = None
    while time.monotonic() < deadline:
        lead = next((s for s in servers if s.is_leader()), None)
        if lead is None:
            time.sleep(0.05)
            continue
        try:
            return lead.put(req)
        except Exception as e:  # noqa: BLE001 — timeout or stopped: retry
            last = e
    raise AssertionError(f"put never committed: {last!r}")


def serves(s, key, value=None):
    rr = s.range(RangeRequest(key=key, serializable=True))
    return bool(rr.kvs) and (value is None or rr.kvs[0].value == value)


def test_put_get_linearizable(tmp_path):
    c = Cluster(str(tmp_path), n=3, **KW)
    try:
        lead = c.wait_leader(60)
        lead.put(PutRequest(key=b"k", value=b"v"))
        linearizable_check(lead, b"k", b"v")
        for s in c.alive():
            wait_until(lambda s=s: serves(s, b"k", b"v"),
                       msg=f"member {s.id} applies")
        hash_check(c.alive())
        assert all(s.node.rn.device.type == "cpu" for s in c.alive())
    finally:
        c.close()


def test_member_restart_replays_wal(tmp_path):
    c = Cluster(str(tmp_path), n=3, **KW)
    try:
        c.wait_leader(60)
        for i in range(5):
            put_any(c.alive(), PutRequest(key=b"k%d" % i, value=b"v%d" % i))
        victim = c.followers()[0].id
        c.kill(victim)
        put_any(c.alive(), PutRequest(key=b"after", value=b"kill"))
        s = c.restart(victim)
        wait_until(lambda: serves(s, b"after"),
                   msg="restarted member catches up")
        for i in range(5):
            assert serves(s, b"k%d" % i, b"v%d" % i)
        hash_check(c.alive())
    finally:
        c.close()


def _lag_behind_the_floor(c, prefix, n=40):
    """Kills a follower, puts n keys, and waits until the leader's ring
    floor passes what the follower applied: it can only catch up by
    MsgSnap. Returns the follower's id."""
    victim = c.followers()[0]
    vid, applied = victim.id, victim.applied_index()
    c.kill(vid)
    for i in range(n):
        put_any(c.alive(), PutRequest(key=prefix + b"%d" % i,
                                      value=b"w%d" % i))

    def floor():
        lead = c.leader()
        return int(lead.node.rn.m_snap[0]) if lead is not None else 0

    wait_until(lambda: floor() > applied, msg="the ring floor advances")
    return vid


def test_snapshot_trigger_and_catchup(tmp_path):
    c = Cluster(str(tmp_path), n=3, **SNAP_KW)
    try:
        c.wait_leader(60)
        vid = _lag_behind_the_floor(c, b"s")
        s = c.restart(vid)
        wait_until(lambda: all(serves(s, b"s%d" % i) for i in range(40)),
                   msg="snapshot catch-up on the batched backend")
        assert s.snapshotter.load().metadata.index > 0
        hash_check(c.alive())
    finally:
        c.close()


def test_restarted_member_serves_snapshot(tmp_path):
    """After the survivors restart, whoever leads serves the lagging
    member from the app snapshot its boot seeded from the snap dir."""
    c = Cluster(str(tmp_path), n=3, **SNAP_KW)
    try:
        c.wait_leader(60)
        vid = _lag_behind_the_floor(c, b"r")
        for s in list(c.alive()):
            sid = s.id
            c.kill(sid)
            c.restart(sid)
        c.wait_leader(60)
        s = c.restart(vid)
        wait_until(lambda: all(serves(s, b"r%d" % i) for i in range(40)),
                   msg="catch-up served by a restarted member")
        hash_check(c.alive())
    finally:
        c.close()


def test_add_and_remove_member(tmp_path):
    """Members provisioned with a spare replica slot admit a joiner,
    which boots voterless and gets its vote with the admitting
    ConfChange; then it is removed and stops itself."""
    net = InProcNetwork()
    servers = {nid: EtcdServer(ServerConfig(
        member_id=nid, peers=[1, 2, 3], data_dir=str(tmp_path), network=net,
        replica_capacity=4, **KW)) for nid in (1, 2, 3)}
    try:
        wait_until(lambda: any(s.is_leader() for s in servers.values()),
                   msg="leader election")
        put_any(servers.values(), PutRequest(key=b"before", value=b"add"))
        lead = next(s for s in servers.values() if s.is_leader())
        lead.add_member(Member(id=4, name="m4"))
        wait_until(lambda: all(4 in s.cluster.member_ids()
                               for s in servers.values()),
                   msg="member add replicated")
        s4 = servers[4] = EtcdServer(ServerConfig(
            member_id=4, peers=[1, 2, 3, 4], data_dir=str(tmp_path),
            network=net, join=True, **KW))
        put_any(servers.values(), PutRequest(key=b"mm", value=b"vv"))
        wait_until(lambda: serves(s4, b"mm", b"vv"),
                   msg="new member catch-up")
        assert serves(s4, b"before", b"add")
        wait_until(lambda: 4 in s4.node._current_conf_state().voters,
                   msg="joiner granted its vote")
        lead = next(s for s in servers.values() if s.is_leader())
        lead.remove_member(4)
        wait_until(lambda: all(4 not in s.cluster.member_ids()
                               for s in servers.values() if s is not s4),
                   msg="member removed")
        wait_until(lambda: s4._stopped.is_set(),
                   msg="removed member stops itself")
    finally:
        for s in servers.values():
            s.stop()
        net.stop()


@pytest.mark.parametrize("backend", ["tpu", "host"])
def test_lease_expire_check(tmp_path, backend):
    """A lease left to expire takes its keys with it on every member; a
    lease renewed past its TTL keeps them. Each lease's keys go in one
    txn right after its grant, and the renews follow the leader, so a
    slow host does not expire a lease early."""
    kw = KW if backend == "tpu" else dict(raft_backend="host",
                                          tick_interval=0.05)
    c = Cluster(str(tmp_path), n=3, **kw)

    def put_leased(lead, keys, lid):
        lead.txn(TxnRequest(success=[RequestOp(request_put=PutRequest(
            key=k, value=b"v", lease=lid)) for k in keys]))

    try:
        lead = c.wait_leader(60)
        kept = lead.lease_grant(3, lease_id=0x4EE9).id
        put_leased(lead, [b"kept"], kept)
        doomed = lead.lease_grant(3, lease_id=0x1D1E).id
        keys = [b"doomed/%d" % i for i in range(3)]
        put_leased(lead, keys, doomed)
        t0 = time.monotonic()
        while time.monotonic() - t0 < 5.0:  # past both TTLs
            try:
                c.wait_leader(60).lease_renew(kept)
            except NotLeaderError:
                pass  # leadership moved under the renew: the next one
            time.sleep(0.2)
        for s in c.alive():
            lease_expire_check(s, [doomed], keys, timeout=30.0)
        lead = c.wait_leader(60)
        assert kept in lead.lease_leases()
        assert serves(lead, b"kept")
        hash_check(c.alive())
    finally:
        c.close()
