"""The port booted as etcd boots: ``python -m etcd_tpu_torch`` members.

tests/e2e/test_e2e.py's four flows run against three port member
processes on the ``"tpu"`` backend (``--device cpu`` here: the batched
round and its plain kernel forms), driven by the reference's etcdctl and
by the port's client and etcdutl:

- put/get/del with a get at every member, followers included: each
  follower asks the leader for the read index over Raft (ROADMAP C16);
- a txn and endpoint status;
- kill -9 of the leader, reads from the survivors, its restart;
- a snapshot saved through the port's client, restored by the port's
  etcdutl, and a solo port member booted from it.

The members keep etcd's member ids (``member_id_from_urls``) in
``member list``, in the data dir's ``member-<id>`` and in the WAL's
HardState vote, and step on the device through the id <-> slot map. An
orderly stop writes each member's ``kernel launches:`` line. Without
CUDA and without ``--device``, a member exits non-zero and leaves no
data dir. One cluster serves the module, as test_e2e.py's fixture does;
the same flows on ``--raft-backend host`` are slow-marked.
"""

import json
import os
import signal
import subprocess
import sys

import pytest

from etcd_tpu_torch.embed.config import member_id_from_urls
from etcd_tpu_torch.tools.member_procs import (
    MemberCluster, MemberProc, free_ports, member_env)

from .framework.e2e import etcdctl


def port_etcdutl(*args, timeout=120.0):
    r = subprocess.run([sys.executable, "-m", "etcd_tpu_torch.etcdutl",
                        *args], env=member_env("cpu"), capture_output=True,
                       text=True, timeout=timeout)
    return r.returncode, r.stdout, r.stderr


@pytest.fixture(scope="module", params=[
    "tpu", pytest.param("host", marks=pytest.mark.slow)])
def cluster(request, tmp_path_factory):
    root = str(tmp_path_factory.mktemp(f"boot-{request.param}"))
    c = MemberCluster(root, device="cpu",
                      flags=["--raft-backend", request.param])
    c.start()
    c.backend = request.param
    yield c
    c.close()


def test_put_get_del_at_every_member(cluster):
    eps = cluster.endpoints()
    rc, _out, err = etcdctl(eps, "put", "e2ek", "e2ev")
    assert rc == 0, err
    lead = cluster.leader()
    for p in cluster.procs:
        # A linearizable get at each member: at a follower the read
        # index comes from the leader.
        rc, out, err = etcdctl(p.endpoint, "get", "e2ek")
        assert rc == 0 and out == "e2ek\ne2ev\n", (p.name, lead.name, err)
    # The port's client, at each follower, reads the leader's newest
    # write.
    for p in cluster.procs:
        if p is lead:
            continue
        cl = lead.client()
        try:
            cl.put(b"c16", p.name.encode())
        finally:
            cl.close()
        cl = p.client()
        try:
            rr = cl.get(b"c16")
        finally:
            cl.close()
        assert [kv.value for kv in rr.kvs] == [p.name.encode()]
    rc, out, _ = etcdctl(eps, "del", "e2ek")
    assert rc == 0 and out.strip() == "1"


def test_txn_and_endpoint_status(cluster):
    eps = cluster.endpoints()
    etcdctl(eps, "put", "t", "old")
    rc, out, _ = etcdctl(
        eps, "txn", stdin='value("t") = "old"\n\nput t new\n\n\n')
    assert rc == 0 and "SUCCEEDED" in out
    rc, out, _ = etcdctl(eps, "get", "t")
    assert rc == 0 and out == "t\nnew\n"
    rc, out, _ = etcdctl(eps, "-w", "json", "endpoint", "status")
    assert rc == 0
    status = [st["Status"] for line in out.splitlines()
              for st in json.loads(line)]
    assert len(status) == 3
    assert sum(st["is_leader"] for st in status) == 1, status
    assert {st["leader"] for st in status} <= {
        p.member_id for p in cluster.procs}


def test_member_ids_are_etcds(cluster):
    """member list, the data dir and the WAL hold etcd's member ids."""
    rc, out, err = etcdctl(cluster.endpoints(), "member", "list")
    assert rc == 0, err
    ids = {int(line.split(",")[0], 16): line.split(",")[2].strip()
           for line in out.splitlines()}
    want = {member_id_from_urls(p.peer_url, "etcd-cluster"): p.name
            for p in cluster.procs}
    assert ids == want
    assert all(mid > 3 for mid in ids)  # not dense ids 1..R
    for p in cluster.procs:
        assert os.listdir(p.data_dir) == [f"member-{p.member_id}"]


def test_kill9_leader_then_restart(cluster):
    eps = cluster.endpoints()
    rc, _out, err = etcdctl(eps, "put", "persist", "me")
    assert rc == 0, err
    leader = cluster.leader()
    leader.kill9()
    survivors = cluster.endpoints(
        [p for p in cluster.procs if p is not leader])
    rc, out, err = etcdctl(survivors, "get", "persist", timeout=90)
    assert rc == 0 and out == "persist\nme\n", err
    # The killed leader's WAL holds a real member id as its vote.
    from etcd_tpu_torch.native import walog
    from etcd_tpu_torch.storage import wal as walmod

    wal_dir = os.path.join(leader.data_dir, f"member-{leader.member_id}",
                           "wal")
    votes = {walmod._STATE.unpack(payload)[1]
             for rtype, payload, _s, _m in walog.read_all(wal_dir)
             if rtype == walmod.REC_STATE}
    assert votes - {0} <= {p.member_id for p in cluster.procs}
    assert votes - {0}
    leader.start()
    leader.wait_ready()
    rc, out, err = etcdctl(leader.endpoint, "get", "persist", timeout=90)
    assert rc == 0 and out == "persist\nme\n", err
    rc, _out, err = etcdctl(leader.endpoint, "put", "after", "restart")
    assert rc == 0, err
    for p in cluster.procs:
        rc, out, _ = etcdctl(p.endpoint, "get", "after", timeout=90)
        assert rc == 0 and out == "after\nrestart\n", p.name


def test_snapshot_restore_through_the_ports_etcdutl(cluster, tmp_path):
    eps = cluster.endpoints()
    rc, _out, err = etcdctl(eps, "put", "snapkey", "snapval")
    assert rc == 0, err
    lead = cluster.leader()
    cl = lead.client()
    try:
        blob = cl.snapshot()
    finally:
        cl.close()
    snap = str(tmp_path / "boot.snap.db")
    with open(snap, "wb") as f:
        f.write(blob)
    rc, out, err = port_etcdutl("-w", "json", "snapshot", "status", snap)
    assert rc == 0, err
    pp, cp, mp = free_ports(3)
    newdir = str(tmp_path / "restored")
    rc, _out, err = port_etcdutl(
        "snapshot", "restore", snap, "--data-dir", newdir, "--name", "solo",
        "--initial-cluster", f"solo=http://127.0.0.1:{pp}")
    assert rc == 0, err
    solo = MemberProc("solo", newdir, pp, cp, mp,
                      f"solo=http://127.0.0.1:{pp}", device="cpu",
                      flags=["--raft-backend", cluster.backend],
                      log_dir=str(tmp_path))
    solo.start()
    try:
        solo.wait_ready()
        rc, out, err = etcdctl(solo.endpoint, "get", "snapkey", timeout=90)
        assert rc == 0 and out == "snapkey\nsnapval\n", err
    finally:
        solo.stop()
    lines = solo.launch_lines()
    assert len(lines) == 1 and lines[0]["member"] == f"{solo.member_id:x}"


def test_orderly_stop_writes_the_launch_line(tmp_path):
    """A solo member's orderly stop: its node rounds since boot, and on
    the CPU no launch (the plain forms run)."""
    pp, cp, mp = free_ports(3)
    p = MemberProc("one", str(tmp_path / "one"), pp, cp, mp,
                   f"one=http://127.0.0.1:{pp}", device="cpu",
                   log_dir=str(tmp_path))
    p.start()
    try:
        p.wait_ready()
        rc, _out, err = etcdctl(p.endpoint, "put", "k", "v")
        assert rc == 0, err
    finally:
        assert p.stop(signal.SIGTERM) == 0
    (line,) = p.launch_lines()
    assert line["rounds"] > 0
    assert line["launches"] == {"quorum_commit_vote": 0, "term_at_batch": 0}
    assert line["forms"] == {}


def test_no_cuda_no_device_leaves_no_data_dir(tmp_path):
    """Without CUDA (this host) and without --device, the member exits
    non-zero before it touches --data-dir."""
    pp, cp = free_ports(2)
    data = tmp_path / "never"
    r = subprocess.run(
        [sys.executable, "-m", "etcd_tpu_torch", "--name", "x",
         "--data-dir", str(data),
         "--listen-peer-urls", f"http://127.0.0.1:{pp}",
         "--listen-client-urls", f"http://127.0.0.1:{cp}",
         "--initial-cluster", f"x=http://127.0.0.1:{pp}"],
        env=member_env(None), capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr
    assert not data.exists()


def test_proxies_are_refused_until_ported():
    for cmd in (["gateway", "start"], ["grpc-proxy", "start"]):
        r = subprocess.run([sys.executable, "-m", "etcd_tpu_torch", *cmd],
                           env=member_env(None), capture_output=True,
                           text=True, timeout=120)
        assert r.returncode == 2 and "ROADMAP A19b" in r.stderr, r.stderr
