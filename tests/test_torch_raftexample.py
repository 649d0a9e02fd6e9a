"""The port's raftexample on the CPU: a three-member replicated KV over
``etcd_tpu_torch`` BatchedNodes (device="cpu"), each member with its own
Ready loop, ticker and network pump threads, its WAL and its snapshots.

* The cluster scenarios of tests/raftexample/test_cluster.py (propose,
  forwarding, failover, restart from the WAL, snapshot trigger and
  restore), run on the port on both backends: the batched one and the
  scalar core's ("host").
* raftnode.py pinned to etcd_tpu's by its syntax tree.
* Cross-read: the WAL and snapshot directories a port member writes are
  replayed by etcd_tpu's ``WAL.read_all`` and ``Snapshotter.load`` to
  equal records and snapshots, and an etcd_tpu member's directories by
  the port's.
* The port's walog library builds from the port's own source.
"""

import dataclasses
import enum
import os

import pytest

from etcd_tpu.raftexample import ExampleRaftNode as JExampleRaftNode
from etcd_tpu.raftexample import InProcNetwork as JInProcNetwork
from etcd_tpu.raftexample import ReplicatedKV as JReplicatedKV
from etcd_tpu.storage import snap as jsnap
from etcd_tpu.storage import wal as jwal
from etcd_tpu_torch import native
from etcd_tpu_torch.raft.types import Entry, HardState
from etcd_tpu_torch.raftexample import (
    ExampleRaftNode,
    InProcNetwork,
    ReplicatedKV,
)
from etcd_tpu_torch.storage import snap as tsnap
from etcd_tpu_torch.storage import wal as twal

from .raftexample.test_cluster import stop_all, wait_leader, wait_until


def make_cluster(tmp_path, snap_count=10000, net=None, backend="tpu"):
    net = net or InProcNetwork()
    nodes, kvs = {}, {}
    for nid in (1, 2, 3):
        nodes[nid], kvs[nid] = member(tmp_path, nid, net, snap_count,
                                      backend)
    return net, nodes, kvs


def member(tmp_path, nid, net, snap_count=10000, backend="tpu"):
    kv = ReplicatedKV()
    node = ExampleRaftNode(
        node_id=nid, peers=[1, 2, 3], network=net, data_dir=str(tmp_path),
        apply_fn=kv.apply, snapshot_fn=kv.snapshot, restore_fn=kv.restore,
        snap_count=snap_count, tick_interval=0.01, backend=backend,
        device="cpu")
    kv.attach(node)
    return node, kv


# -- the cluster scenarios, each run on both backends -------------------------


def propose_replicates_everywhere(tmp_path, backend):
    net, nodes, kvs = make_cluster(tmp_path, backend=backend)
    try:
        lead = wait_leader(nodes)
        kvs[lead].propose("foo", "bar")
        for nid in nodes:
            wait_until(lambda nid=nid: kvs[nid].lookup("foo") == "bar",
                       msg=f"replication to node {nid}")
    finally:
        stop_all(net, nodes)


def follower_proposal_forwarded(tmp_path, backend):
    net, nodes, kvs = make_cluster(tmp_path, backend=backend)
    try:
        lead = wait_leader(nodes)
        follower = next(i for i in nodes if i != lead)
        kvs[follower].propose("k", "v")
        for nid in nodes:
            wait_until(lambda nid=nid: kvs[nid].lookup("k") == "v",
                       msg=f"replication to node {nid}")
    finally:
        stop_all(net, nodes)


def leader_failover(tmp_path, backend):
    net, nodes, kvs = make_cluster(tmp_path, backend=backend)
    try:
        lead = wait_leader(nodes)
        kvs[lead].propose("before", "1")
        survivors = [i for i in nodes if i != lead]
        net.isolate(lead)
        new_lead = wait_leader({i: nodes[i] for i in survivors},
                               timeout=20.0)
        assert new_lead != lead
        kvs[new_lead].propose("after", "2")
        for nid in survivors:
            wait_until(lambda nid=nid: kvs[nid].lookup("after") == "2",
                       msg=f"post-failover replication to {nid}")
        net.heal(lead)
        wait_until(lambda: kvs[lead].lookup("after") == "2", timeout=20.0,
                   msg="healed node catch-up")
    finally:
        stop_all(net, nodes)


def restart_replays_wal(tmp_path, backend):
    net, nodes, kvs = make_cluster(tmp_path, backend=backend)
    try:
        lead = wait_leader(nodes)
        for i in range(20):
            kvs[lead].propose(f"k{i}", f"v{i}")
        victim = next(i for i in nodes if i != lead)
        wait_until(lambda: kvs[victim].lookup("k19") == "v19",
                   msg="replication before restart")
        nodes[victim].stop()
        # Restart from disk: WAL replay must restore all applied state.
        nodes[victim], kvs[victim] = member(tmp_path, victim, net,
                                            backend=backend)
        wait_until(lambda: kvs[victim].lookup("k19") == "v19", timeout=20.0,
                   msg="state after WAL replay")
    finally:
        stop_all(net, nodes)


def snapshot_trigger_and_restore(tmp_path, backend):
    net, nodes, kvs = make_cluster(tmp_path, snap_count=20, backend=backend)
    try:
        lead = wait_leader(nodes)
        for i in range(60):
            kvs[lead].propose(f"k{i}", f"v{i}")
        wait_until(lambda: all(n.snapshot_index > 0 for n in nodes.values()),
                   timeout=20.0, msg="snapshot trigger")
        snapdir = os.path.join(str(tmp_path), f"member-{lead}", "snap")
        assert any(f.endswith(".snap") for f in os.listdir(snapdir))
        victim = next(i for i in nodes if i != lead)
        nodes[victim].stop()
        nodes[victim], kvs[victim] = member(tmp_path, victim, net, 20,
                                            backend)
        wait_until(lambda: kvs[victim].lookup("k59") == "v59", timeout=20.0,
                   msg="restore from snapshot + tail")
    finally:
        stop_all(net, nodes)


SCENARIOS = {
    "propose_replicates_everywhere": propose_replicates_everywhere,
    "follower_proposal_forwarded": follower_proposal_forwarded,
    "leader_failover": leader_failover,
    "restart_replays_wal": restart_replays_wal,
    "snapshot_trigger_and_restore": snapshot_trigger_and_restore,
}


def test_propose_replicates_everywhere(tmp_path):
    propose_replicates_everywhere(tmp_path, "tpu")


def test_follower_proposal_forwarded(tmp_path):
    follower_proposal_forwarded(tmp_path, "tpu")


def test_leader_failover(tmp_path):
    leader_failover(tmp_path, "tpu")


def test_restart_replays_wal(tmp_path):
    restart_replays_wal(tmp_path, "tpu")


def test_snapshot_trigger_and_restore(tmp_path):
    snapshot_trigger_and_restore(tmp_path, "tpu")


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_host_backend_cluster(tmp_path, scenario):
    """The same scenarios on the scalar core's threaded Node, as
    tests/raftexample/test_cluster.py runs them on both backends."""
    SCENARIOS[scenario](tmp_path, "host")


def test_host_backend_touches_no_device(tmp_path, monkeypatch):
    """A host member needs no GPU and takes no device lock: its Node
    thread runs the scalar core only."""
    import torch

    from etcd_tpu_torch.batched import graph

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    taken = []
    real = graph.device_work

    def spy():
        taken.append(1)
        return real()

    monkeypatch.setattr(graph, "device_work", spy)
    net, nodes, kvs = make_cluster(tmp_path, backend="host")
    try:
        lead = wait_leader(nodes)
        kvs[lead].propose("k", "v")
        for nid in nodes:
            wait_until(lambda nid=nid: kvs[nid].lookup("k") == "v",
                       msg=f"replication to node {nid}")
        assert all(type(n.node).__module__ == "etcd_tpu_torch.raft.node"
                   for n in nodes.values())
    finally:
        stop_all(net, nodes)
    assert taken == []


def test_raftnode_is_the_reference_code():
    """raftnode.py equals etcd_tpu's by syntax tree once the listed
    differences are normalized away: the `device` argument, its
    resolve_device guard for the batched backend, and the default
    backend ("tpu" here, "host" there)."""
    import ast

    from .test_torch_hosting import _dump, _Normalize, defs_of

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rel = "raftexample/raftnode.py"
    ref = defs_of(os.path.join(root, "etcd_tpu", rel))
    port = defs_of(os.path.join(root, "etcd_tpu_torch", rel))
    assert set(port) == set(ref)
    norm = _Normalize(args=("device",), stmt=lambda s: (
        isinstance(s, ast.If) and "resolve_device" in ast.unparse(s)),
        names=("resolve_device",))
    for name in sorted(port):
        a, b = ref[name], port[name]
        if name == "<module>":
            b = norm.apply(b)
            b = [x for x in b if not (isinstance(x, ast.ImportFrom)
                                      and not x.names)]
        elif name == "ExampleRaftNode.__init__":
            a = norm.apply(a)
            b = norm.apply(b)
            backend = [d for arg, d in zip(
                b.args.args[-len(b.args.defaults):], b.args.defaults)
                if arg.arg == "backend"]
            assert backend and backend[0].value == "tpu"
            backend[0].value = "host"
        assert _dump(a) == _dump(b), name


def test_member_needs_the_gpu_or_a_named_device(tmp_path, monkeypatch):
    """Without CUDA, a member that names no device raises before it
    touches the disk; it never runs on the CPU unasked."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ExampleRaftNode(1, [1, 2, 3], InProcNetwork(), str(tmp_path),
                        lambda ents: None, lambda: b"", lambda data: None)
    assert os.listdir(tmp_path) == []


# -- the two packages read each other's WAL and snapshot files -----------------


def plain(x):
    if dataclasses.is_dataclass(x):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, enum.Enum):
        return int(x)
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x


def replay(mod_wal, mod_snap, member_dir):
    """A member directory replayed by one package: its newest snapshot,
    then its WAL from that snapshot's marker."""
    try:
        snap = mod_snap.Snapshotter(os.path.join(member_dir, "snap")).load()
    except mod_snap.NoSnapshotError:
        snap = None
    w = mod_wal.WAL.open(os.path.join(member_dir, "wal"))
    try:
        walsnap = mod_wal.WalSnapshot(
            index=snap.metadata.index if snap else 0,
            term=snap.metadata.term if snap else 0)
        meta, hs, ents = w.read_all(walsnap)
    finally:
        w.close()
    return plain(snap), meta, plain(hs), plain(ents)


def run_puts(nodes, kvs, count):
    lead = wait_leader(nodes)
    for i in range(count):
        kvs[lead].propose(f"k{i}", f"v{i}")
    last = f"k{count - 1}"
    for nid in nodes:
        wait_until(lambda nid=nid: kvs[nid].lookup(last) == f"v{count - 1}",
                   timeout=20.0, msg=f"replication to {nid}")
    wait_until(lambda: all(n.snapshot_index > 0 for n in nodes.values()),
               timeout=20.0, msg="snapshot trigger")


def assert_cross_read(tmp_path):
    for nid in (1, 2, 3):
        member_dir = os.path.join(str(tmp_path), f"member-{nid}")
        got = replay(twal, tsnap, member_dir)
        want = replay(jwal, jsnap, member_dir)
        assert got == want, nid
        snap, meta, hs, ents = got
        assert snap["metadata"]["index"] > 0 and hs["commit"] > 0
        assert meta == nid.to_bytes(8, "big")


def test_port_member_files_read_by_etcd_tpu(tmp_path):
    net, nodes, kvs = make_cluster(tmp_path, snap_count=20)
    try:
        run_puts(nodes, kvs, 50)
    finally:
        stop_all(net, nodes)
    assert_cross_read(tmp_path)


def test_etcd_tpu_member_files_read_by_the_port(tmp_path):
    """An etcd_tpu cluster (its scalar host backend, which writes the
    same files and compiles nothing) writes; both packages replay."""
    net = JInProcNetwork()
    nodes, kvs = {}, {}
    for nid in (1, 2, 3):
        kv = JReplicatedKV()
        nodes[nid] = JExampleRaftNode(
            node_id=nid, peers=[1, 2, 3], network=net,
            data_dir=str(tmp_path), apply_fn=kv.apply,
            snapshot_fn=kv.snapshot, restore_fn=kv.restore, snap_count=20,
            tick_interval=0.01, backend="host")
        kv.attach(nodes[nid])
        kvs[nid] = kv
    try:
        run_puts(nodes, kvs, 50)
    finally:
        stop_all(net, nodes)
    assert_cross_read(tmp_path)


def test_walog_builds_from_the_port_source(tmp_path, monkeypatch):
    """The port commits no binary: its walog library is built by g++
    from etcd_tpu_torch/native/src/walog.cc into a build directory keyed
    by the source hash, and a WAL written through it reads back."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    path = native.build("walog")
    assert os.path.dirname(path) == str(tmp_path / "build")
    assert os.path.basename(path) == os.path.basename(
        native.library_path("walog"))
    assert native.build("walog") == path  # built once per source hash
    w = twal.WAL.create(str(tmp_path / "wal"), metadata=b"m")
    w.save(HardState(term=1, vote=1, commit=1),
           [Entry(term=1, index=1, data=b"x")], True)
    w.close()
    with jwal.WAL.open(str(tmp_path / "wal")) as r:
        got = r.read_all()
    assert plain(got) == [b"m", {"term": 1, "vote": 1, "commit": 1},
                          [{"term": 1, "index": 1, "type": 0, "data": b"x"}]]
