"""PyTorch port ↔ JAX reference: the etcd server as a whole.

- A three-member ``functional.Cluster`` of each package gets the same
  seeded, scripted request stream (``tools/server_script``), one request
  at a time to the leader: puts with prev_kv, ranges (linearizable,
  serializable, limits, sorts, past revisions), txns comparing every
  target, deletes, lease grants with explicit IDs and revokes, a
  compaction and a read below it, and a watch. Every response body must
  be equal (the header's ``raft_term`` and ``member_id`` left out; the
  revision compared), and ``hash_kv`` equal at the same revision at the
  end. On the ``"host"`` backend on both sides, and on the ``"tpu"``
  backend with the port on the CPU against ``etcd_tpu``'s JAX node
  (tests/server/test_tpu_backend.py's values: snapshot_count 16, so
  the reference side builds no new node shape).
- Cross-boot on the ``"host"`` backend: each package's data directory
  (WAL, snapshot files, sqlite db) boots the other package's cluster to
  the same KV.
- The entry point: with no device and no CUDA, a port server raises
  before it touches its data directory; ``"host"`` resolves no device.
Exact equality throughout.
"""

import os

import pytest
import torch

from etcd_tpu.functional import Cluster as JCluster
from etcd_tpu.server import api as japi
from etcd_tpu_torch.functional import Cluster as TCluster
from etcd_tpu_torch.server import api as tapi
from etcd_tpu_torch.tools import server_script as ss

SEED = 20261017
# tests/server/test_tpu_backend.py's snapshot cells (W = 128), at the
# server's default tick: a node round on a loaded CPU stays well inside
# the election timeout, so no leadership move times a request out.
TPU_KW = dict(raft_backend="tpu", snapshot_count=16,
              snapshot_catchup_entries=4, request_timeout=25.0,
              tick_interval=0.05)


def _run(cluster_cls, api, path, ops, **kw):
    c = cluster_cls(path, n=3, **kw)
    try:
        c.wait_leader(60)
        bodies = ss.run(c, ss.script(api, SEED, ops), watch=True)
        return bodies, ss.final_hash(c)
    finally:
        c.close()


def _assert_bodies_equal(want, got):
    assert len(want) == len(got)
    for j, (a, b) in enumerate(zip(want, got)):
        assert a == b, (j, a, b)


def _kind(body):
    """A response's type name, an error's class name, or "watch" for the
    watch's list of events."""
    if isinstance(body, tuple):
        return body[0]
    return body[1] if body and body[0] == "error" else "watch"


@pytest.mark.parametrize("backend", ["host", "tpu"])
def test_scripted_stream_equal(tmp_path, backend):
    """Both packages' clusters answer the scripted stream with equal
    bodies and end at the same hash_kv and revision."""
    kw = {"raft_backend": "host"} if backend == "host" else TPU_KW
    ops = 80 if backend == "host" else 50
    want, want_hash = _run(JCluster, japi, str(tmp_path / "jax"), ops, **kw)
    got, got_hash = _run(TCluster, tapi, str(tmp_path / "port"), ops,
                         **kw, **({"device": "cpu"} if backend == "tpu"
                                  else {}))
    _assert_bodies_equal(want, got)
    assert want_hash == got_hash
    kinds = {_kind(b) for b in got}
    for k in ("PutResponse", "RangeResponse", "TxnResponse",
              "DeleteRangeResponse", "LeaseGrantResponse",
              "CompactionResponse", "CompactedError", "watch"):
        assert k in kinds, (k, kinds)
    assert len(got[-1]) > 10  # the watch saw the script's writes


def _fill(c, api, n=40):
    lead = c.wait_leader(60)
    for i in range(n):
        lead = ss.leader_of(c)
        lead.put(api.PutRequest(key=b"x%03d" % i, value=b"v%d" % i))
    lead.delete_range(api.DeleteRangeRequest(key=b"x000"))
    return ss.final_hash(c)


def _kvs(c, api):
    out = []
    for s in sorted(c.alive(), key=lambda s: s.id):
        rr = s.range(api.RangeRequest(key=b"\x00", range_end=b"\xff",
                                      serializable=True))
        out.append([(kv.key, kv.value, kv.mod_revision) for kv in rr.kvs])
    return out


@pytest.mark.parametrize("first", ["jax", "port"])
def test_cross_boot(tmp_path, first):
    """A data directory written by one package's cluster (snapshots at
    snapshot_count 16, so snapshot files and the sqlite db both carry
    state) boots the other package's cluster to the same KV on every
    member and the same hash_kv."""
    kw = dict(raft_backend="host", snapshot_count=16,
              snapshot_catchup_entries=4)
    order = [(JCluster, japi), (TCluster, tapi)]
    if first == "port":
        order.reverse()
    (a_cls, a_api), (b_cls, b_api) = order
    a = a_cls(str(tmp_path), n=3, **kw)
    try:
        rev_hash = _fill(a, a_api)
        want = _kvs(a, a_api)
    finally:
        a.close()
    assert any(f.endswith(".snap") for f in os.listdir(
        tmp_path / "member-1" / "snap"))
    b = b_cls(str(tmp_path), n=3, **kw)
    try:
        b.wait_leader(60)
        assert ss.final_hash(b) == rev_hash
        assert _kvs(b, b_api) == want
        assert len(want[0]) == 39
    finally:
        b.close()


def test_no_device_without_cuda_raises_before_the_data_dir(tmp_path,
                                                            monkeypatch):
    """The port's default backend runs on the card: with no device named
    and no CUDA, ServerConfig's server and the functional cluster raise
    before anything is written under data_dir."""
    from etcd_tpu_torch.raftexample.transport import InProcNetwork
    from etcd_tpu_torch.server import EtcdServer, ServerConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ServerConfig().raft_backend == "tpu"
    net = InProcNetwork()
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            EtcdServer(ServerConfig(data_dir=str(tmp_path), network=net))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TCluster(str(tmp_path), n=3)
    finally:
        net.stop()
    assert os.listdir(tmp_path) == []


def test_host_backend_resolves_no_device(tmp_path, monkeypatch):
    """raft_backend="host" runs the scalar core: it never asks for a
    device, so it boots and serves with device resolution refused."""
    from etcd_tpu_torch.batched import state as tstate

    def refuse(_device=None):
        raise AssertionError("the host backend resolved a device")

    # The server imports the helper where it resolves the device, so the
    # helper is refused at its home.
    monkeypatch.setattr(tstate, "resolve_device", refuse)
    c = TCluster(str(tmp_path), n=3, raft_backend="host")
    try:
        lead = c.wait_leader(60)
        lead.put(tapi.PutRequest(key=b"k", value=b"v"))
        assert lead.range(tapi.RangeRequest(key=b"k")).kvs[0].value == b"v"
        assert all(not hasattr(s, "device") for s in c.alive())
    finally:
        c.close()
