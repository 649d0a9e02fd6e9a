"""PyTorch port ↔ JAX reference over the wire: the framed v3 RPC.

- ``etcd_tpu``'s ``Client`` drives a port ``V3RPCServer`` in front of a
  port server, and the port's ``Client`` drives ``etcd_tpu``'s: put,
  range, txn, delete, a watch from a revision, lease grant, keep-alive
  and time-to-live, a compaction and the typed ``ErrCompacted`` the
  client rebuilds, lock contention between two clients, and election
  campaign, observe, proclaim and resign, as the reference's
  integration tests expect them (tests/integration/test_v3election_lock).
- A subprocess rebuilds every symbol of the port's ``rpctypes.TABLE``
  through the port's ``exception_for``: every class lives in
  ``etcd_tpu_torch`` and neither ``etcd_tpu`` nor ``jax`` is loaded.
"""

import json
import subprocess
import sys
import threading
import time

import pytest

from etcd_tpu import client as jclient
from etcd_tpu.client import concurrency as jconc
from etcd_tpu.functional import Cluster as JCluster
from etcd_tpu.server import api as japi
from etcd_tpu.v3rpc import V3RPCServer as JRPC
from etcd_tpu_torch import client as tclient
from etcd_tpu_torch.client import concurrency as tconc
from etcd_tpu_torch.functional import Cluster as TCluster
from etcd_tpu_torch.server import api as tapi
from etcd_tpu_torch.v3rpc import V3RPCServer as TRPC

ROOT = __file__.rsplit("/tests/", 1)[0]

# server side, client side: (cluster, rpc server) and (client, recipes, api)
SIDES = {
    "port_client_on_jax_server": ((JCluster, JRPC), (tclient, tconc, tapi)),
    "jax_client_on_port_server": ((TCluster, TRPC), (jclient, jconc, japi)),
}


@pytest.fixture(params=sorted(SIDES))
def wire(request, tmp_path):
    (cluster_cls, rpc_cls), (cmod, conc, api) = SIDES[request.param]
    c = cluster_cls(str(tmp_path), n=1, raft_backend="host")
    lead = c.wait_leader(60)
    rpc = rpc_cls(lead, bind=("127.0.0.1", 0))
    clients = []

    def new_client():
        cl = cmod.Client([rpc.addr])
        clients.append(cl)
        return cl

    yield new_client, conc, api, cmod
    for cl in clients:
        cl.close()
    rpc.stop()
    c.close()


def test_kv_txn_watch_compaction(wire):
    new_client, _conc, api, cmod = wire
    cl = new_client()
    r1 = cl.put(b"a", b"1")
    prev = cl.put(b"a", b"2", prev_kv=True)
    assert prev.prev_kv.value == b"1"
    assert prev.header.revision == r1.header.revision + 1
    cl.put(b"b", b"3")
    rr = cl.get(b"a", range_end=b"c")
    assert [(kv.key, kv.value) for kv in rr.kvs] == [(b"a", b"2"), (b"b", b"3")]
    assert cl.get(b"a", revision=r1.header.revision).kvs[0].value == b"1"
    assert cl.get(b"a", range_end=b"c", limit=1).more
    t = cl.txn(api.TxnRequest(
        compare=[api.Compare(result=api.CompareResult.EQUAL,
                             target=api.CompareTarget.VALUE, key=b"a",
                             value=b"2")],
        success=[api.RequestOp(request_put=api.PutRequest(key=b"a",
                                                          value=b"4"))],
        failure=[]))
    assert t.succeeded
    assert cl.get(b"a").kvs[0].value == b"4"
    d = cl.delete(b"b", prev_kv=True)
    assert d.deleted == 1 and d.prev_kvs[0].value == b"3"

    # A watch from the first revision sees every write, in order.
    h = cl.watch(b"a", b"c", start_rev=r1.header.revision)
    events = []
    deadline = time.monotonic() + 10
    while len(events) < 5 and time.monotonic() < deadline:
        batch = h.get(timeout=1.0)
        if batch is not None:
            events.extend(batch[1])
    assert [(e.kv.key, e.kv.value) for e in events] == [
        (b"a", b"1"), (b"a", b"2"), (b"b", b"3"), (b"a", b"4"), (b"b", b"")]
    h.cancel()

    # Compaction; a read below it is the typed ErrCompacted, rebuilt from
    # the client's own package.
    cur = cl.get(b"a").header.revision
    cl.compact(cur)
    with pytest.raises(cmod.ClientError) as ei:
        cl.get(b"a", revision=r1.header.revision)
    typed = ei.value.as_typed()
    assert type(typed).__name__ == "CompactedError"
    assert type(typed).__module__.split(".")[0] == cmod.__name__.split(".")[0]


def test_lease_grant_keepalive_ttl(wire):
    new_client, _conc, _api, _cmod = wire
    cl = new_client()
    lid = cl.lease_grant(ttl=3, lease_id=0x5A5A).id
    assert lid == 0x5A5A
    cl.put(b"leased", b"v", lease=lid)
    stop = cl.lease_keep_alive(lid, interval=0.3)
    try:
        time.sleep(4.0)  # past the TTL: alive only by the keep-alive
        ttl = cl.lease_time_to_live(lid, keys=True)
        assert ttl["ttl"] > 0 and ttl["granted_ttl"] == 3
        assert cl.get(b"leased").kvs
    finally:
        stop()
    cl.lease_revoke(lid)
    assert not cl.get(b"leased").kvs


def test_lock_contention_two_clients(wire):
    new_client, conc, _api, _cmod = wire
    c1, c2 = new_client(), new_client()
    s1, s2 = conc.Session(c1, ttl=30), conc.Session(c2, ttl=30)
    try:
        k1 = c1.lock(b"testlock", s1.lease_id)
        assert k1.startswith(b"testlock/")
        acquired = []
        t = threading.Thread(target=lambda: acquired.append(
            c2.lock(b"testlock", s2.lease_id)), daemon=True)
        t.start()
        time.sleep(0.5)
        assert not acquired, "second lock acquired while the first is held"
        c1.unlock(k1)
        t.join(timeout=10)
        assert acquired and acquired[0] != k1
        c2.unlock(acquired[0])
    finally:
        s1.close()
        s2.close()


def test_election_campaign_observe_resign(wire):
    new_client, conc, _api, cmod = wire
    c1, c2, c3 = new_client(), new_client(), new_client()
    s1, s2 = conc.Session(c1, ttl=30), conc.Session(c2, ttl=30)
    try:
        lk1 = c1.campaign(b"pres", s1.lease_id, b"alice")
        assert c1.election_leader(b"pres").value == b"alice"
        oh = c3.observe(b"pres")
        assert oh.get(timeout=10).value == b"alice"
        c1.proclaim(lk1, b"alice-2")
        assert oh.get(timeout=10).value == b"alice-2"
        stale = dict(lk1)
        stale["rev"] = lk1["rev"] + 100
        with pytest.raises(cmod.ClientError):
            c1.proclaim(stale, b"nope")
        won = []
        t = threading.Thread(target=lambda: won.append(
            c2.campaign(b"pres", s2.lease_id, b"bob")), daemon=True)
        t.start()
        time.sleep(0.5)
        assert not won
        c1.resign(lk1)
        t.join(timeout=10)
        assert won and c2.election_leader(b"pres").value == b"bob"
        assert oh.get(timeout=10).value == b"bob"
        oh.cancel()
        with pytest.raises(cmod.ClientError) as ei:
            c1.election_leader(b"nobody")
        assert "NoLeader" in ei.value.etype
    finally:
        s1.close()
        s2.close()


def test_every_table_symbol_rebuilds_a_port_class():
    """Every TABLE entry of the port's rpctypes rebuilds, through the
    port's exception_for, an exception class of etcd_tpu_torch, in a
    process that loads neither etcd_tpu nor jax."""
    code = """
import json, sys
from etcd_tpu_torch.pkg import rpctypes
out = {}
for sym in sorted(rpctypes.TABLE):
    e = rpctypes.exception_for(sym, "m")
    out[sym] = [type(e).__module__, type(e).__name__,
                rpctypes.entry_for_exception(e)[0]]
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "etcd_tpu" or m.startswith("etcd_tpu."))
print(json.dumps({"out": out, "bad": bad}))
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    got = json.loads(res.stdout)
    assert got["bad"] == []
    from etcd_tpu.pkg import rpctypes as jrpc

    assert sorted(got["out"]) == sorted(jrpc.TABLE)
    for sym, (module, name, back) in got["out"].items():
        assert module.startswith("etcd_tpu_torch."), (sym, module)
        assert back == sym
        # The same class name as the reference's table: either package's
        # client reads either server's errors by name.
        assert name == jrpc.TABLE[sym][2].rsplit(":", 1)[1], sym
