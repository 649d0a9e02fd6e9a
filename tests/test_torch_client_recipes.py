"""PyTorch port ↔ JAX reference: the client recipes.

tests/client/test_features.py's cases (the ordering guard and its
remedy, the leasing cache with owner write-through, non-owner revocation
and a dead owner's marker, the naming registry, the open-range sentinel,
the mirror's base and its update stream, snapshot save), the namespace
wrapper and the v2 HTTP client, each run on both packages: each
package's recipe over its own client against its own in-process member
(the scalar core) behind its ``V3RPCServer`` or its v2 listener. What
each case observes (values, revisions relative to the case's start,
cache hits, errors, events, bytes) is equal.
"""

import importlib
import os
import threading
import time

import pytest

from etcd_tpu_torch.tools.server_script import plain

PACKAGES = ("etcd_tpu", "etcd_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def wait_until(pred, timeout=10.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


class Side:
    def __init__(self, pkg, tmp):
        self.pkg = pkg
        srv = _mod(pkg, "server")
        self.srv = srv.EtcdServer(srv.ServerConfig(
            member_id=1, peers=[1], data_dir=str(tmp),
            network=_mod(pkg, "raftexample.transport").InProcNetwork(),
            tick_interval=0.01, raft_backend="host"))
        self.rpc = _mod(pkg, "v3rpc.service").V3RPCServer(
            self.srv, bind=("127.0.0.1", 0))
        wait_until(self.srv.is_leader, msg="leader")
        self.api = _mod(pkg, "server.api")

    def mod(self, name):
        return _mod(self.pkg, name)

    def client(self):
        return self.mod("client.client").Client([self.rpc.addr])

    def close(self):
        self.rpc.stop()
        self.srv.stop()


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    out = {}
    try:
        for pkg in PACKAGES:
            out[pkg] = Side(pkg, tmp_path_factory.mktemp(pkg))
        yield out
    finally:
        for s in out.values():
            s.close()


def case_ordering(s, tmp):
    ordering = s.mod("client.ordering")
    c = s.client()
    out = {}
    try:
        kv = ordering.OrderingKV(c)
        kv.put(b"ok1", b"a")
        kv.get(b"ok1")
        kv.put(b"ok1", b"b")
        out["monotonic"] = kv.get(b"ok1").kvs[0].value
        called = []
        kv = ordering.OrderingKV(c, violation_fn=called.append)
        kv.put(b"ov", b"x")
        kv._prev_rev = 10**9  # as if a future revision had been seen
        try:
            kv.get(b"ov")
            out["violation"] = None
        except ordering.OrderViolationError as e:
            out["violation"] = (type(e).__name__, len(called))
        kv = ordering.OrderingKV(c)
        kv.violation_fn = lambda _err: setattr(kv, "_prev_rev", 0)
        kv._prev_rev = 10**9
        out["remedied"] = kv.get(b"ov").kvs[0].value
    finally:
        c.close()
    return out


def case_util_guards(s, tmp):
    util = s.mod("client.util")
    api = s.api
    c = s.client()
    try:
        c.put(b"exists", b"1")
        r1 = c.txn(api.TxnRequest(
            compare=[util.key_exists(b"exists")],
            success=[api.RequestOp(request_put=api.PutRequest(
                key=b"guarded", value=b"y"))]))
        r2 = c.txn(api.TxnRequest(compare=[util.key_missing(b"exists")]))
        return [r1.succeeded, r2.succeeded, c.get(b"guarded").kvs[0].value]
    finally:
        c.close()


def case_leasing(s, tmp):
    LeasingKV = s.mod("client.leasing").LeasingKV
    c1, c2 = s.client(), s.client()
    out = {}
    owner = LeasingKV(c1, "_leases/")
    writer = LeasingKV(c2, "_leases/")
    try:
        c1.put(b"lk", b"v0")
        hits0 = owner.cache_hits
        first = owner.get(b"lk").kvs[0].value
        second = owner.get(b"lk").kvs[0].value
        out["cached"] = (first, second, owner.cache_hits - hits0)
        owner.put(b"lk", b"updated")  # write-through, still cached
        out["write_through"] = (owner.get(b"lk").kvs[0].value,
                                c1.get(b"lk").kvs[0].value)
        writer.put(b"lk", b"two")  # a non-owner write revokes the owner
        wait_until(lambda: b"lk" not in owner._owned, msg="revoked")
        out["after_revoke"] = owner.get(b"lk").kvs[0].value
        out["header_revision_positive"] = owner.get(
            b"lk").header.revision > 0
    finally:
        owner.close()
        writer.close()
        c1.close()
        c2.close()
    return out


def case_leasing_dead_owner(s, tmp):
    LeasingKV = s.mod("client.leasing").LeasingKV
    c1, c2 = s.client(), s.client()
    owner = LeasingKV(c1, "_rl/")
    owner.get(b"rlk")  # the marker, on the owner's session lease
    marker = b"_rl/rlk"
    out = {"bound": c2.get(marker).kvs[0].lease == owner.session.lease_id}
    owner._closed = True  # a dead owner: its watcher gone, marker left
    owner._watch.cancel()
    owner._watcher.join(timeout=5)
    writer = LeasingKV(c2, "_rl/")
    try:
        try:
            writer.put(b"rlk", b"w", timeout=1.0)
            out["blocked"] = False
        except TimeoutError:
            out["blocked"] = True
        kv = c2.get(marker).kvs[0]
        out["stamp"] = (kv.value, kv.lease == owner.session.lease_id)
        owner.session.close()  # the owner's lease goes: the writer runs
        writer.put(b"rlk", b"w2", timeout=5.0)
        out["after"] = c2.get(b"rlk").kvs[0].value
    finally:
        writer.close()
        c1.close()
        c2.close()
    return out


def case_naming(s, tmp):
    Endpoints = s.mod("client.naming").Endpoints
    c = s.client()
    try:
        eps = Endpoints(c, "services/db")
        eps.add("a", "10.0.0.1:2379")
        eps.add("b", "10.0.0.2:2379", metadata={"zone": "z1"})
        listing = eps.list()
        addrs = sorted(eps.addresses())
        h = eps.watch()
        eps.delete("a")
        got = h.get(timeout=5)
        h.cancel()
        return {"listing": listing, "addresses": addrs,
                "event": [(int(ev.type), ev.kv.key) for ev in got[1]],
                "after": sorted(eps.list())}
    finally:
        c.close()


def case_open_range(s, tmp):
    c = s.client()
    try:
        c.put(b"\x01low", b"a")
        c.put(b"zz\xff\xffhigh", b"b")
        every = [kv.key for kv in c.get(b"\x00", b"\x00").kvs]
        mid = [kv.key for kv in c.get(b"zz", b"\x00").kvs]
        h = c.watch(b"\x00", b"\x00")
        c.put(b"anywhere/at/all", b"seen")
        got = h.get(timeout=5)
        h.cancel()
        return {"low_and_high": [k in every for k in (
            b"\x01low", b"zz\xff\xffhigh")], "mid": mid,
            "watched": got[1][0].kv.key}
    finally:
        c.close()


def case_mirror(s, tmp):
    Syncer = s.mod("client.mirror").Syncer
    api = s.api
    src, dest = s.client(), s.client()
    try:
        src.put(b"wm1", b"x")
        src.put(b"wm2", b"y")
        _rev, kvs = Syncer(src).sync_base()  # no prefix: everything
        whole = [k in [kv.key for kv in kvs] for k in (b"wm1", b"wm2")]
        src.put(b"mirr-src/seed", b"s")
        sy = Syncer(src, b"mirr-src/")
        stop = threading.Event()
        t = threading.Thread(target=lambda: sy.mirror_to(
            dest, dest_prefix=b"mirr-dst/", max_txns=0, stop=stop),
            daemon=True)
        t.start()
        time.sleep(0.3)  # the update stream attaches
        # One txn of two puts: one watch batch of two events.
        src.txn(api.TxnRequest(success=[
            api.RequestOp(request_put=api.PutRequest(
                key=b"mirr-src/a", value=b"1")),
            api.RequestOp(request_put=api.PutRequest(
                key=b"mirr-src/b", value=b"2"))]))
        wait_until(lambda: dest.get(b"mirr-dst/a").count
                   and dest.get(b"mirr-dst/b").count, timeout=5,
                   msg="mirrored batch")
        stop.set()
        t.join(timeout=5)
        got = {kv.key: kv.value
               for kv in dest.get(b"mirr-dst/", b"mirr-dst0").kvs}
        return {"whole_keyspace": whole, "mirrored": got}
    finally:
        src.close()
        dest.close()


def case_namespace(s, tmp):
    ns = s.mod("client.namespace")
    c = s.client()
    try:
        nc = ns.NamespacedClient(c, b"tenant/")
        nc.put(b"a", b"1")
        nc.put(b"b", b"2")
        got = [(kv.key, kv.value) for kv in nc.get(b"a", b"c").kvs]
        raw = [kv.key for kv in c.get(b"tenant/", b"tenant0").kvs]
        h = nc.watch(b"w")
        nc.put(b"w", b"seen")
        ev = h.get(timeout=5)
        h.cancel()
        deleted = nc.delete(b"a").deleted
        return {"got": got, "raw": raw, "deleted": deleted,
                "watched": [(kv.key, kv.value) for kv in (
                    e.kv for e in ev[1])]}
    finally:
        c.close()


def case_snapshot_save(s, tmp):
    save = s.mod("client.snapshot").save
    c = s.client()
    try:
        c.put(b"snapk", b"snapv")
        path = str(tmp / f"{s.pkg}.snap.db")
        n = save(c, path)
        return {"size_is_the_file": os.path.getsize(path) == n and n > 0,
                "no_part": not os.path.exists(path + ".part")}
    finally:
        c.close()


def case_v2_client(s, tmp):
    h = s.mod("v2http").V2HTTP(s.srv)
    v2 = s.mod("client.v2")
    try:
        cl = v2.V2Client([h.addr], timeout=15.0)
        out = [plain(cl.set("/v2k", "one").node.value),
               cl.get("/v2k").node.value,
               cl.update("/v2k", "two").node.value,
               cl.mkdir("/v2dir").node.dir,
               cl.create("/v2dir/x", "1").node.value,
               sorted(n.key for n in cl.get("/v2dir", recursive=True)
                      .node.nodes),
               cl.delete("/v2k").action]
        try:
            cl.get("/v2k")
            out.append(None)
        except v2.V2ClientError as e:
            out.append((e.code, e.message))
        return out
    finally:
        h.close()


CASES = {f.__name__[len("case_"):]: f for f in (
    case_ordering, case_util_guards, case_leasing, case_leasing_dead_owner,
    case_naming, case_open_range, case_mirror, case_namespace,
    case_snapshot_save, case_v2_client)}


@pytest.mark.parametrize("name", list(CASES))
def test_recipe_matches_the_reference(sides, name, tmp_path):
    ref = CASES[name](sides["etcd_tpu"], tmp_path)
    port = CASES[name](sides["etcd_tpu_torch"], tmp_path)
    assert plain(port) == plain(ref)
