"""PyTorch port ↔ JAX reference: the proxies, and etcd's outer client
surfaces against booted port members.

- tests/proxy/test_grpcproxy.py's cases (passthrough, the serializable
  range cache and its invalidation, watch coalescing, a historical watch
  on an upstream watch of its own, compaction) and its v2 HTTP proxy's
  failover, and tests/transport/test_proxy.py's ``pkg/proxy`` cases
  (forward and blackhole, delay, reset), each run on both packages: each
  package's proxy in front of its own in-process member (the scalar
  core) or its own peer transports. What each case observes (values,
  cache hits and misses, upstream broadcasts, deliveries) is equal.
- ``python -m etcd_tpu_torch grpc-proxy start`` and ``gateway start`` in
  front of three port members on ``"tpu"`` (``--device cpu`` here), as
  the ``ctl`` stage of chip_smoke's ``boot`` phase runs them on the card
  (``tools/ctl_stage.py``; tests/test_torch_boot_smoke.py rehearses the
  whole stage).
"""

import importlib
import time

import pytest

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


class Member:
    """One package's single member on its scalar core, behind its
    V3RPCServer, and the package's modules."""

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
        self.Client = _mod(pkg, "client.client").Client
        self.GrpcProxy = _mod(pkg, "proxy.grpcproxy").GrpcProxy

    def close(self):
        self.rpc.stop()
        self.srv.stop()


@pytest.fixture(scope="module")
def members(tmp_path_factory):
    out = {}
    try:
        for pkg in PACKAGES:
            out[pkg] = Member(pkg, tmp_path_factory.mktemp(pkg))
        yield out
    finally:
        for m in out.values():
            m.close()


def case_passthrough_kv(m):
    proxy = m.GrpcProxy([m.rpc.addr])
    try:
        c = m.Client([proxy.addr])
        c.put(b"pk", b"pv")
        got = [kv.value for kv in c.get(b"pk").kvs]
        c.delete(b"pk")
        count = c.get(b"pk").count
        c.close()
        return {"got": got, "after_delete": count}
    finally:
        proxy.stop()


def case_range_cache_and_invalidation(m):
    proxy = m.GrpcProxy([m.rpc.addr])
    try:
        c = m.Client([proxy.addr])
        c.put(b"ck", b"v1")
        seen = [c.get(b"ck", serializable=True).kvs[0].value]
        counts = [(proxy.cache.hits, proxy.cache.misses)]
        seen.append(c.get(b"ck", serializable=True).kvs[0].value)
        counts.append((proxy.cache.hits, proxy.cache.misses))
        c.put(b"ck", b"v2")  # a write through the proxy invalidates
        seen.append(c.get(b"ck", serializable=True).kvs[0].value)
        counts.append((proxy.cache.hits, proxy.cache.misses))
        c.close()
        return {"seen": seen, "hits_misses": counts, "gen": proxy.cache.gen}
    finally:
        proxy.stop()


def case_watch_coalescing(m):
    proxy = m.GrpcProxy([m.rpc.addr])
    try:
        c1, c2 = m.Client([proxy.addr]), m.Client([proxy.addr])
        h1, h2 = c1.watch(b"wk"), c2.watch(b"wk")
        wait_until(lambda: len(proxy._bcasts) == 1, msg="broadcast join")
        writer = m.Client([m.rpc.addr])
        writer.put(b"wk", b"fanout")
        got = [h.get(timeout=5)[1][0].kv.value for h in (h1, h2)]
        bcasts = len(proxy._bcasts)
        h1.cancel()
        h2.cancel()
        wait_until(lambda: len(proxy._bcasts) == 0, msg="broadcast teardown")
        for c in (writer, c1, c2):
            c.close()
        return {"got": got, "broadcasts": bcasts}
    finally:
        proxy.stop()


def case_historical_watch_dedicated(m):
    writer = m.Client([m.rpc.addr])
    writer.put(b"hk", b"old")
    rev = writer.get(b"hk").header.revision
    proxy = m.GrpcProxy([m.rpc.addr])
    try:
        c = m.Client([proxy.addr])
        h = c.watch(b"hk", start_rev=rev)  # replay from history
        got = h.get(timeout=5)[1][0].kv.value
        bcasts = len(proxy._bcasts)
        h.cancel()
        c.close()
        return {"got": got, "broadcasts": bcasts}
    finally:
        proxy.stop()
        writer.close()


def case_compaction_through_proxy(m):
    proxy = m.GrpcProxy([m.rpc.addr])
    try:
        c = m.Client([proxy.addr])
        for i in range(5):
            c.put(b"comp", str(i).encode())
        rev = c.get(b"comp").header.revision
        c.compact(rev)
        got = proxy.cache.compact_rev == rev
        c.close()
        return {"compact_rev_is_the_revision": got}
    finally:
        proxy.stop()


def case_http_proxy_failover(m):
    v2http = _mod(m.pkg, "v2http")
    V2Client = _mod(m.pkg, "client.v2").V2Client
    HTTPProxy = _mod(m.pkg, "proxy.httpproxy").HTTPProxy
    h = v2http.V2HTTP(m.srv)
    # A dead endpoint first: the connect-phase failover skips it.
    proxy = HTTPProxy([("127.0.0.1", 1), h.addr])
    try:
        cl = V2Client([proxy.addr], timeout=15.0)
        resp = None
        deadline = time.monotonic() + 15
        while resp is None and time.monotonic() < deadline:
            try:
                resp = cl.set("/proxied", "yes")
            except Exception:  # noqa: BLE001 — asked again
                time.sleep(0.2)
        return {"set": resp.node.value, "get": cl.get("/proxied").node.value}
    finally:
        proxy.stop()
        h.close()


def _transports(pkg, delay=0.0):
    ProxyServer = _mod(pkg, "pkg.proxy").ProxyServer
    TCPTransport = _mod(pkg, "transport").TCPTransport
    t2 = TCPTransport(member_id=2, cluster_id=1)
    got = []
    t2.register(2, got.append)
    proxy = ProxyServer(("127.0.0.1", 0), t2.addr)
    if delay:
        proxy.delay_tx(delay)
    t1 = TCPTransport(member_id=1, cluster_id=1)
    t1.add_peer(2, proxy.addr)
    return t1, t2, proxy, got


def _hb(pkg, index):
    types = _mod(pkg, "raft.types")
    return [types.Message(type=types.MessageType.MsgHeartbeat, to=2,
                          from_=1, index=index)]


def case_pkg_proxy_forward_and_blackhole(m):
    t1, t2, proxy, got = _transports(m.pkg)
    try:
        t1.send(1, _hb(m.pkg, 1))
        wait_until(lambda: len(got) == 1, msg="forward through proxy")
        proxy.blackhole()
        t1.send(1, _hb(m.pkg, 2))
        time.sleep(0.3)
        held = len(got)
        proxy.unblackhole()
        t1.send(1, _hb(m.pkg, 3))
        wait_until(lambda: len(got) >= 2, msg="delivery after unblackhole")
        return {"blackholed": held, "indexes": sorted({g.index for g in got}
                                                      - {2})}
    finally:
        t1.stop()
        t2.stop()
        proxy.stop()


def case_pkg_proxy_delay(m):
    t1, t2, proxy, got = _transports(m.pkg, delay=0.3)
    try:
        start = time.monotonic()
        t1.send(1, _hb(m.pkg, 0))
        wait_until(lambda: got, msg="delayed delivery")
        return {"delayed": time.monotonic() - start >= 0.25}
    finally:
        t1.stop()
        t2.stop()
        proxy.stop()


def case_pkg_proxy_reset_listen(m):
    t1, t2, proxy, got = _transports(m.pkg)
    try:
        t1.send(1, _hb(m.pkg, 1))
        wait_until(lambda: len(got) == 1, msg="pre-reset delivery")
        proxy.reset_listen()
        deadline = time.monotonic() + 10
        while len(got) < 2 and time.monotonic() < deadline:
            t1.send(1, _hb(m.pkg, 2))
            time.sleep(0.05)
        return {"recovered": len(got) >= 2}
    finally:
        t1.stop()
        t2.stop()
        proxy.stop()


CASES = {
    "passthrough_kv": (case_passthrough_kv,
                       {"got": [b"pv"], "after_delete": 0}),
    "range_cache_and_invalidation": (case_range_cache_and_invalidation, None),
    "watch_coalescing": (case_watch_coalescing,
                         {"got": [b"fanout"] * 2, "broadcasts": 1}),
    "historical_watch_dedicated": (case_historical_watch_dedicated,
                                   {"got": b"old", "broadcasts": 0}),
    "compaction_through_proxy": (case_compaction_through_proxy,
                                 {"compact_rev_is_the_revision": True}),
    "http_proxy_failover": (case_http_proxy_failover,
                            {"set": "yes", "get": "yes"}),
    "pkg_proxy_forward_and_blackhole": (
        case_pkg_proxy_forward_and_blackhole,
        {"blackholed": 1, "indexes": [1, 3]}),
    "pkg_proxy_delay": (case_pkg_proxy_delay, {"delayed": True}),
    "pkg_proxy_reset_listen": (case_pkg_proxy_reset_listen,
                               {"recovered": True}),
}


@pytest.mark.parametrize("name", list(CASES))
def test_proxy_case_matches_the_reference(members, name):
    fn, want = CASES[name]
    ref, port = fn(members["etcd_tpu"]), fn(members["etcd_tpu_torch"])
    assert port == ref
    if want is not None:
        assert ref == want
    if name == "range_cache_and_invalidation":
        # A hit on the second get, a miss again after the write.
        (h0, m0), (h1, m1), (h2, m2) = ref["hits_misses"]
        assert ref["seen"] == [b"v1", b"v1", b"v2"]
        assert (h1 - h0, m1 - m0) == (1, 0) and (h2 - h1, m2 - m1) == (0, 1)


def test_proxies_through_etcdmain_against_booted_members(tmp_path):
    """``python -m etcd_tpu_torch grpc-proxy start`` and ``gateway start``
    (the ctl stage's proxy steps) in front of three CPU members: the
    grpc-proxy's cache hit and coalesced watch, the gateway's failover;
    the members' SIGHUP launch lines count the node rounds between."""
    from etcd_tpu_torch.tools import ctl_stage
    from etcd_tpu_torch.tools.member_procs import MemberCluster

    c = MemberCluster(str(tmp_path / "cluster"), device="cpu")
    c.start()
    out = {}
    try:
        before = {p.name: p.launches_now() for p in c.procs}
        lead = ctl_stage.leader_of(c.procs)
        ctl_stage.step_grpc_proxy(c.procs, lead, out)
        first = next(p for p in c.procs if p is not lead)
        ctl_stage.step_gateway(c.procs, first, out)
        first.start()
        first.wait_ready()
        after = {p.name: p.launches_now() for p in c.procs}
    finally:
        c.close()
    assert out["grpc_proxy"] == {"upstream_ranges_of_two_gets": [1, 0],
                                 "upstream_watchers_of_two": 1}
    for name, ln in after.items():
        assert ln["at"] == "signal", ln
        if ln["gen"] == before[name]["gen"]:  # not the restarted member
            assert ln["rounds"] > before[name]["rounds"], (before, after)


def _slow_backend(delay):
    """A listener that answers each connection's first bytes with
    b"late:" + them after `delay` seconds."""
    import socket
    import threading

    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(8)

    def serve():
        while True:
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            data = conn.recv(64)
            time.sleep(delay)
            try:
                conn.sendall(b"late:" + data)
            except OSError:
                pass
            conn.close()

    threading.Thread(target=serve, daemon=True).start()
    return srv


@pytest.mark.parametrize("pkg", PACKAGES)
def test_gateway_waits_for_a_slow_answer(pkg):
    """The listed difference of the port's gateway (ROADMAP C22): a
    backend dial's 2 s timeout bounds the dial alone, so an answer that
    takes 2.5 s (a read while the members elect) reaches the client; the
    reference's gateway keeps the timeout on the connection and closes
    it."""
    import socket

    backend = _slow_backend(2.5)
    proxy = _mod(pkg, "proxy.tcpproxy").TCPProxy([backend.getsockname()])
    try:
        with socket.create_connection(proxy.addr, timeout=10) as c:
            c.sendall(b"ping")
            got = c.recv(64)
    finally:
        proxy.stop()
        backend.close()
    assert got == (b"late:ping" if pkg == "etcd_tpu_torch" else b"")
