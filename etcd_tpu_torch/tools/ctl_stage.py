"""etcd's outer client surfaces against booted members: the port's
etcdctl, its grpc-proxy and its gateway, each a process of its own.

``run_ctl_stage(procs, solo, tmp)`` drives a running cluster of
``python -m etcd_tpu_torch`` members (``member_procs.MemberProc``) the
way etcd's e2e tests drive theirs, one ``python -m
etcd_tpu_torch.etcdctl`` process a command, and checks every output:

1. basic ops: a put at every member, followers included, and a
   linearizable get of all of them at every member; a delete; a txn
   from stdin; a watch that sees a put made by another process; a lease
   granted, kept alive once, read and revoked;
2. membership and health: ``member list -w json`` holds etcd's 64-bit
   member ids; ``endpoint status`` names one leader; ``endpoint health``;
   ``endpoint hashkv`` at one revision is equal at every member;
   ``move-leader`` to a follower and back;
3. a lock contended by two processes (the second gets it when the first
   lets go) and an election with a listener;
4. maintenance: compaction, defrag at every member, ``snapshot save``
   and the port's ``etcdutl snapshot status`` of the file, and
   ``make-mirror`` of a prefix into the member `solo` (another cluster):
   the same keys and bytes arrive;
5. ``check perf --load s``: PASS, with its puts/s, p50 and p99;
6. ``python -m etcd_tpu_torch grpc-proxy start`` in front of the
   members: a second serializable get of a key is served from the
   proxy's cache (the members' ``etcd_mvcc_range_total`` does not move),
   a put through the proxy is seen by the next get, and two watchers of
   one key share one upstream watcher (the members'
   ``etcd_debugging_mvcc_watcher_total`` rises by one) and both see the
   put;
7. ``python -m etcd_tpu_torch gateway start`` in front of the members
   (``step_gateway``, which ``run_ctl_stage`` leaves to its caller: it
   stops a member): etcdctl reaches a member through it, and, with the
   first endpoint's member stopped, another.

It starts no CUDA context of its own (etcdctl and the proxies import no
torch). Any failed check raises AssertionError. It returns each step's
seconds and the figures it read (``check perf``'s rate and latencies).
"""

from __future__ import annotations

import json
import os
import re
import signal
import subprocess
import sys
import time
import urllib.request
from typing import Callable, Dict, List, Optional

from ..client import Client
from .member_procs import (
    MemberProc, etcdctl, etcdctl_popen, free_ports, member_env)
from .proc_cluster import wait_until

MIRROR_KEYS = 200
MIRROR_VALUE_BYTES = 256


def ctl(endpoints: str, *args: str, stdin: Optional[str] = None,
        timeout: float = 60.0) -> str:
    """One etcdctl command's stdout, once it exited 0."""
    rc, out, err = etcdctl(endpoints, *args, stdin=stdin, timeout=timeout)
    if rc != 0:
        raise AssertionError(f"ctl: etcdctl {args} rc {rc}: {out[-800:]} "
                             f"{err[-1500:]}")
    return out


def expect(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"ctl: {what}")


def metric(p: MemberProc, name: str) -> float:
    """The sum of metric `name`'s samples at member `p`'s /metrics."""
    with urllib.request.urlopen(
            f"http://127.0.0.1:{p.metrics_port}/metrics", timeout=10) as r:
        text = r.read().decode()
    return sum(float(line.rsplit(None, 1)[1]) for line in text.splitlines()
               if line.startswith(name) and line[len(name):][:1] in " {")


def metric_sum(procs: List[MemberProc], name: str) -> float:
    return sum(metric(p, name) for p in procs)


def statuses(endpoints: str) -> List[dict]:
    """Each endpoint's Status (etcdctl prints a JSON list an endpoint)."""
    return [s["Status"]
            for line in ctl(endpoints, "-w", "json", "endpoint",
                            "status").splitlines()
            for s in json.loads(line)]


def leader_id(procs: List[MemberProc]) -> int:
    lead = [s["member_id"] for s in statuses(eps(procs)) if s["is_leader"]]
    return lead[0] if len(lead) == 1 else 0


def leader_of(procs: List[MemberProc]) -> MemberProc:
    """The member that leads, once one does."""
    wait_until(lambda: leader_id(procs) != 0, "a leader", 30.0, 0.05)
    return next(p for p in procs if p.member_id == leader_id(procs))


def eps(procs: List[MemberProc]) -> str:
    return ",".join(p.endpoint for p in procs)


def start_proxy(kind: List[str], endpoints: str, ready: str):
    """`python -m etcd_tpu_torch <kind> start` on a free port, once it
    printed its ready line: (process, its endpoint)."""
    (port,) = free_ports(1)
    p = subprocess.Popen(
        [sys.executable, "-m", "etcd_tpu_torch", *kind, "start",
         "--endpoints", endpoints, "--listen-addr", f"127.0.0.1:{port}"],
        env=member_env(None), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    line = p.stdout.readline()
    if not line.startswith(ready):
        p.kill()
        raise AssertionError(f"ctl: {kind} printed {line!r}: "
                             f"{p.stderr.read()[-1500:]}")
    return p, f"127.0.0.1:{port}"


def stop_proxy(p: subprocess.Popen, what: str) -> None:
    p.send_signal(signal.SIGTERM)
    rc = p.wait(timeout=60)
    p.stdout.close()
    p.stderr.close()
    expect(rc == 0, f"{what} exited {rc} on SIGTERM")


def finish(p: subprocess.Popen, what: str, timeout: float = 60.0) -> str:
    """A blocking etcdctl's stdout once it exits 0."""
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        p.kill()
        out, err = p.communicate()
        raise AssertionError(f"ctl: {what} did not end: {out} {err}")
    expect(p.returncode == 0, f"{what} rc {p.returncode}: {out} {err}")
    return out


def step_basic(procs, lead, out: dict) -> None:
    all_eps = eps(procs)
    for p in procs:
        expect(ctl(p.endpoint, "put", f"ctl/at/{p.name}", f"v-{p.name}")
               == "OK\n", f"put at {p.name}")
    want = "".join(f"ctl/at/{p.name}\nv-{p.name}\n"
                   for p in sorted(procs, key=lambda p: p.name))
    for p in procs:  # linearizable, at followers too
        got = ctl(p.endpoint, "get", "ctl/at/", "--prefix")
        expect(got == want, f"get at {p.name}: {got!r}")
    expect(ctl(all_eps, "del", "ctl/at/", "--prefix") == f"{len(procs)}\n",
           "delete")
    ctl(lead.endpoint, "put", "ctl/txn", "old")
    got = ctl(all_eps, "txn", stdin='value("ctl/txn") = "old"\n\n'
              "put ctl/txn new\n\nget ctl/txn\n")
    expect(got.startswith("SUCCEEDED\nOK\n"), f"txn: {got!r}")
    expect(ctl(all_eps, "get", "ctl/txn", "--print-value-only") == "new\n",
           "the txn's put")
    follower = next(p for p in procs if p is not lead)
    w = etcdctl_popen(follower.endpoint, "watch", "ctl/w", "--max-events",
                      "1")
    time.sleep(1.0)  # the watch is set up
    ctl(lead.endpoint, "put", "ctl/w", "seen")
    got = finish(w, "watch")
    expect(got == "PUT\nctl/w\nseen\n", f"watch: {got!r}")
    got = ctl(all_eps, "lease", "grant", "60")
    m = re.fullmatch(r"lease ([0-9a-f]+) granted with TTL\(60s\)\n", got)
    expect(m is not None, f"lease grant: {got!r}")
    lid = m.group(1)
    expect("keepalived" in ctl(follower.endpoint, "lease", "keep-alive",
                               lid, "--once"), "keep-alive --once")
    got = ctl(all_eps, "lease", "timetolive", lid)
    expect("granted with TTL(60s)" in got, f"timetolive: {got!r}")
    expect("revoked" in ctl(all_eps, "lease", "revoke", lid), "revoke")
    expect("already expired" in ctl(all_eps, "lease", "timetolive", lid),
           "the revoked lease")


def step_membership(procs, lead, out: dict) -> None:
    all_eps = eps(procs)
    ms = json.loads(ctl(all_eps, "-w", "json", "member", "list"))["members"]
    expect({m["id"] for m in ms} == {p.member_id for p in procs},
           f"member ids {ms}")
    expect({m["name"] for m in ms} == {p.name for p in procs}, "names")
    sts = statuses(all_eps)
    expect([s["member_id"] for s in sts if s["is_leader"]] == [
        lead.member_id], f"status: {sts}")
    got = ctl(all_eps, "endpoint", "health")
    expect(got.count("is healthy") == len(procs), f"health: {got!r}")
    rev = json.loads(ctl(lead.endpoint, "-w", "json", "get", "ctl/txn"))[
        "header"]["revision"]
    wait_until(lambda: len({s["applied_index"] for s in statuses(all_eps)})
               == 1, "the same applied index everywhere", 30.0, 0.05)
    lines = ctl(all_eps, "endpoint", "hashkv", "--rev", str(rev)).splitlines()
    hashes = {ln.split(", ")[1] for ln in lines}
    expect(len(lines) == len(procs) and len(hashes) == 1,
           f"hashkv at {rev}: {lines}")
    out["hashkv_revision"] = rev
    follower = next(p for p in procs if p is not lead)
    for target, via in ((follower, lead), (lead, follower)):
        ctl(via.endpoint, "move-leader", f"{target.member_id:x}")
        wait_until(lambda: leader_id(procs) == target.member_id,
                   f"the lead at {target.name}", 30.0, 0.05)


def step_lock_elect(procs, lead, out: dict) -> None:
    all_eps = eps(procs)
    holder = etcdctl_popen(all_eps, "lock", "ctl-lock", "--hold-seconds", "3")
    first = holder.stdout.readline()
    expect(first.startswith("ctl-lock/"), f"lock holder printed {first!r}")
    t0 = time.monotonic()
    second = ctl(all_eps, "--command-timeout", "30", "lock", "ctl-lock")
    waited = time.monotonic() - t0
    finish(holder, "lock holder")
    expect(second.startswith("ctl-lock/") and second.strip() != first.strip(),
           f"second locker: {second!r}")
    expect(waited > 1.0, f"the second locker waited {waited:.2f} s only")
    out["lock_wait_s"] = waited
    camp = etcdctl_popen(all_eps, "elect", "ctl-elect", "proposal-1",
                         "--hold-seconds", "3")
    expect(camp.stdout.readline().startswith("ctl-elect/"), "campaign")
    got = ctl(all_eps, "elect", "--listen", "ctl-elect")
    expect(got == "proposal-1\n", f"election listener: {got!r}")
    finish(camp, "campaigner")


def step_maintenance(procs, lead, solo, tmp, out: dict,
                     mirror_keys: int) -> None:
    all_eps = eps(procs)
    rev = json.loads(ctl(lead.endpoint, "-w", "json", "get", "ctl/txn"))[
        "header"]["revision"]
    got = ctl(all_eps, "compaction", str(rev))
    expect(f"compacted revision {rev}" in got, f"compaction: {got!r}")
    got = ctl(all_eps, "defrag")
    expect(got.count("Finished defragmenting") == len(procs), f"defrag {got!r}")
    snap = os.path.join(tmp, "ctl.snap.db")
    expect(ctl(lead.endpoint, "snapshot", "save", snap).startswith(
        "Snapshot saved at"), "snapshot save")
    r = subprocess.run(
        [sys.executable, "-m", "etcd_tpu_torch.etcdutl", "-w", "json",
         "snapshot", "status", snap], env=member_env(None), capture_output=True,
        text=True, timeout=120)
    expect(r.returncode == 0, f"etcdutl snapshot status: {r.stderr[-1500:]}")
    st = json.loads(r.stdout)
    expect(st["revision"] >= rev and st["totalSize"] == os.path.getsize(snap),
           f"snapshot status {st}")
    out["snapshot"] = st
    if solo is None:
        return
    # make-mirror of a prefix into another cluster's member: its base,
    # then one update.
    cl = Client([("127.0.0.1", lead.client_port)], request_timeout=60.0)
    try:
        want = {b"ctl/m/%04d" % i: os.urandom(MIRROR_VALUE_BYTES)
                for i in range(mirror_keys)}
        for k, v in want.items():
            cl.put(k, v)
        m = etcdctl_popen(lead.endpoint, "make-mirror", "--prefix", "ctl/m/",
                          "--max-txns", "1", solo.endpoint)
        dst = Client([("127.0.0.1", solo.client_port)], request_timeout=60.0)
        try:
            wait_until(lambda: dst.get(b"ctl/m/", b"ctl/m0", count_only=True,
                                       serializable=True).count == len(want),
                       "the mirror's base at the solo member", 120.0, 0.05)
            want[b"ctl/m/last"] = os.urandom(MIRROR_VALUE_BYTES)
            cl.put(b"ctl/m/last", want[b"ctl/m/last"])
            got = finish(m, "make-mirror", timeout=120)
            expect(got == f"{len(want)}\n", f"make-mirror printed {got!r}")
            kvs = {kv.key: kv.value
                   for kv in dst.get(b"ctl/m/", b"ctl/m0").kvs}
        finally:
            dst.close()
    finally:
        cl.close()
    expect(kvs == want, f"mirrored {len(kvs)} keys, {len(want)} sent")
    out["mirrored"] = {"keys": len(kvs),
                       "bytes": sum(len(v) for v in kvs.values())}


def step_check_perf(procs, lead, out: dict) -> None:
    got = ctl(eps(procs), "check", "perf", "--load", "s", timeout=300)
    m = re.search(r"(\d+) writes in ([\d.]+)s \(([\d.]+)/s\), p50 ([\d.]+)ms,"
                  r" p99 ([\d.]+)ms", got)
    expect(m is not None and got.rstrip().endswith("PASS"),
           f"check perf: {got!r}")
    out["check_perf"] = {"writes": int(m.group(1)), "s": float(m.group(2)),
                         "puts_per_s": float(m.group(3)),
                         "p50_ms": float(m.group(4)),
                         "p99_ms": float(m.group(5))}


def step_grpc_proxy(procs, lead, out: dict) -> None:
    proxy, ep = start_proxy(["grpc-proxy"], eps(procs), "grpcproxy: listening")
    try:
        expect(ctl(ep, "put", "ctl/g", "v1") == "OK\n", "put via the proxy")
        r0 = metric_sum(procs, "etcd_mvcc_range_total")
        gets = []
        for _ in range(2):
            gets.append(ctl(ep, "get", "ctl/g", "--consistency", "s"))
            gets.append(metric_sum(procs, "etcd_mvcc_range_total"))
        expect(gets[0] == gets[2] == "ctl/g\nv1\n", f"proxied gets {gets}")
        upstream = [gets[1] - r0, gets[3] - gets[1]]
        expect(upstream == [1, 0], f"upstream ranges of two gets {upstream}")
        expect(ctl(ep, "put", "ctl/g", "v2") == "OK\n", "second put")
        got = ctl(ep, "get", "ctl/g", "--consistency", "s")
        expect(got == "ctl/g\nv2\n", f"get after the put: {got!r}")
        w0 = metric_sum(procs, "etcd_debugging_mvcc_watcher_total")
        ws = [etcdctl_popen(ep, "watch", "ctl/gw", "--max-events", "1")
              for _ in range(2)]
        time.sleep(1.5)  # both watches set up at the proxy
        w1 = metric_sum(procs, "etcd_debugging_mvcc_watcher_total")
        ctl(lead.endpoint, "put", "ctl/gw", "both")
        for i, w in enumerate(ws):
            got = finish(w, f"proxied watcher {i}")
            expect(got == "PUT\nctl/gw\nboth\n", f"watcher {i}: {got!r}")
        expect(w1 - w0 == 1, f"upstream watchers of two proxied {w1 - w0}")
        out["grpc_proxy"] = {"upstream_ranges_of_two_gets": upstream,
                             "upstream_watchers_of_two": w1 - w0}
    finally:
        stop_proxy(proxy, "grpc-proxy")


def step_gateway(procs, first, out: dict,
                 stop: Optional[Callable[[], object]] = None) -> None:
    """The gateway in front of `procs`, `first` first: etcdctl reaches a
    member through it; then `stop()` (by default an orderly stop of
    `first`), and it reaches another. The caller boots `first` again."""
    order = [first] + [p for p in procs if p is not first]
    gw, ep = start_proxy(["gateway"], eps(order), "tcpproxy: ready")
    try:
        expect(ctl(ep, "put", "ctl/gw-k", "v") == "OK\n", "put via gateway")
        (stop or first.stop)()
        got = ctl(ep, "get", "ctl/gw-k")
        expect(got == "ctl/gw-k\nv\n", f"get via gateway, first down {got!r}")
    finally:
        stop_proxy(gw, "gateway")


def _pcts(xs: List[float]) -> Dict:
    xs = sorted(xs)
    if not xs:
        return {"n": 0}
    return {"n": len(xs), "p50_ms": 1e3 * xs[len(xs) // 2],
            "p99_ms": 1e3 * xs[min(len(xs) - 1, (99 * len(xs)) // 100)],
            "max_ms": 1e3 * xs[-1]}


def slowed_reads(procs: List[MemberProc], victim: Optional[MemberProc],
                 seconds: float, stop_s: float = 0.3,
                 run_s: float = 0.3) -> Dict:
    """Linearizable reads of one key, one after another from a client a
    member (threads of this process), at every member for `seconds`,
    while `victim` (if any) is stopped (SIGSTOP) for `stop_s` of every
    `stop_s + run_s` (SIGCONT between): each member's read count and
    p50 / p99 / max latency. A read at the victim waits out its stop;
    one that waits much longer waits for a backlog the stop left queued
    (ROADMAP C17). Any failed read raises."""
    import threading

    cl = Client([("127.0.0.1", procs[0].client_port)], request_timeout=60.0)
    try:
        cl.put(b"ctl/read", b"r")
    finally:
        cl.close()
    lat: Dict[str, List[float]] = {p.name: [] for p in procs}
    errs: List[str] = []
    done = threading.Event()

    def reader(p):
        c = Client([("127.0.0.1", p.client_port)], request_timeout=60.0)
        try:
            while not done.is_set():
                t0 = time.perf_counter()
                rr = c.get(b"ctl/read")
                lat[p.name].append(time.perf_counter() - t0)
                if [kv.value for kv in rr.kvs] != [b"r"]:
                    errs.append(f"{p.name} read {rr.kvs}")
        except Exception as e:  # noqa: BLE001 — reported below
            errs.append(f"{p.name}: {e!r}")
        finally:
            c.close()

    threads = [threading.Thread(target=reader, args=(p,)) for p in procs]
    for t in threads:
        t.start()
    t_end = time.monotonic() + seconds
    try:
        while time.monotonic() < t_end:
            if victim is not None:
                victim.proc.send_signal(signal.SIGSTOP)
                time.sleep(stop_s)
                victim.proc.send_signal(signal.SIGCONT)
            time.sleep(run_s)
    finally:
        if victim is not None:
            victim.proc.send_signal(signal.SIGCONT)
        done.set()
        for t in threads:
            t.join(120)
    expect(not errs, f"slowed reads: {errs[:3]}")
    return {p.name: _pcts(lat[p.name]) for p in procs}


def run_ctl_stage(procs: List[MemberProc], solo: Optional[MemberProc],
                  tmp: str, mirror_keys: int = MIRROR_KEYS) -> Dict:
    """Steps 1-6 above against the running members `procs` (and `solo`,
    another cluster, for make-mirror of `mirror_keys` keys of
    MIRROR_VALUE_BYTES and one more): each step's seconds and the
    figures read."""
    lead = leader_of(procs)
    out: Dict = {"step_s": {}}
    for name, fn in (
            ("basic", lambda: step_basic(procs, lead, out)),
            ("membership", lambda: step_membership(procs, lead, out)),
            ("lock_elect", lambda: step_lock_elect(procs, lead, out)),
            ("maintenance", lambda: step_maintenance(procs, lead, solo, tmp,
                                                     out, mirror_keys)),
            ("check_perf", lambda: step_check_perf(procs, lead, out)),
            ("grpc_proxy", lambda: step_grpc_proxy(procs, lead, out))):
        t0 = time.perf_counter()
        fn()
        out["step_s"][name] = time.perf_counter() - t0
    return out
