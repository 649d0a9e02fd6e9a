"""Booted port members beside the reference's, and etcd's benchmark tool.

- A mixed cluster: one ``etcd_tpu`` member (the scalar core, as the
  reference's embed boots it) and two port members on ``"tpu"``. The
  reference member is made the leader, so that its appends of many
  entries, its heartbeats carrying its read requests' contexts and its
  MsgReadIndexResp reach the port's node; a burst of puts through it,
  a get at every member, hash_kv agreement, then kill -9 of the leader,
  reads at the survivors, its restart and a put and get at every member.
- Cross-boot: a reference member's data dir boots a port ``"tpu"``
  member, and the reverse; the same keys and the same ``member list``
  ids come back.
- The port's ``tools/benchmark.py`` (with ``pkg/report.py``) in its own
  process against a port member and against a reference member: the
  same seeded runs give the same request and error counts and leave the
  same keys and values.
"""

import re
import subprocess
import sys
import threading
import time

import pytest

from etcd_tpu_torch.tools.member_procs import (
    MemberCluster, MemberProc, free_ports, member_env)

from .framework.e2e import etcdctl


def _all_kvs(p):
    cl = p.client()
    try:
        rr = cl.get(b"\x00", b"\xff", serializable=True)
    finally:
        cl.close()
    return {kv.key: kv.value for kv in rr.kvs}


def test_mixed_cluster_reference_leader(tmp_path):
    c = MemberCluster(str(tmp_path), device="cpu", modules={0: "etcd_tpu"})
    c.start()
    try:
        ref = c.procs[0]
        deadline = time.monotonic() + 60
        while (lead := c.leader()) is not ref:
            assert time.monotonic() < deadline, "the lead never moved"
            cl = lead.client()
            try:
                cl.move_leader(ref.member_id)
            except Exception:  # noqa: BLE001 — asked again below
                pass
            finally:
                cl.close()
            time.sleep(1.0)
        # A burst through the reference leader: its MsgApps carry more
        # entries than a port round takes from one message.
        errs = []

        def burst(k):
            cl = ref.client()
            try:
                for j in range(4):
                    cl.put(b"burst/%02d/%d" % (k, j), b"v%d" % (k * 4 + j))
            except Exception as e:  # noqa: BLE001 — reported below
                errs.append(repr(e))
            finally:
                cl.close()

        threads = [threading.Thread(target=burst, args=(k,))
                   for k in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not errs, errs[:3]
        want = {b"burst/%02d/%d" % (k, j): b"v%d" % (k * 4 + j)
                for k in range(24) for j in range(4)}
        # A port follower takes one append a round from each sender, and
        # the scalar leader sent one a proposal: its linearizable read
        # waits for the backlog to apply (seconds on a loaded CPU;
        # ROADMAP C18), so the reads get etcdctl's timeout of 30 s.
        for p in c.procs:
            rc, out, err = etcdctl(p.endpoint, "--command-timeout", "30",
                                   "get", "burst/", "--prefix", timeout=90)
            assert rc == 0, (p.name, err)
            lines = out.splitlines()
            got = dict(zip(lines[::2], lines[1::2]))
            assert got == {k.decode(): v.decode() for k, v in want.items()}
        hashes = set()
        rev = ref.client().status()["revision"]
        for p in c.procs:
            cl = p.client()
            try:
                hashes.add(cl.hash_kv(rev)["hash"])
            finally:
                cl.close()
        assert len(hashes) == 1
        # kill -9 of the (reference) leader.
        ref.kill9()
        survivors = c.endpoints(c.procs[1:])
        rc, out, err = etcdctl(survivors, "get", "burst/00/0", timeout=90)
        assert rc == 0 and out == "burst/00/0\nv0\n", err
        ref.start()
        ref.wait_ready()
        for p in c.procs:
            rc, _out, err = etcdctl(p.endpoint, "put", f"at-{p.name}", "x",
                                    timeout=90)
            assert rc == 0, (p.name, err)
        for p in c.procs:
            rc, out, err = etcdctl(p.endpoint, "get", "at-", "--prefix",
                                   timeout=90)
            assert rc == 0 and out.split() == [
                "at-m0", "x", "at-m1", "x", "at-m2", "x"], (p.name, err)
    finally:
        lines = c.close()
    # The two port members' orderly stops; the reference member writes
    # none.
    assert len(lines) == 2 and all(ln["rounds"] > 0 for ln in lines)


@pytest.mark.parametrize("first,then", [("etcd_tpu", "etcd_tpu_torch"),
                                        ("etcd_tpu_torch", "etcd_tpu")])
def test_cross_boot(tmp_path, first, then):
    """A data dir written by one package's member boots the other's."""
    pp, cp, mp = free_ports(3)

    def member(module):
        return MemberProc("x", str(tmp_path / "x"), pp, cp, mp,
                          f"x=http://127.0.0.1:{pp}", module=module,
                          device="cpu", log_dir=str(tmp_path))

    seen = {}
    for module in (first, then):
        p = member(module)
        p.start()
        try:
            p.wait_ready()
            if module == first:
                for i in range(20):
                    rc, _out, err = etcdctl(p.endpoint, "put", f"k{i:02d}",
                                            f"v{i}-{first}")
                    assert rc == 0, err
            rc, out, err = etcdctl(p.endpoint, "get", "k", "--prefix",
                                   timeout=90)
            assert rc == 0, err
            rc2, members, err = etcdctl(p.endpoint, "member", "list")
            assert rc2 == 0, err
            seen[module] = (out, members.split(",")[0])
        finally:
            p.stop()
    assert seen[first] == seen[then]
    assert seen[then][1] == f"{p.member_id:x}"
    assert seen[then][0].split()[:2] == ["k00", f"v0-{first}"]


def _bench(p, *args):
    r = subprocess.run(
        [sys.executable, "-m", "etcd_tpu_torch.tools.benchmark",
         "--endpoints", p.endpoint, "--clients", "4", *args],
        env=member_env("cpu"), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    m = re.search(r"Requests:\t(\d+) \(errors (\d+)\)", r.stdout)
    assert m and "p99:" in r.stdout, r.stdout
    return int(m.group(1)), int(m.group(2))


def test_benchmark_tool_against_both_packages(tmp_path):
    runs = (("--total", "80", "--val-size", "256", "put",
             "--sequential-keys"),
            ("--total", "40", "txn-put", "--txn-ops", "2"),
            ("--total", "24", "--key-space-size", "3", "stm"),
            ("--total", "40", "range", "000-", "001-", "--consistency-l"),
            ("--total", "40", "range", "000-", "001-"))
    got = {}
    for module in ("etcd_tpu_torch", "etcd_tpu"):
        pp, cp, mp = free_ports(3)
        p = MemberProc("b", str(tmp_path / module), pp, cp, mp,
                       f"b=http://127.0.0.1:{pp}", module=module,
                       device="cpu", log_dir=str(tmp_path))
        p.start()
        try:
            p.wait_ready()
            counts = [_bench(p, *run) for run in runs]
            got[module] = (counts, _all_kvs(p))
        finally:
            p.stop()
    assert got["etcd_tpu_torch"] == got["etcd_tpu"]
    counts, kvs = got["etcd_tpu_torch"]
    assert counts == [(80, 0), (40, 0), (24, 0), (40, 0), (40, 0)]
    assert kvs[b"000-0000"] == b"v" * 256 and len(kvs) == 4 + 80 + 3


def test_report_matches_the_reference():
    from etcd_tpu.pkg.report import Report as JReport
    from etcd_tpu_torch.pkg.report import Report as TReport

    durs = [0.001 * ((i * 37) % 101 + 1) for i in range(500)]
    stats = []
    for cls in (JReport, TReport):
        rep = cls()
        for i, d in enumerate(durs):
            rep.results(d, ValueError("x") if i % 50 == 0 else None)
        st = rep.stats().to_dict()
        st.pop("total_s"), st.pop("qps")
        stats.append(st)
    assert stats[0] == stats[1]
    assert stats[0]["errors"] == 10 and stats[0]["count"] == 490
