"""Load generator (ref: tools/benchmark/cmd/{put,range,txn_put,
txn_mixed,stm,watch,watch_get,lease}.go — QPS + latency percentiles via
pkg/report).

`python -m etcd_tpu_torch.tools.benchmark <cmd> --endpoints ... --total N
--clients C`; each worker owns a connection, results aggregate into one
report (report.go percentiles p50/p90/p95/p99/p99.9).

Ports ``etcd_tpu/tools/benchmark.py``.
"""

from __future__ import annotations

import argparse
import random
import sys
import threading
import time
from typing import List, Optional, Tuple

from ..client.client import Client
from ..client.concurrency import STM
from ..pkg.report import Report
from ..server import api as sapi


def _parse_endpoints(s: str) -> List[Tuple[str, int]]:
    out = []
    for part in s.split(","):
        part = part.strip()
        if "://" in part:
            part = part.split("://", 1)[1]
        host, port = part.rsplit(":", 1)
        out.append((host, int(port)))
    return out


def _run_workers(args, work) -> Report:
    """Spawn args.clients workers; `work(client, rep, worker_idx, i)`
    runs for each of the worker's share of args.total operations."""
    rep = Report()
    eps = _parse_endpoints(args.endpoints)
    per = args.total // args.clients

    def worker(idx: int) -> None:
        c = Client(eps, request_timeout=args.timeout)
        try:
            for i in range(per):
                try:
                    rep.timed(work, c, idx, i)
                except Exception:  # noqa: BLE001 — recorded by timed
                    pass
        finally:
            c.close()

    threads = [
        threading.Thread(target=worker, args=(i,)) for i in range(args.clients)
    ]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    rep.wall = time.monotonic() - t0  # type: ignore[attr-defined]
    return rep


def bench_put(args) -> Report:
    rng = random.Random(0)
    val = b"v" * args.val_size

    def work(c: Client, idx: int, i: int) -> None:
        if args.sequential_keys:
            key = f"{idx:03d}-{i:010d}"
        else:
            key = f"{rng.randrange(args.key_space_size):0{args.key_size}d}"
        c.put(key.encode()[: args.key_size].ljust(args.key_size, b"0"), val)

    return _run_workers(args, work)


def bench_range(args) -> Report:
    key = args.key.encode()
    end = args.end.encode() if args.end else None

    def work(c: Client, idx: int, i: int) -> None:
        c.get(key, end, serializable=not args.consistency_l)

    return _run_workers(args, work)


def bench_txn_put(args) -> Report:
    val = b"v" * args.val_size

    def work(c: Client, idx: int, i: int) -> None:
        ops = [
            sapi.RequestOp(request_put=sapi.PutRequest(
                key=f"{idx}-{i}-{j}".encode(), value=val,
            ))
            for j in range(args.txn_ops)
        ]
        c.txn(sapi.TxnRequest(success=ops))

    return _run_workers(args, work)


def bench_txn_mixed(args) -> Report:
    val = b"v" * args.val_size
    rng = random.Random(1)

    def work(c: Client, idx: int, i: int) -> None:
        key = f"{rng.randrange(args.key_space_size)}".encode()
        if rng.random() < args.read_ratio:
            c.txn(sapi.TxnRequest(success=[
                sapi.RequestOp(request_range=sapi.RangeRequest(key=key))
            ]))
        else:
            c.txn(sapi.TxnRequest(success=[
                sapi.RequestOp(request_put=sapi.PutRequest(key=key, value=val))
            ]))

    return _run_workers(args, work)


def bench_stm(args) -> Report:
    """Transactional read-modify-write loops (cmd/stm.go)."""
    def work(c: Client, idx: int, i: int) -> None:
        stm = STM(c)

        def apply(txn) -> None:
            k = f"stm-{i % args.key_space_size}".encode()
            cur = txn.get(k)
            txn.put(k, (cur or b"0")[:8] + b"+")

        stm.run(apply)

    return _run_workers(args, work)


def bench_watch(args) -> Report:
    """Watch event delivery throughput (cmd/watch.go: watchers on a
    keyspace, publishers hammering it; measures event latency)."""
    eps = _parse_endpoints(args.endpoints)
    rep = Report()
    watcher_client = Client(eps, request_timeout=args.timeout)
    handles = [
        watcher_client.watch(f"w{j % args.key_space_size}".encode())
        for j in range(args.watchers)
    ]
    stamps = {}
    done = threading.Event()

    def drain() -> None:
        got_n = 0
        while got_n < args.total and not done.wait(0):
            for h in handles:
                got = h.get(timeout=0.05)
                if got is None:
                    continue
                _, events = got
                for ev in events:
                    t0 = stamps.get(ev.kv.value)
                    if t0 is not None:
                        rep.results(time.monotonic() - t0)
                    got_n += 1
                    if got_n >= args.total:
                        return

    dt = threading.Thread(target=drain)
    dt.start()
    pub = Client(eps, request_timeout=args.timeout)
    for i in range(args.total):
        v = f"{i}".encode()
        stamps[v] = time.monotonic()
        pub.put(f"w{i % args.key_space_size}".encode(), v)
    dt.join(timeout=30)
    done.set()
    for h in handles:
        h.cancel()
    pub.close()
    watcher_client.close()
    return rep


def bench_lease_keepalive(args) -> Report:
    def work(c: Client, idx: int, i: int) -> None:
        if i == 0:
            resp = c.lease_grant(ttl=60)
            setattr(c, "_bench_lease", resp.id)
        c.lease_keep_alive_once(getattr(c, "_bench_lease"))

    return _run_workers(args, work)


def bench_mvcc_put(args) -> Report:
    """Raw storage-path put throughput: in-proc store, no server
    (cmd/mvcc_put.go benches the mvcc layer directly)."""
    import tempfile

    from ..storage import backend as bk
    from ..storage.mvcc.kvstore import KVStore

    rep = Report()
    with tempfile.TemporaryDirectory() as td:
        be = bk.open_backend(td + "/db")
        kv = KVStore(be)
        val = b"v" * args.val_size
        for i in range(args.total):
            t0 = time.monotonic()
            kv.put(f"{i % args.key_space_size}".encode(), val)
            rep.results(time.monotonic() - t0)
        be.close()
    return rep


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="benchmark")
    p.add_argument("--endpoints", default="127.0.0.1:2379")
    p.add_argument("--clients", type=int, default=10)
    p.add_argument("--total", type=int, default=1000)
    p.add_argument("--timeout", type=float, default=30.0)
    p.add_argument("--val-size", type=int, default=8)
    p.add_argument("--key-size", type=int, default=8)
    p.add_argument("--key-space-size", type=int, default=1000)
    sub = p.add_subparsers(dest="cmd")

    x = sub.add_parser("put")
    x.add_argument("--sequential-keys", action="store_true")
    x = sub.add_parser("range")
    x.add_argument("key")
    x.add_argument("end", nargs="?", default="")
    x.add_argument("--consistency-l", action="store_true")
    x = sub.add_parser("txn-put")
    x.add_argument("--txn-ops", type=int, default=4)
    x = sub.add_parser("txn-mixed")
    x.add_argument("--read-ratio", type=float, default=0.5)
    sub.add_parser("stm")
    x = sub.add_parser("watch")
    x.add_argument("--watchers", type=int, default=10)
    sub.add_parser("lease-keepalive")
    sub.add_parser("mvcc-put")

    args = p.parse_args(argv)
    fns = {
        "put": bench_put, "range": bench_range, "txn-put": bench_txn_put,
        "txn-mixed": bench_txn_mixed, "stm": bench_stm,
        "watch": bench_watch, "lease-keepalive": bench_lease_keepalive,
        "mvcc-put": bench_mvcc_put,
    }
    if args.cmd not in fns:
        p.print_help()
        return 2
    rep = fns[args.cmd](args)
    print(rep.render())
    return 0


if __name__ == "__main__":
    sys.exit(main())
