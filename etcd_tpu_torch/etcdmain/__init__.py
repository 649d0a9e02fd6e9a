"""CLI entry (ref: server/etcdmain/main.go:25 Main, etcd.go:53
startEtcdOrProxyV2, gateway.go, config.go flag set).

Subcommands:

* (default) / ``etcd``   — start a member from flags or --config-file
* ``gateway start``      — the L4 TCP forwarder (etcdmain/gateway.go)
* ``grpc-proxy start``   — the caching/coalescing L7 proxy

``python -m etcd_tpu_torch`` lands here.

Ports ``etcd_tpu/etcdmain/__init__.py``, with these differences:

* ``--raft-backend`` (``tpu``, the default, or ``host``) and ``--device``
  (default: the GPU; ``cpu`` runs the plain PyTorch forms) reach
  ``embed.Config``;
* an orderly stop writes one ``kernel launches:`` line
  (``launches_line``): the member's node rounds and its launches of each
  kernel and form since boot; SIGHUP writes one more, and the member runs
  on;
* the names it prints are the port's.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading
from typing import List, Optional

from .. import version as ver
from ..embed import Config, config_from_file, start_etcd
from ..embed.config import ConfigError, parse_urls


def _add_member_flags(p: argparse.ArgumentParser) -> None:
    cfg = Config()
    p.add_argument("--name", default=cfg.name)
    p.add_argument("--data-dir", default="")
    p.add_argument("--listen-peer-urls", default=cfg.listen_peer_urls)
    p.add_argument("--listen-client-urls", default=cfg.listen_client_urls)
    p.add_argument("--listen-metrics-urls", default="")
    p.add_argument("--initial-advertise-peer-urls", default="")
    p.add_argument("--advertise-client-urls", default="")
    p.add_argument("--initial-cluster", default="")
    p.add_argument("--initial-cluster-state", default=cfg.initial_cluster_state)
    p.add_argument("--initial-cluster-token", default=cfg.initial_cluster_token)
    p.add_argument("--heartbeat-interval", type=int, default=cfg.heartbeat_interval)
    p.add_argument("--election-timeout", type=int, default=cfg.election_timeout)
    p.add_argument("--snapshot-count", type=int, default=cfg.snapshot_count)
    p.add_argument("--quota-backend-bytes", type=int, default=cfg.quota_backend_bytes)
    p.add_argument("--max-request-bytes", type=int, default=cfg.max_request_bytes)
    p.add_argument("--auto-compaction-mode", default="")
    p.add_argument("--auto-compaction-retention", default="0")
    p.add_argument("--auth-token", default=cfg.auth_token)
    p.add_argument("--initial-corrupt-check", action="store_true")
    p.add_argument("--corrupt-check-time", type=float, default=0.0)
    p.add_argument("--cert-file", default="")
    p.add_argument("--key-file", default="")
    p.add_argument("--trusted-ca-file", default="")
    p.add_argument("--client-cert-auth", action="store_true")
    p.add_argument("--auto-tls", action="store_true")
    p.add_argument("--peer-cert-file", default="")
    p.add_argument("--peer-key-file", default="")
    p.add_argument("--peer-trusted-ca-file", default="")
    p.add_argument("--peer-client-cert-auth", action="store_true")
    p.add_argument("--peer-auto-tls", action="store_true")
    p.add_argument("--discovery-endpoints", default="")
    p.add_argument("--discovery-srv", default="")
    p.add_argument("--enable-v2", action="store_true")
    p.add_argument("--listen-v2-urls", default="")
    p.add_argument("--listen-gateway-urls", default="")
    p.add_argument("--discovery-srv-name", default="")
    p.add_argument("--discovery-token", default="")
    p.add_argument("--log-level", default=cfg.log_level)
    p.add_argument("--enable-pprof", action="store_true")
    p.add_argument("--config-file", default="")
    p.add_argument("--raft-backend", default=cfg.raft_backend,
                   choices=("tpu", "host"))
    p.add_argument("--device", default=None,
                   help="torch device of the batched round (default: "
                        "the GPU; without CUDA the member exits before it "
                        "touches --data-dir)")


def _config_from_args(args: argparse.Namespace) -> Config:
    if args.config_file:
        return config_from_file(args.config_file)
    cfg = Config()
    for f in cfg.__dataclass_fields__:
        if hasattr(args, f):
            setattr(cfg, f, getattr(args, f))
    if not cfg.initial_cluster and not cfg.discovery_token \
            and not cfg.discovery_srv:
        cfg.initial_cluster = (
            f"{cfg.name}={cfg.effective_advertise_peer_urls()}"
        )
    return cfg


def _run_etcd(args: argparse.Namespace) -> int:
    # Debug hook standing in for Go's SIGQUIT goroutine dump: SIGUSR1
    # writes every thread's stack to stderr (the e2e harness and a
    # human operator use it to diagnose a wedged member in place).
    import faulthandler

    faulthandler.register(signal.SIGUSR1, file=sys.stderr)
    try:
        cfg = _config_from_args(args)
        e = start_etcd(cfg)
    except ConfigError as err:
        print(f"error: {err}", file=sys.stderr)
        return 1

    def _dump_lessor(signum, frame):
        try:
            les = e.server.lessor
            with les._lock:
                lines = [
                    f"  lease {l.id:x} ttl={l.ttl} rem_ttl={l.remaining_ttl} "
                    f"remaining={l.remaining():.1f} "
                    f"queued={l.id in les.expired_queue} "
                    f"pending={l.id in les._expired_pending}"
                    for l in les.lease_map.values()
                ]
                print(
                    f"LESSOR primary={les._primary} "
                    f"n={len(les.lease_map)}\n" + "\n".join(lines),
                    file=sys.stderr, flush=True,
                )
        except Exception as exc:  # noqa: BLE001 — diagnostics only
            print(f"LESSOR dump failed: {exc!r}", file=sys.stderr, flush=True)

    signal.signal(signal.SIGUSR2, _dump_lessor)
    signal.signal(signal.SIGHUP,
                  lambda *_: print(launches_line(e, "signal"), flush=True))
    ch, cp = e.client_addr
    mh, mp = e.metrics_addr
    print(
        f"etcd_tpu_torch member {cfg.name} ({e.server.id:x}) serving: "
        f"clients http://{ch}:{cp}, metrics http://{mh}:{mp}",
        flush=True,
    )
    stop = threading.Event()

    def on_signal(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)
    try:
        while not stop.is_set() and not e.server._stopped.is_set():
            stop.wait(0.2)
    finally:
        e.close()
    print(launches_line(e), flush=True)
    return 0


def launches_line(e, at: str = "stop") -> str:
    """The member's node rounds and its launches of each kernel and form
    since boot, as one line (hosting_proc's LAUNCHES_PREFIX); 0 rounds
    on the host backend, and 0 launches on the CPU, where the plain
    forms run. `at` says when it was written: "stop" at an orderly stop,
    "signal" on SIGHUP (the counts so far, the member running on)."""
    import json

    from ..batched.hopper_kernels import FORM_LAUNCHES, LAUNCHES
    from ..batched.hosting_proc import LAUNCHES_PREFIX

    return LAUNCHES_PREFIX + json.dumps({
        "member": f"{e.server.id:x}", "at": at,
        "rounds": int(getattr(e.server.node, "rounds", 0)),
        "launches": dict(LAUNCHES), "forms": dict(FORM_LAUNCHES)})


def _run_gateway(args: argparse.Namespace) -> int:
    from ..proxy.tcpproxy import TCPProxy

    eps = parse_urls(
        ",".join(
            x if "://" in x else f"http://{x}"
            for x in args.endpoints.split(",")
        )
    )
    host, port = args.listen_addr.rsplit(":", 1)
    proxy = TCPProxy(eps, bind=(host, int(port)),
                     monitor_interval=args.retry_delay)
    print(
        f"tcpproxy: ready to proxy client requests to {eps}", flush=True
    )
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    try:
        while not stop.is_set():
            stop.wait(0.2)
    finally:
        proxy.stop()
    return 0


def _run_grpc_proxy(args: argparse.Namespace) -> int:
    from ..proxy.grpcproxy import start_grpc_proxy

    eps = []
    for x in args.endpoints.split(","):
        if "://" not in x:
            x = f"http://{x}"
        eps.extend(parse_urls(x))
    host, port = args.listen_addr.rsplit(":", 1)
    proxy = start_grpc_proxy(eps, bind=(host, int(port)))
    print(f"grpcproxy: listening on {proxy.addr}", flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    try:
        while not stop.is_set():
            stop.wait(0.2)
    finally:
        proxy.stop()
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(
        prog="etcd_tpu_torch", description="etcd-capability TPU-native framework"
    )
    parser.add_argument("--version", action="store_true")
    sub = parser.add_subparsers(dest="cmd")

    p_etcd = sub.add_parser("etcd", help="start a member")
    _add_member_flags(p_etcd)

    p_gw = sub.add_parser("gateway", help="L4 gateway")
    gw_sub = p_gw.add_subparsers(dest="gw_cmd")
    p_gw_start = gw_sub.add_parser("start")
    p_gw_start.add_argument("--listen-addr", default="127.0.0.1:23790")
    p_gw_start.add_argument("--endpoints", default="127.0.0.1:2379")
    p_gw_start.add_argument("--retry-delay", type=float, default=60.0)

    p_gp = sub.add_parser("grpc-proxy", help="L7 caching/coalescing proxy")
    gp_sub = p_gp.add_subparsers(dest="gp_cmd")
    p_gp_start = gp_sub.add_parser("start")
    p_gp_start.add_argument("--listen-addr", default="127.0.0.1:23790")
    p_gp_start.add_argument("--endpoints", default="127.0.0.1:2379")

    # Bare flags (no subcommand) start a member, like `etcd --...`.
    if not argv or argv[0].startswith("-"):
        if "--version" in argv:
            print(f"etcd_tpu_torch Version: {ver.SERVER_VERSION}")
            print(f"Cluster Version: {ver.CLUSTER_VERSION}")
            print(f"API Version: {ver.API_VERSION}")
            return 0
        argv = ["etcd"] + argv

    args = parser.parse_args(argv)
    if args.cmd == "etcd":
        return _run_etcd(args)
    if args.cmd == "gateway":
        if getattr(args, "gw_cmd", None) != "start":
            p_gw.print_help()
            return 2
        return _run_gateway(args)
    if args.cmd == "grpc-proxy":
        if getattr(args, "gp_cmd", None) != "start":
            p_gp.print_help()
            return 2
        return _run_grpc_proxy(args)
    parser.print_help()
    return 2
