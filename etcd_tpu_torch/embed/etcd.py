"""StartEtcd: config → running member (ref: embed/etcd.go:93 StartEtcd;
configurePeerListeners :486; serveClients :693; serveMetrics :731).

Wires, in the reference's order: peer transport (listener first so
peers can connect during boot), EtcdServer (bootstrap: snapshot → WAL
replay → raft), then client RPC + metrics/health HTTP serving.

Ports ``etcd_tpu/embed/etcd.py``. Where the reference builds a server that
runs the scalar core, this one passes ``Config.raft_backend`` and the
device on, and resolves the device first, before the data dir is read.
It gives the node one replica slot more than the initial cluster has
peers, so that a leader that a member's configuration does not name yet
always finds a slot there (ROADMAP C20).
"""

from __future__ import annotations

import socket
import threading
from typing import Dict, List, Optional, Tuple

from ..etcdhttp import EtcdHTTP
from ..server import EtcdServer, ServerConfig
from ..server.corrupt import transport_peer_fetcher
from ..transport.tcp import TCPTransport
from ..v3rpc.service import V3RPCServer
from .config import (
    CLUSTER_STATE_EXISTING,
    Config,
    ConfigError,
    member_id_from_urls,
    parse_urls,
)


class Etcd:
    """A running embedded member (ref: embed.Etcd struct)."""

    def __init__(self, cfg: Config) -> None:
        self.config = cfg
        self.server: Optional[EtcdServer] = None
        self.transport: Optional[TCPTransport] = None
        self.rpc: Optional[V3RPCServer] = None
        self.http: Optional[EtcdHTTP] = None
        self.v2http = None  # legacy /v2/keys listener (v2http.V2HTTP)
        self.gateway = None  # JSON gateway listener (EtcdHTTP)
        self._closed = threading.Event()

    # Addresses, resolved after bind (port 0 supported for tests).
    @property
    def client_addr(self) -> Tuple[str, int]:
        assert self.rpc is not None
        return self.rpc.addr

    @property
    def peer_addr(self) -> Tuple[str, int]:
        assert self.transport is not None
        return self.transport.addr

    @property
    def metrics_addr(self) -> Tuple[str, int]:
        assert self.http is not None
        return self.http.addr

    def close(self) -> None:
        """ref: embed/etcd.go Close — stop serving, then the server."""
        if self._closed.is_set():
            return
        self._closed.set()
        if self.v2http is not None:
            self.v2http.close()
        if self.gateway is not None:
            self.gateway.close()
        if self.http is not None:
            self.http.close()
        if self.rpc is not None:
            self.rpc.stop()
        if self.server is not None:
            self.server.stop()
        if self.transport is not None:
            self.transport.stop()


def start_etcd(cfg: Config) -> Etcd:
    """ref: embed/etcd.go:93 StartEtcd."""
    cfg.validate()
    import os

    device = None
    if cfg.raft_backend == "tpu":
        # Before any file is touched: no GPU and no device named raises.
        from ..batched.state import resolve_device

        device = resolve_device(cfg.device)
    if os.environ.get("ETCD_VERIFY") == "all" and os.path.isdir(cfg.data_dir):
        # Data-dir invariants checked before boot when enabled
        # (ref: server/verify/verify.go VerifyIfEnabled, ETCD_VERIFY env).
        from ..etcdutl import verify as _verify

        if not _verify(cfg.data_dir):
            raise RuntimeError(f"ETCD_VERIFY failed for {cfg.data_dir}")
    e = Etcd(cfg)

    if cfg.discovery_srv and not cfg.initial_cluster:
        # DNS SRV discovery (ref: etcdmain/etcd.go → srv.GetCluster):
        # the record matching our advertised peer URL is us.
        from ..client.srv import get_cluster

        peer_tls = bool(cfg.peer_cert_file or cfg.peer_auto_tls)
        service = "etcd-server-ssl" if peer_tls else "etcd-server"
        mine = {u.strip() for u in
                cfg.effective_advertise_peer_urls().split(",")}
        parts = []
        for entry in get_cluster(service, cfg.discovery_srv_name,
                                 cfg.name, cfg.discovery_srv,
                                 resolver=cfg.srv_resolver):
            nm, _, url = entry.partition("=")
            parts.append(f"{cfg.name}={url}" if url in mine else entry)
        cfg.initial_cluster = ",".join(parts)

    if cfg.discovery_endpoints and cfg.discovery_token and not cfg.initial_cluster:
        # v3 discovery: register with the discovery cluster and wait
        # for the roster (bootstrap.go discovery path).
        from ..discovery import join_cluster

        eps = []
        for part in cfg.discovery_endpoints.split(","):
            host, port = part.strip().rsplit(":", 1)
            eps.append((host, int(port)))
        cfg.initial_cluster = join_cluster(
            eps, cfg.discovery_token, cfg.name,
            cfg.effective_advertise_peer_urls(),
        )

    cluster = cfg.initial_cluster_map()  # name -> peer urls
    ids: Dict[str, int] = {
        nm: member_id_from_urls(urls, cfg.initial_cluster_token)
        for nm, urls in cluster.items()
    }
    my_id = ids[cfg.name]
    cluster_id = member_id_from_urls(
        ",".join(sorted(cluster.values())), cfg.initial_cluster_token
    )

    peer_bind = parse_urls(cfg.listen_peer_urls)[0]
    transport = TCPTransport(
        member_id=my_id, cluster_id=cluster_id, bind=peer_bind,
        tls_info=cfg.peer_tls_info(),
    )
    e.transport = transport
    for nm, urls in cluster.items():
        if nm == cfg.name:
            continue
        transport.add_peer(ids[nm], parse_urls(urls)[0])

    scfg = ServerConfig(
        member_id=my_id,
        cluster_id=cluster_id,
        peers=sorted(ids.values()),
        data_dir=cfg.data_dir,
        network=transport,
        join=cfg.initial_cluster_state == CLUSTER_STATE_EXISTING,
        snapshot_count=cfg.snapshot_count,
        quota_bytes=cfg.quota_backend_bytes,
        tick_interval=cfg.tick_interval(),
        election_tick=cfg.election_ticks(),
        heartbeat_tick=1,
        auto_compaction_mode=cfg.auto_compaction_mode,
        auto_compaction_retention=(
            cfg.auto_compaction_retention_value()
            if cfg.auto_compaction_mode else 0.0
        ),
        pre_vote=cfg.pre_vote,
        max_request_bytes=cfg.max_request_bytes,
        auth_token=cfg.auth_token,
        peer_hash_fetcher=transport_peer_fetcher(transport),
        initial_corrupt_check=cfg.initial_corrupt_check,
        corrupt_check_time=cfg.corrupt_check_time,
        client_tls_info=cfg.client_tls_info(),
        raft_backend=cfg.raft_backend,
        device=device,
        # One spare device slot: a leader that this member's
        # configuration does not name yet (an add it has not applied)
        # always finds one (ROADMAP C20).
        replica_capacity=len(ids) + 1,
    )
    try:
        server = EtcdServer(scfg)
        e.server = server
        transport.set_raft_reporter(server.node)
        transport.set_hash_provider(lambda: server.hash_kv(0))

        client_bind = parse_urls(cfg.listen_client_urls)[0]
        e.rpc = V3RPCServer(server, bind=client_bind,
                            tls_info=cfg.client_tls_info())
        # Publish this member's serving address cluster-wide (ref:
        # server.go publishV3). Advertise flags win; otherwise the
        # actually-bound listener address (covers port-0 test configs),
        # with a wildcard bind host swapped for a routable one — a
        # published 0.0.0.0 would make peers' forwards dial themselves.
        scheme = "https" if cfg.client_tls_info() else "http"
        if cfg.advertise_client_urls:
            adv = cfg.advertise_client_urls
        else:
            host, port = e.rpc.addr[0], e.rpc.addr[1]
            if host in ("0.0.0.0", "::"):
                try:
                    host = socket.gethostbyname(socket.gethostname())
                except OSError:
                    host = "127.0.0.1"
            adv = f"{scheme}://{host}:{port}"
        server.publish(cfg.name, [u.strip() for u in adv.split(",")])

        if cfg.enable_v2:
            # Legacy /v2/keys listener (ref: --enable-v2; the reference
            # multiplexes it on the client listener via cmux).
            from ..v2http import V2HTTP

            v2_bind = (parse_urls(cfg.listen_v2_urls)[0]
                       if cfg.listen_v2_urls else (client_bind[0], 0))
            e.v2http = V2HTTP(server, bind=v2_bind)

        if cfg.listen_gateway_urls:
            # grpc-gateway JSON interop on its own listener — NEVER on
            # the metrics listener (it carries writes).
            gw_bind = parse_urls(cfg.listen_gateway_urls)[0]
            e.gateway = EtcdHTTP(server=server, bind=gw_bind,
                                 serve_gateway=True)

        if cfg.listen_metrics_urls:
            metrics_bind = parse_urls(cfg.listen_metrics_urls)[0]
            e.http = EtcdHTTP(server=server, bind=metrics_bind)
        else:
            # Default: health+metrics on an ephemeral port next to the
            # client listener (the reference multiplexes them on the
            # client listener via cmux; framed RPC and HTTP stay
            # separate here).
            e.http = EtcdHTTP(server=server, bind=(client_bind[0], 0))
    except Exception:
        e.close()  # stops whatever came up, including the transport
        raise
    return e
