"""Embedding config (ref: server/embed/config.go:144-417 Config,
ConfigFromFile :535, Validate :656, ElectionTicks :875).

One dataclass, populated from flags (etcdmain/config.go) or a YAML file,
with the same knobs the reference exposes where they exist in this
build. URLs use the reference's "scheme://host:port" comma-list format.

Ports ``etcd_tpu/embed/config.py``.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import urlparse

DEFAULT_NAME = "default"
DEFAULT_LISTEN_PEER_URLS = "http://localhost:2380"
DEFAULT_LISTEN_CLIENT_URLS = "http://localhost:2379"
CLUSTER_STATE_NEW = "new"
CLUSTER_STATE_EXISTING = "existing"

# election timeout bounds (config.go:74 maxElectionMs, Validate checks
# 5*heartbeat <= election <= 50000ms).
MAX_ELECTION_MS = 50000


class ConfigError(Exception):
    pass


def parse_urls(s: str) -> List[Tuple[str, int]]:
    """"http://h1:p1,http://h2:p2" → [(h1, p1), ...]."""
    out: List[Tuple[str, int]] = []
    for part in s.split(","):
        part = part.strip()
        if not part:
            continue
        u = urlparse(part)
        if u.scheme not in ("http", "https", "unix", "unixs"):
            raise ConfigError(f"URL scheme must be http/https/unix: {part!r}")
        if u.hostname is None or u.port is None:
            raise ConfigError(f"URL must carry host:port: {part!r}")
        out.append((u.hostname, u.port))
    if not out:
        raise ConfigError(f"no URLs in {s!r}")
    return out


def member_id_from_urls(peer_urls: str, cluster_token: str) -> int:
    """Deterministic member ID: hash of sorted peer URLs + token
    (ref: server/etcdserver/api/membership/member.go computeMemberId)."""
    urls = sorted(u.strip() for u in peer_urls.split(",") if u.strip())
    h = hashlib.sha1(("".join(urls) + cluster_token).encode()).digest()
    mid = int.from_bytes(h[:8], "big") & 0x7FFFFFFFFFFFFFFF
    return mid or 1


@dataclass
class Config:
    name: str = DEFAULT_NAME
    data_dir: str = ""
    # URLs (comma-separated "scheme://host:port").
    listen_peer_urls: str = DEFAULT_LISTEN_PEER_URLS
    listen_client_urls: str = DEFAULT_LISTEN_CLIENT_URLS
    listen_metrics_urls: str = ""  # "" → no dedicated metrics listener
    initial_advertise_peer_urls: str = ""
    advertise_client_urls: str = ""
    # Clustering.
    initial_cluster: str = ""  # "name1=http://h:p,name2=..."
    initial_cluster_state: str = CLUSTER_STATE_NEW
    initial_cluster_token: str = "etcd-cluster"
    # v3 discovery bootstrap (ref: api/v3discovery): when set and no
    # initial-cluster is given, the roster comes from this cluster.
    discovery_endpoints: str = ""  # "host:port,host:port"
    discovery_token: str = ""
    # DNS SRV discovery (ref: --discovery-srv/--discovery-srv-name,
    # client/pkg/srv): when set and no initial-cluster is given, the
    # roster comes from _etcd-server._tcp.<domain> records.
    discovery_srv: str = ""
    discovery_srv_name: str = ""
    # Test/deployment seam: callable(name) -> [(host, port)].
    srv_resolver: Any = None
    # Raft timing (milliseconds, ref: config.go TickMs/ElectionMs).
    heartbeat_interval: int = 100
    election_timeout: int = 1000
    pre_vote: bool = True
    # Storage.
    snapshot_count: int = 100000
    quota_backend_bytes: int = 2 * 1024 * 1024 * 1024
    max_request_bytes: int = 1536 * 1024
    auto_compaction_mode: str = ""
    auto_compaction_retention: str = "0"
    # TLS (ref: embed/config.go ClientTLSInfo/PeerTLSInfo + --auto-tls).
    cert_file: str = ""
    key_file: str = ""
    trusted_ca_file: str = ""
    client_cert_auth: bool = False
    auto_tls: bool = False
    peer_cert_file: str = ""
    peer_key_file: str = ""
    peer_trusted_ca_file: str = ""
    peer_client_cert_auth: bool = False
    peer_auto_tls: bool = False
    # Corruption checking (ref: --experimental-initial-corrupt-check,
    # --experimental-corrupt-check-time).
    initial_corrupt_check: bool = False
    corrupt_check_time: float = 0.0  # seconds between periodic checks
    # Legacy v2 API (ref: --enable-v2) and the JSON gateway listener
    # (the reference serves grpc-gateway on the client listener; here
    # it gets its own HTTP port — never the metrics listener).
    enable_v2: bool = False
    listen_v2_urls: str = ""  # "" -> client host, ephemeral port
    listen_gateway_urls: str = ""  # "" -> gateway disabled
    # Ops.
    enable_pprof: bool = False
    log_level: str = "info"
    auth_token: str = "simple"  # "simple" | "hmac:<key>" | "jwt,sign-key=<k>[,sign-method=HS256][,ttl=5m]"
    strict_reconfig_check: bool = True

    # -- derived ---------------------------------------------------------------

    def validate(self) -> None:
        """ref: embed/config.go:656 Validate."""
        if not self.data_dir:
            raise ConfigError("data-dir is required")
        parse_urls(self.listen_peer_urls)
        parse_urls(self.listen_client_urls)
        if self.listen_metrics_urls:
            parse_urls(self.listen_metrics_urls)
        if self.initial_cluster_state not in (
            CLUSTER_STATE_NEW, CLUSTER_STATE_EXISTING,
        ):
            raise ConfigError(
                f"initial-cluster-state must be new|existing, "
                f"got {self.initial_cluster_state!r}"
            )
        if self.heartbeat_interval <= 0:
            raise ConfigError("heartbeat interval must be positive")
        if 5 * self.heartbeat_interval > self.election_timeout:
            raise ConfigError(
                "election timeout should be at least 5x the heartbeat interval"
            )
        if self.election_timeout > MAX_ELECTION_MS:
            raise ConfigError(
                f"election timeout exceeds maximum {MAX_ELECTION_MS}ms"
            )
        cluster = self.initial_cluster_map()
        if self.name not in cluster:
            raise ConfigError(
                f"member name {self.name!r} not in --initial-cluster "
                f"{sorted(cluster)}"
            )
        mode = self.auto_compaction_mode
        if mode not in ("", "periodic", "revision"):
            raise ConfigError(
                f"auto-compaction-mode must be periodic|revision, got {mode!r}"
            )
        for which, cert, key, auto in (
            ("client", self.cert_file, self.key_file, self.auto_tls),
            ("peer", self.peer_cert_file, self.peer_key_file,
             self.peer_auto_tls),
        ):
            if bool(cert) != bool(key):
                raise ConfigError(
                    f"{which} cert-file and key-file must be given together")
            if auto and cert:
                raise ConfigError(
                    f"{which} auto-tls is mutually exclusive with cert-file")
        for which, cc_auth, ca in (
            ("client", self.client_cert_auth, self.trusted_ca_file),
            ("peer", self.peer_client_cert_auth, self.peer_trusted_ca_file),
        ):
            if cc_auth and not ca:
                raise ConfigError(
                    f"{which} client-cert-auth requires trusted-ca-file "
                    f"(an empty trust store would reject every handshake)")

    def client_tls_info(self):
        """TLSInfo for the client channel, or None when insecure
        (ref: embed/config.go ClientSelfCert / ClientTLSInfo)."""
        return self._tls_info(
            self.cert_file, self.key_file, self.trusted_ca_file,
            self.client_cert_auth, self.auto_tls, "client-certs")

    def peer_tls_info(self):
        """TLSInfo for the peer channel, or None (PeerSelfCert)."""
        return self._tls_info(
            self.peer_cert_file, self.peer_key_file,
            self.peer_trusted_ca_file, self.peer_client_cert_auth,
            self.peer_auto_tls, "peer-certs")

    def _tls_info(self, cert, key, ca, cc_auth, auto, subdir):
        from ..pkg.tlsutil import TLSInfo, self_cert

        if auto:
            import os

            hosts = sorted({
                u[0] for u in parse_urls(self.listen_peer_urls)
            } | {u[0] for u in parse_urls(self.listen_client_urls)} | {
                "127.0.0.1", "localhost"})
            info = self_cert(os.path.join(self.data_dir, "fixtures", subdir),
                             hosts=hosts)
            info.client_cert_auth = cc_auth
            return info
        if not cert:
            return None
        return TLSInfo(cert_file=cert, key_file=key, trusted_ca_file=ca,
                       client_cert_auth=cc_auth)

    def initial_cluster_map(self) -> Dict[str, str]:
        """"n1=u1,n2=u2" → {name: peer_urls} (multiple URLs per name keep
        the reference's repeated-name merge semantics)."""
        if not self.initial_cluster:
            return {self.name: self.effective_advertise_peer_urls()}
        out: Dict[str, str] = {}
        for part in self.initial_cluster.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ConfigError(f"bad initial-cluster entry {part!r}")
            nm, url = part.split("=", 1)
            if nm in out:
                out[nm] += "," + url
            else:
                out[nm] = url
        return out

    def effective_advertise_peer_urls(self) -> str:
        return self.initial_advertise_peer_urls or self.listen_peer_urls

    def effective_advertise_client_urls(self) -> str:
        return self.advertise_client_urls or self.listen_client_urls

    def member_id(self) -> int:
        return member_id_from_urls(
            self.initial_cluster_map()[self.name], self.initial_cluster_token
        )

    def election_ticks(self) -> int:
        """ref: embed/config.go:875 ElectionTicks."""
        return self.election_timeout // self.heartbeat_interval

    def tick_interval(self) -> float:
        return self.heartbeat_interval / 1000.0

    def auto_compaction_retention_value(self) -> float:
        """periodic: hours (or Go-duration string); revision: count."""
        s = str(self.auto_compaction_retention)
        for suffix, mult in (("ms", 1 / 3600e3), ("s", 1 / 3600.0),
                             ("m", 1 / 60.0), ("h", 1.0)):
            if s.endswith(suffix):
                return float(s[: -len(suffix)]) * (
                    mult if self.auto_compaction_mode == "periodic" else 1
                )
        return float(s)


def config_from_file(path: str) -> Config:
    """ref: embed/config.go:535 ConfigFromFile — YAML keys use the flag
    names (dashes)."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    cfg = Config()
    keymap = {f.replace("_", "-"): f for f in cfg.__dataclass_fields__}
    for k, v in raw.items():
        attr = keymap.get(k)
        if attr is None:
            raise ConfigError(f"unknown config key {k!r}")
        setattr(cfg, attr, v)
    return cfg
