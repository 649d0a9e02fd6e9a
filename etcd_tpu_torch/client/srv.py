"""DNS SRV discovery (ref: client/pkg/srv/srv.go — GetCluster resolves
_etcd-server[-ssl]._tcp.<domain> into an initial-cluster string,
GetClient resolves _etcd-client[-ssl]._tcp.<domain> into endpoints).

Resolution is pluggable: the default resolver uses ``dns.resolver``
when the dnspython package is present and raises a clear error
otherwise — stdlib Python cannot issue SRV queries. Tests (and
air-gapped deployments) inject a resolver callable returning
[(target_host, port), ...].

Ports ``etcd_tpu/client/srv.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

# resolver(service_name) -> [(host, port)], e.g. for
# "_etcd-server._tcp.example.com"
SRVResolver = Callable[[str], List[Tuple[str, int]]]


class SRVLookupError(Exception):
    pass


def default_resolver(name: str) -> List[Tuple[str, int]]:
    try:
        import dns.resolver  # type: ignore[import-not-found]
    except ImportError as e:
        raise SRVLookupError(
            "SRV discovery needs the dnspython package (or an injected "
            "resolver)") from e
    try:
        answers = dns.resolver.resolve(name, "SRV")
    except Exception as e:  # noqa: BLE001 — NXDOMAIN etc.
        raise SRVLookupError(f"SRV lookup {name!r} failed: {e}") from e
    return [(str(rr.target).rstrip("."), int(rr.port)) for rr in answers]


@dataclass
class SRVClients:
    """ref: srv.go SRVClients."""

    endpoints: List[str] = field(default_factory=list)


def get_cluster(service: str, service_name: str, name: str, domain: str,
                resolver: Optional[SRVResolver] = None) -> List[str]:
    """Build the --initial-cluster list from SRV records
    (ref: srv.go:33-94 GetCluster). ``service`` is "etcd-server" or
    "etcd-server-ssl"; each SRV target becomes
    "<n>=<scheme>://host:port" with generated names for peers other
    than ``name``."""
    resolver = resolver or default_resolver
    scheme = "https" if service.endswith("-ssl") else "http"
    srv_name = f"_{service}._tcp.{domain}"
    if service_name:
        srv_name = f"_{service}-{service_name}._tcp.{domain}"
    # Names are positional; the CALLER renames its own entry by
    # matching its advertised peer URL (srv.go does the same — name
    # inference from hosts is ambiguous, e.g. infra1 vs infra10).
    out: List[str] = []
    for n, (host, port) in enumerate(resolver(srv_name)):
        out.append(f"{n}={scheme}://{host}:{port}")
    if not out:
        raise SRVLookupError(f"no SRV records for {srv_name!r}")
    return out


def get_client(service: str, domain: str, service_name: str = "",
               resolver: Optional[SRVResolver] = None) -> SRVClients:
    """Client endpoints from SRV (ref: srv.go:96-141 GetClient):
    "etcd-client" / "etcd-client-ssl"."""
    resolver = resolver or default_resolver
    scheme = "https" if service.endswith("-ssl") else "http"
    srv_name = f"_{service}._tcp.{domain}"
    if service_name:
        srv_name = f"_{service}-{service_name}._tcp.{domain}"
    eps = [f"{scheme}://{host}:{port}" for host, port in resolver(srv_name)]
    if not eps:
        raise SRVLookupError(f"no SRV records for {srv_name!r}")
    return SRVClients(endpoints=eps)
