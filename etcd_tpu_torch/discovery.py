"""Cluster bootstrap discovery via an existing v3 cluster
(ref: server/etcdserver/api/v3discovery/discovery.go — members
self-register under a token prefix on the discovery cluster, wait for
cluster-size registrations, then derive --initial-cluster).

Keyspace on the discovery cluster:
``/_etcd/registry/<token>/_config/size`` (expected member count) and
``/_etcd/registry/<token>/members/<name>`` → peer URL.

Ports ``etcd_tpu/discovery.py``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from .client.client import Client
from .client.util import prefix_end


class DiscoveryError(Exception):
    pass


def _registry(token: str) -> bytes:
    return f"/_etcd/registry/{token}".encode()


def setup_token(endpoints: List[Tuple[str, int]], token: str,
                size: int) -> None:
    """Operator step: create the token with the expected cluster size
    (discovery.go expects size pre-set by `etcdctl put`)."""
    c = Client(endpoints)
    try:
        c.put(_registry(token) + b"/_config/size", str(size).encode())
    finally:
        c.close()


def join_cluster(endpoints: List[Tuple[str, int]], token: str,
                 name: str, peer_url: str,
                 timeout: float = 60.0) -> str:
    """Register and wait for the full roster; returns the
    initial-cluster string (discovery.go JoinCluster →
    checkCluster/registerSelf/waitNodes)."""
    c = Client(endpoints)
    try:
        reg = _registry(token)
        size_resp = c.get(reg + b"/_config/size")
        if not size_resp.kvs:
            raise DiscoveryError(
                f"discovery token {token!r} not set up (no _config/size)"
            )
        size = int(size_resp.kvs[0].value)

        members_pfx = reg + b"/members/"
        # First-come registration: create-if-absent so a re-joining
        # member keeps its slot and latecomers beyond size are rejected.
        from .server import api as sapi

        my_key = members_pfx + name.encode()
        c.txn(sapi.TxnRequest(
            compare=[sapi.Compare(
                target=sapi.CompareTarget.CREATE,
                result=sapi.CompareResult.EQUAL,
                key=my_key, create_revision=0,
            )],
            success=[sapi.RequestOp(request_put=sapi.PutRequest(
                key=my_key, value=peer_url.encode(),
            ))],
        ))

        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            resp = c.get(members_pfx, prefix_end(members_pfx),
                         sort_order=sapi.SortOrder.ASCEND)
            roster: Dict[str, str] = {}
            for kv in resp.kvs[:size]:  # first `size` registrants win
                roster[kv.key[len(members_pfx):].decode()] = kv.value.decode()
            if name not in roster and len(resp.kvs) >= size:
                raise DiscoveryError(
                    f"cluster is full ({size} members registered first)"
                )
            if len(roster) >= size:
                return ",".join(
                    f"{nm}={url}" for nm, url in sorted(roster.items())
                )
            time.sleep(0.2)
        raise DiscoveryError("timed out waiting for cluster roster")
    finally:
        c.close()
