"""Service naming over the KV space: register endpoints under a prefix
and resolve/watch them (ref: client/v3/naming/endpoints/endpoints_impl.go
+ naming/resolver — the gRPC resolver is the reference's transport glue;
the registry semantics live here).

Ports ``etcd_tpu/client/naming.py``.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from .client import Client
from .util import prefix_end


class Endpoints:
    """Manager for `target/instance -> {"Addr", "Metadata"}` records."""

    def __init__(self, client: Client, target: str) -> None:
        self.c = client
        self.target = target.rstrip("/")

    def _key(self, instance: str) -> bytes:
        return f"{self.target}/{instance}".encode()

    def add(self, instance: str, addr: str,
            metadata: Optional[Dict] = None, lease: int = 0) -> None:
        rec = {"Addr": addr, "Metadata": metadata or {}}
        self.c.put(self._key(instance), json.dumps(rec).encode(), lease=lease)

    def delete(self, instance: str) -> None:
        self.c.delete(self._key(instance))

    def list(self) -> Dict[str, Dict]:
        pfx = (self.target + "/").encode()
        resp = self.c.get(pfx, prefix_end(pfx))
        out = {}
        for kv in resp.kvs:
            inst = kv.key[len(pfx):].decode("utf-8", "replace")
            try:
                out[inst] = json.loads(kv.value)
            except ValueError:
                continue
        return out

    def addresses(self) -> List[str]:
        return [r["Addr"] for r in self.list().values()]

    def watch(self):
        """WatchHandle over the prefix; callers diff add/delete events
        to keep a resolver's address list current."""
        pfx = (self.target + "/").encode()
        return self.c.watch(pfx, prefix_end(pfx))
