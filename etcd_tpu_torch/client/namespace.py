"""Key-prefix namespacing (ref: client/v3/namespace/ — kv.go, watch.go:
every outgoing key/range_end gains the prefix, every returned key loses
it, so an application sees a private keyspace).

Ports ``etcd_tpu/client/namespace.py``.
"""

from __future__ import annotations

from typing import Optional

from ..server import api as sapi
from .client import Client, WatchHandle
from .util import prefix_end as _prefix_end


def _prefix_interval(pfx: bytes, key: bytes, end: bytes) -> tuple:
    """ref: namespace/util.go prefixInterval."""
    pkey = pfx + key
    if not end:
        pend = b""
    elif end == b"\x00":
        # "from key to end of keyspace" → end of prefix range.
        pend = _prefix_end(pfx)
    else:
        pend = pfx + end
    return pkey, pend


class NamespacedClient:
    """Wrap a Client so all KV/watch ops live under `prefix`."""

    def __init__(self, client: Client, prefix: bytes) -> None:
        self.c = client
        self.pfx = prefix

    def _strip(self, resp) -> None:
        for kv in getattr(resp, "kvs", []) or []:
            kv.key = kv.key[len(self.pfx):]
        pk = getattr(resp, "prev_kv", None)
        if pk is not None:
            pk.key = pk.key[len(self.pfx):]
        for kv in getattr(resp, "prev_kvs", []) or []:
            kv.key = kv.key[len(self.pfx):]

    def put(self, key: bytes, value: bytes, **kw) -> sapi.PutResponse:
        resp = self.c.put(self.pfx + key, value, **kw)
        self._strip(resp)
        return resp

    def get(self, key: bytes, range_end: Optional[bytes] = None, **kw):
        pkey, pend = _prefix_interval(self.pfx, key, range_end or b"")
        resp = self.c.get(pkey, range_end=pend or None, **kw)
        self._strip(resp)
        return resp

    def delete(self, key: bytes, range_end: Optional[bytes] = None, **kw):
        pkey, pend = _prefix_interval(self.pfx, key, range_end or b"")
        resp = self.c.delete(pkey, range_end=pend or None, **kw)
        self._strip(resp)
        return resp

    def watch(self, key: bytes, range_end: Optional[bytes] = None,
              start_rev: int = 0) -> "NamespacedWatch":
        pkey, pend = _prefix_interval(self.pfx, key, range_end or b"")
        return NamespacedWatch(
            self.c.watch(pkey, range_end=pend or None, start_rev=start_rev),
            self.pfx,
        )


class NamespacedWatch:
    def __init__(self, handle: WatchHandle, pfx: bytes) -> None:
        self.h = handle
        self.pfx = pfx

    def get(self, timeout=None):
        batch = self.h.get(timeout)
        if batch is None:
            return None
        rev, events = batch
        for ev in events:
            ev.kv.key = ev.kv.key[len(self.pfx):]
            if ev.prev_kv is not None:
                ev.prev_kv.key = ev.prev_kv.key[len(self.pfx):]
        return rev, events

    def cancel(self) -> None:
        self.h.cancel()
