"""In-process client over a live EtcdServer.

The reference builds its server-side election/lock services on the
*client* concurrency recipes by wrapping the server in a loopback
clientv3 (ref: server/etcdserver/api/v3client/v3client.go:24-60 New).
``LocalClient`` is that loopback: it duck-types the subset of
``etcd_tpu.client.client.Client`` the recipes use — KV ops, watch,
lease — but calls straight into the server's apply path with no
sockets or frames in between.

Ports ``etcd_tpu/server/v3client.py``.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional, Tuple

from . import api as sapi


class LocalWatchHandle:
    """WatchHandle contract (get/cancel) over a server-side WatchStream."""

    def __init__(self, kv, key: bytes, range_end: Optional[bytes], start_rev: int):
        self._ws = kv.new_watch_stream()
        end = range_end if range_end else None
        if end == b"\x00":
            end = b""  # open-end sentinel, same as the RPC surface
        self.watch_id = self._ws.watch(key, end, start_rev=start_rev)
        self._closed = False

    def get(self, timeout: Optional[float] = None):
        if self._closed:
            return None
        resp = self._ws.poll(timeout=timeout)
        if resp is None:
            return None
        return resp.revision, list(resp.events)

    def events(self, timeout: float = 5.0):
        out = self.get(timeout=timeout)
        return out[1] if out else []

    def cancel(self) -> None:
        if not self._closed:
            self._closed = True
            try:
                self._ws.close()
            except Exception:
                pass


class LocalClient:
    """Loopback client: the concurrency-recipe surface of ``Client``
    served by direct EtcdServer calls (ref: v3client.go New)."""

    def __init__(self, server, token: Optional[str] = None) -> None:
        self.s = server
        self.token = token

    # -- KV --------------------------------------------------------------------

    def put(self, key: bytes, value: bytes, lease: int = 0,
            prev_kv: bool = False, ignore_lease: bool = False) -> sapi.PutResponse:
        req = sapi.PutRequest(key=key, value=value, lease=lease,
                              prev_kv=prev_kv, ignore_lease=ignore_lease)
        return self.s.put(req, token=self.token)

    def get(self, key: bytes, range_end: Optional[bytes] = None, revision: int = 0,
            limit: int = 0, serializable: bool = False, count_only: bool = False,
            keys_only: bool = False,
            sort_order: sapi.SortOrder = sapi.SortOrder.NONE,
            sort_target: sapi.SortTarget = sapi.SortTarget.KEY) -> sapi.RangeResponse:
        req = sapi.RangeRequest(
            key=key, range_end=range_end or b"", revision=revision, limit=limit,
            serializable=serializable, count_only=count_only, keys_only=keys_only,
            sort_order=sort_order, sort_target=sort_target)
        return self.s.range(req, token=self.token)

    def delete(self, key: bytes, range_end: Optional[bytes] = None,
               prev_kv: bool = False) -> sapi.DeleteRangeResponse:
        req = sapi.DeleteRangeRequest(key=key, range_end=range_end or b"",
                                      prev_kv=prev_kv)
        return self.s.delete_range(req, token=self.token)

    def txn(self, txn_req: sapi.TxnRequest) -> sapi.TxnResponse:
        return self.s.txn(txn_req, token=self.token)

    # -- watch -----------------------------------------------------------------

    def watch(self, key: bytes, range_end: Optional[bytes] = None,
              start_rev: int = 0) -> LocalWatchHandle:
        return LocalWatchHandle(self.s.kv, key, range_end, start_rev)

    # -- lease -----------------------------------------------------------------

    def lease_grant(self, ttl: int, lease_id: int = 0) -> sapi.LeaseGrantResponse:
        return self.s.lease_grant(ttl=ttl, lease_id=lease_id, token=self.token)

    def lease_revoke(self, lease_id: int) -> sapi.LeaseRevokeResponse:
        return self.s.lease_revoke(lease_id, token=self.token)

    def lease_keep_alive_once(self, lease_id: int) -> int:
        return self.s.lease_renew(lease_id)

    def lease_keep_alive(self, lease_id: int,
                         interval: Optional[float] = None) -> Callable[[], None]:
        stop = threading.Event()
        ttl = max(1, interval or 1)

        def loop() -> None:
            while not stop.wait(ttl):
                try:
                    self.s.lease_renew(lease_id)
                except Exception:
                    return

        t = threading.Thread(target=loop, daemon=True,
                             name=f"local-keepalive-{lease_id:x}")
        t.start()
        return stop.set
