"""Caching/coalescing L7 proxy (ref: server/proxy/grpcproxy/:
kv.go request cache, watch.go + watch_broadcast.go coalescing,
lease.go keepalive forwarding, cluster.go/maintenance.go passthrough).

Speaks the same framed-RPC wire protocol as V3RPCServer, so clients
point at the proxy unchanged. Backed by one upstream ``Client`` (which
already does endpoint failover):

* **serializable Range cache** — responses keyed by the request shape,
  invalidated on writes through the proxy and on compaction
  (grpcproxy/kv.go:44-103, cache/store.go);
* **watch coalescing** — one upstream watch per (key, range_end) fans
  out to every proxy-side watcher that joined at "current" (start_rev
  0); historical watchers get a dedicated upstream watch
  (watch_broadcast.go);
* everything else forwards.

Ports ``etcd_tpu/proxy/grpcproxy.py``.
"""

from __future__ import annotations

import socket
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from ..client.client import Client, ClientError
from ..v3rpc import wire
from ..v3rpc.connbase import FramedServerConn

DEFAULT_CACHE_ENTRIES = 2048  # ref: cache/store.go DefaultMaxEntries


class _RangeCache:
    """LRU of serializable range responses (ref: cache/store.go)."""

    def __init__(self, max_entries: int = DEFAULT_CACHE_ENTRIES) -> None:
        self._lock = threading.Lock()
        self._od: "OrderedDict[str, Dict]" = OrderedDict()
        self.max_entries = max_entries
        self.compact_rev = 0
        self.hits = 0
        self.misses = 0
        self.gen = 0  # bumped on invalidate; stale fetches don't re-insert

    @staticmethod
    def _key(params: Dict) -> str:
        return "|".join(
            f"{k}={params.get(k)}"
            for k in sorted(
                ("key", "range_end", "limit", "revision", "sort_order",
                 "sort_target", "count_only", "keys_only",
                 "min_mod_revision", "max_mod_revision",
                 "min_create_revision", "max_create_revision")
            )
        )

    def get(self, params: Dict) -> Optional[Dict]:
        rev = params.get("revision", 0) or 0
        with self._lock:
            if 0 < rev < self.compact_rev:
                return None  # compacted: let the server answer with the error
            k = self._key(params)
            resp = self._od.get(k)
            if resp is None:
                self.misses += 1
                return None
            self._od.move_to_end(k)
            self.hits += 1
            return resp

    def put(self, params: Dict, resp: Dict, gen: int) -> None:
        """Insert only if no invalidation happened since `gen` was read
        (a concurrent write may have made this response stale)."""
        rev = params.get("revision", 0) or 0
        with self._lock:
            if gen != self.gen:
                return
            if 0 < rev < self.compact_rev:
                return
            k = self._key(params)
            self._od[k] = resp
            self._od.move_to_end(k)
            while len(self._od) > self.max_entries:
                self._od.popitem(last=False)

    def invalidate(self) -> None:
        # The reference invalidates by key interval (cache.Invalidate);
        # dropping everything is strictly safer and keeps this host-side
        # path simple.
        with self._lock:
            self.gen += 1
            self._od.clear()

    def compacted(self, rev: int) -> None:
        with self._lock:
            self.gen += 1
            self.compact_rev = max(self.compact_rev, rev)
            self._od.clear()


class _Broadcast:
    """One upstream watch fanned out to many proxy watchers
    (ref: watch_broadcast.go)."""

    def __init__(self, proxy: "GrpcProxy", key: bytes,
                 end: Optional[bytes]) -> None:
        self.proxy = proxy
        self.handle = proxy.client.watch(key, end)
        self.subs: Dict[Tuple[int, int], "_ProxyConn"] = {}  # (conn_id, wid)
        self.lock = threading.Lock()
        self.stopped = False
        self.thread = threading.Thread(target=self._pump, daemon=True)
        self.thread.start()

    def add(self, conn: "_ProxyConn", wid: int) -> None:
        with self.lock:
            self.subs[(id(conn), wid)] = conn

    def remove(self, conn: "_ProxyConn", wid: int) -> bool:
        """Returns True when the broadcast became empty."""
        with self.lock:
            self.subs.pop((id(conn), wid), None)
            return not self.subs

    def stop(self) -> None:
        self.stopped = True
        self.handle.cancel()

    def _pump(self) -> None:
        while not self.stopped and not self.proxy._stopped.is_set():
            got = self.handle.get(timeout=0.2)
            if got is None:
                continue
            rev, events = got
            with self.lock:
                subs = list(self.subs.items())
            for (cid, wid), conn in subs:
                if not conn.push_event(wid, rev, events):
                    # Dead or stalled downstream (send timed out): drop
                    # this subscriber so others keep receiving.
                    self.proxy.release_broadcast(
                        conn=conn, wid=wid, key=None, end=None, bcast=self
                    )


class GrpcProxy:
    def __init__(
        self,
        endpoints: List[Tuple[str, int]],
        bind: Tuple[str, int] = ("127.0.0.1", 0),
    ) -> None:
        self.client = Client(endpoints)
        self.cache = _RangeCache()
        self._stopped = threading.Event()
        self._bcasts: Dict[Tuple[bytes, Optional[bytes]], _Broadcast] = {}
        self._bcast_lock = threading.Lock()
        self._conns: set = set()

        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(bind)
        self._listener.listen(128)
        self.addr = self._listener.getsockname()
        threading.Thread(target=self._accept_loop, daemon=True).start()

    def stop(self) -> None:
        self._stopped.set()
        with self._bcast_lock:
            for b in self._bcasts.values():
                b.stop()
            self._bcasts.clear()
        for s in (self._listener, *list(self._conns)):
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass
        self.client.close()

    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._conns.add(conn)
            _ProxyConn(self, conn)

    # -- broadcast registry ----------------------------------------------------

    def broadcast_join(self, key: bytes, end: Optional[bytes],
                       conn: "_ProxyConn", wid: int) -> _Broadcast:
        """Get-or-create the broadcast AND subscribe under one lock, so
        a concurrent last-watcher teardown can't stop it in between."""
        with self._bcast_lock:
            b = self._bcasts.get((key, end))
            if b is None or b.stopped:
                b = _Broadcast(self, key, end)
                self._bcasts[(key, end)] = b
            b.add(conn, wid)
            return b

    def release_broadcast(self, key: Optional[bytes], end: Optional[bytes],
                          conn: "_ProxyConn", wid: int,
                          bcast: Optional[_Broadcast] = None) -> None:
        with self._bcast_lock:
            if bcast is not None:
                b = bcast
                keys = [k for k, v in self._bcasts.items() if v is b]
                key_tuple = keys[0] if keys else None
            else:
                key_tuple = (key, end)
                b = self._bcasts.get(key_tuple)
            if b is not None and b.remove(conn, wid):
                b.stop()
                if key_tuple is not None:
                    self._bcasts.pop(key_tuple, None)


class _ProxyConn(FramedServerConn):
    """One downstream client connection."""

    SEND_TIMEOUT_S = 5  # stalled-watcher bound: sendall fails after this

    def __init__(self, proxy: GrpcProxy, sock: socket.socket) -> None:
        self.p = proxy
        self._wstate = threading.Lock()  # guards watch bookkeeping below
        self._next_wid = 0
        self._wlocal: Dict[int, Tuple[bytes, Optional[bytes], Any]] = {}
        self._ready_wids: set = set()  # create response on the wire
        self._buffered: Dict[int, list] = {}  # wid -> [(rev, events)]
        import struct as _struct

        try:
            sock.setsockopt(
                socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                _struct.pack("ll", self.SEND_TIMEOUT_S, 0),
            )
        except OSError:
            pass
        super().__init__(sock, proxy._stopped)

    def push_event(self, wid: int, revision: int, events) -> bool:
        # Until the WatchCreate response is on the wire the client can't
        # route this wid — buffer instead of dropping (flushed by
        # after_send).
        with self._wstate:
            if wid in self._wlocal and wid not in self._ready_wids:
                self._buffered.setdefault(wid, []).append((revision, events))
                return True
        return self.send_frame({
            "stream": wid,
            "event": {
                "revision": revision,
                "events": [wire.enc_event(ev) for ev in events],
            },
        })

    def encode_error(self, e: Exception) -> Dict[str, str]:
        if isinstance(e, ClientError):
            return {"type": e.etype, "msg": e.msg}
        return super().encode_error(e)

    def on_close(self) -> None:
        with self._wstate:
            wids = list(self._wlocal)
        for wid in wids:
            self._cancel_watch(wid)
        self.p._conns.discard(self.sock)

    def after_send(self, method: str, params: Dict, result: Any) -> None:
        # The create response is on the wire: flush anything buffered
        # while the client couldn't route this wid yet.
        if method != "WatchCreate":
            return
        wid = result.get("watch_id")
        # Drain-then-mark-ready loop: concurrent pumps keep buffering
        # until the buffer is empty, so event order is preserved.
        while True:
            with self._wstate:
                pending = self._buffered.pop(wid, [])
                if not pending:
                    self._ready_wids.add(wid)
                    return
            for revision, events in pending:
                self.send_frame({
                    "stream": wid,
                    "event": {
                        "revision": revision,
                        "events": [wire.enc_event(ev) for ev in events],
                    },
                })

    def dispatch(self, method: str, params: Dict,
                 token: Optional[str] = None) -> Any:
        return self._dispatch(method, params, token)

    # -- dispatch --------------------------------------------------------------

    def _dispatch(self, method: str, params: Dict,
                  token: Optional[str] = None) -> Any:
        p = self.p
        if method == "Range" and params.get("serializable") and token is None:
            # Auth'd requests bypass the shared cache (per-user
            # permissions must not leak across callers).
            cached = p.cache.get(params)
            if cached is not None:
                return cached
            gen = p.cache.gen
            resp = p.client._request("Range", params)
            p.cache.put(params, resp, gen)
            return resp
        if method in ("Put", "DeleteRange", "Txn"):
            resp = p.client._request(method, params, token=token)
            p.cache.invalidate()
            return resp
        if method == "Compact":
            resp = p.client._request(method, params, token=token)
            p.cache.compacted(params.get("revision", 0))
            return resp
        if method == "WatchCreate":
            return self._watch_create(params)
        if method == "WatchCancel":
            self._cancel_watch(params.get("watch_id", -1))
            return {"canceled": True}
        # Lease/Cluster/Maintenance/Auth passthrough.
        return p.client._request(method, params, token=token)

    # -- watch coalescing ------------------------------------------------------

    def _watch_create(self, params: Dict) -> Dict:
        key = bytes.fromhex(params["key"])
        end_hex = params.get("range_end", "")
        end = bytes.fromhex(end_hex) if end_hex else None
        start_rev = params.get("start_revision", 0)
        with self._wstate:
            wid = self._next_wid
            self._next_wid += 1
        if start_rev == 0:
            with self._wstate:
                self._wlocal[wid] = (key, end, None)
            # Join NOW — no event gap; deliveries buffer until the
            # create response frame goes out (push_event).
            self.p.broadcast_join(key, end, self, wid)
        else:
            h = self.p.client.watch(key, end, start_rev=start_rev)
            with self._wstate:
                self._wlocal[wid] = (key, end, h)
            threading.Thread(
                target=self._dedicated_pump, args=(wid, h), daemon=True
            ).start()
        return {"watch_id": wid, "revision": 0}

    def _dedicated_pump(self, wid: int, h) -> None:
        while not self.p._stopped.is_set() and wid in self._wlocal:
            got = h.get(timeout=0.2)
            if got is None:
                continue
            rev, events = got
            if not self.push_event(wid, rev, events):
                return

    def _cancel_watch(self, wid: int) -> None:
        with self._wstate:
            ent = self._wlocal.pop(wid, None)
            self._ready_wids.discard(wid)
            self._buffered.pop(wid, None)
        if ent is None:
            return
        key, end, dedicated = ent
        if dedicated is not None:
            dedicated.cancel()
        else:
            self.p.release_broadcast(key, end, self, wid)


def start_grpc_proxy(
    endpoints: List[Tuple[str, int]],
    bind: Tuple[str, int] = ("127.0.0.1", 0),
) -> GrpcProxy:
    return GrpcProxy(endpoints, bind)
