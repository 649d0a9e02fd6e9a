"""Client core (ref: client/v3/client.go, kv.go, watch.go, lease.go,
retry_interceptor.go).

One live connection at a time over the endpoint list; a reader thread
routes unary responses by id and watch pushes by stream id. Connection
loss → next endpoint (round-robin, client.go's balancer), watches
resume from last-seen revision + 1, in-flight unary calls fail over
transparently when safe (idempotent or connection-refused-before-send).

Ports ``etcd_tpu/client/client.py``.
"""

from __future__ import annotations

import socket
import ssl
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..server import api as sapi
from ..pkg import rpctypes
from ..storage.mvcc.kv import Event
from ..v3rpc import wire

RETRYABLE = {"ConnectionError"}  # transport-level, always safe to retry
# Server-side errors that mean "try another endpoint" for any method
# (ref: retry_interceptor.go retryPolicy + isSafeRetry).
FAILOVER_ETYPES = {"NotLeaderError", "StoppedError"}
IDEMPOTENT = {
    "Range",
    "Status",
    "MemberList",
    "HashKV",
    "LeaseTimeToLive",
    "LeaseLeases",
    "AuthStatus",
    "UserGet",
    "UserList",
    "RoleGet",
    "RoleList",
    "WatchCreate",
    "LeaseKeepAlive",
    # Lock/Campaign claims are keyed by (name, lease): retrying re-enters
    # the same server-side wait on the same ownership key, so a retry
    # after a dropped connection continues the claim instead of
    # duplicating it (ref: v3lock.go Lock — key is <name>/<lease-hex>).
    "Lock",
    "Campaign",
}


class ClientError(Exception):
    def __init__(self, etype: str, msg: str = "",
                 code: Optional[str] = None,
                 grpc_code: Optional[int] = None) -> None:
        super().__init__(f"{etype}: {msg}")
        self.etype = etype
        self.msg = msg
        # Canonical error identity (ref: api/v3rpc/rpctypes/error.go):
        # retry/failover decisions key off these, not the class name.
        self.code = code
        self.grpc_code = grpc_code

    def as_typed(self) -> Optional[Exception]:
        """The canonical server-side exception, when this error carries
        a table code (for callers that match on exception types)."""
        if self.code is None:
            return None
        return rpctypes.exception_for(self.code, self.msg)


class ConnClosed(Exception):
    pass


@dataclass
class _Pending:
    ev: threading.Event = field(default_factory=threading.Event)
    result: Any = None
    error: Optional[Dict] = None
    sent: bool = False
    method: str = ""  # diagnostics: names the call in conn-loss errors


class WatchHandle:
    """One logical watch; survives reconnects
    (ref: client/v3/watch.go watchGrpcStream resume)."""

    def __init__(self, client: "Client", key: bytes, range_end: Optional[bytes],
                 start_rev: int) -> None:
        self.c = client
        self.key = key
        self.range_end = range_end
        self.next_rev = start_rev
        self.watch_id: Optional[int] = None
        self.canceled = False
        self._q: List[Tuple[int, List[Event]]] = []
        self._cv = threading.Condition()

    def _push(self, revision: int, events: List[Event]) -> None:
        with self._cv:
            self._q.append((revision, events))
            self.next_rev = max(self.next_rev, revision + 1)
            self._cv.notify_all()

    def get(self, timeout: Optional[float] = None) -> Optional[Tuple[int, List[Event]]]:
        """Next (revision, events) batch; None on timeout."""
        with self._cv:
            if not self._q:
                self._cv.wait(timeout)
            return self._q.pop(0) if self._q else None

    def events(self, timeout: float = 5.0):
        """Generator of events until cancel()."""
        while not self.canceled:
            batch = self.get(timeout=timeout)
            if batch is None:
                return
            for ev in batch[1]:
                yield ev

    def cancel(self) -> None:
        self.canceled = True
        if self.watch_id is not None:
            try:
                self.c._request("WatchCancel", {"watch_id": self.watch_id})
            except Exception:  # noqa: BLE001
                pass
        with self.c._lock:
            self.c._watches.pop(self.watch_id, None)
        with self._cv:
            self._cv.notify_all()


class ObserveHandle:
    """One election Observe stream: leader kvs pushed by the server
    (ref: v3election.go:76-91 Observe)."""

    def __init__(self, client: "Client", observe_id: int) -> None:
        self.c = client
        self.observe_id = observe_id
        self.canceled = False
        self._q: List = []
        self._cv = threading.Condition()

    def _push(self, kv) -> None:
        with self._cv:
            self._q.append(kv)
            self._cv.notify_all()

    def get(self, timeout: Optional[float] = None):
        """Next leader kv; None on timeout."""
        with self._cv:
            if not self._q:
                self._cv.wait(timeout)
            return self._q.pop(0) if self._q else None

    def cancel(self) -> None:
        self.canceled = True
        try:
            self.c._request("ObserveCancel", {"observe_id": self.observe_id})
        except Exception:  # noqa: BLE001
            pass
        with self.c._lock:
            self.c._observes.pop(self.observe_id, None)
            # In-flight frames pushed before the cancel was processed
            # would otherwise park in the early buffer forever.
            self.c._observe_early.pop(self.observe_id, None)
        with self._cv:
            self._cv.notify_all()


class Client:
    def __init__(
        self,
        endpoints: List[Tuple[str, int]],
        username: str = "",
        password: str = "",
        dial_timeout: float = 2.0,
        request_timeout: float = 10.0,
        tls_info=None,
    ) -> None:
        self.endpoints = list(endpoints)
        self._ep_index = 0
        self.username = username
        self.password = password
        self.token: Optional[str] = None
        self.dial_timeout = dial_timeout
        self.request_timeout = request_timeout
        # Client-channel TLS (ref: clientv3 TLS config via
        # client/pkg/transport ClientConfig).
        self._ssl = None
        self._tls_server_name = ""
        if tls_info is not None:
            # A CA-only TLSInfo is valid for a client (server cert
            # verification without mutual TLS).
            self._ssl = tls_info.client_context()
            self._tls_server_name = tls_info.server_name

        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._wlock = threading.Lock()
        self._next_id = 1
        self._pending: Dict[int, _Pending] = {}
        self._watches: Dict[int, WatchHandle] = {}
        self._observes: Dict[int, "ObserveHandle"] = {}
        # Observe frames that raced ahead of the Observe response (the
        # server pump can push before the observe_id reaches us); keyed
        # by ostream id, drained when observe() registers the handle.
        self._observe_early: Dict[int, list] = {}
        self._closed = False
        self._reconnect_gen = 0

        self._connect_any()

    # -- connection management -------------------------------------------------

    def _connect_any(self) -> None:
        last_err: Optional[Exception] = None
        for _ in range(len(self.endpoints)):
            ep = self.endpoints[self._ep_index % len(self.endpoints)]
            self._ep_index += 1
            try:
                self._connect(ep)
                return
            except OSError as e:
                last_err = e
        raise ClientError("ConnectionError", f"no endpoint reachable: {last_err}")

    def _connect(self, ep: Tuple[str, int]) -> None:
        sock = socket.create_connection(ep, timeout=self.dial_timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if self._ssl is not None:
            sock = self._ssl.wrap_socket(
                sock, server_hostname=self._tls_server_name or ep[0])
        sock.settimeout(None)
        with self._lock:
            self._sock = sock
            self._reconnect_gen += 1
            gen = self._reconnect_gen
            # Observe ids restart per connection; buffered frames from
            # the previous connection must not seed the new one's ids
            # (the dying read loop skips its own clear when it exits on
            # a generation mismatch).
            self._observe_early.clear()
        threading.Thread(
            target=self._read_loop, args=(sock, gen), daemon=True
        ).start()
        if self.username and self.token is None:
            self._authenticate_locked()
        self._resume_watches()

    def _authenticate_locked(self) -> None:
        self.token = None
        resp = self._request(
            "Authenticate",
            {"name": self.username, "password": self.password},
            _no_reauth=True,
        )
        self.token = resp["token"]

    def authenticate(self, username: str, password: str) -> None:
        self.username, self.password = username, password
        self._authenticate_locked()

    def _resume_watches(self) -> None:
        with self._lock:
            handles = list(self._watches.values())
            self._watches.clear()
        for h in handles:
            if h.canceled:
                continue
            try:
                self._establish_watch(h)
            except Exception:  # noqa: BLE001 — retried on next reconnect
                pass

    def _read_loop(self, sock: socket.socket, gen: int) -> None:
        while True:
            frame = wire.read_frame(sock)
            if frame is None:
                break
            if "stream" in frame:
                with self._lock:
                    h = self._watches.get(frame["stream"])
                if h is not None:
                    ev = frame["event"]
                    h._push(
                        ev["revision"],
                        [wire.dec_event(d) for d in ev.get("events", [])],
                    )
                continue
            if "ostream" in frame:
                with self._lock:
                    oh = self._observes.get(frame["ostream"])
                    # Buffer only for the live connection: observe ids
                    # restart per connection, and a dead loop draining
                    # its socket tail must not seed the next
                    # connection's ids with stale leader kvs.
                    if oh is None and self._reconnect_gen == gen:
                        buf = self._observe_early.setdefault(
                            frame["ostream"], [])
                        if len(buf) < 64:
                            buf.append(frame["kv"])
                if oh is not None:
                    oh._push(wire.dec_kv(frame["kv"]))
                continue
            rid = frame.get("id")
            with self._lock:
                p = self._pending.pop(rid, None)
            if p is not None:
                p.result = frame.get("result")
                p.error = frame.get("error")
                p.ev.set()
        # Connection died: fail pending, mark socket gone.
        with self._lock:
            if self._reconnect_gen != gen:
                return
            self._sock = None
            pend = list(self._pending.values())
            self._pending.clear()
            self._observe_early.clear()  # ids are per-connection
        self._fail_pendings(pend)

    @staticmethod
    def _fail_pendings(pend: List["_Pending"]) -> None:
        for p in pend:
            p.error = {"type": "ConnectionError",
                       "msg": f"connection lost ({p.method or 'call'} in flight)"}
            p.ev.set()

    # -- unary calls -----------------------------------------------------------

    def _request(
        self,
        method: str,
        params: Dict[str, Any],
        timeout: Optional[float] = None,
        _no_reauth: bool = False,
        token: Optional[str] = None,
    ) -> Any:
        """`token` overrides the client's own auth token for this call
        (used by grpcproxy to forward the downstream caller's token)."""
        timeout = timeout or self.request_timeout
        attempts = max(2 * len(self.endpoints), 2)
        last: Optional[ClientError] = None
        for _ in range(attempts):
            if self._closed:
                raise ClientError("Closed", "client closed")
            try:
                return self._request_once(method, params, timeout, token=token)
            except ClientError as e:
                last = e
                invalid_token = (
                    e.code == "ErrInvalidAuthToken"
                    or e.etype == "InvalidAuthTokenError"
                )
                if invalid_token and not _no_reauth and self.username:
                    self._authenticate_locked()
                    continue
                retryable = e.etype in RETRYABLE and (
                    method in IDEMPOTENT or not getattr(e, "sent", True)
                )
                # Failover on codes when the server sends them (gRPC
                # Unavailable class, ref: retry_interceptor.go retrying
                # on codes.Unavailable); class names only as the legacy
                # fallback for code-less peers.
                if e.code is not None or e.grpc_code is not None:
                    failover = (
                        e.grpc_code == int(rpctypes.Code.Unavailable)
                        or e.code in rpctypes.FAILOVER_SYMBOLS
                        or e.etype in FAILOVER_ETYPES
                    )
                else:
                    failover = e.etype in FAILOVER_ETYPES
                if not (retryable or failover):
                    raise
                try:
                    if self._sock is None:
                        self._connect_any()
                    elif failover:
                        self._rotate_endpoint()
                except ClientError as ce:
                    last = ce
                time.sleep(0.05)
        raise last  # type: ignore[misc]

    def _rotate_endpoint(self) -> None:
        with self._lock:
            sock = self._sock
            self._sock = None
            # Requests in flight on the dying connection would otherwise
            # hang until their own deadline: the old read loop skips its
            # pending-failure pass once _reconnect_gen moves on (it can't
            # tell which pendings were re-issued on the new conn). Fail
            # them here so waiters see the break immediately and the
            # retry loop re-sends the retry-safe ones.
            pend = list(self._pending.values())
            self._pending.clear()
        self._fail_pendings(pend)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        self._connect_any()

    def _request_once(self, method: str, params: Dict, timeout: float,
                      token: Optional[str] = None) -> Any:
        with self._lock:
            sock = self._sock
            rid = self._next_id
            self._next_id += 1
            p = _Pending(method=method)
            self._pending[rid] = p
        if sock is None:
            with self._lock:
                self._pending.pop(rid, None)
            err = ClientError("ConnectionError", "not connected")
            err.sent = False
            raise err
        msg = {"id": rid, "method": method, "params": params}
        tok = token if token is not None else self.token
        if tok is not None:
            msg["token"] = tok
        try:
            with self._wlock:
                wire.write_frame(sock, msg)
        except OSError:
            with self._lock:
                self._pending.pop(rid, None)
            err = ClientError("ConnectionError", "send failed")
            err.sent = False
            raise err
        if not p.ev.wait(timeout=timeout):
            with self._lock:
                self._pending.pop(rid, None)
            raise ClientError("Timeout", f"{method} timed out")
        if p.error is not None:
            e = ClientError(
                p.error["type"], p.error.get("msg", ""),
                code=p.error.get("code"),
                grpc_code=p.error.get("grpcCode"),
            )
            e.sent = True
            raise e
        return p.result

    # -- KV API (client/v3/kv.go) ----------------------------------------------

    def put(
        self,
        key: bytes,
        value: bytes,
        lease: int = 0,
        prev_kv: bool = False,
    ) -> sapi.PutResponse:
        req = sapi.PutRequest(key=key, value=value, lease=lease, prev_kv=prev_kv)
        return wire.dec_response("Put", self._request("Put", wire.enc(req)))

    def get(
        self,
        key: bytes,
        range_end: Optional[bytes] = None,
        revision: int = 0,
        limit: int = 0,
        serializable: bool = False,
        count_only: bool = False,
        keys_only: bool = False,
        sort_order: sapi.SortOrder = sapi.SortOrder.NONE,
        sort_target: sapi.SortTarget = sapi.SortTarget.KEY,
    ) -> sapi.RangeResponse:
        req = sapi.RangeRequest(
            key=key,
            range_end=range_end or b"",
            revision=revision,
            limit=limit,
            serializable=serializable,
            count_only=count_only,
            keys_only=keys_only,
            sort_order=sort_order,
            sort_target=sort_target,
        )
        return wire.dec_response("Range", self._request("Range", wire.enc(req)))

    def delete(
        self, key: bytes, range_end: Optional[bytes] = None, prev_kv: bool = False
    ) -> sapi.DeleteRangeResponse:
        req = sapi.DeleteRangeRequest(
            key=key, range_end=range_end or b"", prev_kv=prev_kv
        )
        return wire.dec_response(
            "DeleteRange", self._request("DeleteRange", wire.enc(req))
        )

    def txn(self, txn_req: sapi.TxnRequest) -> sapi.TxnResponse:
        return wire.dec_response("Txn", self._request("Txn", wire.enc(txn_req)))

    def compact(self, revision: int, physical: bool = False) -> sapi.CompactionResponse:
        req = sapi.CompactionRequest(revision=revision, physical=physical)
        return wire.dec_response("Compact", self._request("Compact", wire.enc(req)))

    # -- watch (client/v3/watch.go) --------------------------------------------

    def watch(
        self, key: bytes, range_end: Optional[bytes] = None, start_rev: int = 0
    ) -> WatchHandle:
        h = WatchHandle(self, key, range_end, start_rev)
        self._establish_watch(h)
        return h

    def _establish_watch(self, h: WatchHandle) -> None:
        params: Dict[str, Any] = {
            "key": h.key.hex(),
            "start_revision": h.next_rev,
        }
        if h.range_end:
            params["range_end"] = h.range_end.hex()
        resp = self._request("WatchCreate", params)
        h.watch_id = resp["watch_id"]
        with self._lock:
            self._watches[h.watch_id] = h

    # -- lease (client/v3/lease.go) --------------------------------------------

    def lease_grant(self, ttl: int, lease_id: int = 0) -> sapi.LeaseGrantResponse:
        return wire.dec_response(
            "LeaseGrant", self._request("LeaseGrant", {"ttl": ttl, "id": lease_id})
        )

    def lease_revoke(self, lease_id: int) -> sapi.LeaseRevokeResponse:
        return wire.dec_response(
            "LeaseRevoke", self._request("LeaseRevoke", {"id": lease_id})
        )

    def lease_keep_alive_once(self, lease_id: int) -> int:
        resp = self._request("LeaseKeepAlive", {"id": lease_id})
        return resp["ttl"]

    def lease_time_to_live(self, lease_id: int, keys: bool = False) -> Dict:
        return self._request("LeaseTimeToLive", {"id": lease_id, "keys": keys})

    def lease_keep_alive(self, lease_id: int, interval: Optional[float] = None):
        """Background keepalive; returns a stop callable
        (ref: lease.go KeepAlive loop — sends at ttl/3 cadence)."""
        stop = threading.Event()
        if interval is None:
            ttl = max(self.lease_time_to_live(lease_id).get("granted_ttl", 3), 1)
            interval = ttl / 3.0

        def loop() -> None:
            while not stop.wait(interval):
                try:
                    self.lease_keep_alive_once(lease_id)
                except ClientError:
                    pass  # retried next tick (failover handled in _request)

        threading.Thread(target=loop, daemon=True).start()
        return stop.set

    # -- cluster / maintenance -------------------------------------------------

    def member_list(self) -> List[Dict]:
        return self._request("MemberList", {})["members"]

    def member_add(
        self, member_id: int, name: str = "", peer_urls=None, is_learner=False
    ) -> List[Dict]:
        return self._request(
            "MemberAdd",
            {
                "id": member_id,
                "name": name,
                "peer_urls": peer_urls or [],
                "is_learner": is_learner,
            },
        )["members"]

    def member_remove(self, member_id: int) -> List[Dict]:
        return self._request("MemberRemove", {"id": member_id})["members"]

    def member_promote(self, member_id: int) -> List[Dict]:
        return self._request("MemberPromote", {"id": member_id})["members"]

    def status(self) -> Dict:
        return self._request("Status", {})

    def hash_kv(self, revision: int = 0) -> Dict:
        return self._request("HashKV", {"revision": revision})

    def defragment(self) -> None:
        self._request("Defragment", {})

    def move_leader(self, target_id: int) -> None:
        self._request("MoveLeader", {"target_id": target_id})

    def snapshot(self) -> bytes:
        return bytes.fromhex(self._request("Snapshot", {})["blob"])

    def alarm(self, req: sapi.AlarmRequest) -> sapi.AlarmResponse:
        return wire.dec_response("Alarm", self._request("Alarm", wire.enc(req)))

    # -- election/lock services (server/etcdserver/api/v3election, v3lock) -----

    def lock(self, name: bytes, lease: int, timeout: Optional[float] = None) -> bytes:
        """Server-side Lock RPC (v3lock.go:28-46): blocks on the server
        until the lease owns the mutex; returns the ownership key."""
        params: Dict[str, Any] = {"name": name.hex(), "lease": lease}
        if timeout:
            params["timeout"] = timeout
        rpc_timeout = (timeout + 5.0) if timeout else 24 * 3600.0
        resp = self._request("Lock", params, timeout=rpc_timeout)
        return bytes.fromhex(resp["key"])

    def unlock(self, key: bytes) -> None:
        self._request("Unlock", {"key": key.hex()})

    def campaign(self, name: bytes, lease: int, value: bytes,
                 timeout: Optional[float] = None) -> Dict[str, Any]:
        """Server-side Campaign RPC (v3election.go:42-58); returns the
        LeaderKey dict {name, key, rev, lease} proving leadership."""
        params: Dict[str, Any] = {
            "name": name.hex(), "lease": lease, "value": value.hex()}
        if timeout:
            params["timeout"] = timeout
        rpc_timeout = (timeout + 5.0) if timeout else 24 * 3600.0
        return self._request("Campaign", params, timeout=rpc_timeout)["leader"]

    def proclaim(self, leader: Dict[str, Any], value: bytes) -> None:
        self._request("Proclaim", {"leader": leader, "value": value.hex()})

    def resign(self, leader: Dict[str, Any]) -> None:
        self._request("Resign", {"leader": leader})

    def election_leader(self, name: bytes):
        resp = self._request("Leader", {"name": name.hex()})
        return wire.dec_kv(resp["kv"])

    def observe(self, name: bytes) -> "ObserveHandle":
        """Server-side Observe stream: leader kvs as they change."""
        resp = self._request("Observe", {"name": name.hex()})
        oh = ObserveHandle(self, resp["observe_id"])
        with self._lock:
            # Drain the early buffer under the same lock that registers
            # the handle: once registered, the read loop pushes directly,
            # and a direct push must not overtake older buffered frames.
            self._observes[oh.observe_id] = oh
            for kv in self._observe_early.pop(oh.observe_id, []):
                oh._push(wire.dec_kv(kv))
        return oh

    # -- auth ------------------------------------------------------------------

    def auth_op(self, req: sapi.AuthRequest) -> Any:
        return self._request("Auth", wire.enc(req))

    def auth_enable(self) -> None:
        self.auth_op(sapi.AuthRequest(op="enable"))

    def auth_disable(self) -> None:
        self.auth_op(sapi.AuthRequest(op="disable"))

    def close(self) -> None:
        self._closed = True
        with self._lock:
            sock = self._sock
            self._sock = None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
