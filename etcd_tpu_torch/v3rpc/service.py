"""The RPC server: six service surfaces over one listener
(ref: api/v3rpc/grpc.go:39-93 service registration; key.go, watch.go,
lease.go, maintenance.go, member.go, auth.go).

Connection model: one read loop per client conn; unary methods run on
worker threads (gRPC handler goroutines); each conn owns one
WatchStream whose poller pushes ``{"stream": wid, "event": ...}``
frames (watch.go's sendLoop/recvLoop pair).

Ports ``etcd_tpu/v3rpc/service.py``.
"""

from __future__ import annotations

import socket
import ssl
import struct
import threading
from typing import Any, Dict, Optional

from ..server import api as sapi
from ..server import metrics as smet
from ..server.membership import Member
from . import wire
from .connbase import FramedServerConn


class V3RPCServer:
    def __init__(self, server, bind=("127.0.0.1", 0), tls_info=None) -> None:
        self.s = server
        self._stopped = threading.Event()
        # Client-channel TLS (ref: embed/etcd.go serveClients over
        # transport.NewTLSListener, listener.go:79).
        self._ssl = None
        if tls_info is not None and not tls_info.empty():
            self._ssl = tls_info.server_context()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(bind)
        self._listener.listen(128)
        self.addr = self._listener.getsockname()
        self._conns: set = set()
        threading.Thread(target=self._accept_loop, daemon=True).start()

    def stop(self) -> None:
        self._stopped.set()
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        for c in list(self._conns):
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass

    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            if self._ssl is not None:
                # Handshake off the accept thread: a half-open dialer
                # must not block other clients.
                threading.Thread(target=self._tls_accept, args=(conn,),
                                 daemon=True).start()
            else:
                self._conns.add(conn)
                _Conn(self, conn)

    def _tls_accept(self, conn: socket.socket) -> None:
        try:
            conn = self._ssl.wrap_socket(conn, server_side=True)
        except OSError:  # covers ssl.SSLError
            try:
                conn.close()
            except OSError:
                pass
            return
        self._conns.add(conn)
        if self._stopped.is_set():
            # stop() may have drained _conns while we were handshaking.
            self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass
            return
        _Conn(self, conn)


class _Conn(FramedServerConn):
    recv_counter = staticmethod(smet.client_grpc_received_bytes.inc)
    sent_counter = staticmethod(smet.client_grpc_sent_bytes.inc)

    def __init__(self, srv: V3RPCServer, sock: socket.socket) -> None:
        self.srv = srv
        self.watch_stream = None
        self._watch_poller: Optional[threading.Thread] = None
        self._observers: Dict[int, threading.Event] = {}
        self._next_observe_id = 0
        self._obs_lock = threading.Lock()
        super().__init__(sock, srv._stopped)

    def _send(self, obj: Dict[str, Any]) -> bool:
        return self.send_frame(obj)

    def encode_result(self, result: Any) -> Any:
        return wire.enc(result)

    def on_close(self) -> None:
        if self.watch_stream is not None:
            self.watch_stream.close()
        with self._obs_lock:
            observers = list(self._observers.values())
            self._observers.clear()
        for stop in observers:
            stop.set()
        self.srv._conns.discard(self.sock)

    # -- dispatch --------------------------------------------------------------

    def dispatch(self, method: str, params: Dict, token: Optional[str]):
        return self._dispatch(method, params, token)

    def _dispatch(self, method: str, params: Dict, token: Optional[str]):
        s = self.srv.s
        if method in ("Range", "Put", "DeleteRange", "Txn", "Compact"):
            req = wire.dec_request(method, params)
            fn = {
                "Range": s.range,
                "Put": s.put,
                "DeleteRange": s.delete_range,
                "Txn": s.txn,
                "Compact": s.compact,
            }[method]
            return fn(req, token=token)

        if method == "Alarm":
            req = wire.dec_request("Alarm", params)
            return s.alarm(req, token=token)

        if method == "WatchCreate":
            return self._watch_create(params)
        if method == "WatchCancel":
            if self.watch_stream is not None:
                self.watch_stream.cancel(params["watch_id"])
            return {"canceled": True}

        if method == "LeaseGrant":
            return s.lease_grant(
                ttl=params["ttl"], lease_id=params.get("id", 0), token=token
            )
        if method == "LeaseRevoke":
            return s.lease_revoke(params["id"], token=token)
        if method == "LeaseKeepAlive":
            ttl = s.lease_renew(
                params["id"], local_only=params.get("local_only", False))
            return {"id": params["id"], "ttl": ttl}
        if method == "LeaseTimeToLive":
            out = s.lease_time_to_live(params["id"], keys=params.get("keys", False))
            if out is None:
                return {"id": params["id"], "ttl": -1}
            return out
        if method == "LeaseLeases":
            return {"leases": s.lease_leases()}

        if method == "MemberAdd":
            m = Member(
                id=params["id"],
                name=params.get("name", ""),
                peer_urls=params.get("peer_urls", []),
                is_learner=params.get("is_learner", False),
            )
            s.add_member(m)
            return {"members": [wire.enc(x.__dict__) for x in s.cluster.member_list()]}
        if method == "MemberRemove":
            s.remove_member(params["id"])
            return {"members": [wire.enc(x.__dict__) for x in s.cluster.member_list()]}
        if method == "MemberPromote":
            s.promote_member(params["id"])
            return {"members": [wire.enc(x.__dict__) for x in s.cluster.member_list()]}
        if method == "MemberList":
            return {"members": [wire.enc(x.__dict__) for x in s.cluster.member_list()]}

        if method == "Status":
            return {
                "member_id": s.id,
                "leader": s.leader(),
                "is_leader": s.is_leader(),
                "raft_term": s._term,
                "applied_index": s.applied_index(),
                "committed_index": s.committed_index(),
                "db_size": s.be.size(),
                "db_size_in_use": s.be.size_in_use(),
                "revision": s.kv.rev(),
            }
        if method == "HashKV":
            h, rev, crev = s.hash_kv(params.get("revision", 0))
            return {"hash": h, "compact_revision": crev, "revision": rev}
        if method == "Defragment":
            s.defrag()
            return {}
        if method == "MoveLeader":
            s.node.transfer_leadership(s.leader(), params["target_id"])
            return {}
        if method == "Snapshot":
            import os
            import tempfile

            fd, tmp = tempfile.mkstemp(suffix=".snap.db")
            os.close(fd)
            s.be.snapshot_to(tmp)
            with open(tmp, "rb") as f:
                data = f.read()
            os.remove(tmp)
            return {"blob": data.hex()}

        if method in ("Campaign", "Proclaim", "Leader", "Resign",
                      "Observe", "ObserveCancel"):
            return self._election(method, params, token)
        if method == "Lock":
            # Bounded even for "wait forever" callers so an abandoned
            # conn can't pin a handler thread indefinitely.
            timeout = params.get("timeout") or 24 * 3600.0
            key = s.lock_server.lock(
                bytes.fromhex(params["name"]), params["lease"],
                timeout=timeout, token=token)
            return {"key": key.hex(), "revision": s.kv.rev()}
        if method == "Unlock":
            s.lock_server.unlock(bytes.fromhex(params["key"]), token=token)
            return {"revision": s.kv.rev()}

        if method == "Authenticate":
            token_out = s.authenticate(params["name"], params["password"])
            return {"token": token_out}
        if method == "Auth":
            req = wire.dec_request("Auth", params)
            resp = s.auth_op(req, token=token)
            return resp or {}
        if method == "AuthStatus":
            return {
                "enabled": s.auth_store.is_auth_enabled(),
                "auth_revision": s.auth_store.revision(),
            }
        if method == "UserGet":
            u = s.auth_store.user_get(params["name"])
            return {"name": u.name, "roles": u.roles}
        if method == "UserList":
            return {"users": s.auth_store.user_list()}
        if method == "RoleGet":
            r = s.auth_store.role_get(params["role"])
            return {
                "name": r.name,
                "perms": [
                    {
                        "type": int(p.perm_type),
                        "key": p.key.hex(),
                        "range_end": p.range_end.hex(),
                    }
                    for p in r.key_permissions
                ],
            }
        if method == "RoleList":
            return {"roles": s.auth_store.role_list()}

        raise ValueError(f"unknown method {method!r}")

    # -- election/lock (v3election.go / v3lock.go) ----------------------------

    def _election(self, method: str, params: Dict, token: Optional[str]):
        from ..server.v3election import LeaderKey

        s = self.srv.s
        es = s.election_server

        def dec_leader(d: Dict) -> LeaderKey:
            return LeaderKey(
                name=bytes.fromhex(d["name"]), key=bytes.fromhex(d["key"]),
                rev=d["rev"], lease=d["lease"])

        def enc_leader(lk: LeaderKey) -> Dict:
            return {"name": lk.name.hex(), "key": lk.key.hex(),
                    "rev": lk.rev, "lease": lk.lease}

        if method == "Campaign":
            lk = es.campaign(
                bytes.fromhex(params["name"]), params["lease"],
                bytes.fromhex(params.get("value", "")),
                timeout=params.get("timeout") or 24 * 3600.0, token=token)
            return {"leader": enc_leader(lk), "revision": s.kv.rev()}
        if method == "Proclaim":
            es.proclaim(dec_leader(params["leader"]),
                        bytes.fromhex(params.get("value", "")), token=token)
            return {"revision": s.kv.rev()}
        if method == "Resign":
            es.resign(dec_leader(params["leader"]), token=token)
            return {"revision": s.kv.rev()}
        if method == "Leader":
            kv = es.leader(bytes.fromhex(params["name"]), token=token)
            return {"kv": wire.enc(kv), "revision": s.kv.rev()}
        if method == "Observe":
            with self._obs_lock:
                oid = self._next_observe_id
                self._next_observe_id += 1
                stop = threading.Event()
                self._observers[oid] = stop
            name = bytes.fromhex(params["name"])

            def pump() -> None:
                def push(kv) -> bool:
                    return self._send({"ostream": oid, "kv": wire.enc(kv)})

                try:
                    es.observe(name, push, stop, token=token)
                finally:
                    with self._obs_lock:
                        self._observers.pop(oid, None)

            threading.Thread(target=pump, daemon=True,
                             name=f"observe-{oid}").start()
            return {"observe_id": oid}
        if method == "ObserveCancel":
            with self._obs_lock:
                stop = self._observers.pop(params["observe_id"], None)
            if stop is not None:
                stop.set()
            return {}
        raise ValueError(f"unknown election method {method!r}")

    # -- watch (watch.go stream loops) ----------------------------------------

    def _watch_create(self, params: Dict) -> Dict:
        s = self.srv.s
        if self.watch_stream is None:
            self.watch_stream = s.kv.new_watch_stream()
            self._watch_poller = threading.Thread(
                target=self._watch_push_loop, daemon=True
            )
            self._watch_poller.start()
        key = bytes.fromhex(params["key"])
        end_hex = params.get("range_end", "")
        end = bytes.fromhex(end_hex) if end_hex else None
        if end == b"\x00":
            end = b""  # open end: every key ≥ key (the \x00 sentinel)
        wid = self.watch_stream.watch(
            key, end, start_rev=params.get("start_revision", 0)
        )
        return {"watch_id": wid, "revision": s.kv.rev()}

    def _watch_push_loop(self) -> None:
        ws = self.watch_stream
        while not self.srv._stopped.is_set():
            resp = ws.poll(timeout=0.2)
            if resp is None:
                continue
            ok = self._send(
                {
                    "stream": resp.watch_id,
                    "event": {
                        "revision": resp.revision,
                        "events": [wire.enc_event(ev) for ev in resp.events],
                    },
                }
            )
            if not ok:
                return
