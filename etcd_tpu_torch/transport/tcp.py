"""TCP peer transport (ref: server/etcdserver/api/rafthttp/transport.go,
peer.go, stream.go, pipeline.go, snapshot_sender.go).

Semantics preserved from the reference:

* one **ordered stream** per peer: a writer thread drains a bounded
  queue over a persistent connection — congested queues **drop**
  messages instead of blocking raft (raftNodeConfig comment,
  etcdserver/raft.go:108-111); raft's retries recover;
* a **pipeline** path for big/rare messages (MsgSnap): one-shot
  connections on worker threads so a slow snapshot never head-of-line
  blocks heartbeats (pipeline.go, 4 workers);
* **probing/ActiveSince**: reconnect loop tracks when a peer became
  reachable; send errors surface to raft via report_unreachable /
  report_snapshot (peer status, probing_status.go);
* **fault injection**: pause/resume per peer (rafthttp.Pausable,
  transport.go:420-441) and drop filters, used by the integration
  bridge-style tests.

Wire format: 16-byte hello (cluster_id, from_id) then length-prefixed
message frames (codec.py).

Ports ``etcd_tpu/transport/tcp.py``.
"""

from __future__ import annotations

import queue
import random
import socket
import ssl
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..raft.types import Message, MessageType
from . import metrics as smet
from .codec import MAX_FRAME, decode_message, encode_message

STREAM_BUF = 4096  # queued msgs per peer (streamBufSize stream.go:32)
PIPELINE_WORKERS = 4  # pipeline.go connPerPipeline
RECONNECT_INTERVAL = 0.1
_HELLO = struct.Struct("<QQ")
# First payload byte of a peer-RPC control frame; raft MessageType
# values stay well below 0xFF, so the channel is unambiguous.
CONTROL_BYTE = b"\xff"


def _is_snap(m: Message) -> bool:
    return m.type == MessageType.MsgSnap


class _Peer:
    """Outbound half of a peer (ref: rafthttp/peer.go:63-130)."""

    def __init__(self, transport: "TCPTransport", peer_id: int, addr: Tuple[str, int]):
        self.t = transport
        self.id = peer_id
        self.addr = addr
        self.q: "queue.Queue[Optional[Message]]" = queue.Queue(maxsize=STREAM_BUF)
        self.snap_q: "queue.Queue[Optional[Message]]" = queue.Queue(maxsize=16)
        self.paused = False
        self.active_since: float = 0.0
        self._stopped = threading.Event()
        self._writer = threading.Thread(target=self._stream_loop, daemon=True)
        self._snap_workers = [
            threading.Thread(target=self._pipeline_loop, daemon=True)
            for _ in range(PIPELINE_WORKERS)
        ]
        self._writer.start()
        for w in self._snap_workers:
            w.start()

    def send(self, m: Message) -> None:
        if self.paused:
            return
        q = self.snap_q if _is_snap(m) else self.q
        try:
            q.put_nowait(m)
        except queue.Full:
            # Drop, never block (etcdserver/raft.go:108-111). Raft's
            # probe/retry machinery recovers; tell it now.
            self.t._report_unreachable(self.id)

    def stop(self) -> None:
        self._stopped.set()
        for q in (self.q, self.snap_q):
            try:
                q.put_nowait(None)
            except queue.Full:
                pass

    # -- stream (persistent conn, ordered) ------------------------------------

    def _stream_loop(self) -> None:
        sock: Optional[socket.socket] = None
        while not self._stopped.is_set():
            m = self.q.get()
            if m is None or self._stopped.is_set():
                break
            frame = encode_message(m)
            sent = False
            for _attempt in (0, 1):
                if sock is None:
                    sock = self._dial()
                    if sock is None:
                        self.t._report_unreachable(self.id)
                        break  # drop m
                try:
                    sock.sendall(frame)
                    smet.peer_sent_bytes.labels(str(self.id)).inc(len(frame))
                    sent = True
                    break
                except OSError:
                    try:
                        sock.close()
                    except OSError:
                        pass
                    sock = None
                    self.active_since = 0.0
            if not sent:
                smet.peer_sent_failures.labels(str(self.id)).inc()
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def _pipeline_loop(self) -> None:
        """One-shot connection per big message (rafthttp/pipeline.go)."""
        while not self._stopped.is_set():
            m = self.snap_q.get()
            if m is None or self._stopped.is_set():
                return
            ok = False
            s = self._dial()
            if s is not None:
                try:
                    s.sendall(encode_message(m))
                    ok = True
                except OSError:
                    pass
                finally:
                    try:
                        s.close()
                    except OSError:
                        pass
            if _is_snap(m):
                self.t._report_snapshot(self.id, failure=not ok)
            if not ok:
                self.t._report_unreachable(self.id)

    def _dial(self) -> Optional[socket.socket]:
        try:
            s = socket.create_connection(self.addr, timeout=2.0)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            if self.t._client_ssl is not None:
                # Peer channel TLS (ref: rafthttp dials through
                # transport.TLSInfo ClientConfig, listener.go:376).
                s = self.t._client_ssl.wrap_socket(
                    s, server_hostname=self.t._tls_server_name or self.addr[0])
            s.sendall(_HELLO.pack(self.t.cluster_id, self.t.member_id))
            if self.active_since == 0.0:
                self.active_since = time.monotonic()
            return s
        except OSError:  # covers ssl.SSLError
            return None


class TCPTransport:
    """ref: rafthttp/transport.go:97-132 Transport."""

    def __init__(
        self,
        member_id: int,
        cluster_id: int = 0,
        bind: Tuple[str, int] = ("127.0.0.1", 0),
        tls_info=None,
    ) -> None:
        self.member_id = member_id
        self.cluster_id = cluster_id
        # Peer-channel TLS both ways (ref: --peer-cert-file/--peer-key-file,
        # listener.go NewTLSListener on the server side).
        self._server_ssl = self._client_ssl = None
        self._tls_server_name = ""
        if tls_info is not None and not tls_info.empty():
            self._server_ssl = tls_info.server_context()
            self._client_ssl = tls_info.client_context()
            self._tls_server_name = tls_info.server_name
        self._lock = threading.Lock()
        self._peers: Dict[int, _Peer] = {}
        self._handler: Optional[Callable[[Message], None]] = None
        self._raft_reporter = None  # object with report_unreachable/report_snapshot
        self._stopped = threading.Event()
        self._drop: Dict[int, float] = {}  # peer_id -> drop probability (recv side)
        self._rand = random.Random(0)
        self._conns: List[socket.socket] = []  # accepted, closed on stop

        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(bind)
        self._listener.listen(64)
        self.addr: Tuple[str, int] = self._listener.getsockname()
        self._accept_thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._accept_thread.start()

    # -- the network interface used by EtcdServer ------------------------------

    def register(self, node_id: int, handler: Callable[[Message], None],
                 reporter=None) -> None:
        assert node_id == self.member_id, "TCPTransport is per-member"
        self._handler = handler
        if reporter is not None and self._raft_reporter is None:
            # Wire snapshot-status reporting immediately so a server
            # that never calls set_raft_reporter (the richer node-object
            # path, which also feeds ReportUnreachable and overwrites
            # this) still unsticks StateSnapshot progress on failures.
            class _SnapOnly:
                @staticmethod
                def report_snapshot(vid: int, failure: bool) -> None:
                    reporter(vid, failure)

                @staticmethod
                def report_unreachable(vid: int) -> None:
                    pass

            self._raft_reporter = _SnapOnly()
            self._reporter_from_register = True

    def unregister(self, node_id: int) -> None:
        self._handler = None
        if getattr(self, "_reporter_from_register", False):
            # Drop the register()-installed reporter so a server
            # re-registered on this transport wires its OWN node, not
            # the dead predecessor's.
            self._raft_reporter = None
            self._reporter_from_register = False

    def send(self, _from_id: int, msgs: List[Message]) -> None:
        """ref: transport.go:175 Send — route each message to its peer."""
        for m in msgs:
            if m.to == self.member_id:
                if self._handler is not None:
                    self._handler(m)
                continue
            with self._lock:
                p = self._peers.get(m.to)
            if p is not None:
                p.send(m)

    def set_raft_reporter(self, node) -> None:
        """Wire ReportUnreachable/ReportSnapshot back into raft
        (ref: node.go:535-549 via transport error paths)."""
        self._raft_reporter = node

    # -- peer management (transport.go:295 AddPeer) ----------------------------

    def add_peer(self, peer_id: int, addr: Tuple[str, int]) -> None:
        with self._lock:
            if peer_id in self._peers or peer_id == self.member_id:
                return
            self._peers[peer_id] = _Peer(self, peer_id, tuple(addr))

    def remove_peer(self, peer_id: int) -> None:
        with self._lock:
            p = self._peers.pop(peer_id, None)
        if p is not None:
            p.stop()

    def update_peer(self, peer_id: int, addr: Tuple[str, int]) -> None:
        self.remove_peer(peer_id)
        self.add_peer(peer_id, addr)

    def active_since(self, peer_id: int) -> float:
        with self._lock:
            p = self._peers.get(peer_id)
        return p.active_since if p is not None else 0.0

    # -- fault injection (rafthttp.Pausable + bridge drops) --------------------

    def pause_sending(self, peer_id: Optional[int] = None) -> None:
        with self._lock:
            for pid, p in self._peers.items():
                if peer_id is None or pid == peer_id:
                    p.paused = True

    def resume_sending(self, peer_id: Optional[int] = None) -> None:
        with self._lock:
            for pid, p in self._peers.items():
                if peer_id is None or pid == peer_id:
                    p.paused = False

    def drop_from(self, peer_id: int, prob: float) -> None:
        """Drop incoming messages from peer_id with probability prob."""
        with self._lock:
            self._drop[peer_id] = prob

    # -- inbound ---------------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            with self._lock:
                self._conns.append(conn)
            threading.Thread(
                target=self._recv_loop, args=(conn,), daemon=True
            ).start()

    def _recv_loop(self, conn: socket.socket) -> None:
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            if self._server_ssl is not None:
                # Handshake on the per-conn thread so a stalled dialer
                # can't block the accept loop.
                try:
                    conn = self._server_ssl.wrap_socket(conn, server_side=True)
                except OSError:  # covers ssl.SSLError
                    return
            hello = self._read_exact(conn, _HELLO.size)
            if hello is None:
                return
            cid, from_id = _HELLO.unpack(hello)
            if cid != self.cluster_id:
                return  # cluster-id mismatch rejected (http.go checks)
            while not self._stopped.is_set():
                ln_b = self._read_exact(conn, 4)
                if ln_b is None:
                    return
                (ln,) = struct.unpack("<I", ln_b)
                if ln > MAX_FRAME:
                    return
                payload = self._read_exact(conn, ln)
                if payload is None:
                    return
                smet.peer_received_bytes.labels(str(from_id)).inc(4 + ln)
                with self._lock:
                    drop = self._drop.get(from_id, 0.0)
                if drop and self._rand.random() < drop:
                    continue
                if payload[:1] == CONTROL_BYTE:
                    # Peer-RPC side channel (the analog of the extra
                    # handlers on the reference's peer listener —
                    # hashKVHandler etc., corrupt.go:261).
                    resp = self._handle_control(payload[1:])
                    try:
                        conn.sendall(struct.pack("<I", len(resp)) + resp)
                    except OSError:
                        return
                    continue
                m = decode_message(payload)
                h = self._handler
                if h is not None:
                    try:
                        h(m)
                    except Exception:  # noqa: BLE001
                        pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    # -- peer-RPC control channel ----------------------------------------------

    def set_hash_provider(self, fn: Callable[[], Tuple[int, int, int]]) -> None:
        """fn() -> (hash, revision, compact_revision) — the tuple order
        of mvcc ``hash_kv``; served to peers asking over the control
        channel (ref: corrupt.go:261 hashKVHandler on the peer
        listener)."""
        self._hash_provider = fn

    def _handle_control(self, body: bytes) -> bytes:
        import json

        try:
            req = json.loads(body)
        except ValueError:
            return b"{}"
        if req.get("op") == "hashkv":
            fn = getattr(self, "_hash_provider", None)
            if fn is None:
                return b"{}"
            try:
                h, rev, crev = fn()
            except Exception:  # noqa: BLE001
                return b"{}"
            return json.dumps({
                "member_id": self.member_id, "hash": h,
                "compact_revision": crev, "revision": rev,
            }).encode()
        return b"{}"

    def peer_hash_kv(self, peer_id: int, timeout: float = 3.0):
        """One-shot control query to a peer's listener; None when the
        peer is unreachable or doesn't answer."""
        import json

        with self._lock:
            p = self._peers.get(peer_id)
        if p is None:
            return None
        try:
            s = p._dial()
            if s is None:
                return None
            try:
                s.settimeout(timeout)
                body = CONTROL_BYTE + json.dumps({"op": "hashkv"}).encode()
                s.sendall(struct.pack("<I", len(body)) + body)
                ln_b = self._read_exact(s, 4)
                if ln_b is None:
                    return None
                (ln,) = struct.unpack("<I", ln_b)
                if ln > MAX_FRAME:
                    return None
                resp = self._read_exact(s, ln)
                if resp is None:
                    return None
                out = json.loads(resp)
                return out if "hash" in out else None
            finally:
                try:
                    s.close()
                except OSError:
                    pass
        except (OSError, ValueError):
            return None

    @staticmethod
    def _read_exact(conn: socket.socket, n: int) -> Optional[bytes]:
        buf = b""
        while len(buf) < n:
            try:
                chunk = conn.recv(n - len(buf))
            except OSError:
                return None
            if not chunk:
                return None
            buf += chunk
        return buf

    # -- raft feedback ---------------------------------------------------------

    def _report_unreachable(self, peer_id: int) -> None:
        r = self._raft_reporter
        if r is not None:
            try:
                r.report_unreachable(peer_id)
            except Exception:  # noqa: BLE001
                pass

    def _report_snapshot(self, peer_id: int, failure: bool) -> None:
        r = self._raft_reporter
        if r is not None:
            try:
                r.report_snapshot(peer_id, failure)
            except Exception:  # noqa: BLE001
                pass

    def stop(self) -> None:
        self._stopped.set()
        try:
            # shutdown() wakes the thread blocked in accept(); a bare
            # close() would leave the fd held by the syscall and the
            # port in LISTEN until process exit.
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            peers = list(self._peers.values())
            self._peers.clear()
            conns = list(self._conns)
            self._conns.clear()
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        for p in peers:
            p.stop()
