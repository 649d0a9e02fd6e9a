"""Userspace L4 forwarder: the `etcd gateway`
(ref: server/proxy/tcpproxy/userspace.go, etcdmain/gateway.go).

Each accepted connection is forwarded whole to one backend endpoint,
picked round-robin over the healthy set. A dial failure marks the
endpoint inactive for ``monitor_interval`` and the dial retries the
next endpoint (userspace.go remote.inactivate/tryReactivate).

Ports ``etcd_tpu/proxy/tcpproxy.py``, with one difference: the 2 s
timeout of a backend dial bounds the dial alone. The reference keeps it
on the connection, so an answer that takes longer (a linearizable read
while the members elect a leader) closed the client's connection
(ROADMAP C22); etcd's gateway sets no deadline on the copy
(userspace.go).
"""

from __future__ import annotations

import socket
import threading
import time
from typing import List, Optional, Tuple


class _Remote(object):
    def __init__(self, addr: Tuple[str, int]) -> None:
        self.addr = addr
        self.active = True
        self.deactivated_at = 0.0

    def inactivate(self) -> None:
        self.active = False
        self.deactivated_at = time.monotonic()


class TCPProxy:
    def __init__(
        self,
        endpoints: List[Tuple[str, int]],
        bind: Tuple[str, int] = ("127.0.0.1", 0),
        monitor_interval: float = 5.0,
    ) -> None:
        if not endpoints:
            raise ValueError("no endpoints")
        self.remotes = [_Remote(tuple(ep)) for ep in endpoints]
        self.monitor_interval = monitor_interval
        self._next = 0
        self._lock = threading.Lock()
        self._stopped = threading.Event()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(bind)
        self._listener.listen(128)
        self.addr = self._listener.getsockname()
        self._threads = [threading.Thread(target=self._accept_loop, daemon=True)]
        self._threads[0].start()

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

    # -- internals -------------------------------------------------------------

    def _pick(self) -> Optional[_Remote]:
        """Round-robin over active remotes; reactivate expired ones
        (userspace.go pick + tryReactivate)."""
        with self._lock:
            now = time.monotonic()
            for r in self.remotes:
                if not r.active and now - r.deactivated_at > self.monitor_interval:
                    r.active = True
            actives = [r for r in self.remotes if r.active]
            if not actives:
                return None
            r = actives[self._next % len(actives)]
            self._next += 1
            return r

    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            threading.Thread(
                target=self._serve, args=(conn,), daemon=True
            ).start()

    def _serve(self, conn: socket.socket) -> None:
        out: Optional[socket.socket] = None
        for _ in range(len(self.remotes)):
            r = self._pick()
            if r is None:
                break
            try:
                out = socket.create_connection(r.addr, timeout=2.0)
                # The timeout bounds the dial alone: a member may take
                # longer to answer (a linearizable read during an
                # election), and the pipe waits for it.
                out.settimeout(None)
                break
            except OSError:
                r.inactivate()
                out = None
        if out is None:
            try:
                conn.close()
            except OSError:
                pass
            return
        t1 = threading.Thread(target=self._pipe, args=(conn, out), daemon=True)
        t2 = threading.Thread(target=self._pipe, args=(out, conn), daemon=True)
        t1.start()
        t2.start()

    @staticmethod
    def _pipe(src: socket.socket, dst: socket.socket) -> None:
        try:
            while True:
                data = src.recv(65536)
                if not data:
                    break
                dst.sendall(data)
        except OSError:
            pass
        finally:
            for s in (src, dst):
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    s.close()
                except OSError:
                    pass
