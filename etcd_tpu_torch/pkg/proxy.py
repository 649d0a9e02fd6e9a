"""Fault-injecting TCP proxy (ref: pkg/proxy/server.go — the
delay/blackhole/reorder L4 proxy used by functional chaos and
integration tests).

Sits between two endpoints and forwards bytes with injectable faults:

* ``blackhole_tx/rx`` — silently drop traffic in one direction;
* ``delay_tx/rx(latency, jitter)`` — added latency per segment;
* ``pause_accept`` — refuse new connections;
* ``reset_listen`` — drop all current connections.

Ports ``etcd_tpu/pkg/proxy.py``.
"""

from __future__ import annotations

import random
import socket
import threading
import time
from typing import List, Optional, Tuple


class ProxyServer:
    def __init__(self, listen: Tuple[str, int], target: Tuple[str, int]) -> None:
        self.target = target
        self._lock = threading.Lock()
        self._conns: List[socket.socket] = []
        self._stopped = threading.Event()
        self._accept_paused = False
        self._black_tx = False
        self._black_rx = False
        self._lat_tx = (0.0, 0.0)  # (latency, jitter) seconds
        self._lat_rx = (0.0, 0.0)
        self._rand = random.Random(0)

        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(listen)
        self._listener.listen(64)
        self.addr: Tuple[str, int] = self._listener.getsockname()
        threading.Thread(target=self._accept_loop, daemon=True).start()

    # -- fault controls (ref: server.go Blackhole*/Delay*/Pause*) --------------

    def blackhole_tx(self) -> None:
        self._black_tx = True

    def unblackhole_tx(self) -> None:
        self._black_tx = False

    def blackhole_rx(self) -> None:
        self._black_rx = True

    def unblackhole_rx(self) -> None:
        self._black_rx = False

    def blackhole(self) -> None:
        self._black_tx = self._black_rx = True

    def unblackhole(self) -> None:
        self._black_tx = self._black_rx = False

    def delay_tx(self, latency: float, jitter: float = 0.0) -> None:
        self._lat_tx = (latency, jitter)

    def undelay_tx(self) -> None:
        self._lat_tx = (0.0, 0.0)

    def delay_rx(self, latency: float, jitter: float = 0.0) -> None:
        self._lat_rx = (latency, jitter)

    def undelay_rx(self) -> None:
        self._lat_rx = (0.0, 0.0)

    def pause_accept(self) -> None:
        self._accept_paused = True

    def unpause_accept(self) -> None:
        self._accept_paused = False

    def reset_listen(self) -> None:
        """Kill all live connections (ref: ResetListener)."""
        with self._lock:
            conns, self._conns = self._conns, []
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass

    # -- forwarding ------------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                src, _ = self._listener.accept()
            except OSError:
                return
            if self._accept_paused or self._stopped.is_set():
                try:
                    src.close()
                except OSError:
                    pass
                continue
            try:
                dst = socket.create_connection(self.target, timeout=2.0)
            except OSError:
                src.close()
                continue
            with self._lock:
                self._conns.extend((src, dst))
            threading.Thread(
                target=self._pump, args=(src, dst, "tx"), daemon=True
            ).start()
            threading.Thread(
                target=self._pump, args=(dst, src, "rx"), daemon=True
            ).start()

    def _pump(self, a: socket.socket, b: socket.socket, direction: str) -> None:
        try:
            while not self._stopped.is_set():
                try:
                    chunk = a.recv(65536)
                except OSError:
                    break
                if not chunk:
                    break
                black = self._black_tx if direction == "tx" else self._black_rx
                if black:
                    continue  # swallowed
                lat, jit = self._lat_tx if direction == "tx" else self._lat_rx
                if lat > 0:
                    time.sleep(max(0.0, lat + self._rand.uniform(-jit, jit)))
                try:
                    b.sendall(chunk)
                except OSError:
                    break
        finally:
            for s in (a, b):
                try:
                    s.close()
                except OSError:
                    pass

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
        self.reset_listen()
