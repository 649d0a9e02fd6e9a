"""Broadcast notifier: many waiters, one event, re-armed per generation.

Waiters grab the current generation's event; ``notify()`` fires it and
installs a fresh one, so later waiters wait for the *next* occurrence —
the semantics of the reference's channel-swap notifier (ref:
pkg/notify/notify.go, used for firstCommitInTerm at
server/etcdserver/server.go:1835-1844).

Ports ``etcd_tpu/pkg/notify.py``.
"""

from __future__ import annotations

import threading


class Notifier:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._event = threading.Event()

    def receive(self) -> threading.Event:
        with self._lock:
            return self._event

    def notify(self) -> None:
        with self._lock:
            old, self._event = self._event, threading.Event()
        old.set()
