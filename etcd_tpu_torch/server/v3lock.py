"""Server-side lock service layered on the Mutex recipe through the
loopback client (ref: server/etcdserver/api/v3lock/v3lock.go:28-55 —
Lock builds a session around the caller's lease, locks the mutex, and
returns the ownership key; Unlock deletes it).

Ports ``etcd_tpu/server/v3lock.py``."""

from __future__ import annotations

from typing import Optional

from ..client.concurrency import Mutex, Session
from .v3client import LocalClient


class LockServer:
    def __init__(self, server) -> None:
        self.s = server

    def lock(self, name: bytes, lease: int,
             timeout: Optional[float] = None,
             token: Optional[str] = None) -> bytes:
        """Blocks until the caller's lease owns ``name``; returns the
        ownership key whose existence is tied to the lease
        (v3lock.go:28-46)."""
        c = LocalClient(self.s, token=token)
        sess = Session.from_lease(c, lease)
        m = Mutex(sess, name.decode())
        m.lock(timeout=timeout)
        return m.my_key

    def unlock(self, key: bytes, token: Optional[str] = None) -> None:
        """v3lock.go:48-55 — delete the ownership key."""
        LocalClient(self.s, token=token).delete(key)
