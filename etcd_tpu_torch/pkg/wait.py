"""id → waiter registry used to join a proposal with its apply result.

The server registers a request id before proposing it to raft; when the
committed entry is applied, the applier triggers the id with the result,
waking the RPC thread (ref: pkg/wait/wait.go:33-108, used from
server/etcdserver/v3_server.go:672-733). ``WaitTime`` is the
deadline-keyed variant used by the apply-wait gate
(ref: pkg/wait/wait_time.go).

Ports ``etcd_tpu/pkg/wait.py``.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional


class Wait:
    """Register unique ids, wait on them, trigger them with a value."""

    # Shard the registry lock the way the reference shards its map
    # (wait.go:42 defaultListElementLength) so hot proposal rates don't
    # serialize on one mutex.
    _SHARDS = 16

    def __init__(self) -> None:
        self._locks = [threading.Lock() for _ in range(self._SHARDS)]
        self._maps: list[Dict[int, "_Waiter"]] = [
            {} for _ in range(self._SHARDS)
        ]

    def register(self, wid: int) -> "_Waiter":
        s = wid % self._SHARDS
        with self._locks[s]:
            if wid in self._maps[s]:
                raise RuntimeError(f"dup id {wid:x}")
            w = _Waiter()
            self._maps[s][wid] = w
            return w

    def trigger(self, wid: int, value: Any) -> bool:
        s = wid % self._SHARDS
        with self._locks[s]:
            w = self._maps[s].pop(wid, None)
        if w is None:
            return False
        w.set(value)
        return True

    def is_registered(self, wid: int) -> bool:
        s = wid % self._SHARDS
        with self._locks[s]:
            return wid in self._maps[s]


class _Waiter:
    __slots__ = ("_event", "_value")

    def __init__(self) -> None:
        self._event = threading.Event()
        self._value: Any = None

    def set(self, value: Any) -> None:
        self._value = value
        self._event.set()

    def wait(self, timeout: Optional[float] = None) -> Any:
        if not self._event.wait(timeout):
            raise TimeoutError("wait timed out")
        return self._value

    def done(self) -> bool:
        return self._event.is_set()


class WaitTime:
    """Wait until a logical deadline (an index) has been triggered.

    ``wait(deadline)`` returns an event that fires once ``trigger(t)``
    has been called with ``t >= deadline`` (ref: pkg/wait/wait_time.go:
    the apply-wait used by linearizable reads,
    server/etcdserver/v3_server.go:776-784).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._last: int = 0
        self._pending: Dict[int, threading.Event] = {}

    def wait(self, deadline: int) -> threading.Event:
        with self._lock:
            ev = self._pending.get(deadline)
            if ev is None:
                ev = threading.Event()
                if deadline <= self._last:
                    ev.set()
                else:
                    self._pending[deadline] = ev
            return ev

    def trigger(self, deadline: int) -> None:
        with self._lock:
            self._last = max(self._last, deadline)
            ripe = [d for d in self._pending if d <= deadline]
            for d in ripe:
                self._pending.pop(d).set()
