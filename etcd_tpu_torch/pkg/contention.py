"""Heartbeat-interval contention detector.

The Ready loop records every heartbeat send per peer; if the gap since
the previous send exceeds ``max_duration`` the loop is running late
(disk or CPU contention) and a warning is surfaced (ref:
pkg/contention/contention.go, used at server/etcdserver/raft.go:357-370).

Ports ``etcd_tpu/pkg/contention.py``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Tuple


class TimeoutDetector:
    def __init__(self, max_duration: float) -> None:
        self.max_duration = max_duration
        self._lock = threading.Lock()
        self._records: Dict[int, float] = {}

    def reset(self) -> None:
        with self._lock:
            self._records.clear()

    def observe(self, which: int) -> Tuple[bool, float]:
        """Returns (ok, exceeded_seconds); ok=False when the gap since
        the previous observation of `which` exceeded max_duration."""
        now = time.monotonic()
        with self._lock:
            prev = self._records.get(which)
            self._records[which] = now
        if prev is None:
            return True, 0.0
        exceeded = (now - prev) - self.max_duration
        return exceeded <= 0, max(0.0, exceeded)
