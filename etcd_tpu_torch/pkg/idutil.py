"""Cluster-unique, roughly-time-ordered request id generator.

Layout (64 bits): [16-bit member prefix | 40-bit unix-millis | 8-bit
counter] — same shape and guarantees as the reference's generator
(ref: pkg/idutil/id.go:20-55): ids from different members never collide,
ids from one member are strictly increasing, and ~256 ids/ms/member are
available before the counter bleeds into the timestamp (which keeps
monotonicity, just borrows from future milliseconds).

Ports ``etcd_tpu/pkg/idutil.py``.
"""

from __future__ import annotations

import threading
import time

_TS_BITS = 40
_CNT_BITS = 8
_SUFFIX_BITS = _TS_BITS + _CNT_BITS
_TS_MASK = (1 << _TS_BITS) - 1
_SUFFIX_MASK = (1 << _SUFFIX_BITS) - 1


class Generator:
    def __init__(self, member_id: int, now_ms: int | None = None) -> None:
        if now_ms is None:
            now_ms = int(time.time() * 1000)
        self._prefix = (member_id & 0xFFFF) << _SUFFIX_BITS
        self._suffix = (now_ms & _TS_MASK) << _CNT_BITS
        self._lock = threading.Lock()

    def next(self) -> int:
        with self._lock:
            self._suffix = (self._suffix + 1) & _SUFFIX_MASK
            return self._prefix | self._suffix
