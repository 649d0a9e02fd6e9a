"""Expiry/checkpoint priority queue (ref: server/lease/lease_queue.go).

A lazily-deduplicated min-heap of (time, lease id): stale heap items —
ones whose time no longer matches the lease's registry entry — are
dropped on pop, exactly like the reference's LeaseQueue which keeps one
live entry per lease and lets outdated ones expire on the way out.

Ports ``etcd_tpu/lease/lease_queue.py``.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple


class LeaseQueue:
    def __init__(self) -> None:
        self._heap: List[Tuple[float, int]] = []
        self._registry: Dict[int, float] = {}  # id -> authoritative time

    def push(self, lease_id: int, when: float) -> None:
        self._registry[lease_id] = when
        heapq.heappush(self._heap, (when, lease_id))

    def remove(self, lease_id: int) -> None:
        self._registry.pop(lease_id, None)

    def peek_due(self, now: float) -> Optional[int]:
        """Next lease id due at `now`, or None. Pops stale entries."""
        while self._heap:
            when, lid = self._heap[0]
            live = self._registry.get(lid)
            if live is None or live != when:
                heapq.heappop(self._heap)  # superseded or removed
                continue
            if when > now:
                return None
            return lid
        return None

    def pop(self) -> Optional[int]:
        while self._heap:
            when, lid = heapq.heappop(self._heap)
            if self._registry.get(lid) == when:
                del self._registry[lid]
                return lid
        return None

    def __len__(self) -> int:
        return len(self._registry)

    def __contains__(self, lease_id: int) -> bool:
        return lease_id in self._registry
