"""Auto-compaction (ref: server/etcdserver/api/v3compactor/).

Periodic mode: every interval, compact to the revision observed
interval-ago (periodic.go — revision window ring). Revision mode: keep
the latest N revisions (revision.go). Both drive the server's Compact
through raft so all members see the same compaction.

Ports ``etcd_tpu/server/compactor.py``."""

from __future__ import annotations

import threading
import time
from typing import Callable, List


class Compactor:
    def __init__(self, check_interval: float = 60.0) -> None:
        self._stop = threading.Event()
        self._thread: threading.Thread = threading.Thread(
            target=self._run, daemon=True
        )
        self.check_interval = check_interval
        self._paused = threading.Event()

    def run(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def pause(self) -> None:
        self._paused.set()

    def resume(self) -> None:
        self._paused.clear()

    def _run(self) -> None:
        while not self._stop.wait(self.check_interval):
            if not self._paused.is_set():
                self._tick()

    def _tick(self) -> None:
        raise NotImplementedError


class PeriodicCompactor(Compactor):
    """Compact to the revision seen `retention` seconds ago
    (ref: v3compactor/periodic.go)."""

    def __init__(
        self,
        retention_s: float,
        rev_fn: Callable[[], int],
        compact_fn: Callable[[int], None],
        check_interval: float = None,  # type: ignore[assignment]
    ) -> None:
        # The reference polls at retention/10 (periodic.go getRetryInterval).
        super().__init__(check_interval or max(retention_s / 10.0, 0.05))
        self.retention = retention_s
        self.rev_fn = rev_fn
        self.compact_fn = compact_fn
        self._window: List[tuple] = []  # (time, rev)
        self._last_compacted = 0

    def _tick(self) -> None:
        now = time.monotonic()
        self._window.append((now, self.rev_fn()))
        cutoff = now - self.retention
        target = None
        while self._window and self._window[0][0] <= cutoff:
            target = self._window.pop(0)[1]
        if target is not None and target > self._last_compacted:
            try:
                self.compact_fn(target)
                self._last_compacted = target
            except Exception:  # noqa: BLE001 — retried next pass
                pass


class RevisionCompactor(Compactor):
    """Keep the latest `retention` revisions (ref: v3compactor/revision.go)."""

    def __init__(
        self,
        retention_revs: int,
        rev_fn: Callable[[], int],
        compact_fn: Callable[[int], None],
        check_interval: float = 5.0,
    ) -> None:
        super().__init__(check_interval)
        self.retention = retention_revs
        self.rev_fn = rev_fn
        self.compact_fn = compact_fn
        self._last_compacted = 0

    def _tick(self) -> None:
        target = self.rev_fn() - self.retention
        if target > self._last_compacted and target > 0:
            try:
                self.compact_fn(target)
                self._last_compacted = target
            except Exception:  # noqa: BLE001
                pass


def new_compactor(mode: str, retention: float, rev_fn, compact_fn) -> Compactor:
    if mode == "periodic":
        return PeriodicCompactor(retention, rev_fn, compact_fn)
    if mode == "revision":
        return RevisionCompactor(int(retention), rev_fn, compact_fn)
    raise ValueError(f"unknown compaction mode {mode!r}")
