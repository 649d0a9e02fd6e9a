"""FIFO job scheduler for the apply pipeline.

Jobs run strictly in submission order on one worker thread; ``stop``
drains nothing — it cancels pending jobs and joins the in-flight one,
mirroring the reference scheduler the server feeds ``applyAll`` through
(ref: pkg/schedule/schedule.go, used at server/etcdserver/server.go:742).

Ports ``etcd_tpu/pkg/schedule.py``; its logger is named after this package.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Optional


class FIFOScheduler:
    def __init__(self, name: str = "fifo") -> None:
        self._q: "queue.Queue[Optional[Callable[[], None]]]" = queue.Queue()
        self._scheduled = 0
        self._finished = 0
        self._lock = threading.Lock()
        self._stopped = False
        self._worker = threading.Thread(target=self._run, name=name, daemon=True)
        self._worker.start()

    def schedule(self, job: Callable[[], None]) -> None:
        with self._lock:
            if self._stopped:
                raise RuntimeError("scheduler stopped")
            self._scheduled += 1
            self._q.put(job)

    def pending(self) -> int:
        with self._lock:
            return self._scheduled - self._finished

    def scheduled(self) -> int:
        with self._lock:
            return self._scheduled

    def finished(self) -> int:
        with self._lock:
            return self._finished

    def wait_finish(self, n: int, timeout: float = 30.0) -> None:
        import time

        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.finished() >= n:
                return
            time.sleep(0.001)
        raise TimeoutError(f"scheduler did not finish {n} jobs")

    def stop(self) -> None:
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            # Cancel unstarted jobs: drain the queue and count them as
            # finished so pending() converges; only the in-flight job
            # (if any) runs to completion before join returns.
            cancelled = 0
            try:
                while True:
                    self._q.get_nowait()
                    cancelled += 1
            except queue.Empty:
                pass
            self._finished += cancelled
            self._q.put(None)
        self._worker.join()

    def _run(self) -> None:
        while True:
            job = self._q.get()
            if job is None:
                return
            try:
                job()
            except Exception:  # noqa: BLE001 — a failed job must not kill the pipeline
                import logging

                logging.getLogger("etcd_tpu_torch.schedule").exception(
                    "scheduled job failed"
                )
            finally:
                with self._lock:
                    self._finished += 1
