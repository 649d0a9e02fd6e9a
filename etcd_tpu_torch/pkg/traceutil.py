"""Request tracing: named steps with timestamps, logged only when slow.

The server threads a Trace through the apply/range/txn paths and logs it
only if total duration crosses a threshold, with per-step breakdown
(ref: pkg/traceutil/trace.go:56-153; the 100ms threshold use at
server/etcdserver/v3_server.go:752).

Ports ``etcd_tpu/pkg/traceutil.py``; its logger is named after the
port's package.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional

_local = threading.local()


class Trace:
    def __init__(self, operation: str, logger: Optional[logging.Logger] = None,
                 **fields: Any) -> None:
        self.operation = operation
        self.logger = logger or logging.getLogger("etcd_tpu_torch.trace")
        self.fields: Dict[str, Any] = dict(fields)
        self.start = time.monotonic()
        self.steps: List[tuple[str, float, Dict[str, Any]]] = []

    def step(self, msg: str, **fields: Any) -> None:
        self.steps.append((msg, time.monotonic(), fields))

    def add_field(self, **fields: Any) -> None:
        self.fields.update(fields)

    def duration(self) -> float:
        return time.monotonic() - self.start

    def log_if_long(self, threshold: float) -> bool:
        total = self.duration()
        if total < threshold:
            return False
        lines = [
            f"trace[{self.operation}] took {total*1000:.1f}ms "
            f"(threshold {threshold*1000:.0f}ms) {self.fields}"
        ]
        prev = self.start
        for msg, ts, fields in self.steps:
            lines.append(f"  step [{msg}] +{(ts-prev)*1000:.1f}ms {fields or ''}")
            prev = ts
        self.logger.warning("\n".join(lines))
        return True


def todo() -> Trace:
    """A throwaway trace for paths that don't carry one yet."""
    return Trace("TODO")


def get() -> Trace:
    """The ambient trace for this thread (or a fresh TODO trace)."""
    t = getattr(_local, "trace", None)
    return t if t is not None else todo()


def set_ambient(trace: Optional[Trace]) -> None:
    _local.trace = trace
