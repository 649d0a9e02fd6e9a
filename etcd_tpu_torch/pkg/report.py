"""Benchmark result collection: throughput + latency percentiles.

The load-generator analog of pkg/report/report.go — collect per-request
durations, then render totals, QPS, and p50/p90/p95/p99/p99.9.

Ports ``etcd_tpu/pkg/report.py``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class Stats:
    total_s: float
    count: int
    errors: int
    qps: float
    avg_ms: float
    min_ms: float
    max_ms: float
    percentiles_ms: Dict[str, float]

    def to_dict(self) -> Dict:
        return {
            "total_s": self.total_s,
            "count": self.count,
            "errors": self.errors,
            "qps": self.qps,
            "avg_ms": self.avg_ms,
            "min_ms": self.min_ms,
            "max_ms": self.max_ms,
            **{f"p{k}_ms": v for k, v in self.percentiles_ms.items()},
        }


class Report:
    PERCENTILES = (50, 90, 95, 99, 99.9)

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._durations: List[float] = []
        self._errors = 0
        self._t0 = time.monotonic()

    def results(self, duration_s: float, err: Exception | None = None) -> None:
        with self._lock:
            if err is not None:
                self._errors += 1
            else:
                self._durations.append(duration_s)

    def timed(self, fn, *args, **kwargs):
        t0 = time.monotonic()
        try:
            out = fn(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 — load generator records all
            self.results(time.monotonic() - t0, e)
            raise
        self.results(time.monotonic() - t0)
        return out

    def stats(self) -> Stats:
        with self._lock:
            durs = sorted(self._durations)
            errors = self._errors
        total = time.monotonic() - self._t0
        n = len(durs)
        if n == 0:
            return Stats(total, 0, errors, 0.0, 0.0, 0.0, 0.0,
                         {str(p): 0.0 for p in self.PERCENTILES})
        pct = {}
        for p in self.PERCENTILES:
            idx = min(n - 1, int(n * p / 100.0))
            pct[str(p)] = durs[idx] * 1000
        return Stats(
            total_s=total,
            count=n,
            errors=errors,
            qps=n / total if total > 0 else 0.0,
            avg_ms=sum(durs) / n * 1000,
            min_ms=durs[0] * 1000,
            max_ms=durs[-1] * 1000,
            percentiles_ms=pct,
        )

    def render(self) -> str:
        s = self.stats()
        lines = [
            f"Summary:",
            f"  Total:\t{s.total_s:.4f} s",
            f"  Requests:\t{s.count} (errors {s.errors})",
            f"  Throughput:\t{s.qps:.1f} req/s",
            f"  Avg:\t{s.avg_ms:.3f} ms   Min: {s.min_ms:.3f} ms   Max: {s.max_ms:.3f} ms",
            "Latency distribution:",
        ]
        for p, v in s.percentiles_ms.items():
            lines.append(f"  p{p}:\t{v:.3f} ms")
        return "\n".join(lines)
