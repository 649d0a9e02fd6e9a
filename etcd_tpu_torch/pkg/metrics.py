"""Prometheus-style metrics registry with text exposition
(ref: the prometheus client usage throughout server/etcdserver/metrics.go,
server/storage/mvcc/metrics.go, rafthttp/metrics.go; served at /metrics
by embed/etcd.go:731 and etcdhttp).

Only the pieces etcd actually uses: Counter, Gauge, Histogram, const
labels, label children, and the `/metrics` text format. No external
dependency — the exposition format is the contract.

Ports ``etcd_tpu/pkg/metrics.py`` whole. Its ``DEFAULT`` registry is the
port's own: a metric the port registers never lands in etcd_tpu's.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# Default histogram buckets (prometheus DefBuckets).
DEF_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _fmt_labels(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    inner = ",".join(
        f'{n}="{_escape(v)}"' for n, v in zip(names, values)
    )
    return "{" + inner + "}"


def _escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == int(v):
        return str(int(v))
    return repr(v)


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_: str, labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help_
        self.labelnames = tuple(labelnames)
        self._children: Dict[Tuple[str, ...], "_Metric"] = {}
        self._lock = threading.Lock()

    def labels(self, *values: str, **kv: str):
        if kv:
            values = tuple(kv[n] for n in self.labelnames)
        key = tuple(str(v) for v in values)
        if len(key) != len(self.labelnames):
            raise ValueError(f"{self.name}: want {self.labelnames}, got {key}")
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._new_child()
                child._labelvalues = key  # type: ignore[attr-defined]
                self._children[key] = child
            return child

    def _new_child(self) -> "_Metric":
        return type(self)(self.name, self.help)

    def _samples(self) -> Iterable[Tuple[str, Sequence[str], Sequence[str], float]]:
        raise NotImplementedError

    def expose(self) -> List[str]:
        lines = [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} {self.kind}",
        ]
        if self.labelnames:
            with self._lock:
                children = list(self._children.items())
            for key, child in children:
                for suffix, ln, lv, val in child._samples():
                    lines.append(
                        f"{self.name}{suffix}"
                        f"{_fmt_labels(tuple(self.labelnames) + tuple(ln), key + tuple(lv))}"
                        f" {_fmt_value(val)}"
                    )
        else:
            for suffix, ln, lv, val in self._samples():
                lines.append(
                    f"{self.name}{suffix}{_fmt_labels(ln, lv)} {_fmt_value(val)}"
                )
        return lines


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name: str, help_: str, labelnames: Sequence[str] = ()):
        super().__init__(name, help_, labelnames)
        self._value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError("counter cannot decrease")
        with self._lock:
            self._value += v

    def value(self) -> float:
        with self._lock:
            return self._value

    def _samples(self):
        yield ("", (), (), self.value())


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name: str, help_: str, labelnames: Sequence[str] = ()):
        super().__init__(name, help_, labelnames)
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self._value += v

    def dec(self, v: float = 1.0) -> None:
        with self._lock:
            self._value -= v

    def set_to_current_time(self) -> None:
        self.set(time.time())

    def value(self) -> float:
        with self._lock:
            return self._value

    def _samples(self):
        yield ("", (), (), self.value())


class Histogram(_Metric):
    kind = "histogram"

    def __init__(
        self,
        name: str,
        help_: str,
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] = DEF_BUCKETS,
    ):
        super().__init__(name, help_, labelnames)
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)  # +Inf tail
        self._sum = 0.0
        self._count = 0

    def _new_child(self) -> "_Metric":
        return Histogram(self.name, self.help, buckets=self.buckets)

    def observe(self, v: float) -> None:
        self.observe_many(v, 1)

    def observe_many(self, v: float, n: int) -> None:
        """Fold `n` observations of value `v` in one lock acquisition —
        the pre-bucketed ingest path for device-side histograms (the
        fleet summary frame arrives as bucket counts, not samples;
        calling observe() count-times would be O(rows) per frame)."""
        if n <= 0:
            return
        with self._lock:
            self._sum += v * n
            self._count += n
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self._counts[i] += n
                    return
            self._counts[-1] += n

    def time(self):
        return _Timer(self)

    def _samples(self):
        with self._lock:
            counts = list(self._counts)
            total = self._count
            s = self._sum
        cum = 0
        for b, c in zip(self.buckets, counts):
            cum += c
            yield ("_bucket", ("le",), (_fmt_value(b),), cum)
        yield ("_bucket", ("le",), ("+Inf",), total)
        yield ("_sum", (), (), s)
        yield ("_count", (), (), total)


class _Timer:
    def __init__(self, h: Histogram):
        self.h = h

    def __enter__(self):
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self.h.observe(time.monotonic() - self.t0)


class Registry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def register(self, m: _Metric) -> _Metric:
        with self._lock:
            existing = self._metrics.get(m.name)
            if existing is not None:
                return existing
            self._metrics[m.name] = m
            return m

    def unregister(self, name: str) -> None:
        with self._lock:
            self._metrics.pop(name, None)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def expose(self) -> str:
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        lines: List[str] = []
        for m in metrics:
            lines.extend(m.expose())
        return "\n".join(lines) + "\n"


DEFAULT = Registry()


def counter(name: str, help_: str, labelnames: Sequence[str] = ()) -> Counter:
    return DEFAULT.register(Counter(name, help_, labelnames))  # type: ignore[return-value]


def gauge(name: str, help_: str, labelnames: Sequence[str] = ()) -> Gauge:
    return DEFAULT.register(Gauge(name, help_, labelnames))  # type: ignore[return-value]


def histogram(
    name: str,
    help_: str,
    labelnames: Sequence[str] = (),
    buckets: Sequence[float] = DEF_BUCKETS,
) -> Histogram:
    return DEFAULT.register(Histogram(name, help_, labelnames, buckets))  # type: ignore[return-value]
