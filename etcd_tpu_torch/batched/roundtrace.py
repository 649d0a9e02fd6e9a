"""The engine's round tracer: where a replayed round spends its device
time, where the engine's call spends its host time, and how many rounds
an entry takes from offer to commit, on the host's clock.

A CUDA graph of the round holds only its kernels, so the profiler
ranges that the eager round opens (``step.ROUND_PHASE_SCOPES``) are gone
from a replay. The tracer puts marks into the graph itself: an engine
built with ``round_trace=True`` holds two round graphs, an untraced and
a traced variant (keys UNTRACED, TRACED), both captured in its first
closed-loop call, so switching tracing on or off captures nothing
(``engine._replay_traceable`` says why two and not one a tick value).
An engine built without it captures, loads and launches what it always
did, and this module's kernel library is never built.

**Marks** (``MARKS``). A one-thread kernel (``csrc/roundmark.cu``)
writes the device's ``%globaltimer`` into a ring of marks, [slots, 8]
int64, at the row that a device-side round counter names, so a replay
needs no host sync. The marks open the round and close each of its
seven segments (``SEGMENTS``): deliver, tick, control, propose, emit
(the step's phases), outbox (the lanes' stack, the validity mask, the
lease re-arm, narrowing and any telemetry or fleet plane) and route
(``engine._write_back``); the last one moves the counter on. On the
CPU, where an eager op has finished when it returns, a mark is
``time.perf_counter_ns()``.

**Entry lifecycle** (``LIFE_FIELDS``). For about 256 groups fixed at
construction (``sample_groups``), each traced round copies every
replica's ``last`` before the round and its ``role``, ``last``,
``commit`` and offered ``propose_n`` after it into a second ring, at
the same device slot (``index_copy_``). The host finds each group's
leader and the index a quorum of its replicas hold, and numbers
entries by index (``lifecycle``): first offered, appended on the
leader, held by a quorum, committed.

**Host spans** (``Span``). While a stretch is on, each
``run_rounds`` / ``run_rounds_pipelined`` call stamps
``perf_counter_ns`` at entry, after the proposal copy, once the device
lock is held, around each round's replay, and at exit, into a bounded
ring; a span pushed out of it is counted (``spans_dropped``).

**One clock** (``ClockFit``). At a stretch's start and end the tracer
takes ``ROUND_TRIPS`` synced stamp round trips (host clock, a mark on
the device, sync, host clock) and keeps the tightest of each set;
device times map to ``perf_counter_ns`` along the line through the two,
within ``error_ns``. Each device gap between one round's end mark and
the next round's start mark is named by the host span under way when it
ended (``HOST_SPANS``, or ``OUTSIDE``).

    rt = eng.round_trace           # MultiRaftEngine(..., round_trace=True)
    rt.start()
    eng.run_rounds(1, ...)         # as often as the stretch lasts
    rt.stop()
    stretch = rt.collect()
    stretch.summary()              # segment ms, host spans, gaps, lifecycle
    stretch.export()               # Trace Event JSON: a host and a device lane

The ring holds ``slots`` rounds: a longer stretch keeps its last
``slots`` rounds and counts the rest in ``rounds_dropped``.
"""

from __future__ import annotations

import bisect
import functools
import hashlib
import json
import math
import time
from collections import deque
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..obs.artifacts import dump_path
from . import hopper_kernels as hk
from .state import LEADER
from .step import ROUND_PHASE_SCOPES

SOURCE = Path(__file__).resolve().parent / "csrc" / "roundmark.cu"

# The round graphs' keys of an engine built for tracing.
UNTRACED, TRACED = "untraced", "traced"
# Marks of a round, in order: its start, then the end of each segment.
MARKS = ("start",) + tuple(n for n, _ in ROUND_PHASE_SCOPES[:-1]) + (
    "outbox", "route")
SEGMENTS = MARKS[1:]
MARK_INDEX = {name: k for k, name in enumerate(MARKS)}
# Rows of a lifecycle record, each over the sampled groups' replicas.
LIFE_FIELDS = ("last_before", "role", "last", "commit", "propose_n")
# What the host was doing inside an engine call, and outside one.
HOST_SPANS = ("props copy", "lock wait", "graph launch", "engine, other")
OUTSIDE = "outside the engine"
ROUND_TRIPS = 16  # stamp round trips at each end of a stretch
SAMPLE_GROUPS = 256
SLOTS = 256  # rounds the rings hold
SPAN_CAPACITY = 4096  # engine calls the host ring holds
DUMP_KIND = "roundtrace"


# -- the kernel library ----------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _library():
    """Build (once per source hash, beside the Hopper kernels) and load
    the mark library."""
    import ctypes

    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    lib = hk.build_library(SOURCE, hk.BUILD_DIR / f"libroundmark_{digest}.so")
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.round_mark_launch.argtypes = [p, p, i32, i32, i32, i32, p]
    lib.round_mark_launch.restype = i32
    return lib


def sample_groups(groups: int, k: int = SAMPLE_GROUPS) -> np.ndarray:
    """`k` groups (all of them when there are fewer), the same for every
    engine of `groups` groups whoever builds it."""
    if groups <= k:
        return np.arange(groups, dtype=np.int64)
    pick = np.random.default_rng(0x726F756E64).choice(groups, k,
                                                      replace=False)
    return np.sort(pick).astype(np.int64)


def _gather(src: torch.Tensor, rows: torch.Tensor, out: torch.Tensor) -> None:
    if src.dtype == out.dtype:
        torch.index_select(src, 0, rows, out=out)
    else:
        out.copy_(src.index_select(0, rows))


# -- host spans ----------------------------------------------------------------


class Span:
    """One engine call's host stamps (perf_counter_ns): entry, after the
    proposal copy, once the device lock is held (the first time, for a
    pipelined call), each replay's start and end, exit. The call's
    rounds are the tracer's rounds `first_round`, `first_round + 1`, ...,
    one a replay."""

    __slots__ = ("first_round", "entry", "props", "locked", "replays",
                 "exit")

    def __init__(self, first_round: int) -> None:
        self.first_round = first_round
        self.props = self.locked = self.exit = None
        self.replays: List[int] = []  # start, end, start, end, ...
        self.entry = time.perf_counter_ns()

    def props_copied(self) -> None:
        self.props = time.perf_counter_ns()

    def lock_held(self) -> None:
        if self.locked is None:
            self.locked = time.perf_counter_ns()

    def replay_begin(self) -> None:
        self.replays.append(time.perf_counter_ns())

    def replay_end(self) -> None:
        self.replays.append(time.perf_counter_ns())

    @property
    def rounds(self) -> int:
        return len(self.replays) // 2

    def launch_ns(self) -> int:
        r = self.replays
        return sum(r[k + 1] - r[k] for k in range(0, len(r), 2))

    def parts_ns(self) -> Dict[str, int]:
        """The call's host time by HOST_SPANS."""
        props = self.props or self.entry
        locked = self.locked or props
        launch = self.launch_ns()
        total = self.exit - self.entry
        parts = {"props copy": props - self.entry, "lock wait": locked - props,
                 "graph launch": launch}
        parts["engine, other"] = total - sum(parts.values())
        return parts

    def doing(self, t: float) -> str:
        """The host span under way at time t, inside this call."""
        if t < (self.props or self.entry):
            return "props copy"
        if self.locked is None or t < self.locked:
            return "lock wait"
        r = self.replays
        k = bisect.bisect_right(r, t) - 1
        return "graph launch" if k >= 0 and k % 2 == 0 and k + 1 < len(r) \
            else "engine, other"


# -- one clock -----------------------------------------------------------------


class ClockFit:
    """Device timer (ns) to the host's perf_counter_ns: the line through
    the tightest stamp round trip at each end of a stretch. A round trip
    (t0, d, t1) is the host clock before a stamp's launch, the stamp,
    and the host clock once it synced; the stamp lies within (t1 - t0)
    / 2 of the midpoint."""

    def __init__(self, start: list, end: list) -> None:
        (self.d0, self.h0, e0), (self.d1, self.h1, e1) = (
            self._best(start), self._best(end))
        span = self.d1 - self.d0
        self.rate = (self.h1 - self.h0) / span if span else 1.0
        self.error_ns = max(e0, e1)

    @staticmethod
    def _best(pairs: list) -> tuple:
        t0, d, t1 = min(pairs, key=lambda p: p[2] - p[0])
        return int(d), (t0 + t1) / 2, (t1 - t0) / 2

    def host_ns(self, d) -> np.ndarray:
        rel = (np.asarray(d, dtype=np.int64) - self.d0).astype(np.float64)
        return self.h0 + rel * self.rate


# -- the tracer ----------------------------------------------------------------


class RoundTracer:
    """The rings, marks and spans of one engine (module docstring). The
    engine calls `begin_round`, `mark` and `end_round` from its traced
    round body, and `open_span` / `close_span` around its calls while a
    stretch is on."""

    def __init__(self, cfg, state, props: torch.Tensor, device) -> None:
        self.slots = SLOTS
        self.replicas = r = cfg.num_replicas
        self.groups = sample_groups(cfg.num_groups)
        self.marks = torch.zeros((self.slots, len(MARKS)), dtype=torch.int64,
                                 device=device)
        # The marks' device names its index ("cuda:0", not "cuda").
        dev = self.device = self.marks.device
        self.cuda = dev.type == "cuda"
        self.counter = torch.zeros((1,), dtype=torch.int64, device=dev)
        self._slot = torch.zeros((1,), dtype=torch.int64, device=dev)
        rows = (self.groups[:, None] * r + np.arange(r)).reshape(-1)
        self._rows = torch.as_tensor(rows, device=dev)
        self.life = torch.zeros((self.slots, len(LIFE_FIELDS), rows.size),
                                dtype=torch.int32, device=dev)
        self._stage = torch.zeros((len(LIFE_FIELDS), rows.size),
                                  dtype=torch.int32, device=dev)
        # The engine's buffers are its own for its lifetime.
        self._last = state.last
        self._after = (state.role, state.last, state.commit, props)
        self.spans: deque = deque(maxlen=SPAN_CAPACITY)
        self.spans_dropped = 0
        self.active = False
        self._enqueued = 0  # traced rounds launched since construction
        self._first = 0  # the stretch's first round
        self._cal: Dict[str, list] = {}
        self._cpu_round = 0
        if self.cuda:
            self._mark_fn = _library().round_mark_launch
            self._cal_ring = torch.zeros((ROUND_TRIPS,), dtype=torch.int64,
                                         device=dev)
            self._cal_counter = torch.zeros((1,), dtype=torch.int64,
                                            device=dev)
            # Load every kernel the traced round adds, outside any
            # capture: a mark, the slot and the lifecycle copies.
            self._launch_mark(self._cal_ring, self._cal_counter, 0, False)
            self.begin_round(stamp=False)
            self._record()
            self.life.zero_()

    # -- inside the traced round -------------------------------------------------

    def _launch_mark(self, ring: torch.Tensor, counter: torch.Tensor, k: int,
                     advance: bool) -> None:
        hk._launch("round_mark", self._mark_fn, self.device, ring.data_ptr(),
                   counter.data_ptr(), ring.shape[0],
                   ring.shape[1] if ring.dim() == 2 else 1, k, int(advance))

    def _mark(self, k: int, advance: bool = False) -> None:
        if self.cuda:
            self._launch_mark(self.marks, self.counter, k, advance)
            return
        self.marks[self._cpu_round % self.slots, k] = time.perf_counter_ns()
        if advance:
            self._cpu_round += 1
            self.counter.add_(1)

    def mark(self, name: str) -> None:
        """Close the segment `name` (SEGMENTS)."""
        self._mark(MARK_INDEX[name])

    def begin_round(self, stamp: bool = True) -> None:
        """The round's slot and its sampled replicas' `last` before it,
        then the start mark."""
        torch.remainder(self.counter, self.slots, out=self._slot)
        _gather(self._last, self._rows, self._stage[0])
        if stamp:
            self._mark(0)

    def end_round(self) -> None:
        """The route segment's mark, which moves the round counter on,
        then the round's lifecycle record."""
        self._mark(MARK_INDEX["route"], advance=True)
        self._record()

    def _record(self) -> None:
        for j, src in enumerate(self._after, 1):
            _gather(src, self._rows, self._stage[j])
        self.life.index_copy_(0, self._slot, self._stage.unsqueeze(0))

    # -- host spans and stretches ------------------------------------------------

    def open_span(self) -> Optional[Span]:
        """A Span for an engine call, or None outside a stretch."""
        return Span(self._enqueued) if self.active else None

    def close_span(self, span: Span) -> None:
        span.exit = time.perf_counter_ns()
        self._enqueued += span.rounds
        if len(self.spans) == self.spans.maxlen:
            self.spans_dropped += 1
        self.spans.append(span)

    def _round_trips(self) -> list:
        """ROUND_TRIPS synced stamps (t0, device stamp, t1)."""
        now = time.perf_counter_ns
        if not self.cuda:
            out = []
            for _ in range(ROUND_TRIPS):
                t0 = now()
                d = now()
                out.append((t0, d, now()))
            return out
        stream = torch.cuda.current_stream(self.device)
        stream.synchronize()
        self._cal_counter.zero_()
        host = []
        for _ in range(ROUND_TRIPS):
            t0 = now()
            self._launch_mark(self._cal_ring, self._cal_counter, 0, True)
            # jitlint: waive(sync-in-loop) -- a round trip is one stamp between two host clock reads; each must sync
            stream.synchronize()
            host.append((t0, now()))
        stamps = self._cal_ring.tolist()
        return [(t0, d, t1) for (t0, t1), d in zip(host, stamps)]

    def start(self) -> None:
        """Start a stretch: the clock's first round trips, an empty span
        ring; engine calls trace their rounds until stop()."""
        if self.active:
            raise RuntimeError("a traced stretch is already on")
        self.spans.clear()
        self.spans_dropped = 0
        self._cal = {"start": self._round_trips()}
        self._first = self._enqueued
        self.active = True

    def stop(self) -> None:
        """End the stretch: its rounds finish and the clock's last
        round trips are taken."""
        if not self.active:
            raise RuntimeError("no traced stretch is on")
        self.active = False
        self._cal["end"] = self._round_trips()

    def collect(self) -> "Stretch":
        """The stopped stretch's rings, read back (one sync)."""
        if self.active or "end" not in self._cal:
            raise RuntimeError("collect() needs a stopped stretch")
        counted = int(self.counter)
        if counted != self._enqueued:
            raise RuntimeError(f"the device counted {counted} traced rounds, "
                               f"the host launched {self._enqueued}")
        n = self._enqueued - self._first
        kept = min(n, self.slots)
        rounds = np.arange(self._enqueued - kept, self._enqueued,
                           dtype=np.int64)
        at = rounds % self.slots
        return Stretch(rounds=rounds, marks=self.marks.cpu().numpy()[at],
                       life=self.life.cpu().numpy()[at],
                       spans=list(self.spans), spans_dropped=self.spans_dropped,
                       rounds_dropped=n - kept,
                       clock=ClockFit(self._cal["start"], self._cal["end"]),
                       replicas=self.replicas, groups=self.groups.size,
                       device=str(self.device))


# -- what a stretch shows ------------------------------------------------------


def _rank(values, q: float) -> Optional[int]:
    """The nearest-rank q-quantile of whole numbers `values`, or None."""
    a = np.sort(np.asarray(values))
    return int(a[max(0, math.ceil(q * a.size) - 1)]) if a.size else None


def lifecycle(life: np.ndarray, replicas: int) -> Dict[str, np.ndarray]:
    """Per entry of the sampled groups, the round (index into `life`,
    [rounds, LIFE_FIELDS, groups * replicas]) in which it was first
    offered, appended on its leader, held by a quorum of replicas and
    committed on its leader; -1 where the stretch ended first. Entries
    are numbered by index within their group. An entry counts if it
    was first offered after the stretch's first round (the first round's
    offer may be older)."""
    n = life.shape[0]
    x = life.reshape(n, len(LIFE_FIELDS), -1, replicas).astype(np.int64)
    before, role, last, commit, props = (x[:, j] for j in range(5))
    is_lead = role == LEADER
    has = is_lead.any(2)
    slot = is_lead.argmax(2)[..., None]

    def lead(a):
        # A round without a leader moves nothing.
        return np.maximum.accumulate(
            np.where(has, np.take_along_axis(a, slot, 2)[..., 0], -1), 0)

    q = replicas // 2 + 1
    steps = {"offered": lead(before + props), "appended": lead(last),
             "held": np.maximum.accumulate(np.sort(last, 2)[..., replicas - q],
                                           0),
             "committed": lead(commit)}
    out = {k: [] for k in steps}
    off = steps["offered"]
    for g in range(off.shape[1]):
        idx = np.arange(max(off[0, g], 0) + 1, off[-1, g] + 1)
        for k, v in steps.items():
            r = np.searchsorted(v[:, g], idx, side="left")
            out[k].append(np.where(r < n, r, -1))
    return {k: np.concatenate(v) if v else np.zeros(0, np.int64)
            for k, v in out.items()}


def lifecycle_summary(entries: Dict[str, np.ndarray]) -> dict:
    """Rounds between the lifecycle's steps over the entries whose steps
    all fell in the stretch: p50, p99 and max; the rest are censored."""
    whole = np.all([v >= 0 for v in entries.values()], axis=0) \
        if entries["offered"].size else np.zeros(0, bool)
    e = {k: v[whole] for k, v in entries.items()}
    out = {"entries": int(whole.sum()), "censored": int((~whole).sum())}
    for name, a, b in (("accept_wait_rounds", "offered", "appended"),
                       ("append_to_held_rounds", "appended", "held"),
                       ("commit_rounds", "appended", "committed")):
        d = e[b] - e[a]
        out[name] = {"p50": _rank(d, 0.5), "p99": _rank(d, 0.99),
                     "max": int(d.max()) if d.size else None}
    return out


@dataclass
class Stretch:
    """A stopped stretch, read back: the kept rounds' numbers, their
    marks ([rounds, MARKS] device ns), lifecycle records, the engine
    calls' spans and the clock."""

    rounds: np.ndarray
    marks: np.ndarray
    life: np.ndarray
    spans: List[Span]
    spans_dropped: int
    rounds_dropped: int
    clock: ClockFit
    replicas: int
    groups: int
    device: str

    def host_marks(self) -> np.ndarray:
        """The marks on the host's clock (perf_counter_ns, float)."""
        return self.clock.host_ns(self.marks)

    def segments_ms(self) -> np.ndarray:
        """[rounds, SEGMENTS]: each segment's device time."""
        return np.diff(self.marks, axis=1) / 1e6

    def _span_at(self, entries: list, t: float) -> str:
        k = bisect.bisect_right(entries, t) - 1
        if k >= 0 and t < self.spans[k].exit:
            return self.spans[k].doing(t)
        return OUTSIDE

    def _replay_ends(self) -> Dict[int, int]:
        return {s.first_round + j: s.replays[2 * j + 1]
                for s in self.spans for j in range(s.rounds)}

    def gaps(self) -> List[tuple]:
        """(round before, gap ns, the host span under way at its end) for
        each pair of consecutive kept rounds."""
        host = self.host_marks()
        entries = [s.entry for s in self.spans]
        return [(int(self.rounds[k]), host[k + 1, 0] - host[k, -1],
                 self._span_at(entries, host[k + 1, 0]))
                for k in range(len(self.rounds) - 1)
                if self.rounds[k + 1] == self.rounds[k] + 1]

    def launch_wait_ns(self) -> "tuple[float, float]":
        """(the device's time between a round's end and the return of
        the engine's launch of the next, summed; the device span from
        the first kept round's start to the last one's end)."""
        host, ends = self.host_marks(), self._replay_ends()
        wait = 0.0
        for k in range(len(self.rounds) - 1):
            ret = ends.get(int(self.rounds[k + 1]))
            if ret is not None and self.rounds[k + 1] == self.rounds[k] + 1:
                wait += max(0.0, min(host[k + 1, 0], ret) - host[k, -1])
        return wait, host[-1, -1] - host[0, 0]

    def summary(self) -> dict:
        """What the stretch shows, by the names of the metrics that read
        it (PERF.md §3)."""
        seg = self.segments_ms()
        out = {"device": self.device, "rounds": int(self.rounds.size),
               "rounds_dropped": self.rounds_dropped,
               "spans": len(self.spans), "spans_dropped": self.spans_dropped,
               "clock_error_us": self.clock.error_ns / 1e3}
        if seg.size:
            for j, name in enumerate(SEGMENTS):
                out[f"{name}_ms"] = float(np.median(seg[:, j]))
            out["round_ms"] = float(np.median(seg.sum(1)))
            wait, span = self.launch_wait_ns()
            out["launch_wait_pct"] = (float(100.0 * wait / span) if span > 0
                                      else None)
        rounds = sum(s.rounds for s in self.spans)
        if rounds:
            parts = {name: 0 for name in HOST_SPANS}
            for s in self.spans:
                for name, ns in s.parts_ns().items():
                    parts[name] += ns
            out["engine_host_ms"] = sum(s.exit - s.entry
                                        for s in self.spans) / rounds / 1e6
            out["graph_launch_ms"] = parts["graph launch"] / rounds / 1e6
            out["host_spans_ms"] = {k: v / rounds / 1e6
                                    for k, v in parts.items()}
        gaps: Dict[str, list] = {}
        for _r, ns, name in self.gaps():
            g = gaps.setdefault(name, [0, 0.0])
            g[0] += 1
            g[1] += ns / 1e6
        out["gaps"] = {k: {"count": c, "total_ms": ms}
                       for k, (c, ms) in gaps.items()}
        life = lifecycle_summary(lifecycle(self.life, self.replicas))
        out["lifecycle"] = {"groups": self.groups, **life}
        out["accept_wait_rounds_p99"] = life["accept_wait_rounds"]["p99"]
        out["commit_rounds_p99"] = life["commit_rounds"]["p99"]
        return out

    def trace_events(self) -> dict:
        """The stretch as Trace Event JSON (Perfetto, chrome://tracing): a
        host lane of engine calls and their spans, a device lane of
        rounds, their segments and the gaps between them, in µs from
        the stretch's first stamp on the host's clock."""
        host = self.host_marks()
        t0 = min([s.entry for s in self.spans]
                 + ([host[0, 0]] if host.size else []), default=0)

        def x(name, pid, tid, a, b, **args):
            return {"name": name, "ph": "X", "pid": pid, "tid": tid,
                    "ts": (a - t0) / 1e3, "dur": (b - a) / 1e3, "args": args}

        ev = [{"name": "process_name", "ph": "M", "pid": pid,
               "args": {"name": name}}
              for pid, name in ((1, "host"), (2, "device"))]
        for s in self.spans:
            ev.append(x("run_rounds", 1, 1, s.entry, s.exit,
                        rounds=s.rounds, first_round=s.first_round))
            props = s.props or s.entry
            ev.append(x("props copy", 1, 2, s.entry, props))
            ev.append(x("lock wait", 1, 2, props, s.locked or props))
            for k in range(0, len(s.replays), 2):
                ev.append(x("graph launch", 1, 2, s.replays[k],
                            s.replays[k + 1]))
        for k, r in enumerate(self.rounds):
            ev.append(x(f"round {int(r)}", 2, 1, host[k, 0], host[k, -1]))
            for j, name in enumerate(SEGMENTS):
                ev.append(x(name, 2, 2, host[k, j], host[k, j + 1]))
        for r, ns, name in self.gaps():
            k = int(np.searchsorted(self.rounds, r))
            ev.append(x(f"gap: {name}", 2, 3, host[k, -1], host[k, -1] + ns))
        return {"traceEvents": ev, "displayTimeUnit": "ns",
                "otherData": {"clock_error_us": self.clock.error_ns / 1e3,
                              "device": self.device}}

    def export(self, path: Optional[str] = None, member: str = "0",
               reason: str = "stretch") -> str:
        """Write trace_events() to `path` (default: an artifacts/ dump
        name); return the path."""
        path = path or dump_path(DUMP_KIND, member, reason)
        with open(path, "w") as f:
            json.dump(self.trace_events(), f)
        return path


def table(summary: dict) -> str:
    """The segment table of a stretch's summary (markdown): each
    segment's median and its share of the medians' sum."""
    ms = {name: summary[f"{name}_ms"] for name in SEGMENTS}
    total = sum(ms.values())
    rows = ["| segment | median ms | share |", "|---|---|---|"]
    rows += [f"| {name} | {v:.4f} | {100 * v / total:.1f}% |"
             for name, v in ms.items()]
    rows.append(f"| round | {summary['round_ms']:.4f} | |")
    return "\n".join(rows)
