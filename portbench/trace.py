"""The traced stretch: ``torch.profiler`` with CUDA activity alone
(CUPTI) over a run of the window's rounds, reduced to what the
per-layer readers take.

A round is one replay of the engine's round graph: the kernels whose
correlation id is that of a ``cudaGraphLaunch``. The loop enqueues the
traced rounds behind a hold of the device (``loop.hold``), so the device
runs them back to back whatever the profiler costs the host. The
stretch's window runs from the first kernel of its second graph launch
to the last kernel of its last one; every device operation inside it
(the graph's kernels, the loop's own ops, copies and fills) counts as
busy. An idle gap is named by the host's runtime call under way when
it began, or the last one that had ended.

A session in which a graph launch shows another number of kernels than
the others (CUPTI lost records), or none, fails the stretch: nothing
falls back to another timer. CPU activity is not traced.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import Counter, defaultdict
from typing import Callable, List, Optional

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOPPER = ("quorum_commit_vote", "term_at_batch")


class Stretch:
    """What one traced stretch saw (times in microseconds)."""

    def __init__(self, events: list, ticks: Optional[List[bool]] = None
                 ) -> None:
        """`ticks`: the traced rounds' ticks, one a round."""
        ops = [e for e in events if e.get("ph") == "X"
               and e.get("cat") in DEVICE_CATS]
        runtime = sorted((e for e in events if e.get("ph") == "X"
                          and e.get("cat") in ("cuda_runtime",
                                               "cuda_driver")),
                         key=lambda e: e["ts"])
        launches = [e for e in runtime if e.get("name") == "cudaGraphLaunch"]
        by_corr = defaultdict(list)
        for e in ops:
            by_corr[e.get("args", {}).get("correlation")].append(e)
        graphs = [by_corr.get(e.get("args", {}).get("correlation"), [])
                  for e in launches]
        graphs = [[k for k in g if k["cat"] == "kernel"] for g in graphs]
        if ticks is not None and len(graphs) != len(ticks):
            raise RuntimeError(f"the profiler's session is short: "
                               f"{len(graphs)} graph launches in "
                               f"{len(ticks)} rounds")
        # Both round graphs (with and without a tick) launch the same
        # kernels, so a launch with another count lost some records.
        counts = Counter(len(g) for g in graphs)
        stamped = all(k["dur"] > 0 for g in graphs for k in g)
        if len(graphs) < 2 or 0 in counts or len(counts) > 1 \
                or not stamped:
            raise RuntimeError(
                f"the profiler's session is short: {len(graphs)} graph "
                f"launches, kernels a launch {dict(counts)}, durations "
                f"{'recorded' if stamped else 'missing'}")
        rounds = graphs[1:]
        self.rounds = len(rounds)
        lo = min(k["ts"] for k in rounds[0])
        hi = max(k["ts"] + k["dur"] for k in rounds[-1])
        self.round_kernels = [k for g in rounds for k in g]
        spans = sorted((max(lo, e["ts"]), min(hi, e["ts"] + e["dur"]))
                       for e in ops if e["ts"] < hi and e["ts"] + e["dur"] > lo)
        busy: List[list] = []
        for a, b in spans:
            if busy and a <= busy[-1][1]:
                busy[-1][1] = max(busy[-1][1], b)
            else:
                busy.append([a, b])
        self.window_us = hi - lo
        self.busy_us = sum(b - a for a, b in busy)
        self.gaps = [(busy[k][1], busy[k + 1][0] - busy[k][1])
                     for k in range(len(busy) - 1)]
        self.ops = [e for e in ops if lo <= e["ts"] < hi]
        self._runtime = runtime
        self._starts = [e["ts"] for e in runtime]

    def round_device_ms(self) -> float:
        return sum(e["dur"] for e in self.round_kernels) / self.rounds / 1e3

    def kernels_per_round(self) -> float:
        return len(self.round_kernels) / self.rounds

    def hopper_us(self) -> float:
        return sum(e["dur"] for e in self.round_kernels
                   if any(h in e["name"] for h in HOPPER))

    def idle_pct(self) -> float:
        return 100.0 * (1 - self.busy_us / self.window_us)

    def host_doing(self, t: float) -> str:
        """The host's runtime call under way at time t, or the last one
        that had ended."""
        i = bisect.bisect_right(self._starts, t) - 1
        if i < 0:
            return "host before any runtime call"
        e = self._runtime[i]
        return e["name"] if t <= e["ts"] + e["dur"] else f"after {e['name']}"

    def breakdown(self) -> dict:
        by_name = Counter()
        for e in self.ops:
            by_name[e["name"][:160]] += e["dur"]
        longest = sorted(self.gaps, key=lambda g: -g[1])[:10]
        return {
            "device_ops": [[n, us / 1e6] for n, us in by_name.most_common(10)],
            "idle_gaps": [[self.host_doing(t), us / 1e6] for t, us in longest],
        }


class Tracer:
    """The profiler over stretches of the window. Set-up opens and
    closes one session on a trivial op (the profiler's own first-use
    cost). A stretch's trace is exported and reduced as soon as its
    session stops (the export of a session reads zero timestamps once a
    later session has started); the first whole stretch is kept and
    later stretches run unprofiled. CUPTI has been seen to drop some
    kernels' records of a session, the more the longer it runs."""

    def __init__(self, device) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.device = device
        self._profile = lambda: profile(activities=[ProfilerActivity.CUDA])
        with self._profile():
            torch.ones(1, device=device).add_(1)
            torch.cuda.synchronize(device)
        # Per profiled stretch: the host clock at its start and at the
        # end of its reduction, and what the caller notes beside it.
        self.sessions: List[dict] = []
        self.kept: Optional[tuple] = None  # (Stretch, its session)
        self.errors: List[str] = []

    def run(self, body: Callable[[], None],
            ticks_of: Callable[[], List[bool]], **note) -> None:
        """Run body() inside the profiler, between two syncs, and reduce
        its trace (`ticks_of()`: the stretch's rounds' ticks); once a
        whole stretch is kept, just run body()."""
        if self.kept is not None:
            body()
            return
        t0 = time.perf_counter()
        torch.cuda.synchronize(self.device)
        prof = self._profile()
        prof.start()
        body()
        torch.cuda.synchronize(self.device)
        prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        session = {**note, "span": None}
        self.sessions.append(session)
        try:
            self.kept = (Stretch(events, ticks_of()), session)
        except RuntimeError as e:
            self.errors.append(str(e))
        session["span"] = (t0, time.perf_counter())

    def result(self) -> "tuple[Stretch, dict]":
        if self.kept is None:
            raise RuntimeError("no whole traced stretch: "
                               + "; ".join(self.errors))
        return self.kept


class Context:
    """What a per-layer reader reads: the traced stretch (None on a
    device with no trace), the loop's spans and counters."""

    def __init__(self, stretch: Optional[Stretch], replay_ms: List[float],
                 gen_lag_p99_ms: Optional[float],
                 hopper_bound_ms_per_round: Optional[float],
                 device_wait_pct: Optional[float] = None) -> None:
        self.stretch = stretch
        self.replay_ms = replay_ms
        self.gen_lag_p99_ms = gen_lag_p99_ms
        self.hopper_bound_ms_per_round = hopper_bound_ms_per_round
        self.device_wait_pct = device_wait_pct
