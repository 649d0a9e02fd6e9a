"""The engine's round tracer (etcd_tpu_torch/batched/roundtrace.py) on
the CPU, where a mark is the host's clock: tracing off leaves the
engine's round as it was, tracing on leaves its state as it was, the
marks partition the round, and the host's reductions (lifecycle, clock,
gap names, launch wait, export) hold on hand-built rings. The card's
half (the mark kernel, graph variants, the clock against CUDA events)
is in tests/test_torch_cuda.py."""

import json
import random
import time

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import chip_smoke
from etcd_tpu_torch.batched import MultiRaftEngine
from etcd_tpu_torch.batched import roundtrace as rtm
from etcd_tpu_torch.batched import step as step_mod
from etcd_tpu_torch.batched.roundtrace import (LIFE_FIELDS, MARKS, SEGMENTS,
                                               TRACED, UNTRACED, ClockFit, Span,
                                               Stretch)
from etcd_tpu_torch.batched.state import FOLLOWER, LEADER
from etcd_tpu_torch.tools.benchlib import bench_config

G = 8
# The per-layer metrics that read a stretch's summary (PERF.md §3).
METRICS = tuple(f"{s}_ms" for s in SEGMENTS) + (
    "engine_host_ms", "graph_launch_ms", "launch_wait_pct",
    "accept_wait_rounds_p99", "commit_rounds_p99")


def elected(groups=G, round_trace=False):
    cfg = bench_config(groups)
    eng = MultiRaftEngine(cfg, device="cpu", round_trace=round_trace)
    eng.campaign(range(0, cfg.num_instances, cfg.num_replicas))
    eng.run_rounds(4, tick=False)
    assert (eng.leaders() == 0).all()
    props = torch.zeros((cfg.num_instances,), dtype=torch.int32)
    props[::cfg.num_replicas] = 3
    return eng, props


def stretch_of(eng, props, rounds, pipelined=0):
    rt = eng.round_trace
    rt.start()
    for k in range(rounds):
        eng.run_rounds(1, tick=k % 3 == 0, propose_n=props)
    if pipelined:
        eng.run_rounds_pipelined(pipelined, chunk=2, tick=False,
                                 propose_n=props)
    rt.stop()
    return rt.collect()


class Ops(TorchDispatchMode):
    """The aten ops dispatched inside the block, by name."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


def ops_of(fn):
    with Ops() as mode:
        fn()
    return mode.ops


def is_subsequence(short, long):
    it = iter(long)
    return all(any(x == y for y in it) for x in short)


# -- tracing off, tracing on -----------------------------------------------------


def test_tracing_off_dispatches_the_rounds_it_always_did():
    plain, props = elected()
    built, _ = elected(round_trace=True)
    for fn in (lambda e: e.step_round(tick=True, propose_n=props),
               lambda e: e.run_rounds(2, tick=False, propose_n=props),
               lambda e: e.run_rounds_pipelined(2, chunk=1, propose_n=props)):
        assert ops_of(lambda: fn(built)) == ops_of(lambda: fn(plain))
    assert plain.round_trace is None and plain.captures == 0


def test_a_traced_round_adds_only_the_tracers_ops():
    eng, props = elected(round_trace=True)
    untraced = ops_of(lambda: eng.run_rounds(1, tick=False, propose_n=props))
    eng.round_trace.start()
    traced = ops_of(lambda: eng.run_rounds(1, tick=False, propose_n=props))
    eng.round_trace.stop()
    assert is_subsequence(untraced, traced)
    extra = list(traced)
    for op in untraced:
        extra.remove(op)
    # The proposal copy (the traced loop's own), the slot, the lifecycle
    # gathers and ring copy, the CPU marks and the counter.
    assert set(extra) <= {"copy_", "remainder", "index_select", "index_copy_",
                          "index_copy", "select", "fill_", "add_",
                          "unsqueeze", "lift_fresh"}, set(extra)


def test_untraced_engines_never_load_the_mark_library(monkeypatch):
    def refuse():
        raise AssertionError("the mark library was loaded")

    monkeypatch.setattr(rtm, "_library", refuse)
    eng, props = elected(round_trace=True)  # on the CPU: host-clock marks
    stretch_of(eng, props, 2)
    plain, props = elected()
    plain.run_rounds(2, propose_n=props)


class GraphRecorder:
    """A stand-in for RoundGraphs that records each call and runs the
    body once a round."""

    captures = 0

    def __init__(self):
        self.calls = []

    def run(self, key, body, times=1, **info):
        self.calls.append(("run", key, info))
        for _ in range(times):
            body()

    def prepare(self, key, body, **info):
        self.calls.append(("prepare", key, info))


@pytest.mark.parametrize("built", [False, True])
def test_graph_keys_and_capture_info(built):
    """The engine's graph path with the graphs recorded: an engine built
    without tracing asks for the keys and capture info it always did, a
    graph a tick value; one built for it holds a graph a variant,
    prepares the other variant in the same call, and reads the tick mask
    from a buffer that it rewrites when the tick value changes."""
    eng, props = elected(round_trace=built)
    eng._graphs = rec = GraphRecorder()
    eng.device = torch.device("cuda")  # the graph path, on CPU tensors
    eng._replay(2, True)
    if built:
        assert bool(eng._ticks.all())
    eng._replay(1, False)
    if not built:
        assert rec.calls == [("run", True, {"tick": True}),
                             ("run", False, {"tick": False})]
        return
    assert not bool(eng._ticks.any())
    plain, traced = {"traced": False}, {"traced": True}
    assert rec.calls == [("run", UNTRACED, plain),
                         ("prepare", TRACED, traced)] * 2
    rec.calls.clear()
    eng.round_trace.start()
    span = eng.round_trace.open_span()
    eng._replay(1, True, span)
    eng.round_trace.close_span(span)
    eng.round_trace.stop()
    assert rec.calls == [("run", TRACED, traced),
                         ("prepare", UNTRACED, plain)]
    assert eng.round_trace.collect().rounds.tolist() == [0]


def test_traced_rounds_leave_the_state_bit_for_bit_equal():
    plain, props = elected()
    traced, _ = elected(round_trace=True)
    for k in range(6):
        plain.run_rounds(1, tick=k % 3 == 0, propose_n=props)
    plain.run_rounds_pipelined(4, chunk=2, tick=False, propose_n=props)
    stretch = stretch_of(traced, props, 6, pipelined=4)
    assert stretch.rounds.size == 10
    for name, a, b in zip(plain.state._fields, plain.state, traced.state):
        assert torch.equal(a, b), name
    for name, a, b in zip(plain.inbox._fields, plain.inbox, traced.inbox):
        assert torch.equal(a, b), name
    assert plain.rounds == traced.rounds


def test_marks_partition_the_round():
    eng, props = elected(round_trace=True)
    s = stretch_of(eng, props, 8)
    assert s.marks.shape == (8, len(MARKS))
    assert (np.diff(s.marks, axis=1) >= 0).all()
    assert (np.diff(s.marks[:, 0]) > 0).all()
    seg = s.segments_ms()
    assert np.allclose(seg.sum(1), (s.marks[:, -1] - s.marks[:, 0]) / 1e6)
    summary = s.summary()
    assert sum(summary[f"{name}_ms"] for name in SEGMENTS) \
        == pytest.approx(float(np.median(seg, axis=0).sum()))
    assert summary["rounds"] == 8 and summary["rounds_dropped"] == 0
    assert summary["spans"] == 8 and summary["spans_dropped"] == 0


def test_a_planted_op_in_deliver_moves_deliver_alone(monkeypatch):
    def medians():
        eng, props = elected(round_trace=True)
        return eng, stretch_of(eng, props, 6).summary()

    _, base = medians()
    orig = step_mod._deliver_all

    def slow_deliver(*a, **kw):
        time.sleep(0.05)
        return orig(*a, **kw)

    monkeypatch.setattr(step_mod, "_deliver_all", slow_deliver)
    _, slow = medians()
    moved = {name: slow[f"{name}_ms"] - base[f"{name}_ms"]
             for name in SEGMENTS}
    assert moved["deliver"] >= 45, moved
    assert all(abs(v) < 15 for k, v in moved.items() if k != "deliver"), moved


def test_rings_count_what_they_drop(monkeypatch):
    monkeypatch.setattr(rtm, "SLOTS", 4)
    monkeypatch.setattr(rtm, "SPAN_CAPACITY", 3)
    eng, props = elected(round_trace=True)
    s = stretch_of(eng, props, 10)
    assert s.rounds.tolist() == [6, 7, 8, 9]
    assert s.rounds_dropped == 6 and s.spans_dropped == 7
    assert [sp.first_round for sp in s.spans] == [7, 8, 9]
    assert (np.diff(s.marks[:, 0]) > 0).all()
    summary = s.summary()
    assert summary["rounds_dropped"] == 6 and summary["spans_dropped"] == 7


def test_collect_refuses_counts_that_disagree():
    eng, props = elected(round_trace=True)
    rt = eng.round_trace
    with pytest.raises(RuntimeError, match="stopped stretch"):
        rt.collect()
    rt.start()
    eng.run_rounds(2, propose_n=props)
    with pytest.raises(RuntimeError, match="already on"):
        rt.start()
    rt.stop()
    rt.counter.add_(1)
    with pytest.raises(RuntimeError, match="the device counted 3"):
        rt.collect()


def test_the_sample_is_fixed_by_the_group_count():
    a, b = rtm.sample_groups(102400), rtm.sample_groups(102400)
    assert a.size == 256 and (a == b).all() and (np.diff(a) > 0).all()
    assert rtm.sample_groups(10).tolist() == list(range(10))
    eng, _ = elected(round_trace=True)
    assert eng.round_trace.groups.tolist() == list(range(G))


def test_the_summary_names_every_metric_that_reads_it():
    summary = chip_smoke.run_roundtrace(torch.device("cpu"), groups=16,
                                        rounds=8)
    for name in METRICS:
        assert summary[name] is not None, name
    assert summary["captures"] == 0 and summary["captures_after_warmup"] == 0
    # A proposal appended in round k is acked in k + 1 and committed in
    # k + 2's deliver.
    assert summary["commit_rounds_p99"] == 2
    life = summary["lifecycle"]
    assert life["groups"] == 16 and life["entries"] > 0
    assert life["append_to_held_rounds"]["max"] == 1
    assert "| deliver |" in rtm.table(summary)


def _skip_the_tick_mark(orig):
    def mark(self, k, advance=False):
        if k != MARKS.index("tick"):
            orig(self, k, advance)
    return mark


def _commit_in_the_tracer(orig):
    def end_round(self):
        orig(self)
        self._after[2].add_(1)  # the traced engine's commit
    return end_round


@pytest.mark.parametrize("attr,fault,says", [
    ("_mark", _skip_the_tick_mark, "unwritten"),
    ("end_round", _commit_in_the_tracer, "differs")])
def test_the_smoke_gate_refuses_a_faulty_tracer(monkeypatch, attr, fault,
                                                says):
    """chip_smoke's round-tracer gate raises on a mark left unwritten
    and on a traced engine whose state leaves its untraced twin's."""
    monkeypatch.setattr(rtm.RoundTracer, attr,
                        fault(getattr(rtm.RoundTracer, attr)))
    with pytest.raises(AssertionError, match=says):
        chip_smoke.run_roundtrace(torch.device("cpu"), groups=16, rounds=4)


# -- the host's reductions on hand-built rings ---------------------------------------


def life_ring(rows):
    """[rounds, LIFE_FIELDS, groups * R] from per round, per group:
    (leader slot or None, last before on the leader, offered, the
    replicas' last after, the leader's commit)."""
    n, groups, r = len(rows), len(rows[0]), 3
    life = np.zeros((n, len(LIFE_FIELDS), groups * r), np.int32)
    for i, per_group in enumerate(rows):
        for g, (slot, before, offered, last, commit) in enumerate(per_group):
            cols = slice(g * r, g * r + r)
            life[i, 0, cols] = before
            life[i, 1, cols] = FOLLOWER
            life[i, 2, cols] = last
            life[i, 3, cols] = commit
            if slot is not None:
                life[i, 1, g * r + slot] = LEADER
                life[i, 4, g * r + slot] = offered
    return life


def test_lifecycle_from_a_hand_built_ring():
    """Entries 11-13 offered in round 1 against a cap of 2 (13 waits a
    round), acked a round later, committed two rounds after append;
    14-15 offered in round 4 and not committed when the stretch ends.
    The second group has its leader at slot 1 and none in round 2."""
    a = [(0, 10, 0, (10, 10, 10), 10), (0, 10, 3, (12, 10, 10), 10),
         (0, 12, 1, (13, 12, 12), 10), (0, 13, 0, (13, 13, 13), 12),
         (0, 13, 2, (15, 13, 13), 13), (0, 15, 0, (15, 15, 15), 13)]
    b = [(1, before, off, (last[1], last[0], last[2]), commit)
         for _s, before, off, last, commit in a]
    b[2] = (None, 0, 0, b[2][3], 0)
    e = rtm.lifecycle(life_ring(list(zip(a, b))), 3)
    assert e["offered"][:5].tolist() == [1, 1, 1, 4, 4]
    assert e["appended"][:5].tolist() == [1, 1, 2, 4, 4]
    assert e["held"][:5].tolist() == [2, 2, 3, 5, 5]
    assert e["committed"][:5].tolist() == [3, 3, 4, -1, -1]
    # Group b: round 2 has no leader, so 13 waits until round 3.
    assert e["appended"][5:].tolist() == [1, 1, 3, 4, 4]
    assert e["committed"][5:].tolist() == [3, 3, 4, -1, -1]
    s = rtm.lifecycle_summary(e)
    assert s["entries"] == 6 and s["censored"] == 4
    assert s["accept_wait_rounds"] == {"p50": 0, "p99": 2, "max": 2}
    assert s["commit_rounds"]["p99"] == 2
    assert s["append_to_held_rounds"] == {"p50": 1, "p99": 1, "max": 1}


def test_lifecycle_leaves_out_what_the_first_round_offered():
    rows = [[(0, 4, 6, (6, 4, 4), 4)], [(0, 6, 4, (8, 6, 6), 4)],
            [(0, 8, 2, (9, 8, 8), 6)], [(0, 9, 1, (10, 9, 9), 8)]]
    e = rtm.lifecycle(life_ring(rows), 3)
    # Entries 5-10 were offered in round 0 (maybe earlier): not counted.
    assert e["offered"].size == 0
    assert rtm.lifecycle_summary(e)["entries"] == 0


@pytest.mark.parametrize("skew", [0.0, 3e-6, -8e-6])
def test_the_clock_fit_on_synthetic_round_trips(skew):
    rng = random.Random(7)
    d_base, h_base = 1_760_000_000_000_000_000, 52_000_000_000

    def device(h):
        return d_base + round((h - h_base) * (1 + skew))

    def trips(at):
        out = []
        for k in range(16):
            # One tight round trip (2 us), the rest slow and lopsided.
            before = 1000 if k == 5 else rng.randint(5000, 40000)
            after = 1000 if k == 5 else rng.randint(5000, 90000)
            h = at + k * 200_000
            out.append((h - before, device(h), h + after))
        return out

    fit = ClockFit(trips(h_base), trips(h_base + 50_000_000))
    assert fit.error_ns == 1000
    for h in (h_base + 1_000_000, h_base + 25_000_000, h_base + 50_001_000):
        assert abs(fit.host_ns(device(h)) - h) <= fit.error_ns + 2
    assert fit.rate * (1 + skew) == pytest.approx(1.0, abs=1e-7)


def spanned(entry, props, locked, replays, exit_, first):
    s = Span(first)
    s.entry, s.props, s.locked, s.exit = entry, props, locked, exit_
    s.replays = list(replays)
    return s


def synthetic_stretch():
    """Four rounds on a device whose clock is the host's: round 1 starts
    inside its graph launch, round 2 while its call waits for the lock,
    round 3 outside any call."""
    starts = (1000, 2500, 5000, 7000)
    marks = np.array([[t + 100 * j if j < 7 else t + 1000 for j in range(8)]
                      for t in starts], np.int64)
    spans = [spanned(500, 600, 700, (800, 900), 950, 0),
             spanned(2100, 2200, 2300, (2400, 2600), 2700, 1),
             spanned(4000, 4100, 5500, (5600, 5700), 5800, 2),
             spanned(7500, 7600, 7700, (7800, 7900), 8100, 3)]
    clock = ClockFit([(0, 0, 0)], [(10**9, 10**9, 10**9)])
    return Stretch(rounds=np.arange(4), marks=marks,
                   life=np.zeros((4, len(LIFE_FIELDS), 3), np.int32),
                   spans=spans, spans_dropped=0, rounds_dropped=0,
                   clock=clock, replicas=3, groups=1, device="cpu")


def test_gaps_are_named_by_the_host_span_under_way():
    s = synthetic_stretch()
    assert [(r, ns, name) for r, ns, name in s.gaps()] == [
        (0, 500.0, "graph launch"), (1, 1500.0, "lock wait"),
        (2, 1000.0, "outside the engine")]
    assert spanned(0, 10, 20, (30, 40, 50, 60), 70, 0).doing(45) \
        == "engine, other"
    assert spanned(0, 10, 20, (30, 40), 70, 0).doing(5) == "props copy"


def test_launch_wait_counts_the_device_waiting_on_a_launch():
    s = synthetic_stretch()
    wait, span = s.launch_wait_ns()
    # 2000 - 2600 capped at round 1's start: 500; round 2 started at
    # 5000, before its launch returned: 1500; round 3's launch returned
    # at 7900, after its start: 1000.
    assert (wait, span) == (3000.0, 7000.0)
    summary = s.summary()
    assert summary["launch_wait_pct"] == pytest.approx(100 * 3000 / 7000)
    assert summary["engine_host_ms"] == pytest.approx(
        (450 + 600 + 1800 + 600) / 4 / 1e6)
    assert summary["graph_launch_ms"] == pytest.approx(
        (100 + 200 + 100 + 100) / 4 / 1e6)
    assert summary["gaps"]["lock wait"] == {"count": 1,
                                            "total_ms": 1500 / 1e6}
    parts = summary["host_spans_ms"]
    assert sum(parts.values()) == pytest.approx(summary["engine_host_ms"])


def test_the_trace_export_has_a_host_and_a_device_lane(tmp_path):
    s = synthetic_stretch()
    path = s.export(str(tmp_path / "stretch.json"))
    with open(path) as f:
        trace = json.load(f)
    ev = trace["traceEvents"]
    lanes = {e["args"]["name"]: e["pid"] for e in ev if e["ph"] == "M"}
    assert lanes == {"host": 1, "device": 2}
    xs = [e for e in ev if e["ph"] == "X"]
    assert all(e["dur"] >= 0 and e["ts"] >= 0 for e in xs)
    names = [e["name"] for e in xs if e["pid"] == 2 and e["tid"] == 2]
    assert names == list(SEGMENTS) * 4
    assert sum(e["name"] == "run_rounds" for e in xs) == 4
    assert {e["name"] for e in xs if e["tid"] == 3} == {
        "gap: graph launch", "gap: lock wait", "gap: outside the engine"}


def test_a_default_export_goes_to_the_artifacts_directory(tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv("ETCD_TPU_FLIGHTREC_DIR", str(tmp_path))
    path = synthetic_stretch().export(member="2", reason="probe")
    assert path.startswith(str(tmp_path))
    assert "roundtrace_m2_" in path and path.endswith("_probe.json")
