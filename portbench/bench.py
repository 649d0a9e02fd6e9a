"""One run of one cell: set-up, the window, the drain, then off the
clock the latency resolution, the trace's reduction and the check that
decides ``correct``. ``run.py`` is the command line around ``run_cell``.
"""

from __future__ import annotations

import gc
import math
import subprocess
import sys
import time
from collections import Counter
from typing import Callable, Optional

import torch

from . import check, latency, roofline, spec
from . import traffic as traffic_mod
from .loop import Loop
from .trace import Context, Tracer

SAMPLE_ROWS = 192  # rows (groups x replicas) that the reference runs
CHECKPOINT_EVERY = 64  # rounds between two copies of the sampled rows
TRACE_ROUNDS = 12  # rounds of a traced stretch
PROBE_ROUNDS = 16  # set-up rounds timed to size the recordings


def program_engine(fields: dict, device):
    """The system under test: the port's multi-Raft engine."""
    from etcd_tpu_torch.batched import BatchedConfig, MultiRaftEngine

    return MultiRaftEngine(BatchedConfig(**fields), device=device)


def sample_groups(groups: int, replicas: int, gen: torch.Generator,
                  traffic) -> torch.Tensor:
    """SAMPLE_ROWS // replicas groups drawn from the seed, and in an open
    loop the group with the most arrivals."""
    pick = torch.randperm(groups, generator=gen)[:SAMPLE_ROWS // replicas]
    due = getattr(traffic, "due", None)
    if due is not None:
        busiest = int(torch.isfinite(due).sum(1).argmax())
        if busiest not in pick.tolist():
            pick[-1] = busiest
    return pick.sort().values


def device_of(dev: torch.device) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
           "count": 1,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             f"--id={dev.index or 0}"], capture_output=True, text=True,
            timeout=30, check=True)
        out["power_limit"] = smi.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out["power_limit"] = "unknown"
    return out


def _stats(drv, traffic, ends, seconds: float) -> dict:
    """The window's rounds and their mean time; for an open loop, the
    arrivals handed over but not committed at the window's middle and
    at its end (a backlog that grows between them: above the knee)."""
    first, last = drv.warm_rounds, drv.window_rounds - 1
    out = {"window_rounds": last - first + 1,
           "round_ms": float(ends[last] - ends[first - 1]) * 1e3
           / (last - first + 1)}
    due = getattr(traffic, "due", None)
    if due is not None:
        handed = drv.now_dev.stacked(drv.rounds)
        for name, i in (("backlog_mid", (first + last) // 2),
                        ("backlog_end", last)):
            arrived = int((due <= handed[i]).sum())
            committed = int((drv.hist.row(i).long() - drv.base.long()).sum())
            out[name] = arrived - committed
    return out


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device, t_start: float,
             make_engine: Optional[Callable] = None,
             engine_fields: Optional[dict] = None,
             traffic_params: Optional[dict] = None,
             stats: Optional[dict] = None) -> dict:
    """Run `cell` once; return its result line as a dict, `checks` last.
    `make_engine`, `engine_fields` and `traffic_params` put another
    system, other sizes or other traffic in place (tests, the control,
    the rate sweep); `stats`, when given, receives the rounds' mean
    time and the open loop's backlog at the window's middle and end
    (sweep.py)."""
    dev = torch.device(device)
    fields = {**cell.config["engine"], **(engine_fields or {})}
    params = {**cell.traffic, **(traffic_params or {})}
    g = int(fields["num_groups"])
    seed = int(seed) % 2**63
    marks = [("start", time.perf_counter())]
    eng = (make_engine or program_engine)(fields, dev)
    marks.append(("engine", time.perf_counter()))
    traffic = traffic_mod.make(params, g, seconds,
                               torch.Generator(device=dev).manual_seed(seed),
                               dev)
    sample = sample_groups(g, int(fields["num_replicas"]),
                           torch.Generator().manual_seed(seed), traffic)
    drv = Loop(eng, fields, traffic, float(cell.config["tick_s"]), sample,
                 CHECKPOINT_EVERY, int(params["in_flight_rounds"]), dev)
    marks.append(("schedule", time.perf_counter()))
    round_s = drv.elect(probe_rounds=PROBE_ROUNDS)
    marks.append(("election and captures", time.perf_counter()))
    warm, drain = int(params["warm_rounds"]), float(params["drain_s"])
    drv.start_recording(warm + int(math.ceil(
        (seconds + drain + 1) / max(round_s, 1e-4) * 1.25)))
    marks.append(("recordings", time.perf_counter()))
    budget = None
    if make_engine is None:
        from etcd_tpu_torch.analysis.sentinels import CompileBudget
        budget = CompileBudget(0).track("window", eng)
    tracer = Tracer(dev) if trace and dev.type == "cuda" else None
    if tracer is not None:
        from etcd_tpu_torch.batched import hopper_kernels as hk

        def on_trace(body, first):
            before = Counter(hk.FORM_LAUNCHES)
            tracer.run(body, lambda: drv.ticks[first:first + TRACE_ROUNDS],
                       first=first)
            if tracer.sessions and tracer.sessions[-1]["first"] == first:
                tracer.sessions[-1]["forms"] = (Counter(hk.FORM_LAUNCHES)
                                                - before)
    drv.run(warm, seconds, drain, TRACE_ROUNDS if tracer else 0,
            on_trace if tracer else None)
    setup_s = drv.t0 - t_start
    if budget is not None:
        budget.check()
    device_info = device_of(dev)
    rounds = drv.rounds
    marks.append(("warm-up", drv.t0))
    print(f"portbench: {rounds} rounds ({drv.warm_rounds} warm-up, "
          f"{drv.window_rounds - drv.warm_rounds} in the window), "
          f"{sum(drv.ticks)} ticks, set-up {setup_s:.3f} s (imports "
          f"{marks[0][1] - t_start:.3f}, " + ", ".join(
              f"{name} {t - marks[k][1]:.3f}"
              for k, (name, t) in enumerate(marks[1:])) + "), "
          f"{round_s * 1e3:.3f} ms a set-up round", file=sys.stderr)
    t_post = time.perf_counter()

    stretch = session = None
    if tracer is not None:
        stretch, session = tracer.result()
        print("portbench: traced stretches at " + ", ".join(
            f"{s['span'][0] - drv.t0:.3f}-{s['span'][1] - drv.t0:.3f} s"
            for s in tracer.sessions) + f"; kept the one from round "
            f"{session['first']}", file=sys.stderr)
    # The roofline's bounds: a spy on one eager round of the live state.
    hopper_bound = None
    if stretch is not None and make_engine is None:
        from etcd_tpu_torch.batched import hopper_kernels as hk

        forms, bound = roofline.spy_bounds(
            hk, lambda: eng.step_round(tick=False, propose_n=drv.props))
        per_round = {k: v / TRACE_ROUNDS
                     for k, v in session["forms"].items()}
        if per_round == forms:
            hopper_bound = bound
        else:
            print(f"portbench: the eager round's kernel forms {forms} are "
                  f"not the graph's {per_round}", file=sys.stderr)

    # Off the clock: latencies, from the recordings.
    ends = drv.round_ends().to(dev)
    gaps = torch.diff(ends[drv.warm_rounds:drv.window_rounds]) * 1e3
    if gaps.numel():
        med = float(gaps.median())
        print(f"portbench: window rounds end {med:.3f} ms apart (median), "
              f"{float(gaps.max()):.3f} ms at most, "
              f"{int((gaps > 2 * med).sum())} gaps over twice the median",
              file=sys.stderr)
    if traffic.due is None:
        res = latency.resolve(drv.hist.blocks, rounds, drv.base, ends,
                              seconds, clients=traffic.clients,
                              loop_start=drv.enqueued[0] - drv.t0)
    else:
        # Arrivals due while the profiler paused the host are handed
        # over late by its cost, not the loop's: the lag leaves them out.
        res = latency.resolve(drv.hist.blocks, rounds, drv.base, ends,
                              seconds, due=traffic.due,
                              handed=drv.now_dev.stacked(rounds),
                              lag_skip=None if tracer is None else [
                                  tuple(t - drv.t0 for t in s["span"])
                                  for s in tracer.sessions])
    committed = latency.committed_in_window(drv.hist.blocks, rounds, ends,
                                            seconds, drv.commit0)
    if stats is not None:
        stats.update(_stats(drv, traffic, ends, seconds))
    breaks = int(drv.violations)
    offered = drv.rec_props.stacked(rounds).clone()
    commits = torch.cat([b[:, drv.sample] for b in drv.hist.blocks])[:rounds]
    ck = drv.checkpoints()
    ticks, setup_ticks = list(drv.ticks), list(drv.setup_ticks)
    window = [s * 1e3 for s, p in zip(drv.replay_s, drv.phase)
              if p == "window"]
    # The device's wait between rounds, over the window's rounds outside
    # the traced stretches (and the round after each, which waits for
    # the profiler's stop).
    traced = set()
    if tracer is not None:
        for s in reversed(tracer.sessions):
            first = s["first"] - drv.warm_rounds
            del window[first:first + TRACE_ROUNDS]
            traced.update(range(s["first"], s["first"] + TRACE_ROUNDS + 1))
    waits = drv.clock.waits_ms(
        i for i in range(drv.warm_rounds + 1, drv.window_rounds)
        if i not in traced)
    idle_pct = 100.0 * waits[0] / waits[1] if waits and waits[1] > 0 \
        else None
    # The program's state is freed before the reference runs.
    del eng, traffic, drv, budget
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    mismatches = check.replay(fields, sample.numel(), setup_ticks, ticks,
                              offered, commits, ck, CHECKPOINT_EVERY)
    print(f"portbench: after the window, latencies {t_ref - t_post:.3f} s, "
          f"the reference {time.perf_counter() - t_ref:.3f} s",
          file=sys.stderr)
    checks = {"ref_mismatches": mismatches, "guarantee_breaks": breaks,
              "uncommitted": res.failed}
    out = {"correct": all(v <= check.LIMITS[k] for k, v in checks.items()),
           "attempted": res.attempted, "failed": res.failed}
    if trace:
        ctx = Context(stretch, window,
                      res.lag.quantile_ms(0.99) if res.lag.total else None,
                      hopper_bound, idle_pct)
        out["metrics"] = spec.read_per_layer(cell, ctx)
        if stretch is not None:
            device_info["busy_s"] = stretch.busy_us / 1e6
            device_info["window_s"] = stretch.window_us / 1e6
    else:
        p50, p99 = res.hist.quantile_ms(0.5), res.hist.quantile_ms(0.99)
        values = {"commits_per_s": committed / seconds,
                  "commit_p50_ms": p50, "commit_p99_ms": p99,
                  "setup_s": setup_s}
        out["metrics"] = {m["name"]: {"value": values[m["name"]],
                                      "unit": m["unit"]}
                          for m in cell.end_to_end
                          if values.get(m["name"]) is not None}
    out["device"] = device_info
    if stretch is not None:
        out["breakdown"] = stretch.breakdown()
    out["checks"] = {k: {"value": v, "limit": check.LIMITS[k]}
                     for k, v in checks.items()}
    return out
