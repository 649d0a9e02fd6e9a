"""Bench methodology for the PyTorch engine: the canonical engine config
and the rate and commit-p50 measurements.

Ports ``etcd_tpu/tools/benchlib.py`` (same R/W/E config, same election
setup, same proposal load, same quiet-point commit-latency loop), with
``torch.cuda.synchronize()`` where the JAX version blocks on its
arrays. The engine runs on the GPU unless the caller names another
device; a measurement taken on the CPU is a CPU number and is labeled
with the device it ran on.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import torch

from ..analysis.sentinels import CompileBudget
from ..batched import BatchedConfig, MultiRaftEngine


def _sync(eng) -> None:
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)


def bench_config(groups: int, telemetry: bool = False,
                 fleet: bool = False,
                 deliver_shape: str = "auto") -> BatchedConfig:
    """The canonical bench config: R=3, W=32, E=4, P=2, steady state with
    no timer elections, auto-compacting ring; `telemetry` and `fleet`
    add the telemetry and fleet summary planes to the round;
    `deliver_shape` is lanes | merged | vectorized ("auto": the
    package default)."""
    return BatchedConfig(
        num_groups=groups,
        num_replicas=3,
        window=32,
        max_ents_per_msg=4,
        max_props_per_round=2,
        election_timeout=1 << 20,  # steady state: no timer elections
        heartbeat_timeout=4,
        auto_compact=True,  # sustained load: ring chases the applied mark
        deliver_shape=deliver_shape,
        telemetry=telemetry,
        fleet_summary=fleet,
    )


def make_bench_engine(groups: int, telemetry: bool = False,
                      fleet: bool = False, device=None,
                      deliver_shape: str = "auto"):
    """Build the canonical bench engine, elect every group's slot-0
    replica, and return the engine plus the steady
    2-entries-per-group-per-round proposal vector. The headline number
    runs with both planes off; `telemetry`/`fleet` measure their cost.
    `deliver_shape` is the shape A/B axis: every result names the
    concrete shape it ran (engine.cfg.deliver_shape, resolved)."""
    cfg = bench_config(groups, telemetry, fleet, deliver_shape)
    eng = MultiRaftEngine(cfg, device=device)
    eng.campaign(range(0, cfg.num_instances, cfg.num_replicas))
    eng.run_rounds(4, tick=False)
    if not (eng.leaders() == 0).all():
        raise RuntimeError("election failed in bench setup")
    props = torch.zeros((cfg.num_instances,), dtype=torch.int32,
                        device=eng.device)
    props[::cfg.num_replicas] = 2
    return eng, props


def measure_rate(eng, props, rounds_per_call: int, calls: int,
                 pipelined: bool = False,
                 budget: Optional[CompileBudget] = None) -> float:
    """Steady-state group-rounds/s after one warm-up call (which
    captures the round's graph on CUDA): `calls` run_rounds calls of
    `rounds_per_call` rounds each, or one run_rounds_pipelined pass of
    as many rounds with chunk == rounds_per_call. The measured calls
    are held to zero new captures, in `budget` when the caller gives one
    (its report() then counts them)."""
    eng.run_rounds(rounds_per_call, tick=True, propose_n=props)  # warmup
    _sync(eng)
    # The measured loop replays what the warm-up captured: a capture
    # inside it would be timed as a round (analysis.sentinels).
    budget = (CompileBudget(0) if budget is None else budget).track(
        "measure_rate", eng)
    t0 = time.perf_counter()
    if pipelined:
        eng.run_rounds_pipelined(rounds_per_call * calls,
                                 chunk=rounds_per_call, tick=True,
                                 propose_n=props)
    else:
        for _ in range(calls):
            eng.run_rounds(rounds_per_call, tick=True, propose_n=props)
    _sync(eng)
    dt = time.perf_counter() - t0
    budget.check()
    return eng.cfg.num_groups * rounds_per_call * calls / dt


def measure_commit_p50(eng, max_rounds: int = 10) -> Tuple[float, int]:
    """Commit p50: propose one entry per group at a quiet point, then
    step single rounds until every group's commit covers it — the
    wall-clock from propose to quorum-commit. All groups move in
    lockstep, so p50 == the common latency. Returns (ms, rounds)."""
    r = eng.cfg.num_replicas
    one = torch.zeros((eng.cfg.num_instances,), dtype=torch.int32,
                      device=eng.device)
    one[::r] = 1
    # Drain the in-flight pipeline so the measurement starts quiesced.
    eng.run_rounds(1, tick=False, propose_n=one)
    eng.run_rounds(4, tick=False)
    _sync(eng)
    base = eng.commits()[:, 0].min()
    t0 = time.perf_counter()
    eng.run_rounds(1, tick=False, propose_n=one)
    rounds = 1
    # jitlint: waive(sync-in-loop) -- the sync IS the measurement: commit p50 is wall-clock from propose to observed quorum commit, one read per round by definition
    while eng.commits()[:, 0].min() <= base and rounds < max_rounds:
        eng.run_rounds(1, tick=False)
        rounds += 1
    return (time.perf_counter() - t0) * 1000, rounds
