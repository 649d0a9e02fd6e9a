"""Chip smoke test for the PyTorch engine on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Builds the Hopper kernels (nvcc) and the WAL's record log (g++) from the
sources in this checkout, side by side, holds each kernel against its
plain PyTorch version on the card (at the engine's shapes and at the
node's, N = 1), drives the main path (the bench engine at G=65,536
groups: elections, closed-loop rounds with proposals through the
engine's CUDA graph of one round, commit p50), profiles the graphed
round beside the eager one, holds graph replays against eager rounds,
runs the main path again with the telemetry and fleet planes on, holds
the whole round on CUDA against the same round on the CPU under each of
the three deliver shapes, drives the bench engine at G=65,536 once per
deliver shape (the sender scans "lanes" and "merged" and the vectorized
fold: a seeded loaded schedule with the three compared field for field,
each shape's kernel forms held against their plain versions on the
round's own inputs, rate, commit p50, device time, captures, and graph
replays against eager rounds for both scans), holds the engine on the
card against the shadow cluster (the port's scalar Raft, replaying each
shape's delivery order) on the differential schedules at 64 groups,
drives the
hosted path (three BatchedRawNode members of G=65,536 groups each, every
member's round a graph replay, proposals with payloads committed on
every member), holds hosted members on CUDA against hosted members on
the CPU, drives the apply plane (its dispatch alone at G=65,536 rows, a
CUDA graph held against the eager dispatch and against PlaneOracle on
the sampled, armed-watch and overflowing rows; then three plane-on
members folding KV proposals, each leader's plane held against an
oracle replay of its committed stream, and a 1,024-row capture restored
into another member), holds plane-on members on CUDA against the CPU
and runs a plane dispatch beside another member's capture in a thread,
drives the raft.Node boundary (three BatchedNodes at
raftexample's default width: 4,032 puts, a third forwarded, ReadIndex,
a transfer, a voter removed and re-added, a compaction with a MsgSnap
catch-up), holds CUDA nodes against CPU nodes Ready for Ready, replays
every committed interaction script (etcd_tpu_torch/rafttest/testdata:
one BatchedNode a trace node at R = 1..7, W = 64) through the port's
BatchedInteractionEnv on the card and on the CPU beside the port's
scalar InteractionEnv, directive for directive (the scalar text against
the expected blocks, no state divergence, CUDA equal to the CPU, every
kernel form the nodes launched held against its plain version on every
distinct input of the CPU env's rounds), and runs
raftexample's replicated KV (three members, each in its own threads,
with a WAL and snapshots on disk, one stopped and restarted from them),
drives the multi-raft server (three MultiRaftMembers of G=1,024 groups,
hosted_bench's deployment, in one process: elections, 3,000 puts read
back everywhere, linearizable reads, a member crashed and restarted on
its WAL, the checkers), holds hosting members on CUDA against members
on the CPU step by step (WAL records, KV, mirrors, health), runs the
reference's split-vs-unsplit differential (three members of G = 4,096
groups, each member's rows split over the card twice, against three
unsplit members: the same applied KV; every kernel form of one round of
each shard against its plain version; no capture and no sync in the
steady rounds), and runs the
chaos cells (message faults over the in-process, TCP and shm fabrics, a
failpoint crash, a torn WAL tail, an fsync fail-stop, a WAL-pipeline
crash window) over CUDA members, each closed by the strict checkers,
and the message-fault cell again under each sender scan,
runs the server as three worker processes on the card over TCP (the
port's hosted_bench at its defaults with 6,000 puts, its kill -9 and
restart; then the reference's three-process e2e flow with tracing, the
fleet console and a kill -9), and rebalances leadership (the port's
rebalancerd over three workers with every group on one member; the
limp-eviction episode over CUDA members in this process), then runs the
etcd server (three EtcdServers on the card, each behind a V3RPCServer,
driven by 100 client connections: etcd's documented benchmark cut to
1,000 puts of 8-byte keys and 256-byte values, ranges of both
consistencies, a txn mix, leases, a watch, a compaction, a contended
lock, a follower restarted on its WAL, a MsgSnap catch-up; every acked
put read back on every member, the KV against a dict oracle, hash_check,
every node form against its plain version), holds servers on CUDA
against servers on the CPU response for response, and boots etcd's own
deployment (three `python -m etcd_tpu_torch` member processes on the
card at etcd's defaults, loaded by the port's etcd benchmark tool from a
process of its own: puts, then ranges of both consistencies at every
member; every acked put read back on every member, hash_kv, a kill -9
of the leader and its restart, a snapshot restored by the port's
etcdutl into a solo member on the card; each member's launches from its
orderly stop; the db and WAL dumpers on a stopped member's data dir,
the metrics dumper on a live member).
Each phase prints one line; any failure raises and the script exits
non-zero. It needs CUDA: without it, it prints no result and exits
non-zero.

Line protocol (stdout): one line per phase (the kernels phase times
every main-path and node-path form warm and L2-cold; the slice phase
counts launches per kernel and per form), a line with each phase's wall
seconds, then a JSON line {"kernels": [...]} with every kernel's
launches on each path (the engine's, each deliver shape's, the hosted
one, the plane-on hosted one, the node's, the interaction harness's,
raftexample's, the hosting server's and its worker processes', the split
members', the etcd server's, the booted members', each counted from 0
around its run), at
its most launched engine form its device time warm and cold,
plain-version time and bound, and every form with its launches per
engine round (under each deliver shape), rawnode, node, interaction
node, server and booted member (one member's node round) and hosting
member round (in process and in a worker); then the card's name and
power limit as nvidia-smi reports them; then, last,
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from collections import deque

import numpy as np
import torch

MAIN_GROUPS = 65536
R = 3  # the bench config's replica width
SEED = 20261017


START = time.perf_counter()


def log(phase: str, **fields) -> None:
    """One phase's JSON line, with the seconds since the script began."""
    print(json.dumps({"phase": phase, "t_s": time.perf_counter() - START,
                      **fields}), flush=True)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader",
         "--id=0"], capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def assert_equal(name: str, got, want) -> int:
    """Exact equality of int32 protocol values (a tensor, or a tuple of
    them for the fused quorum form); returns the largest
    |kernel - plain|, which the check holds at 0."""
    if isinstance(got, tuple):
        return max(assert_equal(f"{name} [{j}]", g, w)
                   for j, (g, w) in enumerate(zip(got, want, strict=True)))
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{name}: {got.dtype}{tuple(got.shape)} vs "
                             f"{want.dtype}{tuple(want.shape)}")
    diff = (got.long() - want.long()).abs().max().item() if got.numel() else 0
    if diff != 0:
        bad = (got != want).nonzero()[:5].tolist()
        raise AssertionError(f"{name}: kernel != plain at {bad}")
    return int(diff)


# -- phase: kernels ------------------------------------------------------------


def check_kernels(dev) -> "tuple[list, dict]":
    """Every kernel against its plain version, exactly: the quorum kernel
    in all three modes at every compiled R (1, 3, 5, 7), then every form
    the main path gives either kernel (tools/kernel_times: the quorum's
    modes and its [N, R, R] ack-prefix tallies with unexpanded masks at
    R=3, the ring lookup at K in {1, 3, 4, 12}), each timed warm and
    L2-cold at N = 196,608 rows, then every form a hosting member's
    round gives them at N = 1,024 rows (hosting's default W = 64,
    E = 8: the quorum at [N, 3], the general ring lookup at K in
    {1, 3, 8, 24}), then every form a BatchedNode round
    gives them at N = 1 (B1 at R = 3, at booted members' R = 4 and a
    booted solo member's R = 2, each spare slot included, with joint and
    empty configs; the general ring lookup at K in {1, 2, 3, 4, 8, 16,
    24, 32} and W in {128, 32768}, with queries at the floor, past last
    and across the ring's wrap),
    every seeded case held equal and the first timed. Returns the timed
    forms and each kernel's largest |kernel - plain|, and prints the
    forms."""
    from etcd_tpu_torch.batched import hopper_kernels as hk
    from etcd_tpu_torch.tools import kernel_times as kt

    gen = torch.Generator(device=dev).manual_seed(SEED)
    n = MAIN_GROUPS * R
    err = {"quorum_commit_vote": 0, "term_at_batch": 0}
    for r in (1, 3, 5, 7):
        match, voter, voter_out, in_joint, votes = kt.quorum_inputs(
            n, r, gen, dev)
        want_c, want_v = hk.quorum_commit_vote_ref(
            match, voter, voter_out, in_joint, votes)
        got_c, got_v = hk.quorum_commit_vote(
            match, voter, voter_out, in_joint, votes)
        err["quorum_commit_vote"] = max(
            err["quorum_commit_vote"],
            assert_equal(f"quorum both r={r} commit", got_c, want_c),
            assert_equal(f"quorum both r={r} vote", got_v, want_v),
            assert_equal(f"quorum commit r={r}", hk.quorum_commit(
                match, voter, voter_out, in_joint), want_c),
            assert_equal(f"quorum vote r={r}", hk.quorum_vote(
                votes, voter, voter_out, in_joint), want_v))
    variants = []
    for form in kt.main_path_forms(dev):
        name = form["key"].split()[0]
        err[name] = max(err[name], assert_equal(form["key"], form["call"](),
                                                form["plain"]()))
        variants.append({**kt.time_form(form), "n": n})
    for form in kt.hosting_path_forms(dev) + kt.worker_path_forms(dev):
        name = form["key"].split()[0]
        err[name] = max(err[name], assert_equal(
            f"{form['key']} N={kt.HOSTING_GROUPS}", form["call"](),
            form["plain"]()))
        variants.append({**kt.time_form(form), "n": kt.HOSTING_GROUPS})
    for form in kt.node_path_forms(dev):
        name = form["key"].split()[0]
        for j, (call, plain) in enumerate(form["cases"]):
            err[name] = max(err[name], assert_equal(
                f"{form['key']} N=1 case {j}", call(), plain()))
        variants.append({**kt.time_form(form), "n": 1,
                         "cases": len(form["cases"])})
    log("kernels", equal=True, variants=variants,
        event_timed=list(kt.EVENT_TIMED))
    return variants, err


def kernel_rows(variants: list, err: dict, paths: dict) -> list:
    """The kernels line: each kernel at its most launched form on the
    engine's main path, its launches on every path (each counted from 0
    around its own run), and every form it was timed at with that form's
    launches per engine round (N = 196,608), per rawnode round
    (N = 65,536), per hosting member round (N = 1,024) and per node
    round and server round (N = 1), and the mesh phase's forms (N =
    2,048 rows a shard)."""
    from etcd_tpu_torch.tools import kernel_times as kt

    per_round = {path: {k: v / p["rounds"] for k, v in p["forms"].items()}
                 for path, p in paths.items() if "forms" in p}
    mesh = paths.get("mesh")
    rows = []
    for name, line in (("quorum_commit_vote", 90), ("term_at_batch", 142)):
        mine = [v for v in variants if v["form"].startswith(name + " ")]
        top = max((v for v in mine if v["n"] > 1),
                  key=lambda v: paths["slice"]["forms"].get(v["form"], 0))
        forms = []
        for v in mine:
            path_rounds = ({"node": "node", "server": "server",
                            "boot": "boot", "interaction": "interaction"}
                           if v["n"] == 1 else
                           {"hosting": "hosting",
                            "hosting_proc": "hosting_proc"}
                           if v["n"] == kt.HOSTING_GROUPS else
                           {"engine": "slice", "rawnode": "hosted",
                            "engine_lanes": "shapes_lanes",
                            "engine_merged": "shapes_merged"})
            forms.append({
                **{k: v[k] for k in ("form", "n", "ms", "timed_by",
                                     "cold_ms", "cold_timed_by",
                                     "plain_ms", "plain_timed_by",
                                     "bound_ms", "bound_by")},
                "launches_per_round": {
                    label: per_round[path].get(v["form"], 0.0)
                    for label, path in path_rounds.items()}})
        rows.append({
            "name": name, "route": "cuda",
            "source": "etcd_tpu_torch/batched/csrc/quorum_ring.cu",
            "replaces": f"etcd_tpu/batched/pallas_kernels.py:{line}",
            "launches": sum(p["launches"][name] for p in paths.values()),
            "launches_by_path": {path: p["launches"][name]
                                 for path, p in paths.items()},
            "max_abs_err": err[name],
            "ms": top["ms"], "timed_by": top["timed_by"],
            "cold_ms": top["cold_ms"], "cold_timed_by": top["cold_timed_by"],
            "plain_ms": top["plain_ms"],
            "plain_timed_by": top["plain_timed_by"],
            "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": None,
            "form": top["form"], "forms": forms,
            # BASELINE #2-#5 (the sweep phase): launches a round per form
            # (R = 5 in #3, N = 3,145,728 rows in #5), and #3's and
            # #5's forms' call times on their round's own inputs.
            "sweep_forms": {
                path: {"rounds": p["rounds"],
                       "launches_per_round": {
                           k: v / p["rounds"] for k, v in p["forms"].items()
                           if k.startswith(name + " ")},
                       "timed": {k: v for k, v in p.get("timed", {}).items()
                                 if k.startswith(name + " ")}}
                for path, p in paths.items() if path.startswith("sweep_")},
            # The mesh phase (a member's rows split over two shards):
            # launches per member round of each form over the split run,
            # and the largest |kernel - plain| of each form of one round
            # of every shard.
            "mesh_forms": {
                "launches_per_round": {
                    form: count / mesh["rounds"]
                    for form, count in sorted(mesh["forms"].items())
                    if form.startswith(name + " ")},
                "max_abs_err": {
                    form: max(f[form] for f in mesh["shard_forms"].values())
                    for form in sorted(next(iter(
                        mesh["shard_forms"].values())))
                    if form.startswith(name + " ")}} if mesh else None})
    return rows


# -- phase: slice (the main path) ----------------------------------------------


def run_slice(dev):
    """The main path, with every launch count set to 0 just before it:
    returns the launches per kernel and per (kernel, form), and the
    engine and its proposal vector."""
    from etcd_tpu_torch.analysis.sentinels import CompileBudget
    from etcd_tpu_torch.batched import hopper_kernels as hk
    from etcd_tpu_torch.tools.benchlib import (
        make_bench_engine, measure_commit_p50, measure_rate)

    hk.reset_launches()
    t0 = time.perf_counter()
    eng, props = make_bench_engine(MAIN_GROUPS, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    before = eng.commits().copy()
    # Five runs each, for a median and a spread; after the first one's
    # warm-up, no round captures anew.
    rates = [measure_rate(eng, props, rounds_per_call=8, calls=4)]
    budget = CompileBudget(0).track("slice", eng)
    rates += [measure_rate(eng, props, rounds_per_call=8, calls=4)
              for _ in range(4)]
    after = eng.commits()
    p50s = [measure_commit_p50(eng) for _ in range(5)]
    budget.check()
    launches = dict(hk.LAUNCHES)
    forms = dict(hk.FORM_LAUNCHES)
    rounds = eng.rounds
    if not (after[:, 0] > before[:, 0]).all():
        raise AssertionError("commits did not advance in every group")
    if not (after.min(axis=1) > 0).all():
        raise AssertionError("a group committed nothing under load")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"{name} was never launched on the main path")
    if eng.captures != 2:
        raise AssertionError(f"{eng.captures} graph captures, expected one "
                             "per tick value")
    log("slice", groups=MAIN_GROUPS, rounds=rounds, setup_s=setup_s,
        loop="CUDA graph of one round, replayed",
        group_rounds_per_s=statistics.median(rates),
        group_rounds_per_s_runs=rates,
        commit_p50_ms=statistics.median(ms for ms, _ in p50s),
        commit_p50_runs=[{"ms": ms, "rounds": r} for ms, r in p50s],
        launches=launches,
        launches_per_round={k: v / rounds for k, v in launches.items()},
        form_launches_per_round={k: v / rounds for k, v in forms.items()},
        captures_after_warmup=budget.report(),
        min_commit=int(after.min()), max_commit=int(after.max()))
    return launches, forms, eng, props


def wall_ms(run, rounds: int) -> float:
    """Wall time per round on the host clock, no profiler running."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(rounds)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / rounds


def profile_rounds(run, rounds: int, wall=None) -> dict:
    """Wall time per round (measured here unless given), then device
    time by kernel name over as many rounds (CUPTI through
    torch.profiler, CUDA activity only)."""
    from etcd_tpu_torch.tools.kernel_times import _device_us, profile_kernels

    wall_ms_ = wall_ms(run, rounds) if wall is None else wall
    events = profile_kernels(lambda: run(rounds))
    busy_ms = sum(_device_us(e) for e in events) / 1e3 / rounds
    per_round = sum(e.count for e in events) / rounds
    hopper = {e.key: {"calls_per_round": e.count / rounds,
                      "device_us_per_call": _device_us(e) / e.count}
              for e in events if "quorum_commit_vote" in e.key
              or "term_at_batch" in e.key}
    return dict(
        wall_ms_per_round=wall_ms_, device_ms_per_round=busy_ms,
        device_busy_share=busy_ms / wall_ms_,
        device_kernels_per_round=per_round,
        wall_us_per_device_kernel=wall_ms_ * 1e3 / per_round,
        hopper_kernels=hopper,
        top_kernels=[{"name": e.key[:90], "calls_per_round":
                      e.count / rounds,
                      "device_ms_per_round": _device_us(e) / 1e3 / rounds}
                     for e in sorted(events, key=lambda e: -_device_us(e))[:12]])


def engine_round(eng, props):
    """One eager round of `eng` with `props` proposals, as a callable."""
    return lambda: eng.step_round(tick=True, propose_n=props)


def round_forms(run) -> dict:
    """The inputs that one eager round, `run()`, gives each kernel form
    (the first launch of each), cloned: form -> (wrapper, arguments)."""
    from etcd_tpu_torch.batched import hopper_kernels as hk

    wrappers = {name: getattr(hk, name)
                for name in ("quorum_commit", "quorum_vote", "term_at_batch")}
    forms = {
        "quorum_commit": lambda *a: "quorum_commit_vote commit B=1",
        "quorum_vote": lambda *a: ("quorum_commit_vote vote "
                                   f"B={a[4] if len(a) > 4 else 1}"),
        "term_at_batch": lambda *a: (
            f"term_at_batch K={a[4].shape[1] if a[4].dim() == 2 else 1}"),
    }
    seen = {}

    def spy(name):
        def call(*args):
            seen.setdefault(forms[name](*args), (wrappers[name], [
                a.clone() if isinstance(a, torch.Tensor) else a
                for a in args]))
            return wrappers[name](*args)
        return call

    for name in wrappers:
        setattr(hk, name, spy(name))
    try:
        run()
    finally:
        for name, fn in wrappers.items():
            setattr(hk, name, fn)
    return seen


def in_round_times(eng, props, graphed: dict) -> dict:
    """Each kernel form on the inputs the main path's round gives it,
    timed warm and L2-cold, beside the kernel's device time per launch
    inside the graphed round (B1's forms share one kernel name, so the
    graph's time is their mean)."""
    from etcd_tpu_torch.tools.kernel_times import timed_device_ms

    out = {}
    forms = round_forms(engine_round(eng, props))
    for form, (fn, args) in sorted(forms.items()):
        k = form.split("K=")[-1] if "K=" in form else None
        name = (f"term_at_batch_kernel<{k}," if k else
                "quorum_commit_vote_kernel<")
        in_graph = [v["device_us_per_call"]
                    for key, v in graphed["hopper_kernels"].items()
                    if name in key]
        warm, warm_by = timed_device_ms(lambda: fn(*args), iters=10)
        cold, cold_by = timed_device_ms(lambda: fn(*args), iters=10,
                                        cold=True)
        out[form] = {
            "warm_us": warm * 1e3, "warm_timed_by": warm_by,
            "cold_us": cold * 1e3, "cold_timed_by": cold_by,
            "in_graph_us": in_graph[0] if in_graph else None}
    return out


def graph_pool_bytes():
    """Bytes the caching allocator holds for CUDA graph pools: every
    segment outside the default pool (one engine is alive here)."""
    segments = torch.cuda.memory_snapshot()
    if segments and "segment_pool_id" not in segments[0]:
        return None
    return sum(s["total_size"] for s in segments
               if tuple(s["segment_pool_id"]) != (0, 0))


def run_profile(eng, props) -> float:
    """Where a round's time goes, on the main path's engine: the graphed
    closed loop beside the eager one (step_round, as before the graph),
    the captures and the memory. Returns the graphed round's device ms."""
    rounds = 8

    def eager(k):
        for _ in range(k):
            eng.step_round(tick=True, propose_n=props)

    def graph(k):
        eng.run_rounds(k, tick=True, propose_n=props)

    # Both wall times before this phase's profiler sessions, the eager
    # one again after them.
    walls = {"graphed": wall_ms(graph, rounds), "eager": wall_ms(eager, rounds)}
    graphed = profile_rounds(graph, rounds, walls["graphed"])
    eager_prof = profile_rounds(eager, rounds, walls["eager"])
    walls["eager_after_profiling"] = wall_ms(eager, rounds)
    # Host syncs: a capture fails on any sync inside the round, and the
    # warm replays and eager rounds run under the engine's sync guard
    # (analysis.sentinels.round_guard) with ETCD_TPU_TRANSFER_GUARD=
    # disallow: PyTorch's sync debug mode raises on one.
    old_guard = os.environ.get("ETCD_TPU_TRANSFER_GUARD")
    os.environ["ETCD_TPU_TRANSFER_GUARD"] = "disallow"
    try:
        eng.run_rounds(4, tick=True, propose_n=props)
        eng.step_round(tick=True, propose_n=props)
    finally:
        if old_guard is None:
            os.environ.pop("ETCD_TPU_TRANSFER_GUARD")
        else:
            os.environ["ETCD_TPU_TRANSFER_GUARD"] = old_guard
    torch.cuda.synchronize()
    log("profile", groups=MAIN_GROUPS, rounds=rounds, graphed=graphed,
        eager=eager_prof, host_syncs_per_round="0, proven by capture",
        warm_replays="under round_guard, ETCD_TPU_TRANSFER_GUARD=disallow",
        kernel_forms_in_round=in_round_times(eng, props, graphed),
        wall_ms_per_round=walls, captures=eng.capture_stats,
        graph_pool_bytes=graph_pool_bytes(),
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
        memory_reserved_bytes=torch.cuda.memory_reserved(),
        clocks_power=smi("clocks.sm,power.draw,temperature.gpu"))
    return graphed["device_ms_per_round"]


# -- phase: graph (graph replays vs eager rounds) -------------------------------


def parity_configs(groups: int, planes: bool = False) -> dict:
    """The bench config and a config with timer elections, pre-vote,
    check-quorum and a small ring; `planes` turns on the telemetry and
    fleet summary planes."""
    from etcd_tpu_torch.batched.state import BatchedConfig
    from etcd_tpu_torch.tools.benchlib import bench_config

    return {
        "bench": bench_config(groups, planes, planes),
        "prevote_cq": BatchedConfig(
            num_groups=groups, num_replicas=R, window=16,
            max_ents_per_msg=4, max_props_per_round=4,
            election_timeout=10, heartbeat_timeout=1, pre_vote=True,
            check_quorum=True, auto_compact=True, telemetry=planes,
            fleet_summary=planes),
    }


def assert_engines_equal(a, b, context: str) -> None:
    """Every state and inbox buffer and every plane of two engines equal
    in value and dtype."""
    pairs = [(f"state.{f}", x, y) for f, x, y in
             zip(a.state._fields, a.state, b.state)]
    pairs += [(f"inbox.{f}", x, y) for f, x, y in
              zip(a.inbox._fields, a.inbox, b.inbox)]
    for name, x, y in pairs:
        if x.dtype != y.dtype or not torch.equal(x, y):
            raise AssertionError(f"{context}: {name} differs")
    if a.cfg.telemetry:
        for name, x, y in zip(("counters", "invariants"), a.telemetry(),
                              b.telemetry()):
            if not (x.dtype == y.dtype and (x == y).all()):
                raise AssertionError(f"{context}: telemetry {name} differs")
    if a.cfg.fleet_summary and not (a.fleet_frame() == b.fleet_frame()).all():
        raise AssertionError(f"{context}: fleet frame differs")


def graph_vs_eager(cfg, dev, seed: int) -> dict:
    """One schedule through two engines on `dev`: the closed-loop calls
    through run_rounds (on CUDA, graph replays) on one and as many
    step_round calls on the other, with the same eager control ops
    between them; all buffers equal after every call."""
    from etcd_tpu_torch.batched import MultiRaftEngine

    n, r = cfg.num_instances, cfg.num_replicas
    graphed, eager = (MultiRaftEngine(cfg, device=dev) for _ in range(2))
    both = (graphed, eager)
    gen = torch.Generator().manual_seed(seed)
    for eng in both:
        eng.campaign(range(0, n, r))
    ops = (
        lambda eng: eng.read_index(range(0, n, r)),
        lambda eng: eng.set_membership(1, voters=(0, 1), learners=(2,)),
        lambda eng: eng.drain_fleet() if eng.cfg.fleet_summary else None,
        lambda eng: eng.campaign([2 * r + 1]),
        lambda eng: eng.set_membership(1, voters=(0, 1, 2)),
    )
    blocks = ((1, False), (7, True), (3, False), (12, True), (5, True),
              (12, True))
    for i, (rounds, tick) in enumerate(blocks):
        props = torch.randint(0, cfg.max_props_per_round + 1, (n,),
                              generator=gen, dtype=torch.int32).to(dev)
        graphed.run_rounds(rounds, tick=tick, propose_n=props)
        for _ in range(rounds):
            eager.step_round(tick=tick, propose_n=props)
        assert_engines_equal(graphed, eager, f"block {i}")
        for eng in both:
            ops[i % len(ops)](eng)
        assert_engines_equal(graphed, eager, f"after op {i}")
    return {"rounds": graphed.rounds, "captures": graphed.captures,
            "leaders": int((graphed.state.role == 2).sum()),
            "max_commit": int(graphed.state.commit.max())}


def run_graph(dev) -> None:
    """Graph replays against eager rounds on the card, planes on."""
    for label, cfg in parity_configs(256, planes=True).items():
        res = graph_vs_eager(cfg, dev, SEED)
        if res["captures"] != 2:
            raise AssertionError(f"graph {label}: {res['captures']} captures")
        log("graph", config=label, groups=256, equal=True, **res)


# -- phase: planes (the main path with telemetry and fleet on) ------------------


def run_planes(dev, base_device_ms: float) -> None:
    """The main path with each plane and with both: rate, device time per
    round against the planes-off round's, no invariant tripped."""
    from etcd_tpu_torch.batched.telemetry import TM_INDEX
    from etcd_tpu_torch.obs.fleet import FleetLayout
    from etcd_tpu_torch.tools.benchlib import make_bench_engine, measure_rate

    layout = FleetLayout(MAIN_GROUPS * R, R, MAIN_GROUPS)
    for telemetry, fleet in ((True, False), (False, True), (True, True)):
        eng, props = make_bench_engine(MAIN_GROUPS, telemetry, fleet,
                                       device=dev)
        rate = measure_rate(eng, props, rounds_per_call=8, calls=4)
        prof = profile_rounds(
            lambda k: eng.run_rounds(k, tick=True, propose_n=props), 8)
        fields = {}
        if telemetry:
            counters, inv = eng.drain_telemetry()
            trips = int((inv != 0).sum())
            if trips:
                raise AssertionError(f"invariant_trips = {trips}")
            fields.update(invariant_trips=trips, commit_delta_total=int(
                counters[:, TM_INDEX["commit_delta"]].sum()))
        if fleet:
            census = layout.decode(eng.drain_fleet())
            if census["role_census"][2] != MAIN_GROUPS:
                raise AssertionError(f"fleet: {census['role_census']}")
            fields.update(role_census=census["role_census"].tolist(),
                          top_lag=census["top_lag"].tolist())
        log("planes", telemetry=telemetry, fleet=fleet, groups=MAIN_GROUPS,
            group_rounds_per_s=rate,
            device_ms_per_round=prof["device_ms_per_round"],
            plane_device_ms_per_round=(prof["device_ms_per_round"]
                                       - base_device_ms),
            wall_ms_per_round=prof["wall_ms_per_round"],
            device_busy_share=prof["device_busy_share"], **fields)
        del eng, props


# -- phase: parity (CUDA round vs CPU round) -----------------------------------


SHAPES = ("lanes", "merged", "vectorized")
# Groups of the parity and plane_parity phases (their schedules are the
# same at any width).
PARITY_GROUPS = 128
# Rounds of the parity schedule per deliver shape: the sender scans' eager
# CPU round is ~3x the vectorized one's, so they stop 4 rounds into the
# schedule's partition window (rounds 20-35); the vectorized fold runs
# the window and 5 rounds after it heals.
PARITY_ROUNDS = {"lanes": 24, "merged": 24, "vectorized": 40}


def run_parity(dev, plain_dev=torch.device("cpu"), shapes=SHAPES) -> None:
    """The same schedule through the round on `dev` (on CUDA: the
    kernels) and on `plain_dev` (the CPU: the plain forms), for each
    deliver shape; every state field and the outbox are equal after
    every round."""
    for shape in shapes:
        for label, base in parity_configs(PARITY_GROUPS).items():
            parity_run(base._replace(deliver_shape=shape), label, dev,
                       plain_dev, PARITY_ROUNDS[shape])


def parity_run(cfg, label: str, dev, plain_dev, rounds: int) -> None:
    """One config of the parity phase (run_parity)."""
    from etcd_tpu_torch.batched import hopper_kernels as hk
    from etcd_tpu_torch.batched.state import init_state
    from etcd_tpu_torch.batched.step import (
        NUM_KINDS, empty_msgs, make_step_round, route)

    rng = torch.Generator().manual_seed(SEED)
    n = cfg.num_instances
    sides = {}
    for side, d in (("kernel", dev), ("plain", plain_dev)):
        sides[side] = [
            init_state(cfg, device=d),
            empty_msgs((n, cfg.num_replicas, NUM_KINDS),
                       cfg.max_ents_per_msg, device=d),
            make_step_round(cfg, device=d)]
    hk.reset_launches()
    for rnd in range(rounds):
        # A seeded schedule: early campaigns, steady proposals on every
        # slot (leaders accept), a rolling partition, reads and
        # transfers.
        camp = torch.rand(n, generator=rng) < (0.3 if rnd < 3 else 0.01)
        props = torch.randint(0, cfg.max_props_per_round + 1, (n,),
                              generator=rng, dtype=torch.int32)
        iso = torch.zeros(n, dtype=torch.bool)
        if 20 <= rnd < 35:
            iso[(rnd % R)::R * 7] = True
        read = torch.rand(n, generator=rng) < 0.05
        tr = torch.where(torch.rand(n, generator=rng) < 0.02,
                         torch.randint(1, R + 1, (n,), generator=rng,
                                       dtype=torch.int32), 0)
        tick = torch.full((n,), rnd % 2 == 0 or label != "bench")
        outs = {}
        for name, side in sides.items():
            st, inbox, step = side
            to = lambda x: x.to(st.term.device)  # noqa: E731
            st, out = step(st, inbox, to(tick), to(camp), to(props),
                           to(iso), to(tr), to(read))
            side[0], side[1] = st, route(cfg, out)
            outs[name] = (st, out)
        for part in (0, 1):
            a, b = outs["kernel"][part], outs["plain"][part]
            for f in a._fields:
                x, y = getattr(a, f).cpu(), getattr(b, f)
                if x.dtype != y.dtype or not torch.equal(x, y):
                    raise AssertionError(
                        f"parity {label} {cfg.deliver_shape} round {rnd}: "
                        f"field {f} of "
                        f"{'state' if part == 0 else 'outbox'} differs")
    st = sides["plain"][0]
    log("parity", config=label, shape=cfg.deliver_shape,
        groups=cfg.num_groups, rounds=rounds,
        equal=True, launches=dict(hk.LAUNCHES),
        form_launches=dict(hk.FORM_LAUNCHES),
        leaders=int((st.role == 2).sum()),
        max_commit=int(st.commit.max()), max_term=int(st.term.max()))


# -- phase: shapes (the three deliver shapes at full width) ----------------------

# Loaded rounds of the shapes schedule after the election: (rounds, tick)
# per closed-loop call, the three shapes compared after each call.
SHAPE_BLOCKS = ((8, True), (8, False), (8, True), (8, True), (8, False))


def assert_shapes_agree(engines: dict, context: str) -> None:
    """Every STATE_FIELDS field equal across the shapes' engines."""
    from etcd_tpu_torch.tools.shadow_lockstep import STATE_FIELDS

    (ref_shape, (ref, _)), *rest = engines.items()
    for shape, (eng, _) in rest:
        for f in STATE_FIELDS:
            if not torch.equal(getattr(eng.state, f),
                               getattr(ref.state, f)):
                raise AssertionError(f"shapes {context}: {shape} differs "
                                     f"from {ref_shape} on {f}")


def round_forms_equal_plain(eng, props) -> dict:
    """One eager round of `eng` with each kernel form's first launch
    held against its plain version on the same (cloned) inputs; returns
    each form's largest |kernel - plain| (held at 0)."""
    from etcd_tpu_torch.batched import hopper_kernels as hk

    plain = {hk.quorum_commit: hk.quorum_commit_ref,
             hk.quorum_vote: hk.quorum_vote_ref,
             hk.term_at_batch: hk.term_at_batch_ref}
    return {form: assert_equal(f"{eng.cfg.deliver_shape} {form}",
                               fn(*args), plain[fn](*args))
            for form, (fn, args) in round_forms(engine_round(eng, props)).items()}


def run_shapes(dev, groups: int = MAIN_GROUPS) -> dict:
    """The bench engine at `groups` built once per deliver shape, each
    replayed as a CUDA graph: a seeded loaded schedule with the three
    shapes compared after every closed-loop call, each shape's kernel
    forms held against the plain versions on the round's inputs, then
    per shape its rate, commit p50, device time and kernels a round,
    captures and graph pool. Each shape's launches are counted from 0
    around its own calls. Returns path -> launches for the kernels
    line."""
    from etcd_tpu_torch.analysis.sentinels import CompileBudget
    from etcd_tpu_torch.batched import hopper_kernels as hk
    from etcd_tpu_torch.tools.benchlib import (
        make_bench_engine, measure_commit_p50, measure_rate)

    cuda = dev.type == "cuda"
    if cuda:
        # Graphs of earlier phases' engines are freed now, not in the
        # middle of this phase's pool readings.
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    engines, pools = {}, {}
    for shape in SHAPES:
        t0 = time.perf_counter()
        before = graph_pool_bytes() if cuda else 0
        # The setup's election rounds capture the tick=False graph.
        engines[shape] = make_bench_engine(groups, device=dev,
                                           deliver_shape=shape)
        pools[shape] = {"setup_s": time.perf_counter() - t0,
                        "bytes": (graph_pool_bytes() or 0) - (before or 0)
                        if cuda else 0}
    n = groups * R
    gen = torch.Generator().manual_seed(SEED)
    launches = {s: {k: 0 for k in hk.LAUNCHES} for s in SHAPES}
    forms = {s: {} for s in SHAPES}
    rounds = dict.fromkeys(SHAPES, 0)

    def counted(shape, run):
        hk.reset_launches()
        before = graph_pool_bytes() if cuda else None
        run()
        if cuda:
            torch.cuda.synchronize()
            pools[shape]["bytes"] += (graph_pool_bytes() or 0) - (before or 0)
        for k, v in hk.LAUNCHES.items():
            launches[shape][k] += v
        for k, v in hk.FORM_LAUNCHES.items():
            forms[shape][k] = forms[shape].get(k, 0) + v

    for b, (k, tick) in enumerate(SHAPE_BLOCKS):
        props = torch.randint(0, 3, (n,), generator=gen,
                              dtype=torch.int32).to(dev)
        for shape, (eng, _) in engines.items():
            counted(shape, lambda: eng.run_rounds(k, tick=tick,
                                                  propose_n=props))
            rounds[shape] += k
        assert_shapes_agree(engines, f"block {b}")
    errs = {}
    for shape, (eng, props) in engines.items():
        errs[shape] = round_forms_equal_plain(eng, props)
    assert_shapes_agree(engines, "after the kernel checks")
    # Both tick values are captured by now: the measurements below
    # replay them and capture nothing.
    budget = CompileBudget(0)
    for shape, (eng, _props) in engines.items():
        budget.track(shape, eng)
    for shape, count in launches.items():
        for name, v in count.items():
            if v == 0:
                raise AssertionError(f"shapes: {name} never launched under "
                                     f"{shape}")
    out = {}
    for shape, (eng, props) in engines.items():
        rates = [measure_rate(eng, props, rounds_per_call=8, calls=4)
                 for _ in range(3)]
        p50 = measure_commit_p50(eng)
        prof = (profile_rounds(
            lambda k: eng.run_rounds(k, tick=True, propose_n=props), 8)
            if cuda else {})
        if cuda and eng.captures != 2:
            raise AssertionError(f"shapes {shape}: {eng.captures} captures")
        log("shapes", shape=shape, groups=groups,
            rounds_schedule=rounds[shape],
            group_rounds_per_s=statistics.median(rates),
            group_rounds_per_s_runs=rates, commit_p50_ms=p50[0],
            commit_p50_rounds=p50[1],
            device_ms_per_round=prof.get("device_ms_per_round"),
            wall_ms_per_round=prof.get("wall_ms_per_round"),
            device_kernels_per_round=prof.get("device_kernels_per_round"),
            device_busy_share=prof.get("device_busy_share"),
            hopper_kernels_in_graph=prof.get("hopper_kernels"),
            top_kernels=prof.get("top_kernels", [])[:6],
            captures=eng.capture_stats, graph_pool_bytes=pools[shape],
            launches=launches[shape],
            launches_per_round={k: v / rounds[shape]
                                for k, v in launches[shape].items()},
            form_launches_per_round={k: v / rounds[shape]
                                     for k, v in forms[shape].items()},
            kernel_vs_plain_max_abs_err=errs[shape],
            min_commit=int(eng.commits().min()))
        out[f"shapes_{shape}"] = {"launches": launches[shape],
                                  "forms": forms[shape],
                                  "rounds": rounds[shape]}
    assert_shapes_agree(engines, "after the measurements")
    budget.check()
    log("shapes_budget", captures_after_warmup=budget.report())
    del engines
    if cuda:
        torch.cuda.empty_cache()
    # Graph replays against eager rounds for both scans, at the parity
    # config with timer elections, pre-vote, check-quorum and both planes
    # (the bench config's graphs ran above against the vectorized shape).
    cfg = parity_configs(256, planes=True)["prevote_cq"]
    for shape in SHAPES[:2]:
        res = graph_vs_eager(cfg._replace(deliver_shape=shape), dev, SEED)
        if cuda and res["captures"] != 2:
            raise AssertionError(f"graph {shape}: {res['captures']} "
                                 "captures")
        log("shapes_graph", shape=shape, config="prevote_cq", groups=256,
            equal=True, **res)
    return out


# -- phase: shadow (every shape against the port's scalar Raft) ------------------


def run_shadow(dev, groups: int = 16) -> None:
    """The engine on `dev` against the shadow cluster (the port's scalar
    raft core, replaying the engine's deliver order) for each shape, at
    test_differential's config and `groups` groups, on
    test_differential's and test_deliver_shapes' schedules widened to
    `groups`: (term, role, lead, commit, last) of every instance after
    every round, every log at the end."""
    from etcd_tpu_torch.batched import hopper_kernels as hk
    from etcd_tpu_torch.tools.shadow_lockstep import (
        SCHEDULES, Pair, diff_config, widen)

    for shape in SHAPES:
        t0 = time.perf_counter()
        hk.reset_launches()
        cells = {}
        for name, schedule in SCHEDULES.items():
            pair = Pair(diff_config(groups, shape), device=dev)
            pair.run(widen(schedule, groups))
            pair.compare_logs()
            st = pair.eng.state
            cells[name] = {"rounds": pair.rounds,
                           "leaders": int((st.role == 2).sum()),
                           "max_commit": int(st.commit.max()),
                           "max_term": int(st.term.max())}
        log("shadow", shape=shape, groups=groups, equal=True, cells=cells,
            launches=dict(hk.LAUNCHES), seconds=time.perf_counter() - t0)


def run_chaos_shapes(dev) -> None:
    """The message-fault chaos cell over CUDA members with each sender
    scan shape, strict."""
    for shape in SHAPES[:2]:
        run_chaos(dev, cells=["msg_faults_inproc"], shape=shape,
                  phase="chaos_shapes")


# -- phase: hosted (the rawnode members at full size) ---------------------------

MEMBERS = (1, 2, 3)
PAYLOAD_BYTES = 64
KV_KEYS = 32  # the key space of Harness.propose_kv
LOAD_ROUNDS = 2
PROPS_PER_ROUND = 2  # proposals per group per load round


def hosted_members(cfg, dev, mesh=None) -> dict:
    """Three members in one process, member `mid` holding replica slot
    mid-1 of every group (the hosting layout: rows = G), on `dev` or
    with their rows split over the devices of `mesh`."""
    from etcd_tpu_torch.batched.rawnode import BatchedRawNode

    g = cfg.num_groups
    where = {"device": dev} if mesh is None else {"mesh": mesh}
    return {mid: BatchedRawNode(cfg, groups=np.arange(g, dtype=np.int32),
                                slots=np.full(g, mid - 1, np.int32), **where)
            for mid in MEMBERS}


def route(rns: dict, rd) -> None:
    """The synchronous router of a hosted round: each sub-block of the
    Ready's block to its target member's step_block, each message
    (MsgSnap only) to its target's step after the app-state restore
    hosting does first (install_snapshot_state)."""
    from etcd_tpu_torch.batched.step import T_SNAP

    blk = rd.msg_block
    if blk is not None and len(blk):
        for to, sub in sorted(blk.split_by_target().items()):
            rns[to].step_block(sub)
    for row, m in rd.messages:
        if int(m.type) == T_SNAP:
            rns[m.to].install_snapshot_state(row, m.snapshot.metadata.index)
        rns[m.to].step(row, m)


def ready_digest(rd) -> tuple:
    """Everything protocol-visible in one Ready, hashable (payloads,
    entry types and frame bytes included)."""
    return (
        tuple(rd.hardstates), tuple(iter(rd.entries)),
        tuple((row, tuple(items)) for row, items in rd.committed),
        tuple((row, int(m.type), m.to, m.from_, m.index, m.term, m.log_term,
               m.commit, m.reject, m.reject_hint, m.context,
               m.snapshot.metadata.index, m.snapshot.metadata.term)
              for row, m in rd.messages),
        None if rd.msg_block is None else rd.msg_block.to_bytes(),
        tuple(rd.read_states), tuple(rd.read_opened), tuple(rd.snapshots),
        tuple((row, ring.tobytes()) for row, ring in
              sorted(rd.snap_rings.items())),
        rd.must_sync, rd.contains_updates())


class Harness:
    """The host side of the hosted main path: per member it persists the
    Ready's hardstates and entries (host dicts, as a WAL would) before
    the messages are routed, then applies the committed entries, each
    checked against what that member persisted in this Ready or an
    earlier one. It records each group's proposals and each member's
    committed payloads, and the commit latency of every proposal on its
    group's leader."""

    def __init__(self, rns: dict):
        n = next(iter(rns.values())).n
        self.rns = rns
        self.hard = {mid: {} for mid in rns}
        self.log = {mid: [{} for _ in range(n)] for mid in rns}
        self.applied = {mid: [[] for _ in range(n)] for mid in rns}
        self.proposed = [[] for _ in range(n)]
        self.inflight = [deque() for _ in range(n)]  # (round, t) per proposal
        self.lat_rounds, self.lat_ms = [], []
        self.rounds = 0
        self.times = {mid: {k: [] for k in (
            "stage", "step", "extract", "collect", "harness", "advance")}
            for mid in rns}
        self.round_ms = []
        # on_ready(mid, rd), if set, sees every Ready right after its
        # advance_round.
        self.on_ready = None

    def propose(self, rng, per_group: int) -> None:
        """`per_group` seeded 64-byte payloads on every group's leader
        (group g is led by member g mod 3 + 1)."""
        n = len(self.proposed)
        buf = rng.bytes(PAYLOAD_BYTES * per_group * n)
        self._propose([buf[off:off + PAYLOAD_BYTES] for off in range(
            0, PAYLOAD_BYTES * per_group * n, PAYLOAD_BYTES)], per_group)

    def propose_kv(self, rng, per_group: int) -> None:
        """`per_group` seeded KV payloads on every group's leader, in the
        apply plane's forms: puts of a 16-byte value to one of KV_KEYS
        keys, a fifth of them with a lease of 1-6 ticks, and deletes."""
        from etcd_tpu_torch.batched.applyplane import (
            delete_payload,
            put_payload,
        )

        m = per_group * len(self.proposed)
        keys = rng.randint(0, KV_KEYS, m).tolist()
        kind = rng.rand(m)
        ttls = rng.randint(1, 7, m).tolist()
        vals = rng.bytes(16 * m)
        datas = [delete_payload(b"k%d" % keys[j]) if kind[j] < 0.15 else
                 put_payload(b"k%d" % keys[j], vals[16 * j:16 * j + 16],
                             ttls[j] if kind[j] > 0.8 else 0)
                 for j in range(m)]
        self._propose(datas, per_group)

    def _propose(self, datas: list, per_group: int) -> None:
        now = time.perf_counter()
        for g in range(len(self.proposed)):
            rn = self.rns[g % len(MEMBERS) + 1]
            for data in datas[g * per_group:(g + 1) * per_group]:
                rn.propose(g, data)
                self.proposed[g].append(data)
                self.inflight[g].append((self.rounds, now))

    def member_round(self, mid: int) -> None:
        """One member's round: advance_round, the harness (persist,
        route, apply) and advance, each timed."""
        rn = self.rns[mid]
        rd = rn.advance_round()
        if self.on_ready is not None:
            self.on_ready(mid, rd)
        t0 = time.perf_counter()
        times = self.times[mid]
        for k, v in rn.phase_last.items():
            times[k].append(v * 1e3)
        hard, log = self.hard[mid], self.log[mid]
        for row, term, vote, commit in rd.hardstates:
            hard[row] = (term, vote, commit)
        for row, idx, term, data, _etype in rd.entries:
            log[row][idx] = (term, data)
        route(self.rns, rd)
        now = time.perf_counter()
        applied = self.applied[mid]
        for row, items in rd.committed:
            lead = row % len(MEMBERS) + 1 == mid
            for idx, term, data, _etype in items:
                if log[row].get(idx) != (term, data or b""):
                    raise AssertionError(
                        f"member {mid} row {row}: committed entry {idx} was "
                        "not persisted first")
                if data is not None:
                    applied[row].append(data)
                    if lead:
                        rnd, t = self.inflight[row].popleft()
                        self.lat_rounds.append(self.rounds - rnd + 1)
                        self.lat_ms.append((now - t) * 1e3)
        t1 = time.perf_counter()
        times["harness"].append((t1 - t0) * 1e3)
        rn.advance()
        times["advance"].append((time.perf_counter() - t1) * 1e3)

    def round(self, profile: bool = False) -> dict:
        """One hosted round: every member ticks and advances once, in
        order. With `profile`, each member's round runs under the
        profiler and the round's time is not kept; returns each
        member's device times then."""
        for rn in self.rns.values():
            rn.tick()
        t0 = time.perf_counter()
        device = {}
        for mid in self.rns:
            if profile:
                device[mid] = profile_member_round(self, mid)
            else:
                self.member_round(mid)
        if not profile:
            self.round_ms.append((time.perf_counter() - t0) * 1e3)
        self.rounds += 1
        return device

    def quiet(self) -> bool:
        commits = [rn.m_commit for rn in self.rns.values()]
        return (all(len(a) == len(p) for app in self.applied.values()
                    for a, p in zip(app, self.proposed))
                and all((c == commits[0]).all() for c in commits))

    def check(self) -> None:
        """Every proposal committed on every member exactly once, in
        order, with its bytes; equal commit indexes on all members."""
        for mid, app in self.applied.items():
            bad = [g for g, (a, p) in enumerate(zip(app, self.proposed))
                   if a != p]
            if bad:
                raise AssertionError(
                    f"member {mid}: groups {bad[:5]} committed "
                    f"{[len(app[g]) for g in bad[:5]]} of "
                    f"{[len(self.proposed[g]) for g in bad[:5]]} proposals, "
                    "or not in order")
        commits = [rn.m_commit for rn in self.rns.values()]
        if not all((c == commits[0]).all() for c in commits):
            raise AssertionError("members' commit indexes differ")


def elect_balanced(h: Harness, max_rounds: int = 8) -> int:
    """Group g campaigns on member g mod 3 + 1; rounds until each group
    has its leader."""
    from etcd_tpu_torch.batched.state import LEADER

    n = len(h.proposed)
    for mid, rn in h.rns.items():
        rn.campaign(np.arange(mid - 1, n, len(MEMBERS)))
    for rnd in range(max_rounds):
        h.round()
        if all((rn.m_role[mid - 1::len(MEMBERS)] == LEADER).all()
               for mid, rn in h.rns.items()):
            return rnd + 1
    raise AssertionError("balanced election did not complete")


def load_and_drain(h: Harness, rng, load_rounds: int, max_drain: int = 16,
                   during=None, propose=None) -> int:
    """`load_rounds` rounds with PROPS_PER_ROUND proposals per group
    (h.propose's, or `propose`'s), then rounds until quiet; `during(i)`,
    if given, runs load round i in place of h.round(). Returns the drain
    rounds."""
    for i in range(load_rounds):
        (propose or h.propose)(rng, PROPS_PER_ROUND)
        if during is None:
            h.round()
        else:
            during(i)
    for k in range(max_drain):
        if h.quiet():
            return k
        h.round()
    raise AssertionError(f"not quiet after {max_drain} drain rounds")


def profile_member_round(h: Harness, mid: int) -> dict:
    """Device time of one rawnode round of member `mid` (its graph replay
    and its copies), CUDA activity through torch.profiler; the harness
    work of that member round runs inside the session too."""
    from torch.profiler import ProfilerActivity, profile

    from etcd_tpu_torch.tools.kernel_times import _device_us, kernel_events

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        h.member_round(mid)
        torch.cuda.synchronize()
    events = kernel_events(prof)
    copies = [e for e in events if e.key.startswith(("Memcpy", "Memset"))]
    kernels = [e for e in events if e not in copies]
    if not kernels:
        return {"device_ms": "not measured"}
    return {"device_ms": sum(_device_us(e) for e in kernels) / 1e3,
            "device_kernels": sum(e.count for e in kernels),
            "copy_ms": sum(_device_us(e) for e in copies) / 1e3,
            "copies": {e.key: e.count for e in copies},
            "hopper_kernels": {
                e.key: {"calls": e.count,
                        "device_us_per_call": _device_us(e) / e.count}
                for e in kernels if "quorum_commit_vote" in e.key
                or "term_at_batch" in e.key}}


def run_hosted(dev, groups: int = MAIN_GROUPS,
               load_rounds: int = LOAD_ROUNDS) -> dict:
    """The hosted main path: three members of BatchedRawNode x `groups`
    (the bench config), balanced leaders, PROPS_PER_ROUND 64-byte
    proposals per group per round for `load_rounds` rounds, drained until
    quiet; then a short run with telemetry on. Returns the kernel launches
    and form launches of the main run and its rawnode rounds."""
    from etcd_tpu_torch.batched import hopper_kernels as hk
    from etcd_tpu_torch.tools.benchlib import bench_config

    cuda = dev.type == "cuda"
    rng = np.random.RandomState(SEED)
    t0 = time.perf_counter()
    h = Harness(hosted_members(bench_config(groups), dev))
    setup_s = time.perf_counter() - t0
    elect_rounds = elect_balanced(h)
    hk.reset_launches()
    base_rounds = h.rounds
    h.round_ms.clear()
    for t in h.times.values():
        for v in t.values():
            v.clear()
    device = {}

    def during(i):
        # Load round 1 runs under the profiler, member by member.
        if cuda and i == 1:
            device.update(h.round(profile=True))
        else:
            h.round()

    t0 = time.perf_counter()
    drain = load_and_drain(h, rng, load_rounds, during=during)
    wall_s = time.perf_counter() - t0
    rounds = h.rounds - base_rounds
    launches = dict(hk.LAUNCHES)
    forms = dict(hk.FORM_LAUNCHES)
    h.check()
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"{name} was never launched on the hosted "
                                 "path")
    captures = {mid: rn.captures for mid, rn in h.rns.items()}
    if cuda and set(captures.values()) != {1}:
        raise AssertionError(f"captures per member: {captures}")
    committed = sum(map(len, h.proposed))
    lat_r, lat_ms = np.asarray(h.lat_rounds), np.asarray(h.lat_ms)
    if len(lat_r) != committed:
        raise AssertionError("a proposal's commit was not seen on its leader")
    result = dict(
        groups=groups, members=len(MEMBERS),
        config="bench (R=3, W=32, E=4, P=2, HB=4, auto-compaction)",
        setup_s=setup_s, election_rounds=elect_rounds,
        load_rounds=load_rounds, drain_rounds=drain, rounds=rounds,
        wall_ms_per_hosted_round=statistics.median(h.round_ms),
        wall_ms_per_hosted_round_runs=h.round_ms,
        phase_ms_median={mid: {k: statistics.median(v) for k, v in t.items()}
                         for mid, t in h.times.items()},
        device_per_member_round=device,
        entries_committed=committed,
        entries_committed_per_s=committed / wall_s,
        commit_latency_rounds={"p50": float(np.percentile(lat_r, 50)),
                               "p99": float(np.percentile(lat_r, 99))},
        commit_latency_ms={"p50": float(np.percentile(lat_ms, 50)),
                           "p99": float(np.percentile(lat_ms, 99))},
        launches=launches,
        launches_per_rawnode_round={k: v / (rounds * len(MEMBERS))
                                    for k, v in launches.items()},
        form_launches_per_rawnode_round={
            k: v / (rounds * len(MEMBERS)) for k, v in forms.items()},
        capture_s={mid: [c["seconds"] for c in rn.capture_stats]
                   for mid, rn in h.rns.items()})
    del h
    # A short run with telemetry on: no invariant bit set in any frame.
    ht = Harness(hosted_members(bench_config(groups, telemetry=True), dev))
    elect_balanced(ht)
    trips = []

    def tel_round(_i):
        ht.round()
        trips.extend(int((rn.last_frame[1] != 0).sum())
                     for rn in ht.rns.values())

    load_and_drain(ht, rng, 1, during=tel_round)
    ht.check()
    if any(trips):
        raise AssertionError(f"invariant bits set with telemetry on: {trips}")
    del ht
    log("hosted", **result, telemetry_rows_tripped=sum(trips),
        card=smi("name,power.limit") if cuda else str(dev))
    return {"launches": launches, "forms": forms,
            "rounds": rounds * len(MEMBERS)}


# -- phase: hosted_parity (rawnodes on CUDA vs rawnodes on the CPU) ----------


def leaders_of(rns: dict) -> dict:
    """group -> member id of its leader, from the members' mirrors."""
    from etcd_tpu_torch.batched.state import LEADER

    return {row: mid for mid, rn in rns.items()
            for row in np.nonzero(rn.m_role == LEADER)[0].tolist()}


def hosted_schedule(rnd: int, rns: dict, cfg, payload=None) -> None:
    """Round `rnd`'s staged inputs for one member set, a function of the
    round and the set's own mirrors (equal sets get equal inputs):
    balanced campaigns (timer elections under pre-vote), a tick, seeded
    proposals with some conf-change etypes on each group's leader, and
    the staged edits: ReadIndex, a leader transfer, membership masks,
    a fence, compaction with append pokes, and a member cut off from 32
    groups for long enough to be sent MsgSnap. `payload(rng)` makes each
    proposal's bytes (default: 16 seeded bytes)."""
    g = cfg.num_groups
    if rnd == 0 and not cfg.pre_vote:
        for mid, rn in rns.items():
            rn.campaign(np.arange(mid - 1, g, len(MEMBERS)))
    for rn in rns.values():
        rn.tick()
    lead = leaders_of(rns)
    rng = np.random.RandomState(SEED + rnd)
    for grp in sorted(lead):
        for _ in range(int(rng.randint(0, cfg.max_props_per_round + 1))):
            data = rng.bytes(16) if payload is None else payload(rng)
            rns[lead[grp]].propose(grp, data, etype=int(rng.rand() < 0.1))
    if rnd == 8:
        for grp in range(16):
            if grp in lead:
                rns[lead[grp]].read_index(grp)
    if rnd == 10 and 1 in lead:
        rns[lead[1]].transfer_leader(1, lead[1] % len(MEMBERS))
    if rnd in (12, 18):
        voter = np.ones((4, R), bool)
        learner = np.zeros((4, R), bool)
        if rnd == 12:
            voter[:, 2], learner[:, 2] = False, True
        for rn in rns.values():
            rn.set_membership_many(np.arange(2, 6), voter,
                                   np.zeros((4, R), bool), learner,
                                   np.zeros(4, bool))
    if rnd in (13, 17):
        rns[2].set_fence(7, rnd == 13)
    if rnd == 14:
        for grp in range(4):
            if grp in lead:
                rn = rns[lead[grp]]
                rn.compact(grp, int(rn.m_commit[grp]) - 1)
                rn.poke_append(grp)
    if rnd in (20, 32):
        rns[3].isolate(np.arange(32), on=rnd == 20)


def assert_members_equal(a, b, context: str) -> None:
    """Every device state field (value and dtype) and host mirror of two
    rawnodes equal."""
    for f, x, y in zip(a.state._fields, a.state, b.state):
        x, y = x.cpu(), y.cpu()
        if x.dtype != y.dtype or not torch.equal(x, y):
            raise AssertionError(f"{context}: state.{f} differs")
    for f in ("m_term", "m_vote", "m_commit", "m_last", "m_snap", "m_role",
              "m_lead", "m_ring", "m_lease_ticks", "applied", "stable"):
        x, y = getattr(a, f), getattr(b, f)
        if x.dtype != y.dtype or not np.array_equal(x, y):
            raise AssertionError(f"{context}: {f} differs")


def hosted_lockstep(cfg, sets: list, rounds: int, label: str,
                    schedule=hosted_schedule,
                    check=assert_members_equal) -> dict:
    """Member sets driven through `schedule` (hosted_schedule) in
    lockstep, each set routing its own traffic; after every member round
    the sets' Ready digests are equal, and `check` holds each member
    against its counterpart (state and mirrors)."""
    snaps = 0
    for rnd in range(rounds):
        for rns in sets:
            schedule(rnd, rns, cfg)
        for mid in MEMBERS:
            digests = []
            for rns in sets:
                rd = rns[mid].advance_round()
                route(rns, rd)
                rns[mid].advance()
                digests.append(ready_digest(rd))
            snaps += len(rd.snapshots)
            context = f"{label} round {rnd} member {mid}"
            if any(d != digests[0] for d in digests[1:]):
                raise AssertionError(f"{context}: Readys differ")
            for rns in sets[1:]:
                check(sets[0][mid], rns[mid], context)
    rns = sets[0]
    return {"rounds": rounds, "snapshots_installed": snaps,
            "leaders": len(leaders_of(rns)),
            "max_commit": int(max(rn.m_commit.max() for rn in rns.values())),
            "captures": {mid: rn.captures for mid, rn in rns.items()}}


def run_hosted_parity(dev, plain_dev=torch.device("cpu")) -> None:
    """Three members on `dev` (on CUDA: a graph replay per round) against
    three on the CPU, G=256, in the bench and prevote_cq configs."""
    for label, cfg in parity_configs(256).items():
        res = hosted_lockstep(cfg, [hosted_members(cfg, dev),
                                    hosted_members(cfg, plain_dev)], 40,
                              label)
        if dev.type == "cuda" and set(res["captures"].values()) != {1}:
            raise AssertionError(f"hosted_parity {label}: {res['captures']}")
        if res["leaders"] != 256 or not res["snapshots_installed"]:
            raise AssertionError(f"hosted_parity {label}: {res}")
        log("hosted_parity", config=label, groups=256, equal=True, **res)


# -- phase: plane (the apply plane at full width) -------------------------------

PLANE_DISPATCHES = 40
PLANE_POOL = 48  # keys per ordinary row (fewer than C = 256 slots)
PLANE_OVERFLOW_ROWS = 8  # rows that put fresh keys in every lane
PLANE_WATCH_ROWS = 64
PLANE_SAMPLE_ROWS = 256  # other rows held against the oracle
PLANE_LOAD_ROUNDS = 2
PLANE_CAPTURE_ROWS = 1024


def plane_config(groups: int, base=None):
    """The bench config (or `base`) with the apply plane on, at the
    config's plane defaults (C = 256, WS = 8, A = 8)."""
    from etcd_tpu_torch.tools.benchlib import bench_config

    return (base or bench_config(groups))._replace(apply_plane=True)


def plane_workload(n: int, a: int, dispatches: int, seed: int) -> tuple:
    """Seeded record lanes for `dispatches` dispatches over n rows: each
    row puts (a third with a 1-5 tick lease) and deletes up to A records
    of its own PLANE_POOL keys, the tick advancing 0-2 per dispatch;
    PLANE_OVERFLOW_ROWS rows (the first rows of the returned `special`)
    put a fresh key in every lane, so they pass C keys and overflow.
    Returns (special rows, the key pools, [(ops, keys, vals, ttls,
    tick_add)])."""
    from etcd_tpu_torch.batched.applyplane import OP_DEL, OP_PUT

    rng = np.random.default_rng(seed)
    pool = rng.integers(1, 1 << 31, (n, PLANE_POOL)).astype(np.int32)
    special = rng.choice(n, PLANE_OVERFLOW_ROWS + PLANE_WATCH_ROWS,
                         replace=False)
    over = special[:PLANE_OVERFLOW_ROWS]
    col = np.arange(a)[None, :]
    steps = []
    for _ in range(dispatches):
        lane = col < rng.integers(0, a + 1, (n, 1))
        put = rng.random((n, a)) < 0.7
        ops = np.where(lane, np.where(put, OP_PUT, OP_DEL), 0)
        keys = np.where(lane, np.take_along_axis(
            pool, rng.integers(0, PLANE_POOL, (n, a)), axis=1), 0)
        vals = np.where(ops == OP_PUT, rng.integers(1, 1 << 31, (n, a)), 0)
        ttls = np.where((ops == OP_PUT) & (rng.random((n, a)) < 0.3),
                        rng.integers(1, 6, (n, a)), 0)
        ops[over] = OP_PUT
        keys[over] = rng.integers(1, 1 << 31, (len(over), a))
        vals[over] = rng.integers(1, 1 << 31, (len(over), a))
        ttls[over] = 0
        tick_add = rng.integers(0, 3, n)
        steps.append(tuple(x.astype(np.int32)
                           for x in (ops, keys, vals, ttls, tick_add)))
    return special, pool, steps


def plane_bound(n: int, c: int, ws: int, a: int) -> "tuple[float, str]":
    """The least time of one dispatch on the card: the four [n, C] slot
    lanes read once and written once, the records, tick advance and
    watch keys read once, the [n] state lanes read and written, the
    frame written; or its integer operations (per slot, the expiry
    test and clear, and per record a match and a free test, a score and
    its max) at the 32-bit rate."""
    from etcd_tpu_torch.tools.kernel_times import bound_ms

    nbytes = (4 * n * c * 4 * 2 + (4 * n * a + n + n * ws) * 4
              + 4 * n * 4 * 2 + (4 * n * a + 5 * n) * 4 + n)
    ops = n * c * (6 + 4 * a)
    return bound_ms(nbytes, ops)


class PlaneOwner:
    """A plane and its record inputs in buffers kept for its lifetime,
    as a plane-on rawnode keeps them: each dispatch copies the records
    in and, on CUDA, replays one CUDA graph of dispatch() whose frame
    lands in frame buffers (graphed=False, or the CPU, calls dispatch()
    eagerly)."""

    def __init__(self, cfg, n: int, dev, graphed: bool):
        from etcd_tpu_torch.batched.applyplane import init_plane
        from etcd_tpu_torch.batched.graph import RoundGraphs
        from etcd_tpu_torch.batched.state import I32

        a = cfg.apply_records
        self.plane = init_plane(cfg, n, device=dev)
        self.inputs = tuple(torch.zeros((n, a) if k < 4 else (n,),
                                        dtype=I32, device=dev)
                            for k in range(5))
        self.frame = None
        self.graphed = graphed and dev.type == "cuda"
        self.graphs = RoundGraphs()

    def _body(self):
        from etcd_tpu_torch.batched.applyplane import dispatch

        frame = dispatch(self.plane, *self.inputs)
        if self.frame is None:
            self.frame = [torch.empty_like(x) for x in frame]
        for buf, x in zip(self.frame, frame):
            buf.copy_(x)

    def dispatch(self, step) -> float:
        """One dispatch of `step`'s numpy records; returns the device ms
        of the dispatch alone (CUDA events around it)."""
        for buf, x in zip(self.inputs, step):
            buf.copy_(torch.from_numpy(x))
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        if self.graphed:
            self.graphs.run("plane", self._body)
        else:
            self._body()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)


def oracle_check(cfg, plane, frames_rows: list, rows, watch, steps) -> int:
    """Replay `steps` for `rows` through PlaneOracle (with the rows'
    armed watches `watch` [len(rows), WS]) and hold the plane's rows
    slot for slot, and each dispatch's events (`frames_rows`: per
    dispatch the rows' ev_op, ev_key, ev_rev, ev_wmask and expired, on
    the host), to it. Returns the events compared."""
    from etcd_tpu_torch.batched.applyplane import KV_LANES, PlaneOracle

    rows_t = torch.as_tensor(rows, dtype=torch.int64, device=plane.rev.device)
    got = {f: getattr(plane, f).index_select(0, rows_t).cpu().numpy()
           for f in plane._fields}
    events = 0
    for j, r in enumerate(rows.tolist()):
        o = PlaneOracle(cfg)
        o.watch_key = watch[j].tolist()
        for step in steps:
            ops, keys, vals, ttls, tick_add = (x[r] for x in step)
            o.dispatch(list(zip(ops.tolist(), keys.tolist(), vals.tolist(),
                                ttls.tolist())), int(tick_add))
        for f in KV_LANES:
            if got[f][j].tolist() != getattr(o, f):
                raise AssertionError(f"plane row {r}: {f} != the oracle's")
        if (int(got["rev"][j]), int(got["tick"][j]),
                bool(got["overflow"][j]), int(got["slots_hw"][j])) != (
                o.rev, o.tick, o.overflow, o.slots_hw):
            raise AssertionError(f"plane row {r}: counters != the oracle's")
        evs = [tuple(int(x[j, k]) for x in fr[:4])
               for fr in frames_rows for k in range(cfg.apply_records)
               if fr[0][j, k] != 0]
        if evs != o.events or sum(int(fr[4][j]) for fr in frames_rows) != (
                o.expired):
            raise AssertionError(f"plane row {r}: events != the oracle's")
        events += len(evs)
    return events


def plane_dispatch_check(dev, n: int, dispatches: int = PLANE_DISPATCHES,
                         sample: int = PLANE_SAMPLE_ROWS) -> dict:
    """The dispatch alone over n rows: a graphed and an eager plane fold
    the same seeded records; every frame and the final planes are equal,
    the armed-watch rows, the overflowing rows and `sample` other rows
    equal PlaneOracle's replay slot for slot with the same events, and
    gather_rows equals indexing. Returns the times and counts."""
    from etcd_tpu_torch.batched.applyplane import gather_rows
    from etcd_tpu_torch.tools.kernel_times import _device_us, profile_kernels

    cfg = plane_config(n)
    a, ws, c = cfg.apply_records, cfg.apply_watch_slots, cfg.apply_capacity
    special, pool, steps = plane_workload(n, a, dispatches, SEED)
    watch_rows = special[PLANE_OVERFLOW_ROWS:]
    rest = np.setdiff1d(np.arange(n), special)
    others = np.random.default_rng(SEED + 1).choice(
        rest, min(sample, len(rest)), replace=False)
    rows = np.concatenate([special, others])
    watch = np.zeros((n, ws), np.int32)
    watch[watch_rows, 0] = pool[watch_rows, 0]
    watch[watch_rows, ws - 1] = pool[watch_rows, 1]
    owners = [PlaneOwner(cfg, n, dev, graphed) for graphed in (True, False)]
    for o in owners:
        o.plane.watch_key.copy_(torch.from_numpy(watch))
    rows_t = torch.as_tensor(rows, dtype=torch.int64, device=dev)
    graph_ms, eager_ms, frames_rows = [], [], []
    for i, step in enumerate(steps):
        graph_ms.append(owners[0].dispatch(step))
        eager_ms.append(owners[1].dispatch(step))
        for f, x, y in zip(("ev_op", "ev_key", "ev_rev", "ev_wmask", "puts",
                            "dels", "expired", "slots_used", "leases",
                            "overflow"), owners[0].frame, owners[1].frame):
            if not torch.equal(x, y):
                raise AssertionError(f"plane dispatch {i}: graphed frame {f} "
                                     "!= the eager one")
        frames_rows.append([x.index_select(0, rows_t).cpu().numpy()
                            for x in owners[0].frame[:4]]
                           + [owners[0].frame[6].index_select(0, rows_t)
                              .cpu().numpy()])
    for f, x, y in zip(owners[0].plane._fields, owners[0].plane,
                       owners[1].plane):
        if not torch.equal(x, y):
            raise AssertionError(f"plane: graphed {f} != the eager one")
    plane = owners[0].plane
    events = oracle_check(cfg, plane, frames_rows, rows, watch[rows], steps)
    over = special[:PLANE_OVERFLOW_ROWS]
    if not plane.overflow[torch.as_tensor(over, device=dev)].all():
        raise AssertionError("an overflow row did not overflow")
    for got, f in zip(gather_rows(plane, rows),
                      ("kv_key", "kv_rev", "kv_val", "kv_lease", "rev",
                       "tick", "overflow")):
        if not torch.equal(got, getattr(plane, f)[rows_t]):
            raise AssertionError(f"gather_rows {f} != indexing")
    kernels = profile_kernels(lambda: owners[1].dispatch(steps[-1]))
    copies = [e for e in kernels if e.key.startswith(("Memcpy", "Memset"))]
    kernels = sorted((e for e in kernels if e not in copies),
                     key=lambda e: -_device_us(e))
    bound, bound_by = plane_bound(n, c, ws, a)
    warm = graph_ms[1:]
    return {
        "rows": n, "C": c, "WS": ws, "A": a, "dispatches": dispatches,
        "graphed_eq_eager": True, "oracle_rows": len(rows),
        "oracle_events": events, "overflow_rows": int(plane.overflow.sum()),
        "device_ms_per_dispatch": statistics.median(warm),
        "device_ms_per_dispatch_runs": warm,
        "eager_ms_per_dispatch": statistics.median(eager_ms[1:]),
        "launches_per_dispatch": sum(e.count for e in kernels),
        "kernel_ms_per_dispatch": sum(map(_device_us, kernels)) / 1e3,
        "top_kernels": [{"name": e.key[:80], "calls": e.count,
                         "device_us": _device_us(e)} for e in kernels[:8]],
        "bound_ms": bound, "bound_by": bound_by,
        "plane_bytes": sum(x.nbytes for x in plane)}


def plane_log_records(items) -> list:
    """The apply records one row's committed items make, as the rawnode
    makes them (conf entries, holes and non-KV payloads skipped)."""
    from etcd_tpu_torch.batched.applyplane import (
        OP_PUT,
        fnv1a32,
        parse_payload,
    )

    out = []
    for _i, _t, d, et in items:
        p = parse_payload(d) if et == 0 and d else None
        if p is not None:
            op, k, v, ttl = p
            out.append((op, fnv1a32(k), fnv1a32(v) if op == OP_PUT else 0,
                        ttl if op == OP_PUT else 0))
    return out


def time_plane(rn, stats: dict) -> None:
    """Time member `rn`'s plane: the wall ms of each _plane_dispatch
    (parse, hash, stage, the replays and their wait), on CUDA the device
    ms of each replay of the plane graph (CUDA events), and the host ms
    of each _plane_dispatch: its wall less its replays' device time."""
    inner_dispatch, inner_run = rn._plane_dispatch, rn._graphs.run
    cuda = rn._cuda

    def plane_dispatch(committed, ticks):
        t0 = time.perf_counter()
        before = len(stats["replays"])
        chunks = rn.plane_stats["dispatches"]
        inner_dispatch(committed, ticks)
        wall = (time.perf_counter() - t0) * 1e3
        device = [s.elapsed_time(e) for s, e in stats["replays"][before:]
                  if s]
        stats["wall_ms"].append(wall)
        stats["host_ms"].append(wall - sum(device))
        stats["chunks"].append(rn.plane_stats["dispatches"] - chunks)
        stats["device_ms"].extend(device)

    def run(key, body, times=1, **info):
        if key != "plane":
            return inner_run(key, body, times, **info)
        if not cuda:
            stats["replays"].append((None, None))
            return inner_run(key, body, times, **info)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        inner_run(key, body, times, **info)
        end.record()
        stats["replays"].append((start, end))

    rn._plane_dispatch, rn._graphs.run = plane_dispatch, run


def run_plane_hosted(dev, groups: int = MAIN_GROUPS,
                     load_rounds: int = PLANE_LOAD_ROUNDS) -> dict:
    """Three plane-on members of `groups` groups (the bench config),
    balanced leaders, KV proposals (Harness.propose_kv) for
    `load_rounds` rounds, drained until quiet: every proposal commits on
    every member; each leader's plane on the sampled rows equals a
    PlaneOracle replay of that leader's committed stream, with the same
    watch events; a 1,024-row plane_capture restored into another member
    captures equal there. Returns the kernel launches of the load."""
    from etcd_tpu_torch.batched import hopper_kernels as hk
    from etcd_tpu_torch.batched.applyplane import PlaneOracle, fnv1a32
    from etcd_tpu_torch.batched.graph import device_work

    cuda = dev.type == "cuda"
    cfg = plane_config(groups)
    ws = cfg.apply_watch_slots
    rng = np.random.RandomState(SEED + 5)
    t0 = time.perf_counter()
    h = Harness(hosted_members(cfg, dev))
    setup_s = time.perf_counter() - t0
    rows = np.unique(np.linspace(0, groups - 1, PLANE_SAMPLE_ROWS)
                     .astype(np.int64))
    row_set = set(rows.tolist())
    watch = (fnv1a32(b"k1"), fnv1a32(b"k2"))
    for rn in h.rns.values():
        for r in rows.tolist():
            rn.watch_set(r, 0, watch[0])
            rn.watch_set(r, ws - 1, watch[1])
    log = {mid: [] for mid in MEMBERS}  # per member round: row -> items
    h.on_ready = lambda mid, rd: log[mid].append(
        {row: items for row, items in rd.committed if row in row_set})
    stats = {mid: {"wall_ms": [], "host_ms": [], "device_ms": [],
                   "chunks": [], "replays": []} for mid in MEMBERS}
    for mid, rn in h.rns.items():
        time_plane(rn, stats[mid])
    elect_balanced(h)
    for st in stats.values():
        for v in st.values():
            v.clear()
    hk.reset_launches()
    base = h.rounds
    t0 = time.perf_counter()
    drain = load_and_drain(h, rng, load_rounds, propose=h.propose_kv)
    wall_s = time.perf_counter() - t0
    launches = dict(hk.LAUNCHES)
    forms = dict(hk.FORM_LAUNCHES)
    h.check()
    # Each sampled row against the oracle, on its leader: one dispatch
    # per member round (every round ticks every row once).
    events = 0
    drained = {mid: rn.drain_plane_events() for mid, rn in h.rns.items()}
    for mid, rn in h.rns.items():
        mine = rows[rows % len(MEMBERS) == mid - 1]
        caps = rn.plane_capture(mine)
        with device_work():
            hw = rn.plane.slots_hw.cpu().numpy()
        for r, cap in zip(mine.tolist(), caps):
            o = PlaneOracle(cfg)
            o.watch_key[0], o.watch_key[ws - 1] = watch
            for got in log[mid]:
                o.dispatch(plane_log_records(got.get(r, ())), 1)
            want = {**o.state(), "tick": o.tick}
            for f in ("kv_key", "kv_rev", "kv_val", "kv_lease", "rev",
                      "tick", "overflow"):
                if cap[f] != want[f]:
                    raise AssertionError(f"member {mid} row {r}: plane {f} "
                                         "!= the oracle's")
            if int(hw[r]) != o.slots_hw:
                raise AssertionError(f"member {mid} row {r}: slots_hw")
            evs = [e[1:] for e in drained[mid] if e[0] == r]
            if evs != [e for e in o.events if e[3]]:
                raise AssertionError(f"member {mid} row {r}: watch events")
            events += len(evs)
    if not events:
        raise AssertionError("no watch event on the sampled rows")
    # A capture restored into another member captures equal there (its
    # round runs with no tick and nothing to commit, so no dispatch).
    cap_rows = np.unique(np.linspace(
        0, groups - 1, min(PLANE_CAPTURE_ROWS, groups)).astype(np.int64))
    t0 = time.perf_counter()
    caps = h.rns[1].plane_capture(cap_rows)
    capture_ms = (time.perf_counter() - t0) * 1e3
    for r, cap in zip(cap_rows.tolist(), caps):
        h.rns[2].plane_restore_row(
            r, cap["kv_key"], cap["kv_rev"], cap["kv_val"], cap["kv_lease"],
            cap["rev"], cap["tick"], cap["overflow"], cap["applied"],
            lessor=[(bytes.fromhex(k), e) for k, e in cap["lessor"]])
    h.member_round(2)
    if h.rns[2].plane_capture(cap_rows) != caps:
        raise AssertionError("a restored plane image captures differently")
    rounds = h.rounds - base
    rn1 = h.rns[1]
    plane_bytes = sum(x.nbytes for x in rn1.plane)
    buffer_bytes = plane_bytes + sum(
        x.nbytes for x in (*rn1._plane_in, *rn1._plane_out,
                           *[y for chunk in rn1._plane_chunks
                             for part in chunk for y in part]))
    allst = {k: [v for st in stats.values() for v in st[k]]
             for k in ("wall_ms", "host_ms", "device_ms", "chunks")}
    committed = sum(map(len, h.proposed))
    result = dict(
        groups=groups, members=len(MEMBERS), config="bench + apply plane "
        "(C=256, WS=8, A=8)", setup_s=setup_s, load_rounds=load_rounds,
        drain_rounds=drain, rounds=rounds, entries_committed=committed,
        entries_committed_per_s=committed / wall_s,
        wall_ms_per_hosted_round=statistics.median(h.round_ms[-rounds:]),
        plane_dispatch_wall_ms_median=statistics.median(allst["wall_ms"]),
        plane_dispatch_wall_ms_max=max(allst["wall_ms"]),
        plane_dispatch_host_ms_median=statistics.median(allst["host_ms"]),
        plane_device_ms_per_chunk=(statistics.median(allst["device_ms"])
                                   if allst["device_ms"] else "not measured"),
        chunks_per_member_round=statistics.mean(allst["chunks"]),
        chunks_max=max(allst["chunks"]),
        plane_stats={mid: rn.plane_stats for mid, rn in h.rns.items()},
        oracle_rows=len(rows), watch_events_checked=events,
        capture_rows=len(cap_rows), capture_ms=capture_ms,
        plane_state_bytes=plane_bytes, plane_buffer_bytes=buffer_bytes,
        captures={mid: rn.captures for mid, rn in h.rns.items()},
        launches=launches)
    if cuda and set(result["captures"].values()) != {2}:
        raise AssertionError(f"captures per member: {result['captures']}")
    return {"result": result, "launches": launches, "forms": forms,
            "rounds": rounds * len(MEMBERS)}


def run_plane(dev) -> dict:
    """The apply plane at full width: the dispatch alone at G = 65,536
    rows, then three plane-on hosted members. Returns the hosted run's
    kernel launches."""
    alone = plane_dispatch_check(dev, MAIN_GROUPS)
    hosted = run_plane_hosted(dev)
    log("plane", dispatch=alone, hosted=hosted["result"],
        card=smi("name,power.limit") if dev.type == "cuda" else str(dev))
    return {k: hosted[k] for k in ("launches", "forms", "rounds")}


# -- phase: plane_parity (plane-on rawnodes on CUDA vs the CPU) -----------------


def kv_payload(rng) -> bytes:
    """One seeded KV payload of hosted_schedule's plane runs."""
    from etcd_tpu_torch.batched.applyplane import delete_payload, put_payload

    key = b"k%d" % rng.randint(0, 12)
    u = rng.rand()
    if u < 0.2:
        return delete_payload(key)
    return put_payload(key, rng.bytes(8), int(rng.randint(1, 8))
                       if u > 0.75 else 0)


def plane_schedule(rnd: int, rns: dict, cfg) -> None:
    """hosted_schedule with KV payloads, watch arms on every member at
    rounds 2 and 21, and at round 25 member 1's images of rows 0-7
    restored into member 3."""
    from etcd_tpu_torch.batched.applyplane import fnv1a32

    hosted_schedule(rnd, rns, cfg, payload=kv_payload)
    if rnd in (2, 21):
        for rn in rns.values():
            for row in range(0, cfg.num_groups, 3):
                rn.watch_set(row, row % cfg.apply_watch_slots,
                             fnv1a32(b"k%d" % (row % 4 + rnd % 2)))
    if rnd == 25:
        for row, cap in enumerate(rns[1].plane_capture(range(8))):
            rns[3].plane_restore_row(
                row, cap["kv_key"], cap["kv_rev"], cap["kv_val"],
                cap["kv_lease"], cap["rev"], cap["tick"], cap["overflow"],
                cap["applied"],
                lessor=[(bytes.fromhex(k), e) for k, e in cap["lessor"]])


def assert_planes_equal(a, b, context: str) -> None:
    """assert_members_equal, and every plane tensor, plane_stats, the
    plane mirrors, the lessor, the drained events and a capture of every
    row equal."""
    assert_members_equal(a, b, context)
    for f, x, y in zip(a.plane._fields, a.plane, b.plane):
        if not torch.equal(x.cpu(), y.cpu()):
            raise AssertionError(f"{context}: plane.{f} differs")
    for f in ("m_plane_tick", "m_plane_applied"):
        if not np.array_equal(getattr(a, f), getattr(b, f)):
            raise AssertionError(f"{context}: {f} differs")
    if (a.plane_stats != b.plane_stats
            or list(a.plane_lessor.items()) != list(b.plane_lessor.items())
            or a.drain_plane_events() != b.drain_plane_events()
            or a.plane_capture(range(a.n)) != b.plane_capture(range(b.n))):
        raise AssertionError(f"{context}: plane stats, lessor, events or "
                             "captures differ")


def plane_beside_capture(cfg, dev, rounds: int = 12) -> dict:
    """Member 1 of a plane-on set that has captured both its graphs runs
    rounds (each with a plane dispatch) and plane_captures in a thread,
    while the main thread builds a fresh plane-on set and runs its first
    rounds, whose captures meet the thread's device work. No error, and
    two captures per fresh member."""
    old = hosted_members(cfg, dev)
    for rnd in range(4):
        plane_schedule(rnd, old, cfg)
        for mid in MEMBERS:
            rd = old[mid].advance_round()
            route(old, rd)
            old[mid].advance()
    stop, errors, loops = threading.Event(), [], [0]

    def busy():
        rn = old[1]
        try:
            while not stop.is_set():
                rn.tick()
                rn.advance_round()
                rn.advance()
                rn.plane_capture(range(0, rn.n, 7))
                loops[0] += 1
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append(e)

    t = threading.Thread(target=busy)
    t.start()
    try:
        fresh = hosted_members(cfg, dev)
        for rnd in range(rounds):
            plane_schedule(rnd, fresh, cfg)
            for mid in MEMBERS:
                rd = fresh[mid].advance_round()
                route(fresh, rd)
                fresh[mid].advance()
    finally:
        stop.set()
        t.join(120)
    if errors:
        raise errors[0]
    caps = {mid: rn.captures for mid, rn in fresh.items()}
    if dev.type == "cuda" and set(caps.values()) != {2}:
        raise AssertionError(f"captures beside the thread: {caps}")
    return {"thread_rounds": loops[0], "fresh_captures": caps}


def run_plane_parity(dev, plain_dev=torch.device("cpu")) -> None:
    """Plane-on members on `dev` (on CUDA: a graph replay per round and
    per plane dispatch) against plane-on members on the CPU, G =
    PARITY_GROUPS, in the bench and prevote_cq configs; then a dispatch
    and captures in a thread beside another member set's first
    captures."""
    for label, base in parity_configs(PARITY_GROUPS).items():
        cfg = plane_config(PARITY_GROUPS, base)
        sets = [hosted_members(cfg, dev), hosted_members(cfg, plain_dev)]
        res = hosted_lockstep(cfg, sets, 40, label, schedule=plane_schedule,
                              check=assert_planes_equal)
        stats = sets[0][1].plane_stats
        if dev.type == "cuda" and set(res["captures"].values()) != {2}:
            raise AssertionError(f"plane_parity {label}: {res['captures']}")
        if not (stats["puts"] and stats["dels"] and stats["expired"]
                and stats["watch_events"]):
            raise AssertionError(f"plane_parity {label}: idle plane {stats}")
        log("plane_parity", config=label, groups=PARITY_GROUPS, equal=True,
            **res, plane_stats_member_1=stats)
    cfg = plane_config(PARITY_GROUPS, parity_configs(PARITY_GROUPS)[
        "prevote_cq"])
    log("plane_parity", case="dispatch and capture beside a capture",
        **plane_beside_capture(cfg, dev))


# -- phase: node (three BatchedNodes at raftexample's default width) ------------

# raftexample's member at its defaults (raftexample/raftnode.py and
# BatchedNode's): R = 3, a W = 32,768 term ring, election 10 ticks,
# heartbeat 1, E = 8, P = 8, pre-vote and check-quorum.
NODE_WINDOW = 32768
NODE_PUTS = 4_000
PUTS_PER_ROUND = 8  # P: what a leader appends in one round
# Pump rounds of each load block of node_schedule: at 8 puts a round,
# the node phase makes 4,032 puts, node_parity 352.
NODE_LOAD = (160, 120, 40, 60, 120)
PARITY_LOAD = (12, 10, 6, 8, 4)


def node_plain(x):
    """A Ready, a Status or another dataclass tree as plain values
    (enums as ints, sets sorted, the tracker's config by its fields), for
    an exact comparison."""
    import dataclasses
    import enum

    if dataclasses.is_dataclass(x):
        return (type(x).__name__, {f.name: node_plain(getattr(x, f.name))
                                   for f in dataclasses.fields(x)})
    if isinstance(x, enum.Enum):
        return int(x)
    if isinstance(x, (list, tuple)):
        return [node_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: node_plain(v) for k, v in x.items()}
    if isinstance(x, (set, frozenset)):
        return sorted(node_plain(v) for v in x)
    if hasattr(x, "__dict__"):
        return (type(x).__name__, node_plain(vars(x)))
    return x


class NodeSet:
    """Three BatchedNodes on one device, driven by a synchronous pump:
    every member ticks, then each in turn runs ready(), applies (conf
    changes through apply_conf_change, puts to its list, a snapshot's
    data as the whole list), routes its messages to the others' step
    and advances. Records every put's origin and its commit latency on
    the first member that applies it (the leader)."""

    def __init__(self, dev):
        from etcd_tpu_torch.batched.node import BatchedNode

        t0 = time.perf_counter()
        self.nodes = {i: BatchedNode(i, list(MEMBERS), window=NODE_WINDOW,
                                     device=dev) for i in MEMBERS}
        self.setup_s = time.perf_counter() - t0
        self.applied = {i: [] for i in MEMBERS}
        self.out = set()  # members cut off or removed: no puts via them
        self.cut = set()  # members whose messages are dropped both ways
        self.snaps, self.reads, self.dropped = [], [], []
        self.pending = {}  # put -> (pump round, time) until applied
        self.order = {i: [] for i in MEMBERS}  # puts handed to member i
        self.lat_rounds, self.lat_ms = [], []
        self.rounds = self.node_rounds = 0
        self.ready_ms, self.turn_ms, self.device = [], [], {}

    def leader(self) -> int:
        lead = [i for i, n in self.nodes.items() if n.rn.is_leader(0)]
        return lead[0] if len(lead) == 1 else 0

    def settled(self, want=None) -> bool:
        lead = self.leader()
        return lead != 0 and lead == (want or lead) and all(
            self.nodes[i].rn.lead(0) == lead
            for i in MEMBERS if i not in self.out)

    def commit(self, i: int) -> int:
        return self.nodes[i].status().basic.hard_state.commit

    def quiet(self) -> bool:
        lead = self.leader()
        live = [i for i in MEMBERS if i not in self.out]
        return lead != 0 and not self.pending and all(
            self.applied[i] == self.applied[lead]
            and self.commit(i) == self.commit(lead) for i in live)

    def put(self, via: int, data: bytes) -> None:
        self.nodes[via].propose(data)
        self.pending[data] = (self.rounds, time.perf_counter())
        self.order[via].append(data)

    def apply(self, i: int, rd) -> None:
        from etcd_tpu_torch.raft.types import (
            ConfChange, ConfChangeV2, EntryType)

        n = self.nodes[i]
        if rd.snapshot.metadata.index:
            data = rd.snapshot.data
            self.applied[i] = [data[k:k + PAYLOAD_BYTES]
                               for k in range(0, len(data), PAYLOAD_BYTES)]
            self.snaps.append((i, rd.snapshot.metadata.index))
        now = time.perf_counter()
        for e in rd.committed_entries:
            if e.type == EntryType.EntryConfChange and e.data:
                n.apply_conf_change(ConfChange.unmarshal(e.data))
            elif e.type == EntryType.EntryConfChangeV2:
                n.apply_conf_change(ConfChangeV2.unmarshal(e.data))
            elif e.data:
                self.applied[i].append(e.data)
                born = self.pending.pop(e.data, None)
                if born is not None:
                    self.lat_rounds.append(self.rounds - born[0] + 1)
                    self.lat_ms.append((now - born[1]) * 1e3)
        self.reads += [(i, rs.index, rs.request_ctx) for rs in rd.read_states]

    def member(self, i: int, digest: bool = False):
        """Member i's turn; with `digest`, its Ready as plain values,
        taken before routing (which may edit a MsgSnap in place)."""
        from etcd_tpu_torch.batched.node import ProposalDroppedError

        n = self.nodes[i]
        t0 = time.perf_counter()
        rd = n.ready(timeout=0)
        t1 = time.perf_counter()
        if rd is None:
            return None
        got = node_plain(rd) if digest else None
        self.apply(i, rd)
        for m in rd.messages:
            if i in self.cut or m.to in self.cut:
                continue
            try:
                self.nodes[m.to].step(m)
            except ProposalDroppedError as e:
                self.dropped.append(str(e))
        n.advance()
        self.node_rounds += 1
        self.ready_ms.append((t1 - t0) * 1e3)
        self.turn_ms.append((time.perf_counter() - t0) * 1e3)
        return got

    def profile_member(self, i: int) -> dict:
        """Member i's turn under the profiler: the device time of its
        node round (its graph replay and its copies)."""
        from torch.profiler import ProfilerActivity, profile

        from etcd_tpu_torch.tools.kernel_times import _device_us, kernel_events

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            self.member(i)
            torch.cuda.synchronize()
        events = kernel_events(prof)
        copies = [e for e in events if e.key.startswith(("Memcpy", "Memset"))]
        kernels = [e for e in events if e not in copies]
        if not kernels:
            return {"device_ms": "not measured"}
        return {"device_ms": sum(_device_us(e) for e in kernels) / 1e3,
                "device_kernels": sum(e.count for e in kernels),
                "copy_ms": sum(_device_us(e) for e in copies) / 1e3,
                "copies": sum(e.count for e in copies),
                "hopper_kernels": {
                    e.key: {"calls": e.count,
                            "device_us_per_call": _device_us(e) / e.count}
                    for e in kernels if "quorum_commit_vote" in e.key
                    or "term_at_batch" in e.key}}


def node_round(sets: list, profile: bool = False) -> None:
    """One pump round of every set in lockstep. With two or more sets,
    member i's Readys are equal across the sets after each turn, and so
    is every member's status() after the round. With `profile`, the
    leader's and a follower's turns run under the profiler."""
    for ns in sets:
        for n in ns.nodes.values():
            n.tick()
    lead = sets[0].leader()
    for i in MEMBERS:
        if len(sets) == 1:
            if profile and (i == lead or i == lead % 3 + 1):
                sets[0].device["leader" if i == lead else "follower"] = (
                    sets[0].profile_member(i))
            else:
                sets[0].member(i)
            continue
        got = [ns.member(i, digest=True) for ns in sets]
        if any(g != got[0] for g in got[1:]):
            raise AssertionError(f"node round {sets[0].rounds} member {i}: "
                                 "Readys differ")
    if len(sets) > 1:
        for i in MEMBERS:
            st = [node_plain(ns.nodes[i].status()) for ns in sets]
            if any(x != st[0] for x in st[1:]):
                raise AssertionError(f"node round {sets[0].rounds} member "
                                     f"{i}: status differs")
    for ns in sets:
        ns.rounds += 1


def node_until(sets: list, pred, what: str, max_rounds: int = 600) -> int:
    """Pump rounds until `pred(sets[0])`; at most `max_rounds` (a
    follower catches up E = 8 entries a round, so a catch-up of a
    thousand entries takes ~130)."""
    for k in range(max_rounds):
        if pred(sets[0]):
            return k
        node_round(sets)
    raise AssertionError(f"node: {what} not reached in {max_rounds} rounds")


def node_load(sets: list, rng, rounds: int, profile_at=None) -> None:
    """`rounds` pump rounds with PUTS_PER_ROUND seeded 64-byte puts each;
    every third put is handed to a follower, which forwards it."""
    for k in range(rounds):
        ns = sets[0]
        lead = ns.leader()
        fwd = [i for i in MEMBERS if i != lead and i not in ns.out]
        for j in range(PUTS_PER_ROUND):
            data = rng.bytes(PAYLOAD_BYTES)
            count = sum(map(len, ns.order.values()))
            via = fwd[count % len(fwd)] if fwd and count % 3 == 0 else lead
            for s in sets:
                s.put(via, data)
        node_round(sets, profile=profile_at == k)


def node_schedule(sets: list, load: tuple, profile: bool = False) -> dict:
    """The node schedule on member sets in lockstep: election; load;
    ReadIndex at a quiet point (its index is the leader's commit); a
    leadership transfer; a voter removed (load on two voters) and added
    back; a follower cut off while the leader snapshots and compacts,
    then caught up by MsgSnap; load. Returns the step counts."""
    from etcd_tpu_torch.raft.types import ConfChange, ConfChangeType

    rng = np.random.RandomState(SEED)
    ns = sets[0]
    node_until(sets, lambda s: s.settled(), "election")
    lead = ns.leader()
    node_load(sets, rng, load[0], profile_at=load[0] // 2 if profile else None)
    node_until(sets, NodeSet.quiet, "quiet after load 1")

    for s in sets:
        s.nodes[lead].read_index(b"read-1")
    node_until(sets, lambda s: s.reads, "the read state")
    if ns.reads[0] != (lead, ns.commit(lead), b"read-1"):
        raise AssertionError(f"read state {ns.reads} at commit "
                             f"{ns.commit(lead)}")

    target = lead % 3 + 1
    for s in sets:
        s.nodes[lead].transfer_leadership(lead, target)
    node_until(sets, lambda s: s.settled(target), "the transfer")
    lead = target
    node_load(sets, rng, load[1])
    node_until(sets, NodeSet.quiet, "quiet after load 2")

    victim = lead % 3 + 1
    for s in sets:
        s.out.add(victim)
        s.nodes[lead].propose_conf_change(ConfChange(
            id=1, type=ConfChangeType.ConfChangeRemoveNode, node_id=victim))
    node_until(sets, lambda s: all(
        victim not in s.nodes[i]._current_conf_state().voters
        for i in MEMBERS if i != victim), "the removal")
    node_load(sets, rng, load[2])
    for s in sets:
        s.nodes[lead].propose_conf_change(ConfChange(
            id=2, type=ConfChangeType.ConfChangeAddNode, node_id=victim))
        s.out.discard(victim)
    node_until(sets, lambda s: s.quiet() and all(
        victim in s.nodes[i]._current_conf_state().voters for i in MEMBERS),
        "the re-add and catch-up")

    cut = next(i for i in MEMBERS if i not in (lead, victim))
    for s in sets:
        s.out.add(cut)
        s.cut.add(cut)
    node_load(sets, rng, load[3])
    node_until(sets, NodeSet.quiet, "quiet with a member cut off")
    snaps = []
    for s in sets:
        n = s.nodes[lead]
        idx = n.status().basic.applied
        snap = n.create_snapshot(idx, None, b"".join(s.applied[lead]))
        n.compact(idx, snap)
        snaps.append((idx, node_plain(snap.metadata)))
    if any(x != snaps[0] for x in snaps[1:]):
        raise AssertionError(f"snapshots differ: {snaps}")
    node_load(sets, rng, 4)
    for s in sets:
        s.cut.clear()
        s.out.clear()
    node_until(sets, lambda s: any(i == cut for i, _ in s.snaps),
               "the MsgSnap catch-up")
    node_until(sets, NodeSet.quiet, "quiet after the catch-up")
    node_load(sets, rng, load[4])
    node_until(sets, NodeSet.quiet, "quiet after the last load")
    return {"transfer_to": target, "removed_and_readded": victim,
            "cut_off_and_caught_up": cut, "snapshot_index": snaps[0][0],
            "snapshots_installed": ns.snaps, "read_state": ns.reads[0][:2]}


def check_node_set(ns: NodeSet) -> int:
    """Every put committed once on every member, in the leader's log
    order, with its bytes, each member's puts in the order it was handed
    them; commits equal. Returns the puts."""
    puts = [d for seq in ns.order.values() for d in seq]
    ref = ns.applied[ns.leader()]
    if len(ref) != len(puts) or set(ref) != set(puts) or ns.pending:
        raise AssertionError(f"node: {len(ref)} applied of {len(puts)} puts")
    for i, seq in ns.applied.items():
        if seq != ref:
            raise AssertionError(f"node: member {i} applied other puts")
    pos = {d: k for k, d in enumerate(ref)}
    for i, seq in ns.order.items():
        if [pos[d] for d in seq] != sorted(pos[d] for d in seq):
            raise AssertionError(f"node: member {i}'s puts out of order")
    if len({ns.commit(i) for i in MEMBERS}) != 1 or ns.dropped:
        raise AssertionError(f"node: commits or drops {ns.dropped}")
    return len(puts)


def run_node(dev) -> dict:
    """Three BatchedNodes on the card at raftexample's default width,
    the node schedule at NODE_LOAD (4,032 puts). Returns the launches
    and form launches of its run and its node rounds."""
    from etcd_tpu_torch.batched import hopper_kernels as hk

    ns = NodeSet(dev)
    hk.reset_launches()
    t0 = time.perf_counter()
    steps = node_schedule([ns], NODE_LOAD, profile=dev.type == "cuda")
    wall_s = time.perf_counter() - t0
    launches, forms = dict(hk.LAUNCHES), dict(hk.FORM_LAUNCHES)
    puts = check_node_set(ns)
    if puts < NODE_PUTS:
        raise AssertionError(f"node: {puts} puts")
    captures = {i: n.rn.captures for i, n in ns.nodes.items()}
    if dev.type == "cuda" and set(captures.values()) != {1}:
        raise AssertionError(f"node: captures per node {captures}")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"{name} was never launched on the node "
                                 "path")
    lat_r, lat_ms = np.asarray(ns.lat_rounds), np.asarray(ns.lat_ms)
    log("node", members=len(MEMBERS),
        config=f"R=3, W={NODE_WINDOW}, election 10, heartbeat 1, E=8, P=8, "
        "pre-vote, check-quorum", setup_s=ns.setup_s, **steps,
        puts=puts, pump_rounds=ns.rounds, node_rounds=ns.node_rounds,
        wall_s=wall_s, entries_per_s=puts / wall_s,
        commit_latency_rounds={"p50": float(np.percentile(lat_r, 50)),
                               "p99": float(np.percentile(lat_r, 99))},
        commit_latency_ms={"p50": float(np.percentile(lat_ms, 50)),
                           "p99": float(np.percentile(lat_ms, 99))},
        ready_ms={"p50": statistics.median(ns.ready_ms),
                  "p99": float(np.percentile(ns.ready_ms, 99))},
        turn_ms={"p50": statistics.median(ns.turn_ms),
                 "p99": float(np.percentile(ns.turn_ms, 99))},
        device_per_node_round=ns.device,
        launches=launches,
        launches_per_node_round={k: v / ns.node_rounds
                                 for k, v in launches.items()},
        form_launches_per_node_round={k: v / ns.node_rounds
                                      for k, v in forms.items()},
        captures=captures,
        capture_s={i: [c["seconds"] for c in n.rn.capture_stats]
                   for i, n in ns.nodes.items()},
        card=smi("name,power.limit") if dev.type == "cuda" else str(dev))
    return {"launches": launches, "forms": forms, "rounds": ns.node_rounds}


def run_node_parity(dev, plain_dev=torch.device("cpu")) -> None:
    """The node schedule, shorter (PARITY_LOAD), on nodes on `dev` and on
    nodes on the CPU in lockstep: Ready for Ready and status for status
    equal, every round."""
    sets = [NodeSet(dev), NodeSet(plain_dev)]
    t0 = time.perf_counter()
    steps = node_schedule(sets, PARITY_LOAD)
    puts = [check_node_set(ns) for ns in sets]
    captures = {i: n.rn.captures for i, n in sets[0].nodes.items()}
    if dev.type == "cuda" and set(captures.values()) != {1}:
        raise AssertionError(f"node_parity: captures per node {captures}")
    log("node_parity", equal=True, puts=puts[0], pump_rounds=sets[0].rounds,
        node_rounds=sets[0].node_rounds, wall_s=time.perf_counter() - t0,
        captures=captures, **steps)


# -- phase: interaction (the committed scripts through the batched env) ---------

INTERACTION_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "etcd_tpu_torch", "rafttest", "testdata")
# What state_divergences reads: the rawnode's host mirrors.
INTERACTION_MIRRORS = ("m_term", "m_vote", "m_commit", "m_role", "m_lead",
                       "m_last", "m_snap", "m_ring")


class PlainInputs:
    """While active, the kernel wrappers record every distinct input they
    are given on the CPU (where they run their plain versions), keyed by
    the form that input launches on CUDA (hopper_kernels.FORM_LAUNCHES'
    keys); check() holds each form's kernel on the card against its
    plain version on every recorded input."""

    FORMS = {
        "quorum_commit": lambda a: (
            f"quorum_commit_vote commit R={a[1].shape[1]} B=1"),
        "quorum_vote": lambda a: (
            f"quorum_commit_vote vote R={a[1].shape[1]} "
            f"B={a[4] if len(a) > 4 else 1}"),
        "quorum_commit_vote": lambda a: (
            f"quorum_commit_vote both R={a[1].shape[1]} B=1"),
        "term_at_batch": lambda a: (
            f"term_at_batch K={a[4].shape[1] if a[4].dim() == 2 else 1} "
            f"W={a[0].shape[1]}"),
    }

    def __init__(self):
        self.seen = {}  # form -> {input key: (wrapper, cloned arguments)}
        self.calls = collections.Counter()

    def __enter__(self):
        from etcd_tpu_torch.batched import hopper_kernels as hk

        self._hk = hk
        self._wrappers = {name: getattr(hk, name) for name in self.FORMS}
        for name, fn in self._wrappers.items():
            setattr(hk, name, self._spy(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self._wrappers.items():
            setattr(self._hk, name, fn)

    def _spy(self, name, fn):
        def call(*args):
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            if not any(a.is_cuda for a in tensors):
                form = self.FORMS[name](args)
                key = tuple((str(a.dtype), tuple(a.shape), a.numpy().tobytes())
                            if isinstance(a, torch.Tensor) else a
                            for a in args)
                self.seen.setdefault(form, {}).setdefault(key, (name, [
                    a.clone() if isinstance(a, torch.Tensor) else a
                    for a in args]))
                self.calls[form] += 1
            return fn(*args)
        return call

    def check(self, dev) -> dict:
        """Each recorded input on `dev` through its wrapper (the kernel)
        against the plain version on the CPU, exactly. Returns per form
        the inputs held, the calls recorded and the largest |error|. The
        launches made here are not counted."""
        hk = self._hk
        plain = {"quorum_commit": hk.quorum_commit_ref,
                 "quorum_vote": hk.quorum_vote_ref,
                 "quorum_commit_vote": hk.quorum_commit_vote_ref,
                 "term_at_batch": hk.term_at_batch_ref}
        out = {}
        with hk.recorded_launches():
            for form, cases in sorted(self.seen.items()):
                err = 0
                for j, (name, args) in enumerate(cases.values()):
                    got = getattr(hk, name)(*[
                        a.to(dev) if isinstance(a, torch.Tensor) else a
                        for a in args])
                    got = (tuple(g.cpu() for g in got)
                           if isinstance(got, tuple) else got.cpu())
                    err = max(err, assert_equal(
                        f"interaction {form} input {j}", got,
                        plain[name](*args)))
                out[form] = {"inputs": len(cases), "calls": self.calls[form],
                             "max_abs_err": err}
        return out


def interaction_differences(a, b) -> list:
    """Where two of the port's BatchedInteractionEnvs differ: each node's
    host mirrors (arrays and dtypes) and applied history, and the
    in-flight messages, field for field."""
    if len(a.nodes) != len(b.nodes):
        return [f"nodes: {len(a.nodes)} vs {len(b.nodes)}"]
    out = []
    for i, (x, y) in enumerate(zip(a.nodes, b.nodes)):
        for name in INTERACTION_MIRRORS:
            u, v = getattr(x.node.rn, name), getattr(y.node.rn, name)
            if u.dtype != v.dtype or not np.array_equal(u, v):
                out.append(f"node {i + 1} {name}")
        if node_plain(x.history) != node_plain(y.history):
            out.append(f"node {i + 1} applied history")
    if node_plain(a.messages) != node_plain(b.messages):
        out.append("in-flight messages")
    return out


def run_interaction(dev, plain_dev=torch.device("cpu")) -> dict:
    """Every committed interaction script (etcd_tpu_torch/rafttest/
    testdata: capacities R = 1..7, W = 64) through the port's
    BatchedInteractionEnv on `dev` and, side by side, on `plain_dev`,
    with the port's scalar InteractionEnv as the oracle. After every
    directive: the scalar env's text equals the script's expected block;
    state_divergences(scalar, `dev` env) is empty (log bounds, applied
    history and conf state at full stabilizes, as the CPU tests run it);
    the `dev` env's mirrors, applied history and in-flight messages equal
    the `plain_dev` env's. Launches are counted from 0 around the run
    (on `plain_dev` the wrappers run their plain versions and count
    none); then every form the nodes launched is held against its plain
    version on each distinct input the `plain_dev` env's rounds gave it.
    Returns the path's launches, form launches and node rounds."""
    import glob

    from etcd_tpu_torch.batched import hopper_kernels as hk
    from etcd_tpu_torch.rafttest import InteractionEnv, parse_file
    from etcd_tpu_torch.rafttest.batched_env import (
        BatchedInteractionEnv, state_divergences)

    scripts = sorted(glob.glob(os.path.join(INTERACTION_DATA, "*.txt")))
    if len(scripts) < 11:
        raise AssertionError(f"interaction: {len(scripts)} scripts")
    capacities, directives, rounds, captures, capture_s = {}, 0, 0, 0, []
    hk.reset_launches()
    t0 = time.perf_counter()
    with PlainInputs() as inputs:
        for path in scripts:
            name = os.path.basename(path)
            datas = parse_file(path)
            r = sum(int(d.cmd_args[0].key) for d in datas
                    if d.cmd == "add-nodes")
            capacities[name] = r
            oracle = InteractionEnv()
            envs = [BatchedInteractionEnv(r, device=dev),
                    BatchedInteractionEnv(r, device=plain_dev)]
            try:
                for d in datas:
                    text = oracle.handle(d)
                    if text.rstrip("\n") != d.expected.rstrip("\n"):
                        raise AssertionError(f"interaction {d.pos}: the "
                                             "scalar env's text differs")
                    for env in envs:
                        env.handle(d)
                    quiet = d.cmd == "stabilize" and not any(
                        not a.vals for a in d.cmd_args)
                    div = state_divergences(oracle, envs[0],
                                            check_conf=quiet)
                    if div:
                        raise AssertionError(f"interaction {d.pos}: {d.cmd} "
                                             f"diverges: {div}")
                    diff = interaction_differences(*envs)
                    if diff:
                        raise AssertionError(f"interaction {d.pos}: {dev} "
                                             f"!= {plain_dev}: {diff}")
                    directives += 1
                nodes = [bn.node for bn in envs[0].nodes]
                rounds += sum(n.rounds for n in nodes)
                captures += sum(n.rn.captures for n in nodes)
                capture_s += [c["seconds"] for n in nodes
                              for c in n.rn.capture_stats]
                if dev.type == "cuda" and any(
                        n.rn.captures != (n.rounds > 0) for n in nodes):
                    raise AssertionError(f"interaction {name}: captures "
                                         f"{[n.rn.captures for n in nodes]}")
            finally:
                for env in envs:
                    env.close()
            gc.collect()
    wall_s = time.perf_counter() - t0
    launches, forms = dict(hk.LAUNCHES), dict(hk.FORM_LAUNCHES)
    for kernel, count in launches.items():
        if count == 0:
            raise AssertionError(f"{kernel} was never launched on the "
                                 "interaction path")
    held = inputs.check(dev)
    if set(forms) - set(held):
        raise AssertionError(f"interaction: forms launched with no input "
                             f"held: {sorted(set(forms) - set(held))}")
    log("interaction", scripts=len(scripts), capacities=capacities,
        config="election 3, heartbeat 1, W=64, E=8, P=4, no pre-vote, no "
        "check-quorum", directives=directives, node_rounds=rounds,
        captures=captures, capture_s={"sum": sum(capture_s),
                                      "max": max(capture_s, default=0.0)},
        wall_s=wall_s, launches=launches,
        launches_per_node_round={k: v / rounds for k, v in launches.items()},
        form_launches_per_node_round={k: v / rounds
                                      for k, v in sorted(forms.items())},
        forms_held=held,
        card=smi("name,power.limit") if dev.type == "cuda" else str(dev))
    return {"launches": launches, "forms": forms, "rounds": rounds}


# -- phase: raftexample (three members, each in its own threads) ---------------

EXAMPLE_PUTS = 8_500
EXAMPLE_WINDOW = 64  # the client's puts in flight (not yet visible everywhere)


class DeviceLockTimer:
    """From construction to restore(), every rawnode acquire of the
    process-wide device lock (graph.device_work) goes through this
    object, which records in `waits` the seconds each acquire waited."""

    def __init__(self):
        from etcd_tpu_torch.batched import rawnode
        from etcd_tpu_torch.batched.graph import device_work

        self._rawnode, self._device_work = rawnode, device_work
        self._lock = device_work()
        self.waits = []
        rawnode.device_work = lambda: self

    def __enter__(self):
        t = time.perf_counter()
        self._lock.acquire()
        self.waits.append(time.perf_counter() - t)

    def __exit__(self, *exc):
        self._lock.release()

    def restore(self) -> None:
        self._rawnode.device_work = self._device_work


def run_raftexample(dev, puts: int = EXAMPLE_PUTS,
                    timeout_s: float = 400.0) -> dict:
    """Three raftexample members on `dev`, each with its Ready loop,
    ticker and network pump in threads of its own and its WAL and
    snapshots in a temp directory, at the default snap_count (clamped to
    W/4 = 8,192, so 8,500 puts take one snapshot and one compaction).
    A client thread puts through ReplicatedKV.propose on the leader with
    at most EXAMPLE_WINDOW puts in flight and looks keys up on every
    member; a follower is stopped a third of the way in and restarted
    from its WAL and snapshot at half way, and must catch up. Returns
    the launches of the run."""
    import shutil
    import tempfile
    import threading

    from etcd_tpu_torch.batched import hopper_kernels as hk
    from etcd_tpu_torch.raftexample import (
        ExampleRaftNode, InProcNetwork, ReplicatedKV)

    seen = {}  # (member, key) -> first time it was visible there

    class TimedKV(ReplicatedKV):
        """The app, noting when each key first became visible on its
        member: applied from the log, or restored from a snapshot."""

        def __init__(self, mid):
            super().__init__()
            self.mid = mid

        def _seen(self, keys):
            now = time.perf_counter()
            for key in keys:
                seen.setdefault((self.mid, key), now)

        def apply(self, ents):
            super().apply(ents)
            self._seen(json.loads(e.data)["key"] for e in ents)

        def restore(self, data):
            super().restore(data)
            self._seen(list(self._store))

    tmp = tempfile.mkdtemp(prefix="chip-smoke-raftexample-")
    net = InProcNetwork(seed=SEED)
    members, kvs, rawnodes = {}, {}, []

    def start(mid):
        kv = TimedKV(mid)
        m = ExampleRaftNode(mid, list(MEMBERS), net, tmp, kv.apply,
                            kv.snapshot, kv.restore, device=dev)
        kv.attach(m)
        members[mid], kvs[mid] = m, kv
        rawnodes.append((mid, m.node.rn))

    def leader():
        for mid, m in members.items():
            if not m._stopped.is_set() and m.is_leader():
                return mid
        return 0

    def wait(pred, what, limit=60.0):
        deadline = time.perf_counter() + limit
        while not pred():
            if time.perf_counter() > deadline:
                raise AssertionError(f"raftexample: {what} timed out")
            time.sleep(0.002)

    # The device lock's acquire waits: the members' rounds serialize on
    # it (graph.device_work), as they would on the shared stream.
    lock_timer = DeviceLockTimer()
    waits = lock_timer.waits
    hk.reset_launches()
    t0 = time.perf_counter()
    try:
        for mid in MEMBERS:
            start(mid)
        wait(lambda: leader() != 0, "the election")
        lead = leader()
        victim = lead % 3 + 1
        live = set(MEMBERS)
        born, outage = {}, set()
        lookups = [0]
        err = []

        def client():
            try:
                inflight = deque()
                for k in range(puts):
                    if k == puts // 3:
                        members[victim].stop()
                        live.discard(victim)
                    if k == puts // 2:
                        start(victim)
                        live.add(victim)
                    key = f"k{k:06d}"
                    while len(inflight) >= EXAMPLE_WINDOW:
                        old = inflight[0]
                        if all((m, old) in seen for m in live):
                            inflight.popleft()
                        else:
                            time.sleep(0.0002)
                    if puts // 3 <= k < puts // 2 + EXAMPLE_WINDOW:
                        outage.add(key)  # put while a member was down
                    born[key] = time.perf_counter()
                    kvs[lead].propose(key, f"v{k}")
                    inflight.append(key)
                    if k % 97 == 0:
                        for kv in list(kvs.values()):
                            kv.lookup(key)
                            lookups[0] += 1
            except Exception as e:  # noqa: BLE001 — raised in the main thread
                err.append(e)

        th = threading.Thread(target=client, daemon=True)
        t_load = time.perf_counter()
        th.start()
        th.join(timeout_s)
        if th.is_alive() or err:
            raise AssertionError(f"raftexample client: {err or 'timed out'}")
        last = f"k{puts - 1:06d}"
        wait(lambda: all(kv.lookup(last) == f"v{puts - 1}"
                         for kv in kvs.values()), "the catch-up")
        load_s = time.perf_counter() - t_load
        wait(lambda: len({len(kv) for kv in kvs.values()}) == 1,
             "equal maps")
        maps = [dict(kv._store) for kv in kvs.values()]
        if any(m != maps[0] for m in maps[1:]) or len(maps[0]) != puts:
            raise AssertionError("raftexample: the members' maps differ")
        captures = [(mid, rn.captures) for mid, rn in rawnodes]
        if dev.type == "cuda" and {c for _, c in captures} != {1}:
            raise AssertionError(f"raftexample: captures {captures}")
        snaps = {mid: m.snapshot_index for mid, m in members.items()}
        if puts > members[lead].snap_count and not all(
                snaps[mid] > 0 for mid in MEMBERS if mid != victim):
            raise AssertionError(f"raftexample: snapshot indexes {snaps}")
        lat = [(max(seen[(m, key)] for m in MEMBERS) - t) * 1e3
               for key, t in born.items() if key not in outage]
        launches, forms = dict(hk.LAUNCHES), dict(hk.FORM_LAUNCHES)
        log("raftexample", members=len(MEMBERS), puts=puts,
            window=EXAMPLE_WINDOW, snap_count=members[lead].snap_count,
            stopped_and_restarted=victim, leader=lead,
            puts_per_s=puts / load_s, load_s=load_s,
            wall_s=time.perf_counter() - t0,
            visible_everywhere_ms={"p50": float(np.percentile(lat, 50)),
                                   "p99": float(np.percentile(lat, 99)),
                                   "samples": len(lat)},
            lookups=lookups[0], snapshot_index=snaps, captures=captures,
            device_lock_waits=len(waits),
            device_lock_wait_ms={**pcts(waits), "sum_s": sum(waits)},
            capture_s=[c["seconds"] for _, rn in rawnodes
                       for c in rn.capture_stats],
            launches=launches, form_launches=forms,
            card=smi("name,power.limit") if dev.type == "cuda" else str(dev))
        return launches
    finally:
        lock_timer.restore()
        for m in members.values():
            m.stop()
        net.stop()
        shutil.rmtree(tmp, ignore_errors=True)


# -- phase: hosting (MultiRaftMember: the multi-raft server) ------------------

HOSTING_PUTS = 3000
HOSTING_VALUE = 64      # bytes
HOSTING_INFLIGHT = 4    # puts in flight per group
HOSTING_READS = 96      # linearizable_get samples
HOSTING_PARITY_GROUPS = 128


def hosting_config(groups: int, **kw):
    """MultiRaftMember's default config (hosting.py: W=64, E=8, P=4,
    pre-vote, check-quorum, auto-compaction) at `groups`, with `kw`
    (telemetry, fleet_summary) on top."""
    from etcd_tpu_torch.batched.state import BatchedConfig

    return BatchedConfig(
        num_groups=groups, num_replicas=R, window=64, max_ents_per_msg=8,
        max_props_per_round=4, election_timeout=10, heartbeat_timeout=1,
        pre_vote=True, check_quorum=True, auto_compact=True, **kw)


def chaos_config(groups: int = 8):
    """tests/batched/test_chaos.py's CFG at `groups`: the prevote_cq
    parity config with the fleet summary on."""
    return parity_configs(groups)["prevote_cq"]._replace(fleet_summary=True)


def pcts(xs, scale: float = 1e3) -> dict:
    """p50 and p99 of `xs` (seconds), in ms."""
    if not len(xs):
        return {"p50": None, "p99": None, "n": 0}
    a = np.asarray(xs, np.float64) * scale
    return {"p50": float(np.percentile(a, 50)),
            "p99": float(np.percentile(a, 99)), "n": int(len(a))}


ROUND_PHASES = ("stage", "step", "extract", "collect")


def instrument_member(m, walls: list, fsyncs: list,
                      phases: dict = None) -> None:
    """Record the wall seconds of each of member m's rounds (with the
    rawnode's phase_last split into `phases`) and of each of its WAL
    fsyncs (the calls its loops make through the instance)."""
    run, flush = m.run_round, m.wal.flush

    def timed_round():
        t = time.perf_counter()
        try:
            return run()
        finally:
            walls.append(time.perf_counter() - t)
            if phases is not None:
                for p in ROUND_PHASES:
                    phases[p].append(m.rn.phase_last[p])

    def timed_flush(sync=True):
        t = time.perf_counter()
        try:
            return flush(sync=sync)
        finally:
            if sync:
                fsyncs.append(time.perf_counter() - t)

    m.run_round, m.wal.flush = timed_round, timed_flush


def leader_of(members, g: int):
    return next((m for m in members if m.is_leader(g)), None)


def group_leads(members, groups: int) -> list:
    """Each group's leader's id (None where it has none)."""
    members = list(members)
    return [getattr(leader_of(members, g), "id", None)
            for g in range(groups)]


def leads_moved(a: list, b: list) -> int:
    """Groups whose leader differs between two group_leads."""
    return sum(x != y for x, y in zip(a, b, strict=True))


def balance_leaders(members, groups: int, timeout: float) -> int:
    """hosted_bench's layout, group g led by member g % 3 + 1, by
    transfers from the current leader; returns the groups still
    misplaced when `timeout` runs out (0 when balanced)."""
    deadline = time.monotonic() + timeout
    while True:
        bad = []
        for g in range(groups):
            lead = leader_of(members, g)
            if lead is None or lead.id != g % R + 1:
                bad.append((g, lead))
        if not bad or time.monotonic() > deadline:
            return len(bad)
        for g, lead in bad:
            if lead is not None:
                lead.transfer_leader(g, g % R + 1)
        time.sleep(0.3)


def hosting_puts(members, groups: int, n: int, first: int, value: bytes,
                 inflight: int, timeout: float) -> dict:
    """hosted_bench's put driver (hosting_proc's bench op), in process:
    put `n` keys round-robin over the groups with at most `inflight` in
    flight per group, each proposed on its group's leader and acked once
    that leader applied it (read-your-write); the applied watermarks
    say which groups to check, a sweep every second re-proposes a put
    unacked for 2 s, and the loop sleeps 5 ms between passes. Returns
    the acked map, latencies and counts."""
    from etcd_tpu_torch.batched.hosting import GroupKV

    by_id = {m.id: m for m in members}
    pend = {g: deque() for g in range(groups)}
    acked, lat = {}, []
    i = outstanding = retries = 0
    t0 = last_sweep = time.perf_counter()
    deadline = t0 + timeout
    seen = {m.id: m.applied_index.copy() for m in members}
    while i < n or outstanding:
        now = time.perf_counter()
        if now > deadline:
            g = (first + i) % groups
            raise AssertionError(
                f"hosting: {outstanding} puts unacked and {n - i} not "
                f"proposed after {timeout} s (group {g}: leaders "
                f"{[(m.id, m.leader_of(g), m.is_leader(g)) for m in members]})")
        while i < n and outstanding < inflight * groups:
            g = (first + i) % groups
            if len(pend[g]) >= inflight:
                break
            k = b"put-%06d" % (first + i)
            lead = leader_of(members, g)
            if lead is None or not lead.propose(
                    g, GroupKV.put_payload(k, value)):
                break  # no leader here yet: retry on the next pass
            pend[g].append([k, now, now, lead.id])
            outstanding += 1
            i += 1
        for mid, m in by_id.items():
            arr = m.applied_index.copy()
            moved = np.nonzero(arr != seen[mid])[0]
            seen[mid] = arr
            for g in moved.tolist():
                q = pend[g]
                while q and q[0][3] == mid and m.get(g, q[0][0]) == value:
                    k, t_put, _t, _mid = q.popleft()
                    acked[(g, k)] = value
                    lat.append(now - t_put)
                    outstanding -= 1
        if now - last_sweep > 1.0:
            last_sweep = now
            for g, q in pend.items():
                for rec in q:
                    if now - rec[2] > 2.0:
                        lead = leader_of(members, g)
                        if lead is not None and lead.propose(
                                g, GroupKV.put_payload(rec[0], value)):
                            rec[2], rec[3] = now, lead.id
                            retries += 1
        time.sleep(0.005)
    return {"acked": acked, "lat": lat, "seconds": time.perf_counter() - t0,
            "retries": retries}


# Reads sent again, in all, after the member they went to lost its
# group's lead before their ReadIndex was confirmed.
READ_RETRIES = 2


def linearizable_reads(members, acked: dict, n: int) -> "tuple[list, list]":
    """linearizable_get of `n` sampled acked keys, each on its group's
    leader, each equal to the acked value; returns their seconds and each
    retry as (group, the member that lost the lead, the new leader). A
    read whose ReadIndex is not confirmed in 10 s is sent again only if
    its member no longer leads the group, at most READ_RETRIES times in
    all; else it raises. (A function of its own: no member outlives it in
    a local.)"""
    rng = np.random.RandomState(SEED)
    keys = list(acked)
    lat, moves = [], []
    for j in rng.choice(len(keys), n, replace=False):
        g, k = keys[j]
        t = time.perf_counter()
        while True:
            lead = leader_of(members, g)
            while lead is None and time.perf_counter() - t < 30.0:
                time.sleep(0.01)
                lead = leader_of(members, g)
            if lead is None:
                raise AssertionError(f"hosting: group {g} has no leader")
            try:
                got = lead.linearizable_get(g, k, timeout=10.0)
                break
            except TimeoutError:
                if lead.is_leader(g) or len(moves) >= READ_RETRIES:
                    raise
                now = leader_of(members, g)
                moves.append((g, lead.id, now.id if now else None))
        lat.append(time.perf_counter() - t)
        if got != acked[(g, k)]:
            raise AssertionError(f"hosting: linearizable_get g{g} {k!r}")
    return lat, moves


def run_hosting(dev, groups: int | None = None, puts: int = HOSTING_PUTS,
                tick_interval: float = 0.02,
                reads: int = HOSTING_READS) -> dict:
    """The multi-raft server on `dev`: three MultiRaftMembers of `groups`
    groups in this process over InProcRouter, hosting's default config
    with telemetry and the fleet summary on, the pipelined Ready drain,
    each member's WAL on local disk. Reads of every member's admin
    surface (health, stats, conf_snapshot, peer_match, the leader view)
    run in a thread while the members capture their first rounds. Every
    group elects and leadership is balanced; `puts` 64-byte puts, 4 in
    flight per group, each read back on all three members; `reads`
    linearizable_get samples; member 3 is crashed and its rawnode freed,
    one put per group commits without it, and it is restarted on its WAL
    and caught up: the card memory the crash freed must cover what the
    restarted member takes from its boot to its first capture (its
    state and its graph's pool). The checkers close the run. `groups`
    defaults to hosted_bench's G (kernel_times.HOSTING_GROUPS). Returns
    the launches, their forms and the member rounds of the put load."""
    import gc
    import shutil
    import tempfile
    import weakref

    from etcd_tpu_torch.batched import hopper_kernels as hk
    from etcd_tpu_torch.batched import hosting
    from etcd_tpu_torch.batched.graph import device_work
    from etcd_tpu_torch.functional import (
        committed_never_lost, multiraft_hash_check)
    from etcd_tpu_torch.tools import kernel_times as kt

    groups = kt.HOSTING_GROUPS if groups is None else groups
    cuda = dev.type == "cuda"
    cfg = hosting_config(groups, telemetry=True, fleet_summary=True)
    value = b"v" * HOSTING_VALUE
    tmp = tempfile.mkdtemp(prefix="chip-smoke-hosting-")
    walls = {mid: [] for mid in MEMBERS}
    phases = {p: [] for p in ROUND_PHASES}
    fsyncs = []
    lock_timer = DeviceLockTimer()
    waits = lock_timer.waits
    router = hosting.InProcRouter()
    members, retired = {}, []

    def boot(mid):
        m = hosting.MultiRaftMember(mid, R, groups, tmp, cfg=cfg,
                                    tick_interval=tick_interval,
                                    pipeline=True, device=dev)
        instrument_member(m, walls[mid], fsyncs, phases)
        router.attach(m)
        members[mid] = m
        return m

    def rounds():
        return sum(m.stats["rounds"] for m in members.values())

    def allocated():
        # Under the device lock no member is inside its round's device
        # work, so the reading holds no other round's temporaries.
        if not cuda:
            return 0
        with device_work():
            return torch.cuda.memory_allocated(dev)

    def pool_bytes(pool):
        # Card memory reserved for a graph pool, once the allocator has
        # released the cached blocks of every pool no graph holds.
        with device_work():
            torch.cuda.empty_cache()
            return sum(seg["total_size"]
                       for seg in torch.cuda.memory_snapshot()
                       if tuple(seg["segment_pool_id"]) == pool)

    def wait(pred, what, limit):
        deadline = time.perf_counter() + limit
        while not pred():
            if time.perf_counter() > deadline:
                raise AssertionError(f"hosting: {what} timed out")
            time.sleep(0.01)

    admin_n, read_err, stop_reads = [0], [], threading.Event()

    def admin_reads():
        # The C8 readers: hosting's admin surface from another thread,
        # while the members capture their first rounds.
        try:
            while not stop_reads.is_set():
                for m in list(members.values()):
                    m.health()
                    m.conf_snapshot()
                    dict(m.stats)
                    m.rn.peer_match()
                    _term, role, _lead = m.rn.m_view
                    int(role.sum())
                    admin_n[0] += 1
        except Exception as e:  # noqa: BLE001 — raised below
            read_err.append(e)

    try:
        t0 = time.perf_counter()
        for mid in MEMBERS:
            boot(mid)
        reader = threading.Thread(target=admin_reads, daemon=True)
        reader.start()
        for mid in MEMBERS:
            members[mid].start()
        hosting.wait_group_leaders(
            lambda: list(members.values()), groups, timeout=180.0)
        elect_s = time.perf_counter() - t0
        stop_reads.set()
        reader.join(30)
        if read_err:
            raise AssertionError(f"hosting: admin reads raised {read_err}")
        if cuda and {m.rn.captures for m in members.values()} != {1}:
            raise AssertionError("hosting: captures "
                                 f"{[m.rn.captures for m in members.values()]}")
        misplaced = balance_leaders(list(members.values()), groups, 60.0)
        hosting.wait_group_leaders(
            lambda: list(members.values()), groups, timeout=60.0)

        # The put load, with every launch count set to 0 just before.
        for w in (*walls.values(), *phases.values()):
            w.clear()
        fsyncs.clear()
        waits.clear()
        hk.reset_launches()
        r0 = rounds()
        load = hosting_puts(list(members.values()), groups, puts, 0, value,
                            HOSTING_INFLIGHT, timeout=300.0)
        load_rounds = rounds() - r0
        launches, forms = dict(hk.LAUNCHES), dict(hk.FORM_LAUNCHES)
        for name, count in launches.items():
            if count == 0:
                raise AssertionError(f"hosting: {name} was never launched")
        round_walls = [x for w in walls.values() for x in w]
        phase_ms = {p: pcts(v) for p, v in phases.items()}
        fsync_s, wait_s = list(fsyncs), list(waits)
        acked = dict(load["acked"])
        if len(acked) != puts:
            raise AssertionError(f"hosting: {len(acked)} of {puts} acked")
        wait(lambda: all(m.get(g, k) == v for m in members.values()
                         for (g, k), v in acked.items()),
             "every acked put on every member", 120.0)

        # Device time per member round: a second wave of one put per
        # group under the profiler (every member's thread records); each
        # member's rounds wait on its start and its stop (prof_s).
        device = {"device_ms": "not measured"}
        prof_s = {}
        leads_profiled = group_leads(members.values(), groups)
        if cuda:
            from torch.profiler import ProfilerActivity, profile

            from etcd_tpu_torch.tools.kernel_times import (
                _device_us, kernel_events)

            # The profiler starts and stops under the device lock: its
            # CUPTI teardown deadlocks with a graph launch in another
            # thread (ROADMAP C9).
            prof = profile(activities=[ProfilerActivity.CUDA])
            t = time.perf_counter()
            with device_work():
                prof.start()
            prof_s["start"] = time.perf_counter() - t
            r1 = rounds()
            try:
                wave = hosting_puts(list(members.values()), groups, groups,
                                    puts, value, 1, timeout=120.0)
            finally:
                t = time.perf_counter()
                with device_work():
                    torch.cuda.synchronize(dev)
                    prof.stop()
                prof_s["stop"] = time.perf_counter() - t
            wave_rounds = rounds() - r1
            acked.update(wave["acked"])
            ev = kernel_events(prof)
            kern = [e for e in ev
                    if not e.key.startswith(("Memcpy", "Memset"))]
            if kern and wave_rounds:
                device = {
                    "device_ms": sum(_device_us(e) for e in kern) / 1e3
                    / wave_rounds,
                    "kernels": sum(e.count for e in kern) / wave_rounds,
                    "copy_ms": sum(_device_us(e) for e in ev
                                   if e not in kern) / 1e3 / wave_rounds,
                    "member_rounds": wave_rounds}

        leads_read = group_leads(members.values(), groups)
        lin, lin_retries = linearizable_reads(list(members.values()), acked,
                                              reads)
        leads_after = group_leads(members.values(), groups)
        lead_moves = {
            "over_profile": leads_moved(leads_profiled, leads_read),
            "during_reads": leads_moved(leads_read, leads_after)}

        # Crash member 3, free its rawnode, restart it on its WAL.
        old = members.pop(3)
        pool = tuple(old.rn._graphs._pool) if cuda else None
        pool_live = pool_bytes(pool) if cuda else 0
        alloc_live = allocated()
        old.crash()
        for t in (old._runner, old._ticker, old._drainer):
            if t is not None:
                t.join(30)
        retired.append(old.hub.trips())
        del router.members[3]
        gone = weakref.ref(old.rn)
        old = None
        gc.collect()
        # A survivor's send in flight still holds the crashed member (the
        # router's target snapshot, InProcRouter.send) until it returns.
        deadline = time.perf_counter() + 10.0
        while gone() is not None and time.perf_counter() < deadline:
            time.sleep(0.05)
            gc.collect()
        alloc_freed = alloc_live - allocated()
        if gone() is not None:
            held = [type(r).__name__ for r in gc.get_referrers(gone())]
            raise AssertionError("hosting: the crashed member's rawnode "
                                 f"is still referenced ({held})")
        pool_kept = pool_bytes(pool) if cuda else 0
        if cuda and (pool_live <= 0 or pool_kept):
            raise AssertionError(
                f"hosting: the crashed member's graph pool held {pool_live}"
                f" bytes on the card and keeps {pool_kept}")
        down = hosting_puts(list(members.values()), groups, groups,
                            puts + groups, value, 1, timeout=120.0)
        acked.update(down["acked"])
        t_restart = time.perf_counter()
        alloc_boot = allocated()
        m3 = boot(3)
        m3.start()
        wait(lambda: m3.rn.captures >= 1 or not cuda,
             "member 3's first capture", 60.0)
        alloc_taken = allocated() - alloc_boot
        # What one member holds on the card (state and graph pool) must
        # have gone with the crash; 64 KiB covers allocator rounding.
        if cuda and (alloc_taken <= 0
                     or alloc_freed < alloc_taken - (64 << 10)):
            raise AssertionError(
                "hosting: the crash freed "
                f"{alloc_freed} bytes on the card, a member takes "
                f"{alloc_taken} from boot to its first capture")
        want = np.maximum(members[1].applied_index, members[2].applied_index)
        wait(lambda: bool((m3.applied_index >= want).all()),
             "member 3's catch-up", 180.0)
        catchup_s = time.perf_counter() - t_restart
        mems = list(members.values())
        multiraft_hash_check(mems, timeout=60.0)
        committed_never_lost(mems, acked, timeout=60.0)
        trips = sum(retired) + sum(m.hub.trips() for m in mems)
        if trips:
            raise AssertionError(f"hosting: {trips} invariant trips")
        captures = {mid: m.rn.captures for mid, m in members.items()}
        if cuda and set(captures.values()) != {1}:
            raise AssertionError(f"hosting: captures {captures}")
        lat = load["lat"]
        result = dict(
            groups=groups, members=len(MEMBERS), puts=puts,
            value_bytes=HOSTING_VALUE, inflight_per_group=HOSTING_INFLIGHT,
            config="hosting default (W=64, E=8, P=4, pre-vote, "
                   "check-quorum) + telemetry + fleet, pipelined drain",
            tick_interval_s=tick_interval, election_s=elect_s,
            leaders_misplaced_after_balance=misplaced,
            puts_per_s=puts / load["seconds"], load_s=load["seconds"],
            put_ms=pcts(lat), put_retries=load["retries"],
            member_rounds=load_rounds,
            rounds_per_member=load_rounds / len(MEMBERS),
            round_wall_ms=pcts(round_walls), round_phase_ms=phase_ms,
            device_per_member_round=device,
            captures=captures,
            launches=launches,
            launches_per_member_round={k: v / max(load_rounds, 1)
                                       for k, v in launches.items()},
            form_launches_per_member_round={
                k: v / max(load_rounds, 1) for k, v in forms.items()},
            wal_fsync_ms=pcts(fsync_s), device_lock_wait_ms=pcts(wait_s),
            linearizable_get_ms=pcts(lin),
            linearizable_get_retries=lin_retries, profiler_s=prof_s,
            leaders_moved=lead_moves,
            admin_reads_during_capture=admin_n[0],
            restart_catchup_s=catchup_s,
            crashed_member_bytes_freed=alloc_freed,
            crashed_member_graph_pool_bytes=pool_live,
            restarted_member_bytes_to_capture=alloc_taken,
            invariant_trips=trips,
            card=smi("name,power.limit") if cuda else str(dev))
        log("hosting", **result)
        return {"launches": launches, "forms": forms,
                "rounds": max(load_rounds, 1)}
    finally:
        stop_reads.set()
        lock_timer.restore()
        for m in members.values():
            m.stop()
        shutil.rmtree(tmp, ignore_errors=True)


# -- phase: hosting_parity (members on CUDA vs members on the CPU) -----------


def run_hosting_parity(dev, plain_dev=torch.device("cpu"),
                       groups: int = HOSTING_PARITY_GROUPS,
                       steps: int = 160) -> dict:
    """Three MultiRaftMembers on `dev` against three on the CPU, at
    test_chaos.CFG's values and `groups` groups, synchronous and in
    lockstep (tools/hosting_lockstep: pipeline=False, never started,
    InProcRouter, one seeded schedule of ticks, puts, deletes, a
    transfer, an isolate and heal, a joint membership change and a
    crash and restart). After every step both sides hold equal WAL
    records, KV snapshots and applied indexes, mirrors (m_view, m_last,
    m_snap) and health()."""
    import shutil
    import tempfile

    from etcd_tpu_torch.batched import hosting
    from etcd_tpu_torch.tools.hosting_lockstep import (
        Lockstep, first_diff, run_schedule, step_clock)

    cfg = chaos_config(groups)
    tmp = tempfile.mkdtemp(prefix="chip-smoke-hosting-parity-")

    def check(s, event, obs):
        diff = first_diff(obs[0], obs[1])
        if diff is not None:
            raise AssertionError(
                f"hosting_parity step {s} ({event or 'round'}): {diff}")

    t0 = time.perf_counter()
    with step_clock(hosting) as clock:
        a = Lockstep(hosting, os.path.join(tmp, "dev"), cfg, R, groups,
                     device=dev)
        b = Lockstep(hosting, os.path.join(tmp, "cpu"), cfg, R, groups,
                     device=plain_dev)
        try:
            counts = run_schedule([a, b], clock, steps=steps, check=check,
                                  puts_per_step=8)
        finally:
            a.stop()
            b.stop()
            shutil.rmtree(tmp, ignore_errors=True)
    captures = {mid: m.rn.captures for mid, m in a.members.items()}
    if dev.type == "cuda" and set(captures.values()) != {1}:
        raise AssertionError(f"hosting_parity: captures {captures}")
    for ev in ("demote", "add-learner", "promote"):
        if counts[ev] != f"{{{groups - 1}: 'ok'}}":
            raise AssertionError(f"hosting_parity: {ev} {counts[ev]}")
    log("hosting_parity", groups=groups, equal=True,
        seconds=time.perf_counter() - t0, captures=captures,
        wal_records={mid: len(w) for mid, w in a.wal_log.items()},
        **counts)
    return counts


# -- phase: mesh (a member's rows split over devices, ROADMAP A12) ------------

MESH_GROUPS = 4096
MESH_STRIDE = 173  # the reference's differential puts to range(0, G, 173)


def mesh_config(groups: int):
    """tests/batched/test_multichip.py's sharded-vs-unsharded
    differential config, at `groups` groups."""
    from etcd_tpu_torch.batched.state import BatchedConfig

    return BatchedConfig(
        num_groups=groups, num_replicas=R, window=32, max_ents_per_msg=4,
        max_props_per_round=4, election_timeout=10, heartbeat_timeout=1,
        pre_vote=True, check_quorum=True, auto_compact=True)


def shard_forms_equal_plain(rn) -> dict:
    """Every kernel form of one eager round of each shard of `rn`, on the
    shard's own buffers, held against its plain version on the same
    (cloned) inputs: shard -> form -> largest |kernel - plain| (held at
    0). Under the device lock, so no member round runs meanwhile."""
    import contextlib

    from etcd_tpu_torch.batched import hopper_kernels as hk
    from etcd_tpu_torch.batched.graph import device_work

    plain = {hk.quorum_commit: hk.quorum_commit_ref,
             hk.quorum_vote: hk.quorum_vote_ref,
             hk.term_at_batch: hk.term_at_batch_ref}
    out = {}
    with device_work():
        for i, sh in enumerate(rn._shards):
            with (torch.cuda.device(sh.device) if sh.cuda
                  else contextlib.nullcontext()):
                forms = round_forms(
                    lambda sh=sh: sh.round(sh.state, sh.inbox, *sh.ctl))
                out[f"shard {i} rows {sh.lo}-{sh.hi}"] = {
                    form: assert_equal(f"mesh shard {i} {form}",
                                       fn(*args), plain[fn](*args))
                    for form, (fn, args) in sorted(forms.items())}
    return out


def run_mesh(dev, groups: int = MESH_GROUPS, mesh=None,
             timeout: float = 180.0) -> dict:
    """The reference's sharded-vs-unsharded differential
    (tests/batched/test_multichip.py, G = 4,096) on `dev`: three
    in-process members each split over `mesh` (default: `dev` twice, the
    split's counterpart on one card), then three unsplit members on
    `dev`, with the same puts (groups range(0, G, 173) and the last, all
    in flight at once), must end with the same applied KV at every
    member. Each kind's rounds
    after its elections run under ETCD_TPU_TRANSFER_GUARD=disallow and
    make no new capture; the split's launches are counted from 0 around
    its own run, and every kernel form of one round of each of member
    1's shards is then held against its plain version. Each kind's round
    wall and device ms (the rawnode's CUDA events, ETCD_TPU_PROF) are
    logged side by side. Returns the split's path."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    from etcd_tpu_torch.analysis.sentinels import CompileBudget
    from etcd_tpu_torch.batched import hopper_kernels as hk
    from etcd_tpu_torch.batched.hosting import MultiRaftCluster

    cuda = dev.type == "cuda"
    mesh = [dev, dev] if mesh is None else mesh
    cfg = mesh_config(groups)
    sample = list(range(0, groups, MESH_STRIDE)) + [groups - 1]
    kv, stats, path = {}, {}, {}
    old = {k: os.environ.get(k) for k in ("ETCD_TPU_PROF",
                                           "ETCD_TPU_TRANSFER_GUARD")}
    os.environ["ETCD_TPU_PROF"] = "1"
    tmp = tempfile.mkdtemp(prefix="chip-smoke-mesh-")
    try:
        for label, where in (("split", {"mesh": mesh}),
                             ("unsplit", {"device": dev})):
            os.environ.pop("ETCD_TPU_TRANSFER_GUARD", None)
            hk.reset_launches()
            t0 = time.perf_counter()
            c = MultiRaftCluster(os.path.join(tmp, label), num_members=R,
                                 num_groups=groups, cfg=cfg, **where)
            walls, fsyncs = [], []
            try:
                c.wait_leaders(timeout=timeout)
                elect_s = time.perf_counter() - t0
                os.environ["ETCD_TPU_TRANSFER_GUARD"] = "disallow"
                budget = CompileBudget(0)
                for mid, m in c.members.items():
                    budget.track(f"member {mid}", m.rn)
                    instrument_member(m, walls, fsyncs)
                t1 = time.perf_counter()
                # The reference's puts, all in flight at once (each
                # waits for its leader's apply).
                with ThreadPoolExecutor(len(sample)) as pool:
                    for f in [pool.submit(c.put, grp, b"dk", b"dv%d" % grp,
                                          timeout=timeout) for grp in sample]:
                        f.result()
                wait_for(lambda: all(
                    m.get(grp, b"dk") == b"dv%d" % grp
                    for m in c.members.values() for grp in sample),
                    f"mesh {label} puts on every member", timeout)
                puts_s = time.perf_counter() - t1
                budget.check()
                launches, forms = dict(hk.LAUNCHES), dict(hk.FORM_LAUNCHES)
                rounds = sum(m.stats["rounds"] for m in c.members.values())
                profs = [m.rn.prof for m in c.members.values()]
                prof_rounds = sum(p["rounds"] for p in profs)
                st = stats[label] = {
                    "shards": [len(m.rn.shards) for m in c.members.values()],
                    "captures": {mid: m.rn.captures
                                 for mid, m in c.members.items()},
                    "captures_after_warmup": budget.report(),
                    "elect_s": elect_s, "puts_s": puts_s,
                    "member_rounds": rounds,
                    "round_wall_ms": pcts(walls),
                    "step_ms_mean": 1e3 * sum(p["step"] for p in profs)
                    / max(1, prof_rounds),
                    "device_ms_mean": (1e3 * sum(p["device"] for p in profs)
                                       / max(1, prof_rounds)
                                       if cuda else "not measured"),
                    "launches": launches}
                if cuda and set(st["captures"].values()) != {
                        len(where.get("mesh", [dev]))}:
                    raise AssertionError(f"mesh {label}: captures "
                                         f"{st['captures']}")
                if label == "split":
                    path = {"launches": launches, "forms": forms,
                            "rounds": rounds}
                    if cuda:
                        for name, count in launches.items():
                            if count == 0:
                                raise AssertionError(
                                    f"mesh: {name} never launched")
                    os.environ.pop("ETCD_TPU_TRANSFER_GUARD", None)
                    path["shard_forms"] = shard_forms_equal_plain(
                        c.members[1].rn)
                kv[label] = {grp: {mid: dict(m.kvs[grp].data)
                                   for mid, m in c.members.items()}
                             for grp in sample}
            finally:
                os.environ.pop("ETCD_TPU_TRANSFER_GUARD", None)
                c.stop()
        if kv["split"] != kv["unsplit"]:
            bad = [g for g in sample if kv["split"][g] != kv["unsplit"][g]]
            raise AssertionError(f"mesh: split and unsplit KV differ in "
                                 f"groups {bad[:8]}")
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)
    log("mesh", groups=groups, mesh=[str(d) for d in mesh],
        config="tests/batched/test_multichip.py's differential: W = 32, "
        "E = 4, P = 4, election 10, heartbeat 1, pre-vote, check-quorum, "
        "auto-compaction", puts=len(sample), kv_equal=True,
        sync_guard="disallow: no sync reported", split=stats["split"],
        unsplit=stats["unsplit"],
        form_launches_per_round={k: v / max(1, path["rounds"])
                                 for k, v in path["forms"].items()},
        shard_forms=path["shard_forms"],
        card=smi("name,power.limit") if cuda else str(dev))
    return path


# -- phase: chaos (the seeded fault plane over CUDA members) -----------------


def chaos_lead_by_transfer(h, mid: int, groups: int) -> int:
    """A group member `mid` leads, handed to it by a transfer."""
    m = h.members[mid]
    deadline = time.monotonic() + 60.0
    while time.monotonic() < deadline:
        for g in range(groups):
            if m.is_leader(g):
                return g
        for g in range(groups):
            lead = leader_of(h.alive(), g)
            if lead is not None and lead.id != mid:
                lead.transfer_leader(g, mid)
                break
        time.sleep(0.2)
    raise AssertionError(f"chaos: member {mid} never led a group")


def chaos_cells(dev, shape=None) -> dict:
    """The chaos cells, each a fresh ChaosHarness of CUDA members at
    test_chaos.CFG closed by run_invariant_checks (strict: KV-hash
    parity, committed-never-lost, one leader per term) with
    invariant_trips() == 0: name -> episode(tmp_dir). `shape` names a
    deliver shape (default: the config's)."""
    from etcd_tpu_torch.batched.faults import (
        ChaosHarness, FaultSpec, LeaderObserver, run_invariant_checks)
    from etcd_tpu_torch.pkg import failpoint

    cfg = chaos_config()
    if shape is not None:
        cfg = cfg._replace(deliver_shape=shape)
    g = cfg.num_groups
    msg_faults = FaultSpec(drop=0.05, dup=0.05, delay=0.08,
                           delay_max_s=0.04, reorder=0.2)

    def episode(body, spec=None, transport="inproc", **kw):
        def run(tmp):
            h = ChaosHarness(tmp, 101, spec or FaultSpec(), num_members=R,
                             num_groups=g, cfg=cfg, transport=transport,
                             device=dev, **kw)
            obs = LeaderObserver(h.alive)
            try:
                h.wait_leaders()
                obs.start()
                out = body(h) or {}
                h.plan.quiesce()
                run_invariant_checks(h, obs, expect_members=R)
                if h.invariant_trips():
                    raise AssertionError("chaos: invariant trips")
                return {**out, "captures": sorted(
                    m.rn.captures for m in h.members.values())}
            finally:
                obs.stop()
                h.stop()
                failpoint.disable_all()
        return run

    def faulty(h):
        acked = h.run_workload(20)
        if acked < 10:
            raise AssertionError(f"chaos: only {acked}/20 writes acked")
        st = h.fabric.stats()
        if not st.get("dropped") or not st.get("delayed"):
            raise AssertionError(f"chaos: no faults injected {st}")
        return {"acked": acked, "fabric": st}

    def crash_replay(h):
        h.run_workload(6, prefix=b"pre")
        h.crash_on_failpoint(2, "after_save")
        acked = h.run_workload(6, prefix=b"mid")
        h.restart(2)
        h.wait_leaders()
        h.run_workload(3, prefix=b"post")
        return {"acked_mid": acked}

    def torn(h):
        h.run_workload(8, prefix=b"pre")
        h.crash(3)
        chop = h.torn_tail(3)
        if chop <= 0:
            raise AssertionError("chaos: no WAL tail to tear")
        h.run_workload(4, prefix=b"mid")
        h.restart(3)
        h.wait_leaders()
        h.touch_all_groups()
        return {"chopped_bytes": chop}

    def fsync_failstop(h):
        h.run_workload(6, prefix=b"pre")
        grp = chaos_lead_by_transfer(h, 2, g)
        m = h.members[2]
        h.disk.arm_fsync_error(2, sticky=True)
        m.propose(grp, b"P" + b"doomed\x00never")
        cause = h.wait_fail_stop(2, timeout=30.0)
        if not cause.startswith("fsync:") or m.get(grp, b"doomed"):
            raise AssertionError(f"chaos: fail-stop {cause!r}")
        h.failstop_envelope(2)
        h.run_workload(4, prefix=b"mid")
        h.disk.quiesce()
        h.restart(2)
        h.wait_leaders()
        h.touch_all_groups()
        return {"cause": cause}

    def walpipe_window(h):
        h.run_workload(6, prefix=b"pre")
        h.crash_on_failpoint(2, "before_fsync_release")
        h.torn_tail(2)
        acked = h.run_workload(6, prefix=b"mid")
        h.restart(2)
        h.wait_leaders()
        h.touch_all_groups()
        return {"acked_mid": acked}

    return {
        "msg_faults_inproc": episode(faulty, msg_faults),
        "msg_faults_tcp": episode(faulty, msg_faults, "tcp"),
        "msg_faults_shm": episode(faulty, msg_faults, "shm"),
        "failpoint_crash_replay": episode(crash_replay),
        "torn_wal_tail": episode(torn),
        "fsync_failstop": episode(fsync_failstop),
        "walpipe_crash_window": episode(walpipe_window, wal_pipeline=True),
    }


def run_chaos(dev, cells=None, shape=None, phase="chaos") -> dict:
    """Every chaos cell (or those named in `cells`) on `dev`, each in a
    temp directory of its own, with the deliver shape `shape` (default:
    the config's); the line is logged as `phase`."""
    import shutil
    import tempfile

    results = {}
    for name, run in chaos_cells(dev, shape).items():
        if cells is not None and name not in cells:
            continue
        tmp = tempfile.mkdtemp(prefix=f"chip-smoke-chaos-{name}-")
        t0 = time.perf_counter()
        try:
            out = run(tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        if dev.type == "cuda" and set(out["captures"]) != {1}:
            raise AssertionError(f"chaos {name}: captures {out['captures']}")
        results[name] = {**out, "seconds": time.perf_counter() - t0}
    log(phase, shape=shape or chaos_config().resolved().deliver_shape,
        strict=True, invariant_trips=0, cells=results,
        card=smi("name,power.limit") if dev.type == "cuda" else str(dev))
    return results



# -- phase: hosting_proc (the multi-raft server as worker processes) ---------

HOSTING_PROC_PUTS = 6000  # hosted_bench --n: past the 4 x 1,024 in flight


def worker_device(dev) -> "str | None":
    """The --device of a worker process on `dev`: none on the card (a
    worker's default), the device's name otherwise."""
    return None if dev.type == "cuda" else str(dev)


class AppMemory:
    """While open, a thread reads nvidia-smi's compute apps every half
    second and keeps the reading whose used_memory (MiB) summed largest,
    as its (pid, MiB) lines. nvidia-smi may name processes by another
    namespace's pids, so the lines are kept as it printed them."""

    def __init__(self, enabled: bool):
        self.enabled, self.peak = enabled, []
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.wait(0.5):
            out = subprocess.run(
                ["nvidia-smi", "--query-compute-apps=pid,used_memory",
                 "--format=csv,noheader,nounits"],
                capture_output=True, text=True, timeout=60).stdout
            apps = [[int(x) for x in line.split(",")]
                    for line in out.splitlines()
                    if line.replace(",", "").replace(" ", "").isdigit()]
            if sum(m for _, m in apps) > sum(m for _, m in self.peak):
                self.peak = apps

    def __enter__(self):
        if self.enabled:
            self._t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        if self.enabled:
            self._t.join(30)


def sum_launch_lines(lines: list) -> dict:
    """The launches, forms and member rounds of worker launch lines,
    summed."""
    from etcd_tpu_torch.batched import hopper_kernels as hk

    launches = {k: sum(ln["launches"].get(k, 0) for ln in lines)
                for k in hk.LAUNCHES}
    forms = {}
    for ln in lines:
        for k, v in ln["forms"].items():
            forms[k] = forms.get(k, 0) + v
    return {"launches": launches, "forms": forms,
            "rounds": sum(ln["rounds"] for ln in lines)}


def run_hosting_proc(dev, groups: int | None = None,
                     n: int = HOSTING_PROC_PUTS) -> dict:
    """The multi-raft server as three worker processes on `dev`, over TCP:
    the port's hosted_bench at its defaults (G = groups, R = 3, 64-byte
    values, 4 puts in flight a group; its workers get no --device on the
    card, so they take their default, the GPU) with `n` puts, which
    must all commit and be read back at their leaders (lost 0), then its
    kill -9 of member 3, a write, and the restart's catch-up. Each worker
    writes its rounds and kernel launches since hosted_bench's prof_reset
    when it stops; those lines are the path's launches. Then the e2e flow
    of the reference's three-process test on three more workers (--trace
    --fleet --telemetry; proc_cluster.kill9_restart_flow)."""
    import ast
    import shutil
    import tempfile

    from etcd_tpu_torch.tools import kernel_times as kt
    from etcd_tpu_torch.tools.proc_cluster import (
        REPO, ProcCluster, kill9_restart_flow, read_launch_lines)

    groups = kt.HOSTING_GROUPS if groups is None else groups
    cuda = dev.type == "cuda"
    device = worker_device(dev)
    tmp = tempfile.mkdtemp(prefix="chip-smoke-hosting-proc-")
    bench_dir, e2e_dir = (os.path.join(tmp, d) for d in ("bench", "e2e"))
    os.makedirs(bench_dir)
    os.makedirs(e2e_dir)
    out_path = os.path.join(tmp, "hosted_bench.json")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    try:
        t0 = time.perf_counter()
        with AppMemory(cuda) as mem:
            proc = subprocess.Popen(
                [sys.executable, "-m", "etcd_tpu_torch.tools.hosted_bench",
                 "--groups", str(groups), "--n", str(n),
                 "--data-dir", bench_dir, "--out", out_path]
                + (["--device", device] if device else []),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=env)
            try:
                _out, stderr = proc.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                proc.kill()
                _out, stderr = proc.communicate()
        bench_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"hosting_proc: hosted_bench rc "
                                 f"{proc.returncode}: {stderr[-3000:]}")
        with open(out_path) as f:
            res = json.load(f)
        if res["lost"] != 0 or res["completed"] != n or res["n"] != n:
            raise AssertionError(f"hosting_proc: hosted_bench {res}")
        prof = {}
        for line in stderr.splitlines():
            if line.startswith("member ") and " prof: " in line:
                mid, _, st = line[len("member "):].partition(" prof: ")
                prof[int(mid)] = ast.literal_eval(st)
        bench_lines = read_launch_lines(bench_dir)
        path = sum_launch_lines(bench_lines)
        for name, count in path["launches"].items():
            if cuda and count == 0:
                raise AssertionError(f"hosting_proc: {name} was never "
                                     "launched in a worker")
        dev_ms = [st["rn_device"] / st["rn_rounds"] * 1e3
                  for st in prof.values() if st.get("rn_rounds")]

        t1 = time.perf_counter()
        cluster = ProcCluster(
            e2e_dir, groups, device=device,
            flags=["--trace", "--fleet", "--telemetry"],
            env={mid: {"ETCD_TPU_TRACE_SAMPLE": "1"} for mid in MEMBERS})
        with AppMemory(cuda) as mem2:
            try:
                cluster.start()
                e2e = kill9_restart_flow(cluster)
            finally:
                cluster.stop()
        e2e_lines = sum_launch_lines(cluster.launch_lines())
        log("hosting_proc", groups=groups, members=len(MEMBERS),
            puts=n, config=res["config"], bench_s=bench_s,
            puts_per_s=res["puts_per_sec"], put_p50_ms=res["p50_ms"],
            put_p99_ms=res["p99_ms"], lost=res["lost"],
            completed=res["completed"],
            phase_ms_per_round=res["phase_ms_per_round"],
            restart_catchup_s=res["restart_catchup_s"],
            rounds_per_worker={mid: st.get("rounds")
                               for mid, st in sorted(prof.items())},
            round_wall_ms_mean={mid: st["round_s"] / st["rounds"] * 1e3
                                for mid, st in sorted(prof.items())
                                if st.get("rounds")},
            device_ms_per_member_round=dev_ms or "not measured",
            worker_prof=prof,
            launches=path["launches"], launch_rounds=path["rounds"],
            launches_per_member_round={
                k: v / max(path["rounds"], 1)
                for k, v in path["launches"].items()},
            form_launches_per_member_round={
                k: v / max(path["rounds"], 1)
                for k, v in path["forms"].items()},
            worker_max_reserved_mib={
                ln["log"]: ln["max_reserved_bytes"] / 2**20
                for ln in bench_lines},
            gpu_apps_mib_bench=mem.peak, e2e=e2e,
            e2e_s=time.perf_counter() - t1,
            e2e_launches=e2e_lines["launches"],
            e2e_rounds=e2e_lines["rounds"], gpu_apps_mib_e2e=mem2.peak,
            card=smi("name,power.limit") if cuda else str(dev))
        return {**path, "rounds": max(path["rounds"], 1)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- phase: rebalance (rebalancerd over workers; the limp eviction) ---------


def limp_episode(h, victim: int = 2) -> dict:
    """tests/batched/test_diskfaults.py's run_limp_episode on a started
    harness: slow fsyncs on `victim` until its fleet hub counts
    member_limping, then the port's Rebalancer over an InProcActuator
    drains every leadership off it; heal, write, close strict. Stops the
    harness."""
    from etcd_tpu_torch.batched.faults import (
        LeaderObserver, run_invariant_checks)
    from etcd_tpu_torch.batched.rebalance import (
        InProcActuator, RebalanceConfig, Rebalancer)

    g = h.cfg.num_groups
    obs = LeaderObserver(h.alive)
    try:
        h.wait_leaders()
        obs.start()
        m = h.members[victim]
        for mm in h.members.values():
            mm.fleet.limp_ms = 10.0
            mm.fleet.limp_ops = 4
        h.disk.set_limp(victim, 0.03)
        t0 = time.monotonic()
        deadline = t0 + 60.0
        wave = 0
        while time.monotonic() < deadline:
            h.run_workload(2, prefix=b"limp%d" % wave)
            wave += 1
            if m.fleet.anomalies().get("member_limping", 0) >= 1:
                break
        if not (m.fleet.anomalies().get("member_limping", 0) >= 1
                and m.fleet.limp_state()["limping"]):
            raise AssertionError("limp: the detector never fired")
        detect_s = time.monotonic() - t0
        # A drain needs something to drain: the victim leads at least
        # one group when the rebalancer starts (a transfer hands it one).
        chaos_lead_by_transfer(h, victim, g)
        led_before = sum(1 for x in range(g) if m.is_leader(x))
        reb = Rebalancer(
            InProcActuator(h.members),
            RebalanceConfig(skew_ratio=1.5, cooldown_s=0.5,
                            max_moves_per_pass=g, transfer_wait_s=5.0,
                            min_groups=g))
        deadline = time.monotonic() + 60.0
        evicted = []
        while time.monotonic() < deadline:
            rep = reb.run_once()
            evicted += [mv["group"] for mv in rep["moves"]
                        if mv["reason"] == "limp_evict" and mv["ok"]]
            led = sum(1 for x in range(g) if m.is_leader(x))
            if led == 0 and rep["converged"]:
                break
            time.sleep(0.5)
        if led != 0 or not rep["converged"] or not evicted:
            raise AssertionError(f"limp: the limping member leads {led} "
                                 f"after evicting {evicted}: {rep}")
        h.disk.heal_limp(victim)
        acked = h.run_workload(4, prefix=b"post")
        if acked < 3:
            raise AssertionError(f"limp: {acked}/4 writes after the heal")
        run_invariant_checks(h, obs, expect_members=R)
        if h.invariant_trips():
            raise AssertionError("limp: invariant trips")
        return {"waves_to_detect": wave, "detect_s": detect_s,
                "victim_led_before": led_before, "evicted": evicted,
                "drained": True, "captures": sorted(
                    mm.rn.captures for mm in h.members.values())}
    finally:
        obs.stop()
        h.stop()


def run_rebalance(dev, groups: int | None = None) -> dict:
    """Leadership rebalancing on `dev`: three worker processes (--fleet
    --telemetry) with every group campaigned by member 1, then the port's
    rebalancerd as a subprocess (--once --json) must converge and exit 0
    with a report that passes REPORT_KEYS, and fleet_console must count
    every group led, in balance (proc_cluster.rebalance_flow); then the
    limp-eviction episode in this process over members on `dev` at
    test_chaos.CFG, closed strict."""
    import shutil
    import tempfile

    from etcd_tpu_torch.batched.faults import ChaosHarness, FaultSpec
    from etcd_tpu_torch.tools import kernel_times as kt
    from etcd_tpu_torch.tools.proc_cluster import ProcCluster, rebalance_flow

    groups = kt.HOSTING_GROUPS if groups is None else groups
    cuda = dev.type == "cuda"
    tmp = tempfile.mkdtemp(prefix="chip-smoke-rebalance-")
    try:
        t0 = time.perf_counter()
        cluster = ProcCluster(os.path.join(tmp, "procs"), groups,
                              device=worker_device(dev),
                              flags=["--fleet", "--telemetry"])
        os.makedirs(cluster.data_dir)
        try:
            cluster.start()
            flow = rebalance_flow(cluster)
        finally:
            cluster.stop()
        flow_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        cfg = chaos_config()
        limp = limp_episode(ChaosHarness(
            os.path.join(tmp, "limp"), 404, FaultSpec(), num_members=R,
            num_groups=cfg.num_groups, cfg=cfg, transport="inproc",
            device=dev))
        if cuda and set(limp["captures"]) != {1}:
            raise AssertionError(f"limp: captures {limp['captures']}")
        log("rebalance", groups=groups, rebalancerd=flow,
            rebalancerd_phase_s=flow_s, limp=limp,
            limp_s=time.perf_counter() - t1, strict=True,
            card=smi("name,power.limit") if cuda else str(dev))
        return {"rebalancerd": flow, "limp": limp}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- phase: server (EtcdServer, the etcd v3 server, on the card) --------------

# etcd's documented benchmark (Documentation/op-guide/performance.md,
# "Benchmarks"): three members, 8-byte sequential keys, 256-byte values,
# puts through 100 connections, then ranges, linearizable and
# serializable. Cut: 1,000 clients to 100 (one request in flight each),
# 100,000 puts to 1,000 (the boot phase carries the benchmark's load),
# three processes to one. The members' ring keeps the default
# snapshot_count's width, W = 32,768, and after boot each member snapshots
# past SERVER_SNAP_COUNT entries above its ring floor and compacts to
# SERVER_SNAP_CATCHUP entries below its applied index (the ring's width
# follows the snapshot_count a server boots with; its trigger is read at
# every apply), so the phase compacts the full-width ring and restarts a
# follower from a snapshot and its WAL's tail.
SERVER_CLIENTS = 100
SERVER_PUTS = 1_000
SERVER_SNAP_COUNT = 800
SERVER_SNAP_CATCHUP = 600   # above SERVER_DOWN_PUTS: the restarted
                            # follower catches up from the leader's log
SERVER_KEY_BYTES = 8
SERVER_VALUE_BYTES = 256
SERVER_RANGES = 500         # range requests per consistency
SERVER_TXNS = 150           # each of these three at most `puts`
SERVER_DOWN_PUTS = 500      # puts while a follower is down
SERVER_PROFILE_PUTS = 12    # puts under the profiler (CUPTI slows rounds)
SERVER_TICK = 0.1           # etcd's default heartbeat interval, 100 ms
SERVER_SNAP_PUTS = 40       # the small cluster: snapshot_count 16
SERVER_PARITY_OPS = 40
LEASE_KEYS = 8


class ServerForms:
    """While installed, every launch of a kernel wrapper outside a CUDA
    graph capture (each member's first, eager node round, and on the CPU
    every round) is held against the plain version on a copy of the same
    inputs; `err` keeps each form's largest |kernel - plain|."""

    def __init__(self):
        from etcd_tpu_torch.batched import hopper_kernels as hk

        self.hk = hk
        self.wrappers = {name: getattr(hk, name) for name in (
            "quorum_commit", "quorum_vote", "term_at_batch")}
        plain = {"quorum_commit": hk.quorum_commit_ref,
                 "quorum_vote": hk.quorum_vote_ref,
                 "term_at_batch": hk.term_at_batch_ref}
        self.err = {}
        for name, fn in self.wrappers.items():
            setattr(hk, name, self._spy(fn, plain[name]))

    def _spy(self, fn, ref):
        def call(*args):
            if args[0].is_cuda and torch.cuda.is_current_stream_capturing():
                return fn(*args)
            before = collections.Counter(self.hk.FORM_LAUNCHES)
            copies = [a.clone() if isinstance(a, torch.Tensor) else a
                      for a in args]
            got = fn(*args)
            form = "".join(self.hk.FORM_LAUNCHES - before) or (
                f"{fn.__name__} (plain)")
            self.err[form] = max(self.err.get(form, 0), assert_equal(
                f"server {form}", got, ref(*copies)))
            return got
        return call

    def remove(self) -> None:
        for name, fn in self.wrappers.items():
            setattr(self.hk, name, fn)


def instrument_server(s, st: dict) -> None:
    """Counts member s's node rounds (each ready() that ran one) and
    records the seconds of each such ready() (the device round, its
    wait for the device lock and the Ready's translation), of each of
    its applies and of each WAL fsync."""
    ready, apply_all, flush = s.node.ready, s._apply_all, s.wal._w.flush

    def counted_ready(timeout=None):
        t = time.perf_counter()
        rd = ready(timeout)
        if rd is not None:
            st["rounds"] += 1
            st["ready"].append(time.perf_counter() - t)
        return rd

    def timed_apply(task):
        t = time.perf_counter()
        try:
            return apply_all(task)
        finally:
            st["apply"].append(time.perf_counter() - t)

    def timed_flush(sync=True):
        t = time.perf_counter()
        try:
            return flush(sync=sync)
        finally:
            if sync:
                st["fsync"].append(time.perf_counter() - t)

    s.node.ready, s._apply_all, s.wal._w.flush = (
        counted_ready, timed_apply, timed_flush)


def client_load(clients: list, n: int, op, what: str,
                timeout: float = 300.0) -> "tuple[list, list, float]":
    """op(client, i) for i in 0..n-1 over the clients, one request in
    flight on each: returns each op's seconds, its result and the wall
    seconds. Any error raises."""
    import itertools

    counter = itertools.count()
    lat, res, errs = [0.0] * n, [None] * n, []

    def worker(c):
        while not errs:
            i = next(counter)
            if i >= n:
                return
            t = time.perf_counter()
            try:
                res[i] = op(c, i)
            except Exception as e:  # noqa: BLE001 — raised below
                errs.append((i, repr(e)))
                return
            lat[i] = time.perf_counter() - t

    threads = [threading.Thread(target=worker, args=(c,), daemon=True)
               for c in clients]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(max(1.0, timeout - (time.perf_counter() - t0)))
    wall = time.perf_counter() - t0
    if errs or any(th.is_alive() for th in threads):
        raise AssertionError(f"server {what}: {errs[:3] or 'timed out'}")
    return lat, res, wall


def server_kv(s) -> dict:
    """Member s's whole key space, read serializably on s."""
    from etcd_tpu_torch.server.api import RangeRequest

    rr = s.range(RangeRequest(key=b"\x00", range_end=b"\xff",
                              serializable=True))
    return {kv.key: kv.value for kv in rr.kvs}


def server_get(s, key: bytes):
    """key's value on member s, read serializably on s (None if absent)."""
    from etcd_tpu_torch.server.api import RangeRequest

    rr = s.range(RangeRequest(key=key, serializable=True))
    return rr.kvs[0].value if rr.kvs else None


def wait_for(pred, what: str, limit: float = 120.0) -> float:
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > limit:
            raise AssertionError(f"server: {what} timed out")
        time.sleep(0.01)
    return time.perf_counter() - t0


class ServerSet:
    """A port functional.Cluster on `dev`, every member behind a
    V3RPCServer whose address it publishes (as embed/etcd.py does, so a
    follower forwards a lease renewal to the leader), each member's node
    rounds, applies and fsyncs recorded."""

    def __init__(self, tmp: str, dev, snapshots=None, **kw):
        """`snapshots`: (snapshot_count, snapshot_catchup_entries) set on
        every member once it has booted (its ring's width is the one its
        own configuration gives)."""
        from etcd_tpu_torch.functional import Cluster

        self.stats = {}
        self.rpcs = {}
        self.snapshots = snapshots
        self.c = Cluster(tmp, n=3, device=dev, **kw)
        for s in self.c.alive():
            self._serve(s)

    def _serve(self, s) -> None:
        from etcd_tpu_torch.v3rpc import V3RPCServer

        st = self.stats.setdefault(s.id, {"rounds": 0, "ready": [],
                                          "apply": [], "fsync": []})
        instrument_server(s, st)
        if self.snapshots:
            (s.cfg.snapshot_count,
             s.cfg.snapshot_catchup_entries) = self.snapshots
        rpc = self.rpcs[s.id] = V3RPCServer(s, bind=("127.0.0.1", 0))
        s.publish(f"m{s.id}", ["http://%s:%d" % rpc.addr[:2]])

    def addr(self, mid: int):
        return self.rpcs[mid].addr

    def rounds(self) -> int:
        return sum(st["rounds"] for st in self.stats.values())

    def kill(self, mid: int) -> None:
        self.rpcs.pop(mid).stop()
        self.c.kill(mid)

    def restart(self, mid: int):
        s = self.c.restart(mid)
        self._serve(s)
        return s

    def close(self) -> None:
        for rpc in self.rpcs.values():
            rpc.stop()
        self.c.close()


class KeptLease:
    """A lease kept alive by the client's own keep-alive loop
    (Client.lease_keep_alive, a renewal every `interval` s), with each
    renewal's reply or exception recorded beside its time, and the
    leader's id and the lease's remaining seconds on the leader's lessor
    sampled every 0.25 s."""

    def __init__(self, c, cl, ttl: int, interval: float):
        self.c, self.cl, self.interval = c, cl, interval
        self.id = cl.lease_grant(ttl=ttl).id
        self.renewals = []  # (t, the TTL returned or the exception's repr)
        self.samples = []   # (t, leader id, remaining s on the leader)
        once = cl.lease_keep_alive_once

        def recorded(lease_id):
            t = time.perf_counter()
            try:
                got = once(lease_id)
            except BaseException as e:
                self.renewals.append((t, repr(e)))
                raise
            self.renewals.append((t, got))
            return got

        cl.lease_keep_alive_once = recorded
        self._stop_keep_alive = cl.lease_keep_alive(self.id, interval=interval)
        self._done = threading.Event()
        self._sampler = threading.Thread(target=self._sample, daemon=True)
        self._sampler.start()

    def _sample(self) -> None:
        while not self._done.wait(0.25):
            try:
                lead = self.c.leader()
                lease = lead.lessor.lookup(self.id) if lead else None
                self.samples.append((time.perf_counter(),
                                     lead.id if lead else None,
                                     lease.remaining() if lease else None))
            except Exception as e:  # noqa: BLE001 — kept in the record
                self.samples.append((time.perf_counter(), None, repr(e)))

    def renewed_since(self, t: float) -> int:
        return sum(1 for at, got in self.renewals
                   if at >= t and isinstance(got, int))

    def summary(self) -> dict:
        now = time.perf_counter()
        ok = [at for at, got in self.renewals if isinstance(got, int)]
        errors = collections.Counter(got.split("(")[0] + ": " + got[:60]
                                     for _at, got in self.renewals
                                     if not isinstance(got, int))
        leaders = [lid for _t, lid, _r in self.samples]
        left = [r for _t, _l, r in self.samples if isinstance(r, float)]
        return {
            "renewed": len(ok), "errors": dict(errors),
            "longest_gap_s": max(
                (b - a for a, b in zip(ok, ok[1:])), default=None),
            "last_renewal_ago_s": now - self.renewals[-1][0]
            if self.renewals else None,
            "leaders": [x for i, x in enumerate(leaders)
                        if i == 0 or x != leaders[i - 1]],
            "least_remaining_s": min(left, default=None)}

    def check(self, at, n_keys: int) -> dict:
        """The lease is alive on the leader (client `at`) with its n_keys
        keys and the keep-alive loop is still running; else raises with
        the record's end."""
        ttl = at.lease_time_to_live(self.id, keys=True)
        out = self.summary()
        ago = out["last_renewal_ago_s"]
        if (ttl.get("ttl", -1) <= 0 or len(ttl.get("keys", [])) != n_keys
                or ago is None or ago > 4 * self.interval + 2.5):
            raise AssertionError(
                f"server: the kept lease {ttl}, its keep-alive {out}, the "
                f"last renewals {self.renewals[-6:]}, the last samples "
                f"{self.samples[-6:]}")
        return out

    def stop(self) -> None:
        self._stop_keep_alive()
        self._done.set()
        self._sampler.join(5)


class Oracle:
    """The plain reference: a dict that replays every acknowledged put
    in revision order."""

    def __init__(self):
        self.ops = []  # (revision, key, value)

    def put(self, rev: int, key: bytes, value: bytes) -> None:
        self.ops.append((rev, key, value))

    def replay(self, removed=()) -> dict:
        """The acked puts in revision order, then the keys `removed`
        after all of them (a lease's expiry or revoke)."""
        writes = [op[:2] for op in self.ops]
        if len(set(writes)) != len(writes):
            raise AssertionError("server: a key acked twice at a revision")
        kv = {}
        for _rev, key, value in sorted(self.ops):
            kv[key] = value
        for key in removed:
            kv.pop(key, None)
        return kv


def run_server(dev, puts: int = SERVER_PUTS, clients: int = SERVER_CLIENTS,
               ranges: int = SERVER_RANGES, tick: float = SERVER_TICK,
               snap_puts: int = SERVER_SNAP_PUTS,
               snapshots=(SERVER_SNAP_COUNT, SERVER_SNAP_CATCHUP)) -> dict:
    """Three port EtcdServers on `dev` in this process at the server's
    default snapshot_count (the node's ring at W = 32,768), each then
    snapshotting as `snapshots` (count, catch-up entries) says, each behind
    a V3RPCServer, driven by port Clients: a watch on the put range;
    `puts` puts of sequential 8-byte keys and 256-byte values through
    `clients` connections to the leader; `ranges` linearizable and
    `ranges` serializable ranges spread over the members; a txn mix; a
    lease kept alive and one left to expire with its keys; a compaction
    and a read below it (ErrCompacted); a lock contended by two clients;
    a follower stopped and restarted from its snapshot and its WAL's
    tail (the leader's ring compacted before); then, on a second
    cluster with snapshot_count 16, a follower caught up by MsgSnap.
    Checks every acked put on every member with its bytes, each member's
    whole KV against the oracle, hash_check, the watch against the acked
    puts in revision order, and every node form against its plain
    version. Returns the launches and form launches of the run and its
    node rounds."""
    import shutil
    import tempfile

    from etcd_tpu_torch.batched import hopper_kernels as hk
    from etcd_tpu_torch.batched.graph import device_work
    from etcd_tpu_torch.client import Client, ClientError
    from etcd_tpu_torch.client.concurrency import Session
    from etcd_tpu_torch.functional import hash_check, lease_expire_check
    from etcd_tpu_torch.server.api import (
        Compare, CompareResult, CompareTarget, PutRequest, RequestOp,
        TxnRequest)
    from etcd_tpu_torch.storage.mvcc import CompactedError

    cuda = dev.type == "cuda"
    rng = np.random.RandomState(SEED)
    values = rng.bytes(puts * SERVER_VALUE_BYTES)
    tmp = tempfile.mkdtemp(prefix="chip-smoke-server-")
    forms = ServerForms()
    hk.reset_launches()
    t0 = time.perf_counter()
    sset = small = None
    conns = []
    try:
        sset = ServerSet(os.path.join(tmp, "main"), dev, snapshots=snapshots,
                         tick_interval=tick, election_tick=10,
                         heartbeat_tick=1)
        c = sset.c
        lead = c.wait_leader(60)
        boot_s = time.perf_counter() - t0
        stages, t_stage = {}, [time.perf_counter()]

        def stage(name):
            now = time.perf_counter()
            stages[name] = now - t_stage[0]
            t_stage[0] = now
        window = lead.node.rn.cfg.window
        oracle = Oracle()

        def client(mid):
            cl = Client([sset.addr(mid)])
            conns.append(cl)
            return cl

        # A watch over the put keys from the first revision to come.
        watcher = client(lead.id)
        rev0 = lead.kv.rev()
        handle = watcher.watch(b"0", b":", start_rev=rev0 + 1)
        seen = []
        done = threading.Event()
        until = [0, float("inf")]  # events expected, the deadline

        def watch_loop():
            while not (done.is_set() and (
                    len(seen) >= until[0]
                    or time.perf_counter() > until[1])):
                batch = handle.get(timeout=0.5)
                if batch is not None:
                    seen.extend(batch[1])

        wth = threading.Thread(target=watch_loop, daemon=True)
        wth.start()

        # Puts: 8-byte sequential keys, 256-byte values, to the leader.
        put_conns = [client(lead.id) for _ in range(clients)]

        def put(cl, i):
            key = b"%0*d" % (SERVER_KEY_BYTES, i)
            value = values[i * SERVER_VALUE_BYTES:(i + 1) * SERVER_VALUE_BYTES]
            resp = cl.put(key, value)
            oracle.put(resp.header.revision, key, value)
            return resp.header.revision

        leaders = [lead.id]
        r0 = sset.rounds()
        put_lat, _, put_s = client_load(put_conns, puts, put, "puts")
        put_rounds = sset.rounds() - r0
        leaders.append(c.wait_leader(60).id)

        stage("puts")
        # Ranges of acked keys, each value held to its bytes, spread over
        # the members (a follower asks the leader for the read index).
        spread = [client(1 + i % 3) for i in range(clients)]
        range_stats = {}
        for consistency, range_conns in (("linearizable", spread),
                                         ("serializable", spread)):
            keys = rng.randint(puts, size=ranges)

            def get(cl, i, ser=consistency == "serializable"):
                k = int(keys[i])
                rr = cl.get(b"%0*d" % (SERVER_KEY_BYTES, k), serializable=ser)
                want = values[k * SERVER_VALUE_BYTES:
                              (k + 1) * SERVER_VALUE_BYTES]
                if len(rr.kvs) != 1 or rr.kvs[0].value != want:
                    raise AssertionError(f"range of key {k} read {rr.kvs}")

            lat, _, wall = client_load(range_conns, ranges, get, consistency)
            range_stats[consistency] = {**pcts(lat), "per_s": ranges / wall}

        stage("ranges")
        # A txn mix: compare-and-swap on 20 counters, else read.
        txn_conns = put_conns[:20]

        def txn(cl, i):
            key = b"txn/%02d" % (i % 20)
            cur = cl.get(key)
            version = cur.kvs[0].version if cur.kvs else 0
            value = b"%d" % i
            resp = cl.txn(TxnRequest(
                compare=[Compare(result=CompareResult.EQUAL,
                                 target=CompareTarget.VERSION, key=key,
                                 version=version)],
                success=[RequestOp(request_put=PutRequest(key=key,
                                                          value=value))],
                failure=[]))
            if resp.succeeded:
                oracle.put(resp.header.revision, key, value)
            return resp.succeeded

        txns = min(SERVER_TXNS, puts)
        txn_lat, txn_ok, _ = client_load(txn_conns, txns, txn, "txns")

        stage("txns")
        # Leases: one left to expire with its keys, one kept alive to the
        # end of the phase by a client pinned to this member (the watch's
        # too, which no later stage stops).
        pinned = lead.id
        lc = client(pinned)
        kept = KeptLease(c, lc, ttl=4, interval=0.5)
        removed = []
        for name, ttl in ((b"doomed", 5), (b"kept", 0)):
            lid = lc.lease_grant(ttl=ttl).id if ttl else kept.id
            if ttl:
                doomed = lid
            # One txn puts the lease's keys, one round trip after the
            # grant, however slow the host.
            keys = [b"lease/%s/%d" % (name, j) for j in range(LEASE_KEYS)]
            resp = lc.txn(TxnRequest(compare=[], failure=[], success=[
                RequestOp(request_put=PutRequest(key=k, value=k, lease=lid))
                for k in keys]))
            for k in keys:
                oracle.put(resp.header.revision, k, k)
            removed += keys
        lease_expire_check(c.wait_leader(60), [doomed], removed[:LEASE_KEYS],
                           timeout=60.0)
        # The lead moves off the pinned member: from here each renewal
        # reaches the lessor through a follower, which forwards it to the
        # leader at the client URL the leader published.
        old = c.wait_leader(60).id
        target = next(s.id for s in c.followers() if s.id != pinned)
        t_move = time.perf_counter()
        asked = [0.0]  # when the transfer was last asked for

        def transferred():
            lead = c.leader()
            if lead is not None and lead.id == target:
                return True
            if lead is not None and time.perf_counter() - asked[0] > 2.0:
                asked[0] = time.perf_counter()
                lead.node.transfer_leadership(lead.id, target)
            return False

        wait_for(transferred, "the leader transfer", limit=30.0)
        t_moved = time.perf_counter()
        lead = c.wait_leader(60)
        leaders.append(lead.id)
        wait_for(lambda: kept.renewed_since(t_moved) >= 3,
                 "the kept lease's renewals after the transfer", limit=30.0)
        transfer = {"from": old, "to": target, "s": t_moved - t_move,
                    "renewals_after": kept.renewed_since(t_moved)}

        stage("leases")
        # Compaction, and a read below it, on the leader.
        compact_rev = lead.kv.rev() - 1
        cc = client(lead.id)
        cc.compact(compact_rev)
        try:
            cc.get(b"%0*d" % (SERVER_KEY_BYTES, 0), revision=compact_rev - 1)
            raise AssertionError("server: a read below the compaction")
        except ClientError as e:
            if not isinstance(e.as_typed(), CompactedError):
                raise

        stage("compaction")
        # A lock contended by two clients.
        l1, l2 = client(lead.id), client(lead.id)
        s1, s2 = Session(l1, ttl=30), Session(l2, ttl=30)
        k1 = l1.lock(b"chip-lock", s1.lease_id)
        got = []
        th = threading.Thread(target=lambda: got.append(
            l2.lock(b"chip-lock", s2.lease_id)), daemon=True)
        th.start()
        time.sleep(0.5)
        if got:
            raise AssertionError("server: the lock was taken twice")
        l1.unlock(k1)
        th.join(30)
        if not got or got[0] == k1:
            raise AssertionError(f"server: the second lock holder {got}")
        l2.unlock(got[0])
        s1.close()
        s2.close()

        stage("lock")
        # A follower stopped, puts while it is down, restarted on its
        # snapshot and its WAL's tail (not the pinned member: the watch and
        # the kept lease's client stay connected through it). The leader
        # has compacted its full-width ring.
        lead = c.wait_leader(60)
        lead_floor = int(lead.node.rn.m_snap[0])
        victim = next(s.id for s in c.followers() if s.id != pinned)
        victim_snap = c.servers[victim].snapshotter.load().metadata.index
        if lead_floor <= 1 or victim_snap == 0:
            raise AssertionError(
                f"server: no snapshot at W = {window} before the restart "
                f"(the leader's ring floor {lead_floor}, the follower's "
                f"snapshot {victim_snap})")
        sset.kill(victim)
        down_conns = [client(lead.id) for _ in range(min(clients, 20))]
        down = min(SERVER_DOWN_PUTS, puts)
        _, _, down_s = client_load(
            down_conns, down,
            lambda cl, i: put(cl, puts + i), "puts with a member down")
        t_restart = time.perf_counter()
        back = sset.restart(victim)
        booted_floor = int(back.node.rn.m_snap[0])
        if booted_floor < victim_snap:
            raise AssertionError(
                f"server: the restarted follower's ring floor {booted_floor}"
                f", its snapshot {victim_snap}")
        last = b"%0*d" % (SERVER_KEY_BYTES, puts + down - 1)
        catch_up_s = wait_for(lambda: server_get(back, last) is not None,
                              "the restarted follower's catch-up")
        restart_s = time.perf_counter() - t_restart
        leaders.append(c.wait_leader(60).id)

        stage("restart")
        # Device time and kernels a node round: a wave of puts under the
        # profiler, which starts and stops under the device lock (C9).
        device = {"device_ms": "not measured"}
        wave = min(SERVER_PROFILE_PUTS, puts)
        prof_conns = [client(c.wait_leader(60).id) for _ in range(wave)]
        first = puts + down
        prof_s = {}  # seconds each member's rounds wait on the profiler
        if cuda:
            from torch.profiler import ProfilerActivity, profile

            from etcd_tpu_torch.tools.kernel_times import (
                _device_us, kernel_events)

            prof = profile(activities=[ProfilerActivity.CUDA])
            t = time.perf_counter()
            with device_work():
                prof.start()
            prof_s["start"] = time.perf_counter() - t
        r1 = sset.rounds()
        try:
            client_load(prof_conns, wave, lambda cl, i: put(cl, first + i),
                        "profiled puts")
        finally:
            if cuda:
                t = time.perf_counter()
                with device_work():
                    torch.cuda.synchronize(dev)
                    prof.stop()
                prof_s["stop"] = time.perf_counter() - t
        wave_rounds = sset.rounds() - r1
        leaders.append(c.wait_leader(60).id)
        if cuda:
            ev = kernel_events(prof)
            kern = [e for e in ev
                    if not e.key.startswith(("Memcpy", "Memset"))]
            if kern and wave_rounds:
                device = {
                    "device_ms": sum(_device_us(e) for e in kern) / 1e3
                    / wave_rounds,
                    "kernels": sum(e.count for e in kern) / wave_rounds,
                    "copy_ms": sum(_device_us(e) for e in ev
                                   if e not in kern) / 1e3 / wave_rounds,
                    "node_rounds": wave_rounds, "profiler_s": prof_s,
                    "hopper_kernels": {
                        e.key: {"calls": e.count,
                                "device_us_per_call": _device_us(e) / e.count}
                        for e in kern if "quorum_commit_vote" in e.key
                        or "term_at_batch" in e.key}}
        total = puts + down + wave

        stage("profile")
        # The kept lease outlived the compaction, the lock, the restart
        # and the profiled wave, with its keys.
        kept_alive = kept.check(client(c.wait_leader(60).id), LEASE_KEYS)
        kept_alive["alive_s"] = time.perf_counter() - kept.renewals[0][0]
        kept.stop()
        lc.lease_revoke(kept.id)
        # Every acked write on every member, as the oracle has it (the
        # leases' keys went after all their puts).
        want = oracle.replay(removed=removed)
        wait_for(lambda: all(server_kv(s) == want for s in c.alive()),
                 "every member's KV equal to the oracle", limit=60.0)
        agreed = hash_check(c.alive())
        until[:] = [total, time.perf_counter() + 30.0]
        done.set()
        wth.join(40)
        got_puts = [(e.kv.key, e.kv.value, e.kv.mod_revision) for e in seen]
        want_puts = [(key, value, rev) for rev, key, value in
                     sorted(oracle.ops) if key[:1].isdigit()]
        if got_puts != want_puts:
            raise AssertionError(
                f"server: the watch saw {len(got_puts)} puts of "
                f"{len(want_puts)}, or out of order")
        captures = {s.id: s.node.rn.captures for s in c.alive()}
        if cuda and set(captures.values()) != {1}:
            raise AssertionError(f"server: captures per member {captures}")
        stats = {mid: dict(st) for mid, st in sset.stats.items()}
        main_rounds = sset.rounds()
        sset.close()
        sset = None

        stage("checks")
        # A lagging member caught up by MsgSnap: snapshot_count 16.
        small = ServerSet(os.path.join(tmp, "small"), dev,
                          tick_interval=0.05, snapshot_count=16,
                          snapshot_catchup_entries=4, request_timeout=25.0)
        sc = small.c
        sc.wait_leader(60)
        behind = next(s for s in sc.followers())
        behind_id, behind_applied = behind.id, behind.applied_index()
        small.kill(behind_id)
        for i in range(snap_puts):
            sc.wait_leader(60).put(PutRequest(key=b"s%03d" % i,
                                              value=b"w%d" % i))
        wait_for(lambda: sc.leader() is not None and int(
            sc.leader().node.rn.m_snap[0]) > behind_applied,
            "the small cluster's ring floor passes the follower")
        floor = int(sc.leader().node.rn.m_snap[0])
        back = small.restart(behind_id)
        wait_for(lambda: all(server_get(back, b"s%03d" % i) == b"w%d" % i
                             for i in range(snap_puts)),
                 "the MsgSnap catch-up")
        snap_index = back.snapshotter.load().metadata.index
        if snap_index < floor:
            raise AssertionError(f"server: the follower's snapshot at "
                                 f"{snap_index}, the floor at {floor}")
        hash_check(sc.alive())
        small_rounds = small.rounds()
        small.close()
        small = None

        stage("msgsnap")
        rounds = main_rounds + small_rounds
        launches, form_launches = dict(hk.LAUNCHES), dict(hk.FORM_LAUNCHES)
        for name, count in launches.items():
            if count == 0:
                raise AssertionError(f"{name} was never launched on the "
                                     "server path")
        if cuda and not forms.err:
            raise AssertionError("server: no node form was held to its "
                                 "plain version")
        ready_s = [x for st in stats.values() for x in st["ready"]]
        apply_s = [x for st in stats.values() for x in st["apply"]]
        fsync_s = [x for st in stats.values() for x in st["fsync"]]
        log("server", members=3, clients=clients, window=window,
            config=f"etcd benchmark: {SERVER_KEY_BYTES}-byte sequential keys,"
            f" {SERVER_VALUE_BYTES}-byte values, tick {tick} s, election "
            "10 ticks", boot_s=boot_s, puts=puts,
            puts_per_s=puts / put_s, put_ms=pcts(put_lat),
            put_node_rounds=put_rounds,
            ranges=range_stats, txns=txns,
            txn_succeeded=sum(bool(x) for x in txn_ok), txn_ms=pcts(txn_lat),
            acked_writes=len(oracle.ops), keys=len(want),
            puts_total=total, watch_events=len(seen),
            compacted_at=compact_rev, lease_expired=doomed,
            lease_kept_alive=kept_alive, leader_transfer=transfer,
            leaders=leaders,
            restarted=victim, puts_while_down=down,
            snapshot_count=snapshots[0], leader_ring_floor=lead_floor,
            restarted_from_snapshot=victim_snap,
            down_puts_s=down_s, restart_s=restart_s, catch_up_s=catch_up_s,
            msgsnap={"follower": behind_id, "floor": floor,
                     "snapshot_index": snap_index, "puts": snap_puts},
            hash_revision=agreed,
            ready_ms=pcts(ready_s), apply_ms=pcts(apply_s),
            fsync_ms=pcts(fsync_s),
            node_rounds={mid: st["rounds"] for mid, st in stats.items()},
            device_per_node_round=device,
            launches=launches,
            launches_per_server_round={k: v / rounds
                                       for k, v in launches.items()},
            form_launches_per_server_round={k: v / rounds for k, v in
                                            form_launches.items()},
            forms_held_to_plain=forms.err, captures=captures,
            stage_s=stages, wall_s=time.perf_counter() - t0,
            card=smi("name,power.limit") if cuda else str(dev))
        return {"launches": launches, "forms": form_launches,
                "rounds": rounds}
    finally:
        forms.remove()
        for cl in conns:
            cl.close()
        for s in (sset, small):
            if s is not None:
                s.close()
        shutil.rmtree(tmp, ignore_errors=True)


def run_server_parity(dev, plain_dev=torch.device("cpu"),
                      ops: int = SERVER_PARITY_OPS) -> None:
    """The same scripted request stream (tools/server_script: puts, ranges,
    txns, deletes, leases, a compaction, a watch), one request at a time
    to the leader, to a three-member cluster on `dev` and to one on the
    CPU: every response body equal (header term and member left out) and
    hash_kv equal at the end."""
    import shutil
    import tempfile

    from etcd_tpu_torch.functional import Cluster
    from etcd_tpu_torch.server import api
    from etcd_tpu_torch.tools import server_script as ss

    tmp = tempfile.mkdtemp(prefix="chip-smoke-server-parity-")
    t0 = time.perf_counter()
    bodies, hashes = {}, {}
    try:
        for label, d in (("dev", dev), ("plain", plain_dev)):
            c = Cluster(os.path.join(tmp, label), n=3, device=d,
                        snapshot_count=16, snapshot_catchup_entries=4,
                        request_timeout=25.0, tick_interval=0.05)
            try:
                c.wait_leader(60)
                bodies[label] = ss.run(c, ss.script(api, SEED, ops),
                                       watch=True)
                hashes[label] = ss.final_hash(c)
            finally:
                c.close()
        for j, (a, b) in enumerate(zip(bodies["dev"], bodies["plain"],
                                       strict=True)):
            if a != b:
                raise AssertionError(f"server_parity: response {j} differs:"
                                     f" {a} vs {b}")
        if hashes["dev"] != hashes["plain"]:
            raise AssertionError(f"server_parity: hash_kv {hashes}")
        log("server_parity", equal=True, requests=len(bodies["dev"]),
            watch_events=len(bodies["dev"][-1]), hash_kv=hashes["dev"],
            wall_s=time.perf_counter() - t0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- phase: boot (python -m etcd_tpu_torch members; etcd's benchmark tool) ----


BOOT_PUTS = 1_500           # the benchmark tool's puts (etcd's: 100,000)
BOOT_CLIENTS = 100
BOOT_RANGES = 300           # the tool's ranges, a consistency a member
                            # (5 a connection, so p99 is the 5th worst)
BOOT_CHECKED = 500          # puts of distinct keys and random values, each
                            # read back on every member
BOOT_CHECK_CLIENTS = 20
C17_SECONDS = 2.0           # reads a run: none, a follower, the leader slowed


def bench_tool(endpoint: str, device, *args) -> dict:
    """One run of `python -m etcd_tpu_torch.tools.benchmark` in its own
    process against `endpoint`, with BOOT_CLIENTS connections: its
    requests, errors, throughput and latency percentiles as it printed
    them. Any error, or fewer requests than asked, raises."""
    import re

    from etcd_tpu_torch.tools.member_procs import member_env

    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "etcd_tpu_torch.tools.benchmark",
         "--endpoints", endpoint, "--clients", str(BOOT_CLIENTS), *args],
        env=member_env(device), capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"boot: benchmark {args} rc {r.returncode}: "
                             f"{r.stderr[-2000:]}")
    out = {"process_s": time.perf_counter() - t0}
    for key, pat in (("total_s", r"Total:\t([\d.]+) s"),
                     ("requests", r"Requests:\t(\d+)"),
                     ("errors", r"\(errors (\d+)\)"),
                     ("per_s", r"Throughput:\t([\d.]+) req/s"),
                     ("p50_ms", r"p50:\t([\d.]+) ms"),
                     ("p90_ms", r"p90:\t([\d.]+) ms"),
                     ("p99_ms", r"p99:\t([\d.]+) ms"),
                     ("p99.9_ms", r"p99\.9:\t([\d.]+) ms")):
        m = re.search(pat, r.stdout)
        if m is None:
            raise AssertionError(f"boot: benchmark printed {r.stdout!r}")
        out[key] = float(m.group(1))
    total = int(args[args.index("--total") + 1])
    if out["errors"] or out["requests"] != total:
        raise AssertionError(f"boot: benchmark {args}: {out}")
    return out


def launch_delta(before: dict, after: dict) -> dict:
    """A member's node rounds and launches between two launch lines of
    one of its processes (`launches_now`)."""
    if after["gen"] != before["gen"]:
        raise AssertionError(f"boot: member {after['member']} restarted")
    return {"rounds": after["rounds"] - before["rounds"],
            **{field: {k: v - before[field].get(k, 0)
                       for k, v in after[field].items()}
               for field in ("launches", "forms")}}


def run_tool(main, *argv) -> "tuple[int, str]":
    """A tool's `main` in this process: its exit code and its output."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(list(argv))
    return rc, out.getvalue()


def dump_live_metrics(port: int) -> dict:
    """tools/dump_metrics on a live member's /metrics: the series count
    and the server's leader and proposal series, which must be there."""
    from etcd_tpu_torch.tools import dump_metrics

    t0 = time.perf_counter()
    rc, out = run_tool(dump_metrics.main, "--addr", f"127.0.0.1:{port}")
    series = dump_metrics.parse_series(out)
    for name in ("etcd_server_has_leader", "etcd_server_proposals_committed_total"):
        if rc != 0 or series.get(name, 0) <= 0:
            raise AssertionError(f"dump_metrics rc {rc}: no {name} > 0 in "
                                 f"{out[:2000]}")
    return {"series": len(series), "seconds": time.perf_counter() - t0,
            **{k: series[k] for k in ("etcd_server_has_leader",
                                      "etcd_server_proposals_committed_total")}}


def dump_stopped_member(data_dir: str, key: bytes, value: bytes) -> dict:
    """tools/dump_db (list-bucket, iterate-bucket key --decode, hash) and
    tools/dump_logs on a stopped member's data dir: `key` = `value` in
    the decoded key bucket, its put among the WAL's entries."""
    from etcd_tpu_torch.tools import dump_db, dump_logs

    out = {}
    rc, text = run_tool(dump_db.main, "list-bucket", data_dir)
    if rc != 0 or "key" not in text.splitlines():
        raise AssertionError(f"dump_db list-bucket rc {rc}: {text[:500]}")
    out["buckets"] = text.split()
    rc, text = run_tool(dump_db.main, "iterate-bucket", data_dir, "key",
                        "--decode")
    if rc != 0 or f"key={key!r} | val={value!r}" not in text:
        raise AssertionError(f"dump_db iterate-bucket rc {rc}: no {key!r}")
    out["key_revisions"] = len(text.splitlines())
    rc, text = run_tool(dump_db.main, "hash", data_dir)
    if rc != 0 or "Hash:" not in text:
        raise AssertionError(f"dump_db hash rc {rc}: {text[:500]}")
    out["hash"] = text.split("Hash: ")[1].strip()
    rc, text = run_tool(dump_logs.main, data_dir)
    if rc != 0 or f"key={key!r}" not in text:
        raise AssertionError(f"dump_logs rc {rc}: no put of {key!r}")
    out["wal_lines"] = len(text.splitlines())
    return out


def run_boot(dev, puts: int = BOOT_PUTS, ranges: int = BOOT_RANGES,
             checked: int = BOOT_CHECKED, server_path=None,
             mirror_keys: int = 200, c17_seconds: float = C17_SECONDS) -> dict:
    """etcd's own deployment on `dev`: three `python -m etcd_tpu_torch`
    member processes at etcd's defaults (snapshot_count 100,000, the
    node's ring at W = 32,768; heartbeat 100 ms, election 1,000 ms; the
    "tpu" backend; on the card no --device, so each member takes the
    GPU, with a CUDA context and a device lock of its own), loaded the
    way etcd's documented benchmark loads them, from processes of their
    own: the port's tools/benchmark.py puts `puts` 8-byte sequential
    keys of 256-byte values through 100 connections to the leader, then
    `ranges` ranges of a key of each consistency at every member,
    followers included. Then `checked` puts of distinct keys and random
    values from this process, each read back with its bytes on every
    member, and the tool's keys too; hash_kv equal on every member; a
    snapshot saved through the port's client, restored by `python -m
    etcd_tpu_torch.etcdutl`, a solo member booted on `dev` from it and a
    read there; the `ctl` stage (tools/ctl_stage.py: the port's etcdctl
    and grpc-proxy as processes of their own against the members,
    make-mirror into the solo member; its node rounds and launches from
    the members' launch lines before and after it); linearizable reads
    at every member with no member, a follower and the leader slowed by
    SIGSTOP/SIGCONT bursts (ROADMAP C17); the port's gateway in front of
    the members, the leader first, and kill -9 of the leader through it
    (the stage's last step; its seconds a step on a line of their own),
    a read at each survivor, its restart on its data dir and a read
    there.
    Every member's orderly stop writes its `kernel launches:` line:
    their sum is the path's launches and node rounds (the killed
    leader's process writes none, so its launches are left out of the
    totals, not of the per-round counts). Any failure raises."""
    import shutil
    import tempfile

    from etcd_tpu_torch.tools.ctl_stage import (
        run_ctl_stage, slowed_reads, step_gateway)
    from etcd_tpu_torch.tools.member_procs import (
        MemberCluster, MemberProc, free_ports, member_env)

    cuda = dev.type == "cuda"
    device = worker_device(dev)
    rng = np.random.RandomState(SEED + 11)
    tmp = tempfile.mkdtemp(prefix="chip-smoke-boot-")
    t0 = time.perf_counter()
    stages, t_stage = {}, [time.perf_counter()]

    def stage(name):
        now = time.perf_counter()
        stages[name] = now - t_stage[0]
        t_stage[0] = now

    try:
        c = MemberCluster(os.path.join(tmp, "cluster"), device=device)
        solo = None
        conns = []

        def client(p):
            cl = p.client(timeout=60.0)
            conns.append(cl)
            return cl

        try:
            boot_s = c.start()
            lead = c.leader()
            stage("boot")
            put = bench_tool(
                lead.endpoint, device, "--total", str(puts), "--val-size",
                str(SERVER_VALUE_BYTES), "--key-size", str(SERVER_KEY_BYTES),
                "put", "--sequential-keys")
            stage("puts")
            range_stats = {}
            for p in c.procs:
                for consistency, flag in (
                        ("linearizable", ["--consistency-l"]),
                        ("serializable", [])):
                    st = bench_tool(p.endpoint, device, "--total", str(ranges),
                                    "range", "000-0000", *flag)
                    range_stats[f"{p.name} {consistency}"] = {
                        "role": "leader" if p is lead else "follower",
                        **{k: st[k] for k in ("per_s", "p50_ms", "p99_ms",
                                              "process_s")}}
            stage("ranges")
            # Checked writes: distinct keys, random bytes, each ack recorded.
            values = rng.bytes(checked * SERVER_VALUE_BYTES)
            want = {b"check/%06d" % i:
                    values[i * SERVER_VALUE_BYTES:(i + 1) * SERVER_VALUE_BYTES]
                    for i in range(checked)}
            keys = list(want)
            _lat, _res, checked_s = client_load(
                [client(lead) for _ in range(BOOT_CHECK_CLIENTS)], checked,
                lambda cl, i: cl.put(keys[i], want[keys[i]]).header.revision,
                "boot checked puts")
            tool_keys = {b"%03d-0000" % i: b"v" * SERVER_VALUE_BYTES
                         for i in range(BOOT_CLIENTS)}

            def member_kv(p):
                rr = client(p).get(b"\x00", b"\xff")  # linearizable
                return {kv.key: kv.value for kv in rr.kvs}

            for p in c.procs:
                kv = member_kv(p)
                if kv != {**tool_keys, **want}:
                    raise AssertionError(
                        f"boot: member {p.name} holds {len(kv)} keys, "
                        f"{len(tool_keys) + len(want)} acked")
            rev = client(lead).status()["revision"]
            hashes = {p.name: client(p).hash_kv(rev)["hash"] for p in c.procs}
            if len(set(hashes.values())) != 1:
                raise AssertionError(f"boot: hash_kv at {rev}: {hashes}")
            stage("checks")
            # The operator tools on a live member: dump_metrics scrapes
            # its /metrics.
            metrics = dump_live_metrics(lead.metrics_port)
            stage("dump_metrics")
            last = keys[-1]
            # A snapshot through the client, restored by the port's etcdutl,
            # booted as a solo member on the device.
            snap = os.path.join(tmp, "boot.snap.db")
            with open(snap, "wb") as f:
                f.write(client(lead).snapshot())
            pp, cp, mp = free_ports(3)
            restored = os.path.join(tmp, "restored")
            r = subprocess.run(
                [sys.executable, "-m", "etcd_tpu_torch.etcdutl", "snapshot",
                 "restore", snap, "--data-dir", restored, "--name", "solo",
                 "--initial-cluster", f"solo=http://127.0.0.1:{pp}"],
                env=member_env(device), capture_output=True, text=True,
                timeout=300)
            if r.returncode != 0:
                raise AssertionError(
                    f"boot: etcdutl restore: {r.stderr[-2000:]}")
            solo = MemberProc("solo", restored, pp, cp, mp,
                              f"solo=http://127.0.0.1:{pp}", device=device,
                              log_dir=tmp)
            solo.start()
            solo_s = solo.wait_ready()
            rr = client(solo).get(last)
            if [kv.value for kv in rr.kvs] != [want[last]]:
                raise AssertionError(
                    f"boot: the restored member read {rr.kvs}")
            stage("snapshot_restore")
            # etcd's outer client surfaces: the port's etcdctl and
            # grpc-proxy, each a process of its own; make-mirror into the
            # solo member. The members' launch lines (SIGHUP) before and
            # after count the stage's node rounds and launches.
            before = {p.name: p.launches_now() for p in c.procs}
            ctl_out = run_ctl_stage(c.procs, solo, tmp, mirror_keys)
            after = {p.name: p.launches_now() for p in c.procs}
            ctl_path = sum_launch_lines([
                launch_delta(before[p.name], after[p.name])
                for p in c.procs])
            stage("ctl")
            # ROADMAP C17: linearizable reads at every member, with no
            # member slowed, with a follower and with the leader stopped
            # 0.3 s of every 0.6 s.
            lead = c.leader()
            slow = next(p for p in c.procs if p is not lead)
            c17 = {"none": slowed_reads(c.procs, None, c17_seconds),
                   f"follower {slow.name}": slowed_reads(
                       c.procs, slow, c17_seconds),
                   f"leader {lead.name}": slowed_reads(
                       c.procs, lead, c17_seconds)}
            c17_roles = {p.name: "leader" if p is lead else "follower"
                         for p in c.procs}
            stage("c17_reads")
            # kill -9 of the leader, the gateway's first endpoint: etcdctl
            # through the gateway reaches it, then another member; reads
            # at the survivors; its restart.
            lead = c.leader()
            t_gw = time.perf_counter()
            step_gateway(c.procs, lead, ctl_out, stop=lead.kill9)
            ctl_out["step_s"]["gateway"] = time.perf_counter() - t_gw
            t_kill = time.perf_counter()
            for p in c.procs:
                if p is not lead:
                    rr = client(p).get(last)
                    if [kv.value for kv in rr.kvs] != [want[last]]:
                        raise AssertionError(f"boot: survivor {p.name} read "
                                             f"{rr.kvs}")
            survivors_s = time.perf_counter() - t_kill
            t_restart = time.perf_counter()
            lead.start()
            restart_s = lead.wait_ready()
            new_lead = c.leader()
            client(new_lead).put(b"after-restart", b"x")
            rr = client(lead).get(b"after-restart")  # linearizable, at it
            if [kv.value for kv in rr.kvs] != [b"x"]:
                raise AssertionError(
                    f"boot: the restarted member read {rr.kvs}")
            catch_up_s = time.perf_counter() - t_restart
            stage("kill9_restart")
            print("ctl stage seconds: " + json.dumps(
                {**ctl_out["step_s"],
                 **{k: ctl_out[k] for k in ("gateway_put_s",
                                            "gateway_get_s")}}),
                  flush=True)
        finally:
            for cl in conns:
                cl.close()
            lines = c.close()
            if solo is not None:
                solo.stop()
                lines += solo.launch_lines()
            logs = {p.name: p.log_tail(1500) for p in c.procs}
        # The operator tools on a stopped member: dump_db and dump_logs
        # read its data dir, the last checked put among what they show.
        t_dump = time.perf_counter()
        dumps = dump_stopped_member(c.procs[0].data_dir, last, want[last])
        stages["dump_db_logs"] = time.perf_counter() - t_dump
        # Each member's last process and the solo member (the killed
        # leader's first process writes none).
        if len(lines) != len(c.procs) + 1:
            raise AssertionError(f"boot: {len(lines)} launch lines: {logs}")
        path = sum_launch_lines(lines)
        for ln in lines:
            if ln["rounds"] == 0 or (cuda and 0 in ln["launches"].values()):
                raise AssertionError(f"boot: member {ln['member']} "
                                     f"launched {ln}")
        per_round = {k: v / path["rounds"] for k, v in path["forms"].items()}
        vs_server = None
        if server_path is not None:
            vs_server = {form: {"boot": per_round.get(form, 0.0),
                                "server": server_path["forms"].get(form, 0)
                                / server_path["rounds"]}
                         for form in sorted(set(per_round)
                                            | set(server_path["forms"]))}
        log("boot", members=len(c.procs), clients=BOOT_CLIENTS,
            config="etcd's defaults: snapshot_count 100,000 (W = 32,768), "
            "heartbeat 100 ms, election 1,000 ms, raft backend tpu; the "
            f"benchmark tool: {SERVER_KEY_BYTES}-byte sequential keys, "
            f"{SERVER_VALUE_BYTES}-byte values",
            boot_s=boot_s, puts=puts, puts_per_s=put["per_s"],
            put_ms={k: put[k] for k in ("p50_ms", "p90_ms", "p99_ms",
                                        "p99.9_ms")},
            put_tool_s=put["process_s"], ranges_per_run=ranges,
            ranges=range_stats, checked_puts=checked,
            checked_puts_per_s=checked / checked_s,
            keys_read_back_per_member=len(want) + len(tool_keys),
            hash_kv_revision=rev, leader=lead.name,
            survivors_read_s=survivors_s, restart_s=restart_s,
            catch_up_s=catch_up_s, restored_boot_s=solo_s,
            launch_lines=lines, launches=path["launches"],
            launches_leave_out="the killed leader's first process (kill -9 "
            "writes no launch line)",
            ctl=ctl_out, ctl_node_rounds=ctl_path["rounds"],
            ctl_launches=ctl_path["launches"],
            ctl_launches_per_node_round={
                k: v / max(1, ctl_path["rounds"])
                for k, v in ctl_path["launches"].items()},
            ctl_form_launches_per_node_round={
                k: v / max(1, ctl_path["rounds"])
                for k, v in ctl_path["forms"].items()},
            c17_reads=c17, c17_roles=c17_roles,
            dump_metrics=metrics, dumps=dumps,
            node_rounds=path["rounds"],
            launches_per_node_round={k: v / path["rounds"]
                                     for k, v in path["launches"].items()},
            form_launches_per_node_round=per_round,
            forms_per_node_round_vs_server=vs_server,
            stage_s=stages, wall_s=time.perf_counter() - t0,
            card=smi("name,power.limit") if cuda else str(dev))
        return path
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- phase: sweep (BASELINE #2-#5, the frontier, the batch, the phases) --------

# Cuts of the tools' own depth for chip_smoke's time (each keeps every
# schedule feature; the groups are the tools' accelerator sizes): the
# frontier's calls a point 8 -> 2 and the batch's calls 8 -> 4.
SWEEP_FRONTIER_CALLS = 1
SWEEP_BATCH_CALLS = 2
ROUNDTRACE_ROUNDS = 64  # rounds of the round tracer's stretch
# The largest median distance (us) allowed between a traced round's end
# mark, on the host's clock, and a CUDA event recorded right after it.
ROUNDTRACE_EVENT_US = 50


def run_roundtrace(dev, groups: int, rounds: int = ROUNDTRACE_ROUNDS) -> dict:
    """The round tracer (batched/roundtrace.py) over the bench engine at
    `groups` groups, 2 proposals a leader a round, beside an untraced
    twin: both graph variants captured in set-up, then a stretch of
    `rounds` traced rounds held to zero new captures, a CUDA event
    recorded after each traced call. Raises unless the twin's state
    equals the traced engine's, every round of the stretch was kept and
    every one of its marks written, the marks rise within each round,
    the rounds' start marks rise strictly, and (on CUDA) the end marks
    on the host's clock lie within ROUNDTRACE_EVENT_US of the events
    (median). Returns the stretch's summary."""
    from etcd_tpu_torch.analysis.sentinels import CompileBudget
    from etcd_tpu_torch.batched import MultiRaftEngine
    from etcd_tpu_torch.tools.benchlib import bench_config

    cfg = bench_config(groups)
    plain, eng = (MultiRaftEngine(cfg, device=dev, round_trace=t)
                  for t in (False, True))
    props = torch.zeros((cfg.num_instances,), dtype=torch.int32, device=dev)
    props[::R] = 2
    for e in (plain, eng):
        e.campaign(range(0, cfg.num_instances, R))
        e.run_rounds(4, tick=False)
        if not (e.leaders() == 0).all():
            raise AssertionError("roundtrace: the election failed")
        e.run_rounds(2, tick=True, propose_n=props)
        e.run_rounds(2, tick=False, propose_n=props)
    budget = CompileBudget(0).track("roundtrace", eng)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        anchor = torch.cuda.Event(enable_timing=True)
        anchor.record()
        anchor_ns = time.perf_counter_ns()
    events = []
    rt = eng.round_trace
    rt.start()
    for _ in range(rounds):
        eng.run_rounds(1, tick=False, propose_n=props)
        if cuda:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        plain.run_rounds(1, tick=False, propose_n=props)
    rt.stop()
    assert_engines_equal(plain, eng, "roundtrace: traced against untraced")
    stretch = rt.collect()
    marks = stretch.marks
    if stretch.rounds.size != rounds or stretch.rounds_dropped:
        raise AssertionError(f"roundtrace: {stretch.rounds.size} rounds "
                             f"kept of {rounds}")
    if not (marks > 0).all():
        raise AssertionError("roundtrace: a mark of the stretch is unwritten")
    if not (np.diff(marks, axis=1) >= 0).all():
        raise AssertionError("roundtrace: a mark precedes the one before it")
    if not (np.diff(marks[:, 0]) > 0).all():
        raise AssertionError("roundtrace: the rounds' start marks do not rise")
    summary = stretch.summary()
    if cuda:
        host = np.array([anchor_ns + anchor.elapsed_time(e) * 1e6
                         for e in events])
        diff_us = (host - stretch.host_marks()[:, -1]) / 1e3
        median = float(np.median(diff_us))
        summary["event_minus_end_mark_us"] = {
            "median": median, "min": float(diff_us.min()),
            "max": float(diff_us.max())}
        if abs(median) >= ROUNDTRACE_EVENT_US:
            raise AssertionError(
                f"roundtrace: end marks lie {median:.1f} us from the CUDA "
                f"events after the rounds (median)")
    summary["captures_after_warmup"] = budget.check()
    summary["captures"] = eng.captures
    return summary


def time_round_forms(eng, props) -> dict:
    """Every kernel form of one eager round of `eng`, on the inputs the
    round gives it: held equal to its plain version, then its time a
    call and its plain version's, back to back on the stream between
    two CUDA events (kernel_times.stream_ms: the device's time where the
    card is the slower, the host's launch time where it is not; the
    profiler's records have been seen to come back short late in a long
    run), and its bound on those inputs (kernel_times.form_cost)."""
    from etcd_tpu_torch.batched import hopper_kernels as hk
    from etcd_tpu_torch.tools.kernel_times import bound_ms, form_cost, stream_ms

    plain = {hk.quorum_commit: hk.quorum_commit_ref,
             hk.quorum_vote: hk.quorum_vote_ref,
             hk.term_at_batch: hk.term_at_batch_ref}
    out = {}
    forms = round_forms(engine_round(eng, props))
    for form, (fn, args) in sorted(forms.items()):
        err = assert_equal(f"sweep G={eng.cfg.num_groups} {form}",
                           fn(*args), plain[fn](*args))
        b_ms, b_by = bound_ms(*form_cost(form, args))
        out[form] = {"max_abs_err": err,
                     "call_ms": stream_ms(lambda: fn(*args)),
                     "plain_call_ms": stream_ms(lambda: plain[fn](*args),
                                                iters=5),
                     "bound_ms": b_ms, "bound_by": b_by}
    return out


def run_sweep(dev, scratch: str) -> dict:
    """The engine's sweep tools on the card, at the sizes they run there:
    bench_sweep's BASELINE configs #2-#5 (1,024 groups; 10,240 at R = 5;
    102,400 under timer elections; 1,048,576 with half the groups joint
    and a ReadIndex batch on every leader each block), each with its
    launches per form counted from 0 around its own run and every form
    of one more eager round held against its plain version on that
    round's inputs, those of #3 (R = 5) and #5 (G = 1,048,576) timed a
    call too; frontier_sweep with its pipeline gate and its cold/warm
    start probe; gpu_batch's sections (a)-(e); the round tracer's
    segment table (run_roundtrace).
    Everything runs under ETCD_TPU_TRANSFER_GUARD=disallow (the warm
    replays and eager rounds under the sync guard) and every measured
    loop is held to zero new captures after its warm-up: the closing
    line sums what their budgets counted. Returns path -> launches."""
    from etcd_tpu_torch.analysis import sentinels
    from etcd_tpu_torch.batched import hopper_kernels as hk
    from etcd_tpu_torch.batched import roundtrace
    from etcd_tpu_torch.tools import bench_sweep, frontier_sweep, gpu_batch

    cuda = dev.type == "cuda"
    paths = {}
    after_warmup = {}  # tool -> captures its measured loops' budgets counted
    old_guard = os.environ.get("ETCD_TPU_TRANSFER_GUARD")
    os.environ["ETCD_TPU_TRANSFER_GUARD"] = "disallow"
    try:
        for c, sweep in sorted(bench_sweep.CONFIGS.items()):
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
            hk.reset_launches()
            t0 = time.perf_counter()
            rec, eng = bench_sweep.run_config(c, sweep.groups, sweep.rounds,
                                              sweep.calls, device=dev)
            after_warmup[f"bench_sweep #{c}"] = rec["captures_after_warmup"]
            path = paths[f"sweep_{c}"] = {"launches": dict(hk.LAUNCHES),
                                          "forms": dict(hk.FORM_LAUNCHES),
                                          "rounds": eng.rounds}
            for name, count in hk.LAUNCHES.items():
                if count == 0:
                    raise AssertionError(f"sweep #{c}: {name} never launched")
            # One more eager round, its forms held to their plain
            # versions (#4 proposes nothing: its leaders come and go).
            props = torch.zeros(eng.cfg.num_instances, dtype=torch.int32,
                                device=dev)
            if c != 4:
                props[::sweep.replicas] = 2
            if c in (3, 5):
                forms = path["timed"] = time_round_forms(eng, props)
            else:
                forms = {form: {"max_abs_err": err} for form, err in
                         round_forms_equal_plain(eng, props).items()}
            log("sweep", tool="bench_sweep", **rec,
                seconds=time.perf_counter() - t0,
                launches=path["launches"],
                form_launches_per_round={
                    k: v / eng.rounds for k, v in path["forms"].items()},
                forms_on_round_inputs=forms)
            del eng
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        front = frontier_sweep.sweep(
            os.path.join(scratch, "frontier.json"), dev,
            groups=None if cuda else [64, 128],
            calls=SWEEP_FRONTIER_CALLS)
        after_warmup["frontier_sweep"] = sum(
            p["captures_after_warmup"] for p in front["points"])
        log("sweep", tool="frontier_sweep", gate="pipelined == serial",
            points=front["points"], warm_start=front["warm_start"],
            seconds=time.perf_counter() - t0)
        t0 = time.perf_counter()
        batch = gpu_batch.run(os.path.join(scratch, "batch"),
                              MAIN_GROUPS if cuda else 64, device=dev,
                              calls=SWEEP_BATCH_CALLS)
        after_warmup["gpu_batch"] = sum(
            v["captures_after_warmup"] for k, v in batch.items()
            if k == "a_headline" or k.startswith("b_deliver_"))
        log("sweep", tool="gpu_batch", seconds=time.perf_counter() - t0,
            **{k: v for k, v in batch.items() if k != "e_profile"},
            e_profile={k: v for k, v in batch["e_profile"].items()
                       if k != "trace"})
        t0 = time.perf_counter()
        trace = run_roundtrace(dev, MAIN_GROUPS if cuda else 64)
        after_warmup["roundtrace"] = trace["captures_after_warmup"]
        print(roundtrace.table(trace), flush=True)
        log("sweep", tool="roundtrace", seconds=time.perf_counter() - t0,
            **trace)
    finally:
        if old_guard is None:
            os.environ.pop("ETCD_TPU_TRANSFER_GUARD", None)
        else:
            os.environ["ETCD_TPU_TRANSFER_GUARD"] = old_guard
    log("sweep", sync_guard="disallow: no sync reported",
        captures_after_warmup=after_warmup,
        captures_after_warmup_total=sum(after_warmup.values()),
        distinct_round_step=sentinels.distinct_shapes("round_step"),
        distinct_round_capture=sentinels.distinct_shapes("round_capture"))
    return paths


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this test needs a GPU",
              file=sys.stderr)
        return 2
    from etcd_tpu_torch import native
    from etcd_tpu_torch.analysis import sentinels
    from etcd_tpu_torch.batched import hopper_kernels as hk
    from etcd_tpu_torch.batched.compile_cache import enable_compile_cache

    dev = torch.device("cuda", 0)
    # The native builds' directory, chosen before either build
    # (ETCD_TPU_COMPILE_CACHE; unset: the git-ignored _build directories).
    cache_dir = enable_compile_cache()
    card = smi("name,power.limit")
    t0 = time.perf_counter()
    # The two builds of the checkout's sources run side by side: nvcc for
    # the Hopper kernels, g++ for the WAL's record log.
    walog = {}
    gxx = threading.Thread(target=lambda: walog.update(
        path=native.build("walog"), s=time.perf_counter() - t0))
    gxx.start()
    hk.load_library()
    build_s = time.perf_counter() - t0
    gxx.join()
    if "path" not in walog:
        raise RuntimeError("the walog library did not build")
    log("env", card=card, torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0), build_s=build_s,
        library=hk.library_path().name, build_dir=cache_dir,
        walog_build_s=walog["s"],
        walog_library=os.path.basename(walog["path"]))

    phase_s = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t
        return out

    variants, err = timed("kernels", check_kernels, dev)
    launches, forms, eng, props = timed("slice", run_slice, dev)
    paths = {"slice": {"launches": launches, "forms": forms,
                       "rounds": eng.rounds}}
    base_device_ms = timed("profile", run_profile, eng, props)
    del eng, props
    timed("graph", run_graph, dev)
    timed("planes", run_planes, dev, base_device_ms)
    timed("parity", run_parity, dev)
    paths.update(timed("shapes", run_shapes, dev))
    timed("shadow", run_shadow, dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sweep_") as scratch:
        paths.update(timed("sweep", run_sweep, dev, scratch))
    gc.collect()
    torch.cuda.empty_cache()
    paths["hosted"] = timed("hosted", run_hosted, dev)
    timed("hosted_parity", run_hosted_parity, dev)
    paths["plane"] = timed("plane", run_plane, dev)
    timed("plane_parity", run_plane_parity, dev)
    paths["node"] = timed("node", run_node, dev)
    timed("node_parity", run_node_parity, dev)
    paths["interaction"] = timed("interaction", run_interaction, dev)
    paths["raftexample"] = {"launches": timed("raftexample",
                                              run_raftexample, dev)}
    paths["hosting"] = timed("hosting", run_hosting, dev)
    timed("hosting_parity", run_hosting_parity, dev)
    paths["mesh"] = timed("mesh", run_mesh, dev)
    timed("chaos", run_chaos, dev)
    timed("chaos_shapes", run_chaos_shapes, dev)
    paths["hosting_proc"] = timed("hosting_proc", run_hosting_proc, dev)
    timed("rebalance", run_rebalance, dev)
    paths["server"] = timed("server", run_server, dev)
    timed("server_parity", run_server_parity, dev)
    paths["boot"] = timed("boot", run_boot, dev, BOOT_PUTS, BOOT_RANGES,
                          BOOT_CHECKED, paths["server"])
    log("phases", seconds=phase_s, total_s=sum(phase_s.values()),
        distinct_round_step=sentinels.distinct_shapes("round_step"),
        distinct_round_capture=sentinels.distinct_shapes("round_capture"))
    print(json.dumps({"kernels": kernel_rows(variants, err, paths)}))
    print(smi("name,power.limit"))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
