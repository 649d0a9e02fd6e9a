"""Latency/throughput frontier sweep over group count G, on the PyTorch
engine.

Ports ``etcd_tpu/tools/frontier_sweep.py``. For each G it measures
steady-state group-rounds/s through the pipelined round loop
(``MultiRaftEngine.run_rounds_pipelined``: chunks of graph replays, at
most two in flight, each fenced by a CUDA event) and the commit p50 —
wall-clock from a quiet-point proposal to quorum commit across every
group — with the bench methodology (``benchlib.measure_rate``,
``measure_commit_p50``).

Before measuring, the pipelined loop is gated against single-round
stepping on a small config (G=64, 48 rounds): term, role, lead, commit
and last must be equal, or the sweep aborts and records nothing.

Last, the warm-start probe builds the first point's engine twice, each
time in a fresh process pointed at one fresh build directory
(``batched/compile_cache.py``): the first process builds the native
libraries (nvcc for the Hopper kernels) and captures its graphs (cold),
the second loads them and only captures (warm).

Writes ``--out`` (JSON):

    {"device", "captured_at", "loop", "points": [{"groups", "deliver",
     "rate_group_rounds_per_s", "commit_p50_ms", "commit_p50_rounds",
     "build_s"}, ...],
     "warm_start": {"groups", "cold_build_s", "warm_build_s",
                    "warm_built_nothing"}}

and prints a markdown table.

    python3 -m etcd_tpu_torch.tools.frontier_sweep --out F [--groups ...]
        [--device cpu]

It runs on the GPU unless called with ``--device cpu``; without CUDA
and with no device named it exits with an error and writes nothing. The
JAX tool's ``--append-notes`` (a table appended to BENCH_NOTES.md, the
TPU-era record) is not ported, and a point or probe that fails fails
the sweep: the JAX tool's partial frontier is not kept.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

from ..analysis.sentinels import CompileBudget
from ..batched.state import DELIVER_SHAPES, default_deliver_shape, \
    resolve_device
from .bench import device_label

# The accelerator sweep (the JAX tool's); 131072 probes past the
# headline G for the throughput knee. CPU defaults stay small.
GPU_GROUPS = [1024, 4096, 16384, 65536, 131072]
CPU_GROUPS = [256, 512, 1024, 4096]
GATE_GROUPS, GATE_ROUNDS, GATE_CHUNK = 64, 48, 8
GATE_FIELDS = ("term", "role", "lead", "commit", "last")
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _log(msg: str) -> None:
    print(f"[frontier {time.strftime('%H:%M:%S')}] {msg}",
          file=sys.stderr, flush=True)


def _make_engine(groups: int, shape: str, device, telemetry: bool = False):
    # The bench config and setup, from the shared module so the sweep
    # cannot desynchronize from the bench.
    from .benchlib import make_bench_engine

    return make_bench_engine(groups, telemetry=telemetry, device=device,
                             deliver_shape=shape)


def pipeline_gate(shape: str, device) -> None:
    """Refuse to measure a pipelined loop that diverges from
    single-round stepping."""
    a, props = _make_engine(GATE_GROUPS, shape, device)
    b, _ = _make_engine(GATE_GROUPS, shape, device)
    a.run_rounds_pipelined(GATE_ROUNDS, chunk=GATE_CHUNK, tick=True,
                           propose_n=props)
    for _ in range(GATE_ROUNDS):
        b.step_round(tick=True, propose_n=props)
    for f in GATE_FIELDS:
        if not torch.equal(getattr(a.state, f), getattr(b.state, f)):
            raise AssertionError(
                f"pipelined loop diverged from single-round stepping on "
                f"{f}; refusing to record frontier numbers")
    _log(f"pipeline gate[{shape}]: pipelined == single-round stepping "
         f"over {GATE_ROUNDS} rounds at G={GATE_GROUPS}")


def measure_point(groups: int, shape: str, rounds_per_call: int,
                  calls: int, device, telemetry: bool = False) -> dict:
    from .benchlib import measure_commit_p50, measure_rate

    t0 = time.perf_counter()
    eng, props = _make_engine(groups, shape, device, telemetry)
    build_s = time.perf_counter() - t0
    _log(f"G={groups}: built and elected in {build_s:.1f}s")
    budget = CompileBudget(0)
    rate = measure_rate(eng, props, rounds_per_call, calls, pipelined=True,
                        budget=budget)
    if eng.commits().min() <= 0:
        raise AssertionError(f"G={groups}: a group committed nothing")
    _log(f"G={groups}: {rate:,.0f} group-rounds/s")
    p50_ms, rounds = measure_commit_p50(eng)
    _log(f"G={groups}: commit p50 {p50_ms:.2f}ms over {rounds} rounds")
    out = {"groups": groups, "deliver": eng.cfg.deliver_shape,
           "rate_group_rounds_per_s": rate, "commit_p50_ms": p50_ms,
           "commit_p50_rounds": rounds, "build_s": build_s,
           "captures": eng.captures,
           "captures_after_warmup": budget.misses()}
    del eng, props
    gc.collect()
    return out


def _warm_probe(groups: int, shape: str, device) -> None:
    """Subprocess mode: enable the build directory the environment names,
    build one engine (its setup's rounds load the kernels and capture a
    graph) and print the seconds and what the directory held before."""
    from ..batched import hopper_kernels as hk
    from ..batched.compile_cache import enable_compile_cache

    t0 = time.perf_counter()
    cache = enable_compile_cache()
    found = os.path.exists(hk.library_path())
    eng, _ = _make_engine(groups, shape, device)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "cache": cache, "library_found": found,
                      "captures": eng.captures}))


def run_warm_probe(groups: int, shape: str, device) -> dict:
    """The first point's engine built in two fresh processes sharing one
    fresh build directory: cold, then warm."""
    cache = tempfile.mkdtemp(prefix="frontier_cache_")
    env = dict(os.environ, ETCD_TPU_COMPILE_CACHE=cache)
    cmd = [sys.executable, "-m", "etcd_tpu_torch.tools.frontier_sweep",
           "--warm-probe", str(groups), "--deliver-shape", shape,
           "--device", str(device)]
    runs = []
    try:
        for _ in range(2):
            out = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=1800, env=env, cwd=ROOT,
                                 check=False)
            if out.returncode != 0:
                raise RuntimeError(
                    f"warm probe failed (rc={out.returncode}):\n"
                    f"{out.stderr[-4000:]}")
            runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    cold, warm = runs
    on_card = torch.device(device).type == "cuda"
    if on_card and (cold["library_found"] or not warm["library_found"]):
        raise AssertionError(f"warm probe: the first process should build "
                             f"the kernel library and the second find it "
                             f"({cold}, {warm})")
    return {"groups": groups, "cold_build_s": cold["build_s"],
            "warm_build_s": warm["build_s"],
            # On the card: the second process found the first one's
            # library and built nothing (on the CPU no library is built).
            "warm_built_nothing": True if on_card else None}


def markdown(result: dict) -> str:
    lines = [
        "| G | deliver | group-rounds/s | commit p50 (ms) | rounds "
        "| build (s) |",
        "|---|---|---|---|---|---|",
    ]
    for p in result["points"]:
        lines.append(
            "| {groups} | {deliver} | {rate_group_rounds_per_s:,.0f} | "
            "{commit_p50_ms:.3f} | {commit_p50_rounds} | {build_s:.2f} |"
            .format(**p))
    ws = result.get("warm_start")
    if ws:
        lines.append(
            f"\nWarm start (one build directory, fresh processes, "
            f"G={ws['groups']}): {ws['warm_build_s']:.2f}s warm vs "
            f"{ws['cold_build_s']:.2f}s cold.")
    return "\n".join(lines)


def sweep(out: str, device, groups=None, shapes=None,
          rounds_per_call: int = 16, calls: int = 8,
          telemetry: bool = False, gate: bool = True,
          warm_check: bool = True) -> dict:
    """The gate, every (G, shape) point and the warm-start probe; writes
    `out` after each step and returns the result."""
    dev = resolve_device(device)
    shapes = shapes or [default_deliver_shape()]
    groups = groups or (GPU_GROUPS if dev.type == "cuda" else CPU_GROUPS)
    _log(f"device={device_label(dev)} sweep G={groups} "
         f"deliver={','.join(shapes)}")
    if gate:
        for s in shapes:
            pipeline_gate(s, dev)
    result: dict = {
        "device": device_label(dev),
        "loop": (f"pipelined (run_rounds_pipelined chunk="
                 f"{rounds_per_call} depth=2)"),
        "deliver": shapes, "telemetry": bool(telemetry),
        "captured_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "captured_by": "etcd_tpu_torch/tools/frontier_sweep.py",
        "points": [],
    }
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)

    def flush() -> None:
        with open(out, "w") as f:
            json.dump(result, f, indent=2)
            f.write("\n")

    for g in groups:
        for s in shapes:
            # jitlint: waive(sync-in-loop) -- one engine a point, built and measured on its own: its fences are the measurement
            result["points"].append(measure_point(
                g, s, rounds_per_call, calls, dev, telemetry))
            flush()
    if warm_check:
        p0 = result["points"][0]
        result["warm_start"] = run_warm_probe(p0["groups"], p0["deliver"],
                                              dev)
        ws = result["warm_start"]
        _log(f"warm start: {ws['warm_build_s']:.2f}s vs "
             f"{ws['cold_build_s']:.2f}s cold")
        flush()
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python3 -m etcd_tpu_torch.tools.frontier_sweep")
    ap.add_argument("--groups", default="",
                    help="comma-separated G list (default per device)")
    ap.add_argument("--out", default="",
                    help="the JSON file to write (required for a sweep)")
    ap.add_argument("--rounds-per-call", type=int, default=16)
    ap.add_argument("--calls", type=int, default=8)
    ap.add_argument("--deliver-shape", default="",
                    help="comma-separated deliver shapes to sweep "
                         "(lanes|merged|vectorized; default: the package "
                         "default)")
    ap.add_argument("--telemetry", action="store_true",
                    help="add the telemetry plane to the measured round")
    ap.add_argument("--skip-gate", action="store_true")
    ap.add_argument("--skip-warm-check", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--warm-probe", type=int, default=0,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"frontier_sweep: {e}") from None
    shapes = [s.strip() for s in args.deliver_shape.split(",") if s.strip()]
    for s in shapes:
        if s not in DELIVER_SHAPES:
            raise SystemExit(f"unknown deliver shape {s!r} (choose from "
                             f"{DELIVER_SHAPES})")
    if args.warm_probe:
        _warm_probe(args.warm_probe, shapes[0] if shapes else "auto", dev)
        return
    if not args.out:
        ap.error("--out is required")
    groups = [int(g) for g in args.groups.split(",")] if args.groups else None
    result = sweep(args.out, dev, groups, shapes, args.rounds_per_call,
                   args.calls, args.telemetry, not args.skip_gate,
                   not args.skip_warm_check)
    print(markdown(result))


if __name__ == "__main__":
    main()
