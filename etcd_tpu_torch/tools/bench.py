"""Benchmark: Raft groups stepped per second, PyTorch engine on one GPU.

The twin of the repository's bench.py: the canonical bench engine
(benchlib.make_bench_engine: R=3, W=32, E=4, every group leader-elected,
2 proposals per group per round) runs closed-loop, and the rate is
group-rounds per wall-second; commit p50 is the propose-to-commit
wall-clock at a quiet point.

    python3 -m etcd_tpu_torch.tools.bench

It runs on the GPU at G=65,536 groups, 8 calls of 16 rounds each, as
the JAX bench runs its accelerator cell. Like the JAX bench it reads
three variables, each 0 (the default) or 1: BENCH_PIPELINE=1 times
one run_rounds_pipelined pass (chunk = 16) in place of the serial
calls, BENCH_TELEMETRY=1 and BENCH_FLEET=1 add the telemetry and the
fleet summary planes to the round. BENCH_DELIVER_SHAPE=lanes|merged|
vectorized pins the deliver shape, as in the JAX bench (unset: the
package default, vectorized). The headline is serial with both planes
off.

Prints exactly one JSON line: {"metric", "value", "unit", "vs_baseline"}.
The unit names the device (for a GPU: its name and power limit), G, R,
the deliver shape, the loop and the planes, the commit p50 and the
Hopper kernels' launches.
"""

from __future__ import annotations

import json
import os
import subprocess

import torch

from ..batched import hopper_kernels
from .benchlib import make_bench_engine, measure_commit_p50, measure_rate


def device_label(device: torch.device) -> str:
    """The device as a measurement must name it: a GPU's name and power
    limit as nvidia-smi reports them, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={device.index or 0}"],
        capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip()


GROUPS = 65536
ROUNDS_PER_CALL, CALLS = 16, 8


def env_flag(name: str) -> bool:
    """A 0|1 environment variable of the JAX bench (unset: 0)."""
    value = os.environ.get(name, "")
    if value and value not in ("0", "1"):
        raise SystemExit(f"{name} must be 0|1, got {value!r}")
    return value == "1"


def deliver_shape_env() -> str:
    """BENCH_DELIVER_SHAPE, as the JAX bench reads it (unset: "auto")."""
    if os.environ.get("BENCH_MERGED_DELIVER", ""):
        raise SystemExit(
            "BENCH_MERGED_DELIVER was replaced by "
            "BENCH_DELIVER_SHAPE=lanes|merged|vectorized")
    shape = os.environ.get("BENCH_DELIVER_SHAPE", "")
    if shape and shape not in ("lanes", "merged", "vectorized"):
        raise SystemExit(
            "BENCH_DELIVER_SHAPE must be lanes|merged|vectorized, "
            f"got {shape!r}")
    return shape or "auto"


def result_line(eng, rate: float, p50_ms: float, p50_rounds: int,
                launches: dict, pipelined: bool = False) -> str:
    """The bench's one JSON line for an engine and its measurements."""
    kernels = ", ".join(f"{k}={v}" for k, v in launches.items())
    return json.dumps({
        "metric": "raft_groups_stepped_per_sec",
        "value": rate,
        "unit": (
            f"group-rounds/s ({device_label(eng.device)}, "
            f"G={eng.cfg.num_groups}, R={eng.cfg.num_replicas}, "
            f"deliver={eng.cfg.deliver_shape}, "
            f"loop={'pipelined' if pipelined else 'serial'}, "
            f"telemetry={'on' if eng.cfg.telemetry else 'off'}, "
            f"fleet={'on' if eng.cfg.fleet_summary else 'off'}, "
            f"commit_p50={p50_ms:.2f}ms/{p50_rounds}r, "
            f"hopper kernel launches: {kernels})"),
        "vs_baseline": rate / 1e6,
    })


def main() -> None:
    pipelined = env_flag("BENCH_PIPELINE")
    eng, props = make_bench_engine(GROUPS, env_flag("BENCH_TELEMETRY"),
                                   env_flag("BENCH_FLEET"),
                                   deliver_shape=deliver_shape_env())
    hopper_kernels.reset_launches()
    rate = measure_rate(eng, props, ROUNDS_PER_CALL, CALLS, pipelined)
    launches = dict(hopper_kernels.LAUNCHES)
    if eng.commits().min() <= 0:
        raise RuntimeError("no group committed under load")
    p50_ms, rounds = measure_commit_p50(eng)
    print(result_line(eng, rate, p50_ms, rounds, launches, pipelined))


if __name__ == "__main__":
    main()
