"""Run one cell of the benchmark of ``etcd_tpu_torch`` once, on the
GPUs of this machine, and print its result as the last line of standard
output (one JSON object).

    python3 portbench/run.py --workload r3-100k.closed --seed 7 \\
        --seconds 30 --trace 0

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (a profiled stretch of the window). Every run checks
that what the timed path produced is correct (portbench/check.py) and
prints each number compared beside its limit, last on standard error
and last in the result line. Without CUDA, or with fewer GPUs than the
cell asks for, it exits 2 and prints no result.

Builds and kernel caches go to ``.portbench_cache/`` in the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "etcd_tpu")


def point_caches(root: Path) -> None:
    """Every build and kernel cache of the program, at fixed directories
    inside the checkout."""
    cache = root / ".portbench_cache"
    for var, sub in (("ETCD_TPU_COMPILE_CACHE", "build"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    point_caches(ROOT)
    sys.path.insert(0, str(ROOT))
    from portbench import spec

    cell = spec.load_cell(args.workload, ROOT)
    import torch

    chips = next(w["chips"] for w in spec.load_benchmark(ROOT)["workloads"]
                 if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from portbench.bench import run_cell

    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), T_START)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
