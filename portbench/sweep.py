"""Find an open cell's knee: the open loop at a list of offered rates,
one short window each, in one process on one GPU.

    python3 portbench/sweep.py --workload r3-100k.open \\
        --rates 8e6,12e6,16e6 --seconds 10 --seed 5

For each rate it prints one JSON line: the rate, the committed rate,
commit p50 and p99, failed proposals, the rounds' mean time, and the
backlog (arrivals handed over but not committed) at the window's middle
and end. The knee is the highest rate whose backlog does not grow
between the two; a cell offers 4/5 of it (cells/<cell>.json).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench.run import point_caches

    point_caches(ROOT)
    import torch

    from portbench import spec
    from portbench.bench import run_cell

    if not torch.cuda.is_available():
        print("sweep: needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload, ROOT)
    for rate in (float(r) for r in args.rates.split(",")):
        stats: dict = {}
        out = run_cell(cell, args.seed, args.seconds, False,
                       torch.device("cuda", 0), time.perf_counter(),
                       traffic_params={"rate_per_s": rate}, stats=stats)
        m = {k: v["value"] for k, v in out["metrics"].items()}
        print(json.dumps({"rate_per_s": rate, **m, "failed": out["failed"],
                          "attempted": out["attempted"],
                          "correct": out["correct"], **stats}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
