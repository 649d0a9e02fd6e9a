"""Tiny runs of the benchmark's cells on the CPU, for the tests."""

import time

import torch

from portbench import spec
from portbench.bench import run_cell

GROUPS = 6


def run_tiny(workload: str, seed: int = 20261018, seconds: float = 0.6,
             trace: bool = False, groups: int = GROUPS, **kw) -> dict:
    """One run of `workload` on the CPU at `groups` groups; an open
    cell offers about 40 entries a second a group."""
    torch.set_num_threads(2)
    cell = spec.load_cell(workload)
    params = ({"rate_per_s": 40.0 * groups}
              if "rate_per_s" in cell.traffic else None)
    return run_cell(cell, seed, seconds, trace, "cpu", time.perf_counter(),
                    engine_fields={"num_groups": groups},
                    traffic_params=params, **kw)
