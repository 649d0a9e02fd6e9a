"""What one cell is, read from BENCHMARK.json and the data files it
names.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric lives in a file of its own, found by name:

* ``configs/<config>.json``: the engine's fields (``engine``), the tick
  period (``tick_s``), its source, guarantees, ``assumed`` and
  ``reduced``;
* ``traffic/<traffic>.json``: the mix's parameters and the name of the
  generator that reads them (``generators/<generator>.py``, traffic.py);
* ``cells/<workload>.json`` (optional): the cell's own traffic
  parameters over the mix's, such as an open loop's offered rate;
* ``metrics/<metric>.py``: the reader of one per-layer metric, a
  function ``read(ctx)`` that returns a number or None. A metric split
  by the end-to-end metric it moves (``<quantity>.<part>``, such as
  ``round_device_ms.closed``) is read by ``metrics/<quantity>.py`` where
  it has no file of its own.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    config: dict  # the config file, as run
    traffic: dict  # the mix's parameters, with the cell's own over them
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]  # the per-layer metrics this cell reports


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of BENCHMARK.json with its files."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have: {', '.join(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(root / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    own = HERE / "cells" / f"{name}.json"
    if own.exists():
        with open(own) as f:
            traffic.update(json.load(f))
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, name) and m["moves"] in reported]
    return Cell(name, config, traffic, e2e, per_layer)


def reader_path(metric: str) -> Path:
    """metrics/<metric>.py, or else metrics/<quantity>.py for a metric
    named <quantity>.<part>."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{metric.split('.')[0]}.py"
    return path


def reader(metric: str) -> Callable:
    """The `read` function of the metric's reader (reader_path)."""
    path = reader_path(metric)
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_per_layer(cell: Cell, ctx) -> Dict[str, dict]:
    """Each per-layer metric of the cell whose reader found something."""
    out = {}
    for m in cell.per_layer:
        value = reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
