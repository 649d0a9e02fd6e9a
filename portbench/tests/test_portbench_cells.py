"""Every cell runs end to end on the CPU at a tiny size, and the command
line refuses to run without the GPUs a cell asks for."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import spec
from portbench.tests.tiny import run_tiny

ROOT = spec.ROOT
WORKLOADS = [w["name"] for w in spec.load_benchmark()["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_runs_on_cpu(workload):
    out = run_tiny(workload)
    assert list(out) == KEYS  # `checks` last
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    cell = spec.load_cell(workload)
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end:
        got = out["metrics"][m["name"]]
        assert got["unit"] == m["unit"] and got["value"] > 0
    assert out["device"]["platform"] == "cpu"
    assert out["device"]["kind"] == "cpu"
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("workload", [w for w in WORKLOADS
                                      if w.endswith((".closed", ".open"))])
def test_traced_run_reports_only_per_layer_metrics(workload):
    out = run_tiny(workload, trace=True)
    cell = spec.load_cell(workload)
    allowed = {m["name"] for m in cell.per_layer}
    assert set(out["metrics"]) <= allowed
    # The CPU has no device trace: no device metric is read from it.
    device = {m["name"] for m in cell.per_layer
              if m["source"] == "device_trace"}
    assert not set(out["metrics"]) & device
    assert "busy_s" not in out["device"]
    assert out["correct"] is True


def _run_cli(cwd):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", WORKLOADS[0],
         "--seed", str(2**31 + 12345), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_cli_without_gpu_exits_nonzero_and_prints_no_result():
    proc = _run_cli(ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_cli_without_the_program_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run_cli(tmp_path)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_result_line_is_json():
    out = run_tiny(WORKLOADS[0])
    assert json.loads(json.dumps(out)) == out
