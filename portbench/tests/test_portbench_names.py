"""BENCHMARK.json and the files it names keep to the benchmark's
contract: names, units, keys, sizes, and one file per config, mix and
per-layer metric."""

import json
import re

from portbench import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text, limit=200):
    return (isinstance(text, str) and 1 <= len(text) <= limit
            and "\n" not in text and "\t" not in text)


def test_top_level_keys_and_size():
    assert set(BENCH) == TOP
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p


def test_every_name_and_unit():
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
             + [w["config"] for w in BENCH["workloads"]]
             + [w["traffic"] for w in BENCH["workloads"]]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), names
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert all(UNIT.match(m["unit"]) for m in metrics)
    for group in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[group]}) == len(BENCH[group])
    assert len({m["name"] for m in metrics}) == len(metrics)


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("portbench/") and c["file"] not in files
        files.add(c["file"])
        with open(spec.ROOT / c["file"]) as f:
            body = json.load(f)
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert body["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert body["tick_s"] > 0


def test_engine_fields_are_the_ports():
    from etcd_tpu_torch.batched import BatchedConfig

    for c in BENCH["configs"]:
        with open(spec.ROOT / c["file"]) as f:
            fields = json.load(f)["engine"]
        BatchedConfig(**fields).validate()


def test_workloads():
    ws = BENCH["workloads"]
    assert 1 <= len(ws) <= 24
    pairs = {(w["config"], w["traffic"]) for w in ws}
    assert len(pairs) == len(ws)
    four = sum(w["chips"] == 4 for w in ws)
    assert four <= max(1, len(ws) // 4)
    for w in ws:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (spec.HERE / "traffic" / f"{w['traffic']}.json").exists()
        cell = spec.load_cell(w["name"])
        if "rate_per_s" in cell.traffic:
            assert cell.traffic["rate_per_s"] > 0


def test_metrics():
    e2e = BENCH["end_to_end"]
    assert 1 <= len(e2e) <= 16 and "setup_s" in {m["name"] for m in e2e}
    for m in e2e:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and m["better"] in ("lower",
                                                               "higher")
    pl = BENCH["per_layer"]
    assert 1 <= len(pl) <= 128
    for m in pl:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SOURCES and _line(m["layer"])
        assert spec.reader_path(m["name"]).exists()
        for w in m.get("workloads", [x["name"] for x in BENCH["workloads"]]):
            cell = spec.load_cell(w)
            assert m["moves"] in {x["name"] for x in cell.end_to_end}
            assert m["name"] in {x["name"] for x in cell.per_layer}
    for w in BENCH["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.per_layer and len(cell.end_to_end) >= 2


def test_the_full_check_fits_its_time():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200, total
