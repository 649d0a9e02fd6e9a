"""PyTorch port ↔ JAX reference: the closed-loop engine and the bench
setup, plus the port's import and device contracts.

The port's make_bench_engine (R=3, W=32, E=4, P=2, HB=4, auto_compact)
at G=4 on the CPU against the JAX MultiRaftEngine of the same config —
a config the JAX suite already builds (tests/batched/test_pipelined.py's
G=4 engine), so the compile-shape budget does not move.
"""

import json
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etcd_tpu.batched import BatchedConfig as JBatchedConfig
from etcd_tpu.batched import MultiRaftEngine as JEngine
from etcd_tpu_torch.batched import BatchedConfig, MultiRaftEngine
from etcd_tpu_torch.tools import bench, benchlib

from .test_torch_state import assert_same

G = 4


@pytest.fixture(scope="module")
def engines():
    """The port's bench engine and the JAX engine of the same config,
    driven through the same setup (slot 0 of every group elected)."""
    eng, props = benchlib.make_bench_engine(G, device="cpu")
    jeng = JEngine(JBatchedConfig(**eng.cfg._asdict()))
    jeng.campaign([g * 3 for g in range(G)])
    for _ in range(4):
        jeng.step_round()
    assert_same(jeng.state, eng.state, "after bench setup")
    return eng, props, jeng


def assert_engines_equal(eng, jeng, context):
    assert np.array_equal(eng.leaders(), jeng.leaders()), context
    assert np.array_equal(eng.commits(), jeng.commits()), context
    assert np.array_equal(eng.terms(), jeng.terms()), context


def test_bench_engine_matches_jax_over_sustained_load(engines):
    eng, props, jeng = engines
    jprops = jnp.asarray(props.numpy())
    for rnd in range(72):
        eng.step_round(tick=True, propose_n=props)
        jeng.step_round(tick=True, propose_n=jprops)
        assert_engines_equal(eng, jeng, f"round {rnd}")
    assert_same(jeng.state, eng.state, "after 72 rounds")
    assert_same(jeng.inbox, eng.inbox, "inbox after 72 rounds")
    # The ring (W=32) wrapped several times under auto-compaction.
    assert eng.commits().min() > 4 * eng.cfg.window


def test_engine_control_ops_match_jax(engines):
    """transfer_leader, read_index/read_states, set_membership and
    run_rounds against the JAX engine's."""
    eng, props, jeng = engines
    steps = [
        ("transfer_leader", (0, 2)),
        ("read_index", ([3, 6],)),
        ("set_membership", (2,), dict(voters=(0, 1), learners=(2,))),
        ("set_membership", (3,), dict(voters=(0, 1, 2), voters_out=(0, 1),
                                      joint=True)),
    ]
    for name, args, *kw in steps:
        getattr(eng, name)(*args, **(kw[0] if kw else {}))
        getattr(jeng, name)(*args, **(kw[0] if kw else {}))
        assert_same(jeng.state, eng.state, name)
    for _ in range(8):
        eng.run_rounds(1, tick=True)
        jeng.step_round(tick=True)
        assert_engines_equal(eng, jeng, "after control ops")
    for a, b in zip(eng.read_states(), jeng.read_states()):
        assert np.array_equal(a, b)
    assert_same(jeng.state, eng.state, "after control ops")
    assert eng.leaders()[0] == 2


def test_entry_points_default_to_the_gpu():
    """Without a device argument the engine, the bench setup and
    make_step_round go to CUDA; with no CUDA they raise."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    cfg = benchlib.bench_config(2)
    from etcd_tpu_torch.batched import make_step_round

    for build in (lambda: MultiRaftEngine(cfg),
                  lambda: benchlib.make_bench_engine(2),
                  lambda: make_step_round(cfg)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()


def test_bench_result_is_one_json_line():
    """The bench's JSON line for a small CPU engine and its measurements:
    one line, the metric, and a unit that names the device and shape."""
    eng, props = benchlib.make_bench_engine(8, device="cpu")
    rate = benchlib.measure_rate(eng, props, rounds_per_call=2, calls=1)
    p50_ms, rounds = benchlib.measure_commit_p50(eng)
    line = bench.result_line(eng, rate, p50_ms, rounds,
                             {"quorum_commit_vote": 0, "term_at_batch": 0})
    assert "\n" not in line
    rec = json.loads(line)
    assert rec["metric"] == "raft_groups_stepped_per_sec"
    assert rec["value"] == rate > 0
    assert "(cpu, G=8, R=3, deliver=vectorized" in rec["unit"]
    assert "loop=serial, telemetry=off, fleet=off" in rec["unit"]
    assert "quorum_commit_vote=0, term_at_batch=0" in rec["unit"]


def test_bench_reads_the_jax_bench_variables(monkeypatch):
    """BENCH_PIPELINE, BENCH_TELEMETRY and BENCH_FLEET, 0 or 1 as in
    bench.py, and the unit names the loop and the planes."""
    monkeypatch.setenv("BENCH_TELEMETRY", "1")
    monkeypatch.setenv("BENCH_FLEET", "0")
    monkeypatch.delenv("BENCH_PIPELINE", raising=False)
    assert bench.env_flag("BENCH_TELEMETRY")
    assert not bench.env_flag("BENCH_FLEET")
    assert not bench.env_flag("BENCH_PIPELINE")
    monkeypatch.setenv("BENCH_PIPELINE", "yes")
    with pytest.raises(SystemExit, match="BENCH_PIPELINE must be 0|1"):
        bench.env_flag("BENCH_PIPELINE")
    eng, props = benchlib.make_bench_engine(4, telemetry=True, fleet=True,
                                            device="cpu")
    rate = benchlib.measure_rate(eng, props, rounds_per_call=2, calls=2,
                                 pipelined=True)
    assert eng.rounds == 1 + 4 + 2 + 4
    unit = json.loads(bench.result_line(eng, rate, 1.0, 3, {},
                                        pipelined=True))["unit"]
    assert "loop=pipelined, telemetry=on, fleet=on" in unit


def test_port_imports_no_jax():
    """Importing every module of the port (the rawnode, the node, the
    message codec, the raft host pieces, raftexample, the WAL and its
    native library, the apply plane, the hubs, the tracer, the
    membership store, the wire codec, the hosting stack, the shm fabric,
    the chaos harness, the checkers, the worker process and its admin
    server, the rebalancer and the tools that drive them, the scalar
    raft core, the shadow cluster and its lockstep tool, the etcd server
    with its MVCC store, lessor, auth, v2 store, RPC service and client
    among them, and what boots and fronts it: embed, etcdmain, the peer
    transport, the HTTP listeners, etcdutl, the benchmark tool and the
    member-process harness),
    building and loading the walog library,
    and importing chip_smoke load neither jax nor any module of the JAX
    package."""
    code = """
import pkgutil, sys
import etcd_tpu_torch
for m in pkgutil.walk_packages(etcd_tpu_torch.__path__, "etcd_tpu_torch."):
    __import__(m.name)
from etcd_tpu_torch.native import walog
walog._lib()
import chip_smoke
for m in ("etcd_tpu_torch.batched.rawnode", "etcd_tpu_torch.batched.msgblock",
          "etcd_tpu_torch.batched.graph", "etcd_tpu_torch.raft.types",
          "etcd_tpu_torch.batched.node", "etcd_tpu_torch.raft.confchange",
          "etcd_tpu_torch.raft.storage", "etcd_tpu_torch.raftexample.raftnode",
          "etcd_tpu_torch.storage.wal", "etcd_tpu_torch.storage.snap",
          "etcd_tpu_torch.native.walog", "etcd_tpu_torch.pkg.metrics",
          "etcd_tpu_torch.batched.applyplane", "etcd_tpu_torch.batched.telemetry",
          "etcd_tpu_torch.batched.membership", "etcd_tpu_torch.obs.artifacts",
          "etcd_tpu_torch.obs.fleet", "etcd_tpu_torch.obs.tracer",
          "etcd_tpu_torch.obs.export", "etcd_tpu_torch.obs.merge",
          "etcd_tpu_torch.pkg.failpoint", "etcd_tpu_torch.pkg.errors",
          "etcd_tpu_torch.transport.codec", "etcd_tpu_torch.batched.hosting",
          "etcd_tpu_torch.batched.shmfabric", "etcd_tpu_torch.batched.faults",
          "etcd_tpu_torch.functional.checker", "etcd_tpu_torch.pkg",
          "etcd_tpu_torch.batched.hosting_proc",
          "etcd_tpu_torch.batched.rebalance",
          "etcd_tpu_torch.tools.hosted_bench",
          "etcd_tpu_torch.tools.multiraft_proc_demo",
          "etcd_tpu_torch.tools.multiraft_demo",
          "etcd_tpu_torch.tools.rebalancerd",
          "etcd_tpu_torch.tools.proc_cluster",
          "etcd_tpu_torch.raft.raft", "etcd_tpu_torch.raft.rawnode",
          "etcd_tpu_torch.raft.node", "etcd_tpu_torch.raft.log",
          "etcd_tpu_torch.raft.logger", "etcd_tpu_torch.raft.read_only",
          "etcd_tpu_torch.raft.util", "etcd_tpu_torch.batched.shadow",
          "etcd_tpu_torch.tools.shadow_lockstep",
          "etcd_tpu_torch.server.server", "etcd_tpu_torch.server.apply",
          "etcd_tpu_torch.storage.mvcc.watchable",
          "etcd_tpu_torch.storage.backend", "etcd_tpu_torch.lease.lessor",
          "etcd_tpu_torch.auth.store", "etcd_tpu_torch.v2store.store",
          "etcd_tpu_torch.v3rpc.service", "etcd_tpu_torch.client.client",
          "etcd_tpu_torch.client.concurrency",
          "etcd_tpu_torch.embed.config", "etcd_tpu_torch.pkg.rpctypes",
          "etcd_tpu_torch.functional.cluster",
          "etcd_tpu_torch.tools.server_script",
          "etcd_tpu_torch.embed.etcd", "etcd_tpu_torch.etcdmain",
          "etcd_tpu_torch.__main__", "etcd_tpu_torch.transport.tcp",
          "etcd_tpu_torch.transport.metrics", "etcd_tpu_torch.etcdhttp",
          "etcd_tpu_torch.gatewayjson", "etcd_tpu_torch.v2http",
          "etcd_tpu_torch.discovery", "etcd_tpu_torch.client.srv",
          "etcd_tpu_torch.etcdutl", "etcd_tpu_torch.version",
          "etcd_tpu_torch.pkg.report", "etcd_tpu_torch.tools.benchmark",
          "etcd_tpu_torch.tools.member_procs"):
    assert m in sys.modules, m
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "etcd_tpu" or m.startswith("etcd_tpu."))
print(",".join(bad))
"""
    root = __file__.rsplit("/tests/", 1)[0]
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"port loaded: {out.stdout.strip()}"
