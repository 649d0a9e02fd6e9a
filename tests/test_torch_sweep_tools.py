"""The port's sweep tools against the JAX package's: bench_sweep's
BASELINE configs #2-#5, frontier_sweep's pipeline gate and gpu_batch,
on the CPU at tiny sizes.

Each bench_sweep config runs through the port's own tool
(``bench_sweep.run_config``) at G=4 and the same schedule drives the
JAX engine of the same config with single rounds; every state field and
the routed inbox must be equal, with no tolerance (int32 and bool).
Configs #2 and #5 at G=4 are tests/batched/test_pipelined.py's G=4
engine (R=3, W=32, E=4, P=2, HB=4, auto-compaction), which the JAX
suite already builds; #3 (R=5) and #4 (W=16, E=2, P=1, election 4,
HB=1) are two round programs the reference side builds here, outside
tests/batched. The tables copied from the JAX tools are pinned to
theirs by syntax tree, with the differences listed.
"""

import ast
import inspect
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import etcd_tpu.batched.step as jax_step
import etcd_tpu.tools.bench_sweep as jax_sweep
import etcd_tpu.tools.frontier_sweep as jax_frontier
from etcd_tpu.batched import BatchedConfig as JBatchedConfig
from etcd_tpu.batched import MultiRaftEngine as JEngine
from etcd_tpu_torch.batched import MultiRaftEngine
from etcd_tpu_torch.batched import step as port_step
from etcd_tpu_torch.tools import bench_sweep, frontier_sweep, gpu_batch

from .test_torch_state import assert_same

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G, ROUNDS, CALLS = 4, 4, 2


def jax_schedule(c: int, cfg, rounds: int, calls: int) -> JEngine:
    """The JAX engine through config `c`'s schedule as the JAX tool
    drives it (etcd_tpu/tools/bench_sweep.py), one round at a time."""
    eng = JEngine(JBatchedConfig(**cfg._asdict()))
    n, r, g = cfg.num_instances, cfg.num_replicas, cfg.num_groups
    lead = jnp.arange(g) * r
    props = jnp.zeros((n,), jnp.int32).at[lead].set(2)

    def elect():
        eng.campaign([i * r for i in range(g)])
        for _ in range(4):
            eng.step_round()

    if c == 5:
        half = g // 2
        vout = np.zeros((n, r), bool)
        joint = np.zeros((n,), bool)
        vout[: half * r, : r - 1] = True
        joint[: half * r] = True
        eng.state = eng.state._replace(voter_out=jnp.asarray(vout),
                                       in_joint=jnp.asarray(joint))
    if c in (2, 3, 5):
        elect()
    read = jnp.zeros((n,), bool).at[lead].set(True)
    for _ in range(1 + calls):  # the warm-up block, then the measured
        if c == 5:
            eng.step_round(read_req=read, propose_n=props)
            for _ in range(rounds - 1):
                eng.step_round(tick=True, propose_n=props)
        elif c == 4:
            for _ in range(rounds):
                eng.step_round(tick=True)
        else:
            for _ in range(rounds):
                eng.step_round(tick=True, propose_n=props)
    return eng


@pytest.mark.parametrize("c", [2, 3, 4, 5])
def test_config_equals_the_jax_engine_on_its_schedule(c):
    rec, eng = bench_sweep.run_config(c, G, ROUNDS, CALLS, device="cpu")
    assert rec["config"] == c and rec["groups"] == G
    assert rec["device"] == "cpu" and rec["layout"] == "major"
    assert rec["captures_after_warmup"] == 0
    assert rec["replicas"] == bench_sweep.CONFIGS[c].replicas
    jeng = jax_schedule(c, eng.cfg, ROUNDS, CALLS)
    assert_same(jeng.state, eng.state, f"config #{c}")
    assert_same(jeng.inbox, eng.inbox, f"config #{c} inbox")
    if c == 4:
        assert rec["max_term_reached"] == int(np.asarray(jeng.terms()).max())
    if c == 5:
        assert rec["joint_groups"] == G // 2
        ready = np.asarray(jeng.read_states()[2])
        assert rec["read_batches_confirmed"] == int(ready[::3].sum()) > 0
        assert np.asarray(eng.state.in_joint).sum() == (G // 2) * 3


def test_joint_masks_are_written_into_the_engines_buffers():
    """Config #5 writes the joint masks in place: the state's buffers,
    which a captured graph replays, stay the engine's own."""
    ptrs = {}
    orig = MultiRaftEngine.campaign

    def spy(self, ids):
        ptrs["campaign"] = (self.state.voter_out.data_ptr(),
                            self.state.in_joint.data_ptr())
        return orig(self, ids)

    MultiRaftEngine.campaign = spy
    try:
        eng, _block = bench_sweep.build_joint_readindex(G, 3, "cpu")
    finally:
        MultiRaftEngine.campaign = orig
    assert ptrs["campaign"] == (eng.state.voter_out.data_ptr(),
                                eng.state.in_joint.data_ptr())


def _kwargs_of(fn) -> dict:
    """The keyword arguments of the BatchedConfig(...) call in `fn`."""
    tree = ast.parse(inspect.getsource(fn).lstrip())
    (call,) = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
               and getattr(n.func, "id", "") == "BatchedConfig"]
    return {k.arg: ast.unparse(k.value) for k in call.keywords}


def test_configs_pinned_to_the_jax_tool():
    """Field for field, the configs of etcd_tpu/tools/bench_sweep.py;
    the sizes, rounds and calls of its run table. Difference: the JAX
    tool sets lanes_minor (its --lanes-minor flag); the port's round is
    instance-major whatever the field says, so its configs leave the
    field at its default and it has no such flag."""
    for port_fn, jax_fn in ((bench_sweep.steady_config, jax_sweep._steady_rate),
                            (bench_sweep.election_config,
                             jax_sweep._election_rate),
                            (bench_sweep.steady_config,
                             jax_sweep._joint_readindex_rate)):
        jax_kwargs = _kwargs_of(jax_fn)
        assert jax_kwargs.pop("lanes_minor") == "lanes_minor"
        assert _kwargs_of(port_fn) == jax_kwargs
    assert port_fn(8, 3).lanes_minor is False
    tree = ast.parse(inspect.getsource(jax_sweep.main))
    (runs,) = [n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", "") == "runs"]
    for key, val in zip(runs.keys, runs.values):
        c = key.value
        name = val.elts[0].value
        call = val.elts[1].body
        quick, full = call.args[0].body.value, call.args[0].orelse.value
        replicas, rounds, calls = (a.value for a in call.args[1:4])
        assert bench_sweep.CONFIGS[c] == bench_sweep.Sweep(
            name, full, quick, replicas, rounds, calls), c
    assert [(c, bench_sweep.CONFIGS[c].groups) for c in sorted(
        bench_sweep.CONFIGS)] == [(2, 1024), (3, 10240), (4, 102400),
                                  (5, 1048576)]


def test_frontier_tables_pinned_to_the_jax_tool():
    # Differences: GPU_GROUPS is the JAX tool's TPU_GROUPS under the
    # card's name; --append-notes is not ported; a failed point fails
    # the sweep (no partial frontier).
    assert frontier_sweep.GPU_GROUPS == jax_frontier.TPU_GROUPS
    assert frontier_sweep.CPU_GROUPS == jax_frontier.CPU_GROUPS
    src = inspect.getsource(jax_frontier._pipeline_gate)
    assert f"_make_engine({frontier_sweep.GATE_GROUPS}," in src
    assert (f"run_rounds_pipelined({frontier_sweep.GATE_ROUNDS}, "
            f"chunk={frontier_sweep.GATE_CHUNK}") in src
    (loop,) = [n for n in ast.walk(ast.parse(src.lstrip()))
               if isinstance(n, ast.For) and isinstance(n.iter, ast.Tuple)]
    assert ast.literal_eval(loop.iter) == frontier_sweep.GATE_FIELDS
    assert "append-notes" not in inspect.getsource(frontier_sweep.main)


def test_round_phase_scopes_pinned_to_the_jax_round():
    def assignment(module):
        tree = ast.parse(inspect.getsource(module))
        (node,) = [n for n in tree.body if isinstance(n, ast.Assign)
                   and getattr(n.targets[0], "id", "") == "ROUND_PHASE_SCOPES"]
        return ast.dump(node)

    assert assignment(port_step) == assignment(jax_step)
    assert port_step.ROUND_PHASE_SCOPES == jax_step.ROUND_PHASE_SCOPES


def test_frontier_gate_passes_and_fires_on_a_seeded_divergence(
        monkeypatch):
    frontier_sweep.pipeline_gate("vectorized", "cpu")
    orig = MultiRaftEngine.run_rounds_pipelined

    def drops_a_round(self, rounds, *a, **kw):
        return orig(self, rounds - 1, *a, **kw)

    monkeypatch.setattr(MultiRaftEngine, "run_rounds_pipelined",
                        drops_a_round)
    with pytest.raises(AssertionError, match="diverged"):
        frontier_sweep.pipeline_gate("vectorized", "cpu")


def test_frontier_sweep_on_the_cpu(tmp_path):
    out = tmp_path / "frontier.json"
    result = frontier_sweep.sweep(str(out), "cpu", groups=[8, 16],
                                  rounds_per_call=2, calls=2)
    assert [p["groups"] for p in result["points"]] == [8, 16]
    assert all(p["rate_group_rounds_per_s"] > 0 and p["captures"] == 0
               and p["captures_after_warmup"] == 0 for p in result["points"])
    ws = result["warm_start"]
    assert ws["groups"] == 8 and ws["warm_built_nothing"] is None
    assert ws["cold_build_s"] > 0 and ws["warm_build_s"] > 0
    assert out.exists()
    assert "| 8 | vectorized |" in frontier_sweep.markdown(result)


def test_gpu_batch_on_the_cpu(tmp_path):
    result = gpu_batch.run(str(tmp_path), groups=8, shapes=("lanes",),
                           device="cpu", rounds_per_call=2, calls=2,
                           profile_rounds=2)
    assert result["device"] == "cpu"
    assert result["a_headline"]["rate_group_rounds_per_s"] > 0
    assert result["b_deliver_lanes"]["vs_headline"] > 0
    assert result["a_headline"]["captures_after_warmup"] == 0
    assert result["b_deliver_lanes"]["captures_after_warmup"] == 0
    assert result["c_kernels"].startswith("not measured")
    d = result["d_commit_p50"]
    assert not d["timed_out"] and d["rounds_to_commit"] >= 2
    phases = result["e_profile"]["phases"]
    assert sorted(phases) == sorted(n for n, _ in port_step.ROUND_PHASE_SCOPES)
    assert all(p["rounds"] == 4 for p in phases.values())
    assert sorted(os.listdir(tmp_path)) == ["batch.json", "round_trace.json"]


TOOLS = {
    "bench_sweep": [],
    "frontier_sweep": ["--out", "{tmp}/frontier.json"],
    "gpu_batch": ["--out", "{tmp}/batch"],
}


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tool_without_a_gpu_exits_with_an_error_and_writes_nothing(
        tool, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    args = [a.format(tmp=tmp_path) for a in TOOLS[tool]]
    r = subprocess.run(
        [sys.executable, "-m", f"etcd_tpu_torch.tools.{tool}", *args],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr
    assert r.stdout == ""
    assert os.listdir(tmp_path) == []
