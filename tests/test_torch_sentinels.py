"""The port's runtime sentinels (etcd_tpu_torch/analysis/sentinels.py)
beside the JAX package's (tests/batched/test_sentinels.py:50-138): each
sentinel must fire on a seeded violation.

On the CPU the sync guard is a no-op (there is no device to wait for,
as the JAX guard does not trip on CPU array transfers), so the guard's
mechanics run here with PyTorch's sync debug mode replaced by a
recorder; its firing on a real sync is tests/test_torch_cuda.py's
(`test_seeded_sync_in_a_warm_eager_step_raises`). The capture budget
counts CUDA-graph captures, which only the card makes: here it runs
over an owner whose count the test moves, and on the card over an
engine (`test_capture_budget_fires_on_a_seeded_capture`).
"""

import ast
import inspect

import numpy as np
import pytest
import torch

import etcd_tpu.analysis as jax_analysis
from etcd_tpu_torch import analysis
from etcd_tpu_torch.analysis import sentinels
from etcd_tpu_torch.batched import BatchedConfig, MultiRaftEngine
from etcd_tpu_torch.batched import applyplane
from etcd_tpu_torch.batched.graph import RoundGraphs, device_work
from etcd_tpu_torch.batched.step import make_step_round
from etcd_tpu_torch.tools import benchlib

TCFG = BatchedConfig(
    num_groups=4, num_replicas=3, window=8, max_ents_per_msg=2,
    max_props_per_round=2, election_timeout=10, heartbeat_timeout=1,
)


@pytest.fixture
def eng():
    e = MultiRaftEngine(TCFG, device="cpu")
    e.campaign([g * TCFG.num_replicas for g in range(TCFG.num_groups)])
    e.run_rounds(4, tick=False)
    assert (e.leaders() == 0).all()
    return e


class FakeCuda:
    """PyTorch's sync debug mode, recorded: each set, and whether the
    device lock was held when it was set."""

    def __init__(self):
        self.mode = 0
        self.sets = []

    def get(self):
        return self.mode

    def set(self, level):
        self.sets.append((level, device_work()._is_owned()))
        self.mode = level


@pytest.fixture
def fake_cuda(monkeypatch):
    fake = FakeCuda()
    monkeypatch.setattr(sentinels, "_on_cuda", lambda device: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", fake.get)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", fake.set)
    return fake


# -----------------------------------------------------------------------------
# The sync guard
# -----------------------------------------------------------------------------


def test_round_loop_runs_clean_under_guard(eng, monkeypatch):
    """The engine's paths (single round, closed loop, pipelined) run
    under ETCD_TPU_TRANSFER_GUARD=disallow; on the CPU the guard is a
    no-op and the rounds are as without it."""
    monkeypatch.setenv("ETCD_TPU_TRANSFER_GUARD", "disallow")
    assert sentinels.transfer_guard_mode() == "disallow"
    eng.step_round(tick=True)
    eng.run_rounds(4, tick=True)
    eng.run_rounds_pipelined(8, chunk=4, tick=True)
    assert (eng.leaders() == 0).all()


def test_guard_levels_map_to_sync_debug_modes(monkeypatch):
    for env, level in (("disallow", "error"), ("log", "warn"),
                       ("allow", ""), ("", "")):
        monkeypatch.setenv("ETCD_TPU_TRANSFER_GUARD", env)
        assert sentinels._sync_mode() == level
    monkeypatch.setenv("ETCD_TPU_TRANSFER_GUARD", "strict")
    with pytest.raises(ValueError, match="ETCD_TPU_TRANSFER_GUARD"):
        sentinels._sync_mode()


def test_guard_sets_and_restores_the_mode_under_the_device_lock(
        fake_cuda, monkeypatch):
    """round_guard() sets the level for its block, under the device lock
    (the mode is process-wide), and restores the previous mode after it,
    also when the block raises."""
    monkeypatch.setenv("ETCD_TPU_TRANSFER_GUARD", "disallow")
    fake_cuda.mode = "warn"
    with sentinels.round_guard("cuda"):
        assert fake_cuda.mode == "error"
        assert device_work()._is_owned()
    assert fake_cuda.mode == "warn"
    with pytest.raises(KeyError):
        with sentinels.round_guard("cuda"):
            raise KeyError("inside")
    assert fake_cuda.mode == "warn"
    assert fake_cuda.sets == [("error", True), ("warn", True)] * 2
    assert not device_work()._is_owned()


def test_guard_is_a_noop_on_the_cpu_and_when_off(monkeypatch):
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda level: pytest.fail("mode set"))
    monkeypatch.setenv("ETCD_TPU_TRANSFER_GUARD", "disallow")
    with sentinels.round_guard("cpu"):
        pass
    with sentinels.round_guard(torch.device("cpu")):
        pass
    monkeypatch.delenv("ETCD_TPU_TRANSFER_GUARD")
    with sentinels.round_guard("cuda"):
        pass


def test_cold_dispatch_is_exempt_then_guarded(fake_cuda, monkeypatch):
    """RoundGraphs.run: the first use of a key (the eager body, which
    loads the kernels and makes the constant tables, and the capture)
    runs unguarded; every replay runs under the guard, the first use's
    too, and the mode is restored after them."""
    monkeypatch.setenv("ETCD_TPU_TRANSFER_GUARD", "disallow")
    seen = []

    class Graph:
        def replay(self):
            seen.append(("replay", fake_cuda.mode))

    graphs = RoundGraphs("sentinel-test")

    def capture(key, body, info):
        seen.append(("capture", fake_cuda.mode))
        graphs._graphs[key] = (Graph(), {"kernels": {}, "forms": {}})
        return graphs._graphs[key]

    monkeypatch.setattr(graphs, "_capture", capture)
    graphs.run("k", lambda: seen.append(("eager", fake_cuda.mode)), 2)
    graphs.run("k", lambda: pytest.fail("eager again"), 1)
    assert seen == [("eager", 0), ("capture", 0), ("replay", "error"),
                    ("replay", "error")]
    assert fake_cuda.mode == 0


def test_engine_guards_its_warm_eager_rounds(fake_cuda, monkeypatch):
    """The engine's eager step_round is its warm dispatch after its
    first round: with the guard on, the second and later rounds run
    inside the debug mode, and a seeded sync there would raise on the
    card (tests/test_torch_cuda.py)."""
    monkeypatch.setenv("ETCD_TPU_TRANSFER_GUARD", "disallow")
    e = MultiRaftEngine(TCFG, device="cpu")
    modes = []
    orig = e._step

    def spy(*args):
        modes.append(fake_cuda.mode)
        return orig(*args)

    e._step = spy
    for _ in range(3):
        e.step_round(tick=True)
    assert modes == [0, "error", "error"]
    assert fake_cuda.mode == 0


# -----------------------------------------------------------------------------
# The recompile sentinel and the capture budget
# -----------------------------------------------------------------------------


class Owner:
    """Anything with a `.captures` count (an engine, a rawnode)."""

    def __init__(self):
        self.captures = 2


def test_compile_budget_fires_on_a_seeded_capture():
    """A zero budget passes a steady loop and catches one new capture
    (a new tick value, a new owner's first round)."""
    owner = Owner()
    budget = sentinels.CompileBudget(0).track("closed_loop", owner)
    assert budget.check() == 0  # steady state: no miss
    owner.captures += 1  # seeded: one capture
    with pytest.raises(sentinels.RecompileBudgetExceeded, match="1 > "):
        budget.check()
    assert budget.misses() == 1
    assert budget.report() == {"closed_loop": 1}
    assert sentinels.CompileBudget(1).track("x", owner).check() == 0


def test_measure_rate_holds_its_loop_to_zero_captures(eng, monkeypatch):
    """benchlib.measure_rate's measured calls may capture nothing: a
    loop whose every call captures (seeded) is caught."""
    props = torch.zeros(TCFG.num_instances, dtype=torch.int32)
    benchlib.measure_rate(eng, props, 2, 2)  # clean: no capture
    calls = []
    orig = MultiRaftEngine.run_rounds

    def capturing(self, *a, **kw):
        calls.append(1)
        return orig(self, *a, **kw)

    monkeypatch.setattr(MultiRaftEngine, "captures",
                        property(lambda self: len(calls)))
    monkeypatch.setattr(MultiRaftEngine, "run_rounds", capturing)
    with pytest.raises(sentinels.RecompileBudgetExceeded):
        benchlib.measure_rate(eng, props, 2, 2)


def test_shape_counter_fires_on_a_seeded_novel_config():
    """Building the round for a config nobody else uses adds one
    "round_step" key; building it again adds none."""
    before = sentinels.distinct_shapes("round_step")
    novel = TCFG._replace(window=TCFG.window * 2 + 3)  # seeded
    make_step_round(novel, device="cpu")
    after = sentinels.distinct_shapes("round_step")
    assert after == before + 1, (
        "the recompile sentinel missed a novel round-step config")
    make_step_round(novel, device="cpu")
    assert sentinels.distinct_shapes("round_step") == after
    # The key is the config after apply_plane_key: plane knobs do not
    # make a new round.
    make_step_round(novel._replace(apply_capacity=64), device="cpu")
    assert sentinels.distinct_shapes("round_step") == after


def test_engine_and_plane_note_their_keys():
    cfg = TCFG._replace(window=TCFG.window * 2 + 5)
    MultiRaftEngine(cfg, device="cpu")
    assert f"{cfg.validate().resolved()}" in sentinels.compile_keys(
        "closed_loop")
    plane = applyplane.init_plane(cfg, 3, device="cpu")
    ops = torch.zeros((3, 2), dtype=torch.int32)
    applyplane.dispatch(plane, ops, ops, ops, ops,
                        torch.zeros(3, dtype=torch.int32))
    applyplane.gather_rows(plane, np.array([0, 2]))
    keys = sentinels.compile_keys("apply_plane")
    assert "C=256|WS=8|A=2|n=3" in keys and "gather|m=2" in keys
    # No capture on the CPU: "round_capture" counts on the card only.
    assert not any(k.startswith(f"engine|{cfg.validate().resolved()}")
                   for k in sentinels.compile_keys("round_capture"))


def test_reset_compile_tracking_clears_the_keys():
    saved = {p: sentinels.compile_keys(p) for p in
             ("round_step", "closed_loop", "apply_plane", "round_capture")}
    try:
        sentinels.note_compile_key("sentinel-test", "k")
        assert sentinels.distinct_shapes("sentinel-test") == 1
        sentinels.reset_compile_tracking()
        assert sentinels.distinct_shapes() == 0
        assert sentinels.compile_keys("sentinel-test") == set()
    finally:
        for p, keys in saved.items():
            for k in keys:
                sentinels.note_compile_key(p, k)


# -----------------------------------------------------------------------------
# The package's exports
# -----------------------------------------------------------------------------


def _exports(module):
    tree = ast.parse(inspect.getsource(module))
    return {a.asname or a.name for node in tree.body
            if isinstance(node, ast.ImportFrom) for a in node.names}


def test_analysis_exports_the_jax_package_names():
    assert _exports(analysis) == _exports(jax_analysis)
    for name in _exports(analysis):
        assert hasattr(analysis, name)
    for name in ("note_compile_key", "distinct_shapes", "compile_keys",
                 "reset_compile_tracking", "RecompileBudgetExceeded",
                 "CompileBudget", "round_guard", "transfer_guard_mode"):
        assert hasattr(sentinels, name)
        assert hasattr(jax_analysis.sentinels, name)
    # Difference: the JAX package's keyed warm_guard has no counterpart;
    # the port's owners know their first dispatch (RoundGraphs.run, the
    # engine's round count).
    assert hasattr(jax_analysis.sentinels, "warm_guard")
    assert not hasattr(sentinels, "warm_guard")
    for method in ("track", "misses", "report", "check"):
        assert callable(getattr(sentinels.CompileBudget, method))
