"""PyTorch port ↔ JAX reference: the sender-scan deliver shapes under
load and faults (tests/test_torch_shapes.py holds the schedules).

* a seeded schedule at test_chaos.CFG's values (timer elections,
  pre-vote, check-quorum, auto-compaction; fleet plane off), where the
  shapes may differ from each other but each equals its JAX twin in
  every state field, the outbox and the routed inbox;
* the bench engine under BENCH_DELIVER_SHAPE, against the JAX engine,
  and the three shapes against each other at the bench config;
* the rawnode with a scan shape;
* the two slow chaos cells of tests/batched/test_deliver_shapes.py on
  the port's ChaosHarness.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from etcd_tpu.batched import BatchedConfig as JBatchedConfig
from etcd_tpu.batched import MultiRaftEngine as JEngine
from etcd_tpu_torch.batched import MultiRaftEngine
from etcd_tpu_torch.batched.state import BatchedConfig
from etcd_tpu_torch.tools import bench, benchlib
from etcd_tpu_torch.tools.shadow_lockstep import STATE_FIELDS, state_fields

from .test_torch_state import assert_same
from .test_torch_step import Lockstep

R = 3
SCAN_SHAPES = ("lanes", "merged")
# test_chaos.CFG's values with the fleet plane off (the round's extra
# output is a pure read of its state; tests/test_torch_planes.py holds
# it).
CHAOS = dict(num_groups=8, num_replicas=R, window=16, max_ents_per_msg=4,
             max_props_per_round=4, election_timeout=10, heartbeat_timeout=1,
             pre_vote=True, check_quorum=True, auto_compact=True)


def chaos_schedule(rounds: int, seed: int):
    """Timer elections on every tick, early campaigns, proposals on
    every slot (leaders accept), a rolling partition, reads and
    transfers, keyed (group, slot)."""
    rng = np.random.RandomState(seed)
    g = CHAOS["num_groups"]
    cells = [(gg, s) for gg in range(g) for s in range(R)]
    out = []
    for rnd in range(rounds):
        pick = lambda p: [c for c in cells if rng.rand() < p]  # noqa: E731
        step = {"tick": True,
                "campaign": pick(0.3 if rnd < 3 else 0.02),
                "propose": {c: int(rng.randint(0, 5)) for c in cells},
                "read": pick(0.05),
                "transfer": {c: int(rng.randint(0, R))
                             for c in pick(0.02)}}
        if 20 <= rnd < 35:
            step["isolate"] = [(gg, rnd % R) for gg in range(0, g, 3)]
        out.append(step)
    return out


@pytest.mark.parametrize("shape", SCAN_SHAPES)
def test_shape_matches_jax_prevote_checkquorum(shape):
    """Pre-vote, check-quorum and timer elections: each shape equals its
    JAX twin every round."""
    ls = Lockstep(dict(CHAOS, deliver_shape=shape))
    ls.run(chaos_schedule(60, seed=17))
    assert (ls.tst.role == 2).sum() >= 4
    assert int(ls.tst.commit.max()) > 10


def test_bench_config_shapes_agree():
    """Under the bench config (no pre-vote, no check-quorum) the three
    shapes agree with each other on every STATE_FIELDS field."""
    engines = {}
    for shape in SCAN_SHAPES + ("vectorized",):
        eng, props = benchlib.make_bench_engine(4, device="cpu",
                                                deliver_shape=shape)
        assert eng.cfg.deliver_shape == shape
        engines[shape] = eng
    for rnd in range(24):
        for eng in engines.values():
            eng.step_round(tick=rnd % 2 == 0, propose_n=props)
        want = state_fields(engines["vectorized"])
        for shape in SCAN_SHAPES:
            got = state_fields(engines[shape])
            for f in STATE_FIELDS:
                assert np.array_equal(got[f], want[f]), (shape, rnd, f)
    assert engines["lanes"].commits().min() > 4 * 2


@pytest.mark.parametrize("shape", SCAN_SHAPES)
def test_bench_engine_matches_jax(shape, monkeypatch):
    """The bench engine under BENCH_DELIVER_SHAPE against the JAX
    engine of the same config, over sustained load."""
    monkeypatch.setenv("BENCH_DELIVER_SHAPE", shape)
    eng, props = benchlib.make_bench_engine(
        4, device="cpu", deliver_shape=bench.deliver_shape_env())
    jeng = JEngine(JBatchedConfig(**eng.cfg._asdict()))
    jeng.campaign([g * R for g in range(4)])
    for _ in range(4):
        jeng.step_round()
    jprops = jnp.asarray(props.numpy())
    for _ in range(20):
        eng.step_round(tick=True, propose_n=props)
        jeng.step_round(tick=True, propose_n=jprops)
    assert_same(jeng.state, eng.state, f"{shape} state")
    assert_same(jeng.inbox, eng.inbox, f"{shape} inbox")
    unit = bench.result_line(eng, 1.0, 1.0, 3, {})
    assert f"deliver={shape}," in unit


def test_bench_deliver_shape_variable(monkeypatch):
    """BENCH_DELIVER_SHAPE as the JAX bench reads it: unset is "auto",
    a bad value and the retired BENCH_MERGED_DELIVER exit."""
    monkeypatch.delenv("BENCH_DELIVER_SHAPE", raising=False)
    monkeypatch.delenv("BENCH_MERGED_DELIVER", raising=False)
    assert bench.deliver_shape_env() == "auto"
    eng = MultiRaftEngine(benchlib.bench_config(2), device="cpu")
    assert eng.cfg.deliver_shape == "vectorized"
    monkeypatch.setenv("BENCH_DELIVER_SHAPE", "scan")
    with pytest.raises(SystemExit, match="lanes|merged|vectorized"):
        bench.deliver_shape_env()
    monkeypatch.setenv("BENCH_DELIVER_SHAPE", "merged")
    assert bench.deliver_shape_env() == "merged"
    monkeypatch.setenv("BENCH_MERGED_DELIVER", "1")
    with pytest.raises(SystemExit, match="BENCH_DELIVER_SHAPE"):
        bench.deliver_shape_env()


@pytest.mark.parametrize("shape", SCAN_SHAPES)
def test_scan_round_builds_for_the_engine_and_the_rawnode(shape):
    """A config with either scan shape builds the engine and the hosted
    rawnode, as the reference's do, and a rawnode round runs."""
    from etcd_tpu_torch.batched.rawnode import BatchedRawNode

    cfg = BatchedConfig(**dict(CHAOS, deliver_shape=shape))
    assert MultiRaftEngine(cfg, device="cpu").cfg.deliver_shape == shape
    rn = BatchedRawNode(cfg, groups=np.arange(8), slots=np.zeros(8, int),
                        device="cpu")
    rn.campaign(list(range(8)))
    rn.advance_round()
    rn.advance()
    assert (rn.state.role != 0).all()


# -- chaos re-fly for the scan shapes (slow, as in the reference) -------------


@pytest.mark.slow
@pytest.mark.chaos
@pytest.mark.parametrize("shape", SCAN_SHAPES)
def test_chaos_msg_faults_other_shapes(tmp_path, shape):
    """One message-fault episode per scan shape on the port's harness,
    strict 3-checker + invariant_trips() == 0."""
    from etcd_tpu_torch.batched.faults import (
        ChaosHarness,
        LeaderObserver,
        run_invariant_checks,
    )

    from .test_torch_chaos import CFG, MSG_FAULTS, SEEDS, TICK

    cfg = CFG._replace(deliver_shape=shape)
    h = ChaosHarness(str(tmp_path), SEEDS[0], MSG_FAULTS, num_members=R,
                     num_groups=cfg.num_groups, cfg=cfg,
                     tick_interval=TICK, device="cpu")
    obs = LeaderObserver(h.alive)
    try:
        h.wait_leaders()
        obs.start()
        acked = h.run_workload(20)
        assert acked >= 10, f"only {acked}/20 writes acked"
        h.plan.quiesce()
        run_invariant_checks(h, obs, expect_members=R)
    finally:
        obs.stop()
        h.stop()
