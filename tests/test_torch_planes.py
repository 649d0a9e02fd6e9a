"""PyTorch port ↔ JAX reference: the round planes (telemetry frame,
fleet summary frame), their building blocks, outbox packing and the
engine's closed loop with the plane accumulators.

All comparisons are exact, in values and dtypes (everything is int32,
int64 or bool). The JAX side runs only round-step configs that the
batched suite already builds, so the compile-shape budget of
tests/batched/conftest.py does not move:

* test_telemetry.CFG_ON and test_fleet.CFG_ON (G=2, R=3, W=32, E=4,
  P=4, HB=1, ET=1<<20), through the JAX engine, serial and pipelined
  with chunk == rounds (one scan program per engine);
* test_chaos.CFG (G=8, pre-vote, check-quorum, auto-compaction, fleet
  on) through make_step_round with aux over the dense rows: the key the
  chaos suite's rawnodes build. Its telemetry frame comes from the JAX
  frame function under jax.vmap, outside any round program.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etcd_tpu.batched import MultiRaftEngine as JEngine
from etcd_tpu.batched import kernels as jk
from etcd_tpu.batched import state as jstate
from etcd_tpu.batched import step as jstep
from etcd_tpu.batched import telemetry as jtel
from etcd_tpu.obs import fleet as jfleet
from etcd_tpu.pkg import metrics as jmet
from etcd_tpu_torch.batched import kernels as tk
from etcd_tpu_torch.batched import state as tstate
from etcd_tpu_torch.batched import step as tstep
from etcd_tpu_torch.batched import telemetry as ttel
from etcd_tpu_torch.batched.convert import msgs_from_numpy, state_from_numpy
from etcd_tpu_torch.batched.engine import MultiRaftEngine
from etcd_tpu_torch.obs import fleet as tfleet
from etcd_tpu_torch.pkg import metrics as tmet

from .batched.test_chaos import CFG as CHAOS_CFG
from .batched.test_fleet import CFG_ON as FLEET_CFG
from .batched.test_telemetry import CFG_ON as TEL_CFG
from .test_torch_state import assert_same

R = 3


def test_copied_constants_match_jax():
    assert ttel.TM_NAMES == jtel.TM_NAMES
    assert ttel.NUM_COUNTERS == jtel.NUM_COUNTERS
    assert ttel.TM_INDEX == jtel.TM_INDEX
    assert ttel.INV_NAMES == jtel.INV_NAMES
    for bits in (0, 1, 5, 1 << 10, (1 << 11) - 1, 0x2A5):
        assert ttel.decode_invariants(bits) == jtel.decode_invariants(bits)
    for name in ("FLEET_BUCKETS", "FLEET_TOP_K", "FLEET_HEAT_BINS",
                 "ROLE_NAMES", "PR_STATE_NAMES", "ACC_SUM", "ACC_LAST",
                 "BUCKET_BOUNDS"):
        assert getattr(tfleet, name) == getattr(jfleet, name), name
    for i in range(tfleet.FLEET_BUCKETS):
        assert tfleet.bucket_lower(i) == jfleet.bucket_lower(i)
    assert tstep.REC_WORDS == jstep.REC_WORDS


@pytest.mark.parametrize("rows, r, groups", [
    (6, 3, 2), (24, 3, 8), (1, 1, 1), (300, 3, 100), (1000, 5, 200),
    (196608, 3, 65536), (65536, 3, 65536)])
def test_fleet_layout_matches_jax(rows, r, groups):
    t, j = (tfleet.FleetLayout(rows, r, groups),
            jfleet.FleetLayout(rows, r, groups))
    for attr in ("fields", "offsets", "size", "heat_bins", "top_k",
                 "n_rows", "num_replicas", "num_groups"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert np.array_equal(t.sum_mask(), j.sum_mask())
    assert t.bin_starts() == j.bin_starts()
    vec = np.arange(t.size)
    assert {k: v.tolist() for k, v in t.decode(vec).items()} == {
        k: v.tolist() for k, v in j.decode(vec).items()}


# -- building blocks --------------------------------------------------------------


def random_state(cfg, seed: int) -> dict:
    """A seeded state with every field drawn over a range that trips
    each invariant bit on some rows and on no others."""
    rng = np.random.RandomState(seed)
    st = {f: np.array(v.numpy()) for f, v in
          tstate.init_state(cfg, device="cpu")._asdict().items()}
    n, r, w = cfg.num_instances, cfg.num_replicas, cfg.window

    def ints(lo, hi, shape=(n,)):
        return rng.randint(lo, hi, size=shape).astype(np.int32)

    def bools(p, shape=(n,)):
        return rng.rand(*shape) < p

    st.update(
        role=ints(0, 4), lead=ints(0, r + 1), term=ints(0, 9),
        log_term=ints(0, 9, (n, w)), snap_index=ints(0, 30),
        last=ints(20, 60), commit=ints(15, 62), applied=ints(0, 40),
        match=ints(0, 60, (n, r)), next=ints(0, 62, (n, r)),
        pr_state=ints(0, 3, (n, r)), probe_sent=bools(0.5, (n, r)),
        pending_snapshot=ints(0, 60, (n, r)),
        inflight=ints(0, 5, (n, r)),
        voter=bools(0.7, (n, r)), voter_out=bools(0.2, (n, r)),
        learner=bools(0.1, (n, r)), in_joint=bools(0.3),
        fenced=bools(0.1), read_ready=bools(0.3),
        read_index=ints(-1, 5), lease_ticks=ints(0, 3))
    return st


def test_invariant_bits_match_jax():
    cfg = tstate.BatchedConfig(num_groups=200, num_replicas=R, window=32,
                               max_ents_per_msg=4, max_props_per_round=2)
    st = random_state(cfg, 7)
    slots = (np.arange(cfg.num_instances) % R).astype(np.int32)
    want = np.asarray(jax.vmap(jk.invariant_bits)(
        jstate.BatchedState(**{f: jnp.asarray(v) for f, v in st.items()}),
        jnp.asarray(slots)))
    got = tk.invariant_bits(state_from_numpy(st, device="cpu"),
                            torch.as_tensor(slots)).numpy()
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)
    for bit in range(len(ttel.INV_NAMES)):
        hit = (got >> bit) & 1
        assert hit.any() and not hit.all(), ttel.INV_NAMES[bit]


@pytest.mark.parametrize("shape", [(500,), (300, 3)])
def test_log_buckets_match_jax(shape):
    rng = np.random.RandomState(len(shape))
    v = rng.choice([-7, -1, 0, 0, 1, 2, 3, 5, 8, 100, 1 << 14, 1 << 20],
                   size=shape).astype(np.int32)
    v.flat[:50] = rng.randint(-(1 << 16), 1 << 16, size=50)
    mask = rng.rand(*shape) < 0.6
    tv, tm = torch.as_tensor(v), torch.as_tensor(mask)
    jv, jm = jnp.asarray(v), jnp.asarray(mask)
    b = tfleet.FLEET_BUCKETS
    pairs = [
        (tk.log_bucket_index(tv, b), jk.log_bucket_index(jv, b)),
        (tk.log_bucket_counts(tv, b), jk.log_bucket_counts(jv, b)),
        (tk.log_bucket_counts_masked(tv, b, tm),
         jk.log_bucket_counts_masked(jv, b, jm)),
    ]
    for got, want in pairs:
        got, want = got.numpy(), np.asarray(want)
        assert got.dtype == want.dtype == np.int32
        assert np.array_equal(got, want)


def test_top_k_breaks_ties_by_lower_row():
    """lax.top_k ranks equal values by lower index; torch.topk does not
    (ROADMAP C1's example gave [1, 3, 6, 4])."""
    def top(values, k):
        v = torch.as_tensor(values, dtype=torch.int32)
        rank = len(values) - 1 - torch.arange(len(values))
        return tstep.top_k_rows(v, k, rank).tolist()

    assert top([0, 5, 0, 5, 0, 0, 3], 4) == [1, 3, 6, 0]
    rng = np.random.RandomState(3)
    for size, k in ((50, 8), (7, 7), (1000, 8)):
        v = rng.choice([-3, 0, 0, 0, 2, 2, 9], size=size).astype(np.int32)
        want = np.asarray(jax.lax.top_k(jnp.asarray(v), k)[1]).tolist()
        assert top(v, k) == want


@pytest.mark.parametrize("narrow", [False, True])
def test_pack_outbox_matches_jax(narrow):
    rng = np.random.RandomState(11)
    n, k, e = 12, 6, 4
    wire = [0, 3, 4, 5, 6, 7, 8, 9, 14, 17, 18, 2, 31]
    m = {f: rng.randint(-5, 1 << 20, size=(n, R, k)).astype(np.int32)
         for f in tstep.MsgSlots._fields}
    m.update(valid=rng.rand(n, R, k) < 0.6, reject=rng.rand(n, R, k) < 0.3,
             type=rng.choice(wire, size=(n, R, k)).astype(np.int32),
             n_ents=rng.randint(0, 200, size=(n, R, k)).astype(np.int32),
             ent_terms=rng.randint(0, 9, size=(n, R, k, e)).astype(np.int32))
    if narrow:
        m.update(type=m["type"].astype(np.int8),
                 n_ents=m["n_ents"].astype(np.int16))
    slots = (np.arange(n) % R).astype(np.int32)
    got = tstep.pack_outbox(msgs_from_numpy(m, device="cpu"),
                            torch.as_tensor(slots))
    want = jstep.pack_outbox(
        jstep.MsgSlots(**{f: jnp.asarray(v) for f, v in m.items()}),
        jnp.asarray(slots))
    for g, w in zip(got, want, strict=True):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)


# -- the round with both planes, per round ----------------------------------------


def test_round_planes_match_jax_per_round():
    """The chaos suite's G=8 config (pre-vote, check-quorum, timer
    elections, auto-compaction) over a seeded schedule: every round the
    port's state, outbox, aux and fleet frame equal the JAX round's, and
    its telemetry frame equals the JAX frame function's on the JAX
    round's own inputs and outputs."""
    cfg = CHAOS_CFG
    n = cfg.num_instances
    jround = jstep.make_step_round(cfg, with_aux=True)
    tcfg = tstate.BatchedConfig(**cfg._asdict())
    tround = tstep.make_step_round(tcfg._replace(telemetry=True),
                                   with_aux=True, device="cpu")
    slots = jnp.arange(n, dtype=jnp.int32) % R
    jframe = jax.vmap(functools.partial(jstep._telemetry_frame, cfg))
    jst = jstate.init_state(cfg)
    jinbox = jstep.empty_msgs((n, R, 6), cfg.max_ents_per_msg)
    tst = tstate.init_state(tcfg, device="cpu")
    tinbox = tstep.empty_msgs((n, R, 6), cfg.max_ents_per_msg, device="cpu")
    rng = np.random.RandomState(5)
    trips = 0
    for rnd in range(40):
        tick = np.ones(n, bool)
        camp = rng.rand(n) < (0.3 if rnd < 2 else 0.01)
        props = rng.randint(0, cfg.max_props_per_round + 1, n).astype(
            np.int32)
        iso = np.zeros(n, bool)
        if 15 <= rnd < 25:
            iso[rnd % R::R * 3] = True
        tr = np.where(rng.rand(n) < 0.03, rng.randint(1, R + 1, n),
                      0).astype(np.int32)
        read = rng.rand(n) < 0.05
        args = (tick, camp, props, iso, tr, read)
        jst1, jout, jaux, jfv = jround(jst, jinbox, *map(jnp.asarray, args))
        tst, tout, taux, ttelf, tfv = tround(
            tst, tinbox, *map(torch.as_tensor, args))
        ctx = f"round {rnd}"
        assert_same(jst1, tst, ctx)
        assert_same(jout, tout, ctx)
        assert_same(jaux, taux, ctx)
        assert tfv.dtype == torch.int32
        assert np.array_equal(tfv.numpy(), np.asarray(jfv)), ctx
        jinbox_iso = jinbox._replace(
            valid=jinbox.valid & ~jnp.asarray(iso)[:, None, None])
        want = jframe(slots, jst, jst1, jinbox_iso, jout, jaux.last_tick,
                      jnp.asarray(props))
        assert_same(want, ttelf, ctx)
        trips += int((ttelf.invariants != 0).sum())
        jst, jinbox = jst1, jstep.route(cfg, jout)
        tinbox = tstep.route(tcfg, tout)
    assert trips == 0
    leaders = (tst.role == tstate.LEADER).sum().item()
    assert leaders >= cfg.num_groups // 2


# -- the engine: closed loop, pipelining, accumulators, drains --------------------


def drive(eng, props, pipelined):
    """tests/batched/test_telemetry.py's schedule: elections,
    proposals, heartbeats and a ReadIndex batch, then 12 closed-loop
    rounds (one chunk when pipelined)."""
    g = eng.cfg.num_groups
    eng.campaign([i * R for i in range(g)])
    for _ in range(3):
        eng.step_round()
    eng.step_round(propose_n=props)
    eng.read_index([0])
    if pipelined:
        eng.run_rounds_pipelined(12, chunk=12, tick=True, propose_n=props)
    else:
        eng.run_rounds(12, tick=True, propose_n=props)
    eng.step_round(tick=True)


def records(hub):
    return [{k: v for k, v in rec.items() if k != "t"}
            for rec in hub.records()]


@pytest.mark.parametrize("plane", ["telemetry", "fleet"])
def test_engine_planes_match_jax(plane):
    """State, inbox, the accumulated plane and the records that the
    drains leave in each package's own hub, after the serial and then
    the pipelined phase."""
    cfg = TEL_CFG if plane == "telemetry" else FLEET_CFG
    n = cfg.num_instances
    jeng = JEngine(cfg)
    teng = MultiRaftEngine(tstate.BatchedConfig(**cfg._asdict()),
                           device="cpu")
    props = np.zeros(n, np.int32)
    props[::R] = 2
    if plane == "telemetry":
        hubs = [tel.TelemetryHub(n, registry=met.Registry(),
                                 dump_on_trip=False)
                for tel, met in ((jtel, jmet), (ttel, tmet))]
    else:
        hubs = [fl.FleetHub(n, R, cfg.num_groups, registry=met.Registry())
                for fl, met in ((jfleet, jmet), (tfleet, tmet))]
    for pipelined in (False, True):
        drive(jeng, jnp.asarray(props), pipelined)
        drive(teng, torch.as_tensor(props), pipelined)
        ctx = "pipelined" if pipelined else "serial"
        assert_same(jeng.state, teng.state, ctx)
        assert_same(jeng.inbox, teng.inbox, ctx)
        if plane == "telemetry":
            for w, g in zip(jeng.telemetry(), teng.telemetry(), strict=True):
                assert g.dtype == w.dtype and np.array_equal(g, w), ctx
            drained = (jeng.drain_telemetry(hubs[0]),
                       teng.drain_telemetry(hubs[1]))
            assert all(map(np.array_equal, *drained))
            assert teng.telemetry()[0][:, ttel.TM_INDEX["commit_delta"]].sum()
        else:
            w, g = jeng.fleet_frame(), teng.fleet_frame()
            assert g.dtype == w.dtype == np.int64
            assert np.array_equal(g, w), ctx
            w, g = jeng.drain_fleet(hubs[0]), teng.drain_fleet(hubs[1])
            assert np.array_equal(g, w), ctx
            # The device window is zeroed, the banked base kept.
            assert np.array_equal(teng.fleet_frame(), jeng.fleet_frame())
    assert records(hubs[1]) == records(hubs[0])
    assert len(records(hubs[0])) == 2


def test_pipelined_equals_serial():
    cfg = tstate.BatchedConfig(**FLEET_CFG._replace(telemetry=True)
                               ._asdict())
    props = torch.zeros(cfg.num_instances, dtype=torch.int32)
    props[::R] = 3
    engines = [MultiRaftEngine(cfg, device="cpu") for _ in range(2)]
    for eng in engines:
        eng.campaign([0, 3])
        eng.run_rounds(3, tick=False)
    engines[0].run_rounds(10, propose_n=props)
    engines[1].run_rounds_pipelined(10, chunk=3, depth=1, propose_n=props)
    a, b = engines
    assert a.rounds == b.rounds == 14
    for x, y in zip(tuple(a.state) + tuple(a.inbox),
                    tuple(b.state) + tuple(b.inbox)):
        assert torch.equal(x, y)
    assert all(map(np.array_equal, a.telemetry(), b.telemetry()))
    assert np.array_equal(a.fleet_frame(), b.fleet_frame())
    with pytest.raises(ValueError, match="chunk"):
        b.run_rounds_pipelined(4, chunk=0)
    b.run_rounds_pipelined(0, chunk=0)  # no rounds: a no-op, as in JAX
    assert b.rounds == 14


def test_entry_points_write_into_the_engine_buffers():
    """Every entry point writes its round into the buffers the engine
    was built with (the buffers a captured round replays over), and the
    observation calls return copies, not views of them."""
    cfg = tstate.BatchedConfig(**FLEET_CFG._replace(telemetry=True)
                               ._asdict())
    eng = MultiRaftEngine(cfg, device="cpu")

    def ptrs():
        return [x.data_ptr() for x in tuple(eng.state) + tuple(eng.inbox)
                + (eng._tel_counters, eng._tel_invariants, eng._fleet_vec)]

    before = ptrs()
    commits = eng.commits()
    eng.campaign([0, 3])
    eng.run_rounds(3, tick=False)
    eng.transfer_leader(0, 1)
    eng.read_index([3])
    eng.set_membership(1, voters=(0, 1), learners=(2,))
    eng.step_round(tick=True, isolate=torch.arange(6) == 4)
    eng.drain_fleet()
    eng.run_rounds_pipelined(4, chunk=2)
    assert ptrs() == before
    assert (commits == 0).all() and (eng.commits() > 0).any()
    assert eng.state.learner[5, 2].item()
    assert not eng.state.voter[5, 2].item()
