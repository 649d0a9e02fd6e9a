"""PyTorch port ↔ JAX reference: the batched round.

The round of etcd_tpu_torch/batched/step.py (on the CPU, plain forms)
and the round of etcd_tpu/batched/step.py (deliver_shape="vectorized";
tests/test_torch_shapes*.py hold the two sender-scan shapes)
are stepped in lockstep from the same state with the same host inputs;
after EVERY round every BatchedState field, the outbox and the routed
inbox must be equal in value and dtype.

The JAX side runs only configs whose round-step program the batched
suite already builds, so the compile-shape budget of
tests/batched/conftest.py does not move:

* DIFF — tests/batched/test_deliver_shapes.py's vectorized engine
  (G=2, R=3, W=64, E=16, P=4, ET=1<<20, HB=1, unbounded inflight);
* SUSTAINED — tests/batched/test_sustained.py's engine (G=4, R=3,
  W=16, E=4, P=2, ET=1<<20, HB=2, auto_compact): the bench config in
  miniature.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etcd_tpu.batched import state as jstate
from etcd_tpu.batched import step as jstep
from etcd_tpu_torch.batched import state as tstate
from etcd_tpu_torch.batched import step as tstep
from etcd_tpu_torch.batched.convert import (
    msgs_from_numpy,
    msgs_to_numpy,
    state_from_numpy,
    state_to_numpy,
)

from .test_torch_state import assert_same, jax_to_numpy

R = 3
DIFF = dict(num_groups=2, num_replicas=R, window=64, max_ents_per_msg=16,
            max_props_per_round=4, election_timeout=1 << 20,
            heartbeat_timeout=1, max_inflight=1 << 20,
            deliver_shape="vectorized")
SUSTAINED = dict(num_groups=4, num_replicas=R, window=16, max_ents_per_msg=4,
                 max_props_per_round=2, election_timeout=1 << 20,
                 heartbeat_timeout=2, auto_compact=True)


def host_inputs(n: int, step: dict):
    """One round's host inputs from a schedule entry: campaign /
    propose / isolate / read / transfer keyed by (group, slot)."""
    camp = np.zeros(n, bool)
    props = np.zeros(n, np.int32)
    iso = np.zeros(n, bool)
    read = np.zeros(n, bool)
    tr = np.zeros(n, np.int32)
    for g, s in step.get("campaign", []):
        camp[g * R + s] = True
    for (g, s), k in step.get("propose", {}).items():
        props[g * R + s] = k
    for g, s in step.get("isolate", []):
        iso[g * R + s] = True
    for g, s in step.get("read", []):
        read[g * R + s] = True
    for (g, s), target in step.get("transfer", {}).items():
        tr[g * R + s] = target + 1
    tick = np.full(n, bool(step.get("tick", False)))
    return tick, camp, props, iso, tr, read


class Lockstep:
    """The JAX round and the port's round, stepped together and
    compared after every round."""

    def __init__(self, kw: dict):
        self.jcfg = jstate.BatchedConfig(**kw)
        self.tcfg = tstate.BatchedConfig(**kw)
        self.n = n = self.jcfg.num_instances
        e = self.jcfg.max_ents_per_msg
        self.jstep = jstep.make_step_round(self.jcfg)
        self.tstep = tstep.make_step_round(self.tcfg, device="cpu")
        self.jst = jstate.init_state(self.jcfg)
        self.tst = tstate.init_state(self.tcfg, device="cpu")
        self.jin = jstep.empty_msgs((n, R, jstep.NUM_KINDS), e)
        self.tin = tstep.empty_msgs((n, R, tstep.NUM_KINDS), e,
                                    device="cpu")
        self.rounds = 0

    def load(self, state: dict, inbox: dict) -> None:
        """Put both sides on the same (state, inbox), given as numpy."""
        self.jst = jstate.BatchedState(
            **{f: jnp.asarray(v) for f, v in state.items()})
        self.jin = jstep.MsgSlots(**{f: jnp.asarray(v) for f, v in inbox.items()})
        self.tst = state_from_numpy(state, device="cpu")
        self.tin = msgs_from_numpy(inbox, device="cpu")

    def set_membership(self, group: int, voters, voters_out=(),
                       learners=(), joint=False) -> None:
        """The host confchange apply point, on both sides."""
        st = jax_to_numpy(self.jst)
        rows = slice(group * R, (group + 1) * R)
        for name, slots in (("voter", voters), ("voter_out", voters_out),
                            ("learner", learners)):
            m = np.zeros(R, bool)
            m[list(slots)] = True
            st[name][rows] = m
        st["in_joint"][rows] = joint
        self.load(st, jax_to_numpy(self.jin))

    def step(self, **step) -> None:
        args = host_inputs(self.n, step)
        jo = self.jstep(self.jst, self.jin, *(jnp.asarray(a) for a in args))
        to = self.tstep(self.tst, self.tin, *(torch.as_tensor(a) for a in args))
        ctx = f"round {self.rounds} ({step})"
        (self.jst, jout), (self.tst, tout) = jo, to
        assert_same(self.jst, self.tst, f"{ctx} state")
        assert_same(jout, tout, f"{ctx} outbox")
        self.jin = jstep.route(self.jcfg, jout)
        self.tin = tstep.route(self.tcfg, tout)
        assert_same(self.jin, self.tin, f"{ctx} routed inbox")
        self.rounds += 1

    def run(self, schedule) -> "Lockstep":
        for step in schedule:
            if "membership" in step:
                self.set_membership(**step["membership"])
            self.step(**{k: v for k, v in step.items()
                         if k != "membership"})
        return self


def quiet(k: int, **step):
    return [dict(step) for _ in range(k)]


def test_route_matches_jax():
    rng = np.random.RandomState(3)
    for g in (1, 2, 5):
        n, e = g * R, 4
        out = {}
        for f in jstep.MsgSlots._fields:
            shape = (n, R, jstep.NUM_KINDS) + ((e,) if f == "ent_terms" else ())
            if f in ("valid", "reject"):
                out[f] = rng.rand(*shape) < 0.5
            else:
                out[f] = rng.randint(-5, 100, size=shape).astype(np.int32)
        jcfg = jstate.BatchedConfig(g, R, 8, e, 2)
        tcfg = tstate.BatchedConfig(g, R, 8, e, 2)
        want = jstep.route(jcfg, jstep.MsgSlots(**out))
        got = tstep.route(tcfg, msgs_from_numpy(out, device="cpu"))
        assert_same(want, got, f"route G={g}")


def test_wire_constants_match():
    assert np.array_equal(tstep.LANE_OF, jstep.LANE_OF)
    for name in ("KIND_VOTE", "KIND_APP", "KIND_HB", "KIND_VOTE_RESP",
                 "KIND_APP_RESP", "KIND_HB_RESP", "NUM_KINDS",
                 "NUM_REQ_KINDS", "T_APP", "T_APP_RESP", "T_VOTE",
                 "T_VOTE_RESP", "T_SNAP", "T_HB", "T_HB_RESP",
                 "T_TIMEOUT_NOW", "T_PREVOTE", "T_PREVOTE_RESP"):
        assert getattr(tstep, name) == getattr(jstep, name), name
    assert tstep.MsgSlots._fields == jstep.MsgSlots._fields
    assert_same(jstep.empty_msgs((4, R, 6), 3, narrow=True),
                tstep.empty_msgs((4, R, 6), 3, narrow=True, device="cpu"))


def test_contested_elections():
    """Split votes, staggered re-campaigns and sender-order tie-breaks
    in the vote-lane tournament and the tally reductions."""
    lock = Lockstep(DIFF).run(
        [{"campaign": [(0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2)]}]
        + quiet(3)
        + [{"campaign": [(0, 1), (0, 2), (1, 0), (1, 2)]}] + quiet(4)
        + [{"campaign": [(0, 0), (1, 2)]}] + quiet(4)
        + [{"propose": {(0, 0): 3, (1, 2): 2}}] + quiet(4))
    role = lock.tst.role.view(2, R)
    assert ((role == tstate.LEADER).sum(1) == 1).all()


def test_lockstep_proposals_and_heartbeats():
    """Steady replication: proposals on both leaders every round, with
    heartbeats from ticks, until the uncompacted ring is full and the
    propose headroom clamp holds the log at W - P."""
    props = {(0, 0): 4, (1, 1): 3}
    lock = Lockstep(DIFF).run(
        [{"campaign": [(0, 0), (1, 1)]}] + quiet(3)
        + quiet(30, tick=True, propose=props) + quiet(4, tick=True))
    full = DIFF["window"] - DIFF["max_props_per_round"]
    assert (lock.tst.commit == full).all()


def test_partition_and_heal():
    """A partitioned leader appends a divergent tail; the new leader's
    probe is rejected with a hint and the tail truncated on heal (the
    reject/repair column fold)."""
    iso = [(0, 0)]
    lock = Lockstep(DIFF).run(
        [{"campaign": [(0, 0)]}] + quiet(4)
        + [{"propose": {(0, 0): 2}}] + quiet(3)
        + [{"isolate": iso, "propose": {(0, 0): 3}}] + quiet(2, isolate=iso)
        + [{"isolate": iso, "campaign": [(0, 1)]}] + quiet(4, isolate=iso)
        + [{"isolate": iso, "propose": {(0, 1): 2}}] + quiet(4, isolate=iso)
        + [{"tick": True}] + quiet(6))
    c = lock.tst.commit[:R]
    assert (c == c[0]).all() and c[0] >= 4


def test_read_index():
    """ReadIndex batches confirm via ctx-echoing heartbeat acks; a read
    asked for while a batch is in flight latches."""
    lock = Lockstep(DIFF).run(
        [{"campaign": [(0, 0), (1, 1)]}] + quiet(4)
        + [{"propose": {(0, 0): 2, (1, 1): 1}}] + quiet(3)
        + [{"read": [(0, 0), (1, 1)]}] + [{"read": [(0, 0)]}] + quiet(4)
        + [{"read": [(0, 0)]}] + quiet(4))
    assert bool(lock.tst.read_ready[0]) and int(lock.tst.read_seq[0]) == 3


def test_leader_transfer():
    """Transfer to a caught-up and to a lagging peer (catch-up append,
    then TimeoutNow), a duplicate request, and a self-transfer."""
    lock = Lockstep(DIFF).run(
        [{"campaign": [(0, 0), (1, 0)]}] + quiet(4)
        + quiet(3, tick=True, propose={(0, 0): 2, (1, 0): 2})
        + [{"transfer": {(0, 0): 2, (1, 0): 0}}]
        + [{"transfer": {(0, 0): 2}}] + quiet(6, tick=True)
        + [{"isolate": [(1, 1)], "propose": {(1, 0): 4}}]
        + [{"transfer": {(1, 0): 1}}] + quiet(6, tick=True))
    leaders = (lock.tst.role == tstate.LEADER).view(2, R)
    assert bool(leaders[0, 2]) and bool(leaders[1, 1])


def test_joint_membership_and_learners():
    """Joint quorums (incoming and outgoing voter halves) and a learner
    on the commit and vote paths, through a re-election."""
    props = {(0, 0): 2, (1, 0): 1}
    lock = Lockstep(DIFF).run(
        [{"campaign": [(0, 0), (1, 0)]}] + quiet(4)
        + [{"membership": dict(group=0, voters=(0, 1), learners=(2,)),
            "propose": props}] + quiet(4, tick=True, propose=props)
        + [{"membership": dict(group=1, voters=(0, 1, 2), voters_out=(0, 1),
                               joint=True), "propose": props}]
        + quiet(4, tick=True, propose=props)
        + [{"isolate": [(1, 0)], "campaign": [(1, 2)]}]
        + quiet(6, isolate=[(1, 0)])
        + [{"membership": dict(group=1, voters=(1, 2))}]
        + quiet(6, tick=True, propose={(1, 2): 2}))
    assert int(lock.tst.commit[R + 1]) > 0


def test_compacting_ring_wraps_many_times():
    """Sustained load with auto_compact: the ring chases the applied
    mark and wraps many times."""
    props = {(g, 0): 2 for g in range(4)}
    lock = Lockstep(SUSTAINED).run(
        [{"campaign": [(g, 0) for g in range(4)]}] + quiet(4)
        + quiet(60, tick=True, propose=props))
    assert int(lock.tst.commit.min()) > 6 * SUSTAINED["window"]
    assert int(lock.tst.snap_index.min()) > 4 * SUSTAINED["window"]


def test_lagging_follower_snapshot_catch_up():
    """A follower isolated past the compaction horizon is restored
    through MsgSnap and converges (the snapshot install path)."""
    iso = [(0, 2)]
    lock = Lockstep(SUSTAINED).run(
        [{"campaign": [(g, 0) for g in range(4)]}] + quiet(4)
        + quiet(30, tick=True, isolate=iso, propose={(0, 0): 2})
        + quiet(12, tick=True))
    assert int(lock.tst.snap_index[2]) > SUSTAINED["window"]
    assert int(lock.tst.commit[2]) == int(lock.tst.commit[0])


def random_inbox(rng, st: dict, n: int, e: int, p: float) -> dict:
    """Random messages in every lane of every instance's inbox: the
    types each lane carries, terms and indexes near the receiver's."""
    shape = (n, R, tstep.NUM_KINDS)
    lane_types = [
        (jstep.T_VOTE, jstep.T_PREVOTE), (jstep.T_APP, jstep.T_SNAP),
        (jstep.T_HB, jstep.T_TIMEOUT_NOW),
        (jstep.T_VOTE_RESP, jstep.T_PREVOTE_RESP), (jstep.T_APP_RESP,),
        (jstep.T_HB_RESP, jstep.T_APP_RESP),
    ]
    typ = np.zeros(shape, np.int32)
    for k, types in enumerate(lane_types):
        typ[:, :, k] = rng.choice(types, size=(n, R))
    term = st["term"][:, None, None]
    last = st["last"][:, None, None]
    index = np.clip(last + rng.randint(-6, 4, size=shape), 0, None)
    n_ents = rng.randint(0, e + 1, size=shape)
    ent_terms = term[..., None] + np.sort(
        rng.randint(-1, 2, size=shape + (e,)), axis=-1)
    return {
        "valid": rng.rand(*shape) < p,
        "type": typ,
        "term": (term + rng.randint(-1, 2, size=shape)).astype(np.int32),
        "log_term": np.clip(term + rng.randint(-2, 2, size=shape), 0,
                            None).astype(np.int32),
        "index": index.astype(np.int32),
        "commit": np.clip(index - rng.randint(0, 3, size=shape), 0,
                          None).astype(np.int32),
        "reject": rng.rand(*shape) < 0.3,
        "reject_hint": np.clip(index - rng.randint(0, 4, size=shape), 0,
                               None).astype(np.int32),
        "n_ents": n_ents.astype(np.int32),
        "ctx": rng.randint(0, 3, size=shape).astype(np.int32),
        "ent_terms": np.where(np.arange(e) < n_ents[..., None],
                              np.clip(ent_terms, 0, None), 0).astype(np.int32),
    }


@pytest.mark.parametrize("kw, seed", [(DIFF, 0), (DIFF, 1), (DIFF, 2),
                                      (SUSTAINED, 3), (SUSTAINED, 4)],
                         ids=["diff-0", "diff-1", "diff-2", "sustained-3",
                              "sustained-4"])
def test_one_round_fuzz(kw, seed):
    """From states reached by real schedules, one round with random
    messages injected in every lane (terms, indexes, rejections,
    entries, TimeoutNow, read contexts): both rounds agree."""
    rng = np.random.RandomState(seed)
    g = kw["num_groups"]
    props = {(i, 0): 2 for i in range(g)}
    lock = Lockstep(kw).run(
        [{"campaign": [(i, i % R) for i in range(g)]}] + quiet(3)
        + quiet(6 + seed, tick=True, propose=props)
        + [{"isolate": [(0, 1)], "propose": props}])
    for _ in range(4):
        st = jax_to_numpy(lock.jst)
        inbox = random_inbox(rng, st, lock.n, kw["max_ents_per_msg"],
                             p=rng.choice([0.3, 0.7]))
        lock.load(st, inbox)
        lock.step(tick=bool(rng.rand() < 0.5),
                  read=[(i, 0) for i in range(g) if rng.rand() < 0.5],
                  propose={(i, rng.randint(R)): int(rng.randint(0, 3))
                           for i in range(g)})


def test_narrow_lanes_equal_wide():
    """narrow_lanes keeps the bounded lanes int8/int16 between rounds;
    after widening, every field and the outbox equal the wide round."""
    wide = tstate.BatchedConfig(**SUSTAINED)
    narrow = wide._replace(narrow_lanes=True)
    runs = {}
    for label, cfg in (("wide", wide), ("narrow", narrow)):
        n, e = cfg.num_instances, cfg.max_ents_per_msg
        runs[label] = [tstate.init_state(cfg, device="cpu"),
                       tstep.empty_msgs((n, R, 6), e, narrow=cfg.narrow_lanes,
                                        device="cpu"),
                       tstep.make_step_round(cfg, device="cpu")]
    schedule = ([{"campaign": [(g, g % R) for g in range(4)]}] + quiet(3)
                + quiet(20, tick=True, propose={(g, g % R): 2
                                                for g in range(4)}))
    for rnd, step in enumerate(schedule):
        args = [torch.as_tensor(a) for a in host_inputs(wide.num_instances,
                                                         step)]
        outs = {}
        for label, run in runs.items():
            st, out = run[2](run[0], run[1], *args)
            run[0], run[1] = st, tstep.route(wide, out)
            outs[label] = (st, out)
        (ws, wo), (ns, no) = outs["wide"], outs["narrow"]
        assert ns.role.dtype == torch.int8 and no.type.dtype == torch.int8
        assert_same(ws, tstate.widen_state(ns), f"round {rnd} state")
        assert_same(wo, tstep.widen_msgs(no), f"round {rnd} outbox")


def test_aux_reports_pre_propose_watermark():
    """with_aux adds StepAux and changes nothing else; last_tick is the
    log watermark just before proposals append."""
    cfg = tstate.BatchedConfig(**SUSTAINED)
    n = cfg.num_instances
    plain = tstep.make_step_round(cfg, device="cpu")
    aux_step = tstep.make_step_round(cfg, with_aux=True, device="cpu")
    st = tstate.init_state(cfg, device="cpu")
    inbox = tstep.empty_msgs((n, R, 6), cfg.max_ents_per_msg, device="cpu")
    schedule = [{"campaign": [(0, 0)]}] + quiet(3) + [{"propose": {(0, 0): 2}}]
    for step in schedule:
        args = [torch.as_tensor(a) for a in host_inputs(n, step)]
        st1, out1 = plain(st, inbox, *args)
        st2, out2, aux = aux_step(st, inbox, *args)
        assert_same(st1, st2)
        assert_same(out1, out2)
        before, st, inbox = st, st2, tstep.route(cfg, out2)
    assert int(aux.last_tick[0]) == int(before.last[0])
    assert int(st.last[0]) == int(before.last[0]) + 2
    assert aux.read_index.dtype == torch.int32
    assert aux.read_ready.dtype == torch.bool


def test_convert_roundtrip():
    cfg = tstate.BatchedConfig(**SUSTAINED)
    st = tstate.init_state(cfg, start_index=5, device="cpu")
    back = state_from_numpy(state_to_numpy(st), device="cpu")
    assert all(torch.equal(a, b) and a.dtype == b.dtype
               for a, b in zip(st, back))
    m = tstep.empty_msgs((cfg.num_instances, R, 6), 4, narrow=True,
                         device="cpu")
    back = msgs_from_numpy(msgs_to_numpy(m), device="cpu")
    assert all(torch.equal(a, b) and a.dtype == b.dtype
               for a, b in zip(m, back))
    with pytest.raises(KeyError):
        state_from_numpy({"term": np.zeros(3, np.int32)}, device="cpu")
