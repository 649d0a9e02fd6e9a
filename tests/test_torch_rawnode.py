"""PyTorch port ↔ JAX reference: the hosted entry point, BatchedRawNode.

The same seeded schedule runs through a set of ``etcd_tpu`` rawnodes
and a set of ``etcd_tpu_torch`` rawnodes (device="cpu"), each set
routing its own traffic through the same synchronous router (seeded
record loss, and blocks held back a round so that they arrive after
newer ones and leave residuals). After every advance of every member
the two Readys are compared whole (the digest of
tests/batched/test_tracing.py, entries with payloads and etypes,
snapshots, read states, snap rings, traced keys, the messages field by
field) and so is every device state field, host mirror, arena, fleet
frame and hub record. All of it is int32/int64/bool or bytes, so every
comparison is exact.

The JAX side only builds round programs the batched suite already
compiles (ROADMAP rule 3):

* HOSTED_CFG, the three-member hosted config of
  tests/batched/test_deliver_shapes.py (G=4, W=16, E=4, P=2, HB=1,
  narrow lanes);
* test_chaos.CFG (G=8, pre-vote, check-quorum, auto-compaction, fleet
  on), three hosted members ticked every round, so leaders come from
  timer elections;
* DENSE_CFG, the dense config of tests/batched/test_msgblock.py (G=4,
  W=8, E=2, P=1), one all-replica rawnode per package.
"""

import dataclasses

import numpy as np
import pytest
import torch

from etcd_tpu.batched import msgblock as jmb
from etcd_tpu.batched.rawnode import BatchedRawNode as JRawNode
from etcd_tpu.batched.rawnode import RowRestore as JRowRestore
from etcd_tpu.batched.state import BatchedConfig as JConfig
from etcd_tpu.obs.fleet import FleetHub as JFleetHub
from etcd_tpu.obs.tracer import Tracer as JTracer
from etcd_tpu.pkg import metrics as jmet
from etcd_tpu_torch.batched import msgblock as tmb
from etcd_tpu_torch.batched.rawnode import BatchedRawNode as TRawNode
from etcd_tpu_torch.batched.rawnode import RowRestore as TRowRestore
from etcd_tpu_torch.batched.state import LEADER, PRECANDIDATE, BatchedConfig
from etcd_tpu_torch.batched.step import KIND_HB, NUM_KINDS, T_HB, T_SNAP
from etcd_tpu_torch.batched.telemetry import TM_INDEX, TelemetryHub
from etcd_tpu_torch.obs.fleet import FleetHub as TFleetHub
from etcd_tpu_torch.obs.tracer import Tracer as TTracer
from etcd_tpu_torch.pkg import metrics as tmet

from .batched.test_chaos import CFG as CHAOS_CFG
from .batched.test_tracing import digest

R = 3
MEMBERS = (1, 2, 3)

HOSTED_CFG = JConfig(
    num_groups=4, num_replicas=R, window=16, max_ents_per_msg=4,
    max_props_per_round=2, election_timeout=1 << 20, heartbeat_timeout=1,
    narrow_lanes=True, deliver_shape="vectorized")
DENSE_CFG = JConfig(num_groups=4, num_replicas=R, window=8,
                    max_ents_per_msg=2, max_props_per_round=1,
                    election_timeout=1 << 20)

PKGS = {"jax": (JRawNode, JConfig, JRowRestore, jmb),
        "torch": (TRawNode, BatchedConfig, TRowRestore, tmb)}
# Each package's own tracer, fleet hub and metrics module.
OBS = {"jax": (JTracer, JFleetHub, jmet), "torch": (TTracer, TFleetHub, tmet)}
MIRRORS = ("m_term", "m_vote", "m_commit", "m_last", "m_snap", "m_role",
           "m_lead", "m_ring", "m_lease_ticks", "applied", "stable")


def make(pkg, cfg, groups=None, slots=None, **kw):
    rn_cls, cfg_cls, _, _ = PKGS[pkg]
    if pkg == "torch":
        kw["device"] = "cpu"
    return rn_cls(cfg_cls(**cfg._asdict()), groups=groups, slots=slots, **kw)


def state_np(rn, pkg):
    st = rn.state
    if pkg == "jax":
        return {f: np.asarray(getattr(st, f)) for f in st._fields}
    return {f: getattr(st, f).numpy() for f in st._fields}


def hub_records(hub):
    return [{k: v for k, v in rec.items() if k != "t"}
            for rec in hub.records()]


def assert_ready_equal(a, b, ctx):
    assert digest(a) == digest(b), ctx
    assert a.snapshots == b.snapshots, ctx
    assert a.read_opened == b.read_opened, ctx
    assert a.contains_updates() == b.contains_updates(), ctx
    assert a.traced_entries == b.traced_entries, ctx
    assert a.traced_commit == b.traced_commit, ctx
    for f in ("rows", "idx", "term", "etype"):
        x, y = getattr(a.entries, f), getattr(b.entries, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), (ctx, f)
    assert [(r, dataclasses.asdict(m)) for r, m in a.messages] == [
        (r, dataclasses.asdict(m)) for r, m in b.messages], ctx
    assert sorted(a.snap_rings) == sorted(b.snap_rings), ctx
    for row, ring in a.snap_rings.items():
        got = b.snap_rings[row]
        assert got.dtype == ring.dtype and np.array_equal(got, ring), ctx


def assert_rawnodes_equal(j, t, ctx):
    want, got = state_np(j, "jax"), state_np(t, "torch")
    assert list(got) == list(want), ctx
    for f, w in want.items():
        g = got[f]
        assert g.dtype == w.dtype and np.array_equal(g, w), (ctx, f, g, w)
    for f in MIRRORS:
        w, g = getattr(j, f), getattr(t, f)
        assert g.dtype == w.dtype and np.array_equal(g, w), (ctx, f)
    assert t.arena == j.arena, ctx
    assert t.etypes == j.etypes, ctx
    assert [t.pending_proposals(r) for r in range(t.n)] == [
        j.pending_proposals(r) for r in range(j.n)], ctx
    w, g = j.peer_match(), t.peer_match()
    assert g.dtype == w.dtype and np.array_equal(g, w), ctx
    assert np.array_equal(t.leader_rows(), j.leader_rows()), ctx
    assert t.has_work() == j.has_work(), ctx
    for r in range(t.n):
        assert (t.lead(r), t.is_leader(r), t.latest_commit(r)) == (
            j.lead(r), j.is_leader(r), j.latest_commit(r)), ctx
    if j.cfg.fleet_summary:
        w, g = j.last_fleet, t.last_fleet
        assert g.dtype == w.dtype and np.array_equal(g, w), ctx
    if j.fleet_hub is not None:
        assert hub_records(t.fleet_hub) == hub_records(j.fleet_hub), ctx


class Net:
    """The synchronous router of test_tracing.pump, with seeded faults:
    each routed sub-block loses records with probability `drop`, and
    with probability `delay` is held back and delivered at the end of
    the next round, after newer blocks on the same link (so a key's
    older record arrives second and the newer one waits in the
    residual). MsgSnap goes through the object path after its app
    state is "restored" (install_snapshot_state), as hosting does."""

    def __init__(self, rns, seed, drop=0.0, delay=0.0, route=None):
        self.rns = rns
        self.rng = np.random.RandomState(seed)
        self.drop, self.delay = drop, delay
        self.held, self.due = [], []
        self.snaps = 0
        # route(blk) -> [(receiver, block)]: the hosted default sends
        # each sub-block to the member named by its target id.
        self.route = route or (lambda blk: sorted(
            blk.split_by_target().items()))

    def deliver(self, rd):
        blk = rd.msg_block
        if blk is not None and len(blk):
            for to, sub in self.route(blk):
                if self.drop:
                    sub = sub.take(self.rng.rand(len(sub)) >= self.drop)
                if self.delay and self.rng.rand() < self.delay:
                    self.held.append((to, sub))
                    continue
                self.rns[to].step_block(sub)
        for row, m in rd.messages:
            if int(m.type) == T_SNAP:
                self.snaps += 1
                self.rns[m.to].install_snapshot_state(
                    row, m.snapshot.metadata.index)
            self.rns[m.to].step(row, m)

    def end_round(self):
        for to, sub in self.due:
            self.rns[to].step_block(sub)
        self.due, self.held = self.held, []


class Side:
    """One package's three hosted members and their router."""

    def __init__(self, pkg, cfg, seed, tracer=False, fleet_hub=False,
                 restore=None, **net):
        g = cfg.num_groups
        self.pkg = pkg
        self.rns = {}
        tracer_cls, hub_cls, met = OBS[pkg]
        for mid in MEMBERS:
            rn = make(pkg, cfg, np.arange(g, dtype=np.int32),
                      np.full(g, mid - 1, np.int32),
                      restore=restore(pkg, mid) if restore else None)
            if tracer:
                rn.tracer = tracer_cls(member=str(mid), sample=1, seed=0,
                                       registry=met.Registry())
            if fleet_hub:
                rn.fleet_hub = hub_cls(g, R, g, member=str(mid),
                                       registry=met.Registry())
            self.rns[mid] = rn
        self.net = Net(self.rns, seed, **net)

    def member_round(self, mid):
        rn = self.rns[mid]
        rd = rn.advance_round()
        self.net.deliver(rd)
        if rn.tracer is not None:
            for stage in ("fsync_wait", "fsync", "send"):
                rn.tracer.stamp_many(rd.traced_entries, stage)
            rn.tracer.stamp_many(rd.traced_commit, "apply")
        rn.advance()
        return rd


def run_rounds(sides, rounds, before=None):
    """`rounds` rounds of every member on both sides in lockstep; the
    sides compared after every member's advance. `before(rnd, side)`
    stages the round's inputs on a side."""
    j, t = sides["jax"], sides["torch"]
    out = []
    for rnd in range(rounds):
        if before is not None:
            for side in (j, t):
                before(rnd, side)
        for mid in j.rns:
            a, b = j.member_round(mid), t.member_round(mid)
            ctx = f"round {rnd} member {mid}"
            assert_ready_equal(a, b, ctx)
            assert_rawnodes_equal(j.rns[mid], t.rns[mid], ctx)
            out.append(b)
        j.net.end_round()
        t.net.end_round()
    return out


def leaders(side):
    """group -> leader member id, from the mirrors of `side`."""
    out = {}
    for mid, rn in side.rns.items():
        for row in np.nonzero(rn.m_role == LEADER)[0].tolist():
            out[row] = mid
    return out


def propose_on_leaders(side, rng_state, per_group, conf_every=0):
    """Seeded payloads on every group's current leader (the same on
    both sides: each side draws from its own copy of the stream)."""
    rng = np.random.RandomState(rng_state)
    lead = leaders(side)
    for g in sorted(lead):
        for k in range(per_group):
            etype = 1 if conf_every and (g + k) % conf_every == 0 else 0
            side.rns[lead[g]].propose(
                g, rng.bytes(int(rng.randint(1, 40))), etype=etype)


def both(cfg, seed, **kw):
    return {pkg: Side(pkg, cfg, seed, **kw) for pkg in PKGS}


# -- the three configs ---------------------------------------------------------


def test_hosted_members_match_jax():
    """HOSTED_CFG: campaigns, proposals (normal and conf-change
    etypes), heartbeat ticks, loss and reordering, leader transfer,
    ReadIndex, set_fence, set_membership_many, compact, poke_append and
    isolation."""
    sides = both(HOSTED_CFG, seed=11, drop=0.1, delay=0.25)
    g = HOSTED_CFG.num_groups

    def before(rnd, side):
        rns = side.rns
        if rnd == 0:
            rns[1].campaign([0, 1])
            rns[2].campaign([2, 3])
        for rn in rns.values():
            rn.tick()
        if rnd >= 3 and rnd % 2 == 1:
            propose_on_leaders(side, 1000 + rnd, 1, conf_every=3)
        lead = leaders(side)
        if rnd == 9:
            rns[lead[0]].transfer_leader(0, 2)
        if rnd in (10, 17):
            for grp, mid in lead.items():
                rns[mid].read_index(grp)
        if rnd == 12:
            rns[3].set_fence(1, True)
        if rnd == 16:
            rns[3].set_fence(1, False)
        if rnd == 13:
            for rn in rns.values():
                rn.set_membership_many(
                    [2], [[True, True, False]], [[False] * 3],
                    [[False, False, True]], [False])
        if rnd == 19:
            for rn in rns.values():
                rn.set_membership(2, voters=(0, 1, 2))
        if rnd == 14:
            for grp, mid in lead.items():
                rns[mid].compact(grp, int(rns[mid].m_commit[grp]) - 1)
                rns[mid].poke_append(grp)
        if rnd == 15:
            rns[3].isolate([3])
        if rnd == 20:
            rns[3].isolate([3], on=False)

    readies = run_rounds(sides, 26, before)
    t = sides["torch"]
    assert any(rd.read_states for rd in readies)
    assert any(len(rd.entries) and rd.entries.etype.any() for rd in readies)
    assert leaders(t)[0] == 3  # the transfer landed
    commits = np.stack([rn.m_commit for rn in t.rns.values()])
    assert (commits.min(axis=0) >= 8).all(), commits
    # Leaders drained their queues; proposals staged on a member that
    # lost the lead (the transfer) wait there, as in the reference.
    assert all(t.rns[mid].pending_proposals(grp) == 0
               for grp, mid in leaders(t).items())
    assert sum(rn.pending_proposals(grp) for rn in t.rns.values()
               for grp in range(g)) > 0


def test_chaos_config_timer_elections_prevote_check_quorum():
    """test_chaos.CFG with ticks every round: leaders come from timer
    elections with pre-vote; a member cut off for long enough has its
    leaderships deposed by check-quorum, and once back it is sent
    MsgSnap (auto-compaction moved the floors past its log). Each side
    has its own package's Tracer and FleetHub attached, and the hubs'
    records are compared after every member round."""
    sides = both(CHAOS_CFG, seed=22, drop=0.05, delay=0.1, tracer=True,
                 fleet_hub=True)
    g = CHAOS_CFG.num_groups
    roles, cut_off = [], {}

    def before(rnd, side):
        for rn in side.rns.values():
            rn.tick()
        if rnd >= 26:
            propose_on_leaders(side, 2000 + rnd, 3 if rnd < 50 else 1)
        if rnd == 30:
            side.rns[3].isolate(np.arange(g))
        if rnd == 50:
            cut_off[side.pkg] = leaders(side)
            side.rns[3].isolate(np.arange(g), on=False)
        if side.pkg == "torch":
            roles.append(np.stack([rn.m_role for rn in side.rns.values()]))

    readies = run_rounds(sides, 66, before)
    t = sides["torch"]
    assert (np.stack(roles) == PRECANDIDATE).any()
    assert len(leaders(t)) == g
    assert t.net.snaps > 0
    assert any(rd.snapshots for rd in readies)
    assert any(rd.traced_commit for rd in readies)
    # At the end of the cut, members 1 and 2 lead every group.
    assert sorted(cut_off["torch"]) == list(range(g))
    assert set(cut_off["torch"].values()) <= {1, 2}
    assert (roles[20][2] == LEADER).any()  # member 3 led before the cut
    commits = np.stack([rn.m_commit for rn in t.rns.values()])
    assert (commits.max(axis=0) > CHAOS_CFG.window).all()


def dense_route(mod, mode):
    """Route a dense rawnode's block back to itself: record row (the
    sender's row g*R+s) becomes the receiver's row g*R+to-1, through a
    wire round trip ("block") or as Message objects ("object")."""
    def route(blk):
        rec = blk.rec.copy()
        rec["row"] = rec["row"] // R * R + rec["to"] - 1
        fixed = mod.MsgBlock(rec, ent_term=blk.ent_term,
                             ent_etype=blk.ent_etype, ent_len=blk.ent_len,
                             payload=blk.payload, ent_counts=blk.ent_counts)
        if mode == "block":
            return [(0, mod.MsgBlock.from_bytes(fixed.to_bytes()))]
        return [(0, fixed)]
    return route


class DenseSide:
    """One dense all-replica rawnode routing its own traffic."""

    def __init__(self, pkg, mode, seed):
        self.pkg = pkg
        self.rn = make(pkg, DENSE_CFG)
        self.rns = {0: self.rn}
        mod = PKGS[pkg][3]
        self.net = Net({0: self}, seed, delay=0.2,
                       route=dense_route(mod, mode))
        self.net.rns = {to: self for to in range(R + 1)}
        self.mode, self.mod = mode, mod

    # The router's receiver: blocks in, or their messages one by one.
    def step_block(self, blk):
        if self.mode == "block":
            self.rn.step_block(blk)
        else:
            for row, m in self.mod.block_messages(blk):
                self.rn.step(row, m)

    def install_snapshot_state(self, row, index):
        raise AssertionError("the dense schedule compacts no log")

    def step(self, row, m):
        self.rn.step(row // R * R + m.to - 1, m)

    def member_round(self, _mid):
        rd = self.rn.advance_round()
        self.net.deliver(rd)
        self.rn.advance()
        return rd


@pytest.mark.parametrize("mode", ["object", "block"])
def test_dense_rawnode_matches_jax(mode):
    """DENSE_CFG, one all-replica rawnode per package, its traffic fed
    back through the object path or through wire-round-tripped
    blocks."""
    sides = {pkg: DenseSide(pkg, mode, seed=33) for pkg in PKGS}
    n = DENSE_CFG.num_instances

    def before(rnd, side):
        rn = side.rn
        if rnd == 0:
            rn.campaign([0, 3, 7, 11])
        rn.tick()
        if rnd >= 3:
            rng = np.random.RandomState(3000 + rnd)
            for row in np.nonzero(rn.m_role == LEADER)[0].tolist():
                rn.propose(row, rng.bytes(8), etype=int(rnd % 5 == 0))
        if rnd == 8:
            rn.read_index(int(np.nonzero(rn.m_role == LEADER)[0][0]))

    readies = run_rounds(sides, 16, before)
    rn = sides["torch"].rn
    assert (rn.m_role == LEADER).sum() == DENSE_CFG.num_groups
    assert rn.m_commit.min() >= 6, rn.m_commit
    assert any(rd.read_states for rd in readies)
    assert len(rn.groups) == n


def test_garbage_frame_dropped_alike():
    """The garbage frame of tests/batched/test_msgblock.py: rows out of
    range, frm 0 and 200, a type past the table. Both packages drop it
    whole and step on unchanged."""
    garbage = np.zeros(3, jmb.REC_DTYPE)
    garbage["row"] = [999999, 0, 1]
    garbage["frm"] = [1, 0, 200]
    garbage["lane"] = [KIND_HB, KIND_HB, 5]
    garbage["type"] = [T_HB, T_HB, 255 % 32]
    import struct

    frame = (struct.pack("<BI", jmb.WIRE_VERSION, len(garbage))
             + garbage.tobytes() + struct.pack("<I", 0))
    rns = {}
    for pkg in PKGS:
        rn = make(pkg, DENSE_CFG)
        rn.step_block(PKGS[pkg][3].MsgBlock.from_bytes(frame))
        rns[pkg] = (rn, rn.advance_round())
        rn.advance()
    (j, a), (t, b) = rns["jax"], rns["torch"]
    assert_ready_equal(a, b, "garbage")
    assert_rawnodes_equal(j, t, "garbage")
    assert (t.m_term == 0).all()


def restore_map(pkg, mid):
    """Per-row boot state for member `mid`: a shared committed prefix,
    a member-specific uncommitted tail, a conf-change entry, one fenced
    row and one row booted from a snapshot floor."""
    rr_cls = PKGS[pkg][2]
    out = {}
    for row in range(HOSTED_CFG.num_groups):
        ents = [(i, 1 + (i > 3), b"boot-%d-%d" % (row, i)) for i in
                range(1, 5)]
        ents.append((5, 2, b"conf-%d" % row, 1))
        if mid == 3:
            ents = ents[:3]
        snap = 2 if row == 2 else 0
        out[row] = rr_cls(
            term=2, vote=(row % R) + 1 if mid != 2 else 0, commit=3,
            applied=3 if row != 1 else 2, snap_index=snap,
            snap_term=1 if snap else 0,
            entries=[e for e in ents if e[0] > snap],
            fenced=(row == 1 and mid == 2))
    return out


def test_boot_from_restore_matches_jax():
    """The same RowRestore map boots both packages (narrow lanes: the
    vote lane restores at its int8 storage dtype), then elections and
    proposals run on the restored logs."""
    assert [f.name for f in dataclasses.fields(TRowRestore)] == [
        f.name for f in dataclasses.fields(JRowRestore)]
    assert TRowRestore() == TRowRestore(**dataclasses.asdict(JRowRestore()))
    sides = both(HOSTED_CFG, seed=44, restore=restore_map)
    for mid in MEMBERS:
        assert_rawnodes_equal(sides["jax"].rns[mid],
                              sides["torch"].rns[mid], f"boot {mid}")
    assert sides["torch"].rns[1].state.vote.dtype == torch.int8

    def before(rnd, side):
        if rnd == 0:
            side.rns[1].campaign([0, 1, 2, 3])
        if rnd == 6:
            side.rns[2].set_fence(1, False)
        if rnd >= 3:
            propose_on_leaders(side, 4000 + rnd, 1)
        for rn in side.rns.values():
            rn.tick()

    readies = run_rounds(sides, 12, before)
    assert any(rd.committed for rd in readies)
    assert (sides["torch"].rns[2].m_commit >= 5).all()


def test_mixed_cluster_reads_each_others_frames():
    """One etcd_tpu member and two port members in one cluster, every
    block crossing as wire bytes decoded by the receiver's own package:
    the same Readys and state as an all-etcd_tpu cluster on the same
    schedule."""
    g = HOSTED_CFG.num_groups

    def cluster(pkgs):
        return {mid: make(pkg, HOSTED_CFG, np.arange(g, dtype=np.int32),
                          np.full(g, mid - 1, np.int32))
                for mid, pkg in zip(MEMBERS, pkgs)}

    mixed = cluster(("jax", "torch", "torch"))
    pure = cluster(("jax", "jax", "jax"))
    for rnd in range(14):
        for rns in (mixed, pure):
            if rnd == 0:
                rns[1].campaign([0, 1])
                rns[2].campaign([2, 3])
            for rn in rns.values():
                rn.tick()
            if rnd in (4, 6, 9):
                rng = np.random.RandomState(rnd)
                for grp in range(g):
                    rns[1 if grp < 2 else 2].propose(grp, rng.bytes(12))
        for mid in MEMBERS:
            rds = []
            for rns in (mixed, pure):
                rd = rns[mid].advance_round()
                for to, sub in sorted(rd.msg_block.split_by_target().items()):
                    mod = tmb if isinstance(rns[to], TRawNode) else jmb
                    rns[to].step_block(mod.MsgBlock.from_bytes(sub.to_bytes()))
                for row, m in rd.messages:
                    rns[m.to].step(row, m)
                rns[mid].advance()
                rds.append(rd)
            assert digest(rds[0]) == digest(rds[1]), (rnd, mid)
    for mid in (2, 3):
        assert_rawnodes_equal(pure[mid], mixed[mid], f"member {mid}")
    assert (mixed[3].m_commit >= 4).all(), mixed[3].m_commit


# -- the port's own contracts ---------------------------------------------------


def test_refused_features_name_their_roadmap_item():
    """`mesh=` is refused with the ROADMAP item that ports it. The apply
    plane is ported: a plane-on rawnode builds, and the plane hooks of a
    plane-off one refuse (as the reference's assert) or return nothing."""
    with pytest.raises(NotImplementedError, match="A12"):
        TRawNode(BatchedConfig(**HOSTED_CFG._asdict()), mesh=object(),
                 device="cpu")
    cfg = BatchedConfig(**HOSTED_CFG._replace(apply_plane=True)._asdict())
    assert TRawNode(cfg, device="cpu").plane is not None
    rn = make("torch", HOSTED_CFG, np.arange(4, dtype=np.int32),
              np.zeros(4, np.int32))
    assert rn.plane is None and rn.drain_plane_events() == []
    for call in (lambda: rn.watch_set(0, 0, 1),
                 lambda: rn.plane_restore_row(0, [], [], [], [], 0, 0,
                                              False),
                 lambda: rn.plane_capture([0])):
        with pytest.raises(AssertionError, match="apply plane is off"):
            call()


def test_rawnode_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        TRawNode(BatchedConfig(**HOSTED_CFG._asdict()))


def test_narrow_staging_dtypes():
    """Under narrow lanes the staged inbox holds int8 wire types and
    int16 entry counts (the JAX rawnode's _build_inbox dtypes); the
    device inbox buffers and the state keep their narrow dtypes."""
    rn = make("torch", HOSTED_CFG, np.arange(4, dtype=np.int32),
              np.zeros(4, np.int32))
    stage = dict(zip(rn._inbox._fields, rn._stage_np))
    assert stage["type"].dtype == np.int8
    assert stage["n_ents"].dtype == np.int16
    assert stage["term"].dtype == np.int32
    assert rn._inbox.type.dtype == torch.int8
    rn.campaign([0])
    rn.advance_round()
    rn.advance()
    assert rn.state.role.dtype == torch.int8 and rn.m_role.dtype == np.int8


def test_telemetry_frames_and_hub_records():
    """The rawnode's telemetry path (a config the JAX suite has no
    rawnode program for, so held within the port): protocol output equal
    with telemetry on and off, conf_changes_applied counted on the rows
    whose masks were staged, and the hub receiving each frame with the
    outbox's per-lane counts (lane_summary) as its extra."""
    cfgs = [BatchedConfig(**HOSTED_CFG._replace(telemetry=on)._asdict())
            for on in (False, True)]
    g = HOSTED_CFG.num_groups
    sets = [{mid: TRawNode(cfg, groups=np.arange(g, dtype=np.int32),
                           slots=np.full(g, mid - 1, np.int32),
                           device="cpu") for mid in MEMBERS}
            for cfg in cfgs]
    hub = TelemetryHub(g, registry=tmet.Registry(), dump_on_trip=False)
    sets[1][1].telemetry_hub = hub
    lanes = []
    for rnd in range(8):
        for rns in sets:
            if rnd == 0:
                rns[1].campaign(list(range(g)))
            if rnd == 4:
                rns[1].set_membership(2, voters=(0, 1, 2))
            if rnd == 3:
                rns[1].propose(1, b"tel")
        for mid in MEMBERS:
            rds = []
            for rns in sets:
                rd = rns[mid].advance_round()
                blk = rd.msg_block
                for to, sub in sorted(blk.split_by_target().items()):
                    rns[to].step_block(sub)
                rns[mid].advance()
                rds.append(rd)
            assert digest(rds[0]) == digest(rds[1])
            counters, inv = sets[1][mid].last_frame
            assert counters.shape == (g, len(TM_INDEX)) and not inv.any()
            conf = counters[:, TM_INDEX["conf_changes_applied"]]
            assert conf.tolist() == ([0, 0, 1, 0] if (rnd, mid) == (4, 1)
                                     else [0] * g)
            if mid == 1:
                per_lane = np.zeros(NUM_KINDS, int)
                np.add.at(per_lane, rds[1].msg_block.rec["lane"], 1)
                lanes.append(per_lane.tolist())
    assert [rec["extra"]["outbox_lanes"] for rec in hub.records()] == lanes
    assert sum(map(sum, lanes)) > 0
