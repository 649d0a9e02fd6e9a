"""PyTorch port ↔ JAX reference: the raft.Node boundary, BatchedNode.

Three ``etcd_tpu`` BatchedNodes and three ``etcd_tpu_torch``
BatchedNodes (device="cpu") run the same seeded schedule through the
same synchronous pump (the shape of test_features.TestNodeContract's
``_pump``): every member ticks, then each in turn runs ``ready()``, the
app applies its committed conf changes, its messages are stepped into
their targets, and it advances. After every member's ``ready()`` the
two Readys are compared field for field (hard and soft state, entries,
committed entries, every message with its snapshot, read states,
must_sync), and after every round each member's ``status()``. All of
it is ints, enums and bytes, so every comparison is exact.

Every node is ``BatchedNode(i, [1, 2, 3], election_tick=4)`` or a boot
variant of it (restore, boot_conf_state), test_features' node config:
R=3, W=256, E=8, P=8, pre-vote and check-quorum, so the JAX side builds
no round program the batched suite does not already compile.
"""

import dataclasses
import enum

import numpy as np
import pytest

from etcd_tpu.batched import node as jnode
from etcd_tpu.batched.rawnode import RowRestore as JRowRestore
from etcd_tpu.raft import types as jtypes
from etcd_tpu_torch.batched import node as tnode
from etcd_tpu_torch.batched.rawnode import RowRestore as TRowRestore
from etcd_tpu_torch.raft import types as ttypes

PKGS = {"jax": (jnode, jtypes, JRowRestore),
        "torch": (tnode, ttypes, TRowRestore)}
IDS = (1, 2, 3)


def plain(x):
    """A dataclass tree (or an object tree, as the tracker's config) as
    plain values, enums as ints and sets sorted, for an exact comparison
    across the two packages' classes."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,
                {f.name: plain(getattr(x, f.name))
                 for f in dataclasses.fields(x)})
    if isinstance(x, enum.Enum):
        return int(x)
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (set, frozenset)):
        return sorted(plain(v) for v in x)
    if hasattr(x, "__dict__"):  # the tracker's config classes
        return (type(x).__name__, plain(vars(x)))
    return x


class Side:
    """One package's three nodes, their pump and their app."""

    def __init__(self, pkg, boot=None):
        self.node_mod, self.t, self.rr = PKGS[pkg]
        kw = {"device": "cpu"} if pkg == "torch" else {}
        self.nodes = {i: self.node_mod.BatchedNode(
            i, list(IDS), election_tick=4,
            **(boot(self, i) if boot else {}), **kw) for i in IDS}
        self.cut = set()  # members whose messages are dropped both ways
        self.dropped = []  # ProposalDroppedError texts, in order
        self.snaps = []  # (member, index) of every installed snapshot
        self.reads = []  # (member, index, ctx) of every read state

    def leader(self):
        lead = [i for i, n in self.nodes.items() if n.rn.is_leader(0)]
        return lead[0] if len(lead) == 1 else 0

    def apply(self, i, rd):
        t = self.t
        for e in rd.committed_entries:
            if e.type == t.EntryType.EntryConfChange and e.data:
                self.nodes[i].apply_conf_change(t.ConfChange.unmarshal(e.data))
            elif e.type == t.EntryType.EntryConfChangeV2:
                self.nodes[i].apply_conf_change(
                    t.ConfChangeV2.unmarshal(e.data))
        if rd.snapshot.metadata.index:
            self.snaps.append((i, rd.snapshot.metadata.index))
        self.reads += [(i, rs.index, rs.request_ctx) for rs in rd.read_states]

    def route(self, i, rd):
        for m in rd.messages:
            if i in self.cut or m.to in self.cut:
                continue
            try:
                self.nodes[m.to].step(m)
            except self.node_mod.ProposalDroppedError as e:
                self.dropped.append(str(e))

    def member(self, i):
        """One member's turn: its Ready (as plain values, taken before
        routing, which may edit a MsgSnap in place), then apply, route
        and advance."""
        n = self.nodes[i]
        rd = n.ready(timeout=0)
        if rd is None:
            return None
        got = plain(rd)
        self.apply(i, rd)
        self.route(i, rd)
        n.advance()
        return got


def both(boot=None):
    return {pkg: Side(pkg, boot) for pkg in PKGS}


def pump(sides, rounds=1, tick=True, until=None):
    """`rounds` lockstep rounds (stopping early once `until(jax side)`
    holds); both sides compared after every member's Ready and every
    round's statuses. Returns the rounds run."""
    j, t = sides["jax"], sides["torch"]
    for rnd in range(rounds):
        for side in (j, t):
            if tick:
                for n in side.nodes.values():
                    n.tick()
        for i in IDS:
            a, b = j.member(i), t.member(i)
            assert a == b, f"round {rnd} member {i}"
        for i in IDS:
            assert plain(j.nodes[i].status()) == plain(t.nodes[i].status())
            assert j.nodes[i].has_ready() == t.nodes[i].has_ready()
        assert (j.dropped, j.snaps) == (t.dropped, t.snaps)
        if until is not None and until(j):
            return rnd + 1
    assert until is None, "condition not reached"
    return rounds


def do(sides, fn):
    """The same action on both sides; its results must be equal."""
    got = [plain(fn(side)) for side in sides.values()]
    assert got[0] == got[1]
    return got[0]


def conf_of(side, i):
    return side.nodes[i]._current_conf_state()


def settled(side, lead=None, members=IDS):
    """A single leader (`lead`, if given) that `members` know."""
    want = side.leader() if lead is None else lead
    return want != 0 and side.leader() == want and all(
        side.nodes[i].rn.lead(0) == want for i in members)


def elect(sides, members=IDS):
    pump(sides, 40, until=lambda s: settled(s, members=members))
    lead = sides["jax"].leader()
    assert lead == sides["torch"].leader() != 0
    return lead


def propose(sides, seed, count, forward=True):
    """`count` seeded payloads, a third of them (with `forward`) handed
    to a follower, which forwards them to the leader."""
    rng = np.random.RandomState(seed)
    lead = sides["jax"].leader()
    for k in range(count):
        data = rng.bytes(int(rng.randint(1, 64)))
        via = lead if not forward or k % 3 else [
            i for i in IDS if i != lead][k % 2]
        for side in sides.values():
            side.nodes[via].propose(data)


def test_node_schedule_matches_jax():
    sides = both()
    lead = elect(sides)
    j = sides["jax"]

    # Proposals at the leader and forwarded from followers.
    propose(sides, 1, 24)
    pump(sides, 8)

    # ReadIndex: a batch opens, then a later waiter joins while the
    # first batch is in flight and must wait for a batch of its own.
    do(sides, lambda s: s.nodes[lead].read_index(b"rctx-1"))
    pump(sides, 1)
    do(sides, lambda s: s.nodes[lead].read_index(b"rctx-2"))
    pump(sides, 6)
    assert [r[2] for r in j.reads] == [b"rctx-1", b"rctx-2"]
    assert j.reads == sides["torch"].reads
    with pytest.raises(jnode.ProposalDroppedError):
        j.nodes[lead % 3 + 1].read_index(b"x")
    with pytest.raises(tnode.ProposalDroppedError):
        sides["torch"].nodes[lead % 3 + 1].read_index(b"x")

    # Leadership transfer: direct, then forwarded by a follower.
    target = lead % 3 + 1
    do(sides, lambda s: s.nodes[lead].transfer_leadership(lead, target))
    pump(sides, 20, until=lambda s: settled(s, target))
    lead = target
    other = lead % 3 + 1
    do(sides, lambda s: s.nodes[other].transfer_leadership(lead, other))
    pump(sides, 20, until=lambda s: settled(s, other))
    lead = other
    propose(sides, 2, 9)
    pump(sides, 6)

    # A v1 remove and re-add of a voter.
    t = {pkg: s.t for pkg, s in sides.items()}
    victim = lead % 3 + 1
    for pkg, side in sides.items():
        side.nodes[lead].propose_conf_change(t[pkg].ConfChange(
            id=1, type=t[pkg].ConfChangeType.ConfChangeRemoveNode,
            node_id=victim))
    pump(sides, 20, until=lambda s: victim not in conf_of(s, lead).voters)
    pump(sides, 2)
    propose(sides, 3, 6, forward=False)
    pump(sides, 4)
    for pkg, side in sides.items():
        side.nodes[lead].propose_conf_change(t[pkg].ConfChange(
            id=2, type=t[pkg].ConfChangeType.ConfChangeAddNode,
            node_id=victim))
    pump(sides, 20, until=lambda s: all(
        victim in conf_of(s, i).voters for i in IDS))
    pump(sides, 4)

    # A ConfChangeV2 joint change with auto-leave: the victim becomes a
    # learner through a joint config the leader leaves by itself.
    for pkg, side in sides.items():
        tt = t[pkg]
        side.nodes[lead].propose_conf_change(tt.ConfChangeV2(
            transition=tt.ConfChangeTransition.ConfChangeTransitionJointImplicit,
            changes=[tt.ConfChangeSingle(
                tt.ConfChangeType.ConfChangeAddLearnerNode, victim)]))
    pump(sides, 20, until=lambda s: bool(conf_of(s, lead).voters_outgoing))
    pump(sides, 20, until=lambda s: all(
        not conf_of(s, i).voters_outgoing
        and victim in conf_of(s, i).learners for i in IDS))
    for pkg, side in sides.items():
        tt = t[pkg]
        side.nodes[lead].propose_conf_change(tt.ConfChangeV2(
            changes=[tt.ConfChangeSingle(
                tt.ConfChangeType.ConfChangeAddNode, victim)]))
    pump(sides, 20, until=lambda s: all(
        victim in conf_of(s, i).voters for i in IDS))

    # create_snapshot + compact on the leader while a member is cut
    # off; healed, it is caught up by MsgSnap carrying the app snapshot.
    for side in sides.values():
        side.cut.add(victim)
    propose(sides, 4, 16, forward=False)
    pump(sides, 6)

    def snapshot(side):
        n = side.nodes[lead]
        idx = n.status().basic.applied
        snap = n.create_snapshot(idx, None, b"app@%d" % idx)
        n.compact(idx, snap)
        return snap
    do(sides, snapshot)
    pump(sides, 2)
    # At the floor itself the term comes from the ring floor's term.
    floor = int(j.nodes[lead].rn.m_snap[0])
    do(sides, lambda s: s.nodes[lead].create_snapshot(floor, None, b"f"))
    propose(sides, 5, 5, forward=False)
    pump(sides, 3)
    for side in sides.values():
        side.cut.clear()
    pump(sides, 30, until=lambda s: any(i == victim for i, _ in s.snaps))
    pump(sides, 8)
    assert j.snaps and not j.dropped
    commits = {i: n.status().basic.hard_state.commit
               for i, n in j.nodes.items()}
    assert len(set(commits.values())) == 1, commits


def test_boot_from_row_restore_matches_jax():
    """All three members boot from WAL-replay state (RowRestore with a
    floor, entries and conf_state); the lagging one is caught up."""
    logs = {1: [(3, 1, b"c"), (4, 2, b"d"), (5, 2, b"e")],
            2: [(3, 1, b"c"), (4, 2, b"d")],
            3: [(3, 1, b"c")]}
    hs = {1: (2, 1, 4), 2: (2, 1, 4), 3: (1, 0, 3)}

    def boot(side, i):
        term, vote, commit = hs[i]
        return {"restore": side.rr(
            term=term, vote=vote, commit=commit, applied=2, snap_index=2,
            snap_term=1, entries=list(logs[i]),
            conf_state=side.t.ConfState(voters=list(IDS)))}

    sides = both(boot)
    lead = elect(sides)
    propose(sides, 6, 12)
    pump(sides, 10)
    n = sides["jax"].nodes
    assert len({n[i].status().basic.hard_state.commit for i in IDS}) == 1
    # Commit 4 survives; a new leader without index 5 overwrites it.
    assert n[lead].status().basic.hard_state.commit >= 4 + 1 + 12


def test_voterless_joiner_boot_matches_jax():
    """Members 1 and 2 boot as a two-voter cluster, member 3 voterless
    (boot_conf_state=ConfState()): it cannot campaign until the
    admitting conf change reaches it through the log."""
    def boot(side, i):
        return {"boot_conf_state": side.t.ConfState(
            voters=[] if i == 3 else [1, 2])}

    sides = both(boot)
    lead = elect(sides, members=(1, 2))
    assert lead in (1, 2) and sides["jax"].nodes[3].rn.lead(0) == 0
    propose(sides, 7, 6, forward=False)
    pump(sides, 4)
    for pkg, side in sides.items():
        tt = side.t
        side.nodes[lead].propose_conf_change(tt.ConfChange(
            id=9, type=tt.ConfChangeType.ConfChangeAddNode, node_id=3))
    pump(sides, 30, until=lambda s: 3 in conf_of(s, 3).voters)
    propose(sides, 8, 6)
    pump(sides, 8)
    st = {i: sides["torch"].nodes[i].status().basic.hard_state.commit
          for i in IDS}
    assert len(set(st.values())) == 1, st


def test_node_refuses_a_missing_gpu(monkeypatch):
    """The port's node runs on the GPU unless the caller names the CPU,
    and raises without CUDA rather than run on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tnode.BatchedNode(1, [1, 2, 3])
