"""The port's BatchedNode at etcd's member ids, and its follower reads.

- ``SlotMap``: the identity at dense ids 1..R; sorted boot peers; a
  member added by a conf change takes the first free slot, one removed
  frees it; members that apply the same changes hold the same map, and a
  map rebuilt from the boot peers and the configuration equals it.
- A member restarted from its WAL keeps a vote for a member that its
  last configuration does not name (added after it, no snapshot): the
  vote comes back as that member's id and a second candidate in the term
  is refused. A follower that missed a member add is caught up by the
  new member once it leads (a message from an id without a slot gives
  the sender a free slot, as the reference's raft takes it).
- Three port nodes at 64-bit member ids run a schedule in lockstep with
  three ``etcd_tpu`` nodes at ids 1..3 (test_torch_node's config): every
  Ready and status is equal once ids are mapped (vote, lead, every
  message's to and from) — the map sits at the boundary alone.
- A follower's ``read_index`` (ROADMAP C16): it sends MsgReadIndex to the
  leader, which joins it to its device batch and answers with
  MsgReadIndexResp; the follower surfaces the leader's index as a
  ReadState. Without a leader the request is dropped.
- Three embedded members (``embed.start_etcd``, ``device="cpu"``) hold
  the same map, and a restarted one rebuilds it from its data dir.
- A backlog of single-entry appends from one sender (a scalar-core
  leader's) merges at the follower up to E entries a message (ROADMAP
  C18).
"""

import numpy as np
import pytest

from etcd_tpu.batched import node as jnode
from etcd_tpu.raft import types as jtypes
from etcd_tpu_torch.batched import node as tnode
from etcd_tpu_torch.raft import types as ttypes

from .test_torch_node import plain

DENSE = (1, 2, 3)
# Three 64-bit member ids, as member_id_from_urls gives them, in the
# dense ids' order.
SPARSE = (0x2A8BFA5F836464FD, 0x2F274EF7331B9C92, 0x35179D13D0285315)
TO_DENSE = dict(zip(SPARSE, DENSE))


def test_dense_ids_map_to_themselves():
    sm = tnode.SlotMap([1, 2, 3], 5)
    assert sm.as_dict() == {1: 0, 2: 1, 3: 2}
    assert sm.add(4, {1, 2, 3, 4}) == 3 and sm.add(5, {1, 2, 3, 4, 5}) == 4
    # 2 leaves and comes back: it kept its slot.
    assert sm.add(2, {1, 2, 3, 4, 5}) == 1
    assert [sm.to_device(i) for i in range(6)] == list(range(6))
    assert [sm.from_device(i) for i in range(6)] == list(range(6))


def test_sparse_ids_follow_the_slot_rule():
    a, b, c, d, e = 900, 300, 700, 100, 500
    members = [tnode.SlotMap([a, b, c], 4, self_id=m) for m in (a, b, c)]
    for sm in members:
        assert sm.as_dict() == {b: 0, c: 1, a: 2}
        assert sm.add(d, {a, b, c, d}) == 3  # the first free slot
        with pytest.raises(ValueError, match="no free replica slot"):
            sm.add(e, {a, b, c, d, e})
    # c leaves, then e joins: no slot is free, so e takes the lowest slot
    # of a member outside the configuration, c's.
    for sm in members[:2]:
        assert sm.add(e, {a, b, d, e}) == 1
        assert sm.to_device(e) == 2 and sm.from_device(2) == e
        assert sm.to_device(c) is None and sm.from_device(0) == 0
    assert members[0].as_dict() == members[1].as_dict()
    # c never gives its own slot away.
    with pytest.raises(ValueError, match="no free replica slot"):
        members[2].add(e, {a, b, d, e})
    # Rebuilt after a restart from the boot peers and the configuration
    # (a snapshot's ConfState): the same map.
    for me in (a, b, d, e):
        again = tnode.SlotMap([a, b, c], 4, members={a, b, d, e}, self_id=me)
        assert again.as_dict() == members[0].as_dict(), me


def test_a_joiner_takes_the_slot_the_others_give_it():
    a, b, c, j = 900, 300, 700, 50
    old = tnode.SlotMap([a, b, c], 4, self_id=a)
    old.add(j)
    # The joiner boots with the current members plus itself and no
    # configuration naming it.
    new = tnode.SlotMap([a, b, c, j], 4, members={a, b, c}, self_id=j,
                        joiner=True)
    assert new.as_dict() == old.as_dict() == {b: 0, c: 1, a: 2, j: 3}


# -- the lockstep: sparse port ids against dense reference ids -------------


class Side:
    def __init__(self, mod, types, ids, kw):
        self.mod, self.t, self.ids = mod, types, ids
        self.nodes = {i: mod.BatchedNode(i, list(ids), election_tick=4, **kw)
                      for i in ids}
        self.reads = []

    def leader(self):
        lead = [i for i, n in self.nodes.items() if n.rn.is_leader(0)]
        return lead[0] if len(lead) == 1 else 0

    def turn(self, i):
        n = self.nodes[i]
        rd = n.ready(timeout=0)
        if rd is None:
            return None
        self.reads += [(i, rs.index, rs.request_ctx) for rs in rd.read_states]
        got = plain(rd)
        for m in rd.messages:
            self.nodes[m.to].step(m)
        n.advance()
        return got


def dense(x):
    """A plain tree of a port Ready or Status with member ids mapped to
    1..3 (to, from_, vote, lead; every other field as it is)."""
    if isinstance(x, tuple) and len(x) == 2 and isinstance(x[1], dict):
        name, fields = x
        out = {}
        for k, v in fields.items():
            if k in ("to", "from_", "vote", "lead", "id") and v:
                v = TO_DENSE[v]
            out[k] = dense(v)
        return (name, out)
    if isinstance(x, list):
        return [dense(v) for v in x]
    return x


def pump(j, t, rounds, until=None):
    for _ in range(rounds):
        for side in (j, t):
            for n in side.nodes.values():
                n.tick()
        for a, b in zip(DENSE, SPARSE):
            assert j.turn(a) == dense(t.turn(b))
        for a, b in zip(DENSE, SPARSE):
            assert plain(j.nodes[a].status()) == dense(
                plain(t.nodes[b].status()))
        if until is not None and until():
            return
    assert until is None, "condition not reached"


def test_sparse_ids_step_as_dense_ids():
    j = Side(jnode, jtypes, DENSE, {})
    t = Side(tnode, ttypes, SPARSE, {"device": "cpu"})
    pump(j, t, 40, until=lambda: j.leader() != 0 and all(
        n.rn.lead(0) == j.leader() for n in j.nodes.values()))
    lead = j.leader()
    slead = SPARSE[lead - 1]
    assert t.leader() == slead
    rng = np.random.RandomState(5)
    for k in range(18):
        data = rng.bytes(int(rng.randint(1, 48)))
        via = lead if k % 3 else lead % 3 + 1  # a third forwarded
        j.nodes[via].propose(data)
        t.nodes[SPARSE[via - 1]].propose(data)
    pump(j, t, 8)
    j.nodes[lead].read_index(b"r1")
    t.nodes[slead].read_index(b"r1")
    pump(j, t, 6)
    assert [r[2] for r in j.reads] == [b"r1"] and j.reads == [
        (TO_DENSE[i], idx, ctx) for i, idx, ctx in t.reads]
    # A transfer, asked at a follower: forwarded to the leader.
    target = lead % 3 + 1
    j.nodes[target].transfer_leadership(lead, target)
    t.nodes[SPARSE[target - 1]].transfer_leadership(slead,
                                                    SPARSE[target - 1])
    pump(j, t, 20, until=lambda: j.leader() == target)
    assert t.leader() == SPARSE[target - 1]
    hs = {i: n.status().basic.hard_state for i, n in t.nodes.items()}
    assert {h.vote for h in hs.values()} <= set(SPARSE)
    assert len({h.commit for h in hs.values()}) == 1


def _cluster(ids):
    side = Side(tnode, ttypes, ids, {"device": "cpu"})
    for _ in range(60):
        for n in side.nodes.values():
            n.tick()
        for i in ids:
            side.turn(i)
        if side.leader():
            break
    assert side.leader()
    return side


def test_follower_read_index_asks_the_leader():
    t = _cluster(SPARSE)
    lead = t.leader()
    for k in range(5):
        t.nodes[lead].propose(b"w%d" % k)
    for _ in range(6):
        for i in SPARSE:
            t.turn(i)
    followers = [i for i in SPARSE if i != lead]
    for f in followers:
        t.nodes[f].read_index(b"f-%x" % f)
    sent = []
    for _ in range(8):
        for i in SPARSE:
            n = t.nodes[i]
            rd = n.ready(timeout=0)
            if rd is None:
                continue
            t.reads += [(i, rs.index, rs.request_ctx)
                        for rs in rd.read_states]
            for m in rd.messages:
                if m.type in (ttypes.MessageType.MsgReadIndex,
                              ttypes.MessageType.MsgReadIndexResp):
                    sent.append((m.type, m.from_, m.to))
                t.nodes[m.to].step(m)
            n.advance()
    commit = t.nodes[lead].status().basic.hard_state.commit
    assert sorted(t.reads) == sorted(
        (f, commit, b"f-%x" % f) for f in followers)
    assert sorted(sent) == sorted(
        [(ttypes.MessageType.MsgReadIndex, f, lead) for f in followers]
        + [(ttypes.MessageType.MsgReadIndexResp, lead, f)
           for f in followers])


def test_follower_read_index_without_a_leader_is_dropped():
    n = tnode.BatchedNode(SPARSE[0], list(SPARSE), device="cpu")
    n.read_index(b"x")  # no leader known: dropped, the caller retries
    assert not n.has_ready()


def test_embedded_members_share_the_map(tmp_path):
    from etcd_tpu_torch.embed import Config, start_etcd
    from etcd_tpu_torch.tools.member_procs import free_ports

    ports = free_ports(6)
    names = ("a", "b", "c")
    initial = ",".join(f"{nm}=http://127.0.0.1:{ports[2 * i]}"
                       for i, nm in enumerate(names))

    def config(i, nm):
        return Config(
            name=nm, data_dir=str(tmp_path / nm), initial_cluster=initial,
            listen_peer_urls=f"http://127.0.0.1:{ports[2 * i]}",
            listen_client_urls=f"http://127.0.0.1:{ports[2 * i + 1]}",
            device="cpu")

    members = [start_etcd(config(i, nm)) for i, nm in enumerate(names)]
    try:
        maps = [e.server.node.slot_map.as_dict() for e in members]
        ids = sorted(e.server.id for e in members)
        assert maps == [dict(zip(ids, range(3)))] * 3
        members[1].close()
        members[1] = start_etcd(config(1, "b"))
        assert members[1].server.node.slot_map.as_dict() == maps[0]
    finally:
        for e in members:
            e.close()


def _add_entry(index: int, term: int, node_id: int):
    cc = ttypes.ConfChange(type=ttypes.ConfChangeType.ConfChangeAddNode,
                           node_id=node_id)
    return (index, term, cc.marshal(), int(ttypes.EntryType.EntryConfChange))


def _apply(n, rd):
    for e in rd.committed_entries:
        if e.type == ttypes.EntryType.EntryConfChange and e.data:
            n.apply_conf_change(ttypes.ConfChange.unmarshal(e.data))


def test_a_restarted_vote_keeps_its_member():
    from etcd_tpu_torch.batched.rawnode import RowRestore

    a, b, _c = SPARSE
    d = 0x1C0FFEE5EED5
    # The WAL, no snapshot: the boot peers' adds, d's add, and a vote
    # for d in term 3.
    ents = [_add_entry(i + 1, 1, p) for i, p in enumerate(SPARSE)]
    ents.append(_add_entry(4, 2, d))
    n = tnode.BatchedNode(a, list(SPARSE), election_tick=4, capacity=4,
                          device="cpu", restore=RowRestore(
                              term=3, vote=d, commit=4, entries=ents))
    assert n.slot_map.as_dict() == {**{p: i for i, p in enumerate(SPARSE)},
                                    d: 3}
    assert n.status().basic.hard_state.vote == d
    votes = []

    def ask(frm):
        n.step(ttypes.Message(type=ttypes.MessageType.MsgVote, to=a,
                              from_=frm, term=3, index=4, log_term=2))
        rd = n.ready(timeout=0)
        _apply(n, rd)
        if rd.hard_state.term:
            votes.append(rd.hard_state.vote)
        n.advance()
        return [(m.to, m.reject) for m in rd.messages
                if m.type == ttypes.MessageType.MsgVoteResp]

    assert ask(b) == [(b, True)]   # a second candidate in the term
    assert ask(d) == [(d, False)]  # the one voted for, asking again
    assert set(votes) <= {d}
    hs = n.status().basic.hard_state
    assert (hs.term, hs.vote) == (3, d)
    assert d in n._current_conf_state().voters


def test_a_lagging_follower_takes_the_new_leader():
    d = 0x1C0FFEE5EED5
    ids = list(SPARSE)
    nodes = {i: tnode.BatchedNode(i, ids, election_tick=4, capacity=4,
                                  device="cpu") for i in ids}
    cut = set()

    def run(rounds, until):
        for _ in range(rounds):
            for i, n in list(nodes.items()):
                n.tick()
                rd = n.ready(timeout=0)
                if rd is None:
                    continue
                _apply(n, rd)
                for m in rd.messages:
                    if not ({i, m.to} & cut) and m.to in nodes:
                        nodes[m.to].step(m)
                n.advance()
            if until():
                return
        raise AssertionError("condition not reached")

    def leader():
        lead = [i for i, n in nodes.items() if n.rn.is_leader(0)]
        return lead[0] if len(lead) == 1 else 0

    def commit(i):
        return nodes[i].status().basic.hard_state.commit

    run(60, leader)
    lead = leader()
    lag = next(i for i in ids if i != lead)
    cut.add(lag)
    nodes[lead].propose_conf_change(ttypes.ConfChange(
        type=ttypes.ConfChangeType.ConfChangeAddNode, node_id=d))
    run(40, lambda: all(d in nodes[i]._current_conf_state().voters
                        for i in ids if i != lag))
    # d boots as etcd's joiner does: the others as its configuration.
    nodes[d] = tnode.BatchedNode(d, ids + [d], election_tick=4, capacity=4,
                                 boot_conf_state=ttypes.ConfState(voters=ids),
                                 device="cpu")
    run(60, lambda: d in nodes[d]._current_conf_state().voters
        and commit(d) == commit(lead))
    nodes[lead].transfer_leadership(lead, d)
    run(60, lambda: leader() == d)
    for k in range(6):
        nodes[d].propose(b"after-%d" % k)
    run(20, lambda: commit(d) > commit(lead) - 1 and commit(d) >= 6)
    assert d not in nodes[lag]._current_conf_state().voters
    cut.clear()
    run(80, lambda: commit(lag) == commit(d)
        and d in nodes[lag]._current_conf_state().voters)
    assert leader() == d and nodes[lag].status().basic.soft_state.lead == d
    assert nodes[lag].slot_map.slot(d) == 3


def test_a_backlog_of_single_entry_appends_merges():
    """ROADMAP C18: a scalar-core leader sends one MsgApp a proposal, and
    a round takes one message a sender. A follower that finds 64
    contiguous single-entry appends of one sender queued merges them up
    to E = 8 entries a message, so it holds the whole log after 8 rounds
    (one a message without the merge, 64)."""
    f = tnode.BatchedNode(2, list(DENSE), election_tick=10, device="cpu")
    e = f.cfg.max_ents_per_msg
    n = 8 * e
    for i in range(1, n + 1):
        f.step(ttypes.Message(
            type=ttypes.MessageType.MsgApp, to=2, from_=1, term=2,
            index=i - 1, log_term=2 if i > 1 else 0, commit=i,
            entries=[ttypes.Entry(index=i, term=2, data=b"p%d" % i)]))
    got, rounds = [], 0
    while len(got) < n and rounds < 2 * n:
        rd = f.ready(timeout=0)
        rounds += 1
        if rd is not None:
            got += [(x.index, x.data) for x in rd.entries]
            f.advance()
    assert got == [(i, b"p%d" % i) for i in range(1, n + 1)]
    assert rounds == n // e
    assert f.status().basic.hard_state.commit == n
