"""PyTorch port ↔ JAX reference: the host raft pieces the port copies.

``etcd_tpu_torch.raft`` keeps its own copies of the JAX-free modules of
``etcd_tpu.raft`` that BatchedNode and raftexample need (the conf
changes and their encoding, quorum, tracker and confchange, the
MemoryStorage, the Ready and Status shapes). Each copy is pinned here
to etcd_tpu's on seeded inputs: equal bytes, equal results, equal
errors, equal field sets.
"""

import dataclasses
import enum

import numpy as np
import pytest

from etcd_tpu.raft import confchange as jcc
from etcd_tpu.raft import errors as jerr
from etcd_tpu.raft import quorum as jq
from etcd_tpu.raft import raft as jraft
from etcd_tpu.raft import read_only as jro
from etcd_tpu.raft import rawnode as jrn
from etcd_tpu.raft import storage as jst
from etcd_tpu.raft import tracker as jtr
from etcd_tpu.raft import types as jt
from etcd_tpu_torch.raft import confchange as tcc
from etcd_tpu_torch.raft import errors as terr
from etcd_tpu_torch.raft import quorum as tq
from etcd_tpu_torch.raft import raft as traft
from etcd_tpu_torch.raft import read_only as tro
from etcd_tpu_torch.raft import rawnode as trn
from etcd_tpu_torch.raft import storage as tst
from etcd_tpu_torch.raft import tracker as ttr
from etcd_tpu_torch.raft import types as tt

PKGS = {"jax": (jt, jcc, jq, jtr, jst), "torch": (tt, tcc, tq, ttr, tst)}
CC_TYPES = [0, 1, 2, 3]


def plain(x):
    if dataclasses.is_dataclass(x):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, enum.Enum):
        return int(x)
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, (jtr.TrackerConfig, ttr.TrackerConfig)):
        return ("TrackerConfig", str(x))
    return x


def outcome(fn):
    """fn()'s result, or its error as (class name, message)."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the error is the result
        return ("err", type(e).__name__, str(e))


def random_cc(t, rng):
    """A seeded ConfChange or ConfChangeV2 of package `t`."""
    ctx = rng.bytes(int(rng.randint(0, 4)))
    if rng.rand() < 0.4:
        return t.ConfChange(id=int(rng.randint(0, 1 << 40)),
                            type=t.ConfChangeType(rng.choice(CC_TYPES)),
                            node_id=int(rng.randint(0, 300)), context=ctx)
    return t.ConfChangeV2(
        transition=t.ConfChangeTransition(int(rng.randint(0, 3))),
        changes=[t.ConfChangeSingle(t.ConfChangeType(rng.choice(CC_TYPES)),
                                    int(rng.randint(0, 300)))
                 for _ in range(int(rng.randint(0, 4)))],
        context=ctx)


@pytest.mark.parametrize("seed", range(4))
def test_conf_change_bytes_equal_both_ways(seed):
    rng_j, rng_t = np.random.RandomState(seed), np.random.RandomState(seed)
    for _ in range(200):
        a, b = random_cc(jt, rng_j), random_cc(tt, rng_t)
        assert plain(a) == plain(b)
        data = a.marshal()
        assert b.marshal() == data
        for src, dst in ((jt, tt), (tt, jt)):
            cls = type(a).__name__
            got = getattr(dst, cls).unmarshal(data)
            back = getattr(src, cls).unmarshal(data)
            assert plain(got) == plain(back) == plain(a)
            assert plain(got.as_v2()) == plain(back.as_v2())
        v2 = (a.as_v2(), b.as_v2())
        assert v2[0].enter_joint() == v2[1].enter_joint()
        assert v2[0].leave_joint() == v2[1].leave_joint()


def tracker_view(tr, t):
    cs = tr.conf_state()
    return (str(tr.config), plain(cs),
            sorted((vid, str(p)) for vid, p in tr.progress.items()))


@pytest.mark.parametrize("seed", range(6))
def test_changer_sequences_equal(seed):
    """Seeded sequences of simple / enter_joint / leave_joint steps, from
    a restored start: equal configs and progress, or equal errors."""
    rng = np.random.RandomState(seed)
    start = dict(voters=sorted(set(rng.randint(1, 6, 3).tolist())),
                 learners=[6])
    sides = {}
    for pkg, (t, cc, _, tr_mod, _) in PKGS.items():
        tr = tr_mod.ProgressTracker(max_inflight=256)
        cc.restore(cc.Changer(tr, 10), t.ConfState(**start))
        sides[pkg] = tr
    assert tracker_view(sides["jax"], jt) == tracker_view(sides["torch"], tt)
    for step in range(60):
        kind = rng.randint(0, 3)
        auto = bool(rng.randint(0, 2))
        ops = [(int(rng.choice(CC_TYPES)), int(rng.randint(1, 8)))
               for _ in range(int(rng.randint(0, 3)))]
        results = []
        for pkg, (t, cc, _, _, _) in PKGS.items():
            tr = sides[pkg]
            ccs = [t.ConfChangeSingle(t.ConfChangeType(k), n) for k, n in ops]
            ch = cc.Changer(tr, 10 + step)

            def run(ch=ch, ccs=ccs):
                if kind == 0:
                    return ch.simple(ccs)
                if kind == 1:
                    return ch.enter_joint(auto, ccs)
                return ch.leave_joint()
            res = outcome(run)
            if res[0] == "ok":
                tr.config, tr.progress = res[1]
                res = ("ok",)
            results.append((res, tracker_view(tr, t)))
        assert results[0] == results[1], (seed, step, kind, ops)
    # restore() of each final config into a fresh tracker agrees too.
    finals = []
    for pkg, (t, cc, _, tr_mod, _) in PKGS.items():
        fresh = tr_mod.ProgressTracker(max_inflight=256)
        cs = sides[pkg].conf_state()
        finals.append((outcome(lambda: cc.restore(cc.Changer(fresh, 5), cs)
                               and None), tracker_view(fresh, t)))
    assert finals[0] == finals[1]


@pytest.mark.parametrize("seed", range(3))
def test_quorum_results_equal(seed):
    rng = np.random.RandomState(seed)
    for _ in range(300):
        ids = sorted(set(rng.randint(1, 8, int(rng.randint(0, 6))).tolist()))
        out = sorted(set(rng.randint(1, 8, int(rng.randint(0, 6))).tolist()))
        acked = {i: int(rng.randint(0, 50)) for i in range(1, 8)
                 if rng.rand() < 0.8}
        votes = {i: bool(rng.randint(0, 2)) for i in range(1, 8)
                 if rng.rand() < 0.7}
        got = []
        for _, _, q, _, _ in PKGS.values():
            maj, joint = q.MajorityConfig(ids), q.JointConfig(ids, out)
            got.append((maj.committed_index(acked.get),
                        int(maj.vote_result(votes)),
                        joint.committed_index(acked.get),
                        int(joint.vote_result(votes)), str(joint)))
        assert got[0] == got[1]


def storage_ops(rng, n=160):
    """A seeded MemoryStorage operation sequence (package-neutral): each
    op draws its indexes as offsets around the store's current range,
    so most succeed and some hit each error."""
    ops = []
    for _ in range(n):
        k = int(rng.choice(8, p=[.3, .1, .1, .05, .15, .1, .1, .1]))
        ops.append((k, int(rng.randint(-2, 5)), int(rng.randint(0, 40)),
                    int(rng.randint(1, 4)), rng.bytes(int(rng.randint(0, 8)))))
    return ops


@pytest.mark.parametrize("seed", range(4))
def test_memory_storage_sequence_equal(seed):
    ops = storage_ops(np.random.RandomState(seed))
    stores = {pkg: m[4].MemoryStorage() for pkg, m in PKGS.items()}
    kinds = set()
    for step, (k, off, b, term, data) in enumerate(ops):
        ref = stores["jax"]
        first, last = ref.first_index(), ref.last_index()
        got = []
        for pkg, (t, *_r) in PKGS.items():
            ms = stores[pkg]

            def run(ms=ms, t=t):
                if k == 0:  # overlapping or gapped appends
                    ents = [t.Entry(term=term + j // 3, index=last + off + j,
                                    data=data) for j in range(1 + b % 5)]
                    return ms.append(ents)
                if k == 1:
                    return ms.compact(first + off)
                if k == 2:
                    return ms.create_snapshot(
                        last - off, t.ConfState(voters=[1, 2, b % 5 + 1]),
                        data)
                if k == 3:
                    return ms.apply_snapshot(t.Snapshot(
                        data=data, metadata=t.SnapshotMetadata(
                            conf_state=t.ConfState(voters=[1]),
                            index=first + off + b % 3, term=term)))
                if k == 4:
                    lo = first + off
                    return ms.entries(lo, min(lo + b % 6, last + 2),
                                      [0, 20, 1 << 30][b % 3])
                if k == 5:
                    return ms.term(first + off + b % 4)
                if k == 6:
                    ms.set_hard_state(t.HardState(term=b, vote=b % 4,
                                                  commit=term))
                    return ms.initial_state()
                return (ms.first_index(), ms.last_index(), ms.snapshot())
            res = outcome(run)
            got.append(plain(res[1]) if res[0] == "ok" else res)
        assert got[0] == got[1], (seed, step, k, off, b)
        kinds.add((k, isinstance(got[0], tuple)))  # only errors are tuples
    assert plain(stores["jax"].ents) == plain(stores["torch"].ents)
    # Every kind of op ran, and each of compact, create_snapshot,
    # entries and term both succeeded and raised.
    assert {k for k, _ in kinds} == set(range(8))
    assert all((k, e) in kinds for k in (1, 2, 4, 5) for e in (False, True))


def fields(cls):
    return [(f.name, f.default if f.default is not dataclasses.MISSING
             else plain(f.default_factory())) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", [
    "rawnode.Ready", "rawnode.BasicStatus", "rawnode.Status",
    "raft.SoftState", "read_only.ReadState", "types.HardState",
    "types.ConfState", "types.ConfChange", "types.ConfChangeV2",
    "types.ConfChangeSingle", "types.Snapshot", "types.Message"])
def test_shapes_have_equal_fields(name):
    mod, cls = name.split(".")
    mods = {"rawnode": (jrn, trn), "raft": (jraft, traft),
            "read_only": (jro, tro), "types": (jt, tt)}[mod]
    j, t = (getattr(m, cls) for m in mods)
    if cls in ("ReadState",):
        assert [f.name for f in dataclasses.fields(j)] == [
            f.name for f in dataclasses.fields(t)]
    else:
        assert fields(j) == fields(t)


@pytest.mark.parametrize("enum_name", [
    "types.ConfChangeType", "types.ConfChangeTransition",
    "raft.StateType", "read_only.ReadOnlyOption", "quorum.VoteResult",
    "tracker.ProgressStateType"])
def test_enums_equal(enum_name):
    mod, cls = enum_name.split(".")
    mods = {"types": (jt, tt), "raft": (jraft, traft),
            "read_only": (jro, tro), "quorum": (jq, tq),
            "tracker": (jtr, ttr)}[mod]
    j, t = (getattr(m, cls) for m in mods)
    assert [(e.name, int(e)) for e in j] == [(e.name, int(e)) for e in t]


def test_error_strings_equal():
    names = [n for n in dir(jerr) if n.endswith("Error")]
    assert names == [n for n in dir(terr) if n.endswith("Error")]
    for n in names:
        assert str(getattr(jerr, n)()) == str(getattr(terr, n)())


def test_must_sync_and_ready_helpers_equal():
    rng = np.random.RandomState(5)
    for _ in range(100):
        a, b = (tuple(int(x) for x in rng.randint(0, 3, 3)) for _ in "ab")
        n = int(rng.randint(0, 2))
        assert jrn.must_sync(jt.HardState(*a), jt.HardState(*b), n) == \
            trn.must_sync(tt.HardState(*a), tt.HardState(*b), n)
    for pkg, (t, rn) in {"jax": (jt, jrn), "torch": (tt, trn)}.items():
        rd = rn.Ready(committed_entries=[t.Entry(index=7)])
        assert rd.contains_updates() and rd.applied_cursor() == 7
        assert not rn.Ready().contains_updates()
