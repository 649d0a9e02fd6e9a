"""PyTorch port ↔ JAX reference: the device apply plane and the rawnode's
plane hooks.

Every plane field is int32 or bool and every host form is bytes or
Python ints, so every comparison is exact.

The JAX side builds only programs the batched suite already builds:

* the dispatch of tests/batched/test_applyplane.py's oracle test
  (n = 4, C = 16, WS = 4, A = 4), on the same seeded workload;
* test_chaos.CFG plus that file's plane knobs (CFG_PLANE: C = 64,
  WS = 4, A = 4) for hosted rawnodes — the round key strips the plane
  knobs, so it is the chaos suite's round program, and the plane
  program is the one its lease-read and chaos cells build at n = G.

The WS = 32 case runs against the oracle alone.
"""

import numpy as np
import torch

import jax.numpy as jnp
from etcd_tpu.batched import applyplane as jap
from etcd_tpu_torch.batched import applyplane as tap
from etcd_tpu_torch.batched.convert import plane_from_numpy, plane_to_numpy

from .batched.test_applyplane import CFG_PLANE
from .batched.test_chaos import CFG as CHAOS_CFG
from .test_torch_rawnode import (
    MEMBERS,
    Side,
    assert_rawnodes_equal,
    assert_ready_equal,
    leaders,
)

N_ROWS, A_REC = 4, 4
ORACLE_CFG = CHAOS_CFG._replace(apply_plane=True, apply_capacity=16,
                                apply_watch_slots=4, apply_records=A_REC)


# -- the host forms --------------------------------------------------------------


def test_host_forms_match_jax():
    assert (tap.OP_NONE, tap.OP_PUT, tap.OP_DEL) == (
        jap.OP_NONE, jap.OP_PUT, jap.OP_DEL)
    rng = np.random.default_rng(3)
    blobs = [b"", b"\x00", b"k"] + [rng.bytes(int(rng.integers(1, 70)))
                                     for _ in range(200)]
    assert [tap.fnv1a32(b) for b in blobs] == [jap.fnv1a32(b) for b in blobs]
    for k, v, ttl in ((b"k", b"v", 0), (b"key", b"", 7), (b"", b"x", 1),
                      (b"a\x00b", b"c", 0)):
        assert tap.put_payload(k, v, ttl) == jap.put_payload(k, v, ttl)
        assert tap.delete_payload(k) == jap.delete_payload(k)
    for d in blobs + [b"E\x00", b"E\x00\x00\x00\x05k\x00v", b"Pk", b"Dk",
                      tap.put_payload(b"k", b"v", 9)]:
        assert tap.parse_payload(d) == jap.parse_payload(d)


def seeded_workload(cfg, n, dispatches, seed=7, big_row=0, wslots=(0, 2)):
    """test_applyplane.py's workload: row `big_row` draws from 40 keys
    (so it overflows capacity 16), the others from 10; two armed
    watches per row; uneven tick streams. Yields (watch image, then per
    dispatch (ops, keys, vals, ttls, tick_add, per-row oracle records))."""
    a = cfg.apply_records
    pools = [[tap.fnv1a32(b"r%d-k%d" % (r, i))
              for i in range(40 if r == big_row else 10)] for r in range(n)]
    wk = np.zeros((n, cfg.apply_watch_slots), np.int32)
    for r in range(n):
        for j, w in enumerate(wslots):
            wk[r, w] = pools[r][j % len(pools[r])]
    rng = np.random.default_rng(seed)
    steps = []
    for _ in range(dispatches):
        ops, keys, vals, ttls = (np.zeros((n, a), np.int32) for _ in range(4))
        tick_add = rng.integers(0, 3, size=n).astype(np.int32)
        recs = []
        for r in range(n):
            k = int(rng.integers(0, a + 1))
            row = []
            for j in range(k):
                op = tap.OP_PUT if rng.random() < 0.7 else tap.OP_DEL
                key = int(rng.choice(pools[r]))
                val = tap.fnv1a32(rng.bytes(4)) if op == tap.OP_PUT else 0
                ttl = (int(rng.integers(1, 6))
                       if op == tap.OP_PUT and rng.random() < 0.3 else 0)
                ops[r, j], keys[r, j] = op, key
                vals[r, j], ttls[r, j] = val, ttl
                row.append((op, key, val, ttl))
            recs.append(row + [(tap.OP_NONE, 0, 0, 0)] * (a - k))
        steps.append((ops, keys, vals, ttls, tick_add, recs))
    return wk, steps


def as_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_tuples_equal(want, got, ctx):
    for f in want._fields:
        w, g = as_np(getattr(want, f)), as_np(getattr(got, f))
        assert g.dtype == w.dtype and np.array_equal(g, w), (ctx, f)


def frame_events(frames, r, a):
    return [tuple(int(as_np(getattr(fr, f))[r, j])
                  for f in ("ev_op", "ev_key", "ev_rev", "ev_wmask"))
            for fr in frames for j in range(a)
            if int(as_np(fr.ev_op)[r, j]) != tap.OP_NONE]


def assert_plane_matches_oracles(plane, frames, oracles, a, bit31=False):
    for r, o in enumerate(oracles):
        for name in tap.KV_LANES:
            assert as_np(getattr(plane, name))[r].tolist() == getattr(
                o, name), (r, name)
        assert int(plane.rev[r]) == o.rev
        assert int(plane.tick[r]) == o.tick
        assert bool(plane.overflow[r]) == o.overflow
        assert int(plane.slots_hw[r]) == o.slots_hw
        # The oracle's bitmap is a Python int: its bit 31 is +2^31
        # where the int32 lane holds -2^31.
        want = [(op, k, rv, wm - (1 << 32) if bit31 and wm >= 1 << 31
                 else wm) for op, k, rv, wm in o.events]
        assert frame_events(frames, r, a) == want, r
        assert sum(int(fr.expired[r]) for fr in frames) == o.expired


# -- the dispatch ------------------------------------------------------------------


def test_dispatch_matches_jax_and_oracle():
    """test_applyplane.py's seeded workload (puts, deletes, TTL'd puts,
    re-puts, an overflowing row, armed watches, uneven ticks) through the
    JAX dispatch, the port's and the oracles: plane and frame equal to
    JAX after every dispatch, and to the oracles at the end."""
    n, cfg = N_ROWS, ORACLE_CFG
    jdispatch = jap.make_dispatch(cfg, n)
    wk, steps = seeded_workload(cfg, n, 25)
    jplane = jap.init_plane(cfg, n)._replace(watch_key=jnp.asarray(wk))
    tplane = tap.init_plane(cfg, n, device="cpu")
    tplane.watch_key.copy_(torch.from_numpy(wk))
    oracles = [jap.PlaneOracle(cfg) for _ in range(n)]
    port_oracles = [tap.PlaneOracle(cfg) for _ in range(n)]
    for r in range(n):
        oracles[r].watch_key = wk[r].tolist()
        port_oracles[r].watch_key = wk[r].tolist()
    frames = []
    for i, (ops, keys, vals, ttls, tick_add, recs) in enumerate(steps):
        jplane, jframe = jdispatch(jplane, *(jnp.asarray(x) for x in (
            ops, keys, vals, ttls, tick_add)))
        frame = tap.dispatch(tplane, *(torch.from_numpy(x) for x in (
            ops, keys, vals, ttls, tick_add)))
        assert_tuples_equal(jframe, frame, f"frame {i}")
        assert_tuples_equal(jplane, tplane, f"plane {i}")
        frames.append(frame)
        for r in range(n):
            oracles[r].dispatch(recs[r], int(tick_add[r]))
            port_oracles[r].dispatch(recs[r], int(tick_add[r]))
    assert_plane_matches_oracles(tplane, frames, port_oracles, A_REC)
    assert [o.state() for o in port_oracles] == [o.state() for o in oracles]
    assert [o.events for o in port_oracles] == [o.events for o in oracles]
    assert bool(tplane.overflow[0]) and not tplane.overflow[1:].any()
    assert any(e[3] for o in oracles for e in o.events)
    assert sum(int(f.expired.sum()) for f in frames) > 0


def test_watch_slot_31_against_oracle():
    """WS = 32 with watches armed in slots 0, 30 and 31: the bit-31 slot
    is the int32 sign bit (-2^31), as the reference's int32 shift."""
    cfg = ORACLE_CFG._replace(apply_watch_slots=32, apply_capacity=8)
    n = 3
    wk, steps = seeded_workload(cfg, n, 30, seed=11, big_row=1,
                                wslots=(0, 31, 30))
    plane = tap.init_plane(cfg, n, device="cpu")
    plane.watch_key.copy_(torch.from_numpy(wk))
    oracles = [tap.PlaneOracle(cfg) for _ in range(n)]
    for r in range(n):
        oracles[r].watch_key = wk[r].tolist()
    frames = []
    for ops, keys, vals, ttls, tick_add, recs in steps:
        frames.append(tap.dispatch(plane, *(torch.from_numpy(x) for x in (
            ops, keys, vals, ttls, tick_add))))
        for r in range(n):
            oracles[r].dispatch(recs[r], int(tick_add[r]))
    assert_plane_matches_oracles(plane, frames, oracles, A_REC, bit31=True)
    masks = torch.cat([f.ev_wmask.flatten() for f in frames])
    assert (masks < 0).any(), "slot 31 never matched"
    assert tap._watch_bits(32, torch.device("cpu"))[31] == -(1 << 31)


def test_slot_search_ties_and_empty_rows():
    """First match wins over later matches and over free slots; with no
    match the first free slot; with neither, slot 0 and not ok."""
    kv = torch.tensor([[5, 7, 5, 0],    # two matches of 5: slot 0
                       [0, 9, 0, 5],    # a match after free slots: 3
                       [3, 0, 4, 0],    # no match: first free, 1
                       [1, 2, 3, 4],    # full, no match: 0, not ok
                       [0, 0, 0, 0]],   # empty: first free, 0
                      dtype=torch.int32)
    key = torch.tensor([5, 5, 5, 5, 5], dtype=torch.int32)
    slot, exists, ok = tap.slot_search(kv, key)
    assert slot.tolist() == [0, 3, 1, 0, 0]
    assert exists.tolist() == [True, True, False, False, False]
    assert ok.tolist() == [True, True, True, False, True]
    # A zero key matches free slots: the first of them.
    slot, exists, ok = tap.slot_search(kv, torch.zeros(5, dtype=torch.int32))
    assert slot.tolist() == [3, 0, 1, 0, 0]
    assert exists.tolist() == ok.tolist() == [True, True, True, False, True]


def test_gather_rows_and_numpy_round_trip():
    """gather_rows equals the JAX gather and numpy indexing; a JAX plane
    image loads into the port (plane_from_numpy), reads back equal
    (plane_to_numpy) and steps on equal to the JAX plane."""
    n, cfg = N_ROWS, ORACLE_CFG
    jdispatch = jap.make_dispatch(cfg, n)
    wk, steps = seeded_workload(cfg, n, 16, seed=5)
    jplane = jap.init_plane(cfg, n)._replace(watch_key=jnp.asarray(wk))
    for ops, keys, vals, ttls, tick_add, _ in steps[:10]:
        jplane, _ = jdispatch(jplane, *(jnp.asarray(x) for x in (
            ops, keys, vals, ttls, tick_add)))
    image = {f: np.asarray(getattr(jplane, f)) for f in jplane._fields}
    tplane = plane_from_numpy(image, device="cpu")
    back = plane_to_numpy(tplane)
    assert list(back) == list(image)
    for f, w in image.items():
        assert back[f].dtype == w.dtype and np.array_equal(back[f], w), f
    rows = np.asarray([3, 0, 3], np.int32)
    want = jap.gather_rows(jplane, rows)
    got = tap.gather_rows(tplane, rows)
    assert len(got) == len(want) == 7
    for w, g in zip(want, got):
        assert g.numpy().dtype == np.asarray(w).dtype
        assert np.array_equal(g.numpy(), np.asarray(w))
    for g, f in zip(got, tap.KV_LANES + ("rev", "tick", "overflow")):
        assert np.array_equal(g.numpy(), image[f][rows])
    for i, (ops, keys, vals, ttls, tick_add, _) in enumerate(steps[10:]):
        jplane, jframe = jdispatch(jplane, *(jnp.asarray(x) for x in (
            ops, keys, vals, ttls, tick_add)))
        frame = tap.dispatch(tplane, *(torch.from_numpy(x) for x in (
            ops, keys, vals, ttls, tick_add)))
        assert_tuples_equal(jframe, frame, i)
        assert_tuples_equal(jplane, tplane, i)


# -- the rawnode's plane hooks --------------------------------------------------------


def propose_kv(rnd, side):
    """From round 24, seeded KV proposals on each group's leader: puts,
    TTL'd puts, deletes and a junk payload the KV tier skips."""
    if rnd < 24:
        return
    lead = leaders(side)
    rng = np.random.RandomState(3000 + rnd)
    for grp in sorted(lead):
        for _ in range(int(rng.randint(0, 4))):
            key = b"k%d" % rng.randint(0, 12)
            u = rng.rand()
            if u < 0.55:
                data = tap.put_payload(key, rng.bytes(6))
            elif u < 0.75:
                data = tap.put_payload(key, b"lease", int(rng.randint(1, 8)))
            elif u < 0.95:
                data = tap.delete_payload(key)
            else:
                data = b"?junk"
            side.rns[lead[grp]].propose(grp, data)


def kv_schedule(rnd, side, plane=True):
    """A tick on every member, propose_kv, and with the plane on, watch
    arms on every member at rounds 20 and 36 and, at round 30, member
    1's captures of rows 2 and 5 restored into member 2 with their
    lessor entries."""
    rns = side.rns
    for rn in rns.values():
        rn.tick()
    propose_kv(rnd, side)
    if not plane:
        return
    if rnd in (20, 36):
        for rn in rns.values():
            for grp in range(rn.n):
                rn.watch_set(grp, grp % 4, tap.fnv1a32(b"k%d" % (grp % 3)))
    if rnd == 30:
        for row, cap in zip((2, 5), rns[1].plane_capture([2, 5])):
            rns[2].plane_restore_row(
                row, cap["kv_key"], cap["kv_rev"], cap["kv_val"],
                cap["kv_lease"], cap["rev"], cap["tick"], cap["overflow"],
                cap["applied"],
                lessor=[(bytes.fromhex(k), e) for k, e in cap["lessor"]])


def plane_np(rn):
    pl = rn.plane
    return {f: as_np(getattr(pl, f)) for f in pl._fields}


def assert_planes_equal(j, t, ctx):
    want, got = plane_np(j), plane_np(t)
    assert list(got) == list(want), ctx
    for f, w in want.items():
        assert got[f].dtype == w.dtype and np.array_equal(got[f], w), (
            ctx, f)
    assert t.plane_stats == j.plane_stats, ctx
    for f in ("m_plane_tick", "m_plane_applied"):
        w, g = getattr(j, f), getattr(t, f)
        assert g.dtype == w.dtype and np.array_equal(g, w), (ctx, f)
    assert list(t.plane_lessor.items()) == list(j.plane_lessor.items()), ctx
    assert t.drain_plane_events() == j.drain_plane_events(), ctx
    rows = list(range(t.n))
    assert t.plane_capture(rows) == j.plane_capture(rows), ctx


def test_plane_rawnode_matches_jax():
    """Three hosted members per package at CFG_PLANE (test_chaos.CFG with
    the plane, ticked every round, so leaders come from timer
    elections), one seeded schedule of KV payloads, watch arms and a
    plane_restore_row: after every member round the Readys, protocol
    state and mirrors, plane tensors, plane_stats, events, captures,
    m_plane_* and lessor are equal."""
    sides = {pkg: Side(pkg, CFG_PLANE, seed=33, drop=0.05, delay=0.1)
             for pkg in ("jax", "torch")}
    events = 0
    for rnd in range(44):
        for side in sides.values():
            kv_schedule(rnd, side)
        for mid in MEMBERS:
            jrn, trn = sides["jax"].rns[mid], sides["torch"].rns[mid]
            ready = [s.member_round(mid) for s in sides.values()]
            ctx = f"round {rnd} member {mid}"
            assert_ready_equal(*ready, ctx)
            assert_rawnodes_equal(jrn, trn, ctx)
            events += len(trn.plane_events)
            assert_planes_equal(jrn, trn, ctx)
        for side in sides.values():
            side.net.end_round()
    t = sides["torch"].rns
    stats = [rn.plane_stats for rn in t.values()]
    assert all(s["puts"] and s["dels"] and s["dispatches"] for s in stats)
    assert sum(s["expired"] for s in stats) > 0
    assert events > 0
    assert any(rn.plane_lessor for rn in t.values())


def test_plane_on_equals_plane_off():
    """The plane changes no protocol output: two sets of port members,
    CHAOS_CFG and CFG_PLANE, under one schedule give equal Readys and
    equal state and mirrors after every member round."""
    off = Side("torch", CHAOS_CFG, seed=44, drop=0.05)
    on = Side("torch", CFG_PLANE, seed=44, drop=0.05)
    for rnd in range(40):
        kv_schedule(rnd, off, plane=False)
        kv_schedule(rnd, on)
        for mid in MEMBERS:
            a, b = off.member_round(mid), on.member_round(mid)
            ctx = f"round {rnd} member {mid}"
            assert_ready_equal(a, b, ctx)
            assert_rawnodes_equal(off.rns[mid], on.rns[mid], ctx)
        off.net.end_round()
        on.net.end_round()
    assert off.rns[1].plane is None
    assert on.rns[1].plane_stats["puts"] > 0
    assert on.rns[1].plane_capture([]) == []
