"""PyTorch port ↔ JAX reference: the SoA message codec and the raft
wire types.

``etcd_tpu_torch.batched.msgblock`` is a copy of
``etcd_tpu.batched.msgblock`` (numpy on the host in both packages), so
every comparison here is exact: equal frame bytes, equal record arrays,
equal dense inboxes and residuals. Inputs are seeded random record
sets (numpy RandomState), well-formed and garbage.
"""

import dataclasses

import numpy as np
import pytest

from etcd_tpu.batched import msgblock as jmb
from etcd_tpu.batched import step as jstep
from etcd_tpu.raft import types as jtypes
from etcd_tpu_torch.batched import msgblock as tmb
from etcd_tpu_torch.batched import step as tstep
from etcd_tpu_torch.raft import types as ttypes

R = 3
N_ROWS = 12
MAX_ENTS = 4
SEEDS = [0, 1, 2, 3]

# Routable wire types (the block path never carries T_SNAP).
TYPES = np.array([jstep.T_APP, jstep.T_APP_RESP, jstep.T_VOTE,
                  jstep.T_VOTE_RESP, jstep.T_HB, jstep.T_HB_RESP,
                  jstep.T_PREVOTE, jstep.T_PREVOTE_RESP,
                  jstep.T_TIMEOUT_NOW])


def random_arrays(rng, n_recs, garbage=False):
    """A record array and its flat entry arena. With `garbage`, about a
    third of the records break one wire rule each (row out of range,
    frm 0 or > R, wrong lane, type >= 32, T_SNAP, too many entries,
    entries on a non-MsgApp record)."""
    rec = np.zeros(n_recs, jmb.REC_DTYPE)
    typ = rng.choice(TYPES, n_recs)
    rec["row"] = rng.randint(0, N_ROWS, n_recs)
    rec["to"] = rng.randint(1, R + 1, n_recs)
    rec["frm"] = rng.randint(1, R + 1, n_recs)
    rec["type"] = typ
    rec["lane"] = jstep.LANE_OF[typ]
    rec["reject"] = rng.randint(0, 2, n_recs)
    rec["n_ents"] = np.where(typ == jstep.T_APP,
                             rng.randint(0, MAX_ENTS + 1, n_recs), 0)
    for f in ("term", "log_term", "index", "commit", "reject_hint", "ctx"):
        rec[f] = rng.randint(0, 2**31, n_recs).astype(np.uint32) * 2 + (
            rng.randint(0, 2, n_recs).astype(np.uint32))
    if garbage:
        bad = np.nonzero(rng.rand(n_recs) < 0.35)[0]
        for i, kind in zip(bad, rng.randint(0, 7, len(bad))):
            if kind == 0:
                rec["row"][i] = N_ROWS + rng.randint(0, 1000)
            elif kind == 1:
                rec["frm"][i] = rng.choice([0, R + 1, 200])
            elif kind == 2:
                rec["lane"][i] = (rec["lane"][i] + 1) % tstep.NUM_KINDS
            elif kind == 3:
                rec["type"][i] = 32 + rng.randint(0, 200)
            elif kind == 4:
                rec["type"][i] = jstep.T_SNAP
                rec["lane"][i] = jstep.LANE_OF[jstep.T_SNAP]
            elif kind == 5:
                rec["n_ents"][i] = MAX_ENTS + 1 + rng.randint(0, 3)
            else:
                rec["n_ents"][i] = 1 + rng.randint(0, MAX_ENTS)
    ne = int(rec["n_ents"].astype(np.int64).sum())
    ent_term = rng.randint(0, 1000, ne).astype("<u4")
    ent_etype = rng.randint(0, 3, ne).astype("<u1")
    ent_len = rng.randint(0, 24, ne).astype("<u4")
    payload = rng.bytes(int(ent_len.astype(np.int64).sum()))
    return rec, ent_term, ent_etype, ent_len, payload


def blocks_of(arrays):
    """The same arrays as a block of each package (copies each)."""
    rec, et, ety, el, pay = arrays
    return tuple(mod.MsgBlock(rec.copy(), ent_term=et.copy(),
                              ent_etype=ety.copy(), ent_len=el.copy(),
                              payload=pay)
                 for mod in (jmb, tmb))


def assert_blocks_equal(a, b, context=""):
    assert a.rec.dtype == b.rec.dtype, context
    assert np.array_equal(a.rec, b.rec), context
    assert np.array_equal(a.ent_counts, b.ent_counts), context
    for f in ("ent_term", "ent_etype", "ent_len"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), (context, f)
    assert bytes(a.payload) == bytes(b.payload), context
    assert a.to_bytes() == b.to_bytes(), context


# -- raft/types.py copy ---------------------------------------------------------


@pytest.mark.parametrize("name", ["MessageType", "EntryType"])
def test_enums_pinned_equal(name):
    j, t = getattr(jtypes, name), getattr(ttypes, name)
    assert [(m.name, int(m)) for m in t] == [(m.name, int(m)) for m in j]
    assert all(str(t(int(m))) == str(m) for m in j)


@pytest.mark.parametrize("name", ["Entry", "Message", "Snapshot",
                                  "SnapshotMetadata", "ConfState"])
def test_dataclasses_pinned_equal(name):
    j, t = getattr(jtypes, name), getattr(ttypes, name)

    def shape(cls):
        out = []
        for f in dataclasses.fields(cls):
            default = (f.default_factory() if f.default_factory
                       is not dataclasses.MISSING else f.default)
            out.append((f.name, repr(default)))
        return out

    assert shape(t) == shape(j)


def test_entry_sizes_match():
    rng = np.random.RandomState(9)
    for _ in range(50):
        kw = dict(term=int(rng.randint(0, 1 << 30)),
                  index=int(rng.randint(0, 1 << 30)),
                  data=rng.bytes(int(rng.randint(0, 300))))
        je, te = jtypes.Entry(**kw), ttypes.Entry(**kw)
        assert te.size() == je.size()
        assert te.payload_size() == je.payload_size()
        assert te.clone() == te and te.clone() is not te


# -- codec -----------------------------------------------------------------------


def test_constants_match():
    assert tmb.WIRE_VERSION == jmb.WIRE_VERSION
    assert tmb.REC_DTYPE == jmb.REC_DTYPE and tmb.REC_SIZE == jmb.REC_SIZE
    assert tmb.ENT_DTYPE == jmb.ENT_DTYPE
    assert np.array_equal(tstep.LANE_OF, jstep.LANE_OF)
    assert tstep.NUM_WIRE_TYPES == jstep.NUM_WIRE_TYPES
    assert tstep.REC_WORDS * 4 == jmb.REC_SIZE


@pytest.mark.parametrize("seed", SEEDS)
def test_frames_byte_equal_and_cross_decode(seed):
    rng = np.random.RandomState(seed)
    jb, tb = blocks_of(random_arrays(rng, 200, garbage=seed % 2 == 1))
    frame = jb.to_bytes()
    assert tb.to_bytes() == frame
    # Either package reads the other's frame.
    assert_blocks_equal(jb, tmb.MsgBlock.from_bytes(frame), "jax->torch")
    assert_blocks_equal(jmb.MsgBlock.from_bytes(tb.to_bytes()), tb,
                        "torch->jax")
    # Entry lists and the compat accessors agree.
    assert tb.ents == jb.ents
    for i in rng.randint(0, len(jb), 10):
        assert tb.entry_list(int(i)) == jb.entry_list(int(i))


@pytest.mark.parametrize("bad", [
    b"", b"\x02", b"\x01\x00\x00\x00\x00\x00\x00\x00\x00",
    b"\x02\x01\x00\x00\x00", b"\x02\x00\x00\x00\x00\x00\x00\x00\x00\xff"])
def test_bad_frames_raise_alike(bad):
    with pytest.raises(ValueError) as je:
        jmb.MsgBlock.from_bytes(bad)
    with pytest.raises(ValueError) as te:
        tmb.MsgBlock.from_bytes(bad)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("seed", SEEDS)
def test_take_and_split_by_target_equal(seed):
    rng = np.random.RandomState(100 + seed)
    jb, tb = blocks_of(random_arrays(rng, 150))
    js, ts = jb.split_by_target(), tb.split_by_target()
    assert sorted(js) == sorted(ts)
    for to in js:
        assert_blocks_equal(js[to], ts[to], f"to={to}")
    mask = rng.rand(len(jb)) < 0.5
    idx = np.nonzero(rng.rand(len(jb)) < 0.3)[0][::-1]
    for sel in (mask, idx, slice(10, 90), slice(0, 0)):
        assert_blocks_equal(jb.take(sel), tb.take(sel), f"take {sel!r}")


@pytest.mark.parametrize("seed", SEEDS)
def test_validate_keeps_the_same_records(seed):
    rng = np.random.RandomState(200 + seed)
    arrays = random_arrays(rng, 300, garbage=True)
    jb, tb = blocks_of(arrays)
    jv = jmb.validate_block(jb, N_ROWS, R, MAX_ENTS)
    tv = tmb.validate_block(tb, N_ROWS, R, MAX_ENTS)
    assert 0 < len(tv) < len(tb)
    assert_blocks_equal(jv, tv)
    rec = arrays[0].copy()
    rec["n_ents"] = 0
    assert np.array_equal(jmb.validate_records(rec.copy(), N_ROWS, R),
                          tmb.validate_records(rec.copy(), N_ROWS, R))
    # A hand-built block whose arena does not back its counts keeps
    # only its payload-free records, alike.
    rec2, et, ety, el, pay = arrays
    lying = [mod.MsgBlock(rec2.copy(), ent_term=et[:-1].copy(),
                          ent_etype=ety[:-1].copy(), ent_len=el[:-1].copy(),
                          payload=pay) for mod in (jmb, tmb)]
    assert_blocks_equal(jmb.validate_block(lying[0], N_ROWS, R, MAX_ENTS),
                        tmb.validate_block(lying[1], N_ROWS, R, MAX_ENTS))


def dense_inbox(n, narrow):
    shape = (n, R, tstep.NUM_KINDS)
    dense = {f: np.zeros(shape, np.int32) for f in (
        "type", "term", "log_term", "index", "commit", "reject_hint", "ctx",
        "n_ents")}
    dense["valid"] = np.zeros(shape, bool)
    dense["reject"] = np.zeros(shape, bool)
    dense["ent_terms"] = np.zeros(shape + (MAX_ENTS,), np.int32)
    if narrow:
        dense["type"] = dense["type"].astype(np.int8)
        dense["n_ents"] = dense["n_ents"].astype(np.int16)
    return dense


@pytest.mark.parametrize("narrow", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_merge_blocks_equal_inbox_and_residual(seed, narrow):
    """Several blocks with key collisions (first wins inside a block,
    later records stay queued behind a deferred one), a pre-filled slot,
    then the residual merged again: equal dense inboxes, residuals and
    landed entries at every step."""
    rng = np.random.RandomState(300 + seed)
    sides = {}
    for name, mod in (("jax", jmb), ("torch", tmb)):
        sides[name] = {"mod": mod, "blocks": [], "landed": []}
    for _ in range(4):
        arrays = random_arrays(rng, 60)
        arrays[0]["row"] = rng.randint(0, 4, 60)  # dense keys collide
        jb, tb = blocks_of(arrays)
        sides["jax"]["blocks"].append(jb)
        sides["torch"]["blocks"].append(tb)
    prefill = (int(rng.randint(0, 4)), int(rng.randint(0, R)),
               int(rng.randint(0, tstep.NUM_KINDS)))
    for step_i in range(3):
        outs = {}
        for name, side in sides.items():
            dense = dense_inbox(N_ROWS, narrow)
            if step_i == 0:
                dense["valid"][prefill] = True

            def land(blk, idx, side=side):
                side["landed"].append((blk.to_bytes(), idx.tolist()))

            side["blocks"] = side["mod"].merge_blocks(
                side["blocks"], R, tstep.NUM_KINDS, dense,
                land_entries=land)
            outs[name] = dense
        for f, x in outs["jax"].items():
            y = outs["torch"][f]
            assert x.dtype == y.dtype and np.array_equal(x, y), (step_i, f)
        assert len(sides["jax"]["blocks"]) == len(sides["torch"]["blocks"])
        for a, b in zip(sides["jax"]["blocks"], sides["torch"]["blocks"]):
            assert_blocks_equal(a, b, f"residual {step_i}")
        assert sides["jax"]["landed"] == sides["torch"]["landed"]
    assert sides["torch"]["landed"]


@pytest.mark.parametrize("seed", SEEDS)
def test_ragged_ranges_equal(seed):
    rng = np.random.RandomState(400 + seed)
    starts = rng.randint(-50, 1000, 40)
    lens = rng.randint(0, 7, 40)
    got, want = tmb.ragged_ranges(starts, lens), jmb.ragged_ranges(starts,
                                                                   lens)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert len(tmb.ragged_ranges([], [])) == 0


@pytest.mark.parametrize("seed", SEEDS)
def test_compact_records_and_collect_block_equal(seed):
    """The packed collect (compact_records over [M, 9] int32 words) and
    the reference collect (collect_block over a numpy outbox) give
    equal records in both packages, and each other's."""
    rng = np.random.RandomState(500 + seed)
    n = 6
    shape = (n, R, tstep.NUM_KINDS)

    class Out:
        pass

    out = Out()
    out.type = rng.choice(np.append(TYPES, jstep.T_SNAP), shape).astype(
        np.int32)
    out.n_ents = rng.randint(0, MAX_ENTS + 1, shape).astype(np.int32)
    out.reject = rng.rand(*shape) < 0.3
    for f in ("term", "log_term", "index", "commit", "reject_hint", "ctx"):
        setattr(out, f, rng.randint(0, 1 << 30, shape).astype(np.int32))
    valid = rng.rand(*shape) < 0.6
    slots = rng.randint(0, R, n).astype(np.int32)
    jb, jc = jmb.collect_block(valid, out, slots)
    tb, tc = tmb.collect_block(valid, out, slots)
    assert_blocks_equal(jb, tb)
    assert np.array_equal(jc, tc)
    # Packed words (the port's pack_outbox) -> the same records.
    import torch

    from etcd_tpu_torch.batched.step import MsgSlots, pack_outbox

    slots_t = torch.as_tensor(slots)
    msgs = MsgSlots(
        valid=torch.as_tensor(valid), type=torch.as_tensor(out.type),
        term=torch.as_tensor(out.term), log_term=torch.as_tensor(out.log_term),
        index=torch.as_tensor(out.index), commit=torch.as_tensor(out.commit),
        reject=torch.as_tensor(out.reject),
        reject_hint=torch.as_tensor(out.reject_hint),
        n_ents=torch.as_tensor(out.n_ents), ctx=torch.as_tensor(out.ctx),
        ent_terms=torch.zeros(shape + (MAX_ENTS,), dtype=torch.int32))
    words, simple, cplx = (x.numpy() for x in pack_outbox(msgs, slots_t))
    for mod in (jmb, tmb):
        rec = mod.compact_records(words, simple)
        assert np.array_equal(rec, jb.rec)
    assert np.array_equal(cplx.reshape(shape), jc)


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_block_messages_equal(seed):
    rng = np.random.RandomState(600 + seed)
    arrays = random_arrays(rng, 80)
    jb, tb = blocks_of(arrays)
    jm, tm = jmb.block_messages(jb), tmb.block_messages(tb)
    assert len(jm) == len(tm) == len(jb)
    for (jr, a), (tr, b) in zip(jm, tm):
        assert jr == tr
        assert isinstance(b, ttypes.Message)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("seed", SEEDS)
def test_drop_superseded_keeps_all_but_older_heartbeats(seed):
    """A port-only step of hosting's ingest (ROADMAP C15): each queued
    MsgHeartbeat / MsgHeartbeatResp whose (row, sender, lane) a
    heartbeat of the arriving block also holds goes; every other record
    stays, in order, with its entries. Held against a plain loop over
    the records, for a random arriving block and for one made of the
    first queued block's heartbeats."""
    rng = np.random.RandomState(seed)
    queued = [blocks_of(random_arrays(rng, 40))[1] for _ in range(3)]
    hb = (tstep.T_HB, tstep.T_HB_RESP)

    def key(r):
        return (int(r["row"]), int(r["frm"]), int(r["lane"]))

    mine = queued[0].take(np.isin(queued[0].rec["type"], hb))
    assert len(mine), seed
    for new in (blocks_of(random_arrays(rng, 20))[1], mine):
        newer = {key(r) for r in new.rec if r["type"] in hb}
        want = [[i for i, r in enumerate(q.rec)
                 if not (r["type"] in hb and key(r) in newer)]
                for q in queued]
        got = tmb.drop_superseded(queued, new, hb)
        kept = [(q, w) for q, w in zip(queued, want) if w]
        assert len(got) == len(kept), seed
        for g, (q, w) in zip(got, kept):
            assert_blocks_equal(g, q.take(np.array(w, np.int64)), seed)
    assert len(got[0]) == len(queued[0]) - len(mine), seed
    # A block with no heartbeat drops nothing.
    quiet = queued[1].take(~np.isin(queued[1].rec["type"], hb))
    assert tmb.drop_superseded(queued, quiet, hb) == queued
