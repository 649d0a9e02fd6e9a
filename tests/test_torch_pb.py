"""PyTorch port ↔ JAX reference: the protobuf layer (``pb/``).

Both packages' ``pb`` load in one process: each ``*_pb2`` registers its
file in protobuf's default pool, and the port's serialized descriptors
are the reference's bytes, so the second registration is accepted and
both share one descriptor. tests/pkg/test_pb_wire.py's and
test_kv_pb_wire.py's round trips run through both packages' converters
on seeded inputs: the raft messages (every type, with entries, a
snapshot, a context), HardState, ConfChange and ConfChangeV2, and the
KV subset (put, range, delete and txn requests and responses with
nested txns, events, lease grants): equal bytes, each side decodes the
other's bytes, and the decoded objects are equal.
"""

import numpy as np
import pytest

import etcd_tpu.pb as rpb
import etcd_tpu.pb.kv_convert as rkv
import etcd_tpu.raft.types as rtypes
import etcd_tpu.server.api as rapi
import etcd_tpu_torch.pb as tpb
import etcd_tpu_torch.pb.kv_convert as tkv
import etcd_tpu_torch.raft.types as ttypes
import etcd_tpu_torch.server.api as tapi
from etcd_tpu_torch.tools.server_script import plain

SEEDS = range(6)


def test_both_packages_share_the_descriptors():
    for name in ("raft_pb2", "kv_pb2"):
        r, t = getattr(rpb, name), getattr(tpb, name)
        assert t.DESCRIPTOR.serialized_pb == r.DESCRIPTOR.serialized_pb
        assert t.DESCRIPTOR is r.DESCRIPTOR


def test_golden_hardstate_bytes():
    """tests/pkg/test_pb_wire.py's gogo bytes, from the port."""
    assert tpb.hardstate_to_pb(ttypes.HardState(term=2, vote=3, commit=4)) \
        .SerializeToString() == bytes.fromhex("080210031804")
    assert tpb.hardstate_to_pb(ttypes.HardState()).SerializeToString() \
        == bytes.fromhex("080010001800")


def _message(types, rng):
    """A seeded raft Message of either package (same draws)."""
    mt = int(rng.randint(19))
    ents = [types.Entry(term=int(rng.randint(1, 9)), index=int(10 + i),
                        type=types.EntryType(int(rng.randint(3))),
                        data=rng.bytes(int(rng.randint(0, 12))))
            for i in range(int(rng.randint(0, 4)))]
    snap = types.Snapshot()
    if rng.rand() < 0.4:
        snap = types.Snapshot(
            data=rng.bytes(int(rng.randint(1, 16))),
            metadata=types.SnapshotMetadata(
                conf_state=types.ConfState(
                    voters=[1, 2, 3], learners=[int(rng.randint(4, 9))],
                    voters_outgoing=[1, 2] if rng.rand() < 0.5 else [],
                    auto_leave=bool(rng.rand() < 0.5)),
                index=int(rng.randint(1, 1000)),
                term=int(rng.randint(1, 9))))
    return types.Message(
        type=types.MessageType(mt), to=int(rng.randint(1, 1 << 62)),
        from_=int(rng.randint(1, 1 << 62)), term=int(rng.randint(0, 99)),
        log_term=int(rng.randint(0, 99)), index=int(rng.randint(0, 1 << 40)),
        entries=ents, commit=int(rng.randint(0, 1 << 40)), snapshot=snap,
        reject=bool(rng.rand() < 0.3), reject_hint=int(rng.randint(0, 99)),
        context=rng.bytes(int(rng.randint(0, 9))))


@pytest.mark.parametrize("seed", SEEDS)
def test_raft_messages_cross_both_converters(seed):
    for _ in range(8):
        seed_state = np.random.RandomState(seed).get_state()
        rng = np.random.RandomState()
        rng.set_state(seed_state)
        rm = _message(rtypes, rng)
        rng.set_state(seed_state)
        tm = _message(ttypes, rng)
        seed += 1000
        rb, tb = rpb.message_to_bytes(rm), tpb.message_to_bytes(tm)
        assert tb == rb
        assert plain(tpb.message_from_bytes(rb)) == plain(
            rpb.message_from_bytes(tb)) == plain(rm)


@pytest.mark.parametrize("seed", SEEDS)
def test_confchanges_and_hardstate_cross_both_converters(seed):
    rng = np.random.RandomState(seed)
    for _ in range(6):
        t, nid = int(rng.randint(4)), int(rng.randint(1, 1 << 62))
        ctx = rng.bytes(int(rng.randint(0, 8)))
        pair = [m.ConfChange(type=m.ConfChangeType(t), node_id=nid,
                             context=ctx) for m in (rtypes, ttypes)]
        rb = rpb.confchange_to_pb(pair[0]).SerializeToString()
        assert tpb.confchange_to_pb(pair[1]).SerializeToString() == rb
        p = rpb.raft_pb2.ConfChange.FromString(rb)
        assert plain(tpb.confchange_from_pb(p)) == plain(
            rpb.confchange_from_pb(p))
        changes = [(int(rng.randint(4)), int(rng.randint(1, 99)))
                   for _ in range(int(rng.randint(1, 4)))]
        tr = int(rng.randint(3))
        pair = [m.ConfChangeV2(
            transition=m.ConfChangeTransition(tr),
            changes=[m.ConfChangeSingle(type=m.ConfChangeType(a), node_id=b)
                     for a, b in changes], context=ctx)
            for m in (rtypes, ttypes)]
        rb = rpb.confchange_v2_to_pb(pair[0]).SerializeToString()
        assert tpb.confchange_v2_to_pb(pair[1]).SerializeToString() == rb
        p = rpb.raft_pb2.ConfChangeV2.FromString(rb)
        assert plain(tpb.confchange_v2_from_pb(p)) == plain(
            rpb.confchange_v2_from_pb(p))
        hs = [m.HardState(term=nid % 997, vote=nid, commit=nid % 1013)
              for m in (rtypes, ttypes)]
        assert tpb.hardstate_to_pb(hs[1]).SerializeToString() == \
            rpb.hardstate_to_pb(hs[0]).SerializeToString()


def _kv(api, rng, with_lease=True):
    return api.KeyValue(
        key=rng.bytes(int(rng.randint(1, 8))),
        create_revision=int(rng.randint(1, 99)),
        mod_revision=int(rng.randint(1, 99)),
        version=int(rng.randint(1, 9)), value=rng.bytes(int(rng.randint(8))),
        lease=int(rng.randint(0, 1 << 40)) if with_lease else 0)


def _header(api, rng):
    return api.ResponseHeader(
        cluster_id=int(rng.randint(1, 1 << 62)),
        member_id=int(rng.randint(1, 1 << 62)),
        revision=int(rng.randint(1, 1 << 40)),
        raft_term=int(rng.randint(1, 99)))


def _txn(api, rng, depth=0):
    cmp = [api.Compare(
        result=api.CompareResult(int(rng.randint(4))),
        target=api.CompareTarget(int(rng.randint(5))),
        key=rng.bytes(3), value=rng.bytes(2), version=int(rng.randint(9)),
        create_revision=int(rng.randint(9)), mod_revision=int(rng.randint(9)),
        lease=int(rng.randint(9))) for _ in range(int(rng.randint(0, 3)))]

    def op():
        k = int(rng.randint(4 if depth == 0 else 3))
        if k == 0:
            return api.RequestOp(request_put=api.PutRequest(
                key=rng.bytes(3), value=rng.bytes(4),
                prev_kv=bool(rng.rand() < 0.5)))
        if k == 1:
            return api.RequestOp(request_range=api.RangeRequest(
                key=rng.bytes(2), range_end=rng.bytes(2),
                limit=int(rng.randint(5))))
        if k == 2:
            return api.RequestOp(request_delete_range=api.DeleteRangeRequest(
                key=rng.bytes(2), prev_kv=bool(rng.rand() < 0.5)))
        return api.RequestOp(request_txn=_txn(api, rng, depth + 1))

    return api.TxnRequest(
        compare=cmp, success=[op() for _ in range(int(rng.randint(0, 3)))],
        failure=[op() for _ in range(int(rng.randint(0, 3)))])


def _kv_cases(api, rng):
    """(to_pb name, from_pb name, object) of the KV subset."""
    h = _header(api, rng)
    return [
        ("put_request", api.PutRequest(
            key=rng.bytes(4), value=rng.bytes(6), lease=int(rng.randint(9)),
            prev_kv=bool(rng.rand() < 0.5),
            ignore_value=bool(rng.rand() < 0.2))),
        ("put_response", api.PutResponse(
            header=h, prev_kv=_kv(api, rng) if rng.rand() < 0.5 else None)),
        ("range_request", api.RangeRequest(
            key=rng.bytes(3), range_end=rng.bytes(3),
            limit=int(rng.randint(9)), revision=int(rng.randint(9)),
            sort_order=api.SortOrder(int(rng.randint(3))),
            sort_target=api.SortTarget(int(rng.randint(5))),
            serializable=bool(rng.rand() < 0.5),
            keys_only=bool(rng.rand() < 0.5),
            count_only=bool(rng.rand() < 0.5))),
        ("range_response", api.RangeResponse(
            header=h, kvs=[_kv(api, rng) for _ in range(int(rng.randint(4)))],
            more=bool(rng.rand() < 0.5), count=int(rng.randint(9)))),
        ("delete_request", api.DeleteRangeRequest(
            key=rng.bytes(3), range_end=rng.bytes(2),
            prev_kv=bool(rng.rand() < 0.5))),
        ("delete_response", api.DeleteRangeResponse(
            header=h, deleted=int(rng.randint(5)),
            prev_kvs=[_kv(api, rng) for _ in range(int(rng.randint(3)))])),
        ("txn_request", _txn(api, rng)),
    ]


@pytest.mark.parametrize("seed", SEEDS)
def test_kv_subset_crosses_both_converters(seed):
    seed_state = np.random.RandomState(seed).get_state()
    rng = np.random.RandomState()
    rng.set_state(seed_state)
    rcases = _kv_cases(rapi, rng)
    rng.set_state(seed_state)
    tcases = _kv_cases(tapi, rng)
    for (name, robj), (_, tobj) in zip(rcases, tcases):
        rb = getattr(rkv, f"{name}_to_pb")(robj).SerializeToString()
        tb = getattr(tkv, f"{name}_to_pb")(tobj).SerializeToString()
        assert tb == rb, name
        msg = getattr(rkv, f"{name}_to_pb")(robj)
        back_r = getattr(rkv, f"{name}_from_pb")(type(msg).FromString(tb))
        back_t = getattr(tkv, f"{name}_from_pb")(type(msg).FromString(rb))
        assert plain(back_t) == plain(back_r), name


def test_events_and_leases_cross_both_converters():
    from etcd_tpu.storage.mvcc import kv as rmvcc
    from etcd_tpu_torch.storage.mvcc import kv as tmvcc

    out = []
    for mvcc, kvc in ((rmvcc, rkv), (tmvcc, tkv)):
        kv = mvcc.KeyValue(key=b"k", create_revision=3, mod_revision=5,
                           version=2, value=b"v", lease=7)
        evs = [mvcc.Event(type=mvcc.EventType.PUT, kv=kv),
               mvcc.Event(type=mvcc.EventType.DELETE, kv=kv)]
        out.append([kvc.event_to_pb(e).SerializeToString() for e in evs]
                   + [plain(kvc.event_from_pb(kvc.event_to_pb(e)))
                      for e in evs])
    assert out[1] == out[0]
