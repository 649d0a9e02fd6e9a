"""server.api KV dataclasses <-> etcdserverpb wire messages.

proto3 (like the reference's rpc.proto): zero-valued scalars are
omitted on the wire by BOTH the reference's gogo marshaler and python
protobuf, so no explicit-presence discipline is needed here (contrast
convert.py for the proto2 raftpb layer).

Ports ``etcd_tpu/pb/kv_convert.py``.
"""

from __future__ import annotations

from ..server.api import (
    Compare,
    CompareResult,
    CompareTarget,
    LeaseGrantRequest,
    LeaseGrantResponse,
    LeaseRevokeRequest,
    DeleteRangeRequest,
    DeleteRangeResponse,
    KeyValue,
    PutRequest,
    PutResponse,
    RangeRequest,
    RangeResponse,
    RequestOp,
    ResponseHeader,
    ResponseOp,
    SortOrder,
    SortTarget,
    TxnRequest,
    TxnResponse,
)
from . import kv_pb2 as kpb


def kv_to_pb(kv: KeyValue) -> "kpb.KeyValue":
    return kpb.KeyValue(
        key=kv.key, create_revision=kv.create_revision,
        mod_revision=kv.mod_revision, version=kv.version,
        value=kv.value, lease=kv.lease,
    )


def kv_from_pb(p: "kpb.KeyValue") -> KeyValue:
    return KeyValue(
        key=p.key, create_revision=p.create_revision,
        mod_revision=p.mod_revision, version=p.version,
        value=p.value, lease=p.lease,
    )


def header_to_pb(h: ResponseHeader) -> "kpb.ResponseHeader":
    return kpb.ResponseHeader(
        cluster_id=h.cluster_id, member_id=h.member_id,
        revision=h.revision, raft_term=h.raft_term,
    )


def header_from_pb(p: "kpb.ResponseHeader") -> ResponseHeader:
    return ResponseHeader(
        cluster_id=p.cluster_id, member_id=p.member_id,
        revision=p.revision, raft_term=p.raft_term,
    )


def put_request_to_pb(r: PutRequest) -> "kpb.PutRequest":
    return kpb.PutRequest(
        key=r.key, value=r.value, lease=r.lease, prev_kv=r.prev_kv,
        ignore_value=r.ignore_value, ignore_lease=r.ignore_lease,
    )


def put_request_from_pb(p: "kpb.PutRequest") -> PutRequest:
    return PutRequest(
        key=p.key, value=p.value, lease=p.lease, prev_kv=p.prev_kv,
        ignore_value=p.ignore_value, ignore_lease=p.ignore_lease,
    )


def put_response_to_pb(r: PutResponse) -> "kpb.PutResponse":
    out = kpb.PutResponse(header=header_to_pb(r.header))
    if r.prev_kv is not None:  # oneof-like presence: only set if given
        out.prev_kv.CopyFrom(kv_to_pb(r.prev_kv))
    return out


def put_response_from_pb(p: "kpb.PutResponse") -> PutResponse:
    return PutResponse(
        header=header_from_pb(p.header),
        prev_kv=kv_from_pb(p.prev_kv) if p.HasField("prev_kv") else None,
    )


def range_request_to_pb(r: RangeRequest) -> "kpb.RangeRequest":
    return kpb.RangeRequest(
        key=r.key, range_end=r.range_end, limit=r.limit,
        revision=r.revision, sort_order=int(r.sort_order),
        sort_target=int(r.sort_target), serializable=r.serializable,
        keys_only=r.keys_only, count_only=r.count_only,
        min_mod_revision=r.min_mod_revision,
        max_mod_revision=r.max_mod_revision,
        min_create_revision=r.min_create_revision,
        max_create_revision=r.max_create_revision,
    )


def _enum(cls, val, default):
    """proto3 enums are OPEN: unknown wire values parse fine and must
    not crash the decode path — fall back to the default (the
    reference's Go handlers see the raw int and likewise do not
    reject at decode time)."""
    try:
        return cls(val)
    except ValueError:
        return default


def range_request_from_pb(p: "kpb.RangeRequest") -> RangeRequest:
    return RangeRequest(
        key=p.key, range_end=p.range_end, limit=p.limit,
        revision=p.revision,
        sort_order=_enum(SortOrder, p.sort_order, SortOrder.NONE),
        sort_target=_enum(SortTarget, p.sort_target, SortTarget.KEY),
        serializable=p.serializable, keys_only=p.keys_only,
        count_only=p.count_only,
        min_mod_revision=p.min_mod_revision,
        max_mod_revision=p.max_mod_revision,
        min_create_revision=p.min_create_revision,
        max_create_revision=p.max_create_revision,
    )


def range_response_to_pb(r: RangeResponse) -> "kpb.RangeResponse":
    return kpb.RangeResponse(
        header=header_to_pb(r.header), more=r.more, count=r.count,
        kvs=[kv_to_pb(kv) for kv in r.kvs])


def range_response_from_pb(p: "kpb.RangeResponse") -> RangeResponse:
    return RangeResponse(
        header=header_from_pb(p.header),
        kvs=[kv_from_pb(kv) for kv in p.kvs],
        more=p.more, count=p.count,
    )


def delete_request_to_pb(r: DeleteRangeRequest) -> "kpb.DeleteRangeRequest":
    return kpb.DeleteRangeRequest(
        key=r.key, range_end=r.range_end, prev_kv=r.prev_kv)


def delete_request_from_pb(p: "kpb.DeleteRangeRequest") -> DeleteRangeRequest:
    return DeleteRangeRequest(
        key=p.key, range_end=p.range_end, prev_kv=p.prev_kv)


def delete_response_to_pb(r: DeleteRangeResponse) -> "kpb.DeleteRangeResponse":
    return kpb.DeleteRangeResponse(
        header=header_to_pb(r.header), deleted=r.deleted,
        prev_kvs=[kv_to_pb(kv) for kv in r.prev_kvs])


def delete_response_from_pb(p: "kpb.DeleteRangeResponse") -> DeleteRangeResponse:
    return DeleteRangeResponse(
        header=header_from_pb(p.header), deleted=p.deleted,
        prev_kvs=[kv_from_pb(kv) for kv in p.prev_kvs],
    )


def compare_to_pb(c: Compare) -> "kpb.Compare":
    out = kpb.Compare(result=int(c.result), target=int(c.target),
                      key=c.key)
    if c.range_end:
        out.range_end = c.range_end
    # The oneof member matching `target` carries the operand (how the
    # reference's clientv3 builds Compare, clientv3/compare.go).
    t = c.target
    if t == CompareTarget.VERSION:
        out.version = c.version
    elif t == CompareTarget.CREATE:
        out.create_revision = c.create_revision
    elif t == CompareTarget.MOD:
        out.mod_revision = c.mod_revision
    elif t == CompareTarget.VALUE:
        out.value = c.value
    elif t == CompareTarget.LEASE:
        out.lease = c.lease
    return out


def compare_from_pb(p: "kpb.Compare") -> Compare:
    c = Compare(
        result=_enum(CompareResult, p.result, CompareResult.EQUAL),
        target=_enum(CompareTarget, p.target, CompareTarget.VERSION),
        key=p.key, range_end=p.range_end,
    )
    which = p.WhichOneof("target_union")
    if which is not None:
        setattr(c, which, getattr(p, which))
    return c


def request_op_to_pb(op: RequestOp) -> "kpb.RequestOp":
    out = kpb.RequestOp()
    if op.request_range is not None:
        out.request_range.CopyFrom(range_request_to_pb(op.request_range))
    elif op.request_put is not None:
        out.request_put.CopyFrom(put_request_to_pb(op.request_put))
    elif op.request_delete_range is not None:
        out.request_delete_range.CopyFrom(
            delete_request_to_pb(op.request_delete_range))
    elif op.request_txn is not None:
        out.request_txn.CopyFrom(txn_request_to_pb(op.request_txn))
    return out


def request_op_from_pb(p: "kpb.RequestOp") -> RequestOp:
    which = p.WhichOneof("request")
    if which == "request_range":
        return RequestOp(request_range=range_request_from_pb(p.request_range))
    if which == "request_put":
        return RequestOp(request_put=put_request_from_pb(p.request_put))
    if which == "request_delete_range":
        return RequestOp(request_delete_range=delete_request_from_pb(
            p.request_delete_range))
    if which == "request_txn":
        return RequestOp(request_txn=txn_request_from_pb(p.request_txn))
    return RequestOp()


def response_op_to_pb(op: ResponseOp) -> "kpb.ResponseOp":
    out = kpb.ResponseOp()
    if op.response_range is not None:
        out.response_range.CopyFrom(
            range_response_to_pb(op.response_range))
    elif op.response_put is not None:
        out.response_put.CopyFrom(put_response_to_pb(op.response_put))
    elif op.response_delete_range is not None:
        out.response_delete_range.CopyFrom(
            delete_response_to_pb(op.response_delete_range))
    elif op.response_txn is not None:
        out.response_txn.CopyFrom(txn_response_to_pb(op.response_txn))
    return out


def response_op_from_pb(p: "kpb.ResponseOp") -> ResponseOp:
    which = p.WhichOneof("response")
    if which == "response_range":
        return ResponseOp(
            response_range=range_response_from_pb(p.response_range))
    if which == "response_put":
        return ResponseOp(response_put=put_response_from_pb(p.response_put))
    if which == "response_delete_range":
        return ResponseOp(response_delete_range=delete_response_from_pb(
            p.response_delete_range))
    if which == "response_txn":
        return ResponseOp(
            response_txn=txn_response_from_pb(p.response_txn))
    return ResponseOp()


def txn_request_to_pb(r: TxnRequest) -> "kpb.TxnRequest":
    return kpb.TxnRequest(
        compare=[compare_to_pb(c) for c in r.compare],
        success=[request_op_to_pb(op) for op in r.success],
        failure=[request_op_to_pb(op) for op in r.failure])


def txn_request_from_pb(p: "kpb.TxnRequest") -> TxnRequest:
    return TxnRequest(
        compare=[compare_from_pb(c) for c in p.compare],
        success=[request_op_from_pb(op) for op in p.success],
        failure=[request_op_from_pb(op) for op in p.failure],
    )


def txn_response_to_pb(r: TxnResponse) -> "kpb.TxnResponse":
    return kpb.TxnResponse(
        header=header_to_pb(r.header), succeeded=r.succeeded,
        responses=[response_op_to_pb(op) for op in r.responses])


def txn_response_from_pb(p: "kpb.TxnResponse") -> TxnResponse:
    return TxnResponse(
        header=header_from_pb(p.header), succeeded=p.succeeded,
        responses=[response_op_from_pb(op) for op in p.responses],
    )


# -- watch / lease -------------------------------------------------------------

def mvcc_kv_to_pb(kv) -> "kpb.KeyValue":
    # mvcc and server.api KeyValue are field-identical dataclasses, so
    # kv_to_pb serves both (duck-typed) — one copy site.
    return kv_to_pb(kv)


def mvcc_kv_from_pb(p: "kpb.KeyValue"):
    from ..storage.mvcc.kv import KeyValue as MvccKV

    k = kv_from_pb(p)
    return MvccKV(key=k.key, create_revision=k.create_revision,
                  mod_revision=k.mod_revision, version=k.version,
                  value=k.value, lease=k.lease)


def event_to_pb(ev) -> "kpb.Event":
    """mvcc.Event -> mvccpb.Event wire message."""
    out = kpb.Event(type=int(ev.type), kv=mvcc_kv_to_pb(ev.kv))
    if ev.prev_kv is not None:
        out.prev_kv.CopyFrom(mvcc_kv_to_pb(ev.prev_kv))
    return out


def event_from_pb(p: "kpb.Event"):
    from ..storage.mvcc.kv import Event, EventType

    return Event(
        type=EventType(p.type), kv=mvcc_kv_from_pb(p.kv),
        prev_kv=(mvcc_kv_from_pb(p.prev_kv)
                 if p.HasField("prev_kv") else None),
    )


def watch_events_to_pb(header: ResponseHeader, watch_id: int,
                       events) -> "kpb.WatchResponse":
    """One watch-stream delivery as an etcdserverpb WatchResponse."""
    return kpb.WatchResponse(
        header=header_to_pb(header), watch_id=watch_id,
        events=[event_to_pb(ev) for ev in events])


def lease_grant_request_to_pb(r) -> "kpb.LeaseGrantRequest":
    return kpb.LeaseGrantRequest(TTL=r.ttl, ID=r.id)


def lease_grant_request_from_pb(p: "kpb.LeaseGrantRequest"):
    return LeaseGrantRequest(ttl=p.TTL, id=p.ID)


def lease_grant_response_to_pb(r) -> "kpb.LeaseGrantResponse":
    return kpb.LeaseGrantResponse(
        header=header_to_pb(r.header), ID=r.id, TTL=r.ttl,
        error=r.error)


def lease_grant_response_from_pb(p: "kpb.LeaseGrantResponse"):
    return LeaseGrantResponse(header=header_from_pb(p.header), id=p.ID,
                              ttl=p.TTL, error=p.error)


def lease_revoke_request_to_pb(r) -> "kpb.LeaseRevokeRequest":
    return kpb.LeaseRevokeRequest(ID=r.id)


def lease_revoke_request_from_pb(p: "kpb.LeaseRevokeRequest"):
    return LeaseRevokeRequest(id=p.ID)
