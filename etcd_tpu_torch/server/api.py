"""Request/response model: the etcdserverpb analog
(ref: api/etcdserverpb/rpc.proto and raft_internal.proto).

The reference's InternalRaftRequest is a protobuf union of every
replicated operation; here it is a tagged dict serialized as JSON with
hex-encoded byte fields. JSON costs more than proto on the wire but the
replicated payload stays host-side (entry *data* never lands on the
TPU — the device sees only (term,index) metadata; SURVEY.md §7 "payload
bytes don't belong on the TPU"), so clarity wins.

Ports ``etcd_tpu/server/api.py``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Any, Dict, List, Optional

from ..storage.mvcc.kv import KeyValue


# -- sort / compare enums (rpc.proto RangeRequest/Compare) ---------------------


class SortOrder(IntEnum):
    NONE = 0
    ASCEND = 1
    DESCEND = 2


class SortTarget(IntEnum):
    KEY = 0
    VERSION = 1
    CREATE = 2
    MOD = 3
    VALUE = 4


class CompareResult(IntEnum):
    EQUAL = 0
    GREATER = 1
    LESS = 2
    NOT_EQUAL = 3


class CompareTarget(IntEnum):
    VERSION = 0
    CREATE = 1
    MOD = 2
    VALUE = 3
    LEASE = 4


class AlarmType(IntEnum):
    NONE = 0
    NOSPACE = 1
    CORRUPT = 2


class AlarmAction(IntEnum):
    GET = 0
    ACTIVATE = 1
    DEACTIVATE = 2


@dataclass
class ResponseHeader:
    cluster_id: int = 0
    member_id: int = 0
    revision: int = 0
    raft_term: int = 0


@dataclass
class PutRequest:
    key: bytes = b""
    value: bytes = b""
    lease: int = 0
    prev_kv: bool = False
    ignore_value: bool = False
    ignore_lease: bool = False


@dataclass
class PutResponse:
    header: ResponseHeader = field(default_factory=ResponseHeader)
    prev_kv: Optional[KeyValue] = None


@dataclass
class RangeRequest:
    key: bytes = b""
    range_end: bytes = b""
    limit: int = 0
    revision: int = 0
    sort_order: SortOrder = SortOrder.NONE
    sort_target: SortTarget = SortTarget.KEY
    serializable: bool = False
    keys_only: bool = False
    count_only: bool = False
    min_mod_revision: int = 0
    max_mod_revision: int = 0
    min_create_revision: int = 0
    max_create_revision: int = 0


@dataclass
class RangeResponse:
    header: ResponseHeader = field(default_factory=ResponseHeader)
    kvs: List[KeyValue] = field(default_factory=list)
    more: bool = False
    count: int = 0


@dataclass
class DeleteRangeRequest:
    key: bytes = b""
    range_end: bytes = b""
    prev_kv: bool = False


@dataclass
class DeleteRangeResponse:
    header: ResponseHeader = field(default_factory=ResponseHeader)
    deleted: int = 0
    prev_kvs: List[KeyValue] = field(default_factory=list)


@dataclass
class Compare:
    result: CompareResult = CompareResult.EQUAL
    target: CompareTarget = CompareTarget.VERSION
    key: bytes = b""
    range_end: bytes = b""  # rpc.proto Compare.range_end (txn range compares)
    version: int = 0
    create_revision: int = 0
    mod_revision: int = 0
    value: bytes = b""
    lease: int = 0


@dataclass
class RequestOp:
    """Union: exactly one member set (rpc.proto RequestOp)."""

    request_range: Optional[RangeRequest] = None
    request_put: Optional[PutRequest] = None
    request_delete_range: Optional[DeleteRangeRequest] = None
    request_txn: Optional["TxnRequest"] = None


@dataclass
class ResponseOp:
    response_range: Optional[RangeResponse] = None
    response_put: Optional[PutResponse] = None
    response_delete_range: Optional[DeleteRangeResponse] = None
    response_txn: Optional["TxnResponse"] = None


@dataclass
class TxnRequest:
    compare: List[Compare] = field(default_factory=list)
    success: List[RequestOp] = field(default_factory=list)
    failure: List[RequestOp] = field(default_factory=list)


@dataclass
class TxnResponse:
    header: ResponseHeader = field(default_factory=ResponseHeader)
    succeeded: bool = False
    responses: List[ResponseOp] = field(default_factory=list)


@dataclass
class CompactionRequest:
    revision: int = 0
    physical: bool = False


@dataclass
class CompactionResponse:
    header: ResponseHeader = field(default_factory=ResponseHeader)


@dataclass
class LeaseGrantRequest:
    ttl: int = 0
    id: int = 0


@dataclass
class LeaseGrantResponse:
    header: ResponseHeader = field(default_factory=ResponseHeader)
    id: int = 0
    ttl: int = 0
    error: str = ""


@dataclass
class LeaseRevokeRequest:
    id: int = 0


@dataclass
class LeaseRevokeResponse:
    header: ResponseHeader = field(default_factory=ResponseHeader)


@dataclass
class LeaseCheckpoint:
    id: int = 0
    remaining_ttl: int = 0


@dataclass
class LeaseCheckpointRequest:
    checkpoints: List[LeaseCheckpoint] = field(default_factory=list)


@dataclass
class AlarmRequest:
    action: AlarmAction = AlarmAction.GET
    member_id: int = 0
    alarm: AlarmType = AlarmType.NONE


@dataclass
class AlarmMember:
    member_id: int = 0
    alarm: AlarmType = AlarmType.NONE


@dataclass
class AlarmResponse:
    header: ResponseHeader = field(default_factory=ResponseHeader)
    alarms: List[AlarmMember] = field(default_factory=list)


# -- auth ops (rpc.proto Auth service; all replicated via raft) ----------------


@dataclass
class AuthRequest:
    """Union of auth mutations, tagged by `op` (the reference gives each
    its own message; the applier dispatch is equivalent)."""

    op: str = ""  # enable|disable|user_add|user_delete|...
    name: str = ""
    password: str = ""
    role: str = ""
    key: bytes = b""
    range_end: bytes = b""
    perm_type: int = 0
    no_password: bool = False


# -- internal raft request -----------------------------------------------------

_BYTES_FIELDS = {"key", "value", "range_end"}


def _enc(obj: Any) -> Any:
    if isinstance(obj, bytes):
        return obj.hex()
    if isinstance(obj, list):
        return [_enc(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _enc(v) for k, v in obj.items()}
    if hasattr(obj, "__dataclass_fields__"):
        out = {}
        for f in obj.__dataclass_fields__:
            v = getattr(obj, f)
            if v is None:
                continue
            out[f] = _enc(v)
        return out
    if isinstance(obj, IntEnum):
        return int(obj)
    return obj


def _dec_bytes(v: Any) -> bytes:
    return bytes.fromhex(v) if isinstance(v, str) else v


def _build(cls, d: Dict[str, Any]):
    """Rehydrate a dataclass from a json dict (recursive on known fields)."""
    kw = {}
    for f, fd in cls.__dataclass_fields__.items():
        if f not in d:
            continue
        v = d[f]
        t = fd.type
        if f in ("key", "value", "range_end") or t == "bytes":
            kw[f] = _dec_bytes(v)
        elif f == "compare":
            kw[f] = [_build(Compare, x) for x in v]
        elif f in ("success", "failure"):
            kw[f] = [_build_request_op(x) for x in v]
        elif f == "checkpoints":
            kw[f] = [_build(LeaseCheckpoint, x) for x in v]
        else:
            kw[f] = v
    return cls(**kw)


def _build_request_op(d: Dict[str, Any]) -> RequestOp:
    op = RequestOp()
    if "request_range" in d:
        op.request_range = _build(RangeRequest, d["request_range"])
    if "request_put" in d:
        op.request_put = _build(PutRequest, d["request_put"])
    if "request_delete_range" in d:
        op.request_delete_range = _build(DeleteRangeRequest, d["request_delete_range"])
    if "request_txn" in d:
        op.request_txn = _build(TxnRequest, d["request_txn"])
    return op


_REQUEST_TYPES = {
    "put": PutRequest,
    "range": RangeRequest,
    "delete_range": DeleteRangeRequest,
    "txn": TxnRequest,
    "compaction": CompactionRequest,
    "lease_grant": LeaseGrantRequest,
    "lease_revoke": LeaseRevokeRequest,
    "lease_checkpoint": LeaseCheckpointRequest,
    "alarm": AlarmRequest,
    "auth": AuthRequest,
    "cluster_member_attr": None,  # dict passthrough
    "downgrade": None,
}


@dataclass
class InternalRaftRequest:
    """ref: api/etcdserverpb/raft_internal.proto — union of all
    replicated ops, one field set per request."""

    id: int = 0
    op: str = ""
    req: Any = None
    # The username+revision the proposal was authorized under; re-checked
    # at apply time (raft_internal.proto header.username/auth_revision).
    username: str = ""
    auth_revision: int = 0

    def marshal(self) -> bytes:
        return json.dumps(
            {
                "id": self.id,
                "op": self.op,
                "req": _enc(self.req),
                "u": self.username,
                "ar": self.auth_revision,
            },
            separators=(",", ":"),
        ).encode()

    @staticmethod
    def unmarshal(data: bytes) -> "InternalRaftRequest":
        d = json.loads(data.decode())
        op = d["op"]
        cls = _REQUEST_TYPES.get(op)
        if op == "txn":
            req = _build(TxnRequest, d["req"])
        elif cls is not None:
            req = _build(cls, d["req"])
        else:
            req = d["req"]
        return InternalRaftRequest(
            id=d["id"],
            op=op,
            req=req,
            username=d.get("u", ""),
            auth_revision=d.get("ar", 0),
        )
