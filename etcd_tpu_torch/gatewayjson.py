"""grpc-gateway JSON interop surface (ref: server/embed/serve.go
registering the grpc-gateway mux; api/etcdserverpb/gw/rpc.pb.gw.go
routes). POST /v3/<service>/<method> with a JSON body; byte fields
(key, value, range_end...) travel base64, exactly like the gateway's
protobuf-JSON mapping.

Routes (the reference's curl surface):
    /v3/kv/range | put | deleterange | txn | compaction
    /v3/lease/grant | revoke | timetolive | leases
    /v3/maintenance/status | hash
    /v3/cluster/member/list
    /v3/auth/authenticate

Ports ``etcd_tpu/gatewayjson.py``.
"""

from __future__ import annotations

import base64
import json
from typing import Any, Dict, Optional

from . import version as ver
from .server import api as sapi


def _b64d(v: Optional[str]) -> bytes:
    return base64.b64decode(v) if v else b""


def _b64e(b: bytes) -> str:
    return base64.b64encode(b).decode()


def _enc_header(h: sapi.ResponseHeader) -> Dict[str, Any]:
    return {
        "cluster_id": str(h.cluster_id),
        "member_id": str(h.member_id),
        "revision": str(h.revision),
        "raft_term": str(h.raft_term),
    }


def _enc_kv(kv) -> Dict[str, Any]:
    return {
        "key": _b64e(kv.key),
        "create_revision": str(kv.create_revision),
        "mod_revision": str(kv.mod_revision),
        "version": str(kv.version),
        "value": _b64e(kv.value),
        "lease": str(kv.lease),
    }


def _dec_range(body: Dict[str, Any]) -> sapi.RangeRequest:
    return sapi.RangeRequest(
        key=_b64d(body.get("key")),
        range_end=_b64d(body.get("range_end")),
        limit=int(body.get("limit", 0)),
        revision=int(body.get("revision", 0)),
        serializable=bool(body.get("serializable", False)),
        keys_only=bool(body.get("keys_only", False)),
        count_only=bool(body.get("count_only", False)),
        sort_order=sapi.SortOrder(int(body.get("sort_order", 0))),
        sort_target=sapi.SortTarget(int(body.get("sort_target", 0))),
    )


def _dec_put(body: Dict[str, Any]) -> sapi.PutRequest:
    return sapi.PutRequest(
        key=_b64d(body.get("key")),
        value=_b64d(body.get("value")),
        lease=int(body.get("lease", 0)),
        prev_kv=bool(body.get("prev_kv", False)),
        ignore_value=bool(body.get("ignore_value", False)),
        ignore_lease=bool(body.get("ignore_lease", False)),
    )


def handle(server, path: str, body: Dict[str, Any],
           token: Optional[str] = None) -> Dict[str, Any]:
    """Dispatch one gateway call; returns the JSON-ready response dict.
    Raises KeyError for unknown routes (404 upstream)."""
    s = server
    if path == "/v3/kv/range":
        resp = s.range(_dec_range(body), token=token)
        return {
            "header": _enc_header(resp.header),
            "kvs": [_enc_kv(kv) for kv in resp.kvs],
            "count": str(resp.count),
            **({"more": True} if resp.more else {}),
        }
    if path == "/v3/kv/put":
        resp = s.put(_dec_put(body), token=token)
        out = {"header": _enc_header(resp.header)}
        if resp.prev_kv is not None:
            out["prev_kv"] = _enc_kv(resp.prev_kv)
        return out
    if path == "/v3/kv/deleterange":
        resp = s.delete_range(sapi.DeleteRangeRequest(
            key=_b64d(body.get("key")),
            range_end=_b64d(body.get("range_end")),
            prev_kv=bool(body.get("prev_kv", False)),
        ), token=token)
        return {
            "header": _enc_header(resp.header),
            "deleted": str(resp.deleted),
            "prev_kvs": [_enc_kv(kv) for kv in resp.prev_kvs],
        }
    if path == "/v3/kv/txn":
        resp = s.txn(_dec_txn(body), token=token)
        return _enc_txn_response(resp)
    if path == "/v3/kv/compaction":
        resp = s.compact(sapi.CompactionRequest(
            revision=int(body.get("revision", 0)),
            physical=bool(body.get("physical", False)),
        ), token=token)
        return {"header": _enc_header(resp.header)}
    if path == "/v3/lease/grant":
        resp = s.lease_grant(ttl=int(body.get("TTL", body.get("ttl", 0))),
                             lease_id=int(body.get("ID", body.get("id", 0))),
                             token=token)
        return {
            "header": _enc_header(resp.header),
            "ID": str(resp.id),
            "TTL": str(resp.ttl),
        }
    if path == "/v3/lease/revoke":
        resp = s.lease_revoke(int(body.get("ID", body.get("id", 0))),
                              token=token)
        return {"header": _enc_header(resp.header)}
    if path == "/v3/lease/timetolive":
        out = s.lease_time_to_live(int(body.get("ID", body.get("id", 0))),
                                   keys=bool(body.get("keys", False)))
        if out is None:
            return {"ID": body.get("ID", "0"), "TTL": "-1"}
        return {
            "ID": str(out.get("id", 0)),
            "TTL": str(out.get("ttl", -1)),
            "grantedTTL": str(out.get("granted_ttl", 0)),
            # The lessor tracks attached keys as str; the gateway
            # surface is bytes-in-base64 like every key field.
            "keys": [_b64e(k.encode() if isinstance(k, str) else k)
                     for k in out.get("keys", [])],
        }
    if path == "/v3/lease/leases":
        return {"leases": [{"ID": str(l)} for l in s.lease_leases()]}
    if path == "/v3/maintenance/status":
        return {
            "header": _enc_header(s.response_header()),
            "version": ver.SERVER_VERSION,
            "dbSize": str(s.be.size()),
            "leader": str(s.leader()),
            "raftIndex": str(s.applied_index()),
            "raftTerm": str(s._term),
        }
    if path == "/v3/maintenance/hash":
        h, rev, crev = s.hash_kv(0)
        return {"header": _enc_header(s.response_header()), "hash": h}
    if path == "/v3/cluster/member/list":
        return {
            "header": _enc_header(s.response_header()),
            "members": [
                {
                    "ID": str(m.id),
                    "name": m.name,
                    "peerURLs": list(m.peer_urls),
                    "clientURLs": list(m.client_urls),
                    **({"isLearner": True} if m.is_learner else {}),
                }
                for m in s.cluster.member_list()
            ],
        }
    if path == "/v3/auth/authenticate":
        tok = s.authenticate(body.get("name", ""), body.get("password", ""))
        return {"header": _enc_header(s.response_header()), "token": tok}
    raise KeyError(path)


def _dec_txn(body: Dict[str, Any]) -> sapi.TxnRequest:
    def dec_cmp(c: Dict[str, Any]) -> sapi.Compare:
        target = sapi.CompareTarget(int(c.get("target", 0)))
        kw: Dict[str, Any] = {}
        if "create_revision" in c:
            kw["create_revision"] = int(c["create_revision"])
        if "mod_revision" in c:
            kw["mod_revision"] = int(c["mod_revision"])
        if "version" in c:
            kw["version"] = int(c["version"])
        if "value" in c:
            kw["value"] = _b64d(c["value"])
        return sapi.Compare(
            result=sapi.CompareResult(int(c.get("result", 0))),
            target=target,
            key=_b64d(c.get("key")),
            range_end=_b64d(c.get("range_end")),
            **kw,
        )

    def dec_op(o: Dict[str, Any]) -> sapi.RequestOp:
        if "request_put" in o:
            return sapi.RequestOp(request_put=_dec_put(o["request_put"]))
        if "request_range" in o:
            return sapi.RequestOp(request_range=_dec_range(o["request_range"]))
        if "request_delete_range" in o:
            d = o["request_delete_range"]
            return sapi.RequestOp(request_delete_range=sapi.DeleteRangeRequest(
                key=_b64d(d.get("key")),
                range_end=_b64d(d.get("range_end")),
                prev_kv=bool(d.get("prev_kv", False)),
            ))
        if "request_txn" in o:
            return sapi.RequestOp(request_txn=_dec_txn(o["request_txn"]))
        raise ValueError(f"empty RequestOp: {o}")

    return sapi.TxnRequest(
        compare=[dec_cmp(c) for c in body.get("compare", [])],
        success=[dec_op(o) for o in body.get("success", [])],
        failure=[dec_op(o) for o in body.get("failure", [])],
    )


def _enc_txn_response(resp: sapi.TxnResponse) -> Dict[str, Any]:
    def enc_op(op: sapi.ResponseOp) -> Dict[str, Any]:
        if op.response_put is not None:
            out: Dict[str, Any] = {
                "header": _enc_header(op.response_put.header)}
            if op.response_put.prev_kv is not None:
                out["prev_kv"] = _enc_kv(op.response_put.prev_kv)
            return {"response_put": out}
        if op.response_range is not None:
            rr = op.response_range
            return {"response_range": {
                "header": _enc_header(rr.header),
                "kvs": [_enc_kv(kv) for kv in rr.kvs],
                "count": str(rr.count),
            }}
        if op.response_delete_range is not None:
            dr = op.response_delete_range
            return {"response_delete_range": {
                "header": _enc_header(dr.header),
                "deleted": str(dr.deleted),
            }}
        if op.response_txn is not None:
            return {"response_txn": _enc_txn_response(op.response_txn)}
        return {}

    return {
        "header": _enc_header(resp.header),
        "succeeded": resp.succeeded,
        "responses": [enc_op(op) for op in resp.responses],
    }
