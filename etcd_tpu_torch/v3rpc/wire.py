"""Framing + dataclass (de)serialization for the client RPC surface.

Frames: u32 little-endian length + JSON body. Requests:
``{"id": n, "method": str, "params": {...}, "token": str?}``;
responses: ``{"id": n, "result": ...}`` or
``{"id": n, "error": {"type": str, "msg": str}}``; server-push stream
events carry ``{"stream": watch_id, "event": {...}}`` instead of "id".

Ports ``etcd_tpu/v3rpc/wire.py``.
"""

from __future__ import annotations

import json
import socket
import struct
from typing import Any, Dict, Optional

from ..server import api as sapi
from ..storage.mvcc.kv import Event, EventType, KeyValue

MAX_FRAME = 512 << 20


def write_frame(sock: socket.socket, obj: Dict[str, Any]) -> int:
    body = json.dumps(obj, separators=(",", ":")).encode()
    sock.sendall(struct.pack("<I", len(body)) + body)
    return 4 + len(body)


def read_frame(sock: socket.socket, counter=None) -> Optional[Dict[str, Any]]:
    """`counter`, if given, is called with the frame size in bytes
    (server-side traffic metrics)."""
    hdr = _read_exact(sock, 4)
    if hdr is None:
        return None
    (ln,) = struct.unpack("<I", hdr)
    if ln > MAX_FRAME:
        return None
    body = _read_exact(sock, ln)
    if body is None:
        return None
    if counter is not None:
        counter(4 + ln)
    return json.loads(body.decode())


def _read_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except OSError:
            return None
        if not chunk:
            return None
        buf += chunk
    return buf


# -- dataclass <-> json dict ---------------------------------------------------

enc = sapi._enc  # generic dataclass/bytes/enum encoder


def dec_kv(d: Optional[Dict]) -> Optional[KeyValue]:
    if d is None:
        return None
    return KeyValue(
        key=bytes.fromhex(d.get("key", "")),
        create_revision=d.get("create_revision", 0),
        mod_revision=d.get("mod_revision", 0),
        version=d.get("version", 0),
        value=bytes.fromhex(d.get("value", "")),
        lease=d.get("lease", 0),
    )


def dec_header(d: Optional[Dict]) -> sapi.ResponseHeader:
    d = d or {}
    return sapi.ResponseHeader(
        cluster_id=d.get("cluster_id", 0),
        member_id=d.get("member_id", 0),
        revision=d.get("revision", 0),
        raft_term=d.get("raft_term", 0),
    )


def dec_event(d: Dict) -> Event:
    return Event(
        type=EventType(d.get("type", 0)),
        kv=dec_kv(d.get("kv")) or KeyValue(),
        prev_kv=dec_kv(d.get("prev_kv")),
    )


def enc_event(ev: Event) -> Dict:
    out: Dict[str, Any] = {"type": int(ev.type), "kv": enc(ev.kv)}
    if ev.prev_kv is not None:
        out["prev_kv"] = enc(ev.prev_kv)
    return out


def dec_response(method: str, d: Dict):
    """Rehydrate a response dataclass for the client."""
    if method in ("Range",):
        return sapi.RangeResponse(
            header=dec_header(d.get("header")),
            kvs=[dec_kv(x) for x in d.get("kvs", [])],
            more=d.get("more", False),
            count=d.get("count", 0),
        )
    if method == "Put":
        return sapi.PutResponse(
            header=dec_header(d.get("header")), prev_kv=dec_kv(d.get("prev_kv"))
        )
    if method == "DeleteRange":
        return sapi.DeleteRangeResponse(
            header=dec_header(d.get("header")),
            deleted=d.get("deleted", 0),
            prev_kvs=[dec_kv(x) for x in d.get("prev_kvs", [])],
        )
    if method == "Txn":
        return dec_txn_response(d)
    if method == "Compact":
        return sapi.CompactionResponse(header=dec_header(d.get("header")))
    if method == "LeaseGrant":
        return sapi.LeaseGrantResponse(
            header=dec_header(d.get("header")),
            id=d.get("id", 0),
            ttl=d.get("ttl", 0),
            error=d.get("error", ""),
        )
    if method == "LeaseRevoke":
        return sapi.LeaseRevokeResponse(header=dec_header(d.get("header")))
    if method == "Alarm":
        return sapi.AlarmResponse(
            header=dec_header(d.get("header")),
            alarms=[
                sapi.AlarmMember(
                    member_id=a.get("member_id", 0),
                    alarm=sapi.AlarmType(a.get("alarm", 0)),
                )
                for a in d.get("alarms", [])
            ],
        )
    return d  # generic dict result


def dec_txn_response(d: Dict) -> sapi.TxnResponse:
    resps = []
    for r in d.get("responses", []):
        op = sapi.ResponseOp()
        if "response_range" in r:
            op.response_range = dec_response("Range", r["response_range"])
        if "response_put" in r:
            op.response_put = dec_response("Put", r["response_put"])
        if "response_delete_range" in r:
            op.response_delete_range = dec_response(
                "DeleteRange", r["response_delete_range"]
            )
        if "response_txn" in r:
            op.response_txn = dec_txn_response(r["response_txn"])
        resps.append(op)
    return sapi.TxnResponse(
        header=dec_header(d.get("header")),
        succeeded=d.get("succeeded", False),
        responses=resps,
    )


def dec_request(method: str, params: Dict):
    """Rehydrate a request dataclass server-side."""
    b = sapi._build
    if method == "Range":
        return b(sapi.RangeRequest, params)
    if method == "Put":
        return b(sapi.PutRequest, params)
    if method == "DeleteRange":
        return b(sapi.DeleteRangeRequest, params)
    if method == "Txn":
        return b(sapi.TxnRequest, params)
    if method == "Compact":
        return b(sapi.CompactionRequest, params)
    if method == "Alarm":
        return b(sapi.AlarmRequest, params)
    if method == "Auth":
        return b(sapi.AuthRequest, params)
    return params
