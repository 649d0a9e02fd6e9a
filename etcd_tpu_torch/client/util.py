"""Compare + range helpers (ref: client/v3/clientv3util/util.go,
clientv3.GetPrefixRangeEnd).

Ports ``etcd_tpu/client/util.py``."""

from __future__ import annotations

from ..server import api as sapi


def prefix_end(prefix: bytes) -> bytes:
    """Exclusive upper bound of all keys with `prefix`
    (ref: clientv3/op.go getPrefix). Empty prefix → b"\\x00", the
    open-end sentinel covering the whole keyspace."""
    b = bytearray(prefix)
    for i in reversed(range(len(b))):
        if b[i] < 0xFF:
            b[i] += 1
            return bytes(b[: i + 1])
    return b"\x00"


def key_exists(key: bytes) -> sapi.Compare:
    """Txn guard: key has been created (CreateRevision > 0)."""
    return sapi.Compare(
        target=sapi.CompareTarget.CREATE,
        result=sapi.CompareResult.GREATER,
        key=key,
        create_revision=0,
    )


def key_missing(key: bytes) -> sapi.Compare:
    """Txn guard: key does not exist (CreateRevision == 0)."""
    return sapi.Compare(
        target=sapi.CompareTarget.CREATE,
        result=sapi.CompareResult.EQUAL,
        key=key,
        create_revision=0,
    )
