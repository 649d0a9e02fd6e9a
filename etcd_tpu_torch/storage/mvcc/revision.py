"""Revision: the (main, sub) logical clock of the mvcc store.

``main`` increments once per transaction; ``sub`` orders changes within
one transaction. On-disk keys in the "key" bucket are the 17-byte
big-endian encoding [8B main]['_'][8B sub], optionally followed by 't'
to mark a tombstone — byte order equals revision order, so backend
range scans iterate history in revision order
(ref: server/storage/mvcc/revision.go).

Ports ``etcd_tpu/storage/mvcc/revision.py``.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass


@dataclass(frozen=True, order=True)
class Revision:
    main: int = 0
    sub: int = 0


REV_BYTES_LEN = 17
_MARK_TOMBSTONE = b"t"


def rev_to_bytes(rev: Revision) -> bytes:
    return struct.pack(">Q", rev.main) + b"_" + struct.pack(">Q", rev.sub)


def bytes_to_rev(b: bytes) -> Revision:
    main = struct.unpack_from(">Q", b, 0)[0]
    sub = struct.unpack_from(">Q", b, 9)[0]
    return Revision(main, sub)


def tombstone_key(b: bytes) -> bytes:
    return b + _MARK_TOMBSTONE


def is_tombstone_key(b: bytes) -> bool:
    return len(b) == REV_BYTES_LEN + 1 and b.endswith(_MARK_TOMBSTONE)
