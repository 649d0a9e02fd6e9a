"""KV value model + range options (analog of api/mvccpb/kv.proto and
server/storage/mvcc/kv.go RangeOptions/RangeResult).

Ports ``etcd_tpu/storage/mvcc/kv.py``."""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from enum import IntEnum
from typing import List, Optional


class EventType(IntEnum):
    PUT = 0
    DELETE = 1


@dataclass
class KeyValue:
    key: bytes = b""
    create_revision: int = 0
    mod_revision: int = 0
    version: int = 0
    value: bytes = b""
    lease: int = 0

    _HDR = struct.Struct("<QQQq II")  # create, mod, version, lease, klen, vlen

    def marshal(self) -> bytes:
        return self._HDR.pack(
            self.create_revision, self.mod_revision, self.version,
            self.lease, len(self.key), len(self.value)
        ) + self.key + self.value

    @classmethod
    def unmarshal(cls, data: bytes) -> "KeyValue":
        cr, mr, ver, lease, klen, vlen = cls._HDR.unpack_from(data)
        off = cls._HDR.size
        return cls(
            key=data[off:off + klen],
            create_revision=cr,
            mod_revision=mr,
            version=ver,
            value=data[off + klen:off + klen + vlen],
            lease=lease,
        )


@dataclass
class Event:
    type: EventType = EventType.PUT
    kv: KeyValue = field(default_factory=KeyValue)
    prev_kv: Optional[KeyValue] = None


@dataclass
class RangeOptions:
    limit: int = 0
    rev: int = 0
    count_only: bool = False


@dataclass
class RangeResult:
    kvs: List[KeyValue]
    rev: int
    count: int
