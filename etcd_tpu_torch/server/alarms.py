"""Cluster alarms (ref: server/etcdserver/api/v3alarm/alarms.go).

Raised/cleared via raft so all members agree; persisted in the alarm
bucket; active alarms gate the write path (AlarmApplier).

Ports ``etcd_tpu/server/alarms.py``."""

from __future__ import annotations

import struct
import threading
from typing import Dict, List, Optional, Set

from ..storage import backend as bk
from .api import AlarmMember, AlarmType

ALARM_BUCKET = bk.Bucket("alarm")
_KEY = struct.Struct(">QB")  # member_id, alarm type


class AlarmStore:
    def __init__(self, backend: bk.Backend) -> None:
        self._lock = threading.Lock()
        self.b = backend
        self._types: Dict[AlarmType, Set[int]] = {}
        tx = backend.batch_tx
        with tx.lock:
            tx.unsafe_create_bucket(ALARM_BUCKET)
        for k, _v in backend.read_tx().range(ALARM_BUCKET, b"", b"\xff" * 16, 0):
            mid, t = _KEY.unpack(k)
            self._types.setdefault(AlarmType(t), set()).add(mid)

    def activate(self, member_id: int, alarm: AlarmType) -> Optional[AlarmMember]:
        with self._lock:
            members = self._types.setdefault(alarm, set())
            if member_id in members:
                return None
            members.add(member_id)
            tx = self.b.batch_tx
            with tx.lock:
                tx.put(ALARM_BUCKET, _KEY.pack(member_id, int(alarm)), b"\x01")
            return AlarmMember(member_id=member_id, alarm=alarm)

    def deactivate(self, member_id: int, alarm: AlarmType) -> Optional[AlarmMember]:
        with self._lock:
            members = self._types.get(alarm, set())
            if member_id not in members:
                return None
            members.discard(member_id)
            tx = self.b.batch_tx
            with tx.lock:
                tx.delete(ALARM_BUCKET, _KEY.pack(member_id, int(alarm)))
            return AlarmMember(member_id=member_id, alarm=alarm)

    def get(self, alarm: AlarmType = AlarmType.NONE) -> List[AlarmMember]:
        with self._lock:
            out: List[AlarmMember] = []
            for t, members in sorted(self._types.items()):
                if alarm != AlarmType.NONE and t != alarm:
                    continue
                out.extend(AlarmMember(member_id=m, alarm=t) for m in sorted(members))
            return out

    def active_types(self) -> Set[AlarmType]:
        with self._lock:
            return {t for t, m in self._types.items() if m}
