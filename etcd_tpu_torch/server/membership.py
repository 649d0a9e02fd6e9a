"""Cluster membership (ref: server/etcdserver/api/membership/cluster.go).

RaftCluster: the authoritative member set, updated only by applied conf
changes and persisted in the backend members bucket so restarts recover
it without the WAL (cluster.go:44 RaftCluster, storev2.go/store.go dual
persistence — here backend-only, v2store being a deprecation path).

Ports ``etcd_tpu/server/membership.py``.
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..storage import backend as bk

MEMBERS_BUCKET = bk.Bucket("members")
REMOVED_BUCKET = bk.Bucket("membersRemoved")
CLUSTER_BUCKET = bk.Bucket("cluster")


@dataclass
class Member:
    id: int = 0
    name: str = ""
    peer_urls: List[str] = field(default_factory=list)
    client_urls: List[str] = field(default_factory=list)
    is_learner: bool = False

    def marshal(self) -> bytes:
        return json.dumps(
            {
                "id": self.id,
                "name": self.name,
                "peer_urls": self.peer_urls,
                "client_urls": self.client_urls,
                "is_learner": self.is_learner,
            }
        ).encode()

    @staticmethod
    def unmarshal(b: bytes) -> "Member":
        d = json.loads(b.decode())
        return Member(
            id=d["id"],
            name=d["name"],
            peer_urls=list(d["peer_urls"]),
            client_urls=list(d["client_urls"]),
            is_learner=d.get("is_learner", False),
        )


class MemberNotFoundError(Exception):
    pass


class MemberExistsError(Exception):
    pass


class MemberRemovedError(Exception):
    """ref: membership.ErrIDRemoved."""


class RaftCluster:
    def __init__(self, cluster_id: int, backend: Optional[bk.Backend] = None) -> None:
        self._lock = threading.RLock()
        self.cid = cluster_id
        self.b = backend
        self.members: Dict[int, Member] = {}
        self.removed: Dict[int, bool] = {}
        if backend is not None:
            tx = backend.batch_tx
            with tx.lock:
                tx.unsafe_create_bucket(MEMBERS_BUCKET)
                tx.unsafe_create_bucket(REMOVED_BUCKET)
                tx.unsafe_create_bucket(CLUSTER_BUCKET)
            self._recover()

    def _recover(self) -> None:
        rt = self.b.read_tx()
        for k, v in rt.range(MEMBERS_BUCKET, b"", b"\xff" * 16, 0):
            m = Member.unmarshal(v)
            self.members[m.id] = m
        for k, _v in rt.range(REMOVED_BUCKET, b"", b"\xff" * 16, 0):
            self.removed[int.from_bytes(k, "big")] = True

    def _persist_member(self, m: Member) -> None:
        if self.b is None:
            return
        tx = self.b.batch_tx
        with tx.lock:
            tx.put(MEMBERS_BUCKET, m.id.to_bytes(8, "big"), m.marshal())

    # -- mutations (conf-change apply path, cluster.go:391-444) ---------------

    def add_member(self, m: Member) -> None:
        with self._lock:
            if m.id in self.removed:
                raise MemberRemovedError(str(m.id))
            if m.id in self.members:
                raise MemberExistsError(str(m.id))
            self.members[m.id] = m
            self._persist_member(m)

    def remove_member(self, mid: int) -> None:
        with self._lock:
            self.members.pop(mid, None)
            self.removed[mid] = True
            if self.b is not None:
                tx = self.b.batch_tx
                with tx.lock:
                    tx.delete(MEMBERS_BUCKET, mid.to_bytes(8, "big"))
                    tx.put(REMOVED_BUCKET, mid.to_bytes(8, "big"), b"\x01")

    def promote_member(self, mid: int) -> None:
        with self._lock:
            m = self.members.get(mid)
            if m is None:
                raise MemberNotFoundError(str(mid))
            m.is_learner = False
            self._persist_member(m)

    def update_member_attr(self, mid: int, name: str, client_urls: List[str]) -> None:
        with self._lock:
            m = self.members.get(mid)
            if m is None:
                return
            m.name = name
            m.client_urls = list(client_urls)
            self._persist_member(m)

    # -- queries ---------------------------------------------------------------

    def member(self, mid: int) -> Optional[Member]:
        with self._lock:
            return self.members.get(mid)

    def member_ids(self) -> List[int]:
        with self._lock:
            return sorted(self.members)

    def voting_member_ids(self) -> List[int]:
        with self._lock:
            return sorted(i for i, m in self.members.items() if not m.is_learner)

    def is_removed(self, mid: int) -> bool:
        with self._lock:
            return mid in self.removed

    def member_list(self) -> List[Member]:
        with self._lock:
            return [self.members[i] for i in sorted(self.members)]
