"""Distributed coordination recipes (ref: client/v3/concurrency/).

* ``Session`` — a lease kept alive for the client's lifetime
  (session.go);
* ``Mutex`` — lock ownership by lowest create-revision under a prefix,
  waiting on the predecessor's delete (mutex.go);
* ``Election`` — campaign/proclaim/resign/leader on the same ordering
  (election.go);
* ``STM`` — software transactional memory: read-set/write-set with
  mod-revision conflict detection and retry (stm.go, serializable
  level).

Ports ``etcd_tpu/client/concurrency.py``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..server import api as sapi
from .client import Client, ClientError
from .util import prefix_end as _prefix_end


class Session:
    """ref: concurrency/session.go — lease + keepalive."""

    def __init__(self, client: Client, ttl: int = 10,
                 lease_id: int = 0) -> None:
        """With ``lease_id`` the session adopts an existing lease
        (concurrency.WithLease, session.go:32-38) instead of granting
        one; the caller owns its lifetime."""
        self.client = client
        if lease_id:
            self.lease_id = lease_id
        else:
            resp = client.lease_grant(ttl=ttl)
            self.lease_id = resp.id
        self._stop_keepalive = client.lease_keep_alive(self.lease_id)
        self._closed = False

    @classmethod
    def from_lease(cls, client: Client, lease_id: int) -> "Session":
        """An orphaned session around a caller-owned lease: no
        keepalive, no revoke-on-close (the pattern of the server-side
        lock/election services, ref v3lock.go:30-37 NewSession+Orphan)."""
        s = cls.__new__(cls)
        s.client = client
        s.lease_id = lease_id
        s._stop_keepalive = lambda: None
        s._closed = False
        return s

    def close(self) -> None:
        """Revoke the lease: all owned locks/leadership vanish at once."""
        if self._closed:
            return
        self._closed = True
        self._stop_keepalive()
        try:
            self.client.lease_revoke(self.lease_id)
        except ClientError:
            pass

    def orphan(self) -> None:
        """Stop keepalive but keep the lease (session.go Orphan)."""
        self._closed = True
        self._stop_keepalive()


def _put_if_absent_txn(key: bytes, value: bytes, lease: int) -> sapi.TxnRequest:
    return sapi.TxnRequest(
        compare=[
            sapi.Compare(
                result=sapi.CompareResult.EQUAL,
                target=sapi.CompareTarget.CREATE,
                key=key,
                create_revision=0,
            )
        ],
        success=[
            sapi.RequestOp(
                request_put=sapi.PutRequest(key=key, value=value, lease=lease)
            )
        ],
        failure=[sapi.RequestOp(request_range=sapi.RangeRequest(key=key))],
    )


class Mutex:
    """ref: concurrency/mutex.go."""

    def __init__(self, session: Session, prefix: str) -> None:
        self.session = session
        self.prefix = prefix.rstrip("/") + "/"
        self.my_key = (self.prefix + f"{session.lease_id:x}").encode()
        self.my_rev = 0
        self._owned = False

    def lock(self, timeout: Optional[float] = None) -> None:
        c = self.session.client
        resp = c.txn(_put_if_absent_txn(self.my_key, b"", self.session.lease_id))
        if resp.succeeded:
            self.my_rev = resp.header.revision
        else:
            self.my_rev = resp.responses[0].response_range.kvs[0].create_revision
        deadline = time.monotonic() + timeout if timeout else None
        while True:
            # Owner = lowest create-revision under the prefix.
            rr = c.get(
                self.prefix.encode(),
                range_end=_prefix_end(self.prefix.encode()),
                sort_order=sapi.SortOrder.ASCEND,
                sort_target=sapi.SortTarget.CREATE,
                limit=1,
            )
            if rr.kvs and rr.kvs[0].key == self.my_key:
                self._owned = True
                return
            if deadline is not None and time.monotonic() > deadline:
                self.unlock()
                raise TimeoutError("mutex lock timeout")
            # Wait for the current owner's key to change (waitDeletes).
            h = c.watch(
                self.prefix.encode(),
                range_end=_prefix_end(self.prefix.encode()),
                start_rev=rr.header.revision + 1,
            )
            try:
                h.get(timeout=0.5)
            finally:
                h.cancel()

    def unlock(self) -> None:
        self._owned = False
        try:
            self.session.client.delete(self.my_key)
        except ClientError:
            pass

    def is_owner(self) -> bool:
        return self._owned

    def __enter__(self) -> "Mutex":
        self.lock()
        return self

    def __exit__(self, *exc) -> None:
        self.unlock()


class Election:
    """ref: concurrency/election.go."""

    def __init__(self, session: Session, prefix: str) -> None:
        self.session = session
        self.prefix = prefix.rstrip("/") + "/"
        self.leader_key: Optional[bytes] = None
        self.leader_rev = 0

    def campaign(self, value: bytes, timeout: Optional[float] = None) -> None:
        c = self.session.client
        key = (self.prefix + f"{self.session.lease_id:x}").encode()
        resp = c.txn(_put_if_absent_txn(key, value, self.session.lease_id))
        if resp.succeeded:
            self.leader_rev = resp.header.revision
        else:
            kv = resp.responses[0].response_range.kvs[0]
            self.leader_rev = kv.create_revision
            if kv.value != value:
                c.put(key, value, lease=self.session.lease_id)
        self.leader_key = key
        deadline = time.monotonic() + timeout if timeout else None
        while True:
            rr = c.get(
                self.prefix.encode(),
                range_end=_prefix_end(self.prefix.encode()),
                sort_order=sapi.SortOrder.ASCEND,
                sort_target=sapi.SortTarget.CREATE,
                limit=1,
            )
            if rr.kvs and rr.kvs[0].key == key:
                return  # elected
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("campaign timeout")
            h = c.watch(
                self.prefix.encode(),
                range_end=_prefix_end(self.prefix.encode()),
                start_rev=rr.header.revision + 1,
            )
            try:
                h.get(timeout=0.5)
            finally:
                h.cancel()

    def proclaim(self, value: bytes) -> None:
        if self.leader_key is None:
            raise RuntimeError("not campaigning")
        self.session.client.put(
            self.leader_key, value, lease=self.session.lease_id
        )

    def resign(self) -> None:
        if self.leader_key is not None:
            try:
                self.session.client.delete(self.leader_key)
            except ClientError:
                pass
            self.leader_key = None

    def leader(self) -> Optional[sapi.RangeResponse]:
        rr = self.session.client.get(
            self.prefix.encode(),
            range_end=_prefix_end(self.prefix.encode()),
            sort_order=sapi.SortOrder.ASCEND,
            sort_target=sapi.SortTarget.CREATE,
            limit=1,
        )
        return rr if rr.kvs else None


class STMConflict(Exception):
    pass


class STM:
    """Serializable software transactional memory
    (ref: concurrency/stm.go stmSerializable)."""

    def __init__(self, client: Client, max_retries: int = 64) -> None:
        self.client = client
        self.max_retries = max_retries

    def run(self, apply_fn: Callable[["STMTxn"], None]) -> sapi.TxnResponse:
        for _ in range(self.max_retries):
            txn = STMTxn(self.client)
            apply_fn(txn)
            resp = txn._commit()
            if resp is not None:
                return resp
        raise STMConflict("too many stm retries")


class STMTxn:
    def __init__(self, client: Client) -> None:
        self.c = client
        self.rset: Dict[bytes, Tuple[int, bytes]] = {}  # key -> (mod_rev, value)
        self.wset: Dict[bytes, bytes] = {}
        self._first_read_rev = 0

    def get(self, key: bytes) -> bytes:
        if key in self.wset:
            return self.wset[key]
        if key in self.rset:
            return self.rset[key][1]
        rr = self.c.get(key, revision=self._first_read_rev, serializable=True)
        if self._first_read_rev == 0:
            # Pin all later reads to the first read's revision
            # (stm.go firstRead rev pinning).
            self._first_read_rev = rr.header.revision
        if rr.kvs:
            self.rset[key] = (rr.kvs[0].mod_revision, rr.kvs[0].value)
            return rr.kvs[0].value
        self.rset[key] = (0, b"")
        return b""

    def put(self, key: bytes, value: bytes) -> None:
        self.wset[key] = value

    def _commit(self) -> Optional[sapi.TxnResponse]:
        cmps = [
            sapi.Compare(
                result=sapi.CompareResult.EQUAL,
                target=sapi.CompareTarget.MOD,
                key=k,
                mod_revision=rev,
            )
            for k, (rev, _v) in self.rset.items()
        ]
        puts = [
            sapi.RequestOp(request_put=sapi.PutRequest(key=k, value=v))
            for k, v in self.wset.items()
        ]
        resp = self.c.txn(sapi.TxnRequest(compare=cmps, success=puts, failure=[]))
        return resp if resp.succeeded else None


