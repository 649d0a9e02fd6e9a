"""Server-side election service layered on the concurrency recipes
through the in-process loopback client
(ref: server/etcdserver/api/v3election/v3election.go:26-80 —
Campaign/Proclaim/Leader/Resign/Observe over concurrency.Election).

Ports ``etcd_tpu/server/v3election.py``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

from ..client.concurrency import Election, Session
from ..client.util import prefix_end
from . import api as sapi
from .v3client import LocalClient


class ElectionNoLeaderError(Exception):
    """ref: api/v3rpc/rpctypes/error.go ErrGRPCElectionNoLeader."""


class ElectionNotLeaderError(Exception):
    """ref: rpctypes ErrGRPCElectionNotLeader."""


@dataclass
class LeaderKey:
    """ref: api/v3electionpb LeaderKey — proof of leadership: the
    election name, the owner's key, its create revision, and the
    session lease backing it."""

    name: bytes
    key: bytes
    rev: int
    lease: int


class ElectionServer:
    """ref: v3election.go electionServer — each RPC builds a Session
    around the caller's lease (no server-side keepalive: the caller
    owns the lease lifetime, v3election.go:33-40) and drives the
    Election recipe."""

    def __init__(self, server) -> None:
        self.s = server

    def _client(self, token: Optional[str]) -> LocalClient:
        return LocalClient(self.s, token=token)

    def campaign(self, name: bytes, lease: int, value: bytes,
                 timeout: Optional[float] = None,
                 token: Optional[str] = None) -> LeaderKey:
        """Blocks until this lease owns the election (v3election.go:42-58)."""
        c = self._client(token)
        sess = Session.from_lease(c, lease)
        e = Election(sess, name.decode())
        e.campaign(value, timeout=timeout)
        assert e.leader_key is not None
        return LeaderKey(name=name, key=e.leader_key, rev=e.leader_rev,
                         lease=lease)

    def proclaim(self, leader: LeaderKey, value: bytes,
                 token: Optional[str] = None) -> None:
        """Overwrite the leader value iff the caller still holds the
        election (guarded on create-revision, v3election.go:60-66 →
        election.go Proclaim txn)."""
        c = self._client(token)
        resp = c.txn(sapi.TxnRequest(
            compare=[sapi.Compare(
                result=sapi.CompareResult.EQUAL,
                target=sapi.CompareTarget.CREATE,
                key=leader.key,
                create_revision=leader.rev,
            )],
            success=[sapi.RequestOp(request_put=sapi.PutRequest(
                key=leader.key, value=value, ignore_lease=True))],
        ))
        if not resp.succeeded:
            raise ElectionNotLeaderError("not leader")

    def resign(self, leader: LeaderKey, token: Optional[str] = None) -> None:
        """Delete the ownership key iff still held (election.go Resign)."""
        c = self._client(token)
        c.txn(sapi.TxnRequest(
            compare=[sapi.Compare(
                result=sapi.CompareResult.EQUAL,
                target=sapi.CompareTarget.CREATE,
                key=leader.key,
                create_revision=leader.rev,
            )],
            success=[sapi.RequestOp(request_delete_range=sapi.DeleteRangeRequest(
                key=leader.key))],
        ))

    def leader(self, name: bytes, token: Optional[str] = None) -> sapi.KeyValue:
        """Current leader kv = lowest create-revision under the prefix
        (v3election.go:68-74 → election.go Leader)."""
        kv = self._leader_kv(name, token)
        if kv is None:
            raise ElectionNoLeaderError("no leader")
        return kv

    def _leader_kv(self, name: bytes,
                   token: Optional[str]) -> Optional[sapi.KeyValue]:
        kv, _rev = self._leader_kv_at(name, token)
        return kv

    def _leader_kv_at(self, name: bytes, token: Optional[str]):
        """(leader kv or None, revision of the read)."""
        pfx = name.rstrip(b"/") + b"/"
        rr = self._client(token).get(
            pfx, range_end=prefix_end(pfx), limit=1,
            sort_order=sapi.SortOrder.ASCEND,
            sort_target=sapi.SortTarget.CREATE)
        return (rr.kvs[0] if rr.kvs else None), rr.header.revision

    def observe(self, name: bytes, push: Callable[[sapi.KeyValue], bool],
                stopped, token: Optional[str] = None) -> None:
        """Stream leader kvs to ``push`` until it returns False or
        ``stopped`` is set (v3election.go:76-91 → election.go Observe:
        every proclamation of the current leader is an event)."""
        c = self._client(token)
        pfx = name.rstrip(b"/") + b"/"
        last_mod = 0
        while not stopped.is_set():
            kv, read_rev = self._leader_kv_at(name, token)
            if kv is not None and kv.mod_revision > last_mod:
                last_mod = kv.mod_revision
                if not push(kv):
                    return
            # Hold ONE watch across idle polls: tearing it down every
            # interval opens re-establishment gaps under load (events
            # between cancel and re-watch surface only via the next
            # leader-kv poll, delaying pushes unboundedly). Watch from
            # the READ's revision, never "from now" — with no leader, a
            # campaign landing between the read and the watch would
            # otherwise go unseen for as long as the leader stays quiet.
            h = c.watch(pfx, range_end=prefix_end(pfx),
                        start_rev=(kv.mod_revision + 1 if kv
                                   else read_rev + 1))
            try:
                while not stopped.is_set():
                    if h.get(timeout=0.5) is not None:
                        break  # change seen — re-read the leader kv
            finally:
                h.cancel()
