"""The applier chain: decorated interpreter for committed
InternalRaftRequests (ref: server/etcdserver/apply.go).

``ApplierBackend`` executes each op against mvcc/lease/auth/alarm;
wrapped by ``AuthApplier`` (apply-time permission re-check,
apply_auth.go), ``QuotaApplier`` (backend-size gate → NOSPACE,
apply.go:974) and ``AlarmApplier`` (corrupt/nospace write fence,
corrupt.go:306 + applierV3Capped semantics).

Ports ``etcd_tpu/server/apply.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

from ..auth.store import AuthInfo, PermissionType, Permission
from ..lease.lessor import LeaseItem, LeaseNotFoundError, NoLease
from ..storage.mvcc.kv import KeyValue, RangeOptions
from ..storage.mvcc import metrics as mmet
from .api import (
    AlarmAction,
    AlarmMember,
    AlarmRequest,
    AlarmResponse,
    AuthRequest,
    Compare,
    CompareResult,
    CompareTarget,
    CompactionRequest,
    CompactionResponse,
    DeleteRangeRequest,
    DeleteRangeResponse,
    InternalRaftRequest,
    LeaseCheckpointRequest,
    LeaseGrantRequest,
    LeaseGrantResponse,
    LeaseRevokeRequest,
    LeaseRevokeResponse,
    PutRequest,
    PutResponse,
    RangeRequest,
    RangeResponse,
    RequestOp,
    ResponseHeader,
    ResponseOp,
    SortOrder,
    SortTarget,
    TxnRequest,
    TxnResponse,
)


class NoSpaceError(Exception):
    """ref: rpctypes.ErrNoSpace."""


class CorruptError(Exception):
    """ref: rpctypes.ErrCorrupt."""


class LeaseNotFound(Exception):
    """ref: rpctypes.ErrLeaseNotFound (apply-level)."""


@dataclass
class ApplyResult:
    """ref: apply.go:56-60 applyResult."""

    resp: Any = None
    err: Optional[Exception] = None
    physc: Any = None  # compaction completion signal


class ApplierBackend:
    """ref: apply.go:104-133 applierV3backend."""

    def __init__(self, server) -> None:
        self.s = server

    # -- dispatch (apply.go:135-249 Apply) -------------------------------------

    def apply(self, r: InternalRaftRequest) -> ApplyResult:
        op = r.op
        try:
            if op == "put":
                return ApplyResult(resp=self.put(r.req))
            if op == "range":
                return ApplyResult(resp=self.range(r.req))
            if op == "delete_range":
                return ApplyResult(resp=self.delete_range(r.req))
            if op == "txn":
                return ApplyResult(resp=self.txn(r.req))
            if op == "compaction":
                return ApplyResult(resp=self.compaction(r.req))
            if op == "lease_grant":
                return ApplyResult(resp=self.lease_grant(r.req))
            if op == "lease_revoke":
                return ApplyResult(resp=self.lease_revoke(r.req))
            if op == "lease_checkpoint":
                return ApplyResult(resp=self.lease_checkpoint(r.req))
            if op == "alarm":
                return ApplyResult(resp=self.alarm(r.req))
            if op == "auth":
                return ApplyResult(resp=self.auth_dispatch(r))
            if op == "cluster_member_attr":
                self.s.cluster.update_member_attr(
                    r.req["id"], r.req["name"], r.req["client_urls"]
                )
                return ApplyResult(resp=None)
            return ApplyResult(err=ValueError(f"unknown apply op {op!r}"))
        except Exception as e:  # noqa: BLE001 — applied errors go to the waiter
            return ApplyResult(err=e)

    def _header(self) -> ResponseHeader:
        return self.s.response_header()

    # -- kv ops ----------------------------------------------------------------

    def put(self, p: PutRequest, txn=None) -> PutResponse:
        """ref: apply.go:251-332 Put."""
        mmet.put_total.inc()
        resp = PutResponse(header=self._header())
        owned = txn is None
        if owned:
            txn = self.s.kv.write()
            txn.__enter__()
        try:
            prev: Optional[KeyValue] = None
            if p.prev_kv or p.ignore_value or p.ignore_lease:
                rr = txn.range(p.key, None)
                prev = rr.kvs[0] if rr.kvs else None
            val, lease = p.value, p.lease
            if p.ignore_value or p.ignore_lease:
                if prev is None:
                    raise KeyError("etcdserver: key not found")
                if p.ignore_value:
                    val = prev.value
                if p.ignore_lease:
                    lease = prev.lease
            if lease != NoLease and self.s.lessor is not None:
                if self.s.lessor.lookup(lease) is None:
                    raise LeaseNotFound(str(lease))
            txn.put(p.key, val, lease)
            if p.prev_kv and prev is not None:
                resp.prev_kv = prev
        finally:
            if owned:
                txn.__exit__(None, None, None)
        resp.header.revision = self.s.kv.rev()
        return resp

    def delete_range(
        self, dr: DeleteRangeRequest, txn=None
    ) -> DeleteRangeResponse:
        """ref: apply.go DeleteRange."""
        mmet.delete_total.inc()
        resp = DeleteRangeResponse(header=self._header())
        owned = txn is None
        if owned:
            txn = self.s.kv.write()
            txn.__enter__()
        try:
            end = _resolve_end(dr.range_end)
            if dr.prev_kv:
                rr = txn.range(dr.key, end, RangeOptions(limit=0))
                resp.prev_kvs = rr.kvs
            resp.deleted = txn.delete_range(dr.key, end)
        finally:
            if owned:
                txn.__exit__(None, None, None)
        resp.header.revision = self.s.kv.rev()
        return resp

    def range(self, rreq: RangeRequest, txn=None) -> RangeResponse:
        """ref: apply.go:334-439 Range."""
        mmet.range_total.inc()
        resp = RangeResponse(header=self._header())
        end = _resolve_end(rreq.range_end)

        limit = rreq.limit
        if (
            rreq.sort_order != SortOrder.NONE
            or rreq.min_mod_revision != 0
            or rreq.max_mod_revision != 0
            or rreq.min_create_revision != 0
            or rreq.max_create_revision != 0
        ):
            limit = 0  # fetch everything, filter/sort below (apply.go:354-360)
        opts = RangeOptions(
            limit=limit + 1 if limit > 0 else 0,
            rev=rreq.revision,
            count_only=rreq.count_only,
        )
        src = txn if txn is not None else self.s.kv
        rr = src.range(rreq.key, end, opts)
        kvs = rr.kvs

        def keep(kv: KeyValue) -> bool:
            if rreq.min_mod_revision and kv.mod_revision < rreq.min_mod_revision:
                return False
            if rreq.max_mod_revision and kv.mod_revision > rreq.max_mod_revision:
                return False
            if rreq.min_create_revision and kv.create_revision < rreq.min_create_revision:
                return False
            if rreq.max_create_revision and kv.create_revision > rreq.max_create_revision:
                return False
            return True

        filtered = rreq.min_mod_revision or rreq.max_mod_revision or \
            rreq.min_create_revision or rreq.max_create_revision
        if filtered:
            kvs = [kv for kv in kvs if keep(kv)]

        if rreq.sort_order != SortOrder.NONE:
            keyfn = {
                SortTarget.KEY: lambda kv: kv.key,
                SortTarget.VERSION: lambda kv: kv.version,
                SortTarget.CREATE: lambda kv: kv.create_revision,
                SortTarget.MOD: lambda kv: kv.mod_revision,
                SortTarget.VALUE: lambda kv: kv.value,
            }[rreq.sort_target]
            kvs = sorted(
                kvs, key=keyfn, reverse=rreq.sort_order == SortOrder.DESCEND
            )

        if rreq.limit > 0 and len(kvs) > rreq.limit:
            kvs = kvs[: rreq.limit]
            resp.more = True

        if rreq.keys_only:
            kvs = [
                KeyValue(
                    key=kv.key,
                    create_revision=kv.create_revision,
                    mod_revision=kv.mod_revision,
                    version=kv.version,
                    lease=kv.lease,
                )
                for kv in kvs
            ]
        resp.kvs = kvs
        resp.count = rr.count if not filtered else len(kvs)
        resp.header.revision = rr.rev
        return resp

    # -- txn (apply.go:441-680) ------------------------------------------------

    def txn(self, tr: TxnRequest) -> TxnResponse:
        mmet.txn_total.inc()
        is_write = _is_txn_write(tr)
        if is_write:
            txn = self.s.kv.write()
            txn.__enter__()
        else:
            txn = None
        try:
            succeeded = all(self._apply_compare(c, txn) for c in tr.compare)
            reqs = tr.success if succeeded else tr.failure
            resps = [self._apply_txn_op(op, txn) for op in reqs]
        finally:
            if txn is not None:
                txn.__exit__(None, None, None)
        resp = TxnResponse(
            header=self._header(), succeeded=succeeded, responses=resps
        )
        resp.header.revision = self.s.kv.rev()
        return resp

    def _apply_compare(self, c: Compare, txn) -> bool:
        """ref: apply.go applyCompare."""
        end = _resolve_end(c.range_end)
        src = txn if txn is not None else self.s.kv
        rr = src.range(c.key, end, RangeOptions())
        if not rr.kvs:
            if c.target == CompareTarget.VALUE:
                # Missing key never satisfies a VALUE compare.
                return False
            return _compare_kv(c, KeyValue())
        return all(_compare_kv(c, kv) for kv in rr.kvs)

    def _apply_txn_op(self, op: RequestOp, txn) -> ResponseOp:
        if op.request_range is not None:
            return ResponseOp(response_range=self.range(op.request_range, txn))
        if op.request_put is not None:
            return ResponseOp(response_put=self.put(op.request_put, txn))
        if op.request_delete_range is not None:
            return ResponseOp(
                response_delete_range=self.delete_range(op.request_delete_range, txn)
            )
        if op.request_txn is not None:
            # Nested txn shares the outer write txn (apply.go applyTxn).
            sub = op.request_txn
            succeeded = all(self._apply_compare(c, txn) for c in sub.compare)
            reqs = sub.success if succeeded else sub.failure
            resps = [self._apply_txn_op(o, txn) for o in reqs]
            return ResponseOp(
                response_txn=TxnResponse(
                    header=self._header(), succeeded=succeeded, responses=resps
                )
            )
        return ResponseOp()

    # -- maintenance ops -------------------------------------------------------

    def compaction(self, creq: CompactionRequest) -> CompactionResponse:
        resp = CompactionResponse(header=self._header())
        self.s.kv.compact(creq.revision)
        resp.header.revision = self.s.kv.rev()
        return resp

    def lease_grant(self, lg: LeaseGrantRequest) -> LeaseGrantResponse:
        lease = self.s.lessor.grant(lg.id, lg.ttl)
        return LeaseGrantResponse(
            header=self._header(), id=lease.id, ttl=lease.ttl
        )

    def lease_revoke(self, lr: LeaseRevokeRequest) -> LeaseRevokeResponse:
        try:
            self.s.lessor.revoke(lr.id)
        except LeaseNotFoundError:
            raise LeaseNotFound(str(lr.id))
        return LeaseRevokeResponse(header=self._header())

    def lease_checkpoint(self, lc: LeaseCheckpointRequest):
        for cp in lc.checkpoints:
            try:
                self.s.lessor.checkpoint(cp.id, cp.remaining_ttl)
            except LeaseNotFoundError:
                pass
        return None

    def alarm(self, ar: AlarmRequest) -> AlarmResponse:
        """ref: apply.go Alarm → v3alarm store."""
        resp = AlarmResponse(header=self._header())
        if ar.action == AlarmAction.GET:
            resp.alarms = self.s.alarms.get(ar.alarm)
        elif ar.action == AlarmAction.ACTIVATE:
            m = self.s.alarms.activate(ar.member_id, ar.alarm)
            if m is not None:
                resp.alarms = [m]
        elif ar.action == AlarmAction.DEACTIVATE:
            m = self.s.alarms.deactivate(ar.member_id, ar.alarm)
            if m is not None:
                resp.alarms = [m]
        return resp

    # -- auth (apply_auth dispatch over AuthStore) -----------------------------

    def auth_dispatch(self, r: InternalRaftRequest):
        a: AuthRequest = r.req
        st = self.s.auth_store
        op = a.op
        if op == "enable":
            st.auth_enable()
        elif op == "disable":
            st.auth_disable()
        elif op == "user_add":
            st.user_add(a.name, a.password, no_password=a.no_password)
        elif op == "user_delete":
            st.user_delete(a.name)
        elif op == "user_change_password":
            st.user_change_password(a.name, a.password)
        elif op == "user_grant_role":
            st.user_grant_role(a.name, a.role)
        elif op == "user_revoke_role":
            st.user_revoke_role(a.name, a.role)
        elif op == "role_add":
            st.role_add(a.role)
        elif op == "role_delete":
            st.role_delete(a.role)
        elif op == "role_grant_permission":
            st.role_grant_permission(
                a.role,
                Permission(PermissionType(a.perm_type), a.key, a.range_end),
            )
        elif op == "role_revoke_permission":
            st.role_revoke_permission(a.role, a.key, a.range_end)
        else:
            raise ValueError(f"unknown auth op {op!r}")
        return {"revision": st.revision()}


def _resolve_end(range_end: bytes) -> Optional[bytes]:
    """etcd range_end semantics (ref: rpc.proto RangeRequest doc):
    b"" → the single key; b"\\x00" → open end (every key ≥ key, the
    'range over all keys ≥ key' sentinel); else literal exclusive end.
    Internally None = single key, b"" = open end."""
    if not range_end:
        return None
    if range_end == b"\x00":
        return b""
    return range_end


def _is_txn_write(tr: TxnRequest) -> bool:
    for ops in (tr.success, tr.failure):
        for op in ops:
            if op.request_put is not None or op.request_delete_range is not None:
                return True
            if op.request_txn is not None and _is_txn_write(op.request_txn):
                return True
    return False


def _compare_kv(c: Compare, kv: KeyValue) -> bool:
    """ref: apply.go compareKV."""
    if c.target == CompareTarget.VALUE:
        result = _cmp(kv.value, c.value)
    elif c.target == CompareTarget.VERSION:
        result = _cmp(kv.version, c.version)
    elif c.target == CompareTarget.CREATE:
        result = _cmp(kv.create_revision, c.create_revision)
    elif c.target == CompareTarget.MOD:
        result = _cmp(kv.mod_revision, c.mod_revision)
    elif c.target == CompareTarget.LEASE:
        result = _cmp(kv.lease, c.lease)
    else:
        return False
    if c.result == CompareResult.EQUAL:
        return result == 0
    if c.result == CompareResult.NOT_EQUAL:
        return result != 0
    if c.result == CompareResult.GREATER:
        return result > 0
    if c.result == CompareResult.LESS:
        return result < 0
    return False


def _cmp(a, b) -> int:
    return (a > b) - (a < b)


# -- decorators ----------------------------------------------------------------


class AuthApplier:
    """Apply-time permission re-check (ref: apply_auth.go). The raft
    proposal carries the author's username+auth_revision; if auth state
    moved on since, the request fails with AuthOldRevision and the
    client retries with a fresh token."""

    def __init__(self, base: ApplierBackend, auth_store) -> None:
        self.base = base
        self.st = auth_store

    def apply(self, r: InternalRaftRequest) -> ApplyResult:
        info = AuthInfo(username=r.username, revision=r.auth_revision)
        try:
            if r.op == "put":
                self.st.is_put_permitted(info if r.username else None, r.req.key)
            elif r.op == "delete_range":
                self.st.is_delete_range_permitted(
                    info if r.username else None, r.req.key, r.req.range_end
                )
            elif r.op == "range":
                self.st.is_range_permitted(
                    info if r.username else None, r.req.key, r.req.range_end
                )
            elif r.op == "txn":
                self._check_txn(info if r.username else None, r.req)
            elif r.op == "auth" and r.req.op not in ("enable",):
                # Admin ops require root once auth is on (apply_auth.go).
                if self.st.is_auth_enabled():
                    self.st.is_admin_permitted(info if r.username else None)
        except Exception as e:  # noqa: BLE001
            return ApplyResult(err=e)
        return self.base.apply(r)

    def _check_txn(self, info, tr: TxnRequest) -> None:
        """ref: apply_auth.go checkTxnAuth."""
        for c in tr.compare:
            self.st.is_range_permitted(info, c.key, c.range_end)
        for ops in (tr.success, tr.failure):
            for op in ops:
                if op.request_range is not None:
                    self.st.is_range_permitted(
                        info, op.request_range.key, op.request_range.range_end
                    )
                elif op.request_put is not None:
                    self.st.is_put_permitted(info, op.request_put.key)
                elif op.request_delete_range is not None:
                    self.st.is_delete_range_permitted(
                        info,
                        op.request_delete_range.key,
                        op.request_delete_range.range_end,
                    )
                elif op.request_txn is not None:
                    self._check_txn(info, op.request_txn)


class QuotaApplier:
    """Backend-size write fence (ref: apply.go:974 quotaApplier +
    storage/quota.go). Oversize writes fail with NoSpace and the server
    raises the NOSPACE alarm through raft."""

    def __init__(self, base, server) -> None:
        self.base = base
        self.s = server

    def apply(self, r: InternalRaftRequest) -> ApplyResult:
        if r.op in ("put", "txn", "lease_grant"):
            if not self.s.quota_available(r):
                self.s.maybe_raise_nospace_alarm()
                return ApplyResult(err=NoSpaceError())
        return self.base.apply(r)


class AlarmApplier:
    """Write fence while an alarm is active
    (ref: server.go checkAlarms + applierV3Capped/corrupt)."""

    WRITE_OPS = {"put", "delete_range", "txn", "lease_grant"}

    def __init__(self, base, server) -> None:
        self.base = base
        self.s = server

    def apply(self, r: InternalRaftRequest) -> ApplyResult:
        from .api import AlarmType

        active = self.s.alarms.active_types()
        if AlarmType.CORRUPT in active:
            # Alarm ops must pass the fence or DEACTIVATE could never
            # disarm it (ref: corrupt.go applierV3Corrupt wraps only
            # KV/lease ops; Alarm goes to the base applier).
            if r.op == "alarm":
                return self.base.apply(r)
            return ApplyResult(err=CorruptError())
        if AlarmType.NOSPACE in active and r.op in self.WRITE_OPS:
            if not (r.op == "txn" and not _is_txn_write(r.req)):
                return ApplyResult(err=NoSpaceError())
        return self.base.apply(r)
