"""Canonical RPC error table: one registry of every typed error the
server can return, each with a stable symbolic code, a gRPC status
code, and the canonical message (ref: api/v3rpc/rpctypes/error.go —
the single code<->error table etcd clients program against).

Servers serialize errors as ``{"code": symbol, "grpcCode": int,
"msg": str}``; clients look the symbol up here to rebuild the typed
exception and to drive retry/failover decisions off codes rather than
Python class names (the class name is still sent as ``type`` for
wire compatibility with older peers).

Ports ``etcd_tpu/pkg/rpctypes.py``. Its one difference: the table's class
paths name ``etcd_tpu_torch`` modules, so a client that rebuilds a server
error imports nothing of ``etcd_tpu``. Classes are keyed by name on the
wire, so either package's client reads either package's server.
"""

from __future__ import annotations

import importlib
from enum import IntEnum
from typing import Dict, Optional, Tuple


class Code(IntEnum):
    """gRPC status codes (ref: google.golang.org/grpc/codes)."""

    OK = 0
    Canceled = 1
    Unknown = 2
    InvalidArgument = 3
    DeadlineExceeded = 4
    NotFound = 5
    AlreadyExists = 6
    PermissionDenied = 7
    ResourceExhausted = 8
    FailedPrecondition = 9
    Aborted = 10
    OutOfRange = 11
    Unimplemented = 12
    Internal = 13
    Unavailable = 14
    DataLoss = 15
    Unauthenticated = 16


# symbol -> (grpc code, canonical message, "module.path:ClassName").
# Symbols and messages mirror api/v3rpc/rpctypes/error.go; the class
# path names the exception this framework raises for that condition.
TABLE: Dict[str, Tuple[Code, str, str]] = {
    # KV / txn argument errors (rpctypes/error.go:24-34)
    "ErrCompacted": (
        Code.OutOfRange,
        "etcdserver: mvcc: required revision has been compacted",
        "etcd_tpu_torch.storage.mvcc.kvstore:CompactedError"),
    "ErrFutureRev": (
        Code.OutOfRange,
        "etcdserver: mvcc: required revision is a future revision",
        "etcd_tpu_torch.storage.mvcc.kvstore:FutureRevError"),
    "ErrNoSpace": (
        Code.ResourceExhausted,
        "etcdserver: mvcc: database space exceeded",
        "etcd_tpu_torch.server.apply:NoSpaceError"),
    # Lease (rpctypes/error.go:36-38)
    "ErrLeaseNotFound": (
        Code.NotFound, "etcdserver: requested lease not found",
        "etcd_tpu_torch.lease.lessor:LeaseNotFoundError"),
    "ErrLeaseExist": (
        Code.FailedPrecondition, "etcdserver: lease already exists",
        "etcd_tpu_torch.lease.lessor:LeaseExistsError"),
    "ErrLeaseTTLTooLarge": (
        Code.OutOfRange, "etcdserver: too large lease TTL",
        "etcd_tpu_torch.lease.lessor:LeaseTTLTooLargeError"),
    "ErrLeaseExpired": (
        Code.NotFound, "etcdserver: lease expired",
        "etcd_tpu_torch.lease.lessor:LeaseExpiredError"),
    # Membership (rpctypes/error.go:42-49)
    "ErrMemberExist": (
        Code.FailedPrecondition, "etcdserver: member ID already exist",
        "etcd_tpu_torch.server.membership:MemberExistsError"),
    "ErrMemberNotFound": (
        Code.NotFound, "etcdserver: member not found",
        "etcd_tpu_torch.server.membership:MemberNotFoundError"),
    "ErrMemberRemoved": (
        Code.Unavailable,
        "etcdserver: the member has been permanently removed from the "
        "cluster",
        "etcd_tpu_torch.server.membership:MemberRemovedError"),
    # Request admission (rpctypes/error.go:51-52)
    "ErrRequestTooLarge": (
        Code.InvalidArgument, "etcdserver: request is too large",
        "etcd_tpu_torch.server.server:RequestTooLargeError"),
    "ErrTooManyRequests": (
        Code.ResourceExhausted, "etcdserver: too many requests",
        "etcd_tpu_torch.server.server:TooManyRequestsError"),
    # Auth (rpctypes/error.go:54-70)
    "ErrRootUserNotExist": (
        Code.FailedPrecondition, "etcdserver: root user does not exist",
        "etcd_tpu_torch.auth.store:RootUserNotExistError"),
    "ErrRootRoleNotExist": (
        Code.FailedPrecondition,
        "etcdserver: root user does not have root role",
        "etcd_tpu_torch.auth.store:RootRoleNotGrantedError"),
    "ErrUserAlreadyExist": (
        Code.FailedPrecondition, "etcdserver: user name already exists",
        "etcd_tpu_torch.auth.store:UserAlreadyExistError"),
    "ErrUserEmpty": (
        Code.InvalidArgument, "etcdserver: user name is empty",
        "etcd_tpu_torch.auth.store:UserEmptyError"),
    "ErrUserNotFound": (
        Code.FailedPrecondition, "etcdserver: user name not found",
        "etcd_tpu_torch.auth.store:UserNotFoundError"),
    "ErrRoleAlreadyExist": (
        Code.FailedPrecondition, "etcdserver: role name already exists",
        "etcd_tpu_torch.auth.store:RoleAlreadyExistError"),
    "ErrRoleNotFound": (
        Code.FailedPrecondition, "etcdserver: role name not found",
        "etcd_tpu_torch.auth.store:RoleNotFoundError"),
    "ErrAuthFailed": (
        Code.InvalidArgument,
        "etcdserver: authentication failed, invalid user ID or password",
        "etcd_tpu_torch.auth.store:AuthFailedError"),
    "ErrPermissionDenied": (
        Code.PermissionDenied, "etcdserver: permission denied",
        "etcd_tpu_torch.auth.store:PermissionDeniedError"),
    "ErrRoleNotGranted": (
        Code.FailedPrecondition,
        "etcdserver: role is not granted to the user",
        "etcd_tpu_torch.auth.store:RoleNotGrantedError"),
    "ErrAuthNotEnabled": (
        Code.FailedPrecondition,
        "etcdserver: authentication is not enabled",
        "etcd_tpu_torch.auth.store:AuthNotEnabledError"),
    "ErrInvalidAuthToken": (
        Code.Unauthenticated, "etcdserver: invalid auth token",
        "etcd_tpu_torch.auth.store:InvalidAuthTokenError"),
    "ErrAuthOldRevision": (
        Code.InvalidArgument,
        "etcdserver: revision of auth store is old",
        "etcd_tpu_torch.auth.store:AuthOldRevisionError"),
    "ErrAuthDisabled": (
        Code.FailedPrecondition,
        "etcdserver: authentication is disabled",
        "etcd_tpu_torch.auth.store:AuthDisabledError"),
    # Cluster health / leadership (rpctypes/error.go:72-84)
    "ErrNoLeader": (
        Code.Unavailable, "etcdserver: no leader",
        "etcd_tpu_torch.server.v3election:ElectionNoLeaderError"),
    "ErrNotLeader": (
        Code.FailedPrecondition, "etcdserver: not leader",
        "etcd_tpu_torch.pkg.errors:NotLeaderError"),
    "ErrStopped": (
        Code.Unavailable, "etcdserver: server stopped",
        "etcd_tpu_torch.server.server:StoppedError"),
    "ErrTimeout": (
        Code.Unavailable, "etcdserver: request timed out",
        "etcd_tpu_torch.server.server:TimeoutError_"),
    "ErrCorrupt": (
        Code.DataLoss, "etcdserver: corrupt cluster",
        "etcd_tpu_torch.server.apply:CorruptError"),
    "ErrCorruptCheck": (
        Code.DataLoss, "etcdserver: corruption check failed",
        "etcd_tpu_torch.server.corrupt:CorruptCheckError"),
    # v3election (api/v3election)
    "ErrElectionNotLeader": (
        Code.FailedPrecondition, "etcdserver: not leader of election",
        "etcd_tpu_torch.server.v3election:ElectionNotLeaderError"),
}

# Class name -> symbol (reverse index for serialization).
_CLASS_TO_SYMBOL: Dict[str, str] = {
    path.rsplit(":", 1)[1]: sym for sym, (_, _, path) in TABLE.items()
}
# Duplicate class names would silently shadow each other here; the
# round-trip test asserts this mapping stays 1:1.

# Symbols clients fail over to another endpoint on: exactly the
# Unavailable class (ref: client/v3 retry_interceptor.go — retries on
# codes.Unavailable), which captures no-leader/stopped/member-removed.
FAILOVER_SYMBOLS = frozenset(
    sym for sym, (code, _, _) in TABLE.items() if code == Code.Unavailable
)


def entry_for_exception(e: Exception) -> Optional[Tuple[str, Code, str]]:
    """(symbol, grpc code, canonical message) for a typed server error,
    or None for errors outside the canonical table."""
    sym = _CLASS_TO_SYMBOL.get(type(e).__name__)
    if sym is None:
        return None
    code, msg, _path = TABLE[sym]
    return sym, code, msg


def exception_for(symbol: str, msg: str = "") -> Optional[Exception]:
    """Rebuild the canonical typed exception for a symbol (client side).
    Returns None for unknown symbols (caller falls back to a generic
    error). Classes are resolved lazily to keep this module free of
    import cycles."""
    entry = TABLE.get(symbol)
    if entry is None:
        return None
    code, canonical_msg, path = entry
    mod_name, cls_name = path.rsplit(":", 1)
    cls = getattr(importlib.import_module(mod_name), cls_name)
    return cls(msg or canonical_msg)
