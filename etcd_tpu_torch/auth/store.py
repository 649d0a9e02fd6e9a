"""The auth store (ref: server/auth/store.go).

State lives in three backend buckets — the enable flag + auth revision,
users, roles — exactly the reference's schema split. Every mutation
bumps the **auth revision**; requests carry the revision their token was
minted at and are rejected with AuthOldRevisionError when stale
(store.go isValidPermission/isOpPermitted revision gate). Permission
checks resolve through the per-user unified interval-tree cache
(range_perm_cache.py), rebuilt on every mutation.

Passwords are salted PBKDF2-HMAC-SHA256 (the stdlib stand-in for the
reference's bcrypt; same contract: cost-parameterized, per-user salt,
constant-time compare).

Ports ``etcd_tpu/auth/store.py``.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import os
import threading
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Dict, List, Optional

from ..storage import backend as bk
from .range_perm_cache import UnifiedRangePermissions

ROOT_USER = "root"
ROOT_ROLE = "root"

AUTH_BUCKET = bk.Bucket("auth")
USERS_BUCKET = bk.Bucket("authUsers")
ROLES_BUCKET = bk.Bucket("authRoles")

ENABLED_KEY = b"authEnabled"
REVISION_KEY = b"authRevision"

DEFAULT_PBKDF2_ITERS = 10_000  # host-side cost knob (bcrypt-cost analog)


class PermissionType(IntEnum):
    """ref: authpb.Permission_Type."""

    READ = 0
    WRITE = 1
    READWRITE = 2


@dataclass
class Permission:
    perm_type: PermissionType = PermissionType.READ
    key: bytes = b""
    range_end: bytes = b""


@dataclass
class User:
    name: str = ""
    password: str = ""  # "salt$iters$hexhash", empty for no-password users
    roles: List[str] = field(default_factory=list)
    no_password: bool = False


@dataclass
class Role:
    name: str = ""
    key_permissions: List[Permission] = field(default_factory=list)


@dataclass
class AuthInfo:
    """ref: auth.AuthInfo — identity + the auth revision it was minted at."""

    username: str = ""
    revision: int = 0


class AuthError(Exception):
    pass


class AuthDisabledError(AuthError):
    """ref: ErrAuthNotEnabled (op requires enabled auth)."""


class AuthNotEnabledError(AuthError):
    pass


class AuthFailedError(AuthError):
    """ref: ErrAuthFailed."""


class AuthOldRevisionError(AuthError):
    """ref: ErrAuthOldRevision."""


class InvalidAuthTokenError(AuthError):
    """ref: ErrInvalidAuthToken."""


class PermissionDeniedError(AuthError):
    """ref: ErrPermissionDenied."""


class UserAlreadyExistError(AuthError):
    pass


class UserEmptyError(AuthError):
    pass


class UserNotFoundError(AuthError):
    pass


class RoleAlreadyExistError(AuthError):
    pass


class RoleNotFoundError(AuthError):
    pass


class RoleNotGrantedError(AuthError):
    pass


class RootUserNotExistError(AuthError):
    """ref: ErrRootUserNotExist."""


class RootRoleNotGrantedError(AuthError):
    """ref: ErrRootRoleNotExist."""


def hash_password(password: str, iters: int = DEFAULT_PBKDF2_ITERS) -> str:
    salt = os.urandom(16)
    dk = hashlib.pbkdf2_hmac("sha256", password.encode(), salt, iters)
    return f"{salt.hex()}${iters}${dk.hex()}"


def verify_password(stored: str, password: str) -> bool:
    if not stored:
        return False
    try:
        salt_hex, iters_s, hash_hex = stored.split("$")
        dk = hashlib.pbkdf2_hmac(
            "sha256", password.encode(), bytes.fromhex(salt_hex), int(iters_s)
        )
        return hmac.compare_digest(dk.hex(), hash_hex)
    except ValueError:
        return False


def _user_to_bytes(u: User) -> bytes:
    return json.dumps(
        {
            "name": u.name,
            "password": u.password,
            "roles": u.roles,
            "no_password": u.no_password,
        }
    ).encode()


def _user_from_bytes(b: bytes) -> User:
    d = json.loads(b.decode())
    return User(
        name=d["name"],
        password=d["password"],
        roles=list(d["roles"]),
        no_password=d.get("no_password", False),
    )


def _role_to_bytes(r: Role) -> bytes:
    return json.dumps(
        {
            "name": r.name,
            "perms": [
                {
                    "type": int(p.perm_type),
                    "key": p.key.hex(),
                    "range_end": p.range_end.hex(),
                }
                for p in r.key_permissions
            ],
        }
    ).encode()


def _role_from_bytes(b: bytes) -> Role:
    d = json.loads(b.decode())
    return Role(
        name=d["name"],
        key_permissions=[
            Permission(
                perm_type=PermissionType(p["type"]),
                key=bytes.fromhex(p["key"]),
                range_end=bytes.fromhex(p["range_end"]),
            )
            for p in d["perms"]
        ],
    )


class AuthStore:
    """ref: server/auth/store.go authStore."""

    def __init__(
        self,
        backend: bk.Backend,
        token_provider=None,
        pbkdf2_iters: int = DEFAULT_PBKDF2_ITERS,
    ) -> None:
        self._lock = threading.RLock()
        self.b = backend
        self.tp = token_provider
        self.iters = pbkdf2_iters
        self._enabled = False
        self._revision = 0
        self._range_perm_cache: Dict[str, UnifiedRangePermissions] = {}

        tx = self.b.batch_tx
        with tx.lock:
            tx.unsafe_create_bucket(AUTH_BUCKET)
            tx.unsafe_create_bucket(USERS_BUCKET)
            tx.unsafe_create_bucket(ROLES_BUCKET)
        rt = self.b.read_tx()
        enabled = rt.get(AUTH_BUCKET, ENABLED_KEY)
        rev = rt.get(AUTH_BUCKET, REVISION_KEY)
        self._revision = int.from_bytes(rev, "big") if rev else 0
        if enabled == b"\x01":
            self._enabled = True
            if self.tp is not None:
                self.tp.enable()
            self._refresh_range_perm_cache()

    # -- helpers ---------------------------------------------------------------

    def _commit_revision(self) -> None:
        """Bump + persist auth revision (ref: store.go commitRevision)."""
        self._revision += 1
        tx = self.b.batch_tx
        with tx.lock:
            tx.put(AUTH_BUCKET, REVISION_KEY, self._revision.to_bytes(8, "big"))

    def revision(self) -> int:
        with self._lock:
            return self._revision

    def _get_user(self, name: str) -> Optional[User]:
        v = self.b.read_tx().get(USERS_BUCKET, name.encode())
        return _user_from_bytes(v) if v is not None else None

    def _put_user(self, u: User) -> None:
        tx = self.b.batch_tx
        with tx.lock:
            tx.put(USERS_BUCKET, u.name.encode(), _user_to_bytes(u))

    def _get_role(self, name: str) -> Optional[Role]:
        v = self.b.read_tx().get(ROLES_BUCKET, name.encode())
        return _role_from_bytes(v) if v is not None else None

    def _put_role(self, r: Role) -> None:
        tx = self.b.batch_tx
        with tx.lock:
            tx.put(ROLES_BUCKET, r.name.encode(), _role_to_bytes(r))

    def _all_users(self) -> List[User]:
        rows = self.b.read_tx().range(USERS_BUCKET, b"", b"\xff" * 64, 0)
        return [_user_from_bytes(v) for _k, v in rows]

    def _all_roles(self) -> List[Role]:
        rows = self.b.read_tx().range(ROLES_BUCKET, b"", b"\xff" * 64, 0)
        return [_role_from_bytes(v) for _k, v in rows]

    def _refresh_range_perm_cache(self) -> None:
        """Rebuild every user's merged permission trees
        (ref: range_perm_cache.go refreshRangePermCache)."""
        cache: Dict[str, UnifiedRangePermissions] = {}
        roles = {r.name: r for r in self._all_roles()}
        for user in self._all_users():
            perms = UnifiedRangePermissions()
            for rname in user.roles:
                role = roles.get(rname)
                if role is None:
                    continue
                for p in role.key_permissions:
                    perms.add(p.key, p.range_end, p.perm_type)
            cache[user.name] = perms
        self._range_perm_cache = cache

    # -- enable / disable ------------------------------------------------------

    def is_auth_enabled(self) -> bool:
        with self._lock:
            return self._enabled

    def auth_enable(self) -> None:
        """ref: store.go AuthEnable — requires root user with root role."""
        with self._lock:
            if self._enabled:
                return
            root = self._get_user(ROOT_USER)
            if root is None:
                raise RootUserNotExistError()
            if ROOT_ROLE not in root.roles:
                raise RootRoleNotGrantedError()
            tx = self.b.batch_tx
            with tx.lock:
                tx.put(AUTH_BUCKET, ENABLED_KEY, b"\x01")
            self._enabled = True
            if self.tp is not None:
                self.tp.enable()
            self._refresh_range_perm_cache()
            self._commit_revision()

    def auth_disable(self) -> None:
        with self._lock:
            if not self._enabled:
                return
            tx = self.b.batch_tx
            with tx.lock:
                tx.put(AUTH_BUCKET, ENABLED_KEY, b"\x00")
            self._enabled = False
            if self.tp is not None:
                self.tp.disable()
            self._commit_revision()

    # -- authentication --------------------------------------------------------

    def check_password(self, username: str, password: str) -> int:
        """Verify credentials; returns current auth revision
        (ref: store.go CheckPassword)."""
        with self._lock:
            if not self._enabled:
                raise AuthNotEnabledError()
            user = self._get_user(username)
            if user is None or user.no_password:
                raise AuthFailedError()
        if not verify_password(user.password, password):
            raise AuthFailedError()
        with self._lock:
            return self._revision

    def authenticate(self, username: str, password: str) -> str:
        """Credentials → token (ref: store.go Authenticate + api layer)."""
        rev = self.check_password(username, password)
        if self.tp is None:
            raise AuthError("no token provider configured")
        return self.tp.assign(username, rev)

    def auth_info_from_token(self, token: str) -> AuthInfo:
        """ref: store.go AuthInfoFromCtx token resolution."""
        with self._lock:
            if not self._enabled:
                return AuthInfo()
            if self.tp is None:
                raise InvalidAuthTokenError()
            user = self.tp.info(token)
            if user is None:
                raise InvalidAuthTokenError()
            return AuthInfo(username=user, revision=self._revision)

    # -- user management -------------------------------------------------------

    def user_add(
        self, name: str, password: str = "", no_password: bool = False
    ) -> None:
        """ref: store.go UserAdd."""
        if not name:
            raise UserEmptyError()
        with self._lock:
            if self._get_user(name) is not None:
                raise UserAlreadyExistError(name)
            hashed = "" if no_password else hash_password(password, self.iters)
            self._put_user(User(name=name, password=hashed, no_password=no_password))
            self._commit_revision()
            self._refresh_range_perm_cache()

    def user_delete(self, name: str) -> None:
        with self._lock:
            if self._enabled and name == ROOT_USER:
                raise AuthError("cannot delete root user while auth is enabled")
            if self._get_user(name) is None:
                raise UserNotFoundError(name)
            tx = self.b.batch_tx
            with tx.lock:
                tx.delete(USERS_BUCKET, name.encode())
            if self.tp is not None:
                self.tp.invalidate_user(name)
            self._commit_revision()
            self._refresh_range_perm_cache()

    def user_change_password(self, name: str, password: str) -> None:
        with self._lock:
            user = self._get_user(name)
            if user is None:
                raise UserNotFoundError(name)
            user.password = hash_password(password, self.iters)
            self._put_user(user)
            if self.tp is not None:
                self.tp.invalidate_user(name)
            self._commit_revision()

    def user_grant_role(self, user: str, role: str) -> None:
        with self._lock:
            u = self._get_user(user)
            if u is None:
                raise UserNotFoundError(user)
            if role != ROOT_ROLE and self._get_role(role) is None:
                raise RoleNotFoundError(role)
            if role in u.roles:
                return
            u.roles = sorted(u.roles + [role])
            self._put_user(u)
            self._commit_revision()
            self._refresh_range_perm_cache()

    def user_revoke_role(self, user: str, role: str) -> None:
        with self._lock:
            u = self._get_user(user)
            if u is None:
                raise UserNotFoundError(user)
            if role not in u.roles:
                raise RoleNotGrantedError(role)
            u.roles = [r for r in u.roles if r != role]
            self._put_user(u)
            self._commit_revision()
            self._refresh_range_perm_cache()

    def user_get(self, name: str) -> User:
        with self._lock:
            u = self._get_user(name)
            if u is None:
                raise UserNotFoundError(name)
            return u

    def user_list(self) -> List[str]:
        with self._lock:
            return sorted(u.name for u in self._all_users())

    # -- role management -------------------------------------------------------

    def role_add(self, name: str) -> None:
        if not name:
            raise AuthError("role name empty")
        with self._lock:
            if self._get_role(name) is not None:
                raise RoleAlreadyExistError(name)
            self._put_role(Role(name=name))
            self._commit_revision()

    def role_delete(self, name: str) -> None:
        """Deletes the role and revokes it from every user
        (ref: store.go RoleDelete)."""
        with self._lock:
            if self._enabled and name == ROOT_ROLE:
                raise AuthError("cannot delete root role while auth is enabled")
            if self._get_role(name) is None:
                raise RoleNotFoundError(name)
            tx = self.b.batch_tx
            with tx.lock:
                tx.delete(ROLES_BUCKET, name.encode())
            for u in self._all_users():
                if name in u.roles:
                    u.roles = [r for r in u.roles if r != name]
                    self._put_user(u)
            self._commit_revision()
            self._refresh_range_perm_cache()

    def role_grant_permission(self, role: str, perm: Permission) -> None:
        with self._lock:
            r = self._get_role(role)
            if r is None:
                raise RoleNotFoundError(role)
            r.key_permissions = [
                p
                for p in r.key_permissions
                if not (p.key == perm.key and p.range_end == perm.range_end)
            ] + [perm]
            r.key_permissions.sort(key=lambda p: (p.key, p.range_end))
            self._put_role(r)
            self._commit_revision()
            self._refresh_range_perm_cache()

    def role_revoke_permission(
        self, role: str, key: bytes, range_end: bytes = b""
    ) -> None:
        with self._lock:
            r = self._get_role(role)
            if r is None:
                raise RoleNotFoundError(role)
            before = len(r.key_permissions)
            r.key_permissions = [
                p
                for p in r.key_permissions
                if not (p.key == key and p.range_end == range_end)
            ]
            if len(r.key_permissions) == before:
                raise AuthError("permission not granted to the role")
            self._put_role(r)
            self._commit_revision()
            self._refresh_range_perm_cache()

    def role_get(self, name: str) -> Role:
        with self._lock:
            r = self._get_role(name)
            if r is None:
                raise RoleNotFoundError(name)
            return r

    def role_list(self) -> List[str]:
        with self._lock:
            return sorted(r.name for r in self._all_roles())

    # -- permission checks -----------------------------------------------------

    def _is_op_permitted(
        self, info: Optional[AuthInfo], key: bytes, range_end: bytes, write: bool
    ) -> None:
        """ref: store.go isOpPermitted."""
        with self._lock:
            if not self._enabled:
                return
            if info is None or not info.username:
                raise UserEmptyError()
            if info.revision == 0:
                raise InvalidAuthTokenError()
            if info.revision < self._revision:
                raise AuthOldRevisionError()
            user = self._get_user(info.username)
            if user is None:
                raise UserNotFoundError(info.username)
            if ROOT_ROLE in user.roles:
                return
            perms = self._range_perm_cache.get(info.username)
            ok = (
                perms is not None
                and (
                    perms.check_write(key, range_end)
                    if write
                    else perms.check_read(key, range_end)
                )
            )
            if not ok:
                raise PermissionDeniedError()

    def is_put_permitted(self, info: Optional[AuthInfo], key: bytes) -> None:
        self._is_op_permitted(info, key, b"", write=True)

    def is_range_permitted(
        self, info: Optional[AuthInfo], key: bytes, range_end: bytes = b""
    ) -> None:
        self._is_op_permitted(info, key, range_end, write=False)

    def is_delete_range_permitted(
        self, info: Optional[AuthInfo], key: bytes, range_end: bytes = b""
    ) -> None:
        self._is_op_permitted(info, key, range_end, write=True)

    def is_admin_permitted(self, info: Optional[AuthInfo]) -> None:
        """ref: store.go IsAdminPermitted — root role required."""
        with self._lock:
            if not self._enabled:
                return
            if info is None or not info.username:
                raise UserEmptyError()
            if info.revision < self._revision:
                raise AuthOldRevisionError()
            user = self._get_user(info.username)
            if user is None:
                raise UserNotFoundError(info.username)
            if ROOT_ROLE not in user.roles:
                raise PermissionDeniedError()

    def recover(self, backend: bk.Backend) -> None:
        """Reload state after a backend swap (ref: store.go Recover)."""
        with self._lock:
            self.b = backend
            rt = self.b.read_tx()
            enabled = rt.get(AUTH_BUCKET, ENABLED_KEY)
            rev = rt.get(AUTH_BUCKET, REVISION_KEY)
            self._enabled = enabled == b"\x01"
            self._revision = int.from_bytes(rev, "big") if rev else 0
            if self._enabled and self.tp is not None:
                self.tp.enable()
            self._refresh_range_perm_cache()
