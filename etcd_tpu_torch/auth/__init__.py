"""AuthN/Z (ref: server/auth/).

Users, roles, key-range permissions backed by an interval tree, token
providers (simple TTL tokens + HMAC-signed stateless tokens, the JWT
analog), and a revision-checked store so stale-auth requests are
rejected the way the reference does.

Ports ``etcd_tpu/auth/__init__.py``.
"""

from .store import (  # noqa: F401
    AuthStore,
    AuthInfo,
    AuthDisabledError,
    AuthNotEnabledError,
    AuthFailedError,
    AuthOldRevisionError,
    InvalidAuthTokenError,
    PermissionDeniedError,
    RoleAlreadyExistError,
    RoleNotFoundError,
    RoleNotGrantedError,
    RootUserNotExistError,
    RootRoleNotGrantedError,
    UserAlreadyExistError,
    UserEmptyError,
    UserNotFoundError,
    Permission,
    PermissionType,
    ROOT_USER,
    ROOT_ROLE,
)
from .simple_token import SimpleTokenProvider  # noqa: F401
from .hmac_token import HMACTokenProvider  # noqa: F401
