"""Stateless signed tokens: the JWT analog (ref: server/auth/jwt.go).

Same shape as the reference's JWT provider — a signed claim set of
``{username, revision, exp}`` — but signed with HMAC-SHA256 from the
standard library instead of RSA/ECDSA, since key material handling is a
deployment concern, not a protocol one. Token format:

    base64url(json claims) "." base64url(hmac)

Ports ``etcd_tpu/auth/hmac_token.py``.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
from typing import Optional, Tuple

DEFAULT_HMAC_TOKEN_TTL = 300.0


class HMACTokenProvider:
    def __init__(self, sign_key: bytes, ttl: float = DEFAULT_HMAC_TOKEN_TTL) -> None:
        self._key = sign_key
        self._ttl = ttl
        self._enabled = False

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def _sign(self, payload: bytes) -> bytes:
        return hmac.new(self._key, payload, hashlib.sha256).digest()

    def assign(self, username: str, revision: int = 0) -> str:
        """ref: jwt.go assign — claims {username, revision, exp}."""
        if not self._enabled:
            raise RuntimeError("hmac token provider disabled")
        claims = {
            "username": username,
            "revision": revision,
            "exp": time.time() + self._ttl,
        }
        payload = base64.urlsafe_b64encode(json.dumps(claims).encode())
        sig = base64.urlsafe_b64encode(self._sign(payload))
        return payload.decode() + "." + sig.decode()

    def info(self, token: str) -> Optional[str]:
        user_rev = self.info_with_revision(token)
        return user_rev[0] if user_rev is not None else None

    def info_with_revision(self, token: str) -> Optional[Tuple[str, int]]:
        try:
            payload_b64, sig_b64 = token.split(".", 1)
            payload = payload_b64.encode()
            sig = base64.urlsafe_b64decode(sig_b64.encode())
            if not hmac.compare_digest(sig, self._sign(payload)):
                return None
            claims = json.loads(base64.urlsafe_b64decode(payload))
            if time.time() > float(claims["exp"]):
                return None
            return str(claims["username"]), int(claims["revision"])
        except Exception:  # noqa: BLE001 — any malformed token is invalid
            return None

    def invalidate_user(self, username: str) -> None:
        """Stateless tokens can't be revoked individually; revision checks
        cover invalidation (ref: jwt.go — same limitation)."""
