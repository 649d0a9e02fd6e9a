"""JWT token provider (ref: server/auth/jwt.go:31-120 tokenJWT).

Standard JWT wire format — ``base64url(header).base64url(claims).
base64url(sig)`` with an ``{"alg","typ"}`` header — carrying the
reference's claim set ``{username, revision, exp}`` (jwt.go:71-83
assign). Signing is HS256/HS384/HS512 from the standard library; the
reference additionally supports RSA/ECDSA, which is a key-material
deployment concern, not a protocol difference — the validation
pipeline (alg allow-list, signature check, exp check, revision
extraction) matches jwt.go:41-69 info/parse.

Option string parity with --auth-token
(jwt.go:85-120 NewTokenProviderJWT / prepareOpts):
``jwt,sign-method=HS256,sign-key=<secret>,ttl=5m``.

Ports ``etcd_tpu/auth/jwt_token.py``.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
from typing import Dict, Optional, Tuple

DEFAULT_JWT_TTL = 300.0

_ALGS = {
    "HS256": hashlib.sha256,
    "HS384": hashlib.sha384,
    "HS512": hashlib.sha512,
}


def _b64e(b: bytes) -> str:
    return base64.urlsafe_b64encode(b).rstrip(b"=").decode()


def _b64d(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def parse_ttl(spec: str) -> float:
    """'5m' / '30s' / '1h' / plain seconds (jwt.go ttl option)."""
    spec = spec.strip()
    mult = {"s": 1, "m": 60, "h": 3600}.get(spec[-1:], None)
    if mult is not None:
        return float(spec[:-1]) * mult
    return float(spec)


class JWTTokenProvider:
    """ref: jwt.go tokenJWT — stateless signed tokens; every member
    can validate without shared state, so auth survives leader moves."""

    def __init__(self, sign_key: bytes, sign_method: str = "HS256",
                 ttl: float = DEFAULT_JWT_TTL) -> None:
        if sign_method not in _ALGS:
            raise ValueError(
                f"unsupported sign method {sign_method!r} "
                f"(supported: {sorted(_ALGS)})")
        self._key = sign_key
        self._alg = sign_method
        self._ttl = ttl
        self._enabled = False

    @classmethod
    def from_opts(cls, opts: str) -> "JWTTokenProvider":
        """``sign-method=HS256,sign-key=k,ttl=5m`` (jwt.go prepareOpts)."""
        kv: Dict[str, str] = {}
        for part in opts.split(","):
            if not part:
                continue
            k, _, v = part.partition("=")
            kv[k.strip()] = v.strip()
        key = kv.get("sign-key", "")
        if not key:
            raise ValueError("jwt: sign-key option is required")
        return cls(
            key.encode(),
            sign_method=kv.get("sign-method", "HS256"),
            ttl=parse_ttl(kv["ttl"]) if "ttl" in kv else DEFAULT_JWT_TTL,
        )

    # -- TokenProvider surface (same as simple/hmac providers) -----------------

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def _sign(self, signing_input: bytes) -> bytes:
        return hmac.new(self._key, signing_input, _ALGS[self._alg]).digest()

    def assign(self, username: str, revision: int = 0) -> str:
        """jwt.go:71-83 assign — mint {username, revision, exp}."""
        if not self._enabled:
            raise RuntimeError("jwt token provider disabled")
        header = {"alg": self._alg, "typ": "JWT"}
        claims = {
            "username": username,
            "revision": revision,
            # NumericDate; RFC 7519 §2 allows a fractional part.
            "exp": time.time() + self._ttl,
        }
        signing_input = (
            _b64e(json.dumps(header, separators=(",", ":")).encode())
            + "."
            + _b64e(json.dumps(claims, separators=(",", ":")).encode())
        ).encode()
        return signing_input.decode() + "." + _b64e(self._sign(signing_input))

    def info(self, token: str) -> Optional[str]:
        ur = self.info_with_revision(token)
        return ur[0] if ur is not None else None

    def info_with_revision(self, token: str) -> Optional[Tuple[str, int]]:
        """jwt.go:41-69 info — None on any validation failure."""
        if not self._enabled:
            return None
        try:
            header_b64, claims_b64, sig_b64 = token.split(".")
            header = json.loads(_b64d(header_b64))
            # alg allow-list: reject alg-confusion tokens ("none" etc.).
            if header.get("alg") != self._alg:
                return None
            signing_input = (header_b64 + "." + claims_b64).encode()
            if not hmac.compare_digest(
                    _b64d(sig_b64), self._sign(signing_input)):
                return None
            claims = json.loads(_b64d(claims_b64))
            if float(claims.get("exp", 0)) < time.time():
                return None
            return str(claims["username"]), int(claims.get("revision", 0))
        except (ValueError, KeyError, TypeError):
            return None

    # Stateless: nothing to invalidate per-user, same as the reference
    # (jwt.go invalidateUser is a no-op).
    def invalidate_user(self, username: str) -> None:
        pass
