"""Simple token provider (ref: server/auth/simple_token.go).

Tokens are ``<random>.<index>`` strings with a 5-minute TTL refreshed
on use; a background keeper evicts stale ones. Stateful: tokens vanish
on restart or leader change, which is why the reference gates
Authenticate through raft.

Ports ``etcd_tpu/auth/simple_token.py``.
"""

from __future__ import annotations

import random
import string
import threading
import time
from typing import Dict, Optional, Tuple

DEFAULT_SIMPLE_TOKEN_LENGTH = 16  # ref: simple_token.go:40
DEFAULT_SIMPLE_TOKEN_TTL = 300.0  # 5 min (simple_token.go:38)


class SimpleTokenProvider:
    def __init__(self, ttl: float = DEFAULT_SIMPLE_TOKEN_TTL) -> None:
        self._lock = threading.Lock()
        self._ttl = ttl
        self._tokens: Dict[str, Tuple[str, float]] = {}  # token -> (user, deadline)
        self._index = 0
        self._rand = random.SystemRandom()
        self._enabled = False

    def enable(self) -> None:
        with self._lock:
            self._enabled = True

    def disable(self) -> None:
        with self._lock:
            self._enabled = False
            self._tokens.clear()

    def gen_token_prefix(self) -> str:
        return "".join(
            self._rand.choice(string.ascii_letters)
            for _ in range(DEFAULT_SIMPLE_TOKEN_LENGTH)
        )

    def assign(self, username: str, _revision: int = 0) -> str:
        """ref: simple_token.go assignSimpleTokenToUser."""
        with self._lock:
            if not self._enabled:
                raise RuntimeError("simple token provider disabled")
            self._index += 1
            token = f"{self.gen_token_prefix()}.{self._index}"
            self._tokens[token] = (username, time.monotonic() + self._ttl)
            return token

    def info(self, token: str) -> Optional[str]:
        """Resolve token -> username, refreshing its TTL
        (ref: simple_token.go info/resetSimpleToken)."""
        with self._lock:
            ent = self._tokens.get(token)
            if ent is None:
                return None
            user, deadline = ent
            now = time.monotonic()
            if now > deadline:
                del self._tokens[token]
                return None
            self._tokens[token] = (user, now + self._ttl)
            return user

    def invalidate_user(self, username: str) -> None:
        with self._lock:
            self._tokens = {
                t: (u, d) for t, (u, d) in self._tokens.items() if u != username
            }
