"""Replicated in-memory KV on top of the Ready loop
(ref: contrib/raftexample/kvstore.go — map + gob + snapshot; here the
wire/snapshot encoding is JSON, the fields are the same).

Ports ``etcd_tpu/raftexample/kvstore.py`` whole.
"""

from __future__ import annotations

import json
import threading
from typing import Dict, List, Optional

from ..raft.types import Entry


class ReplicatedKV:
    """The app: proposals are {"key","val"} JSON blobs; lookups are
    served from the local applied map (ref: kvstore.go Lookup/Propose)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._store: Dict[str, str] = {}
        self.node = None  # set by attach()

    def attach(self, node) -> None:
        self.node = node

    # -- raftnode callbacks ----------------------------------------------------

    def apply(self, ents: List[Entry]) -> None:
        with self._lock:
            for e in ents:
                kv = json.loads(e.data.decode())
                self._store[kv["key"]] = kv["val"]

    def snapshot(self) -> bytes:
        with self._lock:
            return json.dumps(self._store).encode()

    def restore(self, data: bytes) -> None:
        with self._lock:
            self._store = json.loads(data.decode()) if data else {}

    # -- client API ------------------------------------------------------------

    def propose(self, key: str, val: str, timeout: float = 5.0) -> None:
        data = json.dumps({"key": key, "val": val}).encode()
        self.node.propose(data, timeout=timeout)

    def lookup(self, key: str) -> Optional[str]:
        with self._lock:
            return self._store.get(key)

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)
