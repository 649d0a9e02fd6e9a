"""Consistent index (ref: server/etcdserver/cindex/cindex.go:56-118).

The applied raft index is persisted in the meta bucket *inside the same
backend batch* as the apply's writes (via a backend commit hook), so a
replayed WAL entry whose index ≤ the stored value is skipped — applies
are exactly-once across restarts (guard at server.go:1815-1827).

Ports ``etcd_tpu/server/cindex.py``.
"""

from __future__ import annotations

import struct
import threading

from ..storage import backend as bk

META_BUCKET = bk.Bucket("meta")
CONSISTENT_INDEX_KEY = b"consistent_index"
TERM_KEY = b"term"


class ConsistentIndex:
    def __init__(self, backend: bk.Backend) -> None:
        self._lock = threading.Lock()
        self._b = backend
        self._index = 0
        self._term = 0
        tx = backend.batch_tx
        with tx.lock:
            tx.unsafe_create_bucket(META_BUCKET)
        v = backend.read_tx().get(META_BUCKET, CONSISTENT_INDEX_KEY)
        if v is not None:
            self._index = struct.unpack(">Q", v)[0]
        t = backend.read_tx().get(META_BUCKET, TERM_KEY)
        if t is not None:
            self._term = struct.unpack(">Q", t)[0]
        # Commit hook: persist in the same batch as buffered applies
        # (ref: server/storage/hooks.go OnPreCommitUnsafe).
        backend.add_hook(self._persist_hook)

    def _persist_hook(self, tx) -> None:
        with self._lock:
            tx.put(META_BUCKET, CONSISTENT_INDEX_KEY, struct.pack(">Q", self._index))
            tx.put(META_BUCKET, TERM_KEY, struct.pack(">Q", self._term))

    def consistent_index(self) -> int:
        with self._lock:
            return self._index

    def set_consistent_index(self, index: int, term: int) -> None:
        with self._lock:
            self._index = index
            self._term = term

    def term(self) -> int:
        with self._lock:
            return self._term
