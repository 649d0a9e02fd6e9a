"""Transactional bucketed KV backend — the bbolt analog.

The reference stores everything durable-but-queryable (mvcc revisions,
membership, leases, auth, alarms, meta) in one bbolt B+tree file with
batched commits (ref: server/storage/backend/backend.go:47-160). This
backend keeps the same shape and contract over sqlite3 — a native
B-tree engine baked into CPython:

* **buckets** → one two-column table per bucket (key BLOB PRIMARY KEY,
  value BLOB) so range scans ride the B-tree index;
* **batch_tx** → a single long-lived write transaction on the writer
  connection, auto-committed every ``batch_interval`` (100 ms) or
  ``batch_limit`` (10k) pending ops — the reference's batchTxBuffered
  cadence (backend.go:131-160);
* **read_tx** → reads on the writer connection, which see the open
  batch transaction (committed + buffered writes, like the reference's
  txReadBuffer merge);
* **concurrent_read_tx** → reads on a separate connection (WAL mode:
  sees only committed state) merged with a snapshot of the write
  buffer taken at creation — long scans never block the writer
  (backend.go:249 ConcurrentReadTx);
* **commit hooks** run inside every batch commit (ref:
  server/storage/hooks.go — the consistent-index persister);
* **defrag** → VACUUM (backend.go:447); size/size_in_use and commit
  counters feed the metrics surface.

Thread model: mutators serialize on ``batch_tx.lock`` exactly like the
reference's batchTx mutex; sqlite3 runs in serialized threading mode.

Ports ``etcd_tpu/storage/backend.py``.
"""

from __future__ import annotations

import os
import sqlite3
import threading
import time

from . import metrics as dmet
from typing import Callable, Dict, List, Optional, Tuple

DEFAULT_BATCH_INTERVAL = 0.1  # seconds (ref: defaultBatchInterval 100ms)
DEFAULT_BATCH_LIMIT = 10000  # ops (ref: defaultBatchLimit)

_MAX_KEY = b"\xff" * 128


class Bucket:
    """A named keyspace. Instances are cheap views; identity is the name."""

    __slots__ = ("name", "table")

    def __init__(self, name: str) -> None:
        self.name = name
        if not name.replace("_", "").isalnum():
            raise ValueError(f"bad bucket name {name!r}")
        self.table = f"bucket_{name}"


# The reference's schema buckets (server/storage/schema/bucket.go).
KEY = Bucket("key")
META = Bucket("meta")
LEASE = Bucket("lease")
ALARM = Bucket("alarm")
CLUSTER = Bucket("cluster")
MEMBERS = Bucket("members")
MEMBERS_REMOVED = Bucket("members_removed")
AUTH = Bucket("auth")
AUTH_USERS = Bucket("authUsers")
AUTH_ROLES = Bucket("authRoles")
TEST = Bucket("test")

ALL_BUCKETS = [KEY, META, LEASE, ALARM, CLUSTER, MEMBERS, MEMBERS_REMOVED,
               AUTH, AUTH_USERS, AUTH_ROLES, TEST]


class BatchTx:
    """The single buffered write transaction (writer connection)."""

    def __init__(self, backend: "Backend") -> None:
        self._b = backend
        self.lock = threading.RLock()
        self._pending = 0
        # Overlay mirror of uncommitted writes, only consumed by
        # concurrent_read_tx snapshots: bucket -> {key: value|None}.
        self._buf: Dict[str, Dict[bytes, Optional[bytes]]] = {}

    # -- mutations (callers hold .lock) --------------------------------------

    def put(self, bucket: Bucket, key: bytes, value: bytes) -> None:
        self._b._exec(
            f"INSERT INTO {bucket.table}(k, v) VALUES(?, ?) "
            f"ON CONFLICT(k) DO UPDATE SET v=excluded.v",
            (key, value),
        )
        self._buf.setdefault(bucket.name, {})[bytes(key)] = bytes(value)
        self._pending += 1
        if self._pending >= self._b.batch_limit:
            self.commit()

    def delete(self, bucket: Bucket, key: bytes) -> None:
        self._b._exec(f"DELETE FROM {bucket.table} WHERE k=?", (key,))
        self._buf.setdefault(bucket.name, {})[bytes(key)] = None
        self._pending += 1

    def delete_range(self, bucket: Bucket, start: bytes,
                     end: Optional[bytes]) -> int:
        """Delete [start, end); end=None deletes just `start`."""
        if end is None:
            self.delete(bucket, start)
            return 1
        doomed = [
            k for k, _ in self._b._query_writer(bucket, start, end)
        ]
        cur = self._b._exec(
            f"DELETE FROM {bucket.table} WHERE k>=? AND k<?", (start, end)
        )
        buf = self._buf.setdefault(bucket.name, {})
        for k in doomed:
            buf[k] = None
        self._pending += 1
        return cur.rowcount

    def unsafe_create_bucket(self, bucket: Bucket) -> None:
        self._b._exec(
            f"CREATE TABLE IF NOT EXISTS {bucket.table} "
            f"(k BLOB PRIMARY KEY, v BLOB NOT NULL) WITHOUT ROWID"
        )

    def pending(self) -> int:
        return self._pending

    def commit(self) -> None:
        with self.lock:
            self._b._run_hooks(self)
            self._b._commit_locked()
            self._buf.clear()
            self._pending = 0


class ReadTx:
    """Read view; `overlay` (if any) patches uncommitted writes over a
    committed-state connection."""

    def __init__(self, backend: "Backend", use_writer: bool,
                 overlay: Optional[Dict[str, Dict[bytes, Optional[bytes]]]]
                 ) -> None:
        self._b = backend
        self._use_writer = use_writer
        self._overlay = overlay

    def _rows(self, bucket: Bucket, start: bytes,
              end: bytes) -> List[Tuple[bytes, bytes]]:
        if self._use_writer:
            return self._b._query_writer(bucket, start, end)
        return self._b._query_reader(bucket, start, end)

    def get(self, bucket: Bucket, key: bytes) -> Optional[bytes]:
        key = bytes(key)
        if self._overlay is not None:
            ov = self._overlay.get(bucket.name)
            if ov is not None and key in ov:
                return ov[key]
        rows = self._rows(bucket, key, key + b"\x00")
        return rows[0][1] if rows else None

    def range(self, bucket: Bucket, start: bytes, end: Optional[bytes],
              limit: int = 0) -> List[Tuple[bytes, bytes]]:
        """Sorted [start, end); end=None means the single key `start`;
        limit 0 = unlimited."""
        if end is None:
            v = self.get(bucket, start)
            return [(bytes(start), v)] if v is not None else []
        rows = dict(self._rows(bucket, start, end))
        if self._overlay is not None:
            ov = self._overlay.get(bucket.name)
            if ov:
                for k, v in ov.items():
                    if start <= k < end:
                        if v is None:
                            rows.pop(k, None)
                        else:
                            rows[k] = v
        out = sorted(rows.items())
        if limit > 0:
            out = out[:limit]
        return out

    def count(self, bucket: Bucket) -> int:
        return len(self.range(bucket, b"", _MAX_KEY))

    def for_each(self, bucket: Bucket,
                 fn: Callable[[bytes, bytes], bool]) -> None:
        for k, v in self.range(bucket, b"", _MAX_KEY):
            if not fn(k, v):
                return


class Backend:
    def __init__(self, path: str,
                 batch_interval: float = DEFAULT_BATCH_INTERVAL,
                 batch_limit: int = DEFAULT_BATCH_LIMIT) -> None:
        self.path = path
        self.batch_interval = batch_interval
        self.batch_limit = batch_limit
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._w = sqlite3.connect(
            path, isolation_level=None, check_same_thread=False
        )
        self._wlock = threading.RLock()
        self._w.execute("PRAGMA journal_mode=WAL")
        self._w.execute("PRAGMA synchronous=NORMAL")
        self._in_txn = False
        self.batch_tx = BatchTx(self)
        self._hooks: List[Callable[[BatchTx], None]] = []
        self.commits = 0
        self._stopped = threading.Event()
        with self.batch_tx.lock:
            for b in ALL_BUCKETS:
                self.batch_tx.unsafe_create_bucket(b)
            self._commit_locked()
        # Reader connection: WAL mode gives it the last-committed
        # snapshot without blocking the writer.
        self._r = sqlite3.connect(path, check_same_thread=False)
        self._rlock = threading.RLock()
        self._runner = threading.Thread(
            target=self._run, name=f"backend-{os.path.basename(path)}",
            daemon=True,
        )
        self._runner.start()

    # -- low-level ------------------------------------------------------------

    def _exec(self, sql: str, params: tuple = ()) -> sqlite3.Cursor:
        with self._wlock:
            if not self._in_txn:
                self._w.execute("BEGIN")
                self._in_txn = True
            return self._w.execute(sql, params)

    def _commit_locked(self) -> None:
        with self._wlock:
            if self._in_txn:
                t0 = time.monotonic()
                self._w.execute("COMMIT")
                dmet.backend_commit_duration.observe(time.monotonic() - t0)
                self._in_txn = False
                self.commits += 1

    def _query_writer(self, bucket: Bucket, start: bytes,
                      end: bytes) -> List[Tuple[bytes, bytes]]:
        with self._wlock:
            return self._w.execute(
                f"SELECT k, v FROM {bucket.table} WHERE k>=? AND k<? "
                f"ORDER BY k", (start, end),
            ).fetchall()

    def _query_reader(self, bucket: Bucket, start: bytes,
                      end: bytes) -> List[Tuple[bytes, bytes]]:
        with self._rlock:
            return self._r.execute(
                f"SELECT k, v FROM {bucket.table} WHERE k>=? AND k<? "
                f"ORDER BY k", (start, end),
            ).fetchall()

    def _run_hooks(self, tx: BatchTx) -> None:
        for h in self._hooks:
            h(tx)

    # -- public ---------------------------------------------------------------

    def read_tx(self) -> ReadTx:
        """Sees committed state + the open batch transaction."""
        return ReadTx(self, use_writer=True, overlay=None)

    def concurrent_read_tx(self) -> ReadTx:
        """Committed snapshot + buffer overlay frozen at creation; never
        contends with the writer connection."""
        with self.batch_tx.lock:
            snap = {b: dict(kv) for b, kv in self.batch_tx._buf.items()}
        return ReadTx(self, use_writer=False, overlay=snap)

    def add_hook(self, hook: Callable[[BatchTx], None]) -> None:
        self._hooks.append(hook)

    def force_commit(self) -> None:
        self.batch_tx.commit()

    def defrag(self) -> None:
        with self.batch_tx.lock:
            self.batch_tx.commit()
            with self._wlock:
                self._w.execute("PRAGMA wal_checkpoint(TRUNCATE)")
                self._w.execute("VACUUM")

    def size(self) -> int:
        """On-disk footprint incl. the not-yet-checkpointed WAL journal
        (bbolt's size is the whole mmap'd file; counting the sqlite -wal
        keeps quota checks honest before checkpoints)."""
        total = 0
        for p in (self.path, self.path + "-wal"):
            try:
                total += os.path.getsize(p)
            except OSError:
                pass
        return total

    def size_in_use(self) -> int:
        with self._wlock:
            pages = self._w.execute("PRAGMA page_count").fetchone()[0]
            free = self._w.execute("PRAGMA freelist_count").fetchone()[0]
            psize = self._w.execute("PRAGMA page_size").fetchone()[0]
        return (pages - free) * psize

    def snapshot_to(self, dest_path: str) -> None:
        """Consistent online copy (the reference streams the bbolt file;
        sqlite3's backup API gives the same guarantee)."""
        with self.batch_tx.lock:
            self.batch_tx.commit()
            with self._wlock:
                dst = sqlite3.connect(dest_path)
                try:
                    self._w.backup(dst)
                finally:
                    dst.close()

    def close(self) -> None:
        self._stopped.set()
        self._runner.join(timeout=5)
        with self.batch_tx.lock:
            # Through the hook-running commit: the consistent index must
            # land in the same final txn as the buffered applies.
            self.batch_tx.commit()
            with self._wlock:
                self._w.close()
            with self._rlock:
                self._r.close()

    # -- background commit loop ----------------------------------------------

    def _run(self) -> None:
        while not self._stopped.wait(self.batch_interval):
            with self.batch_tx.lock:
                if self.batch_tx.pending() > 0:
                    self.batch_tx.commit()


def open_backend(path: str, **kw) -> Backend:
    return Backend(path, **kw)
