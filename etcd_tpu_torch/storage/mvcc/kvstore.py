"""The MVCC store: revisioned KV over (backend, treeIndex).

Layout and lifecycle mirror the reference store
(ref: server/storage/mvcc/kvstore.go:59-419):

* every write txn bumps ``current_rev``; each change writes the key
  bucket at the 17-byte revision key with a marshaled KeyValue (delete
  writes a tombstone-marked revision key with just the key);
* the in-memory TreeIndex maps user keys → revision history and is
  rebuilt from the backend on restore (kvstore.go:323-419);
* reads resolve (key range, at_rev) → revisions via the index, then
  point-read the backend at those revision keys
  (kvstore_txn.go:65 rangeKeys);
* ``compact(rev)`` drops index history and deletes dead revision keys,
  recording scheduled/finished compact revisions in the meta bucket so
  an interrupted compaction resumes on restore (kvstore.go:279,
  kvstore_compaction.go);
* ``hash_kv(rev)`` hashes live revision keys for corruption checks
  (kvstore.go HashStorage).

Ports ``etcd_tpu/storage/mvcc/kvstore.py``.
"""

from __future__ import annotations

import hashlib
import struct
import threading
from typing import Callable, Dict, List, Optional, Tuple

from .. import backend as bk
from . import metrics as mmet
from .index import TreeIndex
from .key_index import RevisionNotFound
from .kv import Event, EventType, KeyValue, RangeOptions, RangeResult
from .revision import (
    Revision, bytes_to_rev, is_tombstone_key, rev_to_bytes, tombstone_key,
)

SCHEDULED_COMPACT_KEY = b"scheduledCompactRev"
FINISHED_COMPACT_KEY = b"finishedCompactRev"


class CompactedError(Exception):
    """Requested revision has been compacted (ref: ErrCompacted)."""


class FutureRevError(Exception):
    """Requested revision is in the future (ref: ErrFutureRev)."""


class KVStore:
    def __init__(self, backend: bk.Backend,
                 lessor: Optional[object] = None) -> None:
        self.b = backend
        self.lessor = lessor
        self.index = TreeIndex()
        self._lock = threading.RLock()
        self.current_rev = 1  # rev of the last completed write txn
        self.compact_rev = 0
        self._fifo_restore()

    # -- restore --------------------------------------------------------------

    def _fifo_restore(self) -> None:
        """Rebuild index + revision counters from the backend
        (ref: kvstore.go:323 restore)."""
        rt = self.b.read_tx()
        fin = rt.get(bk.META, FINISHED_COMPACT_KEY)
        if fin is not None:
            self.compact_rev = struct.unpack("<q", fin)[0]
        rows = rt.range(bk.KEY, b"", b"\xff" * 32)
        # Lease attachments reflect only each key's LATEST state: later
        # revisions override, tombstones clear (ref: kvstore.go restore
        # builds keyToLease the same way). Attaching per historical row
        # would resurrect stale attachments and delete live keys on
        # lease expiry.
        key_lease: Dict[bytes, int] = {}
        for rkey, rval in rows:
            rev = bytes_to_rev(rkey)
            self.current_rev = rev.main
            if is_tombstone_key(rkey):
                try:
                    self.index.tombstone(rval, rev)
                except RevisionNotFound:
                    pass  # creation compacted away; tombstone is stale
                key_lease.pop(rval, None)
                continue
            kv = KeyValue.unmarshal(rval)
            self.index.restore_key(
                kv.key, rev, Revision(kv.create_revision, 0), kv.version
            )
            key_lease[kv.key] = kv.lease
        if self.lessor is not None:
            from ...lease.lessor import LeaseNotFoundError

            for key, lease_id in key_lease.items():
                if not lease_id:
                    continue
                try:
                    self.lessor.attach(lease_id, key)
                except LeaseNotFoundError:
                    pass  # revoked after the final put; nothing to attach
        # A fully-compacted store can have ZERO revision rows; the
        # revision counter must still resume at the compaction point
        # (ref: kvstore.go restore: currentRev = max(currentRev,
        # compactMainRev)).
        self.current_rev = max(self.current_rev, self.compact_rev)
        sched = rt.get(bk.META, SCHEDULED_COMPACT_KEY)
        if sched is not None:
            srev = struct.unpack("<q", sched)[0]
            if srev > self.compact_rev:
                self.compact(srev)  # resume interrupted compaction
        mmet.keys_total.set(self.index.count_all(self.current_rev))

    # -- read path ------------------------------------------------------------

    def rev(self) -> int:
        with self._lock:
            return self.current_rev

    def first_rev(self) -> int:
        with self._lock:
            return self.compact_rev + 1

    def range(self, key: bytes, end: Optional[bytes],
              opts: Optional[RangeOptions] = None) -> RangeResult:
        opts = opts or RangeOptions()
        with self._lock:
            cur = self.current_rev
            at_rev = opts.rev if opts.rev > 0 else cur
            if at_rev < self.compact_rev:
                raise CompactedError()
            if at_rev > cur:
                raise FutureRevError()
            if opts.count_only:
                total = self.index.count_revisions(key, end, at_rev)
                return RangeResult(kvs=[], rev=cur, count=total)
            revs, total = self.index.revisions(key, end, at_rev, opts.limit)
            # Read rows while still holding the store lock so a
            # concurrent compact() cannot delete a resolved revision
            # between index lookup and backend read (the reference pins
            # a bolt read tx for the same reason, backend.go:249).
            rt = self.b.read_tx()
            kvs: List[KeyValue] = []
            for r in revs:
                rows = rt.range(bk.KEY, rev_to_bytes(r), None)
                if not rows:
                    raise RuntimeError(
                        f"revision {r} in index but missing from backend"
                    )
                kvs.append(KeyValue.unmarshal(rows[0][1]))
            return RangeResult(kvs=kvs, rev=cur, count=total)

    # -- write path -----------------------------------------------------------

    def write(self) -> "WriteTxn":
        return WriteTxn(self)

    def put(self, key: bytes, value: bytes, lease: int = 0) -> int:
        with self.write() as tx:
            tx.put(key, value, lease)
        return tx.rev  # read after __exit__ bumps it

    def delete_range(self, key: bytes,
                     end: Optional[bytes]) -> Tuple[int, int]:
        """(deleted_count, rev)."""
        with self.write() as tx:
            n = tx.delete_range(key, end)
        return n, tx.rev

    # -- compaction -----------------------------------------------------------

    def compact(self, at_rev: int) -> int:
        """Synchronous compaction (the reference schedules chunks; our
        backend scan is one pass). Returns the compacted revision."""
        with self._lock:
            if at_rev <= self.compact_rev:
                raise CompactedError()
            if at_rev > self.current_rev:
                raise FutureRevError()
            self.compact_rev = at_rev
            with self.b.batch_tx.lock:
                self.b.batch_tx.put(
                    bk.META, SCHEDULED_COMPACT_KEY, struct.pack("<q", at_rev)
                )
            keep = self.index.compact(at_rev)
            # Delete revision keys ≤ at_rev not in the keep set — still
            # under the store lock so readers never see the index and
            # backend disagree.
            end = rev_to_bytes(Revision(at_rev + 1, 0))
            rt = self.b.read_tx()
            with self.b.batch_tx.lock:
                for rkey, _ in rt.range(bk.KEY, b"", end):
                    base = rkey[:17]
                    rev = bytes_to_rev(base)
                    if rev.main > at_rev:
                        continue
                    if keep.get(rev) and not is_tombstone_key(rkey):
                        continue
                    self.b.batch_tx.delete(bk.KEY, rkey)
                self.b.batch_tx.put(
                    bk.META, FINISHED_COMPACT_KEY, struct.pack("<q", at_rev)
                )
        return at_rev

    # -- integrity ------------------------------------------------------------

    def hash_kv(self, rev: int = 0) -> Tuple[int, int, int]:
        """(hash, current_rev, compact_rev): crc-style digest over live
        revision keys ≤ rev (ref: kvstore.go HashByRev)."""
        with self._lock:
            cur = self.current_rev
            if rev == 0 or rev > cur:
                rev = cur
            if rev < self.compact_rev:
                raise CompactedError()
            keep = self.index.keep(rev)
        h = hashlib.sha256()
        rt = self.b.concurrent_read_tx()
        upper = rev_to_bytes(Revision(rev + 1, 0))
        for rkey, rval in rt.range(bk.KEY, b"", upper):
            kv_rev = bytes_to_rev(rkey[:17])
            if kv_rev.main <= self.compact_rev and kv_rev not in keep:
                continue
            h.update(rkey)
            h.update(rval)
        digest = int.from_bytes(h.digest()[:8], "big")
        return digest, cur, self.compact_rev


class WriteTxn:
    """One write transaction: all changes share main revision
    current_rev+1, sub revisions order them; commit bumps current_rev
    (ref: kvstore_txn.go:133 storeTxnWrite).

    Mutations apply eagerly to index+backend; an exception inside the
    ``with`` block rolls them back (saved KeyIndex copies are restored
    and written revision rows deleted), so an aborted txn leaves no
    trace and the next txn reuses the revision."""

    def __init__(self, store: KVStore,
                 on_end: Optional[Callable[["WriteTxn"], None]] = None
                 ) -> None:
        self.s = store
        self.changes: List[Event] = []
        self._on_end = on_end
        self._saved_ki: Dict[bytes, object] = {}  # key -> KeyIndex copy|None
        self._written_rows: List[bytes] = []
        self._keys_delta = 0  # live-key gauge delta, applied on commit

    def __enter__(self) -> "WriteTxn":
        self.s._lock.acquire()
        self.s.b.batch_tx.lock.acquire()
        self.rev = self.s.current_rev  # updated on first change
        return self

    def __exit__(self, exc_type, *rest) -> None:
        committed = exc_type is None and bool(self.changes)
        try:
            if committed:
                self.s.current_rev += 1
                self.rev = self.s.current_rev
                if self._keys_delta > 0:
                    mmet.keys_total.inc(self._keys_delta)
                elif self._keys_delta < 0:
                    mmet.keys_total.dec(-self._keys_delta)
                # Notify while both locks are held so watchers observe
                # revisions in commit order (the reference notifies in
                # txn End under the store mutex).
                if self._on_end is not None:
                    self._on_end(self)
            elif exc_type is not None and (
                    self.changes or self._written_rows):
                self._rollback()
        finally:
            self.s.b.batch_tx.lock.release()
            self.s._lock.release()

    def _rollback(self) -> None:
        for rkey in self._written_rows:
            self.s.b.batch_tx.delete(bk.KEY, rkey)
        for key, saved in self._saved_ki.items():
            self.s.index.restore_saved(key, saved)
        self.changes.clear()

    def _save_ki(self, key: bytes) -> None:
        if key not in self._saved_ki:
            self._saved_ki[key] = self.s.index.snapshot_ki(key)

    def _next_rev(self) -> Revision:
        return Revision(self.s.current_rev + 1, len(self.changes))

    def put(self, key: bytes, value: bytes, lease: int = 0) -> None:
        rev = self._next_rev()
        created = rev.main
        version = 1
        prev_lease = 0
        try:
            mod, c, ver = self.s.index.get(key, rev.main)
            created = c.main
            version = ver + 1
            prev = self._read_at(mod)
            prev_lease = prev.lease if prev else 0
        except RevisionNotFound:
            pass
        kv = KeyValue(
            key=key, create_revision=created, mod_revision=rev.main,
            version=version, value=value, lease=lease,
        )
        self._save_ki(key)
        rkey = rev_to_bytes(rev)
        self.s.b.batch_tx.put(bk.KEY, rkey, kv.marshal())
        self._written_rows.append(rkey)
        self.s.index.put(key, rev)
        if version == 1:
            self._keys_delta += 1  # new live key (ref: kvstore_txn.go put)
        self.changes.append(Event(type=EventType.PUT, kv=kv))
        les = self.s.lessor
        if les is not None:
            if prev_lease:
                les.detach(prev_lease, key)
            if lease:
                les.attach(lease, key)

    def delete_range(self, key: bytes, end: Optional[bytes]) -> int:
        # Resolve at current_rev+1 so deletes see this txn's own puts.
        revs, _ = self.s.index.revisions(key, end, self.s.current_rev + 1)
        if not revs:
            return 0
        keys = []
        rt = self.s.b.read_tx()
        for r in revs:
            rows = rt.range(bk.KEY, rev_to_bytes(r), None)
            keys.append(KeyValue.unmarshal(rows[0][1]))
        for prev_kv in keys:
            rev = self._next_rev()
            rkey = tombstone_key(rev_to_bytes(rev))
            # tombstone rows store just the user key (enough to rebuild
            # the index on restore)
            self._save_ki(prev_kv.key)
            self.s.b.batch_tx.put(bk.KEY, rkey, prev_kv.key)
            self._written_rows.append(rkey)
            self.s.index.tombstone(prev_kv.key, rev)
            self._keys_delta -= 1
            self.changes.append(Event(
                type=EventType.DELETE,
                kv=KeyValue(key=prev_kv.key, mod_revision=rev.main),
                prev_kv=prev_kv,
            ))
            if self.s.lessor is not None and prev_kv.lease:
                self.s.lessor.detach(prev_kv.lease, prev_kv.key)
        return len(keys)

    def range(self, key: bytes, end: Optional[bytes],
              opts: Optional[RangeOptions] = None) -> RangeResult:
        """Read inside the write txn (sees txn's own writes since the
        index/backend are updated eagerly)."""
        opts = opts or RangeOptions()
        at_rev = opts.rev if opts.rev > 0 else self.s.current_rev + (
            1 if self.changes else 0
        )
        # Same revision bounds as the store-level read path (ref:
        # kvstore_txn.go rangeKeys checks both on every txn read).
        if opts.rev > 0:
            if at_rev < self.s.compact_rev:
                raise CompactedError()
            if at_rev > self.s.current_rev + (1 if self.changes else 0):
                raise FutureRevError()
        revs, total = self.s.index.revisions(key, end, at_rev, opts.limit)
        if opts.count_only:
            return RangeResult(kvs=[], rev=self.s.current_rev, count=total)
        rt = self.s.b.read_tx()
        kvs = []
        for r in revs:
            rows = rt.range(bk.KEY, rev_to_bytes(r), None)
            kvs.append(KeyValue.unmarshal(rows[0][1]))
        return RangeResult(kvs=kvs, rev=self.s.current_rev, count=total)

    def _read_at(self, rev: Revision) -> Optional[KeyValue]:
        rows = self.s.b.read_tx().range(bk.KEY, rev_to_bytes(rev), None)
        return KeyValue.unmarshal(rows[0][1]) if rows else None
