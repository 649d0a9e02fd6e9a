"""In-memory key → KeyIndex ordered map (analog of
server/storage/mvcc/index.go treeIndex over google/btree; here a
SortedDict, the same O(log n) ordered-map contract).

Ports ``etcd_tpu/storage/mvcc/index.py``."""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

try:
    from sortedcontainers import SortedDict
except ImportError:  # gated dep: images without it use the fallback
    from ...pkg.sorteddict import SortedDict  # type: ignore[assignment]

from .key_index import KeyIndex, RevisionNotFound
from .revision import Revision


class TreeIndex:
    def __init__(self) -> None:
        self._tree: SortedDict = SortedDict()
        self._lock = threading.RLock()

    def put(self, key: bytes, rev: Revision) -> None:
        with self._lock:
            ki = self._tree.get(key)
            if ki is None:
                ki = KeyIndex(key=key)
                self._tree[key] = ki
            ki.put(rev.main, rev.sub)

    def restore_key(self, key: bytes, rev: Revision, created: Revision,
                    version: int) -> None:
        """Rebuild path: first sighting of a key seeds a keyIndex with
        the stored created/version; later sightings append normally."""
        with self._lock:
            ki = self._tree.get(key)
            if ki is None:
                ki = KeyIndex(key=key)
                ki.restore(created, rev, version)
                self._tree[key] = ki
            else:
                ki.put(rev.main, rev.sub)

    def tombstone(self, key: bytes, rev: Revision) -> None:
        with self._lock:
            ki = self._tree.get(key)
            if ki is None:
                raise RevisionNotFound()
            ki.tombstone(rev.main, rev.sub)

    def get(self, key: bytes, at_rev: int
            ) -> Tuple[Revision, Revision, int]:
        """(mod, created, version); raises RevisionNotFound."""
        with self._lock:
            ki = self._tree.get(key)
            if ki is None:
                raise RevisionNotFound()
            return ki.get(at_rev)

    def revisions(self, start: bytes, end: Optional[bytes], at_rev: int,
                  limit: int = 0) -> Tuple[List[Revision], int]:
        """Mod-revisions of keys in [start, end) visible at at_rev,
        plus the total count (limit applies to the list only).
        end=None → the single key `start`; end=b"" → open end, every
        key ≥ start (the \\x00 range sentinel resolves to this;
        ref: index.go Revisions)."""
        with self._lock:
            if end is None:
                try:
                    rev, _, _ = self.get(start, at_rev)
                    return [rev], 1
                except RevisionNotFound:
                    return [], 0
            revs: List[Revision] = []
            total = 0
            for key in self._tree.irange(start, end if end else None,
                                         inclusive=(True, False)):
                ki: KeyIndex = self._tree[key]
                try:
                    rev, _, _ = ki.get(at_rev)
                except RevisionNotFound:
                    continue
                total += 1
                if limit <= 0 or len(revs) < limit:
                    revs.append(rev)
            return revs, total

    def count_revisions(self, start: bytes, end: Optional[bytes],
                        at_rev: int) -> int:
        return self.revisions(start, end, at_rev)[1]

    def count_all(self, at_rev: int) -> int:
        """Live keys at at_rev over the WHOLE key space (no end bound —
        arbitrary bytes are legal keys)."""
        with self._lock:
            total = 0
            for ki in self._tree.values():
                try:
                    ki.get(at_rev)
                    total += 1
                except RevisionNotFound:
                    continue
            return total

    def range_since(self, start: bytes, end: Optional[bytes],
                    rev: int) -> List[Revision]:
        """All revisions ≥ rev touching keys in the range, ascending by
        revision — the watcher-replay scan (ref: index.go RangeSince)."""
        with self._lock:
            keys = (
                [start] if end is None
                else list(self._tree.irange(start, end if end else None,
                                            inclusive=(True, False)))
            )
            revs: List[Revision] = []
            for key in keys:
                ki = self._tree.get(key)
                if ki is None:
                    continue
                revs.extend(ki.since(rev))
            revs.sort()
            return revs

    def compact(self, at_rev: int) -> Dict[Revision, bool]:
        """Compact every keyIndex; returns the revisions that remain
        live in the backend (ref: index.go Compact)."""
        available: Dict[Revision, bool] = {}
        with self._lock:
            doomed: List[bytes] = []
            for key, ki in self._tree.items():
                ki.compact(at_rev, available)
                if ki.is_empty():
                    doomed.append(key)
            for key in doomed:
                del self._tree[key]
        return available

    def keep(self, at_rev: int) -> Dict[Revision, bool]:
        """The revisions a compaction at at_rev would keep, without
        mutating (ref: index.go Keep — used for HashKV)."""
        available: Dict[Revision, bool] = {}
        with self._lock:
            for _key, ki in self._tree.items():
                probe: Dict[Revision, bool] = {}
                ki._doompoint(at_rev, probe)
                available.update(probe)
        return available

    # -- txn rollback support -------------------------------------------------

    def snapshot_ki(self, key: bytes):
        """Deep copy of a keyIndex (or None) for write-txn rollback."""
        import copy

        with self._lock:
            ki = self._tree.get(key)
            return copy.deepcopy(ki) if ki is not None else None

    def restore_saved(self, key: bytes, saved) -> None:
        with self._lock:
            if saved is None:
                self._tree.pop(key, None)
            else:
                self._tree[key] = saved

    def __len__(self) -> int:
        with self._lock:
            return len(self._tree)
