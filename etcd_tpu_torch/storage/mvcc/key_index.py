"""Per-key revision history: generations separated by tombstones.

A keyIndex tracks every revision that ever touched one key. A
*generation* is one create→…→delete lifespan; a tombstone ends a
generation and opens a fresh empty one. ``get(at_rev)`` walks the
newest generation not past at_rev; ``compact`` drops revisions ≤ the
compaction point while preserving the one revision still visible at it
(ref: server/storage/mvcc/key_index.go:70-137,204 — the behaviour
matrix in its doc comment is the spec this reimplements).

Ports ``etcd_tpu/storage/mvcc/key_index.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .revision import Revision


class RevisionNotFound(Exception):
    pass


@dataclass
class Generation:
    version: int = 0  # number of revisions in this generation
    created: Revision = field(default_factory=Revision)
    revs: List[Revision] = field(default_factory=list)

    def is_empty(self) -> bool:
        return not self.revs

    def walk(self, fn) -> int:
        """Walk revs newest→oldest; return index of first rev where fn
        is False, or -1."""
        for i in range(len(self.revs) - 1, -1, -1):
            if not fn(self.revs[i]):
                return i
        return -1


@dataclass
class KeyIndex:
    key: bytes
    modified: Revision = field(default_factory=Revision)
    generations: List[Generation] = field(default_factory=list)

    def put(self, main: int, sub: int) -> None:
        rev = Revision(main, sub)
        if rev <= self.modified:
            raise ValueError(
                f"'put' with unexpected smaller revision {rev} <= {self.modified}"
            )
        if not self.generations:
            self.generations.append(Generation())
        g = self.generations[-1]
        if g.is_empty():
            g.created = rev
        g.revs.append(rev)
        g.version += 1
        self.modified = rev

    def restore(self, created: Revision, modified: Revision,
                version: int) -> None:
        """Seed a freshly-rebuilt keyIndex from a stored KeyValue row —
        compaction may have erased earlier revisions, so created/version
        come from the row, not from counting (ref: key_index.go restore)."""
        if self.generations:
            raise ValueError("restore on non-empty keyIndex")
        self.modified = modified
        self.generations.append(
            Generation(version=version, created=created, revs=[modified])
        )

    def tombstone(self, main: int, sub: int) -> None:
        if self.is_empty() or self.generations[-1].is_empty():
            raise RevisionNotFound()
        self.put(main, sub)
        self.generations.append(Generation())

    def get(self, at_rev: int) -> Tuple[Revision, Revision, int]:
        """(modified, created, version) of the key visible at at_rev.
        Raises RevisionNotFound if none (never created yet, deleted
        before at_rev, or compacted away)."""
        g = self._find_generation(at_rev)
        if g is None:
            raise RevisionNotFound()
        n = g.walk(lambda rev: rev.main > at_rev)
        if n != -1:
            return g.revs[n], g.created, g.version - (len(g.revs) - n - 1)
        raise RevisionNotFound()

    def since(self, rev: int) -> List[Revision]:
        """All revisions with main >= rev (ascending), at most one per
        main (the last sub wins) — feeds watcher replay
        (ref: key_index.go since)."""
        if self.is_empty():
            return []
        out: List[Revision] = []
        for g in self.generations:
            for r in g.revs:
                if r.main < rev:
                    continue
                if out and out[-1].main == r.main:
                    out[-1] = r
                else:
                    out.append(r)
        return out

    def is_empty(self) -> bool:
        return not self.generations or (
            len(self.generations) == 1 and self.generations[0].is_empty()
        )

    def _find_generation(self, rev: int) -> Optional[Generation]:
        """Newest generation containing rev (created ≤ rev and not ended
        before it)."""
        last = len(self.generations) - 1
        cg = last
        while cg >= 0:
            g = self.generations[cg]
            if g.is_empty():
                cg -= 1
                continue
            if cg != last:
                # tombstone of g is its final rev; if rev is at/after the
                # tombstone, the key was deleted at rev.
                if rev >= g.revs[-1].main:
                    return None
            if g.revs[0].main <= rev:
                return g
            cg -= 1
        return None

    def compact(self, at_rev: int,
                available: Dict[Revision, bool]) -> None:
        """Remove revisions with main <= at_rev except the newest one
        still visible at at_rev. Finished generations whose tombstone is
        ≤ at_rev disappear entirely (a compacted delete leaves nothing).
        `available` collects revisions that must stay in the backend.
        After compaction `is_empty()` may become True — the caller then
        drops the whole KeyIndex (ref: key_index.go compact doc table).
        """
        gen_idx, rev_idx = self._doompoint(at_rev, available)
        g = self.generations[gen_idx]
        if rev_idx != -1:
            g.revs = g.revs[rev_idx:]
        self.generations = self.generations[gen_idx:]
        if not self.generations:
            self.generations.append(Generation())

    def _doompoint(self, at_rev: int,
                   available: Dict[Revision, bool]) -> Tuple[int, int]:
        """(generation idx, rev idx) where compaction cuts: generations
        before gen_idx are dropped; within it, revs before rev_idx are
        dropped (rev_idx=-1 keeps it whole). Marks the surviving
        revision, if any, in `available`."""
        last = len(self.generations) - 1
        for gi, g in enumerate(self.generations):
            if g.is_empty():
                if gi == last:
                    return gi, -1
                continue
            # A finished generation ends in its tombstone; if that is at
            # or before at_rev the whole lifespan is invisible at at_rev.
            if gi != last and g.revs[-1].main <= at_rev:
                continue
            keep = -1
            for i, r in enumerate(g.revs):
                if r.main <= at_rev:
                    keep = i
                else:
                    break
            if keep == -1:
                return gi, -1  # generation starts after at_rev
            available[g.revs[keep]] = True
            return gi, keep
        return last, -1

    def __repr__(self) -> str:
        return (f"KeyIndex(key={self.key!r}, modified={self.modified}, "
                f"generations={self.generations})")
