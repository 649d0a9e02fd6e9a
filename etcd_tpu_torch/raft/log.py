"""The raft log: stable Storage + unstable tail + commit/apply cursors
(ref: raft/log.go, raft/log_unstable.go).

Ports ``etcd_tpu/raft/log.py`` whole. In the batched round this structure
is an ``[N, W]`` term ring plus per-instance watermarks; the versions here
are the scalar core's.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .errors import CompactedError, UnavailableError
from .logger import Logger, get_logger
from .storage import Storage, limit_size
from .types import Entry, Snapshot

NO_LIMIT = (1 << 64) - 1


class Unstable:
    """Entries/snapshot not yet persisted (ref: raft/log_unstable.go:23-31).

    entries[i] has raft log position i + offset.
    """

    def __init__(self, logger: Logger):
        self.snapshot: Optional[Snapshot] = None
        self.entries: List[Entry] = []
        self.offset = 0
        self.logger = logger

    def maybe_first_index(self) -> Optional[int]:
        if self.snapshot is not None:
            return self.snapshot.metadata.index + 1
        return None

    def maybe_last_index(self) -> Optional[int]:
        if self.entries:
            return self.offset + len(self.entries) - 1
        if self.snapshot is not None:
            return self.snapshot.metadata.index
        return None

    def maybe_term(self, i: int) -> Optional[int]:
        if i < self.offset:
            if self.snapshot is not None and self.snapshot.metadata.index == i:
                return self.snapshot.metadata.term
            return None
        last = self.maybe_last_index()
        if last is None or i > last:
            return None
        return self.entries[i - self.offset].term

    def stable_to(self, i: int, t: int) -> None:
        gt = self.maybe_term(i)
        if gt is None:
            return
        # An index below offset was stabilized by the snapshot; only drop
        # unstable entries when the term matches an unstable entry.
        if gt == t and i >= self.offset:
            self.entries = self.entries[i + 1 - self.offset :]
            self.offset = i + 1

    def stable_snap_to(self, i: int) -> None:
        if self.snapshot is not None and self.snapshot.metadata.index == i:
            self.snapshot = None

    def restore(self, s: Snapshot) -> None:
        self.offset = s.metadata.index + 1
        self.entries = []
        self.snapshot = s

    def truncate_and_append(self, ents: List[Entry]) -> None:
        """ref: log_unstable.go:121-141."""
        after = ents[0].index
        if after == self.offset + len(self.entries):
            self.entries = self.entries + list(ents)
        elif after <= self.offset:
            self.logger.infof("replace the unstable entries from index %d", after)
            self.offset = after
            self.entries = list(ents)
        else:
            self.logger.infof("truncate the unstable entries before index %d", after)
            self.entries = self.slice(self.offset, after) + list(ents)

    def slice(self, lo: int, hi: int) -> List[Entry]:
        self._must_check_out_of_bounds(lo, hi)
        return self.entries[lo - self.offset : hi - self.offset]

    def _must_check_out_of_bounds(self, lo: int, hi: int) -> None:
        if lo > hi:
            self.logger.panicf("invalid unstable.slice %d > %d", lo, hi)
        upper = self.offset + len(self.entries)
        if lo < self.offset or hi > upper:
            self.logger.panicf(
                "unstable.slice[%d,%d) out of bound [%d,%d]", lo, hi, self.offset, upper
            )


class RaftLog:
    """ref: raft/log.go:24-45."""

    def __init__(self, storage: Storage, logger: Optional[Logger] = None,
                 max_next_ents_size: int = NO_LIMIT):
        if storage is None:
            raise ValueError("storage must not be nil")
        self.storage = storage
        self.logger = logger if logger is not None else get_logger()
        self.max_next_ents_size = max_next_ents_size
        self.unstable = Unstable(self.logger)
        self.unstable.offset = storage.last_index() + 1
        first_index = storage.first_index()
        # committed/applied start at the point of the last compaction.
        self.committed = first_index - 1
        self.applied = first_index - 1

    def __str__(self) -> str:
        return (
            f"committed={self.committed}, applied={self.applied}, "
            f"unstable.offset={self.unstable.offset}, "
            f"len(unstable.Entries)={len(self.unstable.entries)}"
        )

    def maybe_append(
        self, index: int, log_term: int, committed: int, ents: List[Entry]
    ) -> Tuple[int, bool]:
        """Append if (index, log_term) matches; returns (last new index, ok)
        (ref: log.go:88-107)."""
        if not self.match_term(index, log_term):
            return 0, False
        lastnewi = index + len(ents)
        ci = self.find_conflict(ents)
        if ci == 0:
            pass
        elif ci <= self.committed:
            self.logger.panicf(
                "entry %d conflict with committed entry [committed(%d)]",
                ci, self.committed,
            )
        else:
            offset = index + 1
            if ci - offset > len(ents):
                self.logger.panicf("index, %d, is out of range [%d]", ci - offset, len(ents))
            self.append(ents[ci - offset :])
        self.commit_to(min(committed, lastnewi))
        return lastnewi, True

    def append(self, ents: List[Entry]) -> int:
        if not ents:
            return self.last_index()
        after = ents[0].index - 1
        if after < self.committed:
            self.logger.panicf("after(%d) is out of range [committed(%d)]", after, self.committed)
        self.unstable.truncate_and_append(ents)
        return self.last_index()

    def find_conflict(self, ents: List[Entry]) -> int:
        """First index where the given entries diverge (ref: log.go:130-141)."""
        for ne in ents:
            if not self.match_term(ne.index, ne.term):
                if ne.index <= self.last_index():
                    self.logger.infof(
                        "found conflict at index %d [existing term: %d, conflicting term: %d]",
                        ne.index,
                        self.zero_term_on_err_compacted(ne.index),
                        ne.term,
                    )
                return ne.index
        return 0

    def find_conflict_by_term(self, index: int, term: int) -> int:
        """Largest index ≤ `index` with term ≤ `term` (ref: log.go:150-171)."""
        li = self.last_index()
        if index > li:
            self.logger.warningf(
                "index(%d) is out of range [0, lastIndex(%d)] in findConflictByTerm",
                index, li,
            )
            return index
        while True:
            try:
                log_term = self.term(index)
            except (CompactedError, UnavailableError):
                break
            if log_term <= term:
                break
            index -= 1
        return index

    def unstable_entries(self) -> List[Entry]:
        return self.unstable.entries

    def next_ents(self) -> List[Entry]:
        """Committed-but-unapplied entries (ref: log.go:183-193)."""
        off = max(self.applied + 1, self.first_index())
        if self.committed + 1 > off:
            try:
                return self.slice(off, self.committed + 1, self.max_next_ents_size)
            except (CompactedError, UnavailableError) as e:
                self.logger.panicf("unexpected error when getting unapplied entries (%s)", e)
        return []

    def has_next_ents(self) -> bool:
        off = max(self.applied + 1, self.first_index())
        return self.committed + 1 > off

    def has_pending_snapshot(self) -> bool:
        s = self.unstable.snapshot
        return s is not None and s.metadata.index != 0

    def snapshot(self) -> Snapshot:
        if self.unstable.snapshot is not None:
            return self.unstable.snapshot
        return self.storage.snapshot()

    def first_index(self) -> int:
        i = self.unstable.maybe_first_index()
        if i is not None:
            return i
        return self.storage.first_index()

    def last_index(self) -> int:
        i = self.unstable.maybe_last_index()
        if i is not None:
            return i
        return self.storage.last_index()

    def commit_to(self, tocommit: int) -> None:
        if self.committed < tocommit:
            if self.last_index() < tocommit:
                self.logger.panicf(
                    "tocommit(%d) is out of range [lastIndex(%d)]. "
                    "Was the raft log corrupted, truncated, or lost?",
                    tocommit, self.last_index(),
                )
            self.committed = tocommit

    def applied_to(self, i: int) -> None:
        if i == 0:
            return
        if self.committed < i or i < self.applied:
            self.logger.panicf(
                "applied(%d) is out of range [prevApplied(%d), committed(%d)]",
                i, self.applied, self.committed,
            )
        self.applied = i

    def stable_to(self, i: int, t: int) -> None:
        self.unstable.stable_to(i, t)

    def stable_snap_to(self, i: int) -> None:
        self.unstable.stable_snap_to(i)

    def last_term(self) -> int:
        try:
            return self.term(self.last_index())
        except (CompactedError, UnavailableError) as e:
            self.logger.panicf("unexpected error when getting the last term (%s)", e)

    def term(self, i: int) -> int:
        """Term of entry i; 0 if outside [dummy index, last index]
        (ref: log.go:268-288). Raises CompactedError/UnavailableError only
        when the storage does."""
        dummy_index = self.first_index() - 1
        if i < dummy_index or i > self.last_index():
            return 0
        t = self.unstable.maybe_term(i)
        if t is not None:
            return t
        return self.storage.term(i)

    def zero_term_on_err_compacted(self, i: int) -> int:
        try:
            return self.term(i)
        except CompactedError:
            return 0

    def entries(self, i: int, max_size: int) -> List[Entry]:
        if i > self.last_index():
            return []
        return self.slice(i, self.last_index() + 1, max_size)

    def all_entries(self) -> List[Entry]:
        try:
            return self.entries(self.first_index(), NO_LIMIT)
        except CompactedError:  # racing compaction; retry
            return self.all_entries()

    def is_up_to_date(self, lasti: int, term: int) -> bool:
        """ref: log.go:316-318."""
        return term > self.last_term() or (
            term == self.last_term() and lasti >= self.last_index()
        )

    def match_term(self, i: int, term: int) -> bool:
        try:
            return self.term(i) == term
        except (CompactedError, UnavailableError):
            return False

    def maybe_commit(self, max_index: int, term: int) -> bool:
        if max_index > self.committed and self.zero_term_on_err_compacted(max_index) == term:
            self.commit_to(max_index)
            return True
        return False

    def restore(self, s: Snapshot) -> None:
        self.logger.infof(
            "log [%s] starts to restore snapshot [index: %d, term: %d]",
            self, s.metadata.index, s.metadata.term,
        )
        self.committed = s.metadata.index
        self.unstable.restore(s)

    def slice(self, lo: int, hi: int, max_size: int) -> List[Entry]:
        """Entries [lo, hi) subject to the size budget (ref: log.go:343-381)."""
        self._must_check_out_of_bounds(lo, hi)
        if lo == hi:
            return []
        ents: List[Entry] = []
        if lo < self.unstable.offset:
            try:
                stored = self.storage.entries(lo, min(hi, self.unstable.offset), max_size)
            except UnavailableError:
                self.logger.panicf(
                    "entries[%d:%d) is unavailable from storage",
                    lo, min(hi, self.unstable.offset),
                )
            if len(stored) < min(hi, self.unstable.offset) - lo:
                return stored  # hit the size limit
            ents = stored
        if hi > self.unstable.offset:
            unstable = self.unstable.slice(max(lo, self.unstable.offset), hi)
            ents = ents + unstable if ents else unstable
        return limit_size(ents, max_size)

    def _must_check_out_of_bounds(self, lo: int, hi: int) -> None:
        if lo > hi:
            self.logger.panicf("invalid slice %d > %d", lo, hi)
        fi = self.first_index()
        if lo < fi:
            raise CompactedError()
        length = self.last_index() + 1 - fi
        if hi > fi + length:
            self.logger.panicf(
                "slice[%d,%d) out of bound [%d,%d]", lo, hi, fi, self.last_index()
            )
