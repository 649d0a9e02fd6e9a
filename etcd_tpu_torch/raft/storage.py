"""Stable log storage interface and in-memory implementation
(ref: raft/storage.go).

Ports ``etcd_tpu/raft/storage.py`` whole. On the batched path only a
bounded tail window of each group's log lives on the card (the ``[N, W]``
term ring); raftexample's WAL replay fills a ``MemoryStorage`` beside it,
so the contract stays the reference's.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Protocol, Tuple

from .errors import CompactedError, SnapOutOfDateError, UnavailableError
from .types import ConfState, Entry, HardState, Snapshot, SnapshotMetadata


def limit_size(ents: List[Entry], max_size: int) -> List[Entry]:
    """Prefix of ents with aggregate proto size ≤ max_size, but always at
    least one entry (ref: raft/util.go:212 limitSize)."""
    if not ents:
        return ents
    size = ents[0].size()
    limit = 1
    while limit < len(ents):
        size += ents[limit].size()
        if size > max_size:
            break
        limit += 1
    return ents[:limit]


class Storage(Protocol):
    """ref: raft/storage.go:46-72."""

    def initial_state(self) -> Tuple[HardState, ConfState]: ...

    def entries(self, lo: int, hi: int, max_size: int) -> List[Entry]: ...

    def term(self, i: int) -> int: ...

    def last_index(self) -> int: ...

    def first_index(self) -> int: ...

    def snapshot(self) -> Snapshot: ...


class MemoryStorage:
    """In-memory Storage with a dummy entry at offset 0
    (ref: raft/storage.go:76-273)."""

    def __init__(self):
        self._mu = threading.Lock()
        self.hard_state = HardState()
        self._snapshot = Snapshot()
        # ents[i] has raft log position i + snapshot.metadata.index
        self.ents: List[Entry] = [Entry()]

    def initial_state(self) -> Tuple[HardState, ConfState]:
        return self.hard_state, self._snapshot.metadata.conf_state

    def set_hard_state(self, st: HardState) -> None:
        with self._mu:
            self.hard_state = st

    def entries(self, lo: int, hi: int, max_size: int) -> List[Entry]:
        with self._mu:
            offset = self.ents[0].index
            if lo <= offset:
                raise CompactedError()
            if hi > self._last_index() + 1:
                raise RuntimeError(
                    f"entries' hi({hi}) is out of bound lastindex({self._last_index()})"
                )
            if len(self.ents) == 1:  # only the dummy entry
                raise UnavailableError()
            return limit_size(self.ents[lo - offset : hi - offset], max_size)

    def term(self, i: int) -> int:
        with self._mu:
            offset = self.ents[0].index
            if i < offset:
                raise CompactedError()
            if i - offset >= len(self.ents):
                raise UnavailableError()
            return self.ents[i - offset].term

    def last_index(self) -> int:
        with self._mu:
            return self._last_index()

    def _last_index(self) -> int:
        return self.ents[0].index + len(self.ents) - 1

    def first_index(self) -> int:
        with self._mu:
            return self._first_index()

    def _first_index(self) -> int:
        return self.ents[0].index + 1

    def snapshot(self) -> Snapshot:
        with self._mu:
            return self._copy_snapshot()

    def _copy_snapshot(self) -> Snapshot:
        # Return a value copy, like Go's by-value Snapshot returns: callers
        # (e.g. a queued MsgSnap) must not observe later create_snapshot
        # mutations of the internal object.
        m = self._snapshot.metadata
        return Snapshot(
            data=self._snapshot.data,
            metadata=SnapshotMetadata(
                conf_state=m.conf_state.clone(), index=m.index, term=m.term
            ),
        )

    def apply_snapshot(self, snap: Snapshot) -> None:
        """Replace contents with the snapshot (ref: storage.go:172-187)."""
        with self._mu:
            if self._snapshot.metadata.index >= snap.metadata.index:
                raise SnapOutOfDateError()
            self._snapshot = snap
            self.ents = [Entry(term=snap.metadata.term, index=snap.metadata.index)]

    def create_snapshot(
        self, i: int, cs: Optional[ConfState], data: bytes
    ) -> Snapshot:
        """ref: storage.go:193-214."""
        with self._mu:
            if i <= self._snapshot.metadata.index:
                raise SnapOutOfDateError()
            offset = self.ents[0].index
            if i > self._last_index():
                raise RuntimeError(
                    f"snapshot {i} is out of bound lastindex({self._last_index()})"
                )
            self._snapshot.metadata.index = i
            self._snapshot.metadata.term = self.ents[i - offset].term
            if cs is not None:
                self._snapshot.metadata.conf_state = cs
            self._snapshot.data = data
            return self._copy_snapshot()

    def compact(self, compact_index: int) -> None:
        """Drop entries before compact_index (ref: storage.go:218-237)."""
        with self._mu:
            offset = self.ents[0].index
            if compact_index <= offset:
                raise CompactedError()
            if compact_index > self._last_index():
                raise RuntimeError(
                    f"compact {compact_index} is out of bound lastindex({self._last_index()})"
                )
            i = compact_index - offset
            ents = [Entry(index=self.ents[i].index, term=self.ents[i].term)]
            ents.extend(self.ents[i + 1 :])
            self.ents = ents

    def append(self, entries: List[Entry]) -> None:
        """ref: storage.go:241-273."""
        if not entries:
            return
        with self._mu:
            first = self._first_index()
            last = entries[0].index + len(entries) - 1
            if last < first:
                return
            if first > entries[0].index:
                entries = entries[first - entries[0].index :]
            offset = entries[0].index - self.ents[0].index
            if len(self.ents) > offset:
                self.ents = self.ents[:offset] + list(entries)
            elif len(self.ents) == offset:
                self.ents = self.ents + list(entries)
            else:
                raise RuntimeError(
                    f"missing log entry [last: {self._last_index()}, "
                    f"append at: {entries[0].index}]"
                )
