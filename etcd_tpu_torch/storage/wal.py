"""Write-ahead log for raft state: the durable half of the Ready contract.

Ports ``etcd_tpu/storage/wal.py`` whole. Facade over the native
segmented record log (``native/walog.py``; C++ core in
``native/src/walog.cc``). Maps raft records onto log record
types and enforces the reference WAL's contract
(ref: server/storage/wal/wal.go:73-99):

* ``create(dir, metadata)`` — new WAL, first record is metadata
  (wal.go:101 Create);
* ``WAL.read_all(snap)`` — replay: returns (metadata, HardState,
  entries after snap.index), dropping entry versions superseded by
  later appends at the same index (wal.go:437-558 ReadAll);
* ``save(hs, entries, must_sync)`` — append entries + HardState, fsync
  when the raft MustSync rule says so (wal.go:920-953 Save), cut to a
  new segment past the size limit (wal.go:710 cut);
* ``save_snapshot(idx, term)`` — record a snapshot marker so replay can
  start there (wal.go:955 SaveSnapshot);
* ``release_to(index)`` — drop segments wholly before index
  (wal.go ReleaseLockTo).

Record payloads use a compact fixed struct encoding — our own wire
format, not the reference's protobufs. It is etcd_tpu's byte for byte,
so each package replays the other's WAL directories.
"""

from __future__ import annotations

import os
import struct
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..native import walog as nwalog
from ..raft.types import Entry, EntryType, HardState, is_empty_hard_state
from . import metrics as dmet

# Record types (native type 0 is reserved for the CRC chain seed).
REC_METADATA = 1
REC_ENTRY = 2
REC_STATE = 3
REC_SNAPSHOT = 4

_STATE = struct.Struct("<QQQ")  # term, vote, commit
_ENTRY_HDR = struct.Struct("<QQI")  # term, index, type
_SNAP = struct.Struct("<QQ")  # index, term

SEGMENT_BYTES = 64 << 20  # ref: wal.go SegmentSizeBytes (64 MiB)


@dataclass
class WalSnapshot:
    """Snapshot marker in the WAL (ref: walpb.Snapshot)."""

    index: int = 0
    term: int = 0


class WALError(Exception):
    pass


class WAL:
    def __init__(self, w: nwalog.Walog, metadata: bytes) -> None:
        self._w = w
        self.metadata = metadata
        self._last_index = 0  # highest entry index appended
        self._segment_bytes = SEGMENT_BYTES

    # -- lifecycle ------------------------------------------------------------

    @staticmethod
    def create(dirpath: str, metadata: bytes = b"",
               segment_bytes: int = SEGMENT_BYTES) -> "WAL":
        w = nwalog.Walog(dirpath, segment_bytes=segment_bytes, create=True)
        wal = WAL(w, metadata)
        wal._segment_bytes = segment_bytes
        w.append(REC_METADATA, metadata)
        # An empty snapshot record marks "replay from the start"
        # (ref: wal.go:130 Create writes an empty walpb.Snapshot).
        w.append(REC_SNAPSHOT, _SNAP.pack(0, 0))
        w.flush(sync=True)
        return wal

    @staticmethod
    def exists(dirpath: str) -> bool:
        return os.path.isdir(dirpath) and any(
            f.endswith(".wal") for f in os.listdir(dirpath)
        )

    @staticmethod
    def open(dirpath: str,
             segment_bytes: int = SEGMENT_BYTES) -> "WAL":
        """Open for appending; run read_all() before the first save."""
        w = nwalog.Walog(dirpath, segment_bytes=segment_bytes, create=False)
        wal = WAL(w, b"")
        wal._segment_bytes = segment_bytes
        return wal

    def close(self) -> None:
        self._w.close()

    def __enter__(self) -> "WAL":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- replay ---------------------------------------------------------------

    def read_all(
        self, snap: Optional[WalSnapshot] = None
    ) -> Tuple[bytes, HardState, List[Entry]]:
        """Replay records; return (metadata, last HardState, entries with
        index > snap.index). Raises WALError if the requested snapshot
        marker never appears in the log (ref: ReadAll's match check)."""
        start = snap.index if snap is not None else 0
        records = nwalog.read_all(self._w.dirpath, repair=True)
        metadata = b""
        hs = HardState()
        ents: List[Entry] = []
        snap_matched = snap is None or (snap.index == 0 and snap.term == 0)
        for rtype, payload, _seq, _meta in records:
            if rtype == REC_METADATA:
                metadata = payload
            elif rtype == REC_STATE:
                term, vote, commit = _STATE.unpack(payload)
                hs = HardState(term=term, vote=vote, commit=commit)
            elif rtype == REC_ENTRY:
                term, index, etype = _ENTRY_HDR.unpack_from(payload)
                e = Entry(term=term, index=index,
                          type=EntryType(etype),
                          data=payload[_ENTRY_HDR.size:])
                if e.index > start:
                    # Later append at index i supersedes any previously
                    # replayed entries at >= i (leader-change rewrite).
                    pos = e.index - start - 1
                    if pos > len(ents):
                        # Gap: the WAL is missing entries between the
                        # snapshot point and this record (ref: ReadAll's
                        # ErrSliceOutOfRange guard).
                        raise WALError(
                            f"entry index {e.index} leaves a gap after "
                            f"{start + len(ents)}"
                        )
                    del ents[pos:]
                    ents.append(e)
                self._last_index = index
            elif rtype == REC_SNAPSHOT:
                idx, term = _SNAP.unpack(payload)
                if snap is not None and idx == snap.index:
                    if term != snap.term and snap.index != 0:
                        raise WALError(
                            f"snapshot marker term mismatch at index {idx}: "
                            f"wal {term} != requested {snap.term}"
                        )
                    snap_matched = True
        if not snap_matched:
            raise WALError(
                f"requested snapshot (index={snap.index}) not found in wal"
            )
        self.metadata = metadata
        return metadata, hs, ents

    # -- append ---------------------------------------------------------------

    def save(self, hs: HardState, entries: List[Entry],
             must_sync: Optional[bool] = None) -> None:
        """Append entries then HardState; fsync iff must_sync (default:
        the raft MustSync rule — any entries or a changed HardState)."""
        if is_empty_hard_state(hs) and not entries:
            return
        for e in entries:
            self._w.append(
                REC_ENTRY,
                _ENTRY_HDR.pack(e.term, e.index, int(e.type)) + e.data,
            )
            self._last_index = e.index
        if not is_empty_hard_state(hs):
            self._w.append(REC_STATE, _STATE.pack(hs.term, hs.vote, hs.commit))
        sync = must_sync if must_sync is not None else True
        if sync:
            t0 = time.monotonic()
            self._w.flush(sync=True)
            dmet.wal_fsync_duration.observe(time.monotonic() - t0)
        else:
            self._w.flush(sync=False)
        if self._w.tail_offset() > self._segment_bytes:
            self._cut()

    def save_snapshot(self, snap: WalSnapshot, sync: bool = True) -> None:
        self._w.append(REC_SNAPSHOT, _SNAP.pack(snap.index, snap.term))
        self._w.flush(sync=sync)

    def _cut(self) -> None:
        """Roll to a new segment named for the next entry index, carrying
        metadata + latest state forward via the crc chain (the chain is
        global, so no re-write is needed — the seed record links it)."""
        self._w.cut(self._last_index + 1)

    def release_to(self, index: int) -> int:
        """Delete segments that only contain data below `index`."""
        return self._w.release_before(index)

    # -- introspection --------------------------------------------------------

    def sync_stats(self) -> Tuple[int, int]:
        return self._w.sync_stats()

    def last_sync_ns(self) -> int:
        return self._w.last_sync_ns()


def verify(dirpath: str) -> bool:
    """Offline chain validation (ref: wal.go:629 Verify)."""
    return nwalog.verify(dirpath)
