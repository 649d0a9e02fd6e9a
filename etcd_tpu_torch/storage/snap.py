"""Snapshotter: durable raft snapshot files
(ref: server/etcdserver/api/snap/snapshotter.go:52-139).

Each snapshot is one file named ``%016x-%016x.snap`` (term-index, same
naming as the reference) containing a CRC32-guarded record:

    [u32 crc over payload][u32 payload_len][payload]

where payload = fixed header (index, term, conf-state counts) + conf
state ids + opaque application data. ``load()`` walks snapshots newest
first and skips corrupt/partial files, renaming them ``.broken`` the
way snapshotter.go:204-243 does.

Ports ``etcd_tpu/storage/snap.py`` whole; the port keeps its own copy and
tests/test_torch_hubs.py pins it equal.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import List, Optional

from ..raft.types import ConfState, Snapshot, SnapshotMetadata

SNAP_SUFFIX = ".snap"
_HDR = struct.Struct("<QQIIII")  # index, term, nv, nl, nvo, nln + auto_leave flag packed in nln high bit


class SnapError(Exception):
    pass


class NoSnapshotError(SnapError):
    """ref: snap.ErrNoSnapshot."""


def _encode(snap: Snapshot) -> bytes:
    md = snap.metadata
    cs = md.conf_state
    ids = cs.voters + cs.learners + cs.voters_outgoing + cs.learners_next
    nln = len(cs.learners_next) | (1 << 31 if cs.auto_leave else 0)
    hdr = _HDR.pack(
        md.index,
        md.term,
        len(cs.voters),
        len(cs.learners),
        len(cs.voters_outgoing),
        nln,
    )
    return hdr + struct.pack(f"<{len(ids)}Q", *ids) + snap.data


def _decode(payload: bytes) -> Snapshot:
    index, term, nv, nl, nvo, nln_raw = _HDR.unpack_from(payload)
    auto_leave = bool(nln_raw >> 31)
    nln = nln_raw & 0x7FFFFFFF
    n = nv + nl + nvo + nln
    off = _HDR.size
    ids = list(struct.unpack_from(f"<{n}Q", payload, off))
    off += 8 * n
    cs = ConfState(
        voters=ids[:nv],
        learners=ids[nv : nv + nl],
        voters_outgoing=ids[nv + nl : nv + nl + nvo],
        learners_next=ids[nv + nl + nvo :],
        auto_leave=auto_leave,
    )
    return Snapshot(
        data=payload[off:],
        metadata=SnapshotMetadata(conf_state=cs, index=index, term=term),
    )


class Snapshotter:
    """``fault_hook(op, nbytes)`` is the storage fault plane's seam
    (batched/faults.DiskFaultPlan — same contract as native Walog's
    hook): called BEFORE each file-affecting step with op in
    {"snap_write", "snap_fsync", "snap_rename"}, so a raise guarantees
    that step never started (the write-atomicity save_snap's tmp+rename
    already provides makes any abort loss-free: the previous snapshot
    file is untouched). The hook may sleep (latency injection) or
    raise: ENOSPC/write errors fire on snap_write/snap_rename, fsync
    errors on snap_fsync — exercised directly by
    tests/batched/test_diskfaults.py's Snapshotter seam tests."""

    def __init__(self, dirpath: str, *, fault_hook=None) -> None:
        self.dir = dirpath
        self.fault_hook = fault_hook
        os.makedirs(dirpath, exist_ok=True)

    def _hook(self, op: str, nbytes: int = 0) -> None:
        if self.fault_hook is not None:
            self.fault_hook(op, nbytes)

    def save_snap(self, snapshot: Snapshot) -> None:
        """ref: snapshotter.go:82-139 SaveSnap/save."""
        if snapshot.metadata.index == 0:
            return
        fname = "%016x-%016x%s" % (
            snapshot.metadata.term,
            snapshot.metadata.index,
            SNAP_SUFFIX,
        )
        payload = _encode(snapshot)
        blob = struct.pack("<II", zlib.crc32(payload), len(payload)) + payload
        tmp = os.path.join(self.dir, fname + ".tmp")
        self._hook("snap_write", len(blob))
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            self._hook("snap_fsync")
            os.fsync(f.fileno())
        self._hook("snap_rename")
        os.replace(tmp, os.path.join(self.dir, fname))
        # Crash-durability: fsync the parent directory after the
        # rename, or a crash can lose the DIRECTORY ENTRY of a fully
        # fsync'd snapshot file (the rename lives in the dir's pages,
        # not the file's — ref: fileutil.Fsync after rename in the
        # reference's snap/wal paths; ATC'19's fsync-failure study
        # calls out exactly this class).
        self._fsync_dir()

    def _fsync_dir(self) -> None:
        dfd = os.open(self.dir, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)

    def snap_names(self) -> List[str]:
        """Snapshot filenames, newest (highest term-index) first."""
        names = [
            n
            for n in os.listdir(self.dir)
            if n.endswith(SNAP_SUFFIX)
        ]
        names.sort(reverse=True)
        return names

    def load(self) -> Snapshot:
        """Newest valid snapshot (ref: snapshotter.go:141-172 Load)."""
        return self.load_matching(lambda s: True)

    def load_newest_available(self, wal_snaps: List[tuple]) -> Snapshot:
        """Newest snapshot also recorded in the WAL's snapshot markers
        (ref: snapshotter.go:160-172): wal_snaps is [(index, term), ...]."""
        want = {(i, t) for i, t in wal_snaps}
        return self.load_matching(
            lambda s: (s.metadata.index, s.metadata.term) in want
        )

    def load_matching(self, matchfn) -> Snapshot:
        for name in self.snap_names():
            path = os.path.join(self.dir, name)
            try:
                snap = self._read(path)
            except SnapError:
                os.replace(path, path + ".broken")
                continue
            if matchfn(snap):
                return snap
        raise NoSnapshotError()

    @staticmethod
    def _read(path: str) -> Snapshot:
        with open(path, "rb") as f:
            blob = f.read()
        if len(blob) < 8:
            raise SnapError(f"snap file {path} too short")
        crc, ln = struct.unpack_from("<II", blob)
        payload = blob[8 : 8 + ln]
        if len(payload) != ln or zlib.crc32(payload) != crc:
            raise SnapError(f"snap file {path} crc mismatch")
        return _decode(payload)

    def release_snap_dbs(self, index: int) -> None:
        """Delete snapshot files older than index (purge path,
        ref: snapshotter.go ReleaseSnapDBs). The unlink runs through
        the fault seam (``snap_unlink``), and the directory is fsync'd
        after pruning — the rename-fsync above makes CREATION durable,
        but an unlink lives in the same directory pages: without this,
        a crash can resurrect a pruned file and a later replay may pick
        a stale snapshot that the retention contract promised was gone."""
        removed = 0
        for name in self.snap_names():
            try:
                idx = int(name[17:33], 16)
            except ValueError:
                continue
            if idx < index:
                self._hook("snap_unlink")
                os.remove(os.path.join(self.dir, name))
                removed += 1
        if removed:
            self._hook("snap_fsync")
            self._fsync_dir()

    def retain(self, keep: int) -> int:
        """Keep the ``keep`` newest snapshot files, unlink the rest
        (fault seam + dir fsync like release_snap_dbs). Returns the
        number pruned. keep < 1 is clamped to 1 — retention must never
        delete the only recoverable snapshot."""
        keep = max(1, int(keep))
        victims = self.snap_names()[keep:]
        for name in victims:
            self._hook("snap_unlink")
            os.remove(os.path.join(self.dir, name))
        if victims:
            self._hook("snap_fsync")
            self._fsync_dir()
        return len(victims)
