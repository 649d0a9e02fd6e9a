"""Snapshotter: durable raft snapshot files
(ref: server/etcdserver/api/snap/snapshotter.go:52-139).

Each snapshot is one file named ``%016x-%016x.snap`` (term-index, same
naming as the reference) containing a CRC32-guarded record:

    [u32 crc over payload][u32 payload_len][payload]

where payload = fixed header (index, term, conf-state counts) + conf
state ids + opaque application data. ``load()`` walks snapshots newest
first and skips corrupt/partial files, renaming them ``.broken`` the
way snapshotter.go:204-243 does.

Ports ``etcd_tpu/storage/snap.py`` without its storage fault seam (which
waits for the hosting layer's port); the file format is etcd_tpu's byte
for byte, so each package loads the other's snapshots.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import List

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
    def __init__(self, dirpath: str) -> None:
        self.dir = dirpath
        os.makedirs(dirpath, exist_ok=True)

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
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
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
        ref: snapshotter.go ReleaseSnapDBs). The directory is fsync'd
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
                os.remove(os.path.join(self.dir, name))
                removed += 1
        if removed:
            self._fsync_dir()
