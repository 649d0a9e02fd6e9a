"""serverstorage.Storage facade: one object owning WAL + Snapshotter,
enforcing the durability ordering the Ready loop depends on
(ref: server/storage/storage.go NewStorage/storage).

Contract (storage.go:27-45):
* ``save(hs, entries, must_sync)`` — WAL append (+fsync per MustSync);
* ``save_snap(snap)`` — snapshot file is written *before* the WAL
  marker so a crash between the two still replays into a state the
  snapshot file can satisfy (storage.go:66-88 SaveSnap);
* ``release(snap)`` — drop WAL segments and snap files made obsolete
  by a persisted snapshot (storage.go:90-109 Release).

Ports ``etcd_tpu/storage/storage.py`` whole.
"""

from __future__ import annotations

from typing import List

from ..raft.types import Entry, HardState, Snapshot
from .snap import Snapshotter
from .wal import WAL, WalSnapshot


class ServerStorage:
    def __init__(self, wal: WAL, snapshotter: Snapshotter) -> None:
        self.wal = wal
        self.snapshotter = snapshotter

    def save(
        self, hs: HardState, entries: List[Entry], must_sync: bool = True
    ) -> None:
        self.wal.save(hs, entries, must_sync)

    def save_snap(self, snap: Snapshot) -> None:
        walsnap = WalSnapshot(index=snap.metadata.index, term=snap.metadata.term)
        # File first, marker second (ref: storage.go:73-87).
        self.snapshotter.save_snap(snap)
        self.wal.save_snapshot(walsnap)

    def release(self, snap: Snapshot) -> None:
        self.wal.release_to(snap.metadata.index)
        self.snapshotter.release_snap_dbs(snap.metadata.index)

    def sync(self) -> None:
        self.wal.save(HardState(), [], must_sync=True)

    def close(self) -> None:
        self.wal.close()
