"""The production Ready loop for one raft member
(ref: contrib/raftexample/raft.go:87 newRaftNode, serveChannels
~raft.go:416-472, with the persistence ordering of
server/etcdserver/raft.go:226-268).

Loop order per Ready:
  1. save snapshot file + WAL marker (raftBeforeSaveSnap);
  2. WAL save HardState+entries, fsync per MustSync;
  3. apply snapshot to MemoryStorage, publish to the app;
  4. MemoryStorage append;
  5. send messages (after persistence — the conservative follower
     order; the leader-parallel-send optimization lives in the
     etcdserver-style host, not this minimal example);
  6. publish committed entries, trigger snapshot every snap_count;
  7. Advance.

Ports ``etcd_tpu/raftexample/raftnode.py`` with both of its backends:
``backend="tpu"`` (the reference's name for the batched engine, kept so
that a caller's code carries over) makes each member one
``BatchedNode``, whose rows live on the GPU unless the caller names
another device; ``backend="host"`` runs the scalar core's threaded
``Node`` over a ``MemoryStorage``, which touches no device. The port's
default is ``"tpu"``; the reference's is ``"host"``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, List, Optional

from ..batched.node import BatchedNode
from ..batched.rawnode import RowRestore
from ..batched.state import resolve_device
from ..raft.node import Node, Peer
from ..raft.raft import Config, NONE, StateType
from ..raft.rawnode import Ready
from ..raft.storage import MemoryStorage
from ..raft.types import (
    ConfChange,
    ConfChangeType,
    ConfChangeV2,
    Entry,
    EntryType,
    Message,
    MessageType,
    Snapshot,
    SnapshotMetadata,
    is_empty_snap,
)
from ..storage.snap import NoSnapshotError, Snapshotter
from ..storage.storage import ServerStorage
from ..storage.wal import WAL, WalSnapshot
from .transport import InProcNetwork

DEFAULT_SNAP_COUNT = 10000  # raftexample's defaultSnapshotCount (raft.go:121)
SNAPSHOT_CATCHUP_ENTRIES = 10000


class ExampleRaftNode:
    """One member: raft Node + WAL + snapshots + transport glue."""

    def __init__(
        self,
        node_id: int,
        peers: List[int],
        network: InProcNetwork,
        data_dir: str,
        apply_fn: Callable[[List[Entry]], None],
        snapshot_fn: Callable[[], bytes],
        restore_fn: Callable[[bytes], None],
        join: bool = False,
        snap_count: int = DEFAULT_SNAP_COUNT,
        tick_interval: float = 0.05,
        election_tick: int = 10,
        heartbeat_tick: int = 1,
        backend: str = "tpu",
        device=None,
    ) -> None:
        """`backend` selects the raft implementation at this single
        construction site (ref: etcdserver/bootstrap.go:473-536
        bootstrapRaft): "host" = the reference-shaped Python core,
        "tpu" = the batched device engine behind the same Node
        contract (batched/node.py), on `device` (the GPU unless the
        caller names another)."""
        assert backend in ("host", "tpu"), backend
        self.backend = backend
        if backend == "tpu":
            # Before any file is touched: no GPU and no device named
            # raises.
            device = resolve_device(device)
        self.id = node_id
        self.peers = list(peers)
        self.network = network
        self.data_dir = data_dir
        self.apply_fn = apply_fn
        self.snapshot_fn = snapshot_fn
        self.restore_fn = restore_fn
        self.snap_count = snap_count
        self.tick_interval = tick_interval

        self.wal_dir = os.path.join(data_dir, f"member-{node_id}", "wal")
        self.snap_dir = os.path.join(data_dir, f"member-{node_id}", "snap")
        os.makedirs(self.snap_dir, exist_ok=True)

        self.raft_storage = MemoryStorage()
        self.snapshotter = Snapshotter(self.snap_dir)
        self.confstate = None
        self.snapshot_index = 0
        self.applied_index = 0
        self._stopped = threading.Event()

        old_wal = WAL.exists(self.wal_dir)
        self._restore_data = None  # set by _replay for the tpu backend
        self._replay()

        if backend == "tpu":
            # Device ring must cover the un-snapshotted tail: snapshots
            # (and the host-driven ring compaction that follows them)
            # happen every `snap_count` entries, so size the window past
            # that plus catch-up margin.
            window = 1 << max(6, (2 * snap_count + 64).bit_length())
            window = min(window, 1 << 15)
            self.snap_count = min(snap_count, window // 4)
            self.node = BatchedNode(
                node_id=node_id,
                peers=peers,
                election_tick=election_tick,
                heartbeat_tick=heartbeat_tick,
                window=window,
                restore=self._restore_data,
                device=device,
            )
            self._restore_data = None
        else:
            cfg = Config(
                id=node_id,
                election_tick=election_tick,
                heartbeat_tick=heartbeat_tick,
                storage=self.raft_storage,
                max_size_per_msg=1024 * 1024,
                max_inflight_msgs=256,
                max_uncommitted_entries_size=1 << 30,
                check_quorum=True,
                pre_vote=True,
            )
            if old_wal or join:
                self.node = Node.restart(cfg)
            else:
                self.node = Node.start(cfg, [Peer(id=p) for p in peers])

        self.storage = ServerStorage(self.wal, self.snapshotter)
        network.register(
            node_id, self._receive,
            reporter=lambda vid, failure: self.node.report_snapshot(
                vid, failure),
        )

        self._ticker = threading.Thread(target=self._tick_loop, daemon=True)
        self._server = threading.Thread(target=self._serve_loop, daemon=True)
        self._ticker.start()
        self._server.start()

    # -- boot ------------------------------------------------------------------

    def _replay(self) -> None:
        """Snapshot → WAL replay → MemoryStorage
        (ref: raftexample/raft.go replayWAL)."""
        snap = Snapshot()
        if WAL.exists(self.wal_dir):
            try:
                snap = self.snapshotter.load()
            except NoSnapshotError:
                snap = Snapshot()
            self.wal = WAL.open(self.wal_dir)
            walsnap = WalSnapshot(
                index=snap.metadata.index, term=snap.metadata.term
            )
            _meta, hs, ents = self.wal.read_all(walsnap)
            if not is_empty_snap(snap):
                self.raft_storage.apply_snapshot(snap)
                self.confstate = snap.metadata.conf_state
                self.snapshot_index = snap.metadata.index
                self.applied_index = snap.metadata.index
                self.restore_fn(snap.data)
            self.raft_storage.set_hard_state(hs)
            self.raft_storage.append(ents)
            base = snap.metadata.index
            if self.backend != "tpu":
                return
            self._restore_data = RowRestore(
                term=hs.term,
                vote=hs.vote,
                commit=hs.commit,
                applied=base,
                snap_index=base,
                snap_term=snap.metadata.term,
                entries=[
                    (e.index, e.term, e.data, int(e.type))
                    for e in ents
                    if e.index > base
                ],
                # Membership at the snapshot point; conf entries in the
                # replayed tail re-apply through Ready on top of it.
                conf_state=(snap.metadata.conf_state
                            if snap.metadata.index > 0 else None),
            )
        else:
            self.wal = WAL.create(
                self.wal_dir, metadata=self.id.to_bytes(8, "big")
            )

    # -- loops -----------------------------------------------------------------

    def _tick_loop(self) -> None:
        while not self._stopped.wait(self.tick_interval):
            self.node.tick()

    def _serve_loop(self) -> None:
        while not self._stopped.is_set():
            rd = self.node.ready(timeout=0.1)
            if rd is None:
                continue
            self._process_ready(rd)

    def _process_ready(self, rd: Ready) -> None:
        if not is_empty_snap(rd.snapshot):
            self.storage.save_snap(rd.snapshot)
        self.wal.save(rd.hard_state, rd.entries, rd.must_sync)
        if not is_empty_snap(rd.snapshot):
            if self.backend == "host":
                self.raft_storage.apply_snapshot(rd.snapshot)
            self._publish_snapshot(rd.snapshot)
        if rd.entries and self.backend == "host":
            self.raft_storage.append(rd.entries)
        self.network.send(self.id, rd.messages)
        ok = self._publish_entries(self._entries_to_apply(rd.committed_entries))
        if not ok:
            self.stop()
            return
        self._maybe_trigger_snapshot()
        self.node.advance()

    def _entries_to_apply(self, ents: List[Entry]) -> List[Entry]:
        if not ents:
            return []
        first = ents[0].index
        if first > self.applied_index + 1:
            raise RuntimeError(
                f"first index of committed entry[{first}] should <= "
                f"progress.appliedIndex[{self.applied_index}]+1"
            )
        if self.applied_index - first + 1 < len(ents):
            return ents[self.applied_index - first + 1 :]
        return []

    def _publish_entries(self, ents: List[Entry]) -> bool:
        """Apply committed entries (ref: raftexample/raft.go publishEntries):
        normal data goes to the app; conf changes reconfigure raft and
        the network."""
        if not ents:
            return True
        data_ents: List[Entry] = []
        for e in ents:
            if e.type == EntryType.EntryNormal:
                if e.data:
                    data_ents.append(e)
            elif e.type == EntryType.EntryConfChange:
                cc = ConfChange.unmarshal(e.data)
                self.confstate = self.node.apply_conf_change(cc)
                if (
                    cc.type == ConfChangeType.ConfChangeRemoveNode
                    and cc.node_id == self.id
                ):
                    return False  # removed from the cluster: shut down
            elif e.type == EntryType.EntryConfChangeV2:
                ccv2 = ConfChangeV2.unmarshal(e.data)
                self.confstate = self.node.apply_conf_change(ccv2)
        if data_ents:
            self.apply_fn(data_ents)
        self.applied_index = ents[-1].index
        return True

    def _publish_snapshot(self, snap: Snapshot) -> None:
        if snap.metadata.index <= self.applied_index:
            raise RuntimeError(
                f"snapshot index [{snap.metadata.index}] should > "
                f"progress.appliedIndex[{self.applied_index}]"
            )
        self.confstate = snap.metadata.conf_state
        self.snapshot_index = snap.metadata.index
        self.applied_index = snap.metadata.index
        self.restore_fn(snap.data)

    def _maybe_trigger_snapshot(self) -> None:
        """ref: raftexample/raft.go maybeTriggerSnapshot."""
        if self.applied_index - self.snapshot_index <= self.snap_count:
            return
        data = self.snapshot_fn()
        if self.backend == "tpu":
            snap = self.node.create_snapshot(
                self.applied_index, self.confstate, data
            )
            self.storage.save_snap(snap)
            # Catch-up margin below the floor, like the host path: a
            # slightly-lagging follower replays entries instead of
            # taking a full snapshot (ref: raftexample/raft.go
            # snapshotCatchUpEntriesN).
            margin = min(SNAPSHOT_CATCHUP_ENTRIES,
                         self.node.cfg.window // 8)
            self.node.compact(
                max(1, self.applied_index - margin), snap)
        else:
            snap = self.raft_storage.create_snapshot(
                self.applied_index, self.confstate, data
            )
            self.storage.save_snap(snap)
            compact_index = 1
            if self.applied_index > SNAPSHOT_CATCHUP_ENTRIES:
                compact_index = self.applied_index - SNAPSHOT_CATCHUP_ENTRIES
            try:
                self.raft_storage.compact(compact_index)
            except Exception:  # noqa: BLE001 — already compacted is fine
                pass
        self.storage.release(snap)
        self.snapshot_index = self.applied_index

    # -- API -------------------------------------------------------------------

    def _receive(self, m: Message) -> None:
        try:
            self.node.step(m)
        except Exception:  # noqa: BLE001
            pass

    def propose(self, data: bytes, timeout: float = 5.0) -> None:
        self.node.propose(data, timeout=timeout)

    def propose_conf_change(self, cc, timeout: float = 5.0) -> None:
        self.node.propose_conf_change(cc, timeout=timeout)

    def is_leader(self) -> bool:
        st = self.node.status()
        return st.basic.soft_state.raft_state == StateType.StateLeader

    def leader(self) -> int:
        return self.node.status().basic.soft_state.lead

    def stop(self) -> None:
        if self._stopped.is_set():
            return
        self._stopped.set()
        self.network.unregister(self.id)
        self.node.stop()
        for t in (self._ticker, self._server):
            if t.is_alive() and t is not threading.current_thread():
                t.join(timeout=5)
        self.wal.close()
