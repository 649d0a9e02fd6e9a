"""EtcdServer: the replicated server core
(ref: server/etcdserver/server.go, raft.go, v3_server.go).

One member = one EtcdServer: raft Node + WAL/snap + backend-backed
subsystems (mvcc watchable KV, lessor, auth, alarms, membership) wired
the reference's way:

* **write path** (v3_server.go:672 processInternalRaftRequestOnce):
  auth-check → id → wait.register → propose → raft commit → applier
  chain (exactly once via consistent index) → wait.trigger unblocks the
  caller with the applied response;
* **read path** (v3_server.go:738 linearizableReadLoop): batch
  ReadIndex rounds — confirm leadership with a heartbeat quorum, wait
  until applied_index ≥ confirmed commit index, serve from mvcc;
* **Ready loop** (etcdserver/raft.go:158-315): apply is scheduled
  async on a FIFO scheduler; the leader sends messages *before* the
  WAL fsync (raft thesis 10.2.1), followers after; snapshot file
  persists before the WAL marker;
* **leadership changes** promote/demote the lessor (primary-only lease
  expiry) and gate lease renew/timetolive on the primary;
* **expired leases** surface from the lessor and are revoked through
  raft proposals (server.go:1120-1165 run.lessor expiry case);
* **snapshots** carry the whole backend (the reference streams the
  bbolt .snap.db and reopens it on the receiver — applySnapshot
  server.go:925; here the sqlite file rides the raft snapshot message).

Ports ``etcd_tpu/server/server.py``. Its differences: ``raft_backend``
defaults to ``"tpu"`` (the reference's name for the batched engine, kept
so that a caller's configuration carries over), whose ``BatchedNode``
rows live on ``ServerConfig.device``, the GPU unless the caller names
another; without CUDA and with no device named, the server raises before
it touches ``data_dir``. ``"host"`` runs the scalar core, which touches
no device. A fresh ``"tpu"`` member writes the bootstrap conf changes
that the scalar core's ``Node.start`` writes (``_bootstrap_log``), so
that its data dir boots the scalar core too.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ..auth.store import AuthInfo, AuthStore
from ..auth.simple_token import SimpleTokenProvider
from ..lease.lessor import (
    Lessor, LeaseItem, LeaseNotFoundError, NoLease, NotPrimaryError,
)
from ..pkg import failpoint
from ..pkg.idutil import Generator
from ..pkg.schedule import FIFOScheduler
from ..pkg.wait import Wait, WaitTime
from ..batched.state import resolve_device
from ..raft.node import Node, Peer
from ..raft.raft import Config, NONE, StateType
from ..raft.rawnode import Ready
from ..raft.storage import MemoryStorage
from ..raft.types import (
    ConfChange,
    ConfState,
    ConfChangeType,
    ConfChangeV2,
    Entry,
    EntryType,
    Message,
    MessageType,
    Snapshot,
    is_empty_hard_state,
    is_empty_snap,
)
from ..storage import backend as bk
from ..storage.mvcc.watchable import WatchableStore
from ..storage.snap import NoSnapshotError, Snapshotter
from ..storage.storage import ServerStorage
from ..storage.wal import WAL, WalSnapshot
from .alarms import AlarmStore
from .api import (
    AlarmAction,
    AlarmRequest,
    AlarmType,
    AuthRequest,
    CompactionRequest,
    DeleteRangeRequest,
    InternalRaftRequest,
    LeaseCheckpoint,
    LeaseCheckpointRequest,
    LeaseGrantRequest,
    LeaseRevokeRequest,
    PutRequest,
    RangeRequest,
    RangeResponse,
    ResponseHeader,
    TxnRequest,
)
from .apply import (
    AlarmApplier,
    ApplierBackend,
    ApplyResult,
    AuthApplier,
    QuotaApplier,
)
from .cindex import ConsistentIndex
from .membership import Member, RaftCluster
from . import metrics as smet

DEFAULT_SNAPSHOT_COUNT = 100000  # ref: server.go:73
DEFAULT_SNAPSHOT_CATCHUP_ENTRIES = 5000  # ref: server.go:80
MAX_GAP_BETWEEN_APPLY_AND_COMMIT = 5000  # ref: v3_server.go:36
DEFAULT_QUOTA_BYTES = 2 * 1024 * 1024 * 1024  # ref: storage/quota.go
READ_INDEX_RETRY_TIME = 0.5  # ref: v3_server.go:44


class StoppedError(Exception):
    """ref: etcdserver.ErrStopped."""


class TimeoutError_(Exception):
    """ref: etcdserver.ErrTimeout."""


# Shared across layers (client failover matches by class name).
from ..pkg.errors import LearnerNotReadyError, NotLeaderError  # noqa: E402


class TooManyRequestsError(Exception):
    """ref: etcdserver.ErrTooManyRequests (apply/commit gap backpressure)."""


class MemberRemovedError(Exception):
    pass


class RequestTooLargeError(Exception):
    """ref: rpctypes.ErrRequestTooLarge (v3_server.go size check)."""


@dataclass
class ServerConfig:
    member_id: int = 1
    cluster_id: int = 0x1000
    peers: List[int] = field(default_factory=lambda: [1])
    data_dir: str = ""
    network: Any = None  # transport with send(from_id, msgs) + register()
    join: bool = False
    snapshot_count: int = DEFAULT_SNAPSHOT_COUNT
    snapshot_catchup_entries: int = DEFAULT_SNAPSHOT_CATCHUP_ENTRIES
    quota_bytes: int = DEFAULT_QUOTA_BYTES
    tick_interval: float = 0.05
    election_tick: int = 10
    heartbeat_tick: int = 1
    auto_compaction_mode: str = ""  # ""|periodic|revision
    auto_compaction_retention: float = 0.0
    lease_min_ttl: int = 1
    lease_checkpoint_interval: float = 300.0
    pre_vote: bool = True
    request_timeout: float = 7.0
    max_request_bytes: int = 1536 * 1024  # ref: embed/config.go DefaultMaxRequestBytes
    auth_token: str = "simple"  # "simple" | "hmac:<key>" | "jwt,sign-key=<k>[,sign-method=HS256][,ttl=5m]" (ref: --auth-token)
    # Corruption checking (ref: corrupt.go; --experimental-initial-
    # corrupt-check / --experimental-corrupt-check-time). The fetcher
    # resolves a peer id to its hash-KV; None disables both checks.
    peer_hash_fetcher: Any = None
    initial_corrupt_check: bool = False
    corrupt_check_time: float = 0.0  # seconds; 0 → no periodic monitor
    # TLSInfo for member→member calls against peers' CLIENT listeners
    # (renew forwarding); None in plaintext clusters.
    client_tls_info: Any = None
    # Raft implementation behind the Node contract: "host" = the
    # reference-shaped Python core, "tpu" = the batched device engine
    # (member ids reach it through its id <-> slot map; ref: SURVEY §7.6
    # --experimental-raft-backend plumbing at bootstrapRaft).
    raft_backend: str = "tpu"
    # tpu backend only: provisioned replica slots (compiled shape).
    # 0 = len(peers). Member-adds beyond this capacity are rejected;
    # provision headroom when the cluster is expected to grow.
    replica_capacity: int = 0
    # tpu backend only: where the node's rows live, the GPU unless the
    # caller names another (a caller without CUDA passes "cpu").
    device: Any = None


@dataclass
class _ApplyTask:
    entries: List[Entry]
    snapshot: Snapshot
    persisted: threading.Event  # snapshot durable on disk


class EtcdServer:
    def __init__(self, cfg: ServerConfig) -> None:
        if cfg.raft_backend == "tpu":
            # Before any file is touched: no GPU and no device named
            # raises.
            self.device = resolve_device(cfg.device)
        self.cfg = cfg
        self.id = cfg.member_id
        self.cluster_id = cfg.cluster_id
        self.network = cfg.network

        self.member_dir = os.path.join(cfg.data_dir, f"member-{self.id}")
        self.wal_dir = os.path.join(self.member_dir, "wal")
        self.snap_dir = os.path.join(self.member_dir, "snap")
        self.db_path = os.path.join(self.member_dir, "db")
        os.makedirs(self.snap_dir, exist_ok=True)

        self._stopped = threading.Event()
        self._applied_index = 0
        self._committed_index = 0
        self._term = 0
        self._lead = NONE
        self._lead_lock = threading.Lock()
        self._fwd_lock = threading.Lock()
        self._fwd_clients: Dict[str, object] = {}  # leader ep -> Client

        self.w = Wait()
        self.apply_wait = WaitTime()
        self.idgen = Generator(self.id & 0xFF)
        self.sched = FIFOScheduler("apply")
        self.first_commit_in_term = threading.Event()
        self.leader_changed = threading.Event()

        self._read_mu = threading.Lock()
        self._read_notifier: Optional[_Notifier] = None
        self._read_waitc = threading.Event()
        self._read_states: List = []
        self._read_states_cv = threading.Condition()

        self._open_backend_stack()
        self._boot_raft()

        self.applier = AlarmApplier(
            QuotaApplier(AuthApplier(ApplierBackend(self), self.auth_store), self),
            self,
        )

        # Lease plumbing: checkpoints + expiry both ride raft.
        self.lessor.checkpointer = self._lease_checkpoint_via_raft
        self.lessor.range_deleter = lambda: _LeaseDeleterTxn(self)

        # Election/lock services over the loopback client
        # (ref: embed/etcd.go registering v3election/v3lock on v3client).
        from .v3election import ElectionServer
        from .v3lock import LockServer

        self.election_server = ElectionServer(self)
        self.lock_server = LockServer(self)

        self.compactor = None
        if cfg.auto_compaction_mode:
            from .compactor import new_compactor

            self.compactor = new_compactor(
                cfg.auto_compaction_mode,
                cfg.auto_compaction_retention,
                self.kv.rev,
                lambda rev: self.compact(CompactionRequest(revision=rev)),
            )
            self.compactor.run()

        # Corruption checking (ref: server.go:558-563 — initial check
        # before serving, then the periodic KV-hash monitor).
        self.corruption_checker = None
        if cfg.peer_hash_fetcher is not None:
            from .corrupt import CorruptionChecker

            self.corruption_checker = CorruptionChecker(
                self, cfg.peer_hash_fetcher)
            if cfg.initial_corrupt_check:
                try:
                    self.corruption_checker.initial_check()
                except Exception:
                    # Refuse to serve, but release what's open (the
                    # loops below haven't started yet).
                    if self.compactor is not None:
                        self.compactor.stop()
                    self.node.stop()
                    self.sched.stop()
                    self.kv.stop_sync_loop()
                    self.lessor.stop()
                    self.wal.close()
                    self.be.close()
                    raise
            if cfg.corrupt_check_time > 0:
                self.corruption_checker.start_periodic(cfg.corrupt_check_time)

        self.network.register(
            self.id, self._receive_message,
            reporter=lambda vid, failure: self.node.report_snapshot(
                vid, failure),
        )
        self._ready_thread = threading.Thread(
            target=self._ready_loop, daemon=True, name=f"ready-{self.id}"
        )
        self._threads = [
            threading.Thread(target=self._tick_loop, daemon=True),
            self._ready_thread,
            threading.Thread(target=self._linearizable_read_loop, daemon=True),
            threading.Thread(target=self._expired_lease_loop, daemon=True),
        ]
        for t in self._threads:
            t.start()

    # -- boot ------------------------------------------------------------------

    def _open_backend_stack(self, db_path: Optional[str] = None) -> None:
        """Open backend + all stores over it (boot & snapshot recovery)."""
        self.be = bk.open_backend(db_path or self.db_path)
        self.cindex = ConsistentIndex(self.be)
        self.lessor = Lessor(
            self.be,
            min_lease_ttl=self.cfg.lease_min_ttl,
            checkpoint_interval=self.cfg.lease_checkpoint_interval,
            loop_interval=min(0.5, self.cfg.tick_interval * 4),
        )
        self.kv = WatchableStore(self.be, self.lessor)
        self.kv.start_sync_loop()
        spec = self.cfg.auth_token
        if spec.startswith("hmac:"):
            from ..auth.hmac_token import HMACTokenProvider

            provider = HMACTokenProvider(spec[len("hmac:"):].encode())
        elif spec == "jwt" or spec.startswith("jwt,"):
            from ..auth.jwt_token import JWTTokenProvider

            provider = JWTTokenProvider.from_opts(spec[len("jwt,"):] if
                                                  "," in spec else "")
        else:
            provider = SimpleTokenProvider()
        self.auth_store = AuthStore(self.be, token_provider=provider)
        self.alarms = AlarmStore(self.be)
        self.cluster = RaftCluster(self.cluster_id, self.be)
        # Legacy v2 store: in-memory, rebuilt by replaying v2 ops from
        # the WAL (ref: api/v2store; the deprecation-path subsystem).
        from ..v2store.store import V2Store

        self.v2store = V2Store()

    def _boot_raft(self) -> None:
        """Cold/warm start (ref: etcdserver/bootstrap.go:52-119)."""
        self.raft_storage = MemoryStorage()
        self.snapshotter = Snapshotter(self.snap_dir)
        self.confstate = None

        old_wal = WAL.exists(self.wal_dir)
        snap = Snapshot()
        hs = None
        ents: List[Entry] = []
        if old_wal:
            try:
                snap = self.snapshotter.load()
            except NoSnapshotError:
                snap = Snapshot()
            self.wal = WAL.open(self.wal_dir)
            walsnap = WalSnapshot(index=snap.metadata.index, term=snap.metadata.term)
            _meta, hs, ents = self.wal.read_all(walsnap)
            if not is_empty_snap(snap):
                if self.cfg.raft_backend != "tpu":  # device holds the log
                    self.raft_storage.apply_snapshot(snap)
                self.confstate = snap.metadata.conf_state
                try:
                    v2blob = json.loads(snap.data.decode()).get("v2")
                    if v2blob:
                        self.v2store.recovery(v2blob)
                except (ValueError, KeyError):
                    pass  # pre-v2 snapshot format
            if self.cfg.raft_backend != "tpu":
                self.raft_storage.set_hard_state(hs)
                self.raft_storage.append(ents)
            # Raft replays ALL committed entries after the snapshot so
            # conf changes rebuild its config; the consistent-index
            # guard dedupes backend effects (server.go:1815-1827) —
            # applied starts at the snapshot point, NOT the cindex.
            self._applied_index = snap.metadata.index
        else:
            self.wal = WAL.create(self.wal_dir, metadata=self.id.to_bytes(8, "big"))

        self.storage = ServerStorage(self.wal, self.snapshotter)
        if self.cfg.raft_backend == "tpu":
            self._boot_raft_tpu(old_wal, snap, hs, ents)
            return

        raft_cfg = Config(
            id=self.id,
            election_tick=self.cfg.election_tick,
            heartbeat_tick=self.cfg.heartbeat_tick,
            storage=self.raft_storage,
            applied=self._applied_index,
            max_size_per_msg=1024 * 1024,  # ref: etcdserver/raft.go:33-40
            max_inflight_msgs=512,
            max_uncommitted_entries_size=1 << 30,
            check_quorum=True,
            pre_vote=self.cfg.pre_vote,
        )
        if old_wal or self.cfg.join:
            self.node = Node.restart(raft_cfg)
        else:
            peers = [
                Peer(
                    id=p,
                    context=Member(id=p, name=f"m{p}").marshal(),
                )
                for p in self.cfg.peers
            ]
            self.node = Node.start(raft_cfg, peers)

    def _boot_raft_tpu(self, old_wal: bool, snap: Snapshot, hs,
                       ents: List[Entry]) -> None:
        """Construct the batched device engine behind the same Node
        contract — the server-side `--raft-backend=tpu` path at the
        single raft-construction site (ref: etcdserver/bootstrap.go:
        473-536 bootstrapRaft; SURVEY §7.6)."""
        from ..batched.node import BatchedNode
        from ..batched.rawnode import RowRestore

        joiner_boot = self.cfg.join and not old_wal
        if not old_wal:
            # Fresh boot: the host path seeds the member registry via
            # bootstrap ConfChange entries (Node.start); the batched
            # engine boots with membership as initial state, so seed
            # the registry directly with the same Member contexts. A
            # JOINER seeds everyone but itself — its own membership
            # (registry entry AND device vote mask) arrives only via
            # the admitting ConfChange in the replicated log, so it
            # cannot campaign or count its own vote before admission
            # (ref: etcdserver/bootstrap.go:487-536; operators pass the
            # current member list via --initial-cluster, exactly what
            # `etcdctl member add` prints).
            for p in self.cfg.peers:
                if p == self.id and self.cfg.join:
                    continue
                if self.cluster.member(p) is None:
                    self.cluster.add_member(Member(id=p, name=f"m{p}"))

        restore = None
        if old_wal and hs is not None:
            base = snap.metadata.index
            restore = RowRestore(
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
                conf_state=(snap.metadata.conf_state
                            if snap.metadata.index > 0 else None),
            )
        if restore is None and not old_wal and not joiner_boot:
            restore = self._bootstrap_log()
        # Device ring must cover the un-snapshotted tail (snapshots
        # every snapshot_count entries plus catch-up margin).
        window = 1 << max(6, (2 * self.cfg.snapshot_count + 64).bit_length())
        window = min(window, 1 << 15)
        self.cfg.snapshot_count = min(self.cfg.snapshot_count, window // 4)
        # Unconditional: a catch-up margin wider than the ring would pin
        # the floor and eventually stall proposals on ring headroom.
        self.cfg.snapshot_catchup_entries = min(
            self.cfg.snapshot_catchup_entries, window // 8)
        self.node = BatchedNode(
            node_id=self.id,
            peers=self.cfg.peers,
            election_tick=self.cfg.election_tick,
            heartbeat_tick=self.cfg.heartbeat_tick,
            window=window,
            pre_vote=self.cfg.pre_vote,
            restore=restore,
            boot_conf_state=(
                ConfState(voters=[p for p in self.cfg.peers
                                  if p != self.id])
                if joiner_boot else None
            ),
            capacity=self.cfg.replica_capacity,
            device=self.device,
        )
        if restore is not None and not is_empty_snap(snap):
            # Seed the node's app snapshot so lagging followers can be
            # served immediately after restart (the host path restores
            # it into MemoryStorage); the ring floor is already at the
            # snapshot index, so this only attaches the app state.
            self.node.compact(snap.metadata.index, snap)

    def _bootstrap_log(self):
        """A fresh member's log as Node.start writes it: one
        ConfChangeAddNode a boot peer at term 1, committed (ref:
        raft/bootstrap.go:30-80), saved to the WAL and given to the node
        as committed; they apply as on the host path (the registry is
        seeded already, the node's configuration holds them already).
        The scalar core rebuilds its configuration from these entries, so
        the data dir boots either backend."""
        from ..batched.rawnode import RowRestore
        from ..raft.types import HardState

        ents = [Entry(type=EntryType.EntryConfChange, term=1, index=i + 1,
                      data=ConfChange(
                          type=ConfChangeType.ConfChangeAddNode, node_id=p,
                          context=Member(id=p, name=f"m{p}").marshal(),
                      ).marshal())
                for i, p in enumerate(self.cfg.peers)]
        self.wal.save(HardState(term=1, commit=len(ents)), ents, True)
        return RowRestore(
            term=1, vote=0, commit=len(ents),
            entries=[(e.index, e.term, e.data, int(e.type)) for e in ents])

    # -- loops -----------------------------------------------------------------

    def _tick_loop(self) -> None:
        # Slow-tick detector: a delayed heartbeat tick usually means the
        # loop thread was starved (slow disk / GC) — the reference's
        # heartbeat contention detector (etcdserver/raft.go:132-134).
        from ..pkg.contention import TimeoutDetector

        td = TimeoutDetector(2 * self.cfg.tick_interval)
        while not self._stopped.wait(self.cfg.tick_interval):
            ok, _ = td.observe(0)
            if not ok and self.is_leader():
                smet.heartbeat_send_failures.inc()
            self.node.tick()

    def _receive_message(self, m: Message) -> None:
        if self.cluster.is_removed(m.from_):
            return  # ref: server.go:690 Process rejects removed members
        try:
            self.node.step(m)
        except Exception:  # noqa: BLE001
            pass

    def _ready_loop(self) -> None:
        """ref: etcdserver/raft.go:158-315 raftNode.start."""
        try:
            self._ready_loop_inner()
        except failpoint.FailpointPanic:
            # gofail-style panic: the ready loop "crashes" — no cleanup,
            # no WAL flush (the reference's panic() kills the process;
            # ref: etcdserver/raft.go:222-265 gofail sites). The chaos
            # harness detects the dead thread and kill()s + restarts the
            # member; stop()/kill() still runs the full teardown, so the
            # stopped flag is deliberately NOT set here.
            return

    def _ready_loop_inner(self) -> None:
        islead = False
        while not self._stopped.is_set():
            rd = self.node.ready(timeout=0.1)
            if rd is None:
                continue
            if rd.soft_state is not None:
                islead = rd.soft_state.raft_state == StateType.StateLeader
                self._update_leadership(rd.soft_state)
            if rd.read_states:
                with self._read_states_cv:
                    self._read_states.extend(rd.read_states)
                    self._read_states_cv.notify_all()
            persisted = threading.Event()
            task = _ApplyTask(
                entries=rd.committed_entries,
                snapshot=rd.snapshot,
                persisted=persisted,
            )
            self._update_committed_index(task)
            self.sched.schedule(lambda t=task: self._apply_all(t))
            if islead:
                # Leader parallel-send: before fsync (raft thesis 10.2.1,
                # etcdserver/raft.go:218-224).
                failpoint.fp("raftBeforeLeaderSend")
                self.network.send(self.id, self._process_messages(rd.messages))
            if not is_empty_snap(rd.snapshot):
                failpoint.fp("raftBeforeSaveSnap")
                self.storage.save_snap(rd.snapshot)
                failpoint.fp("raftAfterSaveSnap")
            failpoint.fp("raftBeforeSave")
            self.wal.save(rd.hard_state, rd.entries, rd.must_sync)
            failpoint.fp("raftAfterSave")
            if not is_empty_snap(rd.snapshot):
                failpoint.fp("raftBeforeApplySnap")
                if self.cfg.raft_backend != "tpu":  # device holds the log
                    self.raft_storage.apply_snapshot(rd.snapshot)
                failpoint.fp("raftAfterApplySnap")
            persisted.set()
            if rd.entries and self.cfg.raft_backend != "tpu":
                self.raft_storage.append(rd.entries)
            if not islead:
                failpoint.fp("raftBeforeFollowerSend")
                self.network.send(self.id, self._process_messages(rd.messages))
            failpoint.fp("raftBeforeAdvance")
            self.node.advance()

    def _process_messages(self, msgs: List[Message]) -> List[Message]:
        """Drop messages to removed members (ref: raft.go:330-373)."""
        out = []
        for m in msgs:
            if self.cluster.is_removed(m.to):
                continue
            out.append(m)
        return out

    def _update_committed_index(self, task: _ApplyTask) -> None:
        ci = 0
        if task.entries:
            ci = task.entries[-1].index
        if task.snapshot.metadata.index > ci:
            ci = task.snapshot.metadata.index
        if ci > self._committed_index:
            self._committed_index = ci
            smet.proposals_committed.set(ci)

    def _update_leadership(self, soft_state) -> None:
        """ref: server.go raftReadyHandler updateLeadership."""
        with self._lead_lock:
            prev = self._lead
            self._lead = soft_state.lead
        if prev != soft_state.lead:
            self.leader_changed.set()
            self.leader_changed = threading.Event()
            if soft_state.lead != NONE:
                smet.leader_changes.inc()
        smet.has_leader.set(1 if soft_state.lead != NONE else 0)
        smet.is_leader.set(
            1 if soft_state.raft_state == StateType.StateLeader else 0
        )
        if soft_state.raft_state == StateType.StateLeader:
            if not self.lessor.is_primary():
                self.lessor.promote(
                    extend=self.cfg.election_tick * self.cfg.tick_interval
                )
            if self.compactor is not None:
                self.compactor.resume()
        else:
            if self.lessor.is_primary():
                self.lessor.demote()
            if self.compactor is not None:
                self.compactor.pause()

    # -- apply -----------------------------------------------------------------

    def _apply_all(self, task: _ApplyTask) -> None:
        """ref: server.go:903 applyAll."""
        t0 = time.monotonic()
        if not self._apply_snapshot(task):
            # Stop-aborted while waiting for snapshot persistence: the
            # entries after the snapshot cannot apply either (applied
            # never reached snap.index); abandon the whole task.
            return
        self._apply_entries(task)
        dt = time.monotonic() - t0
        smet.apply_duration.observe(dt)
        if dt > 0.1:  # warnApplyDuration (server.go:83)
            smet.slow_applies.inc()
        self.apply_wait.trigger(self._applied_index)
        self._maybe_trigger_snapshot()

    def _apply_snapshot(self, task: _ApplyTask) -> bool:
        """Receive a full-state snapshot: reopen the backend from the
        shipped db (ref: server.go:925-1040 applySnapshot). Returns
        False when aborted by stop (the rest of the task must not
        apply)."""
        if is_empty_snap(task.snapshot):
            return True
        snap = task.snapshot
        if snap.metadata.index <= self._applied_index:
            raise RuntimeError(
                f"snapshot index [{snap.metadata.index}] should > "
                f"applied index [{self._applied_index}]"
            )
        smet.snapshot_apply_in_progress.set(1)
        try:
            # Snapshot must be durable before opening it. A ready loop
            # that crashed mid-persist (failpoint panic) never sets the
            # event; bail on stop so teardown's scheduler join cannot
            # deadlock — not applying an unpersisted snapshot is exactly
            # crash semantics.
            while not task.persisted.wait(0.05):
                if self._stopped.is_set():
                    return False
            payload = json.loads(snap.data.decode())
            db_bytes = bytes.fromhex(payload["db"])
            newdb = os.path.join(
                self.member_dir, f"db.snap.{snap.metadata.index}"
            )
            with open(newdb, "wb") as f:
                f.write(db_bytes)
                f.flush()
                os.fsync(f.fileno())
            # Tear down stores over the old backend, swap the file, reopen.
            self.kv.stop_sync_loop()
            self.lessor.stop()
            self.be.close()
            os.replace(newdb, self.db_path)
            self._open_backend_stack()
            self.lessor.checkpointer = self._lease_checkpoint_via_raft
            self.lessor.range_deleter = lambda: _LeaseDeleterTxn(self)
            self.confstate = snap.metadata.conf_state
            self._applied_index = snap.metadata.index
            self._term = max(self._term, snap.metadata.term)
            self.cindex.set_consistent_index(self._applied_index, self._term)
            if "v2" in payload:
                self.v2store.recovery(payload["v2"])
        finally:
            smet.snapshot_apply_in_progress.set(0)

    def _apply_entries(self, task: _ApplyTask) -> None:
        if not task.entries:
            return
        first = task.entries[0].index
        if first > self._applied_index + 1:
            raise RuntimeError(
                f"first committed entry index {first} > applied+1 "
                f"{self._applied_index + 1}"
            )
        ents = [e for e in task.entries if e.index > self._applied_index]
        for e in ents:
            if e.type == EntryType.EntryNormal:
                self._apply_entry_normal(e)
            elif e.type in (EntryType.EntryConfChange, EntryType.EntryConfChangeV2):
                self._apply_conf_change_entry(e)
            self._applied_index = e.index
            self._term = max(self._term, e.term)
        smet.proposals_applied.set(self._applied_index)

    def _apply_entry_normal(self, e: Entry) -> None:
        """ref: server.go:1811-1913 applyEntryNormal."""
        # Consistent-index guard: skip entries already reflected in the
        # backend (replay after restart, server.go:1815-1827). Only
        # advance the index — writing it back on a replayed old entry
        # would reset the guard.
        should_apply = e.index > self.cindex.consistent_index()
        if should_apply:
            self.cindex.set_consistent_index(e.index, e.term)
        if not e.data:
            # Empty entry at term start: first commit notification +
            # lessor primary refresh (server.go:1835-1844).
            self.first_commit_in_term.set()
            self.first_commit_in_term = threading.Event()
            if self.is_leader():
                self.lessor.promote(
                    extend=self.cfg.election_tick * self.cfg.tick_interval
                )
            return
        req = InternalRaftRequest.unmarshal(e.data)
        if req.op == "v2":
            # v2 ops rebuild the in-memory v2 store on every replay —
            # it is NOT backend-backed, so the consistent-index guard
            # does not apply (ref: server.go applyV2Request; the
            # reference replays the v2 store from WAL + snapshot).
            result = self._apply_v2(req)
            if should_apply and req.id != 0:
                self.w.trigger(req.id, result)
            return
        if not should_apply:
            return
        result = self.applier.apply(req)
        if req.id != 0:
            self.w.trigger(req.id, result)

    def _apply_conf_change_entry(self, e: Entry) -> None:
        """ref: server.go:1915-1985 applyConfChange."""
        should_apply = e.index > self.cindex.consistent_index()
        if should_apply:
            self.cindex.set_consistent_index(e.index, e.term)
        if e.type == EntryType.EntryConfChange:
            cc = ConfChange.unmarshal(e.data)
            ccid, typ, nid, ctx = cc.id, cc.type, cc.node_id, cc.context
        else:
            ccv2 = ConfChangeV2.unmarshal(e.data)
            cc = ccv2
            ccid = 0
            typ = ccv2.changes[0].type if ccv2.changes else None
            nid = ccv2.changes[0].node_id if ccv2.changes else 0
            ctx = ccv2.context
        self.confstate = self.node.apply_conf_change(cc)
        if not should_apply:
            if ccid != 0:
                self.w.trigger(ccid, ApplyResult(resp=None))
            return
        removed_self = False
        if typ == ConfChangeType.ConfChangeAddNode:
            existing = self.cluster.member(nid)
            if existing is not None:
                # AddNode for a member we already track is a learner
                # promotion (ref: server.go:1938 promoteMember — the
                # wire carries promotion as AddNode on an existing id).
                if existing.is_learner:
                    self.cluster.promote_member(nid)
            elif not self.cluster.is_removed(nid):
                m = Member.unmarshal(ctx) if ctx else Member(id=nid, name=f"m{nid}")
                try:
                    self.cluster.add_member(m)
                except Exception:  # noqa: BLE001 — already present on replay
                    pass
        elif typ == ConfChangeType.ConfChangeAddLearnerNode:
            if self.cluster.member(nid) is None and not self.cluster.is_removed(nid):
                m = Member.unmarshal(ctx) if ctx else Member(id=nid, name=f"m{nid}")
                m.is_learner = True
                try:
                    self.cluster.add_member(m)
                except Exception:  # noqa: BLE001
                    pass
        elif typ == ConfChangeType.ConfChangeRemoveNode:
            self.cluster.remove_member(nid)
            if nid == self.id:
                removed_self = True
        if ccid != 0:
            self.w.trigger(ccid, ApplyResult(resp=self.confstate))
        if removed_self:
            threading.Thread(target=self.stop, daemon=True).start()

    # -- snapshot trigger ------------------------------------------------------

    def _maybe_trigger_snapshot(self) -> None:
        """ref: server.go:1096-1113 triggerSnapshot."""
        if self._applied_index - self._snapshot_index() <= self.cfg.snapshot_count:
            return
        self._snapshot()

    def _snapshot_index(self) -> int:
        if self.cfg.raft_backend == "tpu":
            return int(self.node.rn.m_snap[0])  # device ring floor
        try:
            return self.raft_storage.snapshot().metadata.index
        except Exception:  # noqa: BLE001
            return 0

    def _snapshot(self) -> None:
        """Serialize the backend into the raft snapshot
        (ref: server.go:1993-2070 snapshot; the reference ships the bbolt
        file the same way via snap.Message)."""
        self.be.force_commit()
        tmp = os.path.join(self.member_dir, "db.snapshot.tmp")
        self.be.snapshot_to(tmp)
        with open(tmp, "rb") as f:
            db_bytes = f.read()
        os.remove(tmp)
        data = json.dumps({
            "db": db_bytes.hex(),
            # The v2 store rides the snapshot (the reference serializes
            # it into .snap files, snapshot_merge.go) so pre-snapshot
            # v2 state survives log compaction and restarts.
            "v2": self.v2store.save(),
        }).encode()
        if self.cfg.raft_backend == "tpu":
            snap = self.node.create_snapshot(
                self._applied_index, self.confstate, data
            )
            self.storage.save_snap(snap)
            # Keep the catch-up margin below the ring floor so a
            # slightly-lagging follower gets log entries, not a full
            # state transfer (ref: server.go:80 CatchUpEntries; the
            # attached app snapshot at applied still covers any floor).
            compact_index = max(
                1, self._applied_index - self.cfg.snapshot_catchup_entries
            )
            self.node.compact(compact_index, snap)
            self.storage.release(snap)
            return
        snap = self.raft_storage.create_snapshot(
            self._applied_index, self.confstate, data
        )
        self.storage.save_snap(snap)
        compact_index = max(1, self._applied_index - self.cfg.snapshot_catchup_entries)
        try:
            self.raft_storage.compact(compact_index)
        except Exception:  # noqa: BLE001 — already compacted
            pass
        self.storage.release(snap)

    # -- write path ------------------------------------------------------------

    def _auth_info_from_token(self, token: Optional[str]) -> Optional[AuthInfo]:
        if not token or not self.auth_store.is_auth_enabled():
            return None
        return self.auth_store.auth_info_from_token(token)

    def process_internal_raft_request(
        self, op: str, req: Any, token: Optional[str] = None
    ) -> ApplyResult:
        """ref: v3_server.go:672-733 processInternalRaftRequestOnce."""
        if self._stopped.is_set():
            raise StoppedError()
        ai = self._committed_index - self._applied_index
        if ai > MAX_GAP_BETWEEN_APPLY_AND_COMMIT:
            raise TooManyRequestsError()
        info = self._auth_info_from_token(token)
        r = InternalRaftRequest(
            id=self.idgen.next(),
            op=op,
            req=req,
            username=info.username if info else "",
            auth_revision=info.revision if info else 0,
        )
        data = r.marshal()
        if len(data) > self.cfg.max_request_bytes:
            raise RequestTooLargeError()
        waiter = self.w.register(r.id)
        smet.proposals_pending.inc()
        try:
            self.node.propose(data, timeout=self.cfg.request_timeout)
            result = waiter.wait(timeout=self.cfg.request_timeout)
        except TimeoutError:
            self.w.trigger(r.id, None)  # deregister
            smet.proposals_failed.inc()
            raise TimeoutError_()
        finally:
            smet.proposals_pending.dec()
        if result is None:
            raise StoppedError()
        if result.err is not None:
            raise result.err
        return result

    # -- public KV API (v3_server.go:99-222) -----------------------------------

    def put(self, req: PutRequest, token: Optional[str] = None):
        return self.process_internal_raft_request("put", req, token).resp

    def delete_range(self, req: DeleteRangeRequest, token: Optional[str] = None):
        return self.process_internal_raft_request("delete_range", req, token).resp

    def txn(self, req: TxnRequest, token: Optional[str] = None):
        from .apply import _is_txn_write

        if _is_txn_write(req):
            return self.process_internal_raft_request("txn", req, token).resp
        # Read-only txn: serve locally after a read-index barrier.
        self.linearizable_read_notify()
        info = self._auth_info_from_token(token)
        if info is not None:
            AuthApplier(ApplierBackend(self), self.auth_store)._check_txn(info, req)
        return ApplierBackend(self).txn(req)

    def range(self, req: RangeRequest, token: Optional[str] = None) -> RangeResponse:
        """ref: v3_server.go:99-137 Range."""
        if not req.serializable:
            self.linearizable_read_notify()
        info = self._auth_info_from_token(token)
        if info is not None:
            self.auth_store.is_range_permitted(info, req.key, req.range_end)
        return ApplierBackend(self).range(req)

    def compact(self, req: CompactionRequest, token: Optional[str] = None):
        result = self.process_internal_raft_request("compaction", req, token)
        if req.physical:
            self.be.force_commit()
        return result.resp

    # -- lease API (v3_server.go:224-331) --------------------------------------

    def lease_grant(self, ttl: int, lease_id: int = 0, token: Optional[str] = None):
        if lease_id == 0:
            lease_id = self.idgen.next() & 0x7FFFFFFFFFFFFFFF
        req = LeaseGrantRequest(ttl=ttl, id=lease_id)
        resp = self.process_internal_raft_request("lease_grant", req, token).resp
        smet.lease_granted.inc()
        return resp

    def lease_revoke(self, lease_id: int, token: Optional[str] = None):
        req = LeaseRevokeRequest(id=lease_id)
        resp = self.process_internal_raft_request("lease_revoke", req, token).resp
        smet.lease_revoked.inc()
        return resp

    def publish(self, name: str, client_urls: List[str]) -> None:
        """Replicate this member's attributes (name + serving client
        URLs) so peers can resolve each other's client endpoints — the
        renew-forwarding path depends on it (ref: server.go:2097
        publishV3, retried until the proposal applies)."""
        def loop() -> None:
            req = {"id": self.id, "name": name,
                   "client_urls": list(client_urls)}
            while not self._stopped.is_set():
                try:
                    self.process_internal_raft_request(
                        "cluster_member_attr", req)
                    return
                except Exception:  # noqa: BLE001 — no leader yet etc.
                    if self._stopped.wait(1.0):
                        return

        t = threading.Thread(target=loop, daemon=True,
                             name=f"publish-{self.id:x}")
        t.start()
        self._threads.append(t)

    def lease_renew(self, lease_id: int, local_only: bool = False) -> int:
        """Keepalive: the expiry clock lives on the primary lessor, so a
        follower forwards the renew to the leader instead of bouncing
        the client (ref: v3_server.go:244-270 LeaseRenew → leasehttp
        RenewHTTP against the leader). ``local_only`` marks an
        already-forwarded request — one hop max, a stale-leader target
        answers NotLeader rather than forwarding again."""
        if not self.lessor.is_primary():
            if local_only:
                raise NotLeaderError()
            return self._forward_lease_renew(lease_id)
        try:
            ttl = self.lessor.renew(lease_id)
        except NotPrimaryError as exc:
            # Demoted between the is_primary check and the renew: the
            # caller should chase the new leader, not see a lease error.
            raise NotLeaderError() from exc
        smet.lease_renewed.inc()
        return ttl

    def _forward_lease_renew(self, lease_id: int) -> int:
        """One-hop renew forward to the current leader's client URL."""
        lead = self.leader()
        m = self.cluster.member(lead) if lead != NONE else None
        if m is None or not m.client_urls:
            raise NotLeaderError()
        ep = m.client_urls[0]
        from ..client.client import ClientError
        try:
            c = self._leader_fwd_client(ep)
            resp = c._request(
                "LeaseKeepAlive",
                {"id": lease_id, "local_only": True}, timeout=2.0)
            return resp["ttl"]
        except Exception as exc:  # noqa: BLE001 — surface as NotLeader
            app_level = isinstance(exc, ClientError) and exc.etype not in (
                "ConnectionError", "Timeout", "Closed")
            if not app_level:
                # Transport-level failure: the cached channel is suspect.
                # Application errors rode a healthy connection; keep it.
                with self._fwd_lock:
                    cli = self._fwd_clients.pop(ep, None)
                if cli is not None:
                    try:
                        cli.close()
                    except Exception:  # noqa: BLE001
                        pass
            if isinstance(exc, ClientError) and exc.etype in (
                    "LeaseNotFoundError", "LeaseExpiredError"):
                raise LeaseNotFoundError(str(lease_id)) from exc
            raise NotLeaderError() from exc

    def _leader_fwd_client(self, ep: str):
        """Cached member→leader client channel for renew forwarding.
        Dials outside _fwd_lock so a slow/unreachable leader cannot
        serialize every concurrent renew behind one connect."""
        from ..client.client import Client
        from ..embed.config import parse_urls
        with self._fwd_lock:
            c = self._fwd_clients.get(ep)
        if c is not None:
            return c
        host, port = parse_urls(ep)[0]
        tls = self.cfg.client_tls_info if ep.startswith("https") else None
        c = Client([(host, port)], dial_timeout=1.0,
                   request_timeout=2.0, tls_info=tls)
        with self._fwd_lock:
            prev = self._fwd_clients.get(ep)
            if prev is not None:  # raced: keep the first, drop ours
                winner, loser = prev, c
            else:
                self._fwd_clients[ep] = c
                winner, loser = c, None
        if loser is not None:
            try:
                loser.close()
            except Exception:  # noqa: BLE001
                pass
        return winner

    def lease_time_to_live(self, lease_id: int, keys: bool = False):
        lease = self.lessor.lookup(lease_id)
        if lease is None:
            return None
        rem = lease.remaining()
        return {
            "id": lease_id,
            "ttl": int(rem) if rem != float("inf") else lease.ttl,
            "granted_ttl": lease.ttl,
            "keys": lease.keys() if keys else [],
        }

    def lease_leases(self) -> List[int]:
        return [l.id for l in self.lessor.leases()]

    def _lease_checkpoint_via_raft(self, lease_id: int, remaining: int) -> None:
        req = LeaseCheckpointRequest(
            checkpoints=[LeaseCheckpoint(id=lease_id, remaining_ttl=remaining)]
        )
        try:
            self.process_internal_raft_request("lease_checkpoint", req)
        except Exception:  # noqa: BLE001 — best-effort
            pass

    def _expired_lease_loop(self) -> None:
        """ref: server.go run() lessor expiry case → LeaseRevoke."""
        while not self._stopped.is_set():
            leases = self.lessor.expired_leases(timeout=0.2)
            for lease in leases:
                if self._stopped.is_set():
                    return
                try:
                    self.lease_revoke(lease.id)
                except Exception:  # noqa: BLE001 — retried by the lessor
                    pass

    # -- linearizable reads (v3_server.go:738-905) -----------------------------

    def linearizable_read_notify(self, timeout: Optional[float] = None) -> None:
        """Block until a read-index round that started after this call
        confirms (ref: v3_server.go:896-905)."""
        timeout = timeout or self.cfg.request_timeout
        with self._read_mu:
            if self._read_notifier is None:
                self._read_notifier = _Notifier()
            nc = self._read_notifier
        self._read_waitc.set()
        err = nc.wait(timeout)
        if err is not None:
            raise err

    def _linearizable_read_loop(self) -> None:
        while not self._stopped.is_set():
            if not self._read_waitc.wait(timeout=0.2):
                continue
            self._read_waitc.clear()
            with self._read_mu:
                nr = self._read_notifier
                self._read_notifier = _Notifier()
            if nr is None:
                continue
            try:
                confirmed = self._request_current_index()
                # Wait for apply to catch up to the confirmed index.
                self.apply_wait.wait(confirmed).wait(
                    timeout=self.cfg.request_timeout
                )
                nr.notify(None)
            except Exception as e:  # noqa: BLE001
                nr.notify(e)

    def _request_current_index(self) -> int:
        """ref: v3_server.go:795-874 requestCurrentIndex."""
        rctx = os.urandom(8)
        self.node.read_index(rctx)
        deadline = time.monotonic() + self.cfg.request_timeout
        retry_at = time.monotonic() + READ_INDEX_RETRY_TIME
        while time.monotonic() < deadline:
            with self._read_states_cv:
                states, self._read_states = self._read_states, []
                if not states:
                    self._read_states_cv.wait(timeout=0.05)
                    states, self._read_states = self._read_states, []
            for rs in states:
                if rs.request_ctx == rctx:
                    return rs.index
            if time.monotonic() >= retry_at:
                # Leader may have changed or dropped it; re-request.
                smet.slow_read_indexes.inc()
                self.node.read_index(rctx)
                retry_at = time.monotonic() + READ_INDEX_RETRY_TIME
        smet.read_indexes_failed.inc()
        raise TimeoutError_("read index not confirmed")

    # -- auth API (replicated; v3_server.go AuthEnable etc.) -------------------

    def auth_enable(self, token: Optional[str] = None):
        return self.process_internal_raft_request(
            "auth", AuthRequest(op="enable"), token
        ).resp

    def auth_disable(self, token: Optional[str] = None):
        return self.process_internal_raft_request(
            "auth", AuthRequest(op="disable"), token
        ).resp

    def authenticate(self, name: str, password: str) -> str:
        """Token mint (reference replicates Authenticate for simple-token
        state; our token providers are node-local, so check+assign is
        local — clients stick to one endpoint for simple tokens)."""
        return self.auth_store.authenticate(name, password)

    def auth_op(self, req: AuthRequest, token: Optional[str] = None):
        return self.process_internal_raft_request("auth", req, token).resp

    # -- alarms / maintenance --------------------------------------------------

    def alarm(self, req: AlarmRequest, token: Optional[str] = None):
        if req.action == AlarmAction.GET:
            from .api import AlarmResponse

            return AlarmResponse(
                header=self.response_header(), alarms=self.alarms.get(req.alarm)
            )
        return self.process_internal_raft_request("alarm", req, token).resp

    def quota_available(self, r: InternalRaftRequest) -> bool:
        """ref: storage/quota.go backendQuota.Available."""
        # Cost model: current size + a coarse per-request overhead.
        cost = 512
        if r.op == "put":
            cost += len(r.req.key) + len(r.req.value)
        return self.be.size() + cost < self.cfg.quota_bytes

    def maybe_raise_nospace_alarm(self) -> None:
        if AlarmType.NOSPACE in self.alarms.active_types():
            return

        def _raise() -> None:
            try:
                self.alarm(
                    AlarmRequest(
                        action=AlarmAction.ACTIVATE,
                        member_id=self.id,
                        alarm=AlarmType.NOSPACE,
                    )
                )
            except Exception:  # noqa: BLE001
                pass

        threading.Thread(target=_raise, daemon=True).start()

    def hash_kv(self, rev: int = 0):
        return self.kv.hash_kv(rev)

    # -- v2 legacy surface (ref: etcdserver/apply_v2.go, v2store) --------------

    def _apply_v2(self, r: InternalRaftRequest):
        """Interpret a committed v2 op against the in-memory v2 store
        (ref: apply_v2.go applierV2 Put/Post/Delete/QGet)."""
        q = dict(r.req)
        st = self.v2store
        if "expire_at" in q:
            # Remaining TTL at apply time; non-positive applies as an
            # immediately-expirable sliver (the key was already dead).
            q["ttl"] = max(q["expire_at"] - time.time(), 1e-6)
        try:
            method = q["method"]
            path = q["path"]
            if method == "set":
                ev = st.set(path, dir_=q.get("dir", False),
                            value=q.get("value", ""), ttl=q.get("ttl"))
            elif method == "create":
                ev = st.create(path, dir_=q.get("dir", False),
                               value=q.get("value", ""), ttl=q.get("ttl"),
                               unique=q.get("unique", False))
            elif method == "update":
                ev = st.update(path, value=q.get("value", ""),
                               ttl=q.get("ttl"))
            elif method == "cas":
                ev = st.compare_and_swap(
                    path, q.get("prev_value"), q.get("prev_index", 0),
                    q.get("value", ""), ttl=q.get("ttl"))
            elif method == "cad":
                ev = st.compare_and_delete(
                    path, q.get("prev_value"), q.get("prev_index", 0))
            elif method == "delete":
                ev = st.delete(path, recursive=q.get("recursive", False),
                               dir_=q.get("dir", False))
            else:
                raise ValueError(f"unknown v2 method {method!r}")
            return ApplyResult(resp=ev)
        except Exception as e:  # noqa: BLE001 — V2Error travels to waiter
            return ApplyResult(err=e)

    def v2_write(self, method: str, path: str, **kwargs):
        """Replicated v2 mutation: proposed through raft like every
        other write (ref: v2http → etcdserver Do → raft)."""
        req = {"method": method, "path": path}
        req.update({k: v for k, v in kwargs.items() if v is not None})
        # TTLs replicate as ABSOLUTE expiration set at proposal time
        # (ref: v2http sets Expiration before etcdserver.Do), so WAL
        # replay cannot resurrect long-expired keys.
        if req.get("ttl") is not None:
            req["expire_at"] = time.time() + float(req.pop("ttl"))
        out = self.process_internal_raft_request("v2", req, None)
        return out.resp

    def v2_get(self, path: str, recursive: bool = False,
               sorted_: bool = False):
        """Local read of the v2 store (the reference's default
        non-quorum GET path)."""
        return self.v2store.get(path, recursive=recursive, sorted_=sorted_)

    def defrag(self) -> None:
        self.be.defrag()

    # -- membership ops (server.go:1265-1537) ----------------------------------

    def add_member(self, member: Member, timeout: Optional[float] = None):
        cc = ConfChange(
            id=self.idgen.next(),
            type=(
                ConfChangeType.ConfChangeAddLearnerNode
                if member.is_learner
                else ConfChangeType.ConfChangeAddNode
            ),
            node_id=member.id,
            context=member.marshal(),
        )
        return self._propose_conf_change(cc, timeout)

    def remove_member(self, mid: int, timeout: Optional[float] = None):
        cc = ConfChange(
            id=self.idgen.next(),
            type=ConfChangeType.ConfChangeRemoveNode,
            node_id=mid,
        )
        return self._propose_conf_change(cc, timeout)

    # A learner is promotable once its match index covers >= 90% of the
    # leader's (ref: server.go:1473 readyPercent).
    _LEARNER_READY_PERCENT = 0.9

    def _is_learner_ready(self, mid: int) -> None:
        """Catch-up gate for promotion (ref: server.go:1446
        isLearnerReady): from the leader's progress view, the learner's
        match index must cover >= readyPercent of the leader's own
        match. Raises LearnerNotReadyError while the learner is still
        catching up, NotLeaderError when this member has no progress
        view (only the leader tracks match indexes)."""
        st = self.node.status()
        if not st.progress:
            if self.is_leader():
                # Leader on a backend whose status() carries no
                # per-peer progress view (the batched/tpu node tracks
                # match on device only): nothing to gate on — allow,
                # as before the gate existed. Raising NotLeaderError
                # here would make promotion permanently impossible
                # (clients fail over member-by-member forever).
                return
            # Follower: only the leader tracks match indexes.
            raise NotLeaderError()
        learner_match = st.progress[mid].match if mid in st.progress else 0
        leader_match = st.progress[st.id].match if st.id in st.progress else 0
        if leader_match == 0 or (
            float(learner_match)
            < float(leader_match) * self._LEARNER_READY_PERCENT
        ):
            raise LearnerNotReadyError(
                f"learner {mid:x} match {learner_match} has not caught "
                f"up to leader match {leader_match} "
                f"(need >= {self._LEARNER_READY_PERCENT:.0%})")

    def promote_member(self, mid: int, timeout: Optional[float] = None):
        """Learner → voter, gated on readiness (server.go:1446 isLearnerReady)."""
        m = self.cluster.member(mid)
        if m is None or not m.is_learner:
            raise ValueError(f"member {mid} is not a learner")
        self._is_learner_ready(mid)
        cc = ConfChange(
            id=self.idgen.next(),
            type=ConfChangeType.ConfChangeAddNode,
            node_id=mid,
            context=json.dumps({"promote": True, **json.loads(m.marshal())}).encode(),
        )
        result = self._propose_conf_change(cc, timeout)
        self.cluster.promote_member(mid)
        if self.is_leader():
            smet.learner_promote_succeed.inc()
        return result

    def _propose_conf_change(self, cc: ConfChange, timeout: Optional[float]):
        waiter = self.w.register(cc.id)
        self.node.propose_conf_change(
            cc, timeout=timeout or self.cfg.request_timeout
        )
        result = waiter.wait(timeout=timeout or self.cfg.request_timeout)
        if result is None:
            raise TimeoutError_()
        return result.resp

    # -- introspection ---------------------------------------------------------

    def response_header(self) -> ResponseHeader:
        return ResponseHeader(
            cluster_id=self.cluster_id,
            member_id=self.id,
            revision=self.kv.rev(),
            raft_term=self._term,
        )

    def is_leader(self) -> bool:
        with self._lead_lock:
            return self._lead == self.id

    def leader(self) -> int:
        with self._lead_lock:
            return self._lead

    def applied_index(self) -> int:
        return self._applied_index

    def committed_index(self) -> int:
        return self._committed_index

    def stop(self) -> None:
        if self._stopped.is_set():
            return
        self._stopped.set()
        self.network.unregister(self.id)
        if self.corruption_checker is not None:
            self.corruption_checker.stop()
        if self.compactor is not None:
            self.compactor.stop()
        self.node.stop()
        with self._fwd_lock:
            fwd, self._fwd_clients = list(self._fwd_clients.values()), {}
        for c in fwd:
            try:
                c.close()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        for t in self._threads:
            if t.is_alive():
                t.join(timeout=5)
        self.sched.stop()
        self.kv.stop_sync_loop()
        self.lessor.stop()
        self.wal.close()
        self.be.close()


class _Notifier:
    """One read-round completion broadcast (ref: v3_server.go notifier)."""

    def __init__(self) -> None:
        self._ev = threading.Event()
        self._err: Optional[Exception] = None

    def notify(self, err: Optional[Exception]) -> None:
        self._err = err
        self._ev.set()

    def wait(self, timeout: float) -> Optional[Exception]:
        if not self._ev.wait(timeout=timeout):
            return TimeoutError_("linearizable read timeout")
        return self._err


class _LeaseDeleterTxn:
    """Lease revoke deletes attached keys through a normal mvcc write txn
    (ref: server.go:594-600 lessor.SetRangeDeleter with kv.Write)."""

    def __init__(self, server: EtcdServer) -> None:
        self.s = server
        self._txn = server.kv.write()
        self._txn.__enter__()

    def delete_range(self, key: bytes, end: Optional[bytes]) -> None:
        self._txn.delete_range(key, end)

    def end(self) -> None:
        self._txn.__exit__(None, None, None)
