"""Multi-raft hosting: G consensus groups served by R member processes,
each member stepping its replica slot of EVERY group in one device
program per round.

This is the scale-out shape the reference's raft library was designed
for but never shipped a host for ("systems which have thousands of Raft
groups per process", ref: raft/tracker/inflights.go:71-73): a
``MultiRaftMember`` owns

* a ``BatchedRawNode`` over rows = G groups (slot = this member),
* ONE write-ahead log for all groups (the native C++ segmented WAL,
  records framed with a group id; one fsync covers every group's
  hardstate+entries for the round — the batched analog of wal.Save,
  ref: server/storage/wal/wal.go:920-953),
* a per-group KV apply target (the 1k-shard KV service),
* a round loop enforcing the reference's ordering per group:
  persist (fsync) → apply → send → advance
  (ref: server/etcdserver/raft.go:226-268; apply-before-send lets
  outbound snapshot messages carry app state at an index ≥ the device
  ring floor),
* a per-group **durable watermark** WAL-recorded ahead of every entry
  batch, so ``_replay`` can detect destroyed fsync'd-acked bytes (torn
  tails beyond raft's durability model) and boot the damaged groups
  **fenced** — out of elections until the probe/snapshot catch-up
  restores the durable log ("Protocol-Aware Recovery for
  Consensus-Based Storage", FAST'18),
* an optional **async group-commit WAL pipeline** (``wal_pipeline``):
  persistence runs on a dedicated WAL-commit worker instead of inline
  in the Ready drain. Producers append pre-serialized record batches
  to an open double buffer and continue into the next device
  round immediately; the worker swaps the buffer, writes it, runs ONE
  fsync covering every batch queued since the last one (bounded by a
  max-delay / max-bytes accumulation window), and only then releases
  the covered batches' acks, sends and applies — persist-before-
  ack/send preserved by the ordered release barrier, never by timing
  (the decoupling the reference's asynchronous-storage-writes design
  permits: raft only requires persist before ack/send, not before the
  next round).

Members exchange per-round message batches. ``InProcRouter`` wires
members in one process (tests, single-host demos); the TCP fabric for
real deployments reuses the same ``deliver()`` entry point.

Ports ``etcd_tpu/batched/hosting.py``. The port differs in one
parameter: ``MultiRaftMember`` and ``MultiRaftCluster`` take
``device=`` and hand it to ``BatchedRawNode`` (default: the GPU), and
``mesh_devices > 0`` is refused (ROADMAP A12). Every other line is the
reference's, pinned by tests/test_torch_hosting.py.
"""

from __future__ import annotations

import json
import logging
import os
import queue as queue_mod
import random
import struct
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..native.walog import (
    TAIL_CLEAN,
    TAIL_CORRUPT,
    TAIL_NAMES,
    Walog,
    WalogError,
    is_disk_full,
    read_all_classified as wal_read_all_classified,
    salvage as wal_salvage,
)
from ..obs.tracer import make_tracer
from ..pkg.failpoint import FailpointPanic, fp
from ..raft.confchange import ConfChangeError
from ..storage.snap import NoSnapshotError, Snapshotter
from ..raft.types import (
    ConfChangeSingle,
    ConfChangeTransition,
    ConfChangeType,
    ConfChangeV2,
    EntryType,
    Message,
    MessageType,
    Snapshot,
    SnapshotMetadata,
)
from .membership import GroupConfStore, decode_conf_entry
from .rawnode import BatchedRawNode, BatchedReady, RowRestore, _refuse
from .state import BatchedConfig, LEADER
from .step import T_SNAP
from .telemetry import (
    TelemetryHub,
    disk_fault_failstop_counter,
    disk_fault_salvage_counter,
    disk_full_gauge,
    fenced_groups_gauge,
    joint_groups_gauge,
    learner_slots_gauge,
    round_phase_histogram,
    router_loss_counter,
    wal_fsync_histogram,
)


from ..pkg.errors import NotLeaderError  # noqa: E402 — shared error type

_log = logging.getLogger("etcd_tpu.batched.hosting")

# WAL record types (the native walog carries opaque frames; these tags
# make one log serve every group — ref: walpb's entry/state/snapshot
# record types, server/storage/wal/walpb/record.pb.go).
RT_ENTRY = 1  # group:u32 index:u64 term:u64 len:u32 data
RT_HARDSTATE = 2  # group:u32 term:u64 vote:u32 commit:u64
RT_SNAPSHOT = 3  # same layout as RT_ENTRY; data = app snapshot
# Durable watermark (protocol-aware torn-tail recovery, FAST'18): the
# per-group (last_index, last_term, commit) this member is about to
# make durable. Written FIRST in every persistence batch that appends
# entries, fsync'd with the batch — so a tail cut that destroys the
# batch's fsync'd entry records leaves their watermark behind, and
# _replay can tell "acked bytes lost" (fence the group) from "crash
# before the write" (nothing to do).
RT_WATERMARK = 4  # group:u32 last:u64 last_term:u64 commit:u64
# One record for a whole Ready's entries, numpy-serialized:
# u32 count | count * WAL_ENT_DTYPE headers | payloads back to back.
# Replaces per-entry RT_ENTRY records on the write path (RT_ENTRY still
# replays for logs written before the batch format); the watermark
# ordering contract is unchanged — a tear anywhere inside the batch
# record destroys it wholesale, and the preceding RT_WATERMARK records
# still demand every entry it carried.
RT_ENTRY_BATCH = 5
# Batched twins of RT_HARDSTATE / RT_WATERMARK, numpy-serialized:
# u32 count | count * WAL_*_DTYPE rows. A steady round writes hundreds
# of hardstate/watermark records per member; one structured-array
# tobytes replaces that many struct.pack + ctypes append calls.
RT_HS_BATCH = 6
RT_WM_BATCH = 7
# Per-group membership configs, numpy-serialized full-state rows
# (membership.GroupConfStore.pack_groups): written whenever committed
# conf-change entries flip a group's config and at inbound-snapshot
# conf restores, so _replay reconstructs config state without
# re-reading the whole log — latest record per group wins, and conf
# entries ABOVE the recorded watermark (committed but crashed before
# the record landed) re-apply from the recovered entries themselves.
RT_CONF_BATCH = 8
# File-snapshot markers (log-lifecycle plane): rows of (group, index,
# term) naming a snapshot FILE (storage/snap.Snapshotter, per-group
# dirs under member-N/snap/) this member made durable — the etcd
# architecture, where snapshot data lives in files and the WAL carries
# only the marker (ref: walpb.Snapshot records). A marker is trusted
# only once its covering fsync lands (the file itself is fsync'd
# BEFORE the marker is appended), and _replay loads the newest file
# matching a durable marker when the full RT_SNAPSHOT record has been
# rotated out of the WAL. Also re-recorded wholesale in every
# rotation checkpoint, so release never strands a group's only
# snapshot evidence in a reclaimed segment.
RT_SNAPMARK = 9

# Per-entry header inside an RT_ENTRY_BATCH record (packed, 25 bytes —
# the same fields as RT_ENTRY's "<IQQBI" header, SoA-serializable).
WAL_ENT_DTYPE = np.dtype([
    ("group", "<u4"), ("index", "<u8"), ("term", "<u8"),
    ("etype", "<u1"), ("len", "<u4"),
])
# Rows of RT_HS_BATCH / RT_WM_BATCH (field-compatible with the single
# records' "<IQIQ" / "<IQQQ" layouts).
WAL_HS_DTYPE = np.dtype([
    ("group", "<u4"), ("term", "<u8"), ("vote", "<u4"),
    ("commit", "<u8"),
])
WAL_WM_DTYPE = np.dtype([
    ("group", "<u4"), ("last", "<u8"), ("last_term", "<u8"),
    ("commit", "<u8"),
])
# Rows of RT_SNAPMARK (file-snapshot markers).
WAL_SNAPMARK_DTYPE = np.dtype([
    ("group", "<u4"), ("index", "<u8"), ("term", "<u8"),
])


def _pack_entry(group: int, index: int, term: int, data: bytes,
                etype: int = 0) -> bytes:
    return struct.pack("<IQQBI", group, index, term, etype, len(data)) + data


def _unpack_entry(b: bytes) -> Tuple[int, int, int, bytes, int]:
    g, i, t, et, ln = struct.unpack_from("<IQQBI", b)
    off = struct.calcsize("<IQQBI")
    return g, i, t, b[off:off + ln], et


def _pack_rows(dtype: np.dtype, cols: Dict[str, object]) -> bytes:
    """Count-prefixed structured rows — the one serializer behind every
    RT_*_BATCH record (the replay side is _unpack_batch)."""
    n = len(next(iter(cols.values())))
    rec = np.empty(n, dtype)
    for f, v in cols.items():
        rec[f] = v
    return struct.pack("<I", n) + rec.tobytes()


def _pack_entry_batch(eb) -> bytes:
    """Serialize an EntryBatch as one WAL record: one numpy header
    array + one payload join — no per-entry struct.pack."""
    hdr = _pack_rows(WAL_ENT_DTYPE, {
        "group": eb.rows, "index": eb.idx, "term": eb.term,
        "etype": eb.etype,
        "len": np.fromiter(map(len, eb.datas), np.uint32, len(eb.datas)),
    })
    return hdr + b"".join(eb.datas)


def _iter_entry_batch(b: bytes):
    """Yield (group, index, term, data, etype) from an RT_ENTRY_BATCH
    record (replay path)."""
    (n,) = struct.unpack_from("<I", b)
    hdr = np.frombuffer(b, WAL_ENT_DTYPE, count=n, offset=4)
    off = 4 + n * WAL_ENT_DTYPE.itemsize
    lens = hdr["len"].tolist()
    for g, i, t, et, ln in zip(hdr["group"].tolist(),
                               hdr["index"].tolist(),
                               hdr["term"].tolist(),
                               hdr["etype"].tolist(), lens):
        yield g, i, t, b[off:off + ln], et
        off += ln


def _unpack_batch(b: bytes, dtype: np.dtype) -> np.ndarray:
    """Header-counted structured rows of an RT_HS_BATCH / RT_WM_BATCH
    record."""
    (n,) = struct.unpack_from("<I", b)
    return np.frombuffer(b, dtype, count=n, offset=4)


def _pack_hs(group: int, term: int, vote: int, commit: int) -> bytes:
    return struct.pack("<IQIQ", group, term, vote, commit)


def _unpack_hs(b: bytes) -> Tuple[int, int, int, int]:
    return struct.unpack_from("<IQIQ", b)


def _pack_snap(group: int, index: int, term: int, data: bytes) -> bytes:
    # Same layout as entries (etype byte unused for snapshots).
    return _pack_entry(group, index, term, data)


_unpack_snap = _unpack_entry


def _env_wal_pipeline() -> bool:
    """ETCD_TPU_WAL_PIPELINE: default for members constructed with
    wal_pipeline=None (the hosted_bench / hosting_proc env knob)."""
    from ..pkg import env_flag

    return env_flag("ETCD_TPU_WAL_PIPELINE")


# Group-commit accumulation defaults (overridable per member and via
# env): after the first pending batch the WAL-commit worker waits up to
# max_delay for more rounds' batches to queue (one fsync then covers
# them all), cutting the wait short once max_bytes are pending. 0 delay
# means fsync as soon as the worker gets the buffer — batching then
# comes only from rounds that queue WHILE an fsync is in flight, which
# on a real disk (fsync >> round) is already most of the win.
# KNOB HAZARD: every outbound message — vote responses included —
# rides the release barrier (raft requires the vote/hardstate durable
# before the grant leaves), so a max_delay rivaling the election
# timeout (election_timeout ticks x tick_interval) delays vote acks
# past it and starves elections. Keep max_delay well under a quarter
# of the timeout.
WAL_GROUP_MAX_DELAY_S = 0.0
WAL_GROUP_MAX_BYTES = 4 << 20

# Log-lifecycle plane defaults (member args, like the pipeline knobs —
# never BatchedConfig fields: host-only, must not fork a compile).
# snap_cadence / wal_rotate_bytes default to None = OFF, preserving
# pre-lifecycle behavior for every existing caller.
SNAP_KEEP_DEFAULT = 2        # snapshot files retained per group
WAL_LIFECYCLE_TICK_S = 0.05  # commit-worker idle lifecycle cadence
SNAP_BUILD_MAX_PER_PASS = 64  # due-group snapshot builds per drain
# pass — bounds the work a single pass steals from the round loop (the
# most-overdue groups go first; the rest catch the next pass)
WAL_PINNED_SEGMENTS = 4      # sealed-but-unreleasable segments before
# the counted wal_pinned anomaly fires (a stuck group must become
# protocol-visible instead of silently pinning disk)


class _PersistGroup:
    """One submitted persistence batch riding the WAL pipeline: the
    pre-serialized records (built under _lock, so record order ==
    submission order == lock order), the Readys whose acks/sends/apply
    it gates, the per-row durable-watermark deltas to fold into the
    mirrors once the covering fsync lands, and the snapshot-install
    generations captured at submit (a MsgSnap restore racing ahead of
    this batch's fsync supersedes its mirror deltas — see
    _apply_wm_locked)."""

    __slots__ = ("records", "readys", "wm", "gens", "must_sync",
                 "nbytes", "t_submit", "on_synced", "traced")

    def __init__(self, records, readys, wm, gens, must_sync,
                 on_synced=None, traced=()):
        self.records = records
        self.readys = readys
        self.wm = wm
        self.gens = gens
        self.must_sync = must_sync
        self.nbytes = sum(len(d) for _rt, d in records)
        self.t_submit = time.monotonic()
        self.on_synced = on_synced
        self.traced = traced


def _pack_wm(group: int, last: int, last_term: int, commit: int) -> bytes:
    return struct.pack("<IQQQ", group, last, last_term, commit)


def _unpack_wm(b: bytes) -> Tuple[int, int, int, int]:
    return struct.unpack_from("<IQQQ", b)


class GroupKV:
    """The applied state machine of one group: a KV map fed committed
    payloads ``op key \\x00 value`` (ref: contrib/raftexample/kvstore.go
    gob-encoded kv pairs; here a flat length-prefixed frame)."""

    def __init__(self) -> None:
        self.data: Dict[bytes, bytes] = {}

    def apply(self, payload: bytes) -> None:
        op, rest = payload[:1], payload[1:]
        if op == b"P":
            k, v = rest.split(b"\x00", 1)
            self.data[k] = v
        elif op == b"E":
            # Expiring put (apply-plane lease form, applyplane.py:
            # u32be TTL then the P layout). The host tier stores the
            # bytes and ignores the TTL — expiry visibility is
            # leader-local (the device lessor masks lease reads, ref:
            # etcd's leader-driven lessor), so the replicated byte
            # state stays identical across members with or without
            # the plane.
            k, v = rest[4:].split(b"\x00", 1)
            self.data[k] = v
        elif op == b"D":
            self.data.pop(rest, None)

    def snapshot(self) -> bytes:
        return json.dumps(
            {k.hex(): v.hex() for k, v in self.data.items()}
        ).encode()

    def restore(self, blob: bytes) -> None:
        self.data = {
            bytes.fromhex(k): bytes.fromhex(v)
            for k, v in json.loads(blob.decode()).items()
        } if blob else {}

    @staticmethod
    def put_payload(key: bytes, value: bytes) -> bytes:
        return b"P" + key + b"\x00" + value

    @staticmethod
    def delete_payload(key: bytes) -> bytes:
        return b"D" + key


def _split_snap_blob(blob: bytes):
    """Decode a snapshot app blob in either on-disk/wire format: the
    legacy host-tier dump (a flat hex dict) or the two-tier apply-plane
    wrapper ({"host": ..., "plane": ...}). Returns (host key->value
    dict, plane image dict or None)."""
    if not blob:
        return {}, None
    d = json.loads(blob.decode())
    img = None
    if "host" in d and "plane" in d:
        img = d["plane"]
        d = d["host"]
    return {
        bytes.fromhex(k): bytes.fromhex(v) for k, v in d.items()
    }, img


class MultiRaftMember:
    """One member process: slot `member_id-1` of every group."""

    def __init__(
        self,
        member_id: int,
        num_members: int,
        num_groups: int,
        data_dir: str,
        cfg: Optional[BatchedConfig] = None,
        tick_interval: float = 0.02,
        send_fn: Optional[Callable[[int, List[Tuple[int, Message]]], None]] = None,
        pipeline: bool = True,
        mesh_devices: int = 0,
        fence: bool = True,
        trace: Optional[bool] = None,
        wal_pipeline: Optional[bool] = None,
        wal_group_max_delay: Optional[float] = None,
        wal_group_max_bytes: Optional[int] = None,
        disk_fault_hook: Optional[Callable[[str, int], None]] = None,
        snap_cadence: Optional[int] = None,
        snap_keep: int = SNAP_KEEP_DEFAULT,
        wal_rotate_bytes: Optional[int] = None,
        wal_pinned_segments: int = WAL_PINNED_SEGMENTS,
        device=None,
    ) -> None:
        if mesh_devices:
            _refuse(f"MultiRaftMember(mesh_devices={mesh_devices})", "mesh")
        self.id = member_id
        self.slot = member_id - 1
        self.g = num_groups
        self.cfg = cfg or BatchedConfig(
            num_groups=num_groups,
            num_replicas=num_members,
            window=64,
            max_ents_per_msg=8,
            max_props_per_round=4,
            election_timeout=10,
            heartbeat_timeout=1,
            pre_vote=True,
            check_quorum=True,
            auto_compact=True,  # floor chases applied; snapshots are
            # generated on demand at send time (apply-before-send keeps
            # host state ≥ floor)
        )
        assert self.cfg.num_groups == num_groups
        self.dir = os.path.join(data_dir, f"member-{member_id}")
        os.makedirs(self.dir, exist_ok=True)
        self.kvs = [GroupKV() for _ in range(num_groups)]
        self.applied_index = np.zeros(num_groups, np.int64)
        # Device apply plane: with cfg.apply_plane the host
        # KV above becomes the shadow/overflow BYTE tier (the device
        # stores 31-bit key/value hashes + revision/lease lanes);
        # linearizable reads route lease-first (linearizable_get) and
        # snapshot capture gathers the device tensors. _boot_plane
        # stashes per-group plane images decoded during _replay (the
        # rawnode does not exist yet there) for post-boot staging.
        self._boot_plane: Dict[int, Dict] = {}
        # Groups with a leadership transfer staged on this member:
        # lease reads refuse until the device round zeroes the lease
        # lane (MsgTimeoutNow lets the target campaign without waiting
        # an election timeout, so the tick-silence safety argument
        # does not cover the staging window).
        self._lease_block: set = set()
        self._watch_next = np.zeros(num_groups, np.int64)
        self._watches: Dict[Tuple[int, int], bytes] = {}
        self._send = send_fn  # set by the router/transport
        # Block fast path (SoA frames, see msgblock.py); routers that
        # support it set this, others get the object fallback.
        self._send_block: Optional[Callable[[int, "object"], None]] = None
        self._lock = threading.Lock()
        self._work = threading.Event()  # wakes the round loop
        # Simulated-kill flag (see crash()): once set (under _lock) the
        # WAL handle is closed and every persistence/apply path bails
        # out, so queued-but-unsaved Readys are lost like a real kill.
        self._crashed = False
        self._wal_tail_at_crash = 0  # last segment's write offset
        # gofail-style storage failpoints on the persistence path
        # (ref: etcdserver/raft.go raftBeforeSave/raftAfterSave); chaos
        # harnesses enable them per-member by these names.
        self._fp_before_save = f"hosting.m{member_id}.raftBeforeSave"
        self._fp_after_save = f"hosting.m{member_id}.raftAfterSave"
        # Pipeline-aware kill point: fires on the WAL-commit
        # worker AFTER the wave's records are written to the fd but
        # BEFORE the covering fsync/release — a crash here leaves a
        # written-but-unfsynced tail whose batches were never acked,
        # exactly the window the async pipeline introduces.
        self._fp_before_release = (
            f"hosting.m{member_id}.raftBeforeFsyncRelease")
        # Wall-seconds per phase of the member pipeline (ETCD_TPU_PROF
        # companion at the hosting layer; read via the admin 'prof' op).
        self.stats = {"rounds": 0, "round_s": 0.0, "wal_s": 0.0,
                      "apply_s": 0.0, "send_s": 0.0, "batched": 0}
        self.tick_interval = tick_interval
        # ReadIndex bookkeeping for linearizable readers: the latest
        # OPENED batch seq per group (readers bind to a batch opened
        # at-or-after their request — an earlier batch's index may
        # predate a write the reader has already observed) and the
        # latest CONFIRMED (seq, index).
        self._read_opened: Dict[int, int] = {}
        self._read_results: Dict[int, Tuple[int, int]] = {}
        self._read_cv = threading.Condition()

        # Durability fencing (protocol-aware torn-tail recovery): the
        # watermark arrays hold the highest per-group (last, last_term,
        # commit) this member ever WAL-recorded as durable; the _dur
        # arrays track what actually IS durable right now. _replay
        # fences any group whose recovered log fell below its watermark
        # — acked bytes were destroyed — and the fence lifts when the
        # durable log is back at the watermark (_maybe_lift_fences).
        self.fence_enabled = bool(fence)
        self._wm_last = np.zeros(num_groups, np.int64)
        self._wm_term = np.zeros(num_groups, np.int64)
        self._wm_commit = np.zeros(num_groups, np.int64)
        self._dur_last = np.zeros(num_groups, np.int64)
        self._dur_term = np.zeros(num_groups, np.int64)
        self._dur_commit = np.zeros(num_groups, np.int64)
        self._fenced = np.zeros(num_groups, bool)
        self._tail_state: Optional[int] = None  # walog TAIL_* at boot
        self._boot_fenced = 0
        self._g_fenced = fenced_groups_gauge().labels(str(member_id))

        # IO-error contract state. disk_fault_hook is the
        # storage fault plane's seam, threaded into the Walog handle
        # below; _disk_full flips while WAL writes refuse at that seam
        # with an ENOSPC-class error (write-back-pressure: proposals
        # refuse, nothing acks, recovery is automatic once space
        # returns); _fail_stop_cause records why a storage fault
        # crash-killed this member (health op surfaces both);
        # _salvage records an at-rest-corruption amputation at boot.
        self._disk_fault_hook = disk_fault_hook
        self._disk_full = False
        self._fail_stop_cause: Optional[str] = None
        self._salvage: Optional[Dict] = None
        self._g_disk_full = disk_full_gauge().labels(str(member_id))
        self._c_failstop = disk_fault_failstop_counter()

        # Per-group membership configs (joint-consensus control plane,
        # the replicated log drives it — committed
        # EntryConfChange/V2 entries apply here, flip the device
        # voter/learner/in_joint lanes via one bulk mask upload, and
        # WAL-record the result (RT_CONF_BATCH) so _replay reconstructs
        # config state across crashes. Guarded by _lock.
        self.conf = GroupConfStore(num_groups, self.cfg.num_replicas)
        self._g_joint = joint_groups_gauge().labels(str(member_id))
        self._g_learners = learner_slots_gauge().labels(str(member_id))
        # Auto-leave-joint re-proposal cooldowns (row -> monotonic s):
        # the leave is proposed at the joint entry's apply on the
        # leader; the sweep in run_round is the fallback for groups
        # whose leadership moved mid-joint.
        self._joint_prop: Dict[int, float] = {}
        self._next_joint_sweep = 0.0

        # Log-lifecycle plane (cadence snapshots, WAL rotation/release,
        # ring back-pressure). Both knobs default OFF; the state below
        # is initialized before _replay() because replay reconstructs
        # it from the surviving segments. All guarded by _lock except
        # where noted.
        self.snap_cadence = (
            None if snap_cadence is None else max(1, int(snap_cadence)))
        self.snap_keep = max(1, int(snap_keep))
        self.wal_rotate_bytes = (
            None if wal_rotate_bytes is None else int(wal_rotate_bytes))
        self.wal_pinned_segments = max(1, int(wal_pinned_segments))
        # Newest durable FILE snapshot per group (what cadence measures
        # against and rotation checkpoints re-record as RT_SNAPMARK).
        self._snap_file_idx = np.zeros(num_groups, np.int64)
        self._snap_file_term = np.zeros(num_groups, np.int64)
        # Release-math cover per group: the newest snapshot EVIDENCE
        # (file marker or RT_SNAPSHOT install record) at _snap_cover[g],
        # whose WAL record lives in segment _snap_seq[g]. A sealed
        # segment s is reclaimable only when, for every group with
        # entries in s (cap > 0), cover >= cap AND the evidence sits in
        # a LATER segment than s — releasing the evidence with the
        # segment would turn the snapshot into an unprovable file.
        self._snap_cover = np.zeros(num_groups, np.int64)
        self._snap_seq = np.zeros(num_groups, np.int64)
        # Sealed (cut) segments awaiting release, oldest first:
        # {"seq", "meta", "cap"} where cap[g] = g's durable last index
        # at seal time (every entry the segment holds is <= cap[g]).
        self._sealed: List[Dict] = []
        self._wal_meta = 0          # current tail segment's meta
        self._ckpt_seq = -1         # seq of the last durable checkpoint
        self._need_ckpt = False     # rotation happened / boot-with-
        # history: (re)write the full-state checkpoint into the tail
        self._last_sync_seq = 0     # tail seq at the last fsync (set
        # under _wal_io; read by the install cover fold)
        self._tail_ckpt_bytes = 0   # checkpoint bytes in the current
        # tail: the cut threshold EXCLUDES them, or at large G a
        # checkpoint bigger than wal_rotate_bytes would cut-storm
        # (every cut writes a checkpoint that immediately re-arms the
        # next cut)
        self._wal_pinned_flag = False
        self._pinned_group = -1
        self._ring_occ_hw = 0       # ring-occupancy high-water (host)
        self._snap_file_count = 0
        self._snappers: Dict[int, "Snapshotter"] = {}

        restore = self._replay()
        groups = np.arange(num_groups, dtype=np.int32)
        slots = np.full(num_groups, self.slot, np.int32)
        self.rn = BatchedRawNode(
            self.cfg, groups=groups, slots=slots, restore=restore,
            device=device,
        )
        # Replayed membership configs onto the device before the first
        # round: the staged masks apply at the head of advance_round,
        # ahead of any delivery/tick — a recovered group must never run
        # one round on the boot all-voter electorate.
        conf_rows = self.conf.non_default_groups()
        if len(conf_rows):
            self.rn.set_membership_many(conf_rows,
                                        *self.conf.masks(conf_rows))
        self._update_conf_gauges()
        # Proposal-lifecycle tracer (obs.tracer): sampled
        # spans stamped at every pipeline stage. trace=None defers to
        # ETCD_TPU_TRACE (off by default); purely host-side, so the
        # device program and protocol state are identical either way.
        self.tracer = make_tracer(str(member_id), enabled=trace)
        self.rn.tracer = self.tracer
        # Telemetry plane (cfg.telemetry): the rawnode folds every
        # round's kernel frame into this hub; WAL fsync latency and
        # per-phase round timings land in the same registry. With
        # telemetry off none of this is touched — the hot path is
        # unchanged.
        self.hub: Optional[TelemetryHub] = None
        self._h_fsync = None
        self._h_phase = None
        # Fleet observatory (cfg.fleet_summary, obs/fleet.py): the
        # rawnode folds every round's device SummaryFrame into this
        # hub — etcd_tpu_fleet_* families, the bounded groups×time
        # heatmap ring (admin 'fleet' op / fleet_console read it), and
        # counted anomaly flags (commit_frozen, leader_skew).
        self.fleet = None
        if self.cfg.fleet_summary:
            from ..obs.fleet import FleetHub

            self.fleet = FleetHub(
                num_groups, self.cfg.num_replicas, num_groups,
                member=str(member_id))
            self.rn.fleet_hub = self.fleet
        if self.cfg.telemetry:
            self.hub = TelemetryHub(num_groups, member=str(member_id))
            self.rn.telemetry_hub = self.hub
            mid = str(member_id)
            self._h_fsync = wal_fsync_histogram().labels(mid)
            ph = round_phase_histogram()
            # round/wal/apply/send are member-pipeline phases; stage/
            # extract/collect split the round's host-side Python (inbox
            # staging, post-round extraction, outbound block assembly)
            # so the BENCH_NOTES phase breakdown is reproducible from
            # metrics alone (dump_metrics --admin).
            self._h_phase = {
                p: ph.labels(mid, p)
                for p in ("round", "wal", "apply", "send",
                          "stage", "extract", "collect")
            }
        # Apply-plane metric children (telemetry + plane both on):
        # gauges fold from rawnode.plane_stats on the apply path, the
        # read counter moves inline in linearizable_get.
        self._m_ap_slots = self._m_ap_leases = None
        self._m_ap_overflow = self._m_ap_watch = None
        self._m_ap_hit = self._m_ap_fb = None
        self._ap_we_prev = 0
        if self.cfg.telemetry and self.cfg.apply_plane:
            from .telemetry import (
                apply_plane_leases_gauge,
                apply_plane_overflow_gauge,
                apply_plane_reads_counter,
                apply_plane_slots_gauge,
                apply_plane_watch_events_counter,
            )

            mid = str(member_id)
            self._m_ap_slots = apply_plane_slots_gauge().labels(mid)
            self._m_ap_leases = apply_plane_leases_gauge().labels(mid)
            self._m_ap_overflow = (
                apply_plane_overflow_gauge().labels(mid))
            self._m_ap_watch = (
                apply_plane_watch_events_counter().labels(mid))
            rc = apply_plane_reads_counter()
            self._m_ap_hit = rc.labels(mid, "lease_hit")
            self._m_ap_fb = rc.labels(mid, "readindex_fallback")
        if restore:
            for row, rr in restore.items():
                self.applied_index[row] = rr.applied
                # Re-apply WAL tail beyond the app snapshot: committed
                # entries land again via the first Ready (applied mirror
                # starts at the snapshot index).
            if self.rn.plane is not None:
                # Seed the device plane rows: the stashed two-tier
                # image where the snapshot carried one (exact — its
                # applied watermark makes the tail re-dispatch
                # idempotent), else a rebuild from the host byte tier
                # (legacy blob: revisions renumbered, leases dropped —
                # the documented contract, see README).
                for row, rr in restore.items():
                    img = self._boot_plane.get(row)
                    if img is not None:
                        self._plane_restore_img(row, img)
                    elif self.kvs[row].data or rr.applied:
                        self._plane_seed_from_host(row, int(rr.applied))
        wal_dir = os.path.join(self.dir, "wal")
        fresh = not (
            os.path.isdir(wal_dir)
            and any(f.endswith(".wal") for f in os.listdir(wal_dir))
        )
        self.wal = Walog(wal_dir, create=fresh,
                         fault_hook=disk_fault_hook)

        self._stopped = threading.Event()
        self._ticker = threading.Thread(target=self._tick_loop, daemon=True)
        self._runner = threading.Thread(target=self._run_loop, daemon=True)
        # Ready pipeline: the round thread hands each BatchedReady to a
        # persist/apply/send worker so the NEXT device round overlaps
        # this round's WAL fsync + apply + TCP send (the reference's
        # overlap, ref: server/etcdserver/raft.go:218-268). Bounded:
        # a slow disk backpressures the round loop after 4 rounds, so a
        # crash loses at most the queued (unacknowledged) suffix and no
        # message ever escapes before its round's fsync (ordered queue,
        # batch fsync covers every append before any send).
        self._ready_q: "queue_mod.Queue" = queue_mod.Queue(maxsize=4)
        self._drainer: Optional[threading.Thread] = (
            threading.Thread(target=self._drain_loop, daemon=True)
            if pipeline else None
        )
        # Async group-commit WAL pipeline. Knobs are member
        # args (NOT BatchedConfig fields: the round program is
        # cached per config VALUE, and a host-only knob must never fork
        # a compile); wal_pipeline=None defers to ETCD_TPU_WAL_PIPELINE.
        # Lock hierarchy (the lock-order sentinel polices it):
        # _lock -> {_wal_io, _wal_cv}; the worker takes them one at a
        # time and never holds _wal_io or _wal_cv while acquiring _lock.
        # _wal_io serializes every native-handle touch against
        # crash()/stop() closing it mid-fsync; _wal_cv guards the open
        # double buffer (_wal_pending — producers append, the worker
        # swaps the whole list out).
        if wal_pipeline is None:
            wal_pipeline = _env_wal_pipeline()
        self._wal_max_delay = (
            WAL_GROUP_MAX_DELAY_S if wal_group_max_delay is None
            else float(wal_group_max_delay))
        self._wal_max_bytes = (
            WAL_GROUP_MAX_BYTES if wal_group_max_bytes is None
            else int(wal_group_max_bytes))
        self._wal_cv = threading.Condition()
        self._wal_pending: List[_PersistGroup] = []
        self._wal_stop = False
        self._wal_io = threading.Lock()
        self._wal_closed = False
        # Snapshot-install generation per group: deliver()'s MsgSnap
        # restore bumps it at submit, and a pipeline batch whose
        # records were built under an older generation skips its mirror
        # delta for that row at fsync completion (the snapshot's state
        # supersedes it; see _apply_wm_locked).
        self._snap_gen = np.zeros(num_groups, np.int64)
        self._wal_worker: Optional[threading.Thread] = (
            threading.Thread(target=self._wal_commit_loop, daemon=True)
            if wal_pipeline else None
        )
        self._m_wal_depth = self._m_wal_batches = None
        self._m_wal_bytes = self._m_wal_release = None
        if wal_pipeline:
            from .telemetry import (
                wal_pipeline_batches_histogram,
                wal_pipeline_bytes_histogram,
                wal_pipeline_depth_gauge,
                wal_pipeline_release_histogram,
            )

            mid = str(member_id)
            self._m_wal_depth = wal_pipeline_depth_gauge().labels(mid)
            self._m_wal_batches = (
                wal_pipeline_batches_histogram().labels(mid))
            self._m_wal_bytes = wal_pipeline_bytes_histogram().labels(mid)
            self._m_wal_release = (
                wal_pipeline_release_histogram().labels(mid))

    def start(self) -> None:
        self._ticker.start()
        self._runner.start()
        if self._drainer is not None:
            self._drainer.start()
        if self._wal_worker is not None:
            self._wal_worker.start()

    # -- boot ------------------------------------------------------------------

    def _replay(self) -> Dict[int, RowRestore]:
        wal_dir = os.path.join(self.dir, "wal")
        if not os.path.isdir(wal_dir) or not os.listdir(wal_dir):
            return {}
        rows: Dict[int, RowRestore] = defaultdict(RowRestore)
        ents: Dict[int, List[Tuple[int, int, bytes]]] = defaultdict(list)
        snaps: Dict[int, Tuple[int, int, bytes]] = {}
        wms: Dict[int, Tuple[int, int, int]] = {}
        # Lifecycle evidence gathered during the scan: per-segment
        # per-group max entry index (rebuilds the sealed-segment caps),
        # snapshot-file markers per group, and the segment each
        # group's newest in-WAL snapshot evidence lives in.
        seg_caps: Dict[int, Dict[int, int]] = defaultdict(dict)
        marks: Dict[int, List[Tuple[int, int, int]]] = defaultdict(list)
        snap_src_seq: Dict[int, int] = {}

        def _cap(seq: int, g: int, i: int) -> None:
            sc = seg_caps[seq]
            if i > sc.get(g, 0):
                sc[g] = i
        # read_all_classified snapshots the tail shape BEFORE the
        # repairing read (which truncates the mid-record evidence) —
        # the ordering protocol-aware recovery rests on, kept
        # unbreakable inside the walog helper.
        try:
            records, self._tail_state = wal_read_all_classified(wal_dir)
        except WalogError:
            # At-rest corruption (a COMPLETE record failing its CRC —
            # bit-rot, not a torn crash tail): the native reader
            # refuses by design. Salvage amputates the log at the
            # first bad record; the durable-watermark pass below then
            # fences exactly the groups whose acked bytes the cut
            # destroyed, and they heal by snapshot/probe rejoin — the
            # damage becomes protocol-visible instead of unbootable.
            info = wal_salvage(wal_dir)
            if info is None:
                raise  # not a salvageable corruption: surface it
            self._salvage = info
            disk_fault_salvage_counter().labels(str(self.id)).inc()
            _log.warning(
                "member %d: at-rest WAL corruption — salvaged: %s "
                "truncated at %d (%d bytes dropped, %d later "
                "segment(s) removed); groups below their durable "
                "watermark boot FENCED", self.id, info["segment"],
                info["truncated_at"], info["bytes_dropped"],
                len(info["removed_segments"]))
            records, _ts = wal_read_all_classified(wal_dir)
            # Keep the ORIGINAL classification: the console/health
            # must report what the boot found, not the amputated
            # aftermath.
            self._tail_state = TAIL_CORRUPT
        for rtype, data, rec_seq, _meta in records:
            if rtype == RT_HARDSTATE:
                g, term, vote, commit = _unpack_hs(data)
                rr = rows[g]
                rr.term, rr.vote, rr.commit = term, vote, commit
            elif rtype == RT_ENTRY:
                g, i, t, d, et = _unpack_entry(data)
                lst = ents[g]
                while lst and lst[-1][0] >= i:
                    lst.pop()  # WAL truncate-and-append semantics
                lst.append((i, t, d, et))
                _cap(rec_seq, g, i)
            elif rtype == RT_ENTRY_BATCH:
                for g, i, t, d, et in _iter_entry_batch(data):
                    lst = ents[g]
                    while lst and lst[-1][0] >= i:
                        lst.pop()  # truncate-and-append per entry
                    lst.append((i, t, d, et))
                    _cap(rec_seq, g, i)
            elif rtype == RT_SNAPSHOT:
                g, i, t, d, _et = _unpack_snap(data)
                snaps[g] = (i, t, d)
                snap_src_seq[g] = rec_seq
                ents[g] = [e for e in ents[g] if e[0] > i]
                _cap(rec_seq, g, i)
            elif rtype == RT_WATERMARK:
                # Latest record wins: `last` legitimately moves DOWN on
                # a conflict truncation (a new leader overwriting an
                # uncommitted suffix), so a running max would
                # false-fence a healthy member.
                g, wl, wt, wc = _unpack_wm(data)
                wms[g] = (wl, wt, wc)
            elif rtype == RT_HS_BATCH:
                hs = _unpack_batch(data, WAL_HS_DTYPE)
                for g, term, vote, commit in zip(
                        hs["group"].tolist(), hs["term"].tolist(),
                        hs["vote"].tolist(), hs["commit"].tolist()):
                    rr = rows[g]
                    rr.term, rr.vote, rr.commit = term, vote, commit
            elif rtype == RT_WM_BATCH:
                wmb = _unpack_batch(data, WAL_WM_DTYPE)
                for g, wl, wt, wc in zip(
                        wmb["group"].tolist(), wmb["last"].tolist(),
                        wmb["last_term"].tolist(),
                        wmb["commit"].tolist()):
                    wms[g] = (wl, wt, wc)
            elif rtype == RT_CONF_BATCH:
                # Full-state config rows; records replay in WAL order,
                # so the last row loaded per group is the newest.
                for g, idx, flags, slots in \
                        GroupConfStore.unpack_groups(
                            data, self.cfg.num_replicas):
                    self.conf.load_record(g, idx, flags, slots)
            elif rtype == RT_SNAPMARK:
                mk = _unpack_batch(data, WAL_SNAPMARK_DTYPE)
                for g, i, t in zip(mk["group"].tolist(),
                                   mk["index"].tolist(),
                                   mk["term"].tolist()):
                    marks[g].append((i, t, rec_seq))
        # File-backed snapshots (RT_SNAPMARK): when a group's newest
        # durable marker names an index beyond any RT_SNAPSHOT record
        # still in the WAL (the full record may live in a released
        # segment), restore from the snapshot FILE. Markers are only
        # written after the file's fsync, and load_newest_available
        # skips corrupt/partial files — a missing file falls back to
        # older evidence, and any acked state thereby lost is caught
        # by the durable-watermark fence below.
        for g, cand in marks.items():
            best = max(i for i, _t, _s in cand)
            if best <= snaps.get(g, (0, 0, b""))[0]:
                continue
            try:
                snap = self._snapper(g).load_newest_available(
                    [(i, t) for i, t, _s in cand])
            except NoSnapshotError:
                continue
            md = snap.metadata
            if md.index > snaps.get(g, (0, 0, b""))[0]:
                snaps[g] = (md.index, md.term, snap.data)
                ents[g] = [e for e in ents[g] if e[0] > md.index]
                snap_src_seq[g] = max(
                    (s for i, t, s in cand
                     if i == md.index and t == md.term), default=0)
                cs = md.conf_state
                if cs is not None:
                    # Supersedes the skipped conf entries the released
                    # segments held (no-op at/below the conf
                    # watermark, same as the install path).
                    self.conf.restore(g, md.index, cs)
        restore: Dict[int, RowRestore] = {}
        for g in set(rows) | set(ents) | set(snaps):
            rr = rows[g]
            si, st_, sd = snaps.get(g, (0, 0, b""))
            # Format-aware host restore (the RT_SNAPSHOT record holds
            # the two-tier wrapper when the plane was on); the plane
            # image is stashed for staging once the rawnode exists.
            host_data, plane_img = _split_snap_blob(sd)
            self.kvs[g].data = host_data
            if plane_img is not None:
                self._boot_plane[g] = plane_img
            rr.snap_index, rr.snap_term = si, st_
            rr.applied = si
            rr.entries = [e for e in ents.get(g, []) if e[0] > si]
            # Contiguity guard: release only ever reclaims entries a
            # snapshot covers, so a gap ABOVE the restored snapshot
            # means the newest snapshot file was unreadable and an
            # older restore point took over. Keep the contiguous
            # prefix — the watermark fence below makes the loss
            # protocol-visible and catch-up re-ships the rest.
            for j, e in enumerate(rr.entries):
                if e[0] != si + 1 + j:
                    rr.entries = rr.entries[:j]
                    break
            lim = rr.snap_index + len(rr.entries)
            rr.commit = min(rr.commit, lim) if rr.commit else rr.commit
            # BatchedRawNode._restore clamps commit up to snap_index (a
            # persisted snapshot proves its index committed) — relevant
            # here when a crash lands between the RT_SNAPSHOT record
            # and the next hardstate record.
            restore[g] = rr
            # Committed conf entries ABOVE the group's recorded conf
            # watermark (the crash landed after the entry's fsync but
            # before the RT_CONF_BATCH record / its fsync): re-apply
            # them now, in log order, so the device masks staged at
            # boot reflect every conf change the quorum may have acted
            # on. Entries above the recovered commit re-apply later
            # through the normal Ready path when they (re-)commit —
            # applying early would run a config the group never
            # committed (the apply-at-commit discipline, etcd-style).
            commit_eff = max(rr.commit, rr.snap_index)
            for ent in rr.entries:
                idx, _t, d = ent[0], ent[1], ent[2]
                et = ent[3] if len(ent) > 3 else 0
                if (et and idx <= commit_eff
                        and idx > self.conf.applied_index[g]):
                    try:
                        cc = decode_conf_entry(d or b"", et)
                    except ValueError:
                        _log.warning(
                            "member %d: undecodable conf entry "
                            "g%d i%d at replay", self.id, g, idx)
                        continue
                    self.conf.apply(g, idx, cc)
        # -- durable bookkeeping + fence decision per group -------------------
        for g, rr in restore.items():
            rec_last = rr.entries[-1][0] if rr.entries else rr.snap_index
            rec_term = rr.entries[-1][1] if rr.entries else rr.snap_term
            self._dur_last[g] = rec_last
            self._dur_term[g] = rec_term
            self._dur_commit[g] = max(rr.commit, rr.snap_index)
        for g, (wl, wt, wc) in wms.items():
            self._wm_last[g] = wl
            self._wm_term[g] = wt
            self._wm_commit[g] = wc
            if not self.fence_enabled:
                continue
            rr = restore.get(g)
            rec_last = self._dur_last[g] if rr is not None else 0
            # Acked-durable bytes lost: the recovered log no longer
            # reaches the watermark point (or holds an OLDER term
            # there — unreachable from a pure tail cut, checked
            # defensively). This replica's log/vote can no longer back
            # its pre-crash promises: boot the row FENCED and let the
            # snapshot/probe catch-up re-converge it (step.py fence
            # lane; RowRestore.fenced → BatchedRawNode._restore).
            below = rec_last < wl
            if not below and rr is not None and wl > rr.snap_index:
                terms = {i: t for i, t, *_ in rr.entries}
                below = terms.get(wl, 0) < wt
            # Term proof (mirrors _fence_lift_locked): a recovered log
            # ENDING above the watermark's term supersedes the demand —
            # the old suffix can never commit once a later-term leader
            # replaced it (reachable when a crash lands between a
            # term-rule lift and the next accurate watermark record).
            if below and self._dur_term[g] > wt:
                below = False
            if below:
                if rr is None:
                    rr = restore[g] = rows[g]
                rr.fenced = True
                self._fenced[g] = True
        self._boot_fenced = int(self._fenced.sum())
        self._g_fenced.set(self._boot_fenced)
        if self._boot_fenced or self._tail_state != TAIL_CLEAN:
            _log.warning(
                "member %d: WAL tail %s; %d group(s) below durable "
                "watermark -> fenced (campaign/vote suppressed until "
                "catch-up): %s", self.id,
                TAIL_NAMES.get(self._tail_state, self._tail_state),
                self._boot_fenced,
                np.nonzero(self._fenced)[0][:16].tolist())
        # -- log-lifecycle state from the surviving segments ------------------
        # Sealed list + caps from the on-disk segment names (all but
        # the highest seq are sealed; caps are the running per-group
        # max entry index up to and including each segment). A boot
        # with sealed segments owes the new tail a checkpoint before
        # anything can release (_ckpt_seq starts unproven).
        segs: List[Tuple[int, int]] = []
        for fname in os.listdir(wal_dir):
            if not fname.endswith(".wal") or len(fname) < 37:
                continue
            try:
                segs.append((int(fname[0:16], 16), int(fname[17:33], 16)))
            except ValueError:
                continue
        segs.sort()
        if segs:
            self._wal_meta = segs[-1][1]
            run_cap: Dict[int, int] = {}
            for sseq, smeta in segs[:-1]:
                for g, i in seg_caps.get(sseq, {}).items():
                    if i > run_cap.get(g, 0):
                        run_cap[g] = i
                cap = np.zeros(self.g, np.int64)
                for g, i in run_cap.items():
                    cap[g] = i
                self._sealed.append(
                    {"seq": sseq, "meta": smeta, "cap": cap})
            self._need_ckpt = bool(self._sealed)
        # Snapshot covers: what each group actually restored from,
        # with the segment holding its WAL evidence; file bookkeeping
        # from the newest durable marker (cadence measures its
        # applied-delta against the newest FILE, even when the restore
        # itself used a newer RT_SNAPSHOT record).
        for g, (si, st_, _sd) in snaps.items():
            if si > 0:
                self._snap_cover[g] = si
                self._snap_seq[g] = int(snap_src_seq.get(g, 0))
        for g, cand in marks.items():
            mi, mt, _ms = max(cand, key=lambda c: c[0])
            self._snap_file_idx[g] = mi
            self._snap_file_term[g] = mt
        snap_root = os.path.join(self.dir, "snap")
        if os.path.isdir(snap_root):
            total = 0
            for sub in os.listdir(snap_root):
                try:
                    total += sum(
                        1 for n in os.listdir(
                            os.path.join(snap_root, sub))
                        if n.endswith(".snap"))
                except (NotADirectoryError, OSError):
                    continue
            self._snap_file_count = total
        return restore

    # -- loops -----------------------------------------------------------------

    def _tick_loop(self) -> None:
        while not self._stopped.wait(self.tick_interval):
            self.rn.tick()
            self._work.set()

    def _run_loop(self) -> None:
        # Event-driven: staged work (proposals, inbound messages,
        # ticks) wakes the loop immediately instead of a blind sleep —
        # a put proposed mid-sleep otherwise pays up to a quarter tick
        # of dead latency PER HOP of the commit path.
        try:
            while not self._stopped.is_set():
                if not self.rn.has_work():
                    self._work.wait(self.tick_interval)
                    self._work.clear()
                    continue
                self.run_round()
        except FailpointPanic:
            # Injected crash on the synchronous (pipeline=False) path.
            # A site armed with the bare 'panic' action (not a crash()
            # callable) reaches here with the member still live — finish
            # the kill, or the member would wedge half-dead.
            _log.info("member %d: injected crash (round loop)", self.id)
            if not self._crashed:
                self.crash()

    def _drain_loop(self) -> None:
        """Persist/apply/send worker: drains Readys in round order,
        coalescing everything queued into ONE WAL fsync before any of
        their messages go out (the reference overlaps the next raft
        Ready with storage/apply the same way — raft.go:218-268 — and
        wal.Save batches; fsync-before-send holds per round because the
        queue is ordered and the sync covers every appended record).

        Guarded: any exception escaping the body (an OSError from a
        full/failed disk in _process_readys, a transport fault in the
        send path) logs and STOPS the member. Without the guard the
        thread died silently and run_round then blocked forever on the
        full _ready_q — a wedged member that still answered pings
        (the reference treats storage errors the same way: a raft
        storage fault is fatal to the member, never swallowed)."""
        try:
            while True:
                rd = self._ready_q.get()
                if rd is None:
                    return
                batch = [rd]
                while True:
                    try:
                        nxt = self._ready_q.get_nowait()
                    except queue_mod.Empty:
                        break
                    if nxt is None:
                        self._process_readys(batch)
                        return
                    batch.append(nxt)
                self._process_readys(batch)
        except FailpointPanic:
            # Injected crash (chaos harness): exit WITHOUT the orderly
            # stop() below, which would flush state a real kill would
            # have torn away. If the site was armed with the bare
            # 'panic' action (no crash() callable), the member is still
            # live here — finish the kill, else run_round spins forever
            # on the full _ready_q.
            _log.info("member %d: injected crash (drain worker)", self.id)
            if not self._crashed:
                self.crash()
        except Exception:  # noqa: BLE001 — fatal: log + stop the member
            _log.exception(
                "member %d: drain worker died; stopping member", self.id)
            self.stats["drain_dead"] = self.stats.get("drain_dead", 0) + 1
            # stop() from this thread: joins skip current_thread, and
            # run_round's queue put is deadline-based, so the round
            # thread can't be left blocked on a dead drainer.
            self.stop()

    def run_round(self) -> BatchedReady:
        """One device round; the Ready's persist/apply/send runs on the
        drain worker (pipelined with the next device round), unless the
        member runs unpipelined (pipeline=False: synchronous — kept as
        a debugging/fallback mode and covered by the test_hosting
        'sync' cluster parametrization)."""
        t0 = time.perf_counter()
        rd = self.rn.advance_round()
        self.rn.advance()
        self._joint_sweep()  # time-gated; no-op while nothing is joint
        self.stats["rounds"] += 1
        dt = time.perf_counter() - t0
        self.stats["round_s"] += dt
        if self._h_phase is not None:
            self._h_phase["round"].observe(dt)
            pl = self.rn.phase_last
            for p in ("stage", "extract", "collect"):
                self._h_phase[p].observe(pl[p])
        if self._drainer is not None:
            # Bounded: backpressure on the round — but never block
            # forever on a stopped/dead drain worker (see _drain_loop's
            # fatal-fault guard); the unpersisted Ready is dropped with
            # the member, same as a crash at this point.
            while not self._stopped.is_set():
                try:
                    self._ready_q.put(rd, timeout=0.2)
                    break
                except queue_mod.Full:
                    continue
        else:
            self._process_readys([rd])
        return rd

    def _build_persist_records(
            self, batch: List[BatchedReady],
    ) -> Tuple[bool, Dict[int, List[int]], List[Tuple[int, bytes]]]:
        """Serialize one Ready batch's persistence work (caller holds
        _lock): (must_sync, per-row durable deltas, WAL records in
        write order). Watermark records go FIRST: a tail cut destroying
        the batch's fsync'd entry records then still leaves the record
        that demanded them, so _replay detects the loss and fences."""
        must_sync = False
        records: List[Tuple[int, bytes]] = []
        # Per-group durable deltas across the whole batch:
        # row -> [last, last_term, commit, has_entries]. Entries
        # replay in order, so the final entry processed IS the new
        # last (truncate-and-append semantics included).
        wm: Dict[int, List[int]] = {}

        def _wm_row(row: int) -> List[int]:
            ent = wm.get(row)
            if ent is None:
                ent = wm[row] = [
                    int(self._dur_last[row]), int(self._dur_term[row]),
                    int(self._dur_commit[row]), 0,
                ]
            return ent

        for rd in batch:
            for row, _term, _vote, commit in rd.hardstates:
                ent = _wm_row(row)
                if commit > ent[2]:
                    ent[2] = commit
            eb = rd.entries
            if len(eb):
                # Last entry per row IS the row's new durable
                # (last, last_term): entries are row-ascending with
                # ascending indexes, so segment boundaries give the
                # per-row finals without a per-entry pass.
                rows_a = eb.rows
                ends = np.nonzero(np.diff(rows_a))[0]
                lasts = np.append(ends, len(rows_a) - 1)
                for j in lasts.tolist():
                    ent = _wm_row(int(rows_a[j]))
                    ent[0] = int(eb.idx[j])
                    ent[1] = int(eb.term[j])
                    ent[3] = 1
            must_sync |= rd.must_sync
        if self.fence_enabled:
            wm_rows: List[Tuple[int, int, int, int]] = []
            for row in sorted(wm):
                last, lterm, commit, has_ents = wm[row]
                if not has_ents:
                    continue  # commit-only: no durability promise moves
                if self._fenced[row] and last < self._wm_last[row]:
                    # Never lower the demand mid-heal: a crash
                    # during catch-up must re-fence at the original
                    # pre-loss watermark, not the partial one.
                    last = int(self._wm_last[row])
                    lterm = int(self._wm_term[row])
                if self._fenced[row]:
                    commit = max(commit, int(self._wm_commit[row]))
                wm_rows.append((row, last, lterm, commit))
            if wm_rows:
                wma = np.array(wm_rows, np.int64)
                records.append((RT_WM_BATCH, _pack_rows(
                    WAL_WM_DTYPE,
                    {"group": wma[:, 0], "last": wma[:, 1],
                     "last_term": wma[:, 2], "commit": wma[:, 3]})))
        for rd in batch:
            if rd.hardstates:
                # rd.hardstates is a host list (no device buffer).
                hsa = np.array(rd.hardstates, np.int64)
                records.append((RT_HS_BATCH, _pack_rows(
                    WAL_HS_DTYPE,
                    {"group": hsa[:, 0], "term": hsa[:, 1],
                     "vote": hsa[:, 2], "commit": hsa[:, 3]})))
            if len(rd.entries):
                records.append(
                    (RT_ENTRY_BATCH, _pack_entry_batch(rd.entries)))
        return must_sync, wm, records

    def _apply_wm_locked(self, wm: Dict[int, List[int]], synced: bool,
                         gens: Optional[Dict[int, int]] = None) -> None:
        """Fold one batch's durable deltas into the mirrors (caller
        holds _lock). Durable mirrors move only once the records are
        fsync'd (entries always set must_sync); the commit mirror rides
        along unsynced — it gates nothing in the fence protocol.
        ``gens``: snapshot-install generations captured at submit (WAL
        pipeline) — a row whose generation moved had a MsgSnap restore
        land AFTER this batch's records were built, and the snapshot's
        (already-applied, strictly-newer) mirrors must not be clobbered
        with this batch's stale delta. Skipping is safe-conservative:
        mirrors only ever claim LESS durable than reality that way, and
        the next entry-carrying batch re-converges them."""
        for row, (last, lterm, commit, has_ents) in wm.items():
            stale = (gens is not None
                     and gens.get(row, 0) != self._snap_gen[row])
            if has_ents and synced and not stale:
                self._dur_last[row] = last
                self._dur_term[row] = lterm
                if not self._fenced[row]:
                    # Track the recorded watermark for healthy rows
                    # (fenced rows keep demanding the boot-time
                    # watermark until the lift below).
                    self._wm_last[row] = last
                    self._wm_term[row] = lterm
                    self._wm_commit[row] = max(
                        self._wm_commit[row], commit)
            self._dur_commit[row] = max(self._dur_commit[row], commit)

    def _wal_submit_locked(self, records: List[Tuple[int, bytes]],
                           must_sync: bool,
                           batch: Sequence[BatchedReady] = (),
                           wm: Optional[Dict[int, List[int]]] = None,
                           on_synced: Optional[Callable[[], None]] = None,
                           ) -> None:
        """Queue one persistence batch on the WAL pipeline (caller
        holds _lock, which makes submission order == record-build
        order across the drain, conf-apply and snapshot-restore
        producers). The worker owns the native handle exclusively from
        here on."""
        gens = {row: int(self._snap_gen[row]) for row in wm} \
            if wm is not None else None
        traced = ()
        if self.tracer is not None:
            traced = [rd.traced_entries for rd in batch
                      if rd.traced_entries]
        g = _PersistGroup(records, list(batch), wm, gens, must_sync,
                          on_synced=on_synced, traced=traced)
        with self._wal_cv:
            self._wal_pending.append(g)
            depth = len(self._wal_pending)
            self._wal_cv.notify()
        if self._m_wal_depth is not None:
            self._m_wal_depth.set(depth)

    def _process_readys(self, batch: List[BatchedReady]) -> None:
        """Persist → apply → send, in round order. With the WAL
        pipeline off: one inline fsync for the whole batch before any
        of its acks/sends/applies (the unpipelined behavior). With it
        on: serialize the records, queue them on the WAL-commit worker
        and return — the worker's ordered release barrier runs the
        apply/send half only after the covering group-commit fsync."""
        fp(self._fp_before_save)  # crash-before-WAL-save injection site
        t0 = time.perf_counter()
        lifts: List[int] = []
        with self._lock:
            if self._crashed:
                return  # simulated kill: queued Readys are torn away
            must_sync, wm, records = self._build_persist_records(batch)
            if self._wal_worker is not None:
                self._wal_submit_locked(records, must_sync,
                                        batch=batch, wm=wm)
                self.stats["batched"] += len(batch)
                dt = time.perf_counter() - t0
                self.stats["wal_s"] += dt
                if self._h_phase is not None:
                    self._h_phase["wal"].observe(dt)
                return
            # Inline mode: snapshot the install generations under the
            # SAME lock the records were built under. The WAL write
            # below runs OUTSIDE _lock (handle serialized by _wal_io —
            # required so an ENOSPC dwell back-pressures without
            # wedging health()/crash()/stop() behind the member lock),
            # so a MsgSnap install can land between build and fsync;
            # the generation guard skips the then-stale mirror delta
            # exactly like the pipeline path does.
            gens = {row: int(self._snap_gen[row]) for row in wm}
        if not self._wal_write_sync(records, must_sync, batch):
            return  # fail-stopped / crashed / stopped mid-write:
            # nothing from the unpersisted window is released
        with self._lock:
            if self._crashed:
                return
            self._apply_wm_locked(wm, must_sync, gens)
            lifts = self._fence_lift_locked()
        dt = time.perf_counter() - t0
        self.stats["wal_s"] += dt
        if self._h_phase is not None:
            self._h_phase["wal"].observe(dt)
        self.stats["batched"] += len(batch)
        self._fence_lift_apply(lifts)
        fp(self._fp_after_save)  # crash-after-save-before-apply site
        for rd in batch:
            self._apply_and_send(rd)
        # Lifecycle work rides the drain AFTER the batch's covering
        # fsync and release (pipeline mode runs the same pass at the
        # end of each commit wave instead).
        self._lifecycle_pass()

    # -- IO-error contract ----------------------------------------------------
    #
    # Three arms, applied identically to the inline drain and the
    # WAL-pipeline worker:
    #
    # * **fail-stop** — the FIRST failed fsync (any errno) kills the
    #   member crash-style: nothing gated on the failed window (acks,
    #   sends, applies) is ever released, and no code path retries an
    #   fsync whose dirty pages the kernel may already have dropped
    #   and marked clean ("Can Applications Recover from fsync
    #   Failures?", Rebello et al., ATC'19 — retry-fsync reports
    #   success without durability on ext4/xfs). Unrecoverable write
    #   errors (partial native write, injected write faults) take the
    #   same arm: the on-disk suffix is unknowable.
    # * **write-back-pressure** — an ENOSPC-class error raised AT THE
    #   FAULT SEAM (DiskFullError: provably nothing was written) puts
    #   the member in disk_full: proposals refuse, the round loop
    #   back-pressures behind the bounded ready queue, health reports
    #   it, and the SAME record retries until space returns — zero
    #   acked writes lost, no crash-loop.
    # * **fence-on-salvage** — at-rest CRC corruption found at boot is
    #   amputated (walog.salvage) and the damaged groups boot FENCED
    #   via the durable watermark (see _replay) — the
    #   machinery, reused.

    def _wal_write_sync(self, records: List[Tuple[int, bytes]],
                        must_sync: bool,
                        batch: Sequence[BatchedReady]) -> bool:
        """Inline-mode persistence with the IO-error contract applied.
        Returns False when the member died (fail-stop/crash/stop)
        before the batch was durable — the caller releases nothing."""
        i = 0
        while True:
            try:
                with self._wal_io:
                    if self._wal_closed:
                        return False
                    while i < len(records):
                        rt, data = records[i]
                        self.wal.append(rt, data)
                        i += 1
            except Exception as e:  # noqa: BLE001 — classified below
                if is_disk_full(e):
                    self._enter_disk_full()
                    if self._dwell_disk_full():
                        continue  # retry the SAME record (seam
                        # guarantees it never reached the buffer)
                    return False
                self._io_fail_stop("write", e)
                return False
            break
        self._exit_disk_full()
        if not must_sync:
            return True
        if self.tracer is not None:
            # fsync_wait is stamped at fsync START (the queue/build
            # half of the old fsync hop), fsync at COMPLETION — one
            # instant pair covers every traced key the batch covers.
            tw = time.monotonic_ns()
            for rd in batch:
                self.tracer.stamp_many(rd.traced_entries, "fsync_wait",
                                       tw)
        tf = time.perf_counter()
        try:
            with self._wal_io:
                if self._wal_closed:
                    return False
                self.wal.flush(sync=True)
                # Everything serialized above is now durable in the
                # current tail segment — snapshot-install covers fold
                # with this seq as their WAL-evidence segment.
                self._last_sync_seq = int(self.wal.tail_seq())
        except Exception as e:  # noqa: BLE001 — first failed fsync
            self._io_fail_stop("fsync", e)
            return False
        dt = time.perf_counter() - tf
        self.stats["wal_fsyncs"] = self.stats.get("wal_fsyncs", 0) + 1
        self.stats["fsync_s"] = self.stats.get("fsync_s", 0.0) + dt
        if self._h_fsync is not None:
            self._h_fsync.observe(dt)
        if self.fleet is not None:
            # Gray-failure feed: the fleet hub watches sustained fsync
            # latency and raises the counted member_limping anomaly
            # the rebalancer evicts leadership on.
            self.fleet.observe_fsync(dt)
        if self.tracer is not None:
            tns = time.monotonic_ns()
            for rd in batch:
                self.tracer.stamp_many(rd.traced_entries, "fsync", tns)
        return True

    def _enter_disk_full(self) -> None:
        if self._disk_full:
            return
        self._disk_full = True
        self._g_disk_full.set(1)
        self.stats["disk_full_episodes"] = (
            self.stats.get("disk_full_episodes", 0) + 1)
        _log.warning(
            "member %d: WAL write hit ENOSPC — entering disk_full "
            "write-back-pressure (proposals refuse, nothing acks, "
            "resumes when space returns)", self.id)

    def _exit_disk_full(self) -> None:
        if not self._disk_full:
            return
        self._disk_full = False
        self._g_disk_full.set(0)
        _log.info("member %d: disk space returned — writes resumed",
                  self.id)

    def _dwell_disk_full(self) -> bool:
        """One back-pressure dwell; False once the member died (the
        batch is abandoned like any crash-torn suffix)."""
        self.stats["disk_full_waits"] = (
            self.stats.get("disk_full_waits", 0) + 1)
        time.sleep(0.05)
        return not (self._crashed or self._stopped.is_set())

    def _io_fail_stop(self, stage: str, exc: BaseException) -> None:
        """Fail-stop arm of the IO-error contract: record the cause,
        count it, and die crash-style (WAL handle torn down, NO orderly
        flush) so nothing gated on the failed window is released and
        nothing ever re-fsyncs over possibly-dropped dirty pages.
        Never called with _lock or _wal_io held (crash() takes both)."""
        if self._crashed:
            return
        self._fail_stop_cause = f"{stage}: {exc}"[:200]
        self._c_failstop.labels(str(self.id), stage).inc()
        _log.error(
            "member %d: storage %s failed (%s) — FAIL-STOP: nothing "
            "from the failed window is released", self.id, stage, exc)
        self.crash()

    # -- log-lifecycle plane --------------------------------------------------
    #
    # Bounded growth over a long life, three lanes:
    #
    # * **snapshot cadence** — when applied-minus-file-snapshot crosses
    #   snap_cadence, the group's snapshot is built OFF the apply
    #   stream (batched across due groups per drain pass): file first
    #   (fsync'd, tmp+rename), then one RT_SNAPMARK batch whose
    #   covering fsync gates the cover fold and the keep-K retention
    #   prune — the WAL pipeline's release-barrier discipline, reused.
    # * **rotation + release** — past wal_rotate_bytes the tail is cut
    #   (native cut() fdatasyncs the sealed fd: seal == durable) with
    #   cap[g] = the durable last per group, a full-state checkpoint
    #   (hardstate/watermark/conf/markers) opens the new tail, and a
    #   sealed segment releases only when every group with entries in
    #   it (cap > 0) has snapshot cover >= cap with the evidence in a
    #   LATER segment. Fenced groups never build new snapshots, so
    #   their segments stay pinned until the fence heals — a fence
    #   demand can never dangle into a released segment — and a stuck
    #   group surfaces as the counted wal_pinned anomaly instead of
    #   silently eating the disk.
    # * **ring back-pressure** — propose() refuses with a typed
    #   ring_full (counted, health-visible) at the exact occupancy
    #   where the device headroom clamp would drop the proposal, and
    #   kernels.invariant_bits trips ring_over_window if an append
    #   ever crosses the floor.

    def _snapper(self, group: int) -> Snapshotter:
        """Per-group snapshot file store (member-N/snap/gXXXXX/),
        created lazily — eager creation would mkdir G directories on
        every boot. Shares the WAL's disk-fault seam."""
        sp = self._snappers.get(group)
        if sp is None:
            sp = self._snappers[group] = Snapshotter(
                os.path.join(self.dir, "snap", f"g{group:05d}"),
                fault_hook=self._disk_fault_hook)
        return sp

    def _append_synced(
            self, records: List[Tuple[int, bytes]]) -> Optional[int]:
        """Append + fsync standalone lifecycle records (snapshot
        markers) with the IO-error contract applied. Returns the tail
        segment seq the records landed in, or None when nothing became
        durable (ENOSPC / member dead) — the caller retries on a later
        pass. Never called with _lock or _wal_io held."""
        fail: Optional[BaseException] = None
        with self._wal_io:
            if self._wal_closed:
                return None
            try:
                for rt, data in records:
                    self.wal.append(rt, data)
                self.wal.flush(sync=True)
                seq = int(self.wal.tail_seq())
                self._last_sync_seq = seq
                return seq
            except Exception as e:  # noqa: BLE001 — classified below
                fail = e
        if is_disk_full(fail):
            # Seam guarantee: the failing record never reached the
            # buffer; anything appended before it rides the next
            # covering fsync. No dwell — lifecycle work just waits.
            self._enter_disk_full()
        else:
            self._io_fail_stop("lifecycle", fail)
        return None

    def _checkpoint_records_locked(self) -> List[Tuple[int, bytes]]:
        """Full-state checkpoint for the (new) tail segment — caller
        holds _lock. Watermark + hardstate rows for every live group,
        conf rows for every non-default group, snapshot markers for
        every file-covered group: any such record a release reclaims
        from an old segment is superseded by this copy first. Fenced
        rows re-record their boot demand (the _wm arrays never lower
        it), so the fence survives rotation; term/vote from the round
        mirrors may run AHEAD of the last fsync'd record, which is the
        safe direction (persisting a vote early can never un-promise
        one). Entries are the one thing a checkpoint cannot re-record —
        the per-segment caps gate those."""
        recs: List[Tuple[int, bytes]] = []
        wmg = np.nonzero((self._wm_last > 0) | (self._wm_commit > 0))[0]
        if wmg.size:
            recs.append((RT_WM_BATCH, _pack_rows(WAL_WM_DTYPE, {
                "group": wmg, "last": self._wm_last[wmg],
                "last_term": self._wm_term[wmg],
                "commit": self._wm_commit[wmg]})))
        rn = self.rn
        live = np.nonzero((rn.m_term > 0) | (rn.m_vote > 0)
                          | (rn.m_commit > 0))[0]
        if live.size:
            recs.append((RT_HS_BATCH, _pack_rows(WAL_HS_DTYPE, {
                "group": live, "term": rn.m_term[live],
                "vote": rn.m_vote[live],
                "commit": rn.m_commit[live]})))
        conf_rows = self.conf.non_default_groups()
        if len(conf_rows):
            recs.append((RT_CONF_BATCH,
                         self.conf.pack_groups(conf_rows)))
        covered = np.nonzero(self._snap_file_idx > 0)[0]
        if covered.size:
            recs.append((RT_SNAPMARK, _pack_rows(WAL_SNAPMARK_DTYPE, {
                "group": covered,
                "index": self._snap_file_idx[covered],
                "term": self._snap_file_term[covered]})))
        return recs

    # -- device apply plane ---------------------------------------------------

    def _snap_data_many(self, rows) -> List[bytes]:
        """App-state blobs for a batch of groups (caller holds _lock).
        Plane off: the host tier's JSON dump, byte-identical to the
        pre-plane wire/disk format. Plane on: the two-tier wrapper —
        host bytes at the apply watermark plus the device plane image
        captured by ONE padded gather for the whole batch (the capture
        seam: a host dict walk per group inside _lock does not survive
        growing G)."""
        rows = [int(g) for g in rows]
        if self.rn.plane is None:
            return [self.kvs[g].snapshot() for g in rows]
        imgs = self.rn.plane_capture(rows)
        return [json.dumps({
            "host": {k.hex(): v.hex()
                     for k, v in self.kvs[g].data.items()},
            "plane": img,
        }).encode() for g, img in zip(rows, imgs)]

    def _restore_data(self, row: int, blob: bytes, idx: int) -> None:
        """Install snapshot app state for one group (caller holds
        _lock): host byte tier always; with the plane on, the device
        row image is staged too — from the blob's plane section, or
        rebuilt from the host dict when a plane-off sender shipped a
        legacy blob."""
        data, img = _split_snap_blob(blob)
        self.kvs[row].data = data
        if self.rn.plane is None:
            return
        if img is not None:
            self._plane_restore_img(row, img)
        else:
            self._plane_seed_from_host(row, idx)

    def _plane_restore_img(self, row: int, img: Dict) -> None:
        self.rn.plane_restore_row(
            row, img["kv_key"], img["kv_rev"], img["kv_val"],
            img["kv_lease"], img["rev"], img["tick"],
            img["overflow"], img.get("applied", 0),
            [(bytes.fromhex(k), int(e))
             for k, e in img.get("lessor", [])])

    def _plane_seed_from_host(self, row: int, applied: int) -> None:
        """Rebuild a plane row from the host byte tier (legacy blob or
        plane-off sender): revisions renumbered 1..k in key order,
        leases dropped — the documented legacy-restore contract."""
        from .applyplane import fnv1a32

        c = self.cfg.apply_capacity
        kk, kr, kv = [0] * c, [0] * c, [0] * c
        rev = slot = 0
        over = False
        data = self.kvs[row].data
        for k in sorted(data):
            rev += 1
            if slot >= c:
                over = True
                continue
            kk[slot] = fnv1a32(k)
            kr[slot] = rev
            kv[slot] = fnv1a32(data[k])
            slot += 1
        self.rn.plane_restore_row(row, kk, kr, kv, [0] * c, rev, 0,
                                  over, applied, [])

    def _lease_masked_get(self, group: int, key: bytes):
        """Host-tier byte read masked by the lessor mirror: a key whose
        lease expired on the device plane clock reads as absent even
        though the byte tier still holds it (expiry is leader-local —
        the replicated byte state never forks)."""
        exp = self.rn.plane_lessor.get((group, bytes(key)))
        if exp is not None and exp <= int(self.rn.m_plane_tick[group]):
            return None
        return self.kvs[group].data.get(key)

    def watch(self, group: int, key: bytes) -> int:
        """Arm an exact-key watch on `group`; returns the watch slot.
        Matching runs as masked compares on the device apply stream —
        fixed-shape event frames, no host scan per commit."""
        if self.rn.plane is None:
            raise RuntimeError("apply_plane is off")
        from .applyplane import fnv1a32

        with self._lock:
            slot = int(self._watch_next[group])
            if slot >= self.cfg.apply_watch_slots:
                raise RuntimeError(
                    f"group {group}: watch slots exhausted")
            self._watch_next[group] = slot + 1
            self._watches[(int(group), slot)] = bytes(key)
        self.rn.watch_set(group, slot, fnv1a32(key))
        self._work.set()
        return slot

    def watch_events(self) -> List[Dict[str, object]]:
        """Drain pending watch events: one dict per (event, armed
        slot), the registered key bytes resolved from the slot
        bitmap."""
        out: List[Dict[str, object]] = []
        if self.rn.plane is None:
            return out
        for row, op, kh, rev, wmask in self.rn.drain_plane_events():
            for s in range(self.cfg.apply_watch_slots):
                if wmask & (1 << s):
                    out.append({
                        "group": int(row), "slot": s,
                        "op": "PUT" if op == 1 else "DELETE",
                        "key": self._watches.get(
                            (int(row), s), b"").hex(),
                        "key_hash": int(kh), "rev": int(rev),
                    })
        return out

    def _lifecycle_pass(self) -> None:
        """One bounded lifecycle step, riding the inline drain or the
        WAL-commit worker AFTER a covering fsync (never with _lock or
        _wal_io held on entry). Work per pass is capped, so the round
        loop never stalls behind snapshot building."""
        if self.snap_cadence is None and self.wal_rotate_bytes is None:
            return
        if (self._crashed or self._disk_full
                or self._fail_stop_cause is not None):
            return
        occ = int((self.rn.m_last - self.rn.m_snap).max())
        if occ > self._ring_occ_hw:
            self._ring_occ_hw = occ
        if self.snap_cadence is not None:
            self._snapshot_due_groups()
        if self.wal_rotate_bytes is not None:
            self._rotate_and_release()

    def _snapshot_due_groups(self) -> None:
        """Cadence snapshots, batched across due groups: capture
        (index, term, conf, KV blob) under _lock off the apply stream,
        write the files OUTSIDE every lock, then append ONE RT_SNAPMARK
        batch — the cover fold and the keep-K retention prune run only
        once the marker's fsync landed. Fenced groups are skipped: a
        fenced group's cover stays frozen, so release keeps every
        segment its un-healed demand may point into."""
        cad = self.snap_cadence
        builds: List[Tuple[int, int, int, bytes, object]] = []
        with self._lock:
            if self._crashed:
                return
            delta = self.applied_index - self._snap_file_idx
            # Catch-up lag: groups whose cover (or marker evidence)
            # still pins the OLDEST sealed segment build regardless of
            # cadence — without this, a group idling 1-2 applied
            # entries past its last snapshot (delta < cadence) would
            # pin that segment forever. Only groups a rebuild can
            # actually help: applied past the cover, or a fresh marker
            # needed as release evidence.
            lag = np.zeros(self.g, dtype=bool)
            if self._sealed:
                s0 = self._sealed[0]
                cap0 = s0["cap"]
                lag = (cap0 > 0) & (
                    ((self._snap_cover < cap0)
                     & (self.applied_index > self._snap_cover))
                    | ((self._snap_cover >= cap0)
                       & (self._snap_seq <= s0["seq"])))
            due = np.nonzero(((delta >= cad) | lag) & ~self._fenced
                             & (self.applied_index > 0))[0]
            if due.size == 0:
                return
            # Build cap scales with the fleet so steady-state cover
            # refresh keeps pace with rotation at large G; laggards
            # outrank merely-due groups under the cap.
            cap_n = max(SNAP_BUILD_MAX_PER_PASS, self.g // 8)
            if due.size > cap_n:
                prio = delta[due] + np.where(lag[due], 1 << 32, 0)
                order = np.argsort(-prio, kind="stable")
                due = due[order[:cap_n]]
            m_last = self.rn.m_last
            ring = self.rn.m_ring
            w = self.cfg.window
            cand: List[Tuple[int, int, int, object]] = []
            for g in due.tolist():
                idx = int(self.applied_index[g])
                last = int(m_last[g])
                # Term at idx from the host ring mirror: valid only
                # while idx is inside the mirrored window (committed
                # slots never rewrite, so mirror staleness is safe; a
                # group at the window edge catches the next pass).
                if idx <= last - w or idx > last:
                    continue
                term = int(ring[g, idx % w])
                if term <= 0:
                    continue
                cand.append((g, idx, term, self.conf.conf_state(g)))
            if cand:
                # App-state capture for the whole build batch at once:
                # with the plane on this is ONE padded device gather
                # instead of a host dict walk per group under _lock.
                blobs = self._snap_data_many([g for g, *_ in cand])
                builds = [(g, idx, term, blob, cs)
                          for (g, idx, term, cs), blob
                          in zip(cand, blobs)]
        if not builds:
            return
        built: List[Tuple[int, int, int]] = []
        for g, idx, term, data, cs in builds:
            snap = Snapshot(
                metadata=SnapshotMetadata(
                    index=idx, term=term, conf_state=cs),
                data=data)
            try:
                self._snapper(g).save_snap(snap)
            except Exception as e:  # noqa: BLE001 — classified below
                # tmp+rename is all-or-nothing: a failed build leaves
                # the previous file intact and the WAL still holds
                # everything, so skip-and-retry is loss-free (and each
                # attempt opens a FRESH tmp file — no retried-fsync
                # dirty-page hazard). ENOSPC enters back-pressure.
                self.stats["snap_build_errors"] = (
                    self.stats.get("snap_build_errors", 0) + 1)
                if is_disk_full(e):
                    self._enter_disk_full()
                    break
                continue
            built.append((g, idx, term))
        if not built:
            return
        rows = np.array(built, np.int64)
        marker = (RT_SNAPMARK, _pack_rows(WAL_SNAPMARK_DTYPE, {
            "group": rows[:, 0], "index": rows[:, 1],
            "term": rows[:, 2]}))
        seq = self._append_synced([marker])
        if seq is None:
            return  # files exist; the marker retries a later pass
        fresh = set()
        with self._lock:
            if self._crashed:
                return
            for g, idx, term in built:
                if idx > int(self._snap_file_idx[g]):
                    self._snap_file_idx[g] = idx
                    self._snap_file_term[g] = term
                    fresh.add(g)  # new file; same-idx catch-up
                    # rebuilds overwrite in place
                if idx >= int(self._snap_cover[g]):
                    self._snap_cover[g] = idx
                    self._snap_seq[g] = max(int(self._snap_seq[g]),
                                            seq)
            self.stats["snapshots_built"] = (
                self.stats.get("snapshots_built", 0) + len(built))
        for g, idx, _t in built:
            pruned = self._snapper(g).retain(self.snap_keep)
            self.stats["snap_files_pruned"] = (
                self.stats.get("snap_files_pruned", 0) + pruned)
            self._snap_file_count += (1 if g in fresh else 0) - pruned
            # Advance the device ring floor to the snapshot point
            # (staged on the rawnode, clamped to commit at the round
            # head): auto_compact's conservative floor trails applied
            # by window//2; this reclaims the rest of the headroom.
            self.rn.compact(g, idx)

    def _rotate_and_release(self) -> None:
        """Seal the tail past the byte threshold, checkpoint the new
        tail, release every sealed segment the fleet-min snapshot
        cover clears, and raise wal_pinned when the backlog of
        unreleasable segments crosses the threshold."""
        rot = self.wal_rotate_bytes
        fail: Optional[BaseException] = None
        ckpt_full = False
        release_meta: Optional[int] = None
        anomaly: Optional[Dict] = None
        with self._lock:
            if self._crashed:
                return
            with self._wal_io:
                if self._wal_closed:
                    return
                try:
                    if (self.wal.tail_offset()
                            >= rot + self._tail_ckpt_bytes):
                        seq = int(self.wal.tail_seq())
                        cap = self._dur_last.copy()
                        # cut() fdatasyncs the sealed segment's fd
                        # before switching: seal == durable, and cap
                        # (folded only after covering fsyncs) bounds
                        # every entry index the segment holds.
                        self.wal.cut(self._wal_meta + 1)
                        self._sealed.append(
                            {"seq": seq, "meta": self._wal_meta,
                             "cap": cap})
                        self._wal_meta += 1
                        self._tail_ckpt_bytes = 0
                        self.stats["wal_cuts"] = (
                            self.stats.get("wal_cuts", 0) + 1)
                        self._need_ckpt = True
                except Exception as e:  # noqa: BLE001 — a failed cut
                    # leaves the native tail state unknowable: the
                    # fail-stop arm, like any failed fsync.
                    fail = e
                if fail is None and self._need_ckpt:
                    # Checkpoint ATOMICALLY with the cut (still under
                    # _lock): no install can slip a newer hardstate
                    # into the sealed segment after our capture, so
                    # everything a release reclaims is genuinely
                    # superseded by this copy.
                    try:
                        ckpt = self._checkpoint_records_locked()
                        for rt, d in ckpt:
                            self.wal.append(rt, d)
                        self.wal.flush(sync=True)
                        self._tail_ckpt_bytes += sum(
                            len(d) + 16 for _rt, d in ckpt)
                        cseq = int(self.wal.tail_seq())
                        self._last_sync_seq = cseq
                        self._ckpt_seq = cseq
                        self._need_ckpt = False
                        cov = self._snap_file_idx > 0
                        self._snap_seq[cov] = np.maximum(
                            self._snap_seq[cov], cseq)
                    except Exception as e:  # noqa: BLE001
                        if is_disk_full(e):
                            ckpt_full = True  # retry next pass
                        else:
                            fail = e
            if fail is None and self._sealed and self._ckpt_seq >= 0:
                k = 0
                for s in self._sealed:
                    if s["seq"] >= self._ckpt_seq:
                        break  # its checkpoint lives in a later
                        # segment only once a NEWER one is written
                    need = s["cap"] > 0
                    if not bool(np.all(~need | (
                            (self._snap_cover >= s["cap"])
                            & (self._snap_seq > s["seq"])))):
                        break  # prefix-only: later segments need this
                        # one's predecessors gone first anyway
                    k += 1
                if k:
                    release_meta = (
                        self._sealed[k]["meta"]
                        if k < len(self._sealed) else self._wal_meta)
                    del self._sealed[:k]
            if fail is None:
                if len(self._sealed) > self.wal_pinned_segments:
                    if not self._wal_pinned_flag:
                        self._wal_pinned_flag = True
                        self.stats["wal_pinned_events"] = (
                            self.stats.get("wal_pinned_events", 0) + 1)
                        s = self._sealed[0]
                        lag = (s["cap"] > 0) & (
                            (self._snap_cover < s["cap"])
                            | (self._snap_seq <= s["seq"]))
                        gap = np.where(
                            lag, s["cap"] - self._snap_cover, -1)
                        self._pinned_group = (
                            int(np.argmax(gap)) if lag.any() else -1)
                        anomaly = {
                            "segments": len(self._sealed),
                            "oldest_seq": int(s["seq"]),
                            "group": self._pinned_group,
                            "gap": int(gap.max()) if lag.any() else 0,
                            "fenced": bool(
                                self._fenced[self._pinned_group])
                            if self._pinned_group >= 0 else False,
                        }
                else:
                    # Edge-triggered: re-arms after the backlog drains.
                    self._wal_pinned_flag = False
                    self._pinned_group = -1
        if fail is not None:
            self._io_fail_stop("rotate", fail)
            return
        if ckpt_full:
            self._enter_disk_full()
            return
        if release_meta is not None:
            with self._wal_io:
                if not self._wal_closed:
                    try:
                        n = self.wal.release_before(release_meta)
                    except Exception as e:  # noqa: BLE001
                        self._io_fail_stop("release", e)
                        return
                    self.stats["wal_segments_released"] = (
                        self.stats.get("wal_segments_released", 0)
                        + n)
        if anomaly is not None:
            _log.warning(
                "member %d: wal_pinned — %d sealed segment(s) "
                "unreleasable, pinned by group %s (cover gap %s%s)",
                self.id, anomaly["segments"], anomaly["group"],
                anomaly["gap"],
                ", fenced" if anomaly["fenced"] else "")
            if self.fleet is not None:
                self.fleet.raise_anomaly("wal_pinned", anomaly)

    def _ring_full(self, group: int) -> bool:
        """Host twin of the device propose-headroom clamp: occupancy
        (last minus compaction floor) has reached the window minus the
        per-round proposal quota, so a staged proposal would be
        dropped on device anyway. Refusing HERE makes the
        back-pressure typed — counted, health-visible — instead of a
        silent device-side drop."""
        occ = int(self.rn.m_last[group]) - int(self.rn.m_snap[group])
        return occ >= self.cfg.window - self.cfg.max_props_per_round

    # -- WAL-commit worker (async group-commit pipeline) ----------------------

    def _wal_commit_loop(self) -> None:
        """Dedicated persistence stage: swap the open double buffer,
        optionally dwell (max-delay/max-bytes group-commit window) so
        more rounds' batches coalesce, write + fsync ONCE for the whole
        wave, fold the durable mirrors, then release every covered
        batch's apply/send in submission order. Guarded like the drain
        worker: an escaping storage/transport fault is fatal to the
        member, never swallowed."""
        try:
            while True:
                idle = False
                with self._wal_cv:
                    while not self._wal_pending and not self._wal_stop:
                        if (self.snap_cadence is not None
                                or self.wal_rotate_bytes is not None):
                            # Lifecycle on: bounded wait so cadence
                            # builds, cuts and releases keep making
                            # progress through idle gaps — without the
                            # tick, a quiet pipeline would freeze the
                            # lifecycle plane until the next write.
                            self._wal_cv.wait(WAL_LIFECYCLE_TICK_S)
                            if (not self._wal_pending
                                    and not self._wal_stop):
                                idle = True
                                break
                        else:
                            self._wal_cv.wait()
                    wave = self._wal_pending
                    self._wal_pending = []
                    stopping = self._wal_stop
                if idle and not wave and not stopping:
                    # Idle lifecycle tick: still THIS thread, so every
                    # cut/checkpoint stays serialized with wave appends.
                    self._lifecycle_pass()
                    continue
                if not wave:
                    return  # stop() with nothing pending
                nbytes = sum(g.nbytes for g in wave)
                if self._wal_max_delay > 0 and not stopping:
                    deadline = time.monotonic() + self._wal_max_delay
                    while nbytes < self._wal_max_bytes:
                        rem = deadline - time.monotonic()
                        if rem <= 0:
                            break
                        with self._wal_cv:
                            if (not self._wal_pending
                                    and not self._wal_stop):
                                self._wal_cv.wait(rem)
                            more = self._wal_pending
                            self._wal_pending = []
                            stopping = self._wal_stop
                        wave.extend(more)
                        nbytes += sum(g.nbytes for g in more)
                        if stopping:
                            break
                if self._m_wal_depth is not None:
                    self._m_wal_depth.set(0)
                self._commit_wave(wave, nbytes)
                if stopping:
                    with self._wal_cv:
                        if not self._wal_pending:
                            return
        except FailpointPanic:
            # Injected crash (chaos harness) at the pipeline kill
            # point; finish the kill if the site was armed with the
            # bare 'panic' action (see _drain_loop).
            _log.info("member %d: injected crash (WAL-commit worker)",
                      self.id)
            if not self._crashed:
                self.crash()
        except Exception:  # noqa: BLE001 — fatal: log + stop the member
            _log.exception(
                "member %d: WAL-commit worker died; stopping member",
                self.id)
            self.stats["walpipe_dead"] = (
                self.stats.get("walpipe_dead", 0) + 1)
            self.stop()

    def _commit_wave(self, wave: List[_PersistGroup],
                     nbytes: int) -> None:
        """Write + group-commit one wave, then run the ordered release
        barrier. Never called with member locks held; takes _wal_io
        around every handle touch (crash()/stop() close under it) and
        _lock only for the mirror fold."""
        must_sync = any(g.must_sync for g in wave)
        recs = [rec for g in wave for rec in g.records]
        i = 0
        while True:
            try:
                with self._wal_io:
                    if self._wal_closed:
                        return  # crashed: wave torn away like a kill
                    while i < len(recs):
                        rt, data = recs[i]
                        self.wal.append(rt, data)
                        i += 1
                    # bytes to the fd; NOT yet durable
                    self.wal.flush(sync=False)
            except Exception as e:  # noqa: BLE001 — IO-error contract
                if is_disk_full(e):
                    # ENOSPC at the fault seam (nothing written):
                    # back-pressure OUTSIDE _wal_io so crash()/stop()
                    # can still take the handle lock, then retry the
                    # SAME record. The wave's acks stay withheld the
                    # whole time — the release barrier below never ran.
                    self._enter_disk_full()
                    if self._dwell_disk_full():
                        continue
                    return
                self._io_fail_stop("write", e)
                return
            break
        self._exit_disk_full()
        # The pipeline's chaos window: records written, fsync pending,
        # nothing released/acked. Outside _wal_io so a crash() action
        # at the site can take _lock -> _wal_io itself.
        fp(self._fp_before_release)
        tw_ns = time.monotonic_ns()  # fsync start (fsync_wait stamp)
        tf = time.perf_counter()
        if must_sync:
            try:
                with self._wal_io:
                    if self._wal_closed:
                        return
                    self.wal.flush(sync=True)
                    # Wave durable in the current tail (cuts happen
                    # only on THIS worker, so every record appended
                    # above landed in it): snapshot-install covers
                    # fold with this seq as their evidence segment.
                    self._last_sync_seq = int(self.wal.tail_seq())
            except Exception as e:  # noqa: BLE001 — first failed fsync
                # Fail-stop releasing NOTHING covered by the failed
                # window: every batch queued behind this group-commit
                # keeps its acks/sends/applies withheld forever
                # (ATC'19: a retried fsync can report success over
                # already-dropped dirty pages).
                self._io_fail_stop("fsync", e)
                return
        dt_sync = time.perf_counter() - tf
        td_ns = time.monotonic_ns()  # fsync completion (fsync stamp)
        lifts: List[int] = []
        with self._lock:
            if self._crashed:
                return
            for g in wave:
                if g.wm is not None:
                    self._apply_wm_locked(g.wm, must_sync, g.gens)
                if g.on_synced is not None:
                    g.on_synced()
            lifts = self._fence_lift_locked()
        self._fence_lift_apply(lifts)
        if must_sync:
            self.stats["wal_fsyncs"] = self.stats.get("wal_fsyncs", 0) + 1
            self.stats["fsync_s"] = (
                self.stats.get("fsync_s", 0.0) + dt_sync)
            if self._h_fsync is not None:
                self._h_fsync.observe(dt_sync)
            if self.fleet is not None:
                # Gray-failure feed (see _wal_write_sync): sustained
                # slow group-commits raise member_limping.
                self.fleet.observe_fsync(dt_sync)
            # Amortization accounting rides the fsyncs only: an idle
            # no-sync wave covering empty rounds must not inflate the
            # rounds-per-fsync ratio the pipeline is judged by.
            rounds = sum(len(g.readys) for g in wave)
            self.stats["wal_fsync_rounds"] = (
                self.stats.get("wal_fsync_rounds", 0) + rounds)
            self.stats["wal_fsync_bytes"] = (
                self.stats.get("wal_fsync_bytes", 0) + nbytes)
            if self._m_wal_batches is not None:
                # Round-Ready batches only: readys-less submissions
                # (conf records, snapshot installs) must not inflate
                # the coverage metric, and the histogram must agree
                # with the health op's rounds_per_fsync ratio.
                if rounds:
                    self._m_wal_batches.observe(rounds)
                self._m_wal_bytes.observe(nbytes)
        if self.tracer is not None:
            # The covering group-commit's instants, for every traced
            # key in the wave: fsync_wait at fsync start (queue half),
            # fsync at completion — the satellite contract that keeps
            # the SLO hop table telescoping with the pipeline on.
            for g in wave:
                for keys in g.traced:
                    self.tracer.stamp_many(keys, "fsync_wait", tw_ns)
                    self.tracer.stamp_many(keys, "fsync", td_ns)
        fp(self._fp_after_save)  # fsync'd-but-unreleased kill window
        # Ordered release barrier: acks, sends and applies of a batch
        # leave ONLY here, after its covering fsync — persist-before-
        # send/ack by construction, not by timing.
        now = time.monotonic()
        for g in wave:
            if self._m_wal_release is not None and g.readys:
                self._m_wal_release.observe(now - g.t_submit)
            for rd in g.readys:
                self._apply_and_send(rd)
        # Lifecycle work rides the commit worker after the wave's
        # release — same thread as every cut/checkpoint, so segment
        # rotation never races the wave appends above.
        self._lifecycle_pass()

    def _apply_and_send(self, rd: BatchedReady) -> None:
        if self._crashed:
            return  # dead members neither apply nor send
        t0 = time.perf_counter()
        conf_changed: List[int] = []
        auto_leave_rows: List[int] = []
        io_fail: Optional[Tuple[str, BaseException]] = None
        with self._lock:
            if self._crashed:
                return  # re-check under _lock: crash() closed the WAL
            # 2. apply committed payloads (persist already happened in
            #    _process_readys; the batch fsync precedes every send).
            #    Conf-change entries apply to the membership control
            #    plane instead of the KV state machine: the new config
            #    flips the device voter/learner/in_joint lanes via one
            #    bulk mask upload after the loop (ref: raft.go:896
            #    applyConfChange; SURVEY §2.1 host-side control plane).
            for row, items in rd.committed:
                for i, _t, d, et in items:
                    if et == 0:
                        if d:
                            self.kvs[row].apply(d)
                    else:
                        self._apply_conf_entry(
                            row, i, d or b"", et, conf_changed,
                            auto_leave_rows)
                    self.applied_index[row] = i
            if conf_changed:
                # WAL-record the new configs before anything downstream
                # of them can be acknowledged; the next batch fsync
                # covers the record, and a crash before it re-derives
                # the state from the (already fsync'd) entries at
                # _replay.
                conf_changed = sorted(set(conf_changed))
                rows = np.asarray(conf_changed)
                packed = self.conf.pack_groups(rows)
                if self._wal_worker is not None:
                    # Pipeline mode: the worker owns the handle, so the
                    # record rides the open buffer — same durability
                    # contract (the next group-commit fsync covers it,
                    # and a crash before that re-derives the config
                    # from the already-fsync'd entries at _replay).
                    self._wal_submit_locked([(RT_CONF_BATCH, packed)],
                                            must_sync=False)
                else:
                    try:
                        with self._wal_io:
                            if not self._wal_closed:
                                self.wal.append(RT_CONF_BATCH, packed)
                    except Exception as e:  # noqa: BLE001 — IO contract
                        if is_disk_full(e):
                            # Can't dwell under _lock: SKIP the record.
                            # Safe by the same argument as a crash
                            # before it lands — the config re-derives
                            # from the (already-fsync'd) conf entries
                            # at _replay; the next conf change or
                            # snapshot re-records full state.
                            self._enter_disk_full()
                            self.stats["conf_rec_skipped"] = (
                                self.stats.get("conf_rec_skipped", 0)
                                + 1)
                        else:
                            # Unrecoverable write fault: defer the
                            # fail-stop to after the lock release
                            # (crash() takes _lock itself).
                            io_fail = ("write", e)
                # Stage the device masks UNDER the same lock as the
                # conf mutation (member._lock -> rn._lock nesting is
                # established — install_snapshot_state does the same):
                # reading or staging after release races deliver()'s
                # snapshot conf restore — torn mask planes, or a stale
                # older config overwriting a newer staging for the
                # same row (rn._pending_conf is last-writer-wins).
                self.rn.set_membership_many(rows,
                                            *self.conf.masks(rows))
                self._update_conf_gauges()
            # 3a. build outbound batch (MsgSnap carries app state at the
            #     host's applied watermark, ≥ the device floor after
            #     step 2; the floor metadata rides in m.index/log_term)
            out: List[Tuple[int, Message]] = []
            w = self.cfg.window
            for row, m in rd.messages:
                if int(m.type) == T_SNAP:
                    idx = int(self.applied_index[row])
                    # Term at the applied watermark, from THIS round's
                    # ring row (captured in the Ready): the drain
                    # worker may run rounds behind the device, and the
                    # live ring slot could have wrapped to a different
                    # entry by now. Below/at the floor, the floor term
                    # rides in the message (m.log_term) — the receiver
                    # persists it and restores its ring floor from it.
                    ring_row = rd.snap_rings.get(row)
                    t = (
                        int(ring_row[idx % w])
                        if idx > m.index and ring_row is not None
                        else m.log_term
                    )
                    m.snapshot = Snapshot(
                        # The config at the snapshot point rides the
                        # metadata (raft.proto ConfState): conf entries
                        # in the skipped log never reach the receiver,
                        # so the snapshot must carry membership or a
                        # rejoining member restores data without its
                        # config (ref: confchange/restore.go).
                        metadata=SnapshotMetadata(
                            index=idx, term=t,
                            conf_state=self.conf.conf_state(row)),
                        # One-row capture on the rare catch-up path
                        # (two-tier blob when the plane is on).
                        data=self._snap_data_many([row])[0],
                    )
                out.append((row, m))
        if io_fail is not None:
            self._io_fail_stop(*io_fail)
            return
        if conf_changed:
            self._post_conf_apply(conf_changed, auto_leave_rows)
        # Apply instant captured here, stamped at the END of this
        # function: "apply" retires a span, and a same-round
        # append+commit (solo group) must take its "send" stamp first.
        tr_apply_ns = (
            time.monotonic_ns()
            if self.tracer is not None and rd.traced_commit else 0
        )
        # 2b. surface ReadIndex progress to waiting readers (after
        #     apply: applied_index moved under the same round).
        if rd.read_opened or rd.read_states or rd.committed:
            with self._read_cv:
                for row, seq in rd.read_opened:
                    self._read_opened[row] = seq
                for row, seq, idx in rd.read_states:
                    self._read_results[row] = (seq, idx)
                self._read_cv.notify_all()
        t1 = time.perf_counter()
        self.stats["apply_s"] += t1 - t0
        if self._h_phase is not None:
            self._h_phase["apply"].observe(t1 - t0)
        if self._m_ap_slots is not None and rd.committed:
            ps = self.rn.plane_stats
            self._m_ap_slots.set(ps["slots_hw"])
            self._m_ap_leases.set(ps["active_leases"])
            self._m_ap_overflow.set(ps["overflow_rows"])
            we = int(ps["watch_events"])
            if we > self._ap_we_prev:
                self._m_ap_watch.inc(we - self._ap_we_prev)
                self._ap_we_prev = we
        # 3b. send OUTSIDE the lock: delivery takes the receiver's lock,
        #     and two members sending to each other must not deadlock.
        # "send" = the instant this round's outbound batch is handed to
        # the transport — captured BEFORE the hand-off (the wire/peer
        # clock starts here, not after local serialization returned),
        # stamped only if something actually left (a round that
        # persisted a traced entry but transmitted nothing — transport
        # detached, nothing outbound — must not fabricate a send hop).
        tr_send_ns = time.monotonic_ns() if self.tracer is not None else 0
        sent_any = False
        if out and self._send is not None:
            self._send(self.id, out)
            sent_any = True
        blk = rd.msg_block
        if blk is not None and len(blk):
            if self._send_block is not None:
                self._send_block(self.id, blk)
                sent_any = True
            elif self._send is not None:
                from .msgblock import block_messages

                self._send(self.id, block_messages(blk))
                sent_any = True
        if self.tracer is not None:
            if rd.traced_entries and sent_any:
                # On the leader the batch carries the entry's MsgApp;
                # on a follower the same round's block carries its
                # MsgAppResp — either way, the ack/replication clock
                # starts here.
                self.tracer.stamp_many(rd.traced_entries, "send",
                                       tr_send_ns)
            if rd.traced_commit:
                # Terminal stamp (retires the span) at the instant the
                # apply loop finished above.
                self.tracer.stamp_many(rd.traced_commit, "apply",
                                       tr_apply_ns)
        dt = time.perf_counter() - t1
        self.stats["send_s"] += dt
        if self._h_phase is not None:
            self._h_phase["send"].observe(dt)

    # -- membership (joint-consensus conf changes) ----------------------------

    def _apply_conf_entry(self, row: int, index: int, data: bytes,
                          etype: int, changed: List[int],
                          auto_rows: List[int]) -> None:
        """Apply one committed conf-change entry to the control plane
        (caller holds _lock). Undecodable bytes and deterministic
        refusals are logged and skipped — every member sees the same
        bytes at the same index, so every member skips identically."""
        try:
            cc = decode_conf_entry(data, etype)
        except ValueError:
            _log.warning("member %d: undecodable conf entry g%d i%d",
                         self.id, row, index)
            return
        err = self.conf.apply(row, index, cc)
        if err is not None:
            if err != "stale":
                _log.info("member %d: conf change g%d i%d refused: %s",
                          self.id, row, index, err)
            return
        changed.append(row)
        if self.conf.in_joint[row] and self.conf.auto_leave[row]:
            auto_rows.append(row)

    def _post_conf_apply(self, changed: List[int],
                         auto_rows: List[int]) -> None:
        """Follow-on actions a leader owes a freshly applied config
        (the masks themselves were staged under _lock by the caller):
        an immediate append/probe to changed membership
        (switchToConfig → maybeSendAppend) and the auto-leave proposal
        for implicit joint entries (raft.go advance() proposing the
        zero ConfChangeV2)."""
        for row in changed:
            if self.rn.is_leader(row):
                # Newly admitted members must be contacted now, not at
                # the next heartbeat timeout.
                self.rn.poke_append(row)
        for row in sorted(set(auto_rows)):
            if self.rn.is_leader(row):
                self._propose_leave_joint(row)
        self._work.set()

    def _propose_leave_joint(self, row: int) -> None:
        """Propose the empty ConfChangeV2 that exits an auto-leave
        joint config, at most once per row per cooldown window (a
        duplicate leave landing after the exit refuses idempotently at
        apply)."""
        now = time.monotonic()
        if now - self._joint_prop.get(row, 0.0) < 1.0:
            return
        self._joint_prop[row] = now
        self.rn.propose(row, ConfChangeV2().marshal(),
                        etype=int(EntryType.EntryConfChangeV2))
        self._work.set()

    def _joint_sweep(self) -> None:
        """Fallback auto-leave driver (run_round, time-gated): the
        leave is normally proposed at the joint entry's apply on the
        leader, but leadership can move mid-joint — the NEW leader must
        exit the joint config or the group is stuck needing both
        quorums forever (the classic place multi-raft breaks; the
        check_config_safety 'joint always exited' clause watches it)."""
        now = time.monotonic()
        if now < self._next_joint_sweep:
            return
        self._next_joint_sweep = now + 0.25
        with self._lock:
            rows = np.nonzero(self.conf.in_joint
                              & self.conf.auto_leave)[0]
        for row in rows.tolist():
            if self.rn.is_leader(row):
                self._propose_leave_joint(row)

    def _update_conf_gauges(self) -> None:
        self._g_joint.set(int(self.conf.in_joint.sum()))
        self._g_learners.set(int(self.conf.learner.sum()))

    def propose_conf(self, group: int, cc) -> bool:
        """Propose a membership change through `group`'s log (leaders
        only — returns False otherwise so callers redirect like
        clients). Accepts ConfChange or ConfChangeV2; always marshals
        as an EntryConfChangeV2 record. A new change while the group is
        mid-joint is refused loudly (ConfChangeError) — one config
        transition in flight per group, the reference's
        pendingConfIndex discipline — except the empty leave-joint."""
        cc2 = cc.as_v2()
        if not self.rn.is_leader(group):
            return False
        with self._lock:
            if self.conf.in_joint[group] and not cc2.leave_joint():
                raise ConfChangeError(
                    f"group {group} is mid-joint; only the leave-joint "
                    "change may be proposed")
        self.rn.propose(group, cc2.marshal(),
                        etype=int(EntryType.EntryConfChangeV2))
        self._work.set()
        return True

    # Learner promotable once its match covers this share of the
    # leader's (ref: server.go:1473 readyPercent).
    LEARNER_READY_PERCENT = 0.9

    def reconfig(self, action: str, target_member: int, groups,
                 joint: bool = False) -> Dict[int, str]:
        """Batched membership admin over the groups this member leads:
        ``add-learner`` / ``promote`` (catch-up-gated) / ``remove``.
        Returns a per-group result string: "ok" (proposed), or why not
        ("not-leader", "not-learner", "not-ready:<match>/<last>",
        "self", "refused:<reason>"). ``joint=True`` proposes the change
        with an implicit joint transition (enter-joint at apply,
        auto-leave once the joint config commits) — the batched
        joint-consensus path."""
        t = int(target_member)
        if not 1 <= t <= self.cfg.num_replicas:
            raise ValueError(
                f"member {t} outside replica capacity "
                f"R={self.cfg.num_replicas}")
        kind = {
            "add-learner": ConfChangeType.ConfChangeAddLearnerNode,
            "promote": ConfChangeType.ConfChangeAddNode,
            "remove": ConfChangeType.ConfChangeRemoveNode,
        }.get(action)
        if kind is None:
            raise ValueError(f"unknown reconfig action {action!r}")
        match = self.rn.peer_match() if action == "promote" else None
        results: Dict[int, str] = {}
        for g in groups:
            g = int(g)
            if not self.rn.is_leader(g):
                results[g] = "not-leader"
                continue
            if action == "promote":
                with self._lock:
                    is_learner = bool(self.conf.learner[g, t - 1])
                if not is_learner:
                    results[g] = "not-learner"
                    continue
                # Catch-up gate (the promote_member gate, read
                # from the leader's device progress view): the learner
                # must cover >= LEARNER_READY_PERCENT of the leader's
                # own log before its vote starts counting.
                lead_last = int(self.rn.m_last[g])
                lm = int(match[g, t - 1])
                if lead_last > 0 and (
                        lm < lead_last * self.LEARNER_READY_PERCENT):
                    results[g] = f"not-ready:{lm}/{lead_last}"
                    continue
            if action == "remove" and t == self.id:
                # Removing the leader through itself wedges the group's
                # proposals mid-flight; transfer leadership away first.
                results[g] = "self"
                continue
            cc = ConfChangeV2(changes=[ConfChangeSingle(kind, t)])
            if joint:
                cc.transition = (
                    ConfChangeTransition.ConfChangeTransitionJointImplicit)
            try:
                results[g] = ("ok" if self.propose_conf(g, cc)
                              else "not-leader")
            except ConfChangeError as e:
                results[g] = f"refused:{e}"
        return results

    def wait_transfers(self, groups, to_member: int,
                       timeout: float = 5.0) -> Tuple[List[int],
                                                      List[int]]:
        """Bounded wait for staged leadership transfers: a group is
        done once this member no longer leads it (the transferee's
        TimeoutNow campaign displaced us) or it already names the
        target as leader. Returns (done, pending-at-timeout)."""
        pending = {int(g) for g in groups}
        done: List[int] = []
        deadline = time.monotonic() + timeout
        while pending and time.monotonic() < deadline:
            for g in list(pending):
                if (not self.rn.is_leader(g)
                        or self.rn.lead(g) == to_member):
                    pending.discard(g)
                    done.append(g)
            if pending:
                time.sleep(0.01)
        return sorted(done), sorted(pending)

    def conf_snapshot(self) -> Dict[str, object]:
        """Membership rollup for checkers/admin (checker duck-type:
        functional.checker.check_config_safety)."""
        with self._lock:
            c = self.conf
            return {
                "voters": [tuple((np.nonzero(c.voter[g])[0]
                                  + 1).tolist())
                           for g in range(self.g)],
                "voters_out": [tuple((np.nonzero(c.voter_out[g])[0]
                                      + 1).tolist())
                               for g in range(self.g)],
                "learners": [tuple((np.nonzero(c.learner[g])[0]
                                    + 1).tolist())
                             for g in range(self.g)],
                "in_joint": c.in_joint.copy(),
                "applied_index": c.applied_index.copy(),
                "epoch": c.epoch.copy(),
                "refused": int(c.refused),
            }

    def conf_history(self, group: int) -> List[Dict]:
        with self._lock:
            return self.conf.history(group)

    # -- durability fence ------------------------------------------------------

    def _fence_lift_locked(self) -> List[int]:
        """Collect fenced groups that re-proved durability (caller
        holds _lock); flips the host mirror, leaves the device edit to
        _fence_lift_apply (outside the lock). Two sufficient proofs:

        * **index**: the durable log reaches the watermark point again
          (``dur_last >= wm_last``) — every pre-crash promise is backed
          by fsync'd bytes once more;
        * **term**: the durable log ENDS in a term above the
          watermark's (``dur_term > wm_term``). A later-term leader was
          elected by a quorum of non-fenced members (this member
          granted nothing while fenced), so by Leader Completeness its
          log carries every entry committed at terms <= wm_term; the
          prefix-matched append that landed the later-term entry
          therefore proves the un-recovered old suffix could never
          have been committed. Without this rule a FALSE fence — a
          kill mid-write persisting a batch's watermark but not its
          (never-acked) entries — wedges an idle group forever: the
          new leader's log is legitimately shorter than the
          overshooting watermark, so the index proof alone never
          arrives.
        """
        if not self.fence_enabled or not self._fenced.any():
            return []
        lifts: List[int] = []
        for row in np.nonzero(self._fenced)[0]:
            if (self._dur_last[row] >= self._wm_last[row]
                    or self._dur_term[row] > self._wm_term[row]):
                self._fenced[row] = False
                lifts.append(int(row))
        return lifts

    def _fence_lift_apply(self, lifts: List[int]) -> None:
        """Stage the device-side fence drop for healed groups (the
        rawnode applies it at the head of the next round) and move the
        gauge. The durable log re-reaching the watermark point means
        every pre-crash promise is backed by fsync'd bytes again —
        terms at a given index never regress across leaders, so the
        comparison needs no term recheck."""
        if not lifts:
            return
        for row in lifts:
            self.rn.set_fence(row, False)
        remaining = int(self._fenced.sum())
        self._g_fenced.set(remaining)
        _log.info(
            "member %d: durability fence lifted for group(s) %s "
            "(%d still fenced)", self.id, lifts[:16], remaining)
        self._work.set()

    def health(self) -> Dict[str, object]:
        """Fence/catch-up visibility (admin 'health' op): per-group
        fenced state, index gap to the durable watermark, and the boot
        WAL-tail classification (walog tail_state)."""
        with self._lock:
            fenced = np.nonzero(self._fenced)[0]
            gaps = {
                int(g): int(self._wm_last[g] - self._dur_last[g])
                for g in fenced
            }
            joint_groups = int(self.conf.in_joint.sum())
            learner_slots = int(self.conf.learner.sum())
            conf_applied = int(self.conf.epoch.sum())
            conf_refused = int(self.conf.refused)
        with self._wal_cv:
            wal_depth = len(self._wal_pending)
        fsyncs = int(self.stats.get("wal_fsyncs", 0))
        rounds_covered = int(self.stats.get("wal_fsync_rounds", 0))
        wal_pipe = {
            # Async group-commit pipeline visibility: live
            # queue depth, fsync count, and the amortization ratio the
            # pipeline exists for (device rounds whose persistence one
            # fsync covered) — fleet_console's wal-pipe column reads
            # this.
            "enabled": self._wal_worker is not None,
            "queue_depth": wal_depth,
            "fsyncs": fsyncs,
            "rounds_per_fsync": (
                round(rounds_covered / fsyncs, 2) if fsyncs else 0.0),
            "bytes_per_fsync": (
                int(self.stats.get("wal_fsync_bytes", 0) // fsyncs)
                if fsyncs else 0),
            "max_delay_s": self._wal_max_delay,
            "max_bytes": self._wal_max_bytes,
        }
        # Log-lifecycle visibility: segments + bytes on
        # disk, the oldest still-pinned sealed segment and the group
        # pinning it, snapshot-file census, and the ring back-pressure
        # high-water — fleet_console's lifecycle columns read this.
        wal_dir = os.path.join(self.dir, "wal")
        wal_segments = 0
        wal_bytes = 0
        try:
            for fname in os.listdir(wal_dir):
                if fname.endswith(".wal"):
                    wal_segments += 1
                    try:
                        wal_bytes += os.path.getsize(
                            os.path.join(wal_dir, fname))
                    except OSError:
                        pass
        except OSError:
            pass
        with self._lock:
            sealed = len(self._sealed)
            oldest = (int(self._sealed[0]["seq"])
                      if self._sealed else -1)
            pinned_group = self._pinned_group
            wal_pinned = self._wal_pinned_flag
        lifecycle = {
            "enabled": (self.snap_cadence is not None
                        or self.wal_rotate_bytes is not None),
            "snap_cadence": self.snap_cadence,
            "snap_keep": self.snap_keep,
            "wal_rotate_bytes": self.wal_rotate_bytes,
            "wal_segments": wal_segments,
            "wal_bytes": wal_bytes,
            "sealed_segments": sealed,
            "oldest_pinned_seq": oldest,
            "pinned_group": int(pinned_group),
            "wal_pinned": bool(wal_pinned),
            "wal_cuts": int(self.stats.get("wal_cuts", 0)),
            "segments_released": int(
                self.stats.get("wal_segments_released", 0)),
            "snapshots_built": int(
                self.stats.get("snapshots_built", 0)),
            "snap_files": int(self._snap_file_count),
            "snap_files_pruned": int(
                self.stats.get("snap_files_pruned", 0)),
            "snap_build_errors": int(
                self.stats.get("snap_build_errors", 0)),
        }
        occ_now = int((self.rn.m_last - self.rn.m_snap).max())
        if occ_now > self._ring_occ_hw:
            self._ring_occ_hw = occ_now
        ring = {
            # Ring back-pressure: occupancy high-water vs the window,
            # and how many proposals the typed ring_full refusal
            # turned away before the device would have dropped them.
            "window": int(self.cfg.window),
            "occ_now": occ_now,
            "occ_high_water": int(self._ring_occ_hw),
            "full_refusals": int(
                self.stats.get("ring_full_refusals", 0)),
        }
        # Device apply plane visibility: slot occupancy
        # high-water vs capacity, live lease/watch census, and the
        # lease-read hit ratio — fleet_console's plane columns read
        # this.
        ap: Dict[str, object] = {"enabled": False}
        if self.rn.plane is not None:
            ps = dict(self.rn.plane_stats)
            hits = int(self.stats.get("lease_read_hits", 0))
            falls = int(self.stats.get("lease_read_fallbacks", 0))
            ap = {
                "enabled": True,
                "capacity": int(self.cfg.apply_capacity),
                "watch_slots": int(self.cfg.apply_watch_slots),
                "slots_high_water": int(ps["slots_hw"]),
                "overflow_rows": int(ps["overflow_rows"]),
                "active_leases": int(ps["active_leases"]),
                "dispatches": int(ps["dispatches"]),
                "puts": int(ps["puts"]),
                "dels": int(ps["dels"]),
                "expired": int(ps["expired"]),
                "watch_events": int(ps["watch_events"]),
                "watch_armed": len(self._watches),
                "lease_holders": int(
                    (self.rn.m_lease_ticks > 0).sum()),
                "lease_read_hits": hits,
                "lease_read_fallbacks": falls,
                "lease_hit_ratio": (
                    round(hits / (hits + falls), 4)
                    if hits + falls else 0.0),
            }
        return {
            "wal_pipeline": wal_pipe,
            "lifecycle": lifecycle,
            "ring": ring,
            "apply_plane": ap,
            "fence_enabled": self.fence_enabled,
            # IO-error contract visibility: live ENOSPC
            # back-pressure, the fail-stop cause when a storage fault
            # killed this member, and the boot-time salvage record for
            # at-rest corruption amputations.
            "disk_full": self._disk_full,
            "disk_full_waits": int(self.stats.get("disk_full_waits", 0)),
            "fail_stop": self._fail_stop_cause,
            "salvage": self._salvage,
            "wal_tail": (TAIL_NAMES.get(self._tail_state, "unknown")
                         if self._tail_state is not None else "fresh"),
            "fenced_groups": [int(g) for g in fenced],
            "catchup_gap": gaps,
            "boot_fenced": self._boot_fenced,
            # Membership control plane: live joint/learner
            # census + applied/refused conf-change totals — the
            # fleet_console joint/learner columns read these.
            "joint_groups": joint_groups,
            "learner_slots": learner_slots,
            "conf_applied": conf_applied,
            "conf_refused": conf_refused,
            "crashed": self._crashed,
            "stopped": self._stopped.is_set(),
        }

    # -- wire ------------------------------------------------------------------

    def deliver(self, group: int, m: Message) -> None:
        """Entry point for the router/transport."""
        if self._stopped.is_set():
            return
        if int(m.type) == int(MessageType.MsgSnap):
            # Restore app state before the device sees the install — all
            # under _lock so run_round's apply step can't interleave
            # stale entries into the freshly restored state.
            idx = m.snapshot.metadata.index
            lifts: List[int] = []
            fail: Optional[Tuple[str, BaseException]] = None
            with self._lock:
                if self._stopped.is_set():
                    # Re-check under _lock: a crash() that won the lock
                    # first has closed the WAL handle this path appends
                    # to (the unlocked check above is advisory only).
                    return
                if idx > self.applied_index[group]:
                    if self._disk_full:
                        # Write-back-pressured: drop the install BEFORE
                        # any state mutates — an install that cannot be
                        # WAL-recorded is a replay hole, and raft
                        # re-sends snapshots (lossy-net semantics; the
                        # dwell cannot run here, it would sit on _lock).
                        self.stats["snap_dropped_disk_full"] = (
                            self.stats.get("snap_dropped_disk_full", 0)
                            + 1)
                        return
                    snap_term = m.snapshot.metadata.term
                    self._restore_data(group, m.snapshot.data, idx)
                    self.applied_index[group] = idx
                    self.rn.install_snapshot_state(group, idx)
                    # WAL-record the snapshot before any post-restore
                    # state can be acknowledged.
                    records: List[Tuple[int, bytes]] = [(
                        RT_SNAPSHOT,
                        _pack_snap(group, idx, snap_term,
                                   m.snapshot.data),
                    )]
                    # Membership rides the snapshot metadata: conf
                    # entries in the skipped log never arrive, so the
                    # carried ConfState supersedes whatever this member
                    # last applied (raft.restore → confchange.Restore).
                    cs = m.snapshot.metadata.conf_state
                    if cs is not None and cs.voters:
                        if self.conf.restore(group, idx, cs):
                            rows = np.asarray([group])
                            records.append((
                                RT_CONF_BATCH,
                                self.conf.pack_groups(rows)))
                            # Stage under the SAME lock as the conf
                            # mutation (see the conf-apply path): a
                            # post-release staging can lose the
                            # last-writer-wins race against a
                            # concurrent apply and leave the device
                            # on the older config.
                            self.rn.set_membership_many(
                                rows, *self.conf.masks(rows))
                            self._update_conf_gauges()
                    wl = wt = None
                    if self.fence_enabled:
                        wl = max(idx, int(self._wm_last[group]))
                        wt = (snap_term if wl == idx
                              else int(self._wm_term[group]))
                        records.append((
                            RT_WATERMARK,
                            _pack_wm(group, wl, wt,
                                     max(idx,
                                         int(self._wm_commit[group])))))

                    def _snap_mirrors(group=group, idx=idx,
                                      snap_term=snap_term,
                                      wl=wl, wt=wt) -> None:
                        # Snapshot-driven heal: the install makes (idx,
                        # snap_term) durable and committed, so the
                        # durable mirrors jump with it and a fence
                        # demanding anything at-or-below idx lifts —
                        # protocol-aware re-convergence needs no log
                        # replay when the quorum ships state directly.
                        # Runs ONLY once the records above are fsync'd
                        # (inline below, or the pipeline's on_synced
                        # callback under _lock).
                        if idx > self._dur_last[group]:
                            self._dur_last[group] = idx
                            self._dur_term[group] = snap_term
                        self._dur_commit[group] = max(
                            self._dur_commit[group], idx)
                        if wl is not None and not self._fenced[group]:
                            self._wm_last[group] = wl
                            self._wm_term[group] = wt
                            self._wm_commit[group] = max(
                                self._wm_commit[group], idx)
                        # Install = durable snapshot cover too (the
                        # full RT_SNAPSHOT record just fsync'd): WAL
                        # segments below idx stop being needed for
                        # this group. Evidence segment = the covering
                        # fsync's tail (file bookkeeping untouched —
                        # there is no FILE, and cadence measures
                        # against the newest file, so a freshly
                        # installed group builds one promptly).
                        if idx >= int(self._snap_cover[group]):
                            self._snap_cover[group] = idx
                            self._snap_seq[group] = max(
                                int(self._snap_seq[group]),
                                int(self._last_sync_seq))

                    if self._wal_worker is not None:
                        # Pipeline mode: the records ride the open
                        # buffer IN ORDER with every pending round
                        # batch; the generation bump makes any
                        # already-submitted (older) batch skip its
                        # now-stale mirror delta for this group, and
                        # the mirror jump itself waits for the covering
                        # fsync via on_synced.
                        self._snap_gen[group] += 1
                        self._wal_submit_locked(
                            records, must_sync=True,
                            on_synced=_snap_mirrors)
                    else:
                        try:
                            # _wal_io nested under _lock (the documented
                            # order): the inline drain writes under
                            # _wal_io WITHOUT _lock now, so the handle
                            # needs its own serialization here too.
                            with self._wal_io:
                                if self._wal_closed:
                                    return
                                for rt, d in records:
                                    self.wal.append(rt, d)
                                self.wal.flush(sync=True)
                                self._last_sync_seq = int(
                                    self.wal.tail_seq())
                        except Exception as e:  # noqa: BLE001
                            # Storage fault mid-install (state already
                            # mutated): fail-stop — the install is
                            # all-or-nothing, and a disk-full dwell
                            # here would sit on _lock. Deferred below:
                            # crash() takes _lock itself.
                            fail = ("snap_install", e)
                        else:
                            # Inline installs bump the generation too:
                            # the drain's mirror fold now runs outside
                            # _lock and guards on it (see
                            # _process_readys).
                            self._snap_gen[group] += 1
                            _snap_mirrors()
                            lifts = self._fence_lift_locked()
            if fail is not None:
                self._io_fail_stop(*fail)
                return
            self._fence_lift_apply(lifts)
        self.rn.step(group, m)
        self._work.set()

    def deliver_block(self, blk) -> None:
        """Batch entry point: payload-free messages as one SoA block
        (no snapshots ever ride a block)."""
        if self._stopped.is_set():
            return
        # A member that runs fewer rounds than a peer would queue that
        # peer's heartbeats without bound, and a ReadIndex on the peer
        # would wait behind them for seconds: the newest heartbeat for
        # a row replaces those still queued (rawnode.step_block).
        self.rn.step_block(blk, supersede_heartbeats=True)
        self._work.set()

    # -- API -------------------------------------------------------------------

    def propose(self, group: int, payload: bytes) -> bool:
        """Propose on this member; returns False if this member isn't
        the group's leader (the caller redirects, like etcd clients
        following leader hints) — or while the member sits in ENOSPC
        write-back-pressure (disk_full: accepting a proposal that can
        never persist would just strand the client)."""
        if self._disk_full:
            return False
        if not self.rn.is_leader(group):
            return False
        if self._ring_full(group):
            # Typed ring back-pressure (the disk_full twin): the log
            # ring has no headroom for another proposal this round —
            # the device clamp would silently drop it. Refuse so the
            # caller retries after compaction frees slots.
            self.stats["ring_full_refusals"] = (
                self.stats.get("ring_full_refusals", 0) + 1)
            return False
        self.rn.propose(group, payload)
        self._work.set()
        return True

    def leader_of(self, group: int) -> int:
        """Member id this member believes leads `group` (0 unknown)."""
        return self.rn.lead(group)

    def is_leader(self, group: int) -> bool:
        return self.rn.is_leader(group)

    def campaign(self, groups) -> None:
        self.rn.campaign(np.asarray(groups))
        self._work.set()

    def transfer_leader(self, group: int, target_member: int) -> bool:
        """Hand leadership of `group` to `target_member` (slot+1) —
        the admin rebalancing primitive; campaigns cannot displace a
        healthy leader under pre-vote/check-quorum, transfers can
        (ref: raft.go:1339 MsgTransferLeader, campaignTransfer)."""
        if not self.rn.is_leader(group):
            return False
        if self.rn.plane is not None:
            # Block lease reads for the group BEFORE the transfer
            # stages: the device zeroes the lease lane in the same
            # round the transfer applies, but a read racing the
            # staging window would still see the stale mirror —
            # MsgTimeoutNow bypasses the election-timeout silence the
            # lease safety argument rests on. The block lifts once
            # the mirror reads 0 (linearizable_get).
            with self._lock:
                self._lease_block.add(int(group))
        self.rn.transfer_leader(group, target_member - 1)
        self._work.set()
        return True

    def get(self, group: int, key: bytes) -> Optional[bytes]:
        """Serializable read from local applied state."""
        return self.kvs[group].data.get(key)

    def linearizable_get(self, group: int, key: bytes,
                         timeout: float = 5.0) -> Optional[bytes]:
        """Linearizable read: open a device ReadIndex batch, wait for
        its heartbeat-ack quorum, wait until the local apply watermark
        covers the confirmed index, then read (ref: v3_server.go
        linearizableReadLoop over Ready.ReadStates — here the batch
        runs in the device kernel). Raises on a non-leader member so
        callers redirect like clients following leader hints.

        Lease fast path (cfg.apply_plane): when this member's lease
        lane shows quorum evidence within the last election-timeout
        ticks (minus lease_read_margin for tick skew), no other leader
        can exist — a peer needs a full election timeout of leader
        silence to win, counted in the same tick currency — so the
        local applied state IS linearizable and the read is one host
        lookup with ZERO per-read quorum rounds (ref: raft §6.4 /
        etcd ReadOnlyLeaseBased). Every acknowledged write on this
        group was acknowledged at-or-below the local apply watermark
        (writes ack on this member after apply), and prior ReadIndex
        reads waited for apply too, so serving the applied host tier
        preserves real-time order. Transfers break the silence
        argument (MsgTimeoutNow campaigns immediately): _lease_block
        refuses lease reads from transfer staging until the device
        round zeroes the lane."""
        if not self.rn.is_leader(group):
            raise NotLeaderError(f"group {group}: not leader here")
        if self.rn.plane is not None:
            with self._lock:
                lt = int(self.rn.m_lease_ticks[group])
                if group in self._lease_block:
                    if lt == 0:
                        # Device processed the transfer staging; from
                        # here the mirror is truth again (it stays 0
                        # until quorum evidence re-arms it with no
                        # transfer in flight).
                        self._lease_block.discard(group)
                    lt = 0
                hit = lt >= self.cfg.lease_read_margin
                if hit:
                    self.stats["lease_read_hits"] = (
                        self.stats.get("lease_read_hits", 0) + 1)
                    if self._m_ap_hit is not None:
                        self._m_ap_hit.inc()
                else:
                    self.stats["lease_read_fallbacks"] = (
                        self.stats.get("lease_read_fallbacks", 0) + 1)
                    if self._m_ap_fb is not None:
                        self._m_ap_fb.inc()
            if hit:
                return self._lease_masked_get(group, key)
        # Any batch already opened captured its commit index BEFORE
        # this request; the serving batch must open at-or-after it
        # (the device latches requests arriving mid-batch, so waiting
        # for confirmed seq > the pre-request opened seq is exact).
        # The seq guard alone is not enough: a batch can open in the
        # same device round that commits a write the caller already
        # observed applied (solo groups confirm instantly), so the
        # confirmed index must also cover the apply watermark at
        # request time — every write this caller could have observed
        # locally is at-or-below it.
        with self._read_cv:
            base_open = self._read_opened.get(group, 0)
        base_applied = int(self.applied_index[group])
        self.rn.read_index(group)
        deadline = time.monotonic() + timeout

        def confirmed():
            got = self._read_results.get(group)
            ok = (
                got is not None
                and got[0] > base_open
                and got[1] >= base_applied
            )
            return got if ok else None

        with self._read_cv:
            while True:
                got = confirmed()
                if got is not None:
                    break
                rem = deadline - time.monotonic()
                if rem <= 0:
                    raise TimeoutError(
                        f"group {group}: ReadIndex quorum not confirmed")
                self._read_cv.wait(rem)
            idx = got[1]
            while self.applied_index[group] < idx:
                rem = deadline - time.monotonic()
                if rem <= 0:
                    raise TimeoutError(
                        f"group {group}: apply lagging read index {idx}")
                self._read_cv.wait(rem)
        return self.kvs[group].data.get(key)

    def crash(self) -> None:
        """Simulated ``kill -9`` for chaos testing: mark the member dead
        and close the WAL handle WITHOUT draining queued Readys — every
        Ready still sitting in ``_ready_q`` (persist not yet run) is
        torn away, exactly the suffix a real crash at this point loses.
        The handle close releases the WAL dir flock so a restarted
        member (a fresh ``MultiRaftMember`` on the same data_dir, booting
        through ``_replay``) can take it in the same process. Closing an
        idle handle flushes at most already-appended-unsynced bytes,
        which only ever makes the survivor MORE durable — never less —
        so no invariant can be violated by the simulation shortcut."""
        with self._lock:
            if self._stopped.is_set():
                return
            self._crashed = True
            self._stopped.set()
            # _wal_io nested under _lock (the documented order): the
            # WAL-commit worker holds _wal_io for the duration of any
            # in-flight write/fsync and NEVER takes _lock while holding
            # it, so this close waits out at most one fsync and can
            # never race the native handle (a close under a live
            # fdatasync is C-level use-after-free).
            with self._wal_io:
                self._wal_closed = True
                try:
                    self._wal_tail_at_crash = self.wal.tail_offset()
                    self.wal.close()
                except WalogError:
                    pass
        # Unpark the WAL-commit worker; pending waves are torn away by
        # its _wal_closed/_crashed gates — exactly the unfsynced,
        # never-acked suffix a real kill at this point loses.
        if self._wal_worker is not None:
            with self._wal_cv:
                self._wal_stop = True
                self._wal_cv.notify_all()
        self._work.set()
        with self._read_cv:
            self._read_cv.notify_all()
        # Unpark the drain worker; queued Readys ahead of the sentinel
        # are discarded by the _crashed gate. The put must be RELIABLE:
        # a put_nowait swallowed by a full queue (crash mid-backpressure
        # is the likeliest crash) parks the worker on get() forever once
        # it drains the gated batches — and stop() after a crash returns
        # at its _stopped check without ever enqueueing a sentinel. A
        # crash FROM the drain worker itself (failpoint action) needs no
        # sentinel: it is unwinding via FailpointPanic.
        if (self._drainer is not None
                and self._drainer is not threading.current_thread()):
            while self._drainer.is_alive():
                try:
                    self._ready_q.put(None, timeout=0.2)
                    break
                except queue_mod.Full:
                    continue

    def stop(self) -> None:
        # Atomic claim: concurrent stop() calls must not both proceed to
        # the WAL close (Event.is_set/set is a check-then-act race).
        with self._lock:
            if self._stopped.is_set():
                return
            self._stopped.set()
        for t in (self._ticker, self._runner):
            if t.is_alive() and t is not threading.current_thread():
                t.join(timeout=5)
        drainer_done = True
        if self._drainer is not None and self._drainer.is_alive():
            if self._drainer is threading.current_thread():
                # Fatal-fault stop FROM the drain worker (_drain_loop
                # guard): it is exiting anyway; a put(None) here could
                # deadlock on a full queue. Leave the WAL open (the
                # comment below) — process exit closes it.
                drainer_done = False
            else:
                # Timed put, re-checking liveness: a drainer that hit
                # its fatal-fault guard is alive-but-exiting and will
                # never drain a full queue — an untimed put(None) here
                # would hang shutdown (and the WAL flush after it).
                while self._drainer.is_alive():
                    try:
                        self._ready_q.put(None, timeout=0.2)
                        break  # drainer drains all queued, then exits
                    except queue_mod.Full:
                        continue
                self._drainer.join(timeout=60)
                drainer_done = not self._drainer.is_alive()
        # Drain the WAL pipeline DETERMINISTICALLY: the drainer above
        # already submitted every queued Ready, so signaling stop and
        # joining the worker flushes + releases every pending wave —
        # stop() returns with nothing in flight and nothing lost (the
        # stop-during-pending-fsync regression). A stop() issued FROM
        # the worker (its fatal-fault guard) skips the join; the
        # worker is exiting anyway and the close below stays guarded.
        walworker_done = True
        if self._wal_worker is not None and self._wal_worker.is_alive():
            if self._wal_worker is threading.current_thread():
                walworker_done = False
            else:
                with self._wal_cv:
                    self._wal_stop = True
                    self._wal_cv.notify_all()
                self._wal_worker.join(timeout=60)
                walworker_done = not self._wal_worker.is_alive()
        with self._lock:
            with self._wal_io:
                if self._wal_closed:
                    return  # crash() already tore the handle down
                try:
                    self.wal.flush(sync=True)
                except (WalogError, OSError):
                    # Storage fault at shutdown: skip the close-flush.
                    # The unflushed suffix was never released/acked, so
                    # losing it is the crash contract, not data loss —
                    # and retrying an fsync here is exactly what the
                    # IO-error contract forbids.
                    _log.exception(
                        "member %d: final WAL flush failed at stop",
                        self.id)
                if drainer_done and walworker_done:
                    # Never close the WAL under a live drain/WAL-commit
                    # worker — its next append would hit a closed file
                    # and silently drop the queued rounds' persistence.
                    # Leaving it open on a wedged worker is safe:
                    # process exit closes the fd and the CRC chain ends
                    # at the last completed record.
                    self.wal.close()
                    self._wal_closed = True


class InProcRouter:
    """Wires MultiRaftMembers in one process; per-destination worker
    queues preserve per-peer ordering (rafthttp's stream semantics)
    without blocking the sender's round loop."""

    kind = "inproc"

    def __init__(self) -> None:
        self.members: Dict[int, MultiRaftMember] = {}
        self._isolated: set = set()
        self._lock = threading.Lock()
        # Loss counters live on the shared pkg.metrics registry — ONE
        # source of truth for drop classes across routers, fabrics and
        # the telemetry plane. This router keeps
        # per-(member, class) label children plus the child's value at
        # first touch, so stats() still reports per-instance counts
        # while /metrics exposes the process-wide monotone totals.
        self._loss = router_loss_counter()
        self._children: Dict[Tuple[int, str], Tuple[object, float]] = {}

    def _count(self, member_id: int, key: str, n: int = 1) -> None:
        with self._lock:
            ent = self._children.get((member_id, key))
            if ent is None:
                child = self._loss.labels("inproc", str(member_id), key)
                ent = (child, child.value())
                self._children[(member_id, key)] = ent
        ent[0].inc(n)

    def stats(self) -> Dict[int, Dict[str, int]]:
        """Per-member counters: isolated_drop (suppressed by
        isolate()), no_route (target not attached), deliver_error
        (exception swallowed on the deliver path). Values are read back
        from the shared registry (etcd_tpu_router_loss_total), scoped
        to this router instance."""
        with self._lock:
            items = list(self._children.items())
        out: Dict[int, Dict[str, int]] = {}
        for (mid, key), (child, base) in items:
            out.setdefault(mid, {})[key] = int(child.value() - base)
        return out

    def attach(self, m: MultiRaftMember) -> None:
        self.members[m.id] = m
        m._send = self.send
        m._send_block = self.send_block

    def send(self, from_id: int, batch: List[Tuple[int, Message]]) -> None:
        with self._lock:
            if from_id in self._isolated:
                sender_isolated = True
                targets = {}
            else:
                sender_isolated = False
                targets = {
                    to: mem for to, mem in self.members.items()
                    if to not in self._isolated
                }
        if sender_isolated:
            self._count(from_id, "isolated_drop", len(batch))
            return
        for group, msg in batch:
            mem = targets.get(msg.to)
            if mem is None:
                self._count(
                    from_id,
                    "isolated_drop" if msg.to in self.members
                    else "no_route",
                )
                continue
            try:
                mem.deliver(group, msg)
            except Exception:  # noqa: BLE001 — drop, like a lossy net
                self._count(from_id, "deliver_error")

    def send_block(self, from_id: int, blk) -> None:
        with self._lock:
            if from_id in self._isolated:
                sender_isolated = True
                targets = {}
            else:
                sender_isolated = False
                targets = {
                    to: mem for to, mem in self.members.items()
                    if to not in self._isolated
                }
        if sender_isolated:
            self._count(from_id, "isolated_drop", len(blk))
            return
        for to, sub in blk.split_by_target().items():
            mem = targets.get(to)
            if mem is None:
                self._count(
                    from_id,
                    "isolated_drop" if to in self.members else "no_route",
                    len(sub),
                )
                continue
            try:
                mem.deliver_block(sub)
            except Exception:  # noqa: BLE001 — drop, like a lossy net
                self._count(from_id, "deliver_error", len(sub))

    def isolate(self, member_id: int) -> None:
        with self._lock:
            self._isolated.add(member_id)

    def heal(self, member_id: int) -> None:
        with self._lock:
            self._isolated.discard(member_id)


class TCPRouter:
    """Real-network fabric for MultiRaftMembers: one listener per
    member, one ordered stream per peer, frames carrying
    ``u32 len | u32 group | message-codec bytes`` (the rafthttp
    "message" codec with a group prefix — SURVEY §7.5's host-side
    per-shard message routing). Reuses ``MultiRaftMember.deliver()``
    exactly like InProcRouter; senders drop-don't-block (ref:
    etcdserver/raft.go:108-111)."""

    kind = "tcp"
    MAX_PENDING = 16384
    BLOCK_SENTINEL = 0xFFFFFFFF  # group-id marker for SoA block frames
    # Sender redial policy: bounded exponential backoff with ±50%
    # jitter (ref: rafthttp's probing/backoff discipline — a dead peer
    # must not be hammered at full rate, a recovered one must be found
    # within ~a second), capped per frame by REDIAL_BUDGET so a long
    # outage degrades to drop-don't-block instead of queue collapse.
    # Backoff sleeps use _stopped.wait, so stop() never waits on one.
    BACKOFF_BASE = 0.05
    BACKOFF_CAP = 1.0
    REDIAL_BUDGET = 3.0
    # Per-peer sender lanes (PriorityQueue; FIFO within a lane via the
    # monotone sequence number). Liveness traffic — the SoA block
    # frames carrying heartbeats/acks/votes — outranks bulk MsgApp
    # streams so queue pressure never churns leadership; stop outranks
    # everything so shutdown can't wedge behind a full bulk backlog.
    PRIO_STOP, PRIO_LIVE, PRIO_BULK = 0, 1, 2

    def __init__(self, member: MultiRaftMember,
                 bind: Tuple[str, int] = ("127.0.0.1", 0)) -> None:
        import itertools
        import socket

        from ..transport.codec import MAX_FRAME, decode_message, \
            encode_message

        self._socket = socket
        self._seq = itertools.count()  # FIFO tiebreak within a lane
        self._enc, self._dec = encode_message, decode_message
        self._max_frame = MAX_FRAME
        self.member = member
        member._send = self.send
        member._send_block = self.send_block
        self._stopped = threading.Event()
        self._lock = threading.Lock()
        # Fabric loss/error counters (never silently pass): queue-full
        # drops, oversize drops, dial failures, per-frame redial-budget
        # drops, send errors, corrupt inbound frames, deliver errors.
        # Counted on the shared registry (etcd_tpu_router_loss_total,
        # transport="tcp") — same source of truth as InProcRouter;
        # stats() reports this instance's deltas.
        self._loss = router_loss_counter()
        self._children: Dict[str, Tuple[object, float]] = {}
        self._stats_lock = threading.Lock()
        # peer id -> (queue, sender thread); established lazily.
        self._peers: Dict[int, "object"] = {}
        self._addrs: Dict[int, Tuple[str, int]] = {}
        self._conns: List["object"] = []  # accepted sockets, for stop()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(
            socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(bind)
        self._listener.listen(16)
        self.addr: Tuple[str, int] = self._listener.getsockname()
        threading.Thread(target=self._accept_loop, daemon=True).start()

    def add_peer(self, peer_id: int, addr: Tuple[str, int]) -> None:
        with self._lock:
            self._addrs[peer_id] = addr

    @staticmethod
    def _frame(group_or_sentinel: int, body: bytes) -> bytes:
        """The wire frame: u4 total (group word + body) | u4 group or
        BLOCK_SENTINEL | body. The one place the header layout is
        packed — the shm fabric reuses the body layout (group word +
        payload) without the length prefix."""
        return struct.pack(
            "<II", len(body) + 4, group_or_sentinel) + body

    def _count(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            ent = self._children.get(key)
            if ent is None:
                child = self._loss.labels(
                    "tcp", str(self.member.id), key)
                ent = (child, child.value())
                self._children[key] = ent
        ent[0].inc(n)

    def stats(self) -> Dict[str, int]:
        """Loss/error counters for this member's fabric (the TCP analog
        of InProcRouter.stats); chaos tests assert these move, operators
        read them through the admin 'stats' op. Values read back from
        the shared registry, scoped to this router instance."""
        with self._stats_lock:
            items = list(self._children.items())
        return {k: int(child.value() - base) for k, (child, base) in items}

    # -- outbound --------------------------------------------------------------

    def send(self, _from_id: int,
             batch: List[Tuple[int, Message]]) -> None:
        import queue as _q  # stdlib; alias avoids shadowing below

        # Resolve/create destination queues once per batch under one
        # lock acquisition (send runs on every member round).
        targets = {m.to for _g, m in batch}
        queues: Dict[int, "_q.Queue"] = {}
        with self._lock:
            if self._stopped.is_set():
                return
            for to in targets:
                ent = self._ensure_peer_locked(to)
                if ent is not None:
                    queues[to] = ent[0]
        for group, m in batch:
            q2 = queues.get(m.to)
            if q2 is None:
                self._count("no_route")
                continue
            try:
                q2.put_nowait((self.PRIO_BULK, next(self._seq),
                               (group, m)))
            except _q.Full:  # drop, never block the round loop
                self._count("queue_full_drop")

    def send_block(self, _from_id: int, blk) -> None:
        """Ship a SoA block: pre-encoded frames per target member (vs
        one frame per message on the object path). Each target's block
        is split into a LIVENESS half (payload-free records:
        heartbeats/acks/votes, PRIO_LIVE) and a BULK half (MsgApp with
        entries, PRIO_BULK) — the rafthttp two-channel discipline
        (ref: server/etcdserver/api/rafthttp/peer.go:337-349): a queue
        full of append payloads must never starve or drop the liveness
        traffic, or followers churn leadership under load. Bulk frames
        exceeding the codec frame cap are chunked (an oversized frame
        would kill the receiver's stream every round, forever)."""
        import queue as _q

        rec = blk.rec
        tos = np.unique(rec["to"]).tolist()
        queues: Dict[int, "_q.Queue"] = {}
        with self._lock:
            if self._stopped.is_set():
                return
            for to in tos:
                ent = self._ensure_peer_locked(int(to))
                if ent is not None:
                    queues[int(to)] = ent[0]

        def enqueue(q2, sub, prio) -> None:
            body = sub.to_bytes()
            if len(body) + 8 > self._max_frame and len(sub) > 1:
                # Contiguous record halves keep the entry arena as
                # pure slices (no gather on the chunking path).
                half = len(sub) // 2
                enqueue(q2, sub.take(slice(0, half)), prio)
                enqueue(q2, sub.take(slice(half, None)), prio)
                return
            if len(body) + 8 > self._max_frame:
                # single unsendable record: drop (raft retries)
                self._count("oversize_drop")
                return
            frame = self._frame(self.BLOCK_SENTINEL, body)
            try:
                q2.put_nowait((prio, next(self._seq), frame))
            except _q.Full:  # drop, never block the round loop
                self._count("queue_full_drop", len(sub))

        # One gather per shipped half, straight off the round block:
        # target and liveness/bulk masks combine BEFORE take(), so the
        # per-target sub-block is never materialized twice.
        has_ents = rec["n_ents"] > 0
        any_ents = bool(has_ents.any())
        for to in tos:
            to = int(to)
            tmask = rec["to"] == to
            q2 = queues.get(to)
            if q2 is None:
                self._count("no_route", int(tmask.sum()))
                continue
            if any_ents and (tmask & has_ents).any():
                live = blk.take(tmask & ~has_ents)
                bulk = blk.take(tmask & has_ents)
                if len(live):
                    enqueue(q2, live, self.PRIO_LIVE)
                enqueue(q2, bulk, self.PRIO_BULK)
            elif len(tos) == 1:
                enqueue(q2, blk, self.PRIO_LIVE)
            else:
                enqueue(q2, blk.take(tmask), self.PRIO_LIVE)

    def _ensure_peer_locked(self, to: int):
        """Resolve or lazily create the (queue, sender) for a peer.
        Caller holds _lock."""
        import queue as _q

        ent = self._peers.get(to)
        if ent is None:
            addr = self._addrs.get(to)
            if addr is None:
                return None
            q: "_q.Queue" = _q.PriorityQueue(maxsize=self.MAX_PENDING)
            t = threading.Thread(
                target=self._sender, args=(to, addr, q), daemon=True)
            self._peers[to] = (q, t)
            t.start()
            ent = self._peers[to]
        return ent

    def _sender(self, peer_id: int, addr: Tuple[str, int], q) -> None:
        """Per-peer sender lane. A down peer is redialed with bounded
        exponential backoff + jitter (state carries across frames so a
        long outage settles at BACKOFF_CAP instead of hammering), each
        frame charged at most REDIAL_BUDGET of redial time before it is
        dropped (drop-don't-block, ref: etcdserver/raft.go:108-111).
        Backoff sleeps are _stopped.wait()s: stop() interrupts them, so
        shutdown never serves out a backoff."""
        rng = random.Random()  # jitter decorrelates peers; not seeded
        sock = None
        backoff = self.BACKOFF_BASE
        while not self._stopped.is_set():
            _prio, _seq, item = q.get()
            if item is None:
                break
            if isinstance(item, bytes):  # pre-encoded block frame
                frame = item
            else:
                group, m = item
                # encode_message returns a length-prefixed frame; strip
                # its prefix — this framing carries its own total +
                # group id.
                payload = self._enc(m)[4:]
                if len(payload) + 4 > self._max_frame:
                    # The receiver would kill the stream on an
                    # oversized frame and the resend would churn it
                    # forever; drop it here instead (the raft layer
                    # retries via snapshots).
                    self._count("oversize_drop")
                    continue
                frame = self._frame(group, payload)
            deadline = time.monotonic() + self.REDIAL_BUDGET
            while not self._stopped.is_set():
                if sock is None:
                    try:
                        sock = self._socket.create_connection(
                            addr, timeout=2.0)
                        if (sock.getsockname()
                                == sock.getpeername()):
                            # TCP simultaneous-open self-connect:
                            # while the peer's listener is down, the
                            # kernel can hand the dial OUR ephemeral
                            # source port == the target port,
                            # connecting the socket to itself. Writes
                            # then "succeed" into our own receive
                            # buffer and deliver nothing — a silently
                            # dead lane (found by the chaos harness:
                            # a follower wedged one entry behind with
                            # zero errors counted).
                            self._count("self_connect")
                            try:
                                sock.close()
                            except OSError:
                                pass
                            sock = None
                            raise OSError("tcp self-connect")
                        sock.setsockopt(
                            self._socket.IPPROTO_TCP,
                            self._socket.TCP_NODELAY, 1)
                    except OSError:
                        sock = None
                        self._count("dial_fail")
                        delay = backoff * (0.5 + rng.random())
                        backoff = min(backoff * 2, self.BACKOFF_CAP)
                        if time.monotonic() + delay > deadline:
                            # Budget exhausted: drop THIS frame but keep
                            # the backoff state — the next frame resumes
                            # the slow probe instead of re-hammering.
                            self._count("redial_drop")
                            break
                        if self._stopped.wait(delay):
                            break
                        continue
                try:
                    sock.sendall(frame)
                    # Only a delivered frame proves the peer healthy:
                    # resetting on dial success would let a peer that
                    # accepts connections but RSTs every write erase
                    # the backoff each cycle — a full-speed
                    # dial/send/reset spin.
                    backoff = self.BACKOFF_BASE
                    break
                except OSError:
                    try:
                        sock.close()
                    except OSError:
                        pass
                    sock = None
                    self._count("send_error")
                    delay = backoff * (0.5 + rng.random())
                    backoff = min(backoff * 2, self.BACKOFF_CAP)
                    if time.monotonic() + delay > deadline:
                        # A peer that accepts dials but resets every
                        # send must not pin this lane to one frame.
                        self._count("redial_drop")
                        break
                    if self._stopped.wait(delay):
                        break
                    continue  # redial under the same frame budget
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    # -- inbound ---------------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            with self._lock:
                if self._stopped.is_set():
                    try:
                        conn.close()
                    except OSError:
                        pass
                    return
                self._conns.append(conn)
            threading.Thread(
                target=self._recv_loop, args=(conn,), daemon=True
            ).start()

    def _recv_loop(self, conn) -> None:
        # Frames are read straight into one preallocated buffer with
        # recv_into (grown on demand up to the frame cap) — a frame
        # costs ONE owned copy-out at the end instead of O(chunks)
        # bytes concatenations per frame. The copy-out is not
        # removable: deliver_block defers the block to the next round,
        # so handing it a view into a reused buffer would corrupt it
        # under the queue.
        buf = bytearray(64 * 1024)

        def read_exact(n: int) -> Optional[memoryview]:
            nonlocal buf
            if n > len(buf):
                buf = bytearray(n)
            mv = memoryview(buf)
            got = 0
            while got < n:
                try:
                    k = conn.recv_into(mv[got:n])
                except OSError:
                    return None
                if not k:
                    return None
                got += k
            return mv[:n]

        while not self._stopped.is_set():
            hdr = read_exact(4)
            if hdr is None:
                break
            (total,) = struct.unpack("<I", hdr)
            if not 4 <= total <= self._max_frame:
                self._count("recv_corrupt")
                break
            body = read_exact(total)
            if body is None:
                break
            (group,) = struct.unpack_from("<I", body)
            if group == self.BLOCK_SENTINEL:
                from .msgblock import MsgBlock

                try:
                    blk = MsgBlock.from_bytes(bytes(body[4:]))
                except ValueError:  # corrupt frame: drop conn
                    self._count("recv_corrupt")
                    break
                try:
                    self.member.deliver_block(blk)
                except Exception:  # noqa: BLE001 — lossy-net semantics
                    self._count("deliver_error")
                continue
            try:
                m = self._dec(bytes(body[4:]))
            except Exception:  # noqa: BLE001 — corrupt frame: drop conn
                self._count("recv_corrupt")
                break
            try:
                self.member.deliver(group, m)
            except Exception:  # noqa: BLE001 — lossy-net semantics
                self._count("deliver_error")
        try:
            conn.close()
        except OSError:
            pass

    def stop(self) -> None:
        self._stopped.set()
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:  # after _stopped: send() cannot add peers now
            peers = list(self._peers.values())
            self._peers.clear()
            conns = list(self._conns)
            self._conns.clear()
        for conn in conns:  # unblock recv threads parked in recv()
            try:
                conn.close()
            except OSError:
                pass
        for q, t in peers:
            try:
                q.put_nowait((self.PRIO_STOP, next(self._seq), None))
            except Exception:  # noqa: BLE001
                pass
        for _q2, t in peers:
            t.join(timeout=2)


def wait_group_leaders(members_fn, num_groups: int,
                       timeout: float = 60.0,
                       nudge_interval: float = 5.0) -> np.ndarray:
    """Block until every group has an elected leader among the members
    ``members_fn()`` returns; returns the per-group leader member id.
    Under heavy host load device rounds can lag the tick clock, so
    leaderless groups are periodically nudged with an explicit campaign
    on every member (any single member's replica may be unelectable —
    shorter log after a restart; pre-vote keeps the extra campaigns
    from disrupting groups that elect meanwhile). Shared by
    MultiRaftCluster and the chaos harness so their convergence
    behavior can't drift apart."""
    deadline = time.monotonic() + timeout
    next_nudge = time.monotonic() + nudge_interval
    while time.monotonic() < deadline:
        leads = np.zeros(num_groups, np.int64)
        for m in members_fn():
            _term, role, _lead = m.rn.m_view
            leads[role == LEADER] = m.id
        if (leads > 0).all():
            return leads
        if time.monotonic() >= next_nudge:
            stuck = np.nonzero(leads == 0)[0]
            for m in members_fn():
                m.campaign(stuck)
            next_nudge = time.monotonic() + nudge_interval
        time.sleep(0.05)
    raise TimeoutError("groups without leader")


class MultiRaftCluster:
    """Convenience harness: R members × G groups in one process."""

    def __init__(self, data_dir: str, num_members: int = 3,
                 num_groups: int = 16,
                 cfg: Optional[BatchedConfig] = None,
                 pipeline: bool = True,
                 mesh_devices: int = 0,
                 fence: bool = True,
                 trace: Optional[bool] = None,
                 wal_pipeline: Optional[bool] = None,
                 wal_group_max_delay: Optional[float] = None,
                 wal_group_max_bytes: Optional[int] = None,
                 disk_fault_hook_fn: Optional[
                     Callable[[int], Optional[Callable[[str, int],
                                                       None]]]] = None,
                 snap_cadence: Optional[int] = None,
                 snap_keep: int = SNAP_KEEP_DEFAULT,
                 wal_rotate_bytes: Optional[int] = None,
                 wal_pinned_segments: int = WAL_PINNED_SEGMENTS,
                 device=None,
                 ) -> None:
        self.router = InProcRouter()
        self.members: Dict[int, MultiRaftMember] = {}
        for mid in range(1, num_members + 1):
            m = MultiRaftMember(
                mid, num_members, num_groups, data_dir, cfg=cfg,
                pipeline=pipeline, mesh_devices=mesh_devices,
                fence=fence, trace=trace, wal_pipeline=wal_pipeline,
                wal_group_max_delay=wal_group_max_delay,
                wal_group_max_bytes=wal_group_max_bytes,
                # Log-lifecycle plane knobs.
                snap_cadence=snap_cadence, snap_keep=snap_keep,
                wal_rotate_bytes=wal_rotate_bytes,
                wal_pinned_segments=wal_pinned_segments,
                # Storage fault plane seam: a per-member
                # hook factory, e.g. DiskFaultPlan.hook_for.
                disk_fault_hook=(disk_fault_hook_fn(mid)
                                 if disk_fault_hook_fn is not None
                                 else None),
                device=device,
            )
            self.router.attach(m)
            self.members[mid] = m
        for m in self.members.values():
            m.start()

    def wait_leaders(self, timeout: float = 60.0) -> np.ndarray:
        """Block until every group has an elected leader; returns the
        per-group leader member id (the hosting analog of etcd clients
        retrying against a leaderless cluster)."""
        g = next(iter(self.members.values())).g
        return wait_group_leaders(
            self.members.values, g, timeout=timeout)

    def put(self, group: int, key: bytes, value: bytes,
            timeout: float = 10.0, lease_ttl: int = 0) -> None:
        """Client write: find the leader, propose, wait for local apply
        (read-your-write via the leader's applied state). lease_ttl>0
        attaches a plane lease (ticks): the replicated bytes are
        identical everywhere, expiry visibility is leader-local."""
        if lease_ttl:
            from .applyplane import put_payload

            payload = put_payload(key, value, lease_ttl)
        else:
            payload = GroupKV.put_payload(key, value)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            for m in self.members.values():
                if not m.propose(group, payload):
                    continue
                # Wait briefly for local apply; a stale (partitioned)
                # leader accepts but never commits — fall through and
                # retry on another member (retries are idempotent:
                # the orphaned entry is truncated by the new leader's
                # conflicting append).
                sub = min(deadline, time.monotonic() + 2.0)
                while time.monotonic() < sub:
                    if m.get(group, key) == value:
                        return
                    time.sleep(0.005)
            time.sleep(0.02)
        raise TimeoutError(f"put for group {group} did not commit")

    def stop(self) -> None:
        for m in self.members.values():
            m.stop()
