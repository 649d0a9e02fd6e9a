"""BatchedRawNode: the RawNode plugin contract over G groups at once, in
PyTorch.

Ports ``etcd_tpu/batched/rawnode.py``. This is the piece that turns the
device round into a *backend*: the same logical cycle as the reference's
RawNode —

    stage inputs → advance_round() → BatchedReady →
    persist (WAL) → apply → send → advance()

(ref: raft/rawnode.go:125-179 HasReady/Ready/Advance and the production
ordering in server/etcdserver/raft.go:158-315) — but for every group in
one device round. Entry payload bytes never touch the device: the host
keeps them in a per-row arena keyed by log index, assigns indexes to
proposals from the phase watermarks the round reports (StepAux), and
re-attaches payloads when draining committed ranges or building
outbound MsgApp messages.

A *row* is one replica instance this process hosts: (group, slot).
Topologies:

* hosting process (one replica slot of every group): rows = G,
  ``slots[i] = s`` constant, messages travel over the wire;
* in-proc all-replica layout (tests, single-process demos): rows = G*R.

The device side. The rawnode owns one device buffer per state field,
per inbox field, per round control vector and per round output it
reads back. A round stages its inputs in host buffers (pinned on CUDA),
applies the staged state edits in place, copies the inputs into their
device buffers, runs the round (step with aux, then pack_outbox) over
those buffers, copies the outputs it reads into host buffers, and waits
once. On CUDA the round itself is one replay of a CUDA graph, captured
after one eager round (graph.RoundGraphs, shared with the engine); on
the CPU it runs eagerly. No result the host keeps past a round is a
view of a buffer the next round rewrites.

The apply plane (``cfg.apply_plane``, applyplane.py) follows the same
rules: the rawnode owns the plane's state, its ``[n, A]`` record inputs
with the tick advance, and its frame. After a round's extraction, each
chunk of at most A committed records per row is copied from pinned
memory into the input buffers and folded by one replay of the plane's
own graph; each chunk's frame goes out by an asynchronous copy into a
pinned host buffer of its own, and the round waits once for all of
them. The dispatch, the staged plane edits and ``plane_capture`` all
hold ``graph.device_work()``, so a capture from another thread never
meets another member's capture (the reference's plane lock, which kept
a capture away from a donated carry, has no counterpart: the buffers
are owned).

Persistence contract per round (must_sync mirrors raft MustSync,
ref: raft/node.go:588-595): the caller drains ``BatchedReady`` to its
WAL and fsyncs BEFORE handing messages to the transport, then applies
committed entries, then calls ``advance()``.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..raft.types import Message, MessageType, Snapshot, SnapshotMetadata
from .applyplane import (
    KV_LANES,
    OP_PUT,
    dispatch as plane_dispatch,
    fnv1a32,
    gather_rows,
    init_plane,
    parse_payload,
)
from .compile_cache import enable_compile_cache
from .graph import RoundGraphs, device_work, storages, write_back
from .msgblock import (
    MsgBlock,
    compact_records,
    drop_superseded,
    merge_blocks,
    ragged_ranges,
    validate_block,
)
from .state import LEADER, BatchedConfig, I32, init_state, resolve_device
from .step import (
    KIND_APP,
    KIND_APP_RESP,
    KIND_HB,
    KIND_HB_RESP,
    KIND_VOTE,
    KIND_VOTE_RESP,
    NUM_KINDS,
    T_APP,
    T_APP_RESP,
    T_HB,
    T_HB_RESP,
    T_PREVOTE,
    T_PREVOTE_RESP,
    T_SNAP,
    T_TIMEOUT_NOW,
    T_VOTE,
    T_VOTE_RESP,
    empty_msgs,
    make_step_round,
    pack_outbox,
)
from .telemetry import TM_INDEX, lane_summary

# Inbox lane for each wire type (lanes are capacity classes; handlers
# dispatch on the type field — see step.py).
_LANE = {
    T_VOTE: KIND_VOTE,
    T_PREVOTE: KIND_VOTE,
    T_APP: KIND_APP,
    T_SNAP: KIND_APP,
    T_HB: KIND_HB,
    T_TIMEOUT_NOW: KIND_HB,
    T_VOTE_RESP: KIND_VOTE_RESP,
    T_PREVOTE_RESP: KIND_VOTE_RESP,
    T_APP_RESP: KIND_APP_RESP,
    T_HB_RESP: KIND_HB_RESP,
}


def _merge_append(prev: Message, m: Message, e: int) -> Optional[Message]:
    """`prev` and `m` as one MsgApp, when `m` continues `prev` (same
    sender and term, `m`'s previous entry is `prev`'s last) and the two
    hold at most `e` entries; None otherwise. The device reads the same
    log either way: `m` appended after `prev` in the round after it."""
    if (int(prev.type) != T_APP or prev.term != m.term or not prev.entries
            or not m.entries or len(prev.entries) + len(m.entries) > e):
        return None
    last = prev.entries[-1]
    if (last.index, last.term) != (m.index, m.log_term):
        return None
    return replace(prev, entries=list(prev.entries) + list(m.entries),
                   commit=max(prev.commit, m.commit))


# The ROADMAP items that port what this module refuses.
_NOT_PORTED = {
    "mesh": "ROADMAP A12 (the hosting stack: its mesh branch becomes a "
            "group-axis split over CUDA devices)",
}


def _refuse(what: str, key: str):
    raise NotImplementedError(f"{what} is not ported yet: {_NOT_PORTED[key]}")


# State fields the host reads after every round, in this order.
_HOST_STATE = ("term", "vote", "commit", "last", "role", "lead",
               "snap_index", "snap_term", "log_term", "read_seq",
               "read_index", "read_ready", "lease_ticks")


@dataclass
class RowRestore:
    """Boot state for one row (from WAL replay / snapshot)."""

    term: int = 0
    vote: int = 0  # slot+1, 0 = none
    commit: int = 0
    applied: int = 0  # host app state watermark (snapshot index)
    snap_index: int = 0  # log floor
    snap_term: int = 0
    entries: List[Tuple[int, int, bytes]] = field(default_factory=list)
    # (index, term, data[, etype]) strictly ascending, > snap_index
    # Membership at the snapshot point (None → full-voter bootstrap;
    # committed conf entries in the tail re-apply through Ready).
    conf_state: Optional[object] = None
    # Durability fence (protocol-aware torn-tail recovery): the hosting
    # layer sets this when the recovered WAL tail fell below the
    # group's durable watermark — the row boots with campaigning and
    # vote-granting suppressed until set_fence(row, False) lifts it.
    fenced: bool = False


_EMPTY_I8 = np.empty(0, np.int64)


class EntryBatch:
    """SoA batch of entry records to persist: parallel numpy arrays
    (row, index, term, etype) plus the payload list, in row-ascending
    index-ascending order. Iterates as (row, index, term, data, etype)
    tuples — the legacy consumer shape — while the arrays feed a batched
    WAL serialization directly."""

    __slots__ = ("rows", "idx", "term", "etype", "datas")

    def __init__(self, rows: np.ndarray = _EMPTY_I8,
                 idx: np.ndarray = _EMPTY_I8,
                 term: np.ndarray = _EMPTY_I8,
                 etype: np.ndarray = _EMPTY_I8,
                 datas: Optional[List[bytes]] = None) -> None:
        self.rows = rows
        self.idx = idx
        self.term = term
        self.etype = etype
        self.datas = datas if datas is not None else []

    def __len__(self) -> int:
        return len(self.datas)

    def __iter__(self):
        return iter(zip(self.rows.tolist(), self.idx.tolist(),
                        self.term.tolist(), self.datas,
                        self.etype.tolist()))


@dataclass
class BatchedReady:
    """One round's outstanding work (ref: raft/node.go:52-90 Ready,
    batched). Drain order: hardstates+entries+snapshots → WAL fsync →
    apply committed → messages → advance()."""

    hardstates: List[Tuple[int, int, int, int]]  # (row, term, vote, commit)
    entries: "EntryBatch"  # (row, index, term, data, etype) records
    # Device-installed snapshot restores this round: (row, index, term).
    # App-state restore happened host-side when the MsgSnap was staged.
    snapshots: List[Tuple[int, int, int]]
    committed: List[Tuple[int, List[Tuple[int, int, Optional[bytes]]]]]
    # (row, [(index, term, data or None for internal/empty)])
    messages: List[Tuple[int, Message]]
    must_sync: bool
    # Payload-free outbound messages as one SoA block (see msgblock.py);
    # `messages` then carries only MsgSnap.
    msg_block: Optional[MsgBlock] = None
    # Quorum-confirmed ReadIndex batches this round: (row, seq, index)
    # (ref: Ready.ReadStates, read_only.go advance).
    read_states: List[Tuple[int, int, int]] = field(default_factory=list)
    # Sampled trace keys: (group, term, index) of traced entries
    # persisted this round and of traced entries newly committed this
    # round. Empty lists when tracing is off.
    traced_entries: List[Tuple[int, int, int]] = field(default_factory=list)
    traced_commit: List[Tuple[int, int, int]] = field(default_factory=list)
    # Batches that OPENED this round: (row, seq). Hosts bind waiters to
    # the open batch so a later waiter is never served an earlier
    # batch's (stale) index.
    read_opened: List[Tuple[int, int]] = field(default_factory=list)
    # Ring term rows captured AT ROUND TIME for rows with outbound
    # MsgSnap: a pipelined drain worker processing this Ready later
    # must price the snapshot term from THIS round's ring.
    snap_rings: Dict[int, np.ndarray] = field(default_factory=dict)

    def contains_updates(self) -> bool:
        return bool(
            self.hardstates or self.entries or self.snapshots
            or self.committed or self.messages or self.read_states
            or (self.msg_block is not None and len(self.msg_block))
        )


class BatchedRawNode:
    """Thread-safe staging + single-threaded advance_round/advance.

    ``advance_round()`` runs one device round over the staged inputs and
    produces a BatchedReady; the caller persists/applies/sends, then
    calls ``advance()`` to commit the host mirrors. Only one round may
    be in flight at a time. The rows live on `device` (default: the
    GPU; a caller without CUDA passes device="cpu").
    """

    def __init__(
        self,
        cfg: BatchedConfig,
        groups: Optional[np.ndarray] = None,
        slots: Optional[np.ndarray] = None,
        restore: Optional[Dict[int, RowRestore]] = None,
        start_index: int = 0,
        mesh: Optional["object"] = None,
        device=None,
    ) -> None:
        # deliver_shape="auto" resolves here, so the hosted path and the
        # closed-loop engine run the same round for one logical config.
        self.cfg = cfg = cfg.validate().resolved()
        if mesh is not None:
            _refuse("BatchedRawNode(mesh=...)", "mesh")
        self.device = dev = resolve_device(device)
        self._cuda = dev.type == "cuda"
        # The native builds' directory (batched/compile_cache.py).
        enable_compile_cache()
        with device_work():
            self._build(cfg, dev, groups, slots, restore, start_index)

    def _build(self, cfg, dev, groups, slots, restore, start_index) -> None:
        """The rest of the constructor: the layout, the round, the
        device buffers and their host twins, the host mirrors, and the
        boot from `restore`. It runs under the process-wide device lock
        (graph.device_work): on CUDA it allocates and copies on the card,
        which another thread's capture must not meet."""
        r, e = cfg.num_replicas, cfg.max_ents_per_msg
        if groups is None:  # dense all-replica layout
            n = cfg.num_instances
            groups = np.arange(n, dtype=np.int32) // r
            slots = np.arange(n, dtype=np.int32) % r
        else:
            groups = np.asarray(groups, np.int32)
            slots = np.asarray(slots, np.int32)
        self.groups = groups
        self.slots = slots
        self.n = n = len(groups)
        iids = groups * r + slots
        self._slots_t = torch.as_tensor(slots, device=dev)
        self._step = make_step_round(cfg, iids=iids, slots=slots,
                                     with_aux=True, device=dev)

        # The device buffers: state, inbox and the six control vectors
        # (tick, campaign, proposals, isolate, transfer, read request).
        self.state = init_state(cfg, start_index, iids=iids, device=dev)
        self._inbox = empty_msgs((n, r, NUM_KINDS), e,
                                 narrow=cfg.narrow_lanes, device=dev)
        self._ctl = tuple(torch.zeros((n,), dtype=dt, device=dev) for dt in (
            torch.bool, torch.bool, I32, torch.bool, I32, torch.bool))
        # Their host staging twins (pinned on CUDA, so the copies into
        # the device buffers are asynchronous DMA), and numpy views of
        # those for the staging code. A staging buffer is refilled only
        # after the round that read it waited (_h2d_pending).
        self._stage = tuple(self._host_like(x) for x in
                            tuple(self._inbox) + self._ctl)
        self._stage_np = [x.numpy() for x in self._stage]
        self._h2d_pending: Optional[torch.cuda.Event] = None
        # The round's outputs (allocated by the first round, from its
        # results) and their host copies.
        self._out: Optional[List[torch.Tensor]] = None
        self._host_out: List[torch.Tensor] = []
        self._host_state = [self._host_like(getattr(self.state, f))
                            if self._cuda else getattr(self.state, f)
                            for f in _HOST_STATE]
        self._owned = storages(tuple(self.state) + tuple(self._inbox)
                               + self._ctl)
        # On CUDA, the round is one graph (graph.RoundGraphs).
        self._graphs = RoundGraphs(f"rawnode|{cfg}")
        self._fleet_pos = 3 + int(cfg.telemetry)

        # Host mirrors (updated in advance()).
        self.m_term = np.zeros(n, np.int64)
        self.m_vote = np.zeros(n, np.int64)
        self.m_commit = np.full(n, start_index, np.int64)
        self.m_last = np.full(n, start_index, np.int64)
        self.m_snap = np.full(n, start_index, np.int64)
        self.m_role = np.zeros(n, np.int64)
        self.m_lead = np.zeros(n, np.int64)
        # Consistent (term, role, lead) triple for observers: one tuple
        # assignment is atomic, two mirror swaps are not.
        self.m_view: Tuple[np.ndarray, np.ndarray, np.ndarray] = (
            self.m_term, self.m_role, self.m_lead)
        self.m_ring = np.zeros((n, cfg.window), np.int64)
        # Leader-lease lane mirror (state.lease_ticks).
        self.m_lease_ticks = np.zeros(n, np.int64)
        self.applied = np.full(n, start_index, np.int64)
        self.stable = np.full(n, start_index, np.int64)

        # Payload arena: per row, index -> (term, data).
        self.arena: List[Dict[int, Tuple[int, bytes]]] = [
            {} for _ in range(n)
        ]
        # Sparse entry-type registry: index -> EntryType for the rare
        # non-Normal entries (conf changes); absent == EntryNormal. The
        # device only ever sees (term, index).
        self.etypes: List[Dict[int, int]] = [{} for _ in range(n)]

        # Monotone commit watermark guarding arena immutability (see
        # step(): inbound MsgApp must not overwrite committed payloads).
        self._commit_guard = np.full(n, start_index, np.int64)

        # Staging (guarded by _lock).
        self._lock = threading.Lock()
        self._pending: Dict[Tuple[int, int, int], deque] = {}
        self._blocks: deque = deque()  # staged MsgBlock record arrays
        self._props: List[deque] = [deque() for _ in range(n)]
        self._ticks = np.zeros(n, np.int64)
        self._campaign = np.zeros(n, bool)
        self._isolate = np.zeros(n, bool)
        self._transfer = np.zeros(n, np.int32)  # target slot+1
        self._read_req = np.zeros(n, bool)
        self._poked = False  # host staged send_append flags (poke_append)
        self._poke_rows = np.zeros(n, bool)
        # Staged device-state edits from foreign threads, applied at the
        # head of the next round ON the round thread: row -> masks, and
        # row -> requested ring-floor index.
        self._pending_conf: Dict[int, Tuple] = {}
        self._pending_compact: Dict[int, int] = {}
        self._pending_fence: Dict[int, bool] = {}
        self._read_seen = np.zeros(n, np.int64)  # last surfaced seq
        self._read_seq_prev = np.zeros(n, np.int64)  # open detection

        if restore:
            self._restore(restore)
        if self._cuda:
            # The round's host copies start as the state's, so a read
            # before the first round (round_snap_term) sees the boot.
            for host, f in zip(self._host_state, _HOST_STATE):
                host.copy_(getattr(self.state, f))

        # In-flight round (between advance_round and advance).
        self._round: Optional[Tuple] = None

        # Per-round phase wall-seconds, always measured: stage (inbox
        # build), step (device round + host reads), extract (post-round
        # entry/commit extraction), collect (outbound block assembly).
        self.phase_last: Dict[str, float] = {
            "stage": 0.0, "step": 0.0, "extract": 0.0, "collect": 0.0}
        # Opt-in cumulative profile (ETCD_TPU_PROF=1): same keys plus a
        # round counter, the staging-lock acquire wait and, on CUDA, the
        # seconds between two CUDA events around the round's device work
        # (the graph replay and its copies; other processes' work that
        # the card interleaves is inside the span).
        self.prof: Optional[Dict[str, float]] = (
            {"stage": 0.0, "stage_lock": 0.0, "step": 0.0,
             "extract": 0.0, "collect": 0.0, "rounds": 0, "device": 0.0}
            if os.environ.get("ETCD_TPU_PROF") else None
        )

        # Telemetry plane (cfg.telemetry): the round's frame is read
        # with the other outputs and handed to an attached hub (any
        # object with ingest_round(counters, invariants, extra=...)).
        self.telemetry_hub = None
        self.last_frame: Optional[Tuple[np.ndarray, np.ndarray]] = None
        # Fleet plane (cfg.fleet_summary): the flat frame, read with the
        # other outputs, handed to an attached hub (ingest_round(vec)).
        self.fleet_hub = None
        self.last_fleet: Optional[np.ndarray] = None
        # Proposal-lifecycle tracer (obs.Tracer), purely host-side.
        self.tracer = None
        # Device-resident apply plane (cfg.apply_plane, applyplane.py):
        # dispatched right after committed-range extraction, where the
        # payload bytes are in hand. The round is the same with the
        # plane on or off.
        self.plane = None
        if cfg.apply_plane:
            self._build_plane(cfg, dev)

    def _build_plane(self, cfg, dev) -> None:
        """The apply plane's owned buffers and host state."""
        n, a = self.n, cfg.apply_records
        self.plane = init_plane(cfg, n, device=dev)
        # The record inputs (ops, keys, vals, ttls [n, A]; tick_add [n]),
        # the frame (PlaneFrame order: four [n, A] event lanes, five [n]
        # counts, the [n] overflow flag), and per chunk of one round a
        # host staging twin of the inputs and a host copy of the frame
        # (pinned on CUDA).
        self._plane_in = tuple(
            torch.zeros((n, a) if k < 4 else (n,), dtype=I32, device=dev)
            for k in range(5))
        self._plane_out = tuple(
            torch.zeros((n, a) if k < 4 else (n,),
                        dtype=torch.bool if k == 9 else I32, device=dev)
            for k in range(10))
        self._plane_chunks: List[Tuple[tuple, tuple]] = []
        # Watch events drained by the hosting layer (row, op, key_hash,
        # rev, wmask); bounded — a stalled drain must not grow the heap.
        self.plane_events: deque = deque(maxlen=8192)
        # Host-accumulated plane stats (round thread writes, any thread
        # reads — GIL-atomic scalar swaps).
        self.plane_stats: Dict[str, int] = {
            "dispatches": 0, "puts": 0, "dels": 0, "expired": 0,
            "watch_events": 0, "slots_hw": 0, "overflow_rows": 0,
            "active_leases": 0,
        }
        # Staged plane edits from foreign threads, applied in place at
        # the head of the next round (the staged-edit idiom of
        # _pending_conf): watch-slot arms and restored row images.
        self._pending_watch: Dict[Tuple[int, int], int] = {}
        self._pending_plane_rows: Dict[int, Tuple] = {}
        # Host mirrors of the plane clock and of the highest entry index
        # folded per row. The applied watermark makes a repeated dispatch
        # idempotent: a plane image restored AHEAD of the host snapshot
        # index must not fold again the WAL tail the host re-delivers.
        self.m_plane_tick = np.zeros(n, np.int64)
        self.m_plane_applied = np.zeros(n, np.int64)
        # Exact host lessor mirror: (row, key bytes) -> absolute
        # plane-tick expiry, replayed from the same payload stream at the
        # dispatch's tick arithmetic (the device stores hashes only).
        self.plane_lessor: Dict[Tuple[int, bytes], int] = {}

    # -- device helpers -------------------------------------------------------

    def _host_like(self, x: torch.Tensor) -> torch.Tensor:
        """A host tensor of x's shape and dtype: pinned on CUDA."""
        return torch.empty(x.shape, dtype=x.dtype, device="cpu",
                           pin_memory=self._cuda)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A small host array on the device, asynchronously on CUDA
        (through pinned memory, which PyTorch's host allocator keeps
        until the copy has run)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if not self._cuda:
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _on_device(self):
        return (torch.cuda.device(self.device) if self._cuda
                else contextlib.nullcontext())

    @property
    def captures(self) -> int:
        """CUDA graphs captured by this rawnode: on CUDA one for the
        round, and one for the apply plane's dispatch when it is on."""
        return self._graphs.captures

    @property
    def capture_stats(self) -> list:
        return self._graphs.capture_stats

    # -- boot ------------------------------------------------------------------

    def _restore(self, restore: Dict[int, RowRestore]) -> None:
        """Rebuild device state from per-row WAL replay results."""
        cfg = self.cfg
        w = cfg.window
        term = np.zeros(self.n, np.int32)
        vote = np.zeros(self.n, np.int32)
        commit = np.zeros(self.n, np.int32)
        last = np.zeros(self.n, np.int32)
        snap_i = np.zeros(self.n, np.int32)
        snap_t = np.zeros(self.n, np.int32)
        ring = np.zeros((self.n, w), np.int32)
        fenced = np.zeros(self.n, bool)
        for row, rr in restore.items():
            fenced[row] = rr.fenced
            term[row] = rr.term
            vote[row] = rr.vote
            # A snapshot at snap_index proves snap_index was committed;
            # a stale persisted hardstate must not boot the row into
            # the illegal watermark order commit < snap_index.
            commit[row] = max(rr.commit, rr.snap_index)
            snap_i[row] = rr.snap_index
            snap_t[row] = rr.snap_term
            li = rr.snap_index
            for ent in rr.entries:
                idx, t, data = ent[0], ent[1], ent[2]
                ring[row, idx % w] = t
                self.arena[row][idx] = (t, data)
                if len(ent) > 3 and ent[3]:
                    self.etypes[row][idx] = int(ent[3])
                li = idx
            last[row] = li
            self.applied[row] = rr.applied
        st = self.state
        nxt = np.repeat(last[:, None] + 1, cfg.num_replicas, axis=1)
        with self._on_device():
            # In place: the buffers keep their addresses and their
            # storage dtypes (vote is int8 under cfg.narrow_lanes).
            for buf, a in ((st.term, term), (st.vote, vote),
                           (st.commit, commit), (st.last, last),
                           (st.snap_index, snap_i), (st.snap_term, snap_t),
                           (st.log_term, ring), (st.fenced, fenced),
                           (st.next, nxt)):
                buf.copy_(self._to_device(a))
        self.m_term = term.astype(np.int64)
        self.m_vote = vote.astype(np.int64)
        self.m_commit = commit.astype(np.int64)
        self.m_last = last.astype(np.int64)
        self.m_snap = snap_i.astype(np.int64)
        self.m_ring = ring.astype(np.int64)
        self.stable = last.astype(np.int64)
        self._commit_guard = np.maximum(
            self._commit_guard, commit.astype(np.int64)
        )

    # -- staging ---------------------------------------------------------------

    def tick(self, rows: Optional[np.ndarray] = None) -> None:
        with self._lock:
            if rows is None:
                self._ticks += 1
            else:
                self._ticks[rows] += 1

    def campaign(self, rows) -> None:
        with self._lock:
            self._campaign[rows] = True

    def isolate(self, rows, on: bool = True) -> None:
        """Fault injection: cut rows off the network."""
        with self._lock:
            self._isolate[rows] = on

    def propose(self, row: int, data: bytes, etype: int = 0) -> None:
        """Queue a payload; it is appended (and assigned an index) in a
        round where this row is leader. `etype` tags non-Normal entries
        (conf changes) — the tag rides the host arena, never the
        device."""
        # The enqueue timestamp rides the queue tuple only when tracing
        # is on (sampling is decided at index-assignment time).
        t_enq = 0 if self.tracer is None else time.monotonic_ns()
        with self._lock:
            self._props[row].append((data, int(etype), t_enq))

    def set_membership(self, row: int, voters, voters_out=(),
                       learners=(), joint: bool = False) -> None:
        """Stage new membership masks for one row — the confchange
        apply point (ref: confchange/confchange.go; the host computes
        slot sets, the device sees only masks). Applied in place at the
        head of the next round, on the round thread."""
        r = self.cfg.num_replicas

        def mask(slots) -> np.ndarray:
            m = np.zeros((r,), bool)
            m[list(slots)] = True
            return m

        with self._lock:
            self._pending_conf[row] = (
                mask(voters), mask(voters_out), mask(learners),
                bool(joint),
            )

    def set_membership_many(self, rows, voter, voter_out, learner,
                            joint) -> None:
        """Bulk set_membership: stage mask planes for many rows under
        ONE lock acquisition. Same staged semantics: the device edit
        lands at the head of the next round as one vectorized
        in-place copy per field."""
        rows = np.asarray(rows, np.int64)
        voter = np.asarray(voter, bool)
        voter_out = np.asarray(voter_out, bool)
        learner = np.asarray(learner, bool)
        joint = np.asarray(joint, bool)
        with self._lock:
            for i, row in enumerate(rows.tolist()):
                self._pending_conf[row] = (
                    voter[i], voter_out[i], learner[i], bool(joint[i]),
                )

    def transfer_leader(self, row: int, target_slot: int) -> None:
        """Stage a leadership handoff request on a leader row
        (ref: raft.go:1339 MsgTransferLeader; device _control phase)."""
        with self._lock:
            self._transfer[row] = target_slot + 1

    def read_index(self, row: int) -> None:
        """Stage a ReadIndex batch request on a leader row; the
        confirmed (seq, index) surfaces in BatchedReady.read_states
        (ref: raft.go:1078 MsgReadIndex → Ready.ReadStates)."""
        with self._lock:
            self._read_req[row] = True

    def set_fence(self, row: int, on: bool) -> None:
        """Stage a durability-fence flip for one row, applied at the
        head of the next round like set_membership."""
        with self._lock:
            self._pending_fence[row] = bool(on)

    def watch_set(self, row: int, wslot: int, key_hash: int) -> None:
        """Stage an exact-key watch into plane watch slot ``wslot`` of
        ``row`` (0 disarms). STAGED like set_fence: the device edit
        lands at the head of the next round."""
        assert self.plane is not None, "apply plane is off"
        assert 0 <= wslot < self.cfg.apply_watch_slots
        with self._lock:
            self._pending_watch[(int(row), int(wslot))] = int(key_hash)

    def plane_restore_row(self, row: int, kv_key, kv_rev, kv_val,
                          kv_lease, rev: int, tick: int,
                          overflow: bool, applied: int = 0,
                          lessor=()) -> None:
        """Stage a full plane-row image (snapshot install / boot
        rebuild): fixed-width [C] i32 vectors + scalars, applied at the
        head of the next round, before its dispatch. ``applied`` is the
        highest entry index the image covers (dispatch skips at-or-
        below it); ``lessor`` is the row's (key bytes, expiry tick)
        mirror entries."""
        assert self.plane is not None, "apply plane is off"
        c = self.cfg.apply_capacity
        img = tuple(np.asarray(x, np.int32).reshape(c)
                    for x in (kv_key, kv_rev, kv_val, kv_lease))
        with self._lock:
            self._pending_plane_rows[int(row)] = img + (
                int(rev), int(tick), bool(overflow), int(applied),
                [(bytes(k), int(e)) for k, e in lessor])

    def drain_plane_events(self) -> List[Tuple[int, int, int, int, int]]:
        """Pop every pending (row, op, key_hash, rev, wmask) watch
        event (round thread appends; any thread drains — deque ops are
        GIL-atomic)."""
        if self.plane is None:
            return []
        evs = []
        try:
            while True:
                evs.append(self.plane_events.popleft())
        except IndexError:
            pass
        return evs

    def plane_capture(self, rows) -> List[Dict[str, object]]:
        """Snapshot-capture gather: one device gather per plane buffer
        for the whole batch of rows, read back under the device lock
        (so any thread may call it, beside other members' captures).
        Returns one JSON-ready dict per requested row."""
        assert self.plane is not None, "apply plane is off"
        rows = np.asarray(rows, np.int32).reshape(-1)
        with self._on_device(), device_work():
            parts = [x.cpu().numpy() for x in gather_rows(self.plane, rows)]
            applied = self.m_plane_applied[rows].tolist()
            tick = self.m_plane_tick[rows].tolist()
            less = {int(r): [] for r in rows}
            for (r2, kb), exp in list(self.plane_lessor.items()):
                if r2 in less:
                    less[r2].append((kb, exp))
        kk, kr, kv, kl, rv, _tk, ov = parts
        out = []
        for j, r in enumerate(rows.tolist()):
            out.append({
                "kv_key": kk[j].tolist(), "kv_rev": kr[j].tolist(),
                "kv_val": kv[j].tolist(), "kv_lease": kl[j].tolist(),
                "rev": int(rv[j]), "tick": int(tick[j]),
                "overflow": bool(ov[j]), "applied": int(applied[j]),
                "lessor": [[kb.hex(), int(e)] for kb, e in less[r]],
            })
        return out

    def pending_proposals(self, row: int) -> int:
        with self._lock:
            return len(self._props[row])

    def step(self, row: int, m: Message, merge_appends: bool = False) -> None:
        """Stage an inbound wire message for `row`. MsgApp entry
        payloads go to the arena; MsgSnap app-state restore must already
        have happened (hosting layer) — here we stage the device-side
        ring restore.

        With `merge_appends` (a difference from the reference, which
        always queues), a MsgApp that continues the append queued last
        for its (row, sender, lane), at the same term, joins it while the
        two hold at most ``max_ents_per_msg`` entries: a scalar-core
        leader sends one append a proposal, and a round takes one message
        a sender (_merge_append)."""
        t = int(m.type)
        lane = _LANE.get(t)
        if lane is None:
            raise ValueError(f"unroutable message type {m.type!r}")
        from_slot = m.from_ - 1
        if t == T_APP:
            with self._lock:
                ar = self.arena[row]
                et = self.etypes[row]
                for e in m.entries:
                    # Never clobber a committed entry's payload with a
                    # conflicting (necessarily stale) one — committed
                    # entries are immutable; only fill gaps there
                    # (post-snapshot resends).
                    if e.index > self._commit_guard[row] or e.index not in ar:
                        ar[e.index] = (e.term, e.data)
                        et.pop(e.index, None)
                        if int(e.type):
                            et[e.index] = int(e.type)
        if t == T_SNAP and m.index == 0:
            # Device ring-floor metadata normally rides in index/log_term
            # (the app snapshot in m.snapshot may sit at a HIGHER applied
            # index); fall back to the snapshot metadata when a caller
            # only filled the Snapshot (host-raft senders).
            m = Message(
                type=m.type, to=m.to, from_=m.from_, term=m.term,
                log_term=m.snapshot.metadata.term,
                index=m.snapshot.metadata.index,
            )
        with self._lock:
            q = self._pending.setdefault((row, from_slot, lane), deque())
            if merge_appends and t == T_APP and q:
                joined = _merge_append(q[-1], m, self.cfg.max_ents_per_msg)
                if joined is not None:
                    q[-1] = joined
                    return
            q.append(m)

    def step_block(self, blk: MsgBlock,
                   supersede_heartbeats: bool = False) -> None:
        """Stage a batch of payload-free inbound messages (the SoA wire
        fast path — see msgblock.py). One lock acquisition per batch.

        Records are validated HERE, at ingest: a malformed record would
        otherwise crash the round (IndexError in _build_inbox) or
        scatter a forged message into another group's inbox slot via
        negative flat-index wraparound. Invalid records are dropped,
        matching the object path's corrupt-frame-drop semantics.

        With `supersede_heartbeats`, a heartbeat or heartbeat response
        in `blk` drops those still queued for its (row, sender, lane)
        (msgblock.drop_superseded)."""
        blk = validate_block(blk, self.n, self.cfg.num_replicas,
                             self.cfg.max_ents_per_msg)
        if len(blk) == 0:
            return
        with self._lock:
            if supersede_heartbeats and self._blocks:
                self._blocks = deque(drop_superseded(
                    self._blocks, blk, (T_HB, T_HB_RESP)))
            self._blocks.append(blk)

    def install_snapshot_state(self, row: int, index: int,
                               applied_data_restored: bool = True) -> None:
        """Hosting layer notifies that app state for `row` was restored
        at `index` (from an inbound snapshot): advance the host applied
        watermark and drop arena entries at/below it."""
        with self._lock:
            if index > self.applied[row]:
                self.applied[row] = index
            ar = self.arena[row]
            for i in [i for i in ar if i <= index]:
                del ar[i]
                self.etypes[row].pop(i, None)

    def has_work(self) -> bool:
        with self._lock:
            if (
                self._pending or self._blocks or self._poked
                or self._pending_conf or self._pending_compact
                or self._pending_fence
                or (self.plane is not None
                    and (self._pending_watch
                         or self._pending_plane_rows))
                or self._ticks.any()
                or self._campaign.any()
                or self._transfer.any()
                or self._read_req.any()
            ):
                return True
            props = np.fromiter(
                (bool(q) for q in self._props), bool, count=self.n
            )
            return bool((props & (self.m_role == LEADER)).any())

    # -- the round on the device -----------------------------------------------

    def _device_round(self) -> None:
        """One round over the rawnode's buffers: step (with aux), pack
        the outbox into wire words, and write every result the host
        reads into its buffer. The body of the CUDA graph."""
        out = self._step(self.state, self._inbox, *self._ctl)
        st, outbox, aux = out[:3]
        words, simple, cplx = pack_outbox(outbox, self._slots_t)
        # Only the MsgApp lane carries entries (emit's lane KIND_APP),
        # so the host reads that lane's entry terms alone.
        results = [words, simple, cplx, outbox.ent_terms[:, :, KIND_APP],
                   *aux]
        if self.cfg.telemetry:
            results += [out[3].counters, out[3].invariants]
        if self.cfg.fleet_summary:
            results.append(out[self._fleet_pos])
        if self._out is None:
            self._out = [torch.empty(x.shape, dtype=x.dtype, device=x.device)
                         for x in results]
            self._owned |= storages(self._out)
            self._host_out = ([self._host_like(x) for x in self._out]
                              if self._cuda else self._out)
        write_back(list(zip(self.state, st, strict=True))
                   + list(zip(self._out, results, strict=True)),
                   self._owned)

    def _run_device(self, pend_conf, pend_fence, compact_rows,
                    poke_rows, pend_watch=None, pend_plane=None) -> None:
        """The round's device work, enqueued with no host sync: the
        staged edits in place on the state and plane buffers, the staged
        inputs into their buffers, the round (a graph replay on CUDA),
        and the outputs the host reads into host buffers."""
        st = self.state
        if pend_watch or pend_plane:
            self._plane_edits(pend_watch, pend_plane)
        if pend_conf:
            rows2 = np.fromiter(pend_conf, np.int64, len(pend_conf))
            idx = self._to_device(rows2)
            for k, name in enumerate(("voter", "voter_out", "learner")):
                getattr(st, name).index_copy_(0, idx, self._to_device(
                    np.stack([pend_conf[r2][k] for r2 in rows2])))
            st.in_joint.index_copy_(0, idx, self._to_device(np.fromiter(
                (pend_conf[r2][3] for r2 in rows2), bool, len(rows2))))
        if pend_fence:
            rows2 = np.fromiter(pend_fence, np.int64, len(pend_fence))
            vals = np.fromiter((pend_fence[int(r2)] for r2 in rows2),
                               bool, len(rows2))
            st.fenced.index_copy_(0, self._to_device(rows2),
                                  self._to_device(vals))
        if compact_rows:
            rows2, idxs, terms = (np.asarray(c, np.int64 if j == 0
                                             else np.int32)
                                  for j, c in enumerate(zip(*compact_rows)))
            ridx = self._to_device(rows2)
            st.snap_index.index_copy_(0, ridx, self._to_device(idxs))
            st.snap_term.index_copy_(0, ridx, self._to_device(terms))
        if poke_rows is not None and len(poke_rows):
            st.send_append.index_fill_(
                0, self._to_device(poke_rows.astype(np.int64)), True)
        for buf, host in zip(tuple(self._inbox) + self._ctl, self._stage):
            buf.copy_(host, non_blocking=True)
        if self._cuda:
            self._h2d_pending = torch.cuda.Event()
            self._h2d_pending.record()
            self._graphs.run("round", self._device_round)
            for host, buf in zip(self._host_out, self._out):
                host.copy_(buf, non_blocking=True)
            for host, f in zip(self._host_state, _HOST_STATE):
                host.copy_(getattr(st, f), non_blocking=True)
        else:
            self._device_round()

    def _plane_edits(self, pend_watch, pend_plane) -> None:
        """The staged plane edits, in place: watch arms, then restored
        row images with their host mirrors (clock, applied watermark,
        lessor entries). Runs under the device lock, at the head of the
        round."""
        pl = self.plane
        if pend_watch:
            keys = list(pend_watch)
            wr, wc = (self._to_device(np.asarray([k[i] for k in keys],
                                                 np.int64)) for i in (0, 1))
            pl.watch_key.index_put_((wr, wc), self._to_device(
                np.asarray([pend_watch[k] for k in keys], np.int32)))
        if pend_plane:
            rows2 = np.fromiter(pend_plane, np.int64, len(pend_plane))
            imgs = [pend_plane[int(r2)] for r2 in rows2]
            ridx = self._to_device(rows2)
            for i, f in enumerate(KV_LANES):
                getattr(pl, f).index_copy_(0, ridx, self._to_device(
                    np.stack([im[i] for im in imgs])))
            for i, buf, dt in ((4, pl.rev, np.int32), (5, pl.tick, np.int32),
                               (6, pl.overflow, bool)):
                buf.index_copy_(0, ridx, self._to_device(
                    np.fromiter((im[i] for im in imgs), dt, len(imgs))))
            for r2 in rows2.tolist():
                im = pend_plane[r2]
                self.m_plane_tick[r2] = im[5]
                self.m_plane_applied[r2] = im[7]
                # Lessor swap: drop every entry for the row, then install
                # the image's (the stale keys listed first — no
                # structural iteration over a dict readers get() from).
                stale = [k for k in self.plane_lessor if k[0] == r2]
                for k in stale:
                    del self.plane_lessor[k]
                for kb, exp in im[8]:
                    self.plane_lessor[(r2, kb)] = exp

    def _wait(self) -> None:
        """The round's one host sync: every copy and the round itself
        have run once the current stream has drained."""
        if self._cuda:
            torch.cuda.current_stream(self.device).synchronize()
            self._h2d_pending = None

    # -- the round -------------------------------------------------------------

    def advance_round(self) -> BatchedReady:
        assert self._round is None, "previous round not advanced"
        cfg = self.cfg
        w = cfg.window
        prof = self.prof
        tracer = self.tracer
        # Trace stamps use monotonic_ns (the tracer's clock domain, NOT
        # perf_counter): stage = staging begins, dispatch = device
        # round dispatched, extract = device done / host extraction.
        tr_stage = time.monotonic_ns() if tracer is not None else 0
        t0 = time.perf_counter()

        self._lock.acquire()
        if prof is not None:
            prof["stage_lock"] += time.perf_counter() - t0
        try:
            self._build_inbox()
            ticks = self._ticks > 0
            self._ticks = np.maximum(self._ticks - 1, 0)
            camp = self._campaign.copy()
            self._campaign[:] = False
            iso = self._isolate.copy()
            transfer = self._transfer.copy()
            self._transfer[:] = 0
            read_req = self._read_req.copy()
            self._read_req[:] = False
            poke_rows = (
                np.nonzero(self._poke_rows)[0] if self._poked else None
            )
            self._poke_rows[:] = False
            self._poked = False
            pend_conf = self._pending_conf
            self._pending_conf = {}
            pend_compact = self._pending_compact
            self._pending_compact = {}
            pend_fence = self._pending_fence
            self._pending_fence = {}
            pend_watch = pend_plane = None
            if self.plane is not None:
                pend_watch = self._pending_watch
                self._pending_watch = {}
                pend_plane = self._pending_plane_rows
                self._pending_plane_rows = {}
            props_n = np.fromiter(
                (min(len(q), cfg.max_props_per_round) for q in self._props),
                np.int32, count=self.n,
            )
        finally:
            self._lock.release()
        for dst, src in zip(self._stage_np[len(self._inbox):],
                            (ticks, camp, props_n, iso, transfer, read_req)):
            dst[:] = src
        t1 = time.perf_counter()
        self.phase_last["stage"] = t1 - t0
        if prof is not None:
            prof["stage"] += t1 - t0
        t0 = t1

        # Host-staged device-state edits (membership masks, ring-floor
        # compaction, bcastAppend pokes), applied in place on the round
        # thread — the only writer of self.state.
        conf_rows = (np.fromiter(pend_conf, np.int32, len(pend_conf))
                     if pend_conf else None)
        compact_rows = []
        for row2, want in pend_compact.items():
            # No round in flight here (asserted above): the commit
            # watermark and floor mirrors are current.
            idx = int(min(want, int(self.m_commit[row2])))
            if idx <= int(self.m_snap[row2]):
                continue
            compact_rows.append(
                (row2, idx, int(self.latest_ring()[row2, idx % w])))
            self.m_snap[row2] = max(self.m_snap[row2], idx)
        tr_dispatch = time.monotonic_ns() if tracer is not None else 0
        with self._on_device(), device_work():
            timed = prof is not None and self._cuda
            if timed:
                ev0, ev1 = (torch.cuda.Event(enable_timing=True)
                            for _ in range(2))
                ev0.record()
            self._run_device(pend_conf, pend_fence, compact_rows, poke_rows,
                             pend_watch, pend_plane)
            if timed:
                ev1.record()
            self._wait()
            if timed:
                prof["device"] += ev0.elapsed_time(ev1) / 1e3

        (term, vote, commit, last, role, lead, snap_i, snap_t, ring,
         rd_seq, rd_idx, rd_ready, lease_tk) = [
            x.numpy() for x in self._host_state]
        words, simple, cplx, app_ents, last_tick, mid_seq, mid_idx, \
            mid_ready = [x.numpy() for x in self._host_out[:8]]
        # The host buffers are rewritten by the next round: whatever
        # outlives this one is copied below (role, lead, the frames).
        role, lead = role.copy(), lead.copy()
        if cfg.telemetry:
            tel_counters, tel_inv = (x.numpy().copy()
                                     for x in self._host_out[8:10])
            if conf_rows is not None and len(conf_rows):
                # Host-populated column (see telemetry.TM_NAMES): the
                # membership masks of these rows flipped at the head of
                # THIS round.
                tel_counters[np.asarray(conf_rows, np.int64),
                             TM_INDEX["conf_changes_applied"]] += 1
            self.last_frame = (tel_counters, tel_inv)
            if self.telemetry_hub is not None:
                valid = (simple | cplx).reshape(
                    self.n, cfg.num_replicas, NUM_KINDS)
                self.telemetry_hub.ingest_round(
                    tel_counters, tel_inv,
                    extra={"outbox_lanes": lane_summary(valid)})
        if cfg.fleet_summary:
            fleet_vec = self._host_out[-1].numpy().copy()
            self.last_fleet = fleet_vec
            if self.fleet_hub is not None:
                self.fleet_hub.ingest_round(fleet_vec)
        tr_extract = time.monotonic_ns() if tracer is not None else 0
        t1 = time.perf_counter()
        self.phase_last["step"] = t1 - t0
        if prof is not None:
            prof["step"] += t1 - t0
        t0 = t1

        term = term.astype(np.int64)
        vote = vote.astype(np.int64)
        commit = commit.astype(np.int64)
        last = last.astype(np.int64)
        ring64 = ring.astype(np.int64)

        # Everything below reads/writes the arena, so it runs under
        # _lock: inbound transport threads (step) must neither clobber
        # payloads mid-drain nor observe half-assigned proposals.
        with self._lock:
            # Freeze arena immutability at this round's commit BEFORE
            # reading payloads out (see step()'s _commit_guard check).
            self._commit_guard = np.maximum(self._commit_guard, commit)

            # -- proposals: pop exactly as many as the device appended
            # and assign their indexes (the propose phase spans
            # (last_tick, last]).
            for row in np.nonzero(last > last_tick)[0].tolist():
                q = self._props[row]
                n_app = int(last[row] - last_tick[row])
                base = int(last_tick[row])
                t_row = int(term[row])
                g_row = int(self.groups[row])
                ar = self.arena[row]
                ets = self.etypes[row]
                for j in range(n_app):
                    data, et, t_enq = q.popleft()
                    idx = base + 1 + j
                    ar[idx] = (t_row, data)
                    ets.pop(idx, None)
                    if et:
                        ets[idx] = et
                    if (tracer is not None and t_enq
                            and tracer.sampled(g_row, idx)):
                        # The origin stamp: the index just got assigned;
                        # the stamp's time is the client enqueue instant.
                        tracer.stamp(g_row, t_row, idx, "propose", t_enq)

            # -- entry records to persist: per row the contiguous range
            # (lo-1, last] where lo is the first ring-changed index
            # this round (or stable+1) — range math fully vectorized,
            # Python only touches the actual entries (payload lookups).
            snap64 = snap_i.astype(np.int64)
            snap_rows = np.nonzero(snap64 > self.m_last)[0]
            # Device installed snapshots past our old log: ring floor
            # jumped. Record them; entries beyond follow.
            snapshots: List[Tuple[int, int, int]] = [
                (row, int(snap_i[row]), int(snap_t[row]))
                for row in snap_rows.tolist()
            ]
            restored = np.zeros(self.n, bool)
            restored[snap_rows] = True
            changed = ring64 != self.m_ring
            rows_changed = np.nonzero(
                changed.any(axis=1) | (last > self.stable) | restored
            )[0]
            entries = EntryBatch()
            if len(rows_changed):
                lastc = last[rows_changed]
                snapc = snap64[rows_changed]
                wgrid = np.arange(w, dtype=np.int64)
                # Log index currently held by ring slot p of each row.
                idxs = lastc[:, None] - ((lastc[:, None] - wgrid) % w)
                big = np.int64(1) << 62
                cand = np.where(
                    changed[rows_changed] & (idxs > snapc[:, None]),
                    idxs, big)
                lo = np.minimum(
                    self.stable[rows_changed] + 1, cand.min(axis=1))
                lo = np.maximum(lo, snapc + 1)
                cnt = np.maximum(lastc - lo + 1, 0)
                sel = cnt > 0
                if sel.any():
                    rows2 = rows_changed[sel]
                    cnt2 = cnt[sel]
                    eb_rows = np.repeat(rows2, cnt2)
                    eb_idx = ragged_ranges(lo[sel], cnt2)
                    eb_term = ring64[eb_rows, eb_idx % w]
                    datas: List[bytes] = []
                    etys: List[int] = []
                    for row, i, t in zip(eb_rows.tolist(),
                                         eb_idx.tolist(),
                                         eb_term.tolist()):
                        a = self.arena[row].get(i)
                        if a is not None and a[0] == t:
                            datas.append(a[1])
                            etys.append(self.etypes[row].get(i, 0))
                        else:
                            datas.append(b"")
                            etys.append(0)
                    entries = EntryBatch(
                        eb_rows, eb_idx, eb_term,
                        np.asarray(etys, np.int64), datas)

            # Sampled trace keys among this round's persisted entries:
            # stamp the round phases, hand the keys to the hosting layer
            # for the fsync/send stamps.
            traced_entries: List[Tuple[int, int, int]] = []
            if tracer is not None and len(entries):
                hits = np.nonzero(tracer.sampled_arr(
                    self.groups[entries.rows], entries.idx))[0]
                if len(hits):
                    traced_entries = list(zip(
                        self.groups[entries.rows[hits]].tolist(),
                        entries.term[hits].tolist(),
                        entries.idx[hits].tolist()))
                    tracer.stamp_many(traced_entries, "stage", tr_stage)
                    tracer.stamp_many(traced_entries, "dispatch",
                                      tr_dispatch)
                    tracer.stamp_many(traced_entries, "extract",
                                      tr_extract)

            # -- hardstate deltas
            hardstates = [
                (int(row), int(term[row]), int(vote[row]), int(commit[row]))
                for row in np.nonzero(
                    (term != self.m_term) | (vote != self.m_vote)
                    | (commit != self.m_commit)
                )[0]
            ]

            # -- committed ranges (applied, commit]
            committed: List[
                Tuple[int, List[Tuple[int, int, Optional[bytes]]]]
            ] = []
            traced_commit: List[Tuple[int, int, int]] = []
            com_rows = np.nonzero(commit > self.applied)[0]
            if len(com_rows):
                loc = np.maximum(self.applied[com_rows], snap64[com_rows])
                cntc = np.maximum(commit[com_rows] - loc, 0)
                selc = cntc > 0
                rows3 = com_rows[selc]
                cnt3 = cntc[selc]
                c_rows = np.repeat(rows3, cnt3)
                c_idx = ragged_ranges(loc[selc] + 1, cnt3)
                c_term = ring64[c_rows, c_idx % w]
                idx_l = c_idx.tolist()
                term_l = c_term.tolist()
                pos = 0
                for row, end in zip(rows3.tolist(),
                                    np.cumsum(cnt3).tolist()):
                    ar = self.arena[row]
                    ets = self.etypes[row]
                    items: List[Tuple[int, int, Optional[bytes], int]] = []
                    for k in range(pos, end):
                        i, t = idx_l[k], term_l[k]
                        a = ar.get(i)
                        ok = a is not None and a[0] == t
                        items.append((
                            i, t,
                            a[1] if ok and a[1] else None,
                            ets.get(i, 0) if ok else 0,
                        ))
                    pos = end
                    committed.append((row, items))
                if tracer is not None and len(c_idx):
                    hits = np.nonzero(tracer.sampled_arr(
                        self.groups[c_rows], c_idx))[0]
                    if len(hits):
                        traced_commit = list(zip(
                            self.groups[c_rows[hits]].tolist(),
                            c_term[hits].tolist(),
                            c_idx[hits].tolist()))
                        # Commit became observable at extraction time.
                        tracer.stamp_many(traced_commit, "commit",
                                          tr_extract)

            t1 = time.perf_counter()
            self.phase_last["extract"] = t1 - t0
            if prof is not None:
                prof["extract"] += t1 - t0
            t0 = t1

            # -- outbound messages (MsgApp payloads come from the arena)
            msg_block, messages = self._collect_messages(
                words, simple, cplx, app_ents
            )
            t1 = time.perf_counter()
            self.phase_last["collect"] = t1 - t0
            if prof is not None:
                prof["collect"] += t1 - t0
                prof["rounds"] += 1

        must_sync = bool(
            entries
            or any(
                term[row] != self.m_term[row] or vote[row] != self.m_vote[row]
                for row, *_ in hardstates
            )
        )

        # Batches opened this round, then newly quorum-confirmed ones
        # (each surfaces exactly once; ref: read_only.go advance →
        # Ready.ReadStates).
        read_opened: List[Tuple[int, int]] = []
        for row in np.nonzero(rd_seq > self._read_seq_prev)[0]:
            read_opened.append((int(row), int(rd_seq[row])))
            self._read_seq_prev[row] = int(rd_seq[row])
        read_states: List[Tuple[int, int, int]] = []
        # Mid-round confirmations first (a latched reopen in _control
        # may have already replaced them in the end-of-round state).
        for row in np.nonzero(mid_ready & (mid_seq > self._read_seen))[0]:
            read_states.append(
                (int(row), int(mid_seq[row]), int(mid_idx[row])))
            self._read_seen[row] = int(mid_seq[row])
        newly = np.nonzero(rd_ready & (rd_seq > self._read_seen))[0]
        for row in newly:
            read_states.append(
                (int(row), int(rd_seq[row]), int(rd_idx[row])))
            self._read_seen[row] = int(rd_seq[row])

        # Apply-plane dispatch: fold this round's committed entries
        # (payload bytes in hand from the extraction above) and staged
        # ticks into the plane. After the lock: it reads only local
        # extraction results and the plane, whose one writer is this
        # thread.
        if self.plane is not None and (committed or ticks.any()):
            self._plane_dispatch(committed, ticks)

        self._round = (term, vote, commit, last, role, lead,
                       snap_i.astype(np.int64), ring64,
                       lease_tk.astype(np.int64))
        snap_rings = {
            row: ring64[row].copy()
            for row, m in messages if int(m.type) == T_SNAP
        }
        return BatchedReady(
            hardstates=hardstates,
            entries=entries,
            snapshots=snapshots,
            committed=committed,
            messages=messages,
            must_sync=must_sync,
            msg_block=msg_block,
            read_states=read_states,
            read_opened=read_opened,
            snap_rings=snap_rings,
            traced_entries=traced_entries,
            traced_commit=traced_commit,
        )

    def advance(self) -> None:
        """Confirm the last Ready: host mirrors move to the new state
        (ref: rawnode.go:174-179 Advance)."""
        assert self._round is not None
        (term, vote, commit, last, role, lead, snap_i, ring64,
         lease_tk) = self._round
        with self._lock:
            # Under _lock: transport threads mutate self.applied via
            # install_snapshot_state, and read the mirrors.
            self.m_term, self.m_vote, self.m_commit = term, vote, commit
            self.m_last, self.m_role, self.m_lead = last, role, lead
            self.m_view = (term, role, lead)
            self.m_snap, self.m_ring = snap_i, ring64
            self.m_lease_ticks = lease_tk
            self.applied = np.maximum(self.applied, commit)
            self.stable = last.copy()
            # GC arena below the compaction floor.
            for row in range(self.n):
                fl = int(min(self.applied[row], snap_i[row]))
                ar = self.arena[row]
                if len(ar) > 2 * self.cfg.window:
                    for i in [i for i in ar if i <= fl]:
                        del ar[i]
                        self.etypes[row].pop(i, None)
            self._round = None

    # -- internals -------------------------------------------------------------

    def _plane_body(self) -> None:
        """One dispatch over the plane's buffers, its frame written into
        the frame buffers. The body of the plane's CUDA graph."""
        frame = plane_dispatch(self.plane, *self._plane_in)
        for buf, x in zip(self._plane_out, frame, strict=True):
            buf.copy_(x)

    def _plane_chunk_buffers(self, ci: int) -> Tuple[tuple, tuple]:
        """Chunk ci's host staging twins of the inputs and host copies
        of the frame, made on first use and kept."""
        while len(self._plane_chunks) <= ci:
            self._plane_chunks.append(tuple(
                tuple(self._host_like(x) for x in bufs)
                for bufs in (self._plane_in, self._plane_out)))
        return self._plane_chunks[ci]

    def _plane_dispatch(self, committed, ticks: np.ndarray) -> None:
        """Fold one round's committed KV payloads + staged ticks into
        the device apply plane (round thread only). Rows committing
        more than A = cfg.apply_records entries dispatch again with the
        next record chunk; the tick advance rides chunk 0 only. The
        payloads are parsed and hashed first, on the host; then, under
        the device lock, the mirrors move and the chunks are enqueued,
        each chunk's frame copied to the host, with one wait for all."""
        cfg = self.cfg
        a, n = cfg.apply_records, self.n
        new_tick = self.m_plane_tick + ticks.astype(np.int64)
        recs: List[Tuple[int, int, int, int, int, int]] = []
        lessor_ops: List[Tuple[Tuple[int, bytes], Optional[int]]] = []
        tops: List[Tuple[int, int]] = []
        longest = 0
        for row, items in committed:
            floor = int(self.m_plane_applied[row])
            top = floor
            pos = 0
            for i, _t, d, et in items:
                if i <= floor:
                    # Already folded (a restored plane image can lead
                    # the host apply watermark; the boot replay and
                    # post-install tail re-deliver that span).
                    continue
                top = max(top, int(i))
                if et != 0 or not d:
                    # Conf entries and unknown payloads (arena holes)
                    # skip the KV tier — exactly the host loop's rule.
                    continue
                p = parse_payload(d)
                if p is None:
                    continue
                op, k, v, ttl = p
                recs.append((row, pos, op, fnv1a32(k),
                             fnv1a32(v) if op == OP_PUT else 0,
                             ttl if op == OP_PUT else 0))
                pos += 1
                # Lessor mirror: same record, same tick arithmetic as
                # the dispatch (chunk 0 advances the clock, so every
                # chunk applies at new_tick).
                lessor_ops.append((
                    (row, k), int(new_tick[row]) + ttl
                    if op == OP_PUT and ttl > 0 else None))
            if top > floor:
                tops.append((row, top))
            longest = max(longest, pos)
        nchunks = max(1, -(-longest // a))
        rec = np.asarray(recs, np.int64).reshape(-1, 6)
        chunk_of = rec[:, 1] // a
        with self._on_device(), device_work():
            for row, top in tops:
                self.m_plane_applied[row] = top
            lessor = self.plane_lessor
            for key, exp in lessor_ops:
                if exp is None:
                    lessor.pop(key, None)
                else:
                    lessor[key] = exp
            self.m_plane_tick = new_tick
            for ci in range(nchunks):
                stage, host_frame = self._plane_chunk_buffers(ci)
                for x in stage:
                    x.zero_()
                sel = rec[chunk_of == ci]
                rows_c, cols_c = sel[:, 0], sel[:, 1] % a
                for x, col in zip(stage[:4], sel[:, 2:].T):
                    x.numpy()[rows_c, cols_c] = col
                if ci == 0:
                    stage[4].numpy()[:] = ticks
                for buf, host in zip(self._plane_in, stage):
                    buf.copy_(host, non_blocking=True)
                if self._cuda:
                    self._graphs.run("plane", self._plane_body)
                else:
                    self._plane_body()
                for host, buf in zip(host_frame, self._plane_out):
                    host.copy_(buf, non_blocking=True)
            self._wait()
        stats = self.plane_stats
        for ci in range(nchunks):
            (ev_op, ev_key, ev_rev, ev_wmask, puts, dels, expired,
             slots_used, leases, overflow) = (
                x.numpy() for x in self._plane_chunks[ci][1])
            stats["dispatches"] += 1
            stats["puts"] += int(puts.sum())
            stats["dels"] += int(dels.sum())
            stats["expired"] += int(expired.sum())
            stats["slots_hw"] = max(stats["slots_hw"], int(slots_used.max()))
            stats["overflow_rows"] = int(overflow.sum())
            stats["active_leases"] = int(leases.sum())
            hit = (ev_op != 0) & (ev_wmask != 0)
            rws, lanes = np.nonzero(hit)
            if len(rws):
                for r2, l2 in zip(rws.tolist(), lanes.tolist()):
                    self.plane_events.append((
                        int(r2), int(ev_op[r2, l2]), int(ev_key[r2, l2]),
                        int(ev_rev[r2, l2]), int(ev_wmask[r2, l2])))
                stats["watch_events"] += len(rws)

    # Residual block records are bounded: raft tolerates message loss,
    # so once the residual queue exceeds this many records per inbox
    # key on average, the OLDEST blocks are dropped.
    _RESIDUAL_RECORDS_PER_KEY = 4

    def _build_inbox(self) -> None:
        """Pop at most one pending message per (row, sender, lane) into
        the dense inbox staging buffers. Caller holds _lock.

        Object-path messages are drained BEFORE queued blocks, so a
        block record can be overtaken by a later object-path message
        for the same (row, sender, lane). That cross-channel reordering
        is intentional — it mirrors the reference's two rafthttp
        channels, which give no cross-channel ordering either (ref:
        server/etcdserver/api/rafthttp/peer.go:337-349); raft tolerates
        reordering and loss on every link."""
        e = self.cfg.max_ents_per_msg
        r = self.cfg.num_replicas
        if self._h2d_pending is not None:
            # A round that copied these buffers to the device never
            # waited (it raised): let its copies finish first.
            with device_work():
                self._h2d_pending.synchronize()
            self._h2d_pending = None
        # The staging buffers keep the inbox's storage dtypes: under
        # cfg.narrow_lanes type is int8 and n_ents int16 (the round
        # widens at deliver entry).
        for x in self._stage[:len(self._inbox)]:
            x.zero_()
        (valid, typ, term, log_term, index, commit, reject, reject_hint,
         n_ents, ctx, ent_terms) = self._stage_np[:len(self._inbox)]
        dead = []
        for key, q in self._pending.items():
            row, s, lane = key
            m: Message = q.popleft()
            if not q:
                dead.append(key)
            valid[row, s, lane] = True
            typ[row, s, lane] = int(m.type)
            term[row, s, lane] = m.term
            log_term[row, s, lane] = m.log_term
            index[row, s, lane] = m.index
            commit[row, s, lane] = m.commit
            reject[row, s, lane] = m.reject
            reject_hint[row, s, lane] = m.reject_hint
            n_ents[row, s, lane] = len(m.entries)
            if len(m.context) == 4:
                ctx[row, s, lane] = int.from_bytes(m.context, "little")
            for j, ent in enumerate(m.entries[:e]):
                ent_terms[row, s, lane, j] = ent.term
        for key in dead:
            del self._pending[key]
        if self._blocks:
            def land_entries(blk: MsgBlock, land: np.ndarray) -> None:
                # A block MsgApp's payloads enter the arena the moment
                # the record lands in the inbox — the block twin of
                # step()'s arena writes, same never-clobber-committed
                # rule. One bulk call per block: the arena slices come
                # straight off the flat entry arena.
                rec = blk.rec
                rows_l = rec["row"][land].tolist()
                base_l = rec["index"][land].tolist()
                cnt = blk.ent_counts[land]
                # Gather ONLY the landed records' arena rows before the
                # Python conversion — a residual-heavy block re-merges
                # every round and must not pay for its deferred tail.
                eidx = ragged_ranges(blk._ent_starts()[land], cnt)
                term_l = blk.ent_term[eidx].tolist()
                ety_l = blk.ent_etype[eidx].tolist()
                len_l = blk.ent_len[eidx].tolist()
                ps_l = blk._pay_starts()[eidx].tolist()
                pay = blk.payload
                k = 0
                for row, base, c in zip(rows_l, base_l, cnt.tolist()):
                    ar = self.arena[row]
                    et = self.etypes[row]
                    guard = self._commit_guard[row]
                    for j in range(c):
                        i2 = base + 1 + j
                        if i2 > guard or i2 not in ar:
                            a = ps_l[k]
                            ar[i2] = (term_l[k], pay[a:a + len_l[k]])
                            et.pop(i2, None)
                            if ety_l[k]:
                                et[i2] = ety_l[k]
                        k += 1

            residual = merge_blocks(
                list(self._blocks), r, NUM_KINDS,
                {"valid": valid, "type": typ, "term": term,
                 "log_term": log_term, "index": index, "commit": commit,
                 "reject": reject, "reject_hint": reject_hint,
                 "ctx": ctx, "n_ents": n_ents, "ent_terms": ent_terms},
                land_entries=land_entries,
            )
            cap = self._RESIDUAL_RECORDS_PER_KEY * self.n * r * NUM_KINDS
            while len(residual) > 1 and sum(map(len, residual)) > cap:
                residual.pop(0)  # drop oldest whole block (loss is safe)
            self._blocks = deque(residual)

    def _collect_messages(self, words, simple, cplx, app_ents):
        """Device-packed outbox → one SoA block for everything except
        MsgSnap (whose app-state payload the hosting layer attaches at
        send time). The record array is a view-cast of the packed word
        rows (step.pack_outbox) compressed by the block mask; MsgApp
        entry payloads ride the block's flat arena, re-attached from
        the host arena with one ragged gather for the terms and one
        payload join. `app_ents` [n, R, E] holds the entry terms of the
        outbox's MsgApp lane."""
        e = self.cfg.max_ents_per_msg
        rec = compact_records(words, simple)
        block = MsgBlock(rec)
        napp = rec["n_ents"]
        app_sel = np.nonzero(napp)[0]
        if len(app_sel):
            counts = napp[app_sel].astype(np.int64)
            # Flat outbox slot of each entry-carrying record (always in
            # lane KIND_APP, so slot // NUM_KINDS is its (row, target)
            # in app_ents) and its per-entry offsets.
            flat_pos = np.nonzero(simple)[0][app_sel]
            offs = ragged_ranges(np.zeros(len(app_sel), np.int64),
                                 counts)
            etf = app_ents.reshape(-1, e)
            terms = etf[np.repeat(flat_pos // NUM_KINDS, counts), offs]
            idx_flat = (np.repeat(rec["index"][app_sel].astype(np.int64),
                                  counts) + 1 + offs)
            rows_rep = np.repeat(rec["row"][app_sel].astype(np.int64),
                                 counts)
            datas: List[bytes] = []
            etys = np.zeros(len(idx_flat), "<u1")
            k = 0
            for row, idx, et in zip(rows_rep.tolist(),
                                    idx_flat.tolist(), terms.tolist()):
                a = self.arena[row].get(idx)
                if a is not None and a[0] == et:
                    datas.append(a[1])
                    ety = self.etypes[row].get(idx, 0)
                    if ety:
                        etys[k] = ety
                else:
                    datas.append(b"")
                k += 1
            block = MsgBlock(
                rec, ent_term=terms.astype("<u4"), ent_etype=etys,
                ent_len=np.fromiter(map(len, datas), np.uint32,
                                    len(datas)),
                payload=b"".join(datas))
        msgs: List[Tuple[int, Message]] = []
        if cplx.any():
            # MsgSnap only (rare): its fields from the packed words of
            # just these flat slots (word 1 holds the type's byte, word
            # 2 the reject byte; words 3-8 term, log_term, index,
            # commit, reject_hint, ctx).
            p = np.nonzero(cplx)[0]
            wp = words[p]
            k6 = NUM_KINDS
            r = self.cfg.num_replicas
            rows_c = (p // (r * k6)).tolist()
            tgts_c = ((p % (r * k6)) // k6).tolist()
            typs = ((wp[:, 1] >> 24) & 0xFF).tolist()
            rejs = (wp[:, 2] & 0xFF).tolist()
            terms_c, lts, idxs, cms, hints, ctxs = (
                wp[:, c].tolist() for c in range(3, 9))
            for j, row in enumerate(rows_c):
                t = int(typs[j])
                m = Message(
                    type=MessageType(t),
                    to=tgts_c[j] + 1,
                    from_=int(self.slots[row]) + 1,
                    term=terms_c[j],
                    log_term=lts[j],
                    index=idxs[j],
                    commit=cms[j],
                    reject=bool(rejs[j]),
                    reject_hint=hints[j],
                )
                cw = ctxs[j]
                if cw:
                    # The device ctx word travels as 4 context bytes
                    # (the reference's Message.Context).
                    m.context = int(cw).to_bytes(4, "little")
                if t == T_SNAP:
                    # metadata only; the hosting layer attaches app
                    # data (at its applied watermark ≥ this floor)
                    # before the wire.
                    m.snapshot = Snapshot(
                        metadata=SnapshotMetadata(
                            index=idxs[j], term=lts[j],
                        )
                    )
                msgs.append((row, m))
        return block, msgs

    # -- introspection ---------------------------------------------------------

    def peer_match(self) -> np.ndarray:
        """Leader-side [n, R] match snapshot — the promote catch-up
        gate's input (server.go:1446 isLearnerReady reads the same
        progress view). A host copy of the live device buffer: one
        fetch, at admin cadence, never on the round's path. Rows this
        process does not lead carry reset-stale values — callers gate
        on leadership first."""
        with device_work():
            return self.state.match.to("cpu", copy=True).numpy()

    def latest_ring(self) -> np.ndarray:
        """The newest known [n, W] term ring (in-flight round if any)."""
        return self._round[7] if self._round is not None else self.m_ring

    def round_snap_term(self, row: int) -> int:
        """The ring floor's term after the last round, from the round's
        host copy (never a read of the device buffer, so any thread may
        call it between rounds)."""
        return int(self._host_state[_HOST_STATE.index("snap_term")][row])

    def latest_commit(self, row: int) -> int:
        arr = self._round[2] if self._round is not None else self.m_commit
        return int(arr[row])

    def compact(self, row: int, index: int) -> None:
        """Move the device ring floor to `index` (host took an app
        snapshot there). STAGED like set_membership: the state edit
        happens at the head of the next round on the round thread. The
        floor only rises; the clamp to the committed watermark and the
        ring-term read happen at apply time, against that round's
        state."""
        with self._lock:
            self._pending_compact[row] = max(
                self._pending_compact.get(row, 0), int(index))

    def poke_append(self, row: int) -> None:
        """Stage an immediate append/probe to every replication target
        of `row` — the device twin of the leader's bcastAppend on a
        config change (ref: raft.go switchToConfig → maybeSendAppend),
        applied at the head of the next advance_round."""
        with self._lock:
            self._poke_rows[row] = True
            self._poked = True

    def leader_rows(self) -> np.ndarray:
        return np.nonzero(self.m_role == LEADER)[0]

    def is_leader(self, row: int) -> bool:
        return self.m_role[row] == LEADER

    def lead(self, row: int) -> int:
        """Leader member id (slot+1) as known by `row`, 0 if unknown."""
        return int(self.m_lead[row])
