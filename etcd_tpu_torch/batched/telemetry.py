"""Device-to-host telemetry plane for the batched multi-raft engine.

The round is a black box by construction — every observable
worth having (who voted, who probed, who stalled) lives in device
arrays the host never looks at on the hot path. This module is the
observability spine the SURVEY maps as etcd's Status/metrics plane
("device -> host gather"), in the Dapper spirit of always-on,
low-overhead tracing:

* **Kernel counters** — behind ``BatchedConfig.telemetry`` (default
  off), ``step.py`` emits one extra SoA block per round
  (``TelemetryFrame``): per-instance event counters (messages emitted
  by lane/type, append accepts/rejects, progress-state transitions,
  elections started/won, commit delta, ReadIndex confirmations,
  proposals dropped) plus an **invariant bitmap** computed on-device
  (``kernels.invariant_bits``). The frame is a pure function of round
  inputs/outputs: with telemetry off the compiled program is
  unchanged; with it on, protocol state stays bit-identical.

* **Host hub** — ``TelemetryHub`` folds round frames into monotonic
  counters on the shared ``pkg.metrics`` registry (labeled by member /
  group-shard) and keeps a bounded **flight recorder**: a ring of the
  last K rounds of per-group deltas plus inbox/outbox lane summaries,
  dumped to ``artifacts/flightrec_*.json`` on demand, on invariant
  trip, or on chaos-checker failure.

This module is import-light on purpose (numpy + pkg.metrics, no torch):
``step.py`` imports the counter indices from here; the hub side never
touches device code.

Ports ``etcd_tpu/batched/telemetry.py`` whole; the port keeps its own copy and
tests/test_torch_hubs.py pins it equal.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..pkg import metrics as pmet

# -----------------------------------------------------------------------------
# Counter layout (column order of TelemetryFrame.counters; step.py
# builds the frame in exactly this order — keep the two in sync).
# -----------------------------------------------------------------------------

TM_NAMES = (
    "sent_vote_req",       # vote / pre-vote requests emitted
    "sent_append",         # MsgApp emitted (probes included)
    "sent_snapshot",       # MsgSnap emitted
    "sent_heartbeat",      # MsgHeartbeat emitted
    "sent_timeout_now",    # MsgTimeoutNow emitted (leader transfer)
    "sent_vote_resp",      # vote / pre-vote responses emitted
    "sent_append_resp",    # MsgAppResp emitted (accepts + rejects)
    "sent_heartbeat_resp",  # MsgHeartbeatResp emitted
    "recv_messages",       # inbox slots delivered (post-isolation)
    "append_accepted",     # inbound appends acked (reject=false)
    "append_rejected",     # inbound appends rejected (hint probing)
    "probe_to_replicate",  # peer transitions PROBE -> REPLICATE
    "to_snapshot",         # peer transitions into SNAPSHOT
    "to_probe",            # peer transitions into PROBE
    "elections_started",   # campaigns entered (candidate/pre-candidate)
    "elections_won",       # transitions into LEADER
    "commit_delta",        # commit-index advance this round
    "reads_confirmed",     # ReadIndex batches quorum-confirmed
    "proposals_dropped",   # staged proposals the device did not append
    "fenced_rounds",       # rounds spent durability-fenced (PAR rejoin)
    # Membership-mask applications staged onto the device this round
    # (entry-driven conf-change applies, snapshot conf restores, manual
    # uploads). The device column is zero — entry types never reach the
    # kernel — and the rawnode adds the count at the staging seam
    # (advance_round's pending-conf application), so the flight
    # recorder still shows per-group conf flips round by round.
    "conf_changes_applied",
)
NUM_COUNTERS = len(TM_NAMES)
TM_INDEX = {n: i for i, n in enumerate(TM_NAMES)}

# Invariant bitmap layout (kernels.invariant_bits builds bits in this
# order). Every bit is impossible under the raft model: a trip means a
# kernel bug or a violated environment assumption (torn WAL tail).
INV_NAMES = (
    "next_le_match",        # progress next <= match on a tracked peer
    "commit_gt_last",       # commit beyond the last log index
    "snap_gt_commit",       # compaction floor above commit
    "leader_lead_mismatch",  # leader whose lead pointer names another
    "probe_wedge",          # paused probe with next <= match (the
    # restarted-member wedge signature)
    "snapshot_stuck",       # SNAPSHOT state with pending <= match
    "read_ready_no_batch",  # confirmed read with no batch open
    "fenced_leader",        # durability-fenced instance became leader
    "voter_out_no_joint",   # outgoing-voter mask residue while the
    # row is not in a joint config (conf-apply lane inconsistency)
    "ring_over_window",     # log-ring occupancy (last - snap_index)
    # beyond the ring width W: an append crossed the compaction floor
    # (wrap = silent log corruption; the ring_full back-pressure lane
    # exists to make this unreachable)
    "lease_on_nonleader",   # leader-lease tick residue on a
    # non-leader: a stale quorum-free read authorization:
    # every step-down path must zero the lane in the same round)
)


def decode_invariants(bits: int) -> List[str]:
    return [n for i, n in enumerate(INV_NAMES) if bits & (1 << i)]


# -----------------------------------------------------------------------------
# Registry metric families (registered lazily, shared process-wide;
# label children distinguish members/shards).
# -----------------------------------------------------------------------------


def counter_family(name: str,
                   registry: Optional[pmet.Registry] = None) -> pmet.Counter:
    reg = registry or pmet.DEFAULT
    return reg.register(pmet.Counter(
        f"etcd_tpu_batched_{name}_total",
        f"batched kernel telemetry: {name} events",
        ("member", "shard"),
    ))


def invariant_family(
        registry: Optional[pmet.Registry] = None) -> pmet.Counter:
    reg = registry or pmet.DEFAULT
    return reg.register(pmet.Counter(
        "etcd_tpu_batched_invariant_trips_total",
        "on-device invariant bitmap trips (any set bit is a bug or a "
        "violated durability assumption)",
        ("member", "invariant"),
    ))


def wal_fsync_histogram(
        registry: Optional[pmet.Registry] = None) -> pmet.Histogram:
    reg = registry or pmet.DEFAULT
    return reg.register(pmet.Histogram(
        "etcd_tpu_hosting_wal_fsync_seconds",
        "WAL append+fsync latency per persistence batch",
        ("member",),
    ))


def wal_pipeline_depth_gauge(
        registry: Optional[pmet.Registry] = None) -> pmet.Gauge:
    """Persistence batches sitting in the async WAL pipeline's open
    buffer — sampled at submit and at every worker swap.
    A depth pinned high means the disk can't keep up with the round
    cadence even amortized."""
    reg = registry or pmet.DEFAULT
    return reg.register(pmet.Gauge(
        "etcd_tpu_wal_pipeline_queue_depth",
        "persistence batches queued on the WAL-commit worker",
        ("member",),
    ))


def wal_pipeline_batches_histogram(
        registry: Optional[pmet.Registry] = None) -> pmet.Histogram:
    """Device rounds whose persistence one group-commit fsync covered —
    the amortization the pipeline exists for (1 == no better than the
    inline path)."""
    reg = registry or pmet.DEFAULT
    return reg.register(pmet.Histogram(
        "etcd_tpu_wal_pipeline_batches_per_fsync",
        "round persistence batches covered by one group-commit fsync",
        ("member",),
        buckets=(1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64),
    ))


def wal_pipeline_bytes_histogram(
        registry: Optional[pmet.Registry] = None) -> pmet.Histogram:
    reg = registry or pmet.DEFAULT
    return reg.register(pmet.Histogram(
        "etcd_tpu_wal_pipeline_bytes_per_fsync",
        "WAL bytes covered by one group-commit fsync",
        ("member",),
        buckets=(1 << 10, 4 << 10, 16 << 10, 64 << 10, 256 << 10,
                 1 << 20, 4 << 20, 16 << 20),
    ))


def wal_pipeline_release_histogram(
        registry: Optional[pmet.Registry] = None) -> pmet.Histogram:
    """Submit→release latency of a persistence batch on the pipeline:
    the time its acks/sends/applies waited on the covering group-commit
    fsync (the ack-release barrier's cost, paid OFF the round thread)."""
    reg = registry or pmet.DEFAULT
    return reg.register(pmet.Histogram(
        "etcd_tpu_wal_pipeline_ack_release_seconds",
        "WAL-pipeline batch submit-to-release (ack barrier) latency",
        ("member",),
        buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                 0.1, 0.25, 0.5, 1.0, 2.5),
    ))


def round_phase_histogram(
        registry: Optional[pmet.Registry] = None) -> pmet.Histogram:
    reg = registry or pmet.DEFAULT
    return reg.register(pmet.Histogram(
        "etcd_tpu_hosting_round_phase_seconds",
        "member pipeline phase wall time per round "
        "(phase: round/wal/apply/send)",
        ("member", "phase"),
        buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                 0.25, 0.5, 1.0),
    ))


def fenced_groups_gauge(
        registry: Optional[pmet.Registry] = None) -> pmet.Gauge:
    """Per-member count of groups currently durability-fenced (torn
    acked bytes detected at _replay; drops back to 0 as the snapshot/
    probe catch-up lifts each fence). Set by the hosting layer at boot
    and on every lift — no per-round cost."""
    reg = registry or pmet.DEFAULT
    return reg.register(pmet.Gauge(
        "etcd_tpu_batched_fenced_groups",
        "groups currently fenced out of elections after durable-loss "
        "detection (protocol-aware torn-tail recovery)",
        ("member",),
    ))


def joint_groups_gauge(
        registry: Optional[pmet.Registry] = None) -> pmet.Gauge:
    """Per-member count of groups currently inside a joint membership
    config (between the enter-joint entry's apply and the leave-joint
    commit). Set by the hosting layer's conf-apply path — a value stuck
    above zero means auto-leave never fired (the condition
    check_config_safety's 'joint always exited' clause asserts away)."""
    reg = registry or pmet.DEFAULT
    return reg.register(pmet.Gauge(
        "etcd_tpu_batched_joint_groups",
        "groups currently in a joint (two-quorum) membership config",
        ("member",),
    ))


def learner_slots_gauge(
        registry: Optional[pmet.Registry] = None) -> pmet.Gauge:
    """Per-member count of (group, slot) learner entries in the live
    config — the catch-up population the promote gate watches."""
    reg = registry or pmet.DEFAULT
    return reg.register(pmet.Gauge(
        "etcd_tpu_batched_learner_slots",
        "live (group, slot) learner entries across this member's "
        "group configs",
        ("member",),
    ))


def disk_fault_failstop_counter(
        registry: Optional[pmet.Registry] = None) -> pmet.Counter:
    """Storage fail-stop events by stage (the IO-error
    contract: the FIRST failed fsync — or any unrecoverable write —
    kills the member crash-style, releasing nothing gated on the
    failed window; never retry-fsync over possibly-dropped dirty
    pages, per Rebello et al., ATC'19)."""
    reg = registry or pmet.DEFAULT
    return reg.register(pmet.Counter(
        "etcd_tpu_disk_fault_failstop_total",
        "member fail-stops forced by storage faults, by stage "
        "(write | fsync | snap_install)",
        ("member", "stage"),
    ))


def disk_full_gauge(
        registry: Optional[pmet.Registry] = None) -> pmet.Gauge:
    """1 while the member sits in ENOSPC write-back-pressure (WAL
    appends refused at the fault seam before any byte was written):
    proposals refuse, acks/sends stall behind the unwritten batch, and
    the member resumes — zero acked writes lost — once space returns.
    The health op's ``disk_full`` field mirrors it."""
    reg = registry or pmet.DEFAULT
    return reg.register(pmet.Gauge(
        "etcd_tpu_disk_fault_disk_full",
        "member currently in ENOSPC write-back-pressure (0/1)",
        ("member",),
    ))


def disk_fault_injected_counter(
        registry: Optional[pmet.Registry] = None) -> pmet.Counter:
    """Injected disk-fault decisions at the Walog/Snapshotter file-op
    seam (batched/faults.DiskFaultPlan) — the fault plane must PROVE
    it injected, same discipline as the message-fault counters."""
    reg = registry or pmet.DEFAULT
    return reg.register(pmet.Counter(
        "etcd_tpu_disk_fault_injected_total",
        "injected disk faults at the storage seam, by op and kind "
        "(kind: fsync_error | write_error | enospc | delay)",
        ("member", "op", "kind"),
    ))


def disk_fault_salvage_counter(
        registry: Optional[pmet.Registry] = None) -> pmet.Counter:
    """At-rest WAL corruption amputations performed at boot (walog
    salvage: truncate at the first CRC-bad complete record, drop later
    segments; the damaged groups boot FENCED via the durable
    watermark)."""
    reg = registry or pmet.DEFAULT
    return reg.register(pmet.Counter(
        "etcd_tpu_disk_fault_salvage_total",
        "at-rest WAL corruption salvage amputations at member boot",
        ("member",),
    ))


def trace_span_counter(
        registry: Optional[pmet.Registry] = None) -> pmet.Counter:
    """Spans opened by the proposal-lifecycle tracer (etcd_tpu.obs) —
    the sampled 1-in-N population size, so rates can be scaled back to
    absolute proposal counts."""
    reg = registry or pmet.DEFAULT
    return reg.register(pmet.Counter(
        "etcd_tpu_trace_spans_total",
        "proposal-lifecycle trace spans opened (sampled)",
        ("member",),
    ))


def trace_drop_counter(
        registry: Optional[pmet.Registry] = None) -> pmet.Counter:
    """Tracer shedding classes (open_evict: span evicted before apply;
    ring_evict: retired span pushed out of the bounded ring). The
    tracer never sheds silently — a hot run that overflows its rings
    shows up here, not as a mystery gap in the merged timeline."""
    reg = registry or pmet.DEFAULT
    return reg.register(pmet.Counter(
        "etcd_tpu_trace_span_drops_total",
        "proposal-lifecycle trace spans dropped/evicted, by class",
        ("member", "cls"),
    ))


def router_loss_counter(
        registry: Optional[pmet.Registry] = None) -> pmet.Counter:
    """One source of truth for transport drop classes (InProcRouter,
    TCPRouter and ShmFabric all count here; their stats() ops read
    back from it)."""
    reg = registry or pmet.DEFAULT
    return reg.register(pmet.Counter(
        "etcd_tpu_router_loss_total",
        "messages lost or errored by the member fabric, by drop class",
        ("transport", "member", "cls"),
    ))


# Shared-memory ring fabric families (batched/shmfabric.py):
# per outbound lane (member -> peer, live|bulk ring). Losses count on
# router_loss_counter (transport="shm") like every fabric; these
# families carry the ring-occupancy/throughput shape the fleet
# console's transport column and capacity tuning read.


def shm_ring_depth_gauge(
        registry: Optional[pmet.Registry] = None) -> pmet.Gauge:
    reg = registry or pmet.DEFAULT
    return reg.register(pmet.Gauge(
        "etcd_tpu_shm_ring_bytes",
        "shm fabric ring occupancy (unread bytes) per outbound lane",
        ("member", "peer", "ring"),
    ))


def shm_ring_high_water_gauge(
        registry: Optional[pmet.Registry] = None) -> pmet.Gauge:
    reg = registry or pmet.DEFAULT
    return reg.register(pmet.Gauge(
        "etcd_tpu_shm_ring_high_water_bytes",
        "shm fabric ring occupancy high-water mark per outbound lane",
        ("member", "peer", "ring"),
    ))


def shm_frames_counter(
        registry: Optional[pmet.Registry] = None) -> pmet.Counter:
    reg = registry or pmet.DEFAULT
    return reg.register(pmet.Counter(
        "etcd_tpu_shm_frames_total",
        "frames written into shm fabric rings per outbound lane",
        ("member", "peer", "ring"),
    ))


def shm_copy_bytes_counter(
        registry: Optional[pmet.Registry] = None) -> pmet.Counter:
    reg = registry or pmet.DEFAULT
    return reg.register(pmet.Counter(
        "etcd_tpu_shm_copy_bytes_total",
        "frame body bytes copied into shm fabric rings per outbound "
        "lane (the transport's entire copy cost)",
        ("member", "peer", "ring"),
    ))


def shm_ring_full_counter(
        registry: Optional[pmet.Registry] = None) -> pmet.Counter:
    reg = registry or pmet.DEFAULT
    return reg.register(pmet.Counter(
        "etcd_tpu_shm_ring_full_total",
        "shm ring-full events per outbound lane (each drops one frame "
        "drop-don't-block; records counted on "
        "etcd_tpu_router_loss_total cls=ring_full_drop)",
        ("member", "peer", "ring"),
    ))


# Device apply-plane families (batched/applyplane.py): the
# hosting layer folds rawnode.plane_stats + its own lease-read
# counters into these after each health/metrics pass — fleet_console's
# plane columns and the read-mix SLO row read them back.


def apply_plane_slots_gauge(
        registry: Optional[pmet.Registry] = None) -> pmet.Gauge:
    reg = registry or pmet.DEFAULT
    return reg.register(pmet.Gauge(
        "etcd_tpu_apply_plane_slots_high_water",
        "device KV slot occupancy high-water across a member's rows "
        "(vs cfg.apply_capacity; overflow rows spill to the host tier)",
        ("member",),
    ))


def apply_plane_leases_gauge(
        registry: Optional[pmet.Registry] = None) -> pmet.Gauge:
    reg = registry or pmet.DEFAULT
    return reg.register(pmet.Gauge(
        "etcd_tpu_apply_plane_active_leases",
        "live (unexpired) key leases on the device plane, member-wide",
        ("member",),
    ))


def apply_plane_overflow_gauge(
        registry: Optional[pmet.Registry] = None) -> pmet.Gauge:
    reg = registry or pmet.DEFAULT
    return reg.register(pmet.Gauge(
        "etcd_tpu_apply_plane_overflow_rows",
        "rows whose device KV store overflowed capacity (sticky; "
        "reads for spilled keys stay host-tier correct)",
        ("member",),
    ))


def apply_plane_watch_events_counter(
        registry: Optional[pmet.Registry] = None) -> pmet.Counter:
    reg = registry or pmet.DEFAULT
    return reg.register(pmet.Counter(
        "etcd_tpu_apply_plane_watch_events_total",
        "watch events emitted by device apply-stream matching",
        ("member",),
    ))


def apply_plane_reads_counter(
        registry: Optional[pmet.Registry] = None) -> pmet.Counter:
    reg = registry or pmet.DEFAULT
    return reg.register(pmet.Counter(
        "etcd_tpu_apply_plane_reads_total",
        "linearizable reads by serving path: kind=lease_hit (zero "
        "quorum rounds) vs kind=readindex_fallback",
        ("member", "kind"),
    ))


# -----------------------------------------------------------------------------
# The hub
# -----------------------------------------------------------------------------


class TelemetryHub:
    """Folds per-round telemetry frames into the metrics registry and
    keeps a bounded flight recorder.

    ``n_rows``: instance rows of the attached engine/rawnode (groups
    for a hosting member). Counters are exposed summed per group-shard
    (``shards`` label children per member — per-group label children
    would explode at G=65536). The flight recorder keeps per-row
    detail: full per-row deltas when ``n_rows`` is small, else totals
    plus the rows whose invariants tripped.
    """

    # Keep full per-row counter deltas in the ring below this many rows.
    FULL_DETAIL_ROWS = 256

    def __init__(self, n_rows: int, member: str = "0",
                 registry: Optional[pmet.Registry] = None,
                 ring: int = 64, shards: int = 8,
                 dump_dir: Optional[str] = None,
                 dump_on_trip: bool = True) -> None:
        self.n_rows = int(n_rows)
        self.member = str(member)
        self.registry = registry or pmet.DEFAULT
        self.shards = max(1, min(int(shards), self.n_rows))
        self._shard_of = (
            np.arange(self.n_rows) * self.shards // max(self.n_rows, 1)
        )
        self.dump_dir = dump_dir or os.environ.get(
            "ETCD_TPU_FLIGHTREC_DIR", "artifacts")
        self.dump_on_trip = dump_on_trip
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=int(ring))
        self._round = 0
        self._trips = 0
        self._dumped_on_trip = False
        self._last_totals: Optional[np.ndarray] = None
        self._last_inv: Optional[np.ndarray] = None
        self._counters = [
            [counter_family(n, self.registry).labels(self.member, str(s))
             for s in range(self.shards)]
            for n in TM_NAMES
        ]
        self._inv_counter = invariant_family(self.registry)
        self.last_dump: Optional[str] = None

    # -- ingest ---------------------------------------------------------------

    def ingest_round(self, counters: np.ndarray, invariants: np.ndarray,
                     extra: Optional[Dict] = None) -> None:
        """Fold one round's frame: ``counters`` [n_rows, NUM_COUNTERS]
        per-round deltas, ``invariants`` [n_rows] bitmaps."""
        counters = np.asarray(counters)
        invariants = np.asarray(invariants)
        # Registry fold: per counter, per shard.
        for ci in range(NUM_COUNTERS):
            col = counters[:, ci]
            if not col.any():
                continue
            if self.shards == 1:
                self._counters[ci][0].inc(float(col.sum()))
            else:
                sums = np.bincount(self._shard_of, weights=col,
                                   minlength=self.shards)
                for s in np.nonzero(sums)[0]:
                    self._counters[ci][int(s)].inc(float(sums[s]))
        tripped = np.nonzero(invariants)[0]
        for row in tripped:
            for name in decode_invariants(int(invariants[row])):
                self._inv_counter.labels(self.member, name).inc()
        with self._lock:
            self._round += 1
            self._ring.append(self._record(counters, invariants,
                                           tripped, extra))
            self._trips += len(tripped)
            want_dump = (
                len(tripped) > 0 and self.dump_on_trip
                and not self._dumped_on_trip
            )
            if want_dump:
                self._dumped_on_trip = True
        if want_dump:
            try:
                self.dump(reason="invariant-trip")
            except OSError:
                # The dump is evidence, not control flow: an unwritable
                # dump dir must not take down the member round thread
                # that ingested the frame.
                pass

    def ingest_totals(self, counters: np.ndarray, invariants: np.ndarray,
                      extra: Optional[Dict] = None) -> None:
        """Fold MONOTONE totals (the engine's in-device accumulator):
        the delta against the previously ingested totals is fed through
        ``ingest_round``. The invariant bitmap is OR-folded on device,
        so only bits NEWLY set since the last drain count — draining
        every chunk must not re-count one trip per drain. Used by
        closed-loop callers that only sync at chunk boundaries."""
        counters = np.asarray(counters, np.int64)
        invariants = np.asarray(invariants, np.int64)
        with self._lock:
            prev = self._last_totals
            prev_inv = self._last_inv
            self._last_totals = counters.copy()
            self._last_inv = invariants.copy()
        delta = counters if prev is None else counters - prev
        new_inv = (invariants if prev_inv is None
                   else invariants & ~prev_inv)
        self.ingest_round(np.maximum(delta, 0), new_inv, extra)

    def _record(self, counters: np.ndarray, invariants: np.ndarray,
                tripped: np.ndarray, extra: Optional[Dict]) -> Dict:
        rec: Dict = {
            "round": self._round,
            "t": time.time(),
            "totals": {
                n: int(counters[:, i].sum())
                for i, n in enumerate(TM_NAMES) if counters[:, i].any()
            },
        }
        if self.n_rows <= self.FULL_DETAIL_ROWS:
            nz_rows = np.nonzero(counters.any(axis=1))[0]
            rec["rows"] = {
                int(r): {
                    n: int(counters[r, i])
                    for i, n in enumerate(TM_NAMES) if counters[r, i]
                }
                for r in nz_rows
            }
        if len(tripped):
            rec["invariants"] = {
                int(r): decode_invariants(int(invariants[r]))
                for r in tripped
            }
        if extra:
            rec["extra"] = extra
        return rec

    # -- flight recorder ------------------------------------------------------

    def records(self) -> List[Dict]:
        with self._lock:
            return list(self._ring)

    def trips(self) -> int:
        with self._lock:
            return self._trips

    def dump(self, path: Optional[str] = None,
             reason: str = "manual") -> str:
        """Write the flight-recorder ring (+ a registry snapshot of this
        member's counters) as JSON; returns the path."""
        with self._lock:
            recs = list(self._ring)
            rnd = self._round
            trips = self._trips
        if path is None:
            # Shared collision-free artifact naming (obs.artifacts):
            # simultaneous multi-member dumps on a checker failure must
            # never overwrite each other. Lazy import: obs must stay
            # out of this module's import graph (tracer imports the
            # registry families from here).
            from ..obs.artifacts import KIND_FLIGHTREC, dump_path

            path = dump_path(KIND_FLIGHTREC, self.member, reason,
                             self.dump_dir)
        payload = {
            "member": self.member,
            "reason": reason,
            "captured_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "rounds_ingested": rnd,
            "invariant_trips": trips,
            "counter_names": list(TM_NAMES),
            "invariant_names": list(INV_NAMES),
            "ring": recs,
        }
        with open(path, "w") as f:
            json.dump(payload, f, indent=1)
            f.write("\n")
        with self._lock:
            self.last_dump = path
        return path


def lane_summary(valid: np.ndarray) -> List[int]:
    """Per-lane message counts from a [n, R, K] validity mask — the
    decoded inbox/outbox summary the flight recorder rides."""
    return np.asarray(valid).sum(axis=(0, 1)).astype(int).tolist()
