"""Fleet observatory: device-side group-state distributions, host side.

Per-group Prometheus labels are a non-starter at G=65536 — the fix is
the Monarch/Dapper move of aggregating AT THE SOURCE: when
``BatchedConfig.fleet_summary`` is on, the round also emits one
fixed-shape **SummaryFrame** — a flat int32 vector whose layout this
module defines (:class:`FleetLayout`) and ``batched/step.py`` builds on
device:

* log-bucketed histograms of per-row commit advance, commit backlog
  (``last - commit``) and leader-side inflight depth;
* per-replica-slot leader counts, role census, progress-state census,
  fenced-row count, term spread;
* a bounded **groups×time heat strip**: per-group-bin commit-delta and
  backlog sums (``min(G, FLEET_HEAT_BINS)`` bins, so the frame size
  never scales with G);
* a top-k of the worst-backlogged rows with their (group id,
  lag, commit, applied, term, role, lead) — laggards are
  *identifiable*, not just counted.

Fleet visibility therefore costs one small SoA frame per round with
zero per-round host sync (the engine accumulates frames in the scan
carry exactly like the telemetry plane; the hosted rawnode fetches the
vector with the round's other state reads).

Host side, :class:`FleetHub` folds frames into ``etcd_tpu_fleet_*``
registry families, keeps a bounded heatmap ring dumped as a
``fleetheat_*`` artifact (absorbing the per-run CSV role of
``tools/rw_heatmaps.py`` for cluster-side heat), and raises **counted
anomaly flags**:

* ``commit_frozen`` — a top-K row whose commit has not moved for
  ``freeze_frames`` consecutive frames while it still has backlog and
  knows a leader (its own row IS the leader, or ``lead`` names one);
* ``leader_skew`` — a replica slot leading more than ``skew_ratio``
  times its fair share ``G/R`` (the trigger signal the ROADMAP item 5
  rebalancer consumes).

Import-light on purpose (numpy + pkg.metrics + obs.artifacts, no torch):
``step.py`` imports only the layout constants; the hub side never
touches device code.

Ports ``etcd_tpu/obs/fleet.py`` whole; the port keeps its own copy and
tests/test_torch_hubs.py pins it equal.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from ..pkg import metrics as pmet
from .artifacts import KIND_FLEETHEAT, dump_path

# -----------------------------------------------------------------------------
# Frame layout (the device side in step.py builds the vector in exactly
# this field order — keep the two in sync via FleetLayout.fields).
# -----------------------------------------------------------------------------

# Log2 buckets: bucket 0 holds v == 0; bucket b (1..B-2) holds
# v in [2^(b-1), 2^b); the last bucket is open-ended (v >= 2^(B-2)).
FLEET_BUCKETS = 16
# Worst-backlog rows surfaced with full identity per frame.
FLEET_TOP_K = 8
# Heat-strip cap: per-group columns below this many groups, fixed-size
# group-range bins above it (the frame must not scale with G).
FLEET_HEAT_BINS = 128

# Role / progress-state names (state.py encodings; kept here so this
# module stays import-free of the batched package).
ROLE_NAMES = ("follower", "candidate", "leader", "precandidate")
PR_STATE_NAMES = ("probe", "replicate", "snapshot")

ACC_SUM = "sum"    # per-round deltas: accumulate by addition
ACC_LAST = "last"  # state snapshots: latest frame wins


def bucket_lower(i: int) -> int:
    """Lower bound of log bucket i (0, 1, 2, 4, ... 2^(B-2))."""
    return 0 if i == 0 else 1 << (i - 1)


def bucket_label(i: int) -> str:
    if i == 0:
        return "0"
    lo, hi = 1 << (i - 1), (1 << i) - 1
    if i == FLEET_BUCKETS - 1:
        return f">={lo}"
    return str(lo) if lo == hi else f"{lo}-{hi}"


BUCKET_BOUNDS = tuple(bucket_lower(i) for i in range(FLEET_BUCKETS))
BUCKET_LABELS = tuple(bucket_label(i) for i in range(FLEET_BUCKETS))


class FleetLayout:
    """Field offsets of the flat [L] int32 SummaryFrame for a given
    (rows, replicas, groups) shape. Rows are replica instances: the
    hosted rawnode owns one slot of every group (n_rows == G); the
    dense closed-loop engine owns all of them (n_rows == G*R)."""

    def __init__(self, n_rows: int, num_replicas: int,
                 num_groups: int) -> None:
        self.n_rows = int(n_rows)
        self.num_replicas = int(num_replicas)
        self.num_groups = int(num_groups)
        self.heat_bins = min(self.num_groups, FLEET_HEAT_BINS)
        self.top_k = max(1, min(FLEET_TOP_K, self.n_rows))
        b, r, hb, k = (FLEET_BUCKETS, self.num_replicas,
                       self.heat_bins, self.top_k)
        # (name, length, accumulate) in frame order.
        self.fields = (
            ("hist_commit_delta", b, ACC_SUM),
            ("hist_backlog", b, ACC_LAST),
            ("hist_inflight", b, ACC_LAST),
            ("hist_ring_occupancy", b, ACC_LAST),
            ("ring_occ_max", 1, ACC_LAST),
            ("leader_slot", r, ACC_LAST),
            ("role_census", len(ROLE_NAMES), ACC_LAST),
            ("pr_census", len(PR_STATE_NAMES), ACC_LAST),
            ("fenced", 1, ACC_LAST),
            ("term_min", 1, ACC_LAST),
            ("term_max", 1, ACC_LAST),
            ("term_sum", 1, ACC_LAST),
            ("heat_commit", hb, ACC_SUM),
            ("heat_backlog", hb, ACC_LAST),
            ("top_group", k, ACC_LAST),
            ("top_lag", k, ACC_LAST),
            ("top_commit", k, ACC_LAST),
            ("top_applied", k, ACC_LAST),
            ("top_term", k, ACC_LAST),
            ("top_role", k, ACC_LAST),
            ("top_lead", k, ACC_LAST),
        )
        self.offsets: Dict[str, tuple] = {}
        off = 0
        for name, length, _acc in self.fields:
            self.offsets[name] = (off, off + length)
            off += length
        self.size = off
        self._sum_mask = np.zeros(self.size, bool)
        for name, _length, acc in self.fields:
            if acc == ACC_SUM:
                s, e = self.offsets[name]
                self._sum_mask[s:e] = True

    def bin_starts(self) -> List[int]:
        """First group id of each heat column, EXACTLY mirroring the
        device mapping ``bin = g * heat_bins // num_groups`` (step.py):
        column i covers groups [starts[i], starts[i+1]) with a final
        sentinel of num_groups. When G % heat_bins != 0 the bins are
        NOT uniform — a ceil(G/bins) stride label would attribute a
        group's heat to the wrong column."""
        g, hb = self.num_groups, self.heat_bins
        # min g with g*hb//G == i  <=>  g >= ceil(i*G/hb).
        return [-(-i * g // hb) for i in range(hb)] + [g]

    def sum_mask(self) -> np.ndarray:
        """[L] bool: True where the accumulator ADDS frames (per-round
        deltas), False where the latest frame replaces (snapshots).
        Cached — callers (ingest_totals runs per drain) must not
        mutate it."""
        return self._sum_mask

    def slice(self, vec: np.ndarray, name: str) -> np.ndarray:
        s, e = self.offsets[name]
        return np.asarray(vec)[..., s:e]

    def decode(self, vec: np.ndarray) -> Dict[str, np.ndarray]:
        vec = np.asarray(vec)
        assert vec.shape[-1] == self.size, (
            f"frame length {vec.shape[-1]} != layout {self.size} "
            f"(rows={self.n_rows} R={self.num_replicas} "
            f"G={self.num_groups})")
        return {name: self.slice(vec, name) for name, _l, _a in
                self.fields}


# -----------------------------------------------------------------------------
# Registry families (etcd_tpu_fleet_*; registered lazily, shared
# process-wide like the telemetry families).
# -----------------------------------------------------------------------------

# Histogram le-boundaries == the device buckets' lower bounds, so
# folding a device bucket count as `count` observations of its lower
# bound lands every observation in exactly its own le bucket.
_HIST_BUCKETS = tuple(float(b) for b in BUCKET_BOUNDS)


def fleet_hist_family(name: str, help_: str,
                      registry: Optional[pmet.Registry] = None
                      ) -> pmet.Histogram:
    reg = registry or pmet.DEFAULT
    return reg.register(pmet.Histogram(
        f"etcd_tpu_fleet_{name}", help_, ("member",),
        buckets=_HIST_BUCKETS))


def fleet_gauge(name: str, help_: str, labels=("member",),
                registry: Optional[pmet.Registry] = None) -> pmet.Gauge:
    reg = registry or pmet.DEFAULT
    return reg.register(pmet.Gauge(
        f"etcd_tpu_fleet_{name}", help_, labels))


def fleet_anomaly_counter(
        registry: Optional[pmet.Registry] = None) -> pmet.Counter:
    reg = registry or pmet.DEFAULT
    return reg.register(pmet.Counter(
        "etcd_tpu_fleet_anomalies_total",
        "fleet anomaly flags raised from device summary frames and "
        "host persistence signals (kind: commit_frozen | leader_skew "
        "| member_limping | wal_pinned)",
        ("member", "kind")))


def fleet_frames_counter(
        registry: Optional[pmet.Registry] = None) -> pmet.Counter:
    reg = registry or pmet.DEFAULT
    return reg.register(pmet.Counter(
        "etcd_tpu_fleet_frames_total",
        "device fleet summary frames folded into the hub",
        ("member",)))


def register_families(registry: Optional[pmet.Registry] = None) -> None:
    """Force-register every etcd_tpu_fleet_* family (they are lazy
    otherwise) — dump_metrics' local mode uses this so the names show
    up before any member ever ingests a frame."""
    for name, help_ in (
        ("commit_delta", "per-row commit-index advance per round "
                         "(device log buckets)"),
        ("commit_backlog", "per-row last-commit backlog "
                           "(device log buckets)"),
        ("inflight_depth", "leader-side tracked-peer inflight depth "
                           "(device log buckets)"),
        ("ring_occupancy", "per-row log-ring occupancy last minus "
                           "compaction floor (device log buckets)"),
    ):
        fleet_hist_family(name, help_, registry)
    fleet_gauge("leader_groups",
                "groups led, by replica slot (device census)",
                ("member", "slot"), registry)
    fleet_gauge("role_rows", "replica rows by role (device census)",
                ("member", "role"), registry)
    fleet_gauge("pr_state_peers",
                "leader-side tracked peers by progress state",
                ("member", "state"), registry)
    fleet_gauge("fenced_rows",
                "durability-fenced rows (device census)",
                ("member",), registry)
    fleet_gauge("term_max", "highest term across rows", ("member",),
                registry)
    fleet_gauge("term_spread", "max-min term spread across rows",
                ("member",), registry)
    fleet_gauge("lag_max", "worst last-commit backlog across rows",
                ("member",), registry)
    fleet_gauge("ring_occ_max",
                "worst log-ring occupancy across rows (vs window W; "
                "the ring_full back-pressure high-water)",
                ("member",), registry)
    fleet_gauge("leader_skew_ratio",
                "max leaders-per-slot over the fair share G/R (x1000)",
                ("member",), registry)
    fleet_gauge("fsync_ewma_ms",
                "EWMA of this member's WAL fsync latency in ms x1000 "
                "(the member_limping gray-failure signal)",
                ("member",), registry)
    fleet_anomaly_counter(registry)
    fleet_frames_counter(registry)


# -----------------------------------------------------------------------------
# The hub
# -----------------------------------------------------------------------------


class FleetHub:
    """Folds device SummaryFrames into the registry, keeps the bounded
    groups×time heatmap ring, and raises counted anomaly flags."""

    def __init__(self, n_rows: int, num_replicas: int, num_groups: int,
                 member: str = "0",
                 registry: Optional[pmet.Registry] = None,
                 ring: int = 128,
                 dump_dir: Optional[str] = None,
                 freeze_frames: int = 8,
                 skew_ratio: float = 2.0,
                 skew_min_groups: int = 16,
                 limp_ms: float = 25.0,
                 limp_ops: int = 8) -> None:
        self.layout = FleetLayout(n_rows, num_replicas, num_groups)
        self.member = str(member)
        self.registry = registry or pmet.DEFAULT
        self.dump_dir = dump_dir
        self.freeze_frames = int(freeze_frames)
        self.skew_ratio = float(skew_ratio)
        self.skew_min_groups = int(skew_min_groups)
        # Gray-failure (limp) detection thresholds — mutable attrs so
        # harnesses can tune per-episode without a rebuild.
        self.limp_ms = float(limp_ms)
        self.limp_ops = int(limp_ops)
        self._fsync_ewma_ms: Optional[float] = None
        self._limp_streak = 0
        self._limping = False
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=int(ring))
        self._frames = 0
        self._last_totals: Optional[np.ndarray] = None
        # commit_frozen tracking: group -> [commit, consecutive frames]
        # (bounded by top_k — only rows the device surfaced can track).
        self._frozen: Dict[int, List[int]] = {}
        self._skewed = False
        self._anomaly_counts: Dict[str, int] = {}
        self._anomaly_log: deque = deque(maxlen=64)
        self.last_dump: Optional[str] = None
        self._latest: Optional[Dict[str, np.ndarray]] = None

        m = self.member
        register_families(self.registry)
        reg = self.registry
        self._h_delta = fleet_hist_family("commit_delta", "",
                                          reg).labels(m)
        self._h_backlog = fleet_hist_family("commit_backlog", "",
                                            reg).labels(m)
        self._h_inflight = fleet_hist_family("inflight_depth", "",
                                             reg).labels(m)
        self._h_ring_occ = fleet_hist_family("ring_occupancy", "",
                                             reg).labels(m)
        self._g_leader = [
            fleet_gauge("leader_groups", "", ("member", "slot"),
                        reg).labels(m, str(s))
            for s in range(self.layout.num_replicas)]
        self._g_role = {
            rn: fleet_gauge("role_rows", "", ("member", "role"),
                            reg).labels(m, rn)
            for rn in ROLE_NAMES}
        self._g_pr = {
            sn: fleet_gauge("pr_state_peers", "", ("member", "state"),
                            reg).labels(m, sn)
            for sn in PR_STATE_NAMES}
        self._g_fenced = fleet_gauge("fenced_rows", "", ("member",),
                                     reg).labels(m)
        self._g_term_max = fleet_gauge("term_max", "", ("member",),
                                       reg).labels(m)
        self._g_term_spread = fleet_gauge("term_spread", "",
                                          ("member",), reg).labels(m)
        self._g_lag_max = fleet_gauge("lag_max", "", ("member",),
                                      reg).labels(m)
        self._g_ring_occ_max = fleet_gauge("ring_occ_max", "",
                                           ("member",), reg).labels(m)
        self._g_skew = fleet_gauge("leader_skew_ratio", "",
                                   ("member",), reg).labels(m)
        self._g_fsync_ewma = fleet_gauge("fsync_ewma_ms", "",
                                         ("member",), reg).labels(m)
        self._c_anom = fleet_anomaly_counter(reg)
        self._c_frames = fleet_frames_counter(reg).labels(m)

    # -- gray-failure (limp) signal -------------------------------------------

    def observe_fsync(self, seconds: float) -> None:
        """Host persistence signal: one WAL fsync's wall time (the
        hosting layer calls this after every sync, inline or
        group-commit). A member whose fsyncs stay above ``limp_ms`` for
        ``limp_ops`` consecutive syncs is LIMPING — alive, acking,
        and slow: the gray-failure shape Huang et al. (HotOS'17) show
        health checks miss. Raises the counted ``member_limping``
        anomaly once per degradation episode (edge-triggered, re-arms
        after the member runs fast again), which the rebalancer
        (batched/rebalance.py) consumes to drain leadership off this
        member — as a follower it no longer holds any commit's
        critical path, the quorum forms from the healthy members."""
        ms = seconds * 1e3
        fire = False
        with self._lock:
            prev = self._fsync_ewma_ms
            self._fsync_ewma_ms = (
                ms if prev is None else 0.2 * ms + 0.8 * prev)
            ewma = self._fsync_ewma_ms
            if ms > self.limp_ms:
                self._limp_streak += 1
                if (self._limp_streak >= self.limp_ops
                        and not self._limping):
                    self._limping = True
                    fire = True
            else:
                self._limp_streak = 0
                self._limping = False  # re-arms on heal
            streak = self._limp_streak
        self._g_fsync_ewma.set(round(ewma * 1000))
        if fire:
            self._raise_anomaly("member_limping", {
                "fsync_ms": round(ms, 2),
                "ewma_ms": round(ewma, 2),
                "streak": streak,
                "threshold_ms": self.limp_ms,
            })

    def limp_state(self) -> Dict:
        with self._lock:
            return {
                "limping": self._limping,
                "fsync_ewma_ms": (round(self._fsync_ewma_ms, 3)
                                  if self._fsync_ewma_ms is not None
                                  else None),
                "slow_streak": self._limp_streak,
                "threshold_ms": self.limp_ms,
            }

    # -- ingest ---------------------------------------------------------------

    def ingest_round(self, vec: np.ndarray,
                     extra: Optional[Dict] = None) -> None:
        """Fold one per-round frame (delta fields are this round's)."""
        f = self.layout.decode(np.asarray(vec, np.int64))
        self._fold_hist(self._h_delta, f["hist_commit_delta"])
        self._fold_hist(self._h_backlog, f["hist_backlog"])
        self._fold_hist(self._h_inflight, f["hist_inflight"])
        self._fold_hist(self._h_ring_occ, f["hist_ring_occupancy"])
        self._g_ring_occ_max.set(int(f["ring_occ_max"][0]))
        for s, g in enumerate(self._g_leader):
            g.set(int(f["leader_slot"][s]))
        for i, rn in enumerate(ROLE_NAMES):
            self._g_role[rn].set(int(f["role_census"][i]))
        for i, sn in enumerate(PR_STATE_NAMES):
            self._g_pr[sn].set(int(f["pr_census"][i]))
        self._g_fenced.set(int(f["fenced"][0]))
        tmin, tmax = int(f["term_min"][0]), int(f["term_max"][0])
        self._g_term_max.set(tmax)
        self._g_term_spread.set(max(tmax - tmin, 0))
        self._g_lag_max.set(int(f["top_lag"][0]))
        self._c_frames.inc()
        top = self._top_entries(f)
        with self._lock:
            self._frames += 1
            self._latest = f
            self._ring.append({
                "frame": self._frames,
                "t": time.time(),
                "heat_commit": f["heat_commit"].astype(int).tolist(),
                "heat_backlog": f["heat_backlog"].astype(int).tolist(),
                "leader_slot": f["leader_slot"].astype(int).tolist(),
                "fenced": int(f["fenced"][0]),
                "top": top,
                **({"extra": extra} if extra else {}),
            })
        self._check_anomalies(f, top)

    def ingest_totals(self, vec: np.ndarray,
                      extra: Optional[Dict] = None) -> None:
        """Fold MONOTONE totals (the engine's in-device accumulator):
        ACC_SUM fields are cumulative sums — the delta against the
        previous drain folds as one round's worth; ACC_LAST fields
        already hold the latest snapshot."""
        vec = np.asarray(vec, np.int64)
        with self._lock:
            prev = self._last_totals
            self._last_totals = vec.copy()
        if prev is not None:
            mask = self.layout.sum_mask()
            vec = np.where(mask, np.maximum(vec - prev, 0), vec)
        self.ingest_round(vec, extra)

    def _fold_hist(self, child, counts: np.ndarray) -> None:
        """Fold device bucket counts into a registry histogram: each
        bucket's count lands as that many observations of its lower
        bound (_HIST_BUCKETS le-boundaries ARE the lower bounds, so
        every observation falls in exactly its own bucket). Snapshot
        histograms (backlog, inflight) re-measure current state each
        frame, so their _count reads rows×frames — quantile shape and
        rates stay meaningful; absolute counts are per-frame censuses.
        """
        for i, c in enumerate(counts.astype(int).tolist()):
            if c:
                child.observe_many(float(BUCKET_BOUNDS[i]), c)

    def _top_entries(self, f: Dict[str, np.ndarray]) -> List[Dict]:
        out = []
        for j in range(self.layout.top_k):
            lag = int(f["top_lag"][j])
            if lag <= 0:
                continue  # top_k pads with non-laggards; drop them
            out.append({
                "group": int(f["top_group"][j]),
                "lag": lag,
                "commit": int(f["top_commit"][j]),
                "applied": int(f["top_applied"][j]),
                "term": int(f["top_term"][j]),
                "role": ROLE_NAMES[int(f["top_role"][j]) % 4],
                "lead": int(f["top_lead"][j]),
            })
        return out

    # -- anomaly flags --------------------------------------------------------

    def raise_anomaly(self, kind: str, detail: Dict) -> None:
        """Host-raised counted anomaly (the hosting layer's lifecycle
        plane fires ``wal_pinned`` through this): same counter + log
        as the frame-derived flags, so consoles see one stream."""
        self._raise_anomaly(kind, detail)

    def _raise_anomaly(self, kind: str, detail: Dict) -> None:
        self._c_anom.labels(self.member, kind).inc()
        with self._lock:
            self._anomaly_counts[kind] = (
                self._anomaly_counts.get(kind, 0) + 1)
            self._anomaly_log.append(
                {"kind": kind, "t": time.time(), **detail})

    def _check_anomalies(self, f: Dict[str, np.ndarray],
                         top: List[Dict]) -> None:
        # commit_frozen: a surfaced laggard whose commit has not moved
        # for freeze_frames consecutive frames while backlog remains
        # and a leader exists (lead != 0 covers "I know a leader";
        # role == leader covers "I AM the leader").
        nxt: Dict[int, List[int]] = {}
        for e in top:
            if e["lead"] == 0 and e["role"] != "leader":
                continue  # leaderless: lag is expected, not anomalous
            g = e["group"]
            prev = self._frozen.get(g)
            if prev is not None and prev[0] == e["commit"]:
                cnt = prev[1] + 1
            else:
                cnt = 1
            nxt[g] = [e["commit"], cnt]
            if cnt == self.freeze_frames:
                self._raise_anomaly("commit_frozen", {
                    "group": g, "commit": e["commit"],
                    "lag": e["lag"], "frames": cnt})
        self._frozen = nxt

        # leader_skew: a slot leading beyond skew_ratio x fair share.
        lay = self.layout
        if lay.num_groups >= self.skew_min_groups:
            fair = lay.num_groups / lay.num_replicas
            mx = int(f["leader_slot"].max())
            ratio = mx / fair if fair else 0.0
            self._g_skew.set(round(ratio * 1000))
            if ratio > self.skew_ratio:
                if not self._skewed:
                    self._raise_anomaly("leader_skew", {
                        "slot": int(f["leader_slot"].argmax()),
                        "leading": mx,
                        "fair_share": round(fair, 1),
                        "ratio": round(ratio, 3)})
                self._skewed = True
            else:
                self._skewed = False  # edge-triggered: re-arms on heal

    # -- read side ------------------------------------------------------------

    def frames(self) -> int:
        with self._lock:
            return self._frames

    def anomalies(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._anomaly_counts)

    def anomaly_log(self) -> List[Dict]:
        with self._lock:
            return list(self._anomaly_log)

    def records(self) -> List[Dict]:
        with self._lock:
            return list(self._ring)

    def snapshot(self) -> Dict:
        """Rollup for the admin 'fleet' op / fleet_console: the latest
        frame decoded plus anomaly state — everything a console needs
        without shipping the ring."""
        with self._lock:
            f = self._latest
            frames = self._frames
            ring_len = len(self._ring)
            anomalies = dict(self._anomaly_counts)
            anomaly_log = list(self._anomaly_log)[-8:]
        lay = self.layout
        out: Dict = {
            "member": self.member,
            "frames": frames,
            "rows": lay.n_rows,
            "groups": lay.num_groups,
            "replicas": lay.num_replicas,
            "heat_bins": lay.heat_bins,
            "heat_bin_starts": lay.bin_starts(),
            "bucket_labels": list(BUCKET_LABELS),
            "ring_len": ring_len,
            "anomalies": anomalies,
            "anomaly_log": anomaly_log,
            # Gray-failure signal: the rebalancer's
            # eviction trigger — LEVEL (currently limping), not just
            # the counted edge in `anomalies`.
            "limp": self.limp_state(),
        }
        if f is not None:
            out.update({
                "leader_slot": f["leader_slot"].astype(int).tolist(),
                "leaders_total": int(f["leader_slot"].sum()),
                "role_census": {
                    rn: int(f["role_census"][i])
                    for i, rn in enumerate(ROLE_NAMES)},
                "pr_census": {
                    sn: int(f["pr_census"][i])
                    for i, sn in enumerate(PR_STATE_NAMES)},
                "fenced": int(f["fenced"][0]),
                "term": {"min": int(f["term_min"][0]),
                         "max": int(f["term_max"][0]),
                         "sum": int(f["term_sum"][0])},
                "lag_max": int(f["top_lag"][0]),
                "ring_occ_max": int(f["ring_occ_max"][0]),
                "top": self._top_entries(f),
                "hist": {
                    "commit_delta":
                        f["hist_commit_delta"].astype(int).tolist(),
                    "backlog":
                        f["hist_backlog"].astype(int).tolist(),
                    "inflight":
                        f["hist_inflight"].astype(int).tolist(),
                    "ring_occupancy":
                        f["hist_ring_occupancy"].astype(int).tolist(),
                },
            })
        return out

    # -- heatmap artifact -----------------------------------------------------

    def dump(self, path: Optional[str] = None,
             reason: str = "manual") -> str:
        """Write the groups×time heatmap ring (+ the rollup snapshot)
        as a JSON artifact; returns the path."""
        if path is None:
            path = dump_path(KIND_FLEETHEAT, self.member, reason,
                             self.dump_dir)
        lay = self.layout
        payload = {
            "member": self.member,
            "reason": reason,
            "captured_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "heat_bins": lay.heat_bins,
            "heat_bin_starts": lay.bin_starts(),
            "num_groups": lay.num_groups,
            "rollup": self.snapshot(),
            "ring": self.records(),
        }
        with open(path, "w") as fh:
            json.dump(payload, fh, indent=1)
            fh.write("\n")
        with self._lock:
            self.last_dump = path
        return path
