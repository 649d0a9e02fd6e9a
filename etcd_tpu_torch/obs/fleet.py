"""Layout of the round's fleet summary frame.

Ports the layout half of ``etcd_tpu/obs/fleet.py`` (the port keeps its
own copy; tests/test_torch_planes.py pins it equal). With
``BatchedConfig.fleet_summary`` on, the round emits one flat ``[L]``
int32 vector in ``FleetLayout.fields`` order (step.py
``_fleet_frame``): log2 histograms, censuses, a groups×time heat strip
of at most ``FLEET_HEAT_BINS`` bins and the ``FLEET_TOP_K``
worst-backlogged rows with their identity. The engine adds the
``ACC_SUM`` fields across rounds and keeps the latest ``ACC_LAST``
ones. The host hub comes with the port of the host codecs.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

# Log2 buckets: bucket 0 holds v == 0; bucket b (1..B-2) holds
# v in [2^(b-1), 2^b); the last bucket is open-ended (v >= 2^(B-2)).
FLEET_BUCKETS = 16
# Worst-backlog rows surfaced with full identity per frame.
FLEET_TOP_K = 8
# Heat-strip cap: one column per group below this many groups, fixed
# group-range bins above it (the frame must not scale with G).
FLEET_HEAT_BINS = 128

ROLE_NAMES = ("follower", "candidate", "leader", "precandidate")
PR_STATE_NAMES = ("probe", "replicate", "snapshot")

ACC_SUM = "sum"    # per-round deltas: accumulate by addition
ACC_LAST = "last"  # state snapshots: latest frame wins


def bucket_lower(i: int) -> int:
    """Lower bound of log bucket i (0, 1, 2, 4, ... 2^(B-2))."""
    return 0 if i == 0 else 1 << (i - 1)


BUCKET_BOUNDS = tuple(bucket_lower(i) for i in range(FLEET_BUCKETS))


class FleetLayout:
    """Field offsets of the flat [L] int32 frame for a given (rows,
    replicas, groups) shape. The dense closed-loop engine owns every
    replica row (n_rows == G*R)."""

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
        """First group id of each heat column, mirroring the device
        mapping ``bin = g * heat_bins // num_groups``, with a final
        sentinel of num_groups."""
        g, hb = self.num_groups, self.heat_bins
        return [-(-i * g // hb) for i in range(hb)] + [g]

    def sum_mask(self) -> np.ndarray:
        """[L] bool: True where the accumulator adds frames, False where
        the latest frame replaces. Shared: callers must not mutate it."""
        return self._sum_mask

    def slice(self, vec: np.ndarray, name: str) -> np.ndarray:
        s, e = self.offsets[name]
        return np.asarray(vec)[..., s:e]

    def decode(self, vec: np.ndarray) -> Dict[str, np.ndarray]:
        vec = np.asarray(vec)
        if vec.shape[-1] != self.size:
            raise ValueError(
                f"frame length {vec.shape[-1]} != layout {self.size} "
                f"(rows={self.n_rows} R={self.num_replicas} "
                f"G={self.num_groups})")
        return {name: self.slice(vec, name) for name, _l, _a in
                self.fields}
