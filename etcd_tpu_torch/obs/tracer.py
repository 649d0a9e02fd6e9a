"""Per-member proposal-lifecycle tracer (the obs package core).

A *span* is one sampled proposal's life on ONE member, keyed by
``(group, term, index)``: a dict of stage-name → ``time.monotonic_ns()``
stamps. The same key on different members yields the per-member
fragments ``tools/trace_merge.py`` joins into a cross-member timeline
— the leader fragment carries propose/fsync/send/commit/apply, each
follower fragment carries its own extract (receive proxy) / fsync /
send (ack) — so no trace id ever rides the wire.

Sampling is deterministic in ``(group, index)`` (seedable): every
member decides identically whether a proposal is traced, with no
coordination and no per-message flag. Default rate ~1/64.

Cost discipline: with tracing off the hot path pays a single
``is not None`` check per hook site. With it on, the round thread pays
three ``monotonic_ns`` reads per round plus one vectorized hash over
the round's (rare) persisted/committed entry arrays; stamps take a
plain lock that only the round and drain threads ever touch. Rings are
bounded; overflow increments ``etcd_tpu_trace_span_drops_total`` on
the shared registry instead of silently shedding.

Ports ``etcd_tpu/obs/tracer.py`` whole; the port keeps its own copy and
tests/test_torch_hubs.py pins it equal.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

# Canonical stage order: every stamp a member can take, in causal
# order. A member's fragment holds a subset ("propose" is origin-only;
# commit/apply arrive rounds after send). tools/trace_merge.py names
# the hops between adjacent present stages.
STAGES = (
    "propose",   # client payload enqueued on the leader (rawnode.propose)
    "stage",     # round staging began (inbox build; advance_round entry)
    "dispatch",  # device round dispatched (host->device staging done)
    "extract",   # device round done; host extraction began
    "fsync_wait",  # covering WAL group-commit fsync STARTED (the
    # extract->fsync_wait hop is record build + persistence-queue wait
    # — with the async WAL pipeline on, the time the entry sat in the
    # open buffer behind earlier waves)
    "fsync",     # covering WAL group-commit fsync COMPLETED
    "send",      # round's outbound batch handed to the transport
    "commit",    # commit watermark reached the entry (extraction time)
    "apply",     # state machine applied the entry
)
STAGE_INDEX = {s: i for i, s in enumerate(STAGES)}

# splitmix64-style mixing constants (golden-ratio increments); the
# point is only that group and index bits both reach every output bit.
_MIX_A = 0x9E3779B97F4A7C15
_MIX_B = 0xC2B2AE3D27D4EB4F
_M64 = (1 << 64) - 1

SpanKey = Tuple[int, int, int]  # (group, term, index)


def _mix(group: int, index: int, seed: int) -> int:
    h = ((group * _MIX_A) ^ (index * _MIX_B)) + seed & _M64
    h &= _M64
    h ^= h >> 33
    return h & _M64


class Tracer:
    """Bounded span collector for one member.

    ``sample``: trace 1-in-``sample`` proposals (1 = every proposal —
    tests and the check.sh trace smoke use that). ``seed`` shifts WHICH
    proposals are picked; every member of a cluster must share it (the
    join depends on all members sampling the same keys).
    """

    # Open spans (stamped but not yet applied) beyond this cap evict
    # oldest-first into the ring, flagged incomplete: a lost/truncated
    # proposal must not pin memory forever.
    OPEN_CAP = 4096

    def __init__(self, member: str = "0", sample: int = 64,
                 seed: int = 0, ring: int = 8192,
                 registry=None,
                 dump_dir: Optional[str] = None) -> None:
        self.member = str(member)
        self.sample = max(1, int(sample))
        self.seed = int(seed) & _M64
        self.dump_dir = dump_dir or os.environ.get(
            "ETCD_TPU_FLIGHTREC_DIR", "artifacts")
        self._lock = threading.Lock()
        self._open: Dict[SpanKey, Dict[str, int]] = {}
        self._ring: deque = deque(maxlen=int(ring))
        # Lazy import: batched.telemetry (the registry module for this
        # plane) transitively imports the hosting layer, which imports
        # this module — at construction time the cycle is long settled.
        from ..batched.telemetry import (
            trace_drop_counter,
            trace_span_counter,
        )

        self._spans_c = trace_span_counter(registry).labels(self.member)
        self._drops = trace_drop_counter(registry)
        self._drop_children: Dict[str, object] = {}
        self.last_dump: Optional[str] = None

    # -- sampling --------------------------------------------------------------

    def sampled(self, group: int, index: int) -> bool:
        """Deterministic sampling decision — identical on every member
        for the same (group, index), whatever order stamps arrive in."""
        return _mix(int(group), int(index), self.seed) % self.sample == 0

    def sampled_arr(self, groups: np.ndarray, idxs: np.ndarray) -> np.ndarray:
        """Vectorized ``sampled`` over parallel arrays (the round's
        entry-extraction path: one hash per persisted/committed entry,
        no Python loop until a hit)."""
        g = np.asarray(groups, np.uint64)
        i = np.asarray(idxs, np.uint64)
        h = (g * np.uint64(_MIX_A)) ^ (i * np.uint64(_MIX_B))
        h = h + np.uint64(self.seed)
        h = h ^ (h >> np.uint64(33))
        return (h % np.uint64(self.sample)) == 0

    # -- stamping --------------------------------------------------------------

    def _drop(self, cls: str) -> None:
        child = self._drop_children.get(cls)
        if child is None:
            child = self._drops.labels(self.member, cls)
            self._drop_children[cls] = child
        child.inc()

    def _stamp_locked(self, key: SpanKey, stage: str, t_ns: int) -> None:
        sp = self._open.get(key)
        if sp is None:
            if len(self._open) >= self.OPEN_CAP:
                old_key, old_sp = next(iter(self._open.items()))
                del self._open[old_key]
                self._retire_locked(old_key, old_sp, complete=False)
                self._drop("open_evict")
            sp = self._open[key] = {}
            self._spans_c.inc()
        if stage not in sp:
            sp[stage] = int(t_ns)
        if stage == "apply":
            del self._open[key]
            self._retire_locked(key, sp, complete=True)

    def stamp(self, group: int, term: int, index: int, stage: str,
              t_ns: Optional[int] = None) -> None:
        """Record one stage stamp; creates the span lazily (peer-side
        fragments have no ``propose``). First-stamp-wins per stage — a
        retransmitted append must not move an already-taken stamp."""
        if t_ns is None:
            t_ns = time.monotonic_ns()
        with self._lock:
            self._stamp_locked((int(group), int(term), int(index)),
                               stage, t_ns)

    def stamp_many(self, keys: Iterable[SpanKey], stage: str,
                   t_ns: Optional[int] = None) -> None:
        """One lock acquisition for a batch of keys sharing one stamp
        (the fsync/send/apply hooks stamp a whole Ready's traced keys
        at the same instant — that IS the semantics: one batch fsync /
        one outbound batch covers them all)."""
        keys = list(keys)
        if not keys:
            return
        if t_ns is None:
            t_ns = time.monotonic_ns()
        t_ns = int(t_ns)
        with self._lock:
            for g, t, i in keys:
                self._stamp_locked((int(g), int(t), int(i)), stage,
                                   t_ns)

    def _retire_locked(self, key: SpanKey, sp: Dict[str, int],
                       complete: bool) -> None:
        if len(self._ring) == self._ring.maxlen:
            self._drop("ring_evict")
        self._ring.append({
            "group": key[0], "term": key[1], "index": key[2],
            "complete": bool(complete), "stages": sp,
        })

    # -- readout ---------------------------------------------------------------

    def spans(self, include_open: bool = True) -> List[Dict]:
        """Retired spans (ring order) plus, optionally, still-open
        fragments — peers never see ``apply`` for entries the leader
        already answered, so the join needs the open set too."""
        with self._lock:
            out = list(self._ring)
            if include_open:
                out.extend(
                    {"group": k[0], "term": k[1], "index": k[2],
                     "complete": False, "stages": dict(sp)}
                    for k, sp in self._open.items()
                )
        return out

    def span_count(self) -> int:
        with self._lock:
            return len(self._ring) + len(self._open)

    def to_payload(self) -> Dict:
        """The dump/admin-op payload shape tools/trace_merge.py joins.
        ``monotonic_ns``/``wall_ns`` are a paired reading of the two
        clocks at capture time — a coarse cross-process anchor the
        merge refines with send/recv pair offsets."""
        t_mono = time.monotonic_ns()
        t_wall = time.time_ns()
        return {
            "member": self.member,
            "sample": self.sample,
            "seed": self.seed,
            "stage_names": list(STAGES),
            "monotonic_ns": t_mono,
            "wall_ns": t_wall,
            "spans": self.spans(include_open=True),
        }

    def dump(self, path: Optional[str] = None,
             reason: str = "manual") -> str:
        """Write the span ring as JSON next to the flight recorders;
        returns the path."""
        if path is None:
            # Shared collision-free artifact naming (obs.artifacts):
            # keyed by kind+member, made unique by pid + sequence so
            # simultaneous multi-member (or same-second re-)dumps
            # never overwrite each other.
            from .artifacts import KIND_TRACERING, dump_path

            path = dump_path(KIND_TRACERING, self.member, reason,
                             self.dump_dir)
        payload = self.to_payload()
        payload["reason"] = reason
        payload["captured_at"] = time.strftime("%Y-%m-%dT%H:%M:%S")
        with open(path, "w") as f:
            json.dump(payload, f, indent=1)
            f.write("\n")
        with self._lock:
            self.last_dump = path
        return path


def make_tracer(member: str,
                enabled: Optional[bool] = None,
                registry=None,
                dump_dir: Optional[str] = None) -> Optional[Tracer]:
    """Constructor for the hosting layer: returns a Tracer or None
    (tracing stays a single ``is not None`` on the hot path).
    ``enabled=None`` defers to ETCD_TPU_TRACE; True/False force it.
    ETCD_TPU_TRACE_SAMPLE (default 64) and ETCD_TPU_TRACE_SEED
    (default 0) tune sampling — the seed must match across members."""
    if enabled is None:
        enabled = os.environ.get(
            "ETCD_TPU_TRACE", "") not in ("", "0", "false")
    if not enabled:
        return None
    return Tracer(
        member=member,
        sample=int(os.environ.get("ETCD_TPU_TRACE_SAMPLE", "64")),
        seed=int(os.environ.get("ETCD_TPU_TRACE_SEED", "0")),
        registry=registry,
        dump_dir=dump_dir,
    )
