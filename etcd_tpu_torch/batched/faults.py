"""Seeded fault injection for the batched multi-raft hosting path.

The reference ships a dedicated functional tester (tests/functional/
tester: kill/blackhole/delay cases, KV-hash checkers) for the single
server; this module is its analog for the layer the paper actually bets
on — ``MultiRaftMember`` over ``InProcRouter`` or the TCP fabric,
thousands of groups per member. Three planes:

* **message faults** — ``FaultPlan`` (one seed → per-link ``random``
  streams) decides drop / duplicate / delay / reorder per (src, dst)
  link; ``FaultyFabric`` interposes on each member's outbound send
  callables, so the SAME fault plane drives both the in-proc router and
  real TCP sockets. Symmetric and asymmetric partitions are directed
  link blocks on the plan.
* **storage faults** — the gofail-style failpoints hosting.py exposes on
  its persistence path (``hosting.m<id>.raftBeforeSave`` /
  ``raftAfterSave``, ref: etcdserver/raft.go raftBeforeSave &c) armed to
  ``MultiRaftMember.crash()``, plus torn-tail injection (truncate the
  last WAL segment at an arbitrary byte inside the written prefix).
* **disk faults** — ``DiskFaultPlan``, an errfs-style shim
  at the ``native/walog.py`` + ``storage/snap.py`` file-op seam:
  one-shot/sticky fsync and write errors, sticky ENOSPC (armed/healed
  so the write-back-pressure contract is testable end to end), per-op
  latency injection (slow-disk as a *fault* — the gray-failure limp),
  and seeded at-rest bit-flips in mid-log records
  (``ChaosHarness.bit_rot``). The contract the shim tests lives in
  hosting.py: first failed fsync ⇒ member fail-stop releasing nothing
  from the failed window; ENOSPC at the seam ⇒ back-pressure that
  recovers with zero acked loss; mid-log CRC corruption ⇒ salvage +
  fenced boot + snapshot/probe heal.
* **process faults** — scripted kill/restart cycles: ``crash()`` then a
  fresh member on the same data_dir, booting through ``_replay``.

Determinism: one seed fixes every fault *decision* (which sends drop,
how long delays run, where the torn byte lands). Thread scheduling still
varies wall-clock interleavings run to run — the invariants the
checkers assert (``functional.checker``) hold for every
interleaving, which is exactly what makes them invariants.
"""

from __future__ import annotations

import heapq
import itertools
import logging
import os
import random
import threading
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..native.walog import DiskFullError, InjectedIOError
from ..pkg import failpoint
from ..pkg.failpoint import FailpointPanic
from .hosting import (
    GroupKV,
    InProcRouter,
    MultiRaftMember,
    TCPRouter,
    wait_group_leaders,
)
from .state import BatchedConfig, LEADER
from .telemetry import disk_fault_injected_counter

_log = logging.getLogger("etcd_tpu.batched.faults")


@dataclass(frozen=True)
class FaultSpec:
    """Per-link fault probabilities (drawn per message batch)."""

    drop: float = 0.0  # lose the batch
    dup: float = 0.0  # deliver it twice
    delay: float = 0.0  # hold it for uniform(1ms, delay_max_s)
    delay_max_s: float = 0.03
    # Brief hold (0.5–5 ms) WITHOUT the big delay: later sends on the
    # link overtake this one — cheap, frequent local reordering.
    reorder: float = 0.0


class FaultPlan:
    """Deterministic fault decisions: one seed → an independent
    ``random.Random`` stream per directed link, so the decision sequence
    on a link depends only on (seed, src, dst, #sends on that link),
    never on cross-thread interleaving. Partitions are a mutable set of
    blocked directed links layered on top."""

    def __init__(self, seed: int, spec: Optional[FaultSpec] = None) -> None:
        self.seed = seed
        self.spec = spec or FaultSpec()
        self._rngs: Dict[Tuple[int, int], random.Random] = {}
        self._lock = threading.Lock()
        self._blocked: set = set()  # directed (src, dst) links

    def link_rng(self, src: int, dst: int) -> random.Random:
        with self._lock:
            r = self._rngs.get((src, dst))
            if r is None:
                r = random.Random(f"{self.seed}/{src}->{dst}")
                self._rngs[(src, dst)] = r
            return r

    def derived_rng(self, tag: str) -> random.Random:
        """Seed-scoped stream for non-link decisions (torn-byte offset,
        victim choice, partition schedule)."""
        return random.Random(f"{self.seed}/{tag}")

    # -- partitions ------------------------------------------------------------

    def block_link(self, src: int, dst: int) -> None:
        with self._lock:
            self._blocked.add((src, dst))

    def partition(self, a: int, b: int, symmetric: bool = True) -> None:
        """Cut a<->b (or only a->b when symmetric=False — the asymmetric
        half-open link that message-reorder bugs love)."""
        self.block_link(a, b)
        if symmetric:
            self.block_link(b, a)

    def isolate_member(self, mid: int, peers) -> None:
        for p in peers:
            if p != mid:
                self.partition(mid, p, symmetric=True)

    def heal_link(self, src: int, dst: int) -> None:
        with self._lock:
            self._blocked.discard((src, dst))

    def heal_all(self) -> None:
        with self._lock:
            self._blocked.clear()

    def blocked(self, src: int, dst: int) -> bool:
        return (src, dst) in self._blocked

    def quiesce(self) -> None:
        """Episode end: zero the probabilistic faults and heal every
        partition so the cluster can converge for the checkers."""
        self.spec = FaultSpec()
        self.heal_all()

    # -- per-send decision -----------------------------------------------------

    def decide(self, src: int, dst: int) -> Tuple[bool, int, float]:
        """(drop, copies, delay_s) for the next batch on src->dst."""
        sp = self.spec
        r = self.link_rng(src, dst)
        drop = r.random() < sp.drop
        copies = 2 if r.random() < sp.dup else 1
        delay = 0.0
        if r.random() < sp.delay:
            delay = r.uniform(0.001, sp.delay_max_s)
        elif r.random() < sp.reorder:
            delay = r.uniform(0.0005, 0.005)
        return drop, copies, delay


class _MemberDiskState:
    """Armed disk faults for one member (DiskFaultPlan internal)."""

    __slots__ = ("fsync_errors", "fsync_sticky", "write_errors",
                 "write_sticky", "enospc", "delay_s", "delay_ops")

    def __init__(self) -> None:
        self.fsync_errors = 0
        self.fsync_sticky = False
        self.write_errors = 0
        self.write_sticky = False
        self.enospc = False
        self.delay_s = 0.0
        self.delay_ops: Tuple[str, ...] = ("fsync",)


class DiskFaultPlan:
    """Deterministic storage-fault decisions at the Walog/Snapshotter
    file-op seam (the errfs idea from "Can Applications Recover from
    fsync Failures?", ATC'19, as a Python shim): ``hook_for(mid)``
    returns the per-member ``fault_hook(op, nbytes)`` a member threads
    into its WAL handle; arming methods flip what the hook does.
    Seeded like FaultPlan — the seed scopes the derived rngs (bit-flip
    placement) so a failing episode replays from its seed.

    Faults raise AT THE SEAM, before the native call starts, which is
    what makes hosting's contracts sound: a DiskFullError provably
    wrote nothing (retry-same-record is legal), an InjectedIOError at
    op="fsync" models the kernel failing fdatasync with the dirty
    pages' fate unknown (fail-stop is the only safe answer). Latency
    injection sleeps at the seam — pure IO wait, generalizing
    ETCD_TPU_FSYNC_DELAY_MS to a per-member, per-op, runtime-armable
    fault (the gray-failure limp)."""

    def __init__(self, seed: int) -> None:
        self.seed = seed
        self._lock = threading.Lock()
        self._state: Dict[int, _MemberDiskState] = {}
        self._stats: Dict[str, int] = defaultdict(int)
        self._c_injected = disk_fault_injected_counter()

    def derived_rng(self, tag: str) -> random.Random:
        return random.Random(f"{self.seed}/disk/{tag}")

    def _st(self, mid: int) -> _MemberDiskState:
        st = self._state.get(mid)
        if st is None:
            st = self._state[mid] = _MemberDiskState()
        return st

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._stats)

    # -- arming ----------------------------------------------------------------

    def arm_fsync_error(self, mid: int, count: int = 1,
                        sticky: bool = False) -> None:
        """Fail the member's next `count` fsyncs (or EVERY fsync when
        sticky) — the ATC'19 fault. The contract under test: the FIRST
        failure fail-stops the member; one-shot vs sticky only matters
        to stacks that (wrongly) retry."""
        with self._lock:
            st = self._st(mid)
            st.fsync_errors = int(count)
            st.fsync_sticky = bool(sticky)

    def arm_write_error(self, mid: int, count: int = 1,
                        sticky: bool = False) -> None:
        with self._lock:
            st = self._st(mid)
            st.write_errors = int(count)
            st.write_sticky = bool(sticky)

    def arm_enospc(self, mid: int) -> None:
        """Sticky disk-full on the member's WRITE path (append/flush,
        never fsync): writes refuse until heal_enospc — the graceful
        back-pressure episode."""
        with self._lock:
            self._st(mid).enospc = True

    def heal_enospc(self, mid: int) -> None:
        """Space returns: the member's dwelling write retries succeed
        and it resumes with zero acked loss."""
        with self._lock:
            self._st(mid).enospc = False

    def set_limp(self, mid: int, delay_s: float,
                 ops: Tuple[str, ...] = ("fsync",)) -> None:
        """Make the member LIMP: every op in `ops` takes an extra
        delay_s of pure IO wait. Not an error — the member stays alive
        and correct, just slow: the gray-failure shape the
        member_limping detector + rebalancer eviction close the loop
        on."""
        with self._lock:
            st = self._st(mid)
            st.delay_s = float(delay_s)
            st.delay_ops = tuple(ops)

    def heal_limp(self, mid: int) -> None:
        with self._lock:
            st = self._st(mid)
            st.delay_s = 0.0

    def quiesce(self) -> None:
        """Episode end: clear every armed fault (mirrors
        FaultPlan.quiesce)."""
        with self._lock:
            self._state.clear()

    # -- the seam --------------------------------------------------------------

    def hook_for(self, mid: int) -> Callable[[str, int], None]:
        def hook(op: str, nbytes: int, _mid: int = mid) -> None:
            self._decide(_mid, op, nbytes)

        return hook

    def _decide(self, mid: int, op: str, nbytes: int) -> None:
        delay = 0.0
        err: Optional[Exception] = None
        kind = None
        with self._lock:
            st = self._state.get(mid)
            if st is None:
                return
            if op in st.delay_ops and st.delay_s > 0:
                delay = st.delay_s
            if op in ("fsync", "snap_fsync") and (
                    st.fsync_sticky or st.fsync_errors > 0):
                if not st.fsync_sticky:
                    st.fsync_errors -= 1
                kind = "fsync_error"
                err = InjectedIOError(
                    f"injected fsync failure (member {mid}, {op})")
            elif op in ("append", "flush", "snap_write", "snap_rename"):
                if st.enospc:
                    kind = "enospc"
                    err = DiskFullError(
                        f"injected ENOSPC (member {mid}, {op})")
                elif st.write_sticky or st.write_errors > 0:
                    if not st.write_sticky:
                        st.write_errors -= 1
                    kind = "write_error"
                    err = InjectedIOError(
                        f"injected write failure (member {mid}, {op})")
            if kind is not None:
                self._stats[kind] += 1
            if delay > 0:
                self._stats["delay"] += 1
        if kind is not None:
            self._c_injected.labels(str(mid), op, kind).inc()
        if delay > 0:
            self._c_injected.labels(str(mid), op, "delay").inc()
            time.sleep(delay)  # pure IO wait, outside the plan lock
        if err is not None:
            raise err


class FaultyFabric:
    """Interposes the fault plane on member outbound sends. Works over
    BOTH routers because each programs ``member._send``/``_send_block``:
    the wrapper splits every outbound batch by destination, consults the
    plan per link, and forwards the surviving (possibly delayed or
    duplicated) sub-batches to the original callables. Delayed
    deliveries run on one pump thread ordered by due time; deliveries
    whose target crashed while they were in flight are dropped (and
    counted) — ``crash()`` tears the member's queues, and a harness
    that restarts the member must not have pre-crash frames leak into
    the fresh incarnation through the fabric's delay heap."""

    def __init__(self, plan: FaultPlan,
                 incarnation_fn: Optional[
                     Callable[[int], Optional[object]]] = None,
                 removed_fn: Optional[
                     Callable[[int], bool]] = None) -> None:
        self.plan = plan
        # Target-incarnation seam for the delayed-delivery pump: maps a
        # member id to an identity token for its CURRENT live
        # incarnation (None = crashed/stopped). The harness wires this
        # to its member table; the pump captures the token at enqueue
        # and re-resolves at fire, so a frame outlives neither a crash
        # NOR a crash+restart (a restarted member is a NEW incarnation
        # whose queues the crash tore). None = always deliver.
        self.incarnation_fn = incarnation_fn
        # Config-removal seam: a member that LEFT the
        # cluster config (removed voter) is treated like a crashed
        # incarnation — frames to it drop and count (removed_drop,
        # immediate and delayed paths both), and the harness issues a
        # fresh incarnation token on re-admission so frames enqueued
        # against the pre-removal identity can never leak into the
        # re-added successor. None = nobody is ever config-removed.
        self.removed_fn = removed_fn
        self._stats: Dict[str, int] = defaultdict(int)
        self._seq = itertools.count()
        self._cv = threading.Condition()
        # (due, seq, dst, token, n, deliver)
        self._heap: List[Tuple[float, int, int, object, int,
                               Callable[[], None]]] = []
        self._stopped = False
        self._pump = threading.Thread(target=self._pump_loop, daemon=True)
        self._pump.start()

    def stats(self) -> Dict[str, int]:
        with self._cv:
            return dict(self._stats)

    def _drop_kind(self, dst: int) -> str:
        """Classify a dead-target drop: config-removed vs crashed —
        the ONE classification site for both the enqueue-time and
        fire-time drops."""
        if self.removed_fn is not None and self.removed_fn(dst):
            return "removed_drop"
        return "crashed_drop"

    def _count(self, key: str, n: int = 1) -> None:
        with self._cv:
            self._stats[key] += n

    def wrap(self, member: MultiRaftMember) -> None:
        """Interpose on `member`'s send callables (call AFTER the router
        attached them; call again after a restart re-attaches)."""
        inner = member._send
        inner_blk = member._send_block
        src = member.id

        def send(from_id: int, batch) -> None:
            by_dst: Dict[int, list] = defaultdict(list)
            for g, m in batch:
                by_dst[m.to].append((g, m))
            for dst, sub in by_dst.items():
                self._ship(src, dst,
                           lambda s=sub: inner(from_id, s), len(sub))

        member._send = send
        if inner_blk is not None:
            def send_block(from_id: int, blk) -> None:
                for dst, sub in blk.split_by_target().items():
                    self._ship(src, dst,
                               lambda s=sub: inner_blk(from_id, s),
                               len(sub))

            member._send_block = send_block

    def _ship(self, src: int, dst: int, deliver: Callable[[], None],
              n: int) -> None:
        if self.removed_fn is not None and self.removed_fn(dst):
            # Removed members are out of the cluster, not just slow:
            # delivering would let a decommissioned replica keep
            # participating (and its successor inherit its traffic).
            self._count("removed_drop", n)
            return
        if self.plan.blocked(src, dst):
            self._count("partitioned", n)
            return
        drop, copies, delay = self.plan.decide(src, dst)
        if drop:
            self._count("dropped", n)
            return
        if copies > 1:
            self._count("duplicated", n)
            # The duplicate trails slightly — same-instant duplicates
            # would coalesce in the per-(row,sender,lane) inbox anyway.
            self._later(delay + 0.002, dst, n, deliver)
        if delay > 0:
            self._count("delayed", n)
            self._later(delay, dst, n, deliver)
        else:
            self._run(deliver)

    def _run(self, deliver: Callable[[], None]) -> None:
        try:
            deliver()
        except Exception:  # noqa: BLE001 — target died mid-delivery
            self._count("deliver_error")

    def _later(self, delay: float, dst: int, n: int,
               deliver: Callable[[], None]) -> None:
        tok = (self.incarnation_fn(dst)
               if self.incarnation_fn is not None else None)
        if self.incarnation_fn is not None and tok is None:
            # Target already crashed (or config-removed) at enqueue.
            self._count(self._drop_kind(dst), n)
            return
        with self._cv:
            if self._stopped:
                return
            heapq.heappush(
                self._heap,
                (time.monotonic() + delay, next(self._seq), dst, tok, n,
                 deliver))
            self._cv.notify()

    def _pump_loop(self) -> None:
        while True:
            with self._cv:
                while not self._stopped and (
                    not self._heap
                    or self._heap[0][0] > time.monotonic()
                ):
                    if self._heap:
                        self._cv.wait(
                            max(0.0, self._heap[0][0] - time.monotonic()))
                    else:
                        self._cv.wait()
                if self._stopped:
                    return
                (_due, _seq, dst, tok, n,
                 deliver) = heapq.heappop(self._heap)
            # Incarnation check AT FIRE TIME against the token captured
            # at enqueue: the member may have crashed — or crashed AND
            # restarted — while the frame sat in the heap. An identity
            # mismatch means the enqueue-time incarnation is gone, and
            # its torn-away queues must not leak frames into a
            # successor (observed as phantom traffic after crash()).
            # Config removal mismatches the same way: leaving the
            # config retires the token, re-admission mints a new one,
            # so a frame from the pre-removal era can never land in
            # the re-added member.
            if self.incarnation_fn is not None \
                    and self.incarnation_fn(dst) is not tok:
                self._count(self._drop_kind(dst), n)
                continue
            self._run(deliver)

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._heap.clear()
            self._cv.notify_all()
        self._pump.join(timeout=5)


class LeaderObserver(threading.Thread):
    """Samples every member's atomic (term, role, lead) view and records
    which member claimed leadership of each (group, term). Any (group,
    term) claimed by two different members is an election-safety
    violation — the at-most-one-leader-per-term checker input (ref:
    functional tester's leader checks; Jepsen's leader analyses)."""

    def __init__(self, members_fn: Callable[[], List[MultiRaftMember]],
                 interval: float = 0.005) -> None:
        super().__init__(daemon=True)
        self.members_fn = members_fn
        self.interval = interval
        self.claims: Dict[Tuple[int, int], int] = {}
        self.conflicts: List[Tuple[int, int, int, int]] = []
        # NB: not `_stop` — threading.Thread defines a private _stop()
        # method that join() calls on interpreter edge paths.
        self._halt = threading.Event()

    def run(self) -> None:
        while not self._halt.is_set():
            for m in self.members_fn():
                term, role, _lead = m.rn.m_view
                for g in np.nonzero(role == LEADER)[0]:
                    key = (int(g), int(term[g]))
                    prev = self.claims.setdefault(key, m.id)
                    if prev != m.id:
                        self.conflicts.append((*key, prev, m.id))
            self._halt.wait(self.interval)

    def stop(self) -> None:
        self._halt.set()
        self.join(timeout=5)


class ChaosHarness:
    """R members × G groups with a seeded fault plane, over the
    in-proc router (``transport='inproc'``), real TCP sockets
    (``transport='tcp'``), or the mmap'd shm ring fabric
    (``transport='shm'``); supports scripted crash/restart cycles
    (through ``_replay``), storage-failpoint crashes, torn-tail WAL
    injection, and an acked-write ledger for the committed-never-lost
    checker. One FaultyFabric drives all three transports through the
    same ``member._send``/``_send_block`` seam."""

    def __init__(self, data_dir: str, seed: int,
                 spec: Optional[FaultSpec] = None,
                 num_members: int = 3, num_groups: int = 8,
                 cfg: Optional[BatchedConfig] = None,
                 transport: str = "inproc",
                 tick_interval: float = 0.02,
                 pipeline: bool = True,
                 fence: bool = True,
                 trace: bool = False,
                 wal_pipeline: bool = False,
                 wal_group_max_delay: Optional[float] = None,
                 snap_cadence: Optional[int] = None,
                 snap_keep: int = 2,
                 wal_rotate_bytes: Optional[int] = None,
                 wal_pinned_segments: Optional[int] = None,
                 device=None) -> None:
        assert transport in ("inproc", "tcp", "shm"), transport
        self.data_dir = data_dir
        self.seed = seed
        self.r = num_members
        self.g = num_groups
        # trace=True flies the episode with the proposal-lifecycle
        # tracer on every member (obs.tracer): the parity/invariant
        # bar is identical — tracing must be a pure observer even
        # under faults — and checker failures dump the span rings
        # alongside the flight recorders.
        self.trace = bool(trace)
        # fence=False disables the durability watermark + fenced-boot
        # path on every member — the pre-PR behavior, kept so the
        # torn-acked divergence stays demonstrable
        # (tools/repro_progress_wedge.py --torn-acked).
        self.fence = fence
        self.cfg = cfg or BatchedConfig(
            num_groups=num_groups, num_replicas=num_members,
            window=16, max_ents_per_msg=4, max_props_per_round=4,
            election_timeout=10, heartbeat_timeout=1,
            pre_vote=True, check_quorum=True, auto_compact=True,
            # The default chaos config flies with the kernel telemetry
            # plane on: the invariant sweep localizes device-side
            # illegal states (a progress wedge once took manual
            # instrumentation to even find) and a checker failure dumps
            # every member's flight recorder.
            telemetry=True,
            # ... and with the fleet observatory on: the
            # device summary must be a pure observer even under faults
            # (strict parity + invariant_trips()==0 holds with it on),
            # and a checker failure freezes the groups×time heatmap
            # rings beside the flight recorders.
            fleet_summary=True,
        )
        self.transport = transport
        self.tick_interval = tick_interval
        self.pipeline = pipeline
        # wal_pipeline=True flies the episode with the async
        # group-commit WAL pipeline on every member: the
        # fsync runs decoupled from the round cadence and acks release
        # only at fsync completion — every chaos cell must close at the
        # same strict bar, or a pipeline reordering leaked.
        self.wal_pipeline = bool(wal_pipeline)
        self.wal_group_max_delay = wal_group_max_delay
        # Log-lifecycle plane knobs: with a cadence and a
        # rotation threshold set, every member snapshots/rotates/
        # releases DURING the chaos episode — restarts replay from
        # snapshot + rotated tail, and the same strict close applies.
        self.snap_cadence = snap_cadence
        self.snap_keep = snap_keep
        self.wal_rotate_bytes = wal_rotate_bytes
        self.wal_pinned_segments = wal_pinned_segments
        self.device = device
        self.plan = FaultPlan(seed, spec)
        # Storage fault plane: every member's WAL handle is
        # born with this plan's hook threaded in (restarts re-thread it
        # in _boot), so fsync errors / ENOSPC / limp delays can be
        # armed mid-episode without touching the member.
        self.disk = DiskFaultPlan(seed)
        self.fabric = FaultyFabric(
            self.plan, incarnation_fn=self._member_incarnation,
            removed_fn=self.is_removed)
        self.members: Dict[int, MultiRaftMember] = {}
        # Incarnation tokens (fresh object per boot AND per config
        # re-admission) + the config-removed set: a member removed from
        # the cluster config is treated like a crashed incarnation by
        # the fabric (frames drop and count as removed_drop), and
        # mark_rejoined mints a NEW token so pre-removal frames in the
        # delay heap can never leak into the re-added successor.
        self._inc_tokens: Dict[int, object] = {}
        self._removed: set = set()
        # member id -> per-member fabric (TCPRouter or ShmFabric),
        # popped + stopped on crash; inproc members share one router.
        self.routers: Dict[int, object] = {}
        self._ports: Dict[int, int] = {}  # stable rebind port per member
        self._shm_dir = os.path.join(data_dir, "shmfabric")
        self.inproc: Optional[InProcRouter] = (
            InProcRouter() if transport == "inproc" else None
        )
        # (group, key) -> latest value the workload saw applied at its
        # proposer — committed by definition, so never losable — plus
        # the full acked-version history per key, so the checker can
        # tell a lagging member (holds an older acked version) from a
        # divergent one (holds a value never acked).
        self.acked: Dict[Tuple[int, bytes], bytes] = {}
        self.acked_history: Dict[Tuple[int, bytes], List[bytes]] = {}
        self._retired_trips = 0  # trips banked from replaced members
        for mid in range(1, num_members + 1):
            self._boot(mid)
        for m in self.members.values():
            m.start()

    # -- membership ------------------------------------------------------------

    def _boot(self, mid: int) -> MultiRaftMember:
        # A restart replaces the member object (and its telemetry
        # hub): bank the outgoing hub's invariant trips first, or
        # pre-crash illegal-progress evidence silently vanishes from
        # the episode-close trips==0 assertion.
        old = self.members.get(mid)
        if old is not None and getattr(old, "hub", None) is not None:
            self._retired_trips += old.hub.trips()
        m = MultiRaftMember(
            mid, self.r, self.g, self.data_dir, cfg=self.cfg,
            tick_interval=self.tick_interval, pipeline=self.pipeline,
            fence=self.fence, trace=self.trace or None,
            wal_pipeline=self.wal_pipeline or None,
            wal_group_max_delay=self.wal_group_max_delay,
            disk_fault_hook=self.disk.hook_for(mid),
            snap_cadence=self.snap_cadence,
            snap_keep=self.snap_keep,
            wal_rotate_bytes=self.wal_rotate_bytes,
            **({"wal_pinned_segments": self.wal_pinned_segments}
               if self.wal_pinned_segments is not None else {}),
            device=self.device,
        )
        if self.inproc is not None:
            self.inproc.attach(m)
        elif self.transport == "shm":
            from .shmfabric import ShmFabric

            # A restart reopens the SAME lane ring files: the writer
            # side resumes after its crashed incarnation's last
            # published frame, the reader side resyncs (stale frames
            # counted, never delivered) — see shmfabric.ShmRing.
            router = ShmFabric(m, self._shm_dir)
            for other, r2 in self.routers.items():
                router.add_peer(other)
                r2.add_peer(mid)
            self.routers[mid] = router
        else:
            deadline = time.monotonic() + 10.0
            while True:
                try:
                    router = TCPRouter(
                        m, bind=("127.0.0.1", self._ports.get(mid, 0)))
                    break
                except OSError:
                    # Restart must rebind the crashed member's port
                    # (peer sender lanes captured its addr at thread
                    # start), but a peer's redial can momentarily squat
                    # the freed port as its EPHEMERAL source port —
                    # outbound sockets lack SO_REUSEADDR, which blocks
                    # the bind; the refused dial frees it right away.
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.1)
            self._ports[mid] = router.addr[1]
            for other, r2 in self.routers.items():
                router.add_peer(other, r2.addr)
                r2.add_peer(mid, router.addr)
            self.routers[mid] = router
        self.fabric.wrap(m)
        self.members[mid] = m
        self._inc_tokens[mid] = object()  # new incarnation per boot
        return m

    def alive(self) -> List[MultiRaftMember]:
        return [m for m in self.members.values()
                if not m._stopped.is_set()]

    def _member_incarnation(self, mid: int) -> Optional[object]:
        """Incarnation seam for the fabric's delayed-delivery pump: a
        fresh token object per boot AND per config re-admission (a
        restart replaces it, and so does mark_rejoined), or None when
        the current incarnation is crashed/stopped/config-removed."""
        m = self.members.get(mid)
        if m is None or m._stopped.is_set() or mid in self._removed:
            return None
        return self._inc_tokens.get(mid)

    def is_removed(self, mid: int) -> bool:
        """Whether `mid` is currently OUT of the cluster config (fully
        removed voter — the decommissioned state between remove and
        re-add)."""
        return mid in self._removed

    def mark_removed(self, mid: int) -> None:
        """Declare `mid` removed from the cluster config: the fabric
        drops (and counts) every frame to it, immediate and delayed —
        a decommissioned replica must not keep participating."""
        self._removed.add(mid)

    def mark_rejoined(self, mid: int) -> None:
        """Re-admit `mid` (e.g. re-added as learner): frames flow
        again, under a NEW incarnation token — anything enqueued
        against the pre-removal identity mismatches at fire time and
        drops instead of leaking into the successor."""
        self._inc_tokens[mid] = object()
        self._removed.discard(mid)

    # -- process faults --------------------------------------------------------

    def crash(self, mid: int) -> None:
        """Simulated kill -9 (see MultiRaftMember.crash)."""
        self.members[mid].crash()
        router = self.routers.pop(mid, None)
        if router is not None:
            router.stop()

    def crash_on_failpoint(self, mid: int, site: str = "before_save",
                           timeout: float = 15.0) -> None:
        """Arm a storage failpoint to crash `mid` at its next
        persistence pass (site: 'before_save' = the Ready batch is
        lost; 'after_save' = persisted but never applied before the
        crash — _replay must re-apply it; 'before_fsync_release' = the
        async WAL pipeline's window: records written to the fd, fsync
        not yet run, NOTHING released — the batch's acks/sends must
        never have escaped, and a tear of the written-unsynced suffix
        must cost only unacked bytes) and wait for the member to die."""
        m = self.members[mid]
        name = {
            "before_save": m._fp_before_save,
            "after_save": m._fp_after_save,
            "before_fsync_release": m._fp_before_release,
        }[site]

        def act(m=m, name=name):
            m.crash()
            raise FailpointPanic(name)

        failpoint.enable(name, act)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if m._stopped.is_set():
                break
            time.sleep(0.01)
        else:
            failpoint.disable(name)
            raise TimeoutError(
                f"member {mid} did not hit failpoint {name}")
        failpoint.disable(name)
        router = self.routers.pop(mid, None)
        if router is not None:
            router.stop()

    def restart(self, mid: int) -> MultiRaftMember:
        """Fresh member on the crashed member's data_dir: boots through
        _replay (WAL prefix + snapshots), re-attaches to the fabric."""
        old = self.members[mid]
        assert old._stopped.is_set(), f"member {mid} still running"
        # Never leave this member's crash failpoints armed across the
        # restart — the names are deterministic per member id, so the
        # NEW member would crash at its first persistence pass too.
        failpoint.disable(old._fp_before_save)
        failpoint.disable(old._fp_after_save)
        failpoint.disable(old._fp_before_release)
        m = self._boot(mid)
        m.start()
        return m

    # -- storage faults --------------------------------------------------------

    def torn_tail(self, mid: int, max_chop: int = 24) -> int:
        """Truncate the crashed member's LAST WAL segment at a
        seed-chosen byte inside the written prefix — the torn record a
        real crash mid-write leaves. Segments are preallocated, so the
        cut is taken from the tail OFFSET captured at crash time, not
        the file size. Returns the number of bytes chopped."""
        m = self.members[mid]
        assert m._stopped.is_set(), "torn_tail needs a crashed member"
        tail = m._wal_tail_at_crash
        wal_dir = os.path.join(self.data_dir, f"member-{mid}", "wal")
        segs = sorted(f for f in os.listdir(wal_dir)
                      if f.endswith(".wal"))
        assert segs, "no WAL segments to tear"
        path = os.path.join(wal_dir, segs[-1])
        if tail <= 64:
            return 0  # nothing beyond the segment header to tear
        rng = self.plan.derived_rng(f"torn/{mid}")
        chop = rng.randint(1, min(max_chop, tail - 64))
        os.truncate(path, tail - chop)
        _log.info("torn tail: member %d seg %s cut %d bytes at %d",
                  mid, segs[-1], chop, tail - chop)
        return chop

    def torn_acked_tail(self, mid: int) -> Tuple[int, int]:
        """DETERMINISTIC acked-loss tear: truncate the crashed member's
        last WAL segment a few bytes INTO its final entry record, so an
        fsync'd (and, if the write was acked, committed) entry is
        verifiably destroyed with a mid-record break — the fault class
        the durability fence exists for. Returns (bytes_chopped,
        group_of_the_torn_entry); (0, -1) when the tail segment holds
        no entry records (nothing acked to tear)."""
        from ..native.walog import segment_records
        from .hosting import (
            RT_ENTRY,
            RT_ENTRY_BATCH,
            WAL_ENT_DTYPE,
            _unpack_batch,
        )

        m = self.members[mid]
        assert m._stopped.is_set(), "torn_acked_tail needs a crashed member"
        wal_dir = os.path.join(self.data_dir, f"member-{mid}", "wal")
        segs = sorted(f for f in os.listdir(wal_dir)
                      if f.endswith(".wal"))
        assert segs, "no WAL segments to tear"
        path = os.path.join(wal_dir, segs[-1])
        recs = [r for r in segment_records(path)
                if r[1] in (RT_ENTRY, RT_ENTRY_BATCH)]
        if not recs:
            return 0, -1
        off, rt, ln, padded = recs[-1]
        with open(path, "rb") as f:
            f.seek(off + 12)  # record header: u32 len | u8 type | pad | crc
            body = f.read(ln)
        if rt == RT_ENTRY_BATCH:
            # A mid-record tear destroys the WHOLE batch record; report
            # the group of its last entry (the deepest demanded index —
            # any entry-carrying group in the batch boots fenced).
            group = int(_unpack_batch(body, WAL_ENT_DTYPE)["group"][-1])
        else:
            group = int.from_bytes(body[:4], "little")
        size = os.path.getsize(path)
        cut = off + 12 + 5  # mid-payload: header survives, bytes don't
        os.truncate(path, cut)
        _log.info(
            "torn acked tail: member %d seg %s cut %d bytes mid-entry "
            "(group %d, record at %d)", mid, segs[-1], size - cut,
            group, off)
        return size - cut, group

    # -- disk faults ------------------------------------------------

    def bit_rot(self, mid: int) -> Tuple[int, int]:
        """At-rest corruption: flip one seeded bit inside a MID-LOG
        record of the crashed member's last WAL segment — not the tail
        (the torn-tail cells own that), a record the chain already
        fsync'd over. The native reader refuses such a log outright;
        the contract under test is hosting._replay's salvage +
        fenced-boot path. Returns (record_offset, byte_offset) of the
        flip, or (-1, -1) when the segment is too short to hold a
        strictly-mid-log record (caller should write more first)."""
        from ..native.walog import segment_records

        m = self.members[mid]
        assert m._stopped.is_set(), "bit_rot needs a crashed member"
        wal_dir = os.path.join(self.data_dir, f"member-{mid}", "wal")
        segs = sorted(f for f in os.listdir(wal_dir)
                      if f.endswith(".wal"))
        assert segs, "no WAL segments to rot"
        path = os.path.join(wal_dir, segs[-1])
        recs = segment_records(path)
        # Strictly mid-log: skip the CRC-seed record (index 0) and the
        # last record; payload-carrying records only (an empty payload
        # leaves nothing to flip).
        candidates = [r for r in recs[1:-1] if r[2] > 0]
        if not candidates:
            return -1, -1
        rng = self.disk.derived_rng(f"bitrot/{mid}")
        off, _rt, ln, _padded = rng.choice(candidates)
        byte_off = off + 12 + rng.randrange(ln)
        with open(path, "r+b") as f:
            f.seek(byte_off)
            b = f.read(1)
            f.seek(byte_off)
            f.write(bytes([b[0] ^ (1 << rng.randrange(8))]))
        _log.info("bit rot: member %d seg %s record at %d, byte %d "
                  "flipped", mid, segs[-1], off, byte_off)
        return off, byte_off

    def wait_fail_stop(self, mid: int, timeout: float = 20.0) -> str:
        """Wait for `mid` to die by the IO-error contract's fail-stop
        arm (crash-shaped death with a recorded cause); tears down its
        router like crash() does. Returns the recorded cause."""
        m = self.members[mid]
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if m._stopped.is_set():
                break
            time.sleep(0.01)
        else:
            raise TimeoutError(f"member {mid} never fail-stopped")
        assert m._crashed, f"member {mid} stopped but not crash-style"
        assert m._fail_stop_cause, \
            f"member {mid} died without a fail-stop cause"
        router = self.routers.pop(mid, None)
        if router is not None:
            router.stop()
        return m._fail_stop_cause

    def failstop_envelope(self, mid: int) -> None:
        """Release-barrier audit for a fail-stopped member: replay its
        WAL host-side and assert every apply it ever RELEASED is
        covered by its durable log (checker.check_durability_envelope)
        — an apply escaping the failed fsync's window would put
        applied_index beyond what the log can replay. (Caveat: a
        snapshot install in flight at the kill can legally bump
        applied ahead of its record in pipeline mode; the
        deterministic fail-stop cells don't install snapshots.)"""
        from ..functional.checker import check_durability_envelope
        from ..native.walog import (
            WalogError,
            read_all_classified,
            salvage,
        )
        from .hosting import (
            RT_ENTRY,
            RT_ENTRY_BATCH,
            RT_SNAPSHOT,
            _iter_entry_batch,
            _unpack_entry,
            _unpack_snap,
        )

        m = self.members[mid]
        assert m._stopped.is_set(), "envelope audit needs a dead member"
        wal_dir = os.path.join(self.data_dir, f"member-{mid}", "wal")
        try:
            records, _ts = read_all_classified(wal_dir)
        except WalogError:
            assert salvage(wal_dir) is not None
            records, _ts = read_all_classified(wal_dir)
        durable: Dict[int, int] = {}
        for rtype, data, _seq, _meta in records:
            if rtype == RT_ENTRY:
                g, i, _t, _d, _et = _unpack_entry(data)
                durable[g] = max(durable.get(g, 0), i)
            elif rtype == RT_ENTRY_BATCH:
                for g, i, _t, _d, _et in _iter_entry_batch(data):
                    durable[g] = max(durable.get(g, 0), i)
            elif rtype == RT_SNAPSHOT:
                g, i, _t, _d, _et = _unpack_snap(data)
                durable[g] = max(durable.get(g, 0), i)
        applied = {g: int(a) for g, a in enumerate(m.applied_index)
                   if a > 0}
        check_durability_envelope(applied, durable)

    # -- workload --------------------------------------------------------------

    def wait_leaders(self, timeout: float = 60.0) -> np.ndarray:
        """Every group led by some live member (the shared
        campaign-nudge convergence loop from hosting.py, restricted to
        alive members)."""
        return wait_group_leaders(self.alive, self.g, timeout=timeout)

    def put(self, group: int, key: bytes, value: bytes,
            timeout: float = 10.0) -> bool:
        """Client write against whichever live member leads `group`;
        an ack (True) means the proposer applied it — i.e. the entry
        committed — and records it in the acked ledger. False = fate
        unknown (timeout), legitimately either committed or not.
        (Same propose/poll-apply retry discipline as
        MultiRaftCluster.put, which raises on timeout instead of
        returning False and keeps no ledger — under chaos a lost write
        is an expected outcome, not an error.)"""
        payload = GroupKV.put_payload(key, value)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            for m in self.alive():
                if not m.propose(group, payload):
                    continue
                sub = min(deadline, time.monotonic() + 1.0)
                while time.monotonic() < sub:
                    if m.get(group, key) == value:
                        self.acked[(group, key)] = value
                        self.acked_history.setdefault(
                            (group, key), []).append(value)
                        return True
                    time.sleep(0.005)
            time.sleep(0.02)
        return False

    def run_workload(self, n_ops: int, prefix: bytes = b"w",
                     per_put_timeout: float = 8.0) -> int:
        """Seeded unique-key put stream over seed-chosen groups;
        returns the number of acked writes (the rest timed out under
        faults — allowed, their fate is unconstrained)."""
        rng = self.plan.derived_rng(f"workload/{prefix.decode()}")
        acked = 0
        for i in range(n_ops):
            g = rng.randrange(self.g)
            key = b"%s-%d" % (prefix, i)
            val = b"v%d-%d" % (self.seed, i)
            if self.put(g, key, val, timeout=per_put_timeout):
                acked += 1
        return acked

    def touch_all_groups(self, prefix: bytes = b"touch",
                         per_put_timeout: float = 10.0) -> int:
        """One put per group — a convergence pass after torn-tail
        recovery. Tearing bytes INSIDE the written (fsync'd, possibly
        acked) prefix voids the durability assumption the leader's
        progress tracker rests on: the leader still believes the torn
        member matches up to its pre-crash ack, so an idle group never
        gets re-replicated (there is no probe without traffic — real
        raft has the same hole, which is why real torn tails only ever
        lose UNsynced bytes). A write per group forces the append →
        reject → backtrack → resend cycle that re-heals every log."""
        acked = 0
        for g in range(self.g):
            if self.put(g, b"%s-g%d" % (prefix, g),
                        b"t%d" % self.seed, timeout=per_put_timeout):
                acked += 1
        return acked

    # -- membership churn -------------------------------------------

    def reconfig_until(self, action: str, target: int,
                       groups=None, timeout: float = 60.0,
                       joint: bool = False) -> None:
        """Drive a membership `action` for member `target` across
        `groups` (default: all) until the change is APPLIED on each
        group's current leader — the retry loop a real operator runs
        under faults: "not-leader" redirects chase moving leaderships,
        "not-ready" waits out the learner catch-up gate, mid-joint
        refusals wait for auto-leave, and a leader that IS the removal
        target gets its leadership transferred away first."""
        groups = list(range(self.g)) if groups is None else \
            [int(g) for g in groups]
        t = int(target)
        pred = {
            "add-learner": lambda c, g: bool(c.learner[g, t - 1]),
            "promote": lambda c, g: bool(
                c.voter[g, t - 1] and not c.in_joint[g]),
            "remove": lambda c, g: bool(
                not c.voter[g, t - 1] and not c.learner[g, t - 1]
                and not c.in_joint[g]),
        }[action]
        pending = set(groups)
        deadline = time.monotonic() + timeout
        spin = 0
        # Re-propose a group's change only after a dwell: the apply
        # latency is rounds, the poll loop is 50ms, and every duplicate
        # proposal is a real log entry (refused idempotently at apply,
        # but churning the log and the joint windows for nothing).
        last_prop: Dict[int, float] = {}
        while pending:
            now = time.monotonic()
            for g in sorted(pending):
                for m in self.alive():
                    if not m.is_leader(g):
                        continue
                    # Predicate under the member's lock: conf applies
                    # are multi-step mutate-then-maybe-rollback, and an
                    # unlocked read can observe a half-entered joint
                    # (voter cleared, in_joint not yet set) as "done".
                    with m._lock:
                        satisfied = pred(m.conf, g)
                    if satisfied:
                        pending.discard(g)
                        break
                    if now - last_prop.get(g, -1e9) < 1.5:
                        break
                    last_prop[g] = now
                    res = m.reconfig(action, t, [g], joint=joint)[g]
                    if res == "self":
                        # Removing the leader itself: hand leadership
                        # to another voter first (etcd's discipline).
                        others = [o.id for o in self.alive()
                                  if o.id != t]
                        m.transfer_leader(
                            g, others[(g + spin) % len(others)])
                    break
            if not pending:
                return
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"reconfig {action} m{t}: groups {sorted(pending)[:8]} "
                    f"never converged")
            spin += 1
            time.sleep(0.05)

    def churn_member(self, mid: int, groups=None,
                     timeout_each: float = 60.0,
                     dwell: Optional[Callable[[], None]] = None) -> None:
        """One full decommission/re-admission cycle for `mid`: remove
        it as voter everywhere (joint-implicit change — enter-joint at
        apply, auto-leave on the joint commit), mark it config-removed
        on the fabric (frames drop like a crashed incarnation), run the
        optional `dwell` workload while it is out, then re-admit under
        a fresh incarnation token: add-as-learner → catch-up gate →
        promote back to voter. Ends at full membership, so strict
        checkers close."""
        self.reconfig_until("remove", mid, groups=groups,
                            timeout=timeout_each, joint=True)
        if groups is None:
            self.mark_removed(mid)
        if dwell is not None:
            dwell()
        if groups is None:
            self.mark_rejoined(mid)
        self.reconfig_until("add-learner", mid, groups=groups,
                            timeout=timeout_each)
        self.reconfig_until("promote", mid, groups=groups,
                            timeout=timeout_each, joint=True)

    def dump_flight_recorders(self, reason: str = "chaos") -> List[str]:
        """Dump every live member's telemetry flight recorder, fleet
        heatmap ring AND trace-span ring (no-ops for whichever plane
        is off); returns the paths. All three share the obs.artifacts
        naming scheme, so simultaneous multi-member dumps never
        overwrite each other."""
        paths = []
        for m in self.members.values():
            hub = getattr(m, "hub", None)
            if hub is not None:
                try:
                    paths.append(hub.dump(reason=reason))
                except OSError:
                    _log.exception("flight-recorder dump failed (m%d)",
                                   m.id)
            fleet = getattr(m, "fleet", None)
            if fleet is not None:
                try:
                    paths.append(fleet.dump(reason=reason))
                except OSError:
                    _log.exception("fleet-heatmap dump failed (m%d)",
                                   m.id)
            tracer = getattr(m, "tracer", None)
            if tracer is not None:
                try:
                    paths.append(tracer.dump(reason=reason))
                except OSError:
                    _log.exception("trace-ring dump failed (m%d)", m.id)
        return paths

    def invariant_trips(self) -> int:
        """Total on-device invariant trips across members — including
        members since replaced by a restart (0 when telemetry is off).
        Episodes assert this stays 0."""
        return self._retired_trips + sum(
            m.hub.trips() for m in self.members.values()
            if getattr(m, "hub", None) is not None
        )

    def stop(self) -> None:
        self.fabric.stop()
        for m in self.members.values():
            m.stop()
        for r in self.routers.values():
            r.stop()


def run_invariant_checks(harness: ChaosHarness,
                         observer: Optional[LeaderObserver],
                         expect_members: int,
                         hash_timeout: float = 45.0,
                         acked_timeout: float = 20.0,
                         allow_lag: int = 0) -> None:
    """Episode closer: the three chaos checkers in canonical order —
    per-group KV-hash parity, committed-never-lost, then (when an
    observer ran) at-most-one-leader-per-(group, term). Since the durability fence,
    every episode class — torn tail included — closes STRICT
    (allow_lag=0, observer on): the durability fence keeps a member
    that verifiably lost fsync'd-acked bytes out of elections until it
    re-converges, which removes the one mechanism that made torn-tail
    divergence legal.

    ``allow_lag=1`` (legacy) relaxes both state checkers to quorum
    agreement — the pre-fence accommodation for torn-tail episodes:
    tearing fsync'd acked bytes let the torn member win an election
    with its shortened log and force a survivor to overwrite an entry
    it had already COMMITTED AND APPLIED, a KV divergence no protocol
    heals after the fact (root-caused with the flight
    recorder — the leader's match oscillates against the survivor's
    below-commit fast-path ack at the conflicted commit index). The
    knob remains for fence-disabled runs
    (tools/repro_progress_wedge.py --torn-acked keeps the failure
    demonstrable against ChaosHarness(fence=False)).

    When the harness flies with telemetry (the default config), the
    closer also asserts the on-device invariant sweep stayed clean —
    ZERO illegal-progress trips across every member and round. The
    pre-fix progress wedge trips `next_le_match`/`probe_wedge`
    persistently, so this is the regression tripwire for wedge-class
    kernel bugs even under relaxed state checks."""
    # Lazy: the checkers module pulls in the server stack, which the
    # batched package must not import at module load.
    from ..functional.checker import (
        check_leader_claims,
        committed_never_lost,
        multiraft_hash_check,
    )

    members = harness.alive()
    assert len(members) == expect_members, (
        f"{len(members)} members alive at episode close, "
        f"want {expect_members}")
    try:
        multiraft_hash_check(members, timeout=hash_timeout,
                             allow_lag=allow_lag)
        committed_never_lost(members, harness.acked,
                             timeout=acked_timeout,
                             allow_lag=allow_lag,
                             history=harness.acked_history)
        if observer is not None:
            observer.stop()
            check_leader_claims(observer.conflicts)
        trips = harness.invariant_trips()
        assert trips == 0, (
            f"{trips} on-device invariant trips during the episode — "
            "illegal kernel progress state (see the flight-recorder "
            "dumps in artifacts/)")
    except AssertionError:
        # Checker failure: freeze the evidence. Every member's flight
        # recorder (last K rounds of per-group kernel deltas + the
        # invariant sweep) lands in artifacts/flightrec_*.json before
        # the failure propagates.
        paths = harness.dump_flight_recorders(reason="checker-failure")
        if paths:
            _log.error("chaos checker failed; flight recorders: %s",
                       paths)
        raise
