"""Lockstep hosting: R members of one hosting module driven round by
round on the caller's thread, for differentials between two clusters.

A ``Lockstep`` cluster runs ``MultiRaftMember``s synchronously
(``pipeline=False``, never ``start()``ed) over an ``InProcRouter``: a
step ticks every live member once, then runs one round on each live
member in id order; the router delivers each member's sends into its
peers' staging before their rounds. With the same config and the same
schedule, two clusters therefore see the same inputs in the same
order, whatever package (``etcd_tpu`` or the port) or device they run
on. Wall-clock gates in hosting (the joint-config sweep and the
leave-joint cooldown) read ``StepClock``, which moves only with the
steps.

``run_schedule`` drives a seeded schedule of ticks, puts, deletes, a
leadership transfer, an isolate and heal, a joint membership change
(remove, re-add as learner, catch-up-gated promote) and a crash and
restart through any number of clusters at once, and hands the caller
each step's ``observe()`` of every cluster: the WAL records each member
appended, its ``GroupKV`` snapshots and applied index, the rawnode's
host mirrors and its ``health()`` without the per-process fields.

The module takes hosting modules as arguments and imports none, so the
same driver holds the port against ``etcd_tpu`` (tests) and CUDA
members against CPU members (chip_smoke.py).
"""

from __future__ import annotations

import contextlib
import time as _time
from typing import Callable, Dict, List, Optional

import numpy as np


class StepClock:
    """A stand-in for the ``time`` module inside hosting: monotonic
    time advances only by ``advance``; perf counters and sleeps are
    the real ones."""

    perf_counter = staticmethod(_time.perf_counter)
    perf_counter_ns = staticmethod(_time.perf_counter_ns)
    sleep = staticmethod(_time.sleep)
    time = staticmethod(_time.time)

    def __init__(self, start: float = 1000.0) -> None:
        self.t = start

    def advance(self, dt: float) -> None:
        self.t += dt

    def monotonic(self) -> float:
        return self.t

    def monotonic_ns(self) -> int:
        return int(self.t * 1e9)


@contextlib.contextmanager
def step_clock(*hosting_modules, start: float = 1000.0):
    """Point each hosting module's ``time`` at one StepClock for the
    duration of the block."""
    clock = StepClock(start)
    saved = [(h, h.time) for h in hosting_modules]
    try:
        for h in hosting_modules:
            h.time = clock
        yield clock
    finally:
        for h, t in saved:
            h.time = t


class Lockstep:
    """R synchronous members of ``hosting`` over its InProcRouter."""

    def __init__(self, hosting, data_dir: str, cfg, num_members: int,
                 num_groups: int, **member_kw) -> None:
        self.hosting = hosting
        self.data_dir = data_dir
        self.cfg = cfg
        self.r = num_members
        self.g = num_groups
        self.kw = member_kw
        self.router = hosting.InProcRouter()
        self.members: Dict[int, object] = {}
        # Per member id: every (record type, bytes) its WAL handles
        # appended, across restarts.
        self.wal_log: Dict[int, List] = {}
        self.conf_target = num_members  # the member the schedule reconfigures
        for mid in range(1, num_members + 1):
            self.boot(mid)

    def boot(self, mid: int):
        m = self.hosting.MultiRaftMember(
            mid, self.r, self.g, self.data_dir, cfg=self.cfg,
            pipeline=False, **self.kw)
        log = self.wal_log.setdefault(mid, [])
        append = m.wal.append

        def logged(rtype, data, _append=append, _log=log):
            _log.append((int(rtype), bytes(data)))
            _append(rtype, data)

        m.wal.append = logged
        self.router.attach(m)
        self.members[mid] = m
        return m

    def alive(self) -> List:
        return [m for _, m in sorted(self.members.items())
                if not m._stopped.is_set()]

    def step(self) -> None:
        live = self.alive()
        for m in live:
            m.rn.tick()
        for m in live:
            m.run_round()

    def leader(self, group: int) -> Optional[object]:
        for m in self.alive():
            if m.is_leader(group):
                return m
        return None

    def crash(self, mid: int) -> None:
        self.members[mid].crash()

    def restart(self, mid: int):
        return self.boot(mid)

    def stop(self) -> None:
        for m in self.members.values():
            m.stop()

    def observe(self) -> Dict[int, Dict[str, object]]:
        """Per member: WAL records appended so far, KV snapshots and
        applied index, the rawnode's host mirrors, and health()."""
        out = {}
        for mid, m in sorted(self.members.items()):
            rn = m.rn
            term, role, lead = rn.m_view
            h = m.health()
            out[mid] = {
                "wal": list(self.wal_log[mid]),
                "kv": [kv.snapshot() for kv in m.kvs],
                "applied": m.applied_index.tolist(),
                "view": (term.tolist(), role.tolist(), lead.tolist()),
                "last": rn.m_last.tolist(),
                "snap": rn.m_snap.tolist(),
                "health": h,
            }
        return out


def first_diff(a, b, path: str = "") -> Optional[str]:
    """The path of the first difference between two nested values
    (dicts, lists, tuples, numpy arrays, scalars, bytes), or None when
    equal. Arrays must agree in dtype too."""
    if isinstance(a, np.ndarray) and isinstance(b, np.ndarray):
        if a.dtype != b.dtype:
            return f"{path}: dtype {a.dtype} != {b.dtype}"
        a, b = a.tolist(), b.tolist()
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return f"{path}: keys {sorted(set(a) ^ set(b), key=str)}"
        for k in a:
            d = first_diff(a[k], b[k], f"{path}.{k}")
            if d:
                return d
        return None
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return f"{path}: length {len(a)} != {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            d = first_diff(x, y, f"{path}[{i}]")
            if d:
                return d
        return None
    return None if a == b else f"{path}: {a!r} != {b!r}"


def run_schedule(clusters: List[Lockstep], clock: StepClock,
                 seed: int = 7, steps: int = 160,
                 check: Callable[[int, str, List[Dict]], None] = None,
                 puts_per_step: int = 2) -> Dict[str, int]:
    """Drive every cluster through one seeded schedule, calling
    ``check(step, event, observations)`` after every step. Decisions
    (which group, which leader) come from cluster 0's state, which the
    checks hold equal to every other cluster's. Returns the counts of
    puts and deletes proposed and each event's outcome."""
    rng = np.random.default_rng(seed)
    c0 = clusters[0]
    g, r = c0.g, c0.r
    counts: Dict[str, object] = {"puts": 0, "deletes": 0, "proposed": 0,
                                 "steps": 0}
    # Event steps (fixed offsets after the first full election).
    plan = {10: "transfer", 25: "isolate", 45: "heal", 60: "demote",
            80: "add-learner", 95: "promote", 110: "crash",
            130: "restart"}
    elected_at = None
    keys = [b"k%d" % i for i in range(6)]
    for s in range(steps):
        event = ""
        if elected_at is None and all(
                c0.leader(grp) is not None for grp in range(g)):
            elected_at = s
        rel = None if elected_at is None else s - elected_at
        if rel is not None and rel in plan:
            event = plan[rel]
            counts[event] = _event(clusters, event, g, r)
        if rel is not None:
            for _ in range(puts_per_step):
                grp = int(rng.integers(g))
                key = keys[int(rng.integers(len(keys)))]
                delete = bool(rng.random() < 0.2)
                payload = (c0.hosting.GroupKV.delete_payload(key) if delete
                           else c0.hosting.GroupKV.put_payload(
                               key, b"v%d.%d" % (s, grp)))
                ok = [None if (m := c.leader(grp)) is None
                      else m.propose(grp, payload) for c in clusters]
                assert len(set(ok)) == 1, (s, grp, ok)
                if ok[0]:
                    counts["deletes" if delete else "puts"] += 1
                    counts["proposed"] += 1
        for c in clusters:
            c.step()
        clock.advance(0.1)
        counts["steps"] += 1
        if check is not None:
            check(s, event, [c.observe() for c in clusters])
    return counts


def _event(clusters: List[Lockstep], event: str, g: int, r: int) -> str:
    """One scheduled fault or admin action, the same on every cluster;
    returns its outcome, which must agree across clusters."""
    outs = []
    for c in clusters:
        out = "done"
        if event == "transfer":
            m = c.leader(0)
            out = str(m.transfer_leader(0, m.id % r + 1))
        elif event == "isolate":
            c.router.isolate(2)
        elif event == "heal":
            c.router.heal(2)
        elif event in ("demote", "add-learner", "promote"):
            # A follower of group g-1 leaves it through a joint config,
            # comes back as a learner, and is promoted once caught up.
            m = c.leader(g - 1)
            if event == "demote" and m is not None:
                c.conf_target = m.id % r + 1
            out = "no-leader" if m is None else str(m.reconfig(
                {"demote": "remove"}.get(event, event), c.conf_target,
                [g - 1], joint=(event == "demote")))
        elif event == "crash":
            c.crash(r)
        elif event == "restart":
            c.restart(r)
        outs.append(out)
    assert len(set(outs)) == 1, (event, outs)
    return outs[0]
