"""Lock-order recorder: lockdep for the hosting path's thread soup.

Ports ``etcd_tpu/analysis/lockorder.py`` whole (stdlib only).

The batched hosting layer runs a member round thread, a WAL drain
worker, a chaos delayed-delivery pump, and per-peer TCP sender lanes —
55 files in this tree spawn threads and nothing checks acquisition
discipline. This module instruments ``threading.Lock``/``RLock``
creation inside a scope, aggregates acquisitions by *creation site*
(lockdep-style lock classes), builds the cross-thread acquisition graph
(an edge A->B means some thread acquired B while holding A), and fails
on cycles — the statistical signature of an eventual deadlock, caught
even on runs where the interleaving never actually deadlocks.

Usage (chaos/hosting tests)::

    with LockOrderRecorder() as rec:
        ...build members/routers/harness...   # their locks get wrapped
        ...run the episode...
    rec.check()        # raises LockOrderViolation on any cycle

Locks created outside the ``with`` block are untouched; instances
created inside keep recording after the block exits (the run phase),
until ``rec.disable()``. Same-site self-edges (two *instances* of one
lock class nested, e.g. member A's _lock inside member B's during a
cross-member call) are recorded but excluded from cycle detection by
default — they are one abstraction level finer than class-granular
ordering can judge; ``check(strict=True)`` includes them.
"""

from __future__ import annotations

import sys
import threading
from typing import Dict, List, Optional, Set, Tuple


class LockOrderViolation(AssertionError):
    pass


def _creation_frame(skip_files: Tuple[str, ...]) -> Tuple[str, int]:
    """(full path, lineno) of the first non-infrastructure frame."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if not fn.endswith(skip_files) and "threading" not in fn:
            return fn, f.f_lineno
        f = f.f_back
    return "<unknown>", 0


class _RecordedLock:
    """Proxy around a real Lock/RLock; records acquisition order into
    the owning recorder. Supports the stdlib lock protocol including
    what threading.Condition needs from a raw lock."""

    __slots__ = ("_real", "_rec", "site")

    def __init__(self, real, rec: "LockOrderRecorder", site: str):
        self._real = real
        self._rec = rec
        self.site = site

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._real.acquire(blocking, timeout)
        if got:
            self._rec._on_acquire(self)
        return got

    def release(self):
        self._rec._on_release(self)
        self._real.release()

    __enter__ = acquire

    def __exit__(self, *exc):
        self.release()

    def locked(self):
        return self._real.locked()

    # RLock introspection Condition uses when available.
    def _is_owned(self):
        if hasattr(self._real, "_is_owned"):
            return self._real._is_owned()
        # Plain Lock fallback (mirrors Condition's own heuristic).
        if self._real.acquire(False):
            self._real.release()
            return False
        return True

    def __getattr__(self, name):
        # Condition PROBES lock._release_save/_acquire_restore and falls
        # back to single release()/acquire() when the probe raises
        # AttributeError. Forward the probe to the real lock: a wrapped
        # RLock must expose them (else a recursively-held Condition
        # wait() releases ONE level and the notifier deadlocks), and a
        # wrapped plain Lock must NOT (so the probe fails naturally and
        # the recorded release()/acquire() fallback runs).
        if name in ("_release_save", "_acquire_restore", "_at_fork_reinit"):
            return getattr(self._real, name)
        raise AttributeError(name)

    def __repr__(self):
        return f"<RecordedLock {self.site} wrapping {self._real!r}>"


class LockOrderRecorder:
    """Patch threading.Lock/RLock factories inside a scope; build the
    held->acquired graph across all threads; detect ordering cycles."""

    _SKIP_FILES = ("lockorder.py",)

    def __init__(self, name: Optional[str] = None, include=None):
        """`include`: optional predicate on the creating frame's FULL
        file path; locks created at non-matching sites stay plain
        (unrecorded). The chaos tests pass `lambda p: "etcd_tpu" in p`
        so the graph covers the drain/pump/sender-lane locks without
        jax/stdlib internals muddying cycle detection."""
        self.name = name or "lockorder"
        self.include = include
        self._orig_lock = None
        self._orig_rlock = None
        self._enabled = False
        self._patched = False
        # (held_site, acquired_site) -> sample (thread, count)
        self._mu = threading.Lock()  # real lock: created pre-patch
        self.edges: Dict[Tuple[str, str], Dict] = {}
        self._tls = threading.local()
        self.sites: Set[str] = set()

    # -- patching -------------------------------------------------------------

    def __enter__(self) -> "LockOrderRecorder":
        self.enable()
        return self

    def __exit__(self, *exc) -> None:
        self.unpatch()

    def enable(self) -> None:
        assert not self._patched, "recorder already active"
        self._orig_lock, self._orig_rlock = threading.Lock, threading.RLock
        rec = self

        def make_lock():
            path, line = _creation_frame(rec._SKIP_FILES)
            if rec.include is not None and not rec.include(path):
                return rec._orig_lock()
            return _RecordedLock(
                rec._orig_lock(), rec, f"{path.rsplit('/', 1)[-1]}:{line}")

        def make_rlock():
            path, line = _creation_frame(rec._SKIP_FILES)
            if rec.include is not None and not rec.include(path):
                return rec._orig_rlock()
            return _RecordedLock(
                rec._orig_rlock(), rec, f"{path.rsplit('/', 1)[-1]}:{line}")

        threading.Lock = make_lock
        threading.RLock = make_rlock
        self._patched = True
        self._enabled = True

    def unpatch(self) -> None:
        """Restore the factories; existing wrapped locks keep
        recording until disable()."""
        if self._patched:
            threading.Lock = self._orig_lock
            threading.RLock = self._orig_rlock
            self._patched = False

    def disable(self) -> None:
        self.unpatch()
        self._enabled = False

    # -- recording ------------------------------------------------------------

    def _held(self) -> List[str]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _on_acquire(self, lock: _RecordedLock) -> None:
        if not self._enabled:
            return
        stack = self._held()
        if stack:
            edge = (stack[-1], lock.site)
            with self._mu:
                info = self.edges.setdefault(
                    edge,
                    {"count": 0, "thread": threading.current_thread().name})
                info["count"] += 1
        with self._mu:
            self.sites.add(lock.site)
        stack.append(lock.site)

    def _on_release(self, lock: _RecordedLock) -> None:
        if not self._enabled:
            return
        stack = self._held()
        # Remove the most recent matching site (non-LIFO release legal).
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == lock.site:
                del stack[i]
                break

    # -- analysis -------------------------------------------------------------

    def graph(self, strict: bool = False) -> Dict[str, Set[str]]:
        with self._mu:
            g: Dict[str, Set[str]] = {}
            for (a, b) in self.edges:
                if a == b and not strict:
                    continue
                g.setdefault(a, set()).add(b)
            return g

    def cycles(self, strict: bool = False) -> List[List[str]]:
        """Elementary cycles in the acquisition graph (DFS with a
        recursion stack; one representative per back edge)."""
        g = self.graph(strict)
        out: List[List[str]] = []
        seen_cycles: Set[Tuple[str, ...]] = set()
        visited: Set[str] = set()

        def dfs(node: str, path: List[str], on_path: Set[str]) -> None:
            visited.add(node)
            on_path.add(node)
            path.append(node)
            for nxt in sorted(g.get(node, ())):
                if nxt in on_path:
                    cyc = path[path.index(nxt):] + [nxt]
                    key = tuple(sorted(set(cyc)))
                    if key not in seen_cycles:
                        seen_cycles.add(key)
                        out.append(cyc)
                elif nxt not in visited:
                    dfs(nxt, path, on_path)
            path.pop()
            on_path.discard(node)

        for node in sorted(g):
            if node not in visited:
                dfs(node, [], set())
        return out

    def check(self, strict: bool = False) -> None:
        cyc = self.cycles(strict)
        if cyc:
            detail = []
            with self._mu:
                for c in cyc:
                    pairs = list(zip(c, c[1:]))
                    detail.append(" -> ".join(c) + "  (" + "; ".join(
                        f"{a}->{b} x{self.edges[(a, b)]['count']} on "
                        f"{self.edges[(a, b)]['thread']}"
                        for a, b in pairs if (a, b) in self.edges) + ")")
            raise LockOrderViolation(
                f"[{self.name}] lock acquisition-order cycle(s) — an "
                "eventual deadlock under the wrong interleaving:\n  "
                + "\n  ".join(detail))
