"""Runtime sentinels for the batched hot path: the sync guard and the
capture budget.

Ports ``etcd_tpu/analysis/sentinels.py``. The JAX package guards
transfers and counts recompiles; on the port the counterpart of a
recompile is a new CUDA-graph capture, and the counterpart of an
implicit transfer is a host sync.

Sync guard
----------
``round_guard(device)`` reads ``ETCD_TPU_TRANSFER_GUARD``, as the JAX
package does. On a CUDA device it sets ``torch.cuda.set_sync_debug_mode``
around the guarded region and restores the previous mode after it:
``"error"`` for ``disallow``, ``"warn"`` for ``log``. It wraps the
port's *warm* device dispatch: every graph replay
(``graph.RoundGraphs.run``: the engine's closed loop, the rawnode's
round and plane) and every eager ``step_round`` after an engine's
first. So a ``.item()``, a ``nonzero`` or a pageable copy that creeps
into the steady loop is an error instead of a silent per-round sync.
Three limits:

* the first dispatch runs unguarded: it loads the kernel library,
  makes the per-device constant tables (``step._lane_table``) and
  captures the graph, all of which may sync once. The owner knows which
  dispatch is its first (a graph key already captured, an engine that
  has run a round), so the JAX package's process-wide ``warm_guard(key)``
  registry has no counterpart here;
* on the CPU the guard is a no-op: there is no device to wait for (the
  JAX guard does not trip on CPU array transfers either);
* the debug mode is process-wide, not per thread, so the guard sets and
  restores it under ``graph.device_work()``: no other thread's device
  read (a hosting drain thread reading its mirrors) runs inside the
  region and no other thread clears the mode in the middle of a round.
  PyTorch's mode "does not yet detect all synchronizing operations", so
  for the graphed round the capture itself stays the proof that the
  round makes no host sync; the guard covers what runs around it.

Recompile sentinel
------------------
``note_compile_key(program, key)`` records one key per distinct
program built this session: ``"round_step"`` per round config
(``step.make_step_round``), ``"closed_loop"`` per engine config,
``"apply_plane"`` per dispatch and gather shape, and ``"round_capture"``
per CUDA graph captured (the owner's kind, its config and the graph's
key). On the CPU only the first three count; on the card all four do.
``CompileBudget`` counts captures of tracked owners (anything with a
``.captures`` count: ``MultiRaftEngine``, ``BatchedRawNode``) against
a limit: a steady loop is held to zero new captures after warm-up.

Nothing here imports torch at module level, so the lint CLI beside it
runs without it.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Dict, Optional, Set

_TRANSFER_GUARD_ENV = "ETCD_TPU_TRANSFER_GUARD"
# The JAX package's transfer-guard levels and the sync debug mode each
# one sets on the card ("allow" and unset: no guard).
_SYNC_MODES = {"disallow": "error", "disallow_explicit": "error",
               "log": "warn", "log_explicit": "warn", "allow": ""}

_lock = threading.Lock()
_compile_keys: Dict[str, Set[str]] = {}


def transfer_guard_mode() -> str:
    """'' (off) or a JAX transfer-guard level ('disallow', 'log', ...)."""
    return os.environ.get(_TRANSFER_GUARD_ENV, "")


def _sync_mode() -> str:
    """The sync debug mode the environment asks for ('' for none)."""
    mode = transfer_guard_mode()
    if mode not in _SYNC_MODES and mode:
        raise ValueError(f"{_TRANSFER_GUARD_ENV}={mode!r}: expected one of "
                         f"{sorted(_SYNC_MODES)}")
    return _SYNC_MODES.get(mode, "")


def _on_cuda(device) -> bool:
    import torch

    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


@contextlib.contextmanager
def _debug_mode(level: str):
    """PyTorch's sync debug mode at `level` for the block, restored
    after it, all under the process-wide device lock."""
    import torch

    from ..batched.graph import device_work

    with device_work():
        previous = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(level)
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(previous)


def round_guard(device=None):
    """Context manager for a warm device dispatch on `device` (None: the
    current CUDA device, if any): the sync debug mode that
    ETCD_TPU_TRANSFER_GUARD asks for, or a no-op when it is off or the
    device is not CUDA. Only wrap dispatch whose kernels and constant
    tables are already made (a warm dispatch)."""
    level = _sync_mode()
    if not level or not _on_cuda(device):
        return contextlib.nullcontext()
    return _debug_mode(level)


# -----------------------------------------------------------------------------
# Recompile sentinel
# -----------------------------------------------------------------------------


class RecompileBudgetExceeded(RuntimeError):
    pass


def note_compile_key(program: str, key: str) -> None:
    """Record that `program` was built (or, for "round_capture",
    captured) for shape/config `key`."""
    with _lock:
        _compile_keys.setdefault(program, set()).add(key)


def distinct_shapes(program: Optional[str] = None) -> int:
    with _lock:
        if program is not None:
            return len(_compile_keys.get(program, ()))
        return sum(len(v) for v in _compile_keys.values())


def compile_keys(program: str) -> Set[str]:
    with _lock:
        return set(_compile_keys.get(program, ()))


def reset_compile_tracking() -> None:
    with _lock:
        _compile_keys.clear()


def _captures(owner) -> int:
    """CUDA graphs an owner has captured (engine.captures,
    rawnode.captures)."""
    return int(owner.captures)


class CompileBudget:
    """Counts new CUDA-graph captures across tracked owners against a
    hard limit.

        budget = CompileBudget(limit=0)
        budget.track("closed_loop", eng)
        ...drive the engine...
        budget.check()   # raises RecompileBudgetExceeded when over

    A miss is a capture made after `track`: a new graph key (a tick
    value the loop had not used) or a new owner's first round. A warmed
    steady loop makes none.
    """

    def __init__(self, limit: int):
        self.limit = int(limit)
        self._baseline: Dict[str, int] = {}
        self._owners: Dict[str, object] = {}

    def track(self, name: str, owner) -> "CompileBudget":
        self._owners[name] = owner
        self._baseline[name] = _captures(owner)
        return self

    def misses(self) -> int:
        return sum(self.report().values())

    def report(self) -> Dict[str, int]:
        return {name: _captures(owner) - self._baseline[name]
                for name, owner in self._owners.items()}

    def check(self) -> int:
        m = self.misses()
        if m > self.limit:
            raise RecompileBudgetExceeded(
                f"new CUDA-graph captures {m} > declared budget "
                f"{self.limit} (per owner: {self.report()}); a new graph "
                "key or owner captured inside the steady loop — make it "
                "conscious (raise the budget) or make it go away")
        return m
