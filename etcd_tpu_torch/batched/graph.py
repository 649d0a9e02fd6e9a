"""One round over buffers its owner keeps for its lifetime: the write
of the round's results into those buffers and, on CUDA, the round's
capture into a CUDA graph and its replays.

Shared by the closed-loop engine (engine.py) and the hosted rawnode
(rawnode.py). A graph replays fixed addresses, so an owner allocates
one buffer per state, input and output field, its round body reads the
inputs and writes every result into the buffers, and whatever the host
changes between rounds it changes in place in those buffers. This is
the counterpart of the JAX package's buffer donation.

Captures and other threads. A capture (``torch.cuda.graph``, in its
default "global" error mode) forbids any other thread of the process
the CUDA calls that could touch the captured stream: an allocation, a
pinned copy, a stream or device synchronize. Hosts such as raftexample
run each member's Ready loop in a thread of its own, so members would
capture and replay side by side. ``device_work()`` is one lock for the
whole process: ``RoundGraphs.run`` holds it for its eager round, its
capture and its replays, and the rawnode holds it for its construction
and for every round from its staged edits to its wait. Members that
share the default stream wait for each other's rounds in that wait
anyway, so the lock costs them only the host time of a round's
enqueue. On the CPU the same lock serializes the members' rounds: a
CPU round is ~2,000 small ops, each of which takes the GIL again, and
three rounds side by side convoy on it (a three-member raftexample
cluster on the CPU ran its rounds 2-3x slower without the lock).

A graph's destruction is such a call too. A crashed or retired owner's
graphs are dropped under the lock (``RoundGraphs.__del__``), and the
garbage collector is off while a capture runs, so no collection in any
thread frees an unreachable owner's graphs in the middle of it.
"""

from __future__ import annotations

import gc
import threading
import time
from typing import Callable, Iterable, List, Set, Tuple

import torch

from . import hopper_kernels as hk


_DEVICE_LOCK = threading.RLock()


def device_work() -> threading.RLock:
    """The process-wide lock around a round's device work and whatever
    CUDA work a capture in another thread must not meet (see above).
    Re-entrant."""
    return _DEVICE_LOCK


def storages(tensors: Iterable[torch.Tensor]) -> Set[int]:
    """The storage addresses of an owner's buffers."""
    return {x.untyped_storage().data_ptr() for x in tensors}


def write_back(pairs: List[Tuple[torch.Tensor, torch.Tensor]],
               owned: Set[int]) -> None:
    """Copy each result x into its buffer, one copy per (buffer, x)
    pair. A result that is its own buffer stays; one that shares storage
    with an owned buffer in any other way is cloned first, so no copy
    overwrites a result that a later copy reads (under a CUDA graph this
    check runs once, at capture)."""
    pairs = [(buf, x if x is buf
              or x.untyped_storage().data_ptr() not in owned
              else x.clone()) for buf, x in pairs]
    for buf, x in pairs:
        if x is not buf:
            buf.copy_(x)


class RoundGraphs:
    """CUDA graphs of a round body, one per key (for the engine, the
    tick value), in one memory pool: no graph's intermediates outlive
    its replay."""

    def __init__(self) -> None:
        self._graphs = {}
        self._pool = None
        self.captures = 0  # CUDA graphs captured
        self.capture_stats: List[dict] = []  # per capture: info, seconds

    def _capture(self, key, body: Callable[[], None], info: dict):
        """Capture `body` for `key`. A failed capture raises."""
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with hk.recorded_launches() as launches:
                with torch.cuda.graph(graph, pool=self._pool):
                    body()
        finally:
            if collecting:
                gc.enable()
        self._pool = graph.pool()
        self.captures += 1
        self.capture_stats.append({**info,
                                   "seconds": time.perf_counter() - t0})
        self._graphs[key] = (graph, launches)
        return self._graphs[key]

    def __del__(self) -> None:
        graphs = self.__dict__.get("_graphs")
        if graphs:
            with device_work():
                graphs.clear()

    def run(self, key, body: Callable[[], None], times: int = 1,
            **info) -> None:
        """`times` runs of `body` on the current stream with no host
        sync: replays of its graph for `key`. The first use of a key
        runs `body` once eagerly, which loads every kernel it launches,
        and then captures it. Launch counts of the replays are the
        captured body's (hopper_kernels.add_launches). All of it holds
        the device lock (device_work), the count too: members in other
        threads add to the same counts."""
        if times <= 0:
            return
        with device_work():
            entry = self._graphs.get(key)
            if entry is None:
                body()
                times -= 1
                entry = self._capture(key, body, info)
            graph, launches = entry
            for _ in range(times):
                graph.replay()
            hk.add_launches(launches, times)
