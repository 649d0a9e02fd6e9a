"""The benchmark's loop around the system under test: set-up, a
warm-up, the measured window and a drain, with what the correctness
check and the latency resolution need recorded on the device.

The system under test is ``etcd_tpu_torch.batched.MultiRaftEngine``
(any object with its ``state``, ``campaign``,
``run_rounds``, ``step_round`` and ``captures`` will do: the control
and the fault tests put others in its place). Each round is one
``run_rounds(1, tick=…, propose_n=…)`` call, which replays the engine's
captured round graph on CUDA. Around it the loop, with its own torch
ops on the same stream and no host sync:

* offers each group's leader (slot 0) its proposals (traffic.py);
* records the offered counts of the sampled groups, every leader's
  commit watermark after the round, and a CUDA event that ends it;
* counts, over every group, rounds that break a guarantee: a commit
  beyond what a majority of the group's replicas hold, a commit that
  goes back, a leader that accepts more than it was offered or whose
  log shrinks;
* every ``checkpoint_every`` rounds, copies the sampled groups' rows of
  the state fields that the reference is compared on (check.py).

A round ticks when ``tick_s`` of host time has passed since the last
tick. At most ``in_flight_rounds`` rounds are enqueued ahead of the
device: the host waits on the event of the round that many back.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Callable, List, Optional

import torch
from torch.profiler import record_function

from . import check

CHUNK = 512  # rows of a recording block
DRAIN_MAX_S = 60.0  # the longest wait past the drain for due proposals
CHECK_EVERY = 32  # drain rounds between two looks at what has committed


class Rows:
    """Rows of a recording, [*, *shape], in blocks allocated ahead
    (set-up allocates what the window is expected to need; a block past
    that is allocated when first reached)."""

    def __init__(self, shape, dtype, device, rows: int,
                 pin: bool = False) -> None:
        self.shape, self.dtype, self.device = tuple(shape), dtype, device
        self.pin = pin
        self.blocks: List[torch.Tensor] = []
        self.reserve(rows)

    def reserve(self, rows: int) -> None:
        while len(self.blocks) * CHUNK < rows:
            self.blocks.append(torch.empty((CHUNK,) + self.shape,
                                           dtype=self.dtype,
                                           device=self.device,
                                           pin_memory=self.pin))

    def row(self, i: int) -> torch.Tensor:
        self.reserve(i + 1)
        return self.blocks[i // CHUNK][i % CHUNK]

    def stacked(self, n: int) -> torch.Tensor:
        """The first n rows as one tensor."""
        if n == 0:
            return torch.empty((0,) + self.shape, dtype=self.dtype,
                               device=self.device)
        return torch.cat(self.blocks)[:n] if len(self.blocks) > 1 \
            else self.blocks[0][:n]


class Clock:
    """The end of each round on the host's clock: a CUDA event a round,
    converted after the window through an anchor event recorded on an
    idle device; on the CPU (tests), where every op has finished when
    it returns, the host's clock itself. On CUDA each round also opens
    with an event, so that the device's wait between two rounds (the
    first's end to the second's start, both on the device's clock) can
    be read without a profiler."""

    def __init__(self, device: torch.device) -> None:
        self.cuda = device.type == "cuda"
        self.marks: list = []
        self.starts: list = []
        if self.cuda:
            torch.cuda.synchronize(device)
            self.anchor = torch.cuda.Event(enable_timing=True)
            self.anchor.record()
        self.anchor_host = time.perf_counter()

    def begin(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.starts.append(ev)

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def wait(self, i: int) -> None:
        """Block until round i has ended."""
        if self.cuda and i >= 0:
            self.marks[i].synchronize()

    def waits_ms(self, rounds) -> Optional[tuple]:
        """(the device's wait before each round i of `rounds` since the
        end of round i - 1, the time from that end to round i's end),
        summed, in ms; None on the CPU."""
        if not self.cuda:
            return None
        torch.cuda.synchronize()
        wait = span = 0.0
        for i in rounds:
            wait += self.marks[i - 1].elapsed_time(self.starts[i])
            span += self.marks[i - 1].elapsed_time(self.marks[i])
        return wait, span

    def host_times(self) -> List[float]:
        """Each round's end on the host's clock (perf_counter)."""
        if not self.cuda:
            return list(self.marks)
        torch.cuda.synchronize()
        return [self.anchor_host + self.anchor.elapsed_time(ev) / 1e3
                for ev in self.marks]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Loop:
    def __init__(self, eng, cfg_fields: dict, traffic, tick_s: float,
                 sample_groups: torch.Tensor, checkpoint_every: int,
                 in_flight: int, device: torch.device) -> None:
        self.eng, self.traffic, self.tick_s = eng, traffic, tick_s
        self.dev = device
        self.g = g = int(cfg_fields["num_groups"])
        self.r = r = int(cfg_fields["num_replicas"])
        self.quorum = r // 2 + 1
        self.in_flight = int(in_flight)
        self.every = int(checkpoint_every)
        st = eng.state
        self.lead_last = st.last[::r]
        self.lead_commit = st.commit[::r]
        self.props = torch.zeros((g * r,), dtype=torch.int32, device=device)
        self.props_lead = self.props[::r]
        self.sample = sample_groups.to(device)
        self.sample_rows = (self.sample.view(-1, 1) * r + torch.arange(
            r, device=device)).view(-1)
        self.last_before = torch.empty_like(self.lead_last)
        self.prev_commit = torch.empty_like(self.lead_commit)
        self.violations = torch.zeros((), dtype=torch.int64, device=device)
        self.ticks: List[bool] = []
        self.phase: List[str] = []
        self.enqueued: List[float] = []  # host clock at each round's offer
        self.replay_s: List[float] = []  # host time inside run_rounds
        self.hist = None

    # -- set-up ------------------------------------------------------------------

    def elect(self, max_rounds: int = 32, probe_rounds: int = 16) -> float:
        """Campaign on every group's slot 0, step rounds with no tick
        until every group has elected it, then one round with a tick
        (which captures its graph) and `probe_rounds` without; return
        the device's seconds a round over those. The reference runs
        this schedule (``setup_ticks``) to check the state it leaves."""
        eng, dev = self.eng, self.dev
        eng.campaign(range(0, self.g * self.r, self.r))
        ticks = []
        while not ticks or not bool((eng.leaders() == 0).all()):
            # Set-up reads the leaders each round (a host sync).
            if len(ticks) == max_rounds:
                raise RuntimeError("not every group elected slot 0 in "
                                   f"{max_rounds} rounds")
            eng.run_rounds(1, tick=False)
            ticks.append(False)
        eng.run_rounds(1, tick=True)
        sync(dev)
        t = time.perf_counter()
        eng.run_rounds(probe_rounds, tick=False)
        sync(dev)
        round_s = (time.perf_counter() - t) / probe_rounds
        self.setup_ticks = ticks + [True] + [False] * probe_rounds
        return round_s

    def start_recording(self, rounds: int) -> None:
        """Allocate the recordings for about `rounds` rounds, take the
        sampled groups' state as it stands (checkpoint 0), and start
        the round clock."""
        dev = self.dev
        self.base = self.lead_last.clone()
        self.commit0 = self.lead_commit.clone()
        self.prev_commit.copy_(self.lead_commit)
        self.hist = Rows((self.g,), torch.int32, dev, rounds)
        self.rec_props = Rows((self.sample.numel(),), torch.int32, dev,
                              rounds)
        self.now_dev = Rows((), torch.float32, dev, rounds)
        # Pinned, so that each round's copy to the device is
        # asynchronous; a slot a round, never written twice.
        self.now_host = (Rows((), torch.float32, "cpu", rounds, pin=True)
                         if dev.type == "cuda" else None)
        fields = self._fields()
        n_ck = rounds // self.every + 2
        self.ck = {name: Rows((self.sample_rows.numel(),) + x.shape[1:],
                              x.dtype, dev, n_ck)
                   for name, x in fields.items()}
        self.n_ck = 0
        self._checkpoint()
        self.clock = Clock(dev)
        self.t0 = math.inf  # the window's start, once warm-up is done
        self.last_tick = -math.inf

    def _fields(self) -> dict:
        st = self.eng.state
        return {k: getattr(st, k) for k in check.FIELDS}

    def _checkpoint(self) -> None:
        for name, x in self._fields().items():
            torch.index_select(x, 0, self.sample_rows,
                               out=self.ck[name].row(self.n_ck))
        self.n_ck += 1

    # -- rounds ------------------------------------------------------------------

    def round(self, phase: str, offer: bool = True) -> None:
        i = len(self.ticks)
        now = time.perf_counter()
        tick = now - self.last_tick >= self.tick_s
        if tick:
            self.last_tick = now
        rel = now - self.t0  # -inf in warm-up
        self.clock.begin()
        if self.now_host is not None:
            slot = self.now_host.row(i)
            slot.fill_(rel)
            self.now_dev.row(i).copy_(slot, non_blocking=True)
        else:
            self.now_dev.row(i).fill_(rel)
        with record_function("portbench.offer"):
            if offer:
                self.traffic.offer(self, i, rel)
            else:
                self.props_lead.zero_()
            torch.index_select(self.props_lead, 0, self.sample,
                               out=self.rec_props.row(i))
            self.last_before.copy_(self.lead_last)
        t = time.perf_counter()
        with record_function("portbench.round"):
            self.eng.run_rounds(1, tick=tick, propose_n=self.props)
        self.replay_s.append(time.perf_counter() - t)
        with record_function("portbench.record"):
            self.hist.row(i).copy_(self.lead_commit)
            self._guard()
            if (i + 1) % self.every == 0:
                self._checkpoint()
            self.clock.mark()
        self.ticks.append(tick)
        self.phase.append(phase)
        self.enqueued.append(now)
        with record_function("portbench.fence"):
            self.clock.wait(i - self.in_flight)

    def _guard(self) -> None:
        """Count the groups whose round broke a guarantee (module
        docstring)."""
        r, q = self.r, self.quorum
        held = self.eng.state.last.view(self.g, r).sort(dim=1).values[:, r - q]
        bad = ((self.lead_commit > held)
               | (self.lead_commit < self.prev_commit)
               | (self.lead_last < self.last_before)
               | (self.lead_last - self.last_before > self.props_lead))
        self.violations.add_(bad.sum())
        self.prev_commit.copy_(self.lead_commit)

    @property
    def rounds(self) -> int:
        return len(self.ticks)

    def run(self, warm_rounds: int, seconds: float, drain_s: float,
            trace_rounds: int = 0,
            on_trace: Optional[Callable] = None) -> None:
        """Warm up, then the window of `seconds`, then the drain. With
        `trace_rounds`, `on_trace(body, first=round)` runs that many of
        the window's rounds inside the profiler, from a quarter, a half
        and three quarters of the window on."""
        # No collection pauses the host inside the rounds.
        gc.collect()
        gc.disable()
        try:
            self._run(warm_rounds, seconds, drain_s, trace_rounds, on_trace)
        finally:
            gc.enable()

    def _run(self, warm_rounds, seconds, drain_s, trace_rounds, on_trace):
        loaded = self.traffic.loaded_warm_up
        for _ in range(warm_rounds):
            self.round("warm", offer=loaded)
        sync(self.dev)
        self.t0 = time.perf_counter()
        self.warm_rounds = self.rounds
        end = self.t0 + seconds
        marks = [self.t0 + seconds * f for f in (0.25, 0.5, 0.75)] \
            if trace_rounds > 0 else []
        while time.perf_counter() < end:
            if marks and time.perf_counter() >= marks[0]:
                marks.pop(0)

                def body():
                    for _ in range(trace_rounds):
                        self.round("window")
                on_trace(body, first=self.rounds)
                continue
            self.round("window")
        self.window_rounds = self.rounds
        drain_end = time.perf_counter() + drain_s
        while time.perf_counter() < drain_end:
            self.round("drain")
        # Past the drain, rounds go on until every proposal due in the
        # window has committed, DRAIN_MAX_S at most: one that commits
        # late is late, not lost.
        due = self.traffic.due
        if due is not None:
            in_window = (due < seconds).sum(1)
            give_up = drain_end + DRAIN_MAX_S
            while time.perf_counter() < give_up and not bool(
                    (self.lead_commit - self.base >= in_window).all()):
                for _ in range(CHECK_EVERY):
                    self.round("drain")
        sync(self.dev)
        # The state after the last round.
        if self.rounds % self.every:
            self._checkpoint()

    def checkpoints(self) -> dict:
        """Each field's checkpoints, [n_ck, rows, ...]: rounds 0,
        every, 2*every, ... and the last round."""
        return {name: rows.stacked(self.n_ck) for name, rows in self.ck.items()}

    def round_ends(self) -> torch.Tensor:
        """Each round's end on the host's clock, seconds from the
        window's start (float64)."""
        return torch.tensor(self.clock.host_times(), dtype=torch.float64) \
            - self.t0

