"""Host-facing wrapper around the batched round, in PyTorch.

Ports ``MultiRaftEngine`` of ``etcd_tpu/batched/engine.py``: it keeps
the full multi-group SoA state on one device (the GPU unless the caller
names another) and runs closed-loop rounds there (deliver → tick →
control → propose → emit → route). Entry payloads never touch the
device: the host keeps them keyed by (group, index), and the commit
watermarks drive payload application (ref:
server/etcdserver/raft.go:158-315).

The engine owns one buffer per state and inbox field for its lifetime,
and every entry point writes a round's results into those buffers. On a
CUDA device the closed loop (``run_rounds``, ``run_rounds_pipelined``)
is a CUDA graph of one round, its route and its plane accumulators,
captured on first use for each ``tick`` value and replayed once per
round: the counterpart of the JAX engine's ``lax.scan`` over donated
buffers. As with donation there, a field of ``engine.state`` read
before a round holds that round's result after it. On the CPU the loop
is eager.

An engine built with ``round_trace=True`` carries a round tracer
(``roundtrace.py``, ``engine.round_trace``): while one of its stretches
is on, the closed loop replays a traced variant of each round graph and
stamps its own calls.
"""

from __future__ import annotations

import contextlib
from collections import deque
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..analysis.sentinels import note_compile_key, round_guard
from ..obs.fleet import FleetLayout
from .compile_cache import enable_compile_cache
from .graph import RoundGraphs, device_work, storages, write_back
from .roundtrace import TRACED, UNTRACED, RoundTracer
from .state import LEADER, BatchedConfig, I32, init_state, resolve_device
from .step import (NUM_KINDS, ROUND_PHASE_SCOPES, empty_msgs, make_step_round,
                   route_view)
from .telemetry import NUM_COUNTERS


def _host(x: torch.Tensor) -> np.ndarray:
    """A numpy copy of a device tensor (never a view of an engine
    buffer, which later rounds overwrite)."""
    return x.to("cpu", copy=True).numpy()


ROUTE_SCOPE = dict(ROUND_PHASE_SCOPES)["route"]


class MultiRaftEngine:
    def __init__(self, cfg: BatchedConfig, start_index: int = 0,
                 device=None, round_trace: bool = False):
        # deliver_shape="auto" resolves here, so self.cfg names the
        # concrete shape the round runs.
        self.cfg = cfg = cfg.validate().resolved()
        self.device = dev = resolve_device(device)
        # The native builds' directory (batched/compile_cache.py).
        enable_compile_cache()
        self.state = init_state(cfg, start_index, device=dev)
        self.inbox = empty_msgs(
            (cfg.num_instances, cfg.num_replicas, NUM_KINDS),
            cfg.max_ents_per_msg, narrow=cfg.narrow_lanes, device=dev)
        self._step = make_step_round(cfg, device=dev)
        n = cfg.num_instances
        self._zeros_b = torch.zeros((n,), dtype=torch.bool, device=dev)
        self._ones_b = torch.ones((n,), dtype=torch.bool, device=dev)
        self._zeros_i = torch.zeros((n,), dtype=I32, device=dev)
        # The proposal counts the captured round reads.
        self._props = torch.zeros((n,), dtype=I32, device=dev)
        # The round tracer: on CUDA, building it builds and loads the
        # mark library. An engine built for it reads the tick mask of its
        # graphed rounds from a buffer (_replay).
        self.round_trace = None
        if round_trace:
            self.round_trace = RoundTracer(cfg, self.state, self._props, dev)
            self._ticks = torch.zeros((n,), dtype=torch.bool, device=dev)
            self._tick_now = False
        # Step outputs past (state, outbox): telemetry, then the fleet
        # frame (the engine's step has no aux).
        self._tel_pos = 2
        self._fleet_pos = 2 + int(cfg.telemetry)
        # Telemetry accumulator: per-instance counter totals and the
        # OR of the invariant bitmaps, since construction.
        if cfg.telemetry:
            self._tel_counters = torch.zeros((n, NUM_COUNTERS), dtype=I32,
                                             device=dev)
            self._tel_invariants = torch.zeros((n,), dtype=I32, device=dev)
        self.telemetry_hub = None
        # Fleet accumulator: one [L] int32 frame whose delta fields
        # (the layout's sum mask) add across rounds and whose snapshot
        # fields keep the latest round's. Its delta fields would wrap
        # int32 after about 2^31/N rounds, so drain_fleet banks them
        # into the int64 host base and zeroes them on the device.
        if cfg.fleet_summary:
            self._fleet_layout = FleetLayout(n, cfg.num_replicas,
                                             cfg.num_groups)
            self._fleet_vec = torch.zeros((self._fleet_layout.size,),
                                          dtype=I32, device=dev)
            self._fleet_sum_np = self._fleet_layout.sum_mask()
            self._fleet_summask = torch.as_tensor(self._fleet_sum_np,
                                                  device=dev)
            self._fleet_base = np.zeros(self._fleet_layout.size, np.int64)
        self.fleet_hub = None
        # The storages of the buffers a round's results go into.
        self._storages = storages(tuple(self.state) + tuple(self.inbox))
        # One CUDA graph of the closed-loop round per tick value.
        self._graphs = RoundGraphs(f"engine|{cfg}")
        note_compile_key("closed_loop", f"{cfg}")
        self.rounds = 0  # rounds stepped since construction

    @property
    def captures(self) -> int:
        """CUDA graphs captured by this engine."""
        return self._graphs.captures

    @property
    def capture_stats(self) -> list:
        """Per capture: tick, seconds."""
        return self._graphs.capture_stats

    # -- one round -----------------------------------------------------------

    def _round(self, ticks, campaign_mask, propose_n, isolate,
               transfer_to=None, read_req=None, rt=None) -> None:
        """Step, accumulate the planes and route, writing every result
        into the engine's buffers; with a tracer `rt`, between the
        round's marks and followed by its lifecycle record."""
        if rt is not None:
            rt.begin_round()
        args = (self.state, self.inbox, ticks, campaign_mask, propose_n,
                isolate, transfer_to, read_req)
        out = self._step(*args) if rt is None else self._step(*args,
                                                              mark=rt.mark)
        st, outbox = out[:2]
        if self.cfg.telemetry:
            frame = out[self._tel_pos]
            self._tel_counters.add_(frame.counters)
            self._tel_invariants.bitwise_or_(frame.invariants)
        if self.cfg.fleet_summary:
            fv = out[self._fleet_pos]
            self._fleet_vec.copy_(torch.where(
                self._fleet_summask, self._fleet_vec + fv, fv))
        if rt is not None:
            rt.mark("outbox")
        self._write_back(st, outbox)
        if rt is not None:
            rt.end_round()

    def _write_back(self, st, outbox) -> None:
        """Copy a round's state into the state buffers and route its
        outbox into the inbox buffers, one copy per field
        (graph.write_back)."""
        pairs = list(zip(self.state, st, strict=True))
        with record_function(ROUTE_SCOPE):
            for buf, x in zip(self.inbox, outbox, strict=True):
                routed = route_view(self.cfg, x)
                pairs.append((buf.view(routed.shape), routed))
            write_back(pairs, self._storages)

    # -- driving -------------------------------------------------------------

    def step_round(
        self,
        tick: bool = False,
        campaign_mask: Optional[torch.Tensor] = None,
        propose_n: Optional[torch.Tensor] = None,
        isolate: Optional[torch.Tensor] = None,
        transfer_to: Optional[torch.Tensor] = None,
        read_req: Optional[torch.Tensor] = None,
    ) -> None:
        """One eager round: deliver pending messages, optionally tick
        every instance, run host control ops (leader transfer,
        ReadIndex), append proposals on leaders, route the outbox.
        `isolate` cuts instances off the network for this round. Every
        round after the engine's first runs under the sync guard
        (analysis.sentinels.round_guard): the first loads the kernels
        and makes the constant tables."""
        with (round_guard(self.device) if self.rounds > 0
              else contextlib.nullcontext()):
            self._round(
                self._ones_b if tick else self._zeros_b,
                self._zeros_b if campaign_mask is None else campaign_mask,
                self._zeros_i if propose_n is None else propose_n,
                self._zeros_b if isolate is None else isolate,
                transfer_to, read_req,
            )
        self.rounds += 1

    def _set_props(self, propose_n: Optional[torch.Tensor]) -> None:
        if propose_n is None:
            self._props.zero_()
        else:
            self._props.copy_(propose_n)

    def _replay(self, rounds: int, tick: bool, span=None) -> None:
        """`rounds` closed-loop rounds through the graph for `tick`, on
        the current stream, with no host sync (graph.RoundGraphs.run:
        the first use of a tick value runs one eager round, then
        captures; its replays run under the sync guard)."""
        if rounds <= 0:
            return
        if self.round_trace is None:
            ticks = self._ones_b if tick else self._zeros_b
            self._graphs.run(tick, lambda: self._round(
                ticks, self._zeros_b, self._props, self._zeros_b), rounds,
                tick=tick)
        else:
            self._replay_traceable(rounds, tick, span)
        self.rounds += rounds

    def _replay_traceable(self, rounds: int, tick: bool, span) -> None:
        """_replay for an engine built for tracing. It holds two graphs,
        one a variant (UNTRACED, TRACED), both captured in its first call
        so that a stretch captures nothing, and each reads the tick mask
        from a buffer: a graph a variant and a tick value would be four
        graphs of the round, and with four (as with two copies of each
        tick value's graph) replays on the card ran ~0.9 ms a round
        slower in about half the processes. With a `span` (a traced
        stretch is on), traced rounds one replay at a time, each stamped
        into the span; on the CPU, eager ones."""
        if tick != self._tick_now:
            self._ticks.copy_(self._ones_b if tick else self._zeros_b)
            self._tick_now = tick

        def body(rt):
            return lambda: self._round(self._ticks, self._zeros_b,
                                       self._props, self._zeros_b, rt=rt)

        rt = self.round_trace
        cuda = self.device.type == "cuda"
        if span is None:
            self._graphs.run(UNTRACED, body(None), rounds, traced=False)
            self._graphs.prepare(TRACED, body(rt), traced=True)
            return
        traced = body(rt)
        with device_work():
            span.lock_held()
            for _ in range(rounds):
                span.replay_begin()
                if cuda:
                    self._graphs.run(TRACED, traced, 1, traced=True)
                else:
                    traced()
                span.replay_end()
        if cuda:
            self._graphs.prepare(UNTRACED, body(None), traced=False)

    def _span(self):
        """A span for this call while a traced stretch is on, else None."""
        rt = self.round_trace
        return None if rt is None else rt.open_span()

    def run_rounds(self, rounds: int, tick: bool = True,
                   propose_n: Optional[torch.Tensor] = None) -> None:
        """Closed-loop simulation of `rounds` rounds with no host sync:
        on CUDA, replays of the captured round; on the CPU, eager
        rounds."""
        span = self._span()
        cuda = self.device.type == "cuda"
        if not cuda and span is None:
            for _ in range(rounds):
                self.step_round(tick=tick, propose_n=propose_n)
            return
        with torch.cuda.device(self.device) if cuda \
                else contextlib.nullcontext():
            self._set_props(propose_n)
            if span is not None:
                span.props_copied()
            self._replay(rounds, tick, span)
        if span is not None:
            self.round_trace.close_span(span)

    def run_rounds_pipelined(self, rounds: int, chunk: int = 16,
                             depth: int = 2, tick: bool = True,
                             propose_n: Optional[torch.Tensor] = None
                             ) -> None:
        """`rounds` closed-loop rounds enqueued in chunks of `chunk`,
        with at most `depth` chunks in flight: each chunk records a CUDA
        event as its fence, and the host waits on the oldest fence when
        more are in flight. The last chunks are left in flight; a caller
        that needs them done synchronizes as usual. On the CPU, the
        serial loop."""
        if rounds <= 0:
            return
        if chunk <= 0:
            # A non-positive chunk would never advance: a host hang.
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        if self.device.type != "cuda":
            self.run_rounds(rounds, tick=tick, propose_n=propose_n)
            return
        span = self._span()
        with torch.cuda.device(self.device):
            self._set_props(propose_n)
            if span is not None:
                span.props_copied()
            fences: deque = deque()
            done = 0
            while done < rounds:
                n = min(chunk, rounds - done)
                self._replay(n, tick, span)
                done += n
                fence = torch.cuda.Event()
                fence.record()
                fences.append(fence)
                while len(fences) > depth:
                    # jitlint: waive(sync-in-loop) -- the sync IS the pipelining contract: wait on the oldest chunk's fence to bound the chunks in flight at `depth`
                    fences.popleft().synchronize()
        if span is not None:
            self.round_trace.close_span(span)

    def _mask(self, instance_ids, value, like):
        idx = torch.as_tensor(np.asarray(instance_ids, np.int64),
                              device=self.device)
        return like.clone().index_fill_(0, idx, value)

    def campaign(self, instance_ids) -> None:
        self.step_round(campaign_mask=self._mask(instance_ids, True,
                                                 self._zeros_b))

    def transfer_leader(self, leader_instance: int, target_slot: int) -> None:
        """Ask the leader instance to hand leadership to target_slot
        (ref: raft.go:1339 MsgTransferLeader on the leader)."""
        self.step_round(transfer_to=self._mask(
            [leader_instance], target_slot + 1, self._zeros_i))

    def read_index(self, instance_ids) -> None:
        """Open a ReadIndex batch on the given leader instances
        (ref: v3_server.go sendReadIndex → MsgReadIndex)."""
        self.step_round(read_req=self._mask(instance_ids, True,
                                            self._zeros_b))

    def read_states(self) -> "tuple[np.ndarray, np.ndarray, np.ndarray]":
        """(seq, index, ready) per instance — the ReadState watermarks
        (ref: read_only.go advance → Ready.ReadStates)."""
        st = self.state
        return (_host(st.read_seq), _host(st.read_index),
                _host(st.read_ready))

    def set_membership(self, group: int, voters, voters_out=(),
                       learners=(), joint: bool = False) -> None:
        """Write new membership masks into every replica row of `group`
        — the confchange apply point (ref: confchange/confchange.go)."""
        r = self.cfg.num_replicas
        rows = slice(group * r, (group + 1) * r)
        st = self.state
        for name, slots in (("voter", voters), ("voter_out", voters_out),
                            ("learner", learners)):
            m = torch.zeros((r,), dtype=torch.bool, device=self.device)
            m[list(slots)] = True
            getattr(st, name)[rows] = m
        st.in_joint[rows] = bool(joint)

    # -- telemetry (device → host gathers; cfg.telemetry only) ---------------

    def telemetry(self) -> "tuple[np.ndarray, np.ndarray]":
        """(counters [N, NUM_COUNTERS], invariants [N]): per-instance
        totals accumulated on the device since construction (column
        order: telemetry.TM_NAMES). One host gather."""
        if not self.cfg.telemetry:
            raise RuntimeError("engine built with telemetry=False")
        return _host(self._tel_counters), _host(self._tel_invariants)

    def drain_telemetry(self, hub=None) -> "tuple[np.ndarray, np.ndarray]":
        """Fold the accumulated totals into `hub` (or the attached
        ``telemetry_hub``), any object with ``ingest_totals(counters,
        invariants)``; returns the fetched (counters, invariants)."""
        counters, inv = self.telemetry()
        hub = hub or self.telemetry_hub
        if hub is not None:
            hub.ingest_totals(counters, inv)
        return counters, inv

    # -- fleet summary (device → host gathers; cfg.fleet_summary only) -------

    def _fleet_totals(self) -> "tuple[np.ndarray, np.ndarray]":
        if not self.cfg.fleet_summary:
            raise RuntimeError("engine built with fleet_summary=False")
        dev = _host(self._fleet_vec).astype(np.int64)
        return dev, np.where(self._fleet_sum_np, self._fleet_base + dev, dev)

    def fleet_frame(self) -> np.ndarray:
        """The accumulated [L] frame (obs/fleet.FleetLayout order,
        int64): delta fields are sums across rounds (the device window
        plus the drained int64 base), snapshot fields hold the last
        round's census and top-k. One host gather."""
        return self._fleet_totals()[1]

    def drain_fleet(self, hub=None) -> np.ndarray:
        """Fold the accumulated frame into `hub` (or the attached
        ``fleet_hub``), any object with ``ingest_totals(vec)``, then bank
        the device window's sums into the int64 base and zero them on
        the device, in place (the captured round adds into that
        buffer); returns the fetched vector."""
        dev, vec = self._fleet_totals()
        hub = hub or self.fleet_hub
        if hub is not None:
            hub.ingest_totals(vec)
        self._fleet_base += np.where(self._fleet_sum_np, dev, 0)
        self._fleet_vec.masked_fill_(self._fleet_summask, 0)
        return vec

    # -- observation (device → host gathers) ---------------------------------

    def _per_group(self, x: torch.Tensor) -> np.ndarray:
        return _host(x).reshape(self.cfg.num_groups, self.cfg.num_replicas)

    def leaders(self) -> np.ndarray:
        """Per group: leader replica slot, or -1."""
        is_lead = self._per_group(self.state.role) == LEADER
        return np.where(is_lead.any(axis=1), is_lead.argmax(axis=1), -1)

    def commits(self) -> np.ndarray:
        """Per-instance commit watermarks [G, R]."""
        return self._per_group(self.state.commit)

    def terms(self) -> np.ndarray:
        return self._per_group(self.state.term)
