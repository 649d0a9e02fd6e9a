"""In-process message router with fault injection.

Plays the role of rafthttp for in-proc clusters: per-destination ordered
delivery, drop-don't-block (ref: etcdserver/raft.go:108-111 comment),
plus the fault hooks integration tests rely on (isolate/partition/drop —
ref: tests/framework/integration bridge + raft/rafttest/network.go).

Ports ``etcd_tpu/raftexample/transport.py`` whole.
"""

from __future__ import annotations

import queue
import random
import time
import threading
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..raft.types import Message, MessageType

MAX_PENDING = 4096


class InProcNetwork:
    def __init__(self, seed: int = 0) -> None:
        self._lock = threading.Lock()
        self._handlers: Dict[int, Callable[[Message], None]] = {}
        self._reporters: Dict[int, Callable[[int, bool], None]] = {}
        self._queues: Dict[int, "queue.Queue[Message]"] = {}
        self._pumps: Dict[int, threading.Thread] = {}
        self._isolated: Set[int] = set()
        self._dropped: Dict[Tuple[int, int], float] = {}
        # Directed-link latency injection: (from, to) -> (base_s, jitter_s)
        # (ref: functional DELAY_PEER_PORT_TX_RX cases, rpcpb/rpc.proto).
        self._delayed: Dict[Tuple[int, int], Tuple[float, float]] = {}
        # Per-link delivery-time floor keeping delayed links FIFO
        # (a TCP stream delays, it does not reorder).
        self._delay_floor: Dict[Tuple[int, int], float] = {}
        self._rand = random.Random(seed)
        self._stopped = False

    def register(self, node_id: int, handler: Callable[[Message], None],
                 reporter=None) -> None:
        """Attach a node; messages to `node_id` are pumped on a dedicated
        thread to preserve per-peer ordering without blocking senders.

        `reporter` (optional) receives snapshot delivery outcomes:
        ``reporter(to_id, failure: bool)`` — the in-proc analog of
        rafthttp's snapshot sender always reporting finish/failure to
        the sender's raft (ref: rafthttp/snapshot_sender.go:200,
        raft.go:1316-1331 MsgSnapStatus), which is what unsticks a
        StateSnapshot progress when the receiver crashes mid-install."""
        with self._lock:
            if self._stopped:
                return
            self._handlers[node_id] = handler
            if reporter is not None:
                self._reporters[node_id] = reporter
            if node_id not in self._queues:
                q: "queue.Queue[Message]" = queue.Queue(maxsize=MAX_PENDING)
                self._queues[node_id] = q
                t = threading.Thread(
                    target=self._pump, args=(node_id, q), daemon=True
                )
                self._pumps[node_id] = t
                t.start()

    def unregister(self, node_id: int) -> None:
        with self._lock:
            self._handlers.pop(node_id, None)
            self._reporters.pop(node_id, None)

    def _report_snap(self, m: Message, failure: bool) -> None:
        """Tell the sender's raft how its MsgSnap delivery went."""
        if m.type != MessageType.MsgSnap:
            return
        with self._lock:
            rep = self._reporters.get(m.from_)
        if rep is not None:
            try:
                rep(m.to, failure)
            except Exception:  # noqa: BLE001 — sender may be stopping
                pass

    def send(self, from_id: int, msgs: List[Message]) -> None:
        for m in msgs:
            self._send_one(from_id, m)

    def _send_one(self, from_id: int, m: Message) -> None:
        with self._lock:
            if self._stopped:
                return
            drop = (
                from_id in self._isolated
                or m.to in self._isolated
                or self._rand.random() < self._dropped.get(
                    (from_id, m.to), 0.0)
            )
            delay_s = 0.0
            q = None
            if not drop:
                dly = self._delayed.get((from_id, m.to))
                if dly:
                    now = time.monotonic()
                    at = now + dly[0] + self._rand.random() * dly[1]
                    # FIFO floor: a later message never overtakes an
                    # earlier one on the same link, jitter or not.
                    key = (from_id, m.to)
                    at = max(at, self._delay_floor.get(key, 0.0))
                    self._delay_floor[key] = at
                    delay_s = at - now
                q = self._queues.get(m.to)
        if drop or q is None:
            self._report_snap(m, failure=True)
            return

        def put() -> None:
            try:
                q.put_nowait(m)  # drop, never block (rafthttp semantics)
            except queue.Full:
                self._report_snap(m, failure=True)

        if delay_s > 0:
            t = threading.Timer(delay_s, put)
            t.daemon = True
            t.start()
        else:
            put()

    def _pump(self, node_id: int, q: "queue.Queue[Message]") -> None:
        while True:
            m = q.get()
            if m is None:  # type: ignore[comparison-overlap]
                return
            with self._lock:
                h = self._handlers.get(node_id)
                stopped = self._stopped
            if stopped:
                return
            if h is None:
                self._report_snap(m, failure=True)
                continue
            try:
                h(m)
            except Exception:  # noqa: BLE001 — a dead node mustn't kill the pump
                self._report_snap(m, failure=True)
            else:
                self._report_snap(m, failure=False)

    # -- fault injection (ref: rafttest/network.go:33-46) ----------------------

    def isolate(self, node_id: int) -> None:
        with self._lock:
            self._isolated.add(node_id)

    def heal(self, node_id: Optional[int] = None) -> None:
        """Clear faults: all of them (no arg), or everything touching
        one member — isolation, drops, and delays alike."""
        with self._lock:
            if node_id is None:
                self._isolated.clear()
                self._dropped.clear()
                self._delayed.clear()
                self._delay_floor.clear()
            else:
                self._isolated.discard(node_id)
                for d in (self._dropped, self._delayed, self._delay_floor):
                    for k in [k for k in d if node_id in k]:
                        del d[k]

    def drop(self, from_id: int, to_id: int, prob: float) -> None:
        with self._lock:
            self._dropped[(from_id, to_id)] = prob

    def cut(self, a: int, b: int) -> None:
        self.drop(a, b, 1.0)
        self.drop(b, a, 1.0)

    def mend(self, a: int, b: int) -> None:
        with self._lock:
            self._dropped.pop((a, b), None)
            self._dropped.pop((b, a), None)

    def delay(self, from_id: int, to_id: int, base_s: float,
              jitter_s: float = 0.0) -> None:
        """Add latency (with jitter) to a directed link — the
        functional suite's delay-peer-traffic fault class."""
        with self._lock:
            self._delayed[(from_id, to_id)] = (base_s, jitter_s)

    def undelay(self, from_id: Optional[int] = None,
                to_id: Optional[int] = None) -> None:
        """Clear delays: everything (no args), every link touching
        from_id (one arg), or one directed link (both args)."""
        with self._lock:
            if from_id is None:
                self._delayed.clear()
                self._delay_floor.clear()
            elif to_id is None:
                for d in (self._delayed, self._delay_floor):
                    for k in [k for k in d if from_id in k]:
                        del d[k]
            else:
                self._delayed.pop((from_id, to_id), None)
                self._delay_floor.pop((from_id, to_id), None)

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            queues = list(self._queues.values())
        for q in queues:
            try:
                q.put_nowait(None)  # type: ignore[arg-type]
            except queue.Full:
                pass
