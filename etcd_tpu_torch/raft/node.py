"""Async Node wrapper: the channel-based driver loop over RawNode
(ref: raft/node.go:126-207 Node interface, node.go:303-410 run loop).

The reference multiplexes Go channels (propc/recvc/confc/tickc/readyc/
advancec) in a select loop. The Python equivalent runs one event-loop
thread over a command deque + condition variable, preserving the
observable contract:

* proposals block the caller until accepted by the state machine, and
  are *deferred* (not dropped) while the group has no leader
  (node.go:305,348 — propc is nil until lead != None);
* at most one Ready is outstanding: the next Ready is only produced
  after Advance (node.go:316-327 readyc/advancec interlock);
* ticks never block the driver (buffered tickc, node.go:283,414) —
  they coalesce if the loop falls behind.

The batched node (batched/node.py) is the many-group analog of this
loop; this single-group Node is the plugin boundary etcdserver-style
hosts program against.

Ports ``etcd_tpu/raft/node.py`` whole. Its thread touches no device:
raftexample's ``"host"`` backend runs it beside its ticker and pump
threads without the batched path's device lock.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from .errors import RaftError
from .raft import NONE, Config
from .rawnode import RawNode, Ready, Status, marshal_conf_change
from .types import (
    ConfChange,
    ConfChangeType,
    ConfState,
    Entry,
    EntryType,
    HardState,
    Message,
    MessageType,
)
from .raft import is_local_msg, is_response_msg


class NodeStoppedError(RaftError):
    """ref: node.go ErrStopped."""


@dataclass
class Peer:
    """Initial cluster member for bootstrap (ref: raft/node.go:210-214)."""

    id: int = 0
    context: bytes = b""


def bootstrap(rn: RawNode, peers: List[Peer]) -> None:
    """Seed an empty Storage with a config describing the initial peers —
    appends one EntryConfChange per peer at term 1 and pre-commits them
    (ref: raft/bootstrap.go:30-80)."""
    if not peers:
        raise ValueError("must provide at least one peer to Bootstrap")
    if rn.raft.raft_log.storage.last_index() != 0:
        raise ValueError("can't bootstrap a nonempty Storage")
    rn.prev_hard_st = HardState()
    rn.raft.become_follower(1, NONE)
    ents: List[Entry] = []
    for i, peer in enumerate(peers):
        cc = ConfChange(
            type=ConfChangeType.ConfChangeAddNode,
            node_id=peer.id,
            context=peer.context,
        )
        ents.append(
            Entry(
                type=EntryType.EntryConfChange,
                term=1,
                index=i + 1,
                data=cc.marshal(),
            )
        )
    rn.raft.raft_log.append(ents)
    rn.raft.raft_log.committed = len(ents)
    for peer in peers:
        rn.raft.apply_conf_change(
            ConfChange(node_id=peer.id).as_v2()
        )


@dataclass
class _Prop:
    msg: Message
    done: threading.Event = field(default_factory=threading.Event)
    err: Optional[BaseException] = None


class Node:
    """Threaded driver over RawNode (ref: raft/node.go:116-124 node).

    Lifecycle: ``Node.start(cfg, peers)`` / ``Node.restart(cfg)`` spawn
    the loop thread; the host consumes ``ready()`` → persist/send →
    ``advance()``; ``stop()`` joins the thread.
    """

    def __init__(self, rn: RawNode):
        self.rn = rn
        self._cv = threading.Condition()
        self._cmds: deque = deque()  # _Prop | ("recv", m) | ("conf", cc, box) | ...
        self._props: deque = deque()  # deferred proposals (no leader yet)
        self._ready_q: deque = deque()  # at most 1 accepted Ready
        self._advance_pending: Optional[Ready] = None
        self._tick_count = 0  # coalesced pending ticks
        self._stopped = False
        self._thread = threading.Thread(target=self._run, daemon=True)

    # -- lifecycle -------------------------------------------------------------

    @staticmethod
    def start(config: Config, peers: List[Peer]) -> "Node":
        """ref: node.go:218-241 StartNode."""
        rn = RawNode(config)
        bootstrap(rn, peers)
        n = Node(rn)
        n._thread.start()
        return n

    @staticmethod
    def restart(config: Config) -> "Node":
        """Rejoin from Storage state; no peers passed
        (ref: node.go:244-249 RestartNode)."""
        rn = RawNode(config)
        n = Node(rn)
        n._thread.start()
        return n

    def stop(self) -> None:
        with self._cv:
            if self._stopped:
                return
            self._stopped = True
            self._cv.notify_all()
        self._thread.join()

    # -- input side ------------------------------------------------------------

    def tick(self) -> None:
        """Never blocks; coalesces under load (ref: node.go:414-422)."""
        with self._cv:
            if self._stopped:
                return
            self._tick_count += 1
            self._cv.notify_all()

    def campaign(self) -> None:
        self._step_wait(Message(type=MessageType.MsgHup), wait=False)

    def propose(self, data: bytes, timeout: Optional[float] = None) -> None:
        """Blocks until the proposal is stepped into the state machine
        (ref: node.go:424-426 Propose → stepWait)."""
        self._step_wait(
            Message(type=MessageType.MsgProp, entries=[Entry(data=data)]),
            wait=True,
            timeout=timeout,
        )

    def propose_conf_change(self, cc, timeout: Optional[float] = None) -> None:
        typ, data = marshal_conf_change(cc)
        self._step_wait(
            Message(type=MessageType.MsgProp, entries=[Entry(type=typ, data=data)]),
            wait=True,
            timeout=timeout,
        )

    def step(self, m: Message) -> None:
        """Feed a message from the network (ref: node.go:428-436; local
        messages are dropped there, not erred)."""
        if is_local_msg(m.type):
            return
        self._enqueue(("recv", m))

    def read_index(self, rctx: bytes) -> None:
        self._enqueue(
            ("recv", Message(type=MessageType.MsgReadIndex, entries=[Entry(data=rctx)]))
        )

    def transfer_leadership(self, lead: int, transferee: int) -> None:
        """ref: node.go:551-558."""
        self._enqueue(
            ("recv", Message(type=MessageType.MsgTransferLeader, from_=transferee, to=lead))
        )

    def report_unreachable(self, vid: int) -> None:
        self._enqueue(("recv", Message(type=MessageType.MsgUnreachable, from_=vid)))

    def report_snapshot(self, vid: int, failure: bool) -> None:
        self._enqueue(
            ("recv", Message(type=MessageType.MsgSnapStatus, from_=vid, reject=failure))
        )

    def apply_conf_change(self, cc) -> ConfState:
        """Synchronous round-trip through the loop thread
        (ref: node.go:503-514)."""
        box: dict = {}
        ev = threading.Event()
        self._enqueue(("conf", cc, box, ev))
        ev.wait()
        if "err" in box:
            raise box["err"]
        return box["cs"]

    def status(self) -> Status:
        box: dict = {}
        ev = threading.Event()
        self._enqueue(("status", box, ev))
        ev.wait()
        if "err" in box:
            raise box["err"]
        return box["status"]

    # -- output side -----------------------------------------------------------

    def ready(self, timeout: Optional[float] = None) -> Optional[Ready]:
        """Block for the next Ready; None on timeout or stop."""
        with self._cv:
            deadline = None
            while not self._ready_q and not self._stopped:
                if not self._cv.wait(timeout=timeout):
                    return None
            if self._ready_q:
                return self._ready_q.popleft()
            return None

    def has_ready(self) -> bool:
        with self._cv:
            return bool(self._ready_q)

    def advance(self) -> None:
        """ref: node.go:516-520 — allows the next Ready."""
        with self._cv:
            self._cmds.append(("advance",))
            self._cv.notify_all()

    # -- loop ------------------------------------------------------------------

    def _enqueue(self, cmd) -> None:
        with self._cv:
            if self._stopped:
                if cmd and isinstance(cmd, _Prop):
                    cmd.err = NodeStoppedError()
                    cmd.done.set()
                elif cmd and cmd[0] in ("conf", "status"):
                    cmd[-2]["err"] = NodeStoppedError()
                    cmd[-1].set()
                return
            self._cmds.append(cmd)
            self._cv.notify_all()

    def _step_wait(
        self, m: Message, wait: bool, timeout: Optional[float] = None
    ) -> None:
        """ref: node.go:464-501 stepWithWaitOption."""
        p = _Prop(msg=m)
        if m.type != MessageType.MsgProp:
            self._enqueue(("recv", m))
            return
        self._enqueue(p)
        if not wait:
            return
        if not p.done.wait(timeout=timeout):
            raise TimeoutError("proposal not accepted in time")
        if p.err is not None:
            raise p.err

    def _run(self) -> None:
        r = self.rn.raft
        lead = NONE
        while True:
            with self._cv:
                while (
                    not self._cmds
                    and self._tick_count == 0
                    and not self._stopped
                    and not (
                        self._advance_pending is None
                        and not self._ready_q
                        and self.rn.has_ready()
                    )
                    and not (self._props and r.lead != NONE)
                ):
                    self._cv.wait()
                if self._stopped:
                    self._fail_pending()
                    return
                cmds = list(self._cmds)
                self._cmds.clear()
                ticks = self._tick_count
                self._tick_count = 0
            for _ in range(ticks):
                self.rn.tick()
            # Leader-gate deferred proposals (ref: node.go:305-312: propc
            # is enabled only while there is a leader).
            if r.lead != NONE and self._props:
                cmds = list(self._props) + cmds
                self._props.clear()
            for cmd in cmds:
                self._handle(cmd)
            lead = r.lead
            # Produce the next Ready when the previous one is consumed.
            with self._cv:
                if (
                    self._advance_pending is None
                    and not self._ready_q
                    and self.rn.has_ready()
                ):
                    rd = self.rn.ready_without_accept()
                    self.rn.accept_ready(rd)
                    self._advance_pending = rd
                    self._ready_q.append(rd)
                    self._cv.notify_all()

    def _handle(self, cmd) -> None:
        r = self.rn.raft
        if isinstance(cmd, _Prop):
            if r.lead == NONE:
                self._props.append(cmd)  # defer until a leader exists
                return
            m = cmd.msg
            m.from_ = r.id
            try:
                r.step(m)
                cmd.done.set()
            except BaseException as e:  # noqa: BLE001 — surfaced to caller
                cmd.err = e
                cmd.done.set()
            return
        kind = cmd[0]
        if kind == "recv":
            m = cmd[1]
            # Filter unknown-peer responses (ref: node.go:356-360).
            if r.prs.progress.get(m.from_) is not None or not is_response_msg(m.type):
                try:
                    r.step(m)
                except RaftError:
                    pass
        elif kind == "conf":
            _, cc, box, ev = cmd
            try:
                box["cs"] = r.apply_conf_change(cc.as_v2())
            except BaseException as e:  # noqa: BLE001
                box["err"] = e
            ev.set()
        elif kind == "status":
            _, box, ev = cmd
            try:
                box["status"] = RawNode.status(self.rn)
            except BaseException as e:  # noqa: BLE001
                box["err"] = e
            ev.set()
        elif kind == "advance":
            if self._advance_pending is not None:
                self.rn.advance(self._advance_pending)
                self._advance_pending = None

    def _fail_pending(self) -> None:
        for cmd in list(self._cmds) + list(self._props):
            if isinstance(cmd, _Prop):
                cmd.err = NodeStoppedError()
                cmd.done.set()
            elif isinstance(cmd, tuple) and cmd[0] in ("conf", "status"):
                cmd[-2]["err"] = NodeStoppedError()
                cmd[-1].set()
        self._cmds.clear()
        self._props.clear()
