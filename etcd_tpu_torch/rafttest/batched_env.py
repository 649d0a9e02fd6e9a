"""Replay interaction scripts through the port's BATCHED NODE, asserting
state equivalence against the port's scalar core at every directive
boundary.

Ports ``etcd_tpu/rafttest/batched_env.py``, over the port's
``batched/node.py`` ``BatchedNode``: each trace node is one node whose
round is the port's device round (on CUDA, one replay of its rawnode's
CUDA graph), so a replay launches both Hopper kernels at the trace's
replica capacity R, a W = 64 ring, and ring lookups at K = 1, R, 8 and
8R.

Why state parity and not textual parity: a script's expected text
encodes two things beyond consensus semantics —

1. the reference's internal LOG LINES (``INFO 1 became leader...``),
   emitted at exact points inside raft.go step functions. The device
   round has no logger, and synthesizing the ~30 distinct formats from
   state deltas would test the synthesizer, not the round (the scalar
   core already reproduces them byte-for-byte — ``interaction.py``);
2. the reference's READY BOUNDARIES: one logical transition is split
   across several Readys by rawnode.go's scheduling. The batched round
   fuses deliver→tick→propose→emit into one device round; making it
   reproduce Go's Ready splits would mean re-implementing rawnode.go's
   scheduler around the kernels.

So the parity chain is: expected text ≡ scalar core text (byte for
byte) AND scalar core state ≡ batched node state after EVERY directive
of every script (this module): term, vote, commit, role, lead, last
index, log floor, per-index entry terms, and the applied state machine
(the appender history's index/term/content and conf state).

Differences from the JAX package's env, by design:

* ``BatchedInteractionEnv(capacity, device=None)`` places every node on
  the GPU unless the caller names another device
  (``batched/state.resolve_device``; without CUDA and with no device
  named it raises), and ``_add_nodes`` passes that device to each
  ``BatchedNode``;
* ``close()`` (a definition the reference does not have) stops every
  node (``BatchedNode.stop()``) and drops them, so their CUDA graphs are
  freed under the process-wide device lock (``graph.device_work``).

``state_divergences`` reads the rawnode's host mirrors (``m_*``, numpy,
set at the end of each round), never a device tensor.

ref: raft/interaction_test.go:24-38, rafttest/interaction_env.go.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..batched.node import BatchedNode, ProposalDroppedError
from ..batched.state import resolve_device
from ..raft.confchange import ConfChangeError
from ..raft.errors import RaftError
from ..raft.types import (
    ConfChange,
    ConfChangeTransition,
    ConfChangeV2,
    ConfState,
    EntryType,
    Message,
    MessageType,
    Snapshot,
    SnapshotMetadata,
    conf_changes_from_string,
)
from .datadriven import TestData


class _BNode:
    """One trace node: a BatchedNode plus the env-side app state the
    oracle's InteractionEnv keeps (appender history) and the buffered
    Readys between eager device rounds and trace process-ready."""

    def __init__(self, node: BatchedNode, history: List[Snapshot]):
        self.node = node
        self.history = history
        self.readys: List = []  # translated Readys awaiting process-ready


class BatchedInteractionEnv:
    """Directive-for-directive twin of rafttest's InteractionEnv over
    the batched device engine (state-parity harness; see module doc).

    ``capacity`` (R) must cover every node the trace will add — the
    batched layout compiles replica capacity as a static shape
    (membership is masks, capacity is not; ref: BatchedNode docstring).
    """

    def __init__(self, capacity: int, device=None):
        self.capacity = capacity
        self.device = resolve_device(device)
        self.nodes: List[_BNode] = []
        self.messages: List[Message] = []  # in-flight, like env.messages

    def close(self) -> None:
        """Stop every node and drop them: their CUDA graphs are freed
        under the device lock (graph.RoundGraphs.__del__)."""
        for bn in self.nodes:
            bn.node.stop()
        self.nodes = []
        self.messages = []

    # -- directive dispatch ----------------------------------------------------

    def handle(self, d: TestData) -> None:
        handler = {
            "_breakpoint": lambda d: None,
            "log-level": lambda d: None,  # text-only directive
            "raft-log": lambda d: None,  # read-only (oracle renders)
            "raft-state": lambda d: None,
            "status": lambda d: None,
            "add-nodes": self._add_nodes,
            "campaign": self._campaign,
            "compact": self._compact,
            "deliver-msgs": self._deliver_msgs,
            "process-ready": self._process_ready,
            "stabilize": self._stabilize,
            "tick-heartbeat": self._tick_heartbeat,
            "transfer-leadership": self._transfer_leadership,
            "propose": self._propose,
            "propose-conf-change": self._propose_conf_change,
        }.get(d.cmd)
        if handler is None:
            raise ValueError(f"unknown command {d.cmd}")
        try:
            handler(d)
        except (RaftError, ValueError):
            # The oracle renders these into the expected text; for
            # state parity the failed directive is a no-op.
            pass

    # -- node lifecycle --------------------------------------------------------

    def _add_nodes(self, d: TestData) -> None:
        n = int(d.cmd_args[0].key)
        cs = ConfState()
        index = 0
        data = b""
        for arg in d.cmd_args[1:]:
            for val in arg.vals:
                if arg.key == "voters":
                    cs.voters.append(int(val))
                elif arg.key == "learners":
                    cs.learners.append(int(val))
                elif arg.key == "index":
                    index = int(val)
                elif arg.key == "content":
                    data = val.encode()
        bootstrap = bool(data or index or cs.voters or cs.learners)
        from ..batched.rawnode import RowRestore

        for _ in range(n):
            node_id = 1 + len(self.nodes)
            restore = None
            if bootstrap:
                restore = RowRestore(
                    term=0, vote=0, commit=index, applied=index,
                    snap_index=index, snap_term=1,
                )
            node = BatchedNode(
                node_id,
                peers=list(range(1, self.capacity + 1)),
                election_tick=3,
                heartbeat_tick=1,
                window=64,
                max_ents_per_msg=8,
                max_props_per_round=4,
                pre_vote=False,  # default_raft_config has no prevote
                check_quorum=False,
                restore=restore,
                boot_conf_state=cs.clone(),
                capacity=self.capacity,
                device=self.device,
            )
            snap = Snapshot(
                data=data,
                metadata=SnapshotMetadata(
                    conf_state=cs.clone(), index=index,
                    term=1 if bootstrap else 0,
                ),
            )
            self.nodes.append(_BNode(node, [snap]))

    # -- directives ------------------------------------------------------------

    def _campaign(self, d: TestData) -> None:
        idx = int(d.cmd_args[0].key) - 1
        self.nodes[idx].node.campaign()
        self._drain(idx)

    def _compact(self, d: TestData) -> None:
        idx = int(d.cmd_args[0].key) - 1
        new_first = int(d.cmd_args[1].key)
        bn = self.nodes[idx]
        # Go's Storage.Compact(i) discards entries <= i; the device twin
        # moves the ring floor there, with the latest applied snapshot
        # available for any straggler (snapOverrideStorage semantics).
        bn.node.compact(new_first, bn.history[-1])

    def _deliver_msgs(self, d: TestData) -> None:
        recipients: List[Tuple[int, bool]] = []
        for arg in d.cmd_args:
            if not arg.vals:
                recipients.append((int(arg.key), False))
            elif arg.key == "drop":
                for val in arg.vals:
                    recipients.append((int(val), True))
        for rid, drop in recipients:
            msgs = [m for m in self.messages if m.to == rid]
            self.messages = [m for m in self.messages if m.to != rid]
            if drop:
                continue
            for m in msgs:
                self._step(rid - 1, m)
            self._drain(rid - 1)

    def _step(self, idx: int, m: Message) -> None:
        try:
            self.nodes[idx].node.step(m)
        except (RaftError, ProposalDroppedError):
            pass

    def _process_ready(self, d: TestData) -> None:
        for idx in self._node_idxs(d):
            self._flush_readys(idx)

    def _stabilize(self, d: TestData) -> None:
        idxs = self._node_idxs(d) or list(range(len(self.nodes)))
        ids = [i + 1 for i in idxs]
        while True:
            done = True
            for idx in idxs:
                self._drain(idx)
                if self.nodes[idx].readys:
                    done = False
                    self._flush_readys(idx)
            for idx in idxs:
                nid = idx + 1
                if any(m.to == nid for m in self.messages):
                    done = False
                    msgs = [m for m in self.messages if m.to == nid]
                    self.messages = [
                        m for m in self.messages if m.to != nid
                    ]
                    for m in msgs:
                        self._step(idx, m)
                    self._drain(idx)
            # Messages addressed to nodes outside the stabilize set
            # stay in flight (the oracle behaves the same way).
            if done and not any(
                self.nodes[i].readys for i in idxs
            ) and not any(m.to in ids for m in self.messages):
                return

    def _tick_heartbeat(self, d: TestData) -> None:
        idx = int(d.cmd_args[0].key) - 1
        self.nodes[idx].node.tick()  # heartbeat_tick == 1
        self._drain(idx)

    def _transfer_leadership(self, d: TestData) -> None:
        from_id = to_id = 0
        for arg in d.cmd_args:
            if arg.key == "from":
                from_id = int(arg.vals[0])
            elif arg.key == "to":
                to_id = int(arg.vals[0])
        self.nodes[from_id - 1].node.transfer_leadership(from_id, to_id)
        self._drain(from_id - 1)

    def _propose(self, d: TestData) -> None:
        idx = int(d.cmd_args[0].key) - 1
        self.nodes[idx].node.propose(d.cmd_args[1].key.encode(),
                                     timeout=0.05)
        self._drain(idx)

    def _propose_conf_change(self, d: TestData) -> None:
        idx = int(d.cmd_args[0].key) - 1
        v1 = False
        transition = ConfChangeTransition.ConfChangeTransitionAuto
        for arg in d.cmd_args[1:]:
            for val in arg.vals:
                if arg.key == "v1":
                    v1 = val.lower() == "true"
                elif arg.key == "transition":
                    transition = {
                        "auto": ConfChangeTransition.ConfChangeTransitionAuto,
                        "implicit":
                            ConfChangeTransition.ConfChangeTransitionJointImplicit,
                        "explicit":
                            ConfChangeTransition.ConfChangeTransitionJointExplicit,
                    }[val]
        ccs = conf_changes_from_string(d.input)
        if v1:
            cc = ConfChange(type=ccs[0].type, node_id=ccs[0].node_id)
            self.nodes[idx].node.propose_conf_change(cc, timeout=0.05)
        else:
            cc2 = ConfChangeV2(transition=transition, changes=ccs)
            self.nodes[idx].node.propose_conf_change(cc2, timeout=0.05)
        self._drain(idx)

    # -- engine plumbing -------------------------------------------------------

    def _drain(self, idx: int) -> None:
        """Run device rounds until this node has no staged work,
        buffering the translated Readys for the trace's
        process-ready/stabilize directives to release.

        Committed entries apply AFTER the staged inbox fully drains —
        mirroring the oracle's ordering, where every in-flight message
        is stepped before process-ready applies (so e.g. two acks that
        commit past a self-removal all count under the pre-removal
        config, the exact scenario of confchange_v1_remove_leader.txt).
        Per-round apply would interleave mask uploads between messages
        the oracle steps as one batch."""
        bn = self.nodes[idx]
        pending: List = []
        progressed = True
        while progressed:
            progressed = False
            while bn.node.has_ready():
                rd = bn.node.ready(timeout=0)
                if rd is None:
                    break
                progressed = True
                pending.extend(rd.committed_entries)
                bn.readys.append(rd)
                bn.node.advance()
            if pending:
                self._apply_committed(bn, pending)
                pending = []
                progressed = True  # apply may poke/propose more work

    def _apply_committed(self, bn: _BNode, entries: List) -> None:
        """The env is the app: conf changes upload masks, every entry
        extends the appender history (process_ready.go:64-101).

        NB: an inbound snapshot install deliberately does NOT touch
        history — the reference env only appends History for committed
        entries, leaving a restored node's History at its boot state."""
        for ent in entries:
            update = b""
            cs: Optional[ConfState] = None
            # Conf-change application may raise (the traces include
            # deliberate error cases the oracle renders as text); the
            # entry still extends history with the prior config, like
            # the oracle's error path.
            if ent.type == EntryType.EntryConfChange:
                cc = ConfChange.unmarshal(ent.data)
                update = cc.context
                try:
                    cs = bn.node.apply_conf_change(cc)
                except (RaftError, ValueError, ConfChangeError):
                    cs = None
            elif ent.type == EntryType.EntryConfChangeV2:
                cc2 = ConfChangeV2.unmarshal(ent.data)
                update = cc2.context
                try:
                    cs = bn.node.apply_conf_change(cc2)
                except (RaftError, ValueError, ConfChangeError):
                    cs = None
            else:
                update = ent.data
            last = bn.history[-1]
            snap = Snapshot(data=last.data + update)
            snap.metadata.index = ent.index
            snap.metadata.term = ent.term
            snap.metadata.conf_state = (
                cs or last.metadata.conf_state
            ).clone()
            bn.history.append(snap)
        # The latest applied state backs outbound MsgSnap
        # (snapOverrideStorage: always the newest app snapshot).
        bn.node.set_app_snapshot(bn.history[-1])

    def _flush_readys(self, idx: int) -> None:
        """Trace-level process-ready: release buffered messages into
        the in-flight pool (persist/apply already happened at drain —
        the device engine is its own storage)."""
        bn = self.nodes[idx]
        self._drain(idx)
        for rd in bn.readys:
            self.messages.extend(rd.messages)
        bn.readys.clear()

    @staticmethod
    def _node_idxs(d: TestData) -> List[int]:
        return [int(a.key) - 1 for a in d.cmd_args if not a.vals]


# -- state comparison ----------------------------------------------------------


def state_divergences(oracle_env, batched_env: BatchedInteractionEnv,
                      check_conf: bool = True) -> List[str]:
    """Compare the host-oracle InteractionEnv and the batched env node
    by node; returns human-readable divergences (empty == parity)."""
    out: List[str] = []
    if len(oracle_env.nodes) != len(batched_env.nodes):
        return [
            f"node count: oracle={len(oracle_env.nodes)} "
            f"batched={len(batched_env.nodes)}"
        ]
    for i, (on, bn) in enumerate(zip(oracle_env.nodes, batched_env.nodes)):
        nid = i + 1
        r = on.rawnode.raft
        rn = bn.node.rn

        def chk(name: str, want, got) -> None:
            if want != got:
                out.append(
                    f"node {nid} {name}: oracle={want} batched={got}")

        chk("term", int(r.term), int(rn.m_term[0]))
        chk("vote", int(r.vote), int(rn.m_vote[0]))
        chk("commit", int(r.raft_log.committed), int(rn.m_commit[0]))
        chk("role", int(r.state.value), int(rn.m_role[0]))
        chk("lead", int(r.lead), int(rn.m_lead[0]))
        if check_conf:
            # A committed conf change applies at drain time in the
            # device env but at process-ready in the oracle; its
            # side-effect proposals (auto-leave) can transiently extend
            # the device log, so the log BOUNDS are a quiescent check.
            chk("last_index", int(r.raft_log.last_index()),
                int(rn.m_last[0]))
            chk("first_index", int(r.raft_log.first_index()),
                int(rn.m_snap[0]) + 1)
        # Entry terms over the shared visible window.
        lo = max(int(r.raft_log.first_index()), int(rn.m_snap[0]) + 1)
        hi = min(int(r.raft_log.last_index()), int(rn.m_last[0]))
        w = rn.cfg.window
        for idx2 in range(lo, hi + 1):
            want_t = int(r.raft_log.term(idx2))
            got_t = int(rn.m_ring[0, idx2 % w])
            if want_t != got_t:
                out.append(
                    f"node {nid} log[{idx2}].term: oracle={want_t} "
                    f"batched={got_t}")
        # Applied state machine (appender history) — compared only at
        # quiescent boundaries: the device env applies committed
        # entries at drain time, the oracle at process-ready.
        oh, bh = on.history[-1], bn.history[-1]
        if check_conf:
            chk("applied.index", oh.metadata.index, bh.metadata.index)
            chk("applied.data", oh.data, bh.data)
            chk("conf.voters", sorted(oh.metadata.conf_state.voters),
                sorted(bh.metadata.conf_state.voters))
            chk("conf.learners",
                sorted(oh.metadata.conf_state.learners),
                sorted(bh.metadata.conf_state.learners))
            chk("conf.voters_outgoing",
                sorted(oh.metadata.conf_state.voters_outgoing),
                sorted(bh.metadata.conf_state.voters_outgoing))
    return out
