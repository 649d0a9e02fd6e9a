"""BatchedNode: the raft.Node plugin boundary served by the batched
round, in PyTorch.

Ports ``etcd_tpu/batched/node.py``. Hosts that drive a ``raft.Node``
(raftexample here; ref: the single raft-construction site in
server/etcdserver/bootstrap.go:473-536 and contrib/raftexample/raft.go:87)
construct a ``BatchedNode`` and run unchanged — same
Ready/persist/send/Advance cycle, same Message wire types — while the
consensus math runs in the device round of one ``BatchedRawNode`` row
(on CUDA, one replay of the rawnode's CUDA graph per ``ready()``).

Differences from the host Node, by design:
* proposals are forwarded to the leader host-side (the kernel has no
  MsgProp lane); with no known leader they are dropped, like the
  reference's ErrProposalDropped path (ref: raft/node.go:425-462);
* log compaction is host-controlled: the host calls ``compact(index)``
  after taking an app snapshot, which moves the device ring floor, and
  outbound MsgSnap messages carry that snapshot's data — keeping the
  floor and the app snapshot index equal by construction;
* conf changes ride the log as typed entries (types live in the host
  arena beside payloads); on apply, the host Changer computes the new
  config and stages voter/learner/joint masks for the device state.

Member ids (differences from the reference's node, which takes dense
ids 1..R only): the device addresses replicas by slot, and ``SlotMap``
turns etcd's member ids (64-bit hashes of the peer URLs) into slots at
this boundary alone. ``step`` and ``Ready.messages`` carry member ids,
so do ``HardState.vote``, ``SoftState.lead``, every ``ConfState``,
``status()`` and ``transfer_leadership``; the rawnode and the device stay
slot-indexed. At dense ids 1..R the map is the identity. A message
from a member this node has no slot for yet (the leader that a conf
change it has not applied added) gives the sender a slot, as the
reference's raft takes a message from any id; a restarted member's
vote keeps its member id whatever its configuration names.

Follower reads (a difference too): a follower's ``read_index`` sends
``MsgReadIndex`` to its leader and surfaces the leader's
``MsgReadIndexResp`` as a ``ReadState``; a leader joins a peer's
``MsgReadIndex`` to its device ReadIndex batch and answers the sender
when the batch is confirmed (ref: raft.go:1069 stepLeader, :1320-1333
stepFollower, :1737 responseToReadIndexReq). A scalar-core peer's
heartbeat context (its read request's bytes) rides the device as a
4-byte token and goes back in the response as the bytes it came as;
an append with more than ``max_ents_per_msg`` entries is staged as
consecutive appends of at most that many, and an append that continues
the one its sender has queued joins it up to that many entries (a
scalar-core leader sends one append a proposal, and a round takes one
message a sender: without the merge its backlog drained one proposal a
round; ROADMAP C18). A batched leader sends at most one append a round
to a follower, so between batched members the merge fires only where a
host holds a leader's appends of several rounds and delivers them
together, as the interaction harness does: the follower then acks once
where the JAX package's acks once per append (ROADMAP C23).

Threads: ``ready``/``advance``/``create_snapshot``/``compact`` run on one
thread (the host's Ready loop); ``tick``, ``propose``, ``step``,
``read_index`` and the conf-change calls may come from any thread and
only stage host-side inputs. No call reads a CUDA tensor outside the
round: ``create_snapshot`` prices a snapshot at the floor from the
round's host copy of ``snap_term``.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import replace
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..raft.confchange import (
    Changer, ConfChangeError, restore as cc_restore)
from ..raft.errors import RaftError
from ..raft.raft import SoftState, StateType
from ..raft.rawnode import BasicStatus, Ready, Status
from ..raft.read_only import ReadState
from ..raft.tracker import ProgressTracker
from ..raft.types import (
    ConfChange,
    ConfChangeV2,
    ConfState,
    Entry,
    EntryType,
    HardState,
    Message,
    MessageType,
    Snapshot,
    SnapshotMetadata,
)
from .msgblock import block_messages
from .rawnode import BatchedRawNode, RowRestore
from .state import BatchedConfig
from .step import T_APP, T_HB, T_HB_RESP, T_SNAP


class ProposalDroppedError(RaftError):
    """ref: raft.ErrProposalDropped."""


class SlotMap:
    """Member id <-> device slot of one node.

    The boot peers take slots 0.. in sorted id order (a joiner's own id
    aside: it takes the first slot after them, the one its boot peers
    give it). Any other id takes the first free slot when it needs one:
    a member that a conf change adds (in log order), a member that only
    the configuration names (in sorted id order), and a sender or a vote
    that this node's configuration does not name yet (the wire carries
    member ids, and the reference's raft steps a message from any id).
    When no slot is free, the lowest slot whose member is outside
    `keep` (the configuration, and the vote and leader the device names)
    passes to the newcomer; a member keeps its slot otherwise, so at
    dense ids 1..R the map is the identity. Members that apply the same
    log hold the same map. On restart the map is rebuilt from what the
    data dir holds: the boot peers, its snapshot's configuration and the
    committed conf changes of the log after it, in log order. It is the
    map the member had, but where members that the snapshot names beyond
    the boot peers joined out of id order (a configuration does not keep
    the order), or where a sender or vote took a slot ahead of its conf
    change. Slots are local to a node, so nothing on the wire sees the
    difference."""

    def __init__(self, peers, capacity: int, members=(),
                 self_id: int = 0, joiner: bool = False) -> None:
        self.capacity = capacity
        self.self_id = self_id
        self._slot: Dict[int, int] = {}
        self._id: Dict[int, int] = {}
        boot = sorted(p for p in peers if not (joiner and p == self_id))
        for slot, mid in enumerate(boot[:capacity]):
            self._bind(mid, slot)
        keep = (set(members) | {self_id}) - {0}
        for mid in sorted(keep - set(self._slot)):
            self.add(mid, keep)

    def _bind(self, mid: int, slot: int) -> None:
        self._slot[mid] = slot
        self._id[slot] = mid

    def add(self, mid: int, keep=()) -> int:
        """The slot of `mid`, giving it the first free one if it has
        none, else the lowest slot of a member outside `keep` (never this
        member's own); ValueError when neither is left."""
        if mid in self._slot:
            return self._slot[mid]
        slots = [s for s in range(self.capacity) if s not in self._id] or [
            s for s in sorted(self._id)
            if self._id[s] not in keep and self._id[s] != self.self_id]
        if not slots:
            raise ValueError(
                f"member {mid:x}: no free replica slot (capacity "
                f"R={self.capacity})")
        self._slot.pop(self._id.get(slots[0]), None)
        self._bind(mid, slots[0])
        return slots[0]

    def copy(self) -> "SlotMap":
        out = SlotMap((), self.capacity)
        out.self_id = self.self_id
        out._slot, out._id = dict(self._slot), dict(self._id)
        return out

    def slot(self, mid: int) -> Optional[int]:
        return self._slot.get(mid)

    def as_dict(self) -> Dict[int, int]:
        """{member id: slot}."""
        return dict(self._slot)

    def to_device(self, mid: int) -> Optional[int]:
        """A member id as the device's id (slot + 1); 0 stays 0 (none),
        None for an id without a slot."""
        if not mid:
            return 0
        slot = self._slot.get(mid)
        return None if slot is None else slot + 1

    def from_device(self, did: int) -> int:
        """The device's id (slot + 1) as a member id; 0 stays 0, and so
        does a slot that no member holds."""
        return self._id.get(did - 1, 0) if did else 0

    def slots(self, ids) -> List[int]:
        return [self._slot[m] for m in ids]


def _members(cs: ConfState) -> set:
    return set(cs.voters) | set(cs.voters_outgoing) | set(cs.learners)


def _changed(tracker: ProgressTracker, cc, last_index: int):
    """The configuration and progress that conf change `cc` makes of
    `tracker`'s, joint semantics included (ref: raft.go:896-905
    applyConfChange -> confchange.Changer)."""
    cc2 = cc.as_v2()
    changer = Changer(tracker=tracker, last_index=last_index)
    if cc2.leave_joint():
        return changer.leave_joint()
    auto_leave, use_joint = cc2.enter_joint()
    if use_joint:
        return changer.enter_joint(auto_leave, cc2.changes)
    return changer.simple(cc2.changes)


def _conf_state(cfg, prs) -> ConfState:
    tr = ProgressTracker(max_inflight=256)
    tr.config, tr.progress = cfg, prs
    return tr.conf_state()


def _boot_slots(sm: SlotMap, cs: ConfState, restore: RowRestore) -> SlotMap:
    """`sm`, built for configuration `cs`, after the committed conf
    changes of `restore`'s log in log order (the map that applying them
    gave this member before it stopped), then with a slot for the WAL's
    vote, which stands whatever the configuration names (a candidate
    that this member's log does not know yet): so no other candidate
    gets a vote in its term. ValueError when the vote finds no slot."""
    tr = ProgressTracker(max_inflight=256)
    if _members(cs):
        cc_restore(Changer(tr, 0), cs)
    for e in restore.entries:
        index, data = e[0], e[2]
        etype = e[3] if len(e) > 3 else int(EntryType.EntryNormal)
        if index > restore.commit:
            break
        if etype == EntryType.EntryConfChange and data:
            cc = ConfChange.unmarshal(data)
        elif etype == EntryType.EntryConfChangeV2:
            cc = ConfChangeV2.unmarshal(data)
        else:
            continue
        trial = sm.copy()
        try:
            cfg, prs = _changed(tr, cc, index)
            members = _members(_conf_state(cfg, prs))
            for c in cc.as_v2().changes:
                if c.node_id in members:
                    trial.add(c.node_id, members | {restore.vote})
        except (ConfChangeError, ValueError):
            continue  # its apply left the configuration as it was
        sm, tr.config, tr.progress = trial, cfg, prs
    if restore.vote:
        sm.add(restore.vote, _members(tr.conf_state()))
    return sm


# Heartbeat context tokens kept per sender (a scalar-core leader's read
# request bytes, staged on the device as 4-byte words).
_CTX_TOKENS = 1024


class BatchedNode:
    """Single-group raft.Node over the batched device engine."""

    def __init__(
        self,
        node_id: int,
        peers: List[int],
        election_tick: int = 10,
        heartbeat_tick: int = 1,
        window: int = 256,
        max_ents_per_msg: int = 8,
        max_props_per_round: int = 8,
        pre_vote: bool = True,
        check_quorum: bool = True,
        restore: Optional[RowRestore] = None,
        boot_conf_state: Optional[ConfState] = None,
        capacity: int = 0,
        device=None,
    ) -> None:
        """`device`: where the rawnode's rows live, the GPU unless the
        caller names another (a caller without CUDA passes "cpu")."""
        self.id = node_id
        self.peers = sorted(peers)
        # Replica capacity R is a compiled shape: provision headroom
        # beyond the boot peers so future member-adds have a slot
        # (spare slots are inert — the kernel's replication/electorate
        # sets are masked by voter|learner, so nothing is sent to them
        # until a conf change admits the member).
        r = max(capacity, len(self.peers))
        if restore is not None and getattr(restore, "conf_state", None):
            boot_cs = restore.conf_state
        elif boot_conf_state is not None:
            # Joiner boot: the caller dictates the starting config —
            # typically voterless (empty), so this member cannot
            # campaign or count its own vote until the admitting conf
            # change applies from the replicated log (the device twin
            # of Node.restart-with-empty-config semantics,
            # ref: etcdserver/bootstrap.go:513-521 RestartNode).
            boot_cs = boot_conf_state
        else:
            boot_cs = ConfState(voters=list(self.peers))
        self.slot_map = SlotMap(
            self.peers, r, members=_members(boot_cs), self_id=node_id,
            joiner=node_id not in _members(boot_cs))
        if restore is not None:
            try:
                self.slot_map = _boot_slots(self.slot_map, boot_cs, restore)
            except ValueError:
                raise RaftError(
                    f"member {node_id:x}: no replica slot for the vote "
                    f"{restore.vote:x} of term {restore.term} (capacity "
                    f"R={r})") from None
            restore = replace(
                restore, vote=self.slot_map.to_device(restore.vote))
        self.cfg = BatchedConfig(
            num_groups=1,
            num_replicas=r,
            window=window,
            max_ents_per_msg=max_ents_per_msg,
            max_props_per_round=max_props_per_round,
            election_timeout=election_tick,
            heartbeat_timeout=heartbeat_tick,
            pre_vote=pre_vote,
            check_quorum=check_quorum,
            auto_compact=False,  # host-controlled via compact()
        )
        self.rn = BatchedRawNode(
            self.cfg,
            groups=np.array([0], np.int32),
            slots=np.array([self.slot_map.slot(node_id)], np.int32),
            restore={0: restore} if restore else None,
            device=device,
        )
        self._lock = threading.Lock()
        self._work = threading.Event()
        self._stopped = False
        # Latest app snapshot (index, term, data): attached to outbound
        # MsgSnap; index == device ring floor by the compact() contract.
        self._app_snap: Optional[Snapshot] = None
        # Inbound snapshot data staged until the device confirms the
        # install (keyed by snapshot index).
        self._inbound_snaps: Dict[int, Snapshot] = {}
        # Host-side proposal forwards waiting for the next Ready.
        self._fwd: List[Message] = []
        # Last emitted SoftState (Ready carries it only on change).
        self._last_soft: Optional[SoftState] = None
        # ReadIndex waiters not yet bound to a device batch, and the
        # per-batch bindings (seq -> waiters). A waiter is only ever
        # served by a batch that opened at-or-after its request, so the
        # confirmed index covers its request time (linearizability).
        # Each waiter is (sender, rctx): sender 0 for this member's own
        # read, else the follower whose MsgReadIndex it came in.
        self._read_unbound: List[Tuple[int, bytes]] = []
        self._read_bound: Dict[int, List[Tuple[int, bytes]]] = {}
        # ReadStates from the leader's MsgReadIndexResp, for the next
        # Ready.
        self._read_remote: List[ReadState] = []
        # Per sender, heartbeat context bytes -> token, oldest first, and
        # token -> the context's bytes.
        self._ctx_tokens: Dict[int, "OrderedDict[bytes, bytes]"] = {}
        self._ctx_bytes: Dict[int, Dict[bytes, bytes]] = {}
        self._ctx_next = 1
        # Node rounds run (each ready() that stepped the device).
        self.rounds = 0
        # Host config mirror driving confchange mask computation
        # (the reference's ProgressTracker config half; progress lives
        # on-device).

        self._conf_tracker = ProgressTracker(max_inflight=256)
        if boot_cs.voters or boot_cs.learners or boot_cs.voters_outgoing:
            cc_restore(Changer(self._conf_tracker, 0), boot_cs)
        cs0 = self._conf_tracker.conf_state()
        # The device boots with ALL R slots as voters (init_state);
        # upload masks whenever the true config differs — including
        # when spare capacity slots exist beyond the boot peers.
        if (sorted(self.slot_map.slots(cs0.voters)) != list(range(r))
                or cs0.learners or cs0.voters_outgoing):
            self._set_membership(cs0)

    def _set_membership(self, cs: ConfState) -> None:
        """Stage `cs`'s masks for the device, by slot."""
        sm = self.slot_map
        self.rn.set_membership(
            0,
            voters=sm.slots(cs.voters),
            voters_out=sm.slots(cs.voters_outgoing),
            learners=sm.slots(cs.learners),
            joint=bool(cs.voters_outgoing),
        )

    def _lead(self) -> int:
        """The leader's member id as this node knows it, 0 if none."""
        return self.slot_map.from_device(self.rn.lead(0))

    def _named(self) -> set:
        """The members the device names now (this term's vote and
        leader): no newcomer takes their slots, so the vote and the
        leader keep their ids when they leave the configuration."""
        sm = self.slot_map
        return {sm.from_device(int(self.rn.m_vote[0])), self._lead()} - {0}

    def _current_conf_state(self) -> ConfState:
        """Membership as last applied (snapshot metadata must reflect
        conf changes, not the boot peer list)."""
        with self._lock:
            return self._conf_tracker.conf_state()

    def _self_tracked(self) -> bool:
        """Whether this member has a progress entry in the current
        config (voter of either half or learner) — the reference's
        condition for a leader to accept proposals (raft.go:1043)."""
        with self._lock:
            cs = self._conf_tracker.conf_state()
        return self.id in set(cs.voters) | set(
            cs.voters_outgoing) | set(cs.learners)

    # -- Node interface --------------------------------------------------------

    def tick(self) -> None:
        self.rn.tick()
        self._work.set()

    def campaign(self) -> None:
        self.rn.campaign([0])
        self._work.set()

    def _propose_entry(self, data: bytes, etype: EntryType,
                       timeout: Optional[float]) -> None:
        """Shared propose path: leaders queue for the next round,
        followers forward to the known leader over the wire, no-leader
        polls up to `timeout` before dropping (ref: node.go:464-501
        stepWithWaitOption)."""
        deadline = time.monotonic() + (timeout if timeout else 5.0)
        while True:
            if self.rn.is_leader(0):
                if not self._self_tracked():
                    # A leader removed from the config drops proposals
                    # (ref: raft.go:1043-1046 "not currently a member
                    # of the range"); the device propose gate refuses
                    # them too, so queueing would pend forever.
                    raise ProposalDroppedError(
                        "raft proposal dropped: leader removed from "
                        "config")
                self.rn.propose(0, data, etype=int(etype))
                self._work.set()
                return
            lead = self._lead()
            if lead != 0:
                with self._lock:
                    self._fwd.append(Message(
                        type=MessageType.MsgProp, to=lead, from_=self.id,
                        entries=[Entry(data=data, type=etype)],
                    ))
                self._work.set()
                return
            if self._stopped or time.monotonic() >= deadline:
                raise ProposalDroppedError("no leader; proposal dropped")
            time.sleep(0.01)

    def propose(self, data: bytes, timeout: Optional[float] = None) -> None:
        self._propose_entry(data, EntryType.EntryNormal, timeout)

    def propose_conf_change(self, cc, timeout: Optional[float] = None) -> None:
        """Propose a membership change through the log; when it commits
        and the app calls apply_conf_change, the new masks upload to
        the device (ref: node.go ProposeConfChange; SURVEY §2.1
        'confchange: host-side control plane, emits new masks').

        Targets must be within the provisioned replica capacity R —
        the batched layout pre-provisions slots, add/remove toggles
        masks (capacity is a compile-time shape, membership is not)."""

        etype = (EntryType.EntryConfChangeV2
                 if isinstance(cc, ConfChangeV2)
                 else EntryType.EntryConfChange)
        self._propose_entry(cc.marshal(), etype, timeout)

    def apply_conf_change(self, cc) -> ConfState:
        """Apply a committed conf change: compute the new config with
        the same Changer the host raft uses (joint semantics included)
        and upload the masks to the device
        (ref: raft.go:896-905 applyConfChange → confchange.Changer)."""

        cc2 = cc.as_v2()
        named = self._named()
        with self._lock:
            tr = self._conf_tracker
            cfg, prs = _changed(tr, cc2, int(self.rn.m_last[0]))
            # The slots first: a target that cannot get one leaves the
            # configuration as it was.
            cs = _conf_state(cfg, prs)
            members = _members(cs)
            sm = self.slot_map.copy()
            try:
                for c in cc2.changes:
                    if c.node_id in members:
                        sm.add(c.node_id, members | named)
            except ValueError:
                raise ValueError(
                    f"conf-change targets {[c.node_id for c in cc2.changes]}"
                    f" outside provisioned replica capacity "
                    f"R={self.cfg.num_replicas}") from None
            self.slot_map = sm
            tr.config, tr.progress = cfg, prs
            auto_leave = bool(cs.voters_outgoing) and tr.config.auto_leave
        self._set_membership(cs)
        if self.rn.is_leader(0):
            # A leader contacts changed membership immediately
            # (ref: raft.go switchToConfig → maybeSendAppend), not at
            # the next heartbeat timeout — a joiner's catch-up must not
            # depend on tick cadence.
            self.rn.poke_append(0)
        if auto_leave and self.rn.is_leader(0):
            # The leader auto-proposes the empty change that exits an
            # implicit joint config (ref: raft.go advance() proposing
            # the zero ConfChangeV2 when autoLeave is pending).

            self.rn.propose(0, ConfChangeV2().marshal(),
                            etype=int(EntryType.EntryConfChangeV2))
        self._work.set()
        return cs

    def step(self, m: Message) -> None:
        if m.type == MessageType.MsgReadIndex:
            self._step_read_index(m)
            return
        if m.type == MessageType.MsgReadIndexResp:
            # The leader confirmed this member's read (ref: raft.go:1328
            # stepFollower MsgReadIndexResp).
            if len(m.entries) == 1:
                with self._lock:
                    self._read_remote.append(ReadState(
                        index=m.index, request_ctx=m.entries[0].data))
                self._work.set()
            return
        if m.type == MessageType.MsgTransferLeader:
            # Forwarded from a follower: from_ carries the transferee
            # (raft.go stepLeader MsgTransferLeader convention).
            slot = self.slot_map.slot(m.from_)
            if self.rn.is_leader(0) and slot is not None:
                self.rn.transfer_leader(0, slot)
                self._work.set()
            return
        if m.type == MessageType.MsgProp:
            # Forwarded proposal: accept if we lead, else re-forward once
            # more toward our view of the leader; drop without one.
            if self.rn.is_leader(0):
                if not self._self_tracked():
                    # Same gate as the local propose path: the device
                    # refuses appends from an untracked leader, so
                    # queueing would pend (and spin has_work) forever.
                    raise ProposalDroppedError(
                        "raft proposal dropped: leader removed from "
                        "config")
                for e in m.entries:
                    # Entry types survive forwarding (a follower's conf
                    # change must commit as EntryConfChange).
                    self.rn.propose(0, e.data, etype=int(e.type))
                self._work.set()
                return
            lead = self._lead()
            if lead == 0 or lead == m.from_:
                raise ProposalDroppedError("no leader; proposal dropped")
            with self._lock:
                self._fwd.append(
                    Message(
                        type=MessageType.MsgProp, to=lead, from_=self.id,
                        entries=m.entries,
                    )
                )
            self._work.set()
            return
        if m.type == MessageType.MsgSnap:
            # Stash app data; the device confirms the install and the
            # Ready carries the snapshot to the host for restore.
            with self._lock:
                self._inbound_snaps[m.snapshot.metadata.index] = m.snapshot
            # The sender's ring floor (m.index) may sit BELOW the
            # attached app snapshot (compaction keeps a catch-up margin;
            # the app state is serialized at applied). Install at the
            # app snapshot's index — its state supersedes the log
            # entries in between, and the confirm/stash keys then agree.
            if m.snapshot.metadata.index > m.index:
                m.index = m.snapshot.metadata.index
                m.log_term = m.snapshot.metadata.term
        if int(m.type) == T_HB and m.context and len(m.context) != 4:
            m = replace(m, context=self._ctx_token(m.from_, m.context))
        frm, to = self._sender(m), self.slot_map.to_device(m.to)
        if frm is None or to is None:
            return  # not for this member, or no slot left for the sender
        m = replace(m, from_=frm, to=to)
        e = self.cfg.max_ents_per_msg
        if int(m.type) == T_APP and len(m.entries) > e:
            # One append of more than E entries (a scalar-core leader's)
            # is the same as its consecutive runs of E, each after the
            # last: the device reads E entries of a message.
            prev, prev_term = m.index, m.log_term
            for k in range(0, len(m.entries), e):
                run = m.entries[k:k + e]
                self.rn.step(0, replace(m, index=prev, log_term=prev_term,
                                        entries=run), merge_appends=True)
                prev, prev_term = run[-1].index, run[-1].term
        else:
            self.rn.step(0, m, merge_appends=True)
        self._work.set()

    def _sender(self, m: Message) -> Optional[int]:
        """m's sender as the device's id. A sender without a slot, at
        this node's term or above, gets a free one (the reference's raft
        steps a message from any id: the leader that a conf change this
        member has not applied yet added must reach it); None for a
        stale one, or when no slot is free."""
        did = self.slot_map.to_device(m.from_)
        if did is not None or m.term < int(self.rn.m_term[0]):
            return did
        named = self._named()
        with self._lock:
            sm = self.slot_map.copy()
            try:
                slot = sm.add(m.from_, _members(
                    self._conf_tracker.conf_state()) | named)
            except ValueError:
                return None
            self.slot_map = sm
        return slot + 1

    def _ctx_token(self, sender: int, ctx: bytes) -> bytes:
        """A 4-byte stand-in for a heartbeat context of another length
        from member `sender`, remembered so that the response carries
        the bytes back."""
        with self._lock:
            toks = self._ctx_tokens.setdefault(sender, OrderedDict())
            ctxs = self._ctx_bytes.setdefault(sender, {})
            tok = toks.get(ctx)
            if tok is not None:
                return tok
            tok = self._ctx_next.to_bytes(4, "little")
            self._ctx_next = self._ctx_next % 0x7FFFFFFF + 1
            toks[ctx], ctxs[tok] = tok, ctx
            while len(toks) > _CTX_TOKENS:
                del ctxs[toks.popitem(last=False)[1]]
            return tok

    def _step_read_index(self, m: Message) -> None:
        """A follower's MsgReadIndex: join the device's next ReadIndex
        batch where this member leads, bound to (sender, ctx); forward
        it toward the leader otherwise; drop it without one (ref:
        raft.go:1069 stepLeader, :1320 stepFollower)."""
        if len(m.entries) != 1:
            return
        if self.rn.is_leader(0):
            sender = 0 if m.from_ == self.id else m.from_
            with self._lock:
                self._read_unbound.append((sender, m.entries[0].data))
            self.rn.read_index(0)
            self._work.set()
            return
        lead = self._lead()
        if lead != 0 and lead != m.from_:
            with self._lock:
                self._fwd.append(replace(m, to=lead))
            self._work.set()

    def read_index(self, rctx: bytes) -> None:
        """Open (or join) a ReadIndex batch on the device; the
        confirmed index surfaces as Ready.read_states carrying `rctx`
        (ref: node.go:556-560 ReadIndex; batching matches the server's
        linearizableReadLoop one-round-many-waiters shape). A follower
        asks its leader with MsgReadIndex and surfaces the leader's
        answer; with no leader it drops the request, as the reference's
        follower does (ref: raft.go:1320-1327), and the caller's retry
        asks again once a leader is known (the server's read loop
        re-requests every READ_INDEX_RETRY_TIME until its timeout)."""
        if not self.rn.is_leader(0):
            lead = self._lead()
            if lead == 0:
                return
            with self._lock:
                self._fwd.append(Message(
                    type=MessageType.MsgReadIndex, to=lead, from_=self.id,
                    entries=[Entry(data=rctx)]))
            self._work.set()
            return
        with self._lock:
            self._read_unbound.append((0, rctx))
        self.rn.read_index(0)
        self._work.set()

    def transfer_leadership(self, lead: int, transferee: int) -> None:
        """ref: node.go:550-554 TransferLeadership. A non-leader
        forwards to its known leader over the wire, the reference's
        stepFollower MsgTransferLeader path (raft.go:1457-1464)."""
        if self.rn.is_leader(0):
            slot = self.slot_map.slot(transferee)
            if slot is None:
                return  # not a member; drop like a stale request
            self.rn.transfer_leader(0, slot)
        else:
            lead_now = self._lead()
            if lead_now == 0:
                return  # no leader; drop like the reference logs+drops
            with self._lock:
                self._fwd.append(Message(
                    type=MessageType.MsgTransferLeader, to=lead_now,
                    from_=transferee,
                ))
        self._work.set()

    def report_unreachable(self, vid: int) -> None:
        pass

    def report_snapshot(self, vid: int, failure: bool) -> None:
        pass

    def has_ready(self) -> bool:
        with self._lock:
            fwd = bool(self._fwd or self._read_remote)
        return fwd or self.rn.has_work()

    def ready(self, timeout: Optional[float] = None) -> Optional[Ready]:
        """Run one device round over the staged inputs and translate the
        BatchedReady to the host Ready shape. Returns None when there is
        no work within `timeout`."""
        if not self.rn.has_work() and not self._fwd and not self._read_remote:
            if not self._work.wait(timeout):
                return None
        self._work.clear()
        if self._stopped:
            return None
        rd = self.rn.advance_round()
        self.rounds += 1
        sm = self.slot_map

        entries = [
            Entry(index=i, term=t, data=d, type=EntryType(et))
            for (_row, i, t, d, et) in rd.entries
        ]
        committed = []
        for _row, items in rd.committed:
            committed.extend(
                Entry(index=i, term=t, data=d or b"", type=EntryType(et))
                for (i, t, d, et) in items
            )

        snapshot = Snapshot()
        if rd.snapshots:
            _row, idx, term = rd.snapshots[-1]
            with self._lock:
                stash = self._inbound_snaps.pop(idx, None)
                # Drop only staler stashes — a higher-index MsgSnap may
                # already be queued for a later round.
                for k in [k for k in self._inbound_snaps if k <= idx]:
                    del self._inbound_snaps[k]
            if stash is not None:
                snapshot = stash
                # An installed snapshot carries the sender's membership;
                # entries between our log and the snapshot (which may
                # include conf changes) are skipped, so the config must
                # be restored from the metadata — the device twin of
                # raft.restore() → confchange.Restore
                # (ref: raft.go:1589-1605, confchange/restore.go:155).
                cs = stash.metadata.conf_state
                if cs.voters or cs.learners or cs.voters_outgoing:
                    with self._lock:
                        tr = ProgressTracker(max_inflight=256)
                        cc_restore(Changer(tr, idx), cs)
                        self._conf_tracker = tr
                        sm = self.slot_map.copy()
                        keep = _members(cs) | self._named()
                        for mid in sorted(_members(cs)):
                            sm.add(mid, keep)
                        self.slot_map = sm
                    self._set_membership(cs)
            else:
                snapshot = Snapshot(
                    metadata=SnapshotMetadata(
                        index=idx, term=term,
                        conf_state=self._current_conf_state(),
                    )
                )
            self.rn.install_snapshot_state(0, idx)

        messages = []
        all_msgs = list(rd.messages)
        if rd.msg_block is not None and len(rd.msg_block):
            all_msgs.extend(block_messages(rd.msg_block))
        for _row, m in all_msgs:
            if int(m.type) == T_SNAP:
                with self._lock:
                    app = self._app_snap
                if app is None or app.metadata.index < m.snapshot.metadata.index:
                    # Floor moved without a matching app snapshot (only
                    # possible transiently); retry next heartbeat.
                    continue
                m.snapshot = app
            m.to, m.from_ = sm.from_device(m.to), sm.from_device(m.from_)
            if not m.to:
                continue  # to a slot that no member holds any more
            if int(m.type) == T_HB_RESP and m.context:
                with self._lock:
                    ctx = self._ctx_bytes.get(m.to, {}).get(m.context)
                if ctx is not None:
                    m.context = ctx
            messages.append(m)

        term = int(self.rn._round[0][0])
        read_states = []
        if rd.read_opened or rd.read_states:
            with self._lock:
                # Bind unbound waiters to the batch that just opened:
                # it captured a commit index ≥ their request time.
                for _row, seq in rd.read_opened:
                    self._read_bound.setdefault(seq, []).extend(
                        self._read_unbound)
                    self._read_unbound = []
                for _row, seq, ridx in rd.read_states:
                    for sender, rctx in self._read_bound.pop(seq, []):
                        if sender:
                            # A follower's read: answer it (ref:
                            # raft.go:1737 responseToReadIndexReq).
                            messages.append(Message(
                                type=MessageType.MsgReadIndexResp,
                                to=sender, from_=self.id, term=term,
                                index=ridx, entries=[Entry(data=rctx)]))
                        else:
                            read_states.append(
                                ReadState(index=ridx, request_ctx=rctx))
        with self._lock:
            messages.extend(self._fwd)
            self._fwd.clear()
            read_states.extend(self._read_remote)
            self._read_remote.clear()

        hs = HardState(
            term=term,
            vote=sm.from_device(int(self.rn._round[1][0])),
            commit=int(self.rn._round[2][0]),
        )
        # SoftState rides the Ready only when it changed — the
        # reference's newReady contract (raft/node.go:564-584), which
        # is how EtcdServer learns leadership transitions.
        soft = SoftState(
            lead=self._lead(),
            raft_state=StateType(int(self.rn.m_role[0])),
        )
        soft_out = None
        if self._last_soft is None or not soft.equal(self._last_soft):
            self._last_soft = soft
            soft_out = soft
        rd_out = Ready(
            hard_state=hs if rd.hardstates else HardState(),
            soft_state=soft_out,
            entries=entries,
            snapshot=snapshot,
            committed_entries=committed,
            messages=messages,
            must_sync=rd.must_sync,
            read_states=read_states,
        )
        return rd_out

    def advance(self) -> None:
        self.rn.advance()

    def create_snapshot(self, index: int, confstate: Optional[ConfState],
                        data: bytes) -> Snapshot:
        """Build a Snapshot at `index` (≤ committed) with the term taken
        from the device ring (ref: MemoryStorage.CreateSnapshot,
        raft/storage.go:180-199). Callable mid-Ready: the host applies
        committed entries before advance(), so the bound is the
        in-flight commit."""
        rn = self.rn
        bound = max(int(rn.applied[0]), rn.latest_commit(0))
        assert index <= bound, (index, bound)
        if index > rn.m_snap[0]:
            term = int(rn.latest_ring()[0, index % self.cfg.window])
        else:
            term = rn.round_snap_term(0)
        return Snapshot(
            metadata=SnapshotMetadata(
                index=index, term=term,
                conf_state=confstate or self._current_conf_state(),
            ),
            data=data,
        )

    def compact(self, index: int, snapshot: Snapshot) -> None:
        """Host took an app snapshot at `index`: move the device ring
        floor there and keep the snapshot for lagging followers."""
        self._app_snap = snapshot
        self.rn.compact(0, index)

    def set_app_snapshot(self, snapshot: Snapshot) -> None:
        """Refresh the app snapshot backing outbound MsgSnap without
        moving the log floor — hosts that apply continuously keep this
        at their applied watermark so stragglers restore to the newest
        state (the snapOverrideStorage shape,
        ref: rafttest/interaction_env_handler_add_nodes.go)."""
        with self._lock:
            if (self._app_snap is None
                    or snapshot.metadata.index
                    >= self._app_snap.metadata.index):
                self._app_snap = snapshot

    def status(self) -> Status:
        role = int(self.rn.m_role[0])
        return Status(
            basic=BasicStatus(
                id=self.id,
                hard_state=HardState(
                    term=int(self.rn.m_term[0]),
                    vote=self.slot_map.from_device(int(self.rn.m_vote[0])),
                    commit=int(self.rn.m_commit[0]),
                ),
                soft_state=SoftState(
                    lead=self._lead(),
                    raft_state=StateType(role),
                ),
                applied=int(self.rn.applied[0]),
            )
        )

    def stop(self) -> None:
        self._stopped = True
        self._work.set()
