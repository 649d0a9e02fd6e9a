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
from typing import Dict, List, Optional

import numpy as np

from ..raft.confchange import Changer, restore as cc_restore
from ..raft.errors import RaftError
from ..raft.raft import SoftState, StateType
from ..raft.rawnode import BasicStatus, Ready, Status
from ..raft.read_only import ReadState
from ..raft.tracker import ProgressTracker
from ..raft.types import (
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
from .step import T_SNAP


class ProposalDroppedError(RaftError):
    """ref: raft.ErrProposalDropped."""


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
        assert self.peers == list(range(1, len(self.peers) + 1)), (
            "batched backend uses dense member ids 1..R"
        )
        # Replica capacity R is a compiled shape: provision headroom
        # beyond the boot peers so future member-adds have a slot
        # (spare slots are inert — the kernel's replication/electorate
        # sets are masked by voter|learner, so nothing is sent to them
        # until a conf change admits the member).
        r = max(capacity, len(self.peers))
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
            slots=np.array([node_id - 1], np.int32),
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
        self._read_unbound: List[bytes] = []
        self._read_bound: Dict[int, List[bytes]] = {}
        # Host config mirror driving confchange mask computation
        # (the reference's ProgressTracker config half; progress lives
        # on-device).

        self._conf_tracker = ProgressTracker(max_inflight=256)
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
        if boot_cs.voters or boot_cs.learners or boot_cs.voters_outgoing:
            cc_restore(Changer(self._conf_tracker, 0), boot_cs)
        cs0 = self._conf_tracker.conf_state()
        # The device boots with ALL R slots as voters (init_state);
        # upload masks whenever the true config differs — including
        # when spare capacity slots exist beyond the boot peers.
        if (sorted(cs0.voters) != list(range(1, r + 1)) or cs0.learners
                or cs0.voters_outgoing):
            self.rn.set_membership(
                0,
                voters=[v - 1 for v in cs0.voters],
                voters_out=[v - 1 for v in cs0.voters_outgoing],
                learners=[v - 1 for v in cs0.learners],
                joint=bool(cs0.voters_outgoing),
            )

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
            lead = self.rn.lead(0)
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
        bad = [c.node_id for c in cc2.changes
               if not 1 <= c.node_id <= self.cfg.num_replicas]
        if bad:
            raise ValueError(
                f"conf-change targets {bad} outside provisioned replica "
                f"capacity R={self.cfg.num_replicas}")
        with self._lock:
            tr = self._conf_tracker
            changer = Changer(tracker=tr, last_index=int(self.rn.m_last[0]))
            if cc2.leave_joint():
                cfg, prs = changer.leave_joint()
            else:
                auto_leave, use_joint = cc2.enter_joint()
                if use_joint:
                    cfg, prs = changer.enter_joint(auto_leave, cc2.changes)
                else:
                    cfg, prs = changer.simple(cc2.changes)
            tr.config, tr.progress = cfg, prs
            cs = tr.conf_state()
            auto_leave = bool(cs.voters_outgoing) and tr.config.auto_leave
        self.rn.set_membership(
            0,
            voters=[v - 1 for v in cs.voters],
            voters_out=[v - 1 for v in cs.voters_outgoing],
            learners=[v - 1 for v in cs.learners],
            joint=bool(cs.voters_outgoing),
        )
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
        if m.type == MessageType.MsgTransferLeader:
            # Forwarded from a follower: from_ carries the transferee
            # (raft.go stepLeader MsgTransferLeader convention).
            if self.rn.is_leader(0):
                self.rn.transfer_leader(0, m.from_ - 1)
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
            lead = self.rn.lead(0)
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
        self.rn.step(0, m)
        self._work.set()

    def read_index(self, rctx: bytes) -> None:
        """Open (or join) a ReadIndex batch on the device; the
        confirmed index surfaces as Ready.read_states carrying `rctx`
        (ref: node.go:556-560 ReadIndex; batching matches the server's
        linearizableReadLoop one-round-many-waiters shape).

        Raises on a non-leader so callers retry against the leader
        instead of hanging (divergence from the reference, which
        forwards MsgReadIndex — the server read loop's retry/timeout
        machinery handles both shapes)."""
        if not self.rn.is_leader(0):
            raise ProposalDroppedError("read_index: not leader")
        with self._lock:
            self._read_unbound.append(rctx)
        self.rn.read_index(0)
        self._work.set()

    def transfer_leadership(self, lead: int, transferee: int) -> None:
        """ref: node.go:550-554 TransferLeadership. A non-leader
        forwards to its known leader over the wire, the reference's
        stepFollower MsgTransferLeader path (raft.go:1457-1464)."""
        if self.rn.is_leader(0):
            self.rn.transfer_leader(0, transferee - 1)
        else:
            lead_now = self.rn.lead(0)
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
            fwd = bool(self._fwd)
        return fwd or self.rn.has_work()

    def ready(self, timeout: Optional[float] = None) -> Optional[Ready]:
        """Run one device round over the staged inputs and translate the
        BatchedReady to the host Ready shape. Returns None when there is
        no work within `timeout`."""
        if not self.rn.has_work() and not self._fwd:
            if not self._work.wait(timeout):
                return None
        self._work.clear()
        if self._stopped:
            return None
        rd = self.rn.advance_round()

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
                    self.rn.set_membership(
                        0,
                        voters=[v - 1 for v in cs.voters],
                        voters_out=[v - 1 for v in cs.voters_outgoing],
                        learners=[v - 1 for v in cs.learners],
                        joint=bool(cs.voters_outgoing),
                    )
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
            messages.append(m)
        with self._lock:
            messages.extend(self._fwd)
            self._fwd.clear()

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
                    for rctx in self._read_bound.pop(seq, []):
                        read_states.append(
                            ReadState(index=ridx, request_ctx=rctx))

        hs = HardState(
            term=int(self.rn._round[0][0]),
            vote=int(self.rn._round[1][0]),
            commit=int(self.rn._round[2][0]),
        )
        # SoftState rides the Ready only when it changed — the
        # reference's newReady contract (raft/node.go:564-584), which
        # is how EtcdServer learns leadership transitions.
        soft = SoftState(
            lead=self.rn.lead(0),
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
                    vote=int(self.rn.m_vote[0]),
                    commit=int(self.rn.m_commit[0]),
                ),
                soft_state=SoftState(
                    lead=self.rn.lead(0),
                    raft_state=StateType(role),
                ),
                applied=int(self.rn.applied[0]),
            )
        )

    def stop(self) -> None:
        self._stopped = True
        self._work.set()
