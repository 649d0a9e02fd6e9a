"""The Raft state machine (ref: raft/raft.go).

Ports ``etcd_tpu/raft/raft.py`` whole: the single-group,
message-in/message-out state machine with no I/O and abstract tick-based
time. It is the independent Raft that the shadow cluster
(``batched/shadow.py``) holds the batched round against, and the core of
raftexample's ``"host"`` backend. Log lines mirror the reference's format
strings byte for byte.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field as dataclass_field
from enum import IntEnum
from typing import Callable, List, Optional

from . import confchange as confchange_mod
from .errors import (
    CompactedError,
    ProposalDroppedError,
    RaftError,
    SnapshotTemporarilyUnavailableError,
    UnavailableError,
)
from .log import NO_LIMIT, RaftLog
from .logger import Logger, get_logger
from .quorum import VoteResult
from .read_only import ReadOnly, ReadOnlyOption, ReadState
from .storage import Storage
from .tracker import (
    Progress,
    ProgressTracker,
    StateProbe,
    StateReplicate,
    StateSnapshot,
    progress_map_str,
)
from .types import (
    ConfChange,
    ConfChangeV2,
    ConfState,
    Entry,
    EntryType,
    HardState,
    Message,
    MessageType,
    Snapshot,
    is_empty_hard_state,
    is_empty_snap,
)

NONE = 0  # placeholder node ID when there is no leader


class StateType(IntEnum):
    StateFollower = 0
    StateCandidate = 1
    StateLeader = 2
    StatePreCandidate = 3

    def __str__(self) -> str:
        return self.name


CAMPAIGN_PRE_ELECTION = "CampaignPreElection"
CAMPAIGN_ELECTION = "CampaignElection"
CAMPAIGN_TRANSFER = "CampaignTransfer"


@dataclass
class SoftState:
    """Volatile state useful for logging/debugging (ref: raft/node.go:60-68)."""

    lead: int = NONE
    raft_state: StateType = StateType.StateFollower

    def equal(self, other: "SoftState") -> bool:
        return self.lead == other.lead and self.raft_state == other.raft_state


def is_local_msg(t: MessageType) -> bool:
    return t in (
        MessageType.MsgHup,
        MessageType.MsgBeat,
        MessageType.MsgUnreachable,
        MessageType.MsgSnapStatus,
        MessageType.MsgCheckQuorum,
    )


def is_response_msg(t: MessageType) -> bool:
    return t in (
        MessageType.MsgAppResp,
        MessageType.MsgVoteResp,
        MessageType.MsgHeartbeatResp,
        MessageType.MsgUnreachable,
        MessageType.MsgPreVoteResp,
    )


def vote_resp_msg_type(t: MessageType) -> MessageType:
    if t == MessageType.MsgVote:
        return MessageType.MsgVoteResp
    if t == MessageType.MsgPreVote:
        return MessageType.MsgPreVoteResp
    raise ValueError(f"not a vote message: {t}")


_global_rand = random.Random()


@dataclass
class Config:
    """Parameters to start a raft instance (ref: raft/raft.go:116-199)."""

    id: int = 0
    election_tick: int = 0
    heartbeat_tick: int = 0
    storage: Optional[Storage] = None
    applied: int = 0
    max_size_per_msg: int = 0
    max_committed_size_per_ready: int = 0
    max_uncommitted_entries_size: int = 0
    max_inflight_msgs: int = 0
    check_quorum: bool = False
    pre_vote: bool = False
    read_only_option: ReadOnlyOption = ReadOnlyOption.ReadOnlySafe
    logger: Optional[Logger] = None
    disable_proposal_forwarding: bool = False
    # Deterministic substitute for the reference's global lockedRand; tests
    # can inject a seeded Random.
    rand: Optional[random.Random] = None

    def validate(self) -> None:
        if self.id == NONE:
            raise ValueError("cannot use none as id")
        if self.heartbeat_tick <= 0:
            raise ValueError("heartbeat tick must be greater than 0")
        if self.election_tick <= self.heartbeat_tick:
            raise ValueError("election tick must be greater than heartbeat tick")
        if self.storage is None:
            raise ValueError("storage cannot be nil")
        if self.max_uncommitted_entries_size == 0:
            self.max_uncommitted_entries_size = NO_LIMIT
        if self.max_committed_size_per_ready == 0:
            self.max_committed_size_per_ready = self.max_size_per_msg
        if self.max_inflight_msgs <= 0:
            raise ValueError("max inflight messages must be greater than 0")
        if self.logger is None:
            self.logger = get_logger()
        if (
            self.read_only_option == ReadOnlyOption.ReadOnlyLeaseBased
            and not self.check_quorum
        ):
            raise ValueError(
                "CheckQuorum must be enabled when ReadOnlyOption is ReadOnlyLeaseBased"
            )


class Raft:
    """ref: raft/raft.go:243-316."""

    def __init__(self, c: Config):
        c.validate()
        raftlog = RaftLog(c.storage, c.logger, c.max_committed_size_per_ready)
        hs, cs = c.storage.initial_state()

        self.id = c.id
        self.term = 0
        self.vote = NONE
        self.read_states: List[ReadState] = []
        self.raft_log = raftlog
        self.max_msg_size = c.max_size_per_msg
        self.max_uncommitted_size = c.max_uncommitted_entries_size
        self.prs = ProgressTracker(c.max_inflight_msgs)
        self.state: StateType = StateType.StateFollower
        self.is_learner = False
        self.msgs: List[Message] = []
        self.lead = NONE
        self.lead_transferee = NONE
        self.pending_conf_index = 0
        self.uncommitted_size = 0
        self.read_only = ReadOnly(c.read_only_option)
        self.election_elapsed = 0
        self.heartbeat_elapsed = 0
        self.check_quorum = c.check_quorum
        self.pre_vote = c.pre_vote
        self.heartbeat_timeout = c.heartbeat_tick
        self.election_timeout = c.election_tick
        self.randomized_election_timeout = 0
        self.disable_proposal_forwarding = c.disable_proposal_forwarding
        self.logger: Logger = c.logger
        self.rand = c.rand if c.rand is not None else _global_rand
        self.pending_read_index_messages: List[Message] = []

        self.tick: Callable[[], None] = self.tick_election
        self.step_fn: Callable[[Raft, Message], None] = step_follower

        cfg, prs = confchange_mod.restore(
            confchange_mod.Changer(self.prs, raftlog.last_index()), cs
        )
        cs2 = self.switch_to_config(cfg, prs)
        if not cs.equivalent(cs2):
            self.logger.panicf("ConfStates not equivalent: %s vs %s", cs, cs2)

        if not is_empty_hard_state(hs):
            self.load_state(hs)
        if c.applied > 0:
            raftlog.applied_to(c.applied)
        self.become_follower(self.term, NONE)

        nodes_strs = ",".join(format(n, "x") for n in self.prs.voter_nodes())
        self.logger.infof(
            "newRaft %x [peers: [%s], term: %d, commit: %d, applied: %d, "
            "lastindex: %d, lastterm: %d]",
            self.id, nodes_strs, self.term, self.raft_log.committed,
            self.raft_log.applied, self.raft_log.last_index(),
            self.raft_log.last_term(),
        )

    # -- state snapshots ------------------------------------------------------

    def has_leader(self) -> bool:
        return self.lead != NONE

    def soft_state(self) -> SoftState:
        return SoftState(lead=self.lead, raft_state=self.state)

    def hard_state(self) -> HardState:
        return HardState(term=self.term, vote=self.vote, commit=self.raft_log.committed)

    # -- sending --------------------------------------------------------------

    def send(self, m: Message) -> None:
        """Queue m for the next Ready; persistence happens first
        (ref: raft.go:384-419)."""
        if m.from_ == NONE:
            m.from_ = self.id
        if m.type in (
            MessageType.MsgVote,
            MessageType.MsgVoteResp,
            MessageType.MsgPreVote,
            MessageType.MsgPreVoteResp,
        ):
            if m.term == 0:
                # Campaign messages carry the term they campaign for; the
                # pre-vote variants carry a future term.
                raise RuntimeError(f"term should be set when sending {m.type}")
        else:
            if m.term != 0:
                raise RuntimeError(
                    f"term should not be set when sending {m.type} (was {m.term})"
                )
            # MsgProp and MsgReadIndex are forwarded to the leader and act
            # as local messages; they carry no term.
            if m.type not in (MessageType.MsgProp, MessageType.MsgReadIndex):
                m.term = self.term
        self.msgs.append(m)

    def send_append(self, to: int) -> None:
        self.maybe_send_append(to, send_if_empty=True)

    def maybe_send_append(self, to: int, send_if_empty: bool) -> bool:
        """Send an append (or snapshot) to `to` if useful
        (ref: raft.go:432-492)."""
        pr = self.prs.progress[to]
        if pr.is_paused():
            return False
        m = Message(to=to)

        term_err = ents_err = None
        term = 0
        ents: List[Entry] = []
        try:
            term = self.raft_log.term(pr.next - 1)
        except (CompactedError, UnavailableError) as e:
            term_err = e
        try:
            ents = self.raft_log.entries(pr.next, self.max_msg_size)
        except CompactedError as e:
            # NB: UnavailableError from slice() is a panic in the reference
            # (log.go:357) and propagates here too.
            ents_err = e
        if not ents and not send_if_empty:
            return False

        if term_err is not None or ents_err is not None:
            # The follower's tail is compacted away: fall back to a snapshot.
            if not pr.recent_active:
                self.logger.debugf(
                    "ignore sending snapshot to %x since it is not recently active", to
                )
                return False
            m.type = MessageType.MsgSnap
            try:
                snapshot = self.raft_log.snapshot()
            except SnapshotTemporarilyUnavailableError:
                self.logger.debugf(
                    "%x failed to send snapshot to %x because snapshot is "
                    "temporarily unavailable",
                    self.id, to,
                )
                return False
            if is_empty_snap(snapshot):
                raise RuntimeError("need non-empty snapshot")
            m.snapshot = snapshot
            sindex, sterm = snapshot.metadata.index, snapshot.metadata.term
            self.logger.debugf(
                "%x [firstindex: %d, commit: %d] sent snapshot[index: %d, term: %d] to %x [%s]",
                self.id, self.raft_log.first_index(), self.raft_log.committed,
                sindex, sterm, to, pr,
            )
            pr.become_snapshot(sindex)
            self.logger.debugf(
                "%x paused sending replication messages to %x [%s]", self.id, to, pr
            )
        else:
            m.type = MessageType.MsgApp
            m.index = pr.next - 1
            m.log_term = term
            m.entries = ents
            m.commit = self.raft_log.committed
            if m.entries:
                if pr.state == StateReplicate:
                    last = m.entries[-1].index
                    pr.optimistic_update(last)
                    pr.inflights.add(last)
                elif pr.state == StateProbe:
                    pr.probe_sent = True
                else:
                    self.logger.panicf(
                        "%x is sending append in unhandled state %s", self.id, pr.state
                    )
        self.send(m)
        return True

    def send_heartbeat(self, to: int, ctx: bytes) -> None:
        """ref: raft.go:495-511 — commit is clamped to the follower's match."""
        commit = min(self.prs.progress[to].match, self.raft_log.committed)
        self.send(
            Message(to=to, type=MessageType.MsgHeartbeat, commit=commit, context=ctx)
        )

    def bcast_append(self) -> None:
        def f(vid: int, _pr: Progress) -> None:
            if vid == self.id:
                return
            self.send_append(vid)

        self.prs.visit(f)

    def bcast_heartbeat(self) -> None:
        last_ctx = self.read_only.last_pending_request_ctx()
        self.bcast_heartbeat_with_ctx(last_ctx if last_ctx else b"")

    def bcast_heartbeat_with_ctx(self, ctx: bytes) -> None:
        def f(vid: int, _pr: Progress) -> None:
            if vid == self.id:
                return
            self.send_heartbeat(vid, ctx)

        self.prs.visit(f)

    # -- Ready/advance --------------------------------------------------------

    def advance(self, rd) -> None:
        """Commit the effects of a handled Ready (ref: raft.go:543-580)."""
        self.reduce_uncommitted_size(rd.committed_entries)

        new_applied = rd.applied_cursor()
        if new_applied > 0:
            old_applied = self.raft_log.applied
            self.raft_log.applied_to(new_applied)

            if (
                self.prs.config.auto_leave
                and old_applied <= self.pending_conf_index <= new_applied
                and self.state == StateType.StateLeader
            ):
                # Auto-leave the joint configuration: propose an empty
                # ConfChangeV2 (nil data can never be size-refused).
                ent = Entry(type=EntryType.EntryConfChangeV2, data=b"")
                if not self.append_entry([ent]):
                    raise RuntimeError("refused un-refusable auto-leaving ConfChangeV2")
                self.pending_conf_index = self.raft_log.last_index()
                self.logger.infof(
                    "initiating automatic transition out of joint configuration %s",
                    self.prs.config,
                )

        if rd.entries:
            e = rd.entries[-1]
            self.raft_log.stable_to(e.index, e.term)
        if not is_empty_snap(rd.snapshot):
            self.raft_log.stable_snap_to(rd.snapshot.metadata.index)

    def maybe_commit(self) -> bool:
        """Advance the commit index from quorum acks (ref: raft.go:585-588).

        This — prs.committed() feeding raft_log.maybe_commit — is the
        replica-axis reduction kernel of the batched engine.
        """
        mci = self.prs.committed()
        return self.raft_log.maybe_commit(mci, self.term)

    def reset(self, term: int) -> None:
        if self.term != term:
            self.term = term
            self.vote = NONE
        self.lead = NONE
        self.election_elapsed = 0
        self.heartbeat_elapsed = 0
        self.reset_randomized_election_timeout()
        self.abort_leader_transfer()

        self.prs.reset_votes()

        def f(vid: int, pr: Progress) -> None:
            from .tracker import Inflights

            is_learner = pr.is_learner
            new_pr = Progress(
                match=0,
                next=self.raft_log.last_index() + 1,
                inflights=Inflights(self.prs.max_inflight),
                is_learner=is_learner,
            )
            if vid == self.id:
                new_pr.match = self.raft_log.last_index()
            # In-place replacement, preserving identity within the map.
            pr.__dict__.update(new_pr.__dict__)

        self.prs.visit(f)

        self.pending_conf_index = 0
        self.uncommitted_size = 0
        self.read_only = ReadOnly(self.read_only.option)

    def append_entry(self, es: List[Entry]) -> bool:
        """ref: raft.go:621-642."""
        li = self.raft_log.last_index()
        for i, e in enumerate(es):
            e.term = self.term
            e.index = li + 1 + i
        if not self.increase_uncommitted_size(es):
            self.logger.debugf(
                "%x appending new entries to log would exceed uncommitted entry "
                "size limit; dropping proposal",
                self.id,
            )
            return False
        li = self.raft_log.append(es)
        self.prs.progress[self.id].maybe_update(li)
        # The caller is responsible for bcast_append regardless.
        self.maybe_commit()
        return True

    # -- ticks ----------------------------------------------------------------

    def tick_election(self) -> None:
        """Followers and candidates (ref: raft.go:645-654)."""
        self.election_elapsed += 1
        if self.promotable() and self.past_election_timeout():
            self.election_elapsed = 0
            try:
                self.step(Message(from_=self.id, type=MessageType.MsgHup))
            except RaftError as e:
                self.logger.debugf("error occurred during election: %s", e)

    def tick_heartbeat(self) -> None:
        """Leaders (ref: raft.go:657-684)."""
        self.heartbeat_elapsed += 1
        self.election_elapsed += 1

        if self.election_elapsed >= self.election_timeout:
            self.election_elapsed = 0
            if self.check_quorum:
                try:
                    self.step(Message(from_=self.id, type=MessageType.MsgCheckQuorum))
                except RaftError as e:
                    self.logger.debugf(
                        "error occurred during checking sending heartbeat: %s", e
                    )
            # A leader that can't finish a transfer within an election
            # timeout resumes normal operation.
            if self.state == StateType.StateLeader and self.lead_transferee != NONE:
                self.abort_leader_transfer()

        if self.state != StateType.StateLeader:
            return

        if self.heartbeat_elapsed >= self.heartbeat_timeout:
            self.heartbeat_elapsed = 0
            try:
                self.step(Message(from_=self.id, type=MessageType.MsgBeat))
            except RaftError as e:
                self.logger.debugf(
                    "error occurred during checking sending heartbeat: %s", e
                )

    # -- role transitions -----------------------------------------------------

    def become_follower(self, term: int, lead: int) -> None:
        self.step_fn = step_follower
        self.reset(term)
        self.tick = self.tick_election
        self.lead = lead
        self.state = StateType.StateFollower
        self.logger.infof("%x became follower at term %d", self.id, self.term)

    def become_candidate(self) -> None:
        if self.state == StateType.StateLeader:
            raise RuntimeError("invalid transition [leader -> candidate]")
        self.step_fn = step_candidate
        self.reset(self.term + 1)
        self.tick = self.tick_election
        self.vote = self.id
        self.state = StateType.StateCandidate
        self.logger.infof("%x became candidate at term %d", self.id, self.term)

    def become_pre_candidate(self) -> None:
        if self.state == StateType.StateLeader:
            raise RuntimeError("invalid transition [leader -> pre-candidate]")
        # Pre-candidacy changes step/tick/state but neither Term nor Vote.
        self.step_fn = step_candidate
        self.prs.reset_votes()
        self.tick = self.tick_election
        self.lead = NONE
        self.state = StateType.StatePreCandidate
        self.logger.infof("%x became pre-candidate at term %d", self.id, self.term)

    def become_leader(self) -> None:
        if self.state == StateType.StateFollower:
            raise RuntimeError("invalid transition [follower -> leader]")
        self.step_fn = step_leader
        self.reset(self.term)
        self.tick = self.tick_heartbeat
        self.lead = self.id
        self.state = StateType.StateLeader
        self.prs.progress[self.id].become_replicate()

        # Conservatively gate conf-change proposals until the log tail is
        # committed; scanning the tail would be more precise but costly.
        self.pending_conf_index = self.raft_log.last_index()

        empty_ent = Entry(data=b"")
        if not self.append_entry([empty_ent]):
            self.logger.panicf("empty entry was dropped")
        # The initial empty entry doesn't count against the uncommitted
        # quota: one over-quota entry is allowed when usage is zero.
        self.reduce_uncommitted_size([empty_ent])
        self.logger.infof("%x became leader at term %d", self.id, self.term)

    def hup(self, t: str) -> None:
        """ref: raft.go:760-781."""
        if self.state == StateType.StateLeader:
            self.logger.debugf("%x ignoring MsgHup because already leader", self.id)
            return
        if not self.promotable():
            self.logger.warningf("%x is unpromotable and can not campaign", self.id)
            return
        try:
            ents = self.raft_log.slice(
                self.raft_log.applied + 1, self.raft_log.committed + 1, NO_LIMIT
            )
        except Exception as e:
            self.logger.panicf("unexpected error getting unapplied entries (%s)", e)
        n = num_of_pending_conf(ents)
        if n != 0 and self.raft_log.committed > self.raft_log.applied:
            self.logger.warningf(
                "%x cannot campaign at term %d since there are still %d pending "
                "configuration changes to apply",
                self.id, self.term, n,
            )
            return
        self.logger.infof("%x is starting a new election at term %d", self.id, self.term)
        self.campaign(t)

    def campaign(self, t: str) -> None:
        """ref: raft.go:785-835."""
        if not self.promotable():
            self.logger.warningf(
                "%x is unpromotable; campaign() should have been called", self.id
            )
        if t == CAMPAIGN_PRE_ELECTION:
            self.become_pre_candidate()
            vote_msg = MessageType.MsgPreVote
            # Pre-vote RPCs carry the next term without bumping self.term.
            term = self.term + 1
        else:
            self.become_candidate()
            vote_msg = MessageType.MsgVote
            term = self.term
        _, _, res = self.poll(self.id, vote_resp_msg_type(vote_msg), True)
        if res == VoteResult.VoteWon:
            # Single-node quorum: advance immediately.
            if t == CAMPAIGN_PRE_ELECTION:
                self.campaign(CAMPAIGN_ELECTION)
            else:
                self.become_leader()
            return
        ids = sorted(self.prs.voters.ids())
        for vid in ids:
            if vid == self.id:
                continue
            self.logger.infof(
                "%x [logterm: %d, index: %d] sent %s request to %x at term %d",
                self.id, self.raft_log.last_term(), self.raft_log.last_index(),
                vote_msg, vid, self.term,
            )
            ctx = t.encode() if t == CAMPAIGN_TRANSFER else b""
            self.send(
                Message(
                    term=term,
                    to=vid,
                    type=vote_msg,
                    index=self.raft_log.last_index(),
                    log_term=self.raft_log.last_term(),
                    context=ctx,
                )
            )

    def poll(self, vid: int, t: MessageType, v: bool):
        if v:
            self.logger.infof("%x received %s from %x at term %d", self.id, t, vid, self.term)
        else:
            self.logger.infof(
                "%x received %s rejection from %x at term %d", self.id, t, vid, self.term
            )
        self.prs.record_vote(vid, v)
        return self.prs.tally_votes()

    # -- stepping -------------------------------------------------------------

    def step(self, m: Message) -> None:
        """Top-level message handling incl. term logic (ref: raft.go:847-987)."""
        if m.term == 0:
            pass  # local message
        elif m.term > self.term:
            if m.type in (MessageType.MsgVote, MessageType.MsgPreVote):
                force = bytes(m.context) == CAMPAIGN_TRANSFER.encode()
                in_lease = (
                    self.check_quorum
                    and self.lead != NONE
                    and self.election_elapsed < self.election_timeout
                )
                if not force and in_lease:
                    # Within the lease period we neither bump our term nor
                    # grant the vote.
                    self.logger.infof(
                        "%x [logterm: %d, index: %d, vote: %x] ignored %s from %x "
                        "[logterm: %d, index: %d] at term %d: lease is not expired "
                        "(remaining ticks: %d)",
                        self.id, self.raft_log.last_term(), self.raft_log.last_index(),
                        self.vote, m.type, m.from_, m.log_term, m.index, self.term,
                        self.election_timeout - self.election_elapsed,
                    )
                    return
            if m.type == MessageType.MsgPreVote:
                pass  # never change term in response to a pre-vote
            elif m.type == MessageType.MsgPreVoteResp and not m.reject:
                # A granted pre-vote carries our own future term; the term
                # bump happens when the quorum is in.
                pass
            else:
                self.logger.infof(
                    "%x [term: %d] received a %s message with higher term from %x [term: %d]",
                    self.id, self.term, m.type, m.from_, m.term,
                )
                if m.type in (
                    MessageType.MsgApp,
                    MessageType.MsgHeartbeat,
                    MessageType.MsgSnap,
                ):
                    self.become_follower(m.term, m.from_)
                else:
                    self.become_follower(m.term, NONE)
        elif m.term < self.term:
            if (self.check_quorum or self.pre_vote) and m.type in (
                MessageType.MsgHeartbeat,
                MessageType.MsgApp,
            ):
                # A removed node's stale leader traffic gets an empty
                # MsgAppResp to nudge it toward the current term without
                # disruptive term bumps (ref: raft.go:884-906).
                self.send(Message(to=m.from_, type=MessageType.MsgAppResp))
            elif m.type == MessageType.MsgPreVote:
                self.logger.infof(
                    "%x [logterm: %d, index: %d, vote: %x] rejected %s from %x "
                    "[logterm: %d, index: %d] at term %d",
                    self.id, self.raft_log.last_term(), self.raft_log.last_index(),
                    self.vote, m.type, m.from_, m.log_term, m.index, self.term,
                )
                self.send(
                    Message(
                        to=m.from_,
                        term=self.term,
                        type=MessageType.MsgPreVoteResp,
                        reject=True,
                    )
                )
            else:
                self.logger.infof(
                    "%x [term: %d] ignored a %s message with lower term from %x [term: %d]",
                    self.id, self.term, m.type, m.from_, m.term,
                )
            return

        if m.type == MessageType.MsgHup:
            self.hup(CAMPAIGN_PRE_ELECTION if self.pre_vote else CAMPAIGN_ELECTION)
        elif m.type in (MessageType.MsgVote, MessageType.MsgPreVote):
            # Vote if repeating a prior vote, if we have no vote and know of
            # no leader this term, or for a future-term pre-vote...
            can_vote = (
                self.vote == m.from_
                or (self.vote == NONE and self.lead == NONE)
                or (m.type == MessageType.MsgPreVote and m.term > self.term)
            )
            # ...and only for an up-to-date candidate. NB: learners must be
            # allowed to vote — they may be voters who haven't yet applied
            # their own promotion (ref: raft.go:938-956).
            if can_vote and self.raft_log.is_up_to_date(m.index, m.log_term):
                self.logger.infof(
                    "%x [logterm: %d, index: %d, vote: %x] cast %s for %x "
                    "[logterm: %d, index: %d] at term %d",
                    self.id, self.raft_log.last_term(), self.raft_log.last_index(),
                    self.vote, m.type, m.from_, m.log_term, m.index, self.term,
                )
                # Respond with the term from the message, not the local term:
                # pre-vote grants keep the local term unchanged.
                self.send(
                    Message(to=m.from_, term=m.term, type=vote_resp_msg_type(m.type))
                )
                if m.type == MessageType.MsgVote:
                    self.election_elapsed = 0
                    self.vote = m.from_
            else:
                self.logger.infof(
                    "%x [logterm: %d, index: %d, vote: %x] rejected %s from %x "
                    "[logterm: %d, index: %d] at term %d",
                    self.id, self.raft_log.last_term(), self.raft_log.last_index(),
                    self.vote, m.type, m.from_, m.log_term, m.index, self.term,
                )
                self.send(
                    Message(
                        to=m.from_,
                        term=self.term,
                        type=vote_resp_msg_type(m.type),
                        reject=True,
                    )
                )
        else:
            self.step_fn(self, m)

    # -- message handlers -----------------------------------------------------

    def handle_append_entries(self, m: Message) -> None:
        """ref: raft.go:1475-1511."""
        if m.index < self.raft_log.committed:
            self.send(
                Message(to=m.from_, type=MessageType.MsgAppResp,
                        index=self.raft_log.committed)
            )
            return
        mlast_index, ok = self.raft_log.maybe_append(m.index, m.log_term, m.commit, m.entries)
        if ok:
            self.send(Message(to=m.from_, type=MessageType.MsgAppResp, index=mlast_index))
        else:
            self.logger.debugf(
                "%x [logterm: %d, index: %d] rejected MsgApp [logterm: %d, index: %d] from %x",
                self.id, self.raft_log.zero_term_on_err_compacted(m.index), m.index,
                m.log_term, m.index, m.from_,
            )
            # Hint the leader at the largest (index, term) pair that could
            # possibly still match, skipping the divergent uncommitted tail
            # in one round trip (ref: raft.go:1487-1509).
            hint_index = min(m.index, self.raft_log.last_index())
            hint_index = self.raft_log.find_conflict_by_term(hint_index, m.log_term)
            hint_term = self.raft_log.term(hint_index)
            self.send(
                Message(
                    to=m.from_,
                    type=MessageType.MsgAppResp,
                    index=m.index,
                    reject=True,
                    reject_hint=hint_index,
                    log_term=hint_term,
                )
            )

    def handle_heartbeat(self, m: Message) -> None:
        self.raft_log.commit_to(m.commit)
        self.send(
            Message(to=m.from_, type=MessageType.MsgHeartbeatResp, context=m.context)
        )

    def handle_snapshot(self, m: Message) -> None:
        sindex, sterm = m.snapshot.metadata.index, m.snapshot.metadata.term
        if self.restore(m.snapshot):
            self.logger.infof(
                "%x [commit: %d] restored snapshot [index: %d, term: %d]",
                self.id, self.raft_log.committed, sindex, sterm,
            )
            self.send(
                Message(to=m.from_, type=MessageType.MsgAppResp,
                        index=self.raft_log.last_index())
            )
        else:
            self.logger.infof(
                "%x [commit: %d] ignored snapshot [index: %d, term: %d]",
                self.id, self.raft_log.committed, sindex, sterm,
            )
            self.send(
                Message(to=m.from_, type=MessageType.MsgAppResp,
                        index=self.raft_log.committed)
            )

    def restore(self, s: Snapshot) -> bool:
        """Apply a snapshot: log + configuration (ref: raft.go:1534-1614)."""
        if s.metadata.index <= self.raft_log.committed:
            return False
        if self.state != StateType.StateFollower:
            # Defense-in-depth; shouldn't fire (ref: raft.go:1538-1549).
            self.logger.warningf(
                "%x attempted to restore snapshot as leader; should never happen",
                self.id,
            )
            self.become_follower(self.term + 1, NONE)
            return False

        cs = s.metadata.conf_state
        found = self.id in (
            set(cs.voters) | set(cs.learners) | set(cs.voters_outgoing)
        )
        if not found:
            self.logger.warningf(
                "%x attempted to restore snapshot but it is not in the ConfState %s; "
                "should never happen",
                self.id, cs,
            )
            return False

        if self.raft_log.match_term(s.metadata.index, s.metadata.term):
            self.logger.infof(
                "%x [commit: %d, lastindex: %d, lastterm: %d] fast-forwarded commit "
                "to snapshot [index: %d, term: %d]",
                self.id, self.raft_log.committed, self.raft_log.last_index(),
                self.raft_log.last_term(), s.metadata.index, s.metadata.term,
            )
            self.raft_log.commit_to(s.metadata.index)
            return False

        self.raft_log.restore(s)

        self.prs = ProgressTracker(self.prs.max_inflight)
        cfg, prs = confchange_mod.restore(
            confchange_mod.Changer(self.prs, self.raft_log.last_index()), cs
        )
        cs2 = self.switch_to_config(cfg, prs)
        if not cs.equivalent(cs2):
            self.logger.panicf("ConfStates not equivalent: %s vs %s", cs, cs2)

        pr = self.prs.progress[self.id]
        pr.maybe_update(pr.next - 1)

        self.logger.infof(
            "%x [commit: %d, lastindex: %d, lastterm: %d] restored snapshot "
            "[index: %d, term: %d]",
            self.id, self.raft_log.committed, self.raft_log.last_index(),
            self.raft_log.last_term(), s.metadata.index, s.metadata.term,
        )
        return True

    def promotable(self) -> bool:
        """Can this node be leader? (ref: raft.go:1618-1621)."""
        pr = self.prs.progress.get(self.id)
        return (
            pr is not None
            and not pr.is_learner
            and not self.raft_log.has_pending_snapshot()
        )

    def apply_conf_change(self, cc: ConfChangeV2) -> ConfState:
        changer = confchange_mod.Changer(self.prs, self.raft_log.last_index())
        if cc.leave_joint():
            cfg, prs = changer.leave_joint()
        else:
            auto_leave, ok = cc.enter_joint()
            if ok:
                cfg, prs = changer.enter_joint(auto_leave, cc.changes)
            else:
                cfg, prs = changer.simple(cc.changes)
        return self.switch_to_config(cfg, prs)

    def switch_to_config(self, cfg, prs) -> ConfState:
        """Install a new configuration (ref: raft.go:1651-1700)."""
        self.prs.config = cfg
        self.prs.progress = prs

        self.logger.infof("%x switched to configuration %s", self.id, self.prs.config)
        cs = self.prs.conf_state()
        pr = self.prs.progress.get(self.id)
        self.is_learner = pr is not None and pr.is_learner

        if (pr is None or self.is_learner) and self.state == StateType.StateLeader:
            # The leader was removed or demoted; hold off on anything else
            # until it steps down.
            return cs

        if self.state != StateType.StateLeader or len(cs.voters) == 0:
            return cs

        if self.maybe_commit():
            # The config change may lower the quorum size and commit
            # entries; tell everyone.
            self.bcast_append()
        else:
            # Probe newly added replicas right away.
            def f(vid: int, _pr: Progress) -> None:
                self.maybe_send_append(vid, send_if_empty=False)

            self.prs.visit(f)

        if self.lead_transferee != 0 and self.lead_transferee not in self.prs.voters.ids():
            self.abort_leader_transfer()
        return cs

    def load_state(self, state: HardState) -> None:
        if state.commit < self.raft_log.committed or state.commit > self.raft_log.last_index():
            self.logger.panicf(
                "%x state.commit %d is out of range [%d, %d]",
                self.id, state.commit, self.raft_log.committed, self.raft_log.last_index(),
            )
        self.raft_log.committed = state.commit
        self.term = state.term
        self.vote = state.vote

    def past_election_timeout(self) -> bool:
        return self.election_elapsed >= self.randomized_election_timeout

    def reset_randomized_election_timeout(self) -> None:
        self.randomized_election_timeout = (
            self.election_timeout + self.rand.randrange(self.election_timeout)
        )

    def send_timeout_now(self, to: int) -> None:
        self.send(Message(to=to, type=MessageType.MsgTimeoutNow))

    def abort_leader_transfer(self) -> None:
        self.lead_transferee = NONE

    def committed_entry_in_current_term(self) -> bool:
        return (
            self.raft_log.zero_term_on_err_compacted(self.raft_log.committed)
            == self.term
        )

    def response_to_read_index_req(self, req: Message, read_index: int) -> Message:
        """ref: raft.go:1737-1751."""
        if req.from_ == NONE or req.from_ == self.id:
            self.read_states.append(
                ReadState(index=read_index, request_ctx=req.entries[0].data)
            )
            return Message()
        return Message(
            type=MessageType.MsgReadIndexResp,
            to=req.from_,
            index=read_index,
            entries=req.entries,
        )

    def increase_uncommitted_size(self, ents: List[Entry]) -> bool:
        """ref: raft.go:1761-1779 — empty payloads are never refused."""
        s = sum(e.payload_size() for e in ents)
        if (
            self.uncommitted_size > 0
            and s > 0
            and self.uncommitted_size + s > self.max_uncommitted_size
        ):
            return False
        self.uncommitted_size += s
        return True

    def reduce_uncommitted_size(self, ents: List[Entry]) -> None:
        if self.uncommitted_size == 0:
            return  # follower fast path
        s = sum(e.payload_size() for e in ents)
        if s > self.uncommitted_size:
            self.uncommitted_size = 0
        else:
            self.uncommitted_size -= s


# -- step functions (ref: raft.go:991-1473) -----------------------------------


def step_leader(r: Raft, m: Message) -> None:
    # Messages that need no per-peer progress.
    if m.type == MessageType.MsgBeat:
        r.bcast_heartbeat()
        return
    if m.type == MessageType.MsgCheckQuorum:
        # The leader always counts itself active; if the quorum isn't, it
        # steps down (ref: raft.go:997-1018).
        pr = r.prs.progress.get(r.id)
        if pr is not None:
            pr.recent_active = True
        if not r.prs.quorum_active():
            r.logger.warningf(
                "%x stepped down to follower since quorum is not active", r.id
            )
            r.become_follower(r.term, NONE)

        def f(vid: int, pr: Progress) -> None:
            if vid != r.id:
                pr.recent_active = False

        r.prs.visit(f)
        return
    if m.type == MessageType.MsgProp:
        if not m.entries:
            r.logger.panicf("%x stepped empty MsgProp", r.id)
        if r.id not in r.prs.progress:
            # We were removed from the config while leading.
            raise ProposalDroppedError()
        if r.lead_transferee != NONE:
            r.logger.debugf(
                "%x [term %d] transfer leadership to %x is in progress; dropping proposal",
                r.id, r.term, r.lead_transferee,
            )
            raise ProposalDroppedError()

        for i, e in enumerate(m.entries):
            cc = None
            if e.type == EntryType.EntryConfChange:
                cc = ConfChange.unmarshal(e.data)
            elif e.type == EntryType.EntryConfChangeV2:
                cc = ConfChangeV2.unmarshal(e.data)
            if cc is not None:
                already_pending = r.pending_conf_index > r.raft_log.applied
                already_joint = len(r.prs.voters.outgoing) > 0
                wants_leave_joint = len(cc.as_v2().changes) == 0

                refused = ""
                if already_pending:
                    refused = (
                        f"possible unapplied conf change at index "
                        f"{r.pending_conf_index} (applied to {r.raft_log.applied})"
                    )
                elif already_joint and not wants_leave_joint:
                    refused = "must transition out of joint config first"
                elif not already_joint and wants_leave_joint:
                    refused = "not in joint state; refusing empty conf change"

                if refused:
                    r.logger.infof(
                        "%x ignoring conf change %s at config %s: %s",
                        r.id, cc.go_str(), r.prs.config, refused,
                    )
                    m.entries[i] = Entry(type=EntryType.EntryNormal)
                else:
                    r.pending_conf_index = r.raft_log.last_index() + i + 1

        if not r.append_entry(m.entries):
            raise ProposalDroppedError()
        r.bcast_append()
        return
    if m.type == MessageType.MsgReadIndex:
        # Leader-only singleton: respond immediately.
        if r.prs.is_singleton():
            resp = r.response_to_read_index_req(m, r.raft_log.committed)
            if resp.to != NONE:
                r.send(resp)
            return
        # Reads wait until this leader has committed in its own term.
        if not r.committed_entry_in_current_term():
            r.pending_read_index_messages.append(m)
            return
        send_msg_read_index_response(r, m)
        return

    # All remaining types need m.From's progress.
    pr = r.prs.progress.get(m.from_)
    if pr is None:
        r.logger.debugf("%x no progress available for %x", r.id, m.from_)
        return

    if m.type == MessageType.MsgAppResp:
        pr.recent_active = True
        if m.reject:
            # The follower rejected (index=m.index, logterm=m.log_term at
            # its hint m.reject_hint); use term-skipping probing to find
            # the common prefix in O(#terms) round trips
            # (ref: raft.go:1109-1236).
            r.logger.debugf(
                "%x received MsgAppResp(rejected, hint: (index %d, term %d)) "
                "from %x for index %d",
                r.id, m.reject_hint, m.log_term, m.from_, m.index,
            )
            next_probe_idx = m.reject_hint
            if m.log_term > 0:
                next_probe_idx = r.raft_log.find_conflict_by_term(
                    m.reject_hint, m.log_term
                )
            if pr.maybe_decr_to(m.index, next_probe_idx):
                r.logger.debugf(
                    "%x decreased progress of %x to [%s]", r.id, m.from_, pr
                )
                if pr.state == StateReplicate:
                    pr.become_probe()
                r.send_append(m.from_)
        else:
            old_paused = pr.is_paused()
            if pr.maybe_update(m.index):
                if pr.state == StateProbe:
                    pr.become_replicate()
                elif pr.state == StateSnapshot and pr.match >= pr.pending_snapshot:
                    r.logger.debugf(
                        "%x recovered from needing snapshot, resumed sending "
                        "replication messages to %x [%s]",
                        r.id, m.from_, pr,
                    )
                    # Probe-then-replicate keeps the snapshot index in the
                    # transition (ref: raft.go:1243-1254).
                    pr.become_probe()
                    pr.become_replicate()
                elif pr.state == StateReplicate:
                    pr.inflights.free_le(m.index)

                if r.maybe_commit():
                    release_pending_read_index_messages(r)
                    r.bcast_append()
                elif old_paused:
                    # A previously-paused node may lack the latest commit.
                    r.send_append(m.from_)
                # Flow control may have opened up; drain what we can.
                while r.maybe_send_append(m.from_, send_if_empty=False):
                    pass
                if m.from_ == r.lead_transferee and pr.match == r.raft_log.last_index():
                    r.logger.infof(
                        "%x sent MsgTimeoutNow to %x after received MsgAppResp",
                        r.id, m.from_,
                    )
                    r.send_timeout_now(m.from_)
    elif m.type == MessageType.MsgHeartbeatResp:
        pr.recent_active = True
        pr.probe_sent = False
        if pr.state == StateReplicate and pr.inflights.full():
            pr.inflights.free_first_one()
        if pr.match < r.raft_log.last_index():
            r.send_append(m.from_)

        if r.read_only.option != ReadOnlyOption.ReadOnlySafe or len(m.context) == 0:
            return
        if (
            r.prs.voters.vote_result(r.read_only.recv_ack(m.from_, m.context))
            != VoteResult.VoteWon
        ):
            return
        rss = r.read_only.advance(m)
        for rs in rss:
            resp = r.response_to_read_index_req(rs.req, rs.index)
            if resp.to != NONE:
                r.send(resp)
    elif m.type == MessageType.MsgSnapStatus:
        if pr.state != StateSnapshot:
            return
        if not m.reject:
            pr.become_probe()
            r.logger.debugf(
                "%x snapshot succeeded, resumed sending replication messages to %x [%s]",
                r.id, m.from_, pr,
            )
        else:
            # Order matters: clear the pending snapshot before probing.
            pr.pending_snapshot = 0
            pr.become_probe()
            r.logger.debugf(
                "%x snapshot failed, resumed sending replication messages to %x [%s]",
                r.id, m.from_, pr,
            )
        # Wait for the next MsgAppResp (success) or heartbeat (failure)
        # before sending more appends.
        pr.probe_sent = True
    elif m.type == MessageType.MsgUnreachable:
        # An optimistic pipeline probably lost a MsgApp; drop to probing.
        if pr.state == StateReplicate:
            pr.become_probe()
        r.logger.debugf(
            "%x failed to send message to %x because it is unreachable [%s]",
            r.id, m.from_, pr,
        )
    elif m.type == MessageType.MsgTransferLeader:
        if pr.is_learner:
            r.logger.debugf("%x is learner. Ignored transferring leadership", r.id)
            return
        lead_transferee = m.from_
        last_lead_transferee = r.lead_transferee
        if last_lead_transferee != NONE:
            if last_lead_transferee == lead_transferee:
                r.logger.infof(
                    "%x [term %d] transfer leadership to %x is in progress, "
                    "ignores request to same node %x",
                    r.id, r.term, lead_transferee, lead_transferee,
                )
                return
            r.abort_leader_transfer()
            r.logger.infof(
                "%x [term %d] abort previous transferring leadership to %x",
                r.id, r.term, last_lead_transferee,
            )
        if lead_transferee == r.id:
            r.logger.debugf(
                "%x is already leader. Ignored transferring leadership to self", r.id
            )
            return
        r.logger.infof(
            "%x [term %d] starts to transfer leadership to %x",
            r.id, r.term, lead_transferee,
        )
        # The transfer should finish within one election timeout.
        r.election_elapsed = 0
        r.lead_transferee = lead_transferee
        if pr.match == r.raft_log.last_index():
            r.send_timeout_now(lead_transferee)
            r.logger.infof(
                "%x sends MsgTimeoutNow to %x immediately as %x already has "
                "up-to-date log",
                r.id, lead_transferee, lead_transferee,
            )
        else:
            r.send_append(lead_transferee)


def step_candidate(r: Raft, m: Message) -> None:
    """Shared by StateCandidate and StatePreCandidate; they differ in which
    vote-response type they count (ref: raft.go:1376-1419)."""
    if r.state == StateType.StatePreCandidate:
        my_vote_resp_type = MessageType.MsgPreVoteResp
    else:
        my_vote_resp_type = MessageType.MsgVoteResp

    if m.type == MessageType.MsgProp:
        r.logger.infof("%x no leader at term %d; dropping proposal", r.id, r.term)
        raise ProposalDroppedError()
    elif m.type == MessageType.MsgApp:
        r.become_follower(m.term, m.from_)  # always m.term == r.term
        r.handle_append_entries(m)
    elif m.type == MessageType.MsgHeartbeat:
        r.become_follower(m.term, m.from_)
        r.handle_heartbeat(m)
    elif m.type == MessageType.MsgSnap:
        r.become_follower(m.term, m.from_)
        r.handle_snapshot(m)
    elif m.type == my_vote_resp_type:
        gr, rj, res = r.poll(m.from_, m.type, not m.reject)
        r.logger.infof(
            "%x has received %d %s votes and %d vote rejections", r.id, gr, m.type, rj
        )
        if res == VoteResult.VoteWon:
            if r.state == StateType.StatePreCandidate:
                r.campaign(CAMPAIGN_ELECTION)
            else:
                r.become_leader()
                r.bcast_append()
        elif res == VoteResult.VoteLost:
            # A pre-vote response carries our future term; keep r.term.
            r.become_follower(r.term, NONE)
    elif m.type == MessageType.MsgTimeoutNow:
        r.logger.debugf(
            "%x [term %d state %s] ignored MsgTimeoutNow from %x",
            r.id, r.term, r.state, m.from_,
        )


def step_follower(r: Raft, m: Message) -> None:
    """ref: raft.go:1421-1473."""
    if m.type == MessageType.MsgProp:
        if r.lead == NONE:
            r.logger.infof("%x no leader at term %d; dropping proposal", r.id, r.term)
            raise ProposalDroppedError()
        elif r.disable_proposal_forwarding:
            r.logger.infof(
                "%x not forwarding to leader %x at term %d; dropping proposal",
                r.id, r.lead, r.term,
            )
            raise ProposalDroppedError()
        m.to = r.lead
        r.send(m)
    elif m.type == MessageType.MsgApp:
        r.election_elapsed = 0
        r.lead = m.from_
        r.handle_append_entries(m)
    elif m.type == MessageType.MsgHeartbeat:
        r.election_elapsed = 0
        r.lead = m.from_
        r.handle_heartbeat(m)
    elif m.type == MessageType.MsgSnap:
        r.election_elapsed = 0
        r.lead = m.from_
        r.handle_snapshot(m)
    elif m.type == MessageType.MsgTransferLeader:
        if r.lead == NONE:
            r.logger.infof(
                "%x no leader at term %d; dropping leader transfer msg", r.id, r.term
            )
            return
        m.to = r.lead
        r.send(m)
    elif m.type == MessageType.MsgTimeoutNow:
        r.logger.infof(
            "%x [term %d] received MsgTimeoutNow from %x and starts an election "
            "to get leadership.",
            r.id, r.term, m.from_,
        )
        # Leadership transfers never use pre-vote: we know we're not
        # recovering from a partition.
        r.hup(CAMPAIGN_TRANSFER)
    elif m.type == MessageType.MsgReadIndex:
        if r.lead == NONE:
            r.logger.infof(
                "%x no leader at term %d; dropping index reading msg", r.id, r.term
            )
            return
        m.to = r.lead
        r.send(m)
    elif m.type == MessageType.MsgReadIndexResp:
        if len(m.entries) != 1:
            r.logger.errorf(
                "%x invalid format of MsgReadIndexResp from %x, entries count: %d",
                r.id, m.from_, len(m.entries),
            )
            return
        r.read_states.append(
            ReadState(index=m.index, request_ctx=m.entries[0].data)
        )


def num_of_pending_conf(ents: List[Entry]) -> int:
    return sum(
        1
        for e in ents
        if e.type in (EntryType.EntryConfChange, EntryType.EntryConfChangeV2)
    )


def release_pending_read_index_messages(r: Raft) -> None:
    if not r.committed_entry_in_current_term():
        r.logger.error(
            "pending MsgReadIndex should be released only after first commit in "
            "current term"
        )
        return
    msgs = r.pending_read_index_messages
    r.pending_read_index_messages = []
    for m in msgs:
        send_msg_read_index_response(r, m)


def send_msg_read_index_response(r: Raft, m: Message) -> None:
    """ref: raft.go:1827-1843."""
    if r.read_only.option == ReadOnlyOption.ReadOnlySafe:
        r.read_only.add_request(r.raft_log.committed, m)
        # The local node acks automatically.
        r.read_only.recv_ack(r.id, m.entries[0].data)
        r.bcast_heartbeat_with_ctx(m.entries[0].data)
    elif r.read_only.option == ReadOnlyOption.ReadOnlyLeaseBased:
        resp = r.response_to_read_index_req(m, r.raft_log.committed)
        if resp.to != NONE:
            r.send(resp)
