"""A plain Raft group, one replica at a time, in plain Python: the
reference that the benchmark holds the engine's sampled groups against.

It is written from etcd's raft (raft.go, tracker/progress.go,
quorum/majority.go) for the paths the benchmark's cells run: a
pre-vote and a vote campaign, leader appends and their acks, commit by
a majority's match, heartbeats and their acks, CheckQuorum, proposals
and log compaction. It shares no code or state with the program.

What it takes from the engine is its round, the unit in which the
engine batches raft's message passing:

* a message sent in one round is delivered in the next, and a replica
  sends at most one message of each kind to each peer a round;
* a round delivers a replica's messages by kind (vote requests,
  appends, heartbeats, vote responses, append responses, heartbeat
  responses) and, within a kind, by sender; then it ticks, takes the
  proposals and sends what the replica has pending (raft's sends are
  deferred to that point, so a leader sends one append a peer a round,
  of at most ``max_ents_per_msg`` entries);
* a leader takes at most ``max_props_per_round`` proposals a round,
  and no more than its log's ring of ``window`` slots holds beside them
  (``window - (last - snap_index) - max_props_per_round``);
* every replica applies what it has committed as it sends, and
  compacts its log up to ``min(applied, last - window // 2)``.

A path outside these (a rejected append, a snapshot, a step-down, a
replica whose election timer runs out) raises ``OutOfModel``: what the
reference does depends only on the inputs both sides were given, so a
run that reaches one says the reference does not cover its traffic, not
that the program is wrong.
"""

from __future__ import annotations

from typing import List, Sequence

FOLLOWER, CANDIDATE, LEADER, PRECANDIDATE = "follower", "candidate", \
    "leader", "precandidate"
PROBE, REPLICATE = "probe", "replicate"

# Message kinds, in the order a round delivers them.
K_VOTE, K_APP, K_HB, K_VOTE_RESP, K_APP_RESP, K_HB_RESP = range(6)
# Message types.
VOTE, PREVOTE, VOTE_RESP, PREVOTE_RESP = "vote", "prevote", "vote_resp", \
    "prevote_resp"
APP, APP_RESP, HB, HB_RESP = "app", "app_resp", "hb", "hb_resp"
_KIND = {VOTE: K_VOTE, PREVOTE: K_VOTE, APP: K_APP, HB: K_HB,
         VOTE_RESP: K_VOTE_RESP, PREVOTE_RESP: K_VOTE_RESP,
         APP_RESP: K_APP_RESP, HB_RESP: K_HB_RESP}


class OutOfModel(RuntimeError):
    """The reference reached a path it does not model."""


class Msg:
    __slots__ = ("type", "frm", "term", "index", "log_term", "commit",
                 "ents", "reject", "order")

    def __init__(self, type, frm, term, index=0, log_term=0, commit=0,
                 ents=(), reject=False):
        self.type, self.frm, self.term = type, frm, term
        self.order = _KIND[type] * 64 + frm  # the round's delivery order
        self.index, self.log_term, self.commit = index, log_term, commit
        self.ents, self.reject = ents, reject


class Replica:
    """One member of a group: raft's state, its log as a list of terms
    (entry 0 is the empty start), and as a leader each peer's
    progress."""

    def __init__(self, slot: int, r: int, cfg: dict) -> None:
        self.slot, self.r = slot, r
        self.quorum = r // 2 + 1
        self.election_timeout = int(cfg["election_timeout"])
        self.heartbeat_timeout = int(cfg["heartbeat_timeout"])
        self.pre_vote = bool(cfg["pre_vote"])
        self.check_quorum = bool(cfg["check_quorum"])
        self.window = int(cfg["window"])
        self.max_ents = int(cfg["max_ents_per_msg"])
        self.max_props = int(cfg["max_props_per_round"])
        self.max_inflight = int(cfg["max_inflight"])
        self.auto_compact = bool(cfg["auto_compact"])
        self.term = 0
        self.vote = None  # the slot voted for
        self.role = FOLLOWER
        self.lead = None  # the leader's slot
        self.log = [0]
        self.last = 0  # len(self.log) - 1
        self.snap_index = 0
        self.commit = 0
        self.applied = 0
        self.election_elapsed = 0
        self.heartbeat_elapsed = 0
        self._reset_progress()
        self.votes = {}
        self.send_vote = None  # None, VOTE or PREVOTE
        self.send_append = [False] * r
        self.send_heartbeat = [False] * r

    def term_at(self, i: int) -> int:
        """The term of entry i; 0 where it is compacted or absent (raft's
        zero term on ErrCompacted / ErrUnavailable)."""
        return self.log[i] if self.snap_index <= i <= self.last else 0

    # -- transitions --------------------------------------------------------

    def _reset_progress(self) -> None:
        last = self.last
        self.match = [last if p == self.slot else 0 for p in range(self.r)]
        self.next = [last + 1] * self.r
        self.state = [PROBE] * self.r
        self.probe_sent = [False] * self.r
        self.inflight = [0] * self.r
        self.recent_active = [False] * self.r

    def reset(self, term: int) -> None:
        """raft.go reset()."""
        if term != self.term:
            self.term, self.vote = term, None
        self.lead = None
        self.election_elapsed = self.heartbeat_elapsed = 0
        self.votes = {}
        self._reset_progress()

    def become_follower(self, term: int, lead) -> None:
        self.reset(term)
        self.role, self.lead = FOLLOWER, lead

    def become_leader(self) -> None:
        self.reset(self.term)
        self.role, self.lead = LEADER, self.slot
        self.state[self.slot] = REPLICATE
        self.append(1)  # the empty entry of the new term

    def campaign(self, pre: bool) -> None:
        if pre:
            self.role, self.lead, self.votes = PRECANDIDATE, None, {}
        else:
            self.reset(self.term + 1)
            self.role, self.vote = CANDIDATE, self.slot
        self.votes[self.slot] = True
        if self.tally() == "won":
            if pre:
                self.campaign(False)
            else:
                self.become_leader()
            return
        self.send_vote = PREVOTE if pre else VOTE

    def tally(self) -> str:
        granted = sum(self.votes.values())
        if granted >= self.quorum:
            return "won"
        if len(self.votes) - granted > self.r - self.quorum:
            return "lost"
        return "pending"

    def append(self, n: int) -> None:
        """A leader appends n entries of its term."""
        self.log.extend([self.term] * n)
        self.last += n
        me = self.slot
        self.match[me] = max(self.match[me], self.last)
        self.next[me] = max(self.next[me], self.last + 1)
        self.maybe_commit()

    def maybe_commit(self) -> bool:
        """Commit what a majority holds, if it is of this term."""
        mci = sorted(self.match, reverse=True)[self.quorum - 1]
        if mci > self.commit and self.term_at(mci) == self.term:
            self.commit = mci
            return True
        return False

    def paused(self, p: int) -> bool:
        if self.state[p] == PROBE:
            return self.probe_sent[p]
        return self.inflight[p] >= self.max_inflight

    # -- a round ------------------------------------------------------------

    def step(self, m: Msg, out: list) -> None:
        """Deliver one message; responses go to `out`."""
        if m.term > self.term:
            in_lease = (self.check_quorum and self.lead is not None
                        and self.election_elapsed < self.election_timeout)
            if m.type in (VOTE, PREVOTE) and in_lease:
                return
            if not (m.type == PREVOTE
                    or (m.type == PREVOTE_RESP and not m.reject)):
                self.become_follower(
                    m.term, m.frm if m.type in (APP, HB) else None)
        elif m.term < self.term:
            raise OutOfModel(f"a {m.type} of an older term")
        _ON[m.type](self, m, out)

    def _on_vote(self, m: Msg, out: list) -> None:
        """A vote or pre-vote request."""
        can = (self.vote == m.frm
               or (self.vote is None and self.lead is None)
               or (m.type == PREVOTE and m.term > self.term))
        last_term = self.term_at(self.last)
        up_to_date = (m.log_term > last_term
                      or (m.log_term == last_term and m.index >= self.last))
        grant = can and up_to_date
        if grant and m.type == VOTE:
            self.election_elapsed, self.vote = 0, m.frm
        out.append((m.frm, Msg(VOTE_RESP if m.type == VOTE else PREVOTE_RESP,
                               self.slot, m.term if grant else self.term,
                               reject=not grant)))

    def _on_vote_resp(self, m: Msg, out: list) -> None:
        mine = PREVOTE_RESP if self.role == PRECANDIDATE else VOTE_RESP
        if self.role not in (CANDIDATE, PRECANDIDATE) or m.type != mine:
            return
        self.votes.setdefault(m.frm, not m.reject)
        res = self.tally()
        if res == "won":
            if self.role == PRECANDIDATE:
                self.campaign(False)
            else:
                self.become_leader()
                for p in range(self.r):
                    self.send_append[p] = True
        elif res == "lost":
            self.become_follower(self.term, None)

    def _from_leader(self, m: Msg) -> bool:
        if self.role == LEADER:
            return False
        if self.role in (CANDIDATE, PRECANDIDATE):
            self.become_follower(m.term, m.frm)
        self.election_elapsed, self.lead = 0, m.frm
        return True

    def _on_app(self, m: Msg, out: list) -> None:
        if not self._from_leader(m):
            return
        prev, n = m.index, len(m.ents)
        if prev < self.commit:
            index = self.commit
        elif self.term_at(prev) == m.log_term:
            for j, t in enumerate(m.ents):
                i = prev + 1 + j
                if i > self.last or self.term_at(i) != t:
                    del self.log[i:]
                    self.log.extend(m.ents[j:])
                    self.last = len(self.log) - 1
                    break
            self.commit = max(self.commit, min(m.commit, prev + n))
            index = prev + n
        else:
            raise OutOfModel("a rejected append")
        out.append((m.frm, Msg(APP_RESP, self.slot, self.term, index=index)))

    def _on_hb(self, m: Msg, out: list) -> None:
        if not self._from_leader(m):
            return
        self.commit = max(self.commit, min(m.commit, self.last))
        out.append((m.frm, Msg(HB_RESP, self.slot, self.term)))

    def _on_app_resp(self, m: Msg, out: list) -> None:
        if self.role != LEADER:
            return
        p = m.frm
        self.recent_active[p] = True
        if m.reject:
            raise OutOfModel("a rejected append")
        if self.match[p] >= m.index:
            return
        was_paused = self.paused(p)
        self.match[p] = m.index
        self.next[p] = max(self.next[p], m.index + 1)
        self.probe_sent[p] = False
        if self.state[p] == PROBE:
            self.state[p], self.next[p] = REPLICATE, m.index + 1
        self.inflight[p] = 0
        if self.maybe_commit():
            for q in range(self.r):
                self.send_append[q] = True
        elif was_paused or self.last >= self.next[p]:
            self.send_append[p] = True

    def _on_hb_resp(self, m: Msg, out: list) -> None:
        if self.role != LEADER:
            return
        p = m.frm
        self.recent_active[p] = True
        self.probe_sent[p] = False
        if self.state[p] == REPLICATE and self.inflight[p] >= self.max_inflight:
            self.inflight[p] -= 1
        if self.match[p] < self.last:
            self.send_append[p] = True

    def tick(self, tick: bool, campaign: bool) -> None:
        if self.role == LEADER:
            if not tick:
                return
            self.election_elapsed += 1
            self.heartbeat_elapsed += 1
            if self.heartbeat_elapsed >= self.heartbeat_timeout:
                self.heartbeat_elapsed = 0
                for p in range(self.r):
                    self.send_heartbeat[p] = True
            if self.election_elapsed >= self.election_timeout:
                self.election_elapsed = 0
                if self.check_quorum:
                    heard = sum(self.recent_active[p] or p == self.slot
                                for p in range(self.r))
                    if heard < self.quorum:
                        raise OutOfModel("a leader steps down")
                    self.recent_active = [p == self.slot
                                          for p in range(self.r)]
            return
        self.election_elapsed += int(tick)
        if self.election_elapsed >= self.election_timeout:
            raise OutOfModel("an election timer ran out")
        if campaign:
            self.election_elapsed = 0
            self.campaign(self.pre_vote)

    def propose(self, n: int) -> None:
        if self.role != LEADER or n <= 0:
            return
        room = max(self.window - (self.last - self.snap_index)
                   - self.max_props, 0)
        n = min(n, self.max_props, room)
        if n > 0:
            self.append(n)
            for p in range(self.r):
                self.send_append[p] = True

    def emit(self, out: list) -> None:
        """Apply and compact, then send what is pending."""
        self.applied = max(self.applied, self.commit)
        if self.auto_compact:
            self.snap_index = max(self.snap_index, min(
                self.applied, self.last - self.window // 2))
        me = self.slot
        if self.send_vote is not None:
            pre = self.send_vote == PREVOTE
            for p in range(self.r):
                if p != me:
                    out.append((p, Msg(self.send_vote, me,
                                       self.term + 1 if pre else self.term,
                                       index=self.last,
                                       log_term=self.term_at(self.last))))
        if self.role == LEADER:
            for p in range(self.r):
                if p != me and self.send_heartbeat[p]:
                    out.append((p, Msg(HB, me, self.term, commit=min(
                        self.match[p], self.commit))))
            for p in range(self.r):
                if p == me or not self.send_append[p] or self.paused(p):
                    continue
                prev = self.next[p] - 1
                if prev < self.snap_index:
                    raise OutOfModel("a snapshot")
                ents = tuple(self.log[prev + 1:prev + 1 + self.max_ents])
                out.append((p, Msg(APP, me, self.term, index=prev,
                                   log_term=self.term_at(prev),
                                   commit=self.commit, ents=ents)))
                if ents:
                    if self.state[p] == PROBE:
                        self.probe_sent[p] = True
                    else:
                        self.next[p] += len(ents)
                        self.inflight[p] += 1
        self.send_vote = None
        if True in self.send_append:
            self.send_append = [False] * self.r
        if True in self.send_heartbeat:
            self.send_heartbeat = [False] * self.r


_ON = {VOTE: Replica._on_vote, PREVOTE: Replica._on_vote,
       VOTE_RESP: Replica._on_vote_resp, PREVOTE_RESP: Replica._on_vote_resp,
       APP: Replica._on_app, HB: Replica._on_hb,
       APP_RESP: Replica._on_app_resp, HB_RESP: Replica._on_hb_resp}


def _order(m: Msg) -> int:
    return m.order


class Group:
    """The replicas of one group and the messages between them."""

    def __init__(self, cfg: dict) -> None:
        r = int(cfg["num_replicas"])
        self.replicas = [Replica(s, r, cfg) for s in range(r)]
        self.inbox: List[list] = [[] for _ in range(r)]

    def round(self, tick: bool, props: int = 0,
              campaign: Sequence[int] = ()) -> None:
        """One round: `props` offered to slot 0, `campaign` the slots
        told to campaign."""
        sent: List[tuple] = []
        for rep, msgs in zip(self.replicas, self.inbox):
            out: List[tuple] = []
            msgs.sort(key=_order)
            for m in msgs:
                rep.step(m, out)
            rep.tick(tick, rep.slot in campaign)
            if rep.slot == 0:
                rep.propose(props)
            rep.emit(out)
            sent.extend(out)
        self.inbox = [[] for _ in self.replicas]
        for to, m in sent:
            self.inbox[to].append(m)
