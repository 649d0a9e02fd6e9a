"""Host shadow cluster: the single-group oracle driven under the batched
round's slot network semantics, for lockstep differential testing.

Ports ``etcd_tpu/batched/shadow.py`` whole, over the port's own scalar
core (``etcd_tpu_torch.raft``). The batched network delivers at most one
message of each KIND per (sender, target) pair per round and processes
inbox slots in the configured deliver shape's order. This adapter runs R
reference-semantics RawNodes under exactly those rules so that, for
schedules within the common feature envelope (explicit campaigns,
leader-side proposals, heartbeat ticks, full-instance partitions; timer
elections through ``DeviceHashRand``), the device state must match the
oracle state field for field after every round, on the CPU or the card.
Schedules that would overflow a slot (two same-kind messages to one
target in one round) raise, keeping the comparison honest.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ..raft import Config, MemoryStorage, RawNode
from ..raft.errors import RaftError
from ..raft.raft import StateType
from ..raft.types import ConfState, Message, MessageType
from .step import (
    KIND_APP,
    KIND_APP_RESP,
    KIND_HB,
    KIND_HB_RESP,
    KIND_VOTE,
    KIND_VOTE_RESP,
    NUM_KINDS,
)

# Kind lanes, matching step.py's inbox layout.
_TYPE_TO_KIND = {
    MessageType.MsgVote: KIND_VOTE,
    MessageType.MsgPreVote: KIND_VOTE,
    MessageType.MsgApp: KIND_APP,
    MessageType.MsgSnap: KIND_APP,
    MessageType.MsgHeartbeat: KIND_HB,
    MessageType.MsgTimeoutNow: KIND_HB,
    MessageType.MsgVoteResp: KIND_VOTE_RESP,
    MessageType.MsgPreVoteResp: KIND_VOTE_RESP,
    MessageType.MsgAppResp: KIND_APP_RESP,
    MessageType.MsgHeartbeatResp: KIND_HB_RESP,
}


def _same_message(a: Message, b: Message) -> bool:
    return (
        a.type == b.type and a.term == b.term and a.log_term == b.log_term
        and a.index == b.index and a.commit == b.commit
        and a.reject == b.reject and a.reject_hint == b.reject_hint
        and [(e.index, e.term) for e in a.entries]
        == [(e.index, e.term) for e in b.entries]
    )


def _merge_apps(a: Message, b: Message) -> Optional[Message]:
    """Coalesce two same-round MsgApps to one target the way the
    device's single send flag does (one append per peer per round
    carrying the union): contiguous, same-term appends merge; anything
    else is a real envelope violation (returns None).

    The oracle legitimately emits two — commit-advance bcastAppend plus
    the proposal bcastAppend in the same Ready (raft.go maybeCommit →
    bcastAppend; appendEntry → bcastAppend)."""
    if a.type != MessageType.MsgApp or b.type != MessageType.MsgApp:
        return None
    if a.term != b.term:
        return None
    first, second = (a, b) if a.index <= b.index else (b, a)
    end1 = first.index + len(first.entries)
    end2 = second.index + len(second.entries)
    if end1 < second.index:
        return None  # gap — not one logical send
    if end1 >= end2:
        # first covers second entirely (re-materialized sends overlap)
        return Message(
            type=MessageType.MsgApp, to=first.to, from_=first.from_,
            term=first.term, log_term=first.log_term, index=first.index,
            entries=list(first.entries), commit=max(a.commit, b.commit))
    take = end1 - second.index  # overlap length to skip in second
    return Message(
        type=MessageType.MsgApp, to=a.to, from_=a.from_, term=a.term,
        log_term=first.log_term, index=first.index,
        entries=list(first.entries) + list(second.entries[take:]),
        commit=max(a.commit, b.commit),
    )


class DeviceHashRand:
    """Replays the device's deterministic randomized-timeout hash
    (step.py _rand_timeout) through the host Config's ``rand`` seam:
    call n (0-based; init's randomize is call 0, matching device
    reset_count 0) returns ((iid+1)*7919 + n*104729) % et, the sum
    wrapped to int32 first as the device's int32 arithmetic wraps it
    (the one difference from the reference's copy, which does not wrap
    and so parts from its device once the sum passes 2^31). With this,
    timer-driven elections fire on identical rounds in both engines."""

    def __init__(self, iid: int):
        self.iid = iid
        self.n = 0

    def randrange(self, et: int) -> int:
        h = (self.iid + 1) * 7919 + self.n * 104729
        out = ((h + (1 << 31)) % (1 << 32) - (1 << 31)) % et
        self.n += 1
        return out


class ShadowCluster:
    def __init__(
        self,
        num_replicas: int,
        election_timeout: int = 1 << 20,
        heartbeat_timeout: int = 1,
        max_inflight: int = 1 << 20,
        pre_vote: bool = False,
        learners: Sequence[int] = (),
        group: int = 0,
        deterministic_timeouts: bool = False,
        auto_compact_window: int = 0,
        max_ents: Optional[int] = None,
        deliver_shape: str = "auto",
    ):
        # Mirrors BatchedConfig.deliver_shape: the device's delivery
        # order is kind-major (six lane scans, "lanes"), sender-major
        # within request/response halves ("merged"), or the vectorized
        # order contract ("vectorized" — see _deliver_vectorized_target
        # below). "auto" resolves to the same platform default the
        # engine resolves, so default-config engine↔shadow pairs always
        # agree on the order.
        if deliver_shape == "auto":
            from .state import default_deliver_shape

            deliver_shape = default_deliver_shape()
        self.deliver_shape = deliver_shape
        self.r = num_replicas
        self.nodes: List[RawNode] = []
        lrn = {s + 1 for s in learners}
        for slot in range(num_replicas):
            storage = MemoryStorage()
            # Bootstrap the full-voter config the way the batched engine
            # does: membership is initial state, not replayed conf changes.
            storage._snapshot.metadata.conf_state = ConfState(
                voters=[i for i in range(1, num_replicas + 1)
                        if i not in lrn],
                learners=sorted(lrn),
            )
            cfg = Config(
                id=slot + 1,
                election_tick=election_timeout,
                heartbeat_tick=heartbeat_timeout,
                storage=storage,
                max_size_per_msg=1 << 62,
                max_inflight_msgs=max_inflight,
                pre_vote=pre_vote,
                rand=(DeviceHashRand(group * num_replicas + slot)
                      if deterministic_timeouts else None),
            )
            self.nodes.append(RawNode(cfg))
        self.auto_compact_window = auto_compact_window
        # Device per-message entry cap: an append exceeding it cannot
        # fit the device's one send per round, so it is an envelope
        # error, never a silent truncation.
        self.max_ents = max_ents
        # inbox[target][sender][kind]
        self.inbox: List[List[List[Optional[Message]]]] = self._empty_inbox()

    def _empty_inbox(self):
        return [
            [[None] * NUM_KINDS for _ in range(self.r)] for _ in range(self.r)
        ]

    def round(
        self,
        campaigns: Sequence[int] = (),
        proposals: Optional[Dict[int, int]] = None,
        tick: bool = False,
        isolate: Iterable[int] = (),
        transfers: Optional[Dict[int, int]] = None,
        drop_pairs: Iterable[Tuple[int, int]] = (),
        reads: Iterable[int] = (),
    ) -> None:
        """One round with the device's phase order:
        deliver → tick/campaign → control → propose → emit.
        `transfers` maps leader slot → target slot; `drop_pairs` drops
        (sender, target) directed edges at emit — partial partitions;
        `reads` opens a ReadIndex request on each slot that leads (the
        device's read_req, a no-op on non-leaders; an addition to the
        reference's copy, which drives no reads)."""
        iso = set(isolate)
        proposals = proposals or {}
        transfers = transfers or {}
        drops = set(drop_pairs)

        # Phase 1: deliver in the exact order of the device's
        # configured deliver shape (step.py _deliver_all): kind-major
        # for the six lane scans ("lanes"), request/response halves
        # sender-major for the two merged scans ("merged"), or the
        # vectorized order contract ("vectorized").
        if self.deliver_shape == "merged":
            order = [
                (sender, kind)
                for kinds in (range(0, 3), range(3, NUM_KINDS))
                for sender in range(self.r)
                for kind in kinds
            ]
        else:  # "lanes" (the vectorized path orders per target below)
            order = [
                (sender, kind)
                for kind in range(NUM_KINDS)
                for sender in range(self.r)
            ]
        inbox, self.inbox = self.inbox, self._empty_inbox()
        for target in range(self.r):
            if target in iso:
                continue
            if self.deliver_shape == "vectorized":
                self._deliver_vectorized_target(target, inbox[target])
                continue
            for sender, kind in order:
                m = inbox[target][sender][kind]
                if m is None:
                    continue
                try:
                    self.nodes[target].step(m)
                except RaftError:
                    pass

        # Phase 2: tick / explicit campaigns.
        if tick:
            for node in self.nodes:
                node.tick()
        for slot in campaigns:
            self.nodes[slot].campaign()

        # Phase 2b: host control ops, same slot order as the device's
        # _control phase (after tick, before propose).
        for slot, target in transfers.items():
            try:
                self.nodes[slot].transfer_leader(target + 1)
            except RaftError:
                pass
        for slot in reads:
            node = self.nodes[slot]
            if node.raft.state == StateType.StateLeader:
                node.read_index(b"read")

        # Phase 3: proposals (empty payloads; the batched engine carries
        # payloads in the host arena, so terms are the shared content).
        # All n entries ride one MsgProp — the batched engine appends
        # its per-round proposals as one batch with one broadcast.
        from ..raft.types import Entry

        for slot, n in proposals.items():
            if n <= 0:
                continue
            node = self.nodes[slot]
            try:
                node.raft.step(
                    Message(
                        type=MessageType.MsgProp,
                        from_=node.raft.id,
                        entries=[Entry(data=b"") for _ in range(n)],
                    )
                )
            except RaftError:
                pass

        # Phase 4a: persist — take every node's Ready and store
        # hardstate/snapshot/entries FIRST, so the compaction and the
        # send materialization below see this round's log.
        readys: List[Tuple[int, object]] = []
        for slot, node in enumerate(self.nodes):
            if not node.has_ready():
                continue
            rd = node.ready()
            storage = node.raft.raft_log.storage
            if rd.hard_state.term or rd.hard_state.vote or rd.hard_state.commit:
                storage.set_hard_state(rd.hard_state)
            if rd.snapshot.metadata.index > 0:
                # Installed snapshot persists before entries
                # (the production drain order, etcdserver/raft.go).
                storage.apply_snapshot(rd.snapshot)
            storage.append(rd.entries)
            readys.append((slot, rd))

        # Phase 4b: auto-compaction emulation — the device compacts at
        # the top of _emit with this round's commit and log, and its
        # append-vs-snapshot decision sees the new floor (step.py
        # _emit auto_compact then snap_needed).
        if self.auto_compact_window:
            keep = self.auto_compact_window // 2
            for node in self.nodes:
                r = node.raft
                st = r.raft_log.storage
                target = min(
                    r.raft_log.committed, st.last_index() - keep
                )
                if target > st.first_index() - 1:
                    st.create_snapshot(target, None, b"")
                    st.compact(target)

        # Phase 4c: emit — bucket outbound messages, device-coalesced.
        for slot, rd in readys:
            node = self.nodes[slot]
            for m in rd.messages:
                if slot in iso:
                    continue
                m = self._rematerialize(node, m)
                kind = _TYPE_TO_KIND.get(m.type)
                if kind is None:
                    raise AssertionError(f"unroutable message type {m.type}")
                target = m.to - 1
                if (slot, target) in drops:
                    continue
                prev = self.inbox[target][slot][kind]
                if prev is not None:
                    # The device coalesces same-round sends into one
                    # flag; the oracle may emit duplicates (hb-resp and
                    # app-resp both probing) or split one logical
                    # append across two messages (commit bcast +
                    # proposal bcast in one Ready). Coalesce both
                    # shapes; anything else is a real violation.
                    if _same_message(prev, m):
                        continue
                    merged = _merge_apps(prev, m)
                    if merged is not None and (
                        self.max_ents is None
                        or len(merged.entries) <= self.max_ents
                    ):
                        self.inbox[target][slot][kind] = merged
                        continue
                    # A snapshot supersedes an append in the same lane,
                    # exactly like the device's emit (snap_needed
                    # overrides the append send).
                    kinds = {prev.type, m.type}
                    if MessageType.MsgSnap in kinds and kinds <= {
                        MessageType.MsgSnap, MessageType.MsgApp
                    }:
                        snaps = [x for x in (prev, m)
                                 if x.type == MessageType.MsgSnap]
                        best = max(snaps,
                                   key=lambda x: x.snapshot.metadata.index)
                        self.inbox[target][slot][kind] = best
                        continue
                    raise AssertionError(
                        f"slot collision: {m.type} from {slot} to {target}; "
                        "schedule outside the differential envelope"
                    )
                self.inbox[target][slot][kind] = m
        for slot, rd in readys:
            self.nodes[slot].advance(rd)


    def _deliver_vectorized_target(self, target: int, msgs) -> None:
        """One target's inbox in the vectorized shape's order contract
        (step.py _deliver_vectorized): lanes in kind order; within the
        vote lane every T_VOTE (term desc, sender asc) before every
        T_PREVOTE (prevotes never mutate state); within the other
        request lanes the winner (term desc, sender asc) first, losers
        after — a loser the winner has not made stale would apply here
        but is dropped on device, so it raises as an envelope
        violation (two leaders at one term cannot exist in-protocol);
        within response lanes same-term effects first (commutative),
        then deposing messages ascending by term."""
        node = self.nodes[target]

        def step(m: Message) -> None:
            try:
                node.step(m)
            except RaftError:
                pass

        def lane(kind):
            return [(s, msgs[s][kind]) for s in range(self.r)
                    if msgs[s][kind] is not None]

        votes = sorted(
            (x for x in lane(KIND_VOTE)
             if x[1].type == MessageType.MsgVote),
            key=lambda sm: (-sm[1].term, sm[0]))
        pres = [x for x in lane(KIND_VOTE)
                if x[1].type != MessageType.MsgVote]
        for _, m in votes + pres:
            step(m)

        for kind in (KIND_APP, KIND_HB):
            ordered = sorted(lane(kind),
                             key=lambda sm: (-sm[1].term, sm[0]))
            for i, (sender, m) in enumerate(ordered):
                if i > 0 and m.term >= node.raft.term:
                    raise AssertionError(
                        f"vectorized deliver: request-lane loser from "
                        f"{sender} at term {m.term} not stale against "
                        f"the winner (node term {node.raft.term}); "
                        "schedule outside the vectorized envelope")
                step(m)

        for kind in (KIND_VOTE_RESP, KIND_APP_RESP, KIND_HB_RESP):
            t0 = node.raft.term
            eff, dep = [], []
            for s, m in lane(kind):
                deposes = m.term > t0 and not (
                    m.type == MessageType.MsgPreVoteResp and not m.reject)
                (dep if deposes else eff).append((s, m))
            dep.sort(key=lambda sm: (sm[1].term, sm[0]))
            for _, m in eff + dep:
                step(m)

    def _rematerialize(self, node: RawNode, m: Message) -> Message:
        """The device remembers only a send FLAG per peer and derives
        append content at emit time (end of round); the oracle bakes
        content at queue time (mid-deliver). Re-slice outbound MsgApp
        entries and commit from the sender's end-of-round log so both
        models emit identical bytes (e.g. a probe queued before this
        round's proposals still carries them)."""
        from ..raft.raft import StateType

        r = node.raft
        if (
            m.type != MessageType.MsgApp
            or m.term != r.term
            or r.state != StateType.StateLeader
        ):
            return m
        # Below the (just-advanced) floor the device sends a snapshot
        # instead (step.py _emit snap_needed after auto-compaction).
        floor = r.raft_log.storage.first_index() - 1
        if m.index < floor:
            snap = r.raft_log.storage.snapshot()
            return Message(
                type=MessageType.MsgSnap, to=m.to, from_=m.from_,
                term=m.term, snapshot=snap,
            )
        last = r.raft_log.last_index()
        want = last - m.index
        if self.max_ents is not None and want > self.max_ents:
            raise AssertionError(
                f"append of {want} entries exceeds the device cap "
                f"{self.max_ents}; schedule outside the differential "
                "envelope")
        if want <= len(m.entries) and m.commit == r.raft_log.committed:
            return m
        try:
            ents = r.raft_log.slice(m.index + 1, m.index + 1 + want, 1 << 62)
        except RaftError:
            return m
        return Message(
            type=m.type, to=m.to, from_=m.from_, term=m.term,
            log_term=m.log_term, index=m.index, entries=ents,
            commit=r.raft_log.committed,
        )

    # -- state vector for comparison ------------------------------------------

    def snapshot_state(self) -> List[Tuple[int, ...]]:
        """(term, role, lead, commit, last) per replica — the fields the
        batched engine must reproduce exactly."""
        out = []
        for node in self.nodes:
            r = node.raft
            out.append(
                (
                    r.term,
                    int(r.state),
                    r.lead,
                    r.raft_log.committed,
                    r.raft_log.last_index(),
                )
            )
        return out

    def log_terms(self, slot: int) -> List[Tuple[int, int]]:
        r = self.nodes[slot].raft
        lo = r.raft_log.first_index()
        hi = r.raft_log.last_index()
        return [(i, r.raft_log.term(i)) for i in range(lo, hi + 1)]
