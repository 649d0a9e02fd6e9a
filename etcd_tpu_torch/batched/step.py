"""The batched round: branch-free message handlers over the instance
axis, with an all-device message router, in PyTorch.

Ports ``etcd_tpu/batched/step.py`` with its three deliver shapes: the
scan-free ``"vectorized"`` fold and the sender scans ``"lanes"`` and
``"merged"``. The JAX module writes each handler for one instance and
maps it with ``jax.vmap``; here every function takes the whole batch
with the instance axis first: a per-instance scalar is ``[N]``, a
per-peer row ``[N, R]``, one lane of the inbox ``[N, R]`` per field
(``[N, R, E]`` for entry terms). Semantics mirror the single-group
oracle (ref: raft/raft.go Step/stepLeader/stepCandidate/stepFollower).

Network model: per round each replica sends at most one message of each
KIND to each peer, so an inbox is a dense ``[N, R, K]`` slot array and
routing between the instances of a group is one transpose of the
(sender, target) axes. A round is:

    deliver (cfg.deliver_shape) → tick → control → propose → emit
    → route

With ``cfg.telemetry`` / ``cfg.fleet_summary`` the round also emits
the telemetry frame (per-instance counters and invariant bits) and the
fleet summary frame (one flat [L] vector of cross-row reductions):
pure reads of the round's inputs and outputs, so protocol state is the
same with the planes on or off.

The quorum and term sites call kernels.joint_committed /
joint_vote_result / term_at, which launch the Hopper kernels on CUDA
tensors. Every handler runs on every instance every round and its
effect is selected per instance, as under vmap; the tensors of a state
are never written in place.

Determinism: randomized election timeouts use a per-instance hash of
(instance id, reset count) (ref: raft.go:1718-1720).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..obs.fleet import FLEET_BUCKETS, FleetLayout
from .kernels import (
    VOTE_LOST,
    VOTE_WON,
    find_conflict_by_term,
    invariant_bits,
    joint_committed,
    joint_vote_result,
    log_bucket_counts,
    log_bucket_counts_masked,
    ring_write,
    ring_write_masked,
    term_at,
)
from .state import (
    CANDIDATE,
    FOLLOWER,
    LEADER,
    PRECANDIDATE,
    PROBE,
    REPLICATE,
    SNAPSHOT,
    BatchedConfig,
    BatchedState,
    I32,
    narrow_state,
    resolve_device,
    widen_state,
)
from .telemetry import NUM_COUNTERS

# Message kinds = inbox slot layout. THE INBOX LANE-ORDER CONTRACT: the
# first NUM_REQ_KINDS lanes carry requests, and the response to a
# kind-k request routes back in lane ``k + NUM_REQ_KINDS``.
KIND_VOTE, KIND_APP, KIND_HB, KIND_VOTE_RESP, KIND_APP_RESP, KIND_HB_RESP = range(6)
NUM_KINDS = 6
NUM_REQ_KINDS = 3

# Wire types (values match the raft MessageType enum).
T_APP, T_APP_RESP = 3, 4
T_VOTE, T_VOTE_RESP = 5, 6
T_SNAP = 7
T_HB, T_HB_RESP = 8, 9
T_TIMEOUT_NOW = 14
T_PREVOTE, T_PREVOTE_RESP = 17, 18

# Wire type -> inbox lane; -1 marks unroutable types.
NUM_WIRE_TYPES = 32
LANE_OF = np.full(NUM_WIRE_TYPES, -1, np.int8)
for _t, _lane in (
    (T_VOTE, KIND_VOTE), (T_PREVOTE, KIND_VOTE),
    (T_APP, KIND_APP), (T_SNAP, KIND_APP),
    (T_HB, KIND_HB), (T_TIMEOUT_NOW, KIND_HB),
    (T_VOTE_RESP, KIND_VOTE_RESP), (T_PREVOTE_RESP, KIND_VOTE_RESP),
    (T_APP_RESP, KIND_APP_RESP),
    (T_HB_RESP, KIND_HB_RESP),
):
    LANE_OF[_t] = _lane


class MsgSlots(NamedTuple):
    """SoA message batch; every field has the same leading shape, plus
    ent_terms with a trailing [E]."""

    valid: torch.Tensor  # bool
    type: torch.Tensor  # i32
    term: torch.Tensor  # i32
    log_term: torch.Tensor  # i32
    index: torch.Tensor  # i32
    commit: torch.Tensor  # i32
    reject: torch.Tensor  # bool
    reject_hint: torch.Tensor  # i32
    n_ents: torch.Tensor  # i32
    # Context word: campaign-transfer flag on votes, read_seq on
    # heartbeats and their acks (ref: raft.go campaignTransfer,
    # read_only.go ctx).
    ctx: torch.Tensor  # i32
    ent_terms: torch.Tensor  # i32 [..., E]


# Narrow storage dtype per bounded message lane (cfg.narrow_lanes):
# wire types are < 32 (int8), entry counts <= 255 (int16).
NARROW_MSG_DTYPES = {
    "type": torch.int8,
    "n_ents": torch.int16,
}


def narrow_msgs(m: MsgSlots) -> MsgSlots:
    """Cast the bounded message lanes to their narrow storage dtypes."""
    return m._replace(**{
        f: getattr(m, f).to(dt) for f, dt in NARROW_MSG_DTYPES.items()
    })


def widen_msgs(m: MsgSlots) -> MsgSlots:
    """Cast narrow message lanes back to int32 for the round."""
    return m._replace(**{f: getattr(m, f).to(I32) for f in NARROW_MSG_DTYPES})


def empty_msgs(shape: Tuple[int, ...], num_ents: int, narrow: bool = False,
               device=None) -> MsgSlots:
    """All-zero (all-invalid) messages of the given leading shape."""
    dev = resolve_device(device)
    z = lambda: torch.zeros(shape, dtype=I32, device=dev)  # noqa: E731
    f = lambda: torch.zeros(shape, dtype=torch.bool, device=dev)  # noqa: E731
    m = MsgSlots(
        valid=f(), type=z(), term=z(), log_term=z(), index=z(), commit=z(),
        reject=f(), reject_hint=z(), n_ents=z(), ctx=z(),
        ent_terms=torch.zeros(shape + (num_ents,), dtype=I32, device=dev),
    )
    return narrow_msgs(m) if narrow else m


# -----------------------------------------------------------------------------
# Batch helpers
# -----------------------------------------------------------------------------


class Ids(NamedTuple):
    """Per-round row identities: global instance id and replica slot of
    each row, and the peer-axis constants derived from them."""

    iid: torch.Tensor  # [N] i32
    slot: torch.Tensor  # [N] i32
    peers: torch.Tensor  # [R] i32
    is_self: torch.Tensor  # [N, R] bool: peers == slot


def make_ids(iids: torch.Tensor, slots: torch.Tensor, r: int) -> Ids:
    peers = torch.arange(r, dtype=I32, device=iids.device)
    return Ids(iids, slots, peers, peers == slots.unsqueeze(-1))


def _col(x: torch.Tensor) -> torch.Tensor:
    """[N] → [N, 1]: a per-instance scalar against a per-peer row."""
    return x.unsqueeze(-1)


def _sel(cond: torch.Tensor, a, b):
    """Fieldwise where(cond, a, b) for a NamedTuple of tensors, with the
    [N] condition broadcast to each field's rank. A field that is the
    same tensor in a and b passes through."""
    return type(a)(*(
        x if x is y else torch.where(
            cond.view(cond.shape + (1,) * (x.dim() - 1)), x, y)
        for x, y in zip(a, b)))


def _choose(cond: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """where(cond, a, b) for two integer constants, as int32."""
    return torch.full(cond.shape, b, dtype=I32,
                      device=cond.device).masked_fill(cond, a)


def _pick(vec: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
    """vec[n, s] of an int32 row for a one-hot mask `at` [N, R]; 0 when
    `at` is empty."""
    return torch.where(at, vec, 0).sum(-1, dtype=I32)


def _pick_b(vec: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
    """vec[n, s] of a bool row for a one-hot mask `at` [N, R]; False
    when `at` is empty."""
    return (vec & at).any(-1)


def _argfirst(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first set bit of each [.., R] bool row (0 if none)."""
    return mask.to(I32).argmax(-1).to(I32)


def _ta(st: BatchedState, i: torch.Tensor) -> torch.Tensor:
    return term_at(st.log_term, st.snap_index, st.snap_term, st.last, i)


# -----------------------------------------------------------------------------
# Primitive transitions. Each returns a full BatchedState.
# -----------------------------------------------------------------------------


def _rand_timeout(cfg: BatchedConfig, iid, reset_count):
    """Deterministic stand-in for lockedRand: [et, 2et-1], reproducible
    by the host oracle. Relies on int32 wraparound, as the reference
    hash does."""
    h = ((iid + 1) * 7919 + reset_count * 104729) % cfg.election_timeout
    return cfg.election_timeout + h


def _reset(cfg: BatchedConfig, st: BatchedState, ids: Ids,
           term: torch.Tensor) -> BatchedState:
    """ref: raft.go:590-619 reset()."""
    changed = st.term != term
    rc = st.reset_count + 1
    return st._replace(
        term=term,
        vote=torch.where(changed, 0, st.vote),
        lead=torch.zeros_like(st.lead),
        election_elapsed=torch.zeros_like(st.election_elapsed),
        heartbeat_elapsed=torch.zeros_like(st.heartbeat_elapsed),
        reset_count=rc,
        randomized_timeout=_rand_timeout(cfg, ids.iid, rc),
        votes=torch.full_like(st.votes, -1),
        match=torch.where(ids.is_self, _col(st.last), 0),
        next=(_col(st.last) + 1).expand(st.next.shape).contiguous(),
        pr_state=torch.full_like(st.pr_state, PROBE),
        probe_sent=torch.zeros_like(st.probe_sent),
        pending_snapshot=torch.zeros_like(st.pending_snapshot),
        recent_active=torch.zeros_like(st.recent_active),
        inflight=torch.zeros_like(st.inflight),
        # abortLeaderTransfer + read state dies with the term/role.
        transferee=torch.zeros_like(st.transferee),
        transfer_sent=torch.zeros_like(st.transfer_sent),
        read_index=torch.full_like(st.read_index, -1),
        read_acks=torch.zeros_like(st.read_acks),
        read_ready=torch.zeros_like(st.read_ready),
        read_req_latch=torch.zeros_like(st.read_req_latch),
    )


def _become_follower(cfg, st, ids, term, lead) -> BatchedState:
    st = _reset(cfg, st, ids, term)
    return st._replace(role=torch.full_like(st.role, FOLLOWER), lead=lead)


def _maybe_commit(st: BatchedState) -> BatchedState:
    """Quorum commit-index advancement — THE replica-axis reduction
    (ref: raft.go:585-588 + quorum/majority.go:126, joint.go:49-56)."""
    mci = joint_committed(st.match, st.voter, st.voter_out, st.in_joint)
    ok = (mci > st.commit) & (_ta(st, mci) == st.term)
    return st._replace(commit=torch.where(ok, mci, st.commit))


def _append_own(cfg: BatchedConfig, st: BatchedState, ids: Ids,
                n: torch.Tensor) -> BatchedState:
    """Leader appends n [N] entries of its own term (ref:
    raft.go:621-642 appendEntry): ring write, self progress,
    maybe_commit."""
    p = cfg.max_props_per_round
    terms = _col(st.term).expand(st.term.shape[0], p)
    log = ring_write(st.log_term, st.last + 1, terms, n)
    last = st.last + n
    match = torch.where(ids.is_self, torch.maximum(st.match, _col(last)),
                        st.match)
    nxt = torch.where(ids.is_self, torch.maximum(st.next, _col(last) + 1),
                      st.next)
    st = st._replace(log_term=log, last=last, match=match, next=nxt)
    return _maybe_commit(st)


def _repl_targets(st: BatchedState) -> torch.Tensor:
    """[N, R] replication set: voters of both configs plus learners."""
    return st.voter | st.voter_out | st.learner


def _vote_targets(st: BatchedState) -> torch.Tensor:
    """[N, R] electorate: voters of both halves, never learners."""
    return st.voter | st.voter_out


def _become_leader(cfg, st, ids) -> BatchedState:
    """ref: raft.go:724-758 (reset, self replicate, append empty entry)."""
    st = _reset(cfg, st, ids, st.term)
    st = st._replace(
        role=torch.full_like(st.role, LEADER),
        lead=ids.slot + 1,
        pr_state=torch.where(ids.is_self, REPLICATE, st.pr_state),
    )
    return _append_own(cfg, st, ids, torch.ones_like(st.term))


def _record_own_vote_and_tally(st: BatchedState, ids: Ids):
    """tracker.go RecordVote (setdefault) of a granted self-vote +
    TallyVotes."""
    votes = torch.where(ids.is_self & (st.votes == -1), 1, st.votes)
    st = st._replace(votes=votes)
    return st, joint_vote_result(votes, st.voter, st.voter_out, st.in_joint)


def _record_vote_and_tally(st: BatchedState, ids: Ids,
                           from_slot: torch.Tensor, granted: torch.Tensor):
    """ref: tracker.go RecordVote (setdefault) of sender `from_slot`'s
    vote [N] + TallyVotes."""
    at = ids.peers == _col(from_slot)
    votes = torch.where(at & (st.votes == -1), _col(granted.to(I32)),
                        st.votes)
    st = st._replace(votes=votes)
    return st, joint_vote_result(votes, st.voter, st.voter_out, st.in_joint)


def _campaign(cfg: BatchedConfig, st: BatchedState, ids: Ids, pre: bool,
              transfer: bool = False) -> BatchedState:
    """ref: raft.go:785-835; `pre`/`transfer` are static (config.pre_vote;
    campaignTransfer skips pre-vote and marks its vote requests to
    pierce leader leases)."""
    if pre:
        # becomePreCandidate: no term bump, no vote change.
        st1 = st._replace(
            role=torch.full_like(st.role, PRECANDIDATE),
            lead=torch.zeros_like(st.lead),
            votes=torch.full_like(st.votes, -1),
        )
    else:
        st1 = _reset(cfg, st, ids, st.term + 1)
        st1 = st1._replace(role=torch.full_like(st.role, CANDIDATE),
                           vote=ids.slot + 1)
    st1, res = _record_own_vote_and_tally(st1, ids)
    won = res == VOTE_WON
    if pre:
        # Single-voter group: pre-vote win chains into the real election.
        st_won = _campaign(cfg, st1, ids, False)
    else:
        st_won = _become_leader(cfg, st1, ids)
    st_lost = st1._replace(
        send_vote_req=torch.ones_like(st.send_vote_req),
        vote_req_is_pre=torch.full_like(st.vote_req_is_pre, pre),
        vote_req_transfer=torch.full_like(st.vote_req_transfer, transfer),
    )
    return _sel(won, st_won, st_lost)


def _paused(cfg: BatchedConfig, st: BatchedState) -> torch.Tensor:
    """[N, R] bool — ref: tracker/progress.go:201-212 IsPaused."""
    return torch.where(
        st.pr_state == PROBE,
        st.probe_sent,
        (st.pr_state != REPLICATE) | (st.inflight >= cfg.max_inflight),
    )


# -----------------------------------------------------------------------------
# Per-message delivery (one message per instance: [N] fields)
# -----------------------------------------------------------------------------


def _term_gate(cfg: BatchedConfig, ids: Ids, st: BatchedState, m: MsgSlots,
               from_slot: torch.Tensor):
    """raft.Step's term handling (ref: raft.go:849-920). Returns
    (st1, dead, lower): st1 is the post-become-follower state, `dead`
    kills the message entirely, `lower` routes to the stale path."""
    higher = m.term > st.term
    lower = m.term < st.term
    from_leader_type = (m.type == T_APP) | (m.type == T_HB) | (m.type == T_SNAP)
    is_vote_req = (m.type == T_VOTE) | (m.type == T_PREVOTE)
    if cfg.check_quorum:
        in_lease = (st.lead != 0) & (
            st.election_elapsed < cfg.election_timeout)
    else:
        in_lease = torch.zeros_like(higher)
    # Transfer-campaign votes pierce the lease (ref: raft.go:870-880).
    ignore_lease = higher & is_vote_req & in_lease & ~(m.ctx == 1)
    keep_term = (m.type == T_PREVOTE) | (
        (m.type == T_PREVOTE_RESP) & ~m.reject)
    do_become = higher & ~keep_term & ~ignore_lease
    st_b = _become_follower(cfg, st, ids, m.term,
                            torch.where(from_leader_type, from_slot + 1, 0))
    st1 = _sel(do_become, st_b, st)
    dead = ~m.valid | ignore_lease
    return st1, dead, lower


def _leader_traffic_prelude(cfg, ids, st1, m, from_slot):
    """Candidate step-down + follower bookkeeping shared by the APP and
    HB lanes (ref: raft.go:1390-1398, 1433-1444)."""
    is_cand = (st1.role == CANDIDATE) | (st1.role == PRECANDIDATE)
    st_f = _sel(is_cand,
                _become_follower(cfg, st1, ids, m.term, from_slot + 1), st1)
    return st_f._replace(
        election_elapsed=torch.zeros_like(st1.election_elapsed),
        lead=from_slot + 1,
    )


def _no_resp(cfg: BatchedConfig, like: torch.Tensor) -> MsgSlots:
    return empty_msgs(tuple(like.shape), cfg.max_ents_per_msg,
                      device=like.device)


# -- lane handlers: each processes ONE inbox lane's message from one
# sender for every instance, implementing only the types that can land
# in that lane (ref: raft.go:991-1473 step* dispatch). The request
# handlers return (state, response); the response handlers the state.


def _lane_vote(cfg: BatchedConfig, ids: Ids, st: BatchedState, m: MsgSlots,
               from_slot):
    """Lane KIND_VOTE: T_VOTE / T_PREVOTE requests (ref: raft.go:930-978)."""
    no_resp = _no_resp(cfg, st.term)
    st1, dead, lower = _term_gate(cfg, ids, st, m, from_slot)

    last_term = _ta(st1, st1.last)
    can_vote = (
        (st1.vote == from_slot + 1)
        | ((st1.vote == 0) & (st1.lead == 0))
        | ((m.type == T_PREVOTE) & (m.term > st1.term))
    )
    up_to_date = (m.log_term > last_term) | (
        (m.log_term == last_term) & (m.index >= st1.last))
    # Durability-fenced instances grant nothing (vote or pre-vote).
    grant = can_vote & up_to_date & ~st1.fenced
    vote_resp = no_resp._replace(
        valid=torch.ones_like(no_resp.valid),
        type=_choose(m.type == T_VOTE, T_VOTE_RESP, T_PREVOTE_RESP),
        term=torch.where(grant, m.term, st1.term),
        reject=~grant,
    )
    record_real = grant & (m.type == T_VOTE)
    st_vote = st1._replace(
        election_elapsed=torch.where(record_real, 0, st1.election_elapsed),
        vote=torch.where(record_real, from_slot + 1, st1.vote),
    )

    # Stale pre-vote: reject with our term (deposes the sender).
    stale_prevote = lower & (m.type == T_PREVOTE)
    resp_stale = no_resp._replace(
        valid=stale_prevote,
        type=torch.full_like(no_resp.type, T_PREVOTE_RESP),
        term=st.term,
        reject=torch.ones_like(no_resp.reject),
    )
    st_out = _sel(dead | lower, st, st_vote)
    resp = _sel(dead, no_resp, _sel(lower, resp_stale, vote_resp))
    return st_out, resp


def _lane_app(cfg: BatchedConfig, ids: Ids, st: BatchedState, m: MsgSlots,
              from_slot):
    """Lane KIND_APP: T_APP / T_SNAP (ref: raft.go:1475-1614)."""
    no_resp = _no_resp(cfg, st.term)
    st1, dead, lower = _term_gate(cfg, ids, st, m, from_slot)

    fol = _leader_traffic_prelude(cfg, ids, st1, m, from_slot)
    st_app, app_resp = _handle_append(cfg, fol, m)
    st_snap, snap_resp = _handle_snapshot(cfg, fol, m)
    is_snap = m.type == T_SNAP
    leader_traffic_ok = st1.role != LEADER
    st_live = _sel(is_snap, st_snap, st_app)
    resp_live = _sel(is_snap, snap_resp, app_resp)
    st_live = _sel(leader_traffic_ok, st_live, st1)
    resp_live = _sel(leader_traffic_ok, resp_live, no_resp)

    # Stale leader: nudge with an empty MsgAppResp carrying our term
    # (ref: raft.go:885-905).
    stale = lower & (cfg.check_quorum or cfg.pre_vote)
    resp_stale = no_resp._replace(
        valid=stale, type=torch.full_like(no_resp.type, T_APP_RESP),
        term=st.term)
    st_out = _sel(dead | lower, st, st_live)
    resp = _sel(dead, no_resp, _sel(lower, resp_stale, resp_live))
    return st_out, resp


def _lane_hb(cfg: BatchedConfig, ids: Ids, st: BatchedState, m: MsgSlots,
             from_slot):
    """Lane KIND_HB: T_HB + T_TIMEOUT_NOW (ref: raft.go:1513;
    :1465-1472 MsgTimeoutNow → immediate transfer campaign)."""
    no_resp = _no_resp(cfg, st.term)
    st1, dead, lower = _term_gate(cfg, ids, st, m, from_slot)

    fol = _leader_traffic_prelude(cfg, ids, st1, m, from_slot)
    st_hb = fol._replace(
        commit=torch.maximum(fol.commit, torch.minimum(m.commit, fol.last)))
    hb_resp = no_resp._replace(
        valid=torch.ones_like(no_resp.valid),
        type=torch.full_like(no_resp.type, T_HB_RESP), term=fol.term,
        ctx=m.ctx,  # ReadIndex ack context echo (read_only.go recvAck)
    )
    leader_traffic_ok = st1.role != LEADER

    # MsgTimeoutNow: campaign at once; only promotable, unfenced
    # instances honor it (raft.go:1465-1472 + hup gating).
    is_ton = m.type == T_TIMEOUT_NOW
    promotable = _pick_b(_vote_targets(st1), ids.is_self)
    st_ton = _campaign(cfg, st1, ids, False, transfer=True)

    st_live = _sel(leader_traffic_ok,
                   _sel(is_ton & promotable & ~st1.fenced, st_ton, st_hb),
                   st1)
    resp_live = _sel(leader_traffic_ok & ~is_ton, hb_resp, no_resp)

    stale = lower & (cfg.check_quorum or cfg.pre_vote) & ~is_ton
    resp_stale = no_resp._replace(
        valid=stale, type=torch.full_like(no_resp.type, T_APP_RESP),
        term=st.term)
    st_out = _sel(dead | lower, st, st_live)
    resp = _sel(dead, no_resp, _sel(lower, resp_stale, resp_live))
    return st_out, resp


def _handle_append(cfg: BatchedConfig, st: BatchedState, m: MsgSlots):
    """Follower append handling (ref: raft.go:1475-1511 +
    log.go maybeAppend/findConflict)."""
    e = cfg.max_ents_per_msg
    no_resp = _no_resp(cfg, st.term)
    prev = m.index
    ok_type = torch.full_like(no_resp.type, T_APP_RESP)
    yes = torch.ones_like(no_resp.valid)

    # Fast path: stale append below commit acks the commit index.
    below_commit = prev < st.commit
    resp_below = no_resp._replace(valid=yes, type=ok_type, index=st.commit,
                                  term=st.term)

    match_ok = _ta(st, prev) == m.log_term

    j = torch.arange(e, dtype=I32, device=prev.device)
    idx = _col(prev) + 1 + j  # [N, E]
    have = j < _col(m.n_ents)
    existing = _ta(st, idx)
    conflict = have & ((idx > _col(st.last)) | (existing != m.ent_terms))
    any_conflict = conflict.any(-1)
    ci = _argfirst(conflict)  # first conflicting offset

    write_mask = have & (j >= _col(ci)) & _col(any_conflict)
    log = ring_write_masked(st.log_term, prev + 1, m.ent_terms, write_mask)
    last = torch.where(any_conflict, prev + m.n_ents, st.last)
    lastnewi = prev + m.n_ents
    commit = torch.maximum(st.commit, torch.minimum(m.commit, lastnewi))
    st_ok = st._replace(log_term=log, last=last, commit=commit)
    resp_ok = no_resp._replace(valid=yes, type=ok_type, index=lastnewi,
                               term=st.term)

    # Reject with a term-skipping hint (ref: raft.go:1487-1509).
    hint0 = torch.minimum(prev, st.last)
    hint = find_conflict_by_term(st.log_term, st.snap_index, st.snap_term,
                                 st.last, hint0, m.log_term)
    resp_rej = no_resp._replace(
        valid=yes, type=ok_type, index=prev, reject=yes, reject_hint=hint,
        log_term=_ta(st, hint), term=st.term)

    st_out = _sel(below_commit, st, _sel(match_ok, st_ok, st))
    resp = _sel(below_commit, resp_below, _sel(match_ok, resp_ok, resp_rej))
    return st_out, resp


def _handle_snapshot(cfg: BatchedConfig, st: BatchedState, m: MsgSlots):
    """Follower snapshot install (ref: raft.go:1518-1614 restore).
    m.index/m.log_term carry the snapshot (index, term)."""
    no_resp = _no_resp(cfg, st.term)
    ignore = m.index <= st.commit
    fast_forward = _ta(st, m.index) == m.log_term

    st_ff = st._replace(commit=torch.maximum(st.commit, m.index))
    st_restore = st._replace(
        log_term=torch.zeros_like(st.log_term),
        snap_index=m.index,
        snap_term=m.log_term,
        last=m.index,
        commit=m.index,
    )
    restored = ~ignore & ~fast_forward
    st_out = _sel(ignore, st, _sel(fast_forward, st_ff, st_restore))
    resp = no_resp._replace(
        valid=torch.ones_like(no_resp.valid),
        type=torch.full_like(no_resp.type, T_APP_RESP),
        index=torch.where(restored, m.index, st_out.commit),
        term=st.term,
    )
    return st_out, resp


def _lane_vote_resp(cfg: BatchedConfig, ids: Ids, st: BatchedState,
                    m: MsgSlots, from_slot) -> BatchedState:
    """Lane KIND_VOTE_RESP: T_VOTE_RESP / T_PREVOTE_RESP
    (ref: raft.go:1399-1414)."""
    st1, dead, lower = _term_gate(cfg, ids, st, m, from_slot)
    is_cand = (st1.role == CANDIDATE) | (st1.role == PRECANDIDATE)
    my_resp_type = _choose(st1.role == PRECANDIDATE, T_PREVOTE_RESP,
                           T_VOTE_RESP)
    st_vr = _candidate_vote_resp(cfg, ids, st1, m, from_slot)
    st_live = _sel(is_cand & (m.type == my_resp_type), st_vr, st1)
    return _sel(dead | lower, st, st_live)


def _lane_app_resp(cfg: BatchedConfig, ids: Ids, st: BatchedState,
                   m: MsgSlots, from_slot) -> BatchedState:
    """Lane KIND_APP_RESP: T_APP_RESP (ref: raft.go:1106-1283)."""
    st1, dead, lower = _term_gate(cfg, ids, st, m, from_slot)
    is_leader = st1.role == LEADER
    st_ar = _leader_app_resp(cfg, ids, st1, m, from_slot)
    st_live = _sel(is_leader & (m.type == T_APP_RESP), st_ar, st1)
    return _sel(dead | lower, st, st_live)


def _lane_hb_resp(cfg: BatchedConfig, ids: Ids, st: BatchedState,
                  m: MsgSlots, from_slot) -> BatchedState:
    """Lane KIND_HB_RESP: T_HB_RESP, plus T_APP_RESP stale-leader nudges
    that route back in this lane (ref: raft.go:1284-1309)."""
    st1, dead, lower = _term_gate(cfg, ids, st, m, from_slot)
    is_leader = st1.role == LEADER
    st_hr = _leader_hb_resp(cfg, ids, st1, m, from_slot)
    st_ar = _leader_app_resp(cfg, ids, st1, m, from_slot)
    st_live = _sel(is_leader & (m.type == T_HB_RESP), st_hr, st1)
    st_live = _sel(is_leader & (m.type == T_APP_RESP), st_ar, st_live)
    return _sel(dead | lower, st, st_live)


def _leader_app_resp(cfg: BatchedConfig, ids: Ids, st: BatchedState,
                     m: MsgSlots, s: torch.Tensor) -> BatchedState:
    """Leader MsgAppResp handling from sender `s` [N]
    (ref: raft.go:1106-1283)."""
    at_s = ids.peers == _col(s)
    # Progress exists for voters and learners.
    prog_ok = _pick_b(_repl_targets(st), at_s)

    st = st._replace(recent_active=st.recent_active | at_s)

    # --- rejected: move next back using the hint (ref: raft.go:1130-1236) ---
    hint = torch.where(
        m.log_term > 0,
        find_conflict_by_term(st.log_term, st.snap_index, st.snap_term,
                              st.last, m.reject_hint, m.log_term),
        m.reject_hint)
    match_s, next_s = _pick(st.match, at_s), _pick(st.next, at_s)
    in_repl = _pick(st.pr_state, at_s) == REPLICATE
    stale_rej = torch.where(in_repl, m.index <= match_s,
                            next_s - 1 != m.index)
    dec_next = torch.where(in_repl, match_s + 1,
                           torch.minimum(m.index, hint + 1).clamp(min=1))
    # On a genuine rejection a replicating peer drops to probing. A
    # follower that rejects below our recorded match has lost entries it
    # once acked (a torn WAL tail): lowering match is always safe, so take
    # its evidence and let probing re-heal (the stale-high match repair).
    match_repair = at_s & _col(dec_next <= match_s)
    rej_repl = at_s & _col(in_repl)
    st_rej = st._replace(
        next=torch.where(at_s, _col(dec_next), st.next),
        match=torch.where(match_repair, _col(dec_next - 1), st.match),
        probe_sent=st.probe_sent & ~at_s,
        pr_state=torch.where(rej_repl, PROBE, st.pr_state),
        pending_snapshot=torch.where(rej_repl, 0, st.pending_snapshot),
        inflight=torch.where(rej_repl, 0, st.inflight),
        send_append=st.send_append | (at_s & _col(~stale_rej)),
    )
    st_rej = _sel(stale_rej, st, st_rej)

    # --- accepted: MaybeUpdate + state transitions + commit ---
    old_paused = _pick_b(_paused(cfg, st), at_s)
    updated = match_s < m.index
    match = torch.where(at_s, torch.maximum(st.match, _col(m.index)),
                        st.match)
    nxt = torch.where(at_s, torch.maximum(st.next, _col(m.index) + 1),
                      st.next)
    st_acc = st._replace(
        match=match,
        next=nxt,
        probe_sent=st.probe_sent & ~(at_s & _col(updated)),
    )
    pr_state_s = _pick(st.pr_state, at_s)
    new_match_s = torch.maximum(match_s, m.index)
    was_probe = pr_state_s == PROBE
    was_snap = (pr_state_s == SNAPSHOT) & (
        new_match_s >= _pick(st.pending_snapshot, at_s))
    to_repl = at_s & _col(updated & (was_probe | was_snap))
    st_acc = st_acc._replace(
        pr_state=torch.where(to_repl, REPLICATE, st_acc.pr_state),
        pending_snapshot=torch.where(to_repl, 0, st_acc.pending_snapshot),
        # count+watermark degeneration of FreeLE
        inflight=torch.where(at_s & _col(updated), 0, st_acc.inflight),
        next=torch.where(to_repl, _col(new_match_s) + 1, nxt),
    )
    committed_before = st_acc.commit
    st_acc = _maybe_commit(st_acc)
    advanced = st_acc.commit > committed_before
    # bcastAppend on commit advance; resend to a previously-paused peer;
    # keep draining while entries remain (ref: raft.go:1259-1276).
    more = st_acc.last >= _pick(st_acc.next, at_s)
    st_acc = st_acc._replace(send_append=torch.where(
        _col(advanced), st_acc.send_append | _repl_targets(st_acc),
        st_acc.send_append | (at_s & _col(old_paused | more))))
    st_acc = _sel(updated, st_acc, st)

    out = _sel(m.reject, st_rej, st_acc)
    return _sel(prog_ok, out, st)


def _leader_hb_resp(cfg: BatchedConfig, ids: Ids, st: BatchedState,
                    m: MsgSlots, s: torch.Tensor) -> BatchedState:
    """ref: raft.go:1284-1309, incl. the ReadIndex ack path
    (read_only.go:68 recvAck + :81 advance)."""
    at_s = ids.peers == _col(s)
    full = st.inflight >= cfg.max_inflight
    st2 = st._replace(
        recent_active=st.recent_active | at_s,
        probe_sent=st.probe_sent & ~at_s,
        inflight=torch.where(at_s & (st.pr_state == REPLICATE) & full,
                             (st.inflight - 1).clamp(min=0), st.inflight),
        send_append=st.send_append | (at_s & (st.match < _col(st.last))),
    )
    # ReadIndex ack: a heartbeat response echoing the pending read's ctx
    # counts toward its quorum; quorum → read_ready.
    pending = (st2.read_index >= 0) & ~st2.read_ready
    ack = pending & (m.ctx == st2.read_seq) & (m.ctx > 0)
    acks = st2.read_acks | (at_s & _col(ack))
    confirmed = joint_vote_result(
        _choose(acks, 1, -1), st2.voter, st2.voter_out,
        st2.in_joint) == VOTE_WON
    st2 = st2._replace(
        read_acks=acks,
        read_ready=st2.read_ready | (pending & confirmed),
    )
    return _sel(_pick_b(_repl_targets(st), at_s), st2, st)


def _candidate_vote_resp(cfg: BatchedConfig, ids: Ids, st: BatchedState,
                         m: MsgSlots, s: torch.Tensor) -> BatchedState:
    """ref: raft.go:1399-1414."""
    st2, res = _record_vote_and_tally(st, ids, s, ~m.reject)
    won, lost = res == VOTE_WON, res == VOTE_LOST
    if cfg.pre_vote:
        st_won_pre = _campaign(cfg, st2, ids, False)
    else:
        st_won_pre = st2
    st_won_real = _become_leader(cfg, st2, ids)
    st_won_real = st_won_real._replace(
        send_append=st_won_real.send_append
        | (_repl_targets(st_won_real) & ~ids.is_self))
    st_won = _sel(st.role == PRECANDIDATE, st_won_pre, st_won_real)
    st_lost = _become_follower(cfg, st2, ids, st2.term,
                               torch.zeros_like(st.lead))
    return _sel(won, st_won, _sel(lost, st_lost, st2))


# -----------------------------------------------------------------------------
# Vectorized deliver: no sender scan. Per round each sender contributes
# at most ONE message per lane; response-lane handlers are
# order-invariant reductions over distinct progress columns (sender s
# only ever touches column s; commit/read-quorum are single recomputes),
# and request lanes admit at most one effective winner after term
# gating. The order contract (the JAX package's, mirrored exactly):
#
#   * lanes process in kind order 0..5;
#   * request lanes: the winner (highest term, lowest sender) delivers
#     first through the full handler; losers then answer against the
#     post-winner state (stale nudges);
#   * the vote lane orders T_VOTE (term desc, sender asc) before every
#     T_PREVOTE (prevotes never change state);
#   * response lanes: same-term effects first (commutative), then the
#     single highest-term depose, re-gated against the post-effect term.
#
# Every lane runs every round: an all-invalid lane is an exact identity,
# and testing lane occupancy would cost a device→host sync per lane.
# -----------------------------------------------------------------------------


def _gather_msg(msgs: MsgSlots, w: torch.Tensor) -> MsgSlots:
    """msgs[n, w[n]] per field: one message per instance from an
    [N, R] lane."""
    def pick(x):
        at = w.long().view(w.shape + (1,) * (x.dim() - 1))
        if x.dim() == 3:
            at = at.expand(-1, 1, x.shape[-1])
        return x.gather(1, at).squeeze(1)

    return MsgSlots(*(pick(x) for x in msgs))


def _vec_lane_request(cfg: BatchedConfig, ids: Ids, st: BatchedState,
                      m: MsgSlots, handler, hb_lane: bool):
    """One request lane (KIND_APP / KIND_HB): the winner — highest
    term, lowest sender — runs the full per-message handler once, and
    every loser is answered with the stale-leader nudge it would have
    received anyway, computed against the post-winner state
    (ref: raft.go:885-905)."""
    t_max = torch.where(m.valid, m.term, -1).amax(-1)
    w = _argfirst(m.valid & (m.term == _col(t_max)))
    at_w = ids.peers == _col(w)
    mw = _gather_msg(m, w)
    st2, wresp = handler(cfg, ids, st, mw, w)

    nudge = m.valid & ~at_w & (m.term < _col(st2.term)) & (
        cfg.check_quorum or cfg.pre_vote)
    if hb_lane:
        # A losing MsgTimeoutNow never draws a response.
        nudge = nudge & (m.type != T_TIMEOUT_NOW)
    resp = MsgSlots(
        valid=torch.where(at_w, _col(wresp.valid), nudge),
        type=torch.where(at_w, _col(wresp.type), T_APP_RESP),
        term=torch.where(at_w, _col(wresp.term), _col(st2.term)),
        log_term=torch.where(at_w, _col(wresp.log_term), 0),
        index=torch.where(at_w, _col(wresp.index), 0),
        commit=torch.where(at_w, _col(wresp.commit), 0),
        reject=at_w & _col(wresp.reject),
        reject_hint=torch.where(at_w, _col(wresp.reject_hint), 0),
        n_ents=torch.where(at_w, _col(wresp.n_ents), 0),
        ctx=torch.where(at_w, _col(wresp.ctx), 0),
        ent_terms=torch.where(_col(at_w), wresp.ent_terms.unsqueeze(1), 0),
    )
    return st2, resp


def _vec_lane_vote(cfg: BatchedConfig, ids: Ids, st: BatchedState,
                   m: MsgSlots):
    """Lane KIND_VOTE. State effects come only from T_VOTE at the
    highest surviving term: one depose and at most one recorded grant
    (the first up-to-date sender when the vote is free — the sequential
    setdefault). Prevotes never mutate state, so all prevote responses
    evaluate against the post-vote state in one masked shot."""
    senders = ids.peers
    is_vote = m.type == T_VOTE
    is_pre = m.type == T_PREVOTE

    # Leases block higher-term requests unless transfer-flagged
    # (ref: raft.go:870-880).
    def lease_block(stx):
        if not cfg.check_quorum:
            return torch.zeros_like(m.valid)
        in_lease = (stx.lead != 0) & (
            stx.election_elapsed < cfg.election_timeout)
        return (m.term > _col(stx.term)) & _col(in_lease) & ~(m.ctx == 1)

    vmask = m.valid & is_vote & ~lease_block(st)
    t_hi = torch.where(vmask, m.term, -1).amax(-1)
    st1 = _sel(
        t_hi > st.term,
        _become_follower(cfg, st, ids, torch.maximum(t_hi, st.term),
                         torch.zeros_like(st.lead)),
        st,
    )

    eq = vmask & (m.term == _col(st1.term))
    last_term = _col(_ta(st1, st1.last))
    up_to_date = (m.log_term > last_term) | (
        (m.log_term == last_term) & (m.index >= _col(st1.last)))
    can_vote = (_col(st1.vote) == senders + 1) | _col(
        (st1.vote == 0) & (st1.lead == 0))
    grantable = eq & can_vote & up_to_date & ~_col(st1.fenced)
    has_grant = grantable.any(-1)
    first = _argfirst(grantable)
    granted = grantable & (senders == _col(first))
    st2 = st1._replace(
        vote=torch.where(has_grant, first + 1, st1.vote),
        election_elapsed=torch.where(has_grant, 0, st1.election_elapsed),
    )

    # Prevote responses against the post-vote state (grants never
    # record, ref: raft.go:960-972).
    pv = m.valid & is_pre & ~lease_block(st2)
    lower_p = m.term < _col(st2.term)
    can_pre = (_col(st2.vote) == senders + 1) | _col(
        (st2.vote == 0) & (st2.lead == 0)) | (m.term > _col(st2.term))
    grant_p = pv & ~lower_p & can_pre & up_to_date & ~_col(st2.fenced)

    resp = _no_resp(cfg, m.term)._replace(
        valid=eq | pv,
        type=_choose(is_vote, T_VOTE_RESP, T_PREVOTE_RESP),
        term=torch.where(grant_p, m.term, _col(st2.term)),
        reject=torch.where(is_vote, ~granted, ~grant_p),
    )
    return st2, resp


def _vec_app_resp_effects(cfg: BatchedConfig, st: BatchedState,
                          m: MsgSlots, eq: torch.Tensor) -> BatchedState:
    """Columnwise leader MsgAppResp handling for every same-term
    response at once: sender s's message only ever touches progress
    column s, so the R sequential handler applications collapse to
    masked column updates plus ONE commit recompute and one
    bcast/resend fold. `eq` gates to valid same-term T_APP_RESP on a
    leader."""
    prog = _repl_targets(st)
    ok = eq & prog
    # recent_active is recorded for every handled message.
    st_in = st._replace(recent_active=st.recent_active | eq)

    # --- rejected: move next back using the hint (raft.go:1130-1236) ---
    hint = find_conflict_by_term(st.log_term, st.snap_index, st.snap_term,
                                 st.last, m.reject_hint, m.log_term)
    hint = torch.where(m.log_term > 0, hint, m.reject_hint)
    in_repl = st.pr_state == REPLICATE
    stale_rej = torch.where(in_repl, m.index <= st.match,
                            st.next - 1 != m.index)
    dec_next = torch.where(in_repl, st.match + 1,
                           torch.minimum(m.index, hint + 1).clamp(min=1))
    rej = ok & m.reject & ~stale_rej
    # Stale-high match repair (a follower that lost acked entries under
    # a torn WAL tail): lowering match is always safe.
    match_repair = rej & (dec_next <= st.match)

    # --- accepted: MaybeUpdate + state transitions ---
    old_paused = _paused(cfg, st)
    updated = st.match < m.index
    accu = ok & ~m.reject & updated
    new_match = torch.maximum(st.match, m.index)
    was_probe = st.pr_state == PROBE
    was_snap = (st.pr_state == SNAPSHOT) & (new_match >= st.pending_snapshot)
    to_repl = accu & (was_probe | was_snap)

    match1 = torch.where(match_repair, dec_next - 1, st.match)
    match1 = torch.where(accu, new_match, match1)
    next1 = torch.where(rej, dec_next, st.next)
    next1 = torch.where(accu, torch.maximum(st.next, m.index + 1), next1)
    next1 = torch.where(to_repl, new_match + 1, next1)
    pr1 = torch.where(rej & in_repl, PROBE, st.pr_state)
    pr1 = torch.where(to_repl, REPLICATE, pr1)
    st2 = st_in._replace(
        match=match1,
        next=next1,
        pr_state=pr1,
        probe_sent=st.probe_sent & ~rej & ~accu,
        pending_snapshot=torch.where((rej & in_repl) | to_repl, 0,
                                     st.pending_snapshot),
        inflight=torch.where((rej & in_repl) | accu, 0, st.inflight),
        send_append=st.send_append | rej,
    )
    # ONE commit recompute: commit is monotone in match and the
    # per-message recomputes' fixpoint equals the recompute on the
    # final match plane.
    commit0 = st.commit
    st2 = _maybe_commit(st2)
    advanced = st2.commit > commit0
    # bcastAppend on commit advance; per-column resend to previously
    # paused peers / peers with entries remaining (raft.go:1259-1276).
    resend = accu & (old_paused | (_col(st2.last) >= next1))
    st2 = st2._replace(send_append=torch.where(
        _col(advanced), st2.send_append | _repl_targets(st2),
        st2.send_append | resend))
    return _sel(eq.any(-1), st2, st)


def _vec_depose(cfg: BatchedConfig, ids: Ids, st: BatchedState,
                m: MsgSlots) -> BatchedState:
    """The response-lane depose tail: become follower at the highest
    term carried by any deposing message, re-gated against the
    post-effect state."""
    keep = (m.type == T_PREVOTE_RESP) & ~m.reject
    deposing = m.valid & (m.term > _col(st.term)) & ~keep
    dep_t = torch.where(deposing, m.term, -1).amax(-1)
    return _sel(
        dep_t > st.term,
        _become_follower(cfg, st, ids, torch.maximum(dep_t, st.term),
                         torch.zeros_like(st.lead)),
        st,
    )


def _vec_lane_vote_resp(cfg: BatchedConfig, ids: Ids, st: BatchedState,
                        m: MsgSlots) -> BatchedState:
    """Lane KIND_VOTE_RESP: record every same-term tally vote at once
    (distinct senders → distinct slots), resolve won/lost once, then the
    depose tail."""
    keep = (m.type == T_PREVOTE_RESP) & ~m.reject
    is_cand = (st.role == CANDIDATE) | (st.role == PRECANDIDATE)
    my_resp_type = _choose(st.role == PRECANDIDATE, T_PREVOTE_RESP,
                           T_VOTE_RESP)
    tally = (
        m.valid
        & ~(m.term < _col(st.term))
        & ~((m.term > _col(st.term)) & ~keep)
        & (m.type == _col(my_resp_type))
        & _col(is_cand)
    )
    votes = torch.where(tally & (st.votes == -1), (~m.reject).to(I32),
                        st.votes)
    st_t = st._replace(votes=votes)
    res = joint_vote_result(votes, st.voter, st.voter_out, st.in_joint)
    won, lost = res == VOTE_WON, res == VOTE_LOST
    if cfg.pre_vote:
        st_won_pre = _campaign(cfg, st_t, ids, False)
    else:
        st_won_pre = st_t
    st_won_real = _become_leader(cfg, st_t, ids)
    st_won_real = st_won_real._replace(
        send_append=st_won_real.send_append
        | (_repl_targets(st_won_real) & ~ids.is_self))
    st_won = _sel(st.role == PRECANDIDATE, st_won_pre, st_won_real)
    st_lost = _become_follower(cfg, st_t, ids, st_t.term,
                               torch.zeros_like(st.lead))
    st_dec = _sel(won, st_won, _sel(lost, st_lost, st_t))
    st1 = _sel(tally.any(-1), st_dec, st)
    return _vec_depose(cfg, ids, st1, m)


def _vec_lane_app_resp(cfg: BatchedConfig, ids: Ids, st: BatchedState,
                       m: MsgSlots) -> BatchedState:
    """Lane KIND_APP_RESP: the masked column fold, then the depose tail
    (a stale-leader nudge carrying a higher term lands here)."""
    eq = (m.valid & (m.term == _col(st.term)) & (m.type == T_APP_RESP)
          & _col(st.role == LEADER))
    st1 = _vec_app_resp_effects(cfg, st, m, eq)
    return _vec_depose(cfg, ids, st1, m)


def _vec_lane_hb_resp(cfg: BatchedConfig, ids: Ids, st: BatchedState,
                      m: MsgSlots) -> BatchedState:
    """Lane KIND_HB_RESP: heartbeat acks are a masked OR into
    probe_sent/inflight/recent_active plus ONE ReadIndex quorum
    recompute; T_APP_RESP stale-leader probes that route back in this
    lane reuse the column fold; then the depose tail."""
    senders = ids.peers
    eqterm = m.valid & (m.term == _col(st.term)) & _col(st.role == LEADER)
    okh = eqterm & (m.type == T_HB_RESP) & _repl_targets(st)
    apr = eqterm & (m.type == T_APP_RESP)

    full = st.inflight >= cfg.max_inflight
    st_h = st._replace(
        recent_active=st.recent_active | okh,
        probe_sent=st.probe_sent & ~okh,
        inflight=torch.where(okh & (st.pr_state == REPLICATE) & full,
                             (st.inflight - 1).clamp(min=0), st.inflight),
        send_append=st.send_append | (okh & (st.match < _col(st.last))),
    )
    # ReadIndex acks (read_only.go recvAck/advance). The sequential
    # handler stops RECORDING once an ack confirms quorum, so the fold
    # records only the sender-ascending prefix up to and including the
    # quorum-confirming ack: conf_at[s] = "quorum with acks from senders
    # <= s folded in" is monotone in s.
    pending = (st_h.read_index >= 0) & ~st_h.read_ready
    inc = okh & _col(pending) & (m.ctx == _col(st_h.read_seq)) & (m.ctx > 0)
    upto = senders.unsqueeze(0) <= senders.unsqueeze(1)  # [R prefix, R]
    prefix = st_h.read_acks.unsqueeze(1) | (inc.unsqueeze(1) & upto)
    conf_at = joint_vote_result(
        _choose(prefix, 1, -1), st_h.voter, st_h.voter_out,
        st_h.in_joint) == VOTE_WON  # [N, R prefixes]
    confirmed = conf_at.any(-1)  # == quorum over the full fold
    rec = inc & (~_col(confirmed) | (senders <= _col(_argfirst(conf_at))))
    st_h = st_h._replace(
        read_acks=st_h.read_acks | rec,
        read_ready=st_h.read_ready | (pending & confirmed & okh.any(-1)),
    )
    st_a = _vec_app_resp_effects(cfg, st_h, m, apr)
    return _vec_depose(cfg, ids, st_a, m)


def _lane(inbox: MsgSlots, k: int) -> MsgSlots:
    return MsgSlots(*(x[:, :, k] for x in inbox))


def _if_used(m: MsgSlots, resp: MsgSlots) -> MsgSlots:
    """The responses of a request lane, or empty slots when no instance
    used the lane this round. The JAX round skips such a lane for the
    whole batch (its lane-occupancy cond), which leaves state as it is —
    an all-invalid lane is an identity here too — but answers with
    all-zero slots; a device-side select keeps the outbox bit-equal
    without a host sync."""
    used = m.valid.any()
    return MsgSlots(*(torch.where(used, x, torch.zeros_like(x))
                      for x in resp))


def _deliver_vectorized(cfg: BatchedConfig, ids: Ids, st: BatchedState,
                        inbox: MsgSlots):
    """Scan-free deliver: lanes in kind order, each lane one vectorized
    fold over the sender axis. Returns the state and the responses to
    the three request lanes, [N, R] per field."""
    resps = []
    m = _lane(inbox, KIND_VOTE)
    st, r = _vec_lane_vote(cfg, ids, st, m)
    resps.append(_if_used(m, r))
    for kind, handler in ((KIND_APP, _lane_app), (KIND_HB, _lane_hb)):
        m = _lane(inbox, kind)
        st, r = _vec_lane_request(cfg, ids, st, m, handler,
                                  hb_lane=kind == KIND_HB)
        resps.append(_if_used(m, r))
    st = _vec_lane_vote_resp(cfg, ids, st, _lane(inbox, KIND_VOTE_RESP))
    st = _vec_lane_app_resp(cfg, ids, st, _lane(inbox, KIND_APP_RESP))
    st = _vec_lane_hb_resp(cfg, ids, st, _lane(inbox, KIND_HB_RESP))
    return st, tuple(resps)


# -----------------------------------------------------------------------------
# Sender-scan deliver ("lanes", "merged"): the reference's length-R
# lax.scan over senders is a Python loop unrolled into the round, one
# handler application per (sender, kind) for every instance at once.
# Every handler runs every round: an invalid slot is `dead`, leaves the
# state as it is and answers with the all-zero no_resp, as the JAX
# scans do (they skip no lane).
# -----------------------------------------------------------------------------


_LANE_HANDLERS = (
    _lane_vote, _lane_app, _lane_hb,
    _lane_vote_resp, _lane_app_resp, _lane_hb_resp,
)


def _sender_major(inbox: MsgSlots) -> MsgSlots:
    """The inbox [N, R, K(, E)] as [R, K, N(, E)] per field, copied once,
    so sender s's message in lane k, x[s, k], is a contiguous [N] (or
    [N, E]) tensor: the kernel wrappers take no strided argument."""
    return MsgSlots(*(x.movedim(0, 2).contiguous() for x in inbox))


def _deliver_in_order(cfg: BatchedConfig, ids: Ids, st: BatchedState,
                      inbox: MsgSlots, senders, order):
    """Apply the handler of lane k to sender s's message for each
    (s, k) of `order`; returns the state and the responses to the three
    request lanes, [N, R] per field, as _deliver_vectorized does."""
    msgs = _sender_major(inbox)
    resps = [[None] * cfg.num_replicas for _ in range(NUM_REQ_KINDS)]
    for s, k in order:
        m = MsgSlots(*(x[s, k] for x in msgs))
        out = _LANE_HANDLERS[k](cfg, ids, st, m, senders[s])
        if k < NUM_REQ_KINDS:
            st, resps[k][s] = out
        else:
            st = out
    return st, tuple(MsgSlots(*(torch.stack(xs, dim=1) for xs in zip(*lane)))
                     for lane in resps)


def _deliver_lanes(cfg: BatchedConfig, ids: Ids, st: BatchedState,
                   inbox: MsgSlots, senders):
    """Six scans, one per kind lane, senders ascending within a lane
    (kind-major order)."""
    order = [(s, k) for k in range(NUM_KINDS)
             for s in range(cfg.num_replicas)]
    return _deliver_in_order(cfg, ids, st, inbox, senders, order)


def _deliver_merged(cfg: BatchedConfig, ids: Ids, st: BatchedState,
                    inbox: MsgSlots, senders):
    """Two scans, the request half (kinds 0..2) then the response half,
    each step chaining the half's three handlers for one sender
    (sender-major order within a half)."""
    order = [(s, k)
             for half in (range(NUM_REQ_KINDS), range(NUM_REQ_KINDS, NUM_KINDS))
             for s in range(cfg.num_replicas) for k in half]
    return _deliver_in_order(cfg, ids, st, inbox, senders, order)


def _deliver_all(cfg: BatchedConfig, ids: Ids, st: BatchedState,
                 inbox: MsgSlots, senders):
    """Deliver the inbox in the configured shape (cfg.deliver_shape,
    resolved): "lanes" and "merged" are the sender scans above,
    "vectorized" the scan-free fold. `senders` holds each sender slot
    as an [N] int32 tensor, made once with the round."""
    if cfg.deliver_shape == "vectorized":
        return _deliver_vectorized(cfg, ids, st, inbox)
    if cfg.deliver_shape == "merged":
        return _deliver_merged(cfg, ids, st, inbox, senders)
    if cfg.deliver_shape == "lanes":
        return _deliver_lanes(cfg, ids, st, inbox, senders)
    raise ValueError(
        f"unresolved deliver_shape {cfg.deliver_shape!r}: call "
        "cfg.resolved() before building a round program")


# -----------------------------------------------------------------------------
# Phases: tick / control / propose / emit
# -----------------------------------------------------------------------------


def _tick(cfg: BatchedConfig, ids: Ids, st: BatchedState,
          do_tick: torch.Tensor, do_campaign: torch.Tensor) -> BatchedState:
    """ref: raft.go:645-684 tickElection/tickHeartbeat."""
    is_leader = st.role == LEADER
    leader_tick = do_tick & is_leader

    ee = st.election_elapsed + do_tick.to(I32)
    he = st.heartbeat_elapsed + leader_tick.to(I32)

    # Leader heartbeat firing.
    hb_fire = is_leader & (he >= cfg.heartbeat_timeout)
    cq_fire = is_leader & (ee >= cfg.election_timeout)
    st1 = st._replace(
        election_elapsed=torch.where(cq_fire, 0, ee),
        heartbeat_elapsed=torch.where(hb_fire, 0, he),
        send_heartbeat=st.send_heartbeat
        | (_col(hb_fire) & _repl_targets(st) & ~ids.is_self),
        # A transfer that outlives one election timeout is aborted
        # (ref: raft.go:670-678 tickHeartbeat abortLeaderTransfer).
        transferee=torch.where(cq_fire, 0, st.transferee),
        transfer_sent=st.transfer_sent & ~cq_fire,
        # The leader lease decays in the same tick currency the
        # electorate measures leader silence in.
        lease_ticks=(st.lease_ticks - leader_tick.to(I32)).clamp(min=0),
    )
    if cfg.check_quorum:
        # Leader self-check every election timeout: step down when a
        # quorum hasn't been heard from, then re-arm the activity bits
        # (ref: raft.go:997-1018 MsgCheckQuorum).
        active = ids.is_self | st1.recent_active
        alive = joint_vote_result(
            active.to(I32), st1.voter, st1.voter_out, st1.in_joint
        ) == VOTE_WON
        st_down = _become_follower(cfg, st1, ids, st1.term,
                                   torch.zeros_like(st1.lead))
        st1 = _sel(cq_fire & ~alive, st_down, st1)
        st1 = st1._replace(
            recent_active=torch.where(_col(cq_fire), ids.is_self,
                                      st1.recent_active),
            # A passed quorum self-check is the evidence the lease
            # leans on.
            lease_ticks=torch.where(cq_fire & alive & (st1.transferee == 0),
                                    cfg.election_timeout, st1.lease_ticks),
        )

    # Follower/candidate election firing (hup gated on promotability;
    # fenced instances never fire).
    promotable = _pick_b(_vote_targets(st), ids.is_self)
    fire = (
        (~is_leader & (ee >= st.randomized_timeout)) | do_campaign
    ) & promotable & (st.role != LEADER) & ~st.fenced
    st1 = st1._replace(election_elapsed=torch.where(
        fire & ~is_leader, 0, st1.election_elapsed))
    st_camp = _campaign(cfg, st1, ids, cfg.pre_vote)
    return _sel(fire, st_camp, st1)


def _control(cfg: BatchedConfig, ids: Ids, st: BatchedState,
             transfer_to: torch.Tensor,
             read_req: torch.Tensor) -> BatchedState:
    """Host control plane: leader-transfer requests and ReadIndex
    rounds (ref: raft.go:1339-1372 stepLeader MsgTransferLeader;
    raft.go:1078-1096 MsgReadIndex + read_only.go addRequest).
    `transfer_to` is slot+1 (0 = none); both are no-ops on non-leaders."""
    is_leader = st.role == LEADER

    # --- leader transfer ---
    at_target = ids.peers == _col(transfer_to - 1)
    valid_target = (
        is_leader
        & (transfer_to > 0)
        & (transfer_to != ids.slot + 1)      # self-transfer is a no-op
        & (transfer_to != st.transferee)     # dup request ignored
        & _pick_b(_vote_targets(st), at_target)  # learners can't lead
    )
    st_tr = st._replace(
        transferee=transfer_to,
        transfer_sent=torch.zeros_like(st.transfer_sent),
        election_elapsed=torch.zeros_like(st.election_elapsed),
        # Last-chance catch-up append (raft.go:1367-1371 sendAppend).
        send_append=st.send_append | (at_target & (st.match < _col(st.last))),
        # A transferring leader stops serving lease reads now.
        lease_ticks=torch.zeros_like(st.lease_ticks),
    )
    st = _sel(valid_target, st_tr, st)

    # --- ReadIndex: only after a commit in the leader's own term, and
    # never over a batch in flight; otherwise the request latches. ---
    committed_in_term = _ta(st, st.commit) == st.term
    batch_pending = (st.read_index >= 0) & ~st.read_ready
    want = read_req | st.read_req_latch
    accept = is_leader & want & committed_in_term & ~batch_pending
    acks0 = ids.is_self
    solo = joint_vote_result(
        _choose(acks0, 1, -1), st.voter, st.voter_out,
        st.in_joint) == VOTE_WON
    st_rd = st._replace(
        read_seq=st.read_seq + 1,
        read_index=st.commit,
        read_acks=acks0,
        read_ready=solo,  # single-voter group confirms instantly
        # Confirmation heartbeats to the electorate; emit stamps
        # ctx = read_seq.
        send_heartbeat=st.send_heartbeat | (_repl_targets(st) & ~ids.is_self),
    )
    st = _sel(accept, st_rd, st)
    return st._replace(read_req_latch=want & ~accept)


def _propose(cfg: BatchedConfig, ids: Ids, st: BatchedState,
             n_new: torch.Tensor) -> BatchedState:
    """Append n_new proposals on leader instances; payload bytes stay in
    the host arena (ref: v3_server.go Propose → appendEntry →
    bcastAppend). Dropped during a transfer and on a leader removed from
    the config (ref: raft.go:1043-1053)."""
    self_tracked = _pick_b(_repl_targets(st), ids.is_self)
    is_leader = (st.role == LEADER) & (st.transferee == 0) & self_tracked
    headroom = (cfg.window - (st.last - st.snap_index)
                - cfg.max_props_per_round).clamp(min=0)
    n = torch.where(is_leader, n_new, 0).clamp(0, cfg.max_props_per_round)
    n = torch.minimum(n, headroom)
    st2 = _append_own(cfg, st, ids, n)
    st2 = st2._replace(send_append=st2.send_append | (
        _col(n > 0) & _repl_targets(st2) & ~ids.is_self))
    return _sel(n > 0, st2, st)


def _request_lane(like: torch.Tensor, e: int, **fields) -> MsgSlots:
    """One [N, R] outbox lane: the given fields broadcast to [N, R]
    ([N, R, E] for ent_terms), the rest zero."""
    n, r = like.shape
    out = {}
    for name in MsgSlots._fields:
        shape = (n, r, e) if name == "ent_terms" else (n, r)
        x = fields.get(name)
        if x is None:
            dt = torch.bool if name in ("valid", "reject") else I32
            out[name] = torch.zeros(shape, dtype=dt, device=like.device)
        else:
            out[name] = x.expand(shape).contiguous()
    return MsgSlots(**out)


def _emit(cfg: BatchedConfig, ids: Ids, st: BatchedState):
    """Materialize pending sends into the three request lanes of the
    outbox and clear the flags; auto-apply committed entries (the host
    drains (group, index) ranges for payload apply)."""
    e = cfg.max_ents_per_msg

    # Device-side apply + compaction first. Stale ring slots below the
    # floor need no clearing: term_at bounds exclude them.
    st = st._replace(applied=torch.maximum(st.applied, st.commit))
    if cfg.auto_compact:
        keep = cfg.window // 2
        new_snap = torch.maximum(
            st.snap_index, torch.minimum(st.applied, st.last - keep))
        st = st._replace(snap_term=_ta(st, new_snap), snap_index=new_snap)

    not_self = ~ids.is_self
    vote_peer = _vote_targets(st) & not_self
    repl_peer = _repl_targets(st) & not_self
    is_leader = st.role == LEADER

    # --- vote requests (ref: raft.go:822-834) ---
    vote_lane = _request_lane(
        st.match, e,
        valid=_col(st.send_vote_req) & vote_peer,
        type=_col(_choose(st.vote_req_is_pre, T_PREVOTE, T_VOTE)),
        term=_col(torch.where(st.vote_req_is_pre, st.term + 1, st.term)),
        index=_col(st.last),
        log_term=_col(_ta(st, st.last)),
        ctx=_col(st.vote_req_transfer.to(I32)),
    )

    # --- heartbeats + TimeoutNow (ref: raft.go:495-511; :1367-1372) ---
    # The pending read's seq rides every confirmation heartbeat;
    # TimeoutNow to a caught-up transferee shares the lane.
    hb = st.send_heartbeat & repl_peer & _col(is_leader)
    pending_read = (st.read_index >= 0) & ~st.read_ready
    hb_ctx = torch.where(pending_read, st.read_seq, 0)
    ton = (
        _col(is_leader & (st.transferee > 0) & ~st.transfer_sent)
        & (st.match >= _col(st.last))
        & (ids.peers == _col(st.transferee - 1))
    )
    hb_lane = _request_lane(
        st.match, e,
        valid=hb | ton,
        type=_choose(ton, T_TIMEOUT_NOW, T_HB),
        term=_col(st.term),
        commit=torch.minimum(st.match, _col(st.commit)),
        ctx=torch.where(ton, 0, _col(hb_ctx)),
    )
    st = st._replace(transfer_sent=st.transfer_sent | ton.any(-1))

    # --- appends / snapshots (ref: raft.go:432-492 maybeSendAppend) ---
    want = st.send_append & repl_peer & _col(is_leader) & ~_paused(cfg, st)
    prev = st.next - 1
    snap_needed = prev < _col(st.snap_index)
    n_send = (_col(st.last) - prev).clamp(0, e)  # [N, R]
    j = torch.arange(e, dtype=I32, device=prev.device)
    ent_idx = prev.unsqueeze(-1) + 1 + j  # [N, R, E]
    ent_terms = _ta(st, ent_idx)
    ent_mask = j < n_send.unsqueeze(-1)
    app = want & ~snap_needed
    snp = want & snap_needed
    app_lane = _request_lane(
        st.match, e,
        valid=app | snp,
        type=_choose(snp, T_SNAP, T_APP),
        term=_col(st.term),
        index=torch.where(snp, _col(st.snap_index), prev),
        log_term=torch.where(snp, _col(st.snap_term), _ta(st, prev)),
        commit=_col(st.commit),
        n_ents=torch.where(app, n_send, 0),
        ent_terms=torch.where(ent_mask & app.unsqueeze(-1), ent_terms, 0),
    )

    # Progress effects of the sends.
    sent_ents = app & (n_send > 0)
    repl_sent = sent_ents & (st.pr_state == REPLICATE)
    st = st._replace(
        probe_sent=st.probe_sent | (sent_ents & (st.pr_state == PROBE)),
        next=torch.where(repl_sent, st.next + n_send, st.next),
        inflight=torch.where(repl_sent, st.inflight + 1, st.inflight),
        pr_state=torch.where(snp, SNAPSHOT, st.pr_state),
        pending_snapshot=torch.where(snp, _col(st.snap_index),
                                     st.pending_snapshot),
        send_append=torch.zeros_like(st.send_append),
        send_heartbeat=torch.zeros_like(st.send_heartbeat),
        send_vote_req=torch.zeros_like(st.send_vote_req),
        vote_req_transfer=torch.zeros_like(st.vote_req_transfer),
    )
    return st, (vote_lane, app_lane, hb_lane)


# -----------------------------------------------------------------------------
# Round assembly + router
# -----------------------------------------------------------------------------


def route_view(cfg: BatchedConfig, x: torch.Tensor) -> torch.Tensor:
    """One outbox field [N, R, ...] routed, as a view [G, R, R, ...] of
    it indexed [group, target, sender, ...] (route() copies it into the
    inbox's [N, R, ...] layout)."""
    g, r = cfg.num_groups, cfg.num_replicas
    return x.reshape((g, r) + x.shape[1:]).transpose(1, 2)


def route(cfg: BatchedConfig, outbox: MsgSlots) -> MsgSlots:
    """All-device network: outbox[i, target_slot, k] → inbox[t,
    sender_slot, k] where i=(g, s) and t=(g, r): one transpose of the
    (sender, target) axes per field. Lane indexes pass through: the
    round already placed each response in lane k + NUM_REQ_KINDS."""
    return MsgSlots(*(route_view(cfg, x).reshape(x.shape) for x in outbox))


class StepAux(NamedTuple):
    """Per-instance mid-round snapshots the host needs.

    last_tick: log watermark after the tick phase (just before proposals
    append) — the host assigns queued proposal payloads to indexes
    (last_tick, last].

    read_*: the ReadIndex state right after delivery — a batch can
    confirm in the deliver phase and be replaced by a latched reopen in
    _control within the same round."""

    last_tick: torch.Tensor  # [N]
    read_seq: torch.Tensor  # [N]
    read_index: torch.Tensor  # [N]
    read_ready: torch.Tensor  # [N]


def _stack_lanes(lanes) -> MsgSlots:
    """NUM_KINDS [N, R] lanes → [N, R, NUM_KINDS] per field
    ([N, R, NUM_KINDS, E] for ent_terms)."""
    return MsgSlots(*(torch.stack(xs, dim=2) for xs in zip(*lanes)))


class TelemetryFrame(NamedTuple):
    """Per-round telemetry (cfg.telemetry): event counters in
    telemetry.TM_NAMES column order and the invariant bitmap
    (kernels.invariant_bits, telemetry.INV_NAMES)."""

    counters: torch.Tensor  # [N, NUM_COUNTERS] i32
    invariants: torch.Tensor  # [N] i32


def _telemetry_frame(ids: Ids, pre: BatchedState, post: BatchedState,
                     inbox: MsgSlots, out: MsgSlots, last_tick: torch.Tensor,
                     n_new: torch.Tensor) -> TelemetryFrame:
    """Counters of one round per instance, a pure read of its inputs and
    outputs: `inbox` after the isolate mask, `out` the wide outbox after
    the response lanes and the isolate mask."""
    def cnt(m):
        return m.reshape(m.shape[0], -1).sum(-1, dtype=I32)

    def lane(x, k):
        return x[:, :, k]

    v, t = out.valid, out.type
    ar_v = lane(v, KIND_APP_RESP) & (lane(t, KIND_APP_RESP) == T_APP_RESP)
    ar_rej = lane(out.reject, KIND_APP_RESP)
    appended = post.last - last_tick

    def cand(role):
        return (role == CANDIDATE) | (role == PRECANDIDATE)

    won = (post.role == LEADER) & (pre.role != LEADER)
    started = (cand(post.role) & ~cand(pre.role)) | (won & ~cand(pre.role))
    cols = (
        cnt(lane(v, KIND_VOTE)),
        cnt(lane(v, KIND_APP) & (lane(t, KIND_APP) == T_APP)),
        cnt(lane(v, KIND_APP) & (lane(t, KIND_APP) == T_SNAP)),
        cnt(lane(v, KIND_HB) & (lane(t, KIND_HB) == T_HB)),
        cnt(lane(v, KIND_HB) & (lane(t, KIND_HB) == T_TIMEOUT_NOW)),
        cnt(lane(v, KIND_VOTE_RESP)),
        cnt(lane(v, KIND_APP_RESP)),
        cnt(lane(v, KIND_HB_RESP)),
        cnt(inbox.valid),
        cnt(ar_v & ~ar_rej),
        cnt(ar_v & ar_rej),
        cnt((pre.pr_state == PROBE) & (post.pr_state == REPLICATE)),
        cnt((pre.pr_state != SNAPSHOT) & (post.pr_state == SNAPSHOT)),
        cnt((pre.pr_state != PROBE) & (post.pr_state == PROBE)),
        started.to(I32),
        won.to(I32),
        post.commit - pre.commit,
        (post.read_ready & ~pre.read_ready).to(I32),
        (n_new.clamp(min=0) - appended).clamp(min=0),
        post.fenced.to(I32),
        # conf_changes_applied: zero on the device (entry types live in
        # the host arena; the host counts where it stages masks).
        torch.zeros_like(post.commit),
    )
    assert len(cols) == NUM_COUNTERS
    return TelemetryFrame(torch.stack(cols, dim=-1),
                          invariant_bits(post, ids.slot))


class _FleetRows(NamedTuple):
    """What the fleet frame needs of the rows' identities, fixed when
    the round is built."""

    layout: FleetLayout
    group: torch.Tensor  # [N] i32 group id of each row
    heat_bin: torch.Tensor  # [N] i64 heat column of each row
    # [N] i64 N-1-row: a tie-break that ranks lower rows first.
    tie_rank: torch.Tensor


def _fleet_rows(cfg: BatchedConfig, ids: Ids) -> _FleetRows:
    n = ids.iid.shape[0]
    layout = FleetLayout(n, cfg.num_replicas, cfg.num_groups)
    group = ids.iid // cfg.num_replicas
    heat_bin = (group * layout.heat_bins // cfg.num_groups).long()
    tie_rank = n - 1 - torch.arange(n, dtype=torch.int64,
                                    device=ids.iid.device)
    return _FleetRows(layout, group, heat_bin, tie_rank)


def top_k_rows(values: torch.Tensor, k: int,
               tie_rank: torch.Tensor) -> torch.Tensor:
    """Indexes of the k largest int32 `values`, largest first and, among
    equal values, lower rows first (jax.lax.top_k's order; torch.topk
    leaves ties unordered). One topk over an int64 key that is unique
    per row: value * 2^32 + (N-1-row)."""
    key = values.to(torch.int64) * (1 << 32) + tie_rank
    return key.topk(k).indices


def _fleet_frame(cfg: BatchedConfig, ids: Ids, rows: _FleetRows,
                 pre: BatchedState, post: BatchedState) -> torch.Tensor:
    """The fleet summary frame: one flat [L] int32 vector in
    obs/fleet.FleetLayout field order, every field a reduction across
    rows (histograms, censuses, heat bins, top-k), so it costs O(L) on
    the host whatever G is. A pure read of the round's pre/post
    state."""
    layout = rows.layout
    delta = post.commit - pre.commit          # [N] commit progress
    backlog = post.last - post.commit         # [N] uncommitted tail
    is_leader = post.role == LEADER
    # The leader's progress rows of tracked peers, self excluded.
    lmask = _col(is_leader) & _repl_targets(post) & ~ids.is_self
    ring_occ = post.last - post.snap_index    # live span of the ring
    top = top_k_rows(backlog, layout.top_k, rows.tie_rank)

    def heat(x):
        # Integer adds, so the order of the atomics does not matter.
        return torch.zeros(layout.heat_bins, dtype=I32,
                           device=x.device).index_add_(0, rows.heat_bin, x)

    def one(x):
        return x.reshape(1)

    roles = torch.arange(4, dtype=I32, device=post.role.device)
    parts = {
        "hist_commit_delta": log_bucket_counts(delta, FLEET_BUCKETS),
        "hist_backlog": log_bucket_counts(backlog, FLEET_BUCKETS),
        "hist_inflight": log_bucket_counts_masked(
            post.inflight, FLEET_BUCKETS, lmask),
        "hist_ring_occupancy": log_bucket_counts(ring_occ, FLEET_BUCKETS),
        "ring_occ_max": one(ring_occ.max()),
        "leader_slot": (ids.is_self & _col(is_leader)).sum(0, dtype=I32),
        "role_census": (post.role.unsqueeze(-1) == roles).sum(0, dtype=I32),
        "pr_census": torch.stack([
            (lmask & (post.pr_state == s)).sum(dtype=I32)
            for s in (PROBE, REPLICATE, SNAPSHOT)]),
        "fenced": one(post.fenced.sum(dtype=I32)),
        "term_min": one(post.term.min()),
        "term_max": one(post.term.max()),
        # An int32 sum, wrapping as the reference's does.
        "term_sum": one(post.term.sum(dtype=I32)),
        "heat_commit": heat(delta),
        "heat_backlog": heat(backlog),
        "top_group": rows.group[top],
        "top_lag": backlog[top],
        "top_commit": post.commit[top],
        "top_applied": post.applied[top],
        "top_term": post.term[top],
        "top_role": post.role[top],
        "top_lead": post.lead[top],
    }
    for name, length, _acc in layout.fields:
        p = parts[name]
        assert p.shape == (length,) and p.dtype == I32, (
            f"fleet frame field {name}: {p.dtype}{tuple(p.shape)}")
    return torch.cat([parts[name] for name, _l, _a in layout.fields])


def make_step_round(cfg: BatchedConfig, iids=None, slots=None,
                    with_aux: bool = False, device=None):
    """Build the round function:

        state, outbox[, aux][, telemetry][, fleet] = step(
            state, inbox, tick_mask, campaign_mask, propose_n, isolate[,
            transfer_to, read_req])

(telemetry: a TelemetryFrame with cfg.telemetry; fleet: the [L] frame
with cfg.fleet_summary.)

    Every tensor stays on one device; chain with route() for a
    closed-loop multi-raft simulation (the dense all-replica layout), or
    pass explicit `iids`/`slots` for a host that owns a subset of rows
    (iid = group*R + slot keeps the randomized-timeout hash identical
    across topologies). The round runs on `device` (default: the GPU),
    or on the device of a tensor `iids`."""
    cfg = cfg.validate().resolved().apply_plane_key()
    if isinstance(iids, torch.Tensor) and device is None:
        dev = iids.device
    else:
        dev = resolve_device(device)
    if iids is None:
        iids = torch.arange(cfg.num_instances, dtype=I32, device=dev)
    else:
        iids = torch.as_tensor(iids, dtype=I32, device=dev)
    if slots is None:
        slots = iids % cfg.num_replicas
    else:
        slots = torch.as_tensor(slots, dtype=I32, device=dev)
    ids = make_ids(iids, slots, cfg.num_replicas)
    n = iids.shape[0]
    zero_i = torch.zeros((n,), dtype=I32, device=dev)
    zero_b = torch.zeros((n,), dtype=torch.bool, device=dev)
    # The sender scans' slot operands, made here: a tensor made inside
    # the round would be a host-to-device copy, which a capture refuses.
    senders = tuple(torch.full((n,), s, dtype=I32, device=dev)
                    for s in range(cfg.num_replicas))
    fleet_rows = _fleet_rows(cfg, ids) if cfg.fleet_summary else None

    def step(st: BatchedState, inbox: MsgSlots, tick_mask, campaign_mask,
             propose_n, isolate, transfer_to: Optional[torch.Tensor] = None,
             read_req: Optional[torch.Tensor] = None):
        transfer_to = zero_i if transfer_to is None else transfer_to
        read_req = zero_b if read_req is None else read_req
        if cfg.narrow_lanes:
            # Narrow lanes live int8/int16 BETWEEN rounds; the protocol
            # math runs on int32 exactly as in the wide layout.
            st = widen_state(st)
            inbox = widen_msgs(inbox)
        pre = st
        # Partitioned instances neither receive nor send this round.
        iso = isolate.view(n, 1, 1)
        inbox = inbox._replace(valid=inbox.valid & ~iso)
        st, req_resps = _deliver_all(cfg, ids, st, inbox, senders)
        st = _tick(cfg, ids, st, tick_mask, campaign_mask)
        read_snap = (st.read_seq, st.read_index, st.read_ready)
        st = _control(cfg, ids, st, transfer_to, read_req)
        last_tick = st.last
        st = _propose(cfg, ids, st, propose_n)
        st, requests = _emit(cfg, ids, st)
        # Responses to requests from sender s land in out[s, k +
        # NUM_REQ_KINDS]; they route back by the same transpose.
        out = _stack_lanes(requests + req_resps)
        out = out._replace(valid=out.valid & ~iso)
        # Quorum-evidence lease re-arm: commit progress this round, or a
        # ReadIndex batch confirming (read_snap: a batch can confirm in
        # deliver and be replaced by a latched reopen in the same
        # round). Leaders mid-transfer never re-arm; non-leaders hold 0.
        is_leader = st.role == LEADER
        fresh = is_leader & (st.transferee == 0) & (
            (st.commit > pre.commit) | (read_snap[2] & ~pre.read_ready))
        lease = torch.where(fresh, cfg.election_timeout, st.lease_ticks)
        st = st._replace(lease_ticks=torch.where(is_leader, lease, 0))
        # The planes read the wide state and outbox.
        planes = ()
        if cfg.telemetry:
            planes += (_telemetry_frame(ids, pre, st, inbox, out, last_tick,
                                        propose_n),)
        if cfg.fleet_summary:
            planes += (_fleet_frame(cfg, ids, fleet_rows, pre, st),)
        if cfg.narrow_lanes:
            st = narrow_state(st)
            out = narrow_msgs(out)
        aux = (StepAux(last_tick, *read_snap),) if with_aux else ()
        return (st, out) + aux + planes

    return step


# -----------------------------------------------------------------------------
# Outbox packing (the hosted collect path)
# -----------------------------------------------------------------------------

# Words per wire record: [M, REC_WORDS] int32 rows whose little-endian
# bytes are the wire record of the host codec (msgblock.REC_DTYPE of
# the JAX package), so the host's collect is a view-cast.
REC_WORDS = 9


@functools.lru_cache(maxsize=None)
def _lane_table(dev: torch.device) -> torch.Tensor:
    """LANE_OF as an int32 tensor on `dev`, made once per device: a
    host-to-device copy inside a CUDA graph capture would sync, so the
    first (eager) round makes it and the captured round reads it.
    Unroutable types map to lane 0; they are never valid, so the host
    drops them (a -1 lane would smear into the type byte)."""
    return torch.as_tensor(np.maximum(LANE_OF, 0).astype(np.int32),
                           device=dev)


def pack_outbox(out: MsgSlots, slots: torch.Tensor):
    """Pack an outbox [N, R, K] into wire-record words on its device.

    Returns (words [M, REC_WORDS] i32, simple [M] bool, complex [M]
    bool) with M = N*R*K flat slots: `simple` marks the messages a block
    carries (all but MsgSnap), `complex` the MsgSnap slots that keep
    the per-message path. `slots` [N] is each row's replica slot."""
    # Narrow storage lanes widen first: an int8 `typ << 24` would wrap.
    typ = out.type.to(I32)
    n_ents = out.n_ents.to(I32)
    n, r, k = typ.shape
    dev = typ.device
    rows = torch.arange(n, dtype=I32, device=dev).view(n, 1, 1)
    to = torch.arange(1, r + 1, dtype=I32, device=dev).view(1, r, 1)
    frm = (slots.to(I32) + 1).view(n, 1, 1)
    lane = _lane_table(dev)[typ.clamp(0, NUM_WIRE_TYPES - 1).long()]
    # Little-endian byte lanes of the record's one-byte fields.
    w_addr = to | (frm << 8) | (lane << 16) | (typ << 24)
    w_flags = out.reject.to(I32) | (torch.where(typ == T_APP, n_ents, 0) << 8)
    words = torch.stack(torch.broadcast_tensors(
        rows, w_addr, w_flags, out.term, out.log_term, out.index,
        out.commit, out.reject_hint, out.ctx), dim=-1)
    simple = (out.valid & (typ != T_SNAP)).reshape(-1)
    cplx = (out.valid & (typ == T_SNAP)).reshape(-1)
    return words.reshape(-1, REC_WORDS), simple, cplx
