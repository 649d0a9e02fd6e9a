"""Replica-axis and log-ring reductions for the batched engine, as plain
PyTorch over an explicit instance axis.

Ports ``etcd_tpu/batched/kernels.py``. Every function takes tensors with
the instance axis first (``[N]`` scalars per instance, ``[N, R]``
replica rows, the ``[N, W]`` term ring) and follows their device. The
array forms of the scalar oracles:

  - quorum_committed   ↔ quorum.MajorityConfig.committed_index
                         (ref: raft/quorum/majority.go:126-172)
  - vote_result        ↔ quorum.MajorityConfig.vote_result
                         (ref: raft/quorum/majority.go:178-210)
  - term_at            ↔ raftLog.term (ref: raft/log.go:268-288)
  - find_conflict_by_term ↔ raftLog.findConflictByTerm
                         (ref: raft/log.go:150-171) — log terms are
                         nondecreasing in the index, so the backward
                         scan becomes a masked count.

``invariant_bits`` and ``log_bucket_*`` serve the telemetry and fleet
frames of the round.

``joint_committed``, ``joint_vote_result`` and ``term_at`` are the
round's quorum and term sites. They go through the wrappers of
hopper_kernels.py, which launch the Hopper kernels on CUDA tensors and
run the ``*_plain`` forms here on the CPU: one plain form per kernel.
"""

from __future__ import annotations

import math

import torch

I32 = torch.int32
MAX_I32 = 2**31 - 1

VOTE_PENDING, VOTE_LOST, VOTE_WON = 1, 2, 3


def _count(mask: torch.Tensor) -> torch.Tensor:
    """int32 count of set bits over the last axis (torch sums of bool
    would widen to int64)."""
    return mask.sum(-1, dtype=I32)


def quorum_committed(match: torch.Tensor, voter: torch.Tensor) -> torch.Tensor:
    """[..., R] → [...]: largest index acked by a quorum of voters.

    The reference picks srt[n-(n/2+1)] of the ascending sort of n acked
    indexes. Masking non-voters to 0 prepends (R-n) zeros to the sort,
    shifting the pick to position R - n//2 - 1."""
    r = match.shape[-1]
    n = _count(voter)
    srt = torch.where(voter, match, 0).sort(-1).values
    pos = (r - n // 2 - 1).clamp(0, r - 1)
    pick = srt.gather(-1, pos.unsqueeze(-1).long()).squeeze(-1)
    # Empty config commits "everything" (joint-quorum convention).
    return torch.where(n == 0, MAX_I32, pick)


def vote_result(votes: torch.Tensor, voter: torch.Tensor) -> torch.Tensor:
    """VOTE_WON / VOTE_LOST / VOTE_PENDING from [..., R] votes (-1
    missing / 0 rejected / 1 granted) and a voter mask."""
    n = _count(voter)
    yes = _count(voter & (votes == 1))
    no = _count(voter & (votes == 0))
    missing = n - yes - no
    q = n // 2 + 1
    won = (yes >= q) | (n == 0)
    pending = yes + missing >= q
    out = torch.full_like(n, VOTE_LOST)
    out = out.masked_fill(pending, VOTE_PENDING)
    return out.masked_fill(won, VOTE_WON)


def joint_committed_plain(match: torch.Tensor, voter: torch.Tensor,
                          voter_out: torch.Tensor,
                          in_joint: torch.Tensor) -> torch.Tensor:
    """Joint-config commit index = min over both halves
    (ref: raft/quorum/joint.go:49-56). match/voter/voter_out [..., R],
    in_joint [...] → [...]. The plain form of the quorum kernel's
    commit half."""
    main = quorum_committed(match, voter)
    return torch.where(
        in_joint, torch.minimum(main, quorum_committed(match, voter_out)),
        main)


def joint_vote_result_plain(votes: torch.Tensor, voter: torch.Tensor,
                            voter_out: torch.Tensor, in_joint: torch.Tensor,
                            tallies: int = 1) -> torch.Tensor:
    """Joint vote result (ref: raft/quorum/joint.go:61-75): lost if
    either half lost, pending if either half pending, else won.
    votes [N*B, R] holds B = `tallies` tallies per instance (rows
    i*B .. i*B+B-1 for instance i), each held to that instance's
    voter/voter_out [N, R] and in_joint [N] → [N*B]. The plain form of
    the quorum kernel's vote half."""
    if tallies > 1:
        voter, voter_out, in_joint = (x.repeat_interleave(tallies, 0)
                                      for x in (voter, voter_out, in_joint))
    a = vote_result(votes, voter)
    b = torch.where(in_joint, vote_result(votes, voter_out), VOTE_WON)
    lost = (a == VOTE_LOST) | (b == VOTE_LOST)
    pending = (a == VOTE_PENDING) | (b == VOTE_PENDING)
    out = torch.full_like(a, VOTE_WON).masked_fill(pending, VOTE_PENDING)
    return out.masked_fill(lost, VOTE_LOST)


def term_at_plain(log_term: torch.Tensor, snap_index: torch.Tensor,
                  snap_term: torch.Tensor, last: torch.Tensor,
                  i: torch.Tensor) -> torch.Tensor:
    """Term of entry i; snap_term at snap_index, 0 outside
    [snap_index, last] (the reference's "zero term on
    compacted/unavailable" behavior). log_term [N, W];
    snap_index/snap_term/last [N]; `i` is [N] or [N, ...]. The ring read
    is one indexed load per index. The plain form of the ring-term
    kernel."""
    w = log_term.shape[-1]
    flat = i.reshape(i.shape[0], -1)
    si, st, la = (x.unsqueeze(-1) for x in (snap_index, snap_term, last))
    in_ring = (flat > si) & (flat <= la)
    ring_val = log_term.gather(-1, (flat.clamp(min=0) % w).long())
    out = torch.where(flat == si, st, torch.where(in_ring, ring_val, 0))
    return out.view(i.shape)


# The round's sites. Their arguments are whole state fields and results
# of the round's own ops, contiguous by construction, so no site copies;
# on the card a strided argument makes the wrapper raise (a later site
# that passes a view must copy it). What each site is given, in step.py:
# - joint_committed: st.match [N, R], st.voter, st.voter_out,
#   st.in_joint.
# - joint_vote_result: st.votes or a torch.where of it, the ack prefixes
#   [N, R, R] of the heartbeat-response lane, an [N, R] activity or ack
#   mask as int32; with st.voter, st.voter_out, st.in_joint.
# - term_at: st.log_term, st.snap_index, st.snap_term, st.last and [N],
#   [N, R], [N, E] or [N, R, E] indexes that the round computes (for the
#   request handlers, fields of the gathered lane winner, not the
#   strided lane view).
# tests/test_torch_kernels.py holds every site's arguments contiguous
# over a seeded schedule of both parity configs on the CPU, and the
# parity phase of chip_smoke.py runs those configs on the card, where a
# strided argument would raise.


def joint_committed(match: torch.Tensor, voter: torch.Tensor,
                    voter_out: torch.Tensor,
                    in_joint: torch.Tensor) -> torch.Tensor:
    """Joint-config commit index, match/voter/voter_out [N, R] and
    in_joint [N] → [N], through the quorum kernel's wrapper."""
    from .hopper_kernels import quorum_commit

    return quorum_commit(match, voter, voter_out, in_joint)


def joint_vote_result(votes: torch.Tensor, voter: torch.Tensor,
                      voter_out: torch.Tensor,
                      in_joint: torch.Tensor) -> torch.Tensor:
    """Joint vote result through the quorum kernel's wrapper.

    votes is [N, R] or [N, B..., R] (several tallies per instance, such
    as the ack prefixes of the heartbeat-response lane); voter/voter_out
    [N, R] and in_joint [N] are shared by an instance's tallies, which
    go to one launch as rows of [N*B, R] with the masks unexpanded."""
    from .hopper_kernels import quorum_vote

    tallies = math.prod(votes.shape[1:-1])
    out = quorum_vote(votes.reshape(-1, votes.shape[-1]), voter, voter_out,
                      in_joint, tallies)
    return out.view(votes.shape[:-1])


def term_at(log_term: torch.Tensor, snap_index: torch.Tensor,
            snap_term: torch.Tensor, last: torch.Tensor,
            i: torch.Tensor) -> torch.Tensor:
    """Term of entry i (see term_at_plain), `i` [N] or [N, ...], through
    the ring-term kernel's wrapper with the indexes flattened to
    [N, K]."""
    from .hopper_kernels import term_at_batch

    n = i.shape[0]
    idx = i.reshape(n, math.prod(i.shape[1:])) if i.dim() > 1 else i
    out = term_at_batch(log_term, snap_index, snap_term, last, idx)
    return out.view(i.shape)


def find_conflict_by_term(log_term: torch.Tensor, snap_index: torch.Tensor,
                          snap_term: torch.Tensor, last: torch.Tensor,
                          index: torch.Tensor,
                          term: torch.Tensor) -> torch.Tensor:
    """Largest idx <= index with term_at(idx) <= term.

    Log terms never decrease with index, so the answer is
    snap_index + |{ j in (snap_index, min(index,last)] : term(j) <= term }|.
    Degenerates to snap_index (the dummy index) when nothing matches,
    like the reference's backward scan hitting ErrCompacted.

    index/term are [N] or [N, K] (K queries against one instance's
    log)."""
    w = log_term.shape[-1]
    extra = index.dim() - 1
    row = lambda x: x.view((x.shape[0],) + (1,) * extra)  # noqa: E731
    hi = torch.minimum(index, row(last))
    # Iterate ring POSITIONS instead of indexes: ring slot p holds the
    # unique index i_p in (snap_index, snap_index+W] with i_p % W == p.
    p = torch.arange(w, dtype=I32, device=log_term.device)
    si = snap_index.unsqueeze(-1)
    idx = si + 1 + (p - si - 1) % w  # [N, W]
    per_query = lambda x: x.view(x.shape[:1] + (1,) * extra + (w,))  # noqa: E731
    valid = per_query(idx) <= hi.unsqueeze(-1)
    cnt = _count(valid & (per_query(log_term) <= term.unsqueeze(-1)))
    # When nothing in the window matches, the backward walk stops at the
    # dummy index (term = snap_term) or, if even that term is too
    # large, one below it (ref: log.go:268-274).
    floor = torch.where(row(snap_term) <= term, row(snap_index),
                        row(snap_index) - 1)
    return torch.where(cnt > 0, row(snap_index) + cnt, floor)


def invariant_bits(st, slot: torch.Tensor) -> torch.Tensor:
    """[N] int32 illegal-state bitmap of an end-of-round state (bit
    order: telemetry.INV_NAMES); `slot` [N] is each row's replica slot.

    Everything here is impossible under the raft model: a set bit means
    a kernel bug or a violated environment assumption (a torn WAL tail
    faking back acked state). Leader-side progress conditions are
    masked to tracked peers other than self."""
    # Local constants mirror state.py, which this module does not import.
    leader, probe, snapshot = 2, 0, 2
    peers = torch.arange(st.match.shape[-1], dtype=I32, device=slot.device)
    is_leader = st.role == leader
    tracked = ((st.voter | st.voter_out | st.learner)
               & (peers != slot.unsqueeze(-1)))
    stale_next = st.next <= st.match
    bad = (
        is_leader & (tracked & stale_next).any(-1),
        st.commit > st.last,
        st.snap_index > st.commit,
        is_leader & (st.lead != slot + 1),
        # The progress wedge: a paused probe that can never progress.
        is_leader & (tracked & (st.pr_state == probe) & st.probe_sent
                     & stale_next).any(-1),
        # A snapshot whose pending index the peer already covers.
        is_leader & (tracked & (st.pr_state == snapshot)
                     & (st.pending_snapshot <= st.match)).any(-1),
        st.read_ready & (st.read_index < 0),
        st.fenced & is_leader,
        ~st.in_joint & st.voter_out.any(-1),
        # Ring occupancy past the window: an append overwrote a live slot.
        (st.last - st.snap_index) > st.log_term.shape[-1],
        (st.lease_ticks > 0) & ~is_leader,
    )
    bits = torch.zeros(st.commit.shape, dtype=I32, device=slot.device)
    for i, b in enumerate(bad):
        bits |= b.to(I32) << i
    return bits


def log_bucket_index(v: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Log2 bucket of each value: bucket 0 holds v <= 0, bucket b
    (1..num_buckets-2) holds v in [2^(b-1), 2^b), the last bucket is
    open-ended (obs/fleet.BUCKET_BOUNDS). The count of powers of two at
    or below v, as int32."""
    thr = 1 << torch.arange(num_buckets - 1, dtype=I32, device=v.device)
    return _count(v.unsqueeze(-1) >= thr)


def log_bucket_counts_masked(v: torch.Tensor, num_buckets: int,
                             mask: torch.Tensor) -> torch.Tensor:
    """[B] int32 histogram of `v` (any shape) over log2 buckets,
    restricted to `mask` (v's shape). Compare and sum: no bincount,
    whose output size would come from the data (a host sync on CUDA)."""
    b = log_bucket_index(v, num_buckets)
    buckets = torch.arange(num_buckets, dtype=I32, device=v.device)
    hit = (b.unsqueeze(-1) == buckets) & mask.unsqueeze(-1)
    return hit.reshape(-1, num_buckets).sum(0, dtype=I32)


def log_bucket_counts(v: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """log_bucket_counts_masked with every element counted."""
    return log_bucket_counts_masked(
        v, num_buckets, torch.ones(v.shape, dtype=torch.bool,
                                   device=v.device))


def ring_write(log_term: torch.Tensor, start_index: torch.Tensor,
               terms: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Write `count` terms at log positions start_index..start_index+count-1
    into each instance's [W] ring. terms [N, K], start_index/count [N]."""
    j = torch.arange(terms.shape[-1], dtype=I32, device=terms.device)
    return ring_write_masked(log_term, start_index, terms,
                             j < count.unsqueeze(-1))


def ring_write_masked(log_term: torch.Tensor, start_index: torch.Tensor,
                      terms: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """Write terms[:, j] at log position start_index+j for each masked j.

    The K positions of one instance are consecutive, so distinct when
    K <= W: a scatter of the masked terms, with the unmasked positions
    rewritten with their own old values, touches each slot once."""
    w = log_term.shape[-1]
    k = terms.shape[-1]
    if k > w:
        # K > W would alias ring positions.
        raise ValueError(f"ring write batch {k} exceeds window {w}")
    j = torch.arange(k, dtype=I32, device=terms.device)
    pos = ((start_index.unsqueeze(-1) + j) % w).long()  # [N, K]
    src = torch.where(mask, terms, log_term.gather(-1, pos))
    return log_term.scatter(-1, pos, src)
