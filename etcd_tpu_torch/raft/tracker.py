"""Leader-side replication tracking (ref: raft/tracker/).

Ports ``etcd_tpu/raft/tracker.py`` whole. Per-follower state
(Match/Next/State/ProbeSent/RecentActive and the inflight window) is what
becomes the ``[N, R]`` tensors of the batched round; on the host side
``batched/node.py`` keeps a ``ProgressTracker`` for its config half only,
which the conf-change ``Changer`` edits.
"""

from __future__ import annotations

from enum import IntEnum
from typing import Callable, Dict, List, Optional, Set, Tuple

from .quorum import JointConfig, MajorityConfig, VoteResult


class ProgressStateType(IntEnum):
    """ref: raft/tracker/state.go."""

    StateProbe = 0
    StateReplicate = 1
    StateSnapshot = 2

    def __str__(self) -> str:
        return self.name


StateProbe = ProgressStateType.StateProbe
StateReplicate = ProgressStateType.StateReplicate
StateSnapshot = ProgressStateType.StateSnapshot


class Inflights:
    """Sliding window bounding un-acked MsgApp per follower
    (ref: raft/tracker/inflights.go).

    Entries are added in increasing index order and freed by "≤ index", so
    a deque suffices; in the batched round this is just a count plus last-added
    index per ``[N, R]`` slot.
    """

    def __init__(self, size: int):
        self.size = size
        self.buffer: List[int] = []

    def clone(self) -> "Inflights":
        c = Inflights(self.size)
        c.buffer = list(self.buffer)
        return c

    def add(self, inflight: int) -> None:
        if self.full():
            raise RuntimeError("cannot add into a Full inflights")
        self.buffer.append(inflight)

    def free_le(self, to: int) -> None:
        i = 0
        while i < len(self.buffer) and self.buffer[i] <= to:
            i += 1
        del self.buffer[:i]

    def free_first_one(self) -> None:
        if self.buffer:
            del self.buffer[0]

    def full(self) -> bool:
        return len(self.buffer) == self.size

    def count(self) -> int:
        return len(self.buffer)

    def reset(self) -> None:
        self.buffer.clear()


class Progress:
    """A follower's replication progress in the leader's view
    (ref: raft/tracker/progress.go:30-80)."""

    def __init__(
        self,
        match: int = 0,
        next: int = 0,
        inflights: Optional[Inflights] = None,
        is_learner: bool = False,
        recent_active: bool = False,
    ):
        self.match = match
        self.next = next
        self.state: ProgressStateType = StateProbe
        self.pending_snapshot = 0
        self.recent_active = recent_active
        self.probe_sent = False
        self.inflights = inflights if inflights is not None else Inflights(0)
        self.is_learner = is_learner

    def reset_state(self, state: ProgressStateType) -> None:
        self.probe_sent = False
        self.pending_snapshot = 0
        self.state = state
        self.inflights.reset()

    def probe_acked(self) -> None:
        self.probe_sent = False

    def become_probe(self) -> None:
        # Probing resumes after the pending snapshot, if one was sent.
        if self.state == StateSnapshot:
            pending = self.pending_snapshot
            self.reset_state(StateProbe)
            self.next = max(self.match + 1, pending + 1)
        else:
            self.reset_state(StateProbe)
            self.next = self.match + 1

    def become_replicate(self) -> None:
        self.reset_state(StateReplicate)
        self.next = self.match + 1

    def become_snapshot(self, snapshoti: int) -> None:
        self.reset_state(StateSnapshot)
        self.pending_snapshot = snapshoti

    def maybe_update(self, n: int) -> bool:
        """Ack up to index n; False if the ack is stale
        (ref: progress.go:144-153)."""
        updated = False
        if self.match < n:
            self.match = n
            updated = True
            self.probe_acked()
        self.next = max(self.next, n + 1)
        return updated

    def optimistic_update(self, n: int) -> None:
        self.next = n + 1

    def maybe_decr_to(self, rejected: int, match_hint: int) -> bool:
        """Handle a MsgApp rejection (ref: progress.go:170-193)."""
        if self.state == StateReplicate:
            if rejected <= self.match:
                return False
            self.next = self.match + 1
            return True
        if self.next - 1 != rejected:
            return False
        self.next = max(min(rejected, match_hint + 1), 1)
        self.probe_sent = False
        return True

    def is_paused(self) -> bool:
        if self.state == StateProbe:
            return self.probe_sent
        if self.state == StateReplicate:
            return self.inflights.full()
        if self.state == StateSnapshot:
            return True
        raise RuntimeError("unexpected state")

    def __str__(self) -> str:
        parts = [f"{self.state} match={self.match} next={self.next}"]
        if self.is_learner:
            parts.append(" learner")
        if self.is_paused():
            parts.append(" paused")
        if self.pending_snapshot > 0:
            parts.append(f" pendingSnap={self.pending_snapshot}")
        if not self.recent_active:
            parts.append(" inactive")
        n = self.inflights.count()
        if n > 0:
            parts.append(f" inflight={n}")
            if self.inflights.full():
                parts.append("[full]")
        return "".join(parts)

    def copy(self) -> "Progress":
        p = Progress(self.match, self.next, self.inflights.clone(), self.is_learner,
                     self.recent_active)
        p.state = self.state
        p.pending_snapshot = self.pending_snapshot
        p.probe_sent = self.probe_sent
        return p


def progress_map_str(progress: Dict[int, Progress]) -> str:
    return "".join(f"{vid}: {progress[vid]}\n" for vid in sorted(progress))


class TrackerConfig:
    """Active configuration (ref: raft/tracker/tracker.go:27-78).

    Empty learner sets are represented as None-equivalent empty sets; the
    printed form only includes non-empty segments, matching the Go nil-map
    conventions.
    """

    def __init__(self):
        self.voters = JointConfig()
        self.auto_leave = False
        self.learners: Set[int] = set()
        self.learners_next: Set[int] = set()

    def __str__(self) -> str:
        buf = f"voters={self.voters}"
        if self.learners:
            buf += f" learners={MajorityConfig(self.learners)}"
        if self.learners_next:
            buf += f" learners_next={MajorityConfig(self.learners_next)}"
        if self.auto_leave:
            buf += " autoleave"
        return buf

    def clone(self) -> "TrackerConfig":
        c = TrackerConfig()
        c.voters = self.voters.clone()
        c.auto_leave = self.auto_leave
        c.learners = set(self.learners)
        c.learners_next = set(self.learners_next)
        return c


class ProgressTracker:
    """Config + per-peer Progress + vote tally
    (ref: raft/tracker/tracker.go:117-125)."""

    def __init__(self, max_inflight: int):
        self.max_inflight = max_inflight
        self.config = TrackerConfig()
        self.progress: Dict[int, Progress] = {}
        self.votes: Dict[int, bool] = {}

    # -- config views ---------------------------------------------------------

    @property
    def voters(self) -> JointConfig:
        return self.config.voters

    @property
    def learners(self) -> Set[int]:
        return self.config.learners

    @property
    def learners_next(self) -> Set[int]:
        return self.config.learners_next

    def conf_state(self):
        from .types import ConfState

        return ConfState(
            voters=self.voters.incoming.slice(),
            voters_outgoing=self.voters.outgoing.slice(),
            learners=MajorityConfig(self.learners).slice(),
            learners_next=MajorityConfig(self.learners_next).slice(),
            auto_leave=self.config.auto_leave,
        )

    def is_singleton(self) -> bool:
        return len(self.voters.incoming) == 1 and len(self.voters.outgoing) == 0

    # -- reductions (the batched-engine kernels) ------------------------------

    def committed(self) -> int:
        """Quorum-acked commit index (ref: tracker.go:177-179)."""

        def acked(vid: int) -> Optional[int]:
            pr = self.progress.get(vid)
            return pr.match if pr is not None else None

        return self.voters.committed_index(acked)

    def visit(self, f: Callable[[int, Progress], None]) -> None:
        """Apply f to all progresses in sorted ID order (ref: tracker.go:191)."""
        for vid in sorted(self.progress):
            f(vid, self.progress[vid])

    def quorum_active(self) -> bool:
        """ref: tracker.go:215-225."""
        votes = {
            vid: pr.recent_active
            for vid, pr in self.progress.items()
            if not pr.is_learner
        }
        return self.voters.vote_result(votes) == VoteResult.VoteWon

    def voter_nodes(self) -> List[int]:
        return sorted(self.voters.ids())

    def learner_nodes(self) -> List[int]:
        return sorted(self.learners)

    def reset_votes(self) -> None:
        self.votes = {}

    def record_vote(self, vid: int, v: bool) -> None:
        self.votes.setdefault(vid, v)

    def tally_votes(self) -> Tuple[int, int, VoteResult]:
        """(granted, rejected, result) — ref: tracker.go:267-288."""
        granted = rejected = 0
        for vid, pr in self.progress.items():
            if pr.is_learner or vid not in self.votes:
                continue
            if self.votes[vid]:
                granted += 1
            else:
                rejected += 1
        return granted, rejected, self.voters.vote_result(self.votes)
