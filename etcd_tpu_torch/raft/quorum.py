"""Quorum math: majority and joint configurations
(ref: raft/quorum/{majority,joint,quorum}.go).

Ports ``etcd_tpu/raft/quorum.py`` whole. ``committed_index`` and
``vote_result`` are the scalar forms of the two reductions the batched
round runs on the card (the quorum kernel, ``batched/hopper_kernels.py``);
here they serve the host config mirror of ``batched/node.py``.
"""

from __future__ import annotations

from enum import IntEnum
from typing import Callable, Dict, Iterable, Optional, Set

MAX_UINT64 = (1 << 64) - 1


class VoteResult(IntEnum):
    """ref: raft/quorum/quorum.go:44-58."""

    VotePending = 1
    VoteLost = 2
    VoteWon = 3

    def __str__(self) -> str:
        return self.name


def index_str(i: int) -> str:
    return "∞" if i == MAX_UINT64 else str(i)


class MajorityConfig(set):
    """A set of voter IDs deciding by majority (ref: quorum/majority.go:25)."""

    def __str__(self) -> str:
        return "(" + " ".join(str(i) for i in sorted(self)) + ")"

    def slice(self):
        return sorted(self)

    def committed_index(self, acked_index: Callable[[int], Optional[int]]) -> int:
        """Largest index acked by a quorum (ref: quorum/majority.go:126-172).

        Voters that have not reported in count as 0; with n voters the
        result is the value at position n-(n//2+1) of the ascending sort.
        """
        n = len(self)
        if n == 0:
            # An empty config commits everything; makes a half-populated
            # joint quorum behave like a majority quorum.
            return MAX_UINT64
        srt = sorted((acked_index(vid) or 0) for vid in self)
        return srt[n - (n // 2 + 1)]

    def vote_result(self, votes: Dict[int, bool]) -> VoteResult:
        """ref: quorum/majority.go:178-210."""
        if len(self) == 0:
            return VoteResult.VoteWon
        yes = no = missing = 0
        for vid in self:
            if vid not in votes:
                missing += 1
            elif votes[vid]:
                yes += 1
            else:
                no += 1
        q = len(self) // 2 + 1
        if yes >= q:
            return VoteResult.VoteWon
        if yes + missing >= q:
            return VoteResult.VotePending
        return VoteResult.VoteLost

    def describe(self, acked_index: Callable[[int], Optional[int]]) -> str:
        """Multi-line commit-index chart (ref: quorum/majority.go:47-103)."""
        if len(self) == 0:
            return "<empty majority quorum>"
        n = len(self)
        info = []
        for vid in self:
            idx = acked_index(vid)
            info.append([vid, idx if idx is not None else 0, idx is not None, 0])
        info.sort(key=lambda t: (t[1], t[0]))
        for i in range(1, len(info)):
            if info[i - 1][1] < info[i][1]:
                info[i][3] = i
        info.sort(key=lambda t: t[0])
        out = [" " * n + "    idx"]
        for vid, idx, ok, bar in info:
            if not ok:
                row = "?" + " " * n
            else:
                row = "x" * bar + ">" + " " * (n - bar)
            out.append("%s %5d    (id=%d)" % (row, idx, vid))
        return "\n".join(out) + "\n"


class JointConfig:
    """Two possibly-overlapping majority configs; decisions need both
    (ref: quorum/joint.go:19)."""

    def __init__(self, incoming: Optional[Iterable[int]] = None,
                 outgoing: Optional[Iterable[int]] = None):
        self.incoming = MajorityConfig(incoming or ())
        self.outgoing = MajorityConfig(outgoing or ())

    def __getitem__(self, i: int) -> MajorityConfig:
        return (self.incoming, self.outgoing)[i]

    def __str__(self) -> str:
        if self.outgoing:
            return f"{self.incoming}&&{self.outgoing}"
        return str(self.incoming)

    def ids(self) -> Set[int]:
        return set(self.incoming) | set(self.outgoing)

    def committed_index(self, acked_index: Callable[[int], Optional[int]]) -> int:
        """min over both halves (ref: quorum/joint.go:49-56)."""
        return min(
            self.incoming.committed_index(acked_index),
            self.outgoing.committed_index(acked_index),
        )

    def vote_result(self, votes: Dict[int, bool]) -> VoteResult:
        """ref: quorum/joint.go:61-75."""
        r1 = self.incoming.vote_result(votes)
        r2 = self.outgoing.vote_result(votes)
        if r1 == r2:
            return r1
        if VoteResult.VoteLost in (r1, r2):
            return VoteResult.VoteLost
        return VoteResult.VotePending

    def describe(self, acked_index: Callable[[int], Optional[int]]) -> str:
        return MajorityConfig(self.ids()).describe(acked_index)

    def clone(self) -> "JointConfig":
        return JointConfig(set(self.incoming), set(self.outgoing))
