"""Joint-consensus configuration changes (ref: raft/confchange/).

Ports ``etcd_tpu/raft/confchange.py`` whole. This is control-plane code:
conf changes run on the host and emit fresh ``[N, R]`` voter/learner
masks that ``batched/node.py`` stages into the device state; correctness
(not throughput) is what matters here.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .quorum import MajorityConfig
from .tracker import Inflights, Progress, ProgressTracker, TrackerConfig
from .types import ConfChangeSingle, ConfChangeType, ConfState


class ConfChangeError(Exception):
    pass


class Changer:
    """ref: raft/confchange/confchange.go:31-34."""

    def __init__(self, tracker: ProgressTracker, last_index: int):
        self.tracker = tracker
        self.last_index = last_index

    # -- public operations ----------------------------------------------------

    def enter_joint(
        self, auto_leave: bool, ccs: List[ConfChangeSingle]
    ) -> Tuple[TrackerConfig, Dict[int, Progress]]:
        """ref: confchange.go:49-76."""
        cfg, prs = self._check_and_copy()
        if _joint(cfg):
            raise ConfChangeError("config is already joint")
        if len(cfg.voters.incoming) == 0:
            # Adding nodes to an empty config is allowed (bootstrap), but a
            # joint transition from nothing is not.
            raise ConfChangeError("can't make a zero-voter config joint")
        cfg.voters.outgoing = MajorityConfig(cfg.voters.incoming)
        self._apply(cfg, prs, ccs)
        cfg.auto_leave = auto_leave
        return _check_and_return(cfg, prs)

    def leave_joint(self) -> Tuple[TrackerConfig, Dict[int, Progress]]:
        """ref: confchange.go:92-123."""
        cfg, prs = self._check_and_copy()
        if not _joint(cfg):
            raise ConfChangeError("can't leave a non-joint config")
        if len(cfg.voters.outgoing) == 0:
            raise ConfChangeError(f"configuration is not joint: {cfg}")
        for vid in list(cfg.learners_next):
            cfg.learners.add(vid)
            prs[vid].is_learner = True
        cfg.learners_next = set()

        for vid in list(cfg.voters.outgoing):
            is_voter = vid in cfg.voters.incoming
            is_learner = vid in cfg.learners
            if not is_voter and not is_learner:
                del prs[vid]
        cfg.voters.outgoing = MajorityConfig()
        cfg.auto_leave = False
        return _check_and_return(cfg, prs)

    def simple(
        self, ccs: List[ConfChangeSingle]
    ) -> Tuple[TrackerConfig, Dict[int, Progress]]:
        """At most one voter change outside a joint config
        (ref: confchange.go:130-147)."""
        cfg, prs = self._check_and_copy()
        if _joint(cfg):
            raise ConfChangeError("can't apply simple config change in joint config")
        self._apply(cfg, prs, ccs)
        if (
            len(
                set(self.tracker.voters.incoming).symmetric_difference(
                    cfg.voters.incoming
                )
            )
            > 1
        ):
            raise ConfChangeError(
                "more than one voter changed without entering joint config"
            )
        return _check_and_return(cfg, prs)

    # -- internals ------------------------------------------------------------

    def _apply(
        self,
        cfg: TrackerConfig,
        prs: Dict[int, Progress],
        ccs: List[ConfChangeSingle],
    ) -> None:
        for cc in ccs:
            if cc.node_id == 0:
                # etcd zeroes the NodeID to mark a change it refused to apply.
                continue
            if cc.type == ConfChangeType.ConfChangeAddNode:
                self._make_voter(cfg, prs, cc.node_id)
            elif cc.type == ConfChangeType.ConfChangeAddLearnerNode:
                self._make_learner(cfg, prs, cc.node_id)
            elif cc.type == ConfChangeType.ConfChangeRemoveNode:
                self._remove(cfg, prs, cc.node_id)
            elif cc.type == ConfChangeType.ConfChangeUpdateNode:
                pass
            else:
                raise ConfChangeError(f"unexpected conf type {cc.type}")
        if len(cfg.voters.incoming) == 0:
            raise ConfChangeError("removed all voters")

    def _make_voter(self, cfg: TrackerConfig, prs: Dict[int, Progress], vid: int) -> None:
        pr = prs.get(vid)
        if pr is None:
            self._init_progress(cfg, prs, vid, is_learner=False)
            return
        pr.is_learner = False
        cfg.learners.discard(vid)
        cfg.learners_next.discard(vid)
        cfg.voters.incoming.add(vid)

    def _make_learner(self, cfg: TrackerConfig, prs: Dict[int, Progress], vid: int) -> None:
        """ref: confchange.go:207-232 — demotions of outgoing voters are
        staged in learners_next until LeaveJoint."""
        pr = prs.get(vid)
        if pr is None:
            self._init_progress(cfg, prs, vid, is_learner=True)
            return
        if pr.is_learner:
            return
        self._remove(cfg, prs, vid)
        prs[vid] = pr
        if vid in cfg.voters.outgoing:
            cfg.learners_next.add(vid)
        else:
            pr.is_learner = True
            cfg.learners.add(vid)

    def _remove(self, cfg: TrackerConfig, prs: Dict[int, Progress], vid: int) -> None:
        if vid not in prs:
            return
        cfg.voters.incoming.discard(vid)
        cfg.learners.discard(vid)
        cfg.learners_next.discard(vid)
        # Keep the Progress while the peer is still an outgoing voter.
        if vid not in cfg.voters.outgoing:
            del prs[vid]

    def _init_progress(
        self, cfg: TrackerConfig, prs: Dict[int, Progress], vid: int, is_learner: bool
    ) -> None:
        if not is_learner:
            cfg.voters.incoming.add(vid)
        else:
            cfg.learners.add(vid)
        # Initializing Next to last_index means the follower is probed with
        # the last index; mark recently-active so CheckQuorum doesn't
        # immediately demote a leader that just added a node.
        prs[vid] = Progress(
            match=0,
            next=self.last_index,
            inflights=Inflights(self.tracker.max_inflight),
            is_learner=is_learner,
            recent_active=True,
        )

    def _check_and_copy(self) -> Tuple[TrackerConfig, Dict[int, Progress]]:
        cfg = self.tracker.config.clone()
        prs = {vid: pr.copy() for vid, pr in self.tracker.progress.items()}
        return _check_and_return(cfg, prs)


def _joint(cfg: TrackerConfig) -> bool:
    return len(cfg.voters.outgoing) > 0


def _check_invariants(cfg: TrackerConfig, prs: Dict[int, Progress]) -> None:
    """ref: confchange.go:283-330."""
    for ids in (cfg.voters.ids(), cfg.learners, cfg.learners_next):
        for vid in ids:
            if vid not in prs:
                raise ConfChangeError(f"no progress for {vid}")
    for vid in cfg.learners_next:
        if vid not in cfg.voters.outgoing:
            raise ConfChangeError(f"{vid} is in LearnersNext, but not Voters[1]")
        if prs[vid].is_learner:
            raise ConfChangeError(
                f"{vid} is in LearnersNext, but is already marked as learner"
            )
    for vid in cfg.learners:
        if vid in cfg.voters.outgoing:
            raise ConfChangeError(f"{vid} is in Learners and Voters[1]")
        if vid in cfg.voters.incoming:
            raise ConfChangeError(f"{vid} is in Learners and Voters[0]")
        if not prs[vid].is_learner:
            raise ConfChangeError(f"{vid} is in Learners, but is not marked as learner")
    if not _joint(cfg):
        if cfg.learners_next:
            raise ConfChangeError("cfg.LearnersNext must be nil when not joint")
        if cfg.auto_leave:
            raise ConfChangeError("AutoLeave must be false when not joint")


def _check_and_return(
    cfg: TrackerConfig, prs: Dict[int, Progress]
) -> Tuple[TrackerConfig, Dict[int, Progress]]:
    _check_invariants(cfg, prs)
    return cfg, prs


def to_conf_change_single(cs: ConfState) -> Tuple[List[ConfChangeSingle], List[ConfChangeSingle]]:
    """Translate a ConfState into (outgoing, incoming) op slices
    (ref: confchange/restore.go:26-100)."""
    out: List[ConfChangeSingle] = []
    in_: List[ConfChangeSingle] = []
    for vid in cs.voters_outgoing:
        out.append(ConfChangeSingle(ConfChangeType.ConfChangeAddNode, vid))
    for vid in cs.voters_outgoing:
        in_.append(ConfChangeSingle(ConfChangeType.ConfChangeRemoveNode, vid))
    for vid in cs.voters:
        in_.append(ConfChangeSingle(ConfChangeType.ConfChangeAddNode, vid))
    for vid in cs.learners:
        in_.append(ConfChangeSingle(ConfChangeType.ConfChangeAddLearnerNode, vid))
    for vid in cs.learners_next:
        in_.append(ConfChangeSingle(ConfChangeType.ConfChangeAddLearnerNode, vid))
    return out, in_


def restore(
    chg: Changer, cs: ConfState
) -> Tuple[TrackerConfig, Dict[int, Progress]]:
    """Rebuild a configuration from a ConfState
    (ref: confchange/restore.go:116-155)."""
    outgoing, incoming = to_conf_change_single(cs)

    tracker = chg.tracker

    def run(op):
        cfg, prs = op()
        tracker.config = cfg
        tracker.progress = prs

    if not outgoing:
        for cc in incoming:
            run(lambda cc=cc: Changer(tracker, chg.last_index).simple([cc]))
    else:
        # Build the outgoing config first as the active one, then rotate it
        # into place by entering the joint config with the incoming ops.
        for cc in outgoing:
            run(lambda cc=cc: Changer(tracker, chg.last_index).simple([cc]))
        run(lambda: Changer(tracker, chg.last_index).enter_joint(cs.auto_leave, incoming))
    return tracker.config, tracker.progress
