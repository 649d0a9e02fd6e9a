"""Per-group membership state for the batched multi-raft hosting path.

The device already carries the joint-config lanes (``voter`` /
``voter_out`` / ``learner`` / ``in_joint`` in ``state.BatchedState``,
with the joint commit/vote kernels of ``kernels.py`` mirroring
raft/quorum/joint.go) — what was missing is the control plane that
drives them from the replicated log at hosting scale.
:class:`GroupConfStore` is that control plane, G groups at once:

* mask-native: membership lives as ``[G, R]`` numpy bool planes plus a
  ``[G]`` joint flag, the exact shape the device upload wants — a conf
  apply is a handful of row flips, and a thousand groups reconfiguring
  in one round stage as ONE bulk mask upload
  (``BatchedRawNode.set_membership_many``);
* joint-consensus semantics match the reference Changer
  (raft/confchange/confchange.go): enter-joint snapshots the incoming
  voters into the outgoing half, demotions defer to ``learner_next``
  until leave-joint, simple changes are limited to one voter delta, a
  change that would zero the electorate is refused;
* idempotent by log index: every apply carries the entry's index and
  is skipped at-or-below the per-group ``applied_index`` watermark, so
  boot-time WAL replay and the post-boot Ready re-delivery of the same
  committed suffix cannot double-apply a change;
* refusals are deterministic: an illegal change (double-enter-joint,
  leaving a non-joint config, zeroing the voters) is REFUSED — state
  untouched, reason returned — and every member refuses identically
  because they apply identical bytes at identical indexes (the
  reference zeroes the NodeID for the same reason, raft.go:896);
* audited: a bounded per-group history of applied configs feeds
  ``functional.checker.check_config_safety`` (committed configs never
  diverge, adjacent configs always share a quorum, joint always
  exits).

Import-light on purpose (numpy + raft.types only): the hosting layer
owns locking; this module is pure state + semantics.

Ports ``etcd_tpu/batched/membership.py`` whole; the port keeps its own copy and
tests/test_torch_hubs.py pins it equal.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..raft.types import (
    ConfChange,
    ConfChangeType,
    ConfChangeV2,
    ConfState,
    EntryType,
)

# Per-slot membership bits inside WAL conf records and history entries.
SLOT_VOTER = 1
SLOT_VOTER_OUT = 2
SLOT_LEARNER = 4
SLOT_LEARNER_NEXT = 8

# Per-group flags.
FLAG_JOINT = 1
FLAG_AUTO_LEAVE = 2


def conf_record_dtype(num_replicas: int) -> np.dtype:
    """Row layout of an RT_CONF_BATCH WAL record: the group's full
    config at `index` (the last conf entry applied), R-agnostic via a
    per-slot bit subarray."""
    return np.dtype([
        ("group", "<u4"), ("index", "<u8"), ("flags", "u1"),
        ("slots", "u1", (num_replicas,)),
    ])


def decode_conf_entry(data: bytes, etype: int) -> ConfChangeV2:
    """Committed conf-change entry bytes → ConfChangeV2 (V1 entries
    normalize through as_v2, exactly like the reference apply path)."""
    if etype == int(EntryType.EntryConfChange):
        return ConfChange.unmarshal(data).as_v2()
    if etype == int(EntryType.EntryConfChangeV2):
        return ConfChangeV2.unmarshal(data)
    raise ValueError(f"entry type {etype} is not a conf change")


class GroupConfStore:
    """Vectorized per-group membership configs (masks + joint flags),
    with reference joint-consensus apply semantics and a bounded
    applied-config history per group. Boot state mirrors
    ``state.init_state``: every slot a voter, no joint, no learners."""

    HISTORY = 64  # applied configs kept per group for the safety checker

    def __init__(self, num_groups: int, num_replicas: int) -> None:
        g, r = int(num_groups), int(num_replicas)
        self.g, self.r = g, r
        self.voter = np.ones((g, r), bool)
        self.voter_out = np.zeros((g, r), bool)
        self.learner = np.zeros((g, r), bool)
        # Demotions inside a joint config park here until leave-joint
        # (the reference's learners_next: an outgoing voter cannot be a
        # learner while its vote still counts in the old half).
        self.learner_next = np.zeros((g, r), bool)
        self.in_joint = np.zeros(g, bool)
        self.auto_leave = np.zeros(g, bool)
        # Log index of the last conf entry APPLIED per group (0 = boot
        # config). The idempotence watermark for replay/re-delivery.
        self.applied_index = np.zeros(g, np.int64)
        # Conf changes applied per group (refusals excluded).
        self.epoch = np.zeros(g, np.int64)
        self.refused = 0  # deterministic refusals (same on every member)
        self._history: List[Deque[Dict]] = [
            deque(maxlen=self.HISTORY) for _ in range(g)]

    # -- queries ---------------------------------------------------------------

    def is_default(self, group: int) -> bool:
        """True when the group still runs the boot all-voter config."""
        return bool(
            self.voter[group].all()
            and not self.voter_out[group].any()
            and not self.learner[group].any()
            and not self.in_joint[group]
        )

    def non_default_groups(self) -> np.ndarray:
        """Groups whose config differs from the boot all-voter default
        (the rows whose masks must be staged onto the device at boot)."""
        changed = (
            ~self.voter.all(axis=1)
            | self.voter_out.any(axis=1)
            | self.learner.any(axis=1)
            | self.in_joint
        )
        return np.nonzero(changed)[0]

    def conf_state(self, group: int) -> ConfState:
        """Reference-shaped ConfState (member ids = slot + 1) — rides
        outbound snapshot metadata so a rejoining member restores the
        config with the app state."""
        ids = lambda mask: (np.nonzero(mask)[0] + 1).tolist()  # noqa: E731
        return ConfState(
            voters=ids(self.voter[group]),
            learners=ids(self.learner[group]),
            voters_outgoing=ids(self.voter_out[group]),
            learners_next=ids(self.learner_next[group]),
            auto_leave=bool(self.auto_leave[group]),
        )

    def history(self, group: int) -> List[Dict]:
        return list(self._history[group])

    # -- apply -----------------------------------------------------------------

    def apply(self, group: int, index: int,
              cc: ConfChangeV2) -> Optional[str]:
        """Apply one committed conf-change entry. Returns None when the
        config changed, or a reason string when the change was skipped
        (stale replay) or deterministically refused (illegal). Masks
        are untouched on any non-None return; ``applied_index`` always
        advances to `index` — a refused entry is still an applied
        entry, and replaying it must refuse again, not retry."""
        if index <= self.applied_index[group]:
            return "stale"
        self.applied_index[group] = index
        err = self._apply_checked(group, cc)
        if err is not None:
            self.refused += 1
            return err
        self.epoch[group] += 1
        self._history[group].append({
            "index": int(index),
            "voters": tuple(np.nonzero(self.voter[group])[0] + 1),
            "voters_out": tuple(np.nonzero(self.voter_out[group])[0] + 1),
            "learners": tuple(np.nonzero(self.learner[group])[0] + 1),
            "joint": bool(self.in_joint[group]),
        })
        return None

    def _apply_checked(self, g: int, cc: ConfChangeV2) -> Optional[str]:
        bad = [c.node_id for c in cc.changes
               if not 1 <= c.node_id <= self.r]
        if bad:
            return f"targets {bad} outside replica capacity R={self.r}"
        if cc.leave_joint():
            return self._leave_joint(g)
        auto_leave, use_joint = cc.enter_joint()
        if use_joint:
            return self._enter_joint(g, auto_leave, cc)
        return self._simple(g, cc)

    def _leave_joint(self, g: int) -> Optional[str]:
        if not self.in_joint[g]:
            return "not in a joint config"
        # Deferred demotions become learners now that the old half's
        # votes stop counting (ref: confchange.go LeaveJoint).
        self.learner[g] |= self.learner_next[g]
        self.learner_next[g] = False
        self.voter_out[g] = False
        self.in_joint[g] = False
        self.auto_leave[g] = False
        return None

    def _enter_joint(self, g: int, auto_leave: bool,
                     cc: ConfChangeV2) -> Optional[str]:
        if self.in_joint[g]:
            return "already in a joint config"
        if not self.voter[g].any():
            return "can't make a zero-voter config joint"
        old_voter = self.voter[g].copy()
        old_learner = self.learner[g].copy()
        # Outgoing half = the incoming voters at entry (joint.go:49).
        self.voter_out[g] = old_voter
        err = self._apply_changes(g, cc, joint=True)
        if err is not None:
            # Roll back the halves touched above + by _apply_changes.
            self.voter[g] = old_voter
            self.learner[g] = old_learner
            self.voter_out[g] = False
            self.learner_next[g] = False
            return err
        self.in_joint[g] = True
        self.auto_leave[g] = bool(auto_leave)
        return None

    def _simple(self, g: int, cc: ConfChangeV2) -> Optional[str]:
        if self.in_joint[g]:
            # ref: confchange.go:135 — a simple change mid-joint would
            # edit the incoming half behind the outgoing snapshot's
            # back (observed live: a stale duplicate add-learner
            # applying inside a promote's joint window re-demoted the
            # freshly promoted voter).
            return "can't apply simple change in a joint config"
        old_voter = self.voter[g].copy()
        old_learner = self.learner[g].copy()
        err = self._apply_changes(g, cc, joint=False)
        if err is None and int(
                (self.voter[g] ^ old_voter).sum()) > 1:
            err = "more than one voter changed without entering joint"
        if err is not None:
            self.voter[g] = old_voter
            self.learner[g] = old_learner
            self.learner_next[g] = False
            return err
        return None

    def _apply_changes(self, g: int, cc: ConfChangeV2,
                       joint: bool) -> Optional[str]:
        for c in cc.changes:
            if c.node_id == 0:
                continue  # zeroed NodeID = refused upstream; no-op
            s = c.node_id - 1
            if c.type == ConfChangeType.ConfChangeAddNode:
                self.voter[g, s] = True
                self.learner[g, s] = False
                self.learner_next[g, s] = False
            elif c.type == ConfChangeType.ConfChangeAddLearnerNode:
                if joint and self.voter[g, s]:
                    # Demoting an incoming voter inside the joint
                    # entry: park as learner_next until leave-joint.
                    self.voter[g, s] = False
                    self.learner_next[g, s] = True
                else:
                    self.voter[g, s] = False
                    self.learner[g, s] = True
            elif c.type == ConfChangeType.ConfChangeRemoveNode:
                self.voter[g, s] = False
                self.learner[g, s] = False
                self.learner_next[g, s] = False
            elif c.type == ConfChangeType.ConfChangeUpdateNode:
                pass
            else:
                return f"unexpected conf change type {c.type}"
        if not self.voter[g].any():
            return "removed all voters"
        return None

    # -- snapshot restore ------------------------------------------------------

    def restore(self, group: int, index: int, cs: ConfState) -> bool:
        """Install the config carried by an inbound snapshot at
        `index` (ref: confchange/restore.go — the snapshot's ConfState
        supersedes whatever conf entries the skipped log held). Returns
        False when the snapshot is at-or-below the group's applied-conf
        watermark (nothing to do)."""
        if index <= self.applied_index[group]:
            return False
        mask = lambda ids: np.isin(  # noqa: E731
            np.arange(self.r) + 1, np.asarray(list(ids), int))
        self.voter[group] = mask(cs.voters)
        self.voter_out[group] = mask(cs.voters_outgoing)
        self.learner[group] = mask(cs.learners)
        self.learner_next[group] = mask(cs.learners_next)
        self.in_joint[group] = bool(cs.voters_outgoing)
        self.auto_leave[group] = bool(getattr(cs, "auto_leave", False))
        self.applied_index[group] = index
        self.epoch[group] += 1
        self._history[group].append({
            "index": int(index),
            "voters": tuple(sorted(cs.voters)),
            "voters_out": tuple(sorted(cs.voters_outgoing)),
            "learners": tuple(sorted(cs.learners)),
            "joint": bool(cs.voters_outgoing),
            # Snapshot restores SKIP the intermediate conf entries the
            # compacted log held — adjacency audits must re-anchor
            # here instead of flagging the jump as an illegal
            # transition (check_config_safety reads this).
            "restored": True,
        })
        return True

    # -- device masks ----------------------------------------------------------

    def masks(self, rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                               np.ndarray, np.ndarray]:
        """Device-shaped mask planes for `rows` — the exact argument
        shape of ``BatchedRawNode.set_membership_many``. learner_next
        slots stay replication targets (they are outgoing voters), so
        they ride the voter_out plane only; the learner plane flips at
        leave-joint."""
        rows = np.asarray(rows, np.int64)
        return (self.voter[rows], self.voter_out[rows],
                self.learner[rows], self.in_joint[rows])

    # -- WAL record ------------------------------------------------------------

    def pack_groups(self, rows: np.ndarray) -> bytes:
        """Count-prefixed RT_CONF_BATCH payload: each row's full config
        at its applied-conf index. Full-state records (not deltas), so
        replay takes the LATEST record per group and needs nothing
        before it."""
        rows = np.asarray(rows, np.int64)
        dt = conf_record_dtype(self.r)
        rec = np.zeros(len(rows), dt)
        rec["group"] = rows
        rec["index"] = self.applied_index[rows]
        rec["flags"] = (
            self.in_joint[rows] * FLAG_JOINT
            + self.auto_leave[rows] * FLAG_AUTO_LEAVE
        )
        rec["slots"] = (
            self.voter[rows] * SLOT_VOTER
            + self.voter_out[rows] * SLOT_VOTER_OUT
            + self.learner[rows] * SLOT_LEARNER
            + self.learner_next[rows] * SLOT_LEARNER_NEXT
        )
        import struct

        return struct.pack("<I", len(rows)) + rec.tobytes()

    @staticmethod
    def unpack_groups(data: bytes,
                      num_replicas: int) -> Iterator[Tuple[int, int,
                                                           int,
                                                           np.ndarray]]:
        """Yield (group, index, flags, slots[R]) rows of an
        RT_CONF_BATCH record."""
        import struct

        (n,) = struct.unpack_from("<I", data)
        rec = np.frombuffer(data, conf_record_dtype(num_replicas),
                            count=n, offset=4)
        for i in range(n):
            yield (int(rec["group"][i]), int(rec["index"][i]),
                   int(rec["flags"][i]), rec["slots"][i])

    def load_record(self, group: int, index: int, flags: int,
                    slots: np.ndarray) -> None:
        """Install one replayed RT_CONF_BATCH row (latest record per
        group wins; caller feeds them in WAL order)."""
        self.voter[group] = (slots & SLOT_VOTER) != 0
        self.voter_out[group] = (slots & SLOT_VOTER_OUT) != 0
        self.learner[group] = (slots & SLOT_LEARNER) != 0
        self.learner_next[group] = (slots & SLOT_LEARNER_NEXT) != 0
        self.in_joint[group] = bool(flags & FLAG_JOINT)
        self.auto_leave[group] = bool(flags & FLAG_AUTO_LEAVE)
        self.applied_index[group] = index
