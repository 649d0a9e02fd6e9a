"""The batched engine against the shadow cluster, in lockstep.

One ``MultiRaftEngine`` (on the CPU or the card) and one
``ShadowCluster`` per group, both of this package, step the same
schedule; after every round each instance's (term, role, lead, commit,
last) must equal its oracle replica's, and at the end every log term
too. The shadow replays the delivery order of the engine's deliver
shape, so the three shapes are each held against an independent Raft
(``etcd_tpu_torch.raft``).

The configs and schedules are those of the JAX package's
tests/batched/test_differential.py and test_deliver_shapes.py:
contested elections, replication, a partitioned leader's torn tail
repaired on heal, ReadIndex confirmation; ``soak`` is
test_differential_wide's random soak. ``widen`` runs a schedule written
for two groups on any number of groups, each group taking one of them
with its slots rotated.

    pair = Pair(diff_config(groups=64, shape="lanes"), device="cuda")
    pair.run(widen(SCHEDULES["contested_elections"], 64))
    pair.compare_logs()
"""

from __future__ import annotations

import random
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..batched import BatchedConfig, MultiRaftEngine
from ..batched.shadow import ShadowCluster
from ..batched.state import LEADER

R = 3
ET = 1 << 20  # no timer elections inside the strict envelope
SHAPES = ("lanes", "merged", "vectorized")

# Every protocol-visible field of BatchedState, send flags included
# (test_deliver_shapes.STATE_FIELDS of the JAX package).
STATE_FIELDS = (
    "term", "vote", "role", "lead", "log_term", "snap_index",
    "snap_term", "last", "commit", "applied", "match", "next",
    "pr_state", "probe_sent", "pending_snapshot", "recent_active",
    "inflight", "votes", "read_seq", "read_index", "read_acks",
    "read_ready", "read_req_latch", "send_append", "send_heartbeat",
    "send_vote_req", "transferee", "transfer_sent",
)


def diff_config(groups: int = 2, shape: str = "lanes",
                **kw) -> BatchedConfig:
    """test_differential's (and test_deliver_shapes') engine config:
    R=3, W=64, E=16, P=4, no timer elections, unbounded inflight."""
    base = dict(num_groups=groups, num_replicas=R, window=64,
                max_ents_per_msg=16, max_props_per_round=4,
                election_timeout=ET, heartbeat_timeout=1,
                max_inflight=1 << 20, deliver_shape=shape)
    return BatchedConfig(**{**base, **kw})


def wide_config(groups: int = 1, election_timeout: int = 8,
                window: int = 64, auto_compact: bool = False,
                max_ents: int = 16, shape: str = "auto") -> BatchedConfig:
    """test_differential_wide's config: timer elections, optional
    auto-compaction."""
    return diff_config(groups, shape, window=window,
                       max_ents_per_msg=max_ents,
                       election_timeout=election_timeout,
                       auto_compact=auto_compact)


class Pair:
    """An engine and its shadow clusters, stepped together."""

    def __init__(self, cfg: BatchedConfig, device=None):
        self.eng = MultiRaftEngine(cfg, device=device)
        self.cfg = cfg = self.eng.cfg
        # With timer elections the shadow replays the round's timeout
        # hash, so elections fire on the same rounds.
        deterministic_timeouts = cfg.election_timeout < ET
        self.shadows = [
            ShadowCluster(
                R, election_timeout=cfg.election_timeout,
                heartbeat_timeout=cfg.heartbeat_timeout,
                max_inflight=cfg.max_inflight, pre_vote=cfg.pre_vote,
                group=g, deterministic_timeouts=deterministic_timeouts,
                auto_compact_window=cfg.window if cfg.auto_compact else 0,
                max_ents=cfg.max_ents_per_msg,
                deliver_shape=cfg.deliver_shape)
            for g in range(cfg.num_groups)]
        self.rounds = 0

    def _mask(self, cells, dtype=torch.bool, values=None) -> torch.Tensor:
        x = torch.zeros(self.cfg.num_instances, dtype=dtype)
        for j, (g, s) in enumerate(cells):
            x[g * R + s] = True if values is None else values[j]
        return x.to(self.eng.device)

    def step(self, campaign: Sequence[Tuple[int, int]] = (),
             propose: Optional[Dict[Tuple[int, int], int]] = None,
             tick: bool = False, isolate: Sequence[Tuple[int, int]] = (),
             read: Sequence[Tuple[int, int]] = (),
             drop_pairs: Iterable[Tuple[int, int]] = ()) -> None:
        """One round on both sides. `drop_pairs` cuts directed
        (sender, target) links of every group for the messages this
        round emits."""
        propose = propose or {}
        drop_pairs = list(drop_pairs)
        self.eng.step_round(
            tick=tick, campaign_mask=self._mask(campaign),
            propose_n=self._mask(list(propose), torch.int32,
                                 list(propose.values())),
            isolate=self._mask(isolate), read_req=self._mask(read))
        if drop_pairs:
            valid = self.eng.inbox.valid
            for s, t in drop_pairs:
                valid[t::R, s, :] = False
        for g, sh in enumerate(self.shadows):
            sh.round(
                campaigns=[s for gg, s in campaign if gg == g],
                proposals={s: k for (gg, s), k in propose.items()
                           if gg == g},
                tick=tick, isolate=[s for gg, s in isolate if gg == g],
                drop_pairs=drop_pairs,
                reads=[s for gg, s in read if gg == g])
        self.compare(f"round {self.rounds}")
        self.rounds += 1

    def run(self, schedule: List[dict]) -> "Pair":
        for step in schedule:
            self.step(**step)
        return self

    def device_state(self) -> List[Tuple[int, ...]]:
        """[(term, role, lead, commit, last)] per instance."""
        st = self.eng.state
        cols = [x.cpu().numpy() for x in
                (st.term, st.role, st.lead, st.commit, st.last)]
        return [tuple(int(c[i]) for c in cols)
                for i in range(self.cfg.num_instances)]

    def compare(self, ctx: str) -> None:
        got = self.device_state()
        want = [s for sh in self.shadows for s in sh.snapshot_state()]
        if got != want:
            bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
            i = bad[0]
            raise AssertionError(
                f"{self.cfg.deliver_shape} {ctx}: instance {i} (group "
                f"{i // R} slot {i % R}) device {got[i]} vs shadow "
                f"{want[i]}; {len(bad)} instances differ")

    def device_log(self, inst: int) -> List[Tuple[int, int]]:
        st = self.eng.state
        si, last = int(st.snap_index[inst]), int(st.last[inst])
        ring = st.log_term[inst].cpu().numpy()
        return [(i, int(ring[i % self.cfg.window]))
                for i in range(si + 1, last + 1)]

    def compare_logs(self) -> None:
        """Every instance's log terms equal its replica's."""
        for inst in range(self.cfg.num_instances):
            want = self.shadows[inst // R].log_terms(inst % R)
            if self.device_log(inst) != want:
                raise AssertionError(
                    f"{self.cfg.deliver_shape}: log of instance {inst} "
                    "differs from its shadow replica's")


def quiet(k: int) -> List[dict]:
    return [{} for _ in range(k)]


# The schedules, keyed (group, slot) for two groups.
SCHEDULES: Dict[str, List[dict]] = {
    # test_differential.test_election_and_replication_lockstep
    "election_replication": (
        [{"campaign": [(0, 0), (1, 2)]}] + quiet(4)
        + [{"propose": {(0, 0): 2, (1, 2): 1}}] + quiet(3)
        + [{"propose": {(0, 0): 3}}] + quiet(3)
        + [{"tick": True}] + quiet(3)),
    # test_differential.test_partition_divergence_and_heal_lockstep (its
    # group 0; group 1 elects and idles)
    "partition_heal": (
        [{"campaign": [(0, 0), (1, 1)]}] + quiet(4)
        + [{"propose": {(0, 0): 2}}] + quiet(3)
        + [{"isolate": [(0, 0)], "propose": {(0, 0): 2}}]
        + [{"isolate": [(0, 0)]} for _ in range(2)]
        + [{"isolate": [(0, 0)], "campaign": [(0, 1)]}]
        + [{"isolate": [(0, 0)]} for _ in range(4)]
        + [{"isolate": [(0, 0)], "propose": {(0, 1): 3}}]
        + [{"isolate": [(0, 0)]} for _ in range(4)]
        + [{"tick": True}] + quiet(6)),
    # test_deliver_shapes.test_contested_elections_agree
    "contested_elections": (
        [{"campaign": [(0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2)]}]
        + quiet(3)
        + [{"campaign": [(0, 1), (0, 2), (1, 0), (1, 2)]}] + quiet(4)
        + [{"campaign": [(0, 0), (1, 2)]}] + quiet(4)
        + [{"propose": {(0, 0): 3, (1, 2): 2}}] + quiet(4)),
    # test_deliver_shapes.test_torn_tail_rejection_repair_agree
    "torn_tail": (
        [{"campaign": [(0, 0)]}] + quiet(4)
        + [{"propose": {(0, 0): 2}}] + quiet(3)
        + [{"isolate": [(0, 0)], "propose": {(0, 0): 3}}]
        + [{"isolate": [(0, 0)]} for _ in range(2)]
        + [{"isolate": [(0, 0)], "campaign": [(0, 1)]}]
        + [{"isolate": [(0, 0)]} for _ in range(4)]
        + [{"isolate": [(0, 0)], "propose": {(0, 1): 2}}]
        + [{"isolate": [(0, 0)]} for _ in range(4)]
        + [{"tick": True}] + quiet(6)),
    # test_deliver_shapes.test_readindex_confirmation_agrees
    "readindex": (
        [{"campaign": [(0, 0), (1, 1)]}] + quiet(4)
        + [{"propose": {(0, 0): 2, (1, 1): 1}}] + quiet(3)
        + [{"read": [(0, 0), (1, 1)]}] + quiet(4)
        + [{"read": [(0, 0)]}] + quiet(4)),
}


def widen(schedule: List[dict], groups: int) -> List[dict]:
    """A two-group schedule on `groups` groups: group g plays group
    g % 2 of the schedule with its slots rotated by (g // 2) % R."""
    def cells(pairs):
        return [(g, (s + (g // 2) % R) % R)
                for g in range(groups) for gg, s in pairs if gg == g % 2]

    out = []
    for step in schedule:
        wide = {k: v for k, v in step.items()
                if k not in ("campaign", "isolate", "read", "propose")}
        for k in ("campaign", "isolate", "read"):
            if k in step:
                wide[k] = cells(step[k])
        if "propose" in step:
            wide["propose"] = {
                (g, (s + (g // 2) % R) % R): n for g in range(groups)
                for (gg, s), n in step["propose"].items() if gg == g % 2}
        out.append(wide)
    return out


def state_fields(eng) -> Dict[str, np.ndarray]:
    """STATE_FIELDS of an engine's state, as numpy."""
    return {f: getattr(eng.state, f).cpu().numpy() for f in STATE_FIELDS}


def soak(shape: str, seed: int, device=None) -> Pair:
    """test_differential_wide's long soak: timer elections, rolling
    isolation windows and proposals on each group's leader, with
    auto-compaction, every round compared and every log at the end."""
    rng = random.Random(seed)
    groups = 2
    pair = Pair(wide_config(groups=groups, election_timeout=10,
                            auto_compact=True, shape=shape), device=device)
    n = pair.cfg.num_instances
    iso_until = {}  # instance -> round its isolation lifts
    for rnd in range(300):
        for inst, until in list(iso_until.items()):
            if until <= rnd:
                del iso_until[inst]
        if rng.random() < 0.05 and not iso_until:
            victim = rng.randrange(n)
            iso_until[victim] = rnd + rng.randint(2, 6)
        roles = pair.eng.state.role.cpu().numpy()
        props = {}
        for g in range(groups):
            leads = [s for s in range(R) if roles[g * R + s] == LEADER]
            if leads and rng.random() < 0.4:
                props[(g, leads[0])] = rng.randint(1, 3)
        pair.step(tick=True, propose=props,
                  isolate=[(i // R, i % R) for i in iso_until])
    pair.compare_logs()
    return pair
