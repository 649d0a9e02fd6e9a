"""What decides ``correct``: the program's sampled groups held, value for
value, against a plain Raft group (``reference/raft.py``) that is given
what the benchmark handed the program, and the guarantees held on every
group.

The reference is independent of the program: plain Python written from
etcd's raft, sharing no code, weights or state with it. It starts every
sampled group from nothing, as the program's set-up did (a campaign on
slot 0, then the set-up's rounds), and runs every round of the run with
the tick and the proposals offered to slot 0 that the program had. It
compares

* after every round, each sampled leader's commit watermark with the
  one the loop recorded from the program;
* at every copy the loop took of the sampled groups' rows (before the
  first recorded round, every ``every`` rounds, and after the last),
  each replica's term, role, leader, last index, commit index and, as
  a leader, each peer's match.

Groups are independent in the engine, so a sample is a sample of
answers: every round of the sampled groups is compared, at the
program's own sizes. Over every group, the loop counted rounds that
broke a guarantee (``loop.Loop._guard``).

The numbers compared, each with its limit (an exact comparison: 0):
``ref_mismatches`` (values that differ from the reference's),
``guarantee_breaks`` (group rounds that broke a guarantee) and
``uncommitted`` (the window's proposals not committed by the end of
the drain).
"""

from __future__ import annotations

import sys
from typing import Dict, List

import torch

from .reference.raft import (CANDIDATE, FOLLOWER, LEADER, PRECANDIDATE,
                             Group)

LIMITS = {"ref_mismatches": 0, "guarantee_breaks": 0, "uncommitted": 0}

# The fields compared at each copy, as the program's state names them.
FIELDS = ("term", "role", "lead", "last", "commit", "match")
# The program's encoding of a role, and of a leader (its slot + 1; 0 for
# none).
ROLE_CODE = {FOLLOWER: 0, CANDIDATE: 1, LEADER: 2, PRECANDIDATE: 3}


def _values(groups: List[Group]) -> Dict[str, list]:
    """The reference's FIELDS over the sampled rows, in the program's
    encoding and row order."""
    reps = [rep for g in groups for rep in g.replicas]
    return {
        "term": [rep.term for rep in reps],
        "role": [ROLE_CODE[rep.role] for rep in reps],
        "lead": [0 if rep.lead is None else rep.lead + 1 for rep in reps],
        "last": [rep.last for rep in reps],
        "commit": [rep.commit for rep in reps],
        # A follower's progress is what its last reset left: its own
        # last index then, 0 for the others.
        "match": [list(rep.match) for rep in reps],
    }


def _differ(groups: List[Group], ck: Dict[str, torch.Tensor], k: int,
            label: str) -> int:
    n = 0
    for name, mine in _values(groups).items():
        theirs = ck[name][k].tolist()
        if theirs != mine:
            bad = sum(a != b for a, b in zip(theirs, mine)) if \
                name != "match" else sum(
                    x != y for a, b in zip(theirs, mine)
                    for x, y in zip(a, b))
            print(f"check: {name} differs from the reference in {bad} "
                  f"values at {label}", file=sys.stderr)
            n += bad
    return n


def replay(cfg_fields: dict, groups: int, setup_ticks: List[bool],
           ticks: List[bool], offered: torch.Tensor, commits: torch.Tensor,
           ck: Dict[str, torch.Tensor], every: int) -> int:
    """ref_mismatches (module docstring) of `groups` sampled groups.
    `offered` and `commits` are [rounds, groups]: each sampled leader's
    offered count and its commit watermark after each round; `ck` each
    of FIELDS' copies of the sampled rows, [n_ck, groups * R, ...]."""
    ref = [Group(cfg_fields) for _ in range(groups)]
    for g in ref:
        g.round(False, campaign=(0,))
        for t in setup_ticks:
            g.round(t)
    bad = _differ(ref, ck, 0, "the start")
    offered, commits = offered.tolist(), commits.tolist()
    rounds = len(ticks)
    lead_bad = 0
    for i, tick in enumerate(ticks):
        for g, props, commit in zip(ref, offered[i], commits[i]):
            g.round(tick, props)
            lead_bad += g.replicas[0].commit != commit
        if (i + 1) % every == 0:
            bad += _differ(ref, ck, (i + 1) // every, f"round {i + 1}")
    if rounds % every:
        bad += _differ(ref, ck, rounds // every + 1, f"round {rounds}")
    if lead_bad:
        print(f"check: {lead_bad} leader commit watermarks differ from the "
              "reference's", file=sys.stderr)
    return bad + lead_bad
