"""The plain reference (portbench/reference/raft.py) on its own: it
imports nothing but the standard library, and a group of it elects,
replicates and commits in the rounds that raft's message passing gives,
worked out here by hand."""

import ast
import json

import pytest

from portbench import spec
from portbench.reference.raft import LEADER, FOLLOWER, Group, OutOfModel


def _cfg(config="r3-100k"):
    with open(spec.HERE / "configs" / f"{config}.json") as f:
        return json.load(f)["engine"]


def test_the_reference_imports_only_the_standard_library():
    tree = ast.parse((spec.HERE / "reference" / "raft.py").read_text())
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert names <= {"__future__", "typing"}, names


@pytest.mark.parametrize("config", ["r3-100k", "r5-10k"])
def test_an_election_and_the_first_commit(config):
    g = Group(_cfg(config))
    lead, *followers = g.replicas
    g.round(False, campaign=(0,))  # a pre-vote campaign; requests sent
    g.round(False)  # pre-votes granted
    g.round(False)  # the pre-vote won: a real campaign at term 1
    assert lead.term == 1 and lead.role != LEADER
    g.round(False)  # votes granted
    assert all(f.term == 1 and f.vote == 0 for f in followers)
    g.round(False)  # elected; the empty entry appended and sent
    assert lead.role == LEADER and lead.last == 1 and lead.commit == 0
    g.round(False)  # the followers append it
    assert all(f.last == 1 and f.lead == 0 and f.role == FOLLOWER
               for f in followers)
    g.round(False)  # the acks commit it on the leader
    assert lead.commit == 1 and all(f.commit == 0 for f in followers)
    g.round(False)  # the followers learn the commit
    assert all(f.commit == 1 for f in followers)


def test_a_full_leader_commits_two_entries_a_round():
    g = Group(_cfg())
    g.round(False, campaign=(0,))
    for _ in range(8):
        g.round(False)
    lead = g.replicas[0]
    for i in range(200):
        g.round(i % 10 == 0, 8 - (lead.last - lead.commit))
    before = lead.commit
    g.round(False, 8 - (lead.last - lead.commit))
    # Two rounds from append to commit, two entries a round.
    assert lead.commit - before == 2 and lead.last - lead.commit == 4
    assert lead.match == [lead.last] + [lead.commit] * 2


def test_a_group_left_without_a_leader_is_out_of_model():
    g = Group(_cfg())
    with pytest.raises(OutOfModel):
        for _ in range(20):
            g.round(True)
