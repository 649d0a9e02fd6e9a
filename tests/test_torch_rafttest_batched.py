"""PyTorch port ↔ JAX reference: the batched interaction envs side by side.

The JAX package's ``BatchedInteractionEnv`` and the port's (on the CPU)
replay the same committed script; after every directive each node's
host mirrors (term, vote, commit, role, lead, last index, log floor and
the term ring) are equal as int64 arrays, its applied history is equal
snapshot for snapshot, and the in-flight messages are equal as
``describe_message`` text.

One listed difference (ROADMAP C23): a port follower merges an append
into the one its sender has queued (C18), so when the env delivers two
of a leader's appends together the port's follower acks once where the
JAX package's acks once per append, and the leader's entry-less appends
that those acks drive collapse to the last. The messages are compared
with what a later message of the same sender to the same target
supersedes dropped on both sides (``live``); a test shows the raw lists
differ where the merge fires.

Each replica capacity costs the JAX side one XLA compile of the node
round, so the differential runs the scripts of three capacities: 2
(the single adds), 3 (the elections, the double adds) and 7 (probing).
"""

import os

import numpy as np
import pytest

from etcd_tpu.raft.util import default_entry_formatter as jfmt
from etcd_tpu.raft.util import describe_message as jdescribe
from etcd_tpu.rafttest.batched_env import BatchedInteractionEnv as JBatched
from etcd_tpu_torch.raft.types import MessageType
from etcd_tpu_torch.raft.util import default_entry_formatter, describe_message
from etcd_tpu_torch.rafttest import parse_file
from etcd_tpu_torch.rafttest.batched_env import BatchedInteractionEnv

from .test_torch_rafttest import MIRRORS, SCRIPTS, TESTDATA, capacity

CAPACITIES = (2, 3, 7)
DIFFERENTIAL = [p for p in SCRIPTS if capacity(p) in CAPACITIES]


def live(msgs: list) -> list:
    """`msgs` without each message that a later one of the list
    supersedes (ROADMAP C23): an accepting MsgAppResp by a later
    accepting one of the same sender, target and term with an index as
    high; an entry-less MsgApp by a later entry-less one of the same
    sender, target, term and log position with a commit as high."""
    def supersedes(n, m) -> bool:
        if (int(n.type), n.from_, n.to, n.term) != (
                int(m.type), m.from_, m.to, m.term):
            return False
        if int(m.type) == int(MessageType.MsgAppResp):
            return not m.reject and not n.reject and n.index >= m.index
        if int(m.type) == int(MessageType.MsgApp):
            return (not m.entries and not n.entries
                    and (n.log_term, n.index) == (m.log_term, m.index)
                    and n.commit >= m.commit)
        return False

    return [m for k, m in enumerate(msgs)
            if not any(supersedes(n, m) for n in msgs[k + 1:])]


def history(h: list) -> list:
    return [(s.metadata.index, s.metadata.term, s.data,
             sorted(s.metadata.conf_state.voters),
             sorted(s.metadata.conf_state.learners),
             sorted(s.metadata.conf_state.voters_outgoing),
             sorted(s.metadata.conf_state.learners_next),
             bool(s.metadata.conf_state.auto_leave)) for s in h]


def differences(ref, port, keep=live) -> list:
    """Where the JAX env `ref` and the port's env `port` differ: each
    node's mirrors and applied history, and the in-flight messages
    (through `keep`)."""
    out = []
    if len(ref.nodes) != len(port.nodes):
        return [f"nodes: {len(ref.nodes)} vs {len(port.nodes)}"]
    for i, (a, b) in enumerate(zip(ref.nodes, port.nodes)):
        for name in MIRRORS:
            x = np.asarray(getattr(a.node.rn, name)).astype(np.int64)
            y = np.asarray(getattr(b.node.rn, name)).astype(np.int64)
            if x.dtype != y.dtype or not np.array_equal(x, y):
                out.append(f"node {i + 1} {name}: {x.tolist()} vs "
                           f"{y.tolist()}")
        if history(a.history) != history(b.history):
            out.append(f"node {i + 1} applied history")
    want = [jdescribe(m, jfmt) for m in keep(ref.messages)]
    got = [describe_message(m, default_entry_formatter)
           for m in keep(port.messages)]
    if want != got:
        out.append(f"in flight: {want} vs {got}")
    return out


def side_by_side(path: str, keep=live):
    """Replay `path` through both envs; yields (directive, differences,
    (JAX env, port env)) after each directive, and closes the port's env
    when it ends or is closed."""
    ref = JBatched(capacity(path))
    port = BatchedInteractionEnv(capacity(path), device="cpu")
    try:
        for d in parse_file(path):
            ref.handle(d)
            port.handle(d)
            yield d, differences(ref, port, keep), (ref, port)
    finally:
        port.close()


def test_the_differential_covers_three_capacities():
    assert {capacity(p) for p in DIFFERENTIAL} == set(CAPACITIES)
    assert len(DIFFERENTIAL) >= 7


@pytest.mark.parametrize("path", DIFFERENTIAL,
                         ids=[os.path.basename(p) for p in DIFFERENTIAL])
def test_batched_envs_agree_across_packages(path):
    """Mirror for mirror, history for history and message for message
    after every directive."""
    failures = [(d.pos, d.cmd, diff) for d, diff, _ in side_by_side(path)
                if diff]
    assert not failures, "\n".join(f"{p}: {c} {diff}"
                                   for p, c, diff in failures[:5])


def test_append_merge_fires_between_batched_members():
    """ROADMAP C23: in probe_and_replicate.txt, n1's appends of a1 and
    a2, delivered together, merge at n2 and n3: one ack each from the
    port, one per append from the JAX package. Compared whole, the
    in-flight lists differ there and nowhere else does anything differ;
    through live they are equal."""
    path = os.path.join(TESTDATA, "probe_and_replicate.txt")
    raw = [(d, diff) for d, diff, _ in side_by_side(path, keep=list)
           if diff]
    assert raw, "the merge no longer fires"
    assert all(len(diff) == 1 and diff[0].startswith("in flight")
               for _, diff in raw), raw
    first_d, first = raw[0]
    assert (first_d.cmd, [a.key for a in first_d.cmd_args]) == (
        "process-ready", ["2", "3"])
    assert ("'2->1 MsgAppResp Term:1 Log:0/12', '2->1 MsgAppResp Term:1 "
            "Log:0/13'" in first[0])


@pytest.mark.parametrize("what", ("mirror", "history", "message"))
def test_differential_sees_a_perturbed_port(what):
    """The comparison fails when the port's env is moved in one mirror of
    one node, one applied snapshot, or one in-flight message."""
    steps = side_by_side(os.path.join(TESTDATA, "probe_and_replicate.txt"))
    for d, diff, (ref, port) in steps:
        assert diff == [], d.pos
        if d.cmd == "process-ready":
            break
    else:
        raise AssertionError("no process-ready")
    if what == "mirror":
        port.nodes[2].node.rn.m_commit[0] += 1
        want = "node 3 m_commit"
    elif what == "history":
        port.nodes[0].history[-1].data += b"!"
        want = "node 1 applied history"
    else:
        assert port.messages, "nothing in flight"
        port.messages[-1].commit += 1
        want = "in flight"
    diff = differences(ref, port)
    steps.close()
    assert len(diff) == 1 and diff[0].startswith(want), diff
