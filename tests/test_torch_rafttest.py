"""PyTorch port ↔ JAX reference: the interaction harness (rafttest).

The committed scripts, ``etcd_tpu_torch/rafttest/testdata/*.txt`` (one
per subject of the reference's raft/testdata traces, written for this
repository; each expected block is the JAX package's ``InteractionEnv``
output for its directive), replay through

* both packages' ``parse_file``: equal ``TestData`` lists, field for
  field;
* both packages' ``InteractionEnv``: equal text, equal to the expected
  block as ``run_file`` compares them;
* the port's ``BatchedInteractionEnv`` on the CPU beside the port's
  scalar ``InteractionEnv``: ``state_divergences`` empty after every
  directive, its deep checks (log bounds, applied history, conf state)
  at quiescent points, as tests/batched/test_trace_parity_batched.py
  runs the reference's traces through the JAX package.

The coverage test holds the scripts to every directive that
``InteractionEnv.handle`` dispatches and to replica capacities 1..7; the
negative tests show each comparison failing on a perturbed input. The
batched node's early auto-leave (ROADMAP C24) is shown by a scenario of
its own.
"""

import ast
import dataclasses
import glob
import os

import pytest

from etcd_tpu.rafttest import InteractionEnv as JEnv
from etcd_tpu.rafttest import parse_file as jparse
from etcd_tpu.rafttest import run_file as jrun
from etcd_tpu.rafttest.batched_env import BatchedInteractionEnv as JBatched
from etcd_tpu.rafttest.batched_env import state_divergences as jdivergences
from etcd_tpu_torch.rafttest import InteractionEnv, parse_file, run_file
from etcd_tpu_torch.rafttest.batched_env import (
    BatchedInteractionEnv,
    state_divergences,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(ROOT, "etcd_tpu_torch", "rafttest", "testdata")
SCRIPTS = sorted(glob.glob(os.path.join(TESTDATA, "*.txt")))
IDS = [os.path.basename(p) for p in SCRIPTS]
# The host mirrors state_divergences reads (rawnode.py advance()).
MIRRORS = ("m_term", "m_vote", "m_commit", "m_role", "m_lead", "m_last",
           "m_snap", "m_ring")


def quiescent(d) -> bool:
    """A full stabilize: the deep checks run only where the whole cluster
    has exchanged everything (tests/batched/test_trace_parity_batched.py
    gives the reasons)."""
    return d.cmd == "stabilize" and not any(not a.vals for a in d.cmd_args)


def capacity(path: str) -> int:
    """Replica capacity R of a script: every node it adds."""
    return sum(int(d.cmd_args[0].key) for d in parse_file(path)
               if d.cmd == "add-nodes")


def dispatched_directives() -> set:
    """The directives InteractionEnv.handle dispatches (its dict's keys)."""
    path = os.path.join(ROOT, "etcd_tpu_torch", "rafttest", "interaction.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    handle = next(n for n in ast.walk(tree)
                  if isinstance(n, ast.FunctionDef) and n.name == "handle")
    table = next(n for n in ast.walk(handle) if isinstance(n, ast.Dict))
    return {k.value for k in table.keys}


def test_scripts_cover_every_directive():
    """At least eleven scripts; together they use every directive that
    handle dispatches, drop messages, render errors as text (a proposal
    dropped for want of a leader, a bad log level) and run at every
    replica capacity from 1 to 7."""
    assert len(SCRIPTS) >= 11, IDS
    datas = [d for p in SCRIPTS for d in parse_file(p)]
    assert {d.cmd for d in datas} == dispatched_directives()
    assert any(d.cmd == "deliver-msgs"
               and any(a.key == "drop" and a.vals for a in d.cmd_args)
               for d in datas)
    expected = [d.expected for d in datas]
    assert "raft proposal dropped" in expected
    assert any(e.startswith("log levels must be either of") for e in expected)
    assert {capacity(p) for p in SCRIPTS} == set(range(1, 8))


@pytest.mark.parametrize("path", SCRIPTS, ids=IDS)
def test_parser_matches_reference(path):
    """Both packages' parse_file give the same TestData, field for field."""
    port = [dataclasses.asdict(d) for d in parse_file(path)]
    ref = [dataclasses.asdict(d) for d in jparse(path)]
    assert port == ref
    assert port


def test_parser_double_separator(tmp_path):
    """An expected block with blank lines in the double-separator form,
    beside a plain one and an input line, parses alike in both packages
    and keeps its blank line."""
    path = tmp_path / "double.txt"
    path.write_text(
        "# comment\n"
        "propose-conf-change 1 transition=auto v1=(true, false)\n"
        "v2 v3\n"
        "----\n"
        "----\n"
        "first line\n"
        "\n"
        "after a blank line\n"
        "----\n"
        "----\n"
        "\n"
        "raft-state\n"
        "----\n"
        "ok\n")
    port = parse_file(str(path))
    assert [dataclasses.asdict(d) for d in port] == [
        dataclasses.asdict(d) for d in jparse(str(path))]
    first, second = port
    assert first.expected == "first line\n\nafter a blank line"
    assert first.input == "v2 v3"
    assert [(a.key, a.vals) for a in first.cmd_args] == [
        ("1", []), ("transition", ["auto"]), ("v1", ["true", "false"])]
    assert (second.cmd, second.expected, second.pos) == (
        "raft-state", "ok", f"{path}:12")


@pytest.mark.parametrize("path", SCRIPTS, ids=IDS)
def test_text_matches_reference(path):
    """Every directive's text from the port's InteractionEnv equals the
    JAX package's, byte for byte, and both equal the script's expected
    block as run_file compares them."""
    port, ref = InteractionEnv(), JEnv()
    for d in parse_file(path):
        got, want = port.handle(d), ref.handle(d)
        assert got == want, f"{d.pos}: {d.cmd}"
    assert run_file(path, InteractionEnv().handle) == []
    assert jrun(path, JEnv().handle) == []


@pytest.mark.parametrize("path", SCRIPTS, ids=IDS)
def test_batched_env_matches_scalar_core(path):
    """The port's batched env shows no divergence from the port's scalar
    env after any directive of the script."""
    oracle = InteractionEnv()
    env = BatchedInteractionEnv(capacity(path), device="cpu")
    failures = []
    try:
        for d in parse_file(path):
            oracle.handle(d)
            env.handle(d)
            div = state_divergences(oracle, env, check_conf=quiescent(d))
            if div:
                failures.append((d.pos, d.cmd, div))
    finally:
        env.close()
    assert not failures, "\n".join(f"{p}: {c} {div}"
                                   for p, c, div in failures[:8])


@pytest.fixture(scope="module")
def settled_envs():
    """The scalar and batched envs after the campaign script."""
    path = os.path.join(TESTDATA, "campaign.txt")
    oracle = InteractionEnv()
    env = BatchedInteractionEnv(capacity(path), device="cpu")
    for d in parse_file(path):
        oracle.handle(d)
        env.handle(d)
    yield oracle, env
    env.close()


@pytest.mark.parametrize("mirror", MIRRORS)
def test_state_divergences_sees_a_perturbed_mirror(settled_envs, mirror):
    """One mirror of one node moved: state_divergences names that node
    (the ring at an index of its log); put back, it is empty again."""
    oracle, env = settled_envs
    assert state_divergences(oracle, env) == []
    rn = env.nodes[1].node.rn
    arr = getattr(rn, mirror)
    before = arr.copy()
    if mirror == "m_ring":
        arr[0, int(rn.m_last[0]) % rn.cfg.window] += 1
    else:
        arr[0] += 1
    try:
        div = state_divergences(oracle, env)
    finally:
        arr[...] = before
    assert div and all(line.startswith("node 2 ") for line in div), div
    assert state_divergences(oracle, env) == []


def test_text_check_fails_on_a_changed_character(tmp_path):
    """A copy of a script with one character of one expected block
    changed fails exactly that directive, in both packages."""
    src = os.path.join(TESTDATA, "campaign.txt")
    text = open(src).read()
    at = text.index("INFO 1 became leader at term 1")
    bad = tmp_path / "campaign.txt"
    bad.write_text(text[:at] + "INFO 1 became leader at term 2"
                   + text[at + len("INFO 1 became leader at term 1"):])
    failures = run_file(str(bad), InteractionEnv().handle)
    assert [d.cmd for d, _ in failures] == ["stabilize"]
    assert "became leader at term 1" in failures[0][1]
    assert len(jrun(str(bad), JEnv().handle)) == 1


def test_close_stops_every_node():
    """close() stops every node and drops them and the messages."""
    path = os.path.join(TESTDATA, "single_node.txt")
    env = BatchedInteractionEnv(capacity(path), device="cpu")
    for d in parse_file(path):
        env.handle(d)
    nodes = [bn.node for bn in env.nodes]
    env.close()
    assert nodes and all(n._stopped for n in nodes)
    assert env.nodes == [] and env.messages == []


# ROADMAP C24: a joint configuration with auto-leave, entered while the
# old voters' acks are all in. etcd's raft (the scalar core) appends the
# leave entry in advance() and sends it with the next append or heartbeat
# response; the batched node (both packages) sends it in the round that
# appends it.
AUTO_LEAVE = """
add-nodes 1 voters=(1) index=2
----
ok

campaign 1
----
ok

stabilize
----
ok

propose-conf-change 1 transition=auto
v2 v3
----
ok

add-nodes 2
----
ok

stabilize
----
ok

propose-conf-change 1 transition=auto
r2 r3
----
ok

stabilize
----
ok

tick-heartbeat 1
----
ok

stabilize
----
ok
"""


def test_auto_leave_is_sent_at_once_by_the_batched_node(tmp_path):
    """After the stabilize that commits r2 r3 the scalar core is still in
    the joint configuration (commit 6, the leave entry 7 unsent) while
    both packages' batched envs have left it (commit 7); the heartbeat
    brings the scalar core there too, and nothing diverges after it."""
    path = tmp_path / "auto_leave.txt"
    path.write_text(AUTO_LEAVE)
    datas = parse_file(str(path))
    oracle, joracle = InteractionEnv(), JEnv()
    env, jenv = BatchedInteractionEnv(3, device="cpu"), JBatched(3)
    seen = []
    try:
        for d in datas:
            oracle.handle(d)
            joracle.handle(d)
            env.handle(d)
            jenv.handle(d)
            q = quiescent(d)
            seen.append((state_divergences(oracle, env, check_conf=q),
                         jdivergences(joracle, jenv, check_conf=q)))
        mirrors = [[int(bn.node.rn.m_commit[0]) for bn in e.nodes]
                   for e in (env, jenv)]
    finally:
        env.close()
    stuck = datas.index(next(d for d in datas if d.input == "r2 r3")) + 1
    for k, (port, ref) in enumerate(seen):
        assert port == ref, datas[k].pos
        assert bool(port) == (k in (stuck, stuck + 1)), (datas[k].pos, port)
    assert "node 1 commit: oracle=6 batched=7" in seen[stuck][0]
    assert ("node 1 conf.voters_outgoing: oracle=[1, 2, 3] batched=[]"
            in seen[stuck][0])
    assert mirrors == [[7, 7, 7], [7, 7, 7]]
    assert oracle.nodes[0].rawnode.raft.raft_log.committed == 7
