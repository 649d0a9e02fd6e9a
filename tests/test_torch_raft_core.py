"""PyTorch port ↔ JAX reference: the scalar raft core and the shadow
cluster.

- The copies (etcd_tpu_torch/raft's logger, read_only, log, raft,
  rawnode, util, node, types and __init__, and batched/shadow.py) are
  pinned to etcd_tpu's by their syntax tree, definition by definition.
  The shadow cluster's two listed differences are normalized away (the
  ReadIndex requests of ``round(reads=)``) or held by behaviour
  (``DeviceHashRand`` wraps its sum to int32 as the device does).
- A seeded lockstep differential of three-node RawNode clusters of both
  packages: campaigns, proposals, partitions, ReadIndex, a leader
  transfer, conf changes (a learner added, promoted and removed) and a
  snapshot catch-up. Every Ready (messages, entries, committed entries,
  hard and soft state, read states, snapshot, must_sync) and every log
  line must be equal.
- The same cluster through each package's threaded Node: equal applied
  streams and final states.
- The two packages' ShadowClusters on one schedule, and DeviceHashRand
  against the round's _rand_timeout.
"""

import ast
import dataclasses
import enum
import os
import random
import threading
import time

import pytest
import torch

import etcd_tpu.raft as jraft
import etcd_tpu.raft.node as jnode
import etcd_tpu.raft.types as jtypes
import etcd_tpu_torch.raft as traft
import etcd_tpu_torch.raft.node as tnode
import etcd_tpu_torch.raft.types as ttypes
from etcd_tpu.batched.shadow import ShadowCluster as JShadow
from etcd_tpu_torch.batched.shadow import DeviceHashRand
from etcd_tpu_torch.batched.shadow import ShadowCluster as TShadow
from etcd_tpu_torch.batched.state import BatchedConfig
from etcd_tpu_torch.batched.step import _rand_timeout

from .test_torch_hosting import _dump, _Normalize, defs_of

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- syntax-tree pins ----------------------------------------------------------

_SAME = _Normalize()
_READS = _Normalize(args=("reads",), stmt=lambda s: (
    isinstance(s, ast.For) and ast.unparse(s.iter) == "reads"))
_STATE_TYPE_IMPORT = _Normalize(stmt=lambda s: (
    isinstance(s, ast.ImportFrom) and s.module == "raft.raft"))
# module -> ({definition: (reference normalizer, port normalizer)},
# definitions that differ by design and are held by behaviour).
PINS = {
    "raft/logger.py": ({}, ()),
    "raft/read_only.py": ({}, ()),
    "raft/log.py": ({}, ()),
    "raft/raft.py": ({}, ()),
    "raft/rawnode.py": ({}, ()),
    "raft/util.py": ({}, ()),
    "raft/node.py": ({}, ()),
    "raft/types.py": ({}, ()),
    "raft/__init__.py": ({}, ()),
    "batched/shadow.py": ({
        "<module>": (_SAME, _STATE_TYPE_IMPORT),
        "ShadowCluster.round": (_SAME, _READS),
    }, ("DeviceHashRand.randrange",)),
}


@pytest.mark.parametrize("rel", sorted(PINS))
def test_copy_is_the_reference_code(rel):
    """Every definition of the port's copy equals etcd_tpu's, the listed
    ones once their listed difference is normalized away; nothing is
    missing or extra."""
    allowed, behaviour = PINS[rel]
    ref = defs_of(os.path.join(ROOT, "etcd_tpu", rel))
    port = defs_of(os.path.join(ROOT, "etcd_tpu_torch", rel))
    assert set(port) == set(ref), set(port) ^ set(ref)
    for name in sorted(port):
        a, b = ref[name], port[name]
        if name in behaviour:
            assert _dump(a) != _dump(b), f"{rel}: {name} no longer differs"
            continue
        if name in allowed:
            assert _dump(a) != _dump(b), f"{rel}: {name} no longer differs"
            na, nb = allowed[name]
            a, b = na.apply(a), nb.apply(b)
        assert _dump(a) == _dump(b), f"{rel}: {name}"


def test_core_imports_no_torch():
    """The scalar core is host code: importing it loads no torch."""
    import subprocess
    import sys

    code = ("import sys, etcd_tpu_torch.raft, etcd_tpu_torch.raft.node, "
            "etcd_tpu_torch.raft.util; print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


# -- the scalar cluster, both packages in lockstep ------------------------------


class Recorder:
    """A raft Logger that keeps its lines (the two packages' Logger
    interfaces are the same)."""

    def __init__(self):
        self.lines = []

    def _rec(self, level, fmt, args):
        self.lines.append((level, fmt % args if args else fmt))

    def debugf(self, fmt, *args):
        self._rec("DEBUG", fmt, args)

    def infof(self, fmt, *args):
        self._rec("INFO", fmt, args)

    def warningf(self, fmt, *args):
        self._rec("WARN", fmt, args)

    def errorf(self, fmt, *args):
        self._rec("ERROR", fmt, args)

    def error(self, *args):
        self._rec("ERROR", " ".join(str(a) for a in args), ())

    def fatalf(self, fmt, *args):
        self._rec("FATAL", fmt, args)

    def panicf(self, fmt, *args):
        self._rec("FATAL", fmt, args)
        raise RuntimeError(fmt % args if args else fmt)


def plain(x):
    if dataclasses.is_dataclass(x):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, enum.Enum):
        return int(x)
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, dict):
        return {k: plain(v) for k, v in sorted(x.items())}
    return x


def boot_storage(pkg, types, voters):
    s = pkg.MemoryStorage()
    if voters:
        s.apply_snapshot(types.Snapshot(metadata=types.SnapshotMetadata(
            conf_state=types.ConfState(voters=list(voters)), index=2,
            term=1)))
    return s


class Cluster:
    """RawNodes of one package, pumped synchronously: each pump takes
    every node's Ready in id order, persists it, applies its committed
    conf changes, advances, then delivers the messages in order."""

    def __init__(self, pkg, types, seed: int, voters=(1, 2, 3)):
        self.pkg, self.types, self.seed = pkg, types, seed
        self.log = Recorder()
        self.nodes = {}
        self.applied = {}
        self.cut = set()  # node ids cut off the network
        for nid in voters:
            self.add(nid, voters)

    def add(self, nid, voters=()):
        storage = boot_storage(self.pkg, self.types, voters)
        cfg = self.pkg.Config(
            id=nid, election_tick=10, heartbeat_tick=1, storage=storage,
            max_size_per_msg=1 << 20, max_inflight_msgs=256,
            applied=2 if voters else 0, pre_vote=True, check_quorum=True,
            rand=random.Random(self.seed * 31 + nid), logger=self.log)
        self.nodes[nid] = self.pkg.RawNode(cfg)
        self.applied[nid] = []

    def pump(self) -> list:
        digests, msgs = [], []
        for nid in sorted(self.nodes):
            rn = self.nodes[nid]
            if not rn.has_ready():
                continue
            rd = rn.ready()
            digests.append((nid, plain(rd)))
            st = rn.raft.raft_log.storage
            if not self.types.is_empty_hard_state(rd.hard_state):
                st.set_hard_state(rd.hard_state)
            if not self.types.is_empty_snap(rd.snapshot):
                st.apply_snapshot(rd.snapshot)
            st.append(rd.entries)
            for e in rd.committed_entries:
                self.applied[nid].append((e.index, e.term, int(e.type),
                                          e.data))
                if e.type == self.types.EntryType.EntryConfChange:
                    rn.apply_conf_change(
                        self.types.ConfChange.unmarshal(e.data))
                elif e.type == self.types.EntryType.EntryConfChangeV2:
                    rn.apply_conf_change(
                        self.types.ConfChangeV2.unmarshal(e.data))
            msgs.extend(rd.messages)
            rn.advance(rd)
        for m in msgs:
            if m.to not in self.nodes or m.to in self.cut or (
                    m.from_ in self.cut):
                continue
            if m.type == self.types.MessageType.MsgSnap:
                self.nodes[m.from_].report_snapshot(m.to, False)
            try:
                self.nodes[m.to].step(m)
            except Exception as e:  # noqa: BLE001 — both sides alike
                digests.append(("step", type(e).__name__))
        return digests

    def settle(self, k: int = 8) -> list:
        return [d for _ in range(k) for d in self.pump()]

    def leader(self):
        for nid, rn in sorted(self.nodes.items()):
            if rn.raft.state == self.pkg.StateType.StateLeader:
                return nid
        return None

    def compact(self, nid):
        rn = self.nodes[nid]
        st = rn.raft.raft_log.storage
        idx = rn.raft.raft_log.applied
        st.create_snapshot(idx, rn.raft.prs.conf_state(), b"snap-%d" % idx)
        st.compact(idx)


def schedule(seed: int):
    """A seeded list of operations on a three-node cluster."""
    rng = random.Random(seed)
    ops = [("campaign", 1), ("settle",)]
    for i in range(6):
        ops.append(("propose", rng.randint(1, 3), b"a%d" % i))
    ops += [("settle",), ("read", b"r1"), ("settle",)]
    ops += [("cut", 3)] + [("propose", 0, b"c%d" % i) for i in range(5)]
    ops += [("settle",), ("compact",), ("heal", 3), ("tick", 3),
            ("settle",)]
    ops += [("transfer", 2), ("tick", 4), ("settle",)]
    ops += [("conf", "add_learner", 4), ("settle",), ("tick", 2),
            ("settle",), ("conf", "promote", 4), ("settle",)]
    for i in range(4):
        ops.append(("propose", rng.randint(1, 4), b"d%d" % i))
    ops += [("tick", 3), ("settle",), ("conf", "remove", 1), ("settle",),
            ("tick", 25), ("settle",), ("read", b"r2"), ("tick", 2),
            ("settle",)]
    return ops


def apply_op(c: Cluster, op) -> list:
    kind = op[0]
    t = c.types
    if kind == "settle":
        return c.settle()
    if kind == "campaign":
        c.nodes[op[1]].campaign()
    elif kind == "propose":
        nid = op[1] or c.leader()
        c.nodes[nid].propose(op[2])
    elif kind == "read":
        c.nodes[c.leader()].read_index(op[1])
    elif kind == "cut":
        c.cut.add(op[1])
    elif kind == "heal":
        c.cut.discard(op[1])
    elif kind == "compact":
        c.compact(c.leader())
    elif kind == "tick":
        out = []
        for _ in range(op[1]):
            for rn in c.nodes.values():
                rn.tick()
            out += c.pump()
        return out
    elif kind == "transfer":
        c.nodes[c.leader()].transfer_leader(op[1])
    elif kind == "conf":
        action, nid = op[1], op[2]
        typ = {"add_learner": t.ConfChangeType.ConfChangeAddLearnerNode,
               "promote": t.ConfChangeType.ConfChangeAddNode,
               "remove": t.ConfChangeType.ConfChangeRemoveNode}[action]
        if action == "add_learner":
            c.add(nid)
        cc = t.ConfChangeV2(changes=[t.ConfChangeSingle(typ, nid)])
        c.nodes[c.leader()].propose_conf_change(cc)
    return c.pump()


@pytest.mark.parametrize("seed", [1, 7, 23])
def test_rawnode_clusters_lockstep(seed):
    a = Cluster(jraft, jtypes, seed)
    b = Cluster(traft, ttypes, seed)
    for j, op in enumerate(schedule(seed)):
        da, db = apply_op(a, op), apply_op(b, op)
        assert da == db, f"op {j} {op}: Readys differ"
        assert a.log.lines == b.log.lines, f"op {j} {op}: log lines differ"
        assert a.applied == b.applied, f"op {j} {op}"
    # The schedule did what it says: the learner was promoted, node 1
    # removed, a snapshot installed, reads served.
    lead = b.leader()
    assert lead not in (None, 1)
    r = b.nodes[lead].raft
    assert sorted(r.prs.voter_nodes()) == [2, 3, 4]
    text = "\n".join(line for _, line in b.log.lines)
    assert "restored snapshot" in text or "starts to restore" in text
    assert len(b.applied[lead]) > 15


# -- the threaded Node, both packages -----------------------------------------


class NodeCluster:
    """Three threaded Nodes of one package and a pump thread each side
    steps synchronously from the test: ready → persist → apply conf
    changes → advance → deliver."""

    def __init__(self, pkg, types, nodemod, seed):
        self.pkg, self.types = pkg, types
        self.nodes, self.storages, self.applied = {}, {}, {}
        for nid in (1, 2, 3):
            st = pkg.MemoryStorage()
            cfg = pkg.Config(
                id=nid, election_tick=10, heartbeat_tick=1, storage=st,
                max_size_per_msg=1 << 20, max_inflight_msgs=256,
                pre_vote=True, check_quorum=True,
                rand=random.Random(seed * 31 + nid), logger=Recorder())
            self.storages[nid] = st
            self.applied[nid] = []
            self.nodes[nid] = nodemod.Node.start(
                cfg, [nodemod.Peer(id=i) for i in (1, 2, 3)])

    def pump(self, rounds: int = 1) -> None:
        for _ in range(rounds):
            for n in self.nodes.values():
                n.tick()
            msgs = []
            for nid, n in sorted(self.nodes.items()):
                rd = n.ready(timeout=0.02)
                if rd is None:
                    continue
                st = self.storages[nid]
                if not self.types.is_empty_hard_state(rd.hard_state):
                    st.set_hard_state(rd.hard_state)
                st.append(rd.entries)
                for e in rd.committed_entries:
                    self.applied[nid].append((e.index, e.term,
                                              int(e.type), e.data))
                    if e.type == self.types.EntryType.EntryConfChange:
                        n.apply_conf_change(
                            self.types.ConfChange.unmarshal(e.data))
                msgs.extend(rd.messages)
                n.advance()
            for m in msgs:
                self.nodes[m.to].step(m)

    def until(self, pred, what, timeout=20.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self.pump()
            if pred():
                return
        raise AssertionError(f"timed out: {what}")

    def lead(self):
        st = self.nodes[1].status()
        return st.basic.soft_state.lead

    def stop(self):
        for n in self.nodes.values():
            n.stop()


def data(applied):
    """The normal entries with data of an applied stream."""
    return [e for e in applied if e[2] == 0 and e[3]]


def drive_nodes(pkg, types, nodemod):
    c = NodeCluster(pkg, types, nodemod, seed=5)
    try:
        c.pump(3)
        c.nodes[1].campaign()
        c.until(lambda: c.lead() == 1, "leader 1")
        done = threading.Event()

        def propose():
            for i in range(12):
                c.nodes[1].propose(b"p%d" % i, timeout=10.0)
            done.set()

        t = threading.Thread(target=propose)
        t.start()
        c.until(done.is_set, "proposals accepted")
        t.join()
        c.until(lambda: all(len(data(c.applied[i])) == 12
                            for i in (1, 2, 3)), "applied everywhere")
        c.nodes[1].transfer_leadership(1, 2)
        c.until(lambda: c.lead() == 2, "transfer to 2")
        return {nid: data(a) for nid, a in c.applied.items()}
    finally:
        c.stop()


def test_threaded_node_clusters_agree():
    """Each package's threaded Node cluster, driven by the same steps,
    applies the same entries in the same order on every node and
    transfers leadership the same way."""
    want = drive_nodes(jraft, jtypes, jnode)
    got = drive_nodes(traft, ttypes, tnode)
    assert got == want
    assert [d for _, _, _, d in got[3]] == [b"p%d" % i for i in range(12)]


# -- the shadow clusters of both packages -----------------------------------------


@pytest.mark.parametrize("shape", ["lanes", "merged", "vectorized"])
def test_shadow_clusters_agree(shape):
    """The two packages' ShadowClusters on one schedule with timer
    elections, proposals, a partition and auto-compaction:
    equal snapshot states, logs and inboxes after every round."""
    kw = dict(election_timeout=6, heartbeat_timeout=1,
              deterministic_timeouts=True, auto_compact_window=16,
              max_ents=16, deliver_shape=shape, group=1)
    a, b = JShadow(3, **kw), TShadow(3, **kw)
    rng = random.Random(11)
    for rnd in range(80):
        lead = [s for s, n in enumerate(b.nodes)
                if n.raft.state == traft.StateType.StateLeader]
        step = dict(tick=True)
        if lead and rng.random() < 0.5:
            step["proposals"] = {lead[0]: rng.randint(1, 3)}
        if 30 <= rnd < 36:
            step["isolate"] = [rnd % 3]
        a.round(**step)
        b.round(**step)
        assert a.snapshot_state() == b.snapshot_state(), rnd
        assert plain(a.inbox) == plain(b.inbox), rnd
    for s in range(3):
        assert a.log_terms(s) == b.log_terms(s)
    assert max(c for _, _, _, c, _ in b.snapshot_state()) > 10


def test_device_hash_rand_is_the_rounds_hash():
    """DeviceHashRand's n-th call equals the round's _rand_timeout at
    reset count n, for every instance and election timeout tried,
    including sums past 2^31 that the device's int32 wraps."""
    for et in (4, 10, 1 << 20):
        cfg = BatchedConfig(num_groups=1, num_replicas=3, window=8,
                            max_ents_per_msg=2, max_props_per_round=1,
                            election_timeout=et)
        for iid in (0, 1, 2, 97, 300_000, 2**30):
            d = DeviceHashRand(iid)
            for n in (0, 1, 2, 3, 20_505, 20_506, 10**6):
                d.n = n
                got = et + d.randrange(et)
                want = _rand_timeout(
                    cfg, torch.tensor([iid], dtype=torch.int32),
                    torch.tensor([n], dtype=torch.int32))
                assert want.dtype == torch.int32
                assert got == int(want[0]), (et, iid, n)
    # Below the wrap it is the reference's sequence.
    from etcd_tpu.batched.shadow import DeviceHashRand as JHash

    j, t = JHash(5), DeviceHashRand(5)
    assert [j.randrange(10) for _ in range(50)] == [
        t.randrange(10) for _ in range(50)]
