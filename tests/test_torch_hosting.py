"""PyTorch port ↔ JAX reference: the in-process hosting stack.

- The copies (hosting.py, shmfabric.py, faults.py, the multi-raft half
  of functional/checker.py, pkg's env_flag) are pinned to etcd_tpu's by
  their syntax tree, definition by definition; each allowed difference
  is listed and normalized away before the comparison.
- Lockstep differential: three etcd_tpu members and three port members
  (test_chaos.CFG's values, G=8; the port on the CPU) run one seeded
  schedule of ticks, puts, deletes, a transfer, an isolate and heal, a
  joint membership change and a crash and restart, synchronously; after
  every step both clusters must hold equal WAL records, KV snapshots,
  applied indexes, rawnode mirrors and health().
- Cross-boot: a member directory written by one package, with a clean
  or a torn tail, boots a member of the other package to the same
  RowRestores, KV, fences and health.
- Pipelined and synchronous port clusters commit equal streams.
"""

import ast
import dataclasses
import os
import shutil
import time

import pytest

from etcd_tpu.batched import hosting as jhost
from etcd_tpu.batched.state import BatchedConfig as JConfig
from etcd_tpu_torch.batched import hosting as thost
from etcd_tpu_torch.batched.state import BatchedConfig as TConfig
from etcd_tpu_torch.native.walog import segment_records
from etcd_tpu_torch.tools.hosting_lockstep import (
    Lockstep,
    first_diff,
    run_schedule,
    step_clock,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

G, R = 8, 3
# test_chaos.CFG's values (the reference side adds no new XLA compile).
CFG_KW = dict(
    num_groups=G, num_replicas=R, window=16, max_ents_per_msg=4,
    max_props_per_round=4, election_timeout=10, heartbeat_timeout=1,
    pre_vote=True, check_quorum=True, auto_compact=True,
    fleet_summary=True,
)


# -- syntax-tree pins -------------------------------------------------------------


def _drop_docstrings(tree):
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef))
                and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return tree


def defs_of(path: str) -> dict:
    """Qualified name -> syntax tree (docstrings dropped) of every
    function and method; the module's other statements under
    "<module>", a class's under "<Class>"."""
    with open(path) as f:
        tree = _drop_docstrings(ast.parse(f.read()))
    out = {"<module>": []}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            out[node.name] = node
        elif isinstance(node, ast.ClassDef):
            out[f"<{node.name}>"] = node
            rest = []
            for item in node.body:
                if isinstance(item, ast.FunctionDef):
                    out[f"{node.name}.{item.name}"] = item
                else:
                    rest.append(item)
            node.body = rest
        else:
            out["<module>"].append(node)
    return out


class _Normalize(ast.NodeTransformer):
    """Removes the listed differences: arguments and keywords by name,
    statements by a predicate, imported names by name."""

    def __init__(self, args=(), stmt=lambda s: False, names=()):
        self.args, self.stmt, self.names = set(args), stmt, set(names)

    def generic_visit(self, node):
        super().generic_visit(node)
        for field in ("body", "orelse"):
            seq = getattr(node, field, None)
            if isinstance(seq, list):
                setattr(node, field,
                        [s for s in seq if not self.stmt(s)] or seq[:0])
        return node

    def visit_arguments(self, node):
        self.generic_visit(node)
        keep = [(a, d) for a, d in zip(
            node.args[len(node.args) - len(node.defaults):], node.defaults)]
        head = node.args[:len(node.args) - len(node.defaults)]
        keep = [(a, d) for a, d in keep if a.arg not in self.args]
        node.args = [a for a in head if a.arg not in self.args] + [
            a for a, _ in keep]
        node.defaults = [d for _, d in keep]
        kw = [(a, d) for a, d in zip(node.kwonlyargs, node.kw_defaults)
              if a.arg not in self.args]
        node.kwonlyargs = [a for a, _ in kw]
        node.kw_defaults = [d for _, d in kw]
        return node

    def visit_Call(self, node):
        self.generic_visit(node)
        node.keywords = [k for k in node.keywords if k.arg not in self.args]
        return node

    def visit_ImportFrom(self, node):
        node.names = [a for a in node.names if a.name not in self.names]
        return node

    def apply(self, node):
        """A definition, or a list of module statements, normalized."""
        if isinstance(node, list):
            return [self.visit(s) for s in node if not self.stmt(s)]
        return self.visit(node)


def _is_if_on(name):
    return lambda s: (isinstance(s, ast.If) and isinstance(s.test, ast.Name)
                      and s.test.id == name)


def _assigns(target):
    return lambda s: (isinstance(s, (ast.Assign, ast.AnnAssign))
                      and target in ast.unparse(s).split("=")[0])


def _any(*preds):
    return lambda s: any(p(s) for p in preds)


def _is_server_import(s):
    return isinstance(s, ast.ImportFrom) and (s.module or "").startswith(
        "server")


# Per copied module: (reference path, port path, definitions the port
# leaves out, {definition: (reference normalizer, port normalizer)}).
_DEVICE = _Normalize(args=("device",), stmt=_any(
    _is_if_on("mesh_devices"), _assigns("self.device")), names=("_refuse",))
_MESH = _Normalize(args=("mesh",), stmt=_any(
    _is_if_on("mesh_devices"), _assigns("mesh")))
_SAME = _Normalize()
PINS = {
    "batched/hosting.py": ("batched/hosting.py", (), {
        "<module>": (_SAME, _DEVICE),
        "MultiRaftMember.__init__": (_MESH, _DEVICE),
        "MultiRaftCluster.__init__": (_SAME, _DEVICE),
    }),
    "batched/shmfabric.py": ("batched/shmfabric.py", (), {}),
    "batched/faults.py": ("batched/faults.py", (), {
        "ChaosHarness.__init__": (_SAME, _DEVICE),
        "ChaosHarness._boot": (_SAME, _DEVICE),
    }),
    "functional/checker.py": ("functional/checker.py", (
        "hash_check", "lease_expire_check", "linearizable_check"), {
        "<module>": (_Normalize(stmt=_is_server_import), _SAME),
    }),
    "pkg/__init__.py": ("pkg/__init__.py", (), {}),
}


def _dump(node):
    if isinstance(node, list):
        return [ast.dump(n) for n in node]
    return ast.dump(node)


@pytest.mark.parametrize("rel", sorted(PINS))
def test_copy_is_the_reference_code(rel):
    """Every definition of the port's copy equals etcd_tpu's; the listed
    ones equal it once the listed differences (device=, the mesh
    refusal, the server half) are normalized away; nothing else is
    missing or extra."""
    port_rel, left_out, allowed = PINS[rel]
    ref = defs_of(os.path.join(ROOT, "etcd_tpu", rel))
    port = defs_of(os.path.join(ROOT, "etcd_tpu_torch", port_rel))
    assert set(port) == set(ref) - set(left_out), (
        set(port) ^ (set(ref) - set(left_out)))
    for name in sorted(port):
        a, b = ref[name], port[name]
        if name in allowed:
            assert _dump(a) != _dump(b), f"{rel}: {name} no longer differs"
            na, nb = allowed[name]
            a, b = na.apply(a), nb.apply(b)
        assert _dump(a) == _dump(b), f"{rel}: {name}"


def test_mesh_is_refused(tmp_path):
    """mesh_devices > 0 raises before anything is built, naming the
    ROADMAP item (the card machine has one GPU)."""
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        thost.MultiRaftMember(1, 3, G, str(tmp_path), cfg=TConfig(**CFG_KW),
                              mesh_devices=2, device="cpu")
    assert not os.listdir(tmp_path)


def test_env_flag_parse(monkeypatch):
    from etcd_tpu.pkg import env_flag as jflag
    from etcd_tpu_torch.pkg import env_flag as tflag

    for v in ("", "0", "false", "1", "true", "yes", "False"):
        monkeypatch.setenv("ETCD_TPU_WAL_PIPELINE", v)
        assert tflag("ETCD_TPU_WAL_PIPELINE") == jflag(
            "ETCD_TPU_WAL_PIPELINE"), v
        assert thost._env_wal_pipeline() == jhost._env_wal_pipeline()


# -- lockstep differential --------------------------------------------------------


def test_lockstep_port_equals_reference(tmp_path):
    """etcd_tpu members against port members, step by step: WAL records,
    KV, applied index, mirrors (m_view, m_last, m_snap) and health()
    equal after every step of the seeded schedule."""
    seen = []

    def check(s, event, obs):
        diff = first_diff(obs[0], obs[1])
        assert diff is None, f"step {s} ({event or 'round'}): {diff}"
        seen.append(event)

    with step_clock(jhost, thost) as clock:
        a = Lockstep(jhost, str(tmp_path / "jax"), JConfig(**CFG_KW), R, G)
        b = Lockstep(thost, str(tmp_path / "port"), TConfig(**CFG_KW), R, G,
                     device="cpu")
        try:
            counts = run_schedule([a, b], clock, check=check)
        finally:
            a.stop()
            b.stop()
    # The schedule really ran: writes landed, every event fired, the
    # joint change went through, and the restarted member caught up.
    assert counts["puts"] > 100 and counts["deletes"] > 20, counts
    for ev in ("transfer", "isolate", "heal", "demote", "add-learner",
               "promote", "crash", "restart"):
        assert ev in seen, (ev, counts)
    for ev in ("demote", "add-learner", "promote"):
        assert counts[ev] == f"{{{G - 1}: 'ok'}}", counts
    applied = [m.applied_index.tolist() for m in b.members.values()]
    assert applied[0] == applied[1] == applied[2], applied
    # What each member's WAL holds on disk is what it appended.
    from etcd_tpu_torch.native.walog import read_all
    for mid, m in b.members.items():
        recs = [(rt, d) for rt, d, _s, _m in read_all(
            os.path.join(m.dir, "wal"), repair=False)]
        assert recs[-len(b.wal_log[mid][-20:]):] == b.wal_log[mid][-20:]


# -- cross-boot -------------------------------------------------------------------


def _write_member_dir(pkg, root, torn):
    """Run one package's lockstep cluster through some writes, crash
    member 3 and (torn) cut its WAL mid-way into its last entry record.
    Returns member 3's directory."""
    hosting, cfg, kw = ((jhost, JConfig(**CFG_KW), {}) if pkg == "jax"
                        else (thost, TConfig(**CFG_KW), {"device": "cpu"}))
    with step_clock(hosting) as clock:
        c = Lockstep(hosting, root, cfg, R, G, **kw)
        try:
            run_schedule([c], clock, steps=70, puts_per_step=3)
            c.crash(3)
        finally:
            c.stop()
    mdir = os.path.join(root, "member-3")
    if torn:
        wal = os.path.join(mdir, "wal")
        path = os.path.join(wal, sorted(
            f for f in os.listdir(wal) if f.endswith(".wal"))[-1])
        ents = [r for r in segment_records(path)
                if r[1] in (thost.RT_ENTRY, thost.RT_ENTRY_BATCH)]
        off = ents[-1][0]
        os.truncate(path, off + 12 + 5)
    return mdir


def _boot_state(hosting, data_dir, cfg, monkeypatch, **kw):
    """Boot member 3 of `hosting` from data_dir (not started): the
    RowRestores its _replay returned and the state it booted to."""
    got = {}
    replay = hosting.MultiRaftMember._replay

    def spy(self):
        got["restore"] = replay(self)
        return got["restore"]

    monkeypatch.setattr(hosting.MultiRaftMember, "_replay", spy)
    m = hosting.MultiRaftMember(3, R, G, data_dir, cfg=cfg, pipeline=False,
                                **kw)
    try:
        restore = {g: dataclasses.asdict(rr)
                   for g, rr in sorted(got["restore"].items())}
        # One round with no peers re-applies the replayed committed
        # tail to the KV (the first Ready's committed entries).
        m.run_round()
        return {
            "restore": restore,
            "kv": [kv.snapshot() for kv in m.kvs],
            "applied": m.applied_index.tolist(),
            "fenced": m._fenced.tolist(),
            "wm": [x.tolist() for x in (m._wm_last, m._wm_term,
                                        m._wm_commit)],
            "dur": [x.tolist() for x in (m._dur_last, m._dur_term,
                                         m._dur_commit)],
            "conf": m.conf_snapshot(),
            "mirrors": [x.tolist() for x in (m.rn.m_term, m.rn.m_vote,
                                             m.rn.m_commit, m.rn.m_last,
                                             m.rn.m_snap)],
            "health": m.health(),
        }
    finally:
        m.stop()


@pytest.mark.parametrize("torn", [False, True], ids=["clean", "torn"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cross_boot(tmp_path, monkeypatch, writer, torn):
    """A member directory written by one package boots a member of each
    package to the same RowRestores, KV, fences, mirrors and health —
    the WAL record tags and codecs are byte-compatible both ways."""
    mdir = _write_member_dir(writer, str(tmp_path / "w"), torn)
    states = {}
    for pkg, hosting, cfg, kw in (
            ("jax", jhost, JConfig(**CFG_KW), {}),
            ("port", thost, TConfig(**CFG_KW), {"device": "cpu"})):
        root = tmp_path / f"boot-{pkg}"
        shutil.copytree(mdir, root / "member-3")
        states[pkg] = _boot_state(hosting, str(root), cfg, monkeypatch,
                                  **kw)
    diff = first_diff(states["jax"], states["port"])
    assert diff is None, diff
    s = states["port"]
    assert s["health"]["wal_tail"] == ("torn" if torn else "clean")
    assert max(s["applied"]) > 10, s["applied"]
    assert sum(len(rr["entries"]) for rr in s["restore"].values()) > 20
    if torn:
        assert any(s["fenced"]), "a torn acked tail must fence its group"


# -- pipelined against synchronous -----------------------------------------------


def test_pipelined_and_sync_clusters_commit_equal_streams(tmp_path):
    """The pipelined drain (a Ready persisted, applied and sent on the
    drain thread while the next round runs) and the synchronous one
    commit the same per-group streams for the same writes: every member
    applies exactly the written payloads, in write order."""
    streams = {}
    writes = [(g, b"k%d" % (i % 3), b"v%d.%d" % (i, g))
              for i in range(3) for g in range(G)]
    for pipeline in (True, False):
        c = thost.MultiRaftCluster(str(tmp_path / str(pipeline)),
                                   num_members=R, num_groups=G,
                                   cfg=TConfig(**CFG_KW), pipeline=pipeline,
                                   device="cpu")
        logs = {}
        for mid, m in c.members.items():
            for g, kv in enumerate(m.kvs):
                log = logs.setdefault((mid, g), [])
                apply = kv.apply

                def logged(payload, _a=apply, _l=log):
                    _l.append(bytes(payload))
                    _a(payload)

                kv.apply = logged
        try:
            c.wait_leaders()
            for g, k, v in writes:
                c.put(g, k, v, timeout=60.0)
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline and not all(
                    m.get(g, k) == v for m in c.members.values()
                    for g, k, v in writes[-G:]):
                time.sleep(0.05)
        finally:
            c.stop()
        for mid in c.members:
            for g in range(G):
                got = logs[(mid, g)]
                # A retried put may commit twice; the stream is
                # otherwise exactly the writes, in order.
                dedup = [p for i, p in enumerate(got)
                         if i == 0 or p != got[i - 1]]
                want = [thost.GroupKV.put_payload(k, v)
                        for g2, k, v in writes if g2 == g]
                assert dedup == want, (pipeline, mid, g)
                streams.setdefault(pipeline, {})[(mid, g)] = dedup
    assert streams[True] == streams[False]
