"""The port's jitlint (etcd_tpu_torch/analysis/jitlint.py) against the
JAX package's: one seeded violation and one clean case per rule, with
exact rule IDs and line numbers, the waiver semantics, graph
reachability, the repository gates, the CLI, and the helpers copied
from etcd_tpu/analysis/jitlint.py pinned to theirs by syntax tree.

Pure AST: no torch, no device, milliseconds per test.
"""

import ast
import inspect
import os
import subprocess
import sys
import textwrap

import pytest

from etcd_tpu.analysis import jitlint as jax_lint
from etcd_tpu_torch.analysis import jitlint
from etcd_tpu_torch.analysis.jitlint import (
    RULES, _collect_module, collect_files, lint_modules, lint_paths,
    lint_source)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "etcd_tpu_torch")


def run(src, path="fx.py", **kw):
    return lint_source(textwrap.dedent(src), path, **kw)


def hits(findings, waived=False):
    return {(f.line, f.rule) for f in findings if f.waived == waived}


# -----------------------------------------------------------------------------
# One violation per rule, exact (line, rule); and its clean twin
# -----------------------------------------------------------------------------


def test_tensor_branch():
    fs = run("""\
    import torch


    def body(x):
        if x > 0:
            x = x + 1
        while x.sum() > 0:
            x = x - 1
        y = 1 if x else 2
        ok = (x > 0) and (x < 9)
        for v in torch.arange(3):
            y += v
        assert x.any()
        return x, y, ok


    def drive(graphs):
        graphs.run("k", body)
    """)
    assert hits(fs) == {
        (5, "tensor-branch"),   # if on a tensor
        (7, "tensor-branch"),   # while on a tensor
        (9, "tensor-branch"),   # ternary on a tensor
        (10, "tensor-branch"),  # and/or on tensors
        (11, "tensor-branch"),  # iteration over a tensor
        (13, "tensor-branch"),  # assert on a tensor
    }


def test_tensor_branch_clean_forms():
    # `is None`, static attributes and methods, configs, annotated
    # statics, and iteration over a tuple of tensors are all legal.
    fs = run("""\
    import torch


    def body(st, x, y, cfg, n: int, flag: bool, owned: "Set[int]"):
        if x is None or cfg.narrow_lanes:
            x = torch.zeros(3)
        if x.shape[0] > n and flag and x.dim() == 1:
            x = x + 1
        for a, b in zip(st, (x, y)):
            a.copy_(b)
        keep = x if x.data_ptr() not in owned else x.clone()
        return torch.where(x > 0, x, y), keep


    def drive(graphs):
        graphs.run("k", body)
    """)
    assert hits(fs) == set()


def test_host_sync_in_graph():
    fs = run("""\
    import numpy as np
    import torch


    def body(x):
        a = float(x)
        b = x.item()
        c = np.asarray(x)
        d = x.tolist()
        e = x.cpu()
        f = torch.nonzero(x)
        g = x.unique()
        torch.cuda.synchronize()
        return a, b, c, d, e, f, g


    def drive(graphs):
        graphs.run("k", body)
    """)
    assert hits(fs) == {(line, "host-sync-in-graph")
                        for line in range(6, 14)}


def test_host_sync_requires_device_value():
    # Host conversions of host data, and static queries of tensors, are
    # not syncs.
    fs = run("""\
    import torch

    TABLE = [1, 2, 3]


    def body(x):
        n = int(x.shape[0])
        k = len(TABLE) + x.numel()
        return x + n + k


    def drive(graphs):
        graphs.run("k", body)
    """)
    assert hits(fs) == set()


def test_h2d_in_graph():
    fs = run("""\
    import numpy as np
    import torch

    TABLE = [1, 2, 3]


    def body(x):
        t = torch.as_tensor(TABLE, device=x.device)
        u = torch.tensor([1, 2])
        v = np.arange(3)
        return x + t + u + torch.from_numpy(v)


    def drive(graphs):
        graphs.run("k", body)
    """)
    assert hits(fs) == {(8, "h2d-in-graph"), (9, "h2d-in-graph"),
                        (10, "h2d-in-graph"), (11, "h2d-in-graph")}


def test_h2d_sanctioned_form_is_a_cached_builder():
    # A per-device constant made by an lru_cache'd builder: its body
    # runs once per key, on the first eager round, never in a capture.
    fs = run("""\
    import functools

    import numpy as np
    import torch

    TABLE = np.arange(3)


    @functools.lru_cache(maxsize=None)
    def _table(dev):
        return torch.as_tensor(TABLE, device=dev)


    def body(x):
        return x + _table(x.device)


    def drive(graphs):
        graphs.run("k", body)
    """)
    assert hits(fs) == set()


def test_narrow_lane_arith():
    fs = run("""\
    import torch


    def body(x):
        nar = x.to(torch.int8)
        bad = nar + 1
        ok = nar.to(torch.int32) + 1
        return bad, ok


    def drive(graphs):
        graphs.run("k", body)
    """)
    assert hits(fs) == {(6, "narrow-lane-arith")}


def test_narrow_lane_widen_at_entry_contract():
    # An entry root taking BatchedState must not read a narrow lane
    # before widen_state; after widening, access is clean.
    fs = run("""\
    def body(st: BatchedState, tick):
        early = st.role
        st = widen_state(st)
        late = st.role
        return early, late


    def drive(graphs):
        graphs.run("k", body)
    """)
    assert hits(fs) == {(2, "narrow-lane-arith")}


def test_impure_graph():
    fs = run("""\
    import time

    import numpy as np


    def body(x):
        t = time.time()
        r = np.random.rand()
        return x + t + r


    def drive(graphs):
        graphs.run("k", body)
    """)
    assert hits(fs) == {(7, "impure-graph"), (8, "impure-graph")}


def test_impure_only_in_graph_code():
    fs = run("""\
    import time


    def host(x):
        return x, time.time()
    """)
    assert hits(fs) == set()


def test_dict_order_static():
    fs = run("""\
    import functools

    D = {"b": 1, "a": 2}


    @functools.lru_cache(maxsize=None)
    def build(names):
        return names


    def body():
        pass


    def drive(graphs):
        graphs.run(tuple(D.keys()), body)
        graphs.run(tuple(sorted(D.keys())), body)
        build(frozenset(D))
        build(tuple(sorted(D)))
    """)
    assert hits(fs) == {(16, "dict-order-static"), (18, "dict-order-static")}


def test_sync_in_loop():
    fs = run("""\
    import torch


    def host_collect(rows):
        out = []
        for r in rows:
            out.append(r.item())
        for r in rows:
            out.append(r.to("cpu"))
        bulk = torch.stack(rows).cpu()
        return out, bulk
    """)
    assert hits(fs) == {(7, "sync-in-loop"), (9, "sync-in-loop")}


def test_sync_in_loop_through_a_syncing_method():
    # A call of a function of the analysed set that syncs (here through
    # a helper within its module) is a sync too; a for's iterable runs
    # once and is not inside the loop.
    fs = run("""\
    import torch


    class Engine:
        def _host(self, x):
            return x.to("cpu", copy=True).numpy()

        def commits(self):
            return self._host(self.commit)


    def wait(eng, base):
        while eng.commits().min() <= base:
            eng.step()
        for c in eng.commits():
            print(c)
    """)
    assert hits(fs) == {(13, "sync-in-loop")}


def test_sync_in_loop_only_in_torch_modules():
    # The same loop in a numpy-only module is host-pure by construction.
    fs = run("""\
    import numpy as np


    def loop_collect(rows):
        out = []
        for r in rows:
            out.append(r.item())
        return out
    """)
    assert hits(fs) == set()


# -----------------------------------------------------------------------------
# Waivers (the JAX pass's, unchanged)
# -----------------------------------------------------------------------------


def test_waived_finding_suppressed_and_reported_waived():
    fs = run("""\
    import torch


    def host(rows):
        for r in rows:
            x = r.item()  # jitlint: waive(sync-in-loop) -- test fixture reason
        return x
    """)
    assert hits(fs) == set()
    assert hits(fs, waived=True) == {(6, "sync-in-loop")}
    (w,) = [f for f in fs if f.waived]
    assert w.reason == "test fixture reason"


def test_waiver_on_preceding_comment_line():
    fs = run("""\
    import torch


    def host(rows):
        for r in rows:
            # jitlint: waive(sync-in-loop) -- standalone pragma form
            x = r.item()
        return x
    """)
    assert hits(fs) == set()
    assert hits(fs, waived=True) == {(7, "sync-in-loop")}


def test_waiver_without_reason_is_malformed_and_inert():
    fs = run("""\
    import torch


    def host(rows):
        for r in rows:
            x = r.item()  # jitlint: waive(sync-in-loop)
        return x
    """)
    assert (6, "sync-in-loop") in hits(fs)  # NOT suppressed
    assert (6, "waiver-malformed") in hits(fs)


def test_unused_waiver_is_a_finding():
    fs = run("""\
    import torch


    def clean():
        return 1  # jitlint: waive(sync-in-loop) -- stale pragma
    """)
    assert hits(fs) == {(5, "waiver-unused")}


def test_unknown_rule_waiver_is_malformed():
    # The JAX pass's donated-use is no rule of the port's.
    fs = run("""\
    import torch


    def clean():
        return 1  # jitlint: waive(donated-use) -- whatever
    """)
    assert (5, "waiver-malformed") in hits(fs)


# -----------------------------------------------------------------------------
# Reachability
# -----------------------------------------------------------------------------


def test_reachability_propagates_through_helpers_and_methods():
    fs = run("""\
    import torch


    class Owner:
        def _round(self, x):
            return helper(x)

        def replay(self):
            self._graphs.run("round", lambda: self._round(self.x))


    def helper(v):
        if v > 0:
            return v
        return -v


    def host_only(v):
        if v > 0:
            return float(v)
        return v
    """)
    # helper is graph-reachable through the lambda body -> flagged;
    # host_only is not.
    assert hits(fs) == {(13, "tensor-branch")}


def test_reachability_crosses_modules_via_imports():
    kernels = textwrap.dedent("""\
    def kern(v):
        if v > 0:
            return v
        return -v
    """)
    main_src = textwrap.dedent("""\
    from kernels import kern


    def body(x):
        return kern(x)


    def drive(graphs):
        graphs.run("k", body)
    """)
    assert hits(run(main_src, extra_modules={"kernels": kernels})) == set()
    main = _collect_module("main.py", main_src)
    kmod = _collect_module("kernels.py", kernels)
    all_f = lint_modules({m.path: m for m in (main, kmod)})
    assert {(f.path, f.line, f.rule) for f in all_f} == {
        ("kernels.py", 2, "tensor-branch")}


def test_cuda_graph_block_calls_are_roots():
    fs = run("""\
    import torch


    def capture(g, x):
        with torch.cuda.graph(g):
            per_row(x)


    def per_row(r):
        return r.item()
    """)
    assert hits(fs) == {(10, "host-sync-in-graph")}


def test_named_roots_of_the_round():
    # In a module named step, the phase functions and the step closure
    # are roots with no graph call in sight.
    fs = run("""\
    def _tick(cfg, ids, st, do_tick, do_campaign):
        return st.term.item()


    def make_step_round(cfg):
        def step(st: BatchedState, inbox):
            bad = st.role
            return widen_state(st), bad
        return step
    """, path="step.py")
    assert hits(fs) == {(2, "host-sync-in-graph"), (7, "narrow-lane-arith")}


def test_seeded_item_in_a_copy_of_tick_is_found():
    """The port's step.py lints clean; the same source with one
    `.item()` seeded into `_tick` gives exactly that finding."""
    path = os.path.join(PORT, "batched", "step.py")
    with open(path) as f:
        src = f.read()
    assert [f for f in lint_source(src, "step.py") if not f.waived] == []
    tree = ast.parse(src)
    (tick,) = [n for n in tree.body
               if isinstance(n, ast.FunctionDef) and n.name == "_tick"]
    lines = src.splitlines()
    at = tick.body[1].lineno  # after the docstring's first statement
    indent = " " * tick.body[1].col_offset
    lines.insert(at - 1, f"{indent}_seeded = st.term.max().item()")
    fs = lint_source("\n".join(lines) + "\n", "step.py")
    assert {(f.line, f.rule) for f in fs if not f.waived} == {
        (at, "host-sync-in-graph")}


def test_static_annotated_params_are_not_tensors():
    fs = run("""\
    def body(x, pre: bool, n: int, cfg, dev: "torch.device"):
        if pre:
            x = x + n
        if cfg.flag and dev.type == "cuda":
            x = x - 1
        return x


    def drive(graphs):
        graphs.run("k", body)
    """)
    assert hits(fs) == set()


# -----------------------------------------------------------------------------
# The repository gates
# -----------------------------------------------------------------------------


def test_repo_batched_hot_path_is_clean():
    findings = lint_paths([os.path.join(PORT, "batched")])
    unwaived = [f.format() for f in findings if not f.waived]
    assert unwaived == [], (
        "jitlint findings in etcd_tpu_torch/batched/ — fix or waive with a "
        "reasoned pragma:\n" + "\n".join(unwaived))
    assert {f.rule for f in findings if f.waived} <= set(RULES)
    for f in findings:
        if f.waived:
            assert f.reason.strip()


def test_repo_analysis_and_tools_scope_is_clean():
    # With the engine in the set: the tools' syncs go through its
    # methods (eng.commits()).
    findings = lint_paths([os.path.join(PORT, "analysis"),
                           os.path.join(PORT, "tools"),
                           os.path.join(PORT, "batched")])
    unwaived = [f.format() for f in findings if not f.waived]
    assert unwaived == [], "\n".join(unwaived)
    # The measurement fences the tools keep are waived with reasons.
    assert {os.path.basename(f.path) for f in findings if f.waived} >= {
        "benchlib.py", "kernel_times.py"}


def test_the_gates_see_the_graphed_round():
    """The gate is not vacuous: the round's phases, the engine's and the
    rawnode's graph bodies and the plane's dispatch are graph code."""
    mods = {}
    for path in collect_files([os.path.join(PORT, "batched")]):
        with open(path) as f:
            rec = _collect_module(path, f.read())
        mods[rec.path] = rec
    lint_modules(mods)
    reach = {(m.name, fr.qualname) for m in mods.values()
             for fr in m.all_funcs if fr.reachable}
    for want in [("step", "_tick"), ("step", "_deliver_vectorized"),
                 ("step", "make_step_round.<locals>.step"),
                 ("step", "pack_outbox"), ("engine", "MultiRaftEngine._round"),
                 ("graph", "write_back"),
                 ("rawnode", "BatchedRawNode._device_round"),
                 ("applyplane", "dispatch"), ("kernels", "term_at")]:
        assert want in reach, want
    # The cached constant tables are host code.
    assert ("step", "_lane_table") not in reach


def test_bad_path_fails_the_gate_loudly():
    with pytest.raises(FileNotFoundError):
        collect_files([os.path.join(PORT, "no_such_dir")])
    with pytest.raises(FileNotFoundError):
        lint_paths(["no/such/file.py"])


def test_rule_catalog_documented():
    fs = run("""\
    def body(x):
        return float(x)


    def drive(graphs):
        graphs.run("k", body)
    """)
    assert fs
    for f in fs:
        assert f.rule in RULES


# -----------------------------------------------------------------------------
# The CLI
# -----------------------------------------------------------------------------


def _cli(*args, cwd=REPO):
    return subprocess.run(
        [sys.executable, "-m", "etcd_tpu_torch.analysis.jitlint", *args],
        cwd=cwd, capture_output=True, text=True, timeout=120)


def test_cli_gate_and_exit_codes(tmp_path):
    ok = _cli("etcd_tpu_torch/batched/", "etcd_tpu_torch/tools/")
    assert ok.returncode == 0, ok.stdout + ok.stderr
    assert "0 finding(s)" in ok.stderr
    bad = tmp_path / "bad.py"
    bad.write_text("import torch\n\n\ndef f(rows):\n    for r in rows:\n"
                   "        r.item()\n")
    hit = _cli(str(bad))
    assert hit.returncode == 1
    assert "bad.py:6: sync-in-loop" in hit.stdout
    assert _cli(str(tmp_path / "missing.py")).returncode == 2
    listed = _cli("--list-rules")
    assert listed.returncode == 0
    assert set(line.split()[0] for line in listed.stdout.splitlines()) == \
        set(RULES)


# -----------------------------------------------------------------------------
# The copy pinned to the JAX pass, with the differences listed
# -----------------------------------------------------------------------------

# Copied unchanged from etcd_tpu/analysis/jitlint.py.
SAME = ("Finding", "_Waiver", "_dotted", "_parse_waivers", "_sorted_wrapped",
        "_apply_waivers", "lint_source", "lint_file", "collect_files",
        "lint_paths")
# Each port rule and the JAX rule it stands for (h2d-in-graph stands for
# ROADMAP C4 and has no JAX rule).
RULE_MAP = {"tensor-branch": "tracer-branch",
            "host-sync-in-graph": "host-sync-in-jit",
            "h2d-in-graph": None,
            "narrow-lane-arith": "narrow-lane-arith",
            "impure-graph": "impure-jit",
            "dict-order-static": "dict-order-static",
            "sync-in-loop": "sync-in-loop",
            "waiver-malformed": "waiver-malformed",
            "waiver-unused": "waiver-unused",
            "syntax-error": "syntax-error"}


def _def(module, name):
    return ast.dump(ast.parse(textwrap.dedent(
        inspect.getsource(getattr(module, name)))))


@pytest.mark.parametrize("name", SAME)
def test_copied_helpers_equal_the_jax_pass(name):
    assert _def(jitlint, name) == _def(jax_lint, name)


def test_rules_map_onto_the_jax_rules():
    assert set(RULE_MAP) == set(RULES)
    mapped = {v for v in RULE_MAP.values() if v}
    # donated-use alone has no counterpart: the port donates nothing.
    assert set(jax_lint.RULES) - mapped == {"donated-use"}
    assert jitlint.NARROW_FIELDS == jax_lint.NARROW_FIELDS
    assert jitlint._WAIVE_RE.pattern == jax_lint._WAIVE_RE.pattern
