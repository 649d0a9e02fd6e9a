"""PyTorch port ↔ JAX reference: the interaction harness and lockorder,
pinned.

The port's ``rafttest`` (the datadriven parser, ``InteractionEnv``,
``BatchedInteractionEnv`` and the package's names) and
``analysis/lockorder.py`` are compared with ``etcd_tpu``'s by their
syntax trees, definition by definition (docstrings dropped). Nothing may
be missing or extra but the listed definitions. The listed differences
are normalized away first, and each must still be there:

- ``rafttest/batched_env.py``: ``BatchedInteractionEnv.__init__`` takes
  a ``device`` and resolves it (``batched/state.resolve_device``, which
  the module imports), ``_add_nodes`` passes it to each ``BatchedNode``,
  and ``close`` (a definition the reference does not have) stops every
  node and drops them.
"""

import ast
import os

import pytest

from .test_torch_hosting import _dump, _Normalize, defs_of

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SAME = _Normalize()
_RESOLVE_IMPORT = _Normalize(stmt=lambda s: (
    isinstance(s, ast.ImportFrom) and s.module == "batched.state"))
_DEVICE = _Normalize(args=("device",), stmt=lambda s: (
    isinstance(s, ast.Assign) and "resolve_device" in ast.unparse(s)))

# {module: ({definition: (reference normalizer, port normalizer)},
# definitions the port adds)}
PINS = {
    "rafttest/datadriven.py": ({}, ()),
    "rafttest/interaction.py": ({}, ()),
    "rafttest/__init__.py": ({}, ()),
    "rafttest/batched_env.py": ({
        "<module>": (_SAME, _RESOLVE_IMPORT),
        "BatchedInteractionEnv.__init__": (_SAME, _DEVICE),
        "BatchedInteractionEnv._add_nodes": (_SAME, _DEVICE),
    }, ("BatchedInteractionEnv.close",)),
    "analysis/lockorder.py": ({}, ()),
}


@pytest.mark.parametrize("rel", sorted(PINS))
def test_copy_is_the_reference_code(rel):
    """The port's module equals etcd_tpu's definition by definition; the
    listed definitions differ, and equal it once the listed differences
    are normalized away; nothing is missing or extra."""
    allowed, added = PINS[rel]
    ref = defs_of(os.path.join(ROOT, "etcd_tpu", rel))
    port = defs_of(os.path.join(ROOT, "etcd_tpu_torch", rel))
    assert set(port) - set(added) == set(ref), (
        (set(port) - set(added)) ^ set(ref))
    assert set(added) <= set(port), set(added) - set(port)
    for name in sorted(port):
        if name in added:
            continue
        a, b = ref[name], port[name]
        if name in allowed:
            assert _dump(a) != _dump(b), f"{rel}: {name} no longer differs"
            na, nb = allowed[name]
            a, b = na.apply(a), nb.apply(b)
        assert _dump(a) == _dump(b), f"{rel}: {name}"


@pytest.mark.parametrize("rel", sorted(PINS))
def test_every_module_names_its_reference(rel):
    """Each copy's docstring names the module it ports."""
    with open(os.path.join(ROOT, "etcd_tpu_torch", rel)) as f:
        doc = ast.get_docstring(ast.parse(f.read())) or ""
    assert f"etcd_tpu/{rel}" in doc, rel


def test_analysis_exports_only_what_is_ported():
    """The port's analysis package exports the lock-order recorder and
    its violation, the lint's and the sentinels' public names (those of
    etcd_tpu/analysis/__init__.py) and its three modules, and names
    each plane in its docstring."""
    import etcd_tpu_torch.analysis as analysis

    assert analysis.LockOrderRecorder.__module__ == (
        "etcd_tpu_torch.analysis.lockorder")
    assert {n for n in vars(analysis) if not n.startswith("_")} == {
        "LockOrderRecorder", "LockOrderViolation", "lockorder",
        "Finding", "RULES", "lint_file", "lint_paths", "lint_source",
        "jitlint", "CompileBudget", "RecompileBudgetExceeded",
        "distinct_shapes", "note_compile_key", "reset_compile_tracking",
        "round_guard", "transfer_guard_mode", "sentinels"}
    for plane in ("jitlint", "sentinels", "lockorder"):
        assert plane in analysis.__doc__, plane
