"""PyTorch port ↔ JAX reference: the server stack's copies, pinned.

Every module the port copied for the etcd server (the ``pkg`` helpers,
the sqlite backend, MVCC, the lessor, auth, the v2 store, ``server/``,
the v3 RPC service and wire, the client and its recipes, ``embed``'s
config, ``functional``'s cluster, stressers and checkers) is compared
with ``etcd_tpu``'s by its syntax tree, definition by definition
(docstrings dropped). Nothing may be missing or extra. The listed
differences are normalized away first, and each must still be there:

- ``pkg/rpctypes.py``: the error table names ``etcd_tpu_torch.`` modules,
  so that a client rebuilding a server error imports nothing of
  ``etcd_tpu``;
- ``pkg/schedule.py``: the logger is named after the port's package;
- ``server/server.py``: ``raft_backend`` defaults to ``"tpu"``,
  ``ServerConfig`` has a ``device`` field, ``EtcdServer.__init__``
  resolves it before any file is touched, and ``_boot_raft_tpu`` passes
  it to ``BatchedNode``;
- ``embed/__init__.py``: exports only ``config``'s names (``embed/etcd``
  is not ported yet).
"""

import ast
import os

import pytest

from .test_torch_hosting import _dump, _Normalize, defs_of

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COPIES = """
pkg/wait.py pkg/schedule.py pkg/idutil.py pkg/contention.py pkg/adt.py
pkg/sorteddict.py pkg/rpctypes.py pkg/tlsutil.py
storage/backend.py storage/metrics.py storage/__init__.py
storage/mvcc/__init__.py storage/mvcc/revision.py storage/mvcc/kv.py
storage/mvcc/key_index.py storage/mvcc/index.py storage/mvcc/metrics.py
storage/mvcc/kvstore.py storage/mvcc/watchable.py
lease/__init__.py lease/lease_queue.py lease/lessor.py
auth/__init__.py auth/range_perm_cache.py auth/store.py
auth/simple_token.py auth/hmac_token.py auth/jwt_token.py
v2store/__init__.py v2store/store.py
server/__init__.py server/api.py server/cindex.py server/alarms.py
server/membership.py server/metrics.py server/apply.py
server/compactor.py server/corrupt.py server/v3client.py
server/v3election.py server/v3lock.py server/server.py
v3rpc/__init__.py v3rpc/wire.py v3rpc/connbase.py v3rpc/service.py
client/__init__.py client/util.py client/client.py client/concurrency.py
embed/__init__.py embed/config.py
functional/__init__.py functional/cluster.py functional/stresser.py
functional/checker.py
""".split()


class _Strings(_Normalize):
    """Also maps string constants through `strings` (old -> new, on
    their prefix) and drops the listed constants from list literals."""

    def __init__(self, strings=(), drop_items=(), **kw):
        super().__init__(**kw)
        self.strings, self.drop_items = strings, set(drop_items)

    def visit_Constant(self, node):
        if isinstance(node.value, str):
            for old, new in self.strings:
                if node.value.startswith(old):
                    node.value = new + node.value[len(old):]
        return node

    def visit_List(self, node):
        self.generic_visit(node)
        node.elts = [e for e in node.elts if not (
            isinstance(e, ast.Constant) and e.value in self.drop_items)]
        return node


_SAME = _Normalize()
_PORT_NAMES = _Strings(strings=(("etcd_tpu_torch.", "etcd_tpu."),))
_DEVICE = _Normalize(args=("device",))
_RESOLVE = _Normalize(stmt=lambda s: (
    isinstance(s, ast.If) and "resolve_device" in ast.unparse(s)))
_STATE_IMPORT = _Normalize(stmt=lambda s: (
    isinstance(s, ast.ImportFrom) and s.module == "batched.state"))
_CONFIG = _Strings(strings=(("tpu", "host"),), stmt=lambda s: (
    isinstance(s, ast.AnnAssign) and ast.unparse(s.target) == "device"))
_EMBED = _Strings(drop_items=("Etcd", "start_etcd"), stmt=lambda s: (
    isinstance(s, ast.ImportFrom) and s.module == "etcd"))

# {module: {definition: (reference normalizer, port normalizer)}}
DIFFERENCES = {
    "pkg/rpctypes.py": {"<module>": (_SAME, _PORT_NAMES)},
    "pkg/schedule.py": {"FIFOScheduler._run": (_SAME, _PORT_NAMES)},
    "server/server.py": {
        "<module>": (_SAME, _STATE_IMPORT),
        "<ServerConfig>": (_SAME, _CONFIG),
        "EtcdServer.__init__": (_SAME, _RESOLVE),
        "EtcdServer._boot_raft_tpu": (_SAME, _DEVICE),
    },
    "embed/__init__.py": {"<module>": (_EMBED, _SAME)},
}


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_the_reference_code(rel):
    """The port's module equals etcd_tpu's definition by definition; the
    listed definitions differ, and equal it once the listed differences
    are normalized away; nothing is missing or extra."""
    ref = defs_of(os.path.join(ROOT, "etcd_tpu", rel))
    port = defs_of(os.path.join(ROOT, "etcd_tpu_torch", rel))
    assert set(port) == set(ref), set(port) ^ set(ref)
    allowed = DIFFERENCES.get(rel, {})
    assert set(allowed) <= set(port), set(allowed) - set(port)
    for name in sorted(port):
        a, b = ref[name], port[name]
        if name in allowed:
            assert _dump(a) != _dump(b), f"{rel}: {name} no longer differs"
            na, nb = allowed[name]
            a, b = na.apply(a), nb.apply(b)
        assert _dump(a) == _dump(b), f"{rel}: {name}"


def test_every_module_names_its_reference():
    """Each copy's docstring names the module it ports."""
    for rel in COPIES:
        with open(os.path.join(ROOT, "etcd_tpu_torch", rel)) as f:
            doc = ast.get_docstring(ast.parse(f.read())) or ""
        assert f"etcd_tpu/{rel}" in doc, rel


def test_the_copies_are_the_servers_import_closure():
    """Every etcd_tpu module that the server, the RPC service, the
    functional cluster and embed's config import (at module level or
    lazily), other than the ones earlier slices ported and embed/etcd.py,
    is one of the copies: the slice is the whole closure."""
    earlier = set()
    for dirpath, _dirs, files in os.walk(os.path.join(ROOT, "etcd_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                earlier.add(os.path.relpath(os.path.join(dirpath, f), os.path.join(
                    ROOT, "etcd_tpu_torch")))
    earlier -= set(COPIES)
    seen, stack = set(), ["server/__init__.py", "v3rpc/__init__.py",
                          "functional/__init__.py", "embed/config.py"]
    while stack:
        rel = stack.pop()
        if rel in seen:
            continue
        seen.add(rel)
        if rel in earlier or rel == "embed/etcd.py":
            continue  # ported before, with its own closure; or not yet
        path = os.path.join(ROOT, "etcd_tpu", rel)
        with open(path) as f:
            tree = ast.parse(f.read())
        pkg = os.path.dirname(rel).split("/") if rel else []
        for node in ast.walk(tree):
            if not (isinstance(node, ast.ImportFrom) and node.level):
                continue
            base = pkg[:len(pkg) - (node.level - 1)]
            mod = base + (node.module.split(".") if node.module else [])
            cands = ["/".join(mod) + ".py", "/".join(mod + ["__init__.py"])]
            cands += ["/".join(mod + [a.name]) + ".py" for a in node.names]
            for c in cands:
                if os.path.exists(os.path.join(ROOT, "etcd_tpu", c)):
                    stack.append(c)
    missing = sorted(seen - set(COPIES) - earlier - {"embed/etcd.py"})
    assert missing == [], missing
    assert len(seen & set(COPIES)) > 40, sorted(seen)
