"""PyTorch port ↔ JAX reference: the server stack's copies, pinned.

Every module the port copied for the etcd server (the ``pkg`` helpers,
the sqlite backend, MVCC, the lessor, auth, the v2 store, ``server/``,
the v3 RPC service and wire, the client and its recipes, ``embed``,
``functional``'s cluster, stressers and checkers) and for booting and
fronting it (the peer transport, etcdmain and ``__main__``, the HTTP,
gateway and v2 listeners, discovery, ``etcdutl``, the version, the
benchmark tool and its report), and for the outer client surfaces
(etcdctl, the grpc, http and tcp proxies, the client recipes, ``pb/``
and the ``pkg`` leaves traceutil, notify, mock and proxy) is compared with ``etcd_tpu``'s by its
syntax tree, definition by definition (docstrings dropped). Nothing may
be missing or extra but the listed definitions. The listed differences
are normalized away first, and each must still be there:

- ``pkg/rpctypes.py``: the error table names ``etcd_tpu_torch.`` modules,
  so that a client rebuilding a server error imports nothing of
  ``etcd_tpu``;
- ``pkg/schedule.py``: the logger is named after the port's package;
- ``server/server.py``: ``raft_backend`` defaults to ``"tpu"``,
  ``ServerConfig`` has a ``device`` field, ``EtcdServer.__init__``
  resolves it before any file is touched (importing the device helper
  there, so that the client side loads no torch), and ``_boot_raft_tpu`` passes
  it to ``BatchedNode``; a fresh ``"tpu"`` member writes the bootstrap
  conf changes the scalar core writes (``EtcdServer._bootstrap_log``, a
  definition the reference does not have), so either backend boots its
  data dir;
- ``embed/config.py``: ``Config`` has two more fields, ``raft_backend``
  (default ``"tpu"``) and ``device`` (default ``None``, the GPU);
- ``embed/etcd.py``: ``start_etcd`` resolves the device (for ``"tpu"``)
  before it reads the data dir (importing the helper there), and passes ``raft_backend``, the
  device and one spare replica slot (``replica_capacity``, the peers and
  one) to ``ServerConfig``;
- ``etcdmain/__init__.py``: the ``--raft-backend`` and ``--device``
  flags; an orderly stop, and SIGHUP, print ``launches_line`` (a
  definition the reference does not have); the names it prints are the port's;
- ``pkg/traceutil.py``: the logger is named after the port's package;
- ``etcdctl/__init__.py``: the deprecation note of ``snapshot
  restore|status`` names the port's etcdutl;
- ``proxy/tcpproxy.py``: a backend dial's timeout is taken off the
  connection once it is made (ROADMAP C22).
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
embed/__init__.py embed/config.py embed/etcd.py
functional/__init__.py functional/cluster.py functional/stresser.py
functional/checker.py
version.py transport/__init__.py transport/metrics.py transport/tcp.py
client/srv.py discovery.py etcdutl/__init__.py etcdutl/__main__.py
etcdhttp.py gatewayjson.py v2http.py etcdmain/__init__.py __main__.py
pkg/report.py tools/benchmark.py
pkg/traceutil.py pkg/notify.py pkg/mock.py pkg/proxy.py
client/snapshot.py client/v2.py client/namespace.py client/naming.py
client/ordering.py client/mirror.py client/leasing.py
proxy/__init__.py proxy/tcpproxy.py proxy/httpproxy.py proxy/grpcproxy.py
etcdctl/__init__.py etcdctl/__main__.py
pb/raft_pb2.py pb/kv_pb2.py pb/convert.py pb/kv_convert.py pb/__init__.py
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
_BOOTSTRAP = _Normalize(args=("device",), stmt=lambda s: (
    isinstance(s, ast.If) and "_bootstrap_log" in ast.unparse(s)))
_RESOLVE = _Normalize(stmt=lambda s: (
    isinstance(s, ast.If) and "resolve_device" in ast.unparse(s)))
_CONFIG = _Strings(strings=(("tpu", "host"),), stmt=lambda s: (
    isinstance(s, ast.AnnAssign) and ast.unparse(s.target) == "device"))
_EMBED_CONFIG = _Normalize(stmt=lambda s: (
    isinstance(s, ast.AnnAssign)
    and ast.unparse(s.target) in ("raft_backend", "device")))
_START_ETCD = _Normalize(args=("raft_backend", "device", "replica_capacity"),
                         stmt=lambda s: (
    isinstance(s, ast.Assign) and ast.unparse(s.targets[0]) == "device"
    or isinstance(s, ast.If) and "raft_backend" in ast.unparse(s.test)))
_BACKEND_FLAGS = _Normalize(stmt=lambda s: (
    isinstance(s, ast.Expr) and ("--raft-backend" in ast.unparse(s)
                                 or "--device" in ast.unparse(s))))
_LAUNCH_LINE = _Strings(
    strings=(("etcd_tpu_torch", "etcd_tpu"),), stmt=lambda s: (
        isinstance(s, ast.Expr) and "launches_line" in ast.unparse(s)))
_PORT_PRINTS = _Strings(strings=(("etcd_tpu_torch", "etcd_tpu"),))
_DIAL_TIMEOUT_ONLY = _Normalize(stmt=lambda s: (
    isinstance(s, ast.Expr) and ast.unparse(s) == "out.settimeout(None)"))
_DEPRECATED = ("etcdctl snapshot restore/status are deprecated; use `python "
               "-m ")
_UTL_NAME = _Strings(strings=((_DEPRECATED + "etcd_tpu_torch.",
                               _DEPRECATED + "etcd_tpu."),))

# {module: {definition: (reference normalizer, port normalizer)}}
DIFFERENCES = {
    "pkg/rpctypes.py": {"<module>": (_SAME, _PORT_NAMES)},
    "pkg/schedule.py": {"FIFOScheduler._run": (_SAME, _PORT_NAMES)},
    "server/server.py": {
        "<ServerConfig>": (_SAME, _CONFIG),
        "EtcdServer.__init__": (_SAME, _RESOLVE),
        "EtcdServer._boot_raft_tpu": (_SAME, _BOOTSTRAP),
    },
    "embed/config.py": {"<Config>": (_SAME, _EMBED_CONFIG)},
    "embed/etcd.py": {"start_etcd": (_SAME, _START_ETCD)},
    "etcdmain/__init__.py": {
        "_add_member_flags": (_SAME, _BACKEND_FLAGS),
        "_run_etcd": (_SAME, _LAUNCH_LINE),
        "main": (_SAME, _PORT_PRINTS),
    },
    "pkg/traceutil.py": {"Trace.__init__": (_SAME, _PORT_NAMES)},
    "etcdctl/__init__.py": {"cmd_snapshot": (_SAME, _UTL_NAME)},
    "proxy/tcpproxy.py": {"TCPProxy._serve": (_SAME, _DIAL_TIMEOUT_ONLY)},
}

# Definitions a copy has and its reference does not.
ADDED = {"etcdmain/__init__.py": {"launches_line"},
         "server/server.py": {"EtcdServer._bootstrap_log"}}


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_the_reference_code(rel):
    """The port's module equals etcd_tpu's definition by definition; the
    listed definitions differ, and equal it once the listed differences
    are normalized away; nothing is missing or extra."""
    ref = defs_of(os.path.join(ROOT, "etcd_tpu", rel))
    port = defs_of(os.path.join(ROOT, "etcd_tpu_torch", rel))
    added = ADDED.get(rel, set())
    assert set(port) - added == set(ref), (set(port) - added) ^ set(ref)
    assert added <= set(port), added - set(port)
    for name in added:
        del port[name]
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
    functional cluster, etcdmain (with embed, and the proxies it starts
    for ``gateway`` and ``grpc-proxy``), the benchmark tool, etcdctl, the
    client recipes, ``pb/`` and the ``pkg`` leaves import (at module level
    or lazily), other than the ones earlier slices ported, is one of the
    copies: the slices are the whole closure."""
    earlier = set()
    for dirpath, _dirs, files in os.walk(os.path.join(ROOT, "etcd_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                earlier.add(os.path.relpath(os.path.join(dirpath, f), os.path.join(
                    ROOT, "etcd_tpu_torch")))
    earlier -= set(COPIES)
    seen, stack = set(), ["server/__init__.py", "v3rpc/__init__.py",
                          "functional/__init__.py", "embed/config.py",
                          "etcdmain/__init__.py", "__main__.py",
                          "tools/benchmark.py", "etcdctl/__init__.py",
                          "etcdctl/__main__.py", "pb/__init__.py",
                          "client/snapshot.py", "client/v2.py",
                          "client/namespace.py", "client/naming.py",
                          "client/ordering.py", "client/leasing.py",
                          "proxy/httpproxy.py", "pkg/traceutil.py",
                          "pkg/notify.py", "pkg/mock.py", "pkg/proxy.py"]
    while stack:
        rel = stack.pop()
        if rel in seen:
            continue
        seen.add(rel)
        if rel in earlier:
            continue  # ported before, with its own closure
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
    missing = sorted(seen - set(COPIES) - earlier)
    assert missing == [], missing
    assert len(seen & set(COPIES)) > 60, sorted(seen)
