"""jitlint: AST lint passes over the port's graphed round (pure stdlib).

Ports ``etcd_tpu/analysis/jitlint.py`` to PyTorch. The JAX package
lints jit-reachable code for what forces a tracer to the host; the
port's counterpart of jit code is the code a CUDA graph captures, where
a host sync is refused by the capture on the card and hidden on the CPU
(the round runs eagerly there, so a stray ``.item()`` passes every CPU
test and only the card's capture fails).

Graph-reachability
------------------
A function is a *graph root* when it is

* passed as the body to a ``RoundGraphs.run(key, body)`` call (a
  ``.run`` on a receiver whose name ends in ``graphs``): a function, a
  method (``self._device_round``) or a lambda;
* called inside a ``with torch.cuda.graph(...)`` block;
* one of the round's named roots (``GRAPH_ROOTS``): the ``step``
  closure that ``make_step_round`` returns, ``route`` and the phase
  functions ``_deliver_all``, ``_tick``, ``_control``, ``_propose``
  and ``_emit`` in ``step.py``, and the apply plane's ``dispatch``.

Reachability then propagates through calls by plain name or by
attribute leaf (``self._round``) within a module, and across files via
``from .mod import name`` within the analysed set, as in the JAX pass.
A function decorated with ``functools.lru_cache`` / ``cache`` is host
code: its body runs once per key, on the first (eager) round, and a
capture only reads the cached result. That is the sanctioned form of a
per-device constant (``step._lane_table``).

Device values (syntactic, conservative)
---------------------------------------
Inside graph code parameters are tensors unless annotated with a
static type (``bool``/``int``/``float``/``str``/``bytes``/``device``/
``dtype``/``Size``/``*Config``) or named ``self``/``cls``/``cfg``/
``config``; results of ``torch.*`` calls (except the host-side
``torch.cuda``, ``torch.profiler``, ``torch.device``, ...) are device
values; devness propagates through arithmetic, comparisons (not
``is``/``is not``), subscripts, attribute access (except the static
``.shape``/``.dtype``/``.ndim``/``.device``/``.is_cuda``), tensor
methods (except the static ``.dim()``/``.numel()``/``.size()``/
``.data_ptr()``/...) and assignment. Iteration is flagged only over a
certain tensor (a ``torch.*`` result or a name bound to one), because a
tuple of tensors (a state, an outbox) is iterated legally everywhere.

Rules, each beside the JAX rule it stands for
---------------------------------------------
- ``tensor-branch``      (``tracer-branch``) Python if/while/assert/
                         ternary/and/or on a device value, or iteration
                         over a tensor, in graph code: an implicit
                         ``bool()``, a sync the capture refuses.
- ``host-sync-in-graph`` (``host-sync-in-jit``) ``.item()``/
                         ``.tolist()``/``.cpu()``/``.numpy()``,
                         ``bool()``/``int()``/``float()`` or ``np.*`` of
                         a device value, ``torch.cuda.synchronize`` and
                         the data-dependent shapes ``nonzero``/
                         ``masked_select``/``unique`` in graph code.
- ``h2d-in-graph``       (C4) ``torch.tensor``/``torch.as_tensor``/
                         ``torch.from_numpy``/``np.*`` of host data in
                         graph code: a host-to-device copy every round.
- ``narrow-lane-arith``  arithmetic on a value narrowed to int8/int16,
                         or a narrow state field read in an entry root
                         (a graph body, the ``step`` closure) before its
                         ``widen_state`` call.
- ``impure-graph``       (``impure-jit``) ``time.*``/``random.*``/
                         ``np.random.*``/``datetime.*``/``uuid.*``/
                         ``secrets.*``/``os.urandom`` in graph code: a
                         replay repeats the value the capture saw.
- ``dict-order-static``  a set or unsorted dict view feeding a
                         ``RoundGraphs.run`` key or a call of an
                         ``lru_cache``d builder (hash order differs per
                         process: new captures, new builds).
- ``sync-in-loop``       ``.item()``/``.cpu()``/``.to("cpu")``/
                         ``torch.cuda.synchronize``/``.synchronize()``,
                         or a call of a function of the analysed set
                         that makes one (by unique name), inside a
                         for/while loop of HOST code in a
                         torch-importing module (the loop's body and a
                         while test; a for's iterable runs once).

The JAX rule ``donated-use`` has no counterpart: the port donates no
buffer (its owners keep one buffer per field and write into it).

Waivers
-------
As in the JAX pass: a comment reading ``jitlint: waive(<rule>) --
<reason>`` on the offending line or the line directly above. The reason
is mandatory (``waiver-malformed``); a pragma that suppresses nothing
is itself a finding (``waiver-unused``).

CLI: ``python -m etcd_tpu_torch.analysis.jitlint etcd_tpu_torch/batched/``.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import re
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

RULES: Dict[str, str] = {
    "tensor-branch": (
        "Python control flow on a device value inside graph-reachable "
        "code (an implicit bool(): a host sync the capture refuses)"),
    "host-sync-in-graph": (
        "host conversion (.item()/.tolist()/.cpu()/.numpy()/bool()/int()/"
        "float()/np.*) of a device value, torch.cuda.synchronize or a "
        "data-dependent shape (nonzero/masked_select/unique) inside "
        "graph-reachable code"),
    "h2d-in-graph": (
        "torch.tensor/torch.as_tensor/torch.from_numpy/np.* of host data "
        "inside graph-reachable code (a host-to-device copy every round; "
        "make constant tables once per device, as step._lane_table does)"),
    "narrow-lane-arith": (
        "arithmetic on an int8/int16-narrowed value (narrow lanes are "
        "storage-only: widen to i32 at kernel entry before any math, "
        "else the win silently becomes wrap-around bugs)"),
    "impure-graph": (
        "impure call (time/random/datetime/uuid/secrets/os.urandom) "
        "inside graph-reachable code (a replay repeats the value the "
        "capture saw)"),
    "dict-order-static": (
        "dict/set iteration order feeding a RoundGraphs.run key or an "
        "lru_cache'd builder (hash-order differences capture and build "
        "anew per process)"),
    "sync-in-loop": (
        "device sync (.item()/.cpu()/.to('cpu')/torch.cuda.synchronize/"
        ".synchronize() or a function that makes one) inside a host loop "
        "— sync once in bulk per round, not per item"),
    "waiver-malformed": (
        "jitlint waive pragma without a ' -- <reason>' justification"),
    "waiver-unused": (
        "jitlint waive pragma that suppresses no finding (stale — "
        "remove it)"),
    "syntax-error": (
        "file failed to parse — nothing else can be checked"),
}

# The round's named roots, by module (file stem): the step closure that
# make_step_round returns is an entry root (narrow state arrives there);
# the others receive wide state.
GRAPH_ROOTS: Dict[str, Tuple[str, ...]] = {
    "step": ("make_step_round.<locals>.step", "route", "_deliver_all",
             "_tick", "_control", "_propose", "_emit"),
    "applyplane": ("dispatch",),
}
ENTRY_ROOTS = {"make_step_round.<locals>.step"}

_STATIC_PARAM_NAMES = {"self", "cls", "cfg", "config"}
_STATIC_ANNOTATIONS = {"bool", "int", "float", "str", "bytes", "device",
                       "dtype", "Size"}
_STATIC_ATTRS = {"shape", "dtype", "ndim", "device", "is_cuda", "layout",
                 "names", "itemsize"}
_STATIC_METHODS = {"dim", "numel", "size", "data_ptr", "element_size",
                   "is_contiguous", "stride", "get_device", "nelement",
                   "untyped_storage", "storage_offset", "is_floating_point"}
# torch.* calls that return host values, not tensors.
_HOST_TORCH = ("torch.cuda.", "torch.profiler.", "torch.backends.",
               "torch.utils.", "torch._C.")
_HOST_TORCH_EXACT = {"torch.device", "torch.Size", "torch.iinfo",
                     "torch.finfo", "torch.is_tensor", "torch.Generator",
                     "torch.get_default_dtype", "torch.promote_types"}
_NARROW_CASTS = {"int8", "int16", "I8", "I16", "i8", "i16"}
# Mirrors state.NARROW_DTYPES (kept literal: jitlint imports nothing
# from the package it lints).
NARROW_FIELDS = {
    "role", "vote", "lead", "transferee", "votes", "pr_state", "inflight",
}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_DYNAMIC_SHAPE = {"nonzero", "masked_select", "unique"}
_H2D_CALLS = {"torch.tensor", "torch.as_tensor", "torch.from_numpy"}
# In host loops: numpy cannot convert a CUDA tensor (np.asarray raises
# on one), so the syncs are the tensor's own conversions.
_LOOP_SYNC_METHODS = {"item", "cpu", "synchronize"}
_LOOP_SYNC_CALLS = {"torch.cuda.synchronize"}
# Annotation names of host values, and of containers of them.
_CONTAINERS = {"Set", "FrozenSet", "Dict", "List", "Tuple", "Sequence",
               "Iterable", "Optional", "set", "frozenset", "dict", "list",
               "tuple", "None"}
_ITER_HELPERS = {"zip", "enumerate", "reversed", "sorted", "list", "tuple",
                 "map", "filter", "range", "iter"}
_IMPURE_PREFIXES = (
    "time.", "random.", "np.random.", "numpy.random.", "datetime.",
    "uuid.", "secrets.",
)
_IMPURE_EXACT = {"os.urandom", "time", "input"}
_CACHE_DECORATORS = {"lru_cache", "cache"}

_WAIVE_RE = re.compile(
    r"#\s*jitlint:\s*waive\(([^)]*)\)(?:\s*--\s*(\S.*))?")


@dataclass
class Finding:
    path: str
    line: int
    rule: str
    message: str
    waived: bool = False
    reason: str = ""

    def format(self) -> str:
        tag = f" [waived: {self.reason}]" if self.waived else ""
        return f"{self.path}:{self.line}: {self.rule}: {self.message}{tag}"


@dataclass
class _Waiver:
    line: int  # line the pragma suppresses findings on
    rules: Set[str]
    reason: str
    pragma_line: int
    used: bool = False


@dataclass(eq=False)
class _FuncRec:
    module: str
    qualname: str
    node: ast.AST  # FunctionDef | AsyncFunctionDef | Lambda
    root: bool = False
    entry: bool = False  # a root where narrow storage arrives
    cached: bool = False  # lru_cache'd: host code by construction
    reachable: bool = False
    calls: Set[str] = field(default_factory=set)  # local names called


@dataclass(eq=False)
class _ModRec:
    name: str
    path: str
    tree: ast.Module
    source_lines: List[str]
    imports_torch: bool = False
    # local name -> (module, name) for `from .mod import name`
    import_map: Dict[str, Tuple[str, str]] = field(default_factory=dict)
    funcs: Dict[str, _FuncRec] = field(default_factory=dict)  # by simple name
    all_funcs: List[_FuncRec] = field(default_factory=list)
    waivers: List[_Waiver] = field(default_factory=list)
    findings: List[Finding] = field(default_factory=list)


def _dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _parse_waivers(source: str, path: str,
                   findings: List[Finding]) -> List[_Waiver]:
    """Scan COMMENT tokens (only — string literals that merely mention
    the pragma syntax, like this module's own docs, never match)."""
    import io
    import tokenize

    waivers: List[_Waiver] = []
    lines = source.splitlines()
    comments: List[Tuple[int, str]] = []
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                comments.append((tok.start[0], tok.string))
    except (tokenize.TokenError, IndentationError):
        pass
    for i, text in comments:
        m = _WAIVE_RE.search(text)
        if not m:
            if "jitlint:" in text and "waive(" in text:
                findings.append(Finding(
                    path, i, "waiver-malformed",
                    "unparseable jitlint pragma (expected "
                    "'# jitlint: waive(<rule>) -- <reason>')"))
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        reason = (m.group(2) or "").strip()
        unknown = rules - set(RULES)
        if unknown or not rules:
            findings.append(Finding(
                path, i, "waiver-malformed",
                f"unknown rule(s) in waive pragma: {sorted(unknown)}"))
            rules &= set(RULES)
            if not rules:
                # Nothing left to waive — don't also append an empty
                # waiver that waiver-unused would re-report as noise.
                continue
        if not reason:
            findings.append(Finding(
                path, i, "waiver-malformed",
                "waive pragma missing ' -- <reason>' justification"))
            continue
        # A standalone comment line waives the next non-comment line;
        # a trailing pragma waives its own line.
        target = i
        full_line = lines[i - 1] if i <= len(lines) else ""
        if full_line.lstrip().startswith("#"):
            target = i + 1
            while target <= len(lines) and (
                    not lines[target - 1].strip()
                    or lines[target - 1].lstrip().startswith("#")):
                target += 1
        waivers.append(_Waiver(target, rules, reason, i))
    return waivers


# -----------------------------------------------------------------------------
# Module collection
# -----------------------------------------------------------------------------


def _is_graphs_run(call: ast.Call) -> bool:
    """A `<...>graphs.run(key, body, ...)` call (RoundGraphs.run)."""
    if not (isinstance(call.func, ast.Attribute)
            and call.func.attr == "run"):
        return False
    recv = call.func.value
    if isinstance(recv, ast.Call):
        recv = recv.func
    name = (_dotted(recv) or "").split(".")[-1].lower()
    return name.endswith("graphs")


def _run_body(call: ast.Call) -> Optional[ast.AST]:
    if len(call.args) > 1:
        return call.args[1]
    for kw in call.keywords:
        if kw.arg == "body":
            return kw.value
    return None


def _run_key(call: ast.Call) -> Optional[ast.AST]:
    if call.args:
        return call.args[0]
    for kw in call.keywords:
        if kw.arg == "key":
            return kw.value
    return None


def _calls_in(node: ast.AST) -> Set[str]:
    """Callee names (plain names and attribute leaves) under `node`."""
    out: Set[str] = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            dd = _dotted(sub.func)
            if dd:
                out.add(dd.split(".")[-1])
    return out


def _collect_module(path: str, source: str) -> _ModRec:
    tree = ast.parse(source, filename=path)
    name = os.path.splitext(os.path.basename(path))[0]
    rec = _ModRec(name, path, tree, source.splitlines())
    rec.waivers = _parse_waivers(source, path, rec.findings)

    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch" or a.name.startswith("torch."):
                    rec.imports_torch = True
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if mod == "torch" or mod.startswith("torch."):
                rec.imports_torch = True
            base = mod.rsplit(".", 1)[-1] if mod else ""
            for a in node.names:
                rec.import_map[a.asname or a.name] = (base, a.name)

    def collect_funcs(body, prefix: str):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{node.name}"
                fr = _FuncRec(rec.name, qual, node)
                rec.funcs.setdefault(node.name, fr)
                rec.all_funcs.append(fr)
                for d in node.decorator_list:
                    dd = _dotted(d.func if isinstance(d, ast.Call) else d)
                    if (dd or "").split(".")[-1] in _CACHE_DECORATORS:
                        fr.cached = True
                collect_funcs(node.body, f"{qual}.<locals>.")
            elif isinstance(node, (ast.ClassDef,)):
                collect_funcs(node.body, f"{prefix}{node.name}.")
            elif hasattr(node, "body") and isinstance(node.body, list):
                # Generic statement containers (if/try/with/for/while
                # and their else/finally/except blocks).
                collect_funcs(node.body, prefix)
                for attr in ("orelse", "finalbody", "handlers"):
                    for sub in getattr(node, attr, []) or []:
                        if hasattr(sub, "body"):
                            collect_funcs(sub.body, prefix)
                        else:
                            collect_funcs([sub], prefix)

    collect_funcs(tree.body, "")

    named = set(GRAPH_ROOTS.get(rec.name, ()))
    for fr in rec.all_funcs:
        if fr.qualname in named:
            fr.root = True
            fr.entry = fr.qualname in ENTRY_ROOTS

    def mark_root(target: ast.AST, entry: bool) -> None:
        if isinstance(target, ast.Lambda):
            fr = _FuncRec(rec.name, f"<lambda:{target.lineno}>", target,
                          root=True, entry=entry)
            rec.all_funcs.append(fr)
            return
        leaf = (_dotted(target) or "").split(".")[-1]
        if leaf in rec.funcs:
            rec.funcs[leaf].root = True
            rec.funcs[leaf].entry |= entry

    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _is_graphs_run(node):
            body = _run_body(node)
            if body is not None:
                mark_root(body, entry=True)
        elif isinstance(node, ast.With) and any(
                isinstance(it.context_expr, ast.Call)
                and (_dotted(it.context_expr.func) or "").endswith(
                    "cuda.graph") for it in node.items):
            for stmt in node.body:
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.Call):
                        mark_root(sub.func, entry=True)

    # Call edges (names and attribute leaves).
    for fr in rec.all_funcs:
        fr.calls = _calls_in(fr.node)
    return rec


def _propagate_reachability(mods: Dict[str, _ModRec]) -> None:
    # Import links resolve by module NAME; records are keyed by path
    # (stems can collide across directories — first record wins links).
    by_name: Dict[str, _ModRec] = {}
    owner: Dict[_FuncRec, _ModRec] = {}
    work: List[_FuncRec] = []
    for m in mods.values():
        by_name.setdefault(m.name, m)
        for fr in m.all_funcs:
            owner[fr] = m
            if fr.root and not fr.reachable:
                fr.reachable = True
                work.append(fr)
    while work:
        fr = work.pop()
        m = owner[fr]
        for callee in fr.calls:
            targets: List[_FuncRec] = []
            if callee in m.funcs:
                targets.append(m.funcs[callee])
            elif callee in m.import_map:
                im, iname = m.import_map[callee]
                if im in by_name and iname in by_name[im].funcs:
                    targets.append(by_name[im].funcs[iname])
            for t in targets:
                # An lru_cache'd builder runs once per key, eagerly: a
                # capture reads its result and never its body.
                if not t.reachable and not t.cached:
                    t.reachable = True
                    work.append(t)


def _resolve(m: _ModRec, call: ast.Call,
             by_name: Dict[str, _ModRec]) -> Optional[_FuncRec]:
    """The function of the analysed set that `call` names within its
    module: a plain name (or a name imported with ``from .mod import``)
    or a ``self.``/``cls.`` method."""
    f = call.func
    if isinstance(f, ast.Name):
        if f.id in m.funcs:
            return m.funcs[f.id]
        if f.id in m.import_map:
            im, iname = m.import_map[f.id]
            if im in by_name:
                return by_name[im].funcs.get(iname)
        return None
    if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
            and f.value.id in ("self", "cls")):
        return m.funcs.get(f.attr)
    return None


def _syncing(mods: Dict[str, _ModRec]) -> "Tuple[Set[_FuncRec], Set[str]]":
    """The functions of the analysed set that make a device sync,
    directly or through calls resolved within their module (_resolve),
    and the names of those defined once across the set: a method call
    by such a name on any object (``eng.commits()``) means that
    function."""
    by_name: Dict[str, _ModRec] = {}
    for m in mods.values():
        by_name.setdefault(m.name, m)
    edges: Dict[_FuncRec, Set[_FuncRec]] = {}
    syncing: Set[_FuncRec] = set()
    count: Dict[str, int] = {}
    for m in mods.values():
        for fr in m.all_funcs:
            if isinstance(fr.node, ast.Lambda):
                continue
            count[fr.node.name] = count.get(fr.node.name, 0) + 1
            edges[fr] = set()
            for sub in ast.walk(fr.node):
                if not isinstance(sub, ast.Call):
                    continue
                if _is_direct_sync(sub):
                    syncing.add(fr)
                t = _resolve(m, sub, by_name)
                if t is not None:
                    edges[fr].add(t)
    changed = True
    while changed:
        changed = False
        for fr, callees in edges.items():
            if fr not in syncing and callees & syncing:
                syncing.add(fr)
                changed = True
    unique = {fr.node.name for fr in syncing if count[fr.node.name] == 1}
    return syncing, unique


def _is_direct_sync(node: ast.Call) -> bool:
    dd = _dotted(node.func) or ""
    if dd in _LOOP_SYNC_CALLS:
        return True
    if not isinstance(node.func, ast.Attribute):
        return False
    attr = node.func.attr
    if attr in _LOOP_SYNC_METHODS:
        return True
    # x.to("cpu") / x.to(device="cpu")
    if attr == "to":
        vals = list(node.args) + [k.value for k in node.keywords
                                  if k.arg == "device"]
        return any(isinstance(v, ast.Constant) and v.value == "cpu"
                   for v in vals)
    return False


# -----------------------------------------------------------------------------
# Devness inference + per-function rule visitors
# -----------------------------------------------------------------------------


def _static_annotation(ann: ast.AST) -> bool:
    """A parameter annotation of a host value: a static type, a config,
    or a container whose every named type is one."""
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return False
    leaf = ast.unparse(ann).split(".")[-1].split("[")[0]
    if leaf in _STATIC_ANNOTATIONS or leaf.endswith("Config"):
        return True
    names = [(_dotted(n) or "").split(".")[-1] for n in ast.walk(ann)
             if isinstance(n, (ast.Name, ast.Attribute))]
    return leaf in _CONTAINERS and all(
        n in _STATIC_ANNOTATIONS or n in _CONTAINERS for n in names if n)


def _is_torch_call(dd: str) -> bool:
    return (dd.startswith("torch.") and not dd.startswith(_HOST_TORCH)
            and dd not in _HOST_TORCH_EXACT)


class _FuncLinter:
    def __init__(self, mod: _ModRec, fr: _FuncRec, graph: bool,
                 syncing: "Tuple[Set[_FuncRec], Set[str]]",
                 by_name: Dict[str, _ModRec]):
        self.mod = mod
        self.by_name = by_name
        self.fr = fr
        self.graph = graph  # graph-reachable scope
        self.syncing = syncing
        self.device: Set[str] = set()
        self.tensor: Set[str] = set()  # names certainly bound to a tensor
        self.narrow: Set[str] = set()
        self.findings = mod.findings
        if graph:
            self._seed_params()

    def _emit(self, node: ast.AST, rule: str, msg: str) -> None:
        self.findings.append(Finding(
            self.mod.path, getattr(node, "lineno", 0), rule, msg))

    def _seed_params(self) -> None:
        args = self.fr.node.args
        all_args = (args.posonlyargs + args.args + args.kwonlyargs
                    + ([args.vararg] if args.vararg else [])
                    + ([args.kwarg] if args.kwarg else []))
        for a in all_args:
            if a.arg in _STATIC_PARAM_NAMES:
                continue
            if a.annotation is not None and _static_annotation(
                    a.annotation):
                continue
            self.device.add(a.arg)

    # -- devness --------------------------------------------------------------

    def is_device(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.device
        if isinstance(node, ast.Attribute):
            if node.attr in _STATIC_ATTRS:
                return False
            return self.is_device(node.value)
        if isinstance(node, ast.Subscript):
            return self.is_device(node.value) or self.is_device(node.slice)
        if isinstance(node, (ast.BinOp,)):
            return self.is_device(node.left) or self.is_device(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_device(node.operand)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False
            return self.is_device(node.left) or any(
                self.is_device(c) for c in node.comparators)
        if isinstance(node, ast.BoolOp):
            return any(self.is_device(v) for v in node.values)
        if isinstance(node, ast.IfExp):
            return self.is_device(node.body) or self.is_device(node.orelse)
        if isinstance(node, ast.Starred):
            return self.is_device(node.value)
        if isinstance(node, ast.Call):
            dd = _dotted(node.func) or ""
            root = dd.split(".")[0]
            if _is_torch_call(dd):
                return True
            if dd.startswith(_HOST_TORCH) or dd in _HOST_TORCH_EXACT:
                return False
            # Method chains on device values (.to/.view/.sum/...) stay
            # device; the host conversions and static queries do not.
            if isinstance(node.func, ast.Attribute) and self.is_device(
                    node.func.value):
                return node.func.attr not in (_SYNC_METHODS
                                              | _STATIC_METHODS)
            if root in ("np", "numpy", "bool", "int", "float", "len",
                        "isinstance", "range", "str"):
                return False
            return any(self.is_device(a) for a in node.args) or any(
                self.is_device(k.value) for k in node.keywords)
        return False

    def is_tensor(self, node: ast.AST) -> bool:
        """Certainly one tensor (not a tuple of them): a torch.* result,
        a tensor method's result or a name bound to one."""
        if isinstance(node, ast.Name):
            return node.id in self.tensor
        if isinstance(node, ast.Call):
            dd = _dotted(node.func) or ""
            if _is_torch_call(dd):
                return dd.split(".")[-1] not in ("broadcast_tensors",
                                                 "unbind", "split", "chunk",
                                                 "meshgrid", "where_")
            if isinstance(node.func, ast.Attribute) and self.is_tensor(
                    node.func.value):
                return node.func.attr not in (
                    _SYNC_METHODS | _STATIC_METHODS
                    | {"unbind", "split", "chunk", "max", "min", "sort",
                       "topk"})
            return False
        if isinstance(node, ast.BinOp):
            return self.is_tensor(node.left) or self.is_tensor(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_tensor(node.operand)
        if isinstance(node, ast.Subscript):
            return self.is_tensor(node.value)
        return False

    def _is_narrow(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.narrow
        if isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute):
            if node.func.attr in ("to", "type") and node.args:
                cast = ast.unparse(node.args[0]).split(".")[-1]
                if cast in _NARROW_CASTS:
                    return True
            if node.func.attr in ("char", "short") and not node.args:
                return True
        if isinstance(node, ast.Call):
            dd = _dotted(node.func) or ""
            if dd.split(".")[-1] == "narrow_state":
                return True
        return False

    # -- the pass -------------------------------------------------------------

    def run(self) -> None:
        node = self.fr.node
        if self.graph:
            # Two passes: devness propagates through assignments that
            # lexically precede their uses on pass 1; pass 2 catches
            # the rest (closures over later defs are rare in graph code).
            for _ in range(2):
                for stmt in ast.walk(node):
                    if isinstance(stmt, ast.Assign):
                        dev = self.is_device(stmt.value)
                        ten = self.is_tensor(stmt.value)
                        nar = self._is_narrow(stmt.value)
                        for t in stmt.targets:
                            for n in ast.walk(t):
                                # Only the names bound (not the
                                # container and index of `a[k] = v`).
                                if isinstance(n, ast.Name) and isinstance(
                                        n.ctx, ast.Store):
                                    if dev:
                                        self.device.add(n.id)
                                    if ten and isinstance(t, ast.Name):
                                        self.tensor.add(n.id)
                                    if nar:
                                        self.narrow.add(n.id)
                                    elif n.id in self.narrow:
                                        self.narrow.discard(n.id)
                    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
                        tgt = stmt.target
                        if isinstance(tgt, ast.Name) and stmt.value is not None \
                                and self.is_device(stmt.value):
                            self.device.add(tgt.id)
            self._check_graph_rules(node)
            self._check_widen_discipline(node)
        else:
            self._check_host_rules(node)

    def _check_graph_rules(self, fn_node: ast.AST) -> None:
        own_nested = {
            n for n in ast.walk(fn_node)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and n is not fn_node
        }

        def in_nested(node):
            return any(node in ast.walk(f) for f in own_nested)

        for node in ast.walk(fn_node):
            # Nested defs are linted as their own (reachable) functions.
            if node is not fn_node and in_nested(node):
                continue
            if isinstance(node, (ast.If, ast.While)) and self.is_device(
                    node.test):
                self._emit(node, "tensor-branch",
                           f"`{ast.unparse(node.test)[:60]}` is a device "
                           "value; use torch.where")
            elif isinstance(node, ast.IfExp) and self.is_device(node.test):
                self._emit(node, "tensor-branch",
                           "ternary on a device value; use torch.where")
            elif isinstance(node, ast.Assert) and self.is_device(node.test):
                self._emit(node, "tensor-branch",
                           "assert on a device value (syncs); use a "
                           "static shape check or a device-side select")
            elif isinstance(node, ast.BoolOp) and self.is_device(node):
                self._emit(node, "tensor-branch",
                           "and/or on device values calls bool(); "
                           "use & / | / torch.logical_*")
            elif isinstance(node, ast.For) and self.is_tensor(node.iter):
                self._emit(node, "tensor-branch",
                           "iteration over a tensor; index with a static "
                           "range")
            elif isinstance(node, ast.comprehension) and self.is_tensor(
                    node.iter):
                self._emit(node, "tensor-branch",
                           "comprehension over a tensor")
            elif isinstance(node, ast.Call):
                self._check_graph_call(node)
            elif isinstance(node, ast.BinOp):
                for side in (node.left, node.right):
                    if self._is_narrow(side):
                        self._emit(
                            node, "narrow-lane-arith",
                            "arithmetic on an int8/int16-narrowed value; "
                            "widen to i32 first (state.widen_state / "
                            ".to(I32))")
                        break

    def _check_graph_call(self, node: ast.Call) -> None:
        dd = _dotted(node.func) or ""
        leaf = dd.split(".")[-1]
        if dd.startswith(_IMPURE_PREFIXES) or dd in _IMPURE_EXACT:
            self._emit(node, "impure-graph",
                       f"`{dd}(...)` inside graph-reachable code")
            return
        args_dev = any(self.is_device(a) for a in node.args) or any(
            self.is_device(k.value) for k in node.keywords)
        method_on_dev = isinstance(node.func, ast.Attribute) and \
            self.is_device(node.func.value)
        if method_on_dev and node.func.attr in _SYNC_METHODS:
            self._emit(node, "host-sync-in-graph",
                       f".{node.func.attr}() on a device value inside "
                       "graph-reachable code")
        elif dd in ("bool", "int", "float") and args_dev:
            self._emit(node, "host-sync-in-graph",
                       f"{dd}() on a device value inside graph-reachable "
                       "code (syncs on the tensor)")
        elif dd == "torch.cuda.synchronize" or (
                leaf in _DYNAMIC_SHAPE
                and (_is_torch_call(dd) or method_on_dev)):
            self._emit(node, "host-sync-in-graph",
                       f"`{dd}(...)` inside graph-reachable code (a host "
                       "sync: a synchronize or a data-dependent shape)")
        elif dd.split(".")[0] in ("np", "numpy") and not dd.startswith(
                ("np.random", "numpy.random")):
            if args_dev:
                self._emit(node, "host-sync-in-graph",
                           f"`{dd}(...)` on a device value inside "
                           "graph-reachable code (numpy pulls the tensor "
                           "to the host)")
            else:
                self._emit(node, "h2d-in-graph",
                           f"`{dd}(...)` inside graph-reachable code "
                           "(host data made every round)")
        elif dd in _H2D_CALLS:
            self._emit(node, "h2d-in-graph",
                       f"`{dd}(...)` inside graph-reachable code (a "
                       "host-to-device copy every round; make it once per "
                       "device, as step._lane_table does)")

    def _check_widen_discipline(self, fn_node: ast.AST) -> None:
        """In an entry root with a BatchedState-annotated param, narrow
        state fields must not be touched before widen_state runs (the
        widen-at-entry contract that keeps cfg.narrow_lanes safe)."""
        if not self.fr.entry or isinstance(fn_node, ast.Lambda):
            return
        args = self.fr.node.args
        state_params = {
            a.arg for a in args.posonlyargs + args.args + args.kwonlyargs
            if a.annotation is not None
            and ast.unparse(a.annotation).split(".")[-1] == "BatchedState"
        }
        if not state_params:
            return
        widened = False
        for stmt in getattr(fn_node, "body", []):
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Call):
                    dd = _dotted(sub.func) or ""
                    if dd.split(".")[-1] == "widen_state":
                        widened = True
                if (not widened and isinstance(sub, ast.Attribute)
                        and sub.attr in NARROW_FIELDS
                        and isinstance(sub.value, ast.Name)
                        and sub.value.id in state_params):
                    self._emit(
                        sub, "narrow-lane-arith",
                        f"narrow lane `.{sub.attr}` read in an entry root "
                        "before widen_state (storage may be int8/int16 "
                        "under cfg.narrow_lanes)")
            if widened:
                break

    def _check_host_rules(self, fn_node: ast.AST) -> None:
        if not self.mod.imports_torch:
            return
        loops = [n for n in ast.walk(fn_node)
                 if isinstance(n, (ast.For, ast.While))]
        seen: Set[int] = set()
        for loop in loops:
            parts = loop.body + loop.orelse + (
                [loop.test] if isinstance(loop, ast.While) else [])
            for node in (n for p in parts for n in ast.walk(p)):
                if id(node) in seen or not isinstance(node, ast.Call):
                    continue
                dd = _dotted(node.func) or ""
                funcs, unique = self.syncing
                target = _resolve(self.mod, node, self.by_name)
                if _is_direct_sync(node):
                    what = dd or f".{node.func.attr}()"
                elif (target in funcs if target is not None else
                      isinstance(node.func, ast.Attribute)
                      and node.func.attr in unique):
                    what = f"{dd}() (it syncs)"
                else:
                    continue
                seen.add(id(node))
                self._emit(
                    node, "sync-in-loop",
                    f"`{what}` inside a host loop; hoist to one bulk sync "
                    "per round")


def _check_dict_order_static(mod: _ModRec) -> None:
    cached = {fr.node.name for fr in mod.all_funcs if fr.cached}
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        if _is_graphs_run(node):
            key = _run_key(node)
            roots = [key] if key is not None else []
            what = "a RoundGraphs.run key"
        elif (_dotted(node.func) or "").split(".")[-1] in cached:
            roots = list(node.args) + [k.value for k in node.keywords]
            what = "an lru_cache'd builder"
        else:
            continue
        for arg in roots:
            for sub in ast.walk(arg):
                bad = None
                if isinstance(sub, (ast.Set, ast.SetComp)):
                    bad = "set literal/comprehension"
                elif isinstance(sub, ast.Call):
                    sdd = _dotted(sub.func) or ""
                    if sdd in ("set", "frozenset"):
                        bad = f"{sdd}(...)"
                    elif isinstance(sub.func, ast.Attribute) and \
                            sub.func.attr in ("keys", "values", "items"):
                        bad = f".{sub.func.attr}()"
                if bad and not _sorted_wrapped(arg, sub):
                    mod.findings.append(Finding(
                        mod.path, sub.lineno, "dict-order-static",
                        f"{bad} feeding {what} — iteration order is "
                        "not canonical; wrap in sorted(...) or use a "
                        "tuple literal"))


def _sorted_wrapped(root: ast.AST, target: ast.AST) -> bool:
    for node in ast.walk(root):
        if isinstance(node, ast.Call):
            if (_dotted(node.func) or "") == "sorted":
                if any(sub is target for sub in ast.walk(node)):
                    return True
    return False


# -----------------------------------------------------------------------------
# Entry points
# -----------------------------------------------------------------------------


def _apply_waivers(mod: _ModRec) -> None:
    for f in mod.findings:
        if f.rule.startswith("waiver-"):
            continue
        for w in mod.waivers:
            if w.line == f.line and f.rule in w.rules:
                f.waived = True
                f.reason = w.reason
                w.used = True
                break
    for w in mod.waivers:
        if not w.used:
            mod.findings.append(Finding(
                mod.path, w.pragma_line, "waiver-unused",
                f"waive({', '.join(sorted(w.rules))}) suppresses "
                "nothing on its target line"))


def lint_modules(mods: Dict[str, _ModRec]) -> List[Finding]:
    _propagate_reachability(mods)
    syncing = _syncing(mods)
    by_name: Dict[str, _ModRec] = {}
    for m in mods.values():
        by_name.setdefault(m.name, m)
    for mod in mods.values():
        for fr in mod.all_funcs:
            _FuncLinter(mod, fr, graph=fr.reachable, syncing=syncing,
                        by_name=by_name).run()
        _check_dict_order_static(mod)
        _apply_waivers(mod)
    # A nested def's body is walked with its parent's and on its own:
    # one finding per (path, line, rule, message).
    out = {(f.path, f.line, f.rule, f.message): f
           for mod in mods.values() for f in mod.findings}
    return sorted(out.values(), key=lambda f: (f.path, f.line, f.rule))


def lint_source(source: str, path: str = "<string>",
                extra_modules: Optional[Dict[str, str]] = None
                ) -> List[Finding]:
    """Lint one source string (tests); `extra_modules` maps module name
    -> source for cross-file reachability."""
    mods = {}
    rec = _collect_module(path, source)
    mods[rec.path] = rec
    for name, src in (extra_modules or {}).items():
        extra = _collect_module(f"<{name}>", src)
        extra.name = name
        mods[extra.path] = extra
    return [f for f in lint_modules(mods) if f.path == path]


def lint_file(path: str) -> List[Finding]:
    return lint_paths([path])


def collect_files(paths: Sequence[str]) -> List[str]:
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for base, _dirs, names in os.walk(p):
                files.extend(
                    os.path.join(base, n) for n in sorted(names)
                    if n.endswith(".py"))
        elif p.endswith(".py") and os.path.isfile(p):
            files.append(p)
        else:
            # A typo'd/renamed path must FAIL the gate, not lint zero
            # files and exit green — a vacuous gate is worse than a
            # broken one.
            raise FileNotFoundError(
                f"jitlint: not a directory or existing .py file: {p!r}")
    return files


def lint_paths(paths: Sequence[str]) -> List[Finding]:
    mods: Dict[str, _ModRec] = {}
    for path in collect_files(paths):
        with open(path, "r", encoding="utf-8") as fh:
            source = fh.read()
        try:
            rec = _collect_module(path, source)
        except SyntaxError as e:
            rec = _ModRec(os.path.basename(path), path,
                          ast.Module(body=[], type_ignores=[]), [])
            rec.findings.append(Finding(
                path, e.lineno or 0, "syntax-error",
                f"syntax error: {e.msg}"))
        # Keyed by PATH (stems collide across dirs, e.g. tools/x.py vs
        # pkg/x.py); lint_modules builds its own name index for import
        # resolution.
        mods[rec.path] = rec
    return lint_modules(mods)


# -----------------------------------------------------------------------------
# CLI (the port's tools/jitlint.py)
# -----------------------------------------------------------------------------


def main(argv: Optional[Sequence[str]] = None) -> int:
    """python -m etcd_tpu_torch.analysis.jitlint [--format json]
    [--list-rules] [--show-waived] PATH...

    Exit code 0 iff there are zero unwaived findings; 2 on a path that
    is neither a directory nor a .py file, or on no files at all. Pure
    AST: no torch, no device, safe anywhere."""
    ap = argparse.ArgumentParser(
        prog="python -m etcd_tpu_torch.analysis.jitlint",
        description="host-sync / capture-safety lint for the port's "
                    "graphed round")
    ap.add_argument("paths", nargs="*", default=[],
                    help="files or directories to lint")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--show-waived", action="store_true",
                    help="also print waived findings (audit mode)")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule, doc in sorted(RULES.items()):
            print(f"{rule:20s} {doc}")
        return 0
    if not args.paths:
        ap.error("no paths given (try: python -m "
                 "etcd_tpu_torch.analysis.jitlint etcd_tpu_torch/batched/)")

    try:
        files = collect_files(args.paths)
    except FileNotFoundError as e:
        print(e, file=sys.stderr)
        return 2
    if not files:
        print(f"jitlint: no .py files under {args.paths} — refusing to "
              "pass a vacuous gate", file=sys.stderr)
        return 2
    findings = lint_paths(files)
    unwaived = [f for f in findings if not f.waived]
    waived = [f for f in findings if f.waived]

    if args.format == "json":
        print(json.dumps([f.__dict__ for f in findings], indent=1))
    else:
        for f in unwaived:
            print(f.format())
        if args.show_waived:
            for f in waived:
                print(f.format())
        print(f"jitlint: {len(unwaived)} finding(s), "
              f"{len(waived)} waived", file=sys.stderr)
    return 1 if unwaived else 0


if __name__ == "__main__":
    sys.exit(main())
