"""Hopper kernels for the batched round's two reductions, their wrappers
and launch counts. Each kernel's plain version is the plain form in
kernels.py (``*_ref`` here names it).

Ports ``etcd_tpu/batched/pallas_kernels.py``:

* ``quorum_commit_vote`` — joint-config commit index and vote result
  (ref: raft/quorum/majority.go:126-210, joint.go:49-75), in the quorum
  support form: the largest masked match value supported by >= n//2+1
  voters, an O(R²) loop with no sort (the plain form sorts; both pick
  the same index). ``tallies`` B lets one launch hold B vote tallies
  per instance against the instance's unexpanded masks.
* ``term_at_batch`` — the term of a log index read from the [N, W] term
  ring (ref: the zero-term-outside-bounds contract of raft/log.go
  term()), for one index per instance ([N]) or K of them ([N, K]).

The CUDA source is ``csrc/quorum_ring.cu`` (its head note gives the
design). It is compiled with nvcc for sm_90a into a shared library with
a plain C interface the first time a kernel runs on a CUDA tensor
(rebuilt when the source changes) and loaded with ctypes.
On a CPU tensor each wrapper runs its plain version; on a CUDA tensor
it launches the kernel on PyTorch's current stream or raises. The
kernels allocate nothing and never synchronize, so a CUDA graph can
capture them.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import torch

# The plain versions are the plain forms of kernels.py, so that the
# kernel checks and the round on the CPU rest on one reference.
from .kernels import joint_committed_plain as quorum_commit_ref
from .kernels import joint_vote_result_plain as quorum_vote_ref
from .kernels import term_at_plain as term_at_batch_ref

I32 = torch.int32

SOURCE = Path(__file__).resolve().parent / "csrc" / "quorum_ring.cu"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

MODE_COMMIT, MODE_VOTE = 1, 2
MODE_NAMES = {MODE_COMMIT: "commit", MODE_VOTE: "vote",
              MODE_COMMIT | MODE_VOTE: "both"}
# The kernels index in 32 bits.
MAX_ELEMS = 2**31 - 1

# Kernel launches per wrapper since the last reset_launches(), and per
# (kernel, form): a count is added where a wrapper launches its kernel
# and nowhere else, so a run can show that its CUDA path went through
# the kernels, and with which shapes. Under a CUDA graph capture a
# launch is only recorded: the count is taken back and added once per
# replay (recorded_launches, add_launches).
LAUNCHES = {"quorum_commit_vote": 0, "term_at_batch": 0}
FORM_LAUNCHES: "collections.Counter[str]" = collections.Counter()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    FORM_LAUNCHES.clear()


@contextlib.contextmanager
def recorded_launches():
    """For a CUDA graph capture, where a wrapper's launch is recorded
    and runs only at each replay: the counts leave the block as they
    entered it, and the dict yielded receives the launches made inside
    ("kernels": per kernel, "forms": per form), which the replayer adds
    with add_launches once per replay."""
    kernels, forms = dict(LAUNCHES), collections.Counter(FORM_LAUNCHES)
    made = {}
    try:
        yield made
    finally:
        made["kernels"] = {k: LAUNCHES[k] - kernels[k] for k in LAUNCHES}
        made["forms"] = FORM_LAUNCHES - forms
        LAUNCHES.update(kernels)
        FORM_LAUNCHES.clear()
        FORM_LAUNCHES.update(forms)


def add_launches(made: dict, times: int = 1) -> None:
    """Count the launches of a recorded block (recorded_launches) as
    made `times` more times: its graph was replayed that often."""
    for k, v in made["kernels"].items():
        LAUNCHES[k] += v * times
    for k, v in made["forms"].items():
        FORM_LAUNCHES[k] += v * times


# -- build -------------------------------------------------------------------


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> Path:
    """Where the built library for the current source lives."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libquorum_ring_{digest}.so"


def build_library(source: Path, path: Path) -> ctypes.CDLL:
    """Build CUDA `source` into the shared library `path` with
    NVCC_FLAGS unless it is there, and load it."""
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        # Build to a private name, then rename: a concurrent build
        # never loads a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
        os.close(fd)
        try:
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)],
                capture_output=True, text=True, check=False)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed (rc={proc.returncode}) building "
                    f"{source.name}:\n{proc.stderr}")
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return ctypes.CDLL(str(path))


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    lib = build_library(SOURCE, library_path())
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.quorum_commit_vote_launch.argtypes = [
        i32, p, p, p, p, p, p, p, i32, i32, i32, p]
    lib.quorum_commit_vote_launch.restype = i32
    lib.term_at_batch_launch.argtypes = [p, p, p, p, p, p, i32, i32, i32, p]
    lib.term_at_batch_launch.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _launchers():
    """The library's two launch functions, resolved once."""
    lib = load_library()
    return lib.quorum_commit_vote_launch, lib.term_at_batch_launch


# -- argument checks and the launch ------------------------------------------------


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device):
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if x.shape != shape:
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _ptr(x):
    return None if x is None else x.data_ptr()


def _launch(kernel: str, fn, dev: torch.device, *args: int) -> None:
    """Call launch function `fn` with `args` and the raw handle of
    PyTorch's current stream on `dev`, switching device only when `dev`
    is not the current one; raise on a launch error."""
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _launch(kernel, fn, dev, *args)
    err = fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError_t {err}")


# -- B1: joint quorum ----------------------------------------------------------


def quorum_commit_vote_ref(match, voter, voter_out, in_joint, votes):
    """Plain version of quorum_commit_vote."""
    return (quorum_commit_ref(match, voter, voter_out, in_joint),
            quorum_vote_ref(votes, voter, voter_out, in_joint))


def _quorum_launch(mode: int, match, voter, voter_out, in_joint, votes,
                   tallies: int = 1):
    """Launch the quorum kernel for the halves that `mode` asks for, over
    N*tallies rows of match/votes against N rows of masks; returns
    (commit or None, vres or None)."""
    shape = voter.shape
    dev = voter.device
    n, r = shape
    rows = n * tallies
    if rows * r > MAX_ELEMS:
        raise ValueError(f"quorum: {rows} x {r} elements exceed the "
                         "kernel's 32-bit indexing")
    _check("voter", voter, torch.bool, shape, dev)
    _check("voter_out", voter_out, torch.bool, shape, dev)
    _check("in_joint", in_joint, torch.bool, shape[:1], dev)
    row_shape = torch.Size((rows, r))
    commit = vres = None
    if mode & MODE_COMMIT:
        _check("match", match, I32, row_shape, dev)
        commit = torch.empty(rows, dtype=I32, device=dev)
    if mode & MODE_VOTE:
        _check("votes", votes, I32, row_shape, dev)
        vres = torch.empty(rows, dtype=I32, device=dev)
    _launch("quorum_commit_vote", _launchers()[0], dev, mode, _ptr(match),
            voter.data_ptr(), voter_out.data_ptr(), in_joint.data_ptr(),
            _ptr(votes), _ptr(commit), _ptr(vres), rows, tallies, r)
    LAUNCHES["quorum_commit_vote"] += 1
    FORM_LAUNCHES[f"quorum_commit_vote {MODE_NAMES[mode]} R={r} "
                  f"B={tallies}"] += 1
    return commit, vres


def quorum_commit_vote(match, voter, voter_out, in_joint, votes):
    """Fused joint commit index + vote result over [N, R] inputs.

    match [N, R] i32; voter/voter_out [N, R] bool; in_joint [N] bool;
    votes [N, R] i32 (-1 missing / 0 rejected / 1 granted).
    Returns (commit [N] i32, vote_result [N] i32)."""
    if not voter.is_cuda:
        return quorum_commit_vote_ref(match, voter, voter_out, in_joint,
                                      votes)
    return _quorum_launch(MODE_COMMIT | MODE_VOTE, match, voter, voter_out,
                          in_joint, votes)


def quorum_commit(match, voter, voter_out, in_joint):
    """The commit half of quorum_commit_vote: [N] joint commit index."""
    if not voter.is_cuda:
        return quorum_commit_ref(match, voter, voter_out, in_joint)
    return _quorum_launch(MODE_COMMIT, match, voter, voter_out, in_joint,
                          None)[0]


def quorum_vote(votes, voter, voter_out, in_joint, tallies=1):
    """The vote half of quorum_commit_vote: [N*B] joint vote results of
    votes [N*B, R], B = `tallies` per instance, instance i's tallies
    in rows i*B .. i*B+B-1, each held to that instance's voter/voter_out
    [N, R] and in_joint [N]."""
    if not voter.is_cuda:
        return quorum_vote_ref(votes, voter, voter_out, in_joint, tallies)
    return _quorum_launch(MODE_VOTE, None, voter, voter_out, in_joint,
                          votes, tallies)[1]


# -- B2: ring-term lookup ------------------------------------------------------


def term_at_batch(log_term, snap_index, snap_term, last, idx):
    """Ring term of entry ``idx`` per instance, 0 outside
    (snap_index, last] and snap_term at the floor itself.

    log_term [N, W] i32; snap_index/snap_term/last [N] i32; idx [N] or
    [N, K] i32. Returns the terms in idx's shape, i32."""
    if not log_term.is_cuda:
        return term_at_batch_ref(log_term, snap_index, snap_term, last, idx)
    shape = log_term.shape
    n, w = shape
    dev = log_term.device
    if idx.dim() not in (1, 2) or idx.shape[0] != n:
        raise ValueError(f"idx: shape {tuple(idx.shape)}, expected ({n},) "
                         f"or ({n}, K)")
    k = idx.shape[1] if idx.dim() == 2 else 1
    if n * max(k, w) > MAX_ELEMS:
        raise ValueError(f"term_at_batch: {n} x {max(k, w)} elements "
                         "exceed the kernel's 32-bit indexing")
    _check("log_term", log_term, I32, shape, dev)
    for name, x in (("snap_index", snap_index), ("snap_term", snap_term),
                    ("last", last)):
        _check(name, x, I32, shape[:1], dev)
    _check("idx", idx, I32, idx.shape, dev)
    out = torch.empty(idx.shape, dtype=I32, device=dev)
    _launch("term_at_batch", _launchers()[1], dev, log_term.data_ptr(),
            snap_index.data_ptr(), snap_term.data_ptr(), last.data_ptr(),
            idx.data_ptr(), out.data_ptr(), n, k, w)
    LAUNCHES["term_at_batch"] += 1
    FORM_LAUNCHES[f"term_at_batch K={k} W={w}"] += 1
    return out
