"""Where the port's native builds go, and how a second process reuses them.

Ports ``etcd_tpu/batched/compile_cache.py``. The JAX package points
XLA's persistent compilation cache at one directory, so the second
compile of an identical round program is a disk hit. The port has no
XLA cache: what it builds are two native libraries, each named by the
hash of its source, so a build directory is already a cache keyed by
content:

* the Hopper kernels, built by nvcc (``hopper_kernels.library_path``,
  ``load_library``);
* the WAL's record log, built by g++ (``native.library_path``,
  ``native.build``).

A process that finds the library for its source in the directory loads
it and builds nothing; one that does not builds it there. A CUDA graph
cannot be cached across processes: each process captures its own.

Environment:

* ``ETCD_TPU_COMPILE_CACHE=<dir>``: build both libraries into ``<dir>``.
* ``ETCD_TPU_COMPILE_CACHE=off`` (or ``0`` / ``none``): build into a
  fresh temporary directory of this process, removed at exit, so every
  process builds: what a disabled cache means here.
* unset: the two git-ignored ``_build`` directories beside the sources
  (``batched/_build``, ``native/_build``).

The directory is chosen once per process. A library is loaded once per
process (``load_library`` is an ``lru_cache``, ``native.load`` keeps
its handle), so repointing a build after its library was loaded raises
rather than load a second copy.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from pathlib import Path
from typing import Optional

from .. import native
from . import hopper_kernels

_OFF = ("0", "off", "none")
_configured: Optional[str] = None


def default_dirs() -> "tuple[str, str]":
    """The build directories when nothing is configured: the kernel
    library's and the record log's ``_build`` beside their sources."""
    return (str(Path(hopper_kernels.SOURCE).parent.parent / "_build"),
            str(Path(native.__file__).resolve().parent / "_build"))


def _private_dir() -> str:
    """A fresh build directory for this process, removed at its exit."""
    d = tempfile.mkdtemp(prefix="etcd_tpu_torch_build_")
    atexit.register(shutil.rmtree, d, True)
    return d


def _point(kernels_dir: str, native_dir: str) -> None:
    """Point both builds at their directories; raise if a library of
    either was already loaded from elsewhere."""
    loaded = {
        "the Hopper kernel library": (
            hopper_kernels.load_library.cache_info().currsize > 0,
            str(hopper_kernels.BUILD_DIR), kernels_dir),
        "the native record log": (bool(native._cache), native.BUILD_DIR,
                                  native_dir),
    }
    for what, (is_loaded, now, want) in loaded.items():
        if is_loaded and os.path.abspath(now) != os.path.abspath(want):
            raise RuntimeError(
                f"{what} is already loaded from {now}; a process loads it "
                f"once, so the build directory cannot move to {want}")
    hopper_kernels.BUILD_DIR = Path(kernels_dir)
    native.BUILD_DIR = native_dir


def enable_compile_cache(cache_dir: Optional[str] = None) -> str:
    """Point both native builds at one directory and return it (explicit
    argument > a directory already configured in this process >
    ``ETCD_TPU_COMPILE_CACHE`` > the default; the env ``off`` switch
    applies only to no-arg calls). Under the default the two libraries
    keep their own ``_build`` directories and the kernel library's is
    returned. Idempotent: the no-arg calls that every engine and
    rawnode constructor makes keep what was configured."""
    global _configured
    env = os.environ.get("ETCD_TPU_COMPILE_CACHE", "")
    if cache_dir is None and _configured is not None:
        return _configured
    if cache_dir is None and env.lower() in _OFF:
        cache_dir = _private_dir()
    cache_dir = cache_dir or env
    if not cache_dir:
        kernels_dir, native_dir = default_dirs()
        _point(kernels_dir, native_dir)
        _configured = kernels_dir
        return kernels_dir
    if _configured == cache_dir:
        return cache_dir
    os.makedirs(cache_dir, exist_ok=True)
    _point(cache_dir, cache_dir)
    _configured = cache_dir
    return cache_dir
