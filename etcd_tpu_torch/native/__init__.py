"""Native (C++) runtime components, loaded over ctypes.

Ports ``etcd_tpu/native/__init__.py``. The WAL's segment framing, CRC
chain and fsync are C++ (``src/walog.cc``, a copy of etcd_tpu's). The
shared library is built with g++ the first time it is loaded, into
``_build/`` beside the sources (git-ignored), under a name keyed by the
source's hash, so a changed source is rebuilt and no binary is
committed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src")
BUILD_DIR = os.path.join(_DIR, "_build")
GXX_FLAGS = ("-O2", "-g", "-std=c++17", "-fPIC", "-shared", "-Wall",
             "-Wextra")

_lock = threading.Lock()
_cache: dict[str, ctypes.CDLL] = {}


def library_path(name: str) -> str:
    """Where the built library for the current source of `name` lives."""
    with open(os.path.join(_SRC, f"{name}.cc"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def build(name: str) -> str:
    """Build `name` from src/ (once per source hash); its path."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Build to a private name, then rename: a concurrent build never
    # loads a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            ["g++", *GXX_FLAGS, "-o", tmp, os.path.join(_SRC, f"{name}.cc")],
            capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed (rc={proc.returncode}) building "
                               f"{name}.cc:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _cache.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _cache[name] = lib
        return lib
