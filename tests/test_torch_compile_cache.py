"""The port's build-cache record (etcd_tpu_torch/batched/compile_cache.py)
beside the JAX package's (tests/batched/test_compile_cache.py): the
wiring (environment precedence, the off switch, idempotence) and the
cross-process behaviour: a fresh process pointed at a directory that
already holds the native library for its source builds nothing.

The port's two native libraries are the Hopper kernels (nvcc, on the
card only) and the WAL's record log (g++); the cross-process test runs
on the record log, which builds here.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import etcd_tpu_torch.batched.compile_cache as cc
from etcd_tpu_torch import native
from etcd_tpu_torch.batched import hopper_kernels as hk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def clean_cc(monkeypatch):
    """Isolate the module's latch and both build directories, and keep
    the record log's loaded handle out of the way, so tests neither see
    nor leave global state."""
    monkeypatch.setattr(cc, "_configured", None)
    monkeypatch.setattr(hk, "BUILD_DIR", hk.BUILD_DIR)
    monkeypatch.setattr(native, "BUILD_DIR", native.BUILD_DIR)
    monkeypatch.setattr(native, "_cache", {})
    monkeypatch.delenv("ETCD_TPU_COMPILE_CACHE", raising=False)


class TestWiring:
    def test_default_is_the_two_build_directories(self, clean_cc):
        kernels_dir, native_dir = cc.default_dirs()
        assert cc.enable_compile_cache() == kernels_dir
        assert hk.BUILD_DIR == Path(REPO, "etcd_tpu_torch", "batched",
                                    "_build")
        assert native.BUILD_DIR == os.path.join(
            REPO, "etcd_tpu_torch", "native", "_build") == native_dir

    def test_env_off_builds_in_a_private_directory(self, clean_cc,
                                                   monkeypatch):
        """off / 0 / none: a fresh directory of this process (every
        process builds), the same one for every later call."""
        for v in ("off", "0", "none", "OFF"):
            monkeypatch.setattr(cc, "_configured", None)
            monkeypatch.setenv("ETCD_TPU_COMPILE_CACHE", v)
            d = cc.enable_compile_cache()
            assert os.path.isdir(d) and os.listdir(d) == []
            assert d not in cc.default_dirs()
            assert hk.BUILD_DIR == Path(d) and native.BUILD_DIR == d
            assert cc.enable_compile_cache() == d

    def test_env_dir_and_explicit_precedence(self, clean_cc, monkeypatch,
                                             tmp_path):
        env_dir = str(tmp_path / "envdir")
        monkeypatch.setenv("ETCD_TPU_COMPILE_CACHE", env_dir)
        assert cc.enable_compile_cache() == env_dir
        assert os.path.isdir(env_dir)
        assert hk.library_path().parent == Path(env_dir)
        assert os.path.dirname(native.library_path("walog")) == env_dir
        # Explicit arg wins over env and over what was configured.
        exp_dir = str(tmp_path / "explicit")
        assert cc.enable_compile_cache(exp_dir) == exp_dir
        assert hk.BUILD_DIR == Path(exp_dir) and native.BUILD_DIR == exp_dir
        # A no-arg call (every engine constructor makes one) keeps it.
        assert cc.enable_compile_cache() == exp_dir

    def test_idempotent(self, clean_cc, monkeypatch, tmp_path):
        d = str(tmp_path / "c")
        monkeypatch.setenv("ETCD_TPU_COMPILE_CACHE", d)
        assert cc.enable_compile_cache() == d
        assert cc.enable_compile_cache() == d  # second call: no-op

    def test_repointing_a_loaded_library_raises(self, clean_cc, tmp_path):
        """A process loads each library once: once the record log is
        loaded from one directory, moving its build raises and loads no
        second copy."""
        first = str(tmp_path / "first")
        assert cc.enable_compile_cache(first) == first
        lib = native.load("walog")
        assert native._cache == {"walog": lib}
        with pytest.raises(RuntimeError, match="already loaded"):
            cc.enable_compile_cache(str(tmp_path / "second"))
        assert native.BUILD_DIR == first
        assert native.load("walog") is lib
        assert not (tmp_path / "second").exists() or not os.listdir(
            tmp_path / "second")
        # Pointing at the directory it was loaded from stays fine.
        assert cc.enable_compile_cache(first) == first

    def test_engine_and_rawnode_constructors_enable_it(self, clean_cc,
                                                       monkeypatch,
                                                       tmp_path):
        from etcd_tpu_torch.batched import MultiRaftEngine
        from etcd_tpu_torch.batched.rawnode import BatchedRawNode
        from etcd_tpu_torch.tools.benchlib import bench_config

        d = str(tmp_path / "ctor")
        monkeypatch.setenv("ETCD_TPU_COMPILE_CACHE", d)
        MultiRaftEngine(bench_config(2), device="cpu")
        assert cc._configured == d and native.BUILD_DIR == d
        monkeypatch.setattr(cc, "_configured", None)
        BatchedRawNode(bench_config(2), device="cpu")
        assert cc._configured == d


_BUILD_SNIPPET = """
import json, os, time
from etcd_tpu_torch import native
from etcd_tpu_torch.batched import MultiRaftEngine
from etcd_tpu_torch.tools.benchlib import bench_config

MultiRaftEngine(bench_config(2), device="cpu")  # enables the cache from env
path = native.library_path("walog")
found = os.path.exists(path)
t0 = time.perf_counter()
native.load("walog")
print(json.dumps({"found": found, "load_s": time.perf_counter() - t0,
                  "path": path, "mtime": os.stat(path).st_mtime_ns}))
"""


class TestCrossProcessWarmStart:
    def test_second_process_builds_nothing(self, tmp_path):
        """A cold process builds the record log into the configured
        directory; a warm process pointed at it finds the library for
        its source, loads it and adds nothing (the file set and the
        library's mtime stay as they were)."""
        cache = tmp_path / "builds"
        env = dict(os.environ, ETCD_TPU_COMPILE_CACHE=str(cache))

        def build():
            r = subprocess.run([sys.executable, "-c", _BUILD_SNIPPET],
                               env=env, cwd=REPO, capture_output=True,
                               text=True, timeout=300)
            assert r.returncode == 0, r.stderr[-2000:]
            return json.loads(r.stdout.strip().splitlines()[-1])

        cold = build()
        assert not cold["found"]
        assert os.path.dirname(cold["path"]) == str(cache)
        entries = set(os.listdir(cache))
        assert entries == {os.path.basename(cold["path"])}

        warm = build()
        assert warm["found"] and warm["path"] == cold["path"]
        assert set(os.listdir(cache)) == entries, "warm process built"
        assert warm["mtime"] == cold["mtime"]
        assert warm["load_s"] < cold["load_s"]

    def test_off_builds_in_every_process(self, tmp_path):
        env = dict(os.environ, ETCD_TPU_COMPILE_CACHE="off",
                   TMPDIR=str(tmp_path))
        paths = []
        for _ in range(2):
            r = subprocess.run([sys.executable, "-c", _BUILD_SNIPPET],
                               env=env, cwd=REPO, capture_output=True,
                               text=True, timeout=300)
            assert r.returncode == 0, r.stderr[-2000:]
            out = json.loads(r.stdout.strip().splitlines()[-1])
            assert not out["found"]
            paths.append(out["path"])
        assert paths[0] != paths[1]
        # Each process removed its private directory at exit.
        assert not any(os.path.exists(p) for p in paths)
