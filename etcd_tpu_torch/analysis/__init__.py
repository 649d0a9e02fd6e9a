"""Analysis for the port's host paths (ports part of ``etcd_tpu/analysis``).

* ``lockorder`` — an instrumented ``threading.Lock`` recorder that
  builds the cross-thread acquisition graph (drain/pump/sender lanes)
  and fails on cycles; a copy of the JAX package's, stdlib only.

The JAX package's other analysis modules, ``jitlint`` (AST lint of
jit-reachable code), ``sentinels`` (the transfer guard and the
recompile sentinel) and ``batched/compile_cache.py``, are queued in
ROADMAP (A15).
"""

from .lockorder import LockOrderRecorder, LockOrderViolation  # noqa: F401
