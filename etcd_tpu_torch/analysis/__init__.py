"""Static analysis and runtime sentinels for the port's hot path (ports
``etcd_tpu/analysis``).

Three planes, one goal — keep the graphed round free of host syncs, the
dtypes disciplined and the captures bounded, mechanically:

* ``jitlint``   — AST lint passes over graph-reachable code (pure
  stdlib, no torch import): tensor control flow, host syncs and
  host-to-device copies inside the captured round, narrow-lane
  arithmetic before the mandated widen-at-entry, banned impurities,
  dict-order-dependent graph keys, and per-item device syncs inside host
  loops. CLI: ``python -m etcd_tpu_torch.analysis.jitlint``.
* ``sentinels`` — runtime guards: PyTorch's sync debug mode around the
  warm round dispatch (ETCD_TPU_TRANSFER_GUARD=disallow) and a
  recompile sentinel counting distinct round programs and CUDA-graph
  captures per session, with a capture budget for steady loops.
* ``lockorder`` — an instrumented ``threading.Lock`` recorder that
  builds the cross-thread acquisition graph (drain/pump/sender lanes)
  and fails on cycles; a copy of the JAX package's, stdlib only.

Everything here is import-light: ``jitlint``/``lockorder`` never import
torch; ``sentinels`` imports it lazily so the lint CLI runs anywhere.
"""

from .jitlint import (  # noqa: F401
    Finding,
    RULES,
    lint_file,
    lint_paths,
    lint_source,
)
from .lockorder import LockOrderRecorder, LockOrderViolation  # noqa: F401
from .sentinels import (  # noqa: F401
    CompileBudget,
    RecompileBudgetExceeded,
    distinct_shapes,
    note_compile_key,
    reset_compile_tracking,
    round_guard,
    transfer_guard_mode,
)
