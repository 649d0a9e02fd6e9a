"""Data-driven interaction-trace harness (ref: raft/rafttest/).

Ports ``etcd_tpu/rafttest/__init__.py``: the same names. The scripts in
``testdata/`` (one per subject of the reference's raft/testdata traces,
written for this repository, each expected block the JAX package's
``InteractionEnv`` output) replay through the port's scalar core
(``InteractionEnv``, compared byte for byte) and through the port's
batched node (``batched_env.BatchedInteractionEnv``, compared state for
state with the scalar core after every directive).
"""

from .datadriven import TestData, CmdArg, parse_file, run_file  # noqa: F401
from .interaction import InteractionEnv, RedirectLogger  # noqa: F401
