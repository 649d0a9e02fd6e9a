"""PyTorch port ↔ JAX reference: the sender-scan deliver shapes.

The port's round with deliver_shape="lanes" and "merged" (on the CPU,
plain forms) and the JAX round of the same shape step in lockstep from
the same state with the same host inputs; after every round every
BatchedState field, the outbox and the routed inbox are equal in value
and dtype (tests/test_torch_step.py's Lockstep). The port must equal
JAX per shape: under pre-vote a mid-lane depose can make the shapes
differ from each other, so agreeing with the vectorized shape is not
enough.

* test_deliver_shapes' three schedules (contested elections, torn-tail
  repair, ReadIndex) and test_differential's two at their config (G=2,
  R=3, W=64, E=16, P=4, no timer elections);
* the sender operands of the scan.

tests/test_torch_shapes_load.py holds the pre-vote/check-quorum config,
the bench engine and the chaos cells.
"""

import pytest
import torch

from etcd_tpu_torch.batched import MultiRaftEngine
from etcd_tpu_torch.batched.state import BatchedConfig
from etcd_tpu_torch.tools.shadow_lockstep import SCHEDULES

from .test_torch_step import DIFF, Lockstep

R = 3
SCAN_SHAPES = ("lanes", "merged")


@pytest.mark.parametrize("name", sorted(SCHEDULES))
@pytest.mark.parametrize("shape", SCAN_SHAPES)
def test_shape_matches_jax(shape, name):
    ls = Lockstep(dict(DIFF, deliver_shape=shape)).run(SCHEDULES[name])
    assert ls.rounds == len(SCHEDULES[name])
    assert (ls.tst.role == 2).any(), "no leader"


def test_sender_operands_are_int32_and_made_once():
    """The scan shapes hand each handler its sender slot as an [N] int32
    tensor made with the round (a Python int would widen _term_gate's
    lead to int64; a tensor made inside the round is a host-to-device
    copy, which a capture refuses)."""
    from etcd_tpu_torch.batched import step as tstep

    seen = []
    real = tstep._lane_vote

    def spy(cfg, ids, st, m, from_slot):
        seen.append(from_slot)
        return real(cfg, ids, st, m, from_slot)

    handlers = tstep._LANE_HANDLERS
    tstep._LANE_HANDLERS = (spy,) + handlers[1:]
    try:
        cfg = BatchedConfig(**dict(DIFF, deliver_shape="lanes"))
        eng = MultiRaftEngine(cfg, device="cpu")
        eng.step_round()
        eng.step_round()
    finally:
        tstep._LANE_HANDLERS = handlers
    assert len(seen) == 2 * R
    assert all(s.dtype == torch.int32 and s.shape == (6,) for s in seen)
    assert [int(s[0]) for s in seen[:R]] == list(range(R))
    # The same R tensors in both rounds.
    assert all(a is b for a, b in zip(seen[:R], seen[R:]))
