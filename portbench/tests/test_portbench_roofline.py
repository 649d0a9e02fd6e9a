"""The frozen yardstick equals the port's own arithmetic on seeded
inputs (the test may import the port; the harness does not)."""

import pytest
import torch

from etcd_tpu_torch.batched import hopper_kernels as hk
from etcd_tpu_torch.tools import kernel_times as kt
from portbench import roofline


def _forms(n, r, w, e):
    gen = torch.Generator().manual_seed(kt.SEED)
    match, voter, voter_out, in_joint, votes = kt.quorum_inputs(
        n, r, gen, "cpu")
    prefix = torch.rand((n, r, r), generator=gen) < 0.5
    tally = torch.where(prefix, 1, -1).to(torch.int32).view(-1, r)
    q = "quorum_commit_vote"
    forms = [(f"{q} commit R={r} B=1", (match, voter, voter_out, in_joint)),
             (f"{q} vote R={r} B=1", (votes, voter, voter_out, in_joint)),
             (f"{q} both R={r} B=1",
              (match, voter, voter_out, in_joint, votes)),
             (f"{q} vote R={r} B={r}",
              (tally, voter, voter_out, in_joint, r))]
    for k in (1, r, e, r * e):
        forms.append((f"term_at_batch K={k} W={w}",
                      kt.term_inputs(n, w, k, gen, "cpu")))
    return forms


@pytest.mark.parametrize("r", [3, 5])
def test_form_cost_and_bound_equal_the_ports(r):
    for key, args in _forms(4096, r, 32, 4):
        assert roofline.form_cost(key, args) == kt.form_cost(key, args), key
        cost = roofline.form_cost(key, args)
        assert roofline.bound_ms(*cost) == kt.bound_ms(*cost)
    assert roofline.HBM_BYTES_PER_S == kt.HBM_BYTES_PER_S
    assert roofline.OPS_PER_S == kt.OPS_PER_S


def test_spy_sees_every_launch_of_a_round_by_its_form():
    from etcd_tpu_torch.batched import BatchedConfig, MultiRaftEngine

    cfg = BatchedConfig(num_groups=8, num_replicas=3, window=32,
                        max_ents_per_msg=4, max_props_per_round=2,
                        pre_vote=True, check_quorum=True, auto_compact=True)
    eng = MultiRaftEngine(cfg, device="cpu")
    hk.reset_launches()
    eng.step_round(tick=True)
    counted = dict(hk.FORM_LAUNCHES)
    forms, bound = roofline.spy_bounds(hk, lambda: eng.step_round(tick=True))
    # On the CPU the wrappers run their plain forms and count nothing;
    # the spy still sees each call, named as the CUDA launches are.
    assert counted == {}
    assert sum(forms.values()) > 0 and bound > 0
    assert all(k.startswith(("quorum_commit_vote ", "term_at_batch "))
               for k in forms)
