"""chip_smoke's interaction phase, rehearsed on the CPU.

``run_interaction`` with both of its batched envs on the CPU: every
committed script replayed beside the port's scalar env, the scalar text
against the expected blocks, no state divergence, the two batched envs
equal after every directive, and every kernel form the nodes launched
held against its plain version on every distinct input. On the CPU the
wrappers run their plain versions and count no launch; here they are
made to count per form, as the kernels do on the card, so the phase's
launch checks run too (both envs count, so a node round shows twice the
card's launches). ``nvidia-smi`` is stubbed.
"""

import torch

import chip_smoke
from etcd_tpu_torch.batched import hopper_kernels as hk


def test_interaction_phase_on_the_cpu(monkeypatch):
    monkeypatch.setattr(chip_smoke, "smi", lambda _q: "cpu")
    for name, form in chip_smoke.PlainInputs.FORMS.items():
        kernel = "term_at_batch" if name == "term_at_batch" else (
            "quorum_commit_vote")

        def counting(*args, _plain=getattr(hk, name), _form=form,
                     _kernel=kernel):
            hk.LAUNCHES[_kernel] += 1
            hk.FORM_LAUNCHES[_form(args)] += 1
            return _plain(*args)

        monkeypatch.setattr(hk, name, counting)
    out = chip_smoke.run_interaction(torch.device("cpu"))
    assert out["rounds"] > 300
    forms = set(out["forms"])
    for r in range(1, 8):
        assert f"quorum_commit_vote commit R={r} B=1" in forms, r
        assert f"quorum_commit_vote vote R={r} B=1" in forms, r
        for k in {1, r, 8, 8 * r}:
            assert f"term_at_batch K={k} W=64" in forms, (r, k)
    assert all(v > 0 for v in out["launches"].values())
