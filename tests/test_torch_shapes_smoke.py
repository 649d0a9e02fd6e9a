"""chip_smoke's shapes and shadow phases, rehearsed on the CPU.

The card's checks at a small width, with chip_smoke.smi stubbed and the
CPU wrappers counting their plain calls as launches (on the CPU the
plain forms run and count nothing): the three deliver shapes agree
field for field through a seeded loaded schedule, each shape's kernel
forms equal their plain versions on the round's inputs, both kernels
launch under every shape at the rates the code fixes, the scan shapes'
graph-vs-eager check runs (eager on both sides here), and the engine
equals the shadow cluster for every shape and schedule.
"""

import pytest
import torch

import chip_smoke
from etcd_tpu_torch.batched import hopper_kernels as hk

CPU = torch.device("cpu")


@pytest.fixture
def counting(monkeypatch):
    monkeypatch.setattr(chip_smoke, "smi", lambda _q: "cpu")
    for fn, name in (("quorum_commit_vote", "quorum_commit_vote"),
                     ("quorum_commit", "quorum_commit_vote"),
                     ("quorum_vote", "quorum_commit_vote"),
                     ("term_at_batch", "term_at_batch")):
        def counted(*a, _f=getattr(hk, fn), _n=name, **kw):
            hk.LAUNCHES[_n] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(hk, fn, counted)


def test_shapes_phase_on_the_cpu(counting):
    out = chip_smoke.run_shapes(CPU, groups=16)
    per_round = {path: {k: v / p["rounds"] for k, v in p["launches"].items()}
                 for path, p in out.items()}
    # Every handler runs every round: the counts are fixed by the code.
    scan = {"quorum_commit_vote": 25.0, "term_at_batch": 34.0}
    assert per_round == {"shapes_lanes": scan, "shapes_merged": scan,
                         "shapes_vectorized": {"quorum_commit_vote": 11.0,
                                               "term_at_batch": 16.0}}


def test_shadow_phase_on_the_cpu(counting):
    hk.reset_launches()
    chip_smoke.run_shadow(CPU, groups=4)
    assert min(hk.LAUNCHES.values()) > 0
