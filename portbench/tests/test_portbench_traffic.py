"""Traffic mixes are data: each names its generator, found by name in
portbench/generators/, and a key that the generator does not read fails
the mix instead of running other traffic."""

import pytest
import torch

from portbench import spec, traffic


def _make(params, seconds=1.0):
    return traffic.make(params, 4, seconds, torch.Generator().manual_seed(1),
                        "cpu")


@pytest.mark.parametrize("mix", sorted(
    p.stem for p in (spec.HERE / "traffic").glob("*.json")))
def test_every_mix_names_a_generator_that_reads_all_its_keys(mix):
    import json

    with open(spec.HERE / "traffic" / f"{mix}.json") as f:
        params = json.load(f)
    mod = traffic.generator(params["generator"])
    assert set(params) <= set(traffic.LOOP_KEYS) | set(mod.PARAMS)


def test_an_unread_key_fails_the_mix():
    with pytest.raises(ValueError, match="zipf_s"):
        _make({"generator": "poisson", "rate_per_s": 10.0, "zipf_s": 0.99})


def test_an_unknown_generator_fails_the_mix():
    with pytest.raises(ValueError, match="no traffic generator"):
        _make({"generator": "zipf", "rate_per_s": 10.0})


def test_the_open_schedule_is_the_seeds():
    a = _make({"generator": "poisson", "rate_per_s": 40.0})
    b = _make({"generator": "poisson", "rate_per_s": 40.0})
    assert torch.equal(a.due, b.due) and a.clients == 0
    c = _make({"generator": "closed", "clients_per_group": 8})
    assert c.due is None and c.clients == 8
