"""test_differential_wide's random soaks on the port with the merged
shape (tests/test_torch_shadow_soak.py has the other two)."""

import pytest

from etcd_tpu_torch.tools.shadow_lockstep import soak


@pytest.mark.parametrize("seed", [3, 11, 42])
def test_long_random_soak_merged(seed):
    pair = soak("merged", seed, device="cpu")
    assert int(pair.eng.state.commit.max()) > 5
