"""test_differential_wide's random soaks on the port: the engine against
the shadow cluster for 300 rounds of timer elections, isolation windows
and proposals under auto-compaction, every round compared, with the
lanes and vectorized shapes (tests/test_torch_shadow_soak_merged.py has
the merged shape; each file stays under a worker's time budget)."""

import pytest

from etcd_tpu_torch.tools.shadow_lockstep import soak


@pytest.mark.parametrize("seed", [3, 11, 42])
@pytest.mark.parametrize("shape", ["lanes", "vectorized"])
def test_long_random_soak(shape, seed):
    pair = soak(shape, seed, device="cpu")
    assert int(pair.eng.state.commit.max()) > 5
