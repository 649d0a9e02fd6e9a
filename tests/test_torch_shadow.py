"""The port's engine against the port's shadow cluster, every deliver
shape: no JAX on either side.

etcd_tpu_torch/tools/shadow_lockstep.py steps a MultiRaftEngine (on the
CPU) and one ShadowCluster per group (the port's scalar raft core,
replaying the engine's deliver order) through one schedule; after every
round each instance's (term, role, lead, commit, last) equals its
replica's, and at the end every log term.

* test_differential's and test_deliver_shapes' schedules (election and
  replication, a partitioned leader's torn tail, contested elections,
  ReadIndex) at their config, and one of them widened to G=64;
* test_differential_wide's cells: timer elections, a split vote, a
  timer failover, an asymmetric link cut, a snapshot catch-up under
  auto-compaction. Its random soaks are in
  tests/test_torch_shadow_soak*.py.
"""

import numpy as np
import pytest

from etcd_tpu_torch.batched.state import LEADER
from etcd_tpu_torch.tools.shadow_lockstep import (
    R,
    SCHEDULES,
    SHAPES,
    Pair,
    diff_config,
    wide_config,
    widen,
)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
@pytest.mark.parametrize("shape", SHAPES)
def test_schedule_lockstep(shape, name):
    pair = Pair(diff_config(2, shape), device="cpu").run(SCHEDULES[name])
    pair.compare_logs()
    assert (pair.eng.state.role == LEADER).any()


@pytest.mark.parametrize("shape", SHAPES)
def test_contested_elections_at_g64(shape):
    pair = Pair(diff_config(64, shape), device="cpu")
    pair.run(widen(SCHEDULES["contested_elections"], 64))
    pair.compare_logs()
    assert int((pair.eng.state.role == LEADER).sum()) == 64


def roles(pair):
    return pair.eng.state.role.numpy()


@pytest.mark.parametrize("shape", SHAPES)
def test_randomized_election(shape):
    """No explicit campaigns: the deterministic-timeout hash drives
    elections on identical rounds in both engines."""
    pair = Pair(wide_config(election_timeout=8, shape=shape), device="cpu")
    for _ in range(40):
        pair.step(tick=True)
    assert (roles(pair) == LEADER).any(), "no timer election in 40 rounds"


@pytest.mark.parametrize("shape", SHAPES)
def test_split_vote_and_reelection(shape):
    pair = Pair(wide_config(groups=4, election_timeout=4, shape=shape),
                device="cpu")
    for _ in range(60):
        pair.step(tick=True)
    pair.compare_logs()


@pytest.mark.parametrize("shape", SHAPES)
def test_disrupted_leader_reelection(shape):
    """Isolate the timer-elected leader until another member times out
    and takes over."""
    pair = Pair(wide_config(election_timeout=6, shape=shape), device="cpu")
    for _ in range(30):
        pair.step(tick=True)
        if (roles(pair) == LEADER).any():
            break
    lead = int(np.argmax(roles(pair) == LEADER))
    for _ in range(40):
        pair.step(tick=True, isolate=[(0, lead)])
    assert any(roles(pair)[i] == LEADER for i in range(R) if i != lead)


@pytest.mark.parametrize("shape", SHAPES)
def test_asymmetric_link_loss(shape):
    """The leader→follower 2 edge cut (not the reverse); the leader
    commits through follower 1, then 2 catches up on heal."""
    pair = Pair(wide_config(election_timeout=1 << 20, shape=shape),
                device="cpu")
    pair.step(campaign=[(0, 0)])
    for _ in range(4):
        pair.step()
    for rnd in range(10):
        pair.step(propose={(0, 0): 2} if rnd == 1 else None,
                  drop_pairs=[(0, 2)])
    commit = pair.eng.state.commit
    assert int(commit[0]) > int(commit[2])
    for _ in range(10):
        pair.step(tick=True)
    assert int(commit[2]) == int(commit[0])


@pytest.mark.parametrize("shape", SHAPES)
def test_window_overflow_snapshot(shape):
    """Auto-compaction passes a dark follower's log; on heal it catches
    up through the snapshot path on both sides."""
    pair = Pair(wide_config(election_timeout=1 << 20, window=16,
                            auto_compact=True, shape=shape), device="cpu")
    pair.step(campaign=[(0, 0)])
    for _ in range(4):
        pair.step()
    for _ in range(14):
        pair.step(tick=True, propose={(0, 0): 2}, isolate=[(0, 2)])
    st = pair.eng.state
    assert int(st.snap_index[0]) > int(st.last[2])
    for _ in range(16):
        pair.step(tick=True)
    assert int(st.commit[2]) == int(st.commit[0])
    assert int(st.snap_index[2]) > 0
    pair.compare_logs()
