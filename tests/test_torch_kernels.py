"""PyTorch port ↔ JAX reference: the replica-axis and ring reductions.

* Every plain form in etcd_tpu_torch/batched/kernels.py against
  jax.vmap of its etcd_tpu/batched/kernels.py counterpart, on seeded
  inputs and edge cases (empty config, joint halves, an index at the
  snapshot floor, outside (snap_index, last], negative, ring wrap, a
  ring write of K == W entries).
* The plain versions beside the Hopper kernels
  (etcd_tpu_torch/batched/hopper_kernels.py) against the Pallas kernels
  they replace, run in interpret mode, on the cases of
  tests/batched/test_pallas_kernels.py.
* The wrappers on CPU tensors run their plain versions (the kernels on
  the card: tests/test_torch_cuda.py).

All values are int32/bool: every comparison is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etcd_tpu.batched import kernels as jk
from etcd_tpu.batched import pallas_kernels as pk
from etcd_tpu_torch.batched import hopper_kernels as hk
from etcd_tpu_torch.batched import kernels as tk


def same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    g = got.cpu().numpy()
    assert g.dtype == want.dtype, (g.dtype, want.dtype)
    assert g.shape == want.shape, (g.shape, want.shape)
    assert np.array_equal(g, want), f"\n{g}\nvs\n{want}"


def t(x) -> torch.Tensor:
    return torch.as_tensor(np.array(x))


def quorum_case(n: int, r: int, seed: int):
    """Seeded [N, R] inputs with empty-config and joint edge rows."""
    rng = np.random.RandomState(seed)
    match = rng.randint(0, 50, size=(n, r)).astype(np.int32)
    voter = rng.rand(n, r) < 0.8
    voter_out = rng.rand(n, r) < 0.4
    in_joint = rng.rand(n) < 0.5
    votes = rng.randint(-1, 2, size=(n, r)).astype(np.int32)
    voter[0], in_joint[0] = False, False          # empty config
    voter[1], voter_out[1], in_joint[1] = False, False, True  # empty joint
    voter[2], in_joint[2] = True, True            # joint, full incoming
    return match, voter, voter_out, in_joint, votes


def ring_case(n: int, w: int, k: int, seed: int):
    """Seeded term rings with indexes below, at, inside and above each
    ring; the ring has wrapped (snap_index spans many windows)."""
    rng = np.random.RandomState(seed)
    log = rng.randint(1, 9, size=(n, w)).astype(np.int32)
    snap_index = rng.randint(0, 100, size=n).astype(np.int32)
    snap_term = rng.randint(1, 9, size=n).astype(np.int32)
    last = (snap_index + rng.randint(0, w + 1, size=n)).astype(np.int32)
    idx = (snap_index[:, None]
           + rng.randint(-3, w + 3, size=(n, k))).astype(np.int32)
    idx[0] = snap_index[0]        # at the floor
    idx[1] = snap_index[1] - 1    # below it
    idx[2] = last[2] + 1          # above last
    idx[3] = -4                   # negative
    snap_index[4], last[4], idx[4] = -6, 1, -2  # negative, inside
    return log, snap_index, snap_term, last, idx


# -- plain forms vs jax.vmap of the JAX forms ----------------------------------


@pytest.mark.parametrize("r", [1, 3, 5, 8])
def test_quorum_forms_match(r):
    match, voter, voter_out, in_joint, votes = quorum_case(300, r, 10 + r)
    same(tk.quorum_committed(t(match), t(voter)),
         jax.vmap(jk.quorum_committed)(match, voter))
    same(tk.vote_result(t(votes), t(voter)),
         jax.vmap(jk.vote_result)(votes, voter))
    same(tk.joint_committed(t(match), t(voter), t(voter_out), t(in_joint)),
         jax.vmap(jk.joint_committed)(match, voter, voter_out, in_joint))
    same(tk.joint_vote_result(t(votes), t(voter), t(voter_out), t(in_joint)),
         jax.vmap(jk.joint_vote_result)(votes, voter, voter_out, in_joint))


def test_joint_vote_result_batched_tallies_match():
    """[N, B, R] tallies sharing one instance's masks — the heartbeat
    ack-prefix form of the round (an inner vmap in the JAX round)."""
    match, voter, voter_out, in_joint, _ = quorum_case(200, 3, 3)
    rng = np.random.RandomState(4)
    votes = rng.randint(-1, 2, size=(200, 3, 3)).astype(np.int32)
    want = jax.vmap(
        lambda v, a, b, j: jax.vmap(
            lambda vv: jk.joint_vote_result(vv, a, b, j))(v)
    )(votes, voter, voter_out, in_joint)
    same(tk.joint_vote_result(t(votes), t(voter), t(voter_out),
                              t(in_joint)), want)


@pytest.mark.parametrize("tallies", [1, 3, 5])
def test_joint_vote_result_plain_tallies_match_jax(tallies):
    """The tallies contract of the plain form (votes [N*B, R], the masks
    [N, R] / [N] unexpanded), against JAX's joint_vote_result mapped over
    each instance's B tallies; B = R = 3 is the heartbeat-response
    lane's [N, R, R] ack prefixes."""
    _, voter, voter_out, in_joint, _ = quorum_case(150, 3, 20 + tallies)
    rng = np.random.RandomState(tallies)
    votes = rng.randint(-1, 2, size=(150, tallies, 3)).astype(np.int32)
    want = jax.vmap(
        lambda v, a, b, j: jax.vmap(
            lambda vv: jk.joint_vote_result(vv, a, b, j))(v)
    )(votes, voter, voter_out, in_joint)
    masks = [t(x) for x in (voter, voter_out, in_joint)]
    flat = t(votes).view(-1, 3)
    got = tk.joint_vote_result_plain(flat, *masks, tallies)
    same(got.view(150, tallies), want)
    same(hk.quorum_vote(flat, *masks, tallies).view(150, tallies), want)


@pytest.mark.parametrize("shape", [(), (5,), (3, 4)])
def test_term_at_matches(shape):
    k = int(np.prod(shape)) if shape else 1
    log, si, st, last, idx = ring_case(120, 16, k, 7)
    idx = idx.reshape((120,) + shape)
    want = jax.vmap(jk.term_at)(log, si, st, last, idx)
    same(tk.term_at(t(log), t(si), t(st), t(last), t(idx)), want)


@pytest.mark.parametrize("k", [0, 4])
def test_find_conflict_by_term_matches(k):
    rng = np.random.RandomState(11 + k)
    n, w = 150, 16
    # Nondecreasing terms along the log, as the protocol keeps them.
    snap_index = rng.randint(0, 60, size=n).astype(np.int32)
    snap_term = rng.randint(0, 4, size=n).astype(np.int32)
    last = (snap_index + rng.randint(0, w + 1, size=n)).astype(np.int32)
    log = np.zeros((n, w), np.int32)
    for i in range(n):
        terms = snap_term[i] + np.cumsum(rng.rand(w) < 0.3)
        for j, idx in enumerate(range(snap_index[i] + 1,
                                      snap_index[i] + w + 1)):
            log[i, idx % w] = terms[j]
    shape = (n, k) if k else (n,)
    index = (snap_index.reshape(-1, 1) if k else snap_index).astype(
        np.int32) + rng.randint(-2, w + 3, size=shape).astype(np.int32)
    term = rng.randint(0, 8, size=shape).astype(np.int32)
    fn = jk.find_conflict_by_term
    if k:
        want = jax.vmap(lambda lg, a, b, c, ix, tm: jax.vmap(
            lambda x, y: fn(lg, a, b, c, x, y))(ix, tm))(
            log, snap_index, snap_term, last, index, term)
    else:
        want = jax.vmap(fn)(log, snap_index, snap_term, last, index, term)
    same(tk.find_conflict_by_term(t(log), t(snap_index), t(snap_term),
                                  t(last), t(index), t(term)), want)


@pytest.mark.parametrize("k", [3, 16])
def test_ring_writes_match(k):
    """Masked and counted ring writes, with start positions that wrap
    the ring; k == W rewrites the whole ring."""
    rng = np.random.RandomState(k)
    n, w = 90, 16
    log = rng.randint(1, 9, size=(n, w)).astype(np.int32)
    start = rng.randint(0, 200, size=n).astype(np.int32)
    terms = rng.randint(10, 20, size=(n, k)).astype(np.int32)
    mask = rng.rand(n, k) < 0.6
    count = rng.randint(0, k + 1, size=n).astype(np.int32)
    same(tk.ring_write_masked(t(log), t(start), t(terms), t(mask)),
         jax.vmap(jk.ring_write_masked)(log, start, terms, mask))
    same(tk.ring_write(t(log), t(start), t(terms), t(count)),
         jax.vmap(jk.ring_write)(log, start, terms, count))


def test_ring_write_rejects_batch_wider_than_window():
    log = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="exceeds window"):
        tk.ring_write_masked(log, torch.zeros(2, dtype=torch.int32),
                             torch.zeros((2, 5), dtype=torch.int32),
                             torch.ones((2, 5), dtype=torch.bool))


# -- the kernels' plain versions vs the Pallas kernels (interpret) ---------------


@pytest.mark.parametrize("r", [1, 3, 5, 7])
def test_quorum_commit_vote_ref_matches_pallas(r):
    n = 700  # not a multiple of the Pallas tile
    match, voter, voter_out, in_joint, votes = quorum_case(n, r, 42 + r)
    want_c, want_v = pk.quorum_commit_vote(
        jnp.asarray(match), jnp.asarray(voter), jnp.asarray(voter_out),
        jnp.asarray(in_joint), jnp.asarray(votes), interpret=True)
    args = [t(x) for x in (match, voter, voter_out, in_joint, votes)]
    got_c, got_v = hk.quorum_commit_vote_ref(*args)
    same(got_c, want_c)
    same(got_v, want_v)
    same(hk.quorum_commit_ref(*args[:4]), want_c)
    same(hk.quorum_vote_ref(args[4], *args[1:4]), want_v)


def test_quorum_empty_config_commits_everything():
    n, r = 8, 3
    voter = torch.zeros((n, r), dtype=torch.bool)
    commit, vres = hk.quorum_commit_vote_ref(
        torch.zeros((n, r), dtype=torch.int32), voter, voter,
        torch.zeros(n, dtype=torch.bool),
        torch.full((n, r), -1, dtype=torch.int32))
    assert (commit == tk.MAX_I32).all()
    assert (vres == tk.VOTE_WON).all()


def test_term_at_batch_ref_matches_pallas():
    log, si, st, last, idx = ring_case(600, 32, 1, 7)
    idx = idx[:, 0]
    want = pk.term_at_batch(jnp.asarray(log), jnp.asarray(si),
                            jnp.asarray(st), jnp.asarray(last),
                            jnp.asarray(idx), interpret=True)
    same(hk.term_at_batch_ref(t(log), t(si), t(st), t(last), t(idx)), want)


def test_term_at_batch_ref_batched_indexes_match_xla():
    """The [N, K] index form (the round's batched term sites) against
    the XLA form kernels.term_at."""
    log, si, st, last, idx = ring_case(300, 32, 12, 9)
    want = jax.vmap(jk.term_at)(log, si, st, last, idx)
    same(hk.term_at_batch_ref(t(log), t(si), t(st), t(last), t(idx)), want)


# -- the wrappers ----------------------------------------------------------------


def test_wrappers_on_cpu_tensors_run_the_plain_versions():
    # One plain form per kernel: the wrappers' plain versions are the
    # plain forms that the round's kernel sites fall back to.
    assert hk.quorum_commit_ref is tk.joint_committed_plain
    assert hk.quorum_vote_ref is tk.joint_vote_result_plain
    assert hk.term_at_batch_ref is tk.term_at_plain
    hk.reset_launches()
    match, voter, voter_out, in_joint, votes = (
        t(x) for x in quorum_case(64, 3, 1))
    c, v = hk.quorum_commit_vote(match, voter, voter_out, in_joint, votes)
    rc, rv = hk.quorum_commit_vote_ref(match, voter, voter_out, in_joint,
                                       votes)
    assert torch.equal(c, rc) and torch.equal(v, rv)
    assert torch.equal(hk.quorum_commit(match, voter, voter_out, in_joint),
                       rc)
    assert torch.equal(hk.quorum_vote(votes, voter, voter_out, in_joint), rv)
    args = [t(x) for x in ring_case(64, 16, 3, 2)]
    assert torch.equal(hk.term_at_batch(*args), hk.term_at_batch_ref(*args))
    # No kernel ran, so nothing was counted.
    assert hk.LAUNCHES == {"quorum_commit_vote": 0, "term_at_batch": 0}
    assert not hk.FORM_LAUNCHES


@pytest.mark.parametrize("label", ["bench", "prevote_cq"])
def test_round_sites_pass_contiguous_arguments(monkeypatch, label):
    """The site functions hand their arguments to the wrappers without
    a copy, and a wrapper on the card raises on a strided tensor: every
    argument that reaches a wrapper over 40 rounds of a seeded schedule
    (elections, proposals, a partition, reads, transfers) is
    contiguous, in both parity configs of chip_smoke.py."""
    from etcd_tpu_torch.batched.state import BatchedConfig, init_state
    from etcd_tpu_torch.batched.step import (
        NUM_KINDS, empty_msgs, make_step_round, route)
    from etcd_tpu_torch.tools.benchlib import bench_config

    calls = {}

    def checked(name):
        wrapper = getattr(hk, name)

        def call(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            for j, x in enumerate(args):
                if isinstance(x, torch.Tensor):
                    assert x.is_contiguous(), f"{name} argument {j}"
            return wrapper(*args, **kw)
        monkeypatch.setattr(hk, name, call)

    for name in ("quorum_commit", "quorum_vote", "term_at_batch"):
        checked(name)
    cfg = bench_config(8) if label == "bench" else BatchedConfig(
        num_groups=8, num_replicas=3, window=16, max_ents_per_msg=4,
        max_props_per_round=4, election_timeout=10, heartbeat_timeout=1,
        pre_vote=True, check_quorum=True, auto_compact=True)
    n = cfg.num_instances
    cpu = torch.device("cpu")
    st = init_state(cfg, device=cpu)
    inbox = empty_msgs((n, 3, NUM_KINDS), cfg.max_ents_per_msg, device=cpu)
    step = make_step_round(cfg, device=cpu)
    gen = torch.Generator().manual_seed(3)
    for rnd in range(40):
        iso = torch.zeros(n, dtype=torch.bool)
        if 20 <= rnd < 30:
            iso[rnd % 3::7] = True
        st, out = step(
            st, inbox, torch.full((n,), rnd % 2 == 0 or label != "bench"),
            torch.rand(n, generator=gen) < (0.3 if rnd < 3 else 0.01),
            torch.randint(0, cfg.max_props_per_round + 1, (n,),
                          generator=gen, dtype=torch.int32),
            iso, torch.where(torch.rand(n, generator=gen) < 0.05,
                             torch.randint(1, 4, (n,), generator=gen,
                                           dtype=torch.int32), 0),
            torch.rand(n, generator=gen) < 0.05)
        inbox = route(cfg, out)
    assert int(st.commit.max()) > 0
    assert calls["quorum_commit"] and calls["quorum_vote"]
    assert calls["term_at_batch"]


@pytest.mark.parametrize("bad, err", [
    (torch.zeros((4, 3), dtype=torch.int64), TypeError),
    (torch.zeros((4, 2), dtype=torch.int32), ValueError),
    (torch.zeros((3, 4), dtype=torch.int32).t(), ValueError),
])
def test_argument_check_raises(bad, err):
    with pytest.raises(err):
        hk._check("x", bad, torch.int32, (4, 3), torch.device("cpu"))


def test_kernel_times_forms_of_a_checkout(monkeypatch):
    """tools/kernel_times loads a checkout's site functions under another
    package name, as its A/B of two checkouts does, and every main-path
    form (the keys hopper_kernels.FORM_LAUNCHES counts) gives what this
    checkout's plain forms give; on CPU tensors, at a small G."""
    from pathlib import Path

    from etcd_tpu_torch.tools import kernel_times as kt

    monkeypatch.setattr(kt, "GROUPS", 8)
    root = Path(kt.__file__).resolve().parents[2]
    k, hk_tree = kt._load_tree(root)
    assert k.__name__ == "ab_tree.batched.kernels"
    forms = kt.main_path_forms(torch.device("cpu"), k, hk_tree)
    assert [f["key"] for f in forms] == [
        "quorum_commit_vote commit R=3 B=1", "quorum_commit_vote vote R=3 B=1",
        "quorum_commit_vote both R=3 B=1", "quorum_commit_vote vote R=3 B=3",
        "term_at_batch K=1 W=32", "term_at_batch K=3 W=32",
        "term_at_batch K=4 W=32", "term_at_batch K=12 W=32"]
    for f in forms:
        got, want = f["call"](), f["plain"]()
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        assert all(map(torch.equal, got, want)), f["key"]
        assert f["bytes"] > 0 and f["ops"] > 0
