"""The PyTorch port's CUDA kernels and round on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one. The file imports no JAX, so it runs on a machine with PyTorch for
CUDA alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(--noconftest: the suite's conftest imports JAX.)
"""

import time

import numpy as np
import pytest
import torch

import chip_smoke
from etcd_tpu_torch.batched import hopper_kernels as hk
from etcd_tpu_torch.batched import kernels as tk
from etcd_tpu_torch.batched.engine import MultiRaftEngine
from etcd_tpu_torch.batched.state import init_state
from etcd_tpu_torch.batched.step import NUM_KINDS, empty_msgs, make_step_round, route
from etcd_tpu_torch.tools.benchlib import bench_config

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def quorum_case(n, r, seed, dev, tallies=1):
    """Seeded inputs: match and votes [N*B, R], masks [N, R], in_joint
    [N], with an empty config and an empty joint config."""
    rng = np.random.RandomState(seed)
    x = [rng.randint(0, 50, size=(n * tallies, r)).astype(np.int32),
         rng.rand(n, r) < 0.8, rng.rand(n, r) < 0.4, rng.rand(n) < 0.5,
         rng.randint(-1, 2, size=(n * tallies, r)).astype(np.int32)]
    x[1][0], x[3][0] = False, False  # empty config
    x[1][1], x[2][1], x[3][1] = False, False, True  # empty joint config
    return [torch.as_tensor(a, device=dev) for a in x]


def ring_case(n, w, k, seed, dev):
    rng = np.random.RandomState(seed)
    si = rng.randint(0, 100, size=n).astype(np.int32)
    last = (si + rng.randint(0, w + 1, size=n)).astype(np.int32)
    idx = (si[:, None] + rng.randint(-3, w + 3, size=(n, k))).astype(np.int32)
    idx[0], idx[1], idx[2] = si[0], si[1] - 1, last[2] + 1
    idx[3] = -4                                 # negative
    si[4], last[4], idx[4] = -6, 1, -2          # negative, inside the ring
    x = [rng.randint(1, 9, size=(n, w)).astype(np.int32), si,
         rng.randint(1, 9, size=n).astype(np.int32), last,
         idx if k > 1 else idx[:, 0].copy()]
    return [torch.as_tensor(a, device=dev) for a in x]


def at_offset(x, off):
    """x as a contiguous slice starting `off` elements into a larger
    tensor, so the kernels meet a pointer that is not 16-byte aligned."""
    big = torch.zeros(x.numel() + off + 5, dtype=x.dtype, device=x.device)
    view = big[off:off + x.numel()].view(x.shape)
    view.copy_(x)
    return view


# R in {1, 3, 5, 7}: the compiled widths; 2, 4, 9: the runtime-R kernel.
@pytest.mark.parametrize("r", [1, 2, 3, 4, 5, 7, 9])
def test_quorum_kernel_matches_plain(dev, r):
    hk.reset_launches()
    match, voter, voter_out, in_joint, votes = quorum_case(700, r, r, dev)
    want_c, want_v = hk.quorum_commit_vote_ref(match, voter, voter_out,
                                               in_joint, votes)
    got_c, got_v = hk.quorum_commit_vote(match, voter, voter_out, in_joint,
                                         votes)
    assert torch.equal(got_c, want_c) and torch.equal(got_v, want_v)
    assert torch.equal(hk.quorum_commit(match, voter, voter_out, in_joint),
                       want_c)
    assert torch.equal(hk.quorum_vote(votes, voter, voter_out, in_joint),
                       want_v)
    assert hk.LAUNCHES["quorum_commit_vote"] == 3
    assert hk.FORM_LAUNCHES == {
        f"quorum_commit_vote {mode} R={r} B=1": 1
        for mode in ("both", "commit", "vote")}


@pytest.mark.parametrize("r", [3, 4, 7])
@pytest.mark.parametrize("off", [1, 2, 3, 5])
def test_quorum_kernel_at_an_offset(dev, r, off):
    """Inputs that start inside a larger tensor, at addresses that are
    not 16-byte aligned."""
    args = [at_offset(x, off + j)
            for j, x in enumerate(quorum_case(300, r, off, dev))]
    want = hk.quorum_commit_vote_ref(*args)
    for got in (hk.quorum_commit_vote(*args),
                (hk.quorum_commit(*args[:4]),
                 hk.quorum_vote(args[4], *args[1:4]))):
        assert all(map(torch.equal, got, want))


@pytest.mark.parametrize("r", [3, 5, 9])
@pytest.mark.parametrize("tallies", [1, 3, 5])
def test_quorum_tallies_with_unexpanded_masks(dev, r, tallies):
    match, voter, voter_out, in_joint, votes = quorum_case(
        301, r, tallies, dev, tallies)
    hk.reset_launches()
    got = hk.quorum_vote(votes, voter, voter_out, in_joint, tallies)
    assert hk.LAUNCHES["quorum_commit_vote"] == 1
    assert torch.equal(got, hk.quorum_vote_ref(votes, voter, voter_out,
                                               in_joint, tallies))
    rows = [x.repeat_interleave(tallies, 0)
            for x in (voter, voter_out, in_joint)]
    assert torch.equal(got, hk.quorum_vote_ref(votes, *rows))


def test_vote_prefix_tallies_match_plain(dev):
    """[N, R, R] tallies, as the heartbeat-response lane builds them,
    through kernels.joint_vote_result: one launch over N*R rows with the
    masks unexpanded, and no other kernel (no mask copies)."""
    from torch.profiler import ProfilerActivity, profile

    _, voter, voter_out, in_joint, _ = quorum_case(700, 3, 4, dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    votes = torch.where(torch.rand((700, 3, 3), generator=gen, device=dev)
                        < 0.5, 1, -1).to(torch.int32)
    hk.reset_launches()
    tk.joint_vote_result(votes, voter, voter_out, in_joint)  # build, load
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = tk.joint_vote_result(votes, voter, voter_out, in_joint)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1, [e.name for e in kernels]
    assert hk.FORM_LAUNCHES == {"quorum_commit_vote vote R=3 B=3": 2}
    assert torch.equal(got, tk.joint_vote_result_plain(
        votes.view(-1, 3), voter, voter_out, in_joint, 3).view(700, 3))


@pytest.mark.parametrize("k", [1, 3, 4, 12])
def test_term_kernel_matches_plain(dev, k):
    hk.reset_launches()
    args = ring_case(700, 32, k, k, dev)
    assert torch.equal(hk.term_at_batch(*args), hk.term_at_batch_ref(*args))
    assert hk.LAUNCHES["term_at_batch"] == 1
    assert hk.FORM_LAUNCHES == {f"term_at_batch K={k} W=32": 1}


# The general kernel: K and W outside the compiled set, W not a power
# of two; and the compiled K = 4, 12 with 16-byte vectors unaligned.
@pytest.mark.parametrize("k, w, off", [(5, 12, 0), (2, 32, 0), (4, 16, 0),
                                       (4, 32, 1), (12, 32, 2), (3, 32, 3)])
def test_term_kernel_other_widths_and_offsets(dev, k, w, off):
    args = [at_offset(x, off) for x in ring_case(700, w, k, 10 * k + w, dev)]
    assert torch.equal(hk.term_at_batch(*args), hk.term_at_batch_ref(*args))


def test_kernels_capture_in_a_cuda_graph(dev):
    """Each wrapper launches on the current stream, allocates nothing in
    the kernel and never syncs: captured once and replayed, it equals
    the eager call on new inputs."""
    q = quorum_case(700, 3, 7, dev, 3)
    ring = ring_case(700, 32, 12, 7, dev)
    calls = {
        "both": lambda: hk.quorum_commit_vote(q[0][:700], *q[1:4],
                                              q[4][:700]),
        "commit": lambda: (hk.quorum_commit(q[0][:700], *q[1:4]),),
        "tallies": lambda: (hk.quorum_vote(q[4], *q[1:4], 3),),
        "term": lambda: (hk.term_at_batch(*ring),),
        "term1": lambda: (hk.term_at_batch(*ring[:4], ring[4][:, 5]
                                           .contiguous()),),
    }
    for name, call in calls.items():
        call()  # build and load outside the capture
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            call()
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = call()
        # New inputs in place, then replay against an eager call.
        fresh_q = quorum_case(700, 3, 8, dev, 3)
        fresh_ring = ring_case(700, 32, 12, 8, dev)
        for x, y in zip(q + ring, fresh_q + fresh_ring):
            x.copy_(y)
        graph.replay()
        torch.cuda.synchronize()
        assert all(map(torch.equal, out, call())), name


def test_wrappers_reject_bad_arguments(dev):
    match, voter, voter_out, in_joint, votes = quorum_case(64, 3, 0, dev)
    with pytest.raises(TypeError):
        hk.quorum_commit(match.long(), voter, voter_out, in_joint)
    with pytest.raises(ValueError, match="contiguous"):
        hk.quorum_vote(votes.t().contiguous().t(), voter, voter_out,
                       in_joint)
    log, si, st, last, idx = ring_case(64, 16, 1, 0, dev)
    with pytest.raises(ValueError, match="on cpu"):
        hk.term_at_batch(log, si, st, last.cpu(), idx)


def test_round_on_cuda_equals_round_on_cpu(dev):
    """A seeded schedule (elections, proposals, a partition, reads) at
    G=8: every state field and the outbox equal after every round."""
    cfg = bench_config(8)
    n = cfg.num_instances
    sides = {}
    for d in (dev, torch.device("cpu")):
        sides[d.type] = [init_state(cfg, device=d),
                         empty_msgs((n, 3, NUM_KINDS), cfg.max_ents_per_msg,
                                    device=d),
                         make_step_round(cfg, device=d)]
    gen = torch.Generator().manual_seed(1)
    hk.reset_launches()
    for rnd in range(24):
        args = (torch.full((n,), rnd % 2 == 0),
                torch.rand(n, generator=gen) < (0.3 if rnd < 2 else 0.0),
                torch.randint(0, 3, (n,), generator=gen, dtype=torch.int32),
                torch.arange(n) % 7 == rnd % 3,
                torch.zeros(n, dtype=torch.int32),
                torch.rand(n, generator=gen) < 0.1)
        outs = {}
        for name, side in sides.items():
            st, inbox, step = side
            st, out = step(st, inbox, *(a.to(st.term.device) for a in args))
            side[0], side[1] = st, route(cfg, out)
            outs[name] = (st, out)
        for a, b in zip(outs["cuda"], outs["cpu"]):
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and torch.equal(x.cpu(), y), rnd
    assert min(hk.LAUNCHES.values()) > 0


def test_engine_defaults_to_the_gpu(dev):
    eng = MultiRaftEngine(bench_config(2))
    assert eng.state.term.is_cuda and eng.inbox.valid.is_cuda


# -- the engine's closed loop as a CUDA graph --------------------------------------


@pytest.mark.parametrize("planes", [False, True])
@pytest.mark.parametrize("config", ["bench", "prevote_cq"])
def test_graph_replays_equal_eager_rounds(dev, config, planes):
    """run_rounds through the captured graph against as many eager
    step_rounds, with campaign, set_membership, read_index and
    drain_fleet between the closed-loop calls: every buffer and plane
    equal after every call (chip_smoke.graph_vs_eager), one capture per
    tick value."""
    cfg = chip_smoke.parity_configs(64, planes)[config]
    res = chip_smoke.graph_vs_eager(cfg, dev, seed=3)
    assert res["captures"] == 2 and res["rounds"] == 44


def test_graph_replays_count_the_launches_of_an_eager_round(dev):
    cfg = chip_smoke.parity_configs(64)["bench"]
    eng = MultiRaftEngine(cfg, device=dev)
    eng.campaign(range(0, cfg.num_instances, 3))
    hk.reset_launches()
    eng.step_round(tick=True)
    eager = (dict(hk.LAUNCHES), dict(hk.FORM_LAUNCHES))
    hk.reset_launches()
    eng.run_rounds(1, tick=True)  # an eager round, then the capture
    eng.run_rounds(6, tick=True)
    assert eng.captures == 1
    assert hk.LAUNCHES == {k: 7 * v for k, v in eager[0].items()}
    assert dict(hk.FORM_LAUNCHES) == {k: 7 * v for k, v in eager[1].items()}


def test_pipelined_equals_serial_on_the_card(dev):
    cfg = chip_smoke.parity_configs(64, planes=True)["bench"]
    props = torch.zeros(cfg.num_instances, dtype=torch.int32, device=dev)
    props[::3] = 2
    engines = [MultiRaftEngine(cfg, device=dev) for _ in range(2)]
    for eng in engines:
        eng.campaign(range(0, cfg.num_instances, 3))
    engines[0].run_rounds(30, propose_n=props)
    engines[1].run_rounds_pipelined(30, chunk=4, depth=2, propose_n=props)
    torch.cuda.synchronize()
    chip_smoke.assert_engines_equal(*engines, "pipelined")
    with pytest.raises(ValueError, match="chunk"):
        engines[1].run_rounds_pipelined(3, chunk=0)


def test_one_capture_per_tick_value(dev):
    eng = MultiRaftEngine(bench_config(8), device=dev)
    for tick in (True, True, False, True, False):
        eng.run_rounds(3, tick=tick)
    assert eng.captures == 2 and len(eng.capture_stats) == 2
    assert eng.rounds == 15


def test_replays_make_no_host_sync(dev):
    cfg = chip_smoke.parity_configs(64, planes=True)["prevote_cq"]
    eng = MultiRaftEngine(cfg, device=dev)
    props = torch.ones(cfg.num_instances, dtype=torch.int32, device=dev)
    eng.run_rounds(2, propose_n=props)  # capture outside the check
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.run_rounds(10, propose_n=props)
        eng.run_rounds_pipelined(10, chunk=5, depth=4, propose_n=props)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert eng.rounds == 22


# -- the hosted rawnode on the card ---------------------------------------------


def eager_members(cfg, dev):
    """Hosted members whose round runs eagerly on the card: the graph
    runner's run replaced by direct calls of the round body."""
    rns = chip_smoke.hosted_members(cfg, dev)
    for rn in rns.values():
        rn._graphs.run = (lambda key, body, times=1, **info:
                          [body() for _ in range(times)])
    return rns


def pump(rns, cfg, rounds, start=0):
    """Rounds of chip_smoke's hosted schedule; yields each (rawnode,
    Ready) after that member's advance."""
    for rnd in range(start, start + rounds):
        chip_smoke.hosted_schedule(rnd, rns, cfg)
        for mid in chip_smoke.MEMBERS:
            rn = rns[mid]
            rd = rn.advance_round()
            chip_smoke.route(rns, rd)
            rn.advance()
            yield rn, rd


@pytest.mark.parametrize("config", ["bench", "prevote_cq", "bench_narrow"])
def test_graphed_rawnodes_equal_eager_ones(dev, config):
    """Three graphed members against three eager ones on the card, G=256,
    with chip_smoke's staged edits between rounds (membership masks,
    fence, compaction, pokes, ReadIndex, a transfer, a cut-off member
    sent MsgSnap): Ready for Ready and field for field, every round; one
    capture per graphed rawnode. bench_narrow stages int8/int16 lanes."""
    configs = chip_smoke.parity_configs(256)
    configs["bench_narrow"] = configs["bench"]._replace(narrow_lanes=True)
    cfg = configs[config]
    res = chip_smoke.hosted_lockstep(
        cfg, [chip_smoke.hosted_members(cfg, dev), eager_members(cfg, dev)],
        40, config)
    assert set(res["captures"].values()) == {1}
    assert res["snapshots_installed"] > 0 and res["leaders"] == 256


@pytest.mark.parametrize("config", ["bench", "prevote_cq"])
def test_split_rawnodes_equal_unsplit_ones(dev, config):
    """Three members whose rows are split over the card twice (two
    shards, two graphs each) against three unsplit members, G=256, 20
    rounds of chip_smoke's hosted schedule: Ready for Ready and field
    for field, every round; then every kernel form of one round of each
    shard equals its plain version."""
    cfg = chip_smoke.parity_configs(256)[config]
    split = chip_smoke.hosted_members(cfg, dev, mesh=[dev, dev])
    res = chip_smoke.hosted_lockstep(
        cfg, [chip_smoke.hosted_members(cfg, dev), split], 20,
        f"split {config}")
    assert set(res["captures"].values()) == {1}
    assert {rn.captures for rn in split.values()} == {2}
    forms = chip_smoke.shard_forms_equal_plain(split[1])
    assert len(forms) == 2
    assert all(len(f) >= 6 and set(f.values()) == {0}
               for f in forms.values())


def test_rawnode_graph_counts_the_launches_of_an_eager_round(dev):
    cfg = chip_smoke.parity_configs(64)["bench"]
    counts = []
    for rns in (eager_members(cfg, dev), chip_smoke.hosted_members(cfg, dev)):
        hk.reset_launches()
        for _ in pump(rns, cfg, 6):
            pass
        counts.append((dict(hk.LAUNCHES), dict(hk.FORM_LAUNCHES)))
    assert counts[0] == counts[1] and min(counts[0][0].values()) > 0


def test_rawnode_round_makes_one_host_sync(dev):
    """After the capture, a whole hosted round (staging, staged edits,
    the replay, the host reads, routing) runs under sync debug mode
    "error" except for each member's one wait."""
    cfg = chip_smoke.parity_configs(64, planes=True)["prevote_cq"]
    rns = chip_smoke.hosted_members(cfg, dev)
    for _ in pump(rns, cfg, 2):
        pass
    waits = []
    for rn in rns.values():
        def wait(inner=rn._wait):
            torch.cuda.set_sync_debug_mode(0)
            try:
                inner()
            finally:
                torch.cuda.set_sync_debug_mode("error")
            waits.append(1)
        rn._wait = wait
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in pump(rns, cfg, 20, start=2):
            pass
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(waits) == 20 * 3
    assert {rn.captures for rn in rns.values()} == {1}


def test_round_results_outlive_the_next_round(dev):
    """The mirrors advance() installs, a Ready's snap rings and entries,
    and the telemetry and fleet frames are the rawnode's to give away:
    the next rounds, which reuse its host buffers, leave them as they
    were. (m_snap is left out: a staged compaction raises the floor
    mirror in place at the head of the next round, as in the
    reference.)"""
    cfg = chip_smoke.parity_configs(256, planes=True)["bench"]
    rns = chip_smoke.hosted_members(cfg, dev)
    held = []
    for rn, rd in pump(rns, cfg, 36):
        keep = [rn.m_term, rn.m_vote, rn.m_commit, rn.m_last, rn.m_role,
                rn.m_lead, rn.m_ring, rn.m_lease_ticks,
                rn.last_fleet, *rn.last_frame, rd.entries.term,
                *rd.snap_rings.values()]
        held.append((keep, [x.copy() for x in keep], len(rd.snap_rings)))
    assert sum(k[2] for k in held) > 0
    for keep, copies, _ in held:
        for x, y in zip(keep, copies):
            assert np.array_equal(x, y)


def test_rawnode_defaults_to_the_gpu(dev):
    from etcd_tpu_torch.batched.rawnode import BatchedRawNode

    rn = BatchedRawNode(bench_config(4))
    assert rn.state.term.is_cuda and rn.device.type == "cuda"


# -- the raft.Node boundary and raftexample on the card --------------------------


def eager_nodes(dev):
    """A node set whose rawnodes run their rounds eagerly on the card."""
    ns = chip_smoke.NodeSet(dev)
    for n in ns.nodes.values():
        n.rn._graphs.run = (lambda key, body, times=1, **info:
                            [body() for _ in range(times)])
    return ns


def test_graphed_nodes_equal_eager_ones(dev):
    """chip_smoke's node schedule (election, forwarded puts, ReadIndex, a
    transfer, a voter removed and re-added, a compaction with a MsgSnap
    catch-up) through graphed nodes and eager nodes in lockstep: Ready
    for Ready and status for status equal; one capture per node."""
    sets = [chip_smoke.NodeSet(dev), eager_nodes(dev)]
    steps = chip_smoke.node_schedule(sets, chip_smoke.PARITY_LOAD)
    assert steps["snapshots_installed"]
    assert {n.rn.captures for n in sets[0].nodes.values()} == {1}
    assert {n.rn.captures for n in sets[1].nodes.values()} == {0}
    assert chip_smoke.check_node_set(sets[0]) == chip_smoke.check_node_set(
        sets[1])


def test_node_round_makes_one_host_sync(dev):
    """After the capture, whole node turns (ready, apply, route, advance)
    under sync debug mode "error", except for each round's one wait."""
    ns = chip_smoke.NodeSet(dev)
    chip_smoke.node_until([ns], lambda s: s.settled(), "election")
    waits = []
    for n in ns.nodes.values():
        def wait(inner=n.rn._wait):
            torch.cuda.set_sync_debug_mode(0)
            try:
                inner()
            finally:
                torch.cuda.set_sync_debug_mode("error")
            waits.append(1)
        n.rn._wait = wait
    rounds = ns.node_rounds
    torch.cuda.set_sync_debug_mode("error")
    try:
        chip_smoke.node_load([ns], np.random.RandomState(1), 20)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(waits) == ns.node_rounds - rounds == 60
    assert {n.rn.captures for n in ns.nodes.values()} == {1}


def test_node_defaults_to_the_gpu(dev):
    from etcd_tpu_torch.batched.node import BatchedNode

    n = BatchedNode(1, [1, 2, 3])
    assert n.rn.device.type == "cuda" and n.rn.state.term.is_cuda


def test_members_capture_side_by_side_in_threads(dev):
    """Three nodes, each driven by a thread of its own that starts its
    first round behind a barrier, so the three captures and then the
    replays run at the same time: no error, one capture each, and every
    put commits on every member."""
    import queue
    import threading

    from etcd_tpu_torch.batched.node import BatchedNode
    from etcd_tpu_torch.raft.types import EntryType

    nodes = {i: BatchedNode(i, [1, 2, 3], device=dev) for i in (1, 2, 3)}
    inbox = {i: queue.Queue() for i in nodes}
    applied = {i: [] for i in nodes}
    barrier = threading.Barrier(3)
    stop = threading.Event()
    errors = []

    def loop(i):
        n = nodes[i]
        try:
            barrier.wait()
            while not stop.is_set():
                while not inbox[i].empty():
                    n.step(inbox[i].get())
                n.tick()
                rd = n.ready(timeout=0.01)
                if rd is None:
                    continue
                applied[i] += [e.data for e in rd.committed_entries
                               if e.type == EntryType.EntryNormal and e.data]
                for m in rd.messages:
                    inbox[m.to].put(m)
                n.advance()
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=loop, args=(i,)) for i in nodes]
    for t in threads:
        t.start()
    puts = [b"put-%03d" % k for k in range(200)]
    try:
        deadline = time.monotonic() + 120
        lead = 0
        while not lead and time.monotonic() < deadline and not errors:
            lead = next((i for i, n in nodes.items() if n.rn.is_leader(0)), 0)
            time.sleep(0.01)
        assert lead, errors
        for p in puts:
            nodes[lead].propose(p)
        while (time.monotonic() < deadline and not errors
               and any(len(a) < len(puts) for a in applied.values())):
            time.sleep(0.01)
    finally:
        stop.set()
        for t in threads:
            t.join(30)
    assert not errors, errors
    assert all(a == puts for a in applied.values())
    assert {n.rn.captures for n in nodes.values()} == {1}


def test_no_graph_is_destroyed_during_a_capture(dev):
    """A graph's destruction is a CUDA call that a capture in any thread
    must not meet: the collector is off while a capture runs (so an
    unreachable owner in a reference cycle is not freed in the middle of
    it), and an owner dropped in another thread frees its graphs only
    once the device lock is free. Replays still run the body."""
    import gc
    import threading

    from etcd_tpu_torch.batched.graph import RoundGraphs, device_work

    x = torch.zeros(1024, device=dev)
    seen = []

    def body():
        seen.append(gc.isenabled())
        x.add_(1)

    assert gc.isenabled()
    old = RoundGraphs()
    old.run("k", body)
    assert old.captures == 1 and seen == [True, False] and gc.isenabled()
    cycle = [old]
    cycle.append(cycle)
    del old
    new = RoundGraphs()
    new.run("k", body, times=3)
    assert seen == [True, False, True, False]
    box = [new]
    del new
    with device_work():
        t = threading.Thread(target=box.clear)
        t.start()
        t.join(0.5)
        assert t.is_alive()
    t.join(10)
    assert not t.is_alive()
    del cycle
    gc.collect()
    torch.cuda.synchronize()
    assert torch.equal(x, torch.full_like(x, 4.0))


def test_plane_graphed_dispatch_equals_eager(dev):
    """The apply plane's dispatch replayed as a CUDA graph over owned
    buffers against the same dispatch run eagerly on the card, 4,096
    rows, 40 seeded dispatches: every frame and the final planes equal,
    and the sampled, armed-watch and overflowing rows equal PlaneOracle."""
    res = chip_smoke.plane_dispatch_check(dev, 4096, sample=64)
    assert res["graphed_eq_eager"] and res["overflow_rows"] >= 8


@pytest.mark.parametrize("config", ["bench", "prevote_cq"])
def test_plane_rawnodes_on_cuda_equal_cpu(dev, config):
    """Plane-on hosted members on the card against plane-on members on
    the CPU, G=64, under chip_smoke's plane schedule (KV payloads, watch
    arms, a restored row image): Readys, state, plane tensors, stats,
    events, captures, mirrors and lessor equal every member round; two
    captures (round and plane) per graphed member."""
    cfg = chip_smoke.plane_config(64, chip_smoke.parity_configs(64)[config])
    res = chip_smoke.hosted_lockstep(
        cfg, [chip_smoke.hosted_members(cfg, dev),
              chip_smoke.hosted_members(cfg, torch.device("cpu"))], 36,
        config, schedule=chip_smoke.plane_schedule,
        check=chip_smoke.assert_planes_equal)
    assert set(res["captures"].values()) == {2}


def test_plane_dispatch_beside_a_capture_in_a_thread(dev):
    """A member's rounds (each with a plane dispatch) and plane_captures
    in a thread while another member set captures its graphs: no capture
    error (the dispatch and the capture hold graph.device_work)."""
    cfg = chip_smoke.plane_config(
        64, chip_smoke.parity_configs(64)["prevote_cq"])
    res = chip_smoke.plane_beside_capture(cfg, dev)
    assert res["thread_rounds"] > 0


def test_raftexample_members_on_the_card(dev):
    """raftexample's three members on the card, each in its own threads,
    with a WAL and snapshots on disk and one member stopped and restarted
    from them (chip_smoke's raftexample phase at 300 puts): equal maps,
    one capture per rawnode."""
    chip_smoke.run_raftexample(dev, puts=300, timeout_s=120)


def test_hosting_cluster_on_the_card(dev):
    """Three MultiRaftMembers of 64 groups on the card in their own
    threads (chip_smoke's hosting phase at 300 puts): admin reads beside
    the first captures, every put read back everywhere, linearizable
    reads, a crash that frees the member's device memory and a restart
    that catches up, one capture per member, the strict checkers."""
    chip_smoke.run_hosting(dev, groups=64, puts=300, reads=16)


def test_hosting_members_on_cuda_equal_cpu(dev):
    """CUDA members against CPU members in lockstep (chip_smoke's
    hosting_parity at 16 groups): equal WAL records, KV, mirrors and
    health after every step."""
    chip_smoke.run_hosting_parity(dev, groups=16, steps=160)


def test_hosting_reads_beside_a_first_capture(dev, tmp_path):
    """ROADMAP C8: hosting's reads from other threads (health,
    conf_snapshot, stats, peer_match, the leader view, deliver_block of
    an empty block) run in a thread while each member captures its first
    round: nothing raises, one capture each, and the rounds go on."""
    import threading

    from etcd_tpu_torch.batched import hosting
    from etcd_tpu_torch.batched.msgblock import REC_DTYPE, MsgBlock
    from etcd_tpu_torch.tools.hosting_lockstep import Lockstep, step_clock

    cfg = chip_smoke.chaos_config(16)
    errors, reads, stop = [], [0], threading.Event()
    with step_clock(hosting) as clock:
        c = Lockstep(hosting, str(tmp_path), cfg, 3, 16, device=dev)

        def reader():
            try:
                while not stop.is_set():
                    for m in c.members.values():
                        m.health()
                        m.conf_snapshot()
                        dict(m.stats)
                        m.rn.peer_match()
                        int(m.rn.m_view[1].sum())
                        m.deliver_block(MsgBlock(np.zeros(0, REC_DTYPE)))
                        reads[0] += 1
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)

        t = threading.Thread(target=reader)
        t.start()
        try:
            for _ in range(40):
                c.step()
                clock.advance(0.1)
            led = [c.leader(g) is not None for g in range(16)]
        finally:
            stop.set()
            t.join(30)
            c.stop()
    assert not errors, errors
    assert reads[0] > 0
    assert {m.rn.captures for m in c.members.values()} == {1}
    assert all(led), led


@pytest.mark.parametrize("cell", ["msg_faults_shm", "fsync_failstop",
                                  "walpipe_crash_window"])
def test_chaos_cells_on_the_card(dev, cell):
    """chip_smoke's chaos cells over CUDA members, closed strict."""
    chip_smoke.run_chaos(dev, cells=[cell])


def test_worker_process_on_the_card(dev, tmp_path):
    """One port worker process (hosting_proc, one member of 64 groups,
    no --device: its default is the card) answers ping, campaign, put,
    get and stop; its launch line counts both kernels."""
    from etcd_tpu_torch.tools.proc_cluster import (
        ProcCluster, place_leaders, put_any)

    c = ProcCluster(str(tmp_path), 64, members=1)
    try:
        c.start()
        assert c.clients[1].call(op="ping")["ok"]
        place_leaders(c, lambda g: 1)
        for g in (0, 31, 63):
            put_any(c.clients, g, b"k%d" % g, b"v%d" % g)
            assert c.clients[1].get(g, b"k%d" % g) == b"v%d" % g
    finally:
        c.stop()
    (line,) = c.launch_lines()
    assert line["rounds"] > 0
    assert all(n > 0 for n in line["launches"].values()), line


def test_admin_ops_beside_first_captures(dev, tmp_path):
    """ROADMAP C8, out of process: three port workers on the card, each
    hammered with the admin 'leaders', 'conf', 'reconfig' and 'stats'
    ops from its admin's first answer until it has run rounds (its first
    capture among them); nothing errs. Then a demotion and promotion of
    member 3 through 'reconfig' lands on every group."""
    import threading

    from etcd_tpu_torch.batched.hosting_proc import ProcClient
    from etcd_tpu_torch.tools.proc_cluster import (
        ProcCluster, place_leaders, wait_until)

    g = 64
    c = ProcCluster(str(tmp_path), g)
    seen, errors = {}, []

    def hammer(mid):
        # Connect within milliseconds of the admin's bind, which comes
        # just before the member starts its first round.
        deadline = time.monotonic() + 300.0
        while True:
            try:
                cl = ProcClient(c.admin(mid))
                cl.call(op="ping")
                break
            except OSError:
                if time.monotonic() > deadline:
                    errors.append((mid, "admin never answered"))
                    return
                time.sleep(0.005)
        try:
            while True:
                st = cl.call(op="stats")
                for op in ({"op": "leaders"}, {"op": "conf"},
                           # promote reads peer_match() on the device
                           # (member 3 is a voter: nothing is proposed).
                           {"op": "reconfig", "action": "promote",
                            "member": 3, "groups": list(range(g))}):
                    r = cl.call(**op)
                    if not r.get("ok"):
                        errors.append((mid, op, r))
                rounds = st["member"]["rounds"]
                seen.setdefault(mid, set()).add(rounds > 0)
                if rounds >= 5:
                    return
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append((mid, e))
        finally:
            cl.close()

    try:
        threads = []
        for mid in c.ids:
            c.spawn(mid)
            t = threading.Thread(target=hammer, args=(mid,))
            t.start()
            threads.append(t)
        for t in threads:
            t.join(300)
        for mid in c.ids:
            c.clients[mid] = c.wait(mid, 60.0)
        assert not errors, errors
        # Every worker ran rounds while hammered; at least one answered
        # before its first round was done.
        assert all(True in s for s in seen.values()), seen
        assert any(False in s for s in seen.values()), seen
        place_leaders(c, lambda x: x % 3 + 1)
        for action, want in (("add-learner", [[3]] * g),
                             ("promote", [[]] * g)):
            def done():
                for cl in c.clients.values():
                    cl.call(op="reconfig", action=action, member=3,
                            groups=list(range(g)))
                conf = c.clients[1].call(op="conf")
                return conf["learners"] == want
            wait_until(done, f"reconfig {action}", 120.0, every=0.5)
    finally:
        c.stop()
    lines = c.launch_lines()
    assert len(lines) == 3 and all(ln["rounds"] > 0 for ln in lines), lines


# -- the sender-scan deliver shapes ------------------------------------------------


@pytest.mark.parametrize("config", ["bench", "prevote_cq"])
@pytest.mark.parametrize("shape", ["lanes", "merged"])
def test_scan_shape_on_cuda_equals_cpu(dev, shape, config):
    """Each sender scan's round on the card (its kernels at the new
    per-sender sites) equals the same round on the CPU, every state
    field and the outbox after every round of chip_smoke's parity
    schedule at G=8."""
    hk.reset_launches()
    cfg = chip_smoke.parity_configs(8)[config]._replace(deliver_shape=shape)
    chip_smoke.parity_run(cfg, config, dev, torch.device("cpu"), 40)
    assert min(hk.LAUNCHES.values()) > 0


def test_scan_graph_replays_equal_eager_rounds(dev):
    cfg = chip_smoke.parity_configs(64, planes=True)["prevote_cq"]
    res = chip_smoke.graph_vs_eager(cfg._replace(deliver_shape="lanes"),
                                    dev, seed=5)
    assert res["captures"] == 2 and res["rounds"] == 44


def test_lanes_replays_beside_a_capture_in_a_thread(dev):
    """A lanes engine replays its graph in a thread while a lanes
    rawnode makes its first captures here: both go through
    graph.device_work, so no capture breaks (ROADMAP rule 8)."""
    import threading

    from etcd_tpu_torch.batched.rawnode import BatchedRawNode

    cfg = chip_smoke.parity_configs(64)["prevote_cq"]._replace(
        deliver_shape="lanes")
    eng = MultiRaftEngine(cfg, device=dev)
    eng.campaign(range(0, cfg.num_instances, 3))
    eng.run_rounds(2, tick=True)
    stop, errors, replays = threading.Event(), [], []

    def replay():
        try:
            while not stop.is_set():
                eng.run_rounds(2, tick=True)
                replays.append(2)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    t = threading.Thread(target=replay)
    t.start()
    try:
        rns = chip_smoke.hosted_members(cfg, dev)
        rns[1].campaign(list(range(cfg.num_groups)))
        for _ in range(6):
            for rn in rns.values():
                rd = rn.advance_round()
                chip_smoke.route(rns, rd)
                rn.advance()
    finally:
        stop.set()
        t.join(60)
    assert not errors, errors
    assert replays and eng.captures == 1
    assert {rn.captures for rn in rns.values()} == {1}
    assert rns[1].is_leader(0)


def test_shadow_on_the_card(dev):
    """chip_smoke's shadow phase at 8 groups: the engine on the card
    against the port's scalar Raft, every shape and schedule."""
    hk.reset_launches()
    chip_smoke.run_shadow(dev, groups=8)
    assert min(hk.LAUNCHES.values()) > 0


def test_shapes_phase_at_a_small_width(dev):
    """chip_smoke's shapes phase at G=512: the three shapes agree, each
    shape's kernel forms equal their plain versions, and both kernels
    launch under each."""
    out = chip_smoke.run_shapes(dev, groups=512)
    assert set(out) == {"shapes_lanes", "shapes_merged", "shapes_vectorized"}
    assert all(min(p["launches"].values()) > 0 for p in out.values())


# -- the etcd server on the card ---------------------------------------------------


def _server_cluster(path, device, **kw):
    from etcd_tpu_torch.functional import Cluster

    return Cluster(str(path), n=3, device=device, snapshot_count=16,
                   snapshot_catchup_entries=4, request_timeout=25.0,
                   tick_interval=0.05, **kw)


def test_server_cluster_on_cuda_equals_cpu(dev, tmp_path):
    """Three port EtcdServers on the card and three on the CPU answer the
    same scripted stream (puts, ranges, txns, deletes, leases, a
    compaction, a watch) with equal bodies and end at the same hash_kv."""
    from etcd_tpu_torch.server import api
    from etcd_tpu_torch.tools import server_script as ss

    out = {}
    for label, d in (("cuda", dev), ("cpu", "cpu")):
        c = _server_cluster(tmp_path / label, d)
        try:
            c.wait_leader(60)
            out[label] = (ss.run(c, ss.script(api, 7, 40), watch=True),
                          ss.final_hash(c))
            if label == "cuda":
                assert {s.node.rn.device.type for s in c.alive()} == {"cuda"}
        finally:
            c.close()
    assert out["cuda"] == out["cpu"]


def test_server_node_round_is_one_graph_replay(dev, tmp_path):
    """Each member's node round on the card is one replay of its own CUDA
    graph: one capture per member, and the launches a round are the
    captured round's (B1 15, B2 16 at R = 3)."""
    from etcd_tpu_torch.server.api import PutRequest

    c = _server_cluster(tmp_path, dev)
    try:
        lead = c.wait_leader(60)
        for i in range(20):
            lead.put(PutRequest(key=b"g%d" % i, value=b"v"))
        rounds = {}
        for s in c.alive():
            ready = s.node.ready

            def counted(timeout=None, _r=ready, _id=s.id):
                rd = _r(timeout)
                if rd is not None:
                    rounds[_id] = rounds.get(_id, 0) + 1
                return rd
            s.node.ready = counted
        hk.reset_launches()
        for i in range(20):
            lead.put(PutRequest(key=b"h%d" % i, value=b"v"))
        launches = dict(hk.LAUNCHES)
        n = sum(rounds.values())
        assert {s.node.rn.captures for s in c.alive()} == {1}
        for s in c.alive():
            for _graph, made in s.node.rn._graphs._graphs.values():
                assert made["kernels"] == {"quorum_commit_vote": 15,
                                           "term_at_batch": 16}
        # Every round adds its graph's launches whole: the replays
        # counted are the rounds the members ran (a round in flight at
        # either end may fall on one side of the count).
        replays = launches["quorum_commit_vote"] // 15
        assert launches["quorum_commit_vote"] == 15 * replays
        assert launches["term_at_batch"] == 16 * replays
        assert n > 0 and abs(replays - n) <= 3, (replays, n)
    finally:
        c.close()


def test_server_restart_from_the_wal_on_the_card(dev, tmp_path):
    """A follower stopped and restarted on its WAL on the card catches
    up, captures its graph anew, and the members agree on hash_kv."""
    from etcd_tpu_torch.functional import hash_check
    from etcd_tpu_torch.server.api import PutRequest, RangeRequest

    c = _server_cluster(tmp_path, dev)
    try:
        lead = c.wait_leader(60)
        for i in range(5):
            lead.put(PutRequest(key=b"k%d" % i, value=b"v%d" % i))
        victim = c.followers()[0].id
        c.kill(victim)
        c.wait_leader(60).put(PutRequest(key=b"after", value=b"kill"))
        s = c.restart(victim)
        deadline = time.monotonic() + 60
        while not s.range(RangeRequest(key=b"after",
                                       serializable=True)).kvs:
            assert time.monotonic() < deadline, "no catch-up"
            time.sleep(0.02)
        assert s.node.rn.device.type == "cuda" and s.node.rn.captures == 1
        hash_check(c.alive())
    finally:
        c.close()


def test_server_phase_at_a_small_size(dev):
    """chip_smoke's server phase at 200 puts through 20 connections,
    snapshots every 50 entries from the 300th."""
    out = chip_smoke.run_server(dev, puts=200, clients=20, ranges=100,
                                snapshots=(300, 250))
    assert all(v > 0 for v in out["launches"].values())


def test_interaction_harness_on_the_card(dev):
    """Two committed scripts through BatchedInteractionEnv on the card
    and on the CPU beside the scalar env: no divergence, CUDA equal to
    the CPU after every directive, one capture a node; close() drops the
    nodes."""
    import os

    from etcd_tpu_torch.rafttest import InteractionEnv, parse_file
    from etcd_tpu_torch.rafttest.batched_env import (
        BatchedInteractionEnv, state_divergences)

    for name, r in (("single_node.txt", 1), ("campaign.txt", 3)):
        datas = parse_file(os.path.join(chip_smoke.INTERACTION_DATA, name))
        oracle = InteractionEnv()
        envs = [BatchedInteractionEnv(r), BatchedInteractionEnv(r, "cpu")]
        assert envs[0].device.type == "cuda"
        for d in datas:
            oracle.handle(d)
            for env in envs:
                env.handle(d)
            full = d.cmd == "stabilize" and all(a.vals for a in d.cmd_args)
            assert state_divergences(oracle, envs[0], check_conf=full) == [], (
                d.pos)
            assert chip_smoke.interaction_differences(*envs) == [], d.pos
        assert all(bn.node.rn.captures == 1 for bn in envs[0].nodes)
        for env in envs:
            env.close()
            assert env.nodes == []


# -- the sentinels on the card (analysis/sentinels.py) ---------------------------


def test_one_capture_key_per_tick_value(dev):
    """Each tick value's graph is noted once under "round_capture" with
    the owner's kind and config; replays note nothing more."""
    from etcd_tpu_torch.analysis import sentinels

    cfg = bench_config(24)
    eng = MultiRaftEngine(cfg, device=dev)
    before = sentinels.compile_keys("round_capture")
    for tick in (True, True, False, True, False):
        eng.run_rounds(3, tick=tick)
    new = sentinels.compile_keys("round_capture") - before
    assert new == {f"engine|{eng.cfg}|True", f"engine|{eng.cfg}|False"}
    assert sentinels.compile_keys("round_step") >= {
        f"{eng.cfg.apply_plane_key()}|aux=0|laneskip=1"}


def test_capture_budget_fires_on_a_seeded_capture(dev):
    """A warmed loop makes no capture; a tick value the loop had not
    used captures once, and a zero budget catches exactly that."""
    from etcd_tpu_torch.analysis import sentinels

    eng = MultiRaftEngine(bench_config(8), device=dev)
    eng.run_rounds(2, tick=True)
    budget = sentinels.CompileBudget(0).track("engine", eng)
    eng.run_rounds(4, tick=True)
    assert budget.check() == 0
    eng.run_rounds(1, tick=False)  # seeded: a new graph key
    with pytest.raises(sentinels.RecompileBudgetExceeded):
        budget.check()
    assert budget.misses() == 1 and budget.report() == {"engine": 1}


def test_warm_replays_under_disallow_raise_nothing(dev, monkeypatch):
    """With ETCD_TPU_TRANSFER_GUARD=disallow the engine's warm replays,
    its pipelined loop, its warm eager rounds and a rawnode's warm
    rounds run under the sync guard and raise nothing; the debug mode
    is back to off afterwards."""
    from etcd_tpu_torch.batched.rawnode import BatchedRawNode

    monkeypatch.setenv("ETCD_TPU_TRANSFER_GUARD", "disallow")
    cfg = chip_smoke.parity_configs(64, planes=True)["prevote_cq"]
    eng = MultiRaftEngine(cfg, device=dev)
    props = torch.ones(cfg.num_instances, dtype=torch.int32, device=dev)
    eng.run_rounds(2, propose_n=props)  # eager and capture unguarded
    eng.step_round(tick=True)  # after a round: guarded
    eng.run_rounds(6, propose_n=props)
    eng.run_rounds_pipelined(10, chunk=5, depth=1, propose_n=props)
    eng.step_round(tick=True, propose_n=props)
    torch.cuda.synchronize()
    assert torch.cuda.get_sync_debug_mode() == 0
    members = {m: BatchedRawNode(bench_config(16), groups=np.arange(16),
                                 slots=np.full(16, m - 1), device=dev)
               for m in (1, 2, 3)}
    for _ in pump(members, bench_config(16), rounds=6):
        pass
    assert all(rn.captures == 1 for rn in members.values())
    assert torch.cuda.get_sync_debug_mode() == 0


def test_seeded_sync_in_a_warm_eager_step_raises(dev, monkeypatch):
    """A `.item()` smuggled into a warm eager round is an error under
    disallow; the engine works on after it and the mode is restored."""
    monkeypatch.setenv("ETCD_TPU_TRANSFER_GUARD", "disallow")
    eng = MultiRaftEngine(bench_config(8), device=dev)
    eng.step_round(tick=True)  # warm
    orig = eng._step

    def poisoned(st, *args):
        st.term.sum().item()  # a host sync inside the guarded round
        return orig(st, *args)

    eng._step = poisoned
    try:
        with pytest.raises(RuntimeError, match="synchroniz"):
            eng.step_round(tick=True)
    finally:
        eng._step = orig
    assert torch.cuda.get_sync_debug_mode() == 0
    eng.step_round(tick=True)
    monkeypatch.delenv("ETCD_TPU_TRANSFER_GUARD")
    eng._step = poisoned  # with the guard off the same round runs
    eng.step_round(tick=True)


def test_device_ms_falls_back_to_cuda_events(dev, monkeypatch):
    """When the profiler's sessions record nothing, a form's warm and
    cold times come from CUDA events, each labelled "events", and the
    reason is noted; the cold difference is returned as it is, never
    clamped."""
    from etcd_tpu_torch.tools import kernel_times as kt

    def empty(*_a, **_k):
        raise RuntimeError("the profiler recorded no device time")

    x = torch.ones(1 << 20, device=dev)
    monkeypatch.setattr(kt, "profile_kernels", empty)
    n = len(kt.EVENT_TIMED)
    ms, by = kt.timed_device_ms(lambda: x.mul_(1.0))
    assert ms > 0 and by == "events"
    monkeypatch.setattr(kt, "stream_ms", lambda fn, iters: (
        1.0 if getattr(fn, "__name__", "") == "fill" else 0.5))
    assert kt.timed_device_ms(lambda: x.mul_(1.0), cold=True) == (
        -0.5, "events")
    assert len(kt.EVENT_TIMED) == n + 2


def test_mesh_phase_at_a_small_size(dev, monkeypatch):
    """chip_smoke's mesh phase at 256 groups: split and unsplit members
    end with the same KV, each kernel launched on the split path, every
    shard's forms equal their plain versions, no capture after the
    elections."""
    path = chip_smoke.run_mesh(dev, groups=256)
    assert min(path["launches"].values()) > 0
    assert len(path["shard_forms"]) == 2


def test_sweep_phase_at_a_small_size(dev, monkeypatch, tmp_path):
    """chip_smoke's sweep phase with every bench_sweep config at a small
    G, the frontier at two points, the batch and the probe at G=256."""
    from etcd_tpu_torch.tools import bench_sweep, frontier_sweep

    monkeypatch.setattr(bench_sweep, "CONFIGS", {
        c: s._replace(groups=g) for (c, s), g in zip(
            sorted(bench_sweep.CONFIGS.items()), (64, 128, 256, 1024))})
    monkeypatch.setattr(frontier_sweep, "GPU_GROUPS", [256, 512])
    monkeypatch.setattr(chip_smoke, "MAIN_GROUPS", 256)
    paths = chip_smoke.run_sweep(dev, str(tmp_path))
    assert sorted(paths) == ["sweep_2", "sweep_3", "sweep_4", "sweep_5"]
    assert any(" R=5 " in k for k in paths["sweep_3"]["forms"])
    assert all(v > 0 for p in paths.values() for v in p["launches"].values())


# -- the round tracer on the card (batched/roundtrace.py) -------------------------


def test_round_tracer_on_the_card(dev):
    """An engine built for tracing beside one built without: both graph
    variants captured in set-up and nothing in the stretch, the state
    equal to the untraced twin's, marks that
    partition the round, and each round's end mark on the host's clock
    beside a CUDA event recorded after it."""
    from etcd_tpu_torch.analysis import sentinels

    cfg = bench_config(256)
    engs = [MultiRaftEngine(cfg, device=dev, round_trace=t)
            for t in (False, True)]
    props = torch.zeros((cfg.num_instances,), dtype=torch.int32, device=dev)
    props[::3] = 3
    for eng in engs:
        eng.campaign(range(0, cfg.num_instances, 3))
        eng.run_rounds(4, tick=False)
        eng.run_rounds(2, tick=True, propose_n=props)
    assert [e.captures for e in engs] == [2, 2]
    assert [c["traced"] for c in engs[1].capture_stats] == [False, True]
    assert sentinels.compile_keys("round_capture") >= {
        f"engine|{eng.cfg}|{t}" for t in (True, False, "untraced",
                                           "traced")}
    rt = engs[1].round_trace
    torch.cuda.synchronize()
    anchor = torch.cuda.Event(enable_timing=True)
    anchor.record()
    anchor_ns = time.perf_counter_ns()
    rt.start()
    events = []
    for k in range(24):
        engs[0].run_rounds(1, tick=k % 5 == 0, propose_n=props)
        engs[1].run_rounds(1, tick=k % 5 == 0, propose_n=props)
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
    engs[1].run_rounds_pipelined(6, chunk=2, tick=False, propose_n=props)
    engs[0].run_rounds_pipelined(6, chunk=2, tick=False, propose_n=props)
    rt.stop()
    assert [e.captures for e in engs] == [2, 2]
    chip_smoke.assert_engines_equal(*engs, "traced against untraced")
    s = rt.collect()
    assert s.rounds.tolist() == list(range(30)) and s.rounds_dropped == 0
    assert (np.diff(s.marks, axis=1) >= 0).all()
    assert (np.diff(s.marks[:, 0]) > 0).all()
    seg = s.segments_ms()
    assert np.allclose(seg.sum(1), (s.marks[:, -1] - s.marks[:, 0]) / 1e6)
    ends = s.host_marks()[:24, -1]
    host = np.array([anchor_ns + anchor.elapsed_time(e) * 1e6
                     for e in events])
    diff_us = (host - ends) / 1e3
    summary = s.summary()
    print(f"round tracer: clock error {summary['clock_error_us']:.2f} us, "
          f"event - end mark median {np.median(diff_us):.2f} us, range "
          f"{diff_us.min():.2f}..{diff_us.max():.2f} us")
    assert abs(float(np.median(diff_us))) < 50
    assert summary["commit_rounds_p99"] == 2
    assert summary["spans"] == 25 and summary["spans_dropped"] == 0
