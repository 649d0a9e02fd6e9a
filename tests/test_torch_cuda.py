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
