"""Times of the Hopper kernels at the main path's forms, and a same-call
A/B of two checkouts.

Each form is one kernel call as the round makes it (through the site
functions of ``batched/kernels.py``, and the fused quorum form through
its wrapper) at G=65,536 groups of the bench config (N = 196,608
rows), on seeded inputs. Per form: device time warm (the inputs in L2
from the previous call) and L2-cold (the 50 MB L2 overwritten before
each call, as the round finds these tensors), the time per call of
back-to-back calls on the stream, and the bound. chip_smoke.py times
its kernels with these functions.

    python3 -m etcd_tpu_torch.tools.kernel_times OLD NEW

runs the forms of checkout OLD, then NEW, NEW, OLD, each in a process
of its own on one GPU, holds every result equal to this checkout's
plain forms, and runs each checkout's bench twin
(``etcd_tpu_torch.tools.bench``) in the same turns. It prints one JSON
line per run, the card's name and power limit, and last a JSON line
with each side's mean of its two runs.
"""

from __future__ import annotations

import functools
import importlib
import importlib.util
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from ..batched import hopper_kernels as hk_plain
from ..batched import kernels as k_plain
from ..batched.step import ROUND_PHASE_SCOPES
from .bench import device_label

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
# The 32-bit rate outside the tensor cores (67 TFLOP/s float32): the
# quorum and ring kernels do integer compares and adds, no matrix work.
OPS_PER_S = 67e12
L2_BYTES = 50 * 2**20  # H100

GROUPS = 65536
R, W, E = 3, 32, 4  # the bench config's widths
SEED = 20261017


# -- timers ----------------------------------------------------------------------


def _device_us(event) -> float:
    t = getattr(event, "self_device_time_total", None)
    return getattr(event, "self_cuda_time_total", 0) if t is None else t


# The ranges the eager round opens (step.ROUND_PHASE_SCOPES): on the
# device timeline each is a user annotation spanning its kernels and the
# gaps between them, not work of its own.
PHASE_LABELS = frozenset(label for _n, label in ROUND_PHASE_SCOPES)


def kernel_events(prof):
    """The profiler's per-name averages of work that ran on the card."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and _device_us(e) > 0 and e.key not in PHASE_LABELS]


def profile_kernels(fn, iters: int = 1, attempts: int = 3):
    """kernel_events of `iters` calls of fn() (CUPTI through
    torch.profiler, CUDA activity only). A session that records no
    device work, or records some kernel a number of times that is not a
    multiple of `iters` (every call launches the same kernels, so some
    records were dropped), is taken again, up to `attempts` times: the
    first session of a process has been seen to come back empty, and
    sessions late in a long process short."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            # jitlint: waive(sync-in-loop) -- the fence that closes a profiler session: one a session, the measurement itself
            torch.cuda.synchronize()
        events = kernel_events(prof)
        if events and all(e.count % iters == 0 for e in events):
            return events
    raise RuntimeError("the profiler recorded no device time, or not "
                       f"every call's kernels, in {attempts} sessions")


@functools.cache
def _flush():
    """A function that overwrites the whole L2 (twice its size, in a
    float64 fill no timed form launches), and its kernels' names."""
    buf = torch.empty(2 * L2_BYTES // 8, dtype=torch.float64, device="cuda")

    def fill():
        buf.fill_(0.5)
    fill()
    return fill, {e.key for e in profile_kernels(fill)}


def device_ms(fn, iters: int = 20, warmup: int = 3, cold: bool = False):
    """Device time per call of fn(): the time of every kernel it
    launches, summed (CUPTI through torch.profiler), over `iters` calls;
    with `cold`, the L2 is overwritten before each call and the
    overwrite's own kernel is left out."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    skip = set()
    timed = fn
    if cold:
        flush, skip = _flush()

        def timed():
            flush()
            fn()
    events = [e for e in profile_kernels(timed, iters) if e.key not in skip]
    return sum(_device_us(e) for e in events) / iters / 1e3


def stream_ms(fn, iters: int = 20, repeats: int = 5, warmup: int = 5):
    """Time per call of fn() on the stream: the median over `repeats` of
    the mean of `iters` back-to-back calls between two CUDA events,
    after `warmup` calls. When the host issues calls slower than the
    card runs them, this is the host's time per call; the median keeps
    a repeat that the shared host stalled out of it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        # jitlint: waive(sync-in-loop) -- the timing fence of one repeat: the measurement itself
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1) / iters)
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float) -> "tuple[float, str]":
    """The least time the card could take: bytes at the HBM rate or
    operations at the 32-bit rate, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def form_cost(key: str, args) -> "tuple[float, float]":
    """The bytes and operations of one call of form `key` (as
    hopper_kernels.FORM_LAUNCHES counts it: "quorum_commit_vote commit
    ...", "... vote ...", "... both ...", "term_at_batch ...") on
    `args`, its wrapper's arguments (hopper_kernels.quorum_commit,
    quorum_vote, quorum_commit_vote, term_at_batch). Bytes: each input
    read once (for the ring, the distinct slots these queries read
    inside it), each output written once. Operations: B1's O(R^2)
    support loop a half for commit, 4R compares a half for a vote
    tally, on every row, twice on a joint row; B2's 8 a query."""
    if key.startswith("term_at_batch"):
        log_term, snap_index, _snap_term, last, idx = args[:5]
        n, w = log_term.shape
        flat = idx.reshape(n, -1)
        ring = ((flat > snap_index.unsqueeze(-1))
                & (flat <= last.unsqueeze(-1)))
        slots = torch.where(flat >= 0, flat % w, 0).long() + w * torch.arange(
            n, device=flat.device).unsqueeze(-1)
        reads = torch.unique(slots[ring]).numel()
        return 4 * (3 * n + 2 * flat.numel() + reads), 8 * flat.numel()
    vals, voter, _voter_out, in_joint = args[:4]
    n, r = voter.shape
    rows = vals.numel() // r  # B tallies an instance
    joint = in_joint.float().mean().item()
    kind = key.split()[1]
    support = r + r * (2 * r + 2)  # the O(R^2) support loop of a half
    per_row = {"commit": support, "vote": 4 * r, "both": support + 4 * r}
    tallies = 2 if kind == "both" else 1  # commit's inputs and votes
    return (tallies * rows * (4 * r + 4) + n * (2 * r + 1),
            rows * (1 + joint) * per_row[kind])


# -- inputs and forms --------------------------------------------------------------


def quorum_inputs(n: int, r: int, gen: torch.Generator, dev):
    """Seeded [N, R] quorum inputs with edge rows: an empty config, an
    empty joint config, a joint row, a single voter."""
    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    match = torch.randint(0, 1 << 20, (n, r), generator=gen, device=dev,
                          dtype=torch.int32)
    voter = rand(n, r) < 0.8
    voter_out = rand(n, r) < 0.4
    in_joint = rand(n) < 0.5
    votes = torch.randint(-1, 2, (n, r), generator=gen, device=dev,
                          dtype=torch.int32)
    voter[0] = False
    in_joint[0] = False
    voter[1] = False
    voter_out[1] = False
    in_joint[1] = True
    in_joint[2] = True
    voter[3] = False
    voter[3, 0] = True
    in_joint[3] = False
    return match, voter, voter_out, in_joint, votes


def term_inputs(n: int, w: int, k: int, gen: torch.Generator, dev):
    """Seeded ring-lookup inputs: indexes below, at, inside and above
    each ring, with edge rows for a negative index and a wrapped ring."""
    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    log_term = randint(1, 1 << 16, (n, w))
    snap_index = randint(0, 1 << 20, (n,))
    snap_term = randint(1, 1 << 16, (n,))
    last = snap_index + randint(0, w + 1, (n,))
    idx = snap_index.unsqueeze(-1) + randint(-3, w + 3, (n, k))
    idx[0] = snap_index[0]          # at the floor
    idx[1] = snap_index[1] - 1      # below it
    idx[2] = last[2] + 1            # above the ring
    idx[3] = -5                     # negative
    snap_index[4] = -9              # a negative index inside the ring
    last[4] = 2
    idx[4] = -3
    return log_term, snap_index, snap_term, last, idx if k > 1 else idx[:, 0]


def main_path_forms(dev, k=k_plain, hk=hk_plain, n: int = 0,
                    w: int = W, e: int = E):
    """Every form the main path gives the two kernels, at N = 196,608
    rows: a list of dicts with the form's key (as
    hopper_kernels.FORM_LAUNCHES counts it), `call` through the site
    functions of kernels module `k` (and the fused quorum form through
    `hk`), `plain` through this checkout's plain forms, and the bytes
    and operations of its bound. `n`, `w` and `e` give another path's
    rows, window and entries per message (hosting_path_forms)."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n = n or GROUPS * R
    match, voter, voter_out, in_joint, votes = quorum_inputs(n, R, gen, dev)
    masks = (voter, voter_out, in_joint)
    prefix = torch.rand((n, R, R), generator=gen, device=dev) < 0.5
    tally = torch.where(prefix, 1, -1).to(torch.int32)
    q = "quorum_commit_vote"
    forms = [
        {"key": f"{q} commit R={R} B=1",
         "call": lambda: k.joint_committed(match, *masks),
         "plain": lambda: hk_plain.quorum_commit_ref(match, *masks),
         "args": (match, *masks)},
        {"key": f"{q} vote R={R} B=1",
         "call": lambda: k.joint_vote_result(votes, *masks),
         "plain": lambda: hk_plain.quorum_vote_ref(votes, *masks),
         "args": (votes, *masks)},
        {"key": f"{q} both R={R} B=1",
         "call": lambda: hk.quorum_commit_vote(match, *masks, votes),
         "plain": lambda: hk_plain.quorum_commit_vote_ref(match, *masks,
                                                          votes),
         "args": (match, *masks, votes)},
        # The heartbeat-response lane's ReadIndex ack prefixes: R
        # tallies per instance (votes 1 or -1).
        {"key": f"{q} vote R={R} B={R}",
         "call": lambda: k.joint_vote_result(tally, *masks),
         "plain": lambda: hk_plain.quorum_vote_ref(
             tally.view(-1, R), *masks, R).view(n, R),
         "args": (tally.view(-1, R), *masks, R)},
    ]
    # The round's index widths: [N] (K=1), _emit's [N, R] prev indexes,
    # _handle_append's [N, E] entry indexes and _emit's [N, R, E]
    # entries (K=12 on the bench config).
    for width in (1, R, e, R * e):
        log_term, snap_index, snap_term, last, idx = term_inputs(
            n, w, width, gen, dev)
        if width == R * e:
            idx = idx.view(n, R, e)
        args = (log_term, snap_index, snap_term, last, idx)
        forms.append({
            "key": f"term_at_batch K={width} W={w}",
            "call": lambda a=args: k.term_at(*a),
            "plain": lambda a=args: hk_plain.term_at_batch_ref(*a),
            "args": args})
    for form in forms:
        # jitlint: waive(sync-in-loop) -- set-up: a bound counts what the seeded inputs hold, once a form, before any timing
        form["bytes"], form["ops"] = form_cost(form["key"], form.pop("args"))
    return forms


# The hosting path (batched/hosting.py): a member's rawnode has one row
# per group (hosted_bench's G = 1,024) at MultiRaftMember's default
# config, W = 64 and E = 8, so the ring lookup meets K = 1, 3, 8 and 24
# in its general kernel (W = 32 alone is compiled).
HOSTING_GROUPS = 1024
HOSTING_W, HOSTING_E = 64, 8


def hosting_path_forms(dev, k=k_plain, hk=hk_plain):
    """Every form a hosting member's round gives the two kernels, at
    N = 1,024 rows: main_path_forms at hosting's widths."""
    return main_path_forms(dev, k, hk, n=HOSTING_GROUPS, w=HOSTING_W,
                           e=HOSTING_E)


# A hosting_proc worker (hosted_bench's member) runs serve's config:
# W = 32 and E = 4, so its ring lookups take the compiled K = 1, 3, 4
# and 12 kernels; its quorum forms are hosting_path_forms' at N = 1,024.
WORKER_W, WORKER_E = 32, 4


def worker_path_forms(dev, k=k_plain, hk=hk_plain):
    """The ring-lookup forms a worker's round gives the kernel at
    N = 1,024 rows (the quorum forms are hosting_path_forms')."""
    return [f for f in main_path_forms(dev, k, hk, n=HOSTING_GROUPS,
                                       w=WORKER_W, e=WORKER_E)
            if f["key"].startswith("term_at_batch ")]


# The node path (batched/node.py): one row (N = 1) per BatchedNode round,
# R = 3, E = 8, so the ring lookup meets K = 1, R, E and R*E = 24, at
# raftexample's and a server's default window, and at the window of a
# server at snapshot_count 16 (chip_smoke's MsgSnap catch-up, W = 128).
# Booted members (embed)
# run a spare slot: R = 4 for three peers, R = 2 for a solo member (as a
# restored snapshot boots), so the lookup also meets K = 2, 4, 16 and 32.
NODE_R, NODE_E = 3, 8
BOOT_R, SOLO_R = NODE_R + 1, 2
NODE_RS = (NODE_R, BOOT_R, SOLO_R)
NODE_WINDOWS = (128, 32768)


def node_term_cases(w: int, k: int, gen: torch.Generator, dev) -> list:
    """Seeded N = 1 ring-lookup inputs at window `w` with K = `k`
    queries: three rings (a fresh log, a full ring that wraps past a
    multiple of W, a long log one past a wrap) and, over the cases of
    each ring, every edge query (the floor, one past last, the first
    and last index, below the floor, the wrap point), padded with
    in-range queries."""
    cases = []
    for si, span in ((0, 40), (3 * w - 5, w - 1), (5 * w + 11, w)):
        last = si + span
        log_term = torch.randint(1, 1 << 16, (1, w), generator=gen,
                                 device=dev, dtype=torch.int32)
        edges = [si, last + 1, si + 1, last, si - 1, (si // w + 1) * w]
        for lo in range(0, len(edges), k):
            q = edges[lo:lo + k]
            pad = torch.randint(si + 1, last + 1, (k - len(q),),
                                generator=gen, device=dev,
                                dtype=torch.int32)
            idx = torch.cat([torch.tensor(q, dtype=torch.int32,
                                          device=dev), pad]).view(1, k)
            cases.append((log_term,
                          torch.tensor([si], dtype=torch.int32, device=dev),
                          torch.randint(1, 1 << 16, (1,), generator=gen,
                                        device=dev, dtype=torch.int32),
                          torch.tensor([last], dtype=torch.int32,
                                       device=dev),
                          idx if k > 1 else idx[:, 0].contiguous()))
    return cases


def node_quorum_cases(gen: torch.Generator, dev, tallies: int = 1,
                      r: int = NODE_R) -> list:
    """Seeded N = 1 quorum inputs at R = 3 (all voters, a joint config,
    a single voter, an empty config and an empty joint config), R = 4
    (a booted member: three voters and the spare slot, a member replaced
    through the spare, a joint config over it, a single voter and an
    empty config) or R = 2 (a booted solo member: its voter and the
    spare, a second voter in the spare, a joint config over both, an
    empty config)."""
    masks = {3: [((1, 1, 1), (0, 0, 0), False), ((1, 1, 0), (1, 0, 1), True),
                 ((0, 1, 0), (0, 0, 0), False), ((0, 0, 0), (0, 0, 0), False),
                 ((0, 0, 0), (0, 0, 0), True)],
             4: [((1, 1, 1, 0), (0, 0, 0, 0), False),
                 ((1, 0, 1, 1), (0, 0, 0, 0), False),
                 ((1, 0, 1, 1), (1, 1, 1, 0), True),
                 ((0, 1, 0, 0), (0, 0, 0, 0), False),
                 ((0, 0, 0, 0), (0, 0, 0, 0), False)],
             2: [((1, 0), (0, 0), False), ((1, 1), (0, 0), False),
                 ((1, 1), (1, 0), True), ((0, 0), (0, 0), False)]}[r]
    cases = []
    for voter, voter_out, joint in masks:
        def mask(v):
            return torch.tensor([v], dtype=torch.bool, device=dev)
        match = torch.randint(0, 1 << 20, (tallies, r), generator=gen,
                              device=dev, dtype=torch.int32)
        votes = torch.randint(-1, 2, (tallies, r), generator=gen,
                              device=dev, dtype=torch.int32)
        cases.append((match, mask(voter), mask(voter_out),
                      torch.tensor([joint], device=dev), votes))
    return cases


def node_path_forms(dev, hk=hk_plain) -> list:
    """Every form a BatchedNode round gives the two kernels, at N = 1:
    like main_path_forms, with `cases` (every seeded case, each to be
    held equal to the plain form) and `call`/`plain` on the timed case
    (B1: the second, the joint config at R = 3; B2: the long log's last
    case), whose bytes and operations the bound counts (form_cost). B1 at R = 3 (a three-member
    cluster), R = 4 (booted members' three peers and spare slot) and
    R = 2 (a booted solo member and its spare slot)."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q = "quorum_commit_vote"
    forms = []

    def add(key, cases, timed):
        """A form over `cases` (run, plain, args) whose `timed` one the
        bound counts."""
        run, plain, args = cases[timed]
        nbytes, ops = form_cost(key, args)
        forms.append({"key": key, "n": 1,
                      "cases": [(c[0], c[1]) for c in cases],
                      "call": run, "plain": plain,
                      "bytes": nbytes, "ops": ops})

    for r in NODE_RS:
        for key, tallies, args_of, run, plain in (
                (f"{q} commit R={r} B=1", 1, lambda c: c[:4],
                 hk.quorum_commit, hk_plain.quorum_commit_ref),
                (f"{q} vote R={r} B=1", 1, lambda c: (c[4], *c[1:4]),
                 hk.quorum_vote, hk_plain.quorum_vote_ref),
                (f"{q} vote R={r} B={r}", r,
                 lambda c, r=r: (c[4], *c[1:4], r),
                 hk.quorum_vote, hk_plain.quorum_vote_ref)):
            cases = [(lambda a=a, f=run: f(*a), lambda a=a, f=plain: f(*a), a)
                     for a in map(args_of,
                                  node_quorum_cases(gen, dev, tallies, r))]
            # jitlint: waive(sync-in-loop) -- set-up: a bound counts what the timed case holds, once a form, before any timing
            add(key, cases, 1)
    for w in NODE_WINDOWS:
        for k in sorted({1, NODE_E} | set(NODE_RS)
                        | {r * NODE_E for r in NODE_RS}):
            cases = [(lambda a=a: hk.term_at_batch(*a),
                      lambda a=a: hk_plain.term_at_batch_ref(*a), a)
                     for a in node_term_cases(w, k, gen, dev)]
            # jitlint: waive(sync-in-loop) -- set-up: a bound counts what the timed case holds, once a form, before any timing
            add(f"term_at_batch K={k} W={w}", cases, -1)
    return forms


def time_form(form: dict, plain: bool = True) -> dict:
    """A form's device time warm and L2-cold, its call time, its bound
    and, with `plain`, its plain form's device and call times."""
    b_ms, b_by = bound_ms(form["bytes"], form["ops"])
    out = {"form": form["key"], "ms": device_ms(form["call"]),
           "cold_ms": device_ms(form["call"], cold=True),
           "call_ms": stream_ms(form["call"]), "bound_ms": b_ms,
           "bound_by": b_by}
    if plain:
        out.update(plain_ms=device_ms(form["plain"]),
                   plain_call_ms=stream_ms(form["plain"]))
    return out


# -- A/B of two checkouts ------------------------------------------------------------


ROOT = Path(__file__).resolve().parents[2]


def _load_tree(tree: Path):
    """The batched kernels and wrappers of the checkout at `tree`, as a
    package of another name."""
    init = tree / "etcd_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        "ab_tree", init, submodule_search_locations=[str(init.parent)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules["ab_tree"] = pkg
    spec.loader.exec_module(pkg)
    return (importlib.import_module("ab_tree.batched.kernels"),
            importlib.import_module("ab_tree.batched.hopper_kernels"))


def run_one(tree: str) -> dict:
    dev = torch.device("cuda", 0)
    k, hk = _load_tree(Path(tree).resolve())
    times = {}
    for form in main_path_forms(dev, k, hk):
        got, want = form["call"](), form["plain"]()
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        if not all(map(torch.equal, got, want)):
            raise AssertionError(f"{tree}: {form['key']} != plain form")
        # jitlint: waive(sync-in-loop) -- each form is timed on its own; its fences are the measurement
        times[form["key"]] = time_form(form, plain=False)
    return {"tree": tree, "forms": times}


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("kernel_times: needs a CUDA device", file=sys.stderr)
        return 2
    if argv[:1] == ["--one"]:
        print(json.dumps(run_one(argv[1])))
        return 0
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = argv
    runs = {a: [], b: []}
    benches = {a: [], b: []}
    for tree in (a, b, b, a):
        rec = json.loads(_last_line(
            [sys.executable, "-m", "etcd_tpu_torch.tools.kernel_times",
             "--one", str(Path(tree).resolve())], ROOT))
        rec["tree"] = tree
        print(json.dumps(rec), flush=True)
        runs[tree].append(rec["forms"])
        bench = bench_run(tree)
        print(json.dumps(bench), flush=True)
        benches[tree].append(bench)
    print(device_label(torch.device("cuda", 0)))
    summary = {}
    for tree, recs in runs.items():
        summary[tree] = {
            key: {m: statistics.mean(r[key][m] for r in recs)
                  for m in ("ms", "cold_ms", "call_ms", "bound_ms")}
            for key in recs[0]}
        summary[tree]["bench"] = {
            m: statistics.mean(r[m] for r in benches[tree])
            for m in ("group_rounds_per_s", "commit_p50_ms")}
    print(json.dumps({"ab": summary}))
    return 0


def _last_line(cmd, cwd) -> str:
    proc = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                          timeout=600, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd} in {cwd} failed:\n{proc.stderr[-4000:]}")
    return proc.stdout.strip().splitlines()[-1]


def bench_run(tree: str) -> dict:
    """One run of the bench twin of the checkout at `tree`, in a process
    of its own: its group-rounds/s and commit p50."""
    rec = json.loads(_last_line(
        [sys.executable, "-m", "etcd_tpu_torch.tools.bench"],
        Path(tree).resolve()))
    p50 = re.search(r"commit_p50=([0-9.]+)ms/(\d+)r", rec["unit"])
    return {"tree": tree, "group_rounds_per_s": rec["value"],
            "commit_p50_ms": float(p50.group(1)),
            "commit_p50_rounds": int(p50.group(2)), "unit": rec["unit"]}


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
