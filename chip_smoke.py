"""Chip smoke test for the PyTorch engine on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Builds the Hopper kernels from the sources in this checkout, holds each
one against its plain PyTorch version on the card, drives the main path
(the bench engine at G=65,536 groups: elections, closed-loop rounds with
proposals, commit p50) and holds the whole round on CUDA against the
same round on the CPU. Each phase prints one line; any failure raises
and the script exits non-zero. It needs CUDA: without it, it prints no
result and exits non-zero.

Line protocol (stdout): one line per phase (the kernels phase times
every main-path form warm and L2-cold; the slice phase counts launches
per kernel and per form), then a JSON line {"kernels": [...]} with every
kernel's launches on the main path and, at its most launched form, its
device time warm and cold, plain-version time and bound; then the
card's name and power limit as nvidia-smi reports them; then, last,
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import warnings

import torch

MAIN_GROUPS = 65536
R = 3  # the bench config's replica width
SEED = 20261017


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader",
         "--id=0"], capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def assert_equal(name: str, got, want) -> int:
    """Exact equality of int32 protocol values (a tensor, or a tuple of
    them for the fused quorum form); returns the largest
    |kernel - plain|, which the check holds at 0."""
    if isinstance(got, tuple):
        return max(assert_equal(f"{name} [{j}]", g, w)
                   for j, (g, w) in enumerate(zip(got, want, strict=True)))
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{name}: {got.dtype}{tuple(got.shape)} vs "
                             f"{want.dtype}{tuple(want.shape)}")
    diff = (got.long() - want.long()).abs().max().item() if got.numel() else 0
    if diff != 0:
        bad = (got != want).nonzero()[:5].tolist()
        raise AssertionError(f"{name}: kernel != plain at {bad}")
    return int(diff)


# -- phase: kernels ------------------------------------------------------------


def check_kernels(dev) -> "tuple[list, dict]":
    """Every kernel against its plain version, exactly: the quorum kernel
    in all three modes at every compiled R (1, 3, 5, 7), then every form
    the main path gives either kernel (tools/kernel_times: the quorum's
    modes and its [N, R, R] ack-prefix tallies with unexpanded masks at
    R=3, the ring lookup at K in {1, 3, 4, 12}), each timed warm and
    L2-cold at N = 196,608 rows. Returns the timed forms and each
    kernel's largest |kernel - plain|, and prints the forms."""
    from etcd_tpu_torch.batched import hopper_kernels as hk
    from etcd_tpu_torch.tools import kernel_times as kt

    gen = torch.Generator(device=dev).manual_seed(SEED)
    n = MAIN_GROUPS * R
    err = {"quorum_commit_vote": 0, "term_at_batch": 0}
    for r in (1, 3, 5, 7):
        match, voter, voter_out, in_joint, votes = kt.quorum_inputs(
            n, r, gen, dev)
        want_c, want_v = hk.quorum_commit_vote_ref(
            match, voter, voter_out, in_joint, votes)
        got_c, got_v = hk.quorum_commit_vote(
            match, voter, voter_out, in_joint, votes)
        err["quorum_commit_vote"] = max(
            err["quorum_commit_vote"],
            assert_equal(f"quorum both r={r} commit", got_c, want_c),
            assert_equal(f"quorum both r={r} vote", got_v, want_v),
            assert_equal(f"quorum commit r={r}", hk.quorum_commit(
                match, voter, voter_out, in_joint), want_c),
            assert_equal(f"quorum vote r={r}", hk.quorum_vote(
                votes, voter, voter_out, in_joint), want_v))
    variants = []
    for form in kt.main_path_forms(dev):
        name = form["key"].split()[0]
        err[name] = max(err[name], assert_equal(form["key"], form["call"](),
                                                form["plain"]()))
        variants.append(kt.time_form(form))
    log("kernels", equal=True, variants=variants)
    return variants, err


def kernel_rows(variants: list, err: dict, launches: dict,
                forms: dict) -> list:
    """The kernels line: each kernel at its most launched form on the
    main path."""
    rows = []
    for name, line in (("quorum_commit_vote", 90), ("term_at_batch", 142)):
        top = max((v for v in variants if v["form"].startswith(name + " ")),
                  key=lambda v: forms.get(v["form"], 0))
        rows.append({
            "name": name, "route": "cuda",
            "source": "etcd_tpu_torch/batched/csrc/quorum_ring.cu",
            "replaces": f"etcd_tpu/batched/pallas_kernels.py:{line}",
            "launches": launches[name], "max_abs_err": err[name],
            "ms": top["ms"], "cold_ms": top["cold_ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": None,
            "form": top["form"]})
    return rows


# -- phase: slice (the main path) ----------------------------------------------


def run_slice(dev) -> "tuple[dict, dict]":
    """The main path, with every launch count set to 0 just before it:
    returns the launches per kernel and per (kernel, form)."""
    from etcd_tpu_torch.batched import hopper_kernels as hk
    from etcd_tpu_torch.tools.benchlib import (
        make_bench_engine, measure_commit_p50, measure_rate)
    from etcd_tpu_torch.tools.kernel_times import _device_us, profile_kernels

    hk.reset_launches()
    t0 = time.perf_counter()
    eng, props = make_bench_engine(MAIN_GROUPS, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    before = eng.commits().copy()
    # Five runs each, for a median and a spread: the loop is host-bound,
    # so its rate follows the host from run to run.
    rates = [measure_rate(eng, props, rounds_per_call=8, calls=4)
             for _ in range(5)]
    after = eng.commits()
    p50s = [measure_commit_p50(eng) for _ in range(5)]
    launches = dict(hk.LAUNCHES)
    forms = dict(hk.FORM_LAUNCHES)
    rounds = eng.rounds
    if not (after[:, 0] > before[:, 0]).all():
        raise AssertionError("commits did not advance in every group")
    if not (after.min(axis=1) > 0).all():
        raise AssertionError("a group committed nothing under load")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"{name} was never launched on the main path")
    log("slice", groups=MAIN_GROUPS, rounds=rounds, setup_s=setup_s,
        group_rounds_per_s=statistics.median(rates),
        group_rounds_per_s_runs=rates,
        commit_p50_ms=statistics.median(ms for ms, _ in p50s),
        commit_p50_runs=[{"ms": ms, "rounds": r} for ms, r in p50s],
        launches=launches,
        launches_per_round={k: v / rounds for k, v in launches.items()},
        form_launches_per_round={k: v / rounds for k, v in forms.items()},
        min_commit=int(after.min()), max_commit=int(after.max()))

    # Where a round's time goes: wall time per round on the host clock
    # (no profiler), then device time by kernel name over as many rounds
    # (CUPTI through torch.profiler, CUDA activity only).
    prof_rounds = 8
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run_rounds(prof_rounds, tick=True, propose_n=props)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / prof_rounds
    events = profile_kernels(
        lambda: eng.run_rounds(prof_rounds, tick=True, propose_n=props))
    # Host syncs inside the closed loop (each one stalls the host until
    # the card drains): counted by PyTorch's sync debug mode.
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            eng.run_rounds(2, tick=True, propose_n=props)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = sum("called a synchronizing CUDA operation" in str(w.message)
                for w in caught) / 2
    busy_ms = sum(_device_us(e) for e in events) / 1e3 / prof_rounds
    per_round = sum(e.count for e in events) / prof_rounds
    log("profile", groups=MAIN_GROUPS, rounds=prof_rounds,
        wall_ms_per_round=wall_ms, device_ms_per_round=busy_ms,
        device_busy_share=busy_ms / wall_ms,
        device_kernels_per_round=per_round, host_syncs_per_round=syncs,
        wall_us_per_device_kernel=wall_ms * 1e3 / per_round,
        clocks_power=smi("clocks.sm,power.draw,temperature.gpu"),
        top_kernels=[{"name": e.key[:90], "calls_per_round":
                      e.count / prof_rounds,
                      "device_ms_per_round": _device_us(e) / 1e3 / prof_rounds}
                     for e in sorted(events, key=lambda e: -_device_us(e))[:12]])
    return launches, forms


# -- phase: parity (CUDA round vs CPU round) -----------------------------------


def run_parity(dev, plain_dev=torch.device("cpu")) -> None:
    """The same schedule through the round on `dev` (on CUDA: the
    kernels) and on `plain_dev` (the CPU: the plain forms); every state
    field and the outbox are equal after every round."""
    from etcd_tpu_torch.batched import hopper_kernels as hk
    from etcd_tpu_torch.batched.state import BatchedConfig, init_state
    from etcd_tpu_torch.batched.step import (
        NUM_KINDS, empty_msgs, make_step_round, route)
    from etcd_tpu_torch.tools.benchlib import bench_config

    groups = 256
    configs = {
        "bench": bench_config(groups),
        # Timer elections with pre-vote and check-quorum, a small ring.
        "prevote_cq": BatchedConfig(
            num_groups=groups, num_replicas=R, window=16,
            max_ents_per_msg=4, max_props_per_round=4,
            election_timeout=10, heartbeat_timeout=1, pre_vote=True,
            check_quorum=True, auto_compact=True),
    }
    rng = torch.Generator().manual_seed(SEED)
    for label, cfg in configs.items():
        n = cfg.num_instances
        sides = {}
        for side, d in (("kernel", dev), ("plain", plain_dev)):
            sides[side] = [
                init_state(cfg, device=d),
                empty_msgs((n, cfg.num_replicas, NUM_KINDS),
                           cfg.max_ents_per_msg, device=d),
                make_step_round(cfg, device=d)]
        rounds = 60
        hk.reset_launches()
        for rnd in range(rounds):
            # A seeded schedule: early campaigns, steady proposals on
            # every slot (leaders accept), a rolling partition, reads and
            # transfers.
            camp = torch.rand(n, generator=rng) < (0.3 if rnd < 3 else 0.01)
            props = torch.randint(0, cfg.max_props_per_round + 1, (n,),
                                  generator=rng, dtype=torch.int32)
            iso = torch.zeros(n, dtype=torch.bool)
            if 20 <= rnd < 35:
                iso[(rnd % R)::R * 7] = True
            read = torch.rand(n, generator=rng) < 0.05
            tr = torch.where(torch.rand(n, generator=rng) < 0.02,
                             torch.randint(1, R + 1, (n,), generator=rng,
                                           dtype=torch.int32), 0)
            tick = torch.full((n,), rnd % 2 == 0 or label != "bench")
            outs = {}
            for name, side in sides.items():
                st, inbox, step = side
                to = lambda x: x.to(st.term.device)  # noqa: E731
                st, out = step(st, inbox, to(tick), to(camp), to(props),
                               to(iso), to(tr), to(read))
                side[0], side[1] = st, route(cfg, out)
                outs[name] = (st, out)
            for part in (0, 1):
                a, b = outs["kernel"][part], outs["plain"][part]
                for f in a._fields:
                    x, y = getattr(a, f).cpu(), getattr(b, f)
                    if x.dtype != y.dtype or not torch.equal(x, y):
                        raise AssertionError(
                            f"parity {label} round {rnd}: field {f} of "
                            f"{'state' if part == 0 else 'outbox'} differs")
        st = sides["plain"][0]
        log("parity", config=label, groups=groups, rounds=rounds,
            equal=True, launches=dict(hk.LAUNCHES),
            form_launches=dict(hk.FORM_LAUNCHES),
            leaders=int((st.role == 2).sum()),
            max_commit=int(st.commit.max()), max_term=int(st.term.max()))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this test needs a GPU",
              file=sys.stderr)
        return 2
    from etcd_tpu_torch.batched import hopper_kernels as hk

    dev = torch.device("cuda", 0)
    card = smi("name,power.limit")
    t0 = time.perf_counter()
    hk.load_library()
    log("env", card=card, torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0),
        build_s=time.perf_counter() - t0, library=hk.library_path().name)

    variants, err = check_kernels(dev)
    launches, forms = run_slice(dev)
    run_parity(dev)
    print(json.dumps({"kernels": kernel_rows(variants, err, launches,
                                             forms)}))
    print(smi("name,power.limit"))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
