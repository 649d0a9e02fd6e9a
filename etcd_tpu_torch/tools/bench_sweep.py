"""BASELINE.md benchmark configs #2-#5: the multi-Raft shard sweep, on
the PyTorch engine.

Ports ``etcd_tpu/tools/bench_sweep.py``; the configs are the same field
for field:

#2  1k-shard,  3 replicas — leader append path (steady proposals)
#3  10k-shard, 5 replicas — commit index + Progress tracker on device
#4  100k-shard, 3 replicas — randomized elections + vote-tally kernel
#5  1M-shard,  3 replicas — JointConfig membership (half the groups run
    a joint config, commit = min of both quorum halves) + a ReadIndex
    batch opened on every leader each measured block, confirmed via
    heartbeat-ack quorum on device

    python3 -m etcd_tpu_torch.tools.bench_sweep [--configs 2,3,4,5]
        [--quick] [--device cpu]

It runs on the GPU unless called with ``--device cpu`` (without CUDA and
with no device named it exits with an error and measures nothing);
``--quick`` gives the JAX tool's CPU sizes (the CPU runs them whether
asked or not, as the JAX tool runs its CPU sizes off an accelerator).
Each config prints one JSON line naming the device (for a GPU, its name
and power limit), the layout the round ran (``"major"``: the port's round is always
instance-major, and the configs keep ``lanes_minor`` at its default),
the captures its measured blocks made (held at 0) and, on the card, the
peak device memory. Config #1 (raftexample's three-node single group) is
the raftexample suite's and chip_smoke's, not this sweep's.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..analysis.sentinels import CompileBudget
from ..batched import BatchedConfig, MultiRaftEngine
from ..batched.state import resolve_device
from .bench import device_label


def _sync(eng) -> None:
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)


class Sweep(NamedTuple):
    name: str
    groups: int  # the accelerator size
    quick_groups: int  # the JAX tool's CPU size
    replicas: int
    rounds: int  # rounds a measured block
    calls: int  # measured blocks


CONFIGS: Dict[int, Sweep] = {
    2: Sweep("append-path", 1024, 1024, 3, 16, 4),
    3: Sweep("commit+progress-R5", 10240, 2048, 5, 16, 4),
    4: Sweep("randomized-elections", 102400, 4096, 3, 16, 4),
    5: Sweep("joint+readindex-scale", 1048576, 16384, 3, 8, 2),
}


def steady_config(groups: int, replicas: int) -> BatchedConfig:
    """Configs #2, #3 and #5: R replicas, W=32, E=4, P=2, heartbeat 4,
    no timer elections, auto-compaction."""
    return BatchedConfig(
        num_groups=groups, num_replicas=replicas, window=32,
        max_ents_per_msg=4, max_props_per_round=2,
        election_timeout=1 << 20, heartbeat_timeout=4,
        auto_compact=True,
    )


def election_config(groups: int, replicas: int) -> BatchedConfig:
    """Config #4: W=16, E=2, P=1, election 4 ticks, heartbeat 1."""
    return BatchedConfig(
        num_groups=groups, num_replicas=replicas, window=16,
        max_ents_per_msg=2, max_props_per_round=1,
        election_timeout=4, heartbeat_timeout=1,
        auto_compact=True,
    )


def _leader_rows(eng) -> torch.Tensor:
    """Every group's slot-0 row (the rows the setup elects)."""
    r = eng.cfg.num_replicas
    return torch.arange(0, eng.cfg.num_instances, r, device=eng.device)


def _elect(eng) -> None:
    eng.campaign(range(0, eng.cfg.num_instances, eng.cfg.num_replicas))
    eng.run_rounds(4, tick=False)
    if not (eng.leaders() == 0).all():
        raise AssertionError("not every group elected its slot-0 leader")


def _props(eng) -> torch.Tensor:
    props = torch.zeros((eng.cfg.num_instances,), dtype=torch.int32,
                        device=eng.device)
    props[_leader_rows(eng)] = 2
    return props


def build_steady(groups: int, replicas: int,
                 device) -> Tuple[MultiRaftEngine, Callable[[int], None]]:
    """Configs #2 and #3: every group's slot 0 elected, then blocks of
    steady rounds with two proposals per leader per round."""
    eng = MultiRaftEngine(steady_config(groups, replicas), device=device)
    _elect(eng)
    props = _props(eng)

    def block(rounds: int) -> None:
        eng.run_rounds(rounds, tick=True, propose_n=props)
    return eng, block


def build_elections(groups: int, replicas: int,
                    device) -> Tuple[MultiRaftEngine, Callable[[int], None]]:
    """Config #4: every group keeps ticking with a short election
    timeout, electing again and again through the vote tally."""
    eng = MultiRaftEngine(election_config(groups, replicas), device=device)

    def block(rounds: int) -> None:
        eng.run_rounds(rounds, tick=True)
    return eng, block


def build_joint_readindex(groups: int, replicas: int, device
                          ) -> Tuple[MultiRaftEngine, Callable[[int], None]]:
    """Config #5: groups [0, G/2) in the joint config {all} x {all but
    the last} (written into the engine's own mask buffers: its graph
    replays their addresses), every slot 0 elected; a block opens a
    ReadIndex batch on every leader in one eager round, then steady
    rounds confirm it through the heartbeat acks."""
    eng = MultiRaftEngine(steady_config(groups, replicas), device=device)
    half = groups // 2
    vout = np.zeros((eng.cfg.num_instances, replicas), bool)
    joint = np.zeros((eng.cfg.num_instances,), bool)
    vout[: half * replicas, : replicas - 1] = True
    joint[: half * replicas] = True
    eng.state.voter_out.copy_(torch.from_numpy(vout))
    eng.state.in_joint.copy_(torch.from_numpy(joint))
    _elect(eng)
    props = _props(eng)
    leader_rows = torch.zeros((eng.cfg.num_instances,), dtype=torch.bool,
                              device=eng.device)
    leader_rows[_leader_rows(eng)] = True

    def block(rounds: int) -> None:
        eng.step_round(read_req=leader_rows, propose_n=props)
        eng.run_rounds(rounds - 1, tick=True, propose_n=props)
    return eng, block


BUILDERS = {2: build_steady, 3: build_steady, 4: build_elections,
            5: build_joint_readindex}


def run_config(c: int, groups: int, rounds: int, calls: int, device=None
               ) -> Tuple[dict, MultiRaftEngine]:
    """Config `c` at `groups`: build and set up the engine, one warm-up
    block (it captures the round's graphs on CUDA), then `calls`
    measured blocks of `rounds` rounds, held to zero new captures; every
    assert of the JAX tool is held. Returns the JSON record and the
    engine."""
    sweep = CONFIGS[c]
    dev = resolve_device(device)
    if dev.type == "cuda":
        # The allocator's peak counters exist once CUDA is initialized.
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    eng, block = BUILDERS[c](groups, sweep.replicas, dev)
    block(rounds)  # warm-up
    _sync(eng)
    setup_s = time.perf_counter() - t0
    # The measured blocks replay what the warm-up captured.
    budget = CompileBudget(0).track(f"sweep#{c}", eng)
    t0 = time.perf_counter()
    for _ in range(calls):
        block(rounds)
    _sync(eng)
    dt = time.perf_counter() - t0
    rec = {"config": c, "name": sweep.name, "groups": groups,
           "replicas": sweep.replicas,
           "group_rounds_per_sec": groups * rounds * calls / dt,
           "rounds": rounds, "calls": calls, "setup_s": setup_s,
           "device": device_label(dev),
           "layout": "major", "deliver": eng.cfg.deliver_shape,
           "captures": eng.captures,
           "captures_after_warmup": budget.check()}
    if c == 4:
        terms = eng.terms()
        if int(terms.max()) <= 0:
            raise AssertionError("no elections fired")
        rec.update(max_term_reached=int(terms.max()),
                   leaders_now=int((eng.leaders() >= 0).sum()))
    else:
        if eng.commits().min() <= 0:
            raise AssertionError(f"config #{c}: a group committed nothing")
    if c == 5:
        _seq, _idx, ready = eng.read_states()
        confirmed = int(ready[::sweep.replicas].sum())
        if confirmed <= 0:
            raise AssertionError("no ReadIndex batch ever confirmed")
        rec.update(joint_groups=groups // 2,
                   read_batches_confirmed=confirmed)
    if dev.type == "cuda":
        rec["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated(
            dev)
    return rec, eng


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python3 -m etcd_tpu_torch.tools.bench_sweep")
    ap.add_argument("--configs", default="2,3,4,5")
    ap.add_argument("--quick", action="store_true",
                    help="the JAX tool's CPU sizes")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"bench_sweep: {e}") from None
    want = sorted({int(c) for c in args.configs.split(",")})
    for c in want:
        if c not in CONFIGS:
            raise SystemExit(f"unknown config #{c} (choose from "
                             f"{sorted(CONFIGS)})")
    quick = args.quick or dev.type != "cuda"
    for c in want:
        sweep = CONFIGS[c]
        groups = sweep.quick_groups if quick else sweep.groups
        # jitlint: waive(sync-in-loop) -- one engine a config, built, measured and checked on its own: its fences are the measurement
        rec, eng = run_config(c, groups, sweep.rounds, sweep.calls, dev)
        print(json.dumps(rec), flush=True)
        del eng


if __name__ == "__main__":
    main()
