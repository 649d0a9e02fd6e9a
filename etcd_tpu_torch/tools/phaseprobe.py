"""Device round-segment attribution: each phase of the batched round
timed as its own CUDA graph over the same live state, beside the full
graphed round.

Ports the repository's ``tools/phaseprobe.py`` to the PyTorch engine.
A warmed bench engine supplies a realistic steady state (leaders
elected, proposals staged, the inbox populated); each phase function of
``step.py`` (``_deliver_all``, ``_tick``, ``_control``, ``_propose``,
``_emit``, then ``route`` on emit's outbox and ``pack_outbox``, the
rawnode's on-device collect) is run once eagerly, captured into a graph
of its own and replayed `rounds` times between two CUDA events; every
replay after the first runs under the sync guard (``analysis.sentinels.
round_guard``). The full round is the engine's own graph, replayed the
same way. The phases are pure functions of the live state, so a replay
repeats the same work. The fused round overlaps nothing across its
phases on one stream, but the isolated graphs pay their own launch
gaps: the segments are an attribution of relative cost, and their sum
can differ from the full round's time (both are reported). On the CPU
each segment is timed eagerly on the host clock and named as such.

    python3 -m etcd_tpu_torch.tools.phaseprobe [--groups 65536]
        [--deliver-shape auto] [--rounds 32] [--out FILE] [--device cpu]

It runs on the GPU unless called with ``--device cpu``; without CUDA
and with no device named it exits with an error and writes nothing.
The labels are ``step.ROUND_PHASE_SCOPES``, the ranges the eager round
opens under ``torch.profiler`` (the JAX package's named_scope strings).
The JAX tool's ``--layout`` and ``--xprof`` have no counterpart: the
port's round has one layout, and ``tools/gpu_batch.py`` section (e)
writes the profiler trace.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from ..analysis.sentinels import round_guard
from ..batched import step as step_mod
from ..batched.graph import device_work
from ..batched.state import I32, resolve_device
from .bench import device_label


def _time_calls(fn, rounds: int, dev) -> float:
    """Milliseconds a call of fn(): on CUDA its graph's replays between
    two CUDA events (one eager call and the capture first, unguarded);
    on the CPU eager calls on the host clock."""
    if dev.type != "cuda":
        fn()
        t0 = time.perf_counter()
        for _ in range(rounds):
            fn()
        return (time.perf_counter() - t0) * 1e3 / rounds
    graph = torch.cuda.CUDAGraph()
    with device_work():
        fn()
        torch.cuda.synchronize(dev)
        with torch.cuda.graph(graph):
            fn()
    graph.replay()  # the first replay: unguarded
    torch.cuda.synchronize(dev)
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with round_guard(dev):
        t0.record()
        for _ in range(rounds):
            graph.replay()
        t1.record()
    torch.cuda.synchronize(dev)
    return t0.elapsed_time(t1) / rounds


def probe(groups: int = 65536, shape: str = "auto", rounds: int = 32,
          device=None) -> dict:
    """The segment table of one warmed bench engine."""
    from .benchlib import make_bench_engine

    dev = resolve_device(device)
    eng, props = make_bench_engine(groups, device=dev, deliver_shape=shape)
    # A steady state: proposals in flight and a populated inbox.
    eng.run_rounds(4, tick=True, propose_n=props)
    cfg = eng.cfg
    n, r = cfg.num_instances, cfg.num_replicas
    iids = torch.arange(n, dtype=I32, device=dev)
    slots = iids % r
    ids = step_mod.make_ids(iids, slots, r)
    senders = tuple(torch.full((n,), s, dtype=I32, device=dev)
                    for s in range(r))
    ones_b = torch.ones((n,), dtype=torch.bool, device=dev)
    zeros_b = torch.zeros((n,), dtype=torch.bool, device=dev)
    zeros_i = torch.zeros((n,), dtype=I32, device=dev)
    st, inbox = eng.state, eng.inbox
    # The round's outbox: emit's requests, then deliver's responses.
    _st, requests = step_mod._emit(cfg, ids, st)
    outbox = step_mod._stack_lanes(requests + step_mod._deliver_all(
        cfg, ids, st, inbox, senders)[1])
    phase_fns = {
        "deliver": lambda: step_mod._deliver_all(cfg, ids, st, inbox,
                                                 senders),
        "tick": lambda: step_mod._tick(cfg, ids, st, ones_b, zeros_b),
        "control": lambda: step_mod._control(cfg, ids, st, zeros_i,
                                             zeros_b),
        "propose": lambda: step_mod._propose(cfg, ids, st, props),
        "emit": lambda: step_mod._emit(cfg, ids, st),
        "route": lambda: step_mod.route(cfg, outbox),
        "pack_outbox": lambda: step_mod.pack_outbox(outbox, slots),
    }
    seg_ms = {}
    for name, fn in phase_fns.items():
        # jitlint: waive(sync-in-loop) -- each segment is timed on its own: its fences are the measurement
        seg_ms[name] = _time_calls(fn, rounds, dev)
        print(f"{name}: {seg_ms[name]:.4f} ms", file=sys.stderr, flush=True)
    captures = eng.captures
    # The full round: the engine's own graph (captured by the setup).
    full_ms = _time_full(eng, props, rounds, dev)
    if dev.type == "cuda" and eng.captures != captures:
        raise AssertionError("the full round captured anew")
    scopes = dict(step_mod.ROUND_PHASE_SCOPES)
    total = sum(seg_ms.values())
    return {
        "metric": "round_segment_attribution",
        "device": device_label(dev),
        "timer": ("CUDA events around graph replays" if dev.type == "cuda"
                  else "host clock around eager calls (cpu)"),
        "config": (f"G={groups} R={r} W={cfg.window} "
                   f"E={cfg.max_ents_per_msg} deliver={cfg.deliver_shape}"),
        "rounds_per_segment": rounds,
        "segments": [{"segment": name, "scope": scopes.get(name, name),
                      "ms": ms, "pct_of_segments": 100 * ms / total}
                     for name, ms in seg_ms.items()],
        "segments_sum_ms": total,
        "full_round_graphed_ms": full_ms,
        "note": ("segments timed as isolated graphs (eagerly on the cpu) "
                 "over the same live state; the sum is an attribution "
                 "baseline, not a wall-time identity"),
        "captured_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "captured_by": "etcd_tpu_torch/tools/phaseprobe.py",
    }


def _time_full(eng, props, rounds: int, dev) -> float:
    """Milliseconds a full round: graph replays between two CUDA events
    (eager rounds on the host clock on the CPU)."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        eng.run_rounds(rounds, tick=True, propose_n=props)
        return (time.perf_counter() - t0) * 1e3 / rounds
    eng.run_rounds(1, tick=True, propose_n=props)
    torch.cuda.synchronize(dev)
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    eng.run_rounds(rounds, tick=True, propose_n=props)
    t1.record()
    torch.cuda.synchronize(dev)
    return t0.elapsed_time(t1) / rounds


def table(result: dict) -> str:
    lines = [f"Config: `{result['config']}` on {result['device']}, "
             f"{result['rounds_per_segment']} timed calls a segment; full "
             f"graphed round {result['full_round_graphed_ms']:.4f} ms.", "",
             "| segment | label | ms | % of segments |", "|---|---|---|---|"]
    for s in result["segments"]:
        lines.append(f"| {s['segment']} | {s['scope']} | {s['ms']:.4f} "
                     f"| {s['pct_of_segments']:.1f} |")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python3 -m etcd_tpu_torch.tools.phaseprobe",
        description="per-phase device round attribution")
    ap.add_argument("--groups", type=int, default=65536)
    ap.add_argument("--deliver-shape",
                    choices=("auto", "lanes", "merged", "vectorized"),
                    default="auto")
    ap.add_argument("--rounds", type=int, default=32)
    ap.add_argument("--out", default="", help="also write the JSON here")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"phaseprobe: {e}") from None
    result = probe(args.groups, args.deliver_shape, args.rounds, dev)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
            f.write("\n")
    print(table(result))


if __name__ == "__main__":
    main()
