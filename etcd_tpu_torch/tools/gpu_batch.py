"""One measurement batch of the engine on the card, every open question
in one run.

Ports ``etcd_tpu/tools/tpu_batch.py``, section for section:

  (a) the headline rate at G=65,536 (the bench config, the package's
      deliver shape, serial graph replays);
  (b) the deliver-shape A/B: each other shape (``--deliver-shape``,
      default lanes and merged) against (a)'s;
  (c) each Hopper kernel form of the main path against its plain
      version, equal and timed (``kernel_times.main_path_forms``,
      ``time_form``), in a process of its own;
  (d) the device-side commit p50: rounds to commit counted by stepping
      single rounds, priced at (a)'s wall time per round, beside the
      bench's wall-clock commit p50;
  (e) a ``torch.profiler`` trace of the steady round: eager rounds,
      whose phases open ranges named after ``step.ROUND_PHASE_SCOPES``
      (device time per phase), then graph replays (device time per
      kernel). On the card a profile that records no device time
      raises; the trace is written beside the JSON.

Writes ``<out>/batch.json`` with every number and its provenance (the
card's name and power limit) and ``<out>/round_trace.json``.

    python3 -m etcd_tpu_torch.tools.gpu_batch --out DIR [--groups 65536]
        [--device cpu]

It runs on the GPU unless called with ``--device cpu`` (then (c) is not
measured: the kernels run only on the card); without CUDA and with no
device named it exits with an error and writes nothing. Unlike the JAX
tool, no section is best-effort: a section that fails fails the batch.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

from ..analysis.sentinels import CompileBudget
from ..batched.state import resolve_device
from .bench import device_label
from .benchlib import make_bench_engine, measure_commit_p50, measure_rate

ROUNDS_PER_CALL, CALLS = 16, 8
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _log(msg: str) -> None:
    print(f"[gpu_batch {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def _sync(eng) -> None:
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)


def _engine(groups: int, shape: str, device):
    t0 = time.perf_counter()
    eng, props = make_bench_engine(groups, device=device,
                                   deliver_shape=shape)
    _sync(eng)
    return eng, props, time.perf_counter() - t0


def rounds_to_commit(eng, limit: int = 10) -> "tuple[int, bool]":
    """Rounds from a quiet-point proposal (one per leader) until every
    group's leader commits it, counted with single rounds; and whether
    `limit` ran out first."""
    r = eng.cfg.num_replicas
    one = torch.zeros((eng.cfg.num_instances,), dtype=torch.int32,
                      device=eng.device)
    one[::r] = 1
    eng.run_rounds(1, tick=False, propose_n=one)
    eng.run_rounds(4, tick=False)
    base = eng.commits()[:, 0].min()
    eng.run_rounds(1, tick=False, propose_n=one)
    rounds = 1
    # jitlint: waive(sync-in-loop) -- the count IS the measurement: one read of the commits a round, until the proposal commits
    while eng.commits()[:, 0].min() <= base and rounds < limit:
        eng.run_rounds(1, tick=False)
        rounds += 1
    return rounds, bool(eng.commits()[:, 0].min() <= base)


def _busy_us(evt, labels) -> float:
    """Device busy time of the kernels a range launched: its own and
    its children's, without the device-side span of a range (a
    user annotation, which counts the gaps between kernels too)."""
    return (sum(k.duration for k in evt.kernels if k.name not in labels)
            + sum(_busy_us(ch, labels) for ch in evt.cpu_children))


def profile_round(eng, props, rounds: int, trace_path: str) -> dict:
    """Section (e): `rounds` eager rounds (their phase ranges) and
    `rounds` graph replays under torch.profiler, started and stopped
    under the device lock (graph.device_work); the trace goes to
    `trace_path`. Per phase label: device and host ms a round; per
    kernel of the whole session: device ms a round. The engine runs
    3 x 2 x `rounds` rounds at most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..batched.graph import device_work
    from ..batched.step import ROUND_PHASE_SCOPES
    from .kernel_times import _device_us, kernel_events

    cuda = eng.device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    # A session that records no device work is taken again, up to three
    # times: a process's first session has been seen to come back empty.
    for _ in range(3):
        with device_work():
            with profile(activities=acts) as prof:
                for _ in range(rounds):
                    eng.step_round(tick=True, propose_n=props)
                eng.run_rounds(rounds, tick=True, propose_n=props)
                # jitlint: waive(sync-in-loop) -- the fence that closes a profiler session: one a session, the measurement itself
                _sync(eng)
        events = kernel_events(prof) if cuda else []
        if events or not cuda:
            break
    else:
        raise RuntimeError("the profiler recorded no device time")
    prof.export_chrome_trace(trace_path)
    labels = {label: name for name, label in ROUND_PHASE_SCOPES}
    sums = {}
    for evt in prof.events():
        if evt.name in labels and evt.device_type == DeviceType.CPU:
            acc = sums.setdefault(labels[evt.name], [evt.name, 0, 0.0, 0.0])
            acc[1] += 1
            acc[2] += _busy_us(evt, labels)
            acc[3] += evt.cpu_time_total
    # A phase runs once an eager round (on the CPU the graphed rounds
    # are eager too): per range is per round.
    phases = {name: {"label": label, "rounds": n,
                     "device_ms_per_round": dev_us / 1e3 / n,
                     "host_ms_per_round": host_us / 1e3 / n}
              for name, (label, n, dev_us, host_us) in sums.items()}
    missing = sorted(set(labels.values()) - set(phases))
    if missing:
        raise RuntimeError(f"the profile holds no range for {missing}")
    out = {"trace": trace_path, "rounds_eager": rounds,
           "rounds_graphed": rounds, "phases": phases}
    if cuda:
        out["device_ms_per_round"] = sum(
            _device_us(e) for e in events) / 1e3 / (2 * rounds)
        out["top_kernels"] = [
            {"name": e.key[:90], "calls": e.count,
             "device_ms": _device_us(e) / 1e3}
            for e in sorted(events, key=lambda e: -_device_us(e))[:12]]
    return out


def kernel_forms(dev) -> list:
    """Section (c): every main-path form against its plain version, on
    the same inputs, then timed (kernel_times)."""
    from . import kernel_times as kt

    rows = []
    for form in kt.main_path_forms(dev):
        got, want = form["call"](), form["plain"]()
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        if not all(map(torch.equal, got, want)):
            raise AssertionError(f"{form['key']}: kernel != plain form")
        # jitlint: waive(sync-in-loop) -- each form is timed on its own; its fences are the measurement
        rows.append(kt.time_form(form))
    return rows


def kernel_forms_in_a_fresh_process(dev) -> list:
    """kernel_forms in a process of its own: the profiler's records have
    been seen to come back short, or empty, late in a long process."""
    out = subprocess.run(
        [sys.executable, "-m", "etcd_tpu_torch.tools.gpu_batch",
         "--kernel-forms", "--device", str(dev)],
        capture_output=True, text=True, timeout=900, cwd=ROOT, check=False)
    if out.returncode != 0:
        raise RuntimeError(f"kernel forms failed (rc={out.returncode}):\n"
                           f"{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def run(out_dir: str, groups: int = 65536, shapes=("lanes", "merged"),
        device=None, rounds_per_call: int = ROUNDS_PER_CALL,
        calls: int = CALLS, profile_rounds: int = 4) -> dict:
    """Every section; writes `out_dir`/batch.json after each and
    returns the result."""
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    result: dict = {"device": device_label(dev), "groups": groups,
                    "torch": torch.__version__,
                    "captured_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
                    "captured_by": "etcd_tpu_torch/tools/gpu_batch.py"}

    def flush() -> None:
        with open(os.path.join(out_dir, "batch.json"), "w") as f:
            json.dump(result, f, indent=2)
            f.write("\n")

    # (a) the headline.
    eng, props, setup_s = _engine(groups, "auto", dev)
    budget = CompileBudget(0)
    rate = measure_rate(eng, props, rounds_per_call, calls, budget=budget)
    if eng.commits().min() <= 0:
        raise AssertionError("(a): a group committed nothing")
    result["a_headline"] = {
        "rate_group_rounds_per_s": rate, "setup_s": setup_s,
        "config": (f"G={groups} R=3 W=32 E=4 P=2 "
                   f"deliver={eng.cfg.deliver_shape}"),
        "rounds_per_call": rounds_per_call, "calls": calls,
        "captures": eng.captures,
        "captures_after_warmup": budget.misses()}
    _log(f"(a) {eng.cfg.deliver_shape}: {rate:,.0f} group-rounds/s")
    flush()

    # (c) the kernel forms.
    result["c_kernels"] = (kernel_forms_in_a_fresh_process(dev)
                           if dev.type == "cuda" else
                           "not measured: the kernels run only on the card")
    flush()

    # (d) commit p50, priced per round.
    n_rounds, timed_out = rounds_to_commit(eng)
    per_round_s = groups / rate
    wall_ms, wall_rounds = measure_commit_p50(eng)
    result["d_commit_p50"] = {
        "rounds_to_commit": n_rounds, "timed_out": timed_out,
        "per_round_us": per_round_s * 1e6,
        "commit_p50_us_device_side": n_rounds * per_round_s * 1e6,
        "commit_p50_ms_wall": wall_ms, "commit_p50_rounds_wall": wall_rounds,
        "note": "round count from single-round stepping, priced at (a)'s "
                "steady wall time a round; beside it the bench's "
                "wall-clock p50 of single rounds"}
    if timed_out:
        raise AssertionError("(d): the proposal did not commit in 10 rounds")
    flush()

    # (e) the profiled steady round.
    result["e_profile"] = profile_round(
        eng, props, profile_rounds, os.path.join(out_dir, "round_trace.json"))
    flush()
    headline_shape = eng.cfg.deliver_shape
    del eng, props

    # (b) the deliver-shape A/B.
    for shape in shapes:
        if shape == headline_shape:
            continue
        # jitlint: waive(sync-in-loop) -- one engine a shape, built and measured on its own: its fences are the measurement
        result[f"b_deliver_{shape}"] = deliver_ab(
            groups, shape, dev, rate, rounds_per_call, calls)
        _log(f"(b) {shape}: {result[f'b_deliver_{shape}']['vs_headline']:.2f}"
             f"x {headline_shape}")
        flush()
    return result


def deliver_ab(groups: int, shape: str, dev, headline_rate: float,
               rounds_per_call: int, calls: int) -> dict:
    """Section (b) for one shape: its engine's rate against the
    headline's."""
    eng, props, setup_s = _engine(groups, shape, dev)
    budget = CompileBudget(0)
    rate = measure_rate(eng, props, rounds_per_call, calls, budget=budget)
    if eng.commits().min() <= 0:
        raise AssertionError(f"(b) {shape}: a group committed nothing")
    return {"rate_group_rounds_per_s": rate, "setup_s": setup_s,
            "vs_headline": rate / headline_rate,
            "captures_after_warmup": budget.misses()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python3 -m etcd_tpu_torch.tools.gpu_batch")
    ap.add_argument("--groups", type=int, default=65536)
    ap.add_argument("--out", default="", help="directory to write")
    ap.add_argument("--kernel-forms", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--deliver-shape", default="lanes,merged",
                    help="comma-separated shapes to A/B against the "
                         "headline (section b)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"gpu_batch: {e}") from None
    if args.kernel_forms:  # section (c)'s process
        print(json.dumps(kernel_forms(dev)))
        return
    if not args.out:
        ap.error("--out is required")
    shapes = tuple(s.strip() for s in args.deliver_shape.split(",")
                   if s.strip())
    result = run(args.out, args.groups, shapes, dev)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
