"""Linearizable read latency on each member of an in-process hosting
cluster, as chip_smoke's `hosting` phase builds it.

Three MultiRaftMembers of G groups (1,024 with CUDA, else 64) at the
phase's config and tick (0.02 s with CUDA, else 0.06), leaders balanced
(group g led by member g % 3 + 1), 3,000 puts through the phase's put
loop (200 on the CPU), optionally a second wave of one put per group
under the profiler as the phase makes it; then sequential
linearizable_gets of acked keys, each on its group's leader, for
SECONDS, each equal to the acked value. Prints each member's rounds a
second before and after the reads and, per member, the reads' count,
p50, p99, max and count over 3 s.

With --dump-after S a read waits S seconds; one not confirmed by then
is printed with the group's device read state and the member's host
read bookkeeping, again once its batch confirms (10 s at most), and
with the seconds a fresh read on the same member then takes.

Run from the repository root (it imports chip_smoke.py):

    python3 -m etcd_tpu_torch.tools.hosting_reads SECONDS [--profile]
        [--dump-after S]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

READ_FIELDS = ("role", "term", "commit", "last", "snap_index", "read_seq",
               "read_index", "read_ready", "read_req_latch", "read_acks",
               "transferee", "lease_ticks")


def read_state(m, g: int) -> dict:
    """Member m's read state of group g: the device's, read under the
    device lock, and the host's."""
    from ..batched.graph import device_work

    with device_work():
        out = {f: getattr(m.rn.state, f)[g].cpu().tolist()
               for f in READ_FIELDS}
    rn = m.rn
    out["host"] = {
        "opened": m._read_opened.get(g), "results": m._read_results.get(g),
        "applied": int(m.applied_index[g]),
        "seq_prev": int(rn._read_seq_prev[g]), "seen": int(rn._read_seen[g]),
        "staged": bool(rn._read_req[g]), "is_leader": bool(m.is_leader(g)),
        "rounds": m.stats["rounds"]}
    return out


def main() -> None:
    import chip_smoke as cs
    from ..batched import hopper_kernels as hk
    from ..batched import hosting
    from ..batched.graph import device_work
    from .. import native

    ap = argparse.ArgumentParser()
    ap.add_argument("seconds", type=float)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--dump-after", type=float, default=None)
    args = ap.parse_args()

    cuda = torch.cuda.is_available()
    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
    if cuda:
        hk.load_library()
        native.build("walog")
    groups = 1024 if cuda else 64
    cfg = cs.hosting_config(groups, telemetry=True, fleet_summary=True)
    router = hosting.InProcRouter()
    ms = []
    tmp = tempfile.mkdtemp(prefix="hosting-reads-")
    for mid in cs.MEMBERS:
        m = hosting.MultiRaftMember(mid, cs.R, groups, tmp, cfg=cfg,
                                    tick_interval=0.02 if cuda else 0.06,
                                    pipeline=True, device=dev)
        router.attach(m)
        ms.append(m)
    for m in ms:
        m.start()
    hosting.wait_group_leaders(lambda: ms, groups, timeout=180.0)
    print("misplaced", cs.balance_leaders(ms, groups, 60.0), flush=True)
    hosting.wait_group_leaders(lambda: ms, groups, timeout=60.0)
    puts = 3000 if cuda else 200
    value = b"v" * cs.HOSTING_VALUE
    acked = dict(cs.hosting_puts(ms, groups, puts, 0, value,
                                 cs.HOSTING_INFLIGHT, timeout=300.0)["acked"])
    if args.profile and cuda:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
        with device_work():
            prof.start()
        wave = cs.hosting_puts(ms, groups, groups, puts, value, 1,
                               timeout=120.0)
        with device_work():
            torch.cuda.synchronize(dev)
            prof.stop()
        acked.update(wave["acked"])
    print("acked", len(acked), flush=True)

    def rates(window: float = 5.0) -> dict:
        r0 = {m.id: m.stats["rounds"] for m in ms}
        time.sleep(window)
        return {m.id: (m.stats["rounds"] - r0[m.id]) / window for m in ms}

    print("rounds_per_s", json.dumps(rates()), flush=True)
    keys = list(acked)
    rng = np.random.RandomState(7)
    per = {m.id: [] for m in ms}
    t0 = time.time()
    while time.time() - t0 < args.seconds:
        g, k = keys[rng.randint(len(keys))]
        lead = cs.leader_of(ms, g)
        if lead is None:
            continue
        t = time.perf_counter()
        try:
            got = lead.linearizable_get(g, k, timeout=args.dump_after or 30.0)
        except TimeoutError as e:
            if args.dump_after is None:
                raise
            rec = {"g": g, "member": lead.id, "err": str(e),
                   # jitlint: waive(sync-in-loop) -- a diagnostic read of one timed-out group, once per timeout
                   "at_timeout": read_state(lead, g)}
            t1, res0 = time.perf_counter(), lead._read_results.get(g)
            while (time.perf_counter() - t1 < 10
                   and lead._read_results.get(g) == res0):
                time.sleep(0.01)
            rec["late_result_after_s"] = (
                time.perf_counter() - t1
                if lead._read_results.get(g) != res0 else None)
            # jitlint: waive(sync-in-loop) -- a diagnostic read of one timed-out group, once per timeout
            rec["after"] = read_state(lead, g)
            t2 = time.perf_counter()
            got = lead.linearizable_get(g, k, timeout=10.0)
            rec["fresh_read_s"] = time.perf_counter() - t2
            print("slow", json.dumps(rec), flush=True)
        if got != acked[(g, k)]:
            raise AssertionError(f"group {g}: read {got!r}")
        per[lead.id].append(time.perf_counter() - t)
    print("reads", json.dumps({
        mid: {"n": len(v), "p50_ms": float(np.percentile(v, 50)) * 1e3,
              "p99_ms": float(np.percentile(v, 99)) * 1e3,
              "max_ms": max(v) * 1e3, "over_3s": sum(x > 3 for x in v)}
        for mid, v in per.items() if v}), flush=True)
    print("rounds_per_s", json.dumps(rates()), flush=True)
    if cuda:
        print(cs.smi("name,power.limit"), flush=True)
    for m in ms:
        m.crash()
    os._exit(0)  # the members' threads are daemons of a crashed cluster


if __name__ == "__main__":
    main()
