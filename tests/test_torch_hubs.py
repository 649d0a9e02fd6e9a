"""PyTorch port ↔ JAX reference: the host pieces the hosting layer
imports — the telemetry hub and its metric families, the fleet hub, the
tracer with its export and merge, the membership store, failpoints,
shared errors, the WAL binding, the snapshotter and the wire codec.

Each is a copy of etcd_tpu's module. The copies are pinned two ways:
their code (the syntax tree with docstrings dropped) equals the
reference's, and the same seeded inputs through both packages give
equal records, metric text, rollups, spans, traces, masks and bytes.
None of these modules touches JAX or torch, so nothing here compiles.
"""

import ast
import json
import os

import numpy as np
import pytest

from etcd_tpu.batched import membership as jmem
from etcd_tpu.batched import telemetry as jtel
from etcd_tpu.obs import export as jexp
from etcd_tpu.obs import fleet as jfleet
from etcd_tpu.obs import merge as jmerge
from etcd_tpu.obs import tracer as jtr
from etcd_tpu.pkg import errors as jerr
from etcd_tpu.pkg import failpoint as jfp
from etcd_tpu.pkg import metrics as jmet
from etcd_tpu.raft import types as jtypes
from etcd_tpu_torch.batched import membership as tmem
from etcd_tpu_torch.batched import telemetry as ttel
from etcd_tpu_torch.obs import export as texp
from etcd_tpu_torch.obs import fleet as tfleet
from etcd_tpu_torch.obs import merge as tmerge
from etcd_tpu_torch.obs import tracer as ttr
from etcd_tpu_torch.pkg import errors as terr
from etcd_tpu_torch.pkg import failpoint as tfp
from etcd_tpu_torch.pkg import metrics as tmet
from etcd_tpu_torch.raft import types as ttypes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Modules the port copies whole from etcd_tpu (same relative path).
COPIES = ("batched/telemetry.py", "batched/membership.py",
          "obs/__init__.py", "obs/artifacts.py", "obs/fleet.py",
          "obs/tracer.py", "obs/export.py", "obs/merge.py",
          "pkg/failpoint.py", "pkg/errors.py", "pkg/metrics.py",
          "native/walog.py", "storage/snap.py", "transport/codec.py")


def code_of(path: str) -> str:
    """The module's syntax tree, docstrings dropped (comments are not
    in the tree): what the module does, not how it is described."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef))
                and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_the_reference_code(rel):
    assert code_of(os.path.join(ROOT, "etcd_tpu_torch", rel)) == code_of(
        os.path.join(ROOT, "etcd_tpu", rel)), rel


def strip_t(x):
    """Drop wall-clock stamps ("t", "captured_at") from nested records."""
    if isinstance(x, dict):
        return {k: strip_t(v) for k, v in x.items()
                if k not in ("t", "captured_at")}
    if isinstance(x, list):
        return [strip_t(v) for v in x]
    return x


# -- the telemetry hub ---------------------------------------------------------------


def test_telemetry_hub_records_and_metric_text(tmp_path):
    """Seeded frames (sparse counters, a few invariant trips) through
    ingest_round and ingest_totals of each package's hub, on a registry
    of its own: equal records, trips, metric text and flight-recorder
    dump; every metric family of the module registers the same text."""
    rng = np.random.default_rng(9)
    n = 24
    hubs = {}
    for name, tel, met in (("jax", jtel, jmet), ("torch", ttel, tmet)):
        reg = met.Registry()
        hubs[name] = (tel.TelemetryHub(n, member="m1", registry=reg,
                                       shards=4, dump_on_trip=False,
                                       dump_dir=str(tmp_path / name)), reg)
    totals = np.zeros((n, ttel.NUM_COUNTERS), np.int64)
    inv_tot = np.zeros(n, np.int64)
    for rnd in range(12):
        counters = rng.integers(0, 4, (n, ttel.NUM_COUNTERS)) * (
            rng.random((n, ttel.NUM_COUNTERS)) < 0.2)
        inv = np.where(rng.random(n) < 0.05,
                       rng.integers(1, 1 << len(ttel.INV_NAMES), n), 0)
        totals += counters
        inv_tot |= inv
        for hub, _reg in hubs.values():
            if rnd % 2:
                hub.ingest_round(counters, inv, extra={"rnd": rnd})
            else:
                hub.ingest_totals(totals, inv_tot)
    (jh, jreg), (th, treg) = hubs["jax"], hubs["torch"]
    assert strip_t(th.records()) == strip_t(jh.records())
    assert th.trips() == jh.trips() > 0
    for tel, reg in ((jtel, jreg), (ttel, treg)):
        for fam in ("wal_fsync_histogram", "wal_pipeline_depth_gauge",
                    "round_phase_histogram", "fenced_groups_gauge",
                    "joint_groups_gauge", "disk_fault_failstop_counter",
                    "disk_full_gauge", "router_loss_counter",
                    "shm_ring_depth_gauge", "apply_plane_slots_gauge",
                    "apply_plane_leases_gauge",
                    "apply_plane_overflow_gauge",
                    "apply_plane_watch_events_counter",
                    "apply_plane_reads_counter"):
            getattr(tel, fam)(reg)
    assert treg.expose() == jreg.expose()
    dumps = [json.load(open(h.dump(reason="test"))) for h, _ in
             (hubs["jax"], hubs["torch"])]
    assert strip_t(dumps[1]) == strip_t(dumps[0])
    assert os.path.basename(th.last_dump).startswith("flightrec_")


# -- the fleet hub ---------------------------------------------------------------------


def test_fleet_hub_rollups():
    """Seeded SummaryFrames (one top-K row frozen long enough to raise
    commit_frozen, a skewed leader census) and slow fsyncs through each
    package's FleetHub: equal rollups, anomalies, records and metric
    text."""
    rng = np.random.default_rng(4)
    g, r = 64, 3
    lay = tfleet.FleetLayout(g, r, g)
    hubs = {}
    for name, fl, met in (("jax", jfleet, jmet), ("torch", tfleet, tmet)):
        reg = met.Registry()
        hubs[name] = (fl.FleetHub(g, r, g, member="2", registry=reg,
                                  freeze_frames=3, limp_ms=5.0,
                                  limp_ops=2), reg)
    for i in range(10):
        vec = np.zeros(lay.size, np.int64)
        for name, _l, _a in lay.fields:
            s, e = lay.offsets[name]
            vec[s:e] = rng.integers(0, 40, e - s)
        s, _ = lay.offsets["leader_slot"]
        vec[s:s + r] = (60, 2, 2)
        s, _ = lay.offsets["top_group"]
        vec[s] = 7
        s, _ = lay.offsets["top_commit"]
        vec[s] = 100  # frozen: never moves
        s, _ = lay.offsets["top_lag"]
        vec[s] = 50
        for hub, _reg in hubs.values():
            if i % 3 == 2:
                hub.ingest_totals(vec)
            else:
                hub.ingest_round(vec)
            hub.observe_fsync(0.02 if i < 6 else 0.001)
    (jh, jreg), (th, treg) = hubs["jax"], hubs["torch"]
    assert strip_t(th.snapshot()) == strip_t(jh.snapshot())
    assert th.anomalies() == jh.anomalies()
    assert {"commit_frozen", "leader_skew", "member_limping"} <= set(
        th.anomalies())
    assert strip_t(th.anomaly_log()) == strip_t(jh.anomaly_log())
    assert strip_t(th.records()) == strip_t(jh.records())
    assert th.frames() == jh.frames() == 10
    assert treg.expose() == jreg.expose()


# -- the tracer, export and merge --------------------------------------------------


def stamped_tracers(pkg_tracer, met):
    """Three members' tracers with the same stamps at fixed instants:
    member 1 is the origin (propose .. apply), 2 and 3 are peers."""
    ms = 1_000_000
    out = []
    for m in ("1", "2", "3"):
        tr = pkg_tracer.Tracer(member=m, sample=2, seed=5,
                               registry=met.Registry(), ring=6)
        shift = {"1": 0, "2": 4 * ms, "3": -2 * ms}[m]
        keys = [(g, 3, i) for g in range(3) for i in range(1, 9)
                if tr.sampled(g, i)]
        stages = (("propose", "stage", "dispatch", "extract", "fsync_wait",
                   "fsync", "send", "commit", "apply") if m == "1" else
                  ("extract", "fsync_wait", "fsync", "send"))
        for k, stage in enumerate(stages):
            t = (k + (0 if m == "1" else 7)) * ms + shift
            tr.stamp_many(keys, stage, t)
        tr.stamp(9, 3, 1, "extract", 5 * ms)  # an open peer fragment
        out.append(tr)
    return out


def test_tracer_spans_export_and_merge():
    """Equal sampling decisions, spans (ring eviction and open fragments
    included), drop counts, chrome traces, validation and merge output
    (offsets, hop stats, markdown) from each package's modules."""
    keys_g = np.arange(40) % 5
    keys_i = np.arange(40) + 3
    want = jtr.Tracer(sample=4, seed=11).sampled_arr(keys_g, keys_i)
    got = ttr.Tracer(sample=4, seed=11).sampled_arr(keys_g, keys_i)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    jt = stamped_tracers(jtr, jmet)
    tt = stamped_tracers(ttr, tmet)
    payloads = {}
    for name, trs in (("jax", jt), ("torch", tt)):
        payloads[name] = [{**tr.to_payload(), "monotonic_ns": 0,
                           "wall_ns": 0} for tr in trs]
    assert payloads["torch"] == payloads["jax"]
    assert [tr.span_count() for tr in tt] == [tr.span_count() for tr in jt]
    pj, pt = payloads["jax"], payloads["torch"]
    trace_j, trace_t = jexp.chrome_trace(pj), texp.chrome_trace(pt)
    assert trace_t == trace_j
    assert texp.validate_chrome_trace(trace_t) == (
        jexp.validate_chrome_trace(trace_j))
    (mt, st), (mj, sj) = tmerge.merge(pt), jmerge.merge(pj)
    assert mt == mj and st == sj
    assert tmerge.estimate_offsets(pt) == jmerge.estimate_offsets(pj)
    assert tmerge.hops_markdown(st) == jmerge.hops_markdown(sj)
    assert ttr.make_tracer("1", enabled=False) is None
    assert isinstance(ttr.make_tracer("1", enabled=True,
                                      registry=tmet.Registry()), ttr.Tracer)


# -- the membership store -------------------------------------------------------------


def conf_sequence(types):
    """A joint conf-change sequence on group 0 and simple changes on
    group 1, as (group, index, ConfChangeV2) of `types`' classes."""
    single, v2 = types.ConfChangeSingle, types.ConfChangeV2
    cct = types.ConfChangeType
    joint = types.ConfChangeTransition.ConfChangeTransitionJointExplicit
    return [
        (0, 4, v2(transition=joint, changes=[
            single(type=cct.ConfChangeRemoveNode, node_id=3),
            single(type=cct.ConfChangeAddLearnerNode, node_id=3)])),
        (0, 5, v2(transition=joint, changes=[
            single(type=cct.ConfChangeAddNode, node_id=2)])),
        (0, 6, v2()),                                   # leave joint
        (0, 6, v2()),                                   # stale replay
        (1, 3, v2(changes=[single(type=cct.ConfChangeRemoveNode,
                                  node_id=1)])),
        (1, 4, v2(changes=[single(type=cct.ConfChangeRemoveNode,
                                  node_id=2)])),
        (1, 5, v2(changes=[single(type=cct.ConfChangeRemoveNode,
                                  node_id=3)])),          # zero voters
        (1, 7, v2(changes=[single(type=cct.ConfChangeAddNode,
                                  node_id=1)])),
    ]


def test_group_conf_store_masks():
    """The same joint conf-change sequence through each package's
    GroupConfStore: equal results, device masks, conf states, histories
    and WAL records after every apply; decode_conf_entry and the record
    dtype agree; a store loaded from the other package's record equals
    it."""
    stores = {"jax": jmem.GroupConfStore(3, 3),
              "torch": tmem.GroupConfStore(3, 3)}
    rows = np.arange(3)
    seqs = {"jax": conf_sequence(jtypes), "torch": conf_sequence(ttypes)}
    for step, (jc, tc) in enumerate(zip(seqs["jax"], seqs["torch"])):
        res = [stores[p].apply(*c) for p, c in (("jax", jc), ("torch", tc))]
        assert res[0] == res[1], step
        for w, g in zip(stores["jax"].masks(rows),
                        stores["torch"].masks(rows)):
            assert g.dtype == w.dtype and np.array_equal(g, w), step
        for grp in range(3):
            assert (str(stores["torch"].conf_state(grp))
                    == str(stores["jax"].conf_state(grp))), step
            assert stores["torch"].history(grp) == (
                stores["jax"].history(grp))
        assert stores["torch"].pack_groups(rows) == (
            stores["jax"].pack_groups(rows))
    assert stores["torch"].refused == stores["jax"].refused > 0
    assert tmem.conf_record_dtype(5) == jmem.conf_record_dtype(5)
    cc = seqs["torch"][0][2]
    data = cc.marshal()
    assert str(tmem.decode_conf_entry(
        data, int(ttypes.EntryType.EntryConfChangeV2))) == str(
        jmem.decode_conf_entry(data, int(jtypes.EntryType.EntryConfChangeV2)))
    loaded = tmem.GroupConfStore(3, 3)
    for row in jmem.GroupConfStore.unpack_groups(
            stores["jax"].pack_groups(rows), 3):
        loaded.load_record(*row)
    for w, g in zip(stores["jax"].masks(rows), loaded.masks(rows)):
        assert np.array_equal(g, w)


# -- failpoints and shared errors ---------------------------------------------------


def test_failpoints_and_errors():
    """Each package's failpoint registry takes the same actions with the
    same effects and counts; the shared error classes keep their
    names."""
    outcomes = {}
    for name, fp in (("jax", jfp), ("torch", tfp)):
        fp.disable_all()
        seen = []
        fp.enable("a", "error")
        fp.enable("b", "sleep(1)")
        fp.enable("c", lambda: seen.append("c"))
        fp.enable("d", "panic")
        got = []
        for site in ("a", "b", "c", "d", "e"):
            try:
                fp.fp(site)
                got.append("ok")
            except fp.FailpointError:
                got.append("error")
            except fp.FailpointPanic:
                got.append("panic")
        fp.disable("a")
        fp.fp("a")
        outcomes[name] = (got, seen, sorted(fp.status()),
                          [fp.hits(s) for s in "abcde"])
        fp.disable_all()
    assert outcomes["torch"] == outcomes["jax"]
    assert outcomes["torch"][0] == ["error", "ok", "ok", "panic", "ok"]
    for cls in ("NotLeaderError", "LearnerNotReadyError"):
        assert getattr(terr, cls).__name__ == getattr(jerr, cls).__name__
        assert issubclass(getattr(terr, cls), Exception)
