"""Cross-member trace join + clock-offset estimation (library half
of ``tools/trace_merge.py`` — importable, so tools/hosted_bench.py can
build its SLO table in-process from the admin 'trace' payloads).

Spans are joined on ``(group, term, index)``; each member's
``monotonic_ns`` clock is its own epoch, so the merge first estimates
per-member clock offsets NTP-style from send/recv stamp pairs: for a
span originated on O with a peer fragment on P,

    forward  d_f = extract_P - send_O      (= offset_P +  net)
    backward d_b = commit_O  - send_P      (= -offset_P + net')

so ``offset_P ≈ (d_f - d_b) / 2`` per span; the estimator takes the
median over all shared spans (robust to the asymmetric processing time
baked into each direction). Members never directly paired fall back to
a BFS chain through members that are.

The hop table decomposes the commit path into named hops::

    enqueue_wait | stage | step | fsync_wait | fsync | send |
    net_to_peer | peer_fsync_wait | peer_fsync | peer_ack |
    ack_to_commit | apply

(``fsync_wait`` is the queue half — record build + time behind earlier
persistence waves, which the async WAL pipeline makes a real hop — and
``fsync`` the device half, stamped at the covering group-commit's
completion.) The hops telescope: their per-span sum equals the span's
propose→apply end-to-end exactly, so the table is a complete
decomposition of commit latency, not a sample of it.

Ports ``etcd_tpu/obs/merge.py`` whole; the port keeps its own copy and
tests/test_torch_hubs.py pins it equal.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from .export import chrome_trace

SpanKey = Tuple[int, int, int]

# Merged-timeline hop decomposition (origin stamps unless _P-suffixed).
HOPS = (
    ("enqueue_wait", "propose", "stage"),
    ("stage", "stage", "dispatch"),
    ("step", "dispatch", "extract"),
    ("fsync_wait", "extract", "fsync_wait"),
    ("fsync", "fsync_wait", "fsync"),
    ("send", "fsync", "send"),
    ("net_to_peer", "send", "extract_P"),
    ("peer_fsync_wait", "extract_P", "fsync_wait_P"),
    ("peer_fsync", "fsync_wait_P", "fsync_P"),
    ("peer_ack", "fsync_P", "send_P"),
    ("ack_to_commit", "send_P", "commit"),
    ("apply", "commit", "apply"),
)


def load_payload(path: str) -> Dict:
    with open(path) as f:
        obj = json.load(f)
    # Accept both a raw payload and the admin-op envelope.
    return obj.get("payload", obj)


def _index_spans(payloads: List[Dict]) -> Dict[SpanKey, Dict[str, Dict]]:
    """key -> member -> stages (first fragment per member wins)."""
    joined: Dict[SpanKey, Dict[str, Dict]] = defaultdict(dict)
    for p in payloads:
        member = str(p.get("member", "?"))
        for sp in p.get("spans", ()):
            key = (sp["group"], sp["term"], sp["index"])
            joined[key].setdefault(member, sp.get("stages", {}))
    return joined


def _origin(frags: Dict[str, Dict]) -> Optional[str]:
    """The member a span originated on (the one holding 'propose')."""
    for member, stages in frags.items():
        if "propose" in stages:
            return member
    return None


def _median(xs: List[float]) -> float:
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else (xs[n // 2 - 1] + xs[n // 2]) / 2


def estimate_offsets(payloads: List[Dict]) -> Dict[str, int]:
    """Per-member clock offset (ns, ADD to that member's stamps) onto
    the first payload's member clock."""
    members = [str(p.get("member", "?")) for p in payloads]
    joined = _index_spans(payloads)
    # Pairwise offset samples: est[(o, p)] = offset of p's clock
    # relative to o's (add to p to land on o). Round-trip samples
    # (both directions observed) are kept apart from coarse one-way
    # samples (which assume net≈0 and are biased LOW by the one-way
    # latency): a pair uses the coarse population only when it has no
    # round-trip evidence at all — in-flight spans dominate a chaos
    # dump, and mixing them in would drag the median by ~net.
    samples: Dict[Tuple[str, str], List[float]] = defaultdict(list)
    coarse: Dict[Tuple[str, str], List[float]] = defaultdict(list)
    for frags in joined.values():
        o = _origin(frags)
        if o is None:
            continue
        so = frags[o]
        if "send" not in so:
            continue
        for m, sm in frags.items():
            if m == o or "extract" not in sm:
                continue
            d_f = sm["extract"] - so["send"]
            if "send" in sm and "commit" in so:
                d_b = so["commit"] - sm["send"]
                samples[(o, m)].append(-(d_f - d_b) / 2)
            else:
                coarse[(o, m)].append(-d_f)
    edges: Dict[Tuple[str, str], float] = {}
    for pair, xs in coarse.items():
        if pair not in samples:
            samples[pair] = xs
    for (o, m), xs in samples.items():
        off = _median(xs)
        edges[(o, m)] = off
        edges.setdefault((m, o), -off)
    # BFS from the reference member through estimated edges.
    ref = members[0]
    offsets: Dict[str, float] = {ref: 0.0}
    frontier = [ref]
    while frontier:
        cur = frontier.pop()
        for (a, b), off in edges.items():
            if a == cur and b not in offsets:
                offsets[b] = offsets[cur] + off
                frontier.append(b)
    for m in members:
        offsets.setdefault(m, 0.0)  # unpaired: no evidence, assume 0
    return {m: int(v) for m, v in offsets.items()}


def _ack_peer(frags: Dict[str, Dict], origin: str,
              offsets: Dict[str, int]) -> Optional[Tuple[str, Dict]]:
    """The quorum-forming peer: among peers holding extract/fsync/send,
    the one whose (aligned) ack left earliest — with a 3-member quorum
    the commit was driven by the fastest ack, so that peer's stamps are
    the ones on the critical path."""
    best = None
    for m, s in frags.items():
        if m == origin:
            continue
        if not all(k in s
                   for k in ("extract", "fsync_wait", "fsync", "send")):
            continue
        t = s["send"] + offsets.get(m, 0)
        if best is None or t < best[0]:
            best = (t, m, s)
    return (best[1], best[2]) if best else None


def hop_stats(payloads: List[Dict],
              offsets: Optional[Dict[str, int]] = None) -> Dict:
    """Per-hop latency distribution over the joined origin spans.

    The hop table is built from the FULLY-decomposed span subset
    (origin propose→apply complete AND a peer ack triple present):
    every hop then draws from the identical span population, so the
    per-span hop vectors telescope to that population's e2e exactly
    and the summed hop p50s track the e2e p50 tightly — a table where
    each hop samples whichever spans happen to carry its endpoints
    drifts from the e2e it claims to decompose. When nothing fully
    decomposes (single-member dump, all spans in flight) the table
    falls back to per-hop-available sampling, flagged by
    ``hops_population: "partial"``."""
    if offsets is None:
        offsets = estimate_offsets(payloads)
    joined = _index_spans(payloads)
    per_hop: Dict[str, List[float]] = defaultdict(list)
    partial_hop: Dict[str, List[float]] = defaultdict(list)
    e2e: List[float] = []
    e2e_commit: List[float] = []
    n_origin = 0
    n_decomposed = 0
    for frags in joined.values():
        o = _origin(frags)
        if o is None:
            continue
        n_origin += 1
        off_o = offsets.get(o, 0)
        st = {k: v + off_o for k, v in frags[o].items()}
        peer = _ack_peer(frags, o, offsets)
        if peer is not None:
            m, s = peer
            off_p = offsets.get(m, 0)
            for k in ("extract", "fsync_wait", "fsync", "send"):
                st[k + "_P"] = s[k] + off_p
        full = all(a in st and b in st for _n, a, b in HOPS)
        if full:
            n_decomposed += 1
        for name, a, b in HOPS:
            if a in st and b in st:
                dt_ms = (st[b] - st[a]) / 1e6
                partial_hop[name].append(dt_ms)
                if full:
                    per_hop[name].append(dt_ms)
        if "propose" in st and "apply" in st:
            e2e.append((st["apply"] - st["propose"]) / 1e6)
        if "propose" in st and "commit" in st:
            e2e_commit.append((st["commit"] - st["propose"]) / 1e6)
    hops_population = "decomposed"
    if n_decomposed == 0:
        per_hop = partial_hop
        hops_population = "partial"

    def dist(xs: List[float]) -> Dict[str, float]:
        if not xs:
            return {}
        xs = sorted(xs)
        pick = lambda q: xs[min(int(len(xs) * q), len(xs) - 1)]  # noqa: E731
        return {
            "n": len(xs),
            "p50_ms": round(pick(0.50), 3),
            "p90_ms": round(pick(0.90), 3),
            "p99_ms": round(pick(0.99), 3),
            "mean_ms": round(sum(xs) / len(xs), 3),
        }

    hops = {name: dist(per_hop[name]) for name, _a, _b in HOPS
            if per_hop[name]}
    hop_p50_sum = round(sum(d["p50_ms"] for d in hops.values()), 3)
    out = {
        "spans_joined": len(joined),
        "spans_origin": n_origin,
        "spans_peer_decomposed": n_decomposed,
        "hops_population": hops_population,
        "clock_offsets_ns": {str(k): int(v) for k, v in offsets.items()},
        "hops": hops,
        "hop_p50_sum_ms": hop_p50_sum,
        "e2e_apply": dist(e2e),
        "e2e_commit": dist(e2e_commit),
    }
    # Coverage compares the hop p50 sum against the e2e p50 of the
    # SAME population the table was built from: for the decomposed
    # subset each span's hop vector sums to its propose→apply exactly,
    # so the per-span totals ARE that subset's e2e and only
    # sum-of-p50s vs p50-of-sums aggregation slack remains.
    if hops_population == "decomposed" and hops:
        totals = [sum(v) for v in zip(*(per_hop[name] for name in hops))]
        out["e2e_decomposed"] = dist(totals)
        p50_pop = out["e2e_decomposed"]["p50_ms"]
        out["hop_coverage_of_e2e_p50"] = (
            round(hop_p50_sum / p50_pop, 3) if p50_pop > 0 else 1.0)
        # The commit decomposition proper: per span, the hops up to
        # ack_to_commit telescope to propose→commit EXACTLY, so under
        # means the sum of parts IS the whole (the identity the table
        # exists for). Under p50s the sum can undershoot: spans whose
        # totals are pinned by wave scheduling split a near-constant
        # budget differently across hops (anti-correlated shares), and
        # sum-of-medians < median-of-sums. Both are reported; budget
        # reading uses the p50 column, completeness uses the means.
        commit_hops = [n for n in hops if n != "apply"]
        c_totals = [sum(v) for v in zip(
            *(per_hop[name] for name in commit_hops))]
        mean_sum = sum(
            sum(per_hop[n]) / len(per_hop[n]) for n in commit_hops)
        c_mean = sum(c_totals) / len(c_totals)
        c_p50 = dist(c_totals)["p50_ms"]
        c_p50_sum = sum(hops[n]["p50_ms"] for n in commit_hops)
        out["commit_decomposition"] = {
            "hop_mean_sum_ms": round(mean_sum, 3),
            "e2e_commit_mean_ms": round(c_mean, 3),
            "coverage_of_commit_mean": (
                round(mean_sum / c_mean, 3) if c_mean > 0 else 1.0),
            "hop_p50_sum_ms": round(c_p50_sum, 3),
            "e2e_commit_p50_ms": c_p50,
            "coverage_of_commit_p50": (
                round(c_p50_sum / c_p50, 3) if c_p50 > 0 else 1.0),
        }
    elif e2e:
        p50 = out["e2e_apply"]["p50_ms"]
        out["hop_coverage_of_e2e_p50"] = (
            round(hop_p50_sum / p50, 3) if p50 > 0 else 1.0)
    return out


def hops_markdown(stats: Dict) -> str:
    lines = [
        "| hop | n | p50 ms | p90 ms | p99 ms | mean ms |",
        "|---|---|---|---|---|---|",
    ]
    for name, _a, _b in HOPS:
        d = stats["hops"].get(name)
        if not d:
            continue
        lines.append(
            f"| {name} | {d['n']} | {d['p50_ms']} | {d['p90_ms']} "
            f"| {d['p99_ms']} | {d['mean_ms']} |")
    for label in ("e2e_commit", "e2e_apply"):
        d = stats.get(label)
        if d:
            lines.append(
                f"| **{label}** | {d['n']} | {d['p50_ms']} "
                f"| {d['p90_ms']} | {d['p99_ms']} | {d['mean_ms']} |")
    lines.append("")
    lines.append(
        f"hop p50 sum {stats['hop_p50_sum_ms']} ms; coverage of "
        f"e2e(apply) p50: {stats.get('hop_coverage_of_e2e_p50', 'n/a')}")
    cd = stats.get("commit_decomposition")
    if cd:
        lines.append(
            f"commit decomposition: hop mean sum "
            f"{cd['hop_mean_sum_ms']} ms = "
            f"{cd['coverage_of_commit_mean']:.0%} of commit mean "
            f"(exact by construction); p50 sum {cd['hop_p50_sum_ms']} "
            f"ms = {cd['coverage_of_commit_p50']:.0%} of commit p50")
    return "\n".join(lines) + "\n"


def merge(payloads: List[Dict]) -> Tuple[Dict, Dict]:
    """(chrome_trace_object, hop_stats) for a set of member payloads,
    on the aligned clock."""
    offsets = estimate_offsets(payloads)
    trace = chrome_trace(payloads, offsets_ns=offsets)
    stats = hop_stats(payloads, offsets)
    return trace, stats


