"""Chrome-trace / Perfetto JSON export for tracer spans.

The Trace Event Format (the ``chrome://tracing`` JSON Perfetto still
loads) wants a ``traceEvents`` list of complete events: ``ph="X"``,
microsecond ``ts``/``dur``, ``pid``/``tid`` lanes, ``name``. We map
member → pid (one process lane per member — which is literally true in
the hosted deployment) and group → tid, and emit one slice per *hop*
(the interval between adjacent present stamps), so the span renders as
a flame of named hops rather than one opaque bar.

Ports ``etcd_tpu/obs/export.py`` whole; the port keeps its own copy and
tests/test_torch_hubs.py pins it equal.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Tuple

from .tracer import STAGE_INDEX, STAGES

# Hop names keyed by (from_stage, to_stage): the slice between two
# adjacent stamps. Single-member hops only — the cross-member hops
# (leader send → peer extract, peer send → leader commit) exist only
# on the merged timeline and are named by tools/trace_merge.py.
HOP_NAMES: Dict[Tuple[str, str], str] = {
    ("propose", "stage"): "enqueue_wait",
    ("stage", "dispatch"): "stage",
    ("dispatch", "extract"): "step",
    ("extract", "fsync_wait"): "fsync_wait",
    ("fsync_wait", "fsync"): "fsync",
    # Dumps from before the fsync_wait split carry one
    # combined hop; keep them renderable.
    ("extract", "fsync"): "fsync",
    ("fsync", "send"): "send",
    ("send", "commit"): "quorum_wait",
    ("commit", "apply"): "apply",
}


def _ordered_stamps(stages: Dict[str, int]) -> List[Tuple[str, int]]:
    return sorted(
        ((s, t) for s, t in stages.items() if s in STAGE_INDEX),
        key=lambda st: STAGE_INDEX[st[0]],
    )


def span_events(span: Dict, pid, offset_ns: int = 0) -> List[Dict]:
    """Per-hop complete events for one span fragment. ``offset_ns`` is
    added to every stamp (the merge tool's clock alignment)."""
    stamps = _ordered_stamps(span.get("stages", {}))
    key_args = {
        "group": span.get("group"), "term": span.get("term"),
        "index": span.get("index"),
        "complete": bool(span.get("complete", False)),
    }
    events: List[Dict] = []
    for (s0, t0), (s1, t1) in zip(stamps, stamps[1:]):
        name = HOP_NAMES.get((s0, s1), f"{s0}→{s1}")
        dur_us = max(t1 - t0, 0) / 1e3
        events.append({
            "name": name,
            "cat": "raft",
            "ph": "X",
            "ts": (t0 + offset_ns) / 1e3,
            "dur": dur_us,
            "pid": pid,
            "tid": int(span.get("group", 0)),
            "args": key_args,
        })
    return events


def chrome_trace(payloads: Iterable[Dict],
                 offsets_ns: Optional[Dict[str, int]] = None) -> Dict:
    """Build one Chrome-trace object from one or more tracer payloads
    (``Tracer.to_payload`` shape). ``offsets_ns`` maps member id → the
    clock offset to ADD to that member's stamps (reference member 0)."""
    offsets_ns = offsets_ns or {}
    events: List[Dict] = []
    members: List[str] = []
    for payload in payloads:
        member = str(payload.get("member", "0"))
        members.append(member)
        off = int(offsets_ns.get(member, 0))
        try:
            pid = int(member)
        except ValueError:
            pid = len(members)
        events.append({
            "name": "process_name",
            "ph": "M",
            "pid": pid,
            "args": {"name": f"member-{member}"},
        })
        for span in payload.get("spans", ()):
            events.extend(span_events(span, pid, off))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "source": "etcd_tpu.obs",
            "members": members,
            "stage_names": list(STAGES),
            "clock_offsets_ns": {
                str(k): int(v) for k, v in offsets_ns.items()},
        },
    }


def validate_chrome_trace(obj: Dict) -> List[Dict]:
    """Assert ``obj`` is a loadable Chrome-trace object; returns the
    non-metadata events. Raises ValueError with the first violation —
    the trace smoke in tools/check.sh and the exporter tests both gate
    on this, so a malformed export can never silently ship."""
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("trace object must carry a traceEvents list")
    events = obj["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("traceEvents must be a list")
    slices: List[Dict] = []
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i}: not an object")
        ph = ev.get("ph")
        if ph not in ("X", "B", "E", "M", "i", "b", "e"):
            raise ValueError(f"event {i}: unknown phase {ph!r}")
        if "pid" not in ev or "name" not in ev:
            raise ValueError(f"event {i}: missing pid/name")
        if ph == "M":
            continue
        for fld in ("ts", "tid"):
            if fld not in ev:
                raise ValueError(f"event {i}: missing {fld}")
        if not isinstance(ev["ts"], (int, float)) or ev["ts"] < 0:
            raise ValueError(f"event {i}: bad ts {ev['ts']!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"event {i}: bad dur {dur!r}")
        slices.append(ev)
    # Round-trip: the object must actually serialize (numpy scalars
    # smuggled into args are the classic failure).
    json.loads(json.dumps(obj))
    return slices
