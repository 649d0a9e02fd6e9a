"""Sampled proposal-lifecycle tracing for the batched hosting path.

The telemetry plane answers *what happened* (counters, invariant
sweep, flight recorder); this package answers *where the time went*:
deterministically sampled proposals are stamped with monotonic clocks
at every pipeline stage — propose-enqueue, round staging, device
dispatch, Ready extraction, WAL fsync, outbound send, commit, apply —
on every member that touches them, keyed by ``(group, term, index)`` so
peer-side spans need no wire-format change (Dapper's causal join trick:
the identifiers already on the wire ARE the trace id).

Pieces:

* ``tracer.Tracer`` — lock-cheap per-member span collector with a
  bounded ring (drops are counted on pkg.metrics, never silent).
* ``export`` — Chrome-trace / Perfetto JSON exporter + validator.
* ``tools/trace_merge.py`` — joins per-member dumps into one timeline
  with cross-process clock-offset estimation from send/recv pairs.
* ``fleet`` — the fleet observatory: layout of the
  device-side group-state SummaryFrame plus the host FleetHub
  (``etcd_tpu_fleet_*`` families, groups×time heatmap ring, counted
  anomaly flags); ``tools/fleet_console.py`` renders a live cluster.
* ``artifacts`` — the one collision-free ``artifacts/`` naming scheme
  every observability dump (flightrec/tracering/fleetheat) shares.

Tracing is OFF by default and purely host-side: the round
program and protocol state are bit-identical with it on or off
(tests/obs/test_tracing.py pins both). The fleet summary is likewise
OFF by default; it IS device-side, but a pure read — bit-parity is
pinned the same way (tests/batched/test_fleet.py).

Ports ``etcd_tpu/obs/__init__.py`` whole; the port keeps its own copy and
tests/test_torch_hubs.py pins it equal.
"""

from .tracer import STAGES, Tracer, make_tracer  # noqa: F401
from .export import chrome_trace, validate_chrome_trace  # noqa: F401
from .fleet import FleetHub, FleetLayout  # noqa: F401
from .artifacts import dump_path  # noqa: F401
