"""One timestamped ``artifacts/`` naming scheme for observability dumps.

Flight recorders (telemetry.TelemetryHub), trace rings (obs.tracer)
and fleet heatmaps (obs.fleet) all freeze evidence to disk on demand,
on invariant trips, and on chaos-checker failures — often for SEVERAL
members in the SAME wall-clock second. The older names keyed on
``{kind}_m{member}_{%Y%m%d-%H%M%S}_{reason}`` alone, so two dumps of
one member's ring within a second (an invariant trip racing the
checker-failure sweep, or a restart generation replacing a member
mid-second) silently overwrote each other. Every dump now routes
through :func:`dump_path`, which appends the writing process id and a
process-local monotone sequence number — collision-free within a
process by the counter, across processes by the pid — while keeping
the ``{kind}_m{member}_*_{reason}.json`` shape every existing glob
(tests, lint.yml artifact upload) matches.

Stdlib-only on purpose: telemetry.py is import-light (numpy +
pkg.metrics) and must stay that way.

Ports ``etcd_tpu/obs/artifacts.py`` whole; the port keeps its own copy and
tests/test_torch_hubs.py pins it equal.
"""

from __future__ import annotations

import itertools
import os
import time
from typing import Optional

# Process-local dump sequence; itertools.count is atomic under the GIL
# so concurrent member threads can't mint the same number.
_SEQ = itertools.count()

# Canonical kind prefixes (one per dump family — new dump families
# should add theirs here so the artifact namespace stays enumerable).
KIND_FLIGHTREC = "flightrec"
KIND_TRACERING = "tracering"
KIND_FLEETHEAT = "fleetheat"
KIND_RWGRID = "rwgrid"  # client-side R/W grid CSVs (tools/rw_heatmaps)


def artifact_dir(dump_dir: Optional[str] = None) -> str:
    """The dump directory: explicit argument, else
    ETCD_TPU_FLIGHTREC_DIR, else ``artifacts``."""
    return dump_dir or os.environ.get("ETCD_TPU_FLIGHTREC_DIR",
                                      "artifacts")


def dump_path(kind: str, member: str, reason: str,
              dump_dir: Optional[str] = None, ext: str = "json") -> str:
    """Collision-free artifact path ``{dir}/{kind}_m{member}_{ts}_
    p{pid}s{seq}_{reason}.{ext}`` (creates the directory)."""
    d = artifact_dir(dump_dir)
    os.makedirs(d, exist_ok=True)
    ts = time.strftime("%Y%m%d-%H%M%S")
    name = (f"{kind}_m{member}_{ts}_p{os.getpid()}s{next(_SEQ):03d}"
            f"_{reason}.{ext}")
    return os.path.join(d, name)
