"""Support libraries (ports the part of ``etcd_tpu/pkg`` that the WAL and
the hosting layer need: the metrics registry, failpoints, the shared
error types and the one boolean env-knob parse)."""

import os as _os


def env_flag(name: str) -> bool:
    """The ONE truthiness parse for boolean env knobs ("", "0" and
    "false" are off; anything else is on) — ETCD_TPU_WAL_PIPELINE,
    bench drivers and member processes must agree on it, so it lives
    here instead of being re-derived per call site."""
    return _os.environ.get(name, "") not in ("", "0", "false")
