"""Snapshot save over the maintenance API
(ref: client/v3/snapshot/v3_snapshot.go SaveWithVersion).

Ports ``etcd_tpu/client/snapshot.py``.
"""

from __future__ import annotations

import os

from .client import Client


def save(client: Client, path: str) -> int:
    """Stream the backend snapshot to `path`; returns bytes written.
    Writes to a temp file then renames (partial downloads never appear
    at the final path, v3_snapshot.go:47-93)."""
    blob = client.snapshot()
    tmp = path + ".part"
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return len(blob)
