"""Disk metric set (ref: server/storage/wal/metrics.go,
server/storage/backend metrics in backend.go).

Ports ``etcd_tpu/storage/metrics.py``, registered in the port's own
registry (``pkg/metrics.py``).
"""

from __future__ import annotations

from ..pkg import metrics as m

wal_fsync_duration = m.histogram(
    "etcd_disk_wal_fsync_duration_seconds", "The latency distributions of fsync called by WAL.",
    buckets=[0.001 * (2 ** i) for i in range(14)],
)
wal_write_bytes = m.gauge(
    "etcd_disk_wal_write_bytes_total", "Total number of bytes written in WAL."
)
backend_commit_duration = m.histogram(
    "etcd_disk_backend_commit_duration_seconds", "The latency distributions of commit called by backend.",
    buckets=[0.001 * (2 ** i) for i in range(14)],
)
backend_snapshot_duration = m.histogram(
    "etcd_disk_backend_snapshot_duration_seconds", "The latency distribution of backend snapshots.",
    buckets=[0.01 * (2 ** i) for i in range(10)],
)
