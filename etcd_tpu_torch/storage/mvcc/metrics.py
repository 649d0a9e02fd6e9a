"""mvcc metric set (ref: server/storage/mvcc/metrics.go).

Process-global like the reference's prometheus registry (one member per
process is the deployment model); in-proc multi-member test clusters
share these, so gauges mix members — assert on per-store state, not
gauges, in such harnesses.

Ports ``etcd_tpu/storage/mvcc/metrics.py``."""

from __future__ import annotations

from ...pkg import metrics as m

db_total_size = m.gauge(
    "etcd_mvcc_db_total_size_in_bytes", "Total size of the underlying database physically allocated in bytes."
)
db_in_use_size = m.gauge(
    "etcd_mvcc_db_total_size_in_use_in_bytes", "Total size of the underlying database logically in use in bytes."
)
keys_total = m.gauge(
    "etcd_debugging_mvcc_keys_total", "Total number of keys."
)
range_total = m.counter(
    "etcd_mvcc_range_total", "Total number of ranges seen by this member."
)
put_total = m.counter(
    "etcd_mvcc_put_total", "Total number of puts seen by this member."
)
delete_total = m.counter(
    "etcd_mvcc_delete_total", "Total number of deletes seen by this member."
)
txn_total = m.counter(
    "etcd_mvcc_txn_total", "Total number of txns seen by this member."
)
watch_stream_total = m.gauge(
    "etcd_debugging_mvcc_watch_stream_total", "Total number of watch streams."
)
watcher_total = m.gauge(
    "etcd_debugging_mvcc_watcher_total", "Total number of watchers."
)
slow_watcher_total = m.gauge(
    "etcd_debugging_mvcc_slow_watcher_total", "Total number of unsynced slow watchers."
)
events_total = m.counter(
    "etcd_debugging_mvcc_events_total", "Total number of events sent by this member."
)
pending_events_total = m.gauge(
    "etcd_debugging_mvcc_pending_events_total", "Total number of pending events to be sent."
)
compact_revision = m.gauge(
    "etcd_debugging_mvcc_compact_revision", "The revision of the last compaction in store."
)
current_revision = m.gauge(
    "etcd_debugging_mvcc_current_revision", "The current revision of store."
)
