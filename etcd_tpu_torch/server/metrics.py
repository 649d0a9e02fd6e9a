"""Server metric set (ref: server/etcdserver/metrics.go) — same metric
names so dashboards port over.

Like the reference's prometheus default registry, metrics are
process-global: one member per process is the deployment model. In-proc
multi-member test clusters share the registry, so per-member gauges
(is_leader/has_leader) reflect the last member that wrote them; assert
on monotonic counters in such harnesses.

Ports ``etcd_tpu/server/metrics.py``."""

from __future__ import annotations

from ..pkg import metrics as m

has_leader = m.gauge(
    "etcd_server_has_leader", "Whether or not a leader exists. 1 is existence, 0 is not."
)
is_leader = m.gauge(
    "etcd_server_is_leader", "Whether or not this member is a leader. 1 if is, 0 otherwise."
)
leader_changes = m.counter(
    "etcd_server_leader_changes_seen_total", "The number of leader changes seen."
)
proposals_committed = m.gauge(
    "etcd_server_proposals_committed_total", "The total number of consensus proposals committed."
)
proposals_applied = m.gauge(
    "etcd_server_proposals_applied_total", "The total number of consensus proposals applied."
)
proposals_pending = m.gauge(
    "etcd_server_proposals_pending", "The current number of pending proposals to commit."
)
proposals_failed = m.counter(
    "etcd_server_proposals_failed_total", "The total number of failed proposals seen."
)
slow_read_indexes = m.counter(
    "etcd_server_slow_read_indexes_total", "The total number of pending read indexes not in sync with leader's or timed out read index requests."
)
read_indexes_failed = m.counter(
    "etcd_server_read_indexes_failed_total", "The total number of failed read indexes seen."
)
slow_applies = m.counter(
    "etcd_server_slow_apply_total", "The total number of slow apply requests (likely overloaded from slow disk)."
)
heartbeat_send_failures = m.counter(
    "etcd_server_heartbeat_send_failures_total", "The total number of leader heartbeat send failures (likely overloaded from slow disk)."
)
snapshot_apply_in_progress = m.gauge(
    "etcd_server_snapshot_apply_in_progress_total", "1 if the server is applying the incoming snapshot. 0 if none."
)
learner_promote_succeed = m.counter(
    "etcd_server_learner_promote_successes", "The total number of successful learner promotions while this member is leader."
)
apply_duration = m.histogram(
    "etcd_server_apply_duration_seconds", "The latency distributions of v2 apply called by backend.",
)

client_grpc_sent_bytes = m.counter(
    "etcd_network_client_grpc_sent_bytes_total", "The total number of bytes sent to grpc clients."
)
client_grpc_received_bytes = m.counter(
    "etcd_network_client_grpc_received_bytes_total", "The total number of bytes received from grpc clients."
)

lease_granted = m.counter(
    "etcd_debugging_lease_granted_total", "The total number of granted leases."
)
lease_revoked = m.counter(
    "etcd_debugging_lease_revoked_total", "The total number of revoked leases."
)
lease_renewed = m.counter(
    "etcd_debugging_lease_renewed_total", "The number of renewed leases seen by the leader."
)
