"""Peer-transport metric set (ref: server/etcdserver/api/rafthttp/metrics.go).

Ports ``etcd_tpu/transport/metrics.py``.
"""

from __future__ import annotations

from ..pkg import metrics as m

peer_sent_bytes = m.counter(
    "etcd_network_peer_sent_bytes_total", "The total number of bytes sent to peers.", ("To",)
)
peer_received_bytes = m.counter(
    "etcd_network_peer_received_bytes_total", "The total number of bytes received from peers.", ("From",)
)
peer_sent_failures = m.counter(
    "etcd_network_peer_sent_failures_total", "The total number of send failures from peers.", ("To",)
)
snapshot_send_success = m.counter(
    "etcd_network_snapshot_send_success", "Total number of successful snapshot sends.", ("To",)
)
snapshot_send_failures = m.counter(
    "etcd_network_snapshot_send_failures", "Total number of snapshot send failures.", ("To",)
)
