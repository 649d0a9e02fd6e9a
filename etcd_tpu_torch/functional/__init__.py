"""Functional/chaos harness (ref: tests/functional/ — agent + tester +
stressers + checkers driven by functional.yaml).

The reference supervises real processes via per-member agents; here
members are in-proc EtcdServers supervised by `Cluster` (kill =
stop + recreate on the same data dir, which exercises the same WAL
replay/snapshot recovery paths), and faults ride the network hooks and
failpoints.

Ports ``etcd_tpu/functional/__init__.py``: ``Cluster(data_dir, n,
device=...)`` passes ``device`` on to each member's ``ServerConfig``.
"""

from .cluster import Cluster
from .checker import (
    check_config_safety,
    check_durability_envelope,
    check_leader_claims,
    check_sequential_history,
    committed_never_lost,
    hash_check,
    kv_map_hash,
    lease_expire_check,
    linearizable_check,
    multiraft_hash_check,
)
from .stresser import KVStresser, LeaseStresser

__all__ = [
    "Cluster", "KVStresser", "LeaseStresser",
    "hash_check", "lease_expire_check", "linearizable_check",
    "kv_map_hash", "multiraft_hash_check", "committed_never_lost",
    "check_leader_claims", "check_sequential_history",
    "check_config_safety", "check_durability_envelope",
]
