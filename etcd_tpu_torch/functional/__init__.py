"""Post-fault checkers (ports the multi-raft half of
``etcd_tpu/functional``: the checkers the batched chaos harness runs).

The in-process server cluster, its stressers and the server checkers
(``hash_check``, ``lease_expire_check``, ``linearizable_check``) come
with the server stack (ROADMAP A16).
"""

from .checker import (
    check_config_safety,
    check_durability_envelope,
    check_leader_claims,
    check_sequential_history,
    committed_never_lost,
    kv_map_hash,
    multiraft_hash_check,
)

__all__ = [
    "kv_map_hash", "multiraft_hash_check", "committed_never_lost",
    "check_leader_claims", "check_sequential_history",
    "check_config_safety", "check_durability_envelope",
]
