"""TTL leases (ref: server/lease/).

Grant/Revoke/Renew/Checkpoint with primary-only expiry via a min-heap,
key attachment for revoke-deletes-keys semantics, and backend
persistence so leases survive restart.

Ports ``etcd_tpu/lease/__init__.py``.
"""

from .lessor import (  # noqa: F401
    Lease,
    LeaseExpiredError,
    LeaseNotFoundError,
    LeaseExistsError,
    Lessor,
    LeaseItem,
    NoLease,
    NotPrimaryError,
    FOREVER,
)
