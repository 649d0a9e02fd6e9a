"""The official client (ref: client/v3).

``Client`` speaks the v3rpc wire protocol with endpoint failover and
retry; watches re-establish across reconnects from the last delivered
revision (client/v3/watch.go's resume machinery); leases keep alive on
a background loop (client/v3/lease.go). Recipes — Session, Mutex,
Election, STM — live in ``concurrency``.

Ports ``etcd_tpu/client/__init__.py``.
"""

from .client import Client, ClientError  # noqa: F401
