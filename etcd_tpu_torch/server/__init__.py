"""The replicated server (ref: server/etcdserver/).

EtcdServer ties the raft Node, WAL/snap storage, mvcc, lease, auth and
alarm subsystems together: proposals flow through
``process_internal_raft_request`` (propose → wait-registry → applied
response), reads through the ReadIndex protocol, and every committed
entry through the applier chain exactly once (consistent-index guard).

Ports ``etcd_tpu/server/__init__.py``.
"""

from .api import *  # noqa: F401,F403
from .server import EtcdServer, ServerConfig  # noqa: F401
