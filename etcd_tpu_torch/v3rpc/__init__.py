"""Client-facing RPC surface (ref: server/etcdserver/api/v3rpc/ — the
gRPC services KV/Watch/Lease/Cluster/Maintenance/Auth).

The reference serves protobuf over gRPC/HTTP2; this serves the same six
service surfaces over length-prefixed JSON frames on TCP — unary
request/response plus server-push streams for watch events and lease
keepalives. Interceptor duties (auth token resolution, leader checks)
live in the method handlers.

Ports ``etcd_tpu/v3rpc/__init__.py``.
"""

from .service import V3RPCServer  # noqa: F401
from .wire import read_frame, write_frame  # noqa: F401
