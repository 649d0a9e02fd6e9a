"""v2 store: the legacy hierarchical TTL store
(ref: server/etcdserver/api/v2store/ — retained in 3.6 the way the
reference retains it: the public v2 API is removed (v2_deprecation.go),
the store survives for internal/membership uses and tooling).

Ports ``etcd_tpu/v2store/__init__.py``."""

from .store import (
    Event, EventHistory, NodeExtern, V2Error, V2Store,
    EcodeKeyNotFound, EcodeNodeExist, EcodeNotDir, EcodeNotFile,
    EcodeDirNotEmpty, EcodeTestFailed,
)

__all__ = [
    "Event", "EventHistory", "NodeExtern", "V2Error", "V2Store",
    "EcodeKeyNotFound", "EcodeNodeExist", "EcodeNotDir", "EcodeNotFile",
    "EcodeDirNotEmpty", "EcodeTestFailed",
]
