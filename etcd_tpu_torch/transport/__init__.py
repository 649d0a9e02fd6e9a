"""Peer transport (ref: server/etcdserver/api/rafthttp/).

The reference moves raft messages over HTTP/1.1 long-lived streams (one
writer/reader pair per peer) plus a POST-per-message pipeline for rare
big messages and a dedicated snapshot sender. This package keeps those
semantics — ordered stream per peer, drop-don't-block, pipeline
fallback, peer probing — over framed TCP:

* ``InProcNetwork`` (raftexample/transport.py) for in-process
  clusters;
* ``TCPTransport`` for real socket clusters (tests/e2e and deployment).

Ports ``etcd_tpu/transport/__init__.py``.
"""

from .codec import decode_message, encode_message  # noqa: F401
from .tcp import TCPTransport  # noqa: F401
