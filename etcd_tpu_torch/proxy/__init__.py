"""Proxies (ref: server/proxy/): tcpproxy (the `etcd gateway` L4
forwarder) and grpcproxy (the caching/coalescing L7 proxy).

Ports ``etcd_tpu/proxy/__init__.py``.
"""
