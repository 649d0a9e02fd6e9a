"""Durable storage: the WAL, snapshot files and the Storage facade that
raftexample persists through (ports the part of ``etcd_tpu/storage``
that raftexample uses)."""
