"""Durable storage: the WAL, snapshot files, the Storage facade, the
sqlite backend and the MVCC store.

Ports ``etcd_tpu/storage/__init__.py``."""
