"""Support libraries (ports the part of ``etcd_tpu/pkg`` that the WAL and
the hosting layer need: the metrics registry, failpoints and the shared
error types)."""
