"""Support libraries (ports the part of ``etcd_tpu/pkg`` that the WAL
needs: the metrics registry)."""
