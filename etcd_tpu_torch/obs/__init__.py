"""Observability layouts of the PyTorch engine (ports ``etcd_tpu/obs``)."""
