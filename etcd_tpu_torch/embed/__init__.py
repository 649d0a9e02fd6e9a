"""In-process server embedding (ref: server/embed/).

``Config`` mirrors embed.Config (embed/config.go:144): one struct,
flag/YAML-populated, validated, converted to ticks. ``start_etcd``
mirrors embed.StartEtcd (embed/etcd.go:93): listeners + EtcdServer +
RPC/HTTP serving, returned as one handle.

Ports ``etcd_tpu/embed/__init__.py``.
"""

from .config import Config, config_from_file
from .etcd import Etcd, start_etcd

__all__ = ["Config", "config_from_file", "Etcd", "start_etcd"]
