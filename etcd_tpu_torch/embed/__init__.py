"""In-process server embedding (ref: server/embed/).

``Config`` mirrors embed.Config (embed/config.go:144): one struct,
flag/YAML-populated, validated, converted to ticks. ``start_etcd``
mirrors embed.StartEtcd (embed/etcd.go:93): listeners + EtcdServer +
RPC/HTTP serving, returned as one handle.

Ports ``etcd_tpu/embed/__init__.py`` without ``Etcd`` and
``start_etcd``: ``embed/etcd.py`` boots the server with its listeners and
comes with the outer surfaces (ROADMAP A19). The server imports
``parse_urls`` from ``config`` when it forwards a lease renew.
"""

from .config import Config, config_from_file

__all__ = ["Config", "config_from_file"]
