"""Peer transport (ports ``etcd_tpu/transport``): the binary message
codec. The TCP transport comes with the hosting stack's out-of-process
half (ROADMAP A12)."""

from .codec import decode_message, encode_message  # noqa: F401
