"""Multi-version KV store (analog of server/storage/mvcc).

Ports ``etcd_tpu/storage/mvcc/__init__.py``."""

from .revision import Revision, rev_to_bytes, bytes_to_rev, tombstone_key
from .kv import KeyValue, Event, EventType, RangeOptions, RangeResult
from .key_index import KeyIndex
from .index import TreeIndex
from .kvstore import KVStore, CompactedError, FutureRevError
from .watchable import WatchableStore, WatchStream

__all__ = [
    "Revision", "rev_to_bytes", "bytes_to_rev", "tombstone_key",
    "KeyValue", "Event", "EventType", "RangeOptions", "RangeResult",
    "KeyIndex", "TreeIndex", "KVStore", "CompactedError", "FutureRevError",
    "WatchableStore", "WatchStream",
]
