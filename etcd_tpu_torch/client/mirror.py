"""Mirroring: base snapshot + update stream of a key prefix
(ref: client/v3/mirror/syncer.go SyncBase/SyncUpdates;
etcdctl make-mirror command/make_mirror_command.go).

Ports ``etcd_tpu/client/mirror.py``.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

from ..server import api as sapi
from ..storage.mvcc.kv import Event, EventType
from .client import Client
from .util import prefix_end


class Syncer:
    """ref: mirror.NewSyncer(client, prefix, rev)."""

    def __init__(self, client: Client, prefix: bytes = b"",
                 rev: int = 0) -> None:
        self.c = client
        self.prefix = prefix
        self.rev = rev

    def sync_base(self) -> Tuple[int, List[sapi.KeyValue]]:
        """One consistent snapshot of the prefix: (revision, kvs)
        (ref: syncer.go SyncBase — paginated range pinned at one rev)."""
        # Empty prefix mirrors the whole keyspace: [\x00, open-end)
        # (syncer.go uses the same "\x00" + open-end sentinel pair).
        key = self.prefix if self.prefix else b"\x00"
        end = prefix_end(self.prefix)
        resp = self.c.get(key, end, revision=self.rev)
        at_rev = self.rev or resp.header.revision
        kvs = list(resp.kvs)
        # Paginate if the server limited the response.
        while resp.more and resp.kvs:
            next_key = resp.kvs[-1].key + b"\x00"
            resp = self.c.get(next_key, end, revision=at_rev)
            kvs.extend(resp.kvs)
        return at_rev, kvs

    def sync_updates(self):
        """WatchHandle streaming changes after the base revision
        (ref: syncer.go SyncUpdates — watch from rev+1)."""
        if self.rev == 0:
            raise ValueError("call sync_base first (rev unset)")
        key = self.prefix if self.prefix else b"\x00"
        end = prefix_end(self.prefix)
        return self.c.watch(key, end, start_rev=self.rev + 1)

    # -- make-mirror (etcdctl) -------------------------------------------------

    def mirror_to(self, dest: Client, dest_prefix: Optional[bytes] = None,
                  max_txns: int = 0, base_only: bool = False,
                  stop=None) -> int:
        """Copy base then stream updates into `dest`; returns keys
        mirrored. base_only skips the update stream; max_txns>0 bounds
        the update phase (testing/one-shot); max_txns=0 streams until
        interrupted (ref: make_mirror_command.go). `stop` is an optional
        threading.Event-like object checked between batches."""
        rev, kvs = self.sync_base()
        self.rev = rev

        def rewrite(key: bytes) -> bytes:
            if dest_prefix is not None and self.prefix:
                return dest_prefix + key[len(self.prefix):]
            return key

        count = 0
        for kv in kvs:
            dest.put(rewrite(kv.key), kv.value)
            count += 1
        if base_only:
            return count
        h = self.sync_updates()
        try:
            applied = 0
            while max_txns == 0 or applied < max_txns:
                if stop is not None and stop.is_set():
                    break
                got = h.get(timeout=0.5)
                if got is None:
                    continue
                _, events = got
                for ev in events:
                    if ev.type == EventType.PUT:
                        dest.put(rewrite(ev.kv.key), ev.kv.value)
                        count += 1
                    else:
                        dest.delete(rewrite(ev.kv.key))
                    applied += 1
                    if max_txns and applied >= max_txns:
                        break
            return count
        finally:
            h.cancel()
