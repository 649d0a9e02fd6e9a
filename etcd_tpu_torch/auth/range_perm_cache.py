"""Per-user unified range permissions
(ref: server/auth/range_perm_cache.go).

Each user's granted role permissions are merged into two interval trees
(read, write); permission checks are containment queries. The cache is
rebuilt wholesale on any auth mutation (rangePermCache invalidation,
store.go refreshRangePermCache).

Ports ``etcd_tpu/auth/range_perm_cache.py``.
"""

from __future__ import annotations

from typing import Dict, List

from ..pkg.adt import Interval, IntervalTree

# The end-of-table sentinel: a range whose end is "" in the API means
# "just the key"; end == b"\x00" means "from key to everything after".
_MAX = b"\xff" * 64


def _ivl(key: bytes, range_end: bytes) -> Interval:
    if not range_end:
        return Interval(key, key + b"\x00")
    if range_end == b"\x00":
        return Interval(key, _MAX)
    return Interval(key, range_end)


class UnifiedRangePermissions:
    def __init__(self) -> None:
        self.read = IntervalTree()
        self.write = IntervalTree()

    def add(self, key: bytes, range_end: bytes, perm_type: int) -> None:
        from .store import PermissionType

        ivl = _ivl(key, range_end)
        if perm_type in (PermissionType.READ, PermissionType.READWRITE):
            self.read.insert(ivl, True)
        if perm_type in (PermissionType.WRITE, PermissionType.READWRITE):
            self.write.insert(ivl, True)

    def _check(self, tree: IntervalTree, key: bytes, range_end: bytes) -> bool:
        want = _ivl(key, range_end)
        if not range_end:
            # Point check: any covering interval grants it
            # (checkKeyPoint range_perm_cache.go:129-141).
            for iv, _v in tree.visit_items(want):
                if iv.begin <= key and (key < iv.end):
                    return True
            return False
        # Interval check: one granted interval must contain the whole
        # request (checkKeyInterval range_perm_cache.go:113-127).
        for iv, _v in tree.visit_items(want):
            if iv.begin <= want.begin and want.end <= iv.end:
                return True
        return False

    def check_read(self, key: bytes, range_end: bytes) -> bool:
        return self._check(self.read, key, range_end)

    def check_write(self, key: bytes, range_end: bytes) -> bool:
        return self._check(self.write, key, range_end)
