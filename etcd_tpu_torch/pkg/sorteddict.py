"""Minimal ordered map fallback for environments without
``sortedcontainers``.

``storage/mvcc/index.py`` needs a sorted key → value map with ranged
iteration (``irange``) — sortedcontainers' SortedDict where available.
Some deployment images don't ship it, and this repo's policy is to gate
missing third-party deps rather than require installs, so this module
provides the small subset the tree index actually uses, backed by a
plain dict plus a bisect-maintained sorted key list.

Complexity: lookups O(1), ranged scans O(log n + k), inserts/deletes of
NEW keys O(n) (list shift) vs sortedcontainers' O(log n) — acceptable
for the MVCC index at test/dev scale; production images should install
sortedcontainers and get the real thing via the import gate in
``index.py``.

Ports ``etcd_tpu/pkg/sorteddict.py``.
"""

from __future__ import annotations

import bisect
from typing import Any, Dict, Iterator, List, Optional, Tuple


class SortedDict:
    """The subset of sortedcontainers.SortedDict used by TreeIndex:
    get/setitem/delitem/pop/len/contains, key-ordered values()/items(),
    and irange(min, max, inclusive=(bool, bool))."""

    def __init__(self) -> None:
        self._keys: List[Any] = []
        self._data: Dict[Any, Any] = {}

    def __setitem__(self, key: Any, value: Any) -> None:
        if key not in self._data:
            bisect.insort(self._keys, key)
        self._data[key] = value

    def __getitem__(self, key: Any) -> Any:
        return self._data[key]

    def get(self, key: Any, default: Any = None) -> Any:
        return self._data.get(key, default)

    def __delitem__(self, key: Any) -> None:
        del self._data[key]
        i = bisect.bisect_left(self._keys, key)
        del self._keys[i]

    def pop(self, key: Any, default: Any = None) -> Any:
        if key in self._data:
            val = self._data[key]
            del self[key]
            return val
        return default

    def __contains__(self, key: Any) -> bool:
        return key in self._data

    def __len__(self) -> int:
        return len(self._data)

    def __iter__(self) -> Iterator[Any]:
        return iter(self._keys)

    def keys(self) -> List[Any]:
        return list(self._keys)

    def values(self) -> Iterator[Any]:
        return (self._data[k] for k in self._keys)

    def items(self) -> Iterator[Tuple[Any, Any]]:
        return ((k, self._data[k]) for k in self._keys)

    def irange(self, minimum: Optional[Any] = None,
               maximum: Optional[Any] = None,
               inclusive: Tuple[bool, bool] = (True, True),
               ) -> Iterator[Any]:
        lo = 0
        if minimum is not None:
            lo = (bisect.bisect_left(self._keys, minimum) if inclusive[0]
                  else bisect.bisect_right(self._keys, minimum))
        hi = len(self._keys)
        if maximum is not None:
            hi = (bisect.bisect_right(self._keys, maximum) if inclusive[1]
                  else bisect.bisect_left(self._keys, maximum))
        return iter(self._keys[lo:hi])
