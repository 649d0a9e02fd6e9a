"""Interval tree over byte-string (or int) ranges.

Used for auth range-permission checks and watcher key-range groups, the
same two consumers as the reference's red-black interval tree
(ref: pkg/adt/interval_tree.go; consumers auth/range_perm_cache.go and
server/storage/mvcc/watcher_group.go). This implementation is an
augmented treap — same O(log n) expected bounds, far less rotation
bookkeeping than red-black, and deterministic given the seeded RNG.

Intervals are half-open ``[begin, end)``. A nil/empty ``end`` of b"\\x00"
conventionally means "single key" at the caller level; callers pass
explicit ends here.

Ports ``etcd_tpu/pkg/adt.py``.
"""

from __future__ import annotations

import random
from typing import Any, Callable, Iterator, List, Optional, Tuple


class _Inf:
    """True +inf interval endpoint: compares greater than every key of
    any type (bytes or int). Used for open-ended watch ranges, where any
    finite byte-string stand-in would miss keys sorting above it."""

    __slots__ = ()

    def __lt__(self, other):
        return False

    def __le__(self, other):
        return other is INF

    def __gt__(self, other):
        return other is not INF

    def __ge__(self, other):
        return True

    def __eq__(self, other):
        return other is INF

    def __hash__(self):
        return hash("adt.INF")

    def __repr__(self):
        return "INF"


INF = _Inf()


class Interval:
    __slots__ = ("begin", "end")

    def __init__(self, begin, end) -> None:
        if not begin < end:
            raise ValueError(f"invalid interval [{begin!r}, {end!r})")
        self.begin = begin
        self.end = end

    def intersects(self, other: "Interval") -> bool:
        return self.begin < other.end and other.begin < self.end

    def contains(self, other: "Interval") -> bool:
        return self.begin <= other.begin and other.end <= self.end

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Interval)
            and self.begin == other.begin
            and self.end == other.end
        )

    def __hash__(self) -> int:
        return hash((self.begin, self.end))

    def __repr__(self) -> str:
        return f"Interval({self.begin!r}, {self.end!r})"


def point_interval(p) -> Interval:
    """The single-point interval [p, p+\\0) for byte keys, [p, p+1) for ints."""
    if isinstance(p, (bytes, bytearray)):
        return Interval(bytes(p), bytes(p) + b"\x00")
    return Interval(p, p + 1)


class _Node:
    __slots__ = ("ivl", "value", "prio", "left", "right", "max_end")

    def __init__(self, ivl: Interval, value: Any, prio: int) -> None:
        self.ivl = ivl
        self.value = value
        self.prio = prio
        self.left: Optional["_Node"] = None
        self.right: Optional["_Node"] = None
        self.max_end = ivl.end

    def pull(self) -> None:
        m = self.ivl.end
        if self.left is not None and self.left.max_end > m:
            m = self.left.max_end
        if self.right is not None and self.right.max_end > m:
            m = self.right.max_end
        self.max_end = m


def _key(ivl: Interval) -> Tuple:
    return (ivl.begin, ivl.end)


class IntervalTree:
    def __init__(self, seed: int = 0x5EED) -> None:
        self._root: Optional[_Node] = None
        self._len = 0
        self._rng = random.Random(seed)

    def __len__(self) -> int:
        return self._len

    # -- update ---------------------------------------------------------------

    def insert(self, ivl: Interval, value: Any) -> None:
        """Insert; an equal [begin,end) interval is replaced in place."""
        found = self._find(self._root, ivl)
        if found is not None:
            found.value = value
            return
        node = _Node(ivl, value, self._rng.getrandbits(30))
        self._root = self._insert(self._root, node)
        self._len += 1

    def _insert(self, root: Optional[_Node], node: _Node) -> _Node:
        if root is None:
            return node
        if node.prio > root.prio:
            node.left, node.right = self._split(root, _key(node.ivl))
            node.pull()
            return node
        if _key(node.ivl) < _key(root.ivl):
            root.left = self._insert(root.left, node)
        else:
            root.right = self._insert(root.right, node)
        root.pull()
        return root

    def _split(
        self, root: Optional[_Node], key: Tuple
    ) -> Tuple[Optional[_Node], Optional[_Node]]:
        if root is None:
            return None, None
        if _key(root.ivl) < key:
            a, b = self._split(root.right, key)
            root.right = a
            root.pull()
            return root, b
        a, b = self._split(root.left, key)
        root.left = b
        root.pull()
        return a, root

    def _merge(
        self, a: Optional[_Node], b: Optional[_Node]
    ) -> Optional[_Node]:
        if a is None:
            return b
        if b is None:
            return a
        if a.prio > b.prio:
            a.right = self._merge(a.right, b)
            a.pull()
            return a
        b.left = self._merge(a, b.left)
        b.pull()
        return b

    def delete(self, ivl: Interval) -> bool:
        node = self._find(self._root, ivl)
        if node is None:
            return False
        self._root = self._delete(self._root, ivl)
        self._len -= 1
        return True

    def _delete(self, root: Optional[_Node], ivl: Interval) -> Optional[_Node]:
        assert root is not None
        if _key(ivl) == _key(root.ivl):
            return self._merge(root.left, root.right)
        if _key(ivl) < _key(root.ivl):
            root.left = self._delete(root.left, ivl)
        else:
            root.right = self._delete(root.right, ivl)
        root.pull()
        return root

    def _find(self, root: Optional[_Node], ivl: Interval) -> Optional[_Node]:
        while root is not None:
            if _key(ivl) == _key(root.ivl):
                return root
            root = root.left if _key(ivl) < _key(root.ivl) else root.right
        return None

    # -- query ----------------------------------------------------------------

    def find(self, ivl: Interval) -> Optional[Any]:
        node = self._find(self._root, ivl)
        return node.value if node is not None else None

    def intersects(self, ivl: Interval) -> bool:
        node = self._root
        while node is not None:
            if node.ivl.intersects(ivl):
                return True
            if node.left is not None and node.left.max_end > ivl.begin:
                node = node.left
            else:
                node = node.right
        return False

    def stab(self, point) -> List[Any]:
        """Values of all intervals containing `point`."""
        return [v for _, v in self.stab_items(point)]

    def stab_items(self, point) -> List[Tuple[Interval, Any]]:
        return self.visit_items(point_interval(point))

    def visit(self, ivl: Interval, fn: Callable[[Interval, Any], bool]) -> None:
        """Call fn on every stored interval intersecting ivl, in sorted
        order; fn returning False stops the walk (ref semantics:
        pkg/adt/interval_tree.go Visit)."""
        self._visit(self._root, ivl, fn)

    def _visit(self, node: Optional[_Node], ivl: Interval, fn) -> bool:
        if node is None or node.max_end <= ivl.begin:
            return True
        if not self._visit(node.left, ivl, fn):
            return False
        if node.ivl.begin >= ivl.end:
            # Whole right spine is also >= end; stop descending right but
            # finish normally.
            return True
        if node.ivl.intersects(ivl) and not fn(node.ivl, node.value):
            return False
        return self._visit(node.right, ivl, fn)

    def visit_items(self, ivl: Interval) -> List[Tuple[Interval, Any]]:
        out: List[Tuple[Interval, Any]] = []

        def collect(i: Interval, v: Any) -> bool:
            out.append((i, v))
            return True

        self.visit(ivl, collect)
        return out

    def items(self) -> Iterator[Tuple[Interval, Any]]:
        def walk(node: Optional[_Node]):
            if node is None:
                return
            yield from walk(node.left)
            yield (node.ivl, node.value)
            yield from walk(node.right)

        yield from walk(self._root)
