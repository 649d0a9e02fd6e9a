"""The v2 hierarchical store (ref: api/v2store/store.go, node.go,
event.go, event_history.go, watcher_hub.go, ttl_key_heap.go).

Semantics preserved:

* a tree of dirs and value nodes addressed by "/"-paths;
* every mutation bumps the store index; nodes carry created/modified
  indexes;
* TTLs expire via a min-heap scanned on every access (DeleteExpiredKeys
  — the reference syncs on a clock tick; here expiry is checked on
  operations and an explicit ``delete_expired_keys``);
* Get with sorted/recursive; Set/Create/Update with prevExist,
  CompareAndSwap/CompareAndDelete with prevValue/prevIndex;
* in-order keys for dirs created with ``unique`` (POST semantics,
  node_extern.go);
* watchers with an event history ring so watches can start in the past
  (event_history.go, watcher_hub.go scanning).

Ports ``etcd_tpu/v2store/store.py``.
"""

from __future__ import annotations

import heapq
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# v2 error codes (ref: error/error.go).
EcodeKeyNotFound = 100
EcodeTestFailed = 101
EcodeNotFile = 102
EcodeNotDir = 104
EcodeNodeExist = 105
EcodeRootROnly = 107
EcodeDirNotEmpty = 108

GET = "get"
SET = "set"
CREATE = "create"
UPDATE = "update"
DELETE = "delete"
CAS = "compareAndSwap"
CAD = "compareAndDelete"
EXPIRE = "expire"


class V2Error(Exception):
    def __init__(self, code: int, cause: str, index: int) -> None:
        super().__init__(f"v2 error {code}: {cause} (index {index})")
        self.code = code
        self.cause = cause
        self.index = index


@dataclass
class NodeExtern:
    """ref: node_extern.go NodeExtern."""
    key: str
    value: Optional[str] = None
    dir: bool = False
    created_index: int = 0
    modified_index: int = 0
    expiration: Optional[float] = None
    ttl: int = 0
    nodes: List["NodeExtern"] = field(default_factory=list)


@dataclass
class Event:
    """ref: event.go."""
    action: str
    node: NodeExtern
    prev_node: Optional[NodeExtern] = None
    etcd_index: int = 0


class _Node:
    def __init__(self, store: "V2Store", path: str, created: int,
                 parent: Optional["_Node"], value: Optional[str],
                 expire_at: Optional[float]) -> None:
        self.store = store
        self.path = path
        self.created_index = created
        self.modified_index = created
        self.parent = parent
        self.value = value  # None → dir
        self.children: Dict[str, _Node] = {}
        self.expire_at = expire_at

    @property
    def is_dir(self) -> bool:
        return self.value is None

    def expired(self, now: float) -> bool:
        return self.expire_at is not None and self.expire_at <= now

    def extern(self, recursive: bool = False, sorted_: bool = False,
               now: Optional[float] = None) -> NodeExtern:
        now = now if now is not None else time.time()
        ne = NodeExtern(
            key=self.path,
            value=None if self.is_dir else self.value,
            dir=self.is_dir,
            created_index=self.created_index,
            modified_index=self.modified_index,
        )
        if self.expire_at is not None:
            ne.expiration = self.expire_at
            ne.ttl = max(0, int(round(self.expire_at - now)))
        if self.is_dir:
            kids = [
                c for c in self.children.values() if not c.expired(now)
            ]
            if sorted_:
                kids.sort(key=lambda c: c.path)
            ne.nodes = [
                c.extern(recursive=recursive, sorted_=sorted_, now=now)
                if recursive else NodeExtern(
                    key=c.path, dir=c.is_dir,
                    value=None if c.is_dir else c.value,
                    created_index=c.created_index,
                    modified_index=c.modified_index,
                )
                for c in kids
            ]
        return ne


class _Watcher:
    def __init__(self, hub: "EventHistory", prefix: str, recursive: bool,
                 since: int) -> None:
        self.prefix = prefix
        self.recursive = recursive
        self.since = since
        self._cond = threading.Condition()
        self._event: Optional[Event] = None

    def _notify(self, ev: Event) -> bool:
        with self._cond:
            if self._event is None:
                self._event = ev
                self._cond.notify_all()
                return True
            return False

    def wait(self, timeout: Optional[float] = None) -> Optional[Event]:
        with self._cond:
            if self._event is None:
                self._cond.wait(timeout)
            return self._event


class EventHistory:
    """Ring of recent events for watch-from-index
    (ref: event_history.go, capacity 1000)."""

    def __init__(self, capacity: int = 1000) -> None:
        self.capacity = capacity
        self.events: List[Event] = []
        self.start_index = 0

    def add(self, ev: Event) -> None:
        self.events.append(ev)
        if len(self.events) > self.capacity:
            self.events.pop(0)
            self.start_index += 1

    def scan(self, prefix: str, recursive: bool, since: int) -> Optional[Event]:
        for ev in self.events:
            if ev.etcd_index < since:
                continue
            key = ev.node.key
            if (key == prefix or
                    (recursive and key.startswith(prefix.rstrip("/") + "/"))):
                return ev
        return None


def _normalize(path: str) -> str:
    path = "/" + path.strip("/")
    return path if path != "/" else "/"


class V2Store:
    def __init__(self) -> None:
        self._lock = threading.RLock()
        self.index = 0
        self.root = _Node(self, "/", 0, None, None, None)
        self.history = EventHistory()
        self._watchers: List[_Watcher] = []
        self._ttl_heap: List[Tuple[float, str]] = []
        self.stats = {"gets": 0, "sets": 0, "deletes": 0, "expires": 0,
                      "cas": 0, "cad": 0, "creates": 0, "updates": 0}

    # -- serialization (ref: store.go Save/Recovery — the v2 store
    # rides raft snapshots so pre-snapshot state survives compaction) --

    def save(self) -> str:
        """JSON dump of the whole tree + index counter."""

        def enc(node: _Node) -> dict:
            out = {
                "p": node.path,
                "c": node.created_index,
                "m": node.modified_index,
            }
            if node.value is not None:
                out["v"] = node.value
            if node.expire_at is not None:
                out["e"] = node.expire_at
            if node.children:
                out["k"] = [enc(ch) for ch in node.children.values()]
            return out

        import json

        with self._lock:
            return json.dumps({"index": self.index, "root": enc(self.root)})

    def recovery(self, blob: str) -> None:
        """Replace the tree from a save() dump (store.go Recovery)."""
        import json

        d = json.loads(blob)

        def dec(obj: dict, parent: Optional[_Node]) -> _Node:
            node = _Node(self, obj["p"], obj["c"], parent,
                         obj.get("v"), obj.get("e"))
            node.modified_index = obj["m"]
            for ch in obj.get("k", []):
                child = dec(ch, node)
                node.children[child.path.rsplit("/", 1)[-1]] = child
                if child.expire_at is not None:
                    heapq.heappush(self._ttl_heap,
                                   (child.expire_at, child.path))
            return node

        with self._lock:
            self._ttl_heap = []
            self.index = d["index"]
            self.root = dec(d["root"], None)

    # -- internals -------------------------------------------------------------

    def _walk(self, path: str, create_dirs: bool = False) -> _Node:
        node = self.root
        if path == "/":
            return node
        parts = path.strip("/").split("/")
        now = time.time()
        for i, part in enumerate(parts):
            child = node.children.get(part)
            if child is not None and child.expired(now):
                self._expire_node(child)
                child = None
            if child is None:
                if not create_dirs:
                    raise V2Error(EcodeKeyNotFound, path, self.index)
                child = _Node(
                    self, node.path.rstrip("/") + "/" + part,
                    self.index, node, None, None,
                )
                node.children[part] = child
            if not child.is_dir and i < len(parts) - 1:
                raise V2Error(EcodeNotDir, child.path, self.index)
            node = child
        return node

    def _expire_node(self, node: _Node) -> None:
        if node.parent is not None:
            node.parent.children.pop(node.path.rsplit("/", 1)[1], None)
        self.index += 1
        self.stats["expires"] += 1
        ev = Event(EXPIRE, NodeExtern(
            key=node.path, modified_index=self.index,
            created_index=node.created_index,
        ), prev_node=node.extern(), etcd_index=self.index)
        self._publish(ev)

    def delete_expired_keys(self, now: Optional[float] = None) -> int:
        """ref: store.go DeleteExpiredKeys (clock-driven sync)."""
        now = now if now is not None else time.time()
        n = 0
        with self._lock:
            while self._ttl_heap and self._ttl_heap[0][0] <= now:
                _, path = heapq.heappop(self._ttl_heap)
                try:
                    node = self._walk(path)
                except V2Error:
                    continue
                if node.expired(now):
                    self._expire_node(node)
                    n += 1
        return n

    def _publish(self, ev: Event) -> None:
        self.history.add(ev)
        still = []
        for w in self._watchers:
            key = ev.node.key
            hit = key == w.prefix or (
                w.recursive and key.startswith(w.prefix.rstrip("/") + "/")
            )
            if hit and ev.etcd_index >= w.since:
                w._notify(ev)
            else:
                still.append(w)
        self._watchers = still

    # -- public API (store.go Store interface) ---------------------------------

    def get(self, path: str, recursive: bool = False,
            sorted_: bool = False) -> Event:
        path = _normalize(path)
        with self._lock:
            self.delete_expired_keys()
            self.stats["gets"] += 1
            node = self._walk(path)
            return Event(
                GET, node.extern(recursive=recursive, sorted_=sorted_),
                etcd_index=self.index,
            )

    def set(self, path: str, dir_: bool = False,
            value: str = "", ttl: Optional[float] = None) -> Event:
        """Create-or-replace (ref: store.go Set)."""
        path = _normalize(path)
        with self._lock:
            self.delete_expired_keys()
            prev = None
            try:
                prev = self._walk(path).extern()
            except V2Error:
                pass
            ev = self._create(path, dir_, value, ttl, replace=True,
                              action=SET)
            ev.prev_node = prev
            self.stats["sets"] += 1
            return ev

    def create(self, path: str, dir_: bool = False, value: str = "",
               ttl: Optional[float] = None, unique: bool = False) -> Event:
        """Fails if the node exists; unique appends an in-order key
        (POST, store.go Create)."""
        path = _normalize(path)
        with self._lock:
            self.delete_expired_keys()
            if unique:
                path = path.rstrip("/") + f"/{self.index + 1:020d}"
            self.stats["creates"] += 1
            return self._create(path, dir_, value, ttl, replace=False,
                                action=CREATE)

    def _create(self, path: str, dir_: bool, value: str,
                ttl: Optional[float], replace: bool, action: str) -> Event:
        parent_path, _, name = path.rpartition("/")
        parent = self._walk(parent_path or "/", create_dirs=True)
        if not parent.is_dir:
            raise V2Error(EcodeNotDir, parent.path, self.index)
        existing = parent.children.get(name)
        now = time.time()
        if existing is not None and existing.expired(now):
            self._expire_node(existing)
            existing = None
        if existing is not None:
            if not replace:
                raise V2Error(EcodeNodeExist, path, self.index)
            if existing.is_dir:
                raise V2Error(EcodeNotFile, path, self.index)
        self.index += 1
        expire_at = now + ttl if ttl is not None else None
        node = _Node(self, path, self.index, parent,
                     None if dir_ else value, expire_at)
        parent.children[name] = node
        if expire_at is not None:
            heapq.heappush(self._ttl_heap, (expire_at, path))
        ev = Event(action, node.extern(), etcd_index=self.index)
        self._publish(ev)
        return ev

    def update(self, path: str, value: str = "",
               ttl: Optional[float] = None) -> Event:
        """Fails if missing (prevExist=true, store.go Update)."""
        path = _normalize(path)
        with self._lock:
            self.delete_expired_keys()
            node = self._walk(path)
            prev = node.extern()
            if node.is_dir and value:
                raise V2Error(EcodeNotFile, path, self.index)
            self.index += 1
            if not node.is_dir:
                node.value = value
            node.modified_index = self.index
            node.expire_at = time.time() + ttl if ttl is not None else None
            if node.expire_at is not None:
                heapq.heappush(self._ttl_heap, (node.expire_at, path))
            self.stats["updates"] += 1
            ev = Event(UPDATE, node.extern(), prev_node=prev,
                       etcd_index=self.index)
            self._publish(ev)
            return ev

    def compare_and_swap(self, path: str, prev_value: Optional[str],
                         prev_index: int, value: str,
                         ttl: Optional[float] = None) -> Event:
        path = _normalize(path)
        with self._lock:
            self.delete_expired_keys()
            node = self._walk(path)
            if node.is_dir:
                raise V2Error(EcodeNotFile, path, self.index)
            if ((prev_value is not None and node.value != prev_value) or
                    (prev_index and node.modified_index != prev_index)):
                raise V2Error(
                    EcodeTestFailed,
                    f"[{prev_value} != {node.value}] "
                    f"[{prev_index} != {node.modified_index}]",
                    self.index,
                )
            prev = node.extern()
            self.index += 1
            node.value = value
            node.modified_index = self.index
            if ttl is not None:
                node.expire_at = time.time() + ttl
                heapq.heappush(self._ttl_heap, (node.expire_at, path))
            self.stats["cas"] += 1
            ev = Event(CAS, node.extern(), prev_node=prev,
                       etcd_index=self.index)
            self._publish(ev)
            return ev

    def compare_and_delete(self, path: str, prev_value: Optional[str],
                           prev_index: int) -> Event:
        path = _normalize(path)
        with self._lock:
            self.delete_expired_keys()
            node = self._walk(path)
            if node.is_dir:
                raise V2Error(EcodeNotFile, path, self.index)
            if ((prev_value is not None and node.value != prev_value) or
                    (prev_index and node.modified_index != prev_index)):
                raise V2Error(EcodeTestFailed, path, self.index)
            self.stats["cad"] += 1
            return self._delete_node(node, CAD)

    def delete(self, path: str, recursive: bool = False,
               dir_: bool = False) -> Event:
        path = _normalize(path)
        with self._lock:
            self.delete_expired_keys()
            node = self._walk(path)
            if node is self.root:
                raise V2Error(EcodeRootROnly, path, self.index)
            if node.is_dir:
                if not recursive and not dir_:
                    raise V2Error(EcodeNotFile, path, self.index)
                if node.children and not recursive:
                    raise V2Error(EcodeDirNotEmpty, path, self.index)
            self.stats["deletes"] += 1
            return self._delete_node(node, DELETE)

    def _delete_node(self, node: _Node, action: str) -> Event:
        prev = node.extern()
        node.parent.children.pop(node.path.rsplit("/", 1)[1], None)
        self.index += 1
        ev = Event(action, NodeExtern(
            key=node.path, modified_index=self.index,
            created_index=node.created_index,
        ), prev_node=prev, etcd_index=self.index)
        self._publish(ev)
        return ev

    # -- watch (watcher_hub.go) ------------------------------------------------

    def watch(self, prefix: str, recursive: bool = False,
              since: int = 0) -> _Watcher:
        prefix = _normalize(prefix)
        with self._lock:
            w = _Watcher(self.history, prefix, recursive,
                         since or self.index + 1)
            if since:
                past = self.history.scan(prefix, recursive, since)
                if past is not None:
                    w._notify(past)
                    return w
            self._watchers.append(w)
            return w
