"""Watchable store: event fanout over the MVCC store.

Same machinery as the reference (ref:
server/storage/mvcc/watchable_store.go:47-510, watcher_group.go):

* watchers hold a key or [key, end) range and a start revision;
* the **synced** group gets events inline as write txns end
  (``notify``); watchers whose start revision is behind go to the
  **unsynced** group and are caught up by a background ``sync_watchers``
  pass that replays history out of the store index/backend
  (watchable_store.go:331-408);
* a watcher whose channel is full becomes a **victim** and is retried
  asynchronously with the events it missed (watchable_store.go victim
  loop) — here the channel is an unbounded deque, so victimhood is
  modeled with an explicit per-watcher cap to preserve the slow-watcher
  semantics;
* watcher groups index range watchers in an interval tree
  (watcher_group.go uses pkg/adt) for O(log n + matches) fanout.

The WatchStream facade matches mvcc/watcher.go: watch/cancel/progress
over a shared event queue.

Ports ``etcd_tpu/storage/mvcc/watchable.py``.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Set, Tuple

from ...pkg.adt import INF, Interval, IntervalTree, point_interval
from . import metrics as mmet
from .kv import Event, EventType, KeyValue
from .kvstore import KVStore
from .revision import rev_to_bytes

# How many buffered events mark a watcher as slow (victim); the
# reference uses chanBufLen 128 on the watch channel.
DEFAULT_BUFFER_CAP = 1024

# Open-ended watch ranges (end = the "\x00" sentinel) use a true +inf
# endpoint in the interval tree — any finite byte string would miss
# events for keys sorting above it.
WATCH_OPEN_MAX = INF


@dataclass
class WatchResponse:
    watch_id: int
    events: List[Event]
    revision: int  # store revision when sent
    compact_revision: int = 0  # nonzero → watcher cancelled at compaction


class Watcher:
    def __init__(self, wid: int, key: bytes, end: Optional[bytes],
                 start_rev: int, fcs: List[Callable[[Event], bool]],
                 sink: "WatchStream") -> None:
        self.id = wid
        self.key = key
        self.end = end
        self.min_rev = start_rev  # next revision this watcher needs
        self.filters = fcs
        self.sink = sink
        self.compacted = False
        self.victim = False

    def interval(self) -> Interval:
        if self.end is None:
            return point_interval(self.key)
        return Interval(self.key, self.end if self.end else WATCH_OPEN_MAX)

    def send(self, resp: WatchResponse) -> bool:
        if self.filters:
            resp.events = [
                e for e in resp.events
                if not any(f(e) for f in self.filters)
            ]
            if not resp.events and resp.compact_revision == 0:
                return True
        return self.sink._deliver(resp)


class WatcherGroup:
    """Point watchers by key + range watchers in an interval tree."""

    def __init__(self) -> None:
        self.keys: Dict[bytes, Set[Watcher]] = {}
        self.ranges = IntervalTree()
        self.watchers: Set[Watcher] = set()

    def add(self, w: Watcher) -> None:
        self.watchers.add(w)
        if w.end is None:
            self.keys.setdefault(w.key, set()).add(w)
            return
        ivl = w.interval()
        ws = self.ranges.find(ivl)
        if ws is None:
            self.ranges.insert(ivl, {w})
        else:
            ws.add(w)

    def remove(self, w: Watcher) -> bool:
        if w not in self.watchers:
            return False
        self.watchers.discard(w)
        if w.end is None:
            s = self.keys.get(w.key)
            if s is not None:
                s.discard(w)
                if not s:
                    del self.keys[w.key]
            return True
        ivl = w.interval()
        ws = self.ranges.find(ivl)
        if ws is not None:
            ws.discard(w)
            if not ws:
                self.ranges.delete(ivl)
        return True

    def matching(self, key: bytes) -> List[Watcher]:
        out = list(self.keys.get(key, ()))
        for ws in self.ranges.stab(key):
            out.extend(ws)
        return out

    def choose_min_rev(self, max_watchers: int, cur_rev: int,
                       compact_rev: int) -> Tuple[List[Watcher], int]:
        """Pick ≤ max_watchers unsynced watchers and the min revision to
        replay from; watchers behind the compaction point are marked
        compacted (ref: watcher_group.go chooseAll)."""
        chosen: List[Watcher] = []
        min_rev = cur_rev + 1
        for w in list(self.watchers)[:max_watchers]:
            if w.min_rev < compact_rev + 1:
                w.compacted = True
            chosen.append(w)
            if not w.compacted and w.min_rev < min_rev:
                min_rev = w.min_rev
        return chosen, min_rev

    def __len__(self) -> int:
        return len(self.watchers)


class WatchableStore(KVStore):
    def __init__(self, backend, lessor=None,
                 buffer_cap: int = DEFAULT_BUFFER_CAP) -> None:
        self._wlock = threading.RLock()
        self.synced = WatcherGroup()
        self.unsynced = WatcherGroup()
        self._victims: List[Tuple[Watcher, List[Event]]] = []
        self._buffer_cap = buffer_cap
        self._next_watch_id = 0
        # Max distinct revisions per unsynced replay response
        # (ref: watchable_store.go watchBatchMaxRevs = 1000).
        self.watch_batch_max_revs = 1000
        super().__init__(backend, lessor)

    # -- KVStore write hook ----------------------------------------------------

    def write(self):
        from .kvstore import WriteTxn

        return WriteTxn(
            self, on_end=lambda tx: self.notify(tx.rev, tx.changes)
        )

    # -- watch API -------------------------------------------------------------

    def new_watch_stream(self) -> "WatchStream":
        return WatchStream(self)

    def watch(self, key: bytes, end: Optional[bytes], start_rev: int,
              sink: "WatchStream", wid: Optional[int] = None,
              fcs: Optional[List[Callable[[Event], bool]]] = None) -> Watcher:
        # Lock order everywhere: store _lock → watch _wlock (notify runs
        # inside the write txn with _lock held).
        with self._lock, self._wlock:
            if wid is None:
                wid = self._next_watch_id
                self._next_watch_id += 1
            w = Watcher(wid, key, end, start_rev, fcs or [], sink)
            cur = self.rev()
            if start_rev == 0 or start_rev > cur:
                # A future-rev watcher is synced but keeps its start
                # revision: notify must not hand it events below it
                # (ref: watchable_store.go:128-136).
                w.min_rev = max(cur + 1, start_rev)
                self.synced.add(w)
            else:
                self.unsynced.add(w)
            mmet.watcher_total.inc()
            self._update_slow_gauge()
            return w

    def cancel_watcher(self, w: Watcher) -> bool:
        with self._wlock:
            found = self.synced.remove(w) or self.unsynced.remove(w)
            if not found:
                for i, (vw, _) in enumerate(self._victims):
                    if vw is w:
                        del self._victims[i]
                        found = True
                        break
            if found:
                mmet.watcher_total.dec()
            self._update_slow_gauge()
            return found

    # -- fanout ----------------------------------------------------------------

    def notify(self, rev: int, events: List[Event]) -> None:
        """Send events to synced watchers; slow ones become victims
        (ref: watchable_store.go:434 notify)."""
        with self._wlock:
            per_w: Dict[Watcher, List[Event]] = {}
            for ev in events:
                for w in self.synced.matching(ev.kv.key):
                    # Future-rev watchers wait for their start revision
                    # (ref: watcher_group.go newWatcherBatch minRev gate).
                    if ev.kv.mod_revision < w.min_rev:
                        continue
                    per_w.setdefault(w, []).append(ev)
            for w, evs in per_w.items():
                ok = w.send(WatchResponse(w.id, evs, rev))
                if ok:
                    mmet.events_total.inc(len(evs))
                if not ok:
                    # victim: move out of synced, retry async
                    self.synced.remove(w)
                    w.victim = True
                    w.min_rev = rev + 1
                    self._victims.append((w, evs))
            self._update_slow_gauge()

    def sync_watchers(self, max_watchers: int = 512) -> int:
        """One pass of the unsynced catch-up loop; returns watchers
        still unsynced (ref: watchable_store.go:331 syncWatchers)."""
        with self._lock, self._wlock:
            if len(self.unsynced) == 0 and not self._victims:
                return 0
            self._retry_victims()
            if len(self.unsynced) == 0:
                self._update_slow_gauge()
                return len(self.unsynced)
            cur = self.rev()
            compact = self.compact_rev
            chosen, min_rev = self.unsynced.choose_min_rev(
                max_watchers, cur, compact
            )
            revs = self.index.range_since(b"", b"", min_rev)
            evs = self._events_from_revs(revs)
            for w in chosen:
                if w.compacted:
                    w.send(WatchResponse(w.id, [], cur,
                                         compact_revision=compact))
                    self.unsynced.remove(w)
                    mmet.watcher_total.dec()  # cancelled at compaction
                    continue
                mine = [
                    e for e in evs
                    if e.kv.mod_revision >= w.min_rev and self._match(w, e)
                ]
                # Cap one replay response to WATCH_BATCH_MAX_REVS
                # distinct revisions; a capped watcher stays unsynced
                # with min_rev at the first undelivered revision
                # (ref: watchable_store.go watchBatchMaxRevs +
                # watcher_group.go newWatcherBatch moreRev).
                more_rev = 0
                if mine:
                    distinct, last, cut = 0, -1, len(mine)
                    for i, e in enumerate(mine):
                        r = e.kv.mod_revision
                        if r != last:
                            distinct += 1
                            last = r
                            if distinct > self.watch_batch_max_revs:
                                cut, more_rev = i, r
                                break
                    mine = mine[:cut]
                if mine and not w.send(
                        WatchResponse(w.id, mine, cur)):
                    w.victim = True
                    w.min_rev = more_rev or cur + 1
                    self.unsynced.remove(w)
                    self._victims.append((w, mine))
                    continue
                if mine:
                    mmet.events_total.inc(len(mine))
                if more_rev:
                    w.min_rev = more_rev  # stay unsynced; next pass
                    continue
                w.min_rev = cur + 1
                self.unsynced.remove(w)
                self.synced.add(w)
            self._update_slow_gauge()
            return len(self.unsynced)

    def start_sync_loop(self, interval: float = 0.1) -> None:
        """The unsynced catch-up + victim retry loop
        (ref: watchable_store.go:211 syncWatchersLoop, every 100ms)."""
        if getattr(self, "_sync_stop", None) is not None:
            return
        stop = threading.Event()
        self._sync_stop = stop

        def loop() -> None:
            while not stop.wait(interval):
                try:
                    self.sync_watchers()
                except Exception:  # noqa: BLE001 — keep the loop alive
                    pass

        self._sync_thread = threading.Thread(target=loop, daemon=True)
        self._sync_thread.start()

    def stop_sync_loop(self) -> None:
        stop = getattr(self, "_sync_stop", None)
        if stop is not None:
            stop.set()
            self._sync_stop = None
            t = getattr(self, "_sync_thread", None)
            if t is not None and t.is_alive():
                t.join(timeout=5)

    def _retry_victims(self) -> None:
        still: List[Tuple[Watcher, List[Event]]] = []
        for w, evs in self._victims:
            if w.send(WatchResponse(w.id, evs,
                                    evs[-1].kv.mod_revision if evs else
                                    self.rev())):
                mmet.events_total.inc(len(evs))
                w.victim = False
                # Writes may have happened while victimized; if so the
                # watcher needs history replay before going live again
                # (ref: watchable_store.go moveVictims).
                if w.min_rev <= self.rev():
                    self.unsynced.add(w)
                else:
                    self.synced.add(w)
            else:
                still.append((w, evs))
        self._victims = still

    def _update_slow_gauge(self) -> None:
        mmet.slow_watcher_total.set(len(self.unsynced) + len(self._victims))
        mmet.pending_events_total.set(
            sum(len(evs) for _, evs in self._victims)
        )

    @staticmethod
    def _match(w: Watcher, ev: Event) -> bool:
        if w.end is None:
            return ev.kv.key == w.key
        if not w.end:  # open end (the \x00 sentinel)
            return ev.kv.key >= w.key
        return w.key <= ev.kv.key < w.end

    def _events_from_revs(self, revs) -> List[Event]:
        from .. import backend as bk
        rt = self.b.read_tx()
        evs: List[Event] = []
        for r in revs:
            base = rev_to_bytes(r)
            rows = rt.range(bk.KEY, base, base + b"\xff")
            for rkey, rval in rows:
                if len(rkey) == 18:  # tombstone row
                    evs.append(Event(
                        type=EventType.DELETE,
                        kv=KeyValue(key=rval, mod_revision=r.main),
                    ))
                else:
                    evs.append(Event(type=EventType.PUT,
                                     kv=KeyValue.unmarshal(rval)))
        return evs


class WatcherDuplicateIDError(Exception):
    """ref: mvcc.ErrWatcherDuplicateID."""


class EmptyWatcherRangeError(Exception):
    """ref: mvcc.ErrEmptyWatcherRange — key >= end describes no keys."""


class WatchStream:
    """Client-facing handle multiplexing many watchers onto one queue
    (ref: mvcc/watcher.go:108 watchStream)."""

    def __init__(self, store: WatchableStore) -> None:
        self._s = store
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._q: Deque[WatchResponse] = deque()
        self._watchers: Dict[int, Watcher] = {}
        self._next_id = 0  # per-stream auto ids (ref: watcher.go Watch)
        self._closed = False
        mmet.watch_stream_total.inc()

    # watchers call this; False → would exceed cap (victim path)
    def _deliver(self, resp: WatchResponse) -> bool:
        with self._lock:
            if self._closed:
                return True  # drop silently after close
            if len(self._q) >= self._s._buffer_cap:
                return False
            self._q.append(resp)
            self._cond.notify_all()
            return True

    def watch(self, key: bytes, end: Optional[bytes] = None,
              start_rev: int = 0, wid: Optional[int] = None,
              fcs=None) -> int:
        """end semantics: None = single key; b"" = open-ended (every
        key >= key); otherwise end must sort above key
        (ref: watcher.go:108-136 Watch)."""
        if end is not None and end != b"" and end <= key:
            raise EmptyWatcherRangeError()
        with self._lock:
            if wid is not None:
                if wid in self._watchers:
                    raise WatcherDuplicateIDError()
            else:
                # Per-stream auto assignment skips manually-taken ids.
                while self._next_id in self._watchers:
                    self._next_id += 1
                wid = self._next_id
                self._next_id += 1
        w = self._s.watch(key, end, start_rev, self, wid=wid, fcs=fcs)
        with self._lock:
            self._watchers[w.id] = w
        return w.id

    def cancel(self, wid: int) -> bool:
        with self._lock:
            w = self._watchers.pop(wid, None)
        return self._s.cancel_watcher(w) if w is not None else False

    def request_progress(self, wid: int) -> None:
        with self._lock:
            w = self._watchers.get(wid)
        if w is None:
            return
        # Only a synced watcher may advertise the current revision: an
        # unsynced/victim watcher has not delivered everything below it
        # (ref: watchable_store.go progress()).
        with self._s._lock, self._s._wlock:
            if w not in self._s.synced.watchers:
                return
            rev = self._s.rev()
        self._deliver(WatchResponse(wid, [], rev))

    def poll(self, timeout: Optional[float] = None) -> Optional[WatchResponse]:
        with self._lock:
            if not self._q:
                self._cond.wait(timeout)
            return self._q.popleft() if self._q else None

    def pending(self) -> int:
        with self._lock:
            return len(self._q)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            wids = list(self._watchers)
            self._closed = True
            self._cond.notify_all()
        mmet.watch_stream_total.dec()
        for wid in wids:
            self.cancel(wid)
