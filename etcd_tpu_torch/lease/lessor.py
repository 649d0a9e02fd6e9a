"""The lessor: owner of all leases (ref: server/lease/lessor.go).

Semantics preserved from the reference:

* **Primary-only expiry** (lessor.go:146-183, 465-530): only a promoted
  (leader) lessor moves leases toward expiry; demoted lessors park every
  expiry at "forever". ``Promote(extend)`` refreshes all expiries to
  now+TTL+extend so a new leader never revokes a lease the old leader
  was still honoring; when many leases would expire in the same window
  it spreads them to keep the revoke rate bounded
  (leaseRevokeRate, lessor.go:491-529).
* **Expiry pipeline** (runLoop lessor.go:611-659): due leases surface
  on ``expired_leases()``; the server turns them into LeaseRevoke
  proposals, and the applied revoke calls ``revoke()`` which deletes
  attached keys through the RangeDeleter txn.
* **Checkpoints** (lessor.go:362-423, 742-795): long-TTL leases
  periodically persist remaining TTL via the Checkpointer so a leader
  change doesn't reset the countdown.
* **Persistence**: each lease is a record in the lease bucket
  (schema: key = big-endian int64 id); recovered on construction
  (initAndRecover lessor.go:797-829).

Ports ``etcd_tpu/lease/lessor.py``.
"""

from __future__ import annotations

import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set

from ..storage import backend as bk
from .lease_queue import LeaseQueue

NoLease = 0  # ref: lease.NoLease
FOREVER = float("inf")
MAX_TTL = 9_000_000_000  # ref: MaxLeaseTTL lessor.go:39
DEFAULT_MIN_TTL = 5  # seconds

LEASE_BUCKET = bk.Bucket("lease")

_LEASE_VAL = struct.Struct("<qqq")  # id, ttl, remaining_ttl

# ref: lessor.go:48-52 — max revokes per 500ms runLoop pass.
LEASE_REVOKE_RATE = 1000
# ref: lessor.go:54-57 — checkpoint batching.
LEASE_CHECKPOINT_RATE = 1000
DEFAULT_CHECKPOINT_INTERVAL = 300.0  # 5 min (lessor.go:60)
MAX_CHECKPOINT_BATCH = 1000


class LeaseNotFoundError(Exception):
    """ref: ErrLeaseNotFound."""


class LeaseExistsError(Exception):
    """ref: ErrLeaseExists."""


class NotPrimaryError(Exception):
    """ref: lease.ErrNotPrimary — renew/checkpoint demand the primary
    (expiry-tracking) lessor; distinct from a missing lease."""


class LeaseExpiredError(Exception):
    """ref: ErrLeaseTTLTooLarge/expired paths."""


class LeaseTTLTooLargeError(Exception):
    """ref: ErrLeaseTTLTooLarge."""


@dataclass(frozen=True)
class LeaseItem:
    """A key attached to a lease (ref: lease.LeaseItem)."""

    key: str


def _as_items(items) -> List["LeaseItem"]:
    if isinstance(items, LeaseItem):
        return [items]
    if isinstance(items, bytes):
        return [LeaseItem(items.decode("latin1"))]
    if isinstance(items, str):
        return [LeaseItem(items)]
    return [
        it if isinstance(it, LeaseItem) else LeaseItem(
            it.decode("latin1") if isinstance(it, bytes) else it
        )
        for it in items
    ]


class Lease:
    """ref: lessor.go:831-905 Lease."""

    def __init__(self, lease_id: int, ttl: int) -> None:
        self.id = lease_id
        self.ttl = ttl  # seconds
        self.remaining_ttl = 0  # checkpointed remainder; 0 = full TTL
        self._expiry_lock = threading.RLock()
        self._expiry: float = FOREVER
        self._items_lock = threading.Lock()
        self.item_set: Set[LeaseItem] = set()

    def expiry(self) -> float:
        with self._expiry_lock:
            return self._expiry

    def refresh(self, extend: float = 0.0) -> None:
        """expiry = now + extend + remaining TTL (ref: Lease.refresh)."""
        ttl = self.remaining_ttl if self.remaining_ttl > 0 else self.ttl
        with self._expiry_lock:
            self._expiry = time.monotonic() + extend + ttl

    def forever(self) -> None:
        with self._expiry_lock:
            self._expiry = FOREVER

    def remaining(self) -> float:
        with self._expiry_lock:
            if self._expiry == FOREVER:
                return FOREVER
            return self._expiry - time.monotonic()

    def expired(self) -> bool:
        return self.remaining() <= 0

    def keys(self) -> List[str]:
        with self._items_lock:
            return sorted(it.key for it in self.item_set)

    def persist_to(self, backend: bk.Backend) -> None:
        key = struct.pack(">q", self.id)
        val = _LEASE_VAL.pack(self.id, self.ttl, self.remaining_ttl)
        tx = backend.batch_tx
        with tx.lock:
            tx.put(LEASE_BUCKET, key, val)


class Lessor:
    """ref: lessor.go:146-246 lessor / NewLessor."""

    def __init__(
        self,
        backend: bk.Backend,
        min_lease_ttl: int = DEFAULT_MIN_TTL,
        checkpoint_interval: float = DEFAULT_CHECKPOINT_INTERVAL,
        expired_leases_retry_interval: float = 3.0,
        checkpoint_persist: bool = False,
        loop_interval: float = 0.5,
    ) -> None:
        self._lock = threading.RLock()
        self.b = backend
        self.min_lease_ttl = min_lease_ttl
        self.checkpoint_interval = checkpoint_interval
        self.expired_retry_interval = expired_leases_retry_interval
        self.checkpoint_persist = checkpoint_persist
        self.loop_interval = loop_interval

        self.lease_map: Dict[int, Lease] = {}
        self.item_map: Dict[LeaseItem, int] = {}
        self.expired_queue = LeaseQueue()
        self.checkpoint_queue = LeaseQueue()
        self._expired_pending: Dict[int, float] = {}  # id -> last surfaced

        self.range_deleter: Optional[Callable[[], object]] = None
        self.checkpointer: Optional[Callable[[int, int], None]] = None

        self.demoted_event = threading.Event()
        self._primary = False
        self._stopped = threading.Event()
        self._expired_c: List[List[Lease]] = []
        self._expired_cv = threading.Condition()

        self._init_and_recover()

        self._loop = threading.Thread(target=self._run_loop, daemon=True)
        self._loop.start()

    # -- recovery --------------------------------------------------------------

    def _init_and_recover(self) -> None:
        """ref: lessor.go:797-829 initAndRecover."""
        tx = self.b.batch_tx
        with tx.lock:
            tx.unsafe_create_bucket(LEASE_BUCKET)
        items = self.b.read_tx().range(
            LEASE_BUCKET, b"\x00" * 8, b"\xff" * 8, 0
        )
        for _k, v in items:
            lid, ttl, remaining = _LEASE_VAL.unpack(v)
            lease = Lease(lid, ttl)
            lease.remaining_ttl = remaining
            lease.forever()  # not primary yet
            self.lease_map[lid] = lease

    # -- grant / revoke --------------------------------------------------------

    def grant(self, lease_id: int, ttl: int) -> Lease:
        """ref: lessor.go:272-320 Grant."""
        if lease_id == NoLease:
            raise LeaseNotFoundError("cannot grant lease with id 0")
        if ttl > MAX_TTL:
            raise LeaseTTLTooLargeError(str(ttl))
        with self._lock:
            if lease_id in self.lease_map:
                raise LeaseExistsError(str(lease_id))
            lease = Lease(lease_id, max(ttl, self.min_lease_ttl))
            self.lease_map[lease_id] = lease
            lease.persist_to(self.b)
            if self._primary:
                lease.refresh()
                self.expired_queue.push(lease_id, lease.expiry())
                if self._should_checkpoint(lease):
                    self._schedule_checkpoint(lease)
            else:
                lease.forever()
            return lease

    def revoke(self, lease_id: int) -> None:
        """Delete the lease and all attached keys in one txn
        (ref: lessor.go:322-360 Revoke)."""
        with self._lock:
            lease = self.lease_map.get(lease_id)
            if lease is None:
                raise LeaseNotFoundError(str(lease_id))
            keys = lease.keys()
        txn = self.range_deleter() if self.range_deleter is not None else None
        if txn is not None:
            for key in keys:
                txn.delete_range(key.encode("latin1"), None)
        with self._lock:
            self.lease_map.pop(lease_id, None)
            for it in list(lease.item_set):
                self.item_map.pop(it, None)
            self.expired_queue.remove(lease_id)
            self.checkpoint_queue.remove(lease_id)
            self._expired_pending.pop(lease_id, None)
            # Delete from backend inside the same logical txn as the keys.
            tx = self.b.batch_tx
            with tx.lock:
                tx.delete(LEASE_BUCKET, struct.pack(">q", lease_id))
        if txn is not None:
            txn.end()

    # -- renew / checkpoint ----------------------------------------------------

    def renew(self, lease_id: int) -> int:
        """Returns the new TTL. Primary only (ref: lessor.go:425-463)."""
        with self._lock:
            if not self._primary:
                raise NotPrimaryError("not primary lessor")
            lease = self.lease_map.get(lease_id)
            if lease is None:
                raise LeaseNotFoundError(str(lease_id))
            # Clear the checkpointed remainder: a renewed lease restarts
            # its full TTL (ref: lessor.go:440-452).
            if lease.remaining_ttl > 0:
                lease.remaining_ttl = 0
                if self.checkpointer is not None:
                    self.checkpointer(lease_id, 0)
            lease.refresh()
            self.expired_queue.push(lease_id, lease.expiry())
            self._expired_pending.pop(lease_id, None)
            return lease.ttl

    def checkpoint(self, lease_id: int, remaining_ttl: int) -> None:
        """Apply a checkpoint (ref: lessor.go:362-390 Checkpoint)."""
        with self._lock:
            lease = self.lease_map.get(lease_id)
            if lease is None:
                raise LeaseNotFoundError(str(lease_id))
            if remaining_ttl >= lease.ttl:
                return
            lease.remaining_ttl = remaining_ttl
            if self.checkpoint_persist:
                lease.persist_to(self.b)
            if self._primary:
                lease.refresh()
                self.expired_queue.push(lease_id, lease.expiry())

    # -- attach / detach -------------------------------------------------------

    def attach(self, lease_id: int, items) -> None:
        """ref: lessor.go:532-556. `items`: List[LeaseItem] or a single
        key (bytes/str) — the mvcc write txn passes raw keys."""
        with self._lock:
            lease = self.lease_map.get(lease_id)
            if lease is None:
                raise LeaseNotFoundError(str(lease_id))
            with lease._items_lock:
                for it in _as_items(items):
                    lease.item_set.add(it)
                    self.item_map[it] = lease_id

    def detach(self, lease_id: int, items) -> None:
        """ref: lessor.go:565-583."""
        with self._lock:
            lease = self.lease_map.get(lease_id)
            if lease is None:
                raise LeaseNotFoundError(str(lease_id))
            with lease._items_lock:
                for it in _as_items(items):
                    lease.item_set.discard(it)
                    self.item_map.pop(it, None)

    def get_lease(self, item: LeaseItem) -> int:
        with self._lock:
            return self.item_map.get(item, NoLease)

    def lookup(self, lease_id: int) -> Optional[Lease]:
        with self._lock:
            return self.lease_map.get(lease_id)

    def leases(self) -> List[Lease]:
        with self._lock:
            return sorted(self.lease_map.values(), key=lambda l: l.id)

    # -- promote / demote ------------------------------------------------------

    def promote(self, extend: float = 0.0) -> None:
        """Become primary: refresh all expiries, rate-limit the expiry
        wave (ref: lessor.go:465-530 Promote)."""
        with self._lock:
            self._primary = True
            self.demoted_event.clear()
            leases = list(self.lease_map.values())
            for lease in leases:
                lease.refresh(extend)
                self.expired_queue.push(lease.id, lease.expiry())
                if self._should_checkpoint(lease):
                    self._schedule_checkpoint(lease)
            if len(leases) < LEASE_REVOKE_RATE:
                return  # no possibility of lease pile-up
            # Spread a thundering herd of expiries over 1-second
            # windows at 3/4 of the revoke rate, exactly the
            # reference's shape (lessor.go:484-517): piled-up leases
            # must not consume the entire revoke limit.
            leases.sort(key=lambda l: l.remaining())
            base_window = leases[0].remaining()
            next_window = base_window + 1.0
            expires = 0
            target_per_second = (3 * LEASE_REVOKE_RATE) // 4
            for lease in leases:
                rem = lease.remaining()
                if rem > next_window:
                    base_window = rem
                    next_window = base_window + 1.0
                    expires = 1
                    continue
                expires += 1
                if expires <= target_per_second:
                    continue
                rate_delay = 1.0 * (expires / target_per_second)
                # Leases n seconds past the base window only need the
                # difference to land in their spread slot.
                rate_delay -= rem - base_window
                next_window = base_window + rate_delay
                lease.refresh(rate_delay + extend)
                self.expired_queue.push(lease.id, lease.expiry())
                if self._should_checkpoint(lease):
                    self._schedule_checkpoint(lease)

    def demote(self) -> None:
        """ref: lessor.go:558-563 + runLoop demotec handling."""
        with self._lock:
            self._primary = False
            for lease in self.lease_map.values():
                lease.forever()
            self._expired_pending.clear()
            self.demoted_event.set()

    def is_primary(self) -> bool:
        with self._lock:
            return self._primary

    # -- expiry loop -----------------------------------------------------------

    def expired_leases(self, timeout: Optional[float] = None) -> List[Lease]:
        """Block for the next batch of expired leases
        (the ExpiredLeasesC read, ref: lessor.go:131-135)."""
        with self._expired_cv:
            if not self._expired_c:
                self._expired_cv.wait(timeout=timeout)
            if self._expired_c:
                return self._expired_c.pop(0)
            return []

    def _run_loop(self) -> None:
        """ref: lessor.go:611-659 runLoop: revoke expired + checkpoint
        scheduled every 500ms."""
        while not self._stopped.wait(self.loop_interval):
            self._revoke_expired()
            self._checkpoint_scheduled()

    def _revoke_expired(self) -> None:
        with self._lock:
            if not self._primary:
                return
            now = time.monotonic()
            limit = int(LEASE_REVOKE_RATE * self.loop_interval)
            batch: List[Lease] = []
            while len(batch) < limit:
                lid = self.expired_queue.peek_due(now)
                if lid is None:
                    break
                self.expired_queue.pop()
                lease = self.lease_map.get(lid)
                if lease is None:
                    continue
                if not lease.expired():
                    self.expired_queue.push(lid, lease.expiry())
                    continue
                # Don't re-surface a lease the server is already revoking;
                # retry after expiredLeaseRetryInterval (lessor.go:670-697).
                last = self._expired_pending.get(lid)
                if last is not None and now - last < self.expired_retry_interval:
                    self.expired_queue.push(lid, last + self.expired_retry_interval)
                    continue
                self._expired_pending[lid] = now
                self.expired_queue.push(lid, now + self.expired_retry_interval)
                batch.append(lease)
        if batch:
            with self._expired_cv:
                self._expired_c.append(batch)
                self._expired_cv.notify_all()

    def _should_checkpoint(self, lease: Lease) -> bool:
        """ref: lessor.go:742-753 shouldCheckpoint condition."""
        return (
            self.checkpointer is not None
            and self.checkpoint_interval > 0
            and lease.ttl > self.checkpoint_interval
        )

    def _schedule_checkpoint(self, lease: Lease) -> None:
        self.checkpoint_queue.push(
            lease.id, time.monotonic() + self.checkpoint_interval
        )

    def _checkpoint_scheduled(self) -> None:
        """ref: lessor.go:755-795 checkpointScheduledLeases."""
        with self._lock:
            if not self._primary or self.checkpointer is None:
                return
            now = time.monotonic()
            count = 0
            while count < MAX_CHECKPOINT_BATCH:
                lid = self.checkpoint_queue.peek_due(now)
                if lid is None:
                    break
                self.checkpoint_queue.pop()
                lease = self.lease_map.get(lid)
                if lease is None:
                    continue
                remaining = lease.remaining()
                if remaining == FOREVER:
                    continue
                self.checkpointer(lid, max(int(remaining), 0))
                self._schedule_checkpoint(lease)
                count += 1

    def stop(self) -> None:
        self._stopped.set()
        with self._expired_cv:
            self._expired_cv.notify_all()
        # Join so no loop iteration touches the backend after our owner
        # closes it (daemon threads in C calls at teardown can fault).
        if self._loop.is_alive():
            self._loop.join(timeout=5)
