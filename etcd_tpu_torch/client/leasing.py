"""Client-side leasing: a write-through cache over keys "owned" via
leasing markers (ref: client/v3/leasing/{kv,cache,txn}.go).

Protocol (all LeasingKV clients cooperate through marker keys under a
shared prefix; a plain Client bypassing the protocol must not touch the
leased keys, same caveat as the reference):

* **acquire on read** — a txn atomically creates ``pfx+key`` bound to
  the session lease and reads the key; once owned, gets serve from the
  local cache with no server round-trip (kv.go Get fast path);
* **write-through** — the owner updates via a txn guarded on its marker
  still existing, then updates the cache (txn.go applyf);
* **revocation** — a non-owner writer stamps the marker with "REVOKE";
  every owner watches its markers and deletes them (dropping cache) on
  revoke, unblocking the writer (kv.go revoke/waitSession);
* session death releases all markers via lease expiry.

Ports ``etcd_tpu/client/leasing.py``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

from ..server import api as sapi
from ..storage.mvcc.kv import EventType
from .client import Client
from .util import prefix_end
from .concurrency import Session

REVOKE = b"REVOKE"


class LeasingKV:
    def __init__(self, client: Client, prefix: str,
                 session_ttl: int = 10) -> None:
        self.c = client
        self.pfx = prefix.encode() if isinstance(prefix, str) else prefix
        self.session = Session(client, ttl=session_ttl)
        self._lock = threading.Lock()
        self._cache: Dict[bytes, Optional[sapi.KeyValue]] = {}
        self._owned: Dict[bytes, int] = {}  # key -> marker create_rev
        # key -> header captured at acquisition; cache hits serve it so
        # header.revision never regresses to 0 (ref: leasing/kv.go Get).
        self._hdr: Dict[bytes, sapi.ResponseHeader] = {}
        self._acquiring: set = set()  # keys mid-acquisition
        self._revoked_early: set = set()  # REVOKE seen while acquiring
        self.cache_hits = 0
        self._closed = False
        self._watch = client.watch(self.pfx, prefix_end(self.pfx))
        self._watcher = threading.Thread(target=self._watch_loop, daemon=True)
        self._watcher.start()

    def close(self) -> None:
        self._closed = True
        self._watch.cancel()
        self._watcher.join(timeout=5)
        # Release markers so other clients acquire immediately.
        with self._lock:
            owned = list(self._owned)
            self._owned.clear()
            self._cache.clear()
            self._hdr.clear()
        for key in owned:
            try:
                self.c.delete(self.pfx + key)
            except Exception:  # noqa: BLE001 — lease expiry reclaims
                pass
        self.session.close()

    # -- read path -------------------------------------------------------------

    def get(self, key: bytes) -> sapi.RangeResponse:
        with self._lock:
            if key in self._owned:
                self.cache_hits += 1
                kv = self._cache.get(key)
                return sapi.RangeResponse(
                    header=self._hdr.get(key, sapi.ResponseHeader()),
                    kvs=[kv] if kv is not None else [],
                    count=1 if kv is not None else 0,
                )
        marker = self.pfx + key
        # Atomically acquire the marker + read the key (kv.go Get txn).
        txn = sapi.TxnRequest(
            compare=[sapi.Compare(
                target=sapi.CompareTarget.CREATE,
                result=sapi.CompareResult.EQUAL,
                key=marker, create_revision=0,
            )],
            success=[
                sapi.RequestOp(request_put=sapi.PutRequest(
                    key=marker, value=b"", lease=self.session.lease_id,
                )),
                sapi.RequestOp(request_range=sapi.RangeRequest(key=key)),
            ],
            failure=[
                sapi.RequestOp(request_range=sapi.RangeRequest(key=key)),
            ],
        )
        with self._lock:
            self._acquiring.add(key)
            self._revoked_early.discard(key)
        try:
            resp = self.c.txn(txn)
            if resp.succeeded:
                rr = resp.responses[1].response_range
                with self._lock:
                    poisoned = key in self._revoked_early
                    if not poisoned:
                        self._owned[key] = resp.header.revision
                        self._cache[key] = rr.kvs[0] if rr.kvs else None
                        self._hdr[key] = resp.header
                if poisoned:
                    # A REVOKE raced our acquisition: release right away
                    # so the waiting writer proceeds.
                    try:
                        self.c.delete(marker)
                    except Exception:  # noqa: BLE001 — lease reclaims
                        pass
            else:
                rr = resp.responses[0].response_range
            return rr
        finally:
            with self._lock:
                self._acquiring.discard(key)
                self._revoked_early.discard(key)

    # -- write path ------------------------------------------------------------

    def put(self, key: bytes, value: bytes,
            timeout: float = 10.0) -> sapi.PutResponse:
        marker = self.pfx + key
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                owned_rev = self._owned.get(key)
            if owned_rev is not None:
                # Owner write-through, guarded on OUR marker (created at
                # the acquisition revision) still existing — "any marker
                # exists" would pass after another client re-acquired.
                txn = sapi.TxnRequest(
                    compare=[sapi.Compare(
                        target=sapi.CompareTarget.CREATE,
                        result=sapi.CompareResult.EQUAL,
                        key=marker, create_revision=owned_rev,
                    )],
                    success=[sapi.RequestOp(
                        request_put=sapi.PutRequest(key=key, value=value)
                    )],
                )
                resp = self.c.txn(txn)
                if resp.succeeded:
                    pr = resp.responses[0].response_put
                    with self._lock:
                        if key in self._owned:
                            self._hdr[key] = resp.header
                            prev = self._cache.get(key)
                            rev = resp.header.revision
                            self._cache[key] = sapi.KeyValue(
                                key=key, value=value,
                                mod_revision=rev,
                                create_revision=(
                                    prev.create_revision if prev else rev
                                ),
                                version=(prev.version + 1 if prev else 1),
                                lease=prev.lease if prev else 0,
                            )
                    return pr
                with self._lock:  # lost ownership mid-flight
                    self._owned.pop(key, None)
                    self._cache.pop(key, None)
                    self._hdr.pop(key, None)
                continue
            # Non-owner: write directly if unleased, else request revoke.
            txn = sapi.TxnRequest(
                compare=[sapi.Compare(
                    target=sapi.CompareTarget.CREATE,
                    result=sapi.CompareResult.EQUAL,
                    key=marker, create_revision=0,
                )],
                success=[sapi.RequestOp(
                    request_put=sapi.PutRequest(key=key, value=value)
                )],
                failure=[sapi.RequestOp(
                    # ignore_lease keeps the marker bound to the OWNER's
                    # session lease: if the owner died, the marker still
                    # expires with that lease instead of living forever
                    # (ref: client/v3/leasing/kv.go:410 WithIgnoreLease).
                    request_put=sapi.PutRequest(
                        key=marker, value=REVOKE, ignore_lease=True
                    )
                )],
            )
            resp = self.c.txn(txn)
            if resp.succeeded:
                return resp.responses[0].response_put
            # Wait for the owner to release, then retry.
            self._wait_marker_gone(marker, deadline)
        raise TimeoutError(f"leasing put {key!r} timed out")

    def _wait_marker_gone(self, marker: bytes, deadline: float) -> None:
        while time.monotonic() < deadline:
            r = self.c.get(marker)
            if r.count == 0:
                return
            time.sleep(0.05)

    # -- revocation watcher ----------------------------------------------------

    def _watch_loop(self) -> None:
        while not self._closed:
            got = self._watch.get(timeout=0.2)
            if got is None:
                continue
            _, events = got
            for ev in events:
                key = ev.kv.key[len(self.pfx):]
                if ev.type == EventType.PUT and ev.kv.value == REVOKE:
                    with self._lock:
                        if key in self._acquiring:
                            # Acquisition in flight: poison it so the
                            # winner releases immediately.
                            self._revoked_early.add(key)
                        mine = key in self._owned
                        if mine:
                            self._owned.pop(key, None)
                            self._cache.pop(key, None)
                            self._hdr.pop(key, None)
                    if mine:
                        try:
                            self.c.delete(self.pfx + key)
                        except Exception:  # noqa: BLE001
                            pass
                elif ev.type == EventType.DELETE:
                    # Marker gone (owner released or lease expired).
                    with self._lock:
                        self._owned.pop(key, None)
                        self._cache.pop(key, None)
                        self._hdr.pop(key, None)


