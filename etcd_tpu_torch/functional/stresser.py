"""Stressers: sustained load that tolerates member failures
(ref: tests/functional/tester/stresser_key.go, stresser_lease.go).

Ports ``etcd_tpu/functional/stresser.py``."""

from __future__ import annotations

import random
import threading
from typing import List, Optional

from ..server.api import (
    Compare, CompareResult, CompareTarget, DeleteRangeRequest, PutRequest,
    RangeRequest, RequestOp, TxnRequest,
)


class KVStresser:
    """Writer threads hammering random keys with put/delete/txn against
    whichever member currently accepts writes. Errors during faults are
    expected and counted, not raised."""

    def __init__(self, cluster, prefix: bytes = b"stress/",
                 keyspace: int = 64, writers: int = 2, seed: int = 0) -> None:
        self.cluster = cluster
        self.prefix = prefix
        self.keyspace = keyspace
        self.writers = writers
        self.rand = random.Random(seed)
        self.success = 0
        self.failure = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

    def start(self) -> None:
        for i in range(self.writers):
            t = threading.Thread(target=self._loop, args=(i,), daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=15)

    def _key(self, rnd: random.Random) -> bytes:
        return self.prefix + str(rnd.randrange(self.keyspace)).encode()

    def _loop(self, idx: int) -> None:
        rnd = random.Random(idx)
        seq = 0
        while not self._stop.is_set():
            lead = self.cluster.leader()
            if lead is None:
                self._stop.wait(0.05)
                continue
            key = self._key(rnd)
            seq += 1
            try:
                op = rnd.random()
                if op < 0.7:
                    lead.put(PutRequest(key=key, value=b"v%d" % seq))
                elif op < 0.85:
                    lead.delete_range(DeleteRangeRequest(key=key))
                else:
                    lead.txn(TxnRequest(
                        compare=[Compare(
                            target=CompareTarget.VERSION,
                            result=CompareResult.GREATER,
                            key=key, version=0,
                        )],
                        success=[RequestOp(request_put=PutRequest(
                            key=key, value=b"t%d" % seq,
                        ))],
                        failure=[RequestOp(request_put=PutRequest(
                            key=key, value=b"f%d" % seq,
                        ))],
                    ))
                with self._lock:
                    self.success += 1
            except Exception:  # noqa: BLE001 — faults make these expected
                with self._lock:
                    self.failure += 1
                self._stop.wait(0.02)


class LeaseStresser:
    """Grants short leases with attached keys; the checker later
    verifies expiry semantics (stresser_lease.go)."""

    def __init__(self, cluster, prefix: bytes = b"leased/",
                 ttl: int = 2) -> None:
        self.cluster = cluster
        self.prefix = prefix
        self.ttl = ttl
        self.granted: List[int] = []
        self.keys: List[bytes] = []

    def grant_with_keys(self, n: int = 3) -> None:
        lead = self.cluster.wait_leader()
        for i in range(n):
            resp = lead.lease_grant(ttl=self.ttl)
            key = self.prefix + str(resp.id).encode()
            lead.put(PutRequest(key=key, value=b"x", lease=resp.id))
            self.granted.append(resp.id)
            self.keys.append(key)
