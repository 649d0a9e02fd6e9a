"""Ordering guard: reject responses that travel back in time
(ref: client/v3/ordering/kv.go + util.go — tracks the max revision seen
and errors when a (possibly stale, failed-over) server answers with an
older one).

Ports ``etcd_tpu/client/ordering.py``.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from ..server import api as sapi
from .client import Client


class OrderViolationError(Exception):
    """ref: ordering.ErrNoGreaterRev."""


def new_order_violation_switch_endpoint_closure(client: Client):
    """The reference's remedy: rotate to another endpoint and retry once
    (ordering/util.go NewOrderViolationSwitchEndpointClosure)."""

    def fix(_err: OrderViolationError) -> None:
        client._rotate_endpoint()

    return fix


class OrderingKV:
    """Wraps a Client's read path with the monotonic-revision check."""

    def __init__(self, client: Client,
                 violation_fn: Optional[Callable] = None) -> None:
        self.c = client
        self.violation_fn = violation_fn
        self._lock = threading.Lock()
        self._prev_rev = 0

    def _violated(self, header: sapi.ResponseHeader) -> bool:
        with self._lock:
            if header.revision < self._prev_rev:
                return True
            self._prev_rev = max(self._prev_rev, header.revision)
            return False

    def _do(self, op: Callable[[], object], retry: bool):
        """Run op; on an order violation apply the remedy (endpoint
        rotate) and — for READS only — retry ONCE before raising, the
        way the reference reissues the request after the violation
        closure runs (ordering/kv.go). Mutations are never re-executed:
        the first attempt already committed, and replaying it would
        double-apply the write."""
        resp = op()
        if not self._violated(resp.header):
            return resp
        err = OrderViolationError(
            f"revision {resp.header.revision} < previously seen revision"
        )
        if self.violation_fn is None:
            raise err
        self.violation_fn(err)
        if not retry:
            raise err
        resp = op()
        if self._violated(resp.header):
            raise err
        return resp

    def get(self, key: bytes, **kw) -> sapi.RangeResponse:
        return self._do(lambda: self.c.get(key, **kw), retry=True)

    def put(self, key: bytes, value: bytes, **kw) -> sapi.PutResponse:
        return self._do(lambda: self.c.put(key, value, **kw), retry=False)

    def delete(self, key: bytes, **kw) -> sapi.DeleteRangeResponse:
        return self._do(lambda: self.c.delete(key, **kw), retry=False)

    def txn(self, req: sapi.TxnRequest) -> sapi.TxnResponse:
        return self._do(lambda: self.c.txn(req), retry=False)
