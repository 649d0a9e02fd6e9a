"""Legacy v2 REST client (ref: client/v2/client.go, keys.go —
KeysAPI Get/Set/Create/CreateInOrder/Update/Delete/Watcher over the
/v2/keys HTTP surface), stdlib http.client only.

Ports ``etcd_tpu/client/v2.py``.
"""

from __future__ import annotations

import http.client
import json
from dataclasses import dataclass, field
from typing import List, Optional, Tuple
from urllib.parse import quote, urlencode


class V2ClientError(Exception):
    """ref: client/v2/client.go Error — the JSON error body."""

    def __init__(self, code: int, message: str, cause: str, index: int):
        super().__init__(f"{code}: {message} ({cause}) [{index}]")
        self.code = code
        self.message = message
        self.cause = cause
        self.index = index


@dataclass
class V2Node:
    key: str = ""
    value: str = ""
    dir: bool = False
    created_index: int = 0
    modified_index: int = 0
    ttl: int = 0
    nodes: List["V2Node"] = field(default_factory=list)


@dataclass
class V2Response:
    action: str = ""
    node: Optional[V2Node] = None
    prev_node: Optional[V2Node] = None
    etcd_index: int = 0


def _dec_node(d: Optional[dict]) -> Optional[V2Node]:
    if d is None:
        return None
    return V2Node(
        key=d.get("key", ""),
        value=d.get("value", ""),
        dir=d.get("dir", False),
        created_index=d.get("createdIndex", 0),
        modified_index=d.get("modifiedIndex", 0),
        ttl=d.get("ttl", 0),
        nodes=[_dec_node(c) for c in d.get("nodes", [])],
    )


class V2Client:
    """One-endpoint-at-a-time REST client with endpoint failover
    (client.go httpClusterClient round-robin)."""

    def __init__(self, endpoints: List[Tuple[str, int]],
                 timeout: float = 10.0):
        self.endpoints = list(endpoints)
        self._i = 0
        self.timeout = timeout

    def _request(self, method: str, path: str, query: dict = None,
                 body: dict = None, timeout: Optional[float] = None):
        query = {k: v for k, v in (query or {}).items() if v is not None}
        body = {k: v for k, v in (body or {}).items() if v is not None}
        url = "/v2/keys" + quote(path)
        if query:
            url += "?" + urlencode(query)
        payload = urlencode(body) if body else None
        if not self.endpoints:
            raise V2ClientError(0, "no endpoints configured", "", 0)
        last: Optional[Exception] = None
        for _ in range(len(self.endpoints)):
            host, port = self.endpoints[self._i % len(self.endpoints)]
            try:
                conn = http.client.HTTPConnection(
                    host, port, timeout=timeout or self.timeout)
                try:
                    headers = {}
                    if payload is not None:
                        headers["Content-Type"] = \
                            "application/x-www-form-urlencoded"
                    conn.request(method, url, body=payload, headers=headers)
                    resp = conn.getresponse()
                    data = json.loads(resp.read() or b"{}")
                    index = int(resp.headers.get("X-Etcd-Index") or 0)
                finally:
                    conn.close()
                if "errorCode" in data:
                    raise V2ClientError(
                        data["errorCode"], data.get("message", ""),
                        data.get("cause", ""), data.get("index", 0))
                return V2Response(
                    action=data.get("action", ""),
                    node=_dec_node(data.get("node")),
                    prev_node=_dec_node(data.get("prevNode")),
                    etcd_index=index,
                )
            except (OSError, TimeoutError) as e:
                last = e
                self._i += 1  # failover
        raise last  # type: ignore[misc]

    # -- KeysAPI (client/v2/keys.go) -------------------------------------------

    def get(self, key: str, recursive: bool = False,
            sorted_: bool = False) -> V2Response:
        return self._request("GET", key, query={
            "recursive": "true" if recursive else None,
            "sorted": "true" if sorted_ else None,
        })

    def set(self, key: str, value: str, ttl: Optional[int] = None,
            prev_value: Optional[str] = None, prev_index: int = 0,
            prev_exist: Optional[bool] = None) -> V2Response:
        body = {"value": value, "ttl": ttl}
        if prev_value is not None:
            body["prevValue"] = prev_value
        if prev_index:
            body["prevIndex"] = prev_index
        if prev_exist is not None:
            body["prevExist"] = "true" if prev_exist else "false"
        return self._request("PUT", key, body=body)

    def mkdir(self, key: str, ttl: Optional[int] = None) -> V2Response:
        return self._request("PUT", key, body={"dir": "true", "ttl": ttl})

    def create(self, key: str, value: str,
               ttl: Optional[int] = None) -> V2Response:
        return self.set(key, value, ttl=ttl, prev_exist=False)

    def create_in_order(self, dir_: str, value: str,
                        ttl: Optional[int] = None) -> V2Response:
        return self._request("POST", dir_, body={"value": value, "ttl": ttl})

    def update(self, key: str, value: str,
               ttl: Optional[int] = None) -> V2Response:
        return self.set(key, value, ttl=ttl, prev_exist=True)

    def delete(self, key: str, recursive: bool = False, dir_: bool = False,
               prev_value: Optional[str] = None,
               prev_index: int = 0) -> V2Response:
        return self._request("DELETE", key, query={
            "recursive": "true" if recursive else None,
            "dir": "true" if dir_ else None,
            "prevValue": prev_value,
            "prevIndex": prev_index or None,
        })

    def watch(self, key: str, recursive: bool = False, after_index: int = 0,
              timeout: float = 30.0) -> Optional[V2Response]:
        """One long-poll wait (keys.go Watcher.Next)."""
        out = self._request("GET", key, query={
            "wait": "true",
            "recursive": "true" if recursive else None,
            "waitIndex": after_index + 1 if after_index else None,
        }, timeout=timeout + 5.0)
        return out if out.node is not None else None
