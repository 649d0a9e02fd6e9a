"""The legacy v2 HTTP API (ref: server/etcdserver/api/v2http/client.go —
keysHandler serveKeys, /v2/keys REST semantics).

Request grammar (client.go parseKeyRequest):

    GET    /v2/keys/foo?recursive=&sorted=&wait=&waitIndex=
    PUT    /v2/keys/foo  value=&ttl=&dir=&prevValue=&prevIndex=&prevExist=
    POST   /v2/keys/foo  value=&ttl=           (in-order unique create)
    DELETE /v2/keys/foo  ?recursive=&dir=&prevValue=&prevIndex=

Writes are proposed through raft (EtcdServer.v2_write → apply_v2);
reads and waits serve from the local v2 store. Errors travel as the
reference's JSON error body {errorCode, message, cause, index}.

Ports ``etcd_tpu/v2http.py``.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import parse_qs, urlparse

from .v2store.store import Event, NodeExtern, V2Error

_ERROR_MESSAGES = {
    100: "Key not found",
    101: "Compare failed",
    102: "Not a file",
    104: "Not a directory",
    105: "Key already exists",
    107: "Root is read only",
    108: "Directory not empty",
}


def _enc_node(n: NodeExtern) -> dict:
    out: dict = {"key": n.key,
                 "createdIndex": n.created_index,
                 "modifiedIndex": n.modified_index}
    if n.dir:
        out["dir"] = True
    else:
        out["value"] = n.value or ""
    if n.ttl:
        out["ttl"] = n.ttl
    if n.nodes:
        out["nodes"] = [_enc_node(c) for c in n.nodes]
    return out


def _enc_event(ev: Event) -> dict:
    out = {"action": ev.action, "node": _enc_node(ev.node)}
    if ev.prev_node is not None:
        out["prevNode"] = _enc_node(ev.prev_node)
    return out


def _flag(q: dict, name: str) -> bool:
    v = q.get(name, ["false"])[0]
    return v in ("true", "1", "")


class V2HTTP:
    """One member's /v2/keys endpoint (plus /v2/stats placeholders)."""

    def __init__(self, server, bind: Tuple[str, int] = ("127.0.0.1", 0)):
        self.s = server
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                outer._handle(self, "GET")

            def do_PUT(self):
                outer._handle(self, "PUT")

            def do_POST(self):
                outer._handle(self, "POST")

            def do_DELETE(self):
                outer._handle(self, "DELETE")

        self.httpd = ThreadingHTTPServer(bind, Handler)
        self.addr = self.httpd.server_address
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, kwargs={"poll_interval": 0.1},
            daemon=True)
        self._thread.start()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(timeout=5)

    # -- request handling ------------------------------------------------------

    def _handle(self, h: BaseHTTPRequestHandler, method: str) -> None:
        u = urlparse(h.path)
        if not u.path.startswith("/v2/keys"):
            self._reply(h, 404, {"message": "404 page not found"})
            return
        path = u.path[len("/v2/keys"):] or "/"
        q = parse_qs(u.query, keep_blank_values=True)
        # PUT/POST/DELETE carry form-encoded bodies (client.go).
        ln = int(h.headers.get("Content-Length") or 0)
        if ln:
            q.update(parse_qs(h.rfile.read(ln).decode(),
                              keep_blank_values=True))
        try:
            if method == "GET":
                self._get(h, path, q)
            elif method == "PUT":
                self._put(h, path, q)
            elif method == "POST":
                self._post(h, path, q)
            else:
                self._delete(h, path, q)
        except V2Error as e:
            self._reply(h, 404 if e.code == 100 else 412 if e.code == 101
                        else 403 if e.code == 107 else 400, {
                            "errorCode": e.code,
                            "message": _ERROR_MESSAGES.get(e.code, "error"),
                            "cause": e.cause,
                            "index": e.index,
                        })
        except Exception as e:  # noqa: BLE001 — raft-level errors
            self._reply(h, 500, {"errorCode": 300,
                                 "message": "Raft Internal Error",
                                 "cause": str(e), "index": 0})

    def _get(self, h, path: str, q) -> None:
        if _flag(q, "wait"):
            since = int(q.get("waitIndex", ["0"])[0] or 0)
            w = self.s.v2store.watch(
                path, recursive=_flag(q, "recursive"), since=since)
            ev = w.wait(timeout=30.0)
            if ev is None:
                self._reply(h, 200, None)  # long-poll timeout: empty
                return
            self._reply(h, 200, _enc_event(ev))
            return
        ev = self.s.v2_get(path, recursive=_flag(q, "recursive"),
                           sorted_=_flag(q, "sorted"))
        self._reply(h, 200, _enc_event(ev))

    def _put(self, h, path: str, q) -> None:
        value = q.get("value", [""])[0]
        ttl = self._ttl(q)
        dir_ = _flag(q, "dir")
        prev_value = q.get("prevValue", [None])[0]
        prev_index = int(q.get("prevIndex", ["0"])[0] or 0)
        prev_exist = q.get("prevExist", [None])[0]
        if prev_value is not None or prev_index:
            ev = self.s.v2_write("cas", path, value=value, ttl=ttl,
                                 prev_value=prev_value,
                                 prev_index=prev_index)
            code = 200
        elif prev_exist == "true":
            ev = self.s.v2_write("update", path, value=value, ttl=ttl)
            code = 200
        elif prev_exist == "false":
            ev = self.s.v2_write("create", path, value=value, ttl=ttl,
                                 dir=dir_)
            code = 201
        else:
            ev = self.s.v2_write("set", path, value=value, ttl=ttl, dir=dir_)
            code = 201 if ev.prev_node is None else 200
        self._reply(h, code, _enc_event(ev))

    def _post(self, h, path: str, q) -> None:
        ev = self.s.v2_write("create", path, value=q.get("value", [""])[0],
                             ttl=self._ttl(q), unique=True)
        self._reply(h, 201, _enc_event(ev))

    def _delete(self, h, path: str, q) -> None:
        prev_value = q.get("prevValue", [None])[0]
        prev_index = int(q.get("prevIndex", ["0"])[0] or 0)
        if prev_value is not None or prev_index:
            ev = self.s.v2_write("cad", path, prev_value=prev_value,
                                 prev_index=prev_index)
        else:
            ev = self.s.v2_write("delete", path,
                                 recursive=_flag(q, "recursive"),
                                 dir=_flag(q, "dir"))
        self._reply(h, 200, _enc_event(ev))

    @staticmethod
    def _ttl(q) -> Optional[float]:
        raw = q.get("ttl", [None])[0]
        return float(raw) if raw else None

    def _reply(self, h, code: int, body: Optional[dict]) -> None:
        data = json.dumps(body).encode() if body is not None else b"{}"
        try:
            h.send_response(code)
            h.send_header("Content-Type", "application/json")
            h.send_header("X-Etcd-Index", str(self.s.v2store.index))
            h.send_header("Content-Length", str(len(data)))
            h.end_headers()
            h.wfile.write(data)
        except OSError:
            pass
