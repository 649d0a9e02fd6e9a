"""v2 HTTP reverse proxy (ref: server/proxy/httpproxy — the legacy
mode started by `etcd --proxy on`): forwards /v2/* to cluster members,
failing over to the next endpoint only while the request has not been
sent (a replayed non-idempotent v2 write could double-apply).

Ports ``etcd_tpu/proxy/httpproxy.py``.
"""

from __future__ import annotations

import http.client
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Tuple

_HOP_HEADERS = {
    "connection", "keep-alive", "proxy-authenticate",
    "proxy-authorization", "te", "trailers", "transfer-encoding",
    "upgrade", "host", "content-length",
}


class HTTPProxy:
    """Forwarding proxy for the v2 REST surface; a failed endpoint is
    rotated out of first position (ref: proxy/httpproxy/proxy.go +
    director.go)."""

    def __init__(self, endpoints: List[Tuple[str, int]],
                 bind: Tuple[str, int] = ("127.0.0.1", 0)):
        if not endpoints:
            raise ValueError("no endpoints")
        self.endpoints = list(endpoints)
        self._i = 0
        self._lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def _fwd(self):
                outer._forward(self)

            do_GET = do_PUT = do_POST = do_DELETE = _fwd

        self.httpd = ThreadingHTTPServer(bind, Handler)
        self.addr = self.httpd.server_address
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, kwargs={"poll_interval": 0.1},
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(timeout=5)

    def _forward(self, h: BaseHTTPRequestHandler) -> None:
        ln = int(h.headers.get("Content-Length") or 0)
        body = h.rfile.read(ln) if ln else None
        headers = {k: v for k, v in h.headers.items()
                   if k.lower() not in _HOP_HEADERS}
        with self._lock:
            order = [self.endpoints[(self._i + j) % len(self.endpoints)]
                     for j in range(len(self.endpoints))]
        last_err = None
        for host, port in order:
            conn = http.client.HTTPConnection(host, port, timeout=10)
            try:
                # Connect-phase failures fail over; anything after the
                # request is on the wire must NOT be replayed (the v2
                # surface carries non-idempotent writes).
                conn.connect()
            except OSError as e:
                last_err = e
                conn.close()
                with self._lock:
                    self._i = (self._i + 1) % len(self.endpoints)
                continue
            try:
                conn.request(h.command, h.path, body=body, headers=headers)
                resp = conn.getresponse()
                payload = resp.read()
            except (OSError, http.client.HTTPException) as e:
                conn.close()
                try:
                    h.send_error(502, f"upstream failed mid-request: {e}")
                except OSError:
                    pass
                return
            conn.close()
            try:
                h.send_response(resp.status)
                for k, v in resp.getheaders():
                    if k.lower() not in _HOP_HEADERS:
                        h.send_header(k, v)
                h.send_header("Content-Length", str(len(payload)))
                h.end_headers()
                h.wfile.write(payload)
            except OSError:
                pass
            return
        try:
            h.send_error(502, f"no endpoint reachable: {last_err}")
        except OSError:
            pass
