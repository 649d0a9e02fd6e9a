"""HTTP observability endpoints: /health, /readyz, /livez, /metrics,
/version (ref: server/etcdserver/api/etcdhttp/{metrics,base}.go,
embed/etcd.go:731 serveMetrics).

Health semantics follow etcdhttp/metrics.go:34-121:

* ``/health`` — unhealthy if a NOSPACE/CORRUPT alarm is raised (unless
  excluded via ``?exclude=NOSPACE``), if there is no leader (unless
  ``?serializable=true``), and optionally proves linearizable progress
  with a ReadIndex barrier.
* ``/readyz`` / ``/livez`` — aggregate check endpoints with per-check
  listing via ``?verbose``.
* ``/metrics`` — the pkg.metrics registry in Prometheus text format.
* ``/version`` — {"etcdserver", "etcdcluster"}.

Ports ``etcd_tpu/etcdhttp.py``.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import parse_qs, urlparse

from . import version as ver
from .pkg import metrics as pmet


class EtcdHTTP:
    """Serves health/metrics for one EtcdServer. `server` may be None
    (metrics-only listener)."""

    def __init__(
        self,
        server=None,
        bind: Tuple[str, int] = ("127.0.0.1", 0),
        registry: Optional[pmet.Registry] = None,
        serve_gateway: bool = False,
    ) -> None:
        """`serve_gateway` mounts the JSON write surface (/v3/...) on
        this listener — keep it OFF for metrics/health listeners."""
        self.server = server
        self.serve_gateway = serve_gateway
        self.registry = registry or pmet.DEFAULT
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                outer._route(self)

            def do_POST(self):
                outer._gateway(self)

        self.httpd = ThreadingHTTPServer(bind, Handler)
        self.addr = self.httpd.server_address
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, kwargs={"poll_interval": 0.1},
            daemon=True,
        )
        self._thread.start()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(timeout=5)

    # -- routing ---------------------------------------------------------------

    def _route(self, h: BaseHTTPRequestHandler) -> None:
        u = urlparse(h.path)
        q = parse_qs(u.query, keep_blank_values=True)
        if u.path == "/metrics":
            self._refresh_gauges()
            body = self.registry.expose().encode()
            self._reply(h, 200, body, "text/plain; version=0.0.4")
        elif u.path == "/version":
            body = json.dumps(
                {
                    "etcdserver": ver.SERVER_VERSION,
                    "etcdcluster": ver.CLUSTER_VERSION,
                }
            ).encode()
            self._reply(h, 200, body, "application/json")
        elif u.path == "/health":
            self._health(h, q)
        elif u.path in ("/readyz", "/livez"):
            self._checkz(h, u.path, q)
        else:
            self._reply(h, 404, b"404 page not found\n")

    def _gateway(self, h: BaseHTTPRequestHandler) -> None:
        """The grpc-gateway JSON interop surface: POST /v3/... with a
        JSON body, bytes base64 (ref: embed/serve.go grpc-gateway mux;
        gatewayjson.py carries the route table)."""
        u = urlparse(h.path)
        not_found = json.dumps({
            "error": "Not Found", "code": 5, "message": "Not Found",
        }).encode()
        if (not self.serve_gateway or not u.path.startswith("/v3/")
                or self.server is None):
            self._reply(h, 404, not_found, "application/json")
            return
        from . import gatewayjson

        try:
            ln = int(h.headers.get("Content-Length") or 0)
            body = json.loads(h.rfile.read(ln) or b"{}")
            token = h.headers.get("Authorization") or None
            out = gatewayjson.handle(self.server, u.path, body, token=token)
            self._reply(h, 200, json.dumps(out).encode(),
                        "application/json")
        except KeyError:
            self._reply(h, 404, not_found, "application/json")
        except Exception as e:  # noqa: BLE001 — gateway error body
            err = {"error": str(e), "code": 2,
                   "message": str(e)}
            self._reply(h, 400, json.dumps(err).encode(),
                        "application/json")

    def _reply(
        self, h: BaseHTTPRequestHandler, code: int, body: bytes,
        ctype: str = "text/plain; charset=utf-8",
    ) -> None:
        try:
            h.send_response(code)
            h.send_header("Content-Type", ctype)
            h.send_header("Content-Length", str(len(body)))
            h.end_headers()
            h.wfile.write(body)
        except OSError:
            pass

    def _refresh_gauges(self) -> None:
        """Point-in-time store gauges, refreshed per scrape (the
        reference refreshes them on backend commit hooks)."""
        s = self.server
        if s is None:
            return
        from .storage.mvcc import metrics as mmet

        try:
            mmet.db_total_size.set(s.be.size())
            mmet.db_in_use_size.set(s.be.size_in_use())
            mmet.current_revision.set(s.kv.rev())
            mmet.compact_revision.set(s.kv.compact_rev)
        except Exception:  # noqa: BLE001 — scrape must not 500
            pass

    # -- health (etcdhttp/metrics.go checkHealth) ------------------------------

    def _health(self, h, q) -> None:
        s = self.server
        if s is None:
            self._reply(h, 200, json.dumps({"health": "true"}).encode(),
                        "application/json")
            return
        excluded = {a for vals in q.get("exclude", []) for a in vals.split(",")}
        serializable = q.get("serializable", ["false"])[0] == "true"

        reason = ""
        healthy = True
        # Alarm check (checkAlarms).
        for am in s.alarms.get():
            short = am.alarm.name  # "NOSPACE" / "CORRUPT"
            if short in excluded:
                continue
            healthy, reason = False, f"alarm activated: {short}"
            break
        # Leader check (checkLeader) — skipped for serializable probes.
        if healthy and not serializable:
            from .raft.raft import NONE

            if s.leader() == NONE:
                healthy, reason = False, "web server has no leader"
        if healthy and not serializable:
            try:
                s.linearizable_read_notify(timeout=2.0)
            except Exception as e:  # noqa: BLE001
                healthy, reason = False, f"QGET ERROR:{type(e).__name__}"
        body = json.dumps(
            {"health": "true" if healthy else "false", "reason": reason}
        ).encode()
        self._reply(h, 200 if healthy else 503, body, "application/json")

    def _checkz(self, h, path: str, q) -> None:
        s = self.server
        checks = {}
        if s is not None:
            if path == "/readyz":
                from .raft.raft import NONE
                from .server.api import AlarmType

                checks["data_corruption"] = not any(
                    am.alarm == AlarmType.CORRUPT for am in s.alarms.get()
                )
                checks["leader"] = s.leader() != NONE
            # A real serializable read proves the local read path is alive
            # (etcdhttp/health.go serializable_read check).
            from .server.api import RangeRequest

            try:
                s.range(RangeRequest(key=b"\x00", serializable=True))
                checks["serializable_read"] = True
            except Exception:  # noqa: BLE001
                checks["serializable_read"] = False
        ok = all(checks.values())
        if "verbose" in q:
            lines = [
                f"[{'+' if v else '-'}]{k} ok" for k, v in checks.items()
            ]
            lines.append("ok" if ok else "failed")
            body = ("\n".join(lines) + "\n").encode()
        else:
            body = b"ok\n" if ok else b"failed\n"
        self._reply(h, 200 if ok else 503, body)
