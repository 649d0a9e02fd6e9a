"""Shared framed-RPC server connection scaffolding, used by both the
member RPC server (service.py) and the grpcproxy — one copy of the
frame pump, per-request threading, and error-frame shaping.

Ports ``etcd_tpu/v3rpc/connbase.py``."""

from __future__ import annotations

import socket
import threading
from typing import Any, Callable, Dict, Optional

from . import wire
from ..pkg import rpctypes


class FramedServerConn:
    """One downstream connection: read loop spawning a handler thread
    per request frame; writes serialized under a lock.

    Subclasses implement ``dispatch(method, params, token) -> result``
    and may override ``on_close`` / ``on_sent`` / byte counters."""

    recv_counter: Optional[Callable[[int], None]] = None
    sent_counter: Optional[Callable[[int], None]] = None

    def __init__(self, sock: socket.socket,
                 stopped: "threading.Event") -> None:
        self.sock = sock
        self.wlock = threading.Lock()
        self._stopped = stopped
        threading.Thread(target=self._read_loop, daemon=True).start()

    # -- override points -------------------------------------------------------

    def dispatch(self, method: str, params: Dict, token: Optional[str]) -> Any:
        raise NotImplementedError

    def encode_result(self, result: Any) -> Any:
        return result

    def encode_error(self, e: Exception) -> Dict[str, Any]:
        """Typed error frame. Canonical-table errors carry a stable
        symbolic code + gRPC status code (ref: api/v3rpc/rpctypes/
        error.go); the class name rides along as ``type`` for older
        peers."""
        out: Dict[str, Any] = {"type": type(e).__name__, "msg": str(e)}
        entry = rpctypes.entry_for_exception(e)
        if entry is not None:
            sym, code, _canonical = entry
            out["code"] = sym
            out["grpcCode"] = int(code)
        return out

    def on_close(self) -> None:
        pass

    def after_send(self, method: str, params: Dict, result: Any) -> None:
        """Runs after the response frame went out (ordering hook: e.g.
        start watch event pumps only once the create response is on the
        wire)."""

    # -- machinery -------------------------------------------------------------

    def send_frame(self, obj: Dict[str, Any]) -> bool:
        try:
            with self.wlock:
                n = wire.write_frame(self.sock, obj)
            if self.sent_counter is not None:
                self.sent_counter(n)
            return True
        except OSError:
            return False

    def _read_loop(self) -> None:
        try:
            while not self._stopped.is_set():
                req = wire.read_frame(self.sock, counter=self.recv_counter)
                if req is None:
                    return
                threading.Thread(
                    target=self._handle, args=(req,), daemon=True
                ).start()
        except OSError:
            return  # peer went away; on_close in finally
        except Exception:  # noqa: BLE001 — a framing crash must be loud
            import sys
            import traceback
            print("v3rpc conn read loop crashed:", file=sys.stderr)
            traceback.print_exc()
        finally:
            self.on_close()
            try:
                self.sock.close()
            except OSError:
                pass

    def _handle(self, req: Dict[str, Any]) -> None:
        rid = req.get("id")
        method = req.get("method", "")
        params = req.get("params", {}) or {}
        token = req.get("token")
        try:
            result = self.dispatch(method, params, token)
            self.send_frame({"id": rid, "result": self.encode_result(result)})
            self.after_send(method, params, result)
        except Exception as e:  # noqa: BLE001 — typed error to the client
            self.send_frame({"id": rid, "error": self.encode_error(e)})
