"""A small threaded HTTP server for a port handler: ``GET /healthz``,
``POST /invoke`` and ``GET /metrics`` (request counters, latency and
each kernel's launch counter). The port's counterpart of the invoke
path of ``lambdipy_tpu/runtime/server.py``; scheduling, batching and
the fleet surfaces are not ported yet."""

from __future__ import annotations

import json
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from lambdipy_tpu_torch.runtime.handlers import HandlerState


class _Stats:
    def __init__(self):
        self._lock = threading.Lock()
        self.requests = 0
        self.errors = 0
        self.busy_s = 0.0

    def record(self, seconds: float, ok: bool) -> None:
        with self._lock:
            self.requests += 1
            self.errors += 0 if ok else 1
            self.busy_s += seconds

    def report(self) -> dict:
        with self._lock:
            return {"requests": self.requests, "errors": self.errors,
                    "busy_s": self.busy_s}


class BundleServer:
    """Serves one :class:`HandlerState` on ``host:port`` (port 0 picks a
    free port). ``start_background()`` runs it on a thread, ``stop()``
    shuts it down and closes the socket."""

    def __init__(self, state: HandlerState, *, host: str = "127.0.0.1",
                 port: int = 0):
        self.state = state
        self.stats = _Stats()
        self._thread = None
        self.httpd = ThreadingHTTPServer((host, port), self._handler_class())
        self.httpd.daemon_threads = True

    @property
    def url(self) -> str:
        host, port = self.httpd.server_address[:2]
        return f"http://{host}:{port}"

    def _handler_class(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet access log
                pass

            def _send(self, code: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, {"ok": True, **server.state.meta})
                elif self.path == "/metrics":
                    self._send(200, {"server": server.stats.report(),
                                     "handler": server.state.stats()})
                else:
                    self._send(404, {"ok": False, "error": "not found"})

            def do_POST(self):
                if self.path != "/invoke":
                    self._send(404, {"ok": False, "error": "not found"})
                    return
                length = int(self.headers.get("Content-Length") or 0)
                try:
                    request = json.loads(self.rfile.read(length) or b"{}")
                except json.JSONDecodeError as e:
                    server.stats.record(0.0, False)
                    self._send(400, {"ok": False, "error": f"bad json: {e}"})
                    return
                t0 = time.monotonic()
                try:
                    result = server.state.invoke(request)
                    code = 200 if result.get("ok") else 400
                except (ValueError, TypeError, KeyError) as e:
                    result, code = {"ok": False, "error": str(e)}, 400
                except Exception as e:  # noqa: BLE001 — report, keep serving
                    traceback.print_exc()
                    result, code = {"ok": False, "error": repr(e)}, 500
                server.stats.record(time.monotonic() - t0, code == 200)
                self._send(code, result)

        return Handler

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def start_background(self) -> "BundleServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="bundle-server", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
