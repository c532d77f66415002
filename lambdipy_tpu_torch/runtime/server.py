"""A small threaded HTTP server for a port handler: ``GET /healthz``,
``POST /invoke`` (``"stream": true`` answers chunked ndjson, one line per
decode segment) and ``GET /metrics`` (request counters, each kernel's
launch counter, the continuous engine and its page pool). The port's
counterpart of the invoke path of ``lambdipy_tpu/runtime/server.py``; a
full page arena is a priced 503 shed (reason ``kv_pages``) as there.
Scheduling and the fleet surfaces are not ported yet."""

from __future__ import annotations

import json
import math
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from lambdipy_tpu_torch.runtime.handlers import HandlerState
from lambdipy_tpu_torch.runtime.pagepool import PagesExhausted


class _Stats:
    def __init__(self):
        self._lock = threading.Lock()
        self.requests = 0
        self.errors = 0
        self.busy_s = 0.0
        self.sheds: dict[str, int] = {}

    def record(self, seconds: float, ok: bool) -> None:
        with self._lock:
            self.requests += 1
            self.errors += 0 if ok else 1
            self.busy_s += seconds

    def record_shed(self, reason: str) -> None:
        """A refused request (backpressure, not an error)."""
        with self._lock:
            self.requests += 1
            self.sheds[reason] = self.sheds.get(reason, 0) + 1

    def report(self) -> dict:
        with self._lock:
            return {"requests": self.requests, "errors": self.errors,
                    "busy_s": self.busy_s, "sheds": dict(self.sheds)}


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

            def _send(self, code: int, payload: dict,
                      headers: dict | None = None) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for key, val in (headers or {}).items():
                    self.send_header(key, val)
                self.end_headers()
                self.wfile.write(body)

            def _send_shed(self, reason: str, retry_after_s: float) -> None:
                """503 + Retry-After (whole seconds; the body carries the
                exact float), shaped as the JAX server's sheds."""
                server.stats.record_shed(reason)
                self._send(503, {"ok": False, "error": f"shed: {reason}",
                                 "shed": reason,
                                 "retry_after_s": round(retry_after_s, 3)},
                           {"Retry-After":
                            str(max(1, math.ceil(retry_after_s)))})

            def _write_frame(self, body: bytes) -> bool:
                """One chunked-transfer frame; False when the client went
                away."""
                try:
                    self.wfile.write(f"{len(body):x}\r\n".encode()
                                     + body + b"\r\n")
                    return True
                except OSError:
                    self.close_connection = True
                    return False

            def _send_stream(self, request: dict, t0: float) -> None:
                """Chunked ndjson, one line per decode segment. The first
                record is taken before the headers go out, so a refused
                admission is still a 503; a later error becomes a final
                ``{"ok": false}`` line."""
                records = server.state.invoke_stream(request)
                try:
                    first = next(records)
                except PagesExhausted as e:
                    self._send_shed("kv_pages", e.retry_after_s)
                    return
                except (ValueError, TypeError, KeyError) as e:
                    server.stats.record(time.monotonic() - t0, False)
                    self._send(400, {"ok": False, "error": str(e)})
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                ok = first.get("ok", False)
                try:
                    if self._write_frame(json.dumps(first).encode() + b"\n"):
                        for rec in records:
                            if not self._write_frame(
                                    json.dumps(rec).encode() + b"\n"):
                                break
                except Exception as e:  # noqa: BLE001 — headers are sent
                    traceback.print_exc()
                    ok = False
                    self._write_frame(json.dumps(
                        {"ok": False, "error": repr(e)}).encode() + b"\n")
                finally:
                    records.close()
                try:
                    self.wfile.write(b"0\r\n\r\n")
                except OSError:
                    self.close_connection = True
                server.stats.record(time.monotonic() - t0, ok)

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
                if request.get("stream"):
                    self._send_stream(request, t0)
                    return
                try:
                    result = server.state.invoke(request)
                    code = 200 if result.get("ok") else 400
                except PagesExhausted as e:
                    # the paged KV arena is transiently full: priced
                    # backpressure, not an error
                    self._send_shed("kv_pages", e.retry_after_s)
                    return
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
