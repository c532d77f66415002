"""A threaded HTTP server for a port handler, the twin of the serving front
of ``lambdipy_tpu/runtime/server.py``:

- ``GET /healthz``: liveness (always 200), ``ready`` (false once
  draining, while the handler's background warm runs or while the engine
  is wedged), ``warming``, ``wedged`` and the engine's fault state
  (``engine``), JAX's boot fields (``pid``, ``bundle``, ``uptime_s``,
  ``cold_start``, ``skew``, ``handler_meta``: the handler's meta,
  ``warm``: the manifest's, ``debug_flags``), and the scheduler's policy
  and queue depth;
- ``GET /metrics``: the server's counters and latency percentiles, the
  scheduler's report (``sched``) and the handler's stats (each kernel's
  launch counter, the continuous engine, its page pool and pipeline);
- ``POST /invoke``: a JSON request through the handler;
  ``"stream": true`` answers chunked ndjson, one line per decode segment;
- ``POST /v1/completions``: the OpenAI completions shape over the same
  handler, ``"stream": true`` as server-sent events closed by
  ``data: [DONE]``;
- ``POST /shutdown``: drain, then stop (admission closes before the
  answer);
- ``POST /profile``: ``{"invokes": N}`` (1-100, default 3) warmup-shaped
  invokes under ``torch.profiler``, the trace written into
  ``<bundle>/profiles/<ts>/`` (503 when the profiler did not start);
- ``POST /v1/debug/faults`` (arm a fault spec on the live plan, or
  clear it), ``POST /v1/debug/knobs`` (retune the engine's knobs live)
  and ``GET /v1/debug/invariants`` (the pool's and the store's
  accounting), for loopback clients only;
- ``POST /v1/kv/export`` (a prompt head's K/V as one ``runtime/kvwire.py``
  frame, or with ``"stream": true`` as a chunked ``LKVS``/``LKVC``
  stream), ``POST /v1/kv/import`` (a frame, or a chunked body streamed
  in, as a radix insert: a garbage frame is a 400, a full page arena the
  priced 503 ``kv_import``) and ``POST /v1/kv/probe`` (the head tokens
  present);
- ``DELETE /v1/sessions/{id}``: release a session's pins now. A
  session's turns name it in the body (``session_id``,
  ``session_ttl_s``) or the headers ``x-session-id`` /
  ``x-session-ttl-s`` (the body wins); a new session past the pin budget
  is the priced 503 ``session_pins`` with ``Retry-After``.

Every invoke passes the SLO scheduler (``sched/``): admission (per-tenant
token buckets on ``x-api-key`` / ``x-tenant``, a bounded queue, deadline
shedding on ``x-deadline-ms``) and then a policy-ordered wait for one of
``max_concurrency`` run slots, by class (``x-priority``: interactive,
batch or background). Overload is an explicit 429 or 503 with
``Retry-After``; so are a full page arena (reason ``kv_pages``), a row
the engine cancelled at a barrier (its deadline passed), and a request
that arrives while a wedged engine restarts (reason ``wedged``: a wedged
engine with no restart in flight admits, since that request is its
probe).

:meth:`BundleServer.from_bundle` boots a bundle directory
(``runtime/loader.py``); ``python -m lambdipy_tpu_torch.runtime.server
<bundle_dir> [port]`` serves one (:func:`main`)."""

from __future__ import annotations

import functools
import itertools
import json
import math
import os
import signal
import sys
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

from lambdipy_tpu_torch.runtime.continuous import RequestCancelled
from lambdipy_tpu_torch.runtime.handlers import HandlerState
from lambdipy_tpu_torch.runtime.loader import BootReport, load_bundle
from lambdipy_tpu_torch.runtime.kvwire import _MAX_CHUNK_BODY
from lambdipy_tpu_torch.runtime.metrics import LatencyStats
from lambdipy_tpu_torch.runtime.pagepool import PagesExhausted
from lambdipy_tpu_torch.runtime.prefixstore import SessionPinsExceeded
from lambdipy_tpu_torch.sched import (SchedConfig, Scheduler, Shed,
                                      clear_request_context,
                                      set_request_context)
from lambdipy_tpu_torch.sched.policy import make_policy


def _request_token_counts(request: dict | None,
                          prefix_probe=None) -> tuple[int, int]:
    """Best-effort (prefill, decode) token counts for the cost estimator;
    wrong-shaped fields count as zero (validation is the handler's).
    ``prefix_probe`` (prompt ids -> tokens the prefix store would reuse)
    prices the suffix a cache hit will prefill, not the whole prompt."""
    if not isinstance(request, dict):
        return 0, 0
    prefill = 0
    toks = request.get("tokens")
    flat_row = None
    if isinstance(toks, (list, tuple)):
        if toks and isinstance(toks[0], (list, tuple)):
            prefill = sum(len(r) for r in toks
                          if isinstance(r, (list, tuple)))
        else:
            prefill = len(toks)
            flat_row = toks
    prefix = request.get("prefix")
    if isinstance(prefix, (list, tuple)):
        prefill += len(prefix)
    elif prefix_probe is not None and flat_row is not None and prefill:
        try:
            prefill = max(0, prefill - int(prefix_probe(flat_row)))
        except Exception:  # noqa: BLE001 — pricing is advisory
            pass
    decode = 0
    for key in ("max_new_tokens", "max_tokens"):
        raw = request.get(key)
        if isinstance(raw, (int, float)):
            decode = max(0, int(raw))
            break
    return prefill, decode


def _openai_to_internal(req: dict) -> tuple[dict, str | None]:
    """An OpenAI ``/v1/completions`` body as the generate handler's
    request. ``prompt`` may be a string (needs a tokenizer) or an int
    token array. OpenAI's sampling defaults apply: temperature and top_p
    default to 1.0 (sampled); send temperature 0 for greedy."""
    prompt = req.get("prompt")
    internal: dict = {}
    if isinstance(prompt, str):
        internal["text"] = prompt
    elif isinstance(prompt, list) and prompt and \
            all(isinstance(t, int) for t in prompt):
        internal["tokens"] = prompt
    else:
        return {}, "prompt must be a string or an array of token ids"
    if req.get("stop") is not None:
        return {}, "stop sequences are not supported; pass eos_id"
    if req.get("n", 1) != 1:
        return {}, "n > 1 is not supported"
    try:
        if req.get("max_tokens") is not None:
            internal["max_new_tokens"] = int(req["max_tokens"])
        internal["temperature"] = float(req.get("temperature", 1.0))
        internal["top_p"] = float(req.get("top_p", 1.0))
    except (TypeError, ValueError) as e:
        return {}, f"max_tokens/temperature/top_p must be numbers: {e}"
    for knob in ("top_k", "seed", "eos_id", "prefix", "segment",
                 "speculative", "session_id", "session_ttl_s"):
        if req.get(knob) is not None:
            internal[knob] = req[knob]
    lp = req.get("logprobs")
    if lp:
        try:
            if lp is not True and int(lp) > 1:
                return {}, ("top_logprobs > 1 is not supported "
                            "(send logprobs: 1)")
        except (TypeError, ValueError):
            return {}, "logprobs must be a boolean or small integer"
        internal["logprobs"] = True
    internal["stream"] = bool(req.get("stream"))
    return internal, None


def _internal_to_openai(internal: dict, result: dict) -> dict:
    """A handler result in the OpenAI completions shape: the row trimmed
    after its eos (the engine pads it with eos), ``finish_reason``
    ``stop`` or ``length``, and the token usage."""
    row = list((result.get("tokens") or [[]])[0])
    eos = result.get("eos_id", internal.get("eos_id"))
    finish = "length"
    if eos is not None and eos in row:
        row = row[: row.index(eos) + 1]
        finish = "stop"
    n_prompt = int(result.get("n_prompt",
                              len(internal.get("tokens") or [])))
    choice = {"index": 0, "text": result.get("completion", ""),
              "tokens": row, "finish_reason": finish,
              "logprobs": None}
    if result.get("logprobs"):
        lp_row = result["logprobs"][0][: len(row)]
        choice["logprobs"] = {"tokens": [str(t) for t in row],
                              "token_logprobs": lp_row,
                              "top_logprobs": None, "text_offset": None}
    return {
        "object": "text_completion",
        "model": "lambdipy-bundle",
        "choices": [choice],
        "usage": {"prompt_tokens": n_prompt,
                  "completion_tokens": len(row),
                  "total_tokens": n_prompt + len(row)},
    }


class _Stats:
    """The server's counters: requests answered, errors, busy seconds,
    sheds by reason, and the latency percentiles of the requests served."""

    def __init__(self):
        self._lock = threading.Lock()
        self.requests = 0
        self.errors = 0
        self.busy_s = 0.0
        self.sheds: dict[str, int] = {}
        self.latency = LatencyStats()

    def record(self, seconds: float, ok: bool) -> None:
        with self._lock:
            self.requests += 1
            self.errors += 0 if ok else 1
            self.busy_s += seconds
        if ok:
            self.latency.record(seconds * 1e3)

    def record_shed(self, reason: str) -> None:
        """A refused request (backpressure, not an error)."""
        with self._lock:
            self.requests += 1
            self.sheds[reason] = self.sheds.get(reason, 0) + 1

    def report(self) -> dict:
        with self._lock:
            out = {"requests": self.requests, "errors": self.errors,
                   "busy_s": self.busy_s, "sheds": dict(self.sheds)}
        out["latency"] = self.latency.report()
        return out


def sched_config(extra: dict, sched: dict | None = None) -> SchedConfig:
    """The scheduler's configuration, as the JAX server resolves it: the
    extra's ``sched_*`` keys, ``LAMBDIPY_SCHED_POLICY``, then ``sched``
    (the constructor's or the CLI's). Unless ``max_concurrency`` is
    pinned, a batching handler's ``batch_max`` (the continuous engine's,
    or the MicroBatcher's under ``batch_window_ms > 0``) floors it, so
    every slot of the batch can fill."""
    sched = sched or {}
    cfg = SchedConfig.from_extra(extra, **sched)
    pinned = (extra.get("sched_max_concurrency") is not None
              or sched.get("max_concurrency") is not None)
    batching = (str(extra.get("batch_mode", "")).lower() == "continuous"
                or float(extra.get("batch_window_ms", 0) or 0) > 0)
    if not pinned and batching:
        cfg.max_concurrency = max(cfg.max_concurrency,
                                  int(extra.get("batch_max", 8)))
    return cfg


class BundleServer:
    """Serves one :class:`HandlerState` on ``host:port`` (port 0 picks a
    free port) behind a :class:`~lambdipy_tpu_torch.sched.Scheduler`
    configured by :func:`sched_config` from the handler's extra and
    ``sched``. The continuous engine's joiners follow the scheduler's
    policy. ``start_background()`` runs it on a thread; ``stop()`` drains
    (new invokes are shed 503 ``draining``; those admitted finish) and
    closes the socket. ``boot`` is the report of the bundle the state was
    booted from (:meth:`from_bundle`), for ``/healthz`` and
    ``/profile``."""

    def __init__(self, state: HandlerState, *, host: str = "127.0.0.1",
                 port: int = 0, sched: dict | None = None,
                 boot: BootReport | None = None):
        self.state = state
        self.boot = boot
        self.started = time.time()
        self._profile_lock = threading.Lock()
        self.stats = _Stats()
        self.sched = Scheduler(sched_config(
            dict(getattr(state, "extra", None) or {}), sched))
        engine = getattr(state, "engine", None)
        policy = self.sched.policy.name
        if engine is not None and getattr(engine.policy, "name", None) \
                != policy:
            engine.policy = make_policy(policy)
        self.draining = False
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._thread = None
        self._stopped = False
        self.httpd = ThreadingHTTPServer((host, port), self._handler_class())
        self.httpd.daemon_threads = True

    @classmethod
    def from_bundle(cls, bundle_dir: Path, *, host: str = "127.0.0.1",
                    port: int = 0, sched: dict | None = None,
                    warmup: bool = True, device=None) -> "BundleServer":
        """Boot ``bundle_dir`` (``runtime/loader.py load_bundle``) and serve
        its handler. The handler builds its engine inside the boot, so the
        scheduler's policy is resolved first (the bundle's extra, then
        ``sched``) and handed over through ``LAMBDIPY_SCHED_POLICY``, as
        the JAX server does. A user's own handler's state is served
        through its module's ``invoke``."""
        bundle_dir = Path(bundle_dir)
        try:  # best effort: the boot reads the manifest for real
            pre_extra = (json.loads((bundle_dir / "manifest.json")
                                    .read_text()).get("payload")
                         or {}).get("extra") or {}
        except (OSError, ValueError):
            pre_extra = {}
        policy = SchedConfig.from_extra(pre_extra, **(sched or {})).policy
        prev = os.environ.get("LAMBDIPY_SCHED_POLICY")
        os.environ["LAMBDIPY_SCHED_POLICY"] = policy
        try:
            boot = load_bundle(bundle_dir, warmup=warmup, device=device)
        finally:
            if prev is None:
                os.environ.pop("LAMBDIPY_SCHED_POLICY", None)
            else:
                os.environ["LAMBDIPY_SCHED_POLICY"] = prev
        state = boot.state
        if not isinstance(state, HandlerState):
            state = HandlerState(
                invoke_fn=functools.partial(boot.handler.invoke, boot.state),
                meta=dict(getattr(boot.state, "meta", None) or {}),
                extra=dict((boot.manifest.get("payload") or {})
                           .get("extra") or {}))
        return cls(state, host=host, port=port, sched=sched, boot=boot)

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    @property
    def url(self) -> str:
        host, port = self.httpd.server_address[:2]
        return f"http://{host}:{port}"

    def health(self) -> dict:
        """The ``/healthz`` document; never raises."""
        engine = self.engine_fault_state()
        wedged = bool(engine.get("wedged"))
        warming = self.warming()
        boot = self.boot
        return {
            "ok": True,
            "ready": not self.draining and not warming and not wedged,
            "warming": warming,
            "wedged": wedged,
            **({"engine": engine} if engine else {}),
            "pid": os.getpid(),
            "draining": self.draining,
            "bundle": str(boot.bundle_dir) if boot is not None else None,
            "uptime_s": round(time.time() - self.started, 1),
            "cold_start": boot.stages if boot is not None else {},
            "skew": boot.skew if boot is not None else {},
            "handler_meta": getattr(self.state, "meta", {}),
            # the build-time warm's outcome, from the manifest
            "warm": boot.manifest.get("warm") if boot is not None else None,
            "debug_flags": boot.debug_flags if boot is not None else {},
            "sched": {"policy": self.sched.policy.name,
                      "queued": self.sched.queue.depth()}}

    def profile(self, request: dict) -> tuple[int, dict]:
        """``POST /profile``: (HTTP code, body). Serialised: one trace at a
        time."""
        from lambdipy_tpu_torch.utils.trace import (latest_trace_files,
                                                    profile_trace)

        try:
            n = max(1, min(int(request.get("invokes", 3)), 100))
        except (TypeError, ValueError):
            return 400, {"ok": False, "error": "invokes must be an integer"}
        if self.boot is None:
            return 404, {"ok": False, "error": "no bundle directory to "
                                               "write a profile into"}
        out_dir = self.boot.bundle_dir / "profiles" / str(int(time.time()))
        with self._profile_lock:
            with profile_trace(out_dir) as capture:
                for _ in range(n):
                    self.state.invoke({"warmup": True})
        payload = {"ok": capture.started, "dir": str(out_dir),
                   "files": latest_trace_files(out_dir)}
        if capture.error:
            payload["error"] = capture.error
        return (200 if capture.started else 503), payload

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

            def _cls(self) -> str:
                return (self.headers.get("x-priority")
                        or "interactive").strip().lower()

            def _send_shed(self, shed: Shed, *, openai: bool = False,
                           counter: str | None = None) -> None:
                """429/503 + Retry-After (whole seconds; the body carries
                the exact float), in the OpenAI error shape on that
                route."""
                server.stats.record_shed(counter or shed.reason)
                headers = {"Retry-After":
                           str(max(1, math.ceil(shed.retry_after_s)))}
                if openai:
                    payload = {"error": {
                        "message": f"shed: {shed.reason}",
                        "type": ("rate_limit_error" if shed.code == 429
                                 else "overloaded_error"),
                        "retry_after_s": round(shed.retry_after_s, 3)}}
                else:
                    payload = shed.payload()
                self._send(shed.code, payload, headers)

            def _shed_failure(self, e: BaseException, *,
                              openai: bool = False) -> bool:
                """A handler exception that is backpressure, not a fault:
                a full page arena (``kv_pages``), a new session past the
                pin budget (``session_pins``, priced by the lease
                horizon) or a row cancelled at a barrier; counted through
                the admission controller and answered as a shed. False
                for any other exception."""
                if isinstance(e, PagesExhausted):
                    shed, counter = Shed(503, "kv_pages",
                                         e.retry_after_s), "kv_pages"
                elif isinstance(e, SessionPinsExceeded):
                    shed, counter = Shed(503, "session_pins",
                                         e.retry_after_s), "session_pins"
                elif isinstance(e, RequestCancelled):
                    shed, counter = Shed(503, str(e), 1.0), "cancelled"
                else:
                    return False
                server.sched.admission.count_shed(counter, self._cls())
                self._send_shed(shed, openai=openai, counter=counter)
                return True

            def _begin_invoke(self, request: dict | None, *,
                              openai: bool = False):
                """The admission gate every invoke passes: the draining
                check and the in-flight count as one step (``stop`` then
                never sees 0 while an admitted invoke is on its way),
                scheduler admission (rate, queue depth, deadline), then
                the policy-ordered wait for a run slot; the request
                context is set for the engine. Returns the ticket, or
                None after sending the shed."""
                cls = self._cls()
                tenant = (self.headers.get("x-api-key")
                          or self.headers.get("x-tenant") or "anon")
                try:
                    deadline_ms = float(self.headers["x-deadline-ms"])
                except (KeyError, TypeError, ValueError):
                    deadline_ms = None
                with server._inflight_lock:
                    draining = server.draining
                    if not draining:
                        server._inflight += 1
                if draining:
                    server.sched.admission.count_shed("draining", cls)
                    self._send_shed(Shed(503, "draining", 1.0),
                                    openai=openai)
                    return None
                engine = server.engine_fault_state()
                if engine.get("wedged") and engine.get("restarting"):
                    # a wedged engine restarting behind a dead wait: shed
                    # instead of queueing into it
                    server._leave()
                    server.sched.admission.count_shed("wedged", cls)
                    self._send_shed(Shed(503, "wedged", 2.0), openai=openai)
                    return None
                prefill, decode = _request_token_counts(
                    request, getattr(server.state, "prefix_probe", None))
                out = server.sched.admit(
                    tenant=tenant, cls=cls, deadline_ms=deadline_ms,
                    prefill_tokens=prefill, decode_tokens=decode)
                if isinstance(out, Shed):
                    server._leave()
                    self._send_shed(out, openai=openai)
                    return None
                if not server.sched.wait_turn(out):
                    # the deadline became unmeetable while queued
                    server._leave()
                    self._send_shed(Shed(503, "deadline",
                                         max(0.05, out.cost_ms / 1e3)),
                                    openai=openai)
                    return None
                set_request_context(cls=out.cls, tenant=tenant,
                                    deadline_ms=deadline_ms)
                return out

            def _end_invoke(self, ticket, t0: float) -> None:
                clear_request_context()
                server.sched.finish(
                    ticket, service_ms=(time.monotonic() - t0) * 1e3)
                server._leave()

            def _read_json(self) -> dict | None:
                """The request body as a JSON object, or None after a 400
                (the body is read either way: keep-alive must not parse
                it as the next request)."""
                length = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(length)
                try:
                    body = json.loads(raw or b"{}")
                    if not isinstance(body, dict):
                        raise ValueError("body must be a JSON object")
                    return body
                except ValueError as e:
                    server.stats.record(0.0, False)
                    self._send(400, {"ok": False,
                                     "error": f"bad json: {e}"})
                    return None

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

            def _end_frames(self) -> None:
                try:
                    self.wfile.write(b"0\r\n\r\n")
                except OSError:
                    self.close_connection = True

            def _first_record(self, request: dict, *, openai: bool):
                """The stream's records and its first one, taken before
                the headers go out so that a refused admission is still a
                503 or a 400; (None, None) after answering."""
                records = None
                try:
                    records = server.state.invoke_stream(request)
                    return records, next(records)
                except Exception as e:  # noqa: BLE001 — answered below
                    if records is not None:
                        records.close()
                    if self._shed_failure(e, openai=openai):
                        return None, None
                    bad = isinstance(e, (ValueError, TypeError, KeyError))
                    if not bad:
                        traceback.print_exc()
                    server.stats.record(0.0, False)
                    kind = "invalid_request_error" if bad else type(e).__name__
                    self._send(400 if bad else 500, (
                        {"error": {"message": str(e), "type": kind}}
                        if openai else {"ok": False, "error": str(e)}))
                    return None, None

            def _send_stream(self, request: dict, t0: float) -> None:
                """Chunked ndjson, one line per decode segment; a later
                error becomes a final ``{"ok": false}`` line."""
                records, first = self._first_record(request, openai=False)
                if records is None:
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                ok = first.get("ok", False)
                try:
                    for rec in itertools.chain([first], records):
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
                self._end_frames()
                server.stats.record(time.monotonic() - t0, ok)

            def _send_sse(self, internal: dict, t0: float) -> None:
                """OpenAI server-sent events: one ``data:`` chunk per
                decode segment, then a last chunk carrying
                ``finish_reason`` and ``data: [DONE]``. An error after
                the headers is a terminal error event."""
                records, first = self._first_record(internal, openai=True)
                if records is None:
                    return
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def event(obj) -> bool:
                    body = b"data: " + (obj if isinstance(obj, bytes)
                                        else json.dumps(obj).encode()) \
                        + b"\n\n"
                    return self._write_frame(body)

                def chunk_event(tokens, text="", finish=None,
                                logprobs=None) -> bool:
                    choice = {"index": 0, "text": text, "tokens": tokens,
                              "finish_reason": finish}
                    if logprobs is not None:
                        choice["logprobs"] = {
                            "tokens": [str(t) for t in tokens],
                            "token_logprobs": logprobs,
                            "top_logprobs": None, "text_offset": None}
                    return event({"object": "text_completion.chunk",
                                  "model": "lambdipy-bundle",
                                  "choices": [choice]})

                emitted: list = []
                final: dict = {}
                try:
                    for payload in itertools.chain([first], records):
                        if not payload.get("ok"):
                            server.stats.record(time.monotonic() - t0,
                                                False)
                            event({"error": {"message": payload.get("error"),
                                             "type": "invoke_error"}})
                            self._end_frames()
                            return
                        if payload.get("done"):
                            final = payload
                            continue
                        emitted.extend(payload["tokens"][0])
                        # a text prompt's chunk carries its text delta
                        if not chunk_event(payload["tokens"][0],
                                           text=payload.get("text", ""),
                                           logprobs=(payload.get("logprobs")
                                                     or [None])[0]):
                            server.stats.record(time.monotonic() - t0,
                                                False)
                            return
                except Exception as e:  # noqa: BLE001 — headers are sent
                    traceback.print_exc()
                    server.stats.record(time.monotonic() - t0, False)
                    event({"error": {"message": str(e),
                                     "type": type(e).__name__}})
                    self._end_frames()
                    return
                finally:
                    records.close()
                eos = final.get("eos_id", internal.get("eos_id"))
                finish = ("stop" if eos is not None and eos in emitted
                          else "length")
                # the last event completes the text: the handler's tail
                chunk_event([], text=final.get("text", ""), finish=finish)
                server.stats.record(time.monotonic() - t0, True)
                if event(b"[DONE]"):
                    self._end_frames()

            def _invoke(self, request: dict, t0: float) -> None:
                """``/invoke`` past admission, answered as JAX's
                (``server.py:587-594``): the handler's result with 200
                whatever its ``ok`` (a refusal such as an empty prompt is
                the handler's answer, counted as served), a shed, or a 500
                with ``{"ok", "error", "kind"}`` for any other exception
                (counted as an error)."""
                if request.get("stream"):
                    self._send_stream(request, t0)
                    return
                try:
                    result = server.state.invoke(request)
                except Exception as e:  # noqa: BLE001 — report, keep serving
                    if self._shed_failure(e):
                        return
                    if not isinstance(e, (ValueError, TypeError, KeyError)):
                        traceback.print_exc()
                    server.stats.record(time.monotonic() - t0, False)
                    self._send(500, {"ok": False, "error": str(e),
                                     "kind": type(e).__name__})
                    return
                server.stats.record(time.monotonic() - t0, True)
                self._send(200, result)

            def _completions(self, internal: dict, ticket,
                             t0: float) -> None:
                """``/v1/completions`` past admission."""
                if internal.pop("stream", False):
                    self._send_sse(internal, t0)
                    return
                try:
                    result = server.state.invoke(internal)
                except Exception as e:  # noqa: BLE001 — report, keep serving
                    if self._shed_failure(e, openai=True):
                        return
                    bad = isinstance(e, (ValueError, TypeError, KeyError))
                    if not bad:
                        traceback.print_exc()
                    server.stats.record(time.monotonic() - t0, False)
                    self._send(400 if bad else 500, {"error": {
                        "message": str(e),
                        "type": ("invalid_request_error" if bad
                                 else type(e).__name__)}})
                    return
                if not result.get("ok"):
                    server.stats.record(time.monotonic() - t0, False)
                    self._send(400, {"error": {
                        "message": result.get("error", "invoke failed"),
                        "type": "invalid_request_error"}})
                    return
                server.stats.record(time.monotonic() - t0, True)
                out = _internal_to_openai(internal, result)
                if ticket.wait_ms is not None:
                    out["queue_wait_ms"] = round(ticket.wait_ms, 3)
                self._send(200, out)

            def _session_header(self, request: dict) -> None:
                """``x-session-id`` and ``x-session-ttl-s`` are the
                header spelling of the body's session fields; the body
                wins when both are present."""
                sid = self.headers.get("x-session-id")
                if sid and not request.get("session_id"):
                    request["session_id"] = sid
                ttl = self.headers.get("x-session-ttl-s")
                if ttl and request.get("session_ttl_s") is None:
                    request["session_ttl_s"] = ttl

            def _kv_export(self, request: dict) -> None:
                """``/v1/kv/export``: the request's whole-block prompt
                head as one binary frame, or with ``"stream": true`` a
                chunked stream of frames flushed as the store's walk
                produces each block group. Missing blocks prefill here,
                so the export passes the invoke's admission gate. A
                failure after a stream's headers truncates it (no
                terminal chunk), which the receiver detects."""
                stream = bool(request.get("stream"))
                fn = getattr(server.state, "kv_export_stream_fn"
                             if stream else "kv_export_fn", None)
                if fn is None:
                    self._send(404, {"ok": False, "error":
                                     "no KV export surface (prefix cache "
                                     "off or unsupported handler)"})
                    return
                ticket = self._begin_invoke(request)
                if ticket is None:
                    return
                t0 = time.monotonic()
                committed, out = False, None
                try:
                    out = fn(request)
                    if isinstance(out, dict):  # the handler refused
                        server.stats.record(0.0, False)
                        self._send(400, out)
                        return
                    self.send_response(200)
                    if stream:
                        self.send_header("Content-Type",
                                         "application/x-lkv-stream")
                        self.send_header("Transfer-Encoding", "chunked")
                        self.end_headers()
                        committed = True
                        for frame in out:
                            if not self._write_frame(frame):
                                return  # client gone; generator closed
                        self._end_frames()
                    else:
                        self.send_header("Content-Type",
                                         "application/octet-stream")
                        self.send_header("Content-Length", str(len(out)))
                        self.end_headers()
                        committed = True
                        try:
                            self.wfile.write(out)
                        except OSError:
                            self.close_connection = True
                    server.stats.record(time.monotonic() - t0, True)
                except Exception as e:  # noqa: BLE001 — answered below
                    if committed:
                        traceback.print_exc()
                        server.stats.record(time.monotonic() - t0, False)
                        self.close_connection = True
                    elif not self._shed_failure(e):
                        traceback.print_exc()
                        server.stats.record(0.0, False)
                        self._send(500, {"ok": False, "error": str(e),
                                         "kind": type(e).__name__})
                finally:
                    if stream and out is not None \
                            and not isinstance(out, dict):
                        out.close()
                    self._end_invoke(ticket, t0)

            def _read_chunked_body(self):
                """The chunks of a chunked-transfer request body (the
                standard library does not de-chunk requests). Bad framing
                raises ValueError, a connection dying mid-chunk
                ConnectionError: both roll a streamed import back."""
                while True:
                    line = self.rfile.readline(66)
                    if not line:
                        raise ConnectionError(
                            "connection closed mid-chunk-stream")
                    try:
                        size = int(line.strip().split(b";")[0], 16)
                    except ValueError:
                        raise ValueError(f"bad chunk size line {line!r}") \
                            from None
                    if size > _MAX_CHUNK_BODY + 4096:
                        # bound the allocation a hostile length asks for
                        # before the wire validator sees a byte
                        raise ValueError(f"chunk size {size} exceeds the "
                                         f"KV stream bound")
                    if size == 0:
                        self.rfile.readline()  # trailing CRLF
                        return
                    data = self.rfile.read(size)
                    if len(data) < size:
                        raise ConnectionError("connection closed "
                                              "mid-chunk")
                    self.rfile.read(2)  # the chunk's CRLF
                    yield data

            def _kv_import(self) -> None:
                """``/v1/kv/import``: a frame (``Content-Length`` body) or
                a chunked stream becomes a radix insert. A garbage frame
                is a 400 and touches nothing; a full page arena the
                priced 503 ``kv_import``. A stream's staging holds no run
                slot: admission brackets only its commit."""
                chunked = "chunked" in (self.headers.get(
                    "Transfer-Encoding") or "").lower()
                fn = getattr(server.state, "kv_import_stream_fn"
                             if chunked else "kv_import_fn", None)
                data = b""
                if not chunked:
                    # the body is read before any reply: on keep-alive the
                    # unread frame would parse as the next request
                    length = int(self.headers.get("Content-Length") or 0)
                    data = self.rfile.read(length) if length > 0 else b""
                if fn is None:
                    self.close_connection = chunked  # an unread body
                    self._send(404, {"ok": False, "error":
                                     "no KV import surface (prefix cache "
                                     "off or unsupported handler)"})
                    return
                t0 = time.monotonic()
                handler = self

                class _Shed(Exception):
                    pass

                class _Gate:
                    """Admission around a streamed import's commit."""

                    def __enter__(gate):
                        gate.ticket = handler._begin_invoke(None)
                        if gate.ticket is None:
                            raise _Shed()  # the 503 is already sent
                        gate.t0 = time.monotonic()
                        return gate

                    def __exit__(gate, *exc):
                        handler._end_invoke(gate.ticket, gate.t0)
                        return False

                ticket = None
                try:
                    if chunked:
                        out = fn(self._read_chunked_body(),
                                 commit_gate=_Gate())
                    else:
                        ticket = self._begin_invoke(None)
                        if ticket is None:
                            return
                        out = fn(data)
                except _Shed:
                    self.close_connection = True
                    return
                except PagesExhausted as e:
                    self.close_connection = chunked
                    server.sched.admission.count_shed("kv_import",
                                                      self._cls())
                    self._send_shed(Shed(503, "kv_import",
                                         e.retry_after_s))
                    return
                except ValueError as e:
                    self.close_connection = chunked
                    server.stats.record(0.0, False)
                    self._send(400, {"ok": False, "error":
                                     f"bad KV {'stream' if chunked else 'frame'}"
                                     f": {e}"})
                    return
                except ConnectionError:
                    # the sender died mid-stream: the staging is rolled
                    # back and nobody is left to answer
                    self.close_connection = True
                    return
                except Exception as e:  # noqa: BLE001 — reported
                    traceback.print_exc()
                    self.close_connection = chunked
                    server.stats.record(0.0, False)
                    self._send(500, {"ok": False, "error": str(e),
                                     "kind": type(e).__name__})
                    return
                finally:
                    if ticket is not None:
                        self._end_invoke(ticket, t0)
                server.stats.record(time.monotonic() - t0, True)
                self._send(200, out)

            def _kv_probe(self, request: dict) -> None:
                """``/v1/kv/probe``: the head tokens the tree holds. No
                admission gate: a host-only walk of the tree."""
                fn = getattr(server.state, "kv_probe_fn", None)
                if fn is None:
                    self._send(404, {"ok": False, "error":
                                     "no KV probe surface (prefix cache "
                                     "off or unsupported handler)"})
                    return
                try:
                    out = fn(request)
                except Exception as e:  # noqa: BLE001 — reported
                    self._send(500, {"ok": False, "error": str(e)})
                    return
                self._send(200 if out.get("ok") else 400, out)

            def do_DELETE(self):
                """``DELETE /v1/sessions/{id}``: release the session's pins
                now instead of at its lease's end."""
                if not self.path.startswith("/v1/sessions/"):
                    self._send(404, {"ok": False, "error": "not found"})
                    return
                sid = self.path[len("/v1/sessions/"):]
                fn = getattr(server.state, "session_end_fn", None)
                if fn is None or not sid:
                    self._send(404, {"ok": False, "error":
                                     "no session surface (prefix cache "
                                     "off or unsupported handler)"})
                    return
                try:
                    out = fn(sid)
                except Exception as e:  # noqa: BLE001 — reported
                    server.stats.record(0.0, False)
                    self._send(500, {"ok": False, "error": str(e)})
                    return
                self._send(200, {"ok": True, "session": sid, **out})

            def _require_loopback(self) -> bool:
                """Host-only endpoints refuse other clients with a 403
                before reading the body, and close the connection."""
                if self.client_address[0] in ("127.0.0.1", "::1"):
                    return True
                self.close_connection = True
                self._send(403, {"ok": False, "error": "host-only endpoint "
                                 "(loopback clients only)"})
                return False

            def _debug(self, name: str, request=None) -> None:
                """``/v1/debug/*``: the handler's ``name`` surface."""
                fn = getattr(server.state, name, None)
                if fn is None:
                    self._send(404, {"ok": False, "error": "not supported "
                                     "by this handler"})
                    return
                try:
                    out = fn() if request is None else fn(request)
                except Exception as e:  # noqa: BLE001 — reported
                    self._send(500, {"ok": False, "error": str(e)})
                    return
                self._send(200 if request is None or out.get("ok") else 400,
                           out)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, server.health())
                elif self.path == "/v1/debug/invariants":
                    if self._require_loopback():
                        self._debug("debug_invariants_fn")
                elif self.path == "/metrics":
                    self._send(200, {"server": server.stats.report(),
                                     "sched": server.sched.report(),
                                     "handler": server.state.stats()})
                else:
                    self._send(404, {"ok": False, "error": "not found"})

            def do_POST(self):
                if self.path == "/shutdown":
                    # admission closes before the answer: an invoke sent
                    # after the 200 can never be admitted ahead of the
                    # thread that runs stop()
                    with server._inflight_lock:
                        server.draining = True
                    self._send(200, {"ok": True, "draining": True})
                    threading.Thread(target=server.stop,
                                     daemon=True).start()
                    return
                if self.path == "/profile":
                    request = self._read_json()
                    if request is not None:
                        try:
                            self._send(*server.profile(request))
                        except Exception as e:  # noqa: BLE001 — reported
                            traceback.print_exc()
                            self._send(500, {"ok": False, "error": str(e)})
                    return
                if self.path in ("/v1/debug/faults", "/v1/debug/knobs"):
                    if self._require_loopback():
                        request = self._read_json()
                        if request is not None:
                            self._debug("faults_admin_fn"
                                        if self.path.endswith("faults")
                                        else "knobs_admin_fn", request)
                    return
                if self.path == "/v1/kv/import":
                    self._kv_import()
                    return
                if self.path not in ("/invoke", "/v1/completions",
                                     "/v1/kv/export", "/v1/kv/probe"):
                    self._send(404, {"ok": False, "error": "not found"})
                    return
                request = self._read_json()
                if request is None:
                    return
                if self.path == "/v1/kv/export":
                    self._kv_export(request)
                    return
                if self.path == "/v1/kv/probe":
                    self._kv_probe(request)
                    return
                openai = self.path == "/v1/completions"
                if openai:
                    request, err = _openai_to_internal(request)
                    if err is not None:
                        server.stats.record(0.0, False)
                        self._send(400, {"error": {
                            "message": err,
                            "type": "invalid_request_error"}})
                        return
                self._session_header(request)
                ticket = self._begin_invoke(request, openai=openai)
                if ticket is None:
                    return
                t0 = time.monotonic()
                # in flight until the response is written: a drain must
                # not close the socket under it
                try:
                    if openai:
                        self._completions(request, ticket, t0)
                    else:
                        self._invoke(request, t0)
                finally:
                    self._end_invoke(ticket, t0)

        return Handler

    def _leave(self) -> None:
        with self._inflight_lock:
            self._inflight -= 1

    def warming(self) -> bool:
        """The handler's O(1) warm flag (False without one); never
        raises."""
        fn = getattr(self.state, "warming_fn", None)
        try:
            return bool(fn()) if fn is not None else False
        except Exception:  # noqa: BLE001 — health must never fail
            return False

    def engine_fault_state(self) -> dict:
        """The engine's O(1) fault state (empty without one); never
        raises, so health never answers 500."""
        fn = getattr(self.state, "engine_fault_fn", None)
        if fn is None:
            return {}
        try:
            return dict(fn())
        except Exception:  # noqa: BLE001 — health must never fail
            return {}

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def start_background(self) -> "BundleServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="bundle-server", daemon=True)
        self._thread.start()
        return self

    def stop(self, *, drain_grace: float = 10.0) -> None:
        """Drain, then stop: admission closes first (new invokes are shed
        503 ``draining`` by the server's gate and the scheduler), then the
        invokes in flight and those already queued finish, for at most
        ``drain_grace`` seconds, then the socket closes and the handler
        lets go of what it holds beyond this process
        (``HandlerState.close``: a tensor-parallel server's followers)."""
        with self._inflight_lock:
            self.draining = True
            if self._stopped:
                return
            self._stopped = True
        self.sched.drain()
        deadline = time.monotonic() + drain_grace
        while self._inflight > 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None \
                and self._thread is not threading.current_thread():
            self._thread.join(timeout=10)
        # a tensor-parallel handler's follower ranks stop with the server
        close = getattr(self.state, "close", None)
        if close is not None:
            close()


def serve_until_term(server: BundleServer, ready: dict) -> None:
    """Print the readiness line ``ready`` on stdout and serve until
    stopped: SIGTERM drains (``stop``) off the serving thread, which
    ``shutdown`` would deadlock."""
    stoppers = []

    def _term(signum, frame):
        stopper = threading.Thread(target=server.stop, daemon=True)
        stoppers.append(stopper)
        stopper.start()

    signal.signal(signal.SIGTERM, _term)
    print(json.dumps(ready), flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.stop()
    for stopper in stoppers:
        stopper.join(timeout=30)


def main(argv=None) -> int:
    """``python -m lambdipy_tpu_torch.runtime.server <bundle_dir> [port]``:
    boot the bundle on the card (``LAMBDIPY_PLATFORM=cpu``: on the CPU),
    print ``{"ready": true, "pid", "port", "cold_start"}`` and serve until
    SIGTERM, which drains."""
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: server <bundle_dir> [port]", file=sys.stderr)
        return 2
    device = "cpu" if os.environ.get("LAMBDIPY_PLATFORM") == "cpu" else None
    server = BundleServer.from_bundle(
        Path(argv[0]), port=int(argv[1]) if len(argv) > 1 else 0,
        device=device)
    serve_until_term(server, {"ready": True, "pid": os.getpid(),
                              "port": server.port,
                              "cold_start": server.boot.stages})
    return 0


if __name__ == "__main__":
    sys.exit(main())
