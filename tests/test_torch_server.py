"""The port's HTTP front (``lambdipy_tpu_torch/runtime/server.py``) on f32
``llama-tiny`` on the CPU: ``/v1/completions`` against ``/invoke`` for
the same body (greedy and seeded), its SSE stream against the
non-streamed completion, the OpenAI request and response translation
against the JAX server's functions, a string prompt answered as the JAX
server answers it without a tokenizer, a deadline cancelled mid-decode
answered 503, and ``/shutdown`` letting the request in flight finish
while refusing the next, and closing admission before it answers.

Every comparison is exact: the same handler serves both routes, so the
tokens are equal, and the translation functions are plain Python."""

import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from lambdipy_tpu.runtime import server as jax_server_mod
from lambdipy_tpu_torch.runtime import server as server_mod
from lambdipy_tpu_torch.runtime.handlers import (HandlerContext,
                                                 HandlerState,
                                                 generate_handler)
from lambdipy_tpu_torch.runtime.server import BundleServer

PROMPT = [5, 17, 3, 99, 250, 8]


@pytest.fixture(scope="module")
def state():
    return generate_handler(
        {"model": "llama-tiny", "dtype": "float32",
         "extra": {"attn_backend": "blocked", "batch_mode": "continuous",
                   "kv_paged": "1", "batch_max": "4", "batch_segment": "4",
                   "prefix_block": "16", "warm_group_prefill": "0"}},
        HandlerContext(device="cpu"))


@pytest.fixture()
def serve():
    servers = []

    def make(state, **kw):
        srv = BundleServer(state, port=0, **kw).start_background()
        servers.append(srv)
        return srv

    yield make
    for srv in servers:
        srv.stop(drain_grace=2.0)


def _post(url, body, headers=None, raw=False):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            data, code, hdrs = resp.read(), resp.status, dict(resp.headers)
    except urllib.error.HTTPError as e:
        data, code, hdrs = e.read(), e.code, dict(e.headers)
    return code, (data if raw else json.loads(data)), hdrs


def _sse(raw: bytes) -> list:
    events = [line[len(b"data: "):] for line in raw.split(b"\n")
              if line.startswith(b"data: ")]
    return [e if e == b"[DONE]" else json.loads(e) for e in events]


@pytest.mark.parametrize("knobs", [{"temperature": 0.0},
                                   {"temperature": 0.8, "seed": 7}],
                         ids=["greedy", "seeded"])
def test_completions_equal_invoke_and_their_stream(state, serve, knobs):
    """A token-array prompt through ``/v1/completions`` gives the tokens
    ``/invoke`` gives for the same body, with usage and finish_reason;
    its SSE chunks, put together, are the same tokens, and the stream
    ends with a finish_reason chunk and ``data: [DONE]``."""
    srv = serve(state)
    code, inv, _ = _post(srv.url + "/invoke",
                         {"tokens": PROMPT, "max_new_tokens": 10, **knobs,
                          "logprobs": True})
    assert code == 200
    body = {"prompt": PROMPT, "max_tokens": 10, "logprobs": 1, **knobs}
    code, comp, _ = _post(srv.url + "/v1/completions", body)
    assert code == 200
    choice = comp["choices"][0]
    assert comp["object"] == "text_completion"
    assert choice["tokens"] == inv["tokens"][0]
    assert choice["finish_reason"] == "length"
    assert choice["logprobs"]["token_logprobs"] == inv["logprobs"][0]
    assert comp["usage"] == {"prompt_tokens": len(PROMPT),
                             "completion_tokens": 10,
                             "total_tokens": len(PROMPT) + 10}
    assert comp["queue_wait_ms"] >= 0
    code, raw, hdrs = _post(srv.url + "/v1/completions",
                            {**body, "stream": True}, raw=True)
    assert code == 200 and hdrs["Content-Type"] == "text/event-stream"
    events = _sse(raw)
    assert events[-1] == b"[DONE]"
    chunks = [e["choices"][0] for e in events[:-1]]
    assert chunks[-1]["tokens"] == [] and chunks[-1]["finish_reason"] \
        == "length"
    assert [t for c in chunks for t in c["tokens"]] == choice["tokens"]
    assert [x for c in chunks[:-1]
            for x in c["logprobs"]["token_logprobs"]] == \
        choice["logprobs"]["token_logprobs"]
    assert all(len(c["tokens"]) <= 4 for c in chunks)


def test_completion_with_eos_stops(state, serve):
    """An eos the row emits: the completion is trimmed after it with
    finish_reason ``stop``, in the body and in the stream."""
    srv = serve(state)
    free = state.invoke({"tokens": PROMPT, "max_new_tokens": 12})
    eos = free["tokens"][0][4]
    cut = free["tokens"][0].index(eos) + 1
    body = {"prompt": PROMPT, "max_tokens": 12, "temperature": 0,
            "eos_id": eos}
    _, comp, _ = _post(srv.url + "/v1/completions", body)
    choice = comp["choices"][0]
    assert choice["finish_reason"] == "stop"
    assert choice["tokens"] == free["tokens"][0][:cut]
    _, raw, _ = _post(srv.url + "/v1/completions", {**body, "stream": True},
                      raw=True)
    events = _sse(raw)
    assert events[-2]["choices"][0]["finish_reason"] == "stop"


@pytest.mark.parametrize("body", [
    {"prompt": [1, 2, 3], "max_tokens": 4, "temperature": 0},
    {"prompt": [1, 2, 3], "logprobs": True, "seed": 3, "top_k": 5},
    {"prompt": "hello", "stream": True},
    {"prompt": [1, 2], "stop": ["\n"]},
    {"prompt": [1, 2], "n": 2},
    {"prompt": [1, "a"]},
    {"prompt": [1, 2], "logprobs": 5},
    {"prompt": [1, 2], "temperature": "hot"},
])
def test_openai_translation_equals_the_jax_server(body):
    """The request translation, and the response translation of a
    result with and without an eos and logprobs, are the JAX server's."""
    assert server_mod._openai_to_internal(dict(body)) == \
        jax_server_mod._openai_to_internal(dict(body))
    internal, err = server_mod._openai_to_internal(dict(body))
    if err is None:
        for result in ({"ok": True, "tokens": [[4, 9, 2, 2]], "n_prompt": 3},
                       {"ok": True, "tokens": [[4, 9, 2, 2]], "eos_id": 9,
                        "logprobs": [[-0.5, -1.0, 0.0, 0.0]]}):
            assert server_mod._internal_to_openai(internal, result) == \
                jax_server_mod._internal_to_openai(internal, result)
    assert server_mod._request_token_counts(internal) == \
        jax_server_mod._request_token_counts(internal)


def test_string_prompt_without_tokenizer_gets_the_jax_answer(state, serve):
    """The port has no tokenizer: a string prompt is refused as the JAX
    server refuses it when its bundle has none (400, invalid request)."""
    srv = serve(state)
    code, out, _ = _post(srv.url + "/v1/completions", {"prompt": "hi"})
    assert code == 400
    assert out == {"error": {"message": "bundle has no tokenizer; send "
                                        "'tokens'",
                             "type": "invalid_request_error"}}
    code, raw, _ = _post(srv.url + "/v1/completions",
                         {"prompt": "hi", "stream": True}, raw=True)
    assert code == 200 and _sse(raw) == [{"error": {
        "message": "bundle has no tokenizer; send 'tokens'",
        "type": "invoke_error"}}]
    code, out, _ = _post(srv.url + "/v1/completions", {"prompt": 5})
    assert code == 400 and out["error"]["type"] == "invalid_request_error"


def test_prefix_probe_prices_the_suffix(state):
    """The scheduler prices the suffix a prefix-store hit will prefill."""
    row = list(range(1, 40))
    state.prefix_store.route(row)
    m = state.prefix_probe(row)
    assert m == 32
    assert server_mod._request_token_counts(
        {"tokens": row, "max_new_tokens": 5}, state.prefix_probe) == \
        jax_server_mod._request_token_counts(
            {"tokens": row, "max_new_tokens": 5},
            state.prefix_probe) == (len(row) - m, 5)


def test_deadline_expired_mid_decode_is_a_503(state, serve):
    """A deadline that admission lets through but that passes while the
    row decodes: the engine cancels the row at a barrier and the server
    answers 503 with Retry-After, counted as a ``cancelled`` shed, on
    both routes."""
    engine = state.engine
    dispatch = engine._run_segment

    def slow(live):
        time.sleep(0.03)
        return dispatch(live)

    engine._run_segment = slow
    try:
        srv = serve(state)
        body = {"tokens": [1, 2, 3], "max_new_tokens": 100}
        code, out, hdrs = _post(srv.url + "/invoke", body,
                                headers={"x-deadline-ms": "200"})
        assert code == 503 and int(hdrs["Retry-After"]) >= 1
        assert "deadline expired" in out["shed"]
        code, out, _ = _post(srv.url + "/v1/completions",
                             {"prompt": [1, 2, 3], "max_tokens": 100},
                             headers={"x-deadline-ms": "200"})
        assert code == 503 and out["error"]["type"] == "overloaded_error"
    finally:
        engine._run_segment = dispatch
    metrics = json.loads(urllib.request.urlopen(srv.url + "/metrics",
                                                timeout=30).read())
    assert metrics["sched"]["shed"]["by_reason"] == {"cancelled": 2}
    assert metrics["server"]["sheds"] == {"cancelled": 2}
    assert metrics["handler"]["batching"]["cancelled"] >= 2


def test_shutdown_drains_then_refuses(state, serve):
    """``POST /shutdown`` answers at once; the request in flight finishes
    with 200, a request sent while it drains is shed 503 ``draining``,
    and once drained the server no longer listens."""
    invoke = state.invoke_fn
    # the request in flight is held until the test has seen the 503, so
    # the drain cannot finish first on a loaded machine
    release = threading.Event()

    def slow(req):
        release.wait(timeout=30)
        return invoke(req)

    srv = serve(dataclasses.replace(state, invoke_fn=slow))
    body = {"tokens": [1, 2, 3], "max_new_tokens": 4}
    done = {}
    first = threading.Thread(target=lambda: done.setdefault(
        "r", _post(srv.url + "/invoke", body)))
    first.start()
    deadline = time.monotonic() + 10
    while srv._inflight == 0 and time.monotonic() < deadline:
        time.sleep(0.005)
    code, out, _ = _post(srv.url + "/shutdown", {})
    assert (code, out) == (200, {"ok": True, "draining": True})
    code, out, hdrs = _post(srv.url + "/invoke", body)
    release.set()
    assert code == 503 and out["shed"] == "draining"
    assert int(hdrs["Retry-After"]) >= 1
    first.join(timeout=30)
    code, out, _ = done["r"]
    assert code == 200 and out["ok"] and len(out["tokens"][0]) == 4
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        try:
            _post(srv.url + "/invoke", body)
        except OSError:  # refused, or reset by the closing socket
            break
        time.sleep(0.02)
    else:
        pytest.fail("the server still answers after its drain")
    # the requests sent while draining were shed, nothing else was
    assert set(srv.sched.report()["shed"]["by_reason"]) == {"draining"}


def test_shutdown_refuses_the_next_invoke_at_once(serve):
    """``POST /shutdown`` closes admission before it answers: an
    ``/invoke`` sent right after its 200 is shed 503 ``draining`` even
    while the thread that runs ``stop`` has not started yet (held back
    here until the 503 is seen), 20 times over, and the handler is never
    called."""
    calls = []
    state = HandlerState(
        invoke_fn=lambda req: calls.append(req) or {"ok": True}, meta={})
    for _ in range(20):
        srv = serve(state)
        answered = threading.Event()

        def late_stop(real=srv.stop, answered=answered, **kw):
            answered.wait(timeout=30)
            real(**kw)

        srv.stop = late_stop
        code, out, _ = _post(srv.url + "/shutdown", {})
        assert (code, out) == (200, {"ok": True, "draining": True})
        code, out, _ = _post(srv.url + "/invoke", {"tokens": [1, 2, 3]})
        answered.set()
        assert code == 503 and out["shed"] == "draining"
    assert calls == []
