"""The port handler's background warm and its ``/v1/debug/knobs`` control
against the JAX handler's (``lambdipy_tpu/runtime/handlers.py:996-1172``),
on the CPU with ``llama-tiny`` (f32, the JAX weights carried over):

- the warm starts after the first invoke and never at init, runs the
  listed buckets and the engine's group prefill, and its ``/metrics``
  block (``handler.warm_buckets``) and warming flag equal the JAX
  handler's for the same extras; ``warm_group_prefill = "0"`` with no
  bucket builds none;
- ``/healthz`` reads ``warming: true`` and ``ready: false`` while the warm
  runs, and ready again after;
- rows served after the warm are bitwise the rows of a handler that did
  not warm;
- every answer of the knob control (clamps, buckets, refusals) against
  JAX's ``knobs_admin`` on the same sequence of requests, over a paged
  engine with speculation and a dense one without; ``prefill_mode=sp``
  is refused (it waits for parallelism); the route is host-only over
  HTTP, and ``max_logical_ctx`` set live routes a row past the window to
  the long-context tier."""

import json
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from lambdipy_tpu.models import registry as jreg
from lambdipy_tpu.runtime.handlers import \
    generate_handler as jax_generate_handler
from lambdipy_tpu_torch.models.params import from_jax_params
from lambdipy_tpu_torch.runtime.handlers import (HandlerContext,
                                                 generate_handler)
from lambdipy_tpu_torch.runtime.server import BundleServer

EXTRA = {"attn_backend": "blocked"}
ENGINE = {"batch_mode": "continuous", "batch_max": "3", "batch_segment": "4",
          "kv_paged": "1", "prefix_block": "16", "prefix_cache_mb": "0"}


@pytest.fixture(scope="module")
def weights():
    adapter = jreg.get("llama-tiny").build(extra=EXTRA)
    return from_jax_params(jax.tree_util.tree_map(
        np.asarray, adapter.init_params(seed=0)))


def _handler(weights, extra):
    return generate_handler(
        {"model": "llama-tiny", "dtype": "float32",
         "extra": {**EXTRA, **extra}},
        HandlerContext(device="cpu", state_dict=weights))


def _jax_handler(extra):
    ctx = SimpleNamespace(params_dir=None, bundle_dir=None, manifest=None)
    return jax_generate_handler(
        {"model": "llama-tiny", "dtype": "float32",
         "extra": {**EXTRA, "serve_aot": "0", **extra}}, ctx)


def _until(pred, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.01)


def _warm_threads() -> int:
    return sum(t.name == "bucket-warm" and t.is_alive()
               for t in threading.enumerate())


def test_warm_runs_after_the_first_invoke_as_jax(weights):
    """The same extras (3 slots, ``warm_buckets = "32"``, the group warm
    on by default) through both handlers: nothing warms at init; the
    first invoke starts the ``bucket-warm`` thread; when it is done both
    ``warm_buckets`` blocks read the same (the bucket, then three group
    programs: joiner counts 2 and 3, the latter bucketed to 4, and the
    64-token family at 3 rows), the warming flags agree at each stage, and
    the engine counted the three warm prefills as forwards."""
    extra = {**ENGINE, "warm_buckets": "32", "max_new_tokens": "4"}
    state, jstate = _handler(weights, extra), _jax_handler(extra)
    before = state.stats()["warm_buckets"]
    assert before == jstate.stats()["warm_buckets"] == {
        "requested": [32], "done": [], "errors": [], "in_flight": False}
    assert state.warming_fn() is jstate.warming_fn() is False
    body = {"tokens": [5, 6, 7], "max_new_tokens": 4}
    out, jout = state.invoke(body), jstate.invoke(body)
    assert out["tokens"] == jout["tokens"]
    for st in (state, jstate):
        _until(lambda st=st: not st.warming_fn())
    warm = state.stats()["warm_buckets"]
    assert warm == jstate.stats()["warm_buckets"] == {
        "requested": [32], "done": [32, "group_prefill:3"], "errors": [],
        "in_flight": False}
    es = state.engine.stats()
    # the request's own prefill was a group of one
    assert es["warm_prefills"] == 3 and es["prefill_groups"] == 1
    assert es["forwards"] == es["steps"] + es["warm_prefills"] \
        + es["row_prefills"] + es["prefill_groups"] + es["prefill_chunks"]
    # a second invoke starts no second warm
    state.invoke(body)
    assert _warm_threads() == 0
    assert state.stats()["warm_buckets"]["done"] == warm["done"]


def test_warm_off_builds_no_warm_as_jax(weights):
    """``warm_group_prefill = "0"`` and no bucket listed: neither handler
    reports a warm, and no thread starts."""
    extra = {**ENGINE, "warm_group_prefill": "0"}
    state, jstate = _handler(weights, extra), _jax_handler(extra)
    state.invoke({"tokens": [5, 6, 7], "max_new_tokens": 2})
    assert "warm_buckets" not in state.stats()
    assert "warm_buckets" not in jstate.stats()
    assert not state.warming_fn() and _warm_threads() == 0


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as resp:
        return json.loads(resp.read())


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_healthz_reads_warming_while_the_warm_runs(weights):
    """While the warm runs (held here on an event) ``/healthz`` reads
    ``warming: true`` and ``ready: false``; after it, ready again, and
    ``/metrics`` carries the finished block."""
    state = _handler(weights, ENGINE)
    hold, entered = threading.Event(), threading.Event()
    warm = state.engine.warm_group_prefill

    def held():
        entered.set()
        hold.wait(timeout=30)
        return warm()

    state.engine.warm_group_prefill = held
    srv = BundleServer(state, port=0).start_background()
    try:
        health = _get(srv.url + "/healthz")
        assert health["ready"] and health["warming"] is False
        code, _ = _post(srv.url + "/invoke",
                        {"tokens": [1, 2, 3], "max_new_tokens": 2})
        assert code == 200
        assert entered.wait(timeout=30)
        health = _get(srv.url + "/healthz")
        assert health["warming"] is True and health["ready"] is False
        assert _get(srv.url + "/metrics")["handler"]["warm_buckets"][
            "in_flight"] is True
        hold.set()
        _until(lambda: _get(srv.url + "/healthz")["ready"])
        block = _get(srv.url + "/metrics")["handler"]["warm_buckets"]
        assert block == {"requested": [], "done": ["group_prefill:3"],
                         "errors": [], "in_flight": False}
    finally:
        hold.set()
        srv.stop()


def test_rows_after_the_warm_are_bitwise_unwarmed(weights):
    """Three concurrent rows through a handler that warmed and one that
    did not: tokens and logprobs bitwise."""
    warmed = _handler(weights, ENGINE)
    cold = _handler(weights, {**ENGINE, "warm_group_prefill": "0"})
    warmed.invoke({"tokens": [9, 9, 9], "max_new_tokens": 2})
    _until(lambda: not warmed.warming_fn())
    bodies = [{"tokens": [3 * i + j + 1 for j in range(5 + 7 * i)],
               "max_new_tokens": 6, "logprobs": True,
               **({"temperature": 0.8, "seed": i} if i == 1 else {})}
              for i in range(3)]
    outs = {}
    for name, st in (("warmed", warmed), ("cold", cold)):
        res = [None] * 3
        threads = [threading.Thread(
            target=lambda i=i, st=st: res.__setitem__(i, st.invoke(
                bodies[i]))) for i in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        outs[name] = res
    for a, b in zip(outs["warmed"], outs["cold"]):
        assert a["tokens"] == b["tokens"] and a["logprobs"] == b["logprobs"]


# -- /v1/debug/knobs ----------------------------------------------------------

KNOB_REQUESTS = (
    {}, {"bogus": 1}, {"pipeline_depth": 0}, {"pipeline_depth": 9},
    {"pipeline_depth": "x"}, {"pipeline_depth": 3}, {"spec_k": "x"},
    {"spec_k": 3}, {"spec_k": 100}, {"spec_k": 1}, {"draft_mode": "banana"},
    {"draft_mode": "auto"}, {"draft_mode": "aux"}, {"draft_mode": "lookup"},
    {"draft_mode": "off"}, {"spec_k": 0}, {"max_logical_ctx": "x"},
    {"max_logical_ctx": 2048}, {"max_logical_ctx": -5},
    {"prefill_mode": "banana"}, {"prefill_mode": "chunked"},
    {"pipeline_depth": 1, "spec_k": 8, "draft_mode": "model"},
    {"max_logical_ctx": 0})
KNOBS = ("pipeline_depth", "spec_k", "draft_mode", "max_logical_ctx",
         "prefill_mode")


@pytest.mark.parametrize("extra", [
    {**ENGINE, "spec_k": "4", "max_logical_ctx": "512"},
    {"batch_mode": "continuous", "prefix_cache_mb": "0"},
    {"prefix_cache_mb": "0"},
], ids=["paged-spec", "dense", "no-engine"])
def test_knobs_answer_as_jax_knobs_admin(weights, extra):
    """One sequence of requests through both handlers' knob controls: the
    same ``ok`` for each, the same applied values, and the engines left
    with the same knobs."""
    extra = {**extra, "warm_group_prefill": "0"}
    state, jstate = _handler(weights, extra), _jax_handler(extra)
    for req in KNOB_REQUESTS:
        got, want = state.knobs_admin_fn(dict(req)), \
            jstate.knobs_admin_fn(dict(req))
        assert got["ok"] == want["ok"], (req, got, want)
        if want["ok"]:
            assert {k: got[k] for k in KNOBS} == {k: want[k] for k in KNOBS}
        else:
            assert got["error"] and want["error"]
    if state.engine is not None:
        # the JAX handler keeps its engine in the knob control's closure
        eng = state.engine
        jeng = next(c.cell_contents for c in jstate.knobs_admin_fn.__closure__
                    if type(c.cell_contents).__name__ == "ContinuousBatcher")
        assert eng.pipe_stats.depth == eng.pipeline_depth
        assert (eng.pipeline_depth, eng.spec_k, eng.draft_mode,
                eng.max_logical_ctx) == (jeng.pipeline_depth, jeng.spec_k,
                                         jeng.draft_mode,
                                         jeng.max_logical_ctx)


def test_knobs_refuse_sp_prefill_and_route_over_http(weights):
    """``prefill_mode=sp`` is refused (JAX stands it down without an sp
    mesh; the port has no sp prefill); the route answers loopback clients
    200 or 400; ``max_logical_ctx`` set live makes the engine serve a row
    past its window, as a runner built at boot serves it."""
    state = _handler(weights, {**ENGINE, "kv_pages": "40",
                               "warm_group_prefill": "0"})
    assert not state.knobs_admin_fn({"prefill_mode": "sp"})["ok"]
    assert state.engine.max_logical_ctx == 0
    row = [(5 * j) % 97 + 3 for j in range(300)]
    with pytest.raises(ValueError):
        state.invoke({"tokens": row, "max_new_tokens": 8})
    srv = BundleServer(state, port=0).start_background()
    try:
        code, out = _post(srv.url + "/v1/debug/knobs",
                          {"max_logical_ctx": 1024})
        assert code == 200 and out["ok"] and out["max_logical_ctx"] == 1024
        code, out = _post(srv.url + "/v1/debug/knobs", {"spec_k": 4})
        assert code == 400 and not out["ok"]
        code, out = _post(srv.url + "/invoke",
                          {"tokens": row, "max_new_tokens": 8})
        assert code == 200
    finally:
        srv.stop()
    booted = _handler(weights, {**ENGINE, "kv_pages": "40",
                                "warm_group_prefill": "0",
                                "max_logical_ctx": "1024"})
    want = booted.invoke({"tokens": row, "max_new_tokens": 8})
    assert out["tokens"] == want["tokens"]
    assert state.stats()["batching"]["long_context"]["runs"] == 1
