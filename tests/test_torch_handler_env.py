"""The port handler's ``LAMBDIPY_*`` environment, its solo stream cadence
and the engine's ``segments_run`` / ``rows_in_segments`` against the JAX
handler's, on the CPU with ``llama-tiny`` (f32, the JAX weights carried
over):

- each variable the JAX handler (or registry) reads when its extra is
  unset resolves to what the JAX handler resolves, with its precedence
  (``LAMBDIPY_KV_PAGED``, ``LAMBDIPY_KV_PAGES``,
  ``LAMBDIPY_PREFIX_BLOCK``, ``LAMBDIPY_ATTN_BACKEND``,
  ``LAMBDIPY_MAX_LOGICAL_CTX``, ``LAMBDIPY_LONG_PREFILL``,
  ``LAMBDIPY_WINDOW_BUCKETING``), and the variables of features the port
  lacks (``LAMBDIPY_MESH``'s ``dp`` axis, ``LAMBDIPY_PREFILL_MODE``)
  raise where their value turns the feature on and the extra is unset;
- a row the engine sends solo streams at the request's ``segment``
  clamped to a power of two in [4, 64], the JAX handler's chunks;
- ``batching.segments_run`` and ``rows_in_segments`` count as JAX counts
  them on a sequential schedule."""

import json
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

EXTRA = {"attn_backend": "blocked"}
BASE = {"batch_mode": "continuous", "prefix_cache_mb": "0",
        "warm_group_prefill": "0"}
VARIABLES = ("LAMBDIPY_KV_PAGED", "LAMBDIPY_KV_PAGES",
             "LAMBDIPY_PREFIX_BLOCK", "LAMBDIPY_ATTN_BACKEND",
             "LAMBDIPY_MAX_LOGICAL_CTX", "LAMBDIPY_LONG_PREFILL",
             "LAMBDIPY_MESH", "LAMBDIPY_WINDOW_BUCKETING",
             "LAMBDIPY_PREFILL_MODE")


@pytest.fixture(scope="module")
def weights():
    adapter = jreg.get("llama-tiny").build(extra=EXTRA)
    return from_jax_params(jax.tree_util.tree_map(
        np.asarray, adapter.init_params(seed=0)))


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for var in VARIABLES:
        monkeypatch.delenv(var, raising=False)


def _handler(weights, extra, base=EXTRA):
    return generate_handler(
        {"model": "llama-tiny", "dtype": "float32",
         "extra": {**base, **extra}},
        HandlerContext(device="cpu", state_dict=weights))


def _jax_handler(extra, base=EXTRA):
    ctx = SimpleNamespace(params_dir=None, bundle_dir=None, manifest=None)
    return jax_generate_handler(
        {"model": "llama-tiny", "dtype": "float32",
         "extra": {**base, "serve_aot": "0", **extra}}, ctx)


def _engines(weights, extra):
    """The port handler's engine and the JAX handler's (the JAX handler
    keeps it in its closure; its knob control reads it)."""
    state, jstate = _handler(weights, extra), _jax_handler(extra)
    jeng = next(c.cell_contents for c in jstate.knobs_admin_fn.__closure__
                if type(c.cell_contents).__name__ == "ContinuousBatcher")
    return state, state.engine, jeng


@pytest.mark.parametrize("env,extra,paged", [
    ("1", {}, True), ("0", {}, False), ("1", {"kv_paged": "0"}, False),
], ids=["on", "off", "extra-first"])
def test_kv_paged_variable(weights, monkeypatch, env, extra, paged):
    monkeypatch.setenv("LAMBDIPY_KV_PAGED", env)
    _, eng, jeng = _engines(weights, {**BASE, **extra})
    assert (eng.pool is not None) == (jeng.pool is not None) == paged


@pytest.mark.parametrize("env,extra,pages", [
    ("9", {}, 9), ("9", {"kv_pages": "12"}, 12),
], ids=["env", "extra-first"])
def test_kv_pages_variable(weights, monkeypatch, env, extra, pages):
    monkeypatch.setenv("LAMBDIPY_KV_PAGES", env)
    _, eng, jeng = _engines(weights, {**BASE, "kv_paged": "1", **extra})
    assert eng.pool.n_pages == jeng.pool.n_pages == pages


@pytest.mark.parametrize("extra", [{}, {"prefix_block": "32"}],
                         ids=["env", "env-first"])
def test_prefix_block_variable(weights, monkeypatch, extra):
    """JAX reads the variable before the extra: the pool's page and the
    store's block follow it."""
    monkeypatch.setenv("LAMBDIPY_PREFIX_BLOCK", "16")
    extra = {**BASE, "kv_paged": "1", "prefix_cache_mb": "8", **extra}
    state, eng, jeng = _engines(weights, extra)
    assert eng.pool.page == jeng.pool.page == 16
    assert state.prefix_store.block == 16


@pytest.mark.parametrize("extra,want", [({}, "flash"),
                                        ({"attn_backend": "dense"}, "dense")],
                         ids=["env", "extra-first"])
def test_attn_backend_variable(weights, monkeypatch, extra, want):
    monkeypatch.setenv("LAMBDIPY_ATTN_BACKEND", "flash")
    state = _handler(weights, extra, base={})
    jstate = _jax_handler(extra, base={})
    jserver = next(c.cell_contents for c in jstate.invoke_fn.__closure__
                   if type(c.cell_contents).__name__ == "LlamaServer")
    assert state.meta["attn_backend"] == want
    assert jserver.model.cfg.attn_backend == want


@pytest.mark.parametrize("env,extra,want", [
    ("1024", {}, 1024), ("1024", {"max_logical_ctx": "512"}, 512),
], ids=["env", "extra-first"])
def test_max_logical_ctx_variable(weights, monkeypatch, env, extra, want):
    monkeypatch.setenv("LAMBDIPY_MAX_LOGICAL_CTX", env)
    _, eng, jeng = _engines(weights, {**BASE, "kv_paged": "1", **extra})
    assert eng.max_logical_ctx == jeng.max_logical_ctx == want
    # without paged K/V both stand the tier down at boot
    _, eng, jeng = _engines(weights, {**BASE, **extra})
    assert eng.max_logical_ctx == jeng.max_logical_ctx == 0


@pytest.mark.parametrize("env,extra,want", [
    ("1", {}, True), ("1", {"long_prefill": "0"}, False),
], ids=["env", "extra-first"])
def test_long_prefill_variable(weights, monkeypatch, env, extra, want):
    monkeypatch.setenv("LAMBDIPY_LONG_PREFILL", env)
    _, eng, jeng = _engines(weights, {**BASE, "kv_paged": "1", **extra})
    assert eng.long_prefill == jeng.long_prefill == want


@pytest.mark.parametrize("env,extra,want", [
    (None, {}, True), ("0", {}, False), ("1", {}, True),
    ("0", {"batch_window_bucketing": "1"}, True),
], ids=["unset", "off", "window-bucketing", "extra-first"])
def test_window_bucketing_variable(weights, monkeypatch, env, extra, want):
    """Window bucketing is on unless turned off; the extra wins over
    ``LAMBDIPY_WINDOW_BUCKETING``, as in JAX (``handlers.py:509-511``)."""
    if env is not None:
        monkeypatch.setenv("LAMBDIPY_WINDOW_BUCKETING", env)
    state, eng, jeng = _engines(weights, {**BASE, **extra})
    assert eng.window_bucketing is jeng.window_bucketing is want
    assert state.stats()["batching"]["window_bucketing"] is want


@pytest.mark.parametrize("var,on,off,key,error,match", [
    ("LAMBDIPY_MESH", "2x2", "off", "mesh", NotImplementedError,
     r"item 3 \(c2\)"),
    ("LAMBDIPY_PREFILL_MODE", "sp", "chunked", "prefill_mode", ValueError,
     "not have yet"),
], ids=["mesh", "prefill-mode"])
def test_unported_feature_variables_raise(weights, monkeypatch, var, on,
                                          off, key, error, match):
    """A value that turns an unported feature on raises, as the extra
    does (a serving mesh's ``dp`` axis: ROADMAP queue 1, item 3 (c2); tp
    serves); the feature's off value builds, and an extra that turns it
    off wins over the variable, as in JAX."""
    monkeypatch.setenv(var, on)
    with pytest.raises(error, match=match):
        _handler(weights, BASE)
    assert _handler(weights, {**BASE, key: off}).engine is not None
    monkeypatch.setenv(var, off)
    assert _handler(weights, BASE).engine is not None


def test_solo_row_streams_at_the_requests_segment(weights):
    """``batch_cache_len = 32``, engine segment 4: a 30-token prompt with
    24 new tokens runs solo, and ``"segment": 8`` streams it in chunks of
    [8, 8, 8] through both handlers; the tokens agree."""
    extra = {**BASE, "batch_cache_len": "32", "batch_segment": "4"}
    body = {"tokens": [(3 * j) % 97 + 2 for j in range(30)],
            "max_new_tokens": 24, "segment": 8}
    recs = list(_handler(weights, extra).invoke_stream(dict(body)))
    jrecs = list(_jax_handler(extra).invoke_stream(dict(body)))
    sizes = [len(r["tokens"][0]) for r in recs[:-1]]
    assert sizes == [len(r["tokens"][0]) for r in jrecs[:-1]] == [8, 8, 8]
    assert [t for r in recs[:-1] for t in r["tokens"][0]] \
        == [t for r in jrecs[:-1] for t in r["tokens"][0]]
    assert recs[-1]["n_new"] == jrecs[-1]["n_new"] == 24


def test_segments_run_counts_as_jax(weights):
    """Three requests one after another (depth 1, 4-step segments, 8 and
    12 new tokens: whole segments): ``segments_run`` and
    ``rows_in_segments`` equal the JAX engine's, beside the port's own
    ``segments``."""
    extra = {**BASE, "batch_max": "2", "batch_segment": "4",
             "pipeline_depth": "1", "batch_window_bucketing": "0"}
    state, jstate = _handler(weights, extra), _jax_handler(extra)
    for n, toks in ((8, [4, 5, 6]), (12, [7, 8, 9, 10]), (8, [11, 12])):
        body = {"tokens": toks, "max_new_tokens": n}
        assert state.invoke(body)["tokens"] == jstate.invoke(body)["tokens"]
    got = json.loads(json.dumps(state.stats()["batching"]))
    want = jstate.stats()["batching"]
    assert (got["segments_run"], got["rows_in_segments"]) \
        == (want["segments_run"], want["rows_in_segments"]) == (7, 7)
    assert got["segments"] == 7
