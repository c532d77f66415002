"""Chunked prefill in the port (``LlamaServer(prefill_chunk=)``,
``_chunked_prefill_cache``, the continuous engine's chunked joiner
prefill, the prefix store's walk width) and the handler's bucket and cap
extras, on ``llama-tiny`` (f32, 2 layers) on the CPU, each against its
JAX twin on the same weights: ``tests/test_sampling.py``'s chunk-width
normalisation, ``tests/test_continuous.py``'s chunked joiner tests and
``tests/test_runtime.py``'s ``min_bucket`` knob.

Tolerances. Within the port, a chunked engine row runs the walk and the
continuation of solo ``generate(row[split:], prefix=row[:split])``, so its
first token and logprob are that run's bitwise; its later steps hold the
solo TOKENS exactly and the logprobs within ``LP_TOL``, as in
``tests/test_torch_continuous.py`` (on the CPU a multi-slot decode step's
plain matmuls sum a row in another order than a one-row step's; on the
card every row is bitwise, ``tests/test_torch_kernels.py``). Across the
frameworks: greedy tokens exact, K/V within ``KV_TOL`` (f32 end to end,
the frameworks sum matmuls and softmaxes in other orders)."""

import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from lambdipy_tpu.models import llama as jl
from lambdipy_tpu.models import registry as jreg
from lambdipy_tpu.runtime.continuous import ContinuousBatcher as JaxBatcher
from lambdipy_tpu.runtime.handlers import \
    generate_handler as jax_generate_handler
from lambdipy_tpu.runtime.metrics import PrefillStats as JaxPrefillStats
from lambdipy_tpu.runtime.prefixstore import PrefixStore as JaxPrefixStore
from lambdipy_tpu_torch.models import llama as tl
from lambdipy_tpu_torch.models import registry as treg
from lambdipy_tpu_torch.models.graphs import FairLock
from lambdipy_tpu_torch.models.params import from_jax_params
from lambdipy_tpu_torch.runtime import continuous
from lambdipy_tpu_torch.runtime.handlers import (HandlerContext,
                                                 generate_handler,
                                                 make_engine)
from lambdipy_tpu_torch.runtime.metrics import PrefillStats
from lambdipy_tpu_torch.runtime.prefixstore import PrefixStore

EXTRA = {"attn_backend": "blocked"}
LP_TOL = 1e-5
KV_TOL = 1e-4
CK = 16  # the chunk width of the engine tests, as the JAX tests set it
ENGINES = {"dense": {"batch_max": "2", "batch_segment": "4"},
           "paged": {"batch_max": "2", "batch_segment": "4",
                     "kv_paged": "1", "prefix_block": "16"}}
ENGINE_CASES = pytest.mark.parametrize(
    "kind,depth", [(k, d) for k in ENGINES for d in (1, 2)],
    ids=[f"{k}-depth{d}" for k in ENGINES for d in (1, 2)])


@pytest.fixture(scope="module")
def weights():
    adapter = jreg.get("llama-tiny").build(extra=EXTRA)
    params = adapter.init_params(seed=0)
    return adapter, params, from_jax_params(
        jax.tree_util.tree_map(np.asarray, params))


@pytest.fixture(scope="module")
def jax_server(weights):
    return weights[0].make_server(weights[1], prefill_chunk=CK)


def _server(weights, **kw):
    return treg.get("llama-tiny").build(extra=EXTRA).make_server(
        weights[2], device="cpu", **kw)


@pytest.fixture
def server(weights):
    return _server(weights, prefill_chunk=CK)


def _split(s: int, ck: int = CK) -> int:
    return ((s - 1) // ck) * ck


def _assert_prefix_run(got, want):
    """An engine row against its solo ``generate(prefix=)`` run: tokens
    exact, the first logprob (the continuation's) bitwise, the rest
    within ``LP_TOL``."""
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1][0, 0] == want[1][0, 0]
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=LP_TOL)


# (max_len, min_bucket, prefill_chunk): widths kept, rounded up to a
# power of two, halved until they divide the window, off when nothing
# >= min_bucket does (120 = 8 x 15: tests/test_sampling.py:532), raised
# to min_bucket, and unset
NORMALISE = [(128, 16, 16), (128, 16, 20), (128, 16, 100), (128, 16, 512),
             (128, 32, 8), (128, 1, 3), (120, 16, 32), (120, 8, 32),
             (96, 16, 32), (96, 16, 64), (100, 4, 64), (128, 16, None),
             (128, 16, 0)]


@pytest.mark.parametrize("max_len,min_bucket,ck", NORMALISE)
def test_prefill_chunk_normalises_as_the_jax_server(weights, max_len,
                                                    min_bucket, ck):
    """The JAX server's chunk-width rule, case for case, with its
    ``min_bucket`` and the default decode cap (the window)."""
    jcfg = dataclasses.replace(weights[0].config, max_len=max_len)
    jsrv = jl.LlamaServer(jl.LlamaModel(jcfg), weights[1],
                          min_bucket=min_bucket, prefill_chunk=ck)
    tcfg = dataclasses.replace(treg.get("llama-tiny").build(
        extra=EXTRA).config, max_len=max_len)
    tsrv = tl.LlamaServer(tl.LlamaModel(tcfg, device="cpu"),
                          min_bucket=min_bucket, prefill_chunk=ck)
    assert tsrv.prefill_chunk == jsrv.prefill_chunk
    assert tsrv.min_bucket == jsrv.min_bucket == min_bucket
    assert tsrv.decode_cap == jsrv.decode_cap == max_len


def test_undivisible_window_serves_unchunked(weights):
    """At ``max_len=120`` nothing >= 16 that is a power of two divides the
    window: chunking is off, and a long prefix serves as the unchunked
    server serves it (the twin of
    ``test_chunked_prefill_requires_divisible_window``)."""
    tcfg = dataclasses.replace(treg.get("llama-tiny").build(
        extra=EXTRA).config, max_len=120)
    model = tl.LlamaModel(tcfg, device="cpu")
    srv = tl.LlamaServer(model, prefill_chunk=32)
    assert srv.prefill_chunk is None
    prefix = list(range(1, 40))
    np.testing.assert_array_equal(
        srv.generate([4, 5], max_new_tokens=4, prefix=prefix),
        tl.LlamaServer(model).generate([4, 5], max_new_tokens=4,
                                       prefix=prefix))


@pytest.mark.parametrize("upto,cache_len", [(16, 128), (40, 128), (48, 128),
                                            (100, 128), (40, 64)])
def test_chunked_prefill_cache_matches_jax(jax_server, server, upto,
                                           cache_len):
    """``_chunked_prefill_cache`` against the JAX function on the same
    weights: the same index, K/V within ``KV_TOL`` over the walked
    positions, whole chunks and a ragged last one; a round per chunk."""
    row = [(5 * j) % 500 + 1 for j in range(upto + 7)]
    stats = PrefillStats()
    tcache = server._chunked_prefill_cache(row, upto, cache_len, stats=stats)
    jcache = jax_server._chunked_prefill_cache(row, upto, cache_len)
    assert stats.report()["rounds"] == -(-upto // CK)
    assert tl.cache_width(tcache) == cache_len
    for te, je in zip(tcache, jcache):
        assert int(te["index"]) == int(je["index"]) == upto
        for name in ("k", "v"):
            np.testing.assert_allclose(te[name][:, :upto].numpy(),
                                       np.asarray(je[name])[:, :upto],
                                       rtol=0, atol=KV_TOL)


def test_chunked_prefix_generate_is_token_exact_against_jax(weights,
                                                            jax_server,
                                                            server):
    """A 70-token prefix walks in chunks of 16 (the last ragged), solo and
    streamed: greedy tokens equal the JAX server's at the same
    ``prefill_chunk``, and the unchunked port server's, logprobs within
    ``LP_TOL`` of it."""
    prefix, suffix = list(range(1, 71)), [40, 41, 42, 43, 44]
    want = np.asarray(jax_server.generate(suffix, prefix=prefix,
                                          max_new_tokens=10))
    got = server.generate(suffix, prefix=prefix, max_new_tokens=10,
                          return_logprobs=True)
    np.testing.assert_array_equal(got[0], want)
    streamed = np.concatenate(list(server.generate_stream(
        suffix, prefix=prefix, max_new_tokens=10, segment=4)), axis=1)
    np.testing.assert_array_equal(streamed, want)
    plain = _server(weights).generate(suffix, prefix=prefix,
                                      max_new_tokens=10,
                                      return_logprobs=True)
    np.testing.assert_array_equal(got[0], plain[0])
    np.testing.assert_allclose(got[1], plain[1], rtol=0, atol=LP_TOL)
    assert server.prefix_stats()["prefix_entries"] == 1


def test_a_one_chunk_prefix_walks_as_the_engine_splits(server,
                                                       monkeypatch):
    """A prefix of exactly one chunk walks as an extension of an empty
    cache, as the engine walks a joiner split after one chunk (on the
    card a one-pass prefill of the chunk softmaxes at another width), and
    a shorter one prefills in one pass."""
    first, calls = server._prefix_first_fn, []

    def counted(sb, cache_len):
        calls.append(sb)
        return first(sb, cache_len)

    monkeypatch.setattr(server, "_prefix_first_fn", counted)
    walked = server.generate([40, 41], prefix=list(range(1, CK + 1)),
                             max_new_tokens=4)
    assert calls == []
    np.testing.assert_array_equal(walked, server.generate(
        list(range(1, CK + 1)) + [40, 41], max_new_tokens=4))
    server.generate([40, 41], prefix=list(range(1, CK)), max_new_tokens=4)
    assert calls == [CK]


def _jax_engine(jax_server, depth, cache_len=None):
    return JaxBatcher(jax_server, slots=2, segment=4, cache_len=cache_len,
                      group_prefill_max=8, window_bucketing=False,
                      pipeline_depth=depth)


@pytest.mark.parametrize("s", [59, 30])
@ENGINE_CASES
def test_chunked_joiner_prefill_matches_solo(jax_server, server, monkeypatch,
                                             kind, depth, s):
    """A 59-token joiner past ``GROUP_PREFILL_MAX`` prefills in 3 chunks
    of 16 and an 11-token continuation on its request thread (a 30-token
    one in 1 chunk and 14): alone and beside a short row, it is its solo
    ``generate(row[split:], prefix=row[:split])`` run (the twin of
    ``test_chunked_joiner_prefill_matches_solo``, dense and paged, depths
    1 and 2), its greedy tokens the JAX engine's, and the short row's
    too."""
    monkeypatch.setattr(continuous, "GROUP_PREFILL_MAX", 8)
    engine = make_engine(server, {**ENGINES[kind],
                                  "pipeline_depth": str(depth)})
    long_prompt = list(range(1, s + 1))
    split = _split(len(long_prompt))
    ref = server.generate(long_prompt[split:], prefix=long_prompt[:split],
                          max_new_tokens=8, return_logprobs=True)
    jref = np.asarray(_jax_engine(jax_server, depth).generate(
        long_prompt, max_new_tokens=8))
    np.testing.assert_array_equal(ref[0], jref)
    _assert_prefix_run(engine.generate(long_prompt, max_new_tokens=8,
                                       return_logprobs=True), ref)
    with ThreadPoolExecutor(max_workers=2) as ex:
        fa = ex.submit(engine.generate, long_prompt, max_new_tokens=8,
                       return_logprobs=True)
        fb = ex.submit(engine.generate, [5, 6, 7], max_new_tokens=8)
        _assert_prefix_run(fa.result(), ref)
        np.testing.assert_array_equal(
            fb.result(), np.asarray(jax_server.generate([5, 6, 7],
                                                        max_new_tokens=8)))
    stats, chunks = engine.stats(), 2 * split // CK
    assert stats["prefill_chunk"] == CK
    assert stats["row_prefills"] == 2 and stats["prefill_chunks"] == chunks
    assert stats["prefill"]["walks"] == 2
    assert stats["prefill"]["rounds"] == chunks
    assert stats["forwards"] == (stats["steps"] + stats["prefill_groups"]
                                 + 2 + chunks)
    if engine.pool is not None:
        engine.pool.check_invariants()
        assert engine.pool.stats()["pages_live"] == 0


@ENGINE_CASES
def test_chunked_joiner_on_capped_engine(weights, jax_server, server,
                                         monkeypatch, kind, depth):
    """A 64-position engine (``cache_len < max_len``, 16 | 64) walks a
    40-token joiner in 2 chunks into its own 64-position cache: the row
    holds its solo ``generate(prefix=)`` tokens (whose cache spans the
    window) and the JAX capped engine's greedy tokens (the twin of
    ``test_chunked_joiner_on_capped_engine``)."""
    monkeypatch.setattr(continuous, "GROUP_PREFILL_MAX", 8)
    engine = make_engine(server, {**ENGINES[kind], "batch_cache_len": "64",
                                  "pipeline_depth": str(depth)})
    assert engine.cache_len == 64
    prompt = list(range(1, 41))  # 40 + 8 <= 64
    split = _split(len(prompt))
    ref = server.generate(prompt[split:], prefix=prompt[:split],
                          max_new_tokens=8, return_logprobs=True)
    got = engine.generate(prompt, max_new_tokens=8, return_logprobs=True)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=LP_TOL)
    np.testing.assert_array_equal(got[0], np.asarray(
        _jax_engine(jax_server, depth, cache_len=64).generate(
            prompt, max_new_tokens=8)))
    np.testing.assert_array_equal(got[0], _server(weights).generate(
        prompt, max_new_tokens=8))
    assert engine.stats()["prefill_chunks"] == 2


class _OrderLock(FairLock):
    """A stand-in device lock: each grant (outermost acquire) is logged
    by the acquiring thread's name, in grant order."""

    def __init__(self, log):
        super().__init__()
        self.log = log

    def acquire(self) -> None:
        super().acquire()
        if self._depth == 1:
            self.log.append(threading.current_thread().name)


def test_segments_run_between_the_chunks_of_a_walk(server, monkeypatch):
    """While a short row decodes, a long joiner's walk takes the device
    lock chunk by chunk (each chunk held 30 ms): the lock's grants show
    the engine's segments between two of the walk's chunks, and the
    engine counts them as segments beside a walk."""
    monkeypatch.setattr(continuous, "GROUP_PREFILL_MAX", 8)
    order = []
    lock = _OrderLock(order)
    monkeypatch.setattr(continuous, "DEVICE_LOCK", lock)
    monkeypatch.setattr(server, "_lock", lock)
    real_ext = server._prefix_ext_fn

    def slow_ext(sbs):
        ext = real_ext(sbs)

        def held(*args):
            with lock:
                order.append("chunk")
                time.sleep(0.03)
                return ext(*args)

        return held

    monkeypatch.setattr(server, "_prefix_ext_fn", slow_ext)
    real_segment = continuous.ContinuousBatcher._run_segment

    def segment(self, live):
        order.append("segment")
        return real_segment(self, live)

    monkeypatch.setattr(continuous.ContinuousBatcher, "_run_segment",
                        segment)
    engine = make_engine(server, ENGINES["paged"])
    long_prompt = list(range(1, 100))  # 6 chunks of 16 and a tail of 3
    out = {}

    def short():
        out["short"] = engine.generate([5, 6, 7], max_new_tokens=100)

    def long():
        out["long"] = engine.generate(long_prompt, max_new_tokens=4)

    t_short = threading.Thread(target=short, name="short")
    t_short.start()
    deadline = time.monotonic() + 30
    while engine.stats()["steps"] == 0 and time.monotonic() < deadline:
        time.sleep(0.005)
    t_long = threading.Thread(target=long, name="walker")
    t_long.start()
    t_long.join(timeout=60)
    t_short.join(timeout=60)
    assert not t_long.is_alive() and not t_short.is_alive()
    chunks = [i for i, e in enumerate(order) if e == "chunk"]
    assert len(chunks) == 6  # every chunk extends the walk's cache
    between = order[chunks[0]:chunks[-1]]
    assert "segment" in between, order
    assert engine.stats()["walk_segments"] >= between.count("segment") > 0
    split = _split(len(long_prompt))
    np.testing.assert_array_equal(out["long"], server.generate(
        long_prompt[split:], prefix=long_prompt[:split], max_new_tokens=4))
    np.testing.assert_array_equal(out["short"], server.generate(
        [5, 6, 7], max_new_tokens=100))


@pytest.mark.parametrize("ck,block,wide", [(32, 16, 32), (16, 32, 128),
                                           (64, 16, 64), (None, 16, 128)])
def test_store_walk_chunk_and_counters_match_the_jax_store(weights, ck,
                                                           block, wide):
    """The store's walk width prefers the server's ``prefill_chunk`` when
    it is a multiple of the block (else the 256 family, halved to divide
    the window): the JAX store's width, and its counters and walk rounds
    route for route."""
    jsrv = weights[0].make_server(weights[1], prefill_chunk=ck)
    tsrv = _server(weights, prefill_chunk=ck)
    jstore = JaxPrefixStore(jsrv, block=block, budget_mb=8,
                            prefill_stats=JaxPrefillStats())
    tstore = PrefixStore(tsrv, block=block, budget_mb=8)
    assert tstore.walk_chunk == jstore.walk_chunk == wide
    row = list(range(1, 101)) + [7, 8, 9]
    keys = ("misses", "hits", "hit_tokens", "blocks", "bytes", "evictions",
            "assemblies")
    for tokens in (row, row[:64] + [5] * 30, row + list(range(200, 215)),
                   [1, 2, 3]):
        assert tstore.route(tokens) == jstore.route(tokens)
        ts, js = tstore.stats(), jstore.stats()
        assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}
        assert tstore.prefill_stats.report()["rounds"] \
            == jstore.prefill_stats.report()["rounds"]
    assert tstore.check_invariants()["ok"]


def _jax_handler(extra):
    ctx = SimpleNamespace(params_dir=None, bundle_dir=None, manifest=None)
    return jax_generate_handler(
        {"model": "llama-tiny", "dtype": "float32",
         "extra": {**EXTRA, "serve_aot": "0", "warm_group_prefill": "0",
                   "prefix_cache_mb": "0", **extra}}, ctx)


def _handler(weights, extra):
    return generate_handler(
        {"model": "llama-tiny", "dtype": "float32",
         "extra": {**EXTRA, "prefix_cache_mb": "0", "warm_group_prefill": "0",
                   **extra}},
        HandlerContext(device="cpu", state_dict=weights[2]))


def test_bucket_and_cap_extras_reach_the_server(weights):
    """``min_bucket``, ``decode_cap`` and ``prefill_chunk`` reach the
    server as the JAX handler passes them: with ``min_bucket = 1`` a
    one-token request keys a decode program of its prompt's bucket plus
    one step (the twin of ``test_min_bucket_recipe_knob_reaches_server``),
    and the engine chunks at the width asked."""
    state = _handler(weights, {"max_new_tokens": "4", "min_bucket": "1",
                               "decode_cap": "6", "prefill_chunk": "32"})
    jstate = _jax_handler({"max_new_tokens": "4", "min_bucket": "1",
                           "decode_cap": "6", "prefill_chunk": "32"})
    server = state.server
    assert (server.min_bucket, server.decode_cap, server.prefill_chunk) \
        == (1, 6, 32)
    out = state.invoke({"tokens": [1, 2, 3], "max_new_tokens": 1})
    jout = jstate.invoke({"tokens": [1, 2, 3], "max_new_tokens": 1})
    assert out["ok"] and out["tokens"] == jout["tokens"]
    assert len(out["tokens"][0]) == 1
    # prompt bucket 4 (3 tokens at min_bucket 1) + 1 decode step
    assert [1, 5] in [key[:2] for key in
                      state.stats()["decode_buckets"]]
    engine = _handler(weights, {"batch_mode": "continuous",
                                "prefill_chunk": "20"}).engine
    assert engine.server.prefill_chunk == 32
    assert engine.stats()["prefill_chunk"] == 32


def test_handler_answers_match_the_jax_handler(weights, tmp_path):
    """The answers to a request past ``decode_cap``, a malformed and a
    well-formed ``speculative`` field, ``random: true`` and a bundle's
    ``tokenizer_path``, against the JAX handler's."""
    state = _handler(weights, {"decode_cap": "4"})
    jstate = _jax_handler({"decode_cap": "4"})
    body = {"tokens": [1, 2, 3], "max_new_tokens": 8}
    with pytest.raises(ValueError) as err:
        state.invoke(body)
    with pytest.raises(ValueError) as jerr:
        jstate.invoke(body)
    assert str(err.value) == str(jerr.value) == (
        "max_new_tokens 8 exceeds the server's decode cap 4")
    bad = {"tokens": [1, 2, 3], "max_new_tokens": 4, "speculative": "x"}
    got, jgot = state.invoke(bad), jstate.invoke(bad)
    assert (got["ok"], got["error"]) == (jgot["ok"], jgot["error"]) == (
        False, "speculative must be an integer draft length")
    # a well-formed one is served solo, speculatively, as JAX serves it:
    # the same greedy tokens and the same verify counters
    spec, jspec = (h.invoke({**bad, "speculative": 4})
                   for h in (state, jstate))
    assert spec["ok"] and jspec["ok"]
    assert spec["tokens"] == jspec["tokens"]
    assert spec["speculative"] == jspec["speculative"]
    rnd = {"random": True, "max_new_tokens": 4}
    out, jout = state.invoke(rnd), jstate.invoke(rnd)
    assert out["ok"] and jout["ok"]
    assert out["tokens"] == jout["tokens"]
    assert out["n_prompt"] == jout["n_prompt"] == 4
    # a tokenizer neither handler can load degrades to token ids, with
    # the same answer to a text request and the reason in the meta
    missing = str(tmp_path / "no-such-tokenizer")
    jtok = _jax_handler({"tokenizer_path": missing})
    tok = _handler(weights, {"tokenizer_path": missing})
    jgot, got = jtok.invoke({"text": "hi"}), tok.invoke({"text": "hi"})
    assert (got["ok"], got["error"]) == (jgot["ok"], jgot["error"]) == (
        False, "bundle has no tokenizer; send 'tokens'")
    assert tok.meta["tokenizer"] is jtok.meta["tokenizer"] is False
    assert tok.meta["tokenizer_error"] and jtok.meta["tokenizer_error"]


class _SleepyEvent:
    """A stand-in for a segment's CUDA event: waiting on it takes
    ``seconds``, as a wait on the card's outstanding compute does."""

    def __init__(self, seconds):
        self.seconds = seconds

    def synchronize(self):
        time.sleep(self.seconds)


def test_fetch_block_s_is_transport_and_the_wait_has_its_own_key(
        server, monkeypatch):
    """The engine's wait on a segment's event lands in ``device_wait_s``;
    ``fetch_block_s`` keeps the JAX metric's interval, from the wait's
    return until the host arrays exist, near 0 here."""
    real_segment = continuous.ContinuousBatcher._run_segment

    def segment(self, live):
        rec = real_segment(self, live)
        rec["event"] = _SleepyEvent(0.05)
        return rec

    monkeypatch.setattr(continuous.ContinuousBatcher, "_run_segment",
                        segment)
    engine = make_engine(server, ENGINES["dense"])
    engine.generate([1, 2, 3], max_new_tokens=12)
    pipe = engine.stats()["pipeline"]
    assert pipe["segments"] == 3
    assert pipe["device_wait_s"] >= 3 * 0.05
    assert pipe["fetch_block_s"] < 0.05


def test_last_segment_is_the_rows_quota_not_the_jax_segment(
        weights, jax_server, server):
    """By design the port's engine dispatches ``min(segment, quota left)``
    steps where the JAX engine always runs ``segment``: sequential greedy
    requests give the JAX engine's tokens, and the port's steps are the
    rows' quotas summed, at most the JAX engine's whole segments."""
    engine = make_engine(server, {**ENGINES["dense"], "pipeline_depth": "1"})
    jengine = _jax_engine(jax_server, 1)
    reqs = [(list(range(3, 8)), 9), (list(range(20, 33)), 6),
            (list(range(9, 18)), 12)]
    for prompt, n in reqs:
        np.testing.assert_array_equal(
            engine.generate(prompt, max_new_tokens=n),
            np.asarray(jengine.generate(prompt, max_new_tokens=n)))
    steps = engine.stats()["steps"]
    jsteps = jengine.stats()["segments_run"] * jengine.segment
    assert steps == sum(n for _, n in reqs) == 27
    assert jsteps == sum(-(-n // 4) * 4 for _, n in reqs) == 32
    assert steps <= jsteps
