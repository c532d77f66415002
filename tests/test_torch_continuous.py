"""The port's continuous engine (``lambdipy_tpu_torch/runtime/continuous.py``)
on ``llama-tiny`` (f32, 2 layers) on the CPU, mirroring
``tests/test_continuous.py`` and ``tests/test_paged.py``: staggered
concurrent requests, a mid-flight join, mixed eos rows, logprobs, seeded
sampling, more requests than slots, the solo fallback past ``cache_len``,
streaming, paged vs dense engines, int8-KV pages, the ``kv_pages`` shed
over HTTP and the handler wiring; and greedy tokens against the JAX
package's ``ContinuousBatcher`` on the same weights.

Engine rows hold the solo ``LlamaServer.generate`` TOKENS exactly. Their
logprobs agree within 1e-5: on the CPU the plain attention softmaxes over
the whole cache width, which differs between the engine (``cache_len``)
and a solo request (its own bucket), and PyTorch's CPU reductions may sum
in another order at another width. Paged and dense engines attend at the
same width (``cache_len``) and agree bitwise, logprobs included."""

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
from lambdipy_tpu.models.llama import init_page_arena as jax_init_page_arena
from lambdipy_tpu.models.llama import page_kv_bytes as jax_page_kv_bytes
from lambdipy_tpu.runtime.continuous import ContinuousBatcher as JaxBatcher
from lambdipy_tpu.runtime.handlers import \
    generate_handler as jax_generate_handler
from lambdipy_tpu.runtime.pagepool import PagePool as JaxPagePool
from lambdipy_tpu_torch.models import registry as treg
from lambdipy_tpu_torch.models.params import from_jax_params
from lambdipy_tpu_torch.runtime import continuous
from lambdipy_tpu_torch.runtime.continuous import ContinuousBatcher
from lambdipy_tpu_torch.runtime.handlers import (HandlerContext,
                                                 generate_handler,
                                                 make_engine)
from lambdipy_tpu_torch.runtime.pagepool import PagesExhausted
from lambdipy_tpu_torch.runtime.server import BundleServer

EXTRA = {"attn_backend": "blocked"}
LP_TOL = 1e-5
ENGINES = {"dense": {"batch_max": "4", "batch_segment": "4"},
           "paged": {"batch_max": "4", "batch_segment": "4",
                     "kv_paged": "1", "prefix_block": "16"}}


@pytest.fixture(scope="module")
def weights():
    adapter = jreg.get("llama-tiny").build(extra=EXTRA)
    params = adapter.init_params(seed=0)
    return adapter, params, from_jax_params(
        jax.tree_util.tree_map(np.asarray, params))


@pytest.fixture(scope="module")
def server(weights):
    return treg.get("llama-tiny").build(extra=EXTRA).make_server(
        weights[2], device="cpu")


def _prompt(i, n):
    return [(7 * i + 3 * j) % 500 + 1 for j in range(n)]


def _concurrent(engine, requests, stagger=0.01):
    """Each request ``(prompt, max_new, kwargs)`` from its own thread,
    ``stagger`` seconds apart; returns the engine's outputs in order."""
    out = [None] * len(requests)

    def run(i):
        time.sleep(stagger * i)
        p, n, kw = requests[i]
        out[i] = engine.generate(p, max_new_tokens=n, return_logprobs=True,
                                 **kw)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    return out


def _assert_solo(server, requests, outs):
    for (p, n, kw), (toks, lps) in zip(requests, outs):
        want, want_lp = server.generate(p, max_new_tokens=n,
                                        return_logprobs=True, **kw)
        np.testing.assert_array_equal(toks, want)
        np.testing.assert_allclose(lps, want_lp, atol=LP_TOL)


@pytest.mark.parametrize("kind", ENGINES)
def test_staggered_concurrent_requests_match_solo(server, kind):
    """8 staggered requests over 4 slots: each row emits its solo tokens
    while rows share decode steps."""
    engine = make_engine(server, {**ENGINES[kind], "batch_max": "8"})
    requests = [(_prompt(i, 3 + 4 * i), 6 + 2 * i, {}) for i in range(8)]
    outs = _concurrent(engine, requests)
    _assert_solo(server, requests, outs)
    stats = engine.stats()
    assert stats["requests_served"] == 8 and stats["joins"] == 8
    assert stats["mean_rows_per_step"] > 1.0, stats
    assert stats["forwards"] == (stats["steps"] + stats["prefill_groups"]
                                 + stats["row_prefills"])
    if kind == "paged":
        pool = stats["page_pool"]
        assert pool["pages_live"] == 0 and pool["alloc_pages"] == sum(
            -(-(len(p) + n) // 16) for p, n, _ in requests)
        # the pool's peak is the most pages that rows held at once, as
        # their logged charge and release times order them
        log = list(engine.request_log)
        assert [r["n_pages"] for r in log] == [-(-(r["s"] + r["n"]) // 16)
                                               for r in log]
        events = sorted([(r["charged_at"], r["n_pages"]) for r in log]
                        + [(r["released_at"], -r["n_pages"]) for r in log])
        held = np.cumsum([d for _, d in events])
        assert held[-1] == 0 and held.max() == pool["pages_live_peak"] > 0
        engine.pool.check_invariants()


def test_midflight_join(server):
    """A request arriving while another decodes joins at the next segment
    boundary instead of waiting for the whole decode."""
    engine = make_engine(server, ENGINES["paged"])
    requests = [(_prompt(1, 5), 40, {}), (_prompt(2, 3), 8, {})]
    outs = _concurrent(engine, requests, stagger=0.05)
    _assert_solo(server, requests, outs)
    stats = engine.stats()
    # the short row rode the long row's steps: far fewer steps than the
    # two decodes one after the other
    assert stats["steps"] < 40 + 8, stats
    assert stats["rows_stepped"] > stats["steps"]


def test_mixed_eos_rows_share_the_batch(server):
    base = [(_prompt(i, 6 + i), 12, {}) for i in range(3)]
    plain = [server.generate(p, max_new_tokens=n) for p, n, _ in base]
    requests = [(p, n, {"eos_id": int(plain[i][0, 3 + i])})
                for i, (p, n, _) in enumerate(base)]
    outs = _concurrent(make_engine(server, ENGINES["dense"]), requests)
    _assert_solo(server, requests, outs)
    for (toks, lps), (_, _, kw) in zip(outs, requests):
        cut = list(toks[0]).index(kw["eos_id"])
        assert (toks[0, cut:] == kw["eos_id"]).all()
        assert (lps[0, cut + 1:] == 0).all()


def test_sampled_requests_batch_with_parity(server):
    """Seeded sampled rows packed beside greedy ones draw exactly their
    solo tokens: each row's generator travels with its slot and draws
    once per step."""
    knobs = [{"temperature": 0.8, "top_p": 0.9, "seed": 7},
             {}, {"temperature": 1.1, "top_k": 20, "seed": 3}, {}]
    requests = [(_prompt(i, 4 + 3 * i), 14, kw)
                for i, kw in enumerate(knobs)]
    for kind in ENGINES:
        outs = _concurrent(make_engine(server, ENGINES[kind]), requests)
        _assert_solo(server, requests, outs)


def test_more_requests_than_slots(server):
    engine = make_engine(server, {**ENGINES["paged"], "batch_max": "2"})
    requests = [(_prompt(i, 5), 6 + i, {}) for i in range(6)]
    outs = _concurrent(engine, requests, stagger=0.0)
    _assert_solo(server, requests, outs)
    assert engine.stats()["requests_served"] == 6


def test_over_cache_len_runs_solo(server):
    """A row past the engine's ``cache_len`` serves solo, as JAX's
    engine does; so does a row needing more pages than the arena
    holds."""
    engine = make_engine(server, {**ENGINES["paged"],
                                  "batch_cache_len": "64", "kv_pages": "3"})
    requests = [(_prompt(1, 50), 20, {}),   # 70 > cache_len 64
                (_prompt(2, 30), 10, {})]   # 3 pages > 2 in the arena
    outs = [engine.generate(p, max_new_tokens=n, return_logprobs=True)
            for p, n, _ in requests]
    _assert_solo(server, requests, outs)
    assert engine.stats()["requests_served"] == 0


def test_stream_rides_the_engine(server):
    engine = make_engine(server, ENGINES["paged"])
    prompt, n = _prompt(4, 9), 11
    chunks = list(engine.generate_stream(prompt, max_new_tokens=n,
                                         return_logprobs=True))
    assert all(c[0].shape[1] <= 4 for c in chunks)
    toks = np.concatenate([c[0] for c in chunks], axis=1)
    lps = np.concatenate([c[1] for c in chunks], axis=1)
    want, want_lp = server.generate(prompt, max_new_tokens=n,
                                    return_logprobs=True)
    np.testing.assert_array_equal(toks, want)
    np.testing.assert_allclose(lps, want_lp, atol=LP_TOL)
    assert engine.stats()["requests_served"] == 1
    # a reader that falls behind the engine still gets chunks of at most
    # one segment
    stream = engine.generate_stream(prompt, max_new_tokens=n)
    lagged = [next(stream)]
    time.sleep(0.5)  # the engine books the rest meanwhile
    lagged += list(stream)
    assert [c.shape[1] for c in lagged][1:] == [4, 3]
    np.testing.assert_array_equal(np.concatenate(lagged, axis=1), want)
    # eos: the chunk holding it is eos-padded and the stream ends there
    eos = int(want[0, 5])
    chunks = list(engine.generate_stream(prompt, max_new_tokens=n,
                                         eos_id=eos))
    got = np.concatenate(chunks, axis=1)[0]
    ref = server.generate(prompt, max_new_tokens=n, eos_id=eos)[0]
    np.testing.assert_array_equal(got, ref[:got.size])
    assert got.size < n and got[-1] == eos


def test_server_generate_stream_matches_generate(server):
    rows = [_prompt(1, 7), _prompt(2, 12)]
    chunks = list(server.generate_stream(rows, max_new_tokens=10,
                                         segment=4, return_logprobs=True))
    assert [c[0].shape for c in chunks] == [(2, 4), (2, 4), (2, 2)]
    want, want_lp = server.generate(rows, max_new_tokens=10,
                                    return_logprobs=True)
    np.testing.assert_array_equal(np.concatenate([c[0] for c in chunks], 1),
                                  want)
    np.testing.assert_array_equal(np.concatenate([c[1] for c in chunks], 1),
                                  want_lp)


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["float", "int8"])
def test_paged_engine_is_bitwise_the_dense_engine(weights, kv_quant):
    """The same traffic through paged and dense engines: tokens and
    logprobs bitwise equal (the gather reads exactly the values the
    dense slot cache holds, at the same width). Tokens also equal solo
    generation, int8 K/V included."""
    extra = {**EXTRA, **({"kv_quant": kv_quant} if kv_quant else {})}
    srv = treg.get("llama-tiny").build(extra=extra).make_server(
        weights[2], device="cpu")
    requests = [(_prompt(i, 5 + 9 * i), 9 + 3 * i,
                 {"temperature": 0.7, "seed": i} if i == 2 else {})
                for i in range(5)]
    outs = {kind: [make_engine(srv, ENGINES[kind]).generate(
        p, max_new_tokens=n, return_logprobs=True, **kw)
        for p, n, kw in requests] for kind in ENGINES}
    for (td, ld), (tp, lp) in zip(outs["dense"], outs["paged"]):
        np.testing.assert_array_equal(tp, td)
        np.testing.assert_array_equal(lp, ld)
    for (p, n, kw), (toks, _) in zip(requests, outs["paged"]):
        np.testing.assert_array_equal(
            toks, srv.generate(p, max_new_tokens=n, **kw))


def test_long_prompt_prefills_on_its_request_thread(server, monkeypatch):
    """Prompts past ``GROUP_PREFILL_MAX`` prefill alone on their request
    threads, one at a time; short ones join the engine's group
    prefill."""
    monkeypatch.setattr(continuous, "GROUP_PREFILL_MAX", 8)
    engine = ContinuousBatcher(server, slots=4, segment=4)
    running, most = [0], [0]
    count = threading.Lock()
    prefill_rows = engine._prefill_rows

    def tracked(entries):
        if threading.current_thread().name == "continuous-batch":
            return prefill_rows(entries)
        with count:
            running[0] += 1
            most[0] = max(most[0], running[0])
        time.sleep(0.05)  # hold the prefill open while the others arrive
        try:
            return prefill_rows(entries)
        finally:
            with count:
                running[0] -= 1

    monkeypatch.setattr(engine, "_prefill_rows", tracked)
    requests = [(_prompt(5, 30), 7, {}), (_prompt(6, 4), 9, {}),
                (_prompt(7, 20), 5, {}), (_prompt(8, 25), 6, {})]
    outs = _concurrent(engine, requests, stagger=0.0)
    _assert_solo(server, requests, outs)
    stats = engine.stats()
    assert stats["row_prefills"] == 3 and stats["rows_group_prefilled"] == 1
    assert most[0] == 1


def _post(url, body, headers=False):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            out = resp.status, resp.read()
            hdrs = dict(resp.headers)
    except urllib.error.HTTPError as e:
        out, hdrs = (e.code, e.read()), dict(e.headers)
    return (*out, hdrs) if headers else out


def test_full_arena_sheds_503_kv_pages_over_http(weights):
    state = generate_handler(
        {"model": "llama-tiny", "dtype": "float32",
         "extra": {**EXTRA, **ENGINES["paged"], "batch_mode": "continuous",
                   "kv_pages": "9", "warm_group_prefill": "0"}},
        HandlerContext(device="cpu", state_dict=weights[2]))
    pool = state.engine.pool
    held = pool.alloc(6)  # another tenant holds most of the arena
    server = BundleServer(state, port=0).start_background()
    body = {"tokens": _prompt(3, 20), "max_new_tokens": 30}  # 4 pages
    try:
        code, raw, hdrs = _post(server.url + "/invoke", body, headers=True)
        s_code, s_raw = _post(server.url + "/invoke", {**body,
                                                       "stream": True})
        pool.release(held)
        ok_code, ok_raw = _post(server.url + "/invoke", body)
        st_code, st_raw = _post(server.url + "/invoke", {**body,
                                                         "stream": True})
        metrics = json.loads(urllib.request.urlopen(
            server.url + "/metrics", timeout=60).read())
    finally:
        server.stop()
    shed = json.loads(raw)
    assert code == 503 and s_code == 503
    assert shed["shed"] == "kv_pages" and shed["ok"] is False
    assert int(hdrs["Retry-After"]) >= 1 and shed["retry_after_s"] > 0
    assert json.loads(s_raw)["shed"] == "kv_pages"
    assert ok_code == 200 and st_code == 200
    tokens = json.loads(ok_raw)["tokens"]
    lines = [json.loads(x) for x in st_raw.splitlines()]
    assert lines[-1]["done"] and lines[-1]["n_new"] == 30
    streamed = [t for r in lines[:-1] for t in r["tokens"][0]]
    assert [streamed] == tokens
    assert metrics["server"]["sheds"] == {"kv_pages": 2}
    assert metrics["server"]["errors"] == 0
    page_pool = metrics["handler"]["batching"]["page_pool"]
    # the prefix store (on by default) keeps the prompt's whole 16-token
    # block in a page of the arena: the only page live after the drain
    prefix_cache = metrics["handler"]["prefix_cache"]
    assert page_pool["sheds"] == 2
    assert page_pool["pages_live"] == prefix_cache["blocks"] == 1


def test_handler_wiring(weights):
    """``batch_mode=continuous`` + ``kv_paged`` build the engine and its
    arena; single rows ride the engine, multi-row requests run as one
    batch; ``/metrics`` carries the engine, its pool and the paged kernel
    counters; a tp=2 mesh with the default prefix store raises, naming
    ROADMAP queue 1, item 3 (c2); window bucketing and the MicroBatcher
    build as in JAX; and ``prefix_cache_mb`` builds the prefix store."""
    state = generate_handler(
        {"model": "llama-tiny", "dtype": "float32",
         "extra": {**EXTRA, **ENGINES["paged"], "batch_mode": "continuous",
                   "prefix_block": "32", "warm_group_prefill": "0"}},
        HandlerContext(device="cpu", state_dict=weights[2]))
    engine = state.engine
    assert state.meta["batch_mode"] == "continuous" and state.meta["kv_paged"]
    assert engine.pool.page == 32 and engine.pool.n_pages == 4 * 4 + 1
    # the JAX handler's defaults: pipeline depth 2, joiners in fair order
    assert engine.pipeline_depth == 2 and engine.policy.name == "fair"
    one = state.invoke({"tokens": _prompt(1, 6), "max_new_tokens": 5,
                        "logprobs": True})
    two = state.invoke({"tokens": [_prompt(1, 6), _prompt(2, 9)],
                        "max_new_tokens": 5})
    assert one["tokens"][0] == two["tokens"][0]
    stats = state.stats()
    assert stats["batching"]["requests_served"] == 1
    assert stats["batching"]["page_pool"]["pages_total"] == 16
    assert {"paged_decode_attention", "paged_decode_attention_int8kv"} \
        <= set(stats["kernels"])
    with pytest.raises(ValueError, match=r"prefix store .* item 3 \(c2\)"):
        generate_handler({"model": "llama-tiny",
                          "extra": {"batch_mode": "continuous",
                                    "mesh": "tp=2"}},
                         HandlerContext(device="cpu"))
    # window bucketing (on unless the extra turns it off) and the
    # MicroBatcher (batch_window_ms > 0 without the engine) build what
    # the JAX handler builds: the same batching blocks in /metrics
    for extra, want in (
            ({"batch_mode": "continuous", "batch_window_bucketing": "1"},
             True),
            ({"batch_mode": "continuous"}, True),
            ({"batch_mode": "continuous", "batch_window_bucketing": "0"},
             False)):
        built = generate_handler({"model": "llama-tiny", "extra": extra},
                                 HandlerContext(device="cpu"))
        jbatching = _jax_handler_stats(extra)["batching"]
        assert built.engine.window_bucketing is want \
            is jbatching["window_bucketing"]
        assert set(built.stats()["batching"]["decode_window"]) \
            == set(jbatching["decode_window"])
    for extra in ({"batch_mode": "window", "batch_window_ms": "2"},
                  {"batch_window_ms": "2"}):
        built = generate_handler({"model": "llama-tiny", "extra": extra},
                                 HandlerContext(device="cpu"))
        assert built.engine is None and built.prefix_store is None
        assert built.meta["batch_mode"] == "window"
        assert built.stats()["batching"] == \
            _jax_handler_stats(extra)["batching"]
    unbatched = generate_handler(
        {"model": "llama-tiny", "extra": {"batch_mode": "window"}},
        HandlerContext(device="cpu"))
    assert unbatched.engine is None and unbatched.batcher is None
    assert "batching" not in _jax_handler_stats({"batch_mode": "window",
                                                 "prefix_cache_mb": "0"})
    # a tokenizer that does not load degrades to token ids, as in JAX
    no_tok = generate_handler(
        {"model": "llama-tiny", "extra": {"tokenizer_path": "tokenizer/"}},
        HandlerContext(device="cpu"))
    assert no_tok.meta["tokenizer"] is False
    assert no_tok.meta["tokenizer_error"]
    # the store's session and offload extras build its pins and arena
    pinned = generate_handler(
        {"model": "llama-tiny",
         "extra": {**ENGINES["paged"], "batch_mode": "continuous",
                   "session_pin_budget_mb": "64", "session_ttl_s": "60",
                   "session_idle_s": "30", "kv_offload": "1"}},
        HandlerContext(device="cpu"))
    ps = pinned.prefix_store
    assert (ps.pin_budget_bytes, ps.session_ttl_s, ps.session_idle_s) \
        == (64 << 20, 60.0, 30.0)
    assert ps.offload is not None and ps.offload.budget_bytes == 256 << 20
    # the prefix store is ported: prefix_cache_mb sizes it
    built = generate_handler({"model": "llama-tiny",
                              "extra": {"prefix_cache_mb": "8"}},
                             HandlerContext(device="cpu"))
    assert built.meta["prefix_cache"]
    assert built.prefix_store.budget_bytes == 8 << 20
    # the fault isolation extras reach the engine (an unset max_replays
    # is 1, as in JAX), and one plan serves the engine, pool and store
    assert engine.watchdog_s == 0.0 and engine.max_replays == 1
    assert not engine.faults.active()
    faulty = generate_handler(
        {"model": "llama-tiny",
         "extra": {**ENGINES["paged"], "batch_mode": "continuous",
                   "engine_watchdog_s": "3", "max_replays": "2",
                   "fault_spec": "segment_fetch:exception@seg=3"}},
        HandlerContext(device="cpu"))
    fe = faulty.engine
    assert fe.watchdog_s == 3.0 and fe.max_replays == 2
    assert fe.faults.describe() == ["segment_fetch:exception@seg=3,n=1"]
    assert fe.pool.faults is fe.faults
    assert faulty.prefix_store.faults is fe.faults


def _jax_handler_stats(extra):
    """The JAX handler's ``/metrics`` block for ``extra`` (llama-tiny,
    f32, its AOT store off)."""
    ctx = SimpleNamespace(params_dir=None, bundle_dir=None, manifest=None)
    return jax_generate_handler(
        {"model": "llama-tiny", "dtype": "float32",
         "extra": {"serve_aot": "0", **extra}}, ctx).stats_fn()


def test_greedy_tokens_equal_the_jax_engine(weights, server):
    """The JAX package's ContinuousBatcher (dense engine, synchronous,
    full window) and the port's paged engine on the same weights emit
    the same greedy tokens."""
    adapter, params, _ = weights
    jax_engine = JaxBatcher(adapter.make_server(params), slots=4, segment=4,
                            window_bucketing=False, pipeline_depth=1)
    engine = make_engine(server, ENGINES["paged"])
    for i, (s, n) in enumerate([(5, 9), (13, 6), (9, 12)]):
        p = _prompt(i, s)
        want = jax_engine.generate(p, max_new_tokens=n)
        np.testing.assert_array_equal(engine.generate(p, max_new_tokens=n),
                                      np.asarray(want))


def test_paged_engine_serves_a_bucket_wider_than_its_window(weights, server):
    """A 70-token prompt prefills at ``generate``'s 128-position bucket,
    wider than a 96-position engine window of three 32-position pages.
    The paged engine stores the window's part of the prefill and serves
    the row: its tokens are solo ``generate``'s, tokens and logprobs are
    bitwise the dense engine's, and the tokens equal the JAX paged
    engine's at the same ``cache_len``."""
    adapter, params, _ = weights
    extra = {"batch_max": "4", "batch_segment": "4", "prefix_block": "32",
             "batch_cache_len": "96"}
    p, n = _prompt(3, 70), 10
    outs = {}
    for kind, paged in (("dense", "0"), ("paged", "1")):
        engine = make_engine(server, {**extra, "kv_paged": paged})
        outs[kind] = engine.generate(p, max_new_tokens=n,
                                     return_logprobs=True)
        assert engine.stats()["requests_served"] == 1
    assert engine.pool.page == 32 and engine.pool.window_pages == 3
    with engine._lock:  # the row's pages go back at the next barrier
        while engine._engine_running:
            engine._lock.wait(0.05)
    assert engine.stats()["page_pool"]["pages_live"] == 0
    np.testing.assert_array_equal(outs["paged"][0], outs["dense"][0])
    np.testing.assert_array_equal(outs["paged"][1], outs["dense"][1])
    _assert_solo(server, [(p, n, {})], [outs["paged"]])
    cfg = adapter.make_server(params).model.cfg
    pool = JaxPagePool(n_pages=13, page=32,
                       page_bytes=jax_page_kv_bytes(cfg, 32),
                       make_arena=lambda: jax_init_page_arena(cfg, 13, 32))
    jax_engine = JaxBatcher(adapter.make_server(params), slots=4, segment=4,
                            cache_len=96, window_bucketing=False,
                            pipeline_depth=1, page_pool=pool)
    np.testing.assert_array_equal(outs["paged"][0],
                                  np.asarray(jax_engine.generate(
                                      p, max_new_tokens=n)))


def test_engine_failure_errors_every_waiting_row(server, monkeypatch):
    engine = make_engine(server, ENGINES["paged"])

    def boom(*args, **kwargs):
        raise RuntimeError("device lost")

    monkeypatch.setattr(engine, "_run_segment", boom)
    with pytest.raises(RuntimeError, match="device lost"):
        engine.generate(_prompt(1, 5), max_new_tokens=4)
    monkeypatch.undo()
    assert engine.stats()["page_pool"]["pages_live"] == 0
    np.testing.assert_array_equal(
        engine.generate(_prompt(1, 5), max_new_tokens=4),
        server.generate(_prompt(1, 5), max_new_tokens=4))


def test_pages_exhausted_reaches_the_caller(server):
    engine = make_engine(server, {**ENGINES["paged"], "kv_pages": "5"})
    held = engine.pool.alloc(3)
    with pytest.raises(PagesExhausted):
        engine.generate(_prompt(1, 20), max_new_tokens=10)
    engine.pool.release(held)
    engine.pool.check_invariants()
