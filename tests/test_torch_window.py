"""Window-bucketed decode in the port's continuous engine
(``lambdipy_tpu_torch/runtime/continuous.py``, ``_window``; the plain
attention's ``models/llama.py DecodeStep.narrowed``) against the JAX
package's (``lambdipy_tpu/runtime/continuous.py:1876-1931``), on
``llama-tiny`` (f32, 2 layers, JAX's weights carried over) on the CPU:

- the same burst through a windowed and a full-window engine gives every
  row bitwise (tokens and logprobs), dense and paged, under the plain
  attention (``dense``: the narrowed view runs) and the decode kernel's
  plain version (``blocked``: the full-window program runs), greedy and
  seeded sampled rows, spec off and on (lookup and model drafts);
  tokens equal solo ``generate`` (logprobs within 1e-5, the tolerance of
  ``tests/test_torch_continuous.py``: solo attends over its own bucket);
- ``decode_window`` and the greedy tokens equal the JAX engine's on a
  schedule of whole segments; where the furthest row's quota is shorter than a segment,
  the port's last segment advances by the quota (ROADMAP §3) and its
  sums follow JAX's formulas with that advance;
- with bucketing off the only bucket is ``cache_len``; ladder level 2
  pins it and turns speculation off;
- ``DecodeWindowStats`` mirrors ``tests/test_metrics.py:90-131``.

A burst is made deterministic by admitting every request before the
engine thread starts (:func:`_burst`): one schedule, whatever the
threads' timing."""

import threading
import time

import jax
import numpy as np
import pytest

from lambdipy_tpu.models import registry as jreg
from lambdipy_tpu.runtime.continuous import ContinuousBatcher as JaxBatcher
from lambdipy_tpu.runtime.metrics import \
    DecodeWindowStats as JaxDecodeWindowStats
from lambdipy_tpu_torch.models import registry as treg
from lambdipy_tpu_torch.models.params import from_jax_params
from lambdipy_tpu_torch.runtime.handlers import make_engine
from lambdipy_tpu_torch.runtime.metrics import DecodeWindowStats

LP_TOL = 1e-5
BASE = {"batch_max": "4", "batch_segment": "4"}
PAGED = {"kv_paged": "1", "prefix_block": "16"}
SPEC = {"off": {}, "lookup": {"spec_k": "4"},
        "model": {"spec_k": "4", "draft_mode": "model"}}


@pytest.fixture(scope="module")
def weights():
    """JAX's llama-tiny (its plain attention) and its weights, as JAX
    arrays and as the port's state dict."""
    adapter = jreg.get("llama-tiny").build(extra={"attn_backend": "dense"})
    params = adapter.init_params(seed=0)
    return adapter, params, from_jax_params(
        jax.tree_util.tree_map(np.asarray, params))


@pytest.fixture(scope="module")
def servers(weights):
    """The port's servers over those weights, plain attention and the
    decode kernel's plain version."""
    return {backend: treg.get("llama-tiny").build(
        extra={"attn_backend": backend}).make_server(weights[2], device="cpu")
        for backend in ("dense", "blocked")}


def _prompt(i, n):
    return [(7 * i + 3 * j) % 500 + 1 for j in range(n)]


# (prompt, max_new, knobs): greedy and seeded sampled rows whose prompts
# and budgets cross the 16- and 32-position buckets, one more row than
# slots
REQUESTS = [(_prompt(0, 20), 16, {}),
            (_prompt(1, 5), 12, {"temperature": 0.8, "seed": 3}),
            (_prompt(2, 40), 9, {}),
            (_prompt(3, 9), 20, {"temperature": 1.1, "top_k": 5, "seed": 1}),
            (_prompt(4, 3), 7, {})]


def _burst(engine, requests, logprobs=True):
    """Each request from its own thread, every one admitted before the
    engine thread starts, queued in the list's order: the engine (the
    port's or JAX's) runs one schedule whatever the threads' timing."""
    with engine._lock:
        engine._engine_running = True  # admissions queue; nothing runs
    out, errors = [None] * len(requests), []

    def run(i):
        p, n, kw = requests[i]
        try:
            out[i] = engine.generate(p, max_new_tokens=n,
                                     return_logprobs=logprobs, **kw)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(requests))]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 60
    while len(engine._joiners) < len(requests):
        assert time.monotonic() < deadline and not errors, errors
        time.sleep(0.005)
    order = {tuple(p): i for i, (p, _, _) in enumerate(requests)}
    with engine._lock:
        engine._joiners.sort(
            key=lambda e: order[tuple(int(t) for t in e["row"])])
        threading.Thread(target=engine._engine_loop, args=(engine._gen,),
                         daemon=True).start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    return out


@pytest.mark.parametrize("spec", SPEC)
@pytest.mark.parametrize("kind", ["dense", "paged"])
@pytest.mark.parametrize("backend", ["dense", "blocked"])
def test_windowed_rows_are_the_full_window_rows_and_solo(servers, backend,
                                                         kind, spec):
    """Bitwise against the full-window engine (tokens and logprobs);
    tokens equal solo ``generate``, logprobs within ``LP_TOL``. The
    windowed engine dispatched narrower windows than its cache."""
    srv = servers[backend]
    extra = {**BASE, **(PAGED if kind == "paged" else {}), **SPEC[spec]}
    on = make_engine(srv, extra)
    off = make_engine(srv, {**extra, "batch_window_bucketing": "0"})
    assert on.window_bucketing and not off.window_bucketing
    got, want = _burst(on, REQUESTS), _burst(off, REQUESTS)
    for (toks, lps), (wt, wl) in zip(got, want):
        np.testing.assert_array_equal(toks, wt)
        np.testing.assert_array_equal(lps, wl)
    for (p, n, kw), (toks, lps) in zip(REQUESTS, got):
        st, sl = srv.generate(p, max_new_tokens=n, return_logprobs=True,
                              **kw)
        np.testing.assert_array_equal(toks, st)
        np.testing.assert_allclose(lps, sl, atol=LP_TOL)
    win = on.stats()["decode_window"]
    assert win["savings_ratio"] < 1.0
    assert min(int(w) for w in win["buckets"]) < on.cache_len
    assert win["attended_tokens"] <= win["window_tokens"] \
        < win["full_tokens"]
    if backend == "dense":
        # the plain attention ran narrowed views, one program per window
        assert on._views and all(w < on.cache_len for w in on._views)
    else:
        assert not on._views  # the kernel's full-window program ran
    if spec != "off":
        assert on.stats()["verify_segments"] > 0


def _jax_pool(adapter, kind):
    if kind != "paged":
        return None
    from lambdipy_tpu.models.llama import init_page_arena, page_kv_bytes
    from lambdipy_tpu.runtime.pagepool import PagePool

    cfg = adapter.config
    n = 4 * cfg.max_len // 16 + 1
    return PagePool(n_pages=n, page=16, page_bytes=page_kv_bytes(cfg, 16),
                    make_arena=lambda: init_page_arena(cfg, n, 16),
                    window_pages=cfg.max_len // 16)


def _whole_segments(requests):
    """The rows' budgets are whole segments of 4 and every row starts at
    the first barrier, so the port's segments advance 4 steps, JAX's."""
    return [(p, 4 * -(-n // 4), kw) for p, n, kw in requests]


@pytest.mark.parametrize("kind,depth", [("dense", 2), ("paged", 1)])
def test_decode_window_equals_the_jax_engine(weights, servers, kind, depth):
    """On a schedule of whole segments the JAX engine (window bucketing
    on, its default) and the port's dispatch the same segments at the
    same windows: ``decode_window`` is equal key for key, and the greedy
    tokens are JAX's."""
    adapter, params, _ = weights
    requests = _whole_segments([r for r in REQUESTS if not r[2]])
    jax_engine = JaxBatcher(adapter.make_server(params), slots=4,
                            segment=4, page_pool=_jax_pool(adapter, kind),
                            pipeline_depth=depth)
    engine = make_engine(servers["dense"],
                         {**BASE, **(PAGED if kind == "paged" else {}),
                          "pipeline_depth": str(depth)})
    want_toks = _burst(jax_engine, requests, logprobs=False)
    got_toks = _burst(engine, requests, logprobs=False)
    for g, w in zip(got_toks, want_toks):
        np.testing.assert_array_equal(g, np.asarray(w))
    want = jax_engine.stats()["decode_window"]
    assert engine.stats()["decode_window"] == want
    assert want["savings_ratio"] < 1.0


def _one_row_window(s, n, segment, cache_len, advance):
    """``decode_window`` of one row of ``s`` prompt tokens and ``n`` new
    ones run alone, each segment at ``advance(disp)`` steps, by JAX's
    formulas (``continuous.py:1883-1897``, ``:1977-1981``)."""
    st = DecodeWindowStats()
    disp = 0
    while disp < n:
        adv = advance(disp)
        pos = s + disp
        window = min(max(16, 1 << (pos + adv - 1).bit_length()), cache_len)
        st.record_segment(attended=adv * pos + adv * (adv + 1) // 2,
                          window_read=adv * window,
                          full_window=adv * cache_len, window=window)
        disp += adv
    return st.report()


def test_last_segment_advances_by_the_quota_not_the_segment(weights,
                                                            servers):
    """A row of 26 prompt tokens and 6 new ones at segment 4: JAX
    dispatches 4 and 4 steps (its scan's length is static), the port 4
    and 2 (the furthest row's quota; ROADMAP §3), so the last segment's
    sums differ and its window is 32 in the port (30 + 2 positions), 64
    in JAX (30 + 4). Each engine matches JAX's formulas with its own
    advance."""
    adapter, params, _ = weights
    jax_engine = JaxBatcher(adapter.make_server(params), slots=4, segment=4,
                            pipeline_depth=1)
    engine = make_engine(servers["dense"], {**BASE, "pipeline_depth": "1"})
    row = _prompt(5, 26)
    np.testing.assert_array_equal(
        engine.generate(row, max_new_tokens=6),
        np.asarray(jax_engine.generate(row, max_new_tokens=6)))
    jax_win = jax_engine.stats()["decode_window"]
    win = engine.stats()["decode_window"]
    assert jax_win == _one_row_window(26, 6, 4, 128, lambda d: 4)
    assert win == _one_row_window(26, 6, 4, 128, lambda d: min(4, 6 - d))
    assert win["segments"] == jax_win["segments"] == 2
    assert win["buckets"] == {"32": 2}
    assert jax_win["buckets"] == {"32": 1, "64": 1}


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_bucketing_off_reads_the_full_window(servers, kind):
    engine = make_engine(servers["dense"],
                         {**BASE, **(PAGED if kind == "paged" else {}),
                          "batch_window_bucketing": "0"})
    _burst(engine, REQUESTS)
    win = engine.stats()["decode_window"]
    assert engine.stats()["window_bucketing"] is False
    assert list(win["buckets"]) == [str(engine.cache_len)]
    assert win["savings_ratio"] == 1.0 and win["segments"] > 0
    assert not engine._views


@pytest.mark.parametrize("backend", ["dense", "blocked"])
def test_ladder_level_two_pins_the_full_window(servers, backend):
    """From ladder level 2 every segment runs at the full window and
    speculation is off (JAX ``continuous.py:1883``); the rows stay the
    spec-off rows."""
    srv = servers[backend]
    engine = make_engine(srv, {**BASE, **SPEC["lookup"]})
    engine.fault_stats.record_degrade(2, "test")
    engine.fault_stats.record_degrade(2, "test")
    out = _burst(engine, REQUESTS)
    stats = engine.stats()
    win = stats["decode_window"]
    assert list(win["buckets"]) == [str(engine.cache_len)]
    assert stats["verify_segments"] == 0 and not engine._views
    plain = _burst(make_engine(srv, BASE), REQUESTS)
    for (t, lp), (pt, plp) in zip(out, plain):
        np.testing.assert_array_equal(t, pt)
        np.testing.assert_array_equal(lp, plp)


def _record(st):
    # 2 rows x 4 steps at a 64-window inside a 256 cache, then 1 row x 4
    # steps at the full window
    st.record_segment(attended=300, window_read=2 * 4 * 64,
                      full_window=2 * 4 * 256, window=64)
    st.record_segment(attended=900, window_read=4 * 256,
                      full_window=4 * 256, window=256)


def test_decode_window_stats_counters():
    """The empty report and JAX's example (``tests/test_metrics.py:90``):
    the port's report equals JAX's key for key."""
    st, jst = DecodeWindowStats(), JaxDecodeWindowStats()
    assert st.report() == jst.report() == {
        "attended_tokens": 0, "window_tokens": 0, "full_tokens": 0,
        "savings_ratio": 1.0, "attended_ratio": 1.0, "segments": 0,
        "buckets": {}}
    _record(st)
    _record(jst)
    rep = st.report()
    assert rep == jst.report()
    assert rep["segments"] == 2 and rep["attended_tokens"] == 1200
    assert rep["window_tokens"] == 512 + 1024
    assert rep["full_tokens"] == 2048 + 1024
    assert rep["savings_ratio"] == round(1536 / 3072, 4)
    assert rep["attended_ratio"] == round(1200 / 3072, 4)
    assert rep["buckets"] == {"64": 1, "256": 1}


def test_decode_window_stats_concurrent():
    """Four writers of 200 segments each lose no update."""
    st = DecodeWindowStats()

    def write():
        for _ in range(200):
            st.record_segment(attended=10, window_read=32, full_window=64,
                              window=32)

    threads = [threading.Thread(target=write) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    rep = st.report()
    assert rep["segments"] == 800
    assert rep["window_tokens"] == 800 * 32
    assert rep["savings_ratio"] == 0.5 and rep["buckets"] == {"32": 800}
