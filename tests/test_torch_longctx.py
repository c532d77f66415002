"""The port's long-context tier (``lambdipy_tpu_torch/runtime/longctx.py``,
the ``Prefetcher`` of ``runtime/offload.py``, the plain windowed attention
of ``ops/decode_attention.py`` and the engine's routing) against
``lambdipy_tpu/runtime/longctx.py`` and ``tests/test_long_context.py``, on
the CPU with ``llama-tiny`` (f32, the JAX weights carried over):

- the windowed reference slices exactly, and at ``base = 0`` is the plain
  reference, bitwise;
- the ``Prefetcher`` moves through the JAX state machine's states and
  counters op for op;
- the runner at 3x the window is token-exact with the JAX runner
  (logprobs within 1e-4), runs twice bitwise with zero pages leaked, a
  churned run (``resident_cap``) is bitwise the unchurned one, a replay
  after an ``offload_stall`` re-online failure is bitwise the clean run,
  and a row over the cap is refused;
- at ``base = 0`` the runner's row is bitwise the port's own prefix path
  where both run the same chunk schedule (solo ``generate(row[64:],
  prefix=row[:64])`` on a server that walks 64-token chunks), and within
  the routed bound of a one-pass ``generate`` (greedy tokens equal, the
  first logprob within 0.05);
- the engine routes a row past its window to the tier from ``generate``
  and ``generate_stream`` (the streamed chunks those of the JAX engine),
  keeps short rows on its own path, stands the tier down without paged
  K/V, and counts a ``long_prefill`` stand-down.

- a head spilled whole on one store re-ships from host RAM into another
  store bitwise.

The offload arena's tests of ``tests/test_long_context.py`` and its
store spill and dropped-entry tests have their twins in
``tests/test_torch_offload.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lambdipy_tpu.models import registry as jreg
from lambdipy_tpu.models.llama import init_page_arena as jax_arena
from lambdipy_tpu.models.llama import page_kv_bytes as jax_page_bytes
from lambdipy_tpu.ops import decode_attention as jda
from lambdipy_tpu.runtime import offload as joff
from lambdipy_tpu.runtime.continuous import ContinuousBatcher as JaxBatcher
from lambdipy_tpu.runtime.longctx import LongContextRunner as JaxRunner
from lambdipy_tpu.runtime.pagepool import PagePool as JaxPool
from lambdipy_tpu_torch.models import registry as treg
from lambdipy_tpu_torch.models.llama import init_page_arena, page_kv_bytes
from lambdipy_tpu_torch.models.params import from_jax_params
from lambdipy_tpu_torch.ops import decode_attention as tda
from lambdipy_tpu_torch.runtime import longctx
from lambdipy_tpu_torch.runtime import offload as toff
from lambdipy_tpu_torch.runtime.continuous import ContinuousBatcher
from lambdipy_tpu_torch.runtime.faults import FaultPlan
from lambdipy_tpu_torch.runtime.longctx import LongContextRunner
from lambdipy_tpu_torch.runtime.pagepool import PagePool, page_width

BLOCK = 16
EXTRA = {"attn_backend": "blocked"}
LOGPROB_TOL = 1e-4   # f32 across frameworks
ROUTED_BOUND = 0.05  # a one-pass prefill against a chunked one


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


@pytest.fixture(scope="module")
def jax_server(weights):
    adapter, params, _ = weights
    return adapter.make_server(params)


def mk_pool(server, *, n_windows=1, extra_pages=2):
    cfg = server.model.cfg
    page = page_width(cfg.max_len, BLOCK)
    n_pages = n_windows * (cfg.max_len // page) + 1 + extra_pages
    return PagePool(n_pages=n_pages, page=page,
                    page_bytes=page_kv_bytes(cfg, page),
                    make_arena=lambda: init_page_arena(cfg, n_pages, page,
                                                       "cpu"))


def mk_jax_pool(jax_server, *, n_windows=1, extra_pages=2):
    cfg = jax_server.model.cfg
    page = page_width(cfg.max_len, BLOCK)
    n_pages = n_windows * (cfg.max_len // page) + 1 + extra_pages
    return JaxPool(n_pages=n_pages, page=page,
                   page_bytes=jax_page_bytes(cfg, page),
                   make_arena=lambda: jax_arena(cfg, n_pages, page))


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(5, 100, size=n).tolist()


def _runner(server, pool, **kw):
    cfg = server.model.cfg
    return LongContextRunner(server, pool, segment=8,
                             max_logical_ctx=8 * cfg.max_len, **kw)


def _leak_free(pool):
    assert pool.free_count() == pool.capacity_pages
    pool.check_invariants()


# -- the windowed attention oracle -------------------------------------------


def test_windowed_reference_matches_full_at_base_zero():
    """At ``base = 0`` over the whole cache the windowed reference IS the
    plain reference, bitwise; and it agrees with the JAX oracle."""
    rng = np.random.default_rng(3)
    b, t, h, kvh, d = 2, 32, 4, 2, 8
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, 1, h, d), (b, t, kvh, d), (b, t, kvh, d)))
    lens = np.asarray([t, t - 5], np.int32)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    full = tda.decode_attention_reference(tq, tk, tv, torch.from_numpy(lens))
    win = tda.windowed_decode_attention_reference(
        tq, tk, tv, torch.zeros(b, dtype=torch.int32),
        torch.from_numpy(lens), t)
    assert torch.equal(full, win)
    jwin = jda.windowed_decode_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.zeros((b,), jnp.int32), jnp.asarray(lens), t)
    np.testing.assert_allclose(win.numpy(), np.asarray(jwin), atol=1e-6)


def test_windowed_reference_slides_exactly():
    """A based view is the plain reference on the pre-sliced cache,
    bitwise (the shape identity the view's gathered window rests on), and
    the JAX oracle's within 1e-6."""
    rng = np.random.default_rng(4)
    b, t, window, h, kvh, d = 2, 64, 32, 4, 2, 8
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, 1, h, d), (b, t, kvh, d), (b, t, kvh, d)))
    base = np.asarray([8, 24], np.int32)
    local = np.asarray([window, window - 3], np.int32)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    win = tda.windowed_decode_attention_reference(
        tq, tk, tv, torch.from_numpy(base), torch.from_numpy(local), window)
    manual = tda.decode_attention_reference(
        tq, torch.stack([tk[r, base[r]:base[r] + window] for r in range(b)]),
        torch.stack([tv[r, base[r]:base[r] + window] for r in range(b)]),
        torch.from_numpy(local))
    assert torch.equal(win, manual)
    jwin = jda.windowed_decode_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(base),
        jnp.asarray(local), window)
    np.testing.assert_allclose(win.numpy(), np.asarray(jwin), atol=1e-6)


# -- the prefetcher state machine ----------------------------------------------


def test_prefetcher_state_machine_matches_jax():
    """The twin of ``test_prefetcher_state_machine``, through both
    machines op for op: the same states, returns and counters."""
    jp, tp = joff.Prefetcher(), toff.Prefetcher()
    keys = [("r", 0), ("r", 1), ("r", 2)]
    ops = [("spill", keys), ("plan", [("r", 0), ("r", 1), ("x", 9)]),
           ("plan", [("r", 0)]), ("complete", [("r", 0), ("r", 1)]),
           ("demand", [("r", 0), ("r", 1), ("r", 2), ("never", 1)]),
           ("forget", [("r", 2)]), ("demand", [("r", 2)])]
    for name, arg in ops:
        assert getattr(tp, name)(list(arg)) == getattr(jp, name)(list(arg))
        assert tp.counts() == jp.counts()
        for key in keys + [("x", 9), ("never", 1)]:
            assert tp.state(key) == jp.state(key)
        assert tp.stats.report() == jp.stats.report()
    assert (toff.OFFLOADED, toff.INFLIGHT, toff.RESIDENT) \
        == (joff.OFFLOADED, joff.INFLIGHT, joff.RESIDENT)
    rep = tp.stats.report()
    assert rep["prefetch_hits"] == 2 and rep["demand_misses"] == 1
    assert ("r", 0) not in tp._state


# -- the runner ----------------------------------------------------------------


def test_runner_short_context_is_the_paged_prefix_path(weights, server):
    """At ``base = 0`` (a row that fits the window) the runner's
    half-window chunks (64 tokens extended at 0, the tail continued at
    64) are the chunk schedule of solo ``generate(row[64:],
    prefix=row[:64])`` on a server that walks 64-token chunks: tokens and
    logprobs bitwise, greedy and sampled (decode over the pages through
    the paged kernel's plain version, against the contiguous one). A
    one-pass ``generate`` keeps the greedy tokens, its first logprob
    within the routed bound. Zero pages leak."""
    chunked = treg.get("llama-tiny").build(extra=EXTRA).make_server(
        weights[2], device="cpu", prefill_chunk=64)
    pool = mk_pool(server, extra_pages=4)
    runner = _runner(chunked, pool)
    row = _prompt(90, seed=5)
    for knobs in ({}, {"temperature": 0.7, "seed": 11}):
        got = runner.generate(row, max_new_tokens=12, return_logprobs=True,
                              **knobs)
        want = chunked.generate(row[64:], prefix=row[:64],
                                max_new_tokens=12, return_logprobs=True,
                                **knobs)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    one_pass = server.generate(row, max_new_tokens=12, return_logprobs=True)
    got = runner.generate(row, max_new_tokens=12, return_logprobs=True)
    np.testing.assert_array_equal(got[0], one_pass[0])
    assert abs(got[1][0, 0] - one_pass[1][0, 0]) <= ROUTED_BOUND
    _leak_free(pool)


def test_runner_long_context_matches_jax_and_repeats(server, jax_server):
    """3x the window in one window's page budget: greedy tokens exact with
    the JAX runner (logprobs within 1e-4), the second run bitwise the
    first, zero pages leaked, the slides spilled and the leaf template
    derived once."""
    cfg = server.model.cfg
    row = _prompt(3 * cfg.max_len, seed=6)
    jrun = JaxRunner(jax_server, mk_jax_pool(jax_server), segment=8,
                     max_logical_ctx=8 * cfg.max_len)
    jt, jl = jrun.generate(row, max_new_tokens=16, return_logprobs=True)
    pool = mk_pool(server)
    runner = _runner(server, pool)
    out1 = runner.generate(row, max_new_tokens=16, return_logprobs=True)
    out2 = runner.generate(row, max_new_tokens=16, return_logprobs=True)
    np.testing.assert_array_equal(out1[0], jt)
    np.testing.assert_allclose(out1[1], jl, atol=LOGPROB_TOL)
    np.testing.assert_array_equal(out1[0], out2[0])
    np.testing.assert_array_equal(out1[1], out2[1])
    _leak_free(pool)
    rep, jrep = runner.report(), jrun.report()
    assert rep["spill_pages"] == 2 * jrep["spill_pages"] > 0
    assert rep["template_encodes"] == 1
    assert rep["offloaded_pages"] == 0
    # 6 half-window chunks and 16 steps a run: the forwards the kernels'
    # launch counters follow
    assert (rep["runs"], rep["chunks"], rep["steps"]) == (2, 12, 32)
    assert rep["forwards"] == rep["eager_prefills"] + rep["eager_steps"]


def test_runner_churn_bitwise_vs_unchurned(server):
    """``resident_cap`` yields cold view pages between segments and
    prefetches them back: bitwise the unchurned run, every demanded page
    a prefetch hit, no stall, no recompute."""
    cfg = server.model.cfg
    pool = mk_pool(server)
    base = _runner(server, pool)
    row = _prompt(3 * cfg.max_len, seed=7)
    want = base.generate(row, max_new_tokens=16, return_logprobs=True)
    churn = _runner(server, pool, resident_cap=base.n_view - 2)
    got = churn.generate(row, max_new_tokens=16, return_logprobs=True)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    rep = churn.report()
    assert rep["prefetch_hits"] > 0 and rep["reonline_pages"] > 0
    assert rep["stalls"] == 0 and rep["recomputes"] == 0
    assert rep["prefetch_hit_rate"] == 1.0
    _leak_free(pool)


def test_runner_failed_reonline_replays_bitwise(server):
    """An armed ``offload_stall`` exception fails the churned run's
    re-online: the runner replays with yielding off and emits the clean
    run's tokens and logprobs, bitwise; the recompute is counted."""
    cfg = server.model.cfg
    row = _prompt(3 * cfg.max_len, seed=8)
    clean = _runner(server, mk_pool(server))
    want = clean.generate(row, max_new_tokens=16, return_logprobs=True)
    pool = mk_pool(server)
    faulty = _runner(server, pool, resident_cap=clean.n_view - 2,
                     faults=FaultPlan.from_spec("offload_stall:exception"))
    got = faulty.generate(row, max_new_tokens=16, return_logprobs=True)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert faulty.report()["recomputes"] > 0
    _leak_free(pool)


def test_runner_rejects_over_cap(server):
    cfg = server.model.cfg
    pool = mk_pool(server, n_windows=2)
    runner = LongContextRunner(server, pool, segment=8,
                               max_logical_ctx=2 * cfg.max_len)
    assert not runner.fits(3 * cfg.max_len, 16)
    with pytest.raises(ValueError):
        runner.generate(_prompt(3 * cfg.max_len), max_new_tokens=16)
    _leak_free(pool)


def test_long_prefill_stands_down_counted(server):
    """``long_prefill`` needs a ring mesh the port does not have: the
    runner counts the stand-down and serves the chunked prefill, bitwise
    the runner without it."""
    before = longctx.standdown_stats()["reasons"].get(
        "long_prefill_without_ring_mesh", 0)
    pool = mk_pool(server)
    asked = _runner(server, pool, long_prefill=True)
    after = longctx.standdown_stats()["reasons"]
    assert after["long_prefill_without_ring_mesh"] == before + 1
    rep = asked.report()
    assert rep["long_prefill"] is True and rep["ring_active"] is False
    row = _prompt(2 * server.model.cfg.max_len, seed=9)
    np.testing.assert_array_equal(
        asked.generate(row, max_new_tokens=8),
        _runner(server, pool).generate(row, max_new_tokens=8))


# -- the engine's routing ------------------------------------------------------


def test_engine_routes_over_window_to_long_tier(weights, server):
    """A row past the window goes to the tier from ``generate`` and
    ``generate_stream``: its tokens the JAX engine's, its streamed chunks
    those of the JAX engine (the engine's segment) concatenating to the
    non-streamed output; ``batching.long_context`` and the pool's
    ``kv_offload`` report; short rows keep the engine's own path, bitwise
    the solo server."""
    cfg = server.model.cfg
    jax_server = weights[0].make_server(weights[1])
    jeng = JaxBatcher(jax_server, slots=2, segment=8,
                      page_pool=mk_jax_pool(jax_server, extra_pages=8),
                      max_logical_ctx=8 * cfg.max_len,
                      window_bucketing=False)
    eng = ContinuousBatcher(server, slots=2, segment=8,
                            page_pool=mk_pool(server, extra_pages=8),
                            max_logical_ctx=8 * cfg.max_len)
    row = _prompt(3 * cfg.max_len, seed=12)
    out = eng.generate(row, max_new_tokens=12)
    np.testing.assert_array_equal(out, jeng.generate(row,
                                                     max_new_tokens=12))
    chunks = list(eng.generate_stream(row, max_new_tokens=12, segment=4))
    jchunks = list(jeng.generate_stream(row, max_new_tokens=12, segment=4))
    assert [c.shape for c in chunks] == [c.shape for c in jchunks] \
        == [(1, 8), (1, 4)]
    np.testing.assert_array_equal(np.concatenate(chunks, axis=1), out)
    st = eng.stats()
    assert st["long_context"]["max_logical_ctx"] == 8 * cfg.max_len
    assert st["long_context"]["runs"] == 2
    assert "kv_offload" in st["page_pool"]
    assert set(jeng.stats()["long_context"]) <= set(st["long_context"])
    short = row[:24]
    np.testing.assert_array_equal(eng.generate(short, max_new_tokens=8),
                                  server.generate(short, max_new_tokens=8))
    eng.pool.check_invariants()


def test_engine_long_tier_needs_paged_kv(server):
    eng = ContinuousBatcher(server, slots=2, segment=8,
                            max_logical_ctx=1024)
    assert eng.max_logical_ctx == 0  # stood down loudly at boot
    assert "long_context" not in eng.stats()


# -- a partially offloaded row's failover re-ship ------------------------------


def _page_bytes(pool, pids) -> list:
    from lambdipy_tpu_torch.models.llama import arena_page_slices

    with pool.arena_lock:
        blocks = arena_page_slices(pool.ensure_arena(), pids)
    return [b"".join(v.numpy().tobytes() for entry in blk
                     for _, v in sorted(entry.items())) for blk in blocks]


def test_store_failover_import_of_an_offloaded_row(server):
    """The twin of ``test_store_failover_import_of_partially_offloaded_row``:
    a head routed on store A and then spilled whole to A's host arena
    exports from host RAM, and store B (its own pool) imports it and
    hands out pages bitwise A's before the spill."""
    from lambdipy_tpu_torch.runtime.prefixstore import PrefixStore

    cfg = server.model.cfg
    pool_a = mk_pool(server, n_windows=2, extra_pages=4)
    store_a = PrefixStore(server, block=BLOCK, pool=pool_a)
    store_a.attach_offload(toff.OffloadArena(page=pool_a.page,
                                             layers=cfg.layers))
    row = _prompt(65, seed=10)
    m = store_a.route(row)
    pids, _ = store_a.acquire_pages(row[:m])
    before = _page_bytes(pool_a, pids)
    pool_a.release(pids)
    while store_a.reclaim_pages(1):
        pass
    assert store_a.check_invariants()["offloaded_blocks"] == m // BLOCK
    head, blocks = store_a.export_blocks(row)
    assert len(head) == m and len(blocks) == m // BLOCK
    pool_b = mk_pool(server, n_windows=2, extra_pages=4)
    store_b = PrefixStore(server, block=BLOCK, pool=pool_b)
    assert store_b.import_blocks(head, blocks)["inserted"] == m // BLOCK
    pids, got = store_b.acquire_pages(head)
    assert got == m and _page_bytes(pool_b, pids) == before
    pool_b.release(pids)
    assert store_b.check_invariants()["ok"]
    pool_a.check_invariants()
    pool_b.check_invariants()
