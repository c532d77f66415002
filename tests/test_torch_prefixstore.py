"""The port's automatic prefix KV cache (``lambdipy_tpu_torch/runtime/
prefixstore.py``) and the pieces under it, on ``llama-tiny`` (f32, 2
layers) on the CPU, mirroring ``tests/test_prefixstore.py``: the radix
store's counters op for op against the JAX ``PrefixStore`` on the same
route sequence; routed output bitwise the unrouted output, greedy and
seeded, solo, streamed and after reassembly from the tree's blocks;
routed rows through the continuous engine, dense and paged; budget
eviction; the wide-chunk walk; concurrent cold requests collapsing to one
walk; the paged zero-copy hit against the dense assembled hit; the pool's
reclaim through the store; ``_continue_prefill``, the cache-block helpers
and routed ``generate`` against the JAX package on the same weights; and
the handler's default, its ``kv_quant`` opt-in and its stand-down.

Engine rows hold their solo runs' TOKENS exactly and their logprobs
within ``LP_TOL``, as in ``tests/test_torch_continuous.py``: on the CPU a
4-slot decode step's plain matmuls sum a row in another order than a
1-row step's. Paged and dense engines run the same shapes and agree
bitwise, logprobs included; on the card every engine row is bitwise its
solo run (``tests/test_torch_kernels.py``)."""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lambdipy_tpu.models import llama as jl
from lambdipy_tpu.models import registry as jreg
from lambdipy_tpu.runtime.prefixstore import PrefixStore as JaxPrefixStore
from lambdipy_tpu_torch.models import llama as tl
from lambdipy_tpu_torch.models import registry as treg
from lambdipy_tpu_torch.models.params import from_jax_params
from lambdipy_tpu_torch.runtime.handlers import (HandlerContext,
                                                 generate_handler,
                                                 make_engine)
from lambdipy_tpu_torch.runtime.prefixstore import PrefixStore

EXTRA = {"attn_backend": "blocked"}
LP_TOL = 1e-5
# f32 end to end: the frameworks sum matmuls and softmaxes in other orders
# (tests/test_torch_llama.py)
LOGIT_TOL = 1e-4
SEEDED = {"temperature": 0.9, "seed": 7, "top_k": 5, "top_p": 0.95}
KNOBS = pytest.mark.parametrize("knobs", [{}, SEEDED],
                                ids=["greedy", "seeded"])
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
def jax_server(weights):
    return weights[0].make_server(weights[1])


@pytest.fixture
def server(weights):
    return treg.get("llama-tiny").build(extra=EXTRA).make_server(
        weights[2], device="cpu")


def _engine_and_store(server, kind, budget_mb=8.0, **extra):
    engine = make_engine(server, {**ENGINES[kind], **extra})
    store = PrefixStore(server, block=16, budget_mb=budget_mb,
                        pool=engine.pool)
    if engine.pool is not None:
        engine.prefix_pages_fn = store.acquire_pages
    return engine, store


def _routed(store, generate, row, **kw):
    m = store.route(row)
    if m > 0:
        return generate(row[m:], prefix=row[:m], **kw)
    return generate(row, **kw)


def test_radix_counters_match_the_jax_store_op_for_op(jax_server, server):
    """The JAX store's counter test, route for route through both stores
    on the same weights: the same matched lengths, hits, misses, hit
    tokens, blocks and bytes after every route, and the same host-only
    matches."""
    jstore = JaxPrefixStore(jax_server, block=16, budget_mb=8)
    tstore = PrefixStore(server, block=16, budget_mb=8)
    row = list(range(1, 41)) + [7, 8, 9]  # 43 tokens -> 32 cacheable
    ops = [(row, 32, (1, 0, 0, 2)),
           (row[:32] + [5, 5, 5, 5, 5], 32, (1, 1, 32, 2)),
           (row[:43] + list(range(50, 60)), 48, (1, 2, 64, 3)),
           ([1, 2, 3], 0, (1, 2, 64, 3)),
           (list(range(1, 300)), 0, (1, 2, 64, 3))]  # past max_len
    keys = ("misses", "hits", "hit_tokens", "blocks", "bytes", "evictions",
            "hit_rate", "assemblies")
    for tokens, want, counts in ops:
        assert tstore.route(tokens) == jstore.route(tokens) == want
        ts, js = tstore.stats(), jstore.stats()
        assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}
        assert (ts["misses"], ts["hits"], ts["hit_tokens"],
                ts["blocks"]) == counts
    for tokens in (ops[2][0], [9, 9], row):
        assert tstore.match_len(tokens) == jstore.match_len(tokens)
        assert tstore.present_len(tokens) == jstore.present_len(tokens)
    assert tstore.check_invariants()["ok"]


@KNOBS
def test_routed_generate_is_unrouted_bitwise(server, knobs):
    """Routed output is bitwise the unrouted output (tokens and
    logprobs), solo and streamed, and again after the registered
    full-window entry is dropped and reassembled from the tree's block
    slices."""
    store = PrefixStore(server, block=16, budget_mb=8)
    row = list(range(3, 45))  # 42 tokens -> 32 cacheable
    off = server.generate(row, max_new_tokens=8, return_logprobs=True,
                          **knobs)
    m = store.route(row)
    assert m == 32
    on = server.generate(row[m:], prefix=row[:m], max_new_tokens=8,
                         return_logprobs=True, **knobs)
    np.testing.assert_array_equal(on[0], off[0])
    np.testing.assert_array_equal(on[1], off[1])
    chunks = list(server.generate_stream(row[m:], prefix=row[:m],
                                         max_new_tokens=8, segment=3,
                                         return_logprobs=True, **knobs))
    np.testing.assert_array_equal(np.concatenate([c[0] for c in chunks], 1),
                                  off[0])
    np.testing.assert_array_equal(np.concatenate([c[1] for c in chunks], 1),
                                  off[1])
    with server._prefix_lock:
        server._prefixes.clear()
    assert store.route(row) == 32
    assert store.stats()["assemblies"] == 1
    again = server.generate(row[m:], prefix=row[:m], max_new_tokens=8,
                            return_logprobs=True, **knobs)
    np.testing.assert_array_equal(again[0], off[0])
    np.testing.assert_array_equal(again[1], off[1])


def test_prefix_entry_is_never_written(server):
    """A continuation copies the prefix entry's positions into the decode
    step's own cache: the shared entry keeps its bits after requests from
    it, as the JAX ext program's copy-before-donate keeps them."""
    prefix = list(range(2, 34))
    key = server.cache_prefix(prefix)
    cache, plen = server.get_prefix(key)
    before = tl.copy_cache(cache)
    for suffix in ([5, 6, 7], list(range(40, 60))):
        server.generate(suffix, prefix=prefix, max_new_tokens=6)
    for a, b in zip(before, server.get_prefix(key)[0]):
        for name in ("k", "v"):
            assert torch.equal(a[name], b[name])
    assert plen == 32


@pytest.mark.parametrize("kind", ENGINES)
def test_engine_rows_match_their_solo_routed_runs(server, kind):
    """Routed requests join the continuous engine beside unrouted
    traffic, greedy and seeded, cold and hot: every row's tokens are its
    solo routed run's and its unrouted run's (logprobs within
    ``LP_TOL``), and the engine counts its prefix joins."""
    engine, store = _engine_and_store(server, kind)
    shared = list(range(1, 34))  # 33 tokens of shared head
    reqs = [(shared + [40, 41], {}),
            (shared + [50, 51, 52], {"temperature": 0.9, "seed": 7}),
            ([9, 8, 7], {}),  # an unrouted neighbour
            (shared + [60], {"temperature": 1.2, "top_k": 3, "seed": 3})]
    solo = [server.generate(r, max_new_tokens=8, return_logprobs=True, **kw)
            for r, kw in reqs]
    store.route(reqs[0][0])  # seed the tree: the burst then hits

    def run(i):
        row, kw = reqs[i]
        return _routed(store, engine.generate, row, max_new_tokens=8,
                       return_logprobs=True, **kw)

    with ThreadPoolExecutor(max_workers=4) as ex:
        outs = list(ex.map(run, range(4)))
    for (row, kw), got, want in zip(reqs, outs, solo):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=LP_TOL)
        m = store.match_len(row)
        if m:
            routed = server.generate(row[m:], prefix=row[:m],
                                     max_new_tokens=8, return_logprobs=True,
                                     **kw)
            np.testing.assert_array_equal(got[0], routed[0])
            np.testing.assert_allclose(got[1], routed[1], rtol=0,
                                       atol=LP_TOL)
    assert engine.stats()["prefix_joins"] == 3
    assert store.stats()["hits"] >= 3
    if engine.pool is not None:
        engine.pool.check_invariants()
        assert engine.pool.stats()["pages_live"] == store.stats()["blocks"]
        assert store.check_invariants()["ok"]


def test_engine_streams_a_routed_row(server):
    """A routed row streamed through the paged engine concatenates to its
    unrouted output."""
    engine, store = _engine_and_store(server, "paged")
    row = list(range(2, 40))
    off = server.generate(row, max_new_tokens=11)
    m = store.route(row)
    chunks = list(engine.generate_stream(row[m:], prefix=row[:m],
                                         max_new_tokens=11))
    np.testing.assert_array_equal(np.concatenate(chunks, axis=1), off)
    assert engine.stats()["prefix_joins"] == 1


def test_paged_zero_copy_hit_is_bitwise_the_dense_assembled_hit(server):
    """The same routed traffic through a paged engine sharing its arena
    with the store and through a dense engine whose store assembles its
    hits: tokens and logprobs bitwise equal; the paged store assembles
    nothing, and its hits share the store's pages by refcount."""
    row = list(range(7, 60))  # 53 tokens -> 48 cacheable
    suffixes = [[3, 4], list(range(70, 79)), [5]]
    outs = {}
    for kind in ("dense", "paged"):
        engine, store = _engine_and_store(server, kind)
        store.route(row)  # cold walk
        if kind == "dense":
            with server._prefix_lock:
                server._prefixes.clear()  # the hits must assemble
        got = []
        for i, tail in enumerate(suffixes):
            kw = {"temperature": 0.8, "seed": i} if i % 2 else {}
            got.append(_routed(store, engine.generate, row[:48] + tail,
                               max_new_tokens=7, return_logprobs=True,
                               **kw))
        stats = store.stats()
        if kind == "paged":
            assert stats["assembly_bytes_peak"] == 0
            assert stats["assemblies"] == 0
            assert engine.pool.stats()["shares"] == 3 * 3
        else:
            assert stats["assembly_bytes_peak"] > 0
        assert stats["hits"] == 3 and engine.stats()["prefix_joins"] == 3
        outs[kind] = got
    for d, p in zip(outs["dense"], outs["paged"]):
        np.testing.assert_array_equal(d[0], p[0])
        np.testing.assert_array_equal(d[1], p[1])


def test_budget_evicts_lru_leaf_blocks(server):
    """Inserts beyond the budget evict least-recently-used leaf blocks;
    bytes stay within the budget and the tree still serves correct
    (shorter) matches."""
    store = PrefixStore(server, block=16, budget_mb=8)
    store.route(list(range(1, 20)))  # one block
    per_block = store.stats()["bytes"]
    small = PrefixStore(server, block=16,
                        budget_mb=1.5 * per_block / 2**20)
    row = list(range(1, 40))
    small.route(row)  # two blocks, evicted down to one
    st = small.stats()
    assert st["evictions"] == 1 and st["blocks"] == 1
    assert st["bytes"] <= small.budget_bytes
    assert small.check_invariants()["ok"]
    off = server.generate(row, max_new_tokens=8)
    on = _routed(small, server.generate, row, max_new_tokens=8)
    np.testing.assert_array_equal(on, off)


def test_wide_chunk_walk_matches_block_walk(server):
    """A cold walk in 32-token chunks with a 16-token tail gives the
    unrouted output, the stored blocks of a walk in 16-token chunks, and
    fewer dispatches."""
    row = list(range(1, 92))  # 91 tokens -> target 80: 32 x 2 + 16
    off = server.generate(row, max_new_tokens=8, return_logprobs=True)
    stores = {}
    for width in (32, 16):
        store = PrefixStore(server, block=16, budget_mb=8)
        store.walk_chunk = width
        with server._prefix_lock:
            server._prefixes.clear()
        on = _routed(store, server.generate, row, max_new_tokens=8,
                     return_logprobs=True)
        np.testing.assert_array_equal(on[0], off[0])
        np.testing.assert_array_equal(on[1], off[1])
        st = store.stats()
        assert st["blocks"] == 5 and st["assembled_entries"] >= 1
        assert st["assembled_bytes"] > 0
        stores[width] = store
    assert stores[32].stats()["prefill"]["rounds"] == 3
    assert stores[16].stats()["prefill"]["rounds"] == 5

    def blocks(store):
        node, out = store._root, []
        while node.children:
            (node,) = node.children.values()
            out.append(node.kv)
        return out

    for wide, narrow in zip(blocks(stores[32]), blocks(stores[16])):
        for lw, ln in zip(wide, narrow):
            for name in ("k", "v"):
                torch.testing.assert_close(lw[name], ln[name], rtol=0,
                                           atol=1e-6)


def test_concurrent_cold_requests_collapse_to_one_walk(server):
    """Four first requests for one prefix run one walk, and all match."""
    store = PrefixStore(server, block=16, budget_mb=8)
    row = list(range(5, 60))  # 55 tokens -> 48 cacheable
    with ThreadPoolExecutor(max_workers=4) as ex:
        ms = list(ex.map(lambda _: store.route(list(row)), range(4)))
    assert ms == [48] * 4
    st = store.stats()
    assert st["blocks"] == 3 and st["prefill"]["walks"] == 1


def test_pool_reclaim_releases_cold_store_pages(server):
    """An admission short of pages first releases the store's cold,
    unshared leaf pages (the pool's reclaim hook) instead of shedding."""
    engine, store = _engine_and_store(server, "paged", kv_pages="9")
    pool = engine.pool  # 8 pages of 16 positions
    head = list(range(3, 44))  # 41 tokens -> 2 pages in the store
    assert store.route(head) == 32
    assert pool.stats()["pages_live"] == 2
    row = list(range(100, 190))  # 90 + 22 new = 7 pages, 6 free
    want = server.generate(row, max_new_tokens=22)
    got = engine.generate(row, max_new_tokens=22)
    np.testing.assert_array_equal(got, want)
    st = store.stats()
    assert st["evictions"] == 1 and st["blocks"] == 1
    assert pool.stats()["sheds"] == 0
    pool.check_invariants()
    assert store.check_invariants()["ok"]
    # the row returns its pages at the barrier after its last block, which
    # may come after its waiter has its tokens
    with engine._lock:
        assert engine._lock.wait_for(lambda: not engine._engine_running,
                                     timeout=30)
    assert pool.stats()["pages_live"] == 1


def test_cache_block_helpers_are_the_jax_helpers(server):
    """``slice_cache_blocks`` / ``concat_cache_blocks`` round-trip a
    prefix entry bitwise and move the same numbers as the JAX helpers;
    ``copy_cache`` gives fresh buffers."""
    cache, plen = server.get_prefix(server.cache_prefix(list(range(1, 40))))
    cfg = server.model.cfg
    blocks = [tl.slice_cache_blocks(cache, p, 16) for p in (0, 16)]
    back = tl.concat_cache_blocks(cfg, blocks, cfg.max_len)
    jcache = [{k: jnp.asarray(v.numpy()) for k, v in tl._leaves(e).items()}
              for e in cache]
    jblocks = [jl.slice_cache_blocks(jcache, p, 16) for p in (0, 16)]
    jback = jl.concat_cache_blocks(_jax_cfg(), jblocks, cfg.max_len)
    for e, b, jb, je in zip(cache, back, jback, jcache):
        assert b["index"] == 32 and int(jb["index"]) == 32
        for name in ("k", "v"):
            np.testing.assert_array_equal(b[name][:, :32].numpy(),
                                          e[name][:, :32].numpy())
            np.testing.assert_array_equal(b[name][:, 32:].numpy(), 0)
            np.testing.assert_array_equal(b[name].numpy(),
                                          np.asarray(jb[name]))
    copy = tl.copy_cache(cache)
    copy[0]["k"].add_(1.0)
    assert not torch.equal(copy[0]["k"], cache[0]["k"])
    assert plen == 39


def _jax_cfg():
    return jreg.get("llama-tiny").build(extra=EXTRA).config


def test_continue_prefill_matches_jax(weights, jax_server, server):
    """``_continue_prefill`` from the same prefix K/V (the port's entry,
    carried to JAX as numpy): the same first token, logprob and index,
    and the suffix K/V within the frameworks' tolerance; routed
    ``generate`` emits JAX's routed greedy tokens."""
    adapter, params, _ = weights
    prefix, suffix = list(range(1, 33)), [40, 41, 42, 43, 44]
    cache, plen = server.get_prefix(server.cache_prefix(prefix))
    sbs = 16
    pad = np.zeros((1, sbs), np.int32)
    pad[0, :len(suffix)] = suffix
    with torch.inference_mode():
        first, lp0, tcache, start, done = tl._continue_prefill(
            server.model, tl.copy_cache(cache), torch.as_tensor(pad).long(),
            len(suffix),
            lambda lg, gens: tl.select_tokens(
                lg, torch.zeros(1), torch.zeros(1, dtype=torch.long),
                torch.ones(1), gens, False),
            [None], torch.tensor([-1]), sbs)
    jcache = [{**{k: jnp.asarray(v.numpy())
                  for k, v in tl._leaves(e).items()},
               "index": jnp.int32(plen)} for e in cache]
    jsel = jl._serve_select(jnp.zeros(1, jnp.float32),
                            jnp.zeros(1, jnp.int32), jnp.ones(1))
    jfirst, jlp0, jnew, jstart, _, _ = jl._continue_prefill(
        adapter.module, params, jcache, jnp.asarray(pad), jnp.int32(5),
        jsel, jax.random.split(jax.random.PRNGKey(0), 1), jnp.int32(-1),
        sbs)
    assert int(first[0]) == int(jfirst[0]) and not bool(done[0])
    assert int(start[0]) == int(jstart[0]) == plen + len(suffix)
    np.testing.assert_allclose(float(lp0[0]), float(jlp0[0]), atol=LOGIT_TOL)
    for te, je in zip(tcache, jnew):
        for name in ("k", "v"):
            np.testing.assert_allclose(
                te[name][:, :plen + len(suffix)].numpy(),
                np.asarray(je[name])[:, :plen + len(suffix)], rtol=0,
                atol=LOGIT_TOL)
    want = jax_server.generate(suffix, prefix=prefix, max_new_tokens=10)
    got = server.generate(suffix, prefix=prefix, max_new_tokens=10)
    np.testing.assert_array_equal(got, np.asarray(want))


def _handler(weights, **extra):
    return generate_handler(
        {"model": "llama-tiny", "dtype": "float32",
         "extra": {**EXTRA, "warm_group_prefill": "0", **extra}},
        HandlerContext(device="cpu", state_dict=weights[2]))


@pytest.mark.parametrize("engine", [{}, {"batch_mode": "continuous",
                                         **ENGINES["paged"]}],
                         ids=["server", "paged-engine"])
def test_handler_routes_by_default(weights, engine):
    """The generate handler builds a 512 MB store by default and routes
    single-row requests through it: the response says so, the counters
    move, and the tokens are the unrouted multi-row request's; an
    explicit ``prefix`` keeps the client's split."""
    state = _handler(weights, **engine)
    assert state.meta["prefix_cache"]
    assert state.prefix_store.budget_bytes == 512 << 20
    row = list(range(1, 44))
    ref = state.invoke({"tokens": [row, row], "max_new_tokens": 8})
    first = state.invoke({"tokens": row, "max_new_tokens": 8})
    second = state.invoke({"tokens": row, "max_new_tokens": 8,
                           "stream": False})
    explicit = state.invoke({"tokens": row[20:], "prefix": row[:20],
                             "max_new_tokens": 8})
    for out in (first, second, explicit):
        assert out["ok"] and out["prefix_cached"]
        assert out["tokens"][0] == ref["tokens"][0]
        assert out["n_prompt"] == len(row)
    records = list(state.invoke_stream({"tokens": row, "max_new_tokens": 8}))
    assert records[-1]["prefix_cached"] and records[-1]["done"]
    assert [t for r in records[:-1] for t in r["tokens"][0]] \
        == ref["tokens"][0]
    pc = state.stats()["prefix_cache"]
    assert (pc["misses"], pc["hits"], pc["hit_tokens"]) == (1, 2, 64)
    assert pc["blocks"] == 32 // state.prefix_store.block
    assert pc["bytes"] > 0
    if engine:
        # the explicit 20-token prefix is no page-aligned head the store
        # holds: that row runs solo
        assert state.stats()["batching"]["prefix_joins"] == 3
        assert pc["assembly_bytes_peak"] == 0


def test_handler_store_opt_in_under_kv_quant_and_stand_down(weights):
    """Under ``kv_quant`` the store is built only when ``prefix_cache_mb``
    is set (routed rows then attend the quantized prefix); an engine
    narrower than the window builds none; ``prefix_cache_mb=0`` turns it
    off; a request that carries a session pins its routed head."""
    assert not _handler(weights, kv_quant="int8").meta["prefix_cache"]
    state = _handler(weights, kv_quant="int8", prefix_cache_mb="8")
    assert state.meta["prefix_cache"]
    row = list(range(1, 44))
    ref = state.invoke({"tokens": [row, row], "max_new_tokens": 8,
                        "logprobs": True})
    out = state.invoke({"tokens": row, "max_new_tokens": 8,
                        "logprobs": True})
    assert out["prefix_cached"] and out["tokens"][0] == ref["tokens"][0]
    np.testing.assert_allclose(out["logprobs"][0], ref["logprobs"][0],
                               rtol=0, atol=0.05)
    capped = _handler(weights, batch_mode="continuous", batch_cache_len="64",
                      **ENGINES["paged"])
    assert not capped.meta["prefix_cache"] and capped.prefix_store is None
    assert not _handler(weights, prefix_cache_mb="0").meta["prefix_cache"]
    out = state.invoke({"tokens": row, "max_new_tokens": 8,
                        "session_id": "chat-1"})
    assert out["prefix_cached"] and out["tokens"][0] == ref["tokens"][0]
    pc = state.stats()["prefix_cache"]
    assert pc["sessions_active"] == 1 and pc["pinned_leaves"] == 1


def test_store_fails_open(server, monkeypatch):
    """A store failure logs and routes nothing: the request serves
    unrouted."""
    store = PrefixStore(server, block=16, budget_mb=8)

    def boom(*_a, **_k):
        raise RuntimeError("walk failed")

    monkeypatch.setattr(store, "_walk", boom)
    assert store.route(list(range(1, 40))) == 0
    assert store.stats()["misses"] == 1 and store.stats()["blocks"] == 0


def test_chunk_write_past_the_window_raises(server):
    """A chunk that would cross the cache's width raises (the JAX write
    clamps it back onto real K/V); the store's target clamp keeps walks
    inside the window."""
    cfg = server.model.cfg
    cache = tl.init_decode_cache(cfg, 1, 32, "cpu")
    cache = [{**tl._leaves(e), "index": 24} for e in cache]
    with torch.inference_mode(), pytest.raises(ValueError, match="crosses"):
        server.model(torch.zeros(1, 16, dtype=torch.long),
                     positions=torch.arange(24, 40)[None], cache=cache)
    store = PrefixStore(server, block=16, budget_mb=8)
    assert store.route(list(range(1, 129))) == cfg.max_len - 16
