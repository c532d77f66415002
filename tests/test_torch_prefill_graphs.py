"""Compiled prefill (``models/llama.py PrefillProgram``, ``WindowEntry``,
``models/graphs.py GraphProgram``) on ``llama-tiny`` (f32, 2 layers) on
the CPU.

The card captures every prefill as a CUDA graph; here the stand-in graph
type ``FakeGraph`` (``tests/test_torch_graphs.py``) takes its place: its
capture records the program's closure without running it and its replay
runs that closure again. So a program that reads anything but its own
buffers (a request's prompt, a host index, a generator it was not given)
answers the second request with the first one's data, and a program
whose outputs a caller keeps past the next run sees them overwritten:
each test runs at least two requests through one program and holds every
path bitwise (tokens, logprobs, K/V) against the same path run eagerly
(``graphs=False``), greedy and seeded. Across the frameworks the
device-index chunk is held against the JAX ``_prefix_ext_fn`` within
``KV_TOL`` (f32 end to end, the frameworks sum in other orders)."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lambdipy_tpu.models import registry as jreg
from lambdipy_tpu_torch.models import graphs
from lambdipy_tpu_torch.models import llama as tl
from lambdipy_tpu_torch.models import registry as treg
from lambdipy_tpu_torch.models.params import from_jax_params
from lambdipy_tpu_torch.ops import quant as tq
from lambdipy_tpu_torch.runtime import continuous
from lambdipy_tpu_torch.runtime.faults import FaultPlan
from lambdipy_tpu_torch.runtime.handlers import (HandlerContext,
                                                 generate_handler,
                                                 make_engine)
from lambdipy_tpu_torch.runtime.prefixstore import PrefixStore
from tests.test_torch_graphs import FAKE_LAUNCHES, FakeGraph, NoDrawsGraph

EXTRA = {"attn_backend": "blocked"}
SEEDED = {"temperature": 0.9, "top_k": 40, "top_p": 0.9, "seed": 5}
KNOBS = pytest.mark.parametrize("knobs", [{}, SEEDED],
                                ids=["greedy", "seeded"])
KV = pytest.mark.parametrize("kv_quant", [None, "int8"],
                             ids=["float", "int8kv"])
KV_TOL = 1e-4
LP_TOL = 1e-5
CK = 16
ENGINES = {"dense": {"batch_max": "2", "batch_segment": "4"},
           "paged": {"batch_max": "2", "batch_segment": "4",
                     "kv_paged": "1", "prefix_block": "16"}}


@pytest.fixture(scope="module")
def weights():
    adapter = jreg.get("llama-tiny").build(extra=EXTRA)
    params = adapter.init_params(seed=0)
    return adapter, params, from_jax_params(
        jax.tree_util.tree_map(np.asarray, params))


def _server(weights, graph_type, kv_quant=None, **kw):
    extra = {**EXTRA, **({"kv_quant": kv_quant} if kv_quant else {})}
    return treg.get("llama-tiny").build(extra=extra).make_server(
        weights[2], device="cpu", graphs=graph_type, **kw)


def _twins(weights, **kw):
    """A stand-in graph server and an eager one on the same weights."""
    return _server(weights, FakeGraph, **kw), _server(weights, False, **kw)


def _prompt(seed: int, n: int) -> list:
    return [(seed * 37 + 11 * j) % 500 + 1 for j in range(n)]


def _equal(got, want) -> None:
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# ------------------------------------------------ 1. the device index


def _slice_chunk_attend(self, q, k, v, cache):
    """The chunk branch as it was with a host ``int`` index: a slice write
    and a mask built from the integer, operation for operation."""
    cfg = self.cfg
    b, s = q.shape[:2]
    idx = int(cache["index"])
    t = tl.cache_width([cache])
    new_cache = {}
    for name, val in tl._kv_store(cfg, k, v).items():
        cache[name][:, idx:idx + s] = val
        new_cache[name] = cache[name]
    new_cache["index"] = idx
    if cfg.kv_quant == "int8":
        ck, cv = new_cache["k_int8"], new_cache["v_int8"]
        scales = {"k_scale": new_cache["k_scale"],
                  "v_scale": new_cache["v_scale"]}
    else:
        ck, cv, scales = new_cache["k"], new_cache["v"], {}
    if cfg.attn_backend == "blocked" and s == 1:
        active = torch.full((b,), idx + 1, dtype=torch.int32)
        return tl.blocked_decode_attention(q, ck, cv, active,
                                           **scales), new_cache
    if scales:
        ck = tl._kv_dequantize(ck, scales["k_scale"], cfg.dtype)
        cv = tl._kv_dequantize(cv, scales["v_scale"], cfg.dtype)
    keys = torch.arange(t)
    queries = idx + torch.arange(s)
    valid = (keys[None, None, :] <= queries[None, :, None]).expand(b, s, t)
    return tl._attend(q, ck, cv, valid), new_cache


@KV
@pytest.mark.parametrize("s", [1, 16])
def test_device_index_chunk_is_bitwise_the_int_chunk(weights, monkeypatch,
                                                     kv_quant, s):
    """A chunk at a 0-dim device index writes the K/V and gives the logits
    of the same chunk at an ``int`` index, and both are bitwise the slice
    write and integer mask the chunk branch had (one token under
    ``blocked`` takes the decode kernel's path)."""
    server = _server(weights, False, kv_quant)
    model = server.model
    cache, plen = server.get_prefix(server.cache_prefix(_prompt(1, 40)))
    chunk = torch.as_tensor([_prompt(2, s)])
    positions = (plen + torch.arange(s))[None]
    outs = {}
    for kind in ("tensor", "int", "slice"):
        if kind == "slice":
            monkeypatch.setattr(tl.LlamaBlock, "_chunk_attend",
                                _slice_chunk_attend)
        work = tl.copy_cache(cache)
        index = torch.tensor(plen) if kind == "tensor" else plen
        with torch.inference_mode():
            logits, _ = model(
                chunk, positions=positions,
                cache=[{**tl._leaves(e), "index": index} for e in work],
                logit_positions=torch.full((1,), s - 1))
        outs[kind] = (logits, work)
    for kind in ("int", "slice"):
        torch.testing.assert_close(outs[kind][0], outs["tensor"][0],
                                   rtol=0, atol=0)
        for a, b in zip(outs[kind][1], outs["tensor"][1]):
            for name, val in tl._leaves(a).items():
                assert torch.equal(val, b[name]), name


def test_device_index_chunk_matches_jax_prefix_ext(weights):
    """The walk's extension at a device index (a window's ``extend``
    program) against the JAX ``_prefix_ext_fn`` on the same prefix K/V:
    the same index, K/V within ``KV_TOL`` over the written positions."""
    adapter, params, _ = weights
    server = _server(weights, FakeGraph)
    jax_server = adapter.make_server(params)
    cache, plen = server.get_prefix(server.cache_prefix(_prompt(3, 32)))
    chunk = np.asarray([_prompt(4, CK)])
    window = server._checkout_window(tl.cache_width(cache))
    with torch.inference_mode():
        window.load(cache, plen)
    for n in (CK, 9):  # a full chunk, then a ragged one
        server._prefix_ext_fn(CK)(window, chunk, n)
    jcache = [{**{k: jnp.asarray(v.numpy())
                  for k, v in tl._leaves(e).items()},
               "index": jnp.int32(plen)} for e in cache]
    ext = jax_server._prefix_ext_fn(CK)
    for n in (CK, 9):
        jcache = ext(params, jcache, jnp.asarray(chunk, jnp.int32),
                     jnp.int32(n))
    assert window.index == int(jcache[0]["index"]) == plen + CK + 9
    for te, je in zip(window.cache, jcache):
        for name in ("k", "v"):
            np.testing.assert_allclose(
                te[name][:, :window.index].numpy(),
                np.asarray(je[name])[:, :window.index], rtol=0,
                atol=KV_TOL)


# ------------------------------------------------ 3.-4. the server's paths


@KV
@KNOBS
def test_generate_and_stream_prefills_are_bitwise_eager(weights, kv_quant,
                                                        knobs):
    """``generate`` and ``generate_stream``, two requests of one bucket
    through one prefill program each: tokens and logprobs bitwise the
    eager server's; every prefill a replay, none eager."""
    graph, eager = _twins(weights, kv_quant=kv_quant)
    for rows in ([_prompt(5, 27), _prompt(6, 9)], [_prompt(7, 20), [5]]):
        want = eager.generate(rows, max_new_tokens=6, return_logprobs=True,
                              **knobs)
        _equal(graph.generate(rows, max_new_tokens=6, return_logprobs=True,
                              **knobs), want)
        chunks = list(graph.generate_stream(rows, max_new_tokens=6,
                                            segment=4, return_logprobs=True,
                                            **knobs))
        _equal([np.concatenate([c[0] for c in chunks], 1),
                np.concatenate([c[1] for c in chunks], 1)], want)
    stats = graph.program_stats()
    assert stats["prefill_replays"] == 4 and stats["eager_prefills"] == 0
    assert eager.program_stats()["eager_prefills"] == 2
    # one prefill program (the bucket's) beside one decode program
    assert stats["compile_count"] == 2


@KV
@KNOBS
def test_prefix_continuations_are_bitwise_eager(weights, kv_quant, knobs):
    """``prefix=``, solo and streamed, two suffixes of one bucket through
    the entry's continuation program: bitwise the eager server's, the
    prefix's own prefill included (a window's first chunk)."""
    graph, eager = _twins(weights, kv_quant=kv_quant)
    prefix = _prompt(8, 40)
    for suffix in (_prompt(9, 5), _prompt(10, 12)):
        want = eager.generate(suffix, prefix=prefix, max_new_tokens=6,
                              return_logprobs=True, **knobs)
        _equal(graph.generate(suffix, prefix=prefix, max_new_tokens=6,
                              return_logprobs=True, **knobs), want)
        chunks = list(graph.generate_stream(
            suffix, prefix=prefix, max_new_tokens=6, segment=4,
            return_logprobs=True, **knobs))
        _equal([np.concatenate([c[0] for c in chunks], 1),
                np.concatenate([c[1] for c in chunks], 1)], want)
    for a, b in zip(graph.get_prefix(graph.cache_prefix(prefix))[0],
                    eager.get_prefix(eager.cache_prefix(prefix))[0]):
        for name, val in tl._leaves(a).items():
            assert torch.equal(val, b[name])
    stats = graph.program_stats()
    # the prefix's first chunk once, four continuations
    assert stats["prefill_replays"] == 5 and stats["eager_prefills"] == 0


def test_chunked_prefix_walk_is_bitwise_eager(weights):
    """A prefix past ``prefill_chunk`` walks in a window of chunk
    programs (full chunks and a ragged last one): the registered cache
    and the continuation bitwise the eager walk's."""
    graph, eager = _twins(weights, prefill_chunk=CK)
    for prefix in (_prompt(11, 70), _prompt(12, 70)):
        want = eager.generate([4, 5], prefix=prefix, max_new_tokens=4,
                              return_logprobs=True, **SEEDED)
        _equal(graph.generate([4, 5], prefix=prefix, max_new_tokens=4,
                              return_logprobs=True, **SEEDED), want)
        for a, b in zip(graph.get_prefix(graph.cache_prefix(prefix))[0],
                        eager.get_prefix(eager.cache_prefix(prefix))[0]):
            assert a["index"] == b["index"] == 70
            for name, val in tl._leaves(a).items():
                assert torch.equal(val, b[name])
    # 5 chunks a walk (4 full, 1 ragged) and a continuation, twice
    assert graph.program_stats()["prefill_replays"] == 12


def test_interleaved_walks_get_their_own_windows(weights, monkeypatch):
    """Two chunked walks of different rows, advanced chunk by chunk in
    turns (each thread waits for the other before its next chunk): each
    checked out a window of its own, and each cache is bitwise its eager
    walk alone."""
    graph, eager = _twins(weights, prefill_chunk=CK)
    rows = [_prompt(13, 64), _prompt(14, 64)]
    turn = threading.Barrier(2, timeout=30)
    real_ext = graph._prefix_ext_fn

    def in_turns(sbs):
        ext = real_ext(sbs)

        def step(*args):
            turn.wait()
            return ext(*args)

        return step

    monkeypatch.setattr(graph, "_prefix_ext_fn", in_turns)
    got = [None, None]

    def walk(i):
        got[i] = graph._chunked_prefill_cache(rows[i], 64, 128)

    threads = [threading.Thread(target=walk, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    windows = [k for k in graph.program_stats()["program_pools"]
               if k[0] == "window"]
    assert len({tuple(k[:5]) for k in windows}) == 1 and len(windows) == 2
    for row, cache in zip(rows, got):
        want = eager._chunked_prefill_cache(row, 64, 128)
        for a, b in zip(cache, want):
            assert a["index"] == b["index"] == 64
            for name, val in tl._leaves(a).items():
                assert torch.equal(val, b[name])


# ------------------------------------------------ 5.-6. the engine


def _engine_twins(weights, kind, monkeypatch, **server_kw):
    monkeypatch.setattr(continuous, "GROUP_PREFILL_MAX", 8)
    out = {}
    for name, graph_type in (("graph", FakeGraph), ("eager", False)):
        server = _server(weights, graph_type, **server_kw)
        engine = make_engine(server, ENGINES[kind])
        store = PrefixStore(server, block=16, budget_mb=8.0,
                            pool=engine.pool)
        if engine.pool is not None:
            engine.prefix_pages_fn = store.acquire_pages
        out[name] = (server, engine, store)
    return out


def _engine_requests(store, engine, requests):
    """Requests one at a time (each row alone in the engine), prefix rows
    routed through the store."""
    outs = []
    for row, prefix, knobs in requests:
        if prefix:
            m = store.route(row)
            assert m > 0
            outs.append(engine.generate(row[m:], prefix=row[:m],
                                        max_new_tokens=5,
                                        return_logprobs=True, **knobs))
        else:
            outs.append(engine.generate(row, max_new_tokens=5,
                                        return_logprobs=True, **knobs))
    return outs


@pytest.mark.parametrize("kind", ENGINES)
@KNOBS
def test_engine_prefills_are_bitwise_eager(weights, monkeypatch, kind,
                                           knobs):
    """Through one engine, one request at a time: short rows (the group
    prefill), long rows (alone, on their request thread), chunked rows
    (a window's chunks and tail), a cold and a hot prefix row (the
    store's walk, then the dense prefix row or the paged continuation),
    two of each shape: every row bitwise the eager engine's, every
    prefill a replay, and the kernels' counters the replays' (each adds
    what its capture counted)."""
    requests = [(_prompt(20, 5), False, knobs), (_prompt(21, 7), False, {}),
                (_prompt(22, 20), False, knobs), (_prompt(23, 24), False, {}),
                (_prompt(24, 40), True, knobs), (_prompt(24, 40), True, {}),
                (_prompt(25, 33), False, knobs),
                (_prompt(26, 35), False, {})]
    twins = _engine_twins(weights, kind, monkeypatch, prefill_chunk=32)
    before = tq.int8_matmul.launches
    got = _engine_requests(*twins["graph"][2:0:-1], requests)
    launched = tq.int8_matmul.launches - before
    want = _engine_requests(*twins["eager"][2:0:-1], requests)
    for g, w in zip(got, want):
        _equal(g, w)
    server, engine, store = twins["graph"]
    stats, sstats = engine.stats(), server.program_stats()
    assert stats["eager_prefills"] == 0 and sstats["eager_prefills"] == 0
    assert stats["prefill_chunks"] == 2  # the 33- and 35-token rows
    # the engine's prefills and the store's walks (on the server's stats)
    assert stats["prefill_replays"] > 0 and sstats["prefill_replays"] > 0
    assert launched == FAKE_LAUNCHES * (
        stats["replays"] + stats["prefill_replays"] + sstats["replays"]
        + sstats["prefill_replays"])
    eager_stats = twins["eager"][1].stats()
    assert eager_stats["eager_prefills"] == stats["prefill_replays"]


@pytest.mark.parametrize("kind", ENGINES)
def test_two_long_rows_of_one_bucket_prefill_before_a_barrier(
        weights, monkeypatch, kind):
    """Two long rows of one bucket prefill back to back on their request
    threads through the same program before the engine packs either: the
    first row's prefill was copied out of the program, so the second run
    does not overwrite it. Both rows are bitwise the eager engine's and
    hold their solo runs."""
    twins = _engine_twins(weights, kind, monkeypatch)
    rows = [_prompt(30, 20), _prompt(31, 27)]  # both in the 32 bucket
    server, engine, _ = twins["graph"]
    queued = []
    real_enqueue = engine._enqueue
    monkeypatch.setattr(engine, "_enqueue", queued.append)
    entries = [engine._admit(row, 6, 0.0, None, None, 0, None, True)
               for row in rows]
    assert queued == entries and all(e["prefill"] is not None
                                     for e in entries)
    for entry in entries:
        real_enqueue(entry)
    with engine._lock:
        assert engine._lock.wait_for(
            lambda: all(e["done"] for e in entries), timeout=60)
    # the eager engine, the same two rows admitted the same way
    eager = twins["eager"][1]
    eager._enqueue = queued.append
    want = [eager._admit(row, 6, 0.0, None, None, 0, None, True)
            for row in rows]
    del eager._enqueue
    for entry in want:
        eager._enqueue(entry)
    with eager._lock:
        assert eager._lock.wait_for(lambda: all(e["done"] for e in want),
                                    timeout=60)
    solo = twins["eager"][0]
    for row, got, ref in zip(rows, entries, want):
        # past 6: over-decoded tokens
        assert got["toks"][:6] == ref["toks"][:6]
        assert got["lps"][:6] == ref["lps"][:6]
        # and each row its own solo run (the eager engine shares the
        # programs' output buffers): tokens exact, the prefill's logprob
        # bitwise, the decode steps' within LP_TOL (the CPU's matmuls
        # round a row by the batch's size)
        toks, lps = solo.generate(row, max_new_tokens=6,
                                  return_logprobs=True)
        assert got["toks"][:6] == toks[0].tolist()
        assert got["lps"][0] == lps[0, 0]
        np.testing.assert_allclose(got["lps"][:6], lps[0], rtol=0,
                                   atol=LP_TOL)
    assert engine.stats()["prefill_replays"] == 2
    pools = server.program_stats()["program_pools"]
    assert [k[:3] for k in pools if k[0] == "prefill"] == [
        ["prefill", 1, 32]]


# ------------------------------------------------ counters, memory, faults


def test_prefill_counters_reach_metrics(weights):
    """The handler's ``stats()`` (``/metrics``) reports the prefill
    counters and every program's pool beside the decode counters, for the
    server and under ``batching`` for the engine."""
    state = generate_handler(
        {"model": "llama-tiny", "dtype": "float32",
         "extra": {**EXTRA, "batch_mode": "continuous", "batch_max": "2",
                   "prefix_cache_mb": "0", "warm_group_prefill": "0"}},
        HandlerContext(device="cpu", state_dict=weights[2]))
    state.server.graph_type = FakeGraph
    for n in (3, 4):
        assert state.invoke({"tokens": _prompt(n, 5),
                             "max_new_tokens": 4})["ok"]
    assert state.invoke({"tokens": [_prompt(1, 5), _prompt(2, 6)],
                         "max_new_tokens": 4})["ok"]
    stats = state.stats()
    assert stats["prefill_replays"] == 1 and stats["eager_prefills"] == 0
    layout = ["float", "blocked", "pallas"]
    assert [2, 32, *layout, "prefill", 16, "greedy", 0] \
        in stats["program_pools"]
    assert ["prefill", 1, 16, *layout, "greedy", 0] in stats["program_pools"]
    assert stats["batching"]["prefill_replays"] == 2
    assert stats["batching"]["eager_prefills"] == 0
    assert stats["batching"]["compile_count"] == 2  # prefill and decode


class PooledGraph(FakeGraph):
    """A stand-in whose capture takes a pool of ``POOL`` bytes."""

    POOL = 1 << 20

    def capture(self, fn, prepare):
        super().capture(fn, prepare)
        self.pool_bytes = self.POOL


def test_prefill_pools_count_under_program_cache_bytes(weights):
    """Prefill graphs' pools are an entry's bytes: ``program_bytes`` is the
    decode caches plus every pool, each pool is reported under its key,
    and an entry whose caches and pools pass ``program_cache_bytes`` is
    evicted before the next entry is made."""
    cfg = _server(weights, False).model.cfg
    one, wider = (tl.decode_cache_bytes(cfg, 1, 32),
                  tl.decode_cache_bytes(cfg, 1, 48))
    pool = PooledGraph.POOL
    server = _server(weights, PooledGraph,
                     program_cache_bytes=wider + 2 * pool)
    server.generate([1, 2, 3], max_new_tokens=4)             # (1, 32)
    stats = server.program_stats()
    assert stats["program_bytes"] == one + 2 * pool
    assert sorted(k[5:] for k in stats["program_pools"]) == [
        ["decode", "greedy", pool], ["prefill", 16, "greedy", pool]]
    server.generate(_prompt(3, 20), max_new_tokens=4)        # (1, 48)
    stats = server.program_stats()
    # (1, 48) and its pools fit the bound alone: (1, 32) went first
    assert stats["program_evictions"] == 1
    assert stats["program_bytes"] == wider + 2 * pool


def test_prefill_graphs_survive_an_injected_failure_not_a_cuda_error(
        weights):
    """An injected (non-CUDA) engine failure keeps the prefill programs
    and their graphs, as it keeps the decode graphs, and the replayed row
    is bitwise; a CUDA runtime error drops the server's idle prefill
    graphs with the engine's."""
    FakeGraph.made.clear()
    server = _server(weights, FakeGraph)
    cb = continuous.ContinuousBatcher(
        server, slots=2, segment=4,
        faults=FaultPlan.from_spec("segment_fetch:exception@seg=1"))
    cb.faults.clear()
    want = server.generate([6, 5, 4], max_new_tokens=8)
    np.testing.assert_array_equal(cb.generate([6, 5, 4], max_new_tokens=8),
                                  want)
    # the solo request's and the engine's, a prefill and a decode each
    made = list(FakeGraph.made)
    assert len(made) == 4 and all(g.fn is not None for g in made)
    cb.faults.arm("segment_fetch:exception")
    np.testing.assert_array_equal(cb.generate([6, 5, 4], max_new_tokens=8),
                                  want)
    cb.faults.clear()
    assert FakeGraph.made == made and all(g.fn is not None for g in made)
    assert cb.stats()["faults"]["replays"]["succeeded"] == 1

    def boom(*args, **kwargs):
        raise RuntimeError("CUDA error: device lost")

    cb._run_segment = boom
    with pytest.raises(RuntimeError, match="device lost"):
        cb.generate([6, 5, 4], max_new_tokens=8)
    # the failed engine thread closes them after the waiter has its error
    deadline = time.monotonic() + 30
    while any(g.fn is not None for g in made) \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    assert all(g.fn is None for g in made)
    assert not server.programs._idle


def test_sampled_prefills_run_eagerly_where_draws_cannot_be_captured(
        weights):
    """A graph type that cannot register generators: sampled prefills
    draw counter-based noise from their own buffers, so they replay like
    greedy ones (none runs eagerly), both bitwise the eager server."""
    graph = _server(weights, NoDrawsGraph)
    eager = _server(weights, False)
    prefix = _prompt(40, 40)
    for knobs in (SEEDED, {}):
        _equal(graph.generate([3, 4], prefix=prefix, max_new_tokens=4,
                              return_logprobs=True, **knobs),
               eager.generate([3, 4], prefix=prefix, max_new_tokens=4,
                              return_logprobs=True, **knobs))
    stats = graph.program_stats()
    assert stats["eager_prefills"] == 0 and stats["prefill_replays"] == 3


def test_a_failed_prefill_capture_raises(weights):
    """A prefill capture that fails raises to the caller; nothing runs
    eagerly in its place and what it counted is taken back."""

    class Broken(FakeGraph):
        def capture(self, fn, prepare):
            tq.int8_matmul.launches += FAKE_LAUNCHES
            raise RuntimeError("capture invalidated")

    server = _server(weights, Broken)
    before = tq.int8_matmul.launches
    with pytest.raises(RuntimeError, match="capture invalidated"):
        server.generate([1, 2, 3], prefix=_prompt(41, 40),
                        max_new_tokens=4)
    assert tq.int8_matmul.launches == before
    stats = server.program_stats()
    assert stats["eager_prefills"] == 0 and stats["prefill_replays"] == 0
    assert not server.programs._busy
    assert graphs.DEVICE_LOCK._owner is None
