"""The compiled decode step (``lambdipy_tpu_torch/models/graphs.py``, the
static-buffer ``DecodeStep`` of ``models/llama.py``) on ``llama-tiny``
(f32, 2 layers) on the CPU.

The card captures the step as a CUDA graph; here a stand-in graph type
(:class:`FakeGraph`) takes its place: its capture records the step
without running it, as the card's does, and its replay runs it. So these
tests hold the program cache (keys, LRU, evictions), the replay counting
and the static-buffer step's bits, while the card tests
(``tests/test_torch_kernels.py``, marker ``cuda``) hold real graphs.

The reference is the decode loop the static-buffer step replaced
(:func:`reference_generate`, kept here operation for operation): a fresh
cache per request, new tensors every step, the request's own generators.
Every comparison with it is bitwise, tokens and logprobs. Engine rows
hold their solo tokens exactly and their logprobs within 1e-5, as
``tests/test_torch_continuous.py`` explains; a row alone in an engine
under the stand-in is bitwise the same engine's row run eagerly."""

import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from lambdipy_tpu.models import registry as jreg
from lambdipy_tpu_torch.models import graphs
from lambdipy_tpu_torch.models import llama as tl
from lambdipy_tpu_torch.models import registry as treg
from lambdipy_tpu_torch.models.params import from_jax_params
from lambdipy_tpu_torch.ops import quant as tq
from lambdipy_tpu_torch.runtime.handlers import (HandlerContext,
                                                 generate_handler,
                                                 make_engine)

EXTRA = {"attn_backend": "blocked"}
ROWS = [list(range(3, 30)), list(range(40, 49)), [5, 6]]
SEEDED = {"temperature": 0.9, "top_k": 40, "top_p": 0.9, "seed": 5}
LP_TOL = 1e-5
# what a stand-in capture "counts", as the card's wrappers count while a
# capture runs their Python
FAKE_LAUNCHES = 7


class FakeGraph:
    """Stand-in for ``models/graphs.py CudaGraph`` on the CPU: ``capture``
    records the step without running it and counts ``FAKE_LAUNCHES`` on
    the int8 matmul's counter, as the card's capture runs the wrappers'
    Python but none of their kernels; ``replay`` runs the step."""

    captures_draws = True
    made: list = []

    def __init__(self, device):
        self.fn, self.gens, self.pool_bytes = None, [], 0
        FakeGraph.made.append(self)

    def register_generator_state(self, gen):
        self.gens.append(gen)

    def capture(self, fn, prepare):
        self.fn = fn
        tq.int8_matmul.launches += FAKE_LAUNCHES

    def replay(self):
        self.fn()

    def reset(self):
        self.fn = None


class NoDrawsGraph(FakeGraph):
    """A graph type that cannot register generators (the port's programs
    register none)."""

    captures_draws = False

    def register_generator_state(self, gen):
        raise AssertionError("a program registered a generator")


@pytest.fixture(scope="module")
def weights():
    adapter = jreg.get("llama-tiny").build(extra=EXTRA)
    params = adapter.init_params(seed=0)
    return adapter, params, from_jax_params(
        jax.tree_util.tree_map(np.asarray, params))


def _server(weights, graphs, kv_quant=None, **kw):
    extra = {**EXTRA, **({"kv_quant": kv_quant} if kv_quant else {})}
    return treg.get("llama-tiny").build(extra=extra).make_server(
        weights[2], device="cpu", graphs=graphs, **kw)


# ------------------------------------------------ the loop it replaced

def _old_select(temperature, top_k, top_p):
    sampled_rows = temperature > 0

    def select(lg, gens):
        lg = lg.float()
        greedy = lg.argmax(dim=-1)
        if not sampled_rows.any():
            return greedy, tl._token_logprob(lg, greedy)
        t_row = torch.as_tensor(temperature, device=lg.device)
        t = t_row.clamp(min=1e-6)[:, None]
        filt = tl.filter_logits_runtime(lg / t, top_k, top_p)
        # each row's stream on the host: its key and draws so far
        keys, draws = map(torch.as_tensor, tl.streams_host(gens, len(gens)))
        for g in gens:
            g.draw += 1
        draw = (filt + tl.gumbel_noise(keys, draws,
                                       lg.shape[-1])).argmax(dim=-1)
        tok = torch.where(t_row > 0, draw, greedy)
        return tok, tl._token_logprob(lg, tok)

    return select


def reference_generate(server, rows, max_new_tokens, *, temperature=0.0,
                       top_k=None, top_p=None, seed=0, eos_id=None):
    """``LlamaServer.generate`` as it was before the static-buffer step:
    the prefill embedded into a fresh decode cache, every step's index,
    positions and carry new tensors, the request's generators drawing."""
    model, cfg = server.model, server.model.cfg
    rows, lengths = server._normalize_prompts(rows)
    b, s = len(rows), max(lengths)
    steps = min(tl._next_bucket(max_new_tokens, tl.MIN_BUCKET),
                cfg.max_len - s)
    sb = server.prompt_bucket(s, max_new_tokens)
    bb = tl._next_bucket(b, 1)
    cache_len = min(sb + steps, cfg.max_len)
    with torch.inference_mode():
        prompt, length = map(torch.as_tensor,
                             server._pad_host(rows, lengths, bb, sb))
        temp, tk, tp, eos, gens = server._knobs_host(
            temperature, top_k, top_p, seed, eos_id, b=bb)
        tk, tp, eos = map(torch.as_tensor, (tk, tp, eos))
        select = _old_select(temp, tk, tp)
        logits, pc = model(prompt, logit_positions=length - 1)
        cache = tl.prefill_into_cache(cfg, pc, bb, cache_len, 0)
        tok, lp = select(logits[:, 0, :].float(), gens)
        pos, done = length, (eos >= 0) & (tok == eos)
        toks, lps = [], []
        for i in range(max_new_tokens):
            toks.append(tok)
            lps.append(lp)
            if i == max_new_tokens - 1:
                break
            for entry in cache:
                entry["index"] = pos
            logits, _ = model(tok[:, None], positions=pos[:, None],
                              cache=cache)
            pos = pos + 1
            nxt, nlp = select(logits[:, -1, :].float(), gens)
            nxt = torch.where(done, eos, nxt)
            nlp = torch.where(done, 0.0, nlp)
            done = done | ((eos >= 0) & (nxt == eos))
            tok, lp = nxt, nlp
        return (torch.stack(toks, 1)[:b].to(torch.int32).numpy(),
                torch.stack(lps, 1)[:b].float().numpy())


GRAPHS = pytest.mark.parametrize("graph_type", [False, FakeGraph],
                                 ids=["eager", "graphs"])
KV = pytest.mark.parametrize("kv_quant", [None, "int8"],
                             ids=["float", "int8kv"])


@GRAPHS
@KV
@pytest.mark.parametrize("knobs", [{}, SEEDED], ids=["greedy", "seeded"])
def test_static_step_is_bitwise_the_loop_it_replaced(weights, graph_type,
                                                     kv_quant, knobs):
    server = _server(weights, graph_type, kv_quant)
    want = reference_generate(server, ROWS, 12, **knobs)
    got = server.generate(ROWS, max_new_tokens=12, return_logprobs=True,
                          **knobs)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # the program's buffers are reused: a second request is bitwise too
    again = server.generate(ROWS, max_new_tokens=12, return_logprobs=True,
                            **knobs)
    np.testing.assert_array_equal(again[1], want[1])
    stats = server.program_stats()
    if graph_type:
        # the prefill program and the decode program, each captured once
        assert stats["compile_count"] == 2
        assert stats["replays"] == 2 * 11 and stats["eager_steps"] == 0
        assert stats["prefill_replays"] == 2 and stats["eager_prefills"] == 0
    else:
        assert stats["compile_count"] == 0 and stats["eager_steps"] == 22
        assert stats["eager_prefills"] == 2


@GRAPHS
def test_eos_latch_is_bitwise_the_loop(weights, graph_type):
    server = _server(weights, graph_type)
    plain = reference_generate(server, ROWS, 10)[0]
    eos = int(plain[0, 4])
    want = reference_generate(server, ROWS, 10, eos_id=eos)
    got = server.generate(ROWS, max_new_tokens=10, eos_id=eos,
                          return_logprobs=True)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert (got[0][0, 4:] == eos).all()


@GRAPHS
@pytest.mark.parametrize("knobs", [{}, SEEDED], ids=["greedy", "seeded"])
def test_generate_stream_is_bitwise_the_loop(weights, graph_type, knobs):
    server = _server(weights, graph_type, "int8")
    want = reference_generate(server, ROWS, 13, **knobs)
    chunks = list(server.generate_stream(ROWS, max_new_tokens=13, segment=4,
                                         return_logprobs=True, **knobs))
    assert [c[0].shape[1] for c in chunks] == [4, 4, 4, 1]
    np.testing.assert_array_equal(np.concatenate([c[0] for c in chunks], 1),
                                  want[0])
    np.testing.assert_array_equal(np.concatenate([c[1] for c in chunks], 1),
                                  want[1])
    # the program went back to the cache when the stream ended
    assert server.programs.keys() and not server.programs._busy


def test_greedy_with_graphs_is_token_exact_against_jax(weights):
    """As ``tests/test_torch_serve.py`` holds for the eager server: the
    same greedy tokens as the JAX server on the same weights, logprobs
    within 1e-4 (f32 summation order)."""
    _, params, _ = weights
    want, want_lp = jreg.get("llama-tiny").build(extra=EXTRA).make_server(
        params).generate(ROWS, max_new_tokens=10, return_logprobs=True)
    server = _server(weights, FakeGraph)
    got, got_lp = server.generate(ROWS, max_new_tokens=10,
                                  return_logprobs=True)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got_lp, want_lp, atol=1e-4)
    assert server.program_stats()["replays"] == 9


def test_program_cache_keys_lru_and_evictions(weights):
    """An entry is keyed (batch bucket, cache_len, KV layout, backends) and
    holds one decode cache with a greedy and a sampled program on it and
    the prefill programs that load it; a program's key adds greedy or
    sampled, as the JAX server keys its programs. The LRU holds
    ``program_cache_max`` entries and counts what it evicts; an evicted
    entry's graphs, prefill graphs included, are freed."""
    server = _server(weights, FakeGraph, program_cache_max=2)
    cfg = server.model.cfg
    FakeGraph.made.clear()
    server.generate([1, 2, 3], max_new_tokens=4)            # (1, 32)
    server.generate([1, 2, 3], max_new_tokens=4, **SEEDED)  # its sampled
    stats = server.program_stats()
    assert stats["decode_buckets"] == [
        [1, 32, "float", "blocked", "pallas", "greedy"],
        [1, 32, "float", "blocked", "pallas", "sampled"]]
    # a prefill and a decode program each, greedy and sampled
    assert stats["compile_count"] == 4 and stats["program_evictions"] == 0
    assert stats["program_pools"] == [
        [1, 32, "float", "blocked", "pallas", "decode", mode, 0]
        for mode in ("greedy", "sampled")] + [
        [1, 32, "float", "blocked", "pallas", "prefill", 16, mode, 0]
        for mode in ("greedy", "sampled")]
    # greedy and sampled share the entry's one cache
    assert stats["program_bytes"] == tl.decode_cache_bytes(cfg, 1, 32)
    server.generate(ROWS, max_new_tokens=4)                # (4, 48)
    server.generate([1, 2, 3], max_new_tokens=20)          # (1, 48)
    stats = server.program_stats()
    assert stats["compile_count"] == 8 and stats["program_evictions"] == 1
    assert [k[:2] for k in stats["decode_buckets"]] == [[1, 48], [4, 48]]
    # the four graphs of the evicted entry were reset
    assert all(g.fn is None for g in FakeGraph.made[:4])
    # a hit captures nothing new and moves the key to the front
    server.generate(ROWS, max_new_tokens=4)
    server.generate([1, 2, 3], max_new_tokens=4)           # (1, 32) again
    stats = server.program_stats()
    assert stats["compile_count"] == 10 and stats["program_evictions"] == 2
    assert [k[:2] for k in stats["decode_buckets"]] == [[1, 32], [4, 48]]
    assert stats["program_bytes"] == (tl.decode_cache_bytes(cfg, 1, 32)
                                      + tl.decode_cache_bytes(cfg, 4, 48))


def test_program_cache_bytes_bound_evicts_before_allocating(weights,
                                                            monkeypatch):
    """``program_cache_bytes`` bounds the bytes the entries hold: idle
    entries are evicted, oldest first, before a new entry's cache is
    allocated, so the held bytes never pass the bound; an entry a stream
    holds stays past the bound, and goes when it is idle."""
    cfg = _server(weights, False).model.cfg
    one, four = (tl.decode_cache_bytes(cfg, 1, 32),
                 tl.decode_cache_bytes(cfg, 4, 48))
    server = _server(weights, FakeGraph, program_cache_bytes=one + four)
    want = reference_generate(server, [[1, 2, 3]], 20)
    held_at_alloc = []
    real = tl.init_decode_cache

    def spy(cfg, batch, max_len, device):
        held_at_alloc.append(server.programs.nbytes())
        return real(cfg, batch, max_len, device)

    monkeypatch.setattr(tl, "init_decode_cache", spy)
    server.generate([1, 2, 3], max_new_tokens=4)            # (1, 32)
    server.generate(ROWS, max_new_tokens=4)                 # (4, 48): fits
    assert server.program_stats()["program_evictions"] == 0
    got = server.generate([1, 2, 3], max_new_tokens=20,     # (1, 48)
                          return_logprobs=True)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    stats = server.program_stats()
    # (1, 48) does not fit beside (4, 48): both older entries went first
    assert held_at_alloc == [0, one, 0]
    assert stats["program_evictions"] == 2
    assert stats["program_bytes"] == tl.decode_cache_bytes(cfg, 1, 48)
    assert [k[:2] for k in stats["decode_buckets"]] == [[1, 48]]

    server = _server(weights, FakeGraph, program_cache_bytes=1)
    stream = server.generate_stream([1, 2, 3], max_new_tokens=8, segment=4)
    first = next(stream)
    assert server.program_stats()["program_bytes"] == one
    want = reference_generate(server, [[4, 5, 6]], 8)[0]
    np.testing.assert_array_equal(server.generate([4, 5, 6],
                                                  max_new_tokens=8), want)
    rest = list(stream)
    np.testing.assert_array_equal(
        np.concatenate([first, *rest], 1),
        reference_generate(server, [[1, 2, 3]], 8)[0])
    stats = server.program_stats()
    assert stats["program_bytes"] == 0 and stats["program_evictions"] == 2


@pytest.mark.parametrize("where", ["allocation", "prefill"])
def test_out_of_memory_evicts_idle_programs_and_retries(weights, monkeypatch,
                                                        where):
    """A request that runs out of device memory, allocating its entry's
    cache or in its prefill, evicts every idle entry and runs once more,
    with the same bits; out of memory with nothing idle to evict
    raises."""
    server = _server(weights, FakeGraph)
    server.generate([1, 2, 3], max_new_tokens=4)            # idle (1, 32)
    server.generate(ROWS, max_new_tokens=4)                 # idle (4, 48)
    want = reference_generate(server, [[1, 2, 3]], 20)
    name = {"allocation": "init_decode_cache",
            "prefill": "_serve_prefill"}[where]
    real, calls = getattr(tl, name), []

    def oom_once(*args):
        calls.append(server.programs.nbytes())
        if len(calls) == 1:
            raise torch.OutOfMemoryError("out of memory")
        return real(*args)

    monkeypatch.setattr(tl, name, oom_once)
    got = server.generate([1, 2, 3], max_new_tokens=20, return_logprobs=True)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert len(calls) == 2 and calls[1] == (
        0 if where == "allocation"
        else tl.decode_cache_bytes(server.model.cfg, 1, 48))
    # the prefill's attempt left its own entry idle: evicted as well
    evicted = {"allocation": 2, "prefill": 3}[where]
    assert server.program_stats()["program_evictions"] == evicted

    def oom(*args):
        raise torch.OutOfMemoryError("out of memory")

    monkeypatch.setattr(tl, name, oom)
    with pytest.raises(torch.OutOfMemoryError):
        server.generate([1, 2, 3], max_new_tokens=40)
    assert not server.programs._busy


def test_generate_lets_other_device_work_run_between_segments(weights):
    """``generate`` holds the device lock one segment of decode steps at
    a time: a thread that asks for the lock while a request decodes (an
    engine segment, another prefill) runs after that segment, not after
    the request. (Replay 1 is the prefill's.)"""
    replays, other = [], []

    def other_work():
        with graphs.DEVICE_LOCK:
            other.append(len(replays))

    class Probe(FakeGraph):
        def replay(self):
            super().replay()
            replays.append(1)
            if len(replays) == 2:
                threading.Thread(target=other_work).start()
                while not graphs.DEVICE_LOCK._queue:
                    time.sleep(0.001)

    server = _server(weights, Probe)
    server.segment = 4
    want = reference_generate(server, [[1, 2, 3]], 13)[0]
    np.testing.assert_array_equal(server.generate([1, 2, 3],
                                                  max_new_tokens=13), want)
    assert other == [1 + 4] and len(replays) == 1 + 12


def test_replays_add_what_the_capture_counted(weights):
    """A capture counts nothing (the stand-in's capture 'counted'
    FAKE_LAUNCHES, and the program took them back); every replay, of a
    prefill or of a decode step, adds exactly what its capture counted."""
    server = _server(weights, FakeGraph)
    before = tq.int8_matmul.launches
    server.generate([4, 5, 6], max_new_tokens=1)   # prefill only
    assert tq.int8_matmul.launches - before == FAKE_LAUNCHES
    server.generate([4, 5, 6], max_new_tokens=9)
    stats = server.program_stats()
    assert stats["compile_count"] == 2 and stats["replays"] == 8
    assert stats["prefill_replays"] == 2
    assert tq.int8_matmul.launches - before == (2 + 8) * FAKE_LAUNCHES


def test_sampled_steps_run_eagerly_where_draws_cannot_be_captured(weights):
    """A graph type that cannot register generators: sampled draws are
    counter-based noise on the program's own buffers, so nothing of a
    sampled step lies outside the graph and, greedy and sampled alike,
    every step and prefill is captured and replayed, with the bits of
    the loop it replaced; none runs eagerly."""
    server = _server(weights, NoDrawsGraph)
    want = reference_generate(server, ROWS, 6, **SEEDED)
    got = server.generate(ROWS, max_new_tokens=6, return_logprobs=True,
                          **SEEDED)
    np.testing.assert_array_equal(got[1], want[1])
    server.generate(ROWS, max_new_tokens=6)
    stats = server.program_stats()
    assert stats["eager_steps"] == 0 and stats["replays"] == 10
    assert stats["eager_prefills"] == 0 and stats["prefill_replays"] == 2
    assert stats["compile_count"] == 4


def test_interleaved_streams_of_one_bucket_get_their_own_programs(weights):
    """Two streams of one key, advanced in turns: each checked out its own
    program (captured anew) and each gives its solo tokens."""
    server = _server(weights, FakeGraph)
    a, b = [7, 8, 9, 10], [11, 12, 13]
    want_a = reference_generate(server, [a], 12)[0]
    want_b = reference_generate(server, [b], 12, **SEEDED)[0]
    sa = server.generate_stream([a], max_new_tokens=12, segment=4)
    sb = server.generate_stream([b], max_new_tokens=12, segment=4, **SEEDED)
    got_a, got_b = [], []
    for ca, cb in zip(sa, sb):
        got_a.append(ca)
        got_b.append(cb)
    np.testing.assert_array_equal(np.concatenate(got_a, 1), want_a)
    np.testing.assert_array_equal(np.concatenate(got_b, 1), want_b)
    # one greedy and one sampled key, then the same key twice at once
    sa = server.generate_stream([a], max_new_tokens=8, segment=4)
    sa2 = server.generate_stream([b], max_new_tokens=8, segment=4)
    outs = [np.concatenate([x, y], 0) for x, y in zip(sa, sa2)]
    np.testing.assert_array_equal(outs[0][0], want_a[0, :4])
    np.testing.assert_array_equal(
        outs[1][1], reference_generate(server, [b], 8)[0][0, 4:])
    stats = server.program_stats()
    # each of the three decode programs with its prefill
    assert stats["compile_count"] == 6
    assert len(stats["decode_buckets"]) == 3


def test_capture_failure_raises(weights):
    """A capture that fails raises to the caller; nothing decodes eagerly
    in its place, what it counted is taken back, and the program goes
    back to the cache."""

    class Broken(FakeGraph):
        def capture(self, fn, prepare):
            tq.int8_matmul.launches += FAKE_LAUNCHES  # counted, then
            raise RuntimeError("capture invalidated")

    server = _server(weights, Broken)
    before = tq.int8_matmul.launches
    with pytest.raises(RuntimeError, match="capture invalidated"):
        server.generate([1, 2, 3], max_new_tokens=4)
    assert tq.int8_matmul.launches == before  # nothing ran
    stats = server.program_stats()
    assert stats["eager_steps"] == 0 and stats["replays"] == 0
    assert not server.programs._busy


# ------------------------------------------------------------- engines

ENGINES = {"dense": {"batch_max": "4", "batch_segment": "4"},
           "paged": {"batch_max": "4", "batch_segment": "4",
                     "kv_paged": "1", "prefix_block": "16"}}


def _concurrent(engine, requests, stagger=0.01):
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
    assert not any(t.is_alive() for t in threads)
    return out


ENGINE_REQUESTS = [([(7 * i + 3 * j) % 500 + 1 for j in range(4 + 3 * i)],
                    10 + 2 * i, SEEDED if i == 1 else {})
                   for i in range(5)]


@pytest.mark.parametrize("kind", ENGINES)
@KV
def test_engine_rows_match_the_eager_engine_and_solo(weights, kind,
                                                     kv_quant):
    """Five requests (one seeded, one joining mid-flight) through an
    engine whose steps replay the stand-in's graphs: every row holds the
    tokens of the same engine run eagerly and its solo tokens (logprobs
    within 1e-5: which rows share a step depends on timing, and the CPU's
    matmuls round a row by the batch's size); a request alone is bitwise
    the eager engine's. Every engine step was a replay of one of its two
    programs."""
    outs, alone = {}, {}
    for graph_type in (False, FakeGraph):
        server = _server(weights, graph_type, kv_quant)
        engine = make_engine(server, ENGINES[kind])
        outs[graph_type] = _concurrent(engine, ENGINE_REQUESTS, stagger=0.03)
        p, n, kw = ENGINE_REQUESTS[1]
        alone[graph_type] = engine.generate(p, max_new_tokens=n,
                                            return_logprobs=True, **kw)
        stats = engine.stats()
        prefills = stats["prefill_groups"] + stats["row_prefills"]
        if graph_type:
            # the two decode programs and a prefill program per shape
            shapes = [k for k in server.program_stats()["program_pools"]
                      if k[0] == "prefill"]
            assert stats["replays"] == stats["steps"] > 0
            assert stats["compile_count"] == 2 + len(shapes) > 2
            assert stats["eager_steps"] == 0
            assert stats["prefill_replays"] == prefills
            assert stats["eager_prefills"] == 0
        else:
            assert stats["eager_steps"] == stats["steps"]
            assert stats["eager_prefills"] == prefills
    np.testing.assert_array_equal(alone[FakeGraph][0], alone[False][0])
    np.testing.assert_array_equal(alone[FakeGraph][1], alone[False][1])
    for (p, n, kw), (tok_e, lp_e), (tok_g, lp_g) in zip(
            ENGINE_REQUESTS, outs[False], outs[FakeGraph]):
        np.testing.assert_array_equal(tok_g, tok_e)
        np.testing.assert_allclose(lp_g, lp_e, atol=LP_TOL)
        want, want_lp = server.generate(p, max_new_tokens=n,
                                        return_logprobs=True, **kw)
        np.testing.assert_array_equal(tok_g, want)
        np.testing.assert_allclose(lp_g, want_lp, atol=LP_TOL)


def test_engine_reset_and_a_rebuilt_arena_drop_its_graphs(weights,
                                                          monkeypatch):
    """A failure from the CUDA runtime resets the engine with its step
    and graphs (an injected or host-side failure keeps them:
    ``tests/test_torch_faults.py``); an arena rebuilt under the engine (a
    new ``generation``) makes it drop graphs that hold the old arena's
    addresses."""
    server = _server(weights, FakeGraph)
    engine = make_engine(server, ENGINES["paged"])
    p = [1, 2, 3, 4, 5]
    want = server.generate(p, max_new_tokens=6)
    np.testing.assert_array_equal(engine.generate(p, max_new_tokens=6), want)
    graph = engine._programs.graph(False)
    assert graph.fn is not None

    def boom(*args, **kwargs):
        raise RuntimeError("CUDA error: device lost")

    monkeypatch.setattr(engine, "_run_segment", boom)
    with pytest.raises(RuntimeError, match="device lost"):
        engine.generate(p, max_new_tokens=6)
    monkeypatch.undo()
    assert engine._step is None and graph.fn is None
    np.testing.assert_array_equal(engine.generate(p, max_new_tokens=6), want)
    graph = engine._programs.graph(False)
    with engine.pool.arena_lock:  # what a rebuild does
        engine.pool._arena = None
        engine.pool.ensure_arena()
    assert engine.pool.generation == 2
    np.testing.assert_array_equal(engine.generate(p, max_new_tokens=6), want)
    assert graph.fn is None and engine._programs.graph(False) is not graph
    # the decode step three times, the group prefill twice: the CUDA
    # error dropped the server's idle prefill programs too
    assert engine.stats()["compile_count"] == 5


def test_handler_honours_program_cache_max_and_reports_programs(weights):
    """The ``program_cache_max`` extra bounds the server's programs;
    ``stats()`` reports decode_buckets, compile_count and
    program_evictions as the JAX handler does, plus replays and
    eager_steps; a warm-up request makes its bucket's program."""
    state = generate_handler(
        {"model": "llama-tiny", "dtype": "float32",
         "extra": {**EXTRA, "program_cache_max": "3"}},
        HandlerContext(device="cpu", state_dict=weights[2]))
    server = state.server
    assert server.programs.max_entries == 3 and server.graph_type is None
    assert state.invoke({"warmup": True})["ok"]
    stats = state.stats()
    assert stats["decode_buckets"] == [
        [1, 32, "float", "blocked", "pallas", "greedy"]]
    assert {"compile_count", "program_evictions", "replays",
            "eager_steps"} <= set(stats)
    assert stats["eager_steps"] == 15 and stats["graphs"] is False


def test_decode_step_writes_the_paged_address_in_place(weights):
    """The paged step's write address is computed into fixed tensors
    every layer shares: page ``tables[r, pos // page]`` at ``pos % page``,
    the null page past the table, attention length ``pos + 1``."""
    model = _server(weights, False).model
    arena = tl.init_page_arena(model.cfg, 9, 4, "cpu")
    tables = torch.tensor([[3, 5], [7, 0]], dtype=torch.int32)
    step = tl.DecodeStep(model, arena, 2, tables=tables)
    addresses = [id(step.cache[0][k]) for k in tl.PAGED_STEP_KEYS]
    step.pos.copy_(torch.tensor([5, 8], dtype=torch.int32))
    step._write_address()
    first = step.cache[0]
    assert first["write_page"].tolist() == [5, tl.NULL_PAGE]
    assert first["write_off"].tolist() == [1, 0]
    assert first["active"].tolist() == [6, 9]
    assert [id(step.cache[1][k]) for k in tl.PAGED_STEP_KEYS] == addresses


def test_device_lock_is_granted_in_arrival_order():
    """The device lock is reentrant and first come, first served: a
    thread that releases it and asks again at once (the engine between
    segments) queues behind a thread already waiting (a request-thread
    prefill); 8 threads x 200 rounds keep it exclusive."""
    lock = graphs.FairLock()
    order = []
    lock.acquire()
    lock.acquire()  # reentrant
    waiter = threading.Thread(target=lambda: (lock.acquire(),
                                              order.append("waiter"),
                                              lock.release()))
    waiter.start()
    while not lock._queue:
        time.sleep(0.001)
    lock.release()
    lock.release()
    with lock:
        order.append("holder")
    waiter.join(timeout=10)
    assert not waiter.is_alive() and order == ["waiter", "holder"]
    with pytest.raises(RuntimeError):
        lock.release()

    inside, most = [0], [0]

    def worker():
        for _ in range(200):
            with lock:
                inside[0] += 1
                most[0] = max(most[0], inside[0])
                inside[0] -= 1

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        workers = [threading.Thread(target=worker) for _ in range(8)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(w.is_alive() for w in workers) and most[0] == 1
