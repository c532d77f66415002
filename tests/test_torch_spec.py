"""Speculative decoding in the port (``lambdipy_tpu_torch/models/spec.py``,
``models/llama.py VerifyStep`` and ``LlamaServer.generate_speculative``,
the engine's ``spec_k``) on ``llama-tiny`` (f32, 2 layers) on the CPU,
against the JAX package on the same weights where the two share a
contract: the twins of ``tests/test_speculative.py``,
``tests/test_spec_engine.py`` and ``tests/test_spec_draft.py`` (not their
``aux``, fleet and sequence-parallel cases).

Tolerances: greedy TOKENS are exact everywhere (port against JAX, spec
against plain). Logprobs: port speculative against port plain within
``LP_TOL`` = 1e-5 (on the CPU PyTorch's matmul may sum a row in another
order at another row count: a verify runs ``b * kb`` rows where the
plain step runs ``b``; on the card the GEMV makes them bitwise, card
tests in ``tests/test_torch_kernels.py``); port against JAX within
``JAX_LP_TOL`` = 1e-4, the JAX suite's own bound for its chunked verify.
Seeded-sampled engine rows: tokens exact against the spec-off engine
(the draw index is rolled back on the device), logprobs within
``LP_TOL``. The rejection sampler's statistical bound is stated at its
test."""

import threading
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from lambdipy_tpu.models import llama as jl
from lambdipy_tpu.models import registry as jreg
from lambdipy_tpu.runtime.handlers import \
    generate_handler as jax_generate_handler
from lambdipy_tpu_torch.models import llama as tl
from lambdipy_tpu_torch.models import registry as treg
from lambdipy_tpu_torch.models import spec as ts
from lambdipy_tpu_torch.models.params import from_jax_params
from lambdipy_tpu_torch.runtime.continuous import ContinuousBatcher
from lambdipy_tpu_torch.runtime.handlers import (HandlerContext,
                                                 generate_handler,
                                                 make_engine)
from lambdipy_tpu_torch.runtime.metrics import SpecDecodeStats

EXTRA = {"attn_backend": "blocked"}
LP_TOL = 1e-5
JAX_LP_TOL = 1e-4
SEEDED = {"temperature": 0.8, "top_p": 0.9, "seed": 11}


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


def _prompt(i, n):
    return [(7 * i + 3 * j) % 500 + 1 for j in range(n)]


def _mk(server, **kw):
    args = dict(slots=4, segment=4, spec_k=8)
    args.update(kw)
    return ContinuousBatcher(server, **args)


# -- the pure parts -----------------------------------------------------------


@pytest.mark.parametrize("context,k,ngram", [
    ([], 4, 3), ([7], 3, 3), ([9, 9], 3, 3), ([5, 6, 5, 6], 4, 3),
    ([1, 2, 3], 3, 3), ([1, 5, 6, 7, 8, 9, 2, 5, 6, 7], 3, 3),
    ([4, 9, 9, 4], 3, 3), ([7, 8, 9, 7, 8], 2, 3), ([5, 6, 5], 4, 3),
    ([1, 5, 6, 7, 42, 9, 2, 5, 6, 7], 3, 3), ([3, 1, 2, 3, 1, 4, 3], 5, 1)])
def test_lookup_draft_matches_jax(context, k, ngram):
    """Prompt-lookup drafting, hit flag included, is the JAX function's
    on its edge cases: an empty context (zeros, a miss), one token, no
    match (repeat the last, a miss), a short continuation padded with the
    last token, an eos inside the draft."""
    got = ts.lookup_draft_hit(context, k, ngram_max=ngram)
    assert got == jl._lookup_draft_hit(context, k, ngram_max=ngram)
    assert ts.lookup_draft(context, k, ngram) == got[0]


def _greedy_chain(lg):
    lsm = torch.log_softmax(lg, dim=-1)
    tok = lg.argmax(-1)
    return tok, lsm.gather(-1, tok[..., None])[..., 0]


def test_chain_verify_accept_and_reject_rows():
    """A full-accept row and an all-rejected row in one chunk: count is
    the accepted prefix plus the chain's token; a ``-1`` pad (a row
    drafting fewer than kb - 1) is never accepted; the logprob block
    starts with the pending token's."""
    torch.manual_seed(0)
    b, kb, v = 3, 4, 16
    lg = torch.randn(b, kb, v) * 3
    tgt, tlp = _greedy_chain(lg)
    draft = torch.stack([tgt[0, :3], (tgt[1, :3] + 1) % v,
                         torch.tensor([int(tgt[2, 0]), -1, -1])])
    lp_in = torch.tensor([0.5, 0.25, 0.125])
    lps, count, tok2, lp2 = ts.chain_verify(tgt, tlp, draft, lp_in)
    assert count.tolist() == [4, 1, 2]
    assert tok2.tolist() == [int(tgt[0, 3]), int(tgt[1, 0]),
                             int(tgt[2, 1])]
    assert torch.equal(lp2, tlp[torch.arange(b), count - 1])
    assert torch.equal(lps[:, 0], lp_in)
    assert torch.equal(lps[:, 1:], tlp[:, :3])


def test_chain_verify_k2_minimum_bucket():
    """The kb = 2 bucket: one draft; accepted gives count 2, rejected 1."""
    lg = torch.tensor([[[0.0, 5.0, 1.0], [3.0, 0.0, 1.0]]])
    tgt, tlp = _greedy_chain(lg)
    for draft, want in ((1, 2), (2, 1), (-1, 1)):
        _, count, tok2, _ = ts.chain_verify(
            tgt, tlp, torch.tensor([[draft]]), torch.zeros(1))
        assert int(count[0]) == want
        assert int(tok2[0]) == int(tgt[0, want - 1])


def test_accept_resample_is_exactly_target_distributed():
    """The rejection core's identity, empirically: over n = 40,000 seeds
    of the solo sampled stream, the first emitted token (draft 0 when
    accepted, else the residual draw) is distributed as the target row.
    Bound: 0.015 on every probability, more than 6 standard errors
    (sqrt(p (1 - p) / n) <= 0.0025), the JAX suite's bound."""
    rng = np.random.default_rng(0)
    v, kb, n = 8, 4, 40000
    logits = rng.standard_normal((kb, v)) * 1.5
    probs = torch.as_tensor(np.exp(logits) / np.exp(logits).sum(-1,
                                                                keepdims=True),
                            dtype=torch.float32)
    keys = torch.as_tensor(np.asarray(
        [tl.row_key(s, tl.SPEC_STREAM) for s in range(n)], np.int64))
    draws = torch.arange(kb, dtype=torch.long)[None, :].expand(n, kb)
    u = tl.stream_uniform(keys[:, None, :].expand(n, kb - 1, 2),
                          draws[:, :kb - 1])
    noise = tl.gumbel_noise(keys, draws[:, kb - 1], v)
    draft = torch.tensor([2, 5, 1])[None, :].expand(n, kb - 1)
    m, new = ts.accept_resample(probs[None].expand(n, kb, v), draft, u,
                                noise)
    first = torch.where(m >= 1, draft[:, 0], new).numpy()
    emp = np.bincount(first, minlength=v) / n
    assert np.abs(emp - probs[0].numpy()).max() < 0.015


def test_stream_noise_is_a_function_of_key_draw_and_vocab_index():
    """The sampled noise depends on (key, draw index, vocab index) alone:
    the same row drawn inside a batch or alone, at its index, gives the
    same uniforms; another index or key gives others; every uniform lies
    in (0, 1)."""
    keys = torch.tensor([tl.row_key(5, 0), tl.row_key(5, 1),
                         tl.row_key(6, 0)])
    draw = torch.tensor([3, 3, 3])
    u = tl.stream_uniform(keys, draw, 64)
    alone = tl.stream_uniform(keys[1:2], draw[1:2], 64)
    assert torch.equal(u[1:2], alone)
    assert not torch.equal(u[0], u[1]) and not torch.equal(u[0], u[2])
    assert not torch.equal(u[0], tl.stream_uniform(keys[:1],
                                                   torch.tensor([4]),
                                                   64)[0])
    assert bool(((u > 0) & (u < 1)).all())


# -- the verify forward and the shallow exit ------------------------------------


def test_shallow_exit_full_depth_is_the_full_forward(server):
    """``exit_layer = layers`` runs the full forward (the same weights, the
    same ops, bitwise); a shallow exit returns one cache entry per layer
    run, as the JAX model does."""
    model = server.model
    toks = torch.tensor([[1, 2, 3, 4, 5]])
    with torch.inference_mode():
        full, _ = model(toks)
        same, cache = model(toks, exit_layer=model.cfg.layers)
        early, cache1 = model(toks, exit_layer=1)
    assert torch.equal(full, same) and len(cache) == model.cfg.layers
    assert early.shape == full.shape and len(cache1) == 1
    assert not torch.equal(early, full)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["float", "int8kv"])
def test_verify_rows_are_the_one_token_steps(weights, paged, kv_quant):
    """A verify of 4 slots x kb = 4 is the one-token steps it stands for:
    with drafts equal to each row's greedy chain every draft is accepted,
    and the emitted tokens, logprobs and every layer's K/V at the verified
    positions are the 4 plain steps' (tokens exact, the rest within
    ``LP_TOL`` on the CPU); the carry (token, position, draw index)
    advances by the count. A second verify with the chain's token at one
    position replaced rolls back to that position."""
    extra = {**EXTRA, **({"kv_quant": kv_quant} if kv_quant else {})}
    model = treg.get("llama-tiny").build(extra=extra).make_server(
        weights[2], device="cpu").model
    cfg = model.cfg
    b, kb, width = 4, 4, 64
    page = 16

    def fresh():
        if not paged:
            cache = tl.init_decode_cache(cfg, b, width, "cpu")
            return tl.DecodeStep(model, cache, b)
        arena = tl.init_page_arena(cfg, 1 + b * width // page, page, "cpu")
        tables = torch.arange(1, 1 + b * width // page,
                              dtype=torch.int32).view(b, -1)
        return tl.DecodeStep(model, arena, b, tables=tables)

    start = torch.tensor([3, 9, 5, 12], dtype=torch.int32)
    first = torch.tensor([7, 8, 9, 10])
    streams = tl.row_streams([(1, r) for r in range(b)])

    def load(step):
        step.load(first, torch.zeros(b), start, [-1] * b, streams)

    with torch.inference_mode():
        plain = fresh()
        load(plain)
        toks, lps = tl._scan_decode(lambda: plain.step(False), plain, kb,
                                    segment=True)
        spec = fresh()
        load(spec)
        vstep = tl.VerifyStep(spec, kb)
        vstep.set_drafts(toks[:, 1:].numpy())
        chunk, vlps, count, pend = vstep.run(False)
    assert count.tolist() == [kb] * b
    assert torch.equal(chunk, toks)
    torch.testing.assert_close(vlps, lps, atol=LP_TOL, rtol=0)
    for name in ("tok", "pos", "draw"):
        assert torch.equal(getattr(spec, name), getattr(plain, name)), name
    torch.testing.assert_close(spec.lp, plain.lp, atol=LP_TOL, rtol=0)
    for pe, se in zip(plain.cache, spec.cache):
        for name, val in tl._leaves(pe).items():
            torch.testing.assert_close(se[name].float(), val.float(),
                                       atol=1e-4, rtol=0)
    with torch.inference_mode():
        bad = toks[:, 1:].clone()
        bad[:, 1] = (bad[:, 1] + 1) % cfg.vocab_size
        again = fresh()
        load(again)
        vstep = tl.VerifyStep(again, kb)
        vstep.set_drafts(bad.numpy())
        _, _, count, _ = vstep.run(False)
    assert count.tolist() == [2] * b
    assert torch.equal(again.pos, start + 2)
    assert torch.equal(again.tok, toks[:, 2])


# -- the solo path: generate_speculative ---------------------------------------


@pytest.mark.parametrize("prompt", [[1, 2, 3, 4, 5], [9, 8, 7],
                                    list(range(1, 30)), [5, 6, 7, 8]])
def test_solo_greedy_matches_jax_and_plain(server, jax_server, prompt):
    """Greedy speculative tokens are plain ``generate``'s and the JAX
    ``generate_speculative``'s for k = 2, 4, 8; logprobs within
    ``LP_TOL`` of plain and ``JAX_LP_TOL`` of JAX; the verify counters
    (steps, emitted) are JAX's."""
    ref, ref_lp = server.generate(prompt, max_new_tokens=24,
                                  return_logprobs=True)
    for k in (2, 4, 8):
        (out, lps), stats = server.generate_speculative(
            prompt, max_new_tokens=24, k=k, return_logprobs=True,
            return_stats=True)
        (jout, jlps), jstats = jax_server.generate_speculative(
            prompt, max_new_tokens=24, k=k, return_logprobs=True,
            return_stats=True)
        np.testing.assert_array_equal(out, ref, err_msg=f"k={k}")
        np.testing.assert_array_equal(out, np.asarray(jout))
        np.testing.assert_allclose(lps, ref_lp, atol=LP_TOL, rtol=0)
        np.testing.assert_allclose(lps, np.asarray(jlps), atol=JAX_LP_TOL,
                                   rtol=0)
        assert stats == jstats


def test_speculative_accepts_on_repetitive_decode(server):
    """The tiny model's greedy decode falls into cycles, where lookup
    drafts verify several tokens a step."""
    out = server.generate([5, 6, 7, 8], max_new_tokens=48)
    spec = server.generate_speculative([5, 6, 7, 8], max_new_tokens=48, k=8)
    np.testing.assert_array_equal(spec, out)
    stats = server.spec_stats
    assert stats["emitted"] >= 48 and stats["tokens_per_step"] > 1.0
    assert stats["steps"] < 48


def test_speculative_k1_degenerates_to_plain(server):
    """k = 1 buckets to the 2-chunk and equals plain decode; an engine at
    ``spec_k`` <= 1 is the plain engine."""
    ref = server.generate([5, 6, 7, 8], max_new_tokens=12)
    np.testing.assert_array_equal(
        server.generate_speculative([5, 6, 7, 8], max_new_tokens=12, k=1),
        ref)
    for k, want in ((0, 0), (1, 0), (3, 4), (8, 8)):
        assert ContinuousBatcher(server, spec_k=k).spec_k == want
    engine = _mk(server, spec_k=1)
    np.testing.assert_array_equal(
        engine.generate([5, 6, 7, 8], max_new_tokens=12), ref)


@pytest.mark.parametrize("where", [1, 3, 5])
def test_speculative_eos_latch_matches_plain(server, where):
    """An eos the model emits (inside an accepted block or at its edge)
    truncates and fills as plain ``generate``'s latch does, fused and
    streamed (the stream ends at the eos)."""
    free = server.generate([5, 6, 7, 8], max_new_tokens=12)[0]
    eos = int(free[where])
    ref = server.generate([5, 6, 7, 8], max_new_tokens=12, eos_id=eos)
    out = server.generate_speculative([5, 6, 7, 8], max_new_tokens=12,
                                      k=8, eos_id=eos)
    np.testing.assert_array_equal(out, ref)
    got = np.concatenate(list(server.generate_speculative_stream(
        [5, 6, 7, 8], max_new_tokens=12, k=8, eos_id=eos)), axis=1)
    np.testing.assert_array_equal(got, ref[:, :got.shape[1]])
    assert got[0, -1] == eos


@pytest.mark.parametrize("knobs", [{}, SEEDED], ids=["greedy", "sampled"])
def test_speculative_stream_matches_fused(server, knobs):
    """Concatenated stream chunks are the fused output (logprobs too),
    one chunk a verify step, and the stream's counters are the fused
    call's."""
    (fused, flp), stats = server.generate_speculative(
        [5, 6, 7, 8], max_new_tokens=16, k=4, return_logprobs=True,
        return_stats=True, **knobs)
    out_stats = {}
    pairs = list(server.generate_speculative_stream(
        [5, 6, 7, 8], max_new_tokens=16, k=4, return_logprobs=True,
        stats_out=out_stats, **knobs))
    np.testing.assert_array_equal(
        np.concatenate([p[0] for p in pairs], axis=1), fused)
    np.testing.assert_array_equal(
        np.concatenate([p[1] for p in pairs], axis=1), flp)
    assert out_stats == stats and len(pairs) == stats["steps"]


def test_speculative_composes_with_prefix(server):
    """From a cached prefix K/V: the output is plain ``generate(prefix +
    suffix)``'s and the full prompt's speculative output, fused and
    streamed; the prefix feeds the lookup drafts."""
    prefix, suffix = list(range(1, 20)), [4, 5]
    plain = server.generate(prefix + suffix, max_new_tokens=16)
    full = server.generate_speculative(prefix + suffix, max_new_tokens=16,
                                       k=4)
    via, stats = server.generate_speculative(
        suffix, max_new_tokens=16, k=4, prefix=prefix, return_stats=True)
    np.testing.assert_array_equal(via, full)
    np.testing.assert_array_equal(via, plain)
    assert stats["steps"] >= 1
    st = np.concatenate(list(server.generate_speculative_stream(
        suffix, max_new_tokens=16, k=4, prefix=prefix)), axis=1)
    np.testing.assert_array_equal(st, full)


def test_speculative_near_window_falls_back(server):
    """No room for a verify chunk near ``max_len`` (128): plain decode,
    the same output, counted under ``row_fallbacks``."""
    metrics = server.spec_metrics
    before = metrics.report()["row_fallbacks"].get("near_window", 0)
    prompt = list(range(1, 100))
    ref = server.generate(prompt, max_new_tokens=28)
    out, stats = server.generate_speculative(prompt, max_new_tokens=28, k=8,
                                             return_stats=True)
    np.testing.assert_array_equal(out, ref)
    assert stats["fallback"] == "plain"
    st = np.concatenate(list(server.generate_speculative_stream(
        prompt, max_new_tokens=28, k=8)), axis=1)
    np.testing.assert_array_equal(st, ref)
    assert metrics.report()["row_fallbacks"]["near_window"] == before + 2
    with pytest.raises(ValueError, match="single-row"):
        server.generate_speculative([[1, 2], [3, 4]], max_new_tokens=4)


def test_speculative_under_int8_kv_cache(weights):
    """Under ``kv_quant="int8"`` the verify rows read the quantized cache
    the one-token steps read: greedy tokens are plain decode's."""
    srv = treg.get("llama-tiny").build(
        extra={**EXTRA, "kv_quant": "int8"}).make_server(weights[2],
                                                          device="cpu")
    ref = srv.generate([5, 6, 7, 8], max_new_tokens=16)
    for k in (2, 4):
        np.testing.assert_array_equal(
            srv.generate_speculative([5, 6, 7, 8], max_new_tokens=16, k=k),
            ref, err_msg=f"k={k}")


def test_sampled_speculative_deterministic_and_composes(server):
    """``temperature > 0``: deterministic per seed, varying across seeds,
    ``top_k = 1`` collapses to greedy speculation, and the verify graph
    keys (kb, greedy or sampled) are reused across requests."""
    a = server.generate_speculative([5, 6, 7], max_new_tokens=10, k=4,
                                    temperature=1.2, seed=42)
    np.testing.assert_array_equal(a, server.generate_speculative(
        [5, 6, 7], max_new_tokens=10, k=4, temperature=1.2, seed=42))
    draws = [server.generate_speculative([5, 6, 7], max_new_tokens=10, k=4,
                                         temperature=1.2, seed=s)
             for s in range(6)]
    assert any(not np.array_equal(draws[0], d) for d in draws[1:])
    g = server.generate_speculative([5, 6, 7], max_new_tokens=10, k=4)
    t1 = server.generate_speculative([5, 6, 7], max_new_tokens=10, k=4,
                                     temperature=2.0, top_k=1, seed=9)
    np.testing.assert_array_equal(g, t1)
    keys = server.program_stats()["decode_buckets"]
    server.generate_speculative([9, 8], max_new_tokens=10, k=4,
                                temperature=0.7, top_p=0.9, seed=3)
    assert server.program_stats()["decode_buckets"] == keys


# -- the engine: spec_k ----------------------------------------------------------


REQUESTS = [(_prompt(1, 9) * 2, 20, {}), (_prompt(2, 5), 14, SEEDED),
            ([5, 6, 7, 8] * 3, 24, {}),
            (_prompt(3, 7), 11, {"temperature": 1.1, "seed": 4})]


def _concurrent(engine, requests=REQUESTS, stagger=0.01):
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


def _engine(server, paged: bool, **kw):
    pool = None
    if paged:
        pool = make_engine(server, {"batch_max": "4", "kv_paged": "1",
                                    "prefix_block": "16"}).pool
    return _mk(server, page_pool=pool, **kw)


_spec_off: dict = {}


def _reference(server, paged, depth):
    """The spec-off engine's rows, once per (paged, depth)."""
    if (paged, depth) not in _spec_off:
        _spec_off[paged, depth] = _concurrent(
            _engine(server, paged, spec_k=0, pipeline_depth=depth))
    return _spec_off[paged, depth]


def _assert_rows(got, want):
    for i, ((t, lp), (wt, wlp)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(t, wt, err_msg=f"row {i}")
        np.testing.assert_allclose(lp, wlp, atol=LP_TOL, rtol=0,
                                   err_msg=f"row {i}")


@pytest.mark.parametrize("draft", ["lookup", "model-1", "model-full"])
@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_rows_are_the_spec_off_engines(server, paged, depth, draft):
    """The engine at ``spec_k = 8`` (lookup drafts, the model tier at
    ``draft_exit`` 1 and at full depth), dense and paged, pipeline depth
    1 and 2: every row, greedy and seeded-sampled, emits the spec-off
    engine's tokens (logprobs within ``LP_TOL``). Full-depth model drafts
    are the target chain itself: every greedy draft is accepted."""
    mode, _, depth_kw = draft.partition("-")
    kw = {"draft_mode": mode}
    if depth_kw:
        kw["draft_exit"] = (server.model.cfg.layers if depth_kw == "full"
                            else int(depth_kw))
    engine = _engine(server, paged, pipeline_depth=depth, **kw)
    metrics = engine.spec_metrics = SpecDecodeStats()
    _assert_rows(_concurrent(engine), _reference(server, paged, depth))
    stats = engine.stats()
    assert stats["verify_segments"] >= 1 and stats["replays"] == 0
    assert stats["spec"]["draft_mode"] == mode
    if draft == "model-full":
        greedy = _engine(server, paged, pipeline_depth=depth, **kw)
        greedy.spec_metrics = full = SpecDecodeStats()
        greedy.generate([5, 6, 7, 8], max_new_tokens=30)
        assert full.report()["acceptance_rate"] == 1.0
    if mode == "model":
        assert stats["draft_forwards"] >= 1
        assert set(metrics.report()["draft"]["k_hist"]) <= {"2", "4", "8"}
    if paged:
        # the last rows retire at the barrier after their waiters wake
        deadline = time.monotonic() + 30
        while engine.stats()["active_rows"] and time.monotonic() < deadline:
            time.sleep(0.01)
        assert engine.pool.stats()["pages_live"] == 0


def test_engine_eos_inside_accepted_block(server):
    """An eos inside an accepted block is cut on the host as the plain
    engine cuts it, fused and streamed."""
    free = server.generate([5, 6, 7, 8] * 3, max_new_tokens=16)[0]
    engine = _mk(server)
    for where in (2, 6):
        eos = int(free[where])
        ref = server.generate([5, 6, 7, 8] * 3, max_new_tokens=16,
                              eos_id=eos)
        np.testing.assert_array_equal(
            engine.generate([5, 6, 7, 8] * 3, max_new_tokens=16,
                            eos_id=eos), ref)
        st = np.concatenate(list(engine.generate_stream(
            [5, 6, 7, 8] * 3, max_new_tokens=16, eos_id=eos)), axis=1)
        np.testing.assert_array_equal(st, ref[:, :st.shape[1]])


def test_engine_replays_a_failure_under_spec(server, monkeypatch):
    """A failure mid-speculation replays the row through a restarted
    engine, bitwise its first attempt's tokens, whatever the new drafts
    propose (the replay re-drafts from scratch)."""
    ref = server.generate([5, 6, 7, 8], max_new_tokens=12, temperature=0.8,
                          seed=9)
    engine = _mk(server, max_replays=1)
    real, calls = engine._spec_draft, {"n": 0}

    def flaky(entry, kb, q, k):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected draft-time failure")
        return real(entry, kb, q, k)

    monkeypatch.setattr(engine, "_spec_draft", flaky)
    out = engine.generate([5, 6, 7, 8], max_new_tokens=12, temperature=0.8,
                          seed=9)
    np.testing.assert_array_equal(out, ref)
    assert engine.fault_stats.replays_attempted >= 1


def test_model_draft_garbage_writes_change_no_bit(server, monkeypatch):
    """The shallow draft writes its K/V into the real cache; the verify
    rewrites every such position before any query reads it. A draft that
    fills those positions (and every later one of its rows) with garbage
    and proposes garbage tokens changes no emitted bit."""
    real = tl.VerifyStep._shallow_draft

    def garbage(self):
        drafts = real(self)
        for entry in self.step.cache:
            for name, val in tl._leaves(entry).items():
                if self.step.tables is None and not name.endswith("scale"):
                    for r in range(self.step.rows):
                        p = int(self.step.pos[r])
                        val[r, p:] = 1e3
        return (drafts * 7 + 3) % self.step.model.cfg.vocab_size

    monkeypatch.setattr(tl.VerifyStep, "_shallow_draft", garbage)
    engine = _engine(server, False, draft_mode="model")
    _assert_rows(_concurrent(engine), _reference(server, False, 2))


def test_model_draft_budget_shorter_than_k(server):
    """A row whose budget is shorter than the verify width lands bitwise:
    the collector cuts the overshoot."""
    engine = _mk(server, draft_mode="model", draft_exit=2)
    for n in (1, 3):
        np.testing.assert_array_equal(
            engine.generate([5, 6, 7, 8], max_new_tokens=n),
            server.generate([5, 6, 7, 8], max_new_tokens=n))


def test_spec_row_init_and_adapt(server):
    """The adaptive-k state machine, driven directly as the JAX suite
    drives it: lookup keeps a fixed k; the model tier slow-starts at 2,
    grows to ``spec_k`` on acceptance, shrinks on collapse and at k = 2
    demotes model -> lookup -> off, counted; a step collected after its
    row was demoted feeds the EWMA but does not re-tune k; lookup mode is
    inert."""
    assert _mk(server, spec_k=4)._spec_row_init() == ("lookup", 4)
    assert _mk(server, spec_k=4,
               draft_mode="model")._spec_row_init() == ("model", 2)
    assert _mk(server, draft_mode="off")._spec_row_init() == ("off", 1)
    assert _mk(server, spec_k=0,
               draft_mode="model")._spec_row_init() == ("off", 1)
    engine = _mk(server, spec_k=4, draft_mode="model")
    metrics = engine.spec_metrics = SpecDecodeStats()
    entry = {"draft_mode": "model", "k_row": 2, "accept_ewma": None}
    engine._spec_adapt(entry, "model", 2, 2)
    assert entry["k_row"] == 4 and entry["accept_ewma"] == 1.0
    engine._spec_adapt(entry, "model", 4, 4)
    assert entry["k_row"] == 4
    for _ in range(3):
        engine._spec_adapt(entry, "model", 4, 1)
    assert entry["k_row"] == 2 and entry["draft_mode"] == "model"
    while entry["draft_mode"] == "model":
        engine._spec_adapt(entry, "model", 2, 1)
    assert entry == {"draft_mode": "lookup", "k_row": 2,
                     "accept_ewma": None}
    engine._spec_adapt(entry, "lookup", 2, 1)
    assert entry["draft_mode"] == "off" and entry["k_row"] == 1
    assert metrics.report()["draft"]["fallbacks"] == {"model->lookup": 1,
                                                      "lookup->off": 1}
    stale = {"draft_mode": "lookup", "k_row": 2, "accept_ewma": None}
    engine._spec_adapt(stale, "model", 4, 4)
    assert stale["k_row"] == 2 and stale["accept_ewma"] == 1.0
    legacy = {"draft_mode": "lookup", "k_row": 4, "accept_ewma": None}
    _mk(server, spec_k=4)._spec_adapt(legacy, "lookup", 4, 1)
    assert legacy == {"draft_mode": "lookup", "k_row": 4,
                      "accept_ewma": None}


def test_spec_decode_stats_report_matches_jax():
    """The counters' report is the JAX object's for the same steps."""
    from lambdipy_tpu.runtime.metrics import SpecDecodeStats as JaxStats

    ours, theirs = SpecDecodeStats(), JaxStats()
    for stats in (ours, theirs):
        stats.record_step(proposed=7, accepted=3, emitted=4, hit=True)
        stats.record_step(proposed=1, accepted=0, emitted=1, hit=False,
                          provider="model", k=2)
        stats.record_fallback("near_window")
        stats.record_draft_fallback("model->lookup")
    assert ours.report() == theirs.report()


# -- the handler ---------------------------------------------------------------


def _handler(weights, extra):
    return generate_handler(
        {"model": "llama-tiny", "dtype": "float32",
         "extra": {**EXTRA, "prefix_cache_mb": "0", "warm_group_prefill": "0",
                   **extra}},
        HandlerContext(device="cpu", state_dict=weights[2]))


def _jax_handler(extra):
    ctx = SimpleNamespace(params_dir=None, bundle_dir=None, manifest=None)
    return jax_generate_handler(
        {"model": "llama-tiny", "dtype": "float32",
         "extra": {**EXTRA, "serve_aot": "0", "warm_group_prefill": "0",
                   "prefix_cache_mb": "0", **extra}}, ctx)


def test_handler_spec_extras_and_speculative_field(weights, monkeypatch):
    """The engine takes ``spec_k``, ``draft_mode`` and ``draft_exit`` as
    the JAX handler passes them (extra before the ``LAMBDIPY_*``
    environment; ``aux`` with no provider serves ``lookup``); a
    ``"speculative": k`` request is served solo with JAX's tokens and
    counters, streamed too, and ``/metrics`` carries the ``spec`` block
    (the engine's ``batching.spec`` reads the same counters)."""
    extra = {"batch_mode": "continuous", "batch_max": "2",
             "batch_segment": "4", "spec_k": "3", "draft_mode": "model",
             "draft_exit": "9"}
    state = _handler(weights, extra)
    engine = state.engine
    assert (engine.spec_k, engine.draft_mode, engine.draft_exit) == (
        4, "model", 2)
    assert engine.spec_metrics is state.server.spec_metrics
    monkeypatch.setenv("LAMBDIPY_SPEC_K", "8")
    monkeypatch.setenv("LAMBDIPY_DRAFT_MODE", "aux")
    env = _handler(weights, {"batch_mode": "continuous"}).engine
    assert (env.spec_k, env.draft_mode, env.draft_exit) == (8, "lookup", 1)
    monkeypatch.delenv("LAMBDIPY_SPEC_K")
    monkeypatch.delenv("LAMBDIPY_DRAFT_MODE")
    jstate = _jax_handler(extra)
    body = {"tokens": [5, 6, 7, 8], "max_new_tokens": 12,
            "speculative": 4, "logprobs": True}
    got, jgot = state.invoke(body), jstate.invoke(body)
    assert got["ok"] and jgot["ok"]
    assert got["tokens"] == jgot["tokens"]
    np.testing.assert_allclose(got["logprobs"], jgot["logprobs"],
                               atol=JAX_LP_TOL, rtol=0)
    assert got["speculative"] == jgot["speculative"]
    stats, jstats = state.stats(), jstate.stats()
    assert set(stats["spec"]) == set(jstats["spec"])
    assert stats["spec"] == jstats["spec"]
    recs = list(state.invoke_stream({**body, "stream": True}))
    assert [t for r in recs[:-1] for t in r["tokens"][0]] \
        == got["tokens"][0]
    assert recs[-1]["done"] and recs[-1]["speculative"] \
        == got["speculative"]
    plain = state.invoke({"tokens": [5, 6, 7, 8], "max_new_tokens": 12})
    assert plain["tokens"] == got["tokens"]
    stats = state.stats()
    spec_block = stats["batching"]["spec"]
    assert (spec_block["k"], spec_block["draft_mode"],
            spec_block["draft_exit"]) == (4, "model", 2)
    assert spec_block["steps"] >= stats["spec"]["steps"]
    bad = state.invoke({**body, "tokens": [[1, 2], [3, 4]]})
    # HandlerState.invoke adds latency_ms (a wall time), as JAX's does
    assert isinstance(bad.pop("latency_ms"), float)
    assert bad == {"ok": False, "error": "speculative decoding is "
                                         "single-row"}


def test_verify_graphs_replay_and_count_as_steps(weights):
    """On stand-in graphs every verify (host drafts and the model tier)
    is a replay of a graph captured on its key's first run; the engine's
    rows are still the spec-off engine's, and no step runs eagerly."""
    from tests.test_torch_graphs import FakeGraph

    srv = treg.get("llama-tiny").build(extra=EXTRA).make_server(
        weights[2], device="cpu", graphs=FakeGraph)
    eager = treg.get("llama-tiny").build(extra=EXTRA).make_server(
        weights[2], device="cpu")
    for mode in ("lookup", "model"):
        engine = _mk(srv, draft_mode=mode, pipeline_depth=2)
        _assert_rows(_concurrent(engine),
                     _concurrent(_mk(eager, spec_k=0, pipeline_depth=2)))
        stats = engine.stats()
        assert stats["eager_steps"] == 0
        assert stats["replays"] == stats["steps"] >= stats["verify_segments"]
        assert stats["verify_segments"] >= 1
    solo = srv.generate_speculative([5, 6, 7, 8], max_new_tokens=20, k=8)
    np.testing.assert_array_equal(
        solo, eager.generate([5, 6, 7, 8], max_new_tokens=20))
    assert srv.program_stats()["eager_steps"] == 0


def test_engine_verify_keys_are_bounded(server):
    """The verify programs an engine holds are keyed by ``kb``, greedy or
    sampled, the draft's exit layer and chain or rejection sampling."""
    engine = _mk(server, draft_mode="model", spec_k=4)
    _concurrent(engine, REQUESTS[:2])
    keys = [k for k in engine._programs.programs if k[0] == "verify"]
    assert keys and all(k[1] in (2, 4) and k[3] in (0, engine.draft_exit)
                        and k[4] == "chain" for k in keys)
