"""The port's MicroBatcher (``lambdipy_tpu_torch/runtime/batching.py``)
mirroring ``tests/test_batching.py`` on ``llama-tiny`` (f32, JAX's weights
carried over) on the CPU: concurrent requests share one ragged call,
mismatched knobs fuse, every row is bitwise its solo ``generate``, errors
surface per request, batch sizes are bucketed, no thread is conscripted.
Greedy rows are token-exact against the JAX package's ``LlamaServer`` on
the same weights (a JAX MicroBatcher row is its solo call's, as
``tests/test_batching.py`` holds); sampled rows against the port's solo
call (the port's sampling stream is its own, ROADMAP §3). A fused call
prefills each row at its own width (the port's fusion rule, the last
test); on the CPU its logprobs agree with the solo call's within 1e-5
(JAX's tolerance in ``tests/test_batching.py``): PyTorch's CPU matmul may
sum a row in another order at another row count. On the card the int8
kernels compute each row alone and the rows are bitwise
(``chip_smoke.py``'s MicroBatcher leg)."""

import json
import threading
import time
import urllib.request

import jax
import numpy as np
import pytest

from lambdipy_tpu.models import registry as jreg
from lambdipy_tpu_torch.models import registry as treg
from lambdipy_tpu_torch.models.params import from_jax_params
from lambdipy_tpu_torch.runtime.batching import MicroBatcher
from lambdipy_tpu_torch.runtime.handlers import (HandlerContext,
                                                 generate_handler)
from lambdipy_tpu_torch.runtime.server import BundleServer, sched_config

EXTRA = {"attn_backend": "blocked"}


@pytest.fixture(scope="module")
def weights():
    adapter = jreg.get("llama-tiny").build(extra=EXTRA)
    params = adapter.init_params(seed=0)
    return adapter.make_server(params), from_jax_params(
        jax.tree_util.tree_map(np.asarray, params))


@pytest.fixture(scope="module")
def server(weights):
    return treg.get("llama-tiny").build(extra=EXTRA).make_server(
        weights[1], device="cpu")


@pytest.fixture(scope="module")
def jax_server(weights):
    return weights[0]


def _fire(fn_list):
    results, errors = [None] * len(fn_list), [None] * len(fn_list)

    def call(i):
        try:
            results[i] = fn_list[i]()
        except Exception as e:  # noqa: BLE001 - surfaced by the assert
            errors[i] = e

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(fn_list))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not any(errors), errors
    return results


def _jax(jax_server, prompt, n, **kw):
    return np.asarray(jax_server.generate(prompt, max_new_tokens=n, **kw))


def test_batched_greedy_matches_solo(server, jax_server):
    """Concurrent greedy requests produce exactly the solo results (the
    JAX server's tokens too) and run as fewer calls than requests."""
    prompts = [[5, 6, 7, 8, 9], [1, 2, 3], [9, 8, 7, 6], [2, 4, 6, 8, 10, 12]]
    solo = [server.generate(p, max_new_tokens=6) for p in prompts]
    batcher = MicroBatcher(server, window_ms=150, max_batch=8)
    results = _fire([
        lambda p=p: batcher.generate(np.asarray(p, np.int32),
                                     max_new_tokens=6)
        for p in prompts])
    for got, want, p in zip(results, solo, prompts):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, _jax(jax_server, p, 6))
    stats = batcher.stats()
    assert stats["rows_served"] == len(prompts)
    assert stats["batches_run"] < len(prompts), stats  # actually batched
    assert stats["pending"] == 0


def test_mismatched_knobs_fuse_with_parity(server, jax_server):
    """Requests with unrelated sampling knobs share one call (per-row
    knob operands) and each row equals its solo output, greedy and
    sampled side by side; the greedy rows equal JAX's."""
    reqs = [
        dict(prompt=[5, 6, 7], kw={}),
        dict(prompt=[1, 2], kw=dict(temperature=0.9, seed=1)),
        dict(prompt=[8, 9], kw=dict(temperature=0.9, seed=2)),
        dict(prompt=[3, 3, 3], kw=dict(top_k=None, eos_id=7)),
    ]
    solo = [server.generate(r["prompt"], max_new_tokens=4, **r["kw"])
            for r in reqs]
    batcher = MicroBatcher(server, window_ms=150, max_batch=8)
    results = _fire([
        lambda r=r: batcher.generate(np.asarray(r["prompt"], np.int32),
                                     max_new_tokens=4, **r["kw"])
        for r in reqs])
    for i, (got, want) in enumerate(zip(results, solo)):
        np.testing.assert_array_equal(got, want, err_msg=f"request {i}")
    for i in (0, 3):
        np.testing.assert_array_equal(
            results[i], _jax(jax_server, reqs[i]["prompt"], 4,
                             **reqs[i]["kw"]))
    stats = batcher.stats()
    assert stats["batches_run"] < len(reqs), stats  # actually fused
    assert stats["pending"] == 0


def test_greedy_fuses_across_inert_knobs(server, jax_server):
    """At temperature 0 seed, top_k and top_p are inert, so requests that
    differ only in those share one call."""
    prompts = [[5, 6, 7], [1, 2, 3], [9, 8, 7, 6], [2, 4, 6]]
    solo = [server.generate(p, max_new_tokens=4) for p in prompts]
    batcher = MicroBatcher(server, window_ms=150, max_batch=8)
    results = _fire([
        lambda i=i, p=p: batcher.generate(
            np.asarray(p, np.int32), max_new_tokens=4, temperature=0.0,
            seed=1000 + i, top_k=(None, 5, 17, None)[i],
            top_p=(None, 0.9, None, 0.5)[i])
        for i, p in enumerate(prompts)])
    for got, want, p in zip(results, solo, prompts):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, _jax(jax_server, p, 4))
    stats = batcher.stats()
    assert stats["batches_run"] < len(prompts), stats  # actually fused


def test_mixed_max_new_sliced_per_request(server, jax_server):
    """Batched requests may ask for different token counts; each gets
    exactly what it asked for."""
    batcher = MicroBatcher(server, window_ms=150)
    results = _fire([
        lambda: batcher.generate(np.asarray([5, 6, 7], np.int32),
                                 max_new_tokens=3),
        lambda: batcher.generate(np.asarray([5, 6, 7], np.int32),
                                 max_new_tokens=9),
    ])
    shapes = sorted(r.shape for r in results)
    assert shapes == [(1, 3), (1, 9)]
    longest = max(results, key=lambda r: r.shape[1])
    np.testing.assert_array_equal(longest, _jax(jax_server, [5, 6, 7], 9))


def test_window_zero_bypasses_queue(server):
    batcher = MicroBatcher(server, window_ms=0)
    out = batcher.generate(np.asarray([5, 6, 7], np.int32), max_new_tokens=4)
    assert out.shape == (1, 4)
    assert batcher.stats()["batches_run"] == 0  # direct path, no queue


def test_error_surfaces_per_request(server):
    """A failing request (past the window) raises in its caller; the
    batcher and server stay healthy for the next request."""
    batcher = MicroBatcher(server, window_ms=20)
    with pytest.raises(ValueError):
        batcher.generate(np.arange(1, 100, dtype=np.int32),
                         max_new_tokens=120)
    out = batcher.generate(np.asarray([5, 6, 7], np.int32), max_new_tokens=4)
    assert out.shape == (1, 4)


def test_http_concurrent_invokes_are_batched(weights):
    """Through the handler and the threaded HTTP server: concurrent greedy
    invokes share calls; ``/metrics`` shows the batcher's counters; a
    batching handler floors the scheduler's concurrency at ``batch_max``
    (JAX ``server.py:211-215``)."""
    extra = {**EXTRA, "max_new_tokens": "4", "batch_window_ms": "100",
             "batch_max": "12"}
    assert sched_config(extra).max_concurrency == 12
    state = generate_handler(
        {"model": "llama-tiny", "dtype": "float32", "extra": extra},
        HandlerContext(device="cpu", state_dict=weights[1]))
    assert state.batcher is not None and state.engine is None
    srv = BundleServer(state, port=0).start_background()

    def post(payload):
        req = urllib.request.Request(
            f"{srv.url}/invoke", data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    try:
        post({"tokens": [1, 2, 3]})  # warm the bucket
        results = _fire([
            lambda i=i: post({"tokens": [1, 2, 3 + i]}) for i in range(4)])
        assert all(r["ok"] and r["n_new"] == 4 for r in results)
        with urllib.request.urlopen(f"{srv.url}/metrics", timeout=30) as r:
            metrics = json.loads(r.read())
        batching = metrics["handler"]["batching"]
        assert batching["rows_served"] >= 5
        assert batching["batches_run"] < batching["rows_served"], batching
        assert metrics["sched"]["max_concurrency"] == 12
    finally:
        srv.stop()


def test_batcher_splits_incompatible_fusions(server):
    """Two requests each valid solo but whose fused shape exceeds max_len
    (llama-tiny: 128) are served in separate calls, both succeeding."""
    long_prompt = list(range(1, 105))   # 104 + 20 = 124 <= 128 solo
    batcher = MicroBatcher(server, window_ms=100)
    calls = [
        lambda: batcher.generate(np.asarray(long_prompt, np.int32),
                                 max_new_tokens=20),
        lambda: batcher.generate(np.asarray([1, 2, 3, 4], np.int32),
                                 max_new_tokens=28),  # 4 + 28 solo ok
    ]
    results = _fire(calls)
    shapes = sorted(r.shape for r in results)
    assert shapes == [(1, 20), (1, 28)]
    assert batcher.stats()["batches_run"] == 2  # could not fuse


def test_batch_size_is_bucketed(weights):
    """Distinct batch sizes reuse power-of-two bucketed programs: a batch
    of 3 runs in the 4-row program."""
    fresh = treg.get("llama-tiny").build(extra=EXTRA).make_server(
        weights[1], device="cpu")
    fresh.generate([[1, 2], [3, 4], [5, 6]], max_new_tokens=4)   # b=3 -> 4
    fresh.generate([[1, 2], [3, 4], [5, 6], [7, 8]], max_new_tokens=4)
    buckets = fresh.program_stats()["decode_buckets"]
    assert len(buckets) == 1 and buckets[0][:2] == [4, 32], buckets


def test_sustained_load_every_request_returns(server):
    """Sustained back-to-back load: no thread is conscripted into serving
    the queue forever; every request returns."""
    batcher = MicroBatcher(server, window_ms=10, max_batch=4)
    n_threads, per_thread = 4, 5
    results = [[] for _ in range(n_threads)]
    errors = []

    def worker(i):
        try:
            for j in range(per_thread):
                out = batcher.generate(
                    np.asarray([1 + i, 2 + j, 3], np.int32), max_new_tokens=4)
                results[i].append(out)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads), "a request never returned"
    assert not errors, errors
    assert all(len(r) == per_thread for r in results)
    assert batcher.stats()["pending"] == 0


def test_decode_cap_incompatibility_splits(weights):
    """A request whose max_new exceeds what the fused batch may use is
    split out, not fused into a batch the cap would reject."""
    capped = treg.get("llama-tiny").build(extra=EXTRA).make_server(
        weights[1], device="cpu", decode_cap=16)
    batcher = MicroBatcher(capped, window_ms=100)
    results = _fire([
        lambda: batcher.generate(np.asarray([1, 2, 3], np.int32),
                                 max_new_tokens=4),
        lambda: batcher.generate(np.asarray([4, 5, 6], np.int32),
                                 max_new_tokens=16),
    ])
    shapes = sorted(r.shape for r in results)
    assert shapes == [(1, 4), (1, 16)]


def test_sampled_requests_stay_seed_deterministic(server):
    """The same (prompt, seed) sampled request returns identical tokens
    whatever shares its call: each row's stream comes from its own
    seed."""
    batcher = MicroBatcher(server, window_ms=50, max_batch=8)

    def sampled():
        return batcher.generate(np.asarray([5, 6, 7], np.int32),
                                max_new_tokens=6, temperature=1.2, seed=42)

    alone = sampled()
    mixed = _fire([sampled] + [
        lambda i=i: batcher.generate(np.asarray([1, 2, 3 + i], np.int32),
                                     max_new_tokens=6)
        for i in range(3)])
    np.testing.assert_array_equal(alone, mixed[0])
    np.testing.assert_array_equal(
        alone, server.generate([5, 6, 7], max_new_tokens=6, temperature=1.2,
                               seed=42))


def test_logprobs_ride_micro_batching(server, jax_server):
    """A logprob request fuses with a non-logprob neighbour and returns
    its solo tokens, logprobs within 1e-5; against the JAX server the
    same."""
    want_t, want_l = server.generate([5, 6, 7], max_new_tokens=5,
                                     return_logprobs=True)
    batcher = MicroBatcher(server, window_ms=150, max_batch=8)
    results = _fire([
        lambda: batcher.generate(np.asarray([5, 6, 7], np.int32),
                                 max_new_tokens=5, return_logprobs=True),
        lambda: batcher.generate(np.asarray([1, 2, 3], np.int32),
                                 max_new_tokens=5),
    ])
    toks, lps = results[0]
    np.testing.assert_array_equal(toks, want_t)
    np.testing.assert_allclose(lps, want_l, rtol=1e-5, atol=1e-5)
    jt, jl = jax_server.generate([5, 6, 7], max_new_tokens=5,
                                 return_logprobs=True)
    np.testing.assert_array_equal(toks, np.asarray(jt))
    np.testing.assert_allclose(lps, np.asarray(jl), rtol=1e-5, atol=1e-5)
    assert results[1].shape == (1, 5)
    assert batcher.stats()["batches_run"] < 2  # they fused


def test_full_batch_wakes_leader_early(server):
    """With max_batch requests queued, the leader drains without waiting
    out the (huge) window."""
    batcher = MicroBatcher(server, window_ms=30_000, max_batch=2)
    t0 = time.monotonic()
    results = _fire([
        lambda: batcher.generate(np.asarray([5, 6, 7], np.int32),
                                 max_new_tokens=4),
        lambda: batcher.generate(np.asarray([1, 2], np.int32),
                                 max_new_tokens=4),
    ])
    assert time.monotonic() - t0 < 20, "leader slept out the full window"
    assert all(r.shape == (1, 4) for r in results)


def test_rows_fuse_only_at_their_own_prefill_width(server):
    """The port's fusion rule (ROADMAP §3): a 20-token prompt (bucket 32)
    and a 3-token one (bucket 16) run as two calls, each row's tokens its
    solo call's (logprobs within 1e-5); two prompts of one bucket
    fuse."""
    batcher = MicroBatcher(server, window_ms=150, max_batch=8)
    reqs = [(list(range(1, 21)), {}), ([5, 6, 7], {"temperature": 0.9,
                                                   "seed": 5}),
            (list(range(30, 48)), {})]
    solo = [server.generate(p, max_new_tokens=6, return_logprobs=True, **kw)
            for p, kw in reqs]
    results = _fire([
        lambda p=p, kw=kw: batcher.generate(np.asarray(p, np.int32),
                                            max_new_tokens=6,
                                            return_logprobs=True, **kw)
        for p, kw in reqs])
    for (toks, lps), (st, sl) in zip(results, solo):
        np.testing.assert_array_equal(toks, st)
        np.testing.assert_allclose(lps, sl, rtol=1e-5, atol=1e-5)
    stats = batcher.stats()
    assert stats["rows_served"] == 3 and stats["batches_run"] == 2, stats
