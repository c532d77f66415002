"""The port's pipelined continuous engine (``pipeline_depth`` >= 2) on f32
``llama-tiny`` on the CPU, the twin of ``tests/test_continuous_pipeline.py``
plus the request context the engine now carries: depths 1, 2 and 3
bitwise each other, dense and paged, greedy and sampled, and their tokens
solo's; eos over-decode dropped exactly and counted; a mid-stream joiner
forcing a bounded drain; prefix rows and streams at depth 3; greedy
tokens equal to the JAX engine's at depth 2; the slot handoff in the
JAX engine's order under ``fair``; and barrier cancellation of an
expired deadline, freeing the row's slot and pages.

Tolerances: engine rows of any depth and layout share one slot count
and one cache width, so they agree bitwise, tokens and logprobs. Against
solo ``LlamaServer.generate`` tokens are exact and logprobs within 1e-5
(on the CPU the plain attention softmaxes over the engine's cache width
and the solo request's bucket, whose reductions may round apart)."""

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

import lambdipy_tpu.sched as jsched
from lambdipy_tpu.models import registry as jreg
from lambdipy_tpu.runtime.continuous import ContinuousBatcher as JaxBatcher
from lambdipy_tpu.sched.policy import make_policy as jax_make_policy
from lambdipy_tpu_torch.models import registry as treg
from lambdipy_tpu_torch.models.graphs import DEVICE_LOCK
from lambdipy_tpu_torch.models.params import from_jax_params
from lambdipy_tpu_torch.runtime.continuous import RequestCancelled
from lambdipy_tpu_torch.runtime.handlers import (HandlerContext,
                                                 generate_handler,
                                                 make_engine)
from lambdipy_tpu_torch.runtime.prefixstore import PrefixStore
from lambdipy_tpu_torch.sched import clear_request_context, set_request_context

EXTRA = {"attn_backend": "blocked"}
LP_TOL = 1e-5
ENGINES = {"dense": {"batch_max": "4", "batch_segment": "4"},
           "paged": {"batch_max": "4", "batch_segment": "4",
                     "kv_paged": "1", "prefix_block": "16"}}
SAMPLED = {"temperature": 0.9, "seed": 7}
REQS = [([1, 2, 3], 12, {}),
        ([9, 8, 7, 6], 12, SAMPLED),
        ([4, 4], 9, {"temperature": 1.2, "top_k": 3, "seed": 11}),
        (list(range(20, 41)), 17, {}),
        ([5, 6, 7, 8, 9], 6, {"temperature": 0.7, "top_p": 0.9, "seed": 3})]


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


def _engine(server, kind, depth, **extra):
    return make_engine(server, {**ENGINES[kind], **extra,
                                "pipeline_depth": str(depth)})


def _run(engine, reqs, stagger=0.01):
    """Each request from its own thread, ``stagger`` seconds apart:
    ``(tokens, logprobs)`` per request, in order."""
    def call(i):
        time.sleep(stagger * i)
        p, n, kw = reqs[i]
        return engine.generate(p, max_new_tokens=n, return_logprobs=True,
                               **kw)

    with ThreadPoolExecutor(max_workers=len(reqs)) as ex:
        return list(ex.map(call, range(len(reqs))))


def _idle(engine, timeout=10.0):
    """Wait for the engine thread to reach its idle barrier (the last
    blocks behind a finished row may still be draining)."""
    deadline = time.monotonic() + timeout
    with engine._lock:
        while engine._engine_running and time.monotonic() < deadline:
            engine._lock.wait(0.05)
    assert not engine._engine_running


def _slow_segments(engine, seconds: float) -> None:
    """Each dispatch held ``seconds`` first, so that a deadline or a
    closed stream reaches the engine mid-decode."""
    dispatch = engine._run_segment

    def slow(live):
        time.sleep(seconds)
        return dispatch(live)

    engine._run_segment = slow


def test_depths_are_bitwise_each_other_and_solo(server):
    """Greedy and seeded rows (one joining mid-flight) through depths 1,
    2 and 3, dense and paged: every engine's rows bitwise the depth-1
    dense engine's, tokens and logprobs, and each row's tokens solo's."""
    solo = [server.generate(p, max_new_tokens=n, return_logprobs=True, **kw)
            for p, n, kw in REQS]
    outs = {}
    for kind in ENGINES:
        for depth in (1, 2, 3):
            engine = _engine(server, kind, depth)
            outs[kind, depth] = _run(engine, REQS)
            _idle(engine)
            stats = engine.stats()
            assert stats["pipeline_depth"] == depth
            assert stats["requests_served"] == len(REQS)
            pipe = stats["pipeline"]
            assert pipe["segments"] == pipe["dispatches"] == \
                stats["segments"]
            assert max(int(d) for d in pipe["in_flight"]) <= depth
            if kind == "paged":
                assert stats["page_pool"]["pages_live"] == 0
                engine.pool.check_invariants()
    ref = outs["dense", 1]
    for key, got in outs.items():
        for (tok, lp), (want_tok, want_lp) in zip(got, ref):
            np.testing.assert_array_equal(tok, want_tok, err_msg=str(key))
            np.testing.assert_array_equal(lp, want_lp, err_msg=str(key))
    for (tok, lp), (want_tok, want_lp) in zip(ref, solo):
        np.testing.assert_array_equal(tok, want_tok)
        np.testing.assert_allclose(lp, want_lp, rtol=0, atol=LP_TOL)


@pytest.mark.parametrize("kind", ENGINES)
def test_eos_overdecode_truncated_exactly(server, kind):
    """A row whose eos lands in its first segment while later segments
    are already dispatched: the blocks behind it are dropped on the host
    and counted, and the output (eos, then eos filler) is solo's."""
    prompt = [5, 6, 7, 8]
    free = server.generate(prompt, max_new_tokens=16)[0]
    eos = int(free[2])
    solo = server.generate(prompt, max_new_tokens=16, eos_id=eos)
    engine = _engine(server, kind, 3, batch_max="2")
    out = engine.generate(prompt, max_new_tokens=16, eos_id=eos)
    np.testing.assert_array_equal(out, solo)
    _idle(engine)
    stats = engine.stats()
    pipe = stats["pipeline"]
    assert pipe["wasted_overdecode_tokens"] == 2 * 4, pipe
    assert pipe["drains"] == {"complete": 1}, pipe
    # the launch identity counts what was dispatched, over-decode included
    assert stats["steps"] == 3 * 4 and stats["segments"] == 3


def test_depth1_keeps_the_synchronous_frontier(server):
    """Depth 1 is the synchronous loop: every segment is booked before
    the next dispatch and no drain ever fires."""
    engine = _engine(server, "paged", 1, batch_max="2")
    out = engine.generate([1, 2, 3], max_new_tokens=12)
    np.testing.assert_array_equal(
        out, server.generate([1, 2, 3], max_new_tokens=12))
    pipe = engine.stats()["pipeline"]
    assert set(pipe["in_flight"]) == {"1"}, pipe
    assert pipe["drains"] == {} and pipe["wasted_overdecode_tokens"] == 0
    assert pipe["segments"] == pipe["dispatches"] == 3


@pytest.mark.parametrize("kind", ENGINES)
def test_midstream_joiner_forces_bounded_drain(server, kind):
    """A joiner arriving while a long row's segments are in flight drains
    the pipeline, packs at the barrier, and both rows are solo's; the
    frontier never exceeds the depth."""
    depth = 3
    engine = _engine(server, kind, depth)
    _slow_segments(engine, 0.005)  # 16 segments outlast the join
    long_prompt, late_prompt = [1, 2, 3, 4, 5], [9, 8, 7]
    solo_long = server.generate(long_prompt, max_new_tokens=64)
    solo_late = server.generate(late_prompt, max_new_tokens=8)
    out = {}

    def late():
        # join once the long row is mid-decode: 2 of its 16 segments
        # booked
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline \
                and engine.stats()["pipeline"]["segments"] < 2:
            time.sleep(0.002)
        out["late"] = engine.generate(late_prompt, max_new_tokens=8)

    t = threading.Thread(target=late)
    t.start()
    out["long"] = engine.generate(long_prompt, max_new_tokens=64)
    t.join()
    np.testing.assert_array_equal(out["long"], solo_long)
    np.testing.assert_array_equal(out["late"], solo_late)
    pipe = engine.stats()["pipeline"]
    assert max(int(d) for d in pipe["in_flight"]) == depth, pipe
    assert pipe["drains"].get("joiner", 0) >= 1, pipe
    assert 0 < pipe["overlap_ratio"] <= 1 and pipe["wall_s"] > 0


@pytest.mark.parametrize("kind", ENGINES)
def test_prefix_rows_and_streams_pipelined(server, kind):
    """Routed prefix rows (greedy and seeded) beside an unrouted row, and
    a streamed row with an eos, through a depth-3 engine: tokens solo's,
    logprobs within ``LP_TOL``; the stream's chunks concatenate to
    ``generate``'s up to the chunk holding eos."""
    engine = _engine(server, kind, 3)
    store = PrefixStore(server, block=16, budget_mb=8, pool=engine.pool)
    if engine.pool is not None:
        engine.prefix_pages_fn = store.acquire_pages
    shared = list(range(1, 34))
    reqs = [(shared + [40, 41], {}), (shared + [50, 51, 52], SAMPLED),
            ([9, 8, 7], {})]
    store.route(reqs[0][0])

    def run(i):
        row, kw = reqs[i]
        m = store.route(row)
        if m:
            return engine.generate(row[m:], prefix=row[:m], max_new_tokens=9,
                                   return_logprobs=True, **kw)
        return engine.generate(row, max_new_tokens=9, return_logprobs=True,
                               **kw)

    with ThreadPoolExecutor(max_workers=3) as ex:
        outs = list(ex.map(run, range(3)))
    for (row, kw), got in zip(reqs, outs):
        want = server.generate(row, max_new_tokens=9, return_logprobs=True,
                               **kw)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=LP_TOL)
    assert engine.stats()["prefix_joins"] == 2
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    want = server.generate(prompt, max_new_tokens=14)
    eos = int(want[0, 6])
    chunks = list(engine.generate_stream(prompt, max_new_tokens=14,
                                         eos_id=eos))
    got = np.concatenate(chunks, axis=1)[0]
    ref = server.generate(prompt, max_new_tokens=14, eos_id=eos)[0]
    np.testing.assert_array_equal(got, ref[:got.size])
    assert got[-1] == eos and all(c.shape[1] <= 4 for c in chunks)
    _idle(engine)
    # the shared prefix blocks kept their K/V through the rows' garbage
    # steps past their quota: a later hit still gives solo's tokens
    row, kw = reqs[1]
    np.testing.assert_array_equal(run(1)[0], server.generate(
        row, max_new_tokens=9, **kw))
    _idle(engine)
    if engine.pool is not None:
        assert engine.pool.stats()["pages_live"] == store.stats()["blocks"]
        assert store.check_invariants()["ok"]


def test_greedy_tokens_equal_the_jax_engine_at_depth_2(weights, server):
    """The JAX ContinuousBatcher at pipeline depth 2 and the port's dense
    and paged engines at depth 2, on the same weights and the same
    concurrent greedy traffic: the same tokens."""
    adapter, params, _ = weights
    jax_engine = JaxBatcher(adapter.make_server(params), slots=4, segment=4,
                            window_bucketing=False, pipeline_depth=2)
    reqs = [(p, n, {}) for p, n, _ in REQS]
    with ThreadPoolExecutor(max_workers=len(reqs)) as ex:
        want = list(ex.map(lambda r: jax_engine.generate(
            r[0], max_new_tokens=r[1]), reqs))
    for kind in ENGINES:
        got = _run(_engine(server, kind, 2), reqs)
        for (tok, _), w in zip(got, want):
            np.testing.assert_array_equal(tok, np.asarray(w))


JOIN_CLASSES = ["background", "batch", "interactive", "batch",
                "interactive", "background", "interactive"]


def _handoff_order(engine, set_context, prefill_attr, hold) -> list:
    """One slot, a long row decoding, then seven joiners of
    ``JOIN_CLASSES`` queued behind it: the order their prompts reach the
    engine's prefill (one joiner per barrier, as the slot frees)."""
    seen = []
    prefill = getattr(engine, prefill_attr)

    def recording(entries, *args, **kwargs):
        seen.extend(int(e["row"][0]) for e in entries)
        return prefill(entries, *args, **kwargs)

    setattr(engine, prefill_attr, recording)
    first = threading.Thread(target=lambda: engine.generate(
        [1, 2, 3], max_new_tokens=100))
    first.start()
    deadline = time.monotonic() + 30
    while not engine._active[0] and time.monotonic() < deadline:
        time.sleep(0.001)

    def join(i):
        set_context(cls=JOIN_CLASSES[i])
        engine.generate([100 + i, 7, 7], max_new_tokens=4)

    with hold():
        threads = [threading.Thread(target=join, args=(i,))
                   for i in range(len(JOIN_CLASSES))]
        for i, t in enumerate(threads):
            t.start()  # one at a time: arrival order is the index order
            while len(engine._joiners) <= i and time.monotonic() < deadline:
                time.sleep(0.001)
        # every joiner queued while the long row still holds the slot
        assert len(engine._joiners) == len(JOIN_CLASSES)
        assert not engine._active[0]["done"]
    for t in [first, *threads]:
        t.join(timeout=60)
    return [s - 100 for s in seen if s >= 100]


def test_slot_handoff_order_under_fair_equals_the_jax_engine(weights,
                                                             server):
    """Under ``fair``, the order the joiners get the one slot is the JAX
    engine's for the same entries (the weighted interleave, carried from
    barrier to barrier), and not arrival order. The JAX engine is slowed
    by its synthetic fetch delay (25 segments of 60 ms for the long row)
    so that the joiners queue before its long row ends; the port's engine
    is held off the card meanwhile."""
    adapter, params, _ = weights
    jax_engine = JaxBatcher(adapter.make_server(params), slots=1, segment=4,
                            window_bucketing=False, pipeline_depth=2,
                            policy=jax_make_policy("fair"),
                            synthetic_fetch_rtt_ms=60.0)
    want = _handoff_order(jax_engine, jsched.set_request_context,
                          "_prefill_group", lambda: _Nothing())
    engine = _engine(server, "paged", 2, batch_max="1", kv_pages="32")
    assert engine.policy.name == "fair"
    got = _handoff_order(engine, set_request_context, "_prefill_rows",
                         lambda: DEVICE_LOCK)
    assert sorted(got) == list(range(len(JOIN_CLASSES)))
    assert got == want
    assert got != list(range(len(JOIN_CLASSES)))


class _Nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("kind", ENGINES)
def test_expired_deadline_raises_and_frees_its_slot(server, kind):
    """A row whose deadline passes mid-decode fails with
    ``RequestCancelled`` at the next barrier (the pipeline drains for
    it), and a joiner whose deadline passes while queued fails too; the
    slot and the pages go back, and a neighbour row is still solo's."""
    engine = _engine(server, kind, 2, batch_max="1", kv_pages="32")
    _slow_segments(engine, 0.03)  # 30 segments: ~0.9 s for the long row
    neighbour = threading.Thread(target=lambda: out.setdefault(
        "n", engine.generate([4, 5, 6], max_new_tokens=6)))
    out = {}
    errors = {}

    def expiring(key, prompt, deadline_ms, n):
        set_request_context(deadline_ms=deadline_ms)
        try:
            engine.generate(prompt, max_new_tokens=n)
        except RequestCancelled as e:
            errors[key] = str(e)
        finally:
            clear_request_context()

    first = threading.Thread(target=expiring,
                             args=("row", [1, 2, 3], 400.0, 120))
    first.start()
    deadline = time.monotonic() + 30
    while not engine._active[0] and time.monotonic() < deadline:
        time.sleep(0.001)
    queued = threading.Thread(target=expiring,
                              args=("joiner", [7, 8, 9], 50.0, 4))
    queued.start()
    for t in (first, queued):
        t.join(timeout=60)
    neighbour.start()
    neighbour.join(timeout=60)
    assert "barrier" in errors["row"] and "deadline" in errors["row"]
    assert "queued" in errors["joiner"]
    np.testing.assert_array_equal(
        out["n"], server.generate([4, 5, 6], max_new_tokens=6))
    _idle(engine)
    stats = engine.stats()
    assert stats["cancelled"] == 2 and stats["requests_served"] == 1
    assert stats["pipeline"]["drains"].get("cancel", 0) >= 1
    assert engine._active == [None] and not engine._joiners
    if kind == "paged":
        assert stats["page_pool"]["pages_live"] == 0
        engine.pool.check_invariants()


def test_abandoned_stream_is_cancelled_at_the_next_barrier(server):
    """A stream whose reader goes away after the first chunk leaves its
    row without a waiter: the engine cancels it instead of decoding the
    rest, and its pages go back."""
    engine = _engine(server, "paged", 2)
    _slow_segments(engine, 0.01)
    stream = engine.generate_stream([1, 2, 3], max_new_tokens=120)
    next(stream)
    stream.close()
    _idle(engine)
    stats = engine.stats()
    assert stats["cancelled"] == 1 and stats["steps"] < 120
    assert stats["page_pool"]["pages_live"] == 0


def test_handler_pipeline_depth_extra_and_environment(monkeypatch):
    """``pipeline_depth`` from the extra, then ``LAMBDIPY_PIPELINE_DEPTH``,
    then 2; below 1 raises."""
    def depth(extra):
        return generate_handler(
            {"model": "llama-tiny",
             "extra": {"batch_mode": "continuous", **extra}},
            HandlerContext(device="cpu")).engine.pipeline_depth

    monkeypatch.delenv("LAMBDIPY_PIPELINE_DEPTH", raising=False)
    assert depth({}) == 2
    monkeypatch.setenv("LAMBDIPY_PIPELINE_DEPTH", "3")
    assert depth({}) == 3
    assert depth({"pipeline_depth": "1"}) == 1
    with pytest.raises(ValueError, match="pipeline_depth"):
        depth({"pipeline_depth": "0"})
