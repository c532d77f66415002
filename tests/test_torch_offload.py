"""The port's host offload tier (``lambdipy_tpu_torch/runtime/offload.py``
and the prefix store's spill and re-online) against
``lambdipy_tpu/runtime/offload.py`` and ``tests/test_long_context.py``, on
the CPU: the arena's gauges and counters equal the JAX arena's op for op
on one seeded sequence, the stored and re-framed bytes are the JAX
arena's (exact), the ``offload_stall`` site delays and fails as in JAX,
and through ``llama-tiny`` (f32) a spilled-and-re-onlined head serves
rows bitwise the rows before the spill, a dropped entry or an armed stall
prunes the ghosts and recomputes (counted, still bitwise), and the
handler builds the arena from ``kv_offload`` / ``kv_offload_mb`` as the
JAX handler does."""

import time

import jax
import numpy as np
import pytest
import torch

from lambdipy_tpu.models import registry as jreg
from lambdipy_tpu.runtime import faults as jfaults
from lambdipy_tpu.runtime import offload as joff
from lambdipy_tpu_torch.models import registry as treg
from lambdipy_tpu_torch.models.llama import arena_page_slices
from lambdipy_tpu_torch.models.params import from_jax_params
from lambdipy_tpu_torch.runtime import faults as tfaults
from lambdipy_tpu_torch.runtime import offload as toff
from lambdipy_tpu_torch.runtime.handlers import (HandlerContext,
                                                 generate_handler,
                                                 make_engine)
from lambdipy_tpu_torch.runtime.prefixstore import PrefixStore

BLOCK = 16
EXTRA = {"attn_backend": "blocked"}
PAGED = {"batch_max": "4", "batch_segment": "4", "kv_paged": "1",
         "prefix_block": "16"}


def _np_block(seed=0, layers=2, kvh=2, d=4):
    rng = np.random.default_rng(seed)
    return [{"k": rng.random((1, BLOCK, kvh, d), dtype=np.float32),
             "v": rng.random((1, BLOCK, kvh, d), dtype=np.float32)}
            for _ in range(layers)]


def _t_block(block):
    return [{k: torch.from_numpy(v.copy()) for k, v in e.items()}
            for e in block]


def _bytes(block) -> bytes:
    return b"".join(np.asarray(v).tobytes() for entry in block
                    for _, v in sorted(entry.items()))


def test_arena_gauges_equal_jax_op_for_op():
    """One seeded sequence of spills (some past the budget), fetches,
    frames, misses and drops through both arenas: the same return values,
    fetched bytes, frames and ``report()`` after every operation."""
    per = len(_bytes(_np_block()))
    budget = 5.5 * per / 2**20
    ja = joff.OffloadArena(page=BLOCK, layers=2, budget_mb=budget)
    ta = toff.OffloadArena(page=BLOCK, layers=2, budget_mb=budget)
    rng = np.random.default_rng(7)
    for step in range(60):
        op = int(rng.integers(0, 5))
        key = ("k", int(rng.integers(0, 8)))
        keys = [("k", int(k)) for k in rng.integers(0, 8, size=3)]
        if op <= 1:
            blk = _np_block(seed=step)
            toks = tuple(range(step, step + BLOCK))
            assert ja.spill(key, toks, blk) \
                == ta.spill(key, toks, _t_block(blk))
        elif op == 2:
            try:
                jout = ja.fetch_many(keys)
            except joff.OffloadMiss:
                with pytest.raises(toff.OffloadMiss):
                    ta.fetch_many(keys)
            else:
                tout = ta.fetch_many(keys)
                assert [_bytes(b) for b in jout] == [_bytes(b) for b in tout]
                assert ja.frames(keys) == ta.frames(keys)
        elif op == 3:
            assert ja.drop(keys) == ta.drop(keys)
        else:
            assert ja.contains(key) == ta.contains(key)
            if ja.contains(key):
                assert ja.tokens_of(key) == ta.tokens_of(key)
        assert ta.report() == ja.report() and len(ta) == len(ja)


def test_roundtrip_bitwise_and_single_template_encode():
    """Spill, two batched fetches (one frame decode each), drop: the bytes
    back are the bytes in, the template was derived once, and a dropped
    key misses."""
    arena = toff.OffloadArena(page=BLOCK, layers=2)
    blocks = {("b", i): _np_block(seed=i) for i in range(3)}
    for i, (key, blk) in enumerate(blocks.items()):
        assert arena.spill(key, tuple(range(i * BLOCK, (i + 1) * BLOCK)),
                           _t_block(blk))
    for _ in range(2):
        got = arena.fetch_many(list(blocks))
        assert [_bytes(b) for b in got] == [_bytes(b)
                                            for b in blocks.values()]
    rep = arena.report()
    assert rep["template_encodes"] == 1 and rep["frame_decodes"] == 2
    assert rep["reonline_pages"] == 6
    arena.drop(list(blocks))
    with pytest.raises(toff.OffloadMiss):
        arena.fetch_many([("b", 0)])


@pytest.mark.parametrize("kind", ["delay", "exception"])
def test_offload_stall_acts_as_in_jax(kind):
    """``offload_stall:delay`` stalls a fetch by its ``ms``;
    ``offload_stall:exception`` fails one fetch and the entry serves
    afterwards, in both packages."""
    blk = _np_block()
    spec = f"offload_stall:{kind}" + ("@ms=80" if kind == "delay" else "")
    for mod, plans, block in ((joff, jfaults, blk),
                              (toff, tfaults, _t_block(blk))):
        arena = mod.OffloadArena(page=BLOCK, layers=2,
                                 faults=plans.FaultPlan.from_spec(spec))
        assert arena.spill(("k", 0), tuple(range(BLOCK)), block)
        t0 = time.monotonic()
        if kind == "exception":
            with pytest.raises(plans.InjectedFault):
                arena.fetch_many([("k", 0)])
        out = arena.fetch_many([("k", 0)])
        if kind == "delay":
            assert time.monotonic() - t0 >= 0.05
        assert _bytes(out[0]) == _bytes(blk)


def test_page_temperature_matches_jax():
    jt, tt = joff.PageTemperature(), toff.PageTemperature()
    rng = np.random.default_rng(3)
    for _ in range(30):
        keys = [int(k) for k in rng.integers(0, 10, size=3)]
        for t in (jt, tt):
            t.touch(keys[:2])
            t.forget(keys[2:])
        assert tt.coldest(range(10), 4) == jt.coldest(range(10), 4)


# -- the store's spill and re-online ------------------------------------------


@pytest.fixture(scope="module")
def weights():
    adapter = jreg.get("llama-tiny").build(extra=EXTRA)
    return from_jax_params(jax.tree_util.tree_map(
        np.asarray, adapter.init_params(seed=0)))


@pytest.fixture
def server(weights):
    return treg.get("llama-tiny").build(extra=EXTRA).make_server(
        weights, device="cpu")


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(5, 100, size=n).tolist()


def _store(server, budget_mb=64.0, faults=None):
    engine = make_engine(server, PAGED)
    if faults is not None:
        engine.faults.arm(faults)
    store = PrefixStore(server, block=BLOCK, pool=engine.pool)
    engine.prefix_pages_fn = store.acquire_pages
    arena = toff.OffloadArena(page=BLOCK, layers=server.model.cfg.layers,
                              budget_mb=budget_mb, faults=engine.faults)
    store.attach_offload(arena)
    return engine, store, arena


def _idle(engine, timeout=10.0):
    """Wait for the engine to retire its rows (their page refs drop)."""
    deadline = time.monotonic() + timeout
    with engine._lock:
        while engine._engine_running and time.monotonic() < deadline:
            engine._lock.wait(0.05)
    assert not engine._engine_running


def _routed(engine, store, row, **kw):
    m = store.route(row)
    out = engine.generate(row[m:], prefix=row[:m], max_new_tokens=8,
                          return_logprobs=True, **kw)
    _idle(engine)
    return m, out


def _page_bytes(pool, pids) -> list:
    with pool.arena_lock:
        blocks = arena_page_slices(pool.ensure_arena(), pids)
    return [b"".join(v.numpy().tobytes() for entry in blk
                     for _, v in sorted(entry.items())) for blk in blocks]


def test_spill_and_reonline_round_trip_is_bitwise(server):
    """A routed head spilled page by page (deepest first), exported while
    partly spilled (the whole head, bitwise), re-onlined by the next hit
    in one batch: the pages hold the bytes they held, and the row is
    bitwise the row served before the spill (tokens and logprobs)."""
    engine, store, arena = _store(server)
    row = _prompt(67, seed=9)
    m, want = _routed(engine, store, row, temperature=0.8, seed=3)
    assert m == 64
    head, before = store.export_blocks(row)
    pids, _ = store.acquire_pages(row[:m])
    pages = _page_bytes(engine.pool, pids)
    engine.pool.release(pids)
    assert store.reclaim_pages(1) == 1 and store.reclaim_pages(1) == 1
    inv = store.check_invariants()
    assert inv["ok"] and inv["offloaded_blocks"] == 2 and inv["blocks"] == 2
    head2, mixed = store.export_blocks(row)
    assert head2 == head
    for a, b in zip(mixed, before):
        assert all(torch.equal(a[i][k], b[i][k]) for i in range(len(a))
                   for k in a[i])
    while store.reclaim_pages(4):
        pass
    assert store.check_invariants()["offloaded_blocks"] == 4
    m2, got = _routed(engine, store, row, temperature=0.8, seed=3)
    assert m2 == m
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    pids, _ = store.acquire_pages(row[:m])
    assert _page_bytes(engine.pool, pids) == pages
    engine.pool.release(pids)
    rep = engine.pool.stats()["kv_offload"]
    # the partly spilled export read 2 pages, the hit 4, one batch each
    assert rep["spill_pages"] == 4 and rep["reonline_pages"] == 6
    assert rep["reonline_batches"] == 2 and rep["recomputes"] == 0
    assert rep["offloaded_pages"] == 0 and rep["template_encodes"] == 1
    assert store.check_invariants()["ok"]
    engine.pool.check_invariants()


@pytest.mark.parametrize("cause", ["dropped", "offload_stall"])
def test_failed_reonline_prunes_and_recomputes(server, cause):
    """Spilled entries the arena no longer holds (a budget drop: an
    ``OffloadMiss``), or an armed ``offload_stall`` exception: the ghosts
    are pruned, the head is walked again, the recompute is counted and
    the row is bitwise the row before the spill."""
    engine, store, arena = _store(server)
    row = _prompt(67, seed=11)
    m, want = _routed(engine, store, row)
    while store.reclaim_pages(4):
        pass
    assert store.check_invariants()["offloaded_blocks"] == m // BLOCK
    if cause == "dropped":
        arena.drop(list(arena._entries))
    else:
        engine.faults.arm("offload_stall:exception")
    walked = store.prefill_stats.report()["rounds"]
    m2, got = _routed(engine, store, row)
    assert m2 == m
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    rep = engine.pool.stats()["kv_offload"]
    assert rep["recomputes"] == m // BLOCK and rep["reonlines"] == 0
    assert rep["offloaded_pages"] == 0
    assert store.prefill_stats.report()["rounds"] > walked
    inv = store.check_invariants()
    assert inv["ok"] and inv["offloaded_blocks"] == 0
    engine.pool.check_invariants()


def test_spill_refused_past_the_budget_drops_the_page(server):
    """An offload arena full to its budget refuses the next spill: the
    victim is dropped (its subtree pruned), counted as a refusal."""
    engine, store, arena = _store(server,
                                  budget_mb=1.5 * engine_page_bytes(server)
                                  / 2**20)
    row = _prompt(67, seed=12)
    store.route(row)
    assert store.reclaim_pages(1) == 1 and store.reclaim_pages(1) == 1
    rep = engine.pool.stats()["kv_offload"]
    assert rep["spill_pages"] == 1 and rep["spill_refusals"] == 1
    inv = store.check_invariants()
    assert inv["ok"] and inv["offloaded_blocks"] == 0 and inv["blocks"] == 2
    engine.pool.check_invariants()


def engine_page_bytes(server) -> int:
    from lambdipy_tpu_torch.models.llama import page_kv_bytes

    return page_kv_bytes(server.model.cfg, BLOCK)


@pytest.mark.parametrize("extra,env,want", [
    ({}, {}, None),
    ({"kv_offload": "1"}, {}, 256 * 2**20),
    ({"kv_offload": "1", "kv_offload_mb": "8"}, {}, 8 * 2**20),
    ({"kv_offload": "1", "kv_offload_mb": "8"},
     {"LAMBDIPY_KV_OFFLOAD_MB": "4"}, 4 * 2**20),
    ({}, {"LAMBDIPY_KV_OFFLOAD": "1"}, 256 * 2**20),
    ({"kv_offload": "0"}, {"LAMBDIPY_KV_OFFLOAD": "1"}, None),
], ids=["off", "on", "mb", "env-mb-first", "env-on", "extra-first"])
def test_handler_builds_the_arena_as_jax_does(weights, monkeypatch, extra,
                                              env, want):
    """``kv_offload`` (the extra before ``LAMBDIPY_KV_OFFLOAD``) attaches
    an arena of ``kv_offload_mb`` (``LAMBDIPY_KV_OFFLOAD_MB`` first; 256
    MB) to a paged engine's store, reported under
    ``batching.page_pool.kv_offload``; a dense engine gets none."""
    for key in ("LAMBDIPY_KV_OFFLOAD", "LAMBDIPY_KV_OFFLOAD_MB"):
        monkeypatch.delenv(key, raising=False)
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    for paged in (True, False):
        eng = {**PAGED, "batch_mode": "continuous"}
        if not paged:
            eng.pop("kv_paged")
        state = generate_handler({"model": "llama-tiny",
                                  "extra": {**EXTRA, **eng, "warm_group_prefill": "0",
                                            **extra}},
                                 HandlerContext(device="cpu",
                                                state_dict=weights))
        arena = state.prefix_store.offload
        if want is None or not paged:
            assert arena is None
            assert "kv_offload" not in state.stats()["batching"].get(
                "page_pool", {})
        else:
            assert arena.budget_bytes == want
            assert state.stats()["batching"]["page_pool"]["kv_offload"][
                "offload_budget_bytes"] == want
