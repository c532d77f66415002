"""The port's page allocator (``lambdipy_tpu_torch/runtime/pagepool.py``)
against the JAX package's ``PagePool``: the same alloc / retain / release
sequence gives the same page ids and the same stats, op for op; a double
free raises; exhaustion is priced backpressure; a seeded fuzz keeps every
invariant; the arena is built once, lazily."""

import numpy as np
import pytest

from lambdipy_tpu.runtime import pagepool as jpp
from lambdipy_tpu_torch.runtime import pagepool as tpp


def _pools(n_pages=17, page=16, page_bytes=1024):
    kw = {"n_pages": n_pages, "page": page, "page_bytes": page_bytes,
          "window_pages": 4}
    return jpp.PagePool(**kw), tpp.PagePool(**kw)


def _same_stats(jax_pool, port_pool):
    want = jax_pool.stats()
    got = port_pool.stats()
    # the EWMA price depends on wall-clock release gaps; everything else
    # must agree exactly
    for stats in (want, got):
        stats.pop("retry_after_s")
    assert {k: got[k] for k in want} == want
    assert set(got) - set(want) == {"pages_live_peak"}


@pytest.mark.parametrize("max_len,block", [(128, 16), (128, 48), (96, 32),
                                           (8192, 32), (100, 16), (64, 1)])
def test_page_width_matches_jax(max_len, block):
    assert tpp.page_width(max_len, block) == jpp.page_width(max_len, block)


def test_op_for_op_against_jax_pool():
    jp, tp = _pools()
    ops = [("alloc", 3, 40), ("alloc", 2, 17), ("retain", 0), ("alloc", 4, 64),
           ("release", 1), ("alloc", 1, 5), ("retain", 2), ("release", 0),
           ("release", 0), ("release", 2), ("alloc", 5, 70), ("release", 2),
           ("release", 3)]
    held_j, held_t = [], []
    for op in ops:
        if op[0] == "alloc":
            pj = jp.alloc(op[1], tokens=op[2])
            pt = tp.alloc(op[1], tokens=op[2])
            assert pt == pj
            held_j.append(pj)
            held_t.append(pt)
        elif op[0] == "retain":
            jp.retain(held_j[op[1]])
            tp.retain(held_t[op[1]])
        else:
            jp.release(held_j[op[1]])
            tp.release(held_t[op[1]])
        _same_stats(jp, tp)
        assert [tp.refcount(p) for p in range(17)] == \
            [jp.refcount(p) for p in range(17)]
        tp.check_invariants()
    assert tp.stats()["pages_live_peak"] == 10


def test_double_free_and_bad_retain_raise():
    _, pool = _pools()
    pids = pool.alloc(2)
    pool.release(pids)
    with pytest.raises(ValueError, match="double free"):
        pool.release(pids)
    with pytest.raises(ValueError, match="unallocated"):
        pool.retain(pids)
    pool.release([tpp.NULL_PAGE])  # the null page is inert
    pool.check_invariants()


def test_exhaustion_is_priced_backpressure():
    _, pool = _pools(n_pages=5)
    pool.alloc(3)
    with pytest.raises(tpp.PagesExhausted) as exc:
        pool.alloc(2)
    assert exc.value.needed == 2 and exc.value.free == 1
    assert 0.5 <= exc.value.retry_after_s <= 30.0
    assert pool.stats()["sheds"] == 1
    assert pool.alloc(0) == [] and pool.alloc(-1) == []


def test_fuzz_alloc_share_release_keeps_invariants():
    rng = np.random.default_rng(0)
    jp, tp = _pools(n_pages=33, page=8)
    held = []  # (jax ids, port ids) per holder
    for _ in range(1500):
        r = rng.random()
        if r < 0.45:
            n = int(rng.integers(1, 6))
            try:
                pj = jp.alloc(n, tokens=int(rng.integers(0, 8 * n + 1)))
            except jpp.PagesExhausted:
                with pytest.raises(tpp.PagesExhausted):
                    tp.alloc(n)
                continue
            pt = tp.alloc(n, tokens=sum(jp._tokens[p] for p in pj))
            held.append((pj, pt))
        elif r < 0.6 and held:
            pj, pt = held[int(rng.integers(len(held)))]
            jp.retain(pj)
            tp.retain(pt)
            held.append((pj, pt))
        elif held:
            pj, pt = held.pop(int(rng.integers(len(held))))
            jp.release(pj)
            tp.release(pt)
        tp.check_invariants()
    _same_stats(jp, tp)
    for pj, pt in held:
        jp.release(pj)
        tp.release(pt)
    tp.check_invariants()
    assert tp.stats()["pages_live"] == 0


def test_arena_is_built_once_on_first_use():
    made = []
    pool = tpp.PagePool(n_pages=4, page=8, page_bytes=64,
                        make_arena=lambda: made.append(1) or ["arena"])
    assert pool.arena is None and made == []
    assert pool.ensure_arena() == ["arena"]
    assert pool.ensure_arena() == ["arena"] and made == [1]
    with pytest.raises(RuntimeError, match="arena factory"):
        tpp.PagePool(n_pages=4, page=8, page_bytes=64).ensure_arena()
    with pytest.raises(ValueError):
        tpp.PagePool(n_pages=1, page=8, page_bytes=64)
