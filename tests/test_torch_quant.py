"""The port's int8 weight-only matmul (``lambdipy_tpu_torch/ops/quant.py``)
against the JAX package's Pallas kernel in interpret mode, at decode and
prefill row counts with f32 and bf16 activations. The CUDA kernel itself
is held against the plain version on the card in
``tests/test_torch_kernels.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lambdipy_tpu.ops import quant as jq
from lambdipy_tpu_torch.ops import quant as tq

K, N, BLOCK = 128, 192, 64


def _inputs(m, k=K, n=N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    scale = ((rng.random((1, n)) + 0.5) / (127 * k ** 0.5)).astype(np.float32)
    return x, w, scale


def _tol(dtype, ref):
    """Both sides multiply bf16 values exactly in f32 and differ only in
    the order of the f32 sums: f32 output agrees to ~1e-6 relative; a bf16
    output may land one bf16 ulp (2^-8 relative) apart."""
    peak = float(np.abs(ref).max())
    return (1e-5 if dtype == "float32" else 2.0 ** -7) * peak


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 8, 64])
def test_plain_matches_pallas_kernel_interpret(m, dtype):
    x, w, scale = _inputs(m, seed=m)
    want = jq.int8_matmul(jnp.asarray(x, getattr(jnp, dtype)),
                          jnp.asarray(w), jnp.asarray(scale), block_m=BLOCK,
                          block_n=BLOCK, block_k=BLOCK, interpret=True)
    got = tq.int8_matmul_reference(torch.as_tensor(x).to(getattr(torch, dtype)),
                                   torch.as_tensor(w), torch.as_tensor(scale))
    assert got.dtype == getattr(torch, dtype) and got.shape == (m, N)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=_tol(dtype, want))


def test_plain_rounds_like_the_kernel_not_like_the_jax_reference():
    """The JAX reference folds the scale into bf16 weights before the
    product; the kernel (and the port at every shape) scales the f32 sum.
    With bf16 activations the two differ by rounding."""
    x, w, scale = _inputs(8, seed=9)
    xb = jnp.asarray(x, jnp.bfloat16)
    kernel = np.asarray(jq.int8_matmul(xb, jnp.asarray(w), jnp.asarray(scale),
                                       block_m=BLOCK, block_n=BLOCK,
                                       block_k=BLOCK, interpret=True)
                        .astype(jnp.float32))
    folded = np.asarray(jq.int8_matmul_reference(
        xb, jnp.asarray(w), jnp.asarray(scale)).astype(jnp.float32))
    port = tq.int8_matmul_reference(torch.as_tensor(x).bfloat16(),
                                    torch.as_tensor(w),
                                    torch.as_tensor(scale)).float().numpy()
    assert np.abs(port - kernel).max() < np.abs(port - folded).max()
    np.testing.assert_allclose(port, folded, rtol=0, atol=0.05 * np.abs(folded).max())


def test_wrapper_on_cpu_runs_plain_version_without_counting():
    x, w, scale = (torch.as_tensor(a) for a in _inputs(4, seed=3))
    before = tq.int8_matmul.launches
    assert torch.equal(tq.int8_matmul(x, w, scale),
                       tq.int8_matmul_reference(x, w, scale))
    assert tq.int8_matmul.launches == before


@pytest.mark.parametrize("bad", ["float_weights", "scale_shape",
                                 "inner_dim", "int_x"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x, w, scale = (torch.as_tensor(a) for a in _inputs(4, seed=4))
    if bad == "float_weights":
        w = w.float()
    elif bad == "scale_shape":
        scale = scale[0]
    elif bad == "inner_dim":
        x = x[:, :-1]
    else:
        x = x.long()
    with pytest.raises(ValueError):
        tq.int8_matmul(x, w, scale)


@pytest.mark.parametrize("name", ["llama3-8b", "llama-tiny"])
def test_every_qdense_shape_meets_the_tiled_contract(name):
    """Every projection of the registry's models takes the tiled route
    (prefill at m > 8) in the model's dtype and in f32 (the lm_head's
    logits path): the kernel's 16-byte-stride contract holds, so no
    prefill ever meets the wrapper's ValueError."""
    from lambdipy_tpu_torch.models import registry
    from lambdipy_tpu_torch.models.llama import LlamaModel, QDense

    cfg = registry.get(name).build(quant="int8").config
    dense = [mod for mod in LlamaModel(cfg, device="meta").modules()
             if isinstance(mod, QDense)]
    assert len(dense) == 7 * cfg.layers + 1
    for mod in dense:
        for dtype in (cfg.dtype, torch.float32):
            assert tq.tiled_shape_error(mod.in_features, mod.features,
                                        dtype) is None, (mod.in_features,
                                                         mod.features)


@pytest.mark.parametrize("k,n,dtype,ok", [
    (4096, 128256, torch.float32, True), (264, 144, torch.bfloat16, True),
    (64, 24, torch.bfloat16, False), (68, 32, torch.bfloat16, False),
    (68, 32, torch.float32, True), (66, 32, torch.float32, False)])
def test_tiled_contract_follows_the_row_strides(k, n, dtype, ok):
    """n % 16 in either dtype; k % 8 for bf16 x, k % 4 for f32 x."""
    assert (tq.tiled_shape_error(k, n, dtype) is None) is ok


@pytest.mark.parametrize("b,s,route", [
    (1, 1, "gemv"), (8, 1, "gemv"), (16, 1, "gemv"), (64, 1, "gemv"),
    (1, 16, "tiled"), (4, 16, "tiled"), (1, 128, "tiled"), (8, 128, "tiled"),
], ids=lambda v: str(v))
def test_qdense_picks_the_route_by_positions_per_row(b, s, route):
    """The route comes from the caller's input shape, not the flattened
    row count alone: one position per row (a decode step over b slots,
    the lm_head at the logit positions) takes the GEMV at any b, so an
    engine row keeps its solo bits past 8 slots; a prefill ``[b, s >=
    16]`` takes the tiled route, also at b * s = 16."""
    from lambdipy_tpu_torch.models.llama import QDense

    x = torch.zeros(b, s, 64)
    assert tq.int8_route(b * s, rows_alone=QDense.rows_alone(x)) == route


def test_int8_route_default_for_callers_that_do_not_say():
    """A caller that passes no word keeps the kernel's default: the GEMV
    for m <= 8, the tiled route above; so does a 2-D activation through
    QDense."""
    from lambdipy_tpu_torch.models.llama import QDense

    assert QDense.rows_alone(torch.zeros(16, 64)) is None
    assert [tq.int8_route(m) for m in (1, 8, 9, 16)] == [
        "gemv", "gemv", "tiled", "tiled"]
    assert tq.int8_route(4, rows_alone=False) == "tiled"


def test_qdense_on_cpu_is_the_plain_version_on_every_route():
    """On the CPU the route word changes nothing: QDense's int8 product
    at one position per row and at a prefill shape is the plain version,
    bitwise, and no launch is counted."""
    from lambdipy_tpu_torch.models.llama import QDense

    dense = QDense(K, N, "int8", torch.float32, "pallas", device="cpu")
    _, w, scale = _inputs(1, seed=5)
    dense.kernel_int8.copy_(torch.as_tensor(w))
    dense.scale.copy_(torch.as_tensor(scale))
    rng = np.random.default_rng(6)
    before = tq.int8_matmul.launches
    for shape in ((16, 1, K), (2, 16, K)):
        x = torch.as_tensor(rng.normal(size=shape).astype(np.float32))
        want = tq.int8_matmul_reference(x.reshape(-1, K), dense.kernel_int8,
                                        dense.scale).reshape(*shape[:2], N)
        assert torch.equal(dense(x), want)
    assert tq.int8_matmul.launches == before


# k x n of QDense layers in both registry models, ragged shapes and the
# edges of the plan (one k step, one split, the most splits)
PLAN_SHAPES = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
               (4096, 128256), (64, 64), (64, 32), (128, 64), (64, 512),
               (264, 152), (264, 144), (37, 24), (1, 8), (16, 16),
               (100_000, 1024), (2048, 2048)]


def _qdense_shapes(name):
    from lambdipy_tpu_torch.models import registry
    from lambdipy_tpu_torch.models.llama import LlamaModel, QDense

    cfg = registry.get(name).build(quant="int8").config
    return sorted({(mod.in_features, mod.features)
                   for mod in LlamaModel(cfg, device="meta").modules()
                   if isinstance(mod, QDense)})


@pytest.mark.parametrize("k,n", PLAN_SHAPES, ids=lambda v: str(v))
def test_gemv_plan_covers_k_exactly(k, n):
    """The splits, in order, cover rows 0 .. k - 1 once each: no gap, no
    overlap, no empty split; the depth is whole 16-deep steps for each of
    a block's warps, and there are at most GEMV_MAX_SPLITS splits (the C
    entry point refuses any other plan)."""
    splits, depth = tq.gemv_plan(k, n)
    assert 1 <= splits <= tq.GEMV_MAX_SPLITS
    assert depth % (tq.GEMV_STEP * tq.GEMV_WARPS) == 0
    ranges = [(s * depth, min(k, (s + 1) * depth)) for s in range(splits)]
    assert all(lo < hi for lo, hi in ranges)
    covered = [r for lo, hi in ranges for r in range(lo, hi)]
    assert covered == list(range(k))


def test_gemv_plan_is_a_function_of_k_and_n_alone():
    """The plan takes the weight's shape and nothing else, so no row
    count, dtype or device can change the order a row is summed in (the
    bits of an engine row at any slot count rest on it)."""
    import inspect

    assert list(inspect.signature(tq.gemv_plan).parameters) == ["k", "n"]
    for k, n in PLAN_SHAPES:
        assert tq.gemv_plan(k, n) == tq.gemv_plan(k, n)


@pytest.mark.parametrize("name", ["llama3-8b", "llama-tiny"])
def test_gemv_plan_fills_the_card_at_every_qdense_shape(name):
    """Through the registry, every projection's plan fills the H100: at
    least 1.5 waves of blocks over its 132 SMs, or as many splits as the
    shape or the kernel allows (GEMV_MAX_SPLITS, one warp step each);
    and no more than one wave of two blocks an SM unless one split
    already makes more (measured: a second, partial wave costs more than
    it overlaps)."""
    for k, n in _qdense_shapes(name):
        splits, depth = tq.gemv_plan(k, n)
        blocks = -(-n // tq.gemv_block_cols(n)) * splits
        steps = -(-k // tq.GEMV_STEP)
        at_most = splits == tq.GEMV_MAX_SPLITS or depth == (
            tq.GEMV_STEP * tq.GEMV_WARPS) or splits == -(-steps // tq.GEMV_WARPS)
        assert blocks >= 1.5 * tq.GEMV_SMS or at_most, (k, n, splits)
        assert blocks <= tq.GEMV_BLOCKS or splits == 1, (k, n, splits)
        if name == "llama3-8b":
            assert blocks >= 128, (k, n, splits)


def test_gemv_geometry_is_the_c_sources():
    """The plan's constants are the kernel's: ``GV_*`` in
    ``csrc/int8_matmul.cu`` read from the source text (the library also
    checks them when it loads, on the card)."""
    import re
    from pathlib import Path

    src = (Path(tq.__file__).resolve().parent.parent / "csrc"
           / "int8_matmul.cu").read_text()
    const = {name: int(v) for name, v in re.findall(
        r"constexpr int (GV_\w+) = (\d+);", src)}
    assert (const["GV_WARPS"], const["GV_STEP"], const["GV_ROWS"],
            const["GV_MAX_SPLITS"], const["GV_WIDE_MIN_N"]) == (
        tq.GEMV_WARPS, tq.GEMV_STEP, tq.GEMV_ROWS, tq.GEMV_MAX_SPLITS,
        tq.GEMV_WIDE_MIN_N)
    assert "n % 16 == 0 && n >= GV_WIDE_MIN_N && m <= 16 ? 16 : 8" in src
    assert tq.gemv_block_cols(4096) == 128 and tq.gemv_block_cols(1024) == 64
    assert tq.gemv_block_cols(2056) == 64  # n % 16 != 0


@pytest.mark.parametrize("m", [1, 8, 16, 33, 64, 65])
@pytest.mark.parametrize("k,n", [(264, 152), (300, 64)], ids=["ragged", "split"])
def test_gemv_route_on_cpu_is_the_plain_version(m, k, n):
    """On the CPU the GEMV route at any row count, split or not, is the
    plain version bitwise, and no launch is counted."""
    x, w, scale = (torch.as_tensor(a) for a in _inputs(m, k, n, seed=m))
    before = tq.int8_matmul.launches
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype)
        assert torch.equal(tq.int8_matmul(xd, w, scale, rows_alone=True),
                           tq.int8_matmul_reference(xd, w, scale))
    assert tq.int8_matmul.launches == before
