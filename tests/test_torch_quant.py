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
