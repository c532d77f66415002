"""The port's decode attention (``lambdipy_tpu_torch/ops/decode_attention.py``)
against the JAX package's: the plain PyTorch version against
``decode_attention_reference`` and against the Pallas kernel in interpret
mode, over ragged lengths, group sizes 1 and 4, f32 and bf16. The CUDA
kernel itself is held against the plain version on the card in
``tests/test_torch_kernels.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lambdipy_tpu.ops import decode_attention as jda
from lambdipy_tpu_torch.ops import decode_attention as tda

B, H, D, T, BLOCK = 4, 4, 32, 64, 16
# 1, a block boundary, one past it, the full window
ALEN = np.asarray([1, BLOCK, BLOCK + 1, T], np.int32)
# f32: the same einsums and softmax, summed in another order; bf16: the
# logits and probabilities are rounded to bf16 in both frameworks, at
# places where their kernels round differently by one bf16 ulp
TOL = {"float32": 1e-6, "bfloat16": 2e-2}
# the Pallas kernel runs an online softmax: another summation order
KERNEL_TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _inputs(kvh, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    k = rng.normal(size=(B, T, kvh, D)).astype(np.float32)
    v = rng.normal(size=(B, T, kvh, D)).astype(np.float32)
    return q, k, v


def _jax(x, dtype):
    return jnp.asarray(x, getattr(jnp, dtype))


def _torch(x, dtype):
    return torch.as_tensor(x).to(getattr(torch, dtype))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kvh", [4, 1], ids=["group1", "group4"])
def test_plain_matches_jax_reference(kvh, dtype):
    q, k, v = _inputs(kvh)
    want = jda.decode_attention_reference(
        _jax(q, dtype), _jax(k, dtype), _jax(v, dtype), jnp.asarray(ALEN))
    got = tda.decode_attention_reference(
        _torch(q, dtype), _torch(k, dtype), _torch(v, dtype),
        torch.as_tensor(ALEN))
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kvh", [4, 1], ids=["group1", "group4"])
def test_plain_matches_pallas_kernel_interpret(kvh, dtype):
    q, k, v = _inputs(kvh, seed=1)
    want = jda.blocked_decode_attention(
        _jax(q, dtype), _jax(k, dtype), _jax(v, dtype), jnp.asarray(ALEN),
        block_k=BLOCK, interpret=True)
    got = tda.decode_attention_reference(
        _torch(q, dtype), _torch(k, dtype), _torch(v, dtype),
        torch.as_tensor(ALEN))
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=KERNEL_TOL[dtype])


def test_plain_at_zero_length_is_mean_of_v():
    """At active_len 0 the plain version (like the JAX reference) gives
    the uniform mean of V; the port's kernel reproduces that, where the
    TPU kernel returns zeros."""
    q, k, v = _inputs(2, seed=2)
    alen = np.asarray([0, 3, 0, T], np.int32)
    got = tda.decode_attention_reference(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        torch.as_tensor(alen))
    want = jda.decode_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(alen))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    mean_v = np.repeat(v.mean(axis=1), H // 2, axis=1)  # [b, h, d]
    np.testing.assert_allclose(got.numpy()[0, 0], mean_v[0], atol=1e-5)


def test_wrapper_on_cpu_runs_plain_version_without_counting():
    q, k, v = (torch.as_tensor(x) for x in _inputs(2, seed=3))
    alen = torch.as_tensor(ALEN)
    before = tda.blocked_decode_attention.launches
    out = tda.decode_attention(q, k, v, alen)
    assert torch.equal(out, tda.decode_attention_reference(q, k, v, alen))
    assert tda.blocked_decode_attention.launches == before


@pytest.mark.parametrize("bad", ["two_tokens", "int64_len", "odd_group"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, k, v = (torch.as_tensor(x) for x in _inputs(2, seed=4))
    alen = torch.as_tensor(ALEN)
    if bad == "two_tokens":
        q = torch.cat([q, q], dim=1)
    elif bad == "int64_len":
        alen = alen.long()
    else:
        k, v = k[:, :, :1].expand(B, T, 3, D), v[:, :, :1].expand(B, T, 3, D)
    with pytest.raises(ValueError):
        tda.blocked_decode_attention(q, k, v, alen)


def test_int8_kv_branch_is_not_ported_yet():
    q, k, v = (torch.as_tensor(x) for x in _inputs(2, seed=5))
    with pytest.raises(NotImplementedError, match="int8 KV"):
        tda.decode_attention(q, k, v, torch.as_tensor(ALEN),
                             k_scale=torch.ones(B, T, 2, 1),
                             v_scale=torch.ones(B, T, 2, 1))
