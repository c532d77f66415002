"""The port's decode attention (``lambdipy_tpu_torch/ops/decode_attention.py``)
against the JAX package's: the plain PyTorch version against
``decode_attention_reference`` and against the Pallas kernel in interpret
mode, over ragged lengths, group sizes 1 and 4, f32 and bf16, for float
K/V and for int8 K/V with per-position scales; and the paged form
against ``paged_decode_attention_reference`` and the paged Pallas kernel
in interpret mode, over shuffled block tables with null-padded tails and
distractor pages. The CUDA kernels themselves are held against the plain
versions on the card in ``tests/test_torch_kernels.py``."""

import math

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


def _int8_kv(kvh, t=T, seed=0):
    """Int8 K/V and their f32 scales ``[B, t, kvh, 1]`` as the model's
    ``_kv_quantize`` makes them, from normal K/V."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        x = rng.normal(size=(B, t, kvh, D)).astype(np.float32)
        scale = np.maximum(np.abs(x).max(-1, keepdims=True) / 127.0, 1e-8)
        out += [np.round(x / scale).astype(np.int8), scale.astype(np.float32)]
    return out  # k_int8, k_scale, v_int8, v_scale


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
    out = tda.blocked_decode_attention(q, k, v, alen)
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


def test_int8_kv_branch_runs_plain_on_cpu():
    """The int8-KV branch is ported: the wrapper takes int8 K/V with
    their scales and, on CPU tensors, runs the plain int8-KV version
    without counting a launch."""
    q = torch.as_tensor(_inputs(2, seed=5)[0])
    k8, ks, v8, vs = (torch.as_tensor(x) for x in _int8_kv(2, seed=5))
    alen = torch.as_tensor(ALEN)
    before = (tda.blocked_decode_attention.launches,
              tda.blocked_decode_attention.launches_int8kv)
    out = tda.blocked_decode_attention(q, k8, v8, alen, k_scale=ks,
                                       v_scale=vs)
    assert torch.equal(out, tda.int8_kv_decode_attention_reference(
        q, k8, v8, alen, ks, vs))
    assert out.shape == q.shape and torch.isfinite(out).all()
    assert (tda.blocked_decode_attention.launches,
            tda.blocked_decode_attention.launches_int8kv) == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kvh", [4, 1], ids=["group1", "group4"])
def test_int8_kv_plain_matches_pallas_kernel_interpret(kvh, dtype):
    """At a tiling ``t`` the JAX wrapper runs the Pallas kernel's int8
    branch: int8 * f32 scale in f32, rounded to q's dtype. The port's
    plain version rounds the same way; tolerances as the float branch's
    (online softmax, another summation order)."""
    q = _inputs(kvh, seed=6)[0]
    k8, ks, v8, vs = _int8_kv(kvh, seed=6)
    want = jda.blocked_decode_attention(
        _jax(q, dtype), jnp.asarray(k8), jnp.asarray(v8), jnp.asarray(ALEN),
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), block_k=BLOCK,
        interpret=True)
    got = tda.blocked_decode_attention(
        _torch(q, dtype), torch.as_tensor(k8), torch.as_tensor(v8),
        torch.as_tensor(ALEN), k_scale=torch.as_tensor(ks),
        v_scale=torch.as_tensor(vs))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=KERNEL_TOL[dtype])


def test_int8_kv_rounds_like_the_kernel_not_like_the_jax_fallback():
    """At a ``t`` that does not tile its blocks the JAX wrapper falls back
    to its reference over ``int8.astype(bf16) * scale.astype(bf16)``: the
    scale is rounded to bf16 before the product. The port keeps the
    kernel's rounding (product in f32, then bf16) at every shape, so in
    bf16 the dequantized K/V differ from the fallback's, and the port's
    output is the reference over the kernel-rounded K/V."""
    t = 60  # not a multiple of BLOCK
    alen = np.asarray([1, 17, 33, t], np.int32)
    q = _inputs(2, seed=7)[0]
    k8, ks, v8, vs = _int8_kv(2, t=t, seed=7)
    kernel_k = tda.dequantize_kv(torch.as_tensor(k8), torch.as_tensor(ks),
                                 torch.bfloat16)
    fallback_k = (torch.as_tensor(k8).to(torch.bfloat16)
                  * torch.as_tensor(ks).to(torch.bfloat16))
    differ = (kernel_k != fallback_k).float().mean().item()
    assert differ > 0.05  # a large share of the elements round otherwise
    got = tda.blocked_decode_attention(
        _torch(q, "bfloat16"), torch.as_tensor(k8), torch.as_tensor(v8),
        torch.as_tensor(alen), k_scale=torch.as_tensor(ks),
        v_scale=torch.as_tensor(vs))
    kernel_v = tda.dequantize_kv(torch.as_tensor(v8), torch.as_tensor(vs),
                                 torch.bfloat16)
    want_kernel = jda.decode_attention_reference(
        _jax(q, "bfloat16"), jnp.asarray(kernel_k.float().numpy(),
                                         jnp.bfloat16),
        jnp.asarray(kernel_v.float().numpy(), jnp.bfloat16),
        jnp.asarray(alen))
    np.testing.assert_allclose(_np(got), _np(want_kernel), rtol=0,
                               atol=TOL["bfloat16"])
    fallback = jda.blocked_decode_attention(
        _jax(q, "bfloat16"), jnp.asarray(k8), jnp.asarray(v8),
        jnp.asarray(alen), k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
        block_k=BLOCK, interpret=True)
    want_fallback = jda.decode_attention_reference(
        _jax(q, "bfloat16"), jnp.asarray(fallback_k.float().numpy(),
                                         jnp.bfloat16),
        jnp.asarray((torch.as_tensor(v8).to(torch.bfloat16)
                     * torch.as_tensor(vs).to(torch.bfloat16))
                    .float().numpy(), jnp.bfloat16),
        jnp.asarray(alen))
    np.testing.assert_array_equal(_np(fallback), _np(want_fallback))
    assert not np.array_equal(_np(got), _np(fallback))


@pytest.mark.parametrize("bad", ["one_scale", "float_kv", "scale_shape"])
def test_int8_kv_wrapper_rejects_bad_operands(bad):
    q = torch.as_tensor(_inputs(2, seed=8)[0])
    k8, ks, v8, vs = (torch.as_tensor(x) for x in _int8_kv(2, seed=8))
    kwargs = {"k_scale": ks, "v_scale": vs}
    if bad == "one_scale":
        kwargs["v_scale"] = None
    elif bad == "float_kv":
        k8, v8 = k8.float(), v8.float()
    else:
        kwargs["k_scale"] = ks[..., 0]
    with pytest.raises(ValueError):
        tda.blocked_decode_attention(q, k8, v8, torch.as_tensor(ALEN),
                                     **kwargs)


# ------------------------------------------------------------------ paged

PAGE, NB = 16, T // 16  # the paged cases cover the same T positions


def _paged(kvh, seed, quant=False):
    """A page arena whose every page holds finite garbage (page 0 and
    unreferenced pages are distractors), shuffled block tables whose
    entries past a row's length are the null page, and the arena's
    float or int8 (+ f32 scale) pages."""
    rng = np.random.default_rng(seed)
    n_pages = B * NB + 5
    shape = (n_pages, PAGE, kvh, D)
    pages = []
    for _ in range(2):
        if quant:
            x = rng.normal(size=shape).astype(np.float32)
            scale = np.maximum(np.abs(x).max(-1, keepdims=True) / 127.0,
                               1e-8).astype(np.float32)
            pages += [np.round(x / scale).astype(np.int8), scale]
        else:
            pages.append(rng.normal(size=shape).astype(np.float32))
    perm = rng.permutation(np.arange(1, n_pages))
    tables = np.zeros((B, NB), np.int32)
    for r, n in enumerate(ALEN):
        used = -(-int(n) // PAGE)
        tables[r, :used] = perm[r * NB:r * NB + used]
    q = rng.normal(size=(B, 1, 4, D)).astype(np.float32)
    return q, pages, tables


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kvh", [4, 1], ids=["group1", "group4"])
def test_paged_plain_matches_jax_paged_reference(kvh, dtype):
    q, (kp, vp), tables = _paged(kvh, seed=10)
    want = jda.paged_decode_attention_reference(
        _jax(q, dtype), _jax(kp, dtype), _jax(vp, dtype),
        jnp.asarray(tables), jnp.asarray(ALEN))
    got = tda.paged_decode_attention(
        _torch(q, dtype), _torch(kp, dtype), _torch(vp, dtype),
        torch.as_tensor(tables), torch.as_tensor(ALEN))
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_paged_plain_matches_paged_pallas_kernel_interpret(quant, dtype):
    """The paged Pallas kernel in interpret mode, float and int8 pages:
    its body dequantizes as int8 * f32 scale in f32, rounded to q's
    dtype, as the port does. Tolerances as the contiguous kernel's
    (online softmax, another summation order)."""
    q, pages, tables = _paged(2, seed=11, quant=quant)
    if quant:
        k8, ks, v8, vs = pages
        want = jda.paged_blocked_decode_attention(
            _jax(q, dtype), jnp.asarray(k8), jnp.asarray(v8),
            jnp.asarray(tables), jnp.asarray(ALEN),
            k_scale_pages=jnp.asarray(ks), v_scale_pages=jnp.asarray(vs),
            interpret=True)
        got = tda.paged_decode_attention(
            _torch(q, dtype), torch.as_tensor(k8), torch.as_tensor(v8),
            torch.as_tensor(tables), torch.as_tensor(ALEN),
            k_scale_pages=torch.as_tensor(ks),
            v_scale_pages=torch.as_tensor(vs))
    else:
        kp, vp = pages
        want = jda.paged_blocked_decode_attention(
            _jax(q, dtype), _jax(kp, dtype), _jax(vp, dtype),
            jnp.asarray(tables), jnp.asarray(ALEN), interpret=True)
        got = tda.paged_decode_attention(
            _torch(q, dtype), _torch(kp, dtype), _torch(vp, dtype),
            torch.as_tensor(tables), torch.as_tensor(ALEN))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=KERNEL_TOL[dtype])


def test_paged_int8_rounds_like_the_kernel_not_like_the_jax_reference():
    """The JAX paged reference rounds the gathered scale to q's dtype
    before the product (``decode_attention.py:276-278``); the port, as
    the TPU kernel body, multiplies in f32 and rounds once. In bf16 the
    two differ, and the port equals the JAX reference run on the
    kernel-rounded K/V."""
    q, (k8, ks, v8, vs), tables = _paged(2, seed=12, quant=True)
    got = tda.paged_decode_attention(
        _torch(q, "bfloat16"), torch.as_tensor(k8), torch.as_tensor(v8),
        torch.as_tensor(tables), torch.as_tensor(ALEN),
        k_scale_pages=torch.as_tensor(ks), v_scale_pages=torch.as_tensor(vs))
    jax_ref = jda.paged_decode_attention_reference(
        _jax(q, "bfloat16"), jnp.asarray(k8), jnp.asarray(v8),
        jnp.asarray(tables), jnp.asarray(ALEN),
        k_scale_pages=jnp.asarray(ks), v_scale_pages=jnp.asarray(vs))
    assert not np.array_equal(_np(got), _np(jax_ref))

    def kernel_rounded(x8, sc):
        return jnp.asarray(tda.dequantize_kv(
            torch.as_tensor(x8), torch.as_tensor(sc), torch.bfloat16)
            .float().numpy(), jnp.bfloat16)

    want = jda.paged_decode_attention_reference(
        _jax(q, "bfloat16"), kernel_rounded(k8, ks), kernel_rounded(v8, vs),
        jnp.asarray(tables), jnp.asarray(ALEN))
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=TOL["bfloat16"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_paged_plain_is_bitwise_contiguous_plain_on_gathered_values(quant,
                                                                    dtype):
    """Paged plain == contiguous plain on the K/V gathered through the
    same tables, bitwise: shuffled tables, null-padded tails, distractor
    pages, and a row at length 0 (uniform mean over every table
    position, null pages included)."""
    q, pages, tables = _paged(2, seed=13, quant=quant)
    alen = torch.as_tensor(np.asarray([0, 5, PAGE + 1, T], np.int32))
    qt, tt = _torch(q, dtype), torch.as_tensor(tables)
    if quant:
        k8, ks, v8, vs = (torch.as_tensor(x) for x in pages)
        got = tda.paged_decode_attention(qt, k8, v8, tt, alen,
                                         k_scale_pages=ks, v_scale_pages=vs)
        want = tda.blocked_decode_attention(
            qt, tda.gather_pages(k8, tt), tda.gather_pages(v8, tt), alen,
            k_scale=tda.gather_pages(ks, tt), v_scale=tda.gather_pages(vs, tt))
    else:
        kp, vp = (_torch(x, dtype) for x in pages)
        got = tda.paged_decode_attention(qt, kp, vp, tt, alen)
        want = tda.blocked_decode_attention(
            qt, tda.gather_pages(kp, tt), tda.gather_pages(vp, tt), alen)
    assert torch.equal(got, want)


def test_paged_wrapper_on_cpu_runs_plain_version_without_counting():
    q, (kp, vp), tables = _paged(2, seed=14)
    args = (torch.as_tensor(q), torch.as_tensor(kp), torch.as_tensor(vp),
            torch.as_tensor(tables), torch.as_tensor(ALEN))
    before = (tda.paged_decode_attention.launches,
              tda.paged_decode_attention.launches_int8kv)
    out = tda.paged_decode_attention(*args)
    assert torch.equal(out, tda.paged_decode_attention_reference(*args))
    assert (tda.paged_decode_attention.launches,
            tda.paged_decode_attention.launches_int8kv) == before


@pytest.mark.parametrize("bad", ["two_tokens", "page_not_pow2",
                                 "int64_tables", "one_scale", "table_rows"])
def test_paged_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, (kp, vp), tables = _paged(2, seed=15)
    q, kp, vp = (torch.as_tensor(x) for x in (q, kp, vp))
    tables, alen, kwargs = torch.as_tensor(tables), torch.as_tensor(ALEN), {}
    if bad == "two_tokens":
        q = torch.cat([q, q], dim=1)
    elif bad == "page_not_pow2":
        kp, vp = kp[:, :12], vp[:, :12]
    elif bad == "int64_tables":
        tables = tables.long()
    elif bad == "one_scale":
        kwargs["k_scale_pages"] = torch.ones(*kp.shape[:3], 1)
    else:
        tables = tables[:2]
    with pytest.raises(ValueError):
        tda.paged_decode_attention(q, kp, vp, tables, alen, **kwargs)


# ------------------------------------------------------ split-KV plan

CHUNK = tda.KV_CHUNK
SPLIT_T = 4 * CHUNK
# 0 (uniform mean over t), 1, a chunk's edges, several chunks, past t
SPLIT_LENS = np.asarray([0, 1, CHUNK - 1, CHUNK, CHUNK + 1, 3 * CHUNK - 50,
                         SPLIT_T + 88], np.int32)


def test_kv_chunk_is_the_sources():
    """The wrapper's ``KV_CHUNK`` (which sizes the kernel's partials) is
    the one compiled into ``csrc/decode_attention.cu``; the wrapper also
    checks it against the built library when it loads."""
    import re
    from pathlib import Path

    src = (Path(tda.__file__).resolve().parent.parent / "csrc"
           / "decode_attention.cu").read_text()
    assert re.findall(r"constexpr int KV_CHUNK = (\d+);", src) == [
        str(CHUNK)]


@pytest.mark.parametrize("t", [CHUNK, SPLIT_T, 8192])
def test_split_bounds_depend_on_active_len_alone(t):
    """A row's chunk bounds are a function of its own length: the same
    at any capacity t that holds it, contiguous from 0, ``KV_CHUNK`` wide
    but for the last."""
    for n in range(1, t + 1, 7):
        bounds = tda.split_bounds(n, t)
        assert bounds == tda.split_bounds(n, n) == tda.split_bounds(
            n, t + 3 * CHUNK + 5)
        assert bounds[0][0] == 0 and bounds[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
        assert all(e - s == CHUNK for s, e in bounds[:-1])
        assert 0 < bounds[-1][1] - bounds[-1][0] <= CHUNK
        assert len(bounds) == -(-n // CHUNK)


def test_split_bounds_at_zero_and_past_the_window():
    """At ``active_len <= 0`` the plan covers all t positions (the
    uniform mean of V); past t it clamps to t."""
    t = SPLIT_T + 40
    whole = [(s, min(s + CHUNK, t)) for s in range(0, t, CHUNK)]
    assert tda.split_bounds(0, t) == tda.split_bounds(-3, t) == whole
    assert tda.split_bounds(t + 1000, t) == whole


def split_combine_reference(q, k, v, active_len):
    """The kernel's algorithm in plain f32 (tests only): each chunk of
    :func:`split_bounds` gives a softmax partial (max m, sum l, unscaled
    p @ V), merged in chunk order as ``sum exp(m_s - M) acc_s /
    max(sum exp(m_s - M) l_s, 1e-30)``."""
    q, k, v = q.float(), k.float(), v.float()
    b, _, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    out = torch.empty(b, 1, h, d)
    for r in range(b):
        n = int(active_len[r])
        qg = q[r, 0].reshape(kvh, h // kvh, d)
        parts = []
        for s0, s1 in tda.split_bounds(n, t):
            kk = k[r, s0:s1].transpose(0, 1)  # [kvh, chunk, d]
            vv = v[r, s0:s1].transpose(0, 1)
            sc = torch.einsum("kgd,knd->kgn", qg, kk) / math.sqrt(d)
            if n <= 0:
                sc = torch.full_like(sc, tda.NEG_INF)
            m = sc.amax(-1, keepdim=True)
            p = torch.exp(sc - m)
            parts.append((m, p.sum(-1, keepdim=True),
                          torch.einsum("kgn,knd->kgd", p, vv)))
        big = torch.stack([m for m, _, _ in parts]).amax(0)
        l_sum = sum(torch.exp(m - big) * l for m, l, _ in parts)
        acc = sum(torch.exp(m - big) * a for m, _, a in parts)
        out[r, 0] = (acc / l_sum.clamp_min(1e-30)).reshape(h, d)
    return out


def _split_inputs(kvh, seed):
    rng = np.random.default_rng(seed)
    b = SPLIT_LENS.size
    q = rng.normal(size=(b, 1, H, D)).astype(np.float32)
    k = rng.normal(size=(b, SPLIT_T, kvh, D)).astype(np.float32)
    v = rng.normal(size=(b, SPLIT_T, kvh, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("kvh", [4, 1], ids=["group1", "group4"])
def test_split_combine_matches_jax_reference(kvh):
    """The split plan with its merge computes the JAX reference's function
    (f32, 1e-5) at lengths around the chunk edges, 0 and past t
    included."""
    q, k, v = _split_inputs(kvh, seed=20)
    got = split_combine_reference(torch.as_tensor(q), torch.as_tensor(k),
                                  torch.as_tensor(v),
                                  torch.as_tensor(SPLIT_LENS))
    want = jda.decode_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(SPLIT_LENS))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("kvh", [4, 1], ids=["group1", "group4"])
def test_split_combine_matches_pallas_kernel_interpret(kvh):
    """The same against the Pallas kernel in interpret mode (128-position
    blocks, its own online softmax), f32, 1e-5. Length 0 is left out:
    there the TPU kernel returns zeros where the reference and the port
    give the uniform mean of V (ROADMAP §3)."""
    q, k, v = _split_inputs(kvh, seed=21)
    lens = np.where(SPLIT_LENS == 0, 5, SPLIT_LENS).astype(np.int32)
    got = split_combine_reference(torch.as_tensor(q), torch.as_tensor(k),
                                  torch.as_tensor(v), torch.as_tensor(lens))
    want = jda.blocked_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        block_k=128, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("kvh", [4, 1], ids=["group1", "group4"])
def test_split_combine_matches_the_port_plain_version(kvh):
    """The port's plain version (which the kernel is held against on the
    card) and the split-and-merge version agree at f32 1e-5 at the same
    lengths."""
    q, k, v = (torch.as_tensor(x) for x in _split_inputs(kvh, seed=22))
    alen = torch.as_tensor(SPLIT_LENS)
    got = split_combine_reference(q, k, v, alen)
    want = tda.decode_attention_reference(q, k, v, alen)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", ["aligned", "row_bytes", "offset"])
def test_kv_alignment_check(case):
    """The kernel's 16-byte copies: a d-vector whose bytes are not a
    multiple of 16, or K/V off a 16-byte boundary, is refused."""
    if case == "aligned":
        for dtype, d in ((torch.float32, 4), (torch.bfloat16, 32),
                         (torch.int8, 16)):
            k = torch.zeros(1, 3, 2, d, dtype=dtype)
            tda.check_kv_alignment(k, k)
        return
    if case == "row_bytes":
        k = torch.zeros(1, 3, 2, 4, dtype=torch.bfloat16)  # 8 bytes
        match = "multiple of 16"
    else:
        k = torch.zeros(1 * 3 * 2 * 8 + 1)[1:].view(1, 3, 2, 8)
        match = "16-byte"
    with pytest.raises(ValueError, match=match):
        tda.check_kv_alignment(k, k)
