"""The port's CUDA kernels against their plain PyTorch versions on the
card. Every test here needs an NVIDIA CUDA device (marker ``cuda``) and
skips without one. The file imports nothing of JAX, so it also runs on a
machine without it:

    python -m pytest tests/test_torch_kernels.py --noconftest -m cuda -q
"""

import numpy as np
import pytest
import torch

from lambdipy_tpu_torch.models import registry
from lambdipy_tpu_torch.models.llama import _kv_quantize
from lambdipy_tpu_torch.ops import attention as tat
from lambdipy_tpu_torch.ops import decode_attention as tda
from lambdipy_tpu_torch.ops import quant as tq

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA device; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # full-f32 plain matmuls
    return torch.device("cuda")


def _row_rel_err(out, ref) -> float:
    """Max over query rows (one head's d-vector) of max |out - ref| over
    the row divided by the row's rms in ``ref``: attention outputs shrink
    as the window grows, so an absolute limit would hold long rows
    loosely."""
    diff = (out.float() - ref.float()).abs().amax(-1)
    rms = ref.float().square().mean(-1).sqrt()
    return (diff / rms).max().item()


# limits on _row_rel_err. bf16: the kernel and the plain version round the
# probabilities to bf16 at other scales and their outputs differ by up to
# one bf16 ulp, at most 2^-7 of a value (~0.03 of the rms at a row's
# peak); f32: summation order and expf
ATTN_TOL = {torch.float32: 1e-4, torch.bfloat16: 0.05}
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                                 ids=["f32", "bf16"])


@DTYPES
@pytest.mark.parametrize("h,kvh,d", [(4, 4, 32), (32, 8, 128), (8, 1, 64)],
                         ids=["group1", "group4-d128", "group8"])
def test_decode_attention_kernel_matches_plain(cuda_device, dtype, h, kvh,
                                               d):
    """Ragged lengths incl. 0 (uniform mean of V), 1, a 64-position tile
    boundary and past the window."""
    rng = np.random.default_rng(h + kvh + d)
    b, t = 5, 200
    q, k, v = (torch.as_tensor(rng.normal(size=s).astype(np.float32))
               .to(dtype).to(cuda_device)
               for s in ((b, 1, h, d), (b, t, kvh, d), (b, t, kvh, d)))
    alen = torch.as_tensor(np.asarray([0, 1, 64, 65, 900], np.int32),
                           device=cuda_device)
    before = tda.blocked_decode_attention.launches
    out = tda.blocked_decode_attention(q, k, v, alen)
    ref = tda.decode_attention_reference(q, k, v, alen)
    torch.cuda.synchronize()
    assert tda.blocked_decode_attention.launches == before + 1
    assert _row_rel_err(out, ref) <= ATTN_TOL[dtype]


@DTYPES
@pytest.mark.parametrize("h,kvh,d", [(4, 4, 32), (32, 8, 128), (8, 1, 64)],
                         ids=["group1", "group4-d128", "group8"])
def test_int8_kv_decode_attention_kernel_matches_plain(cuda_device, dtype,
                                                       h, kvh, d):
    """The int8-KV branch over the same ragged lengths as the float
    branch; K/V quantized as the model does. Tolerances as the float
    branch's: both dequantize with the same rounding."""
    rng = np.random.default_rng(h + kvh + d + 1)
    b, t = 5, 200
    q = torch.as_tensor(rng.normal(size=(b, 1, h, d)).astype(np.float32))
    q = q.to(dtype).to(cuda_device)
    kv = []
    for _ in range(2):
        x = torch.as_tensor(rng.normal(size=(b, t, kvh, d)).astype(np.float32))
        scale = (x.abs().amax(-1, keepdim=True) / 127.0).clamp(min=1e-8)
        kv += [torch.round(x / scale).to(torch.int8).to(cuda_device),
               scale.to(cuda_device)]
    k8, ks, v8, vs = kv
    alen = torch.as_tensor(np.asarray([0, 1, 64, 65, 900], np.int32),
                           device=cuda_device)
    before = (tda.blocked_decode_attention.launches,
              tda.blocked_decode_attention.launches_int8kv)
    out = tda.blocked_decode_attention(q, k8, v8, alen, k_scale=ks,
                                       v_scale=vs)
    ref = tda.int8_kv_decode_attention_reference(q, k8, v8, alen, ks, vs)
    torch.cuda.synchronize()
    assert (tda.blocked_decode_attention.launches,
            tda.blocked_decode_attention.launches_int8kv) == (
                before[0], before[1] + 1)
    assert _row_rel_err(out, ref) <= ATTN_TOL[dtype]


# bf16 against the plain version: it also rounds its logits to bf16 (the
# einsum's output dtype) where the kernel keeps them in f32, ~0.3% noise
# on every probability
FLASH_PLAIN_BF16_TOL = 0.12


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@DTYPES
@pytest.mark.parametrize("h,kvh,d,s", [(4, 4, 32, 128), (32, 8, 128, 200),
                                       (8, 1, 64, 77), (4, 2, 256, 64)],
                         ids=["group1", "group4-d128-ragged",
                              "group8-ragged", "group2-d256"])
def test_flash_attention_kernel_matches_plain(cuda_device, causal, dtype,
                                              h, kvh, d, s):
    rng = np.random.default_rng(h + kvh + d + s)
    b = 2
    q, k, v = (torch.as_tensor(rng.normal(size=sh).astype(np.float32))
               .to(dtype).to(cuda_device)
               for sh in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d)))
    before = tat.flash_attention.launches
    out = tat.flash_attention(q, k, v, causal=causal)
    ref = tat.mha_reference(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tat.flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    if dtype == torch.float32:
        assert _row_rel_err(out, ref) <= ATTN_TOL[dtype]
    else:
        assert _row_rel_err(out, ref) <= FLASH_PLAIN_BF16_TOL
        # the kernel body's rounding: f32 logits, p in bf16 before PV
        ref = tat.mha_reference(q.float(), k.float(), v, causal=causal)
        assert _row_rel_err(out, ref) <= ATTN_TOL[dtype]


def test_flash_attention_never_repeats_kv(cuda_device):
    """Grouped K/V are read in place: the call allocates its output and
    nothing of the size of a repeated K/V."""
    b, s, h, kvh, d = 1, 2048, 32, 8, 128
    q = torch.randn(b, s, h, d, device=cuda_device, dtype=torch.bfloat16)
    k = torch.randn(b, s, kvh, d, device=cuda_device, dtype=torch.bfloat16)
    v = torch.randn_like(k)
    tat.flash_attention(q, k, v, causal=True)  # build and load first
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = tat.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base <= out.numel() * 2
    del out


@pytest.mark.parametrize("m", [1, 4, 8, 9, 130])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_kernel_matches_plain(cuda_device, m, dtype):
    """GEMV (m <= 8) and tiled paths, ragged n and k edges; tolerance:
    one bf16 ulp at the peak for bf16 output, summation order for f32."""
    rng = np.random.default_rng(m)
    k, n = 264, 136
    x = torch.as_tensor(rng.normal(size=(m, k)).astype(np.float32)).to(dtype)
    w = torch.as_tensor(rng.integers(-127, 128, (k, n)).astype(np.int8))
    scale = torch.as_tensor(((rng.random((1, n)) + 0.5)
                             / (127 * k ** 0.5)).astype(np.float32))
    x, w, scale = x.to(cuda_device), w.to(cuda_device), scale.to(cuda_device)
    before = tq.int8_matmul.launches
    out = tq.int8_matmul(x, w, scale)
    ref = tq.int8_matmul_reference(x, w, scale)
    torch.cuda.synchronize()
    assert tq.int8_matmul.launches == before + 1
    assert out.dtype == dtype
    peak = ref.float().abs().max().item()
    tol = (1e-5 if dtype == torch.float32 else 2.0 ** -7) * peak
    assert (out.float() - ref.float()).abs().max().item() <= tol


def test_wrapper_raises_on_cuda_for_unsupported_input(cuda_device):
    w = torch.zeros(16, 12, dtype=torch.int8, device=cuda_device)  # n % 8
    with pytest.raises(ValueError, match="n % 8"):
        tq.int8_matmul(torch.zeros(2, 16, device=cuda_device), w,
                       torch.ones(1, 12, device=cuda_device))


def test_small_int8_model_on_card_matches_cpu(cuda_device):
    """Greedy tokens of a small int8 model with both kernels on the card
    equal the same weights' plain versions on the CPU. Logprobs agree to
    5e-3: the int8 kernel rounds f32 activations to bf16, and a ~1e-7
    difference between card and CPU can flip one by a bf16 ulp (measured
    1.5e-3 on an H100)."""
    extra = {"vocab_size": 512, "hidden": 256, "heads": 4, "kv_heads": 2,
             "mlp": 512, "layers": 2, "max_len": 256,
             "attn_backend": "blocked", "matmul_backend": "pallas"}
    adapter = registry.get("llama-tiny").build(quant="int8", extra=extra)
    sd = adapter.init_params(seed=3, device="cpu")
    rows = [list(range(1, 40)), list(range(5, 12))]
    cpu = adapter.make_server(sd, device="cpu").generate(
        rows, max_new_tokens=12, return_logprobs=True)
    attn0, mm0 = tda.blocked_decode_attention.launches, tq.int8_matmul.launches
    card = adapter.make_server(sd, device=cuda_device).generate(
        rows, max_new_tokens=12, return_logprobs=True)
    np.testing.assert_array_equal(card[0], cpu[0])
    np.testing.assert_allclose(card[1], cpu[1], atol=5e-3)
    assert tda.blocked_decode_attention.launches - attn0 == 2 * 11
    assert tq.int8_matmul.launches - mm0 == (7 * 2 + 1) * 12


@pytest.mark.parametrize("extra,counter", [
    ({"kv_quant": "int8"}, "int8kv"),
    ({"attn_backend": "flash"}, "flash"),
], ids=["blocked-int8kv", "flash"])
def test_small_model_on_new_paths_matches_cpu(cuda_device, extra, counter):
    """The small f32 model under the int8 KV cache and under flash
    prefill: greedy tokens on the card equal the CPU's, logprobs within
    5e-3 (as above), and the path's kernel ran (32-token prompt bucket,
    so flash sees a padded prefill)."""
    extra = {"vocab_size": 512, "hidden": 256, "heads": 4, "kv_heads": 2,
             "mlp": 512, "layers": 2, "max_len": 256,
             "matmul_backend": "pallas", **extra}
    adapter = registry.get("llama-tiny").build(quant="int8", extra=extra)
    sd = adapter.init_params(seed=3, device="cpu")
    rows = [list(range(1, 30)), list(range(5, 12))]
    cpu = adapter.make_server(sd, device="cpu").generate(
        rows, max_new_tokens=12, return_logprobs=True)
    before = (tda.blocked_decode_attention.launches_int8kv,
              tat.flash_attention.launches)
    card = adapter.make_server(sd, device=cuda_device).generate(
        rows, max_new_tokens=12, return_logprobs=True)
    np.testing.assert_array_equal(card[0], cpu[0])
    np.testing.assert_allclose(card[1], cpu[1], atol=5e-3)
    ran = (tda.blocked_decode_attention.launches_int8kv - before[0],
           tat.flash_attention.launches - before[1])
    assert ran == ((2 * 11, 0) if counter == "int8kv" else (0, 2))


def _paged_case(rng, b, page, nb, kvh, d, quant, alen):
    """An arena of random pages (page 0 and unreferenced pages are
    distractors: every value is finite garbage), shuffled non-identity
    block tables whose entries past a row's length are the null page,
    and K/V as float or int8 with f32 scales."""
    n_pages = b * nb + 7
    shape = (n_pages, page, kvh, d)
    pages = {}
    for name in ("k", "v"):
        if quant:
            pages[name] = torch.as_tensor(
                rng.integers(-127, 128, shape).astype(np.int8))
            pages[f"{name}_scale"] = torch.as_tensor(
                (rng.random(shape[:3] + (1,)) * 0.02 + 1e-3)
                .astype(np.float32))
        else:
            pages[name] = torch.as_tensor(
                rng.normal(size=shape).astype(np.float32))
    perm = rng.permutation(np.arange(1, n_pages))
    tables = np.zeros((b, nb), np.int32)
    for r in range(b):
        used = min(nb, -(-max(int(alen[r]), 1) // page))
        tables[r, :used] = perm[r * nb:r * nb + used]
    return pages, torch.as_tensor(tables)


@DTYPES
@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("page", [16, 32, 128])
@pytest.mark.parametrize("h,kvh,d", [(4, 4, 32), (32, 8, 128), (8, 1, 64)],
                         ids=["group1", "group4-d128", "group8"])
def test_paged_decode_attention_kernel_matches_plain_and_contiguous(
        cuda_device, dtype, quant, page, h, kvh, d):
    """Kernel 3 against its plain version (per-row limits as the
    contiguous kernel's), and BITWISE against the contiguous kernel on
    the K/V gathered through the same tables: shuffled tables, null-padded
    tails, distractor pages, lengths 0 (uniform mean over every table
    position), 1, tile and page boundaries, the whole table."""
    rng = np.random.default_rng(page + h + kvh + d + quant)
    nb = max(2, 320 // page)
    alen = np.asarray([0, 1, 63, 64, 65, nb * page], np.int32)
    b = alen.size
    pages, tables = _paged_case(rng, b, page, nb, kvh, d, quant, alen)
    q = torch.as_tensor(rng.normal(size=(b, 1, h, d)).astype(np.float32))
    q = q.to(dtype).to(cuda_device)
    dev = {name: (x if quant else x.to(dtype)).to(cuda_device)
           for name, x in pages.items()}
    _check_paged(q, dev, tables.to(cuda_device),
                 torch.as_tensor(alen, device=cuda_device), quant, dtype)


def _check_paged(q, pages, tables, alen, quant, dtype):
    """Kernel 3 launches once on its own counter, holds its plain version
    within ``ATTN_TOL`` and equals the contiguous kernel bitwise on the
    K/V gathered through ``tables``."""
    scales = ({"k_scale_pages": pages["k_scale"],
               "v_scale_pages": pages["v_scale"]} if quant else {})
    before = (tda.paged_decode_attention.launches,
              tda.paged_decode_attention.launches_int8kv)
    out = tda.paged_decode_attention(q, pages["k"], pages["v"], tables, alen,
                                     **scales)
    ref = tda.paged_decode_attention_reference(q, pages["k"], pages["v"],
                                               tables, alen, **scales)
    gathered = {name: tda.gather_pages(x, tables).contiguous()
                for name, x in pages.items()}
    contiguous = tda.blocked_decode_attention(
        q, gathered["k"], gathered["v"], alen,
        **({"k_scale": gathered["k_scale"], "v_scale": gathered["v_scale"]}
           if quant else {}))
    torch.cuda.synchronize()
    after = (tda.paged_decode_attention.launches,
             tda.paged_decode_attention.launches_int8kv)
    assert after == (before[0] + (not quant), before[1] + quant)
    assert _row_rel_err(out, ref) <= ATTN_TOL[dtype]
    assert torch.equal(out, contiguous)


@DTYPES
@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_paged_decode_attention_at_the_engine_shape(cuda_device, dtype,
                                                    quant):
    """Kernel 3 at the shape the continuous engine gives it for llama3-8b:
    8 slots over an 8,192-position window (tables ``[8, 256]`` of
    32-position pages into a 2,049-page arena), slot 0 idle at
    active_len 1 on an all-null table, the others at burst lengths up to
    4,032 positions."""
    b, page, nb, h, kvh, d = 8, 32, 256, 32, 8, 128
    alen = [1, 144, 164, 532, 1040, 2024, 4032, 180]
    n_pages = b * nb + 1
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    pages = {}
    for name in ("k", "v"):
        x = torch.randn(n_pages, page, kvh, d, generator=gen,
                        device=cuda_device)
        if quant:
            pages[name], pages[f"{name}_scale"] = _kv_quantize(x)
        else:
            pages[name] = x.to(dtype)
    perm = torch.randperm(n_pages - 1,
                          generator=torch.Generator().manual_seed(11)) + 1
    tables = torch.zeros(b, nb, dtype=torch.int32)
    for r in range(1, b):
        used = -(-alen[r] // page)
        tables[r, :used] = perm[r * nb:r * nb + used].to(torch.int32)
    q = torch.randn(b, 1, h, d, generator=gen, device=cuda_device).to(dtype)
    _check_paged(q, pages, tables.to(cuda_device),
                 torch.tensor(alen, dtype=torch.int32, device=cuda_device),
                 quant, dtype)


def test_paged_wrapper_raises_on_cuda_for_unsupported_input(cuda_device):
    q = torch.zeros(1, 1, 4, 32, device=cuda_device)
    pages = torch.zeros(3, 24, 4, 32, device=cuda_device)  # page 24
    with pytest.raises(ValueError, match="power of two"):
        tda.paged_decode_attention(
            q, pages, pages, torch.zeros(1, 2, dtype=torch.int32,
                                         device=cuda_device),
            torch.ones(1, dtype=torch.int32, device=cuda_device))


def test_small_paged_engine_on_card_matches_cpu_and_dense(cuda_device):
    """A small int8 model served by the continuous engine over a page
    arena: greedy rows on the card equal the CPU's tokens (logprobs
    within 5e-3, as above; a seeded row draws other noise on the card,
    whose generators are not the CPU's); on the card the paged engine's
    tokens and logprobs, seeded row included, are bitwise the dense
    engine's; every decode step launched kernel 3 once per layer and
    kernel 1 never."""
    from lambdipy_tpu_torch.runtime.handlers import make_engine

    extra = {"vocab_size": 512, "hidden": 256, "heads": 4, "kv_heads": 2,
             "mlp": 512, "layers": 2, "max_len": 256,
             "attn_backend": "blocked", "matmul_backend": "pallas"}
    adapter = registry.get("llama-tiny").build(quant="int8", extra=extra)
    sd = adapter.init_params(seed=3, device="cpu")
    reqs = [(list(range(1, 40)), 12, {}),
            (list(range(5, 12)), 20, {"temperature": 0.8, "top_p": 0.9,
                                      "seed": 7}),
            (list(range(9, 80)), 9, {})]
    outs = {}
    for dev in ("cpu", cuda_device):
        server = adapter.make_server(sd, device=dev)
        for paged in ("1", "0"):
            eng = make_engine(server, {"batch_max": "4", "batch_segment": "4",
                                       "kv_paged": paged})
            k1 = tda.blocked_decode_attention.launches
            k3 = tda.paged_decode_attention.launches
            outs[str(dev), paged] = [
                eng.generate(p, max_new_tokens=n, return_logprobs=True, **kw)
                for p, n, kw in reqs]
            steps = eng.stats()["steps"]
            if str(dev) != "cpu":
                ran = (tda.blocked_decode_attention.launches - k1,
                       tda.paged_decode_attention.launches - k3)
                assert ran == ((0, 2 * steps) if paged == "1"
                               else (2 * steps, 0))
    for (tok_c, lp_c), (tok_g, lp_g), (tok_d, lp_d), (_, _, kw) in zip(
            outs["cpu", "1"], outs["cuda", "1"], outs["cuda", "0"], reqs):
        if not kw:
            np.testing.assert_array_equal(tok_g, tok_c)
            np.testing.assert_allclose(lp_g, lp_c, atol=5e-3)
        np.testing.assert_array_equal(tok_g, tok_d)
        np.testing.assert_array_equal(lp_g, lp_d)
