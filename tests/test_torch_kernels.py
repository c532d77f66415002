"""The port's CUDA kernels against their plain PyTorch versions on the
card. Every test here needs an NVIDIA CUDA device (marker ``cuda``) and
skips without one. The file imports nothing of JAX, so it also runs on a
machine without it:

    python -m pytest tests/test_torch_kernels.py --noconftest -m cuda -q
"""

import threading
import time

import numpy as np
import pytest
import torch

from lambdipy_tpu_torch.models import registry
from lambdipy_tpu_torch.models.llama import LlamaServer, _kv_quantize
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
                                       (8, 1, 64, 77), (4, 2, 256, 64),
                                       (32, 8, 128, 4096)],
                         ids=["group1", "group4-d128-ragged",
                              "group8-ragged", "group2-d256",
                              "group4-d128-long"])
def test_flash_attention_kernel_matches_plain(cuda_device, causal, dtype,
                                              h, kvh, d, s):
    """Head dims 32 to 256 (padded to 64, 128 or 256 by the kernel's
    loads), ragged query and key tails, groups 1 to 8, and the long
    prompt's bucket (s = 4096, one row) at llama3-8b's heads."""
    rng = np.random.default_rng(h + kvh + d + s)
    b = 1 if s == 4096 else 2
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


@DTYPES
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("s", [128, 200], ids=["s128", "s200-ragged"])
def test_flash_attention_rows_are_batch_invariant(cuda_device, dtype, causal,
                                                  s):
    """What a grouped prefill under ``flash`` rests on: each row of a b=8
    call is bitwise the same row launched alone at b=1, and a second
    launch is bitwise the first (llama3-8b's heads)."""
    h, kvh, d, b = 32, 8, 128, 8
    rng = np.random.default_rng(s + causal)
    q, k, v = (torch.as_tensor(rng.normal(size=sh).astype(np.float32))
               .to(dtype).to(cuda_device)
               for sh in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d)))
    out = tat.flash_attention(q, k, v, causal=causal)
    assert torch.equal(tat.flash_attention(q, k, v, causal=causal), out)
    for r in range(b):
        alone = tat.flash_attention(q[r:r + 1], k[r:r + 1], v[r:r + 1],
                                    causal=causal)
        assert torch.equal(alone, out[r:r + 1]), r


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


@pytest.mark.parametrize("m", [1, 4, 8, 9, 16, 128, 130, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_kernel_matches_plain(cuda_device, m, dtype):
    """GEMV (m <= 8) and tiled routes, ragged tails in m, n and k (k=264 is
    four 64-deep stages and 8 more; n=144 two 64-wide tiles and 16 more);
    tolerance: one bf16 ulp at the peak for bf16 output, summation order
    for f32."""
    rng = np.random.default_rng(m)
    k, n = 264, 144
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n", [(4096, 1024), (4096, 4096), (264, 144)],
                         ids=["k_proj", "q_proj", "ragged"])
def test_int8_matmul_rows_are_batch_invariant(cuda_device, k, n, dtype):
    """The property path D's engine rests on for its grouped prefills: 16
    rows computed alone at m=16 are bitwise the same rows placed at
    offsets 0, 5 and 70 inside m = 32, 128 and 1024 (other rows random).
    The kernel's tile shape follows m: at q_proj 128 x 64 up to m=128,
    then 256 x 128 (bf16) or 128 x 128 (f32) at m=1024."""
    rng = np.random.default_rng(k + n)
    rows = torch.as_tensor(rng.normal(size=(16, k)).astype(np.float32))
    w = torch.as_tensor(rng.integers(-127, 128, (k, n)).astype(np.int8))
    scale = torch.as_tensor(((rng.random((1, n)) + 0.5)
                             / (127 * k ** 0.5)).astype(np.float32))
    rows, w, scale = (rows.to(dtype).to(cuda_device), w.to(cuda_device),
                      scale.to(cuda_device))
    alone = tq.int8_matmul(rows, w, scale)
    for m in (32, 128, 1024):
        for off in (0, 5, 70):
            if off + 16 > m:
                continue
            x = torch.as_tensor(rng.normal(size=(m, k)).astype(np.float32))
            x = x.to(dtype).to(cuda_device)
            x[off:off + 16] = rows
            out = tq.int8_matmul(x, w, scale)
            assert torch.equal(out[off:off + 16], alone), (m, off)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n", [(4096, 1024), (4096, 128256), (14336, 4096),
                                 (264, 152)],
                         ids=["k_proj", "lm_head", "down_proj", "ragged"])
def test_int8_matmul_gemv_rows_are_alone_at_any_m(cuda_device, k, n, dtype):
    """The GEMV route takes any row count when the caller says each row
    stands alone (a decode step over the engine's slots, the lm_head at
    the logit positions): every row at m=1 is bitwise the same row inside
    m = 8, 16 and 64, one launch per call, so an engine row keeps its
    solo bits past 8 slots. down_proj has the plan's deepest merge (8
    splits); ragged (k=264, n=152) a last split of half a step and an
    8-column tail."""
    rng = np.random.default_rng(k + n)
    x = torch.as_tensor(rng.normal(size=(64, k)).astype(np.float32))
    w = torch.as_tensor(rng.integers(-127, 128, (k, n)).astype(np.int8))
    scale = torch.as_tensor(((rng.random((1, n)) + 0.5)
                             / (127 * k ** 0.5)).astype(np.float32))
    x, w, scale = (x.to(dtype).to(cuda_device), w.to(cuda_device),
                   scale.to(cuda_device))
    alone = [tq.int8_matmul(x[r:r + 1], w, scale, rows_alone=True)
             for r in range(64)]
    for m in (8, 16, 64):
        before = tq.int8_matmul.launches
        out = tq.int8_matmul(x[:m], w, scale, rows_alone=True)
        assert tq.int8_matmul.launches == before + 1
        for r in range(m):
            assert torch.equal(out[r:r + 1], alone[r]), (m, r)


@pytest.mark.parametrize("m,rows_alone,k,n", [
    (16, True, 264, 144), (64, True, 264, 144), (4, False, 264, 144),
    (1, True, 14336, 4096), (8, True, 14336, 4096), (33, True, 14336, 4096),
    (64, True, 14336, 4096)],
    ids=["gemv16", "gemv64", "tiled4", "down-gemv1", "down-gemv8",
         "down-gemv33", "down-gemv64"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_caller_route_matches_plain(cuda_device, m, rows_alone,
                                                k, n, dtype):
    """Each route the caller may pick, at row counts the default would
    send the other way, against the plain version (tolerances as
    ``test_int8_matmul_kernel_matches_plain``); and the GEMV at down_proj
    (its plan's deepest merge, 8 splits of 1,792 rows) at 1 to 64 rows,
    each row group layout of the kernel."""
    rng = np.random.default_rng(m + 7)
    x = torch.as_tensor(rng.normal(size=(m, k)).astype(np.float32)).to(dtype)
    w = torch.as_tensor(rng.integers(-127, 128, (k, n)).astype(np.int8))
    scale = torch.as_tensor(((rng.random((1, n)) + 0.5)
                             / (127 * k ** 0.5)).astype(np.float32))
    x, w, scale = x.to(cuda_device), w.to(cuda_device), scale.to(cuda_device)
    out = tq.int8_matmul(x, w, scale, rows_alone=rows_alone)
    ref = tq.int8_matmul_reference(x, w, scale)
    torch.cuda.synchronize()
    peak = ref.float().abs().max().item()
    tol = (1e-5 if dtype == torch.float32 else 2.0 ** -7) * peak
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("m", [1, 70], ids=["m1", "m70"])
def test_int8_matmul_gemv_merge_leaves_its_counters_zero(cuda_device, m):
    """The GEMV's split merge: the last block of a column tile to arrive
    sums the splits and zeroes the tile's counter, so back-to-back calls
    (and a later CUDA-graph capture) find every counter zero and give the
    same bits; at k_proj (8 splits) with one and two groups of 64 rows."""
    rng = np.random.default_rng(m)
    k, n = 4096, 1024
    assert tq.gemv_plan(k, n)[0] > 1
    x = torch.as_tensor(rng.normal(size=(m, k)).astype(np.float32))
    w = torch.as_tensor(rng.integers(-127, 128, (k, n)).astype(np.int8))
    scale = torch.as_tensor(((rng.random((1, n)) + 0.5)
                             / (127 * k ** 0.5)).astype(np.float32))
    x = x.to(torch.bfloat16).to(cuda_device)
    w, scale = w.to(cuda_device), scale.to(cuda_device)
    first = tq.int8_matmul(x, w, scale, rows_alone=True)
    second = tq.int8_matmul(x, w, scale, rows_alone=True)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    counters = tq._counters[(x.device, stream)]
    assert int(counters.abs().sum()) == 0


def test_int8_matmul_gemv_replays_in_a_cuda_graph(cuda_device):
    """A CUDA graph that captures the split GEMV (k_proj, 8 splits)
    replays it with the eager call's bits, twice: the merge finds its
    counters zero at every replay, as a compiled decode step will need."""
    rng = np.random.default_rng(3)
    k, n = 4096, 1024
    x = torch.as_tensor(rng.normal(size=(8, k)).astype(np.float32))
    w = torch.as_tensor(rng.integers(-127, 128, (k, n)).astype(np.int8))
    scale = torch.as_tensor(((rng.random((1, n)) + 0.5)
                             / (127 * k ** 0.5)).astype(np.float32))
    x = x.to(torch.bfloat16).to(cuda_device)
    w, scale = w.to(cuda_device), scale.to(cuda_device)
    eager = tq.int8_matmul(x, w, scale, rows_alone=True)
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):  # the capture stream's counters exist
        tq.int8_matmul(x, w, scale, rows_alone=True)
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = tq.int8_matmul(x, w, scale, rows_alone=True)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


def test_wrapper_raises_on_cuda_for_unsupported_input(cuda_device):
    w = torch.zeros(16, 12, dtype=torch.int8, device=cuda_device)  # n % 8
    with pytest.raises(ValueError, match="n % 8"):
        tq.int8_matmul(torch.zeros(2, 16, device=cuda_device), w,
                       torch.ones(1, 12, device=cuda_device))


@pytest.mark.parametrize("k,n,dtype,match", [
    (64, 24, torch.bfloat16, "n % 16"),
    (68, 32, torch.bfloat16, "k % 8"),
    (66, 32, torch.float32, "k % 4"),
], ids=["n24", "bf16-k68", "f32-k66"])
def test_wrapper_raises_on_cuda_outside_the_tiled_contract(cuda_device, k, n,
                                                           dtype, match):
    """Above 8 rows the TMA-fed kernel wants 16-byte row strides: a shape
    the GEMV takes (n % 8 == 0) is refused there, never run plain."""
    w = torch.zeros(k, n, dtype=torch.int8, device=cuda_device)
    x = torch.zeros(16, k, dtype=dtype, device=cuda_device)
    before = tq.int8_matmul.launches
    with pytest.raises(ValueError, match=match):
        tq.int8_matmul(x, w, torch.ones(1, n, device=cuda_device))
    assert tq.int8_matmul.launches == before


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


def test_small_paged_engine_at_16_slots_rows_are_solo(cuda_device):
    """Past 8 slots: the paged engine at 16 slots takes 14 concurrent
    requests (one seeded-sampled), so every decode step runs 16 rows and
    grouped prefills run up to 16; every engine row's tokens and logprobs
    are bitwise its solo ``generate`` on the card. The decode's int8
    matmuls and the grouped lm_head take the GEMV at any row count (one
    position per row), as the solo row's do."""
    import threading

    from lambdipy_tpu_torch.runtime.handlers import make_engine

    extra = {"vocab_size": 512, "hidden": 256, "heads": 4, "kv_heads": 2,
             "mlp": 512, "layers": 2, "max_len": 256,
             "attn_backend": "blocked", "matmul_backend": "pallas"}
    adapter = registry.get("llama-tiny").build(quant="int8", extra=extra)
    server = adapter.make_server(adapter.init_params(seed=3, device="cpu"),
                                 device=cuda_device)
    reqs = [(list(range(1 + i, 6 + 3 * i)), 8 + (5 * i) % 13,
             {"temperature": 0.8, "top_p": 0.9, "seed": 7} if i == 5
             else {}) for i in range(14)]
    eng = make_engine(server, {"batch_max": "16", "batch_segment": "4",
                               "kv_paged": "1"})
    outs = [None] * len(reqs)

    def run(i):
        p, n, kw = reqs[i]
        outs[i] = eng.generate(p, max_new_tokens=n, return_logprobs=True,
                               **kw)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(reqs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    stats = eng.stats()
    assert stats["requests_served"] == len(reqs)
    assert stats["mean_rows_per_step"] > 8, stats
    for (p, n, kw), (toks, lps) in zip(reqs, outs):
        want, want_lp = server.generate(p, max_new_tokens=n,
                                        return_logprobs=True, **kw)
        np.testing.assert_array_equal(toks, want)
        np.testing.assert_array_equal(lps, want_lp)


@pytest.mark.parametrize("sb", [16, 128])
@pytest.mark.parametrize("bb", [1, 2, 4, 8])
@pytest.mark.parametrize("attn", ["blocked", "flash"])
def test_grouped_prefill_rows_are_bitwise_alone(cuda_device, attn, bb, sb):
    """The identity the engine's grouped prefills rest on, swept over
    group sizes and prompt buckets on a small bf16 int8 model: each row
    of a ragged ``[bb, sb]`` prefill (the engine's call: logits at each
    row's last position, K/V of every layer) is bitwise the row prefilled
    alone at ``[1, sb]``."""
    extra = {"vocab_size": 512, "hidden": 256, "heads": 4, "kv_heads": 2,
             "mlp": 512, "layers": 2, "max_len": 256,
             "attn_backend": attn, "matmul_backend": "pallas"}
    adapter = registry.get("llama-tiny").build(dtype="bfloat16",
                                               quant="int8", extra=extra)
    model = adapter.make_server(adapter.init_params(seed=3, device="cpu"),
                                device=cuda_device).model
    rng = np.random.default_rng(bb * 1000 + sb)
    tokens = torch.as_tensor(rng.integers(1, 512, (bb, sb)),
                             device=cuda_device)
    length = torch.as_tensor([max(1, sb - 5 * r) for r in range(bb)],
                             device=cuda_device)
    with torch.inference_mode():
        logits, cache = model(tokens, logit_positions=length - 1)
        for r in range(bb):
            lg, c = model(tokens[r:r + 1], logit_positions=length[r:r + 1] - 1)
            assert torch.equal(lg, logits[r:r + 1]), r
            for entry, alone in zip(cache, c):
                assert torch.equal(alone["k"], entry["k"][r:r + 1]), r
                assert torch.equal(alone["v"], entry["v"][r:r + 1]), r


# ------------------------------------------------------ split-KV plan

# lengths at and around the split plan's chunk edges: 0 (uniform mean of
# V over all t), 1, one chunk less one, one chunk, one past it, several
# chunks, and past the window (clamped to t)
SPLIT_T = 4 * tda.KV_CHUNK + 40
SPLIT_LENS = [0, 1, tda.KV_CHUNK - 1, tda.KV_CHUNK, tda.KV_CHUNK + 1,
              3 * tda.KV_CHUNK + 17, SPLIT_T + 300]
GROUPS = pytest.mark.parametrize(
    "h,kvh,d", [(4, 4, 32), (32, 8, 128), (8, 1, 64)],
    ids=["group1", "group4-d128", "group8"])


def _kv_operands(rng, b, t, kvh, d, quant, dtype, device):
    """K/V ``[b, t, kvh, d]`` as float in ``dtype`` or int8 with f32
    scales quantized as the model does, on ``device``."""
    out = {}
    for name in ("k", "v"):
        x = torch.as_tensor(rng.normal(size=(b, t, kvh, d)).astype(np.float32))
        if quant:
            out[name], out[f"{name}_scale"] = _kv_quantize(x)
        else:
            out[name] = x.to(dtype)
    return {n: x.to(device) for n, x in out.items()}


def _contiguous(q, kv, alen):
    scales = ({"k_scale": kv["k_scale"], "v_scale": kv["v_scale"]}
              if "k_scale" in kv else {})
    return tda.blocked_decode_attention(q, kv["k"], kv["v"], alen, **scales)


def _contiguous_plain(q, kv, alen):
    if "k_scale" in kv:
        return tda.int8_kv_decode_attention_reference(
            q, kv["k"], kv["v"], alen, kv["k_scale"], kv["v_scale"])
    return tda.decode_attention_reference(q, kv["k"], kv["v"], alen)


@DTYPES
@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@GROUPS
def test_decode_attention_kernel_at_split_edges(cuda_device, dtype, quant,
                                                h, kvh, d):
    """Kernels 1 and 1b at lengths that span several chunks of the split
    plan and hit their edges, against the plain version."""
    rng = np.random.default_rng(h + kvh + d + 7 * quant)
    b = len(SPLIT_LENS)
    q = torch.as_tensor(rng.normal(size=(b, 1, h, d)).astype(np.float32))
    q = q.to(dtype).to(cuda_device)
    kv = _kv_operands(rng, b, SPLIT_T, kvh, d, quant, dtype, cuda_device)
    alen = torch.as_tensor(np.asarray(SPLIT_LENS, np.int32),
                           device=cuda_device)
    out = _contiguous(q, kv, alen)
    ref = _contiguous_plain(q, kv, alen)
    torch.cuda.synchronize()
    assert _row_rel_err(out, ref) <= ATTN_TOL[dtype]


@DTYPES
@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("page", [16, 32, 128])
@GROUPS
def test_paged_decode_attention_kernel_at_split_edges(cuda_device, dtype,
                                                      quant, page, h, kvh,
                                                      d):
    """Kernel 3 at the same split-edge lengths: against its plain version
    and bitwise the contiguous kernel on the gathered K/V."""
    rng = np.random.default_rng(page + h + kvh + d + quant)
    nb = SPLIT_T // page + 1
    alen = np.asarray(SPLIT_LENS, np.int32)
    b = alen.size
    pages, tables = _paged_case(rng, b, page, nb, kvh, d, quant, alen)
    q = torch.as_tensor(rng.normal(size=(b, 1, h, d)).astype(np.float32))
    q = q.to(dtype).to(cuda_device)
    dev = {name: (x if quant else x.to(dtype)).to(cuda_device)
           for name, x in pages.items()}
    _check_paged(q, dev, tables.to(cuda_device),
                 torch.as_tensor(alen, device=cuda_device), quant, dtype)


@DTYPES
@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_decode_attention_rows_are_batch_invariant(cuda_device, dtype, quant,
                                                   paged):
    """The property the serving engine's bitwise checks rest on: a row's
    output is bitwise the same inside a batch of 8 with one capacity t,
    alone at batch 1 with another (positions past its length NaN, or on a
    table of another width), paged or contiguous, and from launch to
    launch."""
    h, kvh, d, page = 32, 8, 128, 32
    rng = np.random.default_rng(17 + 2 * quant + paged)
    lens = [1, 100, tda.KV_CHUNK, tda.KV_CHUNK + 1, 700, 1000, 1500, 37]
    b, t = len(lens), 1536
    q = torch.as_tensor(rng.normal(size=(b, 1, h, d)).astype(np.float32))
    q = q.to(dtype).to(cuda_device)
    kv = _kv_operands(rng, b, t, kvh, d, quant, dtype, cuda_device)
    alen = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    if paged:
        # the batch's K/V as pages of one arena, tables shuffled
        nb = t // page
        perm = torch.as_tensor(rng.permutation(b * nb) + 1,
                               dtype=torch.int32)
        tables = perm.reshape(b, nb).to(cuda_device)
        arena = {}
        for name, x in kv.items():
            a = torch.zeros((b * nb + 1, page, *x.shape[2:]), dtype=x.dtype,
                            device=cuda_device)
            a[tables.reshape(-1).long()] = x.reshape(b * nb, page,
                                                     *x.shape[2:])
            arena[name] = a
        scales = ({"k_scale_pages": arena["k_scale"],
                   "v_scale_pages": arena["v_scale"]} if quant else {})

        def paged_call(qq, tb, al):
            return tda.paged_decode_attention(qq, arena["k"], arena["v"], tb,
                                              al, **scales)

        out = paged_call(q, tables, alen)
        assert torch.equal(out, _contiguous(q, kv, alen))
    else:
        out = _contiguous(q, kv, alen)
    assert _row_rel_err(out, _contiguous_plain(q, kv, alen)) \
        <= ATTN_TOL[dtype]
    again = paged_call(q, tables, alen) if paged else _contiguous(q, kv,
                                                                   alen)
    assert torch.equal(again, out)
    for r, n in enumerate(lens):
        cap = n + 64 + 29 * r  # another capacity, past the row's length
        if paged:
            own = -(-n // page)
            tb = torch.zeros(1, -(-cap // page), dtype=torch.int32,
                             device=cuda_device)
            tb[0, :own] = tables[r, :own]
            solo = paged_call(q[r:r + 1], tb, alen[r:r + 1])
        else:
            solo_kv = {}
            for name, x in kv.items():
                fill = 0 if x.dtype == torch.int8 else float("nan")
                y = torch.full((1, cap, *x.shape[2:]), fill, dtype=x.dtype,
                               device=cuda_device)
                y[:, :n] = x[r:r + 1, :n]
                solo_kv[name] = y
            solo = _contiguous(q[r:r + 1], solo_kv, alen[r:r + 1])
        assert torch.equal(solo, out[r:r + 1]), f"row {r} ({n} positions)"


def test_wrapper_raises_on_cuda_for_misaligned_kv(cuda_device):
    """The kernel copies K/V in 16-byte pieces: a view that starts off a
    16-byte boundary is refused, not read."""
    q = torch.zeros(1, 1, 4, 32, device=cuda_device)
    flat = torch.zeros(1 * 8 * 4 * 32 + 1, device=cuda_device)
    k = flat[1:].view(1, 8, 4, 32)
    with pytest.raises(ValueError, match="16-byte"):
        tda.blocked_decode_attention(q, k, k, torch.ones(1, dtype=torch.int32,
                                                         device=cuda_device))


# ------------------------------------------------ CUDA-graph decode steps

SMALL = {"vocab_size": 512, "hidden": 256, "heads": 4, "kv_heads": 2,
         "mlp": 512, "layers": 2, "max_len": 256, "matmul_backend": "pallas"}
GRAPH_PATHS = {"A": {"attn_backend": "blocked"},
               "B": {"attn_backend": "blocked", "kv_quant": "int8"},
               "C": {"attn_backend": "flash"}}
SAMPLED = {"temperature": 0.8, "top_k": 50, "top_p": 0.9, "seed": 1234}


def _graph_and_eager(cuda_device, path="A"):
    """A small bf16 int8 model on the card served twice on the same
    weights: with CUDA graphs (the default on the card) and eagerly."""
    adapter = registry.get("llama-tiny").build(
        dtype="bfloat16", quant="int8", extra={**SMALL, **GRAPH_PATHS[path]})
    graph = adapter.make_server(adapter.init_params(seed=3, device="cpu"),
                                device=cuda_device)
    return graph, LlamaServer(graph.model, graphs=False)


@pytest.mark.parametrize("knobs", [{}, SAMPLED], ids=["greedy", "seeded"])
@pytest.mark.parametrize("path", GRAPH_PATHS)
def test_graph_decode_is_bitwise_eager(cuda_device, path, knobs):
    """Paths A, B and C on a small bf16 int8 model: ragged rows decoded by
    replays of the captured step give the eager server's tokens and
    logprobs bitwise, greedy and seeded; every decode step was a replay
    (C's decode attention is plain ``_attend``, cuBLAS inside the graph).
    """
    graph, eager = _graph_and_eager(cuda_device, path)
    rows = [list(range(1, 40)), list(range(5, 12)), [7, 8, 9]]
    for _ in range(2):  # the second request replays the captured program
        got = graph.generate(rows, max_new_tokens=12, return_logprobs=True,
                             **knobs)
        want = eager.generate(rows, max_new_tokens=12, return_logprobs=True,
                              **knobs)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    stats = graph.program_stats()
    # the prefill and the decode step, each captured once
    assert stats["compile_count"] == 2 and stats["eager_steps"] == 0
    assert stats["replays"] == 2 * 11
    assert stats["prefill_replays"] == 2 and stats["eager_prefills"] == 0
    assert eager.program_stats()["eager_steps"] == 2 * 11


def test_graph_replays_count_their_launches(cuda_device):
    """After a capture, N replays add N times one step's launches (2
    layers: 15 int8 matmuls and 2 decode-attention launches); the capture
    itself counts nothing. The prefill's replay adds its forward's 15."""
    graph, _ = _graph_and_eager(cuda_device)
    rows = [list(range(1, 20))]
    mm, attn = tq.int8_matmul.launches, tda.blocked_decode_attention.launches
    graph.generate(rows, max_new_tokens=1)  # the prefill's capture, no step
    assert (tq.int8_matmul.launches - mm,
            tda.blocked_decode_attention.launches - attn) == (15, 0)
    for n in (9, 14):  # one key: the first captures, both replay
        mm = tq.int8_matmul.launches
        attn = tda.blocked_decode_attention.launches
        graph.generate(rows, max_new_tokens=n)
        assert tq.int8_matmul.launches - mm == 15 * n
        assert tda.blocked_decode_attention.launches - attn == 2 * (n - 1)
    stats = graph.program_stats()
    assert stats["compile_count"] == 2 and stats["replays"] == 8 + 13
    assert stats["prefill_replays"] == 3


def _threads(fns, timeout=300):
    out, errors = [None] * len(fns), []

    def run(i):
        try:
            out[i] = fns[i]()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(fns))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=timeout)
    assert not any(th.is_alive() for th in threads)
    if errors:
        raise errors[0]
    return out


@pytest.mark.parametrize("paged", ["1", "0"], ids=["paged", "dense"])
def test_graph_engine_rows_are_bitwise_eager_and_solo(cuda_device, paged):
    """The continuous engine with graphs against the same engine run
    eagerly, on the same weights: concurrent greedy and seeded rows, one
    joining mid-decode, each bitwise the eager engine's row and its solo
    ``generate``; every engine step a replay."""
    from lambdipy_tpu_torch.runtime.handlers import make_engine

    graph, eager = _graph_and_eager(cuda_device)
    reqs = [(list(range(1, 40)), 24, {}),
            (list(range(5, 12)), 20, SAMPLED),
            (list(range(9, 80)), 9, {}),
            (list(range(30, 33)), 16, {"temperature": 0.7, "seed": 3})]
    outs = {}
    for name, server in (("graph", graph), ("eager", eager)):
        eng = make_engine(server, {"batch_max": "4", "batch_segment": "4",
                                   "kv_paged": paged})

        def call(i, eng=eng):
            time.sleep(0.2 if i == 3 else 0.0)  # a joiner mid-decode
            p, n, kw = reqs[i]
            return eng.generate(p, max_new_tokens=n, return_logprobs=True,
                                **kw)

        outs[name] = _threads([lambda i=i: call(i) for i in range(4)])
        stats = eng.stats()
        if name == "graph":
            # the decode programs and a prefill program per group shape
            shapes = [k for k in server.program_stats()["program_pools"]
                      if k[0] == "prefill"]
            assert stats["replays"] == stats["steps"] > 0
            assert stats["eager_steps"] == 0
            assert stats["compile_count"] == 2 + len(shapes)
            assert stats["eager_prefills"] == 0
            assert stats["prefill_replays"] == stats["prefill_groups"]
    for (p, n, kw), g, e in zip(reqs, outs["graph"], outs["eager"]):
        np.testing.assert_array_equal(g[0], e[0])
        np.testing.assert_array_equal(g[1], e[1])
        solo = graph.generate(p, max_new_tokens=n, return_logprobs=True,
                              **kw)
        np.testing.assert_array_equal(g[0], solo[0])
        np.testing.assert_array_equal(g[1], solo[1])


@pytest.mark.parametrize("paged", ["1", "0"], ids=["paged", "dense"])
def test_pipelined_engine_rows_are_bitwise_depth1_and_solo(cuda_device,
                                                            paged):
    """The continuous engine with graphs at pipeline depths 1, 2 and 3 on
    the same weights: concurrent greedy and seeded rows, one with an eos
    it meets early (its blocks behind the frontier dropped) and one
    joining mid-decode (a bounded drain). Every row of depths 2 and 3 is
    bitwise the depth-1 engine's and its solo ``generate``, tokens and
    logprobs; every engine step a replay, over-decoded steps included."""
    from lambdipy_tpu_torch.runtime.handlers import make_engine

    graph, _ = _graph_and_eager(cuda_device)
    free = graph.generate(list(range(60, 70)), max_new_tokens=30)[0]
    reqs = [(list(range(1, 40)), 24, {}),
            (list(range(5, 12)), 20, SAMPLED),
            (list(range(60, 70)), 30, {"eos_id": int(free[5])}),
            (list(range(9, 80)), 9, {}),
            (list(range(30, 33)), 16, {"temperature": 0.7, "seed": 3})]
    outs = {}
    for depth in (1, 2, 3):
        eng = make_engine(graph, {"batch_max": "4", "batch_segment": "4",
                                  "kv_paged": paged,
                                  "pipeline_depth": str(depth)})

        def call(i, eng=eng):
            time.sleep(0.2 if i == 4 else 0.0)  # a joiner mid-decode
            p, n, kw = reqs[i]
            return eng.generate(p, max_new_tokens=n, return_logprobs=True,
                                **kw)

        outs[depth] = _threads([lambda i=i: call(i) for i in range(5)])
        with eng._lock:
            while eng._engine_running:
                eng._lock.wait(0.05)
        stats = eng.stats()
        assert stats["replays"] == stats["steps"] > 0
        assert stats["eager_steps"] == 0
        pipe = stats["pipeline"]
        assert max(int(d) for d in pipe["in_flight"]) <= depth
        assert pipe["segments"] == pipe["dispatches"] == stats["segments"]
        if paged == "1":
            assert stats["page_pool"]["pages_live"] == 0
    for i, (p, n, kw) in enumerate(reqs):
        solo = graph.generate(p, max_new_tokens=n, return_logprobs=True,
                              **kw)
        for depth in (1, 2, 3):
            np.testing.assert_array_equal(outs[depth][i][0], solo[0])
            np.testing.assert_array_equal(outs[depth][i][1], solo[1])


def test_two_streams_of_one_bucket_keep_their_solo_bits(cuda_device):
    """Two streams of one key advanced in turns each hold a program of
    their own (captured anew) and give their solo tokens and logprobs."""
    graph, eager = _graph_and_eager(cuda_device)
    a, b = list(range(1, 20)), list(range(40, 52))
    sa = graph.generate_stream([a], max_new_tokens=12, segment=4,
                               return_logprobs=True)
    sb = graph.generate_stream([b], max_new_tokens=12, segment=4,
                               return_logprobs=True)
    chunks = list(zip(sa, sb))
    for i, prompt in enumerate((a, b)):
        want = eager.generate([prompt], max_new_tokens=12,
                              return_logprobs=True)
        np.testing.assert_array_equal(
            np.concatenate([c[i][0] for c in chunks], 1), want[0])
        np.testing.assert_array_equal(
            np.concatenate([c[i][1] for c in chunks], 1), want[1])
    # each stream's prefill and decode step
    assert graph.program_stats()["compile_count"] == 4


def test_graph_programs_past_the_byte_bound_are_freed(cuda_device):
    """A byte bound below one entry's cache: every entry is evicted when
    its request ends, its graphs reset, and the next request of the same
    key captures anew and stays bitwise the eager server's."""
    graph, eager = _graph_and_eager(cuda_device)
    bounded = LlamaServer(graph.model, program_cache_bytes=1)
    rows = [list(range(1, 30)), [4, 5, 6]]
    for n in (9, 9, 20):
        got = bounded.generate(rows, max_new_tokens=n, return_logprobs=True)
        want = eager.generate(rows, max_new_tokens=n, return_logprobs=True)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    stats = bounded.program_stats()
    assert stats["program_bytes"] == 0 and stats["program_evictions"] == 3
    assert stats["compile_count"] == 6 and stats["replays"] == 8 + 8 + 19
    assert stats["prefill_replays"] == 3


def test_capture_beside_a_request_thread_prefill(cuda_device, monkeypatch):
    """Captures (a new server key on one thread, the engine's first graph
    on its thread) while long prompts prefill on their request threads
    and a stream decodes: the process's device lock keeps every capture
    alone, and every output is bitwise its eager twin's."""
    from lambdipy_tpu_torch.runtime import continuous
    from lambdipy_tpu_torch.runtime.handlers import make_engine

    monkeypatch.setattr(continuous, "GROUP_PREFILL_MAX", 8)
    graph, eager = _graph_and_eager(cuda_device)
    eng = make_engine(graph, {"batch_max": "4", "batch_segment": "4",
                              "kv_paged": "1"})
    long_rows = [list(range(3 + i, 60 + 20 * i)) for i in range(3)]
    fns = [lambda p=p: eng.generate(p, max_new_tokens=10,
                                    return_logprobs=True)
           for p in long_rows]
    fns.append(lambda: graph.generate([list(range(2, 9))] * 2,
                                      max_new_tokens=11,
                                      return_logprobs=True, **SAMPLED))
    fns.append(lambda: [c for c in graph.generate_stream(
        [list(range(50, 70))], max_new_tokens=10, segment=4,
        return_logprobs=True)])
    outs = _threads(fns)
    for p, got in zip(long_rows, outs):
        want = eager.generate(p, max_new_tokens=10, return_logprobs=True)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    want = eager.generate([list(range(2, 9))] * 2, max_new_tokens=11,
                          return_logprobs=True, **SAMPLED)
    np.testing.assert_array_equal(outs[3][1], want[1])
    want = eager.generate([list(range(50, 70))], max_new_tokens=10,
                          return_logprobs=True)
    np.testing.assert_array_equal(np.concatenate([c[1] for c in outs[4]], 1),
                                  want[1])
    assert eng.stats()["row_prefills"] == 3


# ------------------------------------------------ the prefix KV cache

PREFIX_HEAD = list(range(3, 100))  # 97 tokens of shared head
PREFIX_ROWS = [(PREFIX_HEAD + [200, 201], {}),
               (PREFIX_HEAD + list(range(300, 340)), SAMPLED),
               (PREFIX_HEAD[:40] + [7, 8, 9], {}),
               (PREFIX_HEAD + [400], {"temperature": 0.7, "seed": 3})]


@pytest.mark.parametrize("paged", ["1", "0"], ids=["paged", "dense"])
def test_routed_engine_rows_are_bitwise_solo(cuda_device, paged):
    """Routed rows through the continuous engine with the prefix store
    (the paged store shares the engine's arena), concurrent, greedy and
    seeded: each row's tokens and logprobs are bitwise its solo routed
    run from the same prefix K/V (a dense store walked in the same order
    registers it); the paged store assembles nothing."""
    from lambdipy_tpu_torch.runtime.handlers import make_engine
    from lambdipy_tpu_torch.runtime.prefixstore import PrefixStore

    graph, _ = _graph_and_eager(cuda_device)
    eng = make_engine(graph, {"batch_max": "4", "batch_segment": "4",
                              "kv_paged": paged, "prefix_block": "16"})
    store = PrefixStore(graph, block=16, pool=eng.pool)
    if eng.pool is not None:
        eng.prefix_pages_fn = store.acquire_pages
    solo_store = PrefixStore(graph, block=16)
    ms = [store.route(row) for row, _ in PREFIX_ROWS]
    assert ms == [solo_store.route(row) for row, _ in PREFIX_ROWS]
    assert all(ms)

    def call(i):
        row, kw = PREFIX_ROWS[i]
        return eng.generate(row[ms[i]:], prefix=row[:ms[i]],
                            max_new_tokens=12, return_logprobs=True, **kw)

    outs = _threads([lambda i=i: call(i) for i in range(len(PREFIX_ROWS))])
    for i, ((row, kw), got) in enumerate(zip(PREFIX_ROWS, outs)):
        solo_store.route(row)  # its entry registered (assembled if evicted)
        want = graph.generate(row[ms[i]:], prefix=row[:ms[i]],
                              max_new_tokens=12, return_logprobs=True, **kw)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    stats = eng.stats()
    assert stats["prefix_joins"] == len(PREFIX_ROWS)
    assert stats["replays"] == stats["steps"] > 0
    if eng.pool is not None:
        assert store.stats()["assembly_bytes_peak"] == 0
        assert eng.pool.stats()["pages_live"] == store.stats()["blocks"]
        assert store.check_invariants()["ok"]


@pytest.mark.parametrize("knobs", [{}, SAMPLED], ids=["greedy", "seeded"])
@pytest.mark.parametrize("path", GRAPH_PATHS)
def test_graph_decode_after_a_continuation_is_bitwise_eager(cuda_device,
                                                            path, knobs):
    """``generate(prefix=)`` and its stream, with graphs against the
    eager server on the same weights, on paths A, B and C: the suffix
    continued from the prefix entry in the step's own cache, then every
    decode step a replay of the step's graph, bitwise the eager steps;
    the prefix entry keeps its bits."""
    graph, eager = _graph_and_eager(cuda_device, path)
    prefix, suffix = PREFIX_HEAD[:64], list(range(150, 170))
    for _ in range(2):
        got = graph.generate(suffix, prefix=prefix, max_new_tokens=12,
                             return_logprobs=True, **knobs)
        want = eager.generate(suffix, prefix=prefix, max_new_tokens=12,
                              return_logprobs=True, **knobs)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    chunks = list(graph.generate_stream(suffix, prefix=prefix,
                                        max_new_tokens=12, segment=4,
                                        return_logprobs=True, **knobs))
    np.testing.assert_array_equal(np.concatenate([c[1] for c in chunks], 1),
                                  want[1])
    stats = graph.program_stats()
    assert stats["eager_steps"] == 0 and stats["replays"] == 3 * 11 + 1
    assert stats["prefix_entries"] == 1


def test_prefix_walk_first_chunk_runs_flash(cuda_device):
    """Under ``attn_backend="flash"`` a cold walk's first chunk (no cache
    yet) runs the flash kernel, one launch per layer, and writes the K/V
    that the plain backend (``dense``) writes on the same weights, within
    ``chip_smoke.py``'s K/V limit (max |diff| / max |value| <= 0.1);
    extension chunks and the continuation attend with plain ``_attend``
    (no launch)."""
    from lambdipy_tpu_torch.runtime.prefixstore import PrefixStore

    flash, _ = _graph_and_eager(cuda_device, "C")
    adapter = registry.get("llama-tiny").build(
        dtype="bfloat16", quant="int8",
        extra={**SMALL, "attn_backend": "dense"})
    plain = adapter.make_server(adapter.init_params(seed=3, device="cpu"),
                                device=cuda_device)
    row = PREFIX_HEAD + [5, 6]  # 99 tokens: target 96, a 16-wide first
    caches = {}
    for name, server in (("flash", flash), ("plain", plain)):
        store = PrefixStore(server, block=16)
        before = tat.flash_attention.launches
        assert store.route(row) == 96
        launched = tat.flash_attention.launches - before
        assert launched == (server.model.cfg.layers if name == "flash"
                            else 0)
        assert store.stats()["prefill"]["rounds"] == 6
        caches[name] = server.get_prefix(server._prefix_key(row[:96]))[0]
    for g, w in zip(caches["flash"], caches["plain"]):
        for leaf in ("k", "v"):
            a, b = g[leaf][:, :96].float(), w[leaf][:, :96].float()
            assert ((a - b).abs().max() / b.abs().max()).item() <= 0.1
    before = tat.flash_attention.launches
    flash.generate(row[96:], prefix=row[:96], max_new_tokens=4)
    assert tat.flash_attention.launches == before


def test_routed_against_unrouted_stays_within_its_bound(cuda_device):
    """On the card a routed request is not bitwise its unrouted twin: a
    continuation's softmax and PV reduce over the whole window, an
    unrouted prefill's over its bucket (ROADMAP section 3). The bound, as
    ``chip_smoke.py`` path E's: greedy tokens equal, and the first
    token's logprob within 0.05 of the unrouted one."""
    from lambdipy_tpu_torch.runtime.prefixstore import PrefixStore

    graph, _ = _graph_and_eager(cuda_device)
    store = PrefixStore(graph, block=16)
    rng = np.random.default_rng(5)
    for n in (40, 99, 150, 230):
        row = rng.integers(1, 512, n).tolist()
        m = store.route(row)
        assert m == (n - 1) // 16 * 16
        routed = graph.generate(row[m:], prefix=row[:m], max_new_tokens=8,
                                return_logprobs=True)
        unrouted = graph.generate(row, max_new_tokens=8,
                                  return_logprobs=True)
        np.testing.assert_array_equal(routed[0], unrouted[0])
        assert abs(float(routed[1][0, 0] - unrouted[1][0, 0])) <= 0.05


CHUNKED_ROWS = [(list(range(3, 63)), {}),             # 60: 3 chunks + 12
                (list(range(10, 110)), SAMPLED),      # 100: 6 chunks + 4
                (list(range(40, 73)), {}),            # 33: 2 chunks + 1
                (list(range(90, 110)), {}),           # 20: 1 chunk + 4
                (list(range(5, 12)), {}),             # 7: a grouped row
                (list(range(7, 207)), {"temperature": 0.7, "seed": 3})]


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("paged", ["1", "0"], ids=["paged", "dense"])
def test_chunked_engine_rows_are_bitwise_solo(cuda_device, monkeypatch,
                                              paged, depth):
    """Long joiners on a ``prefill_chunk=16`` server prefill in chunks on
    their request threads while other rows decode, dense and paged, at
    pipeline depths 1-3: every chunked row's tokens and logprobs are
    bitwise its solo ``generate(row[split:], prefix=row[:split])`` (the
    same walk and continuation over the same window), a grouped row's
    its solo ``generate``; every decode step a replay."""
    from lambdipy_tpu_torch.runtime import continuous
    from lambdipy_tpu_torch.runtime.handlers import make_engine

    monkeypatch.setattr(continuous, "GROUP_PREFILL_MAX", 8)
    adapter = registry.get("llama-tiny").build(
        dtype="bfloat16", quant="int8", extra={**SMALL, **GRAPH_PATHS["A"]})
    graph = adapter.make_server(adapter.init_params(seed=3, device="cpu"),
                                device=cuda_device, prefill_chunk=16)
    eng = make_engine(graph, {"batch_max": "4", "batch_segment": "4",
                              "kv_paged": paged, "prefix_block": "16",
                              "pipeline_depth": str(depth)})

    def call(i):
        row, kw = CHUNKED_ROWS[i]
        return eng.generate(row, max_new_tokens=12, return_logprobs=True,
                            **kw)

    outs = _threads([lambda i=i: call(i) for i in range(len(CHUNKED_ROWS))])
    chunks = 0
    for (row, kw), got in zip(CHUNKED_ROWS, outs):
        split = (len(row) - 1) // 16 * 16
        if len(row) > 8:
            chunks += split // 16
            want = graph.generate(row[split:], prefix=row[:split],
                                  max_new_tokens=12, return_logprobs=True,
                                  **kw)
        else:
            want = graph.generate(row, max_new_tokens=12,
                                  return_logprobs=True, **kw)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    stats = eng.stats()
    assert stats["prefill_chunks"] == chunks and stats["row_prefills"] == 5
    assert stats["replays"] == stats["steps"] > 0
    if eng.pool is not None:
        assert eng.pool.stats()["pages_live"] == 0


# ------------------------------------------------ speculative decoding

@DTYPES
@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_decode_attention_row_map_matches_plain(cuda_device, dtype, quant):
    """The contiguous kernel's row map (a verify chunk's one-token rows
    over their sequence's cache row): each query row reads cache row
    ``row_map[r]`` at its own length; the output is bitwise the kernel's
    on K/V gathered row by row (only the origin of the reads moves) and
    within ``ATTN_TOL`` of the plain version."""
    rng = np.random.default_rng(7)
    rows, t, h, kvh, d, kb = 3, 300, 32, 8, 128, 4
    k, v = (torch.as_tensor(rng.normal(size=(rows, t, kvh, d))
                            .astype(np.float32)).to(cuda_device)
            for _ in range(2))
    scales = {}
    if quant:
        (k, ks), (v, vs) = _kv_quantize(k), _kv_quantize(v)
        scales = {"k_scale": ks, "v_scale": vs}
    else:
        k, v = k.to(dtype), v.to(dtype)
    n = rows * kb
    q = torch.as_tensor(rng.normal(size=(n, 1, h, d)).astype(np.float32)) \
        .to(dtype).to(cuda_device)
    row_map = torch.arange(rows, dtype=torch.int32,
                           device=cuda_device).repeat_interleave(kb)
    alen = (torch.tensor([5, 129, 250], dtype=torch.int32,
                         device=cuda_device).repeat_interleave(kb)
            + torch.arange(kb, dtype=torch.int32,
                           device=cuda_device).repeat(rows))
    counter = "launches_int8kv" if quant else "launches"
    before = getattr(tda.blocked_decode_attention, counter)
    out = tda.blocked_decode_attention(q, k, v, alen, row_map=row_map,
                                       **scales)
    gathered = {name: val[row_map.long()].contiguous()
                for name, val in (("k", k), ("v", v), *scales.items())}
    alone = tda.blocked_decode_attention(
        q, gathered.pop("k"), gathered.pop("v"), alen, **gathered)
    ref = tda.blocked_decode_attention(q.cpu(), k.cpu(), v.cpu(),
                                       alen.cpu(), row_map=row_map.cpu(),
                                       **{n_: s.cpu()
                                          for n_, s in scales.items()})
    torch.cuda.synchronize()
    assert getattr(tda.blocked_decode_attention, counter) == before + 2
    assert torch.equal(out, alone)
    assert _row_rel_err(out.cpu(), ref) <= ATTN_TOL[dtype]


SPEC_MODEL = {"vocab_size": 2048, "hidden": 512, "heads": 8, "kv_heads": 2,
              "mlp": 1024, "layers": 3, "max_len": 512,
              "matmul_backend": "pallas", "attn_backend": "blocked"}


def _spec_model(cuda_device, kv_quant=None):
    extra = {**SPEC_MODEL, **({"kv_quant": kv_quant} if kv_quant else {})}
    adapter = registry.get("llama-tiny").build(dtype="bfloat16",
                                               quant="int8", extra=extra)
    return adapter.make_server(adapter.init_params(seed=5, device="cpu"),
                               device=cuda_device)


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["float", "int8kv"])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_verify_forward_is_bitwise_the_one_token_steps(cuda_device, paged,
                                                       kv_quant):
    """A verify of 8 slots x kb = 8 (64 one-token rows: the GEMV's one
    pass) is the 8 one-token steps it stands for, bitwise: the logits at
    every chunk position, every layer's K/V at every verified position
    (the whole cache), and, with drafts equal to the greedy chain, the
    tokens, logprobs and carry."""
    from lambdipy_tpu_torch.models import llama as tl

    model = _spec_model(cuda_device, kv_quant).model
    cfg = model.cfg
    b, kb, width, page = 8, 8, 512, 32

    def fresh():
        if not paged:
            return tl.DecodeStep(model, tl.init_decode_cache(
                cfg, b, width, cuda_device), b)
        arena = tl.init_page_arena(cfg, 1 + b * width // page, page,
                                   cuda_device)
        tables = torch.randperm(b * width // page, generator=torch.
                                Generator().manual_seed(3)).add(1) \
            .to(torch.int32).view(b, -1).to(cuda_device)
        return tl.DecodeStep(model, arena, b, tables=tables)

    start = torch.tensor([3, 40, 5, 129, 200, 17, 64, 300],
                         dtype=torch.int32, device=cuda_device)
    first = torch.arange(100, 100 + b, device=cuda_device)
    streams = tl.row_streams([(1, r) for r in range(b)])
    logits = []
    real = model.forward

    def recording(*args, **kw):
        out = real(*args, **kw)
        logits.append(out[0][:, -1, :].float().clone())
        return out

    with torch.inference_mode():
        plain, spec = fresh(), fresh()
        for step in (plain, spec):
            step.load(first, torch.zeros(b, device=cuda_device), start,
                      [-1] * b, streams)
        model.forward = recording
        try:
            toks, lps = tl._scan_decode(lambda: plain.step(False), plain,
                                        kb, segment=True)
        finally:
            model.forward = real
        vstep = tl.VerifyStep(spec, kb)
        vstep.set_drafts(toks[:, 1:].cpu().numpy())
        _, _, lg = vstep._forward()
        for j in range(kb):
            assert torch.equal(lg.view(b, kb, -1)[:, j], logits[j]), j
        for pe, se in zip(plain.cache, spec.cache):
            for name, val in tl._leaves(pe).items():
                assert torch.equal(se[name], val), name
        again = fresh()
        again.load(first, torch.zeros(b, device=cuda_device), start,
                   [-1] * b, streams)
        vstep = tl.VerifyStep(again, kb)
        vstep.set_drafts(toks[:, 1:].cpu().numpy())
        chunk, vlps, count, _ = vstep.run(False)
        torch.cuda.synchronize()
    assert count.tolist() == [kb] * b
    assert torch.equal(chunk, toks) and torch.equal(vlps, lps)
    for name in ("tok", "lp", "pos", "draw"):
        assert torch.equal(getattr(again, name), getattr(plain, name)), name


SPEC_REQS = [(list(range(1, 30)) * 2, 40, {}),
             ([5, 6, 7, 8] * 6, 33, {}),
             (list(range(50, 90)), 25, SAMPLED),
             (list(range(9, 20)) * 3, 30, {"temperature": 1.1, "seed": 4})]


@pytest.mark.parametrize("mode", ["lookup", "model"])
@pytest.mark.parametrize("depth", ["1", "2"])
@pytest.mark.parametrize("paged", ["1", "0"], ids=["paged", "dense"])
def test_spec_engine_rows_are_bitwise_spec_off(cuda_device, paged, depth,
                                               mode):
    """The engine at ``spec_k = 8`` (lookup drafts; the model tier at
    ``draft_exit`` 1) on the card, dense and paged, pipeline depths 1 and
    2: every row, greedy and seeded-sampled, is bitwise the spec-off
    engine's in tokens and logprobs; every verify is a graph replay."""
    from lambdipy_tpu_torch.runtime.handlers import make_engine

    server = _spec_model(cuda_device)
    extra = {"batch_max": "4", "batch_segment": "4", "kv_paged": paged,
             "pipeline_depth": depth}

    def run(eng):
        return _threads([lambda r=r: eng.generate(
            r[0], max_new_tokens=r[1], return_logprobs=True, **r[2])
            for r in SPEC_REQS])

    want = run(make_engine(server, extra))
    eng = make_engine(server, {**extra, "spec_k": "8", "draft_mode": mode})
    got = run(eng)
    for (t, lp), (wt, wlp) in zip(got, want):
        np.testing.assert_array_equal(t, wt)
        np.testing.assert_array_equal(lp, wlp)
    stats = eng.stats()
    assert stats["verify_segments"] >= 1 and stats["eager_steps"] == 0
    assert stats["replays"] == stats["steps"]


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["float", "int8kv"])
def test_solo_greedy_speculative_is_bitwise_plain(cuda_device, kv_quant):
    """Solo greedy speculation on the card: tokens and logprobs bitwise
    plain ``generate``'s, fused and streamed, for k = 2 and 8; every
    verify a replay."""
    server = _spec_model(cuda_device, kv_quant)
    prompt = [5, 6, 7, 8] * 5 + list(range(30, 50))
    want = server.generate(prompt, max_new_tokens=48, return_logprobs=True)
    for k in (2, 8):
        got = server.generate_speculative(prompt, max_new_tokens=48, k=k,
                                          return_logprobs=True)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        pairs = list(server.generate_speculative_stream(
            prompt, max_new_tokens=48, k=k, return_logprobs=True))
        np.testing.assert_array_equal(
            np.concatenate([p[1] for p in pairs], axis=1), want[1])
    assert server.program_stats()["eager_steps"] == 0


# ------------------------------------------- K/V ship and host offload

SHIP_ROW = list(range(3, 100)) + [7, 8]  # 99 tokens: 96 routed, 6 blocks
SHIP_ENGINE = {"batch_max": "4", "batch_segment": "4", "kv_paged": "1",
               "prefix_block": "16"}


def _paged_store(server, **extra):
    from lambdipy_tpu_torch.runtime.handlers import make_engine
    from lambdipy_tpu_torch.runtime.prefixstore import PrefixStore

    eng = make_engine(server, {**SHIP_ENGINE, **extra})
    store = PrefixStore(server, block=16, pool=eng.pool)
    eng.prefix_pages_fn = store.acquire_pages
    return eng, store


def _routed_run(eng, store, row, **kw):
    """The routed row through the engine, and the engine idle after it
    (the row's page refs dropped)."""
    m = store.route(row)
    out = eng.generate(row[m:], prefix=row[:m], max_new_tokens=12,
                       return_logprobs=True, **kw)
    deadline = time.monotonic() + 30
    with eng._lock:
        while eng._engine_running and time.monotonic() < deadline:
            eng._lock.wait(0.05)
    return m, out


def _stream_frames(store, row) -> list:
    """A streamed export of ``row``'s head as wire frames."""
    from lambdipy_tpu_torch.runtime import kvwire

    head, groups = store.export_stream(row)
    leaves = [[name, kvwire.dtype_name(dt), list(shape)]
              for name, (shape, dt) in sorted(store._leaf_template().items())]
    frames = [kvwire.encode_stream_header(head, store.block,
                                          store.server.model.cfg.layers,
                                          leaves)]
    sent = 0
    for group in groups:
        frames.append(kvwire.encode_chunk(sent, group))
        sent += len(group)
    return frames


@pytest.mark.parametrize("streamed", [False, True],
                         ids=["frame", "stream"])
def test_imported_pages_route_bitwise_the_exporters_run(cuda_device,
                                                        streamed):
    """A head exported by one paged engine's store (one frame, or a stream
    of chunks staged as they arrive) and imported into a second engine's
    store on the same weights: the importer routes the prompt with no
    walk, every block a hit, and its row is bitwise the exporter's
    routed row."""
    from lambdipy_tpu_torch.runtime import kvwire
    from lambdipy_tpu_torch.runtime.kvwire import StreamDecoder

    graph, _ = _graph_and_eager(cuda_device)
    eng_a, store_a = _paged_store(graph)
    m, want = _routed_run(eng_a, store_a, SHIP_ROW, **SAMPLED)
    assert m == 96
    eng_b, store_b = _paged_store(LlamaServer(graph.model))
    if streamed:
        dec, imp = StreamDecoder(), None
        for frame in _stream_frames(store_a, SHIP_ROW):
            for kind, payload in dec.feed(frame):
                if kind == "header":
                    imp = store_b.import_begin(payload["tokens"])
                else:
                    imp.add_blocks(payload[1])
        res = imp.commit()
    else:
        head, blocks = store_a.export_blocks(SHIP_ROW)
        tokens, _, blocks = kvwire.decode_frame(
            kvwire.encode_frame(head, 16, blocks))
        res = store_b.import_blocks(tokens, blocks)
    assert res["inserted"] == 6 and res["mode"] == "paged"
    m_b, got = _routed_run(eng_b, store_b, SHIP_ROW, **SAMPLED)
    assert m_b == 96 and store_b.prefill_stats.report()["rounds"] == 0
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert store_b.check_invariants()["ok"]


def test_reonlined_pages_are_bitwise_never_spilled(cuda_device):
    """Every page of a routed head spilled to the host offload arena and
    re-onlined by the next hit: the row is bitwise the row served before
    the head left the card. With ``offload_stall`` armed the re-online
    fails, the head is walked again from its first block (counted as a
    recompute) and the row is still bitwise."""
    from lambdipy_tpu_torch.runtime.offload import OffloadArena

    graph, _ = _graph_and_eager(cuda_device)
    eng, store = _paged_store(graph)
    store.attach_offload(OffloadArena(page=16, layers=2, budget_mb=64,
                                      faults=eng.faults))
    m, want = _routed_run(eng, store, SHIP_ROW, **SAMPLED)
    for armed in (False, True):
        while store.reclaim_pages(16):
            pass
        assert store.check_invariants()["offloaded_blocks"] == 6
        if armed:
            eng.faults.arm("offload_stall:exception")
        _, got = _routed_run(eng, store, SHIP_ROW, **SAMPLED)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    rep = eng.pool.stats()["kv_offload"]
    assert rep["reonline_pages"] == 6 and rep["recomputes"] == 6
    assert store.check_invariants()["ok"]


def test_arena_page_read_is_ordered_on_the_serving_stream(cuda_device):
    """A page read right after a write that the card has not run yet (a
    long ``_sleep`` enqueued ahead of it) returns the written values: the
    read is ordered on the serving stream, not on the host's clock."""
    from lambdipy_tpu_torch.models.llama import (init_page_arena,
                                                 arena_page_slices)

    graph, _ = _graph_and_eager(cuda_device)
    arena = init_page_arena(graph.model.cfg, 4, 16, cuda_device)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # ~0.1 s of the card's clock
    for entry in arena:
        entry["k"][2].fill_(3.0)
    block = arena_page_slices(arena, [2])[0]
    assert all(bool((b["k"] == 3.0).all()) for b in block)
    assert block[0]["k"].shape == (1, 16, 2, 64)


# -- the long-context tier on the card -----------------------------------------


def _longctx_engine(cuda_device, monkeypatch, **extra):
    """SMALL's bf16 int8 model (window 256) behind a paged engine with the
    long-context tier on, on a server that walks 128-token chunks (the
    runner's half-window schedule); long joiners past 8 tokens chunk."""
    from lambdipy_tpu_torch.runtime import continuous
    from lambdipy_tpu_torch.runtime.handlers import make_engine

    monkeypatch.setattr(continuous, "GROUP_PREFILL_MAX", 8)
    adapter = registry.get("llama-tiny").build(
        dtype="bfloat16", quant="int8", extra={**SMALL, **GRAPH_PATHS["A"]})
    server = adapter.make_server(adapter.init_params(seed=3, device="cpu"),
                                 device=cuda_device, prefill_chunk=128)
    return make_engine(server, {"batch_max": "2", "batch_segment": "8",
                                "kv_paged": "1", "prefix_block": "16",
                                "max_logical_ctx": str(8 * 256), **extra})


def _lc_row(n, seed):
    return np.random.default_rng(seed).integers(5, 500, size=n).tolist()


def test_long_context_runner_identities(cuda_device, monkeypatch):
    """At base 0 a 200-token row through the runner (a 128-token chunk,
    then the tail) is bitwise the engine's chunked row over the same
    schedule; at 3x the window the second run, a churned run
    (``resident_cap``) and a replay after an ``offload_stall`` re-online
    failure are bitwise the first run (tokens and logprobs); every
    decode step of the runner is a graph replay, the prefill chunks run
    eagerly; no page leaks."""
    eng = _longctx_engine(cuda_device, monkeypatch)
    runner = eng._longctx_runner()
    short = _lc_row(200, 1)
    got = runner.generate(short, max_new_tokens=24, return_logprobs=True)
    want = eng.generate(short, max_new_tokens=24, return_logprobs=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    row = _lc_row(3 * 256, 2)
    first = runner.generate(row, max_new_tokens=24, return_logprobs=True)
    runs = [runner.generate(row, max_new_tokens=24, return_logprobs=True)]
    runner.resident_cap = runner.n_view - 3
    runs.append(runner.generate(row, max_new_tokens=24,
                                return_logprobs=True))
    rep = runner.report()
    assert rep["prefetch_hits"] > 0 and rep["recomputes"] == 0
    # the engine's plan reaches the runner's arena (the pool's)
    eng.faults.arm("offload_stall:exception")
    runs.append(runner.generate(row, max_new_tokens=24,
                                return_logprobs=True))
    assert runner.report()["recomputes"] > 0
    for run in runs:
        for a, b in zip(run, first):
            np.testing.assert_array_equal(a, b)
    rep = runner.report()
    assert rep["replays"] == rep["steps"] and rep["eager_steps"] == 0
    assert rep["eager_prefills"] == rep["chunks"] \
        and rep["prefill_replays"] == 0
    assert eng.pool.free_count() == eng.pool.capacity_pages
    eng.pool.check_invariants()


def test_long_context_spill_reads_what_the_card_wrote(cuda_device,
                                                      monkeypatch):
    """A slide's spill reads the pages right after the chunk or segment
    that wrote them was enqueued: with a ~0.1 s ``_sleep`` enqueued ahead
    of every slide the spilled bytes are the bytes of a run without it
    (the read is ordered on the serving stream), and so are the tokens."""
    eng = _longctx_engine(cuda_device, monkeypatch)
    runner = eng._longctx_runner()
    row = _lc_row(3 * 256, 3)
    spilled = []
    spill = runner.offload.spill

    def record(key, tokens, block):
        spilled[-1].append(b"".join(
            v.contiguous().view(torch.uint8).numpy().tobytes()
            for entry in block for _, v in sorted(entry.items())))
        return spill(key, tokens, block)

    monkeypatch.setattr(runner.offload, "spill", record)
    slide = runner._slide

    def slept(st, k):
        torch.cuda._sleep(200_000_000)
        return slide(st, k)

    outs = []
    for fn in (slide, slept):
        spilled.append([])
        monkeypatch.setattr(runner, "_slide", fn)
        outs.append(runner.generate(row, max_new_tokens=24,
                                    return_logprobs=True))
    assert spilled[0] and spilled[0] == spilled[1]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


# the classify forwards (ResNet-50, BERT-base, bf16): no TPU kernel, plain
# cuDNN and cuBLAS calls captured as one CUDA graph. Bound on max |card -
# CPU f32| / max |CPU f32| of the logits, the CPU forward in f32 on the
# same weights: the card rounds every activation to bf16 (2^-8 of a
# value). A random BERT's two logits are small beside its hidden state,
# so the noise that state carries is a larger share of them; BERT's last
# hidden state is held at 0.05 too. Measured on an H100 (NVIDIA H100
# 80GB HBM3, 700 W): ResNet-50 2.1e-3, BERT-base 0.11
CLASSIFY_CPU_BOUND = {"resnet50": 1e-2, "bert-base": 0.3}


def _classify_inputs(name):
    rng = np.random.default_rng(0)
    if name == "resnet50":
        return (torch.from_numpy(rng.uniform(
            0, 1, (1, 224, 224, 3)).astype(np.float32)),)
    ids = torch.from_numpy(rng.integers(1, 30522, (1, 128)))
    mask = torch.zeros(1, 128, dtype=torch.long)
    mask[:, :100] = 1  # 100 tokens and padding
    return ids, mask


@pytest.mark.parametrize("name", ["resnet50", "bert-base"])
def test_classify_graph_replay_is_bitwise_eager(cuda_device, name):
    """The handlers' compiled forward at full width (``ForwardProgram``):
    the replay bitwise the eager card forward and itself, on a real input
    and on the example batch; and the card's bf16 logits against the CPU
    f32 forward of the same weights within the bound, top-1 equal. A
    ResNet's ``bn3`` scales are drawn: at the init's 0 the residual
    branches would vanish."""
    from lambdipy_tpu_torch.models.graphs import ForwardProgram

    adapter = registry.get(name).build()
    sd = adapter.init_params(seed=1, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    for key, t in sd.items():
        if key.endswith("bn3.scale"):
            t.copy_(0.3 * torch.randn(t.shape, generator=gen,
                                      device=cuda_device))
    model = adapter.make_model(sd, device=cuda_device)
    program = ForwardProgram(model, adapter.example_batch(1, cuda_device))
    assert program.mode == "graph"
    inputs = _classify_inputs(name)
    got = program(*inputs)
    dev = [a.to(t.device, t.dtype) for a, t in zip(inputs, program.inputs)]
    with torch.no_grad():
        eager = model(*dev).cpu()
        eager_example = model(*program.example).cpu()
    assert torch.equal(got, eager)
    assert torch.equal(program(*program.example), eager_example)
    assert torch.equal(program(*inputs), got)
    assert program.report()["replays"] == 4  # the capture's run and 3
    cpu = registry.get(name).build(dtype="float32").make_model(
        {k: v.float().cpu() for k, v in sd.items()}, device="cpu")
    with torch.no_grad():
        ref = cpu(*inputs)
        if name == "bert-base":
            h, h32 = model.encoder(*dev).float().cpu(), cpu.encoder(*inputs)
            assert (h - h32).abs().max() <= 0.05 * h32.abs().max()
    err = ((got - ref).abs().max() / ref.abs().max()).item()
    assert err <= CLASSIFY_CPU_BOUND[name]
    assert torch.equal(got.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["float", "int8kv"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_windowed_step_is_bitwise_the_full_window_step(cuda_device, paged,
                                                       kv_quant):
    """Why the windowed engine replays its full-window program under the
    decode kernels: 16 steps of 8 rows over a 64-position window (a
    contiguous cache of 64 positions, or the first 64 // page entries of
    the rows' tables) give the tokens, logprobs and written K/V of the
    same steps over the full 512 positions, bitwise: the kernels read a
    row only up to its active length. (The plain attention's narrowed
    view is held on the CPU, ``tests/test_torch_window.py``.)"""
    from lambdipy_tpu_torch.models import llama as tl

    model = _spec_model(cuda_device, kv_quant).model
    cfg = model.cfg
    b, width, window, page, steps = 8, 512, 64, 32, 16
    tables = torch.randperm(b * width // page, generator=torch.Generator()
                            .manual_seed(5)).add(1).to(torch.int32) \
        .view(b, -1).to(cuda_device)

    def fresh(w):
        if not paged:
            return tl.DecodeStep(model, tl.init_decode_cache(
                cfg, b, w, cuda_device), b)
        arena = tl.init_page_arena(cfg, 1 + b * width // page, page,
                                   cuda_device)
        return tl.DecodeStep(model, arena, b,
                             tables=tables[:, :w // page].contiguous())

    start = torch.tensor([3, 40, 5, 20, 33, 17, 6, 30], dtype=torch.int32,
                         device=cuda_device)
    first = torch.arange(100, 100 + b, device=cuda_device)
    streams = tl.row_streams([(1, r) for r in range(b)])
    out = {}
    with torch.inference_mode():
        for w in (width, window):
            step = fresh(w)
            step.load(first, torch.zeros(b, device=cuda_device), start,
                      [-1] * b, streams)
            out[w] = (step, *tl._scan_decode(lambda s=step: s.step(False),
                                             step, steps, segment=True))
        torch.cuda.synchronize()
    (full, ft, fl), (narrow, nt, nl) = out[width], out[window]
    assert torch.equal(ft, nt) and torch.equal(fl, nl)
    assert int(start.max()) + steps <= window
    for fe, ne in zip(full.cache, narrow.cache):
        for name, val in tl._leaves(ne).items():
            ref = tl._leaves(fe)[name]
            assert torch.equal(ref if paged else ref[:, :window], val), name


# path Q's MoE FFN (chip_smoke.py): Mixtral-8x7B's experts at llama3-8b's
# width, int8. On the card the stacks dequantize to bf16 and the einsums
# run in bf16 with f32 sums; on the CPU the same int8 weights dequantize
# to f32. The same bf16-rounded input routes the same tokens in both (the
# f32 router); the outputs differ by the bf16 roundings of the weights
# and of the activations, each up to 2^-8 relative, summed over 14,336
# products: within 0.03 of the output's peak
MOE_REL_TOL = 0.03


def test_moe_mlp_on_the_card_matches_its_cpu_result(cuda_device):
    from lambdipy_tpu_torch.models.moe import MoEMLP

    e, h, m = 8, 4096, 14336
    gen = torch.Generator().manual_seed(5)
    card = MoEMLP(h, e, m, 2, 1.25, torch.bfloat16, "int8", 256,
                  device=cuda_device)
    cpu = MoEMLP(h, e, m, 2, 1.25, torch.float32, "int8", 256, device="cpu")
    weights = {"router": torch.randn(h, e, generator=gen) / h ** 0.5}
    for name, n_in in (("experts_gate", h), ("experts_up", h),
                       ("experts_down", m)):
        w = getattr(cpu, f"{name}_int8")
        weights[f"{name}_int8"] = torch.randint(-127, 128, w.shape,
                                                generator=gen,
                                                dtype=torch.int8)
        weights[f"{name}_scale"] = torch.full(
            getattr(cpu, f"{name}_scale").shape, 1 / (127 * n_in ** 0.5))
    cpu.load_state_dict(weights)
    card.load_state_dict(weights)
    x = torch.randn(2, 64, h, generator=gen).to(torch.bfloat16)
    with torch.inference_mode():
        d_card, _, _ = card.route(x.to(cuda_device))
        d_cpu, _, _ = cpu.route(x.float())
        out = card(x.to(cuda_device)).float().cpu()
        ref = cpu(x.float())
    assert torch.equal(d_card.cpu(), d_cpu)  # the same seats
    assert torch.isfinite(out).all()
    rel = ((out - ref).abs().max() / ref.abs().max()).item()
    assert rel <= MOE_REL_TOL, rel


def test_moe_graph_replay_is_bitwise_eager(cuda_device):
    """Routing captures into the decode and prefill graphs (static shapes,
    no host sync): an MoE server's greedy and sampled rows, replayed, are
    bitwise its eager twin's."""
    adapter = registry.get("llama-moe-tiny").build(
        dtype="bfloat16", quant="int8",
        extra={"hidden": "256", "mlp": "512", "heads": "4",
               "kv_heads": "2"})
    model = adapter.make_model(adapter.init_params(seed=2, device="cuda"),
                               device="cuda")
    graph, eager = LlamaServer(model), LlamaServer(model, graphs=False)
    prompts = [[5, 9, 2, 77, 31], [8, 1, 400, 3, 3, 3, 9, 12, 40]]
    for knobs in ({}, {"temperature": 0.8, "seed": 3}):
        for _ in range(2):
            got = graph.generate(prompts, max_new_tokens=12,
                                 return_logprobs=True, **knobs)
            want = eager.generate(prompts, max_new_tokens=12,
                                  return_logprobs=True, **knobs)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
    assert graph.program_stats()["replays"] > 0


def test_quantize_params_on_the_card_is_bitwise_the_cpus(cuda_device):
    """``quantize_params`` on card tensors gives the CPU's bits (the
    CPU's are JAX's, ``tests/test_torch_moe.py``): its scale is an IEEE
    division on both (a CUDA division by a Python scalar would multiply
    by the reciprocal)."""
    from lambdipy_tpu_torch.models.llama import quantize_params

    gen = torch.Generator().manual_seed(9)
    tree = {"q_proj": {"kernel": torch.randn(512, 384, generator=gen)
                       .to(torch.bfloat16)},
            "moe": {"experts_up": torch.randn(4, 256, 128, generator=gen),
                    "router": torch.randn(256, 4, generator=gen)}}
    cpu = quantize_params(tree)
    card = quantize_params({k: {n: t.to(cuda_device) for n, t in v.items()}
                            for k, v in tree.items()})
    for k, node in cpu.items():
        for n, t in node.items():
            assert torch.equal(card[k][n].cpu(), t), (k, n)


# ------------------------------------------------ captures beside threads

def test_capture_survives_device_calls_on_another_thread(cuda_device):
    """One thread captures a ``CudaGraph`` 20 times while another loops
    over device calls: an ``.item()`` (a copy and a stream sync), a fresh
    allocation of a new size, a pinned host copy waited on through an
    event, each without the device lock, as the port's request threads
    make them, and a device-wide ``torch.cuda.synchronize()`` under
    ``DEVICE_LOCK``, the port's rule for a wait on every stream. Neither
    thread fails and every replay equals the eager run. In CUDA's default
    ``global`` capture mode the first three invalidated the capture
    (``cudaErrorStreamCaptureInvalidated``); ``thread_local`` mode takes
    them, and a device-wide sync still invalidates any capture, which the
    lock the capture holds keeps apart."""
    from lambdipy_tpu_torch.models.graphs import DEVICE_LOCK, CudaGraph

    gen = torch.Generator(device=cuda_device).manual_seed(4)
    a = torch.randn(256, 256, generator=gen, device=cuda_device) / 16
    x = torch.randn(256, 256, generator=gen, device=cuda_device)
    out = torch.empty_like(x)

    def fn():
        y = x
        for _ in range(48):
            y = torch.tanh(y @ a)
        out.copy_(y)

    def prepare():
        torch.mm(a, a)  # cuBLAS's handle for the capture stream

    fn()
    want = out.clone()
    stop, errors, rounds = threading.Event(), [], [0]

    def busy():
        i = 0
        try:
            while not stop.is_set():
                z = torch.ones(64, device=cuda_device)
                assert float(z.sum().item()) == 64.0
                fresh = torch.empty((1 + i % 48) << 18, dtype=torch.uint8,
                                    device=cuda_device)
                host = torch.empty(fresh.shape, dtype=torch.uint8,
                                   pin_memory=True)
                host.copy_(fresh.fill_(1), non_blocking=True)
                done = torch.cuda.Event()
                done.record()
                done.synchronize()
                assert int(host[:8].sum()) == 8
                with DEVICE_LOCK:
                    torch.cuda.synchronize()
                i += 1
                rounds[0] = i
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    worker = threading.Thread(target=busy, daemon=True)
    worker.start()
    try:
        for _ in range(20):
            graph = CudaGraph(cuda_device)
            out.zero_()
            graph.capture(fn, prepare)
            graph.replay()
            torch.cuda.current_stream().synchronize()
            torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
            graph.reset()
    finally:
        stop.set()
        worker.join(timeout=60)
    assert not worker.is_alive()
    assert not errors, errors
    assert rounds[0] > 0


# ------------------------------------------------------------- training

def _train_trainer(device, total, ckpt_dir=None, seed=5, mesh=None,
                   fsdp=True):
    from lambdipy_tpu_torch.data import ShardedLoader, TokenSource
    from lambdipy_tpu_torch.models.params import train_params
    from lambdipy_tpu_torch.train.loop import Trainer, TrainerConfig

    adapter = registry.get("llama-tiny").build()
    sd = adapter.init_params(seed=0, device="cpu")
    tokens = np.random.default_rng(3).integers(0, 512, 8000).astype(np.int32)
    loader = ShardedLoader(TokenSource(tokens, 32), 4, seed=seed)
    cfg = TrainerConfig(total_steps=total, log_every=1, ckpt_every=2,
                        learning_rate=3e-3, grad_clip=1.0, warmup_steps=2,
                        fsdp=fsdp)
    return Trainer(adapter.train_forward, train_params(sd), loader, cfg,
                   device=device, ckpt_dir=ckpt_dir, mesh=mesh,
                   rules=adapter.tp_rules)


# card against CPU: the same f32 math, other kernels and summation order
# (TF32 off); measured well inside these
TRAIN_METRIC_TOL = 1e-4
TRAIN_PARAM_TOL = 1e-4


def test_train_step_on_the_card_matches_the_cpu(cuda_device):
    """Four steps of the f32 ``llama-tiny`` from one state on the card
    and on the CPU: every logged metric within ``TRAIN_METRIC_TOL``
    relative, every param within ``TRAIN_PARAM_TOL``; no kernel of the
    port launched (training runs the plain ops)."""
    from lambdipy_tpu_torch.runtime.handlers import kernel_launches

    before = kernel_launches()
    card = _train_trainer(cuda_device, 4)
    card_rows = card.run().history
    assert kernel_launches() == before
    cpu = _train_trainer("cpu", 4)
    cpu_rows = cpu.run().history
    for got, want in zip(card_rows, cpu_rows):
        for k in ("loss", "ce_loss", "grad_norm"):
            assert got[k] == pytest.approx(want[k], rel=TRAIN_METRIC_TOL), k
    for k, p in cpu.state.params.items():
        torch.testing.assert_close(card.state.params[k].cpu(), p,
                                   rtol=TRAIN_PARAM_TOL, atol=TRAIN_PARAM_TOL)


def test_train_resume_on_the_card_is_bitwise(cuda_device, tmp_path):
    """8 steps on the card against 4, a checkpoint and a new ``Trainer``
    resuming to 8 (its loader built with another seed): params,
    optimizer state and the logged rows bitwise; the resumed tensors on
    the card."""
    solo = _train_trainer(cuda_device, 8)
    solo_rows = solo.run().history
    first_rows = _train_trainer(cuda_device, 4, tmp_path / "ck").run().history
    second = _train_trainer(cuda_device, 8, tmp_path / "ck", seed=999)
    assert second.resumed_from == 4
    assert second.state.step.device.type == "cuda"
    rows = second.run().history
    assert first_rows + rows == solo_rows
    for k, p in solo.state.params.items():
        assert torch.equal(second.state.params[k], p), k
    for name in ("mu", "nu"):
        for k, m in solo.state.opt_state["1"]["0"][name].items():
            assert torch.equal(second.state.opt_state["1"]["0"][name][k], m)


@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "dp"])
def test_train_under_a_one_rank_nccl_group_is_bitwise_no_mesh(
        cuda_device, tmp_path, fsdp):
    """Four steps under a one-rank NCCL group over ``make_mesh({"dp":
    -1})`` (every collective of the data-parallel step run) against four
    without a mesh: params, optimizer state, step and logged rows
    bitwise; a checkpoint written under the group restores without
    one."""
    import torch.distributed as dist

    from lambdipy_tpu_torch.parallel.mesh import make_mesh
    from lambdipy_tpu_torch.train.checkpoint import tree_paths

    plain = _train_trainer(cuda_device, 4)
    plain_rows = plain.run().history
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        grouped = _train_trainer(cuda_device, 4, tmp_path / "ck",
                                 mesh=make_mesh({"dp": -1}), fsdp=fsdp)
        assert grouped.step_fn.shardings is not None
        rows = grouped.run().history
        grouped.close()
    finally:
        dist.destroy_process_group()
    assert rows == plain_rows
    want = dict(tree_paths(plain.state))
    got = dict(tree_paths(grouped.state))
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    restored = _train_trainer(cuda_device, 4, tmp_path / "ck")
    assert restored.resumed_from == 4
    assert all(torch.equal(v, want[k])
               for k, v in dict(tree_paths(restored.state)).items())
