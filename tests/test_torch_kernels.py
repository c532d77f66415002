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
from lambdipy_tpu_torch.ops import decode_attention as tda
from lambdipy_tpu_torch.ops import quant as tq

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA device; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # full-f32 plain matmuls
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("h,kvh,d", [(4, 4, 32), (32, 8, 128), (8, 1, 64)],
                         ids=["group1", "group4-d128", "group8"])
def test_decode_attention_kernel_matches_plain(cuda_device, dtype, tol, h,
                                               kvh, d):
    """Ragged lengths incl. 0 (uniform mean of V), 1, a 64-position tile
    boundary and past the window; tolerance: bf16 output rounding, else
    summation order."""
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
    assert (out.float() - ref.float()).abs().max().item() <= tol


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
