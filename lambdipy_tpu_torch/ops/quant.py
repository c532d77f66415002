"""Int8 weight-only matmul: the plain PyTorch version and the wrapper of
the Hopper kernel ``csrc/int8_matmul.cu``.

Twin of ``lambdipy_tpu/ops/quant.py``. The plain version computes what
the TPU kernel BODY computes (``quant.py:37-44``): x cast to bf16, int8
cast to bf16 (exact), f32 accumulation, the per-output-channel f32
scale applied once at the end, the result cast to ``x.dtype``. That is
not the JAX ``int8_matmul_reference``, which folds the scale into bf16
weights before the product and so rounds differently. The JAX wrapper
switches to those reference semantics whenever a shape does not tile
its blocks; the port uses the kernel's semantics at every shape.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from lambdipy_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def int8_matmul_reference(x, w_i8, scale):
    """x ``[m, k]`` (f32/bf16); w_i8 ``[k, n]`` int8; scale ``[1, n]`` f32.
    Returns ``[m, n]`` in ``x.dtype`` with the kernel's rounding."""
    xb = x.to(torch.bfloat16).float()
    wb = w_i8.to(torch.bfloat16).float()
    return (torch.matmul(xb, wb) * scale.float()).to(x.dtype)


@functools.cache
def _launcher():
    """The C entry point of ``csrc/int8_matmul.cu``, built on first use."""
    fn = _build.load("int8_matmul").int8_matmul_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(x, w_i8, scale):
    if x.dim() != 2 or w_i8.dim() != 2 or x.shape[1] != w_i8.shape[0]:
        raise ValueError(f"int8_matmul wants x [m,k] and w [k,n]; got "
                         f"{tuple(x.shape)} and {tuple(w_i8.shape)}")
    n = w_i8.shape[1]
    if scale.shape != (1, n) or scale.dtype != torch.float32:
        raise ValueError(f"scale must be [1, {n}] float32, got "
                         f"{tuple(scale.shape)} {scale.dtype}")
    if w_i8.dtype != torch.int8:
        raise ValueError(f"weights must be int8, got {w_i8.dtype}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    devices = {t.device for t in (x, w_i8, scale)}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: {devices}")


def int8_matmul(x, w_i8, scale):
    """The int8-weight matmul kernel. CUDA tensors launch
    ``csrc/int8_matmul.cu`` (contiguous, ``n % 8 == 0``, weights 16-byte
    aligned; anything else raises): a GEMV path for ``m <= 8`` and a
    tensor-core tiled path above. CPU tensors run the plain version."""
    _check(x, w_i8, scale)
    if x.device.type == "cpu":
        return int8_matmul_reference(x, w_i8, scale)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    m, k = x.shape
    n = w_i8.shape[1]
    if n % 8 or w_i8.data_ptr() % 16:
        raise ValueError(f"kernel needs n % 8 == 0 and 16-byte aligned "
                         f"weights; got n={n}")
    if not all(t.is_contiguous() for t in (x, w_i8, scale)):
        raise ValueError("int8_matmul kernel needs contiguous operands")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _launcher()(_DTYPES[x.dtype], x.data_ptr(), w_i8.data_ptr(),
                      scale.data_ptr(), out.data_ptr(), m, k, n, stream)
    _build.check(err, "int8_matmul")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0
