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
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
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


# the route of a caller that does not say: the GEMV for m <= 8 rows
GEMV_MAX_ROWS = 8
_ROUTE_GEMV, _ROUTE_TILED = -2, -1  # the C entry point's route argument


def int8_route(m: int, rows_alone: bool | None = None) -> str:
    """The kernel route for an ``[m, k]`` x: ``"gemv"`` or ``"tiled"``.

    ``rows_alone`` is the caller's word on what the rows are. True: each
    row is one position of its own sequence (a decode step, the lm_head
    at the logit positions), and the GEMV takes it at any ``m``: it sums
    each row alone, so a row's bits do not depend on how many rows share
    the call (an engine's 16-row decode step gives a row the bits of its
    solo 1-row step). False: the tiled route (a prefill, ``m = b * s``),
    whose rows are invariant in ``m`` too but sum in another order than
    the GEMV's. None: the GEMV for ``m <= GEMV_MAX_ROWS``."""
    if rows_alone is None:
        rows_alone = m <= GEMV_MAX_ROWS
    return "gemv" if rows_alone else "tiled"


def tiled_shape_error(k: int, n: int, dtype) -> str | None:
    """Why the tiled route cannot take a ``[m, k]`` x of ``dtype`` times a
    ``[k, n]`` int8 weight, or None when it can. Its
    tensor-memory-accelerator loads and stores want 16-byte row strides:
    ``n % 16 == 0`` (the int8 weight rows and the output rows in either
    dtype), ``k % 8 == 0`` for bf16 x, ``k % 4 == 0`` for f32."""
    k_mult = 4 if dtype == torch.float32 else 8
    if n % 16:
        return f"the tiled int8 kernel needs n % 16 == 0; got n={n}"
    if k % k_mult:
        return (f"the tiled int8 kernel needs k % {k_mult} == 0 for "
                f"{dtype} x; got k={k}")
    return None


def int8_matmul(x, w_i8, scale, *, rows_alone: bool | None = None):
    """The int8-weight matmul kernel. CUDA tensors launch
    ``csrc/int8_matmul.cu`` on the route :func:`int8_route` picks from
    ``m`` and ``rows_alone``: the GEMV (``n % 8 == 0``, weights 16-byte
    aligned) or a TMA-fed wgmma route (:func:`tiled_shape_error`, and x,
    weights and scale 16-byte aligned); anything else raises, as do
    non-contiguous operands. One launch and one count per call. CPU
    tensors run the plain version."""
    _check(x, w_i8, scale)
    if x.device.type == "cpu":
        return int8_matmul_reference(x, w_i8, scale)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    m, k = x.shape
    n = w_i8.shape[1]
    gemv = int8_route(m, rows_alone) == "gemv"
    if gemv:
        if n % 8 or w_i8.data_ptr() % 16:
            raise ValueError(f"kernel needs n % 8 == 0 and 16-byte aligned "
                             f"weights; got n={n}")
    else:
        why = tiled_shape_error(k, n, x.dtype)
        if why is not None:
            raise ValueError(why)
        if any(t.data_ptr() % 16 for t in (x, w_i8, scale)):
            raise ValueError("the tiled int8 kernel needs 16-byte aligned "
                             "x, weights and scale")
    if not all(t.is_contiguous() for t in (x, w_i8, scale)):
        raise ValueError("int8_matmul kernel needs contiguous operands")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _launcher()(_DTYPES[x.dtype], x.data_ptr(), w_i8.data_ptr(),
                      scale.data_ptr(), out.data_ptr(), m, k, n,
                      _ROUTE_GEMV if gemv else _ROUTE_TILED, stream)
    _build.check(err, "int8_matmul")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0
