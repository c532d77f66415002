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
import threading

import torch

from lambdipy_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def int8_matmul_reference(x, w_i8, scale):
    """x ``[m, k]`` (f32/bf16); w_i8 ``[k, n]`` int8; scale ``[1, n]`` f32.
    Returns ``[m, n]`` in ``x.dtype`` with the kernel's rounding."""
    xb = x.to(torch.bfloat16).float()
    wb = w_i8.to(torch.bfloat16).float()
    return (torch.matmul(xb, wb) * scale.float()).to(x.dtype)


# The GEMV's geometry: warps of a block, k per tensor-core step, rows of a
# block, the most splits (partials a column tile merges), the least n for
# 16 columns a lane; csrc/int8_matmul.cu has the same constants (GV_*),
# checked when the library loads
GEMV_WARPS, GEMV_STEP, GEMV_ROWS, GEMV_MAX_SPLITS, GEMV_WIDE_MIN_N = (
    8, 16, 64, 8, 2048)
# the plan's aim: one wave of two blocks on each of the H100's 132 SMs
GEMV_SMS = 132
GEMV_BLOCKS = 2 * GEMV_SMS


def gemv_block_cols(n: int) -> int:
    """Columns of a GEMV block for one to 16 rows: 128 (16 a lane, 16-byte
    loads) where ``n % 16 == 0`` and ``n >= GEMV_WIDE_MIN_N``, else 64.
    Which block computes an element never changes its bits."""
    return 128 if n % 16 == 0 and n >= GEMV_WIDE_MIN_N else 64


def gemv_split(k: int, splits: int) -> tuple[int, int]:
    """k cut into about ``splits`` ranges of whole 16-deep steps for each
    of a block's :data:`GEMV_WARPS` warps: ``(splits, depth)``, the
    splits that ``depth`` rows leave (none empty, the last may be
    shorter)."""
    steps = -(-k // GEMV_STEP)
    depth = -(-steps // splits // GEMV_WARPS) * GEMV_WARPS
    return -(-steps // depth), depth * GEMV_STEP


def gemv_plan(k: int, n: int) -> tuple[int, int]:
    """The GEMV's split of k for a ``[k, n]`` weight: ``(splits, depth)``,
    k cut into ``splits`` ranges of ``depth`` rows, summed in that order
    (:func:`gemv_split`). A function of ``(k, n)`` alone, so a row's bits
    never depend on ``m``: as many splits as fit :data:`GEMV_BLOCKS`
    blocks, at most :data:`GEMV_MAX_SPLITS`. Measured on an H100
    (``python -m lambdipy_tpu_torch.gemv_probe``): one wave of blocks
    beats more, a second, partial wave costing more than it overlaps."""
    tiles = -(-n // gemv_block_cols(n))
    return gemv_split(k, min(GEMV_MAX_SPLITS, max(1, GEMV_BLOCKS // tiles)))


@functools.cache
def _library():
    """``csrc/int8_matmul.cu``, built on first use; its GEMV geometry
    must be the plan's."""
    lib = _build.load("int8_matmul")
    lib.int8_matmul_gemv_geometry.restype = ctypes.c_int
    lib.int8_matmul_gemv_geometry.argtypes = [ctypes.c_int]
    got = tuple(lib.int8_matmul_gemv_geometry(i) for i in range(5))
    want = (GEMV_WARPS, GEMV_STEP, GEMV_ROWS, GEMV_MAX_SPLITS,
            GEMV_WIDE_MIN_N)
    if got != want:
        raise RuntimeError(f"int8_matmul.cu's GEMV geometry (warps, step, "
                           f"rows, splits, wide n) is {got}, the plan's "
                           f"{want}")
    return lib


@functools.cache
def _launcher():
    """The tiled route's C entry point of ``csrc/int8_matmul.cu``."""
    fn = _library().int8_matmul_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _gemv_launcher():
    """The GEMV's C entry point of ``csrc/int8_matmul.cu``."""
    fn = _library().int8_matmul_gemv_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


# (device, stream) -> the GEMV's merge counters, one per 64 columns and 64
# rows: zero between calls (the block that merges a tile zeroes its own),
# one buffer per stream so that calls on two streams never share one. Every
# launch of the serving path, eager or replayed from a CUDA graph, goes to
# the device's current stream, so no two launches that share a buffer can
# overlap: a graph captured on the capture stream keeps that stream's
# buffer and replays on the current stream, after and before the eager
# launches there. Keep it so.
_counters: dict = {}
# buffers a larger one replaced: a graph captured with one still writes it
_retired: list = []
_counters_lock = threading.Lock()


def gemv_counter_count(m: int, n: int) -> int:
    """Merge counters an ``[m, k] x [k, n]`` GEMV call needs."""
    return -(-m // GEMV_ROWS) * -(-n // 64)


def reserve_gemv_counters(device, stream: int, count: int):
    """The GEMV's merge counters of ``stream``, at least ``count`` of them.
    A buffer is allocated (zeroed) outside a CUDA-graph capture only: one
    made inside would be zeroed by the graph alone and live in its private
    pool. A buffer that grows keeps its old one alive for the graphs that
    captured it."""
    with _counters_lock:
        buf = _counters.get((device, stream))
        if buf is None or buf.numel() < count:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "the int8 GEMV's merge counters for this stream must be "
                    "reserved before a CUDA-graph capture "
                    "(reserve_gemv_counters)")
            if buf is not None:
                _retired.append(buf)
            buf = torch.zeros(max(count, 4096), dtype=torch.int32,
                              device=device)
            _counters[(device, stream)] = buf
        return buf


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
_ROUTE_TILED = -1  # the tiled entry point's route: the kernel's tile pick


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
    aligned; split over k by :func:`gemv_plan`, with an f32 workspace
    ``[splits, m, n]`` when it splits) or a TMA-fed wgmma route
    (:func:`tiled_shape_error`, and x, weights and scale 16-byte
    aligned); anything else raises, as do non-contiguous operands. One
    launch and one count per call. CPU tensors run the plain version."""
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
    # under a CUDA-graph capture out and ws come from the graph's private
    # pool, at addresses every replay reuses (``models/graphs.py`` counts
    # the pool's bytes)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = (_DTYPES[x.dtype], x.data_ptr(), w_i8.data_ptr(),
            scale.data_ptr(), out.data_ptr())
    if gemv:
        splits, depth = gemv_plan(k, n)
        ws = counters = None
        if splits > 1:  # the f32 partials of the splits, merged in order
            ws = torch.empty((splits, m, n), dtype=torch.float32,
                             device=x.device)
            counters = reserve_gemv_counters(x.device, stream,
                                             gemv_counter_count(m, n))
        err = _gemv_launcher()(
            *args, None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr(),
            m, k, n, splits, depth, stream)
    else:
        err = _launcher()(*args, m, k, n, _ROUTE_TILED, stream)
    _build.check(err, "int8_matmul")
    # a capture runs this line too: models/graphs.py takes the capture's
    # counts back and adds them at every replay
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0
