"""Length-aware GQA decode attention: the plain PyTorch version and the
wrapper of the Hopper kernel ``csrc/decode_attention.cu``.

Twin of ``lambdipy_tpu/ops/decode_attention.py`` (float-KV branch). The
layouts are the JAX package's: q ``[b, 1, h, d]``, k/v ``[b, t, kvh, d]``
with grouped kv heads (not pre-broadcast), ``active_len`` ``[b]`` int32 —
row r attends positions ``< active_len[r]``.

The kernel reads nothing past a row's ``active_len`` and reads each kv
head once for its ``h // kvh`` query heads; the source's header note
says what bounds it and what its design does about that. On a CPU
tensor the wrapper runs the plain version; on a CUDA tensor it launches
the kernel or raises. The int8-KV branch of the TPU kernel is not
ported yet.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from lambdipy_tpu_torch.ops import _build

NEG_INF = -1e9  # the mask fill of models/llama.py _attend
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GROUP = 8
_MAX_HEAD_DIM = 256


def decode_attention_reference(q, k, v, active_len):
    """Length-masked GQA decode attention, operation for operation the
    JAX reference: grouped einsums, f32 logits divided by ``sqrt(d)``, a
    ``-1e9`` fill past each row's length, f32 softmax,
    probabilities cast to ``v.dtype`` before the PV product. At
    ``active_len = 0`` every logit is the fill, so the row gets the
    uniform mean of V. Returns ``[b, s, h, d]``."""
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, d)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k).float()
    logits = logits / math.sqrt(d)
    valid = (torch.arange(t, device=k.device)[None, :]
             < active_len.to(torch.int32)[:, None])  # [b, t]
    logits = logits.masked_fill(~valid[:, None, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, d)


@functools.cache
def _launcher():
    """The C entry point of ``csrc/decode_attention.cu``, built on first
    use."""
    fn = _build.load("decode_attention").decode_attention_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, active_len):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"decode attention wants q [b,1,h,d] and k/v "
                         f"[b,t,kvh,d]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    if s != 1:
        raise ValueError(f"the decode kernel takes one query token, got {s}")
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not match k/v "
                         f"{tuple(k.shape)}")
    if active_len.shape != (b,) or active_len.dtype != torch.int32:
        raise ValueError("active_len must be [b] int32")
    devices = {x.device for x in (q, k, v, active_len)}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: {devices}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k and v must share one dtype")


def blocked_decode_attention(q, k, v, active_len):
    """The decode-attention kernel. Shapes as
    :func:`decode_attention_reference` with a single query token. CUDA
    tensors launch ``csrc/decode_attention.cu`` (f32 or bf16, contiguous,
    ``h // kvh <= 8``, ``d <= 256``; anything else raises); CPU tensors
    run the plain version."""
    _check(q, k, v, active_len)
    if q.device.type == "cpu":
        return decode_attention_reference(q, k, v, active_len)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, _, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    if q.dtype not in _DTYPES:
        raise ValueError(f"decode attention kernel takes float32 or "
                         f"bfloat16, got {q.dtype}")
    if group > _MAX_GROUP or d > _MAX_HEAD_DIM:
        raise ValueError(f"kernel supports group <= {_MAX_GROUP} and "
                         f"head dim <= {_MAX_HEAD_DIM}; got {group}, {d}")
    if not all(x.is_contiguous() for x in (q, k, v, active_len)):
        raise ValueError("decode attention kernel needs contiguous operands")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _launcher()(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), active_len.data_ptr(), out.data_ptr(),
                      b, t, kvh, group, d, d ** -0.5, stream)
    _build.check(err, "decode_attention")
    blocked_decode_attention.launches += 1
    return out


blocked_decode_attention.launches = 0


def decode_attention(q, k, v, active_len, *, k_scale=None, v_scale=None):
    """Dispatcher for the ``attn_backend="blocked"`` decode path: the
    kernel wrapper for one-token steps. The int8-KV branch
    (``k_scale``/``v_scale``) is not ported yet and raises."""
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError("int8 KV decode attention is not ported "
                                  "yet (kv_quant slice)")
    return blocked_decode_attention(q, k, v, active_len)
