"""Length-aware GQA decode attention: the plain PyTorch versions and the
wrappers of the Hopper kernel ``csrc/decode_attention.cu``, over a
contiguous cache and over a paged arena.

Twin of ``lambdipy_tpu/ops/decode_attention.py`` (``_decode_kernel`` and
``_paged_kernel``, each with float-KV and int8-KV branches). The layouts
are the JAX package's: q
``[b, 1, h, d]``, k/v ``[b, t, kvh, d]`` with grouped kv heads (not
pre-broadcast), ``active_len`` ``[b]`` int32 — row r attends positions
``< active_len[r]``. Int8 K/V come with f32 scales ``[b, t, kvh, 1]``
(``models/llama.py _kv_quantize``). The paged form reads K/V from an
arena ``[P, page, kvh, d]`` (scales ``[P, page, kvh, 1]``) through block
tables ``[b, nb]`` int32: row r's position p lives in page
``tables[r, p // page]`` at offset ``p % page``.

The kernel reads nothing past a row's ``active_len`` and reads each kv
head once for its ``h // kvh`` query heads. It is split-KV
(flash-decoding): a row's positions are cut into chunks of
:data:`KV_CHUNK` (:func:`split_bounds`), one block per (row x kv head,
chunk) writes a softmax partial, and a second launch merges a row's
partials in chunk order. The plan is a function of the row's
``active_len`` alone, so a row's output is bitwise the same whatever the
batch, the capacity ``t`` or the addressing; the source's header note
says what bounds the kernel and what its design does about that. On a
CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.

Int8-KV rounding: the port dequantizes as the TPU kernel BODY does
(``decode_attention.py:134-137``): int8 times the f32 scale in f32, then
rounded to ``q.dtype``. The JAX wrapper's fallback (``:181-186``), which
it takes whenever ``t`` does not tile its blocks, and the JAX dense path
(``_kv_dequantize``) both round the scale to ``q.dtype`` first; in bf16
the two differ. The port uses the kernel's rounding at every shape; the
JAX paged reference (``:276-278``) rounds the scale first too.
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
# positions per split of the kernel's plan; csrc/decode_attention.cu has
# the same constant, checked when the library loads
KV_CHUNK = 128


def split_bounds(active_len: int, t: int) -> list[tuple[int, int]]:
    """The kernel's split plan for one row, as ``[start, end)`` position
    ranges in merge order: ``active_len`` clamped to ``t`` (all ``t``
    positions at ``active_len <= 0``, the uniform mean) cut into chunks
    of :data:`KV_CHUNK`. For ``0 < active_len <= t`` it depends on
    ``active_len`` alone."""
    n = t if active_len <= 0 or active_len > t else active_len
    return [(s, min(s + KV_CHUNK, n)) for s in range(0, n, KV_CHUNK)]


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


def windowed_decode_attention_reference(q, k, v, base, local_len,
                                        window: int):
    """Decode attention over a sliding logical window (JAX
    ``windowed_decode_attention_reference``): k/v hold a row's whole
    logical context ``[b, T, kvh, d]``; row r attends the view ``[base[r],
    base[r] + window)`` with its first ``local_len[r]`` positions valid,
    the view the long-context tier's block table maps. Sliced, then
    :func:`decode_attention_reference`, so on the same values it is
    bitwise what the view's gathered window computes. The tests' oracle,
    not a kernel."""
    b = q.shape[0]
    base = torch.as_tensor(base, dtype=torch.long).expand(b).tolist()
    k_win = torch.stack([k[r, base[r]:base[r] + window] for r in range(b)])
    v_win = torch.stack([v[r, base[r]:base[r] + window] for r in range(b)])
    return decode_attention_reference(q, k_win, v_win, local_len)


@functools.cache
def _library():
    """``csrc/decode_attention.cu``, built on first use; its split plan
    must be :data:`KV_CHUNK` wide, since that sizes the partials."""
    lib = _build.load("decode_attention")
    lib.decode_attention_kv_chunk.restype = ctypes.c_int
    chunk = lib.decode_attention_kv_chunk()
    if chunk != KV_CHUNK:
        raise RuntimeError(f"decode_attention.cu splits by {chunk} "
                           f"positions, the wrapper by {KV_CHUNK}")
    return lib


@functools.cache
def _launcher():
    """The C entry point of ``csrc/decode_attention.cu``."""
    fn = _library().decode_attention_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10
                   + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _paged_launcher():
    """The paged C entry point of ``csrc/decode_attention.cu``."""
    fn = _library().paged_decode_attention_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10
                   + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _partials(q, b, kvh, group, d, t):
    """The kernel's scratch on q's device, one f32 allocation: the chunk
    accumulators ``[b * kvh, ceil(t / KV_CHUNK), group, d]``, then their
    (m, l) pairs ``[..., group, 2]``; written only for live chunks.
    Returns the two base addresses. Under a CUDA-graph capture the scratch
    comes from the graph's private pool, at an address every replay
    reuses."""
    n = b * kvh * max(1, -(-t // KV_CHUNK)) * group
    scratch = torch.empty(n * (d + 2), dtype=torch.float32, device=q.device)
    return scratch, scratch.data_ptr(), scratch.data_ptr() + n * d * 4


def dequantize_kv(x_i8, scale, dtype):
    """Int8 K/V as the TPU kernel body dequantizes it: ``int8 * scale``
    in f32, then rounded to ``dtype``."""
    return (x_i8.float() * scale.float()).to(dtype)


def int8_kv_decode_attention_reference(q, k, v, active_len, k_scale,
                                       v_scale):
    """The plain version of the int8-KV branch: :func:`dequantize_kv`,
    then :func:`decode_attention_reference`."""
    return decode_attention_reference(
        q, dequantize_kv(k, k_scale, q.dtype),
        dequantize_kv(v, v_scale, q.dtype), active_len)


def _check(q, k, v, active_len, k_scale=None, v_scale=None, row_map=None):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"decode attention wants q [b,1,h,d] and k/v "
                         f"[b,t,kvh,d]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    if s != 1:
        raise ValueError(f"the decode kernel takes one query token, got {s}")
    if (row_map is None and k.shape[0] != b) or k.shape[3] != d \
            or h % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not match k/v "
                         f"{tuple(k.shape)}")
    if row_map is not None and (row_map.shape != (b,)
                                or row_map.dtype != torch.int32):
        raise ValueError("row_map must be [b] int32")
    if active_len.shape != (b,) or active_len.dtype != torch.int32:
        raise ValueError("active_len must be [b] int32")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("int8 K/V needs both k_scale and v_scale")
    scales = () if k_scale is None else (k_scale, v_scale)
    maps = () if row_map is None else (row_map,)
    devices = {x.device for x in (q, k, v, active_len, *scales, *maps)}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: {devices}")
    if not scales:
        if not (q.dtype == k.dtype == v.dtype):
            raise ValueError("q, k and v must share one dtype")
        return
    if not (k.dtype == v.dtype == torch.int8):
        raise ValueError(f"scaled K/V must be int8, got {k.dtype}, "
                         f"{v.dtype}")
    want = (*k.shape[:3], 1)
    for x in scales:
        if x.shape != want or x.dtype != torch.float32:
            raise ValueError(f"k_scale/v_scale must be {list(want)} "
                             f"float32, got {tuple(x.shape)} {x.dtype}")


def map_rows(row_map, *caches):
    """Each query row's cache row of every tensor in ``caches``: the
    plain version's reading of a row map."""
    return [x[row_map.long()] for x in caches]


def blocked_decode_attention(q, k, v, active_len, *, k_scale=None,
                             v_scale=None, row_map=None):
    """The decode-attention kernel. Shapes as
    :func:`decode_attention_reference` with a single query token; with
    ``k_scale``/``v_scale`` (``[b, t, kvh, 1]`` f32) k/v are int8. With
    ``row_map`` (``[b]`` int32) query row r attends cache row
    ``row_map[r]`` of k/v ``[rows, t, kvh, d]``: a speculative verify
    chunk's one-token rows over their sequence's cache row. CUDA tensors
    launch ``csrc/decode_attention.cu`` (q f32 or bf16, contiguous, ``h //
    kvh <= 8``, ``d <= 256``; anything else raises); CPU tensors run the
    plain version. Float-KV launches count on ``launches``, int8-KV
    launches on ``launches_int8kv``."""
    _check(q, k, v, active_len, k_scale, v_scale, row_map)
    quant = k_scale is not None
    if q.device.type == "cpu":
        if row_map is not None:
            k, v = map_rows(row_map, k, v)
            if quant:
                k_scale, v_scale = map_rows(row_map, k_scale, v_scale)
        if quant:
            return int8_kv_decode_attention_reference(
                q, k, v, active_len, k_scale, v_scale)
        return decode_attention_reference(q, k, v, active_len)
    b, _, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    _check_kernel_operands(q, k, v, (q, k, v, active_len, k_scale, v_scale,
                                     row_map))
    out = torch.empty_like(q)
    scratch, acc, ml = _partials(q, b, kvh, h // kvh, d, t)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _launcher()(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), k_scale.data_ptr() if quant else None,
                      v_scale.data_ptr() if quant else None,
                      row_map.data_ptr() if row_map is not None else None,
                      active_len.data_ptr(), out.data_ptr(), acc, ml,
                      b, t, kvh, h // kvh, d, d ** -0.5, stream)
    _build.check(err, "decode_attention")
    # a capture counts here too; models/graphs.py takes it back and adds it
    # at every replay
    if quant:
        blocked_decode_attention.launches_int8kv += 1
    else:
        blocked_decode_attention.launches += 1
    return out


blocked_decode_attention.launches = 0
blocked_decode_attention.launches_int8kv = 0


def _check_kernel_operands(q, k, v, operands) -> None:
    """What the kernel takes beyond the shapes: a CUDA device, q in f32
    or bf16, ``h // kvh <= 8``, ``d <= 256``, contiguous operands (None
    entries skipped), and K/V its 16-byte copies can read
    (:func:`check_kv_alignment`)."""
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"decode attention kernel takes float32 or "
                         f"bfloat16, got {q.dtype}")
    group, d = q.shape[2] // k.shape[2], q.shape[3]
    if group > _MAX_GROUP or d > _MAX_HEAD_DIM:
        raise ValueError(f"kernel supports group <= {_MAX_GROUP} and "
                         f"head dim <= {_MAX_HEAD_DIM}; got {group}, {d}")
    if not all(x.is_contiguous() for x in operands if x is not None):
        raise ValueError("decode attention kernel needs contiguous operands")
    check_kv_alignment(k, v)


def check_kv_alignment(k, v) -> None:
    """The kernel copies each position's d-vector in 16-byte pieces: the
    d-vector's bytes must be a multiple of 16 and K/V must start on a
    16-byte boundary (every llama3-8b and test shape does: d = 32, 64,
    128, 256 in f32, bf16 or int8)."""
    row = k.shape[-1] * k.element_size()
    if row % 16:
        raise ValueError(f"decode attention kernel needs head dim x "
                         f"element size a multiple of 16 bytes; got "
                         f"{k.shape[-1]} x {k.element_size()}")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("decode attention kernel needs K/V on 16-byte "
                         "aligned addresses")


def gather_pages(pages, block_tables):
    """Each row's positions from its block table: arena ``[P, page,
    ...]`` and tables ``[b, nb]`` -> ``[b, nb * page, ...]``, bitwise the
    pages' values (null-page entries included)."""
    b, nb = block_tables.shape
    g = pages[block_tables.reshape(-1).long()]
    return g.reshape(b, nb * pages.shape[1], *pages.shape[2:])


def paged_decode_attention_reference(q, k_pages, v_pages, block_tables,
                                     active_len, *, k_scale_pages=None,
                                     v_scale_pages=None):
    """The plain version of the paged kernel: gather each row's K/V (and
    scales) through its table, then :func:`decode_attention_reference`;
    int8 pages dequantize as the kernel does (:func:`dequantize_kv`).
    Table entries at or past a row's length are masked, so on gathered
    values equal to a contiguous cache's the output is bitwise the
    contiguous plain version's."""
    k = gather_pages(k_pages, block_tables)
    v = gather_pages(v_pages, block_tables)
    if k_scale_pages is not None:
        k = dequantize_kv(k, gather_pages(k_scale_pages, block_tables),
                          q.dtype)
        v = dequantize_kv(v, gather_pages(v_scale_pages, block_tables),
                          q.dtype)
    return decode_attention_reference(q, k, v, active_len)


def _check_paged(q, k_pages, v_pages, block_tables, active_len,
                 k_scale_pages, v_scale_pages):
    if q.dim() != 4 or k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"paged decode attention wants q [b,1,h,d] and "
                         f"k/v pages [P,page,kvh,d]; got {tuple(q.shape)}, "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    b, s, h, d = q.shape
    page, kvh = k_pages.shape[1], k_pages.shape[2]
    if s != 1:
        raise ValueError(f"the decode kernel takes one query token, got {s}")
    if k_pages.shape[3] != d or h % kvh:
        raise ValueError(f"q {tuple(q.shape)} does not match the pages "
                         f"{tuple(k_pages.shape)}")
    if page & (page - 1):
        raise ValueError(f"page {page} is not a power of two")
    if (block_tables.dim() != 2 or block_tables.shape[0] != b
            or block_tables.dtype != torch.int32):
        raise ValueError("block_tables must be [b, nb] int32")
    if active_len.shape != (b,) or active_len.dtype != torch.int32:
        raise ValueError("active_len must be [b] int32")
    if (k_scale_pages is None) != (v_scale_pages is None):
        raise ValueError("int8 pages need both scale arenas")
    scales = (() if k_scale_pages is None
              else (k_scale_pages, v_scale_pages))
    devices = {x.device for x in (q, k_pages, v_pages, block_tables,
                                  active_len, *scales)}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: {devices}")
    if not scales:
        if not (q.dtype == k_pages.dtype == v_pages.dtype):
            raise ValueError("q and the pages must share one dtype")
        return
    if not (k_pages.dtype == v_pages.dtype == torch.int8):
        raise ValueError(f"scaled pages must be int8, got {k_pages.dtype}")
    want = (*k_pages.shape[:3], 1)
    for x in scales:
        if x.shape != want or x.dtype != torch.float32:
            raise ValueError(f"scale pages must be {list(want)} float32, "
                             f"got {tuple(x.shape)} {x.dtype}")


def paged_decode_attention(q, k_pages, v_pages, block_tables, active_len, *,
                           k_scale_pages=None, v_scale_pages=None):
    """The paged decode-attention kernel: :func:`blocked_decode_attention`
    with K/V read from an arena through per-row block tables. Shapes as
    :func:`paged_decode_attention_reference` with a single query token;
    ``page`` a power of two, every table entry a page of the arena (the
    caller's invariant: the kernel does not bound-check ids). CUDA
    tensors launch the paged form of ``csrc/decode_attention.cu`` or
    raise; CPU tensors run the plain version. Float-KV launches count on
    ``launches``, int8-KV launches on ``launches_int8kv``, apart from the
    contiguous kernel's counters."""
    _check_paged(q, k_pages, v_pages, block_tables, active_len,
                 k_scale_pages, v_scale_pages)
    quant = k_scale_pages is not None
    if q.device.type == "cpu":
        return paged_decode_attention_reference(
            q, k_pages, v_pages, block_tables, active_len,
            k_scale_pages=k_scale_pages, v_scale_pages=v_scale_pages)
    b, _, h, d = q.shape
    page, kvh = k_pages.shape[1], k_pages.shape[2]
    nb = block_tables.shape[1]
    _check_kernel_operands(q, k_pages, v_pages,
                           (q, k_pages, v_pages, block_tables, active_len,
                            k_scale_pages, v_scale_pages))
    out = torch.empty_like(q)
    scratch, acc, ml = _partials(q, b, kvh, h // kvh, d, nb * page)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _paged_launcher()(
        _DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), k_scale_pages.data_ptr() if quant else None,
        v_scale_pages.data_ptr() if quant else None,
        block_tables.data_ptr(), active_len.data_ptr(), out.data_ptr(),
        acc, ml, b, nb, page.bit_length() - 1, kvh, h // kvh, d, d ** -0.5,
        stream)
    _build.check(err, "paged_decode_attention")
    # counted as in blocked_decode_attention, captures included
    if quant:
        paged_decode_attention.launches_int8kv += 1
    else:
        paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
paged_decode_attention.launches_int8kv = 0
