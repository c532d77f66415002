"""Llama-3-style decoder-only LM in PyTorch: GQA + RoPE + RMSNorm + SwiGLU,
int8 weight-only quantization, a static KV cache, and the compile-once
server's bucketed generation.

Twin of ``lambdipy_tpu/models/llama.py``; names, layouts and numerics
follow it so the two can be held against each other on the same
weights (``models/params.py from_jax_params``). Differences:

- PyTorch runs eagerly, so ``_scan_decode`` is a Python loop and the
  server keeps no program cache. The bucketing (prompt, decode and batch
  buckets, ``cache_len``) is kept, so the kernels see the shapes the JAX
  programs see.
- The KV cache is updated in place (the JAX cache is functional).
- Only per-row ``[b]`` cache indices exist: the serving decode path.
- The paged decode branch (a cache entry holding arena leaves and block
  ``tables``) writes each step's K/V into the row's page and, under
  ``blocked``, runs the paged decode-attention kernel on the arena where
  the JAX engine gathers each row's pages into a contiguous cache first;
  under ``dense`` it gathers and runs ``_attend``, as JAX does.
- The kernel backends are the defaults: with ``matmul_backend="pallas"``
  every int8 projection runs the port's int8 kernel with the kernel's
  rounding at every shape (``ops/quant.py``); with
  ``attn_backend="blocked"`` every one-token decode step runs the port's
  decode-attention kernel, over float or int8 K/V (``kv_quant``), with
  the TPU kernel's dequant rounding at every shape
  (``ops/decode_attention.py``); with ``attn_backend="flash"`` every
  prefill runs the port's flash-attention kernel (``ops/attention.py``)
  and decode steps run plain ``_attend``. ``"xla"`` and ``"dense"`` are
  the plain PyTorch reference the kernels are held against. Prefill
  attention under ``blocked`` and ``dense`` is plain PyTorch, as the JAX
  package leaves it to XLA.
- Sampling draws Gumbel-max noise from one ``torch.Generator`` per row,
  seeded from that row's ``(seed, row)`` alone. Tokens are deterministic
  within the port and independent of batch composition, but they are not
  JAX's threefry draws.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lambdipy_tpu_torch.ops.attention import flash_attention
from lambdipy_tpu_torch.ops.decode_attention import (blocked_decode_attention,
                                                     gather_pages,
                                                     paged_decode_attention)
from lambdipy_tpu_torch.ops.quant import int8_matmul
from lambdipy_tpu_torch.utils.platform import resolve_device

NEG_INF = -1e9  # attention mask fill, as in the JAX package


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden: int = 4096
    layers: int = 32
    heads: int = 32
    kv_heads: int = 8
    mlp: int = 14336
    max_len: int = 8192
    rope_theta: float = 500000.0
    # None, ("linear", factor) or ("llama3", factor, low_freq_factor,
    # high_freq_factor, original_max_position_embeddings)
    rope_scaling: tuple | None = None
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    quant: str | None = None  # None | "int8"
    # KV-cache quantization: None (cache in ``dtype``) or "int8" (int8
    # values + one f32 scale per position and kv head): half the bytes
    # of the long-context decode cache, which every step re-reads
    kv_quant: str | None = None
    # "blocked" (the decode-attention kernel for one-token steps),
    # "flash" (the flash-attention kernel for prefill; plain decode) or
    # "dense" (plain PyTorch, the reference the kernels are held against)
    attn_backend: str = "blocked"
    # "pallas" (the int8 matmul kernel) or "xla" (int8 dequantized into a
    # plain matmul, the reference); the names follow the JAX package's
    # config, whose defaults are the plain ones
    matmul_backend: str = "pallas"

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads


LLAMA3_8B = LlamaConfig()
LLAMA_TINY = LlamaConfig(vocab_size=512, hidden=64, layers=2, heads=4,
                         kv_heads=2, mlp=128, max_len=128,
                         dtype=torch.float32)


class RMSNorm(nn.Module):
    """f32 math, f32 gain, result cast back to the input dtype.

    ``F.rms_norm`` reduces each row alone (one fused per-row kernel on
    the card), so a row's result does not depend on how many rows share
    the call: the continuous engine's 8-row decode then gives a row the
    bits solo decode gives it. ``mean(-1)``'s reduction tiles the rows
    by their count and differs in the last bit, now and then, between 1
    and 8 rows."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.register_buffer("scale", torch.ones(dim, dtype=torch.float32,
                                                 device=device))

    def forward(self, x):
        y = F.rms_norm(x.float(), (x.shape[-1],), eps=self.eps)
        return (y * self.scale).to(x.dtype)


class Embed(nn.Module):
    def __init__(self, vocab: int, dim: int, dtype, device=None):
        super().__init__()
        self.register_buffer("embedding", torch.empty(
            vocab, dim, dtype=dtype, device=device))

    def forward(self, tokens):
        return F.embedding(tokens, self.embedding)


class QDense(nn.Module):
    """Linear layer ``x @ kernel`` with the kernel kept ``[in, out]`` (the
    layout the int8 kernel reads). quant=None: a float kernel in
    ``dtype``. quant="int8": ``kernel_int8`` + per-output-channel f32
    ``scale`` ``[1, out]``; with ``backend="pallas"`` the product runs the
    int8 matmul kernel, else the weights are dequantized into ``dtype``.
    Weights are buffers: the port serves, it does not train."""

    def __init__(self, in_features: int, features: int, quant, dtype,
                 backend: str = "pallas", device=None):
        super().__init__()
        self.in_features, self.features = in_features, features
        self.quant, self.dtype, self.backend = quant, dtype, backend
        if quant == "int8":
            self.register_buffer("kernel_int8", torch.empty(
                in_features, features, dtype=torch.int8, device=device))
            self.register_buffer("scale", torch.empty(
                1, features, dtype=torch.float32, device=device))
        else:
            self.register_buffer("kernel", torch.empty(
                in_features, features, dtype=dtype, device=device))

    def forward(self, x):
        if self.quant == "int8":
            if self.backend == "pallas":
                flat = x.to(self.dtype).reshape(-1, self.in_features)
                out = int8_matmul(flat.contiguous(), self.kernel_int8,
                                  self.scale)
                return out.reshape(*x.shape[:-1], self.features)
            w = self.kernel_int8.to(self.dtype) * self.scale.to(self.dtype)
        else:
            w = self.kernel
        return x.to(self.dtype) @ w


def _scaled_rope_freqs(freqs, scaling):
    """RoPE inverse-frequency scaling: None, "linear", or the Llama-3.1
    "llama3" scheme (low frequencies slowed by ``factor``, high ones
    kept, a smooth ramp between)."""
    if scaling is None:
        return freqs
    kind = scaling[0]
    if kind == "linear":
        return freqs / float(scaling[1])
    if kind == "llama3":
        factor, low_f, high_f, orig = map(float, scaling[1:])
        wavelen = 2.0 * math.pi / freqs
        smooth = (orig / wavelen - low_f) / (high_f - low_f)
        mid = (1.0 - smooth) * freqs / factor + smooth * freqs
        return torch.where(wavelen > orig / low_f, freqs / factor,
                           torch.where(wavelen < orig / high_f, freqs, mid))
    raise ValueError(f"unsupported rope scaling kind {kind!r}")


def rope(q, k, positions, theta: float, scaling: tuple | None = None):
    """Rotary embeddings with f32 trig, rotate-half split (not
    interleaved). positions: ``[b, s]``."""
    head_dim = q.shape[-1]
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=q.device) / head_dim
    freqs = _scaled_rope_freqs(1.0 / (theta ** exps), scaling)
    angles = positions[..., None].float() * freqs  # [b, s, hd/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]

    def rot(x):
        x1, x2 = x.float().chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                         dim=-1).to(x.dtype)

    return rot(q), rot(k)


def _attend(q, k, v, mask):
    """Grouped-query attention core. q ``[b,s,h,d]``; k/v ``[b,t,kvh,d]``;
    mask ``[b,s,t]`` bool. f32 logits divided by ``sqrt(d)``, ``-1e9``
    fill, f32 softmax, probabilities cast to ``v.dtype`` before PV."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, d)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k).float()
    logits = logits / math.sqrt(d)
    logits = logits.masked_fill(~mask[:, None, None, :, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, d)


def _kv_quantize(x):
    """``[..., d]`` float -> (int8 values, f32 scale ``[..., 1]``):
    symmetric per-vector quantization, scale ``max|x| / 127`` floored at
    1e-8, round half to even."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().amax(dim=-1, keepdim=True) / 127.0,
                        min=1e-8)
    return torch.round(x32 / scale).to(torch.int8), scale


def _kv_dequantize(q_i8, scale, dtype):
    """The dense decode path's dequant, as in the JAX package: int8 and
    scale each cast to ``dtype``, then multiplied."""
    return q_i8.to(dtype) * scale.to(dtype)


def cache_width(cache) -> int:
    """Sequence capacity of a decode cache, float or int8 layout."""
    entry = cache[0]
    leaf = entry["k"] if "k" in entry else entry["k_int8"]
    return leaf.shape[1]


def _kv_store(cfg: LlamaConfig, k, v) -> dict:
    """K/V in the cache's storage layout: the float leaves ``k``/``v``
    in ``cfg.dtype``, or ``k_int8``/``k_scale``/``v_int8``/``v_scale``
    under ``kv_quant="int8"``."""
    if cfg.kv_quant == "int8":
        k_q, k_s = _kv_quantize(k)
        v_q, v_s = _kv_quantize(v)
        return {"k_int8": k_q, "k_scale": k_s,
                "v_int8": v_q, "v_scale": v_s}
    return {"k": k.to(cfg.dtype), "v": v.to(cfg.dtype)}


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.head_dim

        def dense(n_in, n_out):
            return QDense(n_in, n_out, cfg.quant, cfg.dtype,
                          cfg.matmul_backend, device)

        self.attn_norm = RMSNorm(cfg.hidden, cfg.norm_eps, device)
        self.q_proj = dense(cfg.hidden, cfg.heads * d)
        self.k_proj = dense(cfg.hidden, cfg.kv_heads * d)
        self.v_proj = dense(cfg.hidden, cfg.kv_heads * d)
        self.o_proj = dense(cfg.heads * d, cfg.hidden)
        self.mlp_norm = RMSNorm(cfg.hidden, cfg.norm_eps, device)
        self.gate_proj = dense(cfg.hidden, cfg.mlp)
        self.up_proj = dense(cfg.hidden, cfg.mlp)
        self.down_proj = dense(cfg.mlp, cfg.hidden)

    def _prefill_attend(self, q, k, v, mask):
        """Causal prefill attention. ``flash`` ignores the padding mask,
        as the JAX package does: with right padding no real query sees a
        pad key, so real rows agree with ``dense``; the pad positions'
        K/V differ from the second layer on, and decode never reads
        them."""
        if self.cfg.attn_backend == "flash":
            return flash_attention(q, k, v, causal=True)
        s = q.shape[1]
        causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        return _attend(q, k, v, mask[:, None, :] & causal[None])

    def _paged_decode(self, q, k, v, cache):
        """One decode step over a paged cache entry: the arena's
        ``_kv_store`` leaves ``[P, page, kvh, d]``, block ``tables``
        ``[b, nb]`` int32, the per-row ``index`` ``[b]`` and this step's
        write address (:func:`set_decode_index`). Row r writes this
        step's K/V there; then attention over positions ``<= index``: the
        paged kernel under ``blocked``, a gather and ``_attend`` under
        ``dense``."""
        cfg = self.cfg
        tables, idx = cache["tables"], cache["index"]
        names = ("k_int8", "v_int8") if cfg.kv_quant == "int8" else ("k", "v")
        page = cache[names[0]].shape[1]
        nb = tables.shape[1]
        pid, off = cache["write_page"], cache["write_off"]
        for name, val in _kv_store(cfg, k, v).items():
            cache[name][pid, off] = val[:, 0]
        scales = ({"k_scale_pages": cache["k_scale"],
                   "v_scale_pages": cache["v_scale"]}
                  if cfg.kv_quant == "int8" else {})
        ck, cv = cache[names[0]], cache[names[1]]
        if cfg.attn_backend == "blocked":
            return paged_decode_attention(q, ck, cv, tables, cache["active"],
                                          **scales)
        gathered = _gather_page_cache([cache], tables, nb * page, page,
                                      idx)[0]
        ck, cv = gathered[names[0]], gathered[names[1]]
        if scales:
            ck = _kv_dequantize(ck, gathered["k_scale"], cfg.dtype)
            cv = _kv_dequantize(cv, gathered["v_scale"], cfg.dtype)
        valid = (torch.arange(nb * page, device=q.device)[None, None, :]
                 <= idx[:, None, None])  # [b, 1, t]
        return _attend(q, ck, cv, valid)

    def forward(self, x, positions, mask, cache):
        """cache: None (prefill over all of x) or a decode-cache entry
        for a one-token decode step: the ``_kv_store`` leaves and a
        per-row ``[b]`` index, or a paged entry (arena leaves, block
        ``tables`` and the index; :meth:`_paged_decode`). Returns ``(y,
        new_cache_entry)``; a decode step writes the cache in place. The
        prefill entry is float K/V; ``prefill_into_cache`` stores it in
        the cache's layout."""
        cfg = self.cfg
        d = cfg.head_dim
        h = self.attn_norm(x)
        b, s, _ = h.shape
        q = self.q_proj(h).reshape(b, s, cfg.heads, d)
        k = self.k_proj(h).reshape(b, s, cfg.kv_heads, d)
        v = self.v_proj(h).reshape(b, s, cfg.kv_heads, d)
        q, k = rope(q, k, positions, cfg.rope_theta, cfg.rope_scaling)

        if cache is None:
            out = self._prefill_attend(q, k, v, mask)
            new_cache = {"k": k, "v": v}
        elif "tables" in cache:
            if s != 1:
                raise ValueError("the paged cache branch takes one-token "
                                 f"decode steps, got {s} tokens")
            out = self._paged_decode(q, k, v, cache)
            new_cache = cache
        else:
            if s != 1:
                raise ValueError("the per-row cache branch takes one-token "
                                 f"decode steps, got {s} tokens")
            idx = cache["index"]  # [b]
            store = _kv_store(cfg, k, v)
            t = cache_width([cache])
            # the JAX scatter drops out-of-bounds writes; an out-of-bounds
            # index is a device assert here, so such rows rewrite the
            # value already at their clamped slot instead
            rows = torch.arange(b, device=x.device)
            slot = idx.clamp(max=t - 1).long()
            keep = (idx < t)[:, None, None]
            new_cache = {}
            for name, val in store.items():
                leaf = cache[name]
                leaf[rows, slot] = torch.where(keep, val[:, 0],
                                               leaf[rows, slot])
                new_cache[name] = leaf
            if cfg.kv_quant == "int8":
                ck, cv = new_cache["k_int8"], new_cache["v_int8"]
                scales = {"k_scale": new_cache["k_scale"],
                          "v_scale": new_cache["v_scale"]}
            else:
                ck, cv = new_cache["k"], new_cache["v"]
                scales = {}
            if cfg.attn_backend == "blocked":
                # the valid mask "position <= index" is active_len = index + 1
                active = (idx + 1).to(torch.int32)
                out = blocked_decode_attention(q, ck, cv, active, **scales)
            else:
                if scales:
                    ck = _kv_dequantize(ck, scales["k_scale"], cfg.dtype)
                    cv = _kv_dequantize(cv, scales["v_scale"], cfg.dtype)
                valid = (torch.arange(t, device=x.device)[None, None, :]
                         <= idx[:, None, None])  # [b, 1, t]
                out = _attend(q, ck, cv, valid)

        out = out.reshape(b, s, cfg.heads * d)
        x = x + self.o_proj(out)
        h = self.mlp_norm(x)
        x = x + self.down_proj(F.silu(self.gate_proj(h)) * self.up_proj(h))
        return x, new_cache


class LlamaModel(nn.Module):
    """The decoder. Layers are registered as ``layer_{i}`` and every weight
    keeps its flax name, so ``state_dict`` keys are the flax param paths
    with ``/`` replaced by ``.`` (``layer_0.q_proj.kernel_int8``).

    ``device`` defaults to the CUDA card and raises when there is none."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        dev = self.device
        self.embed = Embed(cfg.vocab_size, cfg.hidden, cfg.dtype, dev)
        for i in range(cfg.layers):
            self.add_module(f"layer_{i}", LlamaBlock(cfg, dev))
        self.final_norm = RMSNorm(cfg.hidden, cfg.norm_eps, dev)
        # the lm_head runs with f32 dtype, as in the JAX model
        self.lm_head = QDense(cfg.hidden, cfg.vocab_size, cfg.quant,
                              torch.float32, cfg.matmul_backend, dev)

    def blocks(self):
        return [getattr(self, f"layer_{i}") for i in range(self.cfg.layers)]

    def forward(self, tokens, positions=None, mask=None, cache=None,
                logit_positions=None):
        """Returns ``(logits, new_cache)``.

        prefill: cache=None, tokens ``[b, s]`` -> float cache entries
        sized s. decode: cache = a decode cache (``init_decode_cache``
        layout), tokens ``[b, 1]``.
        logit_positions: optional ``[b]`` — the lm_head runs only at that
        position per row (logits ``[b, 1, v]``)."""
        b, s = tokens.shape
        if positions is None:
            positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
        if mask is None:
            mask = torch.ones(b, s, dtype=torch.bool, device=tokens.device)
        x = self.embed(tokens)
        new_cache = []
        for i, block in enumerate(self.blocks()):
            x, c = block(x, positions, mask,
                         None if cache is None else cache[i])
            new_cache.append(c)
        x = self.final_norm(x)
        if logit_positions is not None:
            x = x[torch.arange(b, device=x.device), logit_positions.long()]
            x = x[:, None, :]
        return self.lm_head(x), new_cache


def _empty_cache_entry(cfg: LlamaConfig, batch: int, max_len: int,
                       device) -> dict:
    """One layer's empty cache leaves in the ``_kv_store`` layout; int8
    scales start at 1e-8, as in the JAX package."""
    shape = (batch, max_len, cfg.kv_heads, cfg.head_dim)
    if cfg.kv_quant == "int8":
        def scale():
            return torch.full(shape[:3] + (1,), 1e-8, dtype=torch.float32,
                              device=device)

        return {"k_int8": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": scale(),
                "v_int8": torch.zeros(shape, dtype=torch.int8, device=device),
                "v_scale": scale()}
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def init_decode_cache(cfg: LlamaConfig, batch: int, max_len: int, device):
    """Static-shape KV cache for decode (one entry per layer, float or
    int8 leaves by ``cfg.kv_quant``), with a per-row ``[batch]`` int32
    index."""
    return [{**_empty_cache_entry(cfg, batch, max_len, device),
             "index": torch.zeros(batch, dtype=torch.int32, device=device)}
            for _ in range(cfg.layers)]


def prefill_into_cache(cfg: LlamaConfig, prefill_cache, batch: int,
                       max_len: int, prompt_len: int):
    """Embed a prefill cache (float entries sized s) at position 0 of a
    static ``max_len`` decode cache, quantizing under ``cfg.kv_quant``."""
    device = prefill_cache[0]["k"].device
    out = init_decode_cache(cfg, batch, max_len, device)
    for dest, entry in zip(out, prefill_cache):
        s = entry["k"].shape[1]
        for name, val in _kv_store(cfg, entry["k"], entry["v"]).items():
            dest[name][:, :s] = val
        dest["index"].fill_(prompt_len)
    return out


NULL_PAGE = 0  # the arena's reserved page (runtime/pagepool.py)


def init_page_arena(cfg: LlamaConfig, n_pages: int, page: int, device):
    """The paged KV arena: per layer, the decode cache's store-layout
    leaves page-major, ``[n_pages, page, kv_heads, head_dim]`` (int8
    scales ``[..., 1]`` starting at 1e-8), with no ``index`` leaf: row
    positions live in the block tables. Page 0 is the null page."""
    device = resolve_device(device)
    return [_empty_cache_entry(cfg, n_pages, page, device)
            for _ in range(cfg.layers)]


def page_kv_bytes(cfg: LlamaConfig, page: int) -> int:
    """Exact stored bytes of ONE page across all layers and leaves."""
    per_pos = cfg.kv_heads * cfg.head_dim
    if cfg.kv_quant == "int8":
        # int8 k + v values, f32 per-position-per-head scales
        per_layer = page * (2 * per_pos + 2 * cfg.kv_heads * 4)
    else:
        itemsize = torch.empty((), dtype=cfg.dtype).element_size()
        per_layer = page * 2 * per_pos * itemsize
    return int(cfg.layers * per_layer)


# the non-leaf entries of a paged cache entry (:func:`set_decode_index`)
PAGED_STEP_KEYS = ("tables", "index", "write_page", "write_off", "active")


def set_decode_index(cache, pos) -> None:
    """Point every layer's decode-cache entry at per-row positions
    ``pos`` ``[b]``. A paged cache (entries holding block ``tables``)
    also gets this step's write address, computed once for all layers:
    page ``tables[r, pos // page]`` at offset ``pos % page``, or the null
    page for a position past the table (the JAX scatter drops such a
    write; nothing reads the null page unmasked), and the attention
    length ``pos + 1``."""
    step = {"index": pos}
    first = cache[0]
    if "tables" in first:
        tables = first["tables"]
        page = first["k_int8" if "k_int8" in first else "k"].shape[1]
        nb = tables.shape[1]
        blk = torch.div(pos, page, rounding_mode="floor").long()
        pid = tables.gather(1, blk.clamp(max=nb - 1)[:, None])[:, 0].long()
        step.update(write_page=torch.where(blk < nb, pid, NULL_PAGE),
                    write_off=torch.remainder(pos, page).long(),
                    active=(pos + 1).to(torch.int32))
    for entry in cache:
        entry.update(step)


def _gather_page_cache(arena, tables, window: int, page: int, index):
    """Each row's first ``window`` positions gathered from its block
    table into a contiguous decode cache (one dict per layer, ``index``
    attached; non-leaf entries such as ``tables`` are skipped). The
    gathered values are bitwise the pages' values, null pages included."""
    nb = window // page
    out = []
    for entry in arena:
        e = {name: gather_pages(val, tables[:, :nb])
             for name, val in entry.items() if name not in PAGED_STEP_KEYS}
        e["index"] = index
        out.append(e)
    return out


def _scatter_page_cache(arena, tables, cache, page: int):
    """Write a contiguous per-row cache (width a multiple of ``page``)
    back into its block-table pages, in place: the inverse of
    :func:`_gather_page_cache`. Table entries that are the null page
    take whatever lands there; nothing reads them unmasked."""
    b = tables.shape[0]
    for aentry, centry in zip(arena, cache):
        for name, val in aentry.items():
            c = centry[name]
            nb = c.shape[1] // page
            pages = c.reshape(b * nb, page, *c.shape[2:]).to(val.dtype)
            val[tables[:, :nb].reshape(-1).long()] = pages
    return arena


def pack_prefill_into_pages(cfg: LlamaConfig, arena, table_row,
                            prefill_cache, src: int) -> None:
    """Store row ``src`` of a prefill cache (float entries ``[gb, sb,
    kvh, d]``) in the arena through ``table_row`` ``[nb]`` (the row's
    pages, null-padded), quantizing under ``cfg.kv_quant``. The prompt's
    bucket is zero-padded to whole pages; positions past the row's pages
    land in the null page."""
    page = arena[0][next(iter(arena[0]))].shape[1]
    sb = prefill_cache[0]["k"].shape[1]
    width = -(-sb // page) * page
    cache = []
    for entry in prefill_cache:
        k, v = entry["k"][src:src + 1], entry["v"][src:src + 1]
        if width != sb:
            pad = (0, 0, 0, 0, 0, width - sb)
            k, v = F.pad(k, pad), F.pad(v, pad)
        cache.append(_kv_store(cfg, k, v))
    _scatter_page_cache(arena, table_row[None, :width // page], cache, page)


# ---------------------------------------------------------------- generation

def filter_logits_runtime(logits, top_k, top_p):
    """Mask logits outside the top-k and then the nucleus (top-p) set to
    -1e30, with per-row knobs: top_k ``[b]`` (<= 0 = off), top_p ``[b]``
    (>= 1 = off). The highest-probability token is always kept."""
    neg = -1e30
    v = logits.shape[-1]
    rows = logits.shape[:-1]
    top_k = torch.as_tensor(top_k, device=logits.device).long().expand(rows)
    top_p = torch.as_tensor(top_p, dtype=torch.float32,
                            device=logits.device).expand(rows)
    srt = torch.sort(logits, dim=-1, descending=True).values
    kth = srt.gather(-1, (top_k - 1).clamp(0, v - 1)[..., None])
    logits = torch.where((top_k > 0)[..., None] & (logits < kth), neg,
                         logits)
    srt = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(srt, dim=-1)
    keep = (torch.cumsum(probs, dim=-1) - probs) < top_p[..., None]
    keep[..., 0] = True
    thresh = torch.where(keep, srt, math.inf).amin(-1, keepdim=True)
    return torch.where((top_p < 1.0)[..., None] & (logits < thresh), neg,
                       logits)


def _token_logprob(lg, tok):
    """Raw model logprob of ``tok`` under f32 logits ``lg`` ``[b, v]``.
    ``log_softmax`` reduces each row alone, so the value does not depend
    on the batch (``logsumexp``'s reduction does, in the last bit)."""
    return F.log_softmax(lg, dim=-1).gather(-1, tok[:, None])[:, 0]


def row_generators(seeds, device):
    """One ``torch.Generator`` per row, seeded from ``(seed, row)`` pairs
    alone (``seeds`` is a list of such pairs), so a row's draws never
    depend on what shares its batch."""
    gens = []
    for seed, row in seeds:
        state = np.random.SeedSequence([seed % 2 ** 64, row]).generate_state(
            1, np.uint64)[0]
        gen = torch.Generator(device=device)
        gen.manual_seed(int(state))
        gens.append(gen)
    return gens


def _serve_select(temperature, top_k, top_p):
    """Token selection over per-row knobs. ``temperature`` is a host numpy
    ``[b]`` array (<= 0 = greedy), top_k/top_p per-row tensors.
    ``select(lg [b, v] f32, gens)`` returns ``(token [b], raw logprob
    [b])``. An all-greedy batch skips the sampling path (its two sorts
    and the noise draws) entirely, as the JAX ``lax.cond`` does."""
    sampled_rows = temperature > 0

    def select(lg, gens):
        lg = lg.float()
        greedy = lg.argmax(dim=-1)
        if not sampled_rows.any():
            return greedy, _token_logprob(lg, greedy)
        t_row = torch.as_tensor(temperature, device=lg.device)
        t = t_row.clamp(min=1e-6)[:, None]
        filt = filter_logits_runtime(lg / t, top_k, top_p)
        # Gumbel-max: argmax(logits + Gumbel noise) is a categorical draw
        u = torch.stack([torch.rand(lg.shape[-1], generator=g,
                                    device=lg.device) for g in gens])
        draw = (filt - torch.log(-torch.log(u))).argmax(dim=-1)
        tok = torch.where(t_row > 0, draw, greedy)
        return tok, _token_logprob(lg, tok)

    return select


def _serve_prefill(model: LlamaModel, prompt, length, select, gens, eos_id,
                   *, cache_len: int):
    """Bucketed serving prefill: embed the prompt into a ``cache_len``
    decode cache and select the first token. Returns the decode carry
    ``(first, lp0, cache, pos, done)``."""
    b = prompt.shape[0]
    logits, prefill_cache = model(prompt, logit_positions=length - 1)
    cache = prefill_into_cache(model.cfg, prefill_cache, b, cache_len, 0)
    for entry in cache:
        entry["index"] = length
    first, lp0 = select(logits[:, 0, :].float(), gens)
    done0 = (eos_id >= 0) & (first == eos_id)
    return first, lp0, cache, length, done0


def _scan_decode(model: LlamaModel, select, first, lp0, cache, start, done0,
                 gens, eos_id, decode_steps: int, return_carry: bool = False):
    """The decode loop: emits ``decode_steps`` tokens starting with
    ``first``. Rows latch at ``eos_id`` (``< 0`` = none): after eos a row
    emits eos with logprob 0. ``pos`` is per row. The JAX server scans a
    bucketed number of steps and drops the tokens past the request;
    this loop runs exactly ``decode_steps - 1`` forwards. Returns
    ``(tokens, logprobs)``, each ``[b, decode_steps]``.

    ``return_carry`` is the segment form: every step forwards the token
    it emits (``decode_steps`` forwards, as the JAX scan) and the final
    carry ``(tok, lp, cache, pos, done, gens)`` comes back too, so a
    later segment continues the decode exactly where this one stopped."""
    has_eos = eos_id >= 0
    tok, lp, pos, done = first, lp0, start, done0
    toks, lps = [], []
    for i in range(decode_steps):
        toks.append(tok)
        lps.append(lp)
        if i == decode_steps - 1 and not return_carry:
            break
        # the blocks write this step's K/V into the cache in place
        set_decode_index(cache, pos)
        logits, _ = model(tok[:, None], positions=pos[:, None], cache=cache)
        pos = pos + 1
        nxt, nlp = select(logits[:, -1, :].float(), gens)
        nxt = torch.where(done, eos_id, nxt)
        nlp = torch.where(done, 0.0, nlp)
        done = done | (has_eos & (nxt == eos_id))
        tok, lp = nxt, nlp
    for entry in cache:
        entry["index"] = pos
    out = (torch.stack(toks, dim=1), torch.stack(lps, dim=1))
    return (out, (tok, lp, cache, pos, done, gens)) if return_carry else out


MIN_BUCKET = 16  # smallest prompt and decode bucket, as in the JAX server


def _next_bucket(n: int, lo: int) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class LlamaServer:
    """Bucketed serving over a :class:`LlamaModel`: prompts pad right to a
    power-of-two bucket, batches to a power-of-two row count with dummy
    length-1 rows, and every sampling knob is a per-row operand, as in
    the JAX server. Calls are serialized by a lock (one card, one
    stream)."""

    def __init__(self, model: LlamaModel):
        self.model = model
        self._lock = threading.Lock()

    @property
    def device(self):
        return self.model.device

    def _validate(self, s: int, max_new_tokens: int) -> None:
        cfg = self.model.cfg
        if max_new_tokens < 0:
            raise ValueError(f"max_new_tokens must be >= 0, got {max_new_tokens}")
        if s + max_new_tokens > cfg.max_len:
            raise ValueError(
                f"prompt {s} + max_new_tokens {max_new_tokens} exceeds "
                f"max_len {cfg.max_len}")

    def _pad_rows(self, rows, lengths, bb: int, sb: int):
        """(padded ``[bb, sb]`` token tensor, per-row length tensor); dummy
        length-1 rows fill the batch bucket."""
        padded = np.zeros((bb, sb), np.int64)
        for r, row in enumerate(rows):
            padded[r, :lengths[r]] = row
        lens = np.asarray(lengths + [1] * (bb - len(rows)), np.int32)
        return (torch.as_tensor(padded, device=self.device),
                torch.as_tensor(lens, device=self.device))

    def _knob_operands(self, temperature, top_k, top_p, seed, eos_id,
                       b: int = 1):
        """Per-row knobs: ``(temperature [b] numpy f32, top_k [b], top_p
        [b], generators, eos [b])``. Each knob is a scalar (broadcast;
        None = the disabled value) or a list of per-row values padded with
        the disabled value. Row r's generator is seeded from
        ``(seed_r, 0)`` for a list of seeds and ``(seed, r)`` for one
        shared seed — a function of the row's own request alone."""

        def vec(x, default, dtype):
            if isinstance(x, (list, tuple, np.ndarray)):
                vals = [default if e is None else e for e in x]
                vals += [default] * (b - len(vals))
                return np.asarray(vals[:b], dtype)
            return np.full((b,), default if x is None else x, dtype)

        if isinstance(seed, (list, tuple, np.ndarray)):
            seeds = ([int(s) if s is not None else 0 for s in seed]
                     + [0] * b)[:b]
            pairs = [(s, 0) for s in seeds]
        else:
            base = int(seed) if seed is not None else 0
            pairs = [(base, r) for r in range(b)]

        def dev(a):
            return torch.as_tensor(a, device=self.device)

        return (vec(temperature, 0.0, np.float32),
                dev(vec(top_k, 0, np.int64)),
                dev(vec(top_p, 1.0, np.float32)),
                row_generators(pairs, self.device),
                dev(vec(eos_id, -1, np.int64)))

    def generate(self, prompt_tokens, *, max_new_tokens: int,
                 temperature: float = 0.0, top_k: int | None = None,
                 top_p: float | None = None, seed: int = 0,
                 eos_id: int | None = None, return_logprobs: bool = False):
        """prompt_tokens: ``[s]``, ``[b, s]`` or a ragged list of rows ->
        int32 numpy ``[b, max_new_tokens]`` (plus f32 logprobs when
        asked). Knobs may be scalars or per-row lists."""
        rows, lengths = self._normalize_prompts(prompt_tokens)
        b, s = len(rows), max(lengths)
        self._validate(s, max_new_tokens)
        if max_new_tokens == 0:
            toks = np.zeros((b, 0), np.int32)
            return (toks, np.zeros((b, 0), np.float32)) if return_logprobs \
                else toks
        with self._lock, torch.inference_mode():
            select, gens, eos, carry = self._prefill(
                rows, lengths, max_new_tokens, temperature, top_k, top_p,
                seed, eos_id)
            toks, lps = _scan_decode(self.model, select, *carry, gens, eos,
                                     max_new_tokens)
            toks = toks[:b].to(torch.int32).cpu().numpy()
            if return_logprobs:
                return toks, lps[:b].float().cpu().numpy()
        return toks

    def prompt_bucket(self, s: int, max_new_tokens: int) -> int:
        """The padded prompt width ``generate`` prefills a prompt of ``s``
        tokens at: the pow-2 bucket, shrunk toward ``s`` near
        ``max_len``."""
        max_len = self.model.cfg.max_len
        steps = min(_next_bucket(max_new_tokens, MIN_BUCKET), max_len - s)
        return min(_next_bucket(s, MIN_BUCKET), max_len - steps)

    def _prefill(self, rows, lengths, max_new_tokens, temperature, top_k,
                 top_p, seed, eos_id):
        """The bucketed prefill shared by :meth:`generate` and
        :meth:`generate_stream` (caller holds the lock, inference mode):
        ``(select, gens, eos, (first, lp0, cache, pos, done))``."""
        cfg = self.model.cfg
        b, s = len(rows), max(lengths)
        steps = min(_next_bucket(max_new_tokens, MIN_BUCKET), cfg.max_len - s)
        sb = self.prompt_bucket(s, max_new_tokens)
        bb = _next_bucket(b, 1)
        cache_len = min(sb + steps, cfg.max_len)
        prompt, length = self._pad_rows(rows, lengths, bb, sb)
        temp, tk, tp, gens, eos = self._knob_operands(
            temperature, top_k, top_p, seed, eos_id, b=bb)
        select = _serve_select(temp, tk, tp)
        carry = _serve_prefill(self.model, prompt, length, select, gens, eos,
                               cache_len=cache_len)
        return select, gens, eos, carry

    def generate_stream(self, prompt_tokens, *, max_new_tokens: int,
                        temperature: float = 0.0, top_k: int | None = None,
                        top_p: float | None = None, seed: int = 0,
                        eos_id: int | None = None, segment: int = 16,
                        return_logprobs: bool = False):
        """Streaming :meth:`generate`: yields int32 numpy ``[b, k]``
        chunks (``k <= segment``; ``(tokens, logprobs)`` pairs when
        asked) as they decode, stopping early once every row has latched
        eos. Concatenated chunks are exactly :meth:`generate`'s output
        prefix: the same prefill and cache, the same per-row generators
        (segment boundaries do not change a row's draws). The lock is
        held per segment, not across the yields."""
        rows, lengths = self._normalize_prompts(prompt_tokens)
        b, s = len(rows), max(lengths)
        self._validate(s, max_new_tokens)
        if max_new_tokens == 0:
            return
        segment = max(1, min(int(segment), max_new_tokens))
        with self._lock, torch.inference_mode():
            select, gens, eos, carry = self._prefill(
                rows, lengths, max_new_tokens, temperature, top_k, top_p,
                seed, eos_id)
        tok, lp, cache, pos, done = carry
        emitted = 0
        while emitted < max_new_tokens:
            k = min(segment, max_new_tokens - emitted)
            with self._lock, torch.inference_mode():
                (toks, lps), (tok, lp, cache, pos, done, gens) = \
                    _scan_decode(self.model, select, tok, lp, cache, pos,
                                 done, gens, eos, k, return_carry=True)
                chunk = toks[:b].to(torch.int32).cpu().numpy()
                lp_chunk = lps[:b].float().cpu().numpy()
                latched = eos_id is not None and bool(done[:b].all())
            emitted += k
            yield (chunk, lp_chunk) if return_logprobs else chunk
            if latched:
                return

    @staticmethod
    def _normalize_prompts(prompt_tokens):
        """-> (list of 1-D int32 row arrays, list of true lengths)."""
        if isinstance(prompt_tokens, (list, tuple)) and prompt_tokens and \
                isinstance(prompt_tokens[0], (list, tuple, np.ndarray)):
            rows = [np.asarray(r, np.int32).reshape(-1) for r in prompt_tokens]
        else:
            ids = np.asarray(prompt_tokens, np.int32)
            rows = list(ids[None, :] if ids.ndim == 1 else ids)
        if not rows or any(len(r) < 1 for r in rows):
            raise ValueError("empty prompt")
        return rows, [len(r) for r in rows]
