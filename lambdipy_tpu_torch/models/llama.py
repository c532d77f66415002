"""Llama-3-style decoder-only LM in PyTorch: GQA + RoPE + RMSNorm + SwiGLU,
int8 weight-only quantization, a static KV cache, and the compile-once
server's bucketed generation.

Twin of ``lambdipy_tpu/models/llama.py``; names, layouts and numerics
follow it so the two can be held against each other on the same
weights (``models/params.py from_jax_params``). Differences:

- The decode step runs on buffers at fixed addresses (:class:`DecodeStep`)
  and, on the card, as a captured CUDA graph replayed once per step; so
  does every prefill (:class:`PrefillProgram`: the serving prefill, a
  prefix continuation, a walk's chunks, the engine's grouped and long
  rows). The server keeps those programs in a bucket-keyed LRU
  (``models/graphs.py``), the counterpart of the JAX server's compiled
  programs. ``_scan_decode`` is a Python loop of replays. The bucketing
  (prompt, decode and batch buckets, ``cache_len``) is kept, so the
  kernels see the shapes the JAX programs see.
- The KV cache is updated in place (the JAX cache is functional). A
  prefix entry the server or the prefix store shares is never written:
  a continuation runs on a copy (the step's own cache, or a one-row
  window, :class:`WindowEntry`), as the JAX ext program's donation needs
  the copy ``runtime/prefixstore.py`` makes first.
- Cache indices are per-row ``[b]`` tensors (one-token decode steps) or
  one scalar (the multi-token chunk of a continuation or of a prefix
  walk, :meth:`LlamaBlock._chunk_attend`): a 0-dim device tensor, so a
  captured chunk reads its position from a buffer, or a Python ``int``.
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
- Sampling draws Gumbel-max noise that is a hash of the row's key (from
  its ``(seed, row)`` alone), its draw index and the vocab index
  (:func:`stream_uniform`), carried on the device. Tokens are
  deterministic within the port and independent of batch composition,
  but they are not JAX's threefry draws. A speculative verify rolls a
  rejected tail's draws back by advancing the draw index by the accepted
  count (:class:`VerifyStep`).
- Speculative decoding scores a verify chunk ``[b, kb]`` as ``b * kb``
  one-token rows, so every accepted position is bitwise the one-token
  step (JAX runs the chunk through its scalar-index branch and admits a
  bf16 argmax difference on the solo path).
- Tensor parallelism (a serving mesh's ``tp``): JAX runs one program over
  N devices and XLA inserts the collectives; here each of N processes
  holds one rank's share (:class:`ShardConfig`: ``heads``, ``kv_heads``,
  ``mlp`` and the vocabulary over ``tp``) and the forward runs explicit
  Megatron collectives (``parallel/distributed.py``): the masked
  embedding and the row-parallel ``o_proj`` and ``down_proj`` are summed
  over the ranks (a gather, then a sum in rank order), the lm_head's
  vocabulary columns gathered. Every rank samples the same gathered
  logits with the same streams. The ranks' calls come in one order
  through the controller's dispatcher (``parallel/tpserve.py``), and
  each rank runs the port's kernels on its share; at ``tp > 1`` the
  server runs eagerly (a CUDA graph cannot hold a gloo collective).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import hashlib
import math
import threading
from collections import OrderedDict
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lambdipy_tpu_torch.models.graphs import (DEVICE_LOCK, CudaGraph,
                                              GraphProgram, GraphStats,
                                              ProgramCache, ProgramSet,
                                              StepPrograms)
from lambdipy_tpu_torch.models.moe import EXPERT_KEYS, MoEMLP, moe_aux_loss
from lambdipy_tpu_torch.models.spec import (accept_resample, chain_verify,
                                            lookup_draft_hit)
from lambdipy_tpu_torch.ops.attention import flash_attention
from lambdipy_tpu_torch.ops.decode_attention import (blocked_decode_attention,
                                                     gather_pages,
                                                     paged_decode_attention)
from lambdipy_tpu_torch.ops.quant import int8_matmul
from lambdipy_tpu_torch.parallel.distributed import (tp_all_gather,
                                                     tp_all_reduce)
from lambdipy_tpu_torch.runtime.metrics import SpecDecodeStats
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
    # Sparse MoE FFN (Mixtral-style, ``models/moe.py``): > 0 replaces the
    # dense SwiGLU with ``moe_experts`` top-k routed experts
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_group_size: int = 256  # routing-group size

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads


@dataclasses.dataclass(frozen=True)
class ShardConfig(LlamaConfig):
    """One tensor-parallel rank's share of a model split over ``tp``
    ranks: ``heads``, ``kv_heads``, ``mlp`` and ``vocab_size`` are the
    rank's (the whole model's over ``tp``), ``head_dim`` the whole
    model's, so every function that sizes from a config (the decode
    cache, the page arena, program bytes) sizes this rank's share. The
    JAX package has no twin: one JAX program holds every shard."""

    tp: int = 1

    @property
    def head_dim(self) -> int:
        return self.hidden // (self.heads * self.tp)


# the fields a tensor-parallel rank holds a share of
_SHARDED_FIELDS = ("heads", "kv_heads", "mlp", "vocab_size")

# what a serving mesh cannot carry at tp > 1 yet
TP_C2 = ("{} at tp > 1 is not ported yet (ROADMAP queue 1, item 3 (c2): "
         "tensor-parallel serving's remaining features)")


def shard_config(cfg: LlamaConfig, tp: int) -> LlamaConfig:
    """The config of one of ``tp`` ranks' shares of ``cfg`` (``cfg``
    itself at ``tp`` 1); :func:`validate_serving_mesh` first, and the
    vocabulary must split evenly too."""
    if tp <= 1 or isinstance(cfg, ShardConfig):
        return cfg
    if cfg.vocab_size % tp:
        raise ValueError(f"mesh tp={tp} does not divide vocab_size="
                         f"{cfg.vocab_size}: the embedding and the lm_head "
                         "shard the vocabulary over tp")
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(LlamaConfig)}
    fields.update({name: fields[name] // tp for name in _SHARDED_FIELDS})
    return ShardConfig(**fields, tp=tp)


def whole_config(cfg: LlamaConfig) -> LlamaConfig:
    """The whole model's config of a rank's :class:`ShardConfig` (``cfg``
    itself otherwise)."""
    if not isinstance(cfg, ShardConfig):
        return cfg
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(LlamaConfig)}
    fields.update({name: fields[name] * cfg.tp
                   for name in _SHARDED_FIELDS})
    return LlamaConfig(**fields)


def validate_serving_mesh(cfg: LlamaConfig, mesh) -> None:
    """Reject serving meshes the TP layout cannot honor (JAX
    ``llama.py:630-652``, its message): a ``tp`` that does not divide the
    kv heads, the heads or the MLP hidden dim raises, rather than paying
    N devices to replicate the KV cache. ``mesh``: a
    ``parallel/mesh.py`` ``Mesh`` or ``{axis: size}``."""
    shape = dict(getattr(mesh, "shape", mesh) or {})
    tp = int(shape.get("tp", 1))
    if tp <= 1:
        return
    cfg = whole_config(cfg)
    bad = []
    if cfg.kv_heads % tp:
        bad.append(f"kv_heads={cfg.kv_heads}")
    if cfg.heads % tp:
        bad.append(f"heads={cfg.heads}")
    if cfg.mlp % tp:
        bad.append(f"mlp={cfg.mlp}")
    if bad:
        raise ValueError(
            f"mesh tp={tp} does not divide {', '.join(bad)}: the "
            "tensor-parallel layout shards attention heads and the MLP "
            "hidden dim over tp, and the KV cache over kv_heads — pick "
            "a tp that divides all three (or drop the mesh)")


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

    @staticmethod
    def rows_alone(x) -> bool | None:
        """The int8 kernel's route word for an activation ``[..., s, f]``
        (``ops/quant.py::int8_route``): True at s == 1 (a decode step, the
        lm_head at the logit positions), so every row takes the GEMV and
        keeps the bits it has alone whatever the batch; False for a
        prefill (the tiled route); None, the kernel's default, for 2-D
        x."""
        return None if x.dim() < 3 else x.shape[-2] == 1

    def forward(self, x):
        if self.quant == "int8":
            if self.backend == "pallas":
                flat = x.to(self.dtype).reshape(-1, self.in_features)
                out = int8_matmul(flat.contiguous(), self.kernel_int8,
                                  self.scale, rows_alone=self.rows_alone(x))
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


def _scalar_index(index) -> bool:
    """A chunk's index: one scalar (an ``int`` or a 0-dim tensor), not a
    decode step's per-row ``[b]`` tensor."""
    return isinstance(index, int) or (torch.is_tensor(index)
                                      and index.dim() == 0)


def _device_index(index, s: int, width: int, device):
    """A chunk's scalar index as a 0-dim int64 tensor on ``device``. An
    ``int`` is checked against the cache first (a chunk of ``s`` tokens
    must end inside its ``width`` positions) and made with a fill, not a
    host copy."""
    if torch.is_tensor(index):
        return index
    if index < 0 or index + s > width:
        raise ValueError(f"a {s}-token chunk at index {index} crosses the "
                         f"cache's {width} positions")
    return torch.full((), index, dtype=torch.long, device=device)


class LlamaBlock(nn.Module):
    # a tensor-parallel rank's group (``parallel/distributed.py``
    # ``TPGroup``): o_proj's and down_proj's partial products are summed
    # over it; None: the whole model
    tp = None

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
        if cfg.moe_experts:
            self.moe = MoEMLP(cfg.hidden, cfg.moe_experts, cfg.mlp,
                              cfg.moe_top_k, cfg.moe_capacity_factor,
                              cfg.dtype, cfg.quant, cfg.moe_group_size,
                              device)
        else:
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
        write address (:meth:`DecodeStep.step`). Row r writes this
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

    def _chunk_attend(self, q, k, v, cache):
        """A chunk of ``s`` tokens at one scalar ``index`` (a 0-dim device
        tensor, or an ``int``): the chunk's K/V written at ``[index,
        index + s)``, in place (an indexed copy, so the position is read
        on the device), and chunk query j attending keys ``<= index + j``,
        causal within the chunk and everything before it (JAX
        ``llama.py:401-431``). A prefix continuation or a prefix walk's
        extension chunk. The attention is plain ``_attend`` over the whole
        cache width (int8 K/V through ``_kv_dequantize``), as the JAX
        package runs it; a one-token chunk under ``blocked`` takes the
        decode kernel, as there. The chunk must fit the cache: the JAX
        write clamps a crossing chunk back onto real K/V, so callers keep
        ``index + s <= width``: an ``int`` index is checked here (a
        crossing chunk raises), a device index by the caller, who knows
        it on the host."""
        cfg = self.cfg
        b, s = q.shape[:2]
        idx = _device_index(cache["index"], s, cache_width([cache]),
                            q.device)
        slots = idx + torch.arange(s, device=q.device)
        new_cache = {}
        for name, val in _kv_store(cfg, k, v).items():
            cache[name].index_copy_(1, slots, val)
            new_cache[name] = cache[name]
        new_cache["index"] = cache["index"]
        if cfg.kv_quant == "int8":
            ck, cv = new_cache["k_int8"], new_cache["v_int8"]
            scales = {"k_scale": new_cache["k_scale"],
                      "v_scale": new_cache["v_scale"]}
        else:
            ck, cv, scales = new_cache["k"], new_cache["v"], {}
        if cfg.attn_backend == "blocked" and s == 1:
            active = (idx + 1).to(torch.int32).expand(b).contiguous()
            return blocked_decode_attention(q, ck, cv, active,
                                            **scales), new_cache
        if scales:
            ck = _kv_dequantize(ck, scales["k_scale"], cfg.dtype)
            cv = _kv_dequantize(cv, scales["v_scale"], cfg.dtype)
        t = ck.shape[1]
        keys = torch.arange(t, device=q.device)
        valid = (keys[None, None, :] <= slots[None, :, None]).expand(b, s, t)
        return _attend(q, ck, cv, valid), new_cache

    def forward(self, x, positions, mask, cache, aux=None):
        """cache: None (prefill over all of x), a decode-cache entry for a
        one-token decode step (the ``_kv_store`` leaves and a per-row
        ``[b]`` index), a paged entry (arena leaves, block ``tables`` and
        the index; :meth:`_paged_decode`), or an entry whose index is one
        scalar (an ``int`` or a 0-dim tensor) for a multi-token chunk
        (:meth:`_chunk_attend`). Returns
        ``(y, new_cache_entry)``; a cache is written in place. The
        prefill entry is float K/V; ``prefill_into_cache`` stores it in
        the cache's layout. ``aux``: a list that an MoE block appends its
        load-balance loss to (None: not computed)."""
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
        elif _scalar_index(cache["index"]):
            out, new_cache = self._chunk_attend(q, k, v, cache)
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
            # a verify forward's rows map each one-token row to its cache
            # row (several rows write one cache row, at their positions)
            row_map = cache.get("rows")
            rows = (torch.arange(b, device=x.device) if row_map is None
                    else row_map)
            # the JAX scatter drops out-of-bounds writes; an out-of-bounds
            # index is a device assert here, so such rows rewrite the
            # value already at their clamped slot instead
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
                out = blocked_decode_attention(q, ck, cv, active,
                                               row_map=row_map, **scales)
            else:
                if row_map is not None:
                    ck, cv = ck[row_map], cv[row_map]
                    scales = {name: val[row_map]
                              for name, val in scales.items()}
                if scales:
                    ck = _kv_dequantize(ck, scales["k_scale"], cfg.dtype)
                    cv = _kv_dequantize(cv, scales["v_scale"], cfg.dtype)
                valid = (torch.arange(t, device=x.device)[None, None, :]
                         <= idx[:, None, None])  # [b, 1, t]
                out = _attend(q, ck, cv, valid)

        out = out.reshape(b, s, cfg.heads * d)
        x = x + tp_all_reduce(self.o_proj(out), self.tp)
        h = self.mlp_norm(x)
        if not cfg.moe_experts:
            y = tp_all_reduce(
                self.down_proj(F.silu(self.gate_proj(h)) * self.up_proj(h)),
                self.tp)
        elif aux is None:
            y = self.moe(h)
        else:
            y, loss = self.moe(h, with_aux=True)
            aux.append(loss)
        return x + y, new_cache


class LlamaModel(nn.Module):
    """The decoder. Layers are registered as ``layer_{i}`` and every weight
    keeps its flax name, so ``state_dict`` keys are the flax param paths
    with ``/`` replaced by ``.`` (``layer_0.q_proj.kernel_int8``).

    ``device`` defaults to the CUDA card and raises when there is none.

    A tensor-parallel rank's model (:meth:`set_tp`) holds a
    :class:`ShardConfig`'s share: its embedding rows and lm_head columns
    are its slice of the vocabulary."""

    # the rank's TPGroup (:meth:`set_tp`); None: the whole model
    tp = None

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

    def set_tp(self, group) -> "LlamaModel":
        """Make this model one rank of ``group`` (a ``TPGroup`` whose size
        is its config's ``tp``; its weights are the rank's share). A
        one-rank group runs no collective and serves bitwise as no
        group."""
        tp = getattr(self.cfg, "tp", 1)
        if group is not None and group.size != tp:
            raise ValueError(f"a {group.size}-rank group over a model "
                             f"sharded {tp} ways")
        if group is not None and group.size > 1 and self.cfg.moe_experts:
            raise NotImplementedError(TP_C2.format("an MoE Llama"))
        self.tp = group
        for block in self.blocks():
            block.tp = group
        return self

    def _embed(self, tokens):
        """The embedding; a tensor-parallel rank looks up the tokens of
        its vocabulary slice (zeros for the rest), summed over the ranks,
        where exactly one rank holds each token's row."""
        tp = self.tp
        if tp is None or tp.size == 1:
            return self.embed(tokens)
        if not tp.active():
            raise RuntimeError(
                "a tensor-parallel forward outside the dispatcher would "
                "pair its collectives with nothing: every call into a "
                "sharded model goes through parallel/tpserve.py")
        rows = self.cfg.vocab_size
        local = tokens - tp.rank * rows
        hit = (local >= 0) & (local < rows)
        x = F.embedding(local.clamp(0, rows - 1), self.embed.embedding)
        x = torch.where(hit[..., None], x, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))
        return tp_all_reduce(x, tp)

    def forward(self, tokens, positions=None, mask=None, cache=None,
                logit_positions=None, exit_layer=None, with_aux=False):
        """Returns ``(logits, new_cache)``, and ``(logits, new_cache,
        aux)`` with ``with_aux``: ``aux`` the MoE layers' load-balance
        loss summed (``models/moe.py moe_aux_loss``; 0 for a dense model),
        the value JAX's forward sows.

        prefill: cache=None, tokens ``[b, s]`` -> float cache entries
        sized s. decode: cache = a decode cache (``init_decode_cache``
        layout), tokens ``[b, 1]``.
        logit_positions: optional ``[b]`` — the lm_head runs only at that
        position per row (logits ``[b, 1, v]``).
        exit_layer: optional int — a shallow-exit forward (the speculative
        draft head): the first ``exit_layer`` layers, then ``final_norm``
        and the lm_head over that early hidden state; ``cache`` (when
        given) is read for the layers run, and ``new_cache`` holds one
        entry per layer run."""
        b, s = tokens.shape
        if positions is None:
            positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
        if mask is None:
            mask = torch.ones(b, s, dtype=torch.bool, device=tokens.device)
        layers = self.cfg.layers if exit_layer is None else max(
            1, min(int(exit_layer), self.cfg.layers))
        x = self._embed(tokens)
        new_cache = []
        aux = [] if with_aux else None
        for i, block in enumerate(self.blocks()[:layers]):
            x, c = block(x, positions, mask,
                         None if cache is None else cache[i], aux)
            new_cache.append(c)
        x = self.final_norm(x)
        if logit_positions is not None:
            x = x[torch.arange(b, device=x.device), logit_positions.long()]
            x = x[:, None, :]
        logits = tp_all_gather(self.lm_head(x), self.tp)
        if with_aux:
            return logits, new_cache, moe_aux_loss(aux).to(x.device)
        return logits, new_cache


def _quantize(w, axis: int) -> tuple:
    """JAX's int8 rule in f32: ``scale = max(max|w| / 127, 1e-8)`` over
    ``axis`` (kept), ``round(w / scale)`` half to even."""
    if not torch.is_tensor(w):  # numpy, ml_dtypes' bf16 too (exact in f32)
        w = torch.from_numpy(np.asarray(w).astype(np.float32))
    w = w.to(torch.float32)

    def const(v):
        # a tensor on w's device: PyTorch's CUDA division by a Python
        # scalar multiplies by its reciprocal, which is not IEEE division
        return torch.tensor(v, dtype=torch.float32, device=w.device)

    scale = torch.maximum(w.abs().amax(axis, keepdim=True) / const(127.0),
                          const(1e-8))
    return torch.round(w / scale).to(torch.int8), scale


def quantize_params(float_params):
    """A float Llama params tree in the JAX layout (``{"params": ...}`` or
    the inner dict; numpy or torch leaves) in the int8 layout, the twin of
    JAX's ``quantize_params`` (``llama.py:840-876``): each 2-D ``kernel``
    becomes ``kernel_int8`` and a per-output-channel f32 ``scale`` ``[1,
    out]``, each 3-D MoE expert stack ``<name>_int8`` and a per-(expert,
    channel) ``<name>_scale`` ``[e, 1, out]``; embeddings, norms and the
    router stay as they are. Bitwise JAX's on the same weights (f32 math,
    rounding half to even). New leaves are torch tensors on the weight's
    device; ``models/params.py from_jax_params`` takes the tree."""

    def convert(tree):
        if not isinstance(tree, dict):
            return tree
        if "kernel" in tree and getattr(tree["kernel"], "ndim", 0) == 2:
            out = dict(tree)
            out["kernel_int8"], out["scale"] = _quantize(out.pop("kernel"),
                                                         0)
            return out
        if any(getattr(tree.get(k), "ndim", 0) == 3 for k in EXPERT_KEYS):
            out = dict(tree)
            for k in EXPERT_KEYS:
                if getattr(out.get(k), "ndim", 0) == 3:  # [e, in, out]
                    out[f"{k}_int8"], out[f"{k}_scale"] = _quantize(
                        out.pop(k), 1)
            return {k: convert(v) for k, v in out.items()}
        return {k: convert(v) for k, v in tree.items()}

    return convert(float_params)


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


def write_prefill(cfg: LlamaConfig, cache, prefill_cache) -> None:
    """Store a prefill cache (float entries sized s) at position 0 of a
    decode cache, in place, quantizing under ``cfg.kv_quant``; every
    position past s takes the empty cache's value again, so the cache
    holds what a fresh one filled with the prefill would."""
    for dest, entry in zip(cache, prefill_cache):
        s = entry["k"].shape[1]
        for name, val in _kv_store(cfg, entry["k"], entry["v"]).items():
            dest[name][:, :s] = val
            dest[name][:, s:] = 1e-8 if name.endswith("_scale") else 0


def prefill_into_cache(cfg: LlamaConfig, prefill_cache, batch: int,
                       max_len: int, prompt_len: int):
    """Embed a prefill cache (float entries sized s) at position 0 of a
    static ``max_len`` decode cache, quantizing under ``cfg.kv_quant``."""
    device = prefill_cache[0]["k"].device
    out = init_decode_cache(cfg, batch, max_len, device)
    write_prefill(cfg, out, prefill_cache)
    for dest in out:
        dest["index"].fill_(prompt_len)
    return out


def _leaves(entry: dict) -> dict:
    """A cache entry's K/V leaves (its tensors in the store layout),
    without the index and the paged step's entries."""
    return {name: val for name, val in entry.items()
            if name not in STEP_KEYS}


def slice_cache_blocks(cache, start: int, width: int):
    """Store-layout ``[start, start + width)`` sequence slices of a decode
    cache, one dict per layer (``index`` dropped): the block unit the
    radix prefix store (``runtime/prefixstore.py``) keeps. Slices are
    fresh buffers, so they stay valid whatever later writes the source
    cache takes, and they hold only their own bytes."""
    return [{name: val[:, start:start + width].clone()
             for name, val in _leaves(entry).items()}
            for entry in cache]


def concat_cache_blocks(cfg: LlamaConfig, blocks, cache_len: int):
    """Assemble per-layer block slices (as :func:`slice_cache_blocks`
    returns, one list entry per block, in sequence order) back into a
    one-row ``cache_len`` decode cache with ``index`` = the assembled
    width (an ``int``): the inverse of slicing at block boundaries. K/V
    is position-dependent (RoPE comes before the cache store), so blocks
    go back to the positions they were sliced from; a radix path does
    that by construction. Positions past the blocks hold the empty
    cache's values. Under an ambient tensor-parallel mesh
    (``parallel/mesh.py use_mesh``) the blocks are this rank's kv heads,
    and so is the assembled cache: the whole cache is never built."""
    first = next(iter(blocks[0][0].values()))
    cfg = _ambient_share(cfg)
    out = []
    for i in range(cfg.layers):
        dest = _empty_cache_entry(cfg, 1, cache_len, first.device)
        pos = 0
        for blk in blocks:
            width = next(iter(blk[i].values())).shape[1]
            for name, val in blk[i].items():
                dest[name][:, pos:pos + width] = val
            pos += width
        dest["index"] = pos
        out.append(dest)
    return out


def copy_cache(cache):
    """Fresh-buffer copy of a decode cache (tensors cloned, an ``int``
    index kept): what a continuation or an extension walk writes in
    place while the original stays shared in a prefix store."""
    return [{name: val.clone() if torch.is_tensor(val) else val
             for name, val in entry.items()}
            for entry in cache]


def cache_nbytes(cache) -> int:
    """Device bytes of a cache's K/V leaves."""
    return sum(val.numel() * val.element_size() for entry in cache
               for val in _leaves(entry).values())


def _mesh_tp(mesh) -> int:
    return int(dict(getattr(mesh, "shape", mesh) or {}).get("tp", 1))


def _ambient_share(cfg: LlamaConfig) -> LlamaConfig:
    """``cfg``'s rank share under the ambient mesh's ``tp`` (``cfg`` as it
    is without one, or when it is a share already)."""
    from lambdipy_tpu_torch.parallel.mesh import current_mesh

    mesh = current_mesh()
    return shard_config(cfg, _mesh_tp(mesh)) if mesh is not None else cfg


# a KV leaf's dims: [rows or pages, positions, kv heads, head_dim or 1];
# the kv heads split over tp, JAX's _kv_leaf_sharding
_KV_LEAVES = ("k", "v", "k_int8", "v_int8", "k_scale", "v_scale")


def kv_shardings(mesh) -> dict:
    """``{leaf name: NamedSharding}`` of a decode cache's or an arena's
    K/V leaves over ``mesh`` (``parallel/sharding.py``: the kv-head dim
    over ``tp``, the ``index`` replicated), keyed as ``device_bytes``
    reads a cache's leaves; JAX's ``_kv_leaf_sharding``."""
    from lambdipy_tpu_torch.parallel.sharding import P, named_sharding

    return {name: named_sharding(mesh, *P(None, None, "tp", None))
            for name in _KV_LEAVES}


def shard_kv_cache(cache, mesh, rank: int | None = None):
    """One rank's share of a whole decode cache (JAX ``shard_kv_cache``,
    which places it over the mesh): the K/V leaves' kv heads of ``rank``
    (default this process's), ``index`` leaves whole. A mesh without
    ``tp`` gives the cache itself."""
    shardings = kv_shardings(mesh)
    return [{name: (shardings[name].shard(val, rank)
                    if name in shardings else val)
             for name, val in entry.items()}
            for entry in cache]


def shard_page_arena(arena, mesh, rank: int | None = None):
    """One rank's share of a whole page arena (JAX ``shard_page_arena``):
    :func:`shard_kv_cache`'s rule on the ``[n_pages, page, kv_heads, *]``
    leaves."""
    return shard_kv_cache(arena, mesh, rank)


NULL_PAGE = 0  # the arena's reserved page (runtime/pagepool.py)


def init_page_arena(cfg: LlamaConfig, n_pages: int, page: int, device,
                    mesh=None):
    """The paged KV arena: per layer, the decode cache's store-layout
    leaves page-major, ``[n_pages, page, kv_heads, head_dim]`` (int8
    scales ``[..., 1]`` starting at 1e-8), with no ``index`` leaf: row
    positions live in the block tables. Page 0 is the null page. With a
    ``mesh`` whose ``tp`` is above 1 the arena is born one rank's share,
    its kv heads over ``tp`` (JAX places it kv-head-sharded); a rank's
    :class:`ShardConfig` sizes its share already."""
    device = resolve_device(device)
    if mesh is not None:
        cfg = shard_config(cfg, _mesh_tp(mesh))
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


# the non-leaf entries of a paged cache entry (:class:`DecodeStep`)
PAGED_STEP_KEYS = ("tables", "index", "write_page", "write_off", "active")
# and of any decode cache entry: a verify forward's cache-row map too
STEP_KEYS = PAGED_STEP_KEYS + ("rows",)


def _page_of(entry: dict) -> int:
    """The page width of a paged cache entry's arena leaves."""
    return entry["k_int8" if "k_int8" in entry else "k"].shape[1]


def page_address(tables, pos, page: int) -> dict:
    """Paged write addresses of one-token rows at positions ``pos [n]``
    through ``tables [n, nb]``: page ``tables[r, pos // page]`` at offset
    ``pos % page``, or the null page for a position past the table (the
    JAX scatter drops such a write; nothing reads the null page
    unmasked), and the attention length ``pos + 1``."""
    nb = tables.shape[1]
    blk = torch.div(pos, page, rounding_mode="floor").long()
    pid = tables.gather(1, blk.clamp(max=nb - 1)[:, None])[:, 0]
    return {"write_page": torch.where(blk < nb, pid.long(), NULL_PAGE),
            "write_off": torch.remainder(pos, page).long(),
            "active": (pos + 1).to(torch.int32)}


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
    kvh, d]``, quantized here under ``cfg.kv_quant``; or a cache already
    in the store layout, as a chunked prefill leaves it) in the arena
    through ``table_row`` ``[nb]`` (the row's pages, null-padded). Only
    the first ``len(table_row) * page`` positions are stored, as the
    dense engine cuts a prefill to its ``cache_len``: the prompt's bucket
    may be wider than the engine's window, and positions past it lie
    beyond ``s + max_new`` of any admitted row. What is kept is
    zero-padded to whole pages; positions past the row's pages land in
    the null page."""
    page = arena[0][next(iter(arena[0]))].shape[1]
    sb = min(cache_width(prefill_cache), table_row.shape[0] * page)
    width = -(-sb // page) * page
    cache = []
    for entry in prefill_cache:
        rows = {name: val[src:src + 1, :sb]
                for name, val in _leaves(entry).items()}
        if width != sb:
            rows = {name: F.pad(val, (0, 0, 0, 0, 0, width - sb))
                    for name, val in rows.items()}
        if "k" in rows:  # float K/V: into the store layout
            rows = _kv_store(cfg, rows["k"], rows["v"])
        cache.append(rows)
    _scatter_page_cache(arena, table_row[None, :width // page], cache, page)


def to_host(tensors: list) -> list:
    """Host copies of device tensors, ordered after every write already
    enqueued for them: the copies run on the current stream (the serving
    stream, on which the engine's graphs replay) into pinned memory, and
    the host waits on a CUDA event recorded after them, as the engine's
    device wait does. A plain ``.cpu()`` is not used: the copies of many
    tensors share one wait. The caller holds ``DEVICE_LOCK`` (no capture
    may run beside the copies). CPU tensors come back cloned."""
    out, event = [], None
    for t in tensors:
        if t.is_cuda:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            out.append(host.copy_(t, non_blocking=True))
            event = event or torch.cuda.Event()
        else:
            out.append(t.clone())
    if event is not None:
        event.record()
        event.synchronize()
    return out


def blocks_to_host(blocks) -> list:
    """Block slices (a list over blocks of per-layer leaf dicts, as
    :func:`slice_cache_blocks` returns) as host tensors, in one ordered
    read (:func:`to_host`)."""
    keys = [(b, i, name) for b, blk in enumerate(blocks)
            for i, entry in enumerate(blk) for name in entry]
    host = to_host([blocks[b][i][name] for b, i, name in keys])
    out = [[{} for _ in blk] for blk in blocks]
    for (b, i, name), t in zip(keys, host):
        out[b][i][name] = t
    return out


def arena_page_slices(arena, pids) -> list:
    """Host reads of arena pages, one block per page id, each a per-layer
    list of ``{leaf: [1, page, kv_heads, d-or-1]}`` tensors, the block
    shape of :func:`slice_cache_blocks`: the export and spill read of a
    paged prefix store (``runtime/kvwire.py`` framing), the JAX
    function's one-page read batched, one gather per leaf and one
    ordered read for all pages (:func:`to_host`). The caller holds a pool
    ref on every page (a released page could be reused mid-read) and
    ``DEVICE_LOCK``."""
    pids = [int(p) for p in pids]
    if not pids:
        return []
    dev = next(iter(arena[0].values())).device
    idx = torch.as_tensor(pids, dtype=torch.long, device=dev)
    names = [list(entry) for entry in arena]
    host = to_host([entry[name].index_select(0, idx)
                    for entry, ns in zip(arena, names) for name in ns])
    it = iter(host)
    layers = [{name: next(it) for name in ns} for ns in names]
    return [[{name: val[j:j + 1] for name, val in layer.items()}
             for layer in layers] for j in range(len(pids))]


def write_arena_pages(arena, pids, blocks) -> None:
    """Write block slices (host or device tensors shaped as
    :func:`arena_page_slices` returns them) into arena pages ``pids``, in
    place, one indexed write per leaf: an import's or a re-online's page
    write. The caller holds ``DEVICE_LOCK`` and the pool's arena lock."""
    if not pids:
        return
    dev = next(iter(arena[0].values())).device
    idx = torch.as_tensor([int(p) for p in pids], dtype=torch.long,
                          device=dev)
    for i, entry in enumerate(arena):
        for name, val in entry.items():
            src = torch.cat([blk[i][name] for blk in blocks])
            val[idx] = src.to(device=dev, dtype=val.dtype)


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


# -- the sampled selection's randomness: counter-based noise ----------------
#
# A sampled row draws from a stream of its own: a 64-bit key (from the
# row's ``(seed, row)`` pair alone, so its draws never depend on what
# shares its batch) and a draw index, the selections made so far. The
# noise of one draw is a hash of (key, draw index, vocab index), computed
# with integer ops on the device, so it is a function of those three
# alone: a graph replays it with no generator state, and a verify
# chunk's position i draws what the one-token step would at index
# ``draw + i``, its rejected tail rolled back by advancing the index by
# the accepted count inside the program.

_M32 = 0xFFFFFFFF


def _fmix32(x):
    """The murmur3 finalizer on int64 tensors holding 32-bit values:
    every input bit moves every output bit (products keep their low 32
    bits; an int64 product past 2**63 wraps, and the mask drops it)."""
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _M32
    return x ^ (x >> 16)


def stream_bits(keys, draw):
    """32 random bits per (row, draw): ``keys [..., 2]`` int64 (the key's
    two 32-bit halves), ``draw [...]`` int64."""
    return _fmix32(keys[..., 0] ^ _fmix32(keys[..., 1]
                                          ^ _fmix32(draw & _M32)))


def _to_uniform(bits):
    """Bits in ``[0, 2**32)`` -> f32 uniforms in (0, 1), exact."""
    return ((bits >> 8).float() + 0.5) * 2.0 ** -24


def stream_uniform(keys, draw, v: int | None = None):
    """Uniforms of a draw: one per (row, draw) (``v`` None), or one per
    vocab entry ``[..., v]``, a hash of (key, draw, vocab index)."""
    bits = stream_bits(keys, draw)
    if v is None:
        return _to_uniform(_fmix32(bits ^ 0x5BD1E995))
    col = _fmix32((torch.arange(v, device=keys.device) * 0x9E3779B9
                   + 0x7F4A7C15) & _M32)
    return _to_uniform(_fmix32(bits[..., None] ^ col))


def gumbel_noise(keys, draw, v: int):
    """Gumbel noise ``[..., v]`` of one draw per row."""
    return -torch.log(-torch.log(stream_uniform(keys, draw, v)))


def row_key(seed: int, row: int) -> tuple[int, int]:
    """A row's 64-bit key, as two 32-bit halves, from ``(seed, row)``."""
    state = np.random.SeedSequence([seed % 2 ** 64, row]).generate_state(
        2, np.uint32)
    return int(state[0]), int(state[1])


class RowStream:
    """A row's sampling stream on the host: its key and the draws made.
    A program that selects for the row copies both in and moves ``draw``
    on by the selections it made; the decode step carries them on the
    device from there."""

    __slots__ = ("key", "draw")

    def __init__(self, key: tuple[int, int], draw: int = 0):
        self.key, self.draw = key, int(draw)


def row_streams(seeds) -> list[RowStream]:
    """One :class:`RowStream` per row, keyed from ``(seed, row)`` pairs
    alone (``seeds`` is a list of such pairs), so a row's draws never
    depend on what shares its batch."""
    return [RowStream(row_key(seed, row)) for seed, row in seeds]


def streams_host(streams, rows: int) -> tuple:
    """``(keys [rows, 2] int64, draw [rows] int64)`` host arrays of
    ``streams`` (rows past them: key 0, draw 0)."""
    keys = np.zeros((rows, 2), np.int64)
    draw = np.zeros((rows,), np.int64)
    for r, st in enumerate(streams[:rows]):
        keys[r] = st.key
        draw[r] = st.draw
    return keys, draw


def select_tokens(lg, temperature, top_k, top_p, streams, sampled: bool):
    """Token selection over per-row knob tensors ``[b]`` (temperature <= 0
    = greedy; top_k, top_p as :func:`filter_logits_runtime`):
    ``(token [b], raw logprob [b])`` from f32 logits ``lg [b, v]``.
    ``streams`` is ``(keys [b, 2], draw [b])``, device tensors: a sampled
    row draws Gumbel-max noise of its draw index (the caller moves the
    index on). Not ``sampled`` (an all-greedy batch) skips the sampling
    path, its two sorts and the noise, entirely, as the JAX ``lax.cond``
    does. Reads no host data, so a CUDA graph can capture it."""
    lg = lg.float()
    greedy = lg.argmax(dim=-1)
    if not sampled:
        return greedy, _token_logprob(lg, greedy)
    t = temperature.clamp(min=1e-6)[:, None]
    filt = filter_logits_runtime(lg / t, top_k, top_p)
    keys, draw = streams
    draw_tok = (filt + gumbel_noise(keys, draw, lg.shape[-1])).argmax(dim=-1)
    tok = torch.where(temperature > 0, draw_tok, greedy)
    return tok, _token_logprob(lg, tok)


def to_device(buf, value) -> None:
    """``value`` (a tensor, or host data) into the device buffer ``buf``.
    Host data goes through pinned memory on the card, ``non_blocking``: a
    pageable copy would wait for the work already enqueued."""
    if torch.is_tensor(value):
        buf.copy_(value)
        return
    src = torch.as_tensor(np.asarray(value)).to(buf.dtype).contiguous()
    if buf.is_cuda:
        buf.copy_(src.pin_memory(), non_blocking=True)
    else:
        buf.copy_(src)


def _mode(sampled: bool) -> str:
    return "sampled" if sampled else "greedy"


class DecodeStep:
    """One decode step of ``rows`` rows on buffers at fixed addresses: the
    unit a CUDA graph captures (``models/graphs.py``). It owns

    - the carry: ``tok [b]``, ``lp [b]``, ``pos [b]`` int32, ``done [b]``
      and ``eos [b]`` (``< 0`` = none);
    - the knobs ``temperature``, ``top_k``, ``top_p`` ``[b]``, set from
      a request's values before a step (:meth:`set_knobs`), and each
      row's sampling stream, ``keys [b, 2]`` and ``draw [b]`` (the draws
      made; :meth:`set_stream`), carried on the device like the token;
    - the decode cache: ``cache``'s leaves (a contiguous cache, or the
      page arena with ``tables [b, nb]``), each layer's entry pointing at
      ``pos`` and, paged, at this step's write address.

    :meth:`step` runs one forward and the selection and writes the next
    carry in place. Host data never enters it, so the same step runs
    eagerly (the CPU) or as a replay (the card).

    ``base``: the long-context tier's step (``runtime/longctx.py``) also
    owns ``base [b]`` int32, the logical position of the view's slot 0:
    cache writes and the valid length follow the local ``pos``, RoPE sees
    ``pos + base`` (JAX ``_scan_decode``'s ``pos_offset``). Every other
    step has none, so its graphs keep their launches and bits."""

    def __init__(self, model: LlamaModel, cache, rows: int, tables=None,
                 base: bool = False):
        dev = model.device
        self.model, self.rows, self.tables = model, rows, tables
        self.window = None  # a narrowed view's width (:meth:`narrowed`)
        self.base = (torch.zeros(rows, dtype=torch.int32, device=dev)
                     if base else None)

        def zeros(dtype):
            return torch.zeros(rows, dtype=dtype, device=dev)

        self.tok, self.lp = zeros(torch.long), zeros(torch.float32)
        self.pos, self.done = zeros(torch.int32), zeros(torch.bool)
        self.eos = torch.full((rows,), -1, dtype=torch.long, device=dev)
        self.temperature, self.top_k = zeros(torch.float32), zeros(torch.long)
        self.top_p = torch.ones(rows, dtype=torch.float32, device=dev)
        self.keys = torch.zeros(rows, 2, dtype=torch.long, device=dev)
        self.draw = zeros(torch.long)
        step_keys = {"index": self.pos}
        if tables is not None:
            step_keys.update(tables=tables, write_page=zeros(torch.long),
                             write_off=zeros(torch.long),
                             active=zeros(torch.int32))
        self.cache = [{**{k: v for k, v in entry.items()
                          if k not in PAGED_STEP_KEYS}, **step_keys}
                      for entry in cache]

    def knobs(self) -> tuple:
        """The knob buffers ``(temperature, top_k, top_p)``."""
        return self.temperature, self.top_k, self.top_p

    def set_knobs(self, temperature, top_k, top_p) -> None:
        """Per-row knobs (host arrays or tensors) into their buffers."""
        for buf, val in zip(self.knobs(), (temperature, top_k, top_p)):
            to_device(buf, val)

    def streams(self) -> tuple:
        """The stream buffers ``(keys, draw)``."""
        return self.keys, self.draw

    def set_stream(self, row: int, stream: RowStream) -> None:
        """Row ``row`` draws on from where ``stream`` stands."""
        keys, draw = streams_host([stream], 1)
        to_device(self.keys[row], keys[0])
        to_device(self.draw[row:row + 1], draw)

    def load(self, first, lp0, pos, eos, streams) -> None:
        """A prefill's carry: the first token and its logprob, the
        positions, eos per row (a tensor or host data; a row whose first
        token is eos starts latched) and the rows' streams."""
        self.tok.copy_(first)
        self.lp.copy_(lp0)
        self.pos.copy_(pos)
        to_device(self.eos, eos)
        self.done.copy_((self.eos >= 0) & (first == self.eos))
        keys, draw = streams_host(streams, self.rows)
        to_device(self.keys, keys)
        to_device(self.draw, draw)

    def _write_address(self) -> None:
        """Paged: this step's write address for every layer, in place: page
        ``tables[r, pos // page]`` at offset ``pos % page``, or the null
        page for a position past the table (the JAX scatter drops such a
        write; nothing reads the null page unmasked), and the attention
        length ``pos + 1``."""
        first = self.cache[0]
        addr = page_address(self.tables, self.pos, _page_of(first))
        for name, val in addr.items():
            first[name].copy_(val)

    def step(self, sampled: bool) -> None:
        """One forward of every row at ``pos`` (writing its K/V into the
        cache), the next token selected, rows latched at their eos (after
        eos a row emits eos with logprob 0), the carry advanced in
        place."""
        if self.tables is not None:
            self._write_address()
        positions = self.pos if self.base is None else self.pos + self.base
        logits, _ = self.model(self.tok[:, None],
                               positions=positions[:, None], cache=self.cache)
        nxt, nlp = select_tokens(logits[:, -1, :], self.temperature,
                                 self.top_k, self.top_p, self.streams(),
                                 sampled)
        nxt = torch.where(self.done, self.eos, nxt)
        nlp = torch.where(self.done, 0.0, nlp)
        self.done |= (self.eos >= 0) & (nxt == self.eos)
        self.tok.copy_(nxt)
        self.lp.copy_(nlp)
        self.pos += 1
        self.draw += 1

    def narrowed(self, window: int) -> "DecodeStep":
        """This step over the first ``window`` positions of its cache, the
        window-bucketed step of the plain attention, whose ``_attend``
        reads the whole width it is given (JAX ``_windowed_seg_fn``,
        ``llama.py:2223``). It shares the carry, knobs and streams (the
        same tensors). Dense: the cache's leaves viewed at ``[:, :window]``,
        so its K/V writes land in the full cache; a write at or past
        ``window`` is dropped, as one past the full width is. Paged: a
        block table of ``window // page`` entries and a write address of
        its own (the caller fills the table), over the same arena. The
        kernel backend never takes a view: its kernel reads a row only up
        to ``active_len`` and refuses strided operands."""
        view = copy.copy(self)
        view.window = window
        if self.tables is None:
            view.cache = [{name: val if name == "index" else val[:, :window]
                           for name, val in entry.items()}
                          for entry in self.cache]
            return view
        dev = self.model.device
        page = _page_of(self.cache[0])
        view.tables = torch.zeros((self.rows, window // page),
                                  dtype=torch.int32, device=dev)
        keys = {"index": self.pos, "tables": view.tables,
                **{name: torch.zeros(self.rows, dtype=dtype, device=dev)
                   for name, dtype in (("write_page", torch.long),
                                       ("write_off", torch.long),
                                       ("active", torch.int32))}}
        view.cache = [{**{k: v for k, v in entry.items()
                          if k not in PAGED_STEP_KEYS}, **keys}
                      for entry in self.cache]
        return view

    def nbytes(self) -> int:
        """Device bytes of the step's own decode cache (0 for the page
        arena, which the pool owns, and for a :meth:`narrowed` view)."""
        if self.tables is not None or self.window is not None:
            return 0
        return sum(v.numel() * v.element_size() for entry in self.cache
                   for k, v in entry.items() if k != "index")


class VerifyStep:
    """A speculative verify segment on a :class:`DecodeStep`'s buffers (its
    carry, knobs, streams and cache), the unit a CUDA graph captures per
    ``kb`` (JAX ``_spec_seg_fn`` / ``_spec_pseg_fn``, ``llama.py:2265,
    2426``; with ``exit_layer`` the model-draft twins ``_mspec_*``). It
    owns the drafts ``[b, kb - 1]`` (raw; ``-1`` pads are never accepted)
    and, with ``exit_layer``, the per-row ``use_model`` mask.

    One verify scores each row's pending token and its ``kb - 1`` drafts
    as ``b * kb`` ONE-TOKEN rows: row ``(r, j)`` at position ``pos[r] +
    j``. Every int8 projection then takes the GEMV (one position per
    row), attention runs the decode kernel over the row's own cache row
    (a row map) or its repeated block table, with ``active_len = pos + j
    + 1``, and every layer writes all ``b * kb`` positions' K/V before it
    reads any. So each accepted position is bitwise the one-token step
    the spec-off engine runs there. The chain verify
    (``models/spec.py chain_verify``) selects at every position with draw
    index ``draw + j`` and advances the carry (token, logprob, position,
    draw index) by the accepted ``count`` in place; a rejected tail's
    K/V lies past the new position, rewritten before anything reads it.
    The verify does not latch eos (the host cuts a row at its eos).

    :meth:`run` returns ``(tokens [b, kb], lps [b, kb], count [b], pending
    [b])``: the first ``count`` columns are the emitted tokens and their
    logprobs. :meth:`run_resample` is the solo sampled path's rejection
    sampling (``models/spec.py accept_resample``) on a stream of its own
    (``keys``, ``draw``, advanced by ``kb`` a step): target-distributed,
    deterministic per seed, not the plain sampled stream."""

    def __init__(self, step: DecodeStep, kb: int,
                 exit_layer: int | None = None):
        dev = step.model.device
        b = step.rows
        self.step, self.kb, self.exit_layer = step, kb, exit_layer
        self.draft = torch.full((b, kb - 1), -1, dtype=torch.long,
                                device=dev)
        self.use_model = (torch.zeros(b, kb - 1, dtype=torch.bool,
                                      device=dev) if exit_layer else None)
        self.offsets = torch.arange(kb, dtype=torch.int32, device=dev)
        self.keys = torch.zeros(b, 2, dtype=torch.long, device=dev)
        self.draw = torch.zeros(b, dtype=torch.long, device=dev)

    def set_drafts(self, draft, use_model=None) -> None:
        """The drafts (host data ``[b, kb - 1]``, raw) and, for the model
        tier, which positions take the in-program draft instead."""
        to_device(self.draft, draft)
        if self.use_model is not None:
            to_device(self.use_model,
                      np.zeros(self.draft.shape, bool) if use_model is None
                      else use_model)

    def _cache(self, positions, tables, layers: int | None = None):
        """The step's cache entries for one-token rows at ``positions
        [n]``: over the contiguous cache with the rows' cache-row map (n
        a multiple of the step's rows, each row's ``n / b`` rows in
        turn), or over the arena through ``tables [n, nb]`` with each
        row's write address."""
        step = self.step
        entries = step.cache[:layers]
        if step.tables is None:
            n = positions.shape[0]
            keys = {"index": positions}
            if n != step.rows:
                keys["rows"] = torch.arange(
                    step.rows, dtype=torch.int32,
                    device=positions.device).repeat_interleave(n // step.rows)
        else:
            keys = {"tables": tables, "index": positions,
                    **page_address(tables, positions,
                                   _page_of(step.cache[0]))}
        return [{**_leaves(e), **keys} for e in entries]

    def _shallow_draft(self):
        """The model tier's draft chain (JAX ``_shallow_draft``,
        ``llama.py:1317``): ``kb - 1`` one-token greedy forwards of the
        first ``exit_layer`` layers off the carry token, each feeding the
        next. Their K/V go into the real cache at ``pos .. pos + kb - 2``
        of those layers (the JAX chain writes throwaway arrays): the
        verify rewrites every one of those positions before any query
        reads it, and a write past a row's pages lands in the null page."""
        step = self.step
        cur, drafts = step.tok, []
        for j in range(self.kb - 1):
            pos = step.pos + j
            lg, _ = step.model(cur[:, None], positions=pos[:, None],
                               cache=self._cache(pos, step.tables,
                                                 self.exit_layer),
                               exit_layer=self.exit_layer)
            cur = lg[:, -1, :].float().argmax(dim=-1)
            drafts.append(cur)
        return torch.stack(drafts, dim=1)

    def _forward(self):
        """The drafts (the model tier's where ``use_model``), the chunk
        ``[b, kb]`` (pending token, drafts clamped into the vocab for the
        embedding) and its ``[b * kb, v]`` f32 logits, one row a
        position."""
        step, kb = self.step, self.kb
        draft = self.draft
        if self.exit_layer:
            draft = torch.where(self.use_model, self._shallow_draft(), draft)
        vocab = step.model.cfg.vocab_size
        chunk = torch.cat([step.tok[:, None], draft.clamp(0, vocab - 1)],
                          dim=1)
        positions = (step.pos[:, None] + self.offsets).reshape(-1)
        tables = (None if step.tables is None
                  else step.tables.repeat_interleave(kb, dim=0))
        logits, _ = step.model(chunk.reshape(-1, 1),
                               positions=positions[:, None],
                               cache=self._cache(positions, tables))
        return draft, chunk, logits[:, -1, :].float()

    def _advance(self, count, tok2, lp2, draw_by) -> None:
        step = self.step
        step.tok.copy_(tok2)
        step.lp.copy_(lp2)
        step.pos += count.to(torch.int32)
        step.draw += draw_by

    def _rows(self, x):
        return x.repeat_interleave(self.kb, dim=0)

    def run(self, sampled: bool):
        """One chain verify (the engine's, and the solo greedy path's)."""
        step, kb = self.step, self.kb
        b = step.rows
        draft, chunk, lg = self._forward()
        draws = (step.draw[:, None] + self.offsets).reshape(-1)
        tgt, tlp = select_tokens(
            lg, *map(self._rows, step.knobs()),
            (self._rows(step.keys), draws), sampled)
        lps, count, tok2, lp2 = chain_verify(tgt.view(b, kb),
                                             tlp.view(b, kb), draft, step.lp)
        self._advance(count, tok2, lp2, count)
        return chunk, lps, count, tok2

    def run_resample(self):
        """One rejection-sampling verify (the solo sampled path)."""
        step, kb = self.step, self.kb
        b = step.rows
        draft, chunk, lg = self._forward()
        vocab = lg.shape[-1]
        temperature, top_k, top_p = map(self._rows, step.knobs())
        filt = filter_logits_runtime(
            lg / temperature.clamp(min=1e-6)[:, None], top_k, top_p)
        probs = torch.softmax(filt, dim=-1).view(b, kb, vocab)
        draws = self.draw[:, None] + self.offsets
        u = stream_uniform(self.keys[:, None, :].expand(b, kb - 1, 2),
                           draws[:, :kb - 1])
        noise = gumbel_noise(self.keys, draws[:, kb - 1], vocab)
        proposal = draft.clamp(0, vocab - 1)
        m, tok2 = accept_resample(probs, proposal, u, noise)
        lsm = F.log_softmax(lg, dim=-1).view(b, kb, vocab)
        lp_draft = lsm[:, :kb - 1].gather(2, proposal[:, :, None])[:, :, 0]
        lp2 = lsm.gather(1, m[:, None, None].expand(b, 1, vocab))[:, 0] \
            .gather(1, tok2[:, None])[:, 0]
        lps = torch.cat([step.lp[:, None], lp_draft], dim=1)
        count = m + 1
        self.draw += kb
        self._advance(count, tok2, lp2, 0)
        return chunk, lps, count, tok2


class VerifyProgram(GraphProgram):
    """A :class:`VerifyStep` run as a :class:`GraphProgram`: the chain
    verify (greedy or ``sampled``) or, with ``resample``, the solo
    sampled path's rejection sampling. Its runs count as decode steps
    (``replays`` / ``eager_steps``); a capture's int8 GEMV counters cover
    its ``rows * kb`` one-token rows."""

    def __init__(self, vstep: VerifyStep, sampled: bool, resample: bool,
                 graph_type, stats: GraphStats):
        body = vstep.run_resample if resample else (
            lambda: vstep.run(sampled))
        super().__init__(body, vstep.step.model,
                         vstep.step.rows * vstep.kb, graph_type, stats)
        self.vstep = vstep


def verify_program(entry: StepPrograms, kb: int, sampled: bool, *,
                   exit_layer: int | None = None,
                   resample: bool = False,
                   step: DecodeStep | None = None) -> VerifyProgram:
    """The verify program of ``entry``'s decode step (or of ``step``, a
    :meth:`DecodeStep.narrowed` view of it), made on first use and kept
    in the entry, keyed by ``kb``, greedy or sampled, the draft's exit
    layer (0: host drafts), chain or rejection sampling and the view's
    window."""
    step = step or entry.step
    key = ("verify", kb, _mode(sampled), exit_layer or 0,
           "resample" if resample else "chain")
    if step.window is not None:
        key += (step.window,)
    return entry.program(key, lambda: VerifyProgram(
        VerifyStep(step, kb, exit_layer), sampled, resample,
        entry.graph_type, entry.stats))


def _chunk_forward(model: LlamaModel, cache, chunk, last, pos_offset=None):
    """A chunk ``[b, w]`` at the scalar index of ``cache``'s entries (a
    0-dim device tensor, or an ``int``), its K/V written there in place,
    the lm_head at ``last [b]``, each row's position in the chunk.
    ``pos_offset`` (a 0-dim device tensor) moves RoPE's positions to
    ``index + pos_offset + j`` while the writes stay at ``index + j`` (the
    long-context view). Returns the logits ``[b, 1, v]`` and the index as
    a device tensor."""
    b, w = chunk.shape
    dev = chunk.device
    idx = _device_index(cache[0]["index"], w, cache_width(cache), dev)
    rope0 = idx if pos_offset is None else idx + pos_offset
    positions = (rope0 + torch.arange(w, device=dev))[None, :].expand(b, w)
    logits, _ = model(chunk, positions=positions,
                      cache=[{**_leaves(e), "index": idx} for e in cache],
                      logit_positions=last)
    return logits, idx


def _continue_prefill(model: LlamaModel, cache, suffix, suffix_len,
                      select, gens, eos, sbs: int, pos_offset=None):
    """Continuation prefill from a cached prefix K/V: the padded suffix
    ``[b, sbs]`` embedded at the positions after the cache's scalar index
    (a 0-dim device tensor or an ``int``; written in place into
    ``cache``), the first token selected at the suffix's last real
    position (``suffix_len``: an ``int``, or a per-row ``[b]`` tensor).
    Returns the decode carry ``(first, lp0, cache, pos, done)`` with
    per-row ``[b]`` index and position, the shapes a prefill gives. The
    one source of the prefix continuation math: the solo, streaming and
    engine prefix paths, a chunked row's tail and the long-context view's
    last chunk (``pos_offset``, :func:`_chunk_forward`) all run it,
    eagerly or captured (:class:`PrefillProgram`) (JAX
    ``llama.py:1141``)."""
    b = suffix.shape[0]
    if isinstance(suffix_len, int):
        suffix_len = torch.full((b,), suffix_len, dtype=torch.long,
                                device=suffix.device)
    logits, idx = _chunk_forward(model, cache, suffix[:, :sbs],
                                 suffix_len - 1, pos_offset)
    start = (idx + suffix_len).to(torch.int32)
    new_cache = [{**_leaves(e), "index": start} for e in cache]
    first, lp0 = select(logits[:, 0, :].float(), gens)
    done0 = (eos >= 0) & (first == eos)
    return first, lp0, new_cache, start, done0


class PrefillProgram:
    """One prefill of ``rows`` rows at ``width`` tokens on static buffers,
    eager or a CUDA graph (:class:`~lambdipy_tpu_torch.models.graphs.
    GraphProgram`): the tokens ``[rows, width]``, each row's real length,
    the position ``index`` (0-dim), the knobs ``[rows]`` (its own, or a
    decode step's buffers), eos, and each row's stream (key and draw
    index) when ``sampled``.

    - ``at_index`` False: a prompt from position 0, the lm_head at each
      row's last real position; its K/V written into the decode cache
      ``target`` (:func:`write_prefill`) or, with no target, kept as
      outputs (:meth:`prefill_cache`, float ``[rows, width]``).
    - ``at_index`` True: a chunk at ``index`` of the one-row cache
      ``target``, written there in place (:func:`_continue_prefill`); the
      lm_head at the chunk's last real position.
    - ``select``: the first token and its logprob are selected (outputs
      :attr:`first`, :attr:`lp0`; at an index also :attr:`start`, the
      position after the chunk). A walk's chunk selects nothing.
    - ``offset`` (at an index): a 0-dim ``base`` buffer moves RoPE's
      positions to ``index + base + j`` (the long-context view's chunks,
      :func:`_chunk_forward`); the other programs have none.

    :meth:`run` copies a request's tokens, lengths, index, knobs, eos
    and each row's stream (key and draw index) into the buffers (from
    pinned memory on the card) and, after a selecting run, moves each
    stream's draw index on by its one selection. Outputs are overwritten
    by the next run."""

    def __init__(self, model: LlamaModel, rows: int, width: int, *,
                 sampled: bool = False, select: bool = True,
                 at_index: bool = False, target=None, knobs=None,
                 graph_type=None, stats: GraphStats | None = None,
                 offset: bool = False):
        dev = model.device
        self.model, self.width = model, width
        self.sampled, self.select, self.at_index = sampled, select, at_index
        self.target = target
        self.tokens = torch.zeros(rows, width, dtype=torch.long, device=dev)
        self.length = torch.ones(rows, dtype=torch.int32, device=dev)
        self.index = torch.zeros((), dtype=torch.long, device=dev)
        self.base = (torch.zeros((), dtype=torch.long, device=dev)
                     if offset else None)
        self.eos = torch.full((rows,), -1, dtype=torch.long, device=dev)
        self.knobs = knobs or (
            torch.zeros(rows, dtype=torch.float32, device=dev),
            torch.zeros(rows, dtype=torch.long, device=dev),
            torch.ones(rows, dtype=torch.float32, device=dev))
        self.own_knobs = knobs is None
        self.keys = torch.zeros(rows, 2, dtype=torch.long, device=dev)
        self.draw = torch.zeros(rows, dtype=torch.long, device=dev)
        self.program = GraphProgram(
            self._body, model, rows, graph_type, stats or GraphStats(),
            events=("prefill_replays", "eager_prefills"))

    @property
    def pool_bytes(self) -> int:
        return self.program.pool_bytes

    def close(self) -> None:
        self.program.close()

    def _select(self, lg, streams):
        return select_tokens(lg, *self.knobs, streams, self.sampled)

    def _body(self):
        model = self.model
        if self.at_index:
            cache = [{**_leaves(e), "index": self.index}
                     for e in self.target]
            if not self.select:
                _chunk_forward(model, cache, self.tokens, self.length - 1,
                               self.base)
                return None
            first, lp0, _, start, _ = _continue_prefill(
                model, cache, self.tokens, self.length, self._select,
                (self.keys, self.draw), self.eos, self.width, self.base)
            return first, lp0, start
        logits, pc = model(self.tokens, logit_positions=self.length - 1)
        if self.target is not None:
            write_prefill(model.cfg, self.target, pc)
        if not self.select:
            return None
        first, lp0 = self._select(logits[:, 0, :].float(),
                                  (self.keys, self.draw))
        if self.target is not None:
            return first, lp0
        return (first, lp0, *[t for e in pc for t in (e["k"], e["v"])])

    def run(self, tokens, lengths, *, index: int = 0, knobs=None, gens=(),
            stats: GraphStats | None = None, base: int = 0) -> None:
        """One prefill of ``tokens [rows, width]`` (host data) and their
        real ``lengths``, at ``index`` (host int; checked against the
        target), under ``knobs`` (host data; only for a program with its
        own knob buffers) drawing on from ``gens`` (the rows'
        :class:`RowStream`\\ s), RoPE moved by ``base`` (an ``offset``
        program's); counters to ``stats``."""
        if self.at_index:
            t = cache_width(self.target)
            if index < 0 or index + self.width > t:
                raise ValueError(f"a {self.width}-token chunk at index "
                                 f"{index} crosses the cache's {t} "
                                 f"positions")
            to_device(self.index, np.int64(index))
        if self.base is not None:
            to_device(self.base, np.int64(base))
        to_device(self.tokens, tokens)
        to_device(self.length, lengths)
        if knobs is not None:
            if not self.own_knobs:
                raise ValueError("this program reads a decode step's knobs")
            for buf, val in zip(self.knobs, knobs):
                to_device(buf, val)
        if self.sampled:
            keys, draw = streams_host(gens, self.keys.shape[0])
            to_device(self.keys, keys)
            to_device(self.draw, draw)
        self.program.run(stats)
        if self.select:
            for stream in gens:
                stream.draw += 1

    @property
    def first(self):
        return self.program.outputs[0]

    @property
    def lp0(self):
        return self.program.outputs[1]

    @property
    def start(self):
        return self.program.outputs[2]

    def prefill_cache(self) -> list:
        """The float K/V outputs, one ``{"k", "v"}`` per layer."""
        kv = self.program.outputs[2:]
        return [{"k": kv[2 * i], "v": kv[2 * i + 1]}
                for i in range(len(kv) // 2)]


def _serve_prefill(program: PrefillProgram, step: DecodeStep, tokens,
                   lengths, eos, gens) -> None:
    """Bucketed serving prefill into ``step``: ``program`` (over the
    step's decode cache and knobs) runs the padded prompt, writing its K/V
    into the cache and selecting the first token, and the carry is
    loaded."""
    program.run(tokens, lengths, gens=gens)
    step.load(program.first, program.lp0, program.length, eos, gens)


class WindowEntry(ProgramSet):
    """A one-row cache of ``width`` positions and the programs that write
    it (:class:`PrefillProgram`): a walk's first chunk and its extensions,
    keyed by width, and the continuations of a suffix after it, keyed by
    width and greedy or sampled. Checked out of the server's program cache
    for a whole walk or continuation, so two walks never share one;
    ``index`` is the host's position in it (a walk's bookkeeping), copied
    into a program's index buffer at each run. Whatever must outlive the
    checkout is copied out (:meth:`snapshot`). ``stats`` receives the
    counters of the runs; whoever checks the window out sets it."""

    def __init__(self, model: LlamaModel, width: int, graph_type,
                 stats: GraphStats):
        super().__init__()
        cfg = model.cfg
        self.model, self.width = model, width
        self.graph_type, self.stats = graph_type, stats
        self.cache = [_empty_cache_entry(cfg, 1, width, model.device)
                      for _ in range(cfg.layers)]
        self.index = 0

    def buffer_bytes(self) -> int:
        return cache_nbytes(self.cache)

    def reset(self) -> None:
        """The empty cache's values again (int8 scales 1e-8), index 0."""
        for entry in self.cache:
            for name, val in entry.items():
                val.fill_(1e-8 if name.endswith("_scale") else 0)
        self.index = 0

    def load(self, cache, length: int) -> None:
        """Every position of ``cache``'s leaves (a one-row cache of this
        width) copied in; the index at ``length``."""
        for dest, src in zip(self.cache, cache):
            for name, val in dest.items():
                val.copy_(src[name])
        self.index = int(length)

    def snapshot(self) -> list:
        """A fresh copy of the cache with the index (an ``int``): what a
        caller keeps past the checkout."""
        return [{**{name: val.clone() for name, val in entry.items()},
                 "index": self.index} for entry in self.cache]

    def _program(self, kind: str, width: int, sampled: bool = False,
                 offset: bool = False) -> PrefillProgram:
        key = ((kind, width) + ((_mode(sampled),) if kind == "continue"
                                else ()) + (("offset",) if offset else ()))
        return self.program(key, lambda: PrefillProgram(
            self.model, 1, width, sampled=sampled,
            select=kind == "continue", at_index=kind != "first",
            target=self.cache, graph_type=self.graph_type,
            stats=self.stats, offset=offset))

    def first(self, tokens, length: int) -> None:
        """A walk's first chunk: ``tokens [1, w]`` (host data, padded)
        prefilled from position 0 into the window, every position past
        ``w`` emptied; the index at the chunk's real ``length``."""
        self._program("first", tokens.shape[1]).run(tokens, [length],
                                                    stats=self.stats)
        self.index = int(length)

    def extend(self, tokens, n: int, base: int | None = None) -> None:
        """One extension chunk ``tokens [1, w]`` (host data, ``n`` real)
        written at the index; the index moves by ``n``. ``base``: RoPE at
        ``base`` past the index (the long-context view's program)."""
        self._program("extend", tokens.shape[1],
                      offset=base is not None).run(
            tokens, [n], index=self.index, stats=self.stats, base=base or 0)
        self.index += int(n)

    def cont(self, tokens, n: int, knobs, gens, sampled: bool,
             base: int | None = None):
        """The continuation of a suffix ``tokens [1, w]`` (host data, ``n``
        real) at the index, under ``knobs`` (host data) drawing from
        ``gens``: ``(first [1], lp0 [1])``, the program's outputs (copy
        them to keep them past its next run). The index stays. ``base``
        as in :meth:`extend`."""
        prog = self._program("continue", tokens.shape[1], sampled,
                             offset=base is not None)
        prog.run(tokens, [n], index=self.index, knobs=knobs, gens=gens,
                 stats=self.stats, base=base or 0)
        return prog.first, prog.lp0


def _scan_decode(run, step: DecodeStep, decode_steps: int,
                 segment: bool = False):
    """The decode loop: emits ``decode_steps`` tokens starting with the
    step's current token, calling ``run()`` (one decode step, eager or a
    graph replay) between them. The JAX server scans a bucketed number of
    steps and drops the tokens past the request; this loop runs exactly
    ``decode_steps - 1`` steps. Returns ``(tokens, logprobs)``, each ``[b,
    decode_steps]``.

    ``segment`` is the segment form: every step forwards the token it
    emits (``decode_steps`` steps, as the JAX scan), so the carry left in
    ``step`` continues the decode exactly where this segment stopped."""
    toks, lps = [], []
    for i in range(decode_steps):
        toks.append(step.tok.clone())
        lps.append(step.lp.clone())
        if segment or i < decode_steps - 1:
            run()
    return torch.stack(toks, dim=1), torch.stack(lps, dim=1)


MIN_BUCKET = 16  # the JAX server's default smallest prompt and decode bucket
# the row of the solo sampled speculative stream's key, ``(seed,
# SPEC_STREAM)``: a stream apart from the request's plain rows ``(seed, r)``
SPEC_STREAM = 1 << 32


def _next_bucket(n: int, lo: int) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


# the server's default program bounds. A-C's traffic holds 5 to 8 keys
# (batch bucket, cache_len, greedy or sampled). An entry's decode cache is
# bb x cache_len x 128 KiB of llama3-8b bf16 KV (32 layers x 8 kv heads x
# 128 x 2 x 2 B): 0.50 GiB for one row at the long request's cache_len of
# 4,128, 8 GiB for 8 rows at the full window of 8,192. So the count alone
# does not bound the memory: the entries' bytes, graph pools included (a
# captured prefill keeps its peak: 6.4 GiB for a 4,096-token ``blocked``
# prompt on an H100), are held to a third of what the weights leave of the
# card (23.7 GiB on an 80 GB H100 beside llama3-8b's 8.2 GiB of int8
# weights), the rest left to eager transients and the continuous engine's
# cache or arena.
PROGRAM_CACHE_MAX = 8
PROGRAM_CACHE_SHARE = 1 / 3


def decode_cache_bytes(cfg: LlamaConfig, batch: int, max_len: int) -> int:
    """Device bytes of :func:`init_decode_cache`'s K/V leaves."""
    return batch * page_kv_bytes(cfg, max_len)


def prefill_bytes(cfg: LlamaConfig, rows: int, width: int) -> int:
    """About the device bytes a captured prefill of ``rows x width``
    tokens keeps in its graph's pool: its float K/V, one layer's MLP
    activations (an MoE layer's seats, and its dequantized int8 expert
    stacks) and, but under ``flash``, one layer's f32 attention
    scores, masked and softmaxed (``_attend``). What a new entry is
    expected to take before its first capture says."""
    item = torch.empty((), dtype=cfg.dtype).element_size()
    tokens = rows * width
    kv = 2 * cfg.layers * tokens * cfg.kv_heads * cfg.head_dim * item
    mlp = 3 * tokens * cfg.mlp * item
    if cfg.moe_experts:
        # the seats' activations, and int8 expert stacks dequantized per
        # call (one layer's at a time)
        seats = math.ceil(cfg.moe_capacity_factor * cfg.moe_top_k * tokens)
        mlp = 3 * seats * cfg.mlp * item
        if cfg.quant == "int8":
            mlp += 3 * cfg.moe_experts * cfg.hidden * cfg.mlp * item
    scores = (0 if cfg.attn_backend == "flash"
              else 3 * rows * cfg.heads * width * width * 4)
    return kv + mlp + scores


def default_program_bytes(model: LlamaModel) -> int | None:
    """The program cache's byte bound on the card: a share of the device
    memory the weights leave (None on the CPU: no bound)."""
    dev = model.device
    if dev.type != "cuda":
        return None
    total = torch.cuda.get_device_properties(dev).total_memory
    weights = sum(t.numel() * t.element_size()
                  for t in (*model.parameters(), *model.buffers()))
    return int(PROGRAM_CACHE_SHARE * max(total - weights, 0))


class LlamaServer:
    """Bucketed serving over a :class:`LlamaModel`: prompts pad right to a
    power-of-two bucket, batches to a power-of-two row count with dummy
    length-1 rows, and every sampling knob is a per-row operand, as in
    the JAX server. Device work takes the process's ``DEVICE_LOCK`` (one
    card, one stream; ``models/graphs.py``) a prefill or a segment of
    decode steps at a time, so other requests' work and the continuous
    engine's segments interleave with a long request.

    Decode runs on a :class:`DecodeStep` with its own decode cache per key
    ``(batch bucket, cache_len, KV layout, backends)``, with a greedy and
    a sampled program on it, each captured as a CUDA graph on its first
    step and replayed at every step after (``models/graphs.py``), and the
    prefills that load it (:class:`PrefillProgram`, keyed in the entry by
    the prompt or suffix width and greedy or sampled), captured on their
    first run. The entries sit in an LRU bounded by ``program_cache_max``
    decode entries and ``program_cache_bytes`` device bytes, graph pools
    included (default: a third of what the weights leave of the card; no
    byte bound on the CPU); the same LRU holds the continuous engine's
    prefill programs and the one-row windows that prefix walks, chunked
    prefills and continuations run in (:class:`WindowEntry`), checked out
    for a whole walk. ``graphs``: None = CUDA graphs on the card, eager
    on the CPU; False = eager, prefills included (every program still runs
    on its fixed buffers); or a stand-in graph type (tests).

    Prefix caching (``generate(..., prefix=)``): a prefix's K/V is
    prefilled once into a one-row full-window cache and kept in an LRU of
    ``prefix_cache_max`` entries (:meth:`cache_prefix`), outside the
    program bytes: one entry of ``llama3-8b`` bf16 K/V is 8,192 positions
    x 128 KiB = 1 GiB. A request then prefills only its suffix: the entry's
    prefix positions are copied into the decode step's cache (the entry
    itself is never written) and the suffix continues there
    (:func:`_continue_prefill`), so decode replays the step's graph.

    The JAX server's bucket and cap arguments: ``min_bucket`` (the
    smallest prompt and decode-step bucket, 16), ``decode_cap`` (the most
    new tokens a request may ask for; default the window) and
    ``prefill_chunk`` (off by default; a prefix of at least that many
    tokens prefills in fixed-width chunks, :meth:`_chunked_prefill_cache`,
    and so do the continuous engine's long joiners).

    ``mesh``: the serving mesh (``parallel/mesh.py``), None without one.
    Over a tensor-parallel model (``model.tp`` of more than one rank) the
    server is one rank's: the controller's has ``dispatcher``
    (``parallel/tpserve.py``), through which :meth:`generate` runs on
    every rank at once; a follower's is driven by its follow loop. Such a
    server runs eagerly, and the prefix cache, speculative decoding and
    chunked prefill raise, naming ROADMAP queue 1, item 3 (c2)."""

    # decode steps per hold of the device lock in generate
    segment = 16

    def __init__(self, model: LlamaModel, *, graphs=None,
                 program_cache_max: int = PROGRAM_CACHE_MAX,
                 program_cache_bytes: int | None = None,
                 prefix_cache_max: int = 4, min_bucket: int = MIN_BUCKET,
                 decode_cap: int | None = None,
                 prefill_chunk: int | None = None, mesh=None,
                 dispatcher=None):
        self.model = model
        self.mesh = mesh
        self.dispatcher = dispatcher
        if self.sharded:
            if prefill_chunk:
                raise NotImplementedError(TP_C2.format("chunked prefill"))
            # a CUDA graph cannot hold a gloo collective, and NCCL with
            # more than one rank cannot run on a one-card host: eager
            graphs = False
        self._lock = DEVICE_LOCK
        # the smallest prompt and decode-step bucket
        self.min_bucket = min_bucket
        # chunked prefill (JAX ``llama.py:1404-1418``): a prefix or a long
        # joiner of this width or more prefills in fixed-width chunks
        # against the growing cache. Every chunk, the padded last one
        # included, is written whole at a multiple of the width, so the
        # width must divide max_len: halved until it does, off when
        # nothing >= min_bucket does. None = off, the JAX default.
        self.prefill_chunk = None
        if prefill_chunk:
            ck = max(min_bucket, _next_bucket(prefill_chunk, 16))
            while ck >= min_bucket and model.cfg.max_len % ck:
                ck //= 2
            if ck >= min_bucket:
                self.prefill_chunk = ck
        # the most new tokens a request may ask for (default: the window)
        self.decode_cap = decode_cap or model.cfg.max_len
        if graphs is None:
            graphs = CudaGraph if model.device.type == "cuda" else False
        self.graph_type = graphs or None
        self.graph_stats = GraphStats()
        if program_cache_bytes is None:
            program_cache_bytes = default_program_bytes(model)
        self.programs = ProgramCache(program_cache_max, self.graph_stats,
                                     program_cache_bytes)
        self._prefix_cache_max = max(1, int(prefix_cache_max))
        self._prefixes: OrderedDict = OrderedDict()  # key -> (cache, len)
        self._prefix_lock = threading.Lock()
        self._prefix_inflight: dict[str, threading.Event] = {}
        # speculative decoding's counters: the solo path's and the
        # continuous engine's, one object (JAX ``llama.py:1389-1400``);
        # spec_stats is the last solo request's
        self.spec_metrics = SpecDecodeStats()
        self.spec_stats: dict = {}

    def program_stats(self) -> dict:
        """The programs, as the JAX handler reports them:
        ``decode_buckets`` (the live decode programs' keys),
        ``compile_count`` (graphs captured, decode and prefill),
        ``program_evictions``, ``replays``, ``eager_steps``,
        ``prefill_replays``, ``eager_prefills``, ``program_pools`` (every
        live program's key and its graph pool's bytes) and
        ``program_bytes`` (the entries' caches and graph pools) under
        ``program_cache_bytes``; and the prefix entries
        (``prefix_entries``, ``prefix_bytes``), which lie outside that
        bound."""
        return {"graphs": self.graph_type is not None,
                "decode_buckets": [list(k) for k in self.programs.keys()],
                **self.graph_stats.report(),
                "program_cache_max": self.programs.max_entries,
                "program_cache_bytes": self.programs.max_bytes,
                "program_bytes": self.programs.nbytes(),
                "program_pools": self.programs.pools(),
                **self.prefix_stats()}

    def prefix_stats(self) -> dict:
        """The prefix entries: how many, and their device bytes."""
        with self._prefix_lock:
            entries = [cache for cache, _ in self._prefixes.values()]
        return {"prefix_entries": len(entries),
                "prefix_bytes": sum(cache_nbytes(c) for c in entries)}

    @property
    def device(self):
        return self.model.device

    @property
    def sharded(self) -> bool:
        """One rank of a tensor-parallel model of more than one rank."""
        tp = self.model.tp
        return tp is not None and tp.size > 1

    def _refuse_sharded(self, what: str) -> None:
        if self.sharded:
            raise NotImplementedError(TP_C2.format(what))

    def _validate(self, s: int, max_new_tokens: int) -> None:
        cfg = self.model.cfg
        if max_new_tokens < 0:
            raise ValueError(f"max_new_tokens must be >= 0, got {max_new_tokens}")
        if max_new_tokens > self.decode_cap:
            raise ValueError(
                f"max_new_tokens {max_new_tokens} exceeds the server's "
                f"decode cap {self.decode_cap}")
        if s + max_new_tokens > cfg.max_len:
            raise ValueError(
                f"prompt {s} + max_new_tokens {max_new_tokens} exceeds "
                f"max_len {cfg.max_len}")

    @staticmethod
    def _pad_host(rows, lengths, bb: int, sb: int):
        """(padded ``[bb, sb]`` int64 tokens, per-row int32 lengths), host
        arrays for a program's buffers; dummy length-1 rows fill the batch
        bucket."""
        padded = np.zeros((bb, sb), np.int64)
        for r, row in enumerate(rows):
            padded[r, :lengths[r]] = row
        lens = np.asarray(list(lengths) + [1] * (bb - len(rows)), np.int32)
        return padded, lens

    def _knobs_host(self, temperature, top_k, top_p, seed, eos_id,
                    b: int = 1):
        """Per-row knobs as host arrays: ``(temperature [b] f32, top_k [b]
        int64, top_p [b] f32, eos [b] int64, streams)``. Each knob is a
        scalar (broadcast; None = the disabled value) or a list of per-row
        values padded with the disabled value. Row r's stream
        (:class:`RowStream`) is keyed from ``(seed_r, 0)`` for a list of
        seeds and ``(seed, r)`` for one shared seed — a function of the
        row's own request alone."""

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

        return (vec(temperature, 0.0, np.float32), vec(top_k, 0, np.int64),
                vec(top_p, 1.0, np.float32), vec(eos_id, -1, np.int64),
                row_streams(pairs))

    def generate(self, prompt_tokens, *, max_new_tokens: int,
                 temperature: float = 0.0, top_k: int | None = None,
                 top_p: float | None = None, seed: int = 0,
                 eos_id: int | None = None, prefix=None,
                 return_logprobs: bool = False):
        """prompt_tokens: ``[s]``, ``[b, s]`` or a ragged list of rows ->
        int32 numpy ``[b, max_new_tokens]`` (plus f32 logprobs when
        asked). Knobs may be scalars or per-row lists. A request that runs
        out of device memory evicts every idle program and runs once more
        from its prefill (the same bits: its streams are keyed
        anew).

        ``prefix``: shared-prefix tokens for a single-row request: their
        K/V is prefilled once and kept (:meth:`cache_prefix`), and only
        ``prompt_tokens``, the suffix after the prefix, is prefilled per
        request. With the float KV cache the output is
        ``generate(prefix + prompt)``'s; under ``kv_quant`` the suffix
        attends the quantized prefix K/V, so the two agree to the
        quantization's tolerance."""
        rows, lengths = self._normalize_prompts(prompt_tokens)
        b, s = len(rows), max(lengths)
        if prefix is not None:
            self._refuse_sharded("the prefix cache")
            return self._generate_with_prefix(
                prefix, rows, lengths, max_new_tokens, temperature, top_k,
                top_p, seed, eos_id, return_logprobs)
        self._validate(s, max_new_tokens)
        if max_new_tokens == 0:
            return self._empty(b, return_logprobs)
        args = (rows, lengths, max_new_tokens, temperature, top_k, top_p,
                seed, eos_id)
        if self.sharded:
            # every rank runs it, in the dispatcher's order; no retry on
            # running out of memory: a partner rank may be mid-collective
            toks, lps = self.dispatcher.call("server", "rank_generate",
                                             *args)
        else:
            toks, lps = self._retry_on_oom(lambda: self.rank_generate(*args))
        toks, lps = toks[:b], lps[:b]
        return (toks, lps) if return_logprobs else toks

    def rank_generate(self, rows, lengths, max_new_tokens, temperature,
                      top_k, top_p, seed, eos_id):
        """:meth:`generate`'s device work on this rank, for validated host
        rows: ``(tokens, logprobs)`` host arrays of the batch bucket's
        rows."""
        args = (rows, lengths, max_new_tokens, temperature, top_k, top_p,
                seed, eos_id)
        return self._generate(lambda: self._prefill(*args), max_new_tokens)

    @staticmethod
    def _empty(b: int, return_logprobs: bool):
        toks = np.zeros((b, 0), np.int32)
        return (toks, np.zeros((b, 0), np.float32)) if return_logprobs \
            else toks

    def _retry_on_oom(self, fn):
        """``fn()``; once more after evicting every idle program when it
        runs out of device memory."""
        try:
            return fn()
        except torch.OutOfMemoryError:
            with self._lock:
                if not self.programs.drop_idle():
                    raise
            return fn()

    def _generate(self, prefill, max_new_tokens):
        """:meth:`generate`'s device work: ``prefill()`` (under the lock,
        returning the checked-out entry and its program), then the decode
        in segments of ``segment`` steps, the device lock held for one
        segment at a time; the tokens are fetched once, at the end."""
        with self._lock, torch.inference_mode():
            entry, prog = prefill()
        try:
            toks, lps, emitted = [], [], 0
            while emitted < max_new_tokens:
                k = min(self.segment, max_new_tokens - emitted)
                emitted += k
                with self._lock, torch.inference_mode():
                    # the last token is emitted, not forwarded
                    t, lp = _scan_decode(prog.run, entry.step, k,
                                         segment=emitted < max_new_tokens)
                toks.append(t)
                lps.append(lp)
            with self._lock:
                return (torch.cat(toks, 1).to(torch.int32).cpu().numpy(),
                        torch.cat(lps, 1).float().cpu().numpy())
        finally:
            with self._lock:
                self.programs.checkin(entry)

    def prefill_logits(self, tokens):
        """The f32 logits of one prefill forward over ``tokens`` (``[b,
        s]`` host ints, every row whole), ``[b, s, vocab]`` host array:
        what a served row's first token is selected from. Through the
        dispatcher on every rank at ``tp > 1``."""
        tokens = np.asarray(tokens, np.int64)
        if self.sharded:
            return self.dispatcher.call("server", "rank_prefill_logits",
                                        tokens)
        return self.rank_prefill_logits(tokens)

    def rank_prefill_logits(self, tokens):
        with self._lock, torch.inference_mode():
            logits, _ = self.model(torch.as_tensor(tokens,
                                                   device=self.device))
            return logits.float().cpu().numpy()

    def prompt_bucket(self, s: int, max_new_tokens: int) -> int:
        """The padded prompt width ``generate`` prefills a prompt of ``s``
        tokens at: the pow-2 bucket, shrunk toward ``s`` near
        ``max_len``."""
        max_len = self.model.cfg.max_len
        steps = min(_next_bucket(max_new_tokens, self.min_bucket),
                    max_len - s)
        return min(_next_bucket(s, self.min_bucket), max_len - steps)

    def _layout(self) -> tuple:
        """The KV layout and backends that key every program."""
        cfg = self.model.cfg
        return cfg.kv_quant or "float", cfg.attn_backend, cfg.matmul_backend

    def _checkout(self, bb: int, cache_len: int) -> StepPrograms:
        """The program entry of key ``(bb, cache_len, KV layout,
        backends)``, checked out (caller holds the lock)."""
        cfg = self.model.cfg

        def make():
            cache = init_decode_cache(cfg, bb, cache_len, self.device)
            return StepPrograms(DecodeStep(self.model, cache, bb),
                                self.graph_type, self.graph_stats)

        return self.programs.checkout(
            (bb, cache_len, *self._layout()),
            decode_cache_bytes(cfg, bb, cache_len), make)

    def _step_prefill(self, entry: StepPrograms, kind: str, width: int,
                      sampled: bool) -> PrefillProgram:
        """A decode entry's prefill program: ``"prefill"`` (a prompt from
        position 0) or ``"continue"`` (a suffix after a prefix) of
        ``width`` tokens, over the entry's decode cache and knobs."""
        step = entry.step
        return entry.program((kind, width, _mode(sampled)),
                             lambda: PrefillProgram(
                                 self.model, step.rows, width,
                                 sampled=sampled,
                                 at_index=kind == "continue",
                                 target=step.cache, knobs=step.knobs(),
                                 graph_type=self.graph_type,
                                 stats=self.graph_stats))

    def _checkout_window(self, width: int, stats: GraphStats | None = None,
                         graphs: bool = True) -> WindowEntry:
        """A one-row window of ``width`` positions, checked out for a walk
        or a continuation (caller holds the lock); its runs count on
        ``stats`` (default: the server's). ``graphs=False``: a window of
        its own whose programs run eagerly (the long-context tier's
        half-window chunks, whose plain attention peaks at several GiB: a
        graph's pool would hold that peak for good)."""
        graph_type = self.graph_type if graphs else None
        window = self.programs.checkout(
            ("window", width, *self._layout())
            + (() if graphs else ("eager",)),
            decode_cache_bytes(self.model.cfg, 1, width),
            lambda: WindowEntry(self.model, width, graph_type,
                                self.graph_stats), counted=False)
        window.stats = stats or self.graph_stats
        return window

    def _rows_prefill(self, tokens, lengths, knobs, gens,
                      stats: GraphStats | None = None):
        """The continuous engine's ragged prefill of ``tokens [bb, sb]``
        (host data; caller holds the lock, inference mode) through the
        prefill program of its shape, each row under its own knobs and
        stream: ``(first [bb], lp0 [bb], prefill cache)``, copied out of
        the program's buffers, since the rows are packed after the next
        request may have run it; counters to ``stats``."""
        cfg = self.model.cfg
        bb, sb = tokens.shape
        sampled = bool((knobs[0] > 0).any())
        entry = self.programs.checkout(
            ("prefill", bb, sb, *self._layout()), prefill_bytes(cfg, bb, sb),
            ProgramSet, counted=False)
        try:
            prog = entry.program((_mode(sampled),), lambda: PrefillProgram(
                self.model, bb, sb, sampled=sampled,
                graph_type=self.graph_type, stats=self.graph_stats))
            prog.run(tokens, lengths, knobs=knobs, gens=gens, stats=stats)
            return (prog.first.clone(), prog.lp0.clone(),
                    [{name: val.clone() for name, val in e.items()}
                     for e in prog.prefill_cache()])
        finally:
            self.programs.checkin(entry)

    def _prefill(self, rows, lengths, max_new_tokens, temperature, top_k,
                 top_p, seed, eos_id):
        """The bucketed prefill shared by :meth:`generate` and
        :meth:`generate_stream` (caller holds the lock, inference mode):
        checks out the key's entry, runs its prefill program of the
        prompt's bucket into the step and returns ``(entry, program)``,
        the decode program greedy or sampled as the knobs ask; the caller
        checks the entry back in."""
        cfg = self.model.cfg
        b, s = len(rows), max(lengths)
        steps = min(_next_bucket(max_new_tokens, self.min_bucket),
                    cfg.max_len - s)
        sb = self.prompt_bucket(s, max_new_tokens)
        bb = _next_bucket(b, 1)
        cache_len = min(sb + steps, cfg.max_len)
        tokens, lens = self._pad_host(rows, lengths, bb, sb)
        temp, tk, tp, eos, gens = self._knobs_host(
            temperature, top_k, top_p, seed, eos_id, b=bb)
        sampled = bool((temp > 0).any())
        entry = self._checkout(bb, cache_len)
        try:
            prog = entry.decode(sampled)
            entry.step.set_knobs(temp, tk, tp)
            _serve_prefill(self._step_prefill(entry, "prefill", sb, sampled),
                           entry.step, tokens, lens, eos, gens)
        except BaseException:
            self.programs.checkin(entry)
            raise
        return entry, prog

    def generate_stream(self, prompt_tokens, *, max_new_tokens: int,
                        temperature: float = 0.0, top_k: int | None = None,
                        top_p: float | None = None, seed: int = 0,
                        eos_id: int | None = None, segment: int = 16,
                        prefix=None, return_logprobs: bool = False):
        """Streaming :meth:`generate`: yields int32 numpy ``[b, k]``
        chunks (``k <= segment``; ``(tokens, logprobs)`` pairs when
        asked) as they decode, stopping early once every row has latched
        eos. Concatenated chunks are exactly :meth:`generate`'s output
        prefix: the same prefill and cache, the same per-row streams
        (segment boundaries do not change a row's draws). The lock is
        held per segment, not across the yields; the stream holds its
        entry (step, cache, graphs) from its prefill to its end. A prefill
        that runs out of device memory evicts every idle program and runs
        once more. ``prefix=`` streams from a cached prefix K/V (a single
        row), as :meth:`generate` does."""
        if self.sharded:
            yield from self._sharded_stream(
                prompt_tokens, max_new_tokens, segment, eos_id,
                return_logprobs, prefix=prefix, temperature=temperature,
                top_k=top_k, top_p=top_p, seed=seed)
            return
        rows, lengths = self._normalize_prompts(prompt_tokens)
        b, s = len(rows), max(lengths)
        if prefix is not None:
            if max_new_tokens == 0:
                self._validate(s, max_new_tokens)
                return
            segment = max(1, min(int(segment), max_new_tokens))
            yield from self._generate_stream_with_prefix(
                prefix, rows, lengths, max_new_tokens, temperature, top_k,
                top_p, seed, eos_id, segment, return_logprobs)
            return
        self._validate(s, max_new_tokens)
        if max_new_tokens == 0:
            return
        segment = max(1, min(int(segment), max_new_tokens))
        args = (rows, lengths, max_new_tokens, temperature, top_k, top_p,
                seed, eos_id)
        yield from self._stream(lambda: self._prefill(*args), b,
                                max_new_tokens, segment, eos_id,
                                return_logprobs)

    def _sharded_stream(self, prompt_tokens, max_new_tokens, segment,
                        eos_id, return_logprobs, *, prefix, temperature,
                        top_k, top_p, seed):
        """:meth:`generate_stream` of a tensor-parallel controller: the
        prefill and each segment are dispatched calls, so a chunk is
        yielded as soon as its segment is decoded and other requests'
        calls run between them. Every rank keeps its own entry under one
        id from the prefill to :meth:`rank_stream_close`, which runs on
        every rank when the stream ends, fails, or is closed by a consumer
        that left mid-stream."""
        if prefix is not None:
            self._refuse_sharded("the prefix cache")
        rows, lengths = self._normalize_prompts(prompt_tokens)
        b, s = len(rows), max(lengths)
        self._validate(s, max_new_tokens)
        if max_new_tokens == 0:
            return
        segment = max(1, min(int(segment), max_new_tokens))
        disp = self.dispatcher
        opened = disp.call("server", "rank_stream_open", rows, lengths,
                           max_new_tokens, temperature, top_k, top_p, seed,
                           eos_id, keep=True)
        try:
            emitted = 0
            while emitted < max_new_tokens:
                k = min(segment, max_new_tokens - emitted)
                chunk, lp_chunk, latched = disp.call(
                    "server", "rank_stream_segment", opened, b, k,
                    eos_id is not None)
                emitted += k
                yield (chunk, lp_chunk) if return_logprobs else chunk
                if latched:
                    return
        finally:
            if disp.live:
                disp.call("server", "rank_stream_close", opened)

    def rank_stream_open(self, rows, lengths, max_new_tokens, temperature,
                         top_k, top_p, seed, eos_id):
        """A stream's prefill on this rank: its checked-out ``(entry,
        program)``, for :meth:`rank_stream_segment` and
        :meth:`rank_stream_close`."""
        with self._lock, torch.inference_mode():
            return self._prefill(rows, lengths, max_new_tokens, temperature,
                                 top_k, top_p, seed, eos_id)

    def rank_stream_segment(self, opened, b: int, k: int, eos: bool):
        """``k`` decode steps of an open stream on this rank: ``(tokens
        [b, k] int32, logprobs [b, k] f32, every row latched eos)``, host
        arrays (``eos`` false: never latched)."""
        entry, prog = opened
        with self._lock, torch.inference_mode():
            toks, lps = _scan_decode(prog.run, entry.step, k, segment=True)
            return (toks[:b].to(torch.int32).cpu().numpy(),
                    lps[:b].float().cpu().numpy(),
                    eos and bool(entry.step.done[:b].all()))

    def rank_stream_close(self, opened) -> None:
        """Check an open stream's entry back in on this rank."""
        with self._lock:
            self.programs.checkin(opened[0])

    def _stream(self, prefill, b, max_new_tokens, segment, eos_id,
                return_logprobs):
        """:meth:`generate_stream`'s device work: ``prefill()`` under the
        lock (once more after evicting idle programs when it runs out of
        memory), then the decode a segment at a time."""
        with self._lock, torch.inference_mode():
            try:
                opened = prefill()
            except torch.OutOfMemoryError:
                if not self.programs.drop_idle():
                    raise
                opened = prefill()
        try:
            emitted = 0
            while emitted < max_new_tokens:
                k = min(segment, max_new_tokens - emitted)
                chunk, lp_chunk, latched = self.rank_stream_segment(
                    opened, b, k, eos_id is not None)
                emitted += k
                yield (chunk, lp_chunk) if return_logprobs else chunk
                if latched:
                    return
        finally:
            self.rank_stream_close(opened)

    # -- prefix caching ------------------------------------------------------

    @staticmethod
    def _prefix_key(tokens) -> str:
        arr = np.asarray(tokens, np.int32).reshape(-1)
        return hashlib.sha1(arr.tobytes()).hexdigest()

    def cache_prefix(self, prefix_tokens) -> str:
        """Prefill ``prefix_tokens`` once and keep its K/V for the
        ``prefix=`` paths (idempotent; LRU-bounded by
        ``prefix_cache_max``). Returns the key. The kept cache spans the
        whole context window, so any suffix and decode the window allows
        can continue from it. Concurrent callers of one prefix wait for
        the one prefill; a wait that times out twice raises."""
        self._refuse_sharded("the prefix cache")
        cfg = self.model.cfg
        rows, lengths = self._normalize_prompts(prefix_tokens)
        if len(rows) != 1:
            raise ValueError("prefix caching is single-row")
        s = lengths[0]
        if s >= cfg.max_len:
            raise ValueError(f"prefix {s} fills the whole context window")
        key = self._prefix_key(rows[0])
        wait_s, timeouts, max_timeouts = 300.0, 0, 2
        while True:
            with self._prefix_lock:
                if key in self._prefixes:
                    self._prefixes.move_to_end(key)
                    return key
                waiter = self._prefix_inflight.get(key)
                if waiter is None:
                    self._prefix_inflight[key] = threading.Event()
                    break
            if not waiter.wait(timeout=wait_s):
                timeouts += 1
                if timeouts >= max_timeouts:
                    raise RuntimeError(
                        f"prefix prefill (key {key[:8]}...) owned by another "
                        f"thread did not complete within "
                        f"{timeouts * wait_s:.0f}s; failing this request")
        try:
            return self._prefill_prefix(key, rows, lengths)
        finally:
            with self._prefix_lock:
                self._prefix_inflight.pop(key).set()

    def get_prefix(self, key: str):
        """LRU-refreshing peek: ``(cache, length)`` for an exact prefix
        key, or None; never prefills."""
        with self._prefix_lock:
            entry = self._prefixes.get(key)
            if entry is not None:
                self._prefixes.move_to_end(key)
            return entry

    def register_prefix(self, key: str, cache, length: int) -> None:
        """Insert a full-window prefix cache built elsewhere (the radix
        prefix store's assembly or walk) under ``key``, with the same LRU
        bound as :meth:`cache_prefix`, so every ``prefix=`` path serves
        from it unchanged."""
        with self._prefix_lock:
            self._prefixes[key] = (cache, int(length))
            self._prefixes.move_to_end(key)
            while len(self._prefixes) > self._prefix_cache_max:
                self._prefixes.popitem(last=False)

    def _prefix_first_fn(self, sb: int, cache_len: int):
        """First-chunk prefix prefill of width ``sb``: ``pf(prompt [1, sb]
        host data, length, window=None)`` embeds the padded chunk at
        position 0 of a one-row ``cache_len`` window with the index at the
        true length (the lm_head runs at one position). Into ``window``
        when given (returned), else into a window checked out for it, of
        which a copy (``index`` an ``int``) is returned. Takes the device
        lock for its dispatch."""
        def pf(prompt, length: int, window=None):
            with self._lock, torch.inference_mode():
                if window is not None:
                    window.first(prompt, length)
                    return window
                window = self._checkout_window(cache_len)
                try:
                    window.first(prompt, length)
                    return window.snapshot()
                finally:
                    self.programs.checkin(window)

        return pf

    def _prefix_ext_fn(self, sbs: int):
        """Extend a walk's window by one padded chunk of width ``sbs``:
        ``ext(window, chunk [1, sbs] host data, chunk_len)`` writes the
        chunk's K/V at the window's index in place (no token selection;
        the lm_head at one position) and moves the index by
        ``chunk_len``. Every chunk but the last must be full: the write
        covers the whole padded chunk, the next chunk overwrites the
        padding, and the last chunk's padding stays behind the index.
        Takes the device lock for its dispatch."""
        def ext(window, chunk, chunk_len: int):
            with self._lock, torch.inference_mode():
                window.extend(chunk, chunk_len)
            return window

        return ext

    def _walk_chunks(self, window: WindowEntry, row, upto: int,
                     stats=None) -> WindowEntry:
        """``row[:upto]`` embedded into ``window`` (emptied first) in
        chunks of ``prefill_chunk`` tokens (JAX ``llama.py:2075``, without
        the sequence-parallel walk), each chunk an extension
        (``_prefix_ext_fn``) written at the window's index and its own
        dispatch under the device lock, so other work interleaves between
        chunks. The JAX walk prefills its first chunk alone
        (``_prefix_first_fn``); here the first chunk extends an empty cache
        at index 0 as well, so every chunk attends through the same plain
        attention over the window that a continuation uses (a first chunk
        attending only its own width softmaxes its rows at another width
        than an unchunked prefill's bucket does: other bits, and on the
        card other greedy tokens where two are nearly tied). The window's
        width must be a multiple of the chunk; the last chunk may be
        ragged (its padding stays behind the index). ``stats`` (a
        ``PrefillStats``) counts a round per chunk."""
        ck = self.prefill_chunk
        ext = self._prefix_ext_fn(ck)
        with self._lock, torch.inference_mode():
            window.reset()
        pos = 0
        while pos < upto:
            n = min(ck, upto - pos)
            chunk, _ = self._pad_host([row[pos:pos + n]], [n], 1, ck)
            window = ext(window, chunk, n)
            if stats is not None:
                stats.record_round()
            pos += n
        return window

    def _chunked_prefill_cache(self, row, upto: int, cache_len: int,
                               stats=None):
        """``row[:upto]`` walked in chunks (:meth:`_walk_chunks`) in a
        one-row ``cache_len`` window checked out for the walk; returns a
        copy of the window (``index`` the ``int`` ``upto``). The chunk
        walk of the prefix path."""
        with self._lock:
            window = self._checkout_window(cache_len)
        try:
            self._walk_chunks(window, row, upto, stats)
            with self._lock, torch.inference_mode():
                return window.snapshot()
        finally:
            with self._lock:
                self.programs.checkin(window)

    def _prefill_prefix(self, key: str, rows, lengths) -> str:
        cfg = self.model.cfg
        s = lengths[0]
        ck = self.prefill_chunk
        # JAX walks a prefix longer than the chunk; a prefix of exactly
        # one chunk walks here too, so that it is the walk the engine runs
        # for a joiner split there (every chunk an extension)
        if ck and s >= ck:
            cache = self._chunked_prefill_cache(rows[0], s, cfg.max_len)
        else:
            sb = min(_next_bucket(s, self.min_bucket), cfg.max_len)
            prompt, _ = self._pad_host(rows, lengths, 1, sb)
            cache = self._prefix_first_fn(sb, cfg.max_len)(prompt, s)
        self.register_prefix(key, cache, s)
        return key

    def _prefix_entry(self, prefix_tokens):
        """``(cache, prefix_len)`` for ``prefix_tokens``, prefilled if
        absent; retried when a burst of other prefixes evicts it between
        the prefill and the lookup."""
        for _ in range(3):
            key = self.cache_prefix(prefix_tokens)
            entry = self.get_prefix(key)
            if entry is not None:
                return entry
        raise RuntimeError("prefix cache thrashing: entry evicted right "
                           "after insert 3x; raise prefix_cache_max")

    def _continue(self, cache, plen: int, row, s: int, sbs: int, knobs):
        """The prefix paths' prefill (caller holds the lock, inference
        mode): checks out the one-row entry at the prefix cache's width,
        copies the prefix's ``plen`` positions into its step's cache (the
        shared entry is never written), runs the entry's continuation
        program of the suffix padded to ``sbs`` there at index ``plen``
        and loads the carry; returns ``(entry, program)``."""
        temp, tk, tp, eos, gens = self._knobs_host(*knobs, b=1)
        sampled = bool((temp > 0).any())
        entry = self._checkout(1, cache_width(cache))
        try:
            prog = entry.decode(sampled)
            step = entry.step
            step.set_knobs(temp, tk, tp)
            for dest, src in zip(step.cache, cache):
                for name, val in _leaves(src).items():
                    dest[name][:, :plen] = val[:, :plen]
            suffix, _ = self._pad_host([row], [s], 1, sbs)
            pre = self._step_prefill(entry, "continue", sbs, sampled)
            pre.run(suffix, [s], index=plen, gens=gens)
            step.load(pre.first, pre.lp0, pre.start, eos, gens)
        except BaseException:
            self.programs.checkin(entry)
            raise
        return entry, prog

    def _generate_with_prefix(self, prefix_tokens, rows, lengths,
                              max_new_tokens, temperature, top_k, top_p,
                              seed, eos_id, return_logprobs=False):
        """Continuation prefill and decode from a cached prefix K/V (one
        row). With the float cache the output is ``generate(prefix +
        suffix)``'s: the suffix attends the cached prefix through the same
        masked attention, where masked positions add exact zeros."""
        cfg = self.model.cfg
        if len(rows) != 1:
            raise ValueError("prefix= requires a single prompt row")
        cache, plen = self._prefix_entry(prefix_tokens)
        s = lengths[0]
        self._validate(plen + s, max_new_tokens)
        if max_new_tokens == 0:
            return self._empty(1, return_logprobs)
        steps = min(_next_bucket(max_new_tokens, self.min_bucket),
                    cfg.max_len - plen - s)
        sbs = min(_next_bucket(s, self.min_bucket),
                  cfg.max_len - plen - steps)
        knobs = (temperature, top_k, top_p, seed, eos_id)
        toks, lps = self._retry_on_oom(lambda: self._generate(
            lambda: self._continue(cache, plen, rows[0], s, sbs, knobs),
            max_new_tokens))
        return (toks, lps) if return_logprobs else toks

    def _generate_stream_with_prefix(self, prefix_tokens, rows, lengths,
                                     max_new_tokens, temperature, top_k,
                                     top_p, seed, eos_id, segment,
                                     return_logprobs):
        """Streaming decode from a cached prefix K/V (one row): one
        continuation of the suffix, then the segment walk of
        :meth:`generate_stream`; its chunks concatenate to the fused
        ``generate(prefix=)`` output (the suffix bucket is the JAX
        streaming path's, without the decode steps' share)."""
        cfg = self.model.cfg
        if len(rows) != 1:
            raise ValueError("prefix= streaming requires a single row")
        cache, plen = self._prefix_entry(prefix_tokens)
        s = lengths[0]
        self._validate(plen + s, max_new_tokens)
        sbs = min(_next_bucket(s, self.min_bucket), cfg.max_len - plen)
        knobs = (temperature, top_k, top_p, seed, eos_id)
        yield from self._stream(
            lambda: self._continue(cache, plen, rows[0], s, sbs, knobs), 1,
            max_new_tokens, segment, eos_id, return_logprobs)

    # -- speculative decoding ----------------------------------------------

    def _spec_args(self, prompt_tokens, max_new_tokens: int, k: int, prefix):
        """The solo speculative request checked as JAX checks it: ``(row,
        prefix entry or None, prefix length, kb, fallback)``; ``kb`` is
        ``k`` bucketed to a power of two >= 2, and ``fallback`` says a
        verify chunk would cross the window (or nothing is asked): the
        request decodes plainly."""
        rows, lengths = self._normalize_prompts(prompt_tokens)
        if len(rows) != 1:
            raise ValueError("speculative decoding is single-row")
        plen, pentry = 0, None
        if prefix is not None:
            pentry = self._prefix_entry(prefix)
            plen = pentry[1]
        self._validate(plen + lengths[0], max_new_tokens)
        kb = max(2, _next_bucket(max(2, int(k)), 2))
        fallback = (max_new_tokens == 0 or plen + lengths[0]
                    + max_new_tokens + kb > self.model.cfg.max_len)
        return rows[0], pentry, plen, kb, fallback

    def _spec_steps(self, row, max_new_tokens: int, kb: int, ngram_max: int,
                    stats_out: dict, prefix=None, pentry=None,
                    temperature: float = 0.0, top_k=None, top_p=None,
                    seed: int = 0):
        """The solo verify loop (JAX ``_spec_steps``, ``llama.py:2897``),
        a generator of ``(tokens, logprobs)`` lists per verify step (the
        accepted drafts and the corrected token, 1..kb tokens), filling
        ``stats_out`` as it goes; the fused and the streamed paths both
        consume it. The prefill (or, with ``prefix``, the continuation)
        is the one plain :meth:`generate` runs, into the decode entry of
        plain ``generate``'s key, and the verifies run on that entry's
        step (:class:`VerifyStep`, a graph per ``kb`` on the card). Greedy:
        the chain verify, so every token and logprob is bitwise plain
        ``generate``'s. Sampled: rejection sampling on a stream of its own
        keyed from ``(seed, SPEC_STREAM)``: target-distributed and
        deterministic per seed. Drafts look the pending token up in the
        prompt (the prefix included) and what was emitted."""
        cfg = self.model.cfg
        s = len(row)
        sampled = (temperature or 0.0) > 0.0
        # eos is the host's: the verify never latches
        knobs = (temperature, top_k, top_p, seed, None)
        context = ([int(t) for t in np.asarray(prefix).reshape(-1)]
                   if prefix is not None else []) + [int(t) for t in row]
        with self._lock, torch.inference_mode():
            if prefix is not None:
                cache, plen = pentry
                steps = min(_next_bucket(max_new_tokens, self.min_bucket),
                            cfg.max_len - plen - s)
                sbs = min(_next_bucket(s, self.min_bucket),
                          cfg.max_len - plen - steps)
                entry, _ = self._continue(cache, plen, row, s, sbs, knobs)
            else:
                entry, _ = self._prefill([row], [s], max_new_tokens,
                                         *knobs)
        try:
            with self._lock, torch.inference_mode():
                prog = verify_program(entry, kb, sampled, resample=sampled)
                vstep = prog.vstep
                if sampled:
                    keys, _ = streams_host(
                        row_streams([(seed, SPEC_STREAM)]), 1)
                    to_device(vstep.keys, keys)
                    vstep.draw.zero_()
                pending = int(entry.step.tok[0])
            emitted = steps_run = 0
            while emitted < max_new_tokens:
                draft, hit = lookup_draft_hit(context + [pending], kb,
                                              ngram_max=ngram_max)
                with self._lock, torch.inference_mode():
                    vstep.set_drafts([draft[:kb - 1]])
                    prog.run()
                    chunk, lps, count, pend = (t.cpu() for t in
                                               prog.outputs)
                cnt = int(count[0])
                toks_step = chunk[0, :cnt].tolist()
                lps_step = lps[0, :cnt].float().tolist()
                steps_run += 1
                emitted += cnt
                context += toks_step
                pending = int(pend[0])
                stats_out.update(
                    {"steps": steps_run, "emitted": emitted,
                     "tokens_per_step": round(emitted / steps_run, 2),
                     "k": kb})
                self.spec_metrics.record_step(proposed=kb - 1,
                                              accepted=cnt - 1,
                                              emitted=cnt, hit=hit)
                yield toks_step, lps_step
        finally:
            with self._lock:
                self.programs.checkin(entry)

    def generate_speculative_stream(self, prompt_tokens, *,
                                    max_new_tokens: int, k: int = 8,
                                    eos_id: int | None = None,
                                    return_logprobs: bool = False,
                                    ngram_max: int = 3, prefix=None,
                                    temperature: float = 0.0,
                                    top_k: int | None = None,
                                    top_p: float | None = None,
                                    seed: int = 0,
                                    stats_out: dict | None = None):
        """Streaming speculative decode (JAX ``llama.py:3011``): one
        ``[1, c]`` chunk per verify step (``1 <= c <= kb``; ``(tokens,
        logprobs)`` pairs when asked), ending at the first eos and at
        ``max_new_tokens``; the chunks concatenate to
        :meth:`generate_speculative`'s output up to its eos filler. Near
        the window's end (no room for a verify chunk) it streams plain
        decode instead, counted as a fallback. ``stats_out``: a dict that
        receives the request's counters."""
        self._refuse_sharded("speculative decoding")
        row, pentry, plen, kb, fallback = self._spec_args(
            prompt_tokens, max_new_tokens, k, prefix)
        stats = {} if stats_out is None else stats_out
        if fallback:
            stats.update({"fallback": "plain", "steps": max_new_tokens,
                          "emitted": max_new_tokens, "tokens_per_step": 1.0,
                          "k": kb})
            self.spec_metrics.record_fallback("near_window")
            yield from self.generate_stream(
                row, max_new_tokens=max_new_tokens, eos_id=eos_id,
                prefix=prefix, temperature=temperature, top_k=top_k,
                top_p=top_p, seed=seed, return_logprobs=return_logprobs)
            return
        emitted = 0
        with contextlib.closing(self._spec_steps(
                row, max_new_tokens, kb, ngram_max, stats, prefix=prefix,
                pentry=pentry, temperature=temperature, top_k=top_k,
                top_p=top_p, seed=seed)) as steps:
            yield from self._spec_chunks(steps, max_new_tokens, eos_id,
                                         return_logprobs)

    @staticmethod
    def _spec_chunks(steps, max_new_tokens: int, eos_id, return_logprobs):
        """The verify steps' lists as stream chunks, cut at
        ``max_new_tokens`` and after the first eos."""
        emitted = 0
        for toks_step, lps_step in steps:
            take = min(len(toks_step), max_new_tokens - emitted)
            chunk, lp_chunk = toks_step[:take], lps_step[:take]
            if eos_id is not None and eos_id in chunk:
                cut = chunk.index(eos_id) + 1
                chunk, lp_chunk = chunk[:cut], lp_chunk[:cut]
            emitted += len(chunk)
            arr = np.asarray([chunk], np.int32)
            yield ((arr, np.asarray([lp_chunk], np.float32))
                   if return_logprobs else arr)
            if eos_id is not None and eos_id in chunk:
                return

    def generate_speculative(self, prompt_tokens, *, max_new_tokens: int,
                             k: int = 8, eos_id: int | None = None,
                             return_logprobs: bool = False,
                             return_stats: bool = False,
                             ngram_max: int = 3, prefix=None,
                             temperature: float = 0.0,
                             top_k: int | None = None,
                             top_p: float | None = None, seed: int = 0):
        """Decode one row with prompt-lookup speculative verification (JAX
        ``llama.py:3133``). Greedy: bitwise :meth:`generate`'s tokens and
        logprobs (each accepted position is the one-token step plain
        decode runs, :class:`VerifyStep`). ``temperature > 0``: rejection
        sampling, target-distributed and deterministic per seed, but not
        plain sampling's tokens. eos truncates and fills as ``generate``'s
        latch does. Returns ``[1, max_new_tokens]`` (plus logprobs when
        asked, plus the request's counters with ``return_stats``); the
        counters also land in :attr:`spec_stats` and, cumulative, in
        :attr:`spec_metrics`."""
        self._refuse_sharded("speculative decoding")
        row, pentry, plen, kb, fallback = self._spec_args(
            prompt_tokens, max_new_tokens, k, prefix)
        if fallback:
            out = self.generate(row, max_new_tokens=max_new_tokens,
                                eos_id=eos_id, prefix=prefix,
                                temperature=temperature, top_k=top_k,
                                top_p=top_p, seed=seed,
                                return_logprobs=return_logprobs)
            stats = {"fallback": "plain", "steps": max_new_tokens,
                     "emitted": max_new_tokens, "tokens_per_step": 1.0,
                     "k": kb}
            self.spec_stats = stats
            self.spec_metrics.record_fallback("near_window")
            return (out, stats) if return_stats else out
        toks: list[int] = []
        lps: list[float] = []
        stats: dict = {}
        with contextlib.closing(self._spec_steps(
                row, max_new_tokens, kb, ngram_max, stats, prefix=prefix,
                pentry=pentry, temperature=temperature, top_k=top_k,
                top_p=top_p, seed=seed)) as steps:
            for toks_step, lps_step in steps:
                toks += toks_step
                lps += lps_step
                if eos_id is not None and eos_id in toks_step:
                    break
        self.spec_stats = stats
        toks, lps = toks[:max_new_tokens], lps[:max_new_tokens]
        if eos_id is not None and eos_id in toks:
            cut = toks.index(eos_id) + 1
            toks = toks[:cut] + [eos_id] * (max_new_tokens - cut)
            lps = lps[:cut] + [0.0] * (max_new_tokens - cut)
        out = np.asarray([toks], np.int32)
        if return_logprobs:
            out = (out, np.asarray([lps], np.float32))
        return (out, stats) if return_stats else out

    @staticmethod
    def _gather_pages_into(window: WindowEntry, arena, table, page: int,
                           length: int) -> None:
        """A one-row block table's pages (``table [1, nb]``, ``nb * page``
        the window's width) gathered into ``window``, bitwise the pages'
        values, null pages included; the index at ``length``. Reads the
        arena, never writes it."""
        tbl = table[0].long()
        for dest, entry in zip(window.cache, arena):
            for name, val in dest.items():
                torch.index_select(entry[name], 0, tbl,
                                   out=val.view(-1, page, *val.shape[2:]))
        window.index = int(length)

    def _paged_continue_fn(self, sbs: int, page: int):
        """Continuation prefill from shared prefix pages: ``cont(window,
        arena, table [1, nb], plen, suffix [1, sbs] host data, suffix_len,
        knobs, gens, sampled)`` gathers the row's pages (the matched
        prefix pages and its own) into ``window`` (as wide as the table),
        runs the window's continuation there (at the shapes the dense
        prefix path runs it), and writes back only the pages the suffix
        chunk wrote, from ``plen // page`` on: the prefix pages are read in
        place and never written. Returns ``(first, lp0)``, copies. The
        caller holds the device and arena locks."""
        def cont(window, arena, table, plen: int, suffix, suffix_len: int,
                 knobs, gens, sampled: bool):
            self._gather_pages_into(window, arena, table, page, plen)
            first, lp0 = window.cont(suffix, suffix_len, knobs, gens,
                                     sampled)
            lo = plen // page
            hi = min(table.shape[1], -(-(plen + sbs) // page))
            written = [{name: val[:, lo * page:hi * page]
                        for name, val in entry.items()}
                       for entry in window.cache]
            _scatter_page_cache(arena, table[:, lo:hi], written, page)
            return first.clone(), lp0.clone()

        return cont

    def _lpaged_continue_fn(self, sbs: int, page: int):
        """One chunk of the long-context prefill through the sliding view
        (JAX ``_lpaged_continue_fn``, ``llama.py:2604``): ``cont(window,
        arena, table [1, nb], local, base, chunk [1, sbs] host data, n,
        knobs=None, gens=(), sampled=False)`` gathers the view's pages
        into ``window`` (as wide as the view; the index at ``local``),
        writes the chunk there with RoPE at its logical positions ``base
        + local + j``, and scatters back the pages the chunk wrote, from
        ``local // page`` on. With ``knobs`` the chunk is the prompt's
        last and selects the first token (``(first, lp0)``, copies; the
        rows' streams move on by one); without, it selects nothing and
        returns None. JAX selects at every chunk from one unchanged rng
        and keeps the last; a stream here moves on at a selection, so
        only the last chunk selects. The caller holds the device and
        arena locks."""
        def cont(window, arena, table, local: int, base: int, chunk,
                 n: int, knobs=None, gens=(), sampled: bool = False):
            self._gather_pages_into(window, arena, table, page, local)
            out = None
            if knobs is None:
                window.extend(chunk, n, base=base)
            else:
                first, lp0 = window.cont(chunk, n, knobs, gens, sampled,
                                         base=base)
                out = first.clone(), lp0.clone()
            lo = local // page
            hi = min(table.shape[1], -(-(local + sbs) // page))
            written = [{name: val[:, lo * page:hi * page]
                        for name, val in entry.items()}
                       for entry in window.cache]
            _scatter_page_cache(arena, table[:, lo:hi], written, page)
            return out

        return cont

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
