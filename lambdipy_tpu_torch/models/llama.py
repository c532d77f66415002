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
- The kernel backends are the defaults: with ``matmul_backend="pallas"``
  every int8 projection runs the port's int8 kernel with the kernel's
  rounding at every shape (``ops/quant.py``); with
  ``attn_backend="blocked"`` every one-token decode step runs the port's
  decode-attention kernel. ``"xla"`` and ``"dense"`` are the plain
  PyTorch reference the kernels are held against. Prefill attention is
  plain PyTorch, as the JAX package leaves it to XLA.
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

from lambdipy_tpu_torch.ops.decode_attention import decode_attention
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
    # "blocked" (the decode-attention kernel for one-token steps) or
    # "dense" (plain PyTorch, the reference the kernel is held against)
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
    """f32 math, f32 gain, result cast back to the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.register_buffer("scale", torch.ones(dim, dtype=torch.float32,
                                                 device=device))

    def forward(self, x):
        x32 = x.float()
        y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + self.eps)
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

    def forward(self, x, positions, mask, cache):
        """cache: None (prefill over all of x) or dict(k, v, index) with a
        per-row ``[b]`` index for a one-token decode step. Returns
        ``(y, new_cache_entry)``; a decode step writes the cache in place."""
        cfg = self.cfg
        d = cfg.head_dim
        h = self.attn_norm(x)
        b, s, _ = h.shape
        q = self.q_proj(h).reshape(b, s, cfg.heads, d)
        k = self.k_proj(h).reshape(b, s, cfg.kv_heads, d)
        v = self.v_proj(h).reshape(b, s, cfg.kv_heads, d)
        q, k = rope(q, k, positions, cfg.rope_theta, cfg.rope_scaling)

        if cache is None:
            causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
            out = _attend(q, k, v, mask[:, None, :] & causal[None])
            new_cache = {"k": k, "v": v}
        else:
            if s != 1:
                raise ValueError("the per-row cache branch takes one-token "
                                 f"decode steps, got {s} tokens")
            idx = cache["index"]  # [b]
            ck, cv = cache["k"], cache["v"]
            t = ck.shape[1]
            # the JAX scatter drops out-of-bounds writes; an out-of-bounds
            # index is a device assert here, so such rows rewrite the
            # value already at their clamped slot instead
            rows = torch.arange(b, device=x.device)
            slot = idx.clamp(max=t - 1).long()
            keep = (idx < t)[:, None, None]
            ck[rows, slot] = torch.where(keep, k[:, 0].to(cfg.dtype),
                                         ck[rows, slot])
            cv[rows, slot] = torch.where(keep, v[:, 0].to(cfg.dtype),
                                         cv[rows, slot])
            new_cache = {"k": ck, "v": cv}
            if cfg.attn_backend == "blocked":
                # the valid mask "position <= index" is active_len = index + 1
                out = decode_attention(q, ck, cv, (idx + 1).to(torch.int32))
            else:
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

        prefill: cache=None, tokens ``[b, s]`` -> cache entries sized s.
        decode: cache = list of {k, v, index}, tokens ``[b, 1]``.
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


def init_decode_cache(cfg: LlamaConfig, batch: int, max_len: int, device):
    """Static-shape KV cache for decode (one entry per layer), with a
    per-row ``[batch]`` int32 index."""
    shape = (batch, max_len, cfg.kv_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
             "index": torch.zeros(batch, dtype=torch.int32, device=device)}
            for _ in range(cfg.layers)]


def prefill_into_cache(cfg: LlamaConfig, prefill_cache, batch: int,
                       max_len: int, prompt_len: int):
    """Embed a prefill cache (float entries sized s) at position 0 of a
    static ``max_len`` decode cache."""
    device = prefill_cache[0]["k"].device
    out = init_decode_cache(cfg, batch, max_len, device)
    for dest, entry in zip(out, prefill_cache):
        s = entry["k"].shape[1]
        dest["k"][:, :s] = entry["k"]
        dest["v"][:, :s] = entry["v"]
        dest["index"].fill_(prompt_len)
    return out


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
    """Raw model logprob of ``tok`` under f32 logits ``lg`` ``[b, v]``."""
    return (lg.gather(-1, tok[:, None])[:, 0]
            - torch.logsumexp(lg, dim=-1))


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
                 gens, eos_id, decode_steps: int):
    """The decode loop: emits ``decode_steps`` tokens starting with
    ``first``. Rows latch at ``eos_id`` (``< 0`` = none): after eos a row
    emits eos with logprob 0. ``pos`` is per row. The JAX server scans a
    bucketed number of steps and drops the tokens past the request;
    this loop runs exactly ``decode_steps - 1`` forwards. Returns ``(tokens, logprobs)``, each ``[b, decode_steps]``."""
    has_eos = eos_id >= 0
    tok, lp, pos, done = first, lp0, start, done0
    toks, lps = [tok], [lp]
    for _ in range(decode_steps - 1):
        # the blocks write this step's K/V into the cache in place
        logits, _ = model(tok[:, None], positions=pos[:, None], cache=cache)
        pos = pos + 1
        for entry in cache:
            entry["index"] = pos
        nxt, nlp = select(logits[:, -1, :].float(), gens)
        nxt = torch.where(done, eos_id, nxt)
        nlp = torch.where(done, 0.0, nlp)
        done = done | (has_eos & (nxt == eos_id))
        tok, lp = nxt, nlp
        toks.append(tok)
        lps.append(lp)
    return torch.stack(toks, dim=1), torch.stack(lps, dim=1)


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
        cfg = self.model.cfg
        rows, lengths = self._normalize_prompts(prompt_tokens)
        b, s = len(rows), max(lengths)
        self._validate(s, max_new_tokens)
        if max_new_tokens == 0:
            toks = np.zeros((b, 0), np.int32)
            return (toks, np.zeros((b, 0), np.float32)) if return_logprobs \
                else toks
        steps = min(_next_bucket(max_new_tokens, MIN_BUCKET), cfg.max_len - s)
        sb = min(_next_bucket(s, MIN_BUCKET), cfg.max_len - steps)
        bb = _next_bucket(b, 1)
        cache_len = min(sb + steps, cfg.max_len)
        with self._lock, torch.inference_mode():
            prompt, length = self._pad_rows(rows, lengths, bb, sb)
            temp, tk, tp, gens, eos = self._knob_operands(
                temperature, top_k, top_p, seed, eos_id, b=bb)
            select = _serve_select(temp, tk, tp)
            first, lp0, cache, pos, done = _serve_prefill(
                self.model, prompt, length, select, gens, eos,
                cache_len=cache_len)
            toks, lps = _scan_decode(self.model, select, first, lp0, cache,
                                     pos, done, gens, eos, max_new_tokens)
            toks = toks[:b].to(torch.int32).cpu().numpy()
            if return_logprobs:
                return toks, lps[:b].float().cpu().numpy()
        return toks

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
