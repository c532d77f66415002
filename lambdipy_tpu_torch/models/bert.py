"""BERT encoder and classification head in PyTorch, the twin of
``lambdipy_tpu/models/bert.py``: module names, layouts and rounding
follow it, so the two can be held against each other on the same
weights (``models/params.py from_jax_params``).

- Every weight keeps its flax layout: ``DenseGeneral`` kernels are
  ``[hidden, heads, head_dim]`` for ``query``, ``key`` and ``value`` and
  ``[heads, head_dim, hidden]`` for ``out`` (viewed 2-D for the matmul),
  dense kernels ``[in, out]``.
- A layer computes in its dtype and rounds where the flax layer does:
  each product is rounded before its bias is added; the three embeddings
  are added in the model dtype, then the f32 ``emb_ln``; attention
  logits are the dtype's product taken to f32, scaled by ``1/sqrt(d)``,
  masked with -1e9, an f32 softmax, the probabilities cast to the dtype
  before PV; LayerNorm is f32 with eps 1e-12 and its output cast back;
  GELU is exact (erf); the pooler is tanh over ``[CLS]`` and the
  classifier f32.
- Attention is plain PyTorch, as the JAX model's is plain einsum and
  softmax (no Pallas kernel, no fused path): the port's flash kernel
  takes no padding mask.

Weights are buffers: the port serves, it does not train.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from lambdipy_tpu_torch.utils.platform import resolve_device

NEG_INF = -1e9  # attention mask fill, as in the JAX model
LN_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    mlp: int = 3072
    max_len: int = 512
    type_vocab: int = 2
    num_classes: int = 2
    dtype: Any = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads


BERT_BASE = BertConfig()
BERT_TINY = BertConfig(vocab_size=1024, hidden=32, layers=2, heads=2,
                       mlp=64, max_len=64, num_classes=2)


class Embed(nn.Module):
    def __init__(self, n: int, dim: int, dtype, device=None):
        super().__init__()
        self.register_buffer("embedding", torch.empty(
            n, dim, dtype=dtype, device=device))

    def forward(self, ids):
        return F.embedding(ids, self.embedding)


class Dense(nn.Module):
    """flax ``nn.Dense`` / ``nn.DenseGeneral`` over the input's last
    ``len(in_dims)`` axes: ``kernel`` ``[*in_dims, *out_dims]``, ``bias``
    ``[*out_dims]``, in ``dtype`` (the input cast to it). The product is
    rounded to ``dtype`` before the bias is added, as in flax."""

    def __init__(self, in_dims: tuple, out_dims: tuple, dtype, device=None):
        super().__init__()
        self.in_dims, self.out_dims = tuple(in_dims), tuple(out_dims)
        self.n_in, self.n_out = math.prod(in_dims), math.prod(out_dims)
        self.dtype = dtype
        self.register_buffer("kernel", torch.empty(
            *in_dims, *out_dims, dtype=dtype, device=device))
        self.register_buffer("bias", torch.empty(
            *out_dims, dtype=dtype, device=device))

    def forward(self, x):
        lead = x.shape[:x.dim() - len(self.in_dims)]
        y = x.to(self.dtype).reshape(*lead, self.n_in) @ \
            self.kernel.reshape(self.n_in, self.n_out)
        y = y + self.bias.reshape(self.n_out)
        return y.reshape(*lead, *self.out_dims)


class LayerNorm(nn.Module):
    """f32 LayerNorm (eps 1e-12, f32 ``scale`` and ``bias``); the result
    stays f32, the caller casts it back."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        for name in ("scale", "bias"):
            self.register_buffer(name, torch.empty(
                dim, dtype=torch.float32, device=device))

    def forward(self, x):
        return F.layer_norm(x.float(), (x.shape[-1],), self.scale,
                            self.bias, LN_EPS)


class SelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        hd = (cfg.heads, cfg.head_dim)
        for name in ("query", "key", "value"):
            self.add_module(name, Dense((cfg.hidden,), hd, cfg.dtype, device))
        self.out = Dense(hd, (cfg.hidden,), cfg.dtype, device)

    def forward(self, x, mask):
        """``x`` ``[b, s, hidden]``, ``mask`` ``[b, s]`` bool (True =
        attend)."""
        q = self.query(x).transpose(1, 2)  # [b, h, s, d]
        k = self.key(x).transpose(1, 2)
        v = self.value(x).transpose(1, 2)
        logits = (q @ k.transpose(-1, -2)).float()
        logits = logits / math.sqrt(self.cfg.head_dim)
        logits = logits.masked_fill(~mask[:, None, None, :], NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(self.cfg.dtype)
        return self.out((probs @ v).transpose(1, 2))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.dtype = cfg.dtype
        self.attn = SelfAttention(cfg, device)
        self.ln_attn = LayerNorm(cfg.hidden, device)
        self.mlp_in = Dense((cfg.hidden,), (cfg.mlp,), cfg.dtype, device)
        self.mlp_out = Dense((cfg.mlp,), (cfg.hidden,), cfg.dtype, device)
        self.ln_mlp = LayerNorm(cfg.hidden, device)

    def forward(self, x, mask):
        x = self.ln_attn(x + self.attn(x, mask)).to(self.dtype)
        y = self.mlp_out(F.gelu(self.mlp_in(x)))  # exact (erf) GELU
        return self.ln_mlp(x + y).to(self.dtype)


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.tok_emb = Embed(cfg.vocab_size, cfg.hidden, cfg.dtype, device)
        self.pos_emb = Embed(cfg.max_len, cfg.hidden, cfg.dtype, device)
        self.type_emb = Embed(cfg.type_vocab, cfg.hidden, cfg.dtype, device)
        self.emb_ln = LayerNorm(cfg.hidden, device)
        for i in range(cfg.layers):
            self.add_module(f"layer_{i}", EncoderLayer(cfg, device))

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        b, s = input_ids.shape
        dev = input_ids.device
        if attention_mask is None:
            attention_mask = torch.ones(b, s, dtype=torch.bool, device=dev)
        mask = attention_mask.bool()
        if token_type_ids is None:
            token_type_ids = torch.zeros(b, s, dtype=torch.long, device=dev)
        emb = self.tok_emb(input_ids)
        emb = emb + self.pos_emb(torch.arange(s, device=dev))[None]
        emb = emb + self.type_emb(token_type_ids)
        x = self.emb_ln(emb).to(self.cfg.dtype)
        for i in range(self.cfg.layers):
            x = getattr(self, f"layer_{i}")(x, mask)
        return x


class BertClassifier(nn.Module):
    """``device`` defaults to the card and raises when there is none."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.encoder = BertEncoder(cfg, self.device)
        self.pooler = Dense((cfg.hidden,), (cfg.hidden,), cfg.dtype,
                            self.device)
        self.classifier = Dense((cfg.hidden,), (cfg.num_classes,),
                                torch.float32, self.device)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        """``input_ids`` ``[b, s]`` -> f32 logits ``[b, num_classes]``."""
        x = self.encoder(input_ids, attention_mask, token_type_ids)
        pooled = torch.tanh(self.pooler(x[:, 0]))  # [CLS] pooling
        return self.classifier(pooled)
