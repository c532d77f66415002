"""Torch BERT-base classifier, the port's copy of
``lambdipy_tpu/models/torch_bert.py`` (BASELINE.json config 4, "pytorch
recipe"): the same stock ``torch.nn`` blocks and module names, so a
bundle's ``model.pt`` ``state_dict`` fits it as it is. The JAX package
moves it to a torch-xla device when there is one and degrades to the CPU
otherwise; the port runs it on the card (``utils/platform.py
resolve_device``), on the CPU only when the caller asks."""

from __future__ import annotations

import dataclasses

import torch
from torch import nn


class TorchBertClassifier(nn.Module):
    def __init__(self, vocab_size: int = 30522, hidden: int = 768,
                 layers: int = 12, heads: int = 12, max_len: int = 128,
                 num_classes: int = 2, mlp_ratio: int = 4):
        super().__init__()
        self.max_len = max_len
        self.tok_emb = nn.Embedding(vocab_size, hidden)
        self.pos_emb = nn.Embedding(max_len, hidden)
        self.emb_ln = nn.LayerNorm(hidden, eps=1e-12)
        layer = nn.TransformerEncoderLayer(
            d_model=hidden, nhead=heads, dim_feedforward=hidden * mlp_ratio,
            activation="gelu", batch_first=True, norm_first=False)
        self.encoder = nn.TransformerEncoder(layer, num_layers=layers)
        self.pooler = nn.Linear(hidden, hidden)
        self.classifier = nn.Linear(hidden, num_classes)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor | None = None) -> torch.Tensor:
        b, s = input_ids.shape
        pos = torch.arange(s, device=input_ids.device).unsqueeze(0)
        x = self.emb_ln(self.tok_emb(input_ids) + self.pos_emb(pos))
        pad_mask = None
        if attention_mask is not None:
            pad_mask = attention_mask == 0  # True = ignore
        x = self.encoder(x, src_key_padding_mask=pad_mask)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return self.classifier(pooled)


@dataclasses.dataclass(frozen=True)
class TorchBertConfig:
    """:class:`TorchBertClassifier`'s arguments (the registry's ``extra``
    keys), f32 as in the JAX package."""

    vocab_size: int = 30522
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    max_len: int = 128
    num_classes: int = 2
