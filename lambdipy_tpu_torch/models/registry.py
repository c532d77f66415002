"""Model registry of the port: name -> builder, as in
``lambdipy_tpu/models/registry.py``: ``llama3-8b`` and ``llama-tiny``
(generation), ``resnet50`` and ``resnet50-tiny`` (image classification),
``bert-base`` and ``bert-tiny`` (text classification), ``bert-base-torch``
(the torch BERT) and ``tabular`` (sklearn), with JAX's arguments and
``extra`` keys."""

from __future__ import annotations

import dataclasses
import os
from collections.abc import Callable
from pathlib import Path
from typing import Any

import numpy as np
import torch

from lambdipy_tpu_torch.models import params
from lambdipy_tpu_torch.models.bert import BERT_BASE, BERT_TINY
from lambdipy_tpu_torch.models.llama import (LLAMA3_8B, LLAMA_TINY,
                                             LlamaConfig, LlamaServer)
from lambdipy_tpu_torch.models.resnet import (RESNET50, RESNET_TINY,
                                              ResNetConfig)
from lambdipy_tpu_torch.models.torch_bert import TorchBertConfig
from lambdipy_tpu_torch.utils.platform import resolve_device


class ModelError(KeyError):
    pass


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    build: Callable
    description: str = ""


@dataclasses.dataclass(frozen=True)
class TorchModel:
    """What a builder returns, one shape for every family: the config
    (``LlamaConfig``, ``ResNetConfig``, ``BertConfig``,
    ``TorchBertConfig`` or ``params.TabularConfig``), and the ways to make
    its example batch, weights and a model from it (``models/params.py``).
    ``device`` defaults to the card. A Llama also makes a server."""

    config: Any

    def example_batch(self, batch_size: int = 1, device=None) -> tuple:
        """The inputs a serving program is built for, as JAX's
        ``example_batch``: zero images ``[b, size, size, 3]`` in the
        model dtype; zero token ids and an all-ones mask ``[b, max_len]``;
        zero tokens ``[b, 16]`` for a Llama; zero features (a host array)
        for tabular."""
        cfg = self.config
        if isinstance(cfg, params.TabularConfig):
            return (np.zeros((batch_size, cfg.n_features)),)
        device = resolve_device(device)
        if isinstance(cfg, ResNetConfig):
            size = cfg.image_size
            return (torch.zeros(batch_size, size, size, 3, dtype=cfg.dtype,
                                device=device),)
        if isinstance(cfg, LlamaConfig):
            return (torch.zeros(batch_size, 16, dtype=torch.long,
                                device=device),)
        shape = (batch_size, cfg.max_len)
        return (torch.zeros(shape, dtype=torch.long, device=device),
                torch.ones(shape, dtype=torch.long, device=device))

    def init_params(self, seed: int = 0, device=None):
        return params.init_params(self.config, seed, device)

    def load_params(self, params_dir: Path, device=None):
        return params.load_params(params_dir, self.config, device)

    def make_model(self, state_dict=None, *, device=None):
        return params.build_model(self.config, state_dict, device=device)

    def make_server(self, state_dict=None, *, device=None,
                    **server_kw) -> LlamaServer:
        """A Llama's server; ``server_kw``: :class:`LlamaServer`'s
        ``graphs``, ``program_cache_max`` and ``program_cache_bytes``."""
        if not isinstance(self.config, LlamaConfig):
            raise TypeError(f"{type(self.config).__name__} has no server")
        return LlamaServer(self.make_model(state_dict, device=device),
                           **server_kw)


_MODELS: dict[str, ModelSpec] = {}


def register(name: str, description: str = ""):
    def deco(fn):
        _MODELS[name] = ModelSpec(name=name, build=fn,
                                  description=description)
        return fn
    return deco


def get(name: str) -> ModelSpec:
    try:
        return _MODELS[name]
    except KeyError:
        raise ModelError(
            f"unknown model {name!r}; registered: {sorted(_MODELS)}") from None


def _dtype(name: str):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


_ATTN_BACKENDS = ("blocked", "dense", "flash")
_UNPORTED_ATTN_BACKENDS = ("ring",)
_MATMUL_BACKENDS = ("pallas", "xla")
_KV_QUANTS = (None, "int8")


def _llama_overrides(extra: dict | None) -> dict:
    """Filter ``extra`` down to LlamaConfig fields, coerce recipe strings
    by the field's annotation (``kv_quant="int8"`` stays a string), and
    validate the backend and ``kv_quant`` knobs: a misspelled or unported
    value raises instead of serving another path."""
    extra = dict(extra or {})
    if extra.get("rope_scaling"):
        if isinstance(extra["rope_scaling"], str):
            raise ValueError("rope_scaling cannot be given as a string")
        extra["rope_scaling"] = tuple(extra["rope_scaling"])
    annotations = {f.name: f.type for f in dataclasses.fields(LlamaConfig)}

    def coerce(name: str, v):
        if isinstance(v, str):
            t = annotations.get(name)
            if t == "int":
                return int(v)
            if t == "float":
                return float(v)
        return v

    out = {k: coerce(k, v) for k, v in extra.items()
           if k in set(annotations) - {"dtype", "quant"}}
    # the operator's backend switch (JAX registry.py:275-282): an explicit
    # extra wins over LAMBDIPY_ATTN_BACKEND
    env_backend = os.environ.get("LAMBDIPY_ATTN_BACKEND")
    if env_backend and "attn_backend" not in out:
        out["attn_backend"] = env_backend
    attn = out.get("attn_backend", LlamaConfig.attn_backend)
    if attn in _UNPORTED_ATTN_BACKENDS:
        raise ValueError(f"attn_backend {attn!r} is not ported yet; "
                         f"supported: {_ATTN_BACKENDS}")
    if attn not in _ATTN_BACKENDS:
        raise ValueError(f"unknown attn_backend {attn!r}; "
                         f"supported: {_ATTN_BACKENDS}")
    if out.get("matmul_backend", LlamaConfig.matmul_backend) \
            not in _MATMUL_BACKENDS:
        raise ValueError(f"unknown matmul_backend {out['matmul_backend']!r}; "
                         f"supported: {_MATMUL_BACKENDS}")
    if out.get("kv_quant") not in _KV_QUANTS:
        raise ValueError(f"unknown kv_quant {out['kv_quant']!r}; "
                         "supported: int8 (or omit for the float cache)")
    return out


@register("llama3-8b", "Llama-3-8B, int8 weights by default")
def _build_llama3_8b(dtype: str = "bfloat16", quant: str | None = "int8",
                     extra: dict | None = None) -> TorchModel:
    return TorchModel(dataclasses.replace(
        LLAMA3_8B, dtype=_dtype(dtype), quant=quant,
        **_llama_overrides(extra)))


@register("llama-tiny", "tiny Llama for tests and dry runs")
def _build_llama_tiny(dtype: str = "float32", quant: str | None = None,
                      extra: dict | None = None) -> TorchModel:
    return TorchModel(dataclasses.replace(
        LLAMA_TINY, dtype=_dtype(dtype), quant=quant,
        **_llama_overrides(extra)))


# ----------------------------------------------------------------------
# the classify families (BASELINE.json configs 2-4); builders take the
# JAX registry's arguments and extra keys (registry.py:93-198, :459-505)


@register("resnet50", "ResNet-50 image classifier (config 3)")
def _build_resnet50(dtype: str = "bfloat16", quant: str | None = None,
                    extra: dict | None = None) -> TorchModel:
    extra = extra or {}
    return TorchModel(dataclasses.replace(
        RESNET50, dtype=_dtype(dtype),
        num_classes=int(extra.get("num_classes", 1000)),
        image_size=int(extra.get("image_size", 224))))


@register("resnet50-tiny", "tiny ResNet for tests and dry runs")
def _build_resnet_tiny(dtype: str = "float32", quant: str | None = None,
                       extra: dict | None = None) -> TorchModel:
    return TorchModel(dataclasses.replace(RESNET_TINY, dtype=_dtype(dtype)))


@register("bert-base", "BERT-base text classifier (config 4)")
def _build_bert_base(dtype: str = "bfloat16", quant: str | None = None,
                     extra: dict | None = None) -> TorchModel:
    extra = extra or {}
    return TorchModel(dataclasses.replace(
        BERT_BASE, dtype=_dtype(dtype),
        max_len=int(extra.get("max_len", 128)),
        num_classes=int(extra.get("num_classes", 2))))


@register("bert-tiny", "tiny BERT for tests and dry runs")
def _build_bert_tiny(dtype: str = "float32", quant: str | None = None,
                     extra: dict | None = None) -> TorchModel:
    return TorchModel(dataclasses.replace(BERT_TINY, dtype=_dtype(dtype)))


@register("tabular", "sklearn tabular classifier (config 2)")
def _build_tabular(dtype: str = "float32", quant: str | None = None,
                   extra: dict | None = None) -> TorchModel:
    extra = extra or {}
    return TorchModel(params.TabularConfig(
        n_features=int(extra.get("n_features", 16))))


@register("bert-base-torch", "torch BERT-base, f32 (config 4, torch path)")
def _build_bert_torch(dtype: str = "float32", quant: str | None = None,
                      extra: dict | None = None) -> TorchModel:
    extra = extra or {}
    return TorchModel(TorchBertConfig(**{
        f.name: int(extra.get(f.name, f.default))
        for f in dataclasses.fields(TorchBertConfig)}))
