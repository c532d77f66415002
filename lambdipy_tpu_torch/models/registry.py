"""Model registry of the port: name -> builder, as in
``lambdipy_tpu/models/registry.py``. Only the Llama builders on the
ported serving path exist so far (``llama3-8b``, ``llama-tiny``)."""

from __future__ import annotations

import dataclasses
import os
from collections.abc import Callable

import torch

from lambdipy_tpu_torch.models.llama import (LLAMA3_8B, LLAMA_TINY,
                                             LlamaConfig, LlamaServer)
from lambdipy_tpu_torch.models.params import build_model, init_params


class ModelError(KeyError):
    pass


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    build: Callable
    description: str = ""


@dataclasses.dataclass(frozen=True)
class TorchModel:
    """What a builder returns: the config and the ways to make weights,
    a model and a server from it. ``device`` defaults to the card."""

    config: LlamaConfig

    def init_params(self, seed: int = 0, device=None) -> dict:
        return init_params(self.config, seed, device)

    def make_model(self, state_dict=None, *, device=None):
        return build_model(self.config, state_dict, device=device)

    def make_server(self, state_dict=None, *, device=None,
                    **server_kw) -> LlamaServer:
        """``server_kw``: :class:`LlamaServer`'s ``graphs``,
        ``program_cache_max`` and ``program_cache_bytes``."""
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
