"""Model registry of the port: name -> builder, as in
``lambdipy_tpu/models/registry.py``: ``llama3-8b``, ``llama-tiny``,
``llama-hf`` (the architecture of an imported HF checkpoint, from
``extra``) and ``llama-moe-tiny`` (generation), ``resnet50`` and
``resnet50-tiny`` (image classification), ``bert-base`` and
``bert-tiny`` (text classification), ``bert-base-torch`` (the torch
BERT) and ``tabular`` (sklearn), with JAX's arguments and ``extra``
keys; :func:`draft_twin`, the aux draft tier's small Llama; and
:func:`save_init_params`, a bundle's seeded params at build time."""

from __future__ import annotations

import dataclasses
import os
from collections.abc import Callable
from pathlib import Path
from typing import Any

import numpy as np
import torch

from lambdipy_tpu_torch.models import params
from lambdipy_tpu_torch.models.bert import BERT_BASE, BERT_TINY, BertConfig
from lambdipy_tpu_torch.models.llama import (LLAMA3_8B, LLAMA_TINY,
                                             LlamaConfig, LlamaServer)
from lambdipy_tpu_torch.models.resnet import (RESNET50, RESNET_TINY,
                                              ResNetConfig)
from lambdipy_tpu_torch.models.torch_bert import TorchBertConfig
from lambdipy_tpu_torch.parallel.sharding import P, ShardingRules
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

    def make_server(self, state_dict=None, *, device=None, mesh=None,
                    group=None, **server_kw) -> LlamaServer:
        """A Llama's server; ``server_kw``: :class:`LlamaServer`'s
        ``graphs``, ``program_cache_max`` and ``program_cache_bytes``.

        ``mesh``: a serving mesh (a ``parallel/mesh.py`` ``Mesh`` or
        ``{axis: size}``), checked as JAX checks it
        (``models/llama.py validate_serving_mesh``; a ``dp`` axis raises,
        ROADMAP queue 1, item 3 (c2)). At ``tp`` above 1 the server is
        the controller of ``tp`` ranks, one process per device
        (``parallel/tpserve.py serve_tp``), each serving its share of
        ``state_dict``, the whole model's weights (None: seeded); close
        it with ``server.dispatcher.close()``. ``group``: this process is
        one rank of that ``TPGroup`` instead, serving its share of
        ``state_dict``. A one-device mesh serves as no mesh."""
        cfg = self.config
        if not isinstance(cfg, LlamaConfig):
            raise TypeError(f"{type(cfg).__name__} has no server")
        if mesh is None and group is None:
            return LlamaServer(self.make_model(state_dict, device=device),
                               **server_kw)
        from lambdipy_tpu_torch.models.llama import validate_serving_mesh
        from lambdipy_tpu_torch.parallel import tpserve
        from lambdipy_tpu_torch.parallel.mesh import (Mesh, make_mesh,
                                                      serving_mesh)

        if mesh is None:
            mesh = {"tp": group.size}
        shape = serving_mesh(mesh.shape if isinstance(mesh, Mesh) else mesh)
        validate_serving_mesh(cfg, shape)
        tp = shape.get("tp", 1)
        if tp > 1 and cfg.moe_experts:
            from lambdipy_tpu_torch.models.llama import TP_C2

            raise NotImplementedError(TP_C2.format("an MoE Llama"))
        if not isinstance(mesh, Mesh):
            mesh = make_mesh(shape, devices=range(tp))
        if group is not None:
            if group.size != tp:
                raise ValueError(f"a mesh of tp={tp} over a {group.size}-"
                                 "rank group")
            whole = (state_dict if state_dict is not None
                     else self.init_params(seed=0, device=device))
            share = tpserve._share(cfg, whole, mesh, group.rank)
            return tpserve.rank_server(cfg, share, group, mesh,
                                       resolve_device(device), **server_kw)
        if tp > 1:
            return tpserve.serve_tp(cfg, state_dict, mesh, device=device,
                                    **server_kw)
        return LlamaServer(self.make_model(state_dict, device=device),
                           mesh=mesh, **server_kw)

    @property
    def tp_rules(self):
        """JAX's ``tp_rules``: the sharding rules of the model's family
        (:func:`_llama_tp_rules`, :func:`_bert_tp_rules`, none for a
        ResNet), matched on JAX's paths; None for the torch BERT and
        tabular, which JAX builds no rules for."""
        cfg = self.config
        if isinstance(cfg, LlamaConfig):
            return _llama_tp_rules()
        if isinstance(cfg, BertConfig):
            return _bert_tp_rules()
        if isinstance(cfg, ResNetConfig):
            return ShardingRules(rules=())
        return None

    @property
    def forward_with_aux(self):
        """JAX's ``forward_with_aux`` (``registry.py:318-325``): for a
        Llama with ``moe_experts > 0``, ``fn(model, tokens) -> (logits,
        aux)``, the forward and its MoE load-balance loss, for a train
        step to read; None for every other model."""
        cfg = self.config
        if not (isinstance(cfg, LlamaConfig) and cfg.moe_experts):
            return None

        def forward_with_aux(model, tokens):
            logits, _, aux = model(tokens, with_aux=True)
            return logits, aux

        return forward_with_aux

    def _trainable(self) -> torch.nn.Module:
        """The module a train forward runs over: the serving ``LlamaModel``
        built on the meta device (shapes alone), every weight supplied by
        the caller's params. Raises where JAX's training cannot run: int8
        weights (``TypeError``, as ``jax.grad`` raises on int8 inputs) and
        ``attn_backend="flash"`` (the flash kernel has no backward; JAX's
        ``pallas_call`` has none either and its grad fails)."""
        cfg = self.config
        if not isinstance(cfg, LlamaConfig):
            raise TypeError(f"{type(cfg).__name__} has no train forward")
        if cfg.quant == "int8":
            raise TypeError("int8 weights cannot be trained: grad requires "
                            "real-valued inputs, as jax.grad does; train a "
                            "float model and quantize it for serving")
        if cfg.attn_backend == "flash":
            raise NotImplementedError(
                "attn_backend 'flash' has no backward (the flash kernel is "
                "forward-only, as the JAX package's pallas_call is); train "
                "under 'blocked' or 'dense'")
        return params.empty_model(cfg, device="meta")

    @property
    def train_forward(self):
        """JAX's ``forward`` for training: ``fn(params, tokens) ->
        logits``, the serving ``LlamaModel``'s prefill forward run by
        ``torch.func.functional_call`` over ``params`` (a dict keyed as the
        ``state_dict``, :func:`models.params.train_params`; its
        ``routes_tokens`` is true for an MoE model), so autograd
        reaches the tensors in ``params`` and the module keeps its weights
        as buffers. Raises for what cannot train (:meth:`_trainable`)."""
        model = self._trainable()

        def train_forward(weights, tokens):
            return torch.func.functional_call(model, weights, (tokens,))[0]

        # an MoE model routes over the batch it is given: one device only
        # (train/step.py refuse_routing_over_ranks)
        train_forward.routes_tokens = bool(self.config.moe_experts)
        return train_forward

    @property
    def train_forward_with_aux(self):
        """JAX's ``forward_with_aux`` for training: ``fn(params, tokens)
        -> (logits, aux)`` for a Llama with ``moe_experts > 0`` (``aux``
        the MoE layers' balance loss summed), None for a dense model."""
        cfg = self.config
        if not (isinstance(cfg, LlamaConfig) and cfg.moe_experts):
            return None
        model = self._trainable()

        def train_forward_with_aux(weights, tokens):
            logits, _, aux = torch.func.functional_call(
                model, weights, (tokens,), {"with_aux": True})
            return logits, aux

        return train_forward_with_aux


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


def _bert_tp_rules() -> ShardingRules:
    """JAX's ``_bert_tp_rules`` (``registry.py:139``), glob for glob."""
    return ShardingRules(rules=(
        ("*attn/query/kernel", P(None, "tp", None)),
        ("*attn/key/kernel", P(None, "tp", None)),
        ("*attn/value/kernel", P(None, "tp", None)),
        ("*attn/out/kernel", P("tp", None, None)),
        ("*mlp_in/kernel", P(None, "tp")),
        ("*mlp_out/kernel", P("tp", None)),
    ))


def _llama_tp_rules() -> ShardingRules:
    """JAX's ``_llama_tp_rules`` (``registry.py:201``), glob for glob:
    heads, MLP and vocabulary over ``tp``, MoE experts over ``ep`` (their
    hidden dim over ``tp``), the router replicated; a trailing ``*``
    covers the int8 layout (``kernel_int8`` shards as its float
    original)."""
    return ShardingRules(rules=(
        ("*embed/embedding", P("tp", None)),
        ("*o_proj/kernel*", P("tp", None)),
        ("*down_proj/kernel*", P("tp", None)),
        ("*o_proj/scale", P()),
        ("*down_proj/scale", P()),
        ("*_proj/kernel*", P(None, "tp")),  # q/k/v/gate/up
        ("*_proj/scale", P(None, "tp")),
        ("*lm_head/kernel*", P(None, "tp")),
        ("*lm_head/scale", P(None, "tp")),
        ("*moe/experts_gate*", P("ep", None, "tp")),
        ("*moe/experts_up*", P("ep", None, "tp")),
        ("*moe/experts_down_int8", P("ep", "tp", None)),
        ("*moe/experts_down_scale", P("ep", None, None)),
        ("*moe/experts_down", P("ep", "tp", None)),
        ("*moe/router", P()),
    ))


_ATTN_BACKENDS = ("blocked", "dense", "flash")
_UNPORTED_ATTN_BACKENDS = ("ring",)
_MATMUL_BACKENDS = ("pallas", "xla")
_KV_QUANTS = (None, "int8")
# the fields of the JAX package's LlamaConfig (``llama.py:28-86``), held
# against it by tests/test_torch_moe.py: an extra naming one the port's
# config lacks raises, and an extra naming none of them is ignored, as JAX
# ignores it
JAX_LLAMA_FIELDS = (
    "vocab_size", "hidden", "layers", "heads", "kv_heads", "mlp", "max_len",
    "rope_theta", "rope_scaling", "norm_eps", "dtype", "quant", "kv_quant",
    "attn_backend", "moe_experts", "moe_top_k", "moe_capacity_factor",
    "moe_group_size", "matmul_backend")


def _llama_overrides(extra: dict | None) -> dict:
    """Filter ``extra`` down to LlamaConfig fields, coerce recipe strings
    by the field's annotation (``kv_quant="int8"`` stays a string), and
    validate the backend and ``kv_quant`` knobs: a misspelled or unported
    value raises instead of serving another path, and so does a field of
    the JAX config that the port's lacks (:data:`JAX_LLAMA_FIELDS`)."""
    extra = dict(extra or {})
    annotations = {f.name: f.type for f in dataclasses.fields(LlamaConfig)}
    unported = sorted(k for k in extra
                      if k in JAX_LLAMA_FIELDS and k not in annotations)
    if unported:
        raise ValueError(f"LlamaConfig field(s) {unported} are not ported "
                         "yet; the port would serve another model")
    if extra.get("rope_scaling"):
        if isinstance(extra["rope_scaling"], str):
            raise ValueError("rope_scaling cannot be given as a string")
        extra["rope_scaling"] = tuple(extra["rope_scaling"])

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


@register("llama-hf", "Llama with the architecture of an imported HF "
          "checkpoint")
def _build_llama_hf(dtype: str = "bfloat16", quant: str | None = None,
                    extra: dict | None = None) -> TorchModel:
    """Every architecture field comes from ``extra``: a bundle's
    ``params_info.config``, written by ``models/convert.py
    save_hf_params``, so the model fits the converted weights."""
    return TorchModel(LlamaConfig(dtype=_dtype(dtype), quant=quant,
                                  **_llama_overrides(extra)))


@register("llama-moe-tiny", "tiny MoE Llama for tests and dry runs")
def _build_llama_moe_tiny(dtype: str = "float32", quant: str | None = None,
                          extra: dict | None = None) -> TorchModel:
    extra = dict(extra or {})
    extra.setdefault("moe_experts", 4)
    return TorchModel(dataclasses.replace(
        LLAMA_TINY, dtype=_dtype(dtype), quant=quant,
        **_llama_overrides(extra)))


@register("llama-tiny", "tiny Llama for tests and dry runs")
def _build_llama_tiny(dtype: str = "float32", quant: str | None = None,
                      extra: dict | None = None) -> TorchModel:
    return TorchModel(dataclasses.replace(
        LLAMA_TINY, dtype=_dtype(dtype), quant=quant,
        **_llama_overrides(extra)))


def draft_twin(adapter: TorchModel, *, layers: int = 2,
               hidden: int | None = None, seed: int = 0, params=None,
               mesh=None, device=None, **caps) -> LlamaServer:
    """A small same-family draft server for the aux draft tier (JAX
    ``registry.py:401-450``): a ``LlamaServer`` over a shrunken copy of
    ``adapter``'s config: the same vocabulary (drafts are token ids of the
    target's), ``layers`` layers, optionally a narrower ``hidden`` (the
    head count scales so the head dim stays the target's), and ``quant``
    and ``kv_quant`` off (the twin serves float: its decode takes the
    float decode-attention kernel under ``blocked``, its projections no
    int8 kernel). ``params`` None draws the twin's weights from ``seed``
    on ``device``; a deployment passes distilled weights (a JAX twin's
    through ``models/params.py from_jax_params``). Wrap the server in
    :class:`~lambdipy_tpu_torch.runtime.continuous.AuxModelDraft` and hand
    it to the engine as ``draft_provider`` with ``draft_mode="aux"``.
    ``caps`` go to the server (e.g. ``prefix_cache_max``). A ``mesh``
    raises: a serving mesh is tensor parallelism (ROADMAP queue 1, item 3
    (c))."""
    cfg = adapter.config
    if not isinstance(cfg, LlamaConfig):
        raise ModelError("draft_twin needs a llama-family adapter "
                         "(adapter.config must be a LlamaConfig)")
    if mesh is not None:
        raise ValueError("draft_twin: a serving mesh is tensor "
                         "parallelism, not ported yet (ROADMAP queue 1, "
                         "item 3 (c))")
    overrides: dict[str, Any] = {
        "layers": max(1, min(int(layers), cfg.layers)),
        "quant": None, "kv_quant": None}
    if hidden is not None:
        head_dim = max(1, cfg.hidden // cfg.heads)
        heads = max(1, int(hidden) // head_dim)
        overrides.update(hidden=heads * head_dim, heads=heads,
                         kv_heads=max(1, min(cfg.kv_heads, heads)),
                         mlp=2 * heads * head_dim)
    twin = TorchModel(dataclasses.replace(cfg, **overrides))
    if params is None:
        params = twin.init_params(seed=seed, device=device)
    return twin.make_server(params, device=device, **caps)


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


# ----------------------------------------------------------------------
# build time: a bundle's params (JAX registry.py:580-634)


def save_init_params(model: str, params_dir: Path, *, dtype: str = "bfloat16",
                     quant: str | None = None, extra: dict | None = None,
                     seed: int = 0, params_format: str = "both",
                     device=None) -> dict:
    """Seeded random weights of ``model`` saved into a bundle's params
    directory, the twin of JAX's ``save_init_params``; returns the info
    recorded in the manifest (JAX's keys), also written to
    ``info.json``.

    The flax families go to ``params.fpk`` (the flax tree,
    ``params.to_flax_tree``, through ``bundle/flatpack.save``): with
    ``params_format`` ``"both"`` or ``"fpk"`` alike, recorded as
    ``"fpk"``, since the card's host has no orbax; ``"orbax"`` raises.
    The torch BERT goes to ``model.pt``, tabular to ``model.joblib``.
    The weights are made on ``device`` (the card by default: an 8B init
    on the CPU takes minutes), recorded as ``init_device`` (the card's
    and the CPU's generators draw other values from one seed), and that
    memory is freed before this returns, so the build's warm process
    finds the card free."""
    if params_format == "orbax":
        raise ValueError(
            f"model {model}: params_format 'orbax' cannot be built by the "
            "port: its host has no orbax, and the port reads params.fpk "
            "alone; use 'fpk' or 'both' (which writes params.fpk)")
    if params_format not in ("both", "fpk"):
        raise ValueError(f"model {model}: unknown params_format "
                         f"{params_format!r}; supported: 'both', 'fpk'")
    import json

    from lambdipy_tpu_torch.bundle import flatpack

    adapter = get(model).build(dtype=dtype, quant=quant, extra=extra)
    cfg = adapter.config
    params_dir = Path(params_dir)
    params_dir.mkdir(parents=True, exist_ok=True)
    if isinstance(cfg, params.TabularConfig):
        import joblib

        joblib.dump(adapter.init_params(seed=seed),
                    params_dir / "model.joblib")
        info = {"format": "joblib", "n_features": cfg.n_features,
                "init_device": "cpu"}
    else:
        device = resolve_device(device)
        state_dict = adapter.init_params(seed=seed, device=device)
        n_params = sum(t.numel() for t in state_dict.values())
        if isinstance(cfg, TorchBertConfig):
            torch.save({k: v.cpu() for k, v in state_dict.items()},
                       params_dir / "model.pt")
            # torch.nn's own init, drawn on the host (params.init_params)
            info = {"format": "torch", "n_params": n_params,
                    "init_device": "cpu"}
        else:
            flatpack.save(params_dir / "params.fpk",
                          params.to_flax_tree(cfg, state_dict))
            info = {"format": "fpk", "n_params": n_params, "seed": seed,
                    # JAX casts f32 kernels to the serving dtype when a
                    # forward proves it inert; the port's init already
                    # makes every leaf in the dtype its model holds
                    "serving_cast": {"applied": False,
                                     "reason": "made in the model's dtypes"},
                    # one seed draws other values on the card and on the
                    # CPU: where these were drawn
                    "init_device": device.type}
        del state_dict
        if device.type == "cuda":
            torch.cuda.empty_cache()
    (params_dir / "info.json").write_text(json.dumps({"model": model,
                                                       **info}))
    return info
