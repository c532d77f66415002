"""Weights for the port's models, one config type per family:
:class:`~lambdipy_tpu_torch.models.llama.LlamaConfig` (``LlamaModel``),
:class:`~lambdipy_tpu_torch.models.resnet.ResNetConfig` (``ResNet``),
:class:`~lambdipy_tpu_torch.models.bert.BertConfig` (``BertClassifier``),
:class:`~lambdipy_tpu_torch.models.torch_bert.TorchBertConfig`
(``TorchBertClassifier``) and :class:`TabularConfig` (a fitted sklearn
estimator).

``from_jax_params`` maps a flax variables tree (numpy leaves) onto the
port's ``state_dict``; ``load_params`` reads a bundle's params onto the
device (``params.fpk`` for the flax families, ``model.pt`` for the torch
BERT, ``model.joblib`` for tabular); ``init_params`` makes seeded random
weights directly on the device, with the magnitudes of the JAX
package's random init, for runs that have no checkpoint. The flax and
the port's layouts differ only in convolution kernels
(:func:`to_torch_layout`, :func:`to_flax_tree`); every other weight keeps
its flax layout and its flax path as its key.
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path

import numpy as np
import torch

from lambdipy_tpu_torch.models import bert, resnet
from lambdipy_tpu_torch.models.llama import LlamaConfig, LlamaModel
from lambdipy_tpu_torch.models.moe import EXPERT_KEYS
from lambdipy_tpu_torch.models.torch_bert import (TorchBertClassifier,
                                                  TorchBertConfig)
from lambdipy_tpu_torch.utils.platform import resolve_device

# flax variable collections: a key's leading component when the tree
# holds more than ``params`` (a ResNet's ``batch_stats``)
COLLECTIONS = ("params", "batch_stats")
# the ResNet batch-norm leaves flax keeps in ``batch_stats``
_BATCH_STATS = ("mean", "var")


@dataclasses.dataclass(frozen=True)
class TabularConfig:
    """The sklearn tabular classifier of BASELINE.json config 2: its
    weights are a fitted estimator, its input ``n_features`` floats."""

    n_features: int = 16


def _to_tensor(arr) -> torch.Tensor:
    if torch.is_tensor(arr):  # a converted checkpoint's leaves (convert.py)
        return arr
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the bits
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def port_key(key: str) -> str:
    """A flax path joined by ``.`` as the port's key: a leading variable
    collection dropped (``batch_stats.stem_bn.mean`` -> ``stem_bn.mean``)."""
    head, _, rest = key.partition(".")
    return rest if head in COLLECTIONS and rest else key


def to_torch_layout(key: str, t: torch.Tensor) -> torch.Tensor:
    """A flax leaf in the port's layout: a convolution kernel (a 4-D
    ``kernel``) from flax's ``[kh, kw, in, out]`` to torch's ``[out, in,
    kh, kw]``; every other leaf as it is."""
    if key.rsplit(".", 1)[-1] == "kernel" and t.dim() == 4:
        return t.permute(3, 2, 0, 1).contiguous()
    return t


def to_flax_tree(cfg, state_dict: dict) -> dict:
    """The inverse of :func:`from_jax_params`: a port ``state_dict`` as the
    flax variables tree the JAX builder writes (``{"params": ...}``, and
    ``"batch_stats"`` for a ResNet), convolution kernels back in flax's
    layout. Leaves stay the given tensors (or permuted views of them)."""
    tree: dict = {}
    for key, t in state_dict.items():
        *parents, leaf = key.split(".")
        collection = ("batch_stats" if isinstance(cfg, resnet.ResNetConfig)
                      and leaf in _BATCH_STATS else "params")
        if leaf == "kernel" and t.dim() == 4:
            t = t.permute(2, 3, 1, 0)
        node = tree.setdefault(collection, {})
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = t
    return tree


def from_jax_params(tree) -> dict[str, torch.Tensor]:
    """Flax variables (``{"params": {...}}``, ``{"params": ...,
    "batch_stats": ...}`` or the inner dict; numpy, array-like or torch
    leaves, the last kept as they are) -> ``state_dict`` of tensors (numpy
    leaves become CPU tensors). Keys are the flax paths joined by
    ``.`` with the collection dropped (``layer_0/q_proj/kernel_int8`` ->
    ``layer_0.q_proj.kernel_int8``); convolution kernels are mapped to
    torch's layout (:func:`to_torch_layout`), every other leaf keeps its
    flax layout (dense kernels ``[in, out]``)."""
    out = {}

    def walk(node, prefix):
        for name, val in node.items():
            key = f"{prefix}{name}"
            if isinstance(val, dict):
                walk(val, key + ".")
            else:
                out[key] = _to_tensor(val)

    walk(tree, "")
    if all(k.partition(".")[0] in COLLECTIONS for k in out):
        out = {port_key(k): v for k, v in out.items()}
    return {k: to_torch_layout(k, v) for k, v in out.items()}


def empty_model(cfg, device=None) -> torch.nn.Module:
    """A model of ``cfg`` on ``device`` with its weights unset (on the
    ``"meta"`` device: shapes and dtypes alone)."""
    if isinstance(cfg, LlamaConfig):
        return LlamaModel(cfg, device=device)
    if isinstance(cfg, resnet.ResNetConfig):
        return resnet.ResNet(cfg, device)
    if isinstance(cfg, bert.BertConfig):
        return bert.BertClassifier(cfg, device)
    if isinstance(cfg, TorchBertConfig):
        with torch.device(resolve_device(device)):
            return TorchBertClassifier(**dataclasses.asdict(cfg))
    raise TypeError(f"no torch model for {type(cfg).__name__}")


def _fit(cfg: TabularConfig, seed: int):
    """The JAX registry's ``make_fitted``: a gradient-boosted classifier
    on seeded synthetic data."""
    from sklearn.ensemble import GradientBoostingClassifier

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(256, cfg.n_features))
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(int)
    clf = GradientBoostingClassifier(n_estimators=20, max_depth=3,
                                     random_state=seed)
    return clf.fit(X, y)


def _fits(where, state_dict: dict, want: dict) -> dict:
    """``state_dict`` checked against ``want`` (a meta model's): keys and
    shapes must be the model's, and a leaf of another float type (the JAX
    builder's ``serving_cast``) is cast to the model's."""
    from lambdipy_tpu_torch.bundle.format import BundleError

    missing = sorted(set(want) - set(state_dict))
    unexpected = sorted(set(state_dict) - set(want))
    if missing or unexpected:
        raise BundleError(f"{where} does not fit the model: missing "
                          f"{missing[:5]}, unexpected {unexpected[:5]}")
    for key, ref in want.items():
        t = state_dict[key]
        if tuple(t.shape) != tuple(ref.shape):
            raise BundleError(f"{where}: {key} has shape {tuple(t.shape)}, "
                              f"the model {tuple(ref.shape)}")
        if t.dtype != ref.dtype:
            state_dict[key] = t.to(ref.dtype)
    return state_dict


def load_params(params_dir: Path, cfg, device=None):
    """A bundle's params as the weights of a model of ``cfg``, on
    ``device`` (the card by default), the twin of JAX's
    ``registry.load_params``: ``params/params.fpk`` for the flax families
    (its keys and shapes must be the model's once the collection is
    dropped and convolution kernels mapped; a leaf the JAX builder stored
    in another float type, its ``serving_cast``, is cast to the model's),
    ``model.pt`` for the torch BERT and ``model.joblib`` (the fitted
    estimator, on the host) for tabular. A params directory with only an
    ``orbax/`` checkpoint raises: the port reads flatpack alone."""
    from lambdipy_tpu_torch.bundle import flatpack
    from lambdipy_tpu_torch.bundle.format import BundleError

    params_dir = Path(params_dir)
    if isinstance(cfg, TabularConfig):
        import joblib

        return joblib.load(params_dir / "model.joblib")
    want = empty_model(cfg, device="meta").state_dict()
    if isinstance(cfg, TorchBertConfig):
        pt = params_dir / "model.pt"
        return _fits(pt, torch.load(pt, map_location=resolve_device(device),
                                    weights_only=True), want)
    fpk = params_dir / "params.fpk"
    if not fpk.is_file():
        what = ("only an orbax/ checkpoint" if (params_dir / "orbax").is_dir()
                else "no params.fpk")
        raise BundleError(
            f"{params_dir} holds {what}; the port reads params.fpk: rebuild "
            "the bundle with the JAX builder's params_format 'fpk' or "
            "'both'")
    state_dict = {port_key(k): to_torch_layout(k, t) for k, t in
                  flatpack.load_state_dict(fpk, resolve_device(device))
                  .items()}
    return _fits(fpk, state_dict, want)


def _lecun_normal(gen, shape, fan_in: int, device) -> torch.Tensor:
    """flax's ``lecun_normal``: a normal truncated at 2 sigma, std
    ``1/sqrt(fan_in)``."""
    w = torch.randn(shape, generator=gen, device=device)
    return w.clamp_(-2.0, 2.0) / (0.87962566103423978 * math.sqrt(fan_in))


def _llama_init(cfg: LlamaConfig, gen, device) -> dict:
    """Embedding normal with std ``1/sqrt(vocab)``; norm gains 1; float
    kernels lecun (fan-in the first axis); int8 kernels ``round(63.5 *
    clip(N(0,1), -2, 2))`` (the per-column max of a 2-sigma-truncated
    normal maps to 127) with the JAX init's constant scale ``1 / (127
    sqrt(in))``. MoE (``models/moe.py``): the f32 router lecun (fan-in
    hidden); the expert stacks ``[e, in, out]`` by the same rules with
    fan-in ``in`` (JAX's ``lecun_normal(batch_axis=(0,))``), their scales
    ``[e, 1, out]``."""
    shapes = LlamaModel(cfg, device="meta").state_dict()
    out = {}
    for key in sorted(shapes):
        ref = shapes[key]
        name = key.rsplit(".", 1)[-1]
        stack = name.removesuffix("_int8").removesuffix("_scale")
        if stack in EXPERT_KEYS:
            if name.endswith("_scale"):
                fan_in = shapes[key.removesuffix("_scale") + "_int8"].shape[1]
                out[key] = torch.full(ref.shape, 1.0 / (127.0 * fan_in ** 0.5),
                                      dtype=ref.dtype, device=device)
            elif name.endswith("_int8"):
                w = torch.randn(ref.shape, generator=gen, device=device)
                out[key] = (w.clamp_(-2.0, 2.0) * 63.5).round_().to(torch.int8)
            else:
                out[key] = _lecun_normal(gen, ref.shape, ref.shape[1],
                                         device).to(ref.dtype)
        elif name == "router":
            out[key] = _lecun_normal(gen, ref.shape, ref.shape[0],
                                     device).to(ref.dtype)
        elif name == "embedding":
            w = torch.randn(ref.shape, generator=gen, device=device)
            out[key] = (w / math.sqrt(ref.shape[0])).to(ref.dtype)
        elif name == "scale" and ref.dim() == 1:  # RMSNorm gain
            out[key] = torch.ones(ref.shape, dtype=ref.dtype, device=device)
        elif name == "scale":  # int8 per-channel scale [1, out]
            fan_in = shapes[key.rsplit(".", 1)[0] + ".kernel_int8"].shape[0]
            out[key] = torch.full(ref.shape, 1.0 / (127.0 * fan_in ** 0.5),
                                  dtype=ref.dtype, device=device)
        elif name == "kernel_int8":
            w = torch.randn(ref.shape, generator=gen, device=device)
            out[key] = (w.clamp_(-2.0, 2.0) * 63.5).round_().to(torch.int8)
        elif name == "kernel":
            out[key] = _lecun_normal(gen, ref.shape, ref.shape[0],
                                     device).to(ref.dtype)
        else:
            raise KeyError(f"no init rule for {key}")
    return out


def _flax_init(cfg, gen, device) -> dict:
    """The flax modules' default inits, module by module: convolution
    and dense kernels lecun (fan-in: the input channels times the window,
    or the input dims), biases 0; batch norm scale 1 (0 for each block's
    ``bn3``, as the JAX ResNet's ``scale_init``), mean 0, var 1; LayerNorm
    scale 1, bias 0; embeddings normal with std ``1/sqrt(dim)``."""
    out = {}

    def put(key, t, ref):
        out[key] = t.to(ref.dtype)

    for name, mod in empty_model(cfg, device="meta").named_modules():
        p = f"{name}." if name else ""
        if isinstance(mod, resnet.Conv):
            ref = mod.kernel
            put(p + "kernel", _lecun_normal(gen, ref.shape,
                                            math.prod(ref.shape[1:]),
                                            device), ref)
        elif isinstance(mod, (resnet.Dense, bert.Dense)):
            fan_in = getattr(mod, "n_in", mod.kernel.shape[0])
            put(p + "kernel", _lecun_normal(gen, mod.kernel.shape, fan_in,
                                            device), mod.kernel)
            put(p + "bias", torch.zeros(mod.bias.shape, device=device),
                mod.bias)
        elif isinstance(mod, resnet.BatchNorm):
            fill = {"scale": 0.0 if name.endswith("bn3") else 1.0,
                    "bias": 0.0, "mean": 0.0, "var": 1.0}
            for leaf, v in fill.items():
                ref = getattr(mod, leaf)
                put(p + leaf, torch.full(ref.shape, v, device=device), ref)
        elif isinstance(mod, bert.LayerNorm):
            put(p + "scale", torch.ones(mod.scale.shape, device=device),
                mod.scale)
            put(p + "bias", torch.zeros(mod.bias.shape, device=device),
                mod.bias)
        elif isinstance(mod, bert.Embed):
            ref = mod.embedding
            w = torch.randn(ref.shape, generator=gen, device=device)
            put(p + "embedding", w / math.sqrt(ref.shape[1]), ref)
    return out


def init_params(cfg, seed: int = 0, device=None):
    """Seeded random weights made on ``device`` (the card by default) with
    one ``torch.Generator``, mirroring the JAX random init's magnitudes
    (:func:`_llama_init`, :func:`_flax_init`). The torch BERT takes
    ``torch.nn``'s own init under ``torch.manual_seed(seed)`` (made on the
    host, then moved); tabular fits its estimator on seeded data."""
    if isinstance(cfg, TabularConfig):
        return _fit(cfg, seed)
    device = resolve_device(device)
    if isinstance(cfg, TorchBertConfig):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = empty_model(cfg, device="cpu")
        return {k: v.to(device) for k, v in model.state_dict().items()}
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if isinstance(cfg, LlamaConfig):
        return _llama_init(cfg, gen, device)
    return _flax_init(cfg, gen, device)


def build_model(cfg, state_dict=None, *, device=None):
    """A model of ``cfg`` on ``device`` holding ``state_dict`` (moved to
    the device), or random weights from seed 0 when it is None; in
    inference mode. A ResNet's convolution kernels are put in
    ``channels_last`` memory (the activations' layout); a tabular
    ``state_dict`` is its fitted estimator, returned as it is."""
    if isinstance(cfg, TabularConfig):
        return state_dict if state_dict is not None else init_params(cfg)
    device = resolve_device(device)
    model = empty_model(cfg, device="meta")
    if state_dict is None:
        state_dict = init_params(cfg, 0, device)
    else:
        state_dict = _fits("state_dict", {k: v.to(device) for k, v in
                                          state_dict.items()},
                           model.state_dict())
    # built on the meta device and handed the tensors themselves: the
    # weights are never allocated twice
    model.load_state_dict(state_dict, strict=True, assign=True)
    model.device = device
    if isinstance(cfg, resnet.ResNetConfig):
        model = model.to(memory_format=torch.channels_last)
    return model.eval().requires_grad_(False)
