"""Weights for the port's :class:`~lambdipy_tpu_torch.models.llama.LlamaModel`.

``from_jax_params`` maps a flax param tree (numpy leaves) onto the
port's ``state_dict``; ``load_params`` reads a bundle's ``params.fpk``
onto the device; ``init_params`` makes seeded random weights directly on
the device, with the magnitudes of the JAX package's random init, for
runs that have no checkpoint.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from lambdipy_tpu_torch.models.llama import LlamaConfig, LlamaModel
from lambdipy_tpu_torch.utils.platform import resolve_device


def _to_tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the bits
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def from_jax_params(tree) -> dict[str, torch.Tensor]:
    """Flax params (``{"params": {...}}`` or the inner dict, numpy or
    array-like leaves) -> ``state_dict`` of CPU tensors. Keys are the flax
    paths joined by ``.`` (``layer_0/q_proj/kernel_int8`` ->
    ``layer_0.q_proj.kernel_int8``); kernels keep their ``[in, out]``
    layout."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out = {}

    def walk(node, prefix):
        for name, val in node.items():
            key = f"{prefix}{name}"
            if isinstance(val, dict):
                walk(val, key + ".")
            else:
                out[key] = _to_tensor(val)

    walk(tree, "")
    return out


def load_params(params_dir: Path, cfg: LlamaConfig,
                device=None) -> dict[str, torch.Tensor]:
    """A bundle's ``params/params.fpk`` as the ``state_dict`` of a model of
    ``cfg``, on ``device`` (the card by default), the twin of JAX's
    ``registry.load_params``. The keys and shapes must be the model's;
    a leaf the JAX builder stored in another float type (its
    ``serving_cast``) is cast to the model's. A params directory with only
    an ``orbax/`` checkpoint raises: the port reads flatpack alone."""
    from lambdipy_tpu_torch.bundle import flatpack
    from lambdipy_tpu_torch.bundle.format import BundleError

    params_dir = Path(params_dir)
    fpk = params_dir / "params.fpk"
    if not fpk.is_file():
        what = ("only an orbax/ checkpoint" if (params_dir / "orbax").is_dir()
                else "no params.fpk")
        raise BundleError(
            f"{params_dir} holds {what}; the port reads params.fpk: rebuild "
            "the bundle with the JAX builder's params_format 'fpk' or "
            "'both'")
    state_dict = flatpack.load_state_dict(fpk, resolve_device(device))
    want = LlamaModel(cfg, device="meta").state_dict()
    missing = sorted(set(want) - set(state_dict))
    unexpected = sorted(set(state_dict) - set(want))
    if missing or unexpected:
        raise BundleError(f"{fpk} does not fit the model: missing "
                          f"{missing[:5]}, unexpected {unexpected[:5]}")
    for key, ref in want.items():
        t = state_dict[key]
        if tuple(t.shape) != tuple(ref.shape):
            raise BundleError(f"{fpk}: {key} has shape {tuple(t.shape)}, "
                              f"the model {tuple(ref.shape)}")
        if t.dtype != ref.dtype:
            state_dict[key] = t.to(ref.dtype)
    return state_dict


def init_params(cfg: LlamaConfig, seed: int = 0,
                device=None) -> dict[str, torch.Tensor]:
    """Seeded random weights made on ``device`` (the card by default)
    with one ``torch.Generator``, mirroring the JAX random init's
    magnitudes: embedding normal with std ``1/sqrt(vocab)``; norm gains
    1; float kernels truncated-normal lecun (std ``1/sqrt(in)``); int8
    kernels ``round(63.5 * clip(N(0,1), -2, 2))`` (the per-column max of a
    2-sigma-truncated normal maps to 127) with the JAX init's constant
    scale ``1 / (127 sqrt(in))``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    shapes = LlamaModel(cfg, device="meta").state_dict()
    out = {}
    for key in sorted(shapes):
        ref = shapes[key]
        name = key.rsplit(".", 1)[-1]
        if name == "embedding":
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
            w = torch.randn(ref.shape, generator=gen, device=device)
            w = w.clamp_(-2.0, 2.0) / (0.87962566103423978
                                       * math.sqrt(ref.shape[0]))
            out[key] = w.to(ref.dtype)
        else:
            raise KeyError(f"no init rule for {key}")
    return out


def build_model(cfg: LlamaConfig, state_dict=None, *,
                device=None) -> LlamaModel:
    """A :class:`LlamaModel` on ``device`` holding ``state_dict`` (moved to
    the device), or random weights from seed 0 when it is None."""
    device = resolve_device(device)
    if state_dict is None:
        state_dict = init_params(cfg, 0, device)
    else:
        state_dict = {k: v.to(device) for k, v in state_dict.items()}
    # built on the meta device and handed the tensors themselves: the
    # weights are never allocated twice
    model = LlamaModel(cfg, device="meta")
    model.load_state_dict(state_dict, strict=True, assign=True)
    model.device = device
    return model.eval()
