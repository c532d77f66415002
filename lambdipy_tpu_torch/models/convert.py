"""HuggingFace weight import of the port, the twin of
``lambdipy_tpu/models/convert.py``: a local HF Llama (or BERT classifier)
checkpoint, or an in-memory ``transformers`` model, converted into the
params tree the JAX package's models take (``{"params": tree}``, kernels
``[in, out]``), which ``models/params.py from_jax_params`` turns into the
port's ``state_dict``. Conversion runs on the host and keeps the
checkpoint's dtype (a bf16 checkpoint stays bf16, with no f32 round trip).

Mapping (HF ``modeling_llama`` names): torch ``nn.Linear`` keeps
``weight`` as ``[out, in]``, transposed into the ``[in, out]`` kernels;
HF's rotary embedding is the rotate-half convention of ``llama.rope``, so
q and k port unpermuted; with ``tie_word_embeddings`` the lm_head kernel
is the transposed embedding.

A source is a ``transformers`` model instance (anything with
``state_dict()`` and ``config``) or a local checkpoint directory. The
port reads a directory itself (:func:`read_hf_checkpoint`), since its
card's host has no ``transformers`` or ``safetensors`` package: JAX loads
it through ``AutoModelFor*.from_pretrained(local_files_only=True)``.
Nothing is downloaded. What a directory may hold, and what raises, is in
:func:`read_hf_checkpoint`.
"""

from __future__ import annotations

import dataclasses
import json
import pickle
import struct
import sys
from pathlib import Path

import torch

from lambdipy_tpu_torch.utils.logs import get_logger, log_event

log = get_logger("lambdipy.convert")

# safetensors' dtype names (its format's header) -> torch
SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool}


class CheckpointError(ValueError):
    """A checkpoint directory that cannot be read; names the file."""


def _read_safetensors(path: Path) -> dict[str, torch.Tensor]:
    """One ``.safetensors`` file: an 8-byte little-endian header length,
    a JSON header (name -> dtype, shape, ``data_offsets`` into the data
    that follows), then the raw little-endian tensors. Each tensor is
    read once into memory of its own, in its dtype."""
    if sys.byteorder != "little":
        raise CheckpointError(f"{path}: safetensors is little-endian; this "
                              "host is not")
    out = {}
    try:
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
            base = 8 + n
            for name, spec in header.items():
                if name == "__metadata__":
                    continue
                dtype = SAFETENSORS_DTYPES.get(spec["dtype"])
                if dtype is None:
                    raise CheckpointError(
                        f"{path}: tensor {name!r} has dtype "
                        f"{spec['dtype']!r}, which the reader does not take")
                begin, end = spec["data_offsets"]
                buf = torch.empty(end - begin, dtype=torch.uint8)
                f.seek(base + begin)
                if f.readinto(buf.numpy()) != end - begin:
                    raise CheckpointError(f"{path}: tensor {name!r} is cut "
                                          "short")
                out[name] = buf.view(dtype).reshape(spec["shape"])
    except CheckpointError:
        raise
    except (OSError, ValueError, KeyError, TypeError, struct.error,
            RuntimeError) as e:
        raise CheckpointError(f"{path}: not a readable safetensors file "
                              f"({type(e).__name__}: {e})") from e
    return out


def _read_torch_bin(path: Path) -> dict[str, torch.Tensor]:
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except (OSError, RuntimeError, EOFError, ValueError,
            pickle.UnpicklingError) as e:
        raise CheckpointError(f"{path}: not a readable torch checkpoint "
                              f"({type(e).__name__}: {e})") from e
    if not isinstance(sd, dict):
        raise CheckpointError(f"{path}: holds a {type(sd).__name__}, not a "
                              "state dict")
    return sd


def _read_sharded(index: Path, read) -> dict[str, torch.Tensor]:
    """The shards an HF ``*.index.json`` maps every tensor to, each read
    once."""
    try:
        weight_map = json.loads(index.read_text())["weight_map"]
    except (OSError, ValueError, KeyError, TypeError) as e:
        raise CheckpointError(f"{index}: not a readable shard index "
                              f"({type(e).__name__}: {e})") from e
    out: dict[str, torch.Tensor] = {}
    for shard in sorted(set(weight_map.values())):
        shard_path = index.parent / shard
        if not shard_path.is_file():
            raise CheckpointError(f"{index}: its shard {shard_path} is "
                                  "missing")
        out.update(read(shard_path))
    missing = sorted(set(weight_map) - set(out))
    if missing:
        raise CheckpointError(f"{index}: tensors {missing[:5]} are in no "
                              "shard")
    return out


def read_hf_checkpoint(path) -> tuple[dict[str, torch.Tensor], dict]:
    """A local HF checkpoint directory -> ``(state_dict of CPU tensors in
    the checkpoint's dtypes, config dict)``. It reads ``config.json`` and
    the weights of the first of ``model.safetensors``,
    ``model.safetensors.index.json`` (its shards), ``pytorch_model.bin``
    (``torch.load(weights_only=True)``) and ``pytorch_model.bin.index.json``
    that it finds, as ``from_pretrained`` prefers them. A directory with
    none of them, a missing shard, or a file it cannot parse raises
    :class:`CheckpointError` naming the file."""
    root = Path(path)
    cfg_path = root / "config.json"
    try:
        hf_cfg = json.loads(cfg_path.read_text())
    except (OSError, ValueError) as e:
        raise CheckpointError(f"{cfg_path}: no readable HF config "
                              f"({type(e).__name__}: {e})") from e
    for name, read, sharded in (
            ("model.safetensors", _read_safetensors, False),
            ("model.safetensors.index.json", _read_safetensors, True),
            ("pytorch_model.bin", _read_torch_bin, False),
            ("pytorch_model.bin.index.json", _read_torch_bin, True)):
        if (root / name).is_file():
            sd = (_read_sharded(root / name, read) if sharded
                  else read(root / name))
            return sd, hf_cfg
    raise CheckpointError(
        f"{root}: no model.safetensors, model.safetensors.index.json, "
        "pytorch_model.bin or pytorch_model.bin.index.json")


def _leaf(t) -> torch.Tensor:
    """A checkpoint tensor as a CPU tensor in its own dtype."""
    return torch.as_tensor(t).detach().to("cpu")


def _state_dict_of(source) -> tuple[dict, dict | None]:
    """(state_dict, hf_config_dict or None) from a model / path / mapping."""
    if hasattr(source, "state_dict") and hasattr(source, "config"):
        return dict(source.state_dict()), source.config.to_dict()
    if isinstance(source, (str, Path)):
        return read_hf_checkpoint(source)
    return dict(source), None


def _rope_scaling_from_hf(hf_cfg: dict) -> tuple | None:
    """HF ``rope_scaling`` -> the config's tuple form; raises for schemes
    the model does not implement (yarn, dynamic, longrope)."""
    rs = hf_cfg.get("rope_scaling")
    if not rs:
        return None
    kind = rs.get("rope_type", rs.get("type", "default"))
    if kind in (None, "default"):
        return None
    if kind == "linear":
        return ("linear", float(rs["factor"]))
    if kind == "llama3":
        return ("llama3", float(rs["factor"]),
                float(rs["low_freq_factor"]), float(rs["high_freq_factor"]),
                float(rs["original_max_position_embeddings"]))
    raise ValueError(
        f"unsupported HF config field: rope_scaling type {kind!r} "
        "(supported: default, linear, llama3)")


def _check_supported_hf_config(hf_cfg: dict) -> None:
    """Reject HF config fields that would change numerics if dropped:
    wrong logits with no error is the worst failure of an import."""
    if hf_cfg.get("attention_bias"):
        raise ValueError(
            "unsupported HF config field: attention_bias=True "
            "(q/k/v/o projection biases are not implemented)")
    if hf_cfg.get("mlp_bias"):
        raise ValueError(
            "unsupported HF config field: mlp_bias=True "
            "(gate/up/down projection biases are not implemented)")
    head_dim = hf_cfg.get("head_dim")
    derived = int(hf_cfg["hidden_size"]) // int(hf_cfg["num_attention_heads"])
    if head_dim is not None and int(head_dim) != derived:
        raise ValueError(
            f"unsupported HF config field: head_dim={head_dim} differs from "
            f"hidden_size/num_attention_heads={derived}")


def llama_config_from_hf(hf_cfg: dict, **overrides):
    """An HF Llama config dict as the port's ``LlamaConfig`` (bf16, the
    port's kernel backends); raises for an unsupported field instead of
    dropping it."""
    from lambdipy_tpu_torch.models.llama import LlamaConfig

    _check_supported_hf_config(hf_cfg)
    cfg = LlamaConfig(
        vocab_size=int(hf_cfg["vocab_size"]),
        hidden=int(hf_cfg["hidden_size"]),
        layers=int(hf_cfg["num_hidden_layers"]),
        heads=int(hf_cfg["num_attention_heads"]),
        kv_heads=int(hf_cfg.get("num_key_value_heads",
                                hf_cfg["num_attention_heads"])),
        mlp=int(hf_cfg["intermediate_size"]),
        max_len=int(hf_cfg.get("max_position_embeddings", 8192)),
        rope_theta=float(hf_cfg.get("rope_theta", 10000.0)),
        rope_scaling=_rope_scaling_from_hf(hf_cfg),
        norm_eps=float(hf_cfg.get("rms_norm_eps", 1e-5)),
        dtype=torch.bfloat16,
    )
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def _n_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(_n_params(v) for v in tree.values())
    return int(tree.numel())


def import_hf_llama(source, *, config_overrides: dict | None = None):
    """An HF Llama checkpoint as ``(LlamaConfig, {"params": tree})``.

    ``source``: a ``transformers`` model instance, a local checkpoint
    directory, or a raw ``state_dict`` mapping (which raises: it carries
    no architecture). Leaves are CPU tensors in the checkpoint's dtype."""
    sd, hf_cfg = _state_dict_of(source)
    if hf_cfg is None:
        raise ValueError(
            "raw state_dict needs an HF config; pass a model or path instead")
    sd = {k: _leaf(v) for k, v in sd.items()}
    cfg = llama_config_from_hf(hf_cfg, **(config_overrides or {}))

    def lin(name):  # torch Linear [out, in] -> kernel [in, out]
        return {"kernel": sd[f"{name}.weight"].T.contiguous()}

    def norm(name):
        return {"scale": sd[f"{name}.weight"]}

    params: dict = {
        "embed": {"embedding": sd["model.embed_tokens.weight"]},
        "final_norm": norm("model.norm"),
    }
    for i in range(cfg.layers):
        hf = f"model.layers.{i}"
        params[f"layer_{i}"] = {
            "attn_norm": norm(f"{hf}.input_layernorm"),
            "q_proj": lin(f"{hf}.self_attn.q_proj"),
            "k_proj": lin(f"{hf}.self_attn.k_proj"),
            "v_proj": lin(f"{hf}.self_attn.v_proj"),
            "o_proj": lin(f"{hf}.self_attn.o_proj"),
            "mlp_norm": norm(f"{hf}.post_attention_layernorm"),
            "gate_proj": lin(f"{hf}.mlp.gate_proj"),
            "up_proj": lin(f"{hf}.mlp.up_proj"),
            "down_proj": lin(f"{hf}.mlp.down_proj"),
        }
    head = sd.get("lm_head.weight", sd["model.embed_tokens.weight"])
    params["lm_head"] = {"kernel": head.T.contiguous()}  # tied: embed.T
    log_event(log, "hf llama imported", layers=cfg.layers,
              n_params=_n_params(params))
    return cfg, {"params": params}


def bert_config_from_hf(hf_cfg: dict, num_classes: int, **overrides):
    from lambdipy_tpu_torch.models.bert import BertConfig

    cfg = BertConfig(
        vocab_size=int(hf_cfg["vocab_size"]),
        hidden=int(hf_cfg["hidden_size"]),
        layers=int(hf_cfg["num_hidden_layers"]),
        heads=int(hf_cfg["num_attention_heads"]),
        mlp=int(hf_cfg["intermediate_size"]),
        max_len=int(hf_cfg.get("max_position_embeddings", 512)),
        type_vocab=int(hf_cfg.get("type_vocab_size", 2)),
        num_classes=num_classes,
        dtype=torch.bfloat16,
    )
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def import_hf_bert(source, *, config_overrides: dict | None = None):
    """An HF ``BertForSequenceClassification`` checkpoint (a model or a
    local directory) as ``(BertConfig, {"params": tree})`` for
    ``models/bert.py BertClassifier``: Linear ``[out, in]`` -> ``[in,
    out]`` kernels; the q/k/v projections as ``[hidden, heads,
    head_dim]``, the output projection as ``[heads, head_dim, hidden]``;
    LayerNorm weight/bias -> scale/bias."""
    sd, hf_cfg = _state_dict_of(source)
    if hf_cfg is None:
        raise ValueError(
            "raw state_dict needs an HF config; pass a model or path instead")
    sd = {k: _leaf(v) for k, v in sd.items()}
    num_classes = sd["classifier.weight"].shape[0]
    cfg = bert_config_from_hf(hf_cfg, num_classes, **(config_overrides or {}))
    h, heads, hd = cfg.hidden, cfg.heads, cfg.hidden // cfg.heads

    def lin(name):
        return {"kernel": sd[f"{name}.weight"].T.contiguous(),
                "bias": sd[f"{name}.bias"]}

    def qkv(name):  # [h_out, h_in] -> kernel [h_in, heads, head_dim]
        return {"kernel": sd[f"{name}.weight"].T.contiguous()
                .reshape(h, heads, hd),
                "bias": sd[f"{name}.bias"].reshape(heads, hd)}

    def ln(name):
        return {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}

    enc: dict = {
        "tok_emb": {"embedding": sd["bert.embeddings.word_embeddings.weight"]},
        "pos_emb": {"embedding":
                    sd["bert.embeddings.position_embeddings.weight"]},
        "type_emb": {"embedding":
                     sd["bert.embeddings.token_type_embeddings.weight"]},
        "emb_ln": ln("bert.embeddings.LayerNorm"),
    }
    for i in range(cfg.layers):
        hf = f"bert.encoder.layer.{i}"
        enc[f"layer_{i}"] = {
            "attn": {
                "query": qkv(f"{hf}.attention.self.query"),
                "key": qkv(f"{hf}.attention.self.key"),
                "value": qkv(f"{hf}.attention.self.value"),
                # output projection: [h_out, h_in] -> [heads, head_dim, h]
                "out": {"kernel": sd[f"{hf}.attention.output.dense.weight"]
                        .T.contiguous().reshape(heads, hd, h),
                        "bias": sd[f"{hf}.attention.output.dense.bias"]},
            },
            "ln_attn": ln(f"{hf}.attention.output.LayerNorm"),
            "mlp_in": lin(f"{hf}.intermediate.dense"),
            "mlp_out": lin(f"{hf}.output.dense"),
            "ln_mlp": ln(f"{hf}.output.LayerNorm"),
        }
    params = {"encoder": enc, "pooler": lin("bert.pooler.dense"),
              "classifier": lin("classifier")}
    log_event(log, "hf bert imported", layers=cfg.layers,
              n_params=_n_params(params))
    return cfg, {"params": params}


def save_hf_params(hf_path, params_dir: Path, *, quant: str | None = None,
                   params_format: str = "both") -> dict:
    """Bundle-build hook (``bundle/package.py`` ``params = "hf"``): convert
    a local HF Llama checkpoint (``llama.quantize_params`` under ``quant =
    "int8"``) and write it as the bundle's ``params.fpk``. ``"both"`` and
    ``"fpk"`` both write ``params.fpk`` alone and record ``"fpk"``: the
    card's host has no orbax; ``"orbax"`` raises. Returns the manifest's
    ``params_info``, JAX's keys, with the complete architecture under
    ``config``: the serving side rebuilds ``llama-hf`` from exactly that."""
    if params_format == "orbax":
        raise ValueError(
            "params_format 'orbax' cannot be built by the port: its host "
            "has no orbax, and the port reads params.fpk alone; use 'fpk' "
            "or 'both' (which writes params.fpk)")
    if params_format not in ("both", "fpk"):
        raise ValueError(f"unknown params_format {params_format!r}; "
                         "supported: 'both', 'fpk'")
    from lambdipy_tpu_torch.bundle import flatpack
    from lambdipy_tpu_torch.models.llama import quantize_params

    cfg, params = import_hf_llama(hf_path)
    if quant == "int8":
        params = quantize_params(params)
    params_dir = Path(params_dir)
    params_dir.mkdir(parents=True, exist_ok=True)
    flatpack.save(params_dir / "params.fpk", params)
    return {"format": "fpk", "n_params": _n_params(params), "source": "hf",
            "hf_path": str(hf_path), "quant": quant,
            "config": {"vocab_size": cfg.vocab_size, "hidden": cfg.hidden,
                       "layers": cfg.layers, "heads": cfg.heads,
                       "kv_heads": cfg.kv_heads, "mlp": cfg.mlp,
                       "rope_theta": cfg.rope_theta,
                       "rope_scaling": (list(cfg.rope_scaling)
                                        if cfg.rope_scaling else None),
                       "norm_eps": cfg.norm_eps, "max_len": cfg.max_len}}
