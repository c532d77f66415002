"""Request handlers of the port, twin of ``lambdipy_tpu/runtime/handlers.py``
for the generate path: a port-owned :class:`HandlerState` and
:func:`generate_handler`, which takes the same spec shape (``model``,
``dtype``, ``quant``, ``extra``) and the same request fields as the JAX
handler's non-batched path."""

from __future__ import annotations

import dataclasses
from collections.abc import Callable
from typing import Any

import numpy as np

from lambdipy_tpu_torch.models import registry
from lambdipy_tpu_torch.ops.decode_attention import blocked_decode_attention
from lambdipy_tpu_torch.ops.quant import int8_matmul


@dataclasses.dataclass
class HandlerState:
    invoke_fn: Callable[[dict], dict]
    meta: dict
    # optional live-stats provider merged into /metrics
    stats_fn: Callable[[], dict] | None = None
    # the LlamaServer behind invoke_fn, for callers that drive it directly
    server: Any = None

    def invoke(self, request: dict) -> dict:
        return self.invoke_fn(request)

    def stats(self) -> dict:
        return self.stats_fn() if self.stats_fn is not None else {}


@dataclasses.dataclass
class HandlerContext:
    """Where the handler's weights come from: ``state_dict`` (e.g. from
    ``models/params.py from_jax_params``) or, when None, random weights
    made on the device from seed 0. ``device`` None means the card."""

    device: Any = None
    state_dict: dict | None = None


def kernel_launches() -> dict:
    """Each kernel wrapper's launch counter."""
    return {"decode_attention": blocked_decode_attention.launches,
            "int8_matmul": int8_matmul.launches}


def generate_handler(spec: dict, ctx: HandlerContext) -> HandlerState:
    """Llama generation: greedy by default; requests may set temperature,
    top_k, top_p, seed and eos_id for sampled decode, and ``logprobs``."""
    extra = dict(spec.get("extra") or {})
    # dtype and quant fall back to the builder's defaults when the spec
    # leaves them out (llama3-8b: bfloat16, int8)
    adapter = registry.get(spec["model"]).build(
        extra=extra, **{k: spec[k] for k in ("dtype", "quant") if k in spec})
    server = adapter.make_server(ctx.state_dict, device=ctx.device)
    default_new = int(extra.get("max_new_tokens", 16))

    def parse(req: dict):
        """Request -> (prompt, max_new, sample_kwargs, want_logprobs), or
        an error dict."""
        if req.get("warmup"):
            prompt = np.asarray([[1, 2, 3, 4]], np.int32)
        else:
            raw = req.get("tokens")
            if raw is None:
                return {"ok": False, "error": "send 'tokens'"}
            if isinstance(raw, (list, tuple)) and raw and \
                    isinstance(raw[0], (list, tuple, np.ndarray)):
                # list of rows, possibly ragged: the server decodes each
                # row from its own prompt end
                rows = [np.asarray(r, dtype=np.int32).reshape(-1)
                        for r in raw]
                if any(r.size == 0 for r in rows):
                    return {"ok": False, "error": "empty prompt row"}
                prompt = (np.stack(rows) if len({len(r) for r in rows}) == 1
                          else rows)
            else:
                arr = np.asarray(raw, dtype=np.int32)
                if arr.size == 0:
                    return {"ok": False, "error": "empty prompt"}
                prompt = arr[None, :] if arr.ndim == 1 else arr
        raw_new = req.get("max_new_tokens")
        max_new = default_new if raw_new is None else int(raw_new)
        sample_kwargs = {
            "temperature": float(req.get("temperature") or 0.0),
            "top_k": int(req["top_k"]) if req.get("top_k") is not None else None,
            "top_p": float(req["top_p"]) if req.get("top_p") is not None else None,
            "seed": int(req.get("seed") or 0),
            "eos_id": int(req["eos_id"]) if req.get("eos_id") is not None else None,
        }
        return prompt, max_new, sample_kwargs, bool(req.get("logprobs"))

    def invoke(req: dict) -> dict:
        parsed = parse(req)
        if isinstance(parsed, dict):
            return parsed
        prompt, max_new, sample_kwargs, want_lp = parsed
        out_ = server.generate(prompt, max_new_tokens=max_new,
                               return_logprobs=want_lp, **sample_kwargs)
        toks, lps = out_ if want_lp else (out_, None)
        out = {"ok": True, "tokens": toks.tolist(),
               "n_new": int(toks.shape[-1]),
               "n_prompt": int(sum(len(r) for r in prompt))}
        if lps is not None:
            out["logprobs"] = [[round(float(x), 5) for x in row]
                               for row in lps]
        if sample_kwargs["eos_id"] is not None:
            out["eos_id"] = sample_kwargs["eos_id"]
        return out

    cfg = adapter.config
    return HandlerState(
        invoke_fn=invoke,
        meta={"model": spec["model"], "max_len": cfg.max_len,
              "device": str(server.device),
              "attn_backend": cfg.attn_backend,
              "matmul_backend": cfg.matmul_backend},
        stats_fn=lambda: {"kernels": kernel_launches()},
        server=server)
