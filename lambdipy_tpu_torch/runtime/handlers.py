"""Request handlers of the port, twin of ``lambdipy_tpu/runtime/handlers.py``
for the generate path: a port-owned :class:`HandlerState` and
:func:`generate_handler`, which takes the same spec shape (``model``,
``dtype``, ``quant``, ``extra``) and the same request fields as the JAX
handler, with ``batch_mode="continuous"`` (optionally over a paged KV
arena, ``kv_paged``) for concurrent traffic."""

from __future__ import annotations

import dataclasses
from collections.abc import Callable, Iterator
from typing import Any

import numpy as np

from lambdipy_tpu_torch.models import registry
from lambdipy_tpu_torch.models.llama import (_next_bucket, init_page_arena,
                                             page_kv_bytes)
from lambdipy_tpu_torch.ops.attention import flash_attention
from lambdipy_tpu_torch.ops.decode_attention import (blocked_decode_attention,
                                                     paged_decode_attention)
from lambdipy_tpu_torch.ops.quant import int8_matmul
from lambdipy_tpu_torch.runtime.continuous import ContinuousBatcher
from lambdipy_tpu_torch.runtime.pagepool import PagePool, page_width


@dataclasses.dataclass
class HandlerState:
    invoke_fn: Callable[[dict], dict]
    meta: dict
    # optional live-stats provider merged into /metrics
    stats_fn: Callable[[], dict] | None = None
    # the LlamaServer behind invoke_fn, for callers that drive it directly
    server: Any = None
    # streaming invoke: request -> iterator of chunk records, the last
    # one carrying {"done": true}
    invoke_stream_fn: Callable[[dict], Iterator[dict]] | None = None
    # the continuous engine behind invoke_fn, when batch_mode=continuous
    engine: Any = None

    def invoke(self, request: dict) -> dict:
        return self.invoke_fn(request)

    def invoke_stream(self, request: dict) -> Iterator[dict]:
        if self.invoke_stream_fn is None:
            raise ValueError("handler does not support streaming")
        return self.invoke_stream_fn(dict(request or {}))

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
    """Each kernel wrapper's launch counter; the decode-attention kernels
    (contiguous and paged) count their float-KV and int8-KV launches
    apart."""
    return {"decode_attention": blocked_decode_attention.launches,
            "decode_attention_int8kv":
                blocked_decode_attention.launches_int8kv,
            "paged_decode_attention": paged_decode_attention.launches,
            "paged_decode_attention_int8kv":
                paged_decode_attention.launches_int8kv,
            "int8_matmul": int8_matmul.launches,
            "flash_attention": flash_attention.launches}


# engine extras of the JAX handler whose features are not ported: the
# value each may take (the feature off), anything else raises
_UNPORTED_ENGINE_EXTRAS = {
    "pipeline_depth": ("1",),
    "batch_window_bucketing": ("0", "false", "off"),
    "prefill_chunk": ("0",),
    "engine_watchdog_s": ("0", "0.0"),
    "max_replays": ("0",),
    "fault_spec": ("",),
    "spec_k": ("0", "1"),
    "draft_mode": ("off",),
    "max_logical_ctx": ("0",),
    "long_prefill": ("0", "false", "off"),
    "prefill_mode": ("chunked",),
    "prefix_cache_mb": ("0",),
    "mesh": ("", "off"),
    "batch_window_ms": ("0",),
}


def _check_unported_extras(extra: dict) -> None:
    for key, off in _UNPORTED_ENGINE_EXTRAS.items():
        if key in extra and str(extra[key]).strip().lower() not in off:
            raise ValueError(
                f"extra {key}={extra[key]!r} needs a feature the port does "
                f"not have yet; supported: {key} in {list(off)} or unset")
    mode = str(extra.get("batch_mode") or "").lower()
    if mode not in ("", "none", "continuous"):
        raise ValueError(f"batch_mode {mode!r} is not ported; supported: "
                         "continuous (or unset)")


def _on(value) -> bool:
    return str(value).strip().lower() not in ("", "0", "false", "off")


def make_engine(server, extra: dict) -> ContinuousBatcher:
    """The continuous engine the extras ask for: ``batch_max`` slots,
    ``batch_segment`` steps per segment, ``batch_cache_len`` positions
    per row (default ``max_len``) and, with ``kv_paged``, a page arena of
    ``kv_pages`` pages (default ``batch_max`` full windows plus the null
    page) whose page width is ``page_width(cache_len, prefix_block)``
    (``prefix_block`` default 32)."""
    cfg = server.model.cfg
    slots = int(extra.get("batch_max", 8))
    bcl = extra.get("batch_cache_len")
    cache_len = min(int(bcl) if bcl else cfg.max_len, cfg.max_len)
    pool = None
    if _on(extra.get("kv_paged", "0")):
        page = page_width(cache_len, int(extra.get("prefix_block") or 32))
        window_pages = cache_len // page
        raw = extra.get("kv_pages")
        n_pages = max(2, int(raw) if raw not in (None, "")
                      else slots * window_pages + 1)
        pool = PagePool(
            n_pages=n_pages, page=page, page_bytes=page_kv_bytes(cfg, page),
            make_arena=lambda: init_page_arena(cfg, n_pages, page,
                                               server.device),
            window_pages=window_pages)
    return ContinuousBatcher(server, slots=slots,
                             segment=int(extra.get("batch_segment", 16)),
                             cache_len=cache_len, page_pool=pool)


def generate_handler(spec: dict, ctx: HandlerContext) -> HandlerState:
    """Llama generation: greedy by default; requests may set temperature,
    top_k, top_p, seed and eos_id for sampled decode, ``logprobs``, and
    ``stream`` (through :meth:`HandlerState.invoke_stream`). With
    ``batch_mode="continuous"`` single-row requests share the continuous
    engine (:func:`make_engine`); multi-row requests run as one batch.
    On the card decode steps replay CUDA graphs, at most
    ``program_cache_max`` programs (extra) beside the engine's; a
    ``{"warmup": true}`` request captures its bucket's graph."""
    extra = dict(spec.get("extra") or {})
    _check_unported_extras(extra)
    # dtype and quant fall back to the builder's defaults when the spec
    # leaves them out (llama3-8b: bfloat16, int8)
    adapter = registry.get(spec["model"]).build(
        extra=extra, **{k: spec[k] for k in ("dtype", "quant") if k in spec})
    server_kw = {}
    if extra.get("program_cache_max") is not None:
        # LRU bound on the decode programs (a CUDA graph and its decode
        # cache each); rising program_evictions in /metrics means it is
        # too small for the workload's bucket diversity
        server_kw["program_cache_max"] = int(extra["program_cache_max"])
    # on the card every decode step replays a captured CUDA graph
    server = adapter.make_server(ctx.state_dict, device=ctx.device,
                                 **server_kw)
    engine = (make_engine(server, extra)
              if str(extra.get("batch_mode") or "").lower() == "continuous"
              else None)
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
        if engine is not None and len(prompt) == 1:
            out_ = engine.generate(prompt[0], max_new_tokens=max_new,
                                   return_logprobs=want_lp, **sample_kwargs)
        else:
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

    def invoke_stream(req: dict):
        """Chunk records as the decode emits them, then a summary record
        ``{"ok": true, "done": true, ...}``; concatenated chunk tokens
        equal the non-streamed response."""
        parsed = parse(req)
        if isinstance(parsed, dict):
            yield parsed
            return
        prompt, max_new, sample_kwargs, want_lp = parsed
        if engine is not None and len(prompt) == 1:
            # the engine's segment sets the chunk cadence
            chunks = engine.generate_stream(
                prompt[0], max_new_tokens=max_new, return_logprobs=want_lp,
                **sample_kwargs)
        else:
            # a pow-2 segment in [4, 64], as the JAX handler clamps it
            segment = min(64, _next_bucket(int(req.get("segment") or 16), 4))
            chunks = server.generate_stream(
                prompt, max_new_tokens=max_new, segment=segment,
                return_logprobs=want_lp, **sample_kwargs)
        n_new = 0
        for chunk in chunks:
            chunk, lp_chunk = chunk if want_lp else (chunk, None)
            n_new += int(chunk.shape[1])
            rec = {"ok": True, "tokens": chunk.tolist()}
            if lp_chunk is not None:
                rec["logprobs"] = [[round(float(x), 5) for x in row]
                                   for row in lp_chunk]
            yield rec
        out = {"ok": True, "done": True, "n_new": n_new,
               "n_prompt": int(sum(len(r) for r in prompt))}
        if sample_kwargs["eos_id"] is not None:
            out["eos_id"] = sample_kwargs["eos_id"]
        yield out

    def stats() -> dict:
        # decode_buckets, compile_count, program_evictions as the JAX
        # handler reports them, plus replays and eager_steps
        out = {"kernels": kernel_launches(), **server.program_stats()}
        if engine is not None:
            out["batching"] = engine.stats()
        return out

    cfg = adapter.config
    return HandlerState(
        invoke_fn=invoke,
        meta={"model": spec["model"], "max_len": cfg.max_len,
              "device": str(server.device),
              "attn_backend": cfg.attn_backend,
              "matmul_backend": cfg.matmul_backend,
              "kv_quant": cfg.kv_quant,
              "batch_mode": "continuous" if engine is not None else None,
              "kv_paged": engine is not None and engine.pool is not None},
        stats_fn=stats, server=server, invoke_stream_fn=invoke_stream,
        engine=engine)

