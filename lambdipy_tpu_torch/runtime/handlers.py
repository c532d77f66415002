"""Request handlers of the port, twin of ``lambdipy_tpu/runtime/handlers.py``
for the generate path: a port-owned :class:`HandlerState` and
:func:`generate_handler`, which takes the same spec shape (``model``,
``dtype``, ``quant``, ``extra``) and the same request fields as the JAX
handler, with ``batch_mode="continuous"`` (optionally over a paged KV
arena, ``kv_paged``; pipelined at ``pipeline_depth`` 2, joiners in the
``sched_policy`` order, ``fair`` by default) for concurrent traffic, and
the automatic prefix KV cache (``runtime/prefixstore.py``) built as the
JAX handler builds it. The server takes the JAX handler's ``decode_cap``,
``prefill_chunk`` and ``min_bucket`` extras, the engine its fault
isolation extras (``engine_watchdog_s``, ``max_replays``, ``fault_spec``;
one live fault plan serves the engine, the page pool and the prefix
store) and its speculative decoding (``spec_k``, ``draft_mode``,
``draft_exit``), and the state carries the engine's fault state for
``/healthz``, the plan's control for ``POST /v1/debug/faults`` and the
invariant sweep for ``GET /v1/debug/invariants``. A request's
``"speculative": k`` decodes it alone through the server's speculative
path, as the JAX handler does. The prefix store takes the JAX handler's
session extras (``session_pin_budget_mb``, ``session_ttl_s``,
``session_idle_s``) and, over a paged engine, its host offload tier
(``kv_offload``, ``kv_offload_mb``); a request's ``session_id`` (and
``session_ttl_s``) pins its conversation's head after routing, and the
state carries the K/V ship surfaces (``kv_export``, ``kv_import``,
``kv_probe`` and their streamed twins, ``runtime/kvwire.py`` frames) and
the session close for the server. A paged engine takes the long-context
tier's extras (``max_logical_ctx``, ``long_prefill``), the state the
live knob control for ``POST /v1/debug/knobs``, and after the first
invoke a background thread warms the buckets ``warm_buckets`` lists and
the engine's group prefill (``warm_group_prefill``, on by default), as
the JAX handler does; ``/healthz`` reads ``warming`` meanwhile. The
engine buckets its decode windows (``batch_window_bucketing``, on by
default, as in JAX); without the engine, ``batch_window_ms > 0`` fuses
concurrent single-row requests in the MicroBatcher
(``runtime/batching.py``). Each extra the JAX handler also takes from a
``LAMBDIPY_*`` variable is resolved with the JAX handler's precedence."""

from __future__ import annotations

import dataclasses
import math
import os
import threading
import time
from collections.abc import Callable, Iterator
from pathlib import Path
from typing import Any

import numpy as np
import torch

from lambdipy_tpu_torch.models import registry
from lambdipy_tpu_torch.models.graphs import ForwardProgram
from lambdipy_tpu_torch.models.llama import (_next_bucket, init_page_arena,
                                             page_kv_bytes)
from lambdipy_tpu_torch.models.params import load_params
from lambdipy_tpu_torch.ops.attention import flash_attention
from lambdipy_tpu_torch.ops.decode_attention import (blocked_decode_attention,
                                                     paged_decode_attention)
from lambdipy_tpu_torch.ops.quant import int8_matmul
from lambdipy_tpu_torch.runtime.batching import MicroBatcher
from lambdipy_tpu_torch.runtime.continuous import ContinuousBatcher
from lambdipy_tpu_torch.runtime.faults import FaultPlan
from lambdipy_tpu_torch.runtime.kvwire import (StreamDecoder, decode_frame,
                                               dtype_name, encode_chunk,
                                               encode_frame,
                                               encode_stream_header)
from lambdipy_tpu_torch.runtime.metrics import KvShipStats
from lambdipy_tpu_torch.runtime.offload import OffloadArena
from lambdipy_tpu_torch.runtime.pagepool import (PagePool, PagesExhausted,
                                                 page_width)
from lambdipy_tpu_torch.runtime.prefixstore import PrefixStore
from lambdipy_tpu_torch.sched.policy import make_policy
from lambdipy_tpu_torch.utils.logs import get_logger
from lambdipy_tpu_torch.utils.platform import resolve_device


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
    # the MicroBatcher behind invoke_fn, when batch_window_ms > 0 and no
    # engine
    batcher: Any = None
    # the automatic prefix KV cache, when one is built
    prefix_store: Any = None
    # prompt ids -> tokens the prefix store would reuse: the scheduler
    # prices the suffix a cache hit will prefill
    prefix_probe: Callable[[Any], int] | None = None
    # the spec's extra: the server reads its sched_* keys, batch_mode
    # and batch_max from it
    extra: dict = dataclasses.field(default_factory=dict)
    # O(1) engine fault state ({"wedged", "degrade_level", "restarting"}):
    # /healthz reports it and admission sheds on it
    engine_fault_fn: Callable[[], dict] | None = None
    # host-only invariant sweep (GET /v1/debug/invariants): the pool's
    # conservation, the store's accounting, the engine's fault state
    debug_invariants_fn: Callable[[], dict] | None = None
    # the K/V ship surfaces (runtime/kvwire.py frames over the prefix
    # store; None without a store, and /v1/kv/* answers 404): export a
    # request's whole-block head as a frame, import a frame as a radix
    # insert, probe the head's present blocks; and the streamed twins, a
    # generator of frames out and an iterator of body chunks in
    kv_export_fn: Callable[[dict], Any] | None = None
    kv_import_fn: Callable[[bytes], dict] | None = None
    kv_probe_fn: Callable[[dict], dict] | None = None
    kv_export_stream_fn: Callable[[dict], Any] | None = None
    kv_import_stream_fn: Callable[..., dict] | None = None
    # DELETE /v1/sessions/{id}: release the session's pins now
    session_end_fn: Callable[[str], dict] | None = None
    # host-only fault control (POST /v1/debug/faults): arm a spec on the
    # live plan, or clear it
    faults_admin_fn: Callable[[dict], dict] | None = None
    # host-only knob control (POST /v1/debug/knobs): retune the engine's
    # pipeline_depth, spec_k, draft_mode and max_logical_ctx live
    knobs_admin_fn: Callable[[dict], dict] | None = None
    # O(1) read: the background warm is running (/healthz "warming", and
    # "ready" false meanwhile)
    warming_fn: Callable[[], bool] | None = None
    # a classify handler's compiled forward (models/graphs.py
    # ForwardProgram; its model is .model), for callers that drive it
    # directly
    forward: Any = None

    def invoke(self, request: dict) -> dict:
        """JAX's: the handler gets a copy of ``request`` (``{}`` for
        None), and its result a ``latency_ms`` unless it set one."""
        t0 = time.monotonic()
        out = self.invoke_fn(dict(request or {}))
        out.setdefault("latency_ms", round((time.monotonic() - t0) * 1e3, 3))
        return out

    def invoke_stream(self, request: dict) -> Iterator[dict]:
        if self.invoke_stream_fn is None:
            raise ValueError("handler does not support streaming")
        return self.invoke_stream_fn(dict(request or {}))

    def stats(self) -> dict:
        return self.stats_fn() if self.stats_fn is not None else {}


@dataclasses.dataclass
class HandlerContext:
    """What a handler gets at init, JAX's fields (``runtime/loader.py``)
    beside the port's. The weights come from ``state_dict`` (e.g. from
    ``models/params.py from_jax_params``), else from the bundle's
    ``params_dir`` (its ``params.fpk``), else random weights made on the
    device from seed 0. ``device`` None means the card."""

    device: Any = None
    state_dict: dict | None = None
    bundle_dir: Path | None = None
    manifest: dict = dataclasses.field(default_factory=dict)
    params_dir: Path | None = None
    spec: dict = dataclasses.field(default_factory=dict)  # the payload

    def degraded(self) -> list[str]:
        return list(self.manifest.get("provenance", {})
                    .get("skipped_optional", []))


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


# engine extras of the JAX handler whose features need a serving mesh,
# which the port does not have yet: the value each may take (the feature
# off), anything else raises naming its ROADMAP item
_UNPORTED_ENGINE_EXTRAS = {
    "prefill_mode": ("chunked",),
    "mesh": ("", "off"),
}
_UNPORTED_ITEM = {
    "prefill_mode": "ROADMAP queue 1, item 3 (e): sequence parallelism",
    "mesh": "ROADMAP queue 1, item 3 (c): tensor parallelism",
}
# the variables the JAX handler reads for those features when their extra
# is unset (the extra wins): a value that turns the feature on raises too
_UNPORTED_ENV = {"LAMBDIPY_MESH": "mesh",
                 "LAMBDIPY_PREFILL_MODE": "prefill_mode"}


def _check_unported_extras(extra: dict) -> None:
    for key, off in _UNPORTED_ENGINE_EXTRAS.items():
        if key in extra and str(extra[key]).strip().lower() not in off:
            raise ValueError(
                f"extra {key}={extra[key]!r} needs a feature the port does "
                f"not have yet; supported: {key} in {list(off)} or unset "
                f"({_UNPORTED_ITEM[key]})")
    for env, key in _UNPORTED_ENV.items():
        raw = os.environ.get(env)
        if key not in extra and raw is not None \
                and raw.strip().lower() not in _UNPORTED_ENGINE_EXTRAS[key]:
            raise ValueError(
                f"{env}={raw!r} needs a feature the port does not have "
                f"yet; supported: {list(_UNPORTED_ENGINE_EXTRAS[key])} or "
                f"unset ({_UNPORTED_ITEM[key]})")


def _on(value) -> bool:
    return str(value).strip().lower() not in ("", "0", "false", "off")


def prefix_block(extra: dict) -> int:
    """The one resolution of the prefix block width, shared by the page
    pool (its page width) and the prefix store (its radix block): the
    ``LAMBDIPY_PREFIX_BLOCK`` environment first, then the extra, then 32
    (JAX ``handlers.py:483-487``)."""
    raw = os.environ.get("LAMBDIPY_PREFIX_BLOCK")
    if raw in (None, ""):
        raw = extra.get("prefix_block")
    return int(raw) if raw not in (None, "") else 32


def _store_knob(extra: dict, key: str, env: str, default):
    """A store knob as the JAX handler reads it: the environment (the serve
    process's choice) first, then the extra, as a float; ``default`` when
    neither is set."""
    raw = os.environ.get(env)
    if raw in (None, ""):
        raw = extra.get(key)
    return default if raw in (None, "") else float(raw)


def make_prefix_store(server, engine, extra: dict,
                      batcher=None) -> PrefixStore | None:
    """The automatic prefix KV cache, built as the JAX handler builds it
    (``lambdipy_tpu/runtime/handlers.py:655-740``): on by default with a
    512 MB budget (``LAMBDIPY_PREFIX_CACHE_MB``, then ``prefix_cache_mb``;
    0 = off); under ``kv_quant`` only when that budget is set (the cached
    prefix reads back quantized, so routed output agrees with unrouted
    only to the quantization's tolerance); not at all where routing must
    stand down: an engine narrower than the model's window (it cannot
    take a full-window prefix row), or a MicroBatcher (``batcher``),
    which has no prefix path, so routing would serialize the concurrent
    traffic it fuses. A paged engine's store shares its
    arena: blocks are pages, and a hit takes them by refcount bump.

    Session pins: ``session_pin_budget_mb`` (default half the cache
    budget, clamped to it), ``session_ttl_s`` (3600) and
    ``session_idle_s`` (600), each after its ``LAMBDIPY_SESSION_*``
    variable. Over a paged engine, ``kv_offload`` (the extra before
    ``LAMBDIPY_KV_OFFLOAD``; off by default) attaches a host offload
    arena of ``kv_offload_mb`` (``LAMBDIPY_KV_OFFLOAD_MB`` first; 256)."""
    cfg = server.model.cfg
    routable = batcher is None and (engine is None
                                    or engine.cache_len == cfg.max_len)
    mb = _store_knob(extra, "prefix_cache_mb", "LAMBDIPY_PREFIX_CACHE_MB",
                     None)
    if not routable or (mb is not None and mb <= 0) \
            or (cfg.kv_quant is not None and mb is None):
        return None
    pool = engine.pool if engine is not None else None
    # the store's cold walks and the engine's chunked prefills report in
    # one prefill block, as in the JAX handler
    store = PrefixStore(
        server, block=prefix_block(extra),
        budget_mb=512.0 if mb is None else mb, pool=pool,
        prefill_stats=engine.prefill_stats if engine is not None else None,
        faults=engine.faults if engine is not None else None,
        pin_budget_mb=_store_knob(extra, "session_pin_budget_mb",
                                  "LAMBDIPY_SESSION_PIN_BUDGET_MB", None),
        session_ttl_s=_store_knob(extra, "session_ttl_s",
                                  "LAMBDIPY_SESSION_TTL_S", 3600.0),
        session_idle_s=_store_knob(extra, "session_idle_s",
                                   "LAMBDIPY_SESSION_IDLE_S", 600.0))
    if pool is not None:
        engine.prefix_pages_fn = store.acquire_pages
        if _on(extra.get("kv_offload",
                         os.environ.get("LAMBDIPY_KV_OFFLOAD", "0"))):
            store.attach_offload(OffloadArena(
                page=pool.page, layers=cfg.layers,
                budget_mb=_store_knob(extra, "kv_offload_mb",
                                      "LAMBDIPY_KV_OFFLOAD_MB", 256.0),
                faults=engine.faults))
    return store


def _flat_tokens(req: dict):
    """A request's ``tokens`` as a flat list of ints, or None."""
    raw = req.get("tokens")
    if not isinstance(raw, (list, tuple)) or not raw or \
            not all(isinstance(t, int) for t in raw):
        return None
    return list(raw)


def kv_ship_fns(store: PrefixStore, stats: KvShipStats) -> dict:
    """The K/V ship surfaces over ``store``, as the JAX handler wires them
    (``lambdipy_tpu/runtime/handlers.py:745-930``), counted in ``stats``
    (``batching.disagg`` in ``/metrics``). A handler-level refusal comes
    back as an error dict (the server answers 400); a garbage frame
    raises ``ValueError`` (400) and a full arena :class:`PagesExhausted`
    (the priced 503 ``kv_import``)."""

    def leaves():
        return [[name, dtype_name(dt), list(shape)]
                for name, (shape, dt)
                in sorted(store._leaf_template().items())]

    def kv_export(req: dict):
        """``{"tokens": [...]}`` -> one ``LKV1`` frame."""
        raw = _flat_tokens(req)
        if raw is None:
            return {"ok": False,
                    "error": "kv export wants a flat token id list"}
        out = store.export_blocks(raw)
        if out is None:
            return {"ok": False, "error": "no whole-block prefix to export"}
        head, blocks = out
        frame = encode_frame(head, store.block, blocks)
        stats.record_export(tokens=len(head), nbytes=len(frame))
        return frame

    def kv_import(data: bytes) -> dict:
        """One ``LKV1`` frame -> a radix insert."""
        try:
            tokens, block, blocks = decode_frame(data)
            if block != store.block:
                raise ValueError(
                    f"frame block width {block} != this replica's "
                    f"prefix block {store.block}")
            res = store.import_blocks(tokens, blocks)
        except PagesExhausted:
            stats.record_backpressure()
            raise
        except ValueError:
            stats.record_rejected()
            raise
        stats.record_import(tokens=len(tokens), nbytes=len(data),
                            inserted=res["inserted"],
                            present=res["present"], mode=res["mode"])
        return {"ok": True, **res}

    def kv_probe(req: dict) -> dict:
        """``{"tokens": [...]}`` -> the head tokens present in the tree
        (host only)."""
        raw = _flat_tokens(req)
        if raw is None:
            return {"ok": False,
                    "error": "kv probe wants a flat token id list"}
        return {"ok": True, "matched": store.present_len(raw),
                "block": store.block}

    def kv_export_stream(req: dict):
        """``{"tokens": [...], "stream": true}`` -> a generator of frames:
        the ``LKVS`` header, then one ``LKVC`` per block group as the
        store produces it."""
        raw = _flat_tokens(req)
        if raw is None:
            return {"ok": False,
                    "error": "kv export wants a flat token id list"}
        out = store.export_stream(raw)
        if out is None:
            return {"ok": False, "error": "no whole-block prefix to export"}
        head, groups = out
        layers = store.server.model.cfg.layers

        def gen():
            header = encode_stream_header(head, store.block, layers,
                                          leaves())
            nbytes, sent, chunks = len(header), 0, 0
            yield header
            for group in groups:
                frame = encode_chunk(sent, group)
                sent += len(group)
                nbytes += len(frame)
                chunks += 1
                yield frame
            # counted only when complete: a truncated export is the
            # receiver's failure signal, not a served export
            stats.record_export(tokens=len(head), nbytes=nbytes,
                                chunks=chunks)

        return gen()

    def kv_import_stream(chunks_iter, commit_gate=None) -> dict:
        """Body chunks off the wire -> per-chunk validation
        (``StreamDecoder``) and staging -> one attach at the stream's end.
        A failure rolls the staged pages back before it propagates.
        ``commit_gate`` (a context manager) brackets only the commit."""
        dec = StreamDecoder()
        imp = None
        nbytes = chunks = 0
        try:
            for data in chunks_iter:
                nbytes += len(data)
                for kind, payload in dec.feed(data):
                    if kind == "header":
                        if payload["block"] != store.block:
                            raise ValueError(
                                f"stream block width {payload['block']} "
                                f"!= this replica's prefix block "
                                f"{store.block}")
                        imp = store.import_begin(payload["tokens"])
                    elif imp is not None:
                        chunks += 1
                        imp.add_blocks(payload[1])
            if imp is None:
                raise ValueError("empty KV stream (no header)")
            if not dec.complete:
                raise ValueError(f"truncated KV stream: "
                                 f"{dec.blocks_received} block(s) arrived")
            if commit_gate is not None:
                with commit_gate:
                    res = imp.commit()
            else:
                res = imp.commit()
        except BaseException as e:
            if isinstance(e, PagesExhausted):
                stats.record_backpressure()
            elif isinstance(e, ValueError):
                stats.record_rejected()
            stats.record_stream_abort()
            if imp is not None:
                imp.abort()
            raise
        stats.record_import(tokens=len(imp.row), nbytes=nbytes,
                            inserted=res["inserted"],
                            present=res["present"], mode=res["mode"],
                            chunks=chunks)
        return {"ok": True, **res, "streamed": True}

    return {"kv_export_fn": kv_export, "kv_import_fn": kv_import,
            "kv_probe_fn": kv_probe, "kv_export_stream_fn": kv_export_stream,
            "kv_import_stream_fn": kv_import_stream}


def sched_policy_name(extra: dict) -> str:
    """The policy batch formation orders joiners by, resolved as the JAX
    handler and ``SchedConfig.from_extra`` resolve it: the
    ``LAMBDIPY_SCHED_POLICY`` environment (the serve process's choice),
    then the ``sched_policy`` extra, then ``fair``."""
    return (os.environ.get("LAMBDIPY_SCHED_POLICY")
            or extra.get("sched_policy") or "fair")


def pipeline_depth(extra: dict) -> int:
    """The engine's pipeline depth: the ``pipeline_depth`` extra, then
    the ``LAMBDIPY_PIPELINE_DEPTH`` environment, then 2 (the JAX
    default); 1 is the synchronous loop."""
    raw = extra.get("pipeline_depth",
                    os.environ.get("LAMBDIPY_PIPELINE_DEPTH", "2"))
    depth = int(raw)
    if depth < 1:
        raise ValueError(f"pipeline_depth must be >= 1, got {raw!r}")
    return depth


def fault_knobs(extra: dict) -> dict:
    """The engine's fault isolation, resolved as the JAX handler resolves
    it (``handlers.py:522-537``), the extra before the environment: the
    watchdog (``engine_watchdog_s``, ``LAMBDIPY_ENGINE_WATCHDOG_S``, 0 =
    off), the replays of a row that delivered nothing (``max_replays``,
    ``LAMBDIPY_MAX_REPLAYS``, 1) and the injection plan (``fault_spec``,
    ``LAMBDIPY_FAULT``, empty)."""
    wd = extra.get("engine_watchdog_s",
                   os.environ.get("LAMBDIPY_ENGINE_WATCHDOG_S", "0"))
    mr = extra.get("max_replays", os.environ.get("LAMBDIPY_MAX_REPLAYS",
                                                 "1"))
    spec = str(extra.get("fault_spec", os.environ.get("LAMBDIPY_FAULT",
                                                      "")) or "")
    return {"watchdog_s": float(wd or 0), "max_replays": int(mr),
            "faults": FaultPlan.from_spec(spec) if spec.strip() else None}


def spec_knobs(extra: dict) -> dict:
    """The engine's speculative decoding, resolved as the JAX handler
    resolves it (``handlers.py:538-560``), the extra before the
    environment: ``spec_k`` (``LAMBDIPY_SPEC_K``, 0 = off), ``draft_mode``
    (``LAMBDIPY_DRAFT_MODE``, ``lookup``) and ``draft_exit``
    (``LAMBDIPY_DRAFT_EXIT``, 1)."""
    sk = extra.get("spec_k", os.environ.get("LAMBDIPY_SPEC_K", "0"))
    mode = extra.get("draft_mode", os.environ.get("LAMBDIPY_DRAFT_MODE",
                                                  "lookup"))
    dexit = extra.get("draft_exit", os.environ.get("LAMBDIPY_DRAFT_EXIT",
                                                   "1"))
    return {"spec_k": int(sk or 0), "draft_mode": str(mode or "lookup"),
            "draft_exit": int(dexit or 1)}


def longctx_knobs(extra: dict) -> dict:
    """The long-context tier, resolved as the JAX handler resolves it
    (``handlers.py:560-571``), the extra before the environment:
    ``max_logical_ctx`` (``LAMBDIPY_MAX_LOGICAL_CTX``, 0 = off) and
    ``long_prefill`` (``LAMBDIPY_LONG_PREFILL``, off)."""
    mlc = extra.get("max_logical_ctx",
                    os.environ.get("LAMBDIPY_MAX_LOGICAL_CTX", "0"))
    lpf = extra.get("long_prefill",
                    os.environ.get("LAMBDIPY_LONG_PREFILL", "0"))
    return {"max_logical_ctx": int(mlc or 0), "long_prefill": _on(lpf)}


def make_engine(server, extra: dict) -> ContinuousBatcher:
    """The continuous engine the extras ask for: ``batch_max`` slots,
    ``batch_segment`` steps per segment, ``batch_cache_len`` positions
    per row (default ``max_len``), :func:`pipeline_depth` segments in
    flight, joiners ordered by :func:`sched_policy_name`, the fault
    isolation of :func:`fault_knobs`, the speculative decoding of
    :func:`spec_knobs`, the long-context tier of :func:`longctx_knobs`
    and, with ``kv_paged`` (the extra before ``LAMBDIPY_KV_PAGED``), a
    page arena of ``kv_pages`` pages (the extra before
    ``LAMBDIPY_KV_PAGES``; default ``batch_max`` full windows plus the
    null page) whose page width is ``page_width(cache_len,
    prefix_block)`` (:func:`prefix_block`, default 32). Window bucketing
    is on unless ``batch_window_bucketing`` (the extra before
    ``LAMBDIPY_WINDOW_BUCKETING``) says ``0``, ``false`` or ``off``, as in
    JAX."""
    cfg = server.model.cfg
    slots = int(extra.get("batch_max", 8))
    bcl = extra.get("batch_cache_len")
    cache_len = min(int(bcl) if bcl else cfg.max_len, cfg.max_len)
    pool = None
    if _on(extra.get("kv_paged", os.environ.get("LAMBDIPY_KV_PAGED", "0"))):
        page = page_width(cache_len, prefix_block(extra))
        window_pages = cache_len // page
        raw = extra.get("kv_pages", os.environ.get("LAMBDIPY_KV_PAGES"))
        n_pages = max(2, int(raw) if raw not in (None, "")
                      else slots * window_pages + 1)
        pool = PagePool(
            n_pages=n_pages, page=page, page_bytes=page_kv_bytes(cfg, page),
            make_arena=lambda: init_page_arena(cfg, n_pages, page,
                                               server.device),
            window_pages=window_pages)
    wb = extra.get("batch_window_bucketing",
                   os.environ.get("LAMBDIPY_WINDOW_BUCKETING", "1"))
    return ContinuousBatcher(server, slots=slots,
                             segment=int(extra.get("batch_segment", 16)),
                             cache_len=cache_len, page_pool=pool,
                             policy=make_policy(sched_policy_name(extra)),
                             window_bucketing=str(wb).lower()
                             not in ("0", "false", "off"),
                             pipeline_depth=pipeline_depth(extra),
                             **fault_knobs(extra), **spec_knobs(extra),
                             **longctx_knobs(extra))


def generate_handler(spec: dict, ctx: HandlerContext) -> HandlerState:
    """Llama generation: greedy by default; requests may set temperature,
    top_k, top_p, seed and eos_id for sampled decode, ``logprobs``, and
    ``stream`` (through :meth:`HandlerState.invoke_stream`). With
    ``batch_mode="continuous"`` single-row requests share the continuous
    engine (:func:`make_engine`); otherwise, with ``batch_window_ms > 0``,
    concurrent single-row requests fuse in the MicroBatcher
    (``runtime/batching.py``); multi-row requests run as one batch.
    On the card decode steps replay CUDA graphs, at most
    ``program_cache_max`` programs (extra) beside the engine's; a
    ``{"warmup": true}`` request captures its bucket's graph.

    Single-row requests route through the prefix store
    (:func:`make_prefix_store`) unless they carry an explicit ``prefix``
    (the client's split is kept): the prompt's longest cached block head
    becomes the ``prefix=`` of a suffix-only request, and a response
    served from a cached prefix says ``"prefix_cached": true``."""
    extra = dict(spec.get("extra") or {})
    _check_unported_extras(extra)
    # a converted checkpoint records its architecture in the manifest; it
    # overrides the builder's defaults for the model alone, as in JAX
    # (handlers.py:172-180)
    payload = ctx.manifest.get("payload") or {}
    model_extra = {**extra,
                   **((payload.get("params_info") or {}).get("config") or {})}
    # dtype and quant fall back to the builder's defaults when the spec
    # leaves them out (llama3-8b: bfloat16, int8)
    adapter = registry.get(spec["model"]).build(
        extra=model_extra,
        **{k: spec[k] for k in ("dtype", "quant") if k in spec})
    state_dict = ctx.state_dict
    if state_dict is None and ctx.params_dir is not None:
        # the bundle's params.fpk, straight onto the device
        state_dict = load_params(ctx.params_dir, adapter.config, ctx.device)
    server_kw = {}
    if extra.get("program_cache_max") is not None:
        # LRU bound on the decode programs (a CUDA graph and its decode
        # cache each); rising program_evictions in /metrics means it is
        # too small for the workload's bucket diversity
        server_kw["program_cache_max"] = int(extra["program_cache_max"])
    if extra.get("prefix_cache_max") is not None:
        # LRU bound on the server's full-window prefix entries
        server_kw["prefix_cache_max"] = int(extra["prefix_cache_max"])
    # the JAX handler's server arguments (handlers.py:422-443): the decode
    # cap (None = the window), chunked prefill (off unless set: a long
    # prefix or engine joiner prefills in chunks that other work
    # interleaves with) and the smallest prompt and decode bucket
    if extra.get("decode_cap"):
        server_kw["decode_cap"] = int(extra["decode_cap"])
    if extra.get("prefill_chunk") is not None:
        server_kw["prefill_chunk"] = int(extra["prefill_chunk"])
    if extra.get("min_bucket") is not None:
        server_kw["min_bucket"] = int(extra["min_bucket"])
    # on the card every decode step replays a captured CUDA graph
    server = adapter.make_server(state_dict, device=ctx.device,
                                 **server_kw)
    # batch formation as in JAX (handlers.py:460-650): batch_mode
    # continuous builds the engine; otherwise batch_window_ms > 0 builds
    # the MicroBatcher, whose ragged calls single-row requests share;
    # otherwise each request runs alone
    engine = micro = None
    if str(extra.get("batch_mode") or "").lower() == "continuous":
        engine = make_engine(server, extra)
    elif float(extra.get("batch_window_ms", 0) or 0) > 0:
        micro = MicroBatcher(server,
                             window_ms=float(extra["batch_window_ms"]),
                             max_batch=int(extra.get("batch_max", 8)),
                             policy=make_policy(sched_policy_name(extra)))
    store = make_prefix_store(server, engine, extra, batcher=micro)
    default_new = int(extra.get("max_new_tokens", 16))

    # text in, text out (JAX handlers.py:1176-1192): a tokenizer shipped
    # in the bundle, loaded with transformers if it is installed; absent,
    # the handler serves token ids and says why in its meta
    tokenizer, tok_err = None, None
    tok_path = extra.get("tokenizer_path")
    if tok_path:
        resolved = Path(tok_path)
        if not resolved.is_absolute() and ctx.bundle_dir is not None:
            resolved = Path(ctx.bundle_dir) / resolved
        try:
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(
                str(resolved), local_files_only=True)
        except Exception as e:  # noqa: BLE001 — degrade, recorded in meta
            tok_err = str(e)

    def decode_text(row: list, eos) -> str:
        """``row`` cut before its eos, as text."""
        if eos is not None and eos in row:
            row = row[:row.index(eos)]
        return tokenizer.decode(row)

    def _route_prefix(prompt, prefix, sess=None):
        """Transparent radix reuse: a single-row prompt split into (suffix
        prompt, cached prefix tokens) when the store matches or extends a
        block-aligned head. An explicit ``prefix`` keeps the client's
        split; multi-row and sub-block prompts pass through; a store
        failure routes nothing (``route`` returns 0). At the engine's
        degradation level 3 routing stands down: the plainest path until
        a clean interval restores it.

        ``sess`` = (session_id, ttl_s or None): after routing, the
        conversation's whole-block head is pinned under the session's
        lease (a budget refusal raises ``SessionPinsExceeded``, which the
        server answers as the priced 503 ``session_pins``); a stand-down
        only renews the lease."""
        if store is None or prefix is not None or len(prompt) != 1:
            return prompt, prefix
        if engine is not None and engine.degrade_level >= 3:
            if sess is not None:
                store.touch_session(sess[0])
            return prompt, prefix
        row = [int(t) for t in np.asarray(prompt[0]).reshape(-1)]
        m = store.route(row)
        if sess is not None:
            # after route: the head's blocks exist now
            store.pin_session(sess[0], row, ttl_s=sess[1])
        if m <= 0:
            return prompt, prefix
        return ([np.asarray(row[m:], np.int32)],
                np.asarray(row[:m], np.int32))

    def parse(req: dict):
        """Request -> (prompt, max_new, sample_kwargs, want_logprobs,
        prefix, speculative k or None, session or None, from_text), or an
        error dict."""
        from_text = False
        if req.get("warmup") or req.get("random"):
            if req.get("warmup") and micro is not None:
                # every batch bucket the MicroBatcher can form, up to the
                # one max_batch rounds up to, run now (JAX
                # handlers.py:1286-1297): a first burst finds its programs
                bb, top = 2, _next_bucket(micro.max_batch, 1)
                while bb <= top:
                    server.generate([[1, 2, 3, 4]] * bb,
                                    max_new_tokens=default_new)
                    bb *= 2
            prompt = np.asarray([[1, 2, 3, 4]], np.int32)
        elif req.get("text") is not None:
            if tokenizer is None:
                return {"ok": False,
                        "error": "bundle has no tokenizer; send 'tokens'"}
            ids = tokenizer(req["text"])["input_ids"]
            if not ids:
                return {"ok": False,
                        "error": "prompt tokenized to zero tokens"}
            prompt = np.asarray([ids], np.int32)
            from_text = True
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
        if sample_kwargs["eos_id"] is None and from_text and \
                tokenizer.eos_token_id is not None:
            # a text prompt stops at the tokenizer's eos
            sample_kwargs["eos_id"] = int(tokenizer.eos_token_id)
        prefix = req.get("prefix")
        if prefix is not None:
            prefix = np.asarray(prefix, np.int32).reshape(-1)
            if prefix.size == 0:
                return {"ok": False, "error": "empty prefix"}
            if len(prompt) != 1:
                return {"ok": False, "error": "prefix caching is single-row"}
        spec_k = req.get("speculative")
        if spec_k is not None:
            try:
                spec_k = int(spec_k)
            except (TypeError, ValueError):
                return {"ok": False, "error": "speculative must be an "
                                              "integer draft length"}
            if len(prompt) != 1:
                return {"ok": False, "error": "speculative decoding is "
                                              "single-row"}
        # a multi-turn session: ``session_id`` pins the conversation's
        # prefix K/V under a lease; ``session_ttl_s`` may tighten it
        sess = None
        sid = req.get("session_id")
        if sid is not None and str(sid):
            try:
                ttl = (float(req["session_ttl_s"])
                       if req.get("session_ttl_s") is not None else None)
            except (TypeError, ValueError):
                return {"ok": False,
                        "error": "session_ttl_s must be a number"}
            sess = (str(sid), ttl)
        return (prompt, max_new, sample_kwargs, bool(req.get("logprobs")),
                prefix, spec_k, sess, from_text)

    def n_prompt(prompt, prefix) -> int:
        return int(sum(len(r) for r in prompt)
                   + (len(prefix) if prefix is not None else 0))

    def invoke(req: dict) -> dict:
        parsed = parse(req)
        if isinstance(parsed, dict):
            return parsed
        try:
            return _invoke_parsed(parsed)
        finally:
            # the first completed invoke (the boot warmup) releases the
            # background warm
            _maybe_start_warm()

    def _invoke_parsed(parsed) -> dict:
        (prompt, max_new, sample_kwargs, want_lp, prefix, spec_k, sess,
         from_text) = parsed
        prompt, prefix = _route_prefix(prompt, prefix, sess)
        spec_stats = None
        if spec_k is not None:
            # speculative decoding: prompt-lookup drafts verified in
            # chunks, solo (the engine is bypassed, as in JAX); the
            # request's counters come back with the call
            out_, spec_stats = server.generate_speculative(
                prompt, max_new_tokens=max_new, k=spec_k, prefix=prefix,
                return_logprobs=want_lp, return_stats=True, **sample_kwargs)
        elif engine is not None and len(prompt) == 1:
            out_ = engine.generate(prompt[0], max_new_tokens=max_new,
                                   prefix=prefix, return_logprobs=want_lp,
                                   **sample_kwargs)
        elif micro is not None and len(prompt) == 1 and prefix is None:
            # the MicroBatcher has no prefix path: a prefix request runs
            # alone, as in JAX
            out_ = micro.generate(prompt[0], max_new_tokens=max_new,
                                  return_logprobs=want_lp, **sample_kwargs)
        else:
            out_ = server.generate(prompt, max_new_tokens=max_new,
                                   prefix=prefix, return_logprobs=want_lp,
                                   **sample_kwargs)
        toks, lps = out_ if want_lp else (out_, None)
        out = {"ok": True, "tokens": toks.tolist(),
               "n_new": int(toks.shape[-1]),
               "n_prompt": n_prompt(prompt, prefix)}
        if lps is not None:
            out["logprobs"] = [[round(float(x), 5) for x in row]
                               for row in lps]
        if sample_kwargs["eos_id"] is not None:
            out["eos_id"] = sample_kwargs["eos_id"]
        if prefix is not None:
            out["prefix_cached"] = True
        if spec_stats is not None:
            out["speculative"] = spec_stats
        if from_text:
            out["completion"] = decode_text(toks[0].tolist(),
                                            sample_kwargs["eos_id"])
        return out

    def invoke_stream(req: dict):
        """Chunk records as the decode emits them, then a summary record
        ``{"ok": true, "done": true, ...}``; concatenated chunk tokens
        equal the non-streamed response."""
        parsed = parse(req)
        if isinstance(parsed, dict):
            yield parsed
            return
        (prompt, max_new, sample_kwargs, want_lp, prefix, spec_k, sess,
         from_text) = parsed
        prompt, prefix = _route_prefix(prompt, prefix, sess)
        # a pow-2 segment in [4, 64], as the JAX handler clamps it: a
        # program key, so a request cannot grow the program cache
        segment = min(64, _next_bucket(max(4, int(req.get("segment") or 16)),
                                       4))
        spec_stats = None
        if spec_k is not None:
            # one chunk per verify step: its accepted tokens
            spec_stats = {}
            chunks = server.generate_speculative_stream(
                prompt[0], max_new_tokens=max_new, k=spec_k, prefix=prefix,
                return_logprobs=want_lp, stats_out=spec_stats,
                **sample_kwargs)
        elif engine is not None and len(prompt) == 1:
            # the engine's segment sets the chunk cadence; the request's
            # reaches a row the engine sends solo
            chunks = engine.generate_stream(
                prompt[0], max_new_tokens=max_new, segment=segment,
                prefix=prefix, return_logprobs=want_lp, **sample_kwargs)
        else:
            chunks = server.generate_stream(
                prompt, max_new_tokens=max_new, segment=segment,
                prefix=prefix, return_logprobs=want_lp, **sample_kwargs)
        n_new = 0
        row0, text_emitted, chunked = [], "", False
        for chunk in chunks:
            chunked = True
            chunk, lp_chunk = chunk if want_lp else (chunk, None)
            n_new += int(chunk.shape[1])
            rec = {"ok": True, "tokens": chunk.tolist()}
            if lp_chunk is not None:
                rec["logprobs"] = [[round(float(x), 5) for x in row]
                                   for row in lp_chunk]
            if from_text:
                # the delta since the last chunk (JAX handlers.py:1531-
                # 1552): the whole row decoded each time, a trailing
                # incomplete UTF-8 sequence held back; when decoding
                # changes text already sent, nothing, and the summary's
                # tail closes the gap
                row0.extend(rec["tokens"][0])
                full = decode_text(row0, sample_kwargs["eos_id"]).rstrip(
                    "\ufffd")
                if full.startswith(text_emitted):
                    rec["text"] = full[len(text_emitted):]
                    text_emitted = full
                else:
                    rec["text"] = ""
            yield rec
        out = {"ok": True, "done": True, "n_new": n_new,
               "n_prompt": n_prompt(prompt, prefix)}
        if spec_stats is not None:
            out["speculative"] = spec_stats
        if sample_kwargs["eos_id"] is not None:
            out["eos_id"] = sample_kwargs["eos_id"]
        if prefix is not None:
            out["prefix_cached"] = True
        if from_text and chunked:
            completion = decode_text(row0, sample_kwargs["eos_id"])
            out["completion"] = completion
            # the tail a delta-concatenating client still needs: at most
            # the span that diverged from the text sent repeats
            out["text"] = completion[len(os.path.commonprefix(
                [completion, text_emitted])):]
        yield out
        # a streaming-only workload releases the warm too
        _maybe_start_warm()

    # one live fault plan serves the engine (and through it the pool and
    # the store): armed and cleared at run time, reported in /metrics
    live_faults = engine.faults if engine is not None else None

    def debug_invariants() -> dict:
        """Host-only: the pool's conservation and the store's accounting
        (``ok`` covers these), with the engine's fault state beside
        them."""
        ok, checks = True, {}
        if engine is not None and engine.pool is not None:
            try:
                engine.pool.check_invariants()
                checks["page_pool"] = {"ok": True}
            except AssertionError as e:
                checks["page_pool"] = {"ok": False, "error": str(e)}
            checks["page_pool"]["stats"] = engine.pool.stats()
            ok = ok and checks["page_pool"]["ok"]
        if store is not None:
            checks["prefix_store"] = store.check_invariants()
            ok = ok and checks["prefix_store"]["ok"]
        if engine is not None:
            checks["engine"] = engine.fault_state()
        return {"ok": ok, "checks": checks}

    def faults_admin(req: dict) -> dict:
        """``{"spec": "site:kind@..."}`` arms rules on the live plan,
        ``{"clear": true}`` drops them and releases hangs in flight."""
        if live_faults is None:
            return {"ok": False,
                    "error": "no fault plan on this handler (no continuous "
                             "engine)"}
        if req.get("clear"):
            return {"ok": True, "cleared": live_faults.clear(),
                    "armed": live_faults.armed()}
        spec = req.get("spec")
        if not spec:
            return {"ok": False,
                    "error": "want {\"spec\": \"site:kind@...\"} or "
                             "{\"clear\": true}"}
        try:
            added = live_faults.arm(str(spec))
        except ValueError as e:
            return {"ok": False, "error": str(e)}
        return {"ok": True, "added": added, "armed": live_faults.armed()}

    # whether speculation was on at boot: the knob resizes it, never
    # turns it on
    spec_boot_on = engine is not None and engine.spec_k >= 2

    def knobs_admin(req: dict) -> dict:
        """``POST /v1/debug/knobs`` (host-only): retune the engine's
        per-dispatch knobs live, with the JAX handler's clamps and
        refusals (``handlers.py:996-1097``): ``pipeline_depth`` in [1, 8];
        ``spec_k`` 0 or a power of two in [2, 8], resizing speculation
        that was on at boot and never turning it on; ``draft_mode``
        model / lookup / aux / off (``auto`` is model; ``aux`` needs the
        engine's ``draft_provider``); ``max_logical_ctx`` (paged KV
        only; 0 stops routing). ``prefill_mode`` takes ``chunked`` only:
        its ``sp`` mode waits for parallelism."""
        if engine is None:
            return {"ok": False,
                    "error": "no continuous engine on this handler "
                             "(pipeline_depth/spec_k are engine knobs)"}
        known = {"pipeline_depth", "spec_k", "draft_mode",
                 "max_logical_ctx", "prefill_mode"}
        unknown = sorted(set(req) - known)
        if unknown or not (set(req) & known):
            return {"ok": False,
                    "error": f"want a subset of {sorted(known)}, got "
                             f"{sorted(req) or 'nothing'}"}
        if "pipeline_depth" in req:
            try:
                d = int(req["pipeline_depth"])
            except (TypeError, ValueError):
                return {"ok": False, "error": "pipeline_depth wants an int"}
            if not 1 <= d <= 8:
                return {"ok": False,
                        "error": f"pipeline_depth {d} out of range [1, 8]"}
            engine.pipeline_depth = d
            engine.pipe_stats.depth = d
        if "spec_k" in req:
            try:
                k = int(req["spec_k"])
            except (TypeError, ValueError):
                return {"ok": False, "error": "spec_k wants an int"}
            if k != 0 and not spec_boot_on:
                return {"ok": False,
                        "error": "spec_k was off at boot: live retune only "
                                 "resizes speculation, never enables it"}
            if k != 0:
                k = min(8, max(2, _next_bucket(k, 2)))
            engine.spec_k = k
        if "draft_mode" in req:
            dm = str(req["draft_mode"] or "").lower()
            if dm == "auto":
                dm = "model"
            if dm not in ("model", "lookup", "aux", "off"):
                return {"ok": False,
                        "error": "draft_mode wants one of "
                                 "model|lookup|aux|off"}
            if dm in ("model", "aux") and not spec_boot_on:
                return {"ok": False,
                        "error": "spec was off at boot: draft_mode "
                                 "retune steers a live draft tier, "
                                 "never enables one"}
            if dm == "aux" and engine.draft_provider is None:
                return {"ok": False,
                        "error": "draft_mode=aux needs a draft_provider "
                                 "wired at boot"}
            # rows admitted from here on; rows in flight keep theirs
            engine.draft_mode = dm
        if "prefill_mode" in req:
            pm = str(req["prefill_mode"] or "").lower()
            if pm not in ("chunked", "sp"):
                return {"ok": False,
                        "error": "prefill_mode wants chunked|sp"}
            if pm != "chunked":
                return {"ok": False,
                        "error": "prefill_mode=sp needs an sp mesh, which "
                                 "the port does not have yet"}
        if "max_logical_ctx" in req:
            try:
                m = int(req["max_logical_ctx"])
            except (TypeError, ValueError):
                return {"ok": False,
                        "error": "max_logical_ctx wants an int"}
            if m != 0 and engine.pool is None:
                return {"ok": False,
                        "error": "max_logical_ctx needs paged KV "
                                 "(kv_paged) at boot"}
            m = max(0, m)
            engine.max_logical_ctx = m
            if engine._longctx is not None and m:
                # a live runner reads its admission cap again; 0 only
                # stops routing
                engine._longctx.max_logical_ctx = m
        return {"ok": True,
                "pipeline_depth": engine.pipeline_depth,
                "spec_k": engine.spec_k,
                "draft_mode": engine.draft_mode,
                "max_logical_ctx": engine.max_logical_ctx,
                "prefill_mode": "chunked"}

    # the background warm (JAX handlers.py:1100-1172): after the first
    # invoke completes, never at init, a daemon thread runs one generate
    # per bucket that warm_buckets lists, then the engine's group prefill
    # (warm_group_prefill, on unless "0"). On the card each run captures
    # its graphs under DEVICE_LOCK, as every capture does; they land in the
    # server's program cache, bounded by program_cache_bytes.
    # "in_flight" is the readiness signal /healthz reads.
    warm_state = {"requested": [], "done": [], "errors": [],
                  "in_flight": False}
    raw_buckets = extra.get("warm_buckets")
    if raw_buckets:
        warm_state["requested"] = sorted(
            {int(tok) for tok in str(raw_buckets).split(",") if tok.strip()})
    warm_lock = threading.Lock()
    warm_started = False
    warm_group = (engine is not None
                  and str(extra.get("warm_group_prefill", "1")) != "0")

    def _maybe_start_warm():
        nonlocal warm_started
        if not warm_state["requested"] and not warm_group:
            return
        with warm_lock:  # one warm thread
            if warm_started:
                return
            warm_started = True
            # set before the thread exists: no probe reads ready while the
            # warm is committed
            warm_state["in_flight"] = True

        def _warm():
            for size in warm_state["requested"]:
                try:
                    server.generate([list(range(1, size + 1))],
                                    max_new_tokens=default_new)
                    with warm_lock:
                        warm_state["done"].append(size)
                except Exception as e:  # noqa: BLE001 — background, never
                    # fatal, and one bad bucket leaves the rest
                    with warm_lock:
                        warm_state["errors"].append(f"bucket {size}: {e}")
            if warm_group:
                try:
                    n = engine.warm_group_prefill()
                    with warm_lock:
                        warm_state["done"].append(f"group_prefill:{n}")
                except Exception as e:  # noqa: BLE001 — as above
                    with warm_lock:
                        warm_state["errors"].append(f"group_prefill: {e}")
            # JAX saves the programs to its AOT store here; a CUDA graph
            # does not outlive its process, so the port has nothing to save
            with warm_lock:
                warm_state["in_flight"] = False

        threading.Thread(target=_warm, daemon=True,
                         name="bucket-warm").start()

    def stats() -> dict:
        # decode_buckets, compile_count, program_evictions as the JAX
        # handler reports them, plus replays and eager_steps
        out = {"kernels": kernel_launches(), **server.program_stats()}
        if engine is not None or micro is not None:
            out["batching"] = (engine or micro).stats()
        # the solo "speculative" path's cumulative counters (the engine's
        # batching.spec block reads the same object)
        out["spec"] = server.spec_metrics.report()
        if store is not None:
            # hits, misses, hit_tokens, evictions, bytes and hit_rate: the
            # automatic radix reuse, with the assembled entries' bytes and
            # the session pins' gauges
            out["prefix_cache"] = store.stats()
            # the K/V ship's counters, under batching as in JAX (with or
            # without an engine)
            out.setdefault("batching", {})["disagg"] = ship_stats.report()
        if live_faults is not None:
            # the live injection plan: a stray LAMBDIPY_FAULT shows here
            out["faults"] = {"armed": live_faults.armed()}
        if warm_state["requested"] or warm_group:
            # what was asked, visible while it runs
            with warm_lock:
                out["warm_buckets"] = {
                    k: list(v) if isinstance(v, list) else v
                    for k, v in warm_state.items()}
        return out

    ship_stats = KvShipStats()
    ship = kv_ship_fns(store, ship_stats) if store is not None else {}
    cfg = adapter.config
    return HandlerState(
        invoke_fn=invoke,
        meta={"model": spec["model"], "max_len": cfg.max_len,
              "device": str(server.device),
              "attn_backend": cfg.attn_backend,
              "matmul_backend": cfg.matmul_backend,
              "kv_quant": cfg.kv_quant,
              "batch_mode": ("continuous" if engine is not None
                             else "window" if micro is not None else None),
              "kv_paged": engine is not None and engine.pool is not None,
              "prefix_cache": store is not None,
              "sessions": store is not None,
              "kv_ship": store is not None,
              "tokenizer": tokenizer is not None,
              **({"tokenizer_error": tok_err} if tok_err else {})},
        stats_fn=stats, server=server, invoke_stream_fn=invoke_stream,
        engine=engine, batcher=micro, prefix_store=store,
        prefix_probe=store.match_len if store is not None else None,
        extra=extra,
        engine_fault_fn=engine.fault_state if engine is not None else None,
        debug_invariants_fn=debug_invariants, faults_admin_fn=faults_admin,
        knobs_admin_fn=knobs_admin,
        # a bare dict read: what a health probe may cost
        warming_fn=lambda: bool(warm_state["in_flight"]),
        session_end_fn=store.end_session if store is not None else None,
        **ship)



# ----------------------------------------------------------------------
# BASELINE.json configs 1-4: hello, tabular, image and text classification
# (JAX handlers.py:117-346, :1677-1731)


def hello_handler(spec: dict, ctx: HandlerContext) -> HandlerState:
    """Config 1: numpy and scipy hello world, a small deterministic linalg
    op on the host, as in JAX."""
    from scipy import linalg

    def invoke(req: dict) -> dict:
        n = int(req.get("n", 64))
        rng = np.random.default_rng(int(req.get("seed", 0)))
        a = rng.normal(size=(n, n))
        sign, logdet = np.linalg.slogdet(a @ a.T + n * np.eye(n))
        lu = linalg.lu_factor(a + n * np.eye(n))[0]
        return {"ok": True, "n": n, "logdet": float(logdet * sign),
                "lu_trace": float(np.trace(lu)), "numpy": np.__version__}

    return HandlerState(invoke_fn=invoke, meta={"model": "hello"})


def tabular_handler(spec: dict, ctx: HandlerContext) -> HandlerState:
    """Config 2: sklearn tabular inference on the host, as in JAX: the
    bundle's ``model.joblib`` (a seeded fit without a params directory);
    ``degraded`` lists the optional packages the build skipped."""
    adapter = registry.get("tabular").build(extra=spec.get("extra"))
    clf = (adapter.load_params(ctx.params_dir) if ctx.params_dir is not None
           else adapter.init_params(seed=0))
    n_features = getattr(clf, "n_features_in_", 16)
    degraded = ctx.degraded()

    def invoke(req: dict) -> dict:
        if req.get("warmup") or req.get("random"):
            x = np.zeros((1, n_features))
        else:
            x = np.asarray(req["instances"], dtype=float)
            if x.ndim == 1:
                x = x[None, :]
        proba = clf.predict_proba(x)
        return {"ok": True, "predictions": proba.argmax(1).tolist(),
                "probabilities": proba.tolist(), "degraded": degraded}

    return HandlerState(invoke_fn=invoke,
                        meta={"model": "tabular", "n_features": n_features})


def _adapter_and_params(spec: dict, ctx: HandlerContext, device):
    """The twin of JAX's ``_jax_adapter_and_params``: the manifest's
    ``params_info.config`` (a converted checkpoint's architecture) over
    the spec's ``extra``; the weights from ``ctx.state_dict``, else the
    bundle's params, else seeded random weights."""
    extra = dict(spec.get("extra") or {})
    payload = ctx.manifest.get("payload") or {}
    extra.update((payload.get("params_info") or {}).get("config") or {})
    adapter = registry.get(spec["model"]).build(
        dtype=spec.get("dtype", "bfloat16"), quant=spec.get("quant"),
        extra=extra)
    if ctx.state_dict is not None:
        return adapter, ctx.state_dict
    if ctx.params_dir is not None:
        return adapter, adapter.load_params(ctx.params_dir, device)
    return adapter, adapter.init_params(seed=0, device=device)


def _single_device(spec: dict) -> None:
    """A payload mesh needs more than the one device the port serves on
    (a serving mesh is tensor parallelism, ROADMAP queue 1, item 3 (c)):
    serve on one, loudly, as JAX does on a host with too few devices
    (``meta.sharded`` false)."""
    mesh = {k: v for k, v in (spec.get("mesh") or {}).items() if v > 1}
    if mesh:
        get_logger("lambdipy.handlers").warning(
            "mesh %s needs %d devices but the port serves on one: "
            "degrading to SINGLE-DEVICE serving (meta.sharded=false)",
            mesh, math.prod(mesh.values()))


def _classify_program(spec: dict, ctx: HandlerContext, device):
    adapter, state_dict = _adapter_and_params(spec, ctx, device)
    _single_device(spec)
    model = adapter.make_model(state_dict, device=device)
    example = adapter.example_batch(int(spec.get("batch_size", 1)), device)
    return adapter, ForwardProgram(model, example)


def image_classify_handler(spec: dict, ctx: HandlerContext) -> HandlerState:
    """Config 3: ResNet-50 image classification. The forward at the
    spec's example shape is a CUDA graph on the card (captured here);
    requests of another shape run eagerly. ``image`` is ``[h, w, 3]`` or
    ``[b, h, w, 3]``."""
    device = resolve_device(ctx.device)
    _, program = _classify_program(spec, ctx, device)

    def invoke(req: dict) -> dict:
        if req.get("warmup") or req.get("random"):
            logits = program(*program.example)
        else:
            x = torch.from_numpy(np.asarray(req["image"], dtype=np.float32))
            logits = program(x[None] if x.dim() == 3 else x)
        logits = logits.float().numpy()
        top = np.argsort(-logits, axis=-1)[:, :5]
        return {"ok": True, "top5": top.tolist(),
                "top1": top[:, 0].tolist(),
                "logit_max": float(logits.max())}

    return HandlerState(
        invoke_fn=invoke, forward=program,
        stats_fn=lambda: _forward_stats(program),
        meta={"model": spec["model"], "batch": program.rows,
              "sharded": False, "aot": program.mode,
              "platform": "gpu" if device.type == "cuda" else device.type})


def _forward_stats(program: ForwardProgram) -> dict:
    """A classify handler's ``/metrics``: the kernels' counters (no TPU
    kernel is on these paths: they stay 0) and the forward's."""
    return {"kernels": kernel_launches(), "forward": program.report()}


def _pad_ids(req: dict, max_len: int) -> tuple:
    """A request's ``input_ids`` (one row or rows) padded to ``max_len``
    with their mask, as host tensors."""
    raw = np.asarray(req["input_ids"], dtype=np.int64)
    if raw.ndim == 1:
        raw = raw[None, :]
    ids = np.zeros((raw.shape[0], max_len), np.int64)
    mask = np.zeros((raw.shape[0], max_len), np.int64)
    n = min(max_len, raw.shape[1])
    ids[:, :n] = raw[:, :n]
    mask[:, :n] = 1
    return torch.from_numpy(ids), torch.from_numpy(mask)


def text_classify_handler(spec: dict, ctx: HandlerContext) -> HandlerState:
    """Config 4: BERT text classification; ``input_ids`` padded to
    ``max_len``. The forward at the spec's example shape is a CUDA graph
    on the card (captured here); other batch sizes run eagerly."""
    device = resolve_device(ctx.device)
    adapter, program = _classify_program(spec, ctx, device)
    max_len = adapter.config.max_len

    def invoke(req: dict) -> dict:
        if req.get("warmup") or req.get("random"):
            logits = program(*program.example)
        else:
            logits = program(*_pad_ids(req, max_len))
        logits = logits.float().numpy()
        return {"ok": True, "labels": logits.argmax(-1).tolist(),
                "logits": logits.tolist()}

    return HandlerState(
        invoke_fn=invoke, forward=program,
        stats_fn=lambda: _forward_stats(program),
        meta={"model": spec["model"], "max_len": max_len, "sharded": False,
              "aot": program.mode})


def torch_text_classify_handler(spec: dict,
                                ctx: HandlerContext) -> HandlerState:
    """Config 4, the torch path: the stock ``torch.nn`` BERT from the
    bundle's ``model.pt``, f32, run eagerly on the card (JAX runs it on a
    torch-xla device and degrades to the CPU without one; the port runs
    on the CPU only when the caller asks). ``device`` in the response and
    the meta is the device's type."""
    device = resolve_device(ctx.device)
    adapter, state_dict = _adapter_and_params(spec, ctx, device)
    model = adapter.make_model(state_dict, device=device)
    program = ForwardProgram(model, adapter.example_batch(1, device),
                             graphs=False)
    max_len = adapter.config.max_len

    def invoke(req: dict) -> dict:
        if req.get("warmup") or req.get("random"):
            logits = program(*program.example)
        else:
            logits = program(*_pad_ids(req, max_len))
        return {"ok": True, "labels": logits.numpy().argmax(-1).tolist(),
                "device": device.type}

    return HandlerState(
        invoke_fn=invoke, forward=program,
        stats_fn=lambda: _forward_stats(program),
        meta={"model": spec["model"], "device": device.type})
