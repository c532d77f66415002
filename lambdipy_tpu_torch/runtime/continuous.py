"""Continuous (in-flight) batching for the generate handler.

The port's ``ContinuousBatcher``, twin of
``lambdipy_tpu/runtime/continuous.py`` cut to this slice. Without it the
port serves one request at a time; here a batched decode advances in
SEGMENTS of ``segment`` steps and new requests join it at segment
boundaries, packed into a free slot.

- The engine owns a B-slot decode step (``models/llama.py DecodeStep``:
  token, logprob, position, knobs and a sampling stream (key and draw
  index) per slot, at fixed addresses) over either a dense B-slot cache
  of ``cache_len`` positions or a page arena (``runtime/pagepool.py``) read through a
  static block-table buffer. On the card every decode step is a replay
  of a CUDA graph of that step, one graph per greedy / sampled
  (``models/graphs.py``); a joiner's stream (key and draw index) moves
  into its slot's stream buffers.
  Slots are a host concept: every decode step runs all B rows, and
  empty slots compute garbage nobody reads (their position is reset to 0
  at each barrier, so their attention stays one position long).
- Paged: admission charges ``ceil((s + max_new) / page)`` pages; the
  slot's block table lists them, padded with the null page 0. Each
  decode step writes the row's K/V into its page and runs the paged
  decode-attention kernel on the arena (``models/llama.py
  LlamaBlock._paged_decode``), where the JAX engine gathers the pages
  into a contiguous cache first. On the same K/V values the paged
  kernel is bitwise the contiguous one, so paged and dense engines emit
  the same tokens and logprobs.
- Short prompts (``<= GROUP_PREFILL_MAX``) join raw and the engine
  prefills waiting joiners together, one ragged call per prompt bucket
  (the bucket ``LlamaServer.generate`` uses, so a row prefills at the
  width it would solo); longer prompts prefill alone on their request
  thread, one at a time (a prefill's transient memory grows with the
  square of its bucket under ``blocked``). Both run the server's prefill
  program of their shape (``models/llama.py PrefillProgram``, a CUDA
  graph on the card), whose outputs are copied out, since a long row
  waits for a later barrier. Packing (scalars into the slot, the
  prefill's K/V into the slot's cache row or pages) happens on the
  engine thread at the barrier.
- Chunked joiner prefill (the server's ``prefill_chunk``, off by
  default, as in JAX): a long prompt past the chunk width walks its head
  in fixed-width chunks into a ``cache_len`` window checked out of the
  server's program cache for the walk and continues its tail there at
  the tail's bucket
  (:meth:`ContinuousBatcher._prefill_row_chunked`). Each chunk takes the
  device lock alone (a ``FairLock``, granted in arrival order), so the
  engine's segments run between chunks instead of stalling behind one
  wide prefill; the prefill lock spans the walk.
- The loop is pipelined (``pipeline_depth``, default 2, as in JAX): it
  keeps up to ``pipeline_depth`` segments on the card. A segment's
  ``[B, k]`` token block (a fresh tensor per segment) is copied
  ``non_blocking`` into pinned host memory behind a CUDA event, and the
  host waits on the oldest segment's event only after the next segment
  is enqueued, so the card computes segment N+1 while the host books N.
  Slot retirement and joiner packing happen only at BARRIERS, with the
  pipeline empty. A waiting joiner that a slot could take stops the
  dispatch: the bounded drain (at most ``pipeline_depth - 1`` segments)
  then reaches the barrier. ``disp`` counts the tokens dispatched per
  row; the segment length is the furthest live row's undispatched
  quota. A row that finished behind the dispatch frontier keeps its
  slot as a garbage row until the barrier: its blocks are dropped on
  the host (``wasted_overdecode_tokens``), so every row is bitwise the
  depth-1 engine's. Its position runs on past its quota: the dense
  write past ``cache_len`` leaves the cache as it is, and the paged
  write goes to the row's own last page or, past its table, to the null
  page, never into a shared prefix page (those lie before the row's
  prompt end). Depth 1 is the synchronous loop: run a segment, fetch
  its block, book it, barrier. The engine exits when idle and restarts
  on the next request.
- Each entry carries its request's scheduling class (``cls``), arrival
  ``seq`` and deadline (``deadline_at``, from ``x-deadline-ms``) from
  the request context ``sched/`` sets; free slots go to joiners in the
  engine's ``policy`` order (the handler's default is ``fair``). At a
  barrier, a row whose deadline passed or whose stream's reader went
  away is failed with :class:`RequestCancelled`; its slot and pages are
  freed there.
- eos is handled on the host, as in JAX: decode never latches; the
  collector records the first eos of a row (``eos_at``) and ``generate``
  truncates the row there and pads it with eos. A row's tokens do not
  depend on its neighbours: attention reads only the row's own
  positions, the int8 GEMV computes each row alone at any slot count
  (decode steps and the grouped lm_head take it: one position per row;
  ``ops/quant.py::int8_route``), the tiled prefill's rows and flash
  prefill's rows do not depend on the group's size, and a
  sampled row draws once per step from its own stream, which travels
  with its slot.
- Device work (prefills, packing, dispatches and the waits on a
  segment's event) holds the process's ``DEVICE_LOCK``, so no capture
  ever runs beside it: the engine takes it for "dispatch N+1, wait on
  N" and lets it go while N's tokens are booked. A rebuilt arena drops
  the step and its graphs, as does a failure from the CUDA runtime or a
  watchdog trip (below).
- Prefix rows (``prefix=``, explicit or from the prefix store's routing)
  continue their suffix from the cached prefix K/V on their request
  thread (``models/llama.py _continue_prefill``) and join like a
  long-prompt row. Dense: from a copy of the server's full-window prefix
  entry in a window (:meth:`ContinuousBatcher._prefill_prefix_row`),
  packed into the slot's cache row. Paged: the row's table starts with
  the store's prefix pages, taken by refcount bump (``prefix_pages_fn``,
  the store's ``acquire_pages``), and the continuation reads them in
  place and writes only the suffix into the row's own pages
  (:meth:`ContinuousBatcher._paged_continue_row`). A prefix entry spans
  the whole window, so a prefix row needs an engine whose ``cache_len``
  is ``max_len``; elsewhere it runs solo.

- Fault isolation (``runtime/faults.py`` is the injection layer), as in
  JAX: every device wait the engine makes (a segment's dispatch, the wait
  on its CUDA event, its host read, a group prefill) goes through
  :meth:`ContinuousBatcher._device_wait`, which fires the site's fault
  hook and, under ``watchdog_s``, registers the wait with a monitor
  thread. A wait past ``watchdog_s`` marks the engine wedged, aborts the
  wait (under a watchdog a CUDA-event wait polls ``event.query()`` and
  its abort flag, since ``synchronize()`` cannot be interrupted, so the
  stuck thread lets go of ``DEVICE_LOCK``) and bumps the engine's
  GENERATION: a superseded thread exits at its next check without
  touching state. On any engine failure (:meth:`ContinuousBatcher.
  _fail_engine`) rows already done keep their results, rows that have
  delivered no bytes (not streamed, or streamed before the first chunk)
  are reset to their admitted state and REPLAYED through a restarted
  engine, at most ``max_replays`` times (default 1, as in JAX), bitwise
  the first attempt, and the rest get the error. A row never packed
  keeps its prefill; a packed one gets a fresh stream from its seed
  and prefills again through the function that admitted it: short rows
  in the group prefill, long rows
  alone on the engine thread (plain or chunked), prefix rows continue
  again from the server's prefix entry (dense) or over the pages they
  kept, shared prefix pages included (paged). Unlike JAX the arena is not
  reset: it is written in place and never holds the output of a failed
  computation, and engine writes never land in shared prefix pages. The
  step and its graphs survive a failure unless it came from the CUDA
  runtime or the watchdog. A CUDA runtime error is sticky: it wedges the
  engine, replays nothing and drops the server's idle prefill programs
  too. Two failures inside ``degrade_window_s`` step the DEGRADATION
  LADDER (1: depth 1; 2: the full-window program pinned and speculation
  off; 3: the prefix store bypassed, in the handler), and
  ``degrade_clean_s`` without a failure restores it. A
  wedged idle engine runs a self-probe, a trivial device round trip on a
  disposable thread under the watchdog; the first clean fetch after a
  failure, or a probe that succeeds, clears the wedge. Everything is
  published as ``EngineFaultStats`` under ``batching.faults``.

- Speculative decoding (``spec_k``, off by default, as in JAX): each
  dispatch is ONE verify of width ``kb`` (``spec_k``, or the power-of-two
  bucket of the live rows' adaptive k): the pending token and ``kb - 1``
  drafts a row, scored as ``slots * kb`` one-token rows
  (``models/llama.py VerifyStep``, a CUDA graph per key on the card), so
  every accepted position is bitwise the spec-off step. The chain verify
  accepts the longest draft prefix equal to the row's own select chain
  (greedy or seeded-sampled: the sampled noise is a function of the
  row's key and draw index, and the verify advances the index by the
  accepted ``count`` on the device), so rows are bitwise the spec-off
  engine's at any pipeline depth. Drafts: ``lookup`` (host prompt lookup
  from fetched truth, extrapolated across the verifies still in flight:
  "dispatch-time draft state") or ``model`` (the shallow-exit head of
  ``draft_exit`` layers in the verify program; per-row adaptive k that
  slow-starts at 2 and demotes a row model -> lookup -> off). A row's
  ``disp`` books the whole ``kb`` at dispatch and the collector gives
  back the rejected tail; a replayed row re-drafts from scratch. The
  counters are ``batching.spec`` (the server's ``SpecDecodeStats``,
  shared with the solo ``"speculative"`` path). ``aux``: a host-side
  :class:`DraftProvider` (``draft_provider=``, e.g. :class:`AuxModelDraft`
  over ``models/registry.py draft_twin``) proposes the drafts, extrapolated
  as lookup's are, adaptive as the model tier; a short or failing proposal
  pads with raw ``-1``. Without a provider ``aux`` serves lookup, as in
  JAX. The proposal runs on the engine thread inside its
  ``DEVICE_LOCK`` hold (the lock is reentrant, so the twin's own device
  work takes it again); on the card it waits for the segment in flight
  before its first read.

- Window bucketing (``window_bucketing``, on by default, as in JAX): a
  segment is dispatched at the window ``min(pow2 >= max(positions) +
  advance (16 at least), cache_len)`` (paged: the occupied slots'
  positions, at least one page; the full window from ladder level 2),
  JAX's rule (``continuous.py:1876-1897``), counted in ``decode_window``
  (:class:`~lambdipy_tpu_torch.runtime.metrics.DecodeWindowStats`). Under
  the plain attention (``dense``, and the decode of ``flash``), which
  reads the whole width it is given, the segment runs a
  :meth:`~lambdipy_tpu_torch.models.llama.DecodeStep.narrowed` view of
  the step: its first ``window`` positions, a program of its own in the
  engine's entry. The decode kernels (``blocked``) read a row only up
  to its ``active_len``, so a narrower program would launch the same
  blocks over the same positions: they replay the full-window program,
  and only the counters see the window.

- The long-context tier (``max_logical_ctx``, off by default, as in JAX;
  paged engines only, a dense engine stands it down at boot with a
  warning): a row whose prompt plus budget passes ``cache_len`` and fits
  the cap is served by a :class:`~lambdipy_tpu_torch.runtime.longctx.
  LongContextRunner` over the engine's pool (built on the first such
  row), from ``generate`` and ``generate_stream`` (its output delivered
  at the engine's segment), reported as ``batching.long_context``.
- ``warm_group_prefill`` runs the group-prefill programs a first burst
  would otherwise capture at request time (the handler's background
  warm).

- Tensor parallelism (a server over ``tp`` ranks, ``models/llama.py``,
  ``parallel/tpserve.py``): the engine's device work is a handful of ops
  of host arguments (``op_init_step``, ``op_reset_positions``,
  ``op_prefill_rows``, ``op_pack``, ``op_segment``), which the server's
  dispatcher runs on every rank in one order, each rank's engine mirror
  (:func:`follower_engine`) over its own share of the step and arena;
  the host logic above them (slots, block tables, windows, joiners,
  the pipeline) runs on the controller alone. ``batching.mesh``
  publishes JAX's ``MeshStats``. Speculative decoding, the long-context
  tier, chunked prefill, prefix rows and the warm raise at ``tp > 1``,
  naming ROADMAP queue 1, item 3 (c2).
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import threading
import time
from collections import deque

import numpy as np
import torch

from lambdipy_tpu_torch.models.graphs import (DEVICE_LOCK, GraphStats,
                                              StepProgram, StepPrograms)
from lambdipy_tpu_torch.models.llama import (TP_C2, DecodeStep, _kv_store,
                                             _leaves, _mode, _next_bucket,
                                             _scan_decode, cache_width,
                                             init_decode_cache,
                                             init_page_arena, kv_shardings,
                                             pack_prefill_into_pages,
                                             page_kv_bytes, row_streams,
                                             to_device, verify_program)
from lambdipy_tpu_torch.models.spec import lookup_draft_hit
from lambdipy_tpu_torch.runtime.faults import (EngineWatchdogTimeout,
                                               FaultPlan)
from lambdipy_tpu_torch.runtime.metrics import (DecodeWindowStats,
                                                EngineFaultStats,
                                                EngineStats, MeshStats,
                                                PipelineStats, PrefillStats,
                                                SpecDecodeStats)
from lambdipy_tpu_torch.runtime.pagepool import PagePool, PagesExhausted
from lambdipy_tpu_torch.sched import (current_request_class,
                                      current_request_deadline_ms)

log = logging.getLogger("lambdipy_tpu_torch.continuous")

_entry_seq = itertools.count()
_engine_ids = itertools.count()


def follower_engine(targets, group, *, slots: int, segment: int,
                    cache_len: int, window_bucketing: bool, pool):
    """A follower's mirror of the controller's engine
    (``parallel/tpserve.py``): an engine of the same geometry over the
    follower's server and its own share of the arena (``pool``: ``(pages,
    page)`` or None), whose device ops the controller's dispatcher calls;
    it never starts a thread of its own."""
    server = targets["server"]
    page_pool = None
    if pool is not None:
        n_pages, page = pool
        cfg = server.model.cfg
        page_pool = PagePool(
            n_pages=n_pages, page=page, page_bytes=page_kv_bytes(cfg, page),
            make_arena=lambda: init_page_arena(cfg, n_pages, page,
                                               server.device),
            window_pages=cache_len // page)
    return ContinuousBatcher(server, slots=slots, segment=segment,
                             cache_len=cache_len, page_pool=page_pool,
                             window_bucketing=window_bucketing)

# prompts longer than this prefill alone on their request thread
GROUP_PREFILL_MAX = 256


class RequestCancelled(RuntimeError):
    """A row cancelled at a barrier: its waiter went away (a closed
    stream) or its deadline passed mid-decode."""


class _StaleEngine(Exception):
    """Raised in an engine thread whose generation a failure superseded:
    it exits without touching the restarted engine's state."""


class DraftProvider:
    """Host-side draft source behind the engine's provider seam
    (``draft_mode="aux"``, JAX ``continuous.py:144-159``): given a row's
    confirmed context, propose up to ``k`` continuation tokens for the
    chain verify to score. A provider is only ever a proposal source:
    acceptance is the target's own chain, so a wrong (or short, padded
    with ``-1``) proposal costs wasted verify positions, never a wrong
    token. The in-program shallow-exit head (``draft_mode="model"``)
    does not go through this interface."""

    def propose(self, context, k: int) -> list:
        raise NotImplementedError


class AuxModelDraft(DraftProvider):
    """A separate small draft model behind :class:`DraftProvider` (JAX
    ``continuous.py:162-180``): any ``generate``-shaped server (e.g. the
    twin :func:`lambdipy_tpu_torch.models.registry.draft_twin` builds)
    greedily continues the context by ``k`` tokens, prefilling the whole
    context at every call. ``proposals`` and ``propose_s`` count its
    calls and their host wall (on the card a call waits for the engine's
    segment in flight before its first read)."""

    def __init__(self, server):
        self.server = server
        self.proposals = 0
        self.propose_s = 0.0

    def propose(self, context, k: int) -> list:
        ctx = [int(t) for t in np.asarray(context).reshape(-1)]
        if not ctx or k <= 0:
            return []
        t0 = time.monotonic()
        try:
            out = self.server.generate(ctx, max_new_tokens=int(k))
        finally:
            self.proposals += 1
            self.propose_s += time.monotonic() - t0
        return [int(t) for t in np.asarray(out).reshape(-1)[:k]]


def is_cuda_error(error: BaseException) -> bool:
    """A CUDA runtime error (an illegal address, a launch failure): it
    poisons the process's context, so no replay in this process can
    succeed. An out-of-memory error is not one."""
    accel = getattr(torch, "AcceleratorError", None)
    return ((accel is not None and isinstance(error, accel))
            or "CUDA error" in str(error))


def _stamp(error: BaseException, site: str) -> None:
    """Attribute a failure to the site it surfaced at, unless it carries
    one (an injected fault, a watchdog timeout)."""
    if not hasattr(error, "fault_site"):
        error.fault_site = site


class ContinuousBatcher:
    """Segment-boundary continuous batching over a ``LlamaServer``.
    ``policy`` (``sched.policy``) orders the joiners a barrier hands free
    slots to (None: arrival order); ``pipeline_depth`` is the most
    segments kept on the card. ``watchdog_s`` bounds device waits (0:
    off, the default, as in JAX), ``max_replays`` the replays of a row
    that delivered nothing, ``faults`` is the injection plan (shared with
    the pool when it has none); ``degrade_window_s`` and
    ``degrade_clean_s`` drive the degradation ladder. ``spec_k`` (0: off,
    the default) turns each dispatch into a speculative verify of up to
    ``spec_k`` tokens a row (bucketed to a power of two), drafted by
    ``draft_mode`` (``lookup``: prompt lookup over n-grams up to
    ``spec_ngram``; ``model``: the shallow-exit head of ``draft_exit``
    layers, per-row adaptive k; ``aux``: ``draft_provider``'s proposals,
    adaptive as ``model``; ``off``) as the module docstring says.
    ``window_bucketing`` (on, as in JAX) dispatches each segment at the
    window its rows need.
    ``max_logical_ctx`` (0: off) turns the long-context tier on over a
    paged engine; ``long_prefill`` asks the tier for ring-attention
    prefill, which stands down counted."""

    def __init__(self, server, *, slots: int = 8, segment: int = 16,
                 cache_len: int | None = None, page_pool=None, policy=None,
                 window_bucketing: bool = True,
                 pipeline_depth: int = 2, watchdog_s: float = 0.0,
                 max_replays: int = 1, faults: FaultPlan | None = None,
                 degrade_window_s: float = 60.0,
                 degrade_clean_s: float = 30.0, spec_k: int = 0,
                 spec_ngram: int = 3, draft_mode: str = "lookup",
                 draft_exit: int = 1, draft_provider=None,
                 max_logical_ctx: int = 0, long_prefill: bool = False):
        cfg = server.model.cfg
        self.server = server
        self.slots = max(1, int(slots))
        self.segment = max(1, int(segment))
        self.policy = policy
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.pipe_stats = PipelineStats(depth=self.pipeline_depth)
        self.cache_len = min(cache_len or cfg.max_len, cfg.max_len)
        # length-aware decode: each segment at the window its rows need
        # (JAX continuous.py:189); the plain attention runs a narrowed view
        # of the step per window, the decode kernels the full program
        self.window_bucketing = bool(window_bucketing)
        self.window_stats = DecodeWindowStats()
        self._narrow = cfg.attn_backend != "blocked"
        self._views: dict[int, DecodeStep] = {}
        self.pool = page_pool
        if page_pool is not None:
            if self.cache_len % page_pool.page:
                raise ValueError(f"page {page_pool.page} does not divide "
                                 f"engine cache_len {self.cache_len}")
            page_pool.window_pages = self.cache_len // page_pool.page
        self.stats_counters = EngineStats()
        # chunked walks (the engine's and, when it shares them, the prefix
        # store's): rounds, chunks, walks and their wall
        self.prefill_stats = PrefillStats()
        self._lock = threading.Condition()
        self._joiners: list[dict] = []
        self._active: list[dict | None] = [None] * self.slots
        self._engine_running = False
        # the B-slot decode step and its greedy and sampled programs
        self._step: DecodeStep | None = None
        self._programs: StepPrograms | None = None
        # the arena's generation the step was built over (paged)
        self._arena_generation = 0
        # one request-thread prefill at a time: long rows keep their
        # arrival order, and one chunked walk holds a window at a time
        self._prefill_lock = threading.Lock()
        # chunked walks in progress (segments dispatched meanwhile are
        # counted as interleaved)
        self._walking = 0
        # paged prefix hits: prefix tokens -> (page ids, length) with a
        # ref taken per page (the prefix store's acquire_pages), or None;
        # unset, prefix rows run solo
        self.prefix_pages_fn = None
        # the last retired rows: prompt length, tokens asked, seconds from
        # admission to the first booked token and to completion, replays;
        # paged rows also their page count and when (``time.monotonic``)
        # the pages were charged and released
        self.request_log: deque = deque(maxlen=256)
        # -- fault isolation ---------------------------------------------
        self.watchdog_s = max(0.0, float(watchdog_s or 0.0))
        self.max_replays = max(0, int(max_replays))
        self.faults = faults if faults is not None else FaultPlan.empty()
        self.fault_stats = EngineFaultStats()
        if page_pool is not None and page_pool.faults is None:
            # one plan drives the pool's page_alloc site too
            page_pool.faults = self.faults
        self.degrade_window_s = max(0.1, float(degrade_window_s))
        self.degrade_clean_s = max(0.1, float(degrade_clean_s))
        self._fail_times: list[float] = []
        self._last_failure_t: float | None = None
        self._had_failure = False        # a recovery waits for a clean fetch
        # bumped by every failure: a thread of an older generation exits
        self._gen = 0
        self._waits: dict[int, dict] = {}   # waits under the watchdog
        self._wait_seq = itertools.count()
        self._monitor: threading.Thread | None = None
        # the wedged engine's self-probe: when it last fired, whether one
        # runs, and consecutive misses (its back-off)
        self._probe_t = 0.0
        self._probe_live = False
        self._probe_misses = 0
        # CUDA-event waits that polled (a watchdog or an armed plan); the
        # default path synchronizes and never polls
        self.polled_waits = 0
        # -- speculative decoding (JAX continuous.py:196-352) --------------
        # spec_k >= 2: the verify width, a power of two; <= 1 is plain
        # decode
        self.spec_k = (max(2, _next_bucket(int(spec_k), 2))
                       if spec_k and int(spec_k) >= 2 else 0)
        self.spec_ngram = max(1, int(spec_ngram))
        mode = str(draft_mode or "lookup").lower()
        if mode == "auto":
            mode = "model"
        if mode not in ("model", "lookup", "aux", "off"):
            log.warning("unknown draft_mode %r; using lookup", draft_mode)
            mode = "lookup"
        self.draft_provider = draft_provider
        self.draft_errors = 0  # proposals that raised, padded with -1
        if mode == "aux" and draft_provider is None:
            log.warning("draft_mode=aux needs draft_provider=; using lookup")
            mode = "lookup"
        self.draft_mode = mode
        self.draft_exit = max(1, min(int(draft_exit or 1), cfg.layers))
        # the per-row adaptive k: EWMA weight, grow and shrink bands
        self.spec_ewma_alpha = 0.3
        self.spec_grow = 0.75
        self.spec_shrink = 0.35
        # one counter object with the server's solo speculative path
        self.spec_metrics = getattr(server, "spec_metrics", None)
        if self.spec_metrics is None:
            self.spec_metrics = SpecDecodeStats()
        # the last failures: site, when (``time.monotonic``), rows
        # requeued, whether it wedged the engine, and for a watchdog trip
        # how long the wait had lasted
        self.failure_log: deque = deque(maxlen=64)
        # JAX's collector counters (continuous.py:1423, :1450): segments
        # landed, and rows that took tokens from one, summed
        self.segments_run = 0
        self.rows_in_segments = 0
        # -- the long-context tier (JAX continuous.py:400-425) -----------
        self.max_logical_ctx = max(0, int(max_logical_ctx or 0))
        self.long_prefill = bool(long_prefill)
        self._longctx = None  # built on the first routed row
        self._longctx_lock = threading.Lock()
        if self.max_logical_ctx and page_pool is None:
            log.warning("max_logical_ctx=%d needs paged KV (kv_paged); the "
                        "long-context tier stands down",
                        self.max_logical_ctx)
            self.max_logical_ctx = 0
        # -- tensor-parallel serving (JAX continuous.py:316-345) -----------
        # a server over a mesh of more than one device publishes its layout
        # and live per-device bytes as batching.mesh; over tp ranks every
        # device op below goes through the server's dispatcher
        self.mesh_stats = None
        self._tp = getattr(server, "dispatcher", None)
        self._tp_name = None
        mesh = getattr(server, "mesh", None)
        if mesh is not None and mesh.size > 1:
            shape = {a: int(n) for a, n in mesh.shape.items() if int(n) > 1}
            self.mesh_stats = MeshStats()
            self.mesh_stats.set_layout(
                shape=shape, devices=mesh.size,
                # Megatron layout, per decoded token: the embedding's
                # all-reduce, o_proj's and down_proj's per layer and the
                # logits' all-gather (analytic; 0 without a tp axis)
                collectives_per_segment=(
                    self.segment * (2 * cfg.layers + 2)
                    if shape.get("tp", 1) > 1 else 0))
            from lambdipy_tpu_torch.models.registry import _llama_tp_rules
            from lambdipy_tpu_torch.parallel.sharding import (
                device_bytes, param_shardings)

            weights = server.model.state_dict()
            self.mesh_stats.set_param_bytes(*device_bytes(
                weights, param_shardings(weights, mesh, _llama_tp_rules())))
        if self._tp is not None:
            for on, what in ((self.spec_k, "speculative decoding"),
                             (self.max_logical_ctx, "the long-context tier"),
                             (server.prefill_chunk, "chunked prefill")):
                if on:
                    raise NotImplementedError(TP_C2.format(what))
            self._tp_name = f"engine:{next(_engine_ids)}"
            self._tp.create(
                self._tp_name,
                "lambdipy_tpu_torch.runtime.continuous:follower_engine",
                self, slots=self.slots, segment=self.segment,
                cache_len=self.cache_len,
                window_bucketing=self.window_bucketing,
                pool=((page_pool.n_pages, page_pool.page)
                      if page_pool is not None else None))

    # -- paged-KV helpers ----------------------------------------------------

    def _charge_pages(self, entry: dict, tokens: int, shared=()) -> None:
        """Charge pages for the row's tokens (prompt + requested decode),
        ``shared`` prefix pages (already retained for the row) first, so
        only the rest are allocated; :class:`PagesExhausted` propagates
        to the caller after the shared refs drop. Any other allocator
        failure (an armed ``page_alloc`` fault) sheds this row as
        :class:`PagesExhausted` too, counted under its site, and leaves
        the engine alone. Charges and releases happen under the engine
        lock, so their times order them as the pool saw them. The store's
        reclaim runs before the lock is taken: with an offload tier it
        reads the spilled pages on the card under ``DEVICE_LOCK``, which
        the engine thread holds while it takes this lock; a reclaim that
        a racer emptied meanwhile runs again."""
        shared = list(shared)
        page = self.pool.page
        need = -(-tokens // page) - len(shared)
        while True:
            reclaimed = self.pool.reclaim(need)
            with self._lock:
                try:
                    fresh = self.pool.alloc(
                        need, tokens=tokens - len(shared) * page,
                        reclaim=False)
                except PagesExhausted:
                    if reclaimed:
                        continue
                    if shared:
                        self.pool.release(shared)
                    raise
                except Exception as e:  # noqa: BLE001 — an injected fault
                    if shared:
                        self.pool.release(shared)
                    self.fault_stats.record_failure(
                        getattr(e, "fault_site", "page_alloc"))
                    raise PagesExhausted(
                        max(0, need), self.pool.free_count(),
                        self.pool.retry_after_s(max(1, need))) from e
                except BaseException:
                    if shared:
                        self.pool.release(shared)
                    raise
                entry["pages"] = shared + fresh
                entry["charged_at"] = time.monotonic()
                return

    def _release_pages(self, entry: dict) -> None:
        """Idempotently return an entry's pages (caller holds the lock)."""
        pids = entry.pop("pages", None)
        if pids:
            self.pool.release(pids)
            entry["n_pages"] = len(pids)
            entry["released_at"] = time.monotonic()

    def _table_row(self, entry: dict | None, nb: int) -> np.ndarray:
        """An entry's block table: ``nb`` page ids, null-padded (all null
        for an empty slot)."""
        row = np.zeros((nb,), np.int32)
        pids = (entry or {}).get("pages") or []
        row[:min(nb, len(pids))] = pids[:nb]
        return row

    # -- device ops ------------------------------------------------------------
    # The engine's device work, as calls of host arguments (and prefill
    # handles): on one device a plain method call; over tensor-parallel
    # ranks each goes through the server's dispatcher, which runs it on
    # every rank's engine in one order (caller holds ``DEVICE_LOCK``).

    def _dev(self, op: str, *args, keep: bool = False):
        if self._tp is None:
            return getattr(self, op)(*args)
        return self._tp.call(self._tp_name, op, *args, keep=keep)

    def op_init_step(self) -> None:
        """A fresh all-empty step (a follower's old one, of a generation
        the controller dropped, goes first)."""
        if self._step is not None:
            programs = self._detach()
            if programs is not None:
                programs.close()
        self._step = self._init_step()

    def op_reset_positions(self, slots: list) -> None:
        """Empty slots restart at position 0: their garbage stays short."""
        for slot in slots:
            self._step.pos[slot] = 0

    def op_prefill_rows(self, tokens, lengths, knobs, gens):
        """A ragged prefill of host rows through the server's program of
        their shape: ``(first, lp0, prefill cache)``."""
        return self.server._rows_prefill(tokens, lengths, knobs, gens,
                                         stats=self.stats_counters)

    def op_pack(self, prefill, src: int, slot: int, pos0: int, stream,
                pages) -> None:
        """Row ``src`` of ``prefill`` into ``slot``: its first token,
        logprob, position ``pos0`` and ``stream`` into the step, its K/V
        into the slot's cache row (dense) or its ``pages`` (paged; none
        for a paged prefix row, whose K/V is in its pages already)."""
        step = self._step
        first, lp0, cache = prefill
        step.tok[slot] = first[src]
        step.lp[slot] = lp0[src]
        step.pos[slot] = pos0
        step.set_stream(slot, stream)
        cfg = self.server.model.cfg
        if cache is None:
            pass
        elif self.pool is not None:
            # the row's own pages: a prefill's positions past them (its
            # bucket's padding, a chunked row's window) are never read
            nb = self.cache_len // self.pool.page
            table = torch.as_tensor(np.asarray(pages[:nb], np.int32),
                                    device=self.server.device)
            with self.pool.arena_lock:
                pack_prefill_into_pages(cfg, self.pool.arena, table, cache,
                                        src)
        else:
            for dest, pc in zip(step.cache, cache):
                width = min(cache_width([pc]), self.cache_len)
                rows = {name: val[src, :width]
                        for name, val in _leaves(pc).items()}
                if "k" in rows:  # float K/V: into the store layout
                    rows = _kv_store(cfg, rows["k"], rows["v"])
                for name, val in rows.items():
                    dest[name][slot, :width] = val

    def _load_segment(self, view, temp, top_k, top_p, tables) -> None:
        """A segment's knobs, and (paged) every slot's block table, into
        the step's buffers (from pinned memory: a pageable copy would wait
        for the segments in flight)."""
        self._step.set_knobs(temp, top_k, top_p)
        if tables is not None:
            to_device((view or self._step).tables, tables)

    def op_segment(self, k: int, window, temp, top_k, top_p, tables,
                   sampled: bool):
        """``k`` decode steps of every slot at ``window`` (a narrowed view
        of the step; None: the full step): ``(tokens [B, k], logprobs [B,
        k])`` on the device."""
        view = self._view(window) if window is not None else None
        self._load_segment(view, temp, top_k, top_p, tables)
        prog = self._program(sampled, view)
        lock = (self.pool.arena_lock if self.pool is not None
                else contextlib.nullcontext())
        with lock:
            return _scan_decode(prog.run, self._step, k, segment=True)

    # -- device helpers ------------------------------------------------------

    def _init_step(self) -> DecodeStep:
        """The all-empty B-slot decode step: over the dense B-slot cache,
        or (paged) over the pool's arena, built on first use, through a
        static ``[B, nb]`` block-table buffer."""
        server, b = self.server, self.slots
        dev = server.device
        if self.pool is None:
            return DecodeStep(server.model, init_decode_cache(
                server.model.cfg, b, self.cache_len, dev), b)
        with self.pool.arena_lock:
            arena = self.pool.ensure_arena()
            self._arena_generation = self.pool.generation
        tables = torch.zeros((b, self.cache_len // self.pool.page),
                             dtype=torch.int32, device=dev)
        return DecodeStep(server.model, arena, b, tables=tables)

    def _entry(self) -> StepPrograms:
        """The step's programs, made on first use."""
        if self._programs is None:
            self._programs = StepPrograms(self._step, self.server.graph_type,
                                          self.stats_counters)
        return self._programs

    def _program(self, sampled: bool, view: DecodeStep | None = None
                 ) -> StepProgram:
        """The step's greedy or sampled program, or that of a narrowed
        ``view`` of it (kept in the entry by its window), made on first
        use."""
        entry = self._entry()
        if view is None:
            return entry.decode(sampled)
        return entry.program(
            ("window", view.window, _mode(sampled)),
            lambda: StepProgram(view, sampled, entry.graph_type,
                                entry.stats))

    def _window(self, positions: list, advance: int) -> int:
        """The window a segment is dispatched at (JAX
        ``continuous.py:1876-1897``): the power-of-two bucket (16 at
        least) of ``max(positions) + advance`` capped at ``cache_len``,
        the furthest write of the segment inside it; at least one page
        when paged; the full window with bucketing off or from ladder
        level 2 on. Under speculation the positions are post-accept
        upper bounds and ``advance`` is the verify width."""
        window = self.cache_len
        if self.window_bucketing and positions \
                and self.fault_stats.degrade_level < 2:
            window = min(_next_bucket(max(positions) + advance, 16),
                         self.cache_len)
        if self.pool is not None:
            window = max(window, self.pool.page)
        return window

    def _view(self, window: int) -> DecodeStep:
        """The step narrowed to ``window`` positions, made on first use."""
        if window not in self._views:
            self._views[window] = self._step.narrowed(window)
        return self._views[window]

    def _detach(self) -> StepPrograms | None:
        """Take the step and its programs off the engine (caller holds the
        lock); the caller closes the programs once it let go of it."""
        programs, self._programs, self._step = self._programs, None, None
        self._views = {}
        return programs

    def release(self) -> None:
        """Drop the engine's step, its cache and its graphs; the next
        segment builds them anew."""
        with self._lock:
            programs = self._detach()
        if programs is not None:
            programs.close()

    def _prefill_rows(self, entries: list):
        """ONE ragged prefill of ``entries`` (rows of one prompt bucket),
        each row under its own knobs and stream, through the server's
        prefill program of its shape (caller holds ``DEVICE_LOCK``):
        ``(first [bb], lp0 [bb], prefill cache)``, copies that outlive the
        program's next run (a long row's waits for a later barrier). The
        prompt width is ``generate``'s for the row, so the prefill is the
        one the row would run solo."""
        server = self.server
        rows = [e["row"] for e in entries]
        lens = [e["s"] for e in entries]
        bb = _next_bucket(len(rows), 1)
        sb = max(server.prompt_bucket(e["s"], e["n"]) for e in entries)
        tokens, lengths = server._pad_host(rows, lens, bb, sb)
        temp, tk, tp, _, gens = server._knobs_host(
            [e["temperature"] for e in entries],
            [e["top_k"] for e in entries], [e["top_p"] for e in entries],
            [e["seed"] for e in entries], None, b=bb)
        gens[:len(entries)] = [e["gen"] for e in entries]
        return self._dev("op_prefill_rows", tokens, lengths, (temp, tk, tp),
                         gens, keep=True)

    def _knobs(self, entry: dict):
        """A row's knobs as host arrays and whether it samples."""
        temp, tk, tp, _, _ = self.server._knobs_host(
            entry["temperature"], entry["top_k"], entry["top_p"],
            entry["seed"], None, b=1)
        return (temp, tk, tp), bool(temp[0] > 0)

    def _pack(self, entry: dict, prefill, src: int, gen: int) -> None:
        """Row ``src`` of a prefill into the entry's slot: the first token,
        its logprob, the position and the stream into the
        step's slot; the K/V into the slot's cache row (dense) or its pages
        (paged). A paged prefix row's K/V is in its pages already (no
        cache); a plain prefill's float K/V is stored in the cache's
        layout, and a dense prefix row's continuation cache and a chunked
        row's cache, in that layout already, are copied as they are (:meth:`op_pack`)."""
        pages = (list(entry.get("pages") or [])
                 if self.pool is not None else None)
        self._dev("op_pack", prefill, src, entry["slot"], entry["pos0"],
                  entry["gen"], pages)
        with self._lock:
            if gen != self._gen:
                raise _StaleEngine()  # a failure reset the entry meanwhile
            entry["packed"] = True
        self.stats_counters.record_join()
        if entry["prefix_toks"] is not None:
            self.stats_counters.record_prefix_join()

    def _replay_prefill(self, entry: dict):
        """A replayed row's prefill, on the engine thread, through the
        function that admitted it (caller holds ``DEVICE_LOCK``): a long
        row alone (plain or chunked), so it is never regrouped at a width
        it did not run at; a dense prefix row continued again from the
        server's prefix entry; a paged prefix row continued again over
        the pages it kept, shared prefix pages included."""
        route = entry["route"]
        if route == "prefix":
            return self._prefill_prefix_row(
                entry, self.server._prefix_entry(entry["prefix_toks"]))
        if route == "paged_prefix":
            return self._paged_continue_row(entry)
        out = (self._prefill_row_chunked(entry) if route == "chunked"
               else self._prefill_rows([entry]))
        self.stats_counters.record_row_prefill()
        return out

    def _pack_joiners(self, packing: list, gen: int) -> None:
        """Prefill this barrier's joiners and pack them: replayed rows of
        another route alone through :meth:`_replay_prefill`, the raw ones
        grouped by prompt bucket. A failed prefill stays scoped to its
        rows, as in JAX: a replayed row gets the error; a group's rows
        under their replay budget wait for the next barrier, the others
        get the error."""
        for e in [e for e in packing
                  if e["prefill"] is None and e["route"] != "group"]:
            site = ("prefix_assemble" if e["prefix_toks"] is not None
                    else "group_prefill")
            try:
                e["prefill"] = self._device_wait(site, gen,
                                                 self._replay_prefill, e)
            except (_StaleEngine, EngineWatchdogTimeout):
                raise
            except Exception as err:  # noqa: BLE001 — scoped to the row
                with self._lock:
                    if gen != self._gen:
                        raise _StaleEngine() from None
                    log.error("replayed row's prefill failed: %s", err)
                    self.fault_stats.record_failure(
                        getattr(err, "fault_site", site))
                    e["error"], e["done"] = err, True
                    self._active[e["slot"]] = None
                    if self.pool is not None:
                        self._release_pages(e)
                    self._lock.notify_all()
        groups: dict[int, list] = {}
        for e in packing:
            if e["prefill"] is None and e["route"] == "group":
                sb = self.server.prompt_bucket(e["s"], e["n"])
                groups.setdefault(sb, []).append(e)
        for group in groups.values():
            try:
                prefill = self._device_wait("group_prefill", gen,
                                            self._prefill_rows, group)
            except (_StaleEngine, EngineWatchdogTimeout):
                raise
            except Exception as err:  # noqa: BLE001 — scoped to the group
                with self._lock:
                    if gen != self._gen:
                        raise _StaleEngine() from None
                    log.error("group prefill failed: %s", err)
                    self.fault_stats.record_failure(
                        getattr(err, "fault_site", "group_prefill"))
                    retried = 0
                    for j in group:
                        self._active[j["slot"]] = None
                        if j["replays"] < self.max_replays:
                            j["replays"] += 1
                            j["slot"] = None
                            j["gen"] = row_streams([(j["seed"], 0)])[0]
                            self._joiners.append(j)
                            retried += 1
                        else:
                            j["error"], j["done"] = err, True
                            if self.pool is not None:
                                self._release_pages(j)
                    if retried:
                        self.fault_stats.record_replays(attempted=retried)
                    self._lock.notify_all()
                continue
            self.stats_counters.record_group_prefill(len(group))
            for src, e in enumerate(group):
                self._pack(e, prefill, src, gen)
        for e in packing:
            if e["prefill"] is not None and not e["done"]:
                self._pack(e, e["prefill"], 0, gen)
                e["prefill"] = None  # free the row's prefill cache

    def _verify_width(self, rows: list) -> int:
        """This dispatch's verify width ``kb`` (0: a plain segment): the
        power-of-two bucket of the live rows' adaptive k, at most
        ``spec_k``; 0 when speculation is off, every row's draft tier is
        off or the ladder stands at level 2 or more (JAX pins the plain
        program there)."""
        if not self.spec_k or self.fault_stats.degrade_level >= 2:
            return 0
        kmax = max((e["k_row"] for _, e in rows
                    if e["draft_mode"] != "off"), default=1)
        return min(self.spec_k, _next_bucket(int(kmax), 2)) if kmax >= 2 \
            else 0

    def _drafts(self, rows: list, kb: int):
        """The host half of a verify dispatch: ``(drafts [B, kb - 1],
        use_model [B, kb - 1] or None, assumed)``. A lookup or aux row
        drafts from its fetched truth (:meth:`_spec_draft`); a model row marks
        its positions for the in-program draft; everything else stays a
        raw ``-1``, which the chain never accepts. ``assumed`` holds each
        drafting row's provider, hit and width for the collector."""
        draft = np.full((self.slots, kb - 1), -1, np.int64)
        use_model = np.zeros((self.slots, kb - 1), bool)
        assumed: dict = {}
        for slot, e in rows:
            provider = e["draft_mode"]
            if provider == "off" or e["k_row"] < 2:
                continue
            krow = min(int(e["k_row"]), kb)
            q = e["spec_inflight"]
            e["spec_inflight"] += 1
            if provider == "model":
                use_model[slot, :krow - 1] = True
                assumed[slot] = ("model", True, krow)
                continue
            if provider == "aux" and self.draft_provider is not None:
                dv, hit = self._aux_draft(e, q, krow)
            else:
                dv, hit = self._spec_draft(e, kb, q, k=krow)
            draft[slot, :krow - 1] = np.asarray(dv, np.int64)[:krow - 1]
            assumed[slot] = (provider, hit, krow)
        return draft, (use_model if use_model.any() else None), assumed

    def _run_segment(self, live: list) -> dict:
        """Dispatch one segment (caller holds ``DEVICE_LOCK``): every slot
        advances ``k`` steps, ``k`` the undispatched quota of the live
        row furthest from its end, at most ``segment``. Only rows with
        quota left take their knobs: one whose output is all dispatched
        decodes greedy garbage, as a finished row does, so the segment
        samples (and picks the sampled program) exactly when the depth-1
        loop would. Under ``spec_k`` every row not done takes its knobs (a
        verify's advance is known only when it lands, so a row's dispatch
        count is an upper bound) and the segment is one verify of width
        ``kb`` (:meth:`_verify_width`; ``k`` is then ``kb``), its drafts
        from :meth:`_drafts`. The block (and a verify's counts and pending
        tokens) goes to pinned host memory behind a CUDA event on the card
        (on the CPU it is copied out of the program's outputs). The
        segment runs at :meth:`_window`'s window: through a narrowed view
        of the step under the plain attention, the full program under the
        decode kernels; the record carries JAX's window sums for
        ``decode_window``. Returns the in-flight record :meth:`_collect`
        books; the caller moves the rows' ``disp`` by its ``k``."""
        b = self.slots
        rows = [(slot, e) for slot, e in live
                if not e["done"] and (self.spec_k or e["disp"] < e["n"])]
        kb = self._verify_width(rows)
        k = kb or min(self.segment, max(e["n"] - e["disp"] for _, e in rows
                                        if e["disp"] < e["n"]))
        # the window (JAX's sums, continuous.py:1977-1981): live rows'
        # dispatch positions; paged, every occupied slot's, since a done
        # row still writes through its table
        positions = [e["pos0"] + e["disp"] for _, e in live if not e["done"]]
        window = self._window(
            [e["pos0"] + e["disp"] for _, e in live]
            if self.pool is not None else positions, k)
        view = (self._view(window)
                if self._narrow and window < self.cache_len else None)
        temp = np.zeros((b,), np.float32)
        top_k = np.zeros((b,), np.int64)
        top_p = np.ones((b,), np.float32)
        for slot, e in rows:
            temp[slot] = e["temperature"] or 0.0
            top_k[slot] = e["top_k"] or 0
            top_p[slot] = 1.0 if e["top_p"] is None else e["top_p"]
        tables = None
        if self.pool is not None:
            # every occupied slot's table, finished rows' too: their
            # garbage steps write into their own pages or the null page
            nb = (window if view is not None else self.cache_len) \
                // self.pool.page
            tables = np.stack([self._table_row(e, nb) for e in self._active])
        sampled = bool((temp > 0).any())
        rec = {"rows": live, "k": k, "event": None, "window": {
            "attended": sum(k * p + k * (k + 1) // 2 for p in positions),
            "window_read": len(positions) * k * window,
            "full_window": len(positions) * k * self.cache_len,
            "window": window}}
        if kb:
            self._load_segment(view, temp, top_k, top_p, tables)
            lock = (self.pool.arena_lock if self.pool is not None
                    else contextlib.nullcontext())
            draft, use_model, rec["assumed"] = self._drafts(rows, kb)
            exit_layer = self.draft_exit if use_model is not None else None
            prog = verify_program(self._entry(), kb, sampled,
                                  exit_layer=exit_layer, step=view)
            prog.vstep.set_drafts(draft, use_model)
            rec["t_dispatch"] = time.monotonic()
            with lock:
                prog.run()
            out = prog.outputs  # overwritten by the next run
            rec.update(spec=kb, counts=out[2], pending=out[3])
            toks, lps = out[0], out[1]
            if not toks.is_cuda:
                toks, lps = toks.clone(), lps.clone()
                rec.update(counts=out[2].clone(), pending=out[3].clone())
            self.stats_counters.record_verify(
                len(rows), kb, kb - 1 if exit_layer else 0,
                beside_walk=self._walking > 0)
        else:
            rec["t_dispatch"] = time.monotonic()
            toks, lps = self._dev("op_segment", k,
                                  window if view is not None else None,
                                  temp, top_k, top_p, tables, sampled)
            if self.mesh_stats is not None:
                self.mesh_stats.record_segment()
            self.stats_counters.record_segment(
                k, len(rows), beside_walk=self._walking > 0)
        need_lp = any(e["want_lp"] for _, e in rows)
        rec.update(toks=toks, lps=lps if need_lp else None)
        if toks.is_cuda:
            for key in ("toks", "lps", "counts", "pending"):
                if rec.get(key) is not None:
                    host = torch.empty(rec[key].shape, dtype=rec[key].dtype,
                                       pin_memory=True)
                    rec[key] = host.copy_(rec[key], non_blocking=True)
            rec["event"] = torch.cuda.Event()
            rec["event"].record()
        return rec

    def _wait(self, rec: dict, gen: int) -> None:
        """Block until the card has computed the record's segment and
        copied its block to the host (caller holds ``DEVICE_LOCK``: a wait
        beside another thread's capture would invalidate it), through the
        ``transport`` site; stamps when it was ready and how long the host
        waited on the card."""
        t0 = time.monotonic()
        self._device_wait("transport", gen, event=rec["event"])
        rec["t_ready"] = time.monotonic()
        rec["wait_s"] = rec["t_ready"] - t0

    @staticmethod
    def _fetch(rec: dict):
        """The host arrays of a segment's block, and of a verify's counts
        and pending tokens (None for a plain segment); the pinned copies
        are complete once the wait returned."""
        toks = rec["toks"].numpy()
        lps = rec["lps"].float().numpy() if rec["lps"] is not None else None
        if not rec.get("spec"):
            return toks, lps, None, None
        return toks, lps, rec["counts"].numpy(), rec["pending"].numpy()

    def _collect(self, rec: dict, gen: int) -> None:
        """Book a segment's block, read through the ``segment_fetch``
        site: each live row's tokens (and logprobs when some row asked),
        its first eos, and done at its eos or quota. A row already done
        when its block lands (finished behind the dispatch frontier)
        books nothing: the block is counted as wasted. A verify's row
        books its first ``count`` tokens (the rejected tail is never
        booked, as an over-decoded block is not), gives back the
        ``kb - count`` its dispatch count assumed, takes the pending token
        as its next draft anchor and feeds its acceptance to the counters
        and the adaptive k. The first clean fetch after a failure counts a
        recovery and clears a wedge."""
        toks, lps, counts, pending = self._device_wait(
            "segment_fetch", gen, self._fetch, rec)
        self.window_stats.record_segment(**rec["window"])
        kb = rec.get("spec", 0)
        now = time.monotonic()
        # the JAX metric's interval: from the wait's return until the
        # host arrays exist (its device_get after block_until_ready)
        fetch_s = now - rec["t_ready"]
        wasted = 0
        with self._lock:
            if gen != self._gen:
                # a failure reset these rows while this thread read: their
                # booking would corrupt the replay
                raise _StaleEngine()
            if self._had_failure:
                self._had_failure = False
                self.fault_stats.record_recovery()
                self.fault_stats.set_wedged(False)
            self.segments_run += 1
            for slot, e in rec["rows"]:
                c = int(counts[slot]) if kb else rec["k"]
                info = rec["assumed"].pop(slot, None) if kb else None
                if info is not None:
                    e["spec_inflight"] -= 1
                if e["done"]:
                    wasted += c
                    continue
                self.rows_in_segments += 1
                row = toks[slot][:c].tolist()
                base = len(e["toks"])
                if base == 0:
                    e["ttft_s"] = now - e["t0"]
                e["toks"].extend(row)
                if lps is not None:
                    e["lps"].extend(lps[slot][:c].tolist())
                if not kb:
                    # a plain segment moved the row past its last
                    # fetched pending token: the next draft guesses it
                    e["spec_pend"] = None
                else:
                    e["disp"] -= kb - c
                    e["spec_pend"] = int(pending[slot])
                    if info is not None:
                        provider, hit, k_used = info
                        self.spec_metrics.record_step(
                            proposed=k_used - 1, accepted=c - 1, emitted=c,
                            hit=bool(hit), provider=provider, k=k_used)
                        self._spec_adapt(e, provider, k_used, c)
                eos_id = e["eos_id"]
                if eos_id is not None and e["eos_at"] is None \
                        and eos_id in row:
                    e["eos_at"] = base + row.index(eos_id)
                if e["eos_at"] is not None or len(e["toks"]) >= e["n"]:
                    e["done"] = True
                    e["wall_s"] = now - e["t0"]
                    self.stats_counters.record_served()
                    if e["replays"]:
                        # a requeued row completed: the replay delivered
                        self.fault_stats.record_replays(succeeded=1)
            self._lock.notify_all()
        self.pipe_stats.record_collect(rec["t_dispatch"], rec["t_ready"],
                                       fetch_s=fetch_s, wait_s=rec["wait_s"],
                                       wasted=wasted)

    # -- speculative decoding ------------------------------------------------

    @staticmethod
    def _context(entry: dict) -> list:
        """A row's fetched truth: its cached prefix, prompt and booked
        tokens."""
        return (entry["prefix_toks"] or []) + entry["row"] + entry["toks"]

    def _spec_draft(self, entry: dict, kb: int, q: int, k: int):
        """A lookup row's draft for one verify (JAX ``_spec_draft``,
        ``continuous.py:878``): extrapolated from fetched truth (the
        prompt, its cached prefix included, the booked tokens and the last
        fetched pending token) by lookup itself across the ``q`` verifies
        still in flight, each assumed to accept all ``k`` of its tokens:
        at depth 2 the next verify is drafted before the one in flight
        lands. A wrong guess only misses. Returns ``(draft [k - 1],
        hit)``."""
        base = self._context(entry)
        pend = entry["spec_pend"]
        if pend is not None:
            ext, hit = lookup_draft_hit(base + [pend], (q + 1) * k - 1,
                                        ngram_max=self.spec_ngram)
            return ext[q * k: q * k + k - 1], hit
        # the device holds the pending token, the host has none yet (a
        # freshly packed row): ext[0] guesses the pending token itself
        ext, hit = lookup_draft_hit(base, (q + 1) * k,
                                    ngram_max=self.spec_ngram)
        return ext[q * k + 1: (q + 1) * k], hit

    def _aux_draft(self, entry: dict, q: int, k: int):
        """An aux row's draft (the aux branch of JAX ``_spec_draft``,
        ``continuous.py:912-934``): the engine's :class:`DraftProvider`
        proposes the whole extrapolation across the ``q`` verifies in
        flight, as lookup extrapolates, and this verify takes its slice.
        A short or failing proposal pads with raw ``-1``, never accepted,
        so a misbehaving provider degrades to plain decode, not to a wrong
        token; a failure is counted in ``draft_errors`` and logged.
        Returns ``(draft [k - 1], hit)``."""
        pend = entry["spec_pend"]
        need = (q + 1) * k - (1 if pend is not None else 0)
        try:
            ext = [int(t) for t in self.draft_provider.propose(
                self._context(entry) + ([pend] if pend is not None else []),
                need)]
        except Exception as e:  # noqa: BLE001 — a proposal, not a result
            self.draft_errors += 1
            log.warning("draft provider failed (padded with -1): %s", e)
            ext = []
        hit = len(ext) >= need
        ext += [-1] * (need - len(ext))
        if pend is not None:
            return ext[q * k: q * k + k - 1], hit
        return ext[q * k + 1: (q + 1) * k], hit

    def _spec_row_init(self) -> tuple:
        """``(provider, k_row)`` a new row starts with: lookup at a fixed
        ``spec_k``; the model and aux tiers slow-start at k = 2."""
        if not self.spec_k or self.draft_mode == "off":
            return "off", 1
        if self.draft_mode == "lookup":
            return "lookup", self.spec_k
        return self.draft_mode, 2

    def _spec_adapt(self, entry: dict, provider: str, k_used: int,
                    accepted_c: int) -> None:
        """Per-row adaptive k (JAX ``_spec_adapt``, ``continuous.py:961``),
        run by the collector: the step's accepted fraction into the row's
        EWMA, then k doubled (up to ``spec_k``) above the grow band,
        halved below the shrink band, and at k = 2 the row demoted along
        model or aux -> lookup -> off (counted under ``draft.fallbacks``). Inert
        in lookup mode."""
        if self.draft_mode in ("lookup", "off"):
            return
        if provider == "off" or k_used < 2:
            return
        frac = (accepted_c - 1) / float(k_used - 1)
        ew = entry["accept_ewma"]
        a = self.spec_ewma_alpha
        ew = frac if ew is None else (1.0 - a) * ew + a * frac
        entry["accept_ewma"] = ew
        if entry["draft_mode"] != provider:
            # demoted between this step's dispatch and its collect
            return
        if ew >= self.spec_grow and entry["k_row"] < self.spec_k:
            entry["k_row"] = min(self.spec_k, max(2, entry["k_row"] * 2))
        elif ew <= self.spec_shrink:
            if entry["k_row"] > 2:
                entry["k_row"] = max(2, entry["k_row"] // 2)
            else:
                nxt = "lookup" if provider in ("model", "aux") else "off"
                entry["draft_mode"] = nxt
                entry["k_row"] = 2 if nxt != "off" else 1
                entry["accept_ewma"] = None
                self.spec_metrics.record_draft_fallback(f"{provider}->{nxt}")

    # -- fault isolation -----------------------------------------------------

    @property
    def wedged(self) -> bool:
        return self.fault_stats.wedged

    @property
    def degrade_level(self) -> int:
        return self.fault_stats.degrade_level

    def fault_state(self) -> dict:
        """O(1) health snapshot for ``/healthz`` and the admission gate:
        bare attribute reads, no locks."""
        return {"wedged": self.fault_stats.wedged,
                "degrade_level": self.fault_stats.degrade_level,
                "restarting": (self.fault_stats.wedged
                               and self._engine_running)}

    def _poll_event(self, event, abort: threading.Event) -> None:
        """Wait for a CUDA event by polling ``query()`` (sleeps of at most
        1 ms) and the watchdog's abort flag: ``synchronize()`` cannot be
        interrupted, and a stuck wait must let go of ``DEVICE_LOCK``."""
        with self._lock:
            self.polled_waits += 1
        while not event.query():
            if abort.is_set():
                return
            time.sleep(0.0005)

    def _device_wait(self, site: str, gen: int | None, fn=None, *args,
                     kind: str = "engine", event=None):
        """A device wait under the fault layer and the watchdog: the site's
        fault hook fires first, then the wait on ``event`` (a CUDA event,
        or None) and ``fn(*args)``. A superseded engine generation aborts
        it instead of touching restarted state. Under a watchdog the wait
        is registered with the monitor, which trips it after
        ``watchdog_s``; the tripped wait raises
        :class:`EngineWatchdogTimeout`. ``kind='request'`` marks a wait on
        a request thread (a prefix continuation, the self-probe): the
        watchdog aborts it and counts the trip, but only engine waits
        wedge the engine. With no watchdog and an empty plan (the
        default) the event is synchronized, and only the site stamp and
        the generation check are added."""
        if self.watchdog_s <= 0 and not self.faults.rules:
            try:
                if event is not None:
                    event.synchronize()
                out = fn(*args) if fn is not None else None
            except Exception as e:  # noqa: BLE001 — stamped, re-raised
                _stamp(e, site)
                raise
            if gen is not None and gen != self._gen:
                raise _StaleEngine()
            return out
        wid = next(self._wait_seq)
        abort = threading.Event()
        rec = {"site": site, "t0": time.monotonic(), "gen": gen,
               "kind": kind, "abort": abort, "tripped": False}
        with self._lock:
            self._waits[wid] = rec
            self._ensure_monitor_locked()
        try:
            self.faults.check(site, interrupt=abort)
            if event is not None:
                self._poll_event(event, abort)
            if abort.is_set():
                raise EngineWatchdogTimeout(site, self.watchdog_s)
            out = fn(*args) if fn is not None else None
        except EngineWatchdogTimeout:
            raise
        except Exception as e:  # noqa: BLE001 — stamped, re-raised
            if abort.is_set():
                # an aborted injected hang: the wait was tripped
                raise EngineWatchdogTimeout(site, self.watchdog_s) from e
            _stamp(e, site)
            raise
        finally:
            with self._lock:
                self._waits.pop(wid, None)
        if abort.is_set():
            raise EngineWatchdogTimeout(site, self.watchdog_s)
        if gen is not None and gen != self._gen:
            raise _StaleEngine()
        return out

    def _ensure_monitor_locked(self) -> None:
        if self.watchdog_s <= 0:
            return
        if self._monitor is not None and self._monitor.is_alive():
            return
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         daemon=True, name="engine-watchdog")
        self._monitor.start()

    def _monitor_loop(self) -> None:
        """The watchdog: trips registered waits older than ``watchdog_s``;
        an engine wait's trip fails the engine, wedged. A tripped wait is
        disowned (a real hang never returns, so its record stays): with
        no other wait and the engine stopped, a wedged engine self-probes
        at a backed-off cadence; an idle healthy one ends the monitor."""
        tick = max(0.01, min(0.2, self.watchdog_s / 4))
        while True:
            time.sleep(tick)
            now = time.monotonic()
            expired: list[dict] = []
            with self._lock:
                live = any(not rec["tripped"]
                           for rec in self._waits.values())
                if not live and not self._engine_running:
                    if not self.fault_stats.wedged:
                        self._monitor = None  # the next wait restarts it
                        return
                    if (not self._probe_live
                            and now - self._probe_t
                            >= min(600.0, max(1.0, 2 * self.watchdog_s)
                                   * (1 << self._probe_misses))):
                        self._probe_live = True
                        self._probe_t = now
                        threading.Thread(target=self._recovery_probe,
                                         daemon=True,
                                         name="engine-recovery-probe").start()
                else:
                    expired = [rec for rec in self._waits.values()
                               if not rec["tripped"]
                               and now - rec["t0"] > self.watchdog_s]
                    for rec in expired:
                        rec["tripped"] = True
                        rec["waited_s"] = now - rec["t0"]
                        if rec["kind"] != "engine":
                            # a request wait: it raises to its own caller
                            self.fault_stats.record_failure(
                                f"watchdog:{rec['site']}", watchdog=True)
                            self.failure_log.append(
                                {"site": f"watchdog:{rec['site']}",
                                 "at": now, "requeued": 0, "wedged": False,
                                 "waited_s": rec["waited_s"]})
            for rec in expired:
                rec["abort"].set()
                if rec["kind"] == "engine":
                    self._fail_engine(
                        EngineWatchdogTimeout(rec["site"], self.watchdog_s),
                        site=f"watchdog:{rec['site']}", gen=rec["gen"],
                        wedged=True, waited_s=rec["waited_s"])

    def _probe_op(self) -> None:
        """One trivial device round trip through the ``transport`` site,
        under ``DEVICE_LOCK`` (no capture may run beside it) and the
        watchdog (the wait polls, so a hung card lets go of the lock)."""
        dev = self.server.device
        with DEVICE_LOCK, torch.inference_mode():
            x = torch.ones(1, device=dev) + 1
            event = None
            if x.is_cuda:
                event = torch.cuda.Event()
                event.record()
            self._device_wait("transport", None, lambda: float(x.cpu()[0]),
                              kind="request", event=event)

    def _recovery_probe(self) -> None:
        """A wedged engine with nothing to serve proves the card answers
        again: :meth:`_probe_op` on a disposable thread, joined for at
        most ``2 * watchdog_s + 1`` seconds. Success clears the wedge and
        counts a recovery; a failure (a sticky CUDA error, a card still
        hung) leaves the engine wedged and backs the cadence off."""
        done = threading.Event()
        ok: list = []

        def op():
            try:
                self._probe_op()
                ok.append(True)
            except Exception:  # noqa: BLE001 — still wedged
                pass
            finally:
                done.set()

        threading.Thread(target=op, daemon=True,
                         name="engine-recovery-probe-op").start()
        finished = done.wait(timeout=2 * self.watchdog_s + 1.0)
        self._probe_live = False
        if not (finished and ok):
            self._probe_misses = min(self._probe_misses + 1, 9)
            return
        self._probe_misses = 0
        with self._lock:
            if self.fault_stats.wedged and not self._engine_running:
                self.fault_stats.set_wedged(False)
                self._had_failure = False
                self.fault_stats.record_recovery()
                log.info("engine recovery probe succeeded: wedge cleared")

    def _fail_engine(self, error: BaseException, *, site: str,
                     gen: int | None, wedged: bool = False,
                     waited_s: float | None = None) -> None:
        """One engine failure, handled as JAX handles it (``wedged``: a
        watchdog trip). Done rows keep their results and release their
        pages; a row that has not streamed, is not abandoned and has
        replays left is reset to its admitted state and requeued (its
        pages kept; a packed row also gets a fresh stream from its seed
        and prefills again, a row never packed keeps its prefill); every
        other row gets the error. A CUDA runtime error replays nothing and
        wedges the engine. The ladder and the wedge update, and a
        replacement engine starts when anything was requeued. The step and
        its graphs are dropped after a CUDA error or a trip, kept
        otherwise."""
        sticky = is_cuda_error(error)
        programs = None
        with self._lock:
            if gen is not None and gen != self._gen:
                return  # a newer generation already handled it
            self._gen += 1
            now = time.monotonic()
            self.fault_stats.record_failure(site, watchdog=wedged)
            if wedged or sticky:
                self.fault_stats.set_wedged(True)
                self._probe_t = now  # the first self-probe an interval out
                self._probe_misses = 0
            self._had_failure = True
            self._last_failure_t = now
            self._fail_times = [t for t in self._fail_times
                                if now - t <= self.degrade_window_s]
            self._fail_times.append(now)
            if len(self._fail_times) >= 2 \
                    and self.fault_stats.degrade_level < 3:
                self.fault_stats.record_degrade(
                    self.fault_stats.degrade_level + 1, site)
            survivors: list[dict] = []
            for entry in self._joiners + [a for a in self._active if a]:
                if entry["done"]:
                    # finished behind the frontier: its result stands; the
                    # barrier that would retire it died with this engine
                    self._retire(entry)
                    continue
                if (not sticky and not entry["streamed"]
                        and not entry["abandoned"]
                        and entry["replays"] < self.max_replays):
                    # no bytes reached this row's client: replay it
                    entry["replays"] += 1
                    entry["toks"], entry["lps"] = [], []
                    entry["disp"] = 0
                    entry["eos_at"] = None
                    entry["slot"] = None
                    # re-drafted from scratch: the chain verify keeps the
                    # replay bitwise whatever its drafts propose
                    entry["spec_pend"] = None
                    entry["spec_inflight"] = 0
                    if entry["packed"]:
                        # its stream was consumed: a fresh one from its
                        # seed, and a prefill again through its route
                        entry["packed"] = False
                        entry["prefill"] = None
                        entry["gen"] = row_streams([(entry["seed"], 0)])[0]
                    # a row never packed keeps its request-thread prefill
                    # (and the stream that drew its first token)
                    survivors.append(entry)
                else:
                    entry["error"], entry["done"] = error, True
                    if self.pool is not None:
                        self._release_pages(entry)
            requeued = len(survivors)
            if requeued:
                self.fault_stats.record_replays(attempted=requeued)
            self.failure_log.append({"site": site, "at": now,
                                     "requeued": requeued,
                                     "wedged": wedged or sticky,
                                     "waited_s": waited_s})
            self._joiners = survivors
            self._active = [None] * self.slots
            if wedged or sticky:
                programs = self._detach()
            self._engine_running = bool(survivors)
            if survivors:
                threading.Thread(target=self._engine_loop,
                                 args=(self._gen,), daemon=True,
                                 name="continuous-batch").start()
            self._lock.notify_all()
        if programs is not None and wedged:
            # closing takes DEVICE_LOCK, which the tripped thread lets go
            # of once it sees its abort: not on the watchdog's thread
            threading.Thread(target=programs.close, daemon=True,
                             name="engine-programs-close").start()
        elif programs is not None:
            programs.close()  # the failed thread let go of DEVICE_LOCK
        if sticky:
            # the server's idle prefill programs and windows go with them
            with DEVICE_LOCK:
                self.server.programs.drop_idle()
        log.error("continuous engine failed at %s: %s (replaying %d "
                  "row(s), degrade level %d%s)", site, error, requeued,
                  self.fault_stats.degrade_level,
                  ", wedged" if (wedged or sticky) else "")

    # -- engine thread -------------------------------------------------------

    def _engine_loop(self, gen: int) -> None:
        try:
            with torch.inference_mode():
                self._engine_body(gen)
        except _StaleEngine:
            log.debug("stale engine generation %d exited", gen)
        except BaseException as e:  # noqa: BLE001 — waiters must never hang
            # a tripped wait that raised here before the watchdog failed
            # the engine is still a trip
            self._fail_engine(e, site=getattr(e, "fault_site", "engine"),
                              gen=gen,
                              wedged=isinstance(e, EngineWatchdogTimeout))

    @staticmethod
    def _cancel_due(entry: dict, now: float) -> bool:
        return bool(entry.get("abandoned")) or (
            entry.get("deadline_at") is not None
            and now > entry["deadline_at"])

    def _cancel_expired_locked(self, now: float) -> None:
        """Barrier cancellation (caller holds the lock, the pipeline is
        empty): rows and queued joiners whose waiter went away or whose
        deadline passed fail with :class:`RequestCancelled`, and their
        slots and pages are freed; decoding them on would spend the card
        on tokens nobody reads."""
        def cancel(e, where):
            e["error"] = RequestCancelled(
                f"cancelled {where}: "
                + ("waiter gone" if e.get("abandoned")
                   else "deadline expired"))
            e["done"], e["prefill"] = True, None
            if self.pool is not None:
                self._release_pages(e)
            self.stats_counters.record_cancelled()
            self.fault_stats.record_cancelled()
            self._lock.notify_all()

        for slot, e in enumerate(self._active):
            if e is not None and not e["done"] and self._cancel_due(e, now):
                self._active[slot] = None
                cancel(e, "at a barrier")
        for j in [j for j in self._joiners if self._cancel_due(j, now)]:
            self._joiners.remove(j)
            cancel(j, "while queued")

    def _barrier(self, gen: int) -> list:
        """The pipeline is empty: restore the ladder after a clean
        interval, cancel what is due, retire finished rows, hand free
        slots to joiners in policy order. Returns the live ``(slot,
        entry)`` pairs; none means the engine stops (caller holds the
        lock)."""
        if gen != self._gen:
            raise _StaleEngine()
        now = time.monotonic()
        if self.fault_stats.degrade_level \
                and self._last_failure_t is not None \
                and now - self._last_failure_t > self.degrade_clean_s:
            self.fault_stats.record_restore()
            self._fail_times.clear()
        self._cancel_expired_locked(now)
        for slot, e in enumerate(self._active):
            if e is not None and e["done"]:
                self._active[slot] = None
                self._retire(e)
        free = [i for i, e in enumerate(self._active) if e is None]
        if self._joiners and free:
            ordered = (self.policy.order(list(self._joiners))
                       if self.policy is not None else list(self._joiners))
            for joiner in ordered[:len(free)]:
                self._joiners.remove(joiner)
                joiner["slot"] = free.pop(0)
                self._active[joiner["slot"]] = joiner
        return self._live_locked()

    def _live_locked(self) -> list:
        return [(slot, e) for slot, e in enumerate(self._active)
                if e is not None]

    def _stop_cause(self, live: list) -> str | None:
        """Why dispatching stops before another segment (caller holds
        the lock): ``complete`` when every live row has its whole output
        dispatched, ``cancel`` when a live row is due to be cancelled (the
        drain brings its barrier at once instead of after the batch),
        ``joiner`` when a waiting joiner could take a slot that is free or
        finished."""
        if not any(not e["done"] and e["disp"] < e["n"] for _, e in live):
            return "complete"
        now = time.monotonic()
        if any(not e["done"] and self._cancel_due(e, now) for _, e in live):
            return "cancel"
        if self._joiners and (len(live) < self.slots
                              or any(e["done"] for _, e in live)):
            return "joiner"
        return None

    def _engine_body(self, gen: int) -> None:
        pstats = self.pipe_stats
        t0 = time.monotonic()
        pstats.begin_episode(t0)
        inflight: deque = deque()
        try:
            while True:
                with self._lock:
                    live = self._barrier(gen)
                    if not live:
                        self._engine_running = False
                        self._lock.notify_all()
                        return
                if (self._step is not None and self.pool is not None
                        and self._arena_generation != self.pool.generation):
                    self.release()  # its graphs hold the old arena's addresses
                with DEVICE_LOCK:
                    if self._step is None:
                        self._dev("op_init_step")
                    self._dev("op_reset_positions",
                              [slot for slot, e in enumerate(self._active)
                               if e is None])
                    self._pack_joiners([e for _, e in live
                                        if not e["packed"]], gen)
                with self._lock:
                    # a failed prefill dropped its rows from their slots
                    live = self._live_locked()
                while True:
                    with self._lock:
                        if gen != self._gen:
                            raise _StaleEngine()
                        cause = self._stop_cause(live)
                    if cause is not None:
                        break
                    # ladder level >= 1: the synchronous loop, one wait
                    # outstanding at a time
                    depth = (1 if self.fault_stats.degrade_level >= 1
                             else self.pipeline_depth)
                    with DEVICE_LOCK:
                        rec = self._device_wait("segment_dispatch", gen,
                                                self._run_segment, live)
                        with self._lock:
                            if gen != self._gen:
                                raise _StaleEngine()
                            for _, e in live:
                                e["disp"] += rec["k"]
                        inflight.append(rec)
                        pstats.record_dispatch(len(inflight))
                        full = len(inflight) >= depth
                        if full:
                            self._wait(inflight[0], gen)
                    if full:
                        self._collect(inflight.popleft(), gen)
                    if depth == 1:
                        break  # the synchronous loop: a barrier each segment
                if inflight:
                    pstats.record_drain(cause)
                    while inflight:
                        with DEVICE_LOCK:
                            self._wait(inflight[0], gen)
                        self._collect(inflight.popleft(), gen)
        finally:
            pstats.record_wall(time.monotonic() - t0)

    def _retire(self, e: dict) -> None:
        """Return a finished row's pages and log it (caller holds the
        lock)."""
        record = {"seq": e["seq"], "s": e["s"], "n": e["n"],
                  "ttft_s": e["ttft_s"], "wall_s": e["wall_s"],
                  "t0": e["t0"], "prefilled_at": e["prefilled_at"],
                  "replays": e["replays"]}
        if self.pool is not None:
            self._release_pages(e)
            record.update({k: e[k] for k in ("n_pages", "charged_at",
                                             "released_at")})
        self.request_log.append(record)

    # -- API -----------------------------------------------------------------

    def _prefill_prefix_row(self, entry: dict, pentry):
        """Dense prefix row: the server's full-window prefix entry
        ``pentry`` copied into a window checked out for it (the entry
        itself is never written), the suffix continued there at the
        suffix bucket the solo prefix path uses (caller holds
        ``DEVICE_LOCK``); returns ``(first, lp0, cache)`` for
        :meth:`_pack`, copies of the window's."""
        server = self.server
        cfg = server.model.cfg
        cache, plen = pentry
        s = entry["s"]
        sbs = min(_next_bucket(s, server.min_bucket), cfg.max_len - plen)
        suffix, _ = server._pad_host([entry["row"]], [s], 1, sbs)
        knobs, sampled = self._knobs(entry)
        window = server._checkout_window(cache_width(cache),
                                         stats=self.stats_counters)
        try:
            window.load(cache, plen)
            first, lp0 = window.cont(suffix, s, knobs, [entry["gen"]],
                                     sampled)
            return first.clone(), lp0.clone(), window.snapshot()
        finally:
            server.programs.checkin(window)

    def _paged_continue_row(self, entry: dict):
        """Paged prefix row: the suffix continued from the shared prefix
        pages, read in place through the row's table; only the suffix is
        written, into the row's own pages. Gathers the whole engine window
        (``max_len`` on every routed configuration) into a window checked
        out for it, so the continuation runs at the shapes of the dense
        and solo prefix paths (caller holds ``DEVICE_LOCK``). Returns
        ``(first, lp0, None)`` for :meth:`_pack`."""
        server, pool = self.server, self.pool
        plen, s = entry["plen"], entry["s"]
        sbs = min(_next_bucket(s, server.min_bucket), self.cache_len - plen)
        cont = server._paged_continue_fn(sbs, pool.page)
        table = torch.as_tensor(
            self._table_row(entry, self.cache_len // pool.page),
            device=server.device)[None, :]
        suffix, _ = server._pad_host([entry["row"]], [s], 1, sbs)
        knobs, sampled = self._knobs(entry)
        window = server._checkout_window(self.cache_len,
                                         stats=self.stats_counters)
        try:
            with pool.arena_lock:
                first, lp0 = cont(window, pool.ensure_arena(), table, plen,
                                  suffix, s, knobs, [entry["gen"]], sampled)
        finally:
            server.programs.checkin(window)
        return first, lp0, None

    def _prefill_row_chunked(self, entry: dict):
        """Long-prompt joiner prefill in fixed-width chunks (JAX
        ``continuous.py:827-869``): ``row[:split]``, ``split`` the last
        multiple of ``prefill_chunk`` before the row's end, walks into a
        ``cache_len`` window checked out for the row (:meth:`LlamaServer.
        _walk_chunks`), each chunk one dispatch under the device lock
        alone, so engine segments run between chunks; then the tail
        continues there at its bucket, which selects the first token. The
        caller holds ``_prefill_lock`` (not the device lock). Returns
        ``(first, lp0, cache)``, copies of the window's, the cache in the
        store layout. The same walk and continuation as solo
        ``generate(row[split:], prefix=row[:split])`` on a ``cache_len ==
        max_len`` engine, so a row is bitwise that run on the card."""
        server = self.server
        ck = server.prefill_chunk
        row, s = entry["row"], entry["s"]
        split = ((s - 1) // ck) * ck  # >= 1 token left to continue
        tail = row[split:]
        sbs = min(_next_bucket(len(tail), server.min_bucket),
                  self.cache_len - split)
        suffix, _ = server._pad_host([tail], [len(tail)], 1, sbs)
        with DEVICE_LOCK:
            knobs, sampled = self._knobs(entry)
            window = server._checkout_window(self.cache_len,
                                             stats=self.stats_counters)
        try:
            t0 = time.monotonic()
            with self._lock:
                self._walking += 1
            try:
                server._walk_chunks(window, row, split,
                                    stats=self.prefill_stats)
            finally:
                with self._lock:
                    self._walking -= 1
            self.prefill_stats.record_walk(time.monotonic() - t0)
            self.stats_counters.record_prefill_chunks(-(-split // ck))
            with DEVICE_LOCK, torch.inference_mode():
                first, lp0 = window.cont(suffix, len(tail), knobs,
                                         [entry["gen"]], sampled)
                return first.clone(), lp0.clone(), window.snapshot()
        finally:
            with DEVICE_LOCK:
                server.programs.checkin(window)

    def _admit_prefix(self, entry: dict, prefix, max_new_tokens: int):
        """The prefix half of :meth:`_admit`: continue the row's suffix
        from its cached prefix here, on the request thread. Returns False
        when the row must run solo: an engine narrower than the prefix
        entry's window, or (paged) a prefix the store does not hold, or a
        row no window or arena could hold. The continuation runs through
        the ``prefix_assemble`` site as a request wait: a fault or a
        watchdog trip there reaches this caller and never the engine."""
        server, s = self.server, entry["s"]
        entry["prefix_toks"] = \
            np.asarray(prefix, np.int32).reshape(-1).tolist()

        def continued(fn, *args):
            def run():
                with self._prefill_lock, DEVICE_LOCK, \
                        torch.inference_mode():
                    return fn(*args)
            return self._device_wait("prefix_assemble", None, run,
                                     kind="request")

        if self.pool is None:
            pentry = server._prefix_entry(prefix)
            if self.cache_len != cache_width(pentry[0]):
                return False
            server._validate(pentry[1] + s, max_new_tokens)
            entry["pos0"] = pentry[1] + s
            entry["route"] = "prefix"
            entry["prefill"] = continued(self._prefill_prefix_row, entry,
                                         pentry)
            return True
        acq = (self.prefix_pages_fn(prefix)
               if self.prefix_pages_fn is not None else None)
        if acq is None:
            return False
        pids, plen = acq
        total = plen + s + max_new_tokens
        if total > self.cache_len \
                or -(-total // self.pool.page) > self.pool.capacity_pages:
            self.pool.release(pids)
            return False
        server._validate(plen + s, max_new_tokens)
        entry["plen"], entry["pos0"] = plen, plen + s
        entry["route"] = "paged_prefix"
        self._charge_pages(entry, total, shared=pids)
        try:
            entry["prefill"] = continued(self._paged_continue_row, entry)
        except BaseException:
            with self._lock:
                self._release_pages(entry)
            raise
        return True

    def _admit(self, prompt_row, max_new_tokens, temperature, top_k, top_p,
               seed, eos_id, return_logprobs, prefix=None):
        """Validate, charge pages, prefill a long prompt (or continue a
        prefix row's suffix) here, enqueue the row as a joiner and start
        the engine. Returns the live entry, or None when the row must run
        solo: past the engine's ``cache_len``, more pages than the arena
        could ever hold, or a prefix row the engine cannot take
        (:meth:`_admit_prefix`). A transiently full arena raises
        :class:`PagesExhausted`."""
        t0 = time.monotonic()
        if max_new_tokens <= 0:
            return None
        row = np.asarray(prompt_row, np.int32).reshape(-1).tolist()
        s = len(row)
        if prefix is None and s + max_new_tokens > self.cache_len:
            return None
        seed = int(seed) if seed is not None else 0
        deadline_ms = current_request_deadline_ms()
        entry = {"n": max_new_tokens, "eos_id": eos_id,
                 "temperature": temperature, "top_k": top_k, "top_p": top_p,
                 "seed": seed, "toks": [], "lps": [],
                 "want_lp": return_logprobs, "done": False, "error": None,
                 "slot": None, "packed": False, "eos_at": None,
                 "row": row, "s": s, "prefill": None, "pos0": s,
                 "prefix_toks": None,
                 # when a request-thread prefill finished (monotonic)
                 "prefilled_at": None,
                 # tokens dispatched for the row (ahead of ``toks`` while
                 # segments are in flight)
                 "disp": 0,
                 # the request context: scheduling class, arrival order
                 # and deadline; a stream whose reader left is abandoned
                 "cls": current_request_class(), "seq": next(_entry_seq),
                 "deadline_at": (t0 + deadline_ms / 1e3 if deadline_ms
                                 else None),
                 "abandoned": False,
                 # fault isolation: replays spent, and whether bytes
                 # reached the client (a streamed row cannot replay)
                 "replays": 0, "streamed": False,
                 # how the row prefills (and prefills again on a replay):
                 # group, row, chunked, prefix or paged_prefix
                 "route": "group",
                 "t0": t0, "ttft_s": None, "wall_s": None,
                 # speculative drafting: the last fetched pending token
                 # (the next draft's anchor), verifies in flight, the
                 # row's draft tier, its adaptive k and acceptance EWMA
                 "spec_pend": None, "spec_inflight": 0,
                 "accept_ewma": None,
                 # the row's own stream, keyed as generate keys a
                 # one-row request; it travels with the row's slot
                 "gen": row_streams([(seed, 0)])[0]}
        entry["draft_mode"], entry["k_row"] = self._spec_row_init()
        if prefix is not None and self._tp is not None:
            raise NotImplementedError(TP_C2.format("the prefix cache"))
        if prefix is not None:
            if not self._admit_prefix(entry, prefix, max_new_tokens):
                return None
            self._enqueue(entry)
            return entry
        self.server._validate(s, max_new_tokens)
        if self.pool is not None:
            if -(-(s + max_new_tokens) // self.pool.page) \
                    > self.pool.capacity_pages:
                return None
            self._charge_pages(entry, s + max_new_tokens)
        try:
            ck = self.server.prefill_chunk
            if s > GROUP_PREFILL_MAX and ck and s > ck \
                    and self.cache_len % ck == 0:
                # chunked (JAX continuous.py:2183-2189): the device lock
                # is taken chunk by chunk, the prefill lock for the walk
                entry["route"] = "chunked"
                with self._prefill_lock:
                    entry["prefill"] = self._prefill_row_chunked(entry)
            elif s > GROUP_PREFILL_MAX:
                entry["route"] = "row"
                with self._prefill_lock, DEVICE_LOCK, \
                        torch.inference_mode():
                    entry["prefill"] = self._prefill_rows([entry])
            if entry["prefill"] is not None:
                entry["prefilled_at"] = time.monotonic()
                self.stats_counters.record_row_prefill()
        except BaseException:
            if self.pool is not None:
                with self._lock:
                    self._release_pages(entry)
            raise
        self._enqueue(entry)
        return entry

    def _enqueue(self, entry: dict) -> None:
        """The admitted row joins the queue; the engine starts if idle."""
        with self._lock:
            self._joiners.append(entry)
            if not self._engine_running:
                self._engine_running = True
                threading.Thread(target=self._engine_loop,
                                 args=(self._gen,), daemon=True,
                                 name="continuous-batch").start()

    def generate(self, prompt_row, *, max_new_tokens: int,
                 temperature: float = 0.0, top_k=None, top_p=None,
                 seed: int = 0, eos_id=None, prefix=None,
                 return_logprobs: bool = False):
        """One request row -> int32 ``[1, max_new_tokens]`` (plus f32
        logprobs when asked): the ``LlamaServer.generate`` contract for a
        single prompt, ``prefix=`` included (the row is then the suffix).
        Rows the engine cannot hold run solo."""
        entry = self._admit(prompt_row, max_new_tokens, temperature, top_k,
                            top_p, seed, eos_id, return_logprobs, prefix)
        if entry is None:
            runner = self._route_longctx(prompt_row, max_new_tokens, prefix)
            if runner is not None:
                return runner.generate(
                    prompt_row, max_new_tokens=max_new_tokens,
                    temperature=temperature, top_k=top_k, top_p=top_p,
                    seed=seed, eos_id=eos_id,
                    return_logprobs=return_logprobs)
            return self.server.generate(
                prompt_row, max_new_tokens=max_new_tokens,
                temperature=temperature, top_k=top_k, top_p=top_p,
                seed=seed, eos_id=eos_id, prefix=prefix,
                return_logprobs=return_logprobs)
        with self._lock:
            while not entry["done"]:
                self._lock.wait(timeout=1.0)
        if entry["error"] is not None:
            raise entry["error"]
        toks, lps = entry["toks"], entry["lps"]
        # truncate at the row's own eos and pad with it, as the solo
        # path's latch does; an eos at or past max_new_tokens is outside
        # the delivered window
        eos_at = entry["eos_at"]
        if eos_at is not None and eos_at < max_new_tokens:
            cut = eos_at + 1
            toks = toks[:cut] + [eos_id] * (max_new_tokens - cut)
            lps = lps[:cut] + [0.0] * (max_new_tokens - cut)
        out = np.asarray([toks[:max_new_tokens]], np.int32)
        if return_logprobs:
            return out, np.asarray([lps[:max_new_tokens]], np.float32)
        return out

    def generate_stream(self, prompt_row, *, max_new_tokens: int,
                        temperature: float = 0.0, top_k=None, top_p=None,
                        seed: int = 0, eos_id=None, segment: int = 16,
                        prefix=None, return_logprobs: bool = False):
        """Streaming over the shared engine: the row joins like any other
        and its slice of each segment is yielded as it lands, as ``[1,
        k]`` chunks, ``k <= segment`` (``(tokens, logprobs)`` pairs when
        asked). Concatenated chunks equal :meth:`generate`'s output up to
        the chunk holding eos. The chunk cadence is the engine's segment;
        ``segment`` (the request's, as the handler clamps it) applies only
        to a row that runs solo, as in JAX; a long-context row's output is
        delivered at the engine's segment."""
        entry = self._admit(prompt_row, max_new_tokens, temperature, top_k,
                            top_p, seed, eos_id, return_logprobs, prefix)
        if entry is None:
            runner = self._route_longctx(prompt_row, max_new_tokens, prefix)
            if runner is not None:
                # the runner decodes the whole row: its output in chunks
                # of the engine's segment, the runner's tokens verbatim
                # (eos filler included), ending at the chunk holding eos
                res = runner.generate(
                    prompt_row, max_new_tokens=max_new_tokens,
                    temperature=temperature, top_k=top_k, top_p=top_p,
                    seed=seed, eos_id=eos_id,
                    return_logprobs=return_logprobs)
                toks, lps = res if return_logprobs else (res, None)
                step = self.segment
                for c0 in range(0, toks.shape[1], step):
                    chunk = toks[:, c0:c0 + step]
                    yield ((chunk, lps[:, c0:c0 + step]) if return_logprobs
                           else chunk)
                    if eos_id is not None and eos_id in chunk[0]:
                        return
                return
            yield from self.server.generate_stream(
                prompt_row, max_new_tokens=max_new_tokens,
                temperature=temperature, top_k=top_k, top_p=top_p,
                seed=seed, eos_id=eos_id, segment=segment,
                prefix=prefix, return_logprobs=return_logprobs)
            return
        try:
            delivered = 0
            while delivered < max_new_tokens:
                with self._lock:
                    while not entry["done"] \
                            and len(entry["toks"]) <= delivered:
                        self._lock.wait(timeout=1.0)
                    if entry["error"] is not None:
                        raise entry["error"]
                    toks, lps = list(entry["toks"]), list(entry["lps"])
                    # at most one segment per chunk, also when this reader
                    # fell behind the engine by several segments
                    take = min(len(toks), max_new_tokens,
                               delivered + self.segment)
                    if take > delivered:
                        # bytes are about to reach the client: from here a
                        # failure can only end the stream with its error
                        # (marked under the lock the failure handler takes)
                        entry["streamed"] = True
                chunk = toks[delivered:take]
                lp_chunk = lps[delivered:take]
                if not chunk:
                    return
                latched = eos_id is not None and eos_id in chunk
                if latched:
                    # fill the rest of the chunk with eos, as the device
                    # latch would, and end the stream at this segment
                    cut = chunk.index(eos_id) + 1
                    chunk = chunk[:cut] + [eos_id] * (len(chunk) - cut)
                    lp_chunk = lp_chunk[:cut] + [0.0] * (len(chunk) - cut)
                delivered = take
                arr = np.asarray([chunk], np.int32)
                yield ((arr, np.asarray([lp_chunk], np.float32))
                       if return_logprobs else arr)
                if latched:
                    return
        finally:
            # a stream closed early (its reader went away) leaves the row
            # without a waiter: the next barrier cancels it
            with self._lock:
                if not entry["done"]:
                    entry["abandoned"] = True

    # -- the long-context tier -------------------------------------------------

    def _longctx_runner(self):
        """The long-context tier, built on first use (one per engine; it
        serializes its own runs). A failed build stands the knob down,
        loudly, and serving goes on."""
        if self.pool is None or not self.max_logical_ctx:
            return None
        with self._longctx_lock:
            if self._longctx is None:
                from lambdipy_tpu_torch.runtime.longctx import \
                    LongContextRunner

                try:
                    self._longctx = LongContextRunner(
                        self.server, self.pool, window=self.cache_len,
                        segment=self.segment,
                        max_logical_ctx=self.max_logical_ctx,
                        long_prefill=self.long_prefill, faults=self.faults,
                        max_replays=max(1, self.max_replays),
                        prefill_stats=self.prefill_stats,
                        graph_stats=GraphStats())
                except Exception as e:  # noqa: BLE001 — stand down, serve on
                    log.error("long-context runner unavailable (the knob "
                              "stands down): %s", e)
                    self.max_logical_ctx = 0
                    return None
            return self._longctx

    def _route_longctx(self, prompt_row, max_new_tokens: int, prefix):
        """The long-context tier for a row the engine refused, when the
        refusal was its window (prompt plus budget past ``cache_len``) and
        the logical cap holds it (JAX ``continuous.py:2231``); None keeps
        the solo fallback."""
        if prefix is not None or not self.max_logical_ctx:
            return None
        try:
            s = int(np.asarray(prompt_row).reshape(-1).shape[0])
        except Exception:  # noqa: BLE001 — a malformed row fails solo
            return None
        if s + int(max_new_tokens) <= self.cache_len:
            return None
        runner = self._longctx_runner()
        if runner is None or not runner.fits(s, int(max_new_tokens)):
            return None
        return runner

    # -- the background warm ---------------------------------------------------

    def warm_group_prefill(self) -> int:
        """Run the group-prefill programs a first concurrent burst would
        otherwise capture one at a time at request latency (JAX
        ``continuous.py:769``): one per power-of-two joiner count from 2
        up to ``slots`` (and ``slots`` itself when it is not a power of
        two) at the smallest prompt bucket, and one at the longest prompt
        bucket a group prefill takes at the largest count. Each takes
        ``DEVICE_LOCK`` for its run (on the card, its capture). Returns
        the programs run; meant for the handler's background warm. The
        port has no AOT store, so nothing is saved afterwards."""
        if self._tp is not None:
            raise NotImplementedError(TP_C2.format("the background warm"))
        counts, bb = [], 2
        while bb <= self.slots:
            counts.append(bb)
            bb *= 2
        if self.slots > 1 and self.slots not in counts:
            counts.append(self.slots)
        seen: set = set()

        def warm(count: int, row: list) -> None:
            entries = [{"row": row, "s": len(row), "n": 1,
                        "temperature": None, "top_k": None, "top_p": None,
                        "seed": 0, "gen": row_streams([(0, 0)])[0]}
                       for _ in range(count)]
            with DEVICE_LOCK, torch.inference_mode():
                self._prefill_rows(entries)
            self.stats_counters.record_warm_prefill()

        for count in counts:
            if (key := _next_bucket(count, 1)) in seen:
                continue
            seen.add(key)
            warm(count, [1, 2, 3])
        n = len(seen)
        # the long-prompt family: rows the engine admits top out near half
        # its cache
        s_warm = min(GROUP_PREFILL_MAX, max(1, self.cache_len // 2))
        min_sb = _next_bucket(3, self.server.min_bucket)
        if counts and _next_bucket(s_warm, self.server.min_bucket) != min_sb:
            warm(max(counts), list(range(1, s_warm + 1)))
            n += 1
        return n

    def stats(self) -> dict:
        with self._lock:
            out = {"mode": "continuous", "slots": self.slots,
                   "segment": self.segment, "cache_len": self.cache_len,
                   "window_bucketing": self.window_bucketing,
                   "paged": self.pool is not None,
                   "pipeline_depth": self.pipeline_depth,
                   "policy": (self.policy.name if self.policy is not None
                              else "arrival"),
                   "active_rows": sum(e is not None for e in self._active),
                   "waiting_joiners": len(self._joiners),
                   **self.stats_counters.report(),
                   "segments_run": self.segments_run,
                   "rows_in_segments": self.rows_in_segments,
                   "pipeline": self.pipe_stats.report(),
                   "decode_window": self.window_stats.report(),
                   "prefill_chunk": self.server.prefill_chunk,
                   "prefill": self.prefill_stats.report(),
                   **({"spec": {"k": self.spec_k,
                                "draft_mode": self.draft_mode,
                                "draft_exit": self.draft_exit,
                                **self.spec_metrics.report()}}
                      if self.spec_k else {}),
                   "watchdog_s": self.watchdog_s,
                   "max_replays": self.max_replays,
                   "polled_waits": self.polled_waits,
                   "faults": self.fault_stats.report(),
                   **({"fault_plan": self.faults.describe()}
                      if self.faults.active() else {})}
            if self.mesh_stats is not None:
                out["mesh"] = self._mesh_report_locked()
        if self._longctx is not None:
            out["long_context"] = self._longctx.report()
        if self.pool is not None:
            out["page_pool"] = self.pool.stats()
        return out

    def _mesh_report_locked(self) -> dict:
        """``batching.mesh``: the KV byte gauges refreshed from the live
        engine state (the step's cache, or the paged arena), shard
        metadata only, no device read (JAX ``continuous.py:2437-2455``);
        caller holds the engine lock."""
        from lambdipy_tpu_torch.parallel.sharding import device_bytes

        kv = None
        if self.pool is not None:
            kv = self.pool.arena
        elif self._step is not None:
            kv = [{name: val for name, val in entry.items()
                   if name in _leaves(entry) or name == "index"}
                  for entry in self._step.cache]
        if kv is not None:
            self.mesh_stats.set_kv_bytes(*device_bytes(
                kv, kv_shardings(self.server.mesh)))
        return self.mesh_stats.report()
