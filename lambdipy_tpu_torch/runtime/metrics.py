"""Counters the port's serving path reports under ``/metrics``: the
port's copies of ``LatencyStats``, ``PipelineStats``, ``PagePoolStats``
and ``PrefixCacheStats`` (``lambdipy_tpu/runtime/metrics.py``),
``PrefillStats`` cut to the chunked walk, ``DecodeWindowStats``,
``EngineFaultStats``, ``MeshStats`` (tensor-parallel serving), the
prefix store's tiers (``KvOffloadStats``, ``KvShipStats``), the fleet's
(``DisaggStats``, ``SessionStats``, ``RouterStats``, ``ControllerStats``:
the router's ``fleet.disagg``, ``fleet.sessions``, ``router`` and
``fleet.controller`` blocks, with JAX's keys and EWMAs), and the
continuous engine's own counters (segments, decode steps, joins, rows
per step)."""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field


@dataclass
class LatencyStats:
    """Bounded reservoir of recent latencies (ms) with percentile report."""

    capacity: int = 2048
    samples: list[float] = field(default_factory=list)
    count: int = 0
    errors: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def record(self, ms: float) -> None:
        with self._lock:
            # sample N lands at index N % capacity once the ring is full
            if len(self.samples) >= self.capacity:
                self.samples[self.count % self.capacity] = ms
            else:
                self.samples.append(ms)
            self.count += 1

    def record_error(self) -> None:
        with self._lock:
            self.errors += 1

    @staticmethod
    def _percentile(samples: list[float], q: float) -> float | None:
        if not samples:
            return None
        s = sorted(samples)
        idx = min(len(s) - 1, max(0, round(q / 100.0 * (len(s) - 1))))
        return s[idx]

    def percentile(self, q: float) -> float | None:
        with self._lock:
            samples = list(self.samples)
        return self._percentile(samples, q)

    def report(self) -> dict:
        with self._lock:
            count, errors = self.count, self.errors
            samples = list(self.samples)
        return {
            "count": count,
            "errors": errors,
            "p50_ms": self._percentile(samples, 50),
            "p90_ms": self._percentile(samples, 90),
            "p99_ms": self._percentile(samples, 99),
        }


@dataclass
class DecodeWindowStats:
    """Counters for length-aware decode (the ``decode_window`` block of
    the engine's ``/metrics``): how many KV positions each decode step
    ATTENDED, how many the dispatched window READ and what the full
    static window would have read. ``savings_ratio`` = read / full: < 1
    means window bucketing cut the window a segment was dispatched at;
    1.0 means every step paid the whole allocated window. ``buckets``
    histograms the windows segments dispatched at. The keys are JAX's
    (``lambdipy_tpu/runtime/metrics.py:72-110``)."""

    attended_tokens: int = 0   # sum over rows x steps of positions attended
    window_tokens: int = 0     # sum of positions the program actually read
    full_tokens: int = 0       # what the full static window would have read
    segments: int = 0
    buckets: dict = field(default_factory=dict)  # window -> segment count
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def record_segment(self, *, attended: int, window_read: int,
                       full_window: int, window: int) -> None:
        with self._lock:
            self.attended_tokens += int(attended)
            self.window_tokens += int(window_read)
            self.full_tokens += int(full_window)
            self.segments += 1
            self.buckets[int(window)] = self.buckets.get(int(window), 0) + 1

    def report(self) -> dict:
        with self._lock:
            full = self.full_tokens
            return {
                "attended_tokens": self.attended_tokens,
                "window_tokens": self.window_tokens,
                "full_tokens": full,
                "savings_ratio": (round(self.window_tokens / full, 4)
                                  if full else 1.0),
                "attended_ratio": (round(self.attended_tokens / full, 4)
                                   if full else 1.0),
                "segments": self.segments,
                "buckets": {str(w): n
                            for w, n in sorted(self.buckets.items())},
            }


@dataclass
class MeshStats:
    """JAX's ``MeshStats`` (``metrics.py:114-175``), field for field:
    gauges + counters for tensor-parallel sharded serving (the
    ``batching.mesh`` block on ``/metrics``). ``shape`` is the serving
    mesh ({axis: size}, size-1 axes omitted) over ``devices`` chips.
    The byte gauges are refreshed from the LIVE engine state at scrape
    time (host-only shard metadata, no device reads):
    ``kv_bytes_per_device`` is the busiest device's share of the
    engine's KV residency (B-slot carry, or the paged arena) vs
    ``kv_bytes_replicated`` — the same object's single-device
    footprint (the port: this rank's share against the whole, one
    process per device); ``hbm_savings`` is their ratio (~1/tp when the head
    sharding holds, 1.0 means the mesh is paying collectives for
    nothing). ``param_bytes_per_device`` / ``param_bytes_total`` track
    the weights the same way. ``collectives_per_segment`` is the
    analytic Megatron-layout count for one engine segment — per decoded
    token, one all-reduce for the vocab-sharded embedding lookup, one
    after the row-parallel o_proj and one after down_proj per layer,
    plus one lm_head logits all-gather per select — i.e.
    ``segment * (2 * layers + 2)``; 0 on a tp-less mesh.
    ``segments_sharded`` counts segments dispatched over the mesh."""

    shape: dict = field(default_factory=dict)
    devices: int = 1
    kv_bytes_per_device: int = 0
    kv_bytes_replicated: int = 0
    param_bytes_per_device: int = 0
    param_bytes_total: int = 0
    collectives_per_segment: int = 0
    segments_sharded: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def set_layout(self, *, shape: dict, devices: int,
                   collectives_per_segment: int) -> None:
        with self._lock:
            self.shape = {str(a): int(n) for a, n in shape.items()}
            self.devices = int(devices)
            self.collectives_per_segment = int(collectives_per_segment)

    def set_kv_bytes(self, per_device: int, replicated: int) -> None:
        with self._lock:
            self.kv_bytes_per_device = int(per_device)
            self.kv_bytes_replicated = int(replicated)

    def set_param_bytes(self, per_device: int, total: int) -> None:
        with self._lock:
            self.param_bytes_per_device = int(per_device)
            self.param_bytes_total = int(total)

    def record_segment(self, n: int = 1) -> None:
        with self._lock:
            self.segments_sharded += int(n)

    def report(self) -> dict:
        with self._lock:
            rep = self.kv_bytes_replicated
            return {
                "shape": dict(self.shape),
                "devices": self.devices,
                "kv_bytes_per_device": self.kv_bytes_per_device,
                "kv_bytes_replicated": rep,
                "hbm_savings": (round(self.kv_bytes_per_device / rep, 4)
                                if rep else 1.0),
                "param_bytes_per_device": self.param_bytes_per_device,
                "param_bytes_total": self.param_bytes_total,
                "param_savings": (
                    round(self.param_bytes_per_device
                          / self.param_bytes_total, 4)
                    if self.param_bytes_total else 1.0),
                "collectives_per_segment": self.collectives_per_segment,
                "segments_sharded": self.segments_sharded,
            }


@dataclass
class PipelineStats:
    """The continuous engine's pipelined dispatch/collect loop (the
    ``batching.pipeline`` block on ``/metrics``). ``in_flight``
    histograms the segments on the card at each dispatch (this one
    included); ``drains`` counts the barrier causes (``joiner``: a
    waiting joiner forced a bounded drain so packing sees host-truth
    slots; ``complete``: every live row had its whole output
    dispatched; ``cancel``: a live row's deadline passed or its stream's
    reader left). ``wasted_tokens`` are tokens fetched for rows already
    finished (eos or quota observed behind the dispatch frontier) and
    dropped on the host. ``fetch_block_s`` is the JAX metric's interval:
    from the end of the wait on a segment until its host arrays exist
    (the transport, near 0 here: the block is copied ``non_blocking``
    into pinned memory before the wait ends); ``device_wait_s`` is the
    host's wait on the segment's CUDA event, the card's compute still
    outstanding when the host asked; ``overlap_ratio`` = device-busy /
    wall, device-busy the union of each segment's [dispatch,
    tokens-ready] interval, so 1.0 means the card always had a segment
    queued while the host booked."""

    depth: int = 1
    segments: int = 0
    dispatches: int = 0
    wasted_tokens: int = 0
    inflight: dict = field(default_factory=dict)  # depth -> dispatches
    drains: dict = field(default_factory=dict)    # cause -> count
    device_busy_s: float = 0.0
    fetch_block_s: float = 0.0
    device_wait_s: float = 0.0
    wall_s: float = 0.0
    _cover_end: float = field(default=0.0, repr=False)
    # start of the engine episode running now (None when idle): report()
    # folds the open episode into wall, so a mid-traffic scrape is sane
    _ep_t0: float | None = field(default=None, repr=False)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def record_dispatch(self, inflight_depth: int) -> None:
        with self._lock:
            self.dispatches += 1
            self.inflight[int(inflight_depth)] = \
                self.inflight.get(int(inflight_depth), 0) + 1

    def record_collect(self, dispatch_t: float, ready_t: float, *,
                       fetch_s: float, wasted: int,
                       wait_s: float = 0.0) -> None:
        with self._lock:
            self.segments += 1
            self.wasted_tokens += int(wasted)
            self.fetch_block_s += max(0.0, fetch_s)
            self.device_wait_s += max(0.0, wait_s)
            # the union of [dispatch, ready] intervals, accumulated as
            # they come: both ends are monotone across segments
            self.device_busy_s += max(
                0.0, ready_t - max(dispatch_t, self._cover_end))
            self._cover_end = max(self._cover_end, ready_t)

    def record_drain(self, cause: str) -> None:
        with self._lock:
            self.drains[cause] = self.drains.get(cause, 0) + 1

    def begin_episode(self, t: float) -> None:
        with self._lock:
            self._ep_t0 = t

    def record_wall(self, seconds: float) -> None:
        """Close the open episode, folding its wall into ``wall_s``."""
        with self._lock:
            self.wall_s += max(0.0, seconds)
            self._ep_t0 = None

    def report(self) -> dict:
        with self._lock:
            wall = self.wall_s
            if self._ep_t0 is not None:
                wall += max(0.0, time.monotonic() - self._ep_t0)
            return {
                "depth": self.depth,
                "segments": self.segments,
                "dispatches": self.dispatches,
                "wasted_overdecode_tokens": self.wasted_tokens,
                "in_flight": {str(d): n
                              for d, n in sorted(self.inflight.items())},
                "drains": dict(self.drains),
                "device_busy_s": round(self.device_busy_s, 4),
                "fetch_block_s": round(self.fetch_block_s, 4),
                "device_wait_s": round(self.device_wait_s, 4),
                "wall_s": round(wall, 4),
                "overlap_ratio": (round(self.device_busy_s / wall, 4)
                                  if wall else 0.0),
            }


@dataclass
class PagePoolStats:
    """Counters of the paged KV allocator (merged into
    :meth:`lambdipy_tpu_torch.runtime.pagepool.PagePool.stats`).
    ``allocs``/``alloc_pages`` count allocation calls and pages taken,
    ``releases``/``release_pages`` pages actually returned to the free
    list (a release of a still-shared page is a refcount drop, not a
    free), ``shares`` refcount bumps, and ``sheds`` admissions refused
    with :class:`~lambdipy_tpu_torch.runtime.pagepool.PagesExhausted`."""

    allocs: int = 0
    alloc_pages: int = 0
    releases: int = 0
    release_pages: int = 0
    shares: int = 0
    sheds: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def record_alloc(self, pages: int) -> None:
        with self._lock:
            self.allocs += 1
            self.alloc_pages += int(pages)

    def record_release(self, pages: int) -> None:
        with self._lock:
            self.releases += 1
            self.release_pages += int(pages)

    def record_share(self, pages: int = 1) -> None:
        with self._lock:
            self.shares += int(pages)

    def record_shed(self) -> None:
        with self._lock:
            self.sheds += 1

    def report(self) -> dict:
        with self._lock:
            return {"allocs": self.allocs, "alloc_pages": self.alloc_pages,
                    "releases": self.releases,
                    "release_pages": self.release_pages,
                    "shares": self.shares, "sheds": self.sheds}


@dataclass
class EngineStats:
    """The continuous engine's counters: ``segments`` run, decode
    ``steps`` (one forward of the slot batch each; the paged engine
    launches its attention kernel once per layer per step),
    ``rows_stepped`` (live rows summed over steps, so
    ``rows_stepped / steps`` is the mean batch), ``joins`` (rows packed
    into a slot), ``prefix_joins`` (rows that joined from a cached
    prefix K/V: the explicit ``prefix=`` or the prefix store's routing,
    their suffix continued on the request thread and packed like a
    long-prompt row), ``prefill_groups``/``rows_group_prefilled`` (the
    engine's grouped prefills), ``row_prefills`` (long prompts prefilled
    alone on their request thread, a chunked row's continuation
    included), ``prefill_chunks`` (the chunk forwards of chunked row
    prefills), ``walk_segments`` (segments dispatched while a chunked
    walk was in progress), ``warm_prefills`` (the background warm's
    group prefills, counted among the forwards), ``requests_served``,
    ``cancelled``
    (rows failed with ``RequestCancelled`` at a barrier: deadline passed
    or waiter gone), and the programs' ``captures`` (CUDA graphs
    captured, decode and prefill, reported as ``compile_count``),
    ``replays`` (steps run as a graph replay), ``eager_steps`` (steps run
    eagerly), ``prefill_replays`` and ``eager_prefills`` (the engine's
    prefills: groups, long rows, prefix rows, a chunked row's chunks and
    tail), recorded through :meth:`record` by ``models/graphs.py
    GraphProgram``. Steps
    are counted when dispatched, over-decoded steps of a pipelined
    engine included, so the kernels' launch counters stay equal to what
    ``steps`` and ``forwards`` imply."""

    segments: int = 0
    steps: int = 0
    rows_stepped: int = 0
    joins: int = 0
    prefix_joins: int = 0
    prefill_groups: int = 0
    rows_group_prefilled: int = 0
    row_prefills: int = 0
    prefill_chunks: int = 0
    walk_segments: int = 0
    requests_served: int = 0
    captures: int = 0
    replays: int = 0
    eager_steps: int = 0
    prefill_replays: int = 0
    eager_prefills: int = 0
    cancelled: int = 0
    verify_segments: int = 0
    verify_rows: int = 0
    draft_forwards: int = 0
    warm_prefills: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def record(self, name: str, n: int = 1) -> None:
        """A program's event: ``captures``, ``replays``, ``eager_steps``,
        ``prefill_replays`` or ``eager_prefills``."""
        with self._lock:
            setattr(self, name, getattr(self, name) + int(n))

    def record_segment(self, steps: int, live_rows: int,
                       beside_walk: bool = False) -> None:
        with self._lock:
            self.segments += 1
            self.steps += int(steps)
            self.rows_stepped += int(steps) * int(live_rows)
            self.walk_segments += int(beside_walk)

    def record_verify(self, live_rows: int, kb: int, draft_forwards: int,
                      beside_walk: bool = False) -> None:
        """One speculative verify segment: a step (one forward of
        ``slots * kb`` one-token rows), ``live_rows * kb`` rows verified,
        and ``draft_forwards`` shallow-exit draft forwards before it."""
        with self._lock:
            self.segments += 1
            self.steps += 1
            self.rows_stepped += int(live_rows)
            self.walk_segments += int(beside_walk)
            self.verify_segments += 1
            self.verify_rows += int(live_rows) * int(kb)
            self.draft_forwards += int(draft_forwards)

    def record_group_prefill(self, rows: int) -> None:
        with self._lock:
            self.prefill_groups += 1
            self.rows_group_prefilled += int(rows)

    def record_row_prefill(self) -> None:
        with self._lock:
            self.row_prefills += 1

    def record_prefill_chunks(self, chunks: int) -> None:
        with self._lock:
            self.prefill_chunks += int(chunks)

    def record_join(self) -> None:
        with self._lock:
            self.joins += 1

    def record_warm_prefill(self) -> None:
        with self._lock:
            self.warm_prefills += 1

    def record_served(self) -> None:
        with self._lock:
            self.requests_served += 1

    def record_prefix_join(self) -> None:
        with self._lock:
            self.prefix_joins += 1

    def record_cancelled(self) -> None:
        with self._lock:
            self.cancelled += 1

    def report(self) -> dict:
        with self._lock:
            return {"segments": self.segments, "steps": self.steps,
                    "rows_stepped": self.rows_stepped,
                    "mean_rows_per_step": (round(self.rows_stepped
                                                 / self.steps, 4)
                                           if self.steps else 0.0),
                    "joins": self.joins,
                    "prefix_joins": self.prefix_joins,
                    "prefill_groups": self.prefill_groups,
                    "rows_group_prefilled": self.rows_group_prefilled,
                    "row_prefills": self.row_prefills,
                    "prefill_chunks": self.prefill_chunks,
                    "walk_segments": self.walk_segments,
                    # the background warm's group prefills
                    "warm_prefills": self.warm_prefills,
                    # forwards the engine ran: decode steps, one per
                    # prefill (grouped, alone or warming) and one per walk
                    # chunk
                    "forwards": (self.steps + self.prefill_groups
                                 + self.row_prefills + self.prefill_chunks
                                 + self.warm_prefills),
                    "requests_served": self.requests_served,
                    "cancelled": self.cancelled,
                    "compile_count": self.captures,
                    "replays": self.replays,
                    "eager_steps": self.eager_steps,
                    "prefill_replays": self.prefill_replays,
                    "eager_prefills": self.eager_prefills,
                    # speculative verifies (each one of the steps) and
                    # the shallow-exit draft forwards before them
                    "verify_segments": self.verify_segments,
                    "verify_rows": self.verify_rows,
                    "draft_forwards": self.draft_forwards}


@dataclass
class EngineFaultStats:
    """The continuous engine's fault isolation (the ``batching.faults``
    block of ``/metrics``), the twin of the JAX package's. ``failures``
    counts engine failures by site (a ``watchdog:`` prefix marks a wait
    the watchdog gave up on, also counted in ``watchdog_trips``);
    ``replays`` counts rows requeued through a restarted engine
    (``attempted``) and those of them that completed (``succeeded``);
    ``cancelled`` rows dropped at a barrier (waiter gone or deadline
    passed). ``degrade_level`` is the ladder's level (0 full service, 1
    pipeline depth 1, 2 the full-window program, 3 the prefix store
    bypassed), ``degrade_steps`` the entries into each level and
    ``last_degrade_cause`` the site of the last step. ``recoveries``
    counts the first clean fetch after a failure (or a self-probe that
    cleared a wedge), ``restores`` the ladder's returns to 0 after a
    clean interval; ``wedged`` is what ``/healthz`` reports."""

    failures: dict = field(default_factory=dict)   # site -> count
    watchdog_trips: int = 0
    replays_attempted: int = 0
    replays_succeeded: int = 0
    cancelled: int = 0
    degrade_level: int = 0                          # gauge
    degrade_steps: dict = field(default_factory=dict)  # level -> entries
    last_degrade_cause: str | None = None
    recoveries: int = 0
    restores: int = 0
    wedged: bool = False                            # gauge
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def record_failure(self, site: str, *, watchdog: bool = False) -> None:
        with self._lock:
            self.failures[site] = self.failures.get(site, 0) + 1
            if watchdog:
                self.watchdog_trips += 1

    def record_replays(self, *, attempted: int = 0, succeeded: int = 0
                       ) -> None:
        with self._lock:
            self.replays_attempted += int(attempted)
            self.replays_succeeded += int(succeeded)

    def record_cancelled(self, n: int = 1) -> None:
        with self._lock:
            self.cancelled += int(n)

    def record_degrade(self, level: int, cause: str) -> None:
        with self._lock:
            self.degrade_level = int(level)
            self.degrade_steps[str(level)] = \
                self.degrade_steps.get(str(level), 0) + 1
            self.last_degrade_cause = cause

    def record_restore(self) -> None:
        with self._lock:
            if self.degrade_level:
                self.restores += 1
            self.degrade_level = 0

    def record_recovery(self) -> None:
        with self._lock:
            self.recoveries += 1

    def set_wedged(self, wedged: bool) -> None:
        with self._lock:
            self.wedged = bool(wedged)

    def report(self) -> dict:
        with self._lock:
            return {
                "failures": dict(self.failures),
                "watchdog_trips": self.watchdog_trips,
                "replays": {"attempted": self.replays_attempted,
                            "succeeded": self.replays_succeeded},
                "cancelled": self.cancelled,
                "degrade_level": self.degrade_level,
                "degrade_steps": dict(self.degrade_steps),
                "last_degrade_cause": self.last_degrade_cause,
                "recoveries": self.recoveries,
                "restores": self.restores,
                "wedged": self.wedged,
            }


@dataclass
class PrefixCacheStats:
    """Counters for the automatic cross-request prefix KV cache: a
    request whose prompt longest-prefix-matches the radix tree is a hit
    (``hit_tokens`` = prompt tokens whose prefill was skipped), one with
    cacheable length but no match is a miss. ``bytes``/``blocks`` track
    what the store currently holds against its device-memory budget;
    ``evictions`` counts blocks dropped by the budget's LRU sweep.
    ``assembly_bytes_peak`` is the largest single full-window cache the
    store has ASSEMBLED (``concat_cache_blocks``) for a hit: the copy and
    peak-memory spike the paged path eliminates, reported explicitly
    (always present, 0 on the paged path) so "no assembly happened" is an
    observable fact rather than a missing key."""

    hits: int = 0
    misses: int = 0
    hit_tokens: int = 0
    evictions: int = 0
    bytes: int = 0
    blocks: int = 0
    assembly_bytes_peak: int = 0
    assemblies: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def record_request(self, matched_tokens: int) -> None:
        with self._lock:
            if matched_tokens > 0:
                self.hits += 1
                self.hit_tokens += matched_tokens
            else:
                self.misses += 1

    def record_insert(self, n_blocks: int, nbytes: int) -> None:
        with self._lock:
            self.blocks += n_blocks
            self.bytes += nbytes

    def record_evict(self, n_blocks: int, nbytes: int) -> None:
        with self._lock:
            self.blocks -= n_blocks
            self.bytes -= nbytes
            self.evictions += n_blocks

    def record_assembly(self, nbytes: int) -> None:
        with self._lock:
            self.assemblies += 1
            self.assembly_bytes_peak = max(self.assembly_bytes_peak,
                                           int(nbytes))

    def report(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": round(self.hits / total, 4) if total else 0.0,
                "hit_tokens": self.hit_tokens,
                "evictions": self.evictions,
                "bytes": self.bytes,
                "blocks": self.blocks,
                "assemblies": self.assemblies,
                "assembly_bytes_peak": self.assembly_bytes_peak,
            }


@dataclass
class PrefillStats:
    """Chunked walks: the prefix store's cold walks and the continuous
    engine's chunked joiner prefills, which share one block when a
    handler builds both (the JAX package's ``PrefillStats``,
    ``batching.prefill`` on ``/metrics``, cut to the chunked walk): a
    ROUND is one chunk's dispatch on the request's critical path,
    ``walks`` the walks run and ``critical_path_s`` their host wall
    time, summed."""

    rounds: int = 0
    chunks: int = 0
    walks: int = 0
    critical_path_s: float = 0.0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def record_round(self, chunks: int = 1) -> None:
        with self._lock:
            self.rounds += 1
            self.chunks += int(chunks)

    def record_walk(self, wall_s: float) -> None:
        with self._lock:
            self.walks += 1
            self.critical_path_s += float(wall_s)

    def report(self) -> dict:
        with self._lock:
            return {"mode": "chunked", "rounds": self.rounds,
                    "chunks": self.chunks, "walks": self.walks,
                    "critical_path_s": round(self.critical_path_s, 6)}


@dataclass
class SpecDecodeStats:
    """Speculative decoding's counters, the JAX ``SpecDecodeStats``
    (``lambdipy_tpu/runtime/metrics.py:364``): ``/metrics`` ``spec`` for
    the solo ``"speculative": k`` path and ``batching.spec`` for the
    engine's ``spec_k``, one object (``LlamaServer.spec_metrics``; the
    engine shares its server's).

    A step is one verify: ``proposed`` draft tokens offered, ``accepted``
    of them equal to the target chain, ``emitted`` tokens delivered
    (accepted plus the corrected token). ``acceptance_rate`` =
    accepted / proposed; ``tokens_per_step`` = emitted / steps, the
    speed-up's proxy (decode is bound by the bytes of the weights it
    reads). ``wasted_verify_tokens``: proposed and rejected positions.
    ``draft_hits`` / ``draft_misses``: steps whose lookup found an n-gram
    or fell back. ``hist``: steps by tokens emitted. ``fallback_rows`` /
    ``row_fallbacks``: requests that decoded plainly, by reason. The
    ``draft`` block: per provider steps, proposals, acceptances and an
    acceptance EWMA, the dispatched-k histogram and provider demotions.
    The port has no sequence-parallel decode, so ``sp_standdown`` is 0."""

    steps: int = 0
    emitted_tokens: int = 0
    proposed_tokens: int = 0
    accepted_tokens: int = 0
    wasted_verify_tokens: int = 0
    draft_hits: int = 0
    draft_misses: int = 0
    fallback_rows: int = 0
    row_fallbacks: dict = field(default_factory=dict)  # reason -> rows
    hist: dict = field(default_factory=dict)           # emitted -> steps
    providers: dict = field(default_factory=dict)      # name -> counters
    k_hist: dict = field(default_factory=dict)         # k -> steps
    draft_fallbacks: dict = field(default_factory=dict)  # edge -> rows
    draft_ewma_alpha: float = 0.2
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def record_step(self, *, proposed: int, accepted: int, emitted: int,
                    hit: bool, provider: str = "lookup",
                    k: int | None = None) -> None:
        with self._lock:
            self.steps += 1
            self.proposed_tokens += int(proposed)
            self.accepted_tokens += int(accepted)
            self.emitted_tokens += int(emitted)
            self.wasted_verify_tokens += max(0, int(proposed) - int(accepted))
            if hit:
                self.draft_hits += 1
            else:
                self.draft_misses += 1
            self.hist[int(emitted)] = self.hist.get(int(emitted), 0) + 1
            p = self.providers.setdefault(
                str(provider), {"steps": 0, "proposed": 0, "accepted": 0,
                                "ewma": None})
            p["steps"] += 1
            p["proposed"] += int(proposed)
            p["accepted"] += int(accepted)
            if proposed > 0:
                frac = int(accepted) / float(proposed)
                a = self.draft_ewma_alpha
                p["ewma"] = (frac if p["ewma"] is None
                             else (1.0 - a) * p["ewma"] + a * frac)
            if k is not None:
                self.k_hist[int(k)] = self.k_hist.get(int(k), 0) + 1

    def record_fallback(self, reason: str = "plain") -> None:
        with self._lock:
            self.fallback_rows += 1
            self.row_fallbacks[str(reason)] = \
                self.row_fallbacks.get(str(reason), 0) + 1

    def record_draft_fallback(self, edge: str) -> None:
        """One row demoted along the provider chain (``"model->lookup"``,
        ``"lookup->off"``) by the engine's adaptive k."""
        with self._lock:
            self.draft_fallbacks[str(edge)] = \
                self.draft_fallbacks.get(str(edge), 0) + 1

    def report(self) -> dict:
        with self._lock:
            steps, proposed = self.steps, self.proposed_tokens
            return {
                "steps": steps,
                "emitted_tokens": self.emitted_tokens,
                "proposed_tokens": proposed,
                "accepted_tokens": self.accepted_tokens,
                "acceptance_rate": (round(self.accepted_tokens / proposed, 4)
                                    if proposed else 0.0),
                "tokens_per_step": (round(self.emitted_tokens / steps, 3)
                                    if steps else 0.0),
                "wasted_verify_tokens": self.wasted_verify_tokens,
                "draft_hits": self.draft_hits,
                "draft_misses": self.draft_misses,
                "draft_hit_rate": (round(self.draft_hits / steps, 4)
                                   if steps else 0.0),
                "fallback_rows": self.fallback_rows,
                "row_fallbacks": dict(self.row_fallbacks),
                "tokens_per_step_hist": {str(n): c for n, c in
                                         sorted(self.hist.items())},
                "draft": {
                    "providers": {
                        name: {"steps": p["steps"],
                               "proposed": p["proposed"],
                               "accepted": p["accepted"],
                               "acceptance_ewma": (
                                   round(p["ewma"], 4)
                                   if p["ewma"] is not None else None)}
                        for name, p in sorted(self.providers.items())},
                    "k_hist": {str(n): c for n, c in
                               sorted(self.k_hist.items())},
                    "fallbacks": dict(self.draft_fallbacks),
                },
                "sp_standdown": 0,
                "sp_standdown_reasons": {},
            }


@dataclass
class KvOffloadStats:
    """Counters for the paged-KV host-offload tier (the ``kv.offload``
    block on ``/metrics``; residency gauges ride on
    :meth:`lambdipy_tpu_torch.runtime.offload.OffloadArena.gauges`, merged
    into the pool's stats). ``spills``/``spill_pages`` count spill calls
    and pages moved to host RAM, ``reonlines``/``reonline_pages`` the
    batched fetch-and-write round trips back into the device arena
    (``reonline_batches`` meters how well the prefetcher coalesces
    them — one frame decode per batch, not per page), and
    ``template_encodes`` every derivation of the kvwire leaf template
    from live arrays — the hot loop must keep it at its attach-time
    value (one), which ``tests/test_torch_offload.py`` asserts.
    ``prefetch_hits`` are pages the decode-cursor prefetcher had
    already re-onlined when attention demanded them; ``demand_misses``
    stalled the dispatch (``stall_s`` accumulates that wait).
    ``recomputes`` count failed re-onlines degraded to prefill
    recompute — counted work, never a wrong token."""

    spills: int = 0
    spill_pages: int = 0
    spill_bytes: int = 0
    reonlines: int = 0
    reonline_pages: int = 0
    reonline_batches: int = 0
    frame_decodes: int = 0
    template_encodes: int = 0
    prefetch_hits: int = 0
    demand_misses: int = 0
    stall_s: float = 0.0
    stalls: int = 0
    recomputes: int = 0
    drops: int = 0
    spill_refusals: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def record_spill(self, pages: int, nbytes: int) -> None:
        with self._lock:
            self.spills += 1
            self.spill_pages += int(pages)
            self.spill_bytes += int(nbytes)

    def record_spill_refusal(self) -> None:
        with self._lock:
            self.spill_refusals += 1

    def record_reonline(self, pages: int, *, batches: int = 1,
                        decodes: int = 1) -> None:
        with self._lock:
            self.reonlines += 1
            self.reonline_pages += int(pages)
            self.reonline_batches += int(batches)
            self.frame_decodes += int(decodes)

    def record_template_encode(self) -> None:
        with self._lock:
            self.template_encodes += 1

    def record_prefetch(self, hits: int, misses: int) -> None:
        with self._lock:
            self.prefetch_hits += int(hits)
            self.demand_misses += int(misses)

    def record_stall(self, seconds: float) -> None:
        with self._lock:
            self.stalls += 1
            self.stall_s += float(seconds)

    def record_recompute(self, pages: int = 1) -> None:
        with self._lock:
            self.recomputes += int(pages)

    def record_drop(self, pages: int = 1) -> None:
        with self._lock:
            self.drops += int(pages)

    def report(self) -> dict:
        with self._lock:
            demanded = self.prefetch_hits + self.demand_misses
            return {
                "spills": self.spills,
                "spill_pages": self.spill_pages,
                "spill_bytes": self.spill_bytes,
                "reonlines": self.reonlines,
                "reonline_pages": self.reonline_pages,
                "reonline_batches": self.reonline_batches,
                "frame_decodes": self.frame_decodes,
                "template_encodes": self.template_encodes,
                "prefetch_hits": self.prefetch_hits,
                "demand_misses": self.demand_misses,
                "prefetch_hit_rate": (
                    round(self.prefetch_hits / demanded, 4)
                    if demanded else 1.0),
                "stalls": self.stalls,
                "stall_s": round(self.stall_s, 6),
                "recomputes": self.recomputes,
                "drops": self.drops,
                "spill_refusals": self.spill_refusals,
            }


@dataclass
class KvShipStats:
    """Replica-side counters for the disaggregated-serving KV ship
    surface (the ``batching.disagg`` block on ``/metrics``). Exports are
    ``/v1/kv/export`` frames served (a prefill-class replica's output);
    imports are ``/v1/kv/import`` frames registered in the radix tree.
    ``import_blocks_present`` counts blocks an import found already
    cached (the router's dedup missed, or two ships raced — the import
    is idempotent); ``imports_zero_copy`` vs ``imports_assembled``
    splits imports by how a later hit CONSUMES them: paged-mode imports
    land in arena pages (a hit is an ``acquire_pages`` refcount bump,
    zero copies), dense-mode imports are tree slices (a hit pays a
    ``concat_cache_blocks`` assembly). ``import_backpressure`` counts
    imports refused because the page arena was full — the priced-shed
    path the router's fallback-to-mixed rides.

    The ``*_stream``/``*_chunk`` counters cover the PIPELINED (chunked)
    ship: streamed exports/imports are the subset that rode the
    ``LKVS``/``LKVC`` frame stream, chunk counters are the wire frames
    flushed/received, and ``import_stream_aborts`` counts chunked
    imports that rolled their staged pages back (truncated stream,
    garbage chunk, dead relay) — an abort touches nothing, so it is a
    wasted transfer, never a corrupt tree."""

    exports: int = 0
    export_bytes: int = 0
    export_tokens: int = 0
    export_streams: int = 0
    export_chunks: int = 0
    imports: int = 0
    import_bytes: int = 0
    import_tokens: int = 0
    import_streams: int = 0
    import_chunks: int = 0
    import_stream_aborts: int = 0
    import_blocks_inserted: int = 0
    import_blocks_present: int = 0
    imports_zero_copy: int = 0
    imports_assembled: int = 0
    import_backpressure: int = 0
    import_rejected: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def record_export(self, *, tokens: int, nbytes: int,
                      chunks: int = 0) -> None:
        with self._lock:
            self.exports += 1
            self.export_tokens += int(tokens)
            self.export_bytes += int(nbytes)
            if chunks:
                self.export_streams += 1
                self.export_chunks += int(chunks)

    def record_import(self, *, tokens: int, nbytes: int, inserted: int,
                      present: int, mode: str, chunks: int = 0) -> None:
        with self._lock:
            self.imports += 1
            self.import_tokens += int(tokens)
            self.import_bytes += int(nbytes)
            self.import_blocks_inserted += int(inserted)
            self.import_blocks_present += int(present)
            if chunks:
                self.import_streams += 1
                self.import_chunks += int(chunks)
            if mode == "paged":
                self.imports_zero_copy += 1
            else:
                self.imports_assembled += 1

    def record_backpressure(self) -> None:
        with self._lock:
            self.import_backpressure += 1

    def record_rejected(self) -> None:
        with self._lock:
            self.import_rejected += 1

    def record_stream_abort(self) -> None:
        with self._lock:
            self.import_stream_aborts += 1

    def report(self) -> dict:
        with self._lock:
            return {
                "exports": self.exports,
                "export_bytes": self.export_bytes,
                "export_tokens": self.export_tokens,
                "export_streams": self.export_streams,
                "export_chunks": self.export_chunks,
                "imports": self.imports,
                "import_bytes": self.import_bytes,
                "import_tokens": self.import_tokens,
                "import_streams": self.import_streams,
                "import_chunks": self.import_chunks,
                "import_stream_aborts": self.import_stream_aborts,
                "import_blocks": {
                    "inserted": self.import_blocks_inserted,
                    "present": self.import_blocks_present,
                },
                "imports_zero_copy": self.imports_zero_copy,
                "imports_assembled": self.imports_assembled,
                "import_backpressure": self.import_backpressure,
                "import_rejected": self.import_rejected,
            }


@dataclass
class SessionStats:
    """Router-side counters for sticky multi-turn sessions — the
    ``fleet.sessions`` block on the fleet ``/metrics``.

    ``opened`` counts session ids first seen; ``sticky_hits`` turns that
    landed on their recorded home replica, ``sticky_misses`` pick
    attempts whose preferred home was unusable at pick time — a
    saturation spill (the home past the outstanding threshold), or the
    home vanishing between the sticky check and the pick. The turn
    still serves and re-homes; under retries/spill a single turn can
    count more than one miss, so hits/misses are attempt-level, not
    turn-level.
    ``failovers`` counts re-homings off a dead/drained home; ``reships``
    the subset whose whole-block KV head was successfully re-shipped to
    the new home (export from the old home → import on the new one), and
    ``reship_fallbacks`` keys the rest by reason — the common SIGKILL
    case is ``old_home_unreachable``: the KV died with the worker, so
    the new home's counted local re-prefill IS the recovery path.
    ``deletes`` counts explicit ``DELETE /v1/sessions/{id}`` closes.
    ``drain_reships`` counts PROACTIVE re-ships fired by a home
    replica's ``begin_drain`` (the session's pinned head moves to its
    rendezvous successor BEFORE the next turn arrives, so the turn
    after a rolling restart pays a sticky hit, not a failover
    re-prefill); their failures land in ``reship_fallbacks`` like
    turn-time ones. ``record_expiries`` counts sticky records swept by
    the router's idle TTL — replica-side pin leases expire on their
    own, and without the sweep the router's session gauge drifted
    arbitrarily far from the fleet's real pinned state (a chaos-soak
    find)."""

    opened: int = 0
    sticky_hits: int = 0
    sticky_misses: int = 0
    failovers: int = 0
    reships: int = 0
    drain_reships: int = 0
    deletes: int = 0
    record_expiries: int = 0
    reship_fallbacks: dict = field(default_factory=dict)  # reason -> n
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def count(self, counter: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, counter, getattr(self, counter) + n)

    def record_fallback(self, reason: str) -> None:
        with self._lock:
            self.reship_fallbacks[str(reason)] = \
                self.reship_fallbacks.get(str(reason), 0) + 1

    def report(self) -> dict:
        with self._lock:
            return {
                "opened": self.opened,
                "sticky_hits": self.sticky_hits,
                "sticky_misses": self.sticky_misses,
                "failovers": self.failovers,
                "reships": self.reships,
                "drain_reships": self.drain_reships,
                "deletes": self.deletes,
                "record_expiries": self.record_expiries,
                "reship_fallbacks": dict(self.reship_fallbacks),
            }


@dataclass
class DisaggStats:
    """Router-side counters for phase-split (disaggregated) serving —
    the ``fleet.disagg`` block on the fleet ``/metrics``.

    ``prefill_dispatches`` counts export legs that completed on a
    prefill-class replica; ``decode_dispatches`` counts full ships
    (export + import both landed, so the decode replica serves the
    request from shipped KV). ``ship_skips`` are requests whose prefix
    the router already shipped to that decode replica (the per-replica
    shipped-key LRU). ``fallbacks`` keys every path back to MIXED-mode
    local prefill by reason — a fallback is a slower request, never a
    lost one. The byte/latency EWMAs (alpha 0.2) price the transfer the
    way the page pool prices its backpressure.

    PIPELINED shipping: ``ships_pipelined`` counts ships that rode the
    chunked relay (export frames pumped to the import leg while later
    prefill chunks were still running), ``chunks_relayed`` the ``LKVC``
    frames pumped, and ``mid_stream_failures`` ships that died AFTER
    the stream opened (truncated export, dead import leg, injected
    ``kv_ship_chunk`` fault) — every one also lands in ``fallbacks``
    by reason, because a mid-stream death degrades to mixed-mode like
    any other ship failure.

    ``util`` is the per-replica-class busy-fraction EWMA (alpha 0.3)
    the router folds from pool occupancy at scrape time — the
    observability basis for sizing the prefill pool: a prefill class
    pinned near 1.0 while decode idles wants more prefill replicas
    (and vice versa)."""

    prefill_dispatches: int = 0
    decode_dispatches: int = 0
    ships: int = 0
    ships_pipelined: int = 0
    chunks_relayed: int = 0
    mid_stream_failures: int = 0
    ship_skips: int = 0
    ship_bytes_total: int = 0
    ship_bytes_ewma: float = 0.0
    ship_ms_ewma: float = 0.0
    import_blocks_inserted: int = 0
    import_blocks_present: int = 0
    imports_zero_copy: int = 0
    imports_assembled: int = 0
    fallbacks: dict = field(default_factory=dict)  # reason -> n
    util: dict = field(default_factory=dict)       # class -> busy EWMA
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def count(self, counter: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, counter, getattr(self, counter) + n)

    def record_fallback(self, reason: str) -> None:
        with self._lock:
            self.fallbacks[str(reason)] = \
                self.fallbacks.get(str(reason), 0) + 1

    def record_ship(self, *, nbytes: int, ms: float, chunks: int = 0,
                    pipelined: bool = False) -> None:
        with self._lock:
            self.ships += 1
            if chunks:
                self.chunks_relayed += int(chunks)
            if pipelined:
                # explicitly flagged, NOT inferred from chunks: the
                # blocking buffer-then-relay baseline ships chunk
                # frames too but overlaps nothing
                self.ships_pipelined += 1
            self.ship_bytes_total += int(nbytes)
            a = 0.2
            if self.ships == 1:
                self.ship_bytes_ewma = float(nbytes)
                self.ship_ms_ewma = float(ms)
            else:
                self.ship_bytes_ewma = ((1 - a) * self.ship_bytes_ewma
                                        + a * float(nbytes))
                self.ship_ms_ewma = ((1 - a) * self.ship_ms_ewma
                                     + a * float(ms))

    def record_util(self, cls: str, busy_frac: float) -> None:
        """Fold one busy-fraction sample (0..1) for a replica class
        into its EWMA — called by the router at scrape time from the
        pool's time-weighted occupancy accounting."""
        frac = min(1.0, max(0.0, float(busy_frac)))
        with self._lock:
            prev = self.util.get(str(cls))
            self.util[str(cls)] = (frac if prev is None
                                   else 0.7 * prev + 0.3 * frac)

    def record_import_result(self, *, inserted: int, present: int,
                             mode: str) -> None:
        with self._lock:
            self.import_blocks_inserted += int(inserted)
            self.import_blocks_present += int(present)
            if mode == "paged":
                self.imports_zero_copy += 1
            else:
                self.imports_assembled += 1

    def report(self) -> dict:
        with self._lock:
            return {
                "prefill_dispatches": self.prefill_dispatches,
                "decode_dispatches": self.decode_dispatches,
                "ships": self.ships,
                "ships_pipelined": self.ships_pipelined,
                "chunks_relayed": self.chunks_relayed,
                "mid_stream_failures": self.mid_stream_failures,
                "ship_skips": self.ship_skips,
                "ship_bytes_total": self.ship_bytes_total,
                "ship_bytes_ewma": round(self.ship_bytes_ewma, 1),
                "ship_ms_ewma": round(self.ship_ms_ewma, 3),
                "util": {cls: round(v, 4)
                         for cls, v in sorted(self.util.items())},
                "import_blocks": {
                    "inserted": self.import_blocks_inserted,
                    "present": self.import_blocks_present,
                },
                "imports_zero_copy": self.imports_zero_copy,
                "imports_assembled": self.imports_assembled,
                "fallbacks": dict(self.fallbacks),
            }




@dataclass
class RouterStats:
    """Counters for the fleet front-door (fleet/router.py), exported on
    the router's ``/metrics`` under ``router``. ``retries`` counts
    re-sends after a retryable failure (connection loss or a 429/503
    shed), ``failovers`` the subset caused by a dead connection;
    ``hedges``/``hedge_wins`` track duplicate sends for slow requests
    and how often the duplicate answered first. The ``affinity_*``
    counters measure prefix-affinity routing: a hit means the request
    reached its rendezvous-hash target; fallbacks record why it did not
    (target ejected/busy). ``latency`` is the router-observed end-to-end
    distribution — the P9x basis for the hedging threshold.

    The ``spill_*`` counters track the router's fleet-wide-overload
    parking lot (fleet/spill.py): ``spilled`` = requests parked at
    least once, ``spill_drained`` = grants back into the retry loop,
    ``spill_expired``/``spill_overflow`` = the queue's own sheds (the
    live depth/wait gauges ride on the spill queue's report in the
    router ``/metrics``). ``retry_budget_denied`` counts re-sends the
    fleet-wide retry budget refused; ``warmed_prefixes`` counts hot
    radix prefixes replayed into a readmitted/attached replica's
    cache."""

    requests: int = 0
    completed: int = 0
    errors: int = 0
    retries: int = 0
    failovers: int = 0
    hedges: int = 0
    hedge_wins: int = 0
    no_replica: int = 0
    spilled: int = 0
    spill_drained: int = 0
    spill_expired: int = 0
    spill_overflow: int = 0
    retry_budget_denied: int = 0
    warmed_prefixes: int = 0
    affinity_requests: int = 0
    affinity_hits: int = 0
    affinity_fallbacks: dict = field(default_factory=dict)  # reason -> n
    latency: LatencyStats = field(default_factory=LatencyStats)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def count(self, counter: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, counter, getattr(self, counter) + n)

    def count_affinity(self, outcome: str) -> None:
        """``outcome``: 'hit', or a fallback reason ('saturated',
        'ejected', ...). Every call is one affinity-keyed request."""
        with self._lock:
            self.affinity_requests += 1
            if outcome == "hit":
                self.affinity_hits += 1
            else:
                self.affinity_fallbacks[outcome] = \
                    self.affinity_fallbacks.get(outcome, 0) + 1

    def report(self) -> dict:
        with self._lock:
            aff = dict(self.affinity_fallbacks)
            out = {
                "requests": self.requests,
                "completed": self.completed,
                "errors": self.errors,
                "retries": self.retries,
                "failovers": self.failovers,
                "hedges": self.hedges,
                "hedge_wins": self.hedge_wins,
                "no_replica": self.no_replica,
                "spill": {
                    "spilled": self.spilled,
                    "drained": self.spill_drained,
                    "expired": self.spill_expired,
                    "overflow": self.spill_overflow,
                },
                "retry_budget_denied": self.retry_budget_denied,
                "warmed_prefixes": self.warmed_prefixes,
                "affinity": {
                    "requests": self.affinity_requests,
                    "hits": self.affinity_hits,
                    "hit_rate": (round(self.affinity_hits
                                       / self.affinity_requests, 4)
                                 if self.affinity_requests else 0.0),
                    "fallbacks": aff,
                },
            }
        out["latency"] = self.latency.report()
        return out


@dataclass
class ControllerStats:
    """Counters for the elastic fleet control loop
    (fleet/controller.py) — the ``fleet.controller`` block on the
    fleet ``/metrics``.

    ``actions`` counts APPLIED actions by kind (promote/demote/spawn/
    retire/set_knob); ``intents`` counts decisions that were logged but
    NOT applied — every decision in dry-run mode, plus live decisions
    whose actuator refused (e.g. a spawn with no spawner wired).
    ``last_decision`` is the most recent non-empty decision trace
    (tick time, the signal values that drove it, the rendered
    actions) so an operator can answer "why did the fleet just
    resize" from one scrape. ``targets`` echoes the loop's current
    goal posts (SLO, bands, dry_run) — the knobs the controller is
    steering TOWARD, as opposed to the per-replica knobs it steers."""

    ticks: int = 0
    errors: int = 0
    actions: dict = field(default_factory=dict)   # kind -> applied n
    intents: dict = field(default_factory=dict)   # kind -> logged-only n
    last_decision: dict = field(default_factory=dict)
    targets: dict = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def count(self, counter: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, counter, getattr(self, counter) + n)

    def record_action(self, kind: str, *, applied: bool) -> None:
        with self._lock:
            book = self.actions if applied else self.intents
            book[str(kind)] = book.get(str(kind), 0) + 1

    def record_decision(self, trace: dict) -> None:
        with self._lock:
            self.last_decision = dict(trace)

    def set_targets(self, **targets) -> None:
        with self._lock:
            self.targets.update(targets)

    def report(self) -> dict:
        with self._lock:
            return {
                "ticks": self.ticks,
                "errors": self.errors,
                "actions": dict(sorted(self.actions.items())),
                "intents": dict(sorted(self.intents.items())),
                "last_decision": dict(self.last_decision),
                "targets": dict(sorted(self.targets.items())),
            }
