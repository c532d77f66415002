"""Counters the port's serving engine reports under ``/metrics``: the
port's copies of ``PagePoolStats`` and ``PrefixCacheStats``
(``lambdipy_tpu/runtime/metrics.py``), ``PrefillStats`` cut to the
chunked walk, and the continuous engine's own counters (segments, decode
steps, joins, rows per step)."""

from __future__ import annotations

import threading
from dataclasses import dataclass, field


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
    alone on their request thread), ``requests_served``, and the decode
    programs' ``captures`` (CUDA graphs captured, reported as
    ``compile_count``), ``replays`` (steps run as a graph replay) and
    ``eager_steps`` (steps run eagerly), recorded through :meth:`record`
    by ``models/graphs.py StepProgram``."""

    segments: int = 0
    steps: int = 0
    rows_stepped: int = 0
    joins: int = 0
    prefix_joins: int = 0
    prefill_groups: int = 0
    rows_group_prefilled: int = 0
    row_prefills: int = 0
    requests_served: int = 0
    captures: int = 0
    replays: int = 0
    eager_steps: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def record(self, name: str, n: int = 1) -> None:
        """A decode program's event: ``captures``, ``replays`` or
        ``eager_steps``."""
        with self._lock:
            setattr(self, name, getattr(self, name) + int(n))

    def record_segment(self, steps: int, live_rows: int) -> None:
        with self._lock:
            self.segments += 1
            self.steps += int(steps)
            self.rows_stepped += int(steps) * int(live_rows)

    def record_group_prefill(self, rows: int) -> None:
        with self._lock:
            self.prefill_groups += 1
            self.rows_group_prefilled += int(rows)

    def record_row_prefill(self) -> None:
        with self._lock:
            self.row_prefills += 1

    def record_join(self) -> None:
        with self._lock:
            self.joins += 1

    def record_served(self) -> None:
        with self._lock:
            self.requests_served += 1

    def record_prefix_join(self) -> None:
        with self._lock:
            self.prefix_joins += 1

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
                    # forwards the engine ran: decode steps plus one per
                    # prefill (grouped or alone)
                    "forwards": (self.steps + self.prefill_groups
                                 + self.row_prefills),
                    "requests_served": self.requests_served,
                    "compile_count": self.captures,
                    "replays": self.replays,
                    "eager_steps": self.eager_steps}


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
    """The prefix store's cold walks (the JAX package's ``PrefillStats``,
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
