"""Paged KV memory: a page allocator over one preallocated arena.

The port's copy of ``lambdipy_tpu/runtime/pagepool.py``, cut to what the
continuous engine uses:

- ONE arena per layer, ``[n_pages, page, kv_heads, head_dim]`` in the
  KV store layout (int8 + scales included), built lazily on the device
  by ``models/llama.py init_page_arena`` the first time the engine needs
  it.
- :class:`PagePool` is the host-side allocator: a LIFO free list,
  per-page refcounts and exact-bytes accounting. Admission charges
  ``ceil(tokens / page)`` pages, so capacity is bounded by the tokens
  rows actually hold, not by full windows.
- Page 0 is the reserved NULL page: block tables pad with it, retired
  slots point every entry at it, and writes past a row's pages land in
  it. Nothing reads the null page unmasked, so its garbage is harmless.
- Running out of pages is backpressure: :class:`PagesExhausted` carries
  a ``retry_after_s`` price, and ``runtime/server.py`` answers 503 +
  ``Retry-After`` (shed reason ``kv_pages``).
- The arena is a set of device tensors updated in place (the JAX arena
  is a functional value each program replaces), so no chain of arena
  versions needs ordering; ``arena_lock`` makes arena writes (prefill
  packing, decode steps) mutually exclusive between threads. A decode
  step captured as a CUDA graph holds the arena's addresses: the arena's
  ``generation`` rises whenever it is (re)built, and the engine drops its
  graphs when it sees a new one.

Not ported yet: fault injection (``faults``), the prefix store's
``reclaim_fn``/``pinned_fn`` hooks, host offload and ``reset_arena``.
"""

from __future__ import annotations

import threading
import time
from collections.abc import Callable
from typing import Any

from lambdipy_tpu_torch.runtime.metrics import PagePoolStats

NULL_PAGE = 0


class PagesExhausted(RuntimeError):
    """The arena has fewer free pages than an admission needs; the HTTP
    layer answers 503 + Retry-After (reason ``kv_pages``)."""

    def __init__(self, needed: int, free: int, retry_after_s: float = 1.0):
        self.needed = int(needed)
        self.free = int(free)
        self.retry_after_s = float(retry_after_s)
        super().__init__(
            f"KV page pool exhausted: need {needed} pages, {free} free "
            f"(retry in ~{self.retry_after_s:.1f}s)")


def page_width(max_len: int, block: int) -> int:
    """The page width for a requested block: the largest power of two
    <= the pow-2 bucket of ``block`` that divides ``max_len``, so every
    page starts at a page-aligned offset of the context window."""
    b = 1
    while b < max(1, int(block)):
        b *= 2
    while b > 1 and max_len % b:
        b //= 2
    return min(b, max_len)


class PagePool:
    """Host-side page allocator and owner of the device KV arena.

    ``make_arena`` builds the arena on first use (:meth:`ensure_arena`).
    ``page_bytes`` is the exact stored bytes of ONE page across all
    layers and leaves, the unit of every byte gauge. ``window_pages`` is
    what one full decode window costs (set by the engine)."""

    def __init__(self, *, n_pages: int, page: int, page_bytes: int,
                 make_arena: Callable[[], Any] | None = None,
                 window_pages: int | None = None):
        if n_pages < 2:
            raise ValueError("n_pages must be >= 2 (page 0 is reserved)")
        self.n_pages = int(n_pages)
        self.page = int(page)
        self.page_bytes = int(page_bytes)
        self.window_pages = max(1, int(window_pages or 1))
        self._make_arena = make_arena
        self.stats_counters = PagePoolStats()
        self._lock = threading.RLock()
        self.arena_lock = threading.RLock()
        self._arena = None
        # times the arena was built: graphs of an older one are stale
        self.generation = 0
        # LIFO free list: the most recently freed page is reused first
        self._free: list[int] = list(range(self.n_pages - 1, 0, -1))
        # page id -> refcount; the null page is permanently held
        self._refs: dict[int, int] = {NULL_PAGE: 1}
        # page id -> tokens actually stored in it (fragmentation gauge)
        self._tokens: dict[int, int] = {}
        # the most pages live at once since construction
        self._live_peak = 0
        # EWMA of seconds between page releases: the Retry-After price
        self._last_release_t: float | None = None
        self._release_gap_s = 0.25

    # -- arena ---------------------------------------------------------------

    @property
    def arena(self):
        return self._arena

    def ensure_arena(self):
        """Build the device arena on first use (idempotent)."""
        with self.arena_lock:
            if self._arena is None:
                if self._make_arena is None:
                    raise RuntimeError("pool has no arena factory")
                self._arena = self._make_arena()
                self.generation += 1
            return self._arena

    # -- allocation ----------------------------------------------------------

    @property
    def capacity_pages(self) -> int:
        """Allocatable pages (the null page excluded)."""
        return self.n_pages - 1

    def free_count(self) -> int:
        with self._lock:
            return len(self._free)

    def alloc(self, n: int, *, tokens: int = 0) -> list[int]:
        """Take ``n`` pages (refcount 1 each); ``tokens`` is how many KV
        positions the caller will store across them. Raises
        :class:`PagesExhausted` (and counts a shed) when fewer are
        free."""
        n = int(n)
        if n <= 0:
            return []
        with self._lock:
            if n > len(self._free):
                self.stats_counters.record_shed()
                raise PagesExhausted(n, len(self._free),
                                     self.retry_after_s(n))
            pids = [self._free.pop() for _ in range(n)]
            left = int(tokens)
            for pid in pids:
                self._refs[pid] = 1
                self._tokens[pid] = max(0, min(self.page, left))
                left -= self.page
            self._live_peak = max(self._live_peak, len(self._refs) - 1)
            self.stats_counters.record_alloc(n)
            return pids

    def retain(self, pids) -> None:
        """Refcount bump: a second holder shares the pages, no copy."""
        with self._lock:
            for pid in pids:
                if pid == NULL_PAGE:
                    continue
                if self._refs.get(pid, 0) <= 0:
                    raise ValueError(f"retain of unallocated page {pid}")
                self._refs[pid] += 1
            self.stats_counters.record_share(
                sum(1 for p in pids if p != NULL_PAGE))

    def release(self, pids) -> None:
        """Drop one ref per page; pages reaching zero return to the free
        list. A double free raises: refcount corruption under a shared
        arena must never pass silently."""
        freed = 0
        with self._lock:
            for pid in pids:
                if pid == NULL_PAGE:
                    continue
                refs = self._refs.get(pid, 0)
                if refs <= 0:
                    raise ValueError(f"double free of page {pid}")
                if refs == 1:
                    del self._refs[pid]
                    self._tokens.pop(pid, None)
                    self._free.append(pid)
                    freed += 1
                else:
                    self._refs[pid] = refs - 1
            self.stats_counters.record_release(freed)
            if freed:
                now = time.monotonic()
                if self._last_release_t is not None:
                    gap = (now - self._last_release_t) / freed
                    self._release_gap_s = (0.8 * self._release_gap_s
                                           + 0.2 * min(gap, 30.0))
                self._last_release_t = now

    def refcount(self, pid: int) -> int:
        """Current refcount of one page (0 = free)."""
        with self._lock:
            return self._refs.get(pid, 0)

    def retry_after_s(self, needed: int = 1) -> float:
        """Backpressure price: pages free at about the recent release
        cadence, so ``needed`` pages should exist in ``needed * gap``
        seconds (clamped to 0.5-30 s)."""
        return max(0.5, min(30.0, float(needed) * self._release_gap_s))

    # -- observability / invariants ------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            live = [p for p in self._refs if p != NULL_PAGE]
            shared = [p for p in live if self._refs[p] > 1]
            hist: dict[str, int] = {}
            for p in live:
                key = str(self._refs[p])
                hist[key] = hist.get(key, 0) + 1
            used_tokens = sum(self._tokens.get(p, 0) for p in live)
            free = len(self._free)
            out = {
                "page_tokens": self.page,
                "page_bytes": self.page_bytes,
                "pages_total": self.capacity_pages,
                "pages_free": free,
                "pages_live": len(live),
                "pages_shared": len(shared),
                "bytes_total": self.capacity_pages * self.page_bytes,
                "bytes_free": free * self.page_bytes,
                "bytes_live": len(live) * self.page_bytes,
                # allocated-but-empty token slots / allocated slots
                "internal_fragmentation": (
                    round(1.0 - used_tokens / (len(live) * self.page), 4)
                    if live else 0.0),
                "refcount_histogram": hist,
                "max_refcount": max((self._refs[p] for p in live),
                                    default=0),
                # full-window rows admissible now vs what a
                # window-per-slot allocator could hold in the same bytes
                "capacity_rows_now": free // self.window_pages,
                "window_bound_rows": (self.capacity_pages
                                      // self.window_pages),
                "retry_after_s": round(self.retry_after_s(), 3),
                "pages_live_peak": self._live_peak,
            }
        out.update(self.stats_counters.report())
        return out

    def check_invariants(self) -> None:
        """Every page is free XOR live exactly once, refcounts are
        positive, and free + live pages cover the arena."""
        with self._lock:
            free = set(self._free)
            live = {p for p in self._refs if p != NULL_PAGE}
            assert len(free) == len(self._free), "free list has duplicates"
            assert not (free & live), f"pages both free and live: {free & live}"
            assert free | live | {NULL_PAGE} == set(range(self.n_pages)), \
                "pages leaked out of the arena"
            assert all(r > 0 for r in self._refs.values()), \
                "non-positive refcount"
            assert len(free) + len(live) == self.capacity_pages
