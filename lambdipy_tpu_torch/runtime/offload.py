"""Host-RAM offload arena for paged KV: the prefix store's spill tier.

The port's copy of ``lambdipy_tpu/runtime/offload.py`` up to its
``Prefetcher``. With ``kv_offload`` on, the prefix store's LRU sweep does
not drop a cold page: its K/V spills here, to host RAM, as kvwire bytes
(``runtime/kvwire.py``), and the node stays in the radix tree as a ghost;
a later hit re-onlines the page into the device arena in one batched
fetch instead of prefilling the range again.

- :class:`OffloadArena`, the spill store. One page spills as one
  ``LKVC``-shaped body under a leaf template derived once (the prefix
  store attaches it; ``template_encodes`` meters every derivation), and
  a batched fetch re-frames the stored bodies into one LKVS/LKVC stream
  decoded by ONE :class:`~lambdipy_tpu_torch.runtime.kvwire.StreamDecoder`
  pass, every wire validation applied before a tensor reaches the page
  write. :meth:`OffloadArena.frames` hands the stored pages to the export
  surfaces as wire frames.
- :class:`PageTemperature`, the LRU tick tracker a pool and its
  consumers share to pick spill victims.
- :class:`Prefetcher`, the per-row page state machine (RESIDENT /
  OFFLOADED / INFLIGHT) the long-context runner (``runtime/longctx.py``)
  drives from its decode cursor: pages it yields spill, the prefetch
  after a dispatch plans them back, the demand check before the next
  dispatch scores hits and misses.

Failure story: ``offload_stall`` is a ``runtime/faults.py`` site, checked
at every :meth:`OffloadArena.fetch_many`. A delay is a slow re-online; an
exception (or a key the arena dropped under budget pressure,
:class:`OffloadMiss`) makes the caller prefill the lost K/V again, counted
under ``kv_offload.recomputes``, never a wrong token.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Iterable

from lambdipy_tpu_torch.runtime.kvwire import (_leaf_template_of,
                                               decode_stream,
                                               encode_chunk_packed,
                                               encode_stream_header,
                                               pack_block_body)
from lambdipy_tpu_torch.runtime.metrics import KvOffloadStats


class OffloadMiss(KeyError):
    """A fetch asked for a key the arena does not hold (dropped under
    budget pressure, or never spilled). The caller's degradation path is
    prefill recompute — counted, never a wrong token."""


class PageTemperature:
    """Monotonic-tick LRU tracker: ``touch`` on every page use, and
    spill-victim selection asks for the coldest of a candidate set. A
    page never touched ranks coldest of all (tick 0) — fresh state must
    not shield a page from the sweep."""

    def __init__(self):
        self._ticks = itertools.count(1)
        self._last: dict[Any, int] = {}
        self._lock = threading.Lock()

    def touch(self, keys: Iterable[Any]) -> None:
        with self._lock:
            t = next(self._ticks)
            for k in keys:
                self._last[k] = t

    def forget(self, keys: Iterable[Any]) -> None:
        with self._lock:
            for k in keys:
                self._last.pop(k, None)

    def coldest(self, keys: Iterable[Any], n: int) -> list:
        """The ``n`` least-recently-touched of ``keys``, coldest first."""
        with self._lock:
            ranked = sorted(keys, key=lambda k: self._last.get(k, 0))
        return ranked[: max(0, int(n))]

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._last)


class OffloadArena:
    """Host-RAM page store keyed by caller-chosen ids.

    ``spill`` serializes one page's per-layer block slices into a single
    contiguous kvwire body under the CACHED leaf template (derived once,
    ``template_encodes``-counted); ``fetch_many`` re-frames any set of
    stored pages into one header + chunk stream and decodes it in one
    :class:`~lambdipy_tpu_torch.runtime.kvwire.StreamDecoder` pass. Budget is
    exact stored bytes: a spill past it is REFUSED (counted) and the
    caller drops the page instead — offload is an optimization of the
    degradation path, never a correctness dependency."""

    def __init__(self, *, page: int, layers: int, budget_mb: float = 256.0,
                 stats: KvOffloadStats | None = None, faults: Any = None):
        self.page = int(page)
        self.layers = int(layers)
        self.budget_bytes = max(0, int(float(budget_mb) * 2**20))
        self.stats = stats if stats is not None else KvOffloadStats()
        self.faults = faults  # FaultPlan | None; site "offload_stall"
        self._lock = threading.Lock()
        # key -> (tokens tuple, packed body bytes)
        self._entries: dict[Any, tuple[tuple, bytes]] = {}
        self._bytes = 0
        # leaf template, derived ONCE from the first spilled page (or
        # attached explicitly): [name, dtype, shape] rows + name order
        self._leaves: list | None = None
        self._names: list | None = None

    # -- template ------------------------------------------------------------

    def attach_template(self, leaves) -> None:
        """Install the wire leaf template up front (``[name, dtype name,
        shape]`` rows, e.g. from the prefix store's ``_leaf_template``)
        so even the FIRST spill skips array introspection."""
        self._leaves = [[str(n), str(d), [int(x) for x in s]]
                        for n, d, s in leaves]
        self._names = [n for n, _, _ in self._leaves]
        self.stats.record_template_encode()

    def _ensure_template(self, block) -> None:
        if self._leaves is None:
            self._leaves = _leaf_template_of(block)
            self._names = [n for n, _, _ in self._leaves]
            self.stats.record_template_encode()

    # -- spill ---------------------------------------------------------------

    def spill(self, key, tokens, block) -> bool:
        """Store one page (``block`` = per-layer leaf-dict list of host
        tensors shaped as ``models/llama.py arena_page_slices`` returns
        them; ``tokens`` its logical token ids). Returns False on budget
        refusal: the caller drops the page and counts the loss."""
        toks = tuple(int(t) for t in tokens)
        if len(toks) != self.page:
            raise ValueError(
                f"spill of {len(toks)} tokens into a {self.page}-token "
                f"page")
        self._ensure_template(block)
        body = pack_block_body([block], self._names)
        with self._lock:
            old = self._entries.get(key)
            new_bytes = self._bytes + len(body) \
                - (len(old[1]) if old else 0)
            if self.budget_bytes and new_bytes > self.budget_bytes:
                self.stats.record_spill_refusal()
                return False
            self._entries[key] = (toks, body)
            self._bytes = new_bytes
        self.stats.record_spill(1, len(body))
        return True

    # -- fetch ---------------------------------------------------------------

    def fetch_many(self, keys) -> list:
        """Batched re-online read: the stored bodies of ``keys``
        re-framed into ONE LKVS/LKVC stream (header bytes from the
        cached template — zero re-encode of live arrays) and decoded in
        one strictly-validating pass. Returns one block per key, in
        order. Raises :class:`OffloadMiss` for an absent key and
        whatever an armed ``offload_stall`` fault injects (the caller's
        recompute path)."""
        keys = list(keys)
        if not keys:
            return []
        if self.faults is not None:
            self.faults.check("offload_stall")
        with self._lock:
            entries = []
            for k in keys:
                e = self._entries.get(k)
                if e is None:
                    raise OffloadMiss(k)
                entries.append(e)
        tokens = [t for toks, _ in entries for t in toks]
        frames = [encode_stream_header(tokens, self.page, self.layers,
                                       self._leaves)]
        frames += [encode_chunk_packed(i, 1, body)
                   for i, (_, body) in enumerate(entries)]
        _, _, blocks = decode_stream(frames)
        self.stats.record_reonline(len(keys), batches=1, decodes=1)
        return blocks

    def frames(self, keys) -> list[bytes]:
        """The stored pages of ``keys`` as wire-ready LKVS/LKVC frames
        (header + one chunk per page) — the failover re-ship read: a
        partially-offloaded row ships its cold pages straight from host
        RAM, no device round trip."""
        keys = list(keys)
        with self._lock:
            entries = []
            for k in keys:
                e = self._entries.get(k)
                if e is None:
                    raise OffloadMiss(k)
                entries.append(e)
        tokens = [t for toks, _ in entries for t in toks]
        out = [encode_stream_header(tokens, self.page, self.layers,
                                    self._leaves)]
        out += [encode_chunk_packed(i, 1, body)
                for i, (_, body) in enumerate(entries)]
        return out

    # -- bookkeeping ---------------------------------------------------------

    def contains(self, key) -> bool:
        with self._lock:
            return key in self._entries

    def tokens_of(self, key) -> tuple:
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                raise OffloadMiss(key)
            return e[0]

    def drop(self, keys) -> int:
        dropped = 0
        with self._lock:
            for k in list(keys):
                e = self._entries.pop(k, None)
                if e is not None:
                    self._bytes -= len(e[1])
                    dropped += 1
        if dropped:
            self.stats.record_drop(dropped)
        return dropped

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def gauges(self) -> dict:
        with self._lock:
            return {"offloaded_pages": len(self._entries),
                    "offloaded_bytes": self._bytes,
                    "offload_budget_bytes": self.budget_bytes}

    def report(self) -> dict:
        """Gauges + counters — the ``kv.offload`` metrics block."""
        out = self.gauges()
        out.update(self.stats.report())
        return out


# Prefetcher page states: absent from the map = the page was never
# offloaded (always resident: not a prefetch hit, not a miss; only pages
# that LEFT the device count toward the hit rate).
OFFLOADED = "offloaded"
INFLIGHT = "inflight"
RESIDENT = "resident"


class Prefetcher:
    """Per-row page-residency state machine, keyed off the decode cursor
    (JAX ``offload.py:279-344``).

    The runner drives it: ``spill(keys)`` when a page yields to pressure;
    ``plan(upcoming)`` right AFTER dispatching a segment (the offloaded
    subset of the pages the next dispatch needs, marked inflight: the
    caller fetches them while the card is busy, then ``complete(keys)``);
    ``demand(needed)`` right BEFORE the next dispatch (counts hits, pages
    the prefetch brought home, against misses, which the caller must
    fetch now, stalling the dispatch)."""

    def __init__(self, stats: KvOffloadStats | None = None):
        self.stats = stats if stats is not None else KvOffloadStats()
        self._state: dict[Any, str] = {}

    def state(self, key) -> str:
        return self._state.get(key, RESIDENT)

    def spill(self, keys) -> None:
        for k in keys:
            self._state[k] = OFFLOADED

    def plan(self, upcoming) -> list:
        """Offloaded pages among ``upcoming``, marked inflight."""
        todo = [k for k in upcoming if self._state.get(k) == OFFLOADED]
        for k in todo:
            self._state[k] = INFLIGHT
        return todo

    def complete(self, keys) -> None:
        """Fetched-and-written pages come home resident."""
        for k in keys:
            if k in self._state:
                self._state[k] = RESIDENT

    def demand(self, needed) -> list:
        """Residency check at dispatch time: returns the keys still not
        resident (the caller fetches them now, a timed stall) and records
        the hit/miss split. A page that went offloaded and is resident
        again by demand time is a prefetch hit; a hit key leaves the
        tracker, so each spill scores at most one hit."""
        needed = list(needed)
        misses = [k for k in needed
                  if self._state.get(k) in (OFFLOADED, INFLIGHT)]
        hit_keys = [k for k in needed if self._state.get(k) == RESIDENT]
        self.stats.record_prefetch(len(hit_keys), len(misses))
        for k in hit_keys:
            del self._state[k]
        for k in misses:
            self._state[k] = INFLIGHT
        return misses

    def forget(self, keys) -> None:
        for k in keys:
            self._state.pop(k, None)

    def counts(self) -> dict:
        out = {OFFLOADED: 0, INFLIGHT: 0, RESIDENT: 0}
        for s in self._state.values():
            out[s] += 1
        return out
