"""Automatic cross-request prefix KV cache: radix reuse for the serve path.

The port's twin of ``lambdipy_tpu/runtime/prefixstore.py``, cut to its
core. Generate traffic shares prompt heads (system prompts, few-shot
templates, multi-turn history); without a cache every request prefills
its whole prompt. :class:`PrefixStore` makes reuse automatic, in the
style of SGLang's RadixAttention and vLLM's automatic prefix caching:

- A RADIX TREE keyed by fixed-width token blocks. A node at depth d holds
  the K/V of its own block at positions ``[d * block, (d + 1) * block)``
  (store layout: float, or int8 + scales under ``kv_quant``); K/V is
  position-dependent (RoPE comes before the cache store), so depth pins
  position.
- :meth:`PrefixStore.route` longest-prefix-matches a prompt against the
  tree in whole blocks, capped so that at least one suffix token remains
  to select from. Dense mode assembles the matched blocks into a
  full-window cache (``models/llama.py concat_cache_blocks``) and
  registers it in the server's prefix LRU, so every ``prefix=`` path
  (solo, streamed, the continuous engine's join) serves the suffix-only
  continuation unchanged.
- Unmatched whole blocks prefill HERE, through the server's fixed-width
  chunk functions (``_prefix_first_fn`` / ``_prefix_ext_fn``, captured
  programs on the card) in a one-row window checked out of the server's
  program cache for the whole walk, and go into the tree: the request's
  own prefill is the insertion. Concurrent first requests for one target
  collapse to one walk; walks of other targets get windows of their
  own.
- A device-memory budget bounds the tree: block bytes are counted from
  the stored leaves, and inserts past the budget evict least-recently
  used LEAF nodes (an interior node's K/V is position-prefixed by its
  parents). Counters: ``runtime/metrics.py PrefixCacheStats``, under
  ``/metrics`` as ``handler.prefix_cache``.

With the float KV cache a routed request's tokens are the unrouted ones:
the continuation attends the same masked K/V the whole prompt's prefill
would have written (``tests/test_torch_prefixstore.py``, bitwise on the
CPU). Under ``kv_quant`` the cached prefix reads back quantized, so the
handler keeps automatic reuse opt-in there.

PAGED mode (``pool=`` a ``runtime/pagepool.py PagePool``): nodes hold
arena PAGE IDS, since a radix block IS a page. A hit costs a refcount
bump per page (:meth:`PrefixStore.acquire_pages`): no assembly, no
registered full-window duplicate (``assembly_bytes_peak`` stays 0). A
cold walk runs the same chunk functions in its window and writes each
new block into a page of its own; eviction is
refcount-aware (a page a live row shares stays).

SESSION PINS (multi-turn chat): a session id attached to a request pins
the conversation's radix path. Pinned nodes are left out of the LRU
budget sweep and of the cold-page reclaim, so an open conversation's K/V
survives cache pressure and every later turn matches its whole history.
Pins are leases: an absolute TTL from the session's creation and an idle
timeout renewed every turn; lapsed sessions release lazily on the next
locked store operation (``stats()`` included). Pinned bytes are capped
by ``pin_budget_mb`` (clamped to the cache budget): a NEW session past
it raises :class:`SessionPinsExceeded`, which the HTTP layer answers as a
priced 503 (``session_pins``) with Retry-After at the earliest lease
expiry. The port's arena is never reset (the engine keeps it through a
failure, a wedge included), so no failure invalidates a pin; JAX drops
every pin with its arena.

HOST OFFLOAD (paged mode, :meth:`PrefixStore.attach_offload`): the sweep
spills a victim's page to a ``runtime/offload.py OffloadArena`` as kvwire
bytes instead of dropping it; the node stays in the tree as a ghost, and
a later hit re-onlines every ghost of its path in one batched fetch, one
allocation and one page write. A failed re-online (an ``offload_stall``
fault, an entry the arena dropped) prunes the ghosts and the range is
walked again, counted as a recompute.

KV SHIP (``runtime/kvwire.py``): :meth:`PrefixStore.export_blocks` hands
a prompt head's whole blocks out as host tensors (walking the missing
ones first), :meth:`PrefixStore.import_blocks` takes shipped blocks in as
a radix insert (paged: one page each, a strict allocation whose
:class:`PagesExhausted` propagates), and the streamed pair
(:meth:`PrefixStore.export_stream`, :class:`KvStreamImport`) does the same
block group by block group, the tree untouched until a complete stream
commits. Every host read of a page holds a pool ref on it and is ordered
on the serving stream (``models/llama.py arena_page_slices``).

Every failure path FAILS OPEN: a store error logs and the request serves
unrouted. The ``prefix_walk`` fault site (``runtime/faults.py``, the
handler's live plan) fires once per chunk dispatch of a cold walk, the
``session_pin`` site once per pin.

Each chunk of a walk takes the device lock alone, like a prefill, so the
continuous engine's segments interleave with a long walk. Lock order:
the store's lock, then ``DEVICE_LOCK``, then the pool's arena lock. Not
ported yet (ROADMAP): the sequence-parallel walk.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from typing import Any

import numpy as np
import torch

from lambdipy_tpu_torch.models.graphs import DEVICE_LOCK
from lambdipy_tpu_torch.models.llama import (_empty_cache_entry,
                                             blocks_to_host, cache_nbytes,
                                             concat_cache_blocks,
                                             arena_page_slices,
                                             slice_cache_blocks,
                                             write_arena_pages)
from lambdipy_tpu_torch.runtime.kvwire import dtype_name
from lambdipy_tpu_torch.runtime.metrics import (PrefillStats,
                                                PrefixCacheStats)
from lambdipy_tpu_torch.runtime.offload import OffloadMiss
from lambdipy_tpu_torch.runtime.pagepool import PagesExhausted, page_width

log = logging.getLogger("lambdipy_tpu_torch.prefixstore")


class SessionPinsExceeded(RuntimeError):
    """Pinning this session's head would push the pinned bytes past
    ``pin_budget_mb``. The HTTP layer answers a priced 503 (reason
    ``session_pins``); ``retry_after_s`` is the earliest lease expiry,
    when the next pinned session can lapse and free budget."""

    def __init__(self, needed: int, budget: int, retry_after_s: float):
        self.needed = int(needed)
        self.budget = int(budget)
        self.retry_after_s = float(retry_after_s)
        super().__init__(
            f"session pin budget exhausted: pinning needs {needed} more "
            f"bytes of a {budget}-byte budget (retry in "
            f"~{self.retry_after_s:.1f}s)")


class _Session:
    """One live conversation's pin lease: the pinned path nodes, the
    idle-renewed expiry, the absolute deadline (created + ttl) and the
    effective idle window (the store's, tightened by the client's
    ``session_ttl_s``; a renewal never widens it again)."""

    __slots__ = ("nodes", "expires", "deadline", "idle", "turns")

    def __init__(self, deadline: float, idle: float):
        self.nodes: list = []
        self.expires = 0.0
        self.deadline = deadline
        self.idle = idle
        self.turns = 0


class _Node:
    """One block of a cached prefix: ``kv`` is the per-layer store-layout
    slice list of this block's positions (dense mode), or ``page_id``
    names the arena page that holds them (paged mode; the store owns one
    pool ref per node). ``pins`` counts the live sessions holding the
    node (a pinned node is left out of every sweep); ``off_key`` names
    the block's bytes in the offload arena when its page was spilled
    (``page_id`` is None then)."""

    __slots__ = ("parent", "token_key", "children", "kv", "nbytes",
                 "last_used", "page_id", "pins", "off_key")

    def __init__(self, parent, token_key, kv=None, nbytes=0, page_id=None):
        self.parent = parent
        self.token_key = token_key  # tuple of this block's tokens
        self.children: dict[tuple, _Node] = {}
        self.kv = kv
        self.nbytes = nbytes
        self.last_used = 0
        self.page_id = page_id
        self.pins = 0
        self.off_key = None


class PrefixStore:
    """Radix-tree prefix KV store over a ``LlamaServer``."""

    def __init__(self, server: Any, *, block: int = 32,
                 budget_mb: float = 512.0, pool: Any = None,
                 prefill_stats: PrefillStats | None = None,
                 faults: Any = None, pin_budget_mb: float | None = None,
                 session_ttl_s: float = 3600.0,
                 session_idle_s: float = 600.0):
        self.server = server
        # FaultPlan | None: site "prefix_walk" fires once per cold-walk
        # chunk dispatch (an exception fails the walk open: route serves
        # the request unrouted), "session_pin" once per pin (fails open)
        self.faults = faults
        cfg = server.model.cfg
        self.pool = pool
        if pool is not None:
            # the pool's page width was fitted to the engine window; the
            # tree keys by the same width, so a block is a page
            self.block = int(pool.page)
        else:
            # a pow-2 block that divides the window: no block write
            # crosses max_len
            self.block = page_width(cfg.max_len, block)
        # cold walks dispatch in chunks wider than a block (the blocks are
        # cut from the walk's cache either way): the server's
        # prefill_chunk when it is a multiple of the block, else 256
        # tokens; the widest pow-2 width that divides the window;
        # block-wide chunks finish it
        ck = server.prefill_chunk
        if ck and ck % self.block == 0:
            wide = ck
        else:
            wide = max(self.block, min(256, cfg.max_len))
        while wide > self.block and cfg.max_len % wide:
            wide //= 2
        self.walk_chunk = wide
        self.budget_bytes = max(0, int(float(budget_mb) * 2**20))
        self.stats_counters = PrefixCacheStats()
        self.prefill_stats = prefill_stats or PrefillStats()
        self._root = _Node(None, None)
        # reentrant: in paged mode the pool's reclaim hook re-enters
        # through the store's own page allocation
        self._lock = threading.RLock()
        # the arena generation this tree's pages were written against
        self._arena_gen = pool.generation if pool is not None else 0
        if pool is not None:
            # admission must never starve behind a cold cache: a short
            # alloc evicts this store's unshared LRU pages first
            pool.reclaim_fn = self.reclaim_pages
        # the host offload tier (runtime/offload.py), wired after
        # construction by attach_offload
        self.offload: Any = None
        self._leaf_tmpl: dict | None = None
        self._clock = itertools.count(1)
        # target-path key -> Event: concurrent cold requests for one
        # prefix wait for one walk
        self._inflight: dict[str, threading.Event] = {}
        # -- session pins --------------------------------------------------
        # default: half the cache budget; an explicit budget is clamped to
        # the cache budget, so pins can never hold the whole cache (or
        # arena) out of eviction's reach
        self.pin_budget_bytes = int(
            min(float(pin_budget_mb) * 2**20, self.budget_bytes)
            if pin_budget_mb is not None
            else self.budget_bytes // 2)
        self.session_ttl_s = max(1.0, float(session_ttl_s))
        self.session_idle_s = max(1.0, float(session_idle_s))
        self._sessions: dict[str, _Session] = {}
        self._pinned_bytes = 0
        self._pinned_leaves = 0
        self.pin_sheds = 0          # NEW sessions refused on budget (503)
        self.pin_overflows = 0      # renewals that could not extend
        self.pin_expiries = 0       # sessions lapsed by TTL or idle lease
        self.pin_invalidations = 0  # sessions dropped with a rebuilt arena
        self.pin_faults = 0         # injected session_pin faults (open)
        if pool is not None:
            # pinned pages report beside the pool's refcount gauges
            pool.pinned_fn = self._pool_pin_gauges

    def attach_offload(self, offload: Any) -> None:
        """Wire a host offload tier (``runtime/offload.py OffloadArena``)
        into the paged store: the sweep SPILLS cold unshared pages to host
        RAM instead of dropping them, and a hit re-onlines spilled blocks
        in one batched fetch. The leaf template is attached here, once,
        from the store layout."""
        if self.pool is None:
            raise ValueError("KV offload requires paged mode (pool=)")
        offload.attach_template(
            [[name, dtype_name(dt), list(shape)]
             for name, (shape, dt) in sorted(self._leaf_template().items())])
        self.offload = offload
        self.pool.attach_offload(offload)

    @staticmethod
    def _node_key(node: _Node) -> tuple:
        """Offload-arena key of a node: the full token path from the root
        (K/V is position-dependent, so one block's tokens at two depths
        are two entries)."""
        parts = []
        while node is not None and node.token_key is not None:
            parts.append(node.token_key)
            node = node.parent
        return tuple(t for key in reversed(parts) for t in key)

    # -- host-side matching --------------------------------------------------

    def _target_len(self, n_tokens: int) -> int:
        """Largest cacheable block-aligned prefix of an n-token prompt: at
        least one token must remain as suffix (the continuation selects
        the first output token from it)."""
        return ((n_tokens - 1) // self.block) * self.block

    def match_len(self, tokens) -> int:
        """Host-only longest-prefix match in whole blocks (no device work,
        no mutation beyond LRU bookkeeping)."""
        try:
            row = [int(t) for t in tokens]
        except (TypeError, ValueError):
            return 0
        with self._lock:
            return self._match_locked(row)[0]

    def _maybe_flush_stale_locked(self) -> None:
        """Paged mode, under the store lock: if the pool's arena was
        (re)built since this tree's pages were written, drop the whole
        tree; its refs release now."""
        if self.pool is None or self._arena_gen == self.pool.generation:
            return
        self._arena_gen = self.pool.generation
        dead_keys = []
        for node in list(self._iter_nodes()):
            if node.page_id is not None:
                self.pool.release([node.page_id])
                self.stats_counters.record_evict(1, node.nbytes)
                node.page_id = None
            if node.off_key is not None:
                dead_keys.append(node.off_key)
                node.off_key = None
            node.pins = 0
        if dead_keys and self.offload is not None:
            self.offload.drop(dead_keys)
        if self._sessions:
            self.pin_invalidations += len(self._sessions)
            self._sessions.clear()
        self._pinned_bytes = 0
        self._pinned_leaves = 0
        if self._root.children:
            log.info("prefix store flushed: the page arena was rebuilt")
        self._root.children = {}

    def _match_locked(self, row: list) -> tuple[int, list]:
        """(matched token count, path nodes) under the store lock."""
        self._maybe_flush_stale_locked()
        cap = self._target_len(len(row))
        m, node, path = 0, self._root, []
        while m < cap:
            child = node.children.get(tuple(row[m:m + self.block]))
            if child is None:
                break
            child.last_used = next(self._clock)
            path.append(child)
            node = child
            m += self.block
        return m, path

    # -- the routing entry point ---------------------------------------------

    def route(self, row) -> int:
        """Match, extend and register for one single-row prompt. Returns
        the block-aligned prefix length the request should run with
        (``prefix=row[:m]``, the prompt its suffix), or 0 when the prompt
        is too short to cache or the store failed (serve unrouted).

        A cold prompt is not a no-op: its unmatched whole blocks prefill
        here (work that replaces the prefill the request would have paid)
        and go into the tree."""
        row = [int(t) for t in row]
        cfg = self.server.model.cfg
        if len(row) > cfg.max_len:
            # the request itself cannot be served; a walk would burn a
            # window of prefill and evict hot entries for nothing
            return 0
        # the clamp keeps every block write inside the window (JAX clamps
        # a crossing write back onto real K/V; here it would raise)
        target = min(self._target_len(len(row)), cfg.max_len - self.block)
        if target <= 0:
            return 0  # a sub-block prompt can never hit: not counted
        with self._lock:
            matched, path = self._match_locked(row)
            if self.pool is not None:
                # spilled blocks of the path re-online here, or (a failed
                # re-online pruned them) the walk below prefills the
                # range again
                ghosts = [n for n in path[:target // self.block]
                          if n.page_id is None]
                if ghosts and not self._reonline_locked(ghosts):
                    matched, path = self._match_locked(row)
        self.stats_counters.record_request(matched)
        try:
            if matched >= target:
                if self.pool is None:
                    self._ensure_assembled(row, path[:target // self.block])
                # paged full hit: the pages are in the arena and the engine
                # takes them by refcount bump (acquire_pages)
            else:
                self._extend(row, target)
            return target
        except Exception as e:  # noqa: BLE001 — fail open, serve unrouted
            log.error("prefix store routing failed (serving without "
                      "reuse): %s", e)
            return 0

    def acquire_pages(self, tokens):
        """Paged-mode hit handout: a block-aligned prefix resolved to its
        arena pages with one pool ref taken per page for the caller (the
        row shares the store's pages; its release is a refcount drop).
        Returns ``(page_ids, prefix_len)``, or None when a block is
        missing (evicted since routing, or an explicit prefix that never
        walked this tree): the caller then serves solo. The refs are taken
        under the store lock, so no sweep releases a page between the
        match and the bump. Spilled blocks re-online first
        (:meth:`_reonline_locked`); a failed re-online returns None."""
        if self.pool is None:
            return None
        try:
            row = [int(t) for t in tokens]
        except (TypeError, ValueError):
            return None
        if not row or len(row) % self.block:
            return None
        with self._lock:
            self._maybe_flush_stale_locked()
            node, m, path = self._root, 0, []
            while m < len(row):
                child = node.children.get(tuple(row[m:m + self.block]))
                if child is None or (child.page_id is None
                                     and child.off_key is None):
                    return None
                child.last_used = next(self._clock)
                path.append(child)
                node = child
                m += self.block
            missing = [n for n in path if n.page_id is None]
            # the resident pages are retained first: the re-online's
            # allocation may run the reclaim sweep, and a refcount of 2
            # keeps the sweep off the path being handed out
            resident = [n.page_id for n in path if n.page_id is not None]
            self.pool.retain(resident)
            if missing and not self._reonline_locked(missing):
                self.pool.release(resident)
                return None
            self.pool.retain([n.page_id for n in missing])
            pids = [n.page_id for n in path]
        return pids, m

    def _reonline_locked(self, nodes: list) -> bool:
        """Bring spilled blocks back into the arena, under the store lock:
        ONE batched fetch (one frame decode), one allocation, one page
        write per leaf under ``DEVICE_LOCK`` and the arena lock, guarded
        by the arena's generation. On success every node holds a fresh
        page (the store's ref) and its offload entry is dropped. A failed
        fetch (an ``offload_stall`` fault, an entry the arena no longer
        holds) prunes the ghosts from the shallowest down, so the range
        walks again; every failure is counted as a recompute and returns
        False with nothing leaked."""
        pool = self.pool
        stats = getattr(self.offload, "stats", None)
        keys = [n.off_key for n in nodes]
        if self.offload is None or any(k is None for k in keys):
            return False
        try:
            blocks = self.offload.fetch_many(keys)
        except Exception as e:  # noqa: BLE001 — recompute, never serve stale
            # the nodes come in path order: the first is the shallowest,
            # and its subtree holds every deeper ghost
            log.error("page re-online failed (%s; the range walks again): "
                      "%s", "entry missing" if isinstance(e, OffloadMiss)
                      else "fetch failed", e)
            self._prune_subtree_locked(nodes[0])
            if stats is not None:
                stats.record_recompute(len(keys))
            return False
        try:
            pids = pool.alloc(len(nodes), tokens=len(nodes) * self.block,
                              record_shed=False)
        except PagesExhausted:
            if stats is not None:
                stats.record_recompute(len(keys))
            return False
        try:
            with DEVICE_LOCK, pool.arena_lock, torch.inference_mode():
                arena = pool.ensure_arena()
                if pool.generation != self._arena_gen:
                    # the arena was rebuilt: the flush sweep cleans up
                    pool.release(pids)
                    return False
                write_arena_pages(arena, pids, blocks)
        except Exception as e:  # noqa: BLE001 — a failed write leaks nothing
            log.error("page re-online write failed: %s", e)
            pool.release(pids)
            if stats is not None:
                stats.record_recompute(len(keys))
            return False
        for node, pid in zip(nodes, pids):
            node.page_id = pid
            node.off_key = None
            self.stats_counters.record_insert(1, node.nbytes)
        self.offload.drop(keys)
        return True

    # -- session pins (multi-turn chat) --------------------------------------

    def _unpin_locked(self, nodes) -> None:
        for n in nodes:
            if n.pins <= 0:
                continue  # already cleared by a flush or a prune
            n.pins -= 1
            if n.pins == 0:
                self._pinned_bytes -= n.nbytes
                self._pinned_leaves -= 1

    def _expire_sessions_locked(self, now: float) -> None:
        """Lapse sessions past their idle lease or absolute TTL, lazily:
        every pin and stats path calls it, so a ``/metrics`` scrape alone
        brings the pin accounting to zero once sessions go quiet."""
        for sid in [s for s, sess in self._sessions.items()
                    if now >= sess.expires or now >= sess.deadline]:
            self._unpin_locked(self._sessions.pop(sid).nodes)
            self.pin_expiries += 1
            log.info("session %s lease expired: pins released", sid[:16])

    def _lease_horizon_locked(self, now: float) -> float:
        """Seconds until the next pinned session can lapse: the
        Retry-After of a budget shed."""
        horizon = [min(s.expires, s.deadline) - now
                   for s in self._sessions.values()]
        return max(1.0, min(horizon)) if horizon else 1.0

    def pin_session(self, session_id: str, tokens, *,
                    ttl_s: float | None = None) -> int:
        """Pin (or renew) ``session_id`` on the whole-block head of
        ``tokens``, after :meth:`route` walked it. Pinned nodes stay out of
        the LRU sweep and the cold-page reclaim until the session ends
        (:meth:`end_session`) or its lease lapses. Each turn re-pins the
        (longer) head and renews the idle lease; ``ttl_s`` may tighten the
        idle lease (a client asks for less retention, never more; it
        sticks for the session's life). Returns the pinned token count.

        Past the budget, a NEW session raises :class:`SessionPinsExceeded`
        (nothing changes; the turn is shed and retried after the lease
        horizon), while an EXISTING one keeps the pins it holds, renews
        and serves (``pin_overflows``): a turn is never refused over
        retention. An armed ``session_pin`` fault fails open: the turn
        serves unpinned, counted in ``pin_faults``."""
        if self.faults is not None:
            try:
                self.faults.check("session_pin")
            except Exception as e:  # noqa: BLE001 — injected: fail OPEN
                with self._lock:
                    self.pin_faults += 1
                log.error("session pin failed open (turn serves "
                          "unpinned): %s", e)
                return 0
        try:
            row = [int(t) for t in tokens]
        except (TypeError, ValueError):
            return 0
        sid = str(session_id)
        cfg = self.server.model.cfg
        target = min(self._target_len(len(row)), cfg.max_len - self.block)
        idle = self.session_idle_s
        if ttl_s is not None and float(ttl_s) > 0:
            idle = min(idle, float(ttl_s))
        now = time.monotonic()
        with self._lock:
            self._maybe_flush_stale_locked()
            self._expire_sessions_locked(now)
            path: list = []
            if target > 0:
                _, path = self._present_locked(row[:target])
            sess = self._sessions.get(sid)
            if sess is not None:
                # applied before any overflow return, so a tightening sent
                # while the budget is full still lands
                sess.idle = min(sess.idle, idle)
            held = set(id(n) for n in sess.nodes) if sess else set()
            fresh = [n for n in path if n.pins == 0 and id(n) not in held]
            need = sum(n.nbytes for n in fresh)
            if self._pinned_bytes + need > self.pin_budget_bytes:
                if sess is None:
                    self.pin_sheds += 1
                    raise SessionPinsExceeded(
                        self._pinned_bytes + need - self.pin_budget_bytes,
                        self.pin_budget_bytes,
                        self._lease_horizon_locked(now))
                self.pin_overflows += 1
                sess.expires = now + sess.idle
                sess.turns += 1
                return len(sess.nodes) * self.block
            if sess is None:
                sess = _Session(deadline=now + self.session_ttl_s, idle=idle)
                self._sessions[sid] = sess
            for n in path:
                if id(n) not in held:
                    n.pins += 1
                    if n.pins == 1:
                        self._pinned_bytes += n.nbytes
                        self._pinned_leaves += 1
            # a turn extends the previous head; nodes off the new path
            # (the client changed conversations under one id) unpin
            new_ids = set(id(n) for n in path)
            self._unpin_locked([n for n in sess.nodes
                                if id(n) not in new_ids])
            sess.nodes = path
            sess.expires = now + sess.idle
            sess.turns += 1
            return len(path) * self.block

    def touch_session(self, session_id: str) -> bool:
        """Renew a session's idle lease without walking its head (routing
        stood down). False: unknown or already lapsed."""
        now = time.monotonic()
        with self._lock:
            self._expire_sessions_locked(now)
            sess = self._sessions.get(str(session_id))
            if sess is None:
                return False
            sess.expires = now + sess.idle
            return True

    def end_session(self, session_id: str) -> dict:
        """Explicit close (``DELETE /v1/sessions/{id}``): release the
        session's pins now."""
        with self._lock:
            self._expire_sessions_locked(time.monotonic())
            sess = self._sessions.pop(str(session_id), None)
            if sess is None:
                return {"released": False, "pinned_leaves": 0}
            n = len(sess.nodes)
            self._unpin_locked(sess.nodes)
            return {"released": True, "pinned_leaves": n}

    def _pool_pin_gauges(self) -> dict:
        """The page pool's view of session pins: each pinned leaf holds
        one arena page the reclaim sweep may not touch."""
        with self._lock:
            return {"pinned_pages": self._pinned_leaves,
                    "pinned_bytes": self._pinned_bytes,
                    "pin_budget_bytes": self.pin_budget_bytes,
                    "pin_sheds": self.pin_sheds}

    def present_len(self, tokens) -> int:
        """Host-only: tokens of the whole-block head whose blocks are all
        present (dense K/V, a live page or a spilled one): the
        ``/v1/kv/probe`` answer."""
        try:
            row = [int(t) for t in tokens]
        except (TypeError, ValueError):
            return 0
        head = row[:(len(row) // self.block) * self.block]
        if not head:
            return 0
        with self._lock:
            self._maybe_flush_stale_locked()
            return self._present_locked(head)[0]

    # -- KV export and import -----------------------------------------------

    def _present_locked(self, row: list) -> tuple[int, list]:
        """Longest prefix of a block-aligned ``row`` whose blocks are all
        present (dense K/V, a live page, or a spilled page whose bytes the
        offload arena holds), with its path nodes. Unlike
        :meth:`_match_locked` it does not stop a block short: the ship
        surfaces take the whole head."""
        node, m, path = self._root, 0, []
        while m < len(row):
            child = node.children.get(tuple(row[m:m + self.block]))
            if child is None or ((child.page_id is None
                                  and child.off_key is None)
                                 if self.pool is not None
                                 else child.kv is None):
                break
            child.last_used = next(self._clock)
            path.append(child)
            node = child
            m += self.block
        return m, path

    def _leaf_template(self) -> dict:
        """name -> (shape, torch dtype) of one block in this server's
        store layout, what an import must match exactly (computed once)."""
        if self._leaf_tmpl is None:
            entry = _empty_cache_entry(self.server.model.cfg, 1, self.block,
                                       "cpu")
            self._leaf_tmpl = {name: (tuple(int(d) for d in val.shape),
                                      val.dtype)
                               for name, val in entry.items()}
        return self._leaf_tmpl

    def _read_blocks(self, pids: list, offs: list) -> list:
        """Host blocks of a path's pages, in order: resident pages in one
        ordered read, spilled ones from the offload arena (read only, they
        stay spilled); truncated at the first block that cannot be read.
        The caller holds a pool ref on every resident page."""
        fetched = self._fetch_offloaded(
            [k for p, k in zip(pids, offs) if p is None and k is not None])
        resident = [p for p in pids if p is not None]
        with DEVICE_LOCK, self.pool.arena_lock, torch.inference_mode():
            read = iter(arena_page_slices(self.pool.ensure_arena(), resident))
        blocks = []
        for pid, key in zip(pids, offs):
            if pid is not None:
                blocks.append(next(read))
            elif key in fetched:
                blocks.append(fetched[key])
            else:
                break
        return blocks

    def export_blocks(self, tokens):
        """A K/V export: the whole-block head of ``tokens`` as ``(head,
        blocks)``, ``blocks`` host tensors (a list over blocks of per-layer
        leaf dicts, the wire shape of ``runtime/kvwire.py``). Missing
        blocks prefill here first, as a cold route would. Returns None
        when the prompt has no whole block. A block the tree cannot hold
        truncates the export to what is present (the importer prefills
        the tail itself)."""
        row = [int(t) for t in tokens]
        cfg = self.server.model.cfg
        bk = self.block
        m = min((len(row) // bk) * bk, cfg.max_len - bk)
        if m <= 0:
            return None
        head = row[:m]
        pids: list = []
        offs: list = []
        kvs: list = []
        for attempt in range(2):
            with self._lock:
                self._maybe_flush_stale_locked()
                present, path = self._present_locked(head)
                if present >= m or attempt:
                    if present <= 0:
                        return None
                    if self.pool is not None:
                        # refs taken under the lock that found the pages:
                        # a sweep must not reuse one before the host read
                        pids = [n.page_id for n in path]
                        offs = [n.off_key for n in path]
                        self.pool.retain([p for p in pids if p is not None])
                    else:
                        kvs = [n.kv for n in path]
                    head = head[:present]
                    break
            # prefill the missing blocks through the walk (once: a racer's
            # eviction meanwhile exports the shorter head)
            self._extend(head, m)
        if self.pool is not None:
            try:
                blocks = self._read_blocks(pids, offs)
            finally:
                self.pool.release([p for p in pids if p is not None])
        else:
            with DEVICE_LOCK, torch.inference_mode():
                blocks = blocks_to_host(kvs)
        if not blocks:
            return None
        return head[:len(blocks) * bk], blocks

    def _fetch_offloaded(self, keys: list) -> dict:
        """Read-only batched fetch of spilled blocks for the export
        surfaces (the entries stay spilled). ``{key: host block}``; what
        could not be read is absent, and the caller truncates."""
        if not keys or self.offload is None:
            return {}
        try:
            return dict(zip(keys, self.offload.fetch_many(keys)))
        except Exception as e:  # noqa: BLE001 — export truncates, never fails
            log.error("offloaded-block fetch failed during export "
                      "(truncating): %s", e)
            return {}

    def _device_blocks(self, blocks) -> list:
        """Host blocks as fresh tensors on the server's device."""
        dev = self.server.device
        with DEVICE_LOCK, torch.inference_mode():
            return [[{name: val.to(device=dev, copy=True)
                      for name, val in entry.items()} for entry in blk]
                    for blk in blocks]

    def import_blocks(self, tokens, blocks) -> dict:
        """Register shipped whole-block K/V under ``tokens``: a radix
        insert. Dense mode attaches the blocks as tree nodes; paged mode
        writes each new block into a page of its own (a strict allocation:
        :class:`PagesExhausted` propagates as priced backpressure). The
        blocks are checked against this server's store layout before any
        device work: a garbage frame raises ``ValueError`` and touches
        nothing. Blocks already present are left alone."""
        row = [int(t) for t in tokens]
        bk = self.block
        self._validate_import_head(row, len(blocks))
        for blk in blocks:
            self._validate_import_block(blk)
        with self._lock:
            self._maybe_flush_stale_locked()
            present, _ = self._present_locked(row)
        mode = "paged" if self.pool is not None else "dense"
        new = blocks[present // bk:]
        if not new:
            return {"present": len(blocks), "inserted": 0, "mode": mode}
        if self.pool is not None:
            inserted = self._import_paged(row, present, new)
        else:
            inserted = self._insert(row, present, self._device_blocks(new))
        return {"present": present // bk, "inserted": inserted,
                "mode": mode}

    def _import_paged(self, row: list, start: int, blocks: list) -> int:
        """Every block into a page of its own, all pages taken up front
        (:class:`PagesExhausted` propagates, nothing taken), written in one
        indexed write per leaf, then attached under the matched path."""
        pool = self.pool
        pids = pool.alloc(len(blocks), tokens=len(blocks) * self.block,
                          record_shed=False)
        try:
            with DEVICE_LOCK, pool.arena_lock, torch.inference_mode():
                arena = pool.ensure_arena()
                gen = pool.generation
                write_arena_pages(arena, pids, blocks)
        except Exception:
            pool.release(pids)  # a failed write leaks no page
            raise
        return self._attach_paged(row, start, pids, gen)

    def _validate_import_head(self, row: list, n_blocks: int) -> None:
        """Import geometry checks shared by the monolithic and streamed
        paths: whole-block coverage and room left to decode."""
        bk = self.block
        cfg = self.server.model.cfg
        if not row or len(row) % bk or len(row) // bk != int(n_blocks):
            raise ValueError(
                f"import tokens ({len(row)}) must cover exactly "
                f"{n_blocks} x {bk}-token blocks")
        if len(row) > cfg.max_len - bk:
            raise ValueError(
                f"shipped prefix of {len(row)} tokens leaves no room "
                f"to decode in a {cfg.max_len}-token window")

    def _validate_import_block(self, blk) -> None:
        """One block's layers and leaves against this server's store
        template."""
        cfg = self.server.model.cfg
        template = self._leaf_template()
        if len(blk) != cfg.layers:
            raise ValueError(
                f"frame has {len(blk)} layers, server has {cfg.layers}")
        for entry in blk:
            if set(entry) != set(template):
                raise ValueError(
                    f"frame leaves {sorted(entry)} do not match "
                    f"store layout {sorted(template)}")
            for name, val in entry.items():
                shape, dt = template[name]
                if not torch.is_tensor(val) or tuple(val.shape) != shape \
                        or val.dtype != dt:
                    got = (f"{val.dtype}{tuple(val.shape)}"
                           if torch.is_tensor(val) else type(val).__name__)
                    raise ValueError(f"leaf {name!r} is {got}, server "
                                     f"stores {dt}{shape}")

    def import_begin(self, tokens) -> "KvStreamImport":
        """Open a streamed import: the head's geometry is checked now, and
        a paged store takes the whole ship's pages up front
        (:class:`PagesExhausted` propagates before any transfer). Nothing
        touches the tree until :meth:`KvStreamImport.commit`; an abort
        releases every staged page."""
        return KvStreamImport(self, tokens)

    def export_stream(self, tokens):
        """The streamed twin of :meth:`export_blocks`: ``(head,
        generator)``, the generator yielding groups of host blocks as each
        is available (the present prefix first, then each walk chunk as
        it runs), so the HTTP layer flushes a wire chunk while the next
        chunk prefills. The head is fixed up front (the stream header is
        already on the wire): a failure mid-walk truncates the stream,
        which the receiver detects. None when the prompt has no whole
        block."""
        row = [int(t) for t in tokens]
        cfg = self.server.model.cfg
        bk = self.block
        m = min((len(row) // bk) * bk, cfg.max_len - bk)
        if m <= 0:
            return None
        head = row[:m]
        return head, self._export_stream_gen(head)

    def _export_stream_gen(self, head: list):
        group = max(1, self.walk_chunk // self.block)
        key = self.server._prefix_key(head)
        target = len(head)
        while True:
            owner, waiter, pinned, offs, kvs = False, None, [], [], []
            with self._lock:
                self._maybe_flush_stale_locked()
                present, path = self._present_locked(head)
                if present < target and self.pool is not None:
                    # the walk gathers the present prefix from resident
                    # pages: it ends at the first spilled block
                    res = 0
                    for n in path:
                        if n.page_id is None:
                            break
                        res += self.block
                    present, path = res, path[:res // self.block]
                if present < target:
                    waiter = self._inflight.get(key)
                    if waiter is None:
                        self._inflight[key] = threading.Event()
                        owner = True
                if present >= target or owner:
                    if self.pool is not None:
                        pinned = [n.page_id for n in path]
                        offs = [n.off_key for n in path]
                        self.pool.retain(
                            [p for p in pinned if p is not None])
                    else:
                        kvs = [n.kv for n in path]
            if present >= target:
                try:
                    yield from self._read_block_groups(pinned, kvs, group,
                                                       offs)
                finally:
                    if pinned:
                        self.pool.release(
                            [p for p in pinned if p is not None])
                return
            if not owner:
                # another thread walks this very prefix: wait, then serve
                # from the tree
                if not waiter.wait(timeout=300.0):
                    raise RuntimeError(
                        f"prefix walk for key {key[:8]}... owned by "
                        "another thread did not complete within 300s")
                continue
            try:
                yield from self._read_block_groups(pinned, kvs, group, offs)
                yield from self._walk_stream(head, present, path)
            finally:
                if pinned:
                    self.pool.release([p for p in pinned if p is not None])
                with self._lock:
                    event = self._inflight.pop(key, None)
                if event is not None:
                    event.set()
            return

    def _read_block_groups(self, pinned: list, kvs: list, group: int,
                           offs: list | None = None):
        """The present prefix as groups of host blocks: paged reads ride
        the refs held in ``pinned`` (a None entry is a spilled block, read
        through its ``offs`` key), dense reads the tree's tensors in
        ``kvs``. An unreadable spilled block truncates the stream."""
        if self.pool is not None:
            offs = offs if offs else [None] * len(pinned)
            for i in range(0, len(pinned), group):
                out = self._read_blocks(pinned[i:i + group],
                                        offs[i:i + group])
                if out:
                    yield out
                if len(out) < len(pinned[i:i + group]):
                    return
        else:
            for i in range(0, len(kvs), group):
                with DEVICE_LOCK, torch.inference_mode():
                    host = blocks_to_host(kvs[i:i + group])
                yield host

    def _walk_stream(self, row: list, matched: int, path: list):
        """The cold tail of a streamed export: the walk of :meth:`_walk`
        chunk by chunk, each chunk's blocks yielded as host tensors once
        the chunk has run, and inserted into the tree on the way (the
        export is the prefill; a failed insert caches less and never
        fails the ship)."""
        server, bk = self.server, self.block
        with DEVICE_LOCK:
            window = server._checkout_window(server.model.cfg.max_len)
        try:
            for lo, hi in self._walk_steps(window, row, matched, len(row),
                                           path):
                with DEVICE_LOCK, torch.inference_mode():
                    new = [slice_cache_blocks(window.cache, p, bk)
                           for p in range(lo, hi, bk)]
                    host = blocks_to_host(new)
                try:
                    if self.pool is not None:
                        self._insert_paged(row, lo, window.cache, hi)
                    else:
                        self._insert(row, lo, new)
                except Exception as e:  # noqa: BLE001 — cache less, ship on
                    log.error("streamed export insert failed (caching "
                              "less): %s", e)
                yield host
            if self.pool is None:
                with DEVICE_LOCK, torch.inference_mode():
                    cache = window.snapshot()
                server.register_prefix(server._prefix_key(row), cache,
                                       len(row))
        finally:
            with DEVICE_LOCK:
                server.programs.checkin(window)

    # -- walks ---------------------------------------------------------------

    def _ensure_assembled(self, row: list, path: list) -> None:
        """Make sure the server's prefix LRU holds the full-window cache
        of ``row[:len(path) * block]``, assembled from the tree's block
        slices when it was evicted."""
        m = len(path) * self.block
        key = self.server._prefix_key(row[:m])
        if self.server.get_prefix(key) is not None:
            return
        cfg = self.server.model.cfg
        with DEVICE_LOCK, torch.inference_mode():
            cache = concat_cache_blocks(cfg, [n.kv for n in path],
                                        cfg.max_len)
        self.stats_counters.record_assembly(cache_nbytes(cache))
        self.server.register_prefix(key, cache, m)

    def _extend(self, row: list, target: int) -> None:
        """Prefill ``row`` up to ``target`` tokens through the server's
        chunk functions, inserting each new block into the tree (and, in
        dense mode, registering the final cache as the target's prefix
        entry). Re-matches after any wait: the owner usually inserted the
        very blocks this thread wanted."""
        key = self.server._prefix_key(row[:target])
        while True:
            owner, waiter, pinned = False, None, []
            with self._lock:
                matched, path = self._match_locked(row)
                if matched < target and self.pool is not None:
                    # hold the matched pages for the walk, under the lock
                    # that matched them: a sweep could otherwise release
                    # and reuse one before the walk's gather reads it. A
                    # spilled block ends the usable prefix: the walk
                    # prefills from there
                    keep = []
                    for n in path:
                        if n.page_id is None:
                            break
                        keep.append(n)
                    path = keep
                    matched = len(keep) * self.block
                    pinned = [n.page_id for n in path]
                    self.pool.retain(pinned)
                if matched < target:
                    waiter = self._inflight.get(key)
                    if waiter is None:
                        self._inflight[key] = threading.Event()
                        owner = True
            if matched >= target:
                if self.pool is None:
                    self._ensure_assembled(row, path[:target // self.block])
                return
            if owner:
                try:
                    self._walk(row, matched, target, path)
                finally:
                    if pinned:
                        self.pool.release(pinned)
                    with self._lock:
                        event = self._inflight.pop(key, None)
                    if event is not None:
                        event.set()
                return
            if pinned:
                self.pool.release(pinned)  # not the owner: let go first
            if not waiter.wait(timeout=300.0):
                raise RuntimeError(
                    f"prefix walk for key {key[:8]}... owned by another "
                    "thread did not complete within 300s")

    def _walk_fault(self) -> None:
        """The ``prefix_walk`` site: once per cold-walk chunk dispatch."""
        if self.faults is not None:
            self.faults.check("prefix_walk")

    def _walk(self, row: list, matched: int, target: int,
              path: list) -> None:
        """The chunked walk from ``matched`` to ``target`` in a window
        checked out of the server's program cache for the walk: a first
        chunk (or the matched prefix gathered from its pages / copied from
        its registered entry), then wide chunks where they fit, block-wide
        chunks for the rest; every chunk one dispatch under the device
        lock. What outlives the walk is copied out of the window: the
        registered entry and the tree's blocks (dense), the new pages
        (paged)."""
        server = self.server
        with DEVICE_LOCK:
            window = server._checkout_window(server.model.cfg.max_len)
        try:
            self._walk_in(window, row, matched, target, path)
        finally:
            with DEVICE_LOCK:
                server.programs.checkin(window)

    def _walk_in(self, window, row: list, matched: int, target: int,
                 path: list) -> None:
        for _ in self._walk_steps(window, row, matched, target, path):
            pass
        if self.pool is not None:
            # paged insertion: each new block gets a page of its own,
            # written from the window; nothing is registered
            self._insert_paged(row, matched, window.cache, target)
            return
        server, bk = self.server, self.block
        with DEVICE_LOCK, torch.inference_mode():
            new_blocks = [slice_cache_blocks(window.cache, p, bk)
                          for p in range(matched, target, bk)]
            cache = window.snapshot()
        server.register_prefix(server._prefix_key(row[:target]), cache,
                               target)
        self._insert(row, matched, new_blocks)

    def _walk_steps(self, window, row: list, matched: int, target: int,
                    path: list):
        """The chunked walk from ``matched`` to ``target`` in ``window``:
        a first chunk (or the matched prefix gathered from its pages /
        copied from its registered entry), then wide chunks where they
        fit, block-wide chunks for the rest; every chunk one dispatch
        under the device lock. Yields each chunk's ``(lo, hi)`` token
        range once the chunk is enqueued."""
        server = self.server
        cfg = server.model.cfg
        bk = self.block
        stats = self.prefill_stats
        t_walk = time.monotonic()
        if matched == 0:
            fw = self.walk_chunk if target >= self.walk_chunk else bk
            prompt, _ = server._pad_host([row[:fw]], [fw], 1, fw)
            self._walk_fault()
            server._prefix_first_fn(fw, cfg.max_len)(prompt, fw, window)
            stats.record_round()
            yield 0, fw
        elif self.pool is not None:
            # the matched blocks live in pages: gather them into the
            # walk's window (transient, never registered)
            tbl = np.zeros((1, cfg.max_len // bk), np.int32)
            tbl[0, :len(path)] = [n.page_id for n in path]
            with DEVICE_LOCK, self.pool.arena_lock, torch.inference_mode():
                server._gather_pages_into(
                    window, self.pool.ensure_arena(),
                    torch.as_tensor(tbl, device=server.device), bk, matched)
        else:
            entry = server.get_prefix(server._prefix_key(row[:matched]))
            with DEVICE_LOCK, torch.inference_mode():
                if entry is not None:
                    # the walk writes its window in place; the registered
                    # entry stays whole for concurrent readers
                    window.load(entry[0], matched)
                else:
                    cache = concat_cache_blocks(cfg, [n.kv for n in path],
                                                cfg.max_len)
                    self.stats_counters.record_assembly(cache_nbytes(cache))
                    window.load(cache, matched)
        pos = window.index
        # full wide chunks where they fit, block-wide ones after: a chunk
        # is written whole at the index, so it must end inside max_len
        wk = self.walk_chunk
        ext = server._prefix_ext_fn(bk)
        ext_wide = server._prefix_ext_fn(wk) if wk > bk else None
        while pos < target:
            wide = (ext_wide is not None and target - pos >= wk
                    and pos + wk <= cfg.max_len)
            width = wk if wide else bk
            chunk, _ = server._pad_host([row[pos:pos + width]], [width], 1,
                                        width)
            self._walk_fault()
            (ext_wide if wide else ext)(window, chunk, width)
            stats.record_round()
            yield pos, pos + width
            pos += width
        stats.record_walk(time.monotonic() - t_walk)

    def _insert(self, row: list, start: int, new_blocks: list) -> int:
        """Attach the new block slices under the matched path (idempotent
        against racers), then sweep the budget. Returns the blocks
        attached (a racer may have won some)."""
        attached = 0
        with self._lock:
            # re-walk from the root: a racer may have changed the path
            node, m = self._root, 0
            while m < start + len(new_blocks) * self.block:
                tok_key = tuple(row[m:m + self.block])
                child = node.children.get(tok_key)
                if child is None:
                    idx = (m - start) // self.block
                    if m < start or idx >= len(new_blocks):
                        # a racer evicted part of our base path: give up
                        # the insert, the K/V already serves
                        break
                    kv = new_blocks[idx]
                    child = _Node(node, tok_key, kv, cache_nbytes(kv))
                    node.children[tok_key] = child
                    self.stats_counters.record_insert(1, child.nbytes)
                    attached += 1
                child.last_used = next(self._clock)
                node = child
                m += self.block
            self._evict_locked()
        return attached

    def _insert_paged(self, row: list, start: int, cache,
                      target: int) -> int:
        """Paged insertion: a page for each new block of the walk's cache
        (``[start, target)``), written from the cache, then attached under
        the matched path. The writes are staged before the store lock is
        taken, so routing never waits behind a cold insert's device work.
        Out of pages asks the pool's reclaim hook (this store's cold
        unshared leaves) through ``alloc``; a full arena caches fewer
        blocks, and the request has its K/V in the walk's cache anyway.
        Returns the blocks attached."""
        pool, bk = self.pool, self.block
        staged: list[int] = []
        for _ in range(start, target, bk):
            try:
                staged.append(pool.alloc(1, tokens=bk, record_shed=False)[0])
            except PagesExhausted:
                break  # cache less; `sheds` meters admissions
        if not staged:
            return 0
        try:
            with DEVICE_LOCK, pool.arena_lock, torch.inference_mode():
                arena = pool.ensure_arena()
                gen = pool.generation
                n = len(staged)
                pids = torch.as_tensor(staged, device=self.server.device)
                for aentry, centry in zip(arena, cache):
                    for name, val in aentry.items():
                        src = centry[name][0, start:start + n * bk]
                        val[pids] = src.reshape(n, bk, *src.shape[1:])
        except Exception:
            pool.release(staged)  # a failed write leaks no page
            raise
        return self._attach_paged(row, start, staged, gen)

    def _attach_paged(self, row: list, start: int, staged: list,
                      gen: int) -> int:
        """Attach staged (allocated and written) pages as tree nodes under
        the matched path. Each page in ``staged`` becomes a store-owned
        node or is released (a racer's duplicate, a vanished base path,
        an arena rebuilt since ``gen``)."""
        pool, bk = self.pool, self.block
        attached: set[int] = set()
        with self._lock:
            self._maybe_flush_stale_locked()
            if pool.generation != gen:
                pool.release(staged)
                return 0
            node, m = self._root, 0
            while m < start + len(staged) * bk:
                tok_key = tuple(row[m:m + bk])
                child = node.children.get(tok_key)
                if child is None:
                    idx = (m - start) // bk
                    if m < start or idx >= len(staged):
                        break
                    child = _Node(node, tok_key, None, pool.page_bytes,
                                  page_id=staged[idx])
                    node.children[tok_key] = child
                    self.stats_counters.record_insert(1, child.nbytes)
                    attached.add(idx)
                child.last_used = next(self._clock)
                node = child
                m += bk
            self._evict_locked()
        leftovers = [pid for i, pid in enumerate(staged) if i not in attached]
        if leftovers:
            pool.release(leftovers)
        return len(attached)

    # -- eviction ------------------------------------------------------------

    def reclaim_pages(self, n: int) -> int:
        """The pool's out-of-pages hook: release up to ``n`` cold
        UNSHARED leaf pages, so live admissions never shed behind a cache
        nobody uses right now. Returns the pages freed."""
        with self._lock:
            return self._sweep_unshared_locked(n)

    def _sweep_unshared_locked(self, n: int) -> int:
        """Release up to ``n`` LRU leaves whose page only the store holds,
        in one tree pass over one snapshot of the refcounts. A parent
        whose chain became evictable goes on the next sweep. Pinned nodes
        are left alone: a session's retention is bounded by the pin
        budget, not by this sweep.

        With an offload tier the victims' pages SPILL: one ordered host
        read of them all, then each page's bytes go to the offload arena
        and the node stays in the tree as a ghost (``off_key`` set, page
        released); a victim the arena refuses is dropped. "Leaf" then
        means "no resident descendant": a spilled child must not shield
        its parent's cold page."""
        refs = self.pool.snapshot_refs()
        nodes = list(self._iter_nodes())
        if self.offload is not None:
            blocked: set[int] = set()
            for node in nodes:
                if node.page_id is not None:
                    p = node.parent
                    while p is not None and id(p) not in blocked:
                        blocked.add(id(p))
                        p = p.parent
            leaves = [node for node in nodes
                      if node.page_id is not None
                      and id(node) not in blocked and not node.pins
                      and refs.get(node.page_id, 0) == 1]
        else:
            leaves = [node for node in nodes
                      if not node.children and node.page_id is not None
                      and not node.pins
                      and refs.get(node.page_id, 0) == 1]
        leaves.sort(key=lambda node: node.last_used)
        victims = leaves[:max(0, int(n))]
        blocks = None
        if self.offload is not None and victims:
            try:
                with DEVICE_LOCK, self.pool.arena_lock, \
                        torch.inference_mode():
                    blocks = arena_page_slices(
                        self.pool.ensure_arena(),
                        [v.page_id for v in victims])
            except Exception as e:  # noqa: BLE001 — drop instead
                log.error("page spill read failed (dropping the pages "
                          "instead): %s", e)
        for i, victim in enumerate(victims):
            spilled, key = False, None
            if blocks is not None:
                key = self._node_key(victim)
                try:
                    spilled = self.offload.spill(key, victim.token_key,
                                                 blocks[i])
                except Exception as e:  # noqa: BLE001 — drop instead
                    log.error("page spill failed (dropping the page "
                              "instead): %s", e)
            if spilled:
                victim.off_key = key
                self.stats_counters.record_evict(1, victim.nbytes)
                self.pool.release([victim.page_id])
                victim.page_id = None
            else:
                # the victim's subtree holds only ghosts: it goes whole
                self._prune_subtree_locked(victim)
        return len(victims)

    def _prune_subtree_locked(self, node: _Node) -> None:
        """Detach ``node`` and clean its whole subtree: resident pages
        release (each counted as evicted), spilled entries drop, pin
        accounting settles."""
        if node.parent is not None:
            node.parent.children.pop(node.token_key, None)
        keys = []
        stack = [node]
        while stack:
            cur = stack.pop()
            if cur.page_id is not None:
                self.pool.release([cur.page_id])
                self.stats_counters.record_evict(1, cur.nbytes)
                cur.page_id = None
            if cur.off_key is not None:
                keys.append(cur.off_key)
                cur.off_key = None
            if cur.pins > 0:
                self._pinned_bytes -= cur.nbytes
                self._pinned_leaves -= 1
                cur.pins = 0
            stack.extend(cur.children.values())
            cur.children = {}
        if keys and self.offload is not None:
            self.offload.drop(keys)

    def _evict_locked(self) -> None:
        """LRU leaf eviction until the budget holds (leaves only: an
        interior node's K/V is position-prefixed by its parents). Paged
        mode skips a leaf whose page a live row still shares: releasing
        it would drop the store's ref without freeing a page."""
        if self.pool is not None:
            while True:
                over = self.stats_counters.report()["bytes"] \
                    - self.budget_bytes
                if over <= 0:
                    return
                need = -(-over // max(1, self.pool.page_bytes))
                if not self._sweep_unshared_locked(need):
                    return
        while self.stats_counters.report()["bytes"] > self.budget_bytes:
            leaves = [n for n in self._iter_nodes()
                      if not n.children and n.kv is not None
                      and not n.pins]
            if not leaves:
                return
            victim = min(leaves, key=lambda n: n.last_used)
            victim.parent.children.pop(victim.token_key, None)
            self.stats_counters.record_evict(1, victim.nbytes)
            victim.kv = None

    def _iter_nodes(self):
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            yield node
            stack.extend(node.children.values())

    # -- observability -------------------------------------------------------

    def check_invariants(self) -> dict:
        """Host-only accounting sweep: recomputes the pin and content
        counters from the tree and checks them against the live ones;
        paged mode also checks that every cached node's page is live in
        the pool and that no node holds a page and a spilled entry at
        once. Returns ``{"ok", "violations", ...}``; never raises."""
        violations: list[str] = []
        with self._lock:
            self._maybe_flush_stale_locked()
            self._expire_sessions_locked(time.monotonic())
            nodes = list(self._iter_nodes())
            pinned = [n for n in nodes if n.pins > 0]
            leaves, nbytes = len(pinned), sum(n.nbytes for n in pinned)
            if leaves != self._pinned_leaves:
                violations.append(
                    f"pinned_leaves counter {self._pinned_leaves} != "
                    f"{leaves} pinned nodes in the tree")
            if nbytes != self._pinned_bytes:
                violations.append(
                    f"pinned_bytes counter {self._pinned_bytes} != "
                    f"{nbytes} recomputed from pinned nodes")
            held: dict[int, int] = {}
            for sess in self._sessions.values():
                for n in sess.nodes:
                    held[id(n)] = held.get(id(n), 0) + 1
            for n in nodes:
                if n.pins != held.get(id(n), 0):
                    violations.append(
                        f"node pins={n.pins} but {held.get(id(n), 0)} "
                        f"live session(s) hold it")
                    break
            content = [n for n in nodes
                       if (n.page_id is not None if self.pool is not None
                           else n.kv is not None)]
            ghosts = [n for n in nodes if n.off_key is not None]
            content_bytes = sum(n.nbytes for n in content)
            rep = self.stats_counters.report()
            if len(content) != rep["blocks"]:
                violations.append(
                    f"blocks counter {rep['blocks']} != {len(content)} "
                    f"content nodes in the tree")
            if content_bytes != rep["bytes"]:
                violations.append(
                    f"bytes counter {rep['bytes']} != {content_bytes} "
                    f"recomputed from content nodes")
            if len(content) + len(ghosts) != len(nodes):
                violations.append(
                    f"{len(nodes) - len(content) - len(ghosts)} nodes in "
                    f"the tree hold no K/V")
            if self.pool is not None:
                refs = self.pool.snapshot_refs()
                for n in content:
                    if refs.get(n.page_id, 0) < 1:
                        violations.append(
                            f"tree references page {n.page_id} with no "
                            f"live pool ref")
                        break
                for n in ghosts:
                    if n.page_id is not None:
                        violations.append(
                            f"node holds page {n.page_id} and offload key "
                            f"{n.off_key!r}: spill and re-online must be "
                            f"exclusive")
                        break
            return {"ok": not violations, "violations": violations,
                    "sessions_active": len(self._sessions),
                    "pinned_leaves": leaves, "pinned_bytes": nbytes,
                    "blocks": len(content), "bytes": content_bytes,
                    "offloaded_blocks": len(ghosts),
                    "pages": sorted(n.page_id for n in content)
                    if self.pool is not None else [],
                    "paged": self.pool is not None}

    def stats(self) -> dict:
        out = self.stats_counters.report()
        out["block"] = self.block
        out["walk_chunk"] = self.walk_chunk
        out["budget_bytes"] = self.budget_bytes
        # the scrape runs the lazy lease sweep, so pins return to zero
        # after the sessions close without any traffic
        with self._lock:
            self._maybe_flush_stale_locked()
            self._expire_sessions_locked(time.monotonic())
            out["sessions_active"] = len(self._sessions)
            out["pinned_leaves"] = self._pinned_leaves
            out["pinned_bytes"] = self._pinned_bytes
            out["pin_budget_bytes"] = self.pin_budget_bytes
            out["pin_sheds"] = self.pin_sheds
            out["pin_overflows"] = self.pin_overflows
            out["pin_expiries"] = self.pin_expiries
            out["pin_invalidations"] = self.pin_invalidations
            out["pin_faults"] = self.pin_faults
        if self.pool is not None:
            out["paged"] = True
        # the assembled full-window caches live in the server's prefix
        # LRU (prefix_cache_max entries), outside this budget: their bytes
        # are reported beside the tree's
        entries = self.server.prefix_stats()
        out["assembled_entries"] = entries["prefix_entries"]
        out["assembled_bytes"] = entries["prefix_bytes"]
        out["prefill"] = self.prefill_stats.report()
        return out


class KvStreamImport:
    """One streamed K/V import in flight (:meth:`PrefixStore.import_begin`)::

        imp = store.import_begin(tokens)     # geometry, page reservation
        imp.add_blocks(blocks)               # per wire chunk: check, stage
        res = imp.commit()                   # attach to the tree at once
        imp.abort()                          # any failure: release all

    Staging (the page writes, or the copies to the device) runs per
    chunk, beside the rest of the transfer; the radix tree changes only
    at :meth:`commit`, so a truncated or garbage stream leaves the store
    as it was."""

    def __init__(self, store: PrefixStore, tokens):
        self.store = store
        self.row = [int(t) for t in tokens]
        bk = store.block
        self.n_blocks = len(self.row) // bk if self.row else 0
        store._validate_import_head(self.row, self.n_blocks)
        with store._lock:
            store._maybe_flush_stale_locked()
            present, _ = store._present_locked(self.row)
        self.present = present          # tokens already in the tree
        self.received = 0               # blocks fed so far (present too)
        self.closed = False
        self._blocks: list = []         # dense staging
        self._pages: list[int] = []     # paged staging (reserved)
        self._written = 0
        self._gen = 0
        pool = store.pool
        if pool is not None:
            with DEVICE_LOCK, pool.arena_lock:
                pool.ensure_arena()
                self._gen = pool.generation
            n_new = self.n_blocks - present // bk
            if n_new > 0:
                # the whole ship's pages before any transfer: a full arena
                # is backpressure now, not a half-staged stream later
                self._pages = pool.alloc(n_new, tokens=n_new * bk,
                                         record_shed=False)

    def add_blocks(self, blocks) -> None:
        """Stage one wire chunk's blocks (in block order, as the stream
        decoder enforces): blocks the tree held at begin are skipped, the
        rest written into their reserved pages (paged) or copied to the
        device (dense). Every block is checked before any is staged."""
        if self.closed:
            raise ValueError("KV stream import already closed")
        store, bk = self.store, self.store.block
        if self.received + len(blocks) > self.n_blocks:
            raise ValueError(
                f"KV stream overruns its header: {self.received} + "
                f"{len(blocks)} > {self.n_blocks} blocks")
        for blk in blocks:
            store._validate_import_block(blk)
        skip = max(0, min(len(blocks), self.present // bk - self.received))
        self.received += len(blocks)
        new = blocks[skip:]
        if not new:
            return
        pool = store.pool
        if pool is None:
            self._blocks.extend(store._device_blocks(new))
            return
        pids = self._pages[self._written:self._written + len(new)]
        with DEVICE_LOCK, pool.arena_lock, torch.inference_mode():
            write_arena_pages(pool.ensure_arena(), pids, new)
        self._written += len(new)

    @property
    def complete(self) -> bool:
        return self.received >= self.n_blocks

    def commit(self) -> dict:
        """Attach every staged block under the matched path, as the
        monolithic import does. An incomplete stream is refused and
        rolled back."""
        store, bk = self.store, self.store.block
        if self.closed:
            raise ValueError("KV stream import already closed")
        if not self.complete:
            got = self.received
            self.abort()
            raise ValueError(
                f"truncated KV stream: {got} of {self.n_blocks} "
                f"block(s) arrived")
        self.closed = True
        mode = "paged" if store.pool is not None else "dense"
        try:
            if store.pool is not None:
                # the staged pages pass to the attach (tree nodes, or
                # released as a racer's duplicates)
                pages, self._pages = self._pages, []
                inserted = store._attach_paged(self.row, self.present,
                                               pages, self._gen)
            elif self._blocks:
                inserted = store._insert(self.row, self.present,
                                         self._blocks)
            else:
                inserted = 0
        except Exception:
            self._release()
            raise
        return {"present": self.present // bk, "inserted": inserted,
                "mode": mode}

    def abort(self) -> None:
        """Release every staged page and forget the staging: the tree and
        the pool read as if the stream never started. Idempotent."""
        if self.closed:
            return
        self.closed = True
        self._release()

    def _release(self) -> None:
        pool = self.store.pool
        if pool is not None and self._pages:
            pool.release(self._pages)
        self._pages = []
        self._blocks = []
