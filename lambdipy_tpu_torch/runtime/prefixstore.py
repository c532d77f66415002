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

Every failure path FAILS OPEN: a store error logs and the request serves
unrouted. The ``prefix_walk`` fault site (``runtime/faults.py``, the
handler's live plan) fires once per chunk dispatch of a cold walk.

Each chunk of a walk takes the device lock alone, like a prefill, so the
continuous engine's segments interleave with a long walk. Not ported yet
(ROADMAP): session pins, the host offload tier, K/V export and import
(``runtime/kvwire.py``) and the sequence-parallel walk.
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
from lambdipy_tpu_torch.models.llama import (cache_nbytes,
                                             concat_cache_blocks,
                                             slice_cache_blocks)
from lambdipy_tpu_torch.runtime.metrics import (PrefillStats,
                                                PrefixCacheStats)
from lambdipy_tpu_torch.runtime.pagepool import PagesExhausted, page_width

log = logging.getLogger("lambdipy_tpu_torch.prefixstore")


class _Node:
    """One block of a cached prefix: ``kv`` is the per-layer store-layout
    slice list of this block's positions (dense mode), or ``page_id``
    names the arena page that holds them (paged mode; the store owns one
    pool ref per node)."""

    __slots__ = ("parent", "token_key", "children", "kv", "nbytes",
                 "last_used", "page_id")

    def __init__(self, parent, token_key, kv=None, nbytes=0, page_id=None):
        self.parent = parent
        self.token_key = token_key  # tuple of this block's tokens
        self.children: dict[tuple, _Node] = {}
        self.kv = kv
        self.nbytes = nbytes
        self.last_used = 0
        self.page_id = page_id


class PrefixStore:
    """Radix-tree prefix KV store over a ``LlamaServer``."""

    def __init__(self, server: Any, *, block: int = 32,
                 budget_mb: float = 512.0, pool: Any = None,
                 prefill_stats: PrefillStats | None = None,
                 faults: Any = None):
        self.server = server
        # FaultPlan | None: site "prefix_walk" fires once per cold-walk
        # chunk dispatch; an exception fails the walk open (route serves
        # the request unrouted)
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
        self._clock = itertools.count(1)
        # target-path key -> Event: concurrent cold requests for one
        # prefix wait for one walk
        self._inflight: dict[str, threading.Event] = {}

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
        for node in list(self._iter_nodes()):
            if node.page_id is not None:
                self.pool.release([node.page_id])
                self.stats_counters.record_evict(1, node.nbytes)
                node.page_id = None
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
        match and the bump."""
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
                if child is None or child.page_id is None:
                    return None
                child.last_used = next(self._clock)
                path.append(child)
                node = child
                m += self.block
            pids = [n.page_id for n in path]
            self.pool.retain(pids)
        return pids, m

    def present_len(self, tokens) -> int:
        """Host-only: tokens of the whole-block head whose blocks are all
        present (dense K/V or a live page)."""
        try:
            row = [int(t) for t in tokens]
        except (TypeError, ValueError):
            return 0
        head = row[:(len(row) // self.block) * self.block]
        if not head:
            return 0
        with self._lock:
            self._maybe_flush_stale_locked()
            node, m = self._root, 0
            while m < len(head):
                child = node.children.get(tuple(head[m:m + self.block]))
                if child is None or (child.page_id is None
                                     if self.pool is not None
                                     else child.kv is None):
                    break
                child.last_used = next(self._clock)
                node = child
                m += self.block
            return m

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
                    # and reuse one before the walk's gather reads it
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
            pos += width
            stats.record_round()
        stats.record_walk(time.monotonic() - t_walk)
        if self.pool is not None:
            # paged insertion: each new block gets a page of its own,
            # written from the window; nothing is registered
            self._insert_paged(row, matched, window.cache, target)
            return
        with DEVICE_LOCK, torch.inference_mode():
            new_blocks = [slice_cache_blocks(window.cache, p, bk)
                          for p in range(matched, target, bk)]
            cache = window.snapshot()
        server.register_prefix(server._prefix_key(row[:target]), cache,
                               target)
        self._insert(row, matched, new_blocks)

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
        whose chain became evictable goes on the next sweep."""
        refs = self.pool.snapshot_refs()
        leaves = [node for node in self._iter_nodes()
                  if not node.children and node.page_id is not None
                  and refs.get(node.page_id, 0) == 1]
        leaves.sort(key=lambda node: node.last_used)
        victims = leaves[:max(0, int(n))]
        for victim in victims:
            self._prune_subtree_locked(victim)
        return len(victims)

    def _prune_subtree_locked(self, node: _Node) -> None:
        """Detach ``node`` and release every page of its subtree (each
        counted as evicted)."""
        if node.parent is not None:
            node.parent.children.pop(node.token_key, None)
        stack = [node]
        while stack:
            cur = stack.pop()
            if cur.page_id is not None:
                self.pool.release([cur.page_id])
                self.stats_counters.record_evict(1, cur.nbytes)
                cur.page_id = None
            stack.extend(cur.children.values())
            cur.children = {}

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
                      if not n.children and n.kv is not None]
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
        """Host-only accounting sweep: recomputes the content counters
        from the tree and checks them against the live ones; paged mode
        also checks that every cached node's page is live in the pool.
        Returns ``{"ok", "violations", ...}``; never raises."""
        violations: list[str] = []
        with self._lock:
            self._maybe_flush_stale_locked()
            nodes = list(self._iter_nodes())
            content = [n for n in nodes
                       if (n.page_id is not None if self.pool is not None
                           else n.kv is not None)]
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
            if len(content) != len(nodes):
                violations.append(f"{len(nodes) - len(content)} nodes in "
                                  f"the tree hold no K/V")
            if self.pool is not None:
                refs = self.pool.snapshot_refs()
                for n in content:
                    if refs.get(n.page_id, 0) < 1:
                        violations.append(
                            f"tree references page {n.page_id} with no "
                            f"live pool ref")
                        break
            return {"ok": not violations, "violations": violations,
                    "blocks": len(content), "bytes": content_bytes,
                    "pages": sorted(n.page_id for n in content)
                    if self.pool is not None else [],
                    "paged": self.pool is not None}

    def stats(self) -> dict:
        out = self.stats_counters.report()
        out["block"] = self.block
        out["walk_chunk"] = self.walk_chunk
        out["budget_bytes"] = self.budget_bytes
        with self._lock:
            self._maybe_flush_stale_locked()
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
