"""Continuous (in-flight) batching for the generate handler.

The port's ``ContinuousBatcher``, twin of
``lambdipy_tpu/runtime/continuous.py`` cut to this slice. Without it the
port serves one request at a time; here a batched decode advances in
SEGMENTS of ``segment`` steps and new requests join it at segment
boundaries, packed into a free slot.

- The engine owns a B-slot decode carry (token, logprob, position and a
  ``torch.Generator`` per slot) over either a dense B-slot cache of
  ``cache_len`` positions or a page arena (``runtime/pagepool.py``).
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
  square of its bucket under ``blocked``). Packing (scalars into the
  slot, the prefill's K/V into the slot's cache row or pages) happens on
  the engine thread at the barrier.
- The loop is synchronous (``pipeline_depth`` 1): run a segment, fetch
  its ``[B, k]`` token block, book it, retire finished rows, pack
  joiners, repeat; it exits when idle and restarts on the next request.
- eos is handled on the host, as in JAX: decode never latches; the
  collector records the first eos of a row (``eos_at``) and ``generate``
  truncates the row there and pads it with eos. A row's tokens do not
  depend on its neighbours: attention reads only the row's own
  positions, the int8 GEMV (m <= 8 rows) computes each row alone, and a
  sampled row draws once per step from its own generator, which travels
  with its slot.

Not ported yet (ROADMAP): pipelining (``pipeline_depth >= 2``), window
bucketing, the chunked joiner prefill, the watchdog / replay /
degradation ladder, speculation, long context, meshes and the
scheduling policy (joiners are FIFO).
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

from lambdipy_tpu_torch.models.llama import (_kv_store, _next_bucket,
                                             _scan_decode, _serve_select,
                                             init_decode_cache,
                                             pack_prefill_into_pages,
                                             row_generators)
from lambdipy_tpu_torch.runtime.metrics import EngineStats

log = logging.getLogger("lambdipy_tpu_torch.continuous")

_entry_seq = itertools.count()

# prompts longer than this prefill alone on their request thread
GROUP_PREFILL_MAX = 256


class ContinuousBatcher:
    """Segment-boundary continuous batching over a ``LlamaServer``."""

    def __init__(self, server, *, slots: int = 8, segment: int = 16,
                 cache_len: int | None = None, page_pool=None):
        cfg = server.model.cfg
        self.server = server
        self.slots = max(1, int(slots))
        self.segment = max(1, int(segment))
        self.cache_len = min(cache_len or cfg.max_len, cfg.max_len)
        self.pool = page_pool
        if page_pool is not None:
            if self.cache_len % page_pool.page:
                raise ValueError(f"page {page_pool.page} does not divide "
                                 f"engine cache_len {self.cache_len}")
            page_pool.window_pages = self.cache_len // page_pool.page
        self.stats_counters = EngineStats()
        self._lock = threading.Condition()
        self._joiners: list[dict] = []
        self._active: list[dict | None] = [None] * self.slots
        self._engine_running = False
        self._carry: dict | None = None
        # one request-thread prefill at a time
        self._prefill_lock = threading.Lock()
        # the last retired rows: prompt length, tokens asked, seconds from
        # admission to the first booked token and to completion; paged
        # rows also their page count and when (``time.monotonic``) the
        # pages were charged and released
        self.request_log: deque = deque(maxlen=256)

    # -- paged-KV helpers ----------------------------------------------------

    def _charge_pages(self, entry: dict, tokens: int) -> None:
        """Charge pages for the row's tokens (prompt + requested decode);
        :class:`PagesExhausted` propagates to the caller. Charges and
        releases happen under the engine lock, so their times order them
        as the pool saw them."""
        with self._lock:
            entry["pages"] = self.pool.alloc(-(-tokens // self.pool.page),
                                             tokens=tokens)
            entry["charged_at"] = time.monotonic()

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

    # -- device helpers ------------------------------------------------------

    def _init_carry(self) -> dict:
        """All-empty B-slot carry on the device: the dense B-slot cache,
        or (paged) the pool's arena, built on first use."""
        server, b = self.server, self.slots
        dev = server.device
        carry = {"tok": torch.zeros(b, dtype=torch.long, device=dev),
                 "lp": torch.zeros(b, dtype=torch.float32, device=dev),
                 "pos": torch.zeros(b, dtype=torch.int32, device=dev),
                 # empty slots draw from placeholders when a neighbour
                 # samples; a joiner's own generator replaces its slot's
                 "gens": row_generators([(0, r) for r in range(b)], dev)}
        carry["idle_gens"] = list(carry["gens"])
        if self.pool is not None:
            with self.pool.arena_lock:
                self.pool.ensure_arena()
        else:
            carry["cache"] = init_decode_cache(server.model.cfg, b,
                                               self.cache_len, dev)
        return carry

    def _prefill_rows(self, entries: list):
        """ONE ragged prefill of ``entries`` (rows of one prompt bucket),
        each row under its own knobs and generator: ``(first [bb], lp0
        [bb], prefill cache)``. The prompt width is ``generate``'s for
        the row, so the prefill is the one the row would run solo."""
        server = self.server
        rows = [e["row"] for e in entries]
        lens = [e["s"] for e in entries]
        bb = _next_bucket(len(rows), 1)
        sb = max(server.prompt_bucket(e["s"], e["n"]) for e in entries)
        prompt, length = server._pad_rows(rows, lens, bb, sb)
        temp, tk, tp, gens, _ = server._knob_operands(
            [e["temperature"] for e in entries],
            [e["top_k"] for e in entries], [e["top_p"] for e in entries],
            [e["seed"] for e in entries], None, b=bb)
        gens[:len(entries)] = [e["gen"] for e in entries]
        logits, cache = server.model(prompt, logit_positions=length - 1)
        first, lp0 = _serve_select(temp, tk, tp)(logits[:, 0, :].float(),
                                                  gens)
        return first, lp0, cache

    def _pack(self, entry: dict, prefill, src: int) -> None:
        """Row ``src`` of a prefill into the entry's slot: the first token,
        its logprob, the position and the generator into the carry; the
        K/V into the slot's cache row (dense) or its pages (paged)."""
        carry, slot = self._carry, entry["slot"]
        first, lp0, cache = prefill
        carry["tok"][slot] = first[src]
        carry["lp"][slot] = lp0[src]
        carry["pos"][slot] = entry["s"]
        carry["gens"][slot] = entry["gen"]
        cfg = self.server.model.cfg
        if self.pool is not None:
            nb = self.cache_len // self.pool.page
            table = torch.as_tensor(self._table_row(entry, nb),
                                    device=self.server.device)
            with self.pool.arena_lock:
                pack_prefill_into_pages(cfg, self.pool.arena, table, cache,
                                        src)
        else:
            for dest, pc in zip(carry["cache"], cache):
                width = min(pc["k"].shape[1], self.cache_len)
                store = _kv_store(cfg, pc["k"][src, :width],
                                  pc["v"][src, :width])
                for name, val in store.items():
                    dest[name][slot, :width] = val
        entry["packed"] = True
        self.stats_counters.record_join()

    def _pack_joiners(self, packing: list) -> None:
        """Prefill the raw joiners, grouped by prompt bucket, and pack
        every joiner of this barrier."""
        groups: dict[int, list] = {}
        for e in packing:
            if e["prefill"] is None:
                sb = self.server.prompt_bucket(e["s"], e["n"])
                groups.setdefault(sb, []).append(e)
        for group in groups.values():
            prefill = self._prefill_rows(group)
            self.stats_counters.record_group_prefill(len(group))
            for src, e in enumerate(group):
                self._pack(e, prefill, src)
        for e in packing:
            if e["prefill"] is not None:
                self._pack(e, e["prefill"], 0)
                e["prefill"] = None  # free the row's prefill cache

    def _run_segment(self, live: list) -> None:
        """Advance every slot up to ``segment`` steps (no further than the
        live row furthest from its quota) and book each live row's
        tokens."""
        server, carry = self.server, self._carry
        dev = server.device
        b = self.slots
        k = min(self.segment,
                max(e["n"] - len(e["toks"]) for _, e in live))
        temp = np.zeros((b,), np.float32)
        top_k = np.zeros((b,), np.int64)
        top_p = np.ones((b,), np.float32)
        for slot, e in live:
            temp[slot] = e["temperature"] or 0.0
            top_k[slot] = e["top_k"] or 0
            top_p[slot] = 1.0 if e["top_p"] is None else e["top_p"]
        select = _serve_select(temp, torch.as_tensor(top_k, device=dev),
                               torch.as_tensor(top_p, device=dev))
        eos = torch.full((b,), -1, dtype=torch.long, device=dev)
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        lock = contextlib.nullcontext()
        if self.pool is not None:
            nb = self.cache_len // self.pool.page
            tables = torch.as_tensor(
                np.stack([self._table_row(e, nb) for e in self._active]),
                device=dev)
            cache = [{**leaves, "tables": tables}
                     for leaves in self.pool.arena]
            lock = self.pool.arena_lock
        else:
            cache = carry["cache"]
        with lock:
            (toks, lps), (tok, lp, _, pos, _, _) = _scan_decode(
                server.model, select, carry["tok"], carry["lp"], cache,
                carry["pos"], done, carry["gens"], eos, k,
                return_carry=True)
        carry.update(tok=tok, lp=lp, pos=pos)
        toks = toks.cpu().numpy()
        lps = (lps.float().cpu().numpy()
               if any(e["want_lp"] for _, e in live) else None)
        self.stats_counters.record_segment(k, len(live))
        now = time.monotonic()
        with self._lock:
            for slot, e in live:
                row = toks[slot].tolist()
                base = len(e["toks"])
                if base == 0:
                    e["ttft_s"] = now - e["t0"]
                e["toks"].extend(row)
                if lps is not None:
                    e["lps"].extend(lps[slot].tolist())
                eos_id = e["eos_id"]
                if eos_id is not None and e["eos_at"] is None \
                        and eos_id in row:
                    e["eos_at"] = base + row.index(eos_id)
                if e["eos_at"] is not None or len(e["toks"]) >= e["n"]:
                    e["done"] = True
                    e["wall_s"] = now - e["t0"]
                    self.stats_counters.record_served()
            self._lock.notify_all()

    # -- engine thread -------------------------------------------------------

    def _engine_loop(self) -> None:
        try:
            with torch.inference_mode():
                self._engine_body()
        except BaseException as e:  # noqa: BLE001 — waiters must never hang
            log.exception("continuous engine failed")
            self._fail(e)

    def _engine_body(self) -> None:
        while True:
            # barrier: retire finished rows, hand free slots to joiners
            with self._lock:
                for slot, e in enumerate(self._active):
                    if e is not None and e["done"]:
                        self._active[slot] = None
                        self._retire(e)
                free = [i for i, e in enumerate(self._active) if e is None]
                while self._joiners and free:
                    joiner = self._joiners.pop(0)
                    joiner["slot"] = free.pop(0)
                    self._active[joiner["slot"]] = joiner
                live = [(slot, e) for slot, e in enumerate(self._active)
                        if e is not None]
                if not live:
                    self._engine_running = False
                    self._lock.notify_all()
                    return
            if self._carry is None:
                self._carry = self._init_carry()
            carry = self._carry
            for slot, e in enumerate(self._active):
                if e is None:
                    # an empty slot restarts at position 0 with a
                    # placeholder generator: its garbage stays short
                    carry["pos"][slot] = 0
                    carry["gens"][slot] = carry["idle_gens"][slot]
            self._pack_joiners([e for _, e in live if not e["packed"]])
            self._run_segment(live)

    def _retire(self, e: dict) -> None:
        """Return a finished row's pages and log it (caller holds the
        lock)."""
        record = {"seq": e["seq"], "s": e["s"], "n": e["n"],
                  "ttft_s": e["ttft_s"], "wall_s": e["wall_s"]}
        if self.pool is not None:
            self._release_pages(e)
            record.update({k: e[k] for k in ("n_pages", "charged_at",
                                             "released_at")})
        self.request_log.append(record)

    def _fail(self, error: BaseException) -> None:
        """Fail every admitted row (their waiters raise ``error``) and
        reset the engine; the next request starts a fresh one."""
        with self._lock:
            for e in [*self._active, *self._joiners]:
                if e is not None and not e["done"]:
                    e["error"], e["done"] = error, True
                if e is not None and self.pool is not None:
                    self._release_pages(e)
            self._active = [None] * self.slots
            self._joiners = []
            self._carry = None
            self._engine_running = False
            self._lock.notify_all()

    # -- API -----------------------------------------------------------------

    def _admit(self, prompt_row, max_new_tokens, temperature, top_k, top_p,
               seed, eos_id, return_logprobs):
        """Validate, charge pages, prefill a long prompt here, enqueue the
        row as a joiner and start the engine. Returns the live entry, or
        None when the row must run solo: past the engine's ``cache_len``,
        or more pages than the arena could ever hold. A transiently full
        arena raises :class:`PagesExhausted`."""
        t0 = time.monotonic()
        if max_new_tokens <= 0:
            return None
        row = np.asarray(prompt_row, np.int32).reshape(-1).tolist()
        s = len(row)
        if s + max_new_tokens > self.cache_len:
            return None
        self.server._validate(s, max_new_tokens)
        seed = int(seed) if seed is not None else 0
        entry = {"n": max_new_tokens, "eos_id": eos_id,
                 "temperature": temperature, "top_k": top_k, "top_p": top_p,
                 "seed": seed, "toks": [], "lps": [],
                 "want_lp": return_logprobs, "done": False, "error": None,
                 "slot": None, "packed": False, "eos_at": None,
                 "row": row, "s": s, "prefill": None,
                 "seq": next(_entry_seq), "t0": t0, "ttft_s": None,
                 # the row's own generator, seeded as generate seeds a
                 # one-row request; it travels with the row's slot
                 "gen": row_generators([(seed, 0)],
                                       self.server.device)[0]}
        if self.pool is not None:
            if -(-(s + max_new_tokens) // self.pool.page) \
                    > self.pool.capacity_pages:
                return None
            self._charge_pages(entry, s + max_new_tokens)
        try:
            if s > GROUP_PREFILL_MAX:
                with self._prefill_lock, torch.inference_mode():
                    entry["prefill"] = self._prefill_rows([entry])
                self.stats_counters.record_row_prefill()
        except BaseException:
            if self.pool is not None:
                with self._lock:
                    self._release_pages(entry)
            raise
        with self._lock:
            self._joiners.append(entry)
            if not self._engine_running:
                self._engine_running = True
                threading.Thread(target=self._engine_loop, daemon=True,
                                 name="continuous-batch").start()
        return entry

    def generate(self, prompt_row, *, max_new_tokens: int,
                 temperature: float = 0.0, top_k=None, top_p=None,
                 seed: int = 0, eos_id=None, return_logprobs: bool = False):
        """One request row -> int32 ``[1, max_new_tokens]`` (plus f32
        logprobs when asked): the ``LlamaServer.generate`` contract for a
        single prompt. Rows the engine cannot hold run solo."""
        entry = self._admit(prompt_row, max_new_tokens, temperature, top_k,
                            top_p, seed, eos_id, return_logprobs)
        if entry is None:
            return self.server.generate(
                prompt_row, max_new_tokens=max_new_tokens,
                temperature=temperature, top_k=top_k, top_p=top_p,
                seed=seed, eos_id=eos_id, return_logprobs=return_logprobs)
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
                        seed: int = 0, eos_id=None,
                        return_logprobs: bool = False):
        """Streaming over the shared engine: the row joins like any other
        and its slice of each segment is yielded as it lands, as ``[1,
        k]`` chunks, ``k <= segment`` (``(tokens, logprobs)`` pairs when
        asked). Concatenated chunks equal :meth:`generate`'s output up to
        the chunk holding eos. The chunk cadence is the engine's segment,
        also for a row that runs solo."""
        entry = self._admit(prompt_row, max_new_tokens, temperature, top_k,
                            top_p, seed, eos_id, return_logprobs)
        if entry is None:
            yield from self.server.generate_stream(
                prompt_row, max_new_tokens=max_new_tokens,
                temperature=temperature, top_k=top_k, top_p=top_p,
                seed=seed, eos_id=eos_id, segment=self.segment,
                return_logprobs=return_logprobs)
            return
        delivered = 0
        while delivered < max_new_tokens:
            with self._lock:
                while not entry["done"] and len(entry["toks"]) <= delivered:
                    self._lock.wait(timeout=1.0)
                if entry["error"] is not None:
                    raise entry["error"]
                toks, lps = list(entry["toks"]), list(entry["lps"])
            # at most one segment per chunk, also when this reader fell
            # behind the engine by several segments
            take = min(len(toks), max_new_tokens, delivered + self.segment)
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

    def stats(self) -> dict:
        with self._lock:
            out = {"mode": "continuous", "slots": self.slots,
                   "segment": self.segment, "cache_len": self.cache_len,
                   "paged": self.pool is not None,
                   "active_rows": sum(e is not None for e in self._active),
                   "waiting_joiners": len(self._joiners),
                   **self.stats_counters.report()}
        if self.pool is not None:
            out["page_pool"] = self.pool.stats()
        return out
