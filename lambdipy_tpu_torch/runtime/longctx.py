"""The long-context tier: serve several times the engine's window through
a sliding block-table view and the paged K/V host offload.

The port's ``LongContextRunner`` and ``ReonlineFailed``, twins of
``lambdipy_tpu/runtime/longctx.py`` (``:78``, ``:67``). The programs
never grow: decode runs a one-row paged decode step at the engine's
``window`` whose block table ``[1, n_view]`` maps a LOGICAL view of a far
larger context. Slot 0 of the view is logical token ``base``; the step's
``pos`` stays in the LOCAL frame (cache writes, the paged decode-attention
kernel's valid length ``local + 1``) while RoPE sees ``local + base``
(``models/llama.py DecodeStep``'s ``base`` buffer). When the cursor
reaches the view's edge the host slides the view by whole pages: the
evicted head pages spill to the pool's :class:`~lambdipy_tpu_torch.
runtime.offload.OffloadArena` (host RAM, kvwire bytes) under ``("lc",
run, page#)`` keys, their pool pages recycle into the view's tail, the
table buffer is rewritten in place and the step's local cursor shifts by
the exact int32 delta on the device, in place: a captured graph reads its
buffers by address. With ``base = 0`` the step computes what the engine's
paged step computes.

Attention is windowed past the window (each token attends the most
recent window-ish logical positions; the page-granular slide schedule
depends on the lengths alone): capacity beyond the window trades global
attention for a sliding window, never for a shed.

Prefill is chunked through the same view in half-window chunks
(``LlamaServer._lpaged_continue_fn``): each chunk gathers the view into a
one-row window checked out of the server's program cache, writes its
K/V there with RoPE at the logical positions (plain attention over the
window, as JAX runs it) and scatters the written pages back, the view
sliding between chunks. Only the last chunk selects the first token. The
chunks run eagerly, not as graphs: at llama3-8b's 8,192-position window a
4,096-token chunk's f32 scores are 4 GiB a layer, a peak a graph's pool
would keep, and its ~1,000 launches are small against its compute. The
decode step is a graph on the card.
``long_prefill`` (ring attention over an ``sp`` mesh) has no mesh to run
on in the port: asking for it stands down, counted (:func:`note_standdown`,
the port's copy of the JAX counter), as JAX does without a ring mesh.

``resident_cap`` is the pressure-yield mode: after each segment's
dispatch the runner spills the view's coldest full pages past the cap
(:class:`~lambdipy_tpu_torch.runtime.offload.PageTemperature` picks
them) and re-onlines them through the :class:`~lambdipy_tpu_torch.
runtime.offload.Prefetcher`; the demand check before the next dispatch
finds them resident (a hit) or fetches them then (a timed stall). A
FAILED re-online (an ``offload_stall`` fault, a page the arena refused)
aborts the pass and the run replays from scratch with yielding off, up
to ``max_replays``: the schedule is deterministic, so the replay emits
the same tokens; a counted recompute, never a wrong token.

Locks: each device dispatch (a chunk, a segment, a page read or write)
holds ``DEVICE_LOCK`` alone, then the pool's arena lock, and lets go
between them, so the engine's rows on the same pool go on between the
runner's segments. Pages are allocated and released outside
``DEVICE_LOCK``: an allocation may run the prefix store's reclaim, whose
spill reads pages under ``DEVICE_LOCK`` behind the store's lock.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from typing import Any

import numpy as np
import torch

from lambdipy_tpu_torch.models.graphs import (DEVICE_LOCK, GraphStats,
                                              StepPrograms)
from lambdipy_tpu_torch.models.llama import (DecodeStep, _next_bucket,
                                             _scan_decode, arena_page_slices,
                                             to_device, write_arena_pages)
from lambdipy_tpu_torch.runtime.offload import (OffloadArena,
                                                PageTemperature, Prefetcher)

log = logging.getLogger("lambdipy_tpu_torch.longctx")

# the port's copy of the JAX stand-down counter
# (``lambdipy_tpu/parallel/spdecode.py note_standdown``): a mode asked for
# and not taken is counted by reason and logged once per reason
_standdown_lock = threading.Lock()
_standdown: dict[str, int] = {}


def note_standdown(reason: str) -> None:
    """Record one stand-down of ``reason``; the first of each reason
    logs a warning."""
    with _standdown_lock:
        first = reason not in _standdown
        _standdown[reason] = _standdown.get(reason, 0) + 1
    if first:
        log.warning("standdown reason=%s (the mode asked for needs a "
                    "feature the port does not have yet)", reason)


def standdown_stats() -> dict:
    """The stand-downs recorded in this process, by reason."""
    with _standdown_lock:
        return {"standdowns": sum(_standdown.values()),
                "reasons": dict(_standdown)}


class ReonlineFailed(RuntimeError):
    """A spilled page could not come back (an injected fault or a budget
    drop). Carries the cause; the runner replays the run on it, up to
    ``max_replays`` times."""

    def __init__(self, cause: BaseException, pages: int):
        super().__init__(f"re-online of {pages} page(s) failed: {cause!r}")
        self.cause = cause
        self.pages = pages


class LongContextRunner:
    """Solo long-context generation over a shared page pool, one run at a
    time (the continuous engine routes rows past its window here,
    :meth:`ContinuousBatcher._route_longctx`). ``graph_stats`` receives
    its programs' counters (default its own)."""

    def __init__(self, server, pool, *, window: int | None = None,
                 segment: int = 16, max_logical_ctx: int = 0,
                 resident_cap: int | None = None, long_prefill: bool = False,
                 faults: Any = None, max_replays: int = 2,
                 prefill_stats: Any = None,
                 graph_stats: GraphStats | None = None):
        cfg = server.model.cfg
        self.server = server
        self.pool = pool
        self.window = int(window) if window else int(cfg.max_len)
        if self.window % pool.page or self.window < 2 * pool.page:
            raise ValueError(f"window {self.window} must be >= 2 whole "
                             f"{pool.page}-token pages")
        self.n_view = self.window // pool.page
        self.segment = max(1, int(segment))
        self.max_logical_ctx = (int(max_logical_ctx) if max_logical_ctx
                                else 32 * self.window)
        # the boot-time cap: a controller stepping max_logical_ctx down
        # restores toward this, never past it
        self.boot_logical_ctx = self.max_logical_ctx
        self.resident_cap = resident_cap
        self.max_replays = max(0, int(max_replays))
        # the pool's attached arena (the prefix store's host tier): one
        # host budget, one stats block; runner keys are ("lc", run, page#)
        # tuples, which never collide with the store's keys. Without one,
        # an arena of the default budget, attached to the pool so its
        # gauges report under batching.page_pool
        self.offload = getattr(pool, "offload", None)
        if self.offload is None:
            self.offload = OffloadArena(page=pool.page, layers=cfg.layers,
                                        faults=faults)
            pool.attach_offload(self.offload)
        self.stats = self.offload.stats
        self.temp = PageTemperature()
        self.prefill_stats = prefill_stats
        self.long_prefill = bool(long_prefill)
        if self.long_prefill:
            # ring attention over an sp mesh waits for parallelism
            # (ROADMAP queue 1): the chunked prefill runs, counted
            note_standdown("long_prefill_without_ring_mesh")
        self.graph_stats = graph_stats or GraphStats()
        self._run_ids = itertools.count(1)
        self._lock = threading.Lock()  # one run at a time
        # the view's decode step and its programs, built on first use
        self._programs: StepPrograms | None = None
        self._arena_generation = 0
        # runs served, prefill chunks and decode steps run (the forwards
        # the kernels' launch counters follow), the host wall of spills
        # (page reads and frame packing) and of re-onlines (frame decodes
        # and page writes); the last run's timings
        self._counts = {"runs": 0, "chunks": 0, "steps": 0, "spill_s": 0.0,
                        "reonline_s": 0.0}
        self.last_run: dict = {}

    # -- public --------------------------------------------------------------

    def fits(self, s: int, max_new_tokens: int) -> bool:
        return 0 < s + max_new_tokens <= self.max_logical_ctx

    def generate(self, prompt_row, *, max_new_tokens: int,
                 temperature: float = 0.0, top_k=None, top_p=None,
                 seed: int = 0, eos_id=None, return_logprobs: bool = False):
        """``LlamaServer.generate``'s single-row contract over the logical
        window: int32 ``[1, max_new_tokens]`` (plus f32 logprobs when
        asked), eos-latched with eos filler. Deterministic in the request
        alone: a replay after a failed re-online emits the same tokens."""
        with self._lock:
            replays = 0
            while True:
                try:
                    toks, lps = self._run(
                        prompt_row, max_new_tokens, temperature, top_k,
                        top_p, seed, eos_id,
                        resident_cap=(self.resident_cap if replays == 0
                                      else None))
                    break
                except ReonlineFailed as exc:
                    # the lost pages' K/V is recomputed by replaying the
                    # whole schedule with yielding off: under a fault that
                    # stays armed the replay never fetches
                    self.stats.record_recompute(exc.pages)
                    replays += 1
                    if replays > self.max_replays:
                        raise exc.cause
                    log.warning("long-context re-online failed (%s); "
                                "replaying the run (%d/%d)", exc, replays,
                                self.max_replays)
        out = np.asarray([toks[:max_new_tokens]], np.int32)
        if return_logprobs:
            return out, np.asarray([lps[:max_new_tokens]], np.float32)
        return out

    def release(self) -> None:
        """Drop the view's step and its graphs."""
        programs, self._programs = self._programs, None
        if programs is not None:
            programs.close()

    def report(self) -> dict:
        # no lock: a run holds self._lock for its whole length, and the
        # counters are ints only that run writes
        counts = dict(self._counts)
        return {"window": self.window, "segment": self.segment,
                "max_logical_ctx": self.max_logical_ctx,
                "boot_logical_ctx": self.boot_logical_ctx,
                "resident_cap": self.resident_cap,
                "long_prefill": self.long_prefill,
                # the port has no ring mesh and no sp prefill
                "ring_active": False, "prefill_mode": "chunked",
                **self.offload.gauges(), **self.stats.report(),
                # the port's own: runs, prefill chunks, decode steps and
                # their sum, the forwards; the programs' counters
                **counts, "forwards": counts["chunks"] + counts["steps"],
                **self.graph_stats.report()}

    # -- internals -----------------------------------------------------------

    def _key(self, st: dict, lpi: int) -> tuple:
        return ("lc", st["run_id"], lpi)

    def _step_programs(self) -> StepPrograms:
        """The view's one-row paged decode step (``base`` buffer, table
        ``[1, n_view]``) and its programs over the pool's arena, built on
        first use and again when the arena was rebuilt (caller holds
        ``DEVICE_LOCK``)."""
        pool, server = self.pool, self.server
        with pool.arena_lock:
            arena = pool.ensure_arena()
            generation = pool.generation
        if self._programs is not None \
                and self._arena_generation == generation:
            return self._programs
        self.release()
        tables = torch.zeros((1, self.n_view), dtype=torch.int32,
                             device=server.device)
        step = DecodeStep(server.model, arena, 1, tables=tables, base=True)
        self._programs = StepPrograms(step, server.graph_type,
                                      self.graph_stats)
        self._arena_generation = generation
        return self._programs

    def _read_pages(self, pids) -> list:
        """Host reads of arena pages ``pids``, ordered after the work
        enqueued for them (``models/llama.py arena_page_slices``)."""
        with DEVICE_LOCK, self.pool.arena_lock:
            return arena_page_slices(self.pool.ensure_arena(), pids)

    def _spill(self, st: dict, lpis: list, pids: list) -> list:
        """Spill the pages ``pids`` (logical pages ``lpis``) to the offload
        arena under the run's keys; returns the logical pages spilled
        (a budget refusal lands in ``st["lost"]``)."""
        page = self.pool.page
        spilled = []
        t0 = time.monotonic()
        for lpi, block in zip(lpis, self._read_pages(pids)):
            toks = st["tokens"][lpi * page:(lpi + 1) * page]
            if self.offload.spill(self._key(st, lpi), toks, block):
                st["off"][lpi] = self._key(st, lpi)
                spilled.append(lpi)
            else:
                st["lost"].add(lpi)
        self._counts["spill_s"] += time.monotonic() - t0
        return spilled

    def _slide(self, st: dict, k_pages: int) -> int:
        """Advance the view by ``k_pages`` whole pages: spill the evicted
        head pages (every token in them attended already), recycle their
        pool pages into the view's tail, shift the frame. Returns the
        token delta; the caller moves the step's local cursor by it. A
        page the arena refuses is lost to history, never to decode: the
        view has moved past it."""
        pool, page = self.pool, self.pool.page
        evict = st["table"][:k_pages]
        base_page = st["base"] // page
        live = [(base_page + j, pid) for j, pid in enumerate(evict)
                if pid is not None]  # None: spilled already by a yield
        if live:
            self._spill(st, [lpi for lpi, _ in live],
                        [pid for _, pid in live])
        gone = [self._key(st, base_page + j) for j in range(k_pages)]
        self.temp.forget(gone)
        st["prefetch"].forget(gone)
        pool.release([pid for pid in evict if pid is not None])
        fresh = pool.alloc(k_pages, tokens=0, record_shed=False)
        st["table"] = st["table"][k_pages:] + list(fresh)
        st["base"] += k_pages * page
        st["local"] -= k_pages * page
        return k_pages * page

    def _reonline(self, st: dict, slots: list, *, timed: bool) -> None:
        """Fetch the offloaded pages of view ``slots`` in one batched frame
        decode and write them into fresh arena pages. ``timed`` marks a
        demand miss: its wall is the stall."""
        if not slots:
            return
        pool = self.pool
        base_page = st["base"] // pool.page
        keys = [self._key(st, base_page + j) for j in slots]
        t0 = time.monotonic()
        try:
            blocks = self.offload.fetch_many(keys)
        except Exception as exc:  # noqa: BLE001 — fault kinds vary
            raise ReonlineFailed(exc, len(keys)) from exc
        pids = pool.alloc(len(slots), tokens=0, record_shed=False)
        with DEVICE_LOCK, pool.arena_lock, torch.inference_mode():
            write_arena_pages(pool.ensure_arena(), pids, blocks)
        for j, pid in zip(slots, pids):
            st["table"][j] = pid
            st["off"].pop(base_page + j, None)
        self.offload.drop(keys)
        self._counts["reonline_s"] += time.monotonic() - t0
        if timed:
            # the demand already scored its miss
            st["prefetch"].forget(keys)
            self.stats.record_stall(time.monotonic() - t0)
        else:
            st["prefetch"].complete(keys)
        self.temp.touch(keys)

    def _yield_cold(self, st: dict, cap: int) -> None:
        """Pressure yield: spill the view's coldest FULL pages past ``cap``
        (strictly below the cursor's page, so the segment in flight reads
        them and writes none: the read waits for it on the serving
        stream) and release their pool pages."""
        page = self.pool.page
        base_page = st["base"] // page
        full = [j for j in range(self.n_view)
                if (j + 1) * page <= st["local"]
                and st["table"][j] is not None]
        excess = sum(pid is not None for pid in st["table"]) - cap
        if excess <= 0 or not full:
            return
        victims = self.temp.coldest([self._key(st, base_page + j)
                                     for j in full], min(excess, len(full)))
        slots = [key[2] - base_page for key in victims]
        spilled = set(self._spill(st, [key[2] for key in victims],
                                  [st["table"][j] for j in slots]))
        for j in slots:
            if base_page + j not in spilled:
                continue  # a refusal keeps the page resident: nothing lost
            st["prefetch"].spill([self._key(st, base_page + j)])
            self.pool.release([st["table"][j]])
            st["table"][j] = None

    def _view_table(self, st: dict) -> np.ndarray:
        """The dispatch's table: every slot resident (demand re-onlines
        first)."""
        assert all(pid is not None for pid in st["table"])
        return np.asarray(st["table"], np.int32)

    def _prefill(self, st: dict, row, s: int, knobs, gens, sampled: bool):
        """The chunked prefill through the sliding view: half-window
        chunks at the cursor, the view sliding between them; returns the
        last chunk's ``(first, lp0)``."""
        server, pool = self.server, self.pool
        page, window, n_view = pool.page, self.window, self.n_view
        chunk = window // 2
        starts = list(range(0, s, chunk))
        t0 = time.monotonic()
        out = None
        for i, c0 in enumerate(starts):
            clen = min(chunk, s - c0)
            while st["local"] + clen > window:
                self._slide(st, n_view // 2)
            sbs = min(_next_bucket(clen, server.min_bucket),
                      window - st["local"])
            tokens, _ = server._pad_host([row[c0:c0 + clen]], [clen], 1, sbs)
            cont = server._lpaged_continue_fn(sbs, page)
            last = i == len(starts) - 1
            with DEVICE_LOCK, torch.inference_mode():
                table = torch.as_tensor(self._view_table(st),
                                        device=server.device)[None, :]
                w = server._checkout_window(window, stats=self.graph_stats,
                                            graphs=False)
                try:
                    with pool.arena_lock:
                        res = cont(w, pool.ensure_arena(), table,
                                   st["local"], st["base"], tokens, clen,
                                   knobs if last else None, gens, sampled)
                finally:
                    server.programs.checkin(w)
            if last:
                out = res
            st["local"] += clen
            self._counts["chunks"] += 1
            self.temp.touch([self._key(st, st["base"] // page + j)
                             for j in range(st["local"] // page)])
            if self.prefill_stats is not None:
                self.prefill_stats.record_round()
        if self.prefill_stats is not None:
            self.prefill_stats.record_walk(time.monotonic() - t0)
        return out

    def _run(self, prompt_row, max_new_tokens, temperature, top_k, top_p,
             seed, eos_id, *, resident_cap):
        server, pool = self.server, self.pool
        page, window, n_view = pool.page, self.window, self.n_view
        rows, lengths = server._normalize_prompts(prompt_row)
        if len(rows) != 1:
            raise ValueError("the long-context tier is single-row")
        row, s = [int(t) for t in rows[0]], lengths[0]
        if not self.fits(s, max_new_tokens):
            raise ValueError(f"{s + max_new_tokens} tokens exceed "
                             f"max_logical_ctx={self.max_logical_ctx}")
        yield_cap = (resident_cap if resident_cap and resident_cap < n_view
                     else None)
        t0 = time.monotonic()
        st = {"run_id": next(self._run_ids), "base": 0, "local": 0,
              "tokens": list(row), "off": {}, "lost": set(),
              "table": list(pool.alloc(n_view, tokens=0,
                                       record_shed=False)),
              "prefetch": Prefetcher(self.stats)}
        temp, tk, tp, eos, gens = server._knobs_host(
            temperature, top_k, top_p, seed, eos_id, b=1)
        knobs, sampled = (temp, tk, tp), bool(temp[0] > 0)
        out_toks: list = []
        out_lps: list = []
        try:
            first, lp0 = self._prefill(st, row, s, knobs, gens, sampled)
            t_first = time.monotonic()
            seg = self.segment
            dev = server.device
            with DEVICE_LOCK, torch.inference_mode():
                progs = self._step_programs()
                step = progs.step
                step.set_knobs(temp, tk, tp)
                step.load(first, lp0,
                          torch.full((1,), st["local"], dtype=torch.int32,
                                     device=dev), eos, gens)
                to_device(step.base, np.full((1,), st["base"], np.int32))
            eos_seen = False
            while len(out_toks) < max_new_tokens and not eos_seen:
                delta = 0
                while st["local"] + seg > window:
                    delta += self._slide(st, n_view // 2)
                # demand: every view slot resident at dispatch; a page the
                # prefetch brought home counts as a hit, a straggler comes
                # back now, a timed stall
                base_page = st["base"] // page
                miss = st["prefetch"].demand(
                    [self._key(st, base_page + j) for j in range(n_view)])
                self._reonline(st, sorted(k[2] - base_page for k in miss),
                               timed=True)
                table = self._view_table(st)
                with DEVICE_LOCK, torch.inference_mode():
                    if delta:
                        step.pos.sub_(delta)  # int32, exact, in place
                    to_device(step.base, np.full((1,), st["base"], np.int32))
                    to_device(step.tables, table[None, :])
                    with pool.arena_lock:
                        toks, lps = _scan_decode(progs.decode(sampled).run,
                                                 step, seg, segment=True)
                    host, event = _to_pinned((toks, lps))
                self._counts["steps"] += seg
                # the segment runs on the card while the host yields and
                # prefetches
                if yield_cap is not None:
                    self._yield_cold(st, yield_cap)
                    planned = st["prefetch"].plan(
                        [self._key(st, st["base"] // page + j)
                         for j in range(n_view) if st["table"][j] is None])
                    if planned:
                        self._reonline(
                            st, [k[2] - st["base"] // page for k in planned],
                            timed=False)
                if event is not None:
                    with DEVICE_LOCK:
                        event.synchronize()
                chunk_t = host[0].numpy()[0]
                chunk_l = host[1].float().numpy()[0]
                take = min(seg, max_new_tokens - len(out_toks))
                for i in range(take):
                    tok = int(chunk_t[i])
                    out_toks.append(tok)
                    out_lps.append(float(chunk_l[i]))
                    st["tokens"].append(tok)
                    if eos_id is not None and tok == int(eos_id):
                        eos_seen = True
                        break
                st["local"] += seg
                self.temp.touch([self._key(st, st["base"] // page + j)
                                 for j in range(min(st["local"], window)
                                                // page)])
            if eos_id is not None and eos_seen:
                pad = max_new_tokens - len(out_toks)
                out_toks += [int(eos_id)] * pad
                out_lps += [0.0] * pad
            self._counts["runs"] += 1
            wall = time.monotonic() - t0
            self.last_run = {"prompt": s, "new": max_new_tokens,
                             "ttft_s": t_first - t0, "wall_s": wall,
                             "decode_s": wall - (t_first - t0),
                             "spilled_pages": len(st["off"]),
                             "lost_pages": len(st["lost"]),
                             "yield_cap": yield_cap}
            return out_toks[:max_new_tokens], out_lps[:max_new_tokens]
        finally:
            pool.release([pid for pid in st["table"] if pid is not None])
            self.offload.drop(list(st["off"].values()))
            self.temp.forget(list(st["off"].values()))


def _to_pinned(tensors):
    """Copies of a segment's outputs into pinned host memory behind a CUDA
    event (the caller holds ``DEVICE_LOCK``), or plain clones on the CPU
    (event None)."""
    if not tensors[0].is_cuda:
        return [t.clone() for t in tensors], None
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            .copy_(t, non_blocking=True) for t in tensors]
    event = torch.cuda.Event()
    event.record()
    return host, event
