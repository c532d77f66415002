"""Compiled decode steps: a :class:`~lambdipy_tpu_torch.models.llama.DecodeStep`
captured as a CUDA graph and replayed once per decode step, and the
bucket-keyed LRU of such programs that ``LlamaServer`` keeps. The port's
twin of the JAX server's compiled programs: ``LlamaServer._fn_cached``
(``lambdipy_tpu/models/llama.py``) and the ``lax.scan`` of
``_scan_decode`` compiled once per bucket.

- A replay runs no Python, so the kernel wrappers' launch counters (a
  Python ``+= 1`` beside each launch) would miss it. A capture runs the
  step's Python once without running its kernels: :class:`StepProgram`
  takes back what the capture counted and adds exactly that at every
  replay, so the counters stay equal to the launches the card ran.
- What must not happen inside a capture is done first, on the capture
  stream (:func:`prepare_capture`): the kernel libraries built and
  loaded, the int8 GEMV's merge counters for the capture stream
  allocated, cuBLAS's handle and workspace for this thread and stream
  made (a first cuBLAS call inside a capture invalidates it on an H100).
- One capture at a time per process, with no other device work beside
  it: every serving path holds :data:`DEVICE_LOCK` around its device work
  (prefills, decode steps and the fetches that wait on them), and
  captures take it too.
- A sampled step draws from one ``torch.Generator`` per row. The
  generators are registered with the graph
  (``CUDAGraph.register_generator_state``), so a replay draws what the
  eager step would and advances each generator as it would. Where the
  card's PyTorch cannot register them, sampled steps run eagerly and are
  counted (``eager_steps``); greedy steps are always captured.

On the CPU no graph exists: a program runs its step eagerly. Tests inject
a stand-in for the graph type (:class:`CudaGraph` is the card's).
"""

from __future__ import annotations

import threading
from collections import OrderedDict, deque

import torch

from lambdipy_tpu_torch.ops import decode_attention, quant
from lambdipy_tpu_torch.ops.attention import flash_attention


class FairLock:
    """A reentrant lock granted in the order threads asked for it. The
    engine thread takes the device lock once per segment and asks again
    at once; with ``threading.RLock`` it could win every time and starve
    a request thread waiting to prefill a long prompt."""

    def __init__(self):
        self._cond = threading.Condition(threading.Lock())
        self._owner = None
        self._depth = 0
        self._queue: deque = deque()

    def acquire(self) -> None:
        me = threading.get_ident()
        with self._cond:
            if self._owner == me:
                self._depth += 1
                return
            self._queue.append(me)
            while self._owner is not None or self._queue[0] != me:
                self._cond.wait()
            self._queue.popleft()
            self._owner, self._depth = me, 1

    def release(self) -> None:
        with self._cond:
            if self._owner != threading.get_ident():
                raise RuntimeError("release of a lock this thread does not "
                                   "hold")
            self._depth -= 1
            if self._depth == 0:
                self._owner = None
                self._cond.notify_all()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


# one capture at a time, and no other device work beside it (see above)
DEVICE_LOCK = FairLock()

_COUNTERS = ((decode_attention.blocked_decode_attention, "launches"),
             (decode_attention.blocked_decode_attention, "launches_int8kv"),
             (decode_attention.paged_decode_attention, "launches"),
             (decode_attention.paged_decode_attention, "launches_int8kv"),
             (quant.int8_matmul, "launches"),
             (flash_attention, "launches"))


def _read_counts() -> list[int]:
    return [getattr(fn, attr) for fn, attr in _COUNTERS]


def _add_counts(counts, sign: int = 1) -> None:
    for (fn, attr), n in zip(_COUNTERS, counts):
        setattr(fn, attr, getattr(fn, attr) + sign * n)


_streams: dict = {}


def capture_stream(device) -> torch.cuda.Stream:
    """The process's capture stream on ``device``: one, so that the GEMV's
    merge counters reserved for it before a capture are the ones the
    capture records."""
    with DEVICE_LOCK:
        if device not in _streams:
            _streams[device] = torch.cuda.Stream(device)
        return _streams[device]


def prepare_capture(model, rows: int) -> None:
    """On the current stream, everything a capture of ``model``'s decode
    step of ``rows`` rows must find done: the kernel libraries loaded
    (``nvcc`` and ``dlopen`` cannot run inside a capture), the GEMV's merge
    counters for this stream at the widest projection's size, and
    cuBLAS's handle and workspace for this thread and stream."""
    cfg = model.cfg
    dev = model.embed.embedding.device  # with its index, as the kernels key
    if cfg.attn_backend == "blocked":
        decode_attention._library()
    if cfg.quant == "int8" and cfg.matmul_backend == "pallas":
        quant._library()
        widest = max(cfg.vocab_size, cfg.mlp, cfg.hidden,
                     cfg.heads * cfg.head_dim)
        stream = torch.cuda.current_stream(dev).cuda_stream
        quant.reserve_gemv_counters(dev, stream,
                                    quant.gemv_counter_count(rows, widest))
    for dtype in {cfg.dtype, torch.float32}:
        a = torch.zeros(1, 8, 8, dtype=dtype, device=dev)
        torch.bmm(a, a)
        torch.mm(a[0], a[0])


class CudaGraph:
    """``torch.cuda.CUDAGraph`` behind the calls a :class:`StepProgram`
    makes: captured on the process's capture stream after
    :func:`prepare_capture` ran there. ``pool_bytes`` is what the capture
    added to the reserved device memory: the graph's private pool, which
    holds the step's temporaries (the kernels' outputs and scratch) at
    the addresses every replay reuses."""

    # the card's PyTorch can capture per-row generator draws
    captures_draws = hasattr(torch.cuda.CUDAGraph, "register_generator_state")

    def __init__(self, device):
        self.device = device
        self.graph = torch.cuda.CUDAGraph()
        self.pool_bytes = 0

    def register_generator_state(self, gen) -> None:
        self.graph.register_generator_state(gen)

    def capture(self, fn, prepare) -> None:
        stream = capture_stream(self.device)
        main = torch.cuda.current_stream(self.device)
        stream.wait_stream(main)
        # capture_begin / capture_end, not the ``torch.cuda.graph`` context:
        # that one empties PyTorch's cache first, and the next request's
        # prefill then waits on fresh cudaMallocs
        with torch.cuda.stream(stream):
            prepare()
            reserved = torch.cuda.memory_reserved(self.device)
            self.graph.capture_begin()
            try:
                fn()
            finally:
                self.graph.capture_end()
        main.wait_stream(stream)
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved

    def replay(self) -> None:
        self.graph.replay()

    def reset(self) -> None:
        self.graph.reset()


class GraphStats:
    """Counters of a server's (or an engine's) decode programs:
    ``captures`` (graphs captured, the JAX server's ``compile_count``),
    ``replays`` (decode steps run as a replay), ``eager_steps`` (decode
    steps run eagerly: every step without graphs, sampled steps where the
    card cannot capture draws) and ``evictions`` (programs the LRU
    dropped)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.captures = self.replays = self.eager_steps = self.evictions = 0

    def record(self, name: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + n)

    def report(self) -> dict:
        with self._lock:
            return {"compile_count": self.captures, "replays": self.replays,
                    "eager_steps": self.eager_steps,
                    "program_evictions": self.evictions}


class StepProgram:
    """One decode step of ``step`` (greedy or ``sampled``), run by
    :meth:`run`: eagerly when ``graph_type`` is None (the CPU, or a server
    built with ``graphs=False``) or when the graph type cannot capture
    generator draws and the step samples; else captured on its first run
    and replayed from then on. A failed capture raises."""

    def __init__(self, step, sampled: bool, graph_type, stats: GraphStats):
        self.step = step
        self.sampled = bool(sampled)
        self.graph_type = graph_type
        self.stats = stats
        self._graph = None
        self._counts = None

    @property
    def uses_graph(self) -> bool:
        return self.graph_type is not None and (
            not self.sampled or self.graph_type.captures_draws)

    @property
    def pool_bytes(self) -> int:
        return getattr(self._graph, "pool_bytes", 0)

    def run(self) -> None:
        if not self.uses_graph:
            self.step.step(self.sampled)
            self.stats.record("eager_steps")
            return
        if self._graph is None:
            self._capture()
        self._graph.replay()
        _add_counts(self._counts)
        self.stats.record("replays")

    def _capture(self) -> None:
        step = self.step
        graph = self.graph_type(step.model.device)
        if self.sampled:
            for gen in step.gens:
                graph.register_generator_state(gen)
        with DEVICE_LOCK:
            before = _read_counts()
            try:
                graph.capture(lambda: step.step(self.sampled),
                              lambda: prepare_capture(step.model, step.rows))
            finally:
                # the capture ran the wrappers' Python, not their kernels
                counts = [a - b for a, b in zip(_read_counts(), before)]
                _add_counts(counts, -1)
        self._graph, self._counts = graph, counts
        self.stats.record("captures")

    def close(self) -> None:
        """Free the graph (and its pool) and let go of the step."""
        if self._graph is not None:
            with DEVICE_LOCK:
                self._graph.reset()
        self._graph = self.step = None


class StepPrograms:
    """A :class:`~lambdipy_tpu_torch.models.llama.DecodeStep` (its buffers
    and decode cache) with its greedy and its sampled :class:`StepProgram`,
    each made on first use: one cache, two programs. The unit both the
    server's :class:`ProgramCache` and the continuous engine hold."""

    def __init__(self, step, graph_type, stats: GraphStats):
        self.step = step
        self.graph_type = graph_type
        self.stats = stats
        self._programs: dict[bool, StepProgram] = {}

    def program(self, sampled: bool) -> StepProgram:
        sampled = bool(sampled)
        if sampled not in self._programs:
            self._programs[sampled] = StepProgram(self.step, sampled,
                                                  self.graph_type, self.stats)
        return self._programs[sampled]

    def modes(self) -> list[str]:
        return ["sampled" if s else "greedy" for s in sorted(self._programs)]

    def graph(self, sampled: bool):
        """The captured graph of the greedy or sampled program, or None."""
        prog = self._programs.get(bool(sampled))
        return prog._graph if prog is not None else None

    def nbytes(self) -> int:
        """Device bytes held: the step's decode cache and the graphs'
        pools."""
        if self.step is None:
            return 0
        return self.step.nbytes() + sum(p.pool_bytes
                                        for p in self._programs.values())

    def close(self) -> None:
        """Free the graphs (and their pools) and let go of the step."""
        for prog in self._programs.values():
            prog.close()
        self._programs, self.step = {}, None


class ProgramCache:
    """``LlamaServer``'s decode programs: an LRU of :class:`StepPrograms`
    keyed by everything but greedy or sampled, bounded by a count
    (``max_entries``, the JAX server's ``program_cache_max``) and by the
    device bytes the entries hold (``max_bytes``, None = no bound), since
    an entry owns a decode cache whose size grows with its key.

    A request checks an entry out for its whole life (a stream holds it
    across segments), so two requests never share a cache: a second
    concurrent request of the same key gets an entry of its own. Before a
    new entry is made, idle entries are evicted oldest first until the
    new one fits both bounds (busy entries stay, even past a bound); an
    allocation that still runs out of device memory evicts every idle
    entry and is retried once. Eviction frees the entry's graphs, pools
    and cache."""

    def __init__(self, max_entries: int, stats: GraphStats,
                 max_bytes: int | None = None):
        self.max_entries = max(1, int(max_entries))
        self.max_bytes = None if max_bytes is None else int(max_bytes)
        self.stats = stats
        self._lock = threading.Lock()
        self._idle: OrderedDict = OrderedDict()  # id -> (key, entry)
        self._busy: dict = {}

    def checkout(self, key, nbytes: int, make) -> StepPrograms:
        """An idle entry of ``key``, or a new one from ``make()`` whose
        decode cache takes ``nbytes`` (caller holds :data:`DEVICE_LOCK`)."""
        with self._lock:
            for eid, (k, entry) in reversed(self._idle.items()):
                if k == key:
                    del self._idle[eid]
                    self._busy[eid] = (k, entry)
                    return entry
        self._evict(incoming=nbytes)
        try:
            entry = make()
        except torch.OutOfMemoryError:
            if not self.drop_idle():
                raise
            entry = make()
        with self._lock:
            self._busy[id(entry)] = (key, entry)
        return entry

    def checkin(self, entry: StepPrograms) -> None:
        with self._lock:
            self._idle[id(entry)] = self._busy.pop(id(entry))
        self._evict()

    def drop_idle(self) -> int:
        """Evict every idle entry (out of device memory); how many went."""
        with self._lock:
            dropped = [entry for _, entry in self._idle.values()]
            self._idle.clear()
        self._close(dropped)
        return len(dropped)

    def _held(self) -> tuple[int, int]:
        entries = [e for _, e in (*self._idle.values(), *self._busy.values())]
        return len(entries), sum(e.nbytes() for e in entries)

    def _evict(self, incoming: int | None = None) -> None:
        """Evict idle entries, oldest first, until the held entries (and
        an ``incoming`` one of that many bytes) fit both bounds."""
        extra = 0 if incoming is None else 1
        dropped = []
        with self._lock:
            while self._idle:
                count, held = self._held()
                over_bytes = (self.max_bytes is not None
                              and held + (incoming or 0) > self.max_bytes)
                if count + extra <= self.max_entries and not over_bytes:
                    break
                dropped.append(self._idle.popitem(last=False)[1][1])
        self._close(dropped)

    def _close(self, dropped) -> None:
        for entry in dropped:
            entry.close()
            self.stats.record("evictions")

    def keys(self) -> list:
        """Every program's key: the entry's key and greedy or sampled."""
        with self._lock:
            items = [*self._idle.values(), *self._busy.values()]
        return sorted(((*k, mode) for k, e in items for mode in e.modes()),
                      key=repr)

    def nbytes(self) -> int:
        """Device bytes the entries hold: their decode caches and graph
        pools."""
        with self._lock:
            return self._held()[1]
