"""Compiled programs: a :class:`~lambdipy_tpu_torch.models.llama.DecodeStep`
captured as a CUDA graph and replayed once per decode step, every prefill
of the serving path captured the same way (``models/llama.py
PrefillProgram``), and the bucket-keyed LRU of such programs that
``LlamaServer`` keeps. The port's twin of the JAX server's compiled
programs: ``LlamaServer._fn_cached`` (``lambdipy_tpu/models/llama.py``),
the ``lax.scan`` of ``_scan_decode`` compiled once per bucket and the
prefill, prefix and continuation programs.

- A program is a closure over static buffers (:class:`GraphProgram`):
  what a request brings is copied into its input buffers before a run,
  and what it gives is read from its output buffers after; a capture
  records the closure's kernels at those addresses.
- A replay runs no Python, so the kernel wrappers' launch counters (a
  Python ``+= 1`` beside each launch) would miss it. A capture runs the
  program's Python once without running its kernels:
  :class:`GraphProgram` takes back what the capture counted and adds
  exactly that at every replay, so the counters stay equal to the
  launches the card ran.
- What must not happen inside a capture is done first, on the capture
  stream (:func:`prepare_capture`): the kernel libraries built and
  loaded, each kernel instantiation's one-time set-up run once outside
  any capture (the tensor-map encoder's driver lookup, the shared-memory
  attributes), the int8 GEMV's merge counters for the capture stream
  allocated, cuBLAS's handle and workspace for this thread and stream
  made (a first cuBLAS call inside a capture invalidates it on an H100).
- One capture at a time per process, with no other device work beside
  it: every serving path holds :data:`DEVICE_LOCK` around its device work
  (prefills, decode steps and the fetches that wait on them), and
  captures take it too.
- A sampled program draws counter-based noise, a function of each
  row's key and draw index, both buffers of the program
  (``models/llama.py stream_uniform``): no generator state lives
  outside the graph, so sampled programs are captured like greedy ones
  and a replay draws what the eager run would.

On the CPU no graph exists: a program runs its step eagerly. Tests inject
a stand-in for the graph type (:class:`CudaGraph` is the card's).
"""

from __future__ import annotations

import gc
import threading
from collections import OrderedDict, deque

import torch

from lambdipy_tpu_torch.ops import _build, attention, decode_attention, quant


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
             (attention.flash_attention, "launches"))


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


_warmed: set = set()


def _warm_kernels(cfg, dev) -> None:
    """Launch every instantiation a prefill of ``cfg`` can reach once,
    outside any capture, on tiny operands and without counting: each runs
    its one-time set-up then (the driver lookup of the tensor-map encoder,
    the function-static ``cudaFuncSetAttribute`` of its shared memory),
    so that no capture ever records it."""
    key = (dev, cfg.dtype, cfg.head_dim, cfg.attn_backend, cfg.quant,
           cfg.matmul_backend)
    if key in _warmed:
        return
    stream = torch.cuda.current_stream(dev).cuda_stream
    if cfg.quant == "int8" and cfg.matmul_backend == "pallas":
        # the tiled route's three tile shapes (0: bf16 only), at m, k, n
        # that fill a tile of each
        m, k, n = 256, 64, 128
        w = torch.zeros(k, n, dtype=torch.int8, device=dev)
        scale = torch.ones(1, n, dtype=torch.float32, device=dev)
        for dtype in {cfg.dtype, torch.float32}:
            x = torch.zeros(m, k, dtype=dtype, device=dev)
            out = torch.empty(m, n, dtype=dtype, device=dev)
            for route in range(0 if dtype == torch.bfloat16 else 1, 3):
                err = quant._launcher()(
                    quant._DTYPES[dtype], x.data_ptr(), w.data_ptr(),
                    scale.data_ptr(), out.data_ptr(), m, k, n, route, stream)
                _build.check(err, "int8_matmul")
    if cfg.attn_backend == "flash":
        q = torch.zeros(1, 128, 1, cfg.head_dim, dtype=cfg.dtype, device=dev)
        out = torch.empty_like(q)
        err = attention._launcher()(
            attention._DTYPES[cfg.dtype], q.data_ptr(), q.data_ptr(),
            q.data_ptr(), out.data_ptr(), 1, 128, 128, 1, 1, cfg.head_dim,
            1.0, 1, stream)
        _build.check(err, "flash_attention")
    torch.cuda.current_stream(dev).synchronize()
    _warmed.add(key)


def prepare_capture(model, rows: int) -> None:
    """On the current stream, everything a capture of one of ``model``'s
    programs over ``rows`` rows must find done: the kernel libraries loaded
    (``nvcc`` and ``dlopen`` cannot run inside a capture) and every kernel
    instantiation's one-time set-up run (:func:`_warm_kernels`), the
    GEMV's merge counters for this stream at the widest projection's size
    (a decode step's every projection, a prefill's lm_head), and
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
    _warm_kernels(cfg, dev)
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

    def __init__(self, device):
        self.device = device
        self.graph = torch.cuda.CUDAGraph()
        self.pool_bytes = 0

    def capture(self, fn, prepare) -> None:
        """Capture ``fn`` on the capture stream after ``prepare`` ran there,
        holding :data:`DEVICE_LOCK` (reentrant: a caller may hold it
        already), so one capture at a time uses the stream, and nothing
        else ever enqueues on it. The capture runs in CUDA's
        ``thread_local`` mode: only this thread's unsafe calls (a sync, a
        ``cudaMalloc``, an event query) may invalidate it. In the default
        ``global`` mode any thread's did, and a request thread's device
        call beside an engine capture failed the capture with
        ``cudaErrorStreamCaptureInvalidated``."""
        with DEVICE_LOCK:
            stream = capture_stream(self.device)
            main = torch.cuda.current_stream(self.device)
            stream.wait_stream(main)
            # capture_begin / capture_end, not the ``torch.cuda.graph``
            # context: that one empties PyTorch's cache first, and the next
            # request's prefill then waits on fresh cudaMallocs. The
            # garbage collector is held off while the capture runs: a
            # graph it finalised there (one of a dropped server's
            # programs) would reset inside the capture, which invalidates
            # it
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.stream(stream):
                    prepare()
                    reserved = torch.cuda.memory_reserved(self.device)
                    self.graph.capture_begin(
                        capture_error_mode="thread_local")
                    try:
                        fn()
                    finally:
                        self.graph.capture_end()
            finally:
                if collecting:
                    gc.enable()
            main.wait_stream(stream)
            self.pool_bytes = (torch.cuda.memory_reserved(self.device)
                               - reserved)

    def replay(self) -> None:
        self.graph.replay()

    def reset(self) -> None:
        self.graph.reset()


class GraphStats:
    """Counters of a server's (or an engine's) programs: ``captures``
    (graphs captured, decode and prefill: the JAX server's
    ``compile_count``), ``replays`` (decode steps and verify steps run as
    a replay), ``eager_steps`` (the same run eagerly: every step without
    graphs),
    ``prefill_replays`` and ``eager_prefills`` (the same for prefills:
    serving prefills, continuations, a walk's chunks) and ``evictions``
    (entries the LRU dropped)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.captures = self.replays = self.eager_steps = self.evictions = 0
        self.prefill_replays = self.eager_prefills = 0

    def record(self, name: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + n)

    def report(self) -> dict:
        with self._lock:
            return {"compile_count": self.captures, "replays": self.replays,
                    "eager_steps": self.eager_steps,
                    "prefill_replays": self.prefill_replays,
                    "eager_prefills": self.eager_prefills,
                    "program_evictions": self.evictions}


class GraphProgram:
    """``body()``, a closure over static buffers, run by :meth:`run`:
    eagerly when ``graph_type`` is None (the CPU, or a server built with
    ``graphs=False``), else captured on its first run and replayed from
    then on. A failed capture raises. ``events`` names the counters a
    replay and an eager run add to (decode: ``replays`` /
    ``eager_steps``).

    ``body`` may return a tuple of tensors: the program's outputs. The
    first run's tensors are kept in :attr:`outputs` (on the card, the
    capture's: they live in the graph's pool) and every later run writes
    into them, so a run overwrites what the one before it gave, eager or
    replayed alike: a caller that keeps an output past the next run of
    the program copies it first."""

    def __init__(self, body, model, rows: int, graph_type,
                 stats: GraphStats,
                 events: tuple = ("replays", "eager_steps")):
        self.body, self.model, self.rows = body, model, rows
        self.graph_type = graph_type
        self.stats = stats
        self.events = events
        self.outputs = None
        self._graph = None
        self._counts = None

    @property
    def uses_graph(self) -> bool:
        return self.graph_type is not None

    @property
    def pool_bytes(self) -> int:
        return getattr(self._graph, "pool_bytes", 0)

    def _call(self) -> None:
        out = self.body()
        if out is None:
            return
        if self.outputs is None:
            self.outputs = tuple(out)
        else:
            for dst, src in zip(self.outputs, out):
                dst.copy_(src)

    def run(self, stats: GraphStats | None = None) -> None:
        """One run; its counters go to ``stats`` (default: the program's
        own)."""
        stats = stats or self.stats
        if not self.uses_graph:
            self._call()
            stats.record(self.events[1])
            return
        if self._graph is None:
            self._capture(stats)
        self._graph.replay()
        _add_counts(self._counts)
        stats.record(self.events[0])

    def prepare(self) -> None:
        """What the capture must find done, run on the capture stream
        just before it (:func:`prepare_capture` for a Llama program)."""
        prepare_capture(self.model, self.rows)

    def _capture(self, stats: GraphStats) -> None:
        graph = self.graph_type(self.model.device)
        with DEVICE_LOCK:
            before = _read_counts()
            try:
                graph.capture(self._call, self.prepare)
            except BaseException:
                self.outputs = None  # the failed capture's, never computed
                raise
            finally:
                # the capture ran the wrappers' Python, not their kernels
                counts = [a - b for a, b in zip(_read_counts(), before)]
                _add_counts(counts, -1)
        self._graph, self._counts = graph, counts
        stats.record("captures")

    def close(self) -> None:
        """Free the graph (and its pool) and let go of the closure."""
        if self._graph is not None:
            with DEVICE_LOCK:
                self._graph.reset()
        self._graph = self.body = self.outputs = None


class ForwardProgram(GraphProgram):
    """A classifier's forward ``model(*example)`` at the example's shapes,
    the twin of the JAX handlers' compiled forward (``_aot_or_jit``): on
    the card a CUDA graph captured when the program is made and replayed
    by every call at those shapes; a call at other shapes runs the model
    eagerly, as JAX's dispatch falls back to ``jax.jit``. On the CPU, or
    with ``graphs=False``, example-shaped calls run the same body eagerly.
    :attr:`mode` is ``"graph"`` or ``"eager"`` (the handlers'
    ``meta["aot"]``). Calls hold :data:`DEVICE_LOCK`: the program's input
    and output buffers are shared."""

    def __init__(self, model, example: tuple, *, graphs: bool = True,
                 graph_type=None):
        self.example = tuple(example)
        self.inputs = tuple(t.clone() for t in example)
        if graph_type is None and graphs and model.device.type == "cuda":
            graph_type = CudaGraph
        super().__init__(self._forward, model, example[0].shape[0],
                         graph_type, GraphStats())
        self.other_shapes = 0
        if self.uses_graph:
            self(*self.example)  # the capture, now

    @property
    def mode(self) -> str:
        return "graph" if self.uses_graph else "eager"

    def _forward(self):
        with torch.no_grad():
            return (self.model(*self.inputs),)

    def prepare(self) -> None:
        # one eager forward on the capture stream: cuDNN's and cuBLAS's
        # first calls at these shapes (handles, workspaces, the choice of
        # algorithm) must not land in the capture
        self._forward()

    def __call__(self, *args) -> torch.Tensor:
        """The model's output for ``args`` (host or device tensors, cast
        to the example's dtypes), as a host tensor of its own: the next
        call overwrites the program's output buffer, on the CPU too."""
        with DEVICE_LOCK:
            if [a.shape for a in args] == [t.shape for t in self.inputs]:
                for buf, a in zip(self.inputs, args):
                    buf.copy_(a)
                self.run()
                out = self.outputs[0]
            else:
                with torch.no_grad():
                    out = self.model(*(a.to(t.device, t.dtype) for a, t in
                                       zip(args, self.inputs)))
                self.other_shapes += 1
            return out.to("cpu", copy=True)

    def report(self) -> dict:
        """``mode``; ``compile_count`` (captures), ``replays``,
        ``eager_runs`` (example-shaped calls run eagerly) and
        ``other_shapes`` (calls at other shapes)."""
        s = self.stats.report()
        return {"mode": self.mode, "compile_count": s["compile_count"],
                "replays": s["replays"], "eager_runs": s["eager_steps"],
                "other_shapes": self.other_shapes}


class StepProgram(GraphProgram):
    """One decode step of ``step`` (greedy or ``sampled``): a
    :class:`GraphProgram` over the step's buffers."""

    def __init__(self, step, sampled: bool, graph_type, stats: GraphStats):
        super().__init__(lambda: step.step(sampled), step.model, step.rows,
                         graph_type, stats)
        self.step = step

    def close(self) -> None:
        super().close()
        self.step = None


class ProgramSet:
    """Programs made on first use, under keys of the caller's (a prefill
    width, greedy or sampled), and the device memory they hold: their
    graphs' pools and :meth:`buffer_bytes`. The unit a :class:`ProgramCache`
    holds, checks out and evicts; ``counted`` says whether it counts
    toward the cache's entry bound (decode entries do; an engine's prefill
    programs and a walk's window count by their bytes alone)."""

    counted = False

    def __init__(self):
        self.programs: dict = {}

    def program(self, key: tuple, make):
        """The program of ``key``, made by ``make()`` on first use."""
        if key not in self.programs:
            self.programs[key] = make()
        return self.programs[key]

    def modes(self) -> list[str]:
        """Its decode programs' modes (none here)."""
        return []

    def buffer_bytes(self) -> int:
        return 0

    def pool_report(self) -> list:
        """``(key, pool bytes)`` of every program."""
        return [(key, prog.pool_bytes) for key, prog in self.programs.items()]

    def nbytes(self) -> int:
        """Device bytes held: the buffers and the graphs' pools."""
        return self.buffer_bytes() + sum(p for _, p in self.pool_report())

    def close(self) -> None:
        """Free the graphs (and their pools)."""
        for prog in self.programs.values():
            prog.close()
        self.programs = {}


class StepPrograms(ProgramSet):
    """A :class:`~lambdipy_tpu_torch.models.llama.DecodeStep` (its buffers
    and decode cache) with its greedy and its sampled :class:`StepProgram`
    and the prefills that load it (``programs``: the serving prefill per
    prompt width, the prefix continuation per suffix width, each greedy
    or sampled), each made on first use: one cache, its programs. The unit
    both the server's :class:`ProgramCache` and the continuous engine
    hold."""

    counted = True

    def __init__(self, step, graph_type, stats: GraphStats):
        super().__init__()
        self.step = step
        self.graph_type = graph_type
        self.stats = stats
        self._steps: dict[bool, StepProgram] = {}

    def decode(self, sampled: bool) -> StepProgram:
        """The greedy or sampled decode program."""
        sampled = bool(sampled)
        if sampled not in self._steps:
            self._steps[sampled] = StepProgram(self.step, sampled,
                                               self.graph_type, self.stats)
        return self._steps[sampled]

    def modes(self) -> list[str]:
        return ["sampled" if s else "greedy" for s in sorted(self._steps)]

    def graph(self, sampled: bool):
        """The captured graph of the greedy or sampled program, or None."""
        prog = self._steps.get(bool(sampled))
        return prog._graph if prog is not None else None

    def buffer_bytes(self) -> int:
        return 0 if self.step is None else self.step.nbytes()

    def pool_report(self) -> list:
        return [(("decode", "sampled" if s else "greedy"), p.pool_bytes)
                for s, p in self._steps.items()] + super().pool_report()

    def close(self) -> None:
        """Free the graphs (and their pools) and let go of the step."""
        for prog in self._steps.values():
            prog.close()
        super().close()
        self._steps, self.step = {}, None


class ProgramCache:
    """``LlamaServer``'s programs: an LRU of :class:`ProgramSet` entries
    (decode entries, :class:`StepPrograms`, keyed by everything but greedy
    or sampled; an engine's prefill programs of one shape; a walk's
    window), bounded by a count of decode entries (``max_entries``, the
    JAX server's ``program_cache_max``) and by the device bytes all the
    entries hold, graph pools included (``max_bytes``, None = no bound),
    since an entry owns a decode cache whose size grows with its key and
    a prefill's pool keeps the prefill's peak.

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

    def checkout(self, key, nbytes: int, make,
                 counted: bool = True) -> ProgramSet:
        """An idle entry of ``key``, or a new one from ``make()`` that
        takes about ``nbytes`` and counts toward ``max_entries`` when
        ``counted`` (caller holds :data:`DEVICE_LOCK`)."""
        with self._lock:
            for eid, (k, entry) in reversed(self._idle.items()):
                if k == key:
                    del self._idle[eid]
                    self._busy[eid] = (k, entry)
                    return entry
        self._evict(incoming=nbytes, counted=counted)
        try:
            entry = make()
        except torch.OutOfMemoryError:
            if not self.drop_idle():
                raise
            entry = make()
        with self._lock:
            self._busy[id(entry)] = (key, entry)
        return entry

    def checkin(self, entry: ProgramSet) -> None:
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
        return (sum(e.counted for e in entries),
                sum(e.nbytes() for e in entries))

    def _evict(self, incoming: int | None = None,
               counted: bool = True) -> None:
        """Evict idle entries, oldest first, until the held entries (and
        an ``incoming`` one of that many bytes, a decode entry when
        ``counted``) fit both bounds."""
        extra = int(incoming is not None and counted)
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
        """Every decode program's key: the entry's key and greedy or
        sampled."""
        with self._lock:
            items = [*self._idle.values(), *self._busy.values()]
        return sorted(((*k, mode) for k, e in items for mode in e.modes()),
                      key=repr)

    def pools(self) -> list:
        """Every program's key (the entry's and the program's) and the
        bytes of its graph's pool."""
        with self._lock:
            items = [*self._idle.values(), *self._busy.values()]
        return sorted(([*k, *pk, pool] for k, e in items
                       for pk, pool in e.pool_report()), key=repr)

    def nbytes(self) -> int:
        """Device bytes the entries hold: their caches and graph pools."""
        with self._lock:
            return self._held()[1]
