"""The process group of the port, the twin of
``lambdipy_tpu/parallel/distributed.py``: bootstrap from the environment,
hybrid meshes, the data-loading contract, and the few collectives the
port's data-parallel training runs.

JAX drives every device of a host from one process; the port runs one
process per device (a rank), over ``torch.distributed``: NCCL for card
ranks (rank ``r`` on ``cuda:LOCAL_RANK``), gloo for CPU ranks. The
environment is read as JAX reads its own: the port's
``LAMBDIPY_COORDINATOR`` / ``LAMBDIPY_NUM_PROCESSES`` /
``LAMBDIPY_PROCESS_ID`` first, then torchrun's ``MASTER_ADDR:MASTER_PORT``
/ ``WORLD_SIZE`` / ``RANK`` in place of JAX's ``JAX_*`` names. A
coordinator is ``host:port`` (a TCP store) or a URL (``tcp://...``,
``file:///path``, the latter for ranks on one host that share no port).

Each process reads an equal, contiguous share of every global batch
(:func:`process_batch_slice`); the process count and index are the
group's world size and rank once a group is up, one and zero otherwise
(``jax.process_count`` and ``jax.process_index`` on one host).

A serving mesh's tensor-parallel ranks are a :class:`TPGroup`
(:func:`tp_group`), apart from the default group: the collectives the
model runs over it (:func:`tp_all_reduce`, a gather and then a sum in
rank order; :func:`tp_all_gather`) and a command channel of its own
(``parallel/tpserve.py``).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np

from lambdipy_tpu_torch.parallel.mesh import MESH_AXES, Mesh
from lambdipy_tpu_torch.utils.logs import get_logger, log_event

log = get_logger("lambdipy.distributed")

# environment (first hit wins): the port's names, then torchrun's
_NPROC_VARS = ("LAMBDIPY_NUM_PROCESSES", "WORLD_SIZE")
_PID_VARS = ("LAMBDIPY_PROCESS_ID", "RANK")


@dataclass(frozen=True)
class DistributedContext:
    """What this process knows about the job after bootstrap (JAX's
    fields, then the group's backend and this rank's device)."""

    initialized: bool  # did this call start the process group
    process_index: int
    process_count: int
    coordinator: str | None = None
    backend: str | None = None
    device: str | None = None

    @property
    def is_primary(self) -> bool:
        return self.process_index == 0


def _group():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def process_count() -> int:
    dist = _group()
    return dist.get_world_size() if dist is not None else 1


def process_index() -> int:
    dist = _group()
    return dist.get_rank() if dist is not None else 0


def _env_first(names) -> str | None:
    for n in names:
        v = os.environ.get(n)
        if v:
            return v
    return None


def _coordinator() -> str | None:
    coord = os.environ.get("LAMBDIPY_COORDINATOR")
    if coord:
        return coord
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    return f"{addr}:{port}" if addr and port else None


def initialize_from_env(*, timeout_s: float | None = None,
                        device=None) -> DistributedContext:
    """Start the process group when the environment describes a job of
    more than one process (a coordinator and a process count above 1);
    one process, or a group already up, is a no-op, as in JAX.
    ``device="cpu"`` starts gloo; otherwise the rank is a card rank: NCCL,
    and ``cuda:LOCAL_RANK`` made the current device (``LOCAL_RANK``
    unset: the rank modulo the host's cards)."""
    import torch
    import torch.distributed as dist

    coord = _coordinator()
    nproc = _env_first(_NPROC_VARS)
    pid = _env_first(_PID_VARS)
    if _group() is not None:
        return DistributedContext(False, dist.get_rank(),
                                  dist.get_world_size(), coord,
                                  dist.get_backend())
    if coord and nproc and int(nproc) > 1:
        if pid is None:
            raise ValueError("a multi-process job needs this process's "
                             "index: LAMBDIPY_PROCESS_ID (or RANK)")
        cpu = device is not None and torch.device(device).type == "cpu"
        if cpu:
            backend, dev = "gloo", "cpu"
        else:
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device is available for a card "
                                   "rank; pass device='cpu' for gloo ranks")
            local = int(os.environ.get("LOCAL_RANK",
                                       int(pid) % torch.cuda.device_count()))
            torch.cuda.set_device(local)
            backend, dev = "nccl", f"cuda:{local}"
        kwargs = {}
        if timeout_s is not None:
            import datetime

            kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
        dist.init_process_group(
            backend, init_method=coord if "://" in coord else f"tcp://{coord}",
            world_size=int(nproc), rank=int(pid), **kwargs)
        log_event(log, "distributed init", coordinator=coord,
                  nproc=int(nproc), backend=backend)
        return DistributedContext(True, dist.get_rank(),
                                  dist.get_world_size(), coord, backend, dev)
    return DistributedContext(False, 0, 1, coord)


def shutdown() -> None:
    """Destroy the process group, when one is up."""
    dist = _group()
    if dist is not None:
        dist.destroy_process_group()


def make_hybrid_mesh(ici: dict[str, int], dcn: dict[str, int] | None = None,
                     devices=None) -> Mesh:
    """A mesh whose per-axis size is ``ici[a] * dcn[a]``, ranks laid out so
    the dcn factor of every axis is outermost (slice-major), JAX's layout
    with contiguous rank blocks standing in for slices. ``devices`` are
    global ranks (default: every rank of the group)."""
    dcn = dict(dcn or {})
    unknown = (set(ici) | set(dcn)) - set(MESH_AXES)
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)}; known: {MESH_AXES}")
    devices = list(devices if devices is not None
                   else range(process_count()))
    axes = [a for a in MESH_AXES
            if ici.get(a, 1) * dcn.get(a, 1) > 1] or ["dp"]
    sizes = {a: ici.get(a, 1) * dcn.get(a, 1) for a in axes}
    if math.prod(sizes.values()) != len(devices):
        raise ValueError(
            f"hybrid mesh {sizes} needs {math.prod(sizes.values())} devices, "
            f"have {len(devices)}")
    if math.prod(dcn.values()) == 1:
        arr = np.asarray(devices).reshape([sizes[a] for a in axes])
        return Mesh(arr, tuple(axes))
    dshape = [dcn.get(a, 1) for a in axes]
    ishape = [ici.get(a, 1) for a in axes]
    arr = np.asarray(devices).reshape(dshape + ishape)
    n = len(axes)
    arr = arr.transpose([x for i in range(n) for x in (i, n + i)])
    arr = arr.reshape([d * i for d, i in zip(dshape, ishape)])
    return Mesh(arr, tuple(axes))


def process_batch_slice(global_batch: int, *, process_index: int | None = None,
                        process_count: int | None = None) -> tuple[int, int]:
    """(local_batch, offset) for this process's equal share of a global
    batch, the contract ``data/loader.py`` derives its shards from.
    Overrides exist for tests and explicit launchers; the defaults read
    ``torch.distributed``."""
    n = process_count if process_count is not None else _count()
    i = process_index if process_index is not None else _index()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} "
                         "processes")
    local = global_batch // n
    return local, local * i


# the keyword arguments above shadow the module's functions
_count, _index = process_count, process_index


# -- collectives (rank order) -------------------------------------------------
#
# ``group=None`` is the whole process group (data-parallel training);
# a :class:`TPGroup` is a serving mesh's tensor-parallel ranks, whose sum
# is :func:`tp_all_reduce`.


def all_gather(t, group: "TPGroup | None" = None):
    """Every rank's ``t``, in rank order (each rank's of one shape). Over a
    :class:`TPGroup` whose backend cannot gather a tensor where it lies
    (gloo on the card), the gather is staged through host memory,
    explicitly: down, gathered, and back to ``t``'s device."""
    import torch

    if group is not None:
        if group.size == 1:
            return [t]
        src = t.contiguous()
        if group.staged(src):
            src = src.cpu()
        out = [torch.empty_like(src) for _ in range(group.size)]
        group.wait(group.pg.allgather([out], [src]))
        return [o.to(t.device, non_blocking=True) for o in out] \
            if out[0].device != t.device else out
    import torch.distributed as dist

    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return out


def reduce_scatter(t, dim: int):
    """The sum over the ranks of ``t``, split into world-size blocks along
    ``dim``; this rank's block."""
    import torch
    import torch.distributed as dist

    blocks = [b.contiguous() for b in t.chunk(dist.get_world_size(), dim)]
    out = torch.empty_like(blocks[0])
    dist.reduce_scatter(out, blocks)
    return out


def all_reduce(t):
    """The sum over the ranks of ``t``, in place; returns ``t``."""
    import torch.distributed as dist

    dist.all_reduce(t)
    return t


def tp_all_reduce(t, group: "TPGroup | None"):
    """The sum of every tensor-parallel rank's ``t`` (a row-parallel
    projection's partial product, a masked embedding's rows): the
    partials gathered, then added in rank order in ``t``'s dtype. The sum
    does not depend on the batch or on the backend's reduction algorithm,
    so a row's result is bitwise its result alone, on gloo and NCCL
    alike. One rank (or no group): ``t`` itself, no collective."""
    if group is None or group.size == 1:
        return t
    parts = all_gather(t, group)
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


def tp_all_gather(t, group: "TPGroup | None"):
    """Every tensor-parallel rank's ``t`` concatenated along the last dim,
    in rank order (the vocabulary-parallel lm_head's logits). One rank (or
    no group): ``t`` itself."""
    import torch

    if group is None or group.size == 1:
        return t
    return torch.cat(all_gather(t, group), dim=-1)


def barrier() -> None:
    import torch.distributed as dist

    dist.barrier()


# -- a serving mesh's tensor-parallel group ---------------------------------

# collectives of a tensor-parallel group give up after this many seconds: a
# rank that stopped answering fails the call instead of hanging it; a rank
# that died fails it at once (its sockets close)
TP_TIMEOUT_S = 300.0


class TPGroup:
    """The tensor-parallel ranks of a serving mesh, one process per device:
    ``pg``, the backend the model's collectives run on (NCCL between
    cards, gloo on the CPU, or gloo on the card when two ranks share one,
    which NCCL refuses), and ``cmd``, the command channel, a CPU gloo
    group beside it (``parallel/tpserve.py``). One rank has neither:
    every collective is the identity, so a one-rank group serves bitwise
    as no group. Both are bare backends on a store of their own, not the
    process's default group: a serving mesh leaves ``torch.distributed``'s
    global state alone (a test process may hold several in turn).

    ``active()`` is true on a thread inside a dispatched call (and always
    on a follower): a model forward outside one would pair its
    collectives with nothing, so it raises instead."""

    def __init__(self, rank: int, size: int, *, pg=None, cmd=None,
                 backend: str | None = None, device=None, store=None):
        import threading

        self.rank, self.size = int(rank), int(size)
        self.pg, self.cmd, self.backend = pg, cmd, backend
        self.device = device
        self.store = store
        self._local = threading.local()
        self.follower = False

    def staged(self, t) -> bool:
        """A gather of ``t`` goes through host memory (gloo on the card)."""
        return self.backend == "gloo" and t.is_cuda

    def wait(self, work) -> None:
        import datetime

        work.wait(datetime.timedelta(seconds=TP_TIMEOUT_S))

    def active(self) -> bool:
        return self.follower or getattr(self._local, "depth", 0) > 0

    def enter(self) -> None:
        self._local.depth = getattr(self._local, "depth", 0) + 1

    def leave(self) -> None:
        self._local.depth -= 1

    # -- the command channel (rank 0 sends, every other rank receives) -----

    def send_command(self, obj) -> None:
        """Broadcast ``obj`` (pickled) from rank 0 on ``cmd``."""
        import pickle

        import torch

        payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        n = torch.tensor([len(payload)], dtype=torch.int64)
        self.cmd.broadcast(n, 0).wait()
        buf = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
        self.cmd.broadcast(buf, 0).wait()

    def recv_command(self):
        """The next object rank 0 broadcast on ``cmd`` (blocks while the
        controller is idle; raises once it is gone)."""
        import pickle

        import torch

        n = torch.zeros(1, dtype=torch.int64)
        self.cmd.broadcast(n, 0).wait()
        buf = torch.empty(int(n[0]), dtype=torch.uint8)
        self.cmd.broadcast(buf, 0).wait()
        return pickle.loads(buf.numpy().tobytes())

    def send_to(self, rank: int, obj) -> None:
        """``obj`` to one rank, point to point on ``cmd`` (torch.save:
        tensors go as they are, a rank's weight shard)."""
        import io

        import torch

        out = io.BytesIO()
        torch.save(obj, out)
        payload = out.getbuffer()
        self.cmd.send([torch.tensor([len(payload)], dtype=torch.int64)],
                      rank, 1).wait()
        self.cmd.send([torch.frombuffer(payload, dtype=torch.uint8)],
                      rank, 2).wait()

    def recv_from(self, rank: int):
        import io

        import torch

        n = torch.zeros(1, dtype=torch.int64)
        self.cmd.recv([n], rank, 1).wait()
        buf = torch.empty(int(n[0]), dtype=torch.uint8)
        self.cmd.recv([buf], rank, 2).wait()
        return torch.load(io.BytesIO(buf.numpy().tobytes()),
                          weights_only=False)

    def gather_ints(self, value: int) -> list[int]:
        """Every rank's ``value`` (an int64) in rank order, on ``cmd``."""
        import torch

        if self.size == 1:
            return [int(value)]
        mine = torch.tensor([int(value)], dtype=torch.int64)
        out = [torch.empty_like(mine) for _ in range(self.size)]
        self.cmd.allgather([out], [mine]).wait()
        return [int(o[0]) for o in out]

    def close(self) -> None:
        for pg in (self.pg, self.cmd):
            if pg is not None:
                try:
                    pg.shutdown()
                except Exception:  # noqa: BLE001 — a peer already gone
                    pass
        self.pg = self.cmd = None


def tp_group(init: str, rank: int, size: int, *, device=None,
             backend: str | None = None) -> TPGroup:
    """Join the tensor-parallel group of ``size`` ranks that meets at
    ``init`` (``file:///path``, a store on this host's disk) as
    ``rank``. ``backend``: the collectives' (default: NCCL for a card
    rank, gloo for a CPU one; ``"gloo"`` on the card stages its gathers
    through host memory). The command channel is always gloo. Collectives
    time out after :data:`TP_TIMEOUT_S`; the command channel waits as long
    as the controller idles, and fails once it is gone."""
    import datetime

    import torch
    import torch.distributed as dist

    if not init.startswith("file://"):
        raise ValueError(f"a tensor-parallel group meets at a file:// "
                         f"store, got {init!r}")
    device = torch.device(device) if device is not None else None
    if backend is None:
        backend = ("nccl" if device is not None and device.type == "cuda"
                   else "gloo")
    store = dist.FileStore(init[len("file://"):], size)
    timeout = datetime.timedelta(seconds=TP_TIMEOUT_S)
    pg = cmd = None
    if backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timeout
        pg = dist.ProcessGroupNCCL(dist.PrefixStore("tp", store), rank,
                                   size, opts)
    elif size > 1:
        pg = dist.ProcessGroupGloo(dist.PrefixStore("tp", store), rank,
                                   size, timeout)
    if size > 1:
        # an idle server's followers wait here for days; a controller
        # that exits closes the sockets, which ends the wait at once
        cmd = dist.ProcessGroupGloo(dist.PrefixStore("cmd", store), rank,
                                    size, datetime.timedelta(days=30))
    log_event(log, "tp group", rank=rank, size=size, backend=backend)
    return TPGroup(rank, size, pg=pg, cmd=cmd, backend=backend,
                   device=device, store=store)
