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


# -- collectives over the whole group (rank order) ---------------------------

def all_gather(t):
    """Every rank's ``t``, in rank order (each rank's of one shape)."""
    import torch
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


def barrier() -> None:
    import torch.distributed as dist

    dist.barrier()
