"""The multi-process data contract, the twin of
``lambdipy_tpu/parallel/distributed.py:136-147``: each process reads an
equal, contiguous share of every global batch. The process count and
index are ``torch.distributed``'s world size and rank once a process
group is initialized, and one and zero otherwise (``jax.process_count``
and ``jax.process_index`` on one host)."""

from __future__ import annotations


def _group():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def process_count() -> int:
    dist = _group()
    return dist.get_world_size() if dist is not None else 1


def process_index() -> int:
    dist = _group()
    return dist.get_rank() if dist is not None else 0


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
