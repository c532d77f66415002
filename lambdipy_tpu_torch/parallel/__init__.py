"""Parallelism of the port, the twin of ``lambdipy_tpu/parallel/``. For now
only the data-loading contract of ``parallel/distributed.py``
(:func:`~lambdipy_tpu_torch.parallel.distributed.process_batch_slice`);
meshes, sharding rules and the collectives come with tensor and sequence
parallelism over ``torch.distributed``."""

from lambdipy_tpu_torch.parallel.distributed import (process_batch_slice,
                                                     process_count,
                                                     process_index)

__all__ = ["process_batch_slice", "process_count", "process_index"]
