"""Parallelism of the port, the twin of ``lambdipy_tpu/parallel/``: meshes
(``mesh.py``), sharding rules (``sharding.py``) and the process group with
its data-loading contract and collectives (``distributed.py``), one
process per device over ``torch.distributed``; and tensor-parallel
serving's controller and followers (``tpserve.py``, which has no JAX
twin). Training runs ``dp`` and FSDP over ``dp``; serving runs ``tp``.
Training's tensor parallelism and expert, sequence and pipeline
parallelism are ROADMAP queue 1, item 3 (c)-(f), and what tensor-parallel
serving does not carry yet is item 3 (c2); each raises, naming its
item."""

from lambdipy_tpu_torch.parallel.distributed import (DistributedContext,
                                                     initialize_from_env,
                                                     make_hybrid_mesh,
                                                     process_batch_slice,
                                                     process_count,
                                                     process_index)
from lambdipy_tpu_torch.parallel.mesh import (MESH_AXES, Mesh, make_mesh,
                                              parse_mesh_spec, use_mesh)
from lambdipy_tpu_torch.parallel.sharding import (NamedSharding,
                                                  PartitionSpec,
                                                  ShardingRules)

__all__ = ["DistributedContext", "MESH_AXES", "Mesh", "NamedSharding",
           "PartitionSpec", "ShardingRules", "initialize_from_env",
           "make_hybrid_mesh", "make_mesh", "parse_mesh_spec",
           "process_batch_slice", "process_count", "process_index",
           "use_mesh"]
