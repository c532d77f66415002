"""Input pipeline of the port, the twin of ``lambdipy_tpu/data/``:
deterministic, resumable, process-sharded batching of a token file."""

from lambdipy_tpu_torch.data.loader import (LoaderState, ShardedLoader,
                                            TokenSource)

__all__ = ["LoaderState", "ShardedLoader", "TokenSource"]
