"""Deterministic sharded data loading for LM training, the twin of
``lambdipy_tpu/data/loader.py``.

- **Index-based**: an epoch is a seeded permutation of example indices
  (``np.random.default_rng((seed, epoch)).permutation``, JAX's), so batch
  ``t`` is a pure function of ``(seed, epoch, t)`` and bitwise the JAX
  loader's; the loader's whole state is three integers.
- **Process-sharded**: each process reads its ``global_batch /
  process_count`` slice of every batch
  (:func:`~lambdipy_tpu_torch.parallel.distributed.process_batch_slice`).
- **Static shapes**: fixed ``[batch, seq_len + 1]`` windows (the +1 feeds
  the shift-by-one LM objective of ``train/step.py``); partial tail
  windows and a partial last batch are dropped.

:meth:`ShardedLoader.place` puts this process's rows on its device as an
int64 tensor. JAX's ``place(batch, mesh, batch_sharding)`` assembles one
global array from every process's rows
(``make_array_from_process_local_data``); the port runs one process per
device, so each rank places its own rows and the global batch is the
ranks' rows concatenated in rank order.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from lambdipy_tpu_torch.parallel.distributed import (process_batch_slice,
                                                     process_count,
                                                     process_index)
from lambdipy_tpu_torch.utils.platform import resolve_device


class TokenSource:
    """A flat token array exposed as fixed-length example windows.

    Accepts an in-memory array or a ``.npy`` / raw binary file (memory-
    mapped, so multi-GB corpora don't load into RAM). Window n is
    ``tokens[n*stride : n*stride + seq_len + 1]``; stride defaults to
    ``seq_len`` (disjoint windows, +1 overlap for the LM target shift).
    """

    def __init__(self, tokens, seq_len: int, *, stride: int | None = None,
                 dtype=np.int32):
        if isinstance(tokens, (str, Path)):
            path = Path(tokens)
            if path.suffix == ".npy":
                self.tokens = np.load(path, mmap_mode="r")
            else:
                self.tokens = np.memmap(path, dtype=dtype, mode="r")
        else:
            self.tokens = np.asarray(tokens)
        if self.tokens.ndim != 1:
            raise ValueError(f"token source must be 1-D, got {self.tokens.shape}")
        self.seq_len = int(seq_len)
        self.stride = int(stride or seq_len)
        window = self.seq_len + 1
        n = (len(self.tokens) - window) // self.stride + 1
        if n <= 0:
            raise ValueError(
                f"{len(self.tokens)} tokens < one window of {window}")
        self.num_examples = n

    def __len__(self) -> int:
        return self.num_examples

    def __getitem__(self, idx: int) -> np.ndarray:
        start = int(idx) * self.stride
        return np.asarray(self.tokens[start:start + self.seq_len + 1],
                          dtype=np.int32)


@dataclass
class LoaderState:
    """The complete resume state: three integers (the seed among them)."""

    seed: int
    epoch: int
    step_in_epoch: int

    def as_dict(self) -> dict:
        return {"seed": self.seed, "epoch": self.epoch,
                "step_in_epoch": self.step_in_epoch}

    @classmethod
    def from_dict(cls, d: dict) -> "LoaderState":
        return cls(seed=int(d["seed"]), epoch=int(d["epoch"]),
                   step_in_epoch=int(d["step_in_epoch"]))


class ShardedLoader:
    """Deterministic epoch-shuffled batches, sharded across processes.

    ``next_batch()`` returns this process's ``[local_batch, seq_len+1]``
    int32 slice of the global batch (a host array, bitwise JAX's);
    :meth:`place` puts it on the device."""

    def __init__(self, source: TokenSource, global_batch: int, *,
                 seed: int = 0, shuffle: bool = True,
                 process_index: int | None = None,
                 process_count: int | None = None):
        self.source = source
        self.global_batch = int(global_batch)
        self.shuffle = shuffle
        self._pc = (process_count if process_count is not None
                    else _count())
        self._pi = (process_index if process_index is not None
                    else _index())
        self.local_batch, self._offset = process_batch_slice(
            self.global_batch, process_index=self._pi,
            process_count=self._pc)
        if len(source) < self.global_batch:
            raise ValueError(
                f"{len(source)} examples < one global batch of {global_batch}")
        self.state = LoaderState(seed=int(seed), epoch=0, step_in_epoch=0)
        self._perm_epoch: int | None = None
        self._perm: np.ndarray | None = None

    @property
    def steps_per_epoch(self) -> int:
        return len(self.source) // self.global_batch  # partial tail dropped

    def _permutation(self, epoch: int) -> np.ndarray:
        if self._perm_epoch != epoch:
            if self.shuffle:
                rng = np.random.default_rng((self.state.seed, epoch))
                self._perm = rng.permutation(len(self.source))
            else:
                self._perm = np.arange(len(self.source))
            self._perm_epoch = epoch
        return self._perm

    def next_batch(self) -> np.ndarray:
        """This process's shard of the next global batch (advances state)."""
        st = self.state
        if st.step_in_epoch >= self.steps_per_epoch:
            st.epoch += 1
            st.step_in_epoch = 0
        perm = self._permutation(st.epoch)
        base = st.step_in_epoch * self.global_batch + self._offset
        idxs = perm[base:base + self.local_batch]
        st.step_in_epoch += 1
        return np.stack([self.source[i] for i in idxs])

    def place(self, batch: np.ndarray, mesh=None, batch_sharding=None, *,
              device=None) -> torch.Tensor:
        """This process's rows ``batch`` as an int64 tensor on ``device``
        (the card unless the caller asks for the CPU): its block of the
        global batch, which is every process's rows in rank order. ``mesh``
        and ``batch_sharding`` are JAX's arguments: a mesh
        (:func:`~lambdipy_tpu_torch.parallel.mesh.job_mesh`) has as many
        devices as the job has processes, the loader is sharded over them,
        and a ``batch_sharding`` is a ``NamedSharding`` of that mesh or
        the device itself."""
        from lambdipy_tpu_torch.parallel.mesh import job_mesh
        from lambdipy_tpu_torch.parallel.sharding import NamedSharding

        if isinstance(batch_sharding, NamedSharding):
            mesh = mesh if mesh is not None else batch_sharding.mesh
            batch_sharding = None
        job_mesh(mesh)
        if self._pc != _count():
            raise ValueError(f"this loader shards over {self._pc} processes; "
                             f"the job has {_count()}")
        if batch_sharding is not None:
            if not isinstance(batch_sharding, (str, torch.device)):
                raise TypeError(f"batch_sharding {batch_sharding!r} is "
                                "neither a NamedSharding nor a device")
            if device is not None and torch.device(batch_sharding) \
                    != torch.device(device):
                raise ValueError(f"batch_sharding {batch_sharding} is not "
                                 f"the device {device}")
            device = batch_sharding
        dev = resolve_device(device)
        return torch.from_numpy(np.asarray(batch, np.int64)).to(dev)

    # -- resume -------------------------------------------------------------

    def state_dict(self) -> dict:
        return self.state.as_dict()

    def restore(self, state: dict) -> None:
        self.state = LoaderState.from_dict(state)
        self._perm_epoch = None  # force re-derivation from (seed, epoch)


# the keyword arguments of ShardedLoader shadow the functions' names
_count, _index = process_count, process_index
