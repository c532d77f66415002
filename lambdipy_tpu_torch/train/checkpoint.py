"""Training checkpoint and resume, the twin of
``lambdipy_tpu/train/checkpoint.py``, in the port's own format (orbax is
JAX's and is not a dependency of the port).

A checkpoint of step ``n`` is the directory ``<dir>/<n>/``:

- ``state.fpk``: every tensor of the state (params, optimizer state, the
  step counter) in one flatpack file (``bundle/flatpack.py``), keyed by
  its path in the state tree joined by ``/``;
- ``meta.json``: every other leaf (the loader's integers) by the same
  paths.

A save writes into ``<dir>/.tmp-<n>-<pid>/`` and renames it to ``<n>``
when both files are whole, so a crash mid-save leaves the last checkpoint
whole; a leftover temporary directory is removed when a checkpointer
opens ``<dir>``. The cadence is orbax's ``CheckpointManager``'s:
``save`` saves when ``force`` is set, or when the step is past the latest
one and either a multiple of ``save_interval_steps`` or the first save
of the directory; a step already saved raises; after each save the
oldest steps beyond ``max_to_keep`` are deleted. Saves are synchronous
(orbax's are asynchronous): ``wait`` and ``close`` have nothing to wait
for. ``restore`` reads onto the template's devices and raises where the
template's keys, shapes or dtypes are not the checkpoint's.

One rank of a mesh (``shardings``, the train step's): a save gathers
each sharded leaf in turn over the process group, rank 0 moves it to the
host at once and the other ranks drop it (a rank's device holds its
blocks and one gathered leaf, not the whole state), rank 0 alone writes
the whole state in the format above, and every rank meets the others at
a barrier before the save returns; a restore reads the whole state and
takes this rank's block of each sharded leaf. The format is one device's either
way, so a checkpoint written by N ranks restores in one process and the
reverse.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from pathlib import Path

import torch

from lambdipy_tpu_torch.bundle import flatpack
from lambdipy_tpu_torch.parallel.distributed import barrier
from lambdipy_tpu_torch.parallel.sharding import leaf_sharding
from lambdipy_tpu_torch.utils.logs import get_logger, log_event

log = get_logger("lambdipy.train.ckpt")

STATE_FILE = "state.fpk"
META_FILE = "meta.json"
_TMP = ".tmp-"


def tree_paths(tree, prefix: tuple = ()):
    """(path, leaf) pairs of a tree of dicts and dataclasses (a
    ``TrainState``), keys in sorted order: tensors and plain leaves
    alike."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = {f.name: getattr(tree, f.name)
                for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], prefix + (str(k),))
    else:
        yield prefix, tree


def _unflatten(template, values: dict, prefix: tuple = ()):
    """``template`` rebuilt with its leaves taken from ``values`` (by
    path)."""
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f.name: _unflatten(getattr(template, f.name), values,
                               prefix + (f.name,))
            for f in dataclasses.fields(template)})
    if isinstance(template, dict):
        return {k: _unflatten(v, values, prefix + (str(k),))
                for k, v in template.items()}
    return values["/".join(prefix)]


class TrainCheckpointer:
    """Periodic save / latest-restore of a train state tree (a dict
    holding a ``TrainState`` and the loader's state)."""

    def __init__(self, directory: Path | str, *, max_to_keep: int = 3,
                 save_interval_steps: int = 1,
                 shardings: dict | None = None):
        from lambdipy_tpu_torch.parallel.distributed import process_index

        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self.shardings = shardings
        # the rank that writes (every rank keeps the same step list)
        self.primary = shardings is None or process_index() == 0
        steps = []
        for p in self.directory.iterdir():
            if p.name.startswith(_TMP):
                if self.primary:  # a save that died
                    shutil.rmtree(p, ignore_errors=True)
            elif p.is_dir() and p.name.isdigit():
                steps.append(int(p.name))
        self._steps = sorted(steps)

    def should_save(self, step: int) -> bool:
        """orbax's decision: past the latest step, and on the interval or
        the directory's first save."""
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        return (step % self.save_interval_steps == 0) or not self._steps

    def save(self, step: int, state, *, force: bool = False) -> bool:
        """Save ``state`` as step ``step`` when the cadence (or ``force``)
        says so; returns whether it saved."""
        if not force and not self.should_save(step):
            return False
        if step in self._steps:
            raise ValueError(f"Checkpoint for step {step} already exists.")
        tensors, meta = {}, {}
        for path, leaf in tree_paths(state):
            key = "/".join(path)
            if not torch.is_tensor(leaf):
                meta[key] = leaf
                continue
            sharding = leaf_sharding(path, leaf, self.shardings)
            if sharding is None or sharding.replicated:
                tensors[key] = leaf.detach()
                continue
            # a collective every rank joins, one leaf at a time: the whole
            # leaf goes to the host at once on the writer and is dropped on
            # the others, so no rank holds more than one gathered leaf
            whole = sharding.gather(leaf.detach())
            if self.primary:
                tensors[key] = whole.cpu()
            del whole
        if self.primary:
            tmp = self.directory / f"{_TMP}{step}-{os.getpid()}"
            shutil.rmtree(tmp, ignore_errors=True)
            tmp.mkdir()
            flatpack.save(tmp / STATE_FILE, tensors)
            (tmp / META_FILE).write_text(json.dumps(meta, sort_keys=True))
            os.replace(tmp, self.directory / str(step))
        self._steps = sorted(self._steps + [step])
        excess = max(0, len(self._steps)
                     - (self.max_to_keep or len(self._steps)))
        if self.primary:
            for old in self._steps[:excess]:
                shutil.rmtree(self.directory / str(old), ignore_errors=True)
        self._steps = self._steps[excess:]
        if self.shardings is not None:
            barrier()
        log_event(log, "checkpoint save", step=step, dir=str(self.directory))
        return True

    def latest_step(self) -> int | None:
        return self._steps[-1] if self._steps else None

    def all_steps(self) -> list[int]:
        return list(self._steps)

    def restore(self, state_template, step: int | None = None):
        """Restore ``step`` (default: the latest) shaped like the template,
        each tensor on its template leaf's device. Returns ``(state,
        step)``, or ``(None, None)`` when the directory holds none. Raises
        ``ValueError`` on a key the template and the checkpoint do not
        share, or a shape or dtype that differs."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        where = self.directory / str(step)
        want = dict(tree_paths(state_template))
        meta = json.loads((where / META_FILE).read_text())
        devices = {v.device for v in want.values() if torch.is_tensor(v)}
        card = (next(iter(devices))
                if len(devices) == 1 and self.shardings is None else None)
        loaded = (flatpack.device_load(where / STATE_FILE, card)
                  if card is not None and card.type == "cuda"
                  else flatpack.load_state_dict(where / STATE_FILE))
        tensor_keys = {"/".join(p) for p, v in want.items()
                       if torch.is_tensor(v)}
        other_keys = {"/".join(p) for p, v in want.items()
                      if not torch.is_tensor(v)}
        if tensor_keys != set(loaded) or other_keys != set(meta):
            missing = sorted((tensor_keys - set(loaded))
                             | (other_keys - set(meta)))
            extra = sorted((set(loaded) - tensor_keys)
                           | (set(meta) - other_keys))
            raise ValueError(f"checkpoint {where} does not fit the template: "
                             f"missing {missing[:5]}, unexpected {extra[:5]}")
        values = dict(meta)
        for path, ref in want.items():
            key = "/".join(path)
            if not torch.is_tensor(ref):
                continue
            t = loaded[key]
            sharding = leaf_sharding(path, ref, self.shardings)
            if sharding is not None:
                t = sharding.shard(t)
            if tuple(t.shape) != tuple(ref.shape) or t.dtype != ref.dtype:
                raise ValueError(
                    f"checkpoint {where}: {key} is {t.dtype} "
                    f"{tuple(t.shape)}, the template {ref.dtype} "
                    f"{tuple(ref.shape)}")
            # a host tensor views the file's mapping: copied out of it
            values[key] = t.to(ref.device, copy=t.device.type == "cpu")
        log_event(log, "checkpoint restore", step=step, dir=str(self.directory))
        return _unflatten(state_template, values), step

    def wait(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    def close(self) -> None:
        """Nothing to release."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
