"""Sharding rules of the port, the twin of
``lambdipy_tpu/parallel/sharding.py``: parameter paths -> partition specs.

Models stay sharding-agnostic; the mapping from a weight to mesh axes
lives here. Rules are matched on the JAX path of a port key,
``"params/" + key.replace(".", "/")`` (``models/params.py
to_flax_tree``'s tree), so the registry's rules are JAX's glob for glob.
Every weight keeps its flax layout in the port except convolution
kernels (``models/params.py to_torch_layout``): a spec is worked out in
the flax layout and then permuted into the port's, so it names the same
dims as JAX's.

JAX places shards through XLA; the port runs one process per device, so
a sharded tensor is this rank's local block (:meth:`NamedSharding.shard`),
and :meth:`NamedSharding.gather` assembles the whole over the process
group. Shards must be even: a dim a spec splits is divisible by the
split.
"""

from __future__ import annotations

import fnmatch
import math
from dataclasses import dataclass

import torch

from lambdipy_tpu_torch.parallel.mesh import Mesh


class PartitionSpec(tuple):
    """JAX's ``PartitionSpec``: per dim, None (whole), an axis name, or a
    tuple of axis names (the dim split over their product, major first)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class ShardingRules:
    """Ordered (path-glob, PartitionSpec) rules; first match wins. Paths
    are JAX's '/'-joined tree paths, e.g.
    ``params/layer_0/q_proj/kernel`` (:func:`jax_path`)."""

    rules: tuple[tuple[str, P], ...]
    default: P = P()

    def spec_for(self, path: str) -> P:
        for pattern, spec in self.rules:
            if fnmatch.fnmatch(path, pattern):
                return spec
        return self.default


def jax_path(key: str) -> str:
    """The JAX tree path of a port key (``layer_0.q_proj.kernel`` ->
    ``params/layer_0/q_proj/kernel``)."""
    return "params/" + key.replace(".", "/")


# a convolution kernel: torch's [out, in, kh, kw] is flax's [kh, kw, in,
# out] with port dim i = flax dim _CONV[i]
_CONV = (3, 2, 0, 1)


def _is_conv(key: str, ndim: int) -> bool:
    return key.rsplit(".", 1)[-1] == "kernel" and ndim == 4


def flax_shape(key: str, shape) -> tuple[int, ...]:
    """``shape`` of the port's tensor ``key`` in flax's layout."""
    shape = tuple(int(s) for s in shape)
    if _is_conv(key, len(shape)):
        return tuple(shape[_CONV.index(j)] for j in range(4))
    return shape


def port_spec(key: str, spec: P) -> P:
    """A spec of flax's layout in the port's (convolution kernels
    permuted)."""
    if _is_conv(key, len(spec)):
        return P(*(spec[_CONV[i]] for i in range(4)))
    return spec


def _filter_spec(spec: P, mesh: Mesh, ndim: int) -> P:
    """Axes not in the mesh dropped (size-1 axes are not in a mesh
    :func:`~lambdipy_tpu_torch.parallel.mesh.make_mesh` builds), the spec
    truncated or padded to the rank, so one rule set works across mesh
    shapes (JAX's)."""
    names = set(mesh.axis_names)

    def keep(entry):
        if entry is None:
            return None
        if isinstance(entry, (tuple, list)):
            kept = tuple(e for e in entry if e in names)
            return kept if kept else None
        return entry if entry in names else None

    entries = [keep(e) for e in spec]
    entries = entries[:ndim] + [None] * max(0, ndim - len(entries))
    return P(*entries)


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


@dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh, JAX's ``NamedSharding``: where each rank's
    block of a tensor lies."""

    mesh: Mesh
    spec: P

    @property
    def replicated(self) -> bool:
        return all(e is None for e in self.spec)

    def parts(self, dim: int) -> int:
        """Blocks along ``dim``."""
        shape = self.mesh.shape
        return math.prod(shape[a] for a in _axes(self.spec[dim]))

    def blocks(self) -> int:
        """Blocks of the whole tensor (its logical size over a block's)."""
        return math.prod(self.parts(d) for d in range(len(self.spec)))

    def _index(self, rank: int, shape) -> tuple[slice, ...]:
        coords, sizes = self.mesh.coords(rank), self.mesh.shape
        index = []
        for dim, entry in enumerate(self.spec):
            n, i = 1, 0
            for axis in _axes(entry):  # major first, as JAX splits
                i, n = i * sizes[axis] + coords[axis], n * sizes[axis]
            if shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(shape)} does not "
                                 f"split evenly into {n} ({self.spec})")
            step = shape[dim] // n
            index.append(slice(i * step, (i + 1) * step))
        return tuple(index)

    def shard(self, tensor: torch.Tensor, rank: int | None = None):
        """``rank``'s block of the whole ``tensor`` (default: this
        process's rank): a tensor of its own, or ``tensor`` itself when
        the sharding is replicated."""
        if self.replicated:
            return tensor
        if rank is None:
            from lambdipy_tpu_torch.parallel.distributed import process_index

            rank = process_index()
        return tensor[self._index(rank, tensor.shape)].clone()

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's block (a collective over the
        process group; the mesh's ranks are the group's)."""
        if self.replicated:
            return local
        from lambdipy_tpu_torch.parallel.distributed import all_gather

        shape = [int(s) * self.parts(d) for d, s in enumerate(local.shape)]
        whole = local.new_empty(shape)
        for rank, block in enumerate(all_gather(local)):
            whole[self._index(rank, shape)] = block
        return whole


def named_sharding(mesh: Mesh, *entries) -> NamedSharding:
    return NamedSharding(mesh, _filter_spec(P(*entries), mesh, len(entries)))


def key_spec(key: str, shape, mesh: Mesh, rules: ShardingRules | None,
             augment=None) -> P:
    """The spec of the port's tensor ``key`` of ``shape``: the first
    matching rule on its JAX path, filtered to the mesh, then
    ``augment(spec, flax_shape, mesh)`` when given (FSDP), worked out in
    flax's layout and returned in the port's."""
    ndim = len(shape)
    spec = rules.spec_for(jax_path(key)) if rules is not None else P()
    spec = _filter_spec(spec, mesh, ndim)
    if augment is not None:
        spec = augment(spec, flax_shape(key, shape), mesh)
    return port_spec(key, spec)


def param_shardings(params: dict, mesh: Mesh,
                    rules: ShardingRules | None) -> dict[str, NamedSharding]:
    """``{key: NamedSharding}`` for a dict of tensors (anything with a
    ``shape``: meta tensors describe a model without its weights)."""
    return {k: NamedSharding(mesh, key_spec(k, t.shape, mesh, rules))
            for k, t in params.items()}


def shard_params(params: dict, mesh: Mesh, rules: ShardingRules | None, *,
                 rank: int | None = None) -> dict[str, torch.Tensor]:
    """This rank's blocks of the whole ``params`` by the rules."""
    shardings = param_shardings(params, mesh, rules)
    return {k: shardings[k].shard(t, rank) for k, t in params.items()}


def leaf_sharding(path: tuple, leaf, shardings: dict | None):
    """The sharding of a state leaf: a param's, or an optimizer leaf's
    whose path ends in that param's key (``mu``, ``nu``, accumulated
    grads mirror the params); None (replicated) for the rest."""
    if not shardings or not path or not torch.is_tensor(leaf):
        return None
    sharding = shardings.get(path[-1])
    if sharding is None or len(sharding.spec) != leaf.dim():
        return None
    return sharding


def device_bytes(tree, shardings: dict | None = None) -> tuple[int, int]:
    """``(per_rank_max, logical_total)`` bytes of a tree (dicts, lists
    and dataclasses: a ``TrainState``, a decode cache) of this rank's
    tensors, JAX's ``device_bytes``: ``logical_total`` is the unsharded
    footprint, a sharded leaf's bytes times its blocks (``shardings``,
    keyed as :func:`leaf_sharding` reads them; none: every leaf whole);
    ``per_rank_max`` the bytes this rank holds, which every rank holds
    alike, the shards being even. Metadata only: no device sync."""
    from lambdipy_tpu_torch.train.checkpoint import tree_paths

    def lists_as_dicts(node):
        # a decode cache or an arena is a list of per-layer dicts
        if isinstance(node, (list, tuple)):
            return {str(i): lists_as_dicts(v) for i, v in enumerate(node)}
        if isinstance(node, dict):
            return {k: lists_as_dicts(v) for k, v in node.items()}
        return node

    per_rank = total = 0
    for path, leaf in tree_paths(lists_as_dicts(tree)):
        if not torch.is_tensor(leaf):
            continue
        nbytes = leaf.numel() * leaf.element_size()
        sharding = leaf_sharding(path, leaf, shardings)
        per_rank += nbytes
        total += nbytes * (sharding.blocks() if sharding is not None else 1)
    return per_rank, total


def shard_batch(batch, mesh: Mesh, axis: str = "dp", *,
                rank: int | None = None, device=None):
    """This rank's rows of every leaf of ``batch``: the leading (batch)
    dim split over ``axis`` (a dict, list or single array or tensor;
    numpy becomes a tensor), on ``device`` when given."""

    def place(leaf):
        t = torch.as_tensor(leaf)
        spec = _filter_spec(P(axis), mesh, t.dim())
        t = NamedSharding(mesh, spec).shard(t, rank)
        return t.to(device) if device is not None else t

    if isinstance(batch, dict):
        return {k: place(v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(place(v) for v in batch)
    return place(batch)
