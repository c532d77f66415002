"""Device meshes of the port, the twin of ``lambdipy_tpu/parallel/mesh.py``.

Canonical axis names, in nesting order (outermost first), JAX's:

- ``dp``   data parallel (params replicated or FSDP-sharded over it,
  batch sharded)
- ``fsdp`` fully-sharded data parallel
- ``pp``   pipeline parallel
- ``tp``   tensor parallel
- ``sp``   sequence parallel
- ``ep``   expert parallel

The port runs one process per device, so a mesh is a plain description:
its axis names, its shape and a numpy array of the global ranks
(``torch.distributed`` ranks, one per device) laid out over the axes. It
is built without a process group (the tests compare it with JAX's on the
host) and gives a ``torch.distributed.device_mesh.DeviceMesh`` only when
asked, with a group up. Of the parallelisms the port trains ``dp`` (and
FSDP over ``dp``); the others raise, each naming its ROADMAP item
(:data:`MESH_REFUSED`).
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass

import numpy as np

MESH_AXES: tuple[str, ...] = ("dp", "fsdp", "pp", "tp", "sp", "ep")

# the axes no port path runs yet, each with the ROADMAP item that ports it
MESH_REFUSED: dict[str, str] = {
    "tp": "tensor parallelism is not ported yet (ROADMAP queue 1, item 3 "
          "(c))",
    "ep": "expert parallelism is not ported yet (ROADMAP queue 1, item 3 "
          "(d))",
    "sp": "sequence parallelism is not ported yet (ROADMAP queue 1, item 3 "
          "(e))",
    "pp": "pipeline parallelism is not ported yet (ROADMAP queue 1, item 3 "
          "(f))",
}


@dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: the global ranks, an int array of ``len(axis_names)``
    dims; ``shape``: ``{axis: size}`` in axis order, as JAX's
    ``mesh.shape``."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    def __post_init__(self):
        arr = np.asarray(self.devices, dtype=np.int64)
        if arr.ndim != len(self.axis_names):
            raise ValueError(f"mesh of {arr.ndim} dims named "
                             f"{self.axis_names}")
        object.__setattr__(self, "devices", arr)
        object.__setattr__(self, "axis_names", tuple(self.axis_names))

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh) and self.axis_names == other.axis_names
                and np.array_equal(self.devices, other.devices))

    def __hash__(self) -> int:
        return hash((self.axis_names, self.devices.tobytes()))

    def coords(self, rank: int) -> dict[str, int]:
        """``{axis: index}`` of ``rank`` in the mesh."""
        where = np.argwhere(self.devices == rank)
        if not len(where):
            raise ValueError(f"rank {rank} is not in the mesh "
                             f"{self.devices.tolist()}")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def device_mesh(self, device_type: str | None = None):
        """The ``DeviceMesh`` of these ranks over the live process group
        (``cuda`` under NCCL, else ``cpu``); raises without a group."""
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("a DeviceMesh needs an initialized process "
                               "group (parallel/distributed.py "
                               "initialize_from_env)")
        if device_type is None:
            device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        return DeviceMesh(device_type, torch.as_tensor(self.devices),
                          mesh_dim_names=self.axis_names)


_ACTIVE_MESH: contextvars.ContextVar[Mesh | None] = contextvars.ContextVar(
    "lambdipy_torch_active_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Enter ``mesh`` as the ambient mesh (:func:`current_mesh`)."""
    token = _ACTIVE_MESH.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE_MESH.reset(token)


def current_mesh() -> Mesh | None:
    """The ambient mesh, or None (the port has no legacy mesh context)."""
    return _ACTIVE_MESH.get()


def _ranks(devices) -> list[int]:
    if devices is not None:
        return [int(d) for d in devices]
    from lambdipy_tpu_torch.parallel.distributed import process_count

    return list(range(process_count()))


def make_mesh(shape: dict[str, int], devices=None) -> Mesh:
    """A mesh from ``{axis: size}``, JAX's ``make_mesh``: absent axes have
    size 1 and size-1 axes are dropped (``["dp"]`` when none is left);
    one ``-1`` is filled with the remaining device factor; the sizes must
    multiply to the device count. ``devices`` are global ranks (default:
    every rank of the process group, ``[0]`` without one)."""
    devices = _ranks(devices)
    sizes = dict(shape)
    unknown = set(sizes) - set(MESH_AXES)
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)}; known: {MESH_AXES}")
    n = len(devices)
    fills = [a for a, s in sizes.items() if s == -1]
    if len(fills) > 1:
        raise ValueError("at most one axis may be -1")
    fixed = math.prod(s for s in sizes.values() if s != -1)
    if fills:
        if n % fixed:
            raise ValueError(f"{n} devices not divisible by fixed axes product {fixed}")
        sizes[fills[0]] = n // fixed
    total = math.prod(sizes.values()) if sizes else 1
    if total != n:
        raise ValueError(
            f"mesh shape {sizes} needs {total} devices, have {n}")
    axis_names = [a for a in MESH_AXES if sizes.get(a, 1) > 1] or ["dp"]
    dims = [sizes.get(a, 1) for a in axis_names]
    return Mesh(np.asarray(devices).reshape(dims), tuple(axis_names))


def flat_mesh(axis: str = "dp", devices=None) -> Mesh:
    """All devices on a single named axis."""
    return Mesh(np.asarray(_ranks(devices)), (axis,))


def refuse_unported(mesh: Mesh | dict) -> None:
    """Raise ``NotImplementedError`` for an axis above 1 that no port path
    runs yet, naming its ROADMAP item (:data:`MESH_REFUSED`)."""
    shape = mesh.shape if isinstance(mesh, Mesh) else mesh
    for axis, text in MESH_REFUSED.items():
        if int(shape.get(axis, 1)) > 1:
            raise NotImplementedError(f"mesh axis {axis}={shape[axis]}: "
                                      f"{text}")


def job_mesh(mesh) -> Mesh | None:
    """The mesh a training job runs over, one process per device: None
    (one device, no group), a :class:`Mesh`, or ``{axis: size}`` (the
    CLI's ``--mesh``; one ``-1`` fills) laid over the group's ranks.
    Raises ``NotImplementedError`` for an axis no port path runs
    (:func:`refuse_unported`), and ``ValueError`` for a mesh whose size is
    not the process count or whose ranks are out of order."""
    if mesh is None:
        return None
    from lambdipy_tpu_torch.parallel.distributed import process_count

    world = process_count()
    if not isinstance(mesh, Mesh):
        shape = {a: int(s) for a, s in dict(mesh).items()}
        unknown = set(shape) - set(MESH_AXES)
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}; known: "
                             f"{MESH_AXES}")
        refuse_unported(shape)
        needed = math.prod(s for s in shape.values() if s != -1)
        if -1 not in shape.values() and needed != world:
            raise ValueError(
                f"mesh {shape} needs {needed} processes, one device each; "
                f"this job has {world} (start {needed} ranks: "
                "LAMBDIPY_COORDINATOR, LAMBDIPY_NUM_PROCESSES and "
                "LAMBDIPY_PROCESS_ID, or torchrun)")
        mesh = make_mesh(shape)
    refuse_unported(mesh)
    if mesh.size != world:
        raise ValueError(f"a mesh of {mesh.size} devices needs {mesh.size} "
                         f"processes, one device each; this job has {world}")
    if not np.array_equal(mesh.devices.ravel(), np.arange(world)):
        raise ValueError(f"the mesh's ranks {mesh.devices.tolist()} are not "
                         "in rank order")
    return mesh


def mesh_shape_for(n_devices: int, *, tp: int | None = None,
                   sp: int = 1, pp: int = 1) -> dict[str, int]:
    """Default mesh shape for n devices, JAX's: tp filled up to 4, the
    rest dp."""
    if tp is None:
        tp = math.gcd(n_devices, 4)
    denom = tp * sp * pp
    if n_devices % denom:
        raise ValueError(f"{n_devices} devices not divisible by tp*sp*pp={denom}")
    return {"dp": n_devices // denom, "pp": pp, "tp": tp, "sp": sp}


def parse_mesh_spec(spec: str) -> dict[str, int]:
    """A mesh declaration as ``{axis: size}``, JAX's grammar:
    ``"tp=2"`` / ``"tp=2,sp=1"`` / ``"dp=2 tp=4"`` (explicit axes, comma
    or whitespace separated), ``"2"`` (a bare tensor-parallel width),
    ``"2x2"`` (``dp x tp``), and ``""`` / ``"0"`` / ``"1"`` / ``"off"`` /
    ``"none"`` (no mesh, ``{}``). Size-1 axes are dropped; unknown axes
    and sizes below 1 raise ``ValueError``."""
    s = (spec or "").strip().lower()
    if s in ("", "0", "1", "off", "none"):
        return {}
    if "x" in s and "=" not in s:
        try:
            dims = [int(tok) for tok in s.split("x")]
        except ValueError:
            raise ValueError(f"unparseable mesh spec {spec!r}") from None
        if len(dims) != 2:
            raise ValueError(
                f"grid mesh spec must be AxB (dp x tp), got {spec!r}")
        shape = {"dp": dims[0], "tp": dims[1]}
    elif "=" not in s:
        try:
            shape = {"tp": int(s)}
        except ValueError:
            raise ValueError(f"unparseable mesh spec {spec!r}") from None
    else:
        shape = {}
        for tok in s.replace(",", " ").split():
            axis, _, val = tok.partition("=")
            if not _ or axis not in MESH_AXES:
                raise ValueError(
                    f"unknown mesh axis {axis!r} in {spec!r}; "
                    f"known: {MESH_AXES}")
            try:
                shape[axis] = int(val)
            except ValueError:
                raise ValueError(
                    f"mesh axis {axis} has non-integer size {val!r}"
                ) from None
    for axis, size in shape.items():
        if size < 1:
            raise ValueError(
                f"mesh axis {axis} must be >= 1, got {size}")
    return {a: n for a, n in shape.items() if n > 1}
