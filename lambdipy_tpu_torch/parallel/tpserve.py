"""Tensor-parallel serving of the port: the controller's dispatcher and
the followers' loop, ``tp`` ranks of one process per device.

JAX has no twin of this module: one JAX process drives every device of a
mesh, and XLA's partitioner inserts the collectives. The port runs one
process per device (a rank), each holding its share of the weights, the
KV cache and the page arena (``models/llama.py ShardConfig``), and its
forward runs explicit collectives (``parallel/distributed.py``). Every
rank must then make the same calls in the same order, or the ranks pair
the wrong collectives:

- Rank 0, the controller, owns the HTTP server, the scheduler, the engine
  and the page pool. Each call it makes into a model program goes through
  :meth:`Dispatcher.call`, under the process's ``DEVICE_LOCK``: the
  command (a target's name, an op's name and host arguments: tokens,
  lengths, slots, page ids, knobs, row streams) goes to the followers on
  the command channel first, then the controller runs the op itself.
- Followers (ranks 1 to N-1) run :func:`follow`: each command runs the
  same op on the follower's own objects (its server, its engine's step
  and arena, made by the factory the controller named), so their
  collectives pair. Device state is addressed by ids the controller names
  (:class:`Remote`), never by tensor handles; a follower drops a result
  once the controller's handle is gone.
- Every rank samples from the same gathered logits with the same row
  streams, so no token is sent. To check that, :meth:`Dispatcher.track`
  has every rank keep a digest of the tokens its ops produce (a read of
  each result to the host, so it is off unless a check asks), and
  :meth:`Dispatcher.agree` gathers the digests.
- Failure: an exception in a dispatched op, on any rank, breaks the
  group. A follower exits (its sockets close, so the controller's next
  collective fails at once); the controller marks the dispatcher broken,
  and every later call raises :class:`TensorParallelError`. Collectives
  give up after ``distributed.TP_TIMEOUT_S``. :meth:`Dispatcher.stats`
  says whether the group can serve (a follower that exited shows there
  before any call fails); the handler turns it into ``/healthz``'s
  ``wedged``. Followers exit when the controller closes or exits.

``python -m lambdipy_tpu_torch.parallel.tpserve <init> <rank> <size>
<device> [<backend>]`` is one follower; :func:`start_ranks` starts them.
"""

from __future__ import annotations

import atexit
import collections
import importlib
import itertools
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import weakref
import zlib
from pathlib import Path

import numpy as np
import torch

from lambdipy_tpu_torch.models.graphs import DEVICE_LOCK
from lambdipy_tpu_torch.parallel.distributed import TPGroup, tp_group
from lambdipy_tpu_torch.utils.logs import get_logger, log_event

log = get_logger("lambdipy.tpserve")

_REPO_ROOT = str(Path(__file__).resolve().parents[2])
# seconds a follower has to join the group after it is started (importing
# torch on a loaded host takes most of it)
JOIN_TIMEOUT_S = 300.0


class TensorParallelError(RuntimeError):
    """A tensor-parallel group is broken: a rank died or failed a call."""


class Remote:
    """The controller's handle on a result every rank keeps under ``id``:
    ``value`` is the controller's own. Passed back into a call, each rank
    reads its own result of that id."""

    __slots__ = ("id", "value", "__weakref__")

    def __init__(self, rid: int, value):
        self.id, self.value = rid, value


class _Ref:
    """A :class:`Remote` on the wire."""

    __slots__ = ("id",)

    def __init__(self, rid: int):
        self.id = rid


def _wire(args):
    return tuple(_Ref(a.id) if isinstance(a, Remote) else a for a in args)


def _local(args):
    return tuple(a.value if isinstance(a, Remote) else a for a in args)


class _Digest:
    """A running CRC of the tokens a rank's ops produced (the first
    element of a result, when it holds integers): on only between
    :meth:`Dispatcher.track` and :meth:`Dispatcher.agree`, as a card
    tensor's update is a device sync."""

    def __init__(self):
        self.value = 0

    def update(self, result) -> None:
        if isinstance(result, tuple) and result:
            result = result[0]
        if torch.is_tensor(result):
            if result.is_floating_point():
                return
            result = result.detach().cpu().numpy()
        if isinstance(result, np.ndarray) and result.dtype.kind in "iu":
            self.value = zlib.crc32(np.ascontiguousarray(
                result.astype(np.int64)).tobytes(), self.value)


def _factory(path: str):
    module, _, name = path.partition(":")
    return getattr(importlib.import_module(module), name)


class Dispatcher:
    """The controller's end of a tensor-parallel group (see the module
    docstring). ``targets`` are the controller's objects by name; each
    follower holds its own of the same names."""

    def __init__(self, group: TPGroup, procs=(), workdir: str | None = None):
        self.group = group
        self.procs = list(procs)
        self.workdir = workdir
        self.targets: dict = {}
        self._ids = itertools.count(1)
        # results the followers may drop (handles collected); a deque, as
        # a handle's finalizer may append from any thread
        self._drops: collections.deque = collections.deque()
        self.broken: BaseException | None = None
        self.closed = False
        self.digest: _Digest | None = None  # on after track()
        self.commands = 0
        atexit.register(self.close)

    @property
    def size(self) -> int:
        return self.group.size

    def _check(self) -> None:
        if self.closed:
            raise TensorParallelError("the tensor-parallel group is closed")
        if self.broken is not None:
            raise TensorParallelError(
                f"the tensor-parallel group is broken: {self.broken!r}")

    def _break(self, error: BaseException) -> TensorParallelError:
        if self.broken is None:
            self.broken = error
            log.error("tensor-parallel group broken: %r", error)
        return TensorParallelError(
            f"a tensor-parallel call failed, and the group with it: "
            f"{error!r}")

    def _send(self, msg) -> None:
        try:
            self.group.send_command(msg)
        except Exception as e:  # noqa: BLE001 — a follower is gone
            raise self._break(e) from e
        self.commands += 1

    def register(self, name: str, obj) -> None:
        self.targets[name] = obj

    def create(self, target: str, factory: str, obj, *, ship=None,
               **kw) -> None:
        """``obj`` is the controller's ``target``; each follower makes its own
        with ``factory(targets, group, **kw)`` (a ``"module:function"``
        path). ``ship``: ``{rank: object}`` sent to each rank point to
        point after the command (a weight shard its factory receives)."""
        with DEVICE_LOCK:
            self._check()
            self._send(("new", target, factory, kw))
            try:
                for rank, payload in (ship or {}).items():
                    self.group.send_to(rank, payload)
            except Exception as e:  # noqa: BLE001
                raise self._break(e) from e
            self.targets[target] = obj

    def call(self, target: str, op: str, *args, keep: bool = False):
        """``targets[target].op(*args)`` on every rank, this one last:
        the result (a :class:`Remote` with ``keep``, which every rank keeps
        until the handle is collected). Any failure breaks the group."""
        with DEVICE_LOCK:
            self._check()
            rid = next(self._ids) if keep else None
            drops = [self._drops.popleft() for _ in range(len(self._drops))]
            self._send(("call", target, op, _wire(args), rid, drops))
            self.group.enter()
            try:
                value = getattr(self.targets[target], op)(*_local(args))
            except BaseException as e:
                raise self._break(e) from e
            finally:
                self.group.leave()
            if self.digest is not None:
                self.digest.update(value)
        if not keep:
            return value
        handle = Remote(rid, value)
        weakref.finalize(handle, self._drops.append, rid)
        return handle

    def each(self, fn: str) -> list:
        """``fn(targets)`` (a ``"module:function"`` path) on every rank,
        its results in rank order (a rank's launch counters, its peak
        memory)."""
        with DEVICE_LOCK:
            self._check()
            self._send(("each", fn))
            try:
                out = [_factory(fn)(self.targets)]
                out += [self.group.recv_from(r)
                        for r in range(1, self.size)]
            except Exception as e:  # noqa: BLE001
                raise self._break(e) from e
            return out

    def track(self) -> None:
        """Every rank starts a digest of the tokens its ops produce, for
        :meth:`agree` (a check's: each result is read to the host)."""
        with DEVICE_LOCK:
            self._check()
            self._send(("track",))
            self.digest = _Digest()

    def agree(self) -> list[int]:
        """Every rank's digest of the tokens its ops produced since
        :meth:`track`, in rank order: equal when the ranks produced the
        same tokens."""
        if self.digest is None:
            raise RuntimeError("agree() needs track() first")
        with DEVICE_LOCK:
            self._check()
            self._send(("digest",))
            try:
                return self.group.gather_ints(self.digest.value)
            except Exception as e:  # noqa: BLE001
                raise self._break(e) from e

    @property
    def live(self) -> bool:
        """Open and not broken (a dispatched call may still fail)."""
        return not self.closed and self.broken is None

    def stats(self) -> dict:
        """The group's state without touching it (a health probe reads
        it): ``ok`` is false once the group is closed or broken, or a
        follower process has exited (``exited``: their ranks)."""
        exited = [r + 1 for r, p in enumerate(self.procs)
                  if p.poll() is not None]
        return {"ok": self.live and not exited, "ranks": self.size,
                "backend": self.group.backend, "commands": self.commands,
                "broken": repr(self.broken) if self.broken else None,
                "exited": exited}

    def close(self, timeout_s: float = 10.0) -> None:
        """Stop the followers (a close command, then a wait, then a kill)
        and leave the group. Idempotent."""
        with DEVICE_LOCK:
            if self.closed:
                return
            self.closed = True
            if self.broken is None and self.group.cmd is not None:
                try:
                    self.group.send_command(("close",))
                except Exception:  # noqa: BLE001 — already gone
                    pass
        deadline = time.monotonic() + timeout_s
        for proc in self.procs:
            try:
                proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        self.group.close()
        if self.workdir:
            shutil.rmtree(self.workdir, ignore_errors=True)
        atexit.unregister(self.close)


def follow(group: TPGroup) -> None:
    """A follower's loop: run each command of the controller on this
    rank's objects until it sends ``close``. An exception leaves the loop
    (the caller exits, which fails the controller's next collective)."""
    group.follower = True
    targets: dict = {}
    results: dict = {}
    digest = None
    while True:
        msg = group.recv_command()
        kind = msg[0]
        if kind == "close":
            return
        if kind == "new":
            _, name, factory, kw = msg
            targets[name] = _factory(factory)(targets, group, **kw)
        elif kind == "call":
            _, target, op, wire, rid, drops = msg
            for d in drops:
                results.pop(d, None)
            args = tuple(results[a.id] if isinstance(a, _Ref) else a
                         for a in wire)
            value = getattr(targets[target], op)(*args)
            if digest is not None:
                digest.update(value)
            if rid is not None:
                results[rid] = value
        elif kind == "track":
            digest = _Digest()
        elif kind == "digest":
            group.gather_ints(digest.value)
        elif kind == "each":
            group.send_to(0, _factory(msg[1])(targets))
        else:
            raise ValueError(f"unknown command {kind!r}")


def _indexed(device) -> torch.device:
    """``device`` with its card's index (``cuda`` alone: the current
    card), as a follower's ``set_device`` needs it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def start_ranks(size: int, *, devices,
                backend: str | None = None) -> Dispatcher:
    """Start followers 1 to ``size - 1`` (processes of this module, rank
    ``r`` on ``devices[r]``) and join the group as rank 0 on
    ``devices[0]``; the controller's :class:`Dispatcher`. A follower that
    exits before the group is up fails the start."""
    devices = [_indexed(d) for d in devices]
    workdir = tempfile.mkdtemp(prefix="lambdipy-tp-")
    init = f"file://{workdir}/store"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_REPO_ROOT] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    procs = [subprocess.Popen(
        [sys.executable, "-m", "lambdipy_tpu_torch.parallel.tpserve", init,
         str(rank), str(size), str(devices[rank]), backend or ""], env=env)
        for rank in range(1, size)]
    box: dict = {}

    def join():
        try:
            box["group"] = tp_group(init, 0, size, device=devices[0],
                                    backend=backend)
        except BaseException as e:  # noqa: BLE001 — reported below
            box["error"] = e

    joiner = threading.Thread(target=join, daemon=True, name="tp-join")
    joiner.start()
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    while joiner.is_alive():
        joiner.join(timeout=0.1)
        dead = [(r + 1, p.returncode) for r, p in enumerate(procs)
                if p.poll() is not None]
        if joiner.is_alive() and (dead or time.monotonic() > deadline):
            for p in procs:
                if p.poll() is None:
                    p.kill()
            shutil.rmtree(workdir, ignore_errors=True)
            raise TensorParallelError(
                f"tensor-parallel ranks did not join: exited {dead}"
                if dead else "tensor-parallel ranks did not join in "
                             f"{JOIN_TIMEOUT_S:.0f} s")
    if "error" in box:
        for p in procs:
            p.kill()
        shutil.rmtree(workdir, ignore_errors=True)
        raise box["error"]
    log_event(log, "tp ranks up", size=size, backend=box["group"].backend,
              devices=[str(d) for d in devices])
    return Dispatcher(box["group"], procs, workdir)


def rank_launches(targets) -> dict:
    """This rank's kernel launch counters (``runtime/handlers.py
    kernel_launches``)."""
    from lambdipy_tpu_torch.runtime.handlers import kernel_launches

    return kernel_launches()


def rank_memory(targets) -> dict:
    """This rank's device, its allocated and peak allocated bytes (0 on
    the CPU)."""
    dev = next((t.device for t in targets.values()
                if hasattr(t, "device")), None)
    if dev is None or dev.type != "cuda":
        return {"device": str(dev), "allocated": 0, "peak": 0}
    return {"device": str(dev),
            "allocated": torch.cuda.memory_allocated(dev),
            "peak": torch.cuda.max_memory_allocated(dev)}


# -- servers --------------------------------------------------------------


def rank_server(cfg, share: dict, group: TPGroup, mesh, device, **server_kw):
    """This rank's ``LlamaServer`` over ``group``: a model of ``cfg``'s
    share (``models/llama.py shard_config``) holding ``share``, the
    rank's weights."""
    from lambdipy_tpu_torch.models import params
    from lambdipy_tpu_torch.models.llama import LlamaServer, shard_config

    model = params.build_model(shard_config(cfg, group.size), share,
                               device=device)
    model.set_tp(group)
    return LlamaServer(model, mesh=mesh, **server_kw)


def _share(cfg, whole: dict, mesh, rank: int) -> dict:
    from lambdipy_tpu_torch.models.registry import _llama_tp_rules
    from lambdipy_tpu_torch.parallel.sharding import shard_params

    return shard_params(whole, mesh, _llama_tp_rules(), rank=rank)


def follower_server(targets, group: TPGroup, *, cfg, mesh, server_kw,
                    seed=None):
    """A follower's server: its share shipped by the controller, or cut
    from the whole model drawn from ``seed`` on this rank's device."""
    from lambdipy_tpu_torch.models import params

    device = group.device
    if seed is None:
        share = group.recv_from(0)
    else:
        whole = params.init_params(cfg, seed, device)
        share = _share(cfg, whole, mesh, group.rank)
        del whole
    return rank_server(cfg, share, group, mesh, device, **server_kw)


def serve_tp(cfg, state_dict, mesh, *, device=None, devices=None,
             backend: str | None = None, dispatcher: Dispatcher | None = None,
             **server_kw):
    """The controller's ``LlamaServer`` of ``cfg`` over ``mesh``'s ``tp``
    ranks: followers started (:func:`start_ranks`) on ``devices`` (default:
    ``cuda:0`` to ``cuda:tp-1`` on the card, the CPU for every rank with
    ``device="cpu"``), each serving its share of ``state_dict`` (the whole
    model's weights, shipped rank by rank; None: the weights
    ``init_params`` draws from seed 0, each rank drawing its own). Close
    it with ``server.dispatcher.close()``. ``dispatcher``: ranks already
    started (:func:`start_ranks`, on ``devices``), whose imports ran
    beside other work."""
    from lambdipy_tpu_torch.models import params
    from lambdipy_tpu_torch.utils.platform import resolve_device

    tp = int(mesh.shape.get("tp", 1))
    if devices is None:
        dev = resolve_device(device)
        devices = ([dev] * tp if dev.type == "cpu"
                   else [torch.device("cuda", r) for r in range(tp)])
    devices = [_indexed(d) for d in devices]
    disp = dispatcher or start_ranks(tp, devices=devices, backend=backend)
    try:
        kw = {"cfg": cfg, "mesh": mesh, "server_kw": server_kw}
        if state_dict is None:
            kw["seed"] = 0
            whole = params.init_params(cfg, 0, devices[0])
            ship = None
        else:
            whole = state_dict
            ship = {r: {k: v.cpu() for k, v in _share(
                cfg, whole, mesh, r).items()} for r in range(1, tp)}
        server = rank_server(cfg, _share(cfg, whole, mesh, 0), disp.group,
                             mesh, devices[0], dispatcher=disp, **server_kw)
        del whole
        disp.create("server", "lambdipy_tpu_torch.parallel.tpserve:"
                    "follower_server", server, ship=ship, **kw)
    except BaseException:
        disp.close()
        raise
    return server


def main(argv=None) -> int:
    """One follower: join the group, follow the controller, exit."""
    argv = sys.argv[1:] if argv is None else argv
    init, rank, size, device = argv[0], int(argv[1]), int(argv[2]), argv[3]
    backend = argv[4] if len(argv) > 4 and argv[4] else None
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        # CPU ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // size))
    group = tp_group(init, rank, size, device=device, backend=backend)
    try:
        with torch.inference_mode():
            follow(group)
    except Exception as e:  # noqa: BLE001 — the group is broken
        log.error("tensor-parallel rank %d failed: %r", rank, e)
        return 1
    finally:
        group.close()
    return 0


if __name__ == "__main__":
    # the package's module, not this ``__main__`` copy: commands unpickle
    # into the package's classes
    from lambdipy_tpu_torch.parallel.tpserve import main as _main

    sys.exit(_main())
