"""One rank of the port's data-parallel checks, run as a process of a gloo
group on the CPU: ``python tests/torch_ranks.py <scenario> <workdir>
<rank> <world> [<json config>]``. It imports the port alone (no jax), so
it runs where jax is absent too; the group meets through
``file://<workdir>/pg``, which no other group shares. Rank 0 writes what
it finds to ``<workdir>/<scenario>.pt``.

- ``train``: rank 0 first trains ``llama-tiny`` in one process (no
  group); then every rank trains it over ``make_mesh({"dp": world})``,
  once per variant (``dp``: params replicated; ``fsdp``: FSDP over
  ``dp``), and the whole params, the metrics, the placed batches
  gathered across the ranks, the local shapes and ``device_bytes`` of
  the params and of the whole state are kept for each.
- ``trainer``: a two-rank ``Trainer`` run of 8 steps; 4 steps, a
  checkpoint and a new ``Trainer`` resumed to 8, and its ``evaluate``
  over two batches of a loader seeded 77; and a ``Trainer`` that restores
  a one-process checkpoint (``<workdir>/one``); each state gathered
  whole.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

T_START = time.perf_counter()

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from lambdipy_tpu_torch.data import ShardedLoader, TokenSource  # noqa: E402
from lambdipy_tpu_torch.models import registry  # noqa: E402
from lambdipy_tpu_torch.models.params import train_params  # noqa: E402
from lambdipy_tpu_torch.parallel import distributed  # noqa: E402
from lambdipy_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from lambdipy_tpu_torch.parallel.sharding import (device_bytes,  # noqa: E402
                                                  leaf_sharding)
from lambdipy_tpu_torch.train.checkpoint import tree_paths  # noqa: E402
from lambdipy_tpu_torch.train.loop import Trainer, TrainerConfig  # noqa: E402
from lambdipy_tpu_torch.train.step import (make_optimizer,  # noqa: E402
                                           sharded_train_step)

DEFAULTS = {"steps": 5, "lr": 1e-3, "grad_clip": 1.0, "warmup_steps": 2,
            "batch": 4, "seq": 16, "seed": 5, "params": None,
            "tokens": "tokens.npy", "variants": ["dp", "fsdp"]}


def join_group(workdir: Path, rank: int, world: int):
    """The port's bootstrap from its own variables, a file store."""
    os.environ.update(LAMBDIPY_COORDINATOR=f"file://{workdir}/pg",
                      LAMBDIPY_NUM_PROCESSES=str(world),
                      LAMBDIPY_PROCESS_ID=str(rank))
    ctx = distributed.initialize_from_env(device="cpu")
    assert ctx.initialized and ctx.backend == "gloo", ctx
    assert (ctx.process_index, ctx.process_count) == (rank, world), ctx
    return ctx


def whole_state(state, shardings) -> dict:
    """Every leaf of a train state by its path, sharded leaves gathered."""
    out = {}
    for path, leaf in tree_paths(state):
        sharding = leaf_sharding(path, leaf, shardings)
        out["/".join(path)] = (sharding.gather(leaf) if sharding is not None
                               else leaf)
    return out


def _params(adapter, cfg, workdir: Path) -> dict:
    if cfg["params"]:
        return torch.load(workdir / cfg["params"])
    return train_params(adapter.init_params(seed=0, device="cpu"))


def _loader(cfg, workdir: Path) -> ShardedLoader:
    return ShardedLoader(TokenSource(np.load(workdir / cfg["tokens"]),
                                     cfg["seq"]), cfg["batch"],
                         seed=cfg["seed"])


def _optimizer(cfg):
    return make_optimizer(cfg["lr"], grad_clip=cfg["grad_clip"],
                          warmup_steps=cfg["warmup_steps"])


def _steps(adapter, params, cfg, workdir, mesh, fsdp):
    step, state, _ = sharded_train_step(
        adapter.train_forward, params, mesh, adapter.tp_rules, device="cpu",
        fsdp=fsdp, optimizer=_optimizer(cfg))
    loader = _loader(cfg, workdir)
    metrics, placed = [], []
    for _ in range(cfg["steps"]):
        batch = loader.place(loader.next_batch(), step.mesh, device="cpu")
        placed.append(batch)
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return step, state, metrics, placed


def train(workdir: Path, rank: int, world: int, cfg: dict) -> dict:
    t0 = time.perf_counter()
    adapter = registry.get("llama-tiny").build()
    params = _params(adapter, cfg, workdir)
    out = {"timings": {"imports_s": t0 - T_START}}
    if rank == 0:  # one process, before the group is up
        _, state, metrics, placed = _steps(adapter, params, cfg, workdir,
                                           None, True)
        out["solo"] = {"params": state.params, "metrics": metrics,
                       "batches": placed}
    t1 = time.perf_counter()
    out["timings"]["solo_s"] = t1 - t0
    join_group(workdir, rank, world)
    t2 = time.perf_counter()
    out["timings"]["join_s"] = t2 - t1
    mesh = make_mesh({"dp": world})
    dm = mesh.device_mesh()
    out["device_mesh"] = {"names": tuple(dm.mesh_dim_names),
                          "shape": tuple(dm.mesh.shape),
                          "type": dm.device_type}
    for variant in cfg["variants"]:
        step, state, metrics, placed = _steps(adapter, params, cfg, workdir,
                                              mesh, variant == "fsdp")
        out[variant] = {
            "params": {k: step.shardings[k].gather(v)
                       for k, v in state.params.items()},
            "state_bytes": device_bytes(state, step.shardings),
            "metrics": metrics,
            "local_shapes": {k: tuple(v.shape)
                             for k, v in state.params.items()},
            "device_bytes": device_bytes(state.params, step.shardings),
            "batches": [torch.cat(distributed.all_gather(b))
                        for b in placed]}
    out["timings"]["mesh_s"] = time.perf_counter() - t2
    return out


def trainer(workdir: Path, rank: int, world: int, cfg: dict) -> dict:
    adapter = registry.get("llama-tiny").build()
    params = _params(adapter, cfg, workdir)
    join_group(workdir, rank, world)

    def make(total: int, ckpt_dir):
        return Trainer(
            adapter.train_forward, params, _loader(cfg, workdir),
            TrainerConfig(total_steps=total, log_every=1, ckpt_every=4,
                          learning_rate=cfg["lr"],
                          grad_clip=cfg["grad_clip"],
                          warmup_steps=cfg["warmup_steps"]),
            device="cpu", mesh={"dp": -1}, rules=adapter.tp_rules,
            ckpt_dir=ckpt_dir)

    full = make(8, None)
    full_rows = full.run().history
    first = make(4, workdir / "ck")
    first_rows = first.run().history
    first.close()
    second = make(8, workdir / "ck")
    second_rows = second.run().history
    second.close()
    reverse = make(4, workdir / "one")
    evaluated = second.evaluate(
        ShardedLoader(TokenSource(np.load(workdir / cfg["tokens"]),
                                  cfg["seq"]), cfg["batch"], seed=77),
        batches=2)
    return {"full_rows": full_rows, "first_rows": first_rows,
            "evaluate": evaluated,
            "second_rows": second_rows,
            "resumed_from": (second.resumed_from, reverse.resumed_from),
            "full": whole_state(full.state, full.step_fn.shardings),
            "second": whole_state(second.state, second.step_fn.shardings),
            "reverse": whole_state(reverse.state,
                                   reverse.step_fn.shardings)}


SCENARIOS = {"train": train, "trainer": trainer}


def main(argv) -> int:
    scenario, workdir, rank, world = (argv[0], Path(argv[1]), int(argv[2]),
                                      int(argv[3]))
    cfg = {**DEFAULTS, **(json.loads(argv[4]) if len(argv) > 4 else {})}
    torch.set_num_threads(1)
    try:
        out = SCENARIOS[scenario](workdir, rank, world, cfg)
        if rank == 0:
            torch.save(out, workdir / f"{scenario}.pt")
    finally:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
