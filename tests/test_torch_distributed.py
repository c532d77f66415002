"""The port's data-parallel training over two gloo ranks on the CPU
(``parallel/``, ``train/``, ``data/loader.py`` and the CLI's ``train``),
against the port in one process and JAX's two-device runs.

The ranks run as processes of ``tests/torch_ranks.py`` (the port alone, no
jax) and of ``python -m lambdipy_tpu_torch train``; each group meets
through a ``file://`` store in its own temporary directory, so no TCP
port is shared across test workers. The three groups start together and
the JAX side (on its 8 virtual CPU devices) is computed while they run.

- dp and FSDP, five steps of the f32 ``llama-tiny`` at ``dp=2`` with the
  clip and a warmup acting, from JAX's params on JAX's batches: metrics
  within ``SOLO_TOL`` of the port's one-process run and params within
  ``SOLO_TOL`` relative (each rank's rows' mean loss averaged and its
  gradient reduced over the ranks: f32 sums in another order; measured
  4.8e-7 and 1.5e-7); against JAX's ``sharded_train_step`` on
  ``make_mesh({"dp": 2})`` within PR 25's ``METRIC_TOL`` / ``PARAM_TOL``
  (two frameworks' forward and backward); the loss falls.
- FSDP's ``device_bytes`` on rank 0 is JAX's ``(per_device_max,
  logical_total)`` for the same params on the same mesh; the placed
  batches gathered across the ranks are JAX's global batches.
- A two-rank ``Trainer``: 4 steps, a checkpoint and a new ``Trainer``
  resumed to 8 are the uninterrupted two-rank run bitwise; that
  checkpoint restores in one process, and a one-process checkpoint in
  two ranks, bitwise; ``evaluate`` over two ranks is one process's.
- ``train --mesh dp=2 --device cpu`` as two processes prints JAX's keys.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from lambdipy_tpu.data import ShardedLoader as JaxLoader
from lambdipy_tpu.data import TokenSource as JaxSource
from lambdipy_tpu.models import registry as jreg
from lambdipy_tpu.parallel.mesh import make_mesh as jax_make_mesh
from lambdipy_tpu.parallel.sharding import device_bytes as jax_device_bytes
from lambdipy_tpu.train.step import make_optimizer as jax_make_optimizer
from lambdipy_tpu.train.step import sharded_train_step as jax_sharded_step
from lambdipy_tpu_torch.data import ShardedLoader, TokenSource
from lambdipy_tpu_torch.models import params as tparams
from lambdipy_tpu_torch.models import registry as treg
from lambdipy_tpu_torch.train.checkpoint import tree_paths
from lambdipy_tpu_torch.train.loop import Trainer, TrainerConfig

ROOT = Path(__file__).resolve().parents[1]
RANKS = ROOT / "tests" / "torch_ranks.py"
# the ranks' config (torch_ranks.DEFAULTS), the params JAX's
CFG = {"steps": 5, "lr": 1e-3, "grad_clip": 1.0, "warmup_steps": 2,
       "batch": 4, "seq": 16, "seed": 5, "params": "params.pt"}
SOLO_TOL = 1e-6
METRIC_TOL = 1e-5  # tests/test_torch_train.py's, port against JAX
PARAM_TOL = 2e-5
VARIANTS = ["dp", "fsdp"]
SPAWN_TIMEOUT_S = 300


def _tokens() -> np.ndarray:
    return np.tile(np.arange(50, dtype=np.int32), 80)


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("LAMBDIPY_", "MASTER_", "WORLD_SIZE",
                                "RANK", "LOCAL_RANK"))}
    return {**env, "PYTHONPATH": str(ROOT), "CUDA_VISIBLE_DEVICES": "",
            "OMP_NUM_THREADS": "1", **extra}


def _spawn(argv_of, env_of) -> list:
    return [subprocess.Popen(argv_of(rank), cwd=ROOT, env=env_of(rank),
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
            for rank in range(2)]


def _wait(procs) -> list[str]:
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=SPAWN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err[-4000:]
        outs.append(out)
    return outs


def _trainer_cfg(total: int) -> TrainerConfig:
    return TrainerConfig(total_steps=total, log_every=1, ckpt_every=4,
                         learning_rate=CFG["lr"], grad_clip=CFG["grad_clip"],
                         warmup_steps=CFG["warmup_steps"])


def _loader() -> ShardedLoader:
    return ShardedLoader(TokenSource(_tokens(), CFG["seq"]), CFG["batch"],
                         seed=CFG["seed"])


def _jax_runs(jad, jparams) -> dict:
    """JAX's ``sharded_train_step`` on two devices, dp and FSDP: metrics,
    params, the placed global batches and FSDP's ``device_bytes``."""
    mesh = jax_make_mesh({"dp": 2}, devices=jax.devices()[:2])
    out = {}
    for variant in VARIANTS:
        opt = jax_make_optimizer(CFG["lr"], grad_clip=CFG["grad_clip"],
                                 warmup_steps=CFG["warmup_steps"])
        step, state, batch_sharding = jax_sharded_step(
            jad.forward, jparams, mesh, jad.tp_rules,
            fsdp=variant == "fsdp", optimizer=opt)
        loader = JaxLoader(JaxSource(_tokens(), CFG["seq"]), CFG["batch"],
                           seed=CFG["seed"], process_index=0,
                           process_count=1)
        bytes_ = jax_device_bytes(state.params)
        metrics, batches = [], []
        for _ in range(CFG["steps"]):
            batch = loader.place(loader.next_batch(), mesh, batch_sharding)
            batches.append(np.asarray(jax.device_get(batch)))
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        out[variant] = {
            "metrics": metrics, "batches": batches, "device_bytes": bytes_,
            "state_bytes": jax_device_bytes(state),
            "params": tparams.from_jax_params(jax.device_get(state.params))}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three rank groups, started together; JAX's runs and the
    one-process checkpoint meanwhile."""
    jad = jreg.get("llama-tiny").build()
    jparams = jad.init_params(seed=0)
    params = tparams.train_params(
        tparams.from_jax_params(jax.device_get(jparams)))
    dirs = {g: tmp_path_factory.mktemp(g) for g in ("train", "trainer",
                                                    "cli")}
    for d in dirs.values():
        np.save(d / "tokens.npy", _tokens())
        torch.save(params, d / "params.pt")
    # the one-process checkpoint the trainer group restores in two ranks
    tad = treg.get("llama-tiny").build()
    one = Trainer(tad.train_forward, params, _loader(), _trainer_cfg(4),
                  device="cpu", ckpt_dir=dirs["trainer"] / "one")
    one.run()
    one.close()
    procs = {}
    for group in ("train", "trainer"):
        procs[group] = _spawn(
            lambda r, g=group: [sys.executable, str(RANKS), g,
                                str(dirs[g]), str(r), "2", json.dumps(CFG)],
            lambda r: _env())
    cli = dirs["cli"]
    procs["cli"] = _spawn(
        lambda r: [sys.executable, "-m", "lambdipy_tpu_torch", "train",
                   "--data", str(cli / "tokens.npy"), "--steps", "2",
                   "--batch", "4", "--seq-len", "16", "--mesh", "dp=2",
                   "--device", "cpu", "--ckpt-dir", str(cli / "ck")],
        lambda r: _env(LAMBDIPY_COORDINATOR=f"file://{cli}/pg",
                       LAMBDIPY_NUM_PROCESSES="2",
                       LAMBDIPY_PROCESS_ID=str(r)))
    try:
        jax_out = _jax_runs(jad, jparams)
    finally:
        outs = {g: _wait(p) for g, p in procs.items()}
    return {"jax": jax_out, "one": one, "dirs": dirs,
            "train": torch.load(dirs["train"] / "train.pt"),
            "trainer": torch.load(dirs["trainer"] / "trainer.pt"),
            "cli": [out.strip().splitlines()[-1] for out in outs["cli"]]}


def _assert_params_close(got: dict, want: dict, rtol: float, atol: float):
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=rtol,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("variant", VARIANTS)
def test_two_ranks_train_as_one_process(runs, variant):
    """Metrics within ``SOLO_TOL``; every param within ``SOLO_TOL`` of its
    leaf's largest magnitude."""
    got, solo = runs["train"][variant], runs["train"]["solo"]
    for g, w in zip(got["metrics"], solo["metrics"], strict=True):
        assert set(g) == {"loss", "ce_loss", "aux_loss", "grad_norm"}
        for k in w:
            assert g[k] == pytest.approx(w[k], rel=SOLO_TOL, abs=SOLO_TOL), k
    for k, w in solo["params"].items():
        scale = float(w.abs().max())
        np.testing.assert_allclose(got["params"][k].numpy(), w.numpy(),
                                   rtol=0, atol=SOLO_TOL * scale, err_msg=k)


@pytest.mark.parametrize("variant", VARIANTS)
def test_two_ranks_train_as_jaxs_two_devices(runs, variant):
    got, want = runs["train"][variant], runs["jax"][variant]
    for g, w in zip(got["metrics"], want["metrics"], strict=True):
        for k in w:
            assert g[k] == pytest.approx(w[k], rel=METRIC_TOL,
                                         abs=METRIC_TOL), k
    _assert_params_close(got["params"], want["params"], PARAM_TOL, PARAM_TOL)


def test_the_loss_falls_and_the_clip_acts(runs):
    """The global grad norm is above the clip at every step (the clip
    reads the norm over both ranks' blocks), and the loss falls."""
    for variant in VARIANTS:
        metrics = runs["train"][variant]["metrics"]
        assert all(m["grad_norm"] > CFG["grad_clip"] for m in metrics)
        assert metrics[-1]["loss"] < metrics[0]["loss"]


def test_fsdp_holds_half_and_counts_jaxs_bytes(runs):
    """Under FSDP rank 0 holds half of every kernel (its first evenly
    divisible dim) and ``device_bytes`` is JAX's, of the params and of the
    whole state (the optimizer's moments sharded as their params); under
    dp every param is whole and the two counts are equal."""
    fsdp, dp = runs["train"]["fsdp"], runs["train"]["dp"]
    for variant in VARIANTS:
        for key in ("device_bytes", "state_bytes"):
            assert runs["train"][variant][key] \
                == runs["jax"][variant][key], (variant, key)
    per, total = fsdp["device_bytes"]
    assert per < total and dp["device_bytes"] == (total, total)
    for k, whole in dp["params"].items():
        local = fsdp["local_shapes"][k]
        assert dp["local_shapes"][k] == tuple(whole.shape)
        if whole.dim() >= 2:
            assert local == (whole.shape[0] // 2,) + tuple(whole.shape[1:])
        else:
            assert local == tuple(whole.shape)


def test_placed_batches_gather_to_jaxs_global_batches(runs):
    """Each rank places its own rows; in rank order they are JAX's global
    batch (``make_array_from_process_local_data``'s), step for step."""
    for variant in VARIANTS:
        got = runs["train"][variant]["batches"]
        want = runs["jax"][variant]["batches"]
        assert len(got) == len(want) == CFG["steps"]
        for g, w in zip(got, want):
            assert g.dtype == torch.int64
            np.testing.assert_array_equal(g.numpy(), w)
    assert runs["train"]["device_mesh"] == {"names": ("dp",), "shape": (2,),
                                            "type": "cpu"}


def _states_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        torch.equal(a[k], b[k]) if torch.is_tensor(a[k]) else a[k] == b[k]
        for k in a)


def _state_dict(state) -> dict:
    return {"/".join(p): v for p, v in tree_paths(state)}


def test_two_rank_resume_is_bitwise(runs):
    """4 steps, a checkpoint, a new two-rank ``Trainer`` resumed at 4 to 8:
    its logged rows, params, optimizer state and step are the
    uninterrupted two-rank run's."""
    out = runs["trainer"]
    assert out["resumed_from"][0] == 4
    assert out["first_rows"] + out["second_rows"] == out["full_rows"]
    assert [r["step"] for r in out["full_rows"]] == list(range(1, 9))
    assert _states_equal(out["second"], out["full"])


def test_a_two_rank_checkpoint_restores_in_one_process(runs):
    """The checkpoint rank 0 wrote (the one-device format) restores in one
    process to the two ranks' gathered state, bitwise; from it, the
    one-process ``evaluate`` is the two ranks' (each rank's mean over its
    rows, averaged) within ``SOLO_TOL``."""
    tad = treg.get("llama-tiny").build()
    params = torch.load(runs["dirs"]["trainer"] / "params.pt")
    solo = Trainer(tad.train_forward, params, _loader(), _trainer_cfg(8),
                   device="cpu", ckpt_dir=runs["dirs"]["trainer"] / "ck")
    assert solo.resumed_from == 8
    state = _state_dict(solo.state)
    assert _states_equal(state, runs["trainer"]["second"])
    evaluated = solo.evaluate(
        ShardedLoader(TokenSource(_tokens(), CFG["seq"]), CFG["batch"],
                      seed=77), batches=2)
    assert runs["trainer"]["evaluate"] == pytest.approx(evaluated,
                                                        rel=SOLO_TOL)


def test_a_one_process_checkpoint_restores_in_two_ranks(runs):
    """A one-process checkpoint of step 4, restored by two ranks (each its
    blocks) and gathered back: the one-process state, bitwise."""
    out = runs["trainer"]
    assert out["resumed_from"][1] == 4
    assert _states_equal(out["reverse"], _state_dict(runs["one"].state))


def test_train_cli_runs_as_two_processes(runs):
    """``train --mesh dp=2 --device cpu`` started as two ranks with the
    port's variables: both print JAX's summary keys, ``"mesh": {"dp":
    2}``, the same metrics."""
    lines = [json.loads(line) for line in runs["cli"]]
    assert set(lines[0]) == {"model", "final_step", "steps_run",
                             "resumed_from", "mesh", "final_metrics"}
    assert lines[0]["mesh"] == {"dp": 2} and lines[0]["final_step"] == 2
    assert lines[0] == lines[1]
    assert sorted(p.name for p in (runs["dirs"]["cli"] / "ck").iterdir()) \
        == ["1", "2"]
