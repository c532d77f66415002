"""The port's ``Trainer`` (``lambdipy_tpu_torch/train/loop.py``), its
checkpoints (``train/checkpoint.py``), the numerics check
(``utils/debug.py``) and the CLI's ``train``, on the CPU.

- The trainer learns a patterned sequence and logs at JAX's cadence.
- Resume is bitwise within the port: 4 steps, a checkpoint, a new
  ``Trainer`` resuming to 8 give the uninterrupted run's params, optimizer
  state and logged rows exactly (one process, the same ops in the same
  order).
- The checkpoint cadence (saved or not, latest, kept steps) equals orbax's
  ``CheckpointManager``'s under JAX's ``TrainCheckpointer`` over one
  sequence of calls; a template that does not fit raises, as orbax's
  restore does; a save that died leaves the last checkpoint whole.
- ``evaluate`` agrees with JAX's ``Trainer.evaluate`` from JAX's params
  within ``EVAL_TOL`` (f32 forwards in two frameworks).
- ``debug_numerics`` raises ``FloatingPointError`` naming the leaf on a
  NaN-poisoned weight.
- ``python -m lambdipy_tpu_torch train --device cpu`` runs, resumes and
  prints JAX's keys; a bad ``--mesh`` gets JAX's message; a mesh of more
  devices than the job has processes raises, and so does each axis not
  ported yet, naming its ROADMAP item (two ranks:
  ``tests/test_torch_distributed.py``).
"""

import json

import jax
import numpy as np
import pytest
import torch

from lambdipy_tpu.data import ShardedLoader as JaxLoader
from lambdipy_tpu.data import TokenSource as JaxSource
from lambdipy_tpu.models import registry as jreg
from lambdipy_tpu.parallel.mesh import make_mesh, use_mesh
from lambdipy_tpu.train.checkpoint import \
    TrainCheckpointer as JaxCheckpointer
from lambdipy_tpu.train.loop import Trainer as JaxTrainer
from lambdipy_tpu.train.loop import TrainerConfig as JaxTrainerConfig
from lambdipy_tpu_torch.__main__ import main as cli_main
from lambdipy_tpu_torch.data import ShardedLoader, TokenSource
from lambdipy_tpu_torch.models import params as tparams
from lambdipy_tpu_torch.models import registry as treg
from lambdipy_tpu_torch.train.checkpoint import TrainCheckpointer
from lambdipy_tpu_torch.train.loop import Trainer, TrainerConfig
from lambdipy_tpu_torch.utils.debug import debug_numerics

EVAL_TOL = 1e-5


def _patterned_tokens(n=4000):
    return np.tile(np.arange(50, dtype=np.int32), n // 50)


def _loader(seq_len=16, batch=4, seed=5):
    return ShardedLoader(TokenSource(_patterned_tokens(), seq_len), batch,
                         seed=seed)


@pytest.fixture(scope="module")
def tiny():
    adapter = treg.get("llama-tiny").build()
    return adapter, adapter.init_params(seed=0, device="cpu")


def _trainer(tiny, cfg, **kw):
    adapter, sd = tiny
    return Trainer(adapter.train_forward, tparams.train_params(sd),
                   kw.pop("loader", None) or _loader(), cfg, device="cpu",
                   **kw)


def test_trainer_learns_and_logs(tiny):
    trainer = _trainer(tiny, TrainerConfig(total_steps=12, log_every=4,
                                           learning_rate=3e-3))
    report = trainer.run()
    assert report.final_step == 12 and report.steps_run == 12
    assert report.resumed_from is None
    assert [r["step"] for r in report.history] == [4, 8, 12]
    assert set(report.history[0]) == {"step", "loss", "ce_loss",
                                      "aux_loss", "grad_norm"}
    assert report.history[-1]["loss"] < report.history[0]["loss"]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_resume_is_bitwise_within_the_port(tiny, tmp_path):
    """8 uninterrupted steps against 4 + a checkpoint + a new Trainer
    (built with another loader seed, which the checkpoint overrides)
    resuming to 8: params, optimizer state, step and the logged rows
    exactly equal."""
    cfg = {"log_every": 2, "ckpt_every": 2, "learning_rate": 3e-3,
           "grad_clip": 1.0, "warmup_steps": 3}
    solo = _trainer(tiny, TrainerConfig(total_steps=8, **cfg))
    solo_report = solo.run()
    first = _trainer(tiny, TrainerConfig(total_steps=4, **cfg),
                     ckpt_dir=tmp_path / "ck")
    first_report = first.run()
    second = _trainer(tiny, TrainerConfig(total_steps=8, **cfg),
                      loader=_loader(seed=999), ckpt_dir=tmp_path / "ck")
    assert second.resumed_from == 4 and second.loader.state.seed == 5
    report = second.run()
    assert report.final_step == 8 and report.steps_run == 4
    assert first_report.history + report.history == solo_report.history
    for k, p in solo.state.params.items():
        assert torch.equal(second.state.params[k], p), k
    want, got = dict(_flat(solo.state.opt_state)), dict(
        _flat(second.state.opt_state))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert second.step == 8
    assert TrainCheckpointer(tmp_path / "ck").all_steps() == [4, 6, 8]


# each call: (step, force); the JAX trainer's pattern (every step offered,
# the last forced when off-cadence), a gap, a step at or below the latest,
# a forced off-cadence step and a reopened directory
CALLS = [(1, False), (2, False), (3, False), (4, False), (5, False),
         (6, False), (7, True), (7, False), (9, False), (10, False),
         (11, True), "reopen", (12, False), (13, False), (15, True),
         (16, False)]


def test_checkpoint_cadence_is_orbaxs(tmp_path):
    """The port's checkpointer and JAX's (orbax underneath) driven over one
    sequence of calls, at ``save_interval_steps`` 3 and ``max_to_keep``
    2: each call's answer, then the latest step and the kept steps."""
    state = {"w": np.arange(4, dtype=np.float32)}
    tstate = {"w": torch.arange(4, dtype=torch.float32)}
    kw = {"max_to_keep": 2, "save_interval_steps": 3}
    jck = JaxCheckpointer(tmp_path / "jax", **kw)
    tck = TrainCheckpointer(tmp_path / "port", **kw)
    try:
        for call in CALLS:
            if call == "reopen":
                jck.wait()
                jck.close()
                jck = JaxCheckpointer(tmp_path / "jax", **kw)
                tck = TrainCheckpointer(tmp_path / "port", **kw)
                continue
            step, force = call
            want = jck.save(step, state, force=force)
            jck.wait()
            assert tck.save(step, tstate, force=force) == want, call
            assert tck.latest_step() == jck.latest_step(), call
            assert tck.all_steps() == jck.all_steps(), call
        assert sorted(int(p.name) for p in (tmp_path / "port").iterdir()) \
            == tck.all_steps() == [12, 15]
        with pytest.raises(ValueError, match="already exists"):
            tck.save(15, tstate, force=True)
    finally:
        jck.wait()
        jck.close()


def test_restore_refuses_a_template_that_does_not_fit(tmp_path):
    """A key, a shape or a dtype that is not the checkpoint's raises; the
    step's own template restores; a temporary directory left by a save
    that died is ignored and removed."""
    ck = TrainCheckpointer(tmp_path)
    state = {"train": {"a": torch.ones(3), "n": torch.zeros((),
                                                            dtype=torch.int32)},
             "loader": {"epoch": 2}}
    assert ck.save(1, state)
    (tmp_path / ".tmp-2-999").mkdir()
    ck = TrainCheckpointer(tmp_path)
    assert not (tmp_path / ".tmp-2-999").exists() and ck.all_steps() == [1]
    back, at = ck.restore(state)
    assert at == 1 and back["loader"] == {"epoch": 2}
    assert torch.equal(back["train"]["a"], state["train"]["a"])
    for bad in ({**state, "train": {**state["train"], "b": torch.ones(1)}},
                {**state, "train": {**state["train"], "a": torch.ones(4)}},
                {**state, "train": {**state["train"],
                                    "a": torch.ones(3, dtype=torch.float64)}},
                {**state, "loader": {"epoch": 2, "seed": 0}}):
        with pytest.raises(ValueError):
            ck.restore(bad)
    assert TrainCheckpointer(tmp_path / "empty").restore(state) \
        == (None, None)


def test_evaluate_matches_jax(tiny):
    """From JAX's init params, the mean eval CE over two batches of a
    loader seeded 77, before training and after three steps (both
    trainers at lr 3e-3 on the same batches), agrees with JAX's."""
    jad = jreg.get("llama-tiny").build()
    jparams = jad.init_params(seed=0)
    mesh = make_mesh({"dp": 1}, devices=jax.devices()[:1])

    def jax_loader(seed):
        return JaxLoader(JaxSource(_patterned_tokens(), 16), 4, seed=seed,
                         process_index=0, process_count=1)

    cfg = {"total_steps": 3, "log_every": 3, "learning_rate": 3e-3}
    with use_mesh(mesh):
        jtr = JaxTrainer(jad.forward, jparams, mesh, jad.tp_rules,
                         jax_loader(5), JaxTrainerConfig(**cfg))
        jbefore = jtr.evaluate(jax_loader(77), batches=2)
        jtr.run()
        jafter = jtr.evaluate(jax_loader(77), batches=2)
    adapter = tiny[0]
    sd = tparams.from_jax_params(jax.device_get(jparams))
    trainer = Trainer(adapter.train_forward, tparams.train_params(sd),
                      _loader(), TrainerConfig(**cfg), device="cpu")
    before = trainer.evaluate(_loader(seed=77), batches=2)
    trainer.run()
    after = trainer.evaluate(_loader(seed=77), batches=2)
    assert before == pytest.approx(jbefore, rel=EVAL_TOL)
    assert after == pytest.approx(jafter, rel=EVAL_TOL)
    assert after < before


def test_debug_numerics_raises_on_a_poisoned_weight(tiny):
    """A NaN in one weight: under ``debug_numerics`` the first step raises
    ``FloatingPointError`` naming the first non-finite output (the loss);
    without it the step logs a NaN loss and carries on. The context
    restores what it found."""
    adapter, sd = tiny
    poisoned = {k: v.clone() for k, v in sd.items()}
    poisoned["layer_0.q_proj.kernel"][0, 0] = float("nan")
    cfg = {"total_steps": 2, "log_every": 1}
    trainer = Trainer(adapter.train_forward, tparams.train_params(poisoned),
                      _loader(), TrainerConfig(debug_numerics=True, **cfg),
                      device="cpu")
    with pytest.raises(FloatingPointError, match="nan.*loss"):
        trainer.run()
    plain = Trainer(adapter.train_forward, tparams.train_params(poisoned),
                    _loader(), TrainerConfig(**cfg), device="cpu")
    assert np.isnan(plain.run().history[-1]["loss"])
    from lambdipy_tpu_torch.utils import debug

    with debug_numerics(infs=True):
        assert debug._ACTIVE == {"nans": True, "infs": True}
        with debug_numerics(nans=None):
            assert debug._ACTIVE == {"nans": True, "infs": True}
    assert debug._ACTIVE == {"nans": False, "infs": False}


def _cli(capsys, *argv) -> tuple[int, str, str]:
    rc = cli_main(list(argv))
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_train_cli_runs_and_resumes_on_the_cpu(tmp_path, capsys):
    """JAX's test of ``train``, through the port's CLI with ``--device
    cpu``: 4 steps, then a re-run to 6 resumes at 4; the last line holds
    JAX's keys."""
    np.save(tmp_path / "toks.npy", _patterned_tokens())
    args = ["train", "--model", "llama-tiny", "--data",
            str(tmp_path / "toks.npy"), "--steps", "4", "--batch", "4",
            "--seq-len", "16", "--ckpt-dir", str(tmp_path / "ck"),
            "--ckpt-every", "2", "--mesh", "dp=1", "--device", "cpu"]
    rc, out, _ = _cli(capsys, *args)
    assert rc == 0
    first = json.loads(out.strip().splitlines()[-1])
    assert set(first) == {"model", "final_step", "steps_run",
                          "resumed_from", "mesh", "final_metrics"}
    assert first["final_step"] == 4 and first["resumed_from"] is None
    assert first["mesh"] == {"dp": 1} and first["final_metrics"]["step"] == 4
    rc, out, _ = _cli(capsys, *args[:5], "--steps", "6", *args[7:])
    assert rc == 0
    second = json.loads(out.strip().splitlines()[-1])
    assert second["resumed_from"] == 4 and second["final_step"] == 6
    assert second["steps_run"] == 2


@pytest.mark.parametrize("mesh,message,model", [
    ("dp2", "bad --mesh entry 'dp2' (want axis=size, e.g. dp=2,tp=4): "
            "missing '='", "llama-tiny"),
    ("dp=2,tp=1", "needs 2 processes, one device each; this job has 1",
     "llama-tiny"),
    ("tp=2", "tensor parallelism is not ported yet (ROADMAP queue 1, item 3 "
             "(c))", "llama-tiny"),
    ("dp=1,ep=2", "item 3 (d)", "llama-tiny"),
    ("sp=2", "item 3 (e)", "llama-tiny"),
    ("pp=2", "item 3 (f)", "llama-tiny"),
    # before it asks for two processes: JAX routes an MoE layer over the
    # global batch, a rank over its own rows
    ("dp=2", "each rank would route its own rows, with its own routing "
             "groups, capacities and drops, where JAX routes the global "
             "batch (ROADMAP queue 1, item 3 (d))", "llama-moe-tiny"),
], ids=["bad_entry", "two_devices", "tp", "ep", "sp", "pp", "moe_dp"])
def test_train_cli_rejects_a_mesh(tmp_path, capsys, mesh, message, model):
    np.save(tmp_path / "toks.npy", _patterned_tokens())
    rc, out, err = _cli(capsys, "train", "--model", model, "--data",
                        str(tmp_path / "toks.npy"), "--steps", "1", "--mesh",
                        mesh, "--device", "cpu")
    assert rc != 0 and message in err and not out
