"""Trainer: the resumable training loop, the twin of
``lambdipy_tpu/train/loop.py``.

Ties the pieces together: deterministic data (``data/loader.py``), the
train step with JAX's optimizer stack (``train/step.py``) and the port's
checkpoints with exact resume (``train/checkpoint.py``), in JAX's loop:
JSON step logs every ``log_every`` steps and at the last, a checkpoint
offered at every step (the checkpointer's cadence decides), the final
state always saved, and a resume that replays the identical batch
sequence. The step is enqueued on the card without a sync; only logging
steps read the metrics on the host.

JAX's ``(mesh, rules)`` are keywords here, beside ``device`` (the card
unless the caller asks for the CPU): with no mesh the trainer runs on one
device; over a mesh of N devices it runs as one of N processes, one per
device (``parallel/distributed.py``), each stepping on its own rows
(``train/step.py``). Its checkpoints are the one-device format: rank 0
gathers the whole state and writes it, every rank then meets the others
at a barrier, and a restore takes each rank's block, so a checkpoint
written by N ranks restores in one process and the reverse.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

import torch

from lambdipy_tpu_torch.utils.logs import get_logger, log_event

log = get_logger("lambdipy.train")


@dataclass
class TrainerConfig:
    total_steps: int
    learning_rate: float = 1e-3
    log_every: int = 10
    ckpt_every: int = 100
    keep_ckpts: int = 3
    fsdp: bool = True
    aux_weight: float = 0.01
    # the optimizer stack (train/step.py make_optimizer): global-norm
    # clipping, warmup / cosine decay, gradient accumulation (total_steps
    # counts micro-steps; params update every accum_steps-th step); all
    # off by default, as in JAX
    grad_clip: float | None = None
    warmup_steps: int = 0
    schedule: str = "constant"  # "constant" | "cosine"
    weight_decay: float = 0.0
    accum_steps: int = 1
    # numerics check (utils/debug.py): a NaN in any step output raises
    # FloatingPointError naming the leaf; one device sync per step
    debug_numerics: bool = False


@dataclass
class TrainerReport:
    steps_run: int
    final_step: int
    resumed_from: int | None
    history: list[dict] = field(default_factory=list)  # logged metric rows


class Trainer:
    """Resumable training on one device, or as one rank of a mesh.

    ``model_apply(params, tokens) -> logits`` (plus an optional
    ``model_apply_aux`` for MoE balance losses), e.g. a registry model's
    ``train_forward``; ``params`` is the INIT dict of float tensors
    (``models/params.py train_params``), copied onto ``device``. When
    ``ckpt_dir`` holds a checkpoint, training resumes from it instead
    (the same keys, shapes and dtypes, or the restore raises). ``mesh``
    and ``rules`` are :func:`~lambdipy_tpu_torch.train.step.sharded_train_step`'s.
    """

    def __init__(self, model_apply: Callable, params: dict, loader,
                 cfg: TrainerConfig, *, device=None, mesh=None, rules=None,
                 ckpt_dir: Path | str | None = None,
                 model_apply_aux: Callable | None = None):
        from lambdipy_tpu_torch.train.checkpoint import TrainCheckpointer
        from lambdipy_tpu_torch.train.step import (make_optimizer,
                                                   sharded_train_step)

        self.cfg = cfg
        self.loader = loader
        self.model_apply = model_apply
        optimizer = make_optimizer(
            cfg.learning_rate, total_steps=cfg.total_steps,
            warmup_steps=cfg.warmup_steps, schedule=cfg.schedule,
            grad_clip=cfg.grad_clip, weight_decay=cfg.weight_decay,
            accum_steps=cfg.accum_steps)
        self.step_fn, self.state, self.device = sharded_train_step(
            model_apply, params, mesh, rules, device=device,
            learning_rate=cfg.learning_rate, fsdp=cfg.fsdp,
            model_apply_aux=model_apply_aux, aux_weight=cfg.aux_weight,
            optimizer=optimizer)
        self.mesh = self.step_fn.mesh

        self.ckpt: Any = None
        self.resumed_from: int | None = None
        if ckpt_dir is not None:
            self.ckpt = TrainCheckpointer(
                ckpt_dir, max_to_keep=cfg.keep_ckpts,
                save_interval_steps=cfg.ckpt_every,
                shardings=self.step_fn.shardings)
            restored, at = self.ckpt.restore(
                {"train": self.state, "loader": loader.state_dict()})
            if restored is not None:
                self.state = restored["train"]
                loader.restore({k: int(v)
                                for k, v in restored["loader"].items()})
                self.resumed_from = at
                log_event(log, "trainer resumed", step=at)

    @property
    def step(self) -> int:
        """The device's step counter (a sync)."""
        return int(self.state.step)

    def run(self) -> TrainerReport:
        """Train until ``cfg.total_steps`` (absolute, resume-aware)."""
        from lambdipy_tpu_torch.utils.debug import debug_numerics

        with (debug_numerics() if self.cfg.debug_numerics
              else contextlib.nullcontext()):
            return self._run()

    def _run(self) -> TrainerReport:
        start = self.step
        history: list[dict] = []
        for host_step in range(start + 1, self.cfg.total_steps + 1):
            batch = self.loader.place(self.loader.next_batch(), self.mesh,
                                      device=self.device)
            self.state, metrics = self.step_fn(self.state, batch)
            # metrics reach the host only on logging steps
            if host_step % self.cfg.log_every == 0 or \
                    host_step == self.cfg.total_steps:
                row = {"step": host_step,
                       **{k: round(float(v), 5) for k, v in metrics.items()}}
                history.append(row)
                log_event(log, "train step", **row)
            if self.ckpt is not None:
                # the checkpointer's save_interval_steps decides the cadence
                self.ckpt.save(host_step,
                               {"train": self.state,
                                "loader": self.loader.state_dict()})
        if self.ckpt is not None and start < self.cfg.total_steps:
            if self.ckpt.latest_step() != self.cfg.total_steps:
                # the final state is always durable, even off-cadence (a
                # cadence save of the same step would collide: skipped)
                self.ckpt.save(self.cfg.total_steps,
                               {"train": self.state,
                                "loader": self.loader.state_dict()},
                               force=True)
            self.ckpt.wait()
        final = self.step
        return TrainerReport(steps_run=final - start, final_step=final,
                             resumed_from=self.resumed_from, history=history)

    def evaluate(self, eval_loader, *, batches: int = 8) -> float:
        """Mean next-token CE over ``batches`` eval batches (no updates;
        over a mesh, each rank's mean over its rows averaged)."""
        from lambdipy_tpu_torch.train.step import DataParallel, lm_loss

        shardings = self.step_fn.shardings
        dp = DataParallel(shardings) if shardings is not None else None
        total = 0.0
        with torch.no_grad():
            params = (dp.gather(self.state.params) if dp is not None
                      else self.state.params)
            for _ in range(batches):
                batch = eval_loader.place(eval_loader.next_batch(), self.mesh,
                                          device=self.device)
                loss = lm_loss(self.model_apply(params, batch[:, :-1]),
                               batch[:, 1:])
                if dp is not None:
                    (loss,) = dp.mean(loss)
                total += float(loss)
        return total / batches

    # -- lifecycle ----------------------------------------------------------

    def close(self) -> None:
        """Flush and release the checkpointer."""
        if self.ckpt is not None:
            self.ckpt.wait()
            self.ckpt.close()
            self.ckpt = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
