"""The language-model train step and its optimizer stack, the twin of
``lambdipy_tpu/train/step.py``.

The optimizer is JAX's: optax 0.2.6's ``adamw`` (``scale_by_adam``, then
``add_decayed_weights``, then ``scale_by_learning_rate``),
``clip_by_global_norm``, ``linear_schedule``,
``warmup_cosine_decay_schedule`` and ``MultiSteps``, written here as plain
tensor functions with optax's arithmetic, op for op: the same moments in
each param's dtype, bias correction by the incremented count, the
schedule read at the count before the increment, the clip's
``where(g_norm < max_norm, g, g / g_norm * max_norm)`` and the
accumulator's running mean. ``torch.optim.AdamW`` and
``clip_grad_norm_`` compute other numbers (another eps placement, a
``max_norm / (norm + 1e-6)`` clip) and are not used. A transformation is
optax's pair of functions, ``init(params) -> state`` and
``update(updates, state, params) -> (updates, state)``; params, grads,
updates and states are dicts of tensors (the state's counters int32
scalars on the params' device), so a state is a tree that
``train/checkpoint.py`` writes as it is.

One device: there are no shardings, and :func:`sharded_train_step` takes
a mesh of one device and refuses a larger one (parallelism comes with
``ROADMAP.md`` queue 1, item 3).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from lambdipy_tpu_torch.train.checkpoint import tree_paths
from lambdipy_tpu_torch.utils import debug
from lambdipy_tpu_torch.utils.platform import resolve_device

_INT32_MAX = 2 ** 31 - 1


class GradientTransformation(NamedTuple):
    """optax's ``GradientTransformation``: ``init(params) -> state``,
    ``update(updates, state, params=None) -> (updates, state)``."""

    init: Callable
    update: Callable


@dataclass
class TrainState:
    params: dict
    opt_state: Any
    step: torch.Tensor  # int32 scalar on the params' device


def _count(params: dict) -> torch.Tensor:
    """A zero int32 counter on the params' device."""
    device = next(iter(params.values())).device if params else None
    return torch.zeros((), dtype=torch.int32, device=device)


def safe_increment(count: torch.Tensor) -> torch.Tensor:
    """``count + 1``, held at the int32 maximum (optax's)."""
    return torch.where(count < _INT32_MAX, count + 1, count)


def global_norm(tree: dict) -> torch.Tensor:
    """optax's ``global_norm``: the square root of the sum over the leaves
    (in key order, a left fold from 0) of each leaf's sum of squares, each
    leaf's sum in the leaf's dtype."""
    total = 0
    for k in sorted(tree):
        g = tree[k]
        total = total + torch.sum(g * g)
    return torch.sqrt(torch.as_tensor(total))


def apply_updates(params: dict, updates: dict) -> dict:
    """optax's ``apply_updates``: ``p + u`` in the param's dtype."""
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}


# ---------------------------------------------------------------- schedules

def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int):
    """optax's ``linear_schedule`` (its polynomial of power 1) over an
    int32 count tensor; a constant ``init_value`` when ``transition_steps
    <= 0``."""
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count):
        count = torch.clamp(count, 0, transition_steps)
        frac = 1 - count / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int):
    """optax's ``warmup_cosine_decay_schedule`` to an end value of 0: a
    linear warmup to ``peak_value``, then from ``warmup_steps`` on
    (optax's ``join_schedules``) ``peak * 0.5 (1 + cos(pi min(t, T) /
    T))`` at ``t = step - warmup_steps``, ``T = decay_steps -
    warmup_steps``, in f32. (optax's ``(1 - alpha) * c ** exponent +
    alpha`` at alpha 0 and exponent 1 is ``c``, bit for bit.)"""
    steps = decay_steps - warmup_steps
    if not steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive "
                         "decay_steps!")
    warmup = linear_schedule(init_value, peak_value, warmup_steps)

    def schedule(step):
        t = torch.clamp((step - warmup_steps).to(torch.float32),
                        max=float(steps))
        decayed = peak_value * (0.5 * (1 + torch.cos(math.pi * t / steps)))
        early = torch.as_tensor(warmup(step), dtype=torch.float32,
                                device=step.device)
        return torch.where(step < warmup_steps, early, decayed)

    return schedule


# ------------------------------------------------------------- transforms

def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  eps_root: float = 0.0) -> GradientTransformation:
    """optax's ``scale_by_adam``: ``mu``, ``nu`` in each param's dtype;
    ``m_hat / (sqrt(v_hat + eps_root) + eps)`` with the bias corrections
    ``1 - b ** count`` at the incremented count, computed in f32 and
    divided in the moment's dtype."""

    def init(params):
        return {"count": _count(params),
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(updates, state, params=None):
        mu = {k: (1 - b1) * g + b1 * state["mu"][k]
              for k, g in updates.items()}
        nu = {k: (1 - b2) * g ** 2 + b2 * state["nu"][k]
              for k, g in updates.items()}
        count_inc = safe_increment(state["count"])
        steps = count_inc.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                         device=steps.device), steps)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                         device=steps.device), steps)
        out = {}
        for k in updates:
            m_hat = mu[k] / bc1.to(mu[k].dtype)
            v_hat = nu[k] / bc2.to(nu[k].dtype)
            out[k] = m_hat / (torch.sqrt(v_hat + eps_root) + eps)
        return out, {"count": count_inc, "mu": mu, "nu": nu}

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float = 0.0) -> GradientTransformation:
    """optax's ``add_decayed_weights``: ``g + weight_decay * p`` (computed
    at 0.0 too, as optax does)."""

    def update(updates, state, params=None):
        if params is None:
            raise ValueError("add_decayed_weights needs the params")
        return ({k: g + weight_decay * params[k]
                 for k, g in updates.items()}, state)

    return GradientTransformation(lambda params: {}, update)


def scale_by_learning_rate(learning_rate) -> GradientTransformation:
    """optax's ``scale_by_learning_rate``: ``-lr * g`` for a constant; for
    a schedule, ``-schedule(count)`` (the count before its increment) in
    the update's dtype, times ``g``, with a count of its own."""
    if not callable(learning_rate):
        step_size = -1 * learning_rate

        def update_constant(updates, state, params=None):
            return {k: step_size * g for k, g in updates.items()}, state

        return GradientTransformation(lambda params: {}, update_constant)

    def init(params):
        return {"count": _count(params)}

    def update(updates, state, params=None):
        step_size = -1 * learning_rate(state["count"])
        out = {k: torch.as_tensor(step_size, device=g.device).to(g.dtype) * g
               for k, g in updates.items()}
        return out, {"count": safe_increment(state["count"])}

    return GradientTransformation(init, update)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """optax's ``clip_by_global_norm``: the updates as they are when their
    global norm is below ``max_norm``, else ``(g / g_norm) * max_norm``."""

    def update(updates, state, params=None):
        g_norm = global_norm(updates)
        trigger = g_norm < max_norm
        return ({k: torch.where(trigger, g,
                                (g / g_norm.to(g.dtype)) * max_norm)
                 for k, g in updates.items()}, state)

    return GradientTransformation(lambda params: {}, update)


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    """optax's ``chain``; its state a dict ``{"0": ..., "1": ...}``."""

    def init(params):
        return {str(i): t.init(params) for i, t in enumerate(transforms)}

    def update(updates, state, params=None):
        new = {}
        for i, t in enumerate(transforms):
            updates, new[str(i)] = t.update(updates, state[str(i)], params)
        return updates, new

    return GradientTransformation(init, update)


def adamw(learning_rate, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, eps_root: float = 0.0,
          weight_decay: float = 1e-4) -> GradientTransformation:
    """optax's ``adamw`` at its defaults (weight decay 1e-4)."""
    return chain(scale_by_adam(b1, b2, eps, eps_root),
                 add_decayed_weights(weight_decay),
                 scale_by_learning_rate(learning_rate))


def multi_steps(opt: GradientTransformation,
                every_k: int) -> GradientTransformation:
    """optax's ``MultiSteps`` with a constant ``every_k`` and the gradient
    mean: each call folds the grads into a running mean (``acc + (g -
    acc) / (mini_step + 1)``) and runs ``opt`` on it; every ``every_k``-th
    call keeps ``opt``'s new state and returns its updates, the others
    keep the old state and return zeros, so the inner count advances once
    per accumulated update."""

    def init(params):
        return {"mini_step": _count(params), "gradient_step": _count(params),
                "inner_opt_state": opt.init(params),
                "acc_grads": {k: torch.zeros_like(p)
                              for k, p in params.items()}}

    def update(updates, state, params=None):
        mini = state["mini_step"]
        acc = {k: a + (updates[k] - a) / (mini + 1)
               for k, a in state["acc_grads"].items()}
        final, new_inner = opt.update(acc, state["inner_opt_state"], params)
        emit = mini == every_k - 1
        keep = emit.to(torch.int32)
        grad_step = state["gradient_step"]
        new_state = {
            "mini_step": safe_increment(mini) % every_k,
            "gradient_step": keep * safe_increment(grad_step)
            + (1 - keep) * grad_step,
            "inner_opt_state": _tree_where(emit, new_inner,
                                           state["inner_opt_state"]),
            "acc_grads": {k: (1 - keep) * a.to(final[k].dtype)
                          for k, a in acc.items()},
        }
        return ({k: emit.to(u.dtype) * u for k, u in final.items()},
                new_state)

    return GradientTransformation(init, update)


def _tree_where(cond, new, old):
    if isinstance(new, dict):
        return {k: _tree_where(cond, new[k], old[k]) for k in new}
    return torch.where(cond, new, old)


def make_optimizer(learning_rate: float, *, total_steps: int | None = None,
                   warmup_steps: int = 0, schedule: str = "constant",
                   grad_clip: float | None = None, weight_decay: float = 0.0,
                   accum_steps: int = 1) -> GradientTransformation:
    """The trainer's optimizer stack, JAX's ``make_optimizer``:
    [clip] -> adamw(lr schedule), in :func:`multi_steps` when
    ``accum_steps > 1``. ``schedule``: "constant" (an optional linear
    warmup) or "cosine" (warmup, then a cosine decay to 0 over
    ``total_steps``, ``decay_steps = max(total, warmup + 1)``).
    ``total_steps`` and ``warmup_steps`` count micro-steps: under
    accumulation the inner schedule advances once per update, so both
    horizons are divided by ``accum_steps``. Weight decay defaults to 0.0
    here; :func:`adamw` alone (the default of
    :func:`sharded_train_step`) decays by 1e-4, as optax's does."""
    if accum_steps > 1:
        total_steps = total_steps and max(1, total_steps // accum_steps)
        warmup_steps = warmup_steps // accum_steps
    lr: Any
    if schedule == "cosine":
        if not total_steps:
            raise ValueError("cosine schedule needs total_steps")
        lr = warmup_cosine_decay_schedule(
            0.0, learning_rate, warmup_steps,
            max(total_steps, warmup_steps + 1))
    elif schedule == "constant":
        lr = (linear_schedule(0.0, learning_rate, warmup_steps)
              if warmup_steps else learning_rate)
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    parts = []
    if grad_clip:
        parts.append(clip_by_global_norm(grad_clip))
    parts.append(adamw(lr, weight_decay=weight_decay))
    tx = chain(*parts) if len(parts) > 1 else parts[0]
    if accum_steps > 1:
        tx = multi_steps(tx, accum_steps)
    return tx


# ------------------------------------------------------------- the step

def lm_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy as JAX's: f32 ``log_softmax``, the
    target's negative log-likelihood, its mean."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    return torch.mean(nll)


def make_train_step(model_apply: Callable, optimizer: GradientTransformation,
                    *, model_apply_aux: Callable | None = None,
                    aux_weight: float = 0.01):
    """A ``(state, tokens) -> (state, metrics)`` LM train step, JAX's
    ``make_train_step``. ``model_apply(params, tokens) -> logits``; the
    loss is next-token cross-entropy over ``tokens [b, s + 1]``, plus
    ``aux_weight * aux`` when ``model_apply_aux(params, tokens) ->
    (logits, aux)`` is given (an MoE model's balance loss). Metrics
    ``loss``, ``ce_loss``, ``aux_loss`` and ``grad_norm`` (the global
    norm of the raw grads) as 0-dim tensors, read without a sync; the
    state is new tensors (the step works out of place)."""

    def loss_fn(params, tokens):
        if model_apply_aux is not None:
            logits, aux = model_apply_aux(params, tokens[:, :-1])
        else:
            logits = model_apply(params, tokens[:, :-1])
            aux = torch.zeros((), dtype=torch.float32, device=logits.device)
        ce = lm_loss(logits, tokens[:, 1:])
        return ce + aux_weight * aux, (ce, aux)

    def step(state: TrainState, tokens: torch.Tensor):
        with torch.enable_grad():
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in state.params.items()}
            loss, (ce, aux) = loss_fn(leaves, tokens)
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, state.opt_state,
                                                  state.params)
            params = apply_updates(state.params, updates)
            gnorm = global_norm(grads)
        metrics = {"loss": loss.detach(), "ce_loss": ce.detach(),
                   "aux_loss": aux.detach(), "grad_norm": gnorm}
        if debug.numerics_checked():
            debug.check_numerics(
                list(metrics.items())
                + [("/".join(path), t) for path, t in tree_paths(
                    {"grads": grads, "params": params,
                     "opt_state": opt_state})])
        return (TrainState(params=params, opt_state=opt_state,
                           step=state.step + 1), metrics)

    return step


def init_train_state(params: dict,
                     optimizer: GradientTransformation) -> TrainState:
    with torch.no_grad():
        return TrainState(params=params, opt_state=optimizer.init(params),
                          step=_count(params))


def sharded_train_step(model_apply: Callable, params: dict, mesh=None,
                       rules=None, *, device=None,
                       learning_rate: float = 1e-3, fsdp: bool = True,
                       model_apply_aux: Callable | None = None,
                       aux_weight: float = 0.01,
                       optimizer: GradientTransformation | None = None):
    """JAX's convenience on one device: returns ``(step, state,
    device)``, the state's params fresh copies of ``params`` on
    ``device`` (the card unless the caller asks for the CPU), so the
    caller's tensors are never touched. The default optimizer is
    :func:`adamw` at ``learning_rate`` with optax's weight decay of 1e-4.
    ``mesh`` may name one device (``None``, ``{"dp": 1}``); a larger one
    raises. ``rules`` and ``fsdp`` shard nothing on one device."""
    from lambdipy_tpu_torch.data.loader import MESH_REFUSED, mesh_devices

    del rules, fsdp
    if mesh_devices(mesh) > 1:
        raise NotImplementedError(MESH_REFUSED)
    dev = resolve_device(device)
    if optimizer is None:
        optimizer = adamw(learning_rate)
    for k, p in params.items():
        if not p.is_floating_point():
            raise TypeError(f"grad requires real-valued inputs; param {k} "
                            f"is {p.dtype}")
    with torch.no_grad():
        placed = {k: p.detach().to(dev, copy=True) for k, p in params.items()}
    state = init_train_state(placed, optimizer)
    step = make_train_step(model_apply, optimizer,
                           model_apply_aux=model_apply_aux,
                           aux_weight=aux_weight)
    return step, state, dev
