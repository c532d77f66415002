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

Over a mesh, one process per
device: :func:`sharded_train_step` gives each param JAX's spec
(:func:`train_shardings`: the model's rules, then FSDP over ``dp`` on the
first evenly divisible dim of every kernel of two dims or more), holds a
sharded param as this rank's block, and runs explicit collectives
(:class:`DataParallel`): params all-gathered before the forward, each
rank's gradient of its own rows' mean loss reduce-scattered (a sharded
param) or all-reduced (a replicated one) and divided by the world size,
the metrics all-reduced and divided alike, and the optimizer run on the
blocks. Clipping and the ``grad_norm`` metric take the global norm: each
sharded leaf's sum of squares is all-reduced before the fold (the step
hands :meth:`DataParallel.norm_sums` to the optimizer as its
``norm_sums`` extra argument, and to :func:`global_norm`). With one
rank every collective and the division are bitwise identities, and a
mesh with no process group runs the step of one device as it is.
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
    """optax's ``GradientTransformationExtraArgs``: ``init(params) ->
    state``, ``update(updates, state, params=None, **extra_args) ->
    (updates, state)``. The one extra argument is ``norm_sums``, which a
    data-parallel step hands down for :func:`clip_by_global_norm`; the
    other transformations ignore it."""

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


def global_norm(tree: dict, norm_sums: Callable | None = None
                ) -> torch.Tensor:
    """optax's ``global_norm``: the square root of the sum over the leaves
    (in key order, a left fold from 0) of each leaf's sum of squares, each
    leaf's sum in the leaf's dtype. ``norm_sums`` (a data-parallel step's
    :meth:`DataParallel.norm_sums`) completes the per-leaf sums over the
    ranks, so the norm of a tree of blocks is the global one."""
    sums = {k: torch.sum(tree[k] * tree[k]) for k in sorted(tree)}
    if norm_sums is not None:
        sums = norm_sums(sums)
    total = 0
    for k in sorted(tree):
        total = total + sums[k]
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

    def update(updates, state, params=None, **extra_args):
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

    def update(updates, state, params=None, **extra_args):
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

        def update_constant(updates, state, params=None, **extra_args):
            return {k: step_size * g for k, g in updates.items()}, state

        return GradientTransformation(lambda params: {}, update_constant)

    def init(params):
        return {"count": _count(params)}

    def update(updates, state, params=None, **extra_args):
        step_size = -1 * learning_rate(state["count"])
        out = {k: torch.as_tensor(step_size, device=g.device).to(g.dtype) * g
               for k, g in updates.items()}
        return out, {"count": safe_increment(state["count"])}

    return GradientTransformation(init, update)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """optax's ``clip_by_global_norm``: the updates as they are when their
    global norm is below ``max_norm``, else ``(g / g_norm) * max_norm``;
    the norm over the ranks when the step hands down ``norm_sums``."""

    def update(updates, state, params=None, *, norm_sums=None,
               **extra_args):
        g_norm = global_norm(updates, norm_sums)
        trigger = g_norm < max_norm
        return ({k: torch.where(trigger, g,
                                (g / g_norm.to(g.dtype)) * max_norm)
                 for k, g in updates.items()}, state)

    return GradientTransformation(lambda params: {}, update)


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    """optax's ``chain``; its state a dict ``{"0": ..., "1": ...}``."""

    def init(params):
        return {str(i): t.init(params) for i, t in enumerate(transforms)}

    def update(updates, state, params=None, **extra_args):
        new = {}
        for i, t in enumerate(transforms):
            updates, new[str(i)] = t.update(updates, state[str(i)], params,
                                            **extra_args)
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

    def update(updates, state, params=None, **extra_args):
        mini = state["mini_step"]
        acc = {k: a + (updates[k] - a) / (mini + 1)
               for k, a in state["acc_grads"].items()}
        final, new_inner = opt.update(acc, state["inner_opt_state"], params,
                                      **extra_args)
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
                    aux_weight: float = 0.01,
                    collectives: "DataParallel | None" = None):
    """A ``(state, tokens) -> (state, metrics)`` LM train step, JAX's
    ``make_train_step``. ``model_apply(params, tokens) -> logits``; the
    loss is next-token cross-entropy over ``tokens [b, s + 1]``, plus
    ``aux_weight * aux`` when ``model_apply_aux(params, tokens) ->
    (logits, aux)`` is given (an MoE model's balance loss). Metrics
    ``loss``, ``ce_loss``, ``aux_loss`` and ``grad_norm`` (the global
    norm of the raw grads) as 0-dim tensors, read without a sync; the
    state is new tensors (the step works out of place). ``collectives``
    (:class:`DataParallel`): the state holds this rank's blocks, and the
    step is the data-parallel one over the process group."""

    def loss_fn(params, tokens):
        if model_apply_aux is not None:
            logits, aux = model_apply_aux(params, tokens[:, :-1])
        else:
            logits = model_apply(params, tokens[:, :-1])
            aux = torch.zeros((), dtype=torch.float32, device=logits.device)
        ce = lm_loss(logits, tokens[:, 1:])
        return ce + aux_weight * aux, (ce, aux)

    def step(state: TrainState, tokens: torch.Tensor):
        params = state.params
        if collectives is not None:
            with torch.no_grad():
                params = collectives.gather(params)
        with torch.enable_grad():
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in params.items()}
            loss, (ce, aux) = loss_fn(leaves, tokens)
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
        with torch.no_grad():
            extra = {}
            if collectives is not None:
                grads = collectives.reduce(grads)
                loss, ce, aux = collectives.mean(loss.detach(), ce.detach(),
                                                 aux.detach())
                extra = {"norm_sums": collectives.norm_sums}
            updates, opt_state = optimizer.update(grads, state.opt_state,
                                                  state.params, **extra)
            params = apply_updates(state.params, updates)
            gnorm = global_norm(grads, **extra)
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


def _fsdp_augment(spec, shape, mesh):
    """JAX's: FSDP sharding over the ``dp`` axis on the first unsharded dim
    of a kernel of two dims or more that ``dp`` divides evenly, composed
    with the rules' spec (``shape`` in flax's layout)."""
    from lambdipy_tpu_torch.parallel.sharding import P

    if "dp" not in mesh.axis_names or len(shape) < 2:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    dp_size = mesh.shape["dp"]
    for i, e in enumerate(entries):
        if e is None and shape[i] % dp_size == 0 and shape[i] >= dp_size:
            entries[i] = "dp"
            break
    return P(*entries)


def train_shardings(params: dict, mesh, rules=None, *,
                    fsdp: bool = True) -> dict:
    """``{key: NamedSharding}`` of a dict of params (anything with a
    ``shape``), JAX's ``train_shardings``: the rules' spec on each key's
    JAX path, plus FSDP over ``dp`` when ``fsdp``."""
    from lambdipy_tpu_torch.parallel.sharding import NamedSharding, key_spec

    augment = _fsdp_augment if fsdp else None
    return {k: NamedSharding(mesh, key_spec(k, t.shape, mesh, rules,
                                            augment))
            for k, t in params.items()}


class DataParallel:
    """The collectives of a data-parallel step over the process group, for
    params of ``shardings`` whose only split axis is ``dp`` (the others
    are refused, :func:`~lambdipy_tpu_torch.parallel.mesh.job_mesh`), the
    mesh's ranks in rank order. A sharded param's block is rank ``r``'s
    ``r``-th along its ``dp`` dim."""

    def __init__(self, shardings: dict):
        from lambdipy_tpu_torch.parallel.distributed import process_count

        self.shardings = shardings
        self.world = process_count()
        self.dims = {k: next((d for d, e in enumerate(s.spec)
                              if e is not None), None)
                     for k, s in shardings.items()}

    def gather(self, params: dict) -> dict:
        return {k: self.shardings[k].gather(p) for k, p in params.items()}

    def reduce(self, grads: dict) -> dict:
        """Each rank's grads of the whole params -> the mean over the ranks
        of this rank's blocks."""
        from lambdipy_tpu_torch.parallel.distributed import (all_reduce,
                                                             reduce_scatter)

        out = {}
        for k, g in grads.items():
            dim = self.dims[k]
            g = all_reduce(g) if dim is None else reduce_scatter(g, dim)
            out[k] = g / self.world
        return out

    def mean(self, *scalars: torch.Tensor) -> tuple:
        """0-dim tensors, each the mean over the ranks."""
        total = _sum_over_ranks(dict(enumerate(scalars)))
        return tuple(total[i] / self.world for i in range(len(scalars)))

    def norm_sums(self, sums: dict) -> dict:
        """Per-leaf sums of squares: a sharded leaf's completed over the
        ranks; a replicated leaf's, the same on every rank, as it is."""
        return {**sums, **_sum_over_ranks(
            {k: s for k, s in sums.items() if self.dims.get(k) is not None})}


def _sum_over_ranks(scalars: dict) -> dict:
    """0-dim tensors summed over the ranks: one all-reduce per dtype."""
    from lambdipy_tpu_torch.parallel.distributed import all_reduce

    out = {}
    # the same order on every rank: collectives pair up by order
    for dtype in sorted({s.dtype for s in scalars.values()}, key=str):
        keys = [k for k, s in scalars.items() if s.dtype == dtype]
        total = all_reduce(torch.stack([scalars[k] for k in keys]))
        out.update(zip(keys, total.unbind()))
    return out


# JAX routes an MoE layer's tokens over the global batch; a rank holds its
# own rows only
MOE_OVER_RANKS = ("an MoE model does not train over more than one rank yet: "
                  "each rank would route its own rows, with its own routing "
                  "groups, capacities and drops, where JAX routes the global "
                  "batch (ROADMAP queue 1, item 3 (d))")


def refuse_routing_over_ranks(mesh) -> None:
    """Raise ``NotImplementedError`` (:data:`MOE_OVER_RANKS`) when
    ``mesh`` (None, a ``Mesh`` or ``{axis: size}``, a ``-1`` filled by
    the process count) spans more than one device: a model that routes
    tokens (an MoE model) trains on one device only."""
    from lambdipy_tpu_torch.parallel.distributed import process_count
    from lambdipy_tpu_torch.parallel.mesh import Mesh

    if mesh is None:
        return
    shape = dict(mesh.shape if isinstance(mesh, Mesh) else mesh)
    sizes = [int(s) for s in shape.values()]
    size = process_count() if -1 in sizes else math.prod(sizes)
    if size > 1:
        raise NotImplementedError(f"mesh {shape}: {MOE_OVER_RANKS}")


@dataclass
class ShardedStep:
    """What :func:`sharded_train_step` returns as its step: a callable
    ``(state, tokens) -> (state, metrics)``, with the mesh it runs over
    (None: one device) and the params' shardings (None unless a process
    group is up: the state then holds this rank's blocks)."""

    fn: Callable
    mesh: Any = None
    shardings: dict | None = None

    def __call__(self, state: TrainState, tokens: torch.Tensor):
        return self.fn(state, tokens)


def sharded_train_step(model_apply: Callable, params: dict, mesh=None,
                       rules=None, *, device=None,
                       learning_rate: float = 1e-3, fsdp: bool = True,
                       model_apply_aux: Callable | None = None,
                       aux_weight: float = 0.01,
                       optimizer: GradientTransformation | None = None):
    """JAX's convenience: returns ``(step, state, device)``, a
    :class:`ShardedStep`, the state (fresh copies of ``params`` on
    ``device``, the card unless the caller asks for the CPU, so the
    caller's tensors are never touched) and the device. The default
    optimizer is :func:`adamw` at ``learning_rate`` with optax's weight
    decay of 1e-4.

    ``mesh`` (:func:`~lambdipy_tpu_torch.parallel.mesh.job_mesh`): None,
    a ``Mesh`` or ``{axis: size}``, one process per device. With a
    process group up, each rank keeps its blocks of the params by
    :func:`train_shardings` (``rules``: the model's ``tp_rules``;
    ``fsdp``) and steps through :class:`DataParallel`; the batch it is
    given is its own rows (``ShardedLoader.place``). Without a group the
    mesh can only be of one device, and the step is one device's. A model
    that routes tokens (``model_apply_aux`` given, or a ``model_apply``
    whose ``routes_tokens`` is true: an MoE model) is refused on a mesh
    of more than one device (:func:`refuse_routing_over_ranks`)."""
    from lambdipy_tpu_torch.parallel.distributed import (_group,
                                                         process_count)
    from lambdipy_tpu_torch.parallel.mesh import job_mesh

    if model_apply_aux is not None or getattr(model_apply, "routes_tokens",
                                              False):
        refuse_routing_over_ranks(mesh)
    mesh = job_mesh(mesh)
    if mesh is None and process_count() > 1:
        raise ValueError(f"a job of {process_count()} processes trains over "
                         "a mesh: pass one (make_mesh({'dp': -1}))")
    dev = resolve_device(device)
    if optimizer is None:
        optimizer = adamw(learning_rate)
    for k, p in params.items():
        if not p.is_floating_point():
            raise TypeError(f"grad requires real-valued inputs; param {k} "
                            f"is {p.dtype}")
    with torch.no_grad():
        placed = {k: p.detach().to(dev, copy=True) for k, p in params.items()}
    shardings = collectives = None
    if mesh is not None and _group() is not None:
        shardings = train_shardings(placed, mesh, rules, fsdp=fsdp)
        with torch.no_grad():
            placed = {k: shardings[k].shard(p) for k, p in placed.items()}
        collectives = DataParallel(shardings)
    state = init_train_state(placed, optimizer)
    step = make_train_step(model_apply, optimizer,
                           model_apply_aux=model_apply_aux,
                           aux_weight=aux_weight, collectives=collectives)
    return ShardedStep(step, mesh, shardings), state, dev
