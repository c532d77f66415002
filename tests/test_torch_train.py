"""The port's train step and optimizer stack (``lambdipy_tpu_torch/train/
step.py``) against the JAX package's and optax's, on the CPU.

- Each optimizer setting of ``make_optimizer`` (and optax's default
  ``adamw``, weight decay 1e-4) against optax over six calls on seeded f32
  trees: updates and params within ``OPT_TOL`` (f32 rounding of the same
  op sequence; measured at most 1.2e-7).
- ``make_train_step`` on the f32 ``llama-tiny`` and ``llama-moe-tiny``
  (with its balance loss) from JAX's params, five steps on the same
  batches through JAX's jitted step and the port's: every metric per step
  within ``METRIC_TOL`` relative, the final params within ``PARAM_TOL``
  (the two frameworks' f32 forward and backward differ in summation
  order; measured 1e-6 relative and 2.6e-6 absolute).
- What JAX cannot train, the port refuses: int8 weights (``TypeError``,
  as ``jax.grad``'s) and the ``flash`` backend (no backward; JAX's grad
  through the Pallas call fails with ``AssertionError``).
"""

import jax
import numpy as np
import optax
import pytest
import torch

from lambdipy_tpu.models import registry as jreg
from lambdipy_tpu.train.step import init_train_state as jax_init_state
from lambdipy_tpu.train.step import make_optimizer as jax_make_optimizer
from lambdipy_tpu.train.step import make_train_step as jax_make_train_step
from lambdipy_tpu_torch.models import params as tparams
from lambdipy_tpu_torch.models import registry as treg
from lambdipy_tpu_torch.train import step as tstep

OPT_TOL = 1e-6
METRIC_TOL = 1e-5
PARAM_TOL = 2e-5
SHAPES = {"a": (3, 5), "b": (7,), "c": (2, 2, 3)}

# name -> make_optimizer kwargs (None: optax.adamw(lr) / the port's adamw)
SETTINGS = {
    "adamw_default_wd": None,
    "constant": {},
    "warmup": {"warmup_steps": 3},
    "cosine": {"total_steps": 6, "warmup_steps": 2, "schedule": "cosine"},
    "clip": {"grad_clip": 1.0},
    "weight_decay": {"weight_decay": 0.1},
    "accum_3": {"accum_steps": 3, "total_steps": 6, "warmup_steps": 3,
                "schedule": "cosine", "grad_clip": 2.0},
}


def _optimizers(setting):
    kw = SETTINGS[setting]
    if kw is None:
        return optax.adamw(1e-2), tstep.adamw(1e-2)
    return jax_make_optimizer(1e-2, **kw), tstep.make_optimizer(1e-2, **kw)


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_optimizer_matches_optax(setting):
    """Six updates of seeded f32 grads (norms ~5, so the clip acts): each
    call's updates and the params after it agree with optax's, and under
    accumulation only every third call moves the params."""
    rng = np.random.default_rng(0)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: (rng.normal(size=s) * 3).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(6)]
    jopt, topt = _optimizers(setting)
    jp = {k: jax.numpy.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts_ = jopt.init(jp), topt.init(tp)
    for i, g in enumerate(grads):
        ju, js = jopt.update({k: jax.numpy.asarray(v) for k, v in g.items()},
                             js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts_ = topt.update({k: torch.from_numpy(v.copy())
                               for k, v in g.items()}, ts_, tp)
        tp = tstep.apply_updates(tp, tu)
        for k in SHAPES:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]),
                                       rtol=OPT_TOL, atol=OPT_TOL)
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=OPT_TOL, atol=OPT_TOL)
            if setting == "accum_3" and i % 3 != 2:
                assert not tu[k].any()


def test_sharded_train_step_defaults_to_optax_adamw_weight_decay():
    """JAX's ``sharded_train_step`` defaults to ``optax.adamw(lr)``, whose
    weight decay is 1e-4; ``make_optimizer`` defaults to 0.0. Both kept:
    a zero grad moves the port's default step's params by ``lr * 1e-4 *
    p`` (optax's), and ``make_optimizer``'s not at all."""
    p = {"w": torch.full((4,), 2.0)}
    zero = {"w": torch.zeros(4)}
    for opt, want in ((tstep.adamw(0.5), 2.0 - 0.5 * 1e-4 * 2.0),
                      (tstep.make_optimizer(0.5), 2.0)):
        u, _ = opt.update(zero, opt.init(p), p)
        got = tstep.apply_updates(p, u)["w"]
        jopt = (optax.adamw(0.5) if want != 2.0
                else jax_make_optimizer(0.5))
        ju, _ = jopt.update({"w": jax.numpy.zeros(4)},
                            jopt.init({"w": jax.numpy.full((4,), 2.0)}),
                            {"w": jax.numpy.full((4,), 2.0)})
        np.testing.assert_allclose(got.numpy(), np.full(4, want, np.float32),
                                   rtol=1e-7)
        np.testing.assert_allclose(u["w"].numpy(), np.asarray(ju["w"]),
                                   rtol=1e-7)


def _batches(n=5, b=4, s=33, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, (b, s)).astype(np.int32) for _ in range(n)]


@pytest.fixture(scope="module", params=["llama-tiny", "llama-moe-tiny"])
def five_steps(request):
    """One JAX run and one port run of five steps from JAX's params, on
    the same batches, through ``make_optimizer(1e-3, grad_clip=1.0,
    warmup_steps=2)`` (the schedule and the clip act on every step)."""
    name = request.param
    jad, tad = jreg.get(name).build(), treg.get(name).build()
    jparams = jad.init_params(seed=0)
    kw = {"grad_clip": 1.0, "warmup_steps": 2}
    jopt = jax_make_optimizer(1e-3, **kw)
    jstep = jax.jit(jax_make_train_step(jad.forward, jopt,
                                        model_apply_aux=jad.forward_with_aux))
    jstate = jax_init_state(jparams, jopt)
    topt = tstep.make_optimizer(1e-3, **kw)
    tfn = tstep.make_train_step(tad.train_forward, topt,
                                model_apply_aux=tad.train_forward_with_aux)
    sd = tparams.from_jax_params(jax.device_get(jparams))
    tstate = tstep.init_train_state(tparams.train_params(sd), topt)
    rows = []
    for tok in _batches():
        jstate, jm = jstep(jstate, tok)
        tstate, tm = tfn(tstate, torch.from_numpy(tok).long())
        rows.append(({k: float(v) for k, v in jm.items()},
                     {k: float(v) for k, v in tm.items()}))
    return name, rows, jstate, tstate


def test_train_step_metrics_match_jax(five_steps):
    """``loss``, ``ce_loss``, ``aux_loss`` and ``grad_norm`` at each of
    five steps; the MoE model's balance loss is on (``aux_loss`` > 0)."""
    name, rows, _, tstate = five_steps
    for want, got in rows:
        assert set(got) == set(want) == {"loss", "ce_loss", "aux_loss",
                                         "grad_norm"}
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=METRIC_TOL,
                                           abs=METRIC_TOL), k
        assert (got["aux_loss"] > 0) == (name == "llama-moe-tiny")
    assert int(tstate.step) == 5 and tstate.step.dtype == torch.int32


def test_train_step_params_match_jax(five_steps):
    """Every param after five steps, and the optimizer's counts."""
    _, _, jstate, tstate = five_steps
    want = tparams.from_jax_params(jax.device_get(jstate.params))
    assert set(tstate.params) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(tstate.params[k].numpy(), w.numpy(),
                                   rtol=PARAM_TOL, atol=PARAM_TOL,
                                   err_msg=k)
    assert int(tstate.opt_state["1"]["0"]["count"]) \
        == int(jstate.opt_state[1][0].count) == 5


def test_int8_training_is_refused_as_jax_refuses_it():
    """JAX's grad raises ``TypeError`` on int8 weights; the port's train
    forward raises ``TypeError`` before any step, and a params dict with
    an int8 leaf is refused by the step builder."""
    jad = jreg.get("llama-tiny").build(quant="int8")
    jopt = optax.adamw(1e-3)
    with pytest.raises(TypeError, match="real"):
        jax.jit(jax_make_train_step(jad.forward, jopt))(
            jax_init_state(jad.init_params(seed=0), jopt),
            np.zeros((2, 17), np.int32))
    tad = treg.get("llama-tiny").build(quant="int8")
    with pytest.raises(TypeError, match="int8"):
        tad.train_forward
    with pytest.raises(TypeError, match="real"):
        tstep.sharded_train_step(lambda p, t: t, {"w": torch.zeros(
            2, dtype=torch.int8)}, device="cpu")


def test_flash_training_is_refused_as_jax_fails_on_it():
    """JAX's grad through the flash Pallas call fails (no backward,
    ``AssertionError``); the port's train forward raises, naming it."""
    jad = jreg.get("llama-tiny").build(extra={"attn_backend": "flash"})
    jopt = optax.adamw(1e-3)
    with pytest.raises(AssertionError):
        jax_make_train_step(jad.forward, jopt)(
            jax_init_state(jad.init_params(seed=0), jopt),
            np.zeros((2, 17), np.int32))
    tad = treg.get("llama-tiny").build(extra={"attn_backend": "flash"})
    with pytest.raises(NotImplementedError, match="no backward"):
        tad.train_forward
    with pytest.raises(NotImplementedError, match=r"item 3 \(c\)"):
        tstep.sharded_train_step(lambda p, t: t, {"w": torch.zeros(2)},
                                 {"tp": 2}, device="cpu")
    with pytest.raises(ValueError, match="needs 2 processes"):
        tstep.sharded_train_step(lambda p, t: t, {"w": torch.zeros(2)},
                                 {"dp": 2}, device="cpu")


def test_moe_training_over_ranks_is_refused():
    """JAX routes an MoE layer over the global batch; a rank of the port
    holds its own rows, so its routing groups and capacities would differ
    (at 4 x 16 tokens over two ranks, a group of 32 where JAX's is 64).
    An MoE model on a mesh of more than one device raises, naming item 3
    (d): through its aux forward, through its plain forward, on a dict or
    a ``Mesh``; one device still trains."""
    from lambdipy_tpu_torch.parallel.mesh import Mesh

    tad = treg.get("llama-moe-tiny").build()
    moe = tad.make_model(tad.init_params(seed=0, device="cpu"),
                         device="cpu").layer_0.moe
    assert moe.capacity(64)[0] == 64 and moe.capacity(32)[0] == 32
    params = tparams.train_params(tad.init_params(seed=0, device="cpu"))
    calls = [dict(model_apply_aux=tad.train_forward_with_aux), {}]
    for mesh in ({"dp": 2}, {"dp": 2, "tp": 1},
                 Mesh(np.arange(2), ("dp",))):
        for kw in calls:
            with pytest.raises(NotImplementedError,
                               match=r"route.*item 3 \(d\)"):
                tstep.sharded_train_step(tad.train_forward, params, mesh,
                                         device="cpu", **kw)
    assert tad.train_forward.routes_tokens
    assert not treg.get("llama-tiny").build().train_forward.routes_tokens
    for mesh in (None, {"dp": 1}, {"dp": -1}):
        step, _, _ = tstep.sharded_train_step(
            tad.train_forward, params, mesh, device="cpu",
            model_apply_aux=tad.train_forward_with_aux)
        assert step.shardings is None


def test_train_forward_is_the_serving_forward_and_leaves_serving_frozen():
    """``train_forward`` over ``train_params`` of a model's weights gives
    the serving model's logits bitwise; the serving model keeps its
    weights as buffers, none requiring grad; int8 scales are not
    trainable."""
    tad = treg.get("llama-tiny").build()
    model = tad.make_model(tad.init_params(seed=2, device="cpu"),
                           device="cpu")
    weights = tparams.train_params(model)
    assert all(w.requires_grad and w.is_leaf for w in weights.values())
    tok = torch.from_numpy(_batches(1)[0]).long()
    with torch.no_grad():
        want = model(tok)[0]
    torch.testing.assert_close(tad.train_forward(weights, tok).detach(), want,
                               rtol=0, atol=0)
    assert not any(b.requires_grad for b in model.buffers())
    assert not list(model.parameters())
    q = treg.get("llama-tiny").build(quant="int8", dtype="bfloat16")
    keys = set(tparams.train_params(q.init_params(seed=0, device="cpu")))
    assert not any(k.endswith(("kernel_int8", "q_proj.scale")) for k in keys)
    assert "layer_0.attn_norm.scale" in keys
