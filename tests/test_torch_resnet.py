"""The port's ResNet (``lambdipy_tpu_torch/models/resnet.py``) against the
flax ResNet on the CPU: ``resnet50-tiny`` on the same numpy images and the
same weights, carried across by ``from_jax_params``.

The flax init sets every block's ``bn3`` scale to 0, which zeroes each
residual branch; the weights here take seeded nonzero ``bn3`` scales, and
seeded batch-norm statistics, scales and biases everywhere, so every
convolution and every batch norm reaches the logits.

Bounds, on ``max |port - flax| / max |flax|``:

- f32: 1e-4 (measured up to 1.0e-6 over seeds 0-5: summation order);
- bf16: 1e-2 with the top-1 class equal. Both round every convolution's
  output and every batch norm's result to bf16, but XLA's and oneDNN's
  bf16 convolutions sum in other orders, and a one-ulp difference
  (2^-8 of a value) in a block's output carries through the later
  blocks. Measured 1.3e-4 to 2.5e-3 over seeds 0-5 at 32 and 224
  pixels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lambdipy_tpu.models import registry as jreg
from lambdipy_tpu_torch.models import registry
from lambdipy_tpu_torch.models.params import (from_jax_params, init_params,
                                              to_flax_tree)

TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def seeded_variables(dtype: str, seed: int = 0):
    """The flax init of ``resnet50-tiny`` (numpy leaves) with seeded batch
    norms: ``bn3`` scales nonzero, every scale, bias, mean and var
    drawn."""
    adapter = jreg.get("resnet50-tiny").build(dtype=dtype)
    tree = jax.tree_util.tree_map(np.asarray, jax.device_get(
        adapter.init_params(seed=seed)))
    rng = np.random.default_rng(seed + 100)

    def draw(node, stats):
        for name, val in node.items():
            if isinstance(val, dict):
                draw(val, stats)
            elif stats and name == "var":
                node[name] = rng.uniform(0.5, 1.5, val.shape).astype(val.dtype)
            elif stats or name in ("scale", "bias"):
                node[name] = rng.normal(0.0, 0.5, val.shape).astype(val.dtype)

    draw(tree["params"], False)
    draw(tree["batch_stats"], True)
    assert all(np.abs(v["bn3"]["scale"]).min() > 0
               for k, v in tree["params"].items() if k.startswith("stage"))
    return adapter, tree


def logits_both(dtype: str, size: int, seed: int = 0, batch: int = 2):
    adapter, tree = seeded_variables(dtype, seed)
    x = np.random.default_rng(seed).normal(
        size=(batch, size, size, 3)).astype(np.float32)
    want = np.asarray(jax.jit(adapter.forward)(
        tree, jnp.asarray(x, adapter.example_batch(1)[0].dtype)),
        np.float32)
    model = registry.get("resnet50-tiny").build(dtype=dtype).make_model(
        from_jax_params(tree), device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(x)).float().numpy()
    return want, got


@pytest.mark.parametrize("dtype,size", [("float32", 32), ("bfloat16", 32),
                                        ("float32", 224),
                                        ("bfloat16", 224)])
def test_resnet_matches_flax(dtype, size):
    """224 pixels: the stride-2 convolutions and the pooling see even and
    odd sizes (112, 56, 28), so every padding rule is covered."""
    want, got = logits_both(dtype, size)
    assert got.shape == want.shape == (2, 10)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= TOL[dtype], err
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_bn3_reaches_the_logits():
    """With ``bn3`` zeroed (the flax init) the residual branches vanish:
    the seeded weights must give other logits, or the parity above would
    leave the branches untested."""
    adapter, tree = seeded_variables("float32")
    x = np.random.default_rng(0).normal(size=(1, 32, 32, 3))
    zeroed = jax.tree_util.tree_map(lambda a: a, tree)
    for k, v in zeroed["params"].items():
        if k.startswith("stage"):
            v["bn3"]["scale"] = np.zeros_like(v["bn3"]["scale"])
    model = registry.get("resnet50-tiny").build().make_model(device="cpu")
    outs = []
    for t in (tree, zeroed):
        model.load_state_dict(from_jax_params(t))
        with torch.no_grad():
            outs.append(model(torch.from_numpy(x)).numpy())
    assert np.abs(outs[0] - outs[1]).max() > 1e-3


def test_layouts_round_trip_and_init_matches_flax_shapes():
    """``to_flax_tree`` inverts ``from_jax_params`` (both collections, the
    convolution kernels back to ``[kh, kw, in, out]``), and the port's
    seeded init has flax's keys, shapes and dtypes, ``bn3`` scales 0."""
    _, tree = seeded_variables("bfloat16")
    cfg = registry.get("resnet50-tiny").build(dtype="bfloat16").config
    back = to_flax_tree(cfg, from_jax_params(tree))
    flat = jax.tree_util.tree_leaves_with_path(tree)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(flat_back)
    for path, leaf in flat:
        np.testing.assert_array_equal(flat_back[path].float().numpy(),
                                      np.asarray(leaf, np.float32))
    ours = init_params(cfg, 0, "cpu")
    theirs = registry.get("resnet50-tiny").build(dtype="bfloat16") \
        .make_model(from_jax_params(tree), device="cpu").state_dict()
    assert {k: (tuple(v.shape), v.dtype) for k, v in ours.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in theirs.items()}
    assert not ours["stage1_block1.bn3.scale"].any()
    assert ours["stage1_block1.bn1.scale"].eq(1).all()
