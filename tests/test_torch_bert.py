"""The port's BERT (``lambdipy_tpu_torch/models/bert.py``) against the flax
BERT on the CPU: ``bert-tiny`` on the same token ids, a ragged padding
mask and the same weights (``from_jax_params``), f32 and bf16; and the
port's copy of the torch BERT against the JAX package's on one
``state_dict``.

The weights take seeded LayerNorm scales and biases and dense biases
(flax inits them to 1 and 0), so every one reaches the logits.

Bounds, on ``max |port - flax| / max |flax|``:

- f32: 1e-4 (measured up to 7.2e-7 over seeds 0-5: summation order,
  LayerNorm's variance);
- bf16: 5e-2 with the labels equal. Both round each product, the
  probabilities and each LayerNorm's output to bf16 at the same points,
  but XLA's and PyTorch's bf16 matmuls, softmax and GELU differ in
  summation order and intermediate precision, and a one-ulp flip (2^-8)
  before a LayerNorm moves the next layer's input. Measured 3.7e-3 to
  1.6e-2 over seeds 0-5.
"""

import jax
import numpy as np
import pytest
import torch

from lambdipy_tpu.models import registry as jreg
from lambdipy_tpu_torch.models import registry
from lambdipy_tpu_torch.models.params import from_jax_params, init_params

TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def seeded_variables(dtype: str, seed: int = 0):
    adapter = jreg.get("bert-tiny").build(dtype=dtype)
    tree = jax.tree_util.tree_map(np.asarray, jax.device_get(
        adapter.init_params(seed=seed)))
    rng = np.random.default_rng(seed + 100)

    def draw(node):
        for name, val in node.items():
            if isinstance(val, dict):
                draw(val)
            elif name in ("scale", "bias"):
                base = 1.0 if name == "scale" else 0.0
                node[name] = (base + rng.normal(0.0, 0.2, val.shape)).astype(
                    val.dtype)

    draw(tree["params"])
    return adapter, tree


def batch(cfg, seed: int = 0):
    """Three rows: full, 20 tokens, 5 tokens."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, (3, cfg.max_len)).astype(np.int32)
    mask = np.ones((3, cfg.max_len), np.int32)
    mask[1, 20:] = 0
    mask[2, 5:] = 0
    return ids, mask


def logits_both(dtype: str, seed: int = 0):
    adapter, tree = seeded_variables(dtype, seed)
    ids, mask = batch(adapter.config, seed)
    want = np.asarray(jax.jit(adapter.forward)(tree, ids, mask), np.float32)
    model = registry.get("bert-tiny").build(dtype=dtype).make_model(
        from_jax_params(tree), device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(),
                    torch.from_numpy(mask).long()).numpy()
    return want, got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bert_matches_flax_with_a_ragged_mask(dtype):
    want, got = logits_both(dtype)
    assert got.shape == want.shape == (3, 2)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= TOL[dtype], err
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_bert_tiny_forward_mask_matters():
    """Twin of ``tests/test_models.py::test_bert_tiny_forward_mask_matters``
    on the port: masking the second half changes the logits."""
    adapter = registry.get("bert-tiny").build()
    model = adapter.make_model(init_params(adapter.config, 0, "cpu"),
                               device="cpu")
    cfg = adapter.config
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, cfg.max_len)))
    full = torch.ones(2, cfg.max_len, dtype=torch.long)
    half = full.clone()
    half[:, cfg.max_len // 2:] = 0
    with torch.no_grad():
        out_full, out_half = model(ids, full), model(ids, half)
    assert out_full.shape == (2, cfg.num_classes)
    assert not torch.allclose(out_full, out_half)


def test_bert_init_matches_flax_shapes():
    _, tree = seeded_variables("bfloat16")
    adapter = registry.get("bert-tiny").build(dtype="bfloat16")
    ours = init_params(adapter.config, 0, "cpu")
    theirs = adapter.make_model(from_jax_params(tree),
                                device="cpu").state_dict()
    assert {k: (tuple(v.shape), v.dtype) for k, v in ours.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in theirs.items()}
    # the classifier computes in f32, the rest in the model dtype
    assert ours["classifier.kernel"].dtype == torch.float32
    assert ours["pooler.kernel"].dtype == torch.bfloat16


def test_torch_bert_is_the_jax_packages():
    """The port's copy of the torch BERT gives the JAX package's logits,
    bitwise, on one ``state_dict`` (the same stock ``torch.nn`` blocks)."""
    from lambdipy_tpu.models.torch_bert import TorchBertClassifier

    dims = {"vocab_size": 128, "hidden": 32, "layers": 2, "heads": 2,
            "max_len": 16, "num_classes": 3}
    torch.manual_seed(0)
    theirs = TorchBertClassifier(**dims).eval()
    adapter = registry.get("bert-base-torch").build(
        extra={k: str(v) for k, v in dims.items()})
    ours = adapter.make_model(theirs.state_dict(), device="cpu")
    ids = torch.randint(0, 128, (2, 16), generator=torch.Generator()
                        .manual_seed(1))
    mask = torch.ones(2, 16, dtype=torch.long)
    mask[1, 7:] = 0
    with torch.no_grad():
        assert torch.equal(ours(ids, mask), theirs(ids, mask))
