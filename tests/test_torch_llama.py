"""The port's Llama model (``lambdipy_tpu_torch/models``) against the JAX
package's on the same weights: the param bridge, prefill logits and
decode steps on ``llama-tiny`` (f32, blocked decode attention) and on a
tiling int8 config where JAX runs the Pallas int8 kernel in interpret
mode; plus the config, registry and sampling-filter pieces."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lambdipy_tpu.models import llama as jl
from lambdipy_tpu.models import registry as jreg
from lambdipy_tpu_torch.models import llama as tl
from lambdipy_tpu_torch.models import registry as treg
from lambdipy_tpu_torch.models.params import from_jax_params

# f32 end to end; the two frameworks sum matmuls and softmaxes in other
# orders, which moves logits by ~1e-6 relative through two layers
LOGIT_TOL = 1e-4
# the int8 kernel rounds its f32 activations to bf16: a ~1e-7 difference
# between the frameworks flips an activation that sits on a rounding
# boundary by one bf16 ulp (2^-8 relative), which moves logits by ~1e-3
# of their peak (measured 2.9e-3 absolute on this config)
INT8_REL_TOL = 1e-2
TILING_INT8 = {"vocab_size": 512, "hidden": 256, "heads": 4, "kv_heads": 2,
               "mlp": 512, "layers": 2, "attn_backend": "blocked",
               "matmul_backend": "pallas"}
# the plain reference backends, which the JAX package also defaults to
PLAIN = {"attn_backend": "dense", "matmul_backend": "xla"}


def _pair(quant=None, extra=None, seed=0):
    extra = {"attn_backend": "blocked", **(extra or {})}
    jad = jreg.get("llama-tiny").build(dtype="float32", quant=quant,
                                       extra=extra)
    params = jad.init_params(seed=seed)
    tad = treg.get("llama-tiny").build(dtype="float32", quant=quant,
                                       extra=extra)
    sd = from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    return jad, params, tad.make_model(sd, device="cpu")


def _prefill_and_decode(jad, params, model, tol, steps=4, seed=0):
    """Prefill a right-padded ragged batch, then ``steps`` per-row decode
    steps, in both frameworks; asserts logits and the written caches agree
    within ``tol(reference)``."""
    cfg = jad.config
    b, s, cache_len = 2, 8, 16
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    length = np.asarray([s, 5], np.int32)

    jlog, jpc = jad.module.apply(params, jnp.asarray(prompt))
    jcache = jl.prefill_into_cache(cfg, jpc, b, cache_len, 0)
    with torch.inference_mode():
        tlog, tpc = model(torch.as_tensor(prompt).long())
        tcache = tl.prefill_into_cache(model.cfg, tpc, b, cache_len, 0)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                               atol=tol(jlog))
    pos = length.copy()
    for entry in jcache:
        entry["index"] = jnp.asarray(pos)
    for entry in tcache:
        entry["index"] = torch.as_tensor(pos)
    for _ in range(steps):
        tok = rng.integers(0, cfg.vocab_size, (b,)).astype(np.int32)
        jlog, jcache = jad.module.apply(
            params, jnp.asarray(tok)[:, None],
            positions=jnp.asarray(pos)[:, None], cache=jcache)
        with torch.inference_mode():
            tlog, _ = model(torch.as_tensor(tok).long()[:, None],
                            positions=torch.as_tensor(pos)[:, None],
                            cache=tcache)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                                   atol=tol(jlog))
        pos = pos + 1
        for entry in jcache:
            entry["index"] = jnp.asarray(pos)
        for entry in tcache:
            entry["index"] = torch.as_tensor(pos)
    # the caches the two decode loops wrote agree too
    for je, te in zip(jcache, tcache):
        for name in ("k", "v"):
            np.testing.assert_allclose(te[name].numpy(), np.asarray(je[name]),
                                       rtol=0, atol=tol(je[name]))


def test_param_bridge_keeps_bf16_bits():
    import ml_dtypes

    w = np.random.default_rng(0).normal(size=(3, 4)).astype(ml_dtypes.bfloat16)
    sd = from_jax_params({"params": {"lm_head": {"kernel": w}}})
    got = sd["lm_head.kernel"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), w.astype(np.float32))


def test_param_bridge_names_every_weight():
    jad, params, model = _pair()
    flat = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    names = {".".join(p.key for p in path) for path, _ in flat}
    assert names == set(model.state_dict())
    assert model.state_dict()["layer_0.q_proj.kernel"].shape == (64, 64)


@pytest.mark.parametrize("quant,extra", [
    (None, None),
    ("int8", TILING_INT8),
    (None, PLAIN),
    ("int8", PLAIN),
], ids=["tiny-f32-blocked", "tiling-int8-pallas", "tiny-f32-dense",
        "tiny-int8-xla-dense"])
def test_prefill_and_decode_logits_match_jax(quant, extra):
    jad, params, model = _pair(quant, extra)
    assert model.cfg.attn_backend == (extra or {}).get("attn_backend",
                                                       "blocked")
    if quant == "int8" and model.cfg.matmul_backend == "pallas":
        assert jad.config.hidden % 128 == 0  # JAX really runs the kernel
        tol = lambda ref: INT8_REL_TOL * float(np.abs(ref).max())  # noqa: E731
    else:
        tol = lambda ref: LOGIT_TOL  # noqa: E731
    _prefill_and_decode(jad, params, model, tol)


def test_logit_positions_select_one_row_each():
    jad, params, model = _pair()
    prompt = np.arange(1, 17, dtype=np.int32).reshape(2, 8)
    lp = np.asarray([7, 3], np.int32)
    jlog, _ = jad.module.apply(params, jnp.asarray(prompt),
                               logit_positions=jnp.asarray(lp))
    with torch.inference_mode():
        tlog, _ = model(torch.as_tensor(prompt).long(),
                        logit_positions=torch.as_tensor(lp))
    assert tlog.shape == (2, 1, 512)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               atol=LOGIT_TOL)


@pytest.mark.parametrize("scaling", [None, ("linear", 4.0),
                                     ("llama3", 8.0, 1.0, 4.0, 64)])
def test_rope_matches_jax(scaling):
    rng = np.random.default_rng(1)
    q = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 5, 2, 16)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 5)).astype(np.int32)
    jq, jk = jl.rope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos),
                     500000.0, scaling)
    tq, tk = tl.rope(torch.as_tensor(q), torch.as_tensor(k),
                     torch.as_tensor(pos), 500000.0, scaling)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-4)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-4)


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (5, 1.0), (0, 0.3),
                                         ([3, 0, 40], [0.5, 0.9, 1.0])])
def test_filter_logits_runtime_matches_jax(top_k, top_p):
    logits = np.random.default_rng(2).normal(size=(3, 64)).astype(np.float32)
    want = jl.filter_logits_runtime(jnp.asarray(logits),
                                    jnp.asarray(top_k), jnp.asarray(top_p))
    got = tl.filter_logits_runtime(torch.as_tensor(logits),
                                   torch.as_tensor(top_k),
                                   torch.as_tensor(top_p))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_token_logprob_matches_jax():
    lg = np.random.default_rng(3).normal(size=(3, 50)).astype(np.float32)
    tok = np.asarray([0, 7, 49], np.int32)
    want = jl._token_logprob(jnp.asarray(lg), jnp.asarray(tok))
    got = tl._token_logprob(torch.as_tensor(lg), torch.as_tensor(tok).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_out_of_bounds_decode_write_is_dropped():
    """A row whose index is past the cache leaves the cache untouched, as
    the JAX scatter drops it."""
    _, _, model = _pair()
    cache = tl.init_decode_cache(model.cfg, 2, 8, "cpu")
    for entry in cache:
        entry["index"] = torch.as_tensor([3, 8], dtype=torch.int32)
    with torch.inference_mode():
        model(torch.as_tensor([[5], [6]]), positions=torch.as_tensor([[3], [8]]),
              cache=cache)
    assert cache[0]["k"][0, 3].abs().sum() > 0
    assert cache[0]["k"][1].abs().sum() == 0


def test_model_without_device_raises_when_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.LlamaModel(tl.LLAMA_TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        treg.get("llama-tiny").build().make_model()


def test_configs_mirror_jax():
    """Every field but dtype and the backends mirrors the JAX config; the
    port defaults to its kernels, the JAX package to its plain paths."""
    backends = {"attn_backend": "blocked", "matmul_backend": "pallas"}
    for jcfg, tcfg in ((jl.LLAMA3_8B, tl.LLAMA3_8B),
                       (jl.LLAMA_TINY, tl.LLAMA_TINY)):
        for f in dataclasses.fields(tcfg):
            if f.name in backends:
                assert getattr(tcfg, f.name) == backends[f.name], f.name
            elif f.name != "dtype":
                assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    cfg = treg.get("llama3-8b").build(extra={"max_len": "4096"}).config
    assert (cfg.quant, cfg.dtype, cfg.max_len) == ("int8", torch.bfloat16, 4096)
    assert (cfg.attn_backend, cfg.matmul_backend) == ("blocked", "pallas")
    plain = treg.get("llama3-8b").build(extra=PLAIN).config
    assert (plain.attn_backend, plain.matmul_backend) == ("dense", "xla")


@pytest.mark.parametrize("extra,match", [
    ({"attn_backend": "flash"}, "not ported yet"),
    ({"attn_backend": "ring"}, "not ported yet"),
    ({"attn_backend": "bogus"}, "unknown attn_backend"),
    ({"matmul_backend": "bogus"}, "unknown matmul_backend"),
    ({"kv_quant": "int8"}, "not ported yet"),
])
def test_registry_rejects_unported_or_unknown_backends(extra, match):
    with pytest.raises(ValueError, match=match):
        treg.get("llama3-8b").build(extra=extra)


def test_init_params_is_seeded_and_sized():
    adapter = treg.get("llama-tiny").build(quant="int8")
    a = adapter.init_params(seed=5, device="cpu")
    b = adapter.init_params(seed=5, device="cpu")
    c = adapter.init_params(seed=6, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["layer_0.q_proj.kernel_int8"],
                           c["layer_0.q_proj.kernel_int8"])
    w = a["layer_1.down_proj.kernel_int8"]
    assert w.dtype == torch.int8 and w.shape == (128, 64)
    assert int(w.abs().max()) == 127
    assert torch.allclose(a["layer_1.down_proj.scale"],
                          torch.full((1, 64), 1 / (127 * 128 ** 0.5)))
    assert torch.equal(a["final_norm.scale"], torch.ones(64))
