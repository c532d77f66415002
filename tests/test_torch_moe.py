"""The port's sparse MoE FFN (``lambdipy_tpu_torch/models/moe.py``) and
``llama-moe-tiny`` against the JAX package's on the same numpy inputs and
weights, on the CPU: ``route_topk`` (ample capacity, overflow, padding, a
tie), ``MoEMLP`` (float and int8 experts, one and several routing
groups), the balance loss, ``quantize_params`` bitwise, the registry's
MoE fields, a ``llama-moe-tiny`` forward, greedy tokens through
``generate`` and through an engine at one live row, a JAX-built bundle,
and the port's identities that hold under MoE.

Tolerances: routing is exact (the same probabilities seat the same
tokens, bitwise); outputs and losses are f32 sums in another order, so
1e-5 relative for one MLP and the llama tests' 1e-4 of logits through
two layers. The expert-parallel tests of ``tests/test_moe.py`` wait for
the port's parallelism."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from lambdipy_tpu.models import llama as jl
from lambdipy_tpu.models import moe as jmoe
from lambdipy_tpu.models import registry as jreg
from lambdipy_tpu.runtime.continuous import ContinuousBatcher as JaxBatcher
from lambdipy_tpu_torch.models import llama as tl
from lambdipy_tpu_torch.models import moe as tmoe
from lambdipy_tpu_torch.models import registry as treg
from lambdipy_tpu_torch.models.params import from_jax_params
from lambdipy_tpu_torch.runtime.handlers import make_engine

OUT_TOL = 1e-5    # one MoE MLP, f32, relative to the output's peak
LOGIT_TOL = 1e-4  # two layers, as tests/test_torch_llama.py
EXTRA = {"attn_backend": "blocked"}


def _np(x):
    return np.asarray(x)


def _probs(shape, seed):
    logits = np.random.default_rng(seed).normal(size=shape)
    return np.asarray(jax.nn.softmax(jnp.asarray(logits, jnp.float32), -1))


def _routing_cases():
    ample = _probs((32, 4), 0)
    crowded = np.stack([np.full(8, 5.0), np.zeros(8)], 1)
    crowded = np.asarray(jax.nn.softmax(jnp.asarray(crowded, jnp.float32)))
    tie = np.full((6, 4), 0.25, np.float32)  # every expert equal
    tie[3] = [0.1, 0.4, 0.4, 0.1]
    valid = np.ones(16, bool)
    valid[11:] = False
    return {"ample": (ample, 2, 32, None),
            "overflow": (_probs((24, 4), 1), 2, 3, None),
            "crowded": (crowded, 1, 1, None),
            "padding": (_probs((16, 4), 2), 2, 5, valid),
            "tie": (tie, 2, 2, None)}


ROUTING = _routing_cases()


@pytest.mark.parametrize("case", ROUTING)
def test_route_topk_matches_jax(case):
    """The same probabilities seat the same tokens in the same slots
    (bitwise), the gates agree within f32 rounding, and so does the
    loss; a tie takes the lower expert, as ``jax.lax.top_k``."""
    probs, k, cap, valid = ROUTING[case]
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else torch.as_tensor(valid)
    jd, jc, ja = jmoe.route_topk(jnp.asarray(probs), k, cap, valid=jv)
    td, tc, ta = tmoe.route_topk(torch.tensor(probs), k, cap, valid=tv)
    np.testing.assert_array_equal(td.numpy(), _np(jd))
    np.testing.assert_allclose(tc.numpy(), _np(jc), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ta.numpy(), _np(ja), rtol=1e-6)
    # seated + dropped = top_k x valid tokens; each (expert, seat) holds
    # at most one token
    n_valid = len(probs) if valid is None else int(valid.sum())
    seated = int(td.sum())
    assert seated <= k * n_valid and td.sum(0).max() <= 1
    if case == "ample":
        assert seated == k * n_valid
        np.testing.assert_allclose(tc.sum((1, 2)).numpy(), 1.0, rtol=1e-5)
    if case == "crowded":  # everyone prefers expert 0; one seat there
        assert seated == 1 and float(td[:, 0].sum()) == 1.0
    if valid is not None:
        assert float(td[~tv].sum()) == 0.0


def test_route_topk_routes_groups_at_once():
    """``[g, t, e]`` routes each group alone: JAX's ``vmap``."""
    probs = _probs((3, 10, 4), 3)
    jd, jc, ja = jax.vmap(lambda p: jmoe.route_topk(p, 2, 4))(
        jnp.asarray(probs))
    td, tc, ta = tmoe.route_topk(torch.as_tensor(probs), 2, 4)
    np.testing.assert_array_equal(td.numpy(), _np(jd))
    np.testing.assert_allclose(tc.numpy(), _np(jc), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ta.numpy(), _np(ja), rtol=1e-6)


def _mlp_pair(e, m, h, quant=None, group_size=256, top_k=2, cf=1.25,
              seed=0, x_shape=(2, 8)):
    x = np.random.default_rng(seed).normal(size=(*x_shape, h)).astype(
        np.float32)
    jmod = jmoe.MoEMLP(num_experts=e, mlp=m, top_k=top_k,
                       capacity_factor=cf, dtype=jnp.float32, quant=quant,
                       group_size=group_size)
    params = jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    tmod = tmoe.MoEMLP(h, e, m, top_k, cf, torch.float32, quant, group_size,
                       device="cpu")
    tmod.load_state_dict(from_jax_params(jax.device_get(params)))
    return x, jmod, params, tmod


@pytest.mark.parametrize("quant,group_size,x_shape", [
    (None, 256, (2, 8)),     # one group, t < group_size
    ("int8", 256, (2, 8)),   # int8 experts, dequantized in the dtype
    (None, 6, (2, 8)),       # 16 tokens in 3 groups of 6, 2 padding
    (None, 4, (1, 12)),      # 3 full groups
])
def test_moe_mlp_matches_jax(quant, group_size, x_shape):
    x, jmod, params, tmod = _mlp_pair(4, 32, 16, quant, group_size,
                                      x_shape=x_shape)
    jout, state = jmod.apply(params, jnp.asarray(x),
                             mutable=["intermediates"])
    jaux = jmoe.moe_aux_loss(state["intermediates"])
    with torch.inference_mode():
        tout, taux = tmod(torch.as_tensor(x), with_aux=True)
        plain = tmod(torch.as_tensor(x))
    peak = float(np.abs(_np(jout)).max())
    np.testing.assert_allclose(tout.numpy(), _np(jout), rtol=0,
                               atol=OUT_TOL * peak)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    assert torch.equal(plain, tout)  # the loss costs the output nothing


def test_moe_single_expert_equals_dense_swiglu():
    """One expert, top 1, ample capacity: a plain SwiGLU MLP (the twin of
    the JAX test of the same name)."""
    b, s, h, m = 2, 8, 16, 32
    x, _, params, tmod = _mlp_pair(1, m, h, top_k=1, cf=float(b * s))
    p = params["params"]
    ref = x.reshape(b * s, h)
    ref = ((fnn.silu(ref @ p["experts_gate"][0]) * (ref @ p["experts_up"][0]))
           @ p["experts_down"][0]).reshape(b, s, h)
    with torch.inference_mode():
        out = tmod(torch.as_tensor(x))
    np.testing.assert_allclose(out.numpy(), _np(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("t", [1, 7, 256, 300, 1000])
def test_capacity_arithmetic_is_jaxs(t):
    """Group size, group count and capacity in Python's arithmetic, as
    JAX's ``moe.py:121-126`` (capacity 1 at least: one decode token)."""
    mod = tmoe.MoEMLP(8, 8, 8, device="meta")
    gs = min(t, 256)
    assert mod.capacity(t) == (gs, -(-t // gs),
                               max(1, int(1.25 * 2 * gs / 8)))


def _moe_tiny(quant=None, extra=None, seed=0):
    extra = {**EXTRA, **(extra or {})}
    jad = jreg.get("llama-moe-tiny").build(dtype="float32", quant=quant,
                                           extra=extra)
    params = jad.init_params(seed=seed)
    tad = treg.get("llama-moe-tiny").build(dtype="float32", quant=quant,
                                           extra=extra)
    sd = from_jax_params(jax.device_get(params))
    return jad, params, tad, tad.make_model(sd, device="cpu")


@pytest.mark.parametrize("quant,extra", [
    (None, {}),
    ("int8", {"matmul_backend": "xla"}),
    ("int8", {"matmul_backend": "pallas"}),
    (None, {"kv_quant": "int8"}),
])
def test_llama_moe_prefill_and_decode_match_jax(quant, extra):
    """``llama-moe-tiny`` prefill logits and per-row decode steps against
    JAX's on the same weights (``tests/test_torch_llama.py``'s walk)."""
    from test_torch_llama import INT8_REL_TOL, _prefill_and_decode

    jad, params, _, model = _moe_tiny(quant, extra)
    rel = INT8_REL_TOL if extra.get("matmul_backend") == "pallas" \
        else LOGIT_TOL
    _prefill_and_decode(jad, params, model,
                        lambda ref: rel * float(np.abs(_np(ref)).max()))


def test_moe_aux_loss_matches_jax():
    """The adapters' ``forward_with_aux``: logits and the summed balance
    loss of both layers; a dense model has none (None in both)."""
    jad, params, tad, model = _moe_tiny()
    toks = np.random.default_rng(4).integers(0, 512, (2, 9)).astype(np.int32)
    jlog, jaux = jad.forward_with_aux(params, jnp.asarray(toks))
    with torch.inference_mode():
        tlog, taux = tad.forward_with_aux(model, torch.as_tensor(toks).long())
    np.testing.assert_allclose(tlog.numpy(), _np(jlog), rtol=0,
                               atol=LOGIT_TOL * float(np.abs(_np(jlog)).max()))
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    assert float(taux) > 0
    assert jreg.get("llama-tiny").build().forward_with_aux is None
    assert treg.get("llama-tiny").build().forward_with_aux is None
    assert float(tmoe.moe_aux_loss([])) == 0.0


def _tree(params):
    """A variables tree as numpy, for both quantizers."""
    return jax.tree_util.tree_map(np.asarray, jax.device_get(params))


@pytest.mark.parametrize("model,dtype", [("llama-tiny", "float32"),
                                         ("llama-moe-tiny", "float32"),
                                         ("llama-tiny", "bfloat16")])
def test_quantize_params_is_bitwise_jaxs(model, dtype):
    """Every int8 leaf and scale equal to JAX's ``quantize_params`` on the
    same numpy tree; embeddings, norms and the router untouched; the
    result serves as the int8 model (``from_jax_params`` fits it)."""
    params = _tree(jreg.get(model).build(dtype=dtype).init_params(seed=1))
    want = from_jax_params(jax.device_get(jl.quantize_params(params)))
    got = from_jax_params(tl.quantize_params(params))
    assert set(got) == set(want)
    for key, t in want.items():
        assert got[key].dtype == t.dtype, key
        assert torch.equal(got[key], t), key
    int8_keys = {k for k, t in got.items() if t.dtype == torch.int8}
    assert int8_keys and all(k.endswith("_int8") for k in int8_keys)
    assert not any(k.endswith(".kernel") for k in got)
    if model == "llama-moe-tiny":
        assert got["layer_0.moe.experts_down_scale"].shape == (4, 1, 64)
        assert got["layer_0.moe.router"].dtype == torch.float32
    adapter = treg.get(model).build(dtype=dtype, quant="int8")
    adapter.make_model(got, device="cpu")


def test_moe_extra_builds_an_moe_model_in_both_packages():
    """``llama-tiny`` with ``moe_experts = 4`` (a recipe's string too)
    builds an MoE model in both packages, with the same parameter paths,
    the same shapes and the same config fields."""
    for extra in ({"moe_experts": 4}, {"moe_experts": "4",
                                       "moe_top_k": "1"}):
        jad = jreg.get("llama-tiny").build(extra=extra)
        tad = treg.get("llama-tiny").build(extra=extra)
        jparams = jax.eval_shape(lambda: jad.init_params(seed=0))
        jshapes = {k: tuple(v.shape) for k, v in from_jax_params(
            jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   jparams)).items()}
        tshapes = {k: tuple(v.shape) for k, v in
                   tl.LlamaModel(tad.config, device="meta").state_dict()
                   .items()}
        assert tshapes == jshapes
        assert "layer_0.moe.experts_gate" in tshapes
        assert "layer_0.gate_proj.kernel" not in tshapes
        for f in ("moe_experts", "moe_top_k", "moe_capacity_factor",
                  "moe_group_size"):
            assert getattr(tad.config, f) == getattr(jad.config, f), f


def test_no_jax_llama_field_is_dropped():
    """The port's list of the JAX config's fields is JAX's; every one is a
    port field (so none is dropped without a word); a JAX field the port
    lacked would raise by name; a name of no field is ignored, as JAX
    ignores it."""
    jax_fields = tuple(f.name for f in dataclasses.fields(jl.LlamaConfig))
    assert treg.JAX_LLAMA_FIELDS == jax_fields
    port_fields = {f.name for f in dataclasses.fields(tl.LlamaConfig)}
    assert set(jax_fields) <= port_fields
    cfg = treg.get("llama-tiny").build(extra={"not_a_field": 3}).config
    assert cfg == treg.get("llama-tiny").build().config
    assert jreg.get("llama-tiny").build(
        extra={"not_a_field": 3}).config.moe_experts == 0
    # a JAX field the port's config lacks raises by name (ring, the one
    # value still unported, raises by its value)
    missing = treg.JAX_LLAMA_FIELDS + ("sliding_window",)
    try:
        treg.JAX_LLAMA_FIELDS = missing
        with pytest.raises(ValueError, match="sliding_window"):
            treg.get("llama-tiny").build(extra={"sliding_window": 4})
    finally:
        treg.JAX_LLAMA_FIELDS = jax_fields
    with pytest.raises(ValueError, match="not ported yet"):
        treg.get("llama-moe-tiny").build(extra={"attn_backend": "ring"})


def test_llama_moe_tiny_registry_and_init():
    """``llama-moe-tiny``: 4 experts unless the extra sets it, f32; the
    seeded init draws the router and the expert stacks (int8 ones with
    the JAX init's constant scale ``1 / (127 sqrt(in))``)."""
    cfg = treg.get("llama-moe-tiny").build().config
    assert (cfg.moe_experts, cfg.dtype, cfg.hidden) == (4, torch.float32, 64)
    assert treg.get("llama-moe-tiny").build(
        extra={"moe_experts": "8"}).config.moe_experts == 8
    adapter = treg.get("llama-moe-tiny").build(quant="int8")
    a = adapter.init_params(seed=3, device="cpu")
    b = adapter.init_params(seed=3, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["layer_0.moe.experts_up_int8"].dtype == torch.int8
    assert int(a["layer_0.moe.experts_up_int8"].abs().max()) == 127
    np.testing.assert_allclose(
        a["layer_1.moe.experts_down_scale"].numpy(), 1 / (127 * 128 ** 0.5))
    assert a["layer_0.moe.router"].dtype == torch.float32
    assert 0.05 < float(a["layer_0.moe.router"].std()) < 0.2  # 1/sqrt(64)


def _prompts():
    return [[(5 * i + 3 * j) % 500 + 1 for j in range(4 + 3 * i)]
            for i in range(3)]


@pytest.fixture(scope="module")
def moe_pair():
    jad, params, tad, model = _moe_tiny()
    return jad, params, tad, tl.LlamaServer(model)


def test_greedy_generate_matches_jax(moe_pair):
    """Greedy tokens of the port's server equal the JAX server's, one row
    at a time and as a ragged batch of 3 (the same buckets, so the same
    padding tokens in each routing group)."""
    jad, params, _, server = moe_pair
    jserver = jad.make_server(params)
    for p in _prompts():
        np.testing.assert_array_equal(
            server.generate(p, max_new_tokens=8),
            np.asarray(jserver.generate(p, max_new_tokens=8)))
    np.testing.assert_array_equal(
        server.generate(_prompts(), max_new_tokens=6),
        np.asarray(jserver.generate(_prompts(), max_new_tokens=6)))


def test_engine_at_one_live_row_matches_jax_and_solo(moe_pair):
    """An engine of one slot: each request is the only token source of its
    routing groups, so its tokens are its solo ``generate``'s and the JAX
    engine's."""
    jad, params, _, server = moe_pair
    jengine = JaxBatcher(jad.make_server(params), slots=1, segment=4,
                         window_bucketing=False, pipeline_depth=1)
    engine = make_engine(server, {"batch_max": "1", "batch_segment": "4"})
    for p in _prompts():
        got = engine.generate(p, max_new_tokens=7)
        np.testing.assert_array_equal(got, server.generate(
            p, max_new_tokens=7))
        np.testing.assert_array_equal(np.ravel(got), np.ravel(
            jengine.generate(p, max_new_tokens=7)))


def _burst(engine, requests):
    """The requests from their own threads, queued one by one in order
    while the test holds the device lock, so every engine packs the first
    row alone, runs it one segment and admits the rest, in order, at the
    next barrier: the same steps over the same slots whatever the
    threads' timing (under MoE a row's tokens depend on which rows share
    its steps)."""
    import threading
    import time

    from lambdipy_tpu_torch.models.graphs import DEVICE_LOCK

    out = [None] * len(requests)

    def run(i):
        out[i] = engine.generate(requests[i], max_new_tokens=5 + 3 * i,
                                 return_logprobs=True)

    def queued():
        with engine._lock:
            return (sum(e is not None for e in engine._active),
                    len(engine._joiners))

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(requests))]
    with DEVICE_LOCK:
        for i, t in enumerate(threads):
            t.start()
            # the first row in its slot before the next one queues, each
            # next one queued before the one after it
            want = (1, 0) if i == 0 else (1, i)
            deadline = time.monotonic() + 60
            while queued() != want and time.monotonic() < deadline:
                time.sleep(0.005)
            assert queued() == want
    for t in threads:
        t.join(timeout=120)
    return out


@pytest.mark.parametrize("other", [
    {"batch_window_bucketing": "0"},  # bucketing off = on
    {},                               # the same burst again
])
def test_engine_identities_that_hold_under_moe(moe_pair, other):
    """Under MoE a row's seat depends on the other tokens of its routing
    group, so an engine row need not be its solo row (as in JAX), and
    whatever changes the tokens that idle or finished slots feed into a
    step changes live rows: a paged engine against a dense one (idle
    slots share the arena's null page) and pipeline depth 2 against 1
    (finished rows decode behind the frontier) are not identities here.
    Two engines that run the same steps with the same slot contents are:
    window bucketing off is bitwise on, and a burst is bitwise itself
    again (tokens and logprobs), at ragged output lengths."""
    server = moe_pair[3]
    base = {"batch_max": "4", "batch_segment": "4", "pipeline_depth": "1"}
    requests = _prompts() + [[9, 8, 7, 6, 5]]
    want = _burst(make_engine(server, base), requests)
    got = _burst(make_engine(server, {**base, **other}), requests)
    for (wt, wl), (gt, gl) in zip(want, got):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gl, wl)


def test_graph_replay_is_bitwise_eager_under_moe(moe_pair):
    """Routing captures into the decode and prefill programs (static
    shapes, no host sync): a server on the stand-in graph type gives the
    eager server's tokens and logprobs bitwise, twice."""
    from test_torch_graphs import FakeGraph

    model = moe_pair[3].model
    graph = tl.LlamaServer(model, graphs=FakeGraph)
    eager = tl.LlamaServer(model, graphs=False)
    for p in _prompts()[:2]:
        want = eager.generate(p, max_new_tokens=6, return_logprobs=True)
        for _ in range(2):
            got = graph.generate(p, max_new_tokens=6, return_logprobs=True)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


def test_jax_built_moe_bundle_boots_with_jaxs_tokens(tmp_path):
    """A ``llama-moe-tiny`` bundle built by the JAX builder (``params.fpk``
    with ``layer_i/moe/...``) boots in the port, whose greedy tokens are
    the JAX boot's."""
    from test_runtime import make_model_bundle

    from lambdipy_tpu.runtime.loader import load_bundle as jax_load
    from lambdipy_tpu_torch.runtime.loader import load_bundle

    bundle = make_model_bundle(
        tmp_path, model="llama-moe-tiny",
        handler="lambdipy_tpu.runtime.handlers:generate_handler",
        extra={"max_new_tokens": "6"})
    jboot = jax_load(bundle, warmup=False)
    boot = load_bundle(bundle, warmup=False, device="cpu")
    assert boot.state.server.model.cfg.moe_experts == 4
    for req in ({"tokens": [5, 17, 3, 99, 250], "max_new_tokens": 6},
                {"tokens": [[5, 17, 3], [8, 1, 2, 4, 9, 11]],
                 "max_new_tokens": 4}):
        want = jboot.handler.invoke(jboot.state, req)
        got = boot.state.invoke(req)
        assert got["ok"] and want["ok"]
        assert got["tokens"] == want["tokens"]
