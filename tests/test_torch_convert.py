"""The port's HF import (``lambdipy_tpu_torch/models/convert.py``), the twin
of ``tests/test_convert.py``: logits and greedy tokens of a converted tiny
``transformers`` Llama against transformers' own forward and against the
JAX package's import; the converted tree bitwise JAX's (tied embeddings
and bf16 included); ``save_pretrained`` output read by the port's own
reader, unsharded, sharded and as ``pytorch_model.bin``; what raises;
``save_hf_params`` and ``llama-hf``; and the quickstart's ``params =
"hf"`` flow (build, deploy, invoke) through the port's CLI on the CPU.

Tolerances: against transformers ``rtol=1e-3``, ``atol=2e-3`` on logits
(f32), as JAX's test; trees bitwise; greedy tokens exact."""

import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lambdipy_tpu.models import convert as jconvert
from lambdipy_tpu.models import llama as jl
from lambdipy_tpu_torch.models import convert
from lambdipy_tpu_torch.models import registry as treg
from lambdipy_tpu_torch.models.llama import LlamaServer
from lambdipy_tpu_torch.models.params import from_jax_params

HF_TOL = {"rtol": 1e-3, "atol": 2e-3}
F32 = {"dtype": torch.float32}


@pytest.fixture(scope="module")
def hf_llama():
    from transformers import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rope_theta=10000.0, rms_norm_eps=1e-5,
        attention_bias=False, tie_word_embeddings=False)
    torch.manual_seed(0)
    model = LlamaForCausalLM(cfg)
    model.eval()
    return model


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(1, 128, shape)


def _model(cfg, params):
    """The port's model on the CPU holding a converted tree."""
    return treg.TorchModel(cfg).make_model(from_jax_params(params),
                                           device="cpu")


def _logits(cfg, params, toks):
    with torch.inference_mode():
        return _model(cfg, params)(torch.as_tensor(toks).long())[0].numpy()


def _hf_logits(model, toks):
    with torch.no_grad():
        return model(torch.as_tensor(toks)).logits.float().numpy()


def _assert_trees_equal(tree, jtree):
    """The port's tree (torch leaves) bitwise JAX's (numpy leaves)."""
    got = from_jax_params(tree)
    want = from_jax_params(jax.device_get(jtree))
    assert set(got) == set(want)
    for key, t in want.items():
        assert got[key].dtype == t.dtype, key
        assert torch.equal(got[key], t), key


def test_hf_llama_logits_parity(hf_llama):
    """Converted weights reproduce transformers' logits (f32), and the
    tree is JAX's import, bitwise."""
    cfg, params = convert.import_hf_llama(hf_llama, config_overrides=F32)
    assert cfg.layers == 2 and cfg.heads == 4 and cfg.kv_heads == 2
    _assert_trees_equal(params, jconvert.import_hf_llama(hf_llama)[1])
    toks = _tokens((2, 10))
    np.testing.assert_allclose(_hf_logits(hf_llama, toks),
                               _logits(cfg, params, toks), **HF_TOL)


def test_hf_llama_greedy_decode_parity(hf_llama):
    """Greedy tokens agree with transformers' and with the JAX import's."""
    cfg, params = convert.import_hf_llama(hf_llama, config_overrides=F32)
    toks = _tokens((1, 6), seed=3)
    with torch.no_grad():
        ref = hf_llama.generate(
            torch.tensor(toks), max_new_tokens=6, do_sample=False,
            pad_token_id=0).numpy()[:, toks.shape[1]:]
    ours = LlamaServer(_model(cfg, params)).generate(toks[0],
                                                     max_new_tokens=6)
    np.testing.assert_array_equal(ours, ref)
    jcfg, jparams = jconvert.import_hf_llama(
        hf_llama, config_overrides={"dtype": jnp.float32})
    jtoks = jl.greedy_generate(jl.LlamaModel(jcfg), jparams,
                               jnp.asarray(toks, jnp.int32), max_new_tokens=6)
    np.testing.assert_array_equal(ours, np.asarray(jtoks))


@pytest.mark.parametrize("how", ["safetensors", "sharded", "bin",
                                 "bin_sharded"])
def test_hf_llama_from_local_path(hf_llama, tmp_path, how):
    """``save_pretrained`` output read by the port's own reader: one
    ``model.safetensors``, shards behind ``model.safetensors.index.json``,
    ``pytorch_model.bin``, or its shards behind
    ``pytorch_model.bin.index.json``; the tree is the in-memory model's,
    bitwise, and its logits transformers'."""
    kw = {"safetensors": {}, "sharded": {"max_shard_size": "40KB"},
          "bin": {"safe_serialization": False},
          "bin_sharded": {"safe_serialization": False,
                          "max_shard_size": "40KB"}}[how]
    hf_llama.save_pretrained(tmp_path / "ckpt", **kw)
    names = {p.name for p in (tmp_path / "ckpt").iterdir()}
    if how == "sharded":
        assert "model.safetensors.index.json" in names and len(
            [n for n in names if n.endswith(".safetensors")]) > 2
    elif how == "bin":
        assert "pytorch_model.bin" in names
    elif how == "bin_sharded":
        assert "pytorch_model.bin.index.json" in names and len(
            [n for n in names if n.endswith(".bin")]) > 2
    cfg, params = convert.import_hf_llama(tmp_path / "ckpt",
                                          config_overrides=F32)
    _assert_trees_equal(params, jconvert.import_hf_llama(hf_llama)[1])
    toks = _tokens((1, 8), seed=1)
    np.testing.assert_allclose(_hf_logits(hf_llama, toks),
                               _logits(cfg, params, toks), **HF_TOL)


def test_hf_llama_tied_embeddings(tmp_path):
    from transformers import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(
        vocab_size=96, hidden_size=32, intermediate_size=64,
        num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=2,
        max_position_embeddings=32, tie_word_embeddings=True)
    torch.manual_seed(1)
    model = LlamaForCausalLM(cfg)
    model.eval()
    model.save_pretrained(tmp_path / "ckpt")  # writes no lm_head.weight
    for source in (model, tmp_path / "ckpt"):
        our_cfg, params = convert.import_hf_llama(source,
                                                  config_overrides=F32)
        emb = params["params"]["embed"]["embedding"]
        assert torch.equal(params["params"]["lm_head"]["kernel"], emb.T)
        _assert_trees_equal(params, jconvert.import_hf_llama(model)[1])
    toks = _tokens((1, 5), seed=2) % 96
    np.testing.assert_allclose(_hf_logits(model, toks),
                               _logits(our_cfg, params, toks), **HF_TOL)


def test_save_hf_params_and_registry_roundtrip(hf_llama, tmp_path):
    """``save_hf_params`` -> ``params.fpk`` -> the ``llama-hf`` adapter
    serves it; the recorded architecture is complete and JAX's."""
    hf_llama.save_pretrained(tmp_path / "ckpt")
    info = convert.save_hf_params(tmp_path / "ckpt", tmp_path / "params")
    assert info["source"] == "hf" and info["n_params"] > 0
    assert info["format"] == "fpk" and info["quant"] is None
    assert info["config"]["norm_eps"] == pytest.approx(1e-5)
    assert info["config"]["max_len"] == 64
    jinfo = jconvert.save_hf_params(tmp_path / "ckpt", tmp_path / "jparams",
                                    params_format="fpk")
    assert info["config"] == jinfo["config"]
    assert set(info) == set(jinfo) and info["n_params"] == jinfo["n_params"]
    adapter = treg.get("llama-hf").build(dtype="float32",
                                         extra=info["config"])
    model = adapter.make_model(adapter.load_params(tmp_path / "params",
                                                   device="cpu"),
                               device="cpu")
    toks = _tokens((1, 7), seed=4)
    with torch.inference_mode():
        logits = model(torch.as_tensor(toks).long())[0].numpy()
    np.testing.assert_allclose(_hf_logits(hf_llama, toks), logits, **HF_TOL)
    with pytest.raises(ValueError, match="orbax"):
        convert.save_hf_params(tmp_path / "ckpt", tmp_path / "o",
                               params_format="orbax")


def test_save_hf_params_int8_is_quantize_params(hf_llama, tmp_path):
    """``quant="int8"``: the written params are JAX's ``quantize_params``
    of JAX's import, bitwise, and load into ``llama-hf`` int8."""
    from lambdipy_tpu_torch.bundle import flatpack

    hf_llama.save_pretrained(tmp_path / "ckpt")
    info = convert.save_hf_params(tmp_path / "ckpt", tmp_path / "params",
                                  quant="int8")
    got = flatpack.load_state_dict(tmp_path / "params" / "params.fpk")
    want = from_jax_params(jax.device_get(jl.quantize_params(
        jconvert.import_hf_llama(hf_llama)[1])))
    assert set(got) == set(want)
    for key, t in want.items():
        assert got[key].dtype == t.dtype and torch.equal(got[key], t), key
    adapter = treg.get("llama-hf").build(dtype="float32", quant="int8",
                                         extra=info["config"])
    adapter.load_params(tmp_path / "params", device="cpu")


def test_hf_import_preserves_bf16(tmp_path):
    """A bf16 checkpoint stays bf16 (no f32 doubling), in memory and read
    from ``model.safetensors`` (``BF16``), bitwise JAX's import."""
    from transformers import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(
        vocab_size=64, hidden_size=32, intermediate_size=64,
        num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=2,
        max_position_embeddings=32)
    torch.manual_seed(2)
    model = LlamaForCausalLM(cfg).to(torch.bfloat16)
    model.save_pretrained(tmp_path / "ckpt")
    header = (tmp_path / "ckpt" / "model.safetensors").read_bytes()[:4096]
    assert b'"BF16"' in header
    for source in (model, tmp_path / "ckpt"):
        _, params = convert.import_hf_llama(source)
        kernel = params["params"]["layer_0"]["q_proj"]["kernel"]
        assert kernel.dtype == torch.bfloat16, kernel.dtype
        _assert_trees_equal(params, jconvert.import_hf_llama(model)[1])


def test_hf_llama31_rope_scaling_parity():
    """A Llama-3.1-style checkpoint (llama3 ``rope_scaling``) reproduces
    transformers' logits."""
    from transformers import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rope_theta=10000.0,
        rope_scaling={"rope_type": "llama3", "factor": 2.0,
                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 32})
    torch.manual_seed(4)
    model = LlamaForCausalLM(cfg)
    model.eval()
    our_cfg, params = convert.import_hf_llama(model, config_overrides=F32)
    assert our_cfg.rope_scaling == ("llama3", 2.0, 1.0, 4.0, 32.0)
    toks = _tokens((2, 40), seed=5)  # deep enough for the scaled freqs
    np.testing.assert_allclose(_hf_logits(model, toks),
                               _logits(our_cfg, params, toks), **HF_TOL)


def test_hf_llama_linear_rope_scaling_parity():
    from transformers import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(
        vocab_size=96, hidden_size=32, intermediate_size=64,
        num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=2,
        max_position_embeddings=64,
        rope_scaling={"rope_type": "linear", "factor": 4.0})
    torch.manual_seed(5)
    model = LlamaForCausalLM(cfg)
    model.eval()
    our_cfg, params = convert.import_hf_llama(model, config_overrides=F32)
    assert our_cfg.rope_scaling == ("linear", 4.0)
    toks = _tokens((1, 24), seed=6) % 96
    np.testing.assert_allclose(_hf_logits(model, toks),
                               _logits(our_cfg, params, toks), **HF_TOL)


def test_hf_unsupported_fields_raise():
    """Unsupported architecture fields raise, with JAX's messages; a raw
    state dict raises (no architecture)."""
    base = {"vocab_size": 64, "hidden_size": 32, "intermediate_size": 64,
            "num_hidden_layers": 1, "num_attention_heads": 2}
    for bad, match in (({"attention_bias": True}, "attention_bias"),
                       ({"mlp_bias": True}, "mlp_bias"),
                       ({"head_dim": 8}, "head_dim"),
                       ({"rope_scaling": {"rope_type": "yarn",
                                          "factor": 2.0}}, "rope_scaling")):
        for fn in (convert.llama_config_from_hf,
                   jconvert.llama_config_from_hf):
            with pytest.raises(ValueError, match=match):
                fn({**base, **bad})
    assert convert.llama_config_from_hf(
        {**base, "head_dim": 16}).head_dim == 16
    with pytest.raises(ValueError, match="raw state_dict"):
        convert.import_hf_llama({"model.norm.weight": torch.ones(4)})


def test_unreadable_checkpoints_raise_with_the_file(hf_llama, tmp_path):
    """No fallback: a directory with no weights, a missing shard, a
    truncated safetensors file and a missing config each raise naming
    the file."""
    hf_llama.save_pretrained(tmp_path / "whole")
    hf_llama.save_pretrained(tmp_path / "sharded", max_shard_size="40KB")
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "config.json").write_text(
        (tmp_path / "whole" / "config.json").read_text())
    with pytest.raises(convert.CheckpointError, match="no model.safetensors"):
        convert.import_hf_llama(empty)
    shard = sorted((tmp_path / "sharded").glob("model-*.safetensors"))[0]
    shard.unlink()
    with pytest.raises(convert.CheckpointError, match=shard.name):
        convert.import_hf_llama(tmp_path / "sharded")
    st = tmp_path / "whole" / "model.safetensors"
    st.write_bytes(st.read_bytes()[:-100])
    with pytest.raises(convert.CheckpointError, match="model.safetensors"):
        convert.import_hf_llama(tmp_path / "whole")
    with pytest.raises(convert.CheckpointError, match="config.json"):
        convert.import_hf_llama(tmp_path / "nowhere")


def test_hf_bert_import_is_jaxs(tmp_path):
    """``import_hf_bert`` from a model and from its directory: JAX's tree
    bitwise, and the port's classifier gives transformers' logits."""
    from transformers import BertConfig, BertForSequenceClassification

    cfg = BertConfig(vocab_size=100, hidden_size=32, num_hidden_layers=2,
                     num_attention_heads=4, intermediate_size=64,
                     max_position_embeddings=64, num_labels=3)
    torch.manual_seed(7)
    model = BertForSequenceClassification(cfg).eval()
    model.save_pretrained(tmp_path / "bert")
    jtree = jconvert.import_hf_bert(model)[1]
    for source in (model, tmp_path / "bert"):
        our_cfg, params = convert.import_hf_bert(
            source, config_overrides={"dtype": torch.float32})
        assert our_cfg.num_classes == 3
        _assert_trees_equal(params, jtree)
    ids = torch.as_tensor(_tokens((2, 12), seed=8) % 100)
    mask = torch.ones_like(ids)
    with torch.no_grad():
        ref = model(input_ids=ids, attention_mask=mask).logits.numpy()
    ours = treg.TorchModel(our_cfg).make_model(from_jax_params(params),
                                               device="cpu")
    with torch.inference_mode():
        got = ours(ids, mask).float().numpy()
    np.testing.assert_allclose(got, ref, **HF_TOL)


def test_hf_rope_scaling_roundtrips_through_bundle(tmp_path):
    """``save_hf_params`` records ``rope_scaling``; after a JSON round trip
    the ``llama-hf`` adapter restores the tuple."""
    from transformers import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(
        vocab_size=64, hidden_size=32, intermediate_size=64,
        num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=2,
        max_position_embeddings=64,
        rope_scaling={"rope_type": "llama3", "factor": 2.0,
                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 32})
    torch.manual_seed(6)
    LlamaForCausalLM(cfg).save_pretrained(tmp_path / "ckpt")
    info = convert.save_hf_params(tmp_path / "ckpt", tmp_path / "params")
    info_config = json.loads(json.dumps(info["config"]))
    adapter = treg.get("llama-hf").build(dtype="float32", extra=info_config)
    assert adapter.config.rope_scaling == ("llama3", 2.0, 1.0, 4.0, 32.0)


def _refused(rt, body: dict) -> dict:
    """The body of a request the deployment answers with a 400."""
    import urllib.error

    with pytest.raises(urllib.error.HTTPError) as e:
        rt.invoke("hf-llama", body)
    assert e.value.code == 400
    return json.loads(e.value.read())


def test_hf_bundle_text_serving(hf_llama, tmp_path, monkeypatch, capsys):
    """``docs/quickstart.md``'s migration path through the port's CLI on
    the CPU: a local HF checkpoint and tokenizer -> a recipe with ``params
    = "hf"`` -> ``build`` -> ``deploy`` -> text in, text out; the token
    API on the same deployment; clean errors for empty prompts; SSE
    ``/v1/completions`` streams text deltas that add up to the completion;
    the served tokens are the converted model's own greedy tokens."""
    from test_convert import _tiny_tokenizer

    from lambdipy_tpu_torch import __main__ as cli
    from lambdipy_tpu_torch.runtime import deploy

    hf_llama.save_pretrained(tmp_path / "ckpt")
    _tiny_tokenizer(tmp_path / "tok")
    rdir = tmp_path / "recipes"
    rdir.mkdir()
    (rdir / "hf-llama.toml").write_text(f'''
schema = 1
name = "hf-llama"
version = "0.1"
device = "any"
base_layer = "torch"
requires = []

[payload]
model = "llama-hf"
handler = "lambdipy_tpu_torch.runtime.handlers:generate_handler"
params = "hf"
dtype = "float32"
batch_size = 1

[payload.extra]
hf_path = "{tmp_path / 'ckpt'}"
tokenizer_path = "{tmp_path / 'tok'}"
max_new_tokens = 4
prefix_cache_mb = 0
warm_group_prefill = 0
''')
    monkeypatch.setattr(deploy, "DEFAULT_STATE", tmp_path / "deps.json")
    reg = str(tmp_path / "registry")

    def run(*args):
        rc = cli.main([str(a) for a in args])
        out = capsys.readouterr().out
        assert rc == 0, out
        return out

    run("build", "hf-llama", "--registry", reg, "--recipe-dir", rdir,
        "--no-smoke", "--no-warm")
    import shutil

    shutil.rmtree(tmp_path / "tok")  # the bundle carries its tokenizer
    run("deploy", "hf-llama", "--registry", reg, "--device", "cpu")
    try:
        rt = deploy.LocalRuntime()
        assert rt.health("hf-llama")["handler_meta"]["tokenizer"] is True
        out = json.loads(run("invoke", "hf-llama", "--data", json.dumps(
            {"text": "the cat sat", "max_new_tokens": 4})).splitlines()[-1])
        assert out["ok"] and isinstance(out["completion"], str), out
        toks = [2, 3, 4]
        out2 = rt.invoke("hf-llama", {"tokens": toks, "max_new_tokens": 3})
        assert out2["ok"] and len(out2["tokens"][0]) == 3
        cfg, params = convert.import_hf_llama(hf_llama,
                                              config_overrides=F32)
        want = LlamaServer(_model(cfg, params)).generate(toks,
                                                         max_new_tokens=3)
        assert out2["tokens"] == want.tolist()
        # the port answers a handler's refusal with a 400 (JAX: a 200)
        bad = _refused(rt, {"text": ""})
        assert bad["ok"] is False and "zero tokens" in bad["error"]
        assert _refused(rt, {"tokens": []})["ok"] is False
        ref = rt.invoke("hf-llama", {"text": "the cat sat",
                                     "max_new_tokens": 4, "eos_id": -1})
        req = urllib.request.Request(
            f"{rt.get('hf-llama').url}/v1/completions",
            data=json.dumps({"prompt": "the cat sat", "max_tokens": 4,
                             "temperature": 0, "stream": True,
                             "segment": 4, "eos_id": -1}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            events = [ln.decode().strip()[len("data: "):] for ln in resp
                      if ln.strip().startswith(b"data: ")]
        assert events[-1] == "[DONE]"
        parsed = [json.loads(e) for e in events[:-1]]
        assert "".join(p["choices"][0]["text"] for p in parsed) \
            == ref["completion"]
        assert any(p["choices"][0]["text"] and p["choices"][0]["tokens"]
                   for p in parsed), "no non-final chunk carried text"
    finally:
        run("stop", "hf-llama")
