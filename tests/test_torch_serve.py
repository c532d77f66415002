"""The port's serving path against the JAX package's: ``LlamaServer.generate``
token-exact on ``llama-tiny`` (f32; blocked decode attention over float
and int8 K/V, and flash prefill), seeded sampling, the HTTP ``/invoke``
surface, the CLI's config overrides, and the rule that the port imports
nothing of JAX or of the JAX package."""

import json
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest

from lambdipy_tpu.models import registry as jreg
from lambdipy_tpu_torch.__main__ import _parse_extra
from lambdipy_tpu_torch.models import registry as treg
from lambdipy_tpu_torch.models.params import from_jax_params
from lambdipy_tpu_torch.runtime.handlers import (HandlerContext,
                                                 generate_handler)
from lambdipy_tpu_torch.runtime.server import BundleServer

ROOT = Path(__file__).resolve().parent.parent
ROWS = [list(range(1, 25)), list(range(7, 14))]
EXTRA = {"attn_backend": "blocked"}


@pytest.fixture(scope="module")
def weights():
    adapter = jreg.get("llama-tiny").build(extra=EXTRA)
    params = adapter.init_params(seed=0)
    return adapter, params, from_jax_params(
        jax.tree_util.tree_map(np.asarray, params))


@pytest.fixture(scope="module")
def jax_server(weights):
    adapter, params, _ = weights
    return adapter.make_server(params)


@pytest.fixture(scope="module")
def port_server(weights):
    return treg.get("llama-tiny").build(extra=EXTRA).make_server(
        weights[2], device="cpu")


def test_greedy_ragged_generate_is_token_exact(jax_server, port_server):
    want, want_lp = jax_server.generate(ROWS, max_new_tokens=10,
                                        return_logprobs=True)
    got, got_lp = port_server.generate(ROWS, max_new_tokens=10,
                                       return_logprobs=True)
    assert got.dtype == np.int32 and got.shape == (2, 10)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got_lp, want_lp, atol=1e-4)


@pytest.mark.parametrize("extra", [
    {"attn_backend": "blocked", "kv_quant": "int8"},
    {"attn_backend": "flash"},
], ids=["blocked-int8kv", "flash"])
def test_greedy_ragged_generate_is_token_exact_on_new_paths(weights, extra):
    """Ragged rows (prompt bucket 32, so the flash prefill pads) under the
    int8 KV cache and under flash prefill: the same tokens as the JAX
    server, logprobs within 1e-4 (f32 summation order)."""
    _, params, sd = weights
    rows = [list(range(3, 30)), list(range(40, 49)), [5, 6]]
    want, want_lp = jreg.get("llama-tiny").build(extra=extra).make_server(
        params).generate(rows, max_new_tokens=10, return_logprobs=True)
    got, got_lp = treg.get("llama-tiny").build(extra=extra).make_server(
        sd, device="cpu").generate(rows, max_new_tokens=10,
                                   return_logprobs=True)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got_lp, want_lp, atol=1e-4)


def test_greedy_eos_latching_is_token_exact(jax_server, port_server):
    plain = port_server.generate(ROWS, max_new_tokens=10)
    eos = int(plain[0, 3])  # row 0 meets it mid-decode
    want = jax_server.generate(ROWS, max_new_tokens=10, eos_id=eos)
    got = port_server.generate(ROWS, max_new_tokens=10, eos_id=eos)
    np.testing.assert_array_equal(got, want)
    first = list(got[0]).index(eos)
    assert (got[0, first:] == eos).all()


def test_zero_new_tokens_and_validation(port_server):
    assert port_server.generate(ROWS, max_new_tokens=0).shape == (2, 0)
    with pytest.raises(ValueError, match="max_len"):
        port_server.generate([1] * 100, max_new_tokens=60)
    with pytest.raises(ValueError, match="empty prompt"):
        port_server.generate([[1, 2], []], max_new_tokens=2)


def test_sampled_is_seed_deterministic_and_batch_independent(port_server):
    knobs = {"temperature": 0.9, "top_k": 40}
    a = port_server.generate([ROWS[1]], max_new_tokens=12, seed=7, **knobs)
    b = port_server.generate([ROWS[1]], max_new_tokens=12, seed=7, **knobs)
    other = port_server.generate([ROWS[1]], max_new_tokens=12, seed=8,
                                 **knobs)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, other)
    # packed beside another request, under its own seed: row 1 carries
    # seed 7 and must sample exactly what it sampled solo
    packed = port_server.generate([ROWS[0], ROWS[1]], max_new_tokens=12,
                                  seed=[3, 7], temperature=[0.5, 0.9],
                                  top_k=[0, 40])
    solo_listed = port_server.generate([ROWS[1]], max_new_tokens=12,
                                       seed=[7], **knobs)
    np.testing.assert_array_equal(packed[1], solo_listed[0])


def test_greedy_rows_ignore_sampled_neighbours(port_server):
    greedy = port_server.generate([ROWS[0]], max_new_tokens=8)
    mixed = port_server.generate(ROWS, max_new_tokens=8, seed=[0, 5],
                                 temperature=[0.0, 1.0])
    np.testing.assert_array_equal(mixed[0], greedy[0])


def _post(url, body):
    """-> (HTTP status, JSON body); error statuses carry a body too."""
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return json.loads(resp.read())


def test_http_invoke_matches_jax_generate(weights, jax_server):
    state = generate_handler({"model": "llama-tiny", "dtype": "float32",
                              "extra": EXTRA},
                             HandlerContext(device="cpu",
                                            state_dict=weights[2]))
    server = BundleServer(state, port=0).start_background()
    try:
        assert _get(server.url + "/healthz")["handler_meta"]["device"] \
            == "cpu"
        code, out = _post(server.url + "/invoke", {
            "tokens": ROWS, "max_new_tokens": 6, "logprobs": True})
        assert code == 200
        _, warm = _post(server.url + "/invoke", {"warmup": True})
        bad = _post(server.url + "/invoke", {"tokens": []})
        metrics = _get(server.url + "/metrics")
    finally:
        server.stop()
    want = jax_server.generate(ROWS, max_new_tokens=6)
    assert out["ok"] and out["tokens"] == want.tolist()
    assert out["n_new"] == 6 and out["n_prompt"] == 31
    assert len(out["logprobs"]) == 2 and len(out["logprobs"][0]) == 6
    assert warm["ok"] and warm["n_new"] == 16
    # the handler's refusal is a 200, counted as served (JAX's /invoke);
    # HandlerState.invoke adds latency_ms (a wall time), as JAX's does
    assert isinstance(bad[1].pop("latency_ms"), float)
    assert bad == (200, {"ok": False, "error": "empty prompt"})
    assert metrics["server"]["requests"] == 3
    assert metrics["server"]["errors"] == 0
    assert set(metrics["handler"]["kernels"]) == {
        "decode_attention", "decode_attention_int8kv",
        "paged_decode_attention", "paged_decode_attention_int8kv",
        "int8_matmul", "flash_attention"}


def test_port_imports_nothing_of_jax():
    """Importing every module of the port (and chip_smoke.py) pulls in no
    ``jax*`` module and no ``lambdipy_tpu`` / ``lambdipy_tpu.*`` module."""
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in (ROOT / "lambdipy_tpu_torch").rglob("*.py"))
    code = (
        "import sys, importlib, runpy\n"
        "before = set(sys.modules)\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m.removesuffix('.__init__'))\n"
        "runpy.run_path('chip_smoke.py', run_name='not_main')\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m == 'jax' or m.startswith('jax')\n"
        "             or m == 'flax' or m.startswith('flax.')\n"
        "             or m == 'lambdipy_tpu'\n"
        "             or m.startswith('lambdipy_tpu.'))\n"
        "print(len(new), bad)\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "lambdipy_tpu_torch.runtime.server" in mods


def test_chip_smoke_refuses_without_a_card():
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_cli_extra_parsing():
    assert _parse_extra("attn_backend=blocked, matmul_backend=pallas") == {
        "attn_backend": "blocked", "matmul_backend": "pallas"}
    assert _parse_extra("") == {}
    with pytest.raises(SystemExit):
        _parse_extra("attn_backend")


def test_cli_extra_selects_int8_kv_and_flash():
    """``serve --extra kv_quant=int8,attn_backend=flash`` reaches the
    config, and the handler reports it."""
    extra = _parse_extra("kv_quant=int8,attn_backend=flash")
    assert extra == {"kv_quant": "int8", "attn_backend": "flash"}
    cfg = treg.get("llama3-8b").build(extra=extra).config
    assert (cfg.kv_quant, cfg.attn_backend) == ("int8", "flash")
    state = generate_handler({"model": "llama-tiny", "extra": extra},
                             HandlerContext(device="cpu"))
    assert state.meta["kv_quant"] == "int8"
    assert state.meta["attn_backend"] == "flash"
    out = state.invoke({"tokens": [1, 2, 3], "max_new_tokens": 3})
    assert out["ok"] and len(out["tokens"][0]) == 3
