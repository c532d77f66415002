"""Bundle boot of the port against the JAX package's, on the CPU: a
``llama-tiny`` bundle (f32, carrying an offline WordLevel tokenizer)
built by the JAX builder and booted by both packages.

- flatpack both ways: JAX's ``flatpack.load`` reads a port-written file
  equal to the tree, the file byte-identical to JAX's for the same tree,
  and the port reads a JAX-written ``params.fpk`` equal to
  ``from_jax_params(flatpack.load(...))`` (f32, and bf16 and int8 leaves
  of ``llama-tiny`` with ``quant=int8``); exact, the bytes are copied;
- boot: JAX's stage names in JAX's order, JAX's skew report; an
  orbax-only params directory, an unported handler, a missing manifest,
  an unknown schema and ``LAMBDIPY_DEBUG_NANS=1`` raise at boot;
- serving: greedy tokens equal to the JAX bundle's, logprobs within
  1e-4 (the serve parity tests' tolerance); text requests (``text``,
  ``completion``, the default ``eos_id``, streamed deltas, the SSE
  ``text``) equal to JAX's, exactly: the same tokens decode to the same
  text;
- HTTP: ``/healthz``'s boot fields against the JAX server's, and
  ``/profile``.
"""

import json
import os
import shutil
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch
from test_runtime import make_model_bundle

from lambdipy_tpu.bundle import flatpack as jflatpack
from lambdipy_tpu.models import registry as jreg
from lambdipy_tpu.runtime.server import BundleServer as JaxServer
from lambdipy_tpu_torch.bundle import flatpack
from lambdipy_tpu_torch.bundle.format import BundleError
from lambdipy_tpu_torch.models.params import from_jax_params
from lambdipy_tpu_torch.runtime.loader import load_bundle
from lambdipy_tpu_torch.runtime.server import BundleServer

PROMPT = [5, 17, 3, 99, 250, 8, 41]
TEXT = "hello world the cat sat on the mat"
LP_TOL = 1e-4


def tiny_tokenizer(save_dir, vocab_size: int = 512):
    """A WordLevel tokenizer built offline over the model's whole vocab,
    so every id the random model emits decodes to a word."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    words = ["hello", "world", "the", "cat", "sat", "on", "mat", "a"]
    vocab = {"[UNK]": 0, "[EOS]": 1}
    vocab.update({w: i + 2 for i, w in enumerate(words)})
    vocab.update({f"w{i}": i for i in range(len(vocab), vocab_size)})
    tok = Tokenizer(models.WordLevel(vocab=vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="[UNK]",
                            eos_token="[EOS]").save_pretrained(save_dir)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch-bundle")
    tiny_tokenizer(tmp / "tok")
    return make_model_bundle(
        tmp, model="llama-tiny",
        handler="lambdipy_tpu.runtime.handlers:generate_handler",
        extra={"max_new_tokens": "8", "tokenizer_path": str(tmp / "tok")})


@pytest.fixture(scope="module")
def jax_server(bundle):
    srv = JaxServer(bundle, port=0).start_background()
    yield srv
    srv.stop(drain_grace=2.0)


@pytest.fixture(scope="module")
def port_server(bundle):
    srv = BundleServer.from_bundle(bundle, device="cpu").start_background()
    yield srv
    srv.stop(drain_grace=2.0)


def _int8_tree():
    adapter = jreg.get("llama-tiny").build(dtype="bfloat16", quant="int8")
    return jax.device_get(adapter.init_params(seed=0))


def _tree(kind, bundle):
    if kind == "f32":
        return jflatpack.load(bundle / "params" / "params.fpk")
    return _int8_tree()


def _as_torch(tree):
    """The same tree with the port's tensors as leaves."""
    sd = from_jax_params(tree)
    out: dict = {}
    for key, val in sd.items():
        node = out.setdefault("params", {})
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val
    return out


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_port_written_flatpack_is_jaxs(bundle, tmp_path, kind):
    """The port's writer gives JAX's bytes for the same tree (numpy or
    torch leaves), and JAX's reader gets the tree back."""
    tree = _tree(kind, bundle)
    jflatpack.save(tmp_path / "jax.fpk", tree)
    flatpack.save(tmp_path / "np.fpk", tree)
    flatpack.save(tmp_path / "torch.fpk", _as_torch(tree))
    want = (tmp_path / "jax.fpk").read_bytes()
    assert (tmp_path / "np.fpk").read_bytes() == want
    assert (tmp_path / "torch.fpk").read_bytes() == want
    back = jflatpack.load(tmp_path / "torch.fpk")
    flat = jax.tree_util.tree_leaves_with_path(tree)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(got)
    for path, leaf in flat:
        assert got[path].dtype == leaf.dtype
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf))


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_port_reads_a_jax_written_params_file(bundle, tmp_path, kind):
    """``load_state_dict`` (mapped views) and the chunked ``device_load``
    walk (at chunk sizes that cut tensors anywhere) give
    ``from_jax_params`` of JAX's reader, dtypes included (bf16, int8)."""
    if kind == "f32":
        path = bundle / "params" / "params.fpk"
    else:
        path = tmp_path / "int8.fpk"
        jflatpack.save(path, _int8_tree())
    want = from_jax_params(jflatpack.load(path))
    dtypes = {t.dtype for t in want.values()}
    assert dtypes == ({torch.float32} if kind == "f32"
                      else {torch.float32, torch.bfloat16, torch.int8})
    for got in (flatpack.load_state_dict(path),
                flatpack.device_load(path, "cpu", chunk_bytes=1000),
                flatpack.device_load(path, "cpu", chunk_bytes=4099)):
        assert set(got) == set(want)
        for key, t in want.items():
            assert got[key].dtype == t.dtype and torch.equal(got[key], t)


def test_flatpack_refuses_what_it_cannot_read(tmp_path):
    """A file that is not a flatpack, and a dtype with no torch twin,
    raise."""
    bad = tmp_path / "bad.fpk"
    bad.write_bytes(b"not a flatpack at all")
    with pytest.raises(ValueError, match="not a flatpack"):
        flatpack.load_state_dict(bad)
    odd = tmp_path / "odd.fpk"
    jflatpack.save(odd, {"a": np.zeros(3, np.complex64)})
    with pytest.raises(ValueError, match="complex64"):
        flatpack.load_state_dict(odd)


def test_boot_stages_and_skew_are_jaxs(jax_server, port_server):
    """The port's stages are JAX's, in JAX's order, and its skew report
    is JAX's on the same host."""
    assert list(port_server.boot.stages) == list(jax_server.boot.stages) \
        == ["manifest", "syspath", "compile_cache", "handler_import", "init",
            "warmup", "total"]
    assert port_server.boot.skew == jax_server.boot.skew
    assert port_server.boot.debug_flags == jax_server.boot.debug_flags == {}


def _break(bundle, tmp_path, how):
    out = tmp_path / "bundle"
    shutil.copytree(bundle, out)
    if how == "orbax_only":
        (out / "params" / "params.fpk").unlink()
    elif how == "unported_handler":
        text = (out / "handler.py").read_text()
        (out / "handler.py").write_text(text.replace(
            "import generate_handler as", "import _aot_or_jit as"))
    elif how == "no_manifest":
        (out / "manifest.json").unlink()
    elif how == "unknown_schema":
        m = json.loads((out / "manifest.json").read_text())
        (out / "manifest.json").write_text(json.dumps({**m, "schema": 99}))
    return out


@pytest.mark.parametrize("how,exc,match", [
    ("orbax_only", BundleError, "params_format"),
    ("unported_handler", NotImplementedError, "not ported"),
    ("no_manifest", BundleError, "not a bundle"),
    ("unknown_schema", BundleError, "unsupported bundle schema"),
    ("debug_nans", ValueError, "LAMBDIPY_DEBUG_NANS=1"),
])
def test_boot_raises_on_what_it_cannot_serve(bundle, tmp_path, monkeypatch,
                                             how, exc, match):
    """No fallback: an orbax-only bundle never serves random weights, an
    unported handler never runs the JAX one, and an unported debug flag
    is not ignored."""
    if how == "debug_nans":
        monkeypatch.setenv("LAMBDIPY_DEBUG_NANS", "1")
    with pytest.raises(exc, match=match):
        load_bundle(_break(bundle, tmp_path, how), warmup=False,
                    device="cpu")


def test_bundle_serving_matches_jax(jax_server, port_server):
    """Greedy tokens equal, logprobs within 1e-4, ragged rows too."""
    for req in ({"tokens": PROMPT, "max_new_tokens": 10, "logprobs": True},
                {"tokens": [PROMPT, PROMPT[:3]], "max_new_tokens": 6,
                 "logprobs": True}):
        want = jax_server.boot.handler.invoke(jax_server.boot.state, req)
        got = port_server.state.invoke(req)
        assert got["ok"] and want["ok"]
        assert got["tokens"] == want["tokens"]
        np.testing.assert_allclose(got["logprobs"], want["logprobs"],
                                   atol=LP_TOL)


def test_text_requests_match_jax(jax_server, port_server):
    """``text`` in, ``completion`` out, the tokenizer's eos as the default
    ``eos_id``; streamed: each record's text delta and the summary's
    ``completion`` and ``text`` tail."""
    jstate = jax_server.boot.state
    req = {"text": TEXT, "max_new_tokens": 12}
    want = jstate.invoke(req)
    got = port_server.state.invoke(req)
    assert got["ok"] and got["completion"]
    for key in ("tokens", "completion", "eos_id", "n_prompt"):
        assert got[key] == want[key], key
    assert got["eos_id"] == 1
    stream = {**req, "segment": 4}
    assert list(port_server.state.invoke_stream(stream)) \
        == list(jstate.invoke_stream(stream))
    assert port_server.state.meta["tokenizer"] is True


def _http(url, body=None, raw=False):
    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            code, data = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        code, data = e.code, e.read()
    return code, (data if raw else json.loads(data))


def _sse_text(raw: bytes) -> list:
    return [json.loads(line[len(b"data: "):])["choices"][0]["text"]
            for line in raw.split(b"\n")
            if line.startswith(b"data: {")]


def test_http_boot_fields_profile_and_sse_text(bundle, jax_server,
                                               port_server):
    """``/healthz`` carries JAX's keys with JAX's values where they do
    not depend on the process, the handler's meta under
    ``handler_meta``; the SSE stream of a string prompt carries JAX's
    text chunks; ``/profile`` writes a trace, and a bad ``invokes`` is a
    400."""
    _, want = _http(jax_server_url(jax_server) + "/healthz")
    _, got = _http(port_server.url + "/healthz")
    assert set(got) == set(want)
    for key in ("ok", "ready", "bundle", "skew", "warm", "debug_flags",
                "draining"):
        assert got[key] == want[key], key
    assert list(got["cold_start"]) == list(want["cold_start"])
    assert got["handler_meta"]["model"] == want["handler_meta"]["model"]
    assert got["handler_meta"]["tokenizer"] is True
    body = {"prompt": TEXT, "max_tokens": 8, "temperature": 0,
            "stream": True}
    code, jraw = _http(jax_server_url(jax_server) + "/v1/completions", body,
                       raw=True)
    assert code == 200
    code, raw = _http(port_server.url + "/v1/completions", body, raw=True)
    assert code == 200 and _sse_text(raw) == _sse_text(jraw)
    assert "".join(_sse_text(raw))
    code, out = _http(port_server.url + "/profile", {"invokes": 2})
    assert code == 200 and out["ok"], out
    assert "trace.json" in out["files"]
    assert str(bundle / "profiles") in out["dir"]
    code, out = _http(port_server.url + "/profile", {"invokes": "x"})
    assert code == 400 and not out["ok"]


def jax_server_url(srv) -> str:
    return f"http://127.0.0.1:{srv.port}"


def test_bundle_modules_import_no_ml_dtypes_click_or_orbax(bundle, tmp_path):
    """Every module of the port imported, a bf16 and int8 params file read
    and the CLI's parser built, in a fresh interpreter: no ``ml_dtypes``,
    ``click`` or ``orbax`` module is loaded (the card's host has none)."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    path = tmp_path / "int8.fpk"
    jflatpack.save(path, _int8_tree())
    mods = sorted(".".join(p.relative_to(root).with_suffix("").parts)
                  for p in (root / "lambdipy_tpu_torch").rglob("*.py"))
    code = (
        "import sys, importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m.removesuffix('.__init__'))\n"
        "from lambdipy_tpu_torch.bundle import flatpack\n"
        f"sd = flatpack.load_state_dict({str(path)!r})\n"
        "assert any(t.dtype.is_floating_point and t.itemsize == 2\n"
        "           for t in sd.values())\n"
        "from lambdipy_tpu_torch.__main__ import parser\n"
        "parser().parse_args(['serve', 'x'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('ml_dtypes', 'click', 'orbax', 'jax'))\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_from_bundle_bridges_the_policy_and_floors_the_slots(
        bundle, tmp_path, monkeypatch):
    """The scheduler's policy (the bundle's extra, then ``sched``) reaches
    the handler's boot through ``LAMBDIPY_SCHED_POLICY`` and is unset
    after it, as in JAX (``server.py:183-200``); a continuous bundle's
    ``batch_max`` floors ``max_concurrency`` (``:205-215``)."""
    from lambdipy_tpu_torch.runtime import server as server_mod
    from lambdipy_tpu_torch.runtime.handlers import HandlerState
    from lambdipy_tpu_torch.runtime.loader import BootReport

    monkeypatch.delenv("LAMBDIPY_SCHED_POLICY", raising=False)
    out = tmp_path / "bundle"
    shutil.copytree(bundle, out)
    m = json.loads((out / "manifest.json").read_text())
    extra = {**m["payload"]["extra"], "sched_policy": "fifo",
             "batch_mode": "continuous", "batch_max": "12"}
    m["payload"]["extra"] = extra
    (out / "manifest.json").write_text(json.dumps(m))
    seen = {}

    def boot(bundle_dir, *, warmup, device):
        seen["policy"] = os.environ.get("LAMBDIPY_SCHED_POLICY")
        state = HandlerState(invoke_fn=lambda req: {"ok": True}, meta={},
                             extra=extra)
        return BootReport(bundle_dir=bundle_dir, handler=None, state=state)

    monkeypatch.setattr(server_mod, "load_bundle", boot)
    for sched, policy in ((None, "fifo"), ({"policy": "priority"},
                                           "priority")):
        srv = BundleServer.from_bundle(out, sched=sched, device="cpu")
        try:
            assert seen["policy"] == srv.sched.policy.name == policy
            assert srv.sched.config.max_concurrency == 12
            assert "LAMBDIPY_SCHED_POLICY" not in os.environ
        finally:
            srv.httpd.server_close()


def test_a_users_own_handler_runs_as_in_jax(bundle, tmp_path):
    """A ``handler.py`` that imports nothing of ``lambdipy_tpu`` is run
    (``init(ctx)`` with the port's context, then ``invoke``) and served
    over HTTP."""
    out = tmp_path / "bundle"
    shutil.copytree(bundle, out)
    (out / "handler.py").write_text(
        "def init(ctx):\n"
        "    return {'bundle': str(ctx.bundle_dir), 'model':"
        " ctx.spec['model'], 'params': ctx.params_dir.name}\n\n\n"
        "def invoke(state, request):\n"
        "    return {'ok': True, **state, 'echo': request.get('x')}\n")
    srv = BundleServer.from_bundle(out, device="cpu").start_background()
    try:
        assert srv.boot.warmup_result["echo"] is None
        code, got = _http(srv.url + "/invoke", {"x": 7})
        assert code == 200 and got == {"ok": True, "bundle": str(out),
                                       "model": "llama-tiny",
                                       "params": "params", "echo": 7}
    finally:
        srv.stop(drain_grace=2.0)
