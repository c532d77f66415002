"""The BASELINE's configs 1-4 served from bundles the JAX builder made, by
the port and by the JAX package, on the CPU: one bundle per handler
(``hello``, ``tabular``, ``resnet50-tiny``, ``bert-tiny`` f32 and bf16,
the bf16 one with the builder's ``serving_cast`` applied, and a small
``bert-base-torch``).

- The port's ``load_bundle(..., device="cpu")`` boots each with JAX's
  stages, and its ``meta`` is JAX's but for ``aot`` (``"eager"`` here,
  ``"graph"`` on the card; JAX's ``"jit"``) and the torch BERT's
  ``degraded`` (JAX's CPU fallback; the port runs on the CPU only when
  asked).
- Answers held against the JAX bundle's on the same requests: hello and
  tabular exactly; classification within the module tests' bounds
  (``tests/test_torch_resnet.py``, ``tests/test_torch_bert.py``) with the
  top-5 or the labels equal.
- A request at the example shape takes the compiled forward (on the CPU
  its body runs eagerly: a capture needs the card); another batch size
  runs the model eagerly and gives the same numbers.
- A manifest's ``params_info.config`` overrides ``extra``; a mesh larger
  than one device serves with ``sharded: false`` and a warning.
- Twins of ``tests/test_runtime.py::test_resnet_bundle_image_handler``,
  ``::test_hello_bundle_without_params`` and of ``tests/test_e2e.py``'s
  configs 1-4 (over the port's HTTP server), and the CLI.
"""

import json
import os
import signal
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from lambdipy_tpu.buildengine import build_recipe
from lambdipy_tpu.bundle import assemble_bundle
from lambdipy_tpu.models import registry as jreg
from lambdipy_tpu.recipes.schema import load_recipe_dict
from lambdipy_tpu.runtime.loader import load_bundle as jax_load_bundle
from lambdipy_tpu_torch.runtime.handlers import (HandlerContext,
                                                 image_classify_handler,
                                                 text_classify_handler)
from lambdipy_tpu_torch.runtime.loader import load_bundle
from lambdipy_tpu_torch.runtime.server import BundleServer

ROOT = Path(__file__).resolve().parent.parent
TORCH_DIMS = {"vocab_size": "128", "hidden": "32", "layers": "1",
              "heads": "2", "max_len": "16", "num_classes": "2"}
# name: (model, handler, dtype, extra, optional_requires)
BUNDLES = {
    "hello": ("hello", "hello_handler", "float32", {}, []),
    "tabular": ("tabular", "tabular_handler", "float32", {}, ["xgboost"]),
    "resnet": ("resnet50-tiny", "image_classify_handler", "float32", {}, []),
    "bert": ("bert-tiny", "text_classify_handler", "float32", {}, []),
    "bert-bf16": ("bert-tiny", "text_classify_handler", "bfloat16", {}, []),
    "torch-bert": ("bert-base-torch", "torch_text_classify_handler",
                   "float32", TORCH_DIMS, ["torch-xla"]),
}
# the module tests' bounds on max |port - jax| / max |jax|
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
STAGES = ["manifest", "syspath", "compile_cache", "handler_import", "init",
          "warmup", "total"]


def make_bundle(tmp: Path, name: str) -> Path:
    """The JAX builder's bundle (``tests/test_runtime.py
    make_model_bundle``, with a dtype and optional requirements)."""
    model, handler, dtype, extra, optional = BUNDLES[name]
    doc = {"schema": 1, "name": f"test-{name}", "version": "0.1",
           "device": "any", "base_layer": "jax-tpu", "requires": [],
           "optional_requires": optional,
           "payload": {"model": model, "params": "init", "dtype": dtype,
                       "handler": f"lambdipy_tpu.runtime.handlers:{handler}",
                       **({"extra": extra} if extra else {})}}
    result = build_recipe(load_recipe_dict(doc), tmp / "work",
                          run_smoke=False)
    assemble_bundle(result, tmp / "bundle", with_payload=True)
    return tmp / "bundle"


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    return {name: make_bundle(tmp_path_factory.mktemp(name), name)
            for name in BUNDLES}


@pytest.fixture(scope="module")
def boots(bundles):
    """name -> (JAX boot report, port boot report)."""
    return {name: (jax_load_bundle(path),
                   load_bundle(path, device="cpu"))
            for name, path in bundles.items()}


def _requests(name: str) -> list:
    rng = np.random.default_rng(5)
    if name == "hello":
        return [{"n": 16, "seed": 7}, {"n": 33, "seed": 3}, {}]
    if name == "tabular":
        return [{"instances": [[0.0] * 16]},
                {"instances": rng.normal(size=(3, 16)).tolist()},
                {"instances": rng.normal(size=16).tolist()},
                {"random": True}]
    if name == "resnet":
        return [{"random": True},
                {"image": rng.normal(size=(32, 32, 3)).tolist()},
                {"image": rng.normal(size=(2, 32, 32, 3)).tolist()}]
    vocab = 128 if name == "torch-bert" else 1024
    return [{"random": True},
            {"input_ids": rng.integers(1, vocab, 11).tolist()},
            {"input_ids": rng.integers(1, vocab, (2, 7)).tolist()}]


def _invoke(report, req):
    out = report.handler.invoke(report.state, req)
    out.pop("latency_ms", None)  # JAX's HandlerState adds it
    return out


@pytest.mark.parametrize("name", list(BUNDLES))
def test_boot_stages_and_meta_are_jaxs(boots, bundles, name):
    jax_boot, boot = boots[name]
    assert list(boot.stages) == list(jax_boot.stages) == STAGES
    assert boot.warmup_result["ok"]
    want = dict(jax_boot.state.meta)
    got = dict(boot.state.meta)
    if name in ("resnet", "bert", "bert-bf16"):
        assert want.pop("aot") == "jit" and got.pop("aot") == "eager"
    if name == "torch-bert":
        assert "CPU torch" in want.pop("degraded") and "degraded" not in got
    assert got == want
    if name == "bert-bf16":  # the bf16 bundle really holds cast kernels
        info = boot.manifest["payload"]["params_info"]
        assert info["serving_cast"]["applied"]
        model = boot.state.forward.model
        assert model.encoder.layer_0.attn.query.kernel.dtype == torch.bfloat16
        assert model.classifier.kernel.dtype == torch.float32


@pytest.mark.parametrize("name", list(BUNDLES))
def test_answers_match_the_jax_bundles(boots, name):
    jax_boot, boot = boots[name]
    dtype = BUNDLES[name][2]
    for req in _requests(name):
        want, got = _invoke(jax_boot, req), _invoke(boot, req)
        assert got["ok"] and want["ok"], (got, want)
        if name in ("hello", "tabular"):
            assert got == want
        elif name == "resnet":
            assert got["top5"] == want["top5"]
            assert got["top1"] == want["top1"]
            assert abs(got["logit_max"] - want["logit_max"]) <= \
                TOL[dtype] * max(abs(want["logit_max"]), 1e-6)
        elif name == "torch-bert":
            assert got["labels"] == want["labels"]
            assert got["device"] == want["device"] == "cpu"
        else:
            assert got["labels"] == want["labels"]
            w, g = np.asarray(want["logits"]), np.asarray(got["logits"])
            assert np.abs(g - w).max() <= TOL[dtype] * np.abs(w).max()


@pytest.mark.parametrize("name", ["resnet", "bert", "torch-bert"])
def test_example_shape_takes_the_compiled_route(boots, name):
    """A batch-1 request runs the program (its body, eagerly here); a
    batch-2 request runs the model eagerly: the same numbers for the
    same row."""
    _, boot = boots[name]
    program = boot.state.forward
    assert program.mode == "eager" and program.rows == 1
    req = _requests(name)[1]
    key = "image" if name == "resnet" else "input_ids"
    before = program.report()
    one = _invoke(boot, req)
    mid = program.report()
    two = _invoke(boot, {key: [req[key], req[key]]})
    after = program.report()
    assert mid["eager_runs"] == before["eager_runs"] + 1
    assert mid["other_shapes"] == before["other_shapes"]
    assert after["other_shapes"] == mid["other_shapes"] + 1
    assert after["eager_runs"] == mid["eager_runs"]
    assert after["compile_count"] == 0 and after["replays"] == 0
    if name == "resnet":
        assert two["top5"] == [one["top5"][0]] * 2
        np.testing.assert_allclose(two["logit_max"], one["logit_max"],
                                   rtol=1e-5)
    else:
        assert two["labels"] == one["labels"] * 2
    if "logits" in one:
        np.testing.assert_allclose(two["logits"], one["logits"] * 2,
                                   rtol=1e-5, atol=1e-6)


class StandInGraph:
    """``models/graphs.py CudaGraph``'s calls on the CPU: ``capture`` runs
    ``prepare`` and keeps the body, ``replay`` runs it."""

    def __init__(self, device):
        self.fn, self.pool_bytes = None, 0

    def capture(self, fn, prepare):
        prepare()
        self.fn = fn

    def replay(self):
        self.fn()

    def reset(self):
        self.fn = None


@pytest.mark.parametrize("name", ["resnet", "bert"])
def test_captured_forward_replays_at_the_example_shape(boots, name):
    """With a graph type the program captures at construction and every
    example-shaped call replays: the answers are the eager program's, a
    replay overwrites the one before it only in the program's buffers,
    and another shape never touches the graph."""
    from lambdipy_tpu_torch.models.graphs import ForwardProgram

    eager = boots[name][1].state.forward
    program = ForwardProgram(eager.model, eager.example,
                             graph_type=StandInGraph)
    assert program.mode == "graph"
    assert program.report()["compile_count"] == 1
    req = _requests(name)[1]
    if name == "resnet":
        args = [(torch.tensor(req["image"])[None],),
                (torch.tensor(req["image"]).flip(0)[None],)]
    else:
        ids = torch.tensor(req["input_ids"])
        args = [(ids[None], torch.ones(1, ids.numel(), dtype=torch.long)),
                (ids.flip(0)[None], torch.ones(1, ids.numel(),
                                               dtype=torch.long))]
        args = [tuple(torch.nn.functional.pad(a, (0, 64 - a.shape[1]))
                      for a in pair) for pair in args]
    first = program(*args[0])
    second = program(*args[1])
    assert torch.equal(first, eager(*args[0]))
    assert torch.equal(second, eager(*args[1]))
    assert not torch.equal(first, second)
    two = program(*(torch.cat([a, a]) for a in args[0]))
    report = program.report()
    assert report["replays"] == 3 and report["eager_runs"] == 0
    assert report["other_shapes"] == 1
    torch.testing.assert_close(two[:1], first, rtol=1e-5, atol=1e-6)


def test_params_info_config_overrides_extra():
    """The manifest's ``params_info.config`` (a converted checkpoint's
    architecture) wins over the spec's ``extra``, as in JAX."""
    spec = {"model": "resnet50", "dtype": "float32",
            "extra": {"num_classes": "1000", "image_size": "224"}}
    config = {"num_classes": 7, "image_size": 16}
    ctx = HandlerContext(device="cpu", manifest={
        "payload": {"params_info": {"config": config}}})
    state = image_classify_handler(spec, ctx)
    cfg = state.forward.model.cfg
    assert (cfg.num_classes, cfg.image_size) == (7, 16)
    assert tuple(state.forward.example[0].shape) == (1, 16, 16, 3)
    out = state.invoke({"random": True})
    assert out["ok"] and sorted(out["top5"][0]) == sorted(set(out["top5"][0]))
    assert max(out["top5"][0]) < 7
    # the JAX builder takes the same merged extra to the same widths
    jmodule = jreg.get("resnet50").build(
        dtype="float32", extra={**spec["extra"], **config}).module
    assert jmodule.num_classes == cfg.num_classes
    assert (jmodule.width, tuple(jmodule.stage_sizes)) == \
        (cfg.width, cfg.stage_sizes)


def test_mesh_larger_than_one_device_serves_unsharded(capfd):
    spec = {"model": "bert-tiny", "dtype": "float32", "mesh": {"dp": 1,
                                                                "tp": 2}}
    state = text_classify_handler(spec, HandlerContext(device="cpu"))
    assert state.meta["sharded"] is False
    assert "SINGLE-DEVICE" in capfd.readouterr().err
    assert state.invoke({"input_ids": [1, 2, 3]})["ok"]


# twins of tests/test_runtime.py and tests/test_e2e.py


def test_resnet_bundle_image_handler(boots):
    _, report = boots["resnet"]
    out = report.handler.invoke(report.state, {"random": True})
    assert out["ok"] and len(out["top5"][0]) == 5


def test_hello_bundle_without_params(boots, bundles):
    assert not (bundles["hello"] / "params").exists()
    _, report = boots["hello"]
    out = report.handler.invoke(report.state, {"n": 16, "seed": 7})
    assert out["ok"] and isinstance(out["logdet"], float)


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _serve(bundle, request):
    """``BundleServer.from_bundle`` on the CPU: (/healthz, /invoke's
    answer, /metrics)."""
    server = BundleServer.from_bundle(bundle, device="cpu")
    server.start_background()
    try:
        health = _get(server.url + "/healthz")
        out = _post(server.url + "/invoke", request)
        metrics = _get(server.url + "/metrics")
    finally:
        server.stop(drain_grace=2.0)
    assert health["ok"] and health["ready"] and out["ok"], (health, out)
    assert list(health["cold_start"]) == STAGES
    assert health["bundle"] == str(bundle)
    assert metrics["server"]["requests"] >= 1
    assert metrics["server"]["errors"] == 0
    return health, out, metrics


def test_config1_hello_numpy_bundle(bundles):
    health, out, metrics = _serve(bundles["hello"], {"n": 32, "seed": 3})
    assert isinstance(out["logdet"], float)
    assert out["numpy"] == np.__version__
    assert "init" in health["cold_start"]
    assert metrics["handler"] == {}  # no stats from this handler


def test_config2_tabular_bundle_degrades_without_xgboost(bundles):
    _, out, _ = _serve(bundles["tabular"], {"instances": [[0.0] * 16]})
    assert out["predictions"] and out["probabilities"]
    assert out["degraded"] == ["xgboost"]


def test_config3_resnet_serving_bundle(bundles):
    health, out, metrics = _serve(bundles["resnet"], {"random": True})
    assert len(out["top5"][0]) == 5
    assert health["handler_meta"]["model"] == "resnet50-tiny"
    assert health["handler_meta"]["aot"] in ("graph", "eager")
    # the boot's warmup and this invoke, through the compiled route
    assert metrics["handler"]["forward"]["eager_runs"] == 2


def test_config4_torch_bert_on_the_asked_device(bundles):
    """JAX degrades to the CPU without torch-xla; the port serves on the
    device it is given (the card by default; the CPU here)."""
    health, out, _ = _serve(bundles["torch-bert"], {"input_ids": [5, 9, 2]})
    assert out["labels"][0] in (0, 1)
    assert out["device"] == "cpu"
    assert health["handler_meta"]["device"] == "cpu"


def test_cli_serves_a_classify_bundle(bundles, tmp_path):
    """``python -m lambdipy_tpu_torch serve <bundle> --device cpu``: the
    readiness line, an invoke, and exit 0 on SIGTERM."""
    with open(tmp_path / "stderr.log", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "lambdipy_tpu_torch", "serve",
             str(bundles["bert"]), "--port", "0", "--device", "cpu"],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=err, text=True,
            env={**os.environ, "LAMBDIPY_LOG_LEVEL": "WARNING"})
    try:
        line = proc.stdout.readline()
        assert line, (tmp_path / "stderr.log").read_text()[-3000:]
        ready = json.loads(line)
        assert ready["ready"] and list(ready["cold_start"]) == STAGES
        base = f"http://127.0.0.1:{ready['port']}"
        assert _get(base + "/healthz")["handler_meta"]["max_len"] == 64
        out = _post(base + "/invoke", {"input_ids": [4, 8, 15, 16, 23]})
        assert out["ok"] and len(out["logits"][0]) == 2
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
