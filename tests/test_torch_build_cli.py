"""The port's bundle lifecycle on the CPU: the build engine, bundle assembly,
the warm, the deploy layer and the CLI (``lambdipy_tpu_torch/__main__.py``)
against the JAX package's, mirroring ``tests/test_buildengine.py``,
``test_cli.py``, ``test_releases.py``' CLI loop and the deploy tests of
``test_runtime.py``:

- a vendor build of the JAX tests' tiny recipe gives the same site files,
  provenance and smoke in both packages;
- ``build`` (registry, cache hit, ``--out``), ``artifacts``, ``publish`` /
  ``fetch`` / ``releases`` (and the fall-back past a corrupt asset),
  ``package``, and ``deploy`` rejecting an unknown target;
- a ``llama-tiny`` and a ``resnet50-tiny`` payload recipe built by the port
  boot in the port on the CPU and answer as the in-process model, exactly;
- one deploy -> invoke -> stop lifecycle on the CPU under the watchdog,
  the supervisor's give-up, and no fallback: without a card and without
  a CPU request ``deploy`` and ``serve`` exit before any readiness line;
- the warm's outcome in the manifest (a timed-out warm is ``ok: false``),
  ``doctor``'s report and its exit code, and the params' forms.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from lambdipy_tpu.bundle.package import _HANDLER_TEMPLATE as JAX_TEMPLATE
from lambdipy_tpu.buildengine import build_recipe as jax_build
from lambdipy_tpu.recipes.schema import load_recipe_dict as jax_recipe
from lambdipy_tpu_torch import __main__ as cli
from lambdipy_tpu_torch.buildengine import build_recipe
from lambdipy_tpu_torch.buildengine.engine import BuildError
from lambdipy_tpu_torch.bundle.format import load_manifest, verify_files
from lambdipy_tpu_torch.bundle.package import (HANDLER_TEMPLATE,
                                               assemble_bundle)
from lambdipy_tpu_torch.models import registry
from lambdipy_tpu_torch.recipes import builtin_store
from lambdipy_tpu_torch.recipes.schema import load_recipe_dict
from lambdipy_tpu_torch.resolve.registry import ArtifactRegistry
from lambdipy_tpu_torch.resolve.releases import ReleaseStore, pack_bundle
from lambdipy_tpu_torch.runtime import deploy
from lambdipy_tpu_torch.runtime.loader import load_bundle

ROOT = Path(__file__).resolve().parent.parent
PYVER = f"{sys.version_info.major}.{sys.version_info.minor}"
PYTAG = "py" + PYVER.replace(".", "")
# the JAX build tests' tiny vendor recipe (tests/test_buildengine.py)
CLICKY = {"schema": 1, "name": "clicky", "version": "1.0",
          "requires": ["click>=8"],
          "prune": {"rules": ["tests", "pycache", "dist-info-extras"]}}
TINY = {  # recipe name: (model, handler, extra)
    "tiny-llm": ("llama-tiny", "generate_handler",
                 {"max_new_tokens": "4", "prefix_cache_mb": "0",
                  "warm_group_prefill": "0"}),
    "tiny-resnet": ("resnet50-tiny", "image_classify_handler", {}),
}


def _recipe_text(name: str) -> str:
    model, handler, extra = TINY[name]
    text = (f'schema = 1\nname = "{name}"\nversion = "0.1"\n'
            'device = "any"\nbase_layer = "torch"\nrequires = []\n'
            f'[payload]\nmodel = "{model}"\n'
            f'handler = "lambdipy_tpu_torch.runtime.handlers:{handler}"\n'
            'params = "init"\ndtype = "float32"\n')
    if extra:
        text += "[payload.extra]\n" + "".join(
            f'{k} = "{v}"\n' for k, v in extra.items())
    return text


@pytest.fixture(scope="module")
def recipe_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("recipes")
    for name in TINY:
        (d / f"{name}.toml").write_text(_recipe_text(name))
    return d


@pytest.fixture(scope="module")
def built(tmp_path_factory, recipe_dir):
    """Each tiny recipe built once by the CLI with ``--out`` (the warm on
    for the llama)."""
    root = tmp_path_factory.mktemp("built")
    out = {}
    for name in TINY:
        out[name] = root / name
        args = ["build", name, "--recipe-dir", str(recipe_dir), "--out",
                str(out[name]), "--no-smoke"]
        if name != "tiny-llm":
            args.append("--no-warm")
        assert cli.main(args) == 0
    return out


def run(args, capsys) -> tuple:
    rc = cli.main([str(a) for a in args])
    got = capsys.readouterr()
    return rc, got.out, got.err


# -- the build engine against JAX's -----------------------------------------


@pytest.fixture(scope="module")
def clicky_builds(tmp_path_factory):
    root = tmp_path_factory.mktemp("clicky")
    port = build_recipe(load_recipe_dict(CLICKY), root / "port")
    jax = jax_build(jax_recipe(CLICKY), root / "jax")
    return port, jax


def _site(path: Path) -> dict:
    """The tree's files and bytes; the bytecode the smoke's imports leave
    behind aside (it records each tree's own path)."""
    return {p.relative_to(path).as_posix(): p.read_bytes()
            for p in sorted(path.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_vendor_build_gives_the_same_site_in_both(clicky_builds):
    port, jax = clicky_builds
    assert _site(port.site_dir) == _site(jax.site_dir)
    assert port.vendored == jax.vendored
    assert port.smoke_versions == jax.smoke_versions and \
        port.smoke_versions.get("click")
    assert port.prune.as_dict() == jax.prune.as_dict()
    prov = port.provenance()
    assert prov["recipe"] == "clicky"
    assert {"stage", "prune", "smoke", "total"} <= set(prov["timings"])


def test_an_assembled_bundle_verifies_and_catches_tampering(clicky_builds,
                                                            tmp_path):
    port, _ = clicky_builds
    out = tmp_path / "bundle"
    manifest = assemble_bundle(port, out, plain_deps=["einops"],
                               with_payload=False)
    assert manifest["artifact_id"] == f"clicky-1.0-{PYTAG}-any"
    assert load_manifest(out)["base_layer"]["name"] == "none"
    assert (out / "site" / "einops" / "__init__.py").exists()
    assert verify_files(out) == []
    victim = next(f for f in manifest["files"] if f["path"].endswith(".py"))
    (out / victim["path"]).write_text("tampered\n")
    assert any("mismatch" in p for p in verify_files(out))


def test_build_errors_and_skipped_optionals_as_in_jax(tmp_path):
    with pytest.raises(BuildError, match="not installed"):
        build_recipe(load_recipe_dict({**CLICKY, "requires": [
            "definitely-not-installed-xyz"]}), tmp_path / "a")
    res = build_recipe(load_recipe_dict({
        **CLICKY, "optional_requires": ["definitely-not-installed-xyz"]}),
        tmp_path / "b", run_smoke=False)
    assert res.skipped_optional == ["definitely-not-installed-xyz"]


def test_the_torch_layer_vendors_nothing_of_torch(tmp_path):
    """numpy and torch come from the base layer: smoke-tested through a
    site of exactly the layer, not copied."""
    res = build_recipe(load_recipe_dict({
        "schema": 1, "name": "thin", "version": "1",
        "requires": ["torch", "numpy"], "base_layer": "torch"}),
        tmp_path / "work")
    assert res.vendored == []
    assert {b["name"] for b in res.base_provided} == {"torch", "numpy"}
    assert res.smoke_versions["torch"] == torch.__version__
    assert not (tmp_path / "work" / "site" / "torch").exists()


def test_the_handler_template_is_jaxs_text():
    assert HANDLER_TEMPLATE == JAX_TEMPLATE


# -- the CLI ----------------------------------------------------------------


def test_recipes_and_show(recipe_dir, capsys):
    rc, out, _ = run(["recipes", "--recipe-dir", recipe_dir], capsys)
    assert rc == 0 and "tiny-llm" in out
    names = [ln.split()[0] for ln in out.splitlines()]
    assert set(builtin_store().names()) < set(names)
    assert "gpu-h100-1" in next(ln for ln in out.splitlines()
                                if ln.startswith("jax-resnet50"))
    rc, out, _ = run(["show", "jax-llama3-8b"], capsys)
    doc = json.loads(out)
    assert rc == 0 and doc["payload"]["quant"] == "int8"
    assert doc["payload"]["mesh"] == [["dp", 1], ["tp", 1]]
    rc, _, err = run(["show", "nope"], capsys)
    assert rc == 1 and "no recipe named" in err


@pytest.mark.parametrize("argv", [["recipes"], ["deployments"],
                                  ["stop", "nothing"], ["releases"]])
def test_a_command_that_needs_no_model_imports_no_torch(argv, tmp_path):
    """The CLI's own errors are caught without importing the fleet (whose
    router imports torch): a command that serves nothing starts in the
    time of its own imports, not of torch's."""
    code = ("import sys\n"
            "from lambdipy_tpu_torch.__main__ import main\n"
            f"rc = main({argv!r})\n"
            "print(rc, 'torch' in sys.modules)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "HOME": str(tmp_path)})
    rc, has_torch = proc.stdout.split()[-2:]
    assert has_torch == "False", proc.stdout + proc.stderr
    assert rc in ("0", "1"), proc.stdout + proc.stderr


def test_build_publishes_then_hits_the_cache(recipe_dir, tmp_path, capsys):
    reg = tmp_path / "registry"
    args = ["build", "tiny-resnet", "--recipe-dir", recipe_dir, "--registry",
            reg, "--no-smoke", "--no-warm"]
    rc, out, _ = run(args, capsys)
    assert rc == 0 and f"built + published tiny-resnet-0.1-{PYTAG}-any" in out
    rc, out, _ = run(args, capsys)
    assert rc == 0 and out.startswith(f"cache hit: tiny-resnet-0.1-{PYTAG}")
    rc, out, _ = run(["artifacts", "--registry", reg], capsys)
    assert f"tiny-resnet-0.1-{PYTAG}-any" in out


def test_build_out_writes_the_bundle_and_its_warm(built):
    llama = built["tiny-llm"]
    m = load_manifest(llama)
    assert (llama / "handler.py").exists()
    assert (llama / "params" / "params.fpk").is_file()
    assert not (llama / "params" / "orbax").exists()
    assert m["payload"]["params_info"]["format"] == "fpk"
    info = json.loads((llama / "params" / "info.json").read_text())
    assert info["model"] == "llama-tiny" and info["seed"] == 0
    # a device "any" recipe draws its weights on the CPU, and says so
    assert info["init_device"] == "cpu"
    assert m["payload"]["params_info"]["init_device"] == "cpu"
    assert load_manifest(built["tiny-resnet"])["payload"]["params_info"][
        "init_device"] == "cpu"
    assert m["warm"]["ok"] is True and m["warm"]["warmed"] is True
    assert m["warm"]["cache_entries"] == 0
    assert set(m["warm"]["stages"]) == {"manifest", "syspath",
                                        "compile_cache", "handler_import",
                                        "init", "warmup", "total"}
    assert "warm" not in load_manifest(built["tiny-resnet"])


def test_a_timed_out_warm_is_recorded(recipe_dir, tmp_path, monkeypatch,
                                      capsys):
    monkeypatch.setenv("LAMBDIPY_WARM_TIMEOUT", "0.01")
    out = tmp_path / "bundle"
    rc, _, err = run(["build", "tiny-resnet", "--recipe-dir", recipe_dir,
                      "--out", out, "--no-smoke"], capsys)
    assert rc == 0 and "warm timed out" in err
    warm = load_manifest(out)["warm"]
    assert warm["ok"] is False and "timeout" in warm["error"]


@pytest.mark.parametrize("name", sorted(TINY))
def test_a_port_built_bundle_answers_as_the_in_process_model(name, built):
    boot = load_bundle(built[name], device="cpu")
    model, _, extra = TINY[name]
    adapter = registry.get(model).build(dtype="float32", extra=extra)
    weights = adapter.init_params(seed=0, device="cpu")
    loaded = {k: v for k, v in boot.manifest.items() if k == "payload"}
    assert loaded["payload"]["params_info"]["n_params"] == sum(
        t.numel() for t in weights.values())
    if name == "tiny-llm":
        prompt = [5, 17, 3, 99, 250, 8, 41]
        got = boot.state.invoke({"tokens": prompt, "max_new_tokens": 6,
                                 "logprobs": True})
        toks, lps = adapter.make_server(weights, device="cpu").generate(
            [prompt], max_new_tokens=6, return_logprobs=True)
        assert got["tokens"] == toks.tolist()
        assert got["logprobs"] == [[round(float(x), 5) for x in row]
                                   for row in lps]
    else:
        got = boot.state.invoke({"random": True})
        net = adapter.make_model(weights, device="cpu")
        with torch.no_grad():
            logits = net(*adapter.example_batch(1, "cpu")).float().numpy()
        assert got["top5"] == (-logits).argsort(-1)[:, :5].tolist()
        assert got["logit_max"] == float(logits.max())


def test_publish_fetch_and_releases(built, recipe_dir, tmp_path, capsys,
                                    monkeypatch):
    store = ReleaseStore.create(tmp_path / "store", protected=True)
    reg = tmp_path / "maintainer"
    ArtifactRegistry(reg).publish(
        f"tiny-resnet-0.1-{PYTAG}-any", built["tiny-resnet"],
        recipe="tiny-resnet", version="0.1", device="any")
    monkeypatch.delenv("LAMBDIPY_RELEASE_TOKEN", raising=False)
    publish = ["publish", "tiny-resnet", "--recipe-dir", recipe_dir,
               "--release-store", store.root, "--registry", reg]
    rc, _, err = run(publish, capsys)
    assert rc == 1 and "protected" in err
    monkeypatch.setenv("LAMBDIPY_RELEASE_TOKEN", "tok")
    rc, out, _ = run(publish, capsys)
    assert rc == 0 and f"published tiny-resnet-0.1-{PYTAG}-any.tar.gz" in out
    rc, out, _ = run(["releases", "--release-store", store.root], capsys)
    assert rc == 0 and "tiny-resnet-0.1" in out
    user = tmp_path / "user"
    rc, out, _ = run(["fetch", "tiny-resnet", "--recipe-dir", recipe_dir,
                      "--release-store", store.root, "--registry", user],
                     capsys)
    assert rc == 0 and ArtifactRegistry(user).list()[0].recipe == \
        "tiny-resnet"
    build = ["build", "tiny-resnet", "--recipe-dir", recipe_dir,
             "--release-store", store.root, "--registry", tmp_path / "u2"]
    rc, out, _ = run(build, capsys)
    assert rc == 0 and "fetched prebuilt" in out and "built" not in \
        out.replace("fetched prebuilt", "")
    rc, out, _ = run(build, capsys)
    assert out.startswith("cache hit")
    # the fetched bundle is the published one, file for file
    assert pack_bundle(ArtifactRegistry(user).fetch(
        f"tiny-resnet-0.1-{PYTAG}-any"), tmp_path / "a.tar.gz").read_bytes() \
        == pack_bundle(built["tiny-resnet"], tmp_path / "b.tar.gz").read_bytes()
    rc, _, err = run(["fetch", "certifi", "--release-store", store.root],
                     capsys)
    assert rc == 1 and "no prebuilt asset" in err


def test_build_falls_back_past_a_corrupt_asset(built, recipe_dir, tmp_path,
                                               capsys):
    store = ReleaseStore.create(tmp_path / "store")
    asset = store.upload_asset(
        "v1", pack_bundle(built["tiny-resnet"], tmp_path / "t.tar.gz"),
        artifact_id=f"tiny-resnet-0.1-{PYTAG}-any", recipe="tiny-resnet",
        version="0.1", python=PYVER, device="any")
    path = store.asset_path(asset)
    path.write_bytes(path.read_bytes() + b"x")
    rc, out, err = run(["build", "tiny-resnet", "--recipe-dir", recipe_dir,
                        "--release-store", store.root, "--registry",
                        tmp_path / "reg", "--no-smoke", "--no-warm"], capsys)
    assert rc == 0 and "prebuilt fetch failed" in err
    assert f"built + published tiny-resnet-0.1-{PYTAG}-any" in out


def test_package_covers_recipes_and_plain_deps(tmp_path, capsys):
    req = tmp_path / "requirements.txt"
    req.write_text("einops\n")
    rc, out, _ = run(["package", req, "--out", tmp_path / "tree"], capsys)
    assert rc == 0 and "plain dep: einops==" in out
    assert (tmp_path / "tree" / "site" / "einops" / "__init__.py").exists()
    rc, _, err = run(["package", tmp_path / "missing.txt", "--out",
                      tmp_path / "t2"], capsys)
    assert rc == 1 and "does not exist" in err


def test_names_resolve_in_jaxs_order(built, recipe_dir, tmp_path,
                                     monkeypatch, capsys):
    reg = ArtifactRegistry(tmp_path / "reg")
    aid = f"tiny-resnet-0.1-{PYTAG}-any"
    reg.publish(aid, built["tiny-resnet"], recipe="tiny-resnet",
                version="0.1", device="any")
    assert cli._resolve_bundle(str(built["tiny-llm"]), reg.root) == \
        built["tiny-llm"]
    assert cli._resolve_bundle(aid, reg.root) == reg.fetch(aid)
    # a custom recipe: by the name recorded at publish
    assert cli._resolve_bundle("tiny-resnet", reg.root) == reg.fetch(aid)
    assert cli._resolve_bundle("llama-tiny", reg.root) is None
    with pytest.raises(cli.CliError, match="has no built artifact"):
        cli._resolve_bundle("jax-resnet50", reg.root)
    monkeypatch.setattr(deploy, "DEFAULT_STATE", tmp_path / "d.json")
    rc, _, err = run(["deploy", "definitely-missing", "--registry",
                      reg.root], capsys)
    assert rc == 1 and "neither a bundle dir" in err


# -- deploy, the watchdog, no fallback --------------------------------------


def test_deploy_invoke_stop_on_the_cpu(built, tmp_path):
    rt = deploy.LocalRuntime(tmp_path / "deployments.json")
    dep = rt.deploy("t1", built["tiny-llm"], device="cpu")
    try:
        health = rt.health("t1")
        assert health["ok"] and health["pid"] != dep.pid  # supervised
        assert list(dep.cold_start)[:3] == ["manifest", "syspath",
                                            "compile_cache"]
        out = rt.invoke("t1", {"tokens": [1, 2], "max_new_tokens": 2})
        assert out["ok"] and len(out["tokens"][0]) == 2
        chunks = list(rt.invoke_stream("t1", {"tokens": [1, 2],
                                              "max_new_tokens": 2}))
        assert chunks[-1]["done"]
        with pytest.raises(deploy.DeployError, match="already exists"):
            rt.deploy("t1", built["tiny-llm"], device="cpu")
        assert [d.name for d in rt.list()] == ["t1"]
        assert (tmp_path / "t1.serve.log").exists()
    finally:
        rt.stop("t1")
    assert rt.list() == [] and not (tmp_path / "t1.serve.log").exists()
    assert not deploy._group_alive(dep.pid)


@pytest.mark.slow  # JAX's twin is slow; the port's takes ~10 s here
def test_the_watchdog_respawns_a_killed_server(built, tmp_path):
    """``test_runtime.py::test_watchdog_restarts_killed_server``'s twin:
    SIGKILL the server, not the supervisor; it comes back on the same
    port under a new pid and answers as before."""
    import signal
    import time

    rt = deploy.LocalRuntime(tmp_path / "deployments.json")
    dep = rt.deploy("wd", built["tiny-llm"], device="cpu")
    try:
        req = {"tokens": [1, 2], "max_new_tokens": 2}
        before = rt.invoke("wd", req)
        first = rt.health("wd")
        assert first["ok"] and first["pid"] != dep.pid
        os.kill(first["pid"], signal.SIGKILL)
        deadline, second = time.monotonic() + 120, None
        while time.monotonic() < deadline:
            try:
                second = rt.health("wd")
                if second["pid"] != first["pid"] and second["ready"]:
                    break
            except OSError:
                pass
            time.sleep(0.2)
        assert second is not None and second["pid"] != first["pid"]
        assert rt.invoke("wd", req) == before
    finally:
        rt.stop("wd")
    assert rt.list() == []


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host with "
                    "no CUDA card")
def test_without_a_card_deploy_and_serve_exit_before_ready(built, tmp_path,
                                                           monkeypatch):
    monkeypatch.delenv("LAMBDIPY_PLATFORM", raising=False)
    rt = deploy.LocalRuntime(tmp_path / "deployments.json")
    with pytest.raises(deploy.DeployError, match="no CUDA device"):
        rt.deploy("t2", built["tiny-llm"])
    assert rt.list() == [] and not (tmp_path / "t2.serve.log").exists()
    env = {k: v for k, v in os.environ.items() if k != "LAMBDIPY_PLATFORM"}
    proc = subprocess.run(
        [sys.executable, "-m", "lambdipy_tpu_torch", "serve",
         str(built["tiny-llm"]), "--port", "0"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and '"ready"' not in proc.stdout
    assert "no CUDA device" in proc.stderr


def test_the_card_check_asks_libcuda():
    """``deploy``'s check counts the cards without importing torch: none
    when the variable hides them, and torch's count otherwise."""
    assert deploy.cuda_cards({"CUDA_VISIBLE_DEVICES": ""}) == 0
    assert deploy.cuda_cards({}) == torch.cuda.device_count()
    deploy.require_device({"LAMBDIPY_PLATFORM": "cpu",
                           "CUDA_VISIBLE_DEVICES": ""})
    with pytest.raises(deploy.DeployError, match="--device cpu"):
        deploy.require_device({"CUDA_VISIBLE_DEVICES": ""})


def test_the_supervisor_gives_up(tmp_path):
    env = {**os.environ, "LAMBDIPY_MAX_RESTARTS": "1",
           "LAMBDIPY_PLATFORM": "cpu"}
    r = subprocess.run(
        [sys.executable, "-m", "lambdipy_tpu_torch.runtime.supervisor",
         str(tmp_path / "not-a-bundle")], cwd=ROOT, capture_output=True,
        text=True, env=env, timeout=120)
    assert r.returncode == 1 and "giving up" in r.stderr


def test_doctor_reports_and_exits_as_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("LAMBDIPY_PLATFORM", raising=False)
    args = ["doctor", "--probe-timeout", "60", "--registry",
            tmp_path / "reg", "--state", tmp_path / "deployments.json"]
    rc, out, _ = run([*args, "--device", "cpu"], capsys)
    doc = json.loads(out)
    assert rc == 0 and doc["packages"]["torch"] == torch.__version__
    assert set(doc["kernels"]) == {"cache_dir", "built", "missing", "nvcc"}
    assert doc["registry"]["artifacts"] == 0 and doc["deployments"] == []
    assert doc["device"]["ok"] == torch.cuda.is_available()
    # --device cpu asks for this command alone: the process keeps no trace
    assert "LAMBDIPY_PLATFORM" not in os.environ
    monkeypatch.setenv("LAMBDIPY_DOCTOR_WEDGE", "1")
    with pytest.raises(SystemExit) as exc:
        cli.main([str(a) for a in [*args[:1], "--probe-timeout", "1",
                                   *args[3:]]])
    doc = json.loads(capsys.readouterr().out)
    assert exc.value.code == 1 and "wedge" in doc["device"]["error"]


def test_the_kernel_cache_variable_moves_the_build_cache(tmp_path):
    """``LAMBDIPY_KERNEL_CACHE`` names the kernel build cache (read when
    ``ops/_build.py`` is imported), and ``doctor`` reports that one."""
    env = {**os.environ, "LAMBDIPY_KERNEL_CACHE": str(tmp_path / "kc"),
           "PYTHONPATH": str(ROOT)}
    code = ("import json; from lambdipy_tpu_torch.__main__ import "
            "_kernel_toolchain; from lambdipy_tpu_torch.ops import _build; "
            "print(json.dumps([str(_build.BUILD_DIR), "
            "str(_build.library_path('int8_matmul').parent), "
            "_kernel_toolchain()]))")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    build_dir, lib_dir, report = json.loads(r.stdout.strip().splitlines()[-1])
    assert build_dir == lib_dir == report["cache_dir"] == str(tmp_path / "kc")
    assert report["missing"] == ["decode_attention", "int8_matmul",
                                 "flash_attention"]


# -- the params' forms ------------------------------------------------------


def _payload_recipe(device="any", **payload):
    return load_recipe_dict({
        "schema": 1, "name": "p", "version": "1", "device": device,
        "payload": {
            "model": "llama-tiny", "dtype": "float32",
            "handler": "lambdipy_tpu_torch.runtime.handlers:generate_handler",
            **payload}})


@pytest.mark.parametrize("payload,error,match", [
    ({"params_format": "orbax"}, ValueError, "orbax"),
    ({"params": "hf"}, NotImplementedError, "not ported"),
    ({"params": "/definitely/missing"}, ValueError, "neither"),
])
def test_unbuildable_params_raise_at_build(payload, error, match, tmp_path):
    from lambdipy_tpu_torch.bundle.package import materialize_payload

    with pytest.raises(error, match=match):
        materialize_payload(_payload_recipe(**payload), tmp_path)


def test_a_card_recipe_draws_its_weights_on_the_card_only(tmp_path,
                                                          monkeypatch,
                                                          capsys):
    """A ``gpu-h100-1`` recipe's weights are drawn on the card: the CPU's
    generator would draw others under the same artifact id, so a CPU
    request fails before the build; a recipe that names no card draws on
    the CPU."""
    from lambdipy_tpu_torch.bundle.package import (build_device,
                                                   materialize_payload)

    card = _payload_recipe(device="gpu-h100-1")
    monkeypatch.setenv("LAMBDIPY_PLATFORM", "cpu")
    with pytest.raises(ValueError, match="drawn on the card"):
        materialize_payload(card, tmp_path)
    assert not (tmp_path / "params").exists()
    assert build_device(_payload_recipe()) == "cpu"
    rdir = tmp_path / "recipes"
    rdir.mkdir()
    (rdir / "card-llm.toml").write_text(_recipe_text("tiny-llm").replace(
        'name = "tiny-llm"', 'name = "card-llm"').replace(
        'device = "any"', 'device = "gpu-h100-1"'))
    rc, out, err = run(["build", "card-llm", "--recipe-dir", rdir, "--out",
                        tmp_path / "b", "--no-smoke"], capsys)
    assert rc == 1 and "drawn on the card" in err
    assert not (tmp_path / "b").exists()
    monkeypatch.delenv("LAMBDIPY_PLATFORM")
    assert build_device(card) is None  # the card, resolved at the draw


def test_a_checkpoint_path_is_hardlinked(built, tmp_path):
    from lambdipy_tpu_torch.bundle.package import materialize_payload

    src = built["tiny-llm"] / "params"
    out = tmp_path / "bundle"
    out.mkdir()
    payload = materialize_payload(_payload_recipe(params=str(src)), out)
    assert payload["params_info"] == {"format": "external",
                                      "source": str(src)}
    assert os.stat(out / "params" / "params.fpk").st_ino == \
        os.stat(src / "params.fpk").st_ino
    fpk = tmp_path / "bundle2"
    fpk.mkdir()
    materialize_payload(_payload_recipe(params=str(src / "params.fpk")), fpk)
    assert (fpk / "params" / "params.fpk").read_bytes() == \
        (src / "params.fpk").read_bytes()
    orbax_only = tmp_path / "ckpt"
    (orbax_only / "orbax").mkdir(parents=True)
    (tmp_path / "bundle3").mkdir()
    with pytest.raises(ValueError, match="only an orbax"):
        materialize_payload(_payload_recipe(params=str(orbax_only)),
                            tmp_path / "bundle3")
