"""The port's bundle command lines on the CPU, on a ``llama-tiny`` bundle
(f32) the JAX builder made:

- ``python -m lambdipy_tpu_torch serve <bundle> --port 0 --device cpu``
  prints JAX's readiness line, serves the bundle's weights (greedy tokens
  equal to the JAX bundle's, exactly), and on SIGTERM finishes the
  request in flight with 200 and exits 0;
- ``python -m lambdipy_tpu_torch.runtime.server <bundle> 0`` (with
  ``LAMBDIPY_PLATFORM=cpu``) prints JAX's server readiness line and exits
  0 on SIGTERM;
- the JAX ``serve`` flags the port takes set the ``LAMBDIPY_*``
  variables the JAX CLI sets, and a ``--mesh`` with a ``dp`` axis and
  ``--prefill-mode sp`` exit before boot.
"""

import json
import os
import signal
import subprocess
import sys
import urllib.request
from pathlib import Path

import pytest
from test_runtime import make_model_bundle

from lambdipy_tpu.runtime.loader import load_bundle as jax_load_bundle
from lambdipy_tpu_torch.__main__ import _ENV_FLAGS, apply_flags, parser

ROOT = Path(__file__).resolve().parent.parent
PROMPT = [5, 17, 3, 99, 250, 8, 41]


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    return make_model_bundle(
        tmp_path_factory.mktemp("torch-cli-bundle"), model="llama-tiny",
        handler="lambdipy_tpu.runtime.handlers:generate_handler",
        extra={"max_new_tokens": "8"})


def _spawn(args, tmp_path, env=None):
    """The command with stdout piped (the readiness line) and stderr to a
    file; returns (process, readiness record)."""
    err = open(tmp_path / "stderr.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", *args], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=err, text=True,
        env={**os.environ, "LAMBDIPY_LOG_LEVEL": "WARNING", **(env or {})})
    err.close()
    line = proc.stdout.readline()
    if not line:
        proc.wait(timeout=30)
        pytest.fail(f"no readiness line (exit {proc.returncode}): "
                    + (tmp_path / "stderr.log").read_text()[-3000:])
    return proc, json.loads(line)


def _post(url, body, stream=False):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    resp = urllib.request.urlopen(req, timeout=120)
    if stream:
        return resp
    with resp:
        return resp.status, json.loads(resp.read())


def test_cli_serves_a_bundle_and_drains_on_sigterm(bundle, tmp_path):
    proc, ready = _spawn(["lambdipy_tpu_torch", "serve", str(bundle),
                          "--port", "0", "--device", "cpu"], tmp_path)
    try:
        assert set(ready) == {"ready", "port", "sched_policy", "cold_start"}
        assert ready["ready"] and ready["sched_policy"] == "fair"
        assert list(ready["cold_start"]) == [
            "manifest", "syspath", "compile_cache", "handler_import", "init",
            "warmup", "total"]
        base = f"http://127.0.0.1:{ready['port']}"
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        assert health["bundle"] == str(bundle)
        assert health["pid"] == proc.pid
        assert health["handler_meta"]["model"] == "llama-tiny"
        code, out = _post(base + "/invoke",
                          {"tokens": PROMPT, "max_new_tokens": 6})
        jax_boot = jax_load_bundle(bundle, warmup=False)
        want = jax_boot.handler.invoke(
            jax_boot.state, {"tokens": PROMPT, "max_new_tokens": 6})
        assert code == 200 and out["tokens"] == want["tokens"]
        # a streamed request in flight (its first chunk read) when SIGTERM
        # lands: it finishes, then the process exits 0
        resp = _post(base + "/invoke", {"tokens": PROMPT,
                                        "max_new_tokens": 48,
                                        "stream": True, "segment": 4},
                     stream=True)
        first = json.loads(resp.readline())
        proc.send_signal(signal.SIGTERM)
        rest = [json.loads(line) for line in resp.read().splitlines()]
        resp.close()
        assert resp.status == 200 and first["ok"]
        assert rest[-1]["done"] and rest[-1]["n_new"] == 48
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def test_server_main_serves_a_bundle(bundle, tmp_path):
    proc, ready = _spawn(["lambdipy_tpu_torch.runtime.server", str(bundle),
                          "0"], tmp_path, env={"LAMBDIPY_PLATFORM": "cpu"})
    try:
        assert set(ready) == {"ready", "pid", "port", "cold_start"}
        assert ready["pid"] == proc.pid and ready["port"] > 0
        code, out = _post(f"http://127.0.0.1:{ready['port']}/invoke",
                          {"tokens": PROMPT, "max_new_tokens": 4})
        assert code == 200 and len(out["tokens"][0]) == 4
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def _clear(monkeypatch):
    """Unset every flag's variable, restored (unset) after the test."""
    for env in _ENV_FLAGS.values():
        monkeypatch.setenv(env, "")
        monkeypatch.delenv(env)


def test_cli_flags_set_the_handlers_environment(monkeypatch):
    """Each flag sets the variable the JAX CLI sets for it, booleans as
    "1" / "0" (``lambdipy_tpu/cli.py:584-612``)."""
    _clear(monkeypatch)
    args = parser().parse_args([
        "serve", "b", "--prefix-cache-mb", "0", "--prefix-block", "16",
        "--session-pin-budget", "8", "--session-ttl", "120",
        "--pipeline-depth", "1", "--engine-watchdog", "3.0", "--kv-paged",
        "--kv-pages", "12", "--max-logical-ctx", "1024", "--no-kv-offload",
        "--kv-offload-mb", "64", "--long-prefill", "--prefill-mode",
        "chunked", "--spec-k", "4", "--draft-mode", "model",
        "--draft-exit", "2", "--mesh", "off"])
    apply_flags(args)
    assert {env: os.environ.get(env) for env in _ENV_FLAGS.values()} == {
        "LAMBDIPY_PREFIX_CACHE_MB": "0.0", "LAMBDIPY_PREFIX_BLOCK": "16",
        "LAMBDIPY_SESSION_PIN_BUDGET_MB": "8.0",
        "LAMBDIPY_SESSION_TTL_S": "120.0", "LAMBDIPY_PIPELINE_DEPTH": "1",
        "LAMBDIPY_ENGINE_WATCHDOG_S": "3.0", "LAMBDIPY_KV_PAGED": "1",
        "LAMBDIPY_KV_PAGES": "12", "LAMBDIPY_MAX_LOGICAL_CTX": "1024",
        "LAMBDIPY_KV_OFFLOAD": "0", "LAMBDIPY_KV_OFFLOAD_MB": "64.0",
        "LAMBDIPY_LONG_PREFILL": "1", "LAMBDIPY_PREFILL_MODE": "chunked",
        "LAMBDIPY_SPEC_K": "4", "LAMBDIPY_DRAFT_MODE": "model",
        "LAMBDIPY_DRAFT_EXIT": "2", "LAMBDIPY_MESH": "off"}


@pytest.mark.parametrize("flags,match", [
    (["--mesh", "2x2"], r"dp axis .* item 3 \(c2\)"),
    (["--prefill-mode", "sp"], "does not have yet")])
def test_cli_refuses_unported_flags_before_boot(monkeypatch, flags, match):
    """``--mesh tp=2`` serves; a mesh with a ``dp`` axis (ROADMAP queue 1,
    item 3 (c2)) and ``--prefill-mode sp`` exit before boot, setting
    nothing."""
    _clear(monkeypatch)
    with pytest.raises(SystemExit, match=match):
        apply_flags(parser().parse_args(["serve", "b", *flags]))
    assert os.environ.get("LAMBDIPY_MESH") is None
