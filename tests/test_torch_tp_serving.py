"""Tensor-parallel serving over two gloo ranks on the CPU, the twins of
``tests/test_mesh_serving.py`` (the engine's mesh stats, the handler's
mesh knob), ``tests/test_sampling.py:343``, ``tests/test_continuous.py:425``,
``tests/test_models.py:103`` and ``tests/test_e2e.py:136``, with the f32
``llama-tiny`` on JAX's weights.

The port runs one process per device: the controller (this test
process) starts its follower with the server
(``parallel/tpserve.py start_ranks``, a ``file://`` store in a
temporary directory), and one two-rank group serves most cases. JAX's
tp=2 runs on two of its virtual CPU devices.

Tolerances: greedy tokens equal, bitwise (tp=2 against tp=1 and against
JAX's tp=2); engine rows' tokens bitwise the tp=2 solo rows', their
logprobs within ``LOGIT_TOL`` (as ``tests/test_torch_continuous.py``
holds them: the CPU's plain matmul rounds a row by the batch it shares,
~2e-6 measured at tp=1 and tp=2 alike; on the card, whose kernels keep a
row's bits, ``chip_smoke.py`` path S holds them bitwise); the logits
within ``LOGIT_TOL`` of tp=1 (f32 partial sums added in another order,
measured ~1e-6) and within JAX's own tp-forward tolerance (``rtol = atol
= 2e-3``) of JAX's."""

import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from lambdipy_tpu.models import registry as jreg
from lambdipy_tpu.parallel.mesh import make_mesh as jax_make_mesh
from lambdipy_tpu.parallel.mesh import use_mesh as jax_use_mesh
from lambdipy_tpu.parallel.sharding import shard_params as jax_shard_params
from lambdipy_tpu.runtime.continuous import \
    ContinuousBatcher as JaxBatcher
from lambdipy_tpu.runtime.metrics import MeshStats as JaxMeshStats
from lambdipy_tpu_torch.models import llama as tl
from lambdipy_tpu_torch.models import registry as treg
from lambdipy_tpu_torch.models.params import from_jax_params
from lambdipy_tpu_torch.parallel.tpserve import TensorParallelError
from lambdipy_tpu_torch.runtime.batching import MicroBatcher
from lambdipy_tpu_torch.runtime.continuous import ContinuousBatcher
from lambdipy_tpu_torch.runtime.handlers import (HandlerContext,
                                                 generate_handler)
from lambdipy_tpu_torch.runtime.pagepool import PagePool

ROOT = Path(__file__).resolve().parents[1]
PROMPTS = ([1, 2, 3], [9, 8, 7, 6], [5, 6, 7, 8], [11, 3, 250, 8, 41])
LOGIT_TOL = 1e-5
# a killed follower fails the controller's next request within this
KILL_BOUND_S = 30.0


def _tiny(**extra):
    return treg.get("llama-tiny").build(extra=extra or None)


@pytest.fixture(scope="module")
def jax_side(cpu_devices):
    """JAX's tp=2 server on its weights, and the weights for the port."""
    adapter = jreg.get("llama-tiny").build()
    params = adapter.init_params(seed=0)
    mesh = jax_make_mesh({"tp": 2}, devices=cpu_devices[:2])
    with jax_use_mesh(mesh):
        sharded = jax_shard_params(params, mesh, adapter.tp_rules)
    return SimpleNamespace(
        adapter=adapter, params=params,
        server=adapter.make_server(sharded, mesh=mesh),
        weights=from_jax_params(jax.tree_util.tree_map(np.asarray, params)))


@pytest.fixture(scope="module")
def ranks(jax_side):
    """The port's tp=2 server (this process and one follower) and its
    tp=1 server, on JAX's weights."""
    tp2 = _tiny().make_server(jax_side.weights, device="cpu",
                              mesh={"tp": 2})
    tp2.dispatcher.track()  # the ranks' token digests, for _agree
    tp1 = _tiny().make_server(jax_side.weights, device="cpu")
    yield SimpleNamespace(tp2=tp2, tp1=tp1)
    tp2.dispatcher.close()
    assert all(p.poll() is not None for p in tp2.dispatcher.procs)


def _agree(server):
    digests = server.dispatcher.agree()
    assert len(set(digests)) == 1, digests


# -- the server (tests/test_sampling.py:343, tests/test_models.py:103) -------


def test_tp2_generate_is_tp1s_and_jaxs_tp2(ranks, jax_side):
    """Greedy tokens at tp=2 equal tp=1's and JAX's tp=2, bitwise, for one
    row and a ragged batch; the ranks produced the same tokens."""
    assert ranks.tp2.sharded and ranks.tp2.mesh.shape == {"tp": 2}
    assert ranks.tp2.model.cfg.heads == 2 and ranks.tp2.graph_type is None
    for prompt in PROMPTS:
        want = np.asarray(jax_side.server.generate(prompt,
                                                   max_new_tokens=6))
        np.testing.assert_array_equal(
            ranks.tp2.generate(prompt, max_new_tokens=6), want)
        np.testing.assert_array_equal(
            ranks.tp1.generate(prompt, max_new_tokens=6), want)
    batch = [PROMPTS[0], PROMPTS[3]]
    np.testing.assert_array_equal(
        ranks.tp2.generate(batch, max_new_tokens=5),
        ranks.tp1.generate(batch, max_new_tokens=5))
    _agree(ranks.tp2)


def test_tp2_sampled_tokens_repeat_and_the_ranks_agree(ranks):
    """Sampled rows (per-row knobs, eos) are the same twice at tp=2, equal
    to tp=1's, and every rank drew the same tokens."""
    kw = dict(max_new_tokens=8, temperature=[0.8, 1.1], top_k=[0, 40],
              top_p=[0.9, None], seed=[3, 4], return_logprobs=True)
    batch = [PROMPTS[1], PROMPTS[2]]
    a, b = (ranks.tp2.generate(batch, **kw) for _ in range(2))
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    ref = ranks.tp1.generate(batch, **kw)
    np.testing.assert_array_equal(a[0], ref[0])
    np.testing.assert_allclose(a[1], ref[1], rtol=0, atol=LOGIT_TOL)
    _agree(ranks.tp2)


def test_tp2_forward_matches_one_device_and_jaxs(ranks, jax_side):
    """The tp=2 forward's logits (every position) within ``LOGIT_TOL`` of
    tp=1's, and within JAX's tp-forward tolerance of JAX's unsharded
    forward (``tests/test_models.py:103``)."""
    tokens = np.random.default_rng(2).integers(0, 500, (2, 8))
    got = ranks.tp2.prefill_logits(tokens)
    np.testing.assert_allclose(got, ranks.tp1.prefill_logits(tokens),
                               rtol=0, atol=LOGIT_TOL)
    ref = np.asarray(jax_side.adapter.forward(jax_side.params, tokens))
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)


def test_a_stream_at_tp2_is_its_generate(ranks):
    """``generate_stream`` at tp=2: its chunks concatenate to
    ``generate``'s row and end at the segment after eos, as tp=1's
    stream. It streams for real: the first chunk comes after two
    dispatched calls (the prefill and one segment), each later chunk after
    one more; a consumer that leaves mid-stream closes it on every rank,
    with one call and no more decoding, and the group serves on."""
    server = ranks.tp2
    disp = server.dispatcher
    full = server.generate(PROMPTS[0], max_new_tokens=12)
    stream = server.generate_stream(PROMPTS[0], max_new_tokens=12,
                                    segment=4)
    n0 = disp.commands
    chunks = [next(stream)]
    assert disp.commands - n0 == 2
    for chunk in stream:
        chunks.append(chunk)
    # three segments, then the close
    assert disp.commands - n0 == 2 + 2 + 1
    np.testing.assert_array_equal(np.concatenate(chunks, 1), full)
    eos = int(full[0, 5])
    kw = dict(max_new_tokens=12, segment=4, eos_id=eos)
    got = list(server.generate_stream(PROMPTS[0], **kw))
    want = list(ranks.tp1.generate_stream(PROMPTS[0], **kw))
    assert [c.tolist() for c in got] == [c.tolist() for c in want]
    left = server.generate_stream(PROMPTS[1], max_new_tokens=12, segment=4,
                                  return_logprobs=True)
    first = next(left)
    n0 = disp.commands
    left.close()
    assert disp.commands - n0 == 1
    ref = ranks.tp1.generate(PROMPTS[1], max_new_tokens=12,
                             return_logprobs=True)
    np.testing.assert_array_equal(first[0], ref[0][:, :4])
    np.testing.assert_allclose(first[1], ref[1][:, :4], rtol=0,
                               atol=LOGIT_TOL)
    np.testing.assert_array_equal(
        server.generate(PROMPTS[1], max_new_tokens=12), ref[0])
    assert not server.programs._busy  # every stream checked its entry in


# -- the engine (tests/test_continuous.py:425, test_mesh_serving.py:243) -----


def _pool(server, slots, cache_len=128, page=32):
    cfg = server.model.cfg
    return PagePool(n_pages=slots * (cache_len // page) + 1, page=page,
                    page_bytes=tl.page_kv_bytes(tl.whole_config(cfg), page),
                    make_arena=lambda: tl.init_page_arena(
                        cfg, slots * (cache_len // page) + 1, page,
                        server.device),
                    window_pages=cache_len // page)


def _burst(cb, rows):
    with ThreadPoolExecutor(max_workers=len(rows)) as ex:
        futs = [ex.submit(cb.generate, p, return_logprobs=True, **kw)
                for p, kw in rows]
        return [f.result() for f in futs]


ROWS = [(PROMPTS[0], {"max_new_tokens": 8}),
        (PROMPTS[1], {"max_new_tokens": 8}),
        (PROMPTS[2], {"max_new_tokens": 11, "temperature": 0.8, "seed": 5}),
        (PROMPTS[3], {"max_new_tokens": 6, "temperature": 1.2, "top_k": 30,
                      "seed": 9})]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("depth", [1, 2])
def test_tp2_engine_rows_are_its_solo_rows(ranks, jax_side, paged, depth):
    """Four concurrent rows (greedy and sampled) through a 2-slot engine
    over the tp=2 server, dense and paged, at pipeline depths 1 and 2:
    each row's tokens bitwise its tp=2 solo row's (logprobs within
    ``LOGIT_TOL``); the greedy rows are JAX's tp=2 engine's rows (at
    dense depth 2, the JAX engine's own setting; JAX holds its engine rows
    equal to its solo rows, ``tests/test_continuous.py:425``, which the
    other cases compare with); segments carried several rows."""
    server = ranks.tp2
    cb = ContinuousBatcher(server, slots=2, segment=4, pipeline_depth=depth,
                           page_pool=_pool(server, 2) if paged else None)
    got = _burst(cb, ROWS)
    for (prompt, kw), (toks, lps) in zip(ROWS, got):
        want = server.generate(prompt, return_logprobs=True, **kw)
        np.testing.assert_array_equal(toks, want[0])
        np.testing.assert_allclose(lps, want[1], rtol=0, atol=LOGIT_TOL)
    jcb = (JaxBatcher(jax_side.server, slots=2, segment=4)
           if depth == 2 and not paged else jax_side.server)
    for (prompt, kw), (toks, _) in zip(ROWS[:2], got):
        np.testing.assert_array_equal(toks, np.asarray(
            jcb.generate(prompt, **kw)))
    stats = cb.stats()
    assert stats["rows_in_segments"] > stats["segments_run"], stats
    assert stats["pipeline_depth"] == depth
    _agree(server)


def test_tp2_engine_mesh_stats_surface(ranks):
    """``batching.mesh`` has JAX's keys; the live KV gauge reads half per
    device, and so do the params; the analytic count is ``segment * (2 *
    layers + 2)``; an unsharded engine publishes no mesh block."""
    server = ranks.tp2
    for pool in (None, _pool(server, 2)):
        cb = ContinuousBatcher(server, slots=2, segment=4, page_pool=pool)
        np.testing.assert_array_equal(
            cb.generate([1, 2, 3], max_new_tokens=6),
            ranks.tp1.generate([1, 2, 3], max_new_tokens=6))
        mb = cb.stats()["mesh"]
        assert set(mb) == set(JaxMeshStats().report())
        assert mb["shape"] == {"tp": 2} and mb["devices"] == 2
        assert mb["segments_sharded"] > 0
        assert 0 < mb["kv_bytes_per_device"] \
            <= 0.55 * mb["kv_bytes_replicated"]
        assert 0 < mb["param_bytes_per_device"] \
            <= 0.55 * mb["param_bytes_total"]
        assert mb["collectives_per_segment"] == 4 * (2 * 2 + 2)
    assert "mesh" not in ContinuousBatcher(
        ranks.tp1, slots=2, segment=4).stats()


def test_window_bucketing_and_the_microbatcher_run_through_it(ranks,
                                                              jax_side):
    """Window bucketing (the plain attention's narrowed views, a tp=2
    server of its own under ``attn_backend="dense"``) and the
    MicroBatcher go through the dispatcher unchanged: rows equal the
    tp=1 server's."""
    dense2 = _tiny(attn_backend="dense").make_server(
        jax_side.weights, device="cpu", mesh={"tp": 2})
    dense1 = _tiny(attn_backend="dense").make_server(jax_side.weights,
                                                     device="cpu")
    try:
        for pool in (None, _pool(dense2, 2)):
            cb = ContinuousBatcher(dense2, slots=2, segment=4,
                                   page_pool=pool)
            got = _burst(cb, ROWS[:3])
            for (prompt, kw), (toks, _) in zip(ROWS[:3], got):
                np.testing.assert_array_equal(
                    toks, dense1.generate(prompt, **kw))
            assert cb.stats()["decode_window"]["savings_ratio"] > 0
    finally:
        dense2.dispatcher.close()
    micro = MicroBatcher(ranks.tp2, window_ms=50.0, max_batch=4)
    with ThreadPoolExecutor(max_workers=3) as ex:
        futs = [ex.submit(micro.generate, p, max_new_tokens=6)
                for p in PROMPTS[:3]]
        for prompt, f in zip(PROMPTS, futs):
            np.testing.assert_array_equal(
                f.result(), ranks.tp1.generate(prompt, max_new_tokens=6))


def test_c2_features_raise_at_tp2(ranks, jax_side):
    """What this slice does not carry at tp > 1 raises, naming ROADMAP
    queue 1, item 3 (c2); the group serves on after each."""
    server, c2 = ranks.tp2, r"item 3 \(c2\)"
    with pytest.raises(NotImplementedError, match=c2):
        server.generate([4, 5], prefix=[1, 2, 3], max_new_tokens=4)
    with pytest.raises(NotImplementedError, match=c2):
        server.cache_prefix([1, 2, 3])
    with pytest.raises(NotImplementedError, match=c2):
        server.generate_speculative([1, 2, 3], max_new_tokens=4)
    with pytest.raises(NotImplementedError, match=c2):
        list(server.generate_speculative_stream([1, 2, 3],
                                                max_new_tokens=4))
    for kw in ({"spec_k": 4}, {"max_logical_ctx": 512,
                               "page_pool": _pool(server, 2)}):
        with pytest.raises(NotImplementedError, match=c2):
            ContinuousBatcher(server, slots=2, segment=4, **kw)
    cb = ContinuousBatcher(server, slots=2, segment=4)
    with pytest.raises(NotImplementedError, match=c2):
        cb.warm_group_prefill()
    with pytest.raises(NotImplementedError, match=c2):
        cb.generate([4, 5], prefix=[1, 2, 3], max_new_tokens=4)
    with pytest.raises(NotImplementedError, match=c2):
        _tiny().make_server(jax_side.weights, device="cpu", mesh={"tp": 2},
                            prefill_chunk=32)
    np.testing.assert_array_equal(
        server.generate([1, 2, 3], max_new_tokens=4),
        ranks.tp1.generate([1, 2, 3], max_new_tokens=4))


def test_a_killed_follower_fails_the_next_request(jax_side):
    """A follower killed between requests: the next solo request and the
    next engine request fail with an error within ``KILL_BOUND_S``, no
    hang; every later call fails at once; closing leaves no process."""
    server = _tiny().make_server(jax_side.weights, device="cpu",
                                 mesh={"tp": 2})
    disp = server.dispatcher
    try:
        cb = ContinuousBatcher(server, slots=2, segment=4, max_replays=1)
        assert cb.generate([1, 2, 3], max_new_tokens=4).shape == (1, 4)
        disp.procs[0].kill()
        disp.procs[0].wait()
        t0 = time.monotonic()
        with pytest.raises(TensorParallelError):
            server.generate([1, 2, 3], max_new_tokens=4)
        with pytest.raises(TensorParallelError):
            cb.generate([4, 5, 6], max_new_tokens=4)
        assert time.monotonic() - t0 < KILL_BOUND_S
        assert sum(cb.stats()["faults"]["failures"].values()) >= 1
        assert disp.stats()["broken"]
    finally:
        disp.close()
    assert all(p.poll() is not None for p in disp.procs)


def test_a_killed_follower_turns_healthz_wedged(jax_side, monkeypatch):
    """A tp=2 engine handler behind the bundle server: ``/healthz`` reads
    ready until its follower is killed, then ``wedged`` (``ready`` false,
    the group's ``exited`` naming rank 1) before any request fails, so a
    fleet routes around it; the next request fails within
    ``KILL_BOUND_S``, and ``/metrics`` shows the group broken."""
    from lambdipy_tpu_torch.runtime.server import BundleServer

    monkeypatch.setenv("LAMBDIPY_MESH", "tp=2")
    state = generate_handler(
        {"model": "llama-tiny", "dtype": "float32", "extra": SPEC_EXTRA},
        HandlerContext(device="cpu", state_dict=jax_side.weights))
    disp = state.server.dispatcher
    srv = BundleServer(state, port=0).start_background()

    def get(path):
        with urllib.request.urlopen(srv.url + path, timeout=60) as r:
            return json.loads(r.read())

    try:
        assert _post(srv.url + "/invoke", {"tokens": [1, 2, 3]})["ok"]
        health = get("/healthz")
        assert health["ready"] and not health["wedged"]
        assert health["engine"]["tp_group"]["ok"]
        disp.procs[0].kill()
        disp.procs[0].wait()
        health = get("/healthz")
        assert health["wedged"] and not health["ready"]
        assert health["engine"]["tp_group"]["exited"] == [1]
        t0 = time.monotonic()
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(srv.url + "/invoke", {"tokens": [4, 5, 6]})
        assert time.monotonic() - t0 < KILL_BOUND_S
        assert err.value.code == 500
        group = get("/metrics")["handler"]["batching"]["mesh"]["group"]
        assert group["broken"] and not group["ok"]
    finally:
        srv.stop()
    assert all(p.poll() is not None for p in disp.procs)


# -- the handler (tests/test_mesh_serving.py:261) ----------------------------


SPEC_EXTRA = {"batch_mode": "continuous", "batch_max": "2",
              "batch_segment": "4", "max_new_tokens": "6",
              "prefix_cache_mb": "0", "warm_group_prefill": "0"}


def test_handler_mesh_knob_end_to_end(jax_side, monkeypatch):
    """``LAMBDIPY_MESH=tp=2`` builds a sharded engine handler: ``meta``
    says so, ``batching.mesh`` rides ``/metrics``, and the tokens equal
    the unsharded handler's and JAX's sharded one's. An explicit extra
    wins over the variable and ``off`` replaces a spec-level mesh; a tp
    the kv heads do not divide raises JAX's error; the default prefix
    store and the warm raise, naming (c2). The JAX side: its tp=2
    server's greedy row, what its handler serves."""
    ctx = HandlerContext(device="cpu", state_dict=jax_side.weights)
    spec = {"model": "llama-tiny", "dtype": "float32", "extra": SPEC_EXTRA}
    monkeypatch.delenv("LAMBDIPY_MESH", raising=False)
    plain = generate_handler(dict(spec), ctx)
    assert plain.meta["sharded"] is False and plain.meta["mesh"] is None
    body = {"tokens": [1, 2, 3], "temperature": 0.7, "seed": 2}
    ref = plain.invoke(dict(body))
    monkeypatch.setenv("LAMBDIPY_MESH", "tp=2")
    sharded = generate_handler(dict(spec), ctx)
    try:
        assert sharded.meta["sharded"] is True
        assert sharded.meta["mesh"] == {"tp": 2}
        out = sharded.invoke(dict(body))
        assert out["ok"] and out["tokens"] == ref["tokens"]
        greedy = sharded.invoke({"tokens": [1, 2, 3]})
        assert greedy["tokens"] == np.asarray(jax_side.server.generate(
            [1, 2, 3], max_new_tokens=6)).tolist()
        stats = sharded.stats()
        block = stats["batching"]["mesh"]
        assert block["shape"] == {"tp": 2} and block["group"]["ok"]
        assert 0 < block["kv_bytes_per_device"] \
            <= 0.55 * block["kv_bytes_replicated"]
        # eager at tp > 1: every engine step ran eagerly, none replayed
        batching = stats["batching"]
        assert stats["replays"] == batching["replays"] == 0
        assert batching["eager_steps"] == batching["steps"] > 0
    finally:
        sharded.close()
    assert all(p.poll() is not None
               for p in sharded.server.dispatcher.procs)
    monkeypatch.setenv("LAMBDIPY_MESH", "tp=4")  # would not divide kv
    off = generate_handler({**spec, "mesh": {"tp": 2},
                            "extra": {**SPEC_EXTRA, "mesh": "off"}}, ctx)
    assert off.meta["sharded"] is False
    with pytest.raises(ValueError, match="kv_heads=2"):
        generate_handler(dict(spec), ctx)
    monkeypatch.setenv("LAMBDIPY_MESH", "tp=2")
    for drop in ("prefix_cache_mb", "warm_group_prefill"):
        extra = {k: v for k, v in SPEC_EXTRA.items() if k != drop}
        with pytest.raises(ValueError, match=r"item 3 \(c2\)"):
            generate_handler({**spec, "extra": extra}, ctx)


# -- the CLI and a bundle (tests/test_e2e.py:136) -----------------------------


def _children(pid: int) -> list[int]:
    path = Path(f"/proc/{pid}/task/{pid}/children")
    return [int(p) for p in path.read_text().split()] if path.exists() \
        else []


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    stat = Path(f"/proc/{pid}/stat")
    return stat.exists() and stat.read_text().split()[2] != "Z"


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_serve_mesh_tp2_on_the_cpu(tmp_path):
    """``serve llama-tiny --mesh tp=2 --device cpu``: its follower is a
    child process; it answers with the unsharded server's tokens, its
    ``/metrics`` and ``/healthz`` say sharded, and ``POST /shutdown``
    stops it and its follower."""
    err = open(tmp_path / "stderr.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "lambdipy_tpu_torch", "serve", "llama-tiny",
         "--mesh", "tp=2", "--device", "cpu", "--port", "0", "--extra",
         "prefix_cache_mb=0,max_new_tokens=6"], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=err, text=True,
        env={**os.environ, "LAMBDIPY_LOG_LEVEL": "WARNING"})
    err.close()
    try:
        line = proc.stdout.readline()
        assert line, (tmp_path / "stderr.log").read_text()[-3000:]
        base = f"http://127.0.0.1:{json.loads(line)['port']}"
        followers = _children(proc.pid)
        assert len(followers) == 1
        out = _post(f"{base}/invoke", {"tokens": [1, 2, 3]})
        want = _tiny().make_server(None, device="cpu").generate(
            [1, 2, 3], max_new_tokens=6)
        assert out["tokens"] == want.tolist()
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            meta = json.loads(r.read())["handler_meta"]
        assert meta["sharded"] is True and meta["mesh"] == {"tp": 2}
        _post(f"{base}/shutdown", {})
        assert proc.wait(timeout=60) == 0
        deadline = time.monotonic() + 30
        while any(_alive(p) for p in followers) \
                and time.monotonic() < deadline:
            time.sleep(0.1)
        assert not any(_alive(p) for p in followers)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_a_payload_mesh_tp2_bundle_builds_and_deploys(tmp_path,
                                                      monkeypatch):
    """``tests/test_e2e.py:136``'s recipe through the port's CLI:
    ``[payload.mesh] tp = 2``, int8 ``llama-tiny``, plus
    ``prefix_cache_mb = 0`` (JAX's default 512 MB store is item 3 (c2)
    here). Deployed on the CPU it serves sharded, with the tokens of the
    same bundle served unsharded (``LAMBDIPY_MESH=off``); stopping the
    deployment leaves no process of its group."""
    from lambdipy_tpu_torch import __main__ as cli
    from lambdipy_tpu_torch.runtime import deploy
    from lambdipy_tpu_torch.runtime.loader import load_bundle

    monkeypatch.delenv("LAMBDIPY_MESH", raising=False)
    recipes = tmp_path / "recipes"
    recipes.mkdir()
    (recipes / "e2e-llama-tp.toml").write_text('''
schema = 1
name = "e2e-llama-tp"
version = "0.1"
device = "any"
base_layer = "torch"
requires = []

[payload]
model = "llama-tiny"
handler = "lambdipy_tpu_torch.runtime.handlers:generate_handler"
params = "init"
dtype = "float32"
quant = "int8"
batch_size = 1

[payload.mesh]
dp = 1
tp = 2

[payload.extra]
max_new_tokens = 4
prefix_cache_mb = 0
''')
    out = tmp_path / "bundle"
    assert cli.main(["build", "e2e-llama-tp", "--recipe-dir", str(recipes),
                     "--out", str(out), "--no-smoke", "--no-warm"]) == 0
    rt = deploy.LocalRuntime(tmp_path / "deployments.json")
    dep = rt.deploy("ll1", out, device="cpu")
    body = {"tokens": [1, 2, 3], "max_new_tokens": 4}
    try:
        got = rt.invoke("ll1", dict(body))
        meta = rt.health("ll1")["handler_meta"]
    finally:
        rt.stop("ll1")
    assert not deploy._group_alive(dep.pid)
    assert got["n_new"] >= 4 and got["tokens"]
    assert meta["sharded"] is True and meta["quant"] == "int8"
    monkeypatch.setenv("LAMBDIPY_MESH", "off")
    report = load_bundle(out, device="cpu")
    assert report.state.meta["sharded"] is False
    assert report.state.invoke(dict(body))["tokens"] == got["tokens"]
