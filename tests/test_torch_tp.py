"""Tensor-parallel serving's host-side pieces in one process, against the
JAX package where it has a twin (``tests/test_mesh_serving.py``,
``tests/test_metrics.py``): the serving-mesh validation and its
messages, a rank's share of the config, the KV cache and the arena with
their per-device bytes, ``concat_cache_blocks`` under an ambient tp
mesh, ``MeshStats`` field for field, the one-device mesh and the
one-rank group served bitwise as no mesh, the handler's degrade on too
few cards and the CLI's ``--mesh``. The multi-rank twins are in
``tests/test_torch_tp_serving.py``."""

import dataclasses
import os
import threading

import jax
import numpy as np
import pytest
import torch

from lambdipy_tpu.models import registry as jreg
from lambdipy_tpu.models.llama import \
    validate_serving_mesh as jax_validate_serving_mesh
from lambdipy_tpu.parallel.mesh import make_mesh as jax_make_mesh
from lambdipy_tpu.runtime.metrics import MeshStats as JaxMeshStats
from lambdipy_tpu_torch.models import llama as tl
from lambdipy_tpu_torch.models import registry as treg
from lambdipy_tpu_torch.models.params import from_jax_params
from lambdipy_tpu_torch.parallel import distributed as tdist
from lambdipy_tpu_torch.parallel.mesh import (make_mesh, serving_mesh,
                                              use_mesh)
from lambdipy_tpu_torch.parallel.sharding import device_bytes
from lambdipy_tpu_torch.runtime import handlers
from lambdipy_tpu_torch.runtime.continuous import ContinuousBatcher
from lambdipy_tpu_torch.runtime.metrics import MeshStats


@pytest.fixture(scope="module")
def weights():
    adapter = jreg.get("llama-tiny").build()
    return from_jax_params(jax.tree_util.tree_map(
        np.asarray, adapter.init_params(seed=0)))


def _tiny():
    return treg.get("llama-tiny").build()


# -- validation --------------------------------------------------------------


@pytest.mark.parametrize("cfg_kw,tp,match", [
    ({}, 4, "kv_heads=2"),
    ({"vocab_size": 64, "hidden": 60, "layers": 1, "heads": 3,
      "kv_heads": 3, "mlp": 64, "max_len": 32}, 2, "heads=3"),
    ({"mlp": 130}, 4, "mlp=130"),
], ids=["kv-heads", "odd-heads", "mlp"])
def test_validate_serving_mesh_raises_jaxs_errors(cpu_devices, cfg_kw, tp,
                                                  match):
    """The port's message is JAX's, word for word (``llama-tiny``: heads
    4, kv_heads 2)."""
    from lambdipy_tpu.models.llama import LLAMA_TINY as JT

    jcfg = dataclasses.replace(JT, **cfg_kw)
    tcfg = dataclasses.replace(tl.LLAMA_TINY, **cfg_kw)
    with pytest.raises(ValueError) as je:
        jax_validate_serving_mesh(
            jcfg, jax_make_mesh({"tp": tp}, devices=cpu_devices[:tp]))
    with pytest.raises(ValueError, match=match) as te:
        tl.validate_serving_mesh(tcfg, {"tp": tp})
    assert str(te.value) == str(je.value)
    tl.validate_serving_mesh(tcfg, {"tp": 1})


def test_make_server_refuses_before_it_starts_a_rank(weights):
    """``make_server(mesh=)`` checks before any process starts: JAX's
    ``kv_heads`` error at tp=4, a ``dp`` axis and an MoE Llama naming
    ROADMAP queue 1, item 3 (c2)."""
    with pytest.raises(ValueError, match="kv_heads"):
        _tiny().make_server(weights, device="cpu", mesh={"tp": 4})
    with pytest.raises(NotImplementedError, match=r"dp axis .* \(c2\)"):
        _tiny().make_server(weights, device="cpu",
                            mesh={"dp": 2, "tp": 2})
    with pytest.raises(NotImplementedError, match=r"MoE .* \(c2\)"):
        treg.get("llama-moe-tiny").build().make_server(
            None, device="cpu", mesh={"tp": 2})


@pytest.mark.parametrize("shape,error,match", [
    ({"tp": 2}, None, None),
    ({"tp": 1, "dp": 1}, None, None),
    ({"dp": 2, "tp": 2}, NotImplementedError, r"item 3 \(c2\)"),
    ({"sp": 2}, NotImplementedError, r"item 3 \(e\)"),
    ({"ep": 2}, NotImplementedError, r"item 3 \(d\)"),
    ({"pp": 2}, NotImplementedError, r"item 3 \(f\)"),
    ({"tq": 2}, ValueError, "unknown mesh axes"),
], ids=["tp", "ones", "dp", "sp", "ep", "pp", "unknown"])
def test_serving_mesh_takes_tp_alone(shape, error, match):
    if error is None:
        assert serving_mesh(shape) == {a: n for a, n in shape.items()
                                       if n > 1}
        return
    with pytest.raises(error, match=match):
        serving_mesh(shape)


def test_a_ranks_share_of_the_config():
    """``shard_config`` splits heads, kv heads, the MLP and the
    vocabulary; the head width stays the whole model's, and
    ``whole_config`` gives the config back."""
    cfg = tl.LLAMA3_8B
    share = tl.shard_config(cfg, 2)
    assert (share.heads, share.kv_heads, share.mlp, share.vocab_size) == \
        (16, 4, 7168, 64128)
    assert share.head_dim == cfg.head_dim == 128
    assert tl.whole_config(share) == cfg
    assert tl.shard_config(cfg, 1) is cfg and tl.whole_config(cfg) is cfg
    with pytest.raises(ValueError, match="vocab_size=513"):
        tl.shard_config(dataclasses.replace(tl.LLAMA_TINY, vocab_size=513),
                        2)


# -- cache placement (tests/test_mesh_serving.py:158-218) --------------------


def test_shard_kv_cache_halves_per_device_bytes():
    cfg = tl.LLAMA_TINY
    mesh = make_mesh({"tp": 2}, devices=[0, 1])
    cache = tl.init_decode_cache(cfg, 2, cfg.max_len, "cpu")
    for e in cache:
        e["k"].normal_()
    shares = [tl.shard_kv_cache(cache, mesh, rank=r) for r in (0, 1)]
    kv_only = [{n: v for n, v in e.items() if n != "index"}
               for e in shares[0]]
    per, total = device_bytes(kv_only, tl.kv_shardings(mesh))
    assert per == total // 2, (per, total)
    # index leaves whole (host-global positions)
    idx_per, idx_total = device_bytes([e["index"] for e in shares[0]],
                                      tl.kv_shardings(mesh))
    assert idx_per == idx_total
    # values untouched: the shares are the whole's kv-head halves
    torch.testing.assert_close(
        torch.cat([shares[0][0]["k"], shares[1][0]["k"]], dim=2),
        cache[0]["k"], rtol=0, atol=0)
    # a mesh without tp places the whole cache
    assert tl.shard_kv_cache(cache, make_mesh({}, devices=[0]),
                             rank=0)[0]["k"] is cache[0]["k"]


def test_shard_page_arena_halves_per_device_bytes():
    cfg = tl.LLAMA_TINY
    mesh = make_mesh({"tp": 2}, devices=[0, 1])
    arena = tl.init_page_arena(cfg, 5, 16, "cpu", mesh=mesh)
    assert arena[0]["k"].shape == (5, 16, 1, cfg.head_dim)
    per, total = device_bytes(arena, tl.kv_shardings(mesh))
    assert per == total // 2, (per, total)
    whole = tl.init_page_arena(cfg, 5, 16, "cpu")
    assert total == device_bytes(whole)[0]
    assert tl.shard_page_arena(whole, mesh, rank=1)[0]["v"].shape == \
        arena[0]["v"].shape
    # the pool's accounting is mesh-agnostic: a page is the whole's
    assert tl.page_kv_bytes(tl.whole_config(tl.shard_config(cfg, 2)),
                            16) == tl.page_kv_bytes(cfg, 16)


def test_concat_cache_blocks_preserves_tp_sharding():
    cfg = tl.LLAMA_TINY
    mesh = make_mesh({"tp": 2}, devices=[0, 1])
    whole = tl.init_decode_cache(cfg, 1, cfg.max_len, "cpu")
    for e in whole:
        e["k"].uniform_()
        e["v"].uniform_()
    cache = tl.shard_kv_cache(whole, mesh, rank=1)
    with use_mesh(mesh):
        blocks = [tl.slice_cache_blocks(cache, p, 16) for p in (0, 16)]
        out = tl.concat_cache_blocks(cfg, blocks, cfg.max_len)
    kv_only = [{n: v for n, v in e.items() if n != "index"} for e in out]
    per, total = device_bytes(kv_only, tl.kv_shardings(mesh))
    assert per == total // 2, (per, total)
    assert out[0]["index"] == 32
    torch.testing.assert_close(out[1]["v"][:, :32], cache[1]["v"][:, :32],
                               rtol=0, atol=0)


# -- MeshStats (tests/test_metrics.py:135, :164) -----------------------------


def test_mesh_stats_is_jaxs_field_for_field():
    assert [f.name for f in dataclasses.fields(MeshStats)] == \
        [f.name for f in dataclasses.fields(JaxMeshStats)]
    reports = []
    for cls in (JaxMeshStats, MeshStats):
        st = cls()
        empty = st.report()
        st.set_layout(shape={"tp": 2}, devices=2,
                      collectives_per_segment=16 * (2 * 32 + 1))
        st.set_kv_bytes(512, 1024)
        st.set_param_bytes(300, 500)
        st.record_segment()
        st.record_segment(2)
        reports.append((empty, st.report()))
    assert reports[0] == reports[1]
    empty, rep = reports[1]
    assert empty["hbm_savings"] == empty["param_savings"] == 1.0
    assert (rep["hbm_savings"], rep["param_savings"],
            rep["segments_sharded"]) == (0.5, 0.6, 3)


def test_mesh_stats_concurrent():
    st = MeshStats()

    def write():
        for _ in range(200):
            st.record_segment()
            st.set_kv_bytes(1, 2)

    threads = [threading.Thread(target=write) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert st.report()["segments_sharded"] == 800


# -- no mesh, a one-device mesh, a one-rank group -----------------------------


def _serve(server):
    """Greedy and sampled solo rows, and rows through a paged engine."""
    out = [server.generate([5, 6, 7], max_new_tokens=6,
                           return_logprobs=True),
           server.generate([[1, 2], [9, 8, 7, 6]], max_new_tokens=5,
                           temperature=0.8, seed=3, return_logprobs=True)]
    from lambdipy_tpu_torch.runtime.pagepool import PagePool

    cfg = server.model.cfg
    pool = PagePool(n_pages=2 * 4 + 1, page=32,
                    page_bytes=tl.page_kv_bytes(cfg, 32),
                    make_arena=lambda: tl.init_page_arena(
                        cfg, 9, 32, server.device), window_pages=4)
    cb = ContinuousBatcher(server, slots=2, segment=4, page_pool=pool)
    out.append(cb.generate([3, 4, 5], max_new_tokens=7, temperature=0.5,
                           seed=1, return_logprobs=True))
    return cb, out


def _bitwise(a, b):
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)


def test_a_one_device_mesh_is_bitwise_no_mesh(weights):
    """``mesh={"tp": 1}``: JAX's degenerate mesh, served byte for byte as
    no mesh (tokens and logprobs, solo and engine); no ``batching.mesh``
    block, as an unsharded engine publishes none."""
    ref_cb, ref = _serve(_tiny().make_server(weights, device="cpu"))
    server = _tiny().make_server(weights, device="cpu", mesh={"tp": 1})
    assert server.mesh.size == 1 and server.dispatcher is None
    cb, out = _serve(server)
    _bitwise(out, ref)
    assert "mesh" not in cb.stats() and "mesh" not in ref_cb.stats()


def test_a_one_rank_group_is_bitwise_no_mesh(weights, tmp_path):
    """A one-rank tensor-parallel group (its store a file): the model's
    collectives are the identity, so a rank serves byte for byte as no
    group."""
    group = tdist.tp_group(f"file://{tmp_path}/store", 0, 1, device="cpu")
    try:
        assert group.pg is None and group.cmd is None
        server = _tiny().make_server(weights, device="cpu",
                                     mesh={"tp": 1}, group=group)
        assert server.model.tp is group and not server.sharded
        _, out = _serve(server)
    finally:
        group.close()
    _, ref = _serve(_tiny().make_server(weights, device="cpu"))
    _bitwise(out, ref)


def test_a_sharded_forward_outside_the_dispatcher_raises(weights):
    """A rank's forward whose collectives nothing would pair raises at
    once, before any collective."""
    cfg = tl.shard_config(tl.LLAMA_TINY, 2)
    model = _tiny().make_model(None, device="cpu")
    share = tl.LlamaModel(cfg, device="meta")
    share.set_tp(tdist.TPGroup(0, 2))
    share.to_empty(device="cpu")
    with pytest.raises(RuntimeError, match="outside the dispatcher"):
        share(torch.zeros(1, 3, dtype=torch.long))
    assert model.tp is None


# -- the handler and the CLI ---------------------------------------------------


def test_a_card_mesh_past_the_hosts_cards_degrades_loudly(monkeypatch,
                                                          capfd):
    """JAX's ``_maybe_shard`` rule and warning: a mesh of more cards than
    the host shows serves on one (``meta.sharded`` false), loudly."""
    monkeypatch.setattr(handlers, "resolve_device",
                        lambda device: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert handlers.serving_shape({"mesh": {"tp": 2}}, None) is None
    assert "SINGLE-DEVICE" in capfd.readouterr().err
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert handlers.serving_shape({"mesh": {"tp": 2, "dp": 1}}, None) == \
        {"tp": 2}
    assert handlers.serving_shape({"mesh": {"dp": 1}}, None) is None


@pytest.mark.parametrize("extra,env,want", [
    ({}, None, None), ({}, "tp=2", {"tp": 2}), ({"mesh": "2"}, "off",
                                               {"tp": 2}),
    ({"mesh": "off"}, "tp=2", {}), ({}, "off", {}),
], ids=["none", "env", "extra-wins", "extra-off", "env-off"])
def test_the_mesh_knob_resolves_as_jaxs(monkeypatch, extra, env, want):
    """The ``mesh`` extra wins over ``LAMBDIPY_MESH``; either replaces a
    spec-level ``[payload.mesh]``, ``off`` included."""
    monkeypatch.delenv("LAMBDIPY_MESH", raising=False)
    if env is not None:
        monkeypatch.setenv("LAMBDIPY_MESH", env)
    spec = {"model": "llama-tiny", "mesh": {"tp": 4}, "extra": extra}
    got = handlers.resolve_mesh(spec)
    assert got["mesh"] == (spec["mesh"] if want is None else want)


def test_serve_mesh_flag_is_jaxs_grammar(monkeypatch):
    from lambdipy_tpu_torch.__main__ import apply_flags, parser

    # recorded first, so that the variables apply_flags sets are undone
    monkeypatch.setenv("LAMBDIPY_MESH", "")
    for spec in ("tp=2", "2", "off"):
        apply_flags(parser().parse_args(["serve", "b", "--mesh", spec]))
        assert os.environ["LAMBDIPY_MESH"] == spec
    monkeypatch.delenv("LAMBDIPY_MESH")
    for bad, match in (("tq=2", "unknown mesh axis"),
                       ("2x2", r"\(c2\)")):
        with pytest.raises(SystemExit, match=match):
            apply_flags(parser().parse_args(["serve", "b", "--mesh", bad]))
        assert os.environ.get("LAMBDIPY_MESH") is None
    text = parser().format_help() + " ".join(
        a.help or "" for a in parser()._subparsers._group_actions[0]
        .choices["serve"]._actions if "--mesh" in a.option_strings)
    assert "tensor-parallel sharded serving" in text
