"""K/V shipping between prefix stores (``PrefixStore.export_blocks`` /
``import_blocks``, the streamed pair, ``runtime/kvwire.py`` frames) and
the server's ``/v1/kv/*`` routes, the twins of ``tests/test_kvship.py``
and ``tests/test_kvstream.py`` on ``llama-tiny`` (f32) on the CPU, dense
and paged: a frame the JAX store exported imports into the port's store,
and the port's routed greedy tokens equal its unrouted ones; a port frame
decodes in JAX's ``decode_frame`` and imports into the JAX store, whose
routed tokens equal its unrouted ones; a port export and import route
bitwise the exporter's run (tokens and logprobs, seeded), streamed
bitwise monolithic; a full arena answers the priced 503 ``kv_import``, a
truncated frame or stream a 400, and both leave the tree as it was."""

import http.client
import json
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from lambdipy_tpu.models import registry as jreg
from lambdipy_tpu.models.llama import init_page_arena as jinit_page_arena
from lambdipy_tpu.models.llama import page_kv_bytes as jpage_kv_bytes
from lambdipy_tpu.runtime import kvwire as jw
from lambdipy_tpu.runtime.pagepool import PagePool as JaxPagePool
from lambdipy_tpu.runtime.prefixstore import PrefixStore as JaxPrefixStore
from lambdipy_tpu_torch.models import registry as treg
from lambdipy_tpu_torch.models.params import from_jax_params
from lambdipy_tpu_torch.runtime import kvwire as tw
from lambdipy_tpu_torch.runtime.handlers import (HandlerContext,
                                                 generate_handler,
                                                 make_engine)
from lambdipy_tpu_torch.runtime.pagepool import PagesExhausted
from lambdipy_tpu_torch.runtime.prefixstore import PrefixStore
from lambdipy_tpu_torch.runtime.server import BundleServer

BLOCK = 16
EXTRA = {"attn_backend": "blocked"}
PAGED = {"batch_max": "4", "batch_segment": "4", "kv_paged": "1",
         "prefix_block": "16"}
SEEDED = {"temperature": 0.9, "seed": 7, "top_k": 5}
# f32 end to end across the frameworks (tests/test_torch_llama.py)
LOGIT_TOL = 1e-4
ROW = [int(t) for t in np.random.default_rng(5).integers(1, 500, size=70)]
HEAD = 64  # ROW's whole-block head: 4 blocks


@pytest.fixture(scope="module")
def weights():
    adapter = jreg.get("llama-tiny").build(extra=EXTRA)
    params = adapter.init_params(seed=0)
    return adapter, params, from_jax_params(
        jax.tree_util.tree_map(np.asarray, params))


@pytest.fixture(scope="module")
def jax_server(weights):
    return weights[0].make_server(weights[1])


def _server(weights):
    return treg.get("llama-tiny").build(extra=EXTRA).make_server(
        weights[2], device="cpu")


def _store(server, paged: bool, **engine_extra):
    """A port store, with a paged engine sharing its arena when paged."""
    if not paged:
        return PrefixStore(server, block=BLOCK, budget_mb=8), None
    engine = make_engine(server, {**PAGED, **engine_extra})
    store = PrefixStore(server, block=BLOCK, budget_mb=8, pool=engine.pool)
    engine.prefix_pages_fn = store.acquire_pages
    return store, engine


def _jax_store(server, paged: bool):
    pool = None
    if paged:
        cfg = server.model.cfg
        n_pages = 2 * (cfg.max_len // BLOCK) + 1
        pool = JaxPagePool(n_pages=n_pages, page=BLOCK,
                           page_bytes=jpage_kv_bytes(cfg, BLOCK),
                           make_arena=lambda: jinit_page_arena(cfg, n_pages,
                                                               BLOCK))
    return JaxPrefixStore(server, block=BLOCK, budget_mb=8, pool=pool)


def _routed(store, engine, server, row, **kw):
    """The store's routed run of ``row``: through the engine (paged) or
    the server's prefix path (dense)."""
    m = store.route(row)
    gen = engine.generate if engine is not None else server.generate
    return m, gen(row[m:], prefix=row[:m], max_new_tokens=8,
                  return_logprobs=True, **kw)


PAGED_IDS = pytest.mark.parametrize("paged", [False, True],
                                    ids=["dense", "paged"])


@PAGED_IDS
def test_jax_frame_imports_into_the_port_store(weights, jax_server, paged):
    """The JAX store's exported frame decodes in the port and imports into
    its store: the route hits every block without a walk, and the routed
    greedy tokens equal the port's unrouted ones (logprobs within the
    cross-framework f32 tolerance)."""
    jstore = _jax_store(jax_server, paged)
    head, blocks = jstore.export_blocks(ROW)
    frame = jw.encode_frame(head, BLOCK, blocks)
    server = _server(weights)
    store, engine = _store(server, paged)
    tokens, block, tblocks = tw.decode_frame(frame)
    assert (tokens, block) == (head, BLOCK) and len(head) == HEAD
    res = store.import_blocks(tokens, tblocks)
    assert res == {"present": 0, "inserted": 4,
                   "mode": "paged" if paged else "dense"}
    m, got = _routed(store, engine, server, ROW)
    assert m == HEAD and store.prefill_stats.report()["rounds"] == 0
    want = server.generate(ROW, max_new_tokens=8, return_logprobs=True)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], atol=LOGIT_TOL)
    assert store.check_invariants()["ok"]


@PAGED_IDS
def test_port_frame_imports_into_the_jax_store(weights, jax_server, paged):
    """The port's exported frame decodes in JAX's ``decode_frame`` and
    imports into the JAX store, whose routed greedy tokens equal its
    unrouted ones."""
    server = _server(weights)
    store, _ = _store(server, paged)
    head, blocks = store.export_blocks(ROW)
    frame = tw.encode_frame(head, BLOCK, blocks)
    tokens, block, jblocks = jw.decode_frame(frame)
    jstore = _jax_store(jax_server, paged)
    assert jstore.import_blocks(tokens, jblocks)["inserted"] == 4
    with jax_server._prefix_lock:
        jax_server._prefixes.clear()
    m = jstore.route(ROW)
    assert m == HEAD
    if paged:
        # the pages hand out whole (the JAX engine gathers them)
        pids, got_m = jstore.acquire_pages(ROW[:m])
        jstore.pool.release(pids)
        assert got_m == m
    else:
        # the route registered the assembled imported blocks as the
        # prefix entry the routed run continues from
        got = jax_server.generate([ROW[m:]], max_new_tokens=8,
                                  prefix=np.asarray(ROW[:m], np.int32))
        want = jax_server.generate([ROW], max_new_tokens=8)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    # the JAX store holds the port's K/V bytes exactly
    _, back = jstore.export_blocks(ROW)
    for jb, tb in zip(back, blocks):
        for je, te in zip(jb, tb):
            for name in je:
                assert np.asarray(je[name]).tobytes() \
                    == te[name].numpy().tobytes()
    with jax_server._prefix_lock:
        jax_server._prefixes.clear()


def _ship(src, dst, streamed: bool) -> dict:
    """``src``'s export of ROW's head imported by ``dst``, as one frame or
    as a stream fed chunk by chunk."""
    if not streamed:
        head, blocks = src.export_blocks(ROW)
        tokens, _, blocks = tw.decode_frame(
            tw.encode_frame(head, BLOCK, blocks))
        return dst.import_blocks(tokens, blocks)
    head, groups = src.export_stream(ROW)
    leaves = [[n, tw.dtype_name(dt), list(s)]
              for n, (s, dt) in sorted(src._leaf_template().items())]
    dec, imp = tw.StreamDecoder(), None
    sent = 0
    frames = [tw.encode_stream_header(head, BLOCK, 2, leaves)]
    for group in groups:
        frames.append(tw.encode_chunk(sent, group))
        sent += len(group)
    for frame in frames:
        for kind, payload in dec.feed(frame):
            if kind == "header":
                imp = dst.import_begin(payload["tokens"])
            else:
                imp.add_blocks(payload[1])
    return imp.commit()


@PAGED_IDS
@pytest.mark.parametrize("streamed", [False, True],
                         ids=["frame", "stream"])
def test_port_ship_routes_bitwise_the_exporters_run(weights, paged,
                                                    streamed):
    """Export (cold: the export walks the head) and import between two
    port stores on the same weights: the importer's routed row, seeded,
    is bitwise the exporter's routed row, and its blocks are bitwise the
    exporter's whether they came as one frame or as a stream."""
    src_server, dst_server = _server(weights), _server(weights)
    src, src_engine = _store(src_server, paged)
    dst, dst_engine = _store(dst_server, paged)
    res = _ship(src, dst, streamed)
    assert res["inserted"] == 4
    assert src.prefill_stats.report()["rounds"] > 0
    _, want = _routed(src, src_engine, src_server, ROW, **SEEDED)
    m, got = _routed(dst, dst_engine, dst_server, ROW, **SEEDED)
    assert m == HEAD and dst.prefill_stats.report()["rounds"] == 0
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    _, a = src.export_blocks(ROW)
    _, b = dst.export_blocks(ROW)
    assert all(torch.equal(x[i][n], y[i][n]) for x, y in zip(a, b)
               for i in range(2) for n in x[i])
    assert _ship(src, dst, streamed)["inserted"] == 0  # idempotent
    assert dst.check_invariants()["ok"]


def test_streamed_import_abort_releases_everything(weights):
    """A stream that stops short or turns to garbage mid-way rolls its
    staged pages back: the tree and the pool read as before it began."""
    server = _server(weights)
    src, _ = _store(server, True)
    dst, engine = _store(_server(weights), True)
    head, groups = src.export_stream(ROW)
    groups = list(groups)
    live = engine.pool.stats()["pages_live"]
    imp = dst.import_begin(head)
    assert engine.pool.stats()["pages_live"] == live + 4
    imp.add_blocks(groups[0][:2])
    with pytest.raises(ValueError, match="truncated"):
        imp.commit()
    assert engine.pool.stats()["pages_live"] == live
    imp = dst.import_begin(head)
    bad = [[{**e, "k": e["k"][:, :, :1]} for e in groups[0][0]]]
    with pytest.raises(ValueError):
        imp.add_blocks(bad)
    imp.abort()
    assert engine.pool.stats()["pages_live"] == live
    assert dst.present_len(ROW) == 0 and dst.check_invariants()["ok"]
    engine.pool.check_invariants()


def test_import_rejects_a_layout_mismatch(weights):
    """An int8-KV frame into a float store, or a frame of another block
    width, is a ``ValueError`` before any device work."""
    server = _server(weights)
    int8 = treg.get("llama-tiny").build(
        extra={**EXTRA, "kv_quant": "int8"}).make_server(weights[2],
                                                         device="cpu")
    src = PrefixStore(int8, block=BLOCK, budget_mb=8)
    head, blocks = src.export_blocks(ROW)
    assert set(blocks[0][0]) == {"k_int8", "k_scale", "v_int8", "v_scale"}
    dst, _ = _store(server, True)
    with pytest.raises(ValueError, match="store layout"):
        dst.import_blocks(head, blocks)
    with pytest.raises(ValueError, match="cover exactly"):
        dst.import_blocks(head[:-1], blocks)
    assert dst.present_len(ROW) == 0


def test_export_of_a_sub_block_prompt_is_none(weights):
    store, _ = _store(_server(weights), True)
    assert store.export_blocks(ROW[:BLOCK - 1]) is None
    assert store.export_stream(ROW[:BLOCK - 1]) is None


# -- over HTTP -------------------------------------------------------------------


def _http(url, body: bytes, headers=None, method="POST"):
    req = urllib.request.Request(url, data=body, method=method,
                                 headers=headers or {})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.read(), dict(r.headers)


def _json(url, obj):
    return json.loads(_http(url, json.dumps(obj).encode(),
                            {"Content-Type": "application/json"})[0])


def _chunked(url, frames) -> tuple[int, dict]:
    """POST ``frames`` as a chunked body; (status, JSON answer)."""
    host, port = url.split("//")[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    try:
        conn.request("POST", "/v1/kv/import", body=iter(frames),
                     headers={"Transfer-Encoding": "chunked"},
                     encode_chunked=True)
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), json.loads(resp.read())
    finally:
        conn.close()


def _serve(weights, **extra):
    state = generate_handler(
        {"model": "llama-tiny",
         "extra": {**EXTRA, **PAGED, "batch_mode": "continuous",
                   "prefix_cache_mb": "8", "warm_group_prefill": "0", **extra}},
        HandlerContext(device="cpu", state_dict=weights[2]))
    return state, BundleServer(state, port=0).start_background()


def test_http_kv_routes_ship_bitwise(weights):
    """``/v1/kv/export`` (a frame, and with ``"stream": true`` a chunked
    stream of frames), ``/v1/kv/import`` (the frame, and the stream as a
    chunked body), ``/v1/kv/probe``: the importer's routed row is bitwise
    the exporter's, streamed bytes carry the same blocks as the frame,
    and ``batching.disagg`` counts both sides."""
    a_state, a = _serve(weights)
    b_state, b = _serve(weights)
    c_state, c = _serve(weights)
    try:
        frame, hdr = _http(a.url + "/v1/kv/export",
                           json.dumps({"tokens": ROW}).encode())
        assert hdr["Content-Type"] == "application/octet-stream"
        raw, hdr = _http(a.url + "/v1/kv/export",
                         json.dumps({"tokens": ROW, "stream": True}).encode())
        frames = [f for _, f in tw.FrameSplitter().feed(raw)]
        _, _, mono = tw.decode_frame(frame)
        _, _, streamed = tw.decode_stream(frames)
        assert all(torch.equal(x[i][n], y[i][n]) for x, y in
                   zip(mono, streamed) for i in range(2) for n in x[i])
        assert _json(b.url + "/v1/kv/probe", {"tokens": ROW})["matched"] == 0
        out = json.loads(_http(b.url + "/v1/kv/import", frame)[0])
        assert out["ok"] and out["inserted"] == 4 and out["mode"] == "paged"
        status, _, out = _chunked(c.url, frames)
        assert status == 200 and out["streamed"] and out["inserted"] == 4
        assert _json(b.url + "/v1/kv/probe",
                     {"tokens": ROW})["matched"] == HEAD
        body = {"tokens": ROW, "max_new_tokens": 8, "logprobs": True,
                **SEEDED}
        want = _json(a.url + "/invoke", body)
        for url in (b.url, c.url):
            got = _json(url + "/invoke", body)
            assert got["prefix_cached"]
            assert (got["tokens"], got["logprobs"]) \
                == (want["tokens"], want["logprobs"])
        for state in (b_state, c_state):
            assert state.prefix_store.prefill_stats.report()["rounds"] == 0
        da = a_state.stats()["batching"]["disagg"]
        assert da["exports"] == 2 and da["export_streams"] == 1
        db = b_state.stats()["batching"]["disagg"]
        assert db["imports"] == 1 and db["imports_zero_copy"] == 1
        dc = c_state.stats()["batching"]["disagg"]
        assert dc["import_streams"] == 1 and dc["import_stream_aborts"] == 0
        with pytest.raises(urllib.error.HTTPError) as exc:
            _json(a.url + "/v1/kv/export", {"tokens": ROW[:3]})
        assert exc.value.code == 400
    finally:
        for srv in (a, b, c):
            srv.stop(drain_grace=5.0)


def test_http_kv_import_garbage_is_400_and_full_arena_503(weights):
    """A truncated frame and a truncated stream answer 400 and leave the
    tree and the pool as they were; an import into an arena without room
    is the priced 503 ``kv_import`` with Retry-After, counted as
    backpressure."""
    src_state, src = _serve(weights)
    state, srv = _serve(weights, kv_pages="5")
    try:
        frame, _ = _http(src.url + "/v1/kv/export",
                         json.dumps({"tokens": ROW}).encode())
        raw, _ = _http(src.url + "/v1/kv/export",
                       json.dumps({"tokens": ROW, "stream": True}).encode())
        frames = [f for _, f in tw.FrameSplitter().feed(raw)]
        pool = state.engine.pool
        live = pool.stats()["pages_live"]
        with pytest.raises(urllib.error.HTTPError) as exc:
            _http(srv.url + "/v1/kv/import", frame[:-9])
        assert exc.value.code == 400
        assert "bad KV frame" in json.loads(exc.value.read())["error"]
        status, _, out = _chunked(srv.url, frames[:-1])
        assert status == 400 and "truncated" in out["error"]
        assert pool.stats()["pages_live"] == live
        assert state.prefix_store.present_len(ROW) == 0
        # fill the arena: 4 free pages, a row holding 3 of them
        held = pool.alloc(3, tokens=48)
        try:
            with pytest.raises(urllib.error.HTTPError) as exc:
                _http(srv.url + "/v1/kv/import", frame)
            assert exc.value.code == 503 and exc.value.headers["Retry-After"]
            assert json.loads(exc.value.read())["shed"] == "kv_import"
            status, hdr, out = _chunked(srv.url, frames)
            assert status == 503 and out["shed"] == "kv_import"
        finally:
            pool.release(held)
        d = state.stats()["batching"]["disagg"]
        assert d["import_backpressure"] == 2 and d["import_rejected"] == 2
        assert d["import_stream_aborts"] == 2 and d["imports"] == 0
        assert state.prefix_store.present_len(ROW) == 0
        assert pool.stats()["pages_live"] == live
        pool.check_invariants()
    finally:
        src.stop(drain_grace=5.0)
        srv.stop(drain_grace=5.0)


def test_import_backpressure_propagates(weights):
    """The store's strict allocation raises ``PagesExhausted`` and takes
    no page."""
    src, _ = _store(_server(weights), False)
    head, blocks = src.export_blocks(ROW)
    dst, engine = _store(_server(weights), True, kv_pages="4")
    with pytest.raises(PagesExhausted):
        dst.import_blocks(head, blocks)
    assert engine.pool.stats()["pages_live"] == 0
    with pytest.raises(PagesExhausted):
        dst.import_begin(head)
    assert engine.pool.stats()["pages_live"] == 0
