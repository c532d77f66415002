"""The port's K/V wire framing (``lambdipy_tpu_torch/runtime/kvwire.py``)
against ``lambdipy_tpu/runtime/kvwire.py``: the same blocks, made from
one numpy seed, encode to byte-identical frames and streams in both
packages (f32, bf16 and int8-KV leaves), each package decodes the other's
frames to the same values (exact), the relay's ``FrameSplitter`` and the
receiver's ``StreamDecoder`` cut any byte chunking into the same frames
and events, and every garbage case raises ``ValueError`` in both. On the
JAX side bf16 goes through ``ml_dtypes``; the port never imports it."""

import json
import struct

import ml_dtypes
import numpy as np
import pytest
import torch

from lambdipy_tpu.runtime import kvwire as jw
from lambdipy_tpu_torch.runtime import kvwire as tw

BLOCK = 16
LAYERS = 2
KINDS = ("f32", "bf16", "int8kv")


def _np_blocks(kind: str, n_blocks: int, seed: int = 0) -> list:
    """Blocks in the store layout, as the JAX package holds them (numpy,
    bf16 through ml_dtypes)."""
    rng = np.random.default_rng(seed)
    shape, sshape = (1, BLOCK, 2, 8), (1, BLOCK, 2, 1)
    blocks = []
    for _ in range(n_blocks):
        blk = []
        for _ in range(LAYERS):
            if kind == "int8kv":
                blk.append({
                    "k_int8": rng.integers(-128, 128, shape).astype(np.int8),
                    "k_scale": rng.random(sshape).astype(np.float32),
                    "v_int8": rng.integers(-128, 128, shape).astype(np.int8),
                    "v_scale": rng.random(sshape).astype(np.float32)})
            else:
                dt = np.float32 if kind == "f32" else ml_dtypes.bfloat16
                blk.append({"k": rng.standard_normal(shape).astype(dt),
                            "v": rng.standard_normal(shape).astype(dt)})
        blocks.append(blk)
    return blocks


def _to_torch(arr) -> torch.Tensor:
    if arr.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _torch_blocks(blocks) -> list:
    return [[{k: _to_torch(v) for k, v in e.items()} for e in blk]
            for blk in blocks]


def _assert_same(np_blocks, t_blocks) -> None:
    """Exact: the same dtype and the same bits."""
    assert len(np_blocks) == len(t_blocks)
    for nb, tb in zip(np_blocks, t_blocks):
        assert len(nb) == len(tb)
        for ne, te in zip(nb, tb):
            assert sorted(ne) == sorted(te)
            for name in ne:
                got = _to_numpy(te[name])
                assert got.dtype == np.asarray(ne[name]).dtype
                assert got.tobytes() == np.asarray(ne[name]).tobytes()


def _tokens(n_blocks: int) -> list:
    return list(range(7, 7 + n_blocks * BLOCK))


@pytest.mark.parametrize("kind", KINDS)
def test_frames_are_byte_identical_to_jax(kind):
    """``encode_frame``, the stream pieces (``encode_stream`` at group 1,
    2 and 5, ``encode_stream_header``, ``encode_chunk``,
    ``pack_block_body`` and ``encode_chunk_packed``) give the JAX
    package's bytes for the same blocks."""
    blocks = _np_blocks(kind, 5)
    tblocks = _torch_blocks(blocks)
    toks = _tokens(5)
    assert tw.encode_frame(toks, BLOCK, tblocks) \
        == jw.encode_frame(toks, BLOCK, blocks)
    for group in (1, 2, 5):
        assert tw.encode_stream(toks, BLOCK, tblocks, group=group) \
            == jw.encode_stream(toks, BLOCK, blocks, group=group)
    leaves = jw._leaf_template_of(blocks[0])
    assert tw._leaf_template_of(tblocks[0]) == leaves
    assert tw.encode_stream_header(toks, BLOCK, LAYERS, leaves) \
        == jw.encode_stream_header(toks, BLOCK, LAYERS, leaves)
    assert tw.encode_chunk(3, tblocks[3:]) == jw.encode_chunk(3, blocks[3:])
    names = [n for n, _, _ in leaves]
    body = tw.pack_block_body(tblocks[1:3], names)
    assert body == jw.pack_block_body(blocks[1:3], names)
    assert tw.encode_chunk_packed(1, 2, body) \
        == jw.encode_chunk_packed(1, 2, body) \
        == jw.encode_chunk(1, blocks[1:3])


@pytest.mark.parametrize("kind", KINDS)
def test_frames_cross_in_both_directions(kind):
    """A JAX frame and stream decode in the port to the same values as
    host tensors, and the port's decode in the JAX package."""
    blocks = _np_blocks(kind, 3, seed=1)
    toks = _tokens(3)
    frame = jw.encode_frame(toks, BLOCK, blocks)
    got_toks, got_block, got = tw.decode_frame(frame)
    assert (got_toks, got_block) == (toks, BLOCK)
    _assert_same(blocks, got)
    assert all(not t.is_cuda for blk in got for e in blk for t in e.values())
    _, _, got = tw.decode_stream(jw.encode_stream(toks, BLOCK, blocks,
                                                  group=2))
    _assert_same(blocks, got)
    tframe = tw.encode_frame(toks, BLOCK, _torch_blocks(blocks))
    jt, jb, jblocks = jw.decode_frame(tframe)
    assert (jt, jb) == (toks, BLOCK)
    _assert_same(jblocks, _torch_blocks(blocks))
    _, _, jblocks = jw.decode_stream(
        tw.encode_stream(toks, BLOCK, _torch_blocks(blocks), group=2))
    _assert_same(jblocks, _torch_blocks(blocks))


def test_bf16_travels_as_its_raw_words():
    """A bf16 leaf's body bytes are its 2-byte words, the JAX package's
    ``ml_dtypes`` bytes, and its header names it ``bfloat16``."""
    blocks = _np_blocks("bf16", 1, seed=2)
    tblocks = _torch_blocks(blocks)
    frame = tw.encode_frame(_tokens(1), BLOCK, tblocks)
    (hlen,) = struct.unpack_from("<I", frame, 4)
    header = json.loads(frame[8:8 + hlen])
    assert {d for _, d, _ in header["leaves"]} == {"bfloat16"}
    words = b"".join(tblocks[0][i][n].view(torch.int16).numpy().tobytes()
                     for i in range(LAYERS) for n in ("k", "v"))
    assert frame[8 + hlen:] == words


@pytest.mark.parametrize("seed", [3, 4])
def test_splitter_and_decoder_match_jax_at_any_chunking(seed):
    """Random byte chunkings of one stream: the port's ``FrameSplitter``
    gives the JAX splitter's frames and completion state, and its
    ``StreamDecoder`` the JAX decoder's events (values exact)."""
    rng = np.random.default_rng(seed)
    blocks = _np_blocks("int8kv" if seed % 2 else "f32", 6, seed=seed)
    raw = b"".join(jw.encode_stream(_tokens(6), BLOCK, blocks, group=4))
    cuts = sorted(rng.choice(np.arange(1, len(raw)), size=12,
                             replace=False))
    pieces = [raw[a:b] for a, b in zip([0, *cuts], [*cuts, len(raw)])]
    ts, js = tw.FrameSplitter(), jw.FrameSplitter()
    td, jd = tw.StreamDecoder(), jw.StreamDecoder()
    for piece in pieces:
        assert ts.feed(piece) == js.feed(piece)
        assert (ts.complete, ts.blocks_seen) == (js.complete, js.blocks_seen)
        tev, jev = td.feed(piece), jd.feed(piece)
        assert [k for k, _ in tev] == [k for k, _ in jev]
        for (kind, tp), (_, jp) in zip(tev, jev):
            if kind == "header":
                assert tp == jp
            else:
                assert tp[0] == jp[0]
                _assert_same(jp[1], tp[1])
    assert td.complete and jd.complete and ts.complete


def _frame_with(header: dict, body: bytes = b"",
                magic: bytes = jw.MAGIC) -> bytes:
    h = json.dumps(header).encode()
    return magic + struct.pack("<I", len(h)) + h + body


def _garbage() -> dict:
    """name -> (decode function name, input): the monolithic cases take
    one frame, the stream cases a list of frames."""
    blocks = _np_blocks("f32", 2, seed=5)
    toks = _tokens(2)
    frame = jw.encode_frame(toks, BLOCK, blocks)
    (hlen,) = struct.unpack_from("<I", frame, 4)
    header = json.loads(frame[8:8 + hlen])
    body = frame[8 + hlen:]
    stream = jw.encode_stream(toks, BLOCK, blocks, group=1)
    lying = dict(header, leaves=[["k", "float32", [1, BLOCK, 2, 9]],
                                 ["v", "float32", [1, BLOCK, 2, 8]]])
    return {
        "truncated": ("frame", frame[:-7]),
        "padded": ("frame", frame + b"\0" * 5),
        "lying_shape": ("frame", _frame_with(lying, body)),
        "bad_magic": ("frame", b"XKV1" + frame[4:]),
        "short_header": ("frame", frame[:6]),
        "oversized_header": ("frame", jw.MAGIC + struct.pack(
            "<I", (1 << 20) + 1) + b"{}"),
        "unparseable_header": ("frame", jw.MAGIC + struct.pack("<I", 3)
                               + b"{x}"),
        "bad_version": ("frame", _frame_with(dict(header, v=2), body)),
        "bad_leaf_name": ("frame", _frame_with(dict(
            header, leaves=[["q", "float32", [1, BLOCK, 2, 8]],
                            ["v", "float32", [1, BLOCK, 2, 8]]]), body)),
        "unknown_dtype": ("frame", _frame_with(dict(
            header, leaves=[["k", "notadtype", [1, BLOCK, 2, 8]],
                            ["v", "float32", [1, BLOCK, 2, 8]]]), body)),
        "tokens_do_not_cover": ("frame", _frame_with(
            dict(header, tokens=toks[:-1]), body)),
        "not_bytes": ("frame", [1, 2, 3]),
        "stream_out_of_order": ("stream", [stream[0], stream[2],
                                           stream[1]]),
        "stream_overlapping": ("stream", [stream[0], stream[1],
                                          stream[1]]),
        "stream_truncated": ("stream", stream[:2]),
        "stream_trailing": ("stream", stream + [stream[1]]),
        "stream_opens_with_a_chunk": ("stream", stream[1:]),
        "stream_body_lies": ("stream", [stream[0], jw.encode_chunk_packed(
            0, 1, b"\0" * 12), stream[2]]),
        "stream_oversized_chunk": ("stream", [stream[0], jw.CHUNK_MAGIC
                                              + struct.pack("<I", 40)
                                              + json.dumps({
                                                  "v": 1, "start": 0,
                                                  "n_blocks": 1,
                                                  "body": (1 << 30) + 1,
                                              }).encode().ljust(40)]),
        "stream_header_lies": ("stream", [_frame_with(
            dict(header, tokens=toks[:-1]), magic=jw.STREAM_MAGIC)]
            + stream[1:]),
    }


@pytest.mark.parametrize("case", sorted(_garbage()))
def test_garbage_raises_value_error_in_both(case):
    """Every malformed frame or stream raises ``ValueError`` in both
    packages before any tensor exists."""
    kind, data = _garbage()[case]
    for mod in (jw, tw):
        with pytest.raises(ValueError):
            if kind == "frame":
                mod.decode_frame(data)
            else:
                mod.decode_stream(data)


@pytest.mark.parametrize("mod", [jw, tw], ids=["jax", "port"])
def test_encode_validates_coverage(mod):
    blocks = _np_blocks("f32", 2)
    if mod is tw:
        blocks = _torch_blocks(blocks)
    with pytest.raises(ValueError):
        mod.encode_frame(_tokens(2)[:-1], BLOCK, blocks)
    with pytest.raises(ValueError):
        mod.encode_frame([], BLOCK, [])
    with pytest.raises(ValueError):
        mod.encode_stream_header(list(range(10)), BLOCK, LAYERS, [])
    with pytest.raises(ValueError):
        mod.encode_chunk(0, [])
