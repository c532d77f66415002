"""KV-block wire framing for shipping a prompt head's K/V between replicas.

The port's copy of ``lambdipy_tpu/runtime/kvwire.py``: the same frames,
byte for byte, so a frame crosses between the two packages in either
direction. A replica exports the whole-block K/V of a prompt head; another
imports it into its prefix store (``runtime/prefixstore.py``) as a radix
insert. The frame is self-describing:

``LKV1 | u32 header_len | header JSON | raw leaf bytes``

The header names the covered tokens, the block width and the per-layer
leaf template (name, dtype, shape): one template, because every block of
every layer stores the same store-layout leaves (``k``/``v`` float, or
``k_int8``/``k_scale``/``v_int8``/``v_scale`` under ``kv_quant``). The
body is raw tensor bytes in a fixed order, block-major, then layer, then
leaf name sorted, so decoding needs no per-tensor framing.

Decoding VALIDATES before any tensor is built: magic, header JSON, leaf
sanity and the exact byte length the template implies. A truncated,
padded or shape-lying frame raises :class:`ValueError`; the import
endpoint answers 400, and a garbage frame never reaches the radix tree.

Dtypes travel by their numpy names. A ``bfloat16`` leaf travels as its
raw 2-byte words under the name ``"bfloat16"`` (``tensor.view`` of the
bytes, no float32 detour), which is what the JAX package writes for the
same values, so a bf16 replica ships its K/V bitwise.

CHUNKED STREAM (the pipelined ship): the same payload as frames that the
exporter can flush as its walk produces each block group:

``LKVS | u32 len | stream header JSON``          (no body)
``LKVC | u32 len | chunk header JSON | raw leaf bytes``  (repeated)

The stream header carries what ``LKV1``'s did (tokens, block width,
layer count, leaf template, total ``n_blocks``); completeness is
``blocks received == n_blocks``, so a connection that dies earlier IS the
truncation signal. Each chunk header names its absolute ``start`` block,
its block count and its body's byte length, so a relay re-frames the
stream without the leaf template; chunks arrive strictly in order.

:class:`FrameSplitter` is the relay-side re-framer (bytes to whole
frames, no tensors); :class:`StreamDecoder` the receiver-side validator
(frames to torch block groups on the host, template-checked).
"""

from __future__ import annotations

import json
import struct

import torch

MAGIC = b"LKV1"
STREAM_MAGIC = b"LKVS"
CHUNK_MAGIC = b"LKVC"
# a header bigger than this is not a header: it bounds the allocation a
# hostile length prefix could ask for before json parsing sees it
_MAX_HEADER = 1 << 20
# chunk bodies are block-group sized; a body claim past this is a lying
# header, not a big ship
_MAX_CHUNK_BODY = 1 << 30

# leaf names the store layout can produce; anything else is garbage
_LEAF_NAMES = {"k", "v", "k_int8", "k_scale", "v_int8", "v_scale"}

# wire dtype names (numpy's) and the torch dtypes they decode to
_DTYPES = {"float64": torch.float64, "float32": torch.float32,
           "float16": torch.float16, "bfloat16": torch.bfloat16,
           "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
           "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool}
_NAMES = {dt: name for name, dt in _DTYPES.items()}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a wire dtype name."""
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unknown KV wire dtype {name!r}") from None


def dtype_name(dtype: torch.dtype) -> str:
    """The wire (numpy) name of a torch dtype."""
    try:
        return _NAMES[dtype]
    except KeyError:
        raise ValueError(f"dtype {dtype} has no KV wire name") from None


def _host(val) -> torch.Tensor:
    """A leaf as a contiguous host tensor."""
    t = val if torch.is_tensor(val) else torch.as_tensor(val)
    return t.detach().cpu().contiguous()


def _tensor_bytes(val) -> bytes:
    """A leaf's raw bytes in C order (bf16 as its 2-byte words)."""
    t = _host(val)
    return t.reshape(-1).view(torch.uint8).numpy().tobytes()


def _leaf_template_of(first_block) -> list:
    """``[name, dtype name, shape]`` rows (name-sorted) from one block's
    first-layer leaf dict: the wire's self-description."""
    out = []
    for name in sorted(first_block[0]):
        t = first_block[0][name]
        t = t if torch.is_tensor(t) else torch.as_tensor(t)
        out.append([name, dtype_name(t.dtype), [int(d) for d in t.shape]])
    return out


def _parse_leaves(raw) -> list:
    """Header ``leaves`` rows as ``[(name, torch dtype, shape)]``."""
    return [(str(n), torch_dtype(str(d)), tuple(int(x) for x in s))
            for n, d, s in raw]


def _leaf_sizes(leaves, block: int) -> list[int]:
    """Per-leaf byte size, validating each leaf's geometry against the
    frame's block width. Raises ValueError on anything malformed."""
    names = [n for n, _, _ in leaves]
    if len(set(names)) != len(names) or not set(names) <= _LEAF_NAMES:
        raise ValueError(f"bad KV frame leaf names {names}")
    per_leaf = []
    for name, dt, shape in leaves:
        if len(shape) != 4 or shape[0] != 1 or shape[1] != block or \
                any(d <= 0 for d in shape):
            raise ValueError(
                f"bad KV frame leaf shape {shape} for {name!r}")
        n = torch.empty((), dtype=dt).element_size()
        for d in shape:
            n *= d
        per_leaf.append(n)
    return per_leaf


def _pack_body(blocks, names) -> list[bytes]:
    return [_tensor_bytes(entry[name])
            for blk in blocks for entry in blk for name in names]


def _unpack_blocks(body: bytearray, n_blocks: int, layers: int, leaves,
                   per_leaf) -> list:
    """Host tensors viewing ``body`` (checked against the template by the
    caller first)."""
    blocks, off = [], 0
    for _ in range(n_blocks):
        blk = []
        for _ in range(layers):
            entry = {}
            for (name, dt, shape), nbytes in zip(leaves, per_leaf):
                size = torch.empty((), dtype=dt).element_size()
                entry[name] = torch.frombuffer(
                    body, dtype=dt, count=nbytes // size,
                    offset=off).reshape(shape)
                off += nbytes
            blk.append(entry)
        blocks.append(blk)
    return blocks


def _parse_json_header(data: bytes, magic: bytes, off: int = 0):
    """``magic | u32 len | header JSON`` at ``off`` as (header dict,
    offset past the header). Raises ValueError on garbage; returns
    ``None`` when ``data`` is merely too short (the caller buffers more)."""
    if len(data) - off < len(magic) + 4:
        return None
    if data[off:off + len(magic)] != magic:
        raise ValueError(
            f"bad KV frame magic {data[off:off + len(magic)]!r} "
            f"(want {magic!r})")
    (hlen,) = struct.unpack_from("<I", data, off + len(magic))
    if hlen <= 0 or hlen > _MAX_HEADER:
        raise ValueError(f"implausible KV frame header length {hlen}")
    hstart = off + len(magic) + 4
    if len(data) < hstart + hlen:
        return None
    try:
        header = json.loads(data[hstart:hstart + hlen])
    except (ValueError, UnicodeDecodeError) as e:
        raise ValueError(f"unparseable KV frame header: {e}") from None
    if not isinstance(header, dict) or header.get("v") != 1:
        raise ValueError("unsupported KV frame version")
    return header, hstart + hlen


def encode_frame(tokens, block: int, blocks) -> bytes:
    """Serialize ``blocks``, a list over blocks, each a list over layers
    of ``{leaf name: tensor [1, block, kv_heads, d-or-1]}`` (the
    ``models/llama.py slice_cache_blocks`` shape), into one frame
    covering ``tokens`` (whole blocks)."""
    tokens = [int(t) for t in tokens]
    block = int(block)
    if not blocks:
        raise ValueError("nothing to encode: no blocks")
    if len(tokens) != len(blocks) * block:
        raise ValueError(
            f"{len(tokens)} tokens do not cover {len(blocks)} x "
            f"{block}-token blocks")
    first = blocks[0]
    leaves = _leaf_template_of(first)
    names = [n for n, _, _ in leaves]
    header = {
        "v": 1,
        "tokens": tokens,
        "block": block,
        "layers": len(first),
        "n_blocks": len(blocks),
        "leaves": leaves,
    }
    hbytes = json.dumps(header).encode()
    out = [MAGIC, struct.pack("<I", len(hbytes)), hbytes]
    for blk in blocks:
        if len(blk) != len(first):
            raise ValueError("blocks disagree on layer count")
    out.extend(_pack_body(blocks, names))
    return b"".join(out)


def decode_frame(data: bytes):
    """Parse and validate a frame back into ``(tokens, block, blocks)``
    with host tensors. Raises :class:`ValueError` on anything malformed,
    before any tensor exists."""
    if not isinstance(data, (bytes, bytearray, memoryview)):
        raise ValueError("KV frame must be bytes")
    data = bytes(data)
    parsed = _parse_json_header(data, MAGIC)
    if parsed is None:
        if len(data) >= len(MAGIC) and data[:len(MAGIC)] != MAGIC:
            raise ValueError("bad KV frame magic")
        raise ValueError("truncated KV frame header")
    header, body_off = parsed
    try:
        tokens = [int(t) for t in header["tokens"]]
        block = int(header["block"])
        layers = int(header["layers"])
        n_blocks = int(header["n_blocks"])
        leaves = _parse_leaves(header["leaves"])
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"bad KV frame header: {e}") from None
    if block <= 0 or layers <= 0 or n_blocks <= 0 or not leaves:
        raise ValueError("bad KV frame header: non-positive geometry")
    if len(tokens) != n_blocks * block:
        raise ValueError("KV frame tokens do not cover its blocks")
    per_leaf = _leaf_sizes(leaves, block)
    body = bytearray(data[body_off:])
    expect = n_blocks * layers * sum(per_leaf)
    if len(body) != expect:
        raise ValueError(
            f"KV frame body is {len(body)} bytes, header implies "
            f"{expect}")
    return tokens, block, _unpack_blocks(body, n_blocks, layers, leaves,
                                         per_leaf)


# -- chunked stream (the pipelined ship) --------------------------------------


def encode_stream_header(tokens, block: int, layers: int,
                         leaves) -> bytes:
    """The ``LKVS`` frame opening a chunked ship: what the monolithic
    header carries, emitted before any block exists (``leaves`` is the
    store-layout template, ``[name, dtype name, shape]`` rows, a constant
    of the server's configuration)."""
    tokens = [int(t) for t in tokens]
    block = int(block)
    if block <= 0 or not tokens or len(tokens) % block:
        raise ValueError(
            f"{len(tokens)} stream tokens do not cover whole "
            f"{block}-token blocks")
    header = {
        "v": 1,
        "tokens": tokens,
        "block": block,
        "layers": int(layers),
        "n_blocks": len(tokens) // block,
        "leaves": [[str(n), str(d), [int(x) for x in s]]
                   for n, d, s in leaves],
    }
    hbytes = json.dumps(header).encode()
    return b"".join([STREAM_MAGIC, struct.pack("<I", len(hbytes)),
                     hbytes])


def encode_chunk(start: int, blocks) -> bytes:
    """One ``LKVC`` frame: the block group ``blocks`` (per-block shape as
    :func:`encode_frame` takes) at absolute block index ``start``, its
    header carrying the body's exact byte length."""
    if not blocks:
        raise ValueError("nothing to encode: empty chunk")
    leaves = _leaf_template_of(blocks[0])
    names = [n for n, _, _ in leaves]
    body = _pack_body(blocks, names)
    nbody = sum(len(b) for b in body)
    header = {"v": 1, "start": int(start), "n_blocks": len(blocks),
              "body": nbody}
    hbytes = json.dumps(header).encode()
    return b"".join([CHUNK_MAGIC, struct.pack("<I", len(hbytes)),
                     hbytes] + body)


def pack_block_body(blocks, names) -> bytes:
    """Blocks as one contiguous ``LKVC`` body under a leaf-name order
    derived once by the caller (the offload spill, ``runtime/offload.py``)."""
    return b"".join(_pack_body(blocks, names))


def encode_chunk_packed(start: int, n_blocks: int, body: bytes) -> bytes:
    """One ``LKVC`` frame over an already-packed ``body``
    (:func:`pack_block_body`): byte-identical to :func:`encode_chunk` for
    the same blocks, the body bytes reused."""
    header = {"v": 1, "start": int(start), "n_blocks": int(n_blocks),
              "body": len(body)}
    hbytes = json.dumps(header).encode()
    return b"".join([CHUNK_MAGIC, struct.pack("<I", len(hbytes)),
                     hbytes, body])


def encode_stream(tokens, block: int, blocks, *,
                  group: int = 4) -> list[bytes]:
    """The ``(tokens, block, blocks)`` that :func:`encode_frame` takes, as
    a header frame and ``group``-block chunk frames."""
    tokens = [int(t) for t in tokens]
    if not blocks:
        raise ValueError("nothing to encode: no blocks")
    if len(tokens) != len(blocks) * int(block):
        raise ValueError(
            f"{len(tokens)} tokens do not cover {len(blocks)} x "
            f"{block}-token blocks")
    frames = [encode_stream_header(tokens, block, len(blocks[0]),
                                   _leaf_template_of(blocks[0]))]
    group = max(1, int(group))
    for i in range(0, len(blocks), group):
        frames.append(encode_chunk(i, blocks[i:i + group]))
    return frames


class FrameSplitter:
    """Relay-side re-framer: raw bytes in, whole ``(kind, frame)`` tuples
    out (kind ``"header"`` or ``"chunk"``), no tensors. Chunk body lengths
    come from the chunk headers' ``body`` field (bounds-checked; checked
    against the leaf template by :class:`StreamDecoder`), and block counts
    are tracked against the stream header, so the relay knows whether the
    stream it forwarded was complete without trusting the transport's
    end of file. The buffer is a ``bytearray`` that whole frames are cut
    from, so a stream fed in small reads costs linear time (a ``bytes``
    buffer grown by concatenation copies itself whole on every read)."""

    def __init__(self):
        self._buf = bytearray()
        self.total_blocks: int | None = None
        self.blocks_seen = 0

    @property
    def complete(self) -> bool:
        return (self.total_blocks is not None
                and self.blocks_seen >= self.total_blocks)

    def feed(self, data: bytes) -> list[tuple[str, bytes]]:
        """Buffer ``data``; return every whole frame now available.
        Raises ValueError on garbage (bad magic, lying lengths, chunks
        past the declared total, frames after completion)."""
        self._buf += data
        out: list[tuple[str, bytes]] = []
        while True:
            frame = self._next_frame()
            if frame is None:
                return out
            out.append(frame)

    def _next_frame(self):
        buf = self._buf
        if len(buf) < 4:
            return None
        magic = bytes(buf[:4])
        if self.total_blocks is None:
            if magic != STREAM_MAGIC:
                raise ValueError(
                    f"KV stream must open with {STREAM_MAGIC!r}, got "
                    f"{magic!r}")
            parsed = _parse_json_header(buf, STREAM_MAGIC)
            if parsed is None:
                return None
            header, end = parsed
            try:
                self.total_blocks = int(header["n_blocks"])
            except (KeyError, TypeError, ValueError):
                raise ValueError("KV stream header lacks n_blocks") \
                    from None
            if self.total_blocks <= 0:
                raise ValueError("KV stream header: no blocks")
            return "header", self._cut(end)
        if self.complete:
            raise ValueError("trailing bytes after a complete KV stream")
        if magic != CHUNK_MAGIC:
            raise ValueError(
                f"bad KV chunk magic {magic!r} (want {CHUNK_MAGIC!r})")
        parsed = _parse_json_header(buf, CHUNK_MAGIC)
        if parsed is None:
            return None
        header, body_start = parsed
        try:
            n_blocks = int(header["n_blocks"])
            nbody = int(header["body"])
        except (KeyError, TypeError, ValueError):
            raise ValueError("KV chunk header lacks n_blocks/body") \
                from None
        if n_blocks <= 0 or nbody < 0 or nbody > _MAX_CHUNK_BODY:
            raise ValueError(
                f"implausible KV chunk geometry (blocks={n_blocks}, "
                f"body={nbody})")
        if self.blocks_seen + n_blocks > self.total_blocks:
            raise ValueError(
                f"KV chunk overruns the stream ({self.blocks_seen} + "
                f"{n_blocks} > {self.total_blocks} blocks)")
        end = body_start + nbody
        if len(buf) < end:
            return None
        self.blocks_seen += n_blocks
        return "chunk", self._cut(end)

    def _cut(self, end: int) -> bytes:
        """The buffer's first ``end`` bytes as a frame, dropped from it."""
        frame = bytes(self._buf[:end])
        del self._buf[:end]
        return frame


class StreamDecoder:
    """Receiver-side validator: frames (or raw bytes) in, typed events
    out. The header event carries the parsed geometry; each chunk event
    ``(start, blocks)`` with host tensors, checked against the header's
    leaf template, the frame's byte length and strict in-order delivery
    (``start ==`` blocks received so far). A stream is :attr:`complete`
    only when every declared block arrived."""

    def __init__(self):
        self._split = FrameSplitter()
        self.tokens: list | None = None
        self.block = 0
        self.layers = 0
        self._leaves = None
        self._per_leaf = None
        self.blocks_received = 0

    @property
    def complete(self) -> bool:
        return (self.tokens is not None
                and self.blocks_received * self.block == len(self.tokens))

    def feed(self, data: bytes) -> list[tuple]:
        """``[("header", {tokens, block, layers, n_blocks}), ...,
        ("chunk", (start, blocks)), ...]`` for every frame that ``data``
        completes. Raises ValueError on any malformed, out-of-order or
        template-lying frame."""
        out = []
        for kind, frame in self._split.feed(data):
            if kind == "header":
                out.append(("header", self._on_header(frame)))
            else:
                out.append(("chunk", self._on_chunk(frame)))
        return out

    def _on_header(self, frame: bytes) -> dict:
        header, _ = _parse_json_header(frame, STREAM_MAGIC)
        try:
            self.tokens = [int(t) for t in header["tokens"]]
            self.block = int(header["block"])
            self.layers = int(header["layers"])
            n_blocks = int(header["n_blocks"])
            self._leaves = _parse_leaves(header["leaves"])
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"bad KV stream header: {e}") from None
        if self.block <= 0 or self.layers <= 0 or not self._leaves:
            raise ValueError("bad KV stream header: non-positive "
                             "geometry")
        if len(self.tokens) != n_blocks * self.block:
            raise ValueError("KV stream tokens do not cover its blocks")
        self._per_leaf = _leaf_sizes(self._leaves, self.block)
        return {"tokens": self.tokens, "block": self.block,
                "layers": self.layers, "n_blocks": n_blocks}

    def _on_chunk(self, frame: bytes) -> tuple[int, list]:
        header, body_start = _parse_json_header(frame, CHUNK_MAGIC)
        start = int(header.get("start", -1))
        n_blocks = int(header["n_blocks"])
        if start != self.blocks_received:
            raise ValueError(
                f"KV chunk out of order: starts at block {start}, "
                f"expected {self.blocks_received}")
        body = bytearray(frame[body_start:])
        expect = n_blocks * self.layers * sum(self._per_leaf)
        if len(body) != expect:
            raise ValueError(
                f"KV chunk body is {len(body)} bytes, the stream's "
                f"leaf template implies {expect}")
        blocks = _unpack_blocks(body, n_blocks, self.layers,
                                self._leaves, self._per_leaf)
        self.blocks_received += n_blocks
        return start, blocks


def decode_stream(frames) -> tuple:
    """Frames as ``(tokens, block, blocks)``, with every per-chunk
    validation applied. Raises ValueError on truncation (blocks missing
    at the end of the input)."""
    dec = StreamDecoder()
    blocks: list = []
    for frame in frames:
        for kind, payload in dec.feed(frame):
            if kind == "chunk":
                blocks.extend(payload[1])
    if not dec.complete:
        raise ValueError(
            f"truncated KV stream: {dec.blocks_received} block(s) "
            f"arrived of {(len(dec.tokens) // dec.block) if dec.tokens else '?'}")
    return dec.tokens, dec.block, blocks
