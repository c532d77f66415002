"""Flatpack, the single-file raw-tensor params format, read and written with
torch: the twin of ``lambdipy_tpu/bundle/flatpack.py``, byte for byte.

Layout (all little-endian):

    b"LFPK1\\n" | uint64 header_len | header JSON (utf-8) | pad to 64
    | tensor 0 bytes | pad to 64 | tensor 1 bytes | ...

Header: ``{"entries": [{"path": [..keys..], "dtype": "bfloat16",
"shape": [..], "nbytes": M, "offset": N}, ...]}``, offsets absolute.
The dtype names are numpy's (``bfloat16`` and the ``float8_*`` names are
ml_dtypes'); they map to torch dtypes directly, so reading a ``bfloat16``
leaf needs no ml_dtypes. The tree is the nested dict flax uses; the
port's ``state_dict`` keys are its paths joined by ``.`` without the
top-level ``params`` (``params/layer_0/q_proj/kernel_int8`` ->
``layer_0.q_proj.kernel_int8``), as ``models/params.py from_jax_params``
maps them.
"""

from __future__ import annotations

import json
import mmap
import struct
from pathlib import Path

import numpy as np
import torch

MAGIC = b"LFPK1\n"
_ALIGN = 64

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "float16": torch.float16, "bfloat16": torch.bfloat16,
           "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
           "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
           "float8_e4m3fn": torch.float8_e4m3fn,
           "float8_e5m2": torch.float8_e5m2}
_NAMES = {dt: name for name, dt in _DTYPES.items()}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"flatpack dtype {name!r} has no torch dtype; "
                         f"known: {sorted(_DTYPES)}") from None


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], prefix + (str(k),))
    else:
        yield prefix, tree


def _leaf(value) -> tuple[str, list, int]:
    """(dtype name, shape, nbytes) of a torch or numpy leaf."""
    if isinstance(value, torch.Tensor):
        if value.dtype not in _NAMES:
            raise ValueError(f"no flatpack name for {value.dtype}")
        return (_NAMES[value.dtype], list(value.shape),
                value.numel() * value.element_size())
    a = np.asarray(value)
    return a.dtype.name, list(a.shape), int(a.nbytes)


def _host_bytes(value) -> memoryview:
    """A leaf's bytes in C order (a CUDA tensor comes to the host first)."""
    if isinstance(value, torch.Tensor):
        t = value.detach().contiguous().cpu().reshape(-1)
        return memoryview(t.view(torch.uint8).numpy())
    a = np.ascontiguousarray(np.asarray(value)).reshape(-1)
    return memoryview(a.view(np.uint8))


def save(path: Path, tree) -> dict:
    """Write a nested-dict tree of torch tensors (any device) or numpy
    arrays, the same bytes as JAX's ``flatpack.save`` for the same tree;
    returns ``{"n_tensors", "bytes"}``."""
    path = Path(path)
    leaves = list(_flatten(tree))
    entries = []
    for p, v in leaves:
        name, shape, nbytes = _leaf(v)
        entries.append({"path": list(p), "dtype": name, "shape": shape,
                        "nbytes": nbytes})

    def aligned(n: int) -> int:
        return (n + _ALIGN - 1) // _ALIGN * _ALIGN

    # the offsets depend on the header's length, which depends on their
    # digits: iterate to the fixed point as JAX's writer does
    for _ in range(3):
        header = json.dumps({"entries": entries},
                            separators=(",", ":")).encode()
        base = aligned(len(MAGIC) + 8 + len(header))
        offset, changed = base, False
        for e in entries:
            if e.get("offset") != offset:
                e["offset"] = offset
                changed = True
            offset += aligned(e["nbytes"])
        if not changed:
            break
    else:
        raise RuntimeError("flatpack header offsets failed to converge")

    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<Q", len(header)))
        f.write(header)
        f.write(b"\0" * (base - len(MAGIC) - 8 - len(header)))
        for e, (_, v) in zip(entries, leaves):
            if f.tell() != e["offset"]:
                raise RuntimeError(f"flatpack writer at {f.tell()}, entry "
                                   f"{e['path']} at {e['offset']}")
            f.write(_host_bytes(v))
            f.write(b"\0" * (aligned(e["nbytes"]) - e["nbytes"]))
    tmp.replace(path)
    return {"n_tensors": len(entries), "bytes": offset}


def _read_header(path: Path):
    """(header dict, a private mapping of the whole file)."""
    path = Path(path)
    with open(path, "rb") as f:
        head = f.read(len(MAGIC) + 8)
        if head[: len(MAGIC)] != MAGIC:
            raise ValueError(f"{path}: not a flatpack file")
        (header_len,) = struct.unpack("<Q", head[len(MAGIC):])
        header = json.loads(f.read(header_len))
        # copy-on-write: torch.frombuffer wants a writable buffer, and no
        # write ever reaches the file
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    return header, buf


def _view(buf, e: dict) -> torch.Tensor:
    dt = torch_dtype(e["dtype"])
    if e["nbytes"] == 0:
        return torch.empty(e["shape"], dtype=dt)
    return torch.frombuffer(buf, dtype=dt, offset=e["offset"],
                            count=e["nbytes"] // dt.itemsize
                            ).reshape(e["shape"])


def _keys(entries) -> list[str]:
    paths = [e["path"] for e in entries]
    strip = all(len(p) > 1 and p[0] == "params" for p in paths)
    return [".".join(p[1:] if strip else p) for p in paths]


def load_state_dict(path: Path, device=None) -> dict[str, torch.Tensor]:
    """``path`` as a port ``state_dict`` on ``device`` (CPU by default):
    on the CPU the tensors view a private mapping of the file (pages are
    read as the consumer touches them); on a card see
    :func:`device_load`."""
    device = torch.device(device or "cpu")
    if device.type == "cuda":
        return device_load(path, device)
    header, buf = _read_header(path)
    entries = header["entries"]
    return {k: _view(buf, e) for k, e in zip(_keys(entries), entries)}


def device_load(path: Path, device,
                chunk_bytes: int = 256 << 20) -> dict[str, torch.Tensor]:
    """Load ``path`` onto ``device`` as a ``state_dict`` through a few
    large transfers, the twin of JAX's ``device_load``: the file's tensor
    region is cut into ``chunk_bytes`` pieces, each copied into one of two
    host buffers (pinned for a card) and sent to the device in one
    transfer, and the tensors cut from the chunk on the device into their
    own allocations. On a card the two buffers alternate, so the host's
    copy of one chunk runs while the other travels; peak extra device
    memory is two chunks. On the CPU the same walk runs synchronously
    (the tests' check of the chunking)."""
    device = torch.device(device)
    header, buf = _read_header(path)
    entries = header["entries"]
    out, spans = {}, []
    for key, e in zip(_keys(entries), entries):
        t = torch.empty(e["shape"], dtype=torch_dtype(e["dtype"]),
                        device=device)
        out[key] = t
        if e["nbytes"]:
            spans.append((e["offset"], e["nbytes"],
                          t.view(-1).view(torch.uint8)))
    if not spans:
        return out
    spans.sort(key=lambda s: s[0])
    start = spans[0][0]
    end = max(off + n for off, n, _ in spans)
    size = min(chunk_bytes, end - start)
    src = np.frombuffer(buf, np.uint8)
    cuda = device.type == "cuda"
    host = [torch.empty(size, dtype=torch.uint8, pin_memory=cuda)
            for _ in range(2)]
    staged = [torch.empty(size, dtype=torch.uint8, device=device)
              for _ in range(2)]
    done: list = [None, None]
    stream = torch.cuda.current_stream(device) if cuda else None
    first = 0  # the first span not yet copied in full
    for k, lo in enumerate(range(start, end, size)):
        hi = min(lo + size, end)
        slot = k % 2
        if done[slot] is not None:
            done[slot].synchronize()  # the slot's last transfer has landed
        host[slot][: hi - lo].numpy()[:] = src[lo:hi]
        staged[slot][: hi - lo].copy_(host[slot][: hi - lo],
                                      non_blocking=True)
        j = first
        while j < len(spans) and spans[j][0] < hi:
            off, n, dst = spans[j]
            a, b = max(off, lo), min(off + n, hi)
            dst[a - off: b - off].copy_(staged[slot][a - lo: b - lo],
                                        non_blocking=True)
            if off + n > hi:
                break  # continues in the next chunk
            j += 1
        first = j
        if cuda:
            done[slot] = torch.cuda.Event()
            done[slot].record(stream)
    if cuda:
        stream.synchronize()
    return out
