"""Where loading a bundle's ``params.fpk`` onto the card spends its time.

Writes a flatpack of llama3-8b's shapes (int8 projections and lm_head,
the bf16 embedding and norms: 8.56 GB) with ``bundle/flatpack.py`` into a
temporary directory, then reads it back in turns, twice each:

- ``mmap``: the file's private mapping copied into a pinned buffer, 256
  MiB at a time (what ``flatpack.device_load`` does);
- ``read xN``: ``os.preadv`` into the pinned buffer by N threads;
- ``h2d``: the pinned buffer to the card, one transfer per 256 MiB;
- ``device_load``: ``flatpack.device_load`` end to end.

It prints each rate in GB/s with the host's memory (``/proc/meminfo``)
and its cgroup limit, and the card's name and power limit. Run on a
machine with an NVIDIA H100:

    python -m lambdipy_tpu_torch.load_probe
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from lambdipy_tpu_torch.bundle import flatpack
from lambdipy_tpu_torch.models import registry
from lambdipy_tpu_torch.models.llama import LlamaModel

CHUNK = 256 << 20


def _host_memory() -> str:
    info = dict(line.split(":", 1) for line in
                Path("/proc/meminfo").read_text().splitlines())
    limit = Path("/sys/fs/cgroup/memory.max")
    return (f"MemTotal {info['MemTotal'].strip()}, MemAvailable "
            f"{info['MemAvailable'].strip()}, Cached {info['Cached'].strip()},"
            f" cgroup memory.max "
            f"{limit.read_text().strip() if limit.exists() else 'none'}")


def _span(path: Path) -> tuple[int, int]:
    header, _ = flatpack._read_header(path)
    offs = [(e["offset"], e["offset"] + e["nbytes"])
            for e in header["entries"]]
    return min(a for a, _ in offs), max(b for _, b in offs)


def read_mmap(path: Path, pinned: torch.Tensor) -> int:
    lo, hi = _span(path)
    _, buf = flatpack._read_header(path)
    src = np.frombuffer(buf, np.uint8)
    dst = pinned.numpy()
    for a in range(lo, hi, CHUNK):
        b = min(a + CHUNK, hi)
        dst[: b - a] = src[a:b]
    return hi - lo


def read_threads(path: Path, pinned: torch.Tensor, threads: int) -> int:
    """Each thread ``preadv``s its share of every 256 MiB chunk."""
    lo, hi = _span(path)
    view = memoryview(pinned.numpy())
    fd = os.open(path, os.O_RDONLY)
    try:
        for a in range(lo, hi, CHUNK):
            n = min(CHUNK, hi - a)
            step = -(-n // threads)

            def part(i):
                s, e = i * step, min(n, (i + 1) * step)
                while s < e:
                    s += os.preadv(fd, [view[s:e]], a + s)

            ts = [threading.Thread(target=part, args=(i,))
                  for i in range(threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
    finally:
        os.close(fd)
    return hi - lo


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("load_probe needs an NVIDIA CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print("host:", _host_memory(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    tree: dict = {"params": {}}
    cfg = registry.get("llama3-8b").build().config  # int8 weights
    for key, ref in LlamaModel(cfg, device="meta").state_dict().items():
        t = torch.randint(-127, 128, ref.shape, generator=gen, device="cuda",
                          dtype=torch.int8)
        node = tree["params"]
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t.view(ref.dtype) if ref.dtype.itemsize == 1 else \
            t.to(ref.dtype)
    root = Path(tempfile.mkdtemp(prefix="lambdipy-load-probe-"))
    try:
        path = root / "params.fpk"
        t0 = time.perf_counter()
        info = flatpack.save(path, tree)
        wall = time.perf_counter() - t0
        del tree
        torch.cuda.empty_cache()
        print(f"write {info['bytes']:,} B: {wall:.2f} s "
              f"({info['bytes'] / wall / 1e9:.2f} GB/s); host: "
              f"{_host_memory()}", flush=True)
        pinned = torch.empty(CHUNK, dtype=torch.uint8, pin_memory=True)
        staged = torch.empty(CHUNK, dtype=torch.uint8, device="cuda")
        runs = [("mmap", lambda: read_mmap(path, pinned)),
                ("read x1", lambda: read_threads(path, pinned, 1)),
                ("read x8", lambda: read_threads(path, pinned, 8))]
        for _ in range(2):
            for name, fn in runs:
                t0 = time.perf_counter()
                n = fn()
                wall = time.perf_counter() - t0
                print(f"{name}: {n / wall / 1e9:.2f} GB/s ({wall:.2f} s) "
                      f"[{card}]", flush=True)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(32):
                staged.copy_(pinned, non_blocking=True)
            end.record()
            end.synchronize()
            print(f"h2d: {32 * CHUNK / start.elapsed_time(end) / 1e6:.2f} "
                  f"GB/s [{card}]", flush=True)
            t0 = time.perf_counter()
            sd = flatpack.device_load(path, "cuda")
            wall = time.perf_counter() - t0
            print(f"device_load: {info['bytes'] / wall / 1e9:.2f} GB/s "
                  f"({wall:.2f} s) [{card}]", flush=True)
            del sd
            torch.cuda.empty_cache()
        print("host:", _host_memory(), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
