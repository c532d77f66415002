"""Device time of the decode-attention kernel at other split widths.

Builds ``csrc/decode_attention.cu`` once for each ``KV_CHUNK`` in
``CHUNKS`` (a copy of the source with the constant replaced, under
``_build/``, one ``nvcc`` per width, all started together) and times
each build's two launches, the split pass and the merge, under
``torch.profiler`` at the decode shapes of ``chip_smoke.py``'s phase 3
(llama3-8b heads, bf16, float and int8 K/V, K/V copies rotated past the
50 MB L2). The profiler reports each kernel's own duration, so host time
is left out. The shipped width is ``ops.decode_attention.KV_CHUNK``; the
split plan must not depend on the batch, so one width serves every
shape. Run on a machine with an NVIDIA H100:

    python -m lambdipy_tpu_torch.kv_chunk_probe
"""

from __future__ import annotations

import ctypes
import re
import subprocess

import torch

from lambdipy_tpu_torch.ops import _build

CHUNKS = (64, 128, 256)
HEADS = (32, 8, 128)  # h, kvh, d of llama3-8b
# (b, t, active_len): chip_smoke.py's DECODE_SHAPES
SHAPES = ((4, 544, (1, 129, 300, 544)), (1, 4128, (4100,)),
          (8, 8192, (1, 144, 164, 532, 1040, 2024, 4032, 180)))
COPIES = 8  # rotated K/V copies: 8 x 33 MB at the largest shape


def build(chunks=CHUNKS) -> dict:
    """``{chunk: launch function}``, the contiguous entry point of a build
    of the source at each split width."""
    src = (_build.CSRC / "decode_attention.cu").read_text()
    const = re.compile(r"constexpr int KV_CHUNK = \d+;")
    if len(const.findall(src)) != 1:
        raise RuntimeError("decode_attention.cu must define KV_CHUNK once")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for chunk in chunks:
        cu = _build.BUILD_DIR / f"probe_kv{chunk}.cu"
        cu.write_text(const.sub(f"constexpr int KV_CHUNK = {chunk};", src))
        lib = _build.BUILD_DIR / f"libprobe_kv{chunk}.so"
        procs[chunk] = (subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    fns = {}
    for chunk, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed at KV_CHUNK {chunk}:\n{log}")
        fn = ctypes.CDLL(str(lib)).decode_attention_launch
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                       + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[chunk] = fn
    return fns


def kernel_times(call, calls: int = 40) -> dict:
    """Mean device µs per call of ``call(i)`` for each kernel it launched,
    from ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for i in range(3):
        call(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            call(i)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            kind = "merge" if "combine" in e.key else "split"
            out[kind] = out.get(kind, 0.0) + e.self_device_time_total / calls
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("kv_chunk_probe needs an NVIDIA CUDA device")
    from lambdipy_tpu_torch.models.llama import _kv_quantize

    fns = build()
    h, kvh, d = HEADS
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    kernel_times(lambda i: torch.ones(1, device="cuda"))  # warm the profiler
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"{card}; device µs per call (split + merge) by KV_CHUNK "
          f"{list(CHUNKS)}")
    for quant in (False, True):
        for b, t, active in SHAPES:
            q = torch.randn(b, 1, h, d, generator=gen,
                            device="cuda").to(torch.bfloat16)
            kvs = []
            for _ in range(COPIES):
                k, v = (torch.randn(b, t, kvh, d, generator=gen,
                                    device="cuda") for _ in range(2))
                if quant:
                    (k8, ks), (v8, vs) = _kv_quantize(k), _kv_quantize(v)
                    kvs.append((k8, v8, ks, vs))
                else:
                    kvs.append((k.bfloat16(), v.bfloat16(), None, None))
                del k, v
            alen = torch.tensor(active, dtype=torch.int32, device="cuda")
            out = torch.empty_like(q)
            row = []
            for chunk, fn in fns.items():
                n = b * kvh * -(-t // chunk) * (h // kvh)
                scratch = torch.empty(n * (d + 2), device="cuda")

                def call(i, fn=fn, n=n, scratch=scratch):
                    k, v, ks, vs = kvs[i % COPIES]
                    err = fn(1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             ks.data_ptr() if quant else None,
                             vs.data_ptr() if quant else None,
                             alen.data_ptr(), out.data_ptr(),
                             scratch.data_ptr(),
                             scratch.data_ptr() + n * d * 4, b, t, kvh,
                             h // kvh, d, d ** -0.5, stream)
                    _build.check(err, "decode_attention")

                us = kernel_times(call)
                row.append(f"{chunk}: {us['split']:.1f} + {us['merge']:.1f} "
                           f"= {us['split'] + us['merge']:.1f}")
            print(f"{'int8' if quant else 'bf16'} K/V b={b} t={t} "
                  f"active_len={list(active)}: " + "; ".join(row),
                  flush=True)
            del kvs
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
