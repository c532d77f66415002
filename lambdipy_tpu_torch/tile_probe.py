"""Device time of the int8 matmul's tiled route under each tile shape.

Launches ``csrc/int8_matmul.cu`` with each tile shape of ``TILES``
forced and with the kernel's own pick (what ``ops.quant.int8_matmul``
launches), for the projections of llama3-8b at the row counts the
serving path gives it (short prompts, grouped prefills, the ~4,000-token
prompt), bf16 x, weight copies rotated past the 50 MB L2. Each time is a
kernel's own duration under ``torch.profiler``, so host time is left
out. The kernel's step times (``TM_STEP`` in ``csrc/int8_matmul.cu``)
come from these: a block's step time is its time over its waves and its
k steps. Run on a machine with an NVIDIA H100:

    python -m lambdipy_tpu_torch.tile_probe
"""

from __future__ import annotations

import subprocess

import torch

from lambdipy_tpu_torch.ops import _build
from lambdipy_tpu_torch.ops.quant import _launcher

# (k, n): q/o, k/v, gate/up, down of llama3-8b
SHAPES = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))
ROWS = (16, 128, 1024, 2048, 4096)
# the kernel's tile shapes (rows x columns of output per block), in the
# order of TM_SHAPES in csrc/int8_matmul.cu; -1 launches the kernel's pick
TILES = ((256, 128), (128, 128), (128, 64))
WEIGHT_BYTES = 160 << 20  # rotated weight copies: past the L2


def kernel_us(call, copies: int, calls: int = 20) -> float:
    """Mean device µs per call of ``call(i)``, from ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for i in range(2):
        call(i % copies)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            call(i % copies)
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / calls


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("tile_probe needs an NVIDIA CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    kernel_us(lambda i: torch.ones(1, device="cuda"), 1)  # warm the profiler
    print(f"{card}; device µs per call by tile shape "
          f"{dict(enumerate(TILES))} and the kernel's pick")
    for k, n in SHAPES:
        copies = max(1, min(16, -(-WEIGHT_BYTES // (k * n))))
        ws = [torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                            dtype=torch.int8) for _ in range(copies)]
        scale = torch.rand(1, n, generator=gen, device="cuda") / k
        for m in ROWS:
            x = torch.randn(m, k, generator=gen,
                            device="cuda").to(torch.bfloat16)
            out = torch.empty(m, n, dtype=x.dtype, device="cuda")
            row = []
            for shape in (-1, *range(len(TILES))):
                def call(i, shape=shape):
                    _build.check(_launcher()(
                        1, x.data_ptr(), ws[i].data_ptr(), scale.data_ptr(),
                        out.data_ptr(), m, k, n, shape, stream),
                        "int8_matmul")

                us = kernel_us(call, copies)
                row.append(f"{'pick' if shape < 0 else shape}: {us:.1f}")
            print(f"m={m} k={k} n={n}: " + "; ".join(row), flush=True)
        del ws
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
