"""Device time of the int8 matmul's GEMV under each split of k.

Launches the GEMV of ``csrc/int8_matmul.cu`` with 1 to 8 splits forced
and with the plan ``ops.quant.gemv_plan`` picks (what
``ops.quant.int8_matmul`` launches), for the projections of llama3-8b at
the row counts of a decode step (1, path D's 8 slots, 16), bf16 x (the
lm_head's f32 x), weight copies rotated past the 50 MB L2. Each time is
the kernel's own duration under ``torch.profiler``, so host time is left
out. The plan's aim (about one wave of two blocks on each SM, at most 8
splits) comes from these. Run on a machine with an NVIDIA H100:

    python -m lambdipy_tpu_torch.gemv_probe
"""

from __future__ import annotations

import subprocess

import torch

from lambdipy_tpu_torch.ops import _build
from lambdipy_tpu_torch.ops import quant as tq
from lambdipy_tpu_torch.tile_probe import WEIGHT_BYTES, kernel_us

# (k, n, x dtype): q/o, k/v, gate/up, down and the lm_head of llama3-8b
SHAPES = ((4096, 4096, torch.bfloat16), (4096, 1024, torch.bfloat16),
          (4096, 14336, torch.bfloat16), (14336, 4096, torch.bfloat16),
          (4096, 128256, torch.float32))
ROWS = (1, 8, 16)
SPLITS = (1, 2, 3, 4, 6, 7, 8)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("gemv_probe needs an NVIDIA CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    counters = torch.zeros(1 << 16, dtype=torch.int32, device="cuda")
    kernel_us(lambda i: torch.ones(1, device="cuda"), 1)  # warm the profiler
    print(f"{card}; device µs per call by splits (* the plan's pick)")
    for k, n, dtype in SHAPES:
        copies = max(1, min(16, -(-WEIGHT_BYTES // (k * n))))
        ws = [torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                            dtype=torch.int8) for _ in range(copies)]
        scale = torch.rand(1, n, generator=gen, device="cuda") / k
        pick = tq.gemv_plan(k, n)
        for m in ROWS:
            x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
            out = torch.empty(m, n, dtype=dtype, device="cuda")
            part = torch.empty(tq.GEMV_MAX_SPLITS, m, n, device="cuda")
            row, seen = [], set()
            for forced in SPLITS:
                splits, depth = tq.gemv_split(k, forced)
                if splits in seen:
                    continue
                seen.add(splits)

                def call(i, splits=splits, depth=depth):
                    _build.check(tq._gemv_launcher()(
                        tq._DTYPES[dtype], x.data_ptr(), ws[i].data_ptr(),
                        scale.data_ptr(), out.data_ptr(), part.data_ptr(),
                        counters.data_ptr(), m, k, n, splits, depth,
                        stream), "int8_matmul")

                us = kernel_us(call, copies)
                mark = "*" if (splits, depth) == pick else ""
                row.append(f"{splits}{mark}: {us:.1f}")
            print(f"k={k} n={n} m={m} {str(dtype)[6:]}: " + ", ".join(row),
                  flush=True)
        del ws
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
