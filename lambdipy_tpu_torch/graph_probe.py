"""What the compiled decode step (``models/graphs.py``) relies on in CUDA
graphs, probed on the card. Run from the root of a checkout on a machine
with one NVIDIA H100:

    python -m lambdipy_tpu_torch.graph_probe

- whether this PyTorch registers generators with a graph
  (``CUDAGraph.register_generator_state``), which sampled steps need;
- per-row generator draws captured once and replayed give the eager
  draws bitwise, also after one generator's state was replaced with
  ``set_state`` (a joiner taking a slot);
- a kernel of the port launched for the first time inside a capture;
- cuBLAS used for the first time inside a capture on a fresh stream, in
  a child process (a failed capture leaves the process's default
  generator unusable), and after a touch on that stream;
- host and device ms per replay of a graph of 1,000 small kernels.

One JSON object goes to standard output, after the card's name and
power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

# cuBLAS's first call inside a capture, optionally after a touch on the
# capture stream; prints whether the replay gave the eager product
_CUBLAS = """
import sys, torch
touch = sys.argv[1] == "touch"
side = torch.cuda.Stream()
a = torch.randn(8, 64, 128, device="cuda", dtype=torch.bfloat16)
b = torch.randn(8, 128, 300, device="cuda", dtype=torch.bfloat16)
torch.cuda.synchronize()
if touch:
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        z = torch.zeros(1, 8, 8, device="cuda", dtype=torch.bfloat16)
        torch.bmm(z, z)
    torch.cuda.current_stream().wait_stream(side)
g = torch.cuda.CUDAGraph()
try:
    with torch.cuda.graph(g, stream=side):
        c = torch.bmm(a, b)
    g.replay()
    torch.cuda.synchronize()
    print(bool(torch.equal(c, torch.bmm(a, b))))
except RuntimeError as e:
    print("failed: " + str(e).splitlines()[0])
"""


def draws(side) -> dict:
    """Captured per-row draws against eager ones, before and after a
    ``set_state``."""
    gens = [torch.Generator(device="cuda").manual_seed(100 + i)
            for i in range(3)]
    ref = [torch.Generator(device="cuda").manual_seed(100 + i)
           for i in range(3)]
    out = torch.empty(3, 1000, device="cuda")
    graph = torch.cuda.CUDAGraph()
    for g in gens:
        graph.register_generator_state(g)
    with torch.cuda.graph(graph, stream=side):
        out.copy_(torch.stack([torch.rand(1000, generator=g, device="cuda")
                               for g in gens]))

    def replays(n) -> bool:
        same = True
        for _ in range(n):
            graph.replay()
            want = torch.stack([torch.rand(1000, generator=g, device="cuda")
                                for g in ref])
            same &= bool(torch.equal(out, want))
        return same

    result = {"bitwise": replays(4)}
    joiner = torch.Generator(device="cuda").manual_seed(777)
    torch.rand(1000, generator=joiner, device="cuda")
    gens[1].set_state(joiner.get_state())
    ref[1].set_state(joiner.get_state())
    result["bitwise_after_set_state"] = replays(3)
    return result


def first_kernel_launch(side) -> bool:
    """The port's decode-attention kernel, built but never launched,
    launched first inside a capture: the replay against an eager call."""
    from lambdipy_tpu_torch.ops import decode_attention as tda

    q = torch.randn(2, 1, 32, 128, device="cuda", dtype=torch.bfloat16)
    k = torch.randn(2, 300, 8, 128, device="cuda", dtype=torch.bfloat16)
    v = torch.randn_like(k)
    active = torch.tensor([100, 300], dtype=torch.int32, device="cuda")
    tda._library()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        got = tda.blocked_decode_attention(q, k, v, active)
    graph.replay()
    torch.cuda.synchronize()
    return bool(torch.equal(got, tda.blocked_decode_attention(q, k, v,
                                                              active)))


def replay_ms(side, kernels: int = 1000, replays: int = 20) -> dict:
    """Host ms to enqueue one replay of a graph of ``kernels`` small
    kernels, and wall ms per replay to the card's end."""
    y = torch.zeros(10, device="cuda")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(kernels):
            y.add_(1)
    graph.replay()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(replays):
        graph.replay()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return {"kernels": kernels, "host_ms": 1e3 * (t1 - t0) / replays,
            "wall_ms": 1e3 * (t2 - t0) / replays}


def main() -> int:
    if not torch.cuda.is_available():
        print("graph_probe: no CUDA device available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60,
                         check=True).stdout.strip(), flush=True)
    side = torch.cuda.Stream()
    out = {"torch": torch.__version__, "register_generator_state": hasattr(
        torch.cuda.CUDAGraph, "register_generator_state")}
    if out["register_generator_state"]:
        out["draws"] = draws(side)
    out["first_kernel_launch_in_capture_bitwise"] = first_kernel_launch(side)
    for mode in ("cold", "touch"):
        res = subprocess.run([sys.executable, "-c", _CUBLAS, mode],
                             capture_output=True, text=True, timeout=300)
        out[f"cublas_first_call_in_capture_{mode}"] = (
            res.stdout.strip().splitlines() or [res.stderr.strip()[-200:]])[-1]
    out["replay"] = replay_ms(side)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
