"""Batch-1 decode rate of full-width ``llama3-8b`` under the port's three
serving configurations, with CUDA graphs and eagerly, over HTTP and
called directly, path after path.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python -m lambdipy_tpu_torch.decode_rate [--order B,A,C,A,B] [--profile]

Each path (A ``attn_backend="blocked"``, B ``blocked`` + ``kv_quant="int8"``,
C ``attn_backend="flash"``; int8 weights, bf16, seeded random weights) is
built from a fresh handler and served by the port's HTTP server, whose
decode steps replay captured CUDA graphs. A rate is 255 / (wall of a
256-token request - wall of a 1-token request) on the same 100-token
prompt (over 255 steps a slow short request moves it by a few percent),
read three times over HTTP, then three times through
``LlamaServer.generate`` with graphs and three times through an eager
server on the same weights (``LlamaServer(model, graphs=False)``), in
turns (graph, eager, eager, graph, ...), since the host's noise moves a
rate 30-70% between runs. Running a path twice in ``--order`` shows how
far the rate moves with the order and the host alone. ``--profile``
traces one request of the first path under ``torch.profiler`` and reads
its rates again, to see whether a profiler session slows the decode that
follows it. One JSON object per path goes to standard output, after the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
import urllib.request

import torch

PATHS = {"A": {"attn_backend": "blocked"},
         "B": {"attn_backend": "blocked", "kv_quant": "int8"},
         "C": {"attn_backend": "flash"}}
PROMPT = list(range(1, 101))
REPEATS = 3
TOKENS = 256


def post(url: str, body: dict) -> dict:
    req = urllib.request.Request(url + "/invoke",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


def rate(request) -> float:
    """Decode tokens per second of one row: ``request(n)`` generates ``n``
    new tokens and returns when they are done."""
    t0 = time.perf_counter()
    request(1)
    t1 = time.perf_counter()
    request(TOKENS)
    t2 = time.perf_counter()
    return (TOKENS - 1) / ((t2 - t1) - (t1 - t0))


def run_path(path: str, profile: bool) -> dict:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from lambdipy_tpu_torch.models.llama import LlamaServer
    from lambdipy_tpu_torch.runtime.handlers import (HandlerContext,
                                                     generate_handler)
    from lambdipy_tpu_torch.runtime.server import BundleServer

    state = generate_handler({"model": "llama3-8b", "extra": PATHS[path]},
                             HandlerContext(device="cuda"))
    server = BundleServer(state, port=0).start_background()

    def http(n):
        post(server.url, {"tokens": PROMPT, "max_new_tokens": n})

    eager = LlamaServer(state.server.model, graphs=False)

    def direct(n, srv=state.server):
        srv.generate([PROMPT], max_new_tokens=n)
        torch.cuda.synchronize()

    def graph_and_eager() -> dict:
        rates = {"graph_tok_s": [], "eager_tok_s": []}
        for i in range(2 * REPEATS):
            kind = ("graph", "eager", "eager", "graph")[i % 4]
            srv = state.server if kind == "graph" else eager
            rates[f"{kind}_tok_s"].append(
                rate(lambda n, srv=srv: direct(n, srv)))
        return rates

    try:
        direct(TOKENS)  # warm: captures the long request's graph
        direct(TOKENS, eager)
        out = {"path": path, **PATHS[path],
               "http_tok_s": [rate(http) for _ in range(REPEATS)],
               **graph_and_eager()}
        if profile:
            with torch_profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]):
                direct(8)
            out["after_profiler"] = {
                "http_tok_s": [rate(http) for _ in range(REPEATS)],
                **graph_and_eager()}
        out["programs"] = state.server.program_stats()
    finally:
        server.stop()
    del state, server, eager
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--order", default="B,A,C,A,B",
                    help="paths to serve, in order (A, B, C)")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_rate: no CUDA device available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60,
                         check=True).stdout.strip(), flush=True)
    for i, path in enumerate(args.order.split(",")):
        print(json.dumps(run_path(path, args.profile and i == 0)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
