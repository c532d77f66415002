#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``lambdipy_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which fails the run with a non-zero exit:

1. print the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel from ``lambdipy_tpu_torch/csrc`` (one ``nvcc``
   per source, in parallel) and print the ptxas report;
3. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes (the paged decode-attention kernel also bitwise
   against the contiguous one on the K/V gathered through its tables;
   every decode-attention row bitwise the same row launched alone at
   batch 1 with another capacity, and launch to launch; every row of the
   int8 matmul's tiled route bitwise the same row alone at m=16 and
   inside m=32/128/1024, and of its GEMV alone at m=1 and inside
   m=8/16/64; every flash-attention row bitwise alone at b=1 inside
   b=8), and time kernel, plain version and a library call that the
   port never uses (CUDA events, warmed, L2 defeated by rotating input
   copies; for decode attention, every GEMV row of the int8 matmul and
   the faster rows of its tiled route and of flash attention also the
   device time per call, and each time's fraction of the bound; the
   GEMV's device time summed over one decode step's 225 calls at 1, 8
   and 16 rows); then hold a small int8 model
   on the card against the same model on the CPU, under each path's
   backends and through the paged continuous engine;
4. the main path: full-width ``llama3-8b`` (int8 weights, bf16,
   ``matmul_backend="pallas"``, seeded random weights) served by the
   port's HTTP server from a fresh handler per path, every decode step
   and every prefill (the serving prefill, the engine's groups and long
   rows, a chunked row's chunks and tail, the prefix store's walk chunks,
   the prefix continuations) a replay of a captured CUDA graph
   (``models/graphs.py``, ``models/llama.py PrefillProgram``): each
   path's ``prefill_replays`` must equal the prefills it ran and none may
   run eagerly, and every graph pool is printed by its program's key. A-C
   also hold their prefills at 100 and ~4,000 tokens bitwise (first
   token, logprob, every layer's K/V) against an eager server's, greedy
   and sampled, and time the first token graph and eager in turns; D's
   chunked rows also run through an eager engine, and E's traffic
   through an eager server's paged engine and store, bitwise. D first, timed
   before any profiler session: the continuous engine over a paged KV
   arena (``batch_mode="continuous"``, ``kv_paged=1``, 8 slots, segment
   16) takes a burst of 8 concurrent requests (prompts of 16 to ~4,000
   tokens; greedy, seeded, logprobs, streamed, eos) and 4 more that join
   while it decodes; every row must equal solo generation, the same
   traffic through a dense engine on the same weights must give the same
   tokens and logprobs, the launch counters must equal the engine's
   steps and forwards, and the pool must drain to 0 live pages. Then A
   ``attn_backend="blocked"`` (float KV), B ``blocked`` with
   ``kv_quant="int8"``, C ``attn_backend="flash"``, B and C with a
   ~4,000-token prompt; A (m): 4 concurrent requests (greedy and seeded
   sampled, 20-31 prompt tokens, 16-32 new) through a MicroBatcher
   handler (``batch_window_ms = 2``, ``batch_max = 4``) on A's weights,
   every row bitwise its solo ``generate``, fewer calls than rows, the
   wall against the 4 one after another. Around each path the kernels' launch counters
   are set to 0 and must then equal what the path implies, and every
   decode step must have been a graph replay (the replays counted in the
   launch counters); each path's rows must be bitwise (tokens and
   logprobs) those of an eager server on the same weights (D: an eager
   paged engine taking the same traffic), and batch-1 decode tok/s is
   read with graphs and eagerly in turns; the served logits of A-C are
   held against the plain PyTorch model on the card, and one request
   (one engine burst for D) is traced with ``torch.profiler`` (device
   busy time by kernel, idle share). A-D run with the prefix store off
   (``prefix_cache_mb=0``). Last, E: D's paged engine with the prefix
   store at the handler's default (512 MB), 8 requests sharing a
   2,048-token head (one cold, 7 together, then a full hit): every row
   bitwise its solo routed run, paged bitwise a dense engine with an
   assembling store, the store's counters and the launch counters the
   traffic's, the pool left holding the store's pages alone; routed
   against unrouted printed, and the TTFT cold, hot and unrouted.
   D runs at the serving defaults: every request passes the SLO
   scheduler (``fair``) into an engine at pipeline depth 2; D (f) holds
   every row of a depth-1 engine bitwise the depth-2 engines', and the
   same burst is driven directly at depths 2, then 1 (tok/s and TTFT
   printed), with the depth-2 engine's ``pipeline`` block. D's engine
   buckets its decode windows (the handler's default, as in JAX): its
   ``decode_window`` is printed, ``savings_ratio`` < 1; D (j) drives the
   burst through a paged engine with ``batch_window_bucketing = "0"``:
   every row bitwise the bucketing engines', the full window its only
   bucket, tok/s and ``compile_count`` beside the bucketing engine's;
   D (k) boots a 1-layer bf16 twin of llama3-8b (``draft_twin``) and
   drives the burst of 8 through a paged engine at ``spec_k = 8``,
   ``draft_mode = "aux"``: every row bitwise spec off, the launches 225 x
   the target's forwards, 32 x its steps and 1 x the twin's decode steps
   on kernel 1; the aux counters, tok/s, the twin's boot and memory and a
   proposal's wall printed. D's chunked
   turns drive the same burst through paged depth-2 engines with
   ``prefill_chunk`` off, 512, 512, off (the long rows walk 512-token
   chunks between the engine's segments): tok/s, steps, segments
   dispatched during walks, TTFT of the rows that arrive while the
   ~4,000-token row prefills and of the long rows; D (g) holds every
   chunked row, paged and dense at depths 2 and 1, bitwise its solo
   ``generate(row[split:], prefix=row[:split])``, D (h) its greedy
   tokens and first logprob within the routed bound of plain solo
   ``generate``, D (i) the launch counters each turn's steps and
   forwards, walk chunks counted. E also walks its head cold at the
   store's default width and at ``prefill_chunk=512``. F, on D's
   handler behind a second server with 2 run slots and a queue of 2:
   ``/v1/completions`` against ``/invoke`` and its SSE stream, a burst
   of 8 shed ``queue_full`` past concurrency plus queue, a deadline
   shed, interactive granted before background, and ``/shutdown``
   draining; its launch counters from 0 equal what the engine implies.
   G, the engine's fault isolation on D's handler (a fresh server), engine
   and weights: (a) ``segment_fetch:exception@seg=3`` armed over ``POST
   /v1/debug/faults`` under D's burst of 8 (two rows streamed): every row
   that had sent nothing replays bitwise its solo run and D's unfaulted
   row, a streamed row that got a chunk ends with the injected error, the
   pool drains, the recovery time printed; (b) ``engine_watchdog_s`` 1.0
   and nothing injected: a 1.7 s ``torch.cuda._sleep`` on the serving
   stream between two segments trips the wait within 1.5 s, ``/healthz``
   reads not ready and wedged, a request meanwhile is shed 503 ``wedged``
   with ``Retry-After``, the replayed row is bitwise solo and ``ready``
   returns; with ``max_replays=0`` the waiter gets the timeout within the
   same bound and the self-probe clears the wedge; (c) two failures step
   the ladder to 1, the replay runs at depth 1 bitwise, a clean interval
   restores it; (f) three failures step it to 2, where the replay's
   segments run at the full window alone, bitwise solo, and a clean
   interval restores it; (e) D's burst at the defaults (no wait polled), its tok/s
   beside D's; (d) E's traffic routed through a store over a second paged
   engine on the same server, every row bitwise its unfaulted routed run
   after ``segment_fetch:exception@seg=2``. Each phase's launch counters,
   from 0, equal its engine steps and forwards. Last, I: the prefix
   store's ship, offload and session tiers on three handlers sharing one
   copy of the weights (D's paged engine, the store at 512 MB): (a) A
   exports E's 2,048-token head over ``/v1/kv/export`` (its body checked
   against 2,048 x 32 x 2 x 8 x 128 x 2 B), B imports the frame and O
   the same head as a chunked stream, and both route the head plus a
   suffix with no walk, bitwise A's routed run; a truncated frame is a
   400 that leaves the tree alone, an import into a full arena the 503
   ``kv_import``; encode, decode, import and export to first token are
   timed; (b) D's long joiners through O's small arena (``kv_offload``)
   spill the head, its next request re-onlines it bitwise (timed per
   page against a pinned ``copy_``), and under ``offload_stall`` the
   head is walked again bitwise; (c) a three-turn ``x-session-id``
   conversation on B hits its pinned head past other heads pushed over
   the budget and an injected engine failure, a new session past the
   pin budget is the 503 ``session_pins``, and ``DELETE`` brings the pin
   gauges to 0; its launch counters equal 225 x forwards and 32 x steps.
   D's warm turns (after G, D's engine and programs released): D's
   traffic over HTTP through fresh handlers on D's weights, after the
   background warm (``warm_group_prefill`` on, ready by ``/healthz``) and
   with it off, warm then cold: tok/s, the joiners'
   TTFT, the pool bytes before and after the warm against
   ``program_cache_bytes``; every row D's, launches 32 x steps and 225 x
   forwards (the warm's prefills counted). Last, J: the long-context tier
   (``max_logical_ctx=32768``, a 4 GiB host offload arena, the store at
   512 MB): (a) at base 0 a 6,000-token row through the runner bitwise
   the engine's chunked row over the same chunk schedule; a 32,768-token
   request (4x the window) over HTTP (b) twice, (c) churned under
   ``resident_cap`` and (d) churned under an armed ``offload_stall``
   (the run replays), each bitwise the first; (e) kernel 2 = 225 x
   forwards, kernel 3 = 32 x decode steps; (f) no page leaked; TTFT,
   decode tok/s past the window, spill and re-online throughput, stalls
   and peak memory printed. Last, K: the port serves a bundle written
   without JAX (D's paged engine, the warm on): (a) ``params.fpk`` from
   seeded random weights under the flax paths, ``manifest.json`` with the
   payload JAX's builder writes, ``handler.py`` in its template's text,
   in a temporary directory (free space, bytes and write time printed);
   (b) ``load_bundle`` on the card: every tensor equal to the one it was
   written from, 4 prompts greedy and seeded sampled (logprobs on)
   bitwise a handler built from the same weights; (c) ``python -m
   lambdipy_tpu_torch serve <bundle> --port 0`` once (beside the walls
   of fresh interpreters importing torch and the port's server): spawn
   to the readiness line and its cold-start stages, spawn to ``/healthz``
   ready, the boot fields (``skew``: the host's own check of the
   manifest's record, ``handler_meta``), 30 invokes of 100 tokens in and 16 out (p50, p99) bitwise
   (b)'s, the kernels' counters from ``/metrics``, and SIGTERM with a
   request in flight: it finishes 200 and the process exits 0; (d) ``POST
   /profile`` writes a trace (its device kernel events counted). Last, L:
   the BASELINE's configs 1-4 from bundles written without JAX at the
   recipes' widths: (a) ``resnet50`` (224 x 224 x 3, bf16, seeded batch
   norms so that every residual branch counts), ``bert-base`` (128
   tokens, bf16), ``bert-base-torch`` (``model.pt``, f32), ``hello`` and,
   where sklearn and joblib import, ``tabular``; (b) each booted in
   process on the card: every tensor equal to the one written, the
   compiled forward (a CUDA graph) bitwise the eager card forward, the
   card's logits against the port's CPU f32 forward of the same weights
   within ``L_CPU_BOUND`` with the top-1 equal, one forward's device time
   replayed and eager against its bound; (c) ResNet-50 and BERT-base as
   ``python -m lambdipy_tpu_torch serve <bundle>`` processes: spawn to
   the readiness line and its stages, 50 and 30 invokes of a
   ``{"random": true}`` body and of a real one (p50, p99, against the <
   15 ms and < 10 s targets), every answer (b)'s, SIGTERM exits 0; the
   kernels' counters read 0 (no TPU kernel is on this path). Then P:
   Llama-3-8B's HF checkpoint at its published widths, 2 of its 32
   layers (vocabulary 128,256, untied), bf16, written by the script's
   own safetensors writer (2 shards and their index, ~2.97 GB) in a
   thread beside the kernel checks, which also builds the bundle's
   params from it (``models/convert.py save_hf_params(quant="int8")``)
   and holds the converted tree bitwise the written tensors transposed;
   (c) ``params.fpk`` bitwise ``quantize_params`` on the card; (d) the
   bundle (``llama-hf``, ``params = "hf"``) booted in process; (e) 4
   concurrent requests through its paged engine bitwise their solo
   ``generate``, the tokens and logprobs bitwise a 2-layer ``llama3-8b``
   server loading the same ``params.fpk`` through ``models/params.py``,
   each phase's launches 15 int8 matmuls a forward and 2 decode-attention
   launches a step. Then Q: ``llama3-8b`` with ``moe_experts = 8`` (
   Mixtral-8x7B's experts: top 2, 4,096 x 14,336) in int8 at 2 of 32
   layers, the weights drawn on the card: (a) a 200-token prefill and 16
   decode steps finite, ``blocked`` / ``pallas`` against ``dense`` /
   ``xla`` (logit cosine and max |diff| against ``Q_COSINE_MIN``,
   ``Q_REL_MAX``); (b) each layer's seats against an independent count
   (seated + dropped = top_k x tokens); (c) a burst of 4 concurrent
   requests through a paged engine completes, 9 int8 matmuls a forward
   (the experts are einsums) and 2 decode-attention launches a step; (d)
   the batch-1 step time and the experts' per-call dequantisation. Then R,
   training: llama3-8b at its published widths, 2 of 32 layers, bf16
   float weights drawn on the card, batch 4 x 512 tokens from a token
   file the script writes, through the port's ``Trainer`` (adamw, the
   clip at 1.0): (a) eight steps, the loss falls, each step's wall, the
   median after the first, tokens/s, 6 N T a step over 989 TFLOP/s, the
   peak memory; (b) 4 steps, a checkpoint and a new ``Trainer`` resuming
   to 8, bitwise (a) (params, optimizer state, logged rows), the
   checkpoint's bytes and its save and restore times; (c) the f32
   ``llama-tiny`` four steps on the card against the CPU within
   ``R_TINY_TOL``; (d) no kernel launched. Last, M:
   the bundle lifecycle through ``python -m lambdipy_tpu_torch``, every
   command a process under a fresh ``HOME`` and an empty kernel build
   cache (``LAMBDIPY_KERNEL_CACHE``): (b) ``recipes`` lists the ten
   twins; (c) ``build`` of ``hello-numpy``, ``jax-resnet50`` and
   ``jax-bert`` at once into the registry (wall, stages, bytes, prune savings,
   the warm record), a second build the cache hit; (d) each deployed by
   name under the watchdog, the three at once (``deploy_wall_s``, ``cold_start``),
   ``bench`` 20 / 50 / 30 times (p50, p99), its answers bitwise an
   in-process boot of the same bundle; (e) the ResNet server SIGKILLed,
   respawned on the same port, the time to ``/healthz`` ready, answers
   as before; (f) ``publish`` to a protected store (refused without the
   token), ``releases`` lists both assets, a second pack the asset's
   bytes, a fresh registry's ``build jax-resnet50`` fetching the
   prebuilt and its ``deploy``; (g) ``jax-llama3-8b`` built with
   ``--out`` (8.56 GB, the warm on), deployed by directory, 30 invokes
   of 100 in and 16 out, greedy tokens and logprobs bitwise an
   in-process ``generate`` on the bundle's weights, ``int8_matmul`` =
   225 x forwards from ``/metrics``, the bundle kept for N; (h) ``doctor``
   reads the card and every deployment healthy, ``stop`` each, no
   deployment, no server process, the card's free memory back within 1
   GiB; (i) ``package`` of numpy (a recipe) and einops (plain). Last, N:
   the fleet, ``python -m lambdipy_tpu_torch fleet`` over M (g)'s bundle
   (a twin whose manifest and ``handler.py`` give the model the engine's
   2,048-position window, so the prefix store runs), two decode-class
   replicas and one prefill-class, ``LAMBDIPY_KV_PAGED=1``, the
   controller in dry run: (a) the readiness line, each replica's
   ``cold_start``, the card's free memory; (b) 8 requests on one
   1,024-token head all on the port's ``pick_replica``, its store's hits,
   greedy tokens equal an in-process ``generate``, the first logprob
   within 0.05; (c) a cold head shipped, pipelined, to the decode
   replica, whose answer is bitwise the prefill replica's; (d) two
   three-turn sessions, the home's worker SIGKILLed, the failed-over
   turn bitwise the other session's, ejection and readmission timed,
   pins 0 after ``DELETE``; (e) D's burst (prompts cut to the window)
   through the router, then again with a decode worker SIGKILLed in
   flight: every non-streamed request answered, the broken stream an
   error (the same burst to one replica alone is left out for time); (f) a second router over the same replicas
   with the ``kv_ship`` and ``route_connect`` sites armed: the fallback
   and the retry counted; (g) the controller's decisions and no
   snapshot field None beyond the ROADMAP's list; (h) the replicas'
   ``handler.kernels`` = 225 x forwards and 32 x decode steps; (i)
   SIGTERM leaves no replica process and the card's memory back within 1
   GiB. Last, O: the chaos soak (``lambdipy_tpu_torch/chaos/``) on a
   twin of M (g)'s bundle with JAX's soak extras (4 slots, segment 8, 8
   new tokens, 32-token blocks, ``max_len`` the engine's 2,048; the
   store's and the offload arena's MB scaled from JAX's tiny soak to as
   many blocks of llama3-8b K/V): (a) ``SoakFleet``, r0 dense and r1
   paged (64 pages, ``LAMBDIPY_KV_OFFLOAD=1``) spawned at once, the
   in-process reference answering the plan beside the boot; (b)-(e) one
   window, seed 11, 12 s, ``offload_stall`` in the schedule, JAX's whole
   oracle: every request delivered bitwise or an explicit failure (0
   silent), the SIGKILL and the drain applied, >= 2 faults overlapping
   for >= 1 s, quiesce converged, the post-storm completion bitwise, the
   canary, the timeline JAX's for the seed, the kill's respawn timed; (f)
   the post-storm row on each replica alone; (g) each process's
   ``handler.kernels`` = 225 x forwards and 32 x decode steps; (h)
   teardown leaves no process and the card's memory back within 1 GiB.
   O runs under a ceiling of its own (120 s), checked at the end of each
   stage (boot, references, window, quiesce, teardown).

   Cut for time: B, C, E, H, I and J serve llama3-8b at its published
   widths with 8 of its 32 layers (``CUT_LAYERS``), every check kept, each
   byte budget (store, offload arena, pins) scaled with the depth so that
   it holds the same blocks; P, Q and R at 2 (``HF_LAYERS``,
   ``R_LAYERS``); A, D-G and
   K-O run at full depth. After each
   path the script prints the seconds since it started; at 1,150 s a
   guard prints the path and stage in progress, stops every process the
   script started and exits 3;
5. print the whole script's time, the kernels' JSON line and, last, the
   device line.

Details go to ``chiprun_out/chip_smoke.json``. With no CUDA device, or
without the rest of the repository beside it, the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch

BW = 3.35e12        # H100 SXM HBM3 bytes/s (data sheet)
BF16_PEAK = 989e12  # H100 SXM dense bf16 tensor-core flop/s (data sheet)
OUT_DIR = Path("chiprun_out")
L2_DEFEAT_BYTES = 160 << 20  # rotate input copies past the 50 MB L2


# the whole script's guard: past this many seconds it names the path and
# stage in progress, stops every process it started and exits non-zero
# (the limit the script runs under is 1,200 s)
SCRIPT_GUARD_S = 1150.0
# what runs now, for the guard: the path, its stage where it names one, and
# the last line printed
PROGRESS = {"t0": time.perf_counter(), "path": "start", "stage": "",
            "last": ""}


def log(*args):
    text = " ".join(str(a) for a in args)
    PROGRESS["last"] = text[:300]
    print(text, flush=True)


def took(what: str, t_start: float) -> None:
    """The line after a path: its seconds and the script's running total."""
    now = time.perf_counter()
    log(f"{what} took {now - t_start:.1f} s; {now - PROGRESS['t0']:.1f} s "
        f"since the script started")


def _timed(what: str, fn, *args):
    """``fn(*args)``, its seconds logged as :func:`took` logs them."""
    t_start = time.perf_counter()
    out = fn(*args)
    took(what, t_start)
    return out


def _descendants() -> list:
    """Every live process below this one, parents before their children."""
    kids: dict = {}
    for entry in Path("/proc").iterdir():
        if not entry.name.isdigit():
            continue
        try:
            status = (entry / "status").read_text()
        except OSError:
            continue
        for line in status.splitlines():
            if line.startswith("PPid:"):
                kids.setdefault(int(line.split()[1]), []).append(
                    int(entry.name))
                break
    out, todo = [], [os.getpid()]
    while todo:
        for pid in sorted(kids.get(todo.pop(0), ())):
            out.append(pid)
            todo.append(pid)
    return out


def start_guard(limit_s: float = SCRIPT_GUARD_S) -> None:
    """At ``limit_s`` since the script started: print the path and stage in
    progress, SIGKILL every process below this one (twice: a supervisor
    killed between the passes respawns nothing) and exit 3."""
    def fire():
        elapsed = time.perf_counter() - PROGRESS["t0"]
        text = (f"chip_smoke: {elapsed:.1f} s since the script started, past "
                f"its {limit_s:.0f} s guard, in path {PROGRESS['path']} "
                f"(stage {PROGRESS['stage'] or '-'}; last line "
                f"{PROGRESS['last']!r}); exiting")
        print(text, flush=True)
        print(text, file=sys.stderr, flush=True)
        for _ in range(2):
            for pid in _descendants():
                try:
                    os.kill(pid, signal.SIGKILL)
                except OSError:
                    pass
        os._exit(3)

    timer = threading.Timer(
        max(0.0, limit_s - (time.perf_counter() - PROGRESS["t0"])), fire)
    timer.daemon = True
    timer.start()


def cuda_time(fn, n_copies: int = 1) -> float:
    """Mean ms per call of ``fn(i)`` (``i`` picks an input copy), warmed,
    timed with CUDA events over enough calls to fill ~200 ms."""
    fn(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn(1 % n_copies)
    end.record()
    torch.cuda.synchronize()
    one = max(start.elapsed_time(end), 1e-3)
    iters = max(3, min(200, int(200.0 / one)))
    start.record()
    for i in range(iters):
        fn(i % n_copies)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_time(fn, n_copies: int = 1, calls: int = 20) -> float:
    """Mean device ms per call of ``fn(i)``, host time left out: the
    stream is held by a sleep kernel while the host enqueues all
    ``calls`` calls, then CUDA events time them running back to back
    (launch gaps on the card included). ``cuda_time`` of eager calls
    this small measures how fast the host enqueues them; this measures
    the card. The calls' launches must fit the card's launch queue (a
    plain version of ~30 small kernels takes fewer calls). Fails if the
    host did not get ahead of the card."""
    fn(0)
    torch.cuda.synchronize()
    held, start, end = (torch.cuda.Event(enable_timing=True)
                        for _ in range(3))
    tries = []
    for cycles in (50_000_000, 400_000_000, 3_000_000_000):  # ~30 ms-2 s
        held.record()
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        start.record()
        for i in range(calls):
            fn(i % n_copies)
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        tries.append((host_ms, held.elapsed_time(start)))
        if host_ms < tries[-1][1]:
            return start.elapsed_time(end) / calls
    raise SystemExit(f"device_time: the host did not enqueue ahead of the "
                     f"card (host ms, held ms: {tries})")


def copies_for(nbytes: int) -> int:
    return max(1, min(32, -(-L2_DEFEAT_BYTES // max(nbytes, 1))))


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / BW * 1e3, flops / BF16_PEAK * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def row_rel_err(out, ref) -> float:
    """Attention kernel against a plain version, per query row (one
    head's d-vector): max over rows of max |out - ref| / rms(ref row).
    Attention outputs shrink as a row's window grows (rms ~ sqrt(e / n)
    for N(0, 1) inputs over n positions: 0.026 at 4,100), so a limit in
    absolute terms that holds the short rows would pass a wrong long row.
    Dropping one 64-position tile of a 4,100-position row moves each
    element by ~sqrt(64 / 4100) = 0.125 rms, the row's max by ~0.4 rms
    (an estimate)."""
    diff = (out.float() - ref.float()).abs().amax(-1)
    rms = ref.float().square().mean(-1).sqrt()
    return (diff / rms).max().item()


def solo_copy(x, r: int, n: int, cap: int):
    """Row ``r`` of a cache ``[b, t, ...]`` alone at batch 1 with capacity
    ``cap``: its first ``n`` positions copied, every later one NaN (0 for
    int8, whose scales are NaN there), so a kernel that read past ``n``
    would return NaN."""
    fill = 0 if x.dtype == torch.int8 else float("nan")
    y = torch.full((1, cap, *x.shape[2:]), fill, dtype=x.dtype,
                   device=x.device)
    y[:, :n] = x[r:r + 1, :n]
    return y


def rows_invariant(batched, out, solo, active) -> bool:
    """The batch-invariance the serving engine rests on: a second launch
    of ``batched()`` is bitwise ``out``, and each row ``r`` launched alone
    (``solo(r, cap)``, at batch 1 with a capacity other than the batch's)
    is bitwise ``out[r]``."""
    same = torch.equal(batched(), out)
    for r, n in enumerate(active):
        cap = n + 64 + 37 * r  # another t per row, past the row's length
        same = same and torch.equal(solo(r, cap), out[r:r + 1])
    return bool(same)


# ------------------------------------------------------------------ phase 3

DECODE_HEADS = (32, 8, 128)  # h, kvh, d of llama3-8b
# path D's decode shape (both engines): 8 slots over an 8,192-position
# window, slot 0 idle at active_len 1 (all-null table when paged), the
# others at the last lengths of seven of its burst rows (prompt + new)
ENGINE_SHAPE = (8, 8192, (1, 144, 164, 532, 1040, 2024, 4032, 180))
# (b, t, active_len): a ragged batch of 4 (the kernels line's shape), the long
# row of paths B and C (bucket 4096 + 32 decode steps) and path D's
DECODE_SHAPES = ((4, 544, (1, 129, 300, 544)), (1, 4128, (4100,)),
                 ENGINE_SHAPE)
# limits on row_rel_err, kernel against plain. bf16: the two round the
# probabilities to bf16 at other scales (the kernel before its final
# division), and their outputs differ by up to one bf16 ulp, at most
# 2^-7 of the value: ~0.03 of the rms at a row's peak of 3-4.5 rms.
# Measured on an H100 (NVIDIA H100 80GB HBM3, 700 W): 0.020-0.028 at
# both shapes, float and int8 K/V. f32: summation order, measured up to
# 7.8e-6. Int8 K/V are dequantized with the same rounding by both.
DECODE_TOL = {torch.bfloat16: 0.05, torch.float32: 1e-4}


def _decode_operands(gen, b, t, dtype, quant):
    """q and (k, v) or (k_int8, v_int8, k_scale, v_scale) for one call;
    int8 K/V quantized by the model's own ``_kv_quantize``."""
    from lambdipy_tpu_torch.models.llama import _kv_quantize

    h, kvh, d = DECODE_HEADS
    q = torch.randn(b, 1, h, d, generator=gen, device="cuda").to(dtype)
    k = torch.randn(b, t, kvh, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(b, t, kvh, d, generator=gen, device="cuda").to(dtype)
    if not quant:
        return q, {"k": k, "v": v}
    (k8, ks), (v8, vs) = _kv_quantize(k), _kv_quantize(v)
    return q, {"k": k8, "v": v8, "k_scale": ks, "v_scale": vs}


def check_decode_attention(gen, quant: bool) -> dict:
    """Decode attention over float K/V (``quant`` False, kernel 1) or int8
    K/V with f32 scales (kernel 1b): kernel against plain at both
    ``DECODE_SHAPES`` in bf16 and f32, then timed in bf16 at both."""
    import torch.nn.functional as F

    from lambdipy_tpu_torch.ops.decode_attention import (
        blocked_decode_attention, decode_attention_reference)

    def plain(q, kv, alen):
        return decode_attention_reference(q, *plain_kv(kv, q.dtype, quant),
                                          alen)

    def kernel(q, kv, alen):
        scales = ({"k_scale": kv["k_scale"], "v_scale": kv["v_scale"]}
                  if quant else {})
        return blocked_decode_attention(q, kv["k"], kv["v"], alen, **scales)

    name = "decode_attention_int8kv" if quant else "decode_attention"
    dev = "cuda"
    h, kvh, d = DECODE_HEADS
    results, timings = {}, []
    for b, t, active in DECODE_SHAPES:
        alen = torch.tensor(active, dtype=torch.int32, device=dev)
        for dtype in (torch.bfloat16, torch.float32):
            tol = DECODE_TOL[dtype]
            q, kv = _decode_operands(gen, b, t, dtype, quant)
            out = kernel(q, kv, alen)
            ref = plain(q, kv, alen)
            # active_len 0: the plain version's uniform mean of V
            zero = alen.clone()
            zero[0] = 0
            out0, ref0 = kernel(q, kv, zero), plain(q, kv, zero)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            rel, rel0 = row_rel_err(out, ref), row_rel_err(out0, ref0)
            invariant = rows_invariant(
                lambda: kernel(q, kv, alen), out,
                lambda r, cap: kernel(
                    q[r:r + 1], {n: solo_copy(x, r, active[r], cap)
                                 for n, x in kv.items()}, alen[r:r + 1]),
                active)
            key = f"b={b} t={t} {dtype}"
            log(f"{name} {key}: max_abs_err {err:.3e}; per row, max |diff| "
                f"/ rms {rel:.3e} (active_len 0 case {rel0:.3e}), "
                f"tolerance {tol}; every row bitwise alone at batch 1 "
                f"with another t, and launch to launch: {invariant}")
            if not (rel <= tol and rel0 <= tol and invariant):
                raise SystemExit(f"{name} disagrees with its plain version "
                                 f"at {key}: {rel}, {rel0} > {tol}, or is "
                                 f"not batch-invariant ({invariant})")
            results[key] = {"max_abs_err": err, "row_rel_err": rel,
                            "row_rel_err_len0": rel0, "tolerance": tol,
                            "batch_invariant": invariant}

        # timing in bf16, K/V copies rotated past L2 (by the active K/V,
        # the bytes the kernel reads)
        dtype = torch.bfloat16
        positions = int(alen.sum().item())
        per_pos = kvh * (d + 4 if quant else 2 * d)  # K or V, with scale
        n = copies_for(2 * positions * per_pos)
        q = torch.randn(b, 1, h, d, generator=gen, device=dev).to(dtype)
        kvs = [_decode_operands(gen, b, t, dtype, quant)[1]
               for _ in range(n)]
        ms = cuda_time(lambda i: kernel(q, kvs[i], alen), n)
        plain_ms = cuda_time(lambda i: plain(q, kvs[i], alen), n)
        # library yardstick: SDPA over the length-masked window, GQA
        # native, on K/V dequantized to bf16 beforehand
        qt = q.transpose(1, 2)
        deq = [plain_kv(kv, dtype, quant) for kv in kvs]
        kts = [k.transpose(1, 2) for k, _ in deq]
        vts = [v.transpose(1, 2) for _, v in deq]
        mask = (torch.arange(t, device=dev)[None, :]
                < alen[:, None])[:, None, None]
        library_ms = cuda_time(lambda i: F.scaled_dot_product_attention(
            qt, kts[i], vts[i], attn_mask=mask, enable_gqa=True), n)
        dms = {"kernel": device_time(lambda i: kernel(q, kvs[i], alen), n),
               "plain": device_time(lambda i: plain(q, kvs[i], alen), n,
                                    calls=6),
               "sdpa": device_time(lambda i: F.scaled_dot_product_attention(
                   qt, kts[i], vts[i], attn_mask=mask, enable_gqa=True), n)}
        del deq, kts, vts, kvs
        nbytes = 2 * q.numel() * 2 + 2 * positions * per_pos + b * 4
        bound_ms, bound_by = bound(nbytes, 4.0 * positions * h * d)
        shape = (f"b={b} h={h} kvh={kvh} d={d} t={t} "
                 f"active_len={list(active)} bf16"
                 + (" int8 K/V" if quant else ""))
        log(f"{name} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}; the kernel at {bound_ms / ms:.3f} of it); "
            f"device time per call: kernel {dms['kernel']:.4f} ms "
            f"({bound_ms / dms['kernel']:.3f} of the bound), plain "
            f"{dms['plain']:.4f} ms, sdpa {dms['sdpa']:.4f} ms")
        timings.append({"shape": shape, "ms": ms, "plain_ms": plain_ms,
                        "library_ms": library_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by,
                        "bound_fraction": bound_ms / ms,
                        "device_ms": dms,
                        "device_bound_fraction": bound_ms / dms["kernel"]})
        torch.cuda.empty_cache()
    results["verify row map"] = check_row_map(gen, quant, kernel, plain)
    line = timings[0]
    return {"name": name, "route": "cuda",
            "source": "lambdipy_tpu_torch/csrc/decode_attention.cu",
            "replaces": ("lambdipy_tpu/ops/decode_attention.py:133"
                         if quant else
                         "lambdipy_tpu/ops/decode_attention.py:110"),
            "shape": line["shape"],
            "max_abs_err": max(r["max_abs_err"] for r in results.values()),
            "ms": line["ms"], "plain_ms": line["plain_ms"],
            "bound_ms": line["bound_ms"], "bound_by": line["bound_by"],
            "library_ms": line["library_ms"], "checks": results,
            "timings": timings}


VERIFY_KB = 8  # path H's verify width: 8 slots x 8 = 64 one-token rows


def check_row_map(gen, quant: bool, kernel, plain) -> dict:
    """The contiguous kernel's row map at a verify of path D's engine
    shape: each of its 8 rows' kb = 8 one-token rows at ``active_len +
    j`` over the row's cache row. Against the plain version (the map
    read as a gather) within the tolerance, and bitwise the kernel
    launched on K/V gathered row by row (the map moves only where a row
    reads from); the device time per call against the spec-off step's
    8-row call."""
    from lambdipy_tpu_torch.ops.decode_attention import (
        blocked_decode_attention, map_rows)

    b, t, active = ENGINE_SHAPE
    h, _, d = DECODE_HEADS
    kb = VERIFY_KB
    dtype = torch.bfloat16
    q, kv = _decode_operands(gen, b * kb, t, dtype, quant)
    kv = {n: x[:b].contiguous() for n, x in kv.items()}
    row_map = torch.arange(b, dtype=torch.int32,
                           device="cuda").repeat_interleave(kb)
    alen = (torch.tensor(active, dtype=torch.int32,
                         device="cuda").repeat_interleave(kb)
            + torch.arange(kb, dtype=torch.int32, device="cuda").repeat(b))
    scales = ({"k_scale": kv["k_scale"], "v_scale": kv["v_scale"]}
              if quant else {})

    def mapped():
        return blocked_decode_attention(q, kv["k"], kv["v"], alen,
                                        row_map=row_map, **scales)

    out = mapped()
    gathered = {n: x.contiguous() for n, x in zip(
        kv, map_rows(row_map, *kv.values()))}
    alone = kernel(q, gathered, alen)
    ref = plain(q, gathered, alen)
    torch.cuda.synchronize()
    rel = row_rel_err(out, ref)
    err = (out.float() - ref.float()).abs().max().item()
    bitwise = bool(torch.equal(out, alone))
    del gathered, alone, ref
    torch.cuda.empty_cache()
    verify_ms = device_time(lambda i: mapped())
    step_alen = torch.tensor(active, dtype=torch.int32, device="cuda")
    step_ms = device_time(lambda i: kernel(q[:b], kv, step_alen))
    name = "decode_attention_int8kv" if quant else "decode_attention"
    log(f"{name} verify row map, {b} rows x kb={kb} over b={b} t={t} "
        f"bf16: per row, max |diff| / rms {rel:.3e}, tolerance "
        f"{DECODE_TOL[dtype]}; bitwise the kernel on K/V gathered row by "
        f"row: {bitwise}; device time per call {verify_ms:.4f} ms against "
        f"{step_ms:.4f} ms for the {b}-row step")
    if not (rel <= DECODE_TOL[dtype] and bitwise):
        raise SystemExit(f"{name}'s row map disagrees: {rel}, bitwise "
                         f"{bitwise}")
    return {"max_abs_err": err, "row_rel_err": rel,
            "bitwise_gathered": bitwise,
            "verify_device_ms": verify_ms, "step_device_ms": step_ms}


def plain_kv(kv, dtype, quant):
    """(k, v) in ``dtype``: int8 K/V dequantized as the kernel does."""
    from lambdipy_tpu_torch.ops.decode_attention import dequantize_kv

    if not quant:
        return kv["k"], kv["v"]
    return (dequantize_kv(kv["k"], kv["k_scale"], dtype),
            dequantize_kv(kv["v"], kv["v_scale"], dtype))


PAGE = 32           # the engine's page (page_width(8192, 32))
ARENA_PAGES = 4096  # phase 3's arena: a few thousand pages of garbage


def idle_rows(b: int, t: int) -> tuple:
    """Rows that stand for empty engine slots: slot 0 at path D's shape."""
    return (0,) if (b, t) == ENGINE_SHAPE[:2] else ()


def _paged_arena(gen, dtype, quant):
    """An arena of ``ARENA_PAGES`` random pages in the engine's layout:
    every page (the null page and the ones no table names included)
    holds finite values, so a wrong page id reads a wrong number."""
    from lambdipy_tpu_torch.models.llama import _kv_quantize

    _, kvh, d = DECODE_HEADS
    shape = (ARENA_PAGES, PAGE, kvh, d)
    out = {}
    for name in ("k", "v"):
        x = torch.randn(shape, generator=gen, device="cuda")
        if quant:
            out[name], out[f"{name}_scale"] = _kv_quantize(x)
        else:
            out[name] = x.to(dtype)
        del x
    return out


def _paged_tables(rng, b, nb, active, idle=()):
    """Shuffled non-identity block tables: each row's pages drawn from a
    permutation of the arena, entries past its length the null page;
    rows in ``idle`` (empty engine slots) all null."""
    perm = torch.randperm(ARENA_PAGES - 1, generator=rng) + 1
    tables = torch.zeros(b, nb, dtype=torch.int32)
    for r, n in enumerate(active):
        if r in idle:
            continue
        used = min(nb, -(-max(int(n), 1) // PAGE))
        tables[r, :used] = perm[r * nb:r * nb + used].to(torch.int32)
    return tables.cuda()


def check_paged_decode_attention(gen) -> dict:
    """Kernel 3, float and int8 pages, at kernel 1's shapes (page 32,
    shuffled tables into an arena of ``ARENA_PAGES`` pages, null-padded
    tails, garbage distractor pages; at path D's shape slot 0 is idle on
    an all-null table): against its plain version
    (gather + reference) with ``DECODE_TOL``, and BITWISE against kernel
    1 / 1b run on the K/V gathered through the same tables; then timed
    in bf16 with table copies rotated over the arena (past L2) beside the
    plain version and SDPA on pre-gathered K/V."""
    import torch.nn.functional as F

    from lambdipy_tpu_torch.ops.decode_attention import (
        blocked_decode_attention, gather_pages, paged_decode_attention,
        paged_decode_attention_reference)

    h, kvh, d = DECODE_HEADS
    rng = torch.Generator().manual_seed(5)
    result = {"checks": {}, "timings": []}
    for quant in (False, True):
        branch = "int8kv" if quant else "float"

        def call(fn, q, arena, tables, alen):
            scales = ({"k_scale_pages": arena["k_scale"],
                       "v_scale_pages": arena["v_scale"]} if quant else {})
            return fn(q, arena["k"], arena["v"], tables, alen, **scales)

        def contiguous(q, arena, tables, alen):
            g = {name: gather_pages(x, tables).contiguous()
                 for name, x in arena.items()}
            scales = ({"k_scale": g["k_scale"], "v_scale": g["v_scale"]}
                      if quant else {})
            return blocked_decode_attention(q, g["k"], g["v"], alen,
                                            **scales)

        for dtype in (torch.bfloat16, torch.float32):
            arena = _paged_arena(gen, dtype, quant)
            tol = DECODE_TOL[dtype]
            for b, t, active in DECODE_SHAPES:
                nb = t // PAGE
                tables = _paged_tables(rng, b, nb, active, idle_rows(b, t))
                alen = torch.tensor(active, dtype=torch.int32, device="cuda")
                zero = alen.clone()
                zero[0] = 0
                q = torch.randn(b, 1, h, d, generator=gen,
                                device="cuda").to(dtype)
                outs = {key: (call(paged_decode_attention, q, arena, tables,
                                   a),
                              call(paged_decode_attention_reference, q,
                                   arena, tables, a),
                              contiguous(q, arena, tables, a))
                        for key, a in (("", alen), ("len0", zero))}
                torch.cuda.synchronize()
                out, ref, cont = outs[""]
                err = (out.float() - ref.float()).abs().max().item()
                rel = row_rel_err(out, ref)
                rel0 = row_rel_err(outs["len0"][0], outs["len0"][1])
                same = all(torch.equal(o, c) for o, _, c in outs.values())

                def solo(r, cap):
                    # the row's own pages, then null pages up to `cap`
                    own = -(-active[r] // PAGE)
                    tb = torch.zeros(1, -(-cap // PAGE), dtype=torch.int32,
                                     device="cuda")
                    tb[0, :own] = tables[r, :own]
                    return call(paged_decode_attention, q[r:r + 1], arena,
                                tb, alen[r:r + 1])

                invariant = rows_invariant(
                    lambda: call(paged_decode_attention, q, arena, tables,
                                 alen), out, solo, active)
                key = f"{branch} b={b} t={t} {dtype}"
                log(f"paged_decode_attention {key}: max_abs_err {err:.3e}; "
                    f"per row, max |diff| / rms {rel:.3e} (active_len 0 case "
                    f"{rel0:.3e}), tolerance {tol}; bitwise equal to the "
                    f"contiguous kernel on the gathered K/V: {same}; every "
                    f"row bitwise alone at batch 1 on another table "
                    f"width, and launch to launch: {invariant}")
                if not (rel <= tol and rel0 <= tol and same and invariant):
                    raise SystemExit(f"paged_decode_attention disagrees at "
                                     f"{key}: {rel}, {rel0} > {tol} or "
                                     f"bitwise {same}, invariant {invariant}")
                result["checks"][key] = {
                    "max_abs_err": err, "row_rel_err": rel,
                    "row_rel_err_len0": rel0, "tolerance": tol,
                    "bitwise_contiguous": same,
                    "batch_invariant": invariant}
            if dtype == torch.float32:
                del arena
                torch.cuda.empty_cache()
                continue
            # timing in bf16: table copies rotated over the arena, so
            # successive calls read other pages (past the 50 MB L2)
            for b, t, active in DECODE_SHAPES:
                nb = t // PAGE
                alen = torch.tensor(active, dtype=torch.int32, device="cuda")
                positions = int(alen.sum().item())
                per_pos = kvh * (d + 4 if quant else 2 * d)  # K or V
                n = copies_for(2 * positions * per_pos)
                tabs = [_paged_tables(rng, b, nb, active, idle_rows(b, t))
                        for _ in range(n)]
                q = torch.randn(b, 1, h, d, generator=gen,
                                device="cuda").to(dtype)
                ms = cuda_time(lambda i: call(paged_decode_attention, q,
                                              arena, tabs[i], alen), n)
                plain_ms = cuda_time(
                    lambda i: call(paged_decode_attention_reference, q,
                                   arena, tabs[i], alen), n)
                deq = [plain_kv({name: gather_pages(x, tb)
                                 for name, x in arena.items()}, dtype, quant)
                       for tb in tabs]
                kts = [k.transpose(1, 2) for k, _ in deq]
                vts = [v.transpose(1, 2) for _, v in deq]
                del deq
                mask = (torch.arange(t, device="cuda")[None, :]
                        < alen[:, None])[:, None, None]
                library_ms = cuda_time(
                    lambda i: F.scaled_dot_product_attention(
                        q.transpose(1, 2), kts[i], vts[i], attn_mask=mask,
                        enable_gqa=True), n)
                dms = {"kernel": device_time(
                           lambda i: call(paged_decode_attention, q, arena,
                                          tabs[i], alen), n),
                       "plain": device_time(
                           lambda i: call(paged_decode_attention_reference,
                                          q, arena, tabs[i], alen), n,
                           calls=6),
                       "sdpa": device_time(
                           lambda i: F.scaled_dot_product_attention(
                               q.transpose(1, 2), kts[i], vts[i],
                               attn_mask=mask, enable_gqa=True), n)}
                del kts, vts
                # q and out, the active K/V (and scales), the table
                nbytes = (2 * q.numel() * 2 + 2 * positions * per_pos
                          + b * nb * 4 + b * 4)
                bound_ms, bound_by = bound(nbytes, 4.0 * positions * h * d)
                shape = (f"b={b} h={h} kvh={kvh} d={d} t={t} page={PAGE} "
                         f"active_len={list(active)} bf16"
                         + (" int8 K/V" if quant else ""))
                log(f"paged_decode_attention {shape}: kernel {ms:.4f} ms, "
                    f"plain {plain_ms:.4f} ms, sdpa (pre-gathered) "
                    f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms "
                    f"({bound_by}; the kernel at {bound_ms / ms:.3f} of it); "
                    f"device time per call: kernel {dms['kernel']:.4f} ms "
                    f"({bound_ms / dms['kernel']:.3f} of the bound), plain "
                    f"{dms['plain']:.4f} ms, sdpa {dms['sdpa']:.4f} ms")
                result["timings"].append(
                    {"shape": shape, "branch": branch, "ms": ms,
                     "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "bound_fraction": bound_ms / ms, "device_ms": dms,
                     "device_bound_fraction": bound_ms / dms["kernel"]})
            del arena
            torch.cuda.empty_cache()
    line = result["timings"][0]  # float K/V, b=4, t=544
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "lambdipy_tpu_torch/csrc/decode_attention.cu",
            "replaces": "lambdipy_tpu/ops/decode_attention.py:282",
            "shape": line["shape"],
            "max_abs_err": max(c["max_abs_err"]
                               for c in result["checks"].values()),
            "ms": line["ms"], "plain_ms": line["plain_ms"],
            "bound_ms": line["bound_ms"], "bound_by": line["bound_by"],
            "library_ms": line["library_ms"], **result}


FLASH_HEADS = (32, 8, 128)  # h, kvh, d of llama3-8b
# (b, s, dtype, causal): the long prompt's bucket, the main path's short
# prompts (a 100-token prompt's 128 bucket alone and in a group of 8), a
# batch of 512-token prompts, one full (non-causal) case and one f32 case
FLASH_CASES = ((1, 4096, torch.bfloat16, True),
               (1, 128, torch.bfloat16, True),
               (8, 128, torch.bfloat16, True),
               (4, 512, torch.bfloat16, True),
               (4, 512, torch.bfloat16, False),
               (1, 512, torch.float32, True))
# the flash kernel's batch invariance: rows of b=8 against the same rows
# alone at b=1, at these lengths (200: ragged tiles), causal and full
FLASH_INVARIANCE_S = (128, 200)
# limits on row_rel_err. "kernel_rounding" is mha_reference on f32 q/k:
# f32 logits and p rounded to bf16 before PV, as the kernel does (which
# rounds p against the running max, not the final sum), so the two differ
# by the one-ulp output rounding that bounds decode attention above.
# "plain" is mha_reference itself, the port's plain version: it also
# rounds its logits to bf16 (the einsum's output dtype), which adds ~0.3%
# noise to every probability. Measured on an H100 (NVIDIA H100 80GB HBM3,
# 700 W): kernel_rounding 0.033-0.035, plain 0.043-0.052. A row of the
# s=4096 case that skipped one 64-position tile of its ~2,000 keys would
# read ~0.5 (an estimate, as for decode). f32: summation order and expf,
# measured 6.0e-6.
FLASH_TOL = {"plain": 0.12, "kernel_rounding": 0.05, "f32": 1e-4}


def check_flash_attention(gen) -> dict:
    """The flash kernel against ``mha_reference`` (in bf16 also against
    it on f32 q/k, the kernel's own rounding) at every ``FLASH_CASES``
    entry, and timed there beside SDPA (causal, GQA native), which the
    port never calls."""
    import torch.nn.functional as F

    from lambdipy_tpu_torch.ops.attention import (flash_attention,
                                                  mha_reference)

    h, kvh, d = FLASH_HEADS
    rows = []
    for b, s, dtype, causal in FLASH_CASES:
        esize = 2 if dtype == torch.bfloat16 else 4
        per_copy = b * s * (h + 2 * kvh) * d * esize
        n = copies_for(per_copy)

        def make():
            return tuple(torch.randn(b, s, heads, d, generator=gen,
                                     device="cuda").to(dtype)
                         for heads in (h, kvh, kvh))

        ins = [make() for _ in range(n)]
        q, k, v = ins[0]
        out = flash_attention(q, k, v, causal=causal)
        ref = mha_reference(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        key = f"b={b} s={s} {dtype} {'causal' if causal else 'full'}"
        rels = {"plain": row_rel_err(out, ref)}
        del ref
        if dtype == torch.bfloat16:
            # the kernel body's rounding: f32 logits, p in bf16 before PV
            ref = mha_reference(q.float(), k.float(), v, causal=causal)
            rels["kernel_rounding"] = row_rel_err(out, ref)
            del ref
        del out
        for ref_name, rel in rels.items():
            tol = FLASH_TOL[ref_name if dtype == torch.bfloat16 else "f32"]
            log(f"flash_attention {key} against the {ref_name} version: "
                f"per row, max |diff| / rms {rel:.3e}, tolerance {tol}"
                + (f" (max_abs_err {err:.3e})" if ref_name == "plain"
                   else ""))
            if not rel <= tol:
                raise SystemExit(f"flash_attention disagrees with the "
                                 f"{ref_name} version at {key}: {rel} > "
                                 f"{tol}")
        def kernel(i):
            return flash_attention(*ins[i], causal=causal)

        ms = cuda_time(kernel, n)
        plain_ms = cuda_time(
            lambda i: mha_reference(*ins[i], causal=causal), n)
        torch.cuda.empty_cache()
        tins = [tuple(x.transpose(1, 2) for x in t3) for t3 in ins]

        def sdpa(i):
            return F.scaled_dot_product_attention(
                *tins[i], is_causal=causal, enable_gqa=True)

        library_ms = cuda_time(sdpa, n)
        pairs = s * (s + 1) / 2 if causal else s * s
        nbytes = b * s * (2 * h + 2 * kvh) * d * esize
        bound_ms, bound_by = bound(nbytes, 4.0 * b * h * d * pairs)
        device_ms = None
        if ms < DEVICE_TIME_BELOW_MS:
            device_ms = {"kernel": device_time(kernel, n),
                         "library": device_time(sdpa, n)}
        log(f"flash_attention {key} h={h} kvh={kvh} d={d}: kernel "
            f"{ms:.4f} ms ({bound_ms / ms:.3f} of the bound), plain "
            f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by})"
            + ("" if device_ms is None else
               f"; device time per call: kernel {device_ms['kernel']:.4f} "
               f"ms ({bound_ms / device_ms['kernel']:.3f} of the bound), "
               f"sdpa {device_ms['library']:.4f} ms"))
        rows.append({"shape": f"{key} h={h} kvh={kvh} d={d}",
                     "max_abs_err": err, "row_rel_err": rels, "ms": ms,
                     "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "bound_fraction": bound_ms / ms,
                     "device_ms": device_ms})
        if device_ms is not None:
            rows[-1]["device_bound_fraction"] = (bound_ms
                                                 / device_ms["kernel"])
        del ins, tins
        torch.cuda.empty_cache()
    invariant = flash_rows_invariant(gen)
    log(f"flash_attention: every row bitwise alone at b=1 inside b=8: "
        f"{invariant}")
    if not invariant:
        raise SystemExit("flash_attention's rows depend on the batch")
    line = rows[0]
    return {"name": "flash_attention", "route": "cuda",
            "source": "lambdipy_tpu_torch/csrc/flash_attention.cu",
            "replaces": "lambdipy_tpu/ops/attention.py:45",
            "shape": line["shape"],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": line["ms"], "plain_ms": line["plain_ms"],
            "bound_ms": line["bound_ms"], "bound_by": line["bound_by"],
            "library_ms": line["library_ms"], "checks": rows,
            "rows_invariant_in_b": invariant}


def flash_rows_invariant(gen) -> bool:
    """Each row of a b=8 flash call at llama3-8b's heads is bitwise the
    same row launched alone at b=1, and a second launch is bitwise the
    first: bf16 and f32, causal and full, at every
    ``FLASH_INVARIANCE_S`` (what a grouped prefill under ``flash``
    rests on)."""
    from lambdipy_tpu_torch.ops.attention import flash_attention

    h, kvh, d = FLASH_HEADS
    same = True
    for s in FLASH_INVARIANCE_S:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn(8, s, heads, d, generator=gen,
                                   device="cuda").to(dtype)
                       for heads in (h, kvh, kvh))
            for causal in (True, False):
                out = flash_attention(q, k, v, causal=causal)
                same = same and torch.equal(
                    flash_attention(q, k, v, causal=causal), out)
                for r in range(8):
                    alone = flash_attention(q[r:r + 1], k[r:r + 1],
                                            v[r:r + 1], causal=causal)
                    same = same and torch.equal(alone, out[r:r + 1])
    return bool(same)


# (k, n, x dtype, row counts): the projections of llama3-8b at
# single-row decode (1), batch-4 decode (4), and the main path's prefills:
# a prefix walk's block chunk and a continuation's suffix (32), path A's
# 100-token prompt (bucket 128), a prefix walk's wide chunk (256), a
# chunked walk's chunk and a chunked tail at ``prefill_chunk=512`` (512), a
# 4 x 512 group (2048) and the ~4,000-token prompt of paths B and C
# (bucket 4096)
PREFILL_MS = (1, 4, 32, 128, 256, 512, 2048, 4096)
MATMUL_SHAPES = (
    (4096, 4096, torch.bfloat16, PREFILL_MS),    # q_proj, o_proj
    (4096, 1024, torch.bfloat16, PREFILL_MS),    # k_proj, v_proj
    (4096, 14336, torch.bfloat16, PREFILL_MS),   # gate_proj, up_proj
    (14336, 4096, torch.bfloat16, PREFILL_MS),   # down_proj
    (4096, 128256, torch.float32, (1, 4, 2048)),  # lm_head (f32 x and out)
)
# the GEMV at the row counts of an engine's decode step (path D's 8 slots,
# 16 and 64; the caller's route: one position per row), at every shape
# above
GEMV_MS = (8, 16, 64)
LINE_SHAPE = (4, 4096, 14336)  # the shape reported in the kernels line
# rows this fast also get their device time; so does every GEMV row and
# every row of these row counts (D's chunked turns run the tiled route at
# m = 512)
DEVICE_TIME_BELOW_MS = 0.2
DEVICE_TIME_MS = (512,)
# a decode step's int8 matmuls: each projection's calls per step (32
# layers; q and o share 4096 x 4096, k and v 4096 x 1024, gate and up
# 4096 x 14336) and the lm_head, 225 in all
STEP_CALLS = {(4096, 4096): 64, (4096, 1024): 64, (4096, 14336): 64,
              (14336, 4096): 32, (4096, 128256): 1}
STEP_MS = (1, 8, 16)  # the row counts whose per-step sums are printed
# the tiled route's row invariance: 16 rows alone at m=16 against the same
# rows at these offsets inside these row counts (shapes: k_proj, q_proj,
# whose tile shape changes with m, and a ragged one)
INVARIANCE_SHAPES = ((4096, 1024), (4096, 4096), (264, 144))
INVARIANCE_MS = (32, 128, 1024)
INVARIANCE_OFFSETS = (0, 5, 70)
# the GEMV's row invariance: every row alone at m=1 against the same rows
# inside these row counts (k_proj, down_proj: the deepest merge of the
# split plan, and the lm_head's width)
GEMV_INVARIANCE_SHAPES = ((4096, 1024), (14336, 4096), (4096, 128256))
GEMV_INVARIANCE_MS = (8, 16, 64)


def gemv_rows_invariant(gen) -> bool:
    """Every ``GEMV_INVARIANCE_SHAPES`` in bf16 and f32: 64 rows through
    the GEMV alone at m=1 are bitwise the same rows inside each of
    ``GEMV_INVARIANCE_MS`` (the route a decode step over the engine's
    slots and the grouped lm_head take), one launch per call."""
    from lambdipy_tpu_torch.ops.quant import int8_matmul

    same = True
    for k, n in GEMV_INVARIANCE_SHAPES:
        w = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                          dtype=torch.int8)
        scale = (torch.rand(1, n, generator=gen, device="cuda") + 0.5) \
            / (127.0 * k ** 0.5)
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(max(GEMV_INVARIANCE_MS), k, generator=gen,
                            device="cuda").to(dtype)
            alone = torch.cat([int8_matmul(x[r:r + 1], w, scale,
                                           rows_alone=True)
                               for r in range(x.shape[0])])
            for m in GEMV_INVARIANCE_MS:
                before = int8_matmul.launches
                out = int8_matmul(x[:m], w, scale, rows_alone=True)
                same = (same and int8_matmul.launches == before + 1
                        and torch.equal(out, alone[:m]))
        del w
    return bool(same)


def int8_rows_invariant(gen) -> bool:
    """Every ``INVARIANCE_SHAPES`` in bf16 and f32: 16 rows through the
    tiled route alone at m=16 are bitwise the same rows inside each of
    ``INVARIANCE_MS`` at each of ``INVARIANCE_OFFSETS`` (other rows
    random), as path D's grouped prefills need (the kernel's tile shape
    changes with m)."""
    from lambdipy_tpu_torch.ops.quant import int8_matmul

    same = True
    for k, n in INVARIANCE_SHAPES:
        w = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                          dtype=torch.int8)
        scale = (torch.rand(1, n, generator=gen, device="cuda") + 0.5) \
            / (127.0 * k ** 0.5)
        for dtype in (torch.bfloat16, torch.float32):
            rows = torch.randn(16, k, generator=gen, device="cuda").to(dtype)
            alone = int8_matmul(rows, w, scale)
            for m in INVARIANCE_MS:
                for off in INVARIANCE_OFFSETS:
                    if off + 16 > m:
                        continue
                    x = torch.randn(m, k, generator=gen,
                                    device="cuda").to(dtype)
                    x[off:off + 16] = rows
                    out = int8_matmul(x, w, scale)
                    same = same and torch.equal(out[off:off + 16], alone)
    return bool(same)


def check_int8_matmul(gen) -> dict:
    from lambdipy_tpu_torch.ops.quant import (int8_matmul,
                                              int8_matmul_reference,
                                              int8_route)

    dev = "cuda"
    rows, line = [], None
    for k, n, xdtype, ms_list in MATMUL_SHAPES:
        n_copies = copies_for(k * n)
        ws = [torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                            dtype=torch.int8) for _ in range(n_copies)]
        scale = (torch.rand(1, n, generator=gen, device=dev) + 0.5) \
            / (127.0 * k ** 0.5)
        # the library yardstick's bf16 weights rotate past L2 as well
        n_deq = copies_for(2 * k * n)
        w_deq = [(w.to(torch.bfloat16) * scale.to(torch.bfloat16))
                 for w in ws[:n_deq]]
        for m, alone in ([(m, None) for m in ms_list]
                         + [(m, True) for m in GEMV_MS]):
            x = torch.randn(m, k, generator=gen, device=dev).to(xdtype)

            def kernel(i):
                return int8_matmul(x, ws[i], scale, rows_alone=alone)

            out = kernel(0)
            ref = int8_matmul_reference(x, ws[0], scale)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            peak = ref.float().abs().max().item()
            del out, ref
            # bf16 output: one bf16 ulp at the peak (2^-8) from another
            # f32 summation order; f32 output: summation order alone
            tol = (2.0 ** -7 if xdtype == torch.bfloat16 else 1e-5) * peak
            ok = err <= tol
            ms = cuda_time(kernel, n_copies)
            plain_ms = cuda_time(
                lambda i: int8_matmul_reference(x, ws[i], scale), n_copies)
            xb = x.to(torch.bfloat16)
            library_ms = cuda_time(lambda i: torch.matmul(xb, w_deq[i]),
                                   n_deq)
            route = int8_route(m, alone)
            device_ms = None
            if ms < DEVICE_TIME_BELOW_MS or route == "gemv" \
                    or m in DEVICE_TIME_MS:
                device_ms = {
                    "kernel": device_time(kernel, n_copies),
                    "library": device_time(
                        lambda i: torch.matmul(xb, w_deq[i]), n_deq)}
            esize = x.element_size()
            nbytes = m * k * esize + k * n + 4 * n + m * n * esize
            bound_ms, bound_by = bound(nbytes, 2.0 * m * k * n)
            row = {"m": m, "k": k, "n": n, "x_dtype": str(xdtype),
                   "route": route,
                   "max_abs_err": err, "max_rel_err": err / peak,
                   "tolerance": tol, "ms": ms,
                   "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bound_fraction": bound_ms / ms, "device_ms": device_ms}
            if device_ms is not None:
                row["device_bound_fraction"] = bound_ms / device_ms["kernel"]
            rows.append(row)
            log(f"int8_matmul m={m} k={k} n={n} x={xdtype} ({route}): "
                f"max_abs_err "
                f"{err:.3e} (relative to the peak {err / peak:.3e}; tol "
                f"{tol:.3e}) kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bf16 matmul {library_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by}; the kernel at "
                f"{bound_ms / ms:.3f} of it)"
                + ("" if device_ms is None else
                   f"; device time per call: kernel "
                   f"{device_ms['kernel']:.4f} ms "
                   f"({bound_ms / device_ms['kernel']:.3f} of the bound), "
                   f"bf16 matmul {device_ms['library']:.4f} ms"))
            if not ok:
                raise SystemExit(f"int8_matmul disagrees with its plain "
                                 f"version at m={m} k={k} n={n}: {err} > {tol}")
            if (m, k, n) == LINE_SHAPE and alone is None:
                line = row
        del ws, w_deq
        torch.cuda.empty_cache()
    step_sums = gemv_step_sums(rows)
    invariant = int8_rows_invariant(gen)
    log(f"int8_matmul tiled: every row bitwise alone at m=16 and inside "
        f"m={'/'.join(map(str, INVARIANCE_MS))}: {invariant}")
    if not invariant:
        raise SystemExit("int8_matmul's tiled route is not row-invariant "
                         "in m")
    gemv_invariant = gemv_rows_invariant(gen)
    log(f"int8_matmul gemv: every row bitwise alone at m=1 inside "
        f"m={'/'.join(map(str, GEMV_INVARIANCE_MS))}: {gemv_invariant}")
    if not gemv_invariant:
        raise SystemExit("int8_matmul's GEMV rows depend on the row count")
    return {"name": "int8_matmul", "route": "cuda",
            "source": "lambdipy_tpu_torch/csrc/int8_matmul.cu",
            "replaces": "lambdipy_tpu/ops/quant.py:32",
            "shape": "m=%d k=%d n=%d bf16" % LINE_SHAPE,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": line["ms"], "plain_ms": line["plain_ms"],
            "bound_ms": line["bound_ms"], "bound_by": line["bound_by"],
            "library_ms": line["library_ms"], "checks": rows,
            "rows_invariant_in_m": invariant,
            "gemv_rows_invariant_in_m": gemv_invariant,
            "gemv_step_sums": step_sums}


def gemv_step_sums(rows) -> dict:
    """Device ms of one decode step's 225 int8 matmuls (``STEP_CALLS``)
    at each of ``STEP_MS`` rows, summed from phase 3's GEMV rows: the
    kernel, the bytes bound and the bf16 matmul; printed one line per
    row count."""
    by = {(r["m"], r["k"], r["n"]): r for r in rows if r["route"] == "gemv"}
    sums = {}
    for m in STEP_MS:
        got = {key: by[(m, *key)] for key in STEP_CALLS}
        total = {name: sum(STEP_CALLS[key] * pick(got[key])
                           for key in STEP_CALLS)
                 for name, pick in (
                     ("kernel_ms", lambda r: r["device_ms"]["kernel"]),
                     ("bound_ms", lambda r: r["bound_ms"]),
                     ("library_ms", lambda r: r["device_ms"]["library"]))}
        sums[m] = total
        log(f"int8_matmul gemv, one decode step at m={m} (225 calls, "
            f"device time): kernel {total['kernel_ms']:.4f} ms, bytes bound "
            f"{total['bound_ms']:.4f} ms (the kernel at "
            f"{total['bound_ms'] / total['kernel_ms']:.3f} of it), bf16 "
            f"matmul {total['library_ms']:.4f} ms")
    return sums


# the three configurations of the main path; all serve llama3-8b with
# int8 weights in bf16 through the int8 matmul kernel
PATHS = {"A": {"attn_backend": "blocked"},
         "B": {"attn_backend": "blocked", "kv_quant": "int8"},
         "C": {"attn_backend": "flash"}}


def check_small_model() -> dict:
    """A small f32 int8-weight model (kernels on the card) against the
    same weights on the CPU (plain versions), under each path's
    backends: greedy tokens and logprobs."""
    from lambdipy_tpu_torch.models import registry

    out = {}
    for path, backends in PATHS.items():
        extra = {"vocab_size": 512, "hidden": 256, "heads": 4,
                 "kv_heads": 2, "mlp": 512, "layers": 2, "max_len": 256,
                 "matmul_backend": "pallas", **backends}
        adapter = registry.get("llama-tiny").build(dtype="float32",
                                                   quant="int8", extra=extra)
        sd = adapter.init_params(seed=3, device="cpu")
        rows = [list(range(1, 40)), list(range(5, 12))]
        outs = {}
        for dev in ("cpu", "cuda"):
            server = adapter.make_server(sd, device=dev)
            outs[dev] = server.generate(rows, max_new_tokens=12,
                                        return_logprobs=True)
        same = bool((outs["cpu"][0] == outs["cuda"][0]).all())
        lp_err = float(abs(outs["cpu"][1] - outs["cuda"][1]).max())
        log(f"small int8 model, path {path} {backends}, card vs CPU: "
            f"greedy tokens equal {same}, logprob max_abs_err {lp_err:.3e} "
            f"(tolerance 5e-3: the int8 kernel rounds f32 activations to "
            f"bf16, and a ~1e-7 difference between card and CPU can flip "
            f"one by a bf16 ulp)")
        if not same or lp_err > 5e-3:
            raise SystemExit(f"small model on the card disagrees with the "
                             f"CPU under path {path}")
        out[path] = {"tokens_equal": same, "logprob_max_abs_err": lp_err}
    out["D"] = check_small_engine()
    return out


def check_small_engine() -> dict:
    """Path D's engine on a small f32 int8-weight model: three concurrent
    greedy rows through the paged continuous engine on the card against
    the same engine on the CPU (tokens equal, logprobs within 5e-3 as
    above), and kernel 3 launched once per layer per engine step."""
    import threading

    from lambdipy_tpu_torch.models import registry
    from lambdipy_tpu_torch.ops.decode_attention import paged_decode_attention
    from lambdipy_tpu_torch.runtime.handlers import make_engine

    extra = {"vocab_size": 512, "hidden": 256, "heads": 4, "kv_heads": 2,
             "mlp": 512, "layers": 2, "max_len": 256,
             "matmul_backend": "pallas", "attn_backend": "blocked"}
    adapter = registry.get("llama-tiny").build(dtype="float32", quant="int8",
                                               extra=extra)
    sd = adapter.init_params(seed=3, device="cpu")
    rows = [(list(range(1, 40)), 12), (list(range(5, 12)), 20),
            (list(range(9, 150)), 9)]
    outs = {}
    for dev in ("cpu", "cuda"):
        engine = make_engine(adapter.make_server(sd, device=dev),
                             {"batch_max": "4", "batch_segment": "4",
                              "kv_paged": "1"})
        launches = paged_decode_attention.launches
        res = [None] * len(rows)

        def run(i):
            res[i] = engine.generate(rows[i][0], max_new_tokens=rows[i][1],
                                     return_logprobs=True)

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(rows))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        outs[dev] = res
        steps = engine.stats()["steps"]
        if dev == "cuda" and (paged_decode_attention.launches - launches
                              != 2 * steps):
            raise SystemExit("small paged engine: kernel 3 launches "
                             f"{paged_decode_attention.launches - launches}"
                             f" != 2 x {steps} steps")
    same = all(bool((c[0] == g[0]).all())
               for c, g in zip(outs["cpu"], outs["cuda"]))
    lp_err = max(float(abs(c[1] - g[1]).max())
                 for c, g in zip(outs["cpu"], outs["cuda"]))
    log(f"small int8 model, paged continuous engine, card vs CPU: greedy "
        f"tokens equal {same}, logprob max_abs_err {lp_err:.3e} (tolerance "
        f"5e-3, as above)")
    if not same or lp_err > 5e-3:
        raise SystemExit("small paged engine on the card disagrees with "
                         "the CPU")
    return {"tokens_equal": same, "logprob_max_abs_err": lp_err}


# ------------------------------------------------------------------ phase 4

def _without_latency(body: dict) -> dict:
    """An ``/invoke`` answer without its ``latency_ms``: the handler's wall
    time, which ``HandlerState.invoke`` adds (as JAX's does) and no two
    answers share."""
    return {k: v for k, v in body.items() if k != "latency_ms"}


def http_json(url: str, payload=None, timeout: float = 900.0) -> dict:
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


LONG_PROMPT = 4000  # bucket 4096; cache_len 4128 with 32 new tokens
KERNELS = ("decode_attention", "decode_attention_int8kv",
           "paged_decode_attention", "paged_decode_attention_int8kv",
           "int8_matmul", "flash_attention")


# Cut for time: these paths serve llama3-8b at its published widths with
# CUT_LAYERS of its 32 layers, every check kept (the launch identities are
# written in the model's layer count); A, D-G, K-O run at full depth
CUT_LAYERS = 8
FULL_LAYERS = 32
CUT_PATHS = ("B", "C", "E", "H", "I", "J")
STORE_MB = 512  # the handler's default prefix store
# the byte budgets of an extra, scaled with the depth so that each holds as
# many blocks, pages and heads at CUT_LAYERS as at FULL_LAYERS
# (a session's pin budget is half the store's by default)
CUT_BUDGETS = ("prefix_cache_mb", "kv_offload_mb")


def cut(extra: dict) -> dict:
    """``extra`` at the cut depth: ``layers`` and each byte budget scaled
    (the store's default made explicit first)."""
    out = {"prefix_cache_mb": str(STORE_MB), **extra,
           "layers": str(CUT_LAYERS)}
    for key in CUT_BUDGETS:
        if key in out:
            out[key] = str(int(out[key]) * CUT_LAYERS // FULL_LAYERS)
    return out


def path_spec(path: str, depth_cut: bool | None = None) -> dict:
    # the prefix store off, so the path's counts and numbers compare with
    # the slices before it; path E drives the store. ``depth_cut``: at
    # CUT_LAYERS (default: the path is one of CUT_PATHS)
    extra = {**PATHS[path], "matmul_backend": "pallas",
             "max_new_tokens": "16", "prefix_cache_mb": "0"}
    if path in CUT_PATHS if depth_cut is None else depth_cut:
        extra = cut(extra)
    return {"model": "llama3-8b", "dtype": "bfloat16", "quant": "int8",
            "extra": extra}


def implied_launches(path: str, layers: int, news) -> dict:
    """Launches a path implies for requests of ``news`` new tokens each:
    one prefill forward + (n - 1) decode forwards per request; 7
    projections per layer + the lm_head per forward; per layer, one
    decode-attention launch per decode forward (A float K/V, B int8 K/V)
    or one flash launch per prefill forward (C)."""
    want = dict.fromkeys(KERNELS, 0)
    want["int8_matmul"] = sum((7 * layers + 1) * n for n in news)
    if path == "C":
        want["flash_attention"] = layers * len(news)
    else:
        key = "decode_attention_int8kv" if path == "B" else "decode_attention"
        want[key] = sum(layers * (n - 1) for n in news)
    return want


def set_launches_to_zero() -> None:
    from lambdipy_tpu_torch.ops.attention import flash_attention
    from lambdipy_tpu_torch.ops.decode_attention import (
        blocked_decode_attention, paged_decode_attention)
    from lambdipy_tpu_torch.ops.quant import int8_matmul

    for fn in (blocked_decode_attention, paged_decode_attention):
        fn.launches = 0
        fn.launches_int8kv = 0
    int8_matmul.launches = 0
    flash_attention.launches = 0


def check_replays(path: str, stats: dict, steps: int,
                  prefills: int | None = None) -> dict:
    """Every decode step of a path was a replay of a captured graph: the
    server's (or engine's) ``replays`` equal the ``steps`` its requests
    implied and none ran eagerly; and so was every prefill: its
    ``prefill_replays`` equal the ``prefills`` it ran (when given) and
    none ran eagerly. The launch checks before this one count each
    replay's launches. Prints every program's graph pool."""
    keys = ("compile_count", "replays", "eager_steps", "prefill_replays",
            "eager_prefills", "program_evictions", "program_bytes",
            "decode_buckets", "program_pools")
    programs = {k: stats[k] for k in keys if k in stats}
    log(f"path {path} decode programs: {programs['compile_count']} graphs "
        f"captured, {programs['replays']} replays for {steps} decode steps, "
        f"{programs['eager_steps']} eager steps"
        + (f", {programs['program_evictions']} evicted, "
           f"{programs['program_bytes'] / 2**20:.1f} MiB of caches and "
           f"graph pools" if "program_bytes" in programs else ""))
    if programs["replays"] != steps or programs["eager_steps"]:
        raise SystemExit(f"path {path}: {programs['replays']} replays and "
                         f"{programs['eager_steps']} eager steps for {steps} "
                         f"decode steps")
    log(f"path {path} prefill programs: {programs['prefill_replays']} "
        f"replays for {prefills if prefills is not None else 'the'} "
        f"prefills run, {programs['eager_prefills']} eager")
    if programs["eager_prefills"] or (
            prefills is not None and programs["prefill_replays"] != prefills):
        raise SystemExit(f"path {path}: {programs['prefill_replays']} "
                         f"prefill replays and {programs['eager_prefills']} "
                         f"eager prefills for {prefills} prefills")
    log_pools(path, programs.get("program_pools", []))
    return programs


def log_pools(path: str, pools) -> None:
    """Each live program's key and the bytes of its graph's pool."""
    if pools:
        log(f"path {path} graph pools by program key (MiB): "
            + "; ".join(f"{'/'.join(map(str, k[:-1]))} {k[-1] / 2**20:.1f}"
                        for k in pools)
            + f"; {sum(k[-1] for k in pools) / 2**30:.3f} GiB in all")


RATE_TOKENS = 256
# the eager server's rate: its steps are the host's launches (~16-23 tok/s
# on an H100's host), so 31 steps read the rate 255 do in an eighth of the
# time
EAGER_RATE_TOKENS = 32


def decode_rate(generate, rows, tokens: int = RATE_TOKENS) -> float:
    """Decode tokens per second of ``rows``: rows x (tokens - 1) / (wall
    of a ``tokens``-token request - wall of a 1-token request); over 255
    steps a slow short request moves the rate by a few percent, not past
    the device bound."""
    walls = []
    for n in (1, tokens):
        t0 = time.perf_counter()
        generate(rows, max_new_tokens=n)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return len(rows) * (tokens - 1) / (walls[1] - walls[0])


def prefill_carry(server, rows, knobs) -> tuple:
    """``server``'s bucketed prefill of ``rows`` for one new token, run as
    ``generate`` runs it: the first tokens, their logprobs and the K/V the
    prefill wrote into the decode cache, copied."""
    with server._lock, torch.inference_mode():
        entry, _ = server._prefill(rows, [len(r) for r in rows], 1,
                                   knobs.get("temperature", 0.0),
                                   knobs.get("top_k"), knobs.get("top_p"),
                                   knobs.get("seed", 0), None)
        try:
            step = entry.step
            return (step.tok.clone(), step.lp.clone(),
                    [{name: val.clone() for name, val in e.items()
                      if name != "index"} for e in step.cache])
        finally:
            server.programs.checkin(entry)


def carries_equal(a, b) -> bool:
    return (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            and all(torch.equal(x[n], y[n]) for x, y in zip(a[2], b[2])
                    for n in x))


def prefill_twins(path: str, server, eager, prompts: dict, knobs: dict,
                  card) -> dict:
    """Graph prefill against eager prefill on the same weights: for each
    ``name -> rows`` the first token, its logprob and every layer's K/V
    bitwise (graph, eager, eager, graph: the graph's second run a replay
    of the program the first captured), greedy and under ``knobs``; then
    the time to first token of a one-token ``generate``, graph and eager
    in turns (graph, eager, eager, graph)."""
    same, ttft = {}, {}
    for name, rows in prompts.items():
        for label, kw in (("greedy", {}), ("sampled", knobs)):
            runs = [prefill_carry(srv, rows, kw)
                    for srv in (server, eager, eager, server)]
            same[f"{name} {label}"] = all(carries_equal(runs[0], r)
                                          for r in runs[1:])
            del runs
        walls = {"graph": [], "eager": []}
        for kind in ("graph", "eager", "eager", "graph"):
            srv = server if kind == "graph" else eager
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            srv.generate(rows, max_new_tokens=1)
            torch.cuda.synchronize()
            walls[kind].append(time.perf_counter() - t0)
        ttft[name] = walls
        log(f"path {path} TTFT {name} ({len(rows[0])} tokens), one-token "
            f"generate in turns: graph {[round(w, 4) for w in walls['graph']]}"
            f" s, eager {[round(w, 4) for w in walls['eager']]} s [{card}]")
    log(f"path {path} graph vs eager prefill, first token, logprob and "
        f"K/V bitwise: {same}")
    if not all(same.values()):
        raise SystemExit(f"path {path}: graph prefill differs from eager")
    return {"bitwise": same, "ttft_s": ttft}


def graph_vs_eager(path: str, server, requests: dict, p100, ragged,
                   p_long, card) -> dict:
    """The graph server's rows against an eager server's on the same
    weights (``LlamaServer(model, graphs=False)``): tokens and logprobs
    bitwise for each request ``name -> (rows, knobs)`` of 32 new tokens;
    the prefills alone (:func:`prefill_twins`) at 100 and ~4,000 tokens;
    then batch-1 decode tok/s on the 100-token prompt (:func:`decode_rate`;
    the graph's over 255 steps, the eager server's over 31), graph and
    eager in turns (graph, eager, eager, graph), the host's noise moving a
    rate 30-70% between runs, and the graph server's ragged batch-4
    tok/s."""
    from lambdipy_tpu_torch.models.llama import LlamaServer

    eager = LlamaServer(server.model, graphs=False)
    same = {}
    for name, (rows, knobs) in requests.items():
        got = server.generate(rows, max_new_tokens=32, return_logprobs=True,
                              **knobs)
        want = eager.generate(rows, max_new_tokens=32, return_logprobs=True,
                              **knobs)
        same[name] = bool(np.array_equal(got[0], want[0])
                          and np.array_equal(got[1], want[1]))
    log(f"path {path} graph vs eager server, tokens and logprobs bitwise: "
        f"{same}")
    if not all(same.values()):
        raise SystemExit(f"path {path}: graph decode differs from eager")
    prefill = prefill_twins(path, server, eager,
                            {"100": [p100], "long": [p_long]},
                            requests["sampled"][1], card)
    rates = {"graph": [], "eager": []}
    # the 256-token key's graph captured before the first timed reading
    server.generate([p100], max_new_tokens=RATE_TOKENS)
    for kind in ("graph", "eager", "eager", "graph"):
        rates[kind].append(
            decode_rate(server.generate, [p100]) if kind == "graph"
            else decode_rate(eager.generate, [p100], EAGER_RATE_TOKENS))
    log(f"path {path} batch-1 decode tok/s, graph {rates['graph']} (255 "
        f"steps) / eager {rates['eager']} ({EAGER_RATE_TOKENS - 1} steps) "
        f"(in turns) [{card}]")
    server.generate(ragged, max_new_tokens=RATE_TOKENS)  # captured first
    ragged_rate = [decode_rate(server.generate, ragged)]
    log(f"path {path} ragged batch-4 decode tok/s, graph {ragged_rate} "
        f"[{card}]")
    del eager
    gc.collect()
    return {"bitwise": same, "prefill": prefill, "decode_tok_s": rates,
            "ragged4_decode_tok_s": ragged_rate, "card": card}


# A (m): 4 concurrent requests through a MicroBatcher handler on A's
# weights, (prompt tokens, new tokens, knobs): greedy and seeded sampled,
# prompts of one prefill width (the 32-token bucket: the port fuses a row
# only at its own width) and of different lengths and budgets
MICRO_REQS = ((20, 32, {}),
              (24, 24, {"temperature": 0.8, "top_p": 0.9, "seed": 7}),
              (27, 32, {}),
              (31, 16, {"temperature": 0.7, "top_k": 50, "seed": 3}))
MICRO_EXTRA = {"batch_window_ms": "2", "batch_max": "4"}


def micro_batcher_leg(state, card: str) -> dict:
    """A (m): the MicroBatcher (``runtime/batching.py``). A handler built
    with A's extras and ``batch_window_ms = 2``, ``batch_max = 4`` over
    A's weights (the same tensors, a server of its own) takes
    ``MICRO_REQS`` at once, twice (the first through ``invoke``, its
    served logprobs rounded as D's; the second straight into its
    batcher, unrounded and timed): every row bitwise its solo
    ``generate`` (tokens and logprobs), the batcher's counters a fused
    call (fewer calls than rows), the wall of the second burst against
    the 4 requests served one after another by solo ``generate``; the
    launches 225 x forwards and 32 x decode steps, every prefill and
    decode step a replay."""
    import threading

    from lambdipy_tpu_torch.runtime.handlers import (HandlerContext,
                                                     generate_handler,
                                                     kernel_launches)

    PROGRESS["stage"] = "A (m): the MicroBatcher"
    spec = path_spec("A")
    spec["extra"].update(MICRO_EXTRA)
    handler = generate_handler(spec, HandlerContext(
        device="cuda", state_dict=state.server.model.state_dict()))
    server, batcher = handler.server, handler.batcher
    cfg = server.model.cfg
    rng = torch.Generator().manual_seed(23)
    reqs = [(torch.randint(1, cfg.vocab_size, (s,), generator=rng).tolist(),
             n, kw) for s, n, kw in MICRO_REQS]
    set_launches_to_zero()
    before = server.program_stats()
    solo, seq_wall = [], []
    for p, n, kw in reqs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solo.append(server.generate(p, max_new_tokens=n,
                                    return_logprobs=True, **kw))
        seq_wall.append(time.perf_counter() - t0)

    def burst(call):
        out, errors = [None] * len(reqs), []
        gate = threading.Barrier(len(reqs))

        def run(i):
            gate.wait(timeout=60)
            try:
                out[i] = call(*reqs[i])
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        b0 = batcher.stats()
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(reqs))]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        wall = time.perf_counter() - t0
        b1 = batcher.stats()
        if errors or any(o is None for o in out):
            raise SystemExit(f"path A (m): a request failed: {errors!r}")
        return out, wall, {k: b1[k] - b0[k]
                           for k in ("batches_run", "rows_served")}

    served, _, calls1 = burst(lambda p, n, kw: handler.invoke(
        {"tokens": p, "max_new_tokens": n, "logprobs": True, **kw}))
    direct, wall, calls2 = burst(lambda p, n, kw: batcher.generate(
        p, max_new_tokens=n, return_logprobs=True, **kw))
    launches = kernel_launches()
    after = server.program_stats()
    steps = sum(after[k] - before[k] for k in ("replays", "eager_steps"))
    prefills = sum(after[k] - before[k]
                   for k in ("prefill_replays", "eager_prefills"))
    want = dict.fromkeys(KERNELS, 0)
    want["int8_matmul"] = (7 * cfg.layers + 1) * (steps + prefills)
    want["decode_attention"] = cfg.layers * steps
    same_http = all(r["ok"] and r["tokens"] == s_[0].tolist()
                    and np.array_equal(np.asarray(r["logprobs"]),
                                       _as_served(s_[1]))
                    for r, s_ in zip(served, solo))
    same = all(_rows_equal(d, s_) for d, s_ in zip(direct, solo))
    log(f"path A (m): 4 concurrent requests through a MicroBatcher handler "
        f"(batch_window_ms {MICRO_EXTRA['batch_window_ms']}, batch_max "
        f"{batcher.max_batch}): calls {calls1} (invoke) and {calls2} "
        f"(direct); the direct burst {wall:.4f} s against "
        f"{sum(seq_wall):.4f} s for the 4 one after another by solo "
        f"generate ({[round(w, 4) for w in seq_wall]}); rows bitwise solo: "
        f"{same} (direct), {same_http} (invoke, logprobs rounded as "
        f"served); {steps} decode steps, {prefills} prefills, "
        f"compile_count {after['compile_count']}; launches {launches} "
        f"implied {want} [{card}]")
    if not (same and same_http and launches == want
            and after["eager_steps"] == before["eager_steps"]
            and after["eager_prefills"] == before["eager_prefills"]
            and all(c["rows_served"] == len(reqs)
                    and c["batches_run"] < len(reqs)
                    for c in (calls1, calls2))):
        raise SystemExit("path A (m): the MicroBatcher failed its checks")
    del handler, server, batcher
    gc.collect()
    torch.cuda.empty_cache()
    return {"burst_wall_s": wall, "sequential_wall_s": sum(seq_wall),
            "sequential_walls_s": seq_wall, "calls": [calls1, calls2],
            "decode_steps": steps, "prefills": prefills,
            "launches": launches, "implied": want}


def serve_path(path: str, card: str) -> dict:
    """Phase 4 for one path: ``path_spec(path)`` served over HTTP on the
    card from a fresh handler; the handler is freed before returning."""
    from lambdipy_tpu_torch.models.llama import LlamaModel
    from lambdipy_tpu_torch.runtime.handlers import (HandlerContext,
                                                     generate_handler,
                                                     kernel_launches)
    from lambdipy_tpu_torch.runtime.server import BundleServer

    spec = path_spec(path)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = generate_handler(spec, HandlerContext(device="cuda"))
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    cfg = state.server.model.cfg
    log(f"path {path}: {spec['model']} ({cfg.layers} layers, hidden "
        f"{cfg.hidden}, {cfg.quant} weights, attn_backend "
        f"{cfg.attn_backend}, kv_quant {cfg.kv_quant}) built with seeded "
        f"random weights in {boot_s:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    server = BundleServer(state, port=0).start_background()
    try:
        health = http_json(server.url + "/healthz")
        if not health.get("ok") \
                or health["handler_meta"].get("kv_quant") != cfg.kv_quant:
            raise SystemExit(f"/healthz not ok: {health}")
        rng = torch.Generator().manual_seed(11)  # the same prompts per path

        def prompt(n):
            return torch.randint(1, cfg.vocab_size, (n,),
                                 generator=rng).tolist()

        p100 = prompt(100)
        ragged = [prompt(n) for n in (17, 64, 200, 500)]
        p_sampled = prompt(64)
        p_long = prompt(LONG_PROMPT)
        sampled = {"temperature": 0.8, "top_k": 50, "top_p": 0.9,
                   "seed": 1234}
        requests = [
            ("warmup", {"warmup": True}, 1, 16),
            ("ttft_1row", {"tokens": p100, "max_new_tokens": 1}, 1, 1),
            ("greedy_1row", {"tokens": p100, "max_new_tokens": 32,
                             "logprobs": True}, 1, 32),
            ("greedy_1row_again", {"tokens": p100, "max_new_tokens": 32,
                                   "logprobs": True}, 1, 32),
            ("ttft_ragged4", {"tokens": ragged, "max_new_tokens": 1}, 4, 1),
            ("ragged4", {"tokens": ragged, "max_new_tokens": 32}, 4, 32),
            ("sampled", {"tokens": p_sampled, "max_new_tokens": 32,
                         **sampled}, 1, 32),
            ("sampled_again", {"tokens": p_sampled, "max_new_tokens": 32,
                               **sampled}, 1, 32),
        ]
        if path != "A":
            requests += [
                ("ttft_long", {"tokens": p_long, "max_new_tokens": 1}, 1, 1),
                ("long", {"tokens": p_long, "max_new_tokens": 32}, 1, 32),
                ("long_again", {"tokens": p_long, "max_new_tokens": 32}, 1,
                 32),
            ]
        # counters to 0 just before the path, read just after
        set_launches_to_zero()
        walls, resp = {}, {}
        t_all = time.perf_counter()
        for name, body, _, _ in requests:
            t1 = time.perf_counter()
            resp[name] = http_json(server.url + "/invoke", body)
            walls[name] = time.perf_counter() - t1
        total_s = time.perf_counter() - t_all
        launches = kernel_launches()
        metrics = http_json(server.url + "/metrics")
    finally:
        server.stop()

    for name, _, n_rows, n_new in requests:
        r = resp[name]
        toks = r.get("tokens")
        if not r.get("ok") or len(toks) != n_rows or any(
                len(row) != n_new or not all(0 <= x < cfg.vocab_size
                                             for x in row)
                for row in toks):
            raise SystemExit(f"path {path}: request {name} answered badly: "
                             f"{json.dumps(r)[:500]}")
    lps = torch.tensor(resp["greedy_1row"]["logprobs"])
    if not torch.isfinite(lps).all():
        raise SystemExit(f"path {path}: non-finite logprobs")
    repeats = [("greedy_1row", "greedy_1row_again"),
               ("sampled", "sampled_again")]
    if path != "A":
        repeats.append(("long", "long_again"))
    for a, b in repeats:
        if resp[a]["tokens"] != resp[b]["tokens"]:
            raise SystemExit(f"path {path}: repeated request {a} gave "
                             f"other tokens")
    want = implied_launches(path, cfg.layers, [n for *_, n in requests])
    log(f"path {path} launch counters: {launches}, implied {want}")
    if launches != want or metrics["handler"]["kernels"] != launches:
        raise SystemExit(f"path {path}: launch counters {launches} "
                         f"(metrics {metrics['handler']['kernels']}) != "
                         f"implied {want}")
    programs = check_replays(path, metrics["handler"],
                             sum(n - 1 for *_, n in requests),
                             prefills=len(requests))

    perf = {"requests": len(requests), "wall_s": total_s,
            "requests_per_s": len(requests) / total_s,
            "ttft_s_1row_100tok": walls["ttft_1row"],
            "ttft_s_ragged4": walls["ttft_ragged4"]}
    if path != "A":
        perf["ttft_s_1row_long"] = walls["ttft_long"]
    perf["max_memory_allocated_gib"] = (torch.cuda.max_memory_allocated()
                                        / 2**30)
    perf["program_bytes"] = programs["program_bytes"]
    for key, val in perf.items():
        if key not in ("requests", "wall_s"):
            log(f"path {path} {key}: {val:.4f} [{card}]")
    perf.update(card=card, request_walls_s=walls)

    # the served model against the plain PyTorch model on the card: the
    # same weight tensors and KV layout, dense attention and dequantized
    # matmuls
    graph_check = graph_vs_eager(path, state.server, {
        "greedy_1row": ([p100], {}), "ragged4": (ragged, {}),
        "sampled": ([p_sampled], sampled),
        **({"long": ([p_long], {})} if path != "A" else {})}, p100, ragged,
        p_long, card)
    served = state.server.model
    plain = LlamaModel(dataclasses.replace(
        served.cfg, attn_backend="dense", matmul_backend="xla"),
        device="meta")
    plain.load_state_dict(served.state_dict(), assign=True)
    plain.device = served.device
    agree = {"100": compare_models(served, plain, p100, path)}
    if path != "A":
        agree["long"] = compare_models(served, plain, p_long, path)
    del plain, served
    trace = {"100": profile_decode(state.server, [p100], card)}
    if path != "A":
        trace["long"] = profile_decode(state.server, [p_long], card)
    out = {"spec": spec, "boot_s": boot_s, "launches": launches,
           "implied": want, "programs": programs,
           "graph_vs_eager": graph_check, "perf": perf,
           "plain_agreement": agree, "trace": trace,
           "tokens": {k: v.get("tokens") for k, v in resp.items()
                      if "long" not in k}}
    if path == "A":
        out["micro"] = _timed("path A (m)", micro_batcher_leg, state, card)
    # free this path's model before the next one is built
    del state, server
    gc.collect()
    torch.cuda.empty_cache()
    return out


# path D: the continuous engine over a paged KV arena
ENGINE_EXTRA = {"attn_backend": "blocked", "matmul_backend": "pallas",
                "batch_mode": "continuous", "kv_paged": "1",
                "batch_max": "8", "batch_segment": "16",
                # the background warm (on by default) runs only in D's warm
                # turns: elsewhere it would race the launch counters
                "warm_group_prefill": "0"}
# (prompt tokens, new tokens, kind): the burst of 8 concurrent requests,
# then 4 that join while it decodes; (s, n) pairs are unique
BURST = ((16, 128, "greedy"), (100, 64, "sampled"), (100, 48, "logprobs"),
         (500, 32, "stream"), (1000, 40, "greedy"), (2000, 24, "greedy"),
         (4000, 32, "logprobs"), (100, 80, "eos"))
JOINERS = ((64, 48, "greedy"), (200, 16, "logprobs"),
           (300, 32, "sampled2"), (50, 24, "greedy"))
KNOBS = {"sampled": {"temperature": 0.8, "top_p": 0.9, "seed": 7},
         "sampled2": {"temperature": 0.7, "top_k": 50, "seed": 3},
         "eos": {"temperature": 1.0, "seed": 11}}


def _post_stream(url: str, body: dict):
    """``/invoke`` with ``"stream": true``: (records, seconds to the first
    record)."""
    req = urllib.request.Request(
        url, data=json.dumps({**body, "stream": True}).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    records, first = [], None
    with urllib.request.urlopen(req, timeout=900) as resp:
        for line in resp:
            if line.strip():
                first = first if first is not None else time.perf_counter()
                records.append(json.loads(line))
    return records, first - t0


def _drive(send, requests, joiners_at: float = 2.0):
    """The burst: ``requests[:8]`` from threads 50 ms apart, the rest
    from ``joiners_at`` seconds on, 50 ms apart; ``send(i)`` serves
    request i. Returns (per-request wall seconds, burst wall seconds)."""
    import threading

    walls = [None] * len(requests)
    errors = []

    def run(i):
        time.sleep(0.05 * i if i < 8 else joiners_at + 0.05 * (i - 8))
        t1 = time.perf_counter()
        try:
            send(i)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)
        walls[i] = time.perf_counter() - t1

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(requests))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    if errors or any(w is None for w in walls):
        raise SystemExit(f"path D: a request failed: {errors!r}")
    return walls, time.perf_counter() - t0


def _as_served(lps) -> np.ndarray:
    """Logprobs rounded as the handler serves them (5 decimals)."""
    return np.asarray([[round(float(x), 5) for x in row] for row in lps])


def _knobs(body: dict) -> dict:
    """A request body's sampling knobs, as ``generate`` takes them."""
    return {k: body[k] for k in ("temperature", "top_k", "top_p", "seed",
                                 "eos_id") if k in body}


def _idle(engine) -> None:
    """Wait until the engine has retired its rows (logged at the barrier
    after the last one) and stopped."""
    with engine._lock:
        while engine._engine_running:
            engine._lock.wait(0.01)


def held_peak(request_log) -> int:
    """The most pages that logged rows held at once: each row holds its
    ``n_pages`` from ``charged_at`` until ``released_at``."""
    events = sorted([(r["charged_at"], r["n_pages"]) for r in request_log]
                    + [(r["released_at"], -r["n_pages"])
                       for r in request_log])
    held = peak = 0
    for _, delta in events:
        held += delta
        peak = max(peak, held)
    return peak


def serve_engine_path(card: str) -> dict:
    """Phase 4, path D: llama3-8b through the continuous engine over a
    paged KV arena, over HTTP, under concurrent traffic; checks (a) every
    row equals solo generation, (b) a dense engine over the same weights
    gives the same tokens and logprobs, (c) the launch counters equal the
    engines' steps and forwards, (d) the pool drains to 0 live pages,
    charged each request its pages, and its peak equals the most pages
    the rows held at once, (e) an eager paged engine on the same weights
    gives every row bitwise; and every engine step was a graph
    replay."""
    from lambdipy_tpu_torch.runtime.continuous import ContinuousBatcher
    from lambdipy_tpu_torch.runtime.handlers import (HandlerContext,
                                                     generate_handler,
                                                     kernel_launches)
    from lambdipy_tpu_torch.runtime.server import BundleServer

    spec = {"model": "llama3-8b", "dtype": "bfloat16", "quant": "int8",
            "extra": {**ENGINE_EXTRA, "max_new_tokens": "16",
                      "prefix_cache_mb": "0"}}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = generate_handler(spec, HandlerContext(device="cuda"))
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    cfg, engine = state.server.model.cfg, state.engine
    layers = cfg.layers
    log(f"path D: {spec['model']} ({layers} layers, hidden {cfg.hidden}, "
        f"{cfg.quant} weights, {cfg.attn_backend}, paged bf16 KV, "
        f"{engine.slots} slots, segment {engine.segment}, page "
        f"{engine.pool.page}, {engine.pool.capacity_pages} pages) built in "
        f"{boot_s:.1f} s")
    rng = torch.Generator().manual_seed(13)
    reqs = []
    for s_len, n, kind in BURST + JOINERS:
        body = {"tokens": torch.randint(1, cfg.vocab_size, (s_len,),
                                        generator=rng).tolist(),
                "max_new_tokens": n, **KNOBS.get(kind, {})}
        if kind in ("logprobs", "stream"):
            body["logprobs"] = True
        reqs.append((kind, body))
    # the eos row's eos: a token its solo decode emits mid-way, first
    # seen at or after a third of the row
    kind, body = reqs[7]
    solo = state.server.generate(body["tokens"], max_new_tokens=80,
                                 **KNOBS["eos"])[0].tolist()
    picks = [j for j in range(len(solo) // 3, len(solo))
             if solo[j] not in solo[:j]]
    body["eos_id"] = solo[picks[0]] if picks else solo[len(solo) // 2]
    log(f"path D: eos row's eos_id {body['eos_id']} (solo emits it first "
        f"at token {solo.index(body['eos_id'])} of 80)")

    server = BundleServer(state, port=0).start_background()
    url = server.url + "/invoke"
    resp, ttft = [None] * len(reqs), [None] * len(reqs)

    def send(i):
        kind, body = reqs[i]
        if kind == "stream":
            records, ttft[i] = _post_stream(url, body)
            if not records[-1].get("done"):
                raise SystemExit(f"path D: stream ended badly: {records[-1]}")
            resp[i] = {"ok": all(r.get("ok") for r in records),
                       "tokens": [[t for r in records[:-1]
                                   for t in r["tokens"][0]]],
                       "logprobs": [[x for r in records[:-1]
                                     for x in r["logprobs"][0]]]}
        else:
            resp[i] = http_json(url, body)

    try:
        health = http_json(server.url + "/healthz")
        if not (health.get("ok") and health["handler_meta"].get("kv_paged")):
            raise SystemExit(f"path D: /healthz not ok: {health}")
        set_launches_to_zero()  # counters to 0 just before the path
        walls, burst_s = _drive(send, reqs)
        launches = kernel_launches()
        metrics = http_json(server.url + "/metrics")
    finally:
        server.stop()
    stats = engine.stats()
    pool = engine.pool
    want = dict.fromkeys(KERNELS, 0)
    want["paged_decode_attention"] = layers * stats["steps"]
    want["int8_matmul"] = (7 * layers + 1) * stats["forwards"]
    log(f"path D launch counters: {launches}, implied {want} "
        f"({stats['steps']} engine steps, {stats['forwards']} forwards)")
    if launches != want or metrics["handler"]["kernels"] != launches:
        raise SystemExit(f"path D: launch counters {launches} != implied "
                         f"{want}")
    # every prefill a replay: the groups, the long rows
    programs = check_replays("D", metrics["handler"]["batching"],
                             stats["steps"],
                             prefills=stats["forwards"] - stats["steps"])
    log_pools("D (server)", metrics["handler"]["program_pools"])
    # (d) the pool drained; it charged each row ceil((s + n) / page)
    # pages; its peak is the most pages rows held at once, from the rows'
    # logged charge and release times
    pool.check_invariants()
    page_stats = pool.stats()
    charges = [-(-(len(body["tokens"]) + body["max_new_tokens"]) // pool.page)
               for _, body in reqs]
    peak = held_peak(engine.request_log)
    log(f"path D page pool after the drain: {page_stats['pages_live']} "
        f"pages live, {page_stats['alloc_pages']} pages charged in all "
        f"(the requests need {sum(charges)}), peak "
        f"{page_stats['pages_live_peak']} (most pages rows held at once by "
        f"their charge and release times: {peak}), invariants hold")
    if (page_stats["pages_live"] != 0
            or page_stats["alloc_pages"] != sum(charges)
            or page_stats["pages_live_peak"] != peak):
        raise SystemExit(f"path D: page pool did not drain, charged "
                         f"{page_stats['alloc_pages']} != {sum(charges)}, or "
                         f"its peak {page_stats['pages_live_peak']} != {peak}")

    # (a) every row against solo generation of the same request
    solo_out = []
    lp_diff = 0.0
    for (kind, body), r in zip(reqs, resp):
        knobs = _knobs(body)
        toks, lps = state.server.generate(
            body["tokens"], max_new_tokens=body["max_new_tokens"],
            return_logprobs=True, **knobs)
        solo_out.append((toks, lps))
        if not r.get("ok") or r["tokens"] != toks.tolist():
            raise SystemExit(f"path D: {kind} row ({len(body['tokens'])} "
                             f"tokens) differs from solo generation")
        if "logprobs" in r:
            lp_diff = max(lp_diff, float(np.abs(
                np.asarray(r["logprobs"]) - _as_served(lps)).max()))
    log(f"path D (a): all {len(reqs)} rows equal solo generation; "
        f"logprob max |diff| {lp_diff:.3e} (HTTP logprobs are rounded to 5 "
        f"decimals, compared with solo's rounded alike)")
    # window bucketing, on at the handler's defaults: the burst's segments
    # by window
    win = stats["decode_window"]
    log(f"path D decode_window (window bucketing "
        f"{stats['window_bucketing']}): {win['segments']} segments, "
        f"buckets {win['buckets']}, savings_ratio {win['savings_ratio']}, "
        f"attended_ratio {win['attended_ratio']} [{card}]")
    if not (stats["window_bucketing"] and win["segments"]
            and win["savings_ratio"] < 1):
        raise SystemExit(f"path D: the handler's engine did not bucket its "
                         f"windows: {win}")

    # (b) the same traffic through a dense engine on the same weights
    dense = ContinuousBatcher(state.server, slots=engine.slots,
                              segment=engine.segment)
    dense_out = [None] * len(reqs)

    def send_dense(i):
        _, body = reqs[i]
        knobs = _knobs(body)
        dense_out[i] = dense.generate(body["tokens"],
                                      max_new_tokens=body["max_new_tokens"],
                                      return_logprobs=True, **knobs)

    set_launches_to_zero()
    _drive(send_dense, reqs)
    dense_launches = kernel_launches()
    dstats = dense.stats()
    dwant = dict.fromkeys(KERNELS, 0)
    dwant["decode_attention"] = layers * dstats["steps"]
    dwant["int8_matmul"] = (7 * layers + 1) * dstats["forwards"]
    log(f"path D dense engine launch counters: {dense_launches}, implied "
        f"{dwant}")
    if dense_launches != dwant:
        raise SystemExit("path D: dense engine launch counters differ from "
                         "the implied counts")
    dense_solo = max(float(np.abs(d[1] - s_[1]).max())
                     for d, s_ in zip(dense_out, solo_out))
    for r, d in zip(resp, dense_out):
        same = r["tokens"] == d[0].tolist() and (
            "logprobs" not in r
            or np.array_equal(np.asarray(r["logprobs"]), _as_served(d[1])))
        if not same:
            raise SystemExit("path D (b): paged and dense engines differ")
    log(f"path D (b): paged (HTTP) and dense (direct) engines give equal "
        f"tokens and logprobs for every row; dense engine vs solo logprob "
        f"max |diff| {dense_solo:.3e} (unrounded)")
    dense.release()
    del dense

    # (e) the same traffic through an eager paged engine on the same
    # weights: every row bitwise the graph engines' (dense, unrounded)
    e_wall, e_out, e_stats = eager_engine_burst(state.server, reqs,
                                                charges)
    for kind_body, d, e in zip(reqs, dense_out, e_out):
        if not (np.array_equal(d[0], e[0]) and np.array_equal(d[1], e[1])):
            raise SystemExit(f"path D (e): {kind_body[0]} row of the eager "
                             f"engine differs from the graph engines'")
    log(f"path D (e): an eager paged engine gives every row's tokens and "
        f"logprobs bitwise ({e_stats['eager_steps']} eager steps); its "
        f"burst {e_wall:.3f} s, {new_tokens_of(reqs) / e_wall:.1f} tok/s "
        f"[{card}]")

    # (f) the same traffic through a depth-1 (synchronous) paged engine
    # on the same weights, driven directly in turns with the depth-2
    # engine: every row bitwise the depth-2 engines' (dense and eager
    # paged, unrounded); the bursts' tok/s and TTFT side by side
    depths = depth_bursts(state.server, engine, reqs, charges, card)
    for kind_body, d, e, f in zip(reqs, dense_out, e_out, depths.pop("out")):
        if not all(np.array_equal(a[j], f[j]) for a in (d, e)
                   for j in (0, 1)):
            raise SystemExit(f"path D (f): {kind_body[0]} row of the "
                             f"depth-1 engine differs from the depth-2 "
                             f"engines'")
    log(f"path D (f): a depth-1 paged engine gives every row's tokens and "
        f"logprobs bitwise the depth-2 engines' (dense and eager paged)")
    # (j) window bucketing off, beside the bucketing engine; (k) the aux
    # draft tier over the burst of 8
    window = _timed("path D (j)", window_off_burst, state.server, engine,
                    reqs, charges, dense_out, depths, card)
    aux = _timed("path D (k)", aux_burst, state.server, reqs[:8],
                 charges[:8], dense_out[:8], card)
    del dense_out, e_out
    # (g)-(i) the same burst with chunked prefill, off and on in turns
    chunked = chunked_turns(state.server, reqs, charges, solo_out, card)

    # numbers, all from the timed paged burst
    log_by = {(e["s"], e["n"]): e for e in engine.request_log}
    rows = []
    for i, (kind, body) in enumerate(reqs):
        e = log_by[(len(body["tokens"]), body["max_new_tokens"])]
        rows.append({"kind": kind, "prompt": len(body["tokens"]),
                     "new": body["max_new_tokens"], "wall_s": walls[i],
                     "http_ttft_s": ttft[i], "engine_ttft_s": e["ttft_s"],
                     "engine_wall_s": e["wall_s"]})
        log(f"path D request {i} ({kind}, {len(body['tokens'])} + "
            f"{body['max_new_tokens']} tokens): wall {walls[i]:.3f} s, TTFT "
            f"{e['ttft_s']:.3f} s (engine, from admission)"
            + (f", first streamed line {ttft[i]:.3f} s" if ttft[i] else "")
            + f" [{card}]")
    new_tokens = new_tokens_of(reqs)
    perf = {"burst_wall_s": burst_s, "new_tokens": new_tokens,
            "decode_tok_s": new_tokens / burst_s,
            "eager_engine_burst_wall_s": e_wall,
            "eager_engine_decode_tok_s": new_tokens / e_wall,
            "engine_steps": stats["steps"],
            "mean_rows_per_step": stats["mean_rows_per_step"],
            "arena_bytes": page_stats["bytes_total"],
            "max_memory_allocated_gib": (torch.cuda.max_memory_allocated()
                                         / 2**30)}
    for key, val in perf.items():
        log(f"path D {key}: {val} [{card}]")
    pipe = stats["pipeline"]
    log(f"path D pipeline (depth {stats['pipeline_depth']}, policy "
        f"{stats['policy']}, the HTTP burst): in_flight {pipe['in_flight']}, "
        f"drains {pipe['drains']}, wasted_overdecode_tokens "
        f"{pipe['wasted_overdecode_tokens']}, overlap_ratio "
        f"{pipe['overlap_ratio']}, fetch_block_s {pipe['fetch_block_s']} "
        f"(transport), device_wait_s {pipe['device_wait_s']}, wall_s "
        f"{pipe['wall_s']} [{card}]")
    sched = metrics["sched"]
    log(f"path D scheduler: policy {sched['policy']}, max_concurrency "
        f"{sched['max_concurrency']}, admitted {sched['admitted']}, "
        f"completed {sched['completed']}, shed {sched['shed']['total']}, "
        f"queue wait {sched['queue_wait']}")
    if (sched["admitted"] != len(reqs) or sched["shed"]["total"]
            or sched["policy"] != "fair" or stats["pipeline_depth"] != 2):
        raise SystemExit("path D: every request must pass the fair "
                         "scheduler unshed, into a depth-2 engine")
    perf["depths"] = depths
    perf["pipeline"] = pipe
    perf["contended"] = contended_burst(state.server, engine, reqs, card)
    trace = profile_engine(engine, [body["tokens"] for _, body in reqs[:8]],
                           card)
    out = {"spec": spec, "boot_s": boot_s, "launches": launches,
           "implied": want, "programs": programs,
           "eager_engine": e_stats, "dense_launches": dense_launches,
           "engine": stats, "dense_engine": dstats, "page_pool": page_stats,
           "peak_held_pages": peak, "logprob_diff_http_vs_solo": lp_diff,
           "logprob_diff_dense_vs_solo": dense_solo, "perf": perf,
           "requests": rows, "trace": trace, "card": card,
           "sched": sched, "chunked": chunked, "window": window, "aux": aux}
    t_front = time.perf_counter()
    out["F"] = serve_front_path(state, card)
    took("path F", t_front)
    t_fault = time.perf_counter()
    out["G"] = serve_fault_path(state, reqs, resp, solo_out, depths, card)
    took("path G", t_fault)
    t_warm = time.perf_counter()
    out["warm"] = warm_turns(state, reqs, resp, card)
    took("path D's warm turns", t_warm)
    del state, engine, server
    gc.collect()
    torch.cuda.empty_cache()
    return out


# the multi-row request beside the engine's burst: 4 rows of 500 tokens,
# 64 new, run as one batch by ``LlamaServer.generate``
MULTI_ROWS, MULTI_PROMPT, MULTI_NEW = 4, 500, 64


def contended_burst(server, engine, reqs, card: str) -> dict:
    """D's traffic driven directly through the paged engine twice: alone,
    then beside a multi-row ``generate`` sent 0.1 s into the burst, which
    takes the device lock a prefill or a segment of decode steps at a
    time, as the engine does. The engine rows' TTFT (from admission) and
    the burst's tok/s in each run."""
    import threading

    rng = torch.Generator().manual_seed(17)
    multi = [torch.randint(1, server.model.cfg.vocab_size, (MULTI_PROMPT,),
                           generator=rng).tolist()
             for _ in range(MULTI_ROWS)]
    server.generate(multi, max_new_tokens=MULTI_NEW)  # its graph captured

    def send(i):
        _, body = reqs[i]
        knobs = _knobs(body)
        engine.generate(body["tokens"], max_new_tokens=body["max_new_tokens"],
                        **knobs)

    out = {}
    for name in ("alone", "beside_multi_row"):
        seq0 = max(e["seq"] for e in engine.request_log)
        side = {}

        def run_multi(side=side):
            time.sleep(0.1)
            t0 = time.perf_counter()
            server.generate(multi, max_new_tokens=MULTI_NEW)
            torch.cuda.synchronize()
            side["wall_s"] = time.perf_counter() - t0

        th = threading.Thread(target=run_multi)
        if name != "alone":
            th.start()
        _, burst_s = _drive(send, reqs)
        if name != "alone":
            th.join(timeout=600)
        ttfts = [e["ttft_s"] for e in engine.request_log if e["seq"] > seq0]
        out[name] = {"burst_wall_s": burst_s,
                     "decode_tok_s": new_tokens_of(reqs) / burst_s,
                     "ttft_s": ttfts, "multi_row_wall_s": side.get("wall_s")}
        log(f"path D burst driven directly, {name.replace('_', ' ')}: "
            f"{burst_s:.3f} s, {new_tokens_of(reqs) / burst_s:.1f} tok/s, "
            f"engine TTFT mean {np.mean(ttfts):.3f} s max {max(ttfts):.3f} s"
            + (f"; the {MULTI_ROWS} x {MULTI_PROMPT}-token request "
               f"({MULTI_NEW} new) took {side['wall_s']:.3f} s"
               if side else "") + f" [{card}]")
    return out


def new_tokens_of(reqs) -> int:
    return sum(body["max_new_tokens"] for _, body in reqs)


def eager_engine_burst(server, reqs, charges):
    """Path D's traffic through an eager paged engine (``LlamaServer(model,
    graphs=False)``, its own arena of the pages the traffic charges plus
    the null page), driven directly: (burst seconds, each row's
    ``(tokens, logprobs)``, the engine's stats)."""
    from lambdipy_tpu_torch.models.llama import LlamaServer
    from lambdipy_tpu_torch.runtime.handlers import make_engine

    eager = make_engine(LlamaServer(server.model, graphs=False),
                        {**ENGINE_EXTRA, "kv_pages": str(sum(charges) + 1)})
    out = [None] * len(reqs)

    def send(i):
        _, body = reqs[i]
        knobs = _knobs(body)
        out[i] = eager.generate(body["tokens"],
                                max_new_tokens=body["max_new_tokens"],
                                return_logprobs=True, **knobs)

    _, wall = _drive(send, reqs)
    stats = eager.stats()
    if stats["replays"] or stats["eager_steps"] != stats["steps"] \
            or stats["prefill_replays"] or stats["eager_prefills"] != (
                stats["forwards"] - stats["steps"]):
        raise SystemExit("path D: the eager engine replayed a graph")
    eager.release()
    del eager
    gc.collect()
    torch.cuda.empty_cache()
    return wall, out, stats


def depth_bursts(server, engine, reqs, charges, card: str) -> dict:
    """D's traffic driven directly through the depth-2 paged engine (the
    HTTP run's) and a depth-1 paged engine on the same weights (its own
    arena of the pages the traffic charges plus the null page), depth 2
    then 1: each burst's wall, tok/s and the rows' TTFT (from admission),
    and the depth-1 burst's rows ``(tokens, logprobs)`` under ``out``."""
    from lambdipy_tpu_torch.runtime.handlers import make_engine

    sync = make_engine(server, {**ENGINE_EXTRA, "pipeline_depth": "1",
                                "kv_pages": str(sum(charges) + 1)})
    out = {"out": [None] * len(reqs)}
    turns = (engine, sync)
    for turn, eng in enumerate(turns):
        keep = eng is sync

        def send(i, eng=eng, keep=keep):
            _, body = reqs[i]
            knobs = _knobs(body)
            got = eng.generate(body["tokens"],
                               max_new_tokens=body["max_new_tokens"],
                               return_logprobs=True, **knobs)
            if keep:
                out["out"][i] = got

        seq0 = max((e["seq"] for e in eng.request_log), default=-1)
        before = eng.stats()
        _, burst_s = _drive(send, reqs)
        after = eng.stats()
        ttfts = [e["ttft_s"] for e in eng.request_log if e["seq"] > seq0]
        steps = after["steps"] - before["steps"]
        wasted = (after["pipeline"]["wasted_overdecode_tokens"]
                  - before["pipeline"]["wasted_overdecode_tokens"])
        drains = {c: n - before["pipeline"]["drains"].get(c, 0)
                  for c, n in after["pipeline"]["drains"].items()}
        name = f"depth{eng.pipeline_depth}"
        out.setdefault(name, []).append(
            {"burst_wall_s": burst_s,
             "decode_tok_s": new_tokens_of(reqs) / burst_s,
             "ttft_mean_s": float(np.mean(ttfts)),
             "ttft_max_s": max(ttfts), "steps": steps,
             "segments": after["segments"] - before["segments"],
             "wasted_overdecode_tokens": wasted, "drains": drains})
        log(f"path D burst driven directly at pipeline depth "
            f"{eng.pipeline_depth} (turn {turn + 1} of {len(turns)}): "
            f"{burst_s:.3f} s, "
            f"{new_tokens_of(reqs) / burst_s:.1f} tok/s, engine TTFT mean "
            f"{np.mean(ttfts):.3f} s max {max(ttfts):.3f} s; {steps} steps "
            f"in {after['segments'] - before['segments']} segments, "
            f"{wasted} tokens dropped, drains {drains} [{card}]")
        out[name][-1]["steady"] = steady_decode(eng, card)
    out["depth1_pipeline"] = sync.stats()["pipeline"]
    sync.release()
    del sync
    gc.collect()
    torch.cuda.empty_cache()
    return out


STEADY_NEW = 256  # 16 segments of one row, no joiner, no drain between


def steady_decode(engine, card: str) -> dict:
    """One greedy row of 16 prompt tokens and ``STEADY_NEW`` new ones
    alone through ``engine``: the host clock's ms per decode step after
    the first token. Against the depth-1 engine in the same call, the
    difference is the host time between segments that pipelining
    hides."""
    prompt = list(range(1, 17))
    engine.generate(prompt, max_new_tokens=32)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.generate(prompt, max_new_tokens=STEADY_NEW)
    wall = time.perf_counter() - t0
    _idle(engine)  # the row is logged at the barrier after it
    ttft = engine.request_log[-1]["ttft_s"]
    step_ms = (wall - ttft) / (STEADY_NEW - 1) * 1e3
    log(f"path D one row alone at pipeline depth {engine.pipeline_depth}: "
        f"{STEADY_NEW} tokens in {wall:.3f} s, TTFT {ttft:.3f} s, "
        f"{step_ms:.3f} ms per decode step after it [{card}]")
    return {"wall_s": wall, "ttft_s": ttft, "step_ms": step_ms}


def window_off_burst(server, engine, reqs, charges, ref_out, depths,
                     card: str) -> dict:
    """D (j): window bucketing, on at the handler's defaults. D's traffic
    driven directly through a paged engine with ``batch_window_bucketing
    = "0"`` (its own arena): every row bitwise the bucketing engines'
    (``ref_out``, D (b)'s dense engine); its only ``decode_window`` bucket
    the full window; its launches 32 x steps and 225 x forwards. Beside
    it, D's bucketing engine: its ``decode_window``, and tok/s of its
    depth-2 burst driven directly in this call (``depths``) against the
    off engine's, with each engine's ``compile_count``: under ``blocked``
    a window replays the full-window program, so bucketing adds no
    capture."""
    from lambdipy_tpu_torch.runtime.handlers import (kernel_launches,
                                                     make_engine)

    PROGRESS["stage"] = "D (j): window bucketing off"
    layers = server.model.cfg.layers
    off = make_engine(server, {**ENGINE_EXTRA,
                               "batch_window_bucketing": "0",
                               "kv_pages": str(sum(charges) + 1)})
    out = [None] * len(reqs)

    def send(i):
        _, body = reqs[i]
        out[i] = off.generate(body["tokens"],
                              max_new_tokens=body["max_new_tokens"],
                              return_logprobs=True, **_knobs(body))

    set_launches_to_zero()
    _, wall = _drive(send, reqs)
    _idle(off)
    launches = kernel_launches()
    stats, on = off.stats(), engine.stats()
    want = dict.fromkeys(KERNELS, 0)
    want["paged_decode_attention"] = layers * stats["steps"]
    want["int8_matmul"] = (7 * layers + 1) * stats["forwards"]
    same = all(_rows_equal(a, b) for a, b in zip(out, ref_out))
    off_tok_s = new_tokens_of(reqs) / wall
    on_tok_s = depths["depth2"][0]["decode_tok_s"]
    log(f"path D (j): window bucketing off: {wall:.3f} s, {off_tok_s:.1f} "
        f"tok/s, compile_count {stats['compile_count']}, decode_window "
        f"{stats['decode_window']}; bucketing on (D's engine, its depth-2 "
        f"burst driven directly in this call): {on_tok_s:.1f} tok/s, "
        f"compile_count {on['compile_count']}; rows bitwise the bucketing "
        f"engines': {same}; launches {launches} implied {want} [{card}]")
    if not (same and launches == want and not stats["window_bucketing"]
            and list(stats["decode_window"]["buckets"])
            == [str(off.cache_len)] and stats["eager_steps"] == 0
            and off.pool.stats()["pages_live"] == 0):
        raise SystemExit("path D (j): the engine with window bucketing off "
                         "failed its checks")
    off.release()
    del off
    gc.collect()
    torch.cuda.empty_cache()
    return {"wall_s": wall, "tok_s": off_tok_s, "on_tok_s": on_tok_s,
            "compile_count": stats["compile_count"],
            "on_compile_count": on["compile_count"],
            "decode_window": stats["decode_window"],
            "on_decode_window": on["decode_window"], "launches": launches,
            "implied": want}


AUX_SPEC_K = 8
AUX_LAYERS = 1


def aux_burst(server, reqs, charges, ref_out, card: str) -> dict:
    """D (k): the aux draft tier. A twin of D's model
    (``models/registry.py draft_twin``: llama3-8b's widths and
    vocabulary, ``AUX_LAYERS`` layer, bf16, no int8) boots on the card
    beside D's server (seconds and GiB printed), and D's 8-request burst
    runs through a paged engine at ``spec_k = 8`` with ``draft_mode =
    "aux"`` and ``AuxModelDraft`` over the twin: every row bitwise the
    spec-off rows (``ref_out``); the launches 225 x the target's forwards
    (a verify is one), 32 x its steps on kernel 3, and ``AUX_LAYERS`` x
    the twin's decode steps on kernel 1 (the twin serves float K/V and
    float weights: no kernel 2); every step a replay; no proposal raised
    (``draft_errors`` 0). Prints the
    ``providers["aux"]`` counters, acceptance, the provider demotions,
    tok/s, the proposals and their mean host wall beside the engine's mean
    wall per segment (a proposal runs on the engine thread and, on the
    card, waits for the segment in flight)."""
    from lambdipy_tpu_torch.models import registry
    from lambdipy_tpu_torch.runtime.continuous import AuxModelDraft
    from lambdipy_tpu_torch.runtime.handlers import (kernel_launches,
                                                     make_engine)
    from lambdipy_tpu_torch.runtime.metrics import SpecDecodeStats

    PROGRESS["stage"] = "D (k): the aux draft tier"
    layers = server.model.cfg.layers
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    twin = registry.draft_twin(registry.TorchModel(server.model.cfg),
                               layers=AUX_LAYERS, device="cuda")
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    twin_gib = (torch.cuda.memory_allocated() - mem0) / 2**30
    prov = AuxModelDraft(twin)
    eng = make_engine(server, {**ENGINE_EXTRA, "spec_k": str(AUX_SPEC_K),
                               "kv_pages": str(sum(charges) + 1)})
    eng.draft_provider, eng.draft_mode = prov, "aux"
    eng.spec_metrics = SpecDecodeStats()
    tw0 = twin.program_stats()
    set_launches_to_zero()
    out, wall = spec_burst(eng, reqs)
    launches = kernel_launches()
    tw1 = twin.program_stats()
    twin_steps = sum(tw1[k] - tw0[k] for k in ("replays", "eager_steps"))
    stats = eng.stats()
    want = spec_launches(layers, "paged_decode_attention", stats["forwards"],
                         stats["steps"])
    want["decode_attention"] += AUX_LAYERS * twin_steps
    rep = stats["spec"]
    aux = rep["draft"]["providers"].get("aux")
    same = all(_rows_equal(a, b) for a, b in zip(out, ref_out))
    new = new_tokens_of(reqs)
    pipe = stats["pipeline"]
    seg_ms = 1e3 * pipe["wall_s"] / max(1, stats["segments"])
    prop_ms = 1e3 * prov.propose_s / max(1, prov.proposals)
    log(f"path D (k): the aux draft twin ({AUX_LAYERS} layer, hidden "
        f"{twin.model.cfg.hidden}, vocab {twin.model.cfg.vocab_size}, "
        f"{twin.model.cfg.dtype}) booted in {boot_s:.2f} s, {twin_gib:.2f} "
        f"GiB; D's burst at spec_k={AUX_SPEC_K}, draft_mode=aux: {new} "
        f"tokens in {wall:.3f} s, {new / wall:.1f} tok/s; "
        f"providers['aux'] {aux}, acceptance {rep['acceptance_rate']}, "
        f"tokens_per_step {rep['tokens_per_step']}, demotions "
        f"{rep['draft']['fallbacks']}; {prov.proposals} proposals, mean "
        f"{prop_ms:.2f} ms of host wall each ({eng.draft_errors} raised), "
        f"against {seg_ms:.2f} ms of engine wall per segment; "
        f"{stats['steps']} steps "
        f"({stats['verify_segments']} verifies), twin decode steps "
        f"{twin_steps}, twin compile_count {tw1['compile_count']}; bitwise "
        f"spec off: {same}; launches {launches} implied {want} [{card}]")
    if not (same and aux and aux["steps"] > 0 and prov.proposals > 0
            and eng.draft_errors == 0 and launches == want and stats["replays"] == stats["steps"]
            and stats["eager_steps"] == 0
            and eng.pool.stats()["pages_live"] == 0):
        raise SystemExit("path D (k): the aux engine failed its checks")
    eng.release()
    del eng, prov, twin
    gc.collect()
    torch.cuda.empty_cache()
    return {"twin_boot_s": boot_s, "twin_gib": twin_gib, "wall_s": wall,
            "tok_s": new / wall, "aux": aux, "spec": rep,
            "propose_mean_ms": prop_ms, "segment_mean_ms": seg_ms,
            "twin_decode_steps": twin_steps, "launches": launches,
            "implied": want}


# D's chunked turns: the server's prefill_chunk (llama3-8b's window of
# 8,192 is a multiple). The burst's 1,000-, 2,000- and 4,000-token rows
# walk 1, 3 and 7 chunks of 512 and continue a tail of 488, 464 and 416
# tokens at the 512 bucket; the 500-token row is not past the width.
CHUNK = 512


def _rows_equal(a, b) -> bool:
    return np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def chunked_turns(server, reqs, charges, solo_out, card: str) -> dict:
    """D's burst driven directly through two paged depth-2 engines on the
    same weights, one over ``server`` (chunking off, as D) and one over a
    ``prefill_chunk=512`` server, in turns off, 512, 512, off, each with
    the launch counters from 0: the burst's tok/s, steps, the segments
    dispatched while a walk was in progress, the TTFT of the rows that
    arrived while the 4,000-token row prefilled and the long rows' own
    TTFT. Checks: (g) every chunked row of the 512 engines, and of a
    paged depth-1 and dense depth-2 and depth-1 engine on the chunked
    server, bitwise its solo ``generate(row[split:], prefix=row[:split])``
    there, every other row bitwise the off engine's; (h) against plain
    solo ``generate`` the chunked rows' greedy tokens equal and the first
    logprob within the routed bound; (i) per turn, paged decode
    attention = 32 x engine steps and the int8 matmul = 225 x forwards,
    the walk chunks counted."""
    from lambdipy_tpu_torch.models.llama import LlamaServer
    from lambdipy_tpu_torch.runtime.continuous import (GROUP_PREFILL_MAX,
                                                       ContinuousBatcher)
    from lambdipy_tpu_torch.runtime.handlers import (kernel_launches,
                                                     make_engine)

    layers = server.model.cfg.layers
    chunked = LlamaServer(server.model, prefill_chunk=CHUNK)
    if chunked.prefill_chunk != CHUNK:
        raise SystemExit(f"path D: prefill_chunk {CHUNK} normalised to "
                         f"{chunked.prefill_chunk}")
    lens = [len(body["tokens"]) for _, body in reqs]
    walked = [s > GROUP_PREFILL_MAX and s > CHUNK for s in lens]
    splits = [(s - 1) // CHUNK * CHUNK if w else 0
              for s, w in zip(lens, walked)]
    long_seq = lens.index(max(lens))
    pages = {**ENGINE_EXTRA, "kv_pages": str(sum(charges) + 1)}
    engines = {"off": make_engine(server, pages),
               "512": make_engine(chunked, pages)}
    for eng in engines.values():  # each engine's two graphs captured
        eng.generate(list(range(1, 17)), max_new_tokens=32)
        eng.generate(list(range(1, 17)), max_new_tokens=32, temperature=0.8,
                     seed=1)

    def drive(eng, counted: bool):
        outs = [None] * len(reqs)

        def send(i):
            _, body = reqs[i]
            outs[i] = eng.generate(body["tokens"],
                                   max_new_tokens=body["max_new_tokens"],
                                   return_logprobs=True, **_knobs(body))

        seq0 = max((e["seq"] for e in eng.request_log), default=-1)
        before = eng.stats()
        if counted:
            set_launches_to_zero()  # counters to 0 just before the turn
        _, burst_s = _drive(send, reqs)
        _idle(eng)
        launches = kernel_launches() if counted else None
        after = eng.stats()
        logs = sorted((e for e in eng.request_log if e["seq"] > seq0),
                      key=lambda e: e["seq"])
        return outs, burst_s, launches, before, after, logs

    out = {"turns": [], "launches": dict.fromkeys(KERNELS, 0)}
    rows = {}
    for turn, name in enumerate(("off", "512", "512", "off")):
        eng = engines[name]
        outs, burst_s, launches, before, after, logs = drive(eng, True)
        rows.setdefault(name, outs)
        delta = {k: after[k] - before[k]
                 for k in ("steps", "segments", "forwards", "walk_segments",
                           "prefill_chunks", "row_prefills",
                           "prefill_replays", "eager_prefills")}
        # every prefill a replay: groups, long rows, chunks and tails
        if delta["eager_prefills"] or delta["prefill_replays"] != (
                delta["forwards"] - delta["steps"]):
            raise SystemExit(f"path D: chunked turn {turn + 1} ran "
                             f"{delta['prefill_replays']} prefill replays "
                             f"and {delta['eager_prefills']} eager prefills "
                             f"for {delta['forwards'] - delta['steps']} "
                             f"prefill forwards")
        want = dict.fromkeys(KERNELS, 0)
        want["paged_decode_attention"] = layers * delta["steps"]
        want["int8_matmul"] = (7 * layers + 1) * delta["forwards"]
        if launches != want:
            raise SystemExit(f"path D (i): chunked turn {turn + 1} ({name}) "
                             f"launch counters {launches} != implied {want}")
        for k, n in launches.items():
            out["launches"][k] += n
        ttft = {(e["s"], e["n"]): e["ttft_s"] for e in logs}
        if len(ttft) != len(reqs):
            raise SystemExit("path D: a chunked turn logged other rows than "
                             "its burst's")
        big = logs[[e["s"] for e in logs].index(lens[long_seq])]
        during = [e["ttft_s"] for e in logs if e is not big
                  and big["t0"] <= e["t0"] <= big["prefilled_at"]]
        rec = {"prefill_chunk": eng.server.prefill_chunk,
               "burst_wall_s": burst_s,
               "decode_tok_s": new_tokens_of(reqs) / burst_s, **delta,
               "long_row_prefill_s": big["prefilled_at"] - big["t0"],
               "ttft_arrived_during_long_prefill_s": during,
               "ttft_long_rows_s": {s: ttft[s, body["max_new_tokens"]]
                                    for s, w, (_, body)
                                    in zip(lens, walked, reqs) if w},
               "ttft_short_rows_mean_s": float(np.mean(
                   [t for (s, _), t in ttft.items()
                    if s <= GROUP_PREFILL_MAX])),
               "ttft_mean_s": float(np.mean(list(ttft.values())))}
        out["turns"].append(rec)
        log(f"path D chunked turn {turn + 1} of 4 (prefill_chunk "
            f"{rec['prefill_chunk']}): {burst_s:.3f} s, "
            f"{rec['decode_tok_s']:.1f} tok/s, {delta['steps']} steps in "
            f"{delta['segments']} segments, {delta['walk_segments']} "
            f"segments dispatched during walks, {delta['prefill_chunks']} "
            f"walk chunks; the {lens[long_seq]}-token row prefilled in "
            f"{rec['long_row_prefill_s']:.3f} s from admission; TTFT of the "
            f"{len(during)} rows that arrived meanwhile "
            f"{[round(t, 3) for t in during]} s, of the long rows "
            f"{ {s: round(t, 3) for s, t in rec['ttft_long_rows_s'].items()} }"
            f" s, short rows' mean {rec['ttft_short_rows_mean_s']:.3f} s, "
            f"all rows' mean {rec['ttft_mean_s']:.3f} s [{card}]")
        if name == "512" and delta["prefill_chunks"] != sum(
                s // CHUNK for s in splits):
            raise SystemExit("path D: the walks ran other chunks than the "
                             "rows imply")
    log(f"path D (i): in each chunked turn paged decode attention = "
        f"{layers} x engine steps and int8 matmul = {7 * layers + 1} x "
        f"forwards (walk chunks and continuations counted)")
    for eng in engines.values():
        eng.release()

    # (g) the chunked rows against their solo prefix runs on the chunked
    # server, the rest against the off engine's rows, in four engines
    solo = {}
    for i, (_, body) in enumerate(reqs):
        if walked[i]:
            row, sp = body["tokens"], splits[i]
            solo[i] = chunked.generate(row[sp:], prefix=row[:sp],
                                       max_new_tokens=body["max_new_tokens"],
                                       return_logprobs=True, **_knobs(body))
    with chunked._prefix_lock:
        chunked._prefixes.clear()
    checked = {"paged depth 2": rows["512"]}
    eager_chunked = LlamaServer(server.model, graphs=False,
                                prefill_chunk=CHUNK)
    for label, make in (
            ("eager paged depth 2", lambda: make_engine(eager_chunked,
                                                        pages)),
            ("paged depth 1", lambda: make_engine(
                chunked, {**pages, "pipeline_depth": "1"})),
            ("dense depth 2", lambda: ContinuousBatcher(
                chunked, slots=8, segment=16, pipeline_depth=2)),
            ("dense depth 1", lambda: ContinuousBatcher(
                chunked, slots=8, segment=16, pipeline_depth=1))):
        eng = make()
        checked[label] = drive(eng, False)[0]
        eng.release()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    for label, outs in checked.items():
        for i, got in enumerate(outs):
            want = solo[i] if walked[i] else rows["off"][i]
            if not _rows_equal(got, want):
                raise SystemExit(
                    f"path D (g): the {lens[i]}-token row of the {label} "
                    f"chunked engine differs from its "
                    + ("solo prefix run" if walked[i] else "unchunked row"))
    log(f"path D (g): every chunked row ({sum(walked)} per burst) of the "
        f"paged depth-2 and depth-1, dense depth-2 and depth-1 and eager "
        f"paged depth-2 engines bitwise its solo generate(row[split:], "
        f"prefix=row[:split]) on the prefill_chunk={CHUNK} server, every "
        f"other row bitwise the unchunked engine's: graph chunks, tails, "
        f"groups and long rows bitwise their eager twins")
    del eager_chunked

    # (h) the routed bound against plain unchunked solo generate
    gaps, bitwise = {}, {}
    for i in solo:
        got, plain = rows["512"][i], solo_out[i]
        greedy = "temperature" not in reqs[i][1]
        gaps[lens[i]] = float(abs(got[1][0, 0] - plain[1][0, 0]))
        bitwise[lens[i]] = _rows_equal(got, plain)
        if (greedy and not np.array_equal(got[0], plain[0])) \
                or gaps[lens[i]] > ROUTED_LOGPROB_GAP:
            raise SystemExit(
                f"path D (h): the {lens[i]}-token chunked row left its bound "
                f"against plain solo generate: greedy tokens equal "
                f"{np.array_equal(got[0], plain[0])}, first-token logprob "
                f"gap {gaps[lens[i]]:.3e}")
    log(f"path D (h): chunked rows against plain solo generate: greedy "
        f"tokens equal, first-token logprob gaps {gaps} (bound "
        f"{ROUTED_LOGPROB_GAP}); bitwise by row {bitwise}")
    out["first_logprob_gap_vs_plain"] = gaps
    out["bitwise_vs_plain"] = bitwise
    del chunked, engines, solo, rows, checked
    gc.collect()
    torch.cuda.empty_cache()
    return out


# path F: the serving front (scheduler, /v1/completions, SSE, /shutdown)
# on D's handler: a second server with 2 run slots and a queue of 2
FRONT_SCHED = {"max_concurrency": 2, "queue_cap": 2}
FRONT_NEW = 24
# the burst's rows run ~0.5 s on the card, far longer than its last 6
# requests take to arrive: exactly concurrency plus queue are admitted
BURST_NEW = 64
FRONT_KNOBS = {"greedy": {"temperature": 0.0},
               "seeded": {"temperature": 0.8, "top_p": 0.9, "seed": 7}}


def _http(url: str, body: dict, headers: dict | None = None,
          raw: bool = False):
    """POST ``body``: (status, JSON body or raw bytes, headers); error
    statuses carry their body too."""
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            data, code, hdrs = resp.read(), resp.status, dict(resp.headers)
    except urllib.error.HTTPError as e:
        data, code, hdrs = e.read(), e.code, dict(e.headers)
    return code, (data if raw else json.loads(data)), hdrs


def _sse_events(raw: bytes) -> list:
    return [line[6:] if line[6:] == b"[DONE]" else json.loads(line[6:])
            for line in raw.split(b"\n") if line.startswith(b"data: ")]


def serve_front_path(state, card: str) -> dict:
    """Path F: D's handler (no second 8B load) behind a second
    ``BundleServer`` with ``FRONT_SCHED``: (a) ``/v1/completions`` with a
    token-array prompt gives ``/invoke``'s tokens for the same body,
    greedy and seeded; (b) its SSE chunks put together equal (a), ending
    in a ``finish_reason`` chunk and ``data: [DONE]``; (c) a burst of 8:
    the 4 over concurrency plus queue are shed 503 ``queue_full`` with
    Retry-After >= 1, counted by reason and class in ``/metrics``, and
    every admitted row equals its solo tokens; (d) a 1 ms
    ``x-deadline-ms`` is shed 503; (e) with both run slots taken, an
    interactive request is granted before a background one that came
    first (a fresh server, so the fair policy starts from no credit);
    (f) ``POST /shutdown`` lets the request in flight finish with 200
    and the next is refused. The launch counters, from 0 before the
    traffic, equal what the engine's steps and forwards imply."""
    import threading

    from lambdipy_tpu_torch.runtime.handlers import kernel_launches
    from lambdipy_tpu_torch.runtime.server import BundleServer

    server, engine = state.server, state.engine
    layers = server.model.cfg.layers
    rng = torch.Generator().manual_seed(23)

    def prompt(n):
        return torch.randint(1, server.model.cfg.vocab_size, (n,),
                             generator=rng).tolist()

    solo_checks = []  # (tokens served, prompt, new tokens, knobs)
    stats0 = engine.stats()
    set_launches_to_zero()
    t0 = time.perf_counter()
    srv = BundleServer(state, port=0, sched=FRONT_SCHED).start_background()
    if srv.sched.config.max_concurrency != 2:
        raise SystemExit("path F: the pinned max_concurrency was not kept")
    # (a), (b)
    for name, knobs in FRONT_KNOBS.items():
        p = prompt(40)
        code_i, inv, _ = _http(srv.url + "/invoke",
                               {"tokens": p, "max_new_tokens": FRONT_NEW,
                                **knobs})
        body = {"prompt": p, "max_tokens": FRONT_NEW, **knobs}
        code_c, comp, _ = _http(srv.url + "/v1/completions", body)
        code_s, raw, hdrs = _http(srv.url + "/v1/completions",
                                  {**body, "stream": True}, raw=True)
        toks = comp["choices"][0]["tokens"] if code_c == 200 else None
        events = _sse_events(raw) if code_s == 200 else []
        chunks = [e["choices"][0] for e in events[:-1]
                  if isinstance(e, dict) and "choices" in e]
        streamed = [t for c in chunks for t in c["tokens"]]
        if not (code_i == code_c == 200 and toks == inv["tokens"][0]):
            raise SystemExit(f"path F (a): {name} /v1/completions differs "
                             f"from /invoke")
        if not (events and events[-1] == b"[DONE]" and streamed == toks
                and chunks[-1]["finish_reason"] == "length"
                and hdrs.get("Content-Type") == "text/event-stream"):
            raise SystemExit(f"path F (b): {name} SSE stream differs: "
                             f"{events[-2:]}")
        solo_checks.append((toks, p, FRONT_NEW, knobs))
        log(f"path F (a), (b): {name} /v1/completions = /invoke, "
            f"{len(chunks) - 1} SSE chunks + finish_reason "
            f"{chunks[-1]['finish_reason']!r} + [DONE] = the same "
            f"{len(toks)} tokens")
    # (c) a burst of 8: the first 2 take the run slots, then the other
    # 6 at once: 2 queue, 4 are shed
    classes = ["interactive", "batch", "background"]
    burst = [(prompt(64), classes[i % 3]) for i in range(8)]
    results = [None] * 8
    gate = threading.Barrier(6)

    def fire(i):
        if i >= 2:
            gate.wait()
        p, cls = burst[i]
        results[i] = _http(srv.url + "/invoke",
                           {"tokens": p, "max_new_tokens": BURST_NEW},
                           headers={"x-priority": cls})

    threads = [threading.Thread(target=fire, args=(i,)) for i in range(8)]
    for i, th in enumerate(threads):
        th.start()
        limit = time.monotonic() + 120
        while i < 2 and srv.sched.report()["running"] <= i:
            if time.monotonic() > limit:
                raise SystemExit("path F (c): a request did not start")
            time.sleep(0.002)
    for th in threads:
        th.join(timeout=600)
    ok = [i for i, r in enumerate(results) if r[0] == 200]
    shed = [i for i, r in enumerate(results) if r[0] != 200]
    metrics = http_json(srv.url + "/metrics")["sched"]
    want_cls = {}
    for i in shed:
        want_cls[burst[i][1]] = want_cls.get(burst[i][1], 0) + 1
    bad = [results[i] for i in shed
           if not (results[i][0] == 503
                   and results[i][1].get("shed") == "queue_full"
                   and int(results[i][2].get("Retry-After", 0)) >= 1)]
    log(f"path F (c): burst of 8 -> {len(ok)} admitted, {len(shed)} shed "
        f"503 queue_full; sched shed {metrics['shed']}")
    if (len(ok) != sum(FRONT_SCHED.values()) or bad
            or metrics["shed"]["by_reason"] != {"queue_full": len(shed)}
            or metrics["shed"]["by_class"] != want_cls):
        raise SystemExit(f"path F (c): admitted {len(ok)}, bad sheds "
                         f"{bad[:1]}, sched {metrics['shed']}")
    for i in ok:
        solo_checks.append((results[i][1]["tokens"][0], burst[i][0],
                            BURST_NEW, {}))
    # (d) a deadline no request can meet
    code, body, hdrs = _http(srv.url + "/invoke",
                             {"tokens": prompt(16), "max_new_tokens": 8},
                             headers={"x-deadline-ms": "1"})
    reason = body.get("shed", "")
    if code != 503 or not (reason == "deadline" or "cancelled" in reason) \
            or int(hdrs.get("Retry-After", 0)) < 1:
        raise SystemExit(f"path F (d): a 1 ms deadline answered {code} "
                         f"{body}")
    log(f"path F (d): a 1 ms x-deadline-ms is answered 503 {reason!r}")
    # (e) interactive granted before an earlier background request
    fresh = BundleServer(state, port=0,
                         sched=FRONT_SCHED).start_background()
    done, sent = {}, {}

    def call(key, n, cls, p):
        sent[key] = time.monotonic()
        done[key] = _http(fresh.url + "/v1/completions",
                          {"prompt": p, "max_tokens": n, "temperature": 0},
                          headers={"x-priority": cls})

    def wait_for(pred, what):
        limit = time.monotonic() + 120
        while not pred():
            if time.monotonic() > limit:
                raise SystemExit(f"path F (e): timed out waiting for {what}")
            time.sleep(0.002)

    order = [("long1", 64, "interactive"), ("long2", 160, "interactive"),
             ("bg", 8, "background"), ("ia", 8, "interactive")]
    threads = []
    for k, (key, n, cls) in enumerate(order):
        threads.append(threading.Thread(target=call,
                                        args=(key, n, cls, prompt(32))))
        threads[-1].start()
        if k < 2:
            wait_for(lambda k=k: fresh.sched.report()["running"] == k + 1,
                     f"{key} to run")
        else:
            wait_for(lambda k=k: fresh.sched.queue.depth() == k - 1,
                     f"{key} to queue")
    for th in threads:
        th.join(timeout=600)
    fresh.stop()
    granted = {key: sent[key] + done[key][1]["queue_wait_ms"] / 1e3
               for key in ("bg", "ia")}
    log(f"path F (e): both slots taken, a background request then an "
        f"interactive one queued; granted ia {granted['ia'] - sent['bg']:.3f}"
        f" s and bg {granted['bg'] - sent['bg']:.3f} s after bg was sent")
    if not all(done[k][0] == 200 for k in done) \
            or granted["ia"] >= granted["bg"]:
        raise SystemExit("path F (e): interactive was not granted before "
                         "background under contention")
    # (f) /shutdown drains: the request in flight ends 200, the next is
    # refused
    inflight = {}
    p = prompt(48)
    th = threading.Thread(target=lambda: inflight.setdefault(
        "r", _http(srv.url + "/invoke", {"tokens": p, "max_new_tokens": 64})))
    th.start()
    limit = time.monotonic() + 60
    while srv._inflight == 0 and time.monotonic() < limit:
        time.sleep(0.002)
    code_s, body_s, _ = _http(srv.url + "/shutdown", {})
    try:
        code_n, body_n, _ = _http(srv.url + "/invoke",
                                  {"tokens": p, "max_new_tokens": 4})
        refused = code_n == 503 and body_n.get("shed") == "draining"
    except OSError:  # the socket already closed
        refused, code_n = True, "connection refused"
    th.join(timeout=600)
    code_r, body_r, _ = inflight["r"]
    log(f"path F (f): /shutdown {code_s}; the request in flight {code_r}, "
        f"the next {code_n}")
    if code_s != 200 or code_r != 200 or not refused:
        raise SystemExit("path F (f): /shutdown did not drain and refuse")
    solo_checks.append((body_r["tokens"][0], p, 64, {}))
    srv.stop()
    wall_s = time.perf_counter() - t0
    launches = kernel_launches()
    stats = engine.stats()
    steps = stats["steps"] - stats0["steps"]
    forwards = stats["forwards"] - stats0["forwards"]
    want = dict.fromkeys(KERNELS, 0)
    want["paged_decode_attention"] = layers * steps
    want["int8_matmul"] = (7 * layers + 1) * forwards
    log(f"path F launch counters: {launches}, implied {want} ({steps} "
        f"engine steps, {forwards} forwards)")
    if launches != want:
        raise SystemExit("path F: launch counters differ from the implied "
                         "counts")
    for toks, p, n, knobs in solo_checks:
        if toks != server.generate(p, max_new_tokens=n,
                                   **knobs)[0].tolist():
            raise SystemExit("path F: a served row differs from solo "
                             "generation")
    log(f"path F: all {len(solo_checks)} served rows equal solo generation; "
        f"{wall_s:.1f} s of traffic [{card}]")
    return {"launches": launches, "implied": want, "wall_s": wall_s,
            "burst": {"admitted": len(ok), "shed": len(shed)},
            "sched": metrics, "grant_s": {k: granted[k] - sent["bg"]
                                          for k in granted}}


# path G: engine fault isolation on D's handler, engine and weights (8
# slots, segment 16, depth 2): a replay, the watchdog on a real wait, the
# ladder, prefix rows replayed over their pages, and the default path
FAULT_WATCHDOG_S = 1.0
# the stall enqueued on the serving stream between two segments: past the
# watchdog, so the next segment's wait trips; short enough that what the
# replay waits for after the trip (the stall's last ~0.5 s) stays inside it
FAULT_STALL_S = 1.7
FAULT_TRIP_SLACK_S = 0.5  # a trip lands within the watchdog plus this
# (c): the ladder's window (its own two failures, not those of (a) and
# (b)) and the clean interval after which it restores
FAULT_WINDOW_S = 5.0
FAULT_CLEAN_S = 2.0
G_STREAMED = (0, 3)  # (a) streams the burst's 16- and 500-token rows


def _stall_cycles_per_s() -> float:
    """``torch.cuda._sleep`` cycles per second on this card, timed."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(1000)
    start.record()
    torch.cuda._sleep(200_000_000)
    end.record()
    torch.cuda.synchronize()
    return 200_000_000 / (start.elapsed_time(end) / 1e3)


def _faults_delta(before: dict, after: dict) -> dict:
    """What one phase added to the engine's ``faults`` block."""
    a, b = after["faults"], before["faults"]
    return {"failures": {k: v - b["failures"].get(k, 0)
                         for k, v in a["failures"].items()
                         if v != b["failures"].get(k, 0)},
            "watchdog_trips": a["watchdog_trips"] - b["watchdog_trips"],
            "replays": {k: a["replays"][k] - b["replays"][k]
                        for k in ("attempted", "succeeded")},
            "degrade_steps": {k: v - b["degrade_steps"].get(k, 0)
                              for k, v in a["degrade_steps"].items()
                              if v != b["degrade_steps"].get(k, 0)},
            "degrade_level": a["degrade_level"],
            "recoveries": a["recoveries"] - b["recoveries"],
            "restores": a["restores"] - b["restores"],
            "wedged": a["wedged"]}


def _engine_launches(phase: str, before: dict, after: dict, layers: int,
                     extra_forwards: int = 0) -> dict:
    """The launch counters since they were set to 0 must equal what the
    engine's steps and forwards (plus ``extra_forwards``: walk chunks and
    continuations) imply: the failed attempts' dispatched steps and every
    replay's prefill counted."""
    from lambdipy_tpu_torch.runtime.handlers import kernel_launches

    launches = kernel_launches()
    steps = after["steps"] - before["steps"]
    forwards = after["forwards"] - before["forwards"] + extra_forwards
    want = dict.fromkeys(KERNELS, 0)
    want["paged_decode_attention"] = layers * steps
    want["int8_matmul"] = (7 * layers + 1) * forwards
    log(f"path G ({phase}) launch counters: {launches}, implied {want} "
        f"({steps} engine steps, {forwards} forwards)")
    if launches != want:
        raise SystemExit(f"path G ({phase}): launch counters {launches} != "
                         f"implied {want}")
    return launches


def _wait_decoding(engine, timeout: float = 120.0) -> None:
    """Until a live row of ``engine`` has booked a segment."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with engine._lock:
            if any(e is not None and len(e["toks"]) >= engine.segment
                   for e in engine._active):
                return
        time.sleep(0.002)
    raise SystemExit("path G: no row started decoding")


def _stall(cycles_per_s: float) -> float:
    """``FAULT_STALL_S`` of ``torch.cuda._sleep`` on the serving stream,
    between two of the engine's segments (it holds ``DEVICE_LOCK`` for
    each dispatch and wait); returns when it was enqueued."""
    from lambdipy_tpu_torch.models.graphs import DEVICE_LOCK

    with DEVICE_LOCK:
        torch.cuda._sleep(int(FAULT_STALL_S * cycles_per_s))
        return time.monotonic()


def _until_health(url: str, pred, timeout: float = 60.0) -> tuple:
    """Poll ``/healthz`` until ``pred(health)``: (health, when)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        h = http_json(url + "/healthz")
        if pred(h):
            return h, time.monotonic()
        time.sleep(0.005)
    raise SystemExit(f"path G: /healthz never met its condition: {h}")


def fault_replay(url, engine, reqs, d_resp, solo_out, layers, card) -> dict:
    """(a) ``segment_fetch:exception@seg=3`` armed over
    ``/v1/debug/faults``, then D's burst of 8 (rows 0 and 3 streamed):
    every row that has not streamed replays bitwise its solo run and D's
    unfaulted row; a streamed row that got a chunk ends with the injected
    error; the pool drains; the recovery time is from the failure to the
    last replayed row's completion."""
    code, out, _ = _http(url + "/v1/debug/faults",
                         {"spec": "segment_fetch:exception@seg=3"})
    if code != 200 or not out.get("ok"):
        raise SystemExit(f"path G (a): arming failed: {out}")
    burst = reqs[:8]
    resp = [None] * len(burst)

    def send(i):
        _, body = burst[i]
        if i in G_STREAMED:
            records, _ = _post_stream(url + "/invoke", body)
            resp[i] = {"records": records}
        else:
            resp[i] = http_json(url + "/invoke", body)

    before = engine.stats()
    seq0 = max(e["seq"] for e in engine.request_log)
    n_fail = len(engine.failure_log)
    set_launches_to_zero()
    _drive(send, burst)
    _idle(engine)
    after = engine.stats()
    launches = _engine_launches("a", before, after, layers)
    _http(url + "/v1/debug/faults", {"clear": True})
    delta = _faults_delta(before, after)
    failure = engine.failure_log[n_fail]
    streamed_errors = 0
    for i, ((kind, body), r) in enumerate(zip(burst, resp)):
        toks, lps = solo_out[i]
        if "records" in r:
            recs = r["records"]
            if not recs[-1].get("ok"):
                if not ("injected exception at segment_fetch"
                        in recs[-1].get("error", "") and len(recs) > 1):
                    raise SystemExit(f"path G (a): streamed row {i} ended "
                                     f"badly: {recs[-1]}")
                streamed_errors += 1
                continue
            r = {"tokens": [[t for x in recs[:-1] for t in x["tokens"][0]]],
                 "logprobs": [[v for x in recs[:-1]
                               for v in x["logprobs"][0]]]}
        same = (r["tokens"] == toks.tolist()
                and r["tokens"] == d_resp[i]["tokens"]
                and ("logprobs" not in r
                     or (np.array_equal(np.asarray(r["logprobs"]),
                                        _as_served(lps))
                         and r["logprobs"] == d_resp[i]["logprobs"])))
        if not same:
            raise SystemExit(f"path G (a): {kind} row {i} differs from its "
                             f"solo run or D's unfaulted row")
    replayed = [e for e in engine.request_log
                if e["seq"] > seq0 and e["replays"]]
    reps = delta["replays"]
    log(f"path G (a): segment_fetch:exception@seg=3 over D's burst of 8: "
        f"failures {delta['failures']}, replays {reps} ({failure['requeued']}"
        f" rows requeued), {streamed_errors} streamed row(s) ended with the "
        f"injected error, every other row bitwise its solo run and D's "
        f"unfaulted row")
    if (delta["failures"] != {"segment_fetch": 1} or reps["attempted"] < 1
            or reps["attempted"] != reps["succeeded"]
            or reps["attempted"] != failure["requeued"]
            or len(replayed) != reps["attempted"]):
        raise SystemExit(f"path G (a): faults {delta}, {len(replayed)} "
                         f"replayed rows logged")
    pool = engine.pool
    pool.check_invariants()
    if pool.stats()["pages_live"]:
        raise SystemExit("path G (a): the pool did not drain")
    recovery_s = max(e["t0"] + e["wall_s"] for e in replayed) - failure["at"]
    log(f"path G (a): recovery {recovery_s:.3f} s from the failure to the "
        f"last replayed row's completion; pool drained [{card}]")
    return {"faults": delta, "launches": launches, "recovery_s": recovery_s,
            "streamed_errors": streamed_errors,
            "requeued": failure["requeued"]}


def fault_watchdog(url, engine, reqs, solo_out, layers, card) -> dict:
    """(b) ``engine_watchdog_s`` = ``FAULT_WATCHDOG_S`` and nothing
    injected: a real stall on the serving stream between two segments of
    a decoding row trips the wait within the watchdog plus
    ``FAULT_TRIP_SLACK_S``; ``/healthz`` reads not ready and wedged; a
    request while the replay waits is shed 503 ``wedged`` with
    ``Retry-After``; the replayed row is bitwise solo, the wedge clears (1
    recovery) and ``ready`` returns. Then with ``max_replays=0`` the
    waiter gets :class:`EngineWatchdogTimeout` within the same bound, and
    the self-probe clears the wedge."""
    import threading

    from lambdipy_tpu_torch.runtime.faults import EngineWatchdogTimeout

    cycles = _stall_cycles_per_s()
    engine.watchdog_s = FAULT_WATCHDOG_S
    bound_s = FAULT_WATCHDOG_S + FAULT_TRIP_SLACK_S
    _, body = reqs[0]  # 16 tokens, 128 new, greedy
    want = solo_out[0][0][0].tolist()
    before = engine.stats()
    n_fail = len(engine.failure_log)
    set_launches_to_zero()
    res = {}

    def call():
        code, res["r"], _ = _http(url + "/invoke", body)
        res["code"] = code

    th = threading.Thread(target=call)
    th.start()
    _wait_decoding(engine)
    t_stall = _stall(cycles)
    wedged, _ = _until_health(url, lambda h: h.get("wedged"), 30)
    shed = None
    while shed is None:
        h = http_json(url + "/healthz")
        if not h.get("wedged"):
            raise SystemExit("path G (b): the engine recovered before a "
                             "request could be shed")
        if h["engine"]["restarting"]:
            code, payload, hdrs = _http(url + "/invoke",
                                        {"tokens": [1, 2, 3],
                                         "max_new_tokens": 4})
            shed = {"code": code, "body": payload,
                    "retry_after": hdrs.get("Retry-After")}
    ready, t_ready = _until_health(url, lambda h: h.get("ready"), 60)
    th.join(timeout=300)
    trip = engine.failure_log[n_fail]
    mid = engine.stats()
    delta = _faults_delta(before, mid)
    log(f"path G (b): a {FAULT_STALL_S} s stall on the serving stream "
        f"tripped the {trip['site']} wait after {trip['waited_s']:.3f} s "
        f"(watchdog {FAULT_WATCHDOG_S} s; the trip {trip['at'] - t_stall:.3f}"
        f" s after the stall was enqueued); /healthz ready "
        f"{wedged['ready']} wedged {wedged['wedged']}; the request sent "
        f"while the replay waited: {shed['code']} {shed['body'].get('shed')}"
        f" Retry-After {shed['retry_after']}; trip to ready "
        f"{t_ready - trip['at']:.3f} s [{card}]")
    if not (trip["site"] == "watchdog:transport"
            and trip["waited_s"] <= bound_s and not wedged["ready"]
            and shed["code"] == 503 and shed["body"].get("shed") == "wedged"
            and shed["retry_after"]
            and res.get("r", {}).get("tokens") == [want]
            and ready["ready"] and not ready["wedged"]
            and delta["recoveries"] == 1 and delta["watchdog_trips"] == 1
            and delta["replays"] == {"attempted": 1, "succeeded": 1}):
        got = (res.get("r") or {}).get("tokens") or [[]]
        diff = next((j for j, (a, b) in enumerate(zip(got[0], want))
                     if a != b), None)
        raise SystemExit(f"path G (b): trip {trip}, health {wedged} then "
                         f"{ready}, shed {shed}, faults {delta}, the row: "
                         f"{res.get('code')} "
                         f"{(res.get('r') or {}).get('error')}, "
                         f"{len(got[0])} tokens, first difference at "
                         f"{diff}: {got[0][diff - 2:diff + 3] if diff else ''}"
                         f" against {want[diff - 2:diff + 3] if diff else ''}")
    # the same stall with no replay budget: the waiter gets the timeout
    engine.max_replays = 0
    n_fail = len(engine.failure_log)
    err = {}

    def direct():
        try:
            engine.generate(body["tokens"],
                            max_new_tokens=body["max_new_tokens"])
        except EngineWatchdogTimeout as e:
            err["at"], err["e"] = time.monotonic(), e

    th = threading.Thread(target=direct)
    th.start()
    _wait_decoding(engine)
    _stall(cycles)
    th.join(timeout=60)
    trip0 = engine.failure_log[n_fail]
    waiter_s = err["at"] - (trip0["at"] - trip0["waited_s"]) \
        if "at" in err else None
    ready0, t_ready0 = _until_health(url, lambda h: h.get("ready"), 60)
    engine.max_replays = 1
    engine.watchdog_s = 0.0
    after = engine.stats()
    launches = _engine_launches("b", before, after, layers)
    log(f"path G (b): with max_replays=0 the waiter got "
        f"{type(err.get('e')).__name__} {waiter_s} s after its wait "
        f"began (bound {bound_s} s); the self-probe cleared the wedge "
        f"{t_ready0 - trip0['at']:.3f} s after the trip [{card}]")
    if waiter_s is None or waiter_s > bound_s or not ready0["ready"]:
        raise SystemExit(f"path G (b): max_replays=0 waiter {err}, trip "
                         f"{trip0}, health {ready0}")
    return {"trip_s": trip["waited_s"],
            "trip_to_ready_s": t_ready - trip["at"],
            "shed": {"code": shed["code"],
                     "retry_after": shed["retry_after"]},
            "no_replay_waiter_s": waiter_s,
            "probe_to_ready_s": t_ready0 - trip0["at"],
            "faults": _faults_delta(before, after), "launches": launches}


def fault_ladder(url, engine, reqs, solo_out, layers, card) -> dict:
    """(c) ``segment_fetch:exception@seg=1,n=2`` with ``max_replays=2``:
    the attempt and the first replay fail, the level becomes 1, the second
    replay runs at depth 1 (no second segment in flight) and is bitwise
    solo; after ``degrade_clean_s`` the next request restores level 0."""
    last = engine.failure_log[-1]["at"]
    time.sleep(max(0.0, last + FAULT_WINDOW_S + 0.1 - time.monotonic()))
    engine.degrade_window_s = FAULT_WINDOW_S
    engine.degrade_clean_s = FAULT_CLEAN_S
    engine.max_replays = 2
    _http(url + "/v1/debug/faults",
          {"spec": "segment_fetch:exception@seg=1,n=2"})
    before = engine.stats()
    set_launches_to_zero()
    _, body = reqs[0]
    got = engine.generate(body["tokens"],
                          max_new_tokens=body["max_new_tokens"],
                          return_logprobs=True)
    _idle(engine)
    stepped = engine.stats()
    _http(url + "/v1/debug/faults", {"clear": True})
    time.sleep(FAULT_CLEAN_S + 0.2)
    kind1, body1 = reqs[1]
    got1 = engine.generate(body1["tokens"],
                           max_new_tokens=body1["max_new_tokens"],
                           return_logprobs=True, **_knobs(body1))
    _idle(engine)
    after = engine.stats()
    launches = _engine_launches("c", before, after, layers)
    engine.max_replays = 1
    engine.degrade_window_s = 60.0
    engine.degrade_clean_s = 30.0
    d1, d2 = _faults_delta(before, stepped), _faults_delta(stepped, after)
    two = {k: stepped["pipeline"]["in_flight"].get(k, 0)
           - before["pipeline"]["in_flight"].get(k, 0) for k in ("1", "2")}
    bitwise = all(np.array_equal(a[j], b[j]) for a, b in
                  ((got, solo_out[0]), (got1, solo_out[1])) for j in (0, 1))
    log(f"path G (c): failures {d1['failures']}, level {d1['degrade_level']}"
        f" (steps {d1['degrade_steps']}), replays {d1['replays']}; segments "
        f"dispatched with 1 / 2 in flight {two['1']} / {two['2']} (the two "
        f"failed attempts reached 2, the depth-1 replay 1); rows bitwise "
        f"solo {bitwise}; after {FAULT_CLEAN_S} s clean: level "
        f"{d2['degrade_level']}, restores {d2['restores']} [{card}]")
    if not (bitwise and d1["degrade_level"] == 1
            and d1["degrade_steps"] == {"1": 1} and two["2"] == 2
            and d1["replays"] == {"attempted": 2, "succeeded": 1}
            and d2["degrade_level"] == 0 and d2["restores"] == 1):
        raise SystemExit(f"path G (c): {d1}, {d2}, in flight {two}, "
                         f"bitwise {bitwise}")
    return {"stepped": d1, "restored": d2, "in_flight": two,
            "launches": launches}


def _bucket_delta(before: dict, after: dict) -> dict:
    """The ``decode_window`` buckets that segments collected between two
    engine stats dispatched at."""
    a, b = (x["decode_window"]["buckets"] for x in (after, before))
    return {w: n - b.get(w, 0) for w, n in a.items() if n != b.get(w, 0)}


def fault_ladder_two(url, engine, reqs, solo_out, layers, card) -> dict:
    """(f) ``segment_fetch:exception@seg=1,n=3`` with ``max_replays=3``: the
    attempt and two replays fail inside ``FAULT_WINDOW_S``, the ladder
    reaches level 2, and the third replay runs there, at depth 1 and the
    full window: its segments' only ``decode_window`` bucket is
    ``cache_len`` (JAX pins the full-window program at level 2), and the
    row is bitwise solo; after ``degrade_clean_s`` the next request
    restores level 0 and is dispatched at narrower windows again."""
    PROGRESS["stage"] = "G (f): ladder level 2"
    last = engine.failure_log[-1]["at"]
    time.sleep(max(0.0, last + FAULT_WINDOW_S + 0.1 - time.monotonic()))
    engine.degrade_window_s = FAULT_WINDOW_S
    engine.degrade_clean_s = FAULT_CLEAN_S
    engine.max_replays = 3
    _http(url + "/v1/debug/faults",
          {"spec": "segment_fetch:exception@seg=1,n=3"})
    before = engine.stats()
    set_launches_to_zero()
    _, body = reqs[0]
    got = engine.generate(body["tokens"],
                          max_new_tokens=body["max_new_tokens"],
                          return_logprobs=True)
    _idle(engine)
    stepped = engine.stats()
    _http(url + "/v1/debug/faults", {"clear": True})
    time.sleep(FAULT_CLEAN_S + 0.2)
    _, body1 = reqs[1]
    got1 = engine.generate(body1["tokens"],
                           max_new_tokens=body1["max_new_tokens"],
                           return_logprobs=True, **_knobs(body1))
    _idle(engine)
    after = engine.stats()
    launches = _engine_launches("f", before, after, layers)
    engine.max_replays = 1
    engine.degrade_window_s = 60.0
    engine.degrade_clean_s = 30.0
    d1, d2 = _faults_delta(before, stepped), _faults_delta(stepped, after)
    w1, w2 = _bucket_delta(before, stepped), _bucket_delta(stepped, after)
    full = str(engine.cache_len)
    bitwise = all(np.array_equal(a[j], b[j]) for a, b in
                  ((got, solo_out[0]), (got1, solo_out[1])) for j in (0, 1))
    log(f"path G (f): failures {d1['failures']}, level {d1['degrade_level']}"
        f" (steps {d1['degrade_steps']}), replays {d1['replays']}; the "
        f"level-2 replay's segments by window {w1}; after {FAULT_CLEAN_S} s "
        f"clean: level {d2['degrade_level']}, restores {d2['restores']}, "
        f"the next request's windows {w2}; rows bitwise solo {bitwise} "
        f"[{card}]")
    if not (bitwise and d1["degrade_level"] == 2
            and d1["degrade_steps"] == {"1": 1, "2": 1}
            and d1["replays"] == {"attempted": 3, "succeeded": 1}
            and list(w1) == [full] and w1[full] > 0
            and d2["degrade_level"] == 0 and d2["restores"] == 1
            and any(int(w) < engine.cache_len for w in w2)):
        raise SystemExit(f"path G (f): {d1}, {d2}, windows {w1} {w2}, "
                         f"bitwise {bitwise}")
    return {"stepped": d1, "restored": d2, "windows_at_level_2": w1,
            "windows_after": w2, "launches": launches}


def fault_default(engine, reqs, depths, layers, card) -> dict:
    """(e) D's burst driven directly at the defaults (no watchdog, an
    empty plan, one replay): tok/s beside D's own depth-2 bursts of this
    run; no wait polled."""
    def send(i):
        _, body = reqs[i]
        engine.generate(body["tokens"], max_new_tokens=body["max_new_tokens"],
                        **_knobs(body))

    if engine.watchdog_s or engine.faults.active() or engine.max_replays != 1:
        raise SystemExit("path G (e): the engine is not at its defaults")
    before = engine.stats()
    set_launches_to_zero()
    _, burst_s = _drive(send, reqs)
    _idle(engine)
    after = engine.stats()
    launches = _engine_launches("e", before, after, layers)
    polled = after["polled_waits"] - before["polled_waits"]
    tok_s = new_tokens_of(reqs) / burst_s
    d2 = [b["decode_tok_s"] for b in depths["depth2"]]
    log(f"path G (e): D's burst at the defaults {burst_s:.3f} s, "
        f"{tok_s:.1f} tok/s (D's depth-2 bursts of this run "
        f"{', '.join(f'{x:.1f}' for x in d2)}); waits polled: {polled} "
        f"[{card}]")
    if polled:
        raise SystemExit("path G (e): the default path polled")
    return {"burst_wall_s": burst_s, "decode_tok_s": tok_s,
            "d_depth2_tok_s": d2, "polled_waits": polled,
            "launches": launches}


def fault_prefix(server, layers, card) -> dict:
    """(d) E's traffic (a seeded 2,048-token head and 8 suffixes, 24 new,
    even rows greedy, odd seeded) routed through a prefix store over a
    paged engine on D's weights: unfaulted, then with
    ``segment_fetch:exception@seg=2``: every routed row bitwise its
    unfaulted routed run, the paged rows continued again over the pages
    they kept, the pool left holding the store's pages."""
    import threading

    from lambdipy_tpu_torch.runtime.handlers import (make_engine,
                                                     make_prefix_store)

    cfg = server.model.cfg
    engine = make_engine(server, {**ENGINE_EXTRA, "kv_pages": "1025"})
    store = make_prefix_store(server, engine, {})
    block = store.block
    rng = torch.Generator().manual_seed(21)

    def tokens(n):
        return torch.randint(1, cfg.vocab_size, (n,), generator=rng).tolist()

    head = tokens(PREFIX_HEAD)
    rows = [(head + tokens(n), prefix_knobs(i))
            for i, (n, _) in enumerate(PREFIX_SUFFIXES)]

    def burst():
        out = [None] * len(rows)

        def one(i):
            row, kw = rows[i]
            m = store.route(row)
            if m != prefix_target(len(row), block, cfg.max_len):
                raise SystemExit(f"path G (d): row {i} routed {m} tokens")
            out[i] = engine.generate(row[m:], prefix=row[:m],
                                     max_new_tokens=PREFIX_NEW,
                                     return_logprobs=True, **kw)

        one(0)  # the cold walk, then the rest together
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(1, len(rows))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        _idle(engine)
        return out

    want = burst()
    engine.faults.arm("segment_fetch:exception@seg=2")
    before, rounds0 = engine.stats(), store.stats()["prefill"]["rounds"]
    set_launches_to_zero()
    got = burst()
    after = engine.stats()
    walked = store.stats()["prefill"]["rounds"] - rounds0
    continuations = after["prefix_joins"] - before["prefix_joins"]
    launches = _engine_launches("d", before, after, layers,
                                extra_forwards=walked + continuations)
    delta = _faults_delta(before, after)
    bitwise = all(w is not None and g is not None and np.array_equal(
        w[j], g[j]) for w, g in zip(want, got) for j in (0, 1))
    engine.pool.check_invariants()
    inv = store.check_invariants()
    pages = engine.pool.stats()["pages_live"]
    log(f"path G (d): E's 8 routed rows with segment_fetch:exception@seg=2:"
        f" failures {delta['failures']}, replays {delta['replays']}, "
        f"{continuations} continuations ({walked} walk chunks); every row "
        f"bitwise its unfaulted routed run: {bitwise}; pool holds "
        f"{pages} pages = the store's {inv['blocks']} [{card}]")
    if not (bitwise and delta["failures"] == {"segment_fetch": 1}
            and delta["replays"]["attempted"] >= 1
            and delta["replays"]["attempted"] == delta["replays"]["succeeded"]
            and inv["ok"] and pages == inv["blocks"]):
        raise SystemExit(f"path G (d): {delta}, bitwise {bitwise}, pages "
                         f"{pages}, store {inv}")
    engine.release()
    del engine, store
    gc.collect()
    torch.cuda.empty_cache()
    return {"faults": delta, "continuations": continuations,
            "launches": launches}


def serve_fault_path(state, reqs, d_resp, solo_out, depths, card) -> dict:
    """Phase 4, path G: the engine's fault isolation on D's handler
    (served over HTTP by a fresh server), D's engine and D's weights:
    (a) a replay, (b) the watchdog on a real wait, (c) the ladder, (f) its
    level 2 and the full window, (e) the
    default path, then (d) prefix rows on a second paged engine over the
    same server. Each phase sets the launch counters to 0 just before it
    and checks them after; the path's launches are their sum."""
    from lambdipy_tpu_torch.runtime.server import BundleServer

    engine, server = state.engine, state.server
    layers = server.model.cfg.layers
    # (a) and (b) leave the ladder alone: their failures come seconds
    # apart, (c) steps it with its own two
    engine.degrade_window_s = 0.1
    http = BundleServer(state, port=0).start_background()
    try:
        out = {"a": fault_replay(http.url, engine, reqs, d_resp, solo_out,
                                 layers, card),
               "b": fault_watchdog(http.url, engine, reqs, solo_out, layers,
                                   card),
               "c": fault_ladder(http.url, engine, reqs, solo_out, layers,
                                 card),
               "f": _timed("path G (f)", fault_ladder_two, http.url,
                           engine, reqs, solo_out, layers, card)}
        metrics = http_json(http.url + "/metrics")
    finally:
        http.stop()
    out["e"] = fault_default(engine, reqs, depths, layers, card)
    out["d"] = fault_prefix(server, layers, card)
    out["metrics_faults"] = metrics["handler"]["batching"]["faults"]
    # every prefill of D's engine since D, the replayed rows' included, a
    # replay of a captured program
    estats = engine.stats()
    out["prefills"] = {k: estats[k] for k in ("prefill_replays",
                                              "eager_prefills",
                                              "compile_count")}
    log(f"path G prefill programs of D's engine after the faults: "
        f"{out['prefills']}")
    if estats["eager_prefills"]:
        raise SystemExit("path G: a prefill ran eagerly")
    out["launches"] = {k: sum(out[p]["launches"][k] for p in "abcdef")
                       for k in KERNELS}
    return out


def profile_engine(engine, prompts, card: str, n_new: int = 16) -> dict:
    """Where an engine burst's time goes: ``len(prompts)`` concurrent
    requests (prompts cut to 100 tokens, ``n_new`` new tokens) under
    ``torch.profiler``, after every timed run."""
    import threading

    def burst():
        threads = [threading.Thread(target=engine.generate, args=(p[:100],),
                                    kwargs={"max_new_tokens": n_new})
                   for p in prompts]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)

    burst()  # warm
    torch.cuda.synchronize()
    steps0 = engine.stats()["steps"]
    wall_ms, busy_ms, kernels = _traced(burst)
    steps = engine.stats()["steps"] - steps0
    if busy_ms is None:
        log("profiler recorded no device kernels: device busy time not "
            "measured")
    else:
        log(f"profiled engine burst ({len(prompts)} x 100-token prompts, "
            f"{n_new} new, {steps} steps): wall {wall_ms:.2f} ms, device "
            f"busy {busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f} "
            f"[{card}]")
        for name, ms, count in kernels[:10]:
            log(f"  {ms:9.3f} ms  {count:6d}x  {name[:100]}")
    return {"wall_ms": wall_ms, "steps": steps, "device_busy_ms": busy_ms,
            "idle_share": None if busy_ms is None else 1 - busy_ms / wall_ms,
            "kernels": [{"name": n, "ms": ms, "count": c}
                        for n, ms, c in kernels[:25]]}


def _traced(fn, window: bool = False):
    """``fn()`` under ``torch.profiler``: (wall ms to the card's end,
    device busy ms as the sum of the CUDA kernels' durations or None when
    the profiler saw none, kernels by device time); with ``window`` also
    :func:`decode_window` of the trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count)
         for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
        key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms, _ in kernels) if kernels else None
    if window:
        return wall_ms, busy_ms, kernels, decode_window(prof.events())
    return wall_ms, busy_ms, kernels


def decode_window(events):
    """The decode part of one traced request, read from its own trace:
    (window ms, device busy ms in it) from the host's first
    ``cudaGraphLaunch`` (the first decode step's replay) to the end of the
    card's last kernel, busy time being the kernels' durations clipped to
    the window; None when the trace holds no graph launch."""
    from torch.autograd import DeviceType

    launches = [e.time_range.start for e in events
                if e.name.startswith("cudaGraphLaunch")]
    kernels = [(e.time_range.start, e.time_range.end) for e in events
               if e.device_type == DeviceType.CUDA]
    if not launches or not kernels:
        return None
    start, end = min(launches), max(b for _, b in kernels)
    busy = sum(max(0, min(b, end) - max(a, start)) for a, b in kernels)
    return (end - start) / 1e3, busy / 1e3


def profile_decode(server, rows, card: str, n_new: int = 16) -> dict:
    """Where a batch-1 request's time goes: one ``generate`` under
    ``torch.profiler`` (after a warm one). Device busy time is the sum of
    the CUDA kernels' durations; the rest of the wall is host time the
    card sat idle (the profiler's own cost included). The decode part's
    idle share comes from the same trace (:func:`decode_window`)."""
    server.generate(rows, max_new_tokens=n_new)
    torch.cuda.synchronize()
    wall_ms, busy_ms, kernels, win = _traced(
        lambda: server.generate(rows, max_new_tokens=n_new), window=True)
    if busy_ms is None:
        log("profiler recorded no device kernels: device busy time not "
            "measured")
        return {"wall_ms": wall_ms, "device_busy_ms": None,
                "idle_share": None, "kernels": []}
    decode_idle = None if win is None else 1 - win[1] / win[0]
    log(f"profiled batch-1 request ({len(rows[0])}-token prompt, {n_new} "
        f"new): wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, idle "
        f"share {1 - busy_ms / wall_ms:.3f}; its decode part "
        + ("not found in the trace (no graph launch)" if win is None else
           f"(first replay to the last kernel: {win[0]:.2f} ms, busy "
           f"{win[1]:.2f} ms) idle share {decode_idle:.3f}")
        + f" [{card}]")
    for name, ms, count in kernels[:10]:
        log(f"  {ms:9.3f} ms  {count:6d}x  {name[:100]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms,
            "decode_window_ms": None if win is None else win[0],
            "decode_busy_ms": None if win is None else win[1],
            "decode_idle_share": decode_idle,
            "kernels": [{"name": n, "ms": ms, "count": c}
                        for n, ms, c in kernels[:25]]}


# The served model (kernels) against the plain model on the same weights.
# The plain int8 path folds each channel's scale into bf16 weights before
# the product, the kernel applies the f32 scale after it, so the two round
# differently; under B the plain path also rounds the int8-KV scale to
# bf16 before the product, and under C its prefill rounds the logits to
# bf16 where the flash kernel keeps them in f32. Measured on an H100
# (NVIDIA H100 80GB HBM3, 700 W), logit cosine min / max |diff| / max
# |logit|: A 0.999893 / 0.0153; B 0.999893 / 0.0164 at 100 tokens and at
# 4,000; C 0.999894 / 0.0158 and 0.999894 / 0.0150. The limits sit three
# to five times outside that gap. Seeded random weights at full depth
# give nearly input-independent logits (greedy decode repeats one
# token), so the logits alone say little about attention: the K/V that
# every layer wrote for every position are compared too (after the
# first layer they carry the attention outputs of the layers below);
# max over layers of max |diff| / max |value|, measured: A 0.0210, B
# 0.0239 and 0.0262, C 0.0204 and 0.0236. The per-kernel checks of
# phase 3 hold each kernel far tighter.
COSINE_MIN, REL_MAX = 0.9995, 0.05
KV_REL_MAX = 0.1


def kv_values(entry, n: int):
    """A cache entry's K and V at positions < n, in f32 (int8 leaves
    dequantized as the kernel does)."""
    from lambdipy_tpu_torch.ops.decode_attention import dequantize_kv

    if "k" in entry:
        return entry["k"][:, :n].float(), entry["v"][:, :n].float()
    return tuple(dequantize_kv(entry[f"{x}_int8"][:, :n],
                               entry[f"{x}_scale"][:, :n], torch.float32)
                 for x in ("k", "v"))


def compare_models(served, plain, tokens, path: str) -> dict:
    """Last-position prefill logits and 4 teacher-forced decode steps of
    the served model (kernels) against the plain model on the same
    weights, and the K/V both wrote (every layer, every position)."""
    from lambdipy_tpu_torch.models.llama import prefill_into_cache

    dev = served.device
    toks = torch.tensor([tokens], device=dev)
    s = toks.shape[1]
    last = torch.tensor([s - 1], device=dev)
    cos_min, rel_max, argmax_same = 1.0, 0.0, 0
    with torch.inference_mode():
        caches, logits = {}, {}
        for name, model in (("served", served), ("plain", plain)):
            lg, pc = model(toks, logit_positions=last)
            caches[name] = prefill_into_cache(model.cfg, pc, 1, s + 8, s)
            logits[name] = lg[:, -1].float()
            del pc
        nxt = logits["plain"].argmax(-1)
        for step in range(5):
            a, b = logits["served"].flatten(), logits["plain"].flatten()
            cos = torch.nn.functional.cosine_similarity(a, b, dim=0).item()
            rel = ((a - b).abs().max() / b.abs().max()).item()
            cos_min, rel_max = min(cos_min, cos), max(rel_max, rel)
            argmax_same += int(a.argmax() == b.argmax())
            if step == 4:
                break
            pos = torch.full((1,), s + step, dtype=torch.int32, device=dev)
            for name, model in (("served", served), ("plain", plain)):
                for entry in caches[name]:
                    entry["index"] = pos
                lg, _ = model(nxt[:, None], positions=pos[:, None],
                              cache=caches[name])
                logits[name] = lg[:, -1].float()
            nxt = logits["plain"].argmax(-1)
        kv_rel = []  # per layer: max |diff| / max |value| over K and V
        for es, ep in zip(caches["served"], caches["plain"]):
            kv_rel.append(max(
                ((a - b).abs().max() / b.abs().max()).item()
                for a, b in zip(kv_values(es, s + 4), kv_values(ep, s + 4))))
    log(f"path {path}, {s}-token prompt, served vs plain model on the "
        f"card: logit cosine min {cos_min:.6f} (tolerance >= {COSINE_MIN}), "
        f"max |diff| / max |logit| {rel_max:.4f} (tolerance <= {REL_MAX}), "
        f"argmax equal at {argmax_same} of 5 positions; K/V max |diff| / "
        f"max |value| {max(kv_rel):.4f} over {len(kv_rel)} layers, layer 1 "
        f"{kv_rel[1]:.4f} (tolerance <= {KV_REL_MAX})")
    if cos_min < COSINE_MIN or rel_max > REL_MAX or max(kv_rel) > KV_REL_MAX:
        raise SystemExit(f"path {path}: served model disagrees with the "
                         f"plain model at the {s}-token prompt")
    return {"prompt_tokens": s, "cosine_min": cos_min, "rel_max": rel_max,
            "argmax_same_of_5": argmax_same, "kv_rel_max": max(kv_rel),
            "kv_rel_by_layer": kv_rel,
            "limits": {"cosine_min": COSINE_MIN, "rel_max": REL_MAX,
                       "kv_rel_max": KV_REL_MAX}}


# path E: the automatic prefix KV cache over the paged engine
PREFIX_EXTRA = {**ENGINE_EXTRA, "max_new_tokens": "24"}  # store at 512 MB
PREFIX_HEAD = 2048  # the shared head: a system prompt or few-shot template
# (suffix tokens, streamed) of the 8 requests; request 0 runs cold, 1-7
# together, then request 0 once more (a full hit)
PREFIX_SUFFIXES = ((40, True), (63, True), (87, False), (110, False),
                   (135, True), (158, False), (181, True), (200, False))
PREFIX_NEW = 24
# routed against unrouted (path E (c)): a continuation's softmax and PV
# reduce over the 8,192-position window, the unrouted prefill's over its
# 4,096 bucket, so the two differ in the last bits (ROADMAP section 3).
# The bound: greedy rows' tokens equal, and every row's first-token
# logprob within this of the unrouted one (measured on an H100, NVIDIA
# H100 80GB HBM3, 700 W: 9.1e-3 at most over the 8 requests; over whole
# rows 1.5e-2)
ROUTED_LOGPROB_GAP = 0.05


def prefix_knobs(i: int) -> dict:
    """Even requests greedy, odd ones seeded."""
    return ({} if i % 2 == 0 else
            {"temperature": 0.8, "top_p": 0.9, "seed": 100 + i})


def prefix_target(n: int, block: int, max_len: int) -> int:
    """The prefix length the store routes an n-token prompt with."""
    return min((n - 1) // block * block, max_len - block)


def walk_rounds(matched: int, target: int, block: int, wide: int,
                max_len: int) -> int:
    """Chunk dispatches of a walk from ``matched`` to ``target``, as the
    store cuts it: a first chunk (wide when the target allows) from 0,
    then wide chunks where they fit, block chunks for the rest."""
    pos, rounds = matched, 0
    if pos == 0:
        pos, rounds = (wide if target >= wide else block), 1
    while pos < target:
        pos += wide if (target - pos >= wide and pos + wide <= max_len) \
            else block
        rounds += 1
    return rounds


def cold_walks(server, row, block: int, card: str) -> dict:
    """E's cold walk of ``row``'s head by a fresh dense store, at the
    store's default width (256) and over a ``prefill_chunk=512`` server on
    the same weights (walk chunk 512), in turns default, 512, 512,
    default: each walk's wall (host clock around the routing, ended by a
    synchronize; the first 512-wide walk captures its programs), the
    store's ``critical_path_s`` (since the chunks are replays, the host's
    enqueue time) and the chunks, which must be the walk's implied
    rounds."""
    from lambdipy_tpu_torch.models.llama import LlamaServer
    from lambdipy_tpu_torch.runtime.prefixstore import PrefixStore

    max_len = server.model.cfg.max_len
    servers = {"default": server,
               "chunked": LlamaServer(server.model, prefill_chunk=CHUNK)}
    target = prefix_target(len(row), block, max_len)
    out = {}
    for name in ("default", "chunked", "chunked", "default"):
        srv = servers[name]
        store = PrefixStore(srv, block=block)
        with srv._prefix_lock:
            srv._prefixes.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if store.route(row) != target:
            raise SystemExit("path E: a cold walk routed another target")
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        walk = store.prefill_stats.report()
        rounds = walk_rounds(0, target, block, store.walk_chunk, max_len)
        if walk["rounds"] != rounds:
            raise SystemExit(f"path E: the {store.walk_chunk}-wide walk ran "
                             f"{walk['rounds']} chunks, implied {rounds}")
        out.setdefault(name, []).append(
            {"ms": wall_ms, "enqueue_ms": 1e3 * walk["critical_path_s"],
             "chunks": walk["rounds"], "walk_chunk": store.walk_chunk})
    with servers["chunked"]._prefix_lock:
        servers["chunked"]._prefixes.clear()
    if out["chunked"][0]["walk_chunk"] != CHUNK:
        raise SystemExit("path E: the store did not walk at the server's "
                         "prefill_chunk")
    log(f"path E cold walks of {target} tokens, turns default, "
        f"prefill_chunk={CHUNK}, {CHUNK}, default: "
        + "; ".join(f"{ws[0]['walk_chunk']}-wide "
                    f"{[round(w['ms'], 1) for w in ws]} ms in "
                    f"{ws[0]['chunks']} chunks (enqueued in "
                    f"{[round(w['enqueue_ms'], 1) for w in ws]} ms)"
                    for ws in out.values())
        + f" [{card}]")
    return out


def eager_prefix_traffic(server, reqs, order, block: int) -> list:
    """E's traffic (cold, the 7 together, the full hit) through a paged
    engine and store over an eager server on ``server``'s model
    (``graphs=False``), driven directly: each row's ``(tokens,
    logprobs)``."""
    from lambdipy_tpu_torch.models.llama import LlamaServer
    from lambdipy_tpu_torch.runtime.handlers import make_engine
    from lambdipy_tpu_torch.runtime.prefixstore import PrefixStore

    eager = LlamaServer(server.model, graphs=False)
    engine = make_engine(eager, {**PREFIX_EXTRA, "kv_pages": "512"})
    store = PrefixStore(eager, block=block, pool=engine.pool)
    engine.prefix_pages_fn = store.acquire_pages
    out = [None] * len(order)

    def send(j):
        body = reqs[order[j]][1]
        row = body["tokens"]
        m = store.route(row)
        out[j] = engine.generate(row[m:], prefix=row[:m],
                                 max_new_tokens=PREFIX_NEW,
                                 return_logprobs=True, **_knobs(body))

    send(0)
    threads = [threading.Thread(target=send, args=(j,))
               for j in range(1, len(order) - 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    send(len(order) - 1)
    stats = engine.stats()
    if stats["prefill_replays"] or stats["replays"] \
            or eager.program_stats()["prefill_replays"]:
        raise SystemExit("path E: the eager twin replayed a graph")
    engine.release()
    del engine, store, eager
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serve_prefix_path(card: str) -> dict:
    """Phase 4, path E: llama3-8b through the continuous engine over a
    paged arena with the prefix store at the handler's default (512 MB),
    over HTTP: a seeded 2,048-token head shared by 8 requests of their own
    suffixes, 24 new tokens each, greedy and seeded, some streamed: one
    cold, 7 together, then the first again (a full hit). Checks (a) every
    row bitwise its solo routed run (``LlamaServer.generate(suffix,
    prefix=)`` from the same prefix K/V), (b) the same traffic through a
    dense full-window engine with a dense store (assembled hits) bitwise
    the paged rows, (c) routed against unrouted (the whole prompt, no
    store): printed, bitwise or the largest logprob gap, (d) the store's
    hits, misses and hit tokens the traffic's and no assembly, (e) the
    launch counters the walks', continuations' and engine steps', every
    step a replay, (f) after the drain the pool holds the store's pages
    alone and both pass their invariant checks."""
    import threading

    from lambdipy_tpu_torch.models.llama import LlamaServer, cache_nbytes
    from lambdipy_tpu_torch.runtime.continuous import ContinuousBatcher
    from lambdipy_tpu_torch.runtime.handlers import (HandlerContext,
                                                     generate_handler,
                                                     kernel_launches)
    from lambdipy_tpu_torch.runtime.prefixstore import PrefixStore
    from lambdipy_tpu_torch.runtime.server import BundleServer

    spec = {"model": "llama3-8b", "dtype": "bfloat16", "quant": "int8",
            "extra": cut(PREFIX_EXTRA)}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = generate_handler(spec, HandlerContext(device="cuda"))
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    server_, engine, store = state.server, state.engine, state.prefix_store
    cfg = server_.model.cfg
    layers, block, max_len = cfg.layers, store.block, cfg.max_len
    if store is None or store.pool is not engine.pool:
        raise SystemExit("path E: the handler built no paged prefix store")
    log(f"path E: {spec['model']} ({layers} layers, {cfg.quant} weights, "
        f"{cfg.attn_backend}, paged bf16 KV, {engine.slots} slots, page "
        f"{engine.pool.page}) with the prefix store at "
        f"{store.budget_bytes / 2**20:.0f} MiB (block {block}, walk chunk "
        f"{store.walk_chunk}) built in {boot_s:.1f} s")
    rng = torch.Generator().manual_seed(21)

    def tokens(n):
        return torch.randint(1, cfg.vocab_size, (n,), generator=rng).tolist()

    head = tokens(PREFIX_HEAD)
    reqs = []
    for i, (n, streamed) in enumerate(PREFIX_SUFFIXES):
        body = {"tokens": head + tokens(n), "max_new_tokens": PREFIX_NEW,
                "logprobs": True, **prefix_knobs(i)}
        reqs.append((streamed, body))
    order = [0, *range(1, 8), 0]  # cold, the 7 together, the full hit
    targets = [prefix_target(len(b["tokens"]), block, max_len)
               for _, b in reqs]

    http = BundleServer(state, port=0).start_background()
    url = http.url + "/invoke"
    resp, first_line = [None] * len(order), [None] * len(order)
    walk0 = {}

    def send(j):
        streamed, body = reqs[order[j]]
        t1 = time.perf_counter()
        if streamed or j in (0, len(order) - 1):
            records, first_line[j] = _post_stream(url, body)
            if not records[-1].get("done"):
                raise SystemExit(f"path E: stream ended badly: "
                                 f"{records[-1]}")
            resp[j] = {"ok": all(r.get("ok") for r in records),
                       "prefix_cached": records[-1].get("prefix_cached"),
                       "tokens": [[t for r in records[:-1]
                                   for t in r["tokens"][0]]],
                       "logprobs": [[x for r in records[:-1]
                                     for x in r["logprobs"][0]]]}
        else:
            resp[j] = http_json(url, body)
        resp[j]["wall_s"] = time.perf_counter() - t1

    try:
        server0 = server_.program_stats()
        set_launches_to_zero()  # counters to 0 just before the path
        t_traffic = time.perf_counter()
        send(0)
        prefill0 = store.stats()["prefill"]
        walk0 = {"ms": 1e3 * prefill0["critical_path_s"],
                 "chunks": prefill0["rounds"]}
        errors = []

        def run(j):
            try:
                send(j)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        threads = [threading.Thread(target=run, args=(j,))
                   for j in range(1, len(order) - 1)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        if errors or any(r is None for r in resp[1:-1]):
            raise SystemExit(f"path E: a request failed: {errors!r}")
        send(len(order) - 1)
        traffic_s = time.perf_counter() - t_traffic
        launches = kernel_launches()
        metrics = http_json(http.url + "/metrics")
    finally:
        http.stop()
    peak_paged = torch.cuda.max_memory_allocated()
    if not all(r.get("ok") and r.get("prefix_cached") for r in resp):
        raise SystemExit(f"path E: a request was not served from the "
                         f"prefix cache: {resp}")
    stats = engine.stats()
    pstats = store.stats()

    # (d) the store's counters: request 0 misses and walks its whole
    # target, 1-7 hit the head and walk their own suffix blocks, the
    # repeat hits its whole target
    want_pc = {"misses": 1, "hits": len(order) - 1,
               "hit_tokens": (len(order) - 2) * PREFIX_HEAD + targets[0],
               "blocks": (targets[0] + sum(t - PREFIX_HEAD
                                           for t in targets[1:])) // block,
               "assembly_bytes_peak": 0, "assemblies": 0, "evictions": 0}
    got_pc = {k: pstats[k] for k in want_pc}
    rounds = (walk_rounds(0, targets[0], block, store.walk_chunk, max_len)
              + sum(walk_rounds(PREFIX_HEAD, t, block, store.walk_chunk,
                                max_len) for t in targets[1:]))
    log(f"path E (d): prefix store {got_pc}, implied {want_pc}; "
        f"{pstats['prefill']['walks']} walks of {pstats['prefill']['rounds']} "
        f"chunks (implied 8 of {rounds}); {stats['prefix_joins']} prefix "
        f"joins")
    if (got_pc != want_pc or pstats["prefill"]["rounds"] != rounds
            or pstats["prefill"]["walks"] != 8
            or stats["prefix_joins"] != len(order)
            or metrics["handler"]["prefix_cache"]["hits"] != want_pc["hits"]):
        raise SystemExit("path E (d): the prefix store's counters differ "
                         "from the traffic's")

    # (e) every forward is a walk chunk, a continuation or an engine step
    forwards = rounds + stats["prefix_joins"] + stats["forwards"]
    want = dict.fromkeys(KERNELS, 0)
    want["paged_decode_attention"] = layers * stats["steps"]
    want["int8_matmul"] = (7 * layers + 1) * forwards
    log(f"path E (e) launch counters: {launches}, implied {want} ({rounds} "
        f"walk chunks, {stats['prefix_joins']} continuations, "
        f"{stats['steps']} engine steps, {stats['forwards']} engine "
        f"forwards)")
    if launches != want or metrics["handler"]["kernels"] != launches:
        raise SystemExit(f"path E: launch counters {launches} != implied "
                         f"{want}")
    # every prefill a replay: the engine's continuations, the store's
    # walk chunks (on the server's counters)
    programs = check_replays("E", metrics["handler"]["batching"],
                             stats["steps"],
                             prefills=(stats["prefix_joins"]
                                       + stats["forwards"] - stats["steps"]))
    walked = {k: metrics["handler"][k] - server0[k]
              for k in ("prefill_replays", "eager_prefills")}
    log(f"path E walk programs: {walked['prefill_replays']} replays for "
        f"{rounds} walk chunks, {walked['eager_prefills']} eager")
    if walked != {"prefill_replays": rounds, "eager_prefills": 0}:
        raise SystemExit("path E: a walk chunk was not a replay")
    log_pools("E (server)", metrics["handler"]["program_pools"])

    # (f) the pool holds the store's pages alone, each with the store's
    # one ref
    pool = engine.pool
    pool.check_invariants()
    inv = store.check_invariants()
    refs = {p: r for p, r in pool.snapshot_refs().items() if p != 0}
    log(f"path E (f): after the drain {len(refs)} pages live, the store "
        f"holds {len(inv['pages'])}, every refcount "
        f"{sorted(set(refs.values()))}; store invariants {inv['ok']} "
        f"{inv['violations']}, pool invariants hold")
    if not inv["ok"] or sorted(refs) != inv["pages"] \
            or set(refs.values()) != {1}:
        raise SystemExit("path E (f): the pool holds pages other than the "
                         "store's after the drain")

    # (b) the same traffic through a dense full-window engine whose dense
    # store assembles its hits, driven directly
    dense = ContinuousBatcher(server_, slots=engine.slots,
                              segment=engine.segment)
    dstore = PrefixStore(server_, block=block)
    dense_out = [None] * len(order)

    def send_dense(j):
        _, body = reqs[order[j]]
        knobs = {k: body[k] for k in ("temperature", "top_p", "seed")
                 if k in body}
        row = body["tokens"]
        m = dstore.route(row)
        dense_out[j] = dense.generate(row[m:], prefix=row[:m],
                                      max_new_tokens=PREFIX_NEW,
                                      return_logprobs=True, **knobs)

    torch.cuda.reset_peak_memory_stats()
    send_dense(0)
    threads = [threading.Thread(target=send_dense, args=(j,))
               for j in range(1, len(order) - 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    send_dense(len(order) - 1)
    peak_dense = torch.cuda.max_memory_allocated()
    dpc = dstore.stats()
    for j, (r, d) in enumerate(zip(resp, dense_out)):
        if r["tokens"] != d[0].tolist() or not np.array_equal(
                np.asarray(r["logprobs"]), _as_served(d[1])):
            raise SystemExit(f"path E (b): request {order[j]}'s paged row "
                             f"differs from the dense engine's")
    log(f"path E (b): paged (HTTP) and dense (direct) engines give equal "
        f"tokens and logprobs for every row; the dense store assembled "
        f"{dpc['assemblies']} caches, peak {dpc['assembly_bytes_peak']} B, "
        f"{dense.stats()['prefix_joins']} prefix joins")

    # (a) each request solo through LlamaServer.generate(prefix=), from
    # the same prefix K/V (the dense store's entry), against the dense
    # engine's row, bitwise (unrounded), and (c) against the whole prompt
    # unrouted
    solo, unrouted, gaps = {}, {}, []
    for i, (_, body) in enumerate(reqs):
        knobs = {k: body[k] for k in ("temperature", "top_p", "seed")
                 if k in body}
        row = body["tokens"]
        m = dstore.route(row)
        solo[i] = server_.generate(row[m:], prefix=row[:m],
                                   max_new_tokens=PREFIX_NEW,
                                   return_logprobs=True, **knobs)
        unrouted[i] = server_.generate(row, max_new_tokens=PREFIX_NEW,
                                       return_logprobs=True, **knobs)
        u, s_ = unrouted[i], solo[i]
        gaps.append({"request": i, "greedy": not knobs,
                     "tokens_equal": bool(np.array_equal(u[0], s_[0])),
                     "bitwise": bool(np.array_equal(u[0], s_[0])
                                     and np.array_equal(u[1], s_[1])),
                     "first_logprob_gap": float(abs(u[1][0, 0]
                                                    - s_[1][0, 0])),
                     "logprob_gap_max": float(np.abs(u[1] - s_[1]).max())})
    for j, d in enumerate(dense_out):
        s_ = solo[order[j]]
        if not (np.array_equal(d[0], s_[0]) and np.array_equal(d[1], s_[1])):
            raise SystemExit(f"path E (a): request {order[j]}'s engine row "
                             f"differs from its solo routed run")
    log(f"path E (a): all {len(order)} engine rows (paged over HTTP at the "
        f"served rounding, dense unrounded) bitwise their solo routed runs")

    # the same traffic through an eager server's paged engine and store
    # (graphs=False: every walk chunk, continuation and decode step eager),
    # driven directly: every row bitwise the graph engines'
    eager_out = eager_prefix_traffic(server_, reqs, order, block)
    for j, (d, e) in enumerate(zip(dense_out, eager_out)):
        if not (np.array_equal(d[0], e[0]) and np.array_equal(d[1], e[1])):
            raise SystemExit(f"path E: request {order[j]}'s row through the "
                             f"eager paged engine differs from the graph "
                             f"engines'")
    log(f"path E: an eager server's paged engine and store (cold walk, "
        f"hot and paged continuations eager) give all {len(order)} rows "
        f"bitwise the graph engines'")
    bitwise = all(g["bitwise"] for g in gaps)
    greedy_equal = all(g["tokens_equal"] for g in gaps if g["greedy"])
    first_gap = max(g["first_logprob_gap"] for g in gaps)
    log(f"path E (c): routed against unrouted (the whole prompt, no "
        f"store): " + ("bitwise" if bitwise else
                       f"not bitwise; largest first-token logprob gap "
                       f"{first_gap:.3e} (bound {ROUTED_LOGPROB_GAP}), "
                       f"largest logprob gap over the row "
                       f"{max(g['logprob_gap_max'] for g in gaps):.3e}")
        + f"; greedy tokens equal: {greedy_equal}; tokens equal by "
        f"request {[g['tokens_equal'] for g in gaps]} [{card}]")
    if not greedy_equal or first_gap > ROUTED_LOGPROB_GAP:
        raise SystemExit("path E (c): routed output left its bound against "
                         "unrouted")

    # time to first token: cold (walk + continuation), hot (continuation)
    # and unrouted (the whole prompt), one-token solo requests on the
    # server, each twice after a warm-up; the HTTP streams' first lines
    row0 = reqs[0][1]["tokens"]

    def one_token(fn):
        fn()
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
        return walls

    def cold(srv=server_):
        fresh = PrefixStore(srv, block=block)
        with srv._prefix_lock:
            srv._prefixes.clear()
        m = fresh.route(row0)
        srv.generate(row0[m:], prefix=row0[:m], max_new_tokens=1)

    m0 = targets[0]
    traces = {}
    for name, fn in (("cold", cold), ("hot", lambda: server_.generate(
            row0[m0:], prefix=row0[:m0], max_new_tokens=1))):
        wall_ms, busy_ms, kernels = _traced(fn)
        traces[name] = {"wall_ms": wall_ms, "busy_ms": busy_ms,
                        "idle_share": (None if busy_ms is None
                                       else 1 - busy_ms / wall_ms),
                        "top_kernels": kernels[:6]}
        if busy_ms is None:
            raise SystemExit("path E: the profiler saw no kernel")
        log(f"path E traced {name} one-token request: wall {wall_ms:.2f} "
            f"ms, device busy {busy_ms:.2f} ms, idle share "
            f"{traces[name]['idle_share']:.3f}; top kernels "
            + ", ".join(f"{k[:40]} {ms:.2f} ms x{n}"
                        for k, ms, n in kernels[:3]) + f" [{card}]")
    eager_srv = LlamaServer(server_.model, graphs=False)
    ttft = {"cold_s": one_token(cold),
            "hot_s": one_token(lambda: server_.generate(
                row0[m0:], prefix=row0[:m0], max_new_tokens=1)),
            "cold_eager_s": one_token(lambda: cold(eager_srv)),
            "hot_eager_s": one_token(lambda: eager_srv.generate(
                row0[m0:], prefix=row0[:m0], max_new_tokens=1)),
            "unrouted_s": one_token(lambda: server_.generate(
                row0, max_new_tokens=1)),
            "http_first_line_cold_s": first_line[0],
            "http_first_line_hot_s": first_line[-1]}
    entry_bytes = cache_nbytes(server_.get_prefix(
        server_._prefix_key(row0[:m0]))[0])
    perf = {"traffic_wall_s": traffic_s,
            "new_tokens": PREFIX_NEW * len(order),
            "decode_tok_s": PREFIX_NEW * len(order) / traffic_s,
            "ttft": ttft, "walk_cold_ms": walk0["ms"],
            "walk_cold_chunks": walk0["chunks"],
            "walks_ms_total": 1e3 * pstats["prefill"]["critical_path_s"],
            "walk_chunks_total": pstats["prefill"]["rounds"],
            "prefix_entry_bytes": entry_bytes,
            "server_prefix_entries": server_.program_stats()[
                "prefix_entries"],
            "server_prefix_bytes": server_.program_stats()["prefix_bytes"],
            "store_bytes": pstats["bytes"],
            "max_memory_allocated_gib_paged": peak_paged / 2**30,
            "max_memory_allocated_gib_dense": peak_dense / 2**30}
    perf["cold_walks"] = cold_walks(server_, row0, block, card)
    del eager_srv
    log(f"path E TTFT (one-token solo requests, two readings each): cold "
        f"{ttft['cold_s']} s, hot {ttft['hot_s']} s, unrouted "
        f"{ttft['unrouted_s']} s; eager server cold {ttft['cold_eager_s']} "
        f"s, hot {ttft['hot_eager_s']} s; first streamed line over HTTP (a "
        f"segment "
        f"of 16 steps after the first token): cold "
        f"{first_line[0]:.3f} s, hot {first_line[-1]:.3f} s [{card}]")
    log(f"path E cold walk of {targets[0]} tokens (the HTTP traffic's "
        f"first, its programs captured on the way): enqueued in "
        f"{walk0['ms']:.1f} ms, {walk0['chunks']} chunks; the 8 walks' "
        f"enqueue times summed (7 of them concurrent) "
        f"{perf['walks_ms_total']:.1f} ms in "
        f"{perf['walk_chunks_total']} chunks [{card}]")
    for key in ("traffic_wall_s", "decode_tok_s", "prefix_entry_bytes",
                "server_prefix_entries", "server_prefix_bytes",
                "store_bytes", "max_memory_allocated_gib_paged",
                "max_memory_allocated_gib_dense"):
        log(f"path E {key}: {perf[key]} [{card}]")
    out = {"spec": spec, "boot_s": boot_s, "launches": launches,
           "implied": want, "programs": programs, "engine": stats,
           "prefix_cache": pstats, "dense_prefix_cache": dpc,
           "page_pool": pool.stats(), "routed_vs_unrouted": gaps,
           "routed_vs_unrouted_bitwise": bitwise,
           "greedy_tokens_equal": greedy_equal, "perf": perf,
           "traces": traces,
           "requests": [{"request": order[j], "wall_s": r["wall_s"],
                         "http_first_line_s": first_line[j]}
                        for j, r in enumerate(resp)],
           "card": card}
    dense.release()
    del state, engine, store, server_, dense, dstore, http
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -------------------------------------------------------------------- main

# path H: speculative decoding. Solo "speculative": k on A's and B's
# servers over HTTP; D's burst through engines at spec_k = 8
SPEC_K = 8
SPEC_NEW = 256
SPEC_PROMPT = 200   # the solo prompt: a phrase of 24 tokens repeated
SPEC_SUFFIX = 64    # the suffix after the shared prefix
SPEC_PREFIX = 2048
# (draft mode, draft exit): 0 = the exit at the model's depth
SPEC_MODES = (("lookup", 1), ("model", 1), ("model", 0))
# the engines' pipeline depths by kv_paged: the dense engine at depth 2
# only (the paged engines hold depth 1 against depth 2 under every draft
# mode, and D (f) holds a depth-1 engine's rows against depth 2's)
SPEC_DEPTHS = {"1": ("2", "1"), "0": ("2",)}
SPEC_TIMED_PROMPT = 512  # the 8-slot timing's prompts, cut to this
SPEC_SAMPLED = {"temperature": 0.8, "top_p": 0.9, "seed": 7}


def spec_prompt(rng, vocab: int, n: int, period: int = 24) -> list:
    """A prompt that repeats a random phrase of ``period`` tokens: text
    with repeats, where prompt-lookup drafting finds its n-grams."""
    phrase = torch.randint(1, vocab, (period,), generator=rng).tolist()
    return (phrase * (n // period + 1))[:n]


def spec_launches(layers: int, attn: str, forwards: int, steps: int,
                  draft_forwards: int = 0, draft_exit: int = 0) -> dict:
    """The launches speculative traffic implies: 7 projections a layer
    plus the lm_head for every full forward (prefills, plain steps and
    verifies, one forward of ``slots x kb`` rows each) and ``7 *
    draft_exit + 1`` for every shallow draft forward; one ``attn`` launch
    a layer for every step (plain or verify) and ``draft_exit`` for every
    draft forward."""
    want = dict.fromkeys(KERNELS, 0)
    want["int8_matmul"] = ((7 * layers + 1) * forwards
                           + (7 * draft_exit + 1) * draft_forwards)
    want[attn] = layers * steps + draft_exit * draft_forwards
    return want


def program_times(server, prompts, kb: int) -> dict:
    """Device ms of one plain decode step and one verify of width ``kb``
    (host drafts of -1: one token accepted a verify) on a decode entry of
    ``len(prompts)`` rows holding ``prompts``, both replays of their
    captured graphs (``device_time``: the host's enqueue left out)."""
    from lambdipy_tpu_torch.models.llama import verify_program

    lens = [len(p) for p in prompts]
    with server._lock, torch.inference_mode():
        entry, prog = server._prefill(prompts, lens, SPEC_NEW, 0.0, None,
                                      None, 0, None)
        try:
            vprog = verify_program(entry, kb, False)
            vprog.vstep.set_drafts(np.full(vprog.vstep.draft.shape, -1,
                                           np.int64))
            step_ms = device_time(lambda i: prog.run())
            verify_ms = device_time(lambda i: vprog.run())
        finally:
            server.programs.checkin(entry)
    return {"rows": len(prompts), "kb": kb, "step_ms": step_ms,
            "verify_ms": verify_ms}


def solo_spec(path: str, card: str) -> dict:
    """Path H on ``path``'s server (A or B) over HTTP: ``"speculative":
    8`` with 256 new tokens, greedy bitwise plain (tokens and logprobs as
    served), sampled the same across two runs, streamed = fused; a
    2,048-token ``prefix``; the launch counters those requests imply;
    every verify a replay; then, directly, greedy bitwise plain
    ``generate`` (unrounded logprobs, with and without the prefix),
    decode tok/s spec on and off, acceptance and ``tokens_per_step``,
    and a verify's device time against a plain step's."""
    from lambdipy_tpu_torch.runtime.handlers import (HandlerContext,
                                                     generate_handler,
                                                     kernel_launches)
    from lambdipy_tpu_torch.runtime.server import BundleServer

    state = generate_handler(path_spec(path, depth_cut=True),
                             HandlerContext(device="cuda"))
    server, cfg = state.server, state.server.model.cfg
    layers = cfg.layers
    attn = "decode_attention_int8kv" if path == "B" else "decode_attention"
    rng = torch.Generator().manual_seed(29)
    p = spec_prompt(rng, cfg.vocab_size, SPEC_PROMPT)
    head = torch.randint(1, cfg.vocab_size, (SPEC_PREFIX,),
                         generator=rng).tolist()
    suffix = spec_prompt(rng, cfg.vocab_size, SPEC_SUFFIX)
    greedy = {"tokens": p, "max_new_tokens": SPEC_NEW, "logprobs": True}
    spec = {**greedy, "speculative": SPEC_K}
    sampled = {**spec, **SPEC_SAMPLED}
    pre = {"tokens": suffix, "prefix": head, "max_new_tokens": SPEC_NEW,
           "logprobs": True}
    http = BundleServer(state, port=0).start_background()
    url = http.url + "/invoke"
    try:
        before = http_json(http.url + "/metrics")["handler"]
        set_launches_to_zero()
        resp = {name: http_json(url, body) for name, body in (
            ("plain", greedy), ("spec", spec), ("sampled", sampled),
            ("sampled_again", sampled))}
        records, _ = _post_stream(url, spec)
        launches = kernel_launches()
        after = http_json(http.url + "/metrics")["handler"]
        resp["prefix_plain"] = http_json(url, pre)
        resp["prefix_spec"] = http_json(url, {**pre, "speculative": SPEC_K})
        prefix_stream, _ = _post_stream(url, {**pre, "speculative": SPEC_K})
    finally:
        http.stop()
    bad = [n for n, r in resp.items() if not r.get("ok")]
    if bad or not records[-1].get("done") \
            or not prefix_stream[-1].get("done"):
        raise SystemExit(f"path H ({path}): requests failed: {bad}")
    streamed = [t for r in records[:-1] for t in r["tokens"][0]]
    pre_streamed = [t for r in prefix_stream[:-1] for t in r["tokens"][0]]
    checks = {
        "spec = plain (tokens, served logprobs)":
            resp["spec"]["tokens"] == resp["plain"]["tokens"]
            and resp["spec"]["logprobs"] == resp["plain"]["logprobs"],
        "sampled the same twice":
            resp["sampled"]["tokens"] == resp["sampled_again"]["tokens"],
        "streamed = fused": streamed == resp["spec"]["tokens"][0],
        "prefix spec = prefix plain":
            resp["prefix_spec"]["tokens"] == resp["prefix_plain"]["tokens"]
            and resp["prefix_spec"]["logprobs"]
            == resp["prefix_plain"]["logprobs"],
        "prefix streamed = fused":
            pre_streamed == resp["prefix_spec"]["tokens"][0]}
    verifies = sum(r["speculative"]["steps"] for r in
                   (resp["spec"], resp["sampled"], resp["sampled_again"],
                    records[-1]))
    plain_steps = SPEC_NEW - 1
    want = spec_launches(layers, attn, 5 + plain_steps + verifies,
                         plain_steps + verifies)
    replays = after["replays"] - before["replays"]
    eager = after["eager_steps"] - before["eager_steps"]
    checks["launch identities"] = launches == want
    checks["every step and verify a replay"] = (
        replays == plain_steps + verifies and eager == 0)
    log(f"path H ({path}): launches {launches}, implied {want} for 5 "
        f"prefills, {plain_steps} plain steps and {verifies} verifies; "
        f"{replays} replays, {eager} eager steps")

    # directly: unrounded logprobs, rates and device times
    gen = server.generate(p, max_new_tokens=SPEC_NEW, return_logprobs=True)
    (sgen, stats) = server.generate_speculative(
        p, max_new_tokens=SPEC_NEW, k=SPEC_K, return_logprobs=True,
        return_stats=True)
    pgen = server.generate(suffix, prefix=head, max_new_tokens=SPEC_NEW,
                           return_logprobs=True)
    psgen = server.generate_speculative(suffix, prefix=head,
                                        max_new_tokens=SPEC_NEW, k=SPEC_K,
                                        return_logprobs=True)
    checks["direct spec bitwise plain"] = all(
        np.array_equal(a, b) for a, b in zip(gen, sgen))
    checks["direct prefix spec bitwise plain"] = all(
        np.array_equal(a, b) for a, b in zip(pgen, psgen))
    log(f"path H ({path}) checks: {checks}")
    if not all(checks.values()):
        raise SystemExit(f"path H ({path}) failed: {checks}")
    off = decode_rate(server.generate, [p])
    walls = []
    for n, fn in ((1, server.generate), (SPEC_NEW, lambda r, max_new_tokens:
                   server.generate_speculative(r, max_new_tokens=
                                               max_new_tokens, k=SPEC_K))):
        t0 = time.perf_counter()
        fn(p, max_new_tokens=n)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    on = (SPEC_NEW - 1) / (walls[1] - walls[0])
    accept = (stats["emitted"] - stats["steps"]) / (stats["steps"]
                                                   * (SPEC_K - 1))
    times = program_times(server, [p], SPEC_K)
    log(f"path H ({path}) batch 1: decode {off:.1f} tok/s spec off, "
        f"{on:.1f} tok/s at speculative={SPEC_K}; {stats['steps']} verifies "
        f"for {stats['emitted']} tokens: tokens_per_step "
        f"{stats['tokens_per_step']}, acceptance {accept:.4f}; device ms a "
        f"plain step {times['step_ms']:.4f}, a verify of kb={SPEC_K} "
        f"{times['verify_ms']:.4f} ({times['verify_ms'] / times['step_ms']:.3f}"
        f"x) [{card}]")
    out = {"checks": checks, "launches": launches, "implied": want,
           "replays": replays, "stats": stats, "acceptance": accept,
           "tok_s_off": off, "tok_s_on": on, "times": times,
           "spec_metrics": after.get("spec")}
    del state, server
    gc.collect()
    torch.cuda.empty_cache()
    return out


def spec_burst(engine, reqs) -> tuple:
    """D's burst driven directly through ``engine``: (each row's
    ``(tokens, logprobs)``, the burst's wall seconds)."""
    out = [None] * len(reqs)

    def send(i):
        _, body = reqs[i]
        out[i] = engine.generate(body["tokens"],
                                 max_new_tokens=body["max_new_tokens"],
                                 return_logprobs=True, **_knobs(body))

    _, wall = _drive(send, reqs)
    _idle(engine)
    return out, wall


def spec_engines(card: str) -> dict:
    """Path H's engines: D's burst (its 8 concurrent requests) over HTTP
    through a handler at ``spec_k = 8`` (paged, depth 2, lookup), then
    directly through paged engines at depths 2 and 1 and a dense one at
    depth 2, spec off and at ``spec_k = 8`` with lookup drafts and the
    model tier at
    ``draft_exit`` 1 and the model's depth: every row, greedy and
    seeded-sampled,
    bitwise the spec-off engine's (tokens and logprobs); the launch
    counters the steps, verifies and draft forwards imply; every step
    and verify a replay, none eager; the pool drained. Prints acceptance,
    ``tokens_per_step``, the burst's tok/s spec on and off, and a verify
    of 8 slots x kb = 8 against an 8-slot step in device time."""
    from lambdipy_tpu_torch.runtime.handlers import (HandlerContext,
                                                     generate_handler,
                                                     kernel_launches,
                                                     make_engine)
    from lambdipy_tpu_torch.runtime.metrics import SpecDecodeStats
    from lambdipy_tpu_torch.runtime.server import BundleServer

    extra = cut({**ENGINE_EXTRA, "max_new_tokens": "16",
                 "prefix_cache_mb": "0"})
    state = generate_handler(
        {"model": "llama3-8b", "dtype": "bfloat16", "quant": "int8",
         "extra": {**extra, "spec_k": str(SPEC_K)}},
        HandlerContext(device="cuda"))
    server, cfg = state.server, state.server.model.cfg
    layers = cfg.layers
    rng = torch.Generator().manual_seed(31)
    reqs = []
    for i, (s_len, n, kind) in enumerate(BURST):
        tokens = (spec_prompt(rng, cfg.vocab_size, s_len) if i % 2 == 0
                  else torch.randint(1, cfg.vocab_size, (s_len,),
                                     generator=rng).tolist())
        body = {"tokens": tokens, "max_new_tokens": n,
                **KNOBS.get(kind, {}), "logprobs": True}
        reqs.append((kind, body))
    charges = [-(-(len(b["tokens"]) + b["max_new_tokens"]) // 32)
               for _, b in reqs]
    new = new_tokens_of(reqs)
    http = BundleServer(state, port=0).start_background()
    resp = [None] * len(reqs)

    def send(i):
        resp[i] = http_json(http.url + "/invoke", reqs[i][1])

    try:
        set_launches_to_zero()
        _drive(send, reqs)
        launches = kernel_launches()
        metrics = http_json(http.url + "/metrics")["handler"]
    finally:
        http.stop()
    batching = metrics["batching"]
    want = spec_launches(layers, "paged_decode_attention",
                         batching["forwards"], batching["steps"])
    log(f"path H: D's burst over HTTP through a spec_k={SPEC_K} handler: "
        f"{batching['steps']} steps ({batching['verify_segments']} "
        f"verifies), spec {batching['spec']}; launches {launches} implied "
        f"{want}; replays {batching['replays']}, eager steps "
        f"{batching['eager_steps']} (server {metrics['eager_steps']})")
    if not all(r.get("ok") for r in resp) or metrics["eager_steps"] \
            or batching["eager_steps"] or launches != want \
            or batching["replays"] != batching["steps"]:
        raise SystemExit("path H: the spec_k handler's burst failed")
    served = [(np.asarray(r["tokens"]), np.asarray(r["logprobs"]))
              for r in resp]
    state.engine.release()
    results = {"http": {"spec": batching["spec"], "launches": launches,
                        "implied": want}}
    refs = {}
    for paged in ("1", "0"):
        attn = "paged_decode_attention" if paged == "1" else \
            "decode_attention"
        for depth in SPEC_DEPTHS[paged]:
            base = {**ENGINE_EXTRA, "kv_paged": paged,
                    "pipeline_depth": depth,
                    "kv_pages": str(sum(charges) + 1)}
            runs = [("off", 0, 0)] + [(m, SPEC_K, x or layers)
                                      for m, x in SPEC_MODES]
            if paged == "1" and depth == "2":
                runs.append(("off", 0, 0))  # spec off, timed warm
            for mode, k, exit_layer in runs:
                eng = make_engine(server, {**base, "spec_k": str(k),
                                           "draft_mode": mode,
                                           "draft_exit": str(exit_layer
                                                             or 1)})
                eng.spec_metrics = SpecDecodeStats()
                set_launches_to_zero()
                out, wall = spec_burst(eng, reqs)
                launches = kernel_launches()
                stats = eng.stats()
                key = f"paged={paged} depth={depth} {mode}" + (
                    f" exit={exit_layer}" if mode == "model" else "")
                if mode == "off":
                    refs.setdefault((paged, depth), out)
                want = spec_launches(
                    layers, attn, stats["forwards"], stats["steps"],
                    stats["draft_forwards"], eng.draft_exit)
                same = all(np.array_equal(a[0], b[0])
                           and np.array_equal(a[1], b[1])
                           for a, b in zip(out, refs[paged, depth]))
                ok = (same and launches == want
                      and stats["replays"] == stats["steps"]
                      and (mode != "lookup"
                           or stats["verify_segments"] == stats["steps"])
                      and stats["eager_steps"] == 0
                      and (paged == "0"
                           or eng.pool.stats()["pages_live"] == 0))
                rep = stats.get("spec", {})
                results[key] = {
                    "bitwise_spec_off": same, "launches": launches,
                    "implied": want, "wall_s": wall, "tok_s": new / wall,
                    "steps": stats["steps"],
                    "verify_segments": stats["verify_segments"],
                    "draft_forwards": stats["draft_forwards"],
                    "acceptance": rep.get("acceptance_rate"),
                    "tokens_per_step": rep.get("tokens_per_step"),
                    "k_hist": rep.get("draft", {}).get("k_hist")}
                log(f"path H {key}: {new} tokens in {wall:.3f} s, "
                    f"{new / wall:.1f} tok/s; {stats['steps']} steps "
                    f"({stats['verify_segments']} verifies, "
                    f"{stats['draft_forwards']} draft forwards), acceptance "
                    f"{rep.get('acceptance_rate')}, tokens_per_step "
                    f"{rep.get('tokens_per_step')}, k {rep.get('draft', {}).get('k_hist')}; "
                    f"bitwise spec off: {same}; launches {launches} implied "
                    f"{want}; replays {stats['replays']} eager "
                    f"{stats['eager_steps']} [{card}]")
                eng.release()
                del eng
                gc.collect()
                torch.cuda.empty_cache()
                if not ok:
                    raise SystemExit(f"path H {key} failed: {results[key]}")
    same_http = all(np.array_equal(a[0], b[0])
                    and np.array_equal(_as_served(b[1]), a[1])
                    for a, b in zip(served, refs["1", "2"]))
    log(f"path H: the spec_k={SPEC_K} handler's HTTP burst = the spec-off "
        f"engine's rows (tokens, served logprobs): {same_http}")
    if not same_http:
        raise SystemExit("path H: the HTTP burst's rows differ")
    prompts = [b["tokens"][:SPEC_TIMED_PROMPT] for _, b in reqs]
    results["times"] = program_times(server, prompts, SPEC_K)
    t = results["times"]
    log(f"path H: device ms of an 8-slot step {t['step_ms']:.4f}, of a "
        f"verify of 8 slots x kb={SPEC_K} {t['verify_ms']:.4f} "
        f"({t['verify_ms'] / t['step_ms']:.3f}x) [{card}]")
    del state, server
    gc.collect()
    torch.cuda.empty_cache()
    return results


def serve_spec_path(card: str) -> dict:
    """Path H: speculative decoding; its launch counters, from 0 before
    each counted phase, are summed into the kernels line."""
    out = {"A": solo_spec("A", card), "B": solo_spec("B", card)}
    out["engines"] = spec_engines(card)
    launches = dict.fromkeys(KERNELS, 0)
    phases = [out["A"]["launches"], out["B"]["launches"]] + [
        r["launches"] for r in out["engines"].values()
        if isinstance(r, dict) and "launches" in r]
    for phase in phases:
        for name, n in phase.items():
            launches[name] += n
    out["launches"] = launches
    return out


# path I: the prefix store's ship, offload and session tiers over D's paged
# engine, the store at the handler's default (512 MB): an exporter A (D's
# arena), an importer B (D's arena) and an offload handler O, all on one
# copy of the weights
SHIP_HEAD = 2048  # E's head: 64 blocks, one frame of 268,435,456 body bytes
SHIP_SUFFIX = 24  # within one block past the head: the route takes the head
SHIP_NEW = 24
SHIP_OTHER = 256  # a second head, for the import into a full arena
# O: an arena D's long joiners (1,000, 2,000 and 4,000 tokens) overrun
# together with E's head, and a host arena that holds everything spilled
OFFLOAD_EXTRA = {"kv_offload": "1", "kv_offload_mb": "2048",
                 "kv_pages": "320"}
OFFLOAD_JOINERS = (1000, 2000, 4000)
SESSION_HEAD = 1000  # the conversation's first turn
SESSION_PUSH = (1500, 1500, 1500)  # other heads past the store's 512 MB


def _post_raw(url: str, data: bytes, headers: dict | None = None,
              method: str = "POST"):
    """A raw request: (status, body bytes, headers); error statuses carry
    their body too."""
    req = urllib.request.Request(url, data=data, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _chunked_import(url: str, frames) -> tuple:
    """``POST /v1/kv/import`` with the frames as a chunked body:
    (status, JSON answer)."""
    import http.client

    host, port = url.split("//")[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=600)
    try:
        conn.request("POST", "/v1/kv/import", body=iter(frames),
                     headers={"Transfer-Encoding": "chunked"},
                     encode_chunked=True)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _routed_direct(state, row) -> tuple:
    """The handler's routed run of ``row`` (greedy, logprobs), driven
    directly so the logprobs come back unrounded: (matched, (tokens,
    logprobs)), the engine idle after it."""
    m = state.prefix_store.route(row)
    out = state.engine.generate(row[m:], prefix=row[:m],
                                max_new_tokens=SHIP_NEW,
                                return_logprobs=True)
    _idle(state.engine)
    return m, out


def _bitwise(a, b) -> bool:
    return bool(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]))


def _spill_all(store) -> int:
    """The pool's reclaim hook run until it frees nothing: every unshared,
    unpinned page of the store spilled (or dropped). Returns the sweeps'
    pages."""
    freed = 0
    while True:
        n = store.reclaim_pages(64)
        if not n:
            return freed
        freed += n


def _head_resident(store, head) -> int:
    """Blocks of ``head`` that hold a page in the arena now."""
    with store._lock:
        _, path = store._present_locked(head)
    return sum(1 for n in path if n.page_id is not None)


def ship_phase(a, b, o, head, prompt, card: str) -> dict:
    """I (a): the head exported by A over HTTP (cold: A walks it) as one
    frame; its bytes against the arithmetic; encode and decode timed; B
    imports the frame, O the same head as a chunked stream; A's routed
    run the reference, B's and O's routed runs bitwise it with no walk;
    the streamed blocks bitwise the frame's; a truncated frame a 400 that
    leaves B's tree alone; an import into B's arena made full a 503
    ``kv_import`` with Retry-After; export to first token on B timed."""
    from lambdipy_tpu_torch.runtime import kvwire

    cfg = a.state.server.model.cfg
    out: dict = {}
    # a head of the same shape through A and B first: the walk's, the
    # continuation's and the decode's graphs captured, so the times below
    # are a warm replica's
    rng = torch.Generator().manual_seed(32)
    warm = torch.randint(1, cfg.vocab_size, (len(prompt),),
                         generator=rng).tolist()
    for state in (a.state, b.state):
        _routed_direct(state, warm)
    t0 = time.perf_counter()
    code, frame, hdrs = _post_raw(a.url + "/v1/kv/export",
                                  json.dumps({"tokens": head}).encode())
    out["export_cold_ms"] = 1e3 * (time.perf_counter() - t0)
    if code != 200:
        raise SystemExit(f"path I (a): export answered {code}: {frame!r}")
    (hlen,) = np.frombuffer(frame[4:8], "<u4")
    body = len(frame) - 8 - int(hlen)
    want_body = (SHIP_HEAD * cfg.layers * 2 * cfg.kv_heads * cfg.head_dim
                 * torch.empty((), dtype=cfg.dtype).element_size())
    out.update(frame_bytes=len(frame), body_bytes=body,
               header_bytes=int(hlen))
    log(f"path I (a): A exported the {SHIP_HEAD}-token head cold (a walk "
        f"of warm graphs) in "
        f"{out['export_cold_ms']:.1f} ms: a frame of {len(frame)} bytes, "
        f"{body} of body ({SHIP_HEAD} x {cfg.layers} layers x 2 x "
        f"{cfg.kv_heads} kv heads x {cfg.head_dim} x 2 B = {want_body}) "
        f"and a {int(hlen)}-byte header")
    if body != want_body:
        raise SystemExit("path I (a): the frame's body is not the "
                         "arithmetic's")
    store_a = a.state.prefix_store
    t1 = time.perf_counter()
    h2, blocks = store_a.export_blocks(head)
    read_ms = 1e3 * (time.perf_counter() - t1)
    t1 = time.perf_counter()
    frame2 = kvwire.encode_frame(h2, store_a.block, blocks)
    out["encode_ms"] = 1e3 * (time.perf_counter() - t1)
    t1 = time.perf_counter()
    _, _, mono = kvwire.decode_frame(frame)
    out["decode_ms"] = 1e3 * (time.perf_counter() - t1)
    if frame2 != frame:
        raise SystemExit("path I (a): a second export's frame differs")
    log(f"path I (a): read of the 64 pages {read_ms:.1f} ms, encode "
        f"{out['encode_ms']:.1f} ms, decode {out['decode_ms']:.1f} ms "
        f"[{card}]")
    m_a, want = _routed_direct(a.state, prompt)
    rounds_b = b.state.prefix_store.prefill_stats.report()["rounds"]
    # export to first token: a warm export from A, the import into B,
    # then B's one-token run of the prompt (its wall is the TTFT)
    t0 = time.perf_counter()
    code, frame3, _ = _post_raw(a.url + "/v1/kv/export",
                                json.dumps({"tokens": head}).encode())
    t_export = time.perf_counter()
    code_i, ans, _ = _post_raw(b.url + "/v1/kv/import", frame3)
    t_import = time.perf_counter()
    first = http_json(b.url + "/invoke", {"tokens": prompt,
                                          "max_new_tokens": 1})
    t_first = time.perf_counter()
    out.update(export_warm_ms=1e3 * (t_export - t0),
               import_ms=1e3 * (t_import - t_export),
               ttft_ms=1e3 * (t_first - t_import),
               export_to_first_token_ms=1e3 * (t_first - t0))
    ans = json.loads(ans)
    log(f"path I (a): export to first token on B "
        f"{out['export_to_first_token_ms']:.1f} ms (warm export "
        f"{out['export_warm_ms']:.1f}, import {out['import_ms']:.1f}, "
        f"TTFT {out['ttft_ms']:.1f}) [{card}]")
    if code_i != 200 or ans.get("inserted") != SHIP_HEAD // store_a.block \
            or not first.get("prefix_cached") \
            or first["tokens"][0] != want[0][0][:1].tolist():
        raise SystemExit(f"path I (a): B's import or its first token "
                         f"failed: {ans}, {first}")
    m_b, got_b = _routed_direct(b.state, prompt)
    # O takes the same head as a stream of chunks
    code, raw, _ = _post_raw(a.url + "/v1/kv/export",
                             json.dumps({"tokens": head,
                                         "stream": True}).encode())
    frames = [f for _, f in kvwire.FrameSplitter().feed(raw)]
    _, _, streamed_blocks = kvwire.decode_stream(frames)
    same_blocks = all(torch.equal(x[i][n], y[i][n])
                      for x, y in zip(mono, streamed_blocks)
                      for i in range(len(x)) for n in x[i])
    code_o, ans_o = _chunked_import(o.url, frames)
    m_o, got_o = _routed_direct(o.state, prompt)
    walked = {"B": b.state.prefix_store.prefill_stats.report()["rounds"]
              - rounds_b,
              "O": o.state.prefix_store.prefill_stats.report()["rounds"]}
    out.update(stream_frames=len(frames), streamed_bitwise=same_blocks,
               b_bitwise=_bitwise(got_b, want), o_bitwise=_bitwise(got_o,
                                                                  want),
               walked=walked)
    log(f"path I (a): routed {m_a}/{m_b}/{m_o} tokens on A/B/O; B (frame) "
        f"bitwise A: {out['b_bitwise']}; O (stream of {len(frames)} "
        f"frames) bitwise A: {out['o_bitwise']}; streamed blocks bitwise "
        f"the frame's: {same_blocks}; walk chunks on B and O: {walked}")
    if not (m_a == m_b == m_o == SHIP_HEAD and out["b_bitwise"]
            and out["o_bitwise"] and same_blocks and code_o == 200
            and ans_o.get("streamed") and walked == {"B": 0, "O": 0}):
        raise SystemExit(f"path I (a): an imported head did not route "
                         f"bitwise the exporter's run ({ans_o})")

    # a truncated frame: 400, B's tree and pool unchanged
    store_b, pool_b = b.state.prefix_store, b.state.engine.pool
    before = (store_b.check_invariants()["pages"],
              pool_b.stats()["pages_live"])
    code, msg, _ = _post_raw(b.url + "/v1/kv/import", frame[:-1000])
    after = (store_b.check_invariants()["pages"],
             pool_b.stats()["pages_live"])
    log(f"path I (a): a truncated frame answered {code} "
        f"({json.loads(msg)['error'][:60]}...), tree unchanged: "
        f"{before == after}")
    if code != 400 or before != after:
        raise SystemExit("path I (a): a truncated frame was not a 400 "
                         "that left the tree alone")
    # a full arena: every free page held, every live page shared
    rng = torch.Generator().manual_seed(33)
    other = torch.randint(1, cfg.vocab_size, (SHIP_OTHER,),
                          generator=rng).tolist()
    _, other_frame, _ = _post_raw(a.url + "/v1/kv/export",
                                  json.dumps({"tokens": other}).encode())
    held = pool_b.alloc(pool_b.free_count(), record_shed=False,
                        reclaim=False)
    live = [p for p in pool_b.snapshot_refs() if p != 0 and p not in held]
    pool_b.retain(live)
    try:
        code, msg, hdrs = _post_raw(b.url + "/v1/kv/import", other_frame)
    finally:
        pool_b.release(live)
        pool_b.release(held)
    log(f"path I (a): an import into a full arena answered {code} "
        f"{msg.decode()[:80]} Retry-After {hdrs.get('Retry-After')}")
    if code != 503 or json.loads(msg).get("shed") != "kv_import" \
            or not hdrs.get("Retry-After"):
        raise SystemExit("path I (a): an import into a full arena was not "
                         "the priced 503 kv_import")
    out["want"] = want
    return out


def offload_phase(o, prompt, want, card: str) -> dict:
    """I (b): D's long joiners through O's small arena sweep the head
    (spilled to the host arena), the reclaim hook spills the rest; the
    head's next request re-onlines every page and is bitwise the run
    before the spill; the re-online timed per page against a plain pinned
    copy of the same bytes; with ``offload_stall`` armed once the next
    re-online fails, the head is walked again (64 recomputes) and the run
    is still bitwise."""
    state, store = o.state, o.state.prefix_store
    cfg = state.server.model.cfg
    head = prompt[:SHIP_HEAD]
    rng = torch.Generator().manual_seed(34)
    for n in OFFLOAD_JOINERS:
        row = torch.randint(1, cfg.vocab_size, (n,), generator=rng).tolist()
        r = http_json(o.url + "/invoke", {"tokens": row,
                                          "max_new_tokens": SHIP_NEW})
        if not r.get("ok"):
            raise SystemExit(f"path I (b): a joiner failed: {r}")
    _idle(state.engine)
    swept = store.check_invariants()["offloaded_blocks"]
    resident = _head_resident(store, head)
    _spill_all(store)
    log(f"path I (b): D's long joiners {OFFLOAD_JOINERS} through O's "
        f"{OFFLOAD_EXTRA['kv_pages']}-page arena left {swept} blocks "
        f"spilled and {resident} of the head's 64 resident; the reclaim "
        f"hook spilled the rest: {_head_resident(store, head)} resident")
    if _head_resident(store, head):
        raise SystemExit("path I (b): the head did not leave the card")
    off0 = state.engine.pool.stats()["kv_offload"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = store.route(prompt)
    torch.cuda.synchronize()
    reonline_s = time.perf_counter() - t0
    _, got = _routed_direct(state, prompt)
    off1 = state.engine.pool.stats()["kv_offload"]
    pages = off1["reonline_pages"] - off0["reonline_pages"]
    nbytes = pages * state.engine.pool.page_bytes
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    copy_ms = cuda_time(lambda _: dev.copy_(host, non_blocking=True))
    del host, dev
    out = {"reonline_pages": pages, "reonline_ms": 1e3 * reonline_s,
           "reonline_ms_per_page": 1e3 * reonline_s / max(1, pages),
           "reonline_gbps": nbytes / reonline_s / 1e9,
           "pinned_copy_ms": copy_ms,
           "pinned_copy_gbps": nbytes / copy_ms / 1e6,
           "reonline_bitwise": _bitwise(got, want)}
    log(f"path I (b): the head's next request re-onlined {pages} pages "
        f"({nbytes} bytes) in {out['reonline_ms']:.1f} ms, "
        f"{out['reonline_ms_per_page']:.3f} ms a page, "
        f"{out['reonline_gbps']:.2f} GB/s host to device; a plain pinned "
        f"copy_ of the same bytes {copy_ms:.2f} ms, "
        f"{out['pinned_copy_gbps']:.2f} GB/s; bitwise the run before the "
        f"spill: {out['reonline_bitwise']} [{card}]")
    if m != SHIP_HEAD or pages != SHIP_HEAD // store.block \
            or not out["reonline_bitwise"]:
        raise SystemExit("path I (b): the re-onlined head was not bitwise "
                         "its run before the spill")
    _spill_all(store)
    if _head_resident(store, head):
        raise SystemExit("path I (b): the head did not spill again")
    rounds0 = store.prefill_stats.report()["rounds"]
    state.faults_admin_fn({"spec": "offload_stall:exception"})
    _, got = _routed_direct(state, prompt)
    state.faults_admin_fn({"clear": True})
    off2 = state.engine.pool.stats()["kv_offload"]
    out.update(stall_bitwise=_bitwise(got, want),
               recomputes=off2["recomputes"] - off1["recomputes"],
               stall_walk_chunks=store.prefill_stats.report()["rounds"]
               - rounds0, kv_offload=off2)
    log(f"path I (b): offload_stall armed once: {out['recomputes']} "
        f"recomputes, the head walked again in {out['stall_walk_chunks']} "
        f"chunks, bitwise: {out['stall_bitwise']}; kv_offload: spills "
        f"{off2['spill_pages']} pages, re-onlines {off2['reonline_pages']}, "
        f"recomputes {off2['recomputes']}, refusals "
        f"{off2['spill_refusals']}, drops {off2['drops']}")
    if not out["stall_bitwise"] or out["recomputes"] != SHIP_HEAD \
            // store.block:
        raise SystemExit("path I (b): the stalled re-online did not "
                         "recompute bitwise")
    return out


def session_phase(b, card: str) -> dict:
    """I (c) on B: a three-turn conversation under ``x-session-id``; other
    heads pushed through the store past its 512 MB between turns; turns 2
    and 3 hit the pinned head, turn 3 past an injected engine failure
    (``segment_fetch:exception``, replayed at G's defaults); a new session
    past the pin budget is a 503 ``session_pins`` with Retry-After;
    ``DELETE`` brings the pin gauges to 0."""
    state, store = b.state, b.state.prefix_store
    cfg = state.server.model.cfg
    rng = torch.Generator().manual_seed(35)

    def tokens(n):
        return torch.randint(1, cfg.vocab_size, (n,), generator=rng).tolist()

    hdr = {"Content-Type": "application/json", "x-session-id": "chat"}
    turns, prompt, hits = [], tokens(SESSION_HEAD), []
    for turn in range(3):
        if turn:
            st0 = store.stats()
            for n in SESSION_PUSH:
                # an export walks the head into the store and decodes
                # nothing: the budget sweep may take the pushed head's own
                # tail, which a generate would then serve solo
                code, _, _ = _post_raw(b.url + "/v1/kv/export", json.dumps(
                    {"tokens": tokens(n)}).encode())
                if code != 200:
                    raise SystemExit(f"path I (c): a push answered {code}")
            pushed = store.stats()
            if turn == 2:
                state.faults_admin_fn(
                    {"spec": "segment_fetch:exception@seg=1"})
            faults0 = state.engine.stats()["faults"]
        before = store.stats()
        code, body, _ = _post_raw(b.url + "/invoke", json.dumps(
            {"tokens": prompt, "max_new_tokens": SHIP_NEW}).encode(), hdr)
        after = store.stats()
        body = json.loads(body)
        if code != 200 or not body.get("ok"):
            raise SystemExit(f"path I (c): turn {turn + 1} failed: {body}")
        rec = {"prompt": len(prompt), "pinned_leaves":
               after["pinned_leaves"],
               "hit_tokens": after["hit_tokens"] - before["hit_tokens"]}
        if turn:
            rec.update(evicted=pushed["evictions"] - st0["evictions"],
                       pinned_before=before["pinned_leaves"])
            hits.append(rec["hit_tokens"] >= before["pinned_leaves"]
                        * store.block > 0 and rec["evicted"] > 0)
        if turn == 2:
            fd = _faults_delta({"faults": faults0}, state.engine.stats())
            rec["replays"] = fd["replays"]
            hits[-1] = hits[-1] and fd["replays"]["succeeded"] >= 1
            state.faults_admin_fn({"clear": True})
        turns.append(rec)
        prompt = prompt + body["tokens"][0] + tokens(SHIP_SUFFIX)
    log(f"path I (c): three turns under one session: {turns}")
    if not all(hits):
        raise SystemExit("path I (c): a later turn did not hit its pinned "
                         "head past the pushed heads (or the failure was "
                         "not replayed)")
    code, body, hdrs = _post_raw(b.url + "/invoke", json.dumps(
        {"tokens": tokens(SHIP_HEAD + SHIP_SUFFIX),
         "max_new_tokens": 4}).encode(),
        {"Content-Type": "application/json", "x-session-id": "big"})
    body = json.loads(body)
    log(f"path I (c): a new session past the pin budget "
        f"({store.pin_budget_bytes} bytes) answered {code} {body} "
        f"Retry-After {hdrs.get('Retry-After')}")
    if code != 503 or body.get("shed") != "session_pins" \
            or not hdrs.get("Retry-After"):
        raise SystemExit("path I (c): the pin budget did not shed a new "
                         "session with Retry-After")
    code, body, _ = _post_raw(b.url + "/v1/sessions/chat", None,
                              method="DELETE")
    metrics = http_json(b.url + "/metrics")["handler"]
    gauges = {"pinned_leaves": metrics["prefix_cache"]["pinned_leaves"],
              "pinned_bytes": metrics["prefix_cache"]["pinned_bytes"],
              "pinned_pages": metrics["batching"]["page_pool"][
                  "pinned_pages"]}
    log(f"path I (c): DELETE answered {code} {json.loads(body)}; pin "
        f"gauges after it {gauges}")
    if code != 200 or any(gauges.values()):
        raise SystemExit("path I (c): DELETE did not release the pins")
    return {"turns": turns, "gauges_after_delete": gauges}


def serve_ship_path(card: str) -> dict:
    """Path I: three handlers over llama3-8b (int8 weights, bf16 paged K/V,
    the store at 512 MB) on one copy of the weights, each behind its own
    HTTP server: I (a) the K/V ship A -> B (one frame) and A -> O (a
    chunked stream), I (b) O's host offload tier, I (c) sessions on B.
    Launch counters from 0 before the traffic: the int8 matmul 225 x the
    forwards (walk chunks, continuations, engine forwards), the paged
    decode attention 32 x the engine steps, summed over the three."""
    from lambdipy_tpu_torch.runtime.handlers import (HandlerContext,
                                                     generate_handler,
                                                     kernel_launches)
    from lambdipy_tpu_torch.runtime.server import BundleServer

    spec = {"model": "llama3-8b", "dtype": "bfloat16", "quant": "int8",
            "extra": cut(PREFIX_EXTRA)}
    t0 = time.perf_counter()
    a_state = generate_handler(spec, HandlerContext(device="cuda"))
    weights = a_state.server.model.state_dict()
    b_state = generate_handler(spec, HandlerContext(device="cuda",
                                                    state_dict=weights))
    o_state = generate_handler(
        {**spec, "extra": cut({**PREFIX_EXTRA, **OFFLOAD_EXTRA})},
        HandlerContext(device="cuda", state_dict=weights))
    del weights
    states = (a_state, b_state, o_state)
    if any(s.prefix_store is None or s.prefix_store.pool is None
           for s in states) or o_state.prefix_store.offload is None \
            or next(iter(b_state.server.model.state_dict().values()))\
            .data_ptr() != next(iter(a_state.server.model.state_dict()
                                     .values())).data_ptr():
        raise SystemExit("path I: the handlers are not paged stores on one "
                         "copy of the weights")
    log(f"path I: handlers A, B (8 slots, {a_state.engine.pool.n_pages} "
        f"pages each) and O ({o_state.engine.pool.n_pages} pages, host "
        f"offload {o_state.prefix_store.offload.budget_bytes >> 20} MiB) "
        f"on one copy of the weights, built in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    servers = [BundleServer(s, port=0).start_background() for s in states]
    a, b, o = servers
    cfg = a_state.server.model.cfg
    rng = torch.Generator().manual_seed(21)
    head = torch.randint(1, cfg.vocab_size, (SHIP_HEAD,),
                         generator=rng).tolist()
    prompt = head + torch.randint(1, cfg.vocab_size, (SHIP_SUFFIX,),
                                  generator=rng).tolist()
    try:
        set_launches_to_zero()  # counters to 0 just before the path
        out = {"ship": ship_phase(a, b, o, head, prompt, card)}
        want = out["ship"].pop("want")
        out["offload"] = offload_phase(o, prompt, want, card)
        out["sessions"] = session_phase(b, card)
        for st in states:
            _idle(st.engine)
        launches = kernel_launches()
    finally:
        for srv in servers:
            srv.stop()
    # the forwards: the store's walk chunks and any solo run's prefills
    # (the server's own prefill programs), a solo run's decode steps (the
    # server's decode programs), the engine's continuations and forwards.
    # A row whose pages the budget sweep took between its route and its
    # admission runs solo, as in JAX: its decode reads kernel 1
    forwards = steps = solo_steps = rounds = 0
    for st in states:
        es, ps = st.engine.stats(), st.server.program_stats()
        solo_steps += ps["replays"] + ps["eager_steps"]
        rounds += st.prefix_store.prefill_stats.report()["rounds"]
        forwards += (ps["prefill_replays"] + ps["eager_prefills"]
                     + ps["replays"] + ps["eager_steps"]
                     + es["prefix_joins"] + es["forwards"])
        steps += es["steps"]
        st.engine.pool.check_invariants()
        inv = st.prefix_store.check_invariants()
        if not inv["ok"]:
            raise SystemExit(f"path I: store invariants {inv}")
    want_l = dict.fromkeys(KERNELS, 0)
    want_l["int8_matmul"] = (7 * cfg.layers + 1) * forwards
    want_l["paged_decode_attention"] = cfg.layers * steps
    want_l["decode_attention"] = cfg.layers * solo_steps
    log(f"path I launch counters: {launches}, implied {want_l} ({forwards} "
        f"forwards: {rounds} walk chunks; {steps} engine steps; "
        f"{solo_steps} decode steps of solo fallbacks, over A, B and O)")
    if launches != want_l:
        raise SystemExit(f"path I: launch counters {launches} != implied "
                         f"{want_l}")
    out["launches"] = launches
    for st in states:
        st.engine.release()
    del states, a_state, b_state, o_state
    gc.collect()
    torch.cuda.empty_cache()
    return out


# D's warm turns: D's burst over HTTP through fresh handlers on D's weights,
# after the background warm has finished (judged by /healthz ready) and
# with warm_group_prefill "0", in turns
WARM_TURNS = ("warm", "cold")
WARMUP_BODY = {"tokens": [1, 2, 3, 4], "max_new_tokens": 4}


def _until_ready(url: str, timeout: float = 300.0) -> float:
    """Seconds until ``/healthz`` reads ready."""
    t0 = time.perf_counter()
    while not http_json(url + "/healthz")["ready"]:
        if time.perf_counter() - t0 > timeout:
            raise SystemExit(f"not ready {timeout} s after the first invoke")
        time.sleep(0.02)
    return time.perf_counter() - t0


def warm_turn(weights, reqs, resp, warm: bool, card: str) -> dict:
    """One turn: a fresh handler over ``weights`` (D's extras; the warm on
    or off), its first invoke (a boot warmup: it captures the engine's
    decode step and, warm, releases the warm), the wait for ready, then
    D's traffic over HTTP. Every row's tokens (and logprobs) must be D's
    HTTP burst's. Returns tok/s, the joiners' TTFT, the pool bytes before
    and after the warm against ``program_cache_bytes``, and the engine's
    counters."""
    from lambdipy_tpu_torch.models.graphs import DEVICE_LOCK
    from lambdipy_tpu_torch.runtime.handlers import (HandlerContext,
                                                     generate_handler)
    from lambdipy_tpu_torch.runtime.server import BundleServer

    spec = {"model": "llama3-8b", "dtype": "bfloat16", "quant": "int8",
            "extra": {**ENGINE_EXTRA, "max_new_tokens": "16",
                      "prefix_cache_mb": "0",
                      "warm_group_prefill": "1" if warm else "0"}}
    state = generate_handler(spec, HandlerContext(device="cuda",
                                                  state_dict=weights))
    engine = state.engine
    srv = BundleServer(state, port=0).start_background()
    got = [None] * len(reqs)
    try:
        http_json(srv.url + "/invoke", WARMUP_BODY)
        before = state.server.program_stats()
        warm_s = _until_ready(srv.url)
        after = state.server.program_stats()
        warm_block = http_json(srv.url + "/metrics")["handler"].get(
            "warm_buckets")
        t_first = len(engine.request_log)

        def send(i):
            body = {k: v for k, v in reqs[i][1].items() if k != "stream"}
            got[i] = http_json(srv.url + "/invoke", body)

        _, burst_s = _drive(send, reqs)
    finally:
        srv.stop()
    for (kind, _), r, want in zip(reqs, got, resp):
        if r["tokens"] != want["tokens"] or r.get("logprobs", []) \
                != want.get("logprobs", r.get("logprobs", [])):
            raise SystemExit(f"path D warm turns: the {kind} row differs from "
                             f"D's HTTP burst")
    stats = engine.stats()
    log_by = {(e["s"], e["n"]): e for e in list(engine.request_log)[t_first:]}
    joiners = [log_by[(len(b["tokens"]), b["max_new_tokens"])]["ttft_s"]
               for _, b in reqs[8:]]
    out = {"warm": warm, "warm_s": warm_s, "burst_s": burst_s,
           "decode_tok_s": new_tokens_of(reqs) / burst_s,
           "joiner_ttft_s": joiners, "warm_buckets": warm_block,
           "program_bytes_before_warm": before["program_bytes"],
           "program_bytes_after_warm": after["program_bytes"],
           "program_bytes_after_burst": state.server.program_stats()[
               "program_bytes"],
           "program_cache_bytes": after["program_cache_bytes"],
           "program_evictions": state.server.program_stats()[
               "program_evictions"],
           "engine": {k: stats[k] for k in (
               "steps", "forwards", "warm_prefills", "prefill_groups",
               "row_prefills", "compile_count", "replays", "eager_steps",
               "prefill_replays", "eager_prefills")}}
    if stats["eager_steps"] or stats["eager_prefills"]:
        raise SystemExit("path D warm turns: an engine step or prefill ran "
                         "eagerly")
    log(f"path D {'warm' if warm else 'cold'} turn: burst {burst_s:.3f} s, "
        f"{out['decode_tok_s']:.1f} tok/s, joiners' TTFT "
        f"{[round(t, 3) for t in joiners]} s, warm {warm_s:.3f} s "
        f"({warm_block}), graph pools and caches "
        f"{before['program_bytes'] / 2**30:.3f} GiB before the warm, "
        f"{after['program_bytes'] / 2**30:.3f} after, "
        f"{out['program_bytes_after_burst'] / 2**30:.3f} after the burst, of "
        f"{after['program_cache_bytes'] / 2**30:.3f} "
        f"(program_cache_bytes), {out['program_evictions']} evictions "
        f"[{card}]")
    engine.release()
    with DEVICE_LOCK:
        state.server.programs.drop_idle()
    del state, engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def warm_turns(d_state, reqs, resp, card: str) -> dict:
    """D's warm turns (warm, then cold) on D's weights, D's engine
    and programs released first. The launch counters, from 0 before the
    turns, must equal 32 x the turns' engine steps (kernel 3) and 225 x
    their forwards, the warm's group prefills included (kernel 2)."""
    from lambdipy_tpu_torch.models.graphs import DEVICE_LOCK
    from lambdipy_tpu_torch.runtime.handlers import kernel_launches

    weights = d_state.server.model.state_dict()
    layers = d_state.server.model.cfg.layers
    d_state.engine.release()
    with DEVICE_LOCK:
        d_state.server.programs.drop_idle()
    gc.collect()
    torch.cuda.empty_cache()
    set_launches_to_zero()  # counters to 0 just before the turns
    turns = [warm_turn(weights, reqs, resp, kind == "warm", card)
             for kind in WARM_TURNS]
    launches = kernel_launches()
    want = dict.fromkeys(KERNELS, 0)
    want["paged_decode_attention"] = layers * sum(t["engine"]["steps"]
                                                  for t in turns)
    want["int8_matmul"] = (7 * layers + 1) * sum(t["engine"]["forwards"]
                                                 for t in turns)
    log(f"path D warm turns launch counters: {launches}, implied {want}")
    if launches != want:
        raise SystemExit(f"path D warm turns: launch counters {launches} != "
                         f"implied {want}")
    for kind in ("warm", "cold"):
        rates = [t["decode_tok_s"] for t in turns if t["warm"] == (kind == "warm")]
        log(f"path D {kind} turns: {[round(r, 1) for r in rates]} tok/s "
            f"[{card}]")
    return {"turns": turns, "launches": launches, "implied": want}


# path J: the long-context tier on llama3-8b at full width
LC_WINDOW = 8192
LC_NEW = 128
LC_PROMPT = 4 * LC_WINDOW - LC_NEW  # the request: 32,768 tokens in all
LC_BASE0 = 6000      # (a): a 4,096-token chunk and a 1,904-token tail
LC_BASE0_NEW = 64
LC_CAP_LESS = 8      # (c), (d): resident_cap = the view's pages less this
LC_EXTRA = {**ENGINE_EXTRA, "max_new_tokens": "16", "kv_offload": "1",
            # the runs' spilled history (~24,576 tokens x 128 KiB) fits
            "kv_offload_mb": "4096",
            "max_logical_ctx": str(4 * LC_WINDOW),
            # (a): the engine's chunked row runs the runner's schedule
            "prefill_chunk": "4096"}


def serve_longctx_path(card: str) -> dict:
    """Path J: the long-context tier (``runtime/longctx.py``) on llama3-8b
    (int8 weights, bf16 paged K/V, ``blocked``, the store at 512 MB with a
    4 GiB host offload arena), seeded random weights. A 32,768-token
    request (4x the 8,192-position window: 32,640 + 128 new) through the
    engine's route over HTTP. Checks: (a) at base 0 a 6,000-token row is
    bitwise (tokens, logprobs) the engine's chunked row over the same
    schedule (the routed bound against a one-pass prefill is D (h)'s);
    (b) the request twice, bitwise; (c) churned (``resident_cap``) against
    unchurned, bitwise; (d) churned under an armed ``offload_stall``: the
    re-online fails, the run replays, bitwise; (e) kernel 2 = 225 x
    forwards (prefill chunks and solo prefills counted), kernel 3 = 32 x
    the runner's and the engine's decode steps, kernel 1 = 32 x the solo
    decode steps; (f) zero pages leaked, no runner page left offloaded,
    the pool's invariants."""
    from lambdipy_tpu_torch.runtime.handlers import (HandlerContext,
                                                     generate_handler,
                                                     kernel_launches)
    from lambdipy_tpu_torch.runtime.server import BundleServer

    spec = {"model": "llama3-8b", "dtype": "bfloat16", "quant": "int8",
            "extra": cut(LC_EXTRA)}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = generate_handler(spec, HandlerContext(device="cuda"))
    engine, server = state.engine, state.server
    cfg = server.model.cfg
    runner = engine._longctx_runner()
    if runner is None or runner.window != LC_WINDOW:
        raise SystemExit("path J: no long-context runner over the window")
    log(f"path J: llama3-8b, window {runner.window} ({runner.n_view} pages "
        f"of {engine.pool.page}), max_logical_ctx {runner.max_logical_ctx}, "
        f"host offload {runner.offload.budget_bytes >> 20} MiB, built in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = torch.Generator().manual_seed(31)
    long_row = torch.randint(1, cfg.vocab_size, (LC_PROMPT,),
                             generator=rng).tolist()
    short_row = torch.randint(1, cfg.vocab_size, (LC_BASE0,),
                              generator=rng).tolist()
    srv = BundleServer(state, port=0).start_background()
    url = srv.url + "/invoke"
    body = {"tokens": long_row, "max_new_tokens": LC_NEW, "logprobs": True}
    runs = {}
    try:
        set_launches_to_zero()  # counters to 0 just before the path
        # (a) base 0: the runner against the engine's chunked row
        r_a = runner.generate(short_row, max_new_tokens=LC_BASE0_NEW,
                              return_logprobs=True)
        e_a = engine.generate(short_row, max_new_tokens=LC_BASE0_NEW,
                              return_logprobs=True)
        _idle(engine)
        same_a = all(np.array_equal(r_a[j], e_a[j]) for j in (0, 1))
        log(f"path J (a): at base 0 a {LC_BASE0}-token row through the runner "
            f"is bitwise the engine's chunked row over the same schedule "
            f"(tokens and logprobs): {same_a}")
        if not same_a:
            raise SystemExit("path J (a): the runner at base 0 differs from "
                             "the engine's chunked row")
        # (b) the request twice over HTTP
        outs = []
        for name, cap, fault in (("first", None, None),
                                 ("second", None, None),
                                 ("churned", runner.n_view - LC_CAP_LESS,
                                  None),
                                 ("replayed", runner.n_view - LC_CAP_LESS,
                                  "offload_stall:exception")):
            runner.resident_cap = cap
            if fault:
                http_json(srv.url + "/v1/debug/faults", {"spec": fault})
            before = runner.report()
            outs.append(http_json(url, body))
            rep = runner.report()
            runs[name] = {**runner.last_run, **{
                k: rep[k] - before[k] for k in (
                    "spill_pages", "spill_bytes", "reonline_pages",
                    "prefetch_hits", "demand_misses", "stalls", "stall_s",
                    "recomputes", "spill_s", "reonline_s", "chunks",
                    "steps")}}
            if fault:
                http_json(srv.url + "/v1/debug/faults", {"clear": True})
            run = runs[name]
            log(f"path J {name} run: TTFT {run['ttft_s']:.3f} s, decode "
                f"{LC_NEW / run['decode_s']:.1f} tok/s past the window "
                f"({run['steps']} steps), {run['chunks']} chunks, spilled "
                f"{run['spill_pages']} pages ({run['spill_bytes'] / 2**20:.1f}"
                f" MiB, {run['spill_bytes'] / max(run['spill_s'], 1e-9) / 1e9:.3f}"
                f" GB/s of spill wall), re-onlined {run['reonline_pages']} "
                f"pages ({run['reonline_s']:.3f} s), prefetch hits "
                f"{run['prefetch_hits']}, demand misses "
                f"{run['demand_misses']}, stalls {run['stalls']} "
                f"({run['stall_s']:.3f} s), recomputes {run['recomputes']} "
                f"[{card}]")
        runner.resident_cap = None
        launches = kernel_launches()
        metrics = http_json(srv.url + "/metrics")
    finally:
        srv.stop()
    first, second, churned, replayed = outs
    first_ = _without_latency(first)
    checks = {"(b) twice": _without_latency(second) == first_,
              "(c) churned": _without_latency(churned) == first_,
              "(d) replayed": _without_latency(replayed) == first_,
              "latency_ms in every body": all("latency_ms" in o
                                              for o in outs)}
    log(f"path J (b)-(d): the second run, the churned run and the replay "
        f"after a failed re-online bitwise the first (tokens and logprobs as "
        f"served): {checks}")
    if not all(checks.values()) or not first["ok"] \
            or len(first["tokens"][0]) != LC_NEW:
        raise SystemExit(f"path J: {checks}")
    if runs["churned"]["prefetch_hits"] <= 0 \
            or runs["replayed"]["recomputes"] <= 0:
        raise SystemExit("path J: the churned run prefetched nothing or the "
                         "armed run did not replay")
    # (e) the launch identity
    rep, es, ps = runner.report(), engine.stats(), server.program_stats()
    solo_steps = ps["replays"] + ps["eager_steps"]
    forwards = (rep["forwards"] + es["forwards"] + ps["prefill_replays"]
                + ps["eager_prefills"] + solo_steps)
    want = dict.fromkeys(KERNELS, 0)
    want["int8_matmul"] = (7 * cfg.layers + 1) * forwards
    want["paged_decode_attention"] = cfg.layers * (rep["steps"] + es["steps"])
    want["decode_attention"] = cfg.layers * solo_steps
    log(f"path J (e) launch counters: {launches}, implied {want} ({forwards} "
        f"forwards: the runner's {rep['chunks']} chunks and {rep['steps']} "
        f"steps, the engine's {es['forwards']}, the solo run's "
        f"{ps['prefill_replays'] + ps['eager_prefills']} prefill and "
        f"{solo_steps} steps)")
    if launches != want:
        raise SystemExit(f"path J (e): launch counters {launches} != {want}")
    if rep["eager_steps"] or rep["replays"] != rep["steps"]:
        raise SystemExit("path J: a runner decode step ran eagerly")
    # (f) no page leaked
    pool = engine.pool
    pool.check_invariants()
    page_stats = pool.stats()
    log(f"path J (f): {page_stats['pages_live']} pages live after the runs "
        f"(the store holds {state.prefix_store.stats()['blocks']} blocks), "
        f"{page_stats['kv_offload']['offloaded_pages']} offloaded, pool "
        f"invariants hold; peak {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB allocated [{card}]")
    if page_stats["pages_live"] != state.prefix_store.stats()["blocks"] \
            or page_stats["kv_offload"]["offloaded_pages"]:
        raise SystemExit("path J (f): pages leaked")
    log_pools("J (server)", ps["program_pools"])
    out = {"spec": spec, "runs": runs, "launches": launches,
           "implied": want, "runner": rep, "checks": checks,
           "base0_bitwise_engine": same_a,
           "long_context": metrics["handler"]["batching"]["long_context"],
           "max_memory_allocated_gib": (torch.cuda.max_memory_allocated()
                                        / 2**30), "card": card}
    engine.release()
    runner.release()
    del state, engine, server, runner
    gc.collect()
    torch.cuda.empty_cache()
    return out


# path K: the port boots a bundle written without JAX (params.fpk,
# manifest.json, handler.py in the JAX builder's text) in process and as
# a CLI process
BUNDLE_EXTRA = {**{k: v for k, v in ENGINE_EXTRA.items()
                   if k != "warm_group_prefill"},  # the warm on by default
                "max_new_tokens": "16", "prefix_cache_mb": "0"}
BUNDLE_PROMPTS = (100, 24, 300, 700)  # (b)'s prompts; the first is (c)'s
BUNDLE_NEW = 16
BUNDLE_INVOKES = 30
BUNDLE_RUNS = 1
# the JAX builder's handler template (lambdipy_tpu/bundle/package.py:29-47)
HANDLER_TEMPLATE = '''\
"""Generated bundle entrypoint ({recipe}).

The serve runtime imports this module with the bundle site tree and base
layer on sys.path, calls ``init(ctx)`` once at boot (cold start), then
``invoke(state, request)`` per request.
"""

from {module} import {attr} as _build_handler

_SPEC = {spec!r}


def init(ctx):
    return _build_handler(_SPEC, ctx)


def invoke(state, request):
    return state.invoke(request)
'''
# the versions of the jax-tpu layer's JAX distributions a JAX build of
# this repository records (its CPU tests' bundles): K's manifest names the
# layer as a JAX-built bundle does, so the skew check runs as it would
JAX_BUILD_VERSIONS = {"jax": "0.9.0", "jaxlib": "0.9.0", "flax": "0.12.3",
                      "orbax-checkpoint": "0.11.32", "ml-dtypes": "0.5.4"}


def write_bundle(bundle: Path, spec: dict, attr: str, card: str,
                 tree: dict | None = None, params_info: dict | None = None,
                 base: str = "jax-tpu", label: str = "K") -> dict:
    """A bundle without JAX, for any model: ``params/params.fpk`` from
    ``tree`` (a variables tree in the flax layout, ``{"params": ...}`` and,
    for a ResNet, ``"batch_stats"``; the port's writer), ``handler.py`` in
    the JAX template's text naming ``lambdipy_tpu.runtime.handlers:attr``,
    ``manifest.json`` with the payload JAX's ``materialize_payload`` writes
    (``bundle/package.py:57-109``), ``params_info`` in it. With no tree,
    ``params/`` is what the caller put there (a ``model.pt``, a
    ``model.joblib``) or absent. ``base`` names the base layer; a
    ``jax-tpu`` layer records the JAX build's versions, so the skew check
    runs as it would on a JAX-built bundle."""
    import shutil

    from lambdipy_tpu_torch.bundle import flatpack
    from lambdipy_tpu_torch.bundle.baselayer import base_layer_versions
    from lambdipy_tpu_torch.bundle.format import write_manifest

    bundle.mkdir(parents=True, exist_ok=True)
    info, write_s = {"bytes": 0, "n_tensors": 0}, 0.0
    free = shutil.disk_usage(bundle).free
    if tree is not None:
        (bundle / "params").mkdir(exist_ok=True)
        leaves = []

        def walk(node):
            for v in node.values():
                walk(v) if isinstance(v, dict) else leaves.append(v)

        walk(tree)
        need = sum(t.numel() * t.element_size() for t in leaves)
        log(f"path {label} (a): {free / 2**30:.1f} GiB free in "
            f"{bundle.parent}, the params need {need / 2**30:.2f} GiB")
        if free < need * 1.05:
            raise SystemExit(f"path {label}: not enough disk for the "
                             f"bundle's params")
        t0 = time.perf_counter()
        info = flatpack.save(bundle / "params" / "params.fpk", tree)
        write_s = time.perf_counter() - t0
    if params_info is not None:
        (bundle / "params" / "info.json").write_text(
            json.dumps({"model": spec["model"], **params_info}))
    (bundle / "handler.py").write_text(HANDLER_TEMPLATE.format(
        recipe=spec["recipe"], module="lambdipy_tpu.runtime.handlers",
        attr=attr, spec=spec))
    versions = base_layer_versions(base)
    if base == "jax-tpu":
        versions = {**versions, **JAX_BUILD_VERSIONS}
    payload = dict(spec)
    if params_info is not None:
        payload.update(params="params", params_info=params_info)
    t0 = time.perf_counter()
    write_manifest(
        bundle, artifact_id=spec["recipe"],
        provenance={"recipe": spec["recipe"], "built_at": time.time(),
                    "python": f"{sys.version_info.major}."
                              f"{sys.version_info.minor}",
                    "skipped_optional": []},
        base_layer={"name": base, "versions": versions},
        payload=payload, runtime={"entry": "handler.py"})
    manifest_s = time.perf_counter() - t0
    if tree is not None:
        log(f"path {label} (a): params.fpk {info['bytes']:,} B "
            f"({info['n_tensors']} tensors) written in {write_s:.2f} s "
            f"({info['bytes'] / write_s / 1e9:.2f} GB/s from the card), "
            f"manifest (sha256 of every file) in {manifest_s:.2f} s "
            f"[{card}]")
    return {"bytes": info["bytes"], "n_tensors": info["n_tensors"],
            "write_s": write_s, "manifest_s": manifest_s,
            "free_bytes": free}


def _bundle_requests(vocab: int) -> list:
    rng = torch.Generator().manual_seed(17)
    reqs = []
    for n in BUNDLE_PROMPTS:
        toks = torch.randint(1, vocab, (n,), generator=rng).tolist()
        for knobs in ({}, KNOBS["sampled"]):
            reqs.append({"tokens": toks, "max_new_tokens": BUNDLE_NEW,
                         "logprobs": True, **knobs})
    return reqs


def _until_warm(state, timeout: float = 300.0) -> None:
    t0 = time.perf_counter()
    while state.warming_fn():
        if time.perf_counter() - t0 > timeout:
            raise SystemExit("path K: the background warm never ended")
        time.sleep(0.02)


def boot_in_process(bundle: Path, state_dict: dict, spec: dict,
                    card: str) -> dict:
    """(b): ``load_bundle`` on the card; every tensor equal to the one it
    was written from; 4 prompts greedy and seeded sampled, logprobs on,
    bitwise a handler built from ``state_dict`` directly."""
    from lambdipy_tpu_torch.runtime.handlers import (HandlerContext,
                                                     generate_handler,
                                                     kernel_launches)
    from lambdipy_tpu_torch.runtime.loader import load_bundle

    set_launches_to_zero()  # counters to 0 just before the path
    t0 = time.perf_counter()
    boot = load_bundle(bundle, device="cuda")
    boot_s = time.perf_counter() - t0
    # the warmup released the background warm, whose captures would
    # refuse a device call from this thread: compare after it
    _until_warm(boot.state)
    loaded = boot.state.server.model.state_dict()
    unequal = [k for k, t in state_dict.items()
               if loaded[k].dtype != t.dtype or not torch.equal(loaded[k], t)]
    log(f"path K (b): load_bundle in {boot_s:.2f} s, stages "
        f"{boot.stages}; {len(state_dict) - len(unequal)} of "
        f"{len(state_dict)} tensors torch.equal to the written ones "
        f"[{card}]")
    if unequal or set(loaded) != set(state_dict):
        raise SystemExit(f"path K (b): tensors differ: {unequal[:5]}")
    ref = generate_handler(spec, HandlerContext(device="cuda",
                                                state_dict=state_dict))
    reqs = _bundle_requests(ref.server.model.cfg.vocab_size)
    got = [boot.state.invoke(r) for r in reqs]
    want = [ref.invoke(r) for r in reqs]
    same = [g["tokens"] == w["tokens"] and g["logprobs"] == w["logprobs"]
            for g, w in zip(got, want)]
    log(f"path K (b): {sum(same)} of {len(reqs)} requests (4 prompts x "
        f"greedy / seeded sampled, logprobs on) bitwise the handler built "
        f"from the state_dict")
    if not all(same) or not all(g["ok"] for g in got):
        raise SystemExit("path K (b): the booted bundle's rows differ")
    _until_warm(ref)
    launches = kernel_launches()
    out = {"boot_s": boot_s, "stages": boot.stages,
           "skew": {k: list(v) for k, v in boot.skew.items()},
           "launches": launches, "greedy": got[0]["tokens"],
           "meta": boot.state.meta}
    del boot, ref, loaded
    return out


def _percentile(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(math.ceil(q * len(xs))) - 1)]


def serve_cli(bundle: Path, prompt: list, want: list, run: int,
              card: str) -> dict:
    """(c) and, on the last run, (d): ``python -m lambdipy_tpu_torch serve
    <bundle> --port 0``: spawn to the readiness line, its cold-start
    stages, spawn to ``/healthz`` ready; the boot fields; 30 invokes
    (100 in, 16 out), each bitwise (b)'s; the kernels' counters from
    ``/metrics``; ``POST /profile``; SIGTERM with a request in flight."""
    import os
    import signal

    from lambdipy_tpu_torch.bundle.baselayer import check_skew
    from lambdipy_tpu_torch.bundle.format import load_manifest

    base = load_manifest(bundle)["base_layer"]
    skew = {k: list(v) for k, v in
            check_skew(base["versions"], base["name"]).items()}
    err_path = OUT_DIR / f"path_k_cli_{run}.log"
    OUT_DIR.mkdir(exist_ok=True)
    with open(err_path, "w") as err:
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "lambdipy_tpu_torch", "serve",
             str(bundle), "--port", "0"],
            stdout=subprocess.PIPE, stderr=err, text=True,
            env={**os.environ, "LAMBDIPY_LOG_LEVEL": "WARNING"})
    try:
        line = proc.stdout.readline()
        spawn_s = time.perf_counter() - t0
        if not line:
            proc.wait(timeout=60)
            raise SystemExit(f"path K (c): no readiness line, exit "
                             f"{proc.returncode}: "
                             f"{err_path.read_text()[-3000:]}")
        ready = json.loads(line)
        url = f"http://127.0.0.1:{ready['port']}"
        ready_s = spawn_s + _until_ready(url)
        log(f"path K (c) run {run}: spawn to readiness line {spawn_s:.3f} s "
            f"(target < 10 s), cold_start {ready['cold_start']}; spawn to "
            f"/healthz ready (the background warm done) {ready_s:.3f} s "
            f"[{card}]")
        health = http_json(url + "/healthz")
        meta = health["handler_meta"]
        checks = {
            "pid": health["pid"] == proc.pid,
            "bundle": health["bundle"] == str(bundle),
            "stages": list(health["cold_start"]) == [
                "manifest", "syspath", "compile_cache", "handler_import",
                "init", "warmup", "total"],
            # the host's own check on the manifest's record: whatever
            # of the jax-tpu layer this host lacks reads <absent>
            "skew": health["skew"] == skew and all(
                live == "<absent>" or live != want
                for want, live in skew.values()),
            "handler_meta": meta["kv_paged"] and meta["model"] == "llama3-8b",
            # a bundle naming no tokenizer serves token ids
            "tokenizer": meta["tokenizer"] is False
            and "tokenizer_error" not in meta,
            "debug_flags": health["debug_flags"] == {},
            "warm": health["warm"] is None}
        log(f"path K (c) run {run}: /healthz skew {health['skew']}, checks "
            f"{checks}")
        if not all(checks.values()):
            raise SystemExit(f"path K (c): /healthz boot fields: {health}")
        walls, same = [], 0
        for _ in range(BUNDLE_INVOKES):
            t1 = time.perf_counter()
            out = http_json(url + "/invoke", {"tokens": prompt,
                                              "max_new_tokens": BUNDLE_NEW})
            walls.append(time.perf_counter() - t1)
            same += out["tokens"] == want
        p50, p99 = _percentile(walls, 0.5), _percentile(walls, 0.99)
        log(f"path K (c) run {run}: {BUNDLE_INVOKES} invokes (100 in, 16 "
            f"out): p50 {p50 * 1e3:.1f} ms, p99 {p99 * 1e3:.1f} ms, "
            f"{same} bitwise (b)'s [{card}]")
        if same != BUNDLE_INVOKES:
            raise SystemExit("path K (c): the CLI's tokens differ from (b)'s")
        profile = None
        if run == BUNDLE_RUNS:
            profile = http_json(url + "/profile", {"invokes": 3})
            if not profile["ok"] or "trace.json" not in profile["files"]:
                raise SystemExit(f"path K (d): no trace: {profile}")
            events = json.loads((Path(profile["dir"]) / "trace.json")
                                .read_text())["traceEvents"]
            profile["kernel_events"] = sum(e.get("cat") == "kernel"
                                           for e in events)
            log(f"path K (d): /profile ok {profile['ok']}, "
                f"{len(profile['files'])} files: {profile['files']}; "
                f"{len(events)} trace events, {profile['kernel_events']} of "
                f"them device kernels")
        launches = http_json(url + "/metrics")["handler"]["kernels"]
        log(f"path K (c) run {run}: kernel launches in the process "
            f"(boot, warm, invokes{', profile' if profile else ''}): "
            f"{launches}")
        if not (launches["int8_matmul"]
                and launches["paged_decode_attention"]):
            raise SystemExit("path K (c): the process ran no kernel")
        # SIGTERM with a request in flight (its first chunk read): the
        # request finishes 200, then the process exits 0
        req = urllib.request.Request(
            url + "/invoke", headers={"Content-Type": "application/json"},
            data=json.dumps({"tokens": prompt, "max_new_tokens": 64,
                             "stream": True}).encode())
        with urllib.request.urlopen(req, timeout=300) as resp:
            first = json.loads(resp.readline())
            t1 = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            rest = [json.loads(x) for x in resp.read().splitlines() if x]
            status = resp.status
        code = proc.wait(timeout=120)
        exit_s = time.perf_counter() - t1
        drained = (status == 200 and first["ok"] and rest[-1].get("done")
                   and rest[-1]["n_new"] == 64 and code == 0)
        log(f"path K (c) run {run}: SIGTERM in flight: the request "
            f"{status} with {rest[-1].get('n_new')} tokens, exit {code} "
            f"{exit_s:.2f} s after the signal")
        if not drained:
            raise SystemExit(f"path K (c): drain on SIGTERM failed (exit "
                             f"{code}): {err_path.read_text()[-3000:]}")
        return {"spawn_to_ready_s": spawn_s, "spawn_to_healthz_ready_s":
                ready_s, "cold_start": ready["cold_start"],
                "invoke_ms": [w * 1e3 for w in walls], "p50_ms": p50 * 1e3,
                "p99_ms": p99 * 1e3, "launches": launches,
                "profile": profile, "sigterm_exit_s": exit_s}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)


def import_walls(card: str) -> dict:
    """What a CLI process spends before its first boot stage: the wall of
    a fresh interpreter that imports torch, and one that also imports the
    CLI's server module (the port's modules)."""
    out = {}
    for name, code in (("python", "pass"), ("torch", "import torch"),
                       ("server", "import torch, "
                                  "lambdipy_tpu_torch.runtime.server")):
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-c", code], check=True,
                       timeout=300)
        out[name] = time.perf_counter() - t0
    log(f"path K (c): a fresh interpreter {out['python']:.3f} s, importing "
        f"torch {out['torch']:.3f} s, torch and the port's server module "
        f"{out['server']:.3f} s [{card}]")
    return out


def serve_bundle_path(card: str) -> dict:
    """Path K: llama3-8b (int8 weights, bf16, D's paged engine, the warm
    on) booted from a bundle the port wrote: (a) the bundle, (b) in
    process, (c) as a CLI process, (d) ``/profile``."""
    import shutil
    import tempfile

    from lambdipy_tpu_torch.models import registry
    from lambdipy_tpu_torch.models.params import to_flax_tree

    spec = {"model": "llama3-8b", "dtype": "bfloat16", "quant": "int8",
            "extra": dict(BUNDLE_EXTRA)}
    adapter = registry.get("llama3-8b").build(
        dtype="bfloat16", quant="int8", extra=spec["extra"])
    bundle = Path(tempfile.mkdtemp(prefix="lambdipy-bundle-")) / "bundle"
    try:
        state_dict = adapter.init_params(seed=0, device="cuda")
        n_params = sum(t.numel() for t in state_dict.values())
        made = write_bundle(
            bundle, {"recipe": "chip-smoke-llama3-8b", **spec,
                     "params": "init", "batch_size": 1, "mesh": {},
                     "device": "any"},
            "generate_handler", card,
            tree=to_flax_tree(adapter.config, state_dict),
            params_info={"format": "fpk", "n_params": n_params, "seed": 0,
                         "serving_cast": {"applied": False,
                                          "reason": "written by the port"}})
        inproc = boot_in_process(bundle, state_dict, spec, card)
        del state_dict
        gc.collect()
        torch.cuda.empty_cache()
        prompt = _bundle_requests(adapter.config.vocab_size)[0]["tokens"]
        imports = import_walls(card)
        runs = [serve_cli(bundle, prompt, inproc["greedy"], run, card)
                for run in range(1, BUNDLE_RUNS + 1)]
    finally:
        shutil.rmtree(bundle.parent, ignore_errors=True)
    launches = {k: inproc["launches"][k] + sum(r["launches"][k] for r in runs)
                for k in KERNELS}
    return {"bundle": made, "in_process": inproc, "import_walls": imports,
            "cli": runs, "launches": launches}


# path L: the BASELINE's configs 1-4 served from bundles the port writes
# without JAX: hello (numpy, scipy), tabular (sklearn), ResNet-50 image
# classification and BERT-base text classification (bf16, the handlers'
# forward a CUDA graph), and the torch BERT-base (f32, eager)
L_BUNDLES = {  # name: (handler, dtype, base layer)
    "resnet50": ("image_classify_handler", "bfloat16", "jax-tpu"),
    "bert-base": ("text_classify_handler", "bfloat16", "jax-tpu"),
    "bert-base-torch": ("torch_text_classify_handler", "float32", "torch"),
    "hello": ("hello_handler", "float32", "none"),
    "tabular": ("tabular_handler", "float32", "none"),
}
L_INVOKES = {"resnet50": 50, "bert-base": 30}  # BASELINE.json's counts
L_P50_TARGET_MS = 15.0   # BASELINE.json's p50 target (set on a TPU)
L_COLD_TARGET_S = 10.0   # and its cold-start target
L_IMAGE = 224
L_TOKENS = 128
# bounds on max |card - CPU| / max |CPU| of the logits: the card's forward
# against the port's CPU forward of the same weights in f32. bf16: the
# card rounds every activation to bf16 (one ulp is 2^-8 of a value), the
# CPU reference does not. A random BERT's two logits are small beside its
# hidden state, so the noise its last hidden state carries is a larger
# share of them; that state is held too (L_HIDDEN_BOUND). Measured on an
# H100 (NVIDIA H100 80GB HBM3, 700 W): ResNet-50 2.3e-3, BERT-base 0.13
# (its last hidden state 1.4e-2), the torch BERT (f32: the card's fused
# attention and summation order) 4.3e-4
L_CPU_BOUND = {"resnet50": 1e-2, "bert-base": 0.3, "bert-base-torch": 5e-3}
L_HIDDEN_BOUND = 0.05  # BERT-base's last hidden state, the same measure


def _perturb_norms(state_dict: dict, seed: int) -> None:
    """Seeded batch-norm statistics, scales and biases, LayerNorm scales
    and dense biases in place of the init's constants: a random ResNet's
    ``bn3`` scales start at 0, which zeroes every residual branch."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for key, t in state_dict.items():
        leaf = key.rsplit(".", 1)[-1]
        if t.dim() != 1 or leaf not in ("scale", "bias", "mean", "var"):
            continue
        r = torch.rand(t.shape, generator=gen, device=t.device)
        n = torch.randn(t.shape, generator=gen, device=t.device)
        val = {"scale": (0.3 * n if key.endswith("bn3.scale")
                         else 0.5 + r),
               "bias": 0.1 * n, "mean": 0.1 * n, "var": 0.5 + r}[leaf]
        t.copy_(val.to(t.dtype))


def _classify_bodies(name: str) -> dict:
    """(the random body, a real one): a 224 x 224 x 3 image as JSON lists
    (3 decimals) or 128 token ids, made from a seed."""
    rng = np.random.default_rng(18)
    if name == "resnet50":
        real = {"image": np.round(rng.uniform(
            0, 1, (L_IMAGE, L_IMAGE, 3)), 3).tolist()}
    else:
        real = {"input_ids": rng.integers(1, 30522, L_TOKENS).tolist()}
    return {"random": {"random": True}, "real": real}


def _logits(name: str, out: dict) -> np.ndarray:
    """What an answer says of the logits: ResNet's top-5 and max, BERT's
    logits."""
    if name == "resnet50":
        return np.asarray(out["top5"][0] + [out["logit_max"]])
    return np.asarray(out["logits"])


def forward_bound(model, inputs) -> dict:
    """One forward's bound: the bytes it must move (weights, inputs and
    output, each once; of an embedding table, the rows the ids gather)
    over 3.35 TB/s against its matmul and convolution operations (counted
    by ``torch.utils.flop_counter`` on this forward) over 989 bf16
    TFLOP/s."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter, torch.no_grad():
        out = model(*inputs)
    nbytes = sum(t.numel() * t.element_size()
                 for t in [*model.state_dict().values(), *inputs, out])
    # an embedding table is read only at the rows this run's ids gather
    rows = inputs[0].numel()
    for mod in model.modules():
        table = getattr(mod, "embedding", None)
        if isinstance(table, torch.Tensor) and table.dim() == 2:
            nbytes -= max(0, table.shape[0] - rows) * table.shape[1] * \
                table.element_size()
    ms, by = bound(nbytes, counter.get_total_flops())
    return {"bytes": nbytes, "flops": counter.get_total_flops(),
            "bound_ms": ms, "bound_by": by}


def _rel_err(out, ref) -> float:
    out, ref = out.float(), ref.float()
    return ((out - ref).abs().max() / ref.abs().max()).item()


def check_classify_boot(name: str, bundle: Path, state_dict: dict,
                        card: str) -> dict:
    """(b) for ResNet-50, BERT-base and the torch BERT: ``load_bundle`` on
    the card; every tensor equal to the one written; the graph replay (a
    real input and the random body) bitwise the eager card forward; the
    card's logits against the port's CPU forward of the same weights in
    f32, within ``L_CPU_BOUND`` and with the top-1 equal (BERT-base's last
    hidden state within ``L_HIDDEN_BOUND``); one forward's
    device time replayed and eager (``device_time``), against its bound."""
    from lambdipy_tpu_torch.models import registry
    from lambdipy_tpu_torch.models.graphs import DEVICE_LOCK
    from lambdipy_tpu_torch.runtime.handlers import _pad_ids
    from lambdipy_tpu_torch.runtime.loader import load_bundle

    t0 = time.perf_counter()
    boot = load_bundle(bundle, device="cuda")
    boot_s = time.perf_counter() - t0
    program = boot.state.forward
    model = program.model
    loaded = model.state_dict()
    unequal = [k for k, t in state_dict.items()
               if loaded[k].dtype != t.dtype or not torch.equal(loaded[k], t)]
    log(f"path L (b) {name}: load_bundle in {boot_s:.2f} s, stages "
        f"{boot.stages}; {len(state_dict) - len(unequal)} of "
        f"{len(state_dict)} tensors torch.equal to the written ones, "
        f"forward {program.mode} [{card}]")
    if unequal or set(loaded) != set(state_dict):
        raise SystemExit(f"path L (b) {name}: tensors differ: {unequal[:5]}")
    real = _classify_bodies(name)["real"]
    if name == "resnet50":
        x = torch.tensor(real["image"], dtype=torch.float32)[None]
        inputs = (x,)
    else:
        inputs = _pad_ids({"input_ids": real["input_ids"]},
                          model.cfg.max_len if name == "bert-base"
                          else model.max_len)
    dev_inputs = [a.to(t.device, t.dtype)
                  for a, t in zip(inputs, program.inputs)]
    got = program(*inputs)
    with torch.no_grad():
        eager = model(*dev_inputs).cpu()
        eager_random = model(*program.example).cpu()
    graph_ok = torch.equal(got, eager) and torch.equal(
        program(*program.example), eager_random)
    # the same widths in f32 on the CPU, the same weights (bf16 ones are
    # exact in f32)
    cpu = registry.get(name).build(dtype="float32").make_model(
        {k: v.float().cpu() for k, v in loaded.items()}, device="cpu")
    with torch.no_grad():
        ref = cpu(*inputs).float()
        hidden_err = (_rel_err(model.encoder(*dev_inputs).cpu(),
                               cpu.encoder(*inputs))
                      if name == "bert-base" else 0.0)
    err = _rel_err(got, ref)
    top1 = bool((got.argmax(-1) == ref.argmax(-1)).all())
    out = {"boot_s": boot_s, "stages": boot.stages, "mode": program.mode,
           "graph_bitwise_eager": graph_ok, "cpu_f32_rel_err": err,
           "cpu_f32_hidden_rel_err": hidden_err, "cpu_top1_equal": top1,
           "meta": boot.state.meta}
    log(f"path L (b) {name}: {program.mode} forward bitwise the eager "
        f"card forward (a real input and the random body): {graph_ok}; "
        f"against the CPU f32 forward of the same weights: max |diff| / "
        f"max |ref| {err:.3e} (bound {L_CPU_BOUND[name]})"
        + (f", last hidden state {hidden_err:.3e} (bound "
           f"{L_HIDDEN_BOUND})" if name == "bert-base" else "")
        + f", top-1 equal {top1}")
    if not graph_ok or err > L_CPU_BOUND[name] or not top1 \
            or hidden_err > L_HIDDEN_BOUND:
        raise SystemExit(f"path L (b) {name}: the card's forward failed "
                         f"its checks: {out}")
    if program.uses_graph:
        with DEVICE_LOCK:
            out["replay_ms"] = device_time(lambda i: program.run())
        with torch.no_grad():
            out["eager_ms"] = device_time(lambda i: model(*dev_inputs),
                                          calls=1)
        out.update(forward_bound(model, dev_inputs))
        log(f"path L (b) {name}: one forward's device time, replayed "
            f"{out['replay_ms']:.4f} ms, eager {out['eager_ms']:.4f} ms; "
            f"bound {out['bound_ms']:.4f} ms ({out['bound_by']}: "
            f"{out['bytes']:,} B, {out['flops']:,} flop) [{card}]")
    out["answers"] = {kind: boot.state.invoke(body) for kind, body in
                      _classify_bodies(name).items()}
    del boot, program, model, cpu
    return out


def serve_classify_cli(name: str, bundle: Path, want: dict,
                       card: str) -> dict:
    """(c): ``python -m lambdipy_tpu_torch serve <bundle> --port 0``:
    spawn to the readiness line, its cold-start stages, spawn to
    ``/healthz`` ready; ``L_INVOKES`` sequential invokes of the random body
    and of the real one (p50, p99), each answer (b)'s; the kernels'
    counters and the forward's from ``/metrics``; SIGTERM, exit 0."""
    import os
    import signal

    err_path = OUT_DIR / f"path_l_cli_{name}.log"
    OUT_DIR.mkdir(exist_ok=True)
    with open(err_path, "w") as err:
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "lambdipy_tpu_torch", "serve",
             str(bundle), "--port", "0"],
            stdout=subprocess.PIPE, stderr=err, text=True,
            env={**os.environ, "LAMBDIPY_LOG_LEVEL": "WARNING"})
    try:
        line = proc.stdout.readline()
        spawn_s = time.perf_counter() - t0
        if not line:
            proc.wait(timeout=60)
            raise SystemExit(f"path L (c) {name}: no readiness line, exit "
                             f"{proc.returncode}: "
                             f"{err_path.read_text()[-3000:]}")
        ready = json.loads(line)
        url = f"http://127.0.0.1:{ready['port']}"
        ready_s = spawn_s + _until_ready(url)
        health = http_json(url + "/healthz")
        meta = health["handler_meta"]
        stages = ready["cold_start"]
        log(f"path L (c) {name}: spawn to readiness line {spawn_s:.3f} s "
            f"(target < {L_COLD_TARGET_S:.0f} s: "
            f"{'met' if spawn_s < L_COLD_TARGET_S else 'not met'}), "
            f"cold_start {stages}; spawn to /healthz ready {ready_s:.3f} "
            f"s; handler_meta {meta} [{card}]")
        if meta.get("aot") != "graph" or list(stages) != [
                "manifest", "syspath", "compile_cache", "handler_import",
                "init", "warmup", "total"]:
            raise SystemExit(f"path L (c) {name}: /healthz: {health}")
        out = {"spawn_to_ready_s": spawn_s, "spawn_to_healthz_ready_s":
               ready_s, "cold_start": stages, "meta": meta}
        for kind, body in _classify_bodies(name).items():
            data = json.dumps(body).encode()
            walls, same, bitwise = [], 0, 0
            for _ in range(L_INVOKES[name]):
                t1 = time.perf_counter()
                status, raw, _ = _post_raw(
                    url + "/invoke", data,
                    {"Content-Type": "application/json"})
                walls.append(time.perf_counter() - t1)
                got = json.loads(raw)
                if status != 200 or not got["ok"]:
                    raise SystemExit(f"path L (c) {name}: {status} {got}")
                ref = want[kind]
                key = "top5" if name == "resnet50" else "labels"
                same += got[key] == ref[key]
                bitwise += bool(np.array_equal(_logits(name, got),
                                               _logits(name, ref)))
            p50, p99 = _percentile(walls, 0.5), _percentile(walls, 0.99)
            log(f"path L (c) {name}: {L_INVOKES[name]} invokes of the "
                f"{kind} body ({len(data):,} B): p50 {p50 * 1e3:.2f} ms "
                f"(target < {L_P50_TARGET_MS:.0f} ms: "
                f"{'met' if p50 * 1e3 < L_P50_TARGET_MS else 'not met'}), "
                f"p99 {p99 * 1e3:.2f} ms; {same} with (b)'s "
                f"{'top-5' if name == 'resnet50' else 'labels'}, {bitwise} "
                f"bitwise (b)'s [{card}]")
            if same != L_INVOKES[name]:
                raise SystemExit(f"path L (c) {name}: answers differ from "
                                 f"(b)'s")
            out[kind] = {"body_bytes": len(data), "p50_ms": p50 * 1e3,
                         "p99_ms": p99 * 1e3, "bitwise": bitwise,
                         "invoke_ms": [w * 1e3 for w in walls]}
        handler = http_json(url + "/metrics")["handler"]
        out["launches"], out["forward"] = handler["kernels"], \
            handler["forward"]
        log(f"path L (c) {name}: /metrics forward {handler['forward']}, "
            f"kernel launches {handler['kernels']}")
        if handler["forward"]["replays"] < 2 * L_INVOKES[name] or \
                handler["forward"]["eager_runs"]:
            raise SystemExit(f"path L (c) {name}: not every invoke replayed "
                             f"the forward: {handler['forward']}")
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=120)
        if code != 0:
            raise SystemExit(f"path L (c) {name}: exit {code} on SIGTERM: "
                             f"{err_path.read_text()[-3000:]}")
        return out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)


def serve_classify_path(card: str) -> dict:
    """Path L: (a) a ``resnet50``, a ``bert-base``, a ``bert-base-torch``
    (``model.pt``), a ``hello`` and, where sklearn and joblib import, a
    ``tabular`` bundle written without JAX at the recipes' widths; (b)
    each booted in process on the card (``check_classify_boot``; hello and
    tabular against their handler and estimator); (c) ResNet-50 and
    BERT-base as CLI processes (``serve_classify_cli``). The kernels'
    counters must read 0: no TPU kernel is on this path."""
    import importlib.util
    import shutil
    import tempfile

    from lambdipy_tpu_torch.models import registry
    from lambdipy_tpu_torch.models.params import to_flax_tree
    from lambdipy_tpu_torch.runtime.handlers import (HandlerContext,
                                                     hello_handler,
                                                     kernel_launches)
    from lambdipy_tpu_torch.runtime.loader import load_bundle

    set_launches_to_zero()  # counters to 0 just before the path
    has_sklearn = all(importlib.util.find_spec(m) is not None
                      for m in ("sklearn", "joblib"))
    log(f"path L: sklearn and joblib "
        f"{'import' if has_sklearn else 'do not import'} on this host: the "
        f"tabular bundle {'runs' if has_sklearn else 'is left out'}")
    root = Path(tempfile.mkdtemp(prefix="lambdipy-classify-"))
    out: dict = {"tabular_ran": has_sklearn}
    try:
        written = {}
        for name, (attr, dtype, base) in L_BUNDLES.items():
            if name == "tabular" and not has_sklearn:
                continue
            bundle = root / name
            spec = {"recipe": f"chip-smoke-{name}", "model": name,
                    "params": "none" if name == "hello" else "init",
                    "dtype": dtype, "batch_size": 1,
                    "mesh": {"dp": 1, "tp": 1} if base == "jax-tpu" else {},
                    "quant": None, "extra": {}, "device": "any"}
            adapter = (None if name == "hello"
                       else registry.get(name).build(dtype=dtype))
            tree, info = None, None
            if name in ("resnet50", "bert-base"):
                sd = adapter.init_params(seed=0, device="cuda")
                _perturb_norms(sd, seed=18)
                tree = to_flax_tree(adapter.config, sd)
                info = {"format": "fpk", "seed": 0,
                        "n_params": sum(t.numel() for t in sd.values()),
                        "serving_cast": {"applied": False,
                                         "reason": "written by the port"}}
            elif name == "bert-base-torch":
                sd = adapter.init_params(seed=0, device="cuda")
                (bundle / "params").mkdir(parents=True)
                torch.save({k: v.cpu() for k, v in sd.items()},
                           bundle / "params" / "model.pt")
                info = {"format": "torch",
                        "n_params": sum(t.numel() for t in sd.values())}
            elif name == "tabular":
                import joblib

                sd = adapter.init_params(seed=0)
                (bundle / "params").mkdir(parents=True)
                joblib.dump(sd, bundle / "params" / "model.joblib")
                info = {"format": "joblib",
                        "n_features": adapter.config.n_features}
            else:
                sd = None
            made = write_bundle(bundle, spec, attr, card, tree=tree,
                                params_info=info, base=base, label="L")
            nbytes = sum(f.stat().st_size for f in bundle.rglob("*")
                         if f.is_file())
            log(f"path L (a) {name}: {nbytes:,} B in the bundle, manifest "
                f"in {made['manifest_s']:.2f} s")
            written[name] = (bundle, sd, spec)
        for name in ("resnet50", "bert-base", "bert-base-torch"):
            bundle, sd, _ = written[name]
            out[name] = check_classify_boot(name, bundle, sd, card)
        boot = load_bundle(written["hello"][0], device="cuda")
        req = {"n": 64, "seed": 3}
        want = hello_handler({}, HandlerContext(device="cuda")).invoke(req)
        got = boot.state.invoke(req)
        same = _without_latency(got) == _without_latency(want)
        log(f"path L (b) hello: stages {boot.stages}, the answer equal to "
            f"a handler built directly: {same}")
        if not same or not got["ok"]:
            raise SystemExit(f"path L (b) hello: {got} != {want}")
        out["hello"] = {"stages": boot.stages, "answer": got}
        if has_sklearn:
            bundle, clf, _ = written["tabular"]
            boot = load_bundle(bundle, device="cuda")
            rows = np.random.default_rng(2).normal(size=(4, 16))
            got = boot.state.invoke({"instances": rows.tolist()})
            same = got["probabilities"] == clf.predict_proba(rows).tolist()
            log(f"path L (b) tabular: stages {boot.stages}, probabilities "
                f"equal to the fitted estimator's: {same}")
            if not same:
                raise SystemExit("path L (b) tabular: answers differ")
            out["tabular"] = {"stages": boot.stages}
        launches = kernel_launches()
        for name in L_INVOKES:
            out[name]["cli"] = serve_classify_cli(
                name, written[name][0], out[name].pop("answers"), card)
            for k, v in out[name]["cli"]["launches"].items():
                launches[k] += v
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["launches"] = {k: launches[k] for k in KERNELS}
    log(f"path L: kernel launches in process and in the CLI processes "
        f"{out['launches']}")
    if any(out["launches"].values()):
        raise SystemExit("path L: a TPU kernel's twin was launched")
    return out


# path M: the bundle lifecycle through the port's CLI, each command a
# process of its own under a fresh HOME: recipes, build (registry, cache
# hit, prebuilt fetch, --out), deploy under the watchdog, bench, invoke,
# a killed server respawned, publish / releases to a protected store,
# llama3-8b built and served at full width, doctor, stop, package. The
# host-only phases run in a thread beside a card build (hello's build
# beside the card recipes'; publish, a second pack and package beside
# the llama's), so they add little wall time; every phase that times a
# deploy, an invoke or a respawn runs alone
M_TWINS = ("certifi", "hello-numpy", "jax-bert", "jax-llama-micro",
           "jax-llama3-8b", "jax-resnet50", "numpy", "numpy-src",
           "tabular-sklearn", "torch-xla-bert")
# BASELINE.json's invoke counts (configs 1, 3 and 4) and bodies
M_BENCH = {"hello-numpy": 20, "jax-resnet50": 50, "jax-bert": 30}
M_BODY = {"hello-numpy": {"n": 64, "seed": 3},
          "jax-resnet50": {"random": True}, "jax-bert": {"random": True}}
M_MODEL = {"jax-resnet50": "resnet50", "jax-bert": "bert-base"}
M_LLAMA_INVOKES = 30
M_FREE_SLACK = 1 << 30  # the card's free memory after M, against before


class Cli:
    """``python -m lambdipy_tpu_torch <args>`` as a process, from the
    checkout's root, under ``home`` (the registry, the deployments, the
    asset and source caches start empty) and a kernel build cache of its
    own (empty too: the first boot on the card builds the kernels)."""

    def __init__(self, root: Path):
        import os

        self.root = root
        self.env = {**os.environ, "HOME": str(root / "home"),
                    "LAMBDIPY_KERNEL_CACHE": str(root / "kernels"),
                    "PYTHONPATH": str(Path(__file__).resolve().parent),
                    "LAMBDIPY_LOG_LEVEL": "WARNING"}
        self.env.pop("LAMBDIPY_RELEASE_STORE", None)
        self.env.pop("LAMBDIPY_RELEASE_TOKEN", None)
        (root / "home").mkdir(parents=True)

    def __call__(self, *args, ok: bool = True, env: dict | None = None,
                 timeout: float = 900.0) -> dict:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "lambdipy_tpu_torch", *map(str, args)],
            capture_output=True, text=True, timeout=timeout,
            env={**self.env, **(env or {})},
            cwd=Path(__file__).resolve().parent)
        out = {"rc": proc.returncode, "stdout": proc.stdout,
               "stderr": proc.stderr, "wall_s": time.perf_counter() - t0}
        if ok and proc.returncode != 0:
            raise SystemExit(f"path M: `{' '.join(map(str, args))}` exited "
                             f"{proc.returncode}:\n{proc.stdout[-2000:]}\n"
                             f"{proc.stderr[-3000:]}")
        if not ok and proc.returncode == 0:
            raise SystemExit(f"path M: `{' '.join(map(str, args))}` "
                             f"should have failed:\n{proc.stdout[-2000:]}")
        return out

    def json(self, *args, **kw):
        """The command's stdout, one JSON document."""
        return json.loads(self(*args, **kw)["stdout"])

    def registry_bundle(self, recipe: str) -> Path:
        from lambdipy_tpu_torch.recipes import builtin_store

        aid = builtin_store().get(recipe).artifact_id(
            f"{sys.version_info.major}.{sys.version_info.minor}")
        return (self.root / "home" / ".lambdipy-tpu-torch" / "registry"
                / "artifacts" / aid / "bundle")


def _build_record(cli: Cli, recipe: str, bundle: Path, wall: float,
                  card: str, beside: str = "") -> dict:
    """(c): a build's wall time, its stages, the bundle's bytes, the prune
    savings and the warm record, from the manifest."""
    from lambdipy_tpu_torch.bundle.format import load_manifest
    from lambdipy_tpu_torch.utils.fsutil import dir_size

    m = load_manifest(bundle)
    prov = m["provenance"]
    rec = {"wall_s": wall, "stages": prov["timings"],
           "bytes": dir_size(bundle), "prune": prov["prune"],
           "vendored": [v["name"] for v in prov["vendored"]],
           "base_provided": [v["name"] for v in prov["base_provided"]],
           "warm": m.get("warm")}
    log(f"path M (c) build {recipe}: {wall:.2f} s{beside}, stages "
        f"{prov['timings']}, "
        f"{rec['bytes']:,} B in the bundle, prune saved "
        f"{prov['prune']['bytes_saved']:,} B of {prov['prune']['bytes_before']:,}"
        f", vendored {rec['vendored']}, base layer {rec['base_provided']}; "
        f"warm {rec['warm']} [{card}]")
    if not (rec["warm"] or {}).get("ok"):
        raise SystemExit(f"path M (c): {recipe}'s warm failed: {rec['warm']}")
    return rec


def _answers_equal(recipe: str, got: dict, want: dict) -> tuple:
    """(top-1 equal, bitwise): ResNet's top-5 and largest logit, BERT's
    labels and logits; hello's whole answer (each without its
    ``latency_ms``)."""
    got, want = _without_latency(got), _without_latency(want)
    if recipe == "jax-resnet50":
        return got["top1"] == want["top1"], got == want
    if recipe == "jax-bert":
        return got["labels"] == want["labels"], got == want
    return got == want, got == want


def _deploy_checks(cli: Cli, recipe: str, dep: dict, card: str) -> dict:
    """(d): ``dep``, the recipe deployed by name under the watchdog (its
    wall and readiness stages); ``bench`` at BASELINE.json's count; the
    deployment's answers against an in-process boot of the same bundle on
    the card, top-1 and bitwise (the same program on the same card: the
    graph of the forward, or the host's numpy)."""
    from lambdipy_tpu_torch.runtime.loader import load_bundle

    ready = json.loads(dep["stdout"].strip().splitlines()[-1])
    log(f"path M (d) deploy {recipe}: deploy_wall_s {dep['wall_s']:.3f} "
        f"(target < 10 s; {len(M_BENCH)} deploys at once), cold_start "
        f"{ready['cold_start']} [{card}]")
    bench = cli.json("bench", recipe, "-n", M_BENCH[recipe], "--data",
                     json.dumps(M_BODY[recipe]))
    log(f"path M (d) bench {recipe}: {bench} [{card}]")
    bodies = ({"body": M_BODY[recipe]} if recipe == "hello-numpy"
              else _classify_bodies(M_MODEL[recipe]))
    boot = load_bundle(cli.registry_bundle(recipe), device="cuda")
    checks = {}
    for kind, body in bodies.items():
        want = boot.state.invoke(body)
        got = http_json(ready["url"] + "/invoke", body)
        checks[kind] = _answers_equal(recipe, got, want)
    log(f"path M (d) {recipe}: (top-1 equal, bitwise) against an in-process "
        f"boot of the same bundle: {checks}")
    if not all(top and bits for top, bits in checks.values()):
        raise SystemExit(f"path M (d) {recipe}: answers differ: {checks}")
    answers = {kind: _without_latency(http_json(ready["url"] + "/invoke",
                                                body))
               for kind, body in bodies.items()}
    del boot
    return {"deploy_wall_s": dep["wall_s"], "url": ready["url"],
            "cold_start": ready["cold_start"], "bench": bench,
            "checks": checks, "answers": answers, "bodies": bodies}


def _watchdog(cli: Cli, dep: dict, card: str) -> dict:
    """(e): SIGKILL the ResNet deployment's server; the supervisor
    respawns it on the same port; the time from the kill to ``/healthz``
    ready under a new pid; the next invoke answers bitwise as before."""
    import os
    import signal

    url = dep["url"]
    old = http_json(url + "/healthz")["pid"]
    t0 = time.perf_counter()
    os.kill(old, signal.SIGKILL)
    while True:
        try:
            health = http_json(url + "/healthz", timeout=5)
            if health["pid"] != old and health["ready"]:
                break
        except OSError:
            pass
        if time.perf_counter() - t0 > 180:
            raise SystemExit("path M (e): the server was not respawned")
        time.sleep(0.05)
    recovery = time.perf_counter() - t0
    same = {kind: _without_latency(http_json(url + "/invoke", body))
            == dep["answers"][kind] for kind, body in dep["bodies"].items()}
    log(f"path M (e) watchdog: server {old} SIGKILLed, respawned as "
        f"{health['pid']} on the same port, /healthz ready after "
        f"{recovery:.3f} s; answers bitwise as before: {same} [{card}]")
    if not all(same.values()):
        raise SystemExit(f"path M (e): answers after the respawn differ")
    return {"recovery_s": recovery, "old_pid": old, "new_pid": health["pid"],
            "same": same}


def _publish(cli: Cli, say) -> dict:
    """(f), host side: publish hello-numpy and jax-resnet50 to a protected
    store (a publish without the token fails), ``releases`` lists both, a
    second pack of the bundle gives the asset's bytes. ``say`` takes the
    log lines (this runs in a thread, beside the llama build)."""
    from lambdipy_tpu_torch.resolve.releases import ReleaseStore, pack_bundle
    from lambdipy_tpu_torch.utils.fsutil import hash_file

    store = ReleaseStore.create(cli.root / "releases", protected=True)
    denied = cli("publish", "jax-resnet50", "--release-store", store.root,
                 ok=False)
    if "protected" not in denied["stderr"]:
        raise SystemExit(f"path M (f): {denied['stderr']}")
    token = {"LAMBDIPY_RELEASE_TOKEN": "chip-smoke"}
    pub = cli("publish", "hello-numpy", "jax-resnet50", "--release-store",
              store.root, env=token)
    listed = cli("releases", "--release-store", store.root)["stdout"]
    say(f"path M (f) publish without the token: exit {denied['rc']} "
        f"({denied['stderr'].strip().splitlines()[-1]}); with it "
        f"{pub['wall_s']:.2f} s (beside the llama build):\n"
        f"{pub['stdout'].strip()}\nreleases:\n{listed.strip()}")
    assets = {a.recipe: a for a in store.list_assets()}
    if set(assets) != {"hello-numpy", "jax-resnet50"} or \
            not all(a.artifact_id in listed for a in assets.values()):
        raise SystemExit(f"path M (f): the store lists {sorted(assets)}")
    asset = assets["jax-resnet50"]
    t0 = time.perf_counter()
    again = pack_bundle(cli.registry_bundle("jax-resnet50"),
                        cli.root / "again.tar.gz")
    pack_s = time.perf_counter() - t0
    same_bytes = hash_file(again) == asset.hash
    say(f"path M (f) a second pack of jax-resnet50's bundle: {pack_s:.2f} s, "
        f"{again.stat().st_size:,} B, the asset's bytes: {same_bytes}")
    if not same_bytes:
        raise SystemExit("path M (f): two packs of one bundle differ")
    again.unlink()
    return {"store": store.root, "publish_s": pub["wall_s"],
            "pack_s": pack_s, "asset_bytes": asset.size}


def _prebuilt(cli: Cli, rel: dict, deps: dict, card: str) -> dict:
    """(f), card side: against a fresh registry, ``build jax-resnet50``
    fetches the prebuilt without building, and ``deploy`` serves it, its
    answers bitwise the built one's."""
    fresh = cli.root / "fresh-registry"
    fetched = cli("build", "jax-resnet50", "--registry", fresh,
                  "--release-store", rel["store"])
    if "fetched prebuilt" not in fetched["stdout"] or \
            "built" in fetched["stdout"].replace("fetched prebuilt", ""):
        raise SystemExit(f"path M (f): {fetched['stdout']}")
    dep = cli("deploy", "jax-resnet50", "--registry", fresh, "--name",
              "resnet-prebuilt")
    ready = json.loads(dep["stdout"].strip().splitlines()[-1])
    same = {kind: _without_latency(http_json(ready["url"] + "/invoke", body))
            == deps["jax-resnet50"]["answers"][kind]
            for kind, body in deps["jax-resnet50"]["bodies"].items()}
    log(f"path M (f) a fresh registry's build: {fetched['wall_s']:.2f} s, "
        f"{fetched['stdout'].strip()}; deploy {dep['wall_s']:.3f} s, "
        f"cold_start {ready['cold_start']}; answers bitwise the built "
        f"bundle's: {same} [{card}]")
    if not all(same.values()):
        raise SystemExit("path M (f): the prebuilt bundle answers otherwise")
    return {**{k: v for k, v in rel.items() if k != "store"},
            "fetch_build_s": fetched["wall_s"],
            "prebuilt_deploy_wall_s": dep["wall_s"],
            "prebuilt_cold_start": ready["cold_start"]}


def _llama(cli: Cli, card: str, beside, out: Path) -> tuple:
    """(g): ``build jax-llama3-8b --out <out>`` (int8, warm on), with
    ``beside`` (host-only work: no card, no latency measured) in a thread
    during the
    build and joined before the deploy; deployed by directory (the prefix
    store off, ``LAMBDIPY_PREFIX_CACHE_MB=0``, so a row is the engine's
    and bitwise solo ``generate``); 30 invokes of 100 in, 16 out through
    ``bench``; greedy tokens and logprobs bitwise an in-process
    ``generate`` on the bundle's weights; ``/metrics``
    ``handler.kernels``: ``int8_matmul`` 225 x forwards, the decode
    attention 32 x decode steps; the bundle kept for path N (the caller
    deletes it). Returns the stats and what ``beside`` returned."""
    from concurrent.futures import ThreadPoolExecutor

    from lambdipy_tpu_torch.bundle.format import load_manifest
    from lambdipy_tpu_torch.models import registry
    from lambdipy_tpu_torch.runtime.handlers import kernel_launches

    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(beside)
        built = cli("build", "jax-llama3-8b", "--out", out)
        host_out = host.result()
    rec = _build_record(cli, "jax-llama3-8b", out, built["wall_s"], card)
    log(f"path M (g) build (beside (f)'s publish and (i)'s package): "
        f"{built['stdout'].strip()}")
    nocache = {"LAMBDIPY_PREFIX_CACHE_MB": "0"}
    dep = cli("deploy", out, "--name", "llama", env=nocache)
    ready = json.loads(dep["stdout"].strip().splitlines()[-1])
    url = ready["url"]
    log(f"path M (g) deploy llama3-8b by directory: deploy_wall_s "
        f"{dep['wall_s']:.3f}, cold_start {ready['cold_start']} (the "
        f"warm built {rec['warm'].get('kernels_built')}: compile_cache "
        f"{ready['cold_start']['compile_cache']:.4f} s, a hit) [{card}]")
    payload = load_manifest(out)["payload"]
    adapter = registry.get(payload["model"]).build(
        dtype=payload["dtype"], quant=payload["quant"],
        extra=dict(payload["extra"]))
    prompt = torch.randint(1, adapter.config.vocab_size, (100,),
                           generator=torch.Generator().manual_seed(19)
                           ).tolist()
    body = {"tokens": prompt, "max_new_tokens": 16}
    bench = cli.json("bench", "llama", "-n", M_LLAMA_INVOKES, "--data",
                     json.dumps(body))
    log(f"path M (g) bench: {M_LLAMA_INVOKES} invokes, 100 in, 16 out: "
        f"{bench} [{card}]")
    served = http_json(url + "/invoke", {**body, "logprobs": True})
    _until_ready(url)  # the handler's background warm ended
    metrics = http_json(url + "/metrics")["handler"]
    server = adapter.make_server(
        adapter.load_params(out / "params", "cuda"), device="cuda")
    toks, lps = server.generate([prompt], max_new_tokens=16,
                                return_logprobs=True)
    bitwise = (served["tokens"] == toks.tolist()
               and served["logprobs"] == _as_served(lps).tolist())
    log(f"path M (g) the deployment's greedy tokens and logprobs bitwise "
        f"an in-process generate on the bundle's weights: {bitwise}")
    if not bitwise:
        raise SystemExit("path M (g): the deployment's row differs")
    layers = adapter.config.layers
    del server, adapter
    gc.collect()
    torch.cuda.empty_cache()
    es = metrics.get("batching") or {}
    forwards = (metrics["prefill_replays"] + metrics["eager_prefills"]
                + metrics["replays"] + metrics["eager_steps"]
                + es.get("prefix_joins", 0) + es.get("forwards", 0))
    launches = metrics["kernels"]
    want = {"int8_matmul": (7 * layers + 1) * forwards,
            "decode_attention": layers * (es.get("steps", 0)
                                          + metrics["replays"]
                                          + metrics["eager_steps"])}
    log(f"path M (g) /metrics handler.kernels {launches}; implied "
        f"{want} ({forwards} forwards, {es.get('steps')} engine steps, "
        f"{metrics['replays'] + metrics['eager_steps']} solo steps)")
    if any(launches[k] != want[k] for k in want):
        raise SystemExit("path M (g): the launch identity fails")
    stats = {"build": rec, "deploy_wall_s": dep["wall_s"],
             "cold_start": ready["cold_start"], "bench": bench,
             "bitwise": bitwise, "launches": launches,
             "implied": want, "in_process": kernel_launches()}
    cli("stop", "llama")
    return stats, host_out


def _server_processes(root: Path) -> list:
    """This run's server and supervisor processes: the port's, serving a
    bundle under ``root`` (every bundle path M deploys is under it), so
    another checkout's deployments on the host are neither counted nor
    killed."""
    mine = str(root.resolve()).encode()
    found = []
    for entry in Path("/proc").iterdir():
        if not entry.name.isdigit():
            continue
        try:
            cmd = (entry / "cmdline").read_bytes().replace(b"\0", b" ")
            state = (entry / "stat").read_text().rsplit(")", 1)[1].split()[0]
        except OSError:
            continue
        if state != "Z" and mine in cmd and (
                b"lambdipy_tpu_torch.runtime.server" in cmd
                or b"lambdipy_tpu_torch.runtime.supervisor" in cmd):
            found.append(int(entry.name))
    return found


def _package(cli: Cli, say) -> dict:
    """(i): a requirements file naming numpy (the numpy recipe covers it)
    and einops (plain) packaged into one site tree holding both (in a
    thread beside the llama build: ``say`` takes the log line)."""
    req = cli.root / "requirements.txt"
    req.write_text("numpy\neinops\n")
    tree = cli.root / "package"
    res = cli("package", req, "--out", tree)
    site = tree / "site"
    holds = {"numpy": (site / "numpy" / "__init__.py").is_file(),
             "einops": (site / "einops" / "__init__.py").is_file()}
    say(f"path M (i) package: {res['wall_s']:.2f} s (beside the llama "
        f"build), {res['stdout'].strip()}; the tree holds {holds}")
    if not all(holds.values()):
        raise SystemExit(f"path M (i): the tree lacks {holds}")
    return {"wall_s": res["wall_s"], "holds": holds}


def serve_lifecycle_path(card: str, llama: Path) -> dict:
    """Path M: the bundle lifecycle through the CLI on the card, (a)-(i)
    (see ``Cli`` and the helpers above); every failure exits non-zero.
    (g) builds the llama bundle into ``llama`` and leaves it there for
    path N."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from lambdipy_tpu_torch.runtime.handlers import kernel_launches

    gc.collect()
    torch.cuda.empty_cache()
    set_launches_to_zero()  # counters to 0 just before the path
    free_before = torch.cuda.mem_get_info()[0]
    cli = Cli(Path(tempfile.mkdtemp(prefix="lambdipy-lifecycle-")))
    out: dict = {}
    try:
        names = [ln.split()[0] for ln in cli("recipes")["stdout"]
                 .splitlines() if ln.strip()]
        log(f"path M (b) recipes: {names}")
        if sorted(names) != sorted(M_TWINS):
            raise SystemExit(f"path M (b): recipes lists {names}")
        log("path M (c): tabular-sklearn left out (no sklearn on this "
            "host), certifi and numpy-src too (sdist recipes: no source "
            "archive here)")
        # the three builds at once, a process each (hello's warm on the
        # CPU, the card recipes' on the card; the kernel cache's writes
        # are atomic, so both card warms may build the kernels)
        recipes = ("jax-resnet50", "jax-bert", "hello-numpy")
        with ThreadPoolExecutor(len(recipes)) as pool:
            builds = {r: pool.submit(cli, "build", r) for r in recipes}
            builds = {r: f.result() for r, f in builds.items()}
        out["builds"] = {r: _build_record(
            cli, r, cli.registry_bundle(r), builds[r]["wall_s"], card,
            " (the three builds at once)") for r in recipes}
        hit = cli("build", "jax-resnet50")
        log(f"path M (c) a second build: {hit['stdout'].strip()} "
            f"({hit['wall_s']:.2f} s)")
        if not hit["stdout"].startswith("cache hit:"):
            raise SystemExit(f"path M (c): no cache hit: {hit['stdout']}")
        # the deploys at once (each process imports torch and boots),
        # then each deployment's bench and checks in turn
        with ThreadPoolExecutor(len(M_BENCH)) as pool:
            deps = {r: pool.submit(cli, "deploy", r) for r in M_BENCH}
            deps = {r: f.result() for r, f in deps.items()}
        out["deploys"] = {r: _deploy_checks(cli, r, deps[r], card)
                          for r in M_BENCH}
        out["watchdog"] = _watchdog(cli, out["deploys"]["jax-resnet50"],
                                    card)
        lines: list = []  # the host-only phases' log, printed after them

        def host_only():  # (f)'s publish and (i): no card, no latency
            return _publish(cli, lines.append), _package(cli, lines.append)

        out["llama"], (rel, out["package"]) = _llama(cli, card, host_only,
                                                     llama)
        for line in lines:
            log(line)
        out["releases"] = _prebuilt(cli, rel, out["deploys"], card)
        doctor = cli.json("doctor", "--probe-timeout", 120)
        healthy = {d["name"]: d.get("healthy") for d in doctor["deployments"]}
        log(f"path M (h) doctor: device {doctor['device']}, cuda "
            f"{doctor['cuda']}, kernels {doctor['kernels']}, registry "
            f"{doctor['registry']}, deployments {healthy}")
        if not doctor["device"]["ok"] or not all(healthy.values()) or \
                set(healthy) != {*M_BENCH, "resnet-prebuilt"}:
            raise SystemExit(f"path M (h): doctor {doctor}")
        for name in healthy:
            cli("stop", name)
        left = cli("deployments")["stdout"].strip()
        procs = _server_processes(cli.root)
        gc.collect()
        torch.cuda.empty_cache()
        free_after = torch.cuda.mem_get_info()[0]
        log(f"path M (h) stopped {sorted(healthy)}; deployments lists "
            f"{left!r}; server processes alive {procs}; the card's free "
            f"memory {free_before / 2**30:.2f} GiB before M, "
            f"{free_after / 2**30:.2f} GiB after [{card}]")
        if left or procs or free_after < free_before - M_FREE_SLACK:
            raise SystemExit("path M (h): teardown left deployments, "
                             "processes or card memory behind")
        out["teardown"] = {"free_before": free_before,
                           "free_after": free_after, "doctor": doctor}
    finally:
        # a failed phase's leftovers
        for pid in _server_processes(cli.root) + _bundle_processes(llama):
            subprocess.run(["kill", "-9", str(pid)], check=False)
        shutil.rmtree(cli.root, ignore_errors=True)
    local = kernel_launches()
    deployed = out["llama"]["launches"]
    out["launches"] = {k: local[k] + deployed[k] for k in KERNELS}
    log(f"path M: kernel launches in process and in the llama deployment "
        f"{out['launches']}")
    return out


# path N: the fleet through the port's CLI, ``python -m lambdipy_tpu_torch
# fleet`` over M (g)'s jax-llama3-8b bundle at full width (int8 weights,
# bf16 paged K/V): two decode-class replicas and one prefill-class behind
# the router, the elastic controller in dry run. The sizes are the
# card's; ``serve_fleet_path(..., sizes=...)`` takes smaller ones for a
# rehearsal of the same checks on the CPU with a tiny bundle
N_SIZES = {
    "block": 32,          # the recipe's prefix_block and the router's
    "head": 1024,         # 32 blocks: half the engine's 2,048-token window
    "tails": (16, 23, 30, 37, 44, 51, 58, 64),
    "new": 16,
    "user": 32,           # the tokens a session turn adds
    "window": 2048,       # the recipe's batch_cache_len
    "burst_scale": 1,     # D's burst prompt lengths are divided by this
}
N_DECODE = 2
N_PREFILL = 1
N_PIN_MB = 384  # a session's three turns over a 1,024-token head pin ~140 MB
N_PROBE_S = 0.25
N_RETRY_BUDGET = 1.0  # a killed replica's in-flight requests all retry
N_FAULTS = "kv_ship:exception@n=1;route_connect:exception@n=1"
N_KILL_STREAM_NEW = 256  # (e)'s streamed row, in flight through the kill
N_LP_GAP = ROUTED_LOGPROB_GAP  # a routed row's first logprob against solo
N_BOOT_S = 900.0
N_FREE_SLACK = 1 << 30
# snapshot fields the port's replicas leave None in this configuration
# (ROADMAP.md §3): no speculative decoding and no long-context tier here
N_NONE_FIELDS = ("spec_k", "acceptance", "draft_mode", "draft_acceptance",
                 "offload_stall_frac", "prefetch_hit_rate",
                 "max_logical_ctx", "compiled_window", "boot_logical_ctx")


class FleetProc:
    """A ``python -m lambdipy_tpu_torch fleet`` process in a session of
    its own, from the checkout's root: its readiness line, its URL, and
    SIGTERM."""

    def __init__(self, root: Path, tag: str, args: list, env: dict):
        import select

        self.log_path = root / f"{tag}.fleet.log"
        t0 = time.perf_counter()
        with open(self.log_path, "w") as err:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "lambdipy_tpu_torch", "fleet",
                 *map(str, args)],
                stdout=subprocess.PIPE, stderr=err, text=True, env=env,
                cwd=Path(__file__).resolve().parent, start_new_session=True)
        ready = None
        while ready is None and time.perf_counter() - t0 < N_BOOT_S:
            if not select.select([self.proc.stdout], [], [], 1.0)[0]:
                if self.proc.poll() is not None:
                    break
                continue
            line = self.proc.stdout.readline()
            if not line:
                break
            try:
                doc = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(doc, dict) and doc.get("ready"):
                ready = doc
        if ready is None:
            self.proc.kill()
            self.proc.wait(60)
            raise SystemExit(f"path N: the {tag} fleet gave no readiness "
                             f"line (rc {self.proc.returncode}):\n"
                             f"{self.log_path.read_text()[-3000:]}")
        self.ready = ready
        self.wall_s = time.perf_counter() - t0
        self.url = f"http://127.0.0.1:{ready['port']}"

    def metrics(self) -> dict:
        return http_json(self.url + "/metrics")

    def states(self) -> dict:
        return http_json(self.url + "/healthz")["replicas"]

    def stop(self, timeout: float = 300.0) -> tuple:
        """SIGTERM, then the exit code and the seconds to it."""
        import signal

        t0 = time.perf_counter()
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            rc = self.proc.wait(60)
        return rc, time.perf_counter() - t0


def _bundle_processes(bundle: Path) -> list:
    """The live server and supervisor processes of the port serving
    ``bundle`` (the replicas, whatever fleet spawned them)."""
    mine = str(bundle.resolve()).encode()
    found = []
    for entry in Path("/proc").iterdir():
        if not entry.name.isdigit():
            continue
        try:
            cmd = (entry / "cmdline").read_bytes().replace(b"\0", b" ")
            state = (entry / "stat").read_text().rsplit(")", 1)[1].split()[0]
        except OSError:
            continue
        if state != "Z" and mine in cmd and (
                b"lambdipy_tpu_torch.runtime.server" in cmd
                or b"lambdipy_tpu_torch.runtime.supervisor" in cmd):
            found.append(int(entry.name))
    return found


def _wait_state(fleet: FleetProc, name: str, state: str, t0: float,
                timeout: float = 300.0) -> float:
    """Seconds from ``t0`` until the router's pool reads ``state`` for
    ``name``."""
    while fleet.states().get(name) != state:
        if time.perf_counter() - t0 > timeout:
            raise SystemExit(f"path N: {name} not {state} {timeout} s on")
        time.sleep(0.02)
    return time.perf_counter() - t0


def _until_routable(fleet: FleetProc, n: int, timeout: float = 600.0
                    ) -> float:
    """Seconds until ``n`` replicas are routable (every background warm
    over: a warming replica reads not ready)."""
    t0 = time.perf_counter()
    while http_json(fleet.url + "/healthz")["routable"] < n:
        if time.perf_counter() - t0 > timeout:
            raise SystemExit(f"path N: fewer than {n} replicas routable "
                             f"{timeout} s on")
        time.sleep(0.05)
    return time.perf_counter() - t0


def _served(out: dict) -> tuple:
    """A non-streamed answer's (tokens, logprobs) of its one row."""
    if not out.get("ok"):
        raise SystemExit(f"path N: a request failed: {str(out)[:500]}")
    return out["tokens"][0], (out.get("logprobs") or [None])[0]


def _stream(url: str, body: dict, on_first=None) -> dict:
    """``/invoke`` with ``"stream": true``: the records, seconds to the
    first and to the end, and the error if the stream broke before its
    ``done`` record. ``on_first`` runs when the first record lands."""
    req = urllib.request.Request(
        url + "/invoke", data=json.dumps({**body, "stream": True}).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    records, first, error = [], None, None
    try:
        with urllib.request.urlopen(req, timeout=900) as resp:
            for line in resp:
                if line.strip():
                    if first is None:
                        first = time.perf_counter() - t0
                        if on_first is not None:
                            on_first()
                    records.append(json.loads(line))
    except Exception as e:  # noqa: BLE001 — a broken stream is the answer
        error = repr(e)
    done = bool(records) and bool(records[-1].get("done"))
    if error is None and not done:
        error = f"no done record: {str(records[-1:])[:300]}"
    return {"records": records, "ttft_s": first,
            "wall_s": time.perf_counter() - t0, "error": error,
            "tokens": [t for r in records if not r.get("done")
                       for t in (r.get("tokens") or [[]])[0]]}


def _post_h(url: str, body: dict, headers: dict) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **headers})
    with urllib.request.urlopen(req, timeout=900) as resp:
        return json.loads(resp.read())


def _replica_metrics(fleet: FleetProc) -> dict:
    return fleet.metrics()["replicas"]


def _routed(fleet: FleetProc) -> dict:
    return {n: r["routed"] for n, r in fleet.metrics()["pool"].items()}


def _pc(metrics: dict, name: str) -> dict:
    return metrics[name]["handler"]["prefix_cache"]


def _burst_bodies(draw, sizes: dict) -> list:
    """D's burst and joiners (prompt length, new tokens, kind) with the
    prompts cut to the engine's window; eos rows sample without the eos."""
    out = []
    for s_len, n, kind in BURST + JOINERS:
        s_len = min(max(4, s_len // sizes["burst_scale"]),
                    sizes["window"] - n)
        body = {"tokens": draw(s_len), "max_new_tokens": n,
                **KNOBS.get(kind, {})}
        if kind in ("logprobs", "stream"):
            body["logprobs"] = True
        out.append((kind, body))
    return out


def _fleet_burst(url: str, reqs: list, *, streamed: bool) -> dict:
    """The burst through ``url``: 8 requests at once, the 4 joiners half
    a second on; every request streamed (the time to its first record)
    or not (the ``stream`` kind streamed all the same). Per request: its
    answer or its error."""
    from concurrent.futures import ThreadPoolExecutor

    def send(i):
        kind, body = reqs[i]
        time.sleep(0.0 if i < 8 else 0.5)
        if streamed or kind == "stream":
            return _stream(url, body)
        t1 = time.perf_counter()
        try:
            out = http_json(url + "/invoke", body)
            return {"out": out, "wall_s": time.perf_counter() - t1,
                    "error": None if out.get("ok") else str(out)[:300]}
        except Exception as e:  # noqa: BLE001 — counted by the caller
            return {"error": repr(e)}

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(reqs)) as pool:
        res = list(pool.map(send, range(len(reqs))))
    wall = time.perf_counter() - t0
    new = sum(len(r["tokens"]) if "records" in r
              else r["out"]["n_new"] if r.get("out") else 0 for r in res)
    ttft = sorted(r["ttft_s"] for r in res if r.get("ttft_s") is not None)
    return {"results": res, "wall_s": wall, "new_tokens": new,
            "tok_s": new / wall,
            "ttft_p50_s": _percentile(ttft, 0.50) if ttft else None,
            "ttft_p99_s": _percentile(ttft, 0.99) if ttft else None}


def _ship_ms(before: dict, after: dict) -> float:
    """One ship's ms out of ``ship_ms_ewma`` (alpha 0.2) before and after
    it."""
    if before["ships"] == 0:
        return after["ship_ms_ewma"]
    return (after["ship_ms_ewma"] - 0.8 * before["ship_ms_ewma"]) / 0.2


def _launch_identity(metrics: dict, layers: int) -> tuple:
    """Summed over the replicas' ``/metrics`` ``handler``: the kernels'
    counters and what the forwards and decode steps imply (path M (g)'s
    count: prefill programs, including the prefix store's walk and export
    chunks, solo decode steps, the engine's continuations and forwards).
    A paged engine's steps launch kernel 3, a dense engine's kernel 1."""
    got = dict.fromkeys(KERNELS, 0)
    want = dict.fromkeys(KERNELS, 0)
    forwards = steps = dense = solo = 0
    for rep in metrics.values():
        h = rep["handler"]
        es = h.get("batching") or {}
        for k in KERNELS:
            got[k] += h["kernels"][k]
        forwards += (h["prefill_replays"] + h["eager_prefills"]
                     + h["replays"] + h["eager_steps"]
                     + es.get("prefix_joins", 0) + es.get("forwards", 0))
        if es.get("paged", True):
            steps += es.get("steps", 0)
        else:
            dense += es.get("steps", 0)
        solo += h["replays"] + h["eager_steps"]
    want["int8_matmul"] = (7 * layers + 1) * forwards
    want["paged_decode_attention"] = layers * steps
    want["decode_attention"] = layers * (solo + dense)
    return got, want, {"forwards": forwards, "engine_steps": steps + dense,
                       "dense_engine_steps": dense, "solo_steps": solo}


def _snapshot_nones(fleet: FleetProc, metrics: dict) -> dict:
    """The elastic controller's snapshot of ``metrics`` (one router
    ``/metrics``), built by the port's ``FleetController`` over a pool
    attached to the same replicas: each replica's fields that are None."""
    from types import SimpleNamespace

    from lambdipy_tpu_torch.fleet import FleetController, ReplicaPool

    pool = ReplicaPool()
    for name, cls in fleet.ready["classes"].items():
        pool.attach(name, fleet.ready["urls"][name], role=cls)
    # what build_snapshot reads of a router: its pool and ship window
    router = SimpleNamespace(pool=pool, ship_window=4, controller=None)
    snap = FleetController(router, dry_run=True).build_snapshot(metrics)
    fields = [f.name for f in dataclasses.fields(snap.replicas[0])]
    return {v.name: sorted(f for f in fields if getattr(v, f) is None)
            for v in snap.replicas}


def _window_bundle(bundle: Path, root: Path,
                   changes: dict | None = None) -> Path:
    """``bundle`` as the fleet serves it. The recipe's engine holds 2,048
    positions (``batch_cache_len``) of llama3-8b's 8,192-position window,
    and the prefix store stands down under an engine narrower than the
    model's window (JAX's rule, ``runtime/handlers.py
    make_prefix_store``): with no store there is no affinity hit, no
    ship and no session. So the fleet serves a twin of the bundle whose
    files are hard links to its own but for the manifest, whose extra
    gives the model the engine's window (``max_len`` = ``batch_cache_len``)
    in the manifest's payload and in ``handler.py``'s ``_SPEC``, which the
    boot reads, with ``changes`` over it; a bundle with no
    ``batch_cache_len`` and no ``changes`` is served as it is."""
    import ast
    import shutil

    manifest = json.loads((bundle / "manifest.json").read_text())
    extra = manifest["payload"].get("extra") or {}
    if extra.get("batch_cache_len") in (None, "") and not changes:
        return bundle
    out = root / "bundle"
    shutil.copytree(bundle, out, copy_function=os.link)
    window = ({} if extra.get("batch_cache_len") in (None, "")
              else {"max_len": extra["batch_cache_len"]})
    window.update(changes or {})
    manifest["payload"]["extra"] = {**extra, **window}
    lines = (bundle / "handler.py").read_text().splitlines(keepends=True)
    for i, line in enumerate(lines):
        if line.startswith("_SPEC = "):
            spec = ast.literal_eval(line[len("_SPEC = "):])
            spec["extra"] = {**spec["extra"], **window}
            lines[i] = f"_SPEC = {spec!r}\n"
    for name, text in (("manifest.json", json.dumps(manifest, indent=2)),
                       ("handler.py", "".join(lines))):
        (out / name).unlink()  # a hard link to the source's file
        (out / name).write_text(text)
    return out


def _fleet_references(bundle: Path, device: str, bodies: dict) -> tuple:
    """In-process rows on the bundle's weights (its manifest's model and
    extra): ``bodies`` maps a key to (body, with logprobs); returns the
    rows, keyed alike, and the model's layer count."""
    from lambdipy_tpu_torch.bundle.format import load_manifest
    from lambdipy_tpu_torch.models import registry

    payload = load_manifest(bundle)["payload"]
    adapter = registry.get(payload["model"]).build(
        dtype=payload["dtype"], quant=payload.get("quant"),
        extra=dict(payload.get("extra") or {}))
    server = adapter.make_server(adapter.load_params(bundle / "params",
                                                     device), device=device)
    refs = {}
    for key, (body, lps) in bodies.items():
        got = server.generate([body["tokens"]],
                              max_new_tokens=body["max_new_tokens"],
                              return_logprobs=lps)
        refs[key] = ((got[0][0].tolist(), _as_served(got[1])[0].tolist())
                     if lps else got[0].tolist())
    layers = adapter.config.layers
    del server, adapter
    gc.collect()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return refs, layers


def serve_fleet_path(card: str, bundle: Path, *, device: str = "cuda",
                     sizes: dict | None = None) -> dict:
    """Path N: the fleet over ``bundle`` (its window twin, see
    ``_window_bundle``), (a)-(i); every failure exits non-zero.
    ``device="cpu"`` (a rehearsal on a tiny bundle) leaves out the
    card's memory and the launch identity."""
    import os
    import shutil
    import signal
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from lambdipy_tpu_torch.bundle.format import load_manifest
    from lambdipy_tpu_torch.fleet import affinity
    from lambdipy_tpu_torch.models import registry
    from lambdipy_tpu_torch.runtime.handlers import kernel_launches

    sz = {**N_SIZES, **(sizes or {})}
    cuda = device == "cuda"
    block, new = sz["block"], sz["new"]
    root = Path(tempfile.mkdtemp(prefix="lambdipy-fleet-"))
    (root / "home").mkdir()
    served = _window_bundle(bundle, root)
    if served != bundle:
        log(f"path N serves a twin of {bundle}: its manifest and handler.py "
            f"give the model the engine's window (max_len "
            f"{load_manifest(served)['payload']['extra']['max_len']}); the "
            f"recipe's bundle as built would serve the fleet with no prefix "
            f"store (no affinity hit, no ship, no session), so every number "
            f"below is the twin's")
    payload = load_manifest(served)["payload"]
    cfg = registry.get(payload["model"]).build(
        dtype=payload["dtype"], quant=payload.get("quant"),
        extra=dict(payload.get("extra") or {})).config
    rng = torch.Generator().manual_seed(23)

    def draw(n):
        return torch.randint(1, cfg.vocab_size, (n,), generator=rng).tolist()

    head = draw(sz["head"])
    b_bodies = [{"tokens": head + draw(t), "max_new_tokens": new,
                 "logprobs": True} for t in sz["tails"]]
    c_body = {"tokens": draw(sz["head"]) + draw(24), "max_new_tokens": new,
              "logprobs": True}
    users = [draw(sz["user"]) for _ in range(3)]
    bursts = {k: _burst_bodies(draw, sz) for k in ("fleet", "kill")}
    f_body = {"tokens": draw(sz["head"]) + draw(24), "max_new_tokens": new}
    ref_bodies = {("b", i): (b, True) for i, b in enumerate(b_bodies)}
    ref_bodies["f"] = (f_body, False)
    ref_bodies.update({("e", i): (b, False)
                       for i, (k, b) in enumerate(bursts["kill"])
                       if k == "greedy"})

    env = {**os.environ, "HOME": str(root / "home"),
           "PYTHONPATH": str(Path(__file__).resolve().parent),
           "LAMBDIPY_KV_PAGED": "1", "LAMBDIPY_LOG_LEVEL": "WARNING"}
    if not cuda:
        env["LAMBDIPY_PLATFORM"] = "cpu"
    dev_args = [] if cuda else ["--device", "cpu"]
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
        set_launches_to_zero()  # counters to 0 just before the path
    free_before = torch.cuda.mem_get_info()[0] if cuda else 0
    out: dict = {}
    fleet = faults = faults_boot = None
    boot_pool = ThreadPoolExecutor(2)
    try:
        # (a) boot, with the in-process references computed meanwhile
        booting = boot_pool.submit(FleetProc, root, "main", [
            served, "--replicas", N_DECODE,
            "--prefill-replicas", N_PREFILL, "--port", 0,
            "--name", "fleet", "--block", block,
            "--probe-interval", N_PROBE_S, "--retries", 3,
            "--retry-budget", N_RETRY_BUDGET,
            "--session-pin-budget", N_PIN_MB, "--autoscale-dry-run",
            "--autoscale-interval", 1.0, *dev_args], env)
        t0 = time.perf_counter()
        try:
            refs, layers = _fleet_references(served, device, ref_bodies)
            log(f"path N: in-process references ({len(refs)} rows) on "
                f"the bundle's weights in "
                f"{time.perf_counter() - t0:.1f} s, beside the boot")
        finally:
            fleet = booting.result()
        ready = fleet.ready
        urls = ready["urls"]
        decs = sorted(n for n, c in ready["classes"].items() if c == "decode")
        pre = next(n for n, c in ready["classes"].items() if c == "prefill")
        cold = {n: http_json(u + "/healthz")["cold_start"]
                for n, u in urls.items()}
        free_boot = torch.cuda.mem_get_info()[0] if cuda else 0
        log(f"path N (a) readiness line {json.dumps(ready)}")
        log(f"path N (a) spawn to the readiness line {fleet.wall_s:.2f} s "
            f"(three replicas at once, beside the references); cold_start "
            f"{json.dumps(cold)}; the card's free memory "
            f"{free_before / 2**30:.2f} GiB before, "
            f"{free_boot / 2**30:.2f} GiB after the boot [{card}]")
        # each replica's first invoke starts its background warm (a
        # warming replica is not routable): warm all three, then route
        with ThreadPoolExecutor(3) as pool:
            list(pool.map(lambda u: http_json(u + "/invoke", WARMUP_BODY),
                          urls.values()))
        warm_s = _until_routable(fleet, N_DECODE + N_PREFILL)
        # (f)'s router, attached to the same replicas, boots beside (b)-(d)
        faults_boot = boot_pool.submit(FleetProc, root, "faults", [
            "-", "--replicas", 0, "--port", 0, "--name", "faults",
            "--block", block, "--probe-interval", N_PROBE_S,
            "--retries", 3, "--fault-spec", N_FAULTS,
            *[a for n, c in ready["classes"].items()
              for a in ("--attach", f"{n}={urls[n]}:{c}")]], env)
        log(f"path N (a) the replicas' background warm after their first "
            f"invoke: {warm_s:.2f} s until all routable")
        out["boot"] = {"ready": ready, "wall_s": fleet.wall_s,
                       "cold_start": cold, "warm_s": warm_s,
                       "free_before": free_before, "free_boot": free_boot}

        # (b) affinity
        want = affinity.pick_replica(
            affinity.prefix_key(b_bodies[0], block=block), decs)
        other = next(n for n in decs if n != want)
        m0 = fleet.metrics()
        t1 = time.perf_counter()
        answers = [http_json(fleet.url + "/invoke", b_bodies[0])]
        first_s = time.perf_counter() - t1
        with ThreadPoolExecutor(7) as pool:
            answers += list(pool.map(
                lambda b: http_json(fleet.url + "/invoke", b), b_bodies[1:]))
        b_wall = time.perf_counter() - t1
        m1 = fleet.metrics()
        routed = {n: m1["pool"][n]["routed"] - m0["pool"][n]["routed"]
                  for n in urls}
        hits = {n: _pc(m1["replicas"], n)["hits"]
                - _pc(m0["replicas"], n)["hits"] for n in decs}
        same = gap = 0
        for i, ans in enumerate(answers):
            toks, lps = _served(ans)
            rt, rl = refs[("b", i)]
            same += toks == rt
            gap = max(gap, abs(lps[0] - rl[0]))
        log(f"path N (b) 8 requests on one {sz['head']}-token head (the "
            f"first alone, {first_s:.2f} s with its ship, then 7 at once, "
            f"{b_wall - first_s:.2f} s) [{card}]: routed "
            f"{routed}, the port's pick_replica {want}; prefix-cache hits "
            f"{hits}; greedy tokens equal in-process generate {same} of 8, "
            f"first-token logprob gap {gap:.5f} (bound {N_LP_GAP}); "
            f"router affinity {m1['router']['affinity']}")
        if routed[want] != 8 or routed[other] or hits[want] < 7 \
                or hits[other] or same != 8 or gap > N_LP_GAP:
            raise SystemExit("path N (b): affinity, hits or tokens differ")
        out["affinity"] = {"routed": routed, "hits": hits, "want": want,
                           "gap": gap, "first_s": first_s, "wall_s": b_wall,
                           "first_ship_ms": m1["fleet"]["disagg"]
                           ["ship_ms_ewma"]}

        # (c) the phase split: a new cold head
        c_want = affinity.pick_replica(
            affinity.prefix_key(c_body, block=block), decs)
        d0 = m1["fleet"]["disagg"]
        walks0 = _pc(m1["replicas"], c_want)["prefill"]["walks"]
        t1 = time.perf_counter()
        c_toks, c_lps = _served(http_json(fleet.url + "/invoke", c_body))
        c_wall = time.perf_counter() - t1
        m2 = fleet.metrics()
        d1 = m2["fleet"]["disagg"]
        walks1 = _pc(m2["replicas"], c_want)["prefill"]["walks"]
        direct = _served(http_json(urls[pre] + "/invoke", c_body))
        ship = {"bytes": d1["ship_bytes_total"] - d0["ship_bytes_total"],
                "ms": _ship_ms(d0, d1), "ship_ms_ewma": d1["ship_ms_ewma"],
                "decode_dispatches": d1["decode_dispatches"]
                - d0["decode_dispatches"],
                "ships_pipelined": d1["ships_pipelined"]
                - d0["ships_pipelined"], "walks": walks1 - walks0,
                "request_s": c_wall}
        frame = (sz["head"] * layers * 2 * cfg.kv_heads * cfg.head_dim
                 * torch.empty((), dtype=cfg.dtype).element_size())
        c_same = (c_toks, c_lps) == direct
        log(f"path N (c) a cold {sz['head']}-token head: ship {ship} "
            f"({ship['bytes']} bytes against {frame} of K/V; pipelined, "
            f"ship_window 4); the decode replica {c_want}'s walks "
            f"{ship['walks']}; tokens and logprobs bitwise the prefill "
            f"replica's answer sent to it directly: {c_same} [{card}]")
        if ship["decode_dispatches"] != 1 or ship["ships_pipelined"] != 1 \
                or ship["walks"] or not c_same:
            raise SystemExit("path N (c): the phase split differs")
        out["ship"] = ship

        # (d) sessions and failover: two sessions of three turns on the
        # (b) head, each turn the last prompt, its completion and new user
        # tokens, sent with x-session-id
        def turn(sid: str, prompt: list) -> tuple:
            before = _routed(fleet)
            row = _served(_post_h(fleet.url + "/invoke",
                                  {"tokens": prompt, "max_new_tokens": new,
                                   "logprobs": True}, {"x-session-id": sid}))
            after = _routed(fleet)
            return row, [n for n in after if after[n] > before[n]]

        def prompts_after(rows):
            p = head + users[0]
            for k, row in enumerate(rows):
                p = p + row[0] + users[k + 1]
            return p

        s0 = fleet.metrics()["fleet"]["sessions"]
        s1_rows, s1_lands = [], []
        for k in range(3):
            row, land = turn("n-s1", prompts_after(s1_rows))
            s1_rows.append(row)
            s1_lands.append(land)
        s2_rows, s2_lands = [], []
        for k in range(2):
            row, land = turn("n-s2", prompts_after(s2_rows))
            s2_rows.append(row)
            s2_lands.append(land)
        home = s2_lands[0][0] if s2_lands[0] else None
        pins = {n: _pc(fleet.metrics()["replicas"], n)["pinned_leaves"]
                for n in decs}
        log(f"path N (d) session 1 turns on {s1_lands}, session 2's first "
            f"two on {s2_lands} (home {home}); pinned leaves {pins}")
        if any(land != [home] for land in s1_lands + s2_lands) \
                or not pins[home]:
            raise SystemExit("path N (d): a turn left its home, or no pins")
        pid = http_json(urls[home] + "/healthz")["pid"]
        t_kill = time.perf_counter()
        os.kill(pid, signal.SIGKILL)
        ejected_s = _wait_state(fleet, home, "ejected", t_kill)
        row, land = turn("n-s2", prompts_after(s2_rows))
        s2_rows.append(row)
        readmitted_s = _wait_state(fleet, home, "ready", t_kill)
        s1 = fleet.metrics()["fleet"]["sessions"]
        tok_same = row[0] == s1_rows[2][0]
        lp_gap = max(abs(a - b) for a, b in zip(row[1], s1_rows[2][1]))
        log(f"path N (d) SIGKILL of {home}'s worker (pid {pid}): ejected "
            f"{ejected_s:.3f} s on, readmitted {readmitted_s:.2f} s on "
            f"(the supervisor's respawn and boot) [{card}]; session 2's "
            f"third turn on {land}: tokens equal session 1's third turn "
            f"{tok_same}, logprobs bitwise {row[1] == s1_rows[2][1]} (max "
            f"gap {lp_gap:.6f}); sessions {s1}")
        if land == [home] or not land or not tok_same or lp_gap > N_LP_GAP \
                or s1["failovers"] - s0["failovers"] != 1:
            raise SystemExit("path N (d): the failover differs")
        _until_routable(fleet, N_DECODE + N_PREFILL)
        for sid in ("n-s1", "n-s2"):
            req = urllib.request.Request(fleet.url + f"/v1/sessions/{sid}",
                                         method="DELETE")
            urllib.request.urlopen(req, timeout=60).read()
        pins = {n: _pc(fleet.metrics()["replicas"], n)["pinned_leaves"]
                for n in urls}
        log(f"path N (d) DELETE /v1/sessions/n-s1 and n-s2: pinned leaves "
            f"{pins}")
        if any(pins.values()):
            raise SystemExit("path N (d): pins left after the DELETEs")
        out["sessions"] = {"home": home, "failover_to": land,
                           "ejected_s": ejected_s,
                           "readmitted_s": readmitted_s,
                           "logprobs_bitwise": row[1] == s1_rows[2][1],
                           "lp_gap": lp_gap}

        # (f) fleet faults: the second router over the same replicas, with
        # the kv_ship and route_connect sites armed (booted beside (b)-(d))
        faults = faults_boot.result()
        _until_routable(faults, N_DECODE + N_PREFILL)
        f_toks = _served(http_json(faults.url + "/invoke", f_body))[0]
        fm = faults.metrics()
        fb, rr = fm["fleet"]["disagg"]["fallbacks"], fm["router"]
        log(f"path N (f) fault spec {N_FAULTS!r}: fallbacks {fb}, retries "
            f"{rr['retries']}, failovers {rr['failovers']}, retry budget "
            f"{rr.get('retry_budget')}; greedy tokens equal in-process "
            f"generate: {f_toks == refs['f']}")
        if fb != {"ship_fault": 1} or rr["retries"] != 1 \
                or f_toks != refs["f"] \
                or rr["retry_budget"]["allowed"] != 1:
            raise SystemExit("path N (f): the fleet faults differ")
        rc, _ = faults.stop()
        faults = None
        out["faults"] = {"fallbacks": fb, "retries": rr["retries"],
                         "retry_budget": rr["retry_budget"], "rc": rc}

        # (e) D's burst through the router, then again with a decode
        # worker SIGKILLed while it is in flight
        e1 = _fleet_burst(fleet.url, bursts["fleet"], streamed=True)
        errs = [r["error"] for r in e1["results"] if r["error"]]
        log(f"path N (e) D's burst ({len(bursts['fleet'])} requests, "
            f"prompts cut to {sz['window']}) through the router: "
            f"{e1['tok_s']:.1f} tok/s, time to the first streamed record "
            f"p50 {e1['ttft_p50_s']:.3f} s, p99 {e1['ttft_p99_s']:.3f} s, "
            f"wall {e1['wall_s']:.2f} s [{card}]")
        if errs:
            raise SystemExit(f"path N (e): burst errors {errs[:3]}")
        kill_reqs = bursts["kill"]
        s_idx = next(i for i, (k, _) in enumerate(kill_reqs) if k == "stream")
        # the streamed row decodes N_KILL_STREAM_NEW tokens here, so that
        # it is still in flight when the other rows reach its replica
        s_body = {**kill_reqs[s_idx][1], "max_new_tokens": min(
            N_KILL_STREAM_NEW,
            sz["window"] - len(kill_reqs[s_idx][1]["tokens"]))}
        victim = affinity.pick_replica(
            affinity.prefix_key(s_body, block=block), decs)
        vpid = http_json(urls[victim] + "/healthz")["pid"]
        first, killed = threading.Event(), {}
        r0 = fleet.metrics()["router"]
        with ThreadPoolExecutor(2) as pool:
            strm = pool.submit(_stream, fleet.url, s_body, first.set)
            first.wait(300)
            rest = [r for i, r in enumerate(kill_reqs) if i != s_idx]
            burst = pool.submit(_fleet_burst, fleet.url, rest,
                                streamed=False)
            # the kill: once the victim holds a non-streamed row besides
            # the stream (its router-side outstanding count)
            t1 = time.perf_counter()
            while not strm.done() and time.perf_counter() - t1 < 60:
                if fleet.metrics()["pool"][victim]["outstanding"] >= 2:
                    break
                time.sleep(0.02)
            killed["outstanding"] = \
                fleet.metrics()["pool"][victim]["outstanding"]
            killed["t"] = time.perf_counter()
            os.kill(vpid, signal.SIGKILL)
            e3, strm = burst.result(), strm.result()
        r1 = fleet.metrics()["router"]
        idx = [i for i in range(len(kill_reqs)) if i != s_idx]
        answered = sum(1 for r in e3["results"] if r["error"] is None)
        wrong = [i for j, i in enumerate(idx) if ("e", i) in refs
                 and e3["results"][j].get("out")
                 and e3["results"][j]["out"]["tokens"][0] != refs[("e", i)]]
        retries = r1["retries"] - r0["retries"]
        readmit2 = _wait_state(fleet, victim, "ready", killed["t"])
        log(f"path N (e) the burst again, {victim}'s worker (pid {vpid}) "
            f"SIGKILLed after the streamed row's first record, with "
            f"{killed['outstanding']} rows in flight there: {answered} of "
            f"{len(rest)} non-streamed requests answered (greedy rows "
            f"against in-process generate: {len(wrong)} differ), retries "
            f"{retries}, failovers {r1['failovers'] - r0['failovers']}; "
            f"the stream {len(strm['records'])} records, then "
            f"{str(strm['error'])[:160]!r}; {victim} readmitted "
            f"{readmit2:.2f} s after the kill")
        if answered != len(rest) or wrong or not retries \
                or strm["error"] is None or not strm["records"]:
            raise SystemExit("path N (e): a request was lost, none was "
                             "retried, or the broken stream did not error")
        out["burst"] = {"fleet": {k: v for k, v in e1.items()
                                  if k != "results"},
                        "kill": {"answered": answered, "of": len(rest),
                                 "retries": retries,
                                 "in_flight": killed["outstanding"],
                                 "stream_error": strm["error"],
                                 "readmitted_s": readmit2}}

        # (g) the controller in dry run over (b)-(f), once every replica's
        # background warm is over
        _until_routable(fleet, N_DECODE + N_PREFILL)
        m4 = fleet.metrics()
        ctl = m4["fleet"]["controller"]
        nones = _snapshot_nones(fleet, m4)
        extra_none = {n: [f for f in v if f not in N_NONE_FIELDS]
                      for n, v in nones.items()}
        log(f"path N (g) fleet.controller: ticks {ctl['ticks']}, errors "
            f"{ctl['errors']}, intents {ctl['intents']}, actions "
            f"{ctl['actions']}, last decision {ctl['last_decision']}; "
            f"snapshot fields None beyond ROADMAP.md's list: {extra_none}")
        if not ctl["ticks"] or ctl["errors"] or ctl["actions"] \
                or any(extra_none.values()):
            raise SystemExit("path N (g): the controller's run differs")
        out["controller"] = {"ticks": ctl["ticks"],
                             "intents": ctl["intents"], "nones": nones}

        # (h) the launch identity over the replicas' processes (read again
        # while an engine still books its last segment)
        programs = {n: r["handler"]["program_bytes"]
                    for n, r in m4["replicas"].items()}
        free_traffic = torch.cuda.mem_get_info()[0] if cuda else 0
        got, implied, counts = _launch_identity(m4["replicas"], layers)
        for _ in range(10 if cuda else 0):
            if got == implied:
                break
            time.sleep(0.5)
            got, implied, counts = _launch_identity(_replica_metrics(fleet),
                                                    layers)
        log(f"path N (h) handler.kernels over the three replicas {got}, "
            f"implied {implied} ({counts}); program_bytes {programs}; the "
            f"card's free memory after the traffic "
            f"{free_traffic / 2**30:.2f} GiB [{card}]")
        if cuda and got != implied:
            raise SystemExit("path N (h): the launch identity fails")
        local = kernel_launches()
        out["launches"] = {k: local[k] + got[k] for k in KERNELS}
        out["programs"] = programs
    finally:
        if faults is None and faults_boot is not None:
            try:
                faults = faults_boot.result()
            except BaseException:  # noqa: BLE001 — its boot failed
                pass
        boot_pool.shutdown(wait=True)
        for proc in (faults, fleet):
            if proc is not None and proc.proc.poll() is None:
                rc, stop_s = proc.stop()
                if proc is fleet:
                    out["stop"] = {"rc": rc, "s": stop_s}
        left = _bundle_processes(served)
        for pid in left:  # a failed phase's leftovers
            subprocess.run(["kill", "-9", str(pid)], check=False)
        shutil.rmtree(root, ignore_errors=True)
    # (i) teardown
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    free_after = torch.cuda.mem_get_info()[0] if cuda else 0
    log(f"path N (i) SIGTERM: the fleet exited {out['stop']['rc']} in "
        f"{out['stop']['s']:.2f} s; replica processes alive {left}; the "
        f"card's free memory {free_before / 2**30:.2f} GiB before N, "
        f"{free_after / 2**30:.2f} GiB after [{card}]")
    if out["stop"]["rc"] != 0 or left or \
            (cuda and free_after < free_before - N_FREE_SLACK):
        raise SystemExit("path N (i): the teardown left processes or card "
                         "memory behind")
    out["teardown"] = {"free_after": free_after, "left": left}
    return out


# path O: the chaos soak (lambdipy_tpu_torch/chaos/) on the card, one window
# of it over a 2-replica fleet of a twin of M (g)'s llama3-8b bundle
O_SEED = 11
O_SECONDS = 12.0     # generate_timeline's floor
O_CEILING_S = 120.0  # the leg's own wall ceiling, checked at each stage
# the oracle's waiter bound, the wait for both replicas routable after the
# window and the nemesis's join past it (the entry point's defaults, for
# the CPU: 90, 240 and 60 s)
O_WAITER_S = 60.0
O_RECOVERY_S = 60.0
O_JOIN_S = 10.0
# JAX's soak bundle (lambdipy_tpu/chaos/soak.py:327-336) over the recipe's
# extra: the engine's slots and segment, new tokens, the store's block and
# the session lease
O_EXTRA = {"max_new_tokens": "8", "prefix_block": "32", "batch_max": "4",
           "batch_segment": "8", "session_idle_s": "60",
           "warm_group_prefill": "0", "serve_aot": "0"}
O_BLOCK = 32
O_NEW = 8
# JAX's soak budgets on llama-tiny (f32): its store's 64 MB and the host
# offload arena's default 256 MB; O gives each the MB that holds as many
# 32-token blocks of llama3-8b K/V
O_TINY_MB = {"prefix_cache_mb": 64, "kv_offload_mb": 256}
O_FREE_SLACK = 1 << 30


def _block_bytes(cfg, block: int) -> int:
    return (block * cfg.layers * 2 * cfg.kv_heads * cfg.head_dim
            * torch.empty((), dtype=cfg.dtype).element_size())


def _soak_budgets(cfg) -> dict:
    """O_TINY_MB scaled from llama-tiny's block bytes to ``cfg``'s."""
    from lambdipy_tpu_torch.models import registry

    tiny = registry.get("llama-tiny").build().config
    per = _block_bytes(tiny, O_BLOCK)
    big = _block_bytes(cfg, O_BLOCK)
    return {k: str(-(-(mb << 20) // per * big >> 20))
            for k, mb in O_TINY_MB.items()}


class _Routable:
    """Polls the pool every 50 ms from the window's start: each replica's
    routable and pid transitions, seconds from the start."""

    def __init__(self, pool):
        self.pool, self.t0 = pool, time.perf_counter()
        self.events: list = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        last: dict = {}
        while not self._stop.wait(0.05):
            for name, r in list(self.pool.replicas.items()):
                now = (r.routable, r.pid)
                if last.get(name) != now:
                    last[name] = now
                    self.events.append((round(time.perf_counter() - self.t0,
                                              3), name, *now))

    def stop(self) -> list:
        self._stop.set()
        self._thread.join(5)
        return self.events


def serve_soak_path(card: str, bundle: Path, *, device: str = "cuda") -> dict:
    """Path O: one window of the chaos soak (``chaos/soak.py``) on the card
    over a twin of ``bundle`` carrying JAX's soak extras (``O_EXTRA``, the
    store and offload MB of ``_soak_budgets``): ``SoakFleet`` (r0 dense, r1
    paged with ``LAMBDIPY_KV_OFFLOAD=1`` and 64 pages, spawned at once,
    the in-process reference answering the plan's requests beside the
    boot), ``run_window`` at seed 11 for 12 s with ``offload_stall`` in the
    schedule, JAX's whole oracle; then the post-storm row sent to each
    replica alone, bitwise the reference's; each process's launch identity;
    SIGTERM leaves no process and the card's memory back within 1 GiB. A
    wall ceiling of ``O_CEILING_S`` is checked at the end of each stage
    (boot, references, window, quiesce, teardown): past it the path exits
    naming the stage. ``device="cpu"`` rehearses it on a small bundle (the
    launch identity and the card's memory left out)."""
    import shutil
    import tempfile

    from lambdipy_tpu_torch.bundle.format import load_manifest
    from lambdipy_tpu_torch.chaos import soak
    from lambdipy_tpu_torch.chaos.nemesis import (generate_timeline,
                                                  timeline_properties)
    from lambdipy_tpu_torch.models import registry
    from lambdipy_tpu_torch.runtime.handlers import kernel_launches

    cuda = device == "cuda"
    t0 = time.perf_counter()
    stages: dict = {}
    marks = [0.0]

    def stage(name: str) -> None:
        now = time.perf_counter() - t0
        stages[name] = round(now - marks[-1], 2)
        marks.append(now)
        following = {"boot": "references", "references": "window",
                     "window": "quiesce", "quiesce": "teardown"}
        PROGRESS["stage"] = following.get(name, "")
        if now > O_CEILING_S:
            raise SystemExit(f"path O: past its {O_CEILING_S:.0f} s ceiling "
                             f"at the end of stage {name} ({now:.1f} s; "
                             f"stages {stages})")

    PROGRESS["stage"] = "boot"
    root = Path(tempfile.mkdtemp(prefix="lambdipy-soak-"))
    payload = load_manifest(bundle)["payload"]
    cfg = registry.get(payload["model"]).build(
        dtype=payload["dtype"], quant=payload.get("quant"),
        extra=dict(payload.get("extra") or {})).config
    budgets = _soak_budgets(cfg)
    served = _window_bundle(bundle, root, {**O_EXTRA, **budgets})
    extra = load_manifest(served)["payload"]["extra"]
    log(f"path O serves a twin of {bundle} with JAX's soak extras: "
        f"max_len {extra['max_len']} (the engine's window), "
        f"{ {k: extra[k] for k in O_EXTRA} }; the store "
        f"{budgets['prefix_cache_mb']} MB and the offload arena "
        f"{budgets['kv_offload_mb']} MB, JAX's {O_TINY_MB} on llama-tiny "
        f"scaled to as many {O_BLOCK}-token blocks of {payload['model']}'s "
        f"K/V ({_block_bytes(cfg, O_BLOCK)} bytes a block)")
    timeline = generate_timeline(seed=O_SEED, duration_s=O_SECONDS,
                                 replicas=list(soak.REPLICAS),
                                 must_include="offload_stall")
    log(f"path O: seed {O_SEED}, {O_SECONDS:.0f} s: "
        f"{timeline_properties(timeline)}")
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
        set_launches_to_zero()  # counters to 0 just before the path
    free_before = torch.cuda.mem_get_info()[0] if cuda else 0
    out: dict = {"budgets": budgets}
    fleet = left = None
    try:
        fleet = soak.SoakFleet(
            bundle=served, device=device, block=O_BLOCK, n_new=O_NEW,
            plan_seeds=((O_SEED, O_SECONDS),), ready_timeout=O_CEILING_S)
        free_boot = torch.cuda.mem_get_info()[0] if cuda else 0
        cold = {n: http_json(r.url + "/healthz")["cold_start"]
                for n, r in fleet.pool.replicas.items()}
        stage("boot")
        log(f"path O (a) SoakFleet {list(soak.REPLICAS)} (r1 paged, 64 "
            f"pages, the offload tier) and the in-process reference: "
            f"{stages['boot']:.2f} s, {fleet.boot_s} [{card}]; cold_start "
            f"{json.dumps(cold)}; the card's free memory "
            f"{free_before / 2**30:.2f} GiB before, {free_boot / 2**30:.2f} "
            f"GiB after the boot")
        watch = _Routable(fleet.pool)
        rec = soak.run_window(fleet, seed=O_SEED, duration_s=O_SECONDS,
                              waiter_bound_s=O_WAITER_S,
                              recovery_s=O_RECOVERY_S, join_slack_s=O_JOIN_S,
                              on_stage=stage)
        events = watch.stop()
        kill = next(e for e in timeline if e.action == "kill")
        log(f"path O (b) seed {O_SEED}, {O_SECONDS:.0f} s: ok {rec['ok']}, "
            f"{rec['requests']} requests, tallies {rec['tallies']}, "
            f"violations {rec['violations']}")
        log(f"path O (c) timeline {rec['timeline_props']}, nemesis "
            f"{rec['nemesis_applied']} events applied, errors "
            f"{rec['nemesis_errors']}; JAX's timeline for the seed: "
            f"{rec['timeline'] == soak.render_timeline(timeline)}")
        log(f"path O (d) {kill.target} SIGKILLed at {kill.t:.3f} s; routable "
            f"and pid by the pool, seconds from the window's start: {events}; "
            f"recovery_s {rec['recovery_s']}, window_wall_s "
            f"{rec['window_wall_s']}, stages {stages} [{card}]")
        log(f"path O (e) canary {rec['canary']}, spill depth "
            f"{rec['spill_depth']}")
        if not rec["ok"] or rec["tallies"]["silent"] \
                or rec["canary"] != {"normal_ok": True,
                                     "suppressed_fails": True} \
                or rec["timeline"] != soak.render_timeline(timeline):
            raise SystemExit("path O (b)-(e): the soak window failed JAX's "
                             "oracle")
        # (f) the post-storm row on each replica alone, against the
        # reference, so that both replicas' engines run after the storm
        probe = [3, 1, 4, 1, 5, 9, 2, 6]
        want = fleet.ref_completion(probe, {}, O_NEW)
        alone = {}
        for name, r in fleet.pool.replicas.items():
            got = http_json(r.url + "/v1/completions",
                            {"prompt": probe, "max_tokens": O_NEW,
                             "temperature": 0})["choices"][0]["tokens"]
            alone[name] = got == want
        log(f"path O (f) the post-storm row sent to each replica alone, "
            f"bitwise the reference's: {alone}")
        if not all(alone.values()):
            raise SystemExit("path O (f): a replica's post-storm row differs")
        # (g) each process's launch identity: 225 x forwards, 32 x steps
        urls = {n: r.url for n, r in fleet.pool.replicas.items()}
        urls["reference"] = fleet.ref_url
        got, implied = {}, {}
        for _ in range(20 if cuda else 1):
            metrics = {n: http_json(u + "/metrics") for n, u in urls.items()}
            ids = {n: _launch_identity({n: m}, cfg.layers)
                   for n, m in metrics.items()}
            got = {n: v[0] for n, v in ids.items()}
            implied = {n: v[1] for n, v in ids.items()}
            if got == implied:
                break
            time.sleep(0.5)
        for n in ids:
            log(f"path O (g) {n}: handler.kernels {got[n]}, implied "
                f"{implied[n]} ({ids[n][2]})")
        if cuda and (got != implied or not all(
                got[n][k] for n, k in (
                    (soak.REPLICAS[0], "decode_attention"),
                    (soak.REPLICAS[1], "paged_decode_attention"),
                    (soak.REPLICAS[0], "int8_matmul"),
                    (soak.REPLICAS[1], "int8_matmul")))):
            raise SystemExit("path O (g): the launch identity fails, or a "
                             "replica launched none of its kernels")
        local = kernel_launches()
        out["launches"] = {k: local[k] + sum(got[n][k] for n in soak.REPLICAS)
                           for k in KERNELS}
        out.update(record=rec,
                   routable=events, alone=alone, cold_start=cold,
                   boot_s=fleet.boot_s, free_before=free_before,
                   free_boot=free_boot)
    finally:
        if fleet is not None:
            fleet.close()
            shutil.rmtree(fleet.tmp, ignore_errors=True)
        left = _bundle_processes(served)
        for pid in left:  # a failed stage's leftovers
            subprocess.run(["kill", "-9", str(pid)], check=False)
        shutil.rmtree(root, ignore_errors=True)
    # (h) teardown
    del fleet
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    free_after = torch.cuda.mem_get_info()[0] if cuda else 0
    stage("teardown")
    log(f"path O (h) SoakFleet.close: soak processes alive {left}; the "
        f"card's free memory {free_before / 2**30:.2f} GiB before O, "
        f"{free_after / 2**30:.2f} GiB after [{card}]; stages {stages}, "
        f"{time.perf_counter() - t0:.1f} s of the {O_CEILING_S:.0f} s "
        f"ceiling")
    if left or (cuda and free_after < free_before - O_FREE_SLACK):
        raise SystemExit("path O (h): the teardown left processes or card "
                         "memory behind")
    out.update(stages=stages, free_after=free_after, left=left)
    return out


# path P: a HuggingFace checkpoint at Llama-3-8B's published widths, cut to
# HF_LAYERS of its 32 layers, written by the script's own safetensors
# writer beside the kernel checks, converted at build by the port
# (models/convert.py save_hf_params, int8) and served from the bundle
HF_LAYERS = 2
HF_CONFIG = {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
             "vocab_size": 128256, "hidden_size": 4096,
             "intermediate_size": 14336, "num_hidden_layers": HF_LAYERS,
             "num_attention_heads": 32, "num_key_value_heads": 8,
             "head_dim": 128, "max_position_embeddings": 8192,
             "rope_theta": 500000.0, "rms_norm_eps": 1e-5,
             "tie_word_embeddings": False, "attention_bias": False,
             "mlp_bias": False, "hidden_act": "silu",
             "torch_dtype": "bfloat16", "bos_token_id": 128000,
             "eos_token_id": 128001}
HF_SEED = 24
HF_PROMPTS = (37, 100, 300, 700)  # P's 4 concurrent requests
HF_NEW = 16
HF_EXTRA = {**ENGINE_EXTRA, "max_new_tokens": str(HF_NEW),
            "prefix_cache_mb": "0"}
# one forward of a dense HF_LAYERS-layer Llama: 7 projections a layer and
# the lm_head on the int8 kernel; a decode step: one decode-attention
# launch a layer
HF_MATMULS = 7 * HF_LAYERS + 1


def hf_tensors(seed: int) -> dict:
    """Llama-3-8B's HF tensors (``modeling_llama`` names, ``[out, in]``
    Linear weights) at ``HF_LAYERS`` layers, bf16, on the host: seeded
    normals, ``1/sqrt(in)`` for the projections and the lm_head, 0.02 for
    the embedding, norm gains near 1."""
    gen = torch.Generator().manual_seed(seed)
    h, m, v = HF_CONFIG["hidden_size"], HF_CONFIG["intermediate_size"], \
        HF_CONFIG["vocab_size"]
    kv = HF_CONFIG["num_key_value_heads"] * HF_CONFIG["head_dim"]

    def lin(n_out, n_in):
        return (torch.randn(n_out, n_in, generator=gen)
                / math.sqrt(n_in)).to(torch.bfloat16)

    def gain():
        return (1.0 + 0.1 * torch.randn(h, generator=gen)).to(torch.bfloat16)

    out = {"model.embed_tokens.weight":
           (0.02 * torch.randn(v, h, generator=gen)).to(torch.bfloat16)}
    for i in range(HF_LAYERS):
        p = f"model.layers.{i}"
        out.update({
            f"{p}.input_layernorm.weight": gain(),
            f"{p}.self_attn.q_proj.weight": lin(h, h),
            f"{p}.self_attn.k_proj.weight": lin(kv, h),
            f"{p}.self_attn.v_proj.weight": lin(kv, h),
            f"{p}.self_attn.o_proj.weight": lin(h, h),
            f"{p}.post_attention_layernorm.weight": gain(),
            f"{p}.mlp.gate_proj.weight": lin(m, h),
            f"{p}.mlp.up_proj.weight": lin(m, h),
            f"{p}.mlp.down_proj.weight": lin(h, m)})
    out["model.norm.weight"] = gain()
    out["lm_head.weight"] = lin(v, h)
    return out


def write_safetensors(path: Path, tensors: dict) -> int:
    """The safetensors format by hand: an 8-byte little-endian header
    length, the JSON header (dtype, shape, ``data_offsets``), padded with
    spaces to 8 bytes, then each bf16 tensor's raw bytes in order.
    Returns the file's bytes."""
    import struct

    header, off = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": "BF16", "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    header["__metadata__"] = {"format": "pt"}
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            f.write(t.contiguous().view(torch.int16).numpy().data)
    return 8 + len(raw) + off


class HfCheckpointWriter(threading.Thread):
    """Path P's host work, beside the kernel checks: writes the checkpoint
    into ``root`` (``config.json``, two safetensors shards, the embedding
    and layer 0 then the rest, and ``model.safetensors.index.json``),
    builds the bundle's params from it (``save_hf_params(quant="int8")``
    into ``root.parent / "bundle" / "params"``) and holds the converted
    float tree against the written tensors transposed.
    :meth:`result` joins it and returns ``(tensors, record)``."""

    def __init__(self, root: Path):
        super().__init__(name="hf-checkpoint-writer", daemon=True)
        self.root, self.error, self.out = root, None, None

    def run(self):
        try:
            from lambdipy_tpu_torch.models.convert import (import_hf_llama,
                                                           save_hf_params)
            from lambdipy_tpu_torch.models.params import from_jax_params

            t0 = time.perf_counter()
            tensors = hf_tensors(HF_SEED)
            draw_s = time.perf_counter() - t0
            self.root.mkdir(parents=True, exist_ok=True)
            (self.root / "config.json").write_text(json.dumps(HF_CONFIG))
            names = list(tensors)
            cut_at = names.index("model.layers.1.input_layernorm.weight")
            shards = {"model-00001-of-00002.safetensors": names[:cut_at],
                      "model-00002-of-00002.safetensors": names[cut_at:]}
            total, weight_map = 0, {}
            for shard, keys in shards.items():
                total += write_safetensors(self.root / shard,
                                           {k: tensors[k] for k in keys})
                weight_map.update(dict.fromkeys(keys, shard))
            (self.root / "model.safetensors.index.json").write_text(
                json.dumps({"metadata": {"total_size": sum(
                    t.numel() * t.element_size() for t in tensors.values())},
                    "weight_map": weight_map}))
            wall_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            info = save_hf_params(self.root,
                                  self.root.parent / "bundle" / "params",
                                  quant="int8")
            build_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            got = from_jax_params(import_hf_llama(self.root)[1])
            want = hf_port_keys(tensors)
            unequal = sorted(set(got) ^ set(want)) + [
                k for k in want if k in got and (
                    got[k].dtype != want[k].dtype
                    or not torch.equal(got[k], want[k]))]
            del got
            self.out = (tensors, {
                "bytes": total, "draw_s": draw_s, "wall_s": wall_s,
                "build_s": build_s, "params_info": info,
                "tree_tensors": len(want), "tree_unequal": unequal,
                "tree_check_s": time.perf_counter() - t0})
        except BaseException as e:  # noqa: BLE001 - reported by result()
            self.error = e

    def result(self) -> tuple:
        self.join()
        if self.error is not None:
            raise SystemExit(f"path P: the checkpoint's writer or build "
                             f"failed: {type(self.error).__name__}: "
                             f"{self.error}")
        return self.out


def hf_port_keys(tensors: dict) -> dict:
    """The written HF tensors under the port's keys in the flax layout
    (kernels ``[in, out]``): the mapping written out here, not through
    ``models/convert.py``."""
    out = {"embed.embedding": tensors["model.embed_tokens.weight"],
           "final_norm.scale": tensors["model.norm.weight"],
           "lm_head.kernel": tensors["lm_head.weight"].T}
    names = {"attn_norm.scale": "input_layernorm.weight",
             "mlp_norm.scale": "post_attention_layernorm.weight",
             **{f"{p}_proj.kernel": f"self_attn.{p}_proj.weight"
                for p in "qkvo"},
             **{f"{p}_proj.kernel": f"mlp.{p}_proj.weight"
                for p in ("gate", "up", "down")}}
    for i in range(HF_LAYERS):
        for ours, theirs in names.items():
            t = tensors[f"model.layers.{i}.{theirs}"]
            out[f"layer_{i}.{ours}"] = t.T if ours.endswith("kernel") else t
    return out


def nested(flat: dict) -> dict:
    """Port keys (``layer_0.q_proj.kernel``) as the nested tree the JAX
    layout's functions take."""
    tree: dict = {}
    for key, t in flat.items():
        *parents, leaf = key.split(".")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = t
    return tree


def _concurrent_engine(engine, prompts, n_new: int) -> list:
    """``prompts`` through ``engine.generate`` at once, one thread each,
    logprobs on."""
    out = [None] * len(prompts)

    def run(i):
        try:
            out[i] = engine.generate(prompts[i], max_new_tokens=n_new,
                                     return_logprobs=True)
        except BaseException as e:  # noqa: BLE001 - raised below
            out[i] = e

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    for o in out:
        if not isinstance(o, tuple):
            raise SystemExit(f"an engine request failed: {o!r}")
    return out


def _launch_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in KERNELS}


def _check_launches(what: str, got: dict, want: dict) -> None:
    want = {k: want.get(k, 0) for k in KERNELS}
    log(f"{what} launch counters: {got}, implied {want}")
    if got != want:
        raise SystemExit(f"{what}: launch counters {got} != implied {want}")


def serve_hf_path(card: str, writer: HfCheckpointWriter) -> dict:
    """Path P: (a) the checkpoint written beside the kernel checks; (b)
    the bundle built from it (``save_hf_params(quant="int8")``, manifest,
    ``handler.py``); (c) the converted tree bitwise the written tensors
    transposed, the int8 params bitwise ``quantize_params`` on the card;
    (d) ``load_bundle`` on the card (``llama-hf`` rebuilt from
    ``params_info.config``); (e) 4 concurrent requests through its engine
    bitwise their solo ``generate``, and the tokens bitwise a
    ``HF_LAYERS``-layer ``llama3-8b`` server loading the same
    ``params.fpk`` through ``models/params.py``; the launch identity of
    each phase."""
    import shutil

    from lambdipy_tpu_torch.bundle import flatpack
    from lambdipy_tpu_torch.models import registry
    from lambdipy_tpu_torch.models.llama import quantize_params
    from lambdipy_tpu_torch.models.params import from_jax_params
    from lambdipy_tpu_torch.runtime.handlers import kernel_launches
    from lambdipy_tpu_torch.runtime.loader import load_bundle

    tensors, wrote = writer.result()
    ckpt = writer.root
    info = wrote["params_info"]
    log(f"path P (a): Llama-3-8B's HF checkpoint at {HF_LAYERS} layers, bf16: "
        f"{wrote['bytes']:,} B in 2 safetensors shards and their index, "
        f"drawn in {wrote['draw_s']:.2f} s, drawn and written in "
        f"{wrote['wall_s']:.2f} s beside the kernel checks")
    bundle = ckpt.parent / "bundle"
    try:
        fpk = bundle / "params" / "params.fpk"
        log(f"path P (b): save_hf_params(quant='int8') read, converted, "
            f"quantized and wrote {fpk.stat().st_size:,} B of params.fpk in "
            f"{wrote['build_s']:.2f} s beside the kernel checks; "
            f"params_info.config {info['config']}")
        spec = {"recipe": "chip-smoke-hf-llama3-8b", "model": "llama-hf",
                "params": "hf", "dtype": "bfloat16", "batch_size": 1,
                "mesh": {}, "quant": "int8",
                "extra": {**HF_EXTRA, "hf_path": str(ckpt)}, "device": "any"}
        write_bundle(bundle, spec, "generate_handler", card,
                     params_info=info, base="torch", label="P")

        PROGRESS["stage"] = "trees"
        t0 = time.perf_counter()
        unequal = wrote["tree_unequal"]
        q_want = from_jax_params(quantize_params(nested(
            {k: v.to("cuda") for k, v in hf_port_keys(tensors).items()})))
        q_got = flatpack.load_state_dict(fpk, "cuda")
        q_unequal = [k for k in q_want if q_got[k].dtype != q_want[k].dtype
                     or not torch.equal(q_got[k], q_want[k])]
        n_tree = wrote["tree_tensors"]
        log(f"path P (c): converted tree {n_tree - len(unequal)} of "
            f"{n_tree} tensors bitwise the written ones "
            f"transposed (checked in {wrote['tree_check_s']:.2f} s beside the "
            f"kernel checks); params.fpk {len(q_want) - len(q_unequal)} of "
            f"{len(q_want)} tensors bitwise quantize_params on the card "
            f"({time.perf_counter() - t0:.2f} s)")
        if unequal or set(q_got) != set(q_want) or q_unequal:
            raise SystemExit(f"path P (c): trees differ: {unequal[:3]} "
                             f"{q_unequal[:3]}")
        del tensors
        gc.collect()

        PROGRESS["stage"] = "boot"
        set_launches_to_zero()  # counters to 0 just before the path
        t0 = time.perf_counter()
        boot = load_bundle(bundle, device="cuda")
        boot_s = time.perf_counter() - t0
        state = boot.state
        server, engine = state.server, state.engine
        cfg = server.model.cfg
        arch = {f: getattr(cfg, f) for f in info["config"]}
        arch["rope_scaling"] = None if cfg.rope_scaling is None \
            else list(cfg.rope_scaling)
        loaded = server.model.state_dict()
        l_unequal = [k for k, t in q_want.items()
                     if not torch.equal(loaded[k], t.to(loaded[k].dtype))]
        log(f"path P (d): load_bundle in {boot_s:.2f} s (stages "
            f"{boot.stages}); llama-hf at {cfg.layers} layers, "
            f"{cfg.hidden} wide, vocab {cfg.vocab_size}, "
            f"{cfg.attn_backend} / {cfg.matmul_backend}; "
            f"{len(q_want) - len(l_unequal)} of {len(q_want)} tensors the "
            f"written ones")
        if arch != info["config"] or l_unequal or engine is None:
            raise SystemExit(f"path P (d): the booted model is not the "
                             f"checkpoint's: {arch} {l_unequal[:3]}")
        del q_got, q_want, loaded

        PROGRESS["stage"] = "engine"
        rng = torch.Generator().manual_seed(HF_SEED)
        prompts = [torch.randint(1, cfg.vocab_size, (n,),
                                 generator=rng).tolist() for n in HF_PROMPTS]
        l0 = kernel_launches()
        before = engine.stats()
        t0 = time.perf_counter()
        rows = _concurrent_engine(engine, prompts, HF_NEW)
        burst_s = time.perf_counter() - t0
        after = engine.stats()
        l1 = kernel_launches()
        steps = after["steps"] - before["steps"]
        forwards = after["forwards"] - before["forwards"]
        _check_launches("path P (e) engine", _launch_delta(l0, l1), {
            "int8_matmul": HF_MATMULS * forwards,
            "paged_decode_attention": HF_LAYERS * steps})
        solo = [server.generate(p, max_new_tokens=HF_NEW,
                                return_logprobs=True) for p in prompts]
        l2 = kernel_launches()
        _check_launches("path P (e) solo", _launch_delta(l1, l2), {
            "int8_matmul": HF_MATMULS * HF_NEW * len(prompts),
            "decode_attention": HF_LAYERS * (HF_NEW - 1) * len(prompts)})
        same = [np.array_equal(r[0], s[0]) and np.array_equal(r[1], s[1])
                for r, s in zip(rows, solo)]
        log(f"path P (e): 4 concurrent requests ({HF_PROMPTS} prompt "
            f"tokens, {HF_NEW} new) through the paged engine in "
            f"{burst_s:.2f} s ({steps} steps, {forwards} forwards): "
            f"{sum(same)} of 4 rows bitwise their solo generate (tokens "
            f"and logprobs) [{card}]")
        if not all(same):
            raise SystemExit("path P (e): engine rows differ from solo")
        del boot, state, server, engine
        gc.collect()
        torch.cuda.empty_cache()

        PROGRESS["stage"] = "llama3-8b"
        ref_adapter = registry.get("llama3-8b").build(
            dtype="bfloat16", quant="int8",
            extra={"layers": str(HF_LAYERS)})
        ref = ref_adapter.make_server(
            ref_adapter.load_params(bundle / "params", device="cuda"),
            device="cuda")
        ref_rows = [ref.generate(p, max_new_tokens=HF_NEW,
                                 return_logprobs=True) for p in prompts]
        l3 = kernel_launches()
        _check_launches("path P (e) llama3-8b", _launch_delta(l2, l3), {
            "int8_matmul": HF_MATMULS * HF_NEW * len(prompts),
            "decode_attention": HF_LAYERS * (HF_NEW - 1) * len(prompts)})
        ref_same = [np.array_equal(r[0], s[0]) and np.array_equal(r[1], s[1])
                    for r, s in zip(ref_rows, solo)]
        log(f"path P (e): {sum(ref_same)} of 4 rows of a {HF_LAYERS}-layer "
            f"llama3-8b server loading the same params.fpk through "
            f"models/params.py bitwise llama-hf's (tokens and logprobs); "
            f"greedy tokens of the first {solo[0][0][0][:8].tolist()}")
        if not all(ref_same):
            raise SystemExit("path P (e): llama-hf and llama3-8b differ")
        del ref
    finally:
        shutil.rmtree(ckpt.parent, ignore_errors=True)
    return {"checkpoint": {k: v for k, v in wrote.items()
                           if k != "params_info"},
            "boot_s": boot_s, "burst_s": burst_s, "params_info": info,
            "steps": steps,
            "forwards": forwards, "launches": l3}


# path Q: llama3-8b (int8, bf16) with Mixtral-8x7B's experts: 8, top 2,
# hidden 4,096, expert width 14,336, at HF_LAYERS of its 32 layers, the
# weights drawn on the card
Q_EXTRA = {"moe_experts": "8", "layers": str(HF_LAYERS)}
Q_NEW = 16
Q_PROMPT = 200
Q_PLAIN = {"attn_backend": "dense", "matmul_backend": "xla"}
# the kernel routes against the plain ones, last-position logits of the
# prefill and of 16 teacher-forced decode steps (measured on the card)
Q_COSINE_MIN, Q_REL_MAX = 0.999, 0.05
# one forward of the MoE model: q, k, v, o a layer and the lm_head on the
# int8 kernel; the experts dequantize into a bf16 einsum
Q_MATMULS = 4 * HF_LAYERS + 1


def q_route_counts(model, toks, mask) -> dict:
    """Each MoE layer's routing of a prefill's tokens, padding included
    (as JAX): the seats ``route`` takes against an independent count, per
    group and expert, of the valid tokens that pick the expert: seated =
    sum(min(demand, capacity)), dropped = sum(max(demand - capacity, 0)),
    seated + dropped = top_k x valid tokens."""
    from lambdipy_tpu_torch.models.moe import _top_k

    seen = {}
    hooks = [blk.moe.register_forward_pre_hook(
        lambda mod, args, i=i: seen.__setitem__(i, args[0]))
        for i, blk in enumerate(model.blocks())]
    try:
        with torch.inference_mode():
            model(toks, mask=mask)
    finally:
        for h in hooks:
            h.remove()
    out = []
    with torch.inference_mode():
        for i, x in sorted(seen.items()):
            moe = model.blocks()[i].moe
            b, s, hidden = x.shape
            t = b * s
            gs, g, cap = moe.capacity(t)
            dispatch, _, _ = moe.route(x)
            probs = torch.softmax(x.reshape(t, hidden).float() @ moe.router,
                                  -1)
            _, idx = _top_k(probs, moe.top_k)
            idx = torch.nn.functional.pad(idx, (0, 0, 0, g * gs - t),
                                          value=-1).reshape(g, gs, -1)
            demand = torch.stack([(idx == e).sum((1, 2)) for e in
                                  range(moe.num_experts)], -1)  # [g, e]
            seated = int(dispatch.sum())
            want = int(demand.clamp(max=cap).sum())
            dropped = int((demand - cap).clamp(min=0).sum())
            one_seat = bool(dispatch.sum(1).max() <= 1)
            out.append({"layer": i, "tokens": t, "groups": g,
                        "capacity": cap, "seated": seated,
                        "dropped": dropped, "seated_expected": want,
                        "one_token_per_seat": one_seat})
            if seated != want or seated + dropped != moe.top_k * t \
                    or not one_seat:
                raise SystemExit(f"path Q (b): layer {i} routes {seated} "
                                 f"seats, {dropped} dropped, against "
                                 f"{want} of {moe.top_k} x {t}")
    return out


def q_compare(served, plain, tokens) -> dict:
    """Last-position logits of the prefill and of ``Q_NEW`` teacher-forced
    decode steps, the kernel routes against the plain ones on the same
    weights: every value finite, cosine and max |diff| / max |logit|."""
    from lambdipy_tpu_torch.models.llama import prefill_into_cache

    dev = served.device
    toks = torch.tensor([tokens], device=dev)
    s = toks.shape[1]
    last = torch.tensor([s - 1], device=dev)
    cos_min, rel_max, argmax_same, finite = 1.0, 0.0, 0, True
    with torch.inference_mode():
        caches, logits = {}, {}
        for name, model in (("served", served), ("plain", plain)):
            lg, pc = model(toks, logit_positions=last)
            caches[name] = prefill_into_cache(model.cfg, pc, 1, s + Q_NEW, s)
            logits[name] = lg[:, -1].float()
            del pc
        nxt = logits["plain"].argmax(-1)
        for step in range(Q_NEW + 1):
            a, b = logits["served"].flatten(), logits["plain"].flatten()
            finite = finite and bool(torch.isfinite(a).all())
            cos = torch.nn.functional.cosine_similarity(a, b, dim=0).item()
            rel = ((a - b).abs().max() / b.abs().max()).item()
            cos_min, rel_max = min(cos_min, cos), max(rel_max, rel)
            argmax_same += int(a.argmax() == b.argmax())
            if step == Q_NEW:
                break
            pos = torch.full((1,), s + step, dtype=torch.int32, device=dev)
            for name, model in (("served", served), ("plain", plain)):
                for entry in caches[name]:
                    entry["index"] = pos
                lg, _ = model(nxt[:, None], positions=pos[:, None],
                              cache=caches[name])
                logits[name] = lg[:, -1].float()
            nxt = logits["plain"].argmax(-1)
    return {"finite": finite, "cosine_min": cos_min, "rel_max": rel_max,
            "argmax_same": argmax_same, "positions": Q_NEW + 1}


def serve_moe_path(card: str) -> dict:
    """Path Q: (a) the prefill and 16 decode steps finite, the kernel
    routes against the plain ones on the card; (b) each layer's route
    counts exact; (c) a burst of 4 concurrent requests through a handler's
    paged engine completes, its launch identity 9 int8 matmuls a forward
    and 2 decode-attention launches a step; (d) the step time and the
    experts' per-call dequantisation."""
    from lambdipy_tpu_torch.models import registry
    from lambdipy_tpu_torch.runtime.handlers import (HandlerContext,
                                                     generate_handler,
                                                     kernel_launches)

    set_launches_to_zero()  # counters to 0 just before the path
    adapter = registry.get("llama3-8b").build(dtype="bfloat16",
                                              quant="int8", extra=Q_EXTRA)
    cfg = adapter.config
    t0 = time.perf_counter()
    sd = adapter.init_params(seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    experts = sum(t.numel() for k, t in sd.items() if ".moe.experts_" in k
                  and k.endswith("_int8"))
    total = sum(t.numel() * t.element_size() for t in sd.values())
    log(f"path Q: llama3-8b with moe_experts {cfg.moe_experts}, top "
        f"{cfg.moe_top_k}, expert width {cfg.mlp}, {cfg.layers} layers, "
        f"int8: experts {experts:,} B, the model {total:,} B, drawn on the "
        f"card in {init_s:.2f} s")
    served = adapter.make_model(sd, device="cuda")
    plain = registry.get("llama3-8b").build(
        dtype="bfloat16", quant="int8", extra={**Q_EXTRA, **Q_PLAIN}
    ).make_model(sd, device="cuda")
    rng = torch.Generator().manual_seed(31)
    prompt = torch.randint(1, cfg.vocab_size, (Q_PROMPT,),
                           generator=rng).tolist()

    PROGRESS["stage"] = "kernel vs plain"
    cmp = q_compare(served, plain, prompt)
    log(f"path Q (a): prefill of {Q_PROMPT} tokens and {Q_NEW} decode "
        f"steps finite: {cmp['finite']}; blocked / pallas against dense / "
        f"xla: logit cosine min {cmp['cosine_min']:.6f} (tolerance >= "
        f"{Q_COSINE_MIN}), max |diff| / max |logit| {cmp['rel_max']:.4f} "
        f"(tolerance <= {Q_REL_MAX}), argmax equal at {cmp['argmax_same']} "
        f"of {cmp['positions']} positions [{card}]")
    if not cmp["finite"] or cmp["cosine_min"] < Q_COSINE_MIN \
            or cmp["rel_max"] > Q_REL_MAX:
        raise SystemExit("path Q (a): the kernel routes disagree with the "
                         "plain ones")

    PROGRESS["stage"] = "route counts"
    toks = torch.randint(1, cfg.vocab_size, (2, 300), generator=rng).cuda()
    mask = torch.ones_like(toks, dtype=torch.bool)
    mask[1, 180:] = False
    counts = q_route_counts(served, toks, mask)
    log(f"path Q (b): route counts exact in every layer: " + "; ".join(
        f"layer {c['layer']}: {c['seated']} seated + {c['dropped']} "
        f"dropped = {cfg.moe_top_k} x {c['tokens']} tokens ({c['groups']} "
        f"groups, capacity {c['capacity']})" for c in counts))
    del plain
    gc.collect()

    PROGRESS["stage"] = "burst"
    spec = {"model": "llama3-8b", "dtype": "bfloat16", "quant": "int8",
            "extra": {**ENGINE_EXTRA, **Q_EXTRA, "prefix_cache_mb": "0",
                      "max_new_tokens": str(Q_NEW)}}
    state = generate_handler(spec, HandlerContext(device="cuda",
                                                  state_dict=sd))
    engine = state.engine
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=rng).tolist()
               for n in (24, 100, 300, 700)]
    l0 = kernel_launches()
    before = engine.stats()
    t0 = time.perf_counter()
    rows = _concurrent_engine(engine, prompts, Q_NEW)
    burst_s = time.perf_counter() - t0
    after = engine.stats()
    steps = after["steps"] - before["steps"]
    forwards = after["forwards"] - before["forwards"]
    _check_launches("path Q (c) engine", _launch_delta(l0, kernel_launches()),
                    {"int8_matmul": Q_MATMULS * forwards,
                     "paged_decode_attention": HF_LAYERS * steps})
    done = [r[0].shape == (1, Q_NEW) and bool(np.isfinite(r[1]).all())
            for r in rows]
    log(f"path Q (c): a burst of 4 concurrent requests (24-700 prompt "
        f"tokens, {Q_NEW} new) through the paged engine completed in "
        f"{burst_s:.2f} s: {sum(done)} of 4 rows whole and finite "
        f"({steps} steps, {forwards} forwards) [{card}]")
    if not all(done):
        raise SystemExit("path Q (c): the burst did not complete")

    PROGRESS["stage"] = "step time"
    server = state.server
    rate = decode_rate(server.generate, [prompt], tokens=64)
    step_ms = 1e3 / rate
    moes = [blk.moe for blk in server.model.blocks()]

    def dequant(_):
        for moe in moes:
            for name in ("experts_gate", "experts_up", "experts_down"):
                moe.expert_weight(name)

    with torch.inference_mode():
        dequant_ms = cuda_time(dequant)
    log(f"path Q (d): batch-1 decode {rate:.1f} tok/s, {step_ms:.3f} ms a "
        f"step (graphs); the experts' per-call dequantisation "
        f"{dequant_ms:.3f} ms a step ({HF_LAYERS} layers x 3 stacks of "
        f"{cfg.moe_experts} x {cfg.hidden} x {cfg.mlp} int8 to bf16), "
        f"{dequant_ms / step_ms:.2f} of the step [{card}]")
    launches = kernel_launches()
    del state, server, engine, served, sd, moes
    gc.collect()
    torch.cuda.empty_cache()
    return {"init_s": init_s, "expert_bytes": experts, "model_bytes": total,
            "compare": cmp, "route_counts": counts, "burst_s": burst_s,
            "steps": steps, "forwards": forwards, "decode_tok_s": rate,
            "step_ms": step_ms, "dequant_ms": dequant_ms,
            "launches": launches}


# path R: training at llama3-8b's widths, 2 of its 32 layers, bf16 float
# weights (JAX trains float models only), batch 4 x 512 tokens
R_LAYERS = 2
R_EXTRA = {"layers": str(R_LAYERS)}
R_BATCH, R_SEQ, R_STEPS = 4, 512, 8
R_LR = 3e-4
# (c): the f32 llama-tiny on the card against the CPU, four steps; the
# same f32 math (TF32 off) in another summation order
R_TINY_TOL = 1e-4
# (f): two gloo CPU ranks of llama-tiny at dp=2 under FSDP against one
# process, each metric relative to max(1, |metric|) and each param to its
# leaf's largest magnitude (tests/test_torch_distributed.py's SOLO_TOL:
# the same f32 math, each rank's gradient reduced over the two)
R_RANKS_TOL = 1e-6
R_RANKS = Path(__file__).resolve().parent / "tests" / "torch_ranks.py"


class _StepClock:
    """A trainer's step function, timed: each call synchronized and its
    wall and metrics recorded (the script's instrumentation; the trainer
    syncs on its logging steps anyway, and R logs every step). Its
    ``shardings`` and ``mesh`` are the step's."""

    def __init__(self, fn):
        self.fn, self.walls, self.metrics = fn, [], []
        self.shardings, self.mesh = fn.shardings, fn.mesh

    def __call__(self, state, batch):
        t0 = time.perf_counter()
        out = self.fn(state, batch)
        torch.cuda.synchronize()
        self.walls.append(time.perf_counter() - t0)
        self.metrics.append(out[1])
        return out


def _r_trainer(adapter, weights, tokens_path: Path, total: int,
               ckpt_dir=None, *, device="cuda", seed: int = 0,
               batch: int = R_BATCH, seq: int = R_SEQ, lr: float = R_LR,
               mesh=None, fsdp: bool = True):
    from lambdipy_tpu_torch.data import ShardedLoader, TokenSource
    from lambdipy_tpu_torch.models.params import train_params
    from lambdipy_tpu_torch.train.loop import Trainer, TrainerConfig

    loader = ShardedLoader(TokenSource(tokens_path, seq), batch, seed=seed)
    # one checkpoint kept: the directory's first offered step saves (orbax's
    # cadence), so (b) writes three, and at most two are on disk at once
    cfg = TrainerConfig(total_steps=total, log_every=1, ckpt_every=R_STEPS,
                        keep_ckpts=1, learning_rate=lr, grad_clip=1.0,
                        fsdp=fsdp)
    trainer = Trainer(adapter.train_forward, train_params(weights), loader,
                      cfg, device=device, mesh=mesh, rules=adapter.tp_rules,
                      ckpt_dir=ckpt_dir)
    trainer.step_fn = _StepClock(trainer.step_fn)
    return trainer


def _state_equal(a, b) -> bool:
    """Two train states bitwise: every param, every optimizer leaf, the
    step."""
    from lambdipy_tpu_torch.train.checkpoint import tree_paths

    la, lb = dict(tree_paths(a)), dict(tree_paths(b))
    return la.keys() == lb.keys() and all(torch.equal(la[k], lb[k])
                                          for k in la)


def serve_train_path(card: str) -> dict:
    """Path R, training: (a) eight steps of llama3-8b at its published
    widths, 2 of 32 layers, bf16, from one seed, through the port's
    ``Trainer`` on a token file the script writes: the loss falls; each
    step's wall, the median after the first, tokens/s, 6 N T over the
    step at 989 TFLOP/s and the peak memory; (b) the same eight steps as
    4, a checkpoint and a new ``Trainer`` resuming to 8: params, optimizer
    state and logged rows bitwise (a)'s; the checkpoint's bytes, save and
    restore times; (c) the f32 ``llama-tiny`` trained four steps on the
    card and on the CPU from one state: losses and grad norms within
    ``R_TINY_TOL``; (e) the one-device identities at (a)'s widths: four
    steps under ``make_mesh({"dp": 1})`` with FSDP and no process group,
    and under a one-rank NCCL group with ``make_mesh({"dp": -1})``, FSDP
    on and off (every collective run), each bitwise (b)'s first four
    steps: params, optimizer state, step and metrics; (f) host only, beside
    (a)-(e): two gloo CPU ranks of ``llama-tiny`` at ``dp=2`` under FSDP,
    four steps, within ``R_RANKS_TOL`` of one process (the host has one
    card, so no multi-card figure is taken); (d) every kernel's launch
    counter moves by 0."""
    import shutil
    import statistics
    import tempfile

    from lambdipy_tpu_torch.models import registry
    from lambdipy_tpu_torch.runtime.handlers import kernel_launches
    from lambdipy_tpu_torch.train import checkpoint

    set_launches_to_zero()  # counters to 0 just before the path
    root = Path(tempfile.mkdtemp(prefix="lambdipy-train-"))
    log(f"path R: {shutil.disk_usage(root).free:,} B free where the "
        f"checkpoints go")
    ranks = _start_r_ranks(root / "ranks")
    try:
        adapter = registry.get("llama3-8b").build(dtype="bfloat16",
                                                  quant=None, extra=R_EXTRA)
        cfg = adapter.config
        rng = np.random.default_rng(0)
        tokens = root / "tokens.npy"
        np.save(tokens, rng.integers(0, cfg.vocab_size,
                                     2 * R_STEPS * R_BATCH * (R_SEQ + 1))
                .astype(np.int32))
        t0 = time.perf_counter()
        weights = adapter.init_params(seed=0, device="cuda")
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in weights.values())
        n_matmul = n_params - weights["embed.embedding"].numel()
        log(f"path R: llama3-8b at {R_LAYERS} of {FULL_LAYERS} layers, its "
            f"published widths, bf16 float weights ({n_params:,} params, "
            f"{sum(t.numel() * t.element_size() for t in weights.values()):,}"
            f" B), drawn on the card in {time.perf_counter() - t0:.2f} s; "
            f"batch {R_BATCH} x {R_SEQ} tokens, adamw at lr {R_LR} with the "
            f"clip at 1.0")

        PROGRESS["stage"] = "(a) eight steps"
        torch.cuda.reset_peak_memory_stats()
        solo = _r_trainer(adapter, weights, tokens, R_STEPS)
        solo_report = solo.run()
        peak = torch.cuda.max_memory_allocated()
        walls = solo.step_fn.walls
        losses = [r["loss"] for r in solo_report.history]
        step_s = statistics.median(walls[1:])
        tok_s = R_BATCH * R_SEQ / step_s
        flop = 6 * n_matmul * R_BATCH * R_SEQ
        log(f"path R (a): losses {losses}; step walls "
            f"{[round(w * 1e3, 2) for w in walls]} ms; median after the "
            f"first {step_s * 1e3:.2f} ms, {tok_s:,.0f} tokens/s, 6 N T = "
            f"{flop / 1e12:.2f} TFLOP a step (N = {n_matmul:,} params "
            f"outside the embedding) at {flop / step_s / BF16_PEAK:.3f} of "
            f"989 TFLOP/s; peak memory allocated {peak / 2**30:.2f} GiB "
            f"[{card}]")
        if not (losses[-1] < losses[0] and all(np.isfinite(losses))):
            raise SystemExit("path R (a): the loss did not fall")

        PROGRESS["stage"] = "(b) checkpoint and resume"
        ck = root / "ck"
        times = {"save": [], "restore": []}
        save, restore = (checkpoint.TrainCheckpointer.save,
                         checkpoint.TrainCheckpointer.restore)

        def timed(fn, key):
            # the calls that wrote or read a checkpoint (the cadence
            # declines most offered steps; a fresh directory restores none)
            def run(*args, **kw):
                t = time.perf_counter()
                out = fn(*args, **kw)
                if out is True or (isinstance(out, tuple)
                                   and out[0] is not None):
                    times[key].append(time.perf_counter() - t)
                return out
            return run

        checkpoint.TrainCheckpointer.save = timed(save, "save")
        checkpoint.TrainCheckpointer.restore = timed(restore, "restore")
        try:
            first = _r_trainer(adapter, weights, tokens, R_STEPS // 2, ck)
            first_rows = first.run().history
            # (e)'s reference: four steps without a mesh
            ref_state, ref_metrics = first.state, first.step_fn.metrics
            del first
            second = _r_trainer(adapter, weights, tokens, R_STEPS, ck,
                                seed=999)
            rows = second.run().history
        finally:
            checkpoint.TrainCheckpointer.save = save
            checkpoint.TrainCheckpointer.restore = restore
        ck_bytes = (ck / str(R_STEPS) / checkpoint.STATE_FILE).stat().st_size
        same = (second.resumed_from == R_STEPS // 2
                and first_rows + rows == solo_report.history
                and _state_equal(second.state, solo.state))
        log(f"path R (b): 4 steps, a checkpoint, a new Trainer resumed at "
            f"{second.resumed_from} to {R_STEPS}: params, optimizer state "
            f"and logged rows bitwise the uninterrupted run: {same}; a "
            f"checkpoint {ck_bytes:,} B, saves "
            f"{[round(t, 2) for t in times['save']]} s (steps "
            f"{sorted(int(p.name) for p in ck.iterdir())} kept), restores "
            f"{[round(t, 2) for t in times['restore']]} s [{card}]")
        if not same:
            raise SystemExit("path R (b): the resumed run is not bitwise "
                             "the uninterrupted one")
        del solo, second
        gc.collect()
        torch.cuda.empty_cache()

        PROGRESS["stage"] = "(e) one-device identities"
        t_e = time.perf_counter()
        identities = _r_identities(adapter, weights, tokens, root,
                                   ref_state, ref_metrics)
        log(f"path R (e): {identities}; took "
            f"{time.perf_counter() - t_e:.1f} s [{card}]")
        if not all(identities.values()):
            raise SystemExit("path R (e): a one-device mesh is not bitwise "
                             "no mesh")
        del weights, ref_state, ref_metrics
        gc.collect()
        torch.cuda.empty_cache()

        PROGRESS["stage"] = "(c) card against CPU"
        tiny = registry.get("llama-tiny").build()
        tiny_sd = tiny.init_params(seed=0, device="cpu")
        tiny_tokens = root / "tiny.npy"
        np.save(tiny_tokens, rng.integers(0, tiny.config.vocab_size, 8000)
                .astype(np.int32))
        runs = {}
        for device in ("cuda", "cpu"):
            runs[device] = _r_trainer(tiny, tiny_sd, tiny_tokens, 4,
                                      device=device, batch=4, seq=32,
                                      lr=3e-3).run().history
        worst = max(abs(g[k] - w[k]) / abs(w[k])
                    for g, w in zip(runs["cuda"], runs["cpu"])
                    for k in ("loss", "grad_norm"))
        log(f"path R (c): the f32 llama-tiny, four steps on the card and on "
            f"the CPU from one state: losses {[r['loss'] for r in runs['cuda']]}"
            f" / {[r['loss'] for r in runs['cpu']]}, the largest relative "
            f"difference of a loss or grad norm {worst:.2e} (tolerance "
            f"{R_TINY_TOL})")
        if not worst <= R_TINY_TOL:
            raise SystemExit("path R (c): the card's training disagrees "
                             "with the CPU's")

        PROGRESS["stage"] = "(f) two gloo ranks (host only)"
        t_f = time.perf_counter()
        rank_result = _wait_r_ranks(ranks)
        ranks = None
        log(f"path R (f), host only (the host has one card: no multi-card "
            f"figure): two gloo CPU ranks of llama-tiny at dp=2 under FSDP, "
            f"four steps against one process: {rank_result} (tolerance "
            f"{R_RANKS_TOL}); waited {time.perf_counter() - t_f:.1f} s for "
            f"them after (c)")
        if not (rank_result["metric_rel_diff"] <= R_RANKS_TOL
                and rank_result["param_rel_diff"] <= R_RANKS_TOL
                and rank_result["sharded"]):
            raise SystemExit("path R (f): two ranks disagree with one "
                             "process")
    finally:
        if ranks is not None:
            for proc in ranks[0]:
                proc.kill()
                proc.wait()
        shutil.rmtree(root, ignore_errors=True)

    launches = kernel_launches()
    log(f"path R (d): launch counters over R {launches} (training runs the "
        f"plain ops, as JAX's runs its dense / xla path)")
    if any(launches.values()):
        raise SystemExit("path R (d): a kernel launched during training")
    return {"step_walls_s": walls, "step_s": step_s, "tokens_per_s": tok_s,
            "flop_per_step": flop, "peak_bytes": peak, "losses": losses,
            "ckpt_bytes": ck_bytes, "save_s": times["save"],
            "restore_s": times["restore"], "tiny_rel_diff": worst,
            "identities": identities, "ranks": rank_result,
            "launches": launches}


def _r_identities(adapter, weights, tokens: Path, root: Path, ref_state,
                  ref_metrics) -> dict:
    """R (e): four steps under each one-device mesh, bitwise the no-mesh
    four steps (``ref_state``, ``ref_metrics``); each variant's state freed
    before the next. The one-rank NCCL group meets through a file store
    and is destroyed after."""
    import torch.distributed as dist

    from lambdipy_tpu_torch.parallel.mesh import make_mesh

    def same(trainer) -> bool:
        metrics = trainer.step_fn.metrics
        return (_state_equal(trainer.state, ref_state)
                and len(metrics) == len(ref_metrics)
                and all(m.keys() == r.keys()
                        and all(torch.equal(m[k], r[k]) for k in m)
                        for m, r in zip(metrics, ref_metrics)))

    def run(mesh, fsdp: bool) -> bool:
        trainer = _r_trainer(adapter, weights, tokens, R_STEPS // 2,
                             mesh=mesh, fsdp=fsdp)
        trainer.run()
        ok = same(trainer)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        return ok

    log(f"path R (e): torch {torch.__version__}, NCCL "
        f"{'.'.join(map(str, torch.cuda.nccl.version()))}")
    out = {"dp=1, fsdp, no group": run(make_mesh({"dp": 1}), True)}
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{root}/nccl-pg",
                            rank=0, world_size=1)
    try:
        for fsdp in (True, False):
            out[f"dp=-1, fsdp {'on' if fsdp else 'off'}, one-rank NCCL "
                f"group"] = run(make_mesh({"dp": -1}), fsdp)
    finally:
        dist.destroy_process_group()
    return out


def _start_r_ranks(workdir: Path):
    """R (f)'s two gloo CPU ranks (``tests/torch_ranks.py train``: rank 0
    trains one process first, then both train at dp=2 under FSDP),
    started now to run beside the card phases; no card is visible to
    them."""
    workdir.mkdir(parents=True)
    np.save(workdir / "tokens.npy", np.tile(np.arange(50, dtype=np.int32),
                                            80))
    cfg = json.dumps({"steps": 4, "variants": ["fsdp"]})
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(R_RANKS.parents[1])}
    procs = [subprocess.Popen(
        [sys.executable, str(R_RANKS), "train", str(workdir), str(rank), "2",
         cfg], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank in range(2)]
    return procs, workdir


def _wait_r_ranks(ranks) -> dict:
    """R (f)'s result: the largest metric difference over max(1, the
    one-process metric) and the largest param difference over its leaf's
    largest magnitude, two ranks against one process, whether FSDP split
    the params, and rank 0's own seconds (imports, the one-process run,
    joining the group, the dp=2 run)."""
    procs, workdir = ranks
    for proc in procs:
        _, err = proc.communicate(timeout=300)
        if proc.returncode:
            raise SystemExit(f"path R (f): a rank exited "
                             f"{proc.returncode}: {err[-2000:]}")
    out = torch.load(workdir / "train.pt")
    got, solo = out["fsdp"], out["solo"]
    metric_diff = max(abs(g[k] - w[k]) / max(1.0, abs(w[k]))
                      for g, w in zip(got["metrics"], solo["metrics"])
                      for k in w)
    param_diff = max(float((got["params"][k] - w).abs().max()
                           / w.abs().max())
                     for k, w in solo["params"].items())
    per_rank, total = got["device_bytes"]
    return {"metric_rel_diff": metric_diff, "param_rel_diff": param_diff,
            "sharded": per_rank < total, "rank_bytes": per_rank,
            "logical_bytes": total, "losses": [m["loss"]
                                               for m in got["metrics"]],
            "rank0_s": {k: round(v, 1) for k, v in out["timings"].items()}}


def main() -> int:
    t_script = PROGRESS["t0"]
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    start_guard()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    card = smi
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    from lambdipy_tpu_torch.ops import _build

    PROGRESS["path"] = "the kernels' build"
    build_s = _build.build_all()
    log(f"kernels built in {build_s:.1f} s")
    for name, text in _build.build_logs.items():
        log(f"--- nvcc {name}.cu\n{text.strip()}")

    import atexit
    import shutil
    import tempfile

    # path P's checkpoint, drawn and written on the host beside the kernel
    # checks; deleted after P
    hf_root = Path(tempfile.mkdtemp(prefix="lambdipy-hf-"))
    atexit.register(shutil.rmtree, hf_root, True)
    hf_writer = HfCheckpointWriter(hf_root / "ckpt")
    hf_writer.start()
    t_phase = time.perf_counter()
    PROGRESS["path"] = "the kernel checks"
    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels = {"decode_attention": check_decode_attention(gen, quant=False),
               "decode_attention_int8kv": check_decode_attention(gen,
                                                                 quant=True),
               "paged_decode_attention": check_paged_decode_attention(gen),
               "int8_matmul": check_int8_matmul(gen),
               "flash_attention": check_flash_attention(gen)}
    small = check_small_model()
    took("kernel checks", t_phase)

    # path D first: its times come before any profiler session
    t_path = time.perf_counter()
    PROGRESS["path"] = "D, F and G"
    paths = {"D": serve_engine_path(card)}
    # path F ran on D's handler, after D's numbers; D's chunked turns are
    # counted apart from its HTTP burst
    paths["F"] = paths["D"].pop("F")
    paths["G"] = paths["D"].pop("G")
    paths["D-chunked"] = paths["D"].pop("chunked")
    paths["D-warm"] = paths["D"].pop("warm")
    paths["D-window"] = paths["D"].pop("window")
    paths["D-aux"] = paths["D"].pop("aux")
    took("paths D, F and G", t_path)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"after paths D, F and G: {torch.cuda.memory_allocated() / 2**30:.2f}"
        f" GiB still allocated, threads alive: "
        f"{sorted(t.name for t in threading.enumerate())}")
    def begin(path: str) -> float:
        PROGRESS.update(path=path, stage="")
        if path in CUT_PATHS:
            log(f"path {path}: llama3-8b at {CUT_LAYERS} of its "
                f"{FULL_LAYERS} layers, its published widths (a cut for time; "
                f"every check kept, its figures not comparable with 32-layer "
                f"ones)")
        if path in ("P", "Q"):
            log(f"path {path}: {HF_LAYERS} of {FULL_LAYERS} layers at the "
                f"published widths (a cut for time; every check kept)")
        return time.perf_counter()

    for path in PATHS:
        t_path = begin(path)
        paths[path] = serve_path(path, card)
        if path == "A":
            # A (m), the MicroBatcher on A's weights, counted apart
            paths["A-micro"] = paths[path].pop("micro")
        took(f"path {path}", t_path)
    t_path = begin("E")
    paths["E"] = serve_prefix_path(card)
    took("path E", t_path)
    t_path = begin("H")
    paths["H"] = serve_spec_path(card)
    took("path H", t_path)
    gc.collect()
    torch.cuda.empty_cache()
    t_path = begin("I")
    paths["I"] = serve_ship_path(card)
    took("path I", t_path)
    gc.collect()
    torch.cuda.empty_cache()
    t_path = begin("J")
    paths["J"] = serve_longctx_path(card)
    took("path J", t_path)
    gc.collect()
    torch.cuda.empty_cache()
    t_path = begin("K")
    paths["K"] = serve_bundle_path(card)
    took("path K", t_path)
    gc.collect()
    torch.cuda.empty_cache()
    t_path = begin("L")
    paths["L"] = serve_classify_path(card)
    took("path L", t_path)
    gc.collect()
    torch.cuda.empty_cache()
    t_path = begin("P")
    try:
        paths["P"] = serve_hf_path(card, hf_writer)
    finally:
        shutil.rmtree(hf_root, ignore_errors=True)
    took("path P", t_path)
    gc.collect()
    torch.cuda.empty_cache()
    t_path = begin("Q")
    paths["Q"] = serve_moe_path(card)
    took("path Q", t_path)
    gc.collect()
    torch.cuda.empty_cache()
    t_path = begin("R")
    paths["R"] = serve_train_path(card)
    took("path R", t_path)
    gc.collect()
    torch.cuda.empty_cache()

    # M (g) builds the llama bundle that N's and O's fleets serve; it is
    # deleted after O
    llama_root = Path(tempfile.mkdtemp(prefix="lambdipy-llama-"))
    try:
        t_path = begin("M")
        paths["M"] = serve_lifecycle_path(card, llama_root / "bundle")
        took("path M", t_path)
        gc.collect()
        torch.cuda.empty_cache()
        t_path = begin("N")
        paths["N"] = serve_fleet_path(card, llama_root / "bundle")
        took("path N", t_path)
        gc.collect()
        torch.cuda.empty_cache()
        t_path = begin("O")
        paths["O"] = serve_soak_path(card, llama_root / "bundle")
        took("path O", t_path)
    finally:
        shutil.rmtree(llama_root, ignore_errors=True)
    # each kernel's launches: the sum over the paths, each path counted
    # from 0 just before it was driven
    for name, kern in kernels.items():
        kern["launches"] = sum(p["launches"][name] for p in paths.values())

    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "torch": torch.__version__, "build_s": build_s,
         "kernels": list(kernels.values()), "small_model": small,
         "main_path": paths}, indent=1))
    PROGRESS.update(path="the result", stage="")
    log(f"the whole script took {time.perf_counter() - t_script:.1f} s "
        f"[{card}]")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys}
                                  for kern in kernels.values()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
