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
   port's HTTP server from a fresh handler per path, every decode step a
   replay of a captured CUDA graph (``models/graphs.py``). D first, timed
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
   ~4,000-token prompt. Around each path the kernels' launch counters
   are set to 0 and must then equal what the path implies, and every
   decode step must have been a graph replay (the replays counted in the
   launch counters); each path's rows must be bitwise (tokens and
   logprobs) those of an eager server on the same weights (D: an eager
   paged engine taking the same traffic), and batch-1 decode tok/s is
   read with graphs and eagerly in turns; the served logits of A-C are
   held against the plain PyTorch model on the card, and one request
   (one engine burst for D) is traced with ``torch.profiler`` (device
   busy time by kernel, idle share);
5. print the kernels' JSON line and, last, the device line.

Details go to ``chiprun_out/chip_smoke.json``. With no CUDA device, or
without the rest of the repository beside it, the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

BW = 3.35e12        # H100 SXM HBM3 bytes/s (data sheet)
BF16_PEAK = 989e12  # H100 SXM dense bf16 tensor-core flop/s (data sheet)
OUT_DIR = Path("chiprun_out")
L2_DEFEAT_BYTES = 160 << 20  # rotate input copies past the 50 MB L2


def log(*args):
    print(*args, flush=True)


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
# path A's 100-token prompt (bucket 128), a 4 x 512 group (2048) and the
# ~4,000-token prompt of paths B and C (bucket 4096)
PREFILL_MS = (1, 4, 128, 2048, 4096)
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
# rows this fast also get their device time; so does every GEMV row
DEVICE_TIME_BELOW_MS = 0.2
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
            if ms < DEVICE_TIME_BELOW_MS or route == "gemv":
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


def path_spec(path: str) -> dict:
    return {"model": "llama3-8b", "dtype": "bfloat16", "quant": "int8",
            "extra": {**PATHS[path], "matmul_backend": "pallas",
                      "max_new_tokens": "16"}}


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


def check_replays(path: str, stats: dict, steps: int) -> dict:
    """Every decode step of a path was a replay of a captured graph: the
    server's (or engine's) ``replays`` equal the ``steps`` its requests
    implied and none ran eagerly. The launch checks before this one count
    each replay's launches."""
    keys = ("compile_count", "replays", "eager_steps", "program_evictions",
            "program_bytes", "decode_buckets")
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
    return programs


RATE_TOKENS = 256


def decode_rate(generate, rows) -> float:
    """Decode tokens per second of ``rows``: rows x 255 / (wall of a
    256-token request - wall of a 1-token request); over 255 steps a slow
    short request moves the rate by a few percent, not past the device
    bound."""
    walls = []
    for n in (1, RATE_TOKENS):
        t0 = time.perf_counter()
        generate(rows, max_new_tokens=n)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return len(rows) * (RATE_TOKENS - 1) / (walls[1] - walls[0])


def graph_vs_eager(path: str, server, requests: dict, p100, ragged,
                   card) -> dict:
    """The graph server's rows against an eager server's on the same
    weights (``LlamaServer(model, graphs=False)``): tokens and logprobs
    bitwise for each request ``name -> (rows, knobs)`` of 32 new tokens;
    then batch-1 decode tok/s on the 100-token prompt over 255 steps
    (:func:`decode_rate`), graph and eager in turns (graph, eager, eager,
    graph), the host's noise moving a rate 30-70% between runs, and the
    graph server's ragged batch-4 tok/s, twice."""
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
    rates = {"graph": [], "eager": []}
    # the 256-token key's graph captured before the first timed reading
    server.generate([p100], max_new_tokens=RATE_TOKENS)
    for kind in ("graph", "eager", "eager", "graph"):
        rates[kind].append(decode_rate(
            (server if kind == "graph" else eager).generate, [p100]))
    log(f"path {path} batch-1 decode tok/s, graph {rates['graph']} / eager "
        f"{rates['eager']} (in turns) [{card}]")
    server.generate(ragged, max_new_tokens=RATE_TOKENS)  # captured first
    ragged_rate = [decode_rate(server.generate, ragged) for _ in range(2)]
    log(f"path {path} ragged batch-4 decode tok/s, graph {ragged_rate} "
        f"[{card}]")
    del eager
    gc.collect()
    return {"bitwise": same, "decode_tok_s": rates,
            "ragged4_decode_tok_s": ragged_rate, "card": card}


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
        if not health.get("ok") or health.get("kv_quant") != cfg.kv_quant:
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
                             sum(n - 1 for *_, n in requests))

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
        card)
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
    # free this path's model before the next one is built
    del state, server
    gc.collect()
    torch.cuda.empty_cache()
    return out


# path D: the continuous engine over a paged KV arena
ENGINE_EXTRA = {"attn_backend": "blocked", "matmul_backend": "pallas",
                "batch_mode": "continuous", "kv_paged": "1",
                "batch_max": "8", "batch_segment": "16"}
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
            "extra": {**ENGINE_EXTRA, "max_new_tokens": "16"}}
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
        if not (health.get("ok") and health.get("kv_paged")):
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
    programs = check_replays("D", metrics["handler"]["batching"],
                             stats["steps"])
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
        knobs = {k: body[k] for k in ("temperature", "top_k", "top_p",
                                      "seed", "eos_id") if k in body}
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

    # (b) the same traffic through a dense engine on the same weights
    dense = ContinuousBatcher(state.server, slots=engine.slots,
                              segment=engine.segment)
    dense_out = [None] * len(reqs)

    def send_dense(i):
        _, body = reqs[i]
        knobs = {k: body[k] for k in ("temperature", "top_k", "top_p",
                                      "seed", "eos_id") if k in body}
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
    del dense_out

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
    perf["contended"] = contended_burst(state.server, engine, reqs, card)
    trace = profile_engine(engine, [body["tokens"] for _, body in reqs[:8]],
                           card)
    out = {"spec": spec, "boot_s": boot_s, "launches": launches,
           "implied": want, "programs": programs,
           "eager_engine": e_stats, "dense_launches": dense_launches,
           "engine": stats, "dense_engine": dstats, "page_pool": page_stats,
           "peak_held_pages": peak, "logprob_diff_http_vs_solo": lp_diff,
           "logprob_diff_dense_vs_solo": dense_solo, "perf": perf,
           "requests": rows, "trace": trace, "card": card}
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
        knobs = {k: body[k] for k in ("temperature", "top_k", "top_p",
                                      "seed", "eos_id") if k in body}
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
        knobs = {k: body[k] for k in ("temperature", "top_k", "top_p",
                                      "seed", "eos_id") if k in body}
        out[i] = eager.generate(body["tokens"],
                                max_new_tokens=body["max_new_tokens"],
                                return_logprobs=True, **knobs)

    _, wall = _drive(send, reqs)
    stats = eager.stats()
    if stats["replays"] or stats["eager_steps"] != stats["steps"]:
        raise SystemExit("path D: the eager engine replayed a graph")
    eager.release()
    del eager
    gc.collect()
    torch.cuda.empty_cache()
    return wall, out, stats


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


# -------------------------------------------------------------------- main

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
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

    build_s = _build.build_all()
    log(f"kernels built in {build_s:.1f} s")
    for name, text in _build.build_logs.items():
        log(f"--- nvcc {name}.cu\n{text.strip()}")

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels = {"decode_attention": check_decode_attention(gen, quant=False),
               "decode_attention_int8kv": check_decode_attention(gen,
                                                                 quant=True),
               "paged_decode_attention": check_paged_decode_attention(gen),
               "int8_matmul": check_int8_matmul(gen),
               "flash_attention": check_flash_attention(gen)}
    small = check_small_model()
    log(f"kernel checks took {time.perf_counter() - t_phase:.1f} s")

    # path D first: its times come before any profiler session
    t_path = time.perf_counter()
    paths = {"D": serve_engine_path(card)}
    log(f"path D took {time.perf_counter() - t_path:.1f} s")
    for path in PATHS:
        t_path = time.perf_counter()
        paths[path] = serve_path(path, card)
        log(f"path {path} took {time.perf_counter() - t_path:.1f} s")
    # each kernel's launches: the sum over the paths, each path counted
    # from 0 just before it was driven
    for name, kern in kernels.items():
        kern["launches"] = sum(p["launches"][name] for p in paths.values())

    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "torch": torch.__version__, "build_s": build_s,
         "kernels": list(kernels.values()), "small_model": small,
         "main_path": paths}, indent=1))
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
