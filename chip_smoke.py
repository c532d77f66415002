#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``lambdipy_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which fails the run with a non-zero exit:

1. print the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel from ``lambdipy_tpu_torch/csrc`` (one ``nvcc``
   per source, in parallel) and print the ptxas report;
3. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes, and time kernel, plain version and a library call
   that the port never uses (CUDA events, warmed, L2 defeated by rotating
   input copies); then hold a small int8 model on the card against the
   same model on the CPU;
4. the main path: full-width ``llama3-8b`` (int8, bf16,
   ``attn_backend="blocked"``, ``matmul_backend="pallas"``, seeded random
   weights) served by the port's HTTP server; requests over HTTP; the
   kernels' launch counters must rise by exactly what the path implies;
   the served logits are held against the plain PyTorch model on the card,
   and one batch-1 request is traced with ``torch.profiler`` (device busy
   time by kernel, idle share);
5. print the kernels' JSON line and, last, the device line.

Details go to ``chiprun_out/chip_smoke.json``. With no CUDA device, or
without the rest of the repository beside it, the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

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


def copies_for(nbytes: int) -> int:
    return max(1, min(32, -(-L2_DEFEAT_BYTES // max(nbytes, 1))))


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / BW * 1e3, flops / BF16_PEAK * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ phase 3

def check_decode_attention(gen) -> dict:
    import torch.nn.functional as F

    from lambdipy_tpu_torch.ops.decode_attention import (
        blocked_decode_attention, decode_attention_reference)

    dev = "cuda"
    b, h, kvh, d, t = 4, 32, 8, 128, 544
    alen = torch.tensor([1, 129, 300, 544], dtype=torch.int32, device=dev)
    results = {}
    # (dtype, tolerance on max |kernel - plain|): bf16 output carries
    # 2^-8 relative rounding and the plain version rounds the
    # probabilities to bf16 before PV; f32 differs only by summation order
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        q = torch.randn(b, 1, h, d, generator=gen, device=dev).to(dtype)
        k = torch.randn(b, t, kvh, d, generator=gen, device=dev).to(dtype)
        v = torch.randn(b, t, kvh, d, generator=gen, device=dev).to(dtype)
        out = blocked_decode_attention(q, k, v, alen)
        ref = decode_attention_reference(q, k, v, alen)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        rel = err / ref.float().abs().max().item()
        # active_len 0: the plain version's uniform mean of V
        zero = torch.tensor([0, 1, 544, 7], dtype=torch.int32, device=dev)
        err0 = (blocked_decode_attention(q, k, v, zero).float()
                - decode_attention_reference(q, k, v, zero).float()
                ).abs().max().item()
        log(f"decode_attention {dtype}: max_abs_err {err:.3e} "
            f"(relative to the peak {rel:.3e}; active_len 0 case "
            f"{err0:.3e}) tolerance {tol}")
        if not (err <= tol and err0 <= tol):
            raise SystemExit(f"decode_attention disagrees with its plain "
                             f"version in {dtype}: {err}, {err0} > {tol}")
        results[str(dtype)] = {"max_abs_err": err, "max_rel_err": rel,
                               "max_abs_err_len0": err0, "tolerance": tol}

    # timing at the bf16 main-path shape, K/V copies rotated past L2
    dtype = torch.bfloat16
    kv_bytes = 2 * b * t * kvh * d * 2
    n = copies_for(kv_bytes)
    q = torch.randn(b, 1, h, d, generator=gen, device=dev).to(dtype)
    ks = [torch.randn(b, t, kvh, d, generator=gen, device=dev).to(dtype)
          for _ in range(n)]
    vs = [torch.randn(b, t, kvh, d, generator=gen, device=dev).to(dtype)
          for _ in range(n)]
    ms = cuda_time(lambda i: blocked_decode_attention(q, ks[i], vs[i], alen),
                   n)
    plain_ms = cuda_time(
        lambda i: decode_attention_reference(q, ks[i], vs[i], alen), n)
    # library yardstick: SDPA over the length-masked window, GQA native
    qt = q.transpose(1, 2)
    kts = [x.transpose(1, 2) for x in ks]
    vts = [x.transpose(1, 2) for x in vs]
    mask = (torch.arange(t, device=dev)[None, :] < alen[:, None])[:, None, None]
    library_ms = cuda_time(lambda i: F.scaled_dot_product_attention(
        qt, kts[i], vts[i], attn_mask=mask, enable_gqa=True), n)
    active = int(alen.sum().item())
    nbytes = (q.numel() * 2 + 2 * active * kvh * d * 2 + alen.numel() * 4
              + q.numel() * 2)
    flops = 4.0 * active * h * d
    bound_ms, bound_by = bound(nbytes, flops)
    log(f"decode_attention b={b} h={h} kvh={kvh} d={d} t={t} "
        f"active_len={alen.tolist()}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} "
        f"ms ({bound_by})")
    return {"name": "decode_attention", "route": "cuda",
            "source": "lambdipy_tpu_torch/csrc/decode_attention.cu",
            "replaces": "lambdipy_tpu/ops/decode_attention.py:110",
            "shape": f"b={b} h={h} kvh={kvh} d={d} t={t} "
                     f"active_len={alen.tolist()} bf16",
            "max_abs_err": max(r["max_abs_err"] for r in results.values()),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "checks": results}


MATMUL_SHAPES = (  # (k, n, x dtype): the projections of llama3-8b
    (4096, 4096, torch.bfloat16),    # q_proj, o_proj
    (4096, 1024, torch.bfloat16),    # k_proj, v_proj
    (4096, 14336, torch.bfloat16),   # gate_proj, up_proj
    (14336, 4096, torch.bfloat16),   # down_proj
    (4096, 128256, torch.float32),   # lm_head (f32 x and output)
)
MATMUL_MS = (1, 4, 2048)  # single-row decode, batch-4 decode, 4 x 512 prefill
LINE_SHAPE = (4, 4096, 14336)  # the shape reported in the kernels line


def check_int8_matmul(gen) -> dict:
    from lambdipy_tpu_torch.ops.quant import int8_matmul, int8_matmul_reference

    dev = "cuda"
    rows, line = [], None
    for k, n, xdtype in MATMUL_SHAPES:
        n_copies = copies_for(k * n)
        ws = [torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                            dtype=torch.int8) for _ in range(n_copies)]
        scale = (torch.rand(1, n, generator=gen, device=dev) + 0.5) \
            / (127.0 * k ** 0.5)
        # the library yardstick's bf16 weights rotate past L2 as well
        n_deq = copies_for(2 * k * n)
        w_deq = [(w.to(torch.bfloat16) * scale.to(torch.bfloat16))
                 for w in ws[:n_deq]]
        for m in MATMUL_MS:
            x = torch.randn(m, k, generator=gen, device=dev).to(xdtype)
            out = int8_matmul(x, ws[0], scale)
            ref = int8_matmul_reference(x, ws[0], scale)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            peak = ref.float().abs().max().item()
            # bf16 output: one bf16 ulp at the peak (2^-8) from another
            # f32 summation order; f32 output: summation order alone
            tol = (2.0 ** -7 if xdtype == torch.bfloat16 else 1e-5) * peak
            ok = err <= tol
            ms = cuda_time(lambda i: int8_matmul(x, ws[i], scale), n_copies)
            plain_ms = cuda_time(
                lambda i: int8_matmul_reference(x, ws[i], scale), n_copies)
            xb = x.to(torch.bfloat16)
            library_ms = cuda_time(lambda i: torch.matmul(xb, w_deq[i]),
                                   n_deq)
            esize = x.element_size()
            nbytes = m * k * esize + k * n + 4 * n + m * n * esize
            bound_ms, bound_by = bound(nbytes, 2.0 * m * k * n)
            row = {"m": m, "k": k, "n": n, "x_dtype": str(xdtype),
                   "max_abs_err": err, "max_rel_err": err / peak,
                   "tolerance": tol, "ms": ms,
                   "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by}
            rows.append(row)
            log(f"int8_matmul m={m} k={k} n={n} x={xdtype}: max_abs_err "
                f"{err:.3e} (relative to the peak {err / peak:.3e}; tol "
                f"{tol:.3e}) kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bf16 matmul {library_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by})")
            if not ok:
                raise SystemExit(f"int8_matmul disagrees with its plain "
                                 f"version at m={m} k={k} n={n}: {err} > {tol}")
            if (m, k, n) == LINE_SHAPE:
                line = row
        del ws, w_deq
        torch.cuda.empty_cache()
    return {"name": "int8_matmul", "route": "cuda",
            "source": "lambdipy_tpu_torch/csrc/int8_matmul.cu",
            "replaces": "lambdipy_tpu/ops/quant.py:32",
            "shape": "m=%d k=%d n=%d bf16" % LINE_SHAPE,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": line["ms"], "plain_ms": line["plain_ms"],
            "bound_ms": line["bound_ms"], "bound_by": line["bound_by"],
            "library_ms": line["library_ms"], "checks": rows}


def check_small_model() -> dict:
    """A small int8 model (kernels on the card) against the same weights
    on the CPU (plain versions): greedy tokens and logprobs."""
    from lambdipy_tpu_torch.models import registry

    extra = {"vocab_size": 512, "hidden": 256, "heads": 4, "kv_heads": 2,
             "mlp": 512, "layers": 2, "max_len": 256,
             "attn_backend": "blocked", "matmul_backend": "pallas"}
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
    log(f"small int8 model, card vs CPU: greedy tokens equal {same}, "
        f"logprob max_abs_err {lp_err:.3e} (tolerance 5e-3: the int8 kernel "
        f"rounds f32 activations to bf16, and a ~1e-7 difference between "
        f"card and CPU can flip one by a bf16 ulp)")
    if not same or lp_err > 5e-3:
        raise SystemExit("small model on the card disagrees with the CPU")
    return {"tokens_equal": same, "logprob_max_abs_err": lp_err}


# ------------------------------------------------------------------ phase 4

def http_json(url: str, payload=None, timeout: float = 900.0) -> dict:
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


MAIN_SPEC = {"model": "llama3-8b", "dtype": "bfloat16", "quant": "int8",
             "extra": {"attn_backend": "blocked", "matmul_backend": "pallas",
                       "max_new_tokens": "16"}}


def main_path(card: str) -> dict:
    """Phase 4: ``MAIN_SPEC`` served over HTTP on the card."""
    from lambdipy_tpu_torch.models.llama import LlamaModel
    from lambdipy_tpu_torch.ops.decode_attention import blocked_decode_attention
    from lambdipy_tpu_torch.ops.quant import int8_matmul
    from lambdipy_tpu_torch.runtime.handlers import (HandlerContext,
                                                     generate_handler)
    from lambdipy_tpu_torch.runtime.server import BundleServer

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    state = generate_handler(MAIN_SPEC, HandlerContext(device="cuda"))
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    cfg = state.server.model.cfg
    log(f"{MAIN_SPEC['model']} ({cfg.layers} layers, hidden {cfg.hidden}, "
        f"{cfg.quant}) built with seeded random weights in {boot_s:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    server = BundleServer(state, port=0).start_background()
    try:
        health = http_json(server.url + "/healthz")
        if not health.get("ok"):
            raise SystemExit(f"/healthz not ok: {health}")
        rng = torch.Generator().manual_seed(11)

        def prompt(n):
            return torch.randint(1, cfg.vocab_size, (n,),
                                 generator=rng).tolist()

        p100 = prompt(100)
        ragged = [prompt(n) for n in (17, 64, 200, 500)]
        p_sampled = prompt(64)
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
        # counters to 0 just before the main path, read just after
        blocked_decode_attention.launches = 0
        int8_matmul.launches = 0
        walls, resp = {}, {}
        t_all = time.perf_counter()
        for name, body, _, _ in requests:
            t1 = time.perf_counter()
            resp[name] = http_json(server.url + "/invoke", body)
            walls[name] = time.perf_counter() - t1
        total_s = time.perf_counter() - t_all
        launches = {"decode_attention": blocked_decode_attention.launches,
                    "int8_matmul": int8_matmul.launches}
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
            raise SystemExit(f"request {name} answered badly: "
                             f"{json.dumps(r)[:500]}")
    lps = torch.tensor(resp["greedy_1row"]["logprobs"])
    if not torch.isfinite(lps).all():
        raise SystemExit("non-finite logprobs")
    if resp["greedy_1row"]["tokens"] != resp["greedy_1row_again"]["tokens"]:
        raise SystemExit("repeated greedy request gave other tokens")
    if resp["sampled"]["tokens"] != resp["sampled_again"]["tokens"]:
        raise SystemExit("repeated seeded request gave other tokens")
    # one prefill forward + (n_new - 1) decode forwards per request;
    # 7 projections per layer + the lm_head per forward, one attention
    # launch per layer per decode forward
    want = {"decode_attention": sum(cfg.layers * (n - 1)
                                    for _, _, _, n in requests),
            "int8_matmul": sum((7 * cfg.layers + 1) * n
                               for _, _, _, n in requests)}
    log(f"launch counters over the main path: {launches}, implied {want}")
    if launches != want or metrics["handler"]["kernels"] != launches:
        raise SystemExit(f"launch counters {launches} (metrics "
                         f"{metrics['handler']['kernels']}) != implied {want}")

    decode_tok_s_1 = 31 / (walls["greedy_1row"] - walls["ttft_1row"])
    decode_tok_s_4 = 4 * 31 / (walls["ragged4"] - walls["ttft_ragged4"])
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    perf = {"requests": len(requests), "wall_s": total_s,
            "requests_per_s": len(requests) / total_s,
            "ttft_s_1row_100tok": walls["ttft_1row"],
            "ttft_s_ragged4": walls["ttft_ragged4"],
            "decode_tok_s_1row": decode_tok_s_1,
            "decode_tok_s_ragged4": decode_tok_s_4,
            "max_memory_allocated_gib": peak_gib, "card": card,
            "request_walls_s": walls}
    for key in ("requests_per_s", "ttft_s_1row_100tok", "ttft_s_ragged4",
                "decode_tok_s_1row", "decode_tok_s_ragged4",
                "max_memory_allocated_gib"):
        log(f"{key}: {perf[key]:.4f} [{card}]")

    # the served model against the plain PyTorch model on the card: the
    # same weight tensors, dense attention and dequantized matmuls
    served = state.server.model
    plain = LlamaModel(dataclasses.replace(
        served.cfg, attn_backend="dense", matmul_backend="xla"),
        device="meta")
    plain.load_state_dict(served.state_dict(), assign=True)
    plain.device = served.device
    agree = compare_models(served, plain, p100)
    del plain
    trace = profile_decode(state.server, [p100], card)
    return {"boot_s": boot_s, "launches": launches, "implied": want,
            "perf": perf, "plain_agreement": agree, "trace": trace,
            "tokens": {k: v.get("tokens") for k, v in resp.items()}}


def profile_decode(server, rows, card: str, n_new: int = 16) -> dict:
    """Where a batch-1 request's time goes: one ``generate`` under
    ``torch.profiler`` (after a warm one). Device busy time is the sum of
    the CUDA kernels' durations; the rest of the wall is host time the
    card sat idle (the profiler's own cost included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    server.generate(rows, max_new_tokens=n_new)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.generate(rows, max_new_tokens=n_new)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count)
         for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
        key=lambda r: -r[1])
    if not kernels:
        log("profiler recorded no device kernels: device busy time not "
            "measured")
        return {"wall_ms": wall_ms, "device_busy_ms": None,
                "idle_share": None, "kernels": []}
    busy_ms = sum(ms for _, ms, _ in kernels)
    log(f"profiled batch-1 request ({len(rows[0])}-token prompt, {n_new} "
        f"new): wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, idle "
        f"share {1 - busy_ms / wall_ms:.3f} [{card}]")
    for name, ms, count in kernels[:10]:
        log(f"  {ms:9.3f} ms  {count:6d}x  {name[:100]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms,
            "kernels": [{"name": n, "ms": ms, "count": c}
                        for n, ms, c in kernels[:25]]}


# The served model (kernels) against the plain model: the plain int8 path
# folds each channel's scale into bf16 weights before the product, the
# kernel applies the f32 scale after it, so the two round differently
# (measured on an H100: cosine 0.999893, rel 0.0153). The limits sit three
# to five times outside that gap; the per-kernel checks of phase 3 hold
# each kernel far tighter.
COSINE_MIN, REL_MAX = 0.9995, 0.05


def compare_models(served, plain, tokens) -> dict:
    """Prefill logits and 4 teacher-forced decode steps of the served
    model (kernels) against the plain model on the same weights."""
    from lambdipy_tpu_torch.models.llama import prefill_into_cache

    dev = served.device
    toks = torch.tensor([tokens], device=dev)
    s = toks.shape[1]
    cos_min, rel_max, argmax_same = 1.0, 0.0, 0
    with torch.inference_mode():
        caches, logits = {}, {}
        for name, model in (("served", served), ("plain", plain)):
            lg, pc = model(toks)
            caches[name] = prefill_into_cache(model.cfg, pc, 1, s + 8, s)
            logits[name] = lg[:, -1].float()
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
    log(f"served vs plain model on the card: logit cosine min "
        f"{cos_min:.6f} (tolerance >= {COSINE_MIN}), max |diff| / max "
        f"|logit| {rel_max:.4f} (tolerance <= {REL_MAX}), argmax equal at "
        f"{argmax_same} of 5 positions")
    if cos_min < COSINE_MIN or rel_max > REL_MAX:
        raise SystemExit("served model disagrees with the plain model")
    return {"cosine_min": cos_min, "rel_max": rel_max,
            "argmax_same_of_5": argmax_same}


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
    attn = check_decode_attention(gen)
    mm = check_int8_matmul(gen)
    small = check_small_model()
    log(f"kernel checks took {time.perf_counter() - t_phase:.1f} s")

    path = main_path(card)
    attn["launches"] = path["launches"]["decode_attention"]
    mm["launches"] = path["launches"]["int8_matmul"]

    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "torch": torch.__version__, "build_s": build_s,
         "kernels": [attn, mm], "small_model": small, "main_path": path},
        indent=1))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys}
                                  for kern in (attn, mm)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
