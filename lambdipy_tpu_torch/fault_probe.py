"""Where a watchdog trip's recovery time goes, probed on the card. Run from
the root of a checkout on a machine with one NVIDIA H100:

    python -m lambdipy_tpu_torch.fault_probe

Builds ``llama3-8b`` (seeded random int8 weights) behind the continuous
engine over a paged arena (8 slots, segment 16, depth 2, the watchdog at
1 s), decodes one 16-token greedy row of 128 new tokens, and while it
decodes holds the serving stream with a 1.7 s ``torch.cuda._sleep``
between two segments: the next segment's wait trips the watchdog and the
row replays. The engine's steps after the trip are timed from the
stall's start (host clock): dropping the old step's graphs, the new
step, the replay's prefill and packing, its graph capture, and each
booked segment (the first clean one ends the wedge). Twice, the second
with the stall enqueued the same way. One JSON object goes to standard
output, after the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import threading
import time

import torch

STALL_S = 1.7
WATCHDOG_S = 1.0
PROMPT = list(range(1, 17))
NEW = 128


def _cycles_per_s() -> float:
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(1000)
    start.record()
    torch.cuda._sleep(200_000_000)
    end.record()
    torch.cuda.synchronize()
    return 200_000_000 / (start.elapsed_time(end) / 1e3)


def _timed(obj, name: str, label: str, events: list) -> None:
    """Wrap ``obj.name`` so each call appends (label, start, end)."""
    real = getattr(obj, name)

    def wrap(*args, **kwargs):
        t0 = time.monotonic()
        try:
            return real(*args, **kwargs)
        finally:
            events.append((label, t0, time.monotonic()))

    setattr(obj, name, wrap)


def trip_timeline(engine, cycles: float, events: list) -> dict:
    """One stalled decode: the trip and the replay's steps, in seconds
    from the stall's start."""
    from lambdipy_tpu_torch.models.graphs import DEVICE_LOCK

    events.clear()
    n_fail = len(engine.failure_log)
    th = threading.Thread(target=lambda: engine.generate(
        PROMPT, max_new_tokens=NEW))
    th.start()
    while True:
        with engine._lock:
            if any(e is not None and len(e["toks"]) >= engine.segment
                   for e in engine._active):
                break
        time.sleep(0.002)
    with DEVICE_LOCK:
        torch.cuda._sleep(int(STALL_S * cycles))
        t0 = time.monotonic()
    th.join()
    trip = engine.failure_log[n_fail]
    return {"trip_s": trip["at"] - t0, "waited_s": trip["waited_s"],
            "steps": [{"step": label, "from_s": round(a - t0, 4),
                       "to_s": round(b - t0, 4)}
                      for label, a, b in events if a >= trip["at"] - 0.05]}


def main() -> int:
    from lambdipy_tpu_torch.models import graphs
    from lambdipy_tpu_torch.ops import _build
    from lambdipy_tpu_torch.runtime.handlers import (HandlerContext,
                                                     generate_handler)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    _build.build_all()
    state = generate_handler(
        {"model": "llama3-8b", "dtype": "bfloat16", "quant": "int8",
         "extra": {"attn_backend": "blocked", "matmul_backend": "pallas",
                   "batch_mode": "continuous", "kv_paged": "1",
                   "batch_max": "8", "batch_segment": "16",
                   "prefix_cache_mb": "0"}},
        HandlerContext(device="cuda"))
    engine = state.engine
    engine.generate(PROMPT, max_new_tokens=NEW)  # graphs captured
    events: list = []
    _timed(graphs.StepProgram, "_capture", "capture", events)
    _timed(graphs.StepPrograms, "close", "close old graphs", events)
    _timed(engine, "_init_step", "new step", events)
    _timed(engine, "_pack_joiners", "prefill and pack", events)
    _timed(engine, "_collect", "book a segment", events)
    engine.watchdog_s = WATCHDOG_S
    engine.degrade_window_s = 0.1  # both replays at the full depth
    cycles = _cycles_per_s()
    runs = [trip_timeline(engine, cycles, events) for _ in range(2)]
    print(card, flush=True)
    print(json.dumps({"stall_s": STALL_S, "watchdog_s": WATCHDOG_S,
                      "runs": runs,
                      "faults": engine.stats()["faults"]}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
