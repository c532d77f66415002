"""Profiling of the serve loop, the twin of ``lambdipy_tpu/utils/trace.py``
over ``torch.profiler``: :func:`profile_trace` captures host and, with a
card, device activity into a directory as a Chrome trace (``POST
/profile``). The host side records the capturing thread's ops only (the
profiler is thread-local there); the card's kernels come from CUPTI,
whichever thread launched them."""

from __future__ import annotations

import json
import time
from contextlib import contextmanager
from pathlib import Path


class TraceCapture:
    """Handle yielded by :func:`profile_trace`; ``started`` records
    whether the profiler engaged (an untraced capture must not pass for a
    trace)."""

    def __init__(self, out_dir: Path):
        self.out_dir = Path(out_dir)
        self.started = False
        self.error: str | None = None


@contextmanager
def profile_trace(out_dir: Path):
    """Capture a ``torch.profiler`` trace into ``out_dir``
    (``trace.json`` and ``capture_meta.json``). Never raises for the
    profiler's sake: serving must not die to tracing, and the yielded
    :class:`TraceCapture` says whether it engaged."""
    capture = TraceCapture(out_dir)
    capture.out_dir.mkdir(parents=True, exist_ok=True)
    prof = None
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.__enter__()
        capture.started = True
    except Exception as e:  # noqa: BLE001 — reported in the capture
        capture.error = f"{type(e).__name__}: {e}"
    t0 = time.monotonic()
    try:
        yield capture
    finally:
        if capture.started:
            try:
                prof.__exit__(None, None, None)
                prof.export_chrome_trace(str(capture.out_dir / "trace.json"))
            except Exception as e:  # noqa: BLE001 — as above
                capture.error = f"stop: {type(e).__name__}: {e}"
        (capture.out_dir / "capture_meta.json").write_text(json.dumps(
            {"wall_s": round(time.monotonic() - t0, 4),
             "started": capture.started}))


def latest_trace_files(out_dir: Path) -> list[str]:
    out_dir = Path(out_dir)
    if not out_dir.is_dir():
        return []
    return sorted(str(p.relative_to(out_dir))
                  for p in out_dir.rglob("*") if p.is_file())[:50]
