"""Stage timing of the port's boot, the twin of ``lambdipy_tpu/utils/timing.py``
(``StageTimer``): every cold-start stage is timed and reported in
``/healthz`` ``cold_start`` and the readiness line."""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class StageTimer:
    """Accumulates named stage durations (seconds)."""

    stages: dict[str, float] = field(default_factory=dict)

    @contextmanager
    def stage(self, name: str):
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.stages[name] = (self.stages.get(name, 0.0)
                                 + time.monotonic() - t0)

    def total(self) -> float:
        return sum(self.stages.values())

    def report(self) -> dict[str, float]:
        out = {k: round(v, 4) for k, v in self.stages.items()}
        out["total"] = round(self.total(), 4)
        return out
