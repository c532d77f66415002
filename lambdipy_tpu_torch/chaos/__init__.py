"""Composed-fault chaos soak over a live fleet of the port's replicas.

The port's copy of ``lambdipy_tpu/chaos/`` (the same modules, public
functions and ``__all__``), driving the port's fleet on the card, or on
the CPU under ``--device cpu``.

Every earlier chaos bench armed ONE fault site in a hand-curated
scenario; the bugs that survived those gates lived in *cross-feature
interactions* under *overlapping* faults (the hardening lists of earlier
reviews). This package is the Jepsen-style answer:

- :mod:`nemesis` — a seeded scheduler that draws composed fault events
  (every ``runtime/faults.py`` registry site x kind, plus process-level
  nemeses: SIGKILL a replica's worker, drain/undrain) onto a randomized
  timeline with controlled overlap, every decision derived from one
  seed so any failing schedule replays exactly;
- :mod:`workload` — a mixed open-loop client driving the full feature
  matrix concurrently (greedy + seeded-sampled, streamed + plain, cold
  + shared-prefix + multi-turn sessions) with per-request expected
  outputs precomputed against a direct reference server;
- :mod:`checker` — the global oracle: every request is delivered
  bitwise vs the reference or is an explicit, priced, counted failure;
  no waiter outlives its bound; and at quiesce all accounting converges
  (pagepool conservation, pins -> 0, spill depth -> 0);
- :mod:`soak` — the orchestrator behind ``python -m
  lambdipy_tpu_torch.chaos.soak`` and its ``--replay-timeline``
  workflow.
"""

from lambdipy_tpu_torch.chaos.checker import check_history, check_quiesce
from lambdipy_tpu_torch.chaos.nemesis import (
    Nemesis,
    NemesisEvent,
    generate_timeline,
    parse_timeline,
    render_timeline,
    timeline_properties,
)
from lambdipy_tpu_torch.chaos.workload import Outcome, build_plan

__all__ = [
    "Nemesis",
    "NemesisEvent",
    "Outcome",
    "build_plan",
    "check_history",
    "check_quiesce",
    "generate_timeline",
    "parse_timeline",
    "render_timeline",
    "timeline_properties",
]
