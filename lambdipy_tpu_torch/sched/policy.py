"""Pluggable dequeue policies.

A policy answers two questions:

- ``select(lanes)`` — which class lane the scheduler dequeues from next
  (``lanes`` maps class name -> non-empty deque of tickets/entries whose
  heads expose ``seq``);
- ``order(entries)`` — how a *batch former* (the ContinuousBatcher's
  joiner pick) should rank a flat list of pending
  entries (dicts carrying ``cls`` and ``seq``).

Policies are tiny, stateful-at-most-by-counters objects so tests can
drive them deterministically.
"""

from __future__ import annotations

from lambdipy_tpu_torch.sched.queue import CLASSES

# fair-share weights: interactive requests get the lion's share of slots
# under contention but batch/background never starve (weighted
# round-robin, not strict priority)
FAIR_WEIGHTS = {"interactive": 8, "batch": 3, "background": 1}

_RANK = {c: i for i, c in enumerate(CLASSES)}


def _entry_cls(e) -> str:
    cls = e.get("cls") if isinstance(e, dict) else getattr(e, "cls", None)
    return cls if cls in CLASSES else "interactive"


def _entry_seq(e):
    return e.get("seq", 0) if isinstance(e, dict) else getattr(e, "seq", 0)


class FifoPolicy:
    """Global arrival order: class is recorded but never reorders."""

    name = "fifo"

    def select(self, lanes: dict) -> str:
        return min(lanes, key=lambda c: lanes[c][0].seq)

    def order(self, entries: list) -> list:
        return sorted(entries, key=_entry_seq)

    def head(self, entries: list):
        """Deterministic, state-free head pick (batch formers poll this
        in wait loops — it must never mutate round-robin state)."""
        return min(entries, key=_entry_seq)


class PriorityPolicy:
    """Strict class priority: interactive > batch > background. Starvation
    of lower classes under sustained interactive load is the documented
    trade — pick fair-share when that matters."""

    name = "priority"

    def select(self, lanes: dict) -> str:
        return min(lanes, key=lambda c: (_RANK[c], lanes[c][0].seq))

    def order(self, entries: list) -> list:
        return sorted(entries,
                      key=lambda e: (_RANK[_entry_cls(e)], _entry_seq(e)))

    def head(self, entries: list):
        return min(entries,
                   key=lambda e: (_RANK[_entry_cls(e)], _entry_seq(e)))


class FairSharePolicy:
    """Smooth weighted round-robin (nginx's algorithm) over class lanes:
    each select, every contending lane gains its weight in credit and the
    highest-credit lane wins and pays back the total — interleaving is
    proportional to weight with no bursts, and an empty lane accrues
    nothing (no post-idle flood)."""

    name = "fair"

    def __init__(self, weights: dict[str, int] | None = None):
        self.weights = dict(weights or FAIR_WEIGHTS)
        self._credit = {c: 0 for c in CLASSES}

    def select(self, lanes: dict) -> str:
        total = 0
        for c in lanes:
            w = self.weights.get(c, 1)
            self._credit[c] += w
            total += w
        best = max(lanes, key=lambda c: (self._credit[c], -_RANK[c]))
        self._credit[best] -= total
        return best

    def order(self, entries: list) -> list:
        """Rank a flat pending list by repeatedly applying the weighted
        selection over its classes — proportional interleave, FIFO
        within a class."""
        lanes: dict[str, list] = {}
        for e in sorted(entries, key=_entry_seq):
            lanes.setdefault(_entry_cls(e), []).append(e)
        out: list = []
        while lanes:
            heads = {c: q for c, q in lanes.items() if q}
            cls = self.select(heads)
            out.append(lanes[cls].pop(0))
            if not lanes[cls]:
                del lanes[cls]
        return out

    def head(self, entries: list):
        """State-free head (no credit mutation): highest class rank wins
        a poll; the credit-weighted interleave applies to full ``order``
        passes, where proportional share actually accrues."""
        return min(entries,
                   key=lambda e: (_RANK[_entry_cls(e)], _entry_seq(e)))


_POLICIES = {p.name: p for p in (FifoPolicy, PriorityPolicy, FairSharePolicy)}


def make_policy(name: str):
    """Build a policy by config/CLI name (``fifo`` | ``priority`` |
    ``fair``; ``fair-share`` accepted as an alias)."""
    key = (name or "fair").lower().replace("-share", "").replace("_share", "")
    if key not in _POLICIES:
        raise ValueError(
            f"unknown scheduling policy {name!r} (choose from "
            f"{sorted(_POLICIES)})")
    return _POLICIES[key]()
