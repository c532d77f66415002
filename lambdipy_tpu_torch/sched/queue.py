"""Bounded request queue with per-class FIFO lanes.

Three request classes cover the serving workloads:
``interactive`` (latency-sensitive user traffic), ``batch`` (bulk
offline inference) and ``background`` (warmers, evals — anything that
should only ride spare capacity). Each class is one FIFO lane; the
dequeue *order between* lanes belongs to the policy
(:mod:`lambdipy_tpu_torch.sched.policy`), so the queue itself stays a dumb,
bounded container that a policy can never corrupt.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field

CLASSES = ("interactive", "batch", "background")

_seq = itertools.count()


@dataclass
class Ticket:
    """One admitted request's place in line."""

    cls: str = "interactive"
    tenant: str = "anon"
    deadline_ms: float | None = None
    cost_ms: float = 0.0           # estimator's service estimate at admit
    prefill_tokens: int = 0
    decode_tokens: int = 0
    seq: int = field(default_factory=lambda: next(_seq))
    enqueued: float = field(default_factory=time.monotonic)
    granted: bool = False
    expired: bool = False          # deadline shed after admission
    wait_ms: float | None = None   # actual queue wait, stamped at grant


class RequestQueue:
    """FIFO lanes under one total bound. Not thread-safe on its own —
    the Scheduler serializes access under its condition lock."""

    def __init__(self, capacity: int = 64):
        self.capacity = max(1, capacity)
        self._lanes: dict[str, deque[Ticket]] = {c: deque() for c in CLASSES}

    def depth(self, cls: str | None = None) -> int:
        if cls is not None:
            return len(self._lanes[cls])
        return sum(len(q) for q in self._lanes.values())

    def full(self) -> bool:
        return self.depth() >= self.capacity

    def push(self, ticket: Ticket) -> bool:
        if self.full():
            return False
        self._lanes[ticket.cls].append(ticket)
        return True

    def pop(self, policy) -> Ticket | None:
        """Dequeue the next ticket; *which lane* is the policy's call."""
        nonempty = {c: q for c, q in self._lanes.items() if q}
        if not nonempty:
            return None
        cls = policy.select(nonempty)
        return self._lanes[cls].popleft()

    def remove(self, ticket: Ticket) -> bool:
        """Withdraw a parked ticket (wait timeout / client gone)."""
        try:
            self._lanes[ticket.cls].remove(ticket)
            return True
        except ValueError:
            return False

    def snapshot(self) -> dict[str, int]:
        return {c: len(q) for c, q in self._lanes.items()}
