"""SLO-aware admission control and request scheduling for the serve path:
the port's copy of ``lambdipy_tpu/sched`` (which imports no JAX, but the
port imports nothing of the JAX package).

- :mod:`lambdipy_tpu_torch.sched.queue` — a bounded queue with per-class
  FIFO lanes (interactive / batch / background);
- :mod:`lambdipy_tpu_torch.sched.policy` — pluggable dequeue policies
  (fifo, priority, fair-share weighted round-robin);
- :mod:`lambdipy_tpu_torch.sched.admission` — per-tenant token buckets,
  queue-depth caps and deadline-based shedding (429/503 + Retry-After);
- :mod:`lambdipy_tpu_torch.sched.estimator` — an EWMA cost model of
  per-request service time (prefill + decode tokens) used for deadline
  feasibility.

:class:`Scheduler` below ties them together and is what
``runtime/server.py`` fronts every invoke with; the request-context
helpers let the continuous engine (``runtime/continuous.py``) see the
scheduling class and deadline of the request it is serving without
threading them through every handler signature.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field

from lambdipy_tpu_torch.runtime.metrics import LatencyStats
from lambdipy_tpu_torch.sched.admission import AdmissionController, Shed
from lambdipy_tpu_torch.sched.estimator import CostEstimator
from lambdipy_tpu_torch.sched.policy import make_policy
from lambdipy_tpu_torch.sched.queue import CLASSES, RequestQueue, Ticket

__all__ = ["Scheduler", "Shed", "Ticket", "CLASSES",
           "set_request_context", "clear_request_context",
           "current_request_class", "current_request_deadline_ms"]


# -- request context ---------------------------------------------------------
# The HTTP thread that admitted a request is the thread that runs the
# handler (and therefore enters the batchers). A thread-local carries the
# request's scheduling class down that call stack so batch formation can
# dequeue by policy without new parameters on every handler.

_ctx = threading.local()


def set_request_context(cls: str = "interactive", tenant: str = "anon",
                        deadline_ms: float | None = None) -> None:
    _ctx.cls, _ctx.tenant, _ctx.deadline_ms = cls, tenant, deadline_ms


def clear_request_context() -> None:
    _ctx.cls = _ctx.tenant = _ctx.deadline_ms = None


def current_request_class() -> str:
    return getattr(_ctx, "cls", None) or "interactive"


def current_request_deadline_ms() -> float | None:
    """The admitted request's ``x-deadline-ms``, if it carried one — the
    continuous engine uses it to cancel rows whose deadline expired
    mid-decode at the next drain barrier instead of decoding them to
    completion."""
    return getattr(_ctx, "deadline_ms", None)


# -- scheduler ---------------------------------------------------------------


@dataclass
class SchedConfig:
    """Operator surface, settable per bundle (``[payload.extra]``) or per
    serve process (CLI flags); every field has a serving-safe default."""

    policy: str = "fair"
    max_concurrency: int = 8       # invokes running at once
    queue_cap: int = 64            # queued (not yet running) requests
    rate: float = 0.0              # per-tenant tokens/s; 0 = unlimited
    burst: float = 0.0             # bucket size; 0 = 2 * rate
    default_cost_ms: float = 50.0  # estimator prior before any sample

    @classmethod
    def from_extra(cls, extra: dict | None, **overrides) -> "SchedConfig":
        """Bundle ``[payload.extra]`` keys (strings), then the
        LAMBDIPY_SCHED_POLICY env var (process-level operator intent,
        also read by the handler's batch formation), then explicit
        overrides (CLI/ctor, already typed). Unknown extra keys are
        ignored — extra is a shared namespace."""
        extra = extra or {}
        kw: dict = {}
        for name, cast in (("policy", str), ("max_concurrency", int),
                           ("queue_cap", int), ("rate", float),
                           ("burst", float), ("default_cost_ms", float)):
            raw = extra.get(f"sched_{name}")
            if raw is not None:
                kw[name] = cast(raw)
        env_policy = os.environ.get("LAMBDIPY_SCHED_POLICY")
        if env_policy:
            kw["policy"] = env_policy
        kw.update({k: v for k, v in overrides.items() if v is not None})
        return cls(**kw)


class Scheduler:
    """Admission + queue + slot handoff in front of the invoke path.

    A request thread calls :meth:`admit` (immediate accept-or-shed) and
    then :meth:`wait_turn` (parks in its class lane until the policy
    grants it one of ``max_concurrency`` run slots); :meth:`finish`
    releases the slot, wakes the next grant, and feeds the estimator.
    """

    def __init__(self, config: SchedConfig | None = None):
        self.config = config or SchedConfig()
        # normalize degenerate configs ONCE here so every consumer (the
        # admission depth check, wait math, the queue's own bound) sees
        # the same floors: queue_cap=0 would otherwise shed every
        # request 503 on an idle server
        self.config.max_concurrency = max(1, self.config.max_concurrency)
        self.config.queue_cap = max(1, self.config.queue_cap)
        self.policy = make_policy(self.config.policy)
        self.estimator = CostEstimator(
            default_ms=self.config.default_cost_ms)
        self.queue = RequestQueue(capacity=self.config.queue_cap)
        self.admission = AdmissionController(
            rate=self.config.rate, burst=self.config.burst)
        self._cond = threading.Condition()
        self._running = 0
        self.draining = False
        # observability: per-class queue-wait reservoirs + counters
        self.wait_stats = {c: LatencyStats(capacity=512) for c in CLASSES}
        self.admitted = 0
        self.completed = 0

    # -- admission -----------------------------------------------------------

    def admit(self, *, tenant: str = "anon", cls: str = "interactive",
              deadline_ms: float | None = None, prefill_tokens: int = 0,
              decode_tokens: int = 0) -> Ticket | Shed:
        if cls not in CLASSES:
            cls = "interactive"
        cost_ms = self.estimator.estimate(prefill_tokens, decode_tokens)
        with self._cond:
            ahead = self.queue.depth() + self._running
            # queue wait ≈ work ahead of us spread over the run slots
            wait_ms = (ahead * self.estimator.mean_ms()
                       / max(1, self.config.max_concurrency))
            shed = self.admission.check(
                tenant=tenant, cls=cls, deadline_ms=deadline_ms,
                queue_depth=self.queue.depth(),
                queue_cap=self.config.queue_cap,
                est_wait_ms=wait_ms, est_cost_ms=cost_ms,
                draining=self.draining)
            if shed is not None:
                return shed
            ticket = Ticket(cls=cls, tenant=tenant,
                            deadline_ms=deadline_ms, cost_ms=cost_ms,
                            prefill_tokens=prefill_tokens,
                            decode_tokens=decode_tokens)
            self.queue.push(ticket)
            self.admitted += 1
            self._pump_locked()
            return ticket

    # -- slot handoff ---------------------------------------------------------

    def _pump_locked(self) -> None:
        while self._running < self.config.max_concurrency:
            ticket = self.queue.pop(self.policy)
            if ticket is None:
                return
            now = time.monotonic()
            wait_ms = (now - ticket.enqueued) * 1e3
            # stamp the ticket so the server can echo queue_wait_ms in
            # the response body — a client can
            # then window queue-wait client-side instead of reading the
            # replica's cumulative reservoir
            ticket.wait_ms = wait_ms
            self.wait_stats[ticket.cls].record(wait_ms)
            # deadline re-check at grant time: overload that built up
            # AFTER this request was admitted can make its deadline
            # unmeetable — shed it now instead of burning a device slot
            # on a response the client already abandoned
            if (ticket.deadline_ms is not None
                    and wait_ms + ticket.cost_ms > ticket.deadline_ms):
                ticket.expired = True
                ticket.granted = True  # wakes the waiter; it sends 503
                self.admission.count_shed("deadline", ticket.cls)
                self._cond.notify_all()
                continue
            ticket.granted = True
            self._running += 1
            self._cond.notify_all()

    def wait_turn(self, ticket: Ticket, timeout: float | None = None) -> bool:
        """Park until the policy grants this ticket a run slot. Returns
        False when the ticket expired (deadline shed at grant time) —
        the caller must NOT run the request and must not call finish."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not ticket.granted:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    self.queue.remove(ticket)
                    ticket.expired = True
                    self.admission.count_shed("deadline", ticket.cls)
                    return False
                self._cond.wait(timeout=remaining)
            return not ticket.expired

    def finish(self, ticket: Ticket, *, service_ms: float | None = None) -> None:
        with self._cond:
            self._running -= 1
            self.completed += 1
            if service_ms is not None:
                self.estimator.observe(service_ms, ticket.prefill_tokens,
                                       ticket.decode_tokens)
            self._pump_locked()
            self._cond.notify_all()

    # -- lifecycle / observability -------------------------------------------

    def drain(self) -> None:
        """Stop admitting; queued requests still run to completion."""
        with self._cond:
            self.draining = True

    def idle(self) -> bool:
        with self._cond:
            return self._running == 0 and self.queue.depth() == 0

    def report(self) -> dict:
        with self._cond:
            running = self._running
            depths = self.queue.snapshot()
            admitted, completed = self.admitted, self.completed
        waits = {}
        for c in CLASSES:
            rep = self.wait_stats[c].report()
            if rep["count"]:
                waits[c] = {"count": rep["count"],
                            "p50_ms": rep["p50_ms"],
                            "p99_ms": rep["p99_ms"]}
        return {
            "policy": self.policy.name,
            "max_concurrency": self.config.max_concurrency,
            "queue_cap": self.config.queue_cap,
            "running": running,
            "queued": depths,
            "admitted": admitted,
            "completed": completed,
            "shed": self.admission.shed_report(),
            "queue_wait": waits,
            "estimator": self.estimator.report(),
        }
