"""Router-level spill queue: absorb fleet-wide overload instead of
relaying it. The port's copy of ``lambdipy_tpu/fleet/spill.py``, built on
the port's ``sched/`` as JAX's is built on JAX's.

When every replica sheds (fleet-wide 429/503) or none is routable (all
ejected/flapping), the router used to relay the last shed to the
client — correct, but it turns a *transient* brownout (both replicas
warming, a flap window, a one-second admission burst) into client-
visible errors. :class:`SpillQueue` is router-level queueing that spills
to the scheduler's queue: a bounded parking lot built
from the sched layer's own pieces — :class:`~lambdipy_tpu_torch.sched.queue.
RequestQueue` class lanes and :class:`~lambdipy_tpu_torch.sched.queue.Ticket`
tickets dequeued by a :mod:`~lambdipy_tpu_torch.sched.policy` policy — so a
parked interactive request drains ahead of a parked background one,
exactly like the server-side queue it mirrors.

Semantics:

- a request parks ONLY after the router's retry loop exhausted the
  fleet (non-streamed only — a parked stream would hold a socket open
  with nothing honest to send);
- a waker grants parked tickets back into the retry loop as replicas
  recover, paced by ``max_inflight`` so a just-readmitted replica is
  not hit by the whole queue at once (no thundering herd);
- the queue sheds only on OVERFLOW (at park time, queue full) or
  DEADLINE (``max_wait_s``, tightened by the request's own
  ``x-deadline-ms``), and those sheds carry the queue's own wait
  estimate as ``Retry-After`` — the same pricing discipline the
  server-side admission layer uses.

The wait estimate is ``ceil((ahead+1) / max_inflight) * drain_ewma``
where ``drain_ewma`` tracks how long a granted ticket takes to leave
(grant → done), floored by the upstream shed's own hint.
"""

from __future__ import annotations

import math
import threading
import time

from lambdipy_tpu_torch.runtime.metrics import LatencyStats
from lambdipy_tpu_torch.sched.admission import Shed
from lambdipy_tpu_torch.sched.policy import make_policy
from lambdipy_tpu_torch.sched.queue import CLASSES, RequestQueue, Ticket

SPILL_DEADLINE = "spill_deadline"
SPILL_OVERFLOW = "spill_overflow"


class SpillQueue:
    def __init__(self, ready_fn, *, capacity: int = 64,
                 max_wait_s: float = 30.0, policy: str = "priority",
                 max_inflight: int = 4, poll_s: float = 0.05,
                 drain_prior_s: float = 0.25):
        self.ready_fn = ready_fn
        self.capacity = max(1, int(capacity))
        self.max_wait_s = max(0.05, float(max_wait_s))
        self.max_inflight = max(1, int(max_inflight))
        self.poll_s = max(0.01, float(poll_s))
        self.queue = RequestQueue(capacity=self.capacity)
        self.policy = make_policy(policy)
        self.wait = LatencyStats(capacity=512)
        self._cond = threading.Condition()
        self._inflight = 0
        self._drain_ewma_s = max(0.01, float(drain_prior_s))
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.parked_total = 0
        self.granted_total = 0
        self.expired_total = 0
        self.overflow_total = 0

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "SpillQueue":
        self._thread = threading.Thread(target=self._waker, daemon=True,
                                        name="fleet-spill-waker")
        self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        with self._cond:
            # wake every parked thread so it can observe its deadline;
            # a closing router must not strand parked client threads
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    # -- parking surface -----------------------------------------------------

    def depth(self) -> int:
        with self._cond:
            return self.queue.depth()

    def estimate_wait_s(self, ahead: int | None = None,
                        hint_s: float = 0.0) -> float:
        """Priced like the admission layer's Retry-After: queue position
        over the grant concurrency, times the observed drain time."""
        with self._cond:
            n = self.queue.depth() if ahead is None else int(ahead)
            est = math.ceil((n + 1) / self.max_inflight) * self._drain_ewma_s
        return min(self.max_wait_s, max(0.05, hint_s, est))

    def park(self, *, cls: str = "interactive", tenant: str = "anon",
             wait_s: float | None = None, hint_s: float = 0.0
             ) -> Ticket | Shed:
        """Block until granted a retry round, or return a :class:`Shed`
        (overflow at entry, or the wait bound expired). The caller MUST
        call :meth:`done` after its retry round when a Ticket was
        returned."""
        bound = self.max_wait_s if wait_s is None \
            else min(self.max_wait_s, float(wait_s))
        with self._cond:
            if bound <= 0:
                self.expired_total += 1
                return Shed(503, SPILL_DEADLINE,
                            self.estimate_wait_s(hint_s=hint_s))
            if self.queue.full():
                self.overflow_total += 1
                return Shed(503, SPILL_OVERFLOW,
                            self.estimate_wait_s(hint_s=hint_s))
            ticket = Ticket(cls=cls if cls in CLASSES else "interactive",
                            tenant=tenant)
            self.queue.push(ticket)
            self.parked_total += 1
            deadline = time.monotonic() + bound
            while not ticket.granted:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._stop.is_set():
                    self.queue.remove(ticket)
                    ticket.expired = True
                    self.expired_total += 1
                    return Shed(503, SPILL_DEADLINE,
                                self.estimate_wait_s(hint_s=hint_s))
                self._cond.wait(timeout=min(remaining, 0.25))
            return ticket

    def done(self, ticket: Ticket) -> None:
        """A granted ticket's retry round finished (delivered or shed
        again): release its grant slot and feed the drain estimate."""
        with self._cond:
            self._inflight = max(0, self._inflight - 1)
            t0 = getattr(ticket, "granted_at", None)
            if t0 is not None:
                dt = min(30.0, max(0.0, time.monotonic() - t0))
                self._drain_ewma_s = (0.8 * self._drain_ewma_s + 0.2 *
                                      max(0.01, dt))

    # -- the waker -----------------------------------------------------------

    def _grant_some_locked(self) -> bool:
        granted = False
        while self._inflight < self.max_inflight:
            ticket = self.queue.pop(self.policy)
            if ticket is None:
                break
            now = time.monotonic()
            ticket.granted_at = now
            ticket.granted = True
            self._inflight += 1
            self.granted_total += 1
            self.wait.record((now - ticket.enqueued) * 1e3)
            granted = True
        return granted

    def _waker(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                if not self.ready_fn():
                    continue
            except Exception:  # noqa: BLE001 — the waker never dies
                continue
            with self._cond:
                if self._grant_some_locked():
                    self._cond.notify_all()

    # -- observability -------------------------------------------------------

    def report(self) -> dict:
        with self._cond:
            rep = {
                "depth": self.queue.depth(),
                "depth_by_class": self.queue.snapshot(),
                "capacity": self.capacity,
                "max_wait_s": self.max_wait_s,
                "inflight_grants": self._inflight,
                "parked": self.parked_total,
                "granted": self.granted_total,
                "expired": self.expired_total,
                "overflow": self.overflow_total,
                "drain_ewma_s": round(self._drain_ewma_s, 4),
            }
        rep["wait"] = self.wait.report()
        return rep
