"""Per-replica circuit breakers and a fleet-wide retry budget.

The port's copy of ``lambdipy_tpu/fleet/breaker.py``: the same states
under the same event sequence.

The router's raw retry loop treats every failure as equally retryable:
under a *partial* failure (one replica dropping connections, or serving
with outlier latency) it keeps offering that replica traffic, and under
a *fleet-wide* failure it multiplies load exactly when capacity is
lowest — the retry storm that finishes off a degraded fleet. Two small
state machines (the Envoy outlier-detection / retry-budget discipline)
fix both:

- :class:`CircuitBreaker` — one per replica. ``fail_threshold``
  consecutive forward failures (dropped connection, or a 5xx that is
  not an explicit 503 shed) OPEN the breaker: the router stops picking
  the replica for ``open_s`` seconds, then lets exactly ONE probe
  request through (HALF_OPEN); success closes the breaker, failure
  re-opens it with the interval doubled (capped at ``max_open_s``).
  Optionally, ``outlier_ms``/``outlier_threshold`` open on consecutive
  *slow successes* — a replica that answers but at outlier latency is
  degrading the tail just as surely as a dead one.
- :class:`RetryBudget` — fleet-wide. Retries are allowed only while the
  retry-to-primary ratio over a sliding window stays under ``ratio``
  (plus a ``min_retries`` floor so a quiet fleet can still retry at
  all). When the budget is spent the router relays the last failure
  instead of re-sending — under a fleet-wide 503 storm the client gets
  the honest shed immediately and the fleet gets no amplification.

Both take an injectable ``clock`` so tests drive the transitions
deterministically.
"""

from __future__ import annotations

import threading
import time
from collections import deque

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """Consecutive-failure / latency-outlier breaker with half-open
    probing. Thread-safe; ``begin_attempt`` is called by the router at
    pick time (it claims the half-open probe slot), ``record_*`` when
    the forward resolves. Two racing picks of an open-expired breaker
    can both probe — the bound is "a couple of requests", not "one",
    and the first resolution wins the transition."""

    def __init__(self, *, fail_threshold: int = 5, open_s: float = 1.0,
                 max_open_s: float = 30.0, outlier_ms: float = 0.0,
                 outlier_threshold: int = 5,
                 probe_grace_s: float = 60.0, clock=time.monotonic):
        self.fail_threshold = max(1, int(fail_threshold))
        self.open_s = max(0.01, float(open_s))
        self.max_open_s = max(self.open_s, float(max_open_s))
        self.outlier_ms = max(0.0, float(outlier_ms))
        self.outlier_threshold = max(1, int(outlier_threshold))
        # some router paths legitimately never resolve their forward
        # against the breaker (a request_timeout 504 is busy-not-dead;
        # a streamed client that went away mid-body): a half-open probe
        # older than this grace is considered ABANDONED and a new probe
        # may be claimed — without it, one unresolved probe would leave
        # the breaker HALF_OPEN (= blocked) forever and permanently
        # blackhole a recovered replica
        self.probe_grace_s = max(0.01, float(probe_grace_s))
        self._clock = clock
        self._lock = threading.Lock()
        self.state = CLOSED
        self.consecutive_fails = 0
        self.consecutive_slow = 0
        self.open_until = 0.0
        self._half_open_at = 0.0   # when the in-flight probe was claimed
        self._reopens = 0          # half-open failures since last close
        self.opens = 0
        self.closes = 0
        self.half_open_probes = 0
        self.last_cause: str | None = None

    # -- router-facing surface ----------------------------------------------

    def blocked(self) -> bool:
        """True while the replica must not be picked: the breaker is
        OPEN and its interval has not elapsed, or a half-open probe is
        in flight and younger than ``probe_grace_s``. State-only —
        never transitions, so the router can filter a whole candidate
        list without consuming probe slots."""
        with self._lock:
            if self.state == OPEN:
                return self._clock() < self.open_until
            if self.state == HALF_OPEN:
                return self._clock() < self._half_open_at + \
                    self.probe_grace_s
            return False

    def begin_attempt(self) -> None:
        """The router picked this replica: claim the half-open probe
        slot if the open interval has elapsed — or RE-claim it when the
        previous probe aged past ``probe_grace_s`` without resolving.
        No-op when closed."""
        with self._lock:
            now = self._clock()
            if self.state == OPEN and now >= self.open_until:
                self.state = HALF_OPEN
                self._half_open_at = now
                self.half_open_probes += 1
            elif self.state == HALF_OPEN and \
                    now >= self._half_open_at + self.probe_grace_s:
                self._half_open_at = now
                self.half_open_probes += 1

    def record_success(self, latency_ms: float | None = None) -> None:
        with self._lock:
            if self.state == HALF_OPEN:
                self.state = CLOSED
                self.closes += 1
                self._reopens = 0
                self.consecutive_fails = self.consecutive_slow = 0
                return
            self.consecutive_fails = 0
            if self.outlier_ms and latency_ms is not None \
                    and latency_ms > self.outlier_ms:
                self.consecutive_slow += 1
                if self.consecutive_slow >= self.outlier_threshold:
                    self._open_locked("latency_outlier")
            else:
                self.consecutive_slow = 0

    def record_failure(self) -> None:
        with self._lock:
            if self.state == HALF_OPEN:
                # the probe failed: back off exponentially, capped
                self._reopens += 1
                self._open_locked("half_open_probe_failed")
                return
            if self.state == OPEN:
                return  # a straggler from before the open; already paying
            self.consecutive_fails += 1
            if self.consecutive_fails >= self.fail_threshold:
                self._open_locked("consecutive_failures")

    # -- internals -----------------------------------------------------------

    def _open_locked(self, cause: str) -> None:
        self.state = OPEN
        self.opens += 1
        self.last_cause = cause
        self.consecutive_fails = self.consecutive_slow = 0
        interval = min(self.max_open_s, self.open_s * (2 ** self._reopens))
        self.open_until = self._clock() + interval

    def report(self) -> dict:
        with self._lock:
            remaining = max(0.0, self.open_until - self._clock()) \
                if self.state == OPEN else 0.0
            return {
                "state": self.state,
                "opens": self.opens,
                "closes": self.closes,
                "half_open_probes": self.half_open_probes,
                "last_cause": self.last_cause,
                "open_remaining_s": round(remaining, 3),
            }


class RetryBudget:
    """Sliding-window retry-to-primary ratio limiter. ``ratio <= 0``
    means unlimited (the budget records but never denies)."""

    def __init__(self, *, ratio: float = 0.2, min_retries: int = 3,
                 window_s: float = 10.0, clock=time.monotonic):
        self.ratio = float(ratio)
        self.min_retries = max(0, int(min_retries))
        self.window_s = max(0.1, float(window_s))
        self._clock = clock
        self._lock = threading.Lock()
        self._primaries: deque[float] = deque()
        self._retries: deque[float] = deque()
        self.allowed = 0
        self.denied = 0

    def _prune_locked(self, now: float) -> None:
        horizon = now - self.window_s
        for dq in (self._primaries, self._retries):
            while dq and dq[0] < horizon:
                dq.popleft()

    def record_request(self) -> None:
        """One client request entering the fleet (the primary send)."""
        with self._lock:
            now = self._clock()
            self._prune_locked(now)
            self._primaries.append(now)

    def allow_retry(self) -> bool:
        """True (and the retry is charged) while the window's retries
        stay under ``min_retries + ratio * primaries``."""
        with self._lock:
            now = self._clock()
            self._prune_locked(now)
            if self.ratio > 0:
                budget = self.min_retries + self.ratio * len(self._primaries)
                if len(self._retries) >= budget:
                    self.denied += 1
                    return False
            self._retries.append(now)
            self.allowed += 1
            return True

    def report(self) -> dict:
        with self._lock:
            self._prune_locked(self._clock())
            return {
                "ratio": self.ratio,
                "min_retries": self.min_retries,
                "window_s": self.window_s,
                "window_primaries": len(self._primaries),
                "window_retries": len(self._retries),
                "allowed": self.allowed,
                "denied": self.denied,
            }
