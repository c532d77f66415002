"""Admission control: decide accept-or-shed BEFORE a request queues.

Overload policy (the whole point of this layer): a request that cannot
be served within its constraints is rejected *immediately and
explicitly* — 429 (client is over its rate) or 503 (server is out of
capacity / draining / the deadline is unmeetable) with a ``Retry-After``
hint — instead of joining a queue whose latency grows without bound.

Checks, in order (cheapest and most client-attributable first):

1. draining           -> 503 (the process is going away)
2. per-tenant rate    -> 429 (token bucket keyed by tenant/API key)
3. queue-depth cap    -> 503 (bounded queue is the backpressure signal)
4. deadline feasible  -> 503 (x-deadline-ms vs estimated wait + service)
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from lambdipy_tpu_torch.sched.queue import CLASSES


@dataclass(frozen=True)
class Shed:
    """An explicit rejection: HTTP status + why + when to come back."""

    code: int            # 429 or 503
    reason: str          # draining | rate | queue_full | deadline
    retry_after_s: float

    def payload(self) -> dict:
        return {"ok": False, "error": f"shed: {self.reason}",
                "shed": self.reason,
                "retry_after_s": round(self.retry_after_s, 3)}


class TokenBucket:
    """Classic token bucket; ``take`` returns 0.0 on success or the
    seconds until a token would be available (the Retry-After hint)."""

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = float(burst) if burst else max(1.0, 2 * self.rate)
        self.tokens = self.burst
        self.stamp = time.monotonic()

    def take(self, now: float | None = None) -> float:
        now = time.monotonic() if now is None else now
        self.tokens = min(self.burst,
                          self.tokens + (now - self.stamp) * self.rate)
        self.stamp = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return 0.0
        return (1.0 - self.tokens) / self.rate if self.rate > 0 else 1.0


class AdmissionController:
    def __init__(self, *, rate: float = 0.0, burst: float = 0.0,
                 max_tenants: int = 1024):
        self.rate = float(rate)
        self.burst = float(burst)
        self.max_tenants = max_tenants
        self._lock = threading.Lock()
        self._buckets: dict[str, TokenBucket] = {}
        self._shed: dict[str, int] = {}          # by reason
        self._shed_cls: dict[str, int] = {c: 0 for c in CLASSES}

    # -- the decision --------------------------------------------------------

    def check(self, *, tenant: str, cls: str, deadline_ms: float | None,
              queue_depth: int, queue_cap: int, est_wait_ms: float,
              est_cost_ms: float, draining: bool) -> Shed | None:
        if draining:
            return self._shed_out(503, "draining", 1.0, cls)
        if self.rate > 0:
            wait = self._bucket(tenant).take()
            if wait > 0:
                return self._shed_out(429, "rate", wait, cls)
        if queue_depth >= queue_cap:
            # come back once roughly half the queue has drained
            retry = max(0.05, est_wait_ms / 2e3)
            return self._shed_out(503, "queue_full", retry, cls)
        if deadline_ms is not None and est_wait_ms + est_cost_ms > deadline_ms:
            # the deadline is unmeetable NOW; by est_wait the queue has
            # turned over and a fresh attempt may fit
            return self._shed_out(503, "deadline",
                                  max(0.05, est_wait_ms / 1e3), cls)
        return None

    # -- internals -----------------------------------------------------------

    def _bucket(self, tenant: str) -> TokenBucket:
        with self._lock:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                if len(self._buckets) >= self.max_tenants:
                    # bound the tenant map on a public endpoint: evict the
                    # LEAST RECENTLY USED bucket (oldest take() stamp). A
                    # token-count comparison would be stale for idle
                    # tenants and make fresh full-burst buckets the
                    # perpetual victims — letting a hammering tenant
                    # recreate its bucket (full burst again) every
                    # request, bypassing the rate limit entirely.
                    victim = min(self._buckets,
                                 key=lambda t: self._buckets[t].stamp)
                    del self._buckets[victim]
                bucket = self._buckets[tenant] = TokenBucket(self.rate,
                                                             self.burst)
            return bucket

    def _shed_out(self, code: int, reason: str, retry_after_s: float,
                  cls: str) -> Shed:
        self.count_shed(reason, cls)
        return Shed(code=code, reason=reason, retry_after_s=retry_after_s)

    def count_shed(self, reason: str, cls: str) -> None:
        with self._lock:
            self._shed[reason] = self._shed.get(reason, 0) + 1
            if cls in self._shed_cls:
                self._shed_cls[cls] += 1

    def shed_report(self) -> dict:
        with self._lock:
            return {"total": sum(self._shed.values()),
                    "by_reason": dict(self._shed),
                    "by_class": {c: n for c, n in self._shed_cls.items()
                                 if n}}
