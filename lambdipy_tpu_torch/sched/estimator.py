"""EWMA cost model of per-request service time.

Deadline feasibility needs an answer to "how long will THIS request
take?" before it runs. Service time on the decode path is close to
affine in the token counts — a fixed overhead, a per-prefill-token cost
and a per-decode-token cost (decode re-reads all weights every step, so
the decode term dominates at scale) — so the estimator fits

    ms  ≈  overhead + prefill_rate * prefill_tokens + decode_rate * decode_tokens

online with a normalized-LMS update (a per-sample gradient step scaled
by the feature norm: the exponential forgetting makes it the
multi-feature generalization of an EWMA, and it degrades gracefully to a
plain EWMA of request latency when token counts are unknown). Weights
are clamped non-negative — a transient can't drive a negative cost and
a nonsense (negative) estimate.

Fed by the server after every completed invoke with the same latencies
``LatencyStats`` records; consumed by admission (deadline shedding) and
the scheduler's queue-wait estimate.
"""

from __future__ import annotations

import threading


class CostEstimator:
    # token features enter the fit divided by this: raw counts (10^2-10^4)
    # against a unit bias feature make normalized-LMS converge on the
    # token weights orders of magnitude slower than on the bias (the
    # norm term is dominated by the largest feature) — scaling to
    # "64-token blocks" puts all features at comparable magnitude
    TOKEN_SCALE = 64.0

    def __init__(self, *, alpha: float = 0.2, default_ms: float = 50.0):
        self.alpha = alpha
        self.default_ms = default_ms
        self._lock = threading.Lock()
        self.samples = 0
        self._ewma_ms = None           # plain EWMA over all requests
        # affine weights over (1, prefill/SCALE, decode/SCALE)
        self._w = [default_ms, 0.0, 0.0]

    def _features(self, prefill_tokens: int,
                  decode_tokens: int) -> tuple[float, float, float]:
        return (1.0, max(0, prefill_tokens) / self.TOKEN_SCALE,
                max(0, decode_tokens) / self.TOKEN_SCALE)

    def observe(self, ms: float, prefill_tokens: int = 0,
                decode_tokens: int = 0) -> None:
        ms = max(0.0, float(ms))
        with self._lock:
            self.samples += 1
            self._ewma_ms = (ms if self._ewma_ms is None else
                             (1 - self.alpha) * self._ewma_ms + self.alpha * ms)
            x = self._features(prefill_tokens, decode_tokens)
            pred = sum(w * xi for w, xi in zip(self._w, x))
            err = ms - pred
            norm = sum(xi * xi for xi in x)
            step = self.alpha * err / norm
            self._w = [max(0.0, w + step * xi)
                       for w, xi in zip(self._w, x)]

    def estimate(self, prefill_tokens: int = 0,
                 decode_tokens: int = 0) -> float:
        """Predicted service ms for a request of this shape."""
        with self._lock:
            if self.samples == 0:
                return self.default_ms
            x = self._features(prefill_tokens, decode_tokens)
            affine = sum(w * xi for w, xi in zip(self._w, x))
            # never below half the observed mean: a cold affine fit can
            # underestimate wildly before the rates converge
            return max(affine, 0.5 * self._ewma_ms)

    def mean_ms(self) -> float:
        """EWMA of request latency regardless of shape (queue-wait math)."""
        with self._lock:
            return self.default_ms if self._ewma_ms is None else self._ewma_ms

    def report(self) -> dict:
        with self._lock:
            return {
                "samples": self.samples,
                "ewma_ms": (None if self._ewma_ms is None
                            else round(self._ewma_ms, 3)),
                "overhead_ms": round(self._w[0], 3),
                "ms_per_prefill_token": round(self._w[1] / self.TOKEN_SCALE,
                                              5),
                "ms_per_decode_token": round(self._w[2] / self.TOKEN_SCALE,
                                             5),
            }
