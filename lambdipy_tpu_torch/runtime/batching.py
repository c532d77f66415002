"""Server-side micro-batching for the generate handler: the port's
``MicroBatcher``, twin of ``lambdipy_tpu/runtime/batching.py``.

The HTTP server is threaded; under concurrent load each request would run
on the card alone. ``LlamaServer.generate`` serves ragged batches (per-row
lengths and knobs), and a decode step reads the weights once for every row
it holds, so concurrent requests can share one call.

Protocol (JAX's): the first thread to arrive becomes the leader, sleeps one
collection window while followers queue, then drains every compatible
pending request, in policy order, into one ragged ``server.generate``.
After every batch the condition variable wakes all waiters: finished
requests return, and the current queue head's own thread drains the next
group, so each thread serves at most the batches its own request rides on
and no composition can strand a request. Errors surface per request; the
server's batch bucket (a power of two) bounds the programs a burst makes.

Every request shape fuses: the sampling knobs (temperature, top-k/p, eos)
are per-row operands of the fused call, and each row's stream is keyed
from its own seed alone (``LlamaServer._knobs_host``: ``(seed_r, 0)``, a
solo request's key), so a row's output, greedy or sampled, is its solo
call's. The port fuses a request only into a batch of its own prefill
width (``LlamaServer.prompt_bucket``), where JAX fuses any widths that fit
the window: a prefill's plain attention reduces over the padded width, and
on the card a row's bits would otherwise depend on its neighbours' prompt
lengths. The decode kernels, the int8 GEMV and the tiled prefill matmul
compute each row alone, so within one width a fused row is bitwise its
solo ``generate``.

Opt-in per bundle: ``[payload.extra] batch_window_ms = 2`` (0 = off).
"""

from __future__ import annotations

import itertools
import threading
import time

from lambdipy_tpu_torch.sched import current_request_class
from lambdipy_tpu_torch.utils.logs import get_logger

log = get_logger("lambdipy.batching")

_seq = itertools.count()


def _remove(entries: list, entry: dict) -> None:
    """Remove ``entry`` by identity: ``list.remove`` compares entries with
    ``==``, which compares their prompt arrays."""
    del entries[next(i for i, e in enumerate(entries) if e is entry)]


class MicroBatcher:
    """Group concurrent single-row generate calls into ragged batches.

    ``policy`` (a ``sched.policy`` object) orders batch formation: pending
    entries are drained in policy order (priority / fair-share classes,
    tagged from the scheduler's request context) instead of arrival order.
    None keeps arrival order."""

    def __init__(self, server, *, window_ms: float = 2.0, max_batch: int = 8,
                 policy=None):
        self.server = server
        self.window_s = max(0.0, window_ms) / 1e3
        self.max_batch = max(1, max_batch)
        self.policy = policy
        self._cond = threading.Condition()
        self._pending: list[dict] = []
        self._collecting = False   # a leader is inside its window
        self.batches_run = 0
        self.rows_served = 0

    # -- internals ----------------------------------------------------------

    def _ordered_locked(self) -> list[dict]:
        """Pending entries in handoff order (policy order, else arrival)."""
        if self.policy is None:
            return list(self._pending)
        return self.policy.order(list(self._pending))

    def _head_locked(self) -> dict | None:
        """The entry whose thread should serve the next group: the
        policy's state-free head pick (wait loops poll it; a mutating pick
        could livelock two out-of-phase waiters)."""
        if not self._pending:
            return None
        if self.policy is None:
            return self._pending[0]
        return self.policy.head(self._pending)

    def _drain_locked(self) -> list[dict]:
        """Take the pending entries that can fuse: the fused call pays
        max(prompt len) + max(max_new) and the shared decode cap, and (the
        port's rule) prefills at one width, so an entry valid solo may not
        fit the forming batch: it stays queued for a later batch rather
        than poisoning this one. The head entry is always taken, alone if
        need be, so its own (possibly invalid) request errors only to its
        caller. Candidates come in the policy's order."""
        max_len = self.server.model.cfg.max_len
        cap = self.server.decode_cap
        width = self.server.prompt_bucket
        ordered = self._ordered_locked()
        head = self._head_locked()
        if head is not None and ordered and ordered[0] is not head:
            # the unconditionally taken first slot is the policy head (the
            # entry whose thread serves this group): the progress invariant
            _remove(ordered, head)
            ordered.insert(0, head)
        batch: list[dict] = []
        s_max = n_max = 0
        for e in ordered:
            if len(batch) >= self.max_batch:
                break
            s = max(s_max, len(e["row"]))
            n = max(n_max, e["n"])
            if batch and (s + n > max_len or n > cap or any(
                    width(len(x["row"]), x["n"]) != width(s, n)
                    for x in (*batch, e))):
                continue
            s_max, n_max = s, n
            batch.append(e)
            _remove(self._pending, e)
        return batch

    def _run_one(self, batch: list[dict]) -> None:
        if not batch:
            return
        try:
            n = max(e["n"] for e in batch)
            want_lp = any(e["want_lp"] for e in batch)
            out = self.server.generate(
                [e["row"] for e in batch], max_new_tokens=n,
                temperature=[e["temperature"] for e in batch],
                top_k=[e["top_k"] for e in batch],
                top_p=[e["top_p"] for e in batch],
                seed=[e["seed"] for e in batch],
                eos_id=[e["eos_id"] for e in batch],
                return_logprobs=want_lp)
            toks, lps = out if want_lp else (out, None)
            for i, e in enumerate(batch):
                e["result"] = toks[i:i + 1, :e["n"]]
                if lps is not None:
                    e["lps"] = lps[i:i + 1, :e["n"]]
        except Exception as ex:  # noqa: BLE001 — surfaces per request
            log.warning("micro-batch of %d row(s) failed: %s", len(batch), ex)
            for e in batch:
                e["error"] = ex
        with self._cond:
            self.batches_run += 1
            self.rows_served += len(batch)
            for e in batch:
                e["done"] = True
            self._cond.notify_all()

    def _serve_group(self) -> None:
        with self._cond:
            batch = self._drain_locked()
        self._run_one(batch)

    # -- API ----------------------------------------------------------------

    def generate(self, prompt_row, *, max_new_tokens: int,
                 temperature: float = 0.0, top_k=None, top_p=None,
                 seed: int = 0, eos_id=None, return_logprobs: bool = False):
        """One request row -> ``[1, max_new_tokens]`` (the contract of
        ``server.generate`` on a single prompt, logprobs included)."""
        if self.window_s <= 0.0:
            return self.server.generate(
                prompt_row, max_new_tokens=max_new_tokens,
                temperature=temperature, top_k=top_k, top_p=top_p,
                seed=seed, eos_id=eos_id, return_logprobs=return_logprobs)
        entry = {"row": prompt_row, "n": max_new_tokens,
                 "temperature": temperature, "top_k": top_k, "top_p": top_p,
                 "seed": seed, "eos_id": eos_id,
                 "want_lp": return_logprobs, "lps": None,
                 "done": False, "result": None, "error": None,
                 "cls": current_request_class(), "seq": next(_seq)}
        with self._cond:
            self._pending.append(entry)
            leader = len(self._pending) == 1
            if leader:
                self._collecting = True
            self._cond.notify_all()  # a collecting leader may now be full
        if leader:
            # collect for one window, waking early once full
            deadline = time.monotonic() + self.window_s
            with self._cond:
                while (remaining := deadline - time.monotonic()) > 0:
                    if len(self._pending) >= self.max_batch:
                        break
                    self._cond.wait(timeout=remaining)
                self._collecting = False
            self._serve_group()
        while True:
            with self._cond:
                if entry["done"]:
                    break
                if self._collecting or self._head_locked() is not entry:
                    # a leader is still inside its window (a policy-head
                    # arrival must not cut it short), or another thread's
                    # batch is in flight: the notify after it wakes us
                    self._cond.wait(timeout=1.0)
                    continue
            # the policy's queue head: serve its own group now (leftovers
            # past the leader's batch, entries that could not fuse)
            self._serve_group()
        if entry["error"] is not None:
            raise entry["error"]
        if return_logprobs:
            return entry["result"], entry["lps"]
        return entry["result"]

    def stats(self) -> dict:
        with self._cond:
            return {"batches_run": self.batches_run,
                    "rows_served": self.rows_served,
                    "pending": len(self._pending)}
