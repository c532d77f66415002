"""Deterministic fault injection for the serve path.

The port's copy of ``lambdipy_tpu/runtime/faults.py``, with the same
grammar, the same per-site call counting and the same plan API. The
continuous engine's recovery machinery (watchdog, replay of rows that
delivered nothing, degradation ladder — ``runtime/continuous.py``) only
earns trust if every path through it runs in the tests; this module
makes named SITES misbehave on purpose:

========================  ====================================================
site                      where it fires
========================  ====================================================
``segment_dispatch``      the engine thread dispatching a decode segment
``segment_fetch``         the host read of a segment's token block
``transport``             the wait on a segment's CUDA event before the read
``group_prefill``         the engine's ragged joiner prefill, and a replayed
                          long row's prefill on the engine thread
``prefix_assemble``       a continuation from a cached prefix's K/V
``prefix_walk``           the prefix store's cold walk, once per chunk
                          dispatch (an exception fails the walk open: the
                          request serves unrouted)
``page_alloc``            the paged-KV pool taking pages for an admission
``session_pin``           the prefix store pinning a session's head (fails
                          open: the turn serves unpinned, counted)
``offload_stall``         the offload arena's batched re-online fetch (an
                          exception makes the caller prefill again)
========================  ====================================================

The registry lists the sites that have a call site in the port. The JAX
package's fleet sites (``route_*``, ``probe``, ``kv_ship*``,
``session_failover``) belong to the fleet router, which the port does not
have yet: a spec naming one raises ``ValueError`` saying so.

Each site can raise (``exception``), stall (``delay``, ``ms=``) or block
(``hang``: until the plan is released or cleared, the watchdog aborts the
wait, or a hard cap expires so that a test never leaks a thread).

Specs are strings so they travel through the environment and the
handler's extras::

    LAMBDIPY_FAULT="segment_fetch:hang@seg=3"      # hang from the 3rd fetch on
    LAMBDIPY_FAULT="group_prefill:exception"        # raise on the 1st call
    LAMBDIPY_FAULT="transport:delay@ms=200,n=2"     # 200 ms stall, twice
    LAMBDIPY_FAULT="segment_fetch:exception;transport:delay"  # two rules

Grammar: ``site:kind[@key=val,key=val]`` joined by ``;``. ``seg=N`` is the
1-based per-site call index where the rule starts firing (default 1),
``n=K`` how many calls it fires for (default 1 for exception and delay,
unlimited for hang; ``n=inf`` forces unlimited), ``ms=X`` the delay.
Call counting is per site and deterministic, so a case replays
identically run after run. Plans can be armed and cleared at run time
(:meth:`FaultPlan.arm`, :meth:`FaultPlan.clear`): the server's ``POST
/v1/debug/faults`` and the ``faults.armed`` block of ``/metrics``.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass


@dataclass(frozen=True)
class FaultSite:
    """One registered injection point: ``owner`` is the layer whose plan
    drives it (engine, store or pool), ``env`` the variable that arms it
    in a serving process, ``note`` what it does. A test asserts that
    every ``.check("...")`` and ``_device_wait("...")`` call site of the
    port is registered here, and that every site here has one."""

    name: str
    owner: str
    env: str
    note: str


_ENGINE_ENV = "LAMBDIPY_FAULT"

REGISTRY: dict[str, FaultSite] = {s.name: s for s in (
    FaultSite("segment_dispatch", "engine", _ENGINE_ENV,
              "the engine thread dispatching a decode segment"),
    FaultSite("segment_fetch", "engine", _ENGINE_ENV,
              "the host read of a segment's token block"),
    FaultSite("group_prefill", "engine", _ENGINE_ENV,
              "the engine's ragged joiner prefill (and a replayed long "
              "row's prefill on the engine thread)"),
    FaultSite("prefix_assemble", "engine", _ENGINE_ENV,
              "a continuation from a cached prefix's K/V"),
    FaultSite("prefix_walk", "store", _ENGINE_ENV,
              "the prefix store's cold walk, once per chunk dispatch "
              "(exception fails the walk open; delay models per-chunk "
              "prefill device time)"),
    FaultSite("transport", "engine", _ENGINE_ENV,
              "the wait on a segment's CUDA event before the host read"),
    FaultSite("page_alloc", "pool", _ENGINE_ENV,
              "the paged-KV pool taking pages for an admission"),
    FaultSite("session_pin", "store", _ENGINE_ENV,
              "the prefix store pinning a session's radix head (fails "
              "OPEN: the turn serves unpinned, counted)"),
    FaultSite("offload_stall", "store", _ENGINE_ENV,
              "the host offload arena's batched page re-online (delay "
              "= a slow fetch; exception = a FAILED re-online: the "
              "caller prefills the range again, counted, never a wrong "
              "token)"),
)}

# the JAX package's sites whose layers the port does not have yet, and
# the layer each waits for
UNPORTED_SITES = {
    "route_connect": "the fleet router", "route_body": "the fleet router",
    "route_latency": "the fleet router", "probe": "the fleet pool",
    "kv_ship": "the fleet router", "kv_ship_chunk": "the fleet router",
    "session_failover": "the fleet router",
}

SITES = tuple(REGISTRY)
KINDS = ("exception", "delay", "hang")
_KIND_ALIASES = {"error": "exception", "raise": "exception",
                 "sleep": "delay", "stall": "delay", "block": "hang"}

# an injected hang still resolves after this many seconds if nothing
# releases or aborts it, so a test that forgets teardown leaks no thread
# for the life of the process
HANG_CAP_S = 300.0


def list_sites(*, owner: str | None = None,
               env: str | None = None) -> list[FaultSite]:
    """The registered sites, optionally those of one owner or one
    arming variable."""
    return [s for s in REGISTRY.values()
            if (owner is None or s.owner == owner)
            and (env is None or s.env == env)]


class InjectedFault(RuntimeError):
    """An exception (or an aborted hang) raised by the fault layer;
    ``fault_site`` lets the engine attribute the failure."""

    def __init__(self, site: str, kind: str, occurrence: int):
        self.fault_site = site
        self.fault_kind = kind
        self.occurrence = occurrence
        super().__init__(
            f"injected {kind} at {site} (call #{occurrence})")


class EngineWatchdogTimeout(TimeoutError):
    """A device wait outlived the engine's watchdog. Raised to the waiters
    of an engine the watchdog declared wedged, and by guarded request
    waits whose hang the watchdog aborted."""

    def __init__(self, site: str, timeout_s: float):
        self.fault_site = f"watchdog:{site}"
        super().__init__(
            f"engine watchdog: {site} wait exceeded {timeout_s:.3g}s")


@dataclass
class FaultRule:
    site: str
    kind: str
    seg: int = 1            # 1-based call index where firing starts
    n: float = 1            # firings (math.inf = permanent)
    ms: float = 50.0        # delay duration
    fired: int = 0

    def matches(self, count: int) -> bool:
        return self.seg <= count and self.fired < self.n

    def describe(self) -> str:
        span = "inf" if math.isinf(self.n) else str(int(self.n))
        return (f"{self.site}:{self.kind}@seg={self.seg},n={span}"
                + (f",ms={self.ms:g}" if self.kind == "delay" else ""))


def parse_spec(spec: str | None) -> list[FaultRule]:
    """A spec string as rules; a malformed spec, an unknown site or kind,
    or a site the port does not have yet raises ``ValueError``."""
    rules: list[FaultRule] = []
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        head, _, params = part.partition("@")
        site, sep, kind = head.partition(":")
        site, kind = site.strip(), kind.strip().lower()
        kind = _KIND_ALIASES.get(kind, kind)
        if site in UNPORTED_SITES:
            raise ValueError(
                f"fault site {site!r} in {part!r} is not ported: it needs "
                f"{UNPORTED_SITES[site]}, which the port does not have yet")
        if not sep or site not in SITES or kind not in KINDS:
            raise ValueError(
                f"bad fault spec {part!r}: want site:kind with site in "
                f"{SITES} and kind in {KINDS}")
        rule = FaultRule(site=site, kind=kind,
                         n=(math.inf if kind == "hang" else 1))
        for kv in filter(None, (p.strip() for p in params.split(","))):
            key, _, val = kv.partition("=")
            key = key.strip().lower()
            try:
                if key in ("seg", "at"):
                    rule.seg = max(1, int(val))
                elif key == "n":
                    rule.n = math.inf if val.strip() in ("inf", "-1") \
                        else max(1, int(val))
                elif key == "ms":
                    rule.ms = max(0.0, float(val))
                else:
                    raise ValueError(key)
            except ValueError:
                raise ValueError(
                    f"bad fault param {kv!r} in {part!r} "
                    f"(known: seg=N, n=K|inf, ms=X)") from None
        rules.append(rule)
    return rules


class FaultPlan:
    """A deterministic set of :class:`FaultRule`\\ s and the per-site call
    counters they key on. An empty plan costs one ``if`` per check."""

    def __init__(self, rules: list[FaultRule] | None = None):
        self.rules = list(rules or ())
        self._counts: dict[str, int] = {}
        self._lock = threading.Lock()
        self._release = threading.Event()

    @classmethod
    def empty(cls) -> "FaultPlan":
        return cls([])

    @classmethod
    def from_spec(cls, spec: str | None) -> "FaultPlan":
        return cls(parse_spec(spec))

    def check(self, site: str, interrupt: threading.Event | None = None
              ) -> None:
        """Called once per site invocation. No-op without a matching rule;
        else sleeps (delay), raises (exception) or blocks (hang) until
        :meth:`release`, :meth:`clear`, the ``interrupt`` event (the
        watchdog's abort) or the hard cap, and then raises: a wait the
        system gave up on must not look like a success."""
        if not self.rules:
            return
        with self._lock:
            count = self._counts.get(site, 0) + 1
            self._counts[site] = count
            rule = next((r for r in self.rules
                         if r.site == site and r.matches(count)), None)
            if rule is not None:
                rule.fired += 1
        if rule is None:
            return
        if rule.kind == "delay":
            time.sleep(rule.ms / 1e3)
            return
        if rule.kind == "hang":
            # the release event of now: clear() sets it and installs a
            # fresh one, so this hang resolves and a later one still blocks
            release = self._release
            deadline = time.monotonic() + HANG_CAP_S
            while time.monotonic() < deadline:
                if release.wait(0.02):
                    break
                if interrupt is not None and interrupt.is_set():
                    break
        raise InjectedFault(site, rule.kind, count)

    def arm(self, spec: str) -> list[str]:
        """Add ``spec``'s rules to the live plan (the call counters keep
        running); returns their descriptions. A bad spec raises
        ``ValueError`` and changes nothing."""
        rules = parse_spec(spec)
        with self._lock:
            self.rules.extend(rules)
        return [r.describe() for r in rules]

    def clear(self) -> int:
        """Drop every rule and release the hangs in flight (they raise
        :class:`InjectedFault`); hangs armed later block on a fresh event.
        The call counters are kept. Returns the number of rules dropped."""
        with self._lock:
            n = len(self.rules)
            self.rules = []
            released, self._release = self._release, threading.Event()
        released.set()
        return n

    def armed(self) -> dict:
        """The live plan for ``/metrics`` (``faults.armed``): armed rules
        with their remaining firings, and the per-site call counters."""
        with self._lock:
            rules = [{
                "site": r.site,
                "kind": r.kind,
                "seg": r.seg,
                "n": ("inf" if math.isinf(r.n) else int(r.n)),
                **({"ms": r.ms} if r.kind == "delay" else {}),
                "fired": r.fired,
                "remaining": ("inf" if math.isinf(r.n)
                              else max(0, int(r.n) - r.fired)),
            } for r in self.rules]
            counts = dict(self._counts)
        return {"active": bool(rules),
                "sites": sorted({r["site"] for r in rules}),
                "rules": rules,
                "counts": counts}

    def release(self) -> None:
        """Unblock every hang in flight and to come (test teardown)."""
        self._release.set()

    def active(self) -> bool:
        return bool(self.rules)

    def counts(self) -> dict:
        with self._lock:
            return dict(self._counts)

    def describe(self) -> list[str]:
        return [r.describe() for r in self.rules]
