"""Fleet front-door: prefix-affinity HTTP router over a ReplicaPool.

The port's copy of ``lambdipy_tpu/fleet/router.py``: the same routing,
retries, hedges, spill queue, phase split and sessions, with the same
``/metrics`` keys and log events, over replicas of the port's server
(``runtime/server.py``), whose ``/v1/kv/*`` routes, session pins and
``/healthz`` keys are JAX's.

One listening port fronting N bundle-server replicas. Per request:

1. **pick** — the prompt's leading token blocks (fleet/affinity.py, same
   block width as the radix prefix cache) rendezvous-hash to a replica,
   so repeated prefixes land where their KV already lives; the router
   falls back to least-outstanding-requests when the affinity target is
   ejected, draining, or saturated (``outstanding >= saturation``), and
   round-robins ties so affinity-off traffic actually spreads.
2. **forward** — the body and scheduling headers (``x-priority``,
   ``x-deadline-ms``, ``x-api-key``/``x-tenant``) pass through verbatim;
   responses relay status, body, and ``Retry-After`` unchanged, so a
   fleet client sees exactly the single-server contract.
3. **retry** — a dead connection or a sched-layer shed (429/503) retries
   on a DIFFERENT replica with jittered backoff; the backoff honors the
   shed's ``Retry-After`` (capped), and connection failures are reported
   to the pool so a dead replica is ejected at traffic speed. Retries
   are governed by two resilience layers (fleet/breaker.py, both
   optional): per-replica CIRCUIT BREAKERS (consecutive forward
   failures or latency outliers open the breaker; after ``open_s`` one
   half-open probe decides readmission — a partially-dead replica stops
   eating retry attempts) and a fleet-wide RETRY BUDGET (re-sends
   capped at a ratio of primary sends, so a fleet-wide failure is
   relayed honestly instead of amplified into a retry storm). When
   every replica shed, the LAST shed response is relayed (with its
   ``Retry-After``) — unless the SPILL QUEUE (fleet/spill.py) is
   enabled, in which case non-streamed requests park in a bounded
   sched-backed queue and drain as replicas recover, shedding only on
   queue overflow or deadline expiry (with the queue's own wait
   estimate as ``Retry-After``). Generate requests are stateless, so
   retrying is always safe; a request is only non-retryable once
   response bytes have reached the client.
4. **hedge** (optional) — a non-streamed request still unanswered after
   the hedge threshold (fixed ms, or ``"p95"`` = the router's own
   observed P95, floored) is duplicated on a second replica; the first
   answer wins. Streamed requests never hedge (two live streams cannot
   be reconciled) but do retry while nothing has been forwarded.

Streaming (``stream: true`` on ``/invoke`` ndjson or ``/v1/completions``
SSE) is a line-wise pass-through: the replica's chunked response is
re-framed to the client byte-identically.

DISAGGREGATED (phase-split) serving: when the pool holds PREFILL-class
replicas (``lambdipy fleet --prefill-replicas M``, or attach grammar
``NAME=URL:prefill``), the router splits a cold request's lifecycle —
prefill is compute-bound and bursty, decode is HBM-bound and steady, and
co-locating them means every prefill burst stalls the decode batch.
Before forwarding, :meth:`_maybe_ship` (1) picks the affinity-chosen
DECODE-class replica, (2) sends the prompt's whole-block token head to a
prefill-class replica's ``/v1/kv/export`` (that call IS the prefill:
missing blocks prefill into the prefill replica's radix store and leave
as a dtype/int8-scale-aware wire frame — runtime/kvwire.py), and (3)
POSTs the frame to the decode replica's ``/v1/kv/import``, where a ship
arrival is just a radix insert (zero-copy into arena pages under
``--kv-paged``). The request then forwards normally; the decode replica
longest-prefix-matches the shipped KV and serves decode from its far
deeper batch. EVERY failure along that path — no prefill replica, a
dead export, import backpressure from a full page arena, an injected
``kv_ship`` fault — falls back to MIXED-mode local prefill on the
decode replica, counted by reason in ``fleet.disagg.fallbacks``: a
fallback is a slower request, never a lost one (the same
zero-silent-loss bar as ``--chaos-fleet``). Ships respect the circuit
breakers (both legs ride :meth:`_forward`) and never retry — a failed
ship spends no retry budget, it just degrades to mixed. A per-replica
shipped-key LRU dedupes repeat ships; an ejected replica's entry is
cleared on readmission (its radix cache died with the worker).
Prefill-class replicas never serve decode traffic, and affinity
rendezvous-hashes over the decode-capable replicas only — unless NO
decode-capable replica is routable, in which case the router degrades
to the prefill class rather than browning out (mixed-mode again).

STICKY SESSIONS (multi-turn chat): a request carrying ``x-session-id``
(or a ``session_id`` body field) routes STICKY — the session id
overrides prefix-affinity rendezvous so every turn lands on the replica
holding the conversation's PINNED radix KV (runtime/prefixstore.py
session pins), making turn-2+ TTFT ~0 prefill. A session the router has
never seen (first turn, or any turn after a router restart) falls back
to NORMAL prefix affinity over the body — never a hash of the bare
session id, which would scatter the first post-restart turn away from
the replica whose radix cache still holds the conversation — and the
replica that actually serves becomes the recorded home. When the home
is ejected/draining, the router performs a SESSION FAILOVER: re-target
by rendezvous over the surviving decode-capable membership and RE-SHIP
the session's whole-block KV head to the new home through the existing
``/v1/kv/export`` → ``/v1/kv/import`` legs (the per-replica ship-dedup
LRU forgets the session's prefix on failover so later phase-split ships
re-send). Every re-ship failure degrades to counted mixed-mode local
re-prefill on the new home — in the common SIGKILL case the old home's
KV died with the worker, so that fallback IS the recovery path and the
re-prefilled turn is bitwise the same answer. ``DELETE
/v1/sessions/{id}`` fans out to the decode-capable replicas (releasing
their pins) and drops the router's sticky record.

``GET /metrics`` aggregates every replica's own ``/metrics`` (so the
fleet-wide prefix-cache hit rate is one read) and adds the router's
counters (runtime/metrics.RouterStats) plus the pool's per-replica
state/ejection/restart counters.
"""

from __future__ import annotations

import http.client
import json
import math
import random
import threading
import time
import urllib.error
import urllib.request
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from queue import Empty, Full, Queue

from lambdipy_tpu_torch.fleet import affinity
from lambdipy_tpu_torch.fleet.breaker import CircuitBreaker, RetryBudget
from lambdipy_tpu_torch.fleet.pool import PREFILL, Replica, ReplicaPool
from lambdipy_tpu_torch.fleet.spill import SPILL_DEADLINE, SpillQueue
from lambdipy_tpu_torch.runtime.deploy import _http_json
from lambdipy_tpu_torch.runtime.faults import FaultPlan, InjectedFault
from lambdipy_tpu_torch.runtime.kvwire import MAGIC as _KV_MAGIC
from lambdipy_tpu_torch.runtime.kvwire import FrameSplitter
from lambdipy_tpu_torch.runtime.metrics import (DisaggStats, RouterStats,
                                          SessionStats)
from lambdipy_tpu_torch.sched.admission import Shed
from lambdipy_tpu_torch.utils.logs import get_logger, log_event

log = get_logger("lambdipy.fleet.router")

_FORWARD_HEADERS = ("x-priority", "x-deadline-ms", "x-api-key", "x-tenant",
                    "x-session-id", "x-session-ttl-s")
_ROUTED_PATHS = ("/invoke", "/v1/completions")


class _ShipStalled(Exception):
    """The ship relay's own stall signal (reader window parked past the
    deadline, or the export feed going quiet). Deliberately NOT a
    TimeoutError: on py3.10 ``socket.timeout`` IS ``TimeoutError``, and
    an import-leg send timeout must be classified against the decode
    replica, never surface through the reader-side passthrough and
    penalize the healthy prefill replica's breaker."""


class FleetRouter:
    def __init__(self, pool: ReplicaPool, *, host: str = "127.0.0.1",
                 port: int = 0, affinity_on: bool = True,
                 block: int = affinity.DEFAULT_BLOCK, max_retries: int = 2,
                 backoff_s: float = 0.05, backoff_cap_s: float = 2.0,
                 saturation: int = 8, hedge_ms: float | str = 0,
                 hedge_floor_ms: float = 50.0,
                 request_timeout: float = 300.0,
                 spill_cap: int = 0, spill_max_wait_s: float = 30.0,
                 breaker_fails: int = 0, breaker_open_s: float = 1.0,
                 breaker_outlier_ms: float = 0.0,
                 retry_budget: float = 0.0, retry_budget_min: int = 3,
                 warm_prefixes: int = 4,
                 ship_window: int = 4, ship_pipelined: bool = True,
                 session_record_ttl_s: float = 3600.0,
                 faults: FaultPlan | None = None):
        self.pool = pool
        self.affinity_on = bool(affinity_on)
        self.block = max(1, int(block))
        self.max_retries = max(0, int(max_retries))
        self.backoff_s = float(backoff_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.saturation = max(1, int(saturation))
        self.hedge_ms = hedge_ms
        self.hedge_floor_ms = float(hedge_floor_ms)
        self.request_timeout = float(request_timeout)
        self.stats = RouterStats()
        self.faults = faults or FaultPlan.empty()
        # fleet-boundary resilience (all off by default at the library
        # level so embedders opt in; `lambdipy fleet` turns them on)
        self.spill: SpillQueue | None = None
        if int(spill_cap) > 0:
            self.spill = SpillQueue(
                lambda: bool(self.pool.routable()
                             or self.pool.live_fallback()),
                capacity=int(spill_cap),
                max_wait_s=float(spill_max_wait_s)).start()
        self.breaker_fails = max(0, int(breaker_fails))
        self.breaker_open_s = float(breaker_open_s)
        self.breaker_outlier_ms = float(breaker_outlier_ms)
        self.breakers: dict[str, CircuitBreaker] | None = \
            {} if self.breaker_fails > 0 else None
        self.retry_budget: RetryBudget | None = None
        if float(retry_budget) > 0:
            self.retry_budget = RetryBudget(ratio=float(retry_budget),
                                            min_retries=retry_budget_min)
        # hot-prefix tracker for affinity-aware cache warming: key ->
        # {prompt, hits}, LRU-bounded; replayed into a replica when the
        # pool (re)admits it
        self.warm_prefixes = max(0, int(warm_prefixes))
        self._hot: OrderedDict = OrderedDict()
        self._hot_cap = max(8, 8 * self.warm_prefixes)
        self._hot_lock = threading.Lock()
        # disaggregated (phase-split) serving: active exactly when the
        # pool holds prefill-class replicas. The shipped-key LRU (per
        # decode replica) dedupes repeat ships of the same prefix; an
        # entry dies with its replica's ejection (the on_admit hook
        # clears it on readmission — the radix cache is gone).
        self.disagg = DisaggStats()
        self._shipped: dict[str, OrderedDict] = {}
        self._shipped_cap = 512
        self._ship_lock = threading.Lock()
        # pipelined (chunked) shipping: ship_window bounds the relay's
        # in-flight chunk frames between the export and import legs
        # (0 = the pre-chunking monolithic ship, one LKV1 frame per
        # round trip); ship_pipelined=False keeps the chunked wire but
        # buffers the whole export before relaying — the blocking
        # baseline the pipelined relay's overlap is measured against
        self.ship_window = max(0, int(ship_window))
        self.ship_pipelined = bool(ship_pipelined)
        # per-class busy-fraction EWMAs (fleet.disagg.util), folded
        # from the pool's time-weighted occupancy at scrape time
        self._util_lock = threading.Lock()
        self._util_prev = {"t": time.monotonic(), "busy": {}}
        # sticky multi-turn sessions: sid -> {home, head, key, t}, LRU-
        # bounded (losing a record only loses stickiness — the next turn
        # re-places by prefix affinity, which is where the KV lives
        # anyway). `head` is the conversation's whole-block token head,
        # what a failover re-ship exports from the old home. Records
        # idle past session_record_ttl_s are swept LAZILY (found by the
        # chaos soak's quiesce probe: replica-side pin LEASES expire,
        # but a router record only ever died by cap pressure or DELETE,
        # so a long-lived router's session gauge drifted arbitrarily
        # far from the fleet's real pinned state).
        self.sessions = SessionStats()
        self._session_map: OrderedDict = OrderedDict()
        self._session_cap = 4096
        self.session_record_ttl_s = max(1.0, float(session_record_ttl_s))
        self._session_lock = threading.Lock()
        # on_admit is always hooked: it clears the shipped-key cache
        # for a readmitted replica, then (when enabled) cache-warms it
        pool.on_admit = self._on_replica_admitted
        # on_drain: proactive session re-ship — a draining home's
        # pinned conversation heads move to their rendezvous successor
        # BEFORE the drain's /shutdown, so the next turn pays a sticky
        # hit instead of a failover re-prefill
        pool.on_drain = self._on_replica_drain
        self._rr = 0  # tie-break rotation for least-outstanding picks
        self._rr_lock = threading.Lock()
        # the elastic control loop (fleet/controller.py) registers
        # itself here; when present its report rides the fleet /metrics
        self.controller = None
        self._httpd = ThreadingHTTPServer((host, port), self._make_handler())
        self.port = self._httpd.server_address[1]
        self._thread: threading.Thread | None = None

    # -- replica selection --------------------------------------------------

    def _least_outstanding(self, cands: list[Replica]) -> Replica:
        with self._rr_lock:
            self._rr += 1
            rot = self._rr % len(cands)
        # rotate before min: equal-depth candidates round-robin instead
        # of the dict-order first replica absorbing every tie
        cands = cands[rot:] + cands[:rot]
        return min(cands, key=lambda r: r.outstanding)

    def _breaker(self, r: Replica) -> CircuitBreaker | None:
        if self.breakers is None:
            return None
        b = self.breakers.get(r.name)
        if b is None:
            b = self.breakers.setdefault(r.name, CircuitBreaker(
                fail_threshold=self.breaker_fails,
                open_s=self.breaker_open_s,
                outlier_ms=self.breaker_outlier_ms,
                # an unresolved probe (504 busy, gone stream client) is
                # abandoned after the longest a forward can take
                probe_grace_s=min(self.request_timeout, 60.0)))
        return b

    def _breaker_blocked(self, r: Replica) -> bool:
        b = self._breaker(r)
        return b is not None and b.blocked()

    def _breaker_result(self, r: Replica, *, ok: bool,
                        latency_ms: float | None = None) -> None:
        b = self._breaker(r)
        if b is None:
            return
        opens_before = b.opens
        if ok:
            b.record_success(latency_ms)
        else:
            b.record_failure()
        if b.opens > opens_before:
            log_event(log, "circuit breaker opened", replica=r.name,
                      cause=b.last_cause)

    def _pick(self, key: bytes | None, exclude: set,
              *, count_affinity: bool,
              prefer: str | None = None) -> Replica | None:
        """``prefer`` is the sticky-session home: when it is among the
        usable candidates it wins outright (the conversation's pinned
        KV lives there); otherwise the pick degrades to normal affinity
        — the failover path has already re-homed the session by the
        time a pick can miss, so a miss here is only the narrow race
        between the sticky check and the pick."""
        def usable(rs):
            return [r for r in rs if r.name not in exclude
                    and not self._breaker_blocked(r)]

        # prefill-class replicas are dedicated to export legs: request
        # traffic routes over the decode-capable (decode/mixed) set...
        cands = usable(r for r in self.pool.routable()
                       if r.role != PREFILL)
        if not cands:
            # degrade to live-but-not-ready replicas (warm in flight /
            # server-side drain flag) rather than 503ing the fleet: a
            # warming replica serves fine, and a draining one sheds a
            # retryable 503 — both beat a synthetic no_replica
            cands = usable(r for r in self.pool.live_fallback()
                           if r.role != PREFILL)
        if not cands:
            # ...unless NOTHING decode-capable is left: a prefill-class
            # replica is a full bundle server, and serving mixed-mode on
            # it beats browning out the fleet (counted, never silent)
            cands = usable(self.pool.routable()) or \
                usable(self.pool.live_fallback())
            if cands:
                self.disagg.record_fallback("no_decode_replica")
        if not cands:
            return None
        chosen: Replica
        if prefer is not None:
            sticky = next((r for r in cands if r.name == prefer), None)
            # the saturation valve applies to sticky homes like any
            # other target: a replica hosting many hot sessions must
            # spill past the threshold (the turn re-homes and pays one
            # re-prefill) instead of melting while the fleet idles
            if sticky is not None and \
                    sticky.outstanding < self.saturation:
                b = self._breaker(sticky)
                if b is not None:
                    b.begin_attempt()
                return sticky
            self.sessions.count("sticky_misses")
        if key is not None and self.affinity_on:
            target_name = affinity.pick_replica(
                key, sorted(r.name for r in cands))
            target = next(r for r in cands if r.name == target_name)
            if target.outstanding >= self.saturation:
                if count_affinity:
                    self.stats.count_affinity("saturated")
                chosen = self._least_outstanding(cands)
            else:
                if count_affinity:
                    # "hit" only when the full-membership rendezvous
                    # target was routable: a pick among survivors after
                    # an ejection is affinity-consistent but not a
                    # cache-affinity hit. Membership = decode-capable
                    # replicas (prefill-class replicas hold export
                    # traffic, not affinity cache).
                    all_names = sorted(
                        n for n, r in self.pool.replicas.items()
                        if r.role != PREFILL)
                    full_target = affinity.pick_replica(
                        key, all_names or sorted(self.pool.replicas))
                    self.stats.count_affinity(
                        "hit" if full_target == target_name else "ejected")
                chosen = target
        else:
            chosen = self._least_outstanding(cands)
        b = self._breaker(chosen)
        if b is not None:
            b.begin_attempt()  # claim the half-open probe slot if due
        return chosen

    # -- forwarding ---------------------------------------------------------

    def _fwd_headers(self, headers) -> dict:
        out = {"Content-Type": "application/json"}
        for h in _FORWARD_HEADERS:
            v = headers.get(h)
            if v:
                out[h] = v
        return out

    def _forward(self, replica: Replica, path: str, data: bytes,
                 headers: dict) -> tuple[int, dict, bytes]:
        """POST to one replica; HTTP error statuses return as statuses,
        connection-level failures raise. Feeds the replica's circuit
        breaker (a 503 shed is explicit backpressure, not a fault; a
        timeout is a busy replica, not a dead one — neither counts as a
        breaker failure) and the router-side fault sites."""
        req = urllib.request.Request(replica.url + path, data=data,
                                     headers=headers, method="POST")
        self.pool.acquire(replica)
        t0 = time.monotonic()
        try:
            # network chaos sites: a simulated latency spike, a dropped
            # connection, and a connection dying mid-body (the body was
            # read but never arrived intact)
            self.faults.check("route_latency")
            self.faults.check("route_connect")
            try:
                with urllib.request.urlopen(
                        req, timeout=self.request_timeout) as resp:
                    out = resp.status, dict(resp.headers), resp.read()
            except urllib.error.HTTPError as e:
                out = e.code, dict(e.headers), e.read()
            self.faults.check("route_body")
            ok = out[0] < 500 or out[0] == 503
            self._breaker_result(
                replica, ok=ok,
                latency_ms=(time.monotonic() - t0) * 1e3 if ok else None)
            return out
        except Exception as e:  # noqa: BLE001 — classify for the breaker
            # (HTTPError cannot reach here — the inner except converts
            # it to a status tuple; only connection-level failures and
            # injected faults do)
            if not self._is_timeout(e):
                self._breaker_result(replica, ok=False)
            raise
        finally:
            self.pool.release(replica)

    @staticmethod
    def _is_timeout(e: Exception) -> bool:
        """A deadline expiry on an ACCEPTED request — the replica is
        busy, not dead. Distinguished from connection failures so one
        over-long generation neither ejects a healthy replica nor gets
        re-sent to burn a second replica's device time."""
        import socket

        return isinstance(e, (socket.timeout, TimeoutError)) or \
            isinstance(getattr(e, "reason", None),
                       (socket.timeout, TimeoutError))

    @staticmethod
    def _retry_after_s(status: int, hdrs: dict, body: bytes) -> float:
        """The shed's own backoff hint: exact float from the JSON body
        when present, else the integer header, else 0."""
        try:
            parsed = json.loads(body)
            val = parsed.get("retry_after_s")
            if val is None:
                val = (parsed.get("error") or {}).get("retry_after_s")
            if val is not None:
                return float(val)
        except (ValueError, AttributeError):
            pass
        try:
            return float(hdrs.get("Retry-After", 0))
        except (TypeError, ValueError):
            return 0.0

    def _backoff(self, attempt: int, hint_s: float, *,
                 others_available: bool) -> None:
        """Jittered backoff between attempts. With another replica free
        the retry goes immediately (the hint priced THAT replica's
        queue, not the fleet); when rotating back, honor the hint."""
        base = self.backoff_s * (2 ** attempt)
        if not others_available:
            base = max(base, hint_s)
        delay = min(self.backoff_cap_s, base) * random.uniform(0.5, 1.0)
        if delay > 0:
            time.sleep(delay)

    def _hedge_threshold_s(self) -> float | None:
        if not self.hedge_ms:
            return None
        if self.hedge_ms == "p95":
            p95 = self.stats.latency.percentile(95)
            if p95 is None or self.stats.latency.count < 20:
                return None  # not enough signal to hedge on yet
            return max(self.hedge_floor_ms, p95) / 1e3
        return max(float(self.hedge_ms), self.hedge_floor_ms) / 1e3

    # -- affinity-aware cache warming ---------------------------------------

    def _note_hot_prefix(self, key: bytes, body: dict) -> None:
        """Track the fleet's hottest affinity prefixes (LRU + hit
        count) so a readmitted or freshly attached replica can be
        warmed with the prefixes the rendezvous hash will send it."""
        if not self.warm_prefixes:
            return
        with self._hot_lock:
            entry = self._hot.get(key)
            if entry is not None:
                entry["hits"] += 1
                self._hot.move_to_end(key)
                return
        prompt = affinity.warm_prompt(body, block=self.block)
        if prompt is None:
            return  # sub-block prompt: nothing the radix store caches
        with self._hot_lock:
            if key not in self._hot:
                self._hot[key] = {"prompt": prompt, "hits": 1}
                while len(self._hot) > self._hot_cap:
                    self._hot.popitem(last=False)

    def _on_replica_admitted(self, replica: Replica) -> None:
        """Pool hook: a replica just became routable (first probe after
        attach/spawn, or readmission after an ejection). Its radix
        cache died with the old worker, so the shipped-key dedup cache
        must forget it — otherwise the router would skip ships the
        replica can no longer serve from. Then warm it in the
        background — the prober thread must not block on prefills."""
        with self._ship_lock:
            self._shipped.pop(replica.name, None)
        if self.warm_prefixes:
            threading.Thread(target=self._warm_replica, args=(replica,),
                             daemon=True,
                             name=f"fleet-warm-{replica.name}").start()

    def _warm_replica(self, replica: Replica) -> None:
        """Replay this replica's share of the fleet's hottest prefixes
        (the keys the FULL-membership rendezvous hash assigns to it)
        as background-class 1-token generations: the prefill IS the
        radix-cache insertion, so the next real request on the warmed
        prefix longest-prefix-matches instead of paying a cold
        prefill."""
        with self._hot_lock:
            items = [(k, e["hits"], e["prompt"])
                     for k, e in self._hot.items()]
        if not items:
            return
        # warm over the decode-capable membership: a prefill-class
        # replica holds no affinity share (and gets an empty `mine`)
        names = sorted(n for n, r in self.pool.replicas.items()
                       if r.role != PREFILL) or sorted(self.pool.replicas)
        mine = [(hits, prompt) for k, hits, prompt in items
                if affinity.pick_replica(k, names) == replica.name]
        mine.sort(key=lambda t: -t[0])
        for _, prompt in mine[: self.warm_prefixes]:
            body = json.dumps({"prompt": prompt, "max_tokens": 1,
                               "temperature": 0}).encode()
            req = urllib.request.Request(
                replica.url + "/v1/completions", data=body,
                headers={"Content-Type": "application/json",
                         "x-priority": "background"}, method="POST")
            try:
                with urllib.request.urlopen(
                        req, timeout=self.request_timeout) as resp:
                    resp.read()
                self.stats.count("warmed_prefixes")
            except Exception as e:  # noqa: BLE001 — warming is advisory
                log_event(log, "cache warm failed", replica=replica.name,
                          error=str(e))
                return  # an unhealthy target: stop, health owns it now

    # -- sticky multi-turn sessions ------------------------------------------

    @staticmethod
    def _session_id(headers, body: dict) -> str | None:
        """Same precedence as the replica server's `_session_header`:
        the BODY field wins over the header — both layers must track
        one request under one id, or a DELETE through the router would
        release nothing while the replica's pins live on."""
        sid = body.get("session_id")
        if sid is None or not str(sid):
            sid = headers.get("x-session-id")
        # same acceptance as the handler (`session_id: 0` is a valid
        # id): only None/empty fall through
        return str(sid) if sid is not None and str(sid) else None

    def _decode_capable(self) -> dict[str, Replica]:
        """Name -> replica for every usable sticky/failover target."""
        return {r.name: r for r in self.pool.routable()
                if r.role != PREFILL and not self._breaker_blocked(r)}

    def _sweep_session_records_locked(self, now: float) -> None:
        """Lazily drop sticky records idle past ``session_record_ttl_s``
        (LRU order — the front of the map is the longest-idle record).
        The replica-side pin LEASES expired long ago for these; keeping
        the record only misreports ``fleet.sessions.active`` and makes
        a post-idle turn chase a home whose pins are gone anyway (a
        prefix-affinity re-place serves it identically)."""
        ttl = self.session_record_ttl_s
        while self._session_map:
            _, rec = next(iter(self._session_map.items()))
            if now - rec.get("t", now) <= ttl:
                break
            self._session_map.popitem(last=False)
            self.sessions.count("record_expiries")

    def _live_session_count(self) -> int:
        """Session gauge for /metrics, /healthz and the invariant
        sweep: runs the lazy TTL sweep first, so a scrape alone
        converges the router's view like the replica's own lease
        expiry does."""
        with self._session_lock:
            self._sweep_session_records_locked(time.monotonic())
            return len(self._session_map)

    def _session_sticky(self, sid: str, body: dict) -> str | None:
        """Resolve the session's home replica for this turn: the
        recorded home when it is still routable (sticky hit), a freshly
        failed-over home when it is not, or None for a session the
        router has never seen — the caller then places the turn by
        NORMAL prefix affinity (the post-restart first turn must land
        where the prompt's prefix key says the KV lives, not where a
        hash of the session id scatters it) and records whoever
        serves."""
        with self._session_lock:
            rec = self._session_map.get(sid)
        if rec is None:
            # unknown session: no head to extend — _note_session_home
            # computes it once after the serving replica is known
            return None
        head = affinity.ship_prompt(
            body, block=self.block,
            key_blocks=affinity.SESSION_KEY_BLOCKS)
        with self._session_lock:
            # re-check: a concurrent DELETE (or the cap sweep) may have
            # dropped the record while ship_prompt ran unlocked
            if sid not in self._session_map:
                return None
            self._session_map.move_to_end(sid)
            rec["t"] = time.monotonic()
            # each turn's prompt extends the conversation: keep the
            # LONGEST head seen — that is what a failover re-ships
            if head is not None and (rec["head"] is None
                                     or len(head) > len(rec["head"])):
                rec["head"] = head
            home = rec["home"]
        cands = self._decode_capable()
        if home in cands:
            self.sessions.count("sticky_hits")
            return home
        return self._session_failover(sid, rec, cands)

    def _session_failover(self, sid: str, rec: dict,
                          cands: dict[str, Replica]) -> str | None:
        """The home died or drained: re-target via rendezvous over the
        SURVIVING decode-capable membership and try to re-ship the
        session's whole-block KV head from the old home to the new one.
        Every failure of the re-ship degrades to counted mixed-mode
        local re-prefill on the new home — when the old home is
        unreachable (the SIGKILL case: its radix cache died with the
        worker) that fallback IS the recovery, and the re-prefilled
        turn is bitwise the same answer."""
        if not cands:
            return None  # nothing decode-capable: _pick's degrade owns it
        self.sessions.count("failovers")
        old_home = rec["home"]
        new_home = affinity.pick_replica(affinity.session_key(sid),
                                         sorted(cands))
        with self._session_lock:
            rec["home"] = new_home
        # the ship-dedup LRU must forget this session's prefix: the new
        # home may carry a stale entry from pre-failover phase-split
        # traffic, and the old home's entry is meaningless now
        akey = rec.get("key")
        if akey is not None:
            with self._ship_lock:
                for seen in self._shipped.values():
                    seen.pop(akey, None)
        reason = self._session_reship(rec.get("head"), old_home,
                                      cands[new_home])
        if reason is None:
            self.sessions.count("reships")
            if akey is not None:
                # the new home now holds the head: the phase-split
                # dedup should skip the very next turn's ship for it
                with self._ship_lock:
                    seen = self._shipped.setdefault(new_home,
                                                    OrderedDict())
                    seen[akey] = True
                    while len(seen) > self._shipped_cap:
                        seen.popitem(last=False)
            log_event(log, "session failed over with KV re-ship",
                      session=sid[:16], old=old_home, new=new_home)
        else:
            self.sessions.record_fallback(reason)
            log_event(log, "session failed over, local re-prefill",
                      session=sid[:16], old=old_home, new=new_home,
                      reason=reason)
        return new_home

    def _session_reship(self, head, old_name: str | None,
                        new_rep: Replica) -> str | None:
        """Export the session head's KV from the old home and import it
        on the new one, through the same pipelined relay the
        phase-split ship rides. Returns None on success, else the
        fallback reason; nothing retries — a failed re-ship costs one
        local re-prefill, never a lost turn."""
        try:
            self.faults.check("session_failover")
        except InjectedFault:
            return "failover_fault"
        if head is None:
            return "no_token_head"
        old = self.pool.replicas.get(old_name) if old_name else None
        if old is None:
            return "no_old_home"
        reason, _info = self._ship_relay(
            old, new_rep, head, {"Content-Type": "application/json"})
        if reason is None:
            return None
        # the relay's vocabulary, translated to the session failover's:
        # an unreachable old home is the SIGKILL case (its KV died with
        # the worker — the new home's re-prefill IS the recovery)
        return {"export_unreachable": "old_home_unreachable",
                "import_unreachable": "import_failed"}.get(reason,
                                                           reason)

    def _on_replica_drain(self, replica: Replica) -> None:
        """Pool ``on_drain`` hook: ``begin_drain`` just marked
        ``replica`` DRAINING (its server still serves — the /shutdown
        comes after this returns), so every session homed there can
        move its pinned KV head to its rendezvous successor NOW,
        through the pipelined relay, instead of paying a failover
        re-prefill on the next turn. Per-session failures degrade to
        exactly that turn-time failover path (counted by reason); only
        a SUCCESSFUL re-ship re-homes the record."""
        with self._session_lock:
            affected = [(sid, rec)
                        for sid, rec in self._session_map.items()
                        if rec.get("home") == replica.name]
        if not affected:
            return
        cands = {r.name: r for r in self.pool.routable()
                 if r.role != PREFILL and r.name != replica.name
                 and not self._breaker_blocked(r)}
        if not cands:
            return  # nowhere to re-home; turn-time failover owns it
        for sid, rec in affected:
            new_home = affinity.pick_replica(
                affinity.session_key(sid), sorted(cands))
            akey = rec.get("key")
            if akey is not None:
                with self._ship_lock:
                    for seen in self._shipped.values():
                        seen.pop(akey, None)
            reason = self._session_reship(rec.get("head"), replica.name,
                                          cands[new_home])
            if reason is not None:
                self.sessions.record_fallback(reason)
                log_event(log, "drain re-ship failed, next turn fails "
                          "over", session=sid[:16], old=replica.name,
                          reason=reason)
                continue
            with self._session_lock:
                if self._session_map.get(sid) is rec:
                    rec["home"] = new_home
            if akey is not None:
                with self._ship_lock:
                    seen = self._shipped.setdefault(new_home,
                                                    OrderedDict())
                    seen[akey] = True
                    while len(seen) > self._shipped_cap:
                        seen.popitem(last=False)
            self.sessions.count("drain_reships")
            log_event(log, "session re-shipped at drain",
                      session=sid[:16], old=replica.name, new=new_home)

    def _note_session_home(self, sid: str | None, replica_name: str,
                           body: dict, key: bytes | None) -> None:
        """Record (or refresh) the replica that actually SERVED this
        session's turn — first turns create the record, retry/failover
        outcomes self-heal it."""
        if sid is None:
            return
        with self._session_lock:
            rec = self._session_map.get(sid)
            if rec is not None:
                # known session: _session_sticky already folded this
                # turn's head into the record — only the home (and the
                # key) need refreshing, no second O(history) extraction
                rec["home"] = replica_name
                rec["t"] = time.monotonic()
                if key is not None:
                    rec["key"] = key
                self._session_map.move_to_end(sid)
                return
        head = affinity.ship_prompt(
            body, block=self.block,
            key_blocks=affinity.SESSION_KEY_BLOCKS)
        with self._session_lock:
            now = time.monotonic()
            self._sweep_session_records_locked(now)
            rec = self._session_map.get(sid)
            if rec is None:
                self._session_map[sid] = {"home": replica_name,
                                          "head": head, "key": key,
                                          "t": now}
                self.sessions.count("opened")
                while len(self._session_map) > self._session_cap:
                    self._session_map.popitem(last=False)
            else:  # a racer created it between the two locked sections
                rec["home"] = replica_name
                rec["t"] = now
                if key is not None:
                    rec["key"] = key
                if head is not None and (rec["head"] is None
                                         or len(head) > len(rec["head"])):
                    rec["head"] = head
            self._session_map.move_to_end(sid)

    def _end_session(self, sid: str, handler) -> None:
        """DELETE /v1/sessions/{id}: drop the sticky record and fan the
        DELETE out to every decode-capable replica — after failovers the
        session's pins may live on more than one, and an extra DELETE on
        a replica that never pinned it is an idempotent no-op."""
        with self._session_lock:
            self._session_map.pop(sid, None)
        self.sessions.count("deletes")
        released: dict = {}
        released_lock = threading.Lock()

        def close_on(name: str, url: str) -> None:
            req = urllib.request.Request(
                f"{url}/v1/sessions/{sid}", method="DELETE")
            try:
                with urllib.request.urlopen(
                        req, timeout=self.pool.probe_timeout) as resp:
                    out = json.loads(resp.read())
            except urllib.error.HTTPError as e:
                out = {"ok": False, "status": e.code}
            except Exception as e:  # noqa: BLE001 — dead replica: its
                # pins died with it, nothing left to release
                out = {"ok": False, "error": str(e)}
            with released_lock:
                released[name] = out

        # concurrent like the /metrics scrape: one wedged replica costs
        # its own timeout, not timeout x fleet serially on the client
        threads = [threading.Thread(target=close_on, args=(n, r.url),
                                    daemon=True)
                   for n, r in sorted(self.pool.replicas.items())
                   if r.role != PREFILL]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=self.pool.probe_timeout + 2.0)
        with released_lock:
            # snapshot: a straggler thread past the join bound must not
            # mutate the dict mid-serialization
            snapshot = dict(released)
        handler.send(200, {"ok": True, "session": sid,
                           "replicas": snapshot})

    # -- disaggregated prefill/decode (phase-split) ship ---------------------

    def _ship_relay(self, src: Replica, dst: Replica, head: list,
                    headers: dict) -> tuple[str | None, dict]:
        """Pump ``src``'s ``/v1/kv/export`` into ``dst``'s
        ``/v1/kv/import``. With ``ship_window > 0`` the export is
        CHUNKED: a reader thread pulls wire frames off the export
        response as the prefill produces them and a bounded queue
        (``ship_window`` frames) feeds the import leg's chunked POST —
        so wire transfer and the decode side's staging both overlap the
        prefill chunks still running on ``src``. ``ship_pipelined=False``
        keeps the chunked wire but buffers the full export first (the
        blocking baseline); an ``LKV1`` response (a pre-chunking
        replica, or ``ship_window=0``) relays as one monolithic frame.

        Returns ``(fallback_reason | None, info)``. Reasons distinguish
        unreachable legs (``export_unreachable``/``import_unreachable``
        — the caller maps them per its own vocabulary and the dead
        replica was already reported to the pool) from sheds, garbage,
        and injected faults (``ship_fault`` pre-stream,
        ``ship_chunk_fault`` mid-stream). Both legs feed the circuit
        breakers; nothing here retries — a failed ship costs one local
        prefill, never a lost request."""
        info: dict = {"nbytes": 0, "chunks": 0, "pipelined": False,
                      "export_ok": False, "import": {}}
        use_stream = self.ship_window > 0
        payload: dict = {"tokens": head}
        if use_stream:
            payload["stream"] = True
        req = urllib.request.Request(
            src.url + "/v1/kv/export", data=json.dumps(payload).encode(),
            headers=headers, method="POST")
        t0 = time.monotonic()
        deadline = t0 + self.request_timeout
        self.pool.acquire(src)
        resp = None
        try:
            try:
                self.faults.check("route_latency")
                self.faults.check("route_connect")
                resp = urllib.request.urlopen(
                    req, timeout=self.request_timeout)
            except urllib.error.HTTPError as e:
                e.read()
                self._breaker_result(src, ok=e.code < 500
                                     or e.code == 503)
                return ("export_shed" if e.code in (429, 503)
                        else "export_failed"), info
            except InjectedFault:
                self._breaker_result(src, ok=False)
                return "ship_fault", info
            except Exception as e:  # noqa: BLE001 — connection-level
                if not self._is_timeout(e):
                    self._breaker_result(src, ok=False)
                    self.pool.note_failure(src)
                return "export_unreachable", info
            # sniff the first frame's magic: LKV1 = monolithic (an
            # unchunked replica, or stream off), LKVS = chunked stream
            try:
                first = resp.read(4)
            except Exception:  # noqa: BLE001
                self._breaker_result(src, ok=False)
                self.pool.note_failure(src)
                return "export_unreachable", info
            if first == _KV_MAGIC:
                return self._relay_monolithic(src, dst, resp, first,
                                              headers, info)
            if first != b"LKVS":
                self._breaker_result(src, ok=False)
                return "export_failed", info
            return self._relay_stream(src, dst, resp, first, headers,
                                      info, deadline)
        finally:
            self.pool.release(src)
            if resp is not None:
                try:
                    resp.close()
                except OSError:
                    pass

    def _relay_monolithic(self, src: Replica, dst: Replica, resp,
                          first: bytes, headers: dict,
                          info: dict) -> tuple[str | None, dict]:
        """The compat/legacy leg: one LKV1 frame, one import POST."""
        try:
            frame = first + resp.read()
            self.faults.check("route_body")
        except InjectedFault:
            self._breaker_result(src, ok=False)
            return "ship_fault", info
        except Exception as e:  # noqa: BLE001
            if not self._is_timeout(e):
                self._breaker_result(src, ok=False)
                self.pool.note_failure(src)
            return "export_unreachable", info
        self._breaker_result(src, ok=True)
        info["export_ok"] = True
        info["nbytes"] = len(frame)
        imp_headers = {**headers,
                       "Content-Type": "application/octet-stream"}
        try:
            istatus, _, ibody = self._forward(dst, "/v1/kv/import",
                                              frame, imp_headers)
        except InjectedFault:
            return "ship_fault", info
        except Exception as e:  # noqa: BLE001
            if not self._is_timeout(e):
                self.pool.note_failure(dst)
            return "import_unreachable", info
        return self._import_outcome(istatus, ibody, info)

    def _relay_stream(self, src: Replica, dst: Replica, resp,
                      first: bytes, headers: dict, info: dict,
                      deadline: float) -> tuple[str | None, dict]:
        """The chunked pump. Mid-stream failures close the import leg
        WITHOUT the terminal chunk, so the decode replica's staged
        pages roll back and its tree (and the ship-dedup LRU above it)
        is never told about a half-arrived head."""
        split = FrameSplitter()
        # the window only applies when a reader thread feeds a writer
        # concurrently; the buffered baseline reads inline with nobody
        # consuming yet, so its queue must be unbounded or it deadlocks
        frames_q: Queue = Queue(
            maxsize=max(1, self.ship_window) if self.ship_pipelined
            else 0)
        rd_err: list = []
        # set when the writer gives up: a reader parked on a full
        # window must unblock NOW, not after the request timeout — a
        # dead import leg would otherwise pin one thread plus a
        # window's worth of KV frames per failed ship for minutes
        abort = threading.Event()
        info["pipelined"] = self.ship_pipelined

        def q_put(item) -> None:
            while True:
                if abort.is_set():
                    raise _ShipStalled("ship relay aborted")
                if time.monotonic() > deadline:
                    raise _ShipStalled("ship relay window stalled")
                try:
                    frames_q.put(item, timeout=0.1)
                    return
                except Full:
                    continue

        def read_frames() -> None:
            try:
                data = first
                while True:
                    for item in split.feed(data):
                        q_put(item)
                    if split.complete:
                        break
                    data = resp.read(65536)
                    if not data:
                        raise ValueError("export stream truncated")
                self.faults.check("route_body")
            except Exception as e:  # noqa: BLE001 — writer classifies
                rd_err.append(e)
            finally:
                # the end marker waits for room as a frame does: dropped
                # while the writer is still sending the window, it would
                # leave the writer waiting for it until the deadline
                # (JAX's relay waits 1 s, then drops it)
                try:
                    q_put(None)
                except _ShipStalled:  # writer gone, or past the deadline
                    pass

        if self.ship_pipelined:
            threading.Thread(target=read_frames, daemon=True,
                             name="kv-ship-relay").start()

            def frame_iter():
                while True:
                    try:
                        item = frames_q.get(timeout=max(
                            0.1, deadline - time.monotonic()))
                    except Empty:
                        raise _ShipStalled(
                            "export stream stalled") from None
                    if item is None:
                        return
                    yield item
        else:
            # the blocking baseline: the whole export (prefill
            # included) lands before the first import byte moves
            read_frames()

            def frame_iter():
                while True:
                    item = frames_q.get_nowait()
                    if item is None:
                        return
                    yield item

        conn = None
        mid_stream = False
        # acquired BEFORE the connection opens (the _forward rule): the
        # lazy connect inside endheaders() can fail, and a release
        # without its acquire would skew outstanding/busy accounting
        self.pool.acquire(dst)
        try:
            try:
                self.faults.check("route_latency")
                self.faults.check("route_connect")
                host, _, port = dst.url.rpartition("//")[2].partition(":")
                conn = http.client.HTTPConnection(
                    host, int(port or 80), timeout=self.request_timeout)
                conn.putrequest("POST", "/v1/kv/import",
                                skip_accept_encoding=True)
                conn.putheader("Content-Type",
                               "application/x-lkv-stream")
                conn.putheader("Transfer-Encoding", "chunked")
                for name, value in headers.items():
                    if name.lower() != "content-type":
                        conn.putheader(name, value)
                conn.endheaders()
            except InjectedFault:
                return "ship_fault", info
            except Exception as e:  # noqa: BLE001
                if not self._is_timeout(e):
                    self.pool.note_failure(dst)
                return "import_unreachable", info
            try:
                try:
                    for kind, frame in frame_iter():
                        mid_stream = True
                        if kind == "chunk":
                            self.faults.check("kv_ship_chunk")
                        conn.send(f"{len(frame):x}\r\n".encode()
                                  + frame + b"\r\n")
                        info["nbytes"] += len(frame)
                        if kind == "chunk":
                            info["chunks"] += 1
                except InjectedFault as e:
                    # the chunk site fired router-side: neither replica
                    # is at fault — close the import leg unterminated
                    # (dst rolls back its staged pages) and degrade
                    site = getattr(e, "fault_site", "")
                    self.disagg.count("mid_stream_failures")
                    return ("ship_chunk_fault"
                            if site == "kv_ship_chunk"
                            else "ship_fault"), info
                except (_ShipStalled, ValueError):
                    raise  # reader-side problems classified below
                except Exception as e:  # noqa: BLE001 — import leg
                    # died (incl. a send timeout: socket.timeout IS
                    # TimeoutError on py3.10 — it belongs HERE, against
                    # the decode replica, not the export classifier)
                    if mid_stream:
                        self.disagg.count("mid_stream_failures")
                    if not self._is_timeout(e):
                        self.pool.note_failure(dst)
                    return "import_unreachable", info
                if rd_err:
                    raise rd_err[0]
                self._breaker_result(src, ok=True)
                info["export_ok"] = True
                try:
                    conn.send(b"0\r\n\r\n")
                    iresp = conn.getresponse()
                    istatus, ibody = iresp.status, iresp.read()
                except Exception as e:  # noqa: BLE001
                    self.disagg.count("mid_stream_failures")
                    if not self._is_timeout(e):
                        self._breaker_result(dst, ok=False)
                        self.pool.note_failure(dst)
                    return "import_unreachable", info
                return self._import_outcome(istatus, ibody, info,
                                            dst=dst)
            except (_ShipStalled, ValueError, InjectedFault,
                    OSError, http.client.HTTPException) as e:
                # export-side stream failure (truncated, garbage,
                # stalled, or a route fault while reading): the import
                # leg is abandoned unterminated — staged pages roll back
                export_failed = e
                if rd_err and isinstance(rd_err[0], Exception):
                    export_failed = rd_err[0]
                self.disagg.count("mid_stream_failures")
                self._breaker_result(src, ok=False)
                if isinstance(export_failed, InjectedFault):
                    return "ship_fault", info
                if isinstance(export_failed, (OSError,
                                              http.client.HTTPException)) \
                        and not self._is_timeout(export_failed):
                    self.pool.note_failure(src)
                    return "export_unreachable", info
                return "export_failed", info
        finally:
            abort.set()  # unblock a reader parked on the window
            self.pool.release(dst)
            if conn is not None:
                try:
                    conn.close()
                except OSError:
                    pass

    def _import_outcome(self, istatus: int, ibody: bytes, info: dict,
                        dst: Replica | None = None
                        ) -> tuple[str | None, dict]:
        """Shared import-status handling. ``dst`` feeds the breaker on
        the streamed leg (the monolithic leg rode ``_forward``, which
        already did)."""
        if dst is not None:
            self._breaker_result(dst, ok=istatus < 500
                                 or istatus == 503)
        if istatus in (429, 503):
            # decode-side backpressure (full page arena / shedding
            # admission): honor it by NOT forcing more KV into the
            # replica — local prefill there is charged through its own
            # admission instead
            return "import_backpressure", info
        if istatus != 200:
            return "import_failed", info
        try:
            info["import"] = json.loads(ibody)
        except (ValueError, TypeError):
            info["import"] = {}
        return None, info

    def _maybe_ship(self, key: bytes | None, body: dict,
                    headers: dict, sticky: str | None = None) -> None:
        """Phase-split a cold request: run its prefill on a PREFILL-
        class replica (``/v1/kv/export`` — the export IS the prefill)
        and ship the resulting KV blocks to the affinity-chosen DECODE
        replica (``/v1/kv/import`` — a radix insert, zero-copy into
        arena pages under ``--kv-paged``). Purely an optimization:
        every failure records a fallback reason and returns — the
        request then serves mixed-mode (local prefill on the decode
        replica), bitwise the same answer."""
        replicas = self.pool.replicas.values()
        if not any(r.role == PREFILL for r in replicas):
            return  # disaggregation not configured: zero-cost exit
        if not self.affinity_on or key is None:
            # without an affinity key the forward target is a rotating
            # least-outstanding pick — shipping to a guess would warm
            # the wrong replica half the time
            self.disagg.record_fallback("no_affinity_key")
            return
        head = affinity.ship_prompt(body, block=self.block,
                                    key_blocks=affinity.SHIP_KEY_BLOCKS)
        if head is None:
            # string prompts (the router never tokenizes) or sub-block
            # heads: nothing the KV wire can frame
            self.disagg.record_fallback("no_token_head")
            return
        routable = self.pool.routable()
        # same breaker filter as _pick: the ship must target the replica
        # the forward will actually choose — shipping into an open
        # breaker would load the replica the breaker shields AND warm
        # the wrong cache
        decs = [r for r in routable if r.role != PREFILL
                and not self._breaker_blocked(r)]
        if not decs:
            self.disagg.record_fallback("no_decode_replica")
            return
        # a sticky session's turn forwards to its HOME, which after a
        # failover is the session-key rendezvous pick, not the prefix-key
        # one — the ship must land where the forward will actually go
        target_name = (sticky if sticky is not None
                       and any(r.name == sticky for r in decs)
                       else affinity.pick_replica(
                           key, sorted(r.name for r in decs)))
        dec = next(r for r in decs if r.name == target_name)
        with self._ship_lock:
            seen = self._shipped.setdefault(dec.name, OrderedDict())
            dedup_hit = key in seen
            if dedup_hit:
                seen.move_to_end(key)
        pulling = False
        if dedup_hit:
            # trust-but-verify the dedup cache: an arena reset (engine
            # failure on the decode replica) or a partial insert leaves
            # a stale entry claiming KV the replica no longer holds —
            # without the check every later request on this prefix pays
            # a silent local re-prefill. A cheap host-only probe
            # (/v1/kv/probe) decides; when the blocks are gone, PULL
            # them back through the normal ship legs instead of falling
            # straight to mixed-mode.
            if not self._probe_missing(dec, head):
                self.disagg.count("ship_skips")
                return
            pulling = True

        def fall(reason: str) -> None:
            self.disagg.record_fallback(reason)
            if pulling:
                self.disagg.record_fallback("pull_failed")

        prefills = [r for r in routable if r.role == PREFILL
                    and not self._breaker_blocked(r)]
        if not prefills:
            fall("no_prefill_replica")
            return
        pre = min(prefills, key=lambda r: r.outstanding)
        t0 = time.monotonic()
        # the relay pumps export -> import (chunked when ship_window >
        # 0: wire transfer and decode-side staging overlap the prefill
        # chunks still running on the prefill replica). Ships never
        # retry (a failed ship costs a local prefill, not a lost
        # request — no budget to spend), but both legs feed breakers.
        try:
            self.faults.check("kv_ship")
        except InjectedFault as e:
            # the kv_ship site fires BEFORE any connection opens: a
            # simulated ship failure says nothing about the replica
            fall("ship_fault")
            log_event(log, "kv ship fault, serving mixed",
                      replica=pre.name, error=str(e))
            return
        reason, info = self._ship_relay(pre, dec, head, headers)
        if info.get("export_ok"):
            self.disagg.count("prefill_dispatches")
        if reason is not None:
            fall({"export_unreachable": "export_failed",
                  "import_unreachable": "import_failed"}.get(reason,
                                                             reason))
            log_event(log, "kv ship failed, serving mixed",
                      prefill=pre.name, decode=dec.name, reason=reason,
                      chunks=info.get("chunks", 0))
            return
        self.disagg.record_ship(nbytes=info["nbytes"],
                                ms=(time.monotonic() - t0) * 1e3,
                                chunks=info["chunks"],
                                pipelined=bool(info.get("pipelined")
                                               and info["chunks"]))
        res = info.get("import") or {}
        try:
            self.disagg.record_import_result(
                inserted=int(res.get("inserted", 0)),
                present=int(res.get("present", 0)),
                mode=str(res.get("mode", "dense")))
        except (ValueError, TypeError):
            pass  # counters are advisory; the ship itself landed
        with self._ship_lock:
            seen = self._shipped.setdefault(dec.name, OrderedDict())
            seen[key] = True
            seen.move_to_end(key)
            while len(seen) > self._shipped_cap:
                seen.popitem(last=False)
        self.disagg.count("decode_dispatches")
        if pulling:
            # the dedup entry lied and the pull restored the blocks —
            # surfaced next to the fallback reasons so an operator sees
            # arena resets eating shipped KV before it costs latency
            self.disagg.record_fallback("pull_hit")

    def _probe_missing(self, dec: Replica, head: list) -> bool:
        """True when the decode replica no longer holds the whole-block
        head the ship-dedup cache claims it shipped (arena reset
        flushed it, or the insert was partial). Probe errors read as
        NOT missing — the pre-pull behavior — so a replica without the
        probe surface keeps plain dedup semantics."""
        try:
            status, _, body = self._forward(
                dec, "/v1/kv/probe",
                json.dumps({"tokens": head}).encode(),
                {"Content-Type": "application/json"})
            if status != 200:
                return False
            matched = int(json.loads(body).get("matched", 0))
        except Exception:  # noqa: BLE001 — probe is advisory
            return False
        return matched < len(head)

    # -- request routing ----------------------------------------------------

    def _spend_retry(self) -> bool:
        """Charge one retry against the fleet-wide budget (always true
        when the budget is disabled)."""
        if self.retry_budget is None or self.retry_budget.allow_retry():
            return True
        self.stats.count("retry_budget_denied")
        return False

    @staticmethod
    def _sched_identity(headers) -> tuple[str, str, float | None]:
        """(class, tenant, deadline_ms) from the sched headers — the
        spill queue parks by the same identity the server-side queue
        would have used."""
        cls = (headers.get("x-priority") or "interactive").strip().lower()
        tenant = (headers.get("x-api-key") or headers.get("x-tenant")
                  or "anon")
        try:
            deadline_ms = float(headers["x-deadline-ms"])
        except (KeyError, TypeError, ValueError):
            deadline_ms = None
        return cls, tenant, deadline_ms

    def _route(self, handler, path: str, body: dict, raw: bytes) -> None:
        openai = path == "/v1/completions"
        key = (affinity.prefix_key(body, block=self.block)
               if self.affinity_on else None)
        headers = self._fwd_headers(handler.headers)
        self.stats.count("requests")
        if key is not None:
            self._note_hot_prefix(key, body)
        if self.retry_budget is not None:
            # streams fund the budget too — they spend it on their
            # pre-first-byte retries, and an unfunded stream-heavy
            # workload would starve everyone down to the min floor
            self.retry_budget.record_request()
        # sticky sessions: resolve the home replica BEFORE the ship and
        # the pick — a failover (dead home) re-homes and re-ships here
        sid = self._session_id(handler.headers, body)
        sticky = self._session_sticky(sid, body) if sid else None
        # phase-split dispatch (no-op without prefill-class replicas):
        # prefill on a prefill replica, KV blocks shipped to the decode
        # target, BEFORE the forward — streams included (the ship
        # happens before any response bytes exist)
        self._maybe_ship(key, body, headers, sticky=sticky)
        if body.get("stream"):
            self._route_stream(handler, path, raw, headers, key,
                               sid=sid, sticky=sticky, body=body)
            return
        t0 = time.monotonic()
        res = self._attempt(handler, path, raw, headers, key, t0,
                            count_affinity=True, sid=sid,
                            sticky=sticky, body=body)
        if res is None:
            return  # response already on the wire
        # the fleet is exhausted (every attempt shed, or nothing was
        # routable). With the spill queue enabled, park non-streamed
        # requests and drain them as replicas recover — a transient
        # fleet-wide brownout should cost queue wait, not client errors.
        if self.spill is not None:
            cls, tenant, deadline_ms = self._sched_identity(handler.headers)
            spill_deadline = t0 + self.spill.max_wait_s
            if deadline_ms is not None:
                spill_deadline = min(spill_deadline, t0 + deadline_ms / 1e3)
            self.stats.count("spilled")
            while True:
                last_shed = res if isinstance(res, tuple) else None
                hint = (self._retry_after_s(*last_shed)
                        if last_shed else 0.0)
                outcome = self.spill.park(
                    cls=cls, tenant=tenant,
                    wait_s=spill_deadline - time.monotonic(), hint_s=hint)
                if isinstance(outcome, Shed):
                    self.stats.count(
                        "spill_expired" if outcome.reason == SPILL_DEADLINE
                        else "spill_overflow")
                    self._send_spill_shed(handler, outcome, openai)
                    return
                self.stats.count("spill_drained")
                try:
                    res = self._attempt(handler, path, raw, headers, key,
                                        t0, count_affinity=False,
                                        sid=sid, sticky=sticky, body=body)
                finally:
                    self.spill.done(outcome)
                if res is None:
                    return
        if isinstance(res, tuple):
            status, hdrs, out = res
            handler.relay(status, hdrs, out)
            return
        self.stats.count("no_replica")
        self.stats.count("errors")
        payload = {"error": {"message": "no routable replicas",
                             "type": "overloaded_error"}} if openai else \
            {"ok": False, "shed": True, "reason": "no_replica",
             "retry_after_s": 1.0}
        handler.send(503, payload, {"Retry-After": "1"})

    def _send_spill_shed(self, handler, shed: Shed, openai: bool) -> None:
        """The spill queue's own shed: same wire contract as the
        server-side admission layer (integer ``Retry-After`` header per
        RFC 9110, exact ``retry_after_s`` float in the body — the shape
        :meth:`_retry_after_s` itself parses), priced by the queue's
        wait estimate."""
        self.stats.count("errors")
        hdrs = {"Retry-After": str(max(1, math.ceil(shed.retry_after_s)))}
        if openai:
            payload = {"error": {
                "message": f"shed: {shed.reason}",
                "type": "overloaded_error",
                "retry_after_s": round(shed.retry_after_s, 3)}}
        else:
            payload = shed.payload()
        handler.send(shed.code, payload, hdrs)

    def _attempt(self, handler, path: str, raw: bytes, headers: dict,
                 key: bytes | None, t0: float, *, count_affinity: bool,
                 sid: str | None = None, sticky: str | None = None,
                 body: dict | None = None):
        """One retry round over the fleet. Returns None when a response
        was sent to the client, the last shed ``(status, hdrs, body)``
        tuple when every attempt shed, or ``"no_replica"`` when nothing
        was routable. ``sticky`` is the session home the first pick
        prefers; whichever replica actually serves is recorded as the
        session's home."""
        tried: set = set()
        last_shed: tuple | None = None
        attempt = 0
        first = count_affinity
        while attempt <= self.max_retries:
            r = self._pick(key, tried, count_affinity=first,
                           prefer=(sticky if sticky is not None
                                   and sticky not in tried else None))
            if r is None:
                break
            hedge_s = self._hedge_threshold_s() if first else None
            try:
                if hedge_s is not None:
                    # r becomes the ANSWERING replica: shed/tried
                    # bookkeeping below must target whoever actually
                    # replied, not whoever was asked first
                    r, (status, hdrs, out) = self._forward_hedged(
                        r, path, raw, headers, hedge_s, tried)
                else:
                    status, hdrs, out = self._forward(r, path, raw, headers)
            except Exception as e:  # noqa: BLE001 — connection-level failure
                if self._is_timeout(e):
                    self.pool.bump(r, "errors")
                    self.stats.count("errors")
                    handler.send(504, {"ok": False,
                                       "error": "upstream timeout",
                                       "replica": r.name})
                    return None
                self.pool.note_failure(r)
                self.stats.count("failovers")
                self.stats.count("retries")
                self.pool.bump(r, "retried")
                tried.add(r.name)
                attempt += 1
                first = False
                log_event(log, "forward failed, retrying", replica=r.name,
                          error=str(e))
                if attempt > self.max_retries:
                    break  # exhausted: no point sleeping before the 503
                if not self._spend_retry():
                    break  # retry budget spent: stop amplifying
                self._backoff(attempt, 0.0, others_available=bool(
                    [x for x in self.pool.routable()
                     if x.name not in tried]))
                continue
            first = False
            if status in (429, 503):
                hint = self._retry_after_s(status, hdrs, out)
                last_shed = (status, hdrs, out)
                tried.add(r.name)
                attempt += 1
                if attempt > self.max_retries:
                    break
                if not self._spend_retry():
                    break  # relay the shed honestly instead of storming
                self.stats.count("retries")
                self.pool.bump(r, "retried")
                others = [x for x in self.pool.routable()
                          if x.name not in tried]
                self._backoff(attempt, hint, others_available=bool(others))
                if not others:
                    tried.clear()  # every replica shed: rotate back through
                continue
            self.pool.bump(r, "routed")
            if status >= 500:
                self.pool.bump(r, "errors")
                self.stats.count("errors")
            else:
                # the replica that SERVED becomes (or stays) the
                # session's home — first turns create the record,
                # retry outcomes self-heal it
                self._note_session_home(sid, r.name, body or {}, key)
                self.stats.count("completed")
                self.stats.latency.record((time.monotonic() - t0) * 1e3)
            handler.relay(status, hdrs, out)
            return None
        return last_shed if last_shed is not None else "no_replica"

    def _forward_hedged(self, primary: Replica, path: str, raw: bytes,
                        headers: dict, hedge_s: float, tried: set,
                        ) -> tuple[Replica, tuple[int, dict, bytes]]:
        """Send to ``primary``; if no answer within ``hedge_s``, duplicate
        on another replica and take the first answer. Returns the
        ANSWERING replica with its response — the caller must attribute
        shed/tried bookkeeping to that replica, not the primary. Raises
        only when every launched leg raised; a wait that outlives
        ``request_timeout`` raises TimeoutError (the 504 path — legs
        still trickling bytes are busy replicas, not dead ones)."""
        results: Queue = Queue()

        def leg(rep: Replica) -> None:
            try:
                results.put((rep, self._forward(rep, path, raw, headers)))
            except Exception as e:  # noqa: BLE001 — caller attributes it
                results.put((rep, e))

        def get_result(timeout: float):
            try:
                return results.get(timeout=timeout)
            except Empty:
                raise TimeoutError(
                    "hedged request exceeded request_timeout") from None

        threading.Thread(target=leg, args=(primary,), daemon=True).start()
        legs = 1
        try:
            rep, out = results.get(timeout=hedge_s)
        except Empty:
            second = self._pick(None, tried | {primary.name},
                                count_affinity=False)
            if second is not None:
                self.stats.count("hedges")
                self.pool.bump(second, "hedged")
                threading.Thread(target=leg, args=(second,),
                                 daemon=True).start()
                legs = 2
            rep, out = get_result(self.request_timeout)

        def _bad(res) -> bool:  # dead leg or a retryable shed
            return isinstance(res, Exception) or res[0] >= 400

        if legs == 2 and _bad(out):
            # first answer was a dead or shedding leg — wait for the
            # other before giving up: a hedge leg's instant 429 must not
            # discard the primary's in-flight (likely successful)
            # response and misread a healthy replica as failed
            rep2, out2 = get_result(self.request_timeout)
            if isinstance(out, Exception) or \
                    (not isinstance(out2, Exception) and not _bad(out2)):
                rep, out = rep2, out2
        if isinstance(out, Exception):
            raise out
        if legs == 2 and rep.name != primary.name and out[0] < 400:
            self.stats.count("hedge_wins")
        return rep, out

    def _route_stream(self, handler, path: str, raw: bytes,
                      headers: dict, key: bytes | None, *,
                      sid: str | None = None, sticky: str | None = None,
                      body: dict | None = None) -> None:
        """Streamed pass-through: retry replicas until a response OPENS,
        then relay line-frames; once bytes are on the wire the stream is
        committed to that replica."""
        t0 = time.monotonic()
        tried: set = set()
        last_shed: tuple | None = None
        first = True
        for attempt in range(self.max_retries + 1):
            r = self._pick(key, tried, count_affinity=first,
                           prefer=(sticky if sticky is not None
                                   and sticky not in tried else None))
            first = False
            if r is None:
                break
            req = urllib.request.Request(r.url + path, data=raw,
                                         headers=headers, method="POST")
            self.pool.acquire(r)
            resp = None
            try:
                try:
                    self.faults.check("route_latency")
                    self.faults.check("route_connect")
                    resp = urllib.request.urlopen(
                        req, timeout=self.request_timeout)
                except urllib.error.HTTPError as e:
                    body = e.read()
                    # the replica ANSWERED: resolve a half-open probe
                    # (a shed is backpressure, not a fault; no latency
                    # sample — see the stream-completion note below)
                    self._breaker_result(r, ok=e.code < 500
                                         or e.code == 503)
                    if e.code in (429, 503):
                        # same shed contract as the non-streamed path:
                        # jittered backoff honoring Retry-After, rotate
                        # back through the fleet when everyone shed
                        last_shed = (e.code, dict(e.headers), body)
                        tried.add(r.name)
                        if attempt >= self.max_retries:
                            break  # out of attempts: relay the shed
                            #        now, don't sleep first
                        if not self._spend_retry():
                            break
                        self.stats.count("retries")
                        self.pool.bump(r, "retried")
                        hint = self._retry_after_s(e.code, dict(e.headers),
                                                   body)
                        others = [x for x in self.pool.routable()
                                  if x.name not in tried]
                        self._backoff(attempt + 1, hint,
                                      others_available=bool(others))
                        if not others:
                            tried.clear()
                        continue
                    self.pool.bump(r, "errors")
                    self.stats.count("errors")
                    handler.relay(e.code, dict(e.headers), body)
                    return
                except Exception as e:  # noqa: BLE001 — connect failure
                    if self._is_timeout(e):
                        self.pool.bump(r, "errors")
                        self.stats.count("errors")
                        handler.send(504, {"ok": False,
                                           "error": "upstream timeout",
                                           "replica": r.name})
                        return
                    self._breaker_result(r, ok=False)
                    self.pool.note_failure(r)
                    self.stats.count("failovers")
                    self.stats.count("retries")
                    self.pool.bump(r, "retried")
                    tried.add(r.name)
                    log_event(log, "stream open failed, retrying",
                              replica=r.name, error=str(e))
                    if not self._spend_retry():
                        break
                    continue
                self.pool.bump(r, "routed")
                # the stream is committed to this replica from here on:
                # it IS the session's home for subsequent turns
                self._note_session_home(sid, r.name, body or {}, key)
                handler.send_response(200)
                handler.send_header(
                    "Content-Type",
                    resp.headers.get("Content-Type", "application/json"))
                handler.send_header("Transfer-Encoding", "chunked")
                handler.end_headers()
                try:
                    for line in resp:  # urllib de-chunks; line-framed body
                        self.faults.check("route_body")
                        if not handler.write_frame(line):
                            # client went away — the REPLICA is healthy,
                            # so a half-open probe must still resolve
                            self._breaker_result(r, ok=True)
                            return
                except (OSError, http.client.HTTPException, InjectedFault):
                    # replica died mid-stream (FIN -> IncompleteRead,
                    # RST -> ConnectionReset). The headers are committed,
                    # so the only honest signal left is an UNTERMINATED
                    # chunked body — writing the terminal chunk would
                    # make the client's HTTP layer report the truncated
                    # output as complete.
                    self._breaker_result(r, ok=False)
                    self.pool.note_failure(r)
                    self.stats.count("errors")
                    handler.close_connection = True
                    return
                handler.end_frames()
                # no latency sample: a stream's duration is the decode
                # length, not replica health — it must not trip the
                # latency-outlier breaker
                self._breaker_result(r, ok=True)
                self.stats.count("completed")
                self.stats.latency.record((time.monotonic() - t0) * 1e3)
                return
            finally:
                self.pool.release(r)
                if resp is not None:
                    try:
                        resp.close()
                    except OSError:
                        pass
        if last_shed is not None:
            status, hdrs, out = last_shed
            handler.relay(status, hdrs, out)
            return
        self.stats.count("no_replica")
        self.stats.count("errors")
        handler.send(503, {"ok": False, "shed": True, "reason": "no_replica",
                           "retry_after_s": 1.0}, {"Retry-After": "1"})

    # -- metrics ------------------------------------------------------------

    def _fold_utilization(self) -> dict:
        """Turn the pool's time-weighted occupancy into per-class
        busy-fraction samples (busy seconds over replicas x wall since
        the last fold) and feed the ``fleet.disagg.util`` EWMAs — the
        observability basis for prefill-pool sizing. Returns the raw
        per-class occupancy snapshot for the same metrics block."""
        totals = self.pool.busy_totals()
        now = time.monotonic()
        with self._util_lock:
            prev = self._util_prev
            wall = now - prev["t"]
            if wall >= 0.2:  # ignore back-to-back scrapes: zero signal
                for cls, cur in totals.items():
                    busy_delta = cur["busy_s"] - prev["busy"].get(cls,
                                                                  0.0)
                    if busy_delta < 0:
                        # a replica restarted/left between scrapes and
                        # its accumulator reset: the class total moved
                        # backwards. Its busy time since the reset is
                        # the honest sample — a clamp-to-zero would
                        # read a saturated churning class as idle.
                        busy_delta = cur["busy_s"]
                    self.disagg.record_util(
                        cls, busy_delta / (max(1, cur["replicas"])
                                           * wall))
                self._util_prev = {
                    "t": now,
                    "busy": {c: v["busy_s"] for c, v in totals.items()},
                }
        return {cls: {"replicas": v["replicas"],
                      "outstanding": v["outstanding"]}
                for cls, v in sorted(totals.items())}

    @staticmethod
    def _fold_queue_wait(per_replica: dict) -> dict:
        """Fleet-level per-class queue-wait percentiles from the
        replicas' own ``sched.queue_wait`` reservoirs, so an SLO
        comparison reads ONE number instead of re-deriving it per
        replica. ``p50_ms`` is the count-weighted mean of the replica
        medians (a center estimate); ``p99_ms`` is the MAX of the
        replica p99s — a sound upper bound on the union's p99: if every
        replica's p99 <= M then at most 1% of each replica's samples
        exceed M, so at most 1% of the union does. The SLO check is a
        "worst lane a request class can land in" comparison, which is
        exactly the conservative reading an autoscaler wants."""
        agg: dict = {}
        for name in sorted(per_replica):
            m = per_replica[name]
            if not isinstance(m, dict):
                continue
            qw = (m.get("sched") or {}).get("queue_wait")
            if not isinstance(qw, dict):
                continue
            for cls, w in qw.items():
                if not isinstance(w, dict) or not w.get("count"):
                    continue
                n = int(w["count"])
                cur = agg.setdefault(cls, {"count": 0, "_p50_wsum": 0.0,
                                           "p99_ms": 0.0})
                cur["count"] += n
                cur["_p50_wsum"] += n * float(w.get("p50_ms", 0.0))
                cur["p99_ms"] = max(cur["p99_ms"],
                                    float(w.get("p99_ms", 0.0)))
        return {cls: {"count": c["count"],
                      "p50_ms": round(c["_p50_wsum"] / c["count"], 3),
                      "p99_ms": round(c["p99_ms"], 3)}
                for cls, c in sorted(agg.items())}

    def metrics(self) -> dict:
        # replica scrapes fan out like the pool's probes: one wedged
        # replica must cost its own timeout, not add probe_timeout
        # serially to every /metrics request for each bad replica
        per_replica: dict = {}

        def scrape(name: str, url: str) -> None:
            try:
                per_replica[name] = _http_json(
                    f"{url}/metrics", timeout=self.pool.probe_timeout)
            except Exception:  # noqa: BLE001 — dead replica, no metrics
                per_replica[name] = None

        threads = [threading.Thread(target=scrape, args=(n, r.url),
                                    daemon=True)
                   for n, r in self.pool.replicas.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=self.pool.probe_timeout + 2.0)
        agg = {"hits": 0, "misses": 0, "hit_tokens": 0}
        # fleet-wide sp-decode stand-downs, keyed by reason: a sharded
        # replica whose decode quietly replicated the KV cache it paid
        # an sp mesh to shard (or whose spec_k stood down under it) must
        # be visible AT THE ROUTER, not only on the one replica's page
        sd_total, sd_reasons = 0, {}
        # replica-side KV-ship counters (batching.disagg), aggregated so
        # "how many imports were zero-copy" is one read at the router
        ship_agg = {"exports": 0, "export_bytes": 0, "export_streams": 0,
                    "export_chunks": 0, "imports": 0,
                    "import_bytes": 0, "import_streams": 0,
                    "import_chunks": 0, "import_stream_aborts": 0,
                    "import_blocks_inserted": 0,
                    "import_blocks_present": 0, "imports_zero_copy": 0,
                    "imports_assembled": 0, "import_backpressure": 0,
                    "import_rejected": 0}
        for name in sorted(self.pool.replicas):
            m = per_replica.setdefault(name, None)
            if m is None:
                continue
            pc = (m.get("handler") or {}).get("prefix_cache")
            if isinstance(pc, dict):
                for k in agg:
                    agg[k] += int(pc.get(k, 0))
            sp = (m.get("handler") or {}).get("spec")
            if isinstance(sp, dict):
                sd_total += int(sp.get("sp_standdown", 0) or 0)
                for reason, n in (sp.get("sp_standdown_reasons")
                                  or {}).items():
                    sd_reasons[reason] = sd_reasons.get(reason, 0) + int(n)
            dg = ((m.get("handler") or {}).get("batching")
                  or {}).get("disagg")
            if isinstance(dg, dict):
                blocks = dg.get("import_blocks") or {}
                for k in ship_agg:
                    if k == "import_blocks_inserted":
                        ship_agg[k] += int(blocks.get("inserted", 0))
                    elif k == "import_blocks_present":
                        ship_agg[k] += int(blocks.get("present", 0))
                    else:
                        ship_agg[k] += int(dg.get(k, 0) or 0)
        total = agg["hits"] + agg["misses"]
        routable = self.pool.routable()
        queue_wait = self._fold_queue_wait(per_replica)
        router_rep = self.stats.report()
        if self.spill is not None:
            # live gauges (depth, wait percentiles, drain estimate)
            # ride on the stats counters the spill path bumps
            router_rep["spill"] = {**router_rep["spill"],
                                   **self.spill.report()}
        if self.breakers is not None:
            router_rep["breakers"] = {
                name: b.report()
                for name, b in sorted(self.breakers.items())}
        if self.retry_budget is not None:
            router_rep["retry_budget"] = self.retry_budget.report()
        return {
            "router": router_rep,
            "pool": self.pool.report(),
            "fleet": {
                "replicas": len(self.pool.replicas),
                "routable": len(routable),
                "outstanding": sum(r.outstanding
                                   for r in self.pool.replicas.values()),
                "prefix_cache": {
                    **agg,
                    "hit_rate": (round(agg["hits"] / total, 4)
                                 if total else 0.0),
                },
                "spec_standdown": {"total": sd_total,
                                   "reasons": sd_reasons},
                # fleet-level per-class queue-wait percentiles folded
                # from the replicas' sched reservoirs — the SLO signal
                # the elastic controller compares against its target
                "queue_wait": queue_wait,
                # sticky multi-turn sessions: open records + sticky/
                # failover/re-ship counters
                # gauge FIRST: the live count runs the lazy TTL sweep,
                # and the counters snapshot must include any expiries
                # that sweep just recorded (same-scrape convergence,
                # like the replica's lease expiry on stats())
                "sessions": {
                    "active": self._live_session_count(),
                    **self.sessions.report(),
                },
                # phase-split serving: router-side dispatch/ship/EWMA
                # counters (incl. per-class busy-fraction EWMAs under
                # "util") + live occupancy + per-class membership + the
                # replica-side export/import aggregate
                "disagg": {
                    **self.disagg.report(),
                    "occupancy": self._fold_utilization(),
                    "classes": self._class_counts(),
                    "replicas": ship_agg,
                },
                # the elastic control loop's surface (action counters,
                # last-decision trace, current targets) — only present
                # when a FleetController registered itself
                **({"controller": self.controller.report()}
                   if self.controller is not None else {}),
            },
            # faults.armed: the ROUTER process's live injection plan
            # (route_*/probe/kv_ship* sites) — a soak run or a stray
            # LAMBDIPY_FLEET_FAULT is visible at the front door. The
            # pool usually shares this plan; a distinct pool plan (probe
            # site armed separately) reports alongside.
            "faults": {
                "armed": self.faults.armed(),
                **({"pool_armed": self.pool.faults.armed()}
                   if self.pool.faults is not self.faults else {}),
            },
            "replicas": per_replica,
        }

    def debug_invariants(self) -> dict:
        """Host-only fleet invariant sweep (GET /v1/debug/invariants):
        fans out to every replica's own sweep concurrently and folds the
        verdicts. ``ok`` covers the replicas that ANSWERED and are
        routable — an ejected replica's accounting died with it (its
        pins died with it too); the router-side
        gauges (spill depth, open sessions) ride along for the chaos
        checker's quiesce assertions."""
        results: dict = {}

        def probe(name: str, url: str) -> None:
            try:
                results[name] = _http_json(
                    f"{url}/v1/debug/invariants",
                    timeout=self.pool.probe_timeout)
            except Exception as e:  # noqa: BLE001 — dead replica
                results[name] = {"unreachable": True, "error": str(e)}

        threads = [threading.Thread(target=probe, args=(n, r.url),
                                    daemon=True)
                   for n, r in self.pool.replicas.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=self.pool.probe_timeout + 2.0)
        ok = True
        for name, r in self.pool.replicas.items():
            rep = results.get(name)
            if not r.routable:
                # an ejected/draining replica's accounting died (or is
                # dying) with it: reported for the operator, never
                # folded into the fleet verdict
                continue
            if rep is None or rep.get("unreachable"):
                ok = False  # routable but not answering the sweep
                continue
            ok = ok and bool(rep.get("ok"))
        return {
            "ok": ok,
            "replicas": results,
            "spill_depth": (self.spill.depth()
                            if self.spill is not None else 0),
            "sessions": self._live_session_count(),
        }

    def _class_counts(self) -> dict:
        out: dict = {}
        for r in self.pool.replicas.values():
            out[r.role] = out.get(r.role, 0) + 1
        return out

    # -- HTTP plumbing ------------------------------------------------------

    def _make_handler(router_self):
        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                log.debug(fmt % args)

            def send(self, code: int, payload: dict,
                     headers: dict | None = None):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for name, value in (headers or {}).items():
                    self.send_header(name, value)
                self.end_headers()
                try:
                    self.wfile.write(body)
                except OSError:
                    self.close_connection = True

            def relay(self, status: int, hdrs: dict, body: bytes):
                """Relay a replica response verbatim (status, body,
                content type, and the shed contract's Retry-After)."""
                self.send_response(status)
                self.send_header("Content-Type",
                                 hdrs.get("Content-Type",
                                          "application/json"))
                self.send_header("Content-Length", str(len(body)))
                if hdrs.get("Retry-After"):
                    self.send_header("Retry-After", hdrs["Retry-After"])
                self.end_headers()
                try:
                    self.wfile.write(body)
                except OSError:
                    self.close_connection = True

            def write_frame(self, body: bytes) -> bool:
                try:
                    self.wfile.write(f"{len(body):x}\r\n".encode())
                    self.wfile.write(body)
                    self.wfile.write(b"\r\n")
                    return True
                except OSError:
                    self.close_connection = True
                    return False

            def end_frames(self) -> None:
                try:
                    self.wfile.write(b"0\r\n\r\n")
                except OSError:
                    self.close_connection = True

            def do_GET(self):
                if self.path == "/healthz":
                    pool = router_self.pool
                    routable = pool.routable()
                    wedged = sorted(n for n, r in pool.replicas.items()
                                    if r.wedged)
                    self.send(200, {
                        "ok": bool(routable),
                        "router": True,
                        "routable": len(routable),
                        "replicas": {n: r.state
                                     for n, r in sorted(
                                         pool.replicas.items())},
                        # phase-split topology at a glance: replica
                        # count per class; disagg is active when a
                        # prefill-class replica exists
                        "classes": router_self._class_counts(),
                        # replicas whose engine watchdog declared the
                        # device wedged (they answer probes but cannot
                        # serve) — the fleet-level view of the per-
                        # replica /healthz wedged flag
                        **({"wedged": wedged} if wedged else {}),
                        **({"spill_depth": router_self.spill.depth()}
                           if router_self.spill is not None else {}),
                        "sessions": router_self._live_session_count(),
                        "affinity": router_self.affinity_on,
                        "block": router_self.block,
                    })
                elif self.path == "/metrics":
                    self.send(200, router_self.metrics())
                elif self.path == "/v1/debug/invariants":
                    # host-only, like the replica twin: a fault-surface
                    # and cache-internals sweep is operator tooling
                    if self.client_address[0] not in ("127.0.0.1",
                                                      "::1"):
                        self.send(403, {"ok": False, "error":
                                        "host-only endpoint (loopback "
                                        "clients only)"})
                        return
                    self.send(200, router_self.debug_invariants())
                else:
                    self.send(404, {"ok": False, "error": "not found"})

            def do_DELETE(self):
                if self.path.startswith("/v1/sessions/"):
                    sid = self.path[len("/v1/sessions/"):]
                    if sid:
                        router_self._end_session(sid, self)
                        return
                self.send(404, {"ok": False, "error": "not found"})

            def do_POST(self):
                if self.path not in _ROUTED_PATHS:
                    self.send(404, {"ok": False, "error": "not found"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    raw = self.rfile.read(length) or b"{}"
                    body = json.loads(raw)
                    if not isinstance(body, dict):
                        raise ValueError("body must be a JSON object")
                except (ValueError, json.JSONDecodeError) as e:
                    self.send(400, {"ok": False,
                                    "error": f"bad request: {e}"})
                    return
                router_self._route(self, self.path, body, raw)

        return Handler

    # -- lifecycle ----------------------------------------------------------

    def serve_forever(self):
        log_event(log, "fleet router serving", port=self.port,
                  replicas=len(self.pool.replicas),
                  affinity=self.affinity_on)
        self._httpd.serve_forever()

    def start_background(self) -> "FleetRouter":
        self._thread = threading.Thread(target=self.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self.spill is not None:
            self.spill.close()  # wake parked client threads first
        self._httpd.shutdown()
        self._httpd.server_close()
