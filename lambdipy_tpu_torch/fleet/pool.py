"""Replica-pool manager: N supervised bundle servers as one fleet.

The port's copy of ``lambdipy_tpu/fleet/pool.py``. Spawned replicas are
the port's deployments (``runtime/deploy.py``): on the card unless the
pool is asked for the CPU (``device="cpu"``); with no card and no CPU
request a spawn raises before it starts a process.

The deploy layer (runtime/deploy.py) knows how to run ONE supervised
replica: spawn, wait for the readiness line, drain, stop.
:class:`ReplicaPool` runs N of them as a unit the router can serve from:

- **spawn** goes through the existing ``LocalRuntime``/supervisor
  contract (one deployment per replica, watchdog on), so every
  single-replica behavior — crash respawn with backoff, port pinning
  across restarts, drain-before-kill — is inherited, not re-implemented;
- a **prober thread** GETs each replica's ``/healthz`` every
  ``probe_interval``: a connection failure (or router-reported one, see
  :meth:`note_failure`) EJECTS the replica after ``fail_threshold``
  consecutive failures; an ejected replica whose probes pass
  ``readmit_passes`` times in a row (and which reports ``ready``) is
  re-admitted — the supervisor's restart story becomes fleet-level
  availability;
- ``/healthz`` ``ready: false`` (boot warm in flight, or drain begun) is
  LIVE but NOT ROUTABLE: the router stops sending before the replica
  starts 503ing, and readiness flaps never count as failures;
- **rolling restart** drains replicas one at a time (``/shutdown`` via
  ``LocalRuntime.restart``, which redeploys on the SAME port), never
  letting the routable count drop below ``live_floor``.

The pool also carries the per-replica router counters
(routed/retried/hedged/errors) so the fleet ``/metrics`` can report
them next to the health state machine's (ejections/restarts).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

from lambdipy_tpu_torch.runtime.deploy import LocalRuntime, _http_json
from lambdipy_tpu_torch.utils.logs import get_logger, log_event

log = get_logger("lambdipy.fleet.pool")

READY = "ready"
DRAINING = "draining"
EJECTED = "ejected"
STOPPED = "stopped"

# replica CLASSES for disaggregated (phase-split) serving: a "prefill"
# replica only ever sees /v1/kv/export legs (compute-bound, bursty); a
# "decode" replica serves the request traffic (HBM-bound, steady) from
# shipped KV; "mixed" — the default — does both, which is exactly the
# pre-disaggregation fleet
PREFILL = "prefill"
DECODE = "decode"
MIXED = "mixed"
CLASSES = (PREFILL, DECODE, MIXED)


class FleetError(RuntimeError):
    pass


def parse_attach_spec(spec: str) -> tuple[str, str, str]:
    """``NAME=URL[:class]`` -> (name, url, class). The class suffix is
    optional (default ``mixed``) and only recognized when it names a
    real replica class — ``NAME=http://host:8080`` keeps its port. A
    purely alphabetic suffix that is NOT a class raises (a typo'd
    ``:prefil`` must not silently attach a mixed replica the operator
    meant to dedicate); anything else — a port, an IPv6 literal's
    ``::1]`` tail, a path — is just part of the URL, exactly what the
    pre-class grammar accepted."""
    name, sep, rest = spec.partition("=")
    if not sep or not name or not rest.startswith("http"):
        raise FleetError(
            f"attach spec wants NAME=URL[:class] (http...), got {spec!r}")
    url, csep, suffix = rest.rpartition(":")
    if csep and suffix.lower() in CLASSES:
        return name, url, suffix.lower()
    if csep and suffix.isalpha():
        raise FleetError(
            f"attach spec {spec!r}: unknown replica class {suffix!r} "
            f"(want one of {CLASSES})")
    return name, rest, MIXED


@dataclass
class Replica:
    """One fleet member. ``state`` is the pool's routing decision
    (ready/draining/ejected/stopped); ``ready`` is the replica's own
    last-reported readiness flag — both must hold to route."""

    name: str
    url: str
    state: str = READY
    ready: bool = True
    # replica class (prefill | decode | mixed): the router's phase-split
    # dispatch keys on it — decode traffic never routes to a prefill-
    # class replica (except as the last-resort mixed-mode degrade), and
    # KV-ship export legs only target prefill-class replicas
    role: str = MIXED
    # the replica's engine watchdog declared its device transport
    # wedged: the process answers /healthz but cannot serve — treated
    # as a FAILED probe (ejection), not a readiness flap
    wedged: bool = False
    managed: bool = False          # spawned through LocalRuntime by us
    spawn_env: dict | None = None  # env to reuse on rolling restart
    spawn_device: str | None = None  # "cpu", or None for the card
    # the on_admit hook (affinity-aware cache warming) fired for this
    # replica's current admission; reset on ejection so a readmitted
    # replica — whose radix cache died with its worker — warms again
    warmed: bool = False
    outstanding: int = 0
    # time-weighted occupancy accounting (fed by acquire/release): total
    # seconds this replica had at least one request outstanding, plus
    # the start of the currently open busy interval. The router's
    # per-class utilization EWMAs (fleet.disagg.util) integrate these —
    # the observability basis for prefill-pool sizing.
    busy_s: float = 0.0
    busy_since: float | None = field(default=None, repr=False)
    consecutive_fails: int = 0
    consecutive_passes: int = 0
    pid: int | None = None         # serving WORKER pid (healthz), not the
    #                                supervisor's — changes on respawn
    restarts: int = 0              # worker pid changes seen by the prober
    ejections: int = 0
    routed: int = 0
    retried: int = 0
    hedged: int = 0
    errors: int = 0
    last_health: dict = field(default_factory=dict)

    @property
    def routable(self) -> bool:
        return self.state == READY and self.ready

    def counters(self) -> dict:
        return {
            "url": self.url,
            "state": self.state,
            "class": self.role,
            "ready": self.ready,
            "wedged": self.wedged,
            "outstanding": self.outstanding,
            "routed": self.routed,
            "retried": self.retried,
            "hedged": self.hedged,
            "errors": self.errors,
            "ejections": self.ejections,
            "restarts": self.restarts,
            "pid": self.pid,
        }


class ReplicaPool:
    def __init__(self, *, probe_interval: float = 1.0,
                 fail_threshold: int = 1, readmit_passes: int = 2,
                 probe_timeout: float = 5.0, faults=None):
        self.probe_interval = max(0.05, float(probe_interval))
        self.fail_threshold = max(1, int(fail_threshold))
        self.readmit_passes = max(1, int(readmit_passes))
        self.probe_timeout = float(probe_timeout)
        # deterministic chaos for the PROBE path (runtime/faults.py
        # ``probe`` site): an empty plan costs one ``if`` per probe
        if faults is None:
            from lambdipy_tpu_torch.runtime.faults import FaultPlan
            faults = FaultPlan.empty()
        self.faults = faults
        # fired (outside the pool lock, from the prober thread) the
        # first time a replica becomes routable after attach/spawn or
        # after an ejection — the router hooks affinity-aware cache
        # warming here; exceptions are swallowed (warming is advisory)
        self.on_admit = None
        # fired SYNCHRONOUSLY (outside the pool lock) the moment
        # begin_drain marks a replica DRAINING — before any /shutdown
        # reaches its server, so the replica still serves. The router
        # hooks proactive session KV re-ship here: pinned conversation
        # heads move to their rendezvous successor while the old home
        # can still export them. Exceptions are swallowed (a re-ship is
        # an optimization; the turn-time failover path remains).
        self.on_drain = None
        self.replicas: dict[str, Replica] = {}
        self.runtime: LocalRuntime | None = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- membership ---------------------------------------------------------

    def attach(self, name: str, url: str, *, role: str = MIXED) -> Replica:
        """Register an externally managed replica (a remote host, a
        deployment the operator already made, or a test stub). Attached
        replicas are FIRST-CLASS for routing and health — probed,
        ejected, readmitted, and cache-warmed exactly like spawned
        ones — but have a probe-only lifecycle: ``rolling_restart`` and
        ``begin_drain`` refuse them (this pool cannot redeploy a
        process it does not own), and ``stop_all`` detaches without
        touching the remote process. ``role`` is the replica class
        (prefill | decode | mixed) the router's phase-split keys on."""
        if role not in CLASSES:
            raise FleetError(
                f"unknown replica class {role!r} (want one of {CLASSES})")
        r = Replica(name=name, url=url.rstrip("/"), role=role)
        with self._lock:
            if name in self.replicas:
                raise FleetError(f"replica {name!r} already in the pool")
            self.replicas[name] = r
        return r

    def spawn(self, name: str, bundle_dir: Path, *,
              runtime: LocalRuntime | None = None, env: dict | None = None,
              port: int = 0, ready_timeout: float = 300.0,
              watchdog: bool = True, role: str = MIXED,
              device: str | None = None) -> Replica:
        """Deploy one supervised replica and register it; ``device="cpu"``
        serves it on the CPU, else on the card."""
        if runtime is not None:
            self.runtime = runtime
        if self.runtime is None:
            self.runtime = LocalRuntime()
        dep = self.runtime.deploy(name, bundle_dir, port=port,
                                  ready_timeout=ready_timeout, env=env,
                                  watchdog=watchdog, device=device)
        return self._register(name, dep.url, role, env, device)

    def _register(self, name: str, url: str, role: str, env: dict | None,
                  device: str | None) -> Replica:
        """Attach a replica this pool deployed, as managed."""
        r = self.attach(name, url, role=role)
        r.managed = True
        r.spawn_env = dict(env) if env else None
        r.spawn_device = device
        self.probe_one(r)  # fill pid/ready before the first route
        log_event(log, "replica spawned", name=name, url=r.url,
                  role=role)
        return r

    def spawn_fleet(self, bundle_dir: Path, n: int, *, base_name: str,
                    runtime: LocalRuntime | None = None,
                    env: dict | None = None,
                    ready_timeout: float = 300.0,
                    role: str = MIXED,
                    device: str | None = None) -> list[Replica]:
        return self.spawn_all(
            bundle_dir, [(f"{base_name}-r{i}", role) for i in range(int(n))],
            runtime=runtime, env=env, ready_timeout=ready_timeout,
            device=device)

    def spawn_all(self, bundle_dir: Path, specs, *,
                  runtime: LocalRuntime | None = None,
                  env: dict | None = None, ready_timeout: float = 300.0,
                  device: str | None = None) -> list[Replica]:
        """Deploy ``specs`` — ``(name, role)`` pairs — at once, a thread
        each, then register them in the order given, as :meth:`spawn`
        registers one: a fleet boots in the time of its slowest replica,
        not of all of them one after the other. If any deploy fails (or
        the wait is interrupted), the others are waited for and stopped
        before the error is raised: a half-spawned fleet leaks no
        process."""
        from concurrent.futures import ThreadPoolExecutor

        specs = list(specs)
        if runtime is not None:
            self.runtime = runtime
        if self.runtime is None:
            self.runtime = LocalRuntime()
        pool = ThreadPoolExecutor(max(1, len(specs)))
        futures = [pool.submit(self.runtime.deploy, name, bundle_dir,
                               ready_timeout=ready_timeout, env=env,
                               device=device) for name, _ in specs]
        try:
            deps = [f.result() for f in futures]
        except BaseException:
            pool.shutdown(wait=True)
            for (name, _), f in zip(specs, futures):
                if f.exception() is None:
                    try:
                        self.runtime.stop(name)
                    except Exception:  # noqa: BLE001 — stop the rest
                        pass
            raise
        pool.shutdown(wait=True)
        return [self._register(name, dep.url, role, env, device)
                for (name, role), dep in zip(specs, deps)]

    # -- health state machine -----------------------------------------------

    def probe_one(self, r: Replica) -> bool:
        """One health probe; returns True when the replica passed."""
        try:
            # ``probe`` fault site: an injected exception is a failed
            # probe (a flapping replica), a delay is probe latency
            self.faults.check("probe")
            h = _http_json(f"{r.url}/healthz", timeout=self.probe_timeout)
            ok = bool(h.get("ok"))
        except Exception:  # noqa: BLE001 — refused/timeout/bad JSON all fail
            h, ok = None, False
        fire_admit = None
        with self._lock:
            if not ok:
                self._fail_locked(r)
                return False
            r.wedged = bool(h.get("wedged"))
            r.last_health = {k: h.get(k) for k in
                             ("ready", "draining", "warming", "wedged",
                              "uptime_s")}
            if r.wedged:
                # the replica ANSWERS but its engine watchdog declared
                # the device transport dead: that is a failure, not a
                # readiness flap — eject at probe speed so the router
                # stops feeding it, and keep failing until the engine
                # reports recovered (readmission then takes the normal
                # consecutive-passes path)
                r.ready = False
                self._fail_locked(r)
                return False
            r.consecutive_fails = 0
            pid = h.get("pid")
            if isinstance(pid, int):
                if r.pid is not None and pid != r.pid:
                    r.restarts += 1  # the supervisor respawned the worker
                r.pid = pid
            # servers predating the readiness split report only
            # "draining" — treat not-draining as ready
            r.ready = bool(h.get("ready", not h.get("draining")))
            if r.state == EJECTED:
                r.consecutive_passes += 1
                if r.consecutive_passes >= self.readmit_passes and r.ready:
                    r.state = READY
                    r.consecutive_passes = 0
                    log_event(log, "replica readmitted", name=r.name,
                              pid=r.pid, restarts=r.restarts)
            if self.on_admit is not None and r.routable and not r.warmed:
                r.warmed = True
                fire_admit = self.on_admit
        if fire_admit is not None:
            try:  # advisory (cache warming): never fail the probe over it
                fire_admit(r)
            except Exception:  # noqa: BLE001
                pass
        return True

    def _fail_locked(self, r: Replica) -> None:
        r.consecutive_passes = 0
        r.consecutive_fails += 1
        # DRAINING deliberately does NOT transition: a replica the pool
        # is restarting is expected to stop answering mid-drain, and
        # counting that as an ejection would make every clean rolling
        # restart read as an outage in /metrics
        if r.state == READY and \
                r.consecutive_fails >= self.fail_threshold:
            r.state = EJECTED
            r.ejections += 1
            r.warmed = False  # its radix cache is gone; re-warm on readmit
            log_event(log, "replica ejected", name=r.name,
                      consecutive_fails=r.consecutive_fails)

    def note_failure(self, r: Replica) -> None:
        """Router-observed connection failure: counts like a failed probe
        so a dead replica is ejected at traffic speed, not probe speed."""
        with self._lock:
            r.errors += 1
            self._fail_locked(r)

    def probe_all(self) -> None:
        """Probe every replica CONCURRENTLY: a wedged replica that
        accepts TCP but never answers must cost its own probe_timeout,
        not delay every other replica's ejection/readmission behind it
        in a serial sweep."""
        targets = [r for r in self.replicas.values() if r.state != STOPPED]
        if len(targets) <= 1:
            for r in targets:
                self.probe_one(r)
            return
        threads = [threading.Thread(target=self.probe_one, args=(r,),
                                    daemon=True) for r in targets]
        for t in threads:
            t.start()
        # bound the SWEEP, not the slowest probe: a wedged replica's
        # probe keeps running (and lands its failure) in the background
        # while the next sweep starts on schedule — otherwise one hung
        # /healthz stretches every replica's probe period to
        # probe_timeout
        deadline = time.monotonic() + max(self.probe_interval, 0.5)
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))

    def start(self) -> "ReplicaPool":
        def _loop():
            while not self._stop.wait(self.probe_interval):
                try:
                    self.probe_all()
                except Exception:  # noqa: BLE001 — the prober never dies
                    pass

        self._thread = threading.Thread(target=_loop, daemon=True,
                                        name="fleet-prober")
        self._thread.start()
        return self

    # -- routing surface ----------------------------------------------------

    def routable(self) -> list[Replica]:
        with self._lock:
            return [r for r in self.replicas.values() if r.routable]

    def live_fallback(self) -> list[Replica]:
        """READY-state replicas whose own readiness flag is false (warm
        in flight, or drain observed on the server side). They DO serve
        traffic — warm time-shares the device by design — so when the
        strict routable set is empty the router degrades to these
        instead of browning out the whole fleet (e.g. both replicas of
        a fresh fleet warming their group-prefill programs at once).
        A WEDGED replica never qualifies: it is live but demonstrably
        cannot serve — degrading to it would turn every fleet-wide brownout
        into guaranteed timeouts."""
        with self._lock:
            return [r for r in self.replicas.values()
                    if r.state == READY and not r.ready and not r.wedged]

    def acquire(self, r: Replica) -> None:
        with self._lock:
            if r.outstanding == 0:
                r.busy_since = time.monotonic()
            r.outstanding += 1

    def release(self, r: Replica) -> None:
        with self._lock:
            r.outstanding = max(0, r.outstanding - 1)
            if r.outstanding == 0 and r.busy_since is not None:
                r.busy_s += time.monotonic() - r.busy_since
                r.busy_since = None

    def busy_totals(self) -> dict:
        """Per-class occupancy snapshot: cumulative busy seconds (open
        intervals closed at now), replica count, and live outstanding —
        the raw material for the router's busy-fraction EWMAs."""
        now = time.monotonic()
        out: dict = {}
        with self._lock:
            for r in self.replicas.values():
                if r.state == STOPPED:
                    continue
                busy = r.busy_s
                if r.busy_since is not None:
                    busy += now - r.busy_since
                cls = out.setdefault(r.role, {"busy_s": 0.0,
                                              "replicas": 0,
                                              "outstanding": 0})
                cls["busy_s"] += busy
                cls["replicas"] += 1
                cls["outstanding"] += r.outstanding
        return out

    def bump(self, r: Replica, counter: str, n: int = 1) -> None:
        """Locked increment of a per-replica router counter
        (routed/retried/hedged/errors) — concurrent handler threads must
        not lose counts the fault-injection tests assert on."""
        with self._lock:
            setattr(r, counter, getattr(r, counter) + n)

    def begin_drain(self, name: str) -> None:
        """Mark a replica draining so the router stops sending BEFORE its
        server starts 503ing new work. Managed replicas only: an
        attached (unmanaged) replica has a probe-only lifecycle — this
        pool cannot finish a drain it cannot restart, so marking one
        DRAINING would just blackhole it until an operator noticed."""
        with self._lock:
            r = self.replicas[name]
            if not r.managed:
                raise FleetError(
                    f"replica {name!r} is attached (unmanaged): probe-only "
                    f"lifecycle — it is ejected/readmitted on health, never "
                    f"drained or restarted by this pool")
            r.state = DRAINING
            hook = self.on_drain
        if hook is not None:
            # synchronous on purpose: rolling_restart POSTs /shutdown
            # right after this returns, and the proactive re-ship must
            # export from the draining replica while it still serves
            try:
                hook(r)
            except Exception:  # noqa: BLE001 — re-ship is advisory
                log_event(log, "on_drain hook failed", name=name)

    def end_drain(self, name: str) -> None:
        """Abort a drain begun with :meth:`begin_drain`: the replica
        returns to routing without a restart. ``rolling_restart`` never
        needs this (its drain always ends in a redeploy); the chaos
        nemesis's drain/undrain events — and an operator changing their
        mind — do. A replica that meanwhile ejected or stopped is left
        alone: only DRAINING flips back."""
        with self._lock:
            r = self.replicas[name]
            if r.state == DRAINING:
                r.state = READY

    def set_role(self, name: str, role: str, *,
                 reship: bool = True) -> Replica:
        """Flip a replica's class (promote a mixed replica to prefill,
        demote it back, ...). The class is a ROUTER-SIDE attribute — the
        replica process never knew it — so no restart is needed: the
        replica goes transiently DRAINING (the router stops picking it),
        the ``on_drain`` hook re-ships its pinned sessions to their
        rendezvous successors while it still serves, and the role flips.
        Works for managed AND attached replicas: unlike
        :meth:`begin_drain`, the drain here is transient by construction
        (this method itself ends it), so the probe-only-lifecycle
        objection does not apply."""
        if role not in CLASSES:
            raise FleetError(
                f"unknown replica class {role!r} (want one of {CLASSES})")
        with self._lock:
            r = self.replicas[name]
            if r.state == STOPPED:
                raise FleetError(f"replica {name!r} is stopped")
            if r.role == role:
                return r
            prev = r.role
            hook = self.on_drain if reship else None
            restore = r.state == READY
            if restore:
                r.state = DRAINING
        if hook is not None:
            try:  # synchronous: export while the old home still serves
                hook(r)
            except Exception:  # noqa: BLE001 — re-ship is advisory
                log_event(log, "on_drain hook failed", name=name)
        with self._lock:
            r.role = role
            # only undo OUR transient drain: a concurrent ejection (or a
            # real begin_drain racing in) keeps its state
            if restore and r.state == DRAINING:
                r.state = READY
        log_event(log, "replica role changed", name=name, prev=prev,
                  role=role)
        return r

    # -- lifecycle ----------------------------------------------------------

    def retire(self, name: str, *, grace: float = 10.0) -> None:
        """Permanently remove ONE managed replica (fleet downsize):
        drain — which fires the proactive session re-ship — then stop
        the deployment and mark it STOPPED so probes and routing skip
        it for good. The raw actuator only: floor enforcement
        (live_floor, min_replicas) is the policy layer's job."""
        with self._lock:
            r = self.replicas[name]
            if not r.managed:
                raise FleetError(
                    f"replica {name!r} is attached (unmanaged): this pool "
                    f"cannot retire a process it does not own")
            if r.state == STOPPED:
                return
        self.begin_drain(name)
        if self.runtime is not None:
            try:
                self.runtime.stop(name, grace=grace)
            except Exception:  # noqa: BLE001 — mark stopped regardless
                log_event(log, "retire: runtime stop failed", name=name)
        with self._lock:
            r.state = STOPPED
        log_event(log, "replica retired", name=name)

    def rolling_restart(self, *, live_floor: int = 1,
                        ready_timeout: float = 300.0,
                        drain_grace: float = 10.0) -> None:
        """Restart every managed replica one at a time: drain via
        ``/shutdown``, redeploy on the SAME port, wait until it serves
        again — the routable count never drops below ``live_floor``.
        Attached (unmanaged) replicas are never touched: they keep
        serving through the restart (and count toward the floor), and a
        pool holding ONLY attached replicas raises a clear error
        instead of an AttributeError on the runtime it never had."""
        managed = [r for r in self.replicas.values() if r.managed]
        attached = sorted(r.name for r in self.replicas.values()
                          if not r.managed and r.state != STOPPED)
        if not managed:
            detail = (f"; {attached} are attached (unmanaged) with a "
                      f"probe-only lifecycle — restart them where they "
                      f"were deployed" if attached else "")
            raise FleetError(f"no managed replicas to restart{detail}")
        if self.runtime is None:
            raise FleetError("pool has no LocalRuntime")
        if live_floor > len(managed) - 1 + \
                len([r for r in self.replicas.values() if not r.managed]):
            raise FleetError(
                f"live_floor={live_floor} cannot hold while restarting "
                f"one of {len(managed)} replicas")
        for r in managed:
            deadline = time.monotonic() + ready_timeout
            while len([x for x in self.routable() if x.name != r.name]) \
                    < live_floor:
                if time.monotonic() > deadline:
                    raise FleetError(
                        f"fleet below live floor {live_floor}; refusing to "
                        f"drain {r.name}")
                time.sleep(0.2)
            self.begin_drain(r.name)
            log_event(log, "rolling restart: draining", name=r.name)
            dep = self.runtime.restart(
                r.name, ready_timeout=ready_timeout, env=r.spawn_env,
                grace=drain_grace, device=r.spawn_device)
            with self._lock:
                r.url = dep.url
                r.consecutive_fails = r.consecutive_passes = 0
            # the redeploy waited for the readiness line; one direct
            # probe flips it routable without waiting readmit_passes
            if self.probe_one(r):
                with self._lock:
                    r.state = READY
            else:  # let the prober re-admit it through the normal path
                with self._lock:
                    r.state = EJECTED
            log_event(log, "rolling restart: replica back", name=r.name,
                      url=r.url)

    def stop_all(self) -> None:
        self.close()
        for r in self.replicas.values():
            if r.managed and self.runtime is not None:
                try:
                    self.runtime.stop(r.name)
                except Exception:  # noqa: BLE001 — stop the rest regardless
                    pass
            r.state = STOPPED

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def report(self) -> dict:
        with self._lock:
            return {name: r.counters()
                    for name, r in sorted(self.replicas.items())}
