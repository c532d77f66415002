"""Elastic fleet control loop: published signals -> safe actuators.

:class:`FleetController` is the port's copy of
``lambdipy_tpu/fleet/controller.py``. Every tick it scrapes the fleet's
own ``/metrics`` surface (the router aggregate — nothing here reads
private state the operator cannot see), assembles a pure
:class:`~lambdipy_tpu_torch.fleet.policy.Snapshot`, asks
:func:`~lambdipy_tpu_torch.fleet.policy.decide` what to do, and acts
through the existing safe primitives:

====================================  ===================================
decision                              actuator
====================================  ===================================
promote / demote (class flip)         ``pool.set_role`` — transient
                                      drain + proactive session re-ship,
                                      no restart (the class is a
                                      router-side attribute)
spawn                                 the ``spawner`` callback (CLI wires
                                      it to ``pool.spawn`` with the
                                      fleet's bundle + env)
retire                                ``pool.retire`` — drain + stop one
                                      managed replica
``pipeline_depth`` / ``spec_k``       ``POST /v1/debug/knobs`` on the
                                      replica (loopback-only admin
                                      endpoint; both knobs are read
                                      per-dispatch by the engine, so a
                                      live retune is race-free)
``ship_window``                       plain attribute write on the
                                      router (read per-ship)
====================================  ===================================

The controller never invents state: hysteresis, cooldowns, and the
live-floor guard all live in the pure policy, so a recorded snapshot
sequence replays to a byte-identical decision trace. In ``dry_run`` mode
decisions are fully traced and counted as INTENTS but no actuator fires
— the recommended first step before trusting the loop in a new
deployment.

Applied actions are appended to :attr:`events` in the chaos nemesis's
event grammar (``@T action target [detail]``) so a soak window can
interleave controller-initiated resizes with injected faults in one
timeline and hold the zero-silent-loss bar across both.
"""

from __future__ import annotations

import threading
import time

from lambdipy_tpu_torch.fleet.policy import (DEMOTE, MIXED, PROMOTE,
                                             RETIRE, ROUTER, SET_KNOB, SPAWN,
                                             Action, PolicyConfig,
                                             PolicyState, ReplicaView,
                                             Snapshot, decide)
from lambdipy_tpu_torch.runtime.deploy import _http_json
from lambdipy_tpu_torch.runtime.metrics import ControllerStats
from lambdipy_tpu_torch.utils.logs import get_logger, log_event

log = get_logger("lambdipy.fleet.controller")

# decision_log / events are diagnosis surfaces, not history: bound them
# so a long-lived loop cannot grow without limit
_LOG_CAP = 4096


class FleetController:
    def __init__(self, router, *, config: PolicyConfig | None = None,
                 interval_s: float = 5.0, dry_run: bool = False,
                 spawner=None, knob_timeout: float = 5.0):
        self.router = router
        self.pool = router.pool
        self.config = config or PolicyConfig()
        self.state = PolicyState()
        self.stats = ControllerStats()
        self.interval_s = max(0.05, float(interval_s))
        self.dry_run = bool(dry_run)
        # spawner(role) -> replica name; must spawn AND register the
        # replica with the pool (the CLI wires pool.spawn). None means
        # the fleet cannot grow — the policy is told via can_spawn.
        self.spawner = spawner
        self.knob_timeout = float(knob_timeout)
        # nemesis-visible ledger of APPLIED actions, in the soak event
        # grammar: {"t", "action", "target", "event"}
        self.events: list[dict] = []
        # (snapshot, [rendered actions]) pairs — a determinism check
        # replays decide() over these with a fresh
        # PolicyState and diffs the rendered actions byte-for-byte
        self.decision_log: list[tuple[Snapshot, list[str]]] = []
        self._t0 = time.monotonic()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.stats.set_targets(
            slo_p99_ms=self.config.slo_p99_ms,
            slo_class=self.config.slo_class,
            hysteresis=self.config.hysteresis,
            sustain_s=self.config.sustain_s,
            live_floor=self.config.live_floor,
            interval_s=self.interval_s,
            dry_run=self.dry_run,
        )
        # the router exports fleet.controller from this registration
        router.controller = self

    # -- snapshot assembly --------------------------------------------------

    def build_snapshot(self, metrics: dict, *, t: float | None = None
                       ) -> Snapshot:
        """Assemble the policy's input from one router ``/metrics``
        scrape. Missing signals become ``None``/defaults — the policy
        skips what it cannot see rather than acting on a guess."""
        if t is None:
            t = time.monotonic() - self._t0
        fleet = metrics.get("fleet") or {}
        disagg = fleet.get("disagg") or {}
        qw = fleet.get("queue_wait") or {}
        per_replica = metrics.get("replicas") or {}
        views = []
        with self.pool._lock:
            members = [(r.name, r.role, r.routable, r.managed,
                        r.outstanding, r.state)
                       for r in self.pool.replicas.values()]
        for name, role, routable, managed, outstanding, state in \
                sorted(members):
            if state == "stopped":
                continue
            rm = per_replica.get(name) or {}
            batching = ((rm.get("handler") or {}).get("batching") or {})
            pipeline = batching.get("pipeline") or {}
            depth = batching.get("pipeline_depth")
            wall = pipeline.get("wall_s")
            fetch = pipeline.get("fetch_block_s")
            fetch_frac = None
            if isinstance(wall, (int, float)) and wall > 0 \
                    and isinstance(fetch, (int, float)):
                fetch_frac = float(fetch) / float(wall)
            spec = batching.get("spec") or {}
            # draft tier: the engine's provider default plus the MODEL
            # provider's acceptance EWMA (batching.spec.draft) — what
            # the policy's draft_mode demote rule watches
            draft = spec.get("draft") or {}
            dprov = ((draft.get("providers") or {}).get("model") or {})
            # long-context tier (batching.long_context): re-online
            # stall seconds over engine-busy wall (pipeline.wall_s) is
            # the thrash signal the max_logical_ctx retune watches;
            # absent block -> all None
            lc = batching.get("long_context") or {}
            stall = lc.get("stall_s")
            stall_frac = None
            if isinstance(wall, (int, float)) and wall > 0 \
                    and isinstance(stall, (int, float)):
                stall_frac = float(stall) / float(wall)
            views.append(ReplicaView(
                name=name, role=role, routable=routable, managed=managed,
                outstanding=int(outstanding),
                pipeline_depth=int(depth) if isinstance(depth, int) else None,
                overlap_ratio=pipeline.get("overlap_ratio"),
                fetch_frac=fetch_frac,
                spec_k=spec.get("k"),
                acceptance=spec.get("acceptance_rate"),
                draft_mode=spec.get("draft_mode"),
                draft_acceptance=dprov.get("acceptance_ewma"),
                offload_stall_frac=stall_frac,
                prefetch_hit_rate=lc.get("prefetch_hit_rate"),
                max_logical_ctx=lc.get("max_logical_ctx"),
                compiled_window=lc.get("window"),
                boot_logical_ctx=lc.get("boot_logical_ctx"),
            ))
        return Snapshot(
            t=round(float(t), 3),
            replicas=tuple(views),
            queue_wait_p99_ms={
                cls: w.get("p99_ms") for cls, w in qw.items()
                if isinstance(w, dict) and w.get("p99_ms") is not None},
            util=dict(disagg.get("util") or {}),
            ship_ms_ewma=float(disagg.get("ship_ms_ewma") or 0.0),
            ships=int(disagg.get("ships") or 0),
            ship_window=int(getattr(self.router, "ship_window", 0)),
            can_spawn=self.spawner is not None,
        )

    # -- one tick -----------------------------------------------------------

    def tick(self) -> list[Action]:
        """Scrape -> decide -> act (or log intents). Safe to call
        directly (the tests do); the background thread just
        calls it on a timer."""
        self.stats.count("ticks")
        try:
            snap = self.build_snapshot(self.router.metrics())
        except Exception:  # noqa: BLE001 — a failed scrape skips the tick
            self.stats.count("errors")
            log_event(log, "controller scrape failed")
            return []
        actions = decide(snap, self.state, self.config)
        rendered = [a.render() for a in actions]
        with self._lock:
            self.decision_log.append((snap, rendered))
            del self.decision_log[:-_LOG_CAP]
        if actions:
            self.stats.record_decision({
                "t": snap.t,
                "p99_ms": dict(snap.queue_wait_p99_ms),
                "util": {k: round(v, 4) for k, v in sorted(
                    snap.util.items())},
                "actions": rendered,
                "applied": not self.dry_run,
            })
        for a in actions:
            if self.dry_run:
                self.stats.record_action(a.kind, applied=False)
                log_event(log, "controller intent (dry run)",
                          action=a.render())
                continue
            self._apply(a, snap)
        return actions

    def _apply(self, a: Action, snap: Snapshot) -> None:
        try:
            detail = self._act(a)
        except Exception as e:  # noqa: BLE001 — one failed actuation
            #                     must not kill the loop; the next tick
            #                     sees the unchanged fleet and re-decides
            self.stats.count("errors")
            self.stats.record_action(a.kind, applied=False)
            log_event(log, "controller action failed", action=a.render(),
                      error=str(e))
            return
        if detail is None:  # actuator unavailable: intent, not action
            self.stats.record_action(a.kind, applied=False)
            log_event(log, "controller intent (no actuator)",
                      action=a.render())
            return
        self.stats.record_action(a.kind, applied=True)
        target = detail if a.kind == SPAWN else a.target
        spec = f" {a.knob}={a.value}" if a.kind == SET_KNOB else ""
        with self._lock:
            self.events.append({
                "t": snap.t, "action": a.kind, "target": target,
                "event": f"@{snap.t:.1f} {a.kind} {target}{spec}",
            })
            del self.events[:-_LOG_CAP]
        log_event(log, "controller action", action=a.render(),
                  target=target)

    def _act(self, a: Action) -> str | None:
        """Run one actuator; returns a detail string on success, None
        when the actuator is not available (counted as an intent)."""
        if a.kind in (PROMOTE, DEMOTE):
            self.pool.set_role(a.target, a.role or MIXED)
            return a.role or MIXED
        if a.kind == SPAWN:
            if self.spawner is None:
                return None
            return str(self.spawner(a.role or MIXED))
        if a.kind == RETIRE:
            self.pool.retire(a.target)
            return a.target
        if a.kind == SET_KNOB:
            if a.target == ROUTER:
                if a.knob != "ship_window":
                    return None
                self.router.ship_window = int(a.value)
                self.stats.set_targets(ship_window=int(a.value))
                return str(a.value)
            with self.pool._lock:
                r = self.pool.replicas.get(a.target)
                url = r.url if r is not None else None
            if url is None:
                return None
            out = _http_json(f"{url}/v1/debug/knobs",
                             {a.knob: a.value}, timeout=self.knob_timeout)
            if not out.get("ok"):
                raise RuntimeError(
                    f"knob refused: {out.get('error', out)}")
            return str(a.value)
        return None

    # -- loop lifecycle -----------------------------------------------------

    def start(self) -> "FleetController":
        def _loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 — the loop never dies
                    self.stats.count("errors")

        self._thread = threading.Thread(target=_loop, daemon=True,
                                        name="fleet-controller")
        self._thread.start()
        log_event(log, "controller started", interval_s=self.interval_s,
                  dry_run=self.dry_run,
                  slo_p99_ms=self.config.slo_p99_ms)
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # -- observability ------------------------------------------------------

    def replay_decisions(self) -> bool:
        """Determinism self-check: re-run the pure policy over the
        recorded snapshots with a FRESH state and compare the rendered
        actions byte-for-byte. True means the live trace is exactly
        reproducible from its inputs."""
        with self._lock:
            logged = list(self.decision_log)
        state = PolicyState()
        for snap, rendered in logged:
            again = [a.render() for a in decide(snap, state, self.config)]
            if again != rendered:
                return False
        return True

    def report(self) -> dict:
        out = self.stats.report()
        with self._lock:
            events = [dict(e) for e in self.events[-64:]]
        out["dry_run"] = self.dry_run
        out["events"] = events
        return out
