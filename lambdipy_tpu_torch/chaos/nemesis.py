"""Seeded nemesis: composed fault schedules for the chaos soak.

The port's copy of ``lambdipy_tpu/chaos/nemesis.py``: the same draw
order over the same site registry (``runtime/faults.py``, JAX's site
for site), so a seed renders a byte-identical timeline in both
packages.

A *timeline* is a list of :class:`NemesisEvent` — timestamped
``arm``/``clear``/``kill``/``drain``/``undrain`` actions against named
targets (replica names, or the in-process ``router``). Timelines are

- **derived from one seed**: :func:`generate_timeline` draws every
  decision (which site, which kind, when, for how long, on whom) from
  ``random.Random(seed)`` over a menu built from the
  ``runtime/faults.py`` site REGISTRY, so the same seed yields a
  byte-identical schedule run after run — the reproducibility spine of
  ``python -m lambdipy_tpu_torch.chaos.soak --seed N``;
- **serializable**: one line per event (``@T action target [spec]``),
  round-tripped by :func:`render_timeline`/:func:`parse_timeline`, so a
  failing run's exact schedule replays from a file
  (``--replay-timeline``) without re-deriving anything;
- **overlap-controlled**: 1-3 fault events may be armed concurrently
  (never two on the same target — clearing one must not clear the
  other), at most one process-level nemesis (kill/drain) is in flight
  at a time, and every generated schedule contains at least one
  sustained >= 2-fault overlap, one SIGKILL, and one drain — the
  acceptance floor of the composed-fault soak.

Execution is split from scheduling: :class:`Nemesis` walks a timeline
against a :class:`FleetOps` adapter (HTTP fault-arming on live
replicas, direct plan mutation on the in-process router, SIGKILL on
worker pids), so tests drive the executor against a fake fleet with a
compressed clock.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass

from lambdipy_tpu_torch.runtime.faults import list_sites, parse_spec

ACTIONS = ("arm", "clear", "kill", "drain", "undrain")
ROUTER = "router"

# bounded fault shapes the generator draws from (seconds / fire counts /
# delay milliseconds): every armed fault is cleared by its paired event,
# so nothing outlives the schedule even when a rule never finished firing
FAULT_HOLD_S = (2.0, 5.0)
DELAY_MS = (80, 320)
# exceptions per arm stay <= 2: an engine-owned exception IS an engine
# failure, and rows alive across a burst replay once per failure — the
# soak replicas' replay budget (LAMBDIPY_MAX_REPLAYS=3) must always
# cover a whole arm event so injected faults surface as transparent
# replays or priced sheds, never client 500s
EXC_N = (1, 2)
DELAY_N = (2, 6)
DRAIN_HOLD_S = (2.5, 4.5)


@dataclass(frozen=True)
class NemesisEvent:
    """One timeline entry. ``t`` is seconds from soak start; ``spec`` is
    a ``runtime/faults.py`` spec string for ``arm`` events (empty
    otherwise). The rendered line grammar is ``@T action target [spec]``
    — specs contain no whitespace, so a plain split round-trips."""

    t: float
    action: str
    target: str
    spec: str = ""

    def render(self) -> str:
        base = f"@{self.t:.3f} {self.action} {self.target}"
        return f"{base} {self.spec}" if self.spec else base

    @classmethod
    def parse(cls, line: str) -> "NemesisEvent":
        parts = line.strip().split()
        if len(parts) not in (3, 4) or not parts[0].startswith("@"):
            raise ValueError(
                f"bad timeline line {line!r}: want '@T action target "
                f"[spec]'")
        try:
            t = float(parts[0][1:])
        except ValueError:
            raise ValueError(
                f"bad timeline time in {line!r}") from None
        action, target = parts[1], parts[2]
        if action not in ACTIONS:
            raise ValueError(
                f"bad timeline action {action!r} (want one of {ACTIONS})")
        spec = parts[3] if len(parts) == 4 else ""
        if action == "arm":
            if not spec:
                raise ValueError(f"arm event without a spec: {line!r}")
            parse_spec(spec)  # validate — a typo must fail the replay loudly
        elif spec:
            raise ValueError(
                f"{action} event carries an unexpected spec: {line!r}")
        return cls(t=t, action=action, target=target, spec=spec)


def render_timeline(events: list[NemesisEvent]) -> str:
    return "\n".join(e.render() for e in events)


def parse_timeline(text: str) -> list[NemesisEvent]:
    """Lines -> events; blank lines and ``#`` comments skipped. The
    result is re-sorted by time (stable), exactly like the generator's
    output, so an edited replay file behaves predictably."""
    events = [NemesisEvent.parse(ln) for ln in text.splitlines()
              if ln.strip() and not ln.strip().startswith("#")]
    return sorted(events, key=lambda e: e.t)


# -- schedule generation ------------------------------------------------------


def _fault_menu(targets: list[str]) -> list[tuple[str, str, str]]:
    """(target, site, kind) menu derived from the site REGISTRY: engine/
    store-owned sites arm on replicas (over the replica's LAMBDIPY_FAULT
    plan via POST /v1/debug/faults), router/pool-owned sites arm on the
    in-process router plan. ``hang`` is offered only for engine-owned
    sites: their hangs resolve through the engine's replay machinery
    (watchdog backstop), while a router-side hang would block a forward
    thread until the paired clear with nothing to attribute it to."""
    menu: list[tuple[str, str, str]] = []
    replicas = [t for t in targets if t != ROUTER]
    for site in list_sites():
        if site.owner in ("engine", "store"):
            kinds = (("exception", "delay", "hang")
                     if site.owner == "engine" else ("exception", "delay"))
            for target in replicas:
                for kind in kinds:
                    menu.append((target, site.name, kind))
        else:
            for kind in ("exception", "delay"):
                menu.append((ROUTER, site.name, kind))
    return menu


def _spec_for(rng: random.Random, site: str, kind: str) -> str:
    if kind == "delay":
        return (f"{site}:delay@ms={rng.randint(*DELAY_MS)},"
                f"n={rng.randint(*DELAY_N)}")
    if kind == "exception":
        return f"{site}:exception@n={rng.randint(*EXC_N)}"
    return f"{site}:hang@n=1"


def generate_timeline(*, seed: int, duration_s: float,
                      replicas: list[str], max_overlap: int = 3,
                      extra_faults: int | None = None,
                      must_include: str | None = None
                      ) -> list[NemesisEvent]:
    """Derive a composed-fault schedule from ``seed``.

    Structure (all times inside ``[0.08*D, 0.82*D]`` so traffic exists
    before the first fault and recovery fits inside the soak window):

    1. a GUARANTEED overlap pair — two fault events on two distinct
       targets whose armed intervals overlap by >= 1.5 s;
    2. a GUARANTEED SIGKILL of one replica's worker;
    3. a GUARANTEED drain/undrain of a replica (a different one when
       the fleet has more than one);
    4. ``extra_faults`` additional fault events (default scales with
       the window) placed wherever the overlap constraints allow.

    Constraints enforced by construction: never two concurrent faults
    on the SAME target, never more than ``max_overlap`` concurrent
    fault events fleet-wide, and never two concurrent process-level
    nemeses. Every decision comes from ``random.Random(seed)`` in a
    fixed draw order — same seed, byte-identical timeline.
    """
    if len(replicas) < 2:
        # the composed-fault floor needs two fault targets BESIDES the
        # router once the kill target's post-kill window is off-limits;
        # failing loudly beats the empty-menu ValueError an operator
        # would otherwise hit mid-draw
        raise ValueError(
            "generate_timeline needs >= 2 replicas: the guaranteed "
            "overlap pair must avoid the SIGKILL target, leaving only "
            "the router as a fault target on a 1-replica fleet")
    rng = random.Random(int(seed))
    duration_s = float(duration_s)
    if duration_s < 12.0:
        # below this the mandatory events' draw windows invert
        # (random.uniform silently accepts reversed bounds and would
        # place events before the workload starts)
        raise ValueError(
            f"soak window {duration_s:.0f}s is too short for the "
            f"composed-fault floor (overlap pair + kill + drain): use "
            f">= 12 s")
    lo, hi = 0.08 * duration_s, 0.82 * duration_s
    targets = list(replicas) + [ROUTER]
    menu = _fault_menu(targets)
    events: list[NemesisEvent] = []
    # active fault intervals: (start, end, target)
    intervals: list[tuple[float, float, str]] = []
    proc_intervals: list[tuple[float, float]] = []

    def overlap_ok(t0: float, t1: float, target: str) -> bool:
        live = [iv for iv in intervals if iv[0] < t1 and t0 < iv[1]]
        if any(iv[2] == target for iv in live):
            return False
        # peak concurrency over the candidate interval, including it
        edges = sorted({t0, t1, *(iv[0] for iv in live),
                        *(iv[1] for iv in live)})
        for a, b in zip(edges, edges[1:]):
            mid = (a + b) / 2
            n = 1 + sum(1 for iv in live if iv[0] <= mid < iv[1])
            if n > max_overlap:
                return False
        return True

    def add_fault(t0: float, hold: float, target: str, site: str,
                  kind: str) -> None:
        spec = _spec_for(rng, site, kind)
        t1 = t0 + hold
        intervals.append((t0, t1, target))
        events.append(NemesisEvent(round(t0, 3), "arm", target, spec))
        events.append(NemesisEvent(round(t1, 3), "clear", target))

    def pick(target_filter=None) -> tuple[str, str, str]:
        cands = [m for m in menu
                 if target_filter is None or target_filter(m[0])]
        return cands[rng.randrange(len(cands))]

    # 1. the guaranteed SIGKILL, drawn FIRST: a fault armed on a dead
    # (respawning) replica would no-op for the rest of the window, so
    # later draws keep the kill target's fault intervals BEFORE kill_t
    kill_target = replicas[rng.randrange(len(replicas))]
    kill_t = rng.uniform(lo + 2.0, hi)
    events.append(NemesisEvent(round(kill_t, 3), "kill", kill_target))
    proc_intervals.append((kill_t, kill_t + 1.0))

    def alive(t0: float, t1: float, target: str) -> bool:
        return target != kill_target or t1 <= kill_t

    # 2. the guaranteed overlap pair (distinct targets, neither the
    # kill target — its post-kill window is a process gap, not a fault)
    base = rng.uniform(lo, max(lo, hi - FAULT_HOLD_S[1] - 2.0))
    ta, sa, ka = pick(lambda t: t != kill_target)
    tb, sb, kb = pick(lambda t: t not in (ta, kill_target))
    hold_a = rng.uniform(*FAULT_HOLD_S)
    hold_b = rng.uniform(*FAULT_HOLD_S)
    # second event starts inside the first's window, >= 1.5 s before its
    # end, so the composed (>= 2 armed) state is sustained
    start_b = base + rng.uniform(0.2, max(0.21, hold_a - 1.5))
    add_fault(base, hold_a, ta, sa, ka)
    add_fault(start_b, hold_b, tb, sb, kb)

    # 3. the guaranteed drain/undrain, clear of the kill instant
    drain_cands = [r for r in replicas if r != kill_target] or replicas
    drain_target = drain_cands[rng.randrange(len(drain_cands))]
    for _ in range(64):
        d0 = rng.uniform(lo, hi - DRAIN_HOLD_S[1])
        d1 = d0 + rng.uniform(*DRAIN_HOLD_S)
        if not any(p0 < d1 and d0 < p1 for p0, p1 in proc_intervals):
            break
    events.append(NemesisEvent(round(d0, 3), "drain", drain_target))
    events.append(NemesisEvent(round(d1, 3), "undrain", drain_target))
    proc_intervals.append((d0, d1))

    # 4. random extras, constraint-checked (rejected draws still consume
    # rng state deterministically — the draw ORDER is the contract)
    n_extra = (extra_faults if extra_faults is not None
               else max(2, int(duration_s / 8)))
    placed = 0
    for _ in range(n_extra * 6):
        if placed >= n_extra:
            break
        target, site, kind = pick()
        t0 = rng.uniform(lo, hi)
        hold = rng.uniform(*FAULT_HOLD_S)
        if t0 + hold > 0.9 * duration_s:
            continue
        if not alive(t0, t0 + hold, target):
            continue
        if not overlap_ok(t0, t0 + hold, target):
            continue
        add_fault(t0, hold, target, site, kind)
        placed += 1

    # 5. the guaranteed must_include site (when asked): a soak composing
    # a SPECIFIC failure mode (offload_stall on a paged+offload fleet,
    # say) needs at least one armed leg of that site in EVERY seed's
    # schedule, not just the seeds whose random draws happened to pick
    # it. Drawn AFTER the extras, so must_include=None timelines stay
    # byte-identical to every seed generated before the knob existed.
    if must_include is not None:
        cands = [m for m in menu if m[1] == must_include]
        if not cands:
            raise ValueError(
                f"must_include site {must_include!r} offers no menu "
                f"legs (unknown site, or no eligible target)")
        if not any(e.action == "arm"
                   and e.spec.partition(":")[0] == must_include
                   for e in events):
            for _ in range(128):
                target, site, kind = cands[rng.randrange(len(cands))]
                t0 = rng.uniform(lo, hi)
                hold = rng.uniform(*FAULT_HOLD_S)
                if t0 + hold > 0.9 * duration_s:
                    continue
                if not alive(t0, t0 + hold, target):
                    continue
                if not overlap_ok(t0, t0 + hold, target):
                    continue
                add_fault(t0, hold, target, site, kind)
                break
            else:
                raise ValueError(
                    f"could not place the must_include "
                    f"{must_include!r} event inside the soak window")

    events.sort(key=lambda e: (e.t, e.action, e.target))
    return events


def timeline_properties(events: list[NemesisEvent]) -> dict:
    """Structural facts the soak's acceptance gate asserts on: kill and
    drain counts, peak concurrent armed faults, and the longest
    sustained window with >= 2 faults armed at once."""
    kills = sum(1 for e in events if e.action == "kill")
    drains = sum(1 for e in events if e.action == "drain")
    # reconstruct armed intervals by pairing each arm with its target's
    # next clear
    arms: list[tuple[float, float]] = []
    open_by_target: dict[str, float] = {}
    for e in sorted(events, key=lambda e: e.t):
        if e.action == "arm":
            open_by_target[e.target] = e.t
        elif e.action == "clear" and e.target in open_by_target:
            arms.append((open_by_target.pop(e.target), e.t))
    edges = sorted({t for iv in arms for t in iv})
    peak, sustained = 0, 0.0
    run = 0.0
    for a, b in zip(edges, edges[1:]):
        mid = (a + b) / 2
        n = sum(1 for iv in arms if iv[0] <= mid < iv[1])
        peak = max(peak, n)
        if n >= 2:
            run += b - a
            sustained = max(sustained, run)
        else:
            run = 0.0
    return {"events": len(events), "kills": kills, "drains": drains,
            "fault_arms": sum(1 for e in events if e.action == "arm"),
            "peak_overlap": peak,
            "sustained_overlap_s": round(sustained, 3)}


# -- execution ----------------------------------------------------------------


class FleetOps:
    """Adapter the executor drives; the soak orchestrator subclasses it
    over the live fleet (HTTP arm/clear, SIGKILL on worker pids, pool
    drain), tests over an in-memory fake. Every method may raise — the
    executor records the error and keeps walking the schedule (a nemesis
    that dies mid-timeline would silently un-compose the faults)."""

    def arm(self, target: str, spec: str) -> None:
        raise NotImplementedError

    def clear(self, target: str) -> None:
        raise NotImplementedError

    def kill(self, target: str) -> None:
        raise NotImplementedError

    def drain(self, target: str) -> None:
        raise NotImplementedError

    def undrain(self, target: str) -> None:
        raise NotImplementedError


@dataclass
class AppliedEvent:
    event: NemesisEvent
    t_actual: float
    error: str | None = None


class Nemesis:
    """Walk a timeline against live fleet ops on the soak clock."""

    def __init__(self, timeline: list[NemesisEvent], ops: FleetOps,
                 *, time_scale: float = 1.0):
        self.timeline = sorted(timeline, key=lambda e: e.t)
        self.ops = ops
        self.time_scale = float(time_scale)  # tests compress the clock
        self.applied: list[AppliedEvent] = []
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    def run(self) -> list[AppliedEvent]:
        t0 = time.monotonic()
        for event in self.timeline:
            wait = t0 + event.t * self.time_scale - time.monotonic()
            if wait > 0 and self._stop.wait(wait):
                break
            err = None
            try:
                fn = {"arm": lambda e: self.ops.arm(e.target, e.spec),
                      "clear": lambda e: self.ops.clear(e.target),
                      "kill": lambda e: self.ops.kill(e.target),
                      "drain": lambda e: self.ops.drain(e.target),
                      "undrain": lambda e: self.ops.undrain(e.target),
                      }[event.action]
                fn(event)
            except Exception as e:  # noqa: BLE001 — recorded, never fatal
                err = f"{type(e).__name__}: {e}"
            self.applied.append(AppliedEvent(
                event=event, t_actual=round(time.monotonic() - t0, 3),
                error=err))
        return self.applied

    def start(self) -> "Nemesis":
        self._thread = threading.Thread(target=self.run, daemon=True,
                                        name="nemesis")
        self._thread.start()
        return self

    def join(self, timeout: float | None = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    def stop(self) -> None:
        self._stop.set()
        self.join(5.0)
