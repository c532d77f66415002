"""Pure decision logic for the elastic fleet control plane.

The controller (fleet/controller.py) scrapes the fleet's published
signals every tick and asks :func:`decide` what to do about them. This
module is deliberately free of I/O, clocks, and randomness: a decision
is a pure function of (:class:`Snapshot`, :class:`PolicyState`,
:class:`PolicyConfig`) — the same inputs always produce the same
actions, which is what makes a byte-identical re-run of a recorded
decision trace possible and keeps every rule unit-testable as a table of
snapshots. The port's copy of ``lambdipy_tpu/fleet/policy.py``: the same
rules, so both packages render the same actions for the same snapshots.

Signals -> actuators:

- fleet-level per-class queue-wait P99 (the router's ``fleet.queue_wait``
  aggregate) vs the SLO target drives the LIFECYCLE actions:
  promote a mixed replica to the prefill class (drain + session re-ship
  is the safe migration primitive), spawn a new replica when there is
  nothing left to promote, and demote/retire on sustained idleness;
- per-replica ``batching.pipeline`` (``overlap_ratio``,
  ``fetch_block_s``/``wall_s``) drives the ``pipeline_depth`` knob;
- per-replica ``batching.spec`` acceptance EWMA drives ``spec_k``;
- the router's ``ship_ms_ewma`` drives ``--ship-window`` — one config
  serves both the loopback and the 66 ms-RTT transport.

Two dampers keep the loop from flapping:

- HYSTERESIS: the SLO comparison is a band, not a line. A breach only
  starts above ``slo * (1 + hysteresis)``, the all-clear only below
  ``slo * (1 - hysteresis)``, and a signal inside the band sustains
  NEITHER (both timers reset) — a boundary-straddling P99 produces no
  actions at all. Knob rules get the same treatment from their
  high/low band pairs.
- COOLDOWN: at most one lifecycle action per
  ``lifecycle_cooldown_s``, and each (target, knob) pair waits
  ``knob_cooldown_s`` between retunes, so the loop observes the effect
  of an action before stacking another on top of it.

Safety invariant (fuzz-tested): no decision sequence may drop the
routable decode-serving set (decode + mixed classes) below
``live_floor`` — promote and retire both refuse when the post-action
count would cross it.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field

PREFILL = "prefill"
DECODE = "decode"
MIXED = "mixed"

# action kinds, in the order ties are broken: one lifecycle action per
# tick, knob retunes ride along freely
PROMOTE = "promote"
DEMOTE = "demote"
SPAWN = "spawn"
RETIRE = "retire"
SET_KNOB = "set_knob"
LIFECYCLE = (PROMOTE, DEMOTE, SPAWN, RETIRE)

ROUTER = "router"  # the knob target that is the router, not a replica


@dataclass(frozen=True)
class ReplicaView:
    """What the policy may know about one replica. ``None`` for a
    signal means the replica does not publish it (no continuous
    engine, spec off, metrics scrape failed) — every rule skips a
    ``None`` rather than guessing."""

    name: str
    role: str = MIXED
    routable: bool = True
    managed: bool = False          # pool-owned: retire is possible
    outstanding: int = 0
    pipeline_depth: int | None = None
    overlap_ratio: float | None = None
    fetch_frac: float | None = None   # fetch_block_s / wall_s
    spec_k: int | None = None
    acceptance: float | None = None   # batching.spec acceptance_rate
    # draft tier (batching.spec.draft): the engine's current provider
    # default and the MODEL provider's acceptance EWMA — the signal the
    # demote rule watches for a collapsed self-draft head
    draft_mode: str | None = None
    draft_acceptance: float | None = None
    # long-context tier (batching.long_context): the re-online stall
    # share of engine wall and the decode-cursor prefetch hit rate
    # drive the max_logical_ctx retune; the compiled window bounds it
    # below, the boot-time cap bounds the restore above
    offload_stall_frac: float | None = None
    prefetch_hit_rate: float | None = None
    max_logical_ctx: int | None = None
    compiled_window: int | None = None
    boot_logical_ctx: int | None = None


@dataclass(frozen=True)
class Snapshot:
    """One tick's view of the fleet — everything :func:`decide` may
    read. ``t`` is the controller's clock (seconds since it started):
    the policy never reads a wall clock of its own, so replaying a
    recorded snapshot sequence replays the decisions bit-for-bit."""

    t: float
    replicas: tuple[ReplicaView, ...] = ()
    queue_wait_p99_ms: dict = field(default_factory=dict)  # class -> ms
    util: dict = field(default_factory=dict)               # class -> EWMA
    ship_ms_ewma: float = 0.0
    ships: int = 0
    ship_window: int = 0
    can_spawn: bool = False

    def to_dict(self) -> dict:
        return asdict(self)


@dataclass(frozen=True)
class PolicyConfig:
    """Operator surface for the control loop; every field has a
    serving-safe default. ``slo_p99_ms`` grades the ``slo_class``
    lane's fleet-level queue-wait P99."""

    slo_p99_ms: float = 250.0
    slo_class: str = "interactive"
    hysteresis: float = 0.25       # fractional band around the SLO
    sustain_s: float = 5.0         # breach/clear must hold this long
    lifecycle_cooldown_s: float = 30.0
    knob_cooldown_s: float = 10.0
    live_floor: int = 1            # min routable decode-serving replicas
    min_replicas: int = 1
    max_replicas: int = 8
    max_prefill: int = 2           # prefill replicas carved from the pool
    util_low: float = 0.25         # idle band for demote/retire
    # pipeline_depth: deepen while the host is visibly blocked fetching
    # (fetch stall share of engine wall) and the device is not already
    # fully overlapped; shrink when fetching costs ~nothing
    depth_min: int = 1
    depth_max: int = 4
    fetch_frac_high: float = 0.25
    fetch_frac_low: float = 0.02
    overlap_high: float = 0.95
    # spec_k: widen while drafts keep being accepted, narrow when the
    # verify work is mostly thrown away (k stays a pow-2 like the
    # engine's own bucketing; never turned on/off here — only resized)
    spec_k_min: int = 2
    spec_k_max: int = 8
    acceptance_high: float = 0.8
    acceptance_low: float = 0.4
    # draft_mode: demote the engine DEFAULT model -> lookup when the
    # model provider's acceptance EWMA collapses below the floor (the
    # per-row fallback already protects in-flight rows one by one; this
    # stops NEW rows from re-paying the discovery). Never promoted
    # lookup -> model here: that is an operator/boot decision.
    draft_acceptance_floor: float = 0.2
    # ship_window: more frames in flight when the transfer is slow
    # (ship latency EWMA prices the transport), fewer when it is ~free
    ship_window_min: int = 2
    ship_window_max: int = 16
    ship_ms_high: float = 50.0
    ship_ms_low: float = 5.0
    # max_logical_ctx: halve the admitted logical window while
    # re-online stalls eat a visible share of engine wall (the offload
    # tier is thrashing — rows slide more history than the host arena
    # can re-online in time), double it back toward the boot cap on
    # clean windows. The band (high/low) plus the per-knob cooldown is
    # the damping; the compiled window is the hard floor (below it the
    # runner cannot serve at all).
    stall_frac_high: float = 0.10
    stall_frac_low: float = 0.02
    prefetch_hit_floor: float = 0.5


@dataclass
class PolicyState:
    """The loop's memory, carried explicitly between ticks so
    :func:`decide` stays pure. ``breach_since``/``clear_since`` are the
    sustained-signal timers; the cooldown maps key on action family
    and ``target:knob``."""

    breach_since: float | None = None
    clear_since: float | None = None
    last_lifecycle_t: float | None = None
    last_knob_t: dict = field(default_factory=dict)  # "target:knob" -> t
    ticks: int = 0


@dataclass(frozen=True)
class Action:
    """One decision. ``kind`` is a lifecycle verb or ``set_knob``;
    ``target`` is a replica name (or ``router`` for the ship window);
    ``reason`` carries the signal that justified it, for the decision
    trace and the nemesis-visible event log."""

    kind: str
    target: str
    role: str | None = None        # spawn/promote/demote: the new class
    knob: str | None = None
    value: int | float | str | None = None   # str: e.g. draft_mode
    reason: str = ""

    def render(self) -> str:
        parts = [self.kind, self.target]
        if self.role is not None:
            parts.append(f"role={self.role}")
        if self.knob is not None:
            parts.append(f"{self.knob}={self.value}")
        if self.reason:
            parts.append(f"({self.reason})")
        return " ".join(parts)


def _next_pow2(n: int, *, up: bool) -> int:
    """The neighbouring power of two: knob steps stay on the engine's
    own pow-2 buckets so a retune never forces a fresh program shape
    outside the bucketed set."""
    n = max(1, int(n))
    p = 1
    while p < n:
        p *= 2
    if up:
        return p * 2 if p <= n else p
    return max(1, p // 2 if p >= n else p)


def _update_slo_timers(snap: Snapshot, state: PolicyState,
                       cfg: PolicyConfig) -> None:
    """Hysteresis core: the breach timer runs only above the high
    band, the clear timer only below the low band, and the band
    between them resets BOTH — straddling the boundary can never
    accumulate sustain in either direction."""
    p99 = snap.queue_wait_p99_ms.get(cfg.slo_class)
    high = cfg.slo_p99_ms * (1.0 + cfg.hysteresis)
    low = cfg.slo_p99_ms * (1.0 - cfg.hysteresis)
    if p99 is not None and p99 > high:
        if state.breach_since is None:
            state.breach_since = snap.t
        state.clear_since = None
    elif p99 is not None and p99 < low:
        if state.clear_since is None:
            state.clear_since = snap.t
        state.breach_since = None
    else:  # inside the band, or no samples yet: no evidence either way
        state.breach_since = None
        state.clear_since = None


def _sustained(since: float | None, now: float, need_s: float) -> bool:
    return since is not None and (now - since) >= need_s


def _knob_ready(state: PolicyState, key: str, now: float,
                cooldown_s: float) -> bool:
    last = state.last_knob_t.get(key)
    return last is None or (now - last) >= cooldown_s


def _lifecycle(snap: Snapshot, state: PolicyState,
               cfg: PolicyConfig) -> Action | None:
    """At most one lifecycle action per tick (and per cooldown
    window): capacity moves one replica at a time so the next
    snapshot shows the effect before the loop moves again."""
    if state.last_lifecycle_t is not None and \
            (snap.t - state.last_lifecycle_t) < cfg.lifecycle_cooldown_s:
        return None
    live = [r for r in snap.replicas if r.routable]
    serving = [r for r in live if r.role in (DECODE, MIXED)]
    prefill = [r for r in live if r.role == PREFILL]
    mixed = sorted((r for r in live if r.role == MIXED),
                   key=lambda r: (r.outstanding, r.name))
    p99 = snap.queue_wait_p99_ms.get(cfg.slo_class)

    if _sustained(state.breach_since, snap.t, cfg.sustain_s):
        reason = (f"{cfg.slo_class} p99 {p99:.0f}ms > slo "
                  f"{cfg.slo_p99_ms:.0f}ms for "
                  f"{snap.t - state.breach_since:.1f}s")
        # promote first: carving a prefill replica out of the mixed
        # pool is free capacity ISOLATION (the burstable phase moves
        # off the decode path) and reversible; spawning is neither
        if mixed and len(prefill) < cfg.max_prefill \
                and len(serving) - 1 >= cfg.live_floor:
            return Action(kind=PROMOTE, target=mixed[0].name,
                          role=PREFILL, reason=reason)
        if snap.can_spawn and len(live) < cfg.max_replicas:
            return Action(kind=SPAWN, target="", role=MIXED,
                          reason=reason)
        return None

    if _sustained(state.clear_since, snap.t, cfg.sustain_s):
        reason = (f"{cfg.slo_class} p99 "
                  f"{p99 if p99 is None else round(p99)}ms < slo "
                  f"{cfg.slo_p99_ms:.0f}ms for "
                  f"{snap.t - state.clear_since:.1f}s")
        # demote before retire: give capacity back to the decode path
        # first, only then shrink the fleet — and only when the class
        # being shed is demonstrably idle
        if prefill and snap.util.get(PREFILL, 1.0) < cfg.util_low:
            cand = sorted(prefill, key=lambda r: (r.outstanding, r.name))
            return Action(kind=DEMOTE, target=cand[0].name, role=MIXED,
                          reason=f"{reason}, prefill util "
                                 f"{snap.util.get(PREFILL, 0.0):.2f}")
        serving_util = max((snap.util.get(c, 0.0) for c in (DECODE,
                                                            MIXED)),
                           default=0.0)
        retirable = sorted(
            (r for r in serving if r.managed and r.outstanding == 0),
            key=lambda r: r.name)
        if retirable and serving_util < cfg.util_low \
                and len(live) > cfg.min_replicas \
                and len(serving) - 1 >= cfg.live_floor:
            return Action(kind=RETIRE, target=retirable[0].name,
                          reason=f"{reason}, serving util "
                                 f"{serving_util:.2f}")
    return None


def _knobs(snap: Snapshot, state: PolicyState,
           cfg: PolicyConfig) -> list[Action]:
    actions: list[Action] = []

    def emit(target: str, knob: str, value, reason: str) -> None:
        key = f"{target}:{knob}"
        if _knob_ready(state, key, snap.t, cfg.knob_cooldown_s):
            state.last_knob_t[key] = snap.t
            actions.append(Action(kind=SET_KNOB, target=target,
                                  knob=knob, value=value, reason=reason))

    for r in sorted(snap.replicas, key=lambda r: r.name):
        if not r.routable:
            continue
        # pipeline_depth from the pipeline's own overlap accounting
        if r.pipeline_depth is not None and r.fetch_frac is not None \
                and r.overlap_ratio is not None:
            if r.fetch_frac > cfg.fetch_frac_high \
                    and r.overlap_ratio < cfg.overlap_high \
                    and r.pipeline_depth < cfg.depth_max:
                emit(r.name, "pipeline_depth", r.pipeline_depth + 1,
                     f"fetch stall {r.fetch_frac:.2f} of wall, "
                     f"overlap {r.overlap_ratio:.2f}")
            elif r.fetch_frac < cfg.fetch_frac_low \
                    and r.pipeline_depth > cfg.depth_min:
                emit(r.name, "pipeline_depth", r.pipeline_depth - 1,
                     f"fetch stall {r.fetch_frac:.2f} of wall")
        # spec_k from the live acceptance EWMA (resize only: a replica
        # that stood spec down, or never ran it, publishes no k)
        if r.spec_k is not None and r.spec_k >= 2 \
                and r.acceptance is not None:
            if r.acceptance > cfg.acceptance_high \
                    and r.spec_k < cfg.spec_k_max:
                emit(r.name, "spec_k",
                     min(cfg.spec_k_max, _next_pow2(r.spec_k, up=True)),
                     f"acceptance {r.acceptance:.2f}")
            elif r.acceptance < cfg.acceptance_low \
                    and r.spec_k > cfg.spec_k_min:
                emit(r.name, "spec_k",
                     max(cfg.spec_k_min, _next_pow2(r.spec_k, up=False)),
                     f"acceptance {r.acceptance:.2f}")
        # draft_mode: demote the engine default model -> lookup when
        # the self-draft head's acceptance EWMA has collapsed — new
        # rows stop paying the draft forward at all, instead of each
        # rediscovering the collapse through its own per-row fallback
        if r.draft_mode in ("model", "aux") \
                and r.spec_k is not None and r.spec_k >= 2 \
                and r.draft_acceptance is not None \
                and r.draft_acceptance < cfg.draft_acceptance_floor:
            emit(r.name, "draft_mode", "lookup",
                 f"draft acceptance {r.draft_acceptance:.2f} < "
                 f"{cfg.draft_acceptance_floor:.2f}")
        # max_logical_ctx from the offload tier's own stall accounting:
        # step DOWN (halve, floored at the compiled window) while
        # re-online stalls are a sustained share of wall — or while the
        # prefetcher is missing most demands and stalls are already
        # above the clean band; step back UP (double, capped at the
        # boot value) once the window runs clean. The replica publishes
        # nothing without a live long-context runner — rule skipped.
        if r.max_logical_ctx is not None \
                and r.compiled_window is not None \
                and r.compiled_window > 0 \
                and r.offload_stall_frac is not None:
            boot = r.boot_logical_ctx or r.max_logical_ctx
            thrash = r.offload_stall_frac > cfg.stall_frac_high or (
                r.prefetch_hit_rate is not None
                and r.prefetch_hit_rate < cfg.prefetch_hit_floor
                and r.offload_stall_frac > cfg.stall_frac_low)
            if thrash and r.max_logical_ctx > r.compiled_window:
                hit = ("n/a" if r.prefetch_hit_rate is None
                       else f"{r.prefetch_hit_rate:.2f}")
                emit(r.name, "max_logical_ctx",
                     max(r.compiled_window, r.max_logical_ctx // 2),
                     f"reonline stall {r.offload_stall_frac:.3f} of "
                     f"wall, prefetch hit {hit}")
            elif r.offload_stall_frac < cfg.stall_frac_low \
                    and r.max_logical_ctx < boot:
                emit(r.name, "max_logical_ctx",
                     min(boot, r.max_logical_ctx * 2),
                     f"reonline stall {r.offload_stall_frac:.3f} of "
                     f"wall (clean)")
    # the router's ship window from the ship-latency EWMA — only once
    # real ships have priced the transport
    if snap.ships > 0 and snap.ship_window > 0:
        if snap.ship_ms_ewma > cfg.ship_ms_high \
                and snap.ship_window < cfg.ship_window_max:
            emit(ROUTER, "ship_window",
                 min(cfg.ship_window_max,
                     _next_pow2(snap.ship_window, up=True)),
                 f"ship {snap.ship_ms_ewma:.1f}ms ewma")
        elif snap.ship_ms_ewma < cfg.ship_ms_low \
                and snap.ship_window > cfg.ship_window_min:
            emit(ROUTER, "ship_window",
                 max(cfg.ship_window_min,
                     _next_pow2(snap.ship_window, up=False)),
                 f"ship {snap.ship_ms_ewma:.1f}ms ewma")
    return actions


def decide(snap: Snapshot, state: PolicyState,
           cfg: PolicyConfig) -> list[Action]:
    """One tick's decisions. Mutates ``state`` (the explicit memory the
    caller carries between ticks) and returns the actions in a
    deterministic order: the single lifecycle action (if any) first,
    then knob retunes sorted by target name."""
    state.ticks += 1
    _update_slo_timers(snap, state, cfg)
    actions: list[Action] = []
    act = _lifecycle(snap, state, cfg)
    if act is not None:
        state.last_lifecycle_t = snap.t
        # a lifecycle action resets the sustain timers: the next
        # breach/clear must re-accumulate against the NEW fleet shape
        state.breach_since = None
        state.clear_since = None
        actions.append(act)
    actions.extend(_knobs(snap, state, cfg))
    return actions
