"""The port's elastic control plane (``fleet/policy.py``,
``fleet/controller.py``), the twin of ``tests/test_fleet_controller.py``:
pure policy tables, hysteresis and cooldown damping, the live-floor fuzz
invariant, the controller's actuation against its dry run, the router's
fleet-level queue-wait fold and the port scheduler's per-ticket wait
stamp, all in process against a fake pool and router. Across the
packages: ``decide`` renders the same actions as JAX's over the seeded
snapshot sequences of ``test_decide_is_a_pure_function_of_its_inputs``,
and ``build_snapshot`` leaves the same fields None over a port replica's
``/metrics`` as over a JAX replica's of the same bundle.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest

from lambdipy_tpu_torch.fleet import (DECODE, MIXED, PREFILL, FleetController,
                                PolicyConfig, PolicyState, ReplicaView,
                                Snapshot, decide)
from lambdipy_tpu_torch.fleet.policy import (DEMOTE, PROMOTE, RETIRE, ROUTER,
                                       SET_KNOB, SPAWN)
from lambdipy_tpu_torch.fleet.router import FleetRouter
from lambdipy_tpu_torch.sched import SchedConfig, Scheduler


def _cfg(**kw) -> PolicyConfig:
    """A config tuned for one-tick tables: no sustain, no cooldown —
    each test re-adds exactly the damper it is about."""
    base = dict(slo_p99_ms=100.0, slo_class="interactive",
                hysteresis=0.25, sustain_s=0.0,
                lifecycle_cooldown_s=0.0, knob_cooldown_s=0.0,
                live_floor=1, min_replicas=1, max_replicas=8,
                max_prefill=2, util_low=0.25)
    base.update(kw)
    return PolicyConfig(**base)


def _snap(t, roles, *, p99=None, util=None, can_spawn=False,
          outstanding=None, managed=True, **kw) -> Snapshot:
    views = tuple(
        ReplicaView(name=f"r{i}", role=role, managed=managed,
                    outstanding=0 if outstanding is None
                    else outstanding[i])
        for i, role in enumerate(roles))
    return Snapshot(
        t=float(t), replicas=views,
        queue_wait_p99_ms={} if p99 is None else {"interactive": p99},
        util=util or {}, can_spawn=can_spawn, **kw)


# -- lifecycle decision tables ------------------------------------------------


@pytest.mark.parametrize("roles,p99,util,can_spawn,expect", [
    # sustained breach + a mixed replica to carve out -> promote
    ([MIXED, MIXED], 900.0, {}, False, (PROMOTE, "r0", PREFILL)),
    # breach but the prefill quota is full -> spawn is the fallback
    ([PREFILL, PREFILL, MIXED], 900.0, {}, True, (SPAWN, "", MIXED)),
    # breach, nothing mixed to promote, no spawner -> nothing
    ([DECODE, PREFILL], 900.0, {}, False, None),
    # breach but promoting the only decode-server would cross the
    # floor -> spawn instead
    ([MIXED, PREFILL], 900.0, {}, True, (SPAWN, "", MIXED)),
    # sustained all-clear + an idle prefill replica -> demote it back
    ([MIXED, PREFILL], 10.0, {PREFILL: 0.0}, False,
     (DEMOTE, "r1", MIXED)),
    # all-clear but the prefill class is busy -> keep it
    ([MIXED, PREFILL], 10.0, {PREFILL: 0.9, MIXED: 0.9}, False, None),
    # all-clear + an idle managed fleet above min -> retire one
    ([MIXED, MIXED], 10.0, {MIXED: 0.01}, False, (RETIRE, "r0", None)),
    # inside the hysteresis band: no evidence either way
    ([MIXED, MIXED], 100.0, {}, True, None),
    # no samples at all: never act on a guess
    ([MIXED, MIXED], None, {}, True, None),
])
def test_lifecycle_table(roles, p99, util, can_spawn, expect):
    cfg = _cfg(live_floor=1 if len(roles) > 1 else 0)
    state = PolicyState()
    acts = [a for a in decide(_snap(1.0, roles, p99=p99, util=util,
                                    can_spawn=can_spawn), state, cfg)
            if a.kind != SET_KNOB]
    if expect is None:
        assert acts == []
    else:
        kind, target, role = expect
        assert len(acts) == 1
        assert (acts[0].kind, acts[0].target, acts[0].role) == \
            (kind, target, role)


def test_promote_picks_least_outstanding_mixed():
    state = PolicyState()
    acts = decide(_snap(1.0, [MIXED, MIXED, MIXED], p99=900.0,
                        outstanding=[5, 0, 2]), state, _cfg())
    assert acts[0].kind == PROMOTE and acts[0].target == "r1"


def test_retire_skips_busy_and_unmanaged():
    # r0 busy, r1 idle-but-attached (unmanaged): nothing retirable
    state = PolicyState()
    views = (ReplicaView("r0", role=MIXED, managed=True, outstanding=3),
             ReplicaView("r1", role=MIXED, managed=False))
    snap = Snapshot(t=1.0, replicas=views,
                    queue_wait_p99_ms={"interactive": 10.0},
                    util={MIXED: 0.0})
    assert decide(snap, state, _cfg()) == []


def test_min_replicas_blocks_retire():
    state = PolicyState()
    acts = decide(_snap(1.0, [MIXED], p99=10.0, util={MIXED: 0.0}),
                  state, _cfg(min_replicas=1, live_floor=1))
    assert acts == []


# -- hysteresis + cooldown ----------------------------------------------------


def test_hysteresis_band_straddle_never_acts():
    """A P99 oscillating across the SLO line but inside the band
    sustains NEITHER timer: many ticks, zero actions."""
    cfg = _cfg(sustain_s=1.0)
    state = PolicyState()
    out = []
    for tick in range(60):
        p99 = 110.0 if tick % 2 else 90.0  # band is [75, 125]
        out += decide(_snap(tick * 0.5, [MIXED, MIXED], p99=p99,
                            can_spawn=True), state, cfg)
    assert [a for a in out if a.kind != SET_KNOB] == []


def test_hysteresis_flapping_signal_never_sustains():
    """Alternating hard-breach / hard-clear resets the opposite timer
    every tick, so with sustain > tick interval nothing ever fires."""
    cfg = _cfg(sustain_s=1.0)
    state = PolicyState()
    out = []
    for tick in range(60):
        p99 = 900.0 if tick % 2 else 5.0
        out += decide(_snap(tick * 0.5, [MIXED, MIXED], p99=p99,
                            util={PREFILL: 0.0, MIXED: 0.0},
                            can_spawn=True), state, cfg)
    assert [a for a in out if a.kind != SET_KNOB] == []


def test_sustain_then_promote():
    cfg = _cfg(sustain_s=1.0)
    state = PolicyState()
    assert decide(_snap(0.0, [MIXED, MIXED], p99=900.0), state,
                  cfg) == []
    assert decide(_snap(0.5, [MIXED, MIXED], p99=900.0), state,
                  cfg) == []
    acts = decide(_snap(1.0, [MIXED, MIXED], p99=900.0), state, cfg)
    assert [a.kind for a in acts] == [PROMOTE]


def test_lifecycle_cooldown_one_action_per_window():
    cfg = _cfg(lifecycle_cooldown_s=10.0)
    state = PolicyState()
    acts = decide(_snap(0.0, [MIXED, MIXED, MIXED], p99=900.0), state,
                  cfg)
    assert [a.kind for a in acts] == [PROMOTE]
    # the breach persists, but the cooldown holds the loop still
    for t in (1.0, 5.0, 9.9):
        assert decide(_snap(t, [PREFILL, MIXED, MIXED], p99=900.0),
                      state, cfg) == []
    # window over -> the next promote is allowed (quota has room)
    acts = decide(_snap(10.0, [PREFILL, MIXED, MIXED], p99=900.0),
                  state, cfg)
    assert [a.kind for a in acts] == [PROMOTE]


# -- knob rules ---------------------------------------------------------------


def _knob_views(**kw):
    base = dict(name="r0", role=MIXED, pipeline_depth=2,
                overlap_ratio=0.5, fetch_frac=0.1, spec_k=None,
                acceptance=None)
    base.update(kw)
    return (ReplicaView(**base),)


def _knob_snap(t, views, **kw):
    return Snapshot(t=float(t), replicas=views, **kw)


def test_depth_deepens_on_fetch_stall():
    acts = decide(_knob_snap(1.0, _knob_views(fetch_frac=0.4,
                                              overlap_ratio=0.6)),
                  PolicyState(), _cfg())
    assert [(a.kind, a.knob, a.value) for a in acts] == \
        [(SET_KNOB, "pipeline_depth", 3)]


def test_depth_shrinks_when_fetch_is_free():
    acts = decide(_knob_snap(1.0, _knob_views(fetch_frac=0.001)),
                  PolicyState(), _cfg())
    assert [(a.knob, a.value) for a in acts] == [("pipeline_depth", 1)]


def test_depth_holds_inside_band_and_at_bounds():
    # inside the band: nothing
    assert decide(_knob_snap(1.0, _knob_views(fetch_frac=0.1)),
                  PolicyState(), _cfg()) == []
    # stalled but already at depth_max: nothing
    assert decide(_knob_snap(1.0, _knob_views(fetch_frac=0.4,
                                              pipeline_depth=4)),
                  PolicyState(), _cfg()) == []
    # free but already at depth_min: nothing
    assert decide(_knob_snap(1.0, _knob_views(fetch_frac=0.001,
                                              pipeline_depth=1)),
                  PolicyState(), _cfg()) == []


def test_spec_k_resizes_on_acceptance_but_never_enables():
    # high acceptance widens to the next pow-2
    acts = decide(_knob_snap(1.0, _knob_views(spec_k=4,
                                              acceptance=0.95)),
                  PolicyState(), _cfg())
    assert [(a.knob, a.value) for a in acts] == [("spec_k", 8)]
    # low acceptance narrows
    acts = decide(_knob_snap(1.0, _knob_views(spec_k=4,
                                              acceptance=0.1)),
                  PolicyState(), _cfg())
    assert [(a.knob, a.value) for a in acts] == [("spec_k", 2)]
    # spec off (k unpublished or < 2): the policy never turns it on
    for k in (None, 0, 1):
        assert decide(_knob_snap(1.0, _knob_views(spec_k=k,
                                                  acceptance=0.95)),
                      PolicyState(), _cfg()) == []


def test_ship_window_tracks_ship_latency():
    cfg = _cfg()
    # slow transport -> widen (pow-2 step)
    acts = decide(Snapshot(t=1.0, ships=10, ship_ms_ewma=80.0,
                           ship_window=4), PolicyState(), cfg)
    assert [(a.target, a.knob, a.value) for a in acts] == \
        [(ROUTER, "ship_window", 8)]
    # near-free transport -> narrow
    acts = decide(Snapshot(t=1.0, ships=10, ship_ms_ewma=1.0,
                           ship_window=8), PolicyState(), cfg)
    assert [(a.value) for a in acts] == [4]
    # no ships yet: the EWMA has priced nothing — leave it alone
    assert decide(Snapshot(t=1.0, ships=0, ship_ms_ewma=80.0,
                           ship_window=4), PolicyState(), cfg) == []


def test_knob_cooldown_is_per_target_knob_pair():
    cfg = _cfg(knob_cooldown_s=5.0)
    state = PolicyState()
    views = (ReplicaView("a", pipeline_depth=2, overlap_ratio=0.5,
                         fetch_frac=0.4),
             ReplicaView("b", pipeline_depth=2, overlap_ratio=0.5,
                         fetch_frac=0.4))
    acts = decide(Snapshot(t=0.0, replicas=views), state, cfg)
    assert sorted(a.target for a in acts) == ["a", "b"]  # independent
    # both pairs are now cooling: an immediate re-tick emits nothing
    assert decide(Snapshot(t=1.0, replicas=views), state, cfg) == []
    # cooldown over: both retune again
    acts = decide(Snapshot(t=5.0, replicas=views), state, cfg)
    assert sorted(a.target for a in acts) == ["a", "b"]


# -- determinism + the live-floor fuzz ---------------------------------------


def test_decide_is_a_pure_function_of_its_inputs():
    """The same snapshot sequence through two fresh states renders the
    same actions byte-for-byte — the bench's replay gate, pure-level."""
    rng = np.random.default_rng(7)
    snaps = []
    for tick in range(40):
        roles = [MIXED, MIXED, PREFILL][:int(rng.integers(1, 4))]
        snaps.append(_snap(
            tick * 0.5, roles,
            p99=float(rng.choice([5.0, 100.0, 900.0])),
            util={PREFILL: float(rng.random()),
                  MIXED: float(rng.random())},
            can_spawn=bool(rng.integers(0, 2))))
    cfg = _cfg(sustain_s=1.0, lifecycle_cooldown_s=2.0)
    traces = []
    for _ in range(2):
        state = PolicyState()
        traces.append([a.render() for s in snaps
                       for a in decide(s, state, cfg)])
    assert traces[0] == traces[1]


@pytest.mark.parametrize("seed", range(5))
def test_fuzz_no_sequence_crosses_the_live_floor(seed):
    """Seeded random signals + faithfully applied decisions: the
    routable decode-serving count must never drop below live_floor, no
    matter what the sequence does."""
    rng = np.random.default_rng(seed)
    cfg = _cfg(sustain_s=1.0, lifecycle_cooldown_s=2.0,
               util_low=0.6, max_prefill=2, min_replicas=1,
               live_floor=1)
    state = PolicyState()
    fleet = [{"name": f"r{i}", "role": MIXED} for i in range(3)]
    spawned = 0
    for tick in range(300):
        views = tuple(
            ReplicaView(name=f["name"], role=f["role"], managed=True,
                        outstanding=int(rng.integers(0, 3)))
            for f in fleet)
        snap = Snapshot(
            t=tick * 0.7, replicas=views,
            queue_wait_p99_ms={
                "interactive": float(rng.choice([5.0, 900.0]))},
            util={PREFILL: float(rng.random()),
                  DECODE: float(rng.random()),
                  MIXED: float(rng.random())},
            can_spawn=bool(rng.integers(0, 2)))
        for a in decide(snap, state, cfg):
            if a.kind == PROMOTE:
                next(f for f in fleet
                     if f["name"] == a.target)["role"] = PREFILL
            elif a.kind == DEMOTE:
                next(f for f in fleet
                     if f["name"] == a.target)["role"] = MIXED
            elif a.kind == RETIRE:
                fleet = [f for f in fleet if f["name"] != a.target]
            elif a.kind == SPAWN:
                fleet.append({"name": f"s{spawned}", "role": MIXED})
                spawned += 1
        serving = [f for f in fleet
                   if f["role"] in (DECODE, MIXED)]
        assert len(serving) >= cfg.live_floor, \
            f"tick {tick}: fleet {fleet} crossed the floor"


# -- the controller against a fake pool/router --------------------------------


class FakeReplica:
    def __init__(self, name, role=MIXED, managed=True):
        self.name, self.role = name, role
        self.routable, self.managed = True, managed
        self.outstanding, self.state = 0, "ready"


class FakePool:
    def __init__(self, replicas):
        self._lock = threading.Lock()
        self.replicas = {r.name: r for r in replicas}
        self.calls: list = []

    def set_role(self, name, role, *, reship=True):
        self.calls.append(("set_role", name, role))
        self.replicas[name].role = role

    def retire(self, name, *, grace=10.0):
        self.calls.append(("retire", name))
        self.replicas[name].state = "stopped"


class FakeRouter:
    def __init__(self, pool, metrics):
        self.pool = pool
        self._metrics = metrics
        self.ship_window = 4

    def metrics(self):
        if isinstance(self._metrics, Exception):
            raise self._metrics
        return self._metrics() if callable(self._metrics) \
            else self._metrics


def _breach_metrics(p99=900.0):
    return {"fleet": {"queue_wait": {
        "interactive": {"count": 9, "p50_ms": p99 / 2,
                        "p99_ms": p99}}}}


def test_controller_tick_applies_promote_and_logs_the_event():
    pool = FakePool([FakeReplica("a"), FakeReplica("b")])
    router = FakeRouter(pool, _breach_metrics())
    ctrl = FleetController(router, config=_cfg(), interval_s=99)
    assert router.controller is ctrl  # /metrics registration
    acts = ctrl.tick()
    assert [a.kind for a in acts] == [PROMOTE]
    assert pool.calls == [("set_role", "a", PREFILL)]
    assert pool.replicas["a"].role == PREFILL
    rep = ctrl.report()
    assert rep["actions"] == {PROMOTE: 1} and rep["intents"] == {}
    # nemesis event grammar: "@T action target"
    assert len(ctrl.events) == 1
    ev = ctrl.events[0]["event"]
    assert ev.startswith("@") and " promote a" in ev
    assert rep["last_decision"]["applied"] is True


def test_controller_dry_run_logs_intents_but_touches_nothing():
    pool = FakePool([FakeReplica("a"), FakeReplica("b")])
    router = FakeRouter(pool, _breach_metrics())
    ctrl = FleetController(router, config=_cfg(), interval_s=99,
                           dry_run=True)
    acts = ctrl.tick()
    assert [a.kind for a in acts] == [PROMOTE]
    assert pool.calls == [] and ctrl.events == []
    assert pool.replicas["a"].role == MIXED
    rep = ctrl.report()
    assert rep["intents"] == {PROMOTE: 1} and rep["actions"] == {}
    assert rep["dry_run"] is True
    assert rep["last_decision"]["applied"] is False


def test_controller_scrape_failure_skips_the_tick():
    pool = FakePool([FakeReplica("a")])
    router = FakeRouter(pool, RuntimeError("replica down"))
    ctrl = FleetController(router, config=_cfg(), interval_s=99)
    assert ctrl.tick() == []
    rep = ctrl.report()
    assert rep["errors"] == 1 and rep["actions"] == {}
    assert pool.calls == []


def test_controller_sets_the_router_ship_window():
    pool = FakePool([FakeReplica("a")])
    router = FakeRouter(pool, {"fleet": {"disagg": {
        "ships": 10, "ship_ms_ewma": 80.0}}})
    ctrl = FleetController(router, config=_cfg(), interval_s=99)
    acts = ctrl.tick()
    assert [(a.kind, a.knob) for a in acts] == [(SET_KNOB,
                                                 "ship_window")]
    assert router.ship_window == 8
    assert ctrl.report()["targets"]["ship_window"] == 8


def test_controller_replay_is_byte_identical():
    pool = FakePool([FakeReplica("a"), FakeReplica("b"),
                     FakeReplica("c")])
    seq = iter([900.0, 900.0, 5.0, 5.0, 900.0])
    router = FakeRouter(pool,
                        lambda: _breach_metrics(next(seq, 50.0)))
    ctrl = FleetController(router, config=_cfg(sustain_s=0.0,
                                               lifecycle_cooldown_s=0.0),
                           interval_s=99)
    for _ in range(5):
        ctrl.tick()
    assert len(ctrl.decision_log) == 5
    assert ctrl.replay_decisions() is True


def test_controller_retired_replica_leaves_the_snapshot():
    pool = FakePool([FakeReplica("a"), FakeReplica("b")])
    pool.replicas["b"].state = "stopped"
    router = FakeRouter(pool, {"fleet": {}})
    ctrl = FleetController(router, config=_cfg(), interval_s=99)
    snap = ctrl.build_snapshot(router.metrics())
    assert [r.name for r in snap.replicas] == ["a"]


# -- the router's fleet-level queue-wait fold ---------------------------------


def test_fold_queue_wait_aggregates_per_class():
    per = {
        "r0": {"sched": {"queue_wait": {
            "interactive": {"count": 10, "p50_ms": 10.0,
                            "p99_ms": 100.0}}}},
        "r1": {"sched": {"queue_wait": {
            "interactive": {"count": 30, "p50_ms": 20.0,
                            "p99_ms": 50.0},
            "batch": {"count": 4, "p50_ms": 5.0, "p99_ms": 9.0}}}},
        "r2": {"error": "unreachable"},
    }
    out = FleetRouter._fold_queue_wait(per)
    # counts sum; p50 is the count-weighted mean; p99 is the max
    # (a sound upper bound on the union's p99)
    assert out["interactive"] == {"count": 40, "p50_ms": 17.5,
                                  "p99_ms": 100.0}
    assert out["batch"] == {"count": 4, "p50_ms": 5.0, "p99_ms": 9.0}
    assert FleetRouter._fold_queue_wait({}) == {}


# -- the scheduler's per-ticket wait stamp ------------------------------------


def test_scheduler_stamps_wait_ms_at_grant():
    s = Scheduler(SchedConfig(max_concurrency=1))
    t = s.admit()
    assert s.wait_turn(t, timeout=5)
    assert t.wait_ms is not None and t.wait_ms >= 0.0
    s.finish(t)
    # a queued ticket's stamp reflects its actual wait, not admission
    t1 = s.admit()
    assert s.wait_turn(t1, timeout=5)
    t2 = s.admit()
    assert t2.wait_ms is None  # not yet granted
    s.finish(t1)
    assert s.wait_turn(t2, timeout=5)
    assert t2.wait_ms is not None and t2.wait_ms >= 0.0
    s.finish(t2)


# -- the max_logical_ctx retune (offload-stall damped rule) -------------------


def _lc_views(**kw):
    base = dict(name="r0", role=MIXED, max_logical_ctx=2048,
                compiled_window=128, boot_logical_ctx=2048,
                offload_stall_frac=0.0, prefetch_hit_rate=0.9)
    base.update(kw)
    return (ReplicaView(**base),)


def test_logical_ctx_halves_on_sustained_stalls():
    acts = decide(_knob_snap(1.0, _lc_views(offload_stall_frac=0.2)),
                  PolicyState(), _cfg())
    assert [(a.kind, a.knob, a.value) for a in acts] == \
        [(SET_KNOB, "max_logical_ctx", 1024)]
    assert "stall" in acts[0].reason


def test_logical_ctx_never_steps_below_the_compiled_window():
    # halving 200 would land at 100 — the floor is the window (128)
    acts = decide(_knob_snap(1.0, _lc_views(max_logical_ctx=200,
                                            offload_stall_frac=0.5)),
                  PolicyState(), _cfg())
    assert [(a.knob, a.value) for a in acts] == [("max_logical_ctx", 128)]
    # already at the window: stalls or not, nothing to shrink
    assert decide(_knob_snap(1.0, _lc_views(max_logical_ctx=128,
                                            offload_stall_frac=0.5)),
                  PolicyState(), _cfg()) == []


def test_logical_ctx_low_prefetch_corroborates_mid_band_stalls():
    # stalls inside the band alone: hold
    assert decide(_knob_snap(1.0, _lc_views(offload_stall_frac=0.05)),
                  PolicyState(), _cfg()) == []
    # same stalls + a collapsed prefetch hit rate: step down
    acts = decide(_knob_snap(1.0, _lc_views(offload_stall_frac=0.05,
                                            prefetch_hit_rate=0.2)),
                  PolicyState(), _cfg())
    assert [(a.knob, a.value) for a in acts] == [("max_logical_ctx",
                                                  1024)]
    # clean stalls: a bad hit rate alone never shrinks the window
    assert decide(_knob_snap(1.0, _lc_views(offload_stall_frac=0.01,
                                            prefetch_hit_rate=0.2)),
                  PolicyState(), _cfg()) == []


def test_logical_ctx_restores_on_clean_windows_capped_at_boot():
    # clean window, previously stepped down: double back up
    acts = decide(_knob_snap(1.0, _lc_views(max_logical_ctx=512,
                                            boot_logical_ctx=2048)),
                  PolicyState(), _cfg())
    assert [(a.knob, a.value) for a in acts] == [("max_logical_ctx",
                                                  1024)]
    # doubling past boot clamps to boot
    acts = decide(_knob_snap(1.0, _lc_views(max_logical_ctx=1536,
                                            boot_logical_ctx=2048)),
                  PolicyState(), _cfg())
    assert [(a.knob, a.value) for a in acts] == [("max_logical_ctx",
                                                  2048)]
    # at boot already: a clean window is the steady state, not a signal
    assert decide(_knob_snap(1.0, _lc_views()), PolicyState(),
                  _cfg()) == []


def test_logical_ctx_skips_unpublished_signals():
    # no long-context block on the replica: every field is None
    for missing in ("offload_stall_frac", "max_logical_ctx",
                    "compiled_window"):
        kw = {"offload_stall_frac": 0.5, missing: None}
        assert decide(_knob_snap(1.0, _lc_views(**kw)),
                      PolicyState(), _cfg()) == []


def test_logical_ctx_cooldown_damps_the_rule():
    cfg = _cfg(knob_cooldown_s=5.0)
    state = PolicyState()
    views = _lc_views(offload_stall_frac=0.5)
    acts = decide(_knob_snap(0.0, views), state, cfg)
    assert [(a.knob, a.value) for a in acts] == [("max_logical_ctx",
                                                  1024)]
    # still stalling one tick later: the cooldown holds the knob
    assert decide(_knob_snap(1.0, views), state, cfg) == []
    # cooldown over: the next halving lands
    acts = decide(_knob_snap(5.0, views), state, cfg)
    assert [(a.knob, a.value) for a in acts] == [("max_logical_ctx",
                                                  1024)]


def _lc_metrics(stall_s, *, wall_s=10.0, mlc=2048, hit=0.9):
    return {"replicas": {"a": {"handler": {"batching": {
        "pipeline": {"wall_s": wall_s},
        "long_context": {"stall_s": stall_s, "prefetch_hit_rate": hit,
                         "max_logical_ctx": mlc, "window": 128,
                         "boot_logical_ctx": 2048}}}}}}


def test_controller_retunes_logical_ctx_over_debug_knobs(monkeypatch):
    posts = []

    def fake_post(url, payload, timeout=None):
        posts.append((url, payload))
        return {"ok": True}

    monkeypatch.setattr("lambdipy_tpu_torch.fleet.controller._http_json",
                        fake_post)
    pool = FakePool([FakeReplica("a")])
    pool.replicas["a"].url = "http://a:1"
    seq = iter([_lc_metrics(3.0),              # 30% stall -> halve
                _lc_metrics(3.0, mlc=1024),    # still hot -> halve again
                _lc_metrics(0.1, mlc=512),     # clean -> restore
                _lc_metrics(0.1, mlc=1024)])   # clean -> restore
    router = FakeRouter(pool, lambda: next(seq))
    ctrl = FleetController(router, config=_cfg(), interval_s=99)
    for _ in range(4):
        ctrl.tick()
    assert posts == [("http://a:1/v1/debug/knobs",
                      {"max_logical_ctx": v})
                     for v in (1024, 512, 1024, 2048)]
    # the recorded decisions replay byte-for-byte
    assert len(ctrl.decision_log) == 4
    assert ctrl.replay_decisions() is True


# -- across the packages: decide ---------------------------------------------


def _as_jax(snap: Snapshot, cfg: PolicyConfig):
    """The same snapshot and config as the JAX package's dataclasses."""
    import dataclasses

    from lambdipy_tpu.fleet import policy as jpolicy

    fields = {f.name: getattr(snap, f.name)
              for f in dataclasses.fields(snap)}
    fields["replicas"] = tuple(jpolicy.ReplicaView(**dataclasses.asdict(v))
                               for v in snap.replicas)
    return (jpolicy.Snapshot(**fields),
            jpolicy.PolicyConfig(**dataclasses.asdict(cfg)))


def _seeded_snaps(seed: int, n: int = 40) -> list:
    """``test_decide_is_a_pure_function_of_its_inputs``'s sequence, with
    per-replica knob signals drawn too, so the knob rules fire."""
    rng = np.random.default_rng(seed)
    snaps = []
    for tick in range(n):
        roles = [MIXED, MIXED, PREFILL][:int(rng.integers(1, 4))]
        views = tuple(
            ReplicaView(name=f"r{i}", role=role, managed=True,
                        outstanding=int(rng.integers(0, 3)),
                        pipeline_depth=int(rng.choice([1, 2, 4])),
                        overlap_ratio=float(rng.random()),
                        fetch_frac=float(rng.choice([0.0005, 0.1, 0.4])),
                        spec_k=int(rng.choice([0, 4, 8])),
                        acceptance=float(rng.random()))
            for i, role in enumerate(roles))
        snaps.append(Snapshot(
            t=tick * 0.5, replicas=views,
            queue_wait_p99_ms={"interactive":
                               float(rng.choice([5.0, 100.0, 900.0]))},
            util={PREFILL: float(rng.random()), MIXED: float(rng.random())},
            ship_ms_ewma=float(rng.choice([0.0, 40.0, 4000.0])),
            ships=int(rng.integers(0, 5)), ship_window=4,
            can_spawn=bool(rng.integers(0, 2))))
    return snaps


@pytest.mark.parametrize("seed", [7, 11, 23])
def test_decide_renders_jaxs_actions_over_seeded_sequences(seed):
    """The port's ``decide`` over a seeded snapshot sequence, from a fresh
    state, renders JAX's actions tick for tick (the pure-function test's
    sequence, and one with knob signals)."""
    from lambdipy_tpu.fleet import policy as jpolicy

    cfg = _cfg(sustain_s=1.0, lifecycle_cooldown_s=2.0)
    for snaps in (_seeded_snaps(seed), _purity_snaps(seed)):
        port_state, jax_state = PolicyState(), jpolicy.PolicyState()
        port, jax = [], []
        for snap in snaps:
            jsnap, jcfg = _as_jax(snap, cfg)
            port.append([a.render() for a in decide(snap, port_state, cfg)])
            jax.append([a.render()
                        for a in jpolicy.decide(jsnap, jax_state, jcfg)])
        assert port == jax
        assert any(port)


def _purity_snaps(seed: int) -> list:
    """Exactly ``test_decide_is_a_pure_function_of_its_inputs``'s
    snapshots at ``seed``."""
    rng = np.random.default_rng(seed)
    snaps = []
    for tick in range(40):
        roles = [MIXED, MIXED, PREFILL][:int(rng.integers(1, 4))]
        snaps.append(_snap(
            tick * 0.5, roles,
            p99=float(rng.choice([5.0, 100.0, 900.0])),
            util={PREFILL: float(rng.random()),
                  MIXED: float(rng.random())},
            can_spawn=bool(rng.integers(0, 2))))
    return snaps


def test_a_port_replica_publishes_every_snapshot_field():
    """Each signal ``build_snapshot`` reads is published by a port replica
    whose feature is on (the continuous paged engine with model drafts
    and the long-context tier): no field of the snapshot stays None, so
    the knob, ``draft_mode`` and ``max_logical_ctx`` rules can fire on a
    port fleet as on JAX's."""
    import dataclasses
    import json
    import urllib.request
    from types import SimpleNamespace

    from lambdipy_tpu_torch.fleet import ReplicaPool
    from lambdipy_tpu_torch.runtime.handlers import (HandlerContext,
                                                     generate_handler)
    from lambdipy_tpu_torch.runtime.server import BundleServer

    state = generate_handler(
        {"model": "llama-tiny",
         "extra": {"batch_mode": "continuous", "kv_paged": "1",
                   "max_logical_ctx": "512", "spec_k": "4",
                   "draft_mode": "model", "draft_exit": "1",
                   "warm_group_prefill": "0"}},
        HandlerContext(device="cpu"))
    srv = BundleServer(state, port=0).start_background()
    try:
        for n in (29, 299):  # a row in the window and one past it
            req = urllib.request.Request(
                srv.url + "/invoke",
                data=json.dumps({"tokens": list(range(1, n + 1)),
                                 "max_new_tokens": 8}).encode(),
                headers={"Content-Type": "application/json"})
            assert json.loads(urllib.request.urlopen(req).read())["ok"]
        metrics = json.loads(urllib.request.urlopen(
            srv.url + "/metrics").read())
    finally:
        srv.stop()
    pool = ReplicaPool()
    pool.attach("r0", "http://127.0.0.1:9")
    router = SimpleNamespace(pool=pool, ship_window=4, controller=None)
    view = FleetController(router, dry_run=True).build_snapshot(
        {"replicas": {"r0": metrics}}).replicas[0]
    assert [f.name for f in dataclasses.fields(view)
            if getattr(view, f.name) is None] == []
    assert view.draft_mode == "model" and view.spec_k == 4
    assert view.max_logical_ctx == 512 and view.compiled_window == 128
