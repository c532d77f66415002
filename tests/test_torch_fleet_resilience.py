"""The port's fleet-boundary resilience, the twin of
``tests/test_fleet_resilience.py``: circuit breakers, the fleet-wide
retry budget, the router's spill queue, the router's network fault sites
(``LAMBDIPY_FLEET_FAULT``), first-class attached replicas and the phase
split's fallbacks, on the JAX tests' scriptable stub replicas (no
model). Then the fleet cases of ``tests/test_faults.py`` (a wedged
replica ejected at probe speed and routed around), and across the
packages: the port's breakers and retry budget reach JAX's states under
the same event sequence on a fake clock."""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from lambdipy_tpu_torch.fleet import (
    EJECTED,
    READY,
    CircuitBreaker,
    FleetError,
    FleetRouter,
    ReplicaPool,
    RetryBudget,
    SpillQueue,
    affinity,
)
from lambdipy_tpu_torch.fleet.breaker import CLOSED, HALF_OPEN, OPEN
from lambdipy_tpu_torch.runtime.faults import FaultPlan
from lambdipy_tpu_torch.sched.admission import Shed

from test_fleet import StubReplica, _get, _post


@pytest.fixture()
def stub_pair():
    s0, s1 = StubReplica("r0"), StubReplica("r1")
    pool = ReplicaPool(probe_interval=0.1, fail_threshold=1,
                      readmit_passes=2, probe_timeout=2.0)
    pool.attach("r0", s0.url)
    pool.attach("r1", s1.url)
    yield s0, s1, pool
    pool.close()
    for s in (s0, s1):
        try:
            s.kill()
        except Exception:
            pass


# -- circuit breaker state machine (pure, fake clock) ------------------------


def test_breaker_transitions_closed_open_half_open_closed():
    t = [100.0]
    b = CircuitBreaker(fail_threshold=3, open_s=1.0, clock=lambda: t[0])
    assert b.state == CLOSED and not b.blocked()
    b.record_failure()
    b.record_failure()
    assert b.state == CLOSED  # under threshold
    b.record_failure()
    assert b.state == OPEN and b.blocked() and b.opens == 1
    assert b.last_cause == "consecutive_failures"
    # the open interval must elapse before a probe is allowed
    t[0] += 0.5
    assert b.blocked()
    t[0] += 0.6
    assert not b.blocked()
    b.begin_attempt()  # the router picked it: half-open probe in flight
    assert b.state == HALF_OPEN and b.half_open_probes == 1
    assert b.blocked()  # a second pick must not double-probe
    b.record_success()
    assert b.state == CLOSED and b.closes == 1 and not b.blocked()
    # a success resets the consecutive count entirely
    b.record_failure()
    b.record_success()
    b.record_failure()
    b.record_failure()
    assert b.state == CLOSED


def test_breaker_half_open_failure_reopens_with_backoff():
    t = [0.0]
    b = CircuitBreaker(fail_threshold=1, open_s=1.0, max_open_s=3.0,
                       clock=lambda: t[0])
    b.record_failure()
    assert b.state == OPEN and b.open_until == pytest.approx(1.0)
    t[0] = 1.5
    b.begin_attempt()
    b.record_failure()  # the probe failed: reopen, interval doubled
    assert b.state == OPEN and b.opens == 2
    assert b.open_until == pytest.approx(1.5 + 2.0)
    assert b.last_cause == "half_open_probe_failed"
    t[0] = 4.0
    b.begin_attempt()
    b.record_failure()  # doubled again but capped at max_open_s
    assert b.open_until == pytest.approx(4.0 + 3.0)
    t[0] = 8.0
    b.begin_attempt()
    b.record_success()  # close resets the backoff ladder
    b.record_failure()
    assert b.open_until == pytest.approx(8.0 + 1.0)


def test_breaker_abandoned_half_open_probe_reclaims_after_grace():
    """Some router paths never resolve their forward (a 504
    busy-not-dead timeout, a streamed client that went away): an
    unresolved half-open probe must not blackhole the replica forever —
    after ``probe_grace_s`` the slot can be re-claimed, and the next
    resolved probe decides."""
    t = [0.0]
    b = CircuitBreaker(fail_threshold=1, open_s=1.0, probe_grace_s=5.0,
                       clock=lambda: t[0])
    b.record_failure()
    t[0] = 1.5
    b.begin_attempt()  # probe 1 claimed... and never resolved
    assert b.state == HALF_OPEN and b.blocked()
    t[0] = 4.0
    assert b.blocked()  # within grace: still one probe in flight
    t[0] = 7.0          # past 1.5 + 5.0: probe 1 is abandoned
    assert not b.blocked()
    b.begin_attempt()
    assert b.half_open_probes == 2
    assert b.blocked()  # probe 2 now owns the slot
    b.record_success()
    assert b.state == CLOSED and not b.blocked()


def test_breaker_latency_outlier_opens():
    t = [0.0]
    b = CircuitBreaker(fail_threshold=5, open_s=1.0, outlier_ms=100.0,
                       outlier_threshold=3, clock=lambda: t[0])
    for _ in range(2):
        b.record_success(latency_ms=500.0)
    assert b.state == CLOSED
    b.record_success(latency_ms=50.0)  # a fast answer resets the streak
    b.record_success(latency_ms=500.0)
    b.record_success(latency_ms=500.0)
    assert b.state == CLOSED
    b.record_success(latency_ms=500.0)
    assert b.state == OPEN and b.last_cause == "latency_outlier"


def test_retry_budget_ratio_floor_and_window():
    t = [0.0]
    rb = RetryBudget(ratio=0.5, min_retries=1, window_s=10.0,
                     clock=lambda: t[0])
    # floor: with zero primaries, exactly min_retries retries pass
    assert rb.allow_retry()
    assert not rb.allow_retry()
    assert rb.denied == 1
    # primaries buy more retries at the ratio
    for _ in range(4):
        rb.record_request()
    assert rb.allow_retry()      # budget = 1 + 0.5*4 = 3 > 1 used
    assert rb.allow_retry()
    assert not rb.allow_retry()  # 3 >= 3
    # the window slides: old entries stop counting against the budget
    t[0] = 11.0
    rb.record_request()
    assert rb.allow_retry()
    rep = rb.report()
    assert rep["window_primaries"] == 1 and rep["window_retries"] == 1
    assert rep["denied"] == 2


def test_retry_budget_disabled_ratio_zero():
    rb = RetryBudget(ratio=0.0, min_retries=0)
    assert all(rb.allow_retry() for _ in range(20))
    assert rb.denied == 0


# -- spill queue (pure) ------------------------------------------------------


def test_spill_queue_grants_in_policy_order_when_ready():
    ready = [False]
    q = SpillQueue(lambda: ready[0], capacity=8, max_wait_s=5.0,
                   poll_s=0.01, max_inflight=1).start()
    order = []

    def park(cls):
        out = q.park(cls=cls)
        assert not isinstance(out, Shed)
        order.append(cls)
        time.sleep(0.05)
        q.done(out)

    try:
        threads = [threading.Thread(target=park, args=("background",)),
                   threading.Thread(target=park, args=("interactive",))]
        threads[0].start()
        time.sleep(0.1)  # background parks first...
        threads[1].start()
        time.sleep(0.1)
        assert q.depth() == 2 and order == []  # nothing ready: all parked
        ready[0] = True
        for th in threads:
            th.join(timeout=5)
        # ...but the priority policy drains interactive first
        assert order == ["interactive", "background"]
        rep = q.report()
        assert rep["parked"] == 2 and rep["granted"] == 2
        assert rep["wait"]["count"] == 2
    finally:
        q.close()


def test_spill_queue_overflow_and_deadline_shed_with_estimate():
    q = SpillQueue(lambda: False, capacity=1, max_wait_s=0.3,
                   poll_s=0.01).start()
    try:
        results = []
        th = threading.Thread(
            target=lambda: results.append(q.park(cls="interactive")))
        th.start()
        time.sleep(0.1)
        # capacity 1 is taken: the second park overflows IMMEDIATELY,
        # priced with the queue's wait estimate
        out = q.park(cls="interactive")
        assert isinstance(out, Shed) and out.reason == "spill_overflow"
        assert out.code == 503 and out.retry_after_s > 0
        th.join(timeout=5)
        # the parked one expired at the deadline (never ready)
        assert isinstance(results[0], Shed)
        assert results[0].reason == "spill_deadline"
        assert results[0].retry_after_s > 0
        rep = q.report()
        assert rep["expired"] == 1 and rep["overflow"] == 1
        assert rep["depth"] == 0  # expired tickets leave the queue
    finally:
        q.close()


def test_spill_queue_respects_caller_wait_bound():
    q = SpillQueue(lambda: False, capacity=4, max_wait_s=30.0,
                   poll_s=0.01).start()
    try:
        t0 = time.monotonic()
        out = q.park(cls="interactive", wait_s=0.2)
        assert isinstance(out, Shed) and out.reason == "spill_deadline"
        assert time.monotonic() - t0 < 2.0
        assert isinstance(q.park(cls="interactive", wait_s=-1.0), Shed)
    finally:
        q.close()


# -- router: spill absorption ------------------------------------------------


def test_router_spill_absorbs_transient_fleet_wide_shed(stub_pair):
    """The tentpole claim: a transient fleet-wide shed burst completes
    with ZERO client-visible 429/503s when queue capacity suffices —
    the router parks the burst and drains it on recovery."""
    s0, s1, pool = stub_pair
    pool.probe_all()
    s0.cfg["shed"] = s1.cfg["shed"] = True
    router = FleetRouter(pool, affinity_on=False, max_retries=1,
                         backoff_s=0.01, backoff_cap_s=0.05,
                         spill_cap=16, spill_max_wait_s=10.0)
    router.start_background()
    base = f"http://127.0.0.1:{router.port}"
    results, errors = [], []

    def one(i):
        try:
            results.append(_post(f"{base}/invoke", {"tokens": [i]}))
        except Exception as e:  # noqa: BLE001 — collected for assert
            errors.append(repr(e))

    try:
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.4)  # the burst is parked, not shed
        assert not errors and not results
        s0.cfg["shed"] = s1.cfg["shed"] = False  # fleet recovers
        for t in threads:
            t.join(timeout=15)
        assert not errors, f"client-visible errors: {errors[:3]}"
        assert len(results) == 4 and all(r["ok"] for r in results)
        rep = router.stats.report()
        assert rep["spill"]["spilled"] == 4
        assert rep["spill"]["drained"] >= 4
        assert rep["spill"]["expired"] == 0
        assert router.metrics()["router"]["spill"]["wait"]["count"] >= 4
    finally:
        router.stop()


def test_router_spill_deadline_sheds_with_wait_estimate(stub_pair):
    """Satellite: when the spill queue itself sheds, the response
    carries the queue's OWN wait estimate in the same wire format the
    server-side shed uses (integer Retry-After header + exact float
    retry_after_s in the body) — the shape the router's own
    ``_retry_after_s`` parses."""
    s0, s1, pool = stub_pair
    pool.probe_all()
    s0.cfg["shed"] = s1.cfg["shed"] = True  # and they never recover
    router = FleetRouter(pool, affinity_on=False, max_retries=1,
                         backoff_s=0.01, backoff_cap_s=0.05,
                         spill_cap=8, spill_max_wait_s=0.5)
    router.start_background()
    base = f"http://127.0.0.1:{router.port}"
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{base}/invoke", {"tokens": [1]})
        assert e.value.code == 503
        assert int(e.value.headers["Retry-After"]) >= 1
        body = json.loads(e.value.read())
        assert body["shed"] == "spill_deadline"
        assert body["retry_after_s"] > 0
        # the relayed format round-trips through the router's parser
        assert FleetRouter._retry_after_s(
            503, {}, json.dumps(body).encode()) == body["retry_after_s"]
        assert router.stats.report()["spill"]["expired"] == 1

        # the OpenAI surface sheds in the OpenAI error shape
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{base}/v1/completions", {"prompt": [1]})
        err = json.loads(e.value.read())["error"]
        assert err["type"] == "overloaded_error"
        assert err["retry_after_s"] > 0
    finally:
        router.stop()


def test_router_spill_overflow_sheds_excess(stub_pair):
    """With the whole fleet EJECTED (nothing routable, nothing to grant
    onto), a burst past the queue capacity overflows immediately —
    bounded queue, explicit sheds — while the one parked request drains
    once a replica is revived and readmitted."""
    s0, s1, pool = stub_pair
    pool.start()
    port0 = s0.port
    s0.kill()
    s1.kill()
    pool.probe_all()
    assert all(r.state == EJECTED for r in pool.replicas.values())
    router = FleetRouter(pool, affinity_on=False, max_retries=0,
                         backoff_s=0.01, spill_cap=1,
                         spill_max_wait_s=15.0)
    router.start_background()
    base = f"http://127.0.0.1:{router.port}"
    outcomes = []
    s0b = None

    def one(i):
        try:
            outcomes.append(("ok", _post(f"{base}/invoke", {"tokens": [i]})))
        except urllib.error.HTTPError as e:
            outcomes.append(("shed", json.loads(e.read())))

    try:
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        time.sleep(0.5)  # 1 parked; the others must have overflowed
        overflowed = [o for kind, o in outcomes if kind == "shed"]
        assert len(overflowed) == 2
        assert all(o["shed"] == "spill_overflow" and o["retry_after_s"] > 0
                   for o in overflowed)
        s0b = StubReplica("r0", port=port0)  # revive -> readmit -> drain
        for t in threads:
            t.join(timeout=15)
        served = [o for kind, o in outcomes if kind == "ok"]
        assert len(served) == 1 and served[0]["ok"]
        rep = router.stats.report()["spill"]
        assert rep["overflow"] == 2 and rep["spilled"] == 3
        assert rep["drained"] >= 1
    finally:
        router.stop()
        if s0b is not None:
            s0b.kill()


def test_router_streams_never_spill(stub_pair):
    """A parked stream would hold a socket open with nothing honest to
    send: streamed requests relay the fleet-wide shed immediately."""
    s0, s1, pool = stub_pair
    pool.probe_all()
    s0.cfg["shed"] = s1.cfg["shed"] = True
    router = FleetRouter(pool, affinity_on=False, max_retries=1,
                         backoff_s=0.01, backoff_cap_s=0.05,
                         spill_cap=8, spill_max_wait_s=30.0)
    router.start_background()
    base = f"http://127.0.0.1:{router.port}"
    try:
        t0 = time.monotonic()
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{base}/invoke", {"tokens": [1], "stream": True})
        assert e.value.code == 503
        assert time.monotonic() - t0 < 5.0  # did not park for 30 s
        assert router.stats.report()["spill"]["spilled"] == 0
    finally:
        router.stop()


# -- router: retry budget ----------------------------------------------------


def test_retry_budget_exhaustion_under_fleet_wide_503(stub_pair):
    """Satellite: under a fleet-wide 503 storm, the budget stops the
    router from re-sending — each shed relays after ONE forward instead
    of max_retries+1, and the denial is counted."""
    s0, s1, pool = stub_pair
    pool.probe_all()
    s0.cfg["shed"] = s1.cfg["shed"] = True
    router = FleetRouter(pool, affinity_on=False, max_retries=3,
                         backoff_s=0.01, backoff_cap_s=0.05,
                         retry_budget=0.01, retry_budget_min=0)
    router.start_background()
    base = f"http://127.0.0.1:{router.port}"
    try:
        for i in range(3):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(f"{base}/invoke", {"tokens": [i]})
            assert e.value.code == 503  # the honest relayed shed
        rep = router.stats.report()
        assert rep["retry_budget_denied"] >= 3
        # the tiny ratio admits exactly one retry in the window; every
        # further re-send is refused — the fleet saw 4 forwards where
        # an unbudgeted max_retries=3 loop would have sent 12
        assert rep["retries"] == 1
        assert len(s0.bodies) + len(s1.bodies) == 4
        assert router.metrics()["router"]["retry_budget"]["denied"] >= 3
    finally:
        router.stop()


# -- router: circuit breakers ------------------------------------------------


def test_breaker_opens_on_dead_replica_and_half_open_readmits(stub_pair):
    s0, s1, pool = stub_pair
    pool.probe_all()
    # fail_threshold high: the POOL never ejects, isolating the breaker
    pool.fail_threshold = 100
    router = FleetRouter(pool, affinity_on=False, max_retries=2,
                         backoff_s=0.01, backoff_cap_s=0.05,
                         breaker_fails=2, breaker_open_s=0.4)
    router.start_background()
    base = f"http://127.0.0.1:{router.port}"
    try:
        port = s0.port
        s0.kill()
        # every request succeeds via failover; after 2 connect failures
        # the breaker opens and r0 stops being offered at all
        for i in range(6):
            assert _post(f"{base}/invoke", {"tokens": [i]})["ok"]
        b = router.breakers["r0"]
        assert b.state == OPEN and b.opens >= 1
        failovers_at_open = router.stats.report()["failovers"]
        for i in range(4):
            assert _post(f"{base}/invoke",
                         {"tokens": [i]})["replica"] == "r1"
        # open breaker = no further connection attempts at the corpse
        assert router.stats.report()["failovers"] == failovers_at_open

        # revive on the same port: after open_s the next pick half-open
        # probes it, success closes, and traffic returns
        s0b = StubReplica("r0", port=port)
        time.sleep(0.5)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and s0b.invokes == 0:
            _post(f"{base}/invoke", {"tokens": [9]})
            time.sleep(0.02)
        assert s0b.invokes >= 1, "traffic never returned to the revived " \
                                 "replica"
        assert b.state == CLOSED and b.closes >= 1
        assert b.half_open_probes >= 1
        rep = router.metrics()["router"]["breakers"]["r0"]
        assert rep["state"] == CLOSED
        s0b.kill()
    finally:
        router.stop()


# -- router-side network fault injection -------------------------------------


def test_fault_grammar_accepts_router_sites():
    plan = FaultPlan.from_spec(
        "route_connect:exception;route_body:exception@seg=2;"
        "route_latency:delay@ms=50;probe:exception@seg=3,n=6")
    assert len(plan.rules) == 4
    with pytest.raises(ValueError):
        FaultPlan.from_spec("route_nowhere:exception")


def test_injected_route_connect_drops_and_fails_over(stub_pair):
    """One injected drop: the request fails over to the other replica
    and still lands. (Two consecutive drops would exhaust a 2-replica
    fleet within one request — that shape is the spill tests' job.)"""
    s0, s1, pool = stub_pair
    pool.probe_all()
    plan = FaultPlan.from_spec("route_connect:exception@seg=1,n=1")
    router = FleetRouter(pool, affinity_on=False, max_retries=3,
                         backoff_s=0.01, backoff_cap_s=0.05, faults=plan)
    router.start_background()
    base = f"http://127.0.0.1:{router.port}"
    try:
        for i in range(4):
            assert _post(f"{base}/invoke", {"tokens": [i]})["ok"]
        rep = router.stats.report()
        assert rep["failovers"] >= 1 and rep["completed"] == 4
        assert plan.counts()["route_connect"] >= 4
    finally:
        router.stop()


def test_injected_route_latency_delays_but_delivers(stub_pair):
    s0, s1, pool = stub_pair
    pool.probe_all()
    plan = FaultPlan.from_spec("route_latency:delay@ms=200,n=1")
    router = FleetRouter(pool, affinity_on=False, faults=plan)
    router.start_background()
    base = f"http://127.0.0.1:{router.port}"
    try:
        t0 = time.monotonic()
        assert _post(f"{base}/invoke", {"tokens": [1]})["ok"]
        assert time.monotonic() - t0 >= 0.2
        assert router.stats.report()["failovers"] == 0
    finally:
        router.stop()


def test_injected_probe_fault_flaps_replica_through_pool(stub_pair):
    s0, s1, pool = stub_pair
    pool.probe_all()  # healthy baseline (counts on the EMPTY plan)
    # a fresh plan counts from zero: its calls 1-2 are the next sweep
    pool.faults = FaultPlan.from_spec("probe:exception@seg=1,n=2")
    pool.probe_all()  # plan calls 1-2: both probes fail -> both ejected
    assert {r.state for r in pool.replicas.values()} == {EJECTED}
    pool.probe_all()
    pool.probe_all()  # two clean passes -> readmitted
    assert all(r.state == READY for r in pool.replicas.values())
    assert all(r.ejections == 1 for r in pool.replicas.values())


# -- first-class attached replicas -------------------------------------------


def test_begin_drain_refuses_attached_replica(stub_pair):
    s0, s1, pool = stub_pair
    pool.probe_all()
    with pytest.raises(FleetError, match="attached.*probe-only"):
        pool.begin_drain("r0")
    assert pool.replicas["r0"].state == READY  # untouched


def test_rolling_restart_refuses_attach_only_pool(stub_pair):
    s0, s1, pool = stub_pair
    pool.probe_all()
    with pytest.raises(FleetError, match="attached"):
        pool.rolling_restart(live_floor=1)
    # not an AttributeError on the missing runtime, and nothing drained
    assert all(r.state == READY for r in pool.replicas.values())


def test_attached_replica_eject_readmit_zero_lost(stub_pair):
    """Attached replicas are first-class for health: kill one mid-
    traffic and every request still lands (failover), the corpse ejects
    at traffic speed, and the revived process readmits on consecutive
    probe passes — zero lost requests end to end."""
    s0, s1, pool = stub_pair
    pool.start()
    pool.probe_all()
    router = FleetRouter(pool, affinity_on=False, max_retries=3,
                         backoff_s=0.01, backoff_cap_s=0.1,
                         spill_cap=16, spill_max_wait_s=10.0)
    router.start_background()
    base = f"http://127.0.0.1:{router.port}"
    stop = threading.Event()
    ok = [0]
    failures = []

    def traffic():
        i = 0
        while not stop.is_set():
            i += 1
            try:
                assert _post(f"{base}/invoke", {"tokens": [i % 7]})["ok"]
                ok[0] += 1
            except Exception as e:  # noqa: BLE001 — collected for assert
                failures.append(repr(e))
            time.sleep(0.02)

    threads = [threading.Thread(target=traffic) for _ in range(2)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.3)
        port = s0.port
        s0.kill()
        victim = pool.replicas["r0"]
        deadline = time.monotonic() + 10
        while victim.state != EJECTED and time.monotonic() < deadline:
            time.sleep(0.05)
        assert victim.state == EJECTED
        time.sleep(0.3)  # traffic rides the survivor
        s0b = StubReplica("r0", port=port)
        deadline = time.monotonic() + 10
        while victim.state != READY and time.monotonic() < deadline:
            time.sleep(0.05)
        assert victim.state == READY and victim.ejections == 1
        time.sleep(0.3)  # traffic over the healed fleet
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
        router.stop()
        try:
            s0b.kill()
        except Exception:
            pass
    assert not failures, f"lost requests: {failures[:3]}"
    assert ok[0] > 10


# -- affinity-aware cache warming --------------------------------------------


def test_warm_prompt_extracts_whole_block_head():
    assert affinity.warm_prompt({"tokens": list(range(70))}, block=32) \
        == list(range(64))
    assert affinity.warm_prompt({"tokens": [1, 2, 3]}, block=32) is None
    assert affinity.warm_prompt({"prompt": "x" * 300}, block=32) \
        == "x" * 256
    # explicit prefix is part of the replayable head
    assert affinity.warm_prompt(
        {"prefix": list(range(32)), "tokens": [1] * 32}, block=32) \
        == list(range(32)) + [1] * 32
    assert affinity.warm_prompt({"n": 3}) is None


def test_readmitted_replica_gets_warmed_with_its_hot_prefixes(stub_pair):
    s0, s1, pool = stub_pair
    pool.start()
    pool.probe_all()
    router = FleetRouter(pool, affinity_on=True, block=4, max_retries=3,
                         backoff_s=0.01, backoff_cap_s=0.1,
                         warm_prefixes=4)
    router.start_background()
    base = f"http://127.0.0.1:{router.port}"
    stubs = {"r0": s0, "r1": s1}
    try:
        # one hot prefix, hammered: the router tracks it
        head = list(range(100, 112))  # 3 whole 4-token blocks
        for i in range(5):
            _post(f"{base}/invoke", {"tokens": head + [i]})
        key = affinity.prefix_key({"tokens": head + [0]}, block=4)
        target = affinity.pick_replica(key, sorted(pool.replicas))
        victim = pool.replicas[target]
        port = stubs[target].port
        stubs[target].kill()
        deadline = time.monotonic() + 10
        while victim.state != EJECTED and time.monotonic() < deadline:
            time.sleep(0.05)
        assert victim.state == EJECTED
        revived = StubReplica(target, port=port)
        deadline = time.monotonic() + 10
        while victim.state != READY and time.monotonic() < deadline:
            time.sleep(0.05)
        assert victim.state == READY
        # the warm request lands on the revived replica: its hot-prefix
        # head as a background-class 1-token completion
        deadline = time.monotonic() + 10
        warm = None
        while warm is None and time.monotonic() < deadline:
            warm = next((b for p, b in revived.bodies
                         if p == "/v1/completions"
                         and b.get("max_tokens") == 1), None)
            time.sleep(0.05)
        assert warm is not None, "readmitted replica never got a warm " \
                                 "request"
        assert warm["prompt"] == head and warm["temperature"] == 0
        assert router.stats.report()["warmed_prefixes"] >= 1
        revived.kill()
    finally:
        router.stop()


def test_router_healthz_reports_spill_depth(stub_pair):
    s0, s1, pool = stub_pair
    pool.probe_all()
    router = FleetRouter(pool, affinity_on=False, spill_cap=4)
    router.start_background()
    try:
        h = _get(f"http://127.0.0.1:{router.port}/healthz")
        assert h["ok"] and h["spill_depth"] == 0
    finally:
        router.stop()


# -- disaggregated prefill/decode: classes, ships, chaos ---------------------


from lambdipy_tpu_torch.fleet import (  # noqa: E402 — section-local imports
    DECODE,
    MIXED,
    PREFILL,
    parse_attach_spec,
)


def test_parse_attach_spec_grammar():
    assert parse_attach_spec("a=http://h:8080") == \
        ("a", "http://h:8080", MIXED)
    assert parse_attach_spec("p0=http://h:8080:prefill") == \
        ("p0", "http://h:8080", PREFILL)
    assert parse_attach_spec("d0=https://h:decode") == \
        ("d0", "https://h", DECODE)
    assert parse_attach_spec("m=http://h:9090:mixed") == \
        ("m", "http://h:9090", MIXED)
    with pytest.raises(FleetError, match="unknown replica class"):
        parse_attach_spec("x=http://h:8080:prefil")
    with pytest.raises(FleetError, match="NAME=URL"):
        parse_attach_spec("http://h:8080")
    with pytest.raises(FleetError, match="NAME=URL"):
        parse_attach_spec("x=ftp://h")


@pytest.fixture()
def disagg_pair():
    """One decode-class + one prefill-class stub behind a router."""
    dec, pre = StubReplica("dec"), StubReplica("pre")
    pool = ReplicaPool(probe_interval=5.0, fail_threshold=1,
                       readmit_passes=2, probe_timeout=2.0)
    pool.attach("dec", dec.url, role=DECODE)
    pool.attach("pre", pre.url, role=PREFILL)
    pool.probe_all()
    yield dec, pre, pool
    pool.close()
    for s in (dec, pre):
        try:
            s.kill()
        except Exception:
            pass


def _router(pool, **kw):
    kw.setdefault("affinity_on", True)
    kw.setdefault("block", 4)
    return FleetRouter(pool, **kw).start_background()


def test_phase_split_ships_then_forwards(disagg_pair):
    """A cold token request exports on the prefill replica, imports on
    the decode replica, and the request itself only ever touches the
    decode replica; a repeat request skips the ship (dedup LRU)."""
    dec, pre, pool = disagg_pair
    router = _router(pool)
    try:
        base = f"http://127.0.0.1:{router.port}"
        row = list(range(1, 13))
        out = _post(f"{base}/invoke", {"tokens": row, "max_new_tokens": 2})
        assert out["ok"] and out["replica"] == "dec"
        assert pre.exports == 1 and len(dec.imports) == 1
        assert dec.imports[0] == pre.cfg["kv_frame"]
        assert pre.invokes == 0  # prefill class never serves decode
        _post(f"{base}/invoke", {"tokens": row, "max_new_tokens": 2})
        assert pre.exports == 1  # second ship deduped
        rep = router.disagg.report()
        assert rep["ships"] == 1 and rep["ship_skips"] == 1
        assert rep["prefill_dispatches"] == 1
        assert rep["decode_dispatches"] == 1
        assert rep["ship_bytes_total"] == len(pre.cfg["kv_frame"])
        assert rep["ship_ms_ewma"] > 0
        assert rep["import_blocks"]["inserted"] == 2
        m = _get(f"{base}/metrics")
        assert m["fleet"]["disagg"]["classes"] == \
            {"decode": 1, "prefill": 1}
        h = _get(f"{base}/healthz")
        assert h["classes"] == {"decode": 1, "prefill": 1}
    finally:
        router.stop()


def test_string_prompt_falls_back_to_mixed(disagg_pair):
    """The router never tokenizes: a string prompt cannot key a KV
    frame, so it serves mixed-mode with the fallback counted."""
    dec, pre, pool = disagg_pair
    router = _router(pool)
    try:
        out = _post(f"http://127.0.0.1:{router.port}/v1/completions",
                    {"prompt": "a" * 64, "max_tokens": 2})
        assert out["ok"] is True  # delivered (stub echoes /invoke shape)
        assert pre.exports == 0
        assert router.disagg.report()["fallbacks"].get("no_token_head") \
            == 1
    finally:
        router.stop()


def test_ship_drop_falls_back_bitwise_and_counted(disagg_pair):
    """Injected kv_ship failure: the request still delivers (identical
    payload — the stub echoes the tokens), the fallback is counted, and
    the prefill replica is NOT ejected (the fault fired router-side,
    before any connection)."""
    dec, pre, pool = disagg_pair
    plan = FaultPlan.from_spec("kv_ship:exception@seg=1,n=2")
    router = _router(pool, faults=plan)
    try:
        base = f"http://127.0.0.1:{router.port}"
        rows = [list(range(10 * i, 10 * i + 8)) for i in range(1, 4)]
        outs = [_post(f"{base}/invoke", {"tokens": r}) for r in rows]
        assert all(o["ok"] and o["replica"] == "dec" for o in outs)
        # delivery is bitwise what a shipless forward returns
        assert [o["echo"] for o in outs] == rows
        rep = router.disagg.report()
        assert rep["fallbacks"]["ship_fault"] == 2
        assert rep["ships"] == 1  # the third request shipped fine
        assert pool.replicas["pre"].state == READY
        assert router.stats.report()["errors"] == 0
    finally:
        router.stop()


def test_ship_latency_delivers_and_prices(disagg_pair):
    """An injected kv_ship delay slows the ship, not the contract: the
    ship lands, the latency EWMA reflects it."""
    dec, pre, pool = disagg_pair
    plan = FaultPlan.from_spec("kv_ship:delay@ms=150,n=1")
    router = _router(pool, faults=plan)
    try:
        base = f"http://127.0.0.1:{router.port}"
        out = _post(f"{base}/invoke", {"tokens": list(range(1, 9))})
        assert out["ok"]
        rep = router.disagg.report()
        assert rep["ships"] == 1 and rep["fallbacks"] == {}
        assert rep["ship_ms_ewma"] >= 150
    finally:
        router.stop()


def test_import_backpressure_falls_back(disagg_pair):
    """A decode replica shedding its import (full page arena) costs the
    ship, never the request — and the shipped-key LRU does NOT mark the
    prefix warm, so the next request re-attempts the ship."""
    dec, pre, pool = disagg_pair
    dec.cfg["kv_shed"] = True
    router = _router(pool)
    try:
        base = f"http://127.0.0.1:{router.port}"
        row = list(range(1, 9))
        out = _post(f"{base}/invoke", {"tokens": row})
        assert out["ok"] and out["replica"] == "dec"
        rep = router.disagg.report()
        assert rep["fallbacks"]["import_backpressure"] == 1
        assert rep["prefill_dispatches"] == 1  # export leg did land
        assert rep["decode_dispatches"] == 0
        dec.cfg["kv_shed"] = False
        out = _post(f"{base}/invoke", {"tokens": row})
        assert router.disagg.report()["decode_dispatches"] == 1
    finally:
        router.stop()


def test_dead_prefill_class_degrades_to_mixed(disagg_pair):
    """Every prefill replica ejected: requests serve mixed-mode on the
    decode class, counted by reason — never an error."""
    dec, pre, pool = disagg_pair
    pre.kill()
    pool.note_failure(pool.replicas["pre"])
    assert pool.replicas["pre"].state == EJECTED
    router = _router(pool)
    try:
        out = _post(f"http://127.0.0.1:{router.port}/invoke",
                    {"tokens": list(range(1, 9))})
        assert out["ok"] and out["replica"] == "dec"
        rep = router.disagg.report()
        assert rep["fallbacks"]["no_prefill_replica"] == 1
        assert rep["ships"] == 0
    finally:
        router.stop()


def test_no_decode_class_degrades_to_prefill_mixed():
    """The inverse hole: only prefill-class replicas routable. The
    router must still deliver (a prefill replica is a full bundle
    server) rather than brown out — counted, never silent."""
    pre = StubReplica("pre")
    pool = ReplicaPool(probe_interval=5.0, probe_timeout=2.0)
    pool.attach("pre", pre.url, role=PREFILL)
    pool.probe_all()
    router = _router(pool)
    try:
        out = _post(f"http://127.0.0.1:{router.port}/invoke",
                    {"tokens": list(range(1, 9))})
        assert out["ok"] and out["replica"] == "pre"
        assert router.disagg.report()["fallbacks"][
            "no_decode_replica"] >= 1
    finally:
        router.stop()
        pool.close()
        pre.kill()


def test_readmission_clears_shipped_keys(disagg_pair):
    """An ejected decode replica's radix cache died with its worker: on
    readmission the router must forget what it shipped there and ship
    again."""
    dec, pre, pool = disagg_pair
    router = _router(pool)
    try:
        base = f"http://127.0.0.1:{router.port}"
        row = list(range(1, 13))
        _post(f"{base}/invoke", {"tokens": row})
        assert pre.exports == 1
        # eject then readmit the decode replica
        r = pool.replicas["dec"]
        pool.note_failure(r)
        assert r.state == EJECTED
        for _ in range(2):
            pool.probe_one(r)
        assert r.state == READY
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and \
                "dec" in router._shipped:
            time.sleep(0.02)
        _post(f"{base}/invoke", {"tokens": row})
        assert pre.exports == 2  # re-shipped after the cache died
    finally:
        router.stop()


def test_stream_ships_before_first_byte(disagg_pair):
    """Streams ride the phase split too: the ship happens before the
    stream opens, so the decode replica serves the whole stream from
    shipped KV."""
    dec, pre, pool = disagg_pair
    router = _router(pool)
    try:
        base = f"http://127.0.0.1:{router.port}"
        req = urllib.request.Request(
            f"{base}/invoke",
            data=json.dumps({"tokens": list(range(1, 13)),
                             "stream": True}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=30) as resp:
            lines = [json.loads(ln) for ln in resp if ln.strip()]
        assert lines and lines[-1].get("done")
        assert pre.exports == 1 and len(dec.imports) == 1
        assert router.disagg.report()["decode_dispatches"] == 1
    finally:
        router.stop()


def test_parse_attach_spec_keeps_odd_urls():
    """The pre-class grammar accepted any http URL: a portless IPv6
    literal or a path-bearing URL must still attach (mixed), only an
    alphabetic non-class suffix raises."""
    assert parse_attach_spec("a=http://[::1]") == \
        ("a", "http://[::1]", MIXED)
    assert parse_attach_spec("a=http://h:8080/base") == \
        ("a", "http://h:8080/base", MIXED)


def _stub_stream_frames(n_blocks=3, block=4):
    """A valid LKVS/LKVC stream (tiny fake KV) a stub export serves."""
    import numpy as np
    import torch

    from lambdipy_tpu_torch.runtime import kvwire

    rng = np.random.default_rng(0)

    def leaf():
        return torch.from_numpy(rng.random((1, block, 2, 4))
                                .astype(np.float32))

    blocks = [[{"k": leaf(), "v": leaf()}
               for _ in range(2)] for _ in range(n_blocks)]
    return kvwire.encode_stream(list(range(n_blocks * block)), block,
                                blocks, group=1)


def test_kv_ship_chunk_fault_degrades_and_never_poisons_dedup(
        disagg_pair):
    """An injected mid-stream chunk failure: the request still delivers
    (mixed-mode fallback, counted by reason), NOTHING half-arrived is
    recorded on the decode side, and the ship-dedup LRU is not marked —
    the next request on the same prefix re-ships, and with the fault
    exhausted that ship lands bitwise."""
    dec, pre, pool = disagg_pair
    frames = _stub_stream_frames()
    pre.cfg["kv_stream_frames"] = frames
    plan = FaultPlan.from_spec("kv_ship_chunk:exception@seg=2,n=1")
    router = _router(pool, faults=plan)
    try:
        base = f"http://127.0.0.1:{router.port}"
        row = list(range(1, 13))
        out = _post(f"{base}/invoke", {"tokens": row,
                                       "max_new_tokens": 2})
        assert out["ok"] and out["replica"] == "dec"  # delivered
        rep = router.disagg.report()
        assert rep["fallbacks"].get("ship_chunk_fault") == 1
        assert rep["mid_stream_failures"] >= 1
        assert rep["ships"] == 0
        assert dec.imports == []  # the aborted stream recorded nothing
        assert pre.exports == 1
        # same prefix again: the dedup LRU must NOT claim it shipped —
        # the relay re-ships, and (fault spent) delivers every frame
        out = _post(f"{base}/invoke", {"tokens": row,
                                       "max_new_tokens": 2})
        assert out["ok"]
        assert pre.exports == 2
        assert dec.imports == [b"".join(frames)]  # bitwise delivery
        rep = router.disagg.report()
        assert rep["ships"] == 1 and rep["ships_pipelined"] == 1
        assert rep["chunks_relayed"] == len(frames) - 1
        # and NOW the dedup holds: a third request skips the ship
        _post(f"{base}/invoke", {"tokens": row, "max_new_tokens": 2})
        assert pre.exports == 2
        assert router.disagg.report()["ship_skips"] == 1
    finally:
        router.stop()


def test_kv_ship_chunk_delay_prices_the_relay(disagg_pair):
    """Per-chunk synthetic RTT (the delay kind) slows but never breaks
    the ship: delivered bitwise, EWMA prices the wire time."""
    dec, pre, pool = disagg_pair
    frames = _stub_stream_frames()
    pre.cfg["kv_stream_frames"] = frames
    plan = FaultPlan.from_spec("kv_ship_chunk:delay@ms=40,n=inf")
    router = _router(pool, faults=plan)
    try:
        base = f"http://127.0.0.1:{router.port}"
        t0 = time.monotonic()
        out = _post(f"{base}/invoke", {"tokens": list(range(1, 13)),
                                       "max_new_tokens": 2})
        assert out["ok"]
        assert dec.imports == [b"".join(frames)]
        rep = router.disagg.report()
        assert rep["ships"] == 1 and rep["chunks_relayed"] == 3
        assert rep["mid_stream_failures"] == 0
        assert rep["ship_ms_ewma"] >= 3 * 40
        assert time.monotonic() - t0 >= 0.12
    finally:
        router.stop()


def test_monolithic_ship_window_zero_uses_single_frame(disagg_pair):
    """ship_window=0 is the pre-chunking behavior: one LKV1 frame, no
    chunk relay, the kv_ship_chunk site never fires."""
    dec, pre, pool = disagg_pair
    plan = FaultPlan.from_spec("kv_ship_chunk:exception@seg=1,n=inf")
    router = _router(pool, ship_window=0, faults=plan)
    try:
        out = _post(f"http://127.0.0.1:{router.port}/invoke",
                    {"tokens": list(range(1, 13)), "max_new_tokens": 2})
        assert out["ok"]
        assert dec.imports == [pre.cfg["kv_frame"]]
        rep = router.disagg.report()
        assert rep["ships"] == 1 and rep["ships_pipelined"] == 0
        assert rep["chunks_relayed"] == 0
        assert plan.counts().get("kv_ship_chunk") is None
    finally:
        router.stop()


def test_ship_skips_breaker_blocked_decode_target(disagg_pair):
    """An open decode-replica breaker shields it from ships too — the
    ship must target the replica the forward will actually pick."""
    dec, pre, pool = disagg_pair
    router = _router(pool, breaker_fails=1, breaker_open_s=30.0)
    try:
        # trip dec's breaker (a forward connection failure)
        b = router._breaker(pool.replicas["dec"])
        b.record_failure()
        assert router._breaker_blocked(pool.replicas["dec"])
        out = _post(f"http://127.0.0.1:{router.port}/invoke",
                    {"tokens": list(range(1, 13))})
        # the only decode-capable replica is breaker-blocked: no ship
        # (and the request degraded per the normal pick rules)
        assert pre.exports == 0 and len(dec.imports) == 0
        assert router.disagg.report()["fallbacks"][
            "no_decode_replica"] >= 1
    finally:
        router.stop()


# -- the fleet cases of tests/test_faults.py: a wedged replica ---------------


def test_pool_ejects_wedged_replica_and_router_routes_around():
    """A replica whose ``/healthz`` reports ``wedged: true`` is ejected at
    probe speed (its liveness 200 notwithstanding), never offered as a
    warming fallback, and traffic through the router all lands on the
    healthy replica; clearing the wedge readmits it after the passes."""
    from test_faults import _WedgeableStub

    s0, s1 = _WedgeableStub(), _WedgeableStub()
    pool = ReplicaPool(probe_interval=0.1, fail_threshold=1,
                       readmit_passes=2, probe_timeout=2.0)
    pool.attach("r0", s0.url)
    pool.attach("r1", s1.url)
    router = FleetRouter(pool, affinity_on=False, max_retries=2,
                         backoff_s=0.01, backoff_cap_s=0.2)
    router.start_background()
    try:
        pool.probe_all()
        assert {r.name for r in pool.routable()} == {"r0", "r1"}
        s0.cfg["wedged"] = True
        pool.probe_all()
        r0 = pool.replicas["r0"]
        assert r0.state == EJECTED and r0.wedged
        assert [r.name for r in pool.routable()] == ["r1"]
        assert pool.live_fallback() == []
        h = _get(f"http://127.0.0.1:{router.port}/healthz")
        assert h["ok"] and h["wedged"] == ["r0"]
        results = []

        def worker(i):
            results.append(_post(f"http://127.0.0.1:{router.port}/invoke",
                                 {"tokens": [i]}, timeout=30))

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(results) == 8 and all(r["ok"] for r in results)
        assert s1.invokes == 8 and s0.invokes == 0
        s0.cfg["wedged"] = False
        for _ in range(3):
            pool.probe_all()
        assert pool.replicas["r0"].state == READY
        assert {r.name for r in pool.routable()} == {"r0", "r1"}
    finally:
        router.stop()
        pool.close()
        for s in (s0, s1):
            s.kill()


def test_probe_site_fails_probes_and_ejects():
    """The pool's ``probe`` site (``LAMBDIPY_FLEET_FAULT``): an injected
    exception is a failed probe, so a healthy replica flaps out and back
    in as the rule's window says, counted as JAX's pool counts it."""
    from lambdipy_tpu.fleet import ReplicaPool as JaxPool
    from lambdipy_tpu.runtime.faults import FaultPlan as JaxPlan

    states = {}
    for tag, pool_cls, plan_cls in (("jax", JaxPool, JaxPlan),
                                    ("port", ReplicaPool, FaultPlan)):
        stub = StubReplica("r0")
        pool = pool_cls(probe_interval=0.1, fail_threshold=1,
                        readmit_passes=2, probe_timeout=2.0,
                        faults=plan_cls.from_spec("probe:exception@seg=2,n=2"))
        pool.attach("r0", stub.url)
        trace = []
        try:
            for _ in range(6):
                trace.append((pool.probe_one(pool.replicas["r0"]),
                              pool.replicas["r0"].state))
        finally:
            pool.close()
            stub.kill()
        states[tag] = (trace, pool.report()["r0"]["ejections"])
    assert states["port"] == states["jax"]
    assert states["port"][1] == 1
    assert [s for _, s in states["port"][0]] == [
        READY, EJECTED, EJECTED, EJECTED, READY, READY]


# -- across the packages: breakers and the retry budget on a fake clock -------


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("seed", range(6))
def test_breaker_states_are_jaxs_under_one_event_sequence(seed):
    """A seeded sequence of successes (fast and slow), failures, picks and
    clock steps: the port's ``CircuitBreaker`` reads JAX's state, its
    ``blocked()`` and its report after every event."""
    import numpy as np

    from lambdipy_tpu.fleet import breaker as jbreaker
    from lambdipy_tpu_torch.fleet import breaker as tbreaker

    events = np.random.default_rng(seed).choice(
        ["ok", "slow", "fail", "attempt", "tick", "long_tick"], size=300,
        p=[0.3, 0.1, 0.25, 0.15, 0.15, 0.05]).tolist()
    traces = []
    for mod in (jbreaker, tbreaker):
        clock = _Clock()
        b = mod.CircuitBreaker(fail_threshold=3, open_s=0.5, max_open_s=4.0,
                               outlier_ms=100.0, outlier_threshold=2,
                               probe_grace_s=2.0, clock=clock)
        trace = []
        for ev in events:
            if ev == "ok":
                b.record_success(5.0)
            elif ev == "slow":
                b.record_success(500.0)
            elif ev == "fail":
                b.record_failure()
            elif ev == "attempt":
                b.begin_attempt()
            else:
                clock.t += 0.3 if ev == "tick" else 2.5
            trace.append((b.state, b.blocked(), b.report()))
        traces.append(trace)
    assert traces[0] == traces[1]
    assert {s for s, _, _ in traces[1]} == {"closed", "open", "half_open"}


@pytest.mark.parametrize("seed", range(4))
def test_retry_budget_states_are_jaxs_under_one_event_sequence(seed):
    """Primaries, retries asked for and clock steps past the window: the
    port's ``RetryBudget`` allows and denies as JAX's, report for
    report."""
    import numpy as np

    from lambdipy_tpu.fleet import breaker as jbreaker
    from lambdipy_tpu_torch.fleet import breaker as tbreaker

    events = np.random.default_rng(seed).choice(
        ["primary", "retry", "tick"], size=400, p=[0.5, 0.35, 0.15]
    ).tolist()
    traces = []
    for mod in (jbreaker, tbreaker):
        clock = _Clock()
        budget = mod.RetryBudget(ratio=0.2, min_retries=2, window_s=3.0,
                                 clock=clock)
        trace = []
        for ev in events:
            if ev == "primary":
                budget.record_request()
                got = None
            elif ev == "retry":
                got = budget.allow_retry()
            else:
                clock.t += 0.7
                got = None
            trace.append((got, budget.report()))
        traces.append(trace)
    assert traces[0] == traces[1]
    assert traces[1][-1][1]["denied"] > 0 and traces[1][-1][1]["allowed"]


def test_relay_end_marker_waits_for_a_slow_writer(disagg_pair):
    """The relay's reader finishes while the writer is still sending: the
    end marker waits for room in the window as a frame does, so the ship
    ends when the writer is done. (Dropped after a 1 s wait, it left the
    writer waiting for it until the request timeout, and the ship failed
    as stalled.) A 1.5 s delay on the second of three chunks, a window
    of one frame."""
    dec, pre, pool = disagg_pair
    frames = _stub_stream_frames()
    pre.cfg["kv_stream_frames"] = frames
    plan = FaultPlan.from_spec("kv_ship_chunk:delay@ms=1500,seg=2,n=1")
    router = _router(pool, faults=plan, ship_window=1, request_timeout=20.0)
    try:
        base = f"http://127.0.0.1:{router.port}"
        t0 = time.monotonic()
        out = _post(f"{base}/invoke", {"tokens": list(range(1, 13)),
                                       "max_new_tokens": 2})
        wall = time.monotonic() - t0
        assert out["ok"]
        rep = router.disagg.report()
        assert rep["ships"] == 1 and rep["chunks_relayed"] == 3
        assert rep["mid_stream_failures"] == 0 and not rep["fallbacks"]
        assert dec.imports == [b"".join(frames)]
        assert 1.5 <= wall < 10.0
    finally:
        router.stop()
