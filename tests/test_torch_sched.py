"""The port's SLO scheduler (``lambdipy_tpu_torch/sched/``) against the JAX
package's (``lambdipy_tpu/sched/``): the unit twins of
``tests/test_sched.py`` (queue, policies, estimator, token bucket,
admission order and reasons, tenant LRU, deadlines, degenerate config,
request context, ``from_extra``), one seeded trace of ``admit`` /
``wait_turn`` / ``finish`` on a patched clock through both schedulers
whose every decision must be equal, and the HTTP twins against the
port's ``BundleServer`` serving ``llama-tiny`` on the CPU (its invokes
slowed by a fixed sleep where a test needs a queue to fill).

Every comparison here is exact: the scheduler is plain Python and the
two copies must make the same decisions on the same inputs."""

import dataclasses
import json
import os
import random
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest

import lambdipy_tpu.sched as jsched
import lambdipy_tpu_torch.sched as tsched
from lambdipy_tpu_torch.runtime.handlers import (HandlerContext,
                                                 generate_handler)
from lambdipy_tpu_torch.runtime.server import BundleServer
from lambdipy_tpu_torch.sched import (CLASSES, SchedConfig, Scheduler, Shed,
                                      clear_request_context,
                                      current_request_class,
                                      current_request_deadline_ms,
                                      set_request_context)
from lambdipy_tpu_torch.sched.admission import (AdmissionController,
                                                TokenBucket)
from lambdipy_tpu_torch.sched.estimator import CostEstimator
from lambdipy_tpu_torch.sched.policy import make_policy
from lambdipy_tpu_torch.sched.queue import RequestQueue, Ticket

# -- queue -------------------------------------------------------------------


def test_queue_lanes_bound_and_remove():
    q = RequestQueue(capacity=3)
    t1 = Ticket(cls="interactive")
    t2 = Ticket(cls="batch")
    t3 = Ticket(cls="background")
    assert q.push(t1) and q.push(t2) and q.push(t3)
    assert q.full() and not q.push(Ticket(cls="interactive"))
    assert q.depth() == 3 and q.depth("batch") == 1
    assert q.remove(t2) and not q.remove(t2)
    assert q.snapshot() == {"interactive": 1, "batch": 0, "background": 1}


def test_queue_pop_follows_policy():
    q = RequestQueue()
    bg = Ticket(cls="background")
    ia = Ticket(cls="interactive")
    q.push(bg)
    q.push(ia)
    assert q.pop(make_policy("priority")) is ia  # class rank beats arrival
    assert q.pop(make_policy("priority")) is bg
    q.push(bg)
    q.push(ia)
    assert q.pop(make_policy("fifo")) is bg  # arrival order


# -- policies ----------------------------------------------------------------


def test_fifo_policy_ignores_class():
    entries = [{"cls": "background", "seq": 1},
               {"cls": "interactive", "seq": 2}]
    assert make_policy("fifo").order(entries) == entries


def test_priority_policy_strict_order():
    entries = [{"cls": "background", "seq": 1}, {"cls": "batch", "seq": 2},
               {"cls": "interactive", "seq": 3}]
    ordered = make_policy("priority").order(entries)
    assert [e["cls"] for e in ordered] == ["interactive", "batch",
                                          "background"]
    assert make_policy("priority").head(entries)["cls"] == "interactive"


def test_fair_share_is_proportional_not_starving():
    """8:3:1 weighted round-robin over 120 picks with every lane
    contending: about 80/30/10, and background is never starved."""
    policy = make_policy("fair")
    lanes = {c: [SimpleNamespace(seq=0)] for c in CLASSES}
    served = {c: 0 for c in CLASSES}
    for _ in range(120):
        served[policy.select(lanes)] += 1
    assert served["background"] >= 5
    assert served["interactive"] > served["batch"] > served["background"]
    assert abs(served["interactive"] - 80) <= 8


def test_fair_share_order_interleaves():
    entries = ([{"cls": "batch", "seq": i} for i in range(6)]
               + [{"cls": "interactive", "seq": 10 + i} for i in range(6)])
    ordered = make_policy("fair").order(entries)
    first_batch = next(i for i, e in enumerate(ordered)
                       if e["cls"] == "batch")
    assert first_batch < 6
    assert ordered != entries


@pytest.mark.parametrize("name", ["fifo", "priority", "fair"])
def test_policy_order_equals_the_jax_policy(name):
    """Repeated ``order`` passes over seeded entry lists (the engine's
    slot handoff calls it once per barrier, and ``fair`` carries credit
    between calls): the same order as the JAX policy, pass by pass."""
    from lambdipy_tpu.sched.policy import make_policy as jax_make_policy

    rng = random.Random(7)
    ours, theirs = make_policy(name), jax_make_policy(name)
    for _ in range(40):
        entries = [{"cls": rng.choice(CLASSES), "seq": rng.randrange(1000)}
                   for _ in range(rng.randrange(1, 9))]
        assert ours.order(list(entries)) == theirs.order(list(entries))


def test_make_policy_names_and_aliases():
    assert make_policy("fair-share").name == "fair"
    assert make_policy("FIFO").name == "fifo"
    with pytest.raises(ValueError, match="unknown scheduling policy"):
        make_policy("lifo")


# -- estimator ---------------------------------------------------------------


def test_estimator_defaults_then_learns_affine_cost():
    est = CostEstimator(default_ms=50.0)
    assert est.estimate(0, 0) == 50.0
    for _ in range(400):
        for d in (8, 32, 128):
            est.observe(10.0 + 0.5 * d, prefill_tokens=0, decode_tokens=d)
    assert est.estimate(0, 100) == pytest.approx(60.0, rel=0.25)
    assert est.estimate(0, 256) > est.estimate(0, 16)
    rep = est.report()
    assert rep["samples"] == 1200 and rep["ms_per_decode_token"] > 0


def test_estimator_plain_ewma_without_token_counts():
    est = CostEstimator(default_ms=50.0)
    for _ in range(50):
        est.observe(200.0)
    assert est.mean_ms() == pytest.approx(200.0, rel=0.05)
    assert est.estimate() == pytest.approx(200.0, rel=0.25)


# -- admission ---------------------------------------------------------------


def test_token_bucket_burst_then_throttle():
    bucket = TokenBucket(rate=1.0, burst=2.0)
    now = time.monotonic()
    assert bucket.take(now) == 0.0
    assert bucket.take(now) == 0.0
    wait = bucket.take(now)
    assert 0.0 < wait <= 1.0
    assert bucket.take(now + 1.0) == 0.0


def test_admission_check_order_and_reasons():
    adm = AdmissionController(rate=100.0)
    common = dict(tenant="t", cls="interactive", deadline_ms=None,
                  queue_depth=0, queue_cap=4, est_wait_ms=0.0,
                  est_cost_ms=10.0)
    assert adm.check(draining=False, **common) is None
    shed = adm.check(draining=True, **common)
    assert shed.code == 503 and shed.reason == "draining"
    full = adm.check(draining=False, **{**common, "queue_depth": 4})
    assert full.code == 503 and full.reason == "queue_full"
    late = adm.check(draining=False,
                     **{**common, "deadline_ms": 5.0, "est_wait_ms": 100.0})
    assert late.code == 503 and late.reason == "deadline"
    assert late.retry_after_s > 0
    rep = adm.shed_report()
    assert rep["total"] == 3 and rep["by_class"]["interactive"] == 3


def test_tenant_eviction_is_lru_not_token_count():
    adm = AdmissionController(rate=100.0, burst=1.0, max_tenants=2)
    adm._bucket("old")
    time.sleep(0.01)
    hot = adm._bucket("hot")
    time.sleep(0.01)
    hot.take()               # refreshes hot's stamp
    adm._bucket("new")       # the map is full: "old" goes, not "hot"
    assert "old" not in adm._buckets
    assert {"hot", "new"} <= set(adm._buckets)


def test_per_tenant_rate_isolation():
    sched = Scheduler(SchedConfig(rate=1.0, burst=1.0))
    assert not isinstance(sched.admit(tenant="a"), Shed)
    over = sched.admit(tenant="a")
    assert isinstance(over, Shed) and over.code == 429
    assert not isinstance(sched.admit(tenant="b"), Shed)


# -- scheduler slot handoff --------------------------------------------------


def test_priority_grant_order_under_contention():
    sched = Scheduler(SchedConfig(policy="priority", max_concurrency=1))
    holder = sched.admit(cls="interactive")
    assert sched.wait_turn(holder, timeout=2)
    bg = sched.admit(cls="background")
    ia = sched.admit(cls="interactive")
    grants = []

    def waiter(ticket, name):
        if sched.wait_turn(ticket, timeout=5):
            grants.append(name)
            sched.finish(ticket, service_ms=1.0)

    threads = [threading.Thread(target=waiter, args=(bg, "bg")),
               threading.Thread(target=waiter, args=(ia, "ia"))]
    for t in threads:
        t.start()
    time.sleep(0.05)
    sched.finish(holder, service_ms=1.0)
    for t in threads:
        t.join()
    assert grants == ["ia", "bg"]


def test_deadline_shed_at_grant_time():
    sched = Scheduler(SchedConfig(max_concurrency=1))
    sched.estimator.observe(50.0)
    holder = sched.admit()
    assert sched.wait_turn(holder, timeout=2)
    late = sched.admit(deadline_ms=120.0)
    assert not isinstance(late, Shed)
    time.sleep(0.15)
    sched.finish(holder, service_ms=150.0)
    assert sched.wait_turn(late, timeout=2) is False
    assert late.expired
    assert sched.report()["shed"]["by_reason"]["deadline"] == 1


def test_degenerate_config_is_floored():
    sched = Scheduler(SchedConfig(queue_cap=0, max_concurrency=0))
    assert sched.config.queue_cap == 1 and sched.config.max_concurrency == 1
    ticket = sched.admit()
    assert not isinstance(ticket, Shed)
    assert sched.wait_turn(ticket, timeout=2)
    sched.finish(ticket, service_ms=1.0)


def test_request_context_roundtrip():
    assert current_request_class() == "interactive"
    set_request_context(cls="batch", tenant="t9", deadline_ms=5.0)
    assert current_request_class() == "batch"
    assert current_request_deadline_ms() == 5.0
    clear_request_context()
    assert current_request_class() == "interactive"
    assert current_request_deadline_ms() is None


def test_sched_config_from_bundle_extra_and_overrides(monkeypatch):
    monkeypatch.delenv("LAMBDIPY_SCHED_POLICY", raising=False)
    extra = {"sched_policy": "priority", "sched_queue_cap": "8",
             "sched_rate": "2.5", "batch_window_ms": "2"}
    cfg = SchedConfig.from_extra(extra)
    assert (cfg.policy, cfg.queue_cap, cfg.rate) == ("priority", 8, 2.5)
    cfg2 = SchedConfig.from_extra(extra, policy="fifo", queue_cap=None)
    assert cfg2.policy == "fifo" and cfg2.queue_cap == 8
    monkeypatch.setenv("LAMBDIPY_SCHED_POLICY", "fifo")
    assert SchedConfig.from_extra(extra).policy == "fifo"
    for cls in (SchedConfig, jsched.SchedConfig):
        assert dataclasses.asdict(cls.from_extra(extra, rate=None)) \
            == dataclasses.asdict(jsched.SchedConfig.from_extra(extra))


# -- the same trace through both schedulers ----------------------------------


def _run_trace(mod, policy: str, seed: int, monkeypatch) -> list:
    """A seeded single-thread trace of admit / wait_turn(timeout=0) /
    finish / clock advances through ``mod``'s Scheduler, on a patched
    ``time.monotonic`` (tickets stamped from the same clock). Returns
    every decision: each admit's shed (code, reason, Retry-After) or
    ticket, each wait_turn's answer, the order the queue handed
    tickets out, and report() every few steps and at the end."""
    clock = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    real_ticket = mod.Ticket
    monkeypatch.setattr(mod, "Ticket",
                        lambda **kw: real_ticket(enqueued=clock[0], **kw))
    sched = mod.Scheduler(mod.SchedConfig(
        policy=policy, max_concurrency=2, queue_cap=4, rate=8.0, burst=3.0,
        default_cost_ms=20.0))
    popped: list = []
    pop = sched.queue.pop

    def recording_pop(pol):
        t = pop(pol)
        if t is not None:
            popped.append(t)
        return t

    sched.queue.pop = recording_pop
    ids: dict = {}
    kept: list = []
    running: list = []
    rng = random.Random(seed)
    out = []
    for step in range(400):
        op = rng.random()
        if op < 0.5:
            res = sched.admit(
                tenant=rng.choice(["a", "b", "c"]),
                cls=rng.choice([*CLASSES, "bogus"]),
                deadline_ms=rng.choice([None, None, 5.0, 40.0, 400.0,
                                         1500.0]),
                prefill_tokens=rng.randrange(0, 300),
                decode_tokens=rng.randrange(0, 200))
            if isinstance(res, mod.Shed):
                out.append(("shed", res.code, res.reason,
                            res.retry_after_s))
            else:
                ids[id(res)] = len(ids)
                kept.append(res)  # alive, so no id() is reused
                running.append(res)
                out.append(("ticket", ids[id(res)], res.cls, res.granted,
                            res.expired, res.cost_ms))
        elif op < 0.7:
            granted = [t for t in running if t.granted and not t.expired]
            if granted:
                t = granted[rng.randrange(len(granted))]
                running.remove(t)
                sched.finish(t, service_ms=rng.uniform(1.0, 900.0))
                out.append(("finish", ids[id(t)]))
        elif op < 0.75:
            waiting = [t for t in running if not t.granted]
            if waiting:
                t = waiting[0]
                ok = sched.wait_turn(t, timeout=0)
                running.remove(t)
                out.append(("wait_turn", ids[id(t)], ok, t.expired))
        else:
            clock[0] += rng.uniform(0.001, 0.3)
        running = [t for t in running if not t.expired]
        out.append(("granted", sorted(ids[id(t)] for t in running
                                      if t.granted)))
        if step % 50 == 0:
            out.append(("report", sched.report()))
    out.append(("popped", [ids[id(t)] for t in popped]))
    out.append(("report", sched.report()))
    monkeypatch.undo()
    return out


@pytest.mark.parametrize("policy", ["fifo", "priority", "fair"])
@pytest.mark.parametrize("seed", [0, 1])
def test_scheduler_decisions_equal_the_jax_scheduler(policy, seed,
                                                     monkeypatch):
    """The same seeded trace through the JAX Scheduler and the port's:
    every admit's shed code, reason and Retry-After, the grant order,
    each wait_turn's answer and report() are equal."""
    want = _run_trace(jsched, policy, seed, monkeypatch)
    got = _run_trace(tsched, policy, seed, monkeypatch)
    # the trace sheds for every reason admission has
    assert {d[2] for d in got if d[0] == "shed"} == {"rate", "queue_full",
                                                     "deadline"}
    assert got == want


# -- HTTP --------------------------------------------------------------------


@pytest.fixture(scope="module")
def state():
    return generate_handler(
        {"model": "llama-tiny", "dtype": "float32",
         "extra": {"attn_backend": "blocked", "max_new_tokens": "4"}},
        HandlerContext(device="cpu"))


def _held(state, release: threading.Event, **changes):
    """The handler with every invoke held until ``release`` is set: the
    requests behind the one running queue however far apart their
    threads start."""
    invoke = state.invoke_fn

    def held(req):
        if not release.wait(timeout=60):
            raise TimeoutError("the test never released the invoke")
        return invoke(req)

    return dataclasses.replace(state, invoke_fn=held, **changes)


@pytest.fixture()
def serve():
    servers = []

    def make(state, **kw):
        srv = BundleServer(state, port=0, **kw).start_background()
        servers.append(srv)
        return srv

    yield make
    for srv in servers:
        srv.stop(drain_grace=2.0)


def _post(base, payload, headers=None, timeout=60, path="/invoke"):
    req = urllib.request.Request(
        f"{base}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read()), dict(resp.headers)


def _get(base, path):
    with urllib.request.urlopen(f"{base}{path}", timeout=30) as resp:
        return json.loads(resp.read())


BODY = {"tokens": [1, 2, 3], "max_new_tokens": 2}


def test_unloaded_server_sheds_nothing(state, serve):
    srv = serve(state)
    for _ in range(5):
        status, body, _ = _post(srv.url, BODY)
        assert status == 200 and body["ok"]
    metrics = _get(srv.url, "/metrics")
    # the server books a request's completion just after it has written
    # the response, so the last one may land a moment after the client
    # read it
    deadline = time.monotonic() + 10
    while metrics["sched"]["completed"] < 5 and time.monotonic() < deadline:
        time.sleep(0.01)
        metrics = _get(srv.url, "/metrics")
    assert metrics["server"]["requests"] == 5
    assert metrics["server"]["errors"] == 0
    assert metrics["server"]["latency"]["count"] == 5
    sched = metrics["sched"]
    assert sched["shed"]["total"] == 0 and sched["completed"] == 5
    assert sched["queue_wait"]["interactive"]["count"] == 5
    assert sched["policy"] == "fair"
    assert _get(srv.url, "/healthz")["sched"] == {"policy": "fair",
                                                  "queued": 0}


def test_overload_sheds_explicitly_with_retry_after(state, serve):
    """12 concurrent requests against 1 run slot and a queue of 3: the
    queue stays bounded, the excess is shed 503 with Retry-After, and
    /metrics counts the sheds by reason and the waits by class."""
    release = threading.Event()
    srv = serve(_held(state, release),
                sched={"max_concurrency": 1, "queue_cap": 3,
                       "policy": "fair"})
    results = []
    lock = threading.Lock()

    def fire(i):
        cls = CLASSES[i % 3]
        try:
            status, body, headers = _post(srv.url, BODY,
                                          headers={"x-priority": cls})
        except urllib.error.HTTPError as e:
            status, body, headers = e.code, json.loads(e.read()), \
                dict(e.headers)
        with lock:
            results.append((status, body, headers))

    threads = [threading.Thread(target=fire, args=(i,)) for i in range(12)]
    for t in threads:
        t.start()
    # the run slot is held: wait until 3 requests queue behind it and the
    # other 8 are answered, then release it
    deadline = time.monotonic() + 30
    while True:
        mid = _get(srv.url, "/metrics")["sched"]
        with lock:
            answered = len(results)
        if (mid["running"], sum(mid["queued"].values()), answered) \
                == (1, 3, 8) or time.monotonic() > deadline:
            break
        time.sleep(0.01)
    release.set()
    assert sum(mid["queued"].values()) <= 3 and mid["running"] <= 1
    assert (mid["running"], sum(mid["queued"].values()), answered) \
        == (1, 3, 8), (mid, answered)
    for t in threads:
        t.join()
    codes = [status for status, _, _ in results]
    assert codes.count(200) == 4
    shed = [r for r in results if r[0] in (429, 503)]
    assert shed, codes
    for status, body, headers in shed:
        assert int(headers["Retry-After"]) >= 1
        assert body["shed"] in ("queue_full", "deadline")
        assert body["retry_after_s"] > 0
    # a completion is booked just after its response is written
    metrics = _get(srv.url, "/metrics")
    deadline = time.monotonic() + 10
    while metrics["sched"]["completed"] < 4 and time.monotonic() < deadline:
        time.sleep(0.01)
        metrics = _get(srv.url, "/metrics")
    sched = metrics["sched"]
    assert sched["shed"]["total"] == len(shed)
    assert sched["shed"]["by_reason"].get("queue_full", 0) > 0
    assert sum(metrics["server"]["sheds"].values()) == len(shed)
    for rep in sched["queue_wait"].values():
        assert rep["p50_ms"] is not None and rep["p99_ms"] >= rep["p50_ms"]
    assert sched["estimator"]["samples"] == codes.count(200)


def test_http_deadline_shedding(state, serve):
    srv = serve(state)
    status, body, _ = _post(srv.url, BODY,
                            headers={"x-deadline-ms": "60000"})
    assert status == 200 and body["ok"]
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(srv.url, BODY, headers={"x-deadline-ms": "0.001"})
    assert err.value.code == 503
    assert json.loads(err.value.read())["shed"] == "deadline"
    assert err.value.headers.get("Retry-After")
    assert _get(srv.url, "/metrics")["sched"]["shed"]["by_reason"][
        "deadline"] == 1


def test_http_per_tenant_rate_limit(state, serve):
    srv = serve(state, sched={"rate": 0.5, "burst": 1.0})
    assert _post(srv.url, BODY, headers={"x-api-key": "k1"})[0] == 200
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(srv.url, BODY, headers={"x-api-key": "k1"})
    assert err.value.code == 429
    assert err.value.headers.get("Retry-After")
    assert json.loads(err.value.read())["shed"] == "rate"
    assert _post(srv.url, BODY, headers={"x-tenant": "k2"})[0] == 200


def test_bundle_extra_configures_scheduler(state, serve, monkeypatch):
    monkeypatch.delenv("LAMBDIPY_SCHED_POLICY", raising=False)
    srv = serve(dataclasses.replace(state, extra={
        "sched_policy": "priority", "sched_queue_cap": "5"}))
    assert srv.sched.policy.name == "priority"
    assert srv.sched.config.queue_cap == 5
    assert _get(srv.url, "/healthz")["sched"]["policy"] == "priority"


def test_resolved_policy_reaches_the_engine(serve, monkeypatch):
    """The handler builds its engine with the extra's (or the
    environment's) policy, fair by default; a server whose scheduler
    resolves another policy (a constructor or CLI override) hands it to
    the engine's batch formation, as the JAX server bridges it through
    ``LAMBDIPY_SCHED_POLICY``."""
    monkeypatch.delenv("LAMBDIPY_SCHED_POLICY", raising=False)
    built = generate_handler(
        {"model": "llama-tiny", "extra": {"batch_mode": "continuous",
                                          "sched_policy": "priority"}},
        HandlerContext(device="cpu"))
    assert built.engine.policy.name == "priority"
    monkeypatch.setenv("LAMBDIPY_SCHED_POLICY", "fifo")
    env_built = generate_handler(
        {"model": "llama-tiny", "extra": {"batch_mode": "continuous"}},
        HandlerContext(device="cpu"))
    assert env_built.engine.policy.name == "fifo"
    monkeypatch.delenv("LAMBDIPY_SCHED_POLICY")
    srv = serve(built, sched={"policy": "fair"})
    assert srv.sched.policy.name == "fair"
    assert built.engine.policy.name == "fair"
    assert built.engine.stats()["policy"] == "fair"
    assert "LAMBDIPY_SCHED_POLICY" not in os.environ


def test_concurrency_floored_at_batcher_width(state, serve):
    srv = serve(dataclasses.replace(state, extra={
        "batch_mode": "continuous", "batch_max": "32"}))
    assert srv.sched.config.max_concurrency == 32
    pinned = serve(dataclasses.replace(state, extra={
        "batch_mode": "continuous", "batch_max": "32"}),
        sched={"max_concurrency": 4})
    assert pinned.sched.config.max_concurrency == 4
    assert serve(state).sched.config.max_concurrency == 8


def test_drain_stops_admission_with_retry_after(state, serve):
    srv = serve(state)
    assert _post(srv.url, BODY)[0] == 200
    srv.draining = True
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(srv.url, BODY)
        assert err.value.code == 503
        assert json.loads(err.value.read())["shed"] == "draining"
        assert err.value.headers.get("Retry-After")
    finally:
        srv.draining = False
    assert _get(srv.url, "/metrics")["sched"]["shed"]["by_reason"] == {
        "draining": 1}
