"""The port's fleet (``lambdipy_tpu_torch/fleet/``), the twin of
``tests/test_fleet.py``: the same cases on the port's affinity, pool and
router over the JAX tests' scriptable stub replicas (``StubReplica``, no
model), and, marked ``slow`` as there, the port's bundle servers on the
CPU behind the router (router-vs-direct parity, the readiness split,
affinity raising the fleet's prefix-cache hit rate, SIGKILL with the
supervisor's respawn and a rolling restart). Then across the packages:
the affinity keys' bytes and rendezvous picks (hypothesis), a JAX router
and the port's over twin stubs routing a seeded sequence to the same
replica names with equal counters, and the CLI's ``fleet --device cpu``
as a process (readiness line, ``/invoke``, SIGTERM, no process left;
without a card and without ``--device cpu`` it exits before its
readiness line)."""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from lambdipy_tpu.fleet import FleetRouter as JaxRouter
from lambdipy_tpu.fleet import ReplicaPool as JaxPool
from lambdipy_tpu.fleet import affinity as jaffinity

from lambdipy_tpu_torch.fleet import (
    DRAINING,
    EJECTED,
    READY,
    FleetRouter,
    ReplicaPool,
    affinity,
)

from test_fleet import StubReplica, _get, _post
from test_runtime import make_model_bundle


# -- affinity hashing (pure) -------------------------------------------------


def test_prefix_key_leading_blocks():
    # keys depend only on the leading WHOLE blocks: same 64-token prefix,
    # different suffixes -> same key
    a = affinity.prefix_key({"tokens": list(range(64)) + [7, 8]}, block=32)
    b = affinity.prefix_key({"tokens": list(range(64)) + [9]}, block=32)
    assert a is not None and a == b
    # a different prefix changes the key
    c = affinity.prefix_key({"tokens": [5] * 64 + [7, 8]}, block=32)
    assert c != a
    # sub-block prompts key on the whole prompt (co-locate exact repeats)
    s1 = affinity.prefix_key({"tokens": [1, 2, 3]}, block=32)
    s2 = affinity.prefix_key({"tokens": [1, 2, 3]}, block=32)
    s3 = affinity.prefix_key({"tokens": [1, 2, 4]}, block=32)
    assert s1 == s2 and s1 != s3
    # an explicit client prefix is part of the effective prompt
    p1 = affinity.prefix_key({"prefix": list(range(32)), "tokens": [1, 2]},
                             block=32)
    p2 = affinity.prefix_key({"tokens": list(range(32)) + [3, 4]}, block=32)
    assert p1 == p2
    # ...including for string-suffix and prefix-only bodies: the prefix
    # is the reusable KV, so all three co-locate
    t1 = affinity.prefix_key({"prefix": list(range(32)), "text": "abc"},
                             block=32)
    t2 = affinity.prefix_key({"prefix": list(range(32)), "text": "xyz"},
                             block=32)
    t3 = affinity.prefix_key({"prefix": list(range(32))}, block=32)
    assert t1 == t2 == t3
    assert affinity.prefix_key({"prefix": [9] * 32, "text": "abc"},
                               block=32) != t1
    # the key window is BOUNDED: prompts sharing the first key_blocks
    # blocks co-locate even when their (multi-block) suffixes diverge —
    # a 512-token system prompt + distinct long user turns is exactly
    # the traffic affinity exists for
    shared = list(range(512))
    long_a = affinity.prefix_key(
        {"tokens": shared + [1] * 100}, block=32)
    long_b = affinity.prefix_key(
        {"tokens": shared + [2] * 100}, block=32)
    assert long_a == long_b
    assert affinity.prefix_key(
        {"tokens": list(range(7, 519)) + [1] * 100}, block=32) != long_a
    # OpenAI shape: token-array prompt and string prompt both key
    assert affinity.prefix_key({"prompt": list(range(40))}, block=32) \
        == affinity.prefix_key({"tokens": list(range(40))}, block=32)
    assert affinity.prefix_key({"prompt": "x" * 200}, block=32) \
        == affinity.prefix_key({"text": "x" * 200}, block=32)
    # nothing routable -> None
    assert affinity.prefix_key({"n": 3}, block=32) is None


def test_rendezvous_membership_stability():
    import random

    names = ["r0", "r1", "r2", "r3"]
    rng = random.Random(0)
    keys = [affinity.prefix_key(
        {"tokens": [rng.randrange(500) for _ in range(40)]})
        for _ in range(300)]
    before = {k: affinity.pick_replica(k, names) for k in keys}
    assert len(set(before.values())) == len(names)  # all replicas used
    # removing one replica remaps ONLY the keys that lived on it
    survivors = [n for n in names if n != "r2"]
    for k in keys:
        after = affinity.pick_replica(k, survivors)
        if before[k] != "r2":
            assert after == before[k]
        else:
            assert after in survivors


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


# -- pool health state machine ----------------------------------------------


def test_pool_eject_readmit_and_draining(stub_pair):
    s0, s1, pool = stub_pair
    pool.probe_all()
    assert {r.name for r in pool.routable()} == {"r0", "r1"}

    # readiness false (drain begun) = alive but NOT routable, NOT ejected
    s0.cfg["draining"] = True
    pool.probe_all()
    r0 = pool.replicas["r0"]
    assert [r.name for r in pool.routable()] == ["r1"]
    assert r0.state == READY and not r0.ready and r0.ejections == 0
    s0.cfg["draining"] = False
    pool.probe_all()
    assert len(pool.routable()) == 2

    # warm-in-flight is the same not-routable-but-live story
    s0.cfg["warming"] = True
    pool.probe_all()
    assert [r.name for r in pool.routable()] == ["r1"]
    s0.cfg["warming"] = False
    pool.probe_all()

    # abrupt death -> ejected after fail_threshold(=1) consecutive fails
    port = s0.port
    s0.kill()
    pool.probe_all()
    assert r0.state == EJECTED and r0.ejections == 1

    # revival (same port, new worker pid) -> readmitted only after
    # readmit_passes consecutive passes, with the restart counted
    s0b = StubReplica("r0", port=port)
    s0b.cfg["pid"] = 2000
    pool.probe_all()
    assert r0.state == EJECTED  # one pass is not enough
    pool.probe_all()
    assert r0.state == READY and r0.restarts == 1
    s0b.kill()


# -- router: routing, failover, retry ---------------------------------------


def test_router_spreads_and_fails_over(stub_pair):
    s0, s1, pool = stub_pair
    pool.probe_all()
    router = FleetRouter(pool, affinity_on=False,
                         max_retries=2, backoff_cap_s=0.2)
    router.start_background()
    base = f"http://127.0.0.1:{router.port}"
    try:
        for i in range(6):
            out = _post(f"{base}/invoke", {"tokens": [i], "n": 1})
            assert out["ok"] and out["echo"] == [i]
        # round-robin tie-break spreads affinity-off traffic
        assert s0.invokes >= 2 and s1.invokes >= 2
        assert s0.invokes + s1.invokes == 6

        # kill one replica: concurrent traffic must all succeed via
        # retries, and the dead replica ejects at TRAFFIC speed (the
        # router reports the connection failure; no probe needed)
        s0.kill()
        results = []

        def worker(i):
            results.append(_post(f"{base}/invoke", {"tokens": [i]}))

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(results) == 8 and all(r["ok"] for r in results)
        assert all(r["replica"] == "r1" for r in results)
        assert pool.replicas["r0"].state == EJECTED
        rep = router.stats.report()
        assert rep["failovers"] >= 1 and rep["retries"] >= 1
        assert rep["completed"] >= 14
    finally:
        router.stop()


def test_router_honors_retry_after_shed(stub_pair):
    s0, s1, pool = stub_pair
    pool.probe_all()
    router = FleetRouter(pool, affinity_on=False, max_retries=2,
                         backoff_s=0.01, backoff_cap_s=0.2)
    router.start_background()
    base = f"http://127.0.0.1:{router.port}"
    try:
        # one replica shedding: every request still lands on the other
        s0.cfg["shed"] = True
        for i in range(4):
            out = _post(f"{base}/invoke", {"tokens": [i]})
            assert out["ok"] and out["replica"] == "r1"
        assert router.stats.report()["retries"] >= 1

        # the WHOLE fleet shedding: the shed response is relayed to the
        # client with its Retry-After intact, not a synthetic error
        s1.cfg["shed"] = True
        s0.cfg["retry_after"] = s1.cfg["retry_after"] = 7
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{base}/invoke", {"tokens": [1]})
        assert e.value.code == 503
        assert e.value.headers["Retry-After"] == "7"
        body = json.loads(e.value.read())
        assert body["shed"] and body["retry_after_s"] == 7.0
    finally:
        router.stop()


def test_router_streaming_passthrough_and_stream_failover(stub_pair):
    s0, s1, pool = stub_pair
    pool.probe_all()
    router = FleetRouter(pool, affinity_on=False, max_retries=2,
                         backoff_cap_s=0.2)
    router.start_background()
    base = f"http://127.0.0.1:{router.port}"
    try:
        # ndjson /invoke pass-through
        req = urllib.request.Request(
            f"{base}/invoke",
            data=json.dumps({"tokens": [1], "stream": True}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert resp.headers["Content-Type"] == "application/x-ndjson"
            lines = [json.loads(ln) for ln in resp if ln.strip()]
        assert lines[-1]["done"] and lines[0]["tokens"] == [[1]]

        # SSE /v1/completions pass-through
        req = urllib.request.Request(
            f"{base}/v1/completions",
            data=json.dumps({"prompt": [1], "stream": True}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert resp.headers["Content-Type"] == "text/event-stream"
            events = [ln.decode().strip()[6:] for ln in resp
                      if ln.strip().startswith(b"data: ")]
        assert events[-1] == "[DONE]"

        # a dead replica is retried BEFORE any bytes are forwarded
        s0.kill()
        served = set()
        for i in range(4):
            req = urllib.request.Request(
                f"{base}/invoke",
                data=json.dumps({"tokens": [i],
                                 "stream": True}).encode(),
                headers={"Content-Type": "application/json"},
                method="POST")
            with urllib.request.urlopen(req, timeout=30) as resp:
                lines = [json.loads(ln) for ln in resp if ln.strip()]
            assert lines[-1]["done"]
            served.add(lines[-1]["replica"])
        assert served == {"r1"}
    finally:
        router.stop()


def test_router_hedges_slow_primary(stub_pair):
    s0, s1, pool = stub_pair
    pool.probe_all()
    # a key whose rendezvous target we can find out, then slow down
    key = affinity.prefix_key({"tokens": list(range(64))}, block=32)
    target = affinity.pick_replica(key, ["r0", "r1"])
    slow, fast = (s0, s1) if target == "r0" else (s1, s0)
    slow.cfg["delay_s"] = 1.5
    router = FleetRouter(pool, affinity_on=True, block=32,
                         hedge_ms=100, hedge_floor_ms=50)
    router.start_background()
    base = f"http://127.0.0.1:{router.port}"
    try:
        t0 = time.monotonic()
        out = _post(f"{base}/invoke", {"tokens": list(range(64))})
        elapsed = time.monotonic() - t0
        assert out["ok"] and out["replica"] == fast.name
        assert elapsed < 1.4  # did not wait out the slow primary
        rep = router.stats.report()
        assert rep["hedges"] == 1 and rep["hedge_wins"] == 1
        assert pool.replicas[fast.name].hedged == 1
    finally:
        router.stop()


def test_router_healthz_and_metrics_aggregation(stub_pair):
    s0, s1, pool = stub_pair
    pool.probe_all()
    s0.cfg["prefix_cache"] = {"hits": 3, "misses": 1, "hit_tokens": 96}
    s1.cfg["prefix_cache"] = {"hits": 1, "misses": 1, "hit_tokens": 32}
    # sp-decode stand-downs aggregate BY REASON at the router (a sharded
    # replica quietly replicating its cache must be visible fleet-wide)
    s0.cfg["spec"] = {"sp_standdown": 2, "sp_standdown_reasons":
                      {"attn_backend=blocked": 2}}
    s1.cfg["spec"] = {"sp_standdown": 1, "sp_standdown_reasons":
                      {"spec_k_under_sp_mesh": 1}}
    router = FleetRouter(pool, affinity_on=True, block=32)
    router.start_background()
    base = f"http://127.0.0.1:{router.port}"
    try:
        for i in range(3):
            _post(f"{base}/invoke", {"tokens": list(range(32 + i))})
        health = _get(f"{base}/healthz")
        assert health["ok"] and health["routable"] == 2
        assert health["replicas"] == {"r0": READY, "r1": READY}
        m = _get(f"{base}/metrics")
        # fleet-wide prefix cache is the SUM over replicas
        assert m["fleet"]["prefix_cache"] == {
            "hits": 4, "misses": 2, "hit_tokens": 128,
            "hit_rate": round(4 / 6, 4)}
        assert m["fleet"]["spec_standdown"] == {
            "total": 3, "reasons": {"attn_backend=blocked": 2,
                                    "spec_k_under_sp_mesh": 1}}
        assert m["router"]["completed"] == 3
        assert m["router"]["affinity"]["requests"] == 3
        assert sum(rep["routed"] for rep in m["pool"].values()) == 3
        # per-replica raw /metrics ride along
        assert m["replicas"]["r0"]["count"] == s0.invokes
        # distinct 32-token prefixes: affinity keys differ, but each is
        # a HIT (target routable)
        assert m["router"]["affinity"]["hit_rate"] == 1.0
    finally:
        router.stop()


def test_router_draining_replica_loses_traffic_before_shedding(stub_pair):
    """The readiness split in action: once a replica reports
    ready: false, the router stops routing there BEFORE any request has
    to eat its 503."""
    s0, s1, pool = stub_pair
    pool.probe_all()
    router = FleetRouter(pool, affinity_on=False)
    router.start_background()
    base = f"http://127.0.0.1:{router.port}"
    try:
        s0.cfg["draining"] = True  # server would 503, probe says not ready
        pool.probe_all()
        before = s0.invokes
        for i in range(4):
            out = _post(f"{base}/invoke", {"tokens": [i]})
            assert out["replica"] == "r1"
        assert s0.invokes == before  # zero requests even reached it
        assert router.stats.report()["retries"] == 0
    finally:
        router.stop()


def test_router_serves_through_whole_fleet_warming(stub_pair):
    """Brownout guard: when EVERY replica reports ready: false because
    its background warm is still compiling (a fresh fleet's first burst
    of traffic), the router degrades to the live-but-warming replicas —
    they serve fine — instead of 503ing the fleet."""
    s0, s1, pool = stub_pair
    s0.cfg["warming"] = s1.cfg["warming"] = True
    pool.probe_all()
    assert pool.routable() == [] and len(pool.live_fallback()) == 2
    router = FleetRouter(pool, affinity_on=False)
    router.start_background()
    base = f"http://127.0.0.1:{router.port}"
    try:
        for i in range(4):
            assert _post(f"{base}/invoke", {"tokens": [i]})["ok"]
        assert router.stats.report()["no_replica"] == 0
        # once warm finishes, strict readiness routing resumes
        s0.cfg["warming"] = s1.cfg["warming"] = False
        pool.probe_all()
        assert len(pool.routable()) == 2
    finally:
        router.stop()


def test_pool_begin_drain_routes_away_immediately(stub_pair):
    """Rolling-drain step 1: begin_drain() flips routing away without
    waiting for the next probe. (The stubs stand in for MANAGED
    replicas here — begin_drain refuses attached ones, see
    tests/test_fleet_resilience.py.)"""
    s0, s1, pool = stub_pair
    pool.probe_all()
    for r in pool.replicas.values():
        r.managed = True
    router = FleetRouter(pool, affinity_on=False)
    router.start_background()
    base = f"http://127.0.0.1:{router.port}"
    try:
        pool.begin_drain("r1")
        assert pool.replicas["r1"].state == DRAINING
        for i in range(4):
            assert _post(f"{base}/invoke",
                         {"tokens": [i]})["replica"] == "r0"
        # end_drain aborts the drain (the chaos nemesis's undrain, an
        # operator changing their mind): r1 routes again, and a second
        # end_drain on a non-draining replica is a no-op
        pool.end_drain("r1")
        assert pool.replicas["r1"].routable
        pool.end_drain("r1")
        seen = {_post(f"{base}/invoke", {"tokens": [i]})["replica"]
                for i in range(8)}
        assert "r1" in seen
    finally:
        router.stop()


# -- deploy/_http_json edges the router leans on -----------------------------


def test_http_json_connection_refused_and_timeout():
    from lambdipy_tpu_torch.runtime.deploy import _http_json

    # refused: nothing listening on a fresh port -> URLError, fast
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    t0 = time.monotonic()
    with pytest.raises(urllib.error.URLError):
        _http_json(f"http://127.0.0.1:{port}/healthz", timeout=5)
    assert time.monotonic() - t0 < 2.0

    # timeout: a listener that accepts but never answers must raise at
    # the caller's deadline, not hang the router's probe thread
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    try:
        t0 = time.monotonic()
        with pytest.raises(Exception) as e:
            _http_json(
                f"http://127.0.0.1:{srv.getsockname()[1]}/healthz",
                timeout=0.3)
        assert isinstance(e.value, (TimeoutError, urllib.error.URLError,
                                    socket.timeout))
        assert time.monotonic() - t0 < 3.0
    finally:
        srv.close()


# -- real-bundle parity through the router -----------------------------------


@pytest.fixture(scope="module")
def fleet_bundle(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fleet-bundle")
    return make_model_bundle(
        tmp, model="llama-tiny",
        handler="lambdipy_tpu.runtime.handlers:generate_handler",
        extra={"max_new_tokens": "4"})


@pytest.fixture(scope="module")
def real_pair(fleet_bundle):
    from lambdipy_tpu_torch.runtime.server import BundleServer

    servers = [BundleServer.from_bundle(fleet_bundle, warmup=False,
                                        device="cpu").start_background()
               for _ in range(2)]
    pool = ReplicaPool(probe_interval=0.2, fail_threshold=1,
                       readmit_passes=2)
    for i, s in enumerate(servers):
        pool.attach(f"b{i}", f"http://127.0.0.1:{s.port}")
    pool.probe_all()
    yield servers, pool
    pool.close()
    for s in servers:
        threading.Thread(target=s.stop, daemon=True).start()


@pytest.mark.slow
def test_bundle_server_readiness_split(real_pair, monkeypatch):
    servers, pool = real_pair
    s = servers[0]
    base = f"http://127.0.0.1:{s.port}"
    h = _get(f"{base}/healthz")
    assert h["ok"] and h["ready"] and not h["warming"]
    # warm in flight: still 200/ok (liveness) but flagged not ready
    monkeypatch.setattr(s.boot.state, "warming_fn", lambda: True)
    h = _get(f"{base}/healthz")
    assert h["ok"] and not h["ready"] and h["warming"]
    monkeypatch.undo()
    # drain begun: same split
    s.draining = True
    try:
        h = _get(f"{base}/healthz")
        assert h["ok"] and not h["ready"] and h["draining"]
    finally:
        s.draining = False


@pytest.mark.slow
def test_router_parity_real_servers(real_pair):
    """Acceptance: router-fronted responses are bitwise identical to
    direct single-replica responses — greedy and seeded-sampled,
    streamed and non-streamed."""
    servers, pool = real_pair
    direct = f"http://127.0.0.1:{servers[0].port}"
    router = FleetRouter(pool, affinity_on=True, block=32)
    router.start_background()
    base = f"http://127.0.0.1:{router.port}"
    try:
        greedy = {"prompt": [1, 2, 3], "max_tokens": 6, "temperature": 0}
        sampled = {"prompt": [1, 2, 3], "max_tokens": 6,
                   "temperature": 0.8, "top_k": 5, "seed": 7}
        for body in (greedy, sampled):
            d = _post(f"{direct}/v1/completions", body)
            r = _post(f"{base}/v1/completions", body)
            # queue_wait_ms is a per-request timing measurement (stamped
            # at sched grant) — each request measures its own wait, so
            # bitwise parity applies to everything BUT it
            assert d.pop("queue_wait_ms", None) is not None
            assert r.pop("queue_wait_ms", None) is not None
            assert d == r  # whole response: tokens, usage, finish_reason

        def sse_events(url, body):
            req = urllib.request.Request(
                url, data=json.dumps({**body, "stream": True,
                                      "segment": 2}).encode(),
                headers={"Content-Type": "application/json"},
                method="POST")
            with urllib.request.urlopen(req, timeout=120) as resp:
                return [ln for ln in resp if ln.strip()]

        for body in (greedy, sampled):
            assert sse_events(f"{direct}/v1/completions", body) == \
                sse_events(f"{base}/v1/completions", body)

        # /invoke ndjson streaming parity
        body = {"tokens": [1, 2, 3], "max_new_tokens": 6, "stream": True,
                "segment": 3}
        assert sse_events(f"{direct}/invoke", body) == \
            sse_events(f"{base}/invoke", body)

        # affinity keeps a repeated prompt on one replica
        routed_before = {n: r.routed for n, r in pool.replicas.items()}
        for _ in range(4):
            _post(f"{base}/v1/completions", greedy)
        moved = {n: pool.replicas[n].routed - routed_before[n]
                 for n in routed_before}
        assert sorted(moved.values()) == [0, 4]
    finally:
        router.stop()


# -- slow: affinity concentrates the prefix cache ----------------------------


@pytest.mark.slow
def test_affinity_raises_fleet_prefix_hit_rate(tmp_path):
    """Acceptance: shared-prefix traffic achieves a HIGHER fleet
    prefix-cache hit rate with affinity on than off. Fresh prefix groups
    per phase keep the comparison cold-for-cold on the same servers."""
    import numpy as np

    from lambdipy_tpu_torch.runtime.server import BundleServer

    bundle = make_model_bundle(
        tmp_path, model="llama-tiny",
        handler="lambdipy_tpu.runtime.handlers:generate_handler",
        extra={"max_new_tokens": "4", "prefix_cache_mb": "64",
               "prefix_block": "16"})
    servers = [BundleServer.from_bundle(bundle, warmup=False,
                                        device="cpu").start_background()
               for _ in range(2)]
    pool = ReplicaPool(probe_interval=0.2)
    for i, s in enumerate(servers):
        pool.attach(f"p{i}", f"http://127.0.0.1:{s.port}")
    pool.probe_all()

    def run_phase(affinity_on, seed):
        phase_rng = np.random.default_rng(seed)
        router = FleetRouter(pool, affinity_on=affinity_on, block=16)
        router.start_background()
        base = f"http://127.0.0.1:{router.port}"
        try:
            before = router.metrics()["fleet"]["prefix_cache"]
            for _ in range(2):  # two distinct shared-prefix groups
                shared = phase_rng.integers(1, 500, 32).tolist()
                for _ in range(5):
                    suffix = phase_rng.integers(1, 500, 4).tolist()
                    out = _post(f"{base}/v1/completions",
                                {"prompt": shared + suffix,
                                 "max_tokens": 4, "temperature": 0},
                                timeout=600)
                    assert out["choices"][0]["tokens"]
            after = router.metrics()["fleet"]["prefix_cache"]
        finally:
            router.stop()
        hits = after["hits"] - before["hits"]
        misses = after["misses"] - before["misses"]
        assert hits + misses == 10
        return hits / 10

    try:
        rate_on = run_phase(True, seed=1)
        rate_off = run_phase(False, seed=2)
        assert rate_on > rate_off, (rate_on, rate_off)
        # with affinity each group pays ONE cold miss; round-robin
        # spreads each group across both replicas' caches
        assert rate_on >= 0.8
    finally:
        pool.close()
        for s in servers:
            threading.Thread(target=s.stop, daemon=True).start()


# -- slow: subprocess fault injection + rolling restart ----------------------


@pytest.mark.slow
def test_fleet_fault_injection_and_rolling_restart(tmp_path):
    """Acceptance: with 2 supervised replicas under concurrent traffic,
    SIGKILL of one replica's worker loses zero requests (retries route
    to the survivor), the dead replica is ejected within one probe
    interval, the supervisor respawns it AT ITS REGISTERED URL
    (port-pinning) and the pool re-admits it — all visible in the fleet
    metrics. Then a rolling restart drains both replicas one at a time
    without ever dropping below the live floor."""
    import os
    import signal

    from lambdipy_tpu_torch.runtime.deploy import LocalRuntime

    bundle = make_model_bundle(
        tmp_path, model="llama-tiny",
        handler="lambdipy_tpu.runtime.handlers:generate_handler",
        extra={"max_new_tokens": "2"})
    env = {
        "LAMBDIPY_PLATFORM": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=1",
        "LAMBDIPY_STABLE_UPTIME_S": "5",
        "LAMBDIPY_MAX_BACKOFF_S": "1",
    }
    rt = LocalRuntime(tmp_path / "deployments.json")
    pool = ReplicaPool(probe_interval=0.5, fail_threshold=1,
                       readmit_passes=2)
    pool.spawn_fleet(bundle, 2, base_name="fi", runtime=rt, env=env)
    pool.start()
    router = FleetRouter(pool, affinity_on=True, block=32, max_retries=3,
                         backoff_cap_s=0.5,
                         request_timeout=120).start_background()
    base = f"http://127.0.0.1:{router.port}"
    stop_traffic = threading.Event()
    ok_count = [0]
    failures = []

    def traffic():
        i = 0
        while not stop_traffic.is_set():
            i += 1
            try:
                out = _post(f"{base}/invoke",
                            {"tokens": [1 + (i % 7), 2, 3],
                             "max_new_tokens": 2}, timeout=120)
                assert out["ok"]
                ok_count[0] += 1
            except Exception as e:  # noqa: BLE001 — collected for assert
                failures.append(repr(e))
            time.sleep(0.05)

    threads = [threading.Thread(target=traffic) for _ in range(3)]
    try:
        for t in threads:
            t.start()
        time.sleep(2)  # let traffic establish on the healthy fleet

        # SIGKILL the WORKER of fi-r1 (healthz pid — the supervisor in
        # front of it must stay up to respawn)
        victim = pool.replicas["fi-r1"]
        url_before, worker_pid = victim.url, victim.pid
        assert worker_pid and worker_pid != rt.get("fi-r1").pid
        os.kill(worker_pid, signal.SIGKILL)

        deadline = time.monotonic() + 30
        while victim.state != EJECTED and time.monotonic() < deadline:
            time.sleep(0.1)
        assert victim.state == EJECTED, "dead replica was not ejected"

        # supervisor respawn -> probe passes -> re-admission, same URL
        deadline = time.monotonic() + 180
        while victim.state != READY and time.monotonic() < deadline:
            time.sleep(0.5)
        assert victim.state == READY, "replica was never re-admitted"
        assert victim.url == url_before  # port pinned across restart
        assert victim.pid != worker_pid and victim.restarts >= 1
        time.sleep(2)  # traffic over the healed fleet

        assert not failures, f"lost requests: {failures[:3]}"
        assert ok_count[0] > 20
        m = router.metrics()
        assert m["router"]["retries"] >= 1
        assert m["pool"]["fi-r1"]["ejections"] == 1

        # rolling restart under (light) traffic: floor holds, zero lost
        pool.rolling_restart(live_floor=1, ready_timeout=180)
        deadline = time.monotonic() + 30  # a stale probe may flap one
        while time.monotonic() < deadline and \
                not all(r.routable for r in pool.replicas.values()):
            time.sleep(0.5)
        assert all(r.routable for r in pool.replicas.values())
        time.sleep(1)
        assert not failures, f"rolling restart lost: {failures[:3]}"
    finally:
        stop_traffic.set()
        for t in threads:
            t.join(timeout=30)
        router.stop()
        pool.stop_all()
    assert rt.list() == []


# -- across the packages: affinity ------------------------------------------

_TOKENS = st.lists(st.integers(0, 128_255), max_size=400)
_TEXT = st.text(max_size=300)
_BODIES = st.one_of(
    st.fixed_dictionaries({"tokens": _TOKENS}),
    st.fixed_dictionaries({"prompt": _TOKENS}),
    st.fixed_dictionaries({"tokens": st.lists(_TOKENS, min_size=1,
                                              max_size=3)}),
    st.fixed_dictionaries({"prefix": _TOKENS, "tokens": _TOKENS}),
    st.fixed_dictionaries({"prefix": _TOKENS, "text": _TEXT}),
    st.fixed_dictionaries({"prefix": _TOKENS}),
    st.fixed_dictionaries({"text": _TEXT}),
    st.fixed_dictionaries({"prompt": _TEXT}),
    st.fixed_dictionaries({"n": st.integers()}),
)


def test_affinity_constants_are_jaxs():
    for name in ("DEFAULT_BLOCK", "DEFAULT_KEY_BLOCKS", "CHARS_PER_TOKEN",
                 "SHIP_KEY_BLOCKS", "SESSION_KEY_BLOCKS"):
        assert getattr(affinity, name) == getattr(jaffinity, name), name


@settings(max_examples=200, deadline=None, database=None)
@given(body=_BODIES, block=st.sampled_from([1, 4, 16, 32]),
       key_blocks=st.integers(1, 70))
def test_affinity_keys_and_heads_are_jaxs(body, block, key_blocks):
    """``prefix_key``, ``warm_prompt`` and ``ship_prompt`` give JAX's
    bytes and heads for any request body."""
    for fn in ("prefix_key", "warm_prompt", "ship_prompt"):
        assert getattr(affinity, fn)(body, block=block,
                                     key_blocks=key_blocks) \
            == getattr(jaffinity, fn)(body, block=block,
                                      key_blocks=key_blocks), fn


@settings(max_examples=200, deadline=None, database=None)
@given(key=st.binary(max_size=80),
       names=st.lists(st.text(min_size=1, max_size=12), min_size=1,
                      max_size=8, unique=True),
       sid=st.one_of(st.text(max_size=24), st.integers()))
def test_rendezvous_picks_and_session_keys_are_jaxs(key, names, sid):
    """``pick_replica`` names JAX's replica for any key and membership;
    ``session_key`` gives JAX's bytes, and so the same failover home."""
    assert affinity.pick_replica(key, names) \
        == jaffinity.pick_replica(key, names)
    assert affinity.session_key(sid) == jaffinity.session_key(sid)
    skey = affinity.session_key(sid)
    assert affinity.pick_replica(skey, names) \
        == jaffinity.pick_replica(skey, names)


# -- across the packages: a JAX router and the port's over twin stubs -------


def _stub_fleet(pool_cls, router_cls, disagg: bool):
    """Three stub replicas (decode-class with a prefill-class stub when
    ``disagg``, else mixed) behind ``router_cls``; probed once, no prober
    thread, so both packages see the same events in the same order."""
    role = "decode" if disagg else "mixed"
    stubs = {n: StubReplica(n) for n in ("r0", "r1", "r2")}
    pool = pool_cls(probe_interval=0.1, fail_threshold=1,
                    readmit_passes=2, probe_timeout=2.0)
    for name, stub in stubs.items():
        pool.attach(name, stub.url, role=role)
    if disagg:
        stubs["p0"] = StubReplica("p0")
        pool.attach("p0", stubs["p0"].url, role="prefill")
    pool.probe_all()
    router = router_cls(pool, affinity_on=True, block=16, max_retries=2,
                        backoff_s=0.001, backoff_cap_s=0.005,
                        breaker_fails=3, retry_budget=0.5,
                        spill_cap=4, spill_max_wait_s=0.5)
    return stubs, pool, router.start_background()


def _counters(metrics: dict) -> dict:
    """The fleet counters of a router ``/metrics`` that the traffic
    decides (latencies, ports and pids left out)."""
    router = {k: v for k, v in metrics["router"].items() if k != "latency"}
    router["breakers"] = {
        n: {k: v for k, v in b.items() if k != "open_remaining_s"}
        for n, b in router.get("breakers", {}).items()}
    router["retry_budget"] = {  # the window's counts move with the clock
        k: v for k, v in router.get("retry_budget", {}).items()
        if not k.startswith("window_")}
    disagg = {k: v for k, v in metrics["fleet"]["disagg"].items()
              if k not in ("ship_ms_ewma", "util", "replicas")}
    pool = {n: {k: v for k, v in r.items() if k not in ("url", "pid")}
            for n, r in metrics["pool"].items()}
    return {"router": router, "disagg": disagg, "pool": pool,
            "sessions": metrics["fleet"]["sessions"],
            "routable": metrics["fleet"]["routable"]}


@pytest.mark.parametrize("disagg", [False, True], ids=["mixed", "split"])
def test_jax_and_port_routers_route_a_seeded_sequence_alike(disagg):
    """The same seeded sequence (heads shared by several requests,
    ``/invoke`` and ``/v1/completions``, three sessions, a replica killed
    midway) through a JAX router and the port's, each over its own twin
    stubs: every request lands on the same replica name, and the fleet
    counters of ``/metrics`` are equal."""
    import numpy as np

    rng = np.random.default_rng(20)
    heads = [rng.integers(1, 500, 48).tolist() for _ in range(4)]
    seq = []
    for i in range(36):
        body = {"tokens": heads[int(rng.integers(0, 4))]
                + rng.integers(1, 500, int(rng.integers(1, 20))).tolist(),
                "max_new_tokens": 2}
        kind = ("session", "completion", "plain")[i % 3]
        headers = {"x-session-id": f"s{int(rng.integers(0, 3))}"} \
            if kind == "session" else {}
        if kind == "completion":
            body = {"prompt": body["tokens"], "max_tokens": 2}
        seq.append(("/v1/completions" if kind == "completion"
                    else "/invoke", body, headers))
    landed, metrics = {}, {}
    for pkg, (pool_cls, router_cls) in {
            "jax": (JaxPool, JaxRouter),
            "port": (ReplicaPool, FleetRouter)}.items():
        stubs, pool, router = _stub_fleet(pool_cls, router_cls, disagg)
        base = f"http://127.0.0.1:{router.port}"
        try:
            names = []
            for i, (path, body, headers) in enumerate(seq):
                if i == 18:
                    stubs["r1"].kill()
                names.append(_post(base + path, body,
                                   headers=headers)["replica"])
            landed[pkg] = names
            metrics[pkg] = _counters(_get(base + "/metrics"))
        finally:
            router.stop()
            pool.close()
            for name, stub in stubs.items():
                if name != "r1":
                    stub.kill()
    assert landed["port"] == landed["jax"]
    assert len(set(landed["port"])) >= 2
    assert metrics["port"] == metrics["jax"]
    assert metrics["port"]["router"]["failovers"] >= 1
    assert metrics["port"]["pool"]["r1"]["state"] == EJECTED
    if disagg:
        assert metrics["port"]["disagg"]["ships"] >= 1


# -- the CLI's fleet as a process --------------------------------------------


def _fleet_env(home: Path) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("LAMBDIPY_PLATFORM", "LAMBDIPY_FLEET_FAULT")}
    env["HOME"] = str(home)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(Path(__file__).resolve().parents[1])]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    return env


def _alive(pid: int) -> bool:
    try:
        state = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1]
    except OSError:
        return False
    return state.split()[0] not in ("Z", "X")


@pytest.fixture(scope="module")
def cli_bundle(tmp_path_factory):
    return make_model_bundle(
        tmp_path_factory.mktemp("fleet-cli"), model="llama-tiny",
        handler="lambdipy_tpu.runtime.handlers:generate_handler",
        extra={"max_new_tokens": "4"})


def test_fleet_cli_on_the_cpu_serves_and_stops_every_replica(cli_bundle,
                                                             tmp_path):
    """``fleet <bundle> --replicas 2 --device cpu``: JAX's readiness line,
    an ``/invoke`` through the router equal to a replica's own answer,
    and SIGTERM: exit 0, no replica or supervisor process left, the
    deployments file empty."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "lambdipy_tpu_torch", "fleet",
         str(cli_bundle), "--replicas", "2", "--port", "0", "--name", "cli",
         "--probe-interval", "0.2", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=_fleet_env(tmp_path), start_new_session=True)
    pids = []
    try:
        ready = json.loads(proc.stdout.readline())
        assert ready["ready"] and ready["replicas"] == 2
        assert ready["classes"] == {"cli-r0": "mixed", "cli-r1": "mixed"}
        assert set(ready) >= {"port", "prefill_replicas", "attached",
                              "affinity", "block", "spill_cap",
                              "breaker_fails", "retry_budget", "autoscale",
                              "autoscale_dry_run", "slo_p99_ms", "urls"}
        base = f"http://127.0.0.1:{ready['port']}"
        body = {"tokens": [5, 17, 3, 99], "max_new_tokens": 4}
        out = _post(base + "/invoke", body)
        direct = _post(ready["urls"]["cli-r0"] + "/invoke", body)
        assert out["ok"] and out["tokens"] == direct["tokens"]
        state = json.loads((tmp_path / ".lambdipy-tpu-torch"
                            / "deployments.json").read_text())
        pids = [d["pid"] for d in state.values()]
        pids += [_get(u + "/healthz")["pid"] for u in ready["urls"].values()]
        assert _get(base + "/healthz")["routable"] == 2
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(120) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
    deadline = time.monotonic() + 10
    while any(_alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert len(pids) == 4 and not any(_alive(p) for p in pids)
    assert json.loads((tmp_path / ".lambdipy-tpu-torch"
                       / "deployments.json").read_text()) == {}


def test_fleet_without_a_card_exits_before_its_readiness_line(cli_bundle,
                                                              tmp_path):
    """No card (none visible) and no ``--device cpu``: ``fleet`` exits
    non-zero with deploy's error before any readiness line, and leaves
    no replica behind."""
    env = _fleet_env(tmp_path)
    env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run(
        [sys.executable, "-m", "lambdipy_tpu_torch", "fleet",
         str(cli_bundle), "--replicas", "2", "--port", "0"],
        capture_output=True, text=True, env=env, timeout=120)
    assert res.returncode != 0 and "ready" not in res.stdout
    assert "no CUDA device" in res.stderr
    state = tmp_path / ".lambdipy-tpu-torch" / "deployments.json"
    assert not state.exists() or json.loads(state.read_text()) == {}


# -- the port's spawn of a whole fleet at once -------------------------------


class _FakeRuntime:
    """``LocalRuntime``'s deploy and stop over stub replicas: each deploy
    sleeps its own time (so they finish out of order), ``fail`` names
    the one that raises."""

    def __init__(self, fail=None):
        self.fail, self.stopped, self.stubs = fail, [], {}
        self.lock = threading.Lock()

    def deploy(self, name, bundle_dir, *, ready_timeout, env, device):
        from lambdipy_tpu_torch.runtime.deploy import DeployError, Deployment

        time.sleep({"f-r0": 1.2, "f-r1": 0.4, "f-p0": 0.8}.get(name, 0.0))
        if name == self.fail:
            raise DeployError(f"server for {name!r} exited before ready")
        stub = StubReplica(name)
        with self.lock:
            self.stubs[name] = stub
        return Deployment(name=name, bundle_dir=str(bundle_dir), pid=1,
                          port=stub.port, cold_start={})

    def stop(self, name, grace=5.0):
        with self.lock:
            self.stopped.append(name)
            self.stubs.pop(name).kill()


SPECS = [("f-r0", "decode"), ("f-r1", "decode"), ("f-p0", "prefill")]


def test_spawn_all_registers_in_the_order_given():
    """The replicas deploy at once and register in the order of the
    specs (JAX's r0..rN-1, p0..pM-1), managed, probed and routable,
    whatever order their deploys finished in."""
    rt = _FakeRuntime()
    pool = ReplicaPool()
    try:
        t0 = time.monotonic()
        got = pool.spawn_all(Path("/nowhere"), SPECS, runtime=rt,
                             env={"A": "1"}, device="cpu")
        assert time.monotonic() - t0 < 2.0  # at once, not 2.4 s in turn
        assert [r.name for r in got] == [n for n, _ in SPECS]
        assert list(pool.replicas) == [n for n, _ in SPECS]
        assert [r.role for r in got] == [c for _, c in SPECS]
        assert all(r.managed and r.routable and r.pid == 1000 for r in got)
        assert got[0].spawn_env == {"A": "1"} and got[0].spawn_device == "cpu"
    finally:
        pool.close()
        for name in list(rt.stubs):
            rt.stop(name)


def test_spawn_all_stops_the_others_when_one_fails():
    """One replica fails to boot: the error is raised after the others
    came up and were stopped, and none is registered."""
    from lambdipy_tpu_torch.runtime.deploy import DeployError

    rt = _FakeRuntime(fail="f-r1")
    pool = ReplicaPool()
    with pytest.raises(DeployError, match="f-r1"):
        pool.spawn_all(Path("/nowhere"), SPECS, runtime=rt)
    assert sorted(rt.stopped) == ["f-p0", "f-r0"] and not rt.stubs
    assert pool.replicas == {}


def test_spawn_fleet_deploys_its_replicas_at_once():
    """``spawn_fleet`` names its replicas as JAX's does (``<base>-r<i>``)
    and deploys them through ``spawn_all``: together, one role."""
    rt = _FakeRuntime()
    pool = ReplicaPool()
    try:
        t0 = time.monotonic()
        got = pool.spawn_fleet(Path("/nowhere"), 2, base_name="f",
                               runtime=rt, role="decode")
        assert time.monotonic() - t0 < 1.5  # at once, not 1.6 s in turn
        assert [r.name for r in got] == ["f-r0", "f-r1"]
        assert all(r.managed and r.role == "decode" for r in got)
    finally:
        pool.close()
        for name in list(rt.stubs):
            rt.stop(name)


_STATE_WRITER = """
import sys, time
from pathlib import Path
from lambdipy_tpu_torch.runtime.deploy import LocalRuntime
rt = LocalRuntime(Path(sys.argv[1]))
for i in range(5):
    with rt._state_lock():
        state = rt._load()
        time.sleep(0.01)  # a read-modify-write that others would overlap
        state[f"{sys.argv[2]}-{i}"] = {"i": i}
        rt._save(state)
"""


def test_the_deployment_state_is_locked_across_processes(tmp_path):
    """Deploys and stops in several processes (a ``deploy`` beside a
    ``fleet``) share one state file: each read-modify-write holds its
    ``flock``, so no process's entry is lost."""
    path = tmp_path / "deployments.json"
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(Path(__file__).resolve().parents[1]),
         os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen([sys.executable, "-c", _STATE_WRITER,
                               str(path), f"p{j}"], env=env)
             for j in range(4)]
    assert [p.wait(timeout=60) for p in procs] == [0] * 4
    assert len(json.loads(path.read_text())) == 20
