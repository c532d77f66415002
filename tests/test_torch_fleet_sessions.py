"""The port's sticky sessions, the twin of ``tests/test_fleet_sessions.py``:
sticky routing, failover with its re-ship, the drain re-ship and the
import-miss pull, on the JAX tests' scriptable stub replicas. Then end
to end on the CPU: ``llama-tiny`` replicas of both packages on the same
weights (one bundle, booted by each package's server), a fleet of a
prefill-class and two decode-class in-process replicas behind each
package's router: an affinity hit, a ship, a session failover and a
``kv_ship`` fault fallback give the JAX fleet's greedy tokens, the
logprobs within the port's serve tests' f32 bound."""

import json
import urllib.request

import pytest

from lambdipy_tpu_torch.fleet import (
    EJECTED,
    READY,
    FleetRouter,
    ReplicaPool,
    affinity,
)
from lambdipy_tpu_torch.fleet.pool import DECODE, PREFILL
from lambdipy_tpu_torch.runtime.faults import FaultPlan

from test_fleet import StubReplica, _get, _post


@pytest.fixture()
def stub_pair():
    s0, s1 = StubReplica("r0"), StubReplica("r1")
    pool = ReplicaPool(probe_interval=5.0, fail_threshold=1,
                       readmit_passes=2, probe_timeout=2.0)
    pool.attach("r0", s0.url)
    pool.attach("r1", s1.url)
    pool.probe_all()
    yield s0, s1, pool
    pool.close()
    for s in (s0, s1):
        try:
            s.kill()
        except Exception:
            pass


def _router(pool, **kw):
    kw.setdefault("affinity_on", True)
    kw.setdefault("block", 4)
    return FleetRouter(pool, **kw).start_background()


def _turn(base, sid, row, **kw):
    return _post(f"{base}/invoke",
                 {"tokens": row, "max_new_tokens": 2,
                  "session_id": sid, **kw})


# -- stickiness ---------------------------------------------------------------


def test_session_turns_route_sticky(stub_pair):
    """Every turn of one session lands on the first turn's replica even
    as the prompt (and thus the prefix key) grows and changes."""
    s0, s1, pool = stub_pair
    router = _router(pool)
    try:
        base = f"http://127.0.0.1:{router.port}"
        row = list(range(1, 13))
        home = _turn(base, "conv-1", row)["replica"]
        for turn in range(3):
            row = row + [50 + turn] * 6  # history grows every turn
            out = _turn(base, "conv-1", row)
            assert out["replica"] == home, f"turn {turn} moved"
        rep = router.metrics()["fleet"]["sessions"]
        assert rep["opened"] == 1 and rep["active"] == 1
        assert rep["sticky_hits"] == 3 and rep["failovers"] == 0
        assert _get(f"{base}/healthz")["sessions"] == 1
    finally:
        router.stop()


def test_session_header_spelling_is_sticky_too(stub_pair):
    s0, s1, pool = stub_pair
    router = _router(pool)
    try:
        base = f"http://127.0.0.1:{router.port}"
        row = list(range(1, 13))
        homes = set()
        for _ in range(3):
            out = _post(f"{base}/invoke",
                        {"tokens": row, "max_new_tokens": 2},
                        headers={"x-session-id": "hdr-conv"})
            homes.add(out["replica"])
            assert out["session"] == "hdr-conv"  # header forwarded
        assert len(homes) == 1
    finally:
        router.stop()


def test_session_id_body_wins_over_header_like_the_replica(stub_pair):
    """Router and replica must resolve one id for one request: the
    BODY field wins on both layers (server._session_header does the
    same), or a DELETE through the router would release nothing while
    the replica's pins live on under the other id."""
    s0, s1, pool = stub_pair
    router = _router(pool)
    try:
        base = f"http://127.0.0.1:{router.port}"
        row = list(range(1, 13))
        _post(f"{base}/invoke",
              {"tokens": row, "max_new_tokens": 2,
               "session_id": "body-id"},
              headers={"x-session-id": "header-id"})
        assert "body-id" in router._session_map
        assert "header-id" not in router._session_map
    finally:
        router.stop()


def test_unknown_session_falls_back_to_prefix_affinity(stub_pair):
    """REGRESSION (router restart): a session id the router has never
    seen must place by NORMAL prefix affinity over the body — the same
    replica a session-less request would get — not by a hash of the
    session id, which would scatter the first post-restart turn away
    from the replica whose radix cache still holds the conversation."""
    s0, s1, pool = stub_pair
    row = list(range(1, 21))
    key = affinity.prefix_key({"tokens": row}, block=4)
    expected = affinity.pick_replica(key, ["r0", "r1"])
    # the "restarted" router: fresh instance, empty session map, but a
    # session id that looks mid-conversation
    router = _router(pool)
    try:
        base = f"http://127.0.0.1:{router.port}"
        out = _turn(base, "pre-restart-conv", row)
        assert out["replica"] == expected
        # ...and had the sticky path hashed the bare session id instead,
        # it could have landed elsewhere: prove the keys differ
        assert affinity.session_key("pre-restart-conv") != key
        rep = router.metrics()["fleet"]["sessions"]
        assert rep["opened"] == 1  # recorded AFTER the serve
    finally:
        router.stop()


# -- failover -----------------------------------------------------------------


def test_failover_dead_home_reprefills_counted(stub_pair):
    """The SIGKILL case: the home dies, the pool ejects it, the next
    turn re-homes via rendezvous over the survivors and serves — the
    re-ship fails (old home unreachable: its KV died with the worker)
    and is COUNTED, the turn itself never errors."""
    s0, s1, pool = stub_pair
    router = _router(pool)
    try:
        base = f"http://127.0.0.1:{router.port}"
        row = list(range(1, 13))
        home = _turn(base, "conv-k", row)["replica"]
        victim = s0 if home == "r0" else s1
        survivor = "r1" if home == "r0" else "r0"
        victim.kill()
        pool.probe_all()  # fail_threshold=1: ejected now
        assert pool.replicas[home].state == EJECTED
        out = _turn(base, "conv-k", row + [99] * 4)
        assert out["ok"] and out["replica"] == survivor
        rep = router.metrics()["fleet"]["sessions"]
        assert rep["failovers"] == 1 and rep["reships"] == 0
        assert rep["reship_fallbacks"].get("old_home_unreachable") == 1
        # sticky on the NEW home afterwards
        assert _turn(base, "conv-k", row + [99] * 8)["replica"] == \
            survivor
        assert router.metrics()["fleet"]["sessions"]["failovers"] == 1
    finally:
        router.stop()


def test_failover_reachable_home_reships_kv(stub_pair):
    """The drain/eject-but-alive case: the session's whole-block head
    re-ships from the old home (export) into the new one (import)
    before the turn forwards."""
    s0, s1, pool = stub_pair
    router = _router(pool)
    try:
        base = f"http://127.0.0.1:{router.port}"
        row = list(range(1, 13))
        home = _turn(base, "conv-r", row)["replica"]
        old = s0 if home == "r0" else s1
        new = s1 if home == "r0" else s0
        pool.replicas[home].state = EJECTED  # drain stand-in; stub lives
        out = _turn(base, "conv-r", row + [7] * 4)
        assert out["ok"] and out["replica"] != home
        assert old.exports == 1  # export leg hit the OLD home
        assert new.imports == [old.cfg["kv_frame"]]  # import leg landed
        # the export asked for the conversation's whole-block head —
        # INCLUDING this turn's extension (the sticky check updates the
        # head before the failover runs)
        export_body = [b for p, b in old.bodies
                       if p == "/v1/kv/export"][0]
        assert export_body["tokens"] == row + [7] * 4
        rep = router.metrics()["fleet"]["sessions"]
        assert rep["failovers"] == 1 and rep["reships"] == 1
        assert rep["reship_fallbacks"] == {}
    finally:
        router.stop()


def test_failover_clears_session_ship_dedup(stub_pair):
    """A failover forgets the session's prefix in the per-replica
    ship-dedup LRU — a stale entry on the new home would otherwise skip
    exactly the re-ship the failover exists to do — and a SUCCESSFUL
    re-ship re-marks the NEW home only (the blocks really are there
    now; the old home's entry stays gone)."""
    s0, s1, pool = stub_pair
    router = _router(pool)
    try:
        base = f"http://127.0.0.1:{router.port}"
        row = list(range(1, 13))
        key = affinity.prefix_key({"tokens": row, "max_new_tokens": 2,
                                   "session_id": "conv-d"},
                                  block=4)
        home = _turn(base, "conv-d", row)["replica"]
        other = "r1" if home == "r0" else "r0"
        # poison both dedup maps with the session's prefix key
        with router._ship_lock:
            from collections import OrderedDict
            for name in (home, other):
                router._shipped.setdefault(
                    name, OrderedDict())[key] = True
        pool.replicas[home].state = EJECTED
        _turn(base, "conv-d", row + [3] * 4)
        assert router.metrics()["fleet"]["sessions"]["reships"] == 1
        with router._ship_lock:
            assert key not in router._shipped.get(home, {})
            # re-marked on the new home by the successful re-ship;
            # note the session head GREW this turn, so the new home is
            # marked under the session's ORIGINAL key
            assert key in router._shipped.get(other, {})
    finally:
        router.stop()


def test_session_failover_fault_site(stub_pair):
    """An injected session_failover fault skips the re-ship (counted)
    but the turn still serves on the new home."""
    s0, s1, pool = stub_pair
    router = _router(pool, faults=FaultPlan.from_spec(
        "session_failover:exception@seg=1,n=1"))
    try:
        base = f"http://127.0.0.1:{router.port}"
        row = list(range(1, 13))
        home = _turn(base, "conv-f", row)["replica"]
        pool.replicas[home].state = EJECTED
        out = _turn(base, "conv-f", row + [5] * 4)
        assert out["ok"] and out["replica"] != home
        rep = router.metrics()["fleet"]["sessions"]
        assert rep["reship_fallbacks"].get("failover_fault") == 1
        assert rep["reships"] == 0
        s_old = s0 if home == "r0" else s1
        assert s_old.exports == 0  # the fault fired before the legs
    finally:
        router.stop()


def test_session_delete_fans_out_and_drops_record(stub_pair):
    s0, s1, pool = stub_pair
    router = _router(pool)
    try:
        base = f"http://127.0.0.1:{router.port}"
        _turn(base, "conv-del", list(range(1, 13)))
        assert len(router._session_map) == 1
        req = urllib.request.Request(f"{base}/v1/sessions/conv-del",
                                     method="DELETE")
        with urllib.request.urlopen(req, timeout=10) as r:
            out = json.loads(r.read())
        assert out["ok"] and set(out["replicas"]) == {"r0", "r1"}
        assert s0.deletes == ["conv-del"] and s1.deletes == ["conv-del"]
        assert len(router._session_map) == 0
        assert router.metrics()["fleet"]["sessions"]["deletes"] == 1
    finally:
        router.stop()


def test_sticky_home_respects_saturation_valve(stub_pair):
    """A sticky home past the outstanding threshold spills the turn to
    the other replica — a replica hosting hot sessions must not melt
    while the fleet idles. The session re-homes (self-heal)."""
    s0, s1, pool = stub_pair
    router = _router(pool, saturation=2)
    try:
        base = f"http://127.0.0.1:{router.port}"
        row = list(range(1, 13))
        home = _turn(base, "conv-sat", row)["replica"]
        other = "r1" if home == "r0" else "r0"
        pool.replicas[home].outstanding = 2  # at the threshold
        try:
            out = _turn(base, "conv-sat", row + [9] * 4)
        finally:
            pool.replicas[home].outstanding = 0
        assert out["replica"] == other
        # self-healed: the serving replica is the new home
        assert router._session_map["conv-sat"]["home"] == other
        assert router.metrics()["fleet"]["sessions"][
            "sticky_misses"] >= 1
    finally:
        router.stop()


# -- import-miss pull (disaggregated fleets) ----------------------------------


@pytest.fixture()
def disagg_pair():
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


def test_phase_split_ships_to_sticky_home_after_failover():
    """Under disaggregation, a failed-over session's ship must land on
    the session's NEW home (session-key rendezvous), not the prefix-key
    rendezvous pick — otherwise every turn warms the wrong replica and
    the home re-prefills locally anyway."""
    decs = {"dec0": StubReplica("dec0"), "dec1": StubReplica("dec1")}
    pre = StubReplica("pre")
    pool = ReplicaPool(probe_interval=5.0, fail_threshold=1,
                       readmit_passes=2, probe_timeout=2.0)
    for n, s in decs.items():
        pool.attach(n, s.url, role=DECODE)
    pool.attach("pre", pre.url, role=PREFILL)
    pool.probe_all()
    router = _router(pool)
    try:
        base = f"http://127.0.0.1:{router.port}"
        row = list(range(1, 13))
        home = _turn(base, "conv-ship", row)["replica"]
        other = "dec1" if home == "dec0" else "dec0"
        assert len(decs[home].imports) == 1  # turn-1 ship landed home
        # failover: the home drops out, the session re-homes + re-ships
        pool.replicas[home].state = EJECTED
        out = _turn(base, "conv-ship", row + [7] * 4)
        assert out["replica"] == other
        assert router.metrics()["fleet"]["sessions"]["reships"] == 1
        imports_after_failover = len(decs[other].imports)
        assert imports_after_failover >= 1  # the re-ship import landed
        # the OLD home comes back: prefix-key rendezvous would pick it
        # again, but the session stays sticky on the new home — and the
        # ship must follow the sticky target
        pool.replicas[home].state = READY
        exports_before = pre.exports
        out = _turn(base, "conv-ship", row + [7] * 8)
        assert out["replica"] == other
        # no NEW import on the old home, and any fresh ship (the head
        # grew a block) lands on the sticky home
        assert len(decs[home].imports) == 1
        if pre.exports > exports_before:
            assert len(decs[other].imports) > imports_after_failover
    finally:
        router.stop()
        pool.close()
        for s in list(decs.values()) + [pre]:
            try:
                s.kill()
            except Exception:
                pass


def test_stale_dedup_probes_and_pulls(disagg_pair):
    """A dedup hit whose blocks vanished on the decode replica (arena
    reset) PULLS them back through the normal ship legs instead of
    silently re-prefilling locally — counted as pull_hit."""
    dec, pre, pool = disagg_pair
    router = _router(pool)
    try:
        base = f"http://127.0.0.1:{router.port}"
        row = list(range(1, 13))
        _post(f"{base}/invoke", {"tokens": row, "max_new_tokens": 2})
        assert pre.exports == 1 and len(dec.imports) == 1
        # dedup intact + blocks present: skip, no second ship
        _post(f"{base}/invoke", {"tokens": row, "max_new_tokens": 2})
        assert pre.exports == 1 and dec.probes == 1
        assert router.disagg.report()["ship_skips"] == 1
        # the decode replica's arena reset: probe says the head is gone
        dec.cfg["kv_probe_matched"] = 0
        _post(f"{base}/invoke", {"tokens": row, "max_new_tokens": 2})
        assert pre.exports == 2 and len(dec.imports) == 2
        rep = router.disagg.report()
        assert rep["fallbacks"].get("pull_hit") == 1
        assert "pull_failed" not in rep["fallbacks"]
    finally:
        router.stop()


def test_pull_failure_counts_pull_failed(disagg_pair):
    """When the pull's export leg sheds, the request still serves
    mixed-mode and BOTH the specific reason and pull_failed count."""
    dec, pre, pool = disagg_pair
    router = _router(pool)
    try:
        base = f"http://127.0.0.1:{router.port}"
        row = list(range(1, 13))
        _post(f"{base}/invoke", {"tokens": row, "max_new_tokens": 2})
        dec.cfg["kv_probe_matched"] = 0
        pre.cfg["shed"] = True  # export leg 503s
        out = _post(f"{base}/invoke", {"tokens": row,
                                       "max_new_tokens": 2})
        assert out["ok"] and out["replica"] == "dec"
        rep = router.disagg.report()
        assert rep["fallbacks"].get("pull_failed") == 1
        assert rep["fallbacks"].get("export_shed") == 1
    finally:
        router.stop()


# -- proactive re-ship on drain ----------------------------------------------


def test_drain_reships_session_proactively():
    """begin_drain on a session's home moves the pinned head to its
    rendezvous successor THROUGH the ship legs before any /shutdown —
    the next turn pays a sticky hit on the new home, not a failover."""
    stubs = {n: StubReplica(n) for n in ("r0", "r1", "r2")}
    pool = ReplicaPool(probe_interval=5.0, fail_threshold=1,
                       readmit_passes=2, probe_timeout=2.0)
    for n, s in stubs.items():
        pool.attach(n, s.url)
    pool.probe_all()
    router = _router(pool)
    try:
        base = f"http://127.0.0.1:{router.port}"
        row = list(range(1, 13))
        home = _turn(base, "conv-drain", row)["replica"]
        # stubs attach unmanaged; the drain contract is managed-only —
        # flip the flag so begin_drain accepts the stand-in
        pool.replicas[home].managed = True
        pool.begin_drain(home)  # fires the on_drain hook synchronously
        rep = router.metrics()["fleet"]["sessions"]
        assert rep["drain_reships"] == 1
        assert rep["reship_fallbacks"] == {}
        assert rep["failovers"] == 0  # proactive, not turn-time
        assert stubs[home].exports == 1  # export hit the DRAINING home
        importers = [n for n in stubs
                     if n != home and stubs[n].imports]
        assert len(importers) == 1
        new_home = importers[0]
        assert stubs[new_home].imports == [stubs[home].cfg["kv_frame"]]
        # the very next turn lands sticky on the new home — no
        # failover, no re-prefill detour through the sticky-miss path
        out = _turn(base, "conv-drain", row + [9] * 4)
        assert out["replica"] == new_home
        rep = router.metrics()["fleet"]["sessions"]
        assert rep["failovers"] == 0 and rep["sticky_hits"] >= 1
    finally:
        router.stop()
        pool.close()
        for s in stubs.values():
            try:
                s.kill()
            except Exception:
                pass


def test_drain_reship_failure_leaves_turn_time_failover():
    """A failed drain re-ship (successor import shedding) must NOT
    re-home the record: the next turn takes the normal failover path
    and still serves."""
    stubs = {n: StubReplica(n) for n in ("r0", "r1")}
    pool = ReplicaPool(probe_interval=5.0, fail_threshold=1,
                       readmit_passes=2, probe_timeout=2.0)
    for n, s in stubs.items():
        pool.attach(n, s.url)
    pool.probe_all()
    router = _router(pool)
    try:
        base = f"http://127.0.0.1:{router.port}"
        row = list(range(1, 13))
        home = _turn(base, "conv-drain2", row)["replica"]
        other = next(n for n in stubs if n != home)
        stubs[other].cfg["kv_shed"] = True  # successor arena "full"
        pool.replicas[home].managed = True
        pool.begin_drain(home)
        rep = router.metrics()["fleet"]["sessions"]
        assert rep["drain_reships"] == 0
        assert rep["reship_fallbacks"].get("import_backpressure") == 1
        # the record still points at the draining home, so the next
        # turn fails over (and serves) through the turn-time path
        stubs[other].cfg["kv_shed"] = False
        out = _turn(base, "conv-drain2", row + [9] * 4)
        assert out["ok"] and out["replica"] == other
        rep = router.metrics()["fleet"]["sessions"]
        assert rep["failovers"] == 1
    finally:
        router.stop()
        pool.close()
        for s in stubs.values():
            try:
                s.kill()
            except Exception:
                pass


def test_idle_session_records_expire_by_router_ttl(stub_pair):
    """The router's sticky records honor an idle TTL (chaos-soak find:
    replica-side pin LEASES expire on their own, but a router record
    only ever died by cap pressure or DELETE, so the fleet session
    gauge drifted from the real pinned state). A scrape alone runs the
    lazy sweep; a fresh turn under the same id re-opens cleanly."""
    s0, s1, pool = stub_pair
    router = _router(pool, session_record_ttl_s=1.0)
    try:
        base = f"http://127.0.0.1:{router.port}"
        row = list(range(1, 13))
        _turn(base, "idle-conv", row)
        rep = router.metrics()["fleet"]["sessions"]
        assert rep["active"] == 1 and rep["record_expiries"] == 0
        import time as _time

        _time.sleep(1.2)
        rep = router.metrics()["fleet"]["sessions"]
        assert rep["active"] == 0, "idle record survived its TTL"
        assert rep["record_expiries"] == 1
        assert _get(f"{base}/healthz")["sessions"] == 0
        # the session is not broken, just unsticky: the next turn
        # places by prefix affinity and re-opens the record
        _turn(base, "idle-conv", row)
        rep = router.metrics()["fleet"]["sessions"]
        assert rep["active"] == 1 and rep["opened"] == 2
    finally:
        router.stop()


def test_active_session_records_survive_the_ttl_sweep(stub_pair):
    """Touching a session (any turn) refreshes its record's clock: only
    IDLE records expire — a live conversation's stickiness must never
    lapse underneath it."""
    s0, s1, pool = stub_pair
    router = _router(pool, session_record_ttl_s=1.0)
    try:
        import time as _time

        base = f"http://127.0.0.1:{router.port}"
        row = list(range(1, 13))
        home = _turn(base, "live-conv", row)["replica"]
        for _ in range(3):  # turns keep arriving inside the TTL
            _time.sleep(0.5)
            row = row + [7] * 4
            assert _turn(base, "live-conv", row)["replica"] == home
        rep = router.metrics()["fleet"]["sessions"]
        assert rep["active"] == 1 and rep["record_expiries"] == 0
    finally:
        router.stop()


# -- end to end on the CPU: llama-tiny fleets of both packages ----------------

E2E_EXTRA = {"batch_mode": "continuous", "batch_max": "4",
             "batch_segment": "4", "kv_paged": "1", "prefix_cache_mb": "8",
             "prefix_block": "16", "max_new_tokens": "6",
             "warm_group_prefill": "0"}
E2E_BLOCK = 16
# f32 across the frameworks (tests/test_torch_kvship.py, test_torch_bundle.py)
E2E_LP_TOL = 1e-4


def _e2e_rows():
    import numpy as np

    rng = np.random.default_rng(31)

    def draw(n):
        return [int(t) for t in rng.integers(1, 500, n)]

    head = draw(48)  # three whole blocks
    return {"head": head, "tails": [draw(5), draw(9)],
            "fault_head": draw(48) + draw(3),
            "users": [draw(6), draw(6)]}


def _e2e_scenario(router, pool, servers, rows) -> dict:
    """One fleet's run: two requests on one head (a ship, then an
    affinity hit), a fault-armed ship falling back to mixed, then a
    two-turn session whose home is stopped between the turns."""
    base = f"http://127.0.0.1:{router.port}"
    out = {"rows": []}

    def send(body, headers=None):
        r = _post(f"{base}/invoke", {**body, "max_new_tokens": 6,
                                      "logprobs": True}, headers=headers)
        assert r["ok"], r
        out["rows"].append((r["tokens"][0], r["logprobs"][0]))
        return r

    def routed():
        return {n: r.routed for n, r in pool.replicas.items()}

    before = routed()
    for tail in rows["tails"]:
        send({"tokens": rows["head"] + tail})
    after = routed()
    out["landed"] = sorted(n for n in after if after[n] > before[n])
    out["disagg_ship"] = router.disagg.report()
    router.faults.arm("kv_ship:exception@n=1")
    send({"tokens": rows["fault_head"]})
    out["disagg_fault"] = router.disagg.report()
    prompt = rows["head"] + rows["users"][0]
    before = routed()
    first = send({"tokens": prompt}, {"x-session-id": "e2e"})
    after = routed()
    home = next(n for n in after if after[n] > before[n])
    servers[home].stop()
    pool.probe_all()
    out["home_state"] = pool.replicas[home].state
    prompt = prompt + first["tokens"][0] + rows["users"][1]
    before = routed()
    send({"tokens": prompt}, {"x-session-id": "e2e"})
    after = routed()
    out["home"] = home
    out["failover_to"] = [n for n in after if after[n] > before[n]]
    out["sessions"] = router.metrics()["fleet"]["sessions"]
    return out


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    """The same ``llama-tiny`` bundle served by three in-process replicas
    of each package (``p0`` prefill-class, ``d0``/``d1`` decode-class)
    behind each package's router; both scenarios run, and the port
    replicas' and a JAX replica's ``/metrics`` are kept for the
    snapshot test."""
    from test_runtime import make_model_bundle

    from lambdipy_tpu.fleet import FleetRouter as JaxRouter
    from lambdipy_tpu.fleet import ReplicaPool as JaxPool
    from lambdipy_tpu.runtime.server import BundleServer as JaxServer
    from lambdipy_tpu_torch.runtime.server import BundleServer

    bundle = make_model_bundle(
        tmp_path_factory.mktemp("fleet-e2e"), model="llama-tiny",
        handler="lambdipy_tpu.runtime.handlers:generate_handler",
        extra=E2E_EXTRA)
    rows = _e2e_rows()
    roles = {"p0": PREFILL, "d0": DECODE, "d1": DECODE}
    boot = {"jax": lambda: JaxServer(bundle, port=0, warmup=False),
            "port": lambda: BundleServer.from_bundle(bundle, device="cpu",
                                                     warmup=False)}
    fleets = {"jax": (JaxPool, JaxRouter), "port": (ReplicaPool, FleetRouter)}
    results, metrics = {}, {}
    for pkg, (pool_cls, router_cls) in fleets.items():
        servers = {n: boot[pkg]().start_background() for n in roles}
        pool = pool_cls(probe_interval=60.0, fail_threshold=1,
                        readmit_passes=2, probe_timeout=5.0)
        for name, role in roles.items():
            pool.attach(name, f"http://127.0.0.1:{servers[name].port}",
                        role=role)
        pool.probe_all()
        router = router_cls(pool, affinity_on=True, block=E2E_BLOCK,
                            max_retries=2, backoff_s=0.01,
                            backoff_cap_s=0.05).start_background()
        try:
            metrics[pkg] = {n: _get(f"http://127.0.0.1:{s.port}/metrics")
                            for n, s in servers.items()}
            results[pkg] = _e2e_scenario(router, pool, servers, rows)
            metrics[pkg] = router.metrics()
        finally:
            router.stop()
            pool.close()
            for srv in servers.values():
                try:
                    srv.stop(drain_grace=1.0)
                except Exception:  # noqa: BLE001 — the failover's victim
                    pass
    return results, metrics


def test_e2e_affinity_hit_and_ship(e2e):
    """Two requests on one head land on one decode replica: the first
    ships the head from the prefill replica, the second skips the ship,
    as in JAX's fleet."""
    results, _ = e2e
    for pkg in ("jax", "port"):
        r = results[pkg]
        assert len(r["landed"]) == 1 and r["landed"][0].startswith("d"), pkg
        assert r["disagg_ship"]["ships"] == 1
        assert r["disagg_ship"]["decode_dispatches"] == 1
        assert r["disagg_ship"]["ship_skips"] == 1
        assert r["disagg_ship"]["imports_zero_copy"] == 1
    assert results["port"]["landed"] == results["jax"]["landed"]


def test_e2e_kv_ship_fault_falls_back_to_mixed(e2e):
    """An armed ``kv_ship`` fault: the request serves mixed on its decode
    replica, counted under ``ship_fault`` in both fleets."""
    results, _ = e2e
    for pkg in ("jax", "port"):
        fault = results[pkg]["disagg_fault"]
        assert fault["fallbacks"] == {"ship_fault": 1}, pkg
        assert fault["ships"] == 1


def test_e2e_session_fails_over_off_a_stopped_home(e2e):
    """The session's home stops between its turns: the pool ejects it, the
    second turn fails over to the other decode replica (counted), in
    both fleets alike."""
    results, _ = e2e
    for pkg in ("jax", "port"):
        r = results[pkg]
        assert r["home_state"] == EJECTED
        assert r["failover_to"] and r["failover_to"] != [r["home"]]
        assert r["failover_to"][0].startswith("d")
        assert r["sessions"]["failovers"] == 1
    assert results["port"]["home"] == results["jax"]["home"]
    assert results["port"]["failover_to"] == results["jax"]["failover_to"]


def test_e2e_greedy_tokens_are_the_jax_fleets(e2e):
    """Every request of the scenario: the port fleet's greedy tokens equal
    the JAX fleet's, the logprobs within the f32 bound."""
    results, _ = e2e
    port, jax = results["port"]["rows"], results["jax"]["rows"]
    assert len(port) == len(jax) == 5
    for (pt, pl), (jt, jl) in zip(port, jax):
        assert pt == jt
        assert max(abs(a - b) for a, b in zip(pl, jl)) <= E2E_LP_TOL


def test_e2e_snapshot_leaves_jaxs_fields_none(e2e):
    """The controller's snapshot over each fleet's ``/metrics`` after the
    traffic: the fields a port replica leaves None are those a JAX
    replica of the same bundle leaves None (no speculative decoding and
    no long-context tier in this configuration), and the pipeline's
    signals are present."""
    from types import SimpleNamespace

    from lambdipy_tpu.fleet import FleetController as JaxController
    from lambdipy_tpu.fleet import ReplicaPool as JaxPool
    from lambdipy_tpu_torch.fleet import FleetController

    _, metrics = e2e
    nones = {}
    for pkg, pool_cls, ctl_cls in (("jax", JaxPool, JaxController),
                                   ("port", ReplicaPool, FleetController)):
        pool = pool_cls()
        for name in ("d0", "d1", "p0"):
            pool.attach(name, "http://127.0.0.1:9",
                        role=PREFILL if name == "p0" else DECODE)
        router = SimpleNamespace(pool=pool, ship_window=4, controller=None)
        snap = ctl_cls(router, dry_run=True).build_snapshot(metrics[pkg])
        nones[pkg] = {v.name: sorted(k for k, x in vars(v).items()
                                     if x is None) for v in snap.replicas}
    assert nones["port"] == nones["jax"]
    served = [n for n, m in metrics["port"]["replicas"].items()
              if (((m or {}).get("handler") or {}).get("batching") or {})
              .get("pipeline", {}).get("wall_s")]
    assert served
    for name in served:
        assert not {"pipeline_depth", "overlap_ratio", "fetch_frac"} \
            & set(nones["port"][name])
