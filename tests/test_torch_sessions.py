"""Session pins of the port's prefix store (``lambdipy_tpu_torch/runtime/
prefixstore.py``) and the server's session surface, the twins of
``tests/test_sessions.py`` on ``llama-tiny`` (f32) on the CPU: pin, renew
and release with the gauges; pins surviving LRU pressure and left out of
the cold-page reclaim; the priced shed at the pin budget and the budget's
clamp; TTL and idle leases; the ``session_pin`` fault failing open; a
pin/unpin churn fuzz with the invariants checked; the store's counters
equal the JAX store's op for op on one seeded sequence; pins surviving an
engine failure and a wedge (a difference by design: the port's arena is
never reset); the handler's extras and ``session_id``; the headers,
``DELETE /v1/sessions/{id}`` and the 503 ``session_pins`` over HTTP."""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from lambdipy_tpu.models import registry as jreg
from lambdipy_tpu.runtime.faults import FaultPlan as JaxFaultPlan
from lambdipy_tpu.runtime.prefixstore import PrefixStore as JaxPrefixStore
from lambdipy_tpu.runtime.prefixstore import \
    SessionPinsExceeded as JaxSessionPinsExceeded
from lambdipy_tpu_torch.models import registry as treg
from lambdipy_tpu_torch.models.params import from_jax_params
from lambdipy_tpu_torch.runtime.faults import FaultPlan
from lambdipy_tpu_torch.runtime.handlers import (HandlerContext,
                                                 HandlerState,
                                                 generate_handler,
                                                 make_engine)
from lambdipy_tpu_torch.runtime.prefixstore import (PrefixStore,
                                                    SessionPinsExceeded)
from lambdipy_tpu_torch.runtime.server import BundleServer

EXTRA = {"attn_backend": "blocked"}
PAGED = {"batch_max": "4", "batch_segment": "4", "kv_paged": "1",
         "prefix_block": "16"}


@pytest.fixture(scope="module")
def weights():
    adapter = jreg.get("llama-tiny").build(extra=EXTRA)
    params = adapter.init_params(seed=0)
    return adapter, params, from_jax_params(
        jax.tree_util.tree_map(np.asarray, params))


@pytest.fixture(scope="module")
def jax_server(weights):
    return weights[0].make_server(weights[1])


@pytest.fixture
def server(weights):
    return treg.get("llama-tiny").build(extra=EXTRA).make_server(
        weights[2], device="cpu")


def _rows(seed, n, length, vocab=500):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, vocab, size=length)]
            for _ in range(n)]


def _paged_store(server, n_pages=None, **kw):
    extra = dict(PAGED)
    if n_pages is not None:
        extra["kv_pages"] = str(n_pages)
    engine = make_engine(server, extra)
    store = PrefixStore(server, block=16, budget_mb=8, pool=engine.pool,
                        **kw)
    engine.prefix_pages_fn = store.acquire_pages
    return store, engine.pool


# -- pin lifecycle -------------------------------------------------------------


def test_pin_renew_release_and_gauges(server):
    """Turn 1 pins the routed head, turn 2 extends the pin along the
    longer head, ``end_session`` returns every gauge to zero."""
    store = PrefixStore(server, block=16, budget_mb=8)
    (row,) = _rows(0, 1, 72)
    assert store.route(row[:40]) == 32
    assert store.pin_session("s1", row[:40]) == 32
    st = store.stats()
    assert st["sessions_active"] == 1
    assert st["pinned_leaves"] == 2 and st["pinned_bytes"] > 0
    per_block = st["pinned_bytes"] // 2
    store.route(row)
    assert store.pin_session("s1", row) == 64
    st = store.stats()
    assert st["pinned_leaves"] == 4 and st["pinned_bytes"] == 4 * per_block
    out = store.end_session("s1")
    assert out["released"] and out["pinned_leaves"] == 4
    st = store.stats()
    assert st["sessions_active"] == 0
    assert st["pinned_leaves"] == 0 and st["pinned_bytes"] == 0
    assert store.end_session("s1")["released"] is False
    assert store.check_invariants()["ok"]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_pins_survive_lru_budget_pressure(server, paged):
    """Cache pressure that evicts every unpinned leaf leaves the session's
    K/V matchable; unpinned, the next inserts sweep it."""
    if paged:
        store, pool = _paged_store(server)
    else:
        store, pool = PrefixStore(server, block=16, budget_mb=8), None
    (pinned_row,) = _rows(1, 1, 40)
    store.route(pinned_row)
    store.pin_session("chat", pinned_row)
    per_block = store.stats()["pinned_bytes"] // 2
    store.budget_bytes = 3 * per_block
    for row in _rows(2, 6, 40):
        store.route(row)
    st = store.stats()
    assert st["evictions"] > 0 and st["pinned_leaves"] == 2
    assert store.match_len(pinned_row) == 32
    store.end_session("chat")
    for row in _rows(3, 3, 40):
        store.route(row)
    assert store.stats()["bytes"] <= store.budget_bytes
    assert store.check_invariants()["ok"]
    if pool is not None:
        pool.check_invariants()


def test_pin_budget_sheds_priced_by_lease_horizon(server):
    """A pin past the budget raises ``SessionPinsExceeded`` and changes
    nothing; its Retry-After is the earliest lease expiry."""
    store = PrefixStore(server, block=16, budget_mb=8, session_idle_s=30.0)
    row_a, row_b = _rows(4, 2, 40)
    store.route(row_a)
    store.pin_session("a", row_a)
    store.pin_budget_bytes = store.stats()["pinned_bytes"] + 1
    store.route(row_b)
    with pytest.raises(SessionPinsExceeded) as exc:
        store.pin_session("b", row_b)
    assert 20.0 < exc.value.retry_after_s <= 30.0
    st = store.stats()
    assert st["pin_sheds"] == 1
    assert st["sessions_active"] == 1 and st["pinned_leaves"] == 2
    assert store.pin_session("a", row_a) == 32  # a's renewal still fits


def test_grown_conversation_overflow_serves_with_existing_pins(server):
    """An existing session whose head outgrew the budget keeps its pins
    and serves (``pin_overflows``); only new sessions shed."""
    store = PrefixStore(server, block=16, budget_mb=8)
    (row,) = _rows(20, 1, 72)
    store.route(row[:40])
    assert store.pin_session("grow", row[:40]) == 32
    store.pin_budget_bytes = store.stats()["pinned_bytes"]
    store.route(row)
    assert store.pin_session("grow", row) == 32
    st = store.stats()
    assert st["pin_overflows"] == 1 and st["pin_sheds"] == 0
    assert st["pinned_leaves"] == 2 and st["sessions_active"] == 1
    store.end_session("grow")
    assert store.stats()["pinned_leaves"] == 0


def test_pin_budget_clamped_to_cache_budget(server):
    store = PrefixStore(server, block=16, budget_mb=1, pin_budget_mb=1024.0)
    assert store.pin_budget_bytes == store.budget_bytes
    store = PrefixStore(server, block=16, budget_mb=1, pin_budget_mb=0.25)
    assert store.pin_budget_bytes == int(0.25 * 2**20)
    assert PrefixStore(server, block=16, budget_mb=1).pin_budget_bytes \
        == 2**20 // 2


@pytest.mark.parametrize("how", ["overflow", "touch"])
def test_tightened_lease_sticks(server, how):
    """A ``session_ttl_s`` tightening lands even while the budget is full
    (the overflow renewal), and a ``touch_session`` renews at the tight
    window, never the store's default."""
    store = PrefixStore(server, block=16, budget_mb=8, session_idle_s=600.0)
    (row,) = _rows(22, 1, 72)
    if how == "overflow":
        store.route(row[:40])
        store.pin_session("t", row[:40])
        store.pin_budget_bytes = store.stats()["pinned_bytes"]
        store.route(row)
        store.pin_session("t", row, ttl_s=0.5)
        assert store.stats()["pin_overflows"] == 1
    else:
        store.route(row[:40])
        store.pin_session("t", row[:40], ttl_s=0.5)
        assert store.touch_session("t")
    time.sleep(0.7)
    st = store.stats()
    assert st["sessions_active"] == 0 and st["pin_expiries"] == 1
    assert store.touch_session("t") is False


def test_ttl_expiry_under_concurrent_renewal(server):
    """A session whose client went away lapses on schedule while a
    renewing one keeps its pins."""
    store = PrefixStore(server, block=16, budget_mb=8)
    row_a, row_b = _rows(5, 2, 40)
    store.route(row_a)
    store.route(row_b)
    store.pin_session("gone", row_a, ttl_s=0.6)
    store.pin_session("live", row_b)
    stop = threading.Event()

    def renew():
        while not stop.is_set():
            store.pin_session("live", row_b)
            time.sleep(0.1)

    t = threading.Thread(target=renew, daemon=True)
    t.start()
    try:
        time.sleep(0.9)
        st = store.stats()
        assert st["pin_expiries"] == 1 and st["sessions_active"] == 1
        assert st["pinned_leaves"] == 2
    finally:
        stop.set()
        t.join(timeout=5)
    store.end_session("live")
    assert store.stats()["pinned_leaves"] == 0


def test_absolute_ttl_caps_renewal(server):
    store = PrefixStore(server, block=16, budget_mb=8, session_ttl_s=1.0,
                        session_idle_s=30.0)
    (row,) = _rows(6, 1, 40)
    store.route(row)
    store.pin_session("s", row)
    deadline = time.monotonic() + 1.1
    while time.monotonic() < deadline:
        store.touch_session("s")
        time.sleep(0.1)
    st = store.stats()
    assert st["sessions_active"] == 0 and st["pin_expiries"] == 1


def test_session_pin_fault_fails_open(server):
    """An injected ``session_pin`` fault costs the pin, never the turn."""
    store = PrefixStore(server, block=16, budget_mb=8,
                        faults=FaultPlan.from_spec(
                            "session_pin:exception@seg=1,n=1"))
    (row,) = _rows(7, 1, 40)
    store.route(row)
    assert store.pin_session("s", row) == 0
    st = store.stats()
    assert st["pin_faults"] == 1 and st["sessions_active"] == 0
    assert store.pin_session("s", row) == 32


def test_paged_pins_excluded_from_cold_page_reclaim(server):
    """The pool's reclaim releases unpinned cold leaves, never a pinned
    session's pages; the pin gauges ride the pool's stats."""
    store, pool = _paged_store(server)
    (pinned_row,) = _rows(8, 1, 40)
    store.route(pinned_row)
    store.pin_session("chat", pinned_row)
    for row in _rows(9, 2, 40):
        store.route(row)
    assert store.reclaim_pages(64) >= 1
    assert store.match_len(pinned_row) == 32
    gauges = pool.stats()
    assert gauges["pinned_pages"] == 2
    assert gauges["pinned_bytes"] == 2 * pool.page_bytes
    assert "pin_budget_bytes" in gauges and "pin_sheds" in gauges
    store.end_session("chat")
    assert store.reclaim_pages(64) >= 2
    pool.check_invariants()


def test_pin_unpin_churn_invariants_fuzz(server):
    """Pin and unpin churn against reclaims and routes keeps the pool's
    invariants, the store's accounting and a shadow model of the
    sessions exact."""
    store, pool = _paged_store(server)
    rows = _rows(11, 6, 40)
    for row in rows:
        store.route(row)
    rng = np.random.default_rng(12)
    shadow: dict[str, int] = {}
    for _ in range(200):
        op = rng.integers(0, 10)
        sid = f"s{int(rng.integers(0, 4))}"
        row = rows[int(rng.integers(0, len(rows)))]
        if op < 5:
            try:
                shadow[sid] = store.pin_session(sid, row) // store.block
            except SessionPinsExceeded:
                pass
        elif op < 7:
            out = store.end_session(sid)
            assert out["released"] == (shadow.pop(sid, None) is not None)
        elif op < 9:
            store.reclaim_pages(int(rng.integers(1, 4)))
            store.route(row)
        else:
            pool.check_invariants()
            assert store.check_invariants()["ok"]
    assert store.stats()["sessions_active"] == len(shadow)
    for sid in list(shadow):
        store.end_session(sid)
    st = store.stats()
    assert st["pinned_leaves"] == 0 and st["pinned_bytes"] == 0
    assert store.check_invariants()["ok"]
    pool.check_invariants()


PIN_KEYS = ("sessions_active", "pinned_leaves", "pinned_bytes",
            "pin_budget_bytes", "pin_sheds", "pin_overflows", "pin_expiries",
            "pin_invalidations", "pin_faults", "hits", "misses",
            "hit_tokens", "blocks", "bytes", "evictions")


def test_store_counters_match_the_jax_store_op_for_op(jax_server, server):
    """One seeded sequence of routes, pins (some past the budget, some
    with a failing ``session_pin`` fault), touches and closes through the
    JAX and the port's dense stores: the same return values and
    exceptions, and the same counters after every operation."""
    spec = "session_pin:exception@seg=5,n=2"
    jstore = JaxPrefixStore(jax_server, block=16, budget_mb=1,
                            pin_budget_mb=0.4,
                            faults=JaxFaultPlan.from_spec(spec))
    tstore = PrefixStore(server, block=16, budget_mb=1, pin_budget_mb=0.4,
                         faults=FaultPlan.from_spec(spec))
    rows = _rows(30, 5, 60)
    rng = np.random.default_rng(31)
    for _ in range(60):
        op = int(rng.integers(0, 6))
        sid = f"s{int(rng.integers(0, 4))}"
        row = rows[int(rng.integers(0, len(rows)))]
        row = row[:int(rng.integers(20, 61))]
        if op <= 1:
            assert tstore.route(row) == jstore.route(row)
        elif op <= 3:
            try:
                want = jstore.pin_session(sid, row)
            except JaxSessionPinsExceeded as e:
                with pytest.raises(SessionPinsExceeded) as exc:
                    tstore.pin_session(sid, row)
                assert (exc.value.needed, exc.value.budget) \
                    == (e.needed, e.budget)
            else:
                assert tstore.pin_session(sid, row) == want
        elif op == 4:
            assert tstore.touch_session(sid) == jstore.touch_session(sid)
        else:
            assert tstore.end_session(sid) == jstore.end_session(sid)
        ts, js = tstore.stats(), jstore.stats()
        assert {k: ts[k] for k in PIN_KEYS} == {k: js[k] for k in PIN_KEYS}
        assert tstore.match_len(row) == jstore.match_len(row)
        assert tstore.present_len(row) == jstore.present_len(row)
    inv_t, inv_j = tstore.check_invariants(), jstore.check_invariants()
    assert inv_t["ok"] and inv_j["ok"]
    assert {k: inv_t[k] for k in ("sessions_active", "pinned_leaves",
                                  "pinned_bytes", "blocks", "bytes")} \
        == {k: inv_j[k] for k in ("sessions_active", "pinned_leaves",
                                  "pinned_bytes", "blocks", "bytes")}


# -- engine failures ------------------------------------------------------------


def _idle(engine, timeout=10.0):
    deadline = time.monotonic() + timeout
    with engine._lock:
        while engine._engine_running and time.monotonic() < deadline:
            engine._lock.wait(0.05)


def test_pins_survive_an_engine_failure_and_a_wedge(server, monkeypatch):
    """Difference by design: the port keeps its arena through every
    engine failure, so no failure invalidates a pin (JAX resets the arena
    and drops every pin, ``tests/test_sessions.py::
    test_arena_reset_invalidates_pins_observably``). An injected failure
    replays bitwise and the paged session's pages stay pinned and matched;
    a sticky CUDA error wedges the engine, and the pins and the tree stay
    as they were (``pin_invalidations`` 0), the pages hold their refs,
    and ``end_session`` still releases them."""
    store, pool = _paged_store(server)
    engine = make_engine(server, PAGED)  # a second engine on the arena
    engine.pool = pool
    engine.prefix_pages_fn = store.acquire_pages
    (row,) = _rows(13, 1, 40)
    m = store.route(row)
    store.pin_session("lad", row)
    want = server.generate(row[m:], prefix=row[:m], max_new_tokens=8)
    engine.faults.arm("segment_fetch:exception@seg=1,n=1")
    got = engine.generate(row[m:], prefix=row[:m], max_new_tokens=8)
    np.testing.assert_array_equal(got, want)
    _idle(engine)
    assert engine.stats()["faults"]["replays"]["succeeded"] == 1
    error = "CUDA error: an illegal memory access was encountered"

    def boom(live):
        raise RuntimeError(error)

    monkeypatch.setattr(engine, "_run_segment", boom)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        engine.generate(row[m:], prefix=row[:m], max_new_tokens=8)
    assert engine.wedged
    st = store.stats()
    assert st["pin_invalidations"] == 0 and st["sessions_active"] == 1
    assert st["pinned_leaves"] == 2 and store.match_len(row) == m
    inv = store.check_invariants()
    assert inv["ok"] and len(inv["pages"]) == 2
    assert store.end_session("lad")["released"]
    assert store.stats()["pinned_leaves"] == 0
    pool.check_invariants()


# -- the handler and the server -------------------------------------------------


def test_handler_reads_session_extras_as_jax_does(weights, monkeypatch):
    """``session_pin_budget_mb`` / ``session_ttl_s`` / ``session_idle_s``,
    each after its ``LAMBDIPY_SESSION_*`` variable; a request's
    ``session_id`` pins its head after routing, a bad ``session_ttl_s``
    is an error, and ``meta`` says sessions are on."""
    for key in ("LAMBDIPY_SESSION_PIN_BUDGET_MB", "LAMBDIPY_SESSION_TTL_S",
                "LAMBDIPY_SESSION_IDLE_S"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("LAMBDIPY_SESSION_TTL_S", "77")
    state = generate_handler(
        {"model": "llama-tiny",
         "extra": {**EXTRA, "prefix_cache_mb": "8", "prefix_block": "16",
                   "session_pin_budget_mb": "2", "session_ttl_s": "5",
                   "session_idle_s": "9"}},
        HandlerContext(device="cpu", state_dict=weights[2]))
    store = state.prefix_store
    assert (store.pin_budget_bytes, store.session_ttl_s,
            store.session_idle_s) == (2 * 2**20, 77.0, 9.0)
    assert state.meta["sessions"] and state.meta["kv_ship"]
    (row,) = _rows(40, 1, 40)
    out = state.invoke({"tokens": row, "max_new_tokens": 4,
                        "session_id": "c", "session_ttl_s": 3})
    assert out["ok"] and out["prefix_cached"]
    assert out["tokens"] == state.server.generate(
        row, max_new_tokens=4).tolist()
    st = state.stats()["prefix_cache"]
    assert st["sessions_active"] == 1 and st["pinned_leaves"] == 2
    assert store._sessions["c"].idle == 3.0
    bad = state.invoke({"tokens": row, "session_id": "c",
                        "session_ttl_s": "soon"})
    assert not bad["ok"] and "session_ttl_s" in bad["error"]
    assert state.session_end_fn("c")["released"]


def _post(url, body, headers=None, method="POST"):
    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method=method)
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_server_maps_session_pins_to_shed_503():
    """``SessionPinsExceeded`` from the handler is a shed: 503 with
    Retry-After from the lease horizon and reason ``session_pins`` on
    ``/invoke``, on a stream and on ``/v1/completions``; no error
    counted."""

    def invoke(request):
        raise SessionPinsExceeded(4096, 1024, retry_after_s=7.5)

    def stream(request):
        raise SessionPinsExceeded(4096, 1024, retry_after_s=7.5)
        yield {}

    srv = BundleServer(HandlerState(invoke_fn=invoke, meta={},
                                    invoke_stream_fn=stream),
                       port=0).start_background()
    try:
        for path, body in (("/invoke", {"tokens": [1, 2]}),
                           ("/invoke", {"tokens": [1, 2], "stream": True}),
                           ("/v1/completions", {"prompt": [1, 2]})):
            with pytest.raises(urllib.error.HTTPError) as exc:
                _post(srv.url + path, body, {"x-session-id": "c1"})
            assert exc.value.code == 503
            assert int(exc.value.headers["Retry-After"]) == 8
            out = json.loads(exc.value.read())
            assert "session_pins" in json.dumps(out)
        shed = srv.sched.admission.shed_report()
        assert shed["by_reason"].get("session_pins") == 3
        assert srv.stats.report()["errors"] == 0
    finally:
        srv.stop(drain_grace=1.0)


def test_server_session_headers_delete_and_gauges(weights):
    """Over HTTP on the paged engine: ``x-session-id`` pins the turn (the
    body's ``session_id`` wins over the header), a second turn extends
    the pin and hits, a new session past the pin budget is a 503
    ``session_pins`` with Retry-After, and ``DELETE /v1/sessions/{id}``
    brings the pin gauges (``prefix_cache`` and ``page_pool``) to 0."""
    state = generate_handler(
        {"model": "llama-tiny",
         "extra": {**EXTRA, **PAGED, "batch_mode": "continuous",
                   "prefix_cache_mb": "8", "warm_group_prefill": "0"}},
        HandlerContext(device="cpu", state_dict=weights[2]))
    srv = BundleServer(state, port=0).start_background()
    try:
        turn1, other = _rows(41, 2, 40)
        out = _post(srv.url + "/invoke",
                    {"tokens": turn1, "max_new_tokens": 4},
                    {"x-session-id": "hdr"})
        assert out["ok"]
        turn2 = turn1 + out["tokens"][0] + list(range(7, 30))
        out = _post(srv.url + "/v1/completions",
                    {"prompt": turn2, "max_tokens": 4, "temperature": 0,
                     "session_id": "hdr"}, {"x-session-id": "ignored"})
        assert out["choices"][0]["tokens"] == state.server.generate(
            turn2, max_new_tokens=4).tolist()[0]
        pc = _post(srv.url + "/metrics", None, method="GET")["handler"][
            "prefix_cache"]
        assert pc["sessions_active"] == 1 and pc["pinned_leaves"] == 4
        assert pc["hits"] >= 1
        state.prefix_store.pin_budget_bytes = pc["pinned_bytes"]
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(srv.url + "/invoke", {"tokens": other,
                                        "max_new_tokens": 4},
                  {"x-session-id": "new"})
        assert exc.value.code == 503 and exc.value.headers["Retry-After"]
        assert json.loads(exc.value.read())["shed"] == "session_pins"
        out = _post(srv.url + "/v1/sessions/hdr", None, method="DELETE")
        assert out["ok"] and out["released"] and out["pinned_leaves"] == 4
        m = _post(srv.url + "/metrics", None, method="GET")["handler"]
        assert m["prefix_cache"]["pinned_leaves"] == 0
        assert m["prefix_cache"]["pinned_bytes"] == 0
        assert m["batching"]["page_pool"]["pinned_pages"] == 0
        assert m["prefix_cache"]["pin_sheds"] == 1
        out = _post(srv.url + "/v1/sessions/hdr", None, method="DELETE")
        assert out["ok"] and not out["released"]
    finally:
        srv.stop(drain_grace=5.0)
