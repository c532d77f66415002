"""The port's engine fault isolation (``lambdipy_tpu_torch/runtime/
faults.py`` and the recovery machinery of ``runtime/continuous.py``), the
twin of ``tests/test_faults.py``: the same scenarios through the JAX
engine (the ``tiny_server`` fixture) and the port's engine on f32
``llama-tiny``, the weights carried across by ``from_jax_params``; then
what is the port's own (the site registry, the parser against the JAX
parser, prefix rows replayed over their pages, the ``prefix_walk`` site,
the fast path that never polls, a sticky CUDA error, graphs kept across
a failure, the HTTP surfaces).

Tolerances: the port's engine rows, replayed or not, against the port's
solo ``generate``: tokens exact, the first logprob exact, the rest within
1e-5 (the CPU engine tests' bound: the plain attention softmaxes over the
engine's window and the solo bucket). Greedy tokens equal the JAX
engine's. Seeded sampled tokens are compared within each framework only
(the port draws counter-based noise, JAX from threefry). The
``faults`` block's counts equal the JAX engine's where the scenario is
one request or rows admitted together. The port's last segment is
shorter than JAX's, so fault rules arm at ``seg=1`` or ``seg=2``, where
both engines count the same calls."""

import json
import re
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest

from lambdipy_tpu.models import registry as jreg
from lambdipy_tpu.runtime import faults as jfaults
from lambdipy_tpu.runtime.continuous import ContinuousBatcher as JaxBatcher
from lambdipy_tpu_torch.models import registry as treg
from lambdipy_tpu_torch.models.graphs import DEVICE_LOCK
from lambdipy_tpu_torch.models.params import from_jax_params
from lambdipy_tpu_torch.runtime import continuous
from lambdipy_tpu_torch.runtime import faults as tfaults
from lambdipy_tpu_torch.runtime.continuous import (ContinuousBatcher,
                                                   RequestCancelled)
from lambdipy_tpu_torch.runtime.faults import (EngineWatchdogTimeout,
                                               FaultPlan, InjectedFault)
from lambdipy_tpu_torch.runtime.handlers import (HandlerContext,
                                                 generate_handler,
                                                 make_engine,
                                                 make_prefix_store)
from lambdipy_tpu_torch.runtime.pagepool import PagesExhausted
from lambdipy_tpu_torch.runtime.server import BundleServer

LP_TOL = 1e-5
PAGED = {"batch_max": "4", "batch_segment": "4", "kv_paged": "1",
         "prefix_block": "16"}
BOTH = pytest.mark.parametrize("mod", [jfaults, tfaults],
                               ids=["jax", "port"])
# the engines' watchdog where a hang must trip it: far above what a
# segment or a prefill of the tiny model takes on a loaded CPU (9 ms
# alone, past a second with every core shared by other test processes),
# which a watchdog cannot tell from a hung wait (the JAX server test sizes
# its watchdog the same way)
WATCHDOG_S = 3.0


@pytest.fixture(scope="module")
def weights():
    params = jreg.get("llama-tiny").build().init_params(seed=0)
    return from_jax_params(jax.tree_util.tree_map(np.asarray, params))


@pytest.fixture(scope="module")
def server(weights):
    return treg.get("llama-tiny").build().make_server(weights, device="cpu")


@pytest.fixture(scope="module")
def warm_jax(tiny_server):
    """The JAX engine's programs at the watchdog scenarios' shapes,
    compiled before a watchdog times them: a monitor cannot tell a cold
    compile from a hung wait (the JAX package sizes its watchdog above
    the compile for the same reason)."""
    JaxBatcher(tiny_server, slots=2, segment=4).generate([1, 2, 3],
                                                         max_new_tokens=8)
    return tiny_server


def _solo(server, prompt, n, **kw):
    return server.generate(prompt, max_new_tokens=n, return_logprobs=True,
                           **kw)


def _assert_row(out, solo):
    """An engine row against solo: tokens exact, first logprob exact, the
    rest within ``LP_TOL``."""
    np.testing.assert_array_equal(out[0], solo[0])
    np.testing.assert_array_equal(out[1][:, 0], solo[1][:, 0])
    np.testing.assert_allclose(out[1], solo[1], atol=LP_TOL)


def _idle(engine, timeout=10.0):
    deadline = time.monotonic() + timeout
    with engine._lock:
        while engine._engine_running and time.monotonic() < deadline:
            engine._lock.wait(0.05)
    assert not engine._engine_running


def _until(pred, timeout=10.0, step=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(step)
    return pred()


# -- spec grammar (pure) -----------------------------------------------------


@BOTH
def test_fault_plan_parsing(mod):
    p = mod.FaultPlan.from_spec("segment_fetch:hang@seg=3")
    assert p.describe() == ["segment_fetch:hang@seg=3,n=inf"]
    p = mod.FaultPlan.from_spec(
        "transport:delay@ms=200,n=2; group_prefill:exception")
    assert p.describe() == ["transport:delay@seg=1,n=2,ms=200",
                            "group_prefill:exception@seg=1,n=1"]
    assert mod.FaultPlan.from_spec("segment_fetch:raise").rules[0].kind \
        == "exception"
    assert not mod.FaultPlan.from_spec(None).active()
    assert not mod.FaultPlan.from_spec("  ").active()
    for bad in ("nosuchsite:hang", "segment_fetch:explode",
                "segment_fetch", "segment_fetch:hang@seg=x",
                "segment_fetch:hang@bogus=1"):
        with pytest.raises(ValueError):
            mod.FaultPlan.from_spec(bad)


@BOTH
def test_fault_plan_deterministic_firing_window(mod):
    plan = mod.FaultPlan.from_spec("segment_fetch:exception@seg=2,n=2")
    plan.check("segment_fetch")            # call 1: before the window
    for _ in range(2):                     # calls 2-3: inside it
        with pytest.raises(mod.InjectedFault):
            plan.check("segment_fetch")
    plan.check("segment_fetch")            # call 4: window exhausted
    plan.check("transport")                # other sites never match
    assert plan.counts() == {"segment_fetch": 4, "transport": 1}


@BOTH
def test_fault_plan_hang_releases_and_raises(mod):
    """A released (or interrupted) hang still raises: a wait the system
    gave up on must not look like a success."""
    plan = mod.FaultPlan.from_spec("transport:hang")
    out = {}

    def hangs():
        try:
            plan.check("transport")
            out["r"] = "returned"
        except mod.InjectedFault as e:
            out["r"] = e.fault_kind

    t = threading.Thread(target=hangs, daemon=True)
    t.start()
    t.join(timeout=0.2)
    assert t.is_alive()
    assert mod.HANG_CAP_S >= 60
    plan.release()
    t.join(timeout=5.0)
    assert not t.is_alive() and out["r"] == "hang"
    plan2 = mod.FaultPlan.from_spec("transport:hang")
    aborted = threading.Event()
    aborted.set()
    with pytest.raises(mod.InjectedFault):
        plan2.check("transport", interrupt=aborted)


@BOTH
def test_fault_plan_accepts_page_alloc_site(mod):
    p = mod.FaultPlan.from_spec("page_alloc:exception@seg=2,n=3")
    assert p.describe() == ["page_alloc:exception@seg=2,n=3"]
    p.check("page_alloc")
    with pytest.raises(mod.InjectedFault) as exc:
        p.check("page_alloc")
    assert exc.value.fault_site == "page_alloc"


@BOTH
def test_fault_plan_runtime_arm_and_clear(mod):
    plan = mod.FaultPlan.empty()
    assert not plan.armed()["active"]
    added = plan.arm("transport:exception@n=1;page_alloc:delay@ms=5,n=2")
    assert len(added) == 2
    with pytest.raises(mod.InjectedFault):
        plan.check("transport")
    assert plan.clear() == 2
    plan.check("transport")
    assert plan.counts()["transport"] == 1
    with pytest.raises(ValueError):
        plan.arm("transport:nope")
    assert not plan.armed()["active"]


@BOTH
def test_fault_plan_clear_releases_hangs_without_poisoning_later_ones(mod):
    plan = mod.FaultPlan.empty()
    plan.arm("transport:hang")
    results: list = []

    def waiter(tag):
        try:
            plan.check("transport")
            results.append((tag, "passed"))
        except mod.InjectedFault:
            results.append((tag, "released"))

    t1 = threading.Thread(target=waiter, args=("first",), daemon=True)
    t1.start()
    time.sleep(0.15)
    plan.clear()
    t1.join(5.0)
    assert ("first", "released") in results
    plan.arm("transport:hang")
    t2 = threading.Thread(target=waiter, args=("second",), daemon=True)
    t2.start()
    t2.join(0.4)
    assert t2.is_alive(), "a re-armed hang resolved at once"
    plan.release()
    t2.join(5.0)
    assert ("second", "released") in results


# -- the port's registry -----------------------------------------------------


def test_site_registry_metadata():
    """The port's registry: every site with an owner, the arming variable
    its owner implies (replica sites ``LAMBDIPY_FAULT``, fleet sites
    ``LAMBDIPY_FLEET_FAULT``) and a note; ``list_sites`` filters as the
    JAX one does."""
    assert tuple(tfaults.REGISTRY) == tfaults.SITES
    for site in tfaults.REGISTRY.values():
        assert site.owner in ("engine", "store", "pool", "router"), site
        want = ("LAMBDIPY_FAULT" if site.owner in ("engine", "store")
                else "LAMBDIPY_FLEET_FAULT")
        assert site.env == want and site.note, site
        assert site.name in jfaults.REGISTRY
    engine = {s.name for s in tfaults.list_sites(owner="engine")}
    assert engine == {"segment_dispatch", "segment_fetch", "transport",
                      "group_prefill", "prefix_assemble"}
    assert {s.name for s in tfaults.list_sites(owner="store")} \
        == {"prefix_walk", "session_pin", "offload_stall", "page_alloc"}
    assert {s.name for s in tfaults.list_sites(owner="pool")} == {"probe"}
    assert {s.name for s in tfaults.list_sites(owner="router")} \
        == {"route_connect", "route_body", "route_latency", "kv_ship",
            "kv_ship_chunk", "session_failover"}
    fleet = {s.name for s in tfaults.list_sites(env="LAMBDIPY_FLEET_FAULT")}
    assert "route_connect" in fleet and "prefix_walk" not in fleet


def test_port_registry_equals_the_jax_registry():
    """Site for site: the same names in the same order, each with JAX's
    owner and arming variable."""
    assert tfaults.SITES == jfaults.SITES
    for name, site in jfaults.REGISTRY.items():
        port = tfaults.REGISTRY[name]
        assert (port.name, port.owner, port.env) \
            == (site.name, site.owner, site.env), name


@pytest.mark.parametrize("var", ["LAMBDIPY_FAULT", "LAMBDIPY_FLEET_FAULT"])
def test_from_env_reads_its_own_variable(var):
    """``FaultPlan.from_env`` reads the variable it is given, as JAX's
    does: the fleet's plan never picks up a replica's spec."""
    environ = {var: "route_connect:exception@n=1"}
    for mod in (jfaults, tfaults):
        got = mod.FaultPlan.from_env(environ, var=var).describe()
        other = ("LAMBDIPY_FLEET_FAULT" if var == "LAMBDIPY_FAULT"
                 else "LAMBDIPY_FAULT")
        assert got == ["route_connect:exception@seg=1,n=1"]
        assert mod.FaultPlan.from_env(environ, var=other).describe() == []


def test_every_fire_site_in_the_port_is_registered():
    """Every literal site of a ``.check("...")`` or ``_device_wait("...")``
    call in ``lambdipy_tpu_torch/`` is registered, and every registered
    site has a call site."""
    root = Path(__file__).resolve().parents[1] / "lambdipy_tpu_torch"
    check_re = re.compile(r"\.check\(\s*[\"']([a-z_]+)[\"']")
    wait_re = re.compile(r"_device_wait\(\s*[\"']([a-z_]+)[\"']")
    found: set = set()
    for path in root.rglob("*.py"):
        text = path.read_text()
        found.update(check_re.findall(text))
        found.update(wait_re.findall(text))
    assert found == set(tfaults.REGISTRY), (
        f"unregistered: {sorted(found - set(tfaults.REGISTRY))}; "
        f"never fired: {sorted(set(tfaults.REGISTRY) - found)}")


@pytest.mark.parametrize("site", sorted(tfaults.REGISTRY))
def test_port_site_specs_parse_as_the_jax_parser_does(site):
    """A spec over a port site parses to the same rules under both
    parsers, kind aliases and parameters included."""
    specs = [f"{site}:exception", f"{site}:hang@seg=3",
             f"{site}:delay@ms=200,n=2", f"{site}:raise@seg=2,n=inf",
             f"{site}:stall@at=4,ms=0.5;{site}:block@n=2"]
    for spec in specs:
        assert tfaults.FaultPlan.from_spec(spec).describe() \
            == jfaults.FaultPlan.from_spec(spec).describe()


# -- the engine: page_alloc --------------------------------------------------


def test_injected_page_alloc_failure_sheds_one_row_only(tiny_server,
                                                        server):
    """The second admission's page_alloc fault sheds that row as priced
    backpressure while the row in flight finishes and later rows serve;
    no wedge; the failure counted under ``page_alloc``; the pool drains.
    The engine's plan drives the pool's site."""
    from lambdipy_tpu.models.llama import init_page_arena, page_kv_bytes
    from lambdipy_tpu.runtime.pagepool import PagePool, page_width
    from lambdipy_tpu.runtime.pagepool import \
        PagesExhausted as JaxPagesExhausted

    rows = [[1, 2, 3], [4, 5, 6], [7, 8, 9]]
    spec = "page_alloc:exception@seg=2"
    cfg = tiny_server.model.cfg
    page = page_width(cfg.max_len, 16)
    n_pages = 4 * (cfg.max_len // page) + 1
    pool = PagePool(n_pages=n_pages, page=page,
                    page_bytes=page_kv_bytes(cfg, page),
                    make_arena=lambda: init_page_arena(cfg, n_pages, page))
    jax_cb = JaxBatcher(tiny_server, slots=4, segment=8, page_pool=pool,
                        faults=jfaults.FaultPlan.from_spec(spec))
    port_cb = make_engine(server, {**PAGED, "batch_segment": "8",
                                   "fault_spec": spec})
    assert port_cb.pool.faults is port_cb.faults
    outs = {}
    for name, cb, shed_exc in (("jax", jax_cb, JaxPagesExhausted),
                               ("port", port_cb, PagesExhausted)):
        out0 = {}
        started = threading.Event()

        def first(cb=cb, out0=out0):
            started.set()
            out0["v"] = cb.generate(rows[0], max_new_tokens=16)

        t = threading.Thread(target=first)
        t.start()
        started.wait()
        time.sleep(0.05)
        with pytest.raises(shed_exc) as exc:
            cb.generate(rows[1], max_new_tokens=16)
        assert exc.value.retry_after_s > 0
        t.join()
        assert not cb.wedged
        outs[name] = (np.asarray(out0["v"]),
                      np.asarray(cb.generate(rows[2], max_new_tokens=16)))
        assert cb.stats()["faults"]["failures"] == {"page_alloc": 1}
        _idle(cb)
        cb.pool.check_invariants()
        st = cb.pool.stats()
        assert st["pages_free"] == st["pages_total"], st
    for i, row in ((0, rows[0]), (1, rows[2])):
        want = server.generate(row, max_new_tokens=16)
        np.testing.assert_array_equal(outs["port"][i], want)
        np.testing.assert_array_equal(outs["port"][i], outs["jax"][i])


# -- replay ------------------------------------------------------------------


def test_injected_fetch_fault_replays_bitwise(tiny_server, server):
    """Rows whose first attempt dies at an injected segment_fetch
    exception replay: greedy and seeded-sampled rows alike come out as
    their solo runs, the greedy tokens as the JAX engine's."""
    reqs = [([1, 2, 3, 4], {}), ([9, 8, 7], {"temperature": 0.8, "seed": 7})]
    spec = "segment_fetch:exception@seg=1"
    for name, cb in (
            ("jax", JaxBatcher(tiny_server, slots=4, segment=4,
                               faults=jfaults.FaultPlan.from_spec(spec))),
            ("port", ContinuousBatcher(server, slots=4, segment=4,
                                       faults=FaultPlan.from_spec(spec)))):
        with ThreadPoolExecutor(max_workers=2) as ex:
            futs = [ex.submit(cb.generate, p, max_new_tokens=12,
                              return_logprobs=True, **kw) for p, kw in reqs]
            got = [f.result() for f in futs]
        if name == "jax":
            jax_greedy = np.asarray(got[0][0])
            for (p, kw), out in zip(reqs, got):
                np.testing.assert_array_equal(
                    out[0], tiny_server.generate(p, max_new_tokens=12,
                                                 **kw))
        else:
            for (p, kw), out in zip(reqs, got):
                _assert_row(out, _solo(server, p, 12, **kw))
            np.testing.assert_array_equal(got[0][0], jax_greedy)
        faults = cb.stats()["faults"]
        assert faults["failures"] == {"segment_fetch": 1}
        assert faults["replays"]["attempted"] >= 1
        assert faults["replays"]["succeeded"] \
            == faults["replays"]["attempted"]
        assert faults["recoveries"] == 1
        assert not cb.wedged


def test_replay_budget_exhausts_to_explicit_error(tiny_server, server):
    """Past ``max_replays`` the row errors explicitly; the engine then
    serves bitwise. One request: the whole ``faults`` block equals the
    JAX engine's (two failures in the window stepped the ladder)."""
    spec = "segment_fetch:exception@seg=1,n=2"
    reports, outs = {}, {}
    for name, cb, exc in (
            ("jax", JaxBatcher(tiny_server, slots=2, segment=4,
                               max_replays=1,
                               faults=jfaults.FaultPlan.from_spec(spec)),
             jfaults.InjectedFault),
            ("port", ContinuousBatcher(server, slots=2, segment=4,
                                       max_replays=1,
                                       faults=FaultPlan.from_spec(spec)),
             InjectedFault)):
        with pytest.raises(exc):
            cb.generate([1, 2, 3], max_new_tokens=8)
        assert cb.stats()["faults"]["replays"] == {"attempted": 1,
                                                   "succeeded": 0}
        outs[name] = np.asarray(cb.generate([1, 2, 3], max_new_tokens=8))
        reports[name] = cb.stats()["faults"]
    np.testing.assert_array_equal(outs["port"], outs["jax"])
    np.testing.assert_array_equal(
        outs["port"], server.generate([1, 2, 3], max_new_tokens=8))
    assert reports["port"] == reports["jax"]


@pytest.mark.parametrize("route", ["row", "chunked"])
def test_long_prompt_row_replays_through_its_own_prefill(tiny_server, weights,
                                                         monkeypatch, route):
    """A replayed row past the group width prefills again alone, through
    the function that admitted it (plain or chunked), never in the group
    program: bitwise the unfaulted run, no group prefill counted."""
    monkeypatch.setattr(continuous, "GROUP_PREFILL_MAX", 4)
    kw = {"prefill_chunk": 16} if route == "chunked" else {}
    srv = treg.get("llama-tiny").build().make_server(weights, device="cpu",
                                                     **kw)
    prompt = list(range(1, 13)) if route == "row" else list(range(1, 41))
    clean = ContinuousBatcher(srv, slots=2, segment=4)
    want = clean.generate(prompt, max_new_tokens=8, return_logprobs=True)
    cb = ContinuousBatcher(
        srv, slots=2, segment=4,
        faults=FaultPlan.from_spec("segment_fetch:exception@seg=1"))
    got = cb.generate(prompt, max_new_tokens=8, return_logprobs=True)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    stats = cb.stats()
    assert stats["faults"]["replays"] == {"attempted": 1, "succeeded": 1}
    assert stats["prefill_groups"] == 0 and stats["row_prefills"] == 2
    if route == "chunked":
        # 40 tokens: two 16-token chunks walked, then the tail, twice
        assert stats["prefill_chunks"] == 2 * clean.stats()["prefill_chunks"]
        assert stats["prefill_chunks"] == 4
    else:
        _assert_row(got, _solo(srv, prompt, 8))
        jax_cb = JaxBatcher(
            tiny_server, slots=2, segment=4, group_prefill_max=4,
            faults=jfaults.FaultPlan.from_spec(
                "segment_fetch:exception@seg=1"))
        np.testing.assert_array_equal(
            got[0], jax_cb.generate(prompt, max_new_tokens=8))
        assert jax_cb.stats()["faults"]["replays"] \
            == stats["faults"]["replays"]
        assert jax_cb.prefill_groups == 0


def test_done_but_undrained_row_survives_engine_error(tiny_server, server):
    """The JAX scenario through both engines: a short row, then a long
    one 50 ms later behind a slowed fetch; the second fetch fails and
    only the unfinished row replays."""
    short, long_ = [5, 6, 7], [1, 2, 3, 4]
    spec = "transport:delay@ms=120,n=2;segment_fetch:exception@seg=2"
    for name, cb in (
            ("jax", JaxBatcher(tiny_server, slots=2, segment=4,
                               pipeline_depth=2,
                               faults=jfaults.FaultPlan.from_spec(spec))),
            ("port", ContinuousBatcher(server, slots=2, segment=4,
                                       pipeline_depth=2,
                                       faults=FaultPlan.from_spec(spec)))):
        srv = tiny_server if name == "jax" else server
        with ThreadPoolExecutor(max_workers=2) as ex:
            f_short = ex.submit(cb.generate, short, max_new_tokens=4)
            time.sleep(0.05)
            f_long = ex.submit(cb.generate, long_, max_new_tokens=12)
            np.testing.assert_array_equal(
                f_short.result(), srv.generate(short, max_new_tokens=4))
            np.testing.assert_array_equal(
                f_long.result(), srv.generate(long_, max_new_tokens=12))
        faults = cb.stats()["faults"]
        assert faults["replays"] == {"attempted": 1, "succeeded": 1}
        assert faults["failures"] == {"segment_fetch": 1}


def test_a_row_done_behind_the_frontier_keeps_its_result(server):
    """Two rows packed at one barrier (the device lock held while both
    join), depth 2: the 4-token row is done but still in its slot when
    the second fetch fails; it keeps its result, only its neighbour
    replays, both bitwise solo."""
    cb = ContinuousBatcher(
        server, slots=2, segment=4, pipeline_depth=2,
        faults=FaultPlan.from_spec("segment_fetch:exception@seg=2"))
    seen = []
    real_fail = cb._fail_engine

    def fail(*args, **kwargs):
        with cb._lock:
            seen.extend((e["n"], e["done"]) for e in cb._active if e)
        return real_fail(*args, **kwargs)

    cb._fail_engine = fail
    reqs = [([5, 6, 7], 4), ([1, 2, 3, 4], 12)]
    with ThreadPoolExecutor(max_workers=2) as ex:
        with DEVICE_LOCK:
            futs = [ex.submit(cb.generate, p, max_new_tokens=n,
                              return_logprobs=True) for p, n in reqs]
            assert _until(lambda: len(cb._joiners)
                          + sum(e is not None for e in cb._active) == 2)
        got = [f.result() for f in futs]
    for (p, n), out in zip(reqs, got):
        _assert_row(out, _solo(server, p, n))
    assert sorted(seen) == [(4, True), (12, False)]
    assert cb.stats()["faults"]["replays"] == {"attempted": 1,
                                               "succeeded": 1}


def test_streamed_row_with_delivered_bytes_errors_not_replays(tiny_server,
                                                              server):
    """Once a chunk reached the client, the row ends with the error; no
    replay is spliced onto its stream."""
    spec = "transport:delay@seg=2,ms=150;segment_fetch:exception@seg=2"
    for cb, exc in (
            (JaxBatcher(tiny_server, slots=2, segment=4,
                        faults=jfaults.FaultPlan.from_spec(spec)),
             jfaults.InjectedFault),
            (ContinuousBatcher(server, slots=2, segment=4,
                               faults=FaultPlan.from_spec(spec)),
             InjectedFault)):
        chunks = []
        with pytest.raises(exc):
            for chunk in cb.generate_stream([1, 2, 3], max_new_tokens=16):
                chunks.append(chunk)
        assert chunks
        assert cb.stats()["faults"]["replays"]["attempted"] == 0
        assert cb.stats()["faults"]["failures"] == {"segment_fetch": 1}


def test_prefix_rows_replay_bitwise_over_their_pages(server):
    """Routed prefix rows (dense: from the server's prefix entry; paged:
    over the store's shared pages and their own) whose first attempt dies
    at a segment_fetch exception replay bitwise their unfaulted routed
    run. The paged rows keep their pages, the shared prefix pages
    included, and the pool holds only the store's pages after."""
    head = [(5 * j) % 400 + 1 for j in range(32)]
    rows = [(head + [7, 8, 9, 10, 11], {}),
            (head + [3, 1, 4], {"temperature": 0.9, "seed": 5})]
    for kind in ("dense", "paged"):
        extra = {"batch_max": "4", "batch_segment": "4",
                 **({"kv_paged": "1", "prefix_block": "16"}
                    if kind == "paged" else {})}
        engine = make_engine(server, extra)
        store = (make_prefix_store(server, engine, {"prefix_block": "16"})
                 if kind == "paged" else None)

        def burst():
            def one(i):
                time.sleep(0.01 * i)
                row, kw = rows[i]
                m = store.route(row) if store is not None else 32
                assert m == 32
                return engine.generate(row[m:], prefix=row[:m],
                                       max_new_tokens=12,
                                       return_logprobs=True, **kw)

            with ThreadPoolExecutor(max_workers=2) as ex:
                return list(ex.map(one, range(2)))

        want = burst()
        _idle(engine)
        engine.faults.arm("segment_fetch:exception@seg=2")
        got = burst()
        _idle(engine)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g[0], w[0])
            np.testing.assert_array_equal(g[1], w[1])
        faults = engine.stats()["faults"]
        assert faults["failures"] == {"segment_fetch": 1}
        assert faults["replays"]["attempted"] >= 1
        assert faults["replays"]["succeeded"] \
            == faults["replays"]["attempted"]
        if kind == "paged":
            engine.pool.check_invariants()
            assert engine.pool.stats()["pages_live"] \
                == store.stats()["blocks"] == 2


def test_prefix_walk_fault_serves_unrouted(weights):
    """``prefix_walk:exception`` armed on the handler's live plan fails
    the cold walk open: the request serves unrouted, bitwise the unrouted
    run, and the next request walks and routes."""
    state = generate_handler(
        {"model": "llama-tiny",
         "extra": {**PAGED, "batch_mode": "continuous",
                   "warm_group_prefill": "0"}},
        HandlerContext(device="cpu", state_dict=weights))
    assert state.prefix_store.faults is state.engine.faults
    prompt = [(3 * j) % 300 + 2 for j in range(40)]
    want = state.server.generate(prompt, max_new_tokens=6)
    out = state.faults_admin_fn({"spec": "prefix_walk:exception"})
    assert out["ok"] and out["added"] == ["prefix_walk:exception@seg=1,n=1"]
    req = {"tokens": prompt, "max_new_tokens": 6}
    first = state.invoke(req)
    assert "prefix_cached" not in first
    assert first["tokens"] == want.tolist()
    assert state.prefix_store.stats()["blocks"] == 0
    second = state.invoke(req)
    assert second["prefix_cached"] and second["tokens"] == want.tolist()
    assert state.engine.faults.counts()["prefix_walk"] >= 2
    assert state.stats()["faults"]["armed"]["rules"][0]["fired"] == 1


# -- the watchdog ------------------------------------------------------------


def test_watchdog_wedges_hung_engine_and_aborts_waiters(warm_jax, server):
    tiny_server = warm_jax
    """A hung fetch trips the watchdog within its bound: with no replay
    budget the waiter gets :class:`EngineWatchdogTimeout`, the engine
    reports wedged (not restarting); the next clean request clears the
    wedge and counts a recovery."""
    for name, cb, plan, exc in (
            ("jax", None, jfaults.FaultPlan.from_spec(
                "segment_fetch:hang@seg=1,n=1"),
             jfaults.EngineWatchdogTimeout),
            ("port", None, FaultPlan.from_spec(
                "segment_fetch:hang@seg=1,n=1"), EngineWatchdogTimeout)):
        cls, srv = ((JaxBatcher, tiny_server) if name == "jax"
                    else (ContinuousBatcher, server))
        cb = cls(srv, slots=2, segment=4, faults=plan, watchdog_s=WATCHDOG_S,
                 max_replays=0)
        t0 = time.monotonic()
        try:
            with pytest.raises(exc):
                cb.generate([1, 2, 3], max_new_tokens=8)
            assert time.monotonic() - t0 < WATCHDOG_S + 8.0
            assert cb.wedged
            state = cb.fault_state()
            assert state["wedged"] and not state["restarting"]
            faults = cb.stats()["faults"]
            assert faults["watchdog_trips"] >= 1
            assert faults["failures"].get("watchdog:segment_fetch", 0) >= 1
        finally:
            plan.release()
        np.testing.assert_array_equal(
            cb.generate([1, 2, 3], max_new_tokens=8),
            srv.generate([1, 2, 3], max_new_tokens=8))
        assert not cb.wedged
        assert cb.stats()["faults"]["recoveries"] >= 1


def test_watchdog_bounded_hang_recovers_via_replay(warm_jax, server):
    tiny_server = warm_jax
    """A one-shot hang trips the watchdog, the row replays bitwise and the
    wedge clears at the first clean fetch."""
    outs = {}
    for name, cls, srv, mod in (
            ("jax", JaxBatcher, tiny_server, jfaults),
            ("port", ContinuousBatcher, server, tfaults)):
        cb = cls(srv, slots=2, segment=4, watchdog_s=WATCHDOG_S,
                 faults=mod.FaultPlan.from_spec(
                     "segment_fetch:hang@seg=1,n=1"))
        outs[name] = np.asarray(cb.generate([4, 2, 1], max_new_tokens=8))
        np.testing.assert_array_equal(
            outs[name], srv.generate([4, 2, 1], max_new_tokens=8))
        faults = cb.stats()["faults"]
        assert faults["watchdog_trips"] >= 1
        assert faults["replays"]["succeeded"] == 1
        assert not cb.wedged
    np.testing.assert_array_equal(outs["port"], outs["jax"])


def test_tripped_wait_does_not_block_wedged_self_probe(warm_jax, server):
    tiny_server = warm_jax
    """A real hang never returns, so its tripped record stays registered;
    the monitor treats it as disowned and the wedged idle engine's
    self-probe still clears the wedge."""
    for cls, srv in ((JaxBatcher, tiny_server), (ContinuousBatcher, server)):
        cb = cls(srv, slots=2, segment=4, watchdog_s=0.3, max_replays=0)
        release = threading.Event()
        gen0 = cb._gen

        def waiter(cb=cb, gen0=gen0, release=release):
            try:
                cb._device_wait("segment_fetch", gen0, release.wait, 30)
            except Exception:  # noqa: BLE001 — unwinds after the release
                pass

        t = threading.Thread(target=waiter, daemon=True)
        t.start()
        try:
            assert _until(lambda: cb.wedged, 10)
            assert any(rec["tripped"] for rec in cb._waits.values())
            assert _until(lambda: not cb.wedged, 30, 0.05)
            assert cb.stats()["faults"]["recoveries"] >= 1
        finally:
            release.set()
            t.join(timeout=5)


def test_degradation_ladder_steps_and_restores(tiny_server, server):
    """Two failures inside the window step the ladder to 1 (depth 1, the
    replay still bitwise); a clean interval restores it. The ``faults``
    blocks equal the JAX engine's at both points."""
    reports = {}
    for name, cls, srv, mod in (
            ("jax", JaxBatcher, tiny_server, jfaults),
            ("port", ContinuousBatcher, server, tfaults)):
        cb = cls(srv, slots=2, segment=4, pipeline_depth=2, max_replays=2,
                 degrade_window_s=60.0, degrade_clean_s=1.0,
                 faults=mod.FaultPlan.from_spec(
                     "segment_fetch:exception@seg=1,n=2"))
        want = srv.generate([3, 1, 4], max_new_tokens=8)
        np.testing.assert_array_equal(
            cb.generate([3, 1, 4], max_new_tokens=8), want)
        stepped = cb.stats()["faults"]
        assert stepped["degrade_level"] == 1
        assert stepped["degrade_steps"] == {"1": 1}
        assert stepped["last_degrade_cause"] == "segment_fetch"
        time.sleep(1.2)
        np.testing.assert_array_equal(
            cb.generate([3, 1, 4], max_new_tokens=8), want)
        restored = cb.stats()["faults"]
        assert restored["degrade_level"] == 0 and restored["restores"] == 1
        reports[name] = (stepped, restored)
    assert reports["port"] == reports["jax"]


def test_ladder_level_two_is_counted_and_serves_as_level_one(tiny_server,
                                                             server):
    """Three failures in the window step the ladder to 2. JAX pins its
    full-window program there; the port has no window variants (nor
    speculation), so level 2 serves exactly as level 1: the replay is
    bitwise, at depth 1, and the ``faults`` block equals JAX's."""
    reports, outs = {}, {}
    for name, cls, srv, mod in (
            ("jax", JaxBatcher, tiny_server, jfaults),
            ("port", ContinuousBatcher, server, tfaults)):
        cb = cls(srv, slots=2, segment=4, max_replays=3,
                 faults=mod.FaultPlan.from_spec(
                     "segment_fetch:exception@seg=1,n=3"))
        outs[name] = np.asarray(cb.generate([2, 7, 1, 8], max_new_tokens=12))
        reports[name] = cb.stats()["faults"]
        assert reports[name]["degrade_level"] == 2
        assert reports[name]["degrade_steps"] == {"1": 1, "2": 1}
        if name == "port":
            # the two attempts at level 0 reached two segments in flight,
            # those at levels 1 and 2 (the synchronous loop) one
            assert cb.stats()["pipeline"]["in_flight"]["2"] == 2
    np.testing.assert_array_equal(outs["port"], outs["jax"])
    np.testing.assert_array_equal(
        outs["port"], server.generate([2, 7, 1, 8], max_new_tokens=12))
    assert reports["port"] == reports["jax"]


def test_abandoned_stream_cancels_and_counts_in_faults(tiny_server, server):
    """A closed stream is cancelled at the next barrier (a joiner forces
    it) and counted in ``faults.cancelled``, as in JAX."""
    for cls, srv in ((JaxBatcher, tiny_server), (ContinuousBatcher, server)):
        cb = cls(srv, slots=2, segment=4)
        stream = cb.generate_stream([1, 2, 3], max_new_tokens=100)
        next(stream)
        stream.close()
        np.testing.assert_array_equal(
            cb.generate([9, 8], max_new_tokens=8),
            srv.generate([9, 8], max_new_tokens=8))
        assert _until(lambda cb=cb: cb.stats()["faults"]["cancelled"] == 1
                      and not cb.stats()["active_rows"], 30, 0.05)


# -- the port's own ----------------------------------------------------------


class _CountingEvent:
    """A stand-in CUDA event: counts ``synchronize`` and ``query`` calls
    (the work it stands for is done)."""

    def __init__(self, counts):
        self.counts = counts

    def synchronize(self):
        self.counts["synchronize"] += 1

    def query(self):
        self.counts["query"] += 1
        return True


@pytest.mark.parametrize("armed", ["default", "watchdog", "plan"])
def test_default_wait_synchronizes_and_never_polls(server, armed):
    """With no watchdog and an empty plan the segment wait calls
    ``event.synchronize()`` and never ``query()``; a watchdog or an armed
    plan makes it poll ``query()`` and never synchronize."""
    counts = {"synchronize": 0, "query": 0}
    kw = {"watchdog_s": 5.0} if armed == "watchdog" else {}
    if armed == "plan":
        kw["faults"] = FaultPlan.from_spec("group_prefill:delay@seg=99")
    cb = ContinuousBatcher(server, slots=2, segment=4, **kw)
    real = cb._run_segment

    def segment(live):
        rec = real(live)
        rec["event"] = _CountingEvent(counts)
        return rec

    cb._run_segment = segment
    np.testing.assert_array_equal(
        cb.generate([2, 7, 1], max_new_tokens=12),
        server.generate([2, 7, 1], max_new_tokens=12))
    segments = cb.stats()["segments"]
    assert segments == 3
    if armed == "default":
        assert counts == {"synchronize": segments, "query": 0}
        assert cb.stats()["polled_waits"] == 0
    else:
        assert counts["synchronize"] == 0 and counts["query"] >= segments
        assert cb.stats()["polled_waits"] == segments


def test_sticky_cuda_error_wedges_and_does_not_replay(server, monkeypatch):
    """A CUDA runtime error poisons the context: the engine replays
    nothing (the row gets the error at once), drops its step and
    programs, and stays wedged while its self-probe fails; once the probe
    succeeds the wedge clears."""
    cb = ContinuousBatcher(server, slots=2, segment=4, max_replays=1)
    cb.generate([1, 2], max_new_tokens=4)
    assert cb._programs is not None
    # a watchdog runs the self-probe (every 2 s at first); set after the
    # warm-up, so no real segment runs under it
    cb.watchdog_s = 1.0
    error = "CUDA error: an illegal memory access was encountered"
    probes = {"n": 0, "ok": False}

    def boom(live):
        raise RuntimeError(error)

    def probe():
        probes["n"] += 1
        if not probes["ok"]:
            raise RuntimeError(error)

    monkeypatch.setattr(cb, "_run_segment", boom)
    monkeypatch.setattr(cb, "_probe_op", probe)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        cb.generate([1, 2, 3], max_new_tokens=8)
    faults = cb.stats()["faults"]
    assert faults["replays"] == {"attempted": 0, "succeeded": 0}
    assert faults["failures"] == {"segment_dispatch": 1}
    assert faults["watchdog_trips"] == 0
    assert cb.wedged and not cb.fault_state()["restarting"]
    assert cb._step is None and cb._programs is None
    assert _until(lambda: probes["n"] >= 1, 20)
    time.sleep(0.2)
    assert cb.wedged  # the failed probe left it wedged
    probes["ok"] = True
    assert _until(lambda: not cb.wedged, 30, 0.05)
    assert cb.stats()["faults"]["recoveries"] == 1


def test_graphs_survive_an_injected_failure_and_not_a_trip(server):
    """The step and its programs survive a failure that did not come from
    the CUDA runtime (the replay reuses them); a watchdog trip drops
    them."""
    cb = ContinuousBatcher(
        server, slots=2, segment=4, watchdog_s=WATCHDOG_S,
        faults=FaultPlan.from_spec("segment_fetch:exception@seg=1"))
    cb.faults.clear()
    cb.generate([6, 5, 4], max_new_tokens=8)
    step, programs = cb._step, cb._programs
    cb.faults.arm("segment_fetch:exception")
    np.testing.assert_array_equal(
        cb.generate([6, 5, 4], max_new_tokens=8),
        server.generate([6, 5, 4], max_new_tokens=8))
    assert cb._step is step and cb._programs is programs
    cb.faults.arm("segment_fetch:hang@n=1")
    np.testing.assert_array_equal(
        cb.generate([6, 5, 4], max_new_tokens=8),
        server.generate([6, 5, 4], max_new_tokens=8))
    cb.faults.clear()
    assert cb.stats()["faults"]["watchdog_trips"] == 1
    assert cb._programs is not programs


def test_ladder_level_three_bypasses_the_prefix_store(weights):
    """At degradation level 3 the handler stops routing through the
    prefix store; the request serves unrouted, bitwise."""
    state = generate_handler(
        {"model": "llama-tiny",
         "extra": {**PAGED, "batch_mode": "continuous",
                   "warm_group_prefill": "0"}},
        HandlerContext(device="cpu", state_dict=weights))
    prompt = [(11 * j) % 300 + 3 for j in range(40)]
    want = state.server.generate(prompt, max_new_tokens=5).tolist()
    for level in (1, 2, 3):
        state.engine.fault_stats.record_degrade(level, "segment_fetch")
    out = state.invoke({"tokens": prompt, "max_new_tokens": 5})
    assert "prefix_cached" not in out and out["tokens"] == want
    assert state.prefix_store.stats()["misses"] == 0
    state.engine.fault_stats.record_restore()
    out = state.invoke({"tokens": prompt, "max_new_tokens": 5})
    assert out["prefix_cached"] and out["tokens"] == want


# -- HTTP: /healthz, the admission hole, /v1/debug/* -------------------------


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=30) as r:
        return json.loads(r.read())


def _post(base, path, body):
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_server_healthz_wedged_and_admission_accept_hole(tiny_server,
                                                         weights):
    """The twin of the JAX server test: a fetch that hangs twice trips
    the watchdog each time; ``/healthz`` reads ``ready: false,
    wedged: true`` (liveness 200), a request while the wedged engine
    restarts sheds 503 ``wedged`` with ``Retry-After``, the first request
    succeeds through its replays with the JAX engine's greedy tokens, and
    health and ``/metrics`` show the recovery."""
    state = generate_handler(
        {"model": "llama-tiny",
         "extra": {"batch_mode": "continuous", "batch_max": "2",
                   "batch_segment": "4", "warm_group_prefill": "0",
                   "engine_watchdog_s": str(WATCHDOG_S),
                   "max_replays": "8", "prefix_cache_mb": "0",
                   "fault_spec": "segment_fetch:hang@seg=2,n=2"}},
        HandlerContext(device="cpu", state_dict=weights))
    srv = BundleServer(state, port=0).start_background()
    base = srv.url
    try:
        h = _get(base, "/healthz")
        assert h["ok"] and h["ready"] and not h["wedged"]
        assert h["engine"] == {"wedged": False, "degrade_level": 0,
                               "restarting": False}
        done = {}

        def doomed():
            try:
                done["out"] = _post(base, "/invoke",
                                    {"tokens": [1, 2, 3],
                                     "max_new_tokens": 16})
            except Exception as e:  # noqa: BLE001 — inspected below
                done["err"] = e

        t = threading.Thread(target=doomed, daemon=True)
        t.start()
        assert _until(lambda: _get(base, "/healthz").get("wedged"), 30,
                      0.01)
        h = _get(base, "/healthz")
        assert not h["ready"] and h["ok"]
        sheds = 0
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and not sheds and not done:
            eng = _get(base, "/healthz").get("engine", {})
            if not (eng.get("wedged") and eng.get("restarting")):
                time.sleep(0.005)
                continue
            try:
                _post(base, "/invoke", {"tokens": [9, 9],
                                        "max_new_tokens": 4})
            except urllib.error.HTTPError as e:
                if e.code == 503:
                    body = json.loads(e.read())
                    assert body["shed"] == "wedged"
                    assert e.headers.get("Retry-After") == "2"
                    sheds += 1
        assert sheds, "admission never shed while wedged and restarting"
        t.join(timeout=60)
        assert done.get("out", {}).get("ok"), done
        assert done["out"]["tokens"] == [np.asarray(tiny_server.generate(
            [1, 2, 3], max_new_tokens=16))[0].tolist()]
        assert _until(lambda: _get(base, "/healthz")["ready"], 30, 0.05)
        m = _get(base, "/metrics")
        faults = m["handler"]["batching"]["faults"]
        assert faults["watchdog_trips"] >= 2
        assert faults["replays"] == {"attempted": faults["watchdog_trips"],
                                     "succeeded": 1}
        assert faults["recoveries"] == 1 and faults["wedged"] is False
        assert m["handler"]["faults"]["armed"]["rules"][0]["fired"] == 2
        assert m["sched"]["shed"]["by_reason"]["wedged"] == sheds
    finally:
        state.engine.faults.release()
        srv.stop()


def test_debug_faults_and_invariants_endpoints(weights):
    """``POST /v1/debug/faults`` arms and clears the live plan (a bad spec
    is a 400 that changes nothing), ``GET /v1/debug/invariants`` sweeps
    the pool and the store, and ``/metrics`` shows ``faults.armed``."""
    state = generate_handler(
        {"model": "llama-tiny",
         "extra": {**PAGED, "batch_mode": "continuous",
                   "warm_group_prefill": "0"}},
        HandlerContext(device="cpu", state_dict=weights))
    srv = BundleServer(state, port=0).start_background()
    base = srv.url
    try:
        out = _post(base, "/v1/debug/faults",
                    {"spec": "segment_fetch:exception@seg=1"})
        assert out["ok"] and out["armed"]["sites"] == ["segment_fetch"]
        # a fleet site arms on a replica's plan as on JAX's replica, and
        # never fires there; a bad spec is a 400 that changes nothing
        out = _post(base, "/v1/debug/faults", {"spec": "probe:exception"})
        assert out["ok"] and out["armed"]["sites"] \
            == ["probe", "segment_fetch"]
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(base, "/v1/debug/faults", {"spec": "probe:nope"})
        assert exc.value.code == 400
        assert "bad fault spec" in json.loads(exc.value.read())["error"]
        r = _post(base, "/invoke", {"tokens": list(range(1, 41)),
                                    "max_new_tokens": 6})
        assert r["ok"] and r["tokens"] == state.server.generate(
            list(range(1, 41)), max_new_tokens=6).tolist()
        m = _get(base, "/metrics")
        assert m["handler"]["faults"]["armed"]["rules"][0]["fired"] == 1
        assert m["handler"]["batching"]["faults"]["replays"] \
            == {"attempted": 1, "succeeded": 1}
        out = _post(base, "/v1/debug/faults", {"clear": True})
        assert out["ok"] and out["cleared"] == 2
        assert not out["armed"]["active"]
        assert _until(lambda: not state.engine._engine_running, 10)
        inv = _get(base, "/v1/debug/invariants")
        assert inv["ok"], inv
        assert inv["checks"]["page_pool"]["ok"]
        assert inv["checks"]["prefix_store"]["ok"]
        assert inv["checks"]["engine"]["wedged"] is False
    finally:
        srv.stop()


def test_non_engine_handler_has_no_fault_plan(weights):
    """Without a continuous engine the handler owns no plan, as in JAX:
    the control surface says so and ``/healthz`` has no engine block."""
    state = generate_handler({"model": "llama-tiny",
                              "extra": {"prefix_cache_mb": "0"}},
                             HandlerContext(device="cpu",
                                            state_dict=weights))
    assert not state.faults_admin_fn({"spec": "transport:delay"})["ok"]
    assert state.engine_fault_fn is None
    srv = BundleServer(state, port=0).start_background()
    try:
        h = _get(srv.url, "/healthz")
        assert h["ready"] and not h["wedged"] and "engine" not in h
        assert "faults" not in _get(srv.url, "/metrics")["handler"]
    finally:
        srv.stop()


def test_cancelled_rows_count_once_in_each_block(server):
    """A queued row whose deadline passed is cancelled at the barrier and
    counted by the engine's counters and its ``faults`` block alike."""
    from lambdipy_tpu_torch.sched import (clear_request_context,
                                          set_request_context)

    cb = ContinuousBatcher(server, slots=1, segment=4,
                           faults=FaultPlan.from_spec(
                               "transport:delay@ms=120,n=2"))
    out = {}
    t = threading.Thread(target=lambda: out.setdefault(
        "a", cb.generate([7, 7], max_new_tokens=32)))
    t.start()
    assert _until(lambda: cb.stats()["active_rows"] >= 1, 20, 0.005)
    set_request_context(cls="interactive", deadline_ms=50.0)
    try:
        with pytest.raises(RequestCancelled):
            cb.generate([1, 2, 3], max_new_tokens=8)
    finally:
        clear_request_context()
    t.join(timeout=60)
    np.testing.assert_array_equal(out["a"],
                                  server.generate([7, 7], max_new_tokens=32))
    stats = cb.stats()
    assert stats["cancelled"] == stats["faults"]["cancelled"] == 1
