"""The port's chaos soak (``lambdipy_tpu_torch/chaos/``) against
``lambdipy_tpu/chaos/`` and ``tests/test_chaos.py``, on the CPU:

- the twins of ``tests/test_chaos.py``'s tests on the port's modules:
  timeline grammar and determinism, the nemesis executor, the workload
  plan, the history and quiesce checker, the prefix store's invariant
  sweep, the server's debug surfaces, and a soak-style window with
  ``offload_stall`` composed in over the port's tiny server, store and
  offload arena (weights carried from the JAX ``llama-tiny``; its greedy
  tokens also the JAX server's);
- what JAX's own tests cannot check: for seeds 0, 7, 11, 23, 99 and
  1234 the two packages render byte-identical timelines and build equal
  plans, a timeline rendered by one parses in the other, and the two
  checkers give the same verdicts, tallies and violations on the same
  histories and sweeps, the canary included;
- the soak itself: one live 12 s window of the port's soak on a CPU
  ``llama-tiny`` fleet (``SoakFleet(device="cpu")``), the entry point's
  refusals, and (``slow``) its CI mode: seeds 11 and 23 at 22 s and a
  determinism re-run."""

import json
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest

from lambdipy_tpu.chaos import checker as jchecker
from lambdipy_tpu.chaos import nemesis as jnemesis
from lambdipy_tpu.chaos import workload as jworkload
from lambdipy_tpu.models import registry as jreg
from lambdipy_tpu_torch.chaos.checker import check_history, check_quiesce
from lambdipy_tpu_torch.chaos.nemesis import (
    ROUTER,
    FleetOps,
    Nemesis,
    NemesisEvent,
    _fault_menu,
    generate_timeline,
    parse_timeline,
    render_timeline,
    timeline_properties,
)
from lambdipy_tpu_torch.chaos.workload import (
    Outcome,
    build_plan,
    precompute_expected,
)
from lambdipy_tpu_torch.models import registry as treg
from lambdipy_tpu_torch.models.params import from_jax_params
from lambdipy_tpu_torch.runtime.faults import REGISTRY

REPLICAS = ["r0", "r1"]
SEEDS = [0, 7, 11, 23, 99, 1234]
EXTRA = {"attn_backend": "blocked"}
REPO = Path(__file__).resolve().parents[1]


# -- timeline grammar ---------------------------------------------------------


def test_event_grammar_round_trip():
    events = [
        NemesisEvent(1.25, "arm", "r0", "segment_fetch:exception@n=2"),
        NemesisEvent(3.5, "clear", "r0"),
        NemesisEvent(4.0, "kill", "r1"),
        NemesisEvent(5.125, "drain", "r0"),
        NemesisEvent(7.0, "undrain", "r0"),
        NemesisEvent(8.0, "arm", ROUTER,
                     "route_latency:delay@ms=120,n=3"),
    ]
    text = render_timeline(events)
    parsed = parse_timeline(text)
    assert render_timeline(parsed) == text
    assert parsed[0].spec == "segment_fetch:exception@n=2"


def test_parse_timeline_skips_comments_and_sorts():
    text = ("# a hand-edited replay file\n"
            "@5.0 kill r1\n"
            "\n"
            "@1.0 arm r0 transport:delay@ms=50\n")
    events = parse_timeline(text)
    assert [e.action for e in events] == ["arm", "kill"]


@pytest.mark.parametrize("line", [
    "no-at arm r0 transport:delay",          # missing @T
    "@1.0 explode r0",                       # unknown action
    "@1.0 arm r0",                           # arm without a spec
    "@1.0 arm r0 not_a_site:exception",      # unregistered site
    "@1.0 arm r0 transport:sideways",        # unknown kind
    "@1.0 kill r0 transport:delay@ms=5",     # spec on a non-arm event
    "@x arm r0 transport:delay",             # bad time
])
def test_parse_rejects_bad_lines(line):
    with pytest.raises(ValueError):
        NemesisEvent.parse(line)
    # the JAX parser refuses the same line
    with pytest.raises(ValueError):
        jnemesis.NemesisEvent.parse(line)


# -- schedule generation ------------------------------------------------------


def test_same_seed_byte_identical_timeline():
    a = render_timeline(generate_timeline(seed=11, duration_s=22.0,
                                          replicas=REPLICAS))
    b = render_timeline(generate_timeline(seed=11, duration_s=22.0,
                                          replicas=REPLICAS))
    assert a == b
    c = render_timeline(generate_timeline(seed=12, duration_s=22.0,
                                          replicas=REPLICAS))
    assert c != a


@pytest.mark.parametrize("seed", SEEDS)
def test_generated_schedule_structural_floor(seed):
    """Every generated schedule meets the composed-fault acceptance
    floor: >= 1 kill, >= 1 drain, a sustained >= 2-fault overlap, peak
    overlap bounded, arm specs drawn from the site registry, and never
    two concurrent faults on one target."""
    events = generate_timeline(seed=seed, duration_s=22.0,
                               replicas=REPLICAS)
    props = timeline_properties(events)
    assert props["kills"] >= 1 and props["drains"] >= 1
    assert props["peak_overlap"] >= 2
    assert props["peak_overlap"] <= 3
    assert props["sustained_overlap_s"] >= 1.0
    open_by_target: dict = {}
    for e in sorted(events, key=lambda e: e.t):
        if e.action == "arm":
            assert e.target not in open_by_target, \
                f"two concurrent faults on {e.target}"
            open_by_target[e.target] = e.t
            site = e.spec.partition(":")[0]
            assert site in REGISTRY
        elif e.action == "clear":
            open_by_target.pop(e.target, None)
    assert not open_by_target, "an armed fault was never cleared"


def test_generated_schedule_respects_kill_window():
    """Faults never target a replica after its worker was SIGKILLed."""
    for seed in range(20):
        events = generate_timeline(seed=seed, duration_s=22.0,
                                   replicas=REPLICAS)
        kill = next(e for e in events if e.action == "kill")
        for e in events:
            if e.action == "arm" and e.target == kill.target:
                clear = next(c for c in events
                             if c.action == "clear"
                             and c.target == e.target and c.t > e.t)
                assert clear.t <= kill.t


# -- the executor -------------------------------------------------------------


class _FakeOps(FleetOps):
    def __init__(self):
        self.calls = []

    def arm(self, target, spec):
        if spec.startswith("page_alloc"):
            raise RuntimeError("replica is mid-respawn")
        self.calls.append(("arm", target, spec))

    def clear(self, target):
        self.calls.append(("clear", target))

    def kill(self, target):
        self.calls.append(("kill", target))

    def drain(self, target):
        self.calls.append(("drain", target))

    def undrain(self, target):
        self.calls.append(("undrain", target))


def test_nemesis_executor_applies_in_order_and_survives_errors():
    timeline = [
        NemesisEvent(0.02, "arm", "r0", "transport:delay@ms=10"),
        NemesisEvent(0.04, "arm", "r1", "page_alloc:exception"),  # raises
        NemesisEvent(0.06, "kill", "r1"),
        NemesisEvent(0.08, "clear", "r0"),
    ]
    ops = _FakeOps()
    applied = Nemesis(timeline, ops).run()
    assert [a.event.action for a in applied] == \
        ["arm", "arm", "kill", "clear"]
    errors = [a for a in applied if a.error]
    assert len(errors) == 1 and "mid-respawn" in errors[0].error
    assert ("kill", "r1") in ops.calls and ("clear", "r0") in ops.calls


# -- the workload plan --------------------------------------------------------


def test_build_plan_deterministic_and_mixed():
    a = build_plan(seed=5, duration_s=20.0)
    b = build_plan(seed=5, duration_s=20.0)
    assert a.requests == b.requests
    assert sorted(a.sessions) == sorted(b.sessions)
    for sid in a.sessions:
        assert a.sessions[sid]["turns"] == b.sessions[sid]["turns"]
    reqs = a.all_requests()
    kinds = {r.kind for r in reqs}
    assert kinds == {"cold", "prefix", "session"}
    assert any(r.stream for r in reqs) and any(not r.stream for r in reqs)
    assert any("seed" in r.kw for r in reqs) \
        and any(not r.kw for r in reqs)
    assert len({r.rid for r in reqs}) == len(reqs)


def _fake_completion(row, kw, max_tokens):
    # deterministic fake: answer depends on the prompt, like a model
    return [sum(row) % 97, len(row) % 89][:max_tokens]


def test_precompute_expected_builds_session_transcripts():
    plan = build_plan(seed=3, duration_s=10.0, n_sessions=1, turns=3,
                      n_cold=1, n_prefix_groups=0)
    precompute_expected(plan, _fake_completion)
    (conv,) = plan.sessions.values()
    history = list(conv["first"])
    for turn, req in enumerate(conv["turns"]):
        assert req.row == history
        assert req.expected == _fake_completion(history, req.kw,
                                                req.max_tokens)
        history = history + req.expected + conv["users"][turn]


# -- the history checker ------------------------------------------------------


def _outcome(rid, status, *, tokens=None, expected=(1, 2, 3), took=0.5,
             cls=Outcome, **kw):
    return cls(rid=rid, kind=kw.pop("kind", "cold"),
               streamed=kw.pop("streamed", False),
               sampled=False, t_start=100.0, t_end=100.0 + took,
               status=status, tokens=tokens,
               expected=list(expected), **kw)


def test_checker_accepts_clean_history():
    v = check_history([
        _outcome(1, "ok", tokens=[1, 2, 3]),
        _outcome(2, "shed", http_status=503, shed_reason="kv_pages",
                 retry_after_s=2.0),
        _outcome(3, "shed", http_status=504, shed_reason="timeout"),
        _outcome(4, "stream_error", streamed=True, tokens=[1, 2]),
        _outcome(5, "stream_truncated", streamed=True, tokens=[1]),
    ], waiter_bound_s=60.0)
    assert v["ok"], v["violations"]
    assert v["tallies"]["delivered"] == 1 and v["tallies"]["sheds"] == 2


def test_checker_rejects_wrong_bytes_as_silent_corruption():
    v = check_history([_outcome(1, "ok", tokens=[9, 9, 9])],
                      waiter_bound_s=60.0)
    assert not v["ok"]
    assert any("WRONG tokens" in x for x in v["violations"])


def test_checker_rejects_diverged_stream_prefix():
    v = check_history(
        [_outcome(1, "stream_truncated", streamed=True, tokens=[1, 9])],
        waiter_bound_s=60.0)
    assert not v["ok"]
    assert any("diverged" in x for x in v["violations"])


def test_checker_rejects_uncontracted_failures_and_slow_waiters():
    v = check_history([
        _outcome(1, "http_error", http_status=500),
        _outcome(2, "exception", detail="ConnectionResetError"),
        _outcome(3, "ok", tokens=[1, 2, 3], took=120.0),
    ], waiter_bound_s=60.0)
    assert not v["ok"]
    joined = "\n".join(v["violations"])
    assert "silent loss" in joined and "waiter outlived" in joined


def test_checker_canary_suppressed_shed_fails_the_oracle():
    """The same history passes the normal oracle and FAILS when the shed
    counter is suppressed: the checker can actually reject."""
    history = [
        _outcome(1, "ok", tokens=[1, 2, 3]),
        _outcome(2, "shed", http_status=503, shed_reason="canary",
                 retry_after_s=1.0),
    ]
    assert check_history(history, waiter_bound_s=60.0)["ok"]
    v = check_history(history, waiter_bound_s=60.0,
                      suppress_sheds=True)
    assert not v["ok"]
    assert any("accounting does not converge" in x
               for x in v["violations"])


# -- the quiesce checker ------------------------------------------------------


def _clean_metrics(pinned=0, sessions=0, armed=False):
    return {"handler": {
        "prefix_cache": {"pinned_leaves": pinned, "pinned_bytes": pinned,
                         "sessions_active": sessions},
        "faults": {"armed": {"active": armed,
                             "sites": ["transport"] if armed else []}},
    }}


QUIESCE_CASES = {
    "converged": (
        {"ok": True, "replicas": {"r0": {"ok": True}}, "spill_depth": 0},
        {"r0": _clean_metrics()},
        {"fleet": {"sessions": {"active": 0}},
         "faults": {"armed": {"active": False}}}),
    "leaks": (
        {"ok": False,
         "replicas": {"r0": {"ok": False, "violations": ["x"]}},
         "spill_depth": 2},
        {"r0": _clean_metrics(pinned=3),
         "r1": _clean_metrics(armed=True),
         "r2": None},
        {"fleet": {"sessions": {"active": 1}},
         "faults": {"armed": {"active": True, "sites": ["kv_ship"]}}}),
}


def test_quiesce_accepts_converged_fleet():
    inv, per, rm = QUIESCE_CASES["converged"]
    v = check_quiesce(inv, per, router_metrics=rm)
    assert v["ok"], v["violations"]


def test_quiesce_rejects_leaks_and_leftover_faults():
    inv, per, rm = QUIESCE_CASES["leaks"]
    v = check_quiesce(inv, per, router_metrics=rm)
    joined = "\n".join(v["violations"])
    for needle in ("invariant sweep failed", "spill depth 2",
                   "pinned_leaves=3", "still armed", "no /metrics",
                   "open session"):
        assert needle in joined, (needle, joined)


# -- the port's tiny server ---------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    adapter = jreg.get("llama-tiny").build(extra=EXTRA)
    params = adapter.init_params(seed=0)
    return adapter, params, from_jax_params(
        jax.tree_util.tree_map(np.asarray, params))


@pytest.fixture
def server(weights):
    return treg.get("llama-tiny").build(extra=EXTRA).make_server(
        weights[2], device="cpu")


# -- prefix-store invariant sweep --------------------------------------------


def test_prefixstore_check_invariants_clean_and_corrupted(server):
    from lambdipy_tpu_torch.runtime.prefixstore import PrefixStore

    store = PrefixStore(server, block=16, budget_mb=4)
    out = store.check_invariants()
    assert out["ok"] and out["violations"] == []
    assert out["pinned_leaves"] == 0 and out["blocks"] == 0
    # corrupt a counter: the sweep must notice the books don't balance
    store._pinned_leaves = 5
    out = store.check_invariants()
    assert not out["ok"]
    assert any("pinned_leaves" in x for x in out["violations"])
    store._pinned_leaves = 0


# -- the server debug surfaces ------------------------------------------------


def _stub_server(**fns):
    from lambdipy_tpu_torch.runtime.handlers import HandlerState
    from lambdipy_tpu_torch.runtime.server import BundleServer

    state = HandlerState(invoke_fn=lambda req: {"ok": True},
                         meta={"model": "stub"}, **fns)
    return BundleServer(state, port=0).start_background()


def test_server_debug_invariants_endpoint():
    srv = _stub_server(debug_invariants_fn=lambda: {
        "ok": True, "checks": {"prefix_store": {"ok": True}}})
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/v1/debug/invariants",
                timeout=10) as r:
            out = json.loads(r.read())
        assert out["ok"] and out["checks"]["prefix_store"]["ok"]
    finally:
        threading.Thread(target=srv.stop, daemon=True).start()


def test_server_debug_faults_endpoint_arms_live_plan():
    """POST /v1/debug/faults drives a REAL FaultPlan: arm fires on the
    next matching call, clear releases the rules — the nemesis's whole
    control contract, minus the fleet."""
    from lambdipy_tpu_torch.runtime.faults import FaultPlan, InjectedFault

    plan = FaultPlan.empty()

    def faults_admin(req):
        if req.get("clear"):
            return {"ok": True, "cleared": plan.clear(),
                    "armed": plan.armed()}
        try:
            return {"ok": True, "added": plan.arm(req["spec"]),
                    "armed": plan.armed()}
        except (KeyError, ValueError) as e:
            return {"ok": False, "error": str(e)}

    srv = _stub_server(faults_admin_fn=faults_admin)
    base = f"http://127.0.0.1:{srv.port}"

    def post(payload):
        req = urllib.request.Request(
            f"{base}/v1/debug/faults",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=10) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        code, out = post({"spec": "transport:exception@n=1"})
        assert code == 200 and out["armed"]["active"]
        with pytest.raises(InjectedFault):
            plan.check("transport")
        code, out = post({"spec": "not_a_site:exception"})
        assert code == 400 and "bad fault spec" in out["error"]
        code, out = post({"clear": True})
        assert code == 200 and not out["armed"]["active"]
        plan.check("transport")  # cleared: no fire
    finally:
        threading.Thread(target=srv.stop, daemon=True).start()


def test_replay_timeline_drives_identical_event_sequence():
    """A timeline rendered to a file and parsed back drives EXACTLY the
    same action sequence as the original."""
    original = generate_timeline(seed=11, duration_s=22.0,
                                 replicas=REPLICAS)
    replayed = parse_timeline(render_timeline(original))
    ops_a, ops_b = _FakeOps(), _FakeOps()
    Nemesis(original, ops_a, time_scale=0.002).run()
    Nemesis(replayed, ops_b, time_scale=0.002).run()
    assert ops_a.calls == ops_b.calls
    assert len(ops_a.calls) >= 5


def test_generate_timeline_rejects_unfittable_configs():
    with pytest.raises(ValueError, match="too short"):
        generate_timeline(seed=1, duration_s=5.0, replicas=REPLICAS)
    with pytest.raises(ValueError, match=">= 2 replicas"):
        generate_timeline(seed=1, duration_s=22.0, replicas=["r0"])


# -- the offload_stall nemesis legs -------------------------------------------


def test_fault_menu_offers_offload_stall_legs():
    menu = _fault_menu(REPLICAS + [ROUTER])
    assert ("r0", "offload_stall", "delay") in menu
    assert ("r1", "offload_stall", "exception") in menu
    assert not any(site == "offload_stall" and kind == "hang"
                   for _, site, kind in menu)
    assert not any(t == ROUTER and site == "offload_stall"
                   for t, site, _ in menu)


@pytest.mark.parametrize("seed", SEEDS)
def test_timeline_must_include_guarantees_offload_stall(seed):
    events = generate_timeline(seed=seed, duration_s=22.0,
                               replicas=REPLICAS,
                               must_include="offload_stall")
    arms = [e for e in events if e.action == "arm"
            and e.spec.partition(":")[0] == "offload_stall"]
    assert arms, "no offload_stall leg in the guaranteed schedule"
    props = timeline_properties(events)
    assert props["kills"] >= 1 and props["drains"] >= 1
    assert props["peak_overlap"] <= 3
    again = generate_timeline(seed=seed, duration_s=22.0,
                              replicas=REPLICAS,
                              must_include="offload_stall")
    assert render_timeline(events) == render_timeline(again)
    with pytest.raises(ValueError, match="no menu legs"):
        generate_timeline(seed=seed, duration_s=22.0,
                          replicas=REPLICAS,
                          must_include="no_such_site")


def test_soak_window_composed_offload_stall_zero_silent_loss(server,
                                                             weights):
    """A soak-style window with offload_stall composed in, in process
    on the port's tiny server: requests riding SPILLED prefixes under an
    armed offload_stall still deliver bitwise tokens (the delay leg a
    timed re-online stall, the exception leg a counted recompute). The
    history checker is the oracle: zero silent losses. The reference's
    greedy tokens are also the JAX server's on the same weights."""
    from lambdipy_tpu_torch.models.llama import (init_page_arena,
                                                 page_kv_bytes)
    from lambdipy_tpu_torch.runtime.continuous import ContinuousBatcher
    from lambdipy_tpu_torch.runtime.faults import FaultPlan
    from lambdipy_tpu_torch.runtime.offload import OffloadArena
    from lambdipy_tpu_torch.runtime.pagepool import PagePool, page_width
    from lambdipy_tpu_torch.runtime.prefixstore import PrefixStore

    cfg = server.model.cfg
    page = page_width(cfg.max_len, 16)
    n_pages = 2 * (cfg.max_len // page) + 1 + 4
    pool = PagePool(n_pages=n_pages, page=page,
                    page_bytes=page_kv_bytes(cfg, page),
                    make_arena=lambda: init_page_arena(cfg, n_pages, page,
                                                       "cpu"))
    plan = FaultPlan.empty()
    store = PrefixStore(server, pool=pool)
    off = OffloadArena(page=pool.page, layers=cfg.layers, faults=plan)
    store.attach_offload(off)
    eng = ContinuousBatcher(server, slots=2, segment=4, page_pool=pool)
    eng.prefix_pages_fn = store.acquire_pages

    row = np.random.default_rng(31).integers(5, 100, size=65).tolist()
    ref = np.asarray(server.generate(row, max_new_tokens=8)).ravel()
    adapter, params, _ = weights
    jref = np.asarray(adapter.make_server(params).generate(
        row, max_new_tokens=8)).ravel()
    assert ref.tolist() == jref.tolist()

    def request(rid, kind):
        t0 = time.monotonic()
        m = store.route(row)
        assert m == 64
        out = eng.generate(row[m:], max_new_tokens=8,
                           prefix=np.asarray(row[:m], np.int32))
        # the row retires before the spill: its page refs drop
        deadline = time.monotonic() + 10.0
        with eng._lock:
            while eng._engine_running and time.monotonic() < deadline:
                eng._lock.wait(0.05)
        return Outcome(rid=rid, kind=kind, streamed=False,
                       sampled=False, t_start=t0,
                       t_end=time.monotonic(), status="ok",
                       tokens=np.asarray(out).ravel().tolist(),
                       expected=ref.tolist())

    outcomes = [request(1, "cold")]
    # spill the whole prefix to the host tier, then hit it under the
    # DELAY leg: the batched re-online pays the injected stall
    while store.reclaim_pages(1):
        pass
    assert store.check_invariants()["offloaded_blocks"] == 4
    plan.arm("offload_stall:delay@ms=60,n=1")
    outcomes.append(request(2, "hit"))
    assert off.report()["reonlines"] >= 1
    # spill again and hit under the EXCEPTION leg: the failed re-online
    # degrades to the recompute, counted
    while store.reclaim_pages(1):
        pass
    plan.clear()
    plan.arm("offload_stall:exception@n=1")
    outcomes.append(request(3, "hit"))
    assert off.report()["recomputes"] >= 1
    v = check_history(outcomes, waiter_bound_s=60.0)
    assert v["ok"], v["violations"]
    assert v["tallies"]["delivered"] == 3
    assert v["tallies"]["silent"] == 0


# -- across the two packages --------------------------------------------------


@pytest.mark.parametrize("duration_s", [12.0, 22.0])
@pytest.mark.parametrize("seed", SEEDS)
def test_timelines_byte_identical_across_packages(seed, duration_s):
    """The same seed, replicas and ``must_include`` render the same
    timeline text in both packages (the registries are equal site for
    site, so the menus and every draw are)."""
    kw = dict(seed=seed, duration_s=duration_s,
              replicas=["soak-r0", "soak-r1"],
              must_include="offload_stall")
    port = render_timeline(generate_timeline(**kw))
    ref = jnemesis.render_timeline(jnemesis.generate_timeline(**kw))
    assert port == ref
    assert timeline_properties(parse_timeline(port)) == \
        jnemesis.timeline_properties(jnemesis.parse_timeline(ref))


def test_fault_menus_equal_across_packages():
    targets = ["soak-r0", "soak-r1", ROUTER]
    assert _fault_menu(targets) == jnemesis._fault_menu(targets)


@pytest.mark.parametrize("seed", SEEDS)
def test_timelines_parse_across_packages(seed):
    """A timeline rendered by JAX is parsed by the port and renders the
    same text, and the reverse (here at the default overlap and extras,
    without ``must_include``)."""
    jax_text = jnemesis.render_timeline(jnemesis.generate_timeline(
        seed=seed, duration_s=22.0, replicas=REPLICAS))
    assert render_timeline(parse_timeline(jax_text)) == jax_text
    port_text = render_timeline(generate_timeline(
        seed=seed, duration_s=22.0, replicas=REPLICAS))
    assert jnemesis.render_timeline(
        jnemesis.parse_timeline(port_text)) == port_text
    assert port_text == jax_text


def _plan_doc(plan) -> dict:
    return {"seed": plan.seed, "duration_s": plan.duration_s,
            "requests": [r.__dict__ for r in plan.requests],
            "sessions": {sid: {**conv, "turns": [t.__dict__
                                                 for t in conv["turns"]]}
                         for sid, conv in plan.sessions.items()}}


@pytest.mark.parametrize("seed", SEEDS)
def test_build_plan_equal_across_packages(seed):
    """``build_plan`` at the soak's arguments (block 32, 8 new tokens)
    gives equal plans in both packages, and the expected outputs filled
    in from one completion function are equal too."""
    kw = dict(seed=seed, duration_s=22.0, n_new=8, prefix_len=32,
              first_len=33)
    port, ref = build_plan(**kw), jworkload.build_plan(**kw)
    assert _plan_doc(port) == _plan_doc(ref)
    precompute_expected(port, _fake_completion)
    jworkload.precompute_expected(ref, _fake_completion)
    assert _plan_doc(port) == _plan_doc(ref)


HISTORIES = {
    "clean": [
        dict(rid=1, status="ok", tokens=[1, 2, 3]),
        dict(rid=2, status="shed", http_status=503, shed_reason="kv_pages",
             retry_after_s=2.0),
        dict(rid=3, status="shed", http_status=504, shed_reason="timeout"),
        dict(rid=4, status="stream_error", streamed=True, tokens=[1, 2]),
        dict(rid=5, status="stream_truncated", streamed=True, tokens=[1]),
    ],
    "wrong_bytes": [dict(rid=1, status="ok", tokens=[9, 9, 9])],
    "diverged_stream": [dict(rid=1, status="stream_truncated",
                             streamed=True, tokens=[1, 9])],
    "uncontracted": [
        dict(rid=1, status="http_error", http_status=500),
        dict(rid=2, status="exception", detail="ConnectionResetError"),
        dict(rid=3, status="ok", tokens=[1, 2, 3], took=120.0),
    ],
    "canary": [
        dict(rid=1, status="ok", tokens=[1, 2, 3]),
        dict(rid=2, status="shed", http_status=503, shed_reason="canary",
             retry_after_s=1.0),
    ],
}


@pytest.mark.parametrize("suppress", [False, True])
@pytest.mark.parametrize("name", sorted(HISTORIES))
def test_check_history_agrees_across_packages(name, suppress):
    """Both checkers give the same ``ok``, tallies and violations on the
    JAX tests' synthetic histories, with and without the shed counter
    (the canary's two legs)."""
    def build(cls):
        out = []
        for doc in HISTORIES[name]:
            doc = dict(doc)
            out.append(_outcome(doc.pop("rid"), doc.pop("status"),
                                cls=cls, **doc))
        return out

    port = check_history(build(Outcome), waiter_bound_s=60.0,
                         suppress_sheds=suppress)
    ref = jchecker.check_history(build(jworkload.Outcome),
                                 waiter_bound_s=60.0,
                                 suppress_sheds=suppress)
    assert port == ref


def test_soak_canary_outcome_agrees_across_packages():
    """The soak's canary record is JAX's, and on a clean history both
    checkers accept it normally and reject it suppressed."""
    from lambdipy_tpu.chaos import soak as jsoak
    from lambdipy_tpu_torch.chaos import soak as tsoak

    assert tsoak._canary_outcome().__dict__ == \
        jsoak._canary_outcome().__dict__
    for suppress in (False, True):
        port = check_history(
            [_outcome(1, "ok", tokens=[1, 2, 3]), tsoak._canary_outcome()],
            waiter_bound_s=90.0, suppress_sheds=suppress)
        ref = jchecker.check_history(
            [_outcome(1, "ok", tokens=[1, 2, 3], cls=jworkload.Outcome),
             jsoak._canary_outcome()],
            waiter_bound_s=90.0, suppress_sheds=suppress)
        assert port == ref
        assert port["ok"] is (not suppress)


@pytest.mark.parametrize("name", sorted(QUIESCE_CASES))
def test_check_quiesce_agrees_across_packages(name):
    inv, per, rm = QUIESCE_CASES[name]
    for router_metrics in (rm, None):
        assert check_quiesce(inv, per, router_metrics=router_metrics) == \
            jchecker.check_quiesce(inv, per, router_metrics=router_metrics)


# -- the soak on a CPU fleet --------------------------------------------------


def test_soak_entry_point_refuses_without_a_card_and_short_windows():
    """Without a card and without ``--device cpu`` the entry point exits
    1 before it builds anything; a window under 12 s is refused before
    the fleet boots."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal cannot show")
    proc = subprocess.run(
        [sys.executable, "-m", "lambdipy_tpu_torch.chaos.soak"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1
    assert "no CUDA device" in proc.stderr
    from lambdipy_tpu_torch.chaos import soak as tsoak

    assert tsoak.main(["--device", "cpu", "--soak-seconds", "5"]) == 1


def test_soak_live_window_on_a_cpu_fleet(tmp_path, monkeypatch):
    """One live 12 s window (seed 11, ``must_include="offload_stall"``)
    of the port's soak over a 2-replica CPU ``llama-tiny`` fleet: JAX's
    whole oracle (history, the kill and the drain applied, a sustained
    overlap, quiesce, the bitwise post-storm completion, the canary),
    and the window's timeline is JAX's for the same seed."""
    from lambdipy_tpu_torch.chaos import soak as tsoak

    monkeypatch.setenv("HOME", str(tmp_path))
    fleet = tsoak.SoakFleet(device="cpu", plan_seeds=((11, 12.0),))
    try:
        rec = tsoak.run_window(fleet, seed=11, duration_s=12.0)
    finally:
        fleet.close()
    assert rec["ok"], rec["violations"]
    assert rec["tallies"]["silent"] == 0
    assert rec["canary"] == {"normal_ok": True, "suppressed_fails": True}
    assert rec["timeline"] == jnemesis.render_timeline(
        jnemesis.generate_timeline(seed=11, duration_s=12.0,
                                   replicas=list(tsoak.REPLICAS),
                                   must_include="offload_stall"))


@pytest.mark.slow
def test_soak_ci_mode_on_a_cpu_fleet(tmp_path, monkeypatch):
    """The entry point's CI mode on the CPU: seeds 11 and 23 at 22 s and
    the determinism re-run of seed 11 (a byte-identical timeline, the
    same verdict)."""
    from lambdipy_tpu_torch.chaos import soak as tsoak

    monkeypatch.setenv("HOME", str(tmp_path))
    rec = tsoak.soak_record(device="cpu")
    assert rec["passed"] and rec["platform"] == "cpu"
    assert [w["seed"] for w in rec["windows"]] == [11, 23]
    assert all(w["ok"] for w in rec["windows"])
    assert rec["determinism"]["timeline_identical"]
    assert rec["determinism"]["verdict_identical"]
