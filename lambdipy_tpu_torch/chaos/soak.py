"""Composed-fault soak orchestrator (``python -m lambdipy_tpu_torch.chaos.soak``).

The port's copy of ``lambdipy_tpu/chaos/soak.py``, over the port's
replicas: on the card unless asked for the CPU (``--device cpu``).

One soak window = one seed: a 2-replica MANAGED fleet (supervised
subprocess bundle servers behind the resilient sticky-session router —
r0 dense KV, r1 paged, bitwise-identical by the paged engine's gate, so
the mixed fleet covers both modes in one run) takes the seeded open-loop
workload while the seeded nemesis arms/clears composed faults, SIGKILLs
a worker, and drains a replica on the same clock. Afterwards the fleet
QUIESCES (faults cleared, recovery awaited, sessions closed, one lease
left to expire) and the checker judges the recorded history plus the
live accounting sweep.

Replayability: a failing run writes its exact event timeline next to
the verdict and names the one-command replay
(``python -m lambdipy_tpu_torch.chaos.soak --seed N --replay-timeline
FILE``) — same seed, same workload, same schedule, same oracle.

The fleet boots ONCE and serves every seed window: radix caches warm
across windows (expected outputs never change — greedy or seeded
sampling only) and the determinism leg re-runs the first seed on the
same fleet, asserting a byte-identical timeline and an identical
verdict.

``SoakFleet`` serves the bundle it is given (``bundle=``), or builds
JAX's tiny soak bundle from its recipe dict; the bounds of a window's
waits are arguments of :func:`run_window`, JAX's long ones by default.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
import urllib.request
from pathlib import Path

from lambdipy_tpu_torch.chaos.checker import check_history, check_quiesce
from lambdipy_tpu_torch.chaos.nemesis import (
    ROUTER,
    FleetOps,
    Nemesis,
    generate_timeline,
    parse_timeline,
    render_timeline,
    timeline_properties,
)
from lambdipy_tpu_torch.chaos.workload import (
    build_plan,
    precompute_expected,
    run_workload,
)
from lambdipy_tpu_torch.utils.logs import get_logger, log_event

log = get_logger("lambdipy.chaos.soak")

REPLICAS = ("soak-r0", "soak-r1")


def _post_json(url: str, payload: dict, timeout: float = 30.0) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _get_json(url: str, timeout: float = 30.0) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


class LiveFleetOps(FleetOps):
    """Nemesis actions against the live fleet: replica-owned fault
    specs arm over ``POST /v1/debug/faults`` (the replica's one
    LAMBDIPY_FAULT-scope plan drives engine, store, and pool sites);
    ``router`` events mutate the in-process router/pool plan directly;
    kill SIGKILLs the serving WORKER (healthz pid — the supervisor in
    front of it respawns at the pinned port); drain/undrain ride the
    pool's own lifecycle (begin_drain fires the router's proactive
    session re-ship hook, exactly like an operator drain would)."""

    def __init__(self, pool, router_plan):
        self.pool = pool
        self.router_plan = router_plan

    def _replica_url(self, name: str) -> str:
        return self.pool.replicas[name].url

    def arm(self, target: str, spec: str) -> None:
        if target == ROUTER:
            self.router_plan.arm(spec)
            return
        out = _post_json(
            f"{self._replica_url(target)}/v1/debug/faults",
            {"spec": spec}, timeout=10.0)
        if not out.get("ok"):
            raise RuntimeError(f"arm refused: {out}")

    def clear(self, target: str) -> None:
        if target == ROUTER:
            self.router_plan.clear()
            return
        _post_json(f"{self._replica_url(target)}/v1/debug/faults",
                   {"clear": True}, timeout=10.0)

    def kill(self, target: str) -> None:
        pid = self.pool.replicas[target].pid
        if not pid:
            raise RuntimeError(f"{target} has no known worker pid")
        os.kill(pid, signal.SIGKILL)

    def drain(self, target: str) -> None:
        self.pool.begin_drain(target)

    def undrain(self, target: str) -> None:
        self.pool.end_drain(target)

    def clear_all(self, deadline_s: float = 60.0) -> None:
        """Post-window safety net: drop every armed rule everywhere,
        retrying replicas that are mid-respawn until the deadline."""
        self.router_plan.clear()
        if self.pool.faults is not self.router_plan:
            self.pool.faults.clear()
        deadline = time.monotonic() + deadline_s
        pending = set(self.pool.replicas)
        while pending and time.monotonic() < deadline:
            for name in sorted(pending):
                try:
                    self.clear(name)
                    pending.discard(name)
                except Exception:  # noqa: BLE001 — replica still booting
                    pass
            if pending:
                time.sleep(1.0)
        if pending:
            raise RuntimeError(
                f"could not clear fault plans on {sorted(pending)}")


class SoakFleet:
    """The long-lived half of the soak: bundle, reference server,
    managed replicas, router. Boots once; every seed window runs
    against it.

    ``bundle``: the bundle every server boots (default: the tiny soak
    bundle, built here). ``device``: ``"cpu"`` or the card.
    ``plan_seeds``: ``(seed, duration_s)`` pairs whose workload plans and
    expected outputs are computed on the reference while the replicas
    boot. ``ready_timeout`` bounds each replica's deploy."""

    def __init__(self, *, block: int = 32, n_new: int = 8,
                 max_len: int = 256, request_timeout: float = 40.0,
                 spill_max_wait_s: float = 20.0,
                 autoscale: bool = False, bundle: Path | None = None,
                 device: str = "cuda", plan_seeds=(),
                 ready_timeout: float = 300.0):
        import tempfile

        from lambdipy_tpu_torch.fleet import FleetRouter, ReplicaPool
        from lambdipy_tpu_torch.runtime.deploy import LocalRuntime
        from lambdipy_tpu_torch.runtime.faults import FaultPlan
        from lambdipy_tpu_torch.runtime.server import BundleServer

        self.block, self.n_new = block, n_new
        self.controller = None  # set below; None-safe for early close()
        self.router = self.pool = self.ref = None
        self.plans: dict = {}
        self.tmp = Path(tempfile.mkdtemp(prefix="lambdipy-soak-"))
        self.bundle = (Path(bundle) if bundle is not None else
                       _build_soak_bundle(self.tmp, n_new=n_new,
                                          block=block, max_len=max_len))

        env_base = {
            "LAMBDIPY_STABLE_UPTIME_S": "5",
            "LAMBDIPY_MAX_BACKOFF_S": "1",
            # the watchdog is a backstop for REAL wedges: injected hangs
            # resolve at their paired clear event (<= ~6 s), and 30 s
            # stays above any first capture so a cold program never
            # reads as a hang
            "LAMBDIPY_ENGINE_WATCHDOG_S": "30",
            # composed faults can fail one row's engine twice before the
            # schedule moves on; replay budget sized so an injected
            # failure never surfaces as a client 500
            "LAMBDIPY_MAX_REPLAYS": "3",
        }
        # the paged replica also runs the host offload tier: the
        # offload_stall legs the timeline guarantees (must_include)
        # need an arena attached to fire for real, not arm a no-op
        env_paged = dict(env_base, LAMBDIPY_KV_PAGED="1",
                         LAMBDIPY_KV_PAGES="64",
                         LAMBDIPY_KV_OFFLOAD="1")
        self.rt = LocalRuntime(self.tmp / "deployments.json")
        self.router_plan = FaultPlan.empty()
        self.pool = ReplicaPool(probe_interval=0.4, fail_threshold=2,
                                readmit_passes=2, probe_timeout=10.0,
                                faults=self.router_plan)
        errs: list = []
        spawn_device = "cpu" if device == "cpu" else None
        # seconds from the start of the boot: each replica deployed, the
        # reference serving, the plans answered
        self.boot_s: dict = {}
        t0 = time.monotonic()

        def spawn(name: str, env: dict) -> None:
            try:
                self.pool.spawn(name, self.bundle, runtime=self.rt,
                                env=env, device=spawn_device,
                                ready_timeout=ready_timeout)
                self.boot_s[name] = round(time.monotonic() - t0, 2)
            except Exception as e:  # noqa: BLE001 — re-raised below
                errs.append(e)

        threads = [threading.Thread(target=spawn, args=(n, e))
                   for n, e in ((REPLICAS[0], env_base),
                                (REPLICAS[1], env_paged))]
        for t in threads:
            t.start()
        try:
            # the direct reference: in-process, fault-free — the
            # oracle's source of expected outputs (identical params make
            # every server in this soak bitwise the same model); it
            # boots and answers the planned requests while the replicas
            # boot
            self.ref = BundleServer.from_bundle(
                self.bundle, warmup=False,
                device=spawn_device).start_background()
            self.ref_url = f"http://127.0.0.1:{self.ref.port}"
            self.boot_s["reference"] = round(time.monotonic() - t0, 2)
            for seed, duration_s in plan_seeds:
                self.plan(seed=seed, duration_s=duration_s)
            self.boot_s["plans"] = round(time.monotonic() - t0, 2)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errs.append(e)
        for t in threads:
            t.join()
        if errs:
            self.close()
            raise errs[0]
        self.pool.probe_all()
        self.pool.start()
        self.router = FleetRouter(
            pool=self.pool, affinity_on=True, block=block,
            max_retries=3, backoff_s=0.05, backoff_cap_s=0.5,
            request_timeout=request_timeout, spill_cap=64,
            spill_max_wait_s=spill_max_wait_s, breaker_fails=8,
            breaker_open_s=0.5, retry_budget=1.0,
            faults=self.router_plan).start_background()
        self.base = f"http://127.0.0.1:{self.router.port}"
        self.ops = LiveFleetOps(self.pool, self.router_plan)
        # opt-in elastic control loop UNDER the nemesis: controller
        # actions land in self.controller.events (the same @T grammar
        # as the timeline) so a window can interleave self-resizing
        # with injected faults and still hold the zero-loss oracle.
        # min_replicas=2 pins the loop to reshaping (promote/demote),
        # never shrinking the 2-replica soak fleet.
        if autoscale:
            from lambdipy_tpu_torch.fleet import (FleetController,
                                                  PolicyConfig)

            self.controller = FleetController(
                self.router,
                config=PolicyConfig(slo_p99_ms=500.0, sustain_s=2.0,
                                    lifecycle_cooldown_s=8.0,
                                    min_replicas=2, max_prefill=1,
                                    live_floor=1),
                interval_s=0.5).start()

    # -- plumbing -------------------------------------------------------------

    def plan(self, *, seed: int, duration_s: float):
        """The seed's workload plan with every expected output filled in
        from the reference (once per seed and window length: the
        outputs never change)."""
        key = (int(seed), float(duration_s))
        if key not in self.plans:
            plan = build_plan(seed=seed, duration_s=duration_s,
                              n_new=self.n_new, prefix_len=self.block,
                              first_len=self.block + 1)
            precompute_expected(plan, self.ref_completion)
            self.plans[key] = plan
        return self.plans[key]

    def ref_completion(self, row, kw, max_tokens):
        body = {"prompt": [int(t) for t in row],
                "max_tokens": max_tokens,
                "temperature": kw.get("temperature", 0)}
        for k in ("seed", "top_p"):
            if k in kw:
                body[k] = kw[k]
        out = _post_json(f"{self.ref_url}/v1/completions", body,
                         timeout=300.0)
        return out["choices"][0]["tokens"]

    def await_recovery(self, deadline_s: float = 240.0) -> float:
        """Block until every replica is routable again (a SIGKILL'd
        worker needs its supervisor respawn + pool readmission — the
        slow tail of every window). Returns how long it took."""
        t0 = time.monotonic()
        deadline = t0 + deadline_s
        while time.monotonic() < deadline:
            if all(r.routable and not r.wedged
                   for r in self.pool.replicas.values()):
                return time.monotonic() - t0
            time.sleep(0.25)
        states = {n: (r.state, r.ready, r.wedged)
                  for n, r in self.pool.replicas.items()}
        raise AssertionError(
            f"fleet never recovered after the soak window: {states}")

    def close_sessions(self, sids, skip: set | None = None) -> None:
        for sid in sids:
            if skip and sid in skip:
                continue
            req = urllib.request.Request(
                f"{self.base}/v1/sessions/{sid}", method="DELETE")
            try:
                urllib.request.urlopen(req, timeout=30).read()
            except Exception:  # noqa: BLE001 — unknown session is fine
                pass

    def quiesce_probes(self) -> tuple[dict, dict, dict]:
        inv = _get_json(f"{self.base}/v1/debug/invariants", timeout=60)
        rm = _get_json(f"{self.base}/metrics", timeout=60)
        per_replica: dict = {}
        for name, r in self.pool.replicas.items():
            try:
                per_replica[name] = _get_json(f"{r.url}/metrics",
                                              timeout=30)
            except Exception:  # noqa: BLE001
                per_replica[name] = None
        return inv, rm, per_replica

    def close(self) -> None:
        for part, stop in ((self.controller, "close"),
                           (self.router, "stop"), (self.pool, "stop_all"),
                           (self.ref, "stop")):
            if part is None:
                continue
            try:
                getattr(part, stop)()
            except Exception:  # noqa: BLE001 — stop the rest regardless
                pass


def _build_soak_bundle(tmp, *, n_new: int, block: int, max_len: int):
    """Tiny llama bundle every soak server boots: continuous engine,
    prefix cache + sessions on, deterministic init params (bitwise
    replicas). Paged mode is a per-replica ENV flag (r1), so one bundle
    serves the dense and paged halves of the matrix. JAX's recipe dict,
    with the port's base layer and handler; ``"device": "any"`` draws
    the params on the CPU."""
    from lambdipy_tpu_torch.buildengine import build_recipe
    from lambdipy_tpu_torch.bundle.package import assemble_bundle
    from lambdipy_tpu_torch.recipes.schema import load_recipe_dict

    doc = {
        "schema": 1, "name": "chaos-soak", "version": "0.1",
        "device": "any", "base_layer": "torch", "requires": [],
        "payload": {
            "model": "llama-tiny",
            "handler": "lambdipy_tpu_torch.runtime.handlers:generate_handler",
            "params": "init", "dtype": "float32",
            "extra": {"max_new_tokens": str(n_new), "serve_aot": "0",
                      "warm_group_prefill": "0",
                      "prefix_cache_mb": "64",
                      "prefix_block": str(block),
                      "max_len": str(max_len),
                      "batch_mode": "continuous",
                      "batch_max": "4", "batch_segment": "8",
                      # short leases so the one lease-to-expiry session
                      # converges inside the quiesce window
                      "session_idle_s": "60"},
        },
    }
    result = build_recipe(load_recipe_dict(doc), tmp / "work",
                          run_smoke=False)
    bundle = tmp / "bundle"
    assemble_bundle(result, bundle, with_payload=True)
    return bundle


EXPIRY_TTL_S = 2.0
_CANARY_RID = 10 ** 6


def _canary_outcome():
    """The deliberately-suppressible record: one synthetic priced shed
    appended to a real history. The normal oracle accepts it; the
    suppressed-shed-counter oracle MUST reject the history — proving
    the checker can actually fail, not just pass."""
    from lambdipy_tpu_torch.chaos.workload import Outcome

    return Outcome(rid=_CANARY_RID, kind="cold", streamed=False,
                   sampled=False, t_start=0.0, t_end=0.1,
                   status="shed", http_status=503,
                   shed_reason="canary", retry_after_s=1.0)


def run_window(fleet: SoakFleet, *, seed: int, duration_s: float,
               waiter_bound_s: float = 90.0, timeline=None,
               recovery_s: float = 240.0, join_slack_s: float = 60.0,
               on_stage=None) -> dict:
    """One soak window on a booted fleet: workload + nemesis on the
    same clock, then quiesce, then the oracle. Returns the full
    JSON-able record (verdict, tallies, timeline text, nemesis apply
    log). ``timeline`` overrides generation — the ``--replay-timeline``
    path. ``recovery_s`` bounds the wait for every replica to be
    routable again and ``join_slack_s`` the nemesis's join past the
    window; ``on_stage(name)`` is called as each of ``references``,
    ``window`` and ``quiesce`` ends, and its exception ends the
    window."""
    stage = on_stage or (lambda name: None)
    plan = fleet.plan(seed=seed, duration_s=duration_s)
    stage("references")
    generated = timeline is None
    if generated:
        timeline = generate_timeline(seed=seed, duration_s=duration_s,
                                     replicas=list(REPLICAS),
                                     must_include="offload_stall")
    props = timeline_properties(timeline)
    sids = sorted(plan.sessions)
    expiry_sid = sids[0] if sids else None
    log_event(log, "soak window starting", seed=seed,
              duration_s=duration_s, requests=len(plan.all_requests()),
              **props)
    t_window = time.monotonic()
    ctrl_ev0 = (len(fleet.controller.events)
                if fleet.controller is not None else 0)
    nemesis = Nemesis(timeline, fleet.ops).start()
    outcomes = run_workload(
        fleet.base, plan, timeout_s=waiter_bound_s,
        session_ttl_last_turn=({expiry_sid: EXPIRY_TTL_S}
                               if expiry_sid else None))
    nemesis.join(timeout=duration_s + join_slack_s)
    nemesis.stop()
    stage("window")

    # -- quiesce: clear, recover, close, converge ----------------------------
    # router/pool plans clear in-process first (an armed probe fault
    # would block readmission forever); replica plans clear once their
    # processes are back (a respawned worker boots with a clean plan)
    fleet.router_plan.clear()
    if fleet.pool.faults is not fleet.router_plan:
        fleet.pool.faults.clear()
    recovery = fleet.await_recovery(deadline_s=recovery_s)
    fleet.ops.clear_all(deadline_s=60.0)
    fleet.close_sessions(sids, skip={expiry_sid} if expiry_sid else None)
    time.sleep(EXPIRY_TTL_S + 1.0)  # the tightened lease lapses
    if expiry_sid is not None:
        # the replica-side pins are gone by EXPIRY now (counted in
        # pin_expiries); this DELETE only clears the router's sticky
        # record — leases are a replica concern, the router map is not
        # lease-aware, and quiesce demands both converge to zero
        fleet.close_sessions([expiry_sid])

    # the fleet must serve BITWISE after the storm (the recovery bar
    # every per-feature chaos test set, now after composed faults)
    probe_row = [3, 1, 4, 1, 5, 9, 2, 6]
    post_expected = fleet.ref_completion(probe_row, {}, fleet.n_new)
    post_detail: str | None = None
    try:
        out = _post_json(f"{fleet.base}/v1/completions",
                         {"prompt": probe_row,
                          "max_tokens": fleet.n_new, "temperature": 0},
                         timeout=120.0)
        got = out["choices"][0]["tokens"]
        if got != post_expected:
            post_detail = f"post-soak serve diverged: {got[:6]}..."
    except Exception as e:  # noqa: BLE001
        post_detail = f"post-soak serve failed: {type(e).__name__}: {e}"

    inv, router_metrics, per_replica = fleet.quiesce_probes()
    stage("quiesce")
    history = check_history(outcomes, waiter_bound_s=waiter_bound_s)
    quiesce = check_quiesce(inv, per_replica,
                            router_metrics=router_metrics)
    violations = list(history["violations"]) + list(
        quiesce["violations"])
    if post_detail is not None:
        violations.append(post_detail)
    applied_errors = [
        {"event": a.event.render(), "error": a.error}
        for a in nemesis.applied if a.error]
    applied_ok = [a.event for a in nemesis.applied if a.error is None]
    if generated:
        # the composed-fault floor the acceptance gate demands of every
        # generated schedule (replayed files are exempt — an operator
        # may replay a hand-pruned timeline). Judged on what APPLIED,
        # not what was planned: a SIGKILL that failed to land would
        # otherwise pass as a composed-fault soak that never killed
        # anything.
        if not any(e.action == "kill" for e in applied_ok):
            violations.append(
                f"the SIGKILL nemesis never applied cleanly: "
                f"{applied_errors}")
        if not any(e.action == "drain" for e in applied_ok):
            violations.append(
                f"the drain nemesis never applied cleanly: "
                f"{applied_errors}")
        if applied_errors:
            violations.append(
                f"nemesis events failed to apply (the schedule ran "
                f"thinner than planned): {applied_errors[:3]}")
        if props["sustained_overlap_s"] < 1.0 or props["peak_overlap"] < 2:
            violations.append(
                f"schedule never sustained >= 2 overlapping faults: "
                f"{props}")
    # the canary: one synthetic priced shed — accepted normally,
    # REJECTED when the shed counter is suppressed. Only judged on a
    # window whose OWN history is clean: on a failing window the base
    # violations already fail the run, and a "canary failed" line
    # there would misread as the oracle being broken when it is
    # working correctly.
    if history["ok"]:
        with_canary = outcomes + [_canary_outcome()]
        canary = {
            "normal_ok": check_history(
                with_canary, waiter_bound_s=waiter_bound_s)["ok"],
            "suppressed_fails": not check_history(
                with_canary, waiter_bound_s=waiter_bound_s,
                suppress_sheds=True)["ok"],
        }
        if not canary["normal_ok"] or not canary["suppressed_fails"]:
            violations.append(
                f"checker canary failed — the oracle cannot reject a "
                f"suppressed-shed history: {canary}")
    else:
        canary = {"skipped": "window history already failing"}
    record = {
        "seed": seed,
        "duration_s": duration_s,
        "ok": not violations,
        "violations": violations,
        "requests": len(plan.all_requests()),
        "tallies": history["tallies"],
        "timeline": render_timeline(timeline),
        "timeline_props": props,
        "nemesis_applied": len(nemesis.applied),
        "nemesis_errors": applied_errors,
        # controller-initiated resizes that landed during this window,
        # in the nemesis event grammar — the self-tuning loop's actions
        # sit on the same timeline as the injected faults, and the
        # zero-loss oracle above already judged the history THROUGH them
        "controller_events": (
            [e["event"] for e in fleet.controller.events[ctrl_ev0:]]
            if fleet.controller is not None else []),
        "recovery_s": round(recovery, 2),
        "spill_depth": quiesce["spill_depth"],
        "canary": canary,
        "window_wall_s": round(time.monotonic() - t_window, 1),
    }
    return record


def soak_record(*, seeds=(11, 23), duration_s: float = 22.0,
                waiter_bound_s: float = 90.0,
                replay_timeline: str | None = None,
                determinism: bool = True,
                autoscale: bool = False, device: str = "cuda") -> dict:
    """The entry point's record. CI mode (defaults): run the fixed seed
    set, then re-run the FIRST seed and assert a byte-identical timeline
    with an identical verdict (schedule determinism on a live fleet, not
    just in the generator). Replay mode (``replay_timeline`` = a
    timeline file's text): run seed[0]'s workload under the file's exact
    schedule — the one-command reproduction of a failing run.

    On any window failing its oracle, the window's timeline is written
    next to the bundle and an AssertionError names the one-command
    replay."""
    import torch

    if duration_s < 12.0:
        # fail BEFORE the fleet boot, with the generator's reason
        raise ValueError(
            f"--soak-seconds {duration_s:.0f} is too short for the "
            f"composed-fault floor; use >= 12 s")
    fleet = SoakFleet(autoscale=autoscale, device=device)
    try:
        timeline = None
        if replay_timeline is not None:
            timeline = parse_timeline(replay_timeline)
            seeds = tuple(seeds)[:1]
            determinism = False
        windows = []
        for seed in seeds:
            rec = run_window(fleet, seed=seed, duration_s=duration_s,
                             waiter_bound_s=waiter_bound_s,
                             timeline=timeline)
            windows.append(rec)
            _gate(fleet, rec)
        determinism_rec = None
        if determinism:
            rec2 = run_window(fleet, seed=seeds[0],
                              duration_s=duration_s,
                              waiter_bound_s=waiter_bound_s)
            _gate(fleet, rec2)
            if rec2["timeline"] != windows[0]["timeline"]:
                raise AssertionError(
                    f"seed {seeds[0]} produced a DIFFERENT timeline on "
                    f"the re-run — schedule determinism broke")
            determinism_rec = {
                "seed": seeds[0],
                "timeline_identical": True,
                "verdict_identical": rec2["ok"] == windows[0]["ok"],
                "tallies": rec2["tallies"],
            }
        return {
            "mode": "soak",
            # from torch: the card's replicas serve on the GPU
            "platform": ("gpu" if device != "cpu"
                         and torch.cuda.is_available() else "cpu"),
            "seeds": list(seeds),
            "duration_s": duration_s,
            "replayed": replay_timeline is not None,
            "autoscale": autoscale,
            "windows": windows,
            "determinism": determinism_rec,
            "passed": True,
        }
    finally:
        fleet.close()


def _gate(fleet: SoakFleet, rec: dict) -> None:
    """Fail the soak on a bad window, leaving the replay artifact: the
    seed + the exact event timeline, replayable in one command."""
    path = fleet.tmp / f"seed-{rec['seed']}.timeline"
    path.write_text(rec["timeline"] + "\n")
    rec["timeline_file"] = str(path)
    if not rec["ok"]:
        raise AssertionError(
            f"soak seed {rec['seed']} FAILED its oracle: "
            f"{rec['violations'][:4]} — replay with: python -m "
            f"lambdipy_tpu_torch.chaos.soak --seed {rec['seed']} "
            f"--replay-timeline {path}")


def main(argv=None) -> int:
    """``python -m lambdipy_tpu_torch.chaos.soak``: the composed-fault
    soak over a 2-replica fleet of the tiny soak bundle, on the card
    unless ``--device cpu``; prints the record as one JSON line and
    exits non-zero on any window failing its oracle."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m lambdipy_tpu_torch.chaos.soak",
        description="composed-fault chaos soak over a live 2-replica "
                    "fleet (seeded nemesis, mixed workload, history and "
                    "quiesce oracle)")
    ap.add_argument("--seed", type=int, action="append", default=None,
                    help="soak seed (repeatable); default: the fixed "
                         "CI set (11, 23) plus a determinism re-run")
    ap.add_argument("--soak-seconds", type=float, default=None,
                    help="window length per seed (default 22 s; longer "
                         "randomized runs use this with --seed)")
    ap.add_argument("--replay-timeline", type=str, default=None,
                    help="timeline file from a failing run: replay its "
                         "exact schedule under --seed's workload")
    ap.add_argument("--no-determinism", action="store_true")
    ap.add_argument("--autoscale", action="store_true",
                    help="run the live FleetController over the soak "
                         "fleet: its resizes join the nemesis timeline "
                         "and the zero-loss bar must hold through them")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the replicas and the reference serve "
                         "(default: the card)")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("Error: no CUDA device is available; run the soak on "
                  "the CPU with --device cpu", file=sys.stderr)
            return 1
    replay = None
    if args.replay_timeline:
        with open(args.replay_timeline) as f:
            replay = f.read()
    seeds = tuple(args.seed) if args.seed else (11, 23)
    kwargs = {}
    if args.soak_seconds:
        kwargs["duration_s"] = float(args.soak_seconds)
    # the determinism re-run is the CI default; explicit seeds/replays
    # are operator iteration loops and skip it
    determinism = (not args.no_determinism and args.seed is None
                   and replay is None)
    try:
        record = soak_record(seeds=seeds, replay_timeline=replay,
                             determinism=determinism,
                             autoscale=args.autoscale, device=args.device,
                             **kwargs)
    except (AssertionError, ValueError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
