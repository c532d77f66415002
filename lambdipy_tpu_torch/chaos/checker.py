"""History checker: the chaos soak's single global oracle.

The port's copy of ``lambdipy_tpu/chaos/checker.py``: the same verdicts,
tallies and violation texts on the same histories and sweeps.

Per-request contract (:func:`check_history`) — the zero-silent-loss
bar every earlier chaos bench enforced per-feature, now fleet-wide
under composed faults:

==================  ========================================================
outcome             verdict
==================  ========================================================
``ok``              tokens must be BITWISE the reference's
``shed``            explicit priced failure (429/503 + Retry-After, or the
                    router's 504 busy-not-dead timeout) — counted, never a
                    loss
``stream_error``    a streamed request's terminal error event (the engine's
                    contract for partially-streamed rows); bytes delivered
                    before it must be a PREFIX of the reference
``stream_truncated``the transport died mid-stream (SIGKILL'd home): the
                    client saw the failure, so it is explicit — but again
                    only a prefix of the reference may have been delivered
``http_error``      a status outside the shed contract — SILENT LOSS
``exception``       a non-streamed transport failure — SILENT LOSS
==================  ========================================================

plus the WAITER BOUND (no request outlives ``waiter_bound_s``) and the
accounting identity ``delivered + explicit == planned`` (a vanished
request is a loss even if nobody saw an error). The deliberately
breakable leg: ``suppress_sheds=True`` drops sheds from the explicit
tally — the canary the soak (``chaos/soak.py``) uses to prove the
oracle can actually reject a history.

Quiesce contract (:func:`check_quiesce`), probed AFTER faults clear,
sessions close, and leases lapse: every replica's
``/v1/debug/invariants`` sweep passes (pagepool conservation,
prefix-store pin/content accounting), pinned bytes and active sessions
read zero everywhere, the router's spill queue is empty, and the
router's own session table agrees with the checker's (all closed).
"""

from __future__ import annotations


def _is_prefix(part, full) -> bool:
    part = list(part or [])
    full = list(full or [])
    return part == full[:len(part)]


def check_history(outcomes, *, waiter_bound_s: float,
                  suppress_sheds: bool = False) -> dict:
    """Judge a recorded history. Returns ``{"ok", "violations",
    "tallies"}`` — violations carry the rid so a failing run names the
    divergent request for the seed+timeline replay."""
    violations: list[str] = []
    tallies = {"total": len(outcomes), "delivered": 0, "sheds": 0,
               "stream_errors": 0, "stream_truncated": 0,
               "silent": 0, "by_kind": {}, "shed_reasons": {}}
    for o in outcomes:
        kind_tally = tallies["by_kind"].setdefault(
            o.kind, {"delivered": 0, "explicit": 0})
        took = o.t_end - o.t_start
        if took > waiter_bound_s:
            violations.append(
                f"rid {o.rid}: waiter outlived its bound "
                f"({took:.1f}s > {waiter_bound_s:.0f}s)")
        if o.status == "ok":
            if list(o.tokens or []) != list(o.expected or []):
                violations.append(
                    f"rid {o.rid} ({o.kind}): WRONG tokens delivered — "
                    f"silent corruption, worse than an error")
                tallies["silent"] += 1
            else:
                tallies["delivered"] += 1
                kind_tally["delivered"] += 1
        elif o.status == "shed":
            tallies["sheds"] += 1
            kind_tally["explicit"] += 1
            r = tallies["shed_reasons"]
            r[str(o.shed_reason)] = r.get(str(o.shed_reason), 0) + 1
        elif o.status in ("stream_error", "stream_truncated"):
            if not _is_prefix(o.tokens, o.expected):
                violations.append(
                    f"rid {o.rid} ({o.kind}): streamed bytes diverged "
                    f"from the reference before the failure — silent "
                    f"corruption")
                tallies["silent"] += 1
            else:
                key = ("stream_errors" if o.status == "stream_error"
                       else "stream_truncated")
                tallies[key] += 1
                kind_tally["explicit"] += 1
        else:
            violations.append(
                f"rid {o.rid} ({o.kind}): silent loss — {o.status} "
                f"{o.detail or o.shed_reason or ''} "
                f"(status {o.http_status})")
            tallies["silent"] += 1
    explicit = (tallies["stream_errors"] + tallies["stream_truncated"]
                + (0 if suppress_sheds else tallies["sheds"]))
    if tallies["delivered"] + explicit + tallies["silent"] \
            != tallies["total"]:
        violations.append(
            f"accounting does not converge: delivered "
            f"{tallies['delivered']} + explicit {explicit} != total "
            f"{tallies['total']} — a request vanished from the tally")
    return {"ok": not violations, "violations": violations,
            "tallies": tallies}


def check_quiesce(router_invariants: dict, replica_metrics: dict,
                  *, router_metrics: dict | None = None) -> dict:
    """Judge the post-soak steady state. ``router_invariants`` is the
    router's ``GET /v1/debug/invariants`` document, ``replica_metrics``
    maps replica name -> its ``/metrics`` document (None = replica did
    not answer — a quiesced fleet must)."""
    violations: list[str] = []
    if not router_invariants.get("ok"):
        detail = {n: r for n, r in
                  (router_invariants.get("replicas") or {}).items()
                  if not r.get("ok")}
        violations.append(
            f"replica invariant sweep failed at quiesce: {detail}")
    spill = router_invariants.get("spill_depth", 0)
    if spill:
        violations.append(
            f"router spill depth {spill} != 0 at quiesce — parked "
            f"requests outlived the soak")
    for name, m in sorted(replica_metrics.items()):
        if m is None:
            violations.append(
                f"replica {name} answered no /metrics at quiesce")
            continue
        pc = (m.get("handler") or {}).get("prefix_cache") or {}
        for key in ("pinned_leaves", "pinned_bytes", "sessions_active"):
            if pc.get(key, 0) != 0:
                violations.append(
                    f"replica {name}: {key}={pc.get(key)} != 0 after "
                    f"DELETE fan-out + lease expiry")
        armed = ((m.get("handler") or {}).get("faults")
                 or {}).get("armed") or {}
        if armed.get("active"):
            violations.append(
                f"replica {name}: fault rules still armed at quiesce: "
                f"{armed.get('sites')}")
    if router_metrics is not None:
        sessions = ((router_metrics.get("fleet") or {}).get("sessions")
                    or {})
        if sessions.get("active", 0) != 0:
            violations.append(
                f"router still tracks {sessions.get('active')} open "
                f"session(s) after the DELETE fan-out")
        armed = (router_metrics.get("faults") or {}).get("armed") or {}
        if armed.get("active"):
            violations.append(
                f"router fault rules still armed at quiesce: "
                f"{armed.get('sites')}")
    return {"ok": not violations, "violations": violations,
            "spill_depth": spill}
