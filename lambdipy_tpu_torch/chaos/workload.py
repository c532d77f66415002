"""Mixed open-loop workload for the chaos soak.

The port's copy of ``lambdipy_tpu/chaos/workload.py``: the same seed
builds the same plan in both packages.

One seed derives the whole request population and its arrival schedule
(:func:`build_plan`): cold unique prompts, shared-prefix groups, and
multi-turn sessions, crossed with {greedy, seeded-sampled} and
{streamed, plain}. Expected outputs are precomputed request-by-request
against a DIRECT reference server (:func:`precompute_expected`) — every
knob is deterministic (greedy, or sampled under an explicit seed), so
the oracle is bitwise, not statistical.

The client (:func:`run_workload`) is OPEN-LOOP: requests fire at their
planned arrival times regardless of how the fleet is coping (a closed
loop would offer a degraded fleet less pressure — backwards for a
robustness claim), except that a session's own turns are inherently
sequential (turn t+1's prompt embeds turn t's answer). Every request
records an :class:`Outcome` the checker judges later; the client itself
asserts nothing.
"""

from __future__ import annotations

import json
import random
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field

SAMPLED_KW = {"temperature": 0.9, "top_p": 0.9}


@dataclass
class PlannedRequest:
    rid: int
    t: float                 # arrival offset from workload start (s)
    kind: str                # "cold" | "prefix" | "session"
    row: list | None         # prompt token ids (None: built from history)
    kw: dict                 # sampling knobs ({} = greedy)
    max_tokens: int
    stream: bool = False
    sid: str | None = None   # session id (kind == "session")
    turn: int = 0
    ttl: float | None = None       # session_ttl_s tightening, if any
    expected: list | None = None   # filled by precompute_expected


@dataclass
class WorkloadPlan:
    seed: int
    duration_s: float
    requests: list = field(default_factory=list)   # non-session arrivals
    # sid -> {"first": [...], "users": [[...]], "turns": [PlannedRequest],
    #         "start": t, "gaps": [s]}
    sessions: dict = field(default_factory=dict)

    def all_requests(self) -> list:
        out = list(self.requests)
        for conv in self.sessions.values():
            out.extend(conv["turns"])
        return sorted(out, key=lambda r: (r.t, r.rid))


def build_plan(*, seed: int, duration_s: float, n_cold: int = 6,
               n_prefix_groups: int = 2, group_size: int = 4,
               n_sessions: int = 3, turns: int = 3, n_new: int = 8,
               vocab: int = 500, cold_len: tuple = (12, 40),
               prefix_len: int = 32, suffix_len: int = 6,
               first_len: int = 33, user_len: int = 8,
               stream_ratio: float = 0.34) -> WorkloadPlan:
    """Derive the request population + arrival schedule from ``seed``.
    Pure host-side: two calls with the same arguments build equal plans
    (asserted in tests/test_torch_chaos.py) — the reference server only fills
    in ``expected`` afterwards."""
    rng = random.Random(int(seed) ^ 0x5EED)
    duration_s = float(duration_s)
    plan = WorkloadPlan(seed=int(seed), duration_s=duration_s)
    rid = 0
    window = (0.2, max(0.3, duration_s * 0.78))

    def knobs(i: int) -> dict:
        # half greedy, half seeded-sampled (per-request seed keeps the
        # reference bitwise)
        if i % 2 == 0:
            return {}
        return dict(SAMPLED_KW, seed=1000 + seed * 97 + i)

    def tokens(n: int) -> list:
        return [rng.randrange(1, vocab) for _ in range(n)]

    for i in range(n_cold):
        plan.requests.append(PlannedRequest(
            rid=(rid := rid + 1), t=round(rng.uniform(*window), 3),
            kind="cold", row=tokens(rng.randint(*cold_len)),
            kw=knobs(i), max_tokens=n_new,
            stream=rng.random() < stream_ratio))
    for g in range(n_prefix_groups):
        shared = tokens(prefix_len)
        for i in range(group_size):
            plan.requests.append(PlannedRequest(
                rid=(rid := rid + 1), t=round(rng.uniform(*window), 3),
                kind="prefix", row=shared + tokens(suffix_len),
                kw=knobs(g + i), max_tokens=n_new,
                stream=rng.random() < stream_ratio))
    for s in range(n_sessions):
        sid = f"soak-{seed}-{s}"
        first = tokens(first_len)
        users = [tokens(user_len) for _ in range(turns)]
        start = round(rng.uniform(0.2, max(0.3, duration_s * 0.3)), 3)
        gaps = [round(rng.uniform(0.5, max(0.6, duration_s / (turns + 2))),
                      3) for _ in range(turns - 1)]
        conv = {"first": first, "users": users, "start": start,
                "gaps": gaps, "turns": []}
        t = start
        for turn in range(turns):
            conv["turns"].append(PlannedRequest(
                rid=(rid := rid + 1), t=t, kind="session", row=None,
                kw=knobs(s), max_tokens=n_new,
                stream=(rng.random() < stream_ratio and turn > 0),
                sid=sid, turn=turn))
            if turn < turns - 1:
                t = round(t + gaps[turn], 3)
        plan.sessions[sid] = conv
    return plan


def precompute_expected(plan: WorkloadPlan, completion) -> None:
    """Fill every planned request's ``expected`` via the DIRECT
    reference: ``completion(row, kw, max_tokens) -> tokens``. Session
    turn t's prompt embeds the expected answers of turns < t, so the
    whole transcript is pinned down before any fault is armed."""
    for req in plan.requests:
        req.expected = completion(req.row, req.kw, req.max_tokens)
    for conv in plan.sessions.values():
        history = list(conv["first"])
        for turn, req in enumerate(conv["turns"]):
            req.row = list(history)
            req.expected = completion(history, req.kw, req.max_tokens)
            history = history + req.expected + conv["users"][turn]


@dataclass
class Outcome:
    """What one request actually got. ``status``:

    - ``ok``              delivered (tokens compared by the checker)
    - ``shed``            explicit 4xx/5xx with the priced-shed contract
    - ``http_error``      an HTTP status OUTSIDE the shed contract
    - ``stream_error``    a streamed request's terminal error event
    - ``stream_truncated``the stream died without DONE or an error event
    - ``exception``       transport-level failure (connection died)
    """

    rid: int
    kind: str
    streamed: bool
    sampled: bool
    t_start: float
    t_end: float
    status: str
    tokens: list | None = None
    expected: list | None = None
    http_status: int | None = None
    shed_reason: str | None = None
    retry_after_s: float | None = None
    detail: str = ""
    sid: str | None = None
    turn: int = 0


def _classify_http_error(e: urllib.error.HTTPError) -> tuple[str, dict]:
    body_raw = e.read() or b"{}"
    try:
        body = json.loads(body_raw)
    except json.JSONDecodeError:
        body = {}
    hint = body.get("retry_after_s")
    if hint is None:
        hint = (body.get("error") or {}).get("retry_after_s")
    if hint is None and e.headers.get("Retry-After"):
        try:
            hint = float(e.headers["Retry-After"])
        except ValueError:
            hint = None
    reason = body.get("reason") or (body.get("error") or {}).get("message")
    # the shed contract: 429/503 carry a priced Retry-After; 504 is the
    # router's busy-not-dead timeout (explicitly allowed without a price)
    if e.code in (429, 503) and hint is not None:
        return "shed", {"http_status": e.code, "shed_reason": str(reason),
                        "retry_after_s": float(hint)}
    if e.code == 504:
        return "shed", {"http_status": 504, "shed_reason": "timeout",
                        "retry_after_s": hint}
    return "http_error", {"http_status": e.code,
                          "shed_reason": str(reason)}


def _post_completion(base: str, req: PlannedRequest, *,
                     timeout: float) -> Outcome:
    body = {"prompt": [int(t) for t in req.row],
            "max_tokens": req.max_tokens,
            "temperature": req.kw.get("temperature", 0)}
    for k in ("seed", "top_p"):
        if k in req.kw:
            body[k] = req.kw[k]
    if req.sid is not None:
        body["session_id"] = req.sid
    if req.ttl is not None:
        body["session_ttl_s"] = req.ttl
    t0 = time.monotonic()
    common = dict(rid=req.rid, kind=req.kind, streamed=req.stream,
                  sampled="seed" in req.kw, t_start=t0,
                  expected=req.expected, sid=req.sid, turn=req.turn)

    def done(**kw) -> Outcome:
        return Outcome(t_end=time.monotonic(), **common, **kw)

    if not req.stream:
        http = urllib.request.Request(
            f"{base}/v1/completions", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(http, timeout=timeout) as resp:
                out = json.loads(resp.read())
            return done(status="ok", tokens=out["choices"][0]["tokens"])
        except urllib.error.HTTPError as e:
            status, extra = _classify_http_error(e)
            return done(status=status, **extra)
        except Exception as e:  # noqa: BLE001 — judged by the checker
            return done(status="exception",
                        detail=f"{type(e).__name__}: {e}")

    # streamed: SSE over /v1/completions — tokens accumulate from chunk
    # events; a terminal error event is an EXPLICIT failure, an abnormal
    # close without DONE is a (transport-explicit) truncation
    body["stream"] = True
    http = urllib.request.Request(
        f"{base}/v1/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    emitted: list = []
    try:
        with urllib.request.urlopen(http, timeout=timeout) as resp:
            for raw in resp:
                raw = raw.strip()
                if not raw.startswith(b"data: "):
                    continue
                payload = raw[len(b"data: "):]
                if payload == b"[DONE]":
                    return done(status="ok", tokens=emitted)
                evt = json.loads(payload)
                if "error" in evt:
                    err = evt["error"] or {}
                    return done(
                        status="stream_error", tokens=emitted,
                        shed_reason=str(err.get("message")),
                        retry_after_s=err.get("retry_after_s"),
                        detail=str(err.get("type")))
                for c in evt.get("choices") or []:
                    emitted.extend(c.get("tokens") or [])
        return done(status="stream_truncated", tokens=emitted,
                    detail="stream closed without DONE")
    except urllib.error.HTTPError as e:
        status, extra = _classify_http_error(e)
        return done(status=status, **extra)
    except Exception as e:  # noqa: BLE001 — mid-stream transport death
        return done(status="stream_truncated", tokens=emitted,
                    detail=f"{type(e).__name__}: {e}")


def run_workload(base: str, plan: WorkloadPlan, *,
                 timeout_s: float = 90.0,
                 session_ttl_last_turn: dict | None = None
                 ) -> list[Outcome]:
    """Drive the plan against ``base`` (the fleet router), open-loop.
    Returns one Outcome per planned request (request threads that never
    returned by the join deadline are the checker's waiter-bound
    violation — they appear as synthetic ``exception`` outcomes).

    ``session_ttl_last_turn`` maps sid -> ttl seconds to send on that
    session's final turn (the soak tightens ONE session's lease instead
    of DELETE-ing it, so quiesce exercises the lease-expiry path)."""
    outcomes: list[Outcome] = []
    lock = threading.Lock()
    t0 = time.monotonic()
    threads: list[threading.Thread] = []

    def fire(req: PlannedRequest) -> None:
        out = _post_completion(base, req, timeout=timeout_s)
        with lock:
            outcomes.append(out)

    def arrival(req: PlannedRequest) -> None:
        delay = t0 + req.t - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        fire(req)

    for req in plan.requests:
        th = threading.Thread(target=arrival, args=(req,), daemon=True)
        threads.append(th)
        th.start()

    def conversation(sid: str, conv: dict) -> None:
        delay = t0 + conv["start"] - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        for turn, req in enumerate(conv["turns"]):
            # the turn's prompt embeds the EXPECTED earlier answers
            # (precomputed), so one failed turn does not cascade — the
            # next turn still asks the reference-true question
            if session_ttl_last_turn and sid in session_ttl_last_turn \
                    and turn == len(conv["turns"]) - 1:
                req = PlannedRequest(
                    **{**req.__dict__,
                       "ttl": session_ttl_last_turn[sid]})
            fire(req)
            if turn < len(conv["turns"]) - 1:
                time.sleep(conv["gaps"][turn])

    for sid, conv in plan.sessions.items():
        th = threading.Thread(target=conversation, args=(sid, conv),
                              daemon=True)
        threads.append(th)
        th.start()

    deadline = time.monotonic() + plan.duration_s + timeout_s + 30.0
    for th in threads:
        th.join(timeout=max(0.0, deadline - time.monotonic()))
    hung = sum(1 for th in threads if th.is_alive())
    with lock:
        got = {o.rid for o in outcomes}
        for req in plan.all_requests():
            if req.rid not in got:
                now = time.monotonic()
                outcomes.append(Outcome(
                    rid=req.rid, kind=req.kind, streamed=req.stream,
                    sampled="seed" in req.kw, t_start=t0, t_end=now,
                    status="exception", expected=req.expected,
                    detail=("waiter still blocked past the join "
                            "deadline" if hung else
                            "request never fired"), sid=req.sid,
                    turn=req.turn))
        return sorted(outcomes, key=lambda o: o.rid)
