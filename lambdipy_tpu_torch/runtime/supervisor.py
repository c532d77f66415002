"""Watchdog supervisor of the port, the twin of
``lambdipy_tpu/runtime/supervisor.py``: the deploy controller spawns this
process, which runs the bundle server (``lambdipy_tpu_torch.runtime.server``)
as its child:

- the first readiness line is forwarded to stdout (the controller parses
  it; it carries the server's ``pid``), with the server's port pinned so
  restarts keep the same URL;
- an abnormal child exit (non-zero rc / killed) triggers a restart with
  exponential backoff (at most ``LAMBDIPY_MAX_BACKOFF_S``), up to
  ``LAMBDIPY_MAX_RESTARTS`` consecutive failures (the count resets after
  a run of ``LAMBDIPY_STABLE_UPTIME_S``);
- a clean child exit (rc 0 — drain via ``POST /shutdown`` or SIGTERM)
  ends the supervisor too;
- SIGTERM/SIGINT are forwarded to the child for a graceful drain.

The child inherits the environment, ``LAMBDIPY_PLATFORM=cpu`` included.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

from lambdipy_tpu_torch.utils.logs import get_logger, log_event

log = get_logger("lambdipy.supervisor")

# A run this long resets the consecutive-failure count; env-tunable so
# fleet fault-injection tests (and operators with fast-booting bundles)
# can shrink the window without patching the module.
STABLE_UPTIME_S = float(os.environ.get("LAMBDIPY_STABLE_UPTIME_S", "60"))
MAX_BACKOFF_S = float(os.environ.get("LAMBDIPY_MAX_BACKOFF_S", "10"))


def _spawn(bundle: str, port: int) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "lambdipy_tpu_torch.runtime.server", bundle, str(port)],
        stdout=subprocess.PIPE, text=True)


def _read_ready(child: subprocess.Popen) -> dict | None:
    """Read child stdout until the readiness line (or EOF = boot failure),
    then keep draining the pipe in the background so the child can never
    block on a full stdout buffer."""
    ready = None
    assert child.stdout is not None
    for line in child.stdout:
        try:
            parsed = json.loads(line)
        except json.JSONDecodeError:
            continue
        if parsed.get("ready"):
            ready = parsed
            break
    if ready is not None:
        threading.Thread(target=lambda: [None for _ in child.stdout],
                         daemon=True).start()
    return ready


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: supervisor <bundle_dir> [port]", file=sys.stderr)
        return 2
    bundle = str(Path(argv[0]))
    port = int(argv[1]) if len(argv) > 1 else 0
    max_restarts = int(os.environ.get("LAMBDIPY_MAX_RESTARTS", "5"))

    state = {"child": None, "stopping": False}

    def _forward_term(signum, frame):
        state["stopping"] = True
        child = state["child"]
        if child is not None and child.poll() is None:
            child.send_signal(signal.SIGTERM)

    signal.signal(signal.SIGTERM, _forward_term)
    signal.signal(signal.SIGINT, _forward_term)

    failures = 0
    announced = False
    while True:
        # a SIGTERM that landed between children (during backoff/respawn)
        # must stop the loop, not be swallowed
        if state["stopping"]:
            log_event(log, "supervisor exit", rc=0, clean=True)
            return 0
        started = time.monotonic()
        child = _spawn(bundle, port)
        state["child"] = child
        if state["stopping"] and child.poll() is None:
            child.send_signal(signal.SIGTERM)  # raced the spawn itself
        ready = _read_ready(child)
        if ready is not None:
            if port == 0:
                port = int(ready["port"])  # pin: restarts keep the URL stable
            if not announced:
                ready["supervisor_pid"] = os.getpid()
                print(json.dumps(ready), flush=True)
                announced = True
            else:
                log_event(log, "restarted", port=port, pid=child.pid,
                          consecutive_failures=failures)
        rc = child.wait()
        uptime = time.monotonic() - started
        if state["stopping"] or rc == 0:
            log_event(log, "supervisor exit", rc=rc, clean=True)
            return 0
        if uptime >= STABLE_UPTIME_S:
            failures = 0
        failures += 1
        if failures > max_restarts:
            log_event(log, "giving up", rc=rc, consecutive_failures=failures,
                      max_restarts=max_restarts)
            return 1
        delay = min(0.5 * (2 ** (failures - 1)), MAX_BACKOFF_S)
        log_event(log, "child died, restarting", rc=rc, uptime_s=round(uptime, 2),
                  backoff_s=delay, attempt=failures)
        time.sleep(delay)


if __name__ == "__main__":
    raise SystemExit(main())
