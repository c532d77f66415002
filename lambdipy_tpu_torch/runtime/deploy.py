"""Deploy layer of the port, the twin of ``lambdipy_tpu/runtime/deploy.py``:
a local process per deployment. ``LocalRuntime`` spawns the bundle server
(under the watchdog supervisor by default), waits for its readiness line,
and records the deployment in a state file; ``invoke``, ``health``,
``metrics`` and ``stop`` act on it by name.

The server runs on the card unless the deployment asks for the CPU
(``device="cpu"``, or ``LAMBDIPY_PLATFORM=cpu`` in its environment, the
variable the port's server reads). With no card and no CPU request
:meth:`LocalRuntime.deploy` raises before it spawns anything. The state
file defaults to ``~/.lambdipy-tpu-torch/deployments.json`` (JAX's is
``~/.lambdipy-tpu/``), so neither package stops the other's deployments;
each deployment's server log is ``<name>.serve.log`` beside it. Each
read-modify-write of the state file holds an ``flock`` on
``deployments.lock`` beside it, so deploys and stops in several
processes (a ``deploy`` beside a ``fleet``) lose no entry.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from dataclasses import dataclass
from pathlib import Path

from lambdipy_tpu_torch.utils.fsutil import atomic_write_text
from lambdipy_tpu_torch.utils.logs import get_logger, log_event

log = get_logger("lambdipy.deploy")

DEFAULT_STATE = Path.home() / ".lambdipy-tpu-torch" / "deployments.json"


class DeployError(RuntimeError):
    pass


@dataclass
class Deployment:
    name: str
    bundle_dir: str
    pid: int
    port: int
    cold_start: dict

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"


def _http_json(url: str, payload: dict | None = None,
               timeout: float = 30.0) -> dict:
    if payload is None:
        req = urllib.request.Request(url)
    else:
        req = urllib.request.Request(
            url, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def cuda_cards(env: dict) -> int:
    """The CUDA cards a process with ``env`` would see, as libcuda's
    ``cuDeviceGetCount`` counts them (0 without libcuda): the check costs
    milliseconds, where importing torch for it would cost seconds of every
    deploy."""
    visible = env.get("CUDA_VISIBLE_DEVICES")
    if visible is not None and not visible.strip():
        return 0
    try:
        lib = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return 0
    count = ctypes.c_int(0)
    if lib.cuInit(0) != 0 or lib.cuDeviceGetCount(ctypes.byref(count)) != 0:
        return 0
    return count.value


def require_device(env: dict) -> None:
    """Raise :class:`DeployError` unless the deployment can run: on the
    CPU when ``env`` asks for it, else on a CUDA card that is present."""
    if env.get("LAMBDIPY_PLATFORM") == "cpu":
        return
    if cuda_cards(env) == 0:
        raise DeployError(
            "no CUDA device is available; deploy on the CPU with --device "
            "cpu (LAMBDIPY_PLATFORM=cpu)")


class LocalRuntime:
    """Process-per-function local runtime with a persisted deployment
    table."""

    def __init__(self, state_path: Path | None = None):
        self.state_path = Path(state_path) if state_path else DEFAULT_STATE
        self.state_path.parent.mkdir(parents=True, exist_ok=True)

    def _load(self) -> dict:
        if self.state_path.exists():
            return json.loads(self.state_path.read_text())
        return {}

    def _save(self, state: dict) -> None:
        atomic_write_text(self.state_path, json.dumps(state, indent=1))

    @contextlib.contextmanager
    def _state_lock(self):
        with open(self.state_path.with_suffix(".lock"), "a") as f:
            fcntl.flock(f, fcntl.LOCK_EX)  # released when f closes
            yield

    def deploy(self, name: str, bundle_dir: Path, *, port: int = 0,
               ready_timeout: float = 300.0, env: dict | None = None,
               watchdog: bool = True, device: str | None = None
               ) -> Deployment:
        """Spawn a server for the bundle and wait until it reports ready.

        ``watchdog`` (default) runs the server under the restart
        supervisor: a crashed server is respawned on the same port with
        backoff, so the deployment's URL heals itself. ``device="cpu"``
        serves on the CPU; otherwise the card, which must be present."""
        bundle_dir = Path(bundle_dir).resolve()
        state = self._load()
        if name in state:
            raise DeployError(
                f"deployment {name!r} already exists; stop it first")
        full_env = dict(os.environ)
        full_env.update(env or {})
        if device is not None:
            if device != "cpu":
                raise DeployError(f"device {device!r}: a deployment runs on "
                                  "the card (the default) or 'cpu'")
            full_env["LAMBDIPY_PLATFORM"] = "cpu"
        require_device(full_env)
        # surface a failed build-time warm before paying for it: this
        # boot builds the kernel libraries itself if they are missing
        try:
            from lambdipy_tpu_torch.bundle.format import load_manifest

            warm_info = load_manifest(bundle_dir).get("warm")
            if isinstance(warm_info, dict) and not warm_info.get("ok"):
                log_event(log, "bundle warm step failed at build time",
                          name=name, warm_error=warm_info.get("error", ""))
        except Exception:  # noqa: BLE001 — advisory only, never blocks
            pass
        module = ("lambdipy_tpu_torch.runtime.supervisor" if watchdog
                  else "lambdipy_tpu_torch.runtime.server")
        cmd = [sys.executable, "-m", module, str(bundle_dir), str(port)]
        # the port itself must be importable in the server process
        repo_root = str(Path(__file__).resolve().parents[2])
        full_env["PYTHONPATH"] = os.pathsep.join(
            [repo_root] + [p for p in full_env.get("PYTHONPATH", "")
                           .split(os.pathsep) if p])
        # the server's stderr goes to a per-deployment log, so a boot
        # failure is diagnosable
        log_path = self.state_path.parent / f"{name}.serve.log"
        with open(log_path, "w") as stderr_f:
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=stderr_f, text=True, env=full_env,
                                    start_new_session=True)

        def _log_tail() -> str:
            try:
                return log_path.read_text(errors="replace")[-800:]
            except OSError:
                return ""

        deadline = time.monotonic() + ready_timeout
        ready_line = None
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                if proc.poll() is not None:
                    raise DeployError(
                        f"server for {name!r} exited rc={proc.returncode} "
                        f"before ready; log tail ({log_path}):\n"
                        f"{_log_tail()}")
                time.sleep(0.05)
                continue
            try:
                parsed = json.loads(line)
            except json.JSONDecodeError:
                continue
            if parsed.get("ready"):
                ready_line = parsed
                break
        if ready_line is None:
            # group-kill: with the watchdog a supervisor fronts the server,
            # and killing only the supervisor would orphan the booting child
            _signal_group(proc.pid, signal.SIGKILL)
            raise DeployError(
                f"deployment {name!r} not ready within {ready_timeout}s; "
                f"log tail ({log_path}):\n{_log_tail()}")
        dep = Deployment(name=name, bundle_dir=str(bundle_dir), pid=proc.pid,
                         port=ready_line["port"],
                         cold_start=ready_line.get("cold_start", {}))
        with self._state_lock():
            state = self._load()
            taken = name in state  # a deploy of the same name won the race
            if not taken:
                state[name] = dep.__dict__
                self._save(state)
        if taken:
            _signal_group(proc.pid, signal.SIGKILL)
            raise DeployError(
                f"deployment {name!r} already exists; stop it first")
        log_event(log, "deployed", name=name, port=dep.port,
                  cold_start=dep.cold_start)
        return dep

    def restart(self, name: str, *, ready_timeout: float = 300.0,
                env: dict | None = None, watchdog: bool = True,
                grace: float = 5.0, device: str | None = None
                ) -> Deployment:
        """Drain and stop, then redeploy the same bundle on the SAME
        port, so whatever holds the deployment's URL (the fleet router's
        replica table) stays valid: the rolling-restart primitive of
        ``fleet/pool.py``. :meth:`stop` waits for the old process group
        to exit, so its card memory is free before the new one boots."""
        dep = self.get(name)
        self.stop(name, grace=grace)
        return self.deploy(name, Path(dep.bundle_dir), port=dep.port,
                           ready_timeout=ready_timeout, env=env,
                           watchdog=watchdog, device=device)

    def list(self) -> list[Deployment]:
        return [Deployment(**v) for v in self._load().values()]

    def get(self, name: str) -> Deployment:
        state = self._load()
        if name not in state:
            raise DeployError(f"no deployment named {name!r}")
        return Deployment(**state[name])

    def invoke(self, name: str, request: dict, timeout: float = 60.0) -> dict:
        dep = self.get(name)
        return _http_json(f"{dep.url}/invoke", request, timeout=timeout)

    def invoke_stream(self, name: str, request: dict, timeout: float = 60.0):
        """Streaming invoke: sets ``stream: true`` and yields one dict per
        ndjson line as the server emits decode segments."""
        dep = self.get(name)
        req = urllib.request.Request(
            f"{dep.url}/invoke",
            data=json.dumps({**request, "stream": True}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            for line in resp:  # urllib de-chunks; one JSON object per line
                line = line.strip()
                if line:
                    yield json.loads(line)

    def health(self, name: str) -> dict:
        return _http_json(f"{self.get(name).url}/healthz")

    def metrics(self, name: str) -> dict:
        return _http_json(f"{self.get(name).url}/metrics")

    def stop(self, name: str, *, grace: float = 5.0) -> None:
        """Drain via ``/shutdown``, escalate to SIGTERM, then SIGKILL the
        whole process group (deploys start a new session, so this reaps
        the supervisor and its server child), and wait until no process
        of the group is left: a dead server has given its card memory
        back before the next deployment boots."""
        dep = self.get(name)
        try:
            _http_json(f"{dep.url}/shutdown", {})
        except Exception:  # noqa: BLE001 — a dead server drains nothing
            pass
        if not _wait_dead(dep.pid, grace):
            _signal_group(dep.pid, signal.SIGTERM)
            if not _wait_dead(dep.pid, grace):
                _signal_group(dep.pid, signal.SIGKILL)
        if not _wait_group_gone(dep.pid, grace):
            _signal_group(dep.pid, signal.SIGKILL)  # an orphaned child
            _wait_group_gone(dep.pid, grace)
        with self._state_lock():
            state = self._load()
            state.pop(name, None)
            self._save(state)
        # the per-deployment serve.log dies with its deployment entry
        (self.state_path.parent / f"{name}.serve.log").unlink(missing_ok=True)
        log_event(log, "stopped", name=name)


def _stat(pid: int) -> tuple[str, int] | None:
    """(state, process group) of ``pid`` from ``/proc``; None when it is
    gone."""
    try:
        raw = Path(f"/proc/{pid}/stat").read_text()
    except OSError:
        return None
    fields = raw[raw.rindex(")") + 2:].split()
    return fields[0], int(fields[2])


def _pid_alive(pid: int) -> bool:
    """A process that has not exited: a zombie (exited, not yet reaped by
    its parent) is dead, and has released its memory and its files."""
    st = _stat(pid)
    return st is not None and st[0] not in ("Z", "X")


def _wait_dead(pid: int, grace: float) -> bool:
    deadline = time.monotonic() + grace
    while time.monotonic() < deadline:
        if not _pid_alive(pid):
            return True
        time.sleep(0.1)
    return not _pid_alive(pid)


def _group_alive(pgid: int) -> bool:
    """Whether a process of the group has not exited (zombies aside)."""
    for entry in Path("/proc").iterdir():
        if entry.name.isdigit():
            st = _stat(int(entry.name))
            if st is not None and st[1] == pgid and st[0] not in ("Z", "X"):
                return True
    return False


def _wait_group_gone(pgid: int, grace: float) -> bool:
    """Until every process of the group has exited: an exited server has
    given its card memory back."""
    deadline = time.monotonic() + grace
    while time.monotonic() < deadline:
        if not _group_alive(pgid):
            return True
        time.sleep(0.05)
    return not _group_alive(pgid)


def _signal_group(pid: int, sig: int) -> None:
    """Signal the deployment's process group, falling back to the single
    pid if the group is gone."""
    try:
        os.killpg(pid, sig)
    except (ProcessLookupError, PermissionError):
        try:
            os.kill(pid, sig)
        except (ProcessLookupError, PermissionError):
            pass
