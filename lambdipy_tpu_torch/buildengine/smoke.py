"""Hermetic import smoke, the twin of ``lambdipy_tpu/buildengine/smoke.py``:
the post-prune gate. The current interpreter runs with ``-I -S``
(isolated, no site-packages), so the only importable packages are the
bundle's site tree and the base layer's materialized site; a wrong
``rm`` or ``strip`` shows as an import error here.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path


class SmokeError(RuntimeError):
    pass


_SMOKE_PROG = r"""
import importlib, json, sys
paths = json.loads(sys.argv[1])
mods = json.loads(sys.argv[2])
sys.path[:0] = paths
out = {}
for mod in mods:
    m = importlib.import_module(mod)
    out[mod] = getattr(m, "__version__", "n/a")
print(json.dumps(out))
"""


def import_smoke(site_dir: Path, modules: list[str], *, timeout: float = 300.0,
                 env: dict[str, str] | None = None,
                 base_paths: list[str] | None = None) -> dict[str, str]:
    """Import ``modules`` in a hermetic interpreter (``-I -S``) where the
    importable world is exactly ``site_dir`` plus ``base_paths`` (the shared
    base layer, when the recipe declares one). Returns {module: __version__}.
    """
    if not modules:
        return {}
    paths = [str(site_dir)] + list(base_paths or [])
    cmd = [sys.executable, "-I", "-S", "-c", _SMOKE_PROG,
           json.dumps(paths), json.dumps(sorted(set(modules)))]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout,
                          env=env or {})
    if proc.returncode != 0:
        raise SmokeError(
            f"import smoke failed for {modules} in {site_dir}:\n{proc.stderr.strip()}")
    return json.loads(proc.stdout.strip().splitlines()[-1])
