"""Build sandbox for sdist recipes, the twin of
``lambdipy_tpu/buildengine/sandbox.py``: a wheel built from a local source
tree with ``python -m build --no-isolation`` (build dependencies come from
the host: there is no network), unpacked into the bundle's site tree by a
minimal installer; a disposable venv for a recipe's extra build steps.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

from lambdipy_tpu_torch.utils.logs import get_logger

log = get_logger("lambdipy.sandbox")


class SandboxError(RuntimeError):
    pass


def build_wheel(source_tree: Path, out_dir: Path, *, env: dict[str, str] | None = None,
                timeout: float = 1800.0) -> Path:
    """Build a wheel from a source tree. Returns the wheel path."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    cmd = [sys.executable, "-m", "build", "--wheel", "--no-isolation",
           "--outdir", str(out_dir), str(source_tree)]
    full_env = dict(os.environ)
    full_env.update(env or {})
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, env=full_env)
    if proc.returncode != 0:
        raise SandboxError(
            f"wheel build failed for {source_tree}:\n{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    wheels = sorted(out_dir.glob("*.whl"))
    if not wheels:
        raise SandboxError(f"build succeeded but no wheel found in {out_dir}")
    return wheels[-1]


def install_wheel(wheel: Path, dest_site: Path) -> dict:
    """Unpack a wheel into a site tree (purelib/platlib merged, scripts and
    headers dropped — bundles carry importable code only, like the
    reference's artifact tars)."""
    dest_site = Path(dest_site)
    dest_site.mkdir(parents=True, exist_ok=True)
    n_files = 0
    with zipfile.ZipFile(wheel) as zf:
        names = zf.namelist()
        data_prefixes = {n.split("/")[0] for n in names if ".data/" in n.split("/")[0]}
        for name in names:
            if name.endswith("/"):
                continue
            parts = name.split("/")
            target_rel: str | None = name
            if parts[0] in data_prefixes:
                # foo-1.0.data/{purelib,platlib}/pkg/... -> pkg/...
                if len(parts) >= 3 and parts[1] in ("purelib", "platlib"):
                    target_rel = "/".join(parts[2:])
                else:  # scripts/headers/data — not importable, skip
                    target_rel = None
            if target_rel is None:
                continue
            dst = dest_site / target_rel
            dst.parent.mkdir(parents=True, exist_ok=True)
            with zf.open(name) as src, open(dst, "wb") as out:
                shutil.copyfileobj(src, out)
            n_files += 1
    # rewrite RECORD paths? RECORD is copied as-is from dist-info; the prune
    # pass drops it (stale after pruning anyway).
    dist_info = next(dest_site.glob("*.dist-info"), None)
    name, version = ("unknown", "0")
    if dist_info is not None:
        stem = dist_info.name.removesuffix(".dist-info")
        name, _, version = stem.rpartition("-")
    return {"name": name, "version": version, "files": n_files, "wheel": wheel.name}


class VenvSandbox:
    """A disposable uv venv used to run recipe build steps in isolation.

    Only sdist recipes with explicit ``build.steps`` need this; the certifi
    exemplar builds with :func:`build_wheel` directly.
    """

    def __init__(self, root: Path):
        self.root = Path(root)
        self.python = self.root / "bin" / "python"

    @classmethod
    def create(cls, root: Path) -> "VenvSandbox":
        root = Path(root)
        uv = shutil.which("uv")
        if uv:
            proc = subprocess.run([uv, "venv", str(root)], capture_output=True, text=True)
            if proc.returncode != 0:
                raise SandboxError(f"uv venv failed: {proc.stderr}")
        else:
            import venv

            venv.create(root, with_pip=False)
        return cls(root)

    def run(self, args: list[str], *, cwd: Path | None = None,
            env: dict[str, str] | None = None, timeout: float = 1800.0) -> str:
        import os

        full_env = dict(os.environ)
        full_env["VIRTUAL_ENV"] = str(self.root)
        full_env["PATH"] = f"{self.root / 'bin'}:{full_env.get('PATH', '')}"
        full_env.update(env or {})
        proc = subprocess.run(args, capture_output=True, text=True, cwd=cwd,
                              env=full_env, timeout=timeout)
        if proc.returncode != 0:
            raise SandboxError(
                f"sandbox step {args!r} failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
        return proc.stdout
