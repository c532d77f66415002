"""Source store of the port, the twin of ``lambdipy_tpu/resolve/sources.py``:
sdist recipes' sources from a local archive of source archives
(``/source.tar.gz`` by default, as in JAX), unpacked lazily into a cache
(``~/.lambdipy-tpu-torch/sources``); a recipe's ``build.source`` key
(e.g. ``"certifi"``) resolves to an unpacked source tree.
"""

from __future__ import annotations

import tarfile
import tempfile
from pathlib import Path

DEFAULT_ARCHIVE = Path("/source.tar.gz")
DEFAULT_CACHE = Path.home() / ".lambdipy-tpu-torch" / "sources"


class SourceError(RuntimeError):
    pass


def _safe_extract(tar: tarfile.TarFile, dest: Path) -> None:
    # the stdlib "data" filter rejects path traversal, absolute names,
    # devices, and chmod/chown escalation (PEP 706)
    tar.extractall(dest, filter="data")


class SourceStore:
    def __init__(self, archive: Path | None = None, cache: Path | None = None):
        self.archive = Path(archive) if archive else DEFAULT_ARCHIVE
        self.cache = Path(cache) if cache else DEFAULT_CACHE

    def _ensure_extracted(self) -> Path:
        outer = self.cache / "outer"
        if not outer.is_dir():
            if not self.archive.exists():
                raise SourceError(f"source archive {self.archive} not found")
            self.cache.mkdir(parents=True, exist_ok=True)
            tmp = Path(tempfile.mkdtemp(dir=self.cache))
            with tarfile.open(self.archive) as tar:
                _safe_extract(tar, tmp)
            tmp.replace(outer)
        return outer

    def available(self) -> list[str]:
        try:
            outer = self._ensure_extracted()
        except SourceError:
            return []
        return sorted(p.name.split("@")[0].removeprefix("Python_").lower()
                      for p in outer.glob("*.tar.gz"))

    def resolve(self, source: str) -> Path:
        """Return the unpacked source tree for a named source (the directory
        containing pyproject.toml/setup.py)."""
        outer = self._ensure_extracted()
        matches = [p for p in outer.glob("*.tar.gz")
                   if p.name.lower().removeprefix("python_").startswith(source.lower())]
        if not matches:
            raise SourceError(
                f"source {source!r} not found in {self.archive}; available: {self.available()}")
        inner = matches[0]
        unpack_dir = self.cache / "trees" / inner.name.removesuffix(".tar.gz")
        if not unpack_dir.is_dir():
            unpack_dir.parent.mkdir(parents=True, exist_ok=True)
            with tarfile.open(inner) as tar:
                _safe_extract(tar, unpack_dir)
        # the project root is the dir holding pyproject.toml/setup.py — either
        # the unpack dir itself or its single top-level directory
        for candidate in [unpack_dir, *sorted(unpack_dir.iterdir())]:
            if candidate.is_dir() and any((candidate / f).exists() for f in ("pyproject.toml", "setup.py")):
                return candidate
        raise SourceError(f"no pyproject.toml/setup.py found under {unpack_dir}")
