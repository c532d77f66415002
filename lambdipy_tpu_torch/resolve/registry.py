"""Local artifact registry of the port, the twin of
``lambdipy_tpu/resolve/registry.py``: one directory per artifact id.

    <root>/
      artifacts/<artifact_id>/bundle/...     # the built bundle tree
      artifacts/<artifact_id>/manifest.json  # provenance + per-file hashes
      index.json                             # artifact_id -> summary

``publish`` copies a built bundle in; ``fetch`` returns its cached path.
Each read-modify-write of ``index.json`` holds an ``flock`` on
``index.lock``, so builds running at once each keep their entry (JAX's
registry writes the index unlocked).
The root defaults to ``~/.lambdipy-tpu-torch/registry`` (JAX's is
``~/.lambdipy-tpu/registry``); every command takes ``--registry``.
"""

from __future__ import annotations

import contextlib
import fcntl
import json
import shutil
import time
from dataclasses import dataclass
from pathlib import Path

from lambdipy_tpu_torch.utils.fsutil import atomic_write_text, copy_tree, dir_size

DEFAULT_ROOT = Path.home() / ".lambdipy-tpu-torch" / "registry"


class RegistryError(RuntimeError):
    pass


@dataclass(frozen=True)
class ArtifactInfo:
    artifact_id: str
    recipe: str
    version: str
    device: str
    size_bytes: int
    created: float


class ArtifactRegistry:
    def __init__(self, root: Path | None = None):
        self.root = Path(root) if root else DEFAULT_ROOT
        self.artifacts_dir = self.root / "artifacts"
        self.index_path = self.root / "index.json"
        self.artifacts_dir.mkdir(parents=True, exist_ok=True)

    def _load_index(self) -> dict:
        if self.index_path.exists():
            return json.loads(self.index_path.read_text())
        return {}

    def _save_index(self, index: dict) -> None:
        atomic_write_text(self.index_path, json.dumps(index, indent=1, sort_keys=True))

    @contextlib.contextmanager
    def _index_lock(self):
        with open(self.root / "index.lock", "a") as f:
            fcntl.flock(f, fcntl.LOCK_EX)  # released when f closes
            yield

    def list(self) -> list[ArtifactInfo]:
        return [ArtifactInfo(**v) for v in self._load_index().values()]

    def has(self, artifact_id: str) -> bool:
        return (self.artifacts_dir / artifact_id / "bundle").is_dir()

    def fetch(self, artifact_id: str) -> Path:
        """Return the bundle tree for an artifact (the cache-hit path)."""
        path = self.artifacts_dir / artifact_id / "bundle"
        if not path.is_dir():
            raise RegistryError(f"artifact {artifact_id!r} not in registry")
        return path

    def publish(self, artifact_id: str, bundle_dir: Path, *, recipe: str,
                version: str, device: str, manifest: dict | None = None) -> Path:
        """Publish a built bundle into the registry (a copy of the tree)."""
        dst = self.artifacts_dir / artifact_id
        if dst.exists():
            shutil.rmtree(dst)
        dst.mkdir(parents=True)
        copy_tree(Path(bundle_dir), dst / "bundle")
        if manifest is not None:
            atomic_write_text(dst / "manifest.json", json.dumps(manifest, indent=1, sort_keys=True))
        entry = {
            "artifact_id": artifact_id,
            "recipe": recipe,
            "version": version,
            "device": device,
            "size_bytes": dir_size(dst / "bundle"),
            "created": time.time(),
        }
        with self._index_lock():
            index = self._load_index()
            index[artifact_id] = entry
            self._save_index(index)
        return dst / "bundle"

    def delete(self, artifact_id: str) -> None:
        dst = self.artifacts_dir / artifact_id
        if dst.exists():
            shutil.rmtree(dst)
        with self._index_lock():
            index = self._load_index()
            index.pop(artifact_id, None)
            self._save_index(index)
