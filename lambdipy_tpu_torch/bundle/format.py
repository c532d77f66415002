"""Bundle manifest of the port, the twin of ``lambdipy_tpu/bundle/format.py``:
the schema version, the reader, and a writer for bundles made without the
JAX builder. The writer hashes with ``sha256:``; the reader takes a JAX
manifest's ``xxh64:`` hashes as they are (boot does not re-verify the
files, as in JAX)."""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

BUNDLE_SCHEMA_VERSION = 1
MANIFEST_NAME = "manifest.json"


class BundleError(RuntimeError):
    pass


def _walk_files(root: Path):
    """Every file under ``root``, sorted (deterministic)."""
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for name in sorted(filenames):
            yield Path(dirpath) / name


def _sha256(path: Path) -> str:
    with open(path, "rb") as f:
        return "sha256:" + hashlib.file_digest(f, "sha256").hexdigest()


def file_table(bundle_dir: Path) -> list[dict]:
    bundle_dir = Path(bundle_dir)
    table = []
    for path in _walk_files(bundle_dir):
        rel = path.relative_to(bundle_dir).as_posix()
        if rel == MANIFEST_NAME or not path.is_file():
            continue  # is_file() is False for dangling symlinks
        table.append({"path": rel, "size": path.stat().st_size,
                      "hash": _sha256(path)})
    return table


def write_manifest(bundle_dir: Path, *, artifact_id: str, provenance: dict,
                   base_layer: dict, payload: dict | None,
                   runtime: dict | None = None) -> dict:
    bundle_dir = Path(bundle_dir)
    manifest = {
        "schema": BUNDLE_SCHEMA_VERSION,
        "artifact_id": artifact_id,
        "provenance": provenance,
        "base_layer": base_layer,
        "payload": payload,
        "runtime": runtime or {},
        "files": file_table(bundle_dir),
    }
    tmp = bundle_dir / (MANIFEST_NAME + ".tmp")
    tmp.write_text(json.dumps(manifest, indent=1, sort_keys=True))
    os.replace(tmp, bundle_dir / MANIFEST_NAME)
    return manifest


def load_manifest(bundle_dir: Path) -> dict:
    path = Path(bundle_dir) / MANIFEST_NAME
    if not path.exists():
        raise BundleError(f"{bundle_dir} is not a bundle (no {MANIFEST_NAME})")
    manifest = json.loads(path.read_text())
    if manifest.get("schema") != BUNDLE_SCHEMA_VERSION:
        raise BundleError(
            f"unsupported bundle schema {manifest.get('schema')!r} in "
            f"{bundle_dir}")
    return manifest
