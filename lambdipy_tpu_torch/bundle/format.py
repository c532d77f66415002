"""Bundle manifest of the port, the twin of ``lambdipy_tpu/bundle/format.py``:
the schema version, the writer, the reader, the merge of a late field
(the build's ``warm`` record) and the integrity check. The writer hashes
with ``sha256:``; the reader takes a JAX manifest's ``xxh64:`` hashes as
they are (boot does not re-verify the files, as in JAX), and
:func:`verify_files` reports such a file as unverifiable."""

from __future__ import annotations

import json
from pathlib import Path

from lambdipy_tpu_torch.utils.fsutil import (atomic_write_text, hash_file,
                                             walk_files)

BUNDLE_SCHEMA_VERSION = 1
MANIFEST_NAME = "manifest.json"


class BundleError(RuntimeError):
    pass


def file_table(bundle_dir: Path) -> list[dict]:
    bundle_dir = Path(bundle_dir)
    table = []
    for path in walk_files(bundle_dir):
        rel = path.relative_to(bundle_dir).as_posix()
        if rel == MANIFEST_NAME or not path.is_file():
            continue  # is_file() is False for dangling symlinks
        table.append({"path": rel, "size": path.stat().st_size,
                      "hash": hash_file(path)})
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
    atomic_write_text(bundle_dir / MANIFEST_NAME,
                      json.dumps(manifest, indent=1, sort_keys=True))
    return manifest


def update_manifest(bundle_dir: Path, **fields) -> dict:
    """Merge top-level fields into an existing manifest (the build's
    ``warm`` record, written after assembly). The file table is not
    recomputed: it never includes the manifest itself."""
    manifest = load_manifest(bundle_dir)
    manifest.update(fields)
    atomic_write_text(Path(bundle_dir) / MANIFEST_NAME,
                      json.dumps(manifest, indent=1, sort_keys=True))
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


def verify_files(bundle_dir: Path, manifest: dict | None = None) -> list[str]:
    """Integrity check: the problems found (empty = ok)."""
    bundle_dir = Path(bundle_dir)
    manifest = manifest or load_manifest(bundle_dir)
    problems = []
    for entry in manifest["files"]:
        path = bundle_dir / entry["path"]
        if not path.is_file():
            problems.append(f"missing: {entry['path']}")
            continue
        if path.stat().st_size != entry["size"]:
            problems.append(f"size mismatch: {entry['path']}")
            continue
        try:
            recomputed = hash_file(path, algo=entry["hash"].split(":", 1)[0])
        except RuntimeError as e:  # a hash the port cannot compute
            problems.append(f"unverifiable ({e}): {entry['path']}")
            continue
        if recomputed != entry["hash"]:
            problems.append(f"hash mismatch: {entry['path']}")
    return problems
