"""Filesystem helpers of the build engine, the prune pass and the bundle
stores: the twin of ``lambdipy_tpu/utils/fsutil.py``.

The port hashes with :mod:`hashlib` alone (``sha256:``). The JAX package
prefers its optional native ``xxh64`` extension; a manifest whose hashes
are ``xxh64:`` cannot be re-verified here, and :func:`hash_file` says so
(``bundle/format.py verify_files`` reports such a file as unverifiable).
"""

from __future__ import annotations

import hashlib
import os
import shutil
from collections.abc import Iterator
from pathlib import Path

_CHUNK = 1 << 20


def walk_files(root: Path) -> Iterator[Path]:
    """Yield all regular files under root (sorted, deterministic)."""
    root = Path(root)
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for name in sorted(filenames):
            p = Path(dirpath) / name
            if p.is_file() or p.is_symlink():
                yield p


def sha256_file(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(_CHUNK):
            h.update(chunk)
    return h.hexdigest()


def hash_file(path: Path, algo: str | None = None) -> str:
    """Content hash for manifests and release assets: ``sha256:<hex>``.
    ``algo`` pins the algorithm when re-verifying a hash made elsewhere;
    only ``sha256`` is available."""
    if algo not in (None, "sha256"):
        raise RuntimeError(f"hash {algo!r} is not available in the port "
                           "(it hashes with sha256 only)")
    return f"sha256:{sha256_file(path)}"


def dir_size(root: Path) -> int:
    return sum(p.stat().st_size for p in walk_files(root) if p.is_file())


def copy_tree(src: Path, dst: Path, *, symlinks: bool = True) -> None:
    shutil.copytree(src, dst, symlinks=symlinks, dirs_exist_ok=True)


def atomic_write_text(path: Path, text: str) -> None:
    path = Path(path)
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_text(text)
    os.replace(tmp, path)


def atomic_write_bytes(path: Path, data: bytes) -> None:
    path = Path(path)
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_bytes(data)
    os.replace(tmp, path)
