"""Vendor backend of the port, the twin of
``lambdipy_tpu/buildengine/vendor.py``: copy installed distributions into
a bundle site tree. The host's installed set is the wheel store, and a
distribution's file list (``RECORD`` via ``importlib.metadata``) says
what to copy.
"""

from __future__ import annotations

import importlib.metadata
import shutil
from pathlib import Path

from packaging.utils import canonicalize_name

from lambdipy_tpu_torch.utils.logs import get_logger

log = get_logger("lambdipy.vendor")


class VendorError(RuntimeError):
    pass


def find_distribution(name: str) -> importlib.metadata.Distribution | None:
    try:
        return importlib.metadata.distribution(name)
    except importlib.metadata.PackageNotFoundError:
        return None


def import_names(dist: importlib.metadata.Distribution) -> list[str]:
    """Top-level import names for a distribution (scikit-learn -> sklearn).

    Prefers ``top_level.txt``; falls back to scanning the file list for
    top-level packages/modules.
    """
    try:
        text = dist.read_text("top_level.txt")
    except Exception:
        text = None
    if text:
        return [line.strip() for line in text.splitlines() if line.strip()]
    names: set[str] = set()
    for f in dist.files or []:
        parts = Path(str(f)).parts
        if not parts or parts[0].endswith((".dist-info", ".data")) or parts[0] == "..":
            continue
        if len(parts) == 1:
            if parts[0].endswith(".py"):
                names.add(parts[0].removesuffix(".py"))
            elif ".so" in parts[0]:
                names.add(parts[0].split(".")[0])
        else:
            names.add(parts[0])
    # drop non-importable artifacts: "numpy.libs" (bundled .so dirs),
    # top-level __pycache__ from sloppy RECORDs
    return sorted(n for n in names if n and "." not in n and n != "__pycache__")


def dependency_closure(roots: list[str]) -> list[str]:
    """Transitive closure of installed distributions reachable from ``roots``.

    Roots may carry extras (``cuda-toolkit[cublas]``). Markers are evaluated against the
    running environment; extra-gated deps are followed only for requested
    extras. Distributions not installed locally are silently absent from the
    closure — the engine decides whether that is fatal (mandatory) or not
    (optional/base-layer-provided).
    """
    from packaging.markers import default_environment
    from packaging.requirements import Requirement as PepReq

    env_base = default_environment()
    seen: set[str] = set()
    visited: set[tuple[str, frozenset[str]]] = set()  # termination on extras cycles
    queue: list[tuple[str, frozenset[str]]] = []
    for root in roots:
        req = PepReq(root) if any(c in root for c in "[<>=!~;") else None
        if req is not None:
            queue.append((canonicalize_name(req.name), frozenset(req.extras)))
        else:
            queue.append((canonicalize_name(root), frozenset()))
    while queue:
        cname, extras = queue.pop()
        if (cname, extras) in visited:
            continue
        visited.add((cname, extras))
        dist = find_distribution(cname)
        if dist is None:
            continue
        seen.add(cname)
        for req_str in dist.requires or []:
            req = PepReq(req_str)
            if req.marker is not None:
                ok = any(
                    req.marker.evaluate({**env_base, "extra": e})
                    for e in (extras or {""})
                )
                if not ok:
                    continue
            queue.append((canonicalize_name(req.name), frozenset(req.extras)))
    return sorted(seen)


def vendor_distribution(name: str, dest_site: Path) -> dict:
    """Copy one installed distribution's files into ``dest_site``.

    Returns a provenance record {name, version, n_files, bytes}. Raises
    :class:`VendorError` when the distribution is not installed.
    """
    dist = find_distribution(name)
    if dist is None:
        raise VendorError(
            f"distribution {name!r} is not installed in the local wheel store")
    dest_site = Path(dest_site)
    dest_site.mkdir(parents=True, exist_ok=True)
    n_files = 0
    n_bytes = 0
    for f in dist.files or []:
        rel = Path(str(f))
        if rel.suffix == ".pyc" or "__pycache__" in rel.parts:
            continue
        # files outside site-packages (console scripts in ../../../bin) are
        # not part of an importable bundle — skip, like the reference's
        # artifact tars which carry only the package tree
        if rel.parts and rel.parts[0] == "..":
            continue
        src = Path(dist.locate_file(f))
        if not src.is_file():
            continue
        dst = dest_site / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(src, dst, follow_symlinks=True)
        n_files += 1
        n_bytes += dst.stat().st_size
    if n_files == 0:
        raise VendorError(f"distribution {name!r} has no copyable files (no RECORD?)")
    return {
        "name": canonicalize_name(name),
        "version": dist.version,
        "files": n_files,
        "bytes": n_bytes,
        "import_names": import_names(dist),
    }
