"""Prune and strip pass of the port, the twin of
``lambdipy_tpu/buildengine/prune.py``: the same rule engine (directories
and files by rule, ``extra_remove`` globs, ``keep`` globs, the dist-info
trim, the guarded ``strip``), with the serving stack's whitelist in place
of JAX's XLA/PJRT one. :data:`SERVING_WHITELIST` names torch's CUDA
libraries (``libtorch_cuda``, ``libc10_cuda``), the NVIDIA wheels
(cuBLAS, cuDNN, NCCL, the runtime, under ``nvidia/``) and ``triton``: no
rule removes them and ``strip`` never touches them, whatever a recipe
says.

Glob note: patterns are matched with :func:`fnmatch.fnmatch` against the
POSIX relative path, where ``*`` already crosses ``/`` boundaries; ``**`` is
normalized to ``*``.
"""

from __future__ import annotations

import fnmatch
import shutil
import subprocess
from dataclasses import dataclass, field
from pathlib import Path

from lambdipy_tpu_torch.recipes.schema import PruneSpec
from lambdipy_tpu_torch.utils.fsutil import walk_files
from lambdipy_tpu_torch.utils.logs import get_logger

log = get_logger("lambdipy.prune")

# Never removed, never stripped: the port's serving stack on the card
SERVING_WHITELIST: tuple[str, ...] = (
    "*libtorch_cuda*",   # torch/lib/libtorch_cuda.so: torch's CUDA kernels
    "*libc10_cuda*",     # torch/lib/libc10_cuda.so: the CUDA allocator
    "nvidia/*",          # the NVIDIA wheels: cuBLAS, cuDNN, NCCL, the runtime
    "triton/*",          # triton's compiler and its bundled CUDA tools
)

# Directory names removed by the named rules. "testing" is deliberately NOT
# here: numpy.testing / torch.testing are imported at runtime by downstreams.
_RULE_DIRS = {
    "tests": ("tests", "test"),
    "pycache": ("__pycache__",),
    "docs": ("docs", "doc", "examples", "benchmarks"),
    "headers": ("include",),
}
_RULE_FILES = {
    "pycache": ("*.pyc", "*.pyo"),
    "pyi": ("*.pyi",),
    "docs": ("*.md", "*.rst"),
    "headers": ("*.h", "*.hpp", "*.pxd"),
}
# Inside *.dist-info, only these survive the dist-info-extras rule. RECORD is
# dropped deliberately: its hashes go stale the moment pruning removes files.
_DIST_INFO_KEEP = ("METADATA", "WHEEL", "entry_points.txt", "top_level.txt",
                   "LICENSE*", "licenses/*", "INSTALLER")

KNOWN_RULES = frozenset(_RULE_DIRS) | frozenset(_RULE_FILES) | {"dist-info-extras"}


@dataclass
class PruneReport:
    bytes_before: int = 0
    bytes_after: int = 0
    files_removed: int = 0
    dirs_removed: int = 0
    sos_stripped: int = 0
    whitelisted: list[str] = field(default_factory=list)

    @property
    def bytes_saved(self) -> int:
        return self.bytes_before - self.bytes_after

    def as_dict(self) -> dict:
        return {
            "bytes_before": self.bytes_before,
            "bytes_after": self.bytes_after,
            "bytes_saved": self.bytes_saved,
            "files_removed": self.files_removed,
            "dirs_removed": self.dirs_removed,
            "sos_stripped": self.sos_stripped,
            "whitelisted": sorted(self.whitelisted),
        }


def _norm(pattern: str) -> str:
    return pattern.replace("**", "*")


def _matches(rel: str, patterns: tuple[str, ...]) -> bool:
    return any(fnmatch.fnmatch(rel, _norm(p)) for p in patterns)


def _is_whitelisted(rel: str, keep: tuple[str, ...]) -> bool:
    return _matches(rel, SERVING_WHITELIST) or _matches(rel, keep)


def prune_tree(root: Path, spec: PruneSpec) -> PruneReport:
    """Apply a recipe's prune spec to a bundle site tree, in place."""
    root = Path(root)
    unknown = set(spec.rules) - KNOWN_RULES
    if unknown:
        raise ValueError(f"unknown prune rules: {sorted(unknown)}")

    report = PruneReport()
    report.bytes_before = sum(p.stat().st_size for p in walk_files(root) if p.is_file())

    rule_dirs: set[str] = set()
    file_patterns: list[str] = []
    for rule in spec.rules:
        rule_dirs.update(_RULE_DIRS.get(rule, ()))
        file_patterns.extend(_RULE_FILES.get(rule, ()))
    file_patterns.extend(_norm(p) for p in spec.extra_remove)

    # pass 1: whole directories (bottom-up so nested matches go first)
    for path in sorted(root.rglob("*"), key=lambda p: -len(p.parts)):
        if not path.is_dir():
            continue
        rel = path.relative_to(root).as_posix()
        if _is_whitelisted(rel, spec.keep) or _is_whitelisted(rel + "/", spec.keep):
            continue
        if path.name in rule_dirs or _matches(rel, tuple(file_patterns)):
            # a whitelisted file anywhere below vetoes directory removal
            if any(_is_whitelisted(f.relative_to(root).as_posix(), spec.keep)
                   for f in walk_files(path)):
                report.whitelisted.append(rel)
                continue
            shutil.rmtree(path)
            report.dirs_removed += 1

    # pass 2: individual files
    for path in list(walk_files(root)):
        rel = path.relative_to(root).as_posix()
        if _is_whitelisted(rel, spec.keep):
            continue
        remove = _matches(rel, tuple(file_patterns))
        if not remove and "dist-info-extras" in spec.rules and ".dist-info/" in rel:
            inner = rel.split(".dist-info/", 1)[1]
            remove = not _matches(inner, _DIST_INFO_KEEP)
        if remove:
            path.unlink()
            report.files_removed += 1

    # pass 3: strip non-whitelisted shared objects — guarded: only objects
    # with strippable sections, and a post-strip ELF alignment check with
    # restore, because binutils strip corrupts some auditwheel-processed .so
    # files (see the utils/elf.py module docstring).
    if spec.strip_so and shutil.which("strip"):
        from lambdipy_tpu_torch.utils.elf import is_elf, load_segments_aligned, strippable_sections

        for path in walk_files(root):
            rel = path.relative_to(root).as_posix()
            if path.suffix != ".so" and ".so." not in path.name:
                continue
            if _is_whitelisted(rel, spec.keep):
                report.whitelisted.append(rel)
                continue
            if not is_elf(path) or not strippable_sections(path):
                continue  # pre-stripped (the manylinux norm) — nothing to gain
            original = path.read_bytes()
            proc = subprocess.run(
                ["strip", "--strip-unneeded", str(path)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                log.warning("strip failed on %s: %s", rel, proc.stderr.strip())
                path.write_bytes(original)
                continue
            if not load_segments_aligned(path):
                log.warning("strip broke ELF alignment on %s; restored original", rel)
                path.write_bytes(original)
                continue
            report.sos_stripped += 1

    # pass 4: drop now-empty directories
    for path in sorted(root.rglob("*"), key=lambda p: -len(p.parts)):
        if path.is_dir() and not any(path.iterdir()):
            path.rmdir()

    report.bytes_after = sum(p.stat().st_size for p in walk_files(root) if p.is_file())
    return report
