"""Project resolution of the port, the twin of
``lambdipy_tpu/resolve/requirements.py``: requirements.txt, Pipfile,
Pipfile.lock and pyproject ``[project] dependencies`` parsed with
:mod:`packaging`, pinned against the host's installed distributions (the
offline stand-in for an index), and split into recipe-covered and plain
dependencies.
"""

from __future__ import annotations

import importlib.metadata
import json
from dataclasses import dataclass
from pathlib import Path

from packaging.requirements import InvalidRequirement
from packaging.requirements import Requirement as _PepRequirement
from packaging.utils import canonicalize_name
from packaging.version import Version

from lambdipy_tpu_torch.recipes.store import RecipeStore
from lambdipy_tpu_torch.utils.toml_compat import tomllib


class ResolutionError(ValueError):
    """Raised when a requirement cannot be parsed or satisfied locally."""


@dataclass(frozen=True)
class Requirement:
    """A parsed requirement, optionally pinned to a locally available version."""

    name: str  # canonical (lowercase, dash) name
    raw: str  # original line
    specifier: str  # e.g. "==2.0.2", may be ""
    pinned: str | None = None  # resolved exact version
    # environment marker evaluated once at parse time against the running
    # interpreter; False = dep is for another platform and should be dropped
    applies: bool = True

    @property
    def pin(self) -> str:
        if self.pinned is None:
            raise ResolutionError(f"requirement {self.raw!r} is not pinned")
        return f"{self.name}=={self.pinned}"


def parse_requirement(line: str) -> Requirement:
    try:
        pep = _PepRequirement(line)
    except InvalidRequirement as e:
        raise ResolutionError(f"invalid requirement {line!r}: {e}") from e
    return Requirement(
        name=canonicalize_name(pep.name),
        raw=line,
        specifier=str(pep.specifier),
        applies=pep.marker is None or pep.marker.evaluate(),
    )


def parse_requirements_text(text: str) -> list[Requirement]:
    """Parse requirements.txt content: one requirement per line, ``#``
    comments and blank lines skipped, pip option lines (-r/-e/--hash...)
    rejected explicitly rather than misparsed."""
    out: list[Requirement] = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        if line.startswith("-"):
            raise ResolutionError(
                f"line {lineno}: pip option lines ({line.split()[0]}) are not supported"
            )
        out.append(parse_requirement(line))
    return out


def _pipfile_entry(name: str, spec) -> Requirement:
    """One ``[packages]`` entry: ``"*"``, a specifier string, or an inline
    table (``{version = "...", extras = [...]}``). VCS/path/editable entries
    have no offline equivalent and are rejected explicitly."""
    if isinstance(spec, str):
        version = "" if spec == "*" else spec
        return parse_requirement(f"{name}{version}")
    if isinstance(spec, dict):
        unsupported = {"git", "path", "file", "editable"} & set(spec)
        if unsupported:
            raise ResolutionError(
                f"Pipfile entry {name!r}: {sorted(unsupported)} sources are "
                "not supported (offline resolver)")
        extras = spec.get("extras") or []
        extras_s = f"[{','.join(extras)}]" if extras else ""
        version = spec.get("version", "*")
        version = "" if version == "*" else version
        markers = spec.get("markers")
        line = f"{name}{extras_s}{version}"
        if markers:
            line += f"; {markers}"
        return parse_requirement(line)
    raise ResolutionError(f"Pipfile entry {name!r}: unsupported value {spec!r}")


def parse_pipfile_text(text: str, *, dev: bool = False) -> list[Requirement]:
    """Parse Pipfile content (``[packages]`` + optionally ``[dev-packages]``)."""
    try:
        doc = tomllib.loads(text)
    except tomllib.TOMLDecodeError as e:
        raise ResolutionError(f"invalid Pipfile: {e}") from e
    sections = ["packages"] + (["dev-packages"] if dev else [])
    out: list[Requirement] = []
    for section in sections:
        for name, spec in (doc.get(section) or {}).items():
            out.append(_pipfile_entry(name, spec))
    return out


def parse_pipfile_lock_text(text: str, *, dev: bool = False) -> list[Requirement]:
    """Parse Pipfile.lock content: exact ``==`` pins from ``default`` (and
    ``develop`` when ``dev``), which is what the reference resolves against
    when a lockfile exists."""
    try:
        doc = json.loads(text)
    except json.JSONDecodeError as e:
        raise ResolutionError(f"invalid Pipfile.lock: {e}") from e
    sections = ["default"] + (["develop"] if dev else [])
    out: list[Requirement] = []
    for section in sections:
        for name, spec in (doc.get(section) or {}).items():
            if not isinstance(spec, dict) or "version" not in spec:
                raise ResolutionError(
                    f"Pipfile.lock entry {name!r}: missing pinned version")
            line = f"{name}{spec['version']}"
            if spec.get("markers"):  # other-platform pins must not abort resolution
                line += f"; {spec['markers']}"
            out.append(parse_requirement(line))
    return out


def parse_pyproject_text(text: str) -> list[Requirement]:
    """Parse ``[project] dependencies`` from pyproject.toml content."""
    try:
        doc = tomllib.loads(text)
    except tomllib.TOMLDecodeError as e:
        raise ResolutionError(f"invalid pyproject.toml: {e}") from e
    deps = (doc.get("project") or {}).get("dependencies", [])
    if not isinstance(deps, list):
        raise ResolutionError("pyproject.toml: [project] dependencies must be a list")
    return [parse_requirement(d) for d in deps]


def parse_project_file(path: Path) -> list[Requirement]:
    """Dispatch on the manifest file name, like the reference's resolver
    choosing between requirements.txt and Pipfile(.lock)."""
    path = Path(path)
    text = path.read_text()
    if path.name == "Pipfile.lock":
        return parse_pipfile_lock_text(text)
    if path.name == "Pipfile":
        return parse_pipfile_text(text)
    if path.name == "pyproject.toml":
        return parse_pyproject_text(text)
    return parse_requirements_text(text)


def installed_version(name: str) -> str | None:
    try:
        return importlib.metadata.version(name)
    except importlib.metadata.PackageNotFoundError:
        return None


def pin_against_local(req: Requirement) -> Requirement:
    """Pin a requirement against the locally installed distribution set.

    This is the offline resolver: the local env *is* the wheel store. A
    version conflict (installed version outside the specifier) is an error,
    matching the reference's behavior when no release asset matches.
    """
    version = installed_version(req.name)
    if version is None:
        raise ResolutionError(
            f"requirement {req.raw!r}: distribution {req.name!r} is not available "
            "in the local wheel store (offline environment)"
        )
    pep = _PepRequirement(req.raw)
    if req.specifier and not pep.specifier.contains(Version(version), prereleases=True):
        raise ResolutionError(
            f"requirement {req.raw!r} cannot be satisfied: local store has "
            f"{req.name}=={version}"
        )
    return Requirement(name=req.name, raw=req.raw, specifier=req.specifier,
                       pinned=version, applies=req.applies)


@dataclass(frozen=True)
class ProjectResolution:
    """Result of resolving a project: recipe-covered deps build via recipes,
    plain deps are vendored directly at package time."""

    recipe_covered: tuple[tuple[Requirement, str], ...]  # (req, recipe name)
    plain: tuple[Requirement, ...]


def split_by_recipes(reqs: list[Requirement], store: RecipeStore) -> ProjectResolution:
    covered: list[tuple[Requirement, str]] = []
    plain: list[Requirement] = []
    for req in reqs:
        recipe = store.covering(req.name)
        if recipe is not None:
            covered.append((req, recipe.name))
        else:
            plain.append(req)
    return ProjectResolution(recipe_covered=tuple(covered), plain=tuple(plain))


def resolve_project(requirements_path: Path, store: RecipeStore) -> ProjectResolution:
    reqs = [r for r in parse_project_file(Path(requirements_path)) if r.applies]
    pinned = [pin_against_local(r) for r in reqs]
    return split_by_recipes(pinned, store)
