"""Project resolution and the artifact, release and source stores of the
port: the twin of ``lambdipy_tpu/resolve/``. A project's requirements
(requirements.txt, Pipfile, Pipfile.lock, pyproject) resolve against the
host's installed distributions and split into recipe-covered and plain
dependencies; built bundles live in a local artifact registry, prebuilt
ones in a release store, and sdist sources in a local source archive. The
port's stores default under ``~/.lambdipy-tpu-torch/``, so the two
packages never read each other's artifacts by accident."""

from lambdipy_tpu_torch.resolve.requirements import (
    Requirement,
    ResolutionError,
    parse_requirement,
    parse_requirements_text,
    resolve_project,
    split_by_recipes,
)
from lambdipy_tpu_torch.resolve.registry import ArtifactRegistry
from lambdipy_tpu_torch.resolve.releases import ReleaseFetcher, ReleaseStore
from lambdipy_tpu_torch.resolve.sources import SourceStore

__all__ = [
    "ArtifactRegistry",
    "ReleaseFetcher",
    "ReleaseStore",
    "Requirement",
    "ResolutionError",
    "SourceStore",
    "parse_requirement",
    "parse_requirements_text",
    "resolve_project",
    "split_by_recipes",
]
