"""Build orchestration of the port, the twin of
``lambdipy_tpu/buildengine/engine.py``: recipe -> staged site tree ->
prune -> smoke, each stage timed into the bundle's provenance.
"""

from __future__ import annotations

import platform
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

from lambdipy_tpu_torch.buildengine.prune import PruneReport, prune_tree
from lambdipy_tpu_torch.buildengine.sandbox import VenvSandbox, build_wheel, install_wheel
from lambdipy_tpu_torch.buildengine.smoke import SmokeError, import_smoke
from lambdipy_tpu_torch.buildengine.vendor import (
    dependency_closure,
    find_distribution,
    import_names,
    vendor_distribution,
)
from lambdipy_tpu_torch.bundle.baselayer import base_layer_dists, materialize_base_site
from lambdipy_tpu_torch.recipes.schema import Recipe
from lambdipy_tpu_torch.resolve.sources import SourceStore
from lambdipy_tpu_torch.utils.logs import get_logger, log_event
from lambdipy_tpu_torch.utils.timing import StageTimer

log = get_logger("lambdipy.build")


class BuildError(RuntimeError):
    pass


@dataclass
class BuildResult:
    recipe: Recipe
    site_dir: Path
    vendored: list[dict] = field(default_factory=list)
    # root requirements satisfied by the shared base layer (not copied)
    base_provided: list[dict] = field(default_factory=list)
    skipped_optional: list[str] = field(default_factory=list)
    prune: PruneReport | None = None
    smoke_versions: dict[str, str] = field(default_factory=dict)
    timings: dict[str, float] = field(default_factory=dict)

    def provenance(self) -> dict:
        """Build provenance for the bundle manifest."""
        return {
            "recipe": self.recipe.name,
            "recipe_version": self.recipe.version,
            "device": self.recipe.device,
            "python": f"{sys.version_info.major}.{sys.version_info.minor}",
            "platform": platform.platform(),
            "built_at": time.time(),
            "vendored": self.vendored,
            "base_provided": self.base_provided,
            "skipped_optional": self.skipped_optional,
            "prune": self.prune.as_dict() if self.prune else None,
            "smoke_versions": self.smoke_versions,
            "timings": self.timings,
        }


def _smoke_modules(result: BuildResult, recipe: Recipe) -> list[str]:
    mods: list[str] = []
    for rec in result.vendored + result.base_provided:
        mods.extend(rec.get("import_names", []))
    # heavyweight frameworks are smoke-tested at the package level only;
    # their internal extensions come along.
    blocklist = {"pkg_resources", "setuptools", "distutils-precedence"}
    return sorted({m for m in mods if m not in blocklist and not m.endswith(".pth")})


def build_recipe(recipe: Recipe, workdir: Path, *, sources: SourceStore | None = None,
                 run_smoke: bool = True) -> BuildResult:
    """Execute a recipe's build path into ``workdir/site``.

    Stages:
      1. stage: vendor installed dists, or sdist->wheel->unpack
      2. prune: recipe rules + the serving stack's whitelist
      3. smoke: hermetic import of every vendored top-level module
    """
    workdir = Path(workdir)
    site_dir = workdir / "site"
    site_dir.mkdir(parents=True, exist_ok=True)
    result = BuildResult(recipe=recipe, site_dir=site_dir)
    timer = StageTimer()

    with timer.stage("stage"):
        if recipe.build.backend == "sdist":
            sources = sources or SourceStore()
            tree = sources.resolve(recipe.build.source)
            log_event(log, "building sdist", recipe=recipe.name, source=str(tree))
            wheel = build_wheel(tree, workdir / "wheels", env=recipe.build.env_dict())
            rec = install_wheel(wheel, site_dir)
            dist = find_distribution(rec["name"])
            rec["import_names"] = import_names(dist) if dist else [rec["name"].replace("-", "_")]
            result.vendored.append(rec)
        else:
            from packaging.requirements import Requirement as PepReq
            from packaging.utils import canonicalize_name

            base = base_layer_dists(recipe.base_layer)
            roots = [canonicalize_name(PepReq(r).name) for r in recipe.requires]
            closure = dependency_closure(list(recipe.requires))
            missing = [r for r in roots if r not in closure]
            if missing:
                raise BuildError(
                    f"recipe {recipe.name}: required distributions not installed "
                    f"in the local wheel store: {missing}")
            for name in closure:
                if name in base:
                    if name in roots:  # still smoke-tested via the base layer
                        dist = find_distribution(name)
                        result.base_provided.append({
                            "name": name,
                            "version": dist.version if dist else None,
                            "import_names": import_names(dist) if dist else [],
                        })
                    continue  # provided by the shared base layer
                result.vendored.append(vendor_distribution(name, site_dir))
            vendored_names = set(closure)
            for req in recipe.optional_requires:
                name = canonicalize_name(PepReq(req).name)
                opt_closure = dependency_closure([req])
                new_deps = [d for d in opt_closure
                            if d not in base and d not in vendored_names]
                # transactional: vendor only when the root and every new dep
                # are fully copyable, so a partial optional never leaves
                # orphan files or contradictory provenance in the bundle
                copyable = name in opt_closure and all(
                    (dist := find_distribution(d)) is not None and (dist.files or [])
                    for d in new_deps)
                if not copyable:
                    log_event(log, "optional distribution unavailable, skipping",
                              recipe=recipe.name, dist=name)
                    result.skipped_optional.append(name)
                    continue
                for dep in new_deps:
                    result.vendored.append(vendor_distribution(dep, site_dir))
                    vendored_names.add(dep)
        if recipe.build.steps:
            sandbox = VenvSandbox.create(workdir / "venv")
            for step in recipe.build.steps:
                sandbox.run(["bash", "-c", step], cwd=site_dir, env=recipe.build.env_dict())

    with timer.stage("prune"):
        result.prune = prune_tree(site_dir, recipe.prune)

    if run_smoke:
        with timer.stage("smoke"):
            mods = _smoke_modules(result, recipe)
            base_paths = None
            if recipe.base_layer != "none":
                # exactly the declared layer — NOT the whole host site-packages,
                # which would mask missing vendored files
                base_site = materialize_base_site(recipe.base_layer, workdir / "base-site")
                base_paths = [str(base_site)]
            try:
                result.smoke_versions = import_smoke(site_dir, mods, base_paths=base_paths)
            except SmokeError as e:
                raise BuildError(str(e)) from e

    result.timings = timer.report()
    log_event(log, "build complete", recipe=recipe.name,
              bytes=result.prune.bytes_after if result.prune else None,
              saved=result.prune.bytes_saved if result.prune else None,
              timings=result.timings)
    return result
