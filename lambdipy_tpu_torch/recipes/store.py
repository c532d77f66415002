"""Recipe store of the port, the twin of ``lambdipy_tpu/recipes/store.py``:
discovery and lookup of recipe documents. The builtin recipes are the
port's twins of JAX's, TOML files in ``lambdipy_tpu_torch/recipes/builtin/``;
further directories (a project's ``recipes/``) layer on top.
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path

from lambdipy_tpu_torch.recipes.schema import Recipe, RecipeError, load_recipe_file

BUILTIN_DIR = Path(__file__).parent / "builtin"


class RecipeStore:
    def __init__(self, dirs: list[Path]):
        self._dirs = [Path(d) for d in dirs]
        self._recipes: dict[str, Recipe] = {}
        for d in self._dirs:
            if not d.is_dir():
                continue
            for path in sorted(d.glob("*.toml")):
                recipe = load_recipe_file(path)
                # later dirs override earlier ones (project overrides builtin)
                self._recipes[recipe.name] = recipe

    def names(self) -> list[str]:
        return sorted(self._recipes)

    def get(self, name: str) -> Recipe:
        try:
            return self._recipes[name]
        except KeyError:
            raise RecipeError(
                f"no recipe named {name!r}; available: {', '.join(self.names())}"
            ) from None

    def __contains__(self, name: str) -> bool:
        return name in self._recipes

    def covering(self, package: str) -> Recipe | None:
        """Recipe covering a plain pip package name, if any (used by the
        resolver to split recipe-covered vs plain deps)."""
        from packaging.utils import canonicalize_name

        return self._recipes.get(canonicalize_name(package))


@lru_cache(maxsize=None)
def builtin_store(extra_dir: str | None = None) -> RecipeStore:
    dirs = [BUILTIN_DIR]
    if extra_dir:
        dirs.append(Path(extra_dir))
    return RecipeStore(dirs)
