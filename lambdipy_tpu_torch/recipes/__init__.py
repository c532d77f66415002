"""Recipes of the port: per-package build recipes with device variants,
the twin of ``lambdipy_tpu/recipes/``. A recipe is a validated TOML file
under ``lambdipy_tpu_torch/recipes/builtin/``; model recipes also declare
a payload (model, params, handler).
"""

from lambdipy_tpu_torch.recipes.schema import (
    BuildSpec,
    PayloadSpec,
    PruneSpec,
    Recipe,
    RecipeError,
    load_recipe_file,
    load_recipe_dict,
)
from lambdipy_tpu_torch.recipes.store import RecipeStore, builtin_store

__all__ = [
    "BuildSpec",
    "PayloadSpec",
    "PruneSpec",
    "Recipe",
    "RecipeError",
    "RecipeStore",
    "builtin_store",
    "load_recipe_file",
    "load_recipe_dict",
]
