"""Bundle assembly of the port, the twin of ``lambdipy_tpu/bundle/package.py``:
build result + payload -> a deployable bundle directory.

The payload is JAX's: ``handler.py`` in the JAX builder's template text
(naming the recipe's handler, the port's for the builtin twins), the
params, and a tokenizer named by the recipe copied in. The port's loader
runs such a ``handler.py`` as JAX's does, and reads the JAX builder's own
with ``ast`` (``runtime/loader.py``). Params differ by design:

- ``params = "init"``: seeded random weights made by the port
  (``models/registry.py save_init_params``) into ``params.fpk`` (the
  flax families), ``model.pt`` (the torch BERT) or ``model.joblib``
  (tabular); made on the card when the recipe's device is the card
  (never on the CPU: :func:`build_device`), the device recorded as
  ``init_device``;
- ``params_format``: ``"both"`` writes ``params.fpk`` alone and records
  ``"fpk"`` (the card's host has no orbax); ``"orbax"`` raises;
- ``params = "hf"`` raises: ``models/convert.py`` is not ported yet;
- a checkpoint path (a params directory holding ``params.fpk``, or a
  ``.fpk`` file) is hardlinked into the bundle, copied across
  filesystems, as in JAX.
"""

from __future__ import annotations

import os
import shutil
import sys
from pathlib import Path
from typing import TYPE_CHECKING

if TYPE_CHECKING:  # buildengine.engine imports bundle.baselayer
    from lambdipy_tpu_torch.buildengine.engine import BuildResult

from lambdipy_tpu_torch.buildengine.vendor import vendor_distribution
from lambdipy_tpu_torch.bundle.baselayer import base_layer_versions
from lambdipy_tpu_torch.bundle.format import write_manifest
from lambdipy_tpu_torch.recipes.schema import Recipe
from lambdipy_tpu_torch.utils.fsutil import copy_tree
from lambdipy_tpu_torch.utils.logs import get_logger, log_event

log = get_logger("lambdipy.package")

# the JAX builder's template (lambdipy_tpu/bundle/package.py:29-48), text
# for text
HANDLER_TEMPLATE = '''\
"""Generated bundle entrypoint ({recipe}).

The serve runtime imports this module with the bundle site tree and base
layer on sys.path, calls ``init(ctx)`` once at boot (cold start), then
``invoke(state, request)`` per request.
"""

from {module} import {attr} as _build_handler

_SPEC = {spec!r}


def init(ctx):
    return _build_handler(_SPEC, ctx)


def invoke(state, request):
    return state.invoke(request)
'''


def build_device(recipe: Recipe) -> str | None:
    """Where the build makes a recipe's weights and warms its bundle: the
    card (None: :func:`~lambdipy_tpu_torch.utils.platform.resolve_device`
    picks it, and raises without one) for a recipe whose device is the
    card; the CPU for every other recipe, as JAX keeps ``cpu`` / ``any``
    recipes off the TPU. The card's and the CPU's generators draw other
    values from one seed, and an artifact id names no init device, so a
    card recipe's weights are never drawn on the CPU:
    ``LAMBDIPY_PLATFORM=cpu`` raises for one."""
    if not recipe.device.startswith("gpu"):
        return "cpu"
    if os.environ.get("LAMBDIPY_PLATFORM") == "cpu":
        raise ValueError(
            f"recipe {recipe.name} ({recipe.device}): its seeded weights are "
            "drawn on the card, and the CPU would draw others under the same "
            "artifact id; build it on the card (LAMBDIPY_PLATFORM=cpu is "
            "set)")
    return None


def _link_or_copy(src, dst) -> None:
    try:
        os.link(src, dst)
    except OSError:
        shutil.copy2(src, dst)


def materialize_payload(recipe: Recipe, bundle_dir: Path) -> dict:
    """Write the model payload into the bundle: ``handler.py`` and the
    params (see the module docstring); returns the manifest's payload."""
    payload = recipe.payload
    assert payload is not None
    module, attr = payload.handler.split(":", 1)
    spec = {
        "recipe": recipe.name,
        "model": payload.model,
        "params": payload.params,
        "dtype": payload.dtype,
        "batch_size": payload.batch_size,
        "mesh": payload.mesh_dict(),
        "quant": payload.quant,
        "extra": dict(payload.extra),
        "device": recipe.device,
    }
    # a tokenizer named by the recipe is copied into the bundle and the
    # spec rewritten bundle-relative before it is baked into handler.py
    tok_path = spec["extra"].get("tokenizer_path")
    if tok_path:
        src = Path(tok_path)
        if not src.is_dir():
            raise ValueError(f"recipe {recipe.name}: tokenizer_path "
                             f"{tok_path!r} is not a directory")
        copy_tree(src, Path(bundle_dir) / "tokenizer")
        spec["extra"]["tokenizer_path"] = "tokenizer"
    (Path(bundle_dir) / "handler.py").write_text(HANDLER_TEMPLATE.format(
        recipe=recipe.name, module=module, attr=attr, spec=spec))

    manifest_payload = dict(spec)
    params_dir = Path(bundle_dir) / "params"
    if payload.params == "init" and payload.model not in ("hello",):
        from lambdipy_tpu_torch.models import registry as model_registry

        info = model_registry.save_init_params(
            payload.model, params_dir, dtype=payload.dtype,
            quant=payload.quant, extra=dict(payload.extra),
            params_format=payload.params_format,
            device=build_device(recipe))
        manifest_payload["params"] = "params"
        manifest_payload["params_info"] = info
    elif payload.params == "hf":
        raise NotImplementedError(
            f"recipe {recipe.name}: params = 'hf' (a HuggingFace checkpoint "
            "converted at build) is not ported yet: models/convert.py "
            "(ROADMAP.md queue 1, other models)")
    elif payload.params not in ("init", "none", ""):
        # a checkpoint path: a params dir holding params.fpk, or a bare
        # .fpk file; hardlinked when source and bundle share a filesystem
        # (an 8B params.fpk is ~8 GB; bundles never mutate params)
        src = Path(payload.params)
        if src.is_file() and src.suffix == ".fpk":
            params_dir.mkdir(parents=True, exist_ok=True)
            _link_or_copy(src, params_dir / "params.fpk")
        elif src.is_dir() and (src / "params.fpk").is_file():
            shutil.copytree(src, params_dir, copy_function=_link_or_copy)
        elif src.is_dir() and (src / "orbax").is_dir():
            # validated here: the boot would fail on it
            raise ValueError(
                f"recipe {recipe.name}: payload.params {payload.params!r} "
                "holds only an orbax/ checkpoint; the port reads "
                "params.fpk")
        else:
            raise ValueError(
                f"recipe {recipe.name}: payload.params {payload.params!r} "
                "is neither 'init'/'hf', a params dir (params.fpk inside), "
                "nor a .fpk file")
        manifest_payload["params"] = "params"
        manifest_payload["params_info"] = {"format": "external",
                                           "source": str(src)}
    return manifest_payload


def assemble_bundle(result: "BuildResult", out_dir: Path, *,
                    plain_deps: list[str] | None = None,
                    with_payload: bool = True) -> dict:
    """Assemble the bundle tree and write its manifest; returns the
    manifest. ``plain_deps``: distributions no recipe covers, vendored
    straight into ``site/``."""
    recipe = result.recipe
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    site_dst = out_dir / "site"
    if result.site_dir.resolve() != site_dst.resolve():
        copy_tree(result.site_dir, site_dst)
    for dep in plain_deps or []:
        result.vendored.append(vendor_distribution(dep, site_dst))

    manifest_payload = None
    if with_payload and recipe.is_model:
        manifest_payload = materialize_payload(recipe, out_dir)

    manifest = write_manifest(
        out_dir,
        artifact_id=recipe.artifact_id(
            f"{sys.version_info.major}.{sys.version_info.minor}"),
        provenance=result.provenance(),
        base_layer={"name": recipe.base_layer,
                    "versions": base_layer_versions(recipe.base_layer)},
        payload=manifest_payload,
        runtime={"entry": "handler.py"} if recipe.is_model else {},
    )
    log_event(log, "bundle assembled", recipe=recipe.name, out=str(out_dir),
              files=len(manifest["files"]))
    return manifest
