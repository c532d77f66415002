"""Build engine of the port, the twin of ``lambdipy_tpu/buildengine/``:
recipe -> staged site tree -> prune -> smoke.

- ``vendor`` backend: copy installed distributions out of the host via
  their RECORD file lists (the offline ``pip install``);
- ``sdist`` backend: build a wheel from a local source tree (``python -m
  build --no-isolation``) and unpack it;
- the prune pass, with the serving stack's whitelist
  (:data:`~lambdipy_tpu_torch.buildengine.prune.SERVING_WHITELIST`: torch's
  CUDA libraries, the NVIDIA wheels, triton) that no rule removes or
  strips;
- the import smoke in a fresh interpreter (``-I -S``).
"""

from lambdipy_tpu_torch.buildengine.engine import BuildError, BuildResult, build_recipe
from lambdipy_tpu_torch.buildengine.prune import PruneReport, prune_tree, SERVING_WHITELIST
from lambdipy_tpu_torch.buildengine.vendor import import_names, vendor_distribution
from lambdipy_tpu_torch.buildengine.smoke import import_smoke

__all__ = [
    "BuildError",
    "BuildResult",
    "build_recipe",
    "PruneReport",
    "prune_tree",
    "SERVING_WHITELIST",
    "import_names",
    "vendor_distribution",
    "import_smoke",
]
