"""Base layers, the parts of ``lambdipy_tpu/bundle/baselayer.py`` that boot
reads: the named distribution sets, the live versions, the ``sys.path``
layering and the skew check.

A bundle the JAX builder made names the ``jax-tpu`` layer. On a host
with PyTorch the check reports the layer's distributions the host lacks
(``flax``, ``orbax-checkpoint``, ...) as ``<absent>``: that is the
truth, reported in ``/healthz`` ``skew``, and not an error."""

from __future__ import annotations

import importlib.metadata
import site
from pathlib import Path

# Distribution sets per layer; the versions are recorded at build time
BASE_LAYERS: dict[str, tuple[str, ...]] = {
    "none": (),
    "jax-tpu": (
        "jax", "jaxlib", "libtpu", "numpy", "ml-dtypes", "opt-einsum", "scipy",
        "flax", "optax", "chex", "orbax-checkpoint", "msgpack", "einops",
        "absl-py", "etils", "typing-extensions", "rich", "pyyaml",
        "tensorstore", "protobuf", "treescope", "humanize", "fsspec",
        "importlib-resources", "zipp", "nest-asyncio", "simplejson", "toolz",
        "markdown-it-py", "mdurl", "pygments", "setuptools", "wheel",
        "aiofiles", "ordered-set",
    ),
    "sci-cpu": ("numpy", "scipy", "scikit-learn", "joblib", "threadpoolctl"),
    "torch": ("torch", "numpy", "typing-extensions", "sympy", "networkx",
              "jinja2", "markupsafe", "filelock", "fsspec", "mpmath"),
}


def base_layer_versions(name: str) -> dict[str, str]:
    """Installed version of each of the layer's distributions present."""
    try:
        dists = BASE_LAYERS[name]
    except KeyError:
        raise KeyError(f"unknown base layer {name!r}; known: "
                       f"{sorted(BASE_LAYERS)}") from None
    out = {}
    for dist in dists:
        try:
            out[dist] = importlib.metadata.version(dist)
        except importlib.metadata.PackageNotFoundError:
            pass
    return out


def _host_site_packages() -> list[str]:
    paths = list(site.getsitepackages()) \
        if hasattr(site, "getsitepackages") else []
    if not paths:
        import numpy

        paths = [str(Path(numpy.__file__).parent.parent)]
    return [p for p in paths if Path(p).is_dir()]


def runtime_sys_path(bundle_site: Path, base_layer: str) -> list[str]:
    """``sys.path`` layering at serve time: the bundle's ``site/`` first,
    then the base layer (the host's site-packages)."""
    path = [str(bundle_site)]
    if base_layer != "none":
        path.extend(_host_site_packages())
    return path


def check_skew(manifest_versions: dict[str, str],
               layer: str) -> dict[str, tuple[str, str]]:
    """{dist: (built against, live)} for every recorded version the host
    does not have, ``<absent>`` where the distribution is missing."""
    live = base_layer_versions(layer)
    return {dist: (want, live.get(dist, "<absent>"))
            for dist, want in manifest_versions.items()
            if live.get(dist) != want}
