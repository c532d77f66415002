"""Base layers, the twin of ``lambdipy_tpu/bundle/baselayer.py``: the named
distribution sets the serving host provides, their live versions, the
``sys.path`` layering at serve time, the build smoke's site of exactly
one layer, and the skew check.

A layer's entry may be a glob (``nvidia-*``), matched against the
distributions installed on the host: the ``torch`` layer names torch's
CUDA wheels that way, because their names carry the CUDA major version
(``nvidia-cublas-cu12``) and differ between hosts. Without them a recipe
that requires torch would vendor gigabytes of CUDA libraries, and the
skew check would miss them.

A bundle the JAX builder made names the ``jax-tpu`` layer. On a host
with PyTorch the check reports the layer's distributions the host lacks
(``flax``, ``orbax-checkpoint``, ...) as ``<absent>``: that is the
truth, reported in ``/healthz`` ``skew``, and not an error."""

from __future__ import annotations

import fnmatch
import functools
import importlib.metadata
import re
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
    # JAX's torch layer, plus what torch's CUDA build requires on the
    # card's host: the NVIDIA wheels (cuBLAS, cuDNN, NCCL, the runtime,
    # ...), the cuda-toolkit / cuda-bindings wheels, triton, and the
    # setuptools torch pins
    "torch": ("torch", "numpy", "typing-extensions", "sympy", "networkx",
              "jinja2", "markupsafe", "filelock", "fsspec", "mpmath",
              "nvidia-*", "cuda-*", "triton", "setuptools"),
}


def _canonical(name: str) -> str:
    """PEP 503's normal form, as ``packaging.utils.canonicalize_name``."""
    return re.sub(r"[-_.]+", "-", name).lower()


@functools.lru_cache(maxsize=1)
def _installed() -> frozenset[str]:
    """The host's distributions (read once: a scan of every dist-info)."""
    return frozenset({_canonical(d.metadata["Name"] or "")
                      for d in importlib.metadata.distributions()} - {""})


def base_layer_dists(name: str) -> set[str]:
    """The layer's distribution names, its globs expanded against the
    distributions installed here."""
    try:
        entries = BASE_LAYERS[name]
    except KeyError:
        raise KeyError(f"unknown base layer {name!r}; known: "
                       f"{sorted(BASE_LAYERS)}") from None
    plain = {e for e in entries if not any(c in e for c in "*?[")}
    globs = [e for e in entries if e not in plain]
    if globs:
        plain |= {d for d in _installed()
                  if any(fnmatch.fnmatch(d, g) for g in globs)}
    return plain


def base_layer_versions(name: str) -> dict[str, str]:
    """Installed version of each of the layer's distributions present."""
    out = {}
    for dist in sorted(base_layer_dists(name)):
        try:
            out[dist] = importlib.metadata.version(dist)
        except importlib.metadata.PackageNotFoundError:
            pass
    return out


def host_site_packages() -> list[str]:
    """The host's site-packages directories (the physical base layer)."""
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
        path.extend(host_site_packages())
    return path


def materialize_base_site(layer: str, dest: Path) -> Path:
    """A site directory holding exactly the layer, as symlinks into the
    host's: the build smoke imports against the declared layer, not the
    whole host site-packages (which would mask missing vendored files)."""
    dest = Path(dest)
    dest.mkdir(parents=True, exist_ok=True)
    for dist_name in sorted(base_layer_dists(layer)):
        try:
            dist = importlib.metadata.distribution(dist_name)
        except importlib.metadata.PackageNotFoundError:
            continue
        tops: set[str] = set()
        for f in dist.files or []:
            first = Path(str(f)).parts[0] if Path(str(f)).parts else ""
            if first and first != "..":
                tops.add(first)
        for top in sorted(tops):
            src = Path(dist.locate_file(top))
            link = dest / top
            if src.exists() and not link.exists():
                link.symlink_to(src)
    return dest


def check_skew(manifest_versions: dict[str, str],
               layer: str) -> dict[str, tuple[str, str]]:
    """{dist: (built against, live)} for every recorded version the host
    does not have, ``<absent>`` where the distribution is missing."""
    live = base_layer_versions(layer)
    return {dist: (want, live.get(dist, "<absent>"))
            for dist, want in manifest_versions.items()
            if live.get(dist) != want}
