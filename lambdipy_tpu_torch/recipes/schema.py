"""Recipe schema of the port, the twin of ``lambdipy_tpu/recipes/schema.py``:
the same documents, fields and checks, so any JAX recipe file loads here
unchanged, to the same :class:`Recipe` and the same ``artifact_id``. The
one difference: ``device`` also takes the card, ``gpu-h100-1``.

A recipe is a versioned TOML document that declares

- what to install (``requires``: pip requirements, resolved against the
  host's installed distributions — there is no network),
- how to build (``[build]``: ``vendor`` copies installed distributions,
  ``sdist`` builds a wheel from a local source archive),
- how to shrink it (``[prune]``: rule names, extra patterns, and the
  serving stack's whitelist, which is always enforced),
- the optional model payload (``[payload]``: model family, params,
  handler entrypoint, sharding),
- the target device (``device``: any | cpu | gpu-h100-1 | the JAX
  package's TPU variants).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path

from lambdipy_tpu_torch.utils.toml_compat import tomllib

SCHEMA_VERSION = 1

_NAME_RE = re.compile(r"^[a-z0-9][a-z0-9._-]*$")
# JAX's five devices and the card
_DEVICES = {"any", "cpu", "tpu-v5e-1", "tpu-v5e-4", "tpu-v5e-8", "gpu-h100-1"}
_BACKENDS = {"vendor", "sdist"}


class RecipeError(ValueError):
    """Raised for malformed or invalid recipe documents."""


@dataclass(frozen=True)
class BuildSpec:
    backend: str = "vendor"  # vendor | sdist
    source: str | None = None  # sdist: path/URL of the source archive
    steps: tuple[str, ...] = ()  # extra shell steps inside the sandbox
    env: tuple[tuple[str, str], ...] = ()

    def env_dict(self) -> dict[str, str]:
        return dict(self.env)


@dataclass(frozen=True)
class PruneSpec:
    rules: tuple[str, ...] = ("tests", "pycache", "dist-info-extras", "docs")
    extra_remove: tuple[str, ...] = ()  # extra glob patterns to delete
    keep: tuple[str, ...] = ()  # glob patterns exempt from all rules
    strip_so: bool = True  # run `strip --strip-unneeded` on non-whitelisted .so


@dataclass(frozen=True)
class PayloadSpec:
    """Model payload carried by model recipes (BASELINE.json configs
    1-5)."""

    model: str  # registered model family, e.g. "resnet50"
    handler: str  # dotted path "module:function" building the handler
    params: str = "init"  # "init" (random init at build time) | checkpoint path
    dtype: str = "bfloat16"
    batch_size: int = 1
    mesh: tuple[tuple[str, int], ...] = ()  # e.g. (("dp",1),("tp",4))
    quant: str | None = None  # e.g. "int8" for Llama config 5
    extra: tuple[tuple[str, str], ...] = ()
    # which checkpoint formats the bundle ships: "both" (orbax canonical +
    # params.fpk boot accelerator), "fpk" (flat file only — big payloads
    # must not double their dominant bytes; an 8B int8 bundle is 8 GB per
    # copy), or "orbax"
    params_format: str = "both"

    def mesh_dict(self) -> dict[str, int]:
        return dict(self.mesh)


@dataclass(frozen=True)
class Recipe:
    name: str
    version: str  # payload/package version this recipe builds
    schema: int = SCHEMA_VERSION
    description: str = ""
    python: tuple[str, ...] = ("3.12",)
    device: str = "any"
    requires: tuple[str, ...] = ()
    # Requirements that are vendored when available locally but skipped (with a
    # warning) when not — e.g. xgboost in the tabular recipe, torch-xla in the
    # BERT recipe.
    optional_requires: tuple[str, ...] = ()
    # Shared base layer the serving host provides (bundle/baselayer.py): a
    # bundle carries only its delta over it, as a Lambda function carries
    # its delta over its layers. "none" = fully self-contained bundle.
    base_layer: str = "none"
    build: BuildSpec = field(default_factory=BuildSpec)
    prune: PruneSpec = field(default_factory=PruneSpec)
    payload: PayloadSpec | None = None

    @property
    def is_model(self) -> bool:
        return self.payload is not None

    def artifact_id(self, python: str) -> str:
        """Artifact key, after the release-asset naming
        ``<pkg>-<ver>-python<N>``, with the device."""
        return f"{self.name}-{self.version}-py{python.replace('.', '')}-{self.device}"


def _expect(cond: bool, msg: str) -> None:
    if not cond:
        raise RecipeError(msg)


def _tuple_of_str(value, what: str) -> tuple[str, ...]:
    _expect(isinstance(value, list) and all(isinstance(x, str) for x in value),
            f"{what} must be a list of strings, got {value!r}")
    return tuple(value)


def load_recipe_dict(doc: dict, *, origin: str = "<dict>") -> Recipe:
    _expect(isinstance(doc, dict), f"{origin}: recipe document must be a table")
    unknown = set(doc) - {"schema", "name", "version", "description", "python",
                          "device", "requires", "optional_requires", "base_layer",
                          "build", "prune", "payload"}
    _expect(not unknown, f"{origin}: unknown recipe keys {sorted(unknown)}")

    schema = doc.get("schema", SCHEMA_VERSION)
    _expect(schema == SCHEMA_VERSION, f"{origin}: unsupported schema version {schema}")

    name = doc.get("name")
    _expect(isinstance(name, str) and _NAME_RE.match(name or ""),
            f"{origin}: invalid recipe name {name!r}")
    version = doc.get("version")
    _expect(isinstance(version, str) and version,
            f"{origin}: recipe {name}: version is required")

    device = doc.get("device", "any")
    _expect(device in _DEVICES, f"{origin}: recipe {name}: unknown device {device!r}")

    python = _tuple_of_str(doc.get("python", ["3.12"]), f"recipe {name}: python")
    requires = _tuple_of_str(doc.get("requires", []), f"recipe {name}: requires")
    optional_requires = _tuple_of_str(
        doc.get("optional_requires", []), f"recipe {name}: optional_requires")
    base_layer = doc.get("base_layer", "none")
    _expect(isinstance(base_layer, str), f"{origin}: recipe {name}: base_layer must be a string")

    bdoc = doc.get("build", {})
    _expect(isinstance(bdoc, dict), f"{origin}: recipe {name}: [build] must be a table")
    backend = bdoc.get("backend", "vendor")
    _expect(backend in _BACKENDS, f"{origin}: recipe {name}: unknown build backend {backend!r}")
    source = bdoc.get("source")
    _expect(source is None or isinstance(source, str),
            f"{origin}: recipe {name}: build.source must be a string")
    if backend == "sdist":
        _expect(source is not None, f"{origin}: recipe {name}: sdist build needs build.source")
    build = BuildSpec(
        backend=backend,
        source=source,
        steps=_tuple_of_str(bdoc.get("steps", []), f"recipe {name}: build.steps"),
        env=tuple(sorted((str(k), str(v)) for k, v in bdoc.get("env", {}).items())),
    )

    pdoc = doc.get("prune", {})
    _expect(isinstance(pdoc, dict), f"{origin}: recipe {name}: [prune] must be a table")
    prune = PruneSpec(
        rules=_tuple_of_str(pdoc.get("rules", ["tests", "pycache", "dist-info-extras", "docs"]),
                            f"recipe {name}: prune.rules"),
        extra_remove=_tuple_of_str(pdoc.get("extra_remove", []), f"recipe {name}: prune.extra_remove"),
        keep=_tuple_of_str(pdoc.get("keep", []), f"recipe {name}: prune.keep"),
        strip_so=bool(pdoc.get("strip_so", True)),
    )

    payload = None
    ydoc = doc.get("payload")
    if ydoc is not None:
        _expect(isinstance(ydoc, dict), f"{origin}: recipe {name}: [payload] must be a table")
        model = ydoc.get("model")
        _expect(isinstance(model, str) and model, f"{origin}: recipe {name}: payload.model required")
        handler = ydoc.get("handler")
        _expect(isinstance(handler, str) and ":" in (handler or ""),
                f"{origin}: recipe {name}: payload.handler must be 'module:attr'")
        mesh_doc = ydoc.get("mesh", {})
        _expect(isinstance(mesh_doc, dict) and all(isinstance(v, int) and v >= 1 for v in mesh_doc.values()),
                f"{origin}: recipe {name}: payload.mesh must map axis name -> positive int")
        params_format = str(ydoc.get("params_format", "both"))
        _expect(params_format in ("both", "fpk", "orbax"),
                f"{origin}: recipe {name}: payload.params_format must be "
                f"'both', 'fpk' or 'orbax', got {params_format!r}")
        payload = PayloadSpec(
            model=model,
            handler=handler,
            params=str(ydoc.get("params", "init")),
            dtype=str(ydoc.get("dtype", "bfloat16")),
            batch_size=int(ydoc.get("batch_size", 1)),
            mesh=tuple(mesh_doc.items()),
            quant=ydoc.get("quant"),
            extra=tuple(sorted((str(k), str(v)) for k, v in ydoc.get("extra", {}).items())),
            params_format=params_format,
        )

    return Recipe(
        name=name,
        version=version,
        schema=schema,
        description=str(doc.get("description", "")),
        python=python,
        device=device,
        requires=requires,
        optional_requires=optional_requires,
        base_layer=base_layer,
        build=build,
        prune=prune,
        payload=payload,
    )


def load_recipe_file(path: Path) -> Recipe:
    path = Path(path)
    try:
        doc = tomllib.loads(path.read_text())
    except tomllib.TOMLDecodeError as e:
        raise RecipeError(f"{path}: invalid TOML: {e}") from e
    return load_recipe_dict(doc, origin=str(path))
