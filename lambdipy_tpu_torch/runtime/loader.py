"""Bundle boot of the port, the twin of ``lambdipy_tpu/runtime/loader.py``:
manifest -> handler state, warmed, every stage timed (JAX's stages in
JAX's order):

1. ``manifest``: read the manifest, check the base layer's skew (a
   JAX-built bundle names ``jax-tpu``; what of it the host lacks, e.g.
   ``flax`` and ``orbax-checkpoint`` on a PyTorch host, reads
   ``<absent>``: reported, not an error);
2. ``syspath``: the bundle's ``site/`` first, then the base layer;
3. ``compile_cache``: build or load the port's kernel libraries
   (``ops/_build.py``; on the CPU nothing), so the first invoke never
   waits on ``nvcc``; and the numerics switch (``utils/debug.py``);
4. ``handler_import``: read ``handler.py``. The JAX builder's template
   imports ``lambdipy_tpu.runtime.handlers:<attr>``, which would import
   the JAX package: the port reads that file with ``ast`` instead of
   running it, takes ``_SPEC`` with ``ast.literal_eval`` and maps the
   handler to the port's ``lambdipy_tpu_torch.runtime.handlers:<attr>``.
   Only ``generate_handler`` is ported; another raises at ``init``. A
   ``handler.py`` that imports nothing of ``lambdipy_tpu`` is a user's own
   and runs as JAX runs it;
5. ``init``: ``init(ctx)`` with a :class:`HandlerContext` naming the
   bundle, its manifest, its params directory, the payload spec and the
   device;
6. ``warmup``: one ``{"warmup": true}`` invoke.
"""

from __future__ import annotations

import ast
import importlib.util
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from lambdipy_tpu_torch.bundle.baselayer import check_skew, runtime_sys_path
from lambdipy_tpu_torch.bundle.format import BundleError, load_manifest
from lambdipy_tpu_torch.runtime.handlers import HandlerContext
from lambdipy_tpu_torch.utils.debug import apply_debug_env
from lambdipy_tpu_torch.utils.logs import get_logger, log_event
from lambdipy_tpu_torch.utils.platform import resolve_device
from lambdipy_tpu_torch.utils.timing import StageTimer

log = get_logger("lambdipy.runtime")

_JAX_HANDLERS = "lambdipy_tpu.runtime.handlers"
# the JAX package's handlers the port has a twin of
PORTED_HANDLERS = ("generate_handler",)


@dataclass
class BootReport:
    bundle_dir: Path
    handler: Any
    state: Any
    stages: dict[str, float] = field(default_factory=dict)
    skew: dict = field(default_factory=dict)
    warmup_result: Any = None
    manifest: dict = field(default_factory=dict)
    # numerics-sanitizer flags applied (utils/debug.py): always {} in the
    # port, which raises where JAX would turn one on
    debug_flags: dict = field(default_factory=dict)


class PortedHandler:
    """A JAX-built bundle's ``handler.py``, read and not run: ``init``
    builds the port's twin of the handler it names, with its ``_SPEC``."""

    def __init__(self, attr: str, spec: dict):
        self.attr = attr
        self.spec = spec

    def init(self, ctx: HandlerContext):
        if self.attr not in PORTED_HANDLERS:
            raise NotImplementedError(
                f"handler {_JAX_HANDLERS}:{self.attr} is not ported yet; "
                f"the port serves {', '.join(PORTED_HANDLERS)} bundles")
        from lambdipy_tpu_torch.runtime import handlers

        return getattr(handlers, self.attr)(self.spec, ctx)

    @staticmethod
    def invoke(state, request: dict) -> dict:
        return state.invoke(request)


def _jax_imports(tree: ast.AST) -> list[ast.AST]:
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level == 0 and \
                node.module and node.module.split(".")[0] == "lambdipy_tpu":
            out.append(node)
        elif isinstance(node, ast.Import) and any(
                a.name.split(".")[0] == "lambdipy_tpu" for a in node.names):
            out.append(node)
    return out


def read_handler(path: Path) -> PortedHandler | None:
    """The JAX builder's ``handler.py`` at ``path`` as a
    :class:`PortedHandler`, or None when it imports nothing of
    ``lambdipy_tpu`` (a user's own handler). Raises :class:`BundleError`
    when it imports another part of the JAX package or carries no literal
    ``_SPEC``."""
    tree = ast.parse(Path(path).read_text(), filename=str(path))
    imports = _jax_imports(tree)
    if not imports:
        return None
    node = imports[0]
    if len(imports) != 1 or not isinstance(node, ast.ImportFrom) or \
            node.module != _JAX_HANDLERS or len(node.names) != 1:
        raise BundleError(
            f"{path} imports {ast.unparse(node)!r}: the port reads only the "
            f"JAX builder's template, one handler from {_JAX_HANDLERS}")
    spec = None
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "_SPEC"
                for t in stmt.targets):
            spec = ast.literal_eval(stmt.value)
    if not isinstance(spec, dict):
        raise BundleError(f"{path} has no literal _SPEC dict")
    return PortedHandler(node.names[0].name, spec)


def _import_user_handler(bundle_dir: Path):
    spec = importlib.util.spec_from_file_location(
        f"lambdipy_bundle_handler_{bundle_dir.name}",
        bundle_dir / "handler.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_bundle(bundle_dir: Path, *, warmup: bool = True,
                device=None) -> BootReport:
    """Boot ``bundle_dir`` on ``device`` (the card unless ``"cpu"``; with
    no card and no device asked for this raises)."""
    bundle_dir = Path(bundle_dir)
    timer = StageTimer()

    with timer.stage("manifest"):
        manifest = load_manifest(bundle_dir)
        payload = manifest.get("payload")
        if payload is None:
            raise ValueError(
                f"bundle {bundle_dir} has no payload; nothing to serve")
        base = manifest.get("base_layer") or {"name": "none", "versions": {}}
        skew = check_skew(base.get("versions") or {},
                          base.get("name", "none"))
        if skew:
            log_event(log, "base layer skew detected", skew=skew)

    with timer.stage("syspath"):
        for p in reversed(runtime_sys_path(bundle_dir / "site",
                                           base.get("name", "none"))):
            if p not in sys.path:
                sys.path.insert(0, p)

    with timer.stage("compile_cache"):
        device = resolve_device(device)
        if device.type == "cuda":
            from lambdipy_tpu_torch.ops import _build

            _build.build_all()
        debug_flags = apply_debug_env()

    with timer.stage("handler_import"):
        handler = read_handler(bundle_dir / "handler.py")
        if handler is None:
            handler = _import_user_handler(bundle_dir)

    with timer.stage("init"):
        params_dir = bundle_dir / "params"
        ctx = HandlerContext(
            device=device, bundle_dir=bundle_dir, manifest=manifest,
            params_dir=params_dir if params_dir.is_dir() else None,
            spec=dict(payload))
        state = handler.init(ctx)

    warmup_result = None
    if warmup:
        with timer.stage("warmup"):
            warmup_result = handler.invoke(state, {"warmup": True})

    report = BootReport(bundle_dir=bundle_dir, handler=handler, state=state,
                        stages=timer.report(), skew=skew,
                        warmup_result=warmup_result, manifest=manifest,
                        debug_flags=debug_flags)
    log_event(log, "bundle booted", bundle=str(bundle_dir),
              cold_start=report.stages, skew=bool(skew))
    return report
