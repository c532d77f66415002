"""Command line of the port, the twin of ``lambdipy_tpu/cli.py`` with
argparse (the card's host need not have ``click``): the bundle lifecycle,
with JAX's commands, flags and output lines.

    python -m lambdipy_tpu_torch build jax-resnet50
    python -m lambdipy_tpu_torch deploy jax-resnet50
    python -m lambdipy_tpu_torch invoke jax-resnet50 --data '{"random": true}'
    python -m lambdipy_tpu_torch stop jax-resnet50

- ``recipes``, ``show``: the builtin recipes (the port's twins of JAX's,
  ``recipes/builtin/``) and a ``--recipe-dir`` layered over them;
- ``build``: a registry cache hit, else a prebuilt release fetched, else
  a local build (vendor, prune, smoke, payload, then the warm, a
  subprocess that boots the bundle once and is recorded in the manifest
  as ``warm``), published into the artifact registry or written to
  ``--out``; ``artifacts`` lists the registry;
- ``publish``, ``fetch``, ``releases``: prebuilt bundles in a release
  store (``--release-store`` or ``LAMBDIPY_RELEASE_STORE``; a protected
  store takes uploads only with ``LAMBDIPY_RELEASE_TOKEN``);
- ``package``: a requirements file as a site tree (recipe-covered
  distributions through their recipes, the rest vendored);
- ``deploy`` (under the watchdog supervisor by default), ``deployments``,
  ``invoke`` (``--stream``), ``bench``, ``stop``: local deployments, one
  server process each, recorded in ``~/.lambdipy-tpu-torch/``;
- ``doctor``: torch and CUDA versions, the card (name, power limit,
  compute capability; probed in a subprocess with a timeout), ``nvcc``
  and the kernel build cache, the registry and the deployments;
- ``serve``: a bundle in the foreground until SIGTERM, which drains;
- ``fleet``: a bundle from N supervised replicas behind one router
  (``fleet/``): prefix affinity, retries, hedges, the spill queue, the
  phase split (``--prefill-replicas``), sticky sessions and the elastic
  controller (``--autoscale``, ``--autoscale-dry-run``), with JAX's
  flags, defaults and readiness line; SIGTERM stops every replica.

``serve`` and ``deploy`` resolve their target in JAX's order: a bundle
directory (holding ``manifest.json``), a recipe with a built artifact,
an artifact id, a recipe recorded at publish. ``serve`` then falls back
to a model of the port's registry (``llama3-8b``, ``llama-tiny``, ...),
served with seeded random weights (seed 0) and ``--extra`` overrides of
its config, e.g. ``kv_quant=int8``, ``attn_backend=flash``,
``attn_backend=dense,matmul_backend=xla`` (the plain reference model),
``batch_mode=continuous,kv_paged=1``. A bundle boots through
``runtime/loader.py`` with its cold-start stages; the readiness line
``{"ready", "port", "sched_policy", "cold_start"}`` goes to stdout, as
the JAX CLI prints it.

Everything runs on the card through the port's kernels; ``--device cpu``
(``deploy``, ``serve``, ``fleet``, ``doctor``; or
``LAMBDIPY_PLATFORM=cpu``) runs
their plain PyTorch versions on the CPU instead. With no card and no CPU
request, ``deploy``, ``serve`` and ``fleet`` exit non-zero before any
readiness line. ``build`` makes a card recipe's weights and warms its bundle on
the card, and fails without one (and under ``LAMBDIPY_PLATFORM=cpu``:
the CPU would draw other weights under the same artifact id); a recipe
whose device is not the card builds and warms on the CPU, as JAX keeps
``cpu`` / ``any`` recipes off the TPU.

``serve``'s flags are the JAX CLI's ``serve`` flags whose features are
ported. The scheduler's reach the server; the others set the
``LAMBDIPY_*`` variables the handler reads, with JAX's precedence
(``lambdipy_tpu/cli.py:584-612``). ``--mesh`` and ``--prefill-mode sp``
ask for features the port does not have and exit before boot. ``POST
/shutdown`` drains and stops the server.

``train`` is JAX's: ``--model``, ``--data``, ``--steps``, ``--batch``,
``--seq-len``, ``--lr``, ``--ckpt-dir`` (a re-run resumes), ``--ckpt-every``,
``--mesh`` and ``--seed``, with ``--device cpu`` as on the other commands;
the last line holds JAX's keys (``model``, ``final_step``, ``steps_run``,
``resumed_from``, ``mesh``, ``final_metrics``). JAX drives N devices from
one process; the port runs N processes of one device each: ``--mesh
dp=N`` (FSDP over ``dp``) trains as one of N ranks started with the
port's variables (``LAMBDIPY_COORDINATOR``, ``LAMBDIPY_NUM_PROCESSES``,
``LAMBDIPY_PROCESS_ID``) or by torchrun, and a mesh that is not the
process count raises, as do ``tp``, ``ep``, ``sp`` and ``pp`` above 1
(ROADMAP queue 1, item 3 (c)-(f)). The default mesh is every rank on
``dp``. The weights are the port's seeded draws, not JAX's, and
checkpoints are the port's own format (``train/checkpoint.py``), written
whole by rank 0.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

# flag -> the variable it sets (a bool flag's value as "1" / "0")
_ENV_FLAGS = {
    "prefix_cache_mb": "LAMBDIPY_PREFIX_CACHE_MB",
    "prefix_block": "LAMBDIPY_PREFIX_BLOCK",
    "session_pin_budget": "LAMBDIPY_SESSION_PIN_BUDGET_MB",
    "session_ttl": "LAMBDIPY_SESSION_TTL_S",
    "pipeline_depth": "LAMBDIPY_PIPELINE_DEPTH",
    "engine_watchdog": "LAMBDIPY_ENGINE_WATCHDOG_S",
    "kv_paged": "LAMBDIPY_KV_PAGED",
    "kv_pages": "LAMBDIPY_KV_PAGES",
    "max_logical_ctx": "LAMBDIPY_MAX_LOGICAL_CTX",
    "kv_offload": "LAMBDIPY_KV_OFFLOAD",
    "kv_offload_mb": "LAMBDIPY_KV_OFFLOAD_MB",
    "long_prefill": "LAMBDIPY_LONG_PREFILL",
    "prefill_mode": "LAMBDIPY_PREFILL_MODE",
    "spec_k": "LAMBDIPY_SPEC_K",
    "draft_mode": "LAMBDIPY_DRAFT_MODE",
    "draft_exit": "LAMBDIPY_DRAFT_EXIT",
    "mesh": "LAMBDIPY_MESH",
}
_REPO_ROOT = str(Path(__file__).resolve().parents[1])


class CliError(Exception):
    """A command's failure, printed as ``Error: <message>`` with exit 1
    (``click.ClickException``'s contract in the JAX CLI)."""


def _echo(text: str = "", err: bool = False) -> None:
    print(text, file=sys.stderr if err else sys.stdout, flush=True)


def _parse_extra(text: str) -> dict:
    extra = {}
    for item in filter(None, (text or "").split(",")):
        key, sep, value = item.partition("=")
        if not sep:
            raise SystemExit(f"--extra wants key=value pairs, got {item!r}")
        extra[key.strip()] = value.strip()
    return extra


def _pyver() -> str:
    return f"{sys.version_info.major}.{sys.version_info.minor}"


def _child_env() -> dict:
    """The environment of a subprocess of the port: the repository first
    on ``PYTHONPATH``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_REPO_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                        if p])
    return env


# -- recipes and the registry -----------------------------------------------


def cmd_recipes(args) -> None:
    from lambdipy_tpu_torch.recipes import builtin_store

    store = builtin_store(args.recipe_dir)
    for name in store.names():
        r = store.get(name)
        kind = "model" if r.is_model else "package"
        _echo(f"{name:20s} {r.version:10s} {r.device:10s} {kind:8s} "
              f"{r.description}")


def cmd_show(args) -> None:
    import dataclasses

    from lambdipy_tpu_torch.recipes import builtin_store

    recipe = builtin_store(args.recipe_dir).get(args.recipe_name)
    _echo(json.dumps(dataclasses.asdict(recipe), indent=1, default=str))


def cmd_artifacts(args) -> None:
    from lambdipy_tpu_torch.resolve.registry import ArtifactRegistry

    for info in ArtifactRegistry(args.registry).list():
        _echo(f"{info.artifact_id:45s} {info.size_bytes / 1e6:9.1f}MB  "
              f"{info.device}")


# -- build / package --------------------------------------------------------


def _registry_lookup(registry, recipe, pyver: str) -> str | None:
    """The artifact id under which the recipe is cached, or None: the
    recipe's own id, then the ``device=any`` id of the same recipe,
    version and python (a prebuilt asset published for ``any`` satisfies
    a device-pinned recipe; nothing looser does)."""
    import dataclasses

    exact = recipe.artifact_id(pyver)
    any_id = dataclasses.replace(recipe, device="any").artifact_id(pyver)
    for candidate in (exact, any_id):
        if registry.has(candidate):
            return candidate
    return None


def _warm(recipe, bundle_dir: Path) -> dict:
    """Run ``runtime/warm.py`` on the bundle in a subprocess, on the
    recipe's device, bounded by ``LAMBDIPY_WARM_TIMEOUT`` (600 s); its
    outcome, failed or not, is the manifest's ``warm`` record."""
    from lambdipy_tpu_torch.bundle.package import build_device

    env = _child_env()
    if build_device(recipe) == "cpu":
        env["LAMBDIPY_PLATFORM"] = "cpu"
    warm_timeout = float(os.environ.get("LAMBDIPY_WARM_TIMEOUT", "600"))
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "lambdipy_tpu_torch.runtime.warm",
             str(bundle_dir)],
            capture_output=True, text=True, env=env, timeout=warm_timeout)
    except subprocess.TimeoutExpired:
        _echo(f"warning: warm timed out after {warm_timeout:.0f}s; bundle "
              "still usable", err=True)
        return {"ok": False, "error": f"timeout after {warm_timeout:.0f}s"}
    if proc.returncode != 0:
        error = proc.stderr.strip()[-300:]
        _echo(f"warning: warm failed (bundle still usable): {error}",
              err=True)
        return {"ok": False, "error": error}
    lines = proc.stdout.strip().splitlines()
    last = lines[-1] if lines else ""
    _echo(f"warmed: {last}")
    record = {"ok": True}
    try:
        parsed = json.loads(last)
        if isinstance(parsed, dict):
            record.update(parsed)
    except ValueError:
        pass
    return record


def _run_build(recipe, registry, *, out=None, no_smoke=False,
               no_payload=False, warm=True) -> str:
    """Build one recipe into a bundle: published into the registry, or
    written to ``out``. Shared by ``build`` and ``publish``."""
    from lambdipy_tpu_torch.buildengine import build_recipe
    from lambdipy_tpu_torch.bundle.format import update_manifest
    from lambdipy_tpu_torch.bundle.package import (assemble_bundle,
                                                   build_device)

    with_payload = not no_payload and recipe.is_model
    if with_payload:
        try:  # before the vendor build: a card recipe on the CPU fails
            build_device(recipe)
        except ValueError as e:
            raise CliError(str(e)) from e
    artifact_id = recipe.artifact_id(_pyver())
    workdir = Path(tempfile.mkdtemp(prefix=f"lambdipy-build-{recipe.name}-"))
    try:
        result = build_recipe(recipe, workdir, run_smoke=not no_smoke)
        bundle_dir = Path(out) if out else workdir / "bundle"
        manifest = assemble_bundle(result, bundle_dir,
                                   with_payload=with_payload)
        if warm and with_payload:
            manifest = update_manifest(bundle_dir,
                                       warm=_warm(recipe, bundle_dir))
        if out is None:
            registry.publish(artifact_id, bundle_dir, recipe=recipe.name,
                             version=recipe.version, device=recipe.device,
                             manifest=manifest)
            _echo(f"built + published {artifact_id}")
        else:
            _echo(f"built {artifact_id} -> {bundle_dir}")
    finally:
        # the registry holds a copy, --out the bundle itself
        shutil.rmtree(workdir, ignore_errors=True)
    p = result.prune
    _echo(f"size {p.bytes_after / 1e6:.1f}MB (saved "
          f"{p.bytes_saved / 1e6:.1f}MB); skipped optional: "
          f"{result.skipped_optional or 'none'}")
    return artifact_id


def cmd_build(args) -> None:
    from lambdipy_tpu_torch.recipes import builtin_store
    from lambdipy_tpu_torch.resolve.registry import ArtifactRegistry
    from lambdipy_tpu_torch.resolve.releases import (ReleaseError,
                                                     ReleaseFetcher,
                                                     default_store)

    recipe = builtin_store(args.recipe_dir).get(args.recipe_name)
    registry = ArtifactRegistry(args.registry)
    if not args.force and args.out is None:
        cached = _registry_lookup(registry, recipe, _pyver())
        if cached is not None:
            _echo(f"cache hit: {cached} (use --force to rebuild)")
            return
    if not args.force and args.out is None and not args.no_prebuilt:
        releases = default_store(args.release_store)
        if releases is not None:
            asset = releases.find_asset(recipe=recipe.name, python=_pyver(),
                                        device=recipe.device,
                                        version=recipe.version)
            if asset is not None:
                try:
                    ReleaseFetcher(releases).fetch_into_registry(asset,
                                                                 registry)
                except ReleaseError as e:
                    _echo(f"warning: prebuilt fetch failed ({e}); building "
                          "locally", err=True)
                else:
                    _echo(f"fetched prebuilt {asset.name} (release "
                          f"{asset.tag}) -> {asset.artifact_id}")
                    return
    _run_build(recipe, registry, out=args.out, no_smoke=args.no_smoke,
               no_payload=args.no_payload, warm=args.warm)


# -- prebuilt releases ------------------------------------------------------


def _require_store(release_store):
    from lambdipy_tpu_torch.resolve.releases import STORE_ENV, default_store

    store = default_store(release_store)
    if store is None:
        raise CliError(f"no release store: pass --release-store or set "
                       f"{STORE_ENV}")
    return store


def cmd_publish(args) -> None:
    from lambdipy_tpu_torch import __version__
    from lambdipy_tpu_torch.recipes import builtin_store
    from lambdipy_tpu_torch.resolve.registry import ArtifactRegistry
    from lambdipy_tpu_torch.resolve.releases import ReleaseError, pack_bundle

    if not args.recipe_names and not args.all:
        raise CliError("pass recipe names or --all")
    store = builtin_store(args.recipe_dir)
    names = store.names() if args.all else list(args.recipe_names)
    releases = _require_store(args.release_store)
    try:  # a protected store without the token fails before any build
        releases._check_write()
    except ReleaseError as e:
        raise CliError(str(e)) from e
    registry = ArtifactRegistry(args.registry)
    tag = args.tag or f"v{__version__}"
    failed: list[str] = []
    for name in names:
        recipe = store.get(name)
        if _pyver() not in recipe.python:
            _echo(f"skip {name}: recipe pins python {recipe.python}")
            continue
        artifact_id = recipe.artifact_id(_pyver())
        if args.rebuild or not registry.has(artifact_id):
            try:
                _run_build(recipe, registry, warm=args.warm)
            except Exception as e:  # noqa: BLE001 — one unbuildable
                # recipe must not abort the whole sweep
                _echo(f"FAILED {name}: {e}", err=True)
                failed.append(name)
                continue
        bundle = registry.fetch(artifact_id)
        with tempfile.TemporaryDirectory(prefix="lambdipy-publish-") as td:
            archive = pack_bundle(bundle, Path(td) / f"{artifact_id}.tar.gz")
            try:
                asset = releases.upload_asset(
                    tag, archive, artifact_id=artifact_id,
                    recipe=recipe.name, version=recipe.version,
                    python=_pyver(), device=recipe.device)
            except ReleaseError as e:
                raise CliError(str(e)) from e
        _echo(f"published {asset.name} ({asset.size / 1e6:.1f}MB) -> "
              f"release {tag}")
    if failed:
        raise CliError(f"{len(failed)} recipe(s) failed to build: "
                       f"{', '.join(failed)}")


def cmd_fetch(args) -> None:
    from lambdipy_tpu_torch.recipes import builtin_store
    from lambdipy_tpu_torch.resolve.registry import ArtifactRegistry
    from lambdipy_tpu_torch.resolve.releases import (ReleaseError,
                                                     ReleaseFetcher)

    releases = _require_store(args.release_store)
    store = builtin_store(args.recipe_dir)
    device = version = None
    if args.recipe_name in store:
        recipe = store.get(args.recipe_name)
        device, version = recipe.device, recipe.version
    asset = releases.find_asset(recipe=args.recipe_name, python=_pyver(),
                                device=device, version=version)
    if asset is None:
        raise CliError(f"no prebuilt asset for {args.recipe_name!r} (python "
                       f"{_pyver()}) in {releases.root}")
    try:
        ReleaseFetcher(releases).fetch_into_registry(
            asset, ArtifactRegistry(args.registry))
    except ReleaseError as e:
        raise CliError(str(e)) from e
    _echo(f"fetched {asset.name} (release {asset.tag}) -> "
          f"{asset.artifact_id}")


def cmd_releases(args) -> None:
    releases = _require_store(args.release_store)
    for asset in releases.list_assets():
        _echo(f"{asset.tag:12s} {asset.name:55s} {asset.size / 1e6:8.1f}MB "
              f"py{asset.python} {asset.device}")


def cmd_package(args) -> None:
    from lambdipy_tpu_torch.buildengine import build_recipe
    from lambdipy_tpu_torch.buildengine.vendor import (dependency_closure,
                                                       vendor_distribution)
    from lambdipy_tpu_torch.recipes import builtin_store
    from lambdipy_tpu_torch.resolve import resolve_project
    from lambdipy_tpu_torch.utils.fsutil import copy_tree

    if not Path(args.requirements).exists():
        raise CliError(f"requirements file {args.requirements!r} does not "
                       "exist")
    store = builtin_store(args.recipe_dir)
    res = resolve_project(Path(args.requirements), store)
    out_dir = Path(args.out)
    site = out_dir / "site"
    site.mkdir(parents=True, exist_ok=True)
    for req, recipe_name in res.recipe_covered:
        recipe = store.get(recipe_name)
        workdir = Path(tempfile.mkdtemp(prefix=f"lambdipy-pkg-{recipe.name}-"))
        try:
            copy_tree(build_recipe(recipe, workdir).site_dir, site)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        _echo(f"recipe {recipe_name}: {req.pin}")
    vendored = set()
    for req in res.plain:
        for dep in dependency_closure([req.raw]):
            if dep not in vendored and \
                    not (site / dep.replace("-", "_")).exists():
                vendor_distribution(dep, site)
                vendored.add(dep)
        _echo(f"plain dep: {req.pin}")
    _echo(f"packaged -> {out_dir} (add your handler.py and deploy)")


# -- deploy / serve / invoke ------------------------------------------------


def _resolve_bundle(name_or_dir: str, registry_dir) -> Path | None:
    """The bundle a name stands for, in JAX's order (``cli.py:389-412``):
    a bundle directory, a builtin recipe's built artifact, an artifact id,
    the newest artifact of a recipe recorded at publish; None when the
    name is none of these. A builtin recipe with no built artifact
    raises."""
    from lambdipy_tpu_torch.recipes import builtin_store
    from lambdipy_tpu_torch.resolve.registry import ArtifactRegistry

    path = Path(name_or_dir)
    if path.is_dir() and (path / "manifest.json").exists():
        return path
    registry = ArtifactRegistry(registry_dir)
    store = builtin_store()
    if name_or_dir in store:
        artifact_id = _registry_lookup(registry, store.get(name_or_dir),
                                       _pyver())
        if artifact_id is not None:
            return registry.fetch(artifact_id)
        raise CliError(f"recipe {name_or_dir!r} has no built artifact; run: "
                       f"python -m lambdipy_tpu_torch build {name_or_dir}")
    if registry.has(name_or_dir):
        return registry.fetch(name_or_dir)
    # custom recipes (built with --recipe-dir) are not in the builtin
    # store: resolve them by the recipe name recorded at publish
    by_recipe = [a for a in registry.list() if a.recipe == name_or_dir]
    if by_recipe:
        latest = max(by_recipe, key=lambda a: a.created)
        return registry.fetch(latest.artifact_id)
    return None


def _neither(name: str) -> CliError:
    return CliError(f"{name!r} is neither a bundle dir, recipe, nor "
                    "artifact id")


def cmd_deploy(args) -> None:
    from lambdipy_tpu_torch.runtime.deploy import LocalRuntime

    bundle_dir = _resolve_bundle(args.bundle, args.registry)
    if bundle_dir is None:
        raise _neither(args.bundle)
    dep = LocalRuntime().deploy(args.name or args.bundle.split("/")[-1],
                                bundle_dir, port=args.port,
                                ready_timeout=args.timeout,
                                watchdog=args.watchdog, device=args.device)
    _echo(json.dumps({"name": dep.name, "url": dep.url,
                      "cold_start": dep.cold_start}))


def apply_flags(args: argparse.Namespace) -> None:
    """Set the ``LAMBDIPY_*`` variable of every ``serve`` flag given; a
    flag that asks for an unported feature exits with the handler's
    message before boot."""
    from lambdipy_tpu_torch.runtime.handlers import _check_unported_extras

    try:
        _check_unported_extras({k: getattr(args, k)
                                for k in ("mesh", "prefill_mode")
                                if getattr(args, k) is not None})
    except ValueError as e:
        raise SystemExit(f"serve: {e}") from None
    for flag, env in _ENV_FLAGS.items():
        value = getattr(args, flag)
        if value is not None:
            os.environ[env] = (("1" if value else "0")
                               if isinstance(value, bool) else str(value))


def cmd_serve(args) -> None:
    apply_flags(args)
    from lambdipy_tpu_torch.runtime.server import (BundleServer,
                                                   serve_until_term)

    sched = {"policy": args.sched_policy,
             "max_concurrency": args.sched_concurrency,
             "queue_cap": args.sched_queue_cap, "rate": args.sched_rate,
             "burst": args.sched_burst}
    bundle_dir = _resolve_bundle(args.target, args.registry)
    if bundle_dir is not None:
        if args.extra:
            raise CliError("serve: --extra overrides a model's config; a "
                           "bundle's config is its manifest")
        server = BundleServer.from_bundle(bundle_dir, host=args.host,
                                          port=args.port, sched=sched,
                                          device=args.device)
        ready = {"ready": True, "port": server.port,
                 "sched_policy": server.sched.policy.name,
                 "cold_start": server.boot.stages}
    else:
        from lambdipy_tpu_torch.models import registry as model_registry
        from lambdipy_tpu_torch.runtime.handlers import (HandlerContext,
                                                         generate_handler)

        try:
            model_registry.get(args.target)
        except model_registry.ModelError:
            raise _neither(args.target) from None
        state = generate_handler(
            {"model": args.target, "extra": _parse_extra(args.extra)},
            HandlerContext(device=args.device))
        server = BundleServer(state, host=args.host, port=args.port,
                              sched=sched)
        ready = {"ready": True, "port": server.port,
                 "sched_policy": server.sched.policy.name,
                 "model": args.target}
    serve_until_term(server, ready)


def _request(data: str) -> dict:
    try:
        return json.loads(data)
    except json.JSONDecodeError as e:
        raise CliError(f"--data is not valid JSON: {e}") from e


def cmd_invoke(args) -> None:
    from lambdipy_tpu_torch.runtime.deploy import LocalRuntime

    request = _request(args.data)
    if args.stream:
        for chunk in LocalRuntime().invoke_stream(args.name, request):
            _echo(json.dumps(chunk))
    else:
        _echo(json.dumps(LocalRuntime().invoke(args.name, request)))


def cmd_deployments(args) -> None:
    from lambdipy_tpu_torch.runtime.deploy import LocalRuntime

    for dep in LocalRuntime().list():
        _echo(f"{dep.name:25s} pid={dep.pid:<8d} {dep.url}")


def cmd_bench(args) -> None:
    import statistics
    import time

    from lambdipy_tpu_torch.runtime.deploy import LocalRuntime

    request = _request(args.data)
    rt = LocalRuntime()
    for _ in range(args.warmup):
        rt.invoke(args.name, request)
    times = []
    for _ in range(args.iters):
        t0 = time.monotonic()
        out = rt.invoke(args.name, request)
        times.append((time.monotonic() - t0) * 1000.0)
        if not out.get("ok", True):
            raise CliError(f"invoke failed: {out}")
    times.sort()

    def pct(q):  # nearest rank: ceil(q * n) - 1, 0-based
        return times[max(0, math.ceil(q * args.iters) - 1)]

    _echo(json.dumps({
        "name": args.name, "n": args.iters,
        "p50_ms": round(statistics.median(times), 3),
        "p90_ms": round(pct(0.90), 3),
        "p99_ms": round(pct(0.99), 3),
        "mean_ms": round(statistics.fmean(times), 3),
    }))


def cmd_stop(args) -> None:
    from lambdipy_tpu_torch.runtime.deploy import LocalRuntime

    LocalRuntime().stop(args.name)
    _echo(f"stopped {args.name}")


# -- fleet ------------------------------------------------------------------


def cmd_fleet(args) -> None:
    """Serve a bundle from N supervised replicas behind one router
    (``lambdipy_tpu/cli.py:638-916``): spawns the replicas (decode-class
    with ``--prefill-replicas`` > 0, mixed otherwise, then the prefill
    class as ``NAME-p0..M-1``), attaches ``--attach`` replicas, probes
    them (eject on failure, readmit on recovery), and serves ``/invoke``
    and ``/v1/completions`` on ``--port`` with prefix affinity, retries,
    the phase split and sticky sessions. The readiness line is JAX's;
    SIGTERM stops the router and then every replica. The replicas run on
    the card unless ``--device cpu``."""
    import signal
    import threading

    from lambdipy_tpu_torch.fleet import (DECODE, MIXED, PREFILL, FleetError,
                                          FleetRouter, ReplicaPool,
                                          parse_attach_spec)
    from lambdipy_tpu_torch.runtime.deploy import LocalRuntime
    from lambdipy_tpu_torch.runtime.faults import FaultPlan

    if args.replicas < 1 and not args.attach:
        raise CliError("--replicas must be >= 1 (or pass --attach for an "
                       "attach-only fleet)")
    if args.prefill_replicas < 0:
        raise CliError("--prefill-replicas must be >= 0")
    attached: list[tuple[str, str, str]] = []
    for spec in args.attach:
        try:
            attached.append(parse_attach_spec(spec))
        except FleetError as e:
            raise CliError(str(e)) from None
    try:
        fleet_faults = (FaultPlan.from_spec(args.fault_spec)
                        if args.fault_spec is not None
                        else FaultPlan.from_env(var="LAMBDIPY_FLEET_FAULT"))
    except ValueError as e:
        raise CliError(str(e)) from None
    hedge_ms: float | str = 0
    if args.hedge not in ("off", "0", ""):
        if args.hedge == "p95":
            hedge_ms = "p95"
        else:
            try:
                hedge_ms = float(args.hedge)
            except ValueError:
                raise CliError(f"--hedge must be 'off', 'p95' or a "
                               f"threshold in ms, got {args.hedge!r}"
                               ) from None
    # an attach-only fleet never deploys the bundle: it need not resolve
    bundle_dir = None
    if args.replicas >= 1 or args.prefill_replicas >= 1:
        bundle_dir = _resolve_bundle(args.bundle, args.registry)
        if bundle_dir is None:
            raise _neither(args.bundle)
    fleet_name = args.name or args.bundle.rstrip("/").split("/")[-1]
    pool = ReplicaPool(probe_interval=args.probe_interval,
                       fail_threshold=args.fail_threshold,
                       readmit_passes=args.readmit_passes,
                       faults=fleet_faults)
    replica_env = {}
    if args.engine_watchdog is not None:
        replica_env["LAMBDIPY_ENGINE_WATCHDOG_S"] = str(args.engine_watchdog)
    if args.session_pin_budget is not None:
        replica_env["LAMBDIPY_SESSION_PIN_BUDGET_MB"] = \
            str(args.session_pin_budget)
    if args.session_ttl is not None:
        replica_env["LAMBDIPY_SESSION_TTL_S"] = str(args.session_ttl)
    replica_env = replica_env or None
    device = args.device
    spawned = []
    controller = None
    try:
        runtime = LocalRuntime()
        # with a prefill class the serve replicas are decode-class (the
        # phase split is the point); otherwise they stay mixed. All boot
        # at once and register in JAX's order: r0..rN-1, then p0..pM-1
        role = DECODE if args.prefill_replicas else MIXED
        specs = [(f"{fleet_name}-r{i}", role)
                 for i in range(max(0, args.replicas))]
        specs += [(f"{fleet_name}-p{i}", PREFILL)
                  for i in range(args.prefill_replicas)]
        if specs:
            spawned = pool.spawn_all(bundle_dir, specs, runtime=runtime,
                                     env=replica_env,
                                     ready_timeout=args.timeout,
                                     device=device)
        for aname, aurl, arole in attached:
            pool.probe_one(pool.attach(aname, aurl, role=arole))
        pool.start()
        # inside the guard: a router that cannot bind its port must not
        # leak the replicas
        router = FleetRouter(pool, port=args.port,
                             affinity_on=args.affinity, block=args.block,
                             max_retries=args.retries,
                             saturation=args.saturation, hedge_ms=hedge_ms,
                             spill_cap=args.spill_cap,
                             spill_max_wait_s=args.spill_max_wait,
                             breaker_fails=args.breaker_fails,
                             breaker_open_s=args.breaker_open_s,
                             retry_budget=args.retry_budget,
                             ship_window=args.ship_window,
                             faults=fleet_faults)
        autoscale = args.autoscale or args.autoscale_dry_run
        if autoscale:
            from lambdipy_tpu_torch.fleet import (FleetController,
                                                  PolicyConfig)

            spawner = None
            if bundle_dir is not None:
                counter = iter(range(len(spawned), 10_000))

                def spawner(role):
                    nm = f"{fleet_name}-a{next(counter)}"
                    pool.spawn(nm, bundle_dir, runtime=runtime,
                               env=replica_env, ready_timeout=args.timeout,
                               role=role, device=device)
                    return nm

            controller = FleetController(
                router, config=PolicyConfig(slo_p99_ms=args.slo_p99_ms),
                interval_s=args.autoscale_interval,
                dry_run=args.autoscale_dry_run, spawner=spawner).start()
    except BaseException:
        # a half-spawned fleet leaks no process, Ctrl-C mid-boot included
        if controller is not None:
            controller.close()
        pool.stop_all()
        raise
    _echo(json.dumps({
        "ready": True, "port": router.port, "replicas": len(spawned),
        "prefill_replicas": args.prefill_replicas,
        "attached": [a for a, _, _ in attached],
        "classes": {r.name: r.role for r in pool.replicas.values()},
        "affinity": args.affinity, "block": args.block,
        "spill_cap": args.spill_cap, "breaker_fails": args.breaker_fails,
        "retry_budget": args.retry_budget,
        "autoscale": bool(autoscale),
        "autoscale_dry_run": bool(args.autoscale_dry_run),
        "slo_p99_ms": args.slo_p99_ms,
        "urls": {r.name: r.url for r in spawned},
    }))

    def _term(signum, frame):
        threading.Thread(target=router.stop, daemon=True).start()

    signal.signal(signal.SIGTERM, _term)
    try:
        router.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if controller is not None:
            controller.close()
        pool.stop_all()


# -- doctor -----------------------------------------------------------------

# the card probe, run in a fresh interpreter; LAMBDIPY_DOCTOR_WEDGE hangs
# it (fault injection: the timeout's diagnosis is testable)
_DOCTOR_PROBE = r"""
import json, os, subprocess, time
if os.environ.get("LAMBDIPY_DOCTOR_WEDGE"):
    time.sleep(3600)
import torch
out = {"available": torch.cuda.is_available(),
       "count": torch.cuda.device_count(), "cuda": torch.version.cuda}
if out["available"]:
    major, minor = torch.cuda.get_device_capability(0)
    out["name"] = torch.cuda.get_device_name(0)
    out["capability"] = f"{major}.{minor}"
    try:
        out["power_limit"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, timeout=30).stdout.strip() or None
    except (OSError, subprocess.TimeoutExpired):
        out["power_limit"] = None
print("DOCTOR " + json.dumps(out))
"""


def _probe_card(timeout: float) -> dict:
    try:
        proc = subprocess.run([sys.executable, "-c", _DOCTOR_PROBE],
                              capture_output=True, text=True,
                              env=_child_env(), timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"ok": False,
                "error": f"wedge: the card probe hung for {timeout:.0f}s "
                         "(CUDA stuck? another process holding the "
                         "card?)"}
    marker = [ln for ln in proc.stdout.splitlines()
              if ln.startswith("DOCTOR ")]
    if proc.returncode != 0 or not marker:
        return {"ok": False, "error": proc.stderr.strip()[-300:]}
    found = json.loads(marker[-1].removeprefix("DOCTOR "))
    if not found["available"]:
        return {"ok": False, "platform": "cpu", "n_devices": 0,
                "cuda": found["cuda"],
                "error": "no CUDA device is available"}
    return {"ok": True, "platform": "gpu", "n_devices": found["count"],
            "cuda": found["cuda"], "name": found["name"],
            "power_limit": found["power_limit"],
            "compute_capability": found["capability"]}


def _kernel_toolchain() -> dict:
    from lambdipy_tpu_torch.ops import _build

    out = {"cache_dir": str(_build.BUILD_DIR),
           "built": [n for n in _build.SOURCES
                     if _build.library_path(n).exists()],
           "missing": [n for n in _build.SOURCES
                       if not _build.library_path(n).exists()]}
    try:
        path = _build.nvcc()
        version = subprocess.run([path, "--version"], capture_output=True,
                                 text=True, timeout=60).stdout
        out["nvcc"] = {"path": path,
                       "version": version.strip().splitlines()[-1]}
    except (RuntimeError, OSError, subprocess.TimeoutExpired,
            IndexError) as e:
        out["nvcc"] = {"path": None, "error": str(e)[:200]}
    return out


def cmd_doctor(args) -> None:
    import importlib.metadata as md

    from lambdipy_tpu_torch.resolve.registry import ArtifactRegistry
    from lambdipy_tpu_torch.runtime.deploy import LocalRuntime

    report: dict = {"python": sys.version.split()[0], "packages": {}}
    for pkg in ("torch", "numpy", "triton"):
        try:
            report["packages"][pkg] = md.version(pkg)
        except md.PackageNotFoundError:
            report["packages"][pkg] = None
    report["device"] = _probe_card(args.probe_timeout)
    # the version of CUDA torch was built for, as the probe read it
    report["cuda"] = report["device"].get("cuda")
    report["kernels"] = _kernel_toolchain()
    try:
        arts = ArtifactRegistry(args.registry).list()
        report["registry"] = {"artifacts": len(arts),
                              "bytes": sum(a.size_bytes for a in arts)}
    except Exception as e:  # noqa: BLE001 — a diagnosis, never a crash
        report["registry"] = {"error": str(e)}
    deployments = []
    try:
        rt = LocalRuntime(Path(args.state) if args.state else None)
        for dep in rt.list():
            entry = {"name": dep.name, "url": dep.url}
            try:
                entry["healthy"] = bool(rt.health(dep.name).get("ok"))
            except Exception as e:  # noqa: BLE001 — reported
                entry["healthy"] = False
                entry["error"] = str(e)[:120]
            deployments.append(entry)
    except Exception as e:  # noqa: BLE001 — reported
        deployments = [{"error": str(e)[:120]}]
    report["deployments"] = deployments
    _echo(json.dumps(report, indent=1))
    if not report["device"]["ok"] and args.device != "cpu" \
            and os.environ.get("LAMBDIPY_PLATFORM") != "cpu":
        raise SystemExit(1)


# -- the parser -------------------------------------------------------------


def _mesh_shape(spec: str | None, world: int) -> dict:
    """``--mesh`` as ``{axis: size}``, JAX's parse and message; the
    default puts every rank on ``dp`` (JAX: every device)."""
    if not spec:
        return {"dp": world}
    shape = {}
    for part in spec.split(","):
        axis, eq, size = part.partition("=")
        try:
            if not eq:
                raise ValueError("missing '='")
            shape[axis.strip()] = int(size)
        except ValueError as e:
            raise CliError(f"bad --mesh entry {part!r} (want axis=size, e.g. "
                           f"dp=2,tp=4): {e}") from e
    return shape


def cmd_train(args) -> None:
    """JAX's ``train``: a registry model with seeded random weights (the
    port's draws), trained on a token file by the resumable ``Trainer``,
    on one device or as one rank of a ``dp`` mesh; the last line is JAX's
    summary."""
    if not Path(args.data).exists():
        raise CliError(f"--data: path {args.data!r} does not exist")
    from lambdipy_tpu_torch.parallel.distributed import (initialize_from_env,
                                                         shutdown)

    try:
        ctx = initialize_from_env(device=args.device)
    except (ValueError, RuntimeError) as e:
        raise CliError(f"train: {e}") from None
    try:
        _train(args, ctx)
    finally:
        shutdown()


def _train(args, ctx) -> None:
    from lambdipy_tpu_torch.data import ShardedLoader, TokenSource
    from lambdipy_tpu_torch.models import registry as model_registry
    from lambdipy_tpu_torch.models.params import train_params
    from lambdipy_tpu_torch.parallel.mesh import job_mesh
    from lambdipy_tpu_torch.train.loop import Trainer, TrainerConfig
    from lambdipy_tpu_torch.train.step import refuse_routing_over_ranks
    from lambdipy_tpu_torch.utils.platform import resolve_device

    adapter = model_registry.get(args.model).build()
    try:
        shape = _mesh_shape(args.mesh, ctx.process_count)
        if adapter.train_forward_with_aux is not None:
            refuse_routing_over_ranks(shape)
        mesh = job_mesh(shape)
        device = resolve_device(ctx.device or args.device)
    except (ValueError, NotImplementedError, RuntimeError) as e:
        raise CliError(f"train: {e}") from None
    params = train_params(adapter.init_params(seed=args.seed, device=device))
    loader = ShardedLoader(TokenSource(args.data, args.seq_len), args.batch,
                           seed=args.seed)
    cfg = TrainerConfig(total_steps=args.steps, learning_rate=args.lr,
                        ckpt_every=args.ckpt_every)
    with Trainer(adapter.train_forward, params, loader, cfg, device=device,
                 mesh=mesh, rules=adapter.tp_rules, ckpt_dir=args.ckpt_dir,
                 model_apply_aux=adapter.train_forward_with_aux) as trainer:
        report = trainer.run()
    last = report.history[-1] if report.history else {}
    _echo(json.dumps({
        "model": args.model, "final_step": report.final_step,
        "steps_run": report.steps_run, "resumed_from": report.resumed_from,
        "mesh": mesh.shape, "final_metrics": last}))


def parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m lambdipy_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    def add(name, fn, help_):
        p = sub.add_parser(name, help=help_)
        p.set_defaults(fn=fn)
        return p

    def registry_flag(p):
        p.add_argument("--registry", default=None,
                       help="artifact registry root (default: "
                            "~/.lambdipy-tpu-torch/registry)")

    def recipe_dir_flag(p):
        p.add_argument("--recipe-dir", default=None,
                       help="extra recipe dir layered over the builtins")

    def store_flag(p):
        p.add_argument("--release-store", default=None,
                       help="release store root (default: "
                            "$LAMBDIPY_RELEASE_STORE)")

    def device_flag(p, what):
        p.add_argument("--device", default=None, choices=["cpu"],
                       help=f"{what} on the CPU (default: the CUDA card)")

    p = add("recipes", cmd_recipes, "list the recipes")
    recipe_dir_flag(p)
    p = add("show", cmd_show, "show one recipe as JSON")
    p.add_argument("recipe_name")
    recipe_dir_flag(p)
    p = add("artifacts", cmd_artifacts, "list the registry's artifacts")
    registry_flag(p)

    p = add("build", cmd_build, "build a recipe into a bundle: registry "
                                "cache hit, then prebuilt fetch, then a "
                                "local build")
    p.add_argument("recipe_name")
    p.add_argument("--out", default=None,
                   help="bundle output dir (default: a temporary dir, "
                        "published into the registry)")
    registry_flag(p)
    recipe_dir_flag(p)
    store_flag(p)
    p.add_argument("--no-prebuilt", action="store_true",
                   help="skip the prebuilt-release lookup")
    p.add_argument("--no-smoke", action="store_true",
                   help="skip the hermetic import smoke")
    p.add_argument("--no-payload", action="store_true",
                   help="skip params and handler")
    p.add_argument("--force", action="store_true",
                   help="rebuild even if the artifact is cached")
    p.add_argument("--warm", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="boot the bundle once at build (model recipes): "
                        "builds the kernel libraries, checks the handler")

    p = add("publish", cmd_publish, "build recipes and upload them as "
                                    "prebuilt release assets")
    p.add_argument("recipe_names", nargs="*")
    p.add_argument("--all", action="store_true",
                   help="publish every builtin recipe")
    store_flag(p)
    p.add_argument("--tag", default=None,
                   help="release tag (default: v<the port's version>)")
    registry_flag(p)
    recipe_dir_flag(p)
    p.add_argument("--rebuild", action="store_true",
                   help="rebuild even if cached locally")
    p.add_argument("--warm", action=argparse.BooleanOptionalAction,
                   default=True)

    p = add("fetch", cmd_fetch, "download a prebuilt bundle into the "
                                "registry")
    p.add_argument("recipe_name")
    store_flag(p)
    registry_flag(p)
    recipe_dir_flag(p)
    p = add("releases", cmd_releases, "list the release store's assets")
    store_flag(p)

    p = add("package", cmd_package, "a requirements file as a deployable "
                                    "site tree")
    p.add_argument("requirements")
    p.add_argument("--out", required=True, help="output build/ tree")
    recipe_dir_flag(p)

    p = add("deploy", cmd_deploy, "deploy a built bundle as a local "
                                  "server process")
    p.add_argument("bundle")
    p.add_argument("--name", default=None,
                   help="deployment name (default: recipe/artifact)")
    p.add_argument("--port", type=int, default=0)
    registry_flag(p)
    p.add_argument("--timeout", type=float, default=300.0)
    p.add_argument("--watchdog", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="run under the restart supervisor (crash -> "
                        "respawn)")
    device_flag(p, "serve")

    serve = add("serve", cmd_serve, "serve a bundle or a model over HTTP")
    serve.add_argument("target", metavar="bundle_or_model",
                       help="a bundle directory, a recipe or artifact "
                            "name, or a model name of the port's registry")
    registry_flag(serve)
    serve.add_argument("--extra", default="",
                       help="a model's config overrides, key=value, "
                            "comma-separated (not for a bundle)")
    serve.add_argument("--device", default=None,
                       help="default: the CUDA card")
    serve.add_argument("--host", default="127.0.0.1")
    serve.add_argument("--port", type=int, default=8000,
                       help="0 picks a free port")
    serve.add_argument("--sched-policy", default=None,
                       choices=["fifo", "priority", "fair"],
                       help="dequeue policy between request classes "
                            "(default: extra sched_policy, else fair)")
    serve.add_argument("--sched-concurrency", type=int, default=None,
                       help="invokes running at once (default 8, floored "
                            "at the engine's batch_max)")
    serve.add_argument("--sched-queue-cap", type=int, default=None,
                       help="bounded queue depth; beyond it requests shed "
                            "503 (default 64)")
    serve.add_argument("--sched-rate", type=float, default=None,
                       help="per-tenant admission rate, requests/s, keyed "
                            "by x-api-key/x-tenant (0 = unlimited)")
    serve.add_argument("--sched-burst", type=float, default=None,
                       help="per-tenant token-bucket burst (default 2x "
                            "rate)")
    serve.add_argument("--prefix-cache-mb", type=float, default=None,
                       help="device budget (MB) of the automatic prefix "
                            "KV cache; 0 disables (default: extra "
                            "prefix_cache_mb, else 512)")
    serve.add_argument("--prefix-block", type=int, default=None,
                       help="token-block width of prefix reuse and of the "
                            "KV pages (default 32)")
    serve.add_argument("--session-pin-budget", type=float, default=None,
                       help="MB of the prefix cache open sessions may pin "
                            "(default: half the cache budget)")
    serve.add_argument("--session-ttl", type=float, default=None,
                       help="absolute session pin lease, seconds "
                            "(default 3600)")
    serve.add_argument("--pipeline-depth", type=int, default=None,
                       help="decode segments the continuous engine keeps "
                            "on the card: 1 = the synchronous loop "
                            "(default: extra pipeline_depth, else 2)")
    serve.add_argument("--engine-watchdog", type=float, default=None,
                       help="seconds after which a hung engine wait marks "
                            "the engine wedged; 0 disables (default off)")
    serve.add_argument("--kv-paged", action=argparse.BooleanOptionalAction,
                       default=None,
                       help="the continuous engine over a paged KV arena "
                            "(default: extra kv_paged, else off)")
    serve.add_argument("--kv-pages", type=int, default=None,
                       help="pages of the paged arena (default: the dense "
                            "engine's memory)")
    serve.add_argument("--max-logical-ctx", type=int, default=None,
                       help="long-context tier: serve prompts up to this "
                            "many tokens past the window (needs "
                            "--kv-paged; 0 disables)")
    serve.add_argument("--kv-offload", action=argparse.BooleanOptionalAction,
                       default=None,
                       help="host offload tier of the prefix store's pages "
                            "(default: extra kv_offload, else off)")
    serve.add_argument("--kv-offload-mb", type=float, default=None,
                       help="host budget of the offload arena, MiB "
                            "(default 256)")
    serve.add_argument("--long-prefill",
                       action=argparse.BooleanOptionalAction, default=None,
                       help="the long-context prefill's ring mode; without "
                            "an sp mesh it stands down, counted")
    serve.add_argument("--prefill-mode", choices=["chunked", "sp"],
                       default=None,
                       help="cold-prefill schedule; only chunked is ported")
    serve.add_argument("--spec-k", type=int, default=None,
                       help="speculative decoding in the continuous engine: "
                            "drafts per verify; 0/1 disables")
    serve.add_argument("--draft-mode", default=None,
                       choices=["lookup", "model", "aux", "off"],
                       help="draft provider for --spec-k rows (default "
                            "lookup)")
    serve.add_argument("--draft-exit", type=int, default=None,
                       help="layers the shallow-exit draft runs (default 1)")
    serve.add_argument("--mesh", default=None,
                       help="tensor-parallel serving; not ported (only "
                            "'off')")

    p = add("fleet", cmd_fleet, "serve a bundle from N supervised replicas "
                                "behind one router")
    p.add_argument("bundle")
    p.add_argument("--replicas", "-n", type=int, default=2,
                   help="supervised replicas (decode-class when "
                        "--prefill-replicas > 0, mixed otherwise; default 2)")
    p.add_argument("--prefill-replicas", type=int, default=0,
                   help="additional prefill-class replicas (NAME-p0..M-1): "
                        "cold prefills run there (/v1/kv/export) and their "
                        "K/V ships to the affinity-chosen decode replica; "
                        "0 = no phase split")
    p.add_argument("--port", type=int, default=8080,
                   help="router port, 0 picks a free one (replicas pick "
                        "their own; default 8080)")
    p.add_argument("--name", default=None,
                   help="fleet name; replicas deploy as NAME-r0..N-1")
    registry_flag(p)
    p.add_argument("--affinity", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="route by a rendezvous hash of the prompt's "
                        "leading token blocks (default on)")
    p.add_argument("--block", type=int, default=32,
                   help="affinity block width in tokens: keep equal to the "
                        "bundle's prefix_block (default 32)")
    p.add_argument("--probe-interval", type=float, default=1.0,
                   help="seconds between /healthz probes (default 1)")
    p.add_argument("--fail-threshold", type=int, default=1,
                   help="consecutive failures before ejection (default 1)")
    p.add_argument("--readmit-passes", type=int, default=2,
                   help="consecutive probe passes before an ejected "
                        "replica takes traffic again (default 2)")
    p.add_argument("--retries", type=int, default=2,
                   help="max re-sends onto different replicas (default 2)")
    p.add_argument("--saturation", type=int, default=8,
                   help="outstanding requests at which the affinity target "
                        "is bypassed (default 8)")
    p.add_argument("--hedge", default="off",
                   help="duplicate slow non-streamed requests: 'off', "
                        "'p95' or a threshold in ms (default off)")
    p.add_argument("--timeout", type=float, default=300.0,
                   help="per-replica deploy ready timeout, seconds")
    p.add_argument("--engine-watchdog", type=float, default=None,
                   help="per-replica engine watchdog, seconds: a wedged "
                        "replica is ejected at probe speed")
    p.add_argument("--attach", action="append", default=[],
                   metavar="NAME=URL[:class]",
                   help="attach an externally managed replica (probed, "
                        "ejected, readmitted, never restarted); repeatable; "
                        "class prefill|decode|mixed (default mixed)")
    p.add_argument("--spill-cap", type=int, default=64,
                   help="router spill-queue capacity; 0 disables "
                        "(default 64)")
    p.add_argument("--spill-max-wait", type=float, default=30.0,
                   help="max seconds a spilled request waits (default 30)")
    p.add_argument("--breaker-fails", type=int, default=5,
                   help="consecutive forward failures that open a "
                        "replica's breaker; 0 disables (default 5)")
    p.add_argument("--breaker-open-s", type=float, default=2.0,
                   help="seconds a breaker stays open before its "
                        "half-open probe (default 2)")
    p.add_argument("--retry-budget", type=float, default=0.2,
                   help="fleet-wide retry-to-primary ratio; 0 disables "
                        "(default 0.2)")
    p.add_argument("--fault-spec", default=None,
                   help="fleet fault injection (runtime/faults.py grammar "
                        "over route_connect, route_body, route_latency, "
                        "probe, kv_ship, kv_ship_chunk, session_failover); "
                        "default $LAMBDIPY_FLEET_FAULT")
    p.add_argument("--session-pin-budget", type=float, default=None,
                   help="per-replica MB of prefix cache open sessions may "
                        "pin")
    p.add_argument("--session-ttl", type=float, default=None,
                   help="per-replica absolute session pin lease, seconds")
    p.add_argument("--ship-window", type=int, default=4,
                   help="chunk frames in flight between a ship's export "
                        "and import legs; 0 = one blocking frame "
                        "(default 4)")
    p.add_argument("--autoscale", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="run the elastic controller (promote, demote, "
                        "spawn, retire, knob retunes)")
    p.add_argument("--autoscale-dry-run", action="store_true",
                   help="run the controller but only log its decisions "
                        "as intents")
    p.add_argument("--slo-p99-ms", type=float, default=250.0,
                   help="autoscale target: interactive queue-wait P99 "
                        "(default 250)")
    p.add_argument("--autoscale-interval", type=float, default=5.0,
                   help="seconds between controller ticks (default 5)")
    device_flag(p, "run the replicas")

    p = add("train", cmd_train, "train a registry model on a token file "
                                "(resumable)")
    p.add_argument("--model", default="llama-tiny",
                   help="registry model (llama-tiny / llama3-8b / "
                        "llama-moe-tiny ...)")
    p.add_argument("--data", required=True,
                   help="token file (.npy or raw int32 binary)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoint dir; re-running resumes from the latest "
                        "step")
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--mesh", default=None,
                   help='mesh axes, e.g. "dp=2" (default: every rank on dp): '
                        'one process per device, started with '
                        'LAMBDIPY_COORDINATOR / LAMBDIPY_NUM_PROCESSES / '
                        'LAMBDIPY_PROCESS_ID or torchrun; tp, ep, sp and pp '
                        'are not ported yet')
    p.add_argument("--seed", type=int, default=0)
    device_flag(p, "train")

    p = add("invoke", cmd_invoke, "invoke a deployment")
    p.add_argument("name")
    p.add_argument("--data", default="{}", help="JSON request body")
    p.add_argument("--stream", action="store_true",
                   help="stream the response (generate handlers): one JSON "
                        "line per decode segment")
    add("deployments", cmd_deployments, "list deployments")
    p = add("doctor", cmd_doctor, "diagnose the environment")
    registry_flag(p)
    p.add_argument("--state", default=None,
                   help="deployments state file (default: "
                        "~/.lambdipy-tpu-torch/deployments.json)")
    p.add_argument("--probe-timeout", type=float, default=90.0,
                   help="seconds before the card probe is declared wedged")
    device_flag(p, "diagnose for a run")
    p = add("bench", cmd_bench, "invoke latency percentiles of a "
                                "deployment")
    p.add_argument("name")
    p.add_argument("--data", default='{"random": true}',
                   help="JSON request body")
    p.add_argument("-n", dest="iters", type=int, default=50,
                   help="measured invokes")
    p.add_argument("--warmup", type=int, default=5)
    p = add("stop", cmd_stop, "stop a deployment")
    p.add_argument("name")
    return parser


def main(argv=None) -> int:
    from lambdipy_tpu_torch.bundle.format import BundleError
    from lambdipy_tpu_torch.recipes.schema import RecipeError
    from lambdipy_tpu_torch.resolve.registry import RegistryError
    from lambdipy_tpu_torch.resolve.releases import ReleaseError
    from lambdipy_tpu_torch.resolve.requirements import ResolutionError
    from lambdipy_tpu_torch.runtime.deploy import DeployError

    args = parser().parse_args(argv)
    try:
        args.fn(args)
    except Exception as e:
        # a FleetError can come only from a command that loaded the fleet:
        # importing it here would import torch (through the router) into
        # every command, `recipes` and `stop` included
        pool = sys.modules.get("lambdipy_tpu_torch.fleet.pool")
        if not isinstance(e, (CliError, RecipeError, BundleError,
                              RegistryError, ReleaseError, ResolutionError,
                              DeployError)) \
                and not (pool and isinstance(e, pool.FleetError)):
            raise
        # printed as the JAX CLI prints its ClickExceptions
        _echo(f"Error: {e}", err=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
