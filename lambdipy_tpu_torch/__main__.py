"""Command line of the port.

    python -m lambdipy_tpu_torch serve <bundle_dir> --port 8000
    python -m lambdipy_tpu_torch serve llama3-8b --port 8000

A directory holding a ``manifest.json`` is a bundle (one the JAX builder
made, or one written without JAX): it boots through
``runtime/loader.py`` with its cold-start stages and serves its weights,
and the readiness line ``{"ready", "port", "sched_policy",
"cold_start"}`` goes to stdout, as the JAX CLI prints it. Any other name
is a model of the port's registry, served with random weights (seed 0)
and ``--extra`` overrides of its config, e.g. ``kv_quant=int8``,
``attn_backend=flash``, ``attn_backend=dense,matmul_backend=xla`` (the
plain reference model), ``batch_mode=continuous,kv_paged=1``. Either
runs on the card through the port's kernels (``--device cpu`` runs their
plain PyTorch versions instead) until SIGTERM, which drains.

The flags are the JAX CLI's ``serve`` flags whose features are ported.
The scheduler's reach the server; the others set the ``LAMBDIPY_*``
variables the handler reads, with JAX's precedence
(``lambdipy_tpu/cli.py:584-612``). ``--mesh`` and ``--prefill-mode sp``
ask for features the port does not have and exit before boot.
``POST /shutdown`` drains and stops the server.
"""

from __future__ import annotations

import argparse
import os
import sys
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


def _parse_extra(text: str) -> dict:
    extra = {}
    for item in filter(None, (text or "").split(",")):
        key, sep, value = item.partition("=")
        if not sep:
            raise SystemExit(f"--extra wants key=value pairs, got {item!r}")
        extra[key.strip()] = value.strip()
    return extra


def parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m lambdipy_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    serve = sub.add_parser("serve", help="serve a bundle or a model over "
                                         "HTTP")
    serve.add_argument("target", metavar="bundle_or_model",
                       help="a bundle directory (holding manifest.json) or "
                            "a model name of the port's registry")
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
    return parser


def apply_flags(args: argparse.Namespace) -> None:
    """Set the ``LAMBDIPY_*`` variable of every flag given; a flag that
    asks for an unported feature exits with the handler's message before
    boot."""
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


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    apply_flags(args)

    from lambdipy_tpu_torch.runtime.server import (BundleServer,
                                                   serve_until_term)

    sched = {"policy": args.sched_policy,
             "max_concurrency": args.sched_concurrency,
             "queue_cap": args.sched_queue_cap, "rate": args.sched_rate,
             "burst": args.sched_burst}
    target = Path(args.target)
    if target.is_dir() and (target / "manifest.json").is_file():
        if args.extra:
            raise SystemExit("serve: --extra overrides a model's config; a "
                             "bundle's config is its manifest")
        server = BundleServer.from_bundle(target, host=args.host,
                                          port=args.port, sched=sched,
                                          device=args.device)
        ready = {"ready": True, "port": server.port,
                 "sched_policy": server.sched.policy.name,
                 "cold_start": server.boot.stages}
    else:
        from lambdipy_tpu_torch.runtime.handlers import (HandlerContext,
                                                         generate_handler)

        state = generate_handler(
            {"model": args.target, "extra": _parse_extra(args.extra)},
            HandlerContext(device=args.device))
        server = BundleServer(state, host=args.host, port=args.port,
                              sched=sched)
        ready = {"ready": True, "port": server.port,
                 "sched_policy": server.sched.policy.name,
                 "model": args.target}
    serve_until_term(server, ready)
    return 0


if __name__ == "__main__":
    sys.exit(main())
