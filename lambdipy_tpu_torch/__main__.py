"""Command line of the port.

    python -m lambdipy_tpu_torch serve llama3-8b --port 8000

serves the model with random weights (seed 0) on the card through the
port's kernels (``--device cpu`` runs their plain PyTorch versions
instead) until interrupted. ``--extra`` overrides config fields, e.g.
``kv_quant=int8`` for the int8 KV cache, ``attn_backend=flash`` for
flash prefill, ``attn_backend=dense,matmul_backend=xla`` for the plain
reference model, ``batch_mode=continuous,kv_paged=1`` for the continuous
engine over a paged KV arena (``batch_max``, ``batch_segment``,
``kv_pages`` size it). The scheduler's and the engine's flags are the
JAX CLI's: ``--sched-policy``, ``--sched-concurrency``,
``--sched-queue-cap``, ``--sched-rate``, ``--sched-burst`` and
``--pipeline-depth``. ``POST /shutdown`` drains and stops the server.
"""

from __future__ import annotations

import argparse
import sys


def _parse_extra(text: str) -> dict:
    extra = {}
    for item in filter(None, (text or "").split(",")):
        key, sep, value = item.partition("=")
        if not sep:
            raise SystemExit(f"--extra wants key=value pairs, got {item!r}")
        extra[key.strip()] = value.strip()
    return extra


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m lambdipy_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    serve = sub.add_parser("serve", help="serve a model over HTTP")
    serve.add_argument("model")
    serve.add_argument("--extra", default="",
                       help="comma-separated config overrides, key=value")
    serve.add_argument("--device", default=None,
                       help="default: the CUDA card")
    serve.add_argument("--host", default="127.0.0.1")
    serve.add_argument("--port", type=int, default=8000)
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
    serve.add_argument("--pipeline-depth", type=int, default=None,
                       help="decode segments the continuous engine keeps "
                            "on the card: 1 = the synchronous loop "
                            "(default: extra pipeline_depth, else 2)")
    args = parser.parse_args(argv)

    from lambdipy_tpu_torch.runtime.handlers import (HandlerContext,
                                                     generate_handler)
    from lambdipy_tpu_torch.runtime.server import BundleServer

    extra = _parse_extra(args.extra)
    if args.pipeline_depth is not None:
        extra.setdefault("pipeline_depth", str(args.pipeline_depth))
    spec = {"model": args.model, "extra": extra}
    state = generate_handler(spec, HandlerContext(device=args.device))
    server = BundleServer(state, host=args.host, port=args.port, sched={
        "policy": args.sched_policy,
        "max_concurrency": args.sched_concurrency,
        "queue_cap": args.sched_queue_cap, "rate": args.sched_rate,
        "burst": args.sched_burst})
    print(f"serving {args.model} on {server.url}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.httpd.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
