"""Command line of the port.

    python -m lambdipy_tpu_torch serve llama3-8b --port 8000

serves the model with random weights (seed 0) on the card through the
port's kernels (``--device cpu`` runs their plain PyTorch versions
instead) until interrupted. ``--extra`` overrides config fields, e.g.
``kv_quant=int8`` for the int8 KV cache, ``attn_backend=flash`` for
flash prefill, ``attn_backend=dense,matmul_backend=xla`` for the plain
reference model, ``batch_mode=continuous,kv_paged=1`` for the continuous
engine over a paged KV arena (``batch_max``, ``batch_segment``,
``kv_pages`` size it).
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
    args = parser.parse_args(argv)

    from lambdipy_tpu_torch.runtime.handlers import (HandlerContext,
                                                     generate_handler)
    from lambdipy_tpu_torch.runtime.server import BundleServer

    spec = {"model": args.model, "extra": _parse_extra(args.extra)}
    state = generate_handler(spec, HandlerContext(device=args.device))
    server = BundleServer(state, host=args.host, port=args.port)
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
