"""Build-time bundle warming of the port, the twin of
``lambdipy_tpu/runtime/warm.py``: ``build`` runs this module as a
subprocess on the freshly assembled bundle, on the recipe's device, and
records its last line in the manifest as ``warm``.

It boots the bundle once (``load_bundle(warmup=True)``, then waits for
the handler's background warm to end): on the card that builds the
kernel libraries into ``ops/_build.py``'s cache, so a deployment's
``compile_cache`` stage is a hit and skips ``nvcc``, and it checks that
the handler serves. JAX's warm fills a compilation cache shipped inside
the bundle; a CUDA graph cannot be saved and the kernel libraries are
tied to one toolkit and architecture, so the port ships none:
``cache_entries`` counts the bundle's ``compile_cache/`` as JAX's does,
and is 0.

Usage: ``python -m lambdipy_tpu_torch.runtime.warm <bundle_dir>``
(``LAMBDIPY_PLATFORM=cpu``: on the CPU, as the server).
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path


def warm_bundle(bundle_dir: Path, device=None) -> dict:
    from lambdipy_tpu_torch.ops import _build
    from lambdipy_tpu_torch.runtime.loader import load_bundle

    bundle_dir = Path(bundle_dir)
    t0 = time.monotonic()
    report = load_bundle(bundle_dir, warmup=True, device=device)
    # the warmup invoke starts the handler's background warm: let it end
    # (its captures are the handler serving too) before the process does;
    # the build's LAMBDIPY_WARM_TIMEOUT bounds the whole process
    warming = getattr(report.state, "warming_fn", None)
    while warming is not None and warming():
        time.sleep(0.05)
    cache = bundle_dir / "compile_cache"
    return {
        "warmed": True,
        "wall_s": round(time.monotonic() - t0, 2),
        "stages": report.stages,
        "cache_entries": (sum(1 for p in cache.rglob("*") if p.is_file())
                          if cache.is_dir() else 0),
        # the kernel libraries this boot compiled (none when the build
        # cache already held them)
        "kernels_built": sorted(_build.build_logs),
    }


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: warm <bundle_dir>", file=sys.stderr)
        return 2
    device = "cpu" if os.environ.get("LAMBDIPY_PLATFORM") == "cpu" else None
    print(json.dumps(warm_bundle(Path(argv[0]), device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
