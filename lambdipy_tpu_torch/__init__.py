"""lambdipy-tpu-torch: the PyTorch/CUDA port of the serving path.

The package mirrors :mod:`lambdipy_tpu`'s module names (``models/llama.py``
is the twin of ``lambdipy_tpu/models/llama.py``) and runs on an NVIDIA
Hopper card. Every Pallas kernel of the JAX package on the ported path
becomes a hand-written CUDA kernel under ``csrc/``, built with ``nvcc``
at first use and bound with ``ctypes`` (``ops/_build.py``).

The port imports ``torch``, numpy and the standard library only — never
``jax`` or anything under ``lambdipy_tpu``. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; with no card and no device
asked for they raise instead of carrying on on the CPU.

Subpackages are imported lazily, so importing the package stays cheap.
"""

from __future__ import annotations

import importlib

__version__ = "0.1.0"

_SUBMODULES = ("models", "ops", "runtime", "utils")


def __getattr__(name: str):
    if name in _SUBMODULES:
        mod = importlib.import_module(f"{__name__}.{name}")
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_SUBMODULES))
