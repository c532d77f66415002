"""The serve runtime's numerics switch, the twin of ``apply_debug_env`` in
``lambdipy_tpu/utils/debug.py``. ``LAMBDIPY_DEBUG_NANS=1`` and
``LAMBDIPY_DEBUG_INFS=1`` turn on JAX's ``debug_nans`` / ``debug_infs``
there; the port has no such sanitizer yet, so boot raises on either
instead of serving without the check that was asked for."""

from __future__ import annotations

import os


def apply_debug_env() -> dict:
    """The flags applied (for the boot report): ``{}`` when neither
    variable is set; raises ``ValueError`` when one is."""
    asked = [var for var in ("LAMBDIPY_DEBUG_NANS", "LAMBDIPY_DEBUG_INFS")
             if os.environ.get(var) == "1"]
    if asked:
        raise ValueError(
            f"{', '.join(f'{v}=1' for v in asked)} needs a feature the port "
            "does not have yet (a numerics sanitizer); unset it to serve")
    return {}
