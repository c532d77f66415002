"""Numerics debug checks, the twin of ``lambdipy_tpu/utils/debug.py``.

- :func:`debug_numerics`: a scoped switch (tests, ``TrainerConfig
  .debug_numerics=True``). While it is on, the train step
  (``train/step.py``) checks every output of each step (metrics, grads,
  new params, optimizer state) and raises ``FloatingPointError`` naming
  the first leaf that holds a NaN (and an Inf, when asked). JAX's
  ``debug_nans`` re-runs the step op by op and raises at the producing
  primitive; here the check runs after the step, so the error names the
  leaf, not the op. One device sync per step: a debug mode.
- :func:`apply_debug_env`: the serve runtime's switch.
  ``LAMBDIPY_DEBUG_NANS=1`` and ``LAMBDIPY_DEBUG_INFS=1`` turn on JAX's
  ``debug_nans`` / ``debug_infs`` for a whole serving process; the port
  has no per-op sanitizer for serving, so boot raises on either instead
  of serving without the check that was asked for.
"""

from __future__ import annotations

import contextlib
import os

import torch

# the checks in force: {"nans": bool, "infs": bool}
_ACTIVE = {"nans": False, "infs": False}


@contextlib.contextmanager
def debug_numerics(nans: bool | None = True, infs: bool | None = None):
    """Check for NaN (and optionally Inf) in the enclosed scope; prior
    values are restored on exit. ``None`` leaves a check as it is, so the
    context never weakens checking that an outer scope turned on."""
    prior = dict(_ACTIVE)
    if nans is not None:
        _ACTIVE["nans"] = nans
    if infs is not None:
        _ACTIVE["infs"] = infs
    try:
        yield
    finally:
        _ACTIVE.update(prior)


def numerics_checked() -> bool:
    return _ACTIVE["nans"] or _ACTIVE["infs"]


def check_numerics(named: list) -> None:
    """Raise ``FloatingPointError`` naming the first ``(name, tensor)`` of
    ``named`` that holds a NaN (or an Inf, when that check is on); one
    device sync for the whole list."""
    if not named:
        return
    flags = []
    for _, t in named:
        t = t.detach()
        bad = torch.zeros((), dtype=torch.bool, device=t.device)
        if _ACTIVE["nans"]:
            bad = bad | torch.isnan(t).any()
        if _ACTIVE["infs"]:
            bad = bad | torch.isinf(t).any()
        flags.append(bad.to(named[0][1].device))
    hits = torch.stack(flags).tolist()
    for (name, t), hit in zip(named, hits):
        if hit:
            what = ("nan" if _ACTIVE["nans"] and bool(torch.isnan(t).any())
                    else "inf")
            raise FloatingPointError(f"invalid value ({what}) in {name}")


def apply_debug_env() -> dict:
    """The flags applied (for the boot report): ``{}`` when neither
    variable is set; raises ``ValueError`` when one is."""
    asked = [var for var in ("LAMBDIPY_DEBUG_NANS", "LAMBDIPY_DEBUG_INFS")
             if os.environ.get(var) == "1"]
    if asked:
        raise ValueError(
            f"{', '.join(f'{v}=1' for v in asked)} needs a feature the port "
            "does not have yet (a numerics sanitizer for serving); unset it "
            "to serve")
    return {}
