"""TOML parsing across interpreter versions.

``tomllib`` landed in the stdlib in Python 3.11; on 3.10 the same module
ships as the third-party ``tomli`` (identical API — tomllib IS tomli
vendored). Import the shim's ``tomllib`` name everywhere instead of the
stdlib module so the recipe/resolve stack collects on both interpreters:

    from lambdipy_tpu_torch.utils.toml_compat import tomllib
"""

from __future__ import annotations

try:
    import tomllib
except ModuleNotFoundError:  # Python < 3.11
    try:
        import tomli as tomllib
    except ModuleNotFoundError as e:  # pragma: no cover - env misconfig
        raise ModuleNotFoundError(
            "no TOML parser: Python < 3.11 needs the 'tomli' package "
            "(declared as tomli; python_version < \"3.11\")") from e

__all__ = ["tomllib"]
