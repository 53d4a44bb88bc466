"""Lazy package exports.

A package ``__init__`` of the port names what its JAX counterpart's
exports, but imports the module that holds a name only when the name is
first read. So importing a light module of a package (the broker, which
imports no torch) does not pull in the package's heavy ones.
"""

from __future__ import annotations

import importlib


def lazy(package: str, exports: dict[str, tuple[str, str | None]]):
    """The module ``__getattr__`` of a package whose public ``name`` is
    attribute ``attr`` of module ``module`` (the module itself when
    ``attr`` is None), for ``exports[name] = (module, attr)``."""

    def __getattr__(name: str):
        if name not in exports:
            raise AttributeError(
                f"module {package!r} has no attribute {name!r}")
        module, attr = exports[name]
        mod = importlib.import_module(module)
        value = mod if attr is None else getattr(mod, attr)
        setattr(importlib.import_module(package), name, value)
        return value

    return __getattr__
