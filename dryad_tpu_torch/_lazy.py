"""Lazy re-exports for the subpackages' ``__init__`` modules.

Each subpackage re-exports the names its JAX counterpart's ``__init__``
does, but imports a defining module only when one of its names is first
read: importing a subpackage loads nothing more than the package itself
(the JSONL tools already pay for the torch import) and makes no import
cycle."""

from __future__ import annotations

import importlib
import sys
from typing import Dict, Tuple

__all__ = ["lazy_exports"]


def lazy_exports(pkg: str, modules: Dict[str, Tuple[str, ...]]):
    """``(__getattr__, __dir__, __all__)`` for package ``pkg``:
    ``modules`` maps each defining module to the names it exports, or
    ``pkg`` itself to names that are its submodules."""
    names = {n: m for m, ns in modules.items() for n in ns}

    def __getattr__(name: str):
        mod = names.get(name)
        if mod is None:
            raise AttributeError(f"module {pkg!r} has no attribute {name!r}")
        if mod == pkg:
            value = importlib.import_module(f"{pkg}.{name}")
        else:
            value = getattr(importlib.import_module(mod), name)
        setattr(sys.modules[pkg], name, value)
        return value

    def __dir__():
        return sorted(set(vars(sys.modules[pkg])) | set(names))

    return __getattr__, __dir__, list(names)
