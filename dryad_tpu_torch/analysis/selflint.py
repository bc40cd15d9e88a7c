"""Self-lint core: the dependency-free unused-import scan — the port of
``dryad_tpu/analysis/selflint.py``, pointed at ``dryad_tpu_torch/``.

``python -m dryad_tpu_torch.analysis --selfcheck`` runs ``ruff check``
where it is installed; this module is the always-available fallback: an
AST unused-import scan honoring ``noqa`` and ``__all__``-by-string
re-exports (pyflakes' F401) in ~60 lines.
"""

from __future__ import annotations

import ast
import pathlib
from typing import List, Tuple

__all__ = ["py_files", "unused_imports", "scan_package"]

PKG_DIR = pathlib.Path(__file__).resolve().parent.parent


def py_files(pkg: pathlib.Path = PKG_DIR) -> List[pathlib.Path]:
    return sorted(p for p in pkg.rglob("*.py"))


def unused_imports(path: pathlib.Path
                   ) -> List[Tuple[pathlib.Path, int, str, str]]:
    """(path, line, name, statement) for every import binding the module
    never reads.  Imports inside ``try:`` blocks (optional-dependency
    probes), ``noqa``-marked lines, underscore-prefixed names
    (side-effect/shim convention), and names re-exported by string
    (``__all__`` entries) are exempt."""
    src = path.read_text()
    lines = src.splitlines()
    tree = ast.parse(src, filename=str(path))

    bindings = {}  # name -> (lineno, text)
    in_try = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Try):
            for sub in ast.walk(node):
                in_try.add(id(sub))
    for node in ast.walk(tree):
        if not isinstance(node, (ast.Import, ast.ImportFrom)):
            continue
        if id(node) in in_try:
            continue
        if isinstance(node, ast.ImportFrom) \
                and node.module == "__future__":
            continue
        stmt = " ".join(
            lines[i].strip()
            for i in range(node.lineno - 1,
                           (node.end_lineno or node.lineno)))
        if "noqa" in stmt:
            continue
        for alias in node.names:
            if alias.name == "*":
                continue
            name = alias.asname or alias.name.split(".")[0]
            if name.startswith("_"):
                continue
            bindings[name] = (node.lineno, stmt)

    used = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    used |= {n.value for n in ast.walk(tree)
             if isinstance(n, ast.Constant) and isinstance(n.value, str)
             and n.value in bindings}  # __all__ re-exports by string
    return [(path, line, name, stmt)
            for name, (line, stmt) in sorted(bindings.items(),
                                             key=lambda kv: kv[1][0])
            if name not in used]


def scan_package(pkg: pathlib.Path = PKG_DIR) -> List[str]:
    """Unused-import findings over the whole package, rendered one per
    line (empty list = clean)."""
    out = []
    for path in py_files(pkg):
        for p, line, name, stmt in unused_imports(path):
            out.append(f"{p}:{line}: unused import {name!r} ({stmt})")
    return out
