"""Canonicalization: stable SEMANTIC fingerprints for query plans — the
port of ``dryad_tpu/analysis/canon.py``.

Two queries that mean the same thing should share plans and results, so
this pass reduces a plan to a canonical form:

* **bound SQL plans** (:func:`canonical_select` over a
  ``sql.binder.BoundSelect``): alias-insensitive renaming (FROM-order
  positional aliases ``t0, t1, ...``), commutative/associative
  predicate and projection ordering, constant folding in rowexpr trees
  (``sql.rowexpr.fold_prog``), NNF push-down of ``NOT``, canonical
  comparison direction, and dead-column pruning of scan renames;
* **api.Dataset DAGs** (:func:`dag_fingerprints` over ``plan/expr``
  nodes): a structural bottom-up hash whose rowexpr callables
  canonicalize by content while opaque Python callables fingerprint by
  identity — unknown code never unifies, which is the sound default.

The result is a 16-hex *semantic fingerprint*: equal fingerprints mean
the plans compute the same function over the same source content
(per-table content identity rides along via
``sql.catalog.table_fingerprint``).  The forms are the JAX package's
byte for byte, so the committed goldens (``docs/plans/*.canon.json``)
hold for both packages; ``python -m dryad_tpu_torch.analysis
--selfcheck`` compares them.  A DAG fingerprint names a registered
callable by its import ref (``fn:module:qualname``), and so names its
package: the two packages' DAG fingerprints agree only where no
callable is named.

Soundness notes: only bitwise-safe rewrites are applied.  Two-operand
commutation of ``+``/``*``/``=``/``!=`` is IEEE-exact; AND/OR chains
flatten, sort, and dedup (idempotent boolean algebra); ``NOT`` folds
through comparisons because the SQL type system has no NULLs.
Float *re-association* across operator levels is NOT performed — it is
not bit-stable, and fingerprint-equal queries must produce
bit-identical results.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, List, Optional

__all__ = ["canon_prog", "canonical_select", "canonical_form_json",
           "semantic_fingerprint", "scan_prefix", "conjuncts_of",
           "dag_fingerprints", "node_fingerprint"]


# -- rowexpr program canonicalization -----------------------------------


def _key(prog: List) -> str:
    """Stable sort key for canonical operand ordering."""
    return json.dumps(prog, sort_keys=True, default=str)


def _flatten(op: str, prog: List, out: List[List]) -> None:
    if prog[0] == "bin" and prog[1] == op:
        _flatten(op, prog[2], out)
        _flatten(op, prog[3], out)
    else:
        out.append(prog)


def _not_of(x: List) -> List:
    """NOT over an already-canonical program, pushed to NNF.  Folding
    NOT through comparisons is sound here: SQL types carry no NULLs
    and numerics are totally ordered."""
    if x[0] == "lit":
        return ["lit", not x[1], "bool"]
    if x[0] == "not":
        return x[1]
    if x[0] == "bin":
        op = x[1]
        inv = {"=": "!=", "!=": "=", "<": ">=", "<=": ">"}
        if op in inv:
            return _norm(["bin", inv[op], x[2], x[3]])
        if op in ("and", "or"):
            other = "or" if op == "and" else "and"
            return _norm(["bin", other, _not_of(x[2]), _not_of(x[3])])
    return ["not", x]


def _norm(prog: List) -> List:
    head = prog[0]
    if head in ("col", "lit", "const"):
        return list(prog)
    if head == "neg":
        return ["neg", _norm(prog[1])]
    if head == "not":
        return _not_of(_norm(prog[1]))
    # head == "bin"
    op, a, b = prog[1], _norm(prog[2]), _norm(prog[3])
    if op in ("and", "or"):
        # associative + commutative + idempotent: flatten the whole
        # chain, dedup, sort, rebuild left-deep — conjunct order and
        # repetition vanish from the fingerprint
        terms: List[List] = []
        _flatten(op, ["bin", op, a, b], terms)
        uniq = {_key(t): t for t in terms}
        keys = sorted(uniq)
        out = uniq[keys[0]]
        for k in keys[1:]:
            out = ["bin", op, out, uniq[k]]
        return out
    if op in ("+", "*", "=", "!="):
        # two-operand commutation only (bitwise-exact for IEEE floats;
        # re-association across levels is not, so chains keep shape)
        if _key(b) < _key(a):
            a, b = b, a
        return ["bin", op, a, b]
    if op in (">", ">="):
        # canonical comparison direction: everything becomes < / <=
        return ["bin", "<" if op == ">" else "<=", b, a]
    return ["bin", op, a, b]


def canon_prog(prog: List) -> List:
    """Canonical form of a row-expression program: constants folded
    (``sql.rowexpr.fold_prog``), NOT pushed to NNF, AND/OR chains
    flattened + sorted + deduped, commutative operands ordered,
    comparisons directed ``< / <=``."""
    from dryad_tpu_torch.sql.rowexpr import fold_prog
    return _norm(fold_prog(list(prog)))


def conjuncts_of(prog: Optional[List]) -> List[List]:
    """Canonical conjunct list of a (canonicalized) predicate —
    ``None`` / folded-true predicates yield ``[]``, the always-true
    filter (subsume.py's implication checks work over this)."""
    if prog is None:
        return []
    c = canon_prog(prog)
    if c == ["lit", True, "bool"]:
        return []
    out: List[List] = []
    _flatten("and", c, out)
    return out


# -- bound SQL plan canonicalization ------------------------------------


def _rename_cols(prog: List, phys_map: Dict[str, str]) -> List:
    head = prog[0]
    if head == "col":
        return ["col", phys_map.get(prog[1], prog[1])]
    if head in ("lit", "const"):
        return list(prog)
    if head in ("not", "neg"):
        return [head, _rename_cols(prog[1], phys_map)]
    return ["bin", prog[1], _rename_cols(prog[2], phys_map),
            _rename_cols(prog[3], phys_map)]


def canonical_select(catalog, bound) -> Dict[str, Any]:
    """Canonical JSON-able form of a ``BoundSelect``; see module
    docstring for the rewrite set.  ``catalog`` supplies per-table
    content fingerprints (``sql.catalog.table_fingerprint``), so the
    form identifies the *data* too — equal canonical forms compute
    the same result, not just the same function."""
    from dryad_tpu_torch.sql.catalog import table_fingerprint
    from dryad_tpu_torch.sql.rowexpr import prog_columns

    # alias-insensitive renaming: positional canonical aliases in FROM
    # order (join order is semantically significant — it is preserved)
    alias_map = {bound.base_alias: "t0"}
    for i, j in enumerate(bound.joins):
        alias_map[j.alias] = f"t{i + 1}"

    def canon_phys(phys: str) -> str:
        alias, _, col = phys.partition(".")
        return f"{alias_map[alias]}.{col}" if alias in alias_map \
            else phys

    all_renames = [(bound.base_alias, bound.base_renames)] \
        + [(j.alias, j.renames) for j in bound.joins]
    phys_map = {phys: canon_phys(phys)
                for _, renames in all_renames for phys in renames}

    def cp(prog: Optional[List]) -> Optional[List]:
        return None if prog is None \
            else canon_prog(_rename_cols(prog, phys_map))

    # referenced physical columns — dead-column pruning of scan renames
    referenced: set = set()
    if bound.where is not None:
        referenced |= prog_columns(bound.where)
    for j in bound.joins:
        referenced |= set(j.left_keys) | set(j.right_keys)
    if bound.grouped:
        for prog in (bound.pre_projection or {}).values():
            referenced |= prog_columns(prog)
        referenced |= set(bound.group_keys)
    else:
        for prog in bound.outputs.values():
            referenced |= prog_columns(prog)

    tables = []
    for (alias, renames), tname in zip(
            all_renames, [bound.base_table]
            + [j.table for j in bound.joins]):
        t = catalog.get(tname)
        cols = sorted(renames[p] for p in renames if p in referenced)
        tables.append({"name": tname, "alias": alias_map[alias],
                       "content": (table_fingerprint(t)
                                   if t is not None else "?"),
                       "columns": cols})

    joins = []
    for j in bound.joins:
        pairs = sorted((canon_phys(lk), canon_phys(rk))
                       for lk, rk in zip(j.left_keys, j.right_keys))
        joins.append({"how": j.how, "on": [list(p) for p in pairs]})

    form: Dict[str, Any] = {
        "tables": tables,
        "joins": joins,
        "where": cp(bound.where),
        "outputs": {name: cp(bound.outputs[name])
                    for name in sorted(bound.outputs)},
        "output_types": {name: bound.output_types[name]
                         for name in sorted(bound.output_types)},
        "distinct": bound.distinct,
        "order_by": [[name, bool(desc)] for name, desc
                     in bound.order_by],
        "limit": bound.limit,
        "emit_every": bound.emit_every,
    }
    if bound.grouped:
        # aggregates key by OUTPUT name with their canonical input
        # program inlined — the synthesized __sqlaggN numbering (a
        # SELECT-order artifact) disappears from the form
        pre = bound.pre_projection or {}
        aggs = {}
        for name in sorted(bound.aggs):
            kind, in_col = bound.aggs[name]
            aggs[name] = {"kind": kind,
                          "input": cp(pre[in_col])
                          if in_col is not None and in_col in pre
                          else None}
        form["group_keys"] = sorted(canon_phys(k)
                                    for k in bound.group_keys)
        form["aggs"] = aggs
        form["having"] = cp(bound.having)
    return form


def canonical_form_json(catalog, bound) -> str:
    """Deterministic pretty JSON of the canonical form — the committed
    golden-file format (docs/plans/*.canon.json, drift-gated by the
    analysis selfcheck)."""
    return json.dumps(canonical_select(catalog, bound), indent=1,
                      sort_keys=True) + "\n"


def semantic_fingerprint(catalog, bound) -> str:
    """16-hex semantic fingerprint of a bound statement: sha256 over
    the canonical form.  Equal fingerprints => same function over the
    same source content => shareable plans/results (a SQL
    plan-cache key)."""
    blob = json.dumps(canonical_select(catalog, bound), sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def scan_prefix(catalog, bound) -> Optional[Dict[str, Any]]:
    """Canonical scan+filter prefix of a SINGLE-TABLE statement: the
    unit analysis/subsume.py proves containment over.  ``None`` for
    joined statements (their filters may straddle tables — prefix
    containment is only claimed where it is trivially sound).

    Keys: ``table`` / ``content`` (source identity), ``columns``
    (source column names the query reads), ``filter`` (canonical
    conjunct list over SOURCE column names; empty = always-true)."""
    from dryad_tpu_torch.sql.catalog import table_fingerprint
    from dryad_tpu_torch.sql.rowexpr import prog_columns
    if bound.joins:
        return None
    src_map = {phys: col for phys, col in bound.base_renames.items()}
    referenced: set = set()
    if bound.where is not None:
        referenced |= prog_columns(bound.where)
    if bound.grouped:
        for prog in (bound.pre_projection or {}).values():
            referenced |= prog_columns(prog)
        referenced |= set(bound.group_keys)
    else:
        for prog in bound.outputs.values():
            referenced |= prog_columns(prog)
    t = catalog.get(bound.base_table)
    filt = [] if bound.where is None else conjuncts_of(
        _rename_cols(bound.where, src_map))
    return {"table": bound.base_table,
            "content": table_fingerprint(t) if t is not None else "?",
            "columns": sorted(src_map[p] for p in referenced
                              if p in src_map),
            "filter": filt}


# -- api.Dataset DAG fingerprints ---------------------------------------


def _val_fp(v: Any) -> str:
    """Canonical fingerprint of one node param value.  Rowexpr
    callables canonicalize by content; registered callables by import
    ref; anything opaque by object identity (never unifies across
    distinct objects — sound by construction)."""
    from dryad_tpu_torch.sql.rowexpr import Predicate, Projector
    if isinstance(v, Predicate):
        return "pred:" + _key(canon_prog(v.prog))
    if isinstance(v, Projector):
        return "proj:" + _key({n: canon_prog(p) for n, p in
                               sorted(v.outputs.items())})
    if hasattr(v, "__ship_payload__") \
            and hasattr(type(v), "__from_payload__"):
        return (f"ship:{type(v).__qualname__}:"
                f"{json.dumps(v.__ship_payload__(), sort_keys=True)}")
    if callable(v):
        from dryad_tpu_torch.plan.serialize import import_ref
        ref = import_ref(v)
        return f"fn:{ref}" if ref is not None else "opaque:%x" % id(v)
    if isinstance(v, (list, tuple)):
        return "[" + ",".join(_val_fp(x) for x in v) + "]"
    if isinstance(v, dict):
        return "{" + ",".join(f"{k}={_val_fp(v[k])}"
                              for k in sorted(v)) + "}"
    return repr(v)


def _column_bytes(v: Any) -> bytes:
    """The bytes numpy gives for one host column.  A tensor is read to
    the host once (``.cpu()``: a device column costs one copy), so a
    column hashes the same wherever it lies."""
    import numpy as np
    import torch
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.ascontiguousarray(v).tobytes()


def _source_fp(data: Any, host: Any) -> str:
    """Content identity of a Source node's data: its host columns' bytes
    (numpy's, for arrays and tensors alike), else a store spec's path."""
    if host is not None:
        h = hashlib.sha256()
        for col in sorted(host):
            v = host[col]
            h.update(col.encode())
            try:
                if isinstance(v, (list, tuple)):
                    for x in v:
                        h.update(x if isinstance(x, bytes)
                                 else str(x).encode())
                        h.update(b"\x00")
                else:
                    h.update(_column_bytes(v))
            except (TypeError, ValueError, RuntimeError):
                return "opaque:%x" % id(data)
        return "host:" + h.hexdigest()[:16]
    spec = getattr(data, "spec", None)
    if isinstance(spec, dict):
        path = spec.get("path") or spec.get("paths")
        if path is not None:
            return "spec:" + json.dumps(
                {k: spec[k] for k in sorted(spec)
                 if isinstance(spec[k], (str, int, float, bool, list,
                                         tuple))}, default=str)
    return "opaque:%x" % id(data)


def dag_fingerprints(root) -> Dict[int, str]:
    """Bottom-up semantic fingerprint per node of a ``plan/expr`` DAG
    (node id -> 16-hex fp).  Hash = node kind + canonical params +
    parent fingerprints + source content identity; spans and node ids
    are excluded (two lowerings of one query fingerprint equal)."""
    import dataclasses as _dc

    from dryad_tpu_torch.plan import expr as E
    fps: Dict[int, str] = {}
    for node in E.walk(root):
        items = [type(node).__name__]
        items.extend(fps[p.id] for p in node.parents)
        for f in _dc.fields(node):
            if f.name in ("parents", "id", "span"):
                continue
            v = getattr(node, f.name)
            if f.name == "data":       # Source payload
                v = _source_fp(v, getattr(node, "host", None))
                items.append(f"data={v}")
            elif f.name == "host":
                continue               # folded into data
            else:
                items.append(f"{f.name}={_val_fp(v)}")
        blob = "|".join(items)
        fps[node.id] = hashlib.sha256(blob.encode()).hexdigest()[:16]
    return fps


def node_fingerprint(root) -> str:
    """Semantic fingerprint of a whole Dataset DAG (its root node)."""
    return dag_fingerprints(root)[root.id]
