"""Lowering: BoundSelect -> api.Dataset operator chain — the port of
``dryad_tpu/sql/lower.py``.

A bound SQL statement becomes the SAME ``Dataset`` calls a Python user
would write, so every query inherits the whole stack: the pre-submit
lint and DTA2xx cost forecasts, ``EXPLAIN [COST]`` via
``Dataset.explain()``, adaptive stage-boundary rewrites, streamed
sources, and every exchange kernel of the joins, group-bys and sorts.

Shape of the lowered chain::

    FROM t [JOIN ...]      catalog.dataset() roots + rename Projector
                           (every column becomes ``alias.col``)
    WHERE                  .where(Predicate)
    GROUP BY + aggregates  pre-Projector (keys + agg-input exprs)
                           -> .group_by(keys, aggs) [-> .where(HAVING)]
    SELECT list            final Projector (output names)
    DISTINCT               .distinct()
    ORDER BY               .order_by([(name, desc)])
    LIMIT                  .take(n)

All callables are :mod:`dryad_tpu_torch.sql.rowexpr` programs —
shippable as data (plan/serialize.ship_ref_of) and content-
fingerprinted, so a re-lowered query finds its stages' measured send
slots.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from dryad_tpu_torch.sql.binder import BoundSelect
from dryad_tpu_torch.sql.catalog import Catalog
from dryad_tpu_torch.sql.rowexpr import Predicate, Projector

__all__ = ["lower", "GLOBAL_AGG_KEY"]

GLOBAL_AGG_KEY = "__sqlagg_key"


def _rename_projector(renames: Dict[str, str]) -> Projector:
    return Projector({phys: ["col", src] for phys, src in
                      renames.items()})


def _stamp(ds, span):
    """Point the node's provenance INTO THE QUERY TEXT (file slot =
    query origin, func slot = ``sql:<col>``): analyzer findings and
    runtime errors for SQL-lowered nodes quote the query, and offline
    plan JSON is deterministic regardless of which Python frame drove
    the lowering."""
    if span is not None:
        object.__setattr__(ds.node, "span",
                           (span.file, span.line, f"sql:{span.col}"))
    return ds


def lower(ctx, catalog: Catalog, bound: BoundSelect, loader=None
          ) -> Tuple[Any, Dict[int, str]]:
    """(dataset, source-handle map) for a bound statement under ``ctx``
    (api.Context or sql.catalog.SchemaContext).  The handle map
    (``id(Source.data) -> table name``) maps a plan's source slots back
    to tables (``source_tables``).  ``loader`` (optional,
    ``name -> PData``) is forwarded to :meth:`Catalog.dataset` (one
    loaded table shared by several queries)."""
    handles: Dict[int, str] = {}

    def root(table: str, alias: str, renames: Dict[str, str], span):
        ds, data = catalog.dataset(ctx, table, loader=loader)
        handles[id(data)] = table
        _stamp(ds, span)
        return _stamp(ds.select(_rename_projector(renames),
                                label=f"sql-scan {alias}"), span)

    cur = root(bound.base_table, bound.base_alias, bound.base_renames,
               bound.span)
    for j in bound.joins:
        right = root(j.table, j.alias, j.renames, j.span)
        cur = _stamp(cur.join(right, j.left_keys, j.right_keys,
                              how=j.how), j.span)
    if bound.where is not None:
        cur = _stamp(cur.where(Predicate(bound.where),
                               label="sql-where"),
                     bound.where_span or bound.span)
    if bound.grouped:
        pre = dict(bound.pre_projection or {})
        keys = list(bound.group_keys)
        if not keys:
            # global aggregate: one constant key, dropped again by the
            # final projection (api.Dataset.aggregate pattern)
            pre[GLOBAL_AGG_KEY] = ["const", 0, "int"]
            keys = [GLOBAL_AGG_KEY]
        cur = _stamp(cur.select(Projector(pre), label="sql-agg-in"),
                     bound.span)
        cur = _stamp(cur.group_by(keys, dict(bound.aggs)), bound.span)
        if bound.having is not None:
            cur = _stamp(cur.where(Predicate(bound.having),
                                   label="sql-having"),
                         bound.having_span or bound.span)
    cur = _stamp(cur.select(Projector(bound.outputs),
                            label="sql-select"), bound.span)
    if bound.distinct:
        cur = _stamp(cur.distinct(), bound.span)
    if bound.order_by:
        cur = _stamp(cur.order_by(list(bound.order_by)), bound.span)
    if bound.limit is not None:
        cur = _stamp(cur.take(bound.limit), bound.span)
    # any node a Context helper built internally (e.g. a streamed
    # from_store chain) still carries a Python creation span — restamp
    # everything reachable so the whole SQL plan points at the query
    from dryad_tpu_torch.plan import expr as E
    for n in E.walk(cur.node):
        sp = getattr(n, "span", None)
        if sp is None or not str(sp[2] if sp else "").startswith("sql:"):
            object.__setattr__(n, "span",
                               (bound.span.file, bound.span.line,
                                f"sql:{bound.span.col}")
                               if bound.span is not None else None)
    return cur, handles


def source_tables(graph, handles: Dict[int, str]
                  ) -> Dict[str, Optional[str]]:
    """Map a planned StageGraph's source slots ("sid:leg", the key
    format of ``graph_from_json``'s ``sources``) back to catalog table
    names via the handle identities recorded by :func:`lower`."""
    out: Dict[str, Optional[str]] = {}
    for st in graph.stages:
        for li, leg in enumerate(st.legs):
            if isinstance(leg.src, tuple) and leg.src[0] == "source":
                out[f"{st.id}:{li}"] = handles.get(id(leg.src[1]))
    return out
