"""SQL front end: declarative queries compiling to the plan DAG — the
port of ``dryad_tpu/sql``.

A dependency-free SQL compiler — lexer -> recursive-descent parser ->
binder / catalog -> lowering — whose output is ordinary
:class:`api.Dataset` calls, so a query inherits the pre-submit lint,
``EXPLAIN [COST]``, adaptive rewrites and every kernel of the joins,
group-bys and sorts it lowers to.  ``EXPLAIN ANALYZE`` runs the query
once and appends its measured per-stage actuals against the cost model
(``Dataset.explain(analyze=True)``, ``obs/analyze.py``).

Entry points::

    from dryad_tpu_torch import Context, sql
    cat = sql.Catalog().register_columns("t", {"k": ..., "v": ...})
    ds  = sql.query(Context(), cat, "SELECT k, SUM(v) AS s FROM t GROUP BY k")
    ds.collect()                      # ... or .explain(cost=True), etc.

    python -m dryad_tpu_torch.sql --catalog cat.json          # REPL
    python -m dryad_tpu_torch.sql --catalog cat.json \\
        -e "EXPLAIN COST SELECT ..."                           # one-shot

The Context runs on the CUDA card unless it is given ``device="cpu"``;
``offline_explain`` / ``offline_plan_json`` (and the CLI's plain
``EXPLAIN``) plan against a schema-only catalog with no device at all.
Compile errors raise :class:`SqlError` — ONE exception carrying every
DTA3xx finding with line:column spans into the query text.  Every
successful lowering emits ``sql_query`` (normalized query text + catalog
fingerprint) and ``sql_lowered`` events.  ``EMIT EVERY`` (a standing
query: it needs ``inc/``) parses and binds but is refused with
``NotImplementedError``: that layer is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

from dryad_tpu_torch.sql.binder import BoundSelect, bind
from dryad_tpu_torch.sql.catalog import (Catalog, CatalogTable,
                                         SchemaContext,
                                         SchemaOnlyTableError)
from dryad_tpu_torch.sql.errors import SqlError
from dryad_tpu_torch.sql.lower import lower, source_tables
from dryad_tpu_torch.sql.parser import parse, parse_statement

__all__ = [
    "Catalog", "CatalogTable", "SchemaContext", "SchemaOnlyTableError",
    "SqlError",
    "parse", "parse_statement", "bind", "lower", "source_tables",
    "normalize_query", "compile_query", "query", "explain",
    "offline_explain", "offline_plan_json",
]


def normalize_query(text: str) -> str:
    """Whitespace-collapsed query text: the identity of the
    ``sql_query`` event (two spellings of one query are one query)."""
    return " ".join(text.split())


def compile_query(catalog: Catalog, text: str,
                  origin: str = "<sql>") -> Tuple[str, BoundSelect]:
    """Parse + bind (no Context needed): returns (mode, BoundSelect)
    where mode reflects a leading ``EXPLAIN [COST]``.  Raises
    :class:`SqlError` with all DTA3xx findings."""
    mode, stmt = parse_statement(text, origin=origin)
    return mode, bind(catalog, stmt)


def _refuse_unported(mode: str, bound: BoundSelect) -> None:
    if bound.emit_every is not None:
        raise NotImplementedError(
            "EMIT EVERY (a standing query) needs the incremental-"
            "execution layer (dryad_tpu_torch/inc), which is not ported "
            "yet")


def query(ctx, catalog: Catalog, text: str, origin: str = "<sql>",
          event=None):
    """Compile ``text`` to a lazy :class:`api.Dataset` under ``ctx``.
    A leading EXPLAIN is rejected here (use :func:`explain`)."""
    mode, bound = compile_query(catalog, text, origin=origin)
    _refuse_unported(mode, bound)
    if mode != "run":
        raise ValueError(
            "EXPLAIN statements build no dataset — use sql.explain()")
    ds, _handles = lower(ctx, catalog, bound)
    _emit(ctx, event, text, catalog, bound)
    return ds


def _emit(ctx, event, text: str, catalog: Catalog,
          bound: BoundSelect) -> None:
    sink = event if event is not None else getattr(ctx, "_event_log",
                                                   None)
    if sink is None:
        return
    sink({"event": "sql_query", "query": normalize_query(text),
          "catalog": catalog.fingerprint(),
          "tables": list(bound.tables)})
    sink({"event": "sql_lowered",
          "outputs": list(bound.outputs),
          "grouped": bound.grouped, "joins": len(bound.joins),
          "limit": bound.limit})


def explain(ctx, catalog: Catalog, text: str, origin: str = "<sql>",
            event=None) -> str:
    """EXPLAIN text for a query (with or without a leading EXPLAIN
    [COST | ANALYZE] keyword).  COST adds the DTA2xx predicted-cost
    table and the static diagnostics; it runs nothing and launches no
    kernel (the cost model runs the ops on meta tensors).  ANALYZE
    **runs the query once** under an event capture and appends the
    measured per-stage actuals against the cost model (it needs a
    Context with loadable tables, as running the query does)."""
    mode, bound = compile_query(catalog, text, origin=origin)
    _refuse_unported(mode, bound)
    ds, _ = lower(ctx, catalog, bound)
    _emit(ctx, event, text, catalog, bound)
    cost = mode == "explain_cost"
    return ds.explain(verify=cost, cost=cost,
                      analyze=mode == "explain_analyze")


def _offline_graph(catalog: Catalog, text: str, nparts: int,
                   origin: str):
    from dryad_tpu_torch.plan.planner import plan_query
    mode, bound = compile_query(catalog, text, origin=origin)
    _refuse_unported(mode, bound)
    ctx = SchemaContext(nparts=nparts)
    ds, _ = lower(ctx, catalog, bound)
    return plan_query(ds.node, nparts, config=ctx.config)


def offline_explain(catalog: Catalog, text: str, nparts: int = 8,
                    origin: str = "<sql>") -> str:
    """Textual EXPLAIN with NO device and no data (schema-only catalogs
    suffice) — the CLI's offline mode."""
    return _offline_graph(catalog, text, nparts, origin).explain()


def offline_plan_json(catalog: Catalog, text: str, nparts: int = 8,
                      origin: str = "<sql>") -> str:
    """Deterministic lowered-plan JSON with NO device and no data: the
    JAX package's golden plans (``docs/plans/*.json``) are this
    function's output, up to the package prefix of the shipped class
    refs.  Row-expression callables serialize as data
    (``__shipped__``), so the output round-trips through
    graph_from_json."""
    from dryad_tpu_torch.plan.serialize import graph_to_json
    return graph_to_json(_offline_graph(catalog, text, nparts, origin))
