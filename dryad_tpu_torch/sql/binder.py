"""Binder: resolve a parsed SELECT against a Catalog, type-check every
expression, and produce the lowering-ready :class:`BoundSelect` — the
port of ``dryad_tpu/sql/binder.py``.

All findings report AT ONCE through one DiagnosticReport (a query with
three typos gets three DTA3xx findings in one rejection, each with a
line:column span into the query text):

* DTA302 unknown table, DTA303 unknown column, DTA304 ambiguous
  column / duplicate alias / duplicate output name,
* DTA305 type mismatches (including aggregate-shape errors: a
  non-grouped column in an aggregated SELECT),
* DTA306 recognized-but-unsupported constructs.

Internally every column gets a unique physical name ``alias.col`` the
moment its table enters scope, so downstream joins can never collide
names and EXPLAIN output stays readable.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from dryad_tpu_torch.analysis.diagnostics import DiagnosticReport, Span

from dryad_tpu_torch.sql import nodes as N
from dryad_tpu_torch.sql.catalog import Catalog, sql_type_of
from dryad_tpu_torch.sql.errors import SqlError

__all__ = ["BoundSelect", "BoundJoin", "bind"]

Prog = list  # rowexpr program node


@dataclasses.dataclass
class BoundJoin:
    table: str                       # catalog table name
    alias: str
    how: str                         # inner | left | right | full
    left_keys: List[str]             # physical names in the left scope
    right_keys: List[str]            # physical names in the new table
    renames: Dict[str, str]          # phys -> source column
    span: Optional[Span] = None


@dataclasses.dataclass
class BoundSelect:
    """Everything lower.py needs; all names physical."""

    base_table: str
    base_alias: str
    base_renames: Dict[str, str]          # phys -> source column
    joins: List[BoundJoin]
    where: Optional[Prog]
    # aggregation (empty group_keys + aggs means a GLOBAL aggregate)
    grouped: bool
    group_keys: List[str]                 # physical names
    pre_projection: Optional[Dict[str, Prog]]
    aggs: Dict[str, Tuple[str, Optional[str]]]
    having: Optional[Prog]
    # final projection over the current scope -> output names
    outputs: Dict[str, Prog]
    output_types: Dict[str, str]
    distinct: bool
    order_by: List[Tuple[str, bool]]
    limit: Optional[int]
    tables: List[str]                     # catalog names, FROM order
    # query-text provenance: lowering stamps these onto the plan nodes
    # it builds, so plan spans (and any runtime error quoting them)
    # point INTO THE QUERY, and offline plan JSON is deterministic
    span: Optional[Span] = None           # the SELECT keyword
    where_span: Optional[Span] = None
    having_span: Optional[Span] = None
    # standing query (EMIT EVERY <n>): refresh cadence in seconds; the
    # lowered batch plan is IDENTICAL — the cadence drives a standing-
    # query scheduler and the incremental refresh planner (``inc/``)
    emit_every: Optional[float] = None
    emit_span: Optional[Span] = None


class _Scope:
    """Ordered (alias -> {col: (phys, type)}) with bare-name lookup."""

    def __init__(self):
        self.order: List[str] = []
        self.by_alias: Dict[str, Dict[str, Tuple[str, str]]] = {}

    def add_table(self, alias: str, cols: Dict[str, Tuple[str, str]]):
        self.order.append(alias)
        self.by_alias[alias] = dict(cols)

    def lookup(self, table: Optional[str], name: str):
        """(phys, type) | ("unknown-table"|"unknown"|"ambiguous", None)"""
        if table is not None:
            t = self.by_alias.get(table)
            if t is None:
                return ("unknown-table", None)
            hit = t.get(name)
            return hit if hit is not None else ("unknown", None)
        hits = [a for a in self.order if name in self.by_alias[a]]
        if not hits:
            return ("unknown", None)
        if len(hits) > 1:
            return ("ambiguous", hits)
        return self.by_alias[hits[0]][name]

    def all_columns(self):
        """[(alias, col, phys, type)] in FROM order."""
        out = []
        for a in self.order:
            for c, (phys, typ) in self.by_alias[a].items():
                out.append((a, c, phys, typ))
        return out


class _Binder:
    def __init__(self, catalog: Catalog, stmt: N.Select):
        self.catalog = catalog
        self.stmt = stmt
        self.report = DiagnosticReport()

    def diag(self, code: str, msg: str, span: Span) -> None:
        self.report.add(code, "error", msg, span=span, node="sql")

    def fail_if_dirty(self) -> None:
        if self.report.errors:
            raise SqlError(self.report)

    # -- FROM / JOIN -------------------------------------------------------

    def _table_scope(self, ref: N.TableRef, scope: _Scope,
                     seen_aliases: set) -> Optional[Dict[str, str]]:
        t = self.catalog.get(ref.name)
        if t is None:
            known = ", ".join(self.catalog.names()) or "none registered"
            self.diag("DTA302",
                      f"unknown table {ref.name!r} (catalog tables: "
                      f"{known})", ref.span)
            return None
        if ref.alias in seen_aliases:
            self.diag("DTA304",
                      f"duplicate table alias {ref.alias!r} makes "
                      f"column references ambiguous", ref.span)
            return None
        seen_aliases.add(ref.alias)
        renames: Dict[str, str] = {}
        cols: Dict[str, Tuple[str, str]] = {}
        for col, spec in t.schema.items():
            phys = f"{ref.alias}.{col}"
            renames[phys] = col
            cols[col] = (phys, sql_type_of(spec))
        scope.add_table(ref.alias, cols)
        return renames

    def _bind_on(self, on, left_aliases: set, right_alias: str,
                 scope: _Scope):
        """Decompose an ON conjunction into cross-side equi-key pairs."""
        lks: List[str] = []
        rks: List[str] = []

        def conjuncts(e):
            if isinstance(e, N.Bin) and e.op == "and":
                return conjuncts(e.left) + conjuncts(e.right)
            return [e]

        for c in conjuncts(on):
            if not (isinstance(c, N.Bin) and c.op == "="
                    and isinstance(c.left, N.Col)
                    and isinstance(c.right, N.Col)):
                self.diag("DTA306",
                          "JOIN ... ON supports conjunctions of "
                          "column equalities only (put residual "
                          "predicates in WHERE)",
                          getattr(c, "span", self.stmt.span))
                continue
            sides = []
            for col in (c.left, c.right):
                phys, typ = self._bind_col(col, scope)
                sides.append((col, phys, typ))
            if any(p is None for _, p, _ in sides):
                continue

            def side_of(phys: str) -> Optional[str]:
                alias = phys.split(".", 1)[0]
                if alias == right_alias:
                    return "right"
                if alias in left_aliases:
                    return "left"
                return None

            tags = [side_of(phys) for _, phys, _ in sides]
            if set(tags) != {"left", "right"}:
                self.diag("DTA306",
                          "each JOIN ... ON equality must compare a "
                          "column of the joined table with one of the "
                          "tables to its left", c.span)
                continue
            (l_i, r_i) = (0, 1) if tags[0] == "left" else (1, 0)
            lt, rt = sides[l_i][2], sides[r_i][2]
            if lt != rt and {lt, rt} != {"int", "float"}:
                self.diag("DTA305",
                          f"JOIN key type mismatch: {sides[l_i][1]} is "
                          f"{lt}, {sides[r_i][1]} is {rt}", c.span)
                continue
            lks.append(sides[l_i][1])
            rks.append(sides[r_i][1])
        return lks, rks

    # -- expressions -------------------------------------------------------

    def _bind_col(self, col: N.Col, scope: _Scope):
        hit = scope.lookup(col.table, col.name)
        if hit[0] == "unknown-table":
            self.diag("DTA302",
                      f"unknown table alias {col.table!r} in column "
                      f"reference {col.table}.{col.name}", col.span)
            return None, None
        if hit[0] == "unknown":
            cands = sorted({c for _, c, _, _ in scope.all_columns()})
            self.diag("DTA303",
                      f"unknown column "
                      f"{(col.table + '.') if col.table else ''}"
                      f"{col.name!r} (in scope: {', '.join(cands)})",
                      col.span)
            return None, None
        if hit[0] == "ambiguous":
            self.diag("DTA304",
                      f"ambiguous column {col.name!r} (in tables: "
                      f"{', '.join(hit[1])}) — qualify with an alias",
                      col.span)
            return None, None
        return hit

    def bind_expr(self, e, scope: _Scope,
                  want: Optional[str] = None) -> Tuple[Optional[Prog],
                                                       Optional[str]]:
        """(program, type); records diagnostics and returns (None, None)
        on any error in the subtree."""
        if isinstance(e, N.Agg):
            self.diag("DTA306",
                      "aggregates are only allowed at the top level of "
                      "SELECT items (with GROUP BY or as a global "
                      "aggregate) and in HAVING via their output name",
                      e.span)
            return None, None
        if isinstance(e, N.Lit):
            return ["lit", e.value, e.typ], e.typ
        if isinstance(e, N.Col):
            phys, typ = self._bind_col(e, scope)
            if phys is None:
                return None, None
            return ["col", phys], typ
        if isinstance(e, N.Un):
            prog, typ = self.bind_expr(e.operand, scope)
            if prog is None:
                return None, None
            if e.op == "not":
                if typ != "bool":
                    self.diag("DTA305",
                              f"NOT needs a boolean operand, got {typ}",
                              e.span)
                    return None, None
                return ["not", prog], "bool"
            if typ not in ("int", "float"):
                self.diag("DTA305",
                          f"unary minus needs a numeric operand, got "
                          f"{typ}", e.span)
                return None, None
            return ["neg", prog], typ
        if isinstance(e, N.Bin):
            lp, lt = self.bind_expr(e.left, scope)
            rp, rt = self.bind_expr(e.right, scope)
            if lp is None or rp is None:
                return None, None
            op = e.op
            if op in ("and", "or"):
                if lt != "bool" or rt != "bool":
                    self.diag("DTA305",
                              f"{op.upper()} needs boolean operands, "
                              f"got {lt} {op.upper()} {rt}", e.span)
                    return None, None
                return ["bin", op, lp, rp], "bool"
            if op in ("+", "-", "*", "/"):
                if lt not in ("int", "float") or rt not in ("int",
                                                            "float"):
                    self.diag("DTA305",
                              f"arithmetic {op!r} needs numeric "
                              f"operands, got {lt} {op} {rt}", e.span)
                    return None, None
                typ = ("float" if op == "/" or "float" in (lt, rt)
                       else "int")
                return ["bin", op, lp, rp], typ
            # comparisons
            numeric = {"int", "float"}
            if op in ("=", "!="):
                ok = (({lt, rt} <= numeric) or lt == rt)
            else:
                ok = {lt, rt} <= numeric
            if not ok:
                what = ("ordering comparisons need numeric operands"
                        if op not in ("=", "!=") else
                        "equality needs same-typed operands")
                self.diag("DTA305", f"{what}, got {lt} {op} {rt}",
                          e.span)
                return None, None
            return ["bin", op, lp, rp], "bool"
        raise AssertionError(f"unexpected AST node {e!r}")

    # -- the main walk -----------------------------------------------------

    def bind(self) -> BoundSelect:
        stmt = self.stmt
        scope = _Scope()
        seen: set = set()
        base_renames = self._table_scope(stmt.table, scope, seen)
        joins: List[BoundJoin] = []
        left_aliases = {stmt.table.alias}
        for jc in stmt.joins:
            renames = self._table_scope(jc.table, scope, seen)
            if renames is None:
                continue
            lks, rks = self._bind_on(jc.on, left_aliases,
                                     jc.table.alias, scope)
            if not lks and not self.report.errors:
                self.diag("DTA306",
                          "JOIN needs at least one equi-key in ON",
                          jc.span)
            left_aliases.add(jc.table.alias)
            joins.append(BoundJoin(jc.table.name, jc.table.alias,
                                   jc.how, lks, rks, renames,
                                   span=jc.span))
        # name resolution is hopeless without the FROM scope
        self.fail_if_dirty()

        where = None
        if stmt.where is not None:
            where, wt = self.bind_expr(stmt.where, scope)
            if where is not None and wt != "bool":
                self.diag("DTA305",
                          f"WHERE must be boolean, got {wt}",
                          getattr(stmt.where, "span", stmt.span))

        has_agg = any(isinstance(it.expr, N.Agg) for it in stmt.items)
        grouped = bool(stmt.group_by) or has_agg
        if stmt.having is not None and not grouped:
            self.diag("DTA306",
                      "HAVING needs GROUP BY (or an aggregated SELECT)",
                      stmt.span)

        outputs: Dict[str, Prog] = {}
        output_types: Dict[str, str] = {}

        def add_output(name: str, prog: Prog, typ: str,
                       span: Span) -> None:
            if name in outputs:
                self.diag("DTA304",
                          f"duplicate output column {name!r} — use AS "
                          f"to disambiguate", span)
                return
            outputs[name] = prog
            output_types[name] = typ

        group_keys: List[str] = []
        pre_projection: Optional[Dict[str, Prog]] = None
        aggs: Dict[str, Tuple[str, Optional[str]]] = {}
        having = None

        if grouped:
            if any(isinstance(it.expr, N.Col) and it.expr.name == "*"
                   for it in stmt.items):
                self.diag("DTA306",
                          "SELECT * is not supported with GROUP BY / "
                          "aggregates", stmt.span)
                self.fail_if_dirty()
            pre_projection = {}
            key_types: Dict[str, str] = {}
            for g in stmt.group_by:
                phys, typ = self._bind_col(g, scope)
                if phys is None:
                    continue
                group_keys.append(phys)
                key_types[phys] = typ
                pre_projection[phys] = ["col", phys]
            agg_i = 0
            for it in stmt.items:
                e = it.expr
                if isinstance(e, N.Col):
                    phys, typ = self._bind_col(e, scope)
                    if phys is None:
                        continue
                    if phys not in group_keys:
                        self.diag("DTA305",
                                  f"column {e.name!r} is neither "
                                  f"aggregated nor in GROUP BY", e.span)
                        continue
                    add_output(it.alias or e.name, ["col", phys], typ,
                               it.span)
                elif isinstance(e, N.Agg):
                    kind = N.AGG_FUNCS[e.func]
                    if e.arg is None:            # COUNT(*)
                        in_col, in_typ = None, "int"
                    else:
                        prog, in_typ = self.bind_expr(e.arg, scope)
                        if prog is None:
                            continue
                        if kind != "count" and in_typ not in ("int",
                                                              "float"):
                            self.diag(
                                "DTA305",
                                f"{e.func} needs a numeric argument, "
                                f"got {in_typ}", e.span)
                            continue
                        if kind == "count":
                            in_col = None  # COUNT(expr) == row count
                        else:
                            in_col = f"__sqlagg{agg_i}"
                            agg_i += 1
                            pre_projection[in_col] = prog
                    if it.alias:
                        name = it.alias
                    elif e.arg is not None and isinstance(e.arg, N.Col):
                        name = f"{e.func.lower()}_{e.arg.name}"
                    elif e.arg is None:
                        name = "count"
                    else:
                        name = f"{e.func.lower()}_{agg_i}"
                    out_typ = ("int" if kind == "count" else
                               "float" if kind == "mean" else in_typ)
                    if name in aggs or name in outputs:
                        self.diag("DTA304",
                                  f"duplicate output column {name!r} — "
                                  f"use AS to disambiguate", it.span)
                        continue
                    aggs[name] = (kind, in_col)
                    add_output(name, ["col", name], out_typ, it.span)
                else:
                    self.diag("DTA306",
                              "in a grouped SELECT each item must be a "
                              "group key or a single aggregate (no "
                              "expressions over aggregates)", it.span)
            if not aggs:
                self.diag("DTA306",
                          "GROUP BY needs at least one aggregate in "
                          "SELECT", stmt.span)
            # HAVING binds the POST-aggregation scope: group keys stay
            # under their own table aliases (so qualified refs work and
            # same-named keys from two tables are properly AMBIGUOUS,
            # not silently first-wins) plus the aggregate output names
            if stmt.having is not None and not self.report.errors:
                hscope = _Scope()
                per_alias: Dict[str, Dict[str, Tuple[str, str]]] = {}
                for phys in group_keys:
                    alias, col = phys.split(".", 1)
                    per_alias.setdefault(alias, {})[col] = \
                        (phys, key_types[phys])
                for alias, cols in per_alias.items():
                    hscope.add_table(alias, cols)
                hscope.add_table("__aggs", {
                    name: (name, output_types.get(name, "int"))
                    for name in aggs})
                having, ht = self.bind_expr(stmt.having, hscope)
                if having is not None and ht != "bool":
                    self.diag("DTA305",
                              f"HAVING must be boolean, got {ht}",
                              stmt.span)
        else:
            for it in stmt.items:
                e = it.expr
                if isinstance(e, N.Col) and e.name == "*":
                    all_cols = scope.all_columns()
                    bare_counts: Dict[str, int] = {}
                    for _, c, _, _ in all_cols:
                        bare_counts[c] = bare_counts.get(c, 0) + 1
                    for alias, c, phys, typ in all_cols:
                        name = c if bare_counts[c] == 1 else phys
                        add_output(name, ["col", phys], typ, it.span)
                    continue
                prog, typ = self.bind_expr(e, scope)
                if prog is None:
                    continue
                if it.alias:
                    name = it.alias
                elif isinstance(e, N.Col):
                    name = e.name
                else:
                    name = f"col{len(outputs)}"
                add_output(name, prog, typ, it.span)

        if stmt.emit_every is not None:
            # standing-query shape checks (DTA307): the interval must
            # be positive, and the base table must be able to GROW —
            # inline registrations are immutable host columns
            espan = stmt.emit_span or stmt.span
            if not stmt.emit_every > 0:
                self.diag("DTA307",
                          f"EMIT EVERY needs a positive interval, got "
                          f"{stmt.emit_every:g}", espan)
            base = self.catalog.get(stmt.table.name)
            if base is not None and base.kind == "inline":
                self.diag("DTA307",
                          f"EMIT EVERY over inline table "
                          f"{stmt.table.name!r}: inline registrations "
                          f"cannot grow — a standing query needs a "
                          f"store-backed base table", espan)

        order_by: List[Tuple[str, bool]] = []
        for o in stmt.order_by:
            if o.name not in outputs:
                self.diag("DTA303",
                          f"ORDER BY {o.name!r} is not an output "
                          f"column of this SELECT (order by a selected "
                          f"column or alias; outputs: "
                          f"{', '.join(outputs) or 'none'})", o.span)
                continue
            order_by.append((o.name, o.descending))

        self.fail_if_dirty()
        return BoundSelect(
            base_table=stmt.table.name, base_alias=stmt.table.alias,
            base_renames=base_renames or {}, joins=joins, where=where,
            grouped=grouped, group_keys=group_keys,
            pre_projection=pre_projection, aggs=aggs, having=having,
            outputs=outputs, output_types=output_types,
            distinct=stmt.distinct, order_by=order_by,
            limit=stmt.limit,
            tables=[stmt.table.name] + [j.table for j in joins],
            span=stmt.span,
            where_span=getattr(stmt.where, "span", None),
            having_span=getattr(stmt.having, "span", None),
            emit_every=stmt.emit_every, emit_span=stmt.emit_span)


def bind(catalog: Catalog, stmt: N.Select) -> BoundSelect:
    return _Binder(catalog, stmt).bind()
