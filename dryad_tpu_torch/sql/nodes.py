"""SQL abstract syntax: small frozen dataclasses with query-text spans —
the port of ``dryad_tpu/sql/nodes.py``.  Every node keeps the
:class:`Span` of the token that introduced it, so the binder's DTA3xx
findings point into the query text.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from dryad_tpu_torch.analysis.diagnostics import Span

__all__ = ["Lit", "Col", "Bin", "Un", "Agg", "SelectItem", "TableRef",
           "JoinClause", "OrderItem", "Select", "Expr", "AGG_FUNCS"]

# SQL aggregate -> group_by agg kind (api.Dataset.group_by)
AGG_FUNCS = {"SUM": "sum", "COUNT": "count", "MIN": "min", "MAX": "max",
             "AVG": "mean"}


@dataclasses.dataclass(frozen=True)
class Lit:
    value: object            # int | float | str
    typ: str                 # "int" | "float" | "str"
    span: Span


@dataclasses.dataclass(frozen=True)
class Col:
    table: Optional[str]     # alias qualifier, or None for bare names
    name: str
    span: Span


@dataclasses.dataclass(frozen=True)
class Bin:
    op: str                  # + - * / = != < <= > >= and or
    left: "Expr"
    right: "Expr"
    span: Span


@dataclasses.dataclass(frozen=True)
class Un:
    op: str                  # "not" | "neg"
    operand: "Expr"
    span: Span


@dataclasses.dataclass(frozen=True)
class Agg:
    func: str                # key of AGG_FUNCS
    arg: Optional["Expr"]    # None for COUNT(*)
    span: Span


Expr = object  # Lit | Col | Bin | Un | Agg


@dataclasses.dataclass(frozen=True)
class SelectItem:
    expr: Expr               # or the "*" marker (Col(None, "*"))
    alias: Optional[str]
    span: Span


@dataclasses.dataclass(frozen=True)
class TableRef:
    name: str
    alias: str               # defaults to the table name
    span: Span


@dataclasses.dataclass(frozen=True)
class JoinClause:
    table: TableRef
    how: str                 # inner | left | right | full
    on: Expr                 # conjunction of equality comparisons
    span: Span


@dataclasses.dataclass(frozen=True)
class OrderItem:
    name: str                # output-scope column name
    descending: bool
    span: Span


@dataclasses.dataclass(frozen=True)
class Select:
    items: List[SelectItem]
    distinct: bool
    table: TableRef
    joins: Tuple[JoinClause, ...]
    where: Optional[Expr]
    group_by: Tuple[Col, ...]
    having: Optional[Expr]
    order_by: Tuple[OrderItem, ...]
    limit: Optional[int]
    span: Span
    # standing query: refresh cadence in seconds (EMIT EVERY <n>
    # [SECONDS]); None for plain batch queries
    emit_every: Optional[float] = None
    emit_span: Optional[Span] = None
