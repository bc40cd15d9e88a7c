"""Recursive-descent SQL parser — the port of ``dryad_tpu/sql/parser.py``.

Grammar (SELECT / WHERE / GROUP BY + aggregates / JOIN / ORDER BY /
LIMIT over the plan DAG)::

    query     := SELECT [DISTINCT] items FROM table_ref join* [WHERE expr]
                 [GROUP BY col ("," col)*] [HAVING expr]
                 [ORDER BY ord ("," ord)*] [LIMIT int]
                 [EMIT EVERY num [SECONDS]] [";"]
    items     := "*" | item ("," item)*
    item      := expr [[AS] ident]
    table_ref := ident [[AS] ident]
    join      := [INNER | LEFT|RIGHT|FULL [OUTER]] JOIN table_ref ON expr
    ord       := ident [ASC | DESC]
    expr      := or-tree over NOT / comparisons / + - / * / / unary- /
                 "(" expr ")" / literal / [ident "."] ident /
                 SUM|COUNT|MIN|MAX|AVG "(" expr | "*" ")"

A syntax error raises :class:`SqlError` with DTA301 and the offending
token's line:column; recognized-but-unsupported constructs (subqueries,
CROSS/NATURAL JOIN, UNION/INTERSECT/EXCEPT, OFFSET, IN/LIKE/BETWEEN/
CASE/IS NULL) raise DTA306 so the message says "unsupported", not
"syntax error".
"""

from __future__ import annotations

from typing import List, Optional

from dryad_tpu_torch.sql import nodes as N
from dryad_tpu_torch.sql.errors import SqlError, sql_report
from dryad_tpu_torch.sql.lexer import Token, tokenize

__all__ = ["parse", "parse_statement"]

_UNSUPPORTED_KW = {
    "UNION": "UNION", "INTERSECT": "INTERSECT", "EXCEPT": "EXCEPT",
    "OFFSET": "OFFSET", "IN": "IN (...)", "LIKE": "LIKE",
    "BETWEEN": "BETWEEN", "CASE": "CASE", "IS": "IS [NOT] NULL",
}


class _Parser:
    def __init__(self, toks: List[Token], origin: str):
        self.toks = toks
        self.i = 0
        self.origin = origin

    # -- token plumbing ----------------------------------------------------

    @property
    def cur(self) -> Token:
        return self.toks[self.i]

    def _span(self, tok: Token):
        return tok.span(self.origin)

    def err(self, msg: str, tok: Optional[Token] = None,
            code: str = "DTA301") -> SqlError:
        tok = tok or self.cur
        at = f" (at {tok.kind} {tok.text!r})" if tok.kind != "eof" \
            else " (at end of query)"
        return SqlError(sql_report(code, msg + at, self._span(tok)))

    def at_kw(self, *names: str) -> bool:
        return self.cur.kind == "kw" and self.cur.text in names

    def at_punct(self, text: str) -> bool:
        return self.cur.kind == "punct" and self.cur.text == text

    def take(self) -> Token:
        t = self.cur
        self.i += 1
        return t

    def expect_kw(self, name: str) -> Token:
        if not self.at_kw(name):
            raise self.err(f"expected {name}")
        return self.take()

    def expect_punct(self, text: str) -> Token:
        if not self.at_punct(text):
            raise self.err(f"expected {text!r}")
        return self.take()

    def expect_ident(self, what: str) -> Token:
        if self.cur.kind != "ident":
            raise self.err(f"expected {what}")
        return self.take()

    def _check_unsupported(self) -> None:
        if self.cur.kind == "kw" and self.cur.text in _UNSUPPORTED_KW:
            raise self.err(
                f"{_UNSUPPORTED_KW[self.cur.text]} is not supported",
                code="DTA306")

    # -- query -------------------------------------------------------------

    def parse_select(self) -> N.Select:
        head = self.expect_kw("SELECT")
        distinct = False
        if self.at_kw("DISTINCT"):
            self.take()
            distinct = True
        items = self.select_items()
        self.expect_kw("FROM")
        table = self.table_ref()
        joins = []
        while self.at_kw("JOIN", "INNER", "LEFT", "RIGHT", "FULL",
                         "CROSS", "NATURAL"):
            joins.append(self.join_clause())
        where = None
        if self.at_kw("WHERE"):
            self.take()
            where = self.expr()
        group_by: List[N.Col] = []
        if self.at_kw("GROUP"):
            self.take()
            self.expect_kw("BY")
            group_by.append(self.col_ref("GROUP BY column"))
            while self.at_punct(","):
                self.take()
                group_by.append(self.col_ref("GROUP BY column"))
        having = None
        if self.at_kw("HAVING"):
            self.take()
            having = self.expr()
        order_by: List[N.OrderItem] = []
        if self.at_kw("ORDER"):
            self.take()
            self.expect_kw("BY")
            order_by.append(self.order_item())
            while self.at_punct(","):
                self.take()
                order_by.append(self.order_item())
        limit = None
        if self.at_kw("LIMIT"):
            self.take()
            t = self.take()
            if t.kind != "int":
                raise self.err("LIMIT needs an integer literal", t)
            limit = int(t.text)
        emit_every = None
        emit_span = None
        if self.at_kw("EMIT"):
            e0 = self.take()
            self.expect_kw("EVERY")
            t = self.take()
            if t.kind not in ("int", "float"):
                raise self.err("EMIT EVERY needs a numeric interval "
                               "(seconds)", t)
            emit_every = float(t.text)
            if self.at_kw("SECONDS"):
                self.take()
            emit_span = self._span(e0)
        if self.at_punct(";"):
            self.take()
        self._check_unsupported()
        if self.cur.kind != "eof":
            raise self.err("unexpected trailing input")
        return N.Select(items=items, distinct=distinct, table=table,
                        joins=tuple(joins), where=where,
                        group_by=tuple(group_by), having=having,
                        order_by=tuple(order_by), limit=limit,
                        span=self._span(head), emit_every=emit_every,
                        emit_span=emit_span)

    def select_items(self) -> List[N.SelectItem]:
        if self.at_punct("*"):
            t = self.take()
            return [N.SelectItem(N.Col(None, "*", self._span(t)), None,
                                 self._span(t))]
        items = [self.select_item()]
        while self.at_punct(","):
            self.take()
            items.append(self.select_item())
        return items

    def select_item(self) -> N.SelectItem:
        t0 = self.cur
        e = self.expr()
        alias = None
        if self.at_kw("AS"):
            self.take()
            alias = self.expect_ident("alias after AS").text
        elif self.cur.kind == "ident":
            alias = self.take().text
        return N.SelectItem(e, alias, self._span(t0))

    def table_ref(self) -> N.TableRef:
        self._check_unsupported()
        if self.at_punct("("):
            raise self.err("subqueries are not supported", code="DTA306")
        t = self.expect_ident("table name")
        alias = t.text
        if self.at_kw("AS"):
            self.take()
            alias = self.expect_ident("alias after AS").text
        elif self.cur.kind == "ident":
            alias = self.take().text
        return N.TableRef(t.text, alias, self._span(t))

    def join_clause(self) -> N.JoinClause:
        t0 = self.cur
        if self.at_kw("CROSS", "NATURAL"):
            raise self.err(f"{self.cur.text} JOIN is not supported",
                           code="DTA306")
        how = "inner"
        if self.at_kw("INNER"):
            self.take()
        elif self.at_kw("LEFT", "RIGHT", "FULL"):
            how = self.take().text.lower()
            if self.at_kw("OUTER"):
                self.take()
        self.expect_kw("JOIN")
        table = self.table_ref()
        self.expect_kw("ON")
        on = self.expr()
        return N.JoinClause(table, how, on, self._span(t0))

    def col_ref(self, what: str) -> N.Col:
        t = self.expect_ident(what)
        if self.at_punct("."):
            self.take()
            c = self.expect_ident("column name after '.'")
            return N.Col(t.text, c.text, self._span(t))
        return N.Col(None, t.text, self._span(t))

    def order_item(self) -> N.OrderItem:
        t = self.expect_ident("ORDER BY column")
        desc = False
        if self.at_kw("ASC", "DESC"):
            desc = self.take().text == "DESC"
        return N.OrderItem(t.text, desc, self._span(t))

    # -- expressions (precedence: OR < AND < NOT < cmp < +- < */ < unary) --

    def expr(self):
        e = self.and_expr()
        while self.at_kw("OR"):
            t = self.take()
            e = N.Bin("or", e, self.and_expr(), self._span(t))
        return e

    def and_expr(self):
        e = self.not_expr()
        while self.at_kw("AND"):
            t = self.take()
            e = N.Bin("and", e, self.not_expr(), self._span(t))
        return e

    def not_expr(self):
        if self.at_kw("NOT"):
            t = self.take()
            return N.Un("not", self.not_expr(), self._span(t))
        return self.cmp_expr()

    def cmp_expr(self):
        e = self.add_expr()
        self._check_unsupported()
        if self.cur.kind == "punct" and self.cur.text in (
                "=", "!=", "<", "<=", ">", ">="):
            t = self.take()
            return N.Bin(t.text, e, self.add_expr(), self._span(t))
        return e

    def add_expr(self):
        e = self.mul_expr()
        while self.cur.kind == "punct" and self.cur.text in ("+", "-"):
            t = self.take()
            e = N.Bin(t.text, e, self.mul_expr(), self._span(t))
        return e

    def mul_expr(self):
        e = self.unary_expr()
        while self.cur.kind == "punct" and self.cur.text in ("*", "/"):
            t = self.take()
            e = N.Bin(t.text, e, self.unary_expr(), self._span(t))
        return e

    def unary_expr(self):
        if self.at_punct("-"):
            t = self.take()
            return N.Un("neg", self.unary_expr(), self._span(t))
        return self.atom()

    def atom(self):
        self._check_unsupported()
        t = self.cur
        if t.kind == "punct" and t.text == "(":
            self.take()
            if self.at_kw("SELECT"):
                raise self.err("subqueries are not supported",
                               code="DTA306")
            e = self.expr()
            self.expect_punct(")")
            return e
        if t.kind == "int":
            self.take()
            return N.Lit(int(t.text), "int", self._span(t))
        if t.kind == "float":
            self.take()
            return N.Lit(float(t.text), "float", self._span(t))
        if t.kind == "str":
            self.take()
            return N.Lit(t.text, "str", self._span(t))
        if t.kind == "kw" and t.text == "NULL":
            raise self.err("NULL literals are not supported",
                           code="DTA306")
        if t.kind == "ident":
            name = self.take()
            up = name.text.upper()
            if up in N.AGG_FUNCS and self.at_punct("("):
                self.take()
                if self.at_punct("*"):
                    star = self.take()
                    if up != "COUNT":
                        raise self.err(
                            f"{up}(*) is not supported (only COUNT(*))",
                            star, code="DTA306")
                    arg = None
                else:
                    if self.at_kw("DISTINCT"):
                        raise self.err(
                            "aggregate DISTINCT is not supported",
                            code="DTA306")
                    arg = self.expr()
                self.expect_punct(")")
                return N.Agg(up, arg, self._span(name))
            if self.at_punct("("):
                raise self.err(
                    f"unknown function {name.text!r} (supported: "
                    f"{', '.join(sorted(N.AGG_FUNCS))})", name,
                    code="DTA306")
            if self.at_punct("."):
                self.take()
                c = self.expect_ident("column name after '.'")
                return N.Col(name.text, c.text, self._span(name))
            return N.Col(None, name.text, self._span(name))
        raise self.err("expected an expression")


def parse(query: str, origin: str = "<sql>") -> N.Select:
    """Parse one SELECT statement (any leading EXPLAIN [COST] must be
    stripped by the caller — sql.split_explain)."""
    return _Parser(tokenize(query, origin), origin).parse_select()


def parse_statement(query: str, origin: str = "<sql>"):
    """(mode, Select) where mode is "run" | "explain" | "explain_cost"
    | "explain_analyze" depending on a leading ``EXPLAIN [COST |
    ANALYZE]``.  ANALYZE is deliberately NOT a reserved keyword (it
    stays usable as a column/table name) — it only has meaning directly
    after EXPLAIN."""
    toks = tokenize(query, origin)
    mode = "run"
    if toks and toks[0].kind == "kw" and toks[0].text == "EXPLAIN":
        toks = toks[1:]
        mode = "explain"
        if toks and toks[0].kind == "kw" and toks[0].text == "COST":
            toks = toks[1:]
            mode = "explain_cost"
        elif (toks and toks[0].kind == "ident"
                and toks[0].text.upper() == "ANALYZE"):
            toks = toks[1:]
            mode = "explain_analyze"
    return mode, _Parser(toks, origin).parse_select()
