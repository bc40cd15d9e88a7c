"""SQL tokenizer with line:column provenance — the port of
``dryad_tpu/sql/lexer.py``.

Every token carries its 1-based (line, col) into the ORIGINAL query
text, so parse/bind diagnostics (DTA3xx) point at the exact spot the
user typed — the SQL analogue of the Python UDF lint's file:line spans
(analysis/diagnostics.Span with ``col`` set).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from dryad_tpu_torch.analysis.diagnostics import Span
from dryad_tpu_torch.sql.errors import SqlError, sql_report

__all__ = ["Token", "tokenize", "KEYWORDS"]

KEYWORDS = frozenset({
    "SELECT", "DISTINCT", "FROM", "WHERE", "GROUP", "BY", "HAVING",
    "ORDER", "LIMIT", "AS", "AND", "OR", "NOT", "JOIN", "INNER", "LEFT",
    "RIGHT", "FULL", "OUTER", "CROSS", "NATURAL", "ON", "ASC", "DESC",
    "UNION", "INTERSECT", "EXCEPT", "OFFSET", "EXPLAIN", "COST", "NULL",
    "IN", "LIKE", "BETWEEN", "CASE", "IS", "EMIT", "EVERY", "SECONDS",
})

_PUNCT = ("<=", ">=", "!=", "<>", "=", "<", ">", "(", ")", ",", ".",
          "+", "-", "*", "/", ";")


@dataclasses.dataclass(frozen=True)
class Token:
    kind: str         # "kw" | "ident" | "int" | "float" | "str" | "punct" | "eof"
    text: str         # keyword/punct text, identifier, or literal lexeme
    line: int
    col: int

    def span(self, origin: str = "<sql>") -> Span:
        return Span(origin, self.line, "", self.col)


def tokenize(query: str, origin: str = "<sql>") -> List[Token]:
    """Tokens + a trailing ``eof`` token.  Raises :class:`SqlError`
    (DTA301) on an unterminated string or an illegal character."""
    toks: List[Token] = []
    line, col = 1, 1
    i, n = 0, len(query)

    def err(msg: str, ln: int, cl: int) -> SqlError:
        return SqlError(sql_report(
            "DTA301", msg, Span(origin, ln, "", cl)))

    while i < n:
        c = query[i]
        if c == "\n":
            line += 1
            col = 1
            i += 1
            continue
        if c in " \t\r":
            i += 1
            col += 1
            continue
        if c == "-" and query[i + 1:i + 2] == "-":   # -- comment to EOL
            while i < n and query[i] != "\n":
                i += 1
            continue
        start_line, start_col = line, col
        if c == "'":
            j = i + 1
            buf = []
            while True:
                if j >= n:
                    raise err("unterminated string literal", start_line,
                              start_col)
                if query[j] == "'":
                    if query[j + 1:j + 2] == "'":    # '' escapes a quote
                        buf.append("'")
                        j += 2
                        continue
                    break
                if query[j] == "\n":
                    raise err("unterminated string literal", start_line,
                              start_col)
                buf.append(query[j])
                j += 1
            toks.append(Token("str", "".join(buf), start_line, start_col))
            col += (j + 1 - i)
            i = j + 1
            continue
        if c.isdigit() or (c == "." and query[i + 1:i + 2].isdigit()):
            j = i
            seen_dot = False
            while j < n and (query[j].isdigit()
                             or (query[j] == "." and not seen_dot
                                 and query[j + 1:j + 2].isdigit())):
                seen_dot = seen_dot or query[j] == "."
                j += 1
            text = query[i:j]
            toks.append(Token("float" if "." in text else "int", text,
                              start_line, start_col))
            col += j - i
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (query[j].isalnum() or query[j] == "_"):
                j += 1
            text = query[i:j]
            up = text.upper()
            toks.append(Token("kw" if up in KEYWORDS else "ident",
                              up if up in KEYWORDS else text,
                              start_line, start_col))
            col += j - i
            i = j
            continue
        matched: Optional[str] = None
        for p in _PUNCT:
            if query.startswith(p, i):
                matched = p
                break
        if matched is None:
            raise err(f"illegal character {c!r}", start_line, start_col)
        # normalize the <> spelling so the parser sees one token text
        toks.append(Token("punct", "!=" if matched == "<>" else matched,
                          start_line, start_col))
        col += len(matched)
        i += len(matched)
    toks.append(Token("eof", "", line, col))
    return toks
