"""SQL compile errors: DTA3xx findings over the shared diagnostics —
the port of ``dryad_tpu/sql/errors.py``.

A failed compile raises ONE :class:`SqlError` carrying a full
``DiagnosticReport`` — the binder reports every unresolved name / type
mismatch at once, each finding with a line:column span into the query
text.  ``SqlError`` subclasses ``DiagnosticError`` (the CLI exits 2 on
it, before any work starts).
"""

from __future__ import annotations

from typing import Any

from dryad_tpu_torch.analysis.diagnostics import (DiagnosticError,
                                            DiagnosticReport, Span)

__all__ = ["SqlError", "sql_report"]


def sql_report(code: str, message: str, span: Span) -> DiagnosticReport:
    """One-finding report (the lexer/parser stop at the first error;
    the binder builds multi-finding reports itself)."""
    rep = DiagnosticReport()
    rep.add(code, "error", message, span=span, node="sql")
    return rep


class SqlError(DiagnosticError):
    """SQL front-end rejection: parse/bind/type findings, all at once.
    ``code`` is the first (sorted most-severe-first) finding's code;
    ``report`` has everything."""

    def __init__(self, report: DiagnosticReport):
        self.report = report
        first = next(iter(report.sorted()), None)
        super().__init__(
            "SQL query rejected:\n" + report.render(),
            code=first.code if first is not None else "DTA301",
            span=first.span if first is not None else None)

    def codes(self) -> Any:
        return self.report.codes()
