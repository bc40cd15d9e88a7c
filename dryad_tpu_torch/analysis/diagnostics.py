"""Diagnostics: stable codes, severities, source provenance — the port
of ``dryad_tpu/analysis/diagnostics.py``.

Every finding is a ``Diagnostic`` with a stable ``DTAxxx`` code, so
tooling (CI gates, tests) can key off it.  The code table is the JAX
package's whole, so a code means the same thing to both packages; the
port emits the plan verifier's (DTA0xx), the UDF lint's (DTA1xx), the
cost model's (DTA2xx) and the SQL front end's (DTA3xx).

Code space: DTA0xx plan verifier, DTA1xx UDF lint, DTA2xx cost and
resource model, DTA3xx SQL front end, DTA4xx incremental execution,
DTA5xx plan equivalence and reuse, DTA9xx runtime-only conditions.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional

__all__ = ["Span", "Diagnostic", "DiagnosticReport", "DiagnosticError",
           "LintError", "SEVERITIES", "CODES", "RUNTIME_ONLY_CODES"]

# severity rank for sorting/gating (error first)
SEVERITIES = {"error": 0, "warn": 1, "info": 2}

# every stable code with its one-line meaning, the JAX package's table
# unchanged (a code means the same thing to both packages)
CODES = {
    # -- plan verifier (DTA0xx) -------------------------------------------
    # DTA001 (global take over cluster streams) RETIRED: the streamed
    # runner grew a real lowering (runtime/stream_plan._global_take)
    "DTA002": "placeholder (do_while loop input) in a streamed cluster "
              "plan",
    "DTA003": "operator not supported over cluster streams",
    "DTA010": "capacity hazard: fan-out op without a with_capacity bound",
    "DTA011": "redundant repartition: placement already satisfied",
    "DTA012": "fan-out (Tee) consumer without cache()",
    "DTA013": "unsound assume_* placement claim",
    "DTA014": "UDF is not cluster-shippable (lambda/closure)",
    "DTA015": "source is not cluster-shippable (non-deferred)",
    "DTA016": "op param is not serializable for cluster execution",
    "DTA017": "pinned partitioning (assume_*/explicit repartition) "
              "blocks adaptive repartitioning of an elided consumer",
    # -- UDF lint (DTA1xx) -------------------------------------------------
    "DTA101": "nondeterministic call in UDF (time/random/uuid/urandom)",
    "DTA102": "object-identity dependence in UDF (id()/salted hash())",
    "DTA103": "set-iteration-order dependence in UDF",
    "DTA104": "UDF mutates captured state",
    "DTA105": "UDF closes over a device array / large ndarray constant "
              "(ships the bytes with every task envelope)",
    # -- cost & resource analyzer (DTA2xx) ---------------------------------
    "DTA200": "cost analyzer internal failure — cost pass skipped",
    "DTA201": "predicted per-device footprint provably exceeds "
              "device_hbm_bytes",
    "DTA202": "predicted per-device footprint may exceed "
              "device_hbm_bytes (predicted spill)",
    "DTA203": "unbounded fan-out reaches an exchange (buffer sized "
              "blind)",
    "DTA204": "cache() of edge-scale data (info: lowered to the "
              "store-backed re-streaming cache tier; warn when the "
              "tier is disabled and the result pins device memory)",
    "DTA205": "per-stage predicted cost summary",
    # -- SQL front end (DTA3xx) --------------------------------------------
    "DTA301": "SQL parse error",
    "DTA302": "unknown table (not registered in the catalog)",
    "DTA303": "unknown column",
    "DTA304": "ambiguous column reference (qualify with the table "
              "alias)",
    "DTA305": "type mismatch in SQL expression",
    "DTA306": "unsupported SQL construct",
    "DTA307": "invalid standing query (EMIT EVERY misuse: non-positive "
              "interval, or a base table that cannot grow)",
    # -- incremental execution (DTA4xx, dryad_tpu/inc) ---------------------
    # info-grade verdicts of the standing-query planner: how a refresh
    # will execute, surfaced by EXPLAIN and carried on refresh events
    "DTA401": "standing query runs incrementally (decomposable "
              "aggregate suffix merges new chunks into persisted "
              "state)",
    "DTA402": "standing query falls back to full re-run (suffix not "
              "decomposable: join / DISTINCT / ORDER BY / LIMIT / "
              "HAVING over the growing table)",
    "DTA403": "cost model chose a full re-run for this refresh (the "
              "chunk delta is most of the store — state is rebuilt, "
              "not merged)",
    # -- plan equivalence & cross-job reuse (DTA5xx) -----------------------
    # info-grade verdicts of the semantic plan-equivalence analyzer
    # (analysis/canon.py canonical fingerprints + analysis/subsume.py
    # containment): surfaced by EXPLAIN and carried on service
    # admission events when a submission reuses cached work
    "DTA501": "semantically equivalent plan (canonical fingerprints "
              "match — cached plan / compiled stages / results are "
              "shareable verbatim)",
    "DTA502": "subsumed scan+filter prefix (this query's scan reads a "
              "subset of an equivalent cached prefix: predicate "
              "implied over Interval bounds, projection a subset, "
              "same source content)",
    "DTA503": "unsound to share (plans overlap textually or "
              "structurally but sharing is refused, with the reason — "
              "e.g. a nondeterministic UDF in the shared prefix, or "
              "differing source content)",
    # -- runtime-only (DTA9xx) ---------------------------------------------
    "DTA901": "internal: op kind cannot ride a wave program",
    "DTA902": "internal: unknown exchange kind in streamed plan",
    "DTA903": "bucket capacity overflow during wave exchange",
    "DTA904": "wave exchange still overflowing after capacity retries",
    "DTA905": "worker cannot resolve a plan callable (missing --fn-module)",
    # multi-tenant job service admission (dryad_tpu/service): typed,
    # code-carrying rejections raised BEFORE any work starts
    "DTA910": "job service: unknown app or malformed job spec",
    "DTA911": "job service: tenant admission queue full (backpressure — "
              "resubmit later)",
    "DTA912": "job service: tenant failure budget exhausted",
    "DTA913": "job service: daemon is draining/stopped — submission "
              "refused",
    # durable service (dryad_tpu/service/durable): raised at daemon
    # START, refusing to recover over bad durable state rather than
    # silently restoring a partial view
    "DTA914": "job service: write-ahead journal corrupt or its format "
              "version unsupported — recovery refused",
}

# codes with NO static-analyzer rule, by design: data-dependent
# overflows, internal invariants, worker-side deploy failures and the
# service's admission refusals
RUNTIME_ONLY_CODES = frozenset({"DTA901", "DTA902", "DTA903", "DTA904",
                                "DTA905", "DTA910", "DTA911", "DTA912",
                                "DTA913", "DTA914"})


@dataclasses.dataclass(frozen=True)
class Span:
    """Source provenance: where the user wrote the offending construct.

    For Python UDF/plan findings ``file:line`` names a source file; for
    SQL findings (DTA3xx) the ``file`` slot names the query's origin
    (``<sql>`` or a ``.sql`` path) and ``col`` carries the 1-based
    column INSIDE the query text, rendered ``origin:line:column``."""

    file: str
    line: int
    func: str = ""
    col: int = 0

    def __str__(self) -> str:
        base = f"{self.file}:{self.line}"
        return f"{base}:{self.col}" if self.col else base

    @staticmethod
    def of(v: Any) -> Optional["Span"]:
        """Coerce a (file, line[, func]) tuple / Span / None."""
        if v is None or isinstance(v, Span):
            return v
        if isinstance(v, (tuple, list)) and len(v) >= 2:
            return Span(str(v[0]), int(v[1]), str(v[2]) if len(v) > 2
                        else "")
        return None


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding: stable code, severity, message, provenance."""

    code: str
    severity: str  # "error" | "warn" | "info"
    message: str
    span: Optional[Span] = None
    node: str = ""  # logical node / op the finding anchors to

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}")

    def render(self) -> str:
        where = f"{self.span}: " if self.span else ""
        at = f" [{self.node}]" if self.node else ""
        return f"{where}{self.severity} {self.code}: {self.message}{at}"


class DiagnosticReport:
    """All findings of one check() pass, reported at once (the whole
    point: every contract violation in ONE diagnostic sweep instead of
    one runtime failure at a time)."""

    def __init__(self, diagnostics: Iterable[Diagnostic] = ()):
        self.diagnostics: List[Diagnostic] = list(diagnostics)

    def add(self, code: str, severity: str, message: str,
            span: Any = None, node: str = "") -> None:
        self.diagnostics.append(Diagnostic(code, severity, message,
                                           Span.of(span), node))

    def __iter__(self):
        return iter(self.sorted())

    def __len__(self) -> int:
        return len(self.diagnostics)

    def sorted(self) -> List[Diagnostic]:
        return sorted(self.diagnostics,
                      key=lambda d: (SEVERITIES[d.severity], d.code,
                                     str(d.span or "")))

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "error"]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "warn"]

    @property
    def clean(self) -> bool:
        """No error/warn findings (info notes do not dirty a plan)."""
        return not self.errors and not self.warnings

    def codes(self) -> set:
        return {d.code for d in self.diagnostics}

    def by_code(self, code: str) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.code == code]

    def dedup(self) -> "DiagnosticReport":
        """Collapse findings that differ only by the consumer path that
        reached them: a construct consumed by N Tee'd branches reports
        once, annotated with the path count.  The message is part of
        the identity (two different defects at one span both stay).  In
        place; returns self."""
        groups: Dict[tuple, List[Diagnostic]] = {}
        for d in self.diagnostics:
            groups.setdefault((d.code, d.severity, d.span, d.node,
                               d.message), []).append(d)
        self.diagnostics = [
            g[0] if len(g) == 1 else dataclasses.replace(
                g[0], message=f"{g[0].message} [x{len(g)} consumer "
                              f"paths]")
            for g in groups.values()]
        return self

    def render(self) -> str:
        if not self.diagnostics:
            return "no findings"
        lines = [d.render() for d in self.sorted()]
        n_e, n_w = len(self.errors), len(self.warnings)
        n_i = len(self.diagnostics) - n_e - n_w
        lines.append(f"{n_e} error(s), {n_w} warning(s), {n_i} info")
        return "\n".join(lines)


class DiagnosticError(RuntimeError):
    """A runtime error that mirrors a static diagnostic: it carries the
    stable ``code`` and the offending construct's ``span``, so the
    message points at the user's query line (the SQL front end's
    ``SqlError`` is one)."""

    def __init__(self, message: str, code: Optional[str] = None,
                 span: Any = None):
        self.code = code
        self.span = Span.of(span)
        full = f"[{code}] {message}" if code else message
        if self.span is not None:
            full += f" (at {self.span})"
        super().__init__(full)


class LintError(RuntimeError):
    """Raised by the pre-submit gate (``JobConfig.lint="error"``) when
    the static analyzer reports error-severity findings: the job never
    reaches the executor."""

    def __init__(self, report: DiagnosticReport):
        self.report = report
        super().__init__(
            "static analysis found error-severity diagnostics "
            "(JobConfig.lint='error'):\n" + report.render())
