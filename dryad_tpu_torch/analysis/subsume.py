"""Subsumption: can one query's scan+filter prefix serve another?  The
port of ``dryad_tpu/analysis/subsume.py``; verdicts and messages are
the JAX package's.

The second half of the plan-equivalence analyzer (with
analysis/canon.py): given two plans over the same catalog, decide
whether work may be SHARED and emit an info-grade DTA5xx verdict:

* **DTA501 exact-equivalent** — canonical semantic fingerprints match:
  the cached plan, its compiled stages, and its results are shareable
  verbatim (a semantic plan-cache hit).
* **DTA502 subsumed-prefix** — query A's scan+filter prefix *contains*
  query B's: B's predicate implies A's (proved over the cost
  model's :class:`~dryad_tpu_torch.analysis.domain.Interval` bounds),
  B projects a subset of A's columns, and both read the same source
  content (``sql.catalog.table_fingerprint`` equality).  B could read
  A's Tee'd prefix output instead of paying a second cold scan.
* **DTA503 unsound-to-share** — the plans overlap (same source, or
  structurally equal shapes) but sharing is REFUSED, with the reason:
  a nondeterministic UDF in the shared prefix (per
  analysis/udf_lint — a replayed/shared evaluation would observe
  different values), differing source content behind one table name,
  or a standing query's side-effecting registration.

No verdict (``None``) means the plans are simply unrelated — nothing
to share, nothing unsound.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

from dryad_tpu_torch.analysis.canon import scan_prefix, \
    semantic_fingerprint
from dryad_tpu_torch.analysis.diagnostics import Diagnostic
from dryad_tpu_torch.analysis.domain import Interval

__all__ = ["Verdict", "compare", "implies", "bounds_of",
           "dataset_share_verdict", "prefix_nondet_findings"]


@dataclasses.dataclass(frozen=True)
class Verdict:
    """One share/refuse decision; ``code`` is DTA501/502/503."""

    code: str
    message: str
    # direction for DTA502: which side's prefix contains the other's
    detail: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def diagnostic(self) -> Diagnostic:
        return Diagnostic(self.code, "info", self.message, node="reuse")

    def render(self) -> str:
        return f"{self.code}: {self.message}"


# -- predicate implication over Interval bounds -------------------------


@dataclasses.dataclass(frozen=True)
class _Bounds:
    """Per-column constraint: the numeric hull as an
    :class:`~dryad_tpu_torch.analysis.domain.Interval` (``lo=-inf`` /
    ``hi=None`` for unbounded sides) plus open/closed flags."""

    iv: Interval
    lo_strict: bool = False
    hi_strict: bool = False

    def intersect(self, other: "_Bounds") -> "_Bounds":
        lo, los = max((self.iv.lo, self.lo_strict),
                      (other.iv.lo, other.lo_strict))
        if self.iv.hi is None:
            hi, his = other.iv.hi, other.hi_strict
        elif other.iv.hi is None:
            hi, his = self.iv.hi, self.hi_strict
        else:
            hi, his = min((self.iv.hi, not self.hi_strict),
                          (other.iv.hi, not other.hi_strict))
            his = not his
        return _Bounds(Interval(lo, hi), los, his)

    def contained_in(self, outer: "_Bounds") -> bool:
        """Every value satisfying ``self`` satisfies ``outer``."""
        if outer.iv.lo > self.iv.lo or (
                outer.iv.lo == self.iv.lo
                and outer.lo_strict and not self.lo_strict):
            return False
        if outer.iv.hi is not None:
            if self.iv.hi is None or self.iv.hi > outer.iv.hi or (
                    self.iv.hi == outer.iv.hi
                    and outer.hi_strict and not self.hi_strict):
                return False
        return True


_FREE = _Bounds(Interval(-math.inf, None))


def _bound_of_conjunct(c: List) -> Optional[Tuple[str, _Bounds]]:
    """(column, bounds) for an interval-shaped canonical conjunct
    (col-vs-literal comparison), else None (residual)."""
    if c[0] != "bin":
        return None
    op, a, b = c[1], c[2], c[3]
    if a[0] == "col" and b[0] == "lit" \
            and isinstance(b[1], (int, float)) \
            and not isinstance(b[1], bool):
        col, v = a[1], float(b[1])
        if op == "=":
            return col, _Bounds(Interval(v, v))
        if op == "<":
            return col, _Bounds(Interval(-math.inf, v), hi_strict=True)
        if op == "<=":
            return col, _Bounds(Interval(-math.inf, v))
    elif a[0] == "lit" and b[0] == "col" \
            and isinstance(a[1], (int, float)) \
            and not isinstance(a[1], bool):
        col, v = b[1], float(a[1])
        if op == "=":                  # canon sorts col first for "=",
            return col, _Bounds(Interval(v, v))   # but stay defensive
        if op == "<":
            return col, _Bounds(Interval(v, None), lo_strict=True)
        if op == "<=":
            return col, _Bounds(Interval(v, None))
    return None


def bounds_of(conjuncts: List[List]
              ) -> Tuple[Dict[str, _Bounds], List[str]]:
    """({column: intersected bounds}, residual conjunct keys).
    Residuals are conjuncts the Interval domain cannot shape
    (disjunctions, col-vs-col comparisons, !=, string equality) —
    implication requires them verbatim."""
    import json
    bounds: Dict[str, _Bounds] = {}
    residual: List[str] = []
    for c in conjuncts:
        hit = _bound_of_conjunct(c)
        if hit is None:
            residual.append(json.dumps(c, sort_keys=True, default=str))
        else:
            col, b = hit
            bounds[col] = bounds.get(col, _FREE).intersect(b)
    return bounds, residual


def implies(p: List[List], q: List[List]) -> bool:
    """Does predicate ``p`` (conjunct list) imply predicate ``q``?
    Sound, not complete: every interval constraint of q must contain
    p's interval for that column, and every residual conjunct of q
    must appear verbatim among p's conjuncts.  ``[]`` is TRUE (implied
    by anything)."""
    pb, pr = bounds_of(p)
    qb, qr = bounds_of(q)
    for col, outer in qb.items():
        if not pb.get(col, _FREE).contained_in(outer):
            return False
    return set(qr) <= set(pr)


# -- bound SQL statement comparison -------------------------------------


def compare(catalog, bound_a, bound_b) -> Optional[Verdict]:
    """Share verdict for two bound SQL statements over one catalog:
    DTA501 / DTA502 / DTA503 / None (unrelated).  ``bound_a`` plays
    the cached/running side, ``bound_b`` the new submission."""
    fa = semantic_fingerprint(catalog, bound_a)
    fb = semantic_fingerprint(catalog, bound_b)
    if fa == fb:
        if bound_b.emit_every is not None:
            return Verdict(
                "DTA503",
                f"plans are semantically equivalent ({fa}) but the "
                f"submission is a standing query (EMIT EVERY) — its "
                f"registration is stateful, one-shot results are not "
                f"shareable", {"fingerprint": fa})
        return Verdict(
            "DTA501",
            f"semantically equivalent to cached plan {fa} — plan, "
            f"compiled stages, and results shareable verbatim, zero "
            f"compile", {"fingerprint": fa})
    pa, pb = scan_prefix(catalog, bound_a), scan_prefix(catalog,
                                                       bound_b)
    if pa is None or pb is None or pa["table"] != pb["table"]:
        return None
    if pa["content"] != pb["content"]:
        return Verdict(
            "DTA503",
            f"both plans scan table {pa['table']!r} but the source "
            f"content fingerprints differ ({pa['content']} vs "
            f"{pb['content']}) — a shared scan would serve stale "
            f"rows", {"table": pa["table"]})
    if set(pb["columns"]) <= set(pa["columns"]) \
            and implies(pb["filter"], pa["filter"]):
        return Verdict(
            "DTA502",
            f"scan+filter prefix of the cached plan subsumes this "
            f"query over {pa['table']!r}: predicate implied over "
            f"Interval bounds, projection a subset — the Tee'd cached "
            f"scan serves both", {"table": pa["table"],
                                  "direction": "cached-covers-new"})
    if set(pa["columns"]) <= set(pb["columns"]) \
            and implies(pa["filter"], pb["filter"]):
        return Verdict(
            "DTA502",
            f"this query's scan+filter prefix subsumes the cached "
            f"plan over {pa['table']!r} — sharing is possible in the "
            f"other direction", {"table": pa["table"],
                                 "direction": "new-covers-cached"})
    return None


# -- api.Dataset DAG sharing --------------------------------------------


def _prefix_nodes(root) -> List[Any]:
    """The scan prefix of a Dataset DAG: every Source plus the
    single-parent Map/Filter chain above each (the segment a shared
    Tee'd edge would serve)."""
    from dryad_tpu_torch.plan import expr as E
    nodes = list(E.walk(root))
    prefix: List[Any] = []
    for n in nodes:
        if isinstance(n, E.Source):
            prefix.append(n)
            cur = n
            while True:
                nxt = [m for m in nodes
                       if cur in m.parents
                       and isinstance(m, (E.Map, E.Filter))
                       and len(m.parents) == 1]
                if len(nxt) != 1:
                    break
                cur = nxt[0]
                prefix.append(cur)
    return prefix


def prefix_nondet_findings(root) -> List[Diagnostic]:
    """udf_lint findings (DTA101/102/103) for every callable in a
    DAG's scan prefix — the evidence a DTA503 refusal cites."""
    import dataclasses as _dc

    from dryad_tpu_torch.analysis.udf_lint import lint_udf
    out: List[Diagnostic] = []
    for n in _prefix_nodes(root):
        for f in _dc.fields(n):
            v = getattr(n, f.name)
            if callable(v) and not hasattr(v, "__ship_payload__"):
                out.extend(d for d in lint_udf(v, role=f.name)
                           if d.code in ("DTA101", "DTA102", "DTA103"))
    return out


def dataset_share_verdict(root_a, root_b) -> Optional[Verdict]:
    """Share verdict for two api.Dataset DAGs (their root plan nodes):
    DTA503 when a nondeterministic UDF sits in either scan prefix
    (sharing one evaluation is unsound even for structurally equal
    DAGs — each run legitimately observes different values), DTA501
    when the canonical DAG fingerprints match, else None."""
    from dryad_tpu_torch.analysis.canon import node_fingerprint
    nondet = prefix_nondet_findings(root_a) \
        + prefix_nondet_findings(root_b)
    if nondet:
        why = "; ".join(sorted({d.message for d in nondet}))
        return Verdict(
            "DTA503",
            f"nondeterministic UDF in the scan prefix — sharing one "
            f"evaluation is unsound ({why})",
            {"findings": [d.code for d in nondet]})
    fa, fb = node_fingerprint(root_a), node_fingerprint(root_b)
    if fa == fb:
        return Verdict(
            "DTA501",
            f"semantically equivalent DAGs (canonical fingerprint "
            f"{fa}) — compiled stages and cached results shareable",
            {"fingerprint": fa})
    return None
