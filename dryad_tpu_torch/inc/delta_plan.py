"""Incremental re-plan: decide how a standing query refreshes — the port
of ``dryad_tpu/inc/delta_plan.py``, verdict text for verdict text.

The analogue of the reference's decomposability analysis
(IDecomposable.cs) turned toward TIME instead of the shuffle: a bound
SELECT whose aggregate suffix is built from decomposable kinds
(sum/count/min/max/mean — plan/planner.py's own builtin triples) can
run its pipeline over ONLY the chunks appended since the last
watermark and ``merge`` the partial into persisted per-group state;
everything else (joins over the growing table, DISTINCT, ORDER BY,
LIMIT, HAVING) falls back to a full re-run.

The verdict is static — shape only, readable off the BoundSelect — and
surfaces as info-grade DTA4xx diagnostics in ``EXPLAIN`` so a user
knows BEFORE registering whether their standing query will pay O(delta)
or O(store) per refresh:

* DTA401 — runs incrementally (with the state-column layout),
* DTA402 — full re-run fallback (with the offending constructs),
* DTA403 — (refresh-time, not static) the cost model chose a rebuild
  for one refresh because the delta was most of the store.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from dryad_tpu_torch.analysis.diagnostics import DiagnosticReport
from dryad_tpu_torch.sql.binder import BoundSelect

__all__ = ["DeltaPlan", "plan_delta", "state_statement",
           "render_verdict", "REBUILD_DELTA_FRACTION"]

# refresh-time cost rule (DTA403): when the un-merged delta exceeds
# this fraction of the store's total bytes, a refresh rebuilds state
# from a full scan instead of merging — the merge bookkeeping would
# cost more than it saves (mirrors the DTA2xx "predicted spill" style
# of static byte arithmetic over manifest stats)
REBUILD_DELTA_FRACTION = 0.5


@dataclasses.dataclass
class DeltaPlan:
    """The static refresh verdict for one bound statement."""

    decomposable: bool
    shape: Optional[str]        # "aggregate" | "append" | None (rescan)
    reasons: List[str]          # why not decomposable (DTA402 detail)
    # aggregate shape: the state query's aggregate set (mean split into
    # sum+count components) and how persisted state columns finalize
    # into the SELECT's output columns
    state_aggs: Dict[str, Tuple[str, Optional[str]]]
    # out name -> ("key", phys) | ("state", state_col)
    #           | ("mean", sum_col, cnt_col)
    finalize: Dict[str, tuple]
    group_keys: List[str]
    report: DiagnosticReport
    code: str                   # DTA401 | DTA402

    @property
    def mode(self) -> str:
        return "incremental" if self.decomposable else "rescan"


def _fresh_name(base: str, taken) -> str:
    name = base
    while name in taken:
        name += "_"
    return name


def plan_delta(catalog, bound: BoundSelect) -> DeltaPlan:
    """Classify a bound statement's refresh mode (see module
    docstring).  Pure shape analysis — no store IO, usable offline
    against a schema-only catalog (EXPLAIN)."""
    reasons: List[str] = []
    if bound.joins:
        reasons.append("JOIN (the growing table feeds both a scan and "
                       "a shuffle side)")
    if bound.distinct:
        reasons.append("DISTINCT (global dedup needs the full history)")
    if bound.order_by:
        reasons.append("ORDER BY (a total order is not mergeable)")
    if bound.limit is not None:
        reasons.append("LIMIT (top-N over history is not mergeable)")
    if bound.having is not None:
        reasons.append("HAVING (group filter re-evaluates over merged "
                       "state)")

    report = DiagnosticReport()
    span = bound.emit_span or bound.span
    if reasons:
        report.add("DTA402", "info",
                   "standing query falls back to a full re-run each "
                   "refresh: " + "; ".join(reasons), span=span,
                   node="sql")
        return DeltaPlan(False, None, reasons, {}, {}, [], report,
                         "DTA402")

    if not bound.grouped:
        # pure select/where/project: appends only ever ADD output rows
        # (chunk order is preserved), so each refresh emits exactly the
        # rows its delta produced — no persisted value state at all
        report.add("DTA401", "info",
                   "standing query runs incrementally: append-only "
                   "shape, each refresh emits the rows produced by the "
                   "new chunks", span=span, node="sql")
        return DeltaPlan(True, "append", [], {}, {}, [], report,
                         "DTA401")

    # aggregate shape: derive the state-column set.  mean splits into
    # engine-computed sum+count partials (the exact decomposition
    # plan/planner._decompose_aggs uses across the shuffle), merged
    # host-side and divided at finalize with the engine's arithmetic.
    state_aggs: Dict[str, Tuple[str, Optional[str]]] = {}
    finalize: Dict[str, tuple] = {}
    taken = set(bound.outputs) | set(bound.aggs) | set(bound.group_keys)
    mean_parts: Dict[str, Tuple[str, str]] = {}
    for out, (kind, in_col) in bound.aggs.items():
        if kind == "mean":
            s = _fresh_name(f"{out}__isum", taken)
            taken.add(s)
            c = _fresh_name(f"{out}__icnt", taken)
            taken.add(c)
            state_aggs[s] = ("sum", in_col)
            state_aggs[c] = ("count", None)
            mean_parts[out] = (s, c)
        else:
            state_aggs[out] = (kind, in_col)
    for out, prog in bound.outputs.items():
        src = prog[1]               # outputs are always ["col", name]
        if src in bound.aggs:
            kind = bound.aggs[src][0]
            finalize[out] = (("mean",) + mean_parts[src]
                             if kind == "mean" else ("state", src))
        else:
            finalize[out] = ("key", src)

    state_cols = ", ".join(sorted(state_aggs)) or "none"
    report.add("DTA401", "info",
               f"standing query runs incrementally: decomposable "
               f"aggregate suffix merges each refresh's partial into "
               f"persisted state (state columns: "
               f"{len(bound.group_keys)} key(s) + {state_cols})",
               span=span, node="sql")
    return DeltaPlan(True, "aggregate", [], state_aggs, finalize,
                     list(bound.group_keys), report, "DTA401")


def state_statement(bound: BoundSelect, plan: DeltaPlan) -> BoundSelect:
    """The statement one refresh actually runs over the chunk delta.

    For the append shape it IS the original statement (order/limit/
    distinct are absent by construction).  For the aggregate shape the
    SELECT's aggregates are swapped for the state-column set and the
    output projection keeps the group keys + raw state columns — the
    engine computes per-group PARTIALS over the delta, and the host
    merge/finalize (inc/refresh.py) does the rest."""
    if plan.shape != "aggregate":
        return bound
    outputs: Dict[str, list] = {}
    output_types: Dict[str, str] = {}
    for k in bound.group_keys:
        outputs[k] = ["col", k]
        output_types[k] = "int"
    for s in plan.state_aggs:
        outputs[s] = ["col", s]
        output_types[s] = "int"
    return dataclasses.replace(
        bound, aggs=dict(plan.state_aggs), outputs=outputs,
        output_types=output_types, having=None, order_by=[],
        limit=None, distinct=False)


def render_verdict(catalog, bound: BoundSelect, plan: DeltaPlan) -> str:
    """The EXPLAIN section for a standing query: cadence, verdict
    diagnostics, and (for store-backed tables) the manifest-seeded
    per-refresh scan arithmetic."""
    lines = [f"standing query: refresh every {bound.emit_every:g}s "
             f"-> {plan.mode}"]
    lines.extend(d.render() for d in plan.report.sorted())
    t = catalog.get(bound.base_table)
    if t is not None and t.kind == "store" and plan.decomposable:
        from dryad_tpu_torch.io.store import store_generation, store_meta
        try:
            meta = store_meta(t.path)
        except OSError:
            return "\n".join(lines)
        total = sum(meta.get("bytes", ()))
        lines.append(
            f"  base store {bound.base_table!r}: generation "
            f"{store_generation(meta)}, {int(meta['npartitions'])} "
            f"chunk(s), {total} byte(s) total — each refresh scans "
            f"only chunks past its watermark (full scan would pay "
            f"{total} byte(s) every refresh)")
    return "\n".join(lines)
