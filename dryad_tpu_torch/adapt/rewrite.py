"""Stage-graph mutation over the NOT-YET-EXECUTED stages — the port of
``dryad_tpu/adapt/rewrite.py``.

Dryad's connection managers restructure the running DrGraph by splicing
vertices into stages whose inputs have not started
(``DrDynamicAggregateManager`` building machine->pod->overall trees from
completed-vertex sizes).  The physical plan here is a ``StageGraph``
executed demand-driven (``exec/recovery.Run``), so the same capability
is a mutation window: between one stage's materialization and its
dependents' execution, rules may rewrite any stage that has not produced
output yet.

Invariants this module enforces (the "stable stage-id remapping"
contract):

* executed stages are IMMUTABLE — their ids, legs, and results stand;
  ``check()`` raises on any attempt to touch one;
* new stages get fresh ids appended at ``len(stages)`` — an id, once
  assigned, never changes meaning, so stage events / spill files /
  lineage edges recorded before a rewrite stay valid after it;
* redirecting consumers (``redirect_consumers``) only rewrites legs of
  unexecuted stages plus ``out_stage``; a bypassed stage becomes an
  orphan the demand-driven walk simply never visits.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Set

from dryad_tpu_torch.plan.stages import (Exchange, Leg, Stage, StageGraph,
                                         StageOp)

__all__ = ["RewriteError", "PlanRewriter", "describe_stage"]


class RewriteError(RuntimeError):
    """An adaptive rule attempted an illegal mutation (executed-stage
    touch, unknown stage).  Caught by the manager: the rewrite is
    skipped, the job proceeds on the un-rewritten plan."""


def _ex_desc(ex: Optional[Exchange]) -> Optional[str]:
    if ex is None:
        return None
    keys = ",".join(ex.keys)
    ax = f"@{ex.axis}" if ex.axis else ""
    return f"{ex.kind}({keys}){ax} cap={ex.out_capacity}"


def describe_stage(st: Stage) -> Dict[str, Any]:
    """Compact topology snapshot for ``graph_rewrite`` before/after
    payloads — enough for a viewer to draw the rewrite, small enough to
    ride every event."""
    return {"stage": st.id, "label": st.label,
            "legs": [{"src": (leg.src if isinstance(leg.src, int)
                              else leg.src[0]),
                      "ops": [op.kind for op in leg.ops],
                      "exchange": _ex_desc(leg.exchange)}
                     for leg in st.legs],
            "body": [op.kind for op in st.body],
            "salted": bool(st._salted),
            "slack": st._send_slack}


class PlanRewriter:
    """One rewrite window over ``graph`` given the set of executed stage
    ids.  Rules snapshot topology, mutate via the helpers, and return
    event payloads; the manager re-creates a rewriter per window so the
    executed set is always current."""

    def __init__(self, graph: StageGraph, executed: Set[int]):
        self.graph = graph
        self.executed = set(executed)

    # -- guards ------------------------------------------------------------

    def check(self, sid: int) -> Stage:
        if not (0 <= sid < len(self.graph.stages)):
            raise RewriteError(f"unknown stage {sid}")
        if sid in self.executed:
            raise RewriteError(
                f"stage {sid} already materialized — the executed prefix "
                f"is immutable")
        return self.graph.stage(sid)

    def is_executed(self, sid: int) -> bool:
        return sid in self.executed

    # -- queries -----------------------------------------------------------

    def consumers_of(self, sid: int) -> List[Stage]:
        """Unexecuted stages with a leg fed by ``sid``."""
        return [st for st in self.graph.stages
                if st.id not in self.executed
                and any(leg.src == sid for leg in st.legs)]

    def snapshot(self, *sids: int) -> List[Dict[str, Any]]:
        return [describe_stage(self.graph.stage(s)) for s in sids]

    # -- mutations ---------------------------------------------------------

    def new_stage(self, legs: List[Leg], body: List[StageOp],
                  label: str) -> Stage:
        """Append a stage under a fresh id (stable remapping: existing
        ids keep their meaning)."""
        st = Stage(id=len(self.graph.stages), legs=legs, body=body,
                   label=label)
        self.graph.stages.append(st)
        return st

    def redirect_consumers(self, old: int, new: int,
                           exclude=()) -> int:
        """Repoint every unexecuted consumer leg (and ``out_stage``)
        from ``old`` to ``new``; returns the number of edges moved.
        ``exclude`` lists stages whose legs must keep reading ``old`` —
        the stages a rule just inserted BETWEEN old and new (rewriting
        those would close a cycle: the first inserted hop reads old by
        construction)."""
        moved = 0
        skip = {new, *exclude}
        for st in self.graph.stages:
            if st.id in self.executed or st.id in skip:
                continue
            for leg in st.legs:
                if leg.src == old:
                    leg.src = new
                    moved += 1
                if (leg.exchange is not None
                        and leg.exchange.bounds_from == old):
                    leg.exchange.bounds_from = new
                    moved += 1
        if self.graph.out_stage == old:
            self.graph.out_stage = new
            moved += 1
        return moved
