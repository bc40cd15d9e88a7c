"""Adaptive execution manager: the stage-boundary rewrite driver — the
port of ``dryad_tpu/adapt/manager.py``.

``exec/recovery.Run`` calls :meth:`AdaptiveManager.on_stage_materialized`
after every synchronous stage completion (where measured rows per
partition exist); the manager records the
:class:`~dryad_tpu_torch.adapt.stats.StageStats`, opens a
:class:`~dryad_tpu_torch.adapt.rewrite.PlanRewriter` window over the
unexecuted stages, and runs the
:class:`~dryad_tpu_torch.adapt.rules.ConnectionManager` rules — Dryad's
graph manager dispatching ``NotifyUpstreamVertexCompleted`` to each
stage's DrConnectionManager.

Contract:

* ``JobConfig.adaptive == "off"`` means this object is never built: no
  plan mutation, and the deferred settle stays on.  ``"on"`` needs each
  stage's rows on the host, so the run reads every stage's info back
  when it runs (the synchronous path).
* A rule failure never fails the job: a rule that raises (a
  :class:`~dryad_tpu_torch.adapt.rewrite.RewriteError` guard among
  them) becomes an ``adapt_skipped`` event and the plan proceeds
  un-rewritten.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Set

from dryad_tpu_torch.adapt.rewrite import PlanRewriter, RewriteError
from dryad_tpu_torch.adapt.rules import RuleContext, default_rules
from dryad_tpu_torch.adapt.stats import StageStats
from dryad_tpu_torch.obs.metrics import REGISTRY, family_counter
from dryad_tpu_torch.plan.stages import StageGraph

__all__ = ["AdaptiveManager", "levels_of_mesh"]


def levels_of_mesh(mesh) -> tuple:
    """Mesh -> ((axis, size), ...) innermost first, the planner's
    ``levels`` orientation.  On a worker gang the outermost axis is the
    process boundary (dcn), so the topology-aware rules see the gang's
    structure."""
    if mesh is None:
        return ()
    return tuple(reversed(mesh.axes))


class AdaptiveManager:
    """One per :class:`~dryad_tpu_torch.exec.recovery.Run` when
    ``JobConfig.adaptive == "on"``."""

    def __init__(self, graph: StageGraph, config, nparts: int,
                 levels: tuple = (),
                 event: Optional[Callable[[dict], None]] = None,
                 rules=None, cost_report=None):
        self.graph = graph
        self.config = config
        self.nparts = nparts
        self.levels = tuple(levels)
        self._event = event or (lambda e: None)
        self.rules = list(rules) if rules is not None else default_rules()
        self.stats: Dict[int, StageStats] = {}
        # static per-stage bounds of the run's cost report
        # (analysis/cost.CostReport), or None: rules read them as PRIORS
        # for stages that have not materialized yet (rules.rows_bounds)
        self.cost = cost_report
        self.applied: List[dict] = []   # graph_rewrite payloads, in order

    @property
    def rewrite_count(self) -> int:
        return len(self.applied)

    def on_stage_materialized(self, st: StageStats,
                              executed: Set[int]) -> None:
        """The boundary hook.  ``executed`` is the set of stage ids with
        materialized results (including ``st.stage``)."""
        self.stats[st.stage] = st

        def emit(e: dict) -> None:
            # stamp emission time here: a bare-callable sink (a list
            # append) does not
            e.setdefault("ts", round(time.time(), 4))
            self._event(e)

        emit(st.event())
        rw = PlanRewriter(self.graph, executed)
        ctx = RuleContext(rw=rw, stats=self.stats, config=self.config,
                          nparts=self.nparts, levels=self.levels,
                          cost=self.cost)
        for rule in self.rules:
            try:
                events = rule.on_stage_done(ctx, st)
            except RewriteError as e:
                events = [{"event": "adapt_skipped", "rule": rule.name,
                           "stage": st.stage, "reason": str(e)}]
            except Exception as e:   # a rule bug must not fail the job
                events = [{"event": "adapt_skipped", "rule": rule.name,
                           "stage": st.stage,
                           "reason": f"rule error: {e!r}"}]
            for ev in events:
                emit(ev)
                if ev.get("event") == "graph_rewrite":
                    self.applied.append(ev)
                    family_counter(REGISTRY, "graph_rewrites",
                                   rule=ev.get("rule", "?"),
                                   kind=ev.get("kind", "?")).inc()
