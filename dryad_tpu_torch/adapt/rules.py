"""Connection-manager rules: the three stage-boundary rewrites — the
port of ``dryad_tpu/adapt/rules.py``, whose decisions, capacities and
event payloads it keeps unchanged.

Each rule mirrors one of Dryad's dynamic graph managers
(``DrConnectionManager`` subclasses):

* :class:`DynamicAggregationTree` — ``DrDynamicAggregateManager``: pick
  the combine-tree depth from MEASURED partial-output sizes and the mesh
  topology: collapse a hierarchical merge chain to one global exchange
  when the measured data is tiny, or expand a flat merge into per-axis
  hops when it is huge and the mesh has more than one level.  Both need
  a multi-level mesh; on the port's one-axis mesh the rule declines.
* :class:`SkewRepartition` — ``DrDynamicDistributionManager``: right-size
  a downstream exchange from observed rows (coalesce: shrink the padded
  capacity the planner guessed; split: pre-salt a saltable join or
  pre-raise send slack) when a partition exceeds the sibling-median skew
  factor (adapt/thresholds.py).
* :class:`BroadcastManager` — ``DrDynamicBroadcastManager``: flip a
  planned broadcast join to a hash exchange when the measured build side
  blew its estimate, and promote a hash-hash join to broadcast when the
  build side measured tiny.

Rules receive a :class:`~dryad_tpu_torch.adapt.rewrite.PlanRewriter` window
plus the accumulated :class:`~dryad_tpu_torch.adapt.stats.StageStats`; they
mutate only after every precondition holds and return event payloads
(``kind`` + before/after topology) the manager emits as
``graph_rewrite`` events.  SPMD partition COUNT is fixed by the mesh, so
"repartitioning" here reshapes capacity, salting, slack, and tree depth
— the placement levers that exist under static SPMD shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

from dryad_tpu_torch.adapt.rewrite import PlanRewriter
from dryad_tpu_torch.adapt.stats import StageStats
from dryad_tpu_torch.plan.stages import Exchange, Leg, Stage, StageOp

__all__ = ["ConnectionManager", "RuleContext", "rows_bounds",
           "DynamicAggregationTree", "SkewRepartition",
           "BroadcastManager", "default_rules", "NON_EXPANDING_OPS"]

# op kinds that can only PRESERVE or REDUCE row counts: a producer's
# measured rows upper-bound the exchange input through any chain of
# these, so capacity decisions made from producer stats stay sound.
# Expanders (flat_tokens / flat_map / join / group_apply / apply / zip /
# concat / apply2 / sliding_window) are deliberately absent.
NON_EXPANDING_OPS = frozenset({
    "fn", "filter", "group", "dgroup_partial", "dgroup_local",
    "dgroup_merge", "distinct", "sort", "take", "skip", "take_while",
    "skip_while", "mean_fin", "row_index", "group_top_k", "group_rank",
    "recap",
})

_MERGE_KINDS = ("group", "dgroup_merge")


def _round_cap(rows: int) -> int:
    """Row bound -> exchange capacity, in multiples of 128 rows (the JAX
    package's grid, kept so that both packages rewrite to the same
    capacities)."""
    return max(128, -(-int(rows) // 128) * 128)


def _non_expanding(ops) -> bool:
    return all(op.kind in NON_EXPANDING_OPS for op in ops)


@dataclasses.dataclass
class RuleContext:
    """Everything a rule may consult: the rewrite window, all stats
    observed so far (stage id -> StageStats), the JobConfig, and the
    mesh topology as (axis, size) pairs INNERMOST FIRST — the same
    orientation as the planner's ``levels`` (on a driver this derives
    from the mesh; on a gang the process axis is the outermost entry,
    the role ``cluster.worker_hosts()`` plays for task placement)."""

    rw: PlanRewriter
    stats: Dict[int, StageStats]
    config: Any
    nparts: int
    levels: tuple  # ((axis_name, size), ...) innermost first
    # static per-stage bounds from the pre-submit cost pass
    # (analysis/cost.CostReport), or None: PRIORS for stages that have
    # not materialized yet — see :func:`rows_bounds`
    cost: Any = None


def rows_bounds(ctx: RuleContext, sid: int):
    """(lo, hi) total-row bounds for stage ``sid``: the MEASURED rows
    when the stage has materialized (exact — lo == hi), else the static
    cost analyzer's interval as a prior (analysis/cost.py), else None.
    Rules that needed both join sides measured can act one boundary
    earlier when the static bound for the other side is tight — the
    'static plan optimizer seeds the dynamic managers' direction of the
    reference's DrDynamicBroadcastManager."""
    st = ctx.stats.get(sid)
    if st is not None:
        return (st.total_rows, st.total_rows)
    if ctx.cost is not None:
        b = ctx.cost.rows_bounds(sid)
        if b is not None and b[1] is not None:
            return (int(b[0]), int(b[1]))
    return None


class ConnectionManager:
    """Plug-in interface (DrConnectionManager parity): one instance per
    run, ``on_stage_done`` called at every stage-materialization
    boundary with that stage's observed stats.  Return a list of event
    payload dicts; mutate the graph only through ``ctx.rw``."""

    name = "?"

    def on_stage_done(self, ctx: RuleContext,
                      st: StageStats) -> List[dict]:  # pragma: no cover
        raise NotImplementedError


# ---------------------------------------------------------------------------
# 1. dynamic aggregation trees


class DynamicAggregationTree(ConnectionManager):
    name = "agg_tree"

    def _merge_chain(self, ctx: RuleContext, first: Stage) -> List[Stage]:
        """Follow a hierarchical merge chain (single-leg stages whose
        exchange is axis-scoped hash on the same keys) starting at
        ``first``; returns [] unless it is a >=2-stage chain ending in
        the finalizing level."""
        chain = [first]
        keys = first.legs[0].exchange.keys
        while True:
            cur = chain[-1]
            nxt = [s for s in ctx.rw.consumers_of(cur.id)
                   if len(s.legs) == 1 and not s.legs[0].ops
                   and s.legs[0].exchange is not None
                   and s.legs[0].exchange.kind == "hash"
                   and s.legs[0].exchange.axis is not None
                   and s.legs[0].exchange.keys == keys
                   and s.body and s.body[0].kind in _MERGE_KINDS]
            if len(nxt) != 1 or len(ctx.rw.consumers_of(cur.id)) != 1 \
                    or ctx.rw.graph.out_stage == cur.id:
                break
            chain.append(nxt[0])
        return chain if len(chain) >= 2 else []

    def _collapse(self, ctx: RuleContext, st: StageStats) -> List[dict]:
        out = []
        limit = getattr(ctx.config, "adapt_agg_collapse_rows", 4096)
        for c in ctx.rw.consumers_of(st.stage):
            if (len(c.legs) != 1 or c.legs[0].src != st.stage
                    or c.legs[0].exchange is None
                    or c.legs[0].exchange.kind != "hash"
                    or c.legs[0].exchange.axis is None
                    or not c.body or c.body[0].kind not in _MERGE_KINDS
                    or not _non_expanding(c.legs[0].ops)):
                continue
            if st.total_rows > limit:
                out.append({"event": "adapt_skipped", "rule": self.name,
                            "stage": c.id,
                            "reason": f"measured rows {st.total_rows} > "
                                      f"collapse limit {limit}"})
                continue
            chain = self._merge_chain(ctx, c)
            if not chain:
                continue
            first, last = chain[0], chain[-1]
            before = ctx.rw.snapshot(*(s.id for s in chain))
            # one global exchange replaces the whole per-axis ladder:
            # the measured data is small enough that hop-per-fabric
            # buys nothing over a single all-to-all
            ex = last.legs[0].exchange
            last.legs[0] = Leg(first.legs[0].src, first.legs[0].ops,
                               Exchange("hash", keys=ex.keys,
                                        out_capacity=ex.out_capacity,
                                        axis=None))
            out.append({"event": "graph_rewrite", "rule": self.name,
                        "kind": "agg_tree_collapse", "stage": last.id,
                        "trigger_stage": st.stage,
                        "orphaned": [s.id for s in chain[:-1]],
                        "levels_before": len(chain), "levels_after": 1,
                        "before": before,
                        "after": ctx.rw.snapshot(last.id)})
        return out

    def _final_aggs_clone(self, op: StageOp) -> StageOp:
        """A merge level applied on top of another merge level: builtin
        final aggs (out -> (sum|min|max|any|all, out)) are idempotent
        under re-application, so the op clones as-is."""
        return StageOp(op.kind, dict(op.params), span=op.span)

    def _expand(self, ctx: RuleContext, st: StageStats) -> List[dict]:
        out = []
        limit = getattr(ctx.config, "adapt_agg_expand_rows", 1 << 20)
        if len(ctx.levels) < 2 or st.total_rows < limit:
            return out
        for c in ctx.rw.consumers_of(st.stage):
            if (len(c.legs) != 1 or c.legs[0].src != st.stage
                    or c.legs[0].exchange is None
                    or c.legs[0].exchange.kind != "hash"
                    or c.legs[0].exchange.axis is not None
                    or not c.legs[0].exchange.keys
                    or not c.body or c.body[0].kind not in _MERGE_KINDS
                    or c._salted):
                continue
            before = ctx.rw.snapshot(c.id)
            ex = c.legs[0].exchange
            axes = [name for name, _size in ctx.levels]
            # innermost axis hop stays on this stage; it stops finalizing
            ex.axis = axes[0]
            mean_fin = None
            if c.body[0].kind == "dgroup_merge":
                c.body[0].params["finalize"] = False
            if len(c.body) > 1 and c.body[-1].kind == "mean_fin":
                mean_fin = c.body.pop()
            # one appended merge stage per remaining (scarcer) fabric;
            # the LAST level finalizes (mean_fin / dgroup finalize)
            prev, new_ids = c, []
            for i, ax in enumerate(axes[1:], start=1):
                last = i == len(axes) - 1
                body_op = self._final_aggs_clone(c.body[0])
                if body_op.kind == "dgroup_merge":
                    body_op.params["finalize"] = last
                body = [body_op]
                if last and mean_fin is not None:
                    body.append(mean_fin)
                nst = ctx.rw.new_stage(
                    [Leg(prev.id, [],
                         Exchange("hash", keys=ex.keys,
                                  out_capacity=ex.out_capacity,
                                  axis=ax))],
                    body, f"{c.label}-{ax}")
                new_ids.append(nst.id)
                prev = nst
            ctx.rw.redirect_consumers(c.id, prev.id, exclude=new_ids)
            out.append({"event": "graph_rewrite", "rule": self.name,
                        "kind": "agg_tree_expand", "stage": c.id,
                        "trigger_stage": st.stage,
                        "levels_before": 1, "levels_after": len(axes),
                        "new_stages": new_ids,
                        "before": before,
                        "after": ctx.rw.snapshot(c.id, prev.id)})
        return out

    def on_stage_done(self, ctx: RuleContext,
                      st: StageStats) -> List[dict]:
        return self._collapse(ctx, st) + self._expand(ctx, st)


# ---------------------------------------------------------------------------
# 2. skew-aware repartitioning


class SkewRepartition(ConnectionManager):
    name = "skew_repartition"

    def on_stage_done(self, ctx: RuleContext,
                      st: StageStats) -> List[dict]:
        out: List[dict] = []
        cfg = ctx.config
        factor = getattr(cfg, "adapt_skew_factor", 4.0)
        shrink_at = getattr(cfg, "adapt_shrink_factor", 2.0)
        skewed = st.is_skewed(factor)
        for c in ctx.rw.consumers_of(st.stage):
            for li, leg in enumerate(c.legs):
                if leg.src != st.stage or leg.exchange is None:
                    continue
                if not _non_expanding(leg.ops):
                    out.append({"event": "adapt_skipped",
                                "rule": self.name, "stage": c.id,
                                "reason": "leg ops may expand rows — "
                                          "measured bound unusable"})
                    continue
                ex = leg.exchange
                # COALESCE: the planner sized this exchange at the
                # static capacity envelope; the destination can never
                # receive more rows than the measured total, so the
                # padded lanes past that bound are pure waste in every
                # downstream program
                cap_bound = _round_cap(st.total_rows)
                if (ex.out_capacity >= shrink_at * max(st.total_rows, 1)
                        and cap_bound < ex.out_capacity):
                    before = ctx.rw.snapshot(c.id)
                    old = ex.out_capacity
                    ex.out_capacity = cap_bound
                    out.append({"event": "graph_rewrite",
                                "rule": self.name,
                                "kind": "repartition_shrink",
                                "stage": c.id, "leg": li,
                                "trigger_stage": st.stage,
                                "cap_before": old,
                                "cap_after": cap_bound,
                                "before": before,
                                "after": ctx.rw.snapshot(c.id)})
                if not skewed:
                    continue
                # SPLIT: a >=factor-x-median partition is about to feed
                # this exchange.  For a saltable join, rewrite to the
                # hot-key-salted exchange BEFORE the first attempt (the
                # overflow-retry path reaches the same program one
                # wasted compile+run later); otherwise pre-size the
                # send-slot slack for the worst case of the peak
                # partition landing on one destination.
                if c.salt_ok and not c._salted and len(c.legs) == 2:
                    before = ctx.rw.snapshot(c.id)
                    c._salted = True
                    out.append({"event": "graph_rewrite",
                                "rule": self.name, "kind": "pre_salt",
                                "stage": c.id,
                                "trigger_stage": st.stage,
                                "skew_ratio": round(st.skew_ratio, 1),
                                "before": before,
                                "after": ctx.rw.snapshot(c.id)})
                elif ex.kind in ("hash", "range"):
                    need = -(-st.peak_rows * ctx.nparts
                             // max(ex.out_capacity, 1))
                    need = max(1, min(ctx.nparts, need))
                    cur = c._send_slack or getattr(
                        cfg, "initial_send_slack", 2)
                    if need > cur:
                        before = ctx.rw.snapshot(c.id)
                        c._send_slack = need
                        out.append({"event": "graph_rewrite",
                                    "rule": self.name,
                                    "kind": "send_slack",
                                    "stage": c.id, "leg": li,
                                    "trigger_stage": st.stage,
                                    "slack_before": cur,
                                    "slack_after": need,
                                    "skew_ratio":
                                        round(st.skew_ratio, 1),
                                    "before": before,
                                    "after": ctx.rw.snapshot(c.id)})
        return out


# ---------------------------------------------------------------------------
# 3. broadcast demotion / promotion


class BroadcastManager(ConnectionManager):
    name = "broadcast"

    @staticmethod
    def _cap_of(ctx: RuleContext, sid: int) -> int:
        """Per-partition capacity of stage ``sid``'s output: measured
        when available, else the static cost pass's prediction."""
        st = ctx.stats.get(sid)
        if st is not None and st.capacity:
            return st.capacity
        if ctx.cost is not None:
            return ctx.cost.capacity_of(sid)
        return 0

    def on_stage_done(self, ctx: RuleContext,
                      st: StageStats) -> List[dict]:
        out: List[dict] = []
        ratio = getattr(ctx.config, "adapt_broadcast_max_ratio", 0.25)
        for c in ctx.rw.graph.stages:
            if (ctx.rw.is_executed(c.id) or len(c.legs) != 2
                    or not c.body or c.body[0].kind != "join"):
                continue
            lsrc, rsrc = c.legs[0].src, c.legs[1].src
            # act only at the boundary that completed one of OUR inputs;
            # the OTHER side may ride the static cost pass's bounds as a
            # prior (rows_bounds) instead of waiting to be measured
            if st.stage not in (lsrc, rsrc):
                continue
            if not (isinstance(lsrc, int) and isinstance(rsrc, int)):
                continue
            lb, rb = rows_bounds(ctx, lsrc), rows_bounds(ctx, rsrc)
            if lb is None or rb is None:
                continue
            if not (_non_expanding(c.legs[0].ops)
                    and _non_expanding(c.legs[1].ops)):
                continue
            jop = c.body[0]
            how = jop.params.get("how", "inner")
            # conservative ends of the intervals: a flip must hold for
            # EVERY row count the bounds admit (measured sides are
            # exact, lo == hi)
            lt_lo, lt_hi = lb
            rt_lo, rt_hi = rb
            lt, rt = lt_hi, rt_hi
            lex, rex = c.legs[0].exchange, c.legs[1].exchange
            if rex is not None and rex.kind == "broadcast":
                # DEMOTE: the "small" side measured past the planner's
                # estimate — replicating it nparts-ways loses to a pair
                # of hash exchanges
                if how not in ("inner", "left"):
                    continue
                # demotion must hold at the interval ends that FAVOR
                # keeping the broadcast: certainly-oversized build side
                # (rt_lo) vs the largest possible probe side (lt_hi)
                if rt_lo <= ratio * max(lt_hi, 1):
                    continue
                if getattr(c, "placement_relied", False):
                    out.append({"event": "adapt_skipped",
                                "rule": self.name, "stage": c.id,
                                "reason": "downstream relied on this "
                                          "join's output placement"})
                    continue
                before = ctx.rw.snapshot(c.id)
                c.legs[1].exchange = Exchange(
                    "hash", keys=tuple(jop.params["right_keys"]),
                    out_capacity=self._cap_of(ctx, rsrc)
                    or _round_cap(rt))
                if lex is None:
                    c.legs[0].exchange = Exchange(
                        "hash", keys=tuple(jop.params["left_keys"]),
                        out_capacity=self._cap_of(ctx, lsrc)
                        or _round_cap(lt))
                # now the canonical 2-hash inner/left shape: the salted
                # skew escape applies to it like any planned hash join
                c.salt_ok = True
                out.append({"event": "graph_rewrite", "rule": self.name,
                            "kind": "broadcast_demote", "stage": c.id,
                            "trigger_stage": st.stage,
                            "left_rows": lt, "right_rows": rt,
                            "before": before,
                            "after": ctx.rw.snapshot(c.id)})
            elif (c.salt_ok and not c._salted
                  and lex is not None and rex is not None
                  and lex.kind == "hash" and rex.kind == "hash"
                  and how in ("inner", "left")):
                # PROMOTE: the build side is tiny — replicate it and
                # keep the probe side IN PLACE (drops the expensive
                # big-side exchange entirely).  salt_ok guarantees no
                # downstream stage assumed this join's output placement.
                # Conservative ends: the LARGEST possible build side
                # (rt_hi) must stay within ratio of the SMALLEST
                # possible probe side (lt_lo).
                if not rt_hi or rt_hi > ratio * max(lt_lo, 1):
                    continue
                before = ctx.rw.snapshot(c.id)
                c.legs[1].exchange = Exchange(
                    "broadcast", out_capacity=_round_cap(rt))
                c.legs[0].exchange = None
                c.salt_ok = False
                out.append({"event": "graph_rewrite", "rule": self.name,
                            "kind": "broadcast_promote", "stage": c.id,
                            "trigger_stage": st.stage,
                            "left_rows": lt, "right_rows": rt,
                            "before": before,
                            "after": ctx.rw.snapshot(c.id)})
        return out


def default_rules() -> List[ConnectionManager]:
    """Rule order matters: tree shape first, then join strategy, then
    capacity/slack sizing — so the sizing pass sees post-flip
    exchanges."""
    return [DynamicAggregationTree(), BroadcastManager(),
            SkewRepartition()]
