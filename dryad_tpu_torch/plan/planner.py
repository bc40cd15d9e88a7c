"""Logical -> physical lowering — the subset of
``dryad_tpu/plan/planner.py`` that the ported slices need.

Row-local ops (select, where, tokenize, flat_map, apply_per_partition,
sliding_window, take) grow a fragment along each edge; stages are cut at
exchanges and at fan-out (a node consumed twice is materialized once).
GroupBy lowers to partial group -> hash exchange -> final group (the
IDecomposable / PARTIALAGGR pattern); with a user-defined
``Decomposable`` among the aggregates, to seed + merge -> exchange of
the flattened states -> merge + finalize. Distinct is a partial distinct
-> hash exchange -> distinct; the group-contents operators (group_apply
among them) co-locate by hash and run once. OrderBy materializes its
input, samples split points from it, range-exchanges on the primary key
and sorts locally by all keys. A Join is one stage of two legs, each
hash-exchanged on its keys unless already placed by them, and a body
``join`` op, or, for a broadcast join, the right leg is replicated to
every partition and the left one stays put. CrossApply is the same
two-leg shape (a broadcast right leg, the user's ``apply2``); the set
operators hash-exchange whole rows on both legs; Concat and Zip are two
legs and no exchange (the zip body realigns the right side itself).
WithRowIndex and SkipTake are row-local ops that read every partition's
count. A do_while Placeholder is a leg source bound at run time;
WithCapacity is a ``recap`` op. An exchange is elided where the input is
already placed as needed (partition elimination); the stages whose
placement was trusted are marked ``placement_relied`` (and never
salted). P = 8 plans exactly as the JAX package plans on its 8-device
mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from dryad_tpu_torch.ops.kernels import maximum, minimum
from dryad_tpu_torch.plan import expr as E
from dryad_tpu_torch.plan.stages import Exchange, Leg, Stage, StageGraph, \
    StageOp

__all__ = ["Planner", "plan_query"]


@dataclasses.dataclass
class Fragment:
    src: Any  # int stage id | ("source", data)
    ops: List[StageOp]
    capacity: int
    partitioning: E.Partitioning


def _decompose_aggs(aggs: Dict[str, Tuple[str, Optional[str]]]):
    """Aggregates -> (partial, final, mean columns): the partial runs
    before the exchange, the final merges partials after it."""
    partial: Dict[str, Tuple[str, Optional[str]]] = {}
    final: Dict[str, Tuple[str, Optional[str]]] = {}
    mean_cols: List[str] = []
    for out, (kind, col) in aggs.items():
        if kind == "count":
            partial[out] = ("count", None)
            final[out] = ("sum", out)
        elif kind in ("sum", "min", "max", "any", "all"):
            partial[out] = (kind, col)
            merge_kind = "sum" if kind == "sum" else kind
            final[out] = (merge_kind, out)
        elif kind == "mean":
            partial[out + "__sum"] = ("sum", col)
            partial[out + "__cnt"] = ("count", None)
            final[out + "__sum"] = ("sum", out + "__sum")
            final[out + "__cnt"] = ("sum", out + "__cnt")
            mean_cols.append(out)
        else:
            raise ValueError(f"aggregate kind {kind!r} not decomposable")
    return partial, final, mean_cols


def _ones(cols) -> torch.Tensor:
    """int32 ones, one per row of the columns."""
    v = next(iter(cols.values()))
    t = v.lengths if hasattr(v, "lengths") else v
    return torch.ones(t.shape[0], dtype=torch.int32, device=t.device)


def _mean_finalize(s):
    tot, cnt = s
    cf = torch.clamp(cnt, min=1)
    return tot / cf.to(tot.dtype) if tot.dtype.is_floating_point \
        else tot.to(torch.float32) / cf


def _builtin_as_decomposable(kind: str, col: Optional[str]):
    """A builtin aggregate kind as a Decomposable, for a group_by that
    mixes builtin kinds with user-defined Decomposables (the whole
    aggregation then runs through the segmented merge)."""
    if kind == "count":
        return E.Decomposable(_ones, lambda a, b: a + b, None)
    if kind == "sum":
        return E.Decomposable(lambda c: c[col], lambda a, b: a + b, None)
    if kind == "min":
        return E.Decomposable(lambda c: c[col], minimum, None)
    if kind == "max":
        return E.Decomposable(lambda c: c[col], maximum, None)
    if kind == "any":
        return E.Decomposable(lambda c: c[col].to(torch.bool),
                              lambda a, b: a | b, None)
    if kind == "all":
        return E.Decomposable(lambda c: c[col].to(torch.bool),
                              lambda a, b: a & b, None)
    if kind == "mean":
        return E.Decomposable(lambda c: (c[col], _ones(c)),
                              lambda a, b: (a[0] + b[0], a[1] + b[1]),
                              _mean_finalize)
    raise ValueError(f"aggregate kind {kind!r} not decomposable")


def _normalize_decs(aggs: Dict[str, Any]) -> Dict[str, Any]:
    """aggs (builtin tuples and/or Decomposables) -> out -> dec spec: the
    user's Decomposable itself, or a ("__builtin__", kind, col) tag that
    the kernel resolves (ops.kernels.resolve_dec_spec)."""
    return {name: spec if isinstance(spec, E.Decomposable)
            else ("__builtin__",) + tuple(spec)
            for name, spec in aggs.items()}


def _has_user_decs(aggs: Dict[str, Any]) -> bool:
    return any(isinstance(v, E.Decomposable) for v in aggs.values())


class Planner:
    def __init__(self, npartitions: int, hosts: int = 1, config=None,
                 levels: tuple = ()):
        self.nparts = npartitions
        self.hosts = hosts  # > 1: a multi-level mesh, hierarchical aggs
        # the hierarchy's axes, innermost first ("dp", ["host",] "dcn"):
        # one combine stage per level (the reference's machine -> pod ->
        # overall aggregation trees); the two-level default is dp -> dcn
        self.levels = tuple(levels) or (("dp", "dcn") if hosts > 1
                                        else ())
        self.config = config
        self.stages: List[Stage] = []
        self.frags: Dict[int, Fragment] = {}
        self.consumers: Dict[int, int] = {}
        # stage ids whose OUTPUT PLACEMENT a later lowering relied on
        # (partition elimination)
        self.placement_dependent: set = set()

    def _rely_on_placement(self, f: Fragment) -> None:
        if isinstance(f.src, int):
            self.placement_dependent.add(f.src)

    def _new_stage(self, legs: List[Leg], body: List[StageOp],
                   label: str) -> Stage:
        st = Stage(id=len(self.stages), legs=legs, body=body, label=label)
        self.stages.append(st)
        return st

    def _materialize(self, frag: Fragment,
                     label: str = "tee") -> Tuple[int, Fragment]:
        """Ensure the fragment is a stage output."""
        if isinstance(frag.src, int) and not frag.ops:
            return frag.src, frag
        st = self._new_stage([Leg(frag.src, frag.ops, None)], [], label)
        return st.id, Fragment(st.id, [], frag.capacity, frag.partitioning)

    def plan(self, root: E.Node) -> StageGraph:
        order = E.walk(root)
        for n in order:
            for p in n.parents:
                self.consumers[p.id] = self.consumers.get(p.id, 0) + 1
        for n in order:
            pre_stages = len(self.stages)
            frag = self._lower(n)
            if self.consumers.get(n.id, 0) > 1:
                _, frag = self._materialize(
                    frag, label=f"tee:{type(n).__name__}")
            self.frags[n.id] = frag
            # provenance: ops made lowering THIS node (in the pending
            # fragment or in the stages it cut) take its creation span;
            # ops carried over from earlier fragments keep their own
            span = getattr(n, "span", None)
            if span is not None:
                ops = list(frag.ops)
                for st in self.stages[pre_stages:]:
                    ops.extend(op for leg in st.legs for op in leg.ops)
                    ops.extend(st.body)
                for op in ops:
                    if op.span is None:
                        op.span = span
        out_id, _ = self._materialize(self.frags[root.id], label="output")
        # a placement claim flows back through exchange-less legs, so the
        # whole ancestor chain carrying it is relied upon
        dependent = set(self.placement_dependent)
        changed = True
        while changed:
            changed = False
            for st in self.stages:
                if st.id not in dependent:
                    continue
                for leg in st.legs:
                    if (leg.exchange is None and isinstance(leg.src, int)
                            and leg.src not in dependent):
                        dependent.add(leg.src)
                        changed = True
        for sid in dependent:
            self.stages[sid].salt_ok = False
            self.stages[sid].placement_relied = True
        return StageGraph(self.stages, out_id)

    def _lower_group_decomposable(self, f: Fragment, keys: Tuple[str, ...],
                                  aggs: Dict[str, Any]) -> Fragment:
        """GroupBy with user-defined Decomposables: seed + merge ->
        hash exchange of the flattened states -> merge + finalize.  The
        state treespecs travel through a box shared by the two ops (the
        partial always runs before its merge)."""
        decs = _normalize_decs(aggs)
        box: Dict[str, Any] = {}
        if self.nparts == 1 or (f.partitioning.kind == "hash"
                                and f.partitioning.keys == keys):
            if self.nparts > 1:
                self._rely_on_placement(f)
            f.ops.append(StageOp("dgroup_local", {"keys": keys,
                                                  "decs": decs, "box": box}))
            f.partitioning = E.Partitioning("hash", keys)
            return f
        f.ops.append(StageOp("dgroup_partial", {"keys": keys, "decs": decs,
                                                "box": box}))
        if self.levels:
            return self._combine_levels(f, keys, "dgroupby", lambda last: [
                StageOp("dgroup_merge", {"keys": keys, "decs": decs,
                                         "box": box, "finalize": last})])
        ex = Exchange("hash", keys=keys, out_capacity=f.capacity)
        st = self._new_stage(
            [Leg(f.src, f.ops, ex)],
            [StageOp("dgroup_merge", {"keys": keys, "decs": decs,
                                      "box": box, "finalize": True})],
            "dgroupby")
        return Fragment(st.id, [], f.capacity, E.Partitioning("hash", keys))

    def _combine_levels(self, f: Fragment, keys: Tuple[str, ...],
                        prefix: str, body_of) -> Fragment:
        """Hierarchical aggregation over the mesh axes (the reference's
        machine -> pod -> overall trees): one combine stage per level,
        innermost first, each exchanging over its own axis, so each
        scarcer level carries one partial per (level, key);
        ``body_of(last)`` is a level's body, the last one finalizing."""
        src, ops = f.src, f.ops
        for i, ax in enumerate(self.levels):
            ex = Exchange("hash", keys=keys, out_capacity=f.capacity,
                          axis=ax)
            st = self._new_stage([Leg(src, ops, ex)],
                                 body_of(i == len(self.levels) - 1),
                                 f"{prefix}-{ax}")
            src, ops = st.id, []
        return Fragment(st.id, [], f.capacity, E.Partitioning("hash", keys))

    def _frag(self, n: E.Node) -> Fragment:
        f = self.frags[n.id]
        return Fragment(f.src, list(f.ops), f.capacity, f.partitioning)

    def _colocate_then(self, f: Fragment, keys: Tuple[str, ...],
                       op: StageOp, label: str,
                       out_capacity: Optional[int] = None) -> Fragment:
        """Hash-co-locate rows by ``keys``, then apply ``op`` — the shared
        lowering of the group-contents operators; no exchange when the
        input already hashes on the same keys.  ``out_capacity`` is the
        op's output capacity (default: its input's)."""
        cap = out_capacity or f.capacity
        if self.nparts == 1 or (f.partitioning.kind == "hash"
                                and f.partitioning.keys == keys and keys):
            if self.nparts > 1:
                self._rely_on_placement(f)
            f.ops.append(op)
            f.capacity = cap
            f.partitioning = E.Partitioning("hash", keys)
            return f
        ex = Exchange("hash", keys=keys, out_capacity=f.capacity)
        st = self._new_stage([Leg(f.src, f.ops, ex)], [op], label)
        return Fragment(st.id, [], cap, E.Partitioning("hash", keys))

    def _lower(self, n: E.Node) -> Fragment:
        if isinstance(n, E.Source):
            return Fragment(("source", n.data), [], n.data.capacity,
                            n.partitioning)

        if isinstance(n, E.Placeholder):
            return Fragment(("placeholder", n.name), [], n.capacity or 0,
                            n.partitioning)

        if isinstance(n, E.Map):
            # the fragment's partitioning claim carries through, as in
            # the JAX planner
            f = self._frag(n.parents[0])
            f.ops.append(StageOp("fn", {"fn": n.fn, "label": n.label}))
            return f

        if isinstance(n, E.Filter):
            f = self._frag(n.parents[0])
            f.ops.append(StageOp("filter", {"fn": n.fn, "label": n.label}))
            return f

        if isinstance(n, E.FlatTokens):
            f = self._frag(n.parents[0])
            f.ops.append(StageOp("flat_tokens", {
                "column": n.column, "out_capacity": n.out_capacity,
                "max_token_len": n.max_token_len, "delims": n.delims,
                "lower": n.lower,
                "max_tokens_per_row": n.max_tokens_per_row}))
            f.capacity = n.out_capacity
            f.partitioning = E.Partitioning.none()
            return f

        if isinstance(n, E.FlatMap):
            f = self._frag(n.parents[0])
            f.ops.append(StageOp("flat_map", {
                "fn": n.fn, "out_capacity": n.out_capacity,
                "label": n.label}))
            f.capacity = n.out_capacity
            f.partitioning = E.Partitioning.none()
            return f

        if isinstance(n, E.ApplyPerPartition):
            f = self._frag(n.parents[0])
            f.ops.append(StageOp("apply", {"fn": n.fn, "label": n.label,
                                           "with_index": n.with_index}))
            f.partitioning = n.partitioning
            return f

        if isinstance(n, E.SlidingWindow):
            f = self._frag(n.parents[0])
            f.ops.append(StageOp("sliding_window", {"w": n.w}))
            f.partitioning = E.Partitioning.none()
            return f

        if isinstance(n, E.GroupByAgg):
            f = self._frag(n.parents[0])
            keys = tuple(n.keys)
            if _has_user_decs(n.aggs):
                return self._lower_group_decomposable(f, keys, n.aggs)
            if self.nparts == 1:
                # one partition: everything is co-located already
                f.ops.append(StageOp("group", {"keys": keys,
                                               "aggs": dict(n.aggs)}))
                f.partitioning = E.Partitioning("hash", keys)
                return f
            if f.partitioning.kind == "hash" and f.partitioning.keys == keys:
                # partition elimination: already co-located by these keys
                self._rely_on_placement(f)
                f.ops.append(StageOp("group", {"keys": keys,
                                               "aggs": dict(n.aggs)}))
                return f
            partial, final, mean_cols = _decompose_aggs(n.aggs)
            f.ops.append(StageOp("group", {"keys": keys, "aggs": partial}))
            if self.levels:
                return self._combine_levels(f, keys, "groupby", lambda last: [
                    StageOp("group", {"keys": keys, "aggs": final})] + (
                    [StageOp("mean_fin", {"cols": mean_cols})]
                    if last and mean_cols else []))
            ex = Exchange("hash", keys=keys, out_capacity=f.capacity)
            body = [StageOp("group", {"keys": keys, "aggs": final})]
            if mean_cols:
                body.append(StageOp("mean_fin", {"cols": mean_cols}))
            st = self._new_stage([Leg(f.src, f.ops, ex)], body, "groupby")
            return Fragment(st.id, [], f.capacity,
                            E.Partitioning("hash", keys))

        if isinstance(n, E.HashRepartition):
            f = self._frag(n.parents[0])
            if self.nparts == 1:
                f.partitioning = E.Partitioning("hash", tuple(n.keys))
                return f
            ex = Exchange("hash", keys=tuple(n.keys), out_capacity=f.capacity)
            st = self._new_stage([Leg(f.src, f.ops, ex)], [], "hashpartition")
            return Fragment(st.id, [], f.capacity,
                            E.Partitioning("hash", tuple(n.keys)))

        if isinstance(n, E.RangeRepartition):
            f = self._frag(n.parents[0])
            if self.nparts == 1:
                f.partitioning = E.Partitioning("range", tuple(n.keys))
                return f
            src_id, f = self._materialize(f, label="range-input")
            key = n.keys[0]
            ex = Exchange("range", keys=(key,), out_capacity=f.capacity,
                          bounds_from=src_id, bounds_key=key)
            st = self._new_stage([Leg(src_id, [], ex)], [], "rangepartition")
            return Fragment(st.id, [], f.capacity,
                            E.Partitioning("range", tuple(n.keys)))

        if isinstance(n, E.AssumePartitioning):
            f = self._frag(n.parents[0])
            f.partitioning = E.Partitioning(n.kind, tuple(n.keys))
            return f

        if isinstance(n, E.Take):
            f = self._frag(n.parents[0])
            f.ops.append(StageOp("take", {"n": n.n, "global": True}))
            return f

        if isinstance(n, E.WithRowIndex):
            f = self._frag(n.parents[0])
            f.ops.append(StageOp("row_index", {"column": n.column}))
            return f

        if isinstance(n, E.SkipTake):
            f = self._frag(n.parents[0])
            f.ops.append(StageOp(n.op, {"n": n.n} if n.op == "skip"
                                 else {"fn": n.fn}))
            return f

        if isinstance(n, E.Zip):
            lf = self._frag(n.parents[0])
            rf = self._frag(n.parents[1])
            st = self._new_stage(
                [Leg(lf.src, lf.ops, None), Leg(rf.src, rf.ops, None)],
                [StageOp("zip", {"suffix": n.suffix})], "zip")
            return Fragment(st.id, [], min(lf.capacity, rf.capacity),
                            E.Partitioning.none())

        if isinstance(n, E.WithCapacity):
            f = self._frag(n.parents[0])
            f.ops.append(StageOp("recap", {"capacity": n.capacity}))
            f.capacity = n.capacity
            return f

        if isinstance(n, E.Join):
            return self._lower_join(n)

        if isinstance(n, E.CrossApply):
            # the left leg stays where it is; the right one is replicated
            # to every partition
            lf = self._frag(n.parents[0])
            rf = self._frag(n.parents[1])
            rex = None if self.nparts == 1 else Exchange(
                "broadcast", out_capacity=rf.capacity * self.nparts)
            st = self._new_stage(
                [Leg(lf.src, lf.ops, None), Leg(rf.src, rf.ops, rex)],
                [StageOp("apply2", {"fn": n.fn, "label": n.label})],
                "cross_apply")
            return Fragment(st.id, [], lf.capacity, E.Partitioning.none())

        if isinstance(n, E.Broadcast):
            f = self._frag(n.parents[0])
            if self.nparts == 1:
                f.partitioning = E.Partitioning("replicated")
                return f
            ex = Exchange("broadcast", out_capacity=f.capacity * self.nparts)
            st = self._new_stage([Leg(f.src, f.ops, ex)], [], "broadcast")
            return Fragment(st.id, [], f.capacity * self.nparts,
                            E.Partitioning("replicated"))

        if isinstance(n, E.SetOp):
            return self._lower_set_op(n)

        if isinstance(n, E.Concat):
            lf = self._frag(n.parents[0])
            rf = self._frag(n.parents[1])
            st = self._new_stage(
                [Leg(lf.src, lf.ops, None), Leg(rf.src, rf.ops, None)],
                [StageOp("concat", {})], "concat")
            return Fragment(st.id, [], lf.capacity + rf.capacity,
                            E.Partitioning.none())

        if isinstance(n, E.GroupApply):
            f = self._frag(n.parents[0])
            keys = tuple(n.keys)
            oc = n.out_capacity or f.capacity
            op = StageOp("group_apply", {
                "keys": keys, "fn": n.fn,
                "max_groups": n.max_groups or f.capacity,
                "group_capacity": n.group_capacity,
                "out_rows": n.out_rows, "out_capacity": oc})
            return self._colocate_then(f, keys, op, "group_apply",
                                       out_capacity=oc)

        if isinstance(n, E.GroupTopK):
            f = self._frag(n.parents[0])
            op = StageOp("group_top_k", {
                "keys": tuple(n.keys), "k": n.k, "by": n.by,
                "descending": n.descending})
            return self._colocate_then(f, tuple(n.keys), op, "group_top_k")

        if isinstance(n, E.GroupRankSelect):
            f = self._frag(n.parents[0])
            op = StageOp("group_rank", {
                "keys": tuple(n.keys), "by": n.by, "rank": n.rank,
                "out": n.out})
            return self._colocate_then(f, tuple(n.keys), op, "group_rank")

        if isinstance(n, E.Distinct):
            f = self._frag(n.parents[0])
            keys = tuple(n.keys)
            if self.nparts == 1 or (f.partitioning.kind == "hash"
                                    and f.partitioning.keys == keys
                                    and keys):
                if self.nparts > 1:
                    self._rely_on_placement(f)
                f.ops.append(StageOp("distinct", {"keys": keys}))
                return f
            # a partial distinct, then the copies arriving from different
            # partitions are co-located and deduplicated once more
            f.ops.append(StageOp("distinct", {"keys": keys}))
            ex = Exchange("hash", keys=keys, out_capacity=f.capacity)
            st = self._new_stage([Leg(f.src, f.ops, ex)],
                                 [StageOp("distinct", {"keys": keys})],
                                 "distinct")
            return Fragment(st.id, [], f.capacity,
                            E.Partitioning("hash", keys))

        if isinstance(n, E.OrderBy):
            return self._lower_order_by(n)

        raise TypeError(f"planner: unhandled node {type(n).__name__}")

    def _lower_set_op(self, n: "E.SetOp") -> Fragment:
        """Both legs deduplicate locally (the right one not for a union)
        and hash-exchange whole rows, so equal rows meet; the body
        concatenates (union) or keeps the left rows found (intersect) or
        not found (except) on the right, then deduplicates the copies
        that arrived from different partitions."""
        lf = self._frag(n.parents[0])
        rf = self._frag(n.parents[1])
        lf.ops.append(StageOp("distinct", {"keys": ()}))
        if n.op != "union":
            rf.ops.append(StageOp("distinct", {"keys": ()}))
        lex = rex = None
        if self.nparts > 1:
            lex = Exchange("hash", keys=(), out_capacity=lf.capacity)
            rex = Exchange("hash", keys=(), out_capacity=rf.capacity)
        if n.op == "union":
            first, cap = StageOp("concat", {}), lf.capacity + rf.capacity
        elif n.op in ("intersect", "except"):
            first = StageOp("semi_anti", {"anti": n.op == "except"})
            cap = lf.capacity
        else:
            raise ValueError(n.op)
        st = self._new_stage(
            [Leg(lf.src, lf.ops, lex), Leg(rf.src, rf.ops, rex)],
            [first, StageOp("distinct", {"keys": ()})], n.op)
        return Fragment(st.id, [], cap, E.Partitioning("hash", ()))

    def _lower_join(self, n: "E.Join") -> Fragment:
        """Both legs hash-exchange on their keys unless already placed by
        them, or the right one is broadcast to every partition; the body
        joins."""
        lf = self._frag(n.parents[0])
        rf = self._frag(n.parents[1])
        lkeys, rkeys = tuple(n.left_keys), tuple(n.right_keys)
        out_cap = max(1, int(lf.capacity * n.expansion))
        bthresh = getattr(self.config, "broadcast_join_threshold", 0.0) \
            if self.config else 0.0
        broadcast_right = n.broadcast_right or (
            bthresh > 0 and rf.capacity * self.nparts <= bthresh * lf.capacity)
        if n.how in ("right", "full"):
            broadcast_right = False
        if self.nparts == 1:
            lex = rex = None
        elif broadcast_right:
            lex = None
            rex = Exchange("broadcast",
                           out_capacity=rf.capacity * self.nparts)
        else:
            lex = None if (lf.partitioning.kind == "hash"
                           and lf.partitioning.keys == lkeys) else \
                Exchange("hash", keys=lkeys, out_capacity=lf.capacity)
            rex = None if (rf.partitioning.kind == "hash"
                           and rf.partitioning.keys == rkeys) else \
                Exchange("hash", keys=rkeys, out_capacity=rf.capacity)
            if lex is None:
                self._rely_on_placement(lf)
            if rex is None:
                self._rely_on_placement(rf)
        st = self._new_stage(
            [Leg(lf.src, lf.ops, lex), Leg(rf.src, rf.ops, rex)],
            [StageOp("join", {"left_keys": lkeys, "right_keys": rkeys,
                              "out_capacity": out_cap, "how": n.how,
                              "right_unique": n.right_unique})],
            "join")
        # the JAX executor may salt this stage's exchanges on hot-key skew:
        # only the two-hash-exchange inner/left shape, and plan() clears
        # it where a later elimination trusted the placement
        st.salt_ok = (lex is not None and rex is not None
                      and n.how in ("inner", "left")
                      and not broadcast_right)
        # a broadcast join keeps the LEFT side's placement: each partition
        # holds the matches of its own left rows only
        out_part = lf.partitioning if broadcast_right \
            else E.Partitioning("hash", lkeys)
        return Fragment(st.id, [], out_cap, out_part)

    def _lower_order_by(self, n: "E.OrderBy") -> Fragment:
        f = self._frag(n.parents[0])
        sort_keys = tuple(k for k, _ in n.keys)
        all_asc = all(not d for _, d in n.keys)
        sort = StageOp("sort", {"keys": tuple(n.keys)})
        if self.nparts == 1:
            f.ops.append(sort)
            f.partitioning = (E.Partitioning("range", sort_keys) if all_asc
                              else E.Partitioning.none())
            return f
        pkeys = f.partitioning.keys
        if (f.partitioning.kind == "range" and all_asc
                and sort_keys == pkeys[:len(sort_keys)]):
            # exchange elimination (AssumeOrderBy): sound only when the
            # ascending sort keys are a PREFIX of the claimed range keys.
            # A range claim keeps the data globally sorted in partition
            # order but need not keep key ties together, so a key beyond
            # the claim, or a descending one, keeps its exchange.  A
            # stable local sort of claim-sorted partitions keeps the
            # whole claim.
            self._rely_on_placement(f)
            f.ops.append(sort)
            return f
        src_id, f = self._materialize(f, label="sort-input")
        primary, desc = n.keys[0]
        ex = Exchange("range", keys=(primary,), out_capacity=f.capacity,
                      descending=desc, bounds_from=src_id,
                      bounds_key=primary)
        st = self._new_stage([Leg(src_id, [], ex)], [sort], "orderby")
        # the exchange ranges on the primary only, but it routes equal
        # primary lanes to ONE destination, and the local sort orders
        # each partition by every key: globally sorted by all keys
        return Fragment(st.id, [], f.capacity,
                        E.Partitioning("range", sort_keys) if all_asc
                        else E.Partitioning.none())


def plan_query(root: E.Node, npartitions: int, hosts: int = 1,
               config=None, levels: tuple = ()) -> StageGraph:
    return Planner(npartitions, hosts=hosts, config=config,
                   levels=levels).plan(root)
