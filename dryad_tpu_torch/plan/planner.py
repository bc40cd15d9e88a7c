"""Logical -> physical lowering — the subset of
``dryad_tpu/plan/planner.py`` that the WordCount slice needs.

Row-local ops grow a fragment along each edge; stages are cut at
exchanges and at fan-out (a node consumed twice is materialized once).
GroupBy lowers to partial group -> hash exchange -> final group (the
IDecomposable / PARTIALAGGR pattern), so P = 8 plans exactly as the JAX
package plans on its 8-device mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from dryad_tpu_torch.ops.kernels import NotPortedYet
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


class Planner:
    def __init__(self, npartitions: int):
        self.nparts = npartitions
        self.stages: List[Stage] = []
        self.frags: Dict[int, Fragment] = {}
        self.consumers: Dict[int, int] = {}

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
            frag = self._lower(n)
            if self.consumers.get(n.id, 0) > 1:
                _, frag = self._materialize(
                    frag, label=f"tee:{type(n).__name__}")
            self.frags[n.id] = frag
        out_id, _ = self._materialize(self.frags[root.id], label="output")
        return StageGraph(self.stages, out_id)

    def _frag(self, n: E.Node) -> Fragment:
        f = self.frags[n.id]
        return Fragment(f.src, list(f.ops), f.capacity, f.partitioning)

    def _lower(self, n: E.Node) -> Fragment:
        if isinstance(n, E.Source):
            return Fragment(("source", n.data), [], n.data.capacity,
                            n.partitioning)

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

        if isinstance(n, E.GroupByAgg):
            f = self._frag(n.parents[0])
            keys = tuple(n.keys)
            if any(not isinstance(v, tuple) for v in n.aggs.values()):
                raise NotPortedYet("user-defined Decomposable aggregates",
                                   "GroupByReduce")
            if self.nparts == 1:
                # one partition: everything is co-located already
                f.ops.append(StageOp("group", {"keys": keys,
                                               "aggs": dict(n.aggs)}))
                f.partitioning = E.Partitioning("hash", keys)
                return f
            if f.partitioning.kind == "hash" and f.partitioning.keys == keys:
                # partition elimination: already co-located by these keys
                f.ops.append(StageOp("group", {"keys": keys,
                                               "aggs": dict(n.aggs)}))
                return f
            partial, final, mean_cols = _decompose_aggs(n.aggs)
            f.ops.append(StageOp("group", {"keys": keys, "aggs": partial}))
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

        raise TypeError(f"planner: unhandled node {type(n).__name__}")


def plan_query(root: E.Node, npartitions: int) -> StageGraph:
    return Planner(npartitions).plan(root)
