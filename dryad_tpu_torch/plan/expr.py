"""Logical query expression DAG — the subset of ``dryad_tpu/plan/expr.py``
that the WordCount slice plans: sources, the tokenizing SelectMany,
GroupBy with builtin decomposable aggregates, and explicit hash
repartition.  A ``Dataset`` method chain builds this DAG lazily; the
planner (``plan/planner.py``) lowers it to stages."""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, Optional, Tuple

__all__ = ["Partitioning", "Node", "Source", "FlatTokens", "GroupByAgg",
           "HashRepartition", "walk"]

_ids = itertools.count()


@dataclasses.dataclass(frozen=True)
class Partitioning:
    """How a dataset's rows are distributed over partitions."""

    kind: str  # "none" | "hash"
    keys: Tuple[str, ...] = ()

    @staticmethod
    def none() -> "Partitioning":
        return Partitioning("none")


class Node:
    """Base logical node.  Subclasses are dataclasses with ``parents``."""

    id: int
    parents: Tuple["Node", ...]

    def __post_init__(self):
        object.__setattr__(self, "id", next(_ids))

    @property
    def npartitions(self) -> int:
        return self.parents[0].npartitions

    @property
    def partitioning(self) -> Partitioning:
        return self.parents[0].partitioning


def _node(cls):
    return dataclasses.dataclass(frozen=True, eq=False)(cls)


@_node
class Source(Node):
    """Materialized input (a ``PData``)."""

    parents: Tuple[Node, ...]
    data: Any
    _npartitions: int
    _partitioning: Partitioning = Partitioning.none()

    @property
    def npartitions(self) -> int:
        return self._npartitions

    @property
    def partitioning(self) -> Partitioning:
        return self._partitioning


@_node
class FlatTokens(Node):
    """Tokenizing SelectMany over a string column (the WordCount kernel)."""

    parents: Tuple[Node, ...]
    column: str
    out_capacity: int
    max_token_len: int = 24
    delims: bytes = b" \t\r\n.,;:!?\"'()[]{}<>"
    lower: bool = False
    # static per-row token bound (None = the ceil(L/2) worst case);
    # overflow feeds the NEED retry channel
    max_tokens_per_row: Optional[int] = None

    @property
    def partitioning(self) -> Partitioning:
        return Partitioning.none()


@_node
class GroupByAgg(Node):
    """GroupBy + decomposable aggregation.
    aggs: out_name -> (kind, value_col | None)."""

    parents: Tuple[Node, ...]
    keys: Tuple[str, ...]
    aggs: Dict[str, Any]

    @property
    def partitioning(self) -> Partitioning:
        return Partitioning("hash", tuple(self.keys))


@_node
class HashRepartition(Node):
    """Explicit HashPartition."""

    parents: Tuple[Node, ...]
    keys: Tuple[str, ...]

    @property
    def partitioning(self) -> Partitioning:
        return Partitioning("hash", tuple(self.keys))


def walk(root: Node):
    """Topological (parents-first) walk, each node once."""
    seen = set()
    order = []

    def visit(n: Node):
        if n.id in seen:
            return
        seen.add(n.id)
        for p in n.parents:
            visit(p)
        order.append(n)

    visit(root)
    return order
