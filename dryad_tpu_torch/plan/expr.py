"""Logical query expression DAG — the subset of ``dryad_tpu/plan/expr.py``
that the ported slices plan: sources, Select / Where, the tokenizing
SelectMany and the generic one (FlatMap), the per-partition escape hatch
(ApplyPerPartition), GroupBy with builtin or user-defined decomposable
aggregates, the group-contents operators (top-k, rank select, the
general GroupApply), OrderBy, Distinct, Take, explicit hash and range
repartition, partitioning claims (AssumePartitioning), the equi-Join,
the set operators (SetOp, Concat), Broadcast, the two-input CrossApply,
the positional operators (Zip, WithRowIndex, SkipTake, SlidingWindow),
WithCapacity and the do_while loop's Placeholder.  A ``Dataset`` method
chain builds this DAG lazily; the planner (``plan/planner.py``) lowers it
to stages."""

from __future__ import annotations

import dataclasses
import itertools
import os
import sys
from typing import Any, Callable, Dict, Optional, Tuple

__all__ = ["Partitioning", "Node", "Source", "Placeholder", "Map", "Filter",
           "FlatTokens", "FlatMap", "ApplyPerPartition", "Decomposable",
           "GroupByAgg", "GroupApply", "GroupTopK", "GroupRankSelect",
           "Join", "OrderBy", "Distinct", "SetOp", "Concat",
           "HashRepartition", "RangeRepartition", "Broadcast",
           "Take", "WithCapacity", "CrossApply", "AssumePartitioning",
           "Zip", "WithRowIndex", "SkipTake", "SlidingWindow", "walk"]

_ids = itertools.count()

# creation-site provenance: every Node captures the first stack frame
# outside the package (dryad_tpu_torch/* except apps/, which are
# user-shaped samples), so diagnostics (``analysis/``) and runtime errors
# point at the user's query line
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_APPS_DIR = os.path.join(_PKG_ROOT, "apps")


def _creation_span() -> Optional[Tuple[str, int, str]]:
    f = sys._getframe(1)
    depth = 0
    while f is not None and depth < 32:
        fn = f.f_code.co_filename
        internal = (fn.startswith("<")
                    or (fn.startswith(_PKG_ROOT + os.sep)
                        and not fn.startswith(_APPS_DIR + os.sep)))
        if not internal:
            return (fn, f.f_lineno, f.f_code.co_name)
        f = f.f_back
        depth += 1
    return None


@dataclasses.dataclass(frozen=True)
class Partitioning:
    """How a dataset's rows are distributed over partitions."""

    kind: str  # "none" | "hash" | "range" | "replicated"
    keys: Tuple[str, ...] = ()

    @staticmethod
    def none() -> "Partitioning":
        return Partitioning("none")


class Node:
    """Base logical node.  Subclasses are dataclasses with ``parents``."""

    id: int
    parents: Tuple["Node", ...]
    # (file, line, function) of the user call that created the node —
    # not a dataclass field (set in __post_init__, excluded from eq/repr)
    span: Optional[Tuple[str, int, str]]

    def __post_init__(self):
        object.__setattr__(self, "id", next(_ids))
        object.__setattr__(self, "span", _creation_span())

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
    """Materialized input (a ``PData``).  ``host`` is the host table the
    sequential oracle reads (``oracle.run_oracle``): the caller's columns
    by reference for ``from_columns``, never a copy; None where there is
    none."""

    parents: Tuple[Node, ...]
    data: Any
    _npartitions: int
    _partitioning: Partitioning = Partitioning.none()
    host: Any = None

    @property
    def npartitions(self) -> int:
        return self._npartitions

    @property
    def partitioning(self) -> Partitioning:
        return self._partitioning


@_node
class Placeholder(Node):
    """Loop-carried input of a do_while body; bound at execution time."""

    parents: Tuple[Node, ...]
    name: str
    _npartitions: int
    capacity: int = 0
    _partitioning: Partitioning = Partitioning.none()

    @property
    def npartitions(self) -> int:
        return self._npartitions

    @property
    def partitioning(self) -> Partitioning:
        return self._partitioning


@_node
class Map(Node):
    """Columnwise projection / transform: fn(cols) -> cols."""

    parents: Tuple[Node, ...]
    fn: Callable
    label: str = "map"


@_node
class Filter(Node):
    """fn(cols) -> bool mask (Where)."""

    parents: Tuple[Node, ...]
    fn: Callable
    label: str = "where"


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
class FlatMap(Node):
    """Generic SelectMany: fn(cols) -> (out_cols each [cap, m, ...],
    mask [cap, m]); rows flattened in row-major order, then compacted
    into ``out_capacity`` rows."""

    parents: Tuple[Node, ...]
    fn: Callable
    out_capacity: int
    label: str = "flat_map"

    @property
    def partitioning(self) -> Partitioning:
        return Partitioning.none()


@_node
class ApplyPerPartition(Node):
    """An arbitrary per-partition Batch -> Batch function (the escape
    hatch): fn(batch), or fn(batch, partition_index) with ``with_index``.
    The partitioning claim survives only when the fn preserves it.
    ``host_fn`` (table -> table) is the same function on host tables,
    kept with the node."""

    parents: Tuple[Node, ...]
    fn: Callable
    label: str = "apply"
    preserves_partitioning: bool = False
    with_index: bool = False
    host_fn: Any = None

    @property
    def partitioning(self) -> Partitioning:
        if self.preserves_partitioning:
            return self.parents[0].partitioning
        return Partitioning.none()


@dataclasses.dataclass(frozen=True)
class Decomposable:
    """User-defined decomposable aggregate (IDecomposable parity):

    * ``seed(columns) -> state``: the row columns (tensors, vectorized
      over rows) to a state pytree (tensors in tuples, lists, dicts);
    * ``merge(a, b) -> state``: ASSOCIATIVE combine of two states,
      elementwise over rows (it runs inside a segmented scan);
    * ``finalize(state) -> value | dict[str, value]``: the per-group
      result (None = the state itself; a dict fans out to columns).
    """

    seed: Any
    merge: Any
    finalize: Any = None


@_node
class GroupByAgg(Node):
    """GroupBy + decomposable aggregation.  aggs: out_name -> (kind,
    value_col | None) builtin aggregate, or a ``Decomposable``."""

    parents: Tuple[Node, ...]
    keys: Tuple[str, ...]
    aggs: Dict[str, Any]

    @property
    def partitioning(self) -> Partitioning:
        return Partitioning("hash", tuple(self.keys))


@_node
class GroupApply(Node):
    """GroupBy yielding group CONTENTS to an arbitrary per-group fn (the
    general result selector): fn(cols, count) -> (out_cols [out_rows,
    ...], mask [out_rows]), mapped over groups; group keys are attached
    to the output.  None capacities resolve to the input capacity at plan
    time."""

    parents: Tuple[Node, ...]
    keys: Tuple[str, ...]
    fn: Callable
    group_capacity: int
    max_groups: Optional[int] = None
    out_rows: int = 1
    out_capacity: Optional[int] = None

    @property
    def partitioning(self) -> Partitioning:
        return Partitioning("hash", tuple(self.keys))


@_node
class GroupTopK(Node):
    """Per-group top-k rows by a column (all columns kept)."""

    parents: Tuple[Node, ...]
    keys: Tuple[str, ...]
    k: int
    by: str
    descending: bool = True

    @property
    def partitioning(self) -> Partitioning:
        return Partitioning("hash", tuple(self.keys))


@_node
class GroupRankSelect(Node):
    """One row per group at a sorted rank of a column (median/min/max)."""

    parents: Tuple[Node, ...]
    keys: Tuple[str, ...]
    by: str
    rank: str = "median"
    out: Optional[str] = None

    @property
    def partitioning(self) -> Partitioning:
        return Partitioning("hash", tuple(self.keys))


@_node
class Join(Node):
    """Equi-join: inner, or left / right / full outer with the other
    side's columns zero-filled (a right row's keys fill the left key
    columns)."""

    parents: Tuple[Node, ...]  # (left, right)
    left_keys: Tuple[str, ...]
    right_keys: Tuple[str, ...]
    expansion: float = 1.0  # out_capacity multiplier over left capacity
    broadcast_right: bool = False
    how: str = "inner"
    # caller hint: right keys are unique (a lookup table) — enables the
    # merge-fill join, verified at run time (duplicates take the general
    # join)
    right_unique: bool = False

    @property
    def partitioning(self) -> Partitioning:
        return Partitioning("hash", tuple(self.left_keys))


@_node
class OrderBy(Node):
    """Global sort: sampled split points, a range exchange on the primary
    key, a local sort by all keys."""

    parents: Tuple[Node, ...]
    keys: Tuple[Tuple[str, bool], ...]  # (column, descending)

    @property
    def partitioning(self) -> Partitioning:
        return Partitioning("range", tuple(k for k, _ in self.keys))


@_node
class Distinct(Node):
    parents: Tuple[Node, ...]
    keys: Tuple[str, ...]  # empty = all columns

    @property
    def partitioning(self) -> Partitioning:
        return Partitioning("hash", tuple(self.keys))


@_node
class SetOp(Node):
    """Union / Intersect / Except with set semantics (dedup), over all
    columns."""

    parents: Tuple[Node, ...]  # (left, right)
    op: str  # "union" | "intersect" | "except"

    @property
    def partitioning(self) -> Partitioning:
        return Partitioning("hash", ())


@_node
class Concat(Node):
    """The left's rows, then the right's, partition by partition."""

    parents: Tuple[Node, ...]  # (left, right)

    @property
    def partitioning(self) -> Partitioning:
        return Partitioning.none()


@_node
class HashRepartition(Node):
    """Explicit HashPartition."""

    parents: Tuple[Node, ...]
    keys: Tuple[str, ...]

    @property
    def partitioning(self) -> Partitioning:
        return Partitioning("hash", tuple(self.keys))


@_node
class RangeRepartition(Node):
    """Explicit RangePartition."""

    parents: Tuple[Node, ...]
    keys: Tuple[str, ...]

    @property
    def partitioning(self) -> Partitioning:
        return Partitioning("range", tuple(self.keys))


@_node
class Broadcast(Node):
    """Replicate a (small) dataset to every partition."""

    parents: Tuple[Node, ...]

    @property
    def partitioning(self) -> Partitioning:
        return Partitioning("replicated")


@_node
class Take(Node):
    """The first n rows, in partition order."""

    parents: Tuple[Node, ...]
    n: int


@_node
class WithCapacity(Node):
    """Coerce per-partition capacity (pad, or truncate with an overflow
    check): do_while bodies keep their shapes across iterations."""

    parents: Tuple[Node, ...]
    capacity: int


@_node
class CrossApply(Node):
    """Binary per-partition op: fn(left_batch, right_broadcast_batch) ->
    Batch.  The right side is replicated to every partition (small data).
    ``host_fn(table_l, table_r) -> table`` is the same function on host
    tables (the JAX package's oracle reads it; the port keeps it with the
    node)."""

    parents: Tuple[Node, ...]  # (left, right)
    fn: Any
    host_fn: Any = None
    label: str = "cross_apply"

    @property
    def partitioning(self) -> Partitioning:
        return Partitioning.none()


@_node
class Zip(Node):
    """Pairwise combination by GLOBAL position (shorter-side semantics):
    right rows move to the partition holding the same global row index
    on the left (``parallel/shuffle.zip_exchange``), so sides with
    different per-partition counts (after a filter) pair correctly."""

    parents: Tuple[Node, ...]  # (left, right)
    suffix: str = "_r"

    @property
    def partitioning(self) -> Partitioning:
        return Partitioning.none()


@_node
class WithRowIndex(Node):
    """Add a global row-index column."""

    parents: Tuple[Node, ...]
    column: str = "row_index"


@_node
class SkipTake(Node):
    """Global skip / take_while / skip_while."""

    parents: Tuple[Node, ...]
    op: str  # "skip" | "take_while" | "skip_while"
    n: int = 0
    fn: Any = None


@_node
class SlidingWindow(Node):
    """Each row becomes the window of ``w`` consecutive rows starting at
    it (windows crossing the dataset's end are dropped); columns gain a
    window axis.  Partition p takes the first w - 1 rows of partition
    p + 1 as its halo."""

    parents: Tuple[Node, ...]
    w: int


@_node
class AssumePartitioning(Node):
    """Declare, without moving rows, that the data is already partitioned
    this way (AssumeHashPartition / AssumeRangePartition)."""

    parents: Tuple[Node, ...]
    kind: str
    keys: Tuple[str, ...]

    @property
    def partitioning(self) -> Partitioning:
        return Partitioning(self.kind, tuple(self.keys))


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
