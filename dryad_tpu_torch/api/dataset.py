"""User-facing API: ``Context`` and the lazy ``Dataset`` — the subset of
``dryad_tpu/api/dataset.py`` that WordCount, GroupByReduce, TeraSort,
PageRank and k-means call, with the sort family (``order_by``,
``range_partition``, the ``assume_*`` claims, ``take``, ``distinct``,
``group_top_k``, ``group_median``), ``join`` (inner / left / right /
full, hash or broadcast, hot-key salted on skew), ``group_join``,
``cross_apply``, ``broadcast``, the set operators (``union``,
``intersect``, ``except_``, ``concat``), the positional operators
(``zip_with``, ``with_row_index``, ``skip``, ``take_while``,
``skip_while``, ``sliding_window``), ``flat_map``, ``group_apply``,
``apply_per_partition`` / ``apply_with_partition_index``, ``fork`` /
``fork_by`` / ``fork_on``, ``assume_hash_partition``,
``with_capacity``, the in-memory ``cache``,
``Context.do_while`` and the terminal scalars (``count``, ``sum``,
``min``, ``max``, ``mean``, ``any``, ``all``, ``first``,
``aggregate``).

``Context(device="cuda", nparts=8)`` runs ``nparts`` logical partitions
on one CUDA card (``parallel/mesh.py``).  The device is CUDA unless the
caller asks for the CPU; on a machine without CUDA the default raises
rather than quietly running on the CPU.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from dryad_tpu_torch.exec.data import PData, maybe_shrink_for_collect, \
    pdata_from_host, pdata_to_host, split_partitions
from dryad_tpu_torch.exec.executor import Executor
from dryad_tpu_torch.ops.kernels import scalar_aggregate
from dryad_tpu_torch.parallel.mesh import Mesh, resolve_device
from dryad_tpu_torch.plan import expr as E
from dryad_tpu_torch.plan.planner import plan_query
from dryad_tpu_torch.utils.config import JobConfig

__all__ = ["Context", "Dataset"]


def _add_agg_key(cols):
    """The columns plus a zero int32 ``__agg_key`` (one global group for
    the whole-dataset ``aggregate``)."""
    v = next(iter(cols.values()))
    t = v.lengths if hasattr(v, "lengths") else v
    return dict(cols, __agg_key=torch.zeros(t.shape[0], dtype=torch.int32,
                                            device=t.device))


def _first_if_one(v):
    v = np.asarray(v)
    return v[0] if v.shape and v.shape[0] == 1 else v


class Context:
    """Owns the mesh + executor and creates root Datasets."""

    def __init__(self, device="cuda", nparts: int = 8,
                 config: JobConfig | None = None):
        self.config = config or JobConfig()
        self.mesh = Mesh(resolve_device(device), nparts)
        self.nparts = nparts
        self.executor = Executor(self.mesh, config=self.config)

    @property
    def device(self):
        return self.mesh.device

    def from_columns(self, columns: Mapping[str, Any],
                     capacity: int | None = None,
                     str_max_len: int | None = None) -> "Dataset":
        """A partitioned dataset from host columns (block-partitioned
        rows; lists of str/bytes become string columns)."""
        str_max_len = str_max_len or self.config.string_max_len
        pdata = pdata_from_host(columns, self.mesh, capacity=capacity,
                                str_max_len=str_max_len)
        return Dataset(self, E.Source(parents=(), data=pdata,
                                      _npartitions=self.nparts))

    def from_pdata(self, pdata: PData,
                   partitioning: E.Partitioning = E.Partitioning.none()
                   ) -> "Dataset":
        """A dataset over data already on the mesh, with the partitioning
        it is claimed to have (a cached or loop-carried result keeps its
        hash placement, so later joins and group-bys skip the
        exchange)."""
        return Dataset(self, E.Source(parents=(), data=pdata,
                                      _npartitions=self.nparts,
                                      _partitioning=partitioning))

    def do_while(self, init: "Dataset",
                 body: Callable[["Dataset"], "Dataset"], n_iters: int,
                 cond: Optional[Callable[[Dict[str, Any]], bool]] = None
                 ) -> "Dataset":
        """Iterative execution (DoWhile), in memory on one process: the
        body is planned ONCE over a placeholder, and each of up to
        ``n_iters`` iterations runs that plan with the previous
        iteration's output bound to it (stages are reused, so a capacity
        scale learned in the first iteration carries over).  The body must
        keep the per-partition capacity (``with_capacity``).  ``cond``, a
        predicate on the current table collected to the host, stops the
        loop early when it returns False."""
        if n_iters > self.config.max_loop_iterations:
            raise ValueError(
                f"n_iters={n_iters} exceeds JobConfig.max_loop_iterations="
                f"{self.config.max_loop_iterations}; raise the knob "
                f"explicitly for longer loops")
        cur = init._materialize()
        ph = E.Placeholder(parents=(), name="__loop",
                           _npartitions=self.nparts, capacity=cur.capacity)
        graph = plan_query(body(Dataset(self, ph)).node, self.nparts)
        for _ in range(n_iters):
            nxt = self.executor.run(graph, bindings={"__loop": cur})
            if nxt.capacity != cur.capacity:
                raise ValueError(
                    "do_while body must preserve per-partition capacity "
                    f"({cur.capacity} -> {nxt.capacity}); use explicit "
                    "capacities (with_capacity) inside the loop")
            cur = nxt
            if cond is not None and not cond(pdata_to_host(cur)):
                break
        return self.from_pdata(cur)


class Dataset:
    """A lazy, partitioned, columnar dataset."""

    def __init__(self, ctx: Context, node: E.Node):
        self.ctx = ctx
        self.node = node

    def select(self, fn: Callable[[Dict[str, Any]], Dict[str, Any]],
               label: str = "select") -> "Dataset":
        """Columnwise projection: fn(cols) -> new cols (replaces the
        columns)."""
        return Dataset(self.ctx, E.Map(parents=(self.node,), fn=fn,
                                       label=label))

    def where(self, fn: Callable[[Dict[str, Any]], Any],
              label: str = "where") -> "Dataset":
        """Keep the rows where fn(cols) (a bool [capacity] mask) holds."""
        return Dataset(self.ctx, E.Filter(parents=(self.node,), fn=fn,
                                          label=label))

    def split_words(self, column: str, out_capacity: int,
                    max_token_len: int | None = None,
                    delims: bytes | None = None,
                    lower: bool = False,
                    max_tokens_per_row: int | None = None) -> "Dataset":
        """Tokenizing SelectMany (the WordCount flat-map).  Token length
        and delimiter defaults come from JobConfig."""
        cfg = self.ctx.config
        return Dataset(self.ctx, E.FlatTokens(
            parents=(self.node,), column=column, out_capacity=out_capacity,
            max_token_len=(cfg.token_max_len if max_token_len is None
                           else max_token_len),
            delims=cfg.token_delims if delims is None else delims,
            lower=lower, max_tokens_per_row=max_tokens_per_row))

    def apply_per_partition(self, fn, label: str = "apply",
                            preserves_partitioning: bool = False,
                            host_fn=None) -> "Dataset":
        """``fn(batch) -> Batch`` on every partition (the escape hatch).
        ``fn`` sees the port's Batches: torch tensors on the context's
        device, the count a 0-d int32 tensor.  With
        ``preserves_partitioning`` the input's partitioning claim carries
        over.  ``host_fn(table) -> table`` is the same function on host
        tables, kept with the plan."""
        return Dataset(self.ctx, E.ApplyPerPartition(
            parents=(self.node,), fn=fn, label=label,
            preserves_partitioning=preserves_partitioning, host_fn=host_fn))

    def apply_with_partition_index(self, fn, label: str = "apply_idx"
                                   ) -> "Dataset":
        """``fn(batch, partition_index) -> Batch``; the index is an int in
        [0, nparts)."""
        return Dataset(self.ctx, E.ApplyPerPartition(
            parents=(self.node,), fn=fn, label=label, with_index=True))

    def flat_map(self, fn, out_capacity: int,
                 label: str = "flat_map") -> "Dataset":
        """Generic SelectMany: ``fn(cols) -> (out_cols, mask)`` with every
        output column [capacity, m, ...] and mask [capacity, m] bool; the
        masked cells of the valid rows, flattened row-major, become rows.
        ``out_capacity`` rows per partition; an overflow retries at the
        measured size."""
        return Dataset(self.ctx, E.FlatMap(
            parents=(self.node,), fn=fn, out_capacity=out_capacity,
            label=label))

    def sliding_window(self, w: int) -> "Dataset":
        """Windows of ``w`` consecutive rows in global row order (windows
        crossing the end are dropped); columns gain a window axis
        [rows, w, ...].  Every partition but the last takes its halo from
        the next one, which must hold at least w - 1 rows."""
        return Dataset(self.ctx, E.SlidingWindow(parents=(self.node,), w=w))

    def fork_by(self, fn) -> Tuple["Dataset", "Dataset"]:
        """Split one scan into the rows where ``fn(cols)`` holds and the
        rest; the shared parent is materialized once (Tee)."""
        t = self.where(fn, label="fork_t")
        f = self.where(lambda c, _fn=fn: ~_fn(c), label="fork_f")
        return t, f

    def fork(self, *predicates) -> Tuple["Dataset", ...]:
        """One branch per predicate over a single shared scan (the parent
        is materialized once by the planner's consumer count).  Branches
        may overlap or leave rows out."""
        return tuple(self.where(p, label=f"fork_{i}")
                     for i, p in enumerate(predicates))

    def fork_on(self, column: str, values: Sequence[Any]
                ) -> Tuple["Dataset", ...]:
        """One branch per value: branch i holds the rows where
        ``column == values[i]``."""
        dev = self.ctx.device
        return tuple(
            self.where(lambda c, _v=torch.as_tensor(v, device=dev):
                       c[column] == _v, label=f"fork_{column}_{i}")
            for i, v in enumerate(values))

    def assume_hash_partition(self, keys: Sequence[str]) -> "Dataset":
        """Declare, without moving rows, that each key's rows lie on the
        partition its hash names: a later group-by, group-contents
        operator or join on the same keys skips its exchange."""
        return Dataset(self.ctx, E.AssumePartitioning(
            parents=(self.node,), kind="hash", keys=tuple(keys)))

    def group_by(self, keys: Sequence[str],
                 aggs: Dict[str, Any]) -> "Dataset":
        """GroupBy + decomposable aggregates: aggs maps output column ->
        (kind, value_column), kind in sum/count/min/max/mean/any/all, or
        -> a ``Decomposable(seed, merge, finalize)`` for user-defined
        aggregation.  Groups are identified by a 64-bit key hash, as in
        the JAX package."""
        return Dataset(self.ctx, E.GroupByAgg(
            parents=(self.node,), keys=tuple(keys), aggs=dict(aggs)))

    def hash_partition(self, keys: Sequence[str]) -> "Dataset":
        """Explicit repartition by key hash."""
        return Dataset(self.ctx, E.HashRepartition(parents=(self.node,),
                                                   keys=tuple(keys)))

    def group_top_k(self, keys: Sequence[str], k: int, by: str,
                    descending: bool = True) -> "Dataset":
        """Per-group top-k rows by ``by`` (all columns kept; ties keep
        arrival order)."""
        return Dataset(self.ctx, E.GroupTopK(
            parents=(self.node,), keys=tuple(keys), k=k, by=by,
            descending=descending))

    def group_apply(self, keys: Sequence[str], fn,
                    group_capacity: int, max_groups: int | None = None,
                    out_rows: int = 1, out_capacity: int | None = None
                    ) -> "Dataset":
        """GroupBy yielding each group's CONTENTS to ``fn`` (the general
        result selector: a window function, a mode, any non-decomposable
        reduction).  ``fn(cols, count) -> (out_cols, mask)`` sees one
        group's columns as [group_capacity, ...] tensors (rows >= count
        unspecified: mask by count) and its row count; out_cols are
        [out_rows, ...] and mask [out_rows] bool.  ``fn`` is mapped over
        the groups with ``torch.func.vmap``, so it must be vmap-able (no
        data-dependent Python control flow).  The group keys are attached
        to the output.  ``group_capacity`` bounds one group's rows,
        ``max_groups`` a partition's groups (default: the input capacity),
        ``out_capacity`` the output rows (default: the input capacity); an
        overflow of any retries at the measured size.  The regroup holds
        max_groups x group_capacity cells per column."""
        return Dataset(self.ctx, E.GroupApply(
            parents=(self.node,), keys=tuple(keys), fn=fn,
            group_capacity=group_capacity, max_groups=max_groups,
            out_rows=out_rows, out_capacity=out_capacity))

    def group_median(self, keys: Sequence[str], by: str,
                     out: str | None = None) -> "Dataset":
        """One row per group: keys + the LOWER median of ``by`` (element
        (n-1)//2 of the ascending order — always an element of the
        group, unlike numpy's interpolated even-size median)."""
        return Dataset(self.ctx, E.GroupRankSelect(
            parents=(self.node,), keys=tuple(keys), by=by, rank="median",
            out=out))

    def order_by(self, keys: Sequence[Tuple[str, bool]]) -> "Dataset":
        """Global sort; keys = [(column, descending), ...]."""
        return Dataset(self.ctx, E.OrderBy(parents=(self.node,),
                                           keys=tuple(keys)))

    def distinct(self, keys: Sequence[str] = ()) -> "Dataset":
        """One row per distinct key (by ``keys``, or all columns when
        empty): the first in arrival order.  Keys are told apart by their
        64-bit hash, as in ``group_by``."""
        return Dataset(self.ctx, E.Distinct(parents=(self.node,),
                                            keys=tuple(keys)))

    def range_partition(self, keys: Sequence[str]) -> "Dataset":
        """Explicit repartition by ranges of the first key."""
        return Dataset(self.ctx, E.RangeRepartition(parents=(self.node,),
                                                    keys=tuple(keys)))

    def assume_range_partition(self, keys: Sequence[str]) -> "Dataset":
        """Declare, without moving rows, that partitions hold ascending
        ranges of ``keys``."""
        return Dataset(self.ctx, E.AssumePartitioning(
            parents=(self.node,), kind="range", keys=tuple(keys)))

    def assume_order_by(self, keys: Sequence[str]) -> "Dataset":
        """Declare, without sorting, that the data is globally sorted
        ascending by ``keys`` (AssumeOrderBy).  A later ``order_by`` whose
        ascending keys are a prefix of ``keys`` skips the range exchange
        and only sorts locally."""
        return self.assume_range_partition(keys)

    def take(self, n: int) -> "Dataset":
        """The first ``n`` rows, in partition order."""
        return Dataset(self.ctx, E.Take(parents=(self.node,), n=n))

    def zip_with(self, other: "Dataset", suffix: str = "_r") -> "Dataset":
        """Positional pairing by global row index (LINQ Zip), as many rows
        as the shorter side; ``other``'s columns suffixed on a name clash.
        Sides with different per-partition counts are realigned by an
        exchange."""
        return Dataset(self.ctx, E.Zip(parents=(self.node, other.node),
                                       suffix=suffix))

    def with_row_index(self, column: str = "row_index") -> "Dataset":
        """Add a global int32 row-index column (partition order)."""
        return Dataset(self.ctx, E.WithRowIndex(parents=(self.node,),
                                                column=column))

    def skip(self, n: int) -> "Dataset":
        """Every row but the first ``n``, in partition order."""
        return Dataset(self.ctx, E.SkipTake(parents=(self.node,), op="skip",
                                            n=n))

    def take_while(self, fn) -> "Dataset":
        """The rows before the first one where ``fn(cols)`` (a bool
        [capacity] mask) fails, in partition order."""
        return Dataset(self.ctx, E.SkipTake(parents=(self.node,),
                                            op="take_while", fn=fn))

    def skip_while(self, fn) -> "Dataset":
        """The rows from the first one where ``fn(cols)`` fails on."""
        return Dataset(self.ctx, E.SkipTake(parents=(self.node,),
                                            op="skip_while", fn=fn))

    def with_capacity(self, capacity: int) -> "Dataset":
        """Coerce per-partition capacity (pad; a truncation that would drop
        rows raises CapacityError): keeps do_while bodies shape-stable."""
        return Dataset(self.ctx, E.WithCapacity(parents=(self.node,),
                                                capacity=capacity))

    def cross_apply(self, other: "Dataset", fn, host_fn=None,
                    label: str = "cross_apply") -> "Dataset":
        """``fn(batch, other_batch) -> Batch`` on every partition, with
        ``other`` broadcast to every partition (small data).  ``fn`` sees
        the port's Batches: torch tensors on the context's device, the
        count a 0-d int32 tensor.  ``host_fn(table, other_table)`` is the
        same function on host tables, kept with the plan."""
        return Dataset(self.ctx, E.CrossApply(
            parents=(self.node, other.node), fn=fn, host_fn=host_fn,
            label=label))

    def broadcast(self) -> "Dataset":
        """Replicate to every partition (small datasets)."""
        return Dataset(self.ctx, E.Broadcast(parents=(self.node,)))

    def union(self, other: "Dataset") -> "Dataset":
        """The distinct rows of both (set semantics, all columns)."""
        return Dataset(self.ctx, E.SetOp(parents=(self.node, other.node),
                                         op="union"))

    def intersect(self, other: "Dataset") -> "Dataset":
        """The distinct rows found in both."""
        return Dataset(self.ctx, E.SetOp(parents=(self.node, other.node),
                                         op="intersect"))

    def except_(self, other: "Dataset") -> "Dataset":
        """The distinct rows of this dataset not found in ``other``."""
        return Dataset(self.ctx, E.SetOp(parents=(self.node, other.node),
                                         op="except"))

    def concat(self, other: "Dataset") -> "Dataset":
        """Every row of both (a multiset), partition by partition."""
        return Dataset(self.ctx, E.Concat(parents=(self.node, other.node)))

    def aggregate(self, dec: "E.Decomposable"):
        """Whole-dataset user-defined aggregation: the decomposable
        protocol over ONE global group (a const-key ``group_by``); returns
        the finalized value, or a dict of them for a dict finalize."""
        const = self.select(_add_agg_key, label="agg-key")
        out = const.group_by(["__agg_key"], {"agg": dec}).collect()
        res = {k: v for k, v in out.items() if k != "__agg_key"}
        if set(res) == {"agg"}:
            return _first_if_one(res["agg"])
        return {k: _first_if_one(v) for k, v in res.items()}

    def join(self, other: "Dataset", left_keys: Sequence[str],
             right_keys: Sequence[str] | None = None,
             expansion: float | None = None, broadcast: bool = False,
             how: str = "inner", right_unique: bool = False) -> "Dataset":
        """Equi-join on ``left_keys`` = ``right_keys``; output columns =
        left columns + right non-key columns (suffixed ``_r`` on a name
        clash), ``expansion`` x the left capacity per partition.
        ``how="left"`` keeps unmatched left rows with the right columns
        zero-filled; ``how="right"`` keeps unmatched right rows, their
        keys in the left key columns and the other left columns
        zero-filled; ``how="full"`` keeps both.  ``right_unique=True``
        declares the right side unique-keyed (a lookup table) and routes
        an inner or left join through the merge-fill join; uniqueness is
        checked at run time and duplicates take the general join.
        ``broadcast=True`` (or ``JobConfig.broadcast_join_threshold``)
        replicates the right side to every partition instead of
        hash-exchanging both; the output
        then keeps the left side's placement (a right or full join never
        broadcasts: its unmatched right rows would come out once per
        partition).  A hash join whose exchanges overflow on a hot key
        re-runs with the salted exchange, unless a later stage relies on
        its placement."""
        if how not in ("inner", "left", "right", "full"):
            raise ValueError(f"unknown join how={how!r}")
        return Dataset(self.ctx, E.Join(
            parents=(self.node, other.node), left_keys=tuple(left_keys),
            right_keys=tuple(right_keys or left_keys),
            expansion=expansion or self.ctx.config.join_expansion,
            broadcast_right=broadcast, how=how,
            right_unique=right_unique))

    def group_join(self, other: "Dataset", left_keys: Sequence[str],
                   aggs: Dict[str, Any],
                   right_keys: Sequence[str] | None = None,
                   expansion: float = 1.0) -> "Dataset":
        """GroupJoin: each left row with the AGGREGATE of its matching
        right group: ``other.group_by(right_keys, aggs)`` then a left join,
        so a left row without a group gets zero aggregates (include a
        ``("count", None)`` to tell empty groups apart)."""
        rkeys = list(right_keys or left_keys)
        return self.join(other.group_by(rkeys, aggs), left_keys, rkeys,
                         expansion=expansion, how="left")

    def cache(self) -> "Dataset":
        """Materialize NOW and reuse the result in later queries (hoist
        loop-invariant work out of a do_while body).  The in-memory form:
        the result stays on the card and keeps its partitioning claim.
        The store-backed re-streaming tiers come with the out-of-core
        slice.  A run that salted a join drops the claim: its rows no
        longer lie where the key's hash says."""
        pd, salted = self._run()
        return self.ctx.from_pdata(
            pd, partitioning=(E.Partitioning.none() if salted
                              else self.node.partitioning))

    def plan(self):
        return plan_query(self.node, self.ctx.nparts, config=self.ctx.config)

    def _run(self):
        """(output, whether any stage ran salted)."""
        graph = self.plan()
        return (self.ctx.executor.run(graph),
                any(st._salted for st in graph.stages))

    def _materialize(self):
        return self._run()[0]

    def collect(self) -> Dict[str, Any]:
        """Execute and pull all rows to the host."""
        out = pdata_to_host(maybe_shrink_for_collect(self._materialize(),
                                                     self.ctx.config))
        if isinstance(self.node, E.Take):
            out = {k: v[:self.node.n] for k, v in out.items()}
        return out

    def explain(self) -> str:
        return self.plan().explain()

    # -- terminal scalars --------------------------------------------------

    def count(self) -> int:
        return int(self._materialize().counts.sum())

    def _scalar(self, kind: str, column: str):
        """A terminal scalar aggregate: per-partition partials on the
        device (``scalar_aggregate``), combined on the host as the JAX
        package does: min / max over the non-empty partitions, the mean
        weighted by the counts, None for an empty dataset."""
        pd = self._materialize()
        parts = [scalar_aggregate(b, {"out": (kind, column),
                                      "cnt": ("count", None)})
                 for b in split_partitions(pd)]
        vals = torch.stack([p["out"] for p in parts]).cpu().numpy()
        cnts = torch.stack([p["cnt"] for p in parts]).cpu().numpy()
        nonempty = cnts > 0
        if kind == "sum":
            return vals.sum(axis=0)
        if kind == "min":
            return vals[nonempty].min(axis=0) if nonempty.any() else None
        if kind == "max":
            return vals[nonempty].max(axis=0) if nonempty.any() else None
        if kind == "mean":
            total = cnts.sum()
            if total == 0:
                return None
            return (vals.T * cnts).T.sum(axis=0) / total
        if kind == "any":
            return bool(vals[nonempty].any())
        if kind == "all":
            return bool(vals[nonempty].all()) if nonempty.any() else True
        raise ValueError(kind)

    def sum(self, column: str):
        return self._scalar("sum", column)

    def min(self, column: str):
        return self._scalar("min", column)

    def max(self, column: str):
        return self._scalar("max", column)

    def mean(self, column: str):
        return self._scalar("mean", column)

    def any(self, column: str) -> bool:
        return self._scalar("any", column)

    def all(self, column: str) -> bool:
        return self._scalar("all", column)

    def first(self) -> Dict[str, Any]:
        t = self.take(1).collect()
        return {k: v[0] for k, v in t.items()}
