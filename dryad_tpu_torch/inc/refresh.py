"""One standing-query refresh: delta scan -> merge -> finalize -> commit —
the port of ``dryad_tpu/inc/refresh.py``.

The refresh runs the statement through the NORMAL SQL lowering (the same
Dataset chain, planner, executor and event stream as a batch query, on
the context's device); only the base table's scan is scoped to the
partitions appended since the committed watermark, by a catalog view
whose ``dataset()`` reads just those store partitions.  For the aggregate
shape the engine computes per-group PARTIALS over the delta (the state
statement of ``inc/delta_plan.py``) and the host merges them into the
persisted state with the engine's arithmetic: sums and counts add in the
engine's dtype (int32 wraps around), min / max keep the new value where
it compares lower / higher, and a mean finalizes as
``sum.astype(float32) / max(count, 1)``, the builtin decomposable's
finalize.  An incremental result is therefore bit-identical to a full
rescan for integer-valued aggregates.

The JAX package merges row by row in Python; here the merge is
vectorized over numpy columns with the same results: a state row per
group in first-seen order (the previous state's rows, then the
partial's new groups in its row order).

Commit discipline: the engine run reads only; the ONLY mutation is the
single atomic state + watermark replace (``inc/state.py``).  A crash
before it changes nothing, so every appended partition is counted once
per state lineage — never twice, never skipped.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from dryad_tpu_torch.inc import state as inc_state
from dryad_tpu_torch.inc.delta_plan import (REBUILD_DELTA_FRACTION,
                                            DeltaPlan, plan_delta,
                                            state_statement)
from dryad_tpu_torch.sql.binder import BoundSelect
from dryad_tpu_torch.sql.catalog import Catalog

__all__ = ["RefreshResult", "run_refresh", "table_payload"]


@dataclasses.dataclass
class RefreshResult:
    """The outcome of one refresh (the record behind the ``inc_refresh``
    event)."""

    mode: str                   # incremental | rebuild | rescan | noop
    shape: Optional[str]        # aggregate | append | None
    code: str                   # DTA401 | DTA402 | DTA403
    generation: int             # store generation this refresh covers
    watermark: int              # committed watermark (== generation)
    delta_parts: List[int]      # store partitions scanned
    delta_rows: int             # input rows scanned
    table: Dict[str, Any]       # the full current result
    rows: int
    changed: Dict[str, Any]     # the rows that changed this refresh
    changed_rows: int
    wall_s: float = 0.0
    merge_s: float = 0.0        # the host merge's seconds (aggregate)


def table_payload(table: Dict[str, Any], cap: Optional[int] = None
                  ) -> Dict[str, Any]:
    """The JSON-able ``{"table": cols, "rows": n}`` form of a host table
    (bytes decoded as utf-8, numpy scalars as Python ones), optionally
    capped at ``cap`` rows."""
    out: Dict[str, Any] = {}
    n = 0
    for k, v in table.items():
        vals = list(v if cap is None else v[:cap])
        out[k] = [x.decode("utf-8", "replace")
                  if isinstance(x, (bytes, bytearray))
                  else (x.item() if hasattr(x, "item") else x)
                  for x in vals]
        n = max(n, len(vals))
    return {"table": out, "rows": n}


class _DeltaCatalog(Catalog):
    """A catalog view that scopes ONE table's scan to a list of store
    partitions: the unchanged SQL lowering then runs over the delta."""

    def __init__(self, base: Catalog, table: str,
                 partitions: List[int]):
        super().__init__()
        self.tables = base.tables
        self._table = table
        self._partitions = list(partitions)

    def dataset(self, ctx, name: str, loader=None):
        # ``loader`` (a shared full-table scan) is ignored on purpose: a
        # delta scan reads a partition subset
        if name != self._table:
            return super().dataset(ctx, name)
        from dryad_tpu_torch.io.store import read_store, store_meta
        t = self.tables[name]
        # the capacity of the partitions read: the manifest's is sized
        # for the store's largest part, and padding a small delta to it
        # would make the incremental scan compute at full-store scale.
        # Re-blocked rows need ceil(total / nparts), a verbatim load the
        # largest part read: the larger covers both
        meta = store_meta(t.path)
        counts = [int(meta["counts"][p]) for p in self._partitions]
        total = sum(counts)
        cap = max(max(counts or [1]), -(-total // max(ctx.nparts, 1)), 1)
        pd = read_store(t.path, ctx.mesh, capacity=cap,
                        partitions=self._partitions,
                        verify=ctx.config.store_verify_checksums)
        ds = ctx.from_pdata(pd)
        return ds, ds.node.data


def _run_statement(ctx, catalog: Catalog, bound: BoundSelect,
                   event=None, job: Optional[str] = None
                   ) -> Dict[str, Any]:
    """Lower, plan and execute one statement under ``ctx``: its host
    table."""
    from dryad_tpu_torch.exec.data import maybe_shrink_for_collect, \
        pdata_to_host
    from dryad_tpu_torch.plan.planner import plan_query
    from dryad_tpu_torch.sql.lower import lower
    ds, _handles = lower(ctx, catalog, bound)
    graph = plan_query(ds.node, ctx.nparts, hosts=ctx.hosts,
                       levels=ctx.levels, config=ctx.config)
    pd = ctx.executor.run(graph, event_log=event, job=job)
    return pdata_to_host(maybe_shrink_for_collect(pd, ctx.config))


def _rows_of(table: Dict[str, Any]) -> int:
    for v in table.values():
        return len(v)
    return 0


def _trim(table: Dict[str, Any], limit: Optional[int]
          ) -> Dict[str, Any]:
    if limit is None:
        return table
    return {k: v[:limit] for k, v in table.items()}


def _is_str_col(v) -> bool:
    return (isinstance(v, list)
            or getattr(getattr(v, "dtype", None), "kind", "") == "S")


def _str_array(v) -> np.ndarray:
    """A string column (a list of bytes, or an ``S`` array) as the
    ``S``-dtype array the state file holds."""
    if isinstance(v, np.ndarray):
        return v
    return np.asarray([bytes(x) for x in v])


def _concat(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``a`` then ``b``, an empty piece dropped (an empty string column
    is a float64 array, which does not concatenate with bytes)."""
    if not len(a):
        return b
    if not len(b):
        return a
    return np.concatenate([a, b])


def _key_codes(prev: List[np.ndarray], part: List[np.ndarray]
               ) -> Tuple[np.ndarray, np.ndarray]:
    """An int64 code per row of the previous state and of the partial,
    equal exactly where the group keys are."""
    n_prev = len(prev[0])
    per_col = []
    for a, b in zip(prev, part):
        _, inv = np.unique(_concat(a, b), return_inverse=True)
        per_col.append(inv.reshape(-1))
    if len(per_col) == 1:
        codes = per_col[0]
    else:
        _, codes = np.unique(np.stack(per_col, axis=1), axis=0,
                             return_inverse=True)
        codes = codes.reshape(-1)
    return codes[:n_prev], codes[n_prev:]


def _combine(kind: str, cur: np.ndarray, new: np.ndarray) -> np.ndarray:
    """The merge of a state column's values with a partial's, in the
    engine's dtype."""
    if kind in ("sum", "count"):
        return cur + new                 # int32 wraps, as in the engine
    if kind == "min":
        return np.where(new < cur, new, cur)
    return np.where(new > cur, new, cur)             # max


def _merge_state(plan: DeltaPlan, prev: Dict[str, Any],
                 partial: Dict[str, Any]):
    """Merge an engine partial table into the persisted state columns.

    Returns ``(columns, touched)``: the merged columns as numpy arrays
    (a string key as ``S`` dtype; a numeric column in the partial's
    dtype, else the previous state's) and the sorted state rows this
    partial touched."""
    keys = plan.group_keys
    aggs = plan.state_aggs
    names = keys + list(aggs)
    dtypes: Dict[str, Any] = {}
    for name in names:
        for src in (partial.get(name), prev.get(name)):
            if src is not None and not _is_str_col(src) \
                    and name not in dtypes:
                dtypes[name] = np.asarray(src).dtype

    def column(table, name):
        v = table.get(name)
        if v is None:
            v = []
        if name in dtypes:
            return np.asarray(v, dtype=dtypes[name])
        return _str_array(v)

    pv = {n: column(prev, n) for n in names}
    pt = {n: column(partial, n) for n in names}
    n_prev = len(pv[names[0]]) if names else 0
    n_part = _rows_of(partial)
    if keys:
        code_prev, code_part = _key_codes([pv[k] for k in keys],
                                          [pt[k] for k in keys])
    else:
        # a global aggregate: one state row, one partial row
        assert n_part <= 1 and n_prev <= 1, (n_prev, n_part)
        code_prev = np.zeros(n_prev, np.int64)
        code_part = np.zeros(n_part, np.int64)
    where = np.full(int(max(code_prev.max(initial=-1),
                            code_part.max(initial=-1))) + 1, -1, np.int64)
    where[code_prev] = np.arange(n_prev)
    match = where[code_part]
    new = match < 0
    old = ~new
    cols: Dict[str, np.ndarray] = {}
    for name in names:
        cur = pv[name]
        if name in aggs and old.any():
            cur = cur.copy()
            rows = match[old]
            cur[rows] = _combine(aggs[name][0], cur[rows], pt[name][old])
        cols[name] = _concat(cur, pt[name][new])
    touched = np.concatenate([np.unique(match[old]),
                              n_prev + np.arange(int(new.sum()))])
    return cols, touched


def _finalize(plan: DeltaPlan, cols: Dict[str, Any],
              idx: Optional[np.ndarray] = None) -> Dict[str, Any]:
    """State columns -> the SELECT's output columns (a string key as a
    list of bytes, as a query's collect gives it), optionally only the
    rows ``idx``.  A mean divides with the engine's exact arithmetic."""
    def pick(name):
        v = np.asarray(cols[name])
        return v if idx is None else v[np.asarray(idx, dtype=np.int64)]

    out: Dict[str, Any] = {}
    for name, spec in plan.finalize.items():
        if spec[0] in ("key", "state"):
            v = pick(spec[1])
            out[name] = ([bytes(x) for x in v] if _is_str_col(v)
                         else v)
        else:                                       # ("mean", sum, cnt)
            tot = pick(spec[1])
            cf = np.maximum(pick(spec[2]), 1)
            if np.issubdtype(tot.dtype, np.floating):
                out[name] = tot / cf.astype(tot.dtype)
            else:
                out[name] = (tot.astype(np.float32)
                             / cf.astype(np.float32))
    return out


def run_refresh(ctx, catalog: Catalog, bound: BoundSelect, norm: str,
                state_dir: str, event=None, job: Optional[str] = None
                ) -> RefreshResult:
    """One refresh of a standing query under ``ctx`` (an api.Context,
    whose executor runs the delta scan).  ``norm`` is the normalized
    query text (part of the state's key); ``event`` an optional sink for
    the ``inc_*`` events."""
    from dryad_tpu_torch.io.store import (parts_since, store_generation,
                                          store_meta)
    t0 = time.perf_counter()
    emit = event if event is not None else (lambda e: None)
    table = catalog.tables[bound.base_table]
    if table.kind != "store":
        raise ValueError(f"standing query base table "
                         f"{bound.base_table!r} is {table.kind}-backed "
                         f"— refreshes need a growing store")
    meta = store_meta(table.path)
    gen = store_generation(meta)
    plan = plan_delta(catalog, bound)
    sp = inc_state.state_path(
        state_dir, inc_state.state_key(norm, bound.base_table,
                                       table.path, meta["schema"]))
    loaded = inc_state.load_state(sp)
    watermark = loaded[0] if loaded is not None else -1
    delta = parts_since(meta, watermark)

    def done(mode, code, parts, res_table, changed, extra_event=None,
             merge_s=0.0):
        wall = time.perf_counter() - t0
        drows = sum(int(meta["counts"][p]) for p in parts)
        res = RefreshResult(
            mode=mode, shape=plan.shape, code=code, generation=gen,
            watermark=gen, delta_parts=list(parts), delta_rows=drows,
            table=res_table, rows=_rows_of(res_table),
            changed=changed, changed_rows=_rows_of(changed),
            wall_s=wall, merge_s=merge_s)
        if extra_event:
            emit(extra_event)
        emit({"event": "inc_refresh", "mode": mode, "code": code,
              "generation": gen, "delta_parts": len(parts),
              "delta_rows": drows, "rows": res.rows,
              "changed_rows": res.changed_rows,
              "wall_s": round(wall, 4),
              "delta": table_payload(changed, cap=64)})
        return res

    if not plan.decomposable:
        # a full re-run each refresh; the watermark-only state records
        # how far the result has seen
        res_table = _trim(_run_statement(ctx, catalog, bound,
                                         event=event, job=job),
                          bound.limit)
        inc_state.commit_state(sp, gen, {})
        emit({"event": "inc_state_write", "watermark": gen,
              "state_rows": 0, "path": sp})
        return done("rescan", "DTA402", delta, res_table, res_table,
                    extra_event={"event": "inc_fallback_rescan",
                                 "code": "DTA402",
                                 "reasons": plan.reasons})

    if not delta:
        # nothing appended past the committed watermark
        if plan.shape == "aggregate" and loaded is not None:
            full = _finalize(plan, loaded[1])
            return done("noop", plan.code, [], full,
                        {k: v[:0] for k, v in full.items()})
        return done("noop", plan.code, [], {}, {})

    if plan.shape == "append":
        # each refresh emits exactly the rows its delta produced
        dcat = _DeltaCatalog(catalog, bound.base_table, delta)
        res_table = _run_statement(ctx, dcat, bound, event=event,
                                   job=job)
        inc_state.commit_state(sp, gen, {})
        emit({"event": "inc_state_write", "watermark": gen,
              "state_rows": 0, "path": sp})
        return done("incremental", "DTA401", delta, res_table,
                    res_table)

    # the aggregate shape.  The cost rule (DTA403): a delta that is most
    # of the store saves nothing by merging — rebuild from a full scan
    rebuild = False
    if loaded is not None:
        delta_bytes = sum(int(meta["bytes"][p]) for p in delta)
        total_bytes = sum(int(b) for b in meta["bytes"])
        rebuild = (total_bytes > 0 and
                   delta_bytes > REBUILD_DELTA_FRACTION * total_bytes)
    scan = (list(range(int(meta["npartitions"])))
            if rebuild or loaded is None else delta)
    stmt = state_statement(bound, plan)
    dcat = _DeltaCatalog(catalog, bound.base_table, scan)
    partial = _run_statement(ctx, dcat, stmt, event=event, job=job)
    prev = {} if (rebuild or loaded is None) else loaded[1]
    tm = time.perf_counter()
    cols, touched = _merge_state(plan, prev, partial)
    merge_s = time.perf_counter() - tm
    inc_state.commit_state(sp, gen, cols)
    emit({"event": "inc_state_write", "watermark": gen,
          "state_rows": _rows_of(cols), "path": sp})
    full = _finalize(plan, cols)
    if rebuild:
        return done("rebuild", "DTA403", scan, full, full,
                    extra_event={"event": "inc_fallback_rescan",
                                 "code": "DTA403",
                                 "delta_parts": len(delta)},
                    merge_s=merge_s)
    return done("incremental", "DTA401", scan, full,
                _finalize(plan, cols, idx=touched), merge_s=merge_s)
