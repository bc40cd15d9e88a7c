"""Streamed (out-of-core) execution of planned StageGraphs — the port of
``dryad_tpu/exec/stream_exec.py``.

A query whose source streams (``Context.read_store_stream`` /
``read_text_stream`` / ``from_stream``, or a store past
``JobConfig.ooc_auto_stream_rows``) is planned with ONE logical
partition (``plan_query(root, 1)``: the one-partition lowering has no
exchange), and the stage DAG runs over ChunkSources instead of device
PData:

* a run of row-local ops is one chunk function, with up to
  ``ooc_inflight`` chunks in flight and a per-chunk retry at the
  measured need when an op overflows;
* ``sort`` lowers to ``ooc.external_sort``, ``group`` to
  ``ooc.streaming_group_aggregate``, ``distinct`` to
  ``ooc.streaming_distinct``, and so on for every kind of
  ``_STREAM_KINDS``;
* a join (or cross_apply, intersect, except) materializes its RIGHT side
  on the device (at most ``JobConfig.ooc_join_build_rows`` rows) and
  streams the left side through it; right and full joins track the
  matched right rows across chunks (``kernels.right_match_mask``) and
  append the unmatched ones at the end;
* a stage with several consumers spills once to a store under the job's
  directory (a Tee) instead of being recomputed per consumer.

The device holds O(chunk_rows) rows whatever the data size.  The JAX
package's compiled chunk-program memo (``_PROG_CACHE``) has no
counterpart: nothing is compiled.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from dryad_tpu_torch.data.columnar import Batch, unpack_rows
from dryad_tpu_torch.exec import ooc
from dryad_tpu_torch.exec.data import PData, pdata_to_numpy
from dryad_tpu_torch.exec.executor import _UNSCALABLE, _apply_op
from dryad_tpu_torch.exec.ooc import ChunkSource, HChunk, OOCError, \
    _batch_to_chunk, _chunk_to_batch, _concat_hchunks, _probe_schema, \
    _read_ahead, _slice_hchunk, chunk_schema
from dryad_tpu_torch.ops import kernels
from dryad_tpu_torch.plan.stages import StageGraph, StageOp

__all__ = ["StreamSource", "StreamExecutionError", "run_stream_graph",
           "chunks_to_table", "stream_scalar"]


class StreamExecutionError(RuntimeError):
    pass


class StreamSource:
    """Planner-visible streaming source: wraps a ChunkSource and exposes
    ``.capacity`` (= chunk rows) the way PData does."""

    def __init__(self, cs: ChunkSource):
        self.cs = cs

    @property
    def capacity(self) -> int:
        return self.cs.chunk_rows


# op kinds that are chunk-local (one chunk function)
_LOCAL_KINDS = {"fn", "filter", "mean_fin", "flat_tokens", "flat_map",
                "apply", "recap"}
# op kinds with whole-stream semantics, each lowered to an ooc primitive
_STREAM_KINDS = {"sort", "group", "dgroup_local", "distinct",
                 "group_top_k", "take", "skip", "row_index",
                 "take_while", "skip_while", "sliding_window",
                 "group_rank", "group_apply"}

_UNSUPPORTED_HINTS = {}


def _unsupported(kind: str) -> StreamExecutionError:
    hint = _UNSUPPORTED_HINTS.get(kind, "")
    return StreamExecutionError(
        f"op {kind!r} is not supported in streamed (out-of-core) "
        f"execution{': ' + hint if hint else ''}")


# ---------------------------------------------------------------------------
# chunk-local ops (with a measured-need retry per chunk)


def _local_op(b: Batch, op: StageOp, scale: int):
    """One chunk-local op (the executor's ``_apply_op``); returns (batch,
    need_scale): 0 (fits), the scale a retry needs, or ``_UNSCALABLE``."""
    if op.kind not in _LOCAL_KINDS:
        raise _unsupported(op.kind)
    if op.kind == "apply" and op.params.get("with_index"):
        # streamed data has no fixed partition identity
        raise _unsupported("apply_with_partition_index")
    out, needs = _apply_op(b, op, scale)
    return out, needs[0]


def _ops_out_capacity(in_cap: int, ops: List[StageOp]) -> int:
    cap = in_cap
    for op in ops:
        if op.kind in ("flat_tokens", "flat_map"):
            cap = op.params["out_capacity"]
        elif op.kind == "recap":
            cap = op.params["capacity"]
    return cap


def _stream_local(cs: ChunkSource, ops: List[StageOp], config, device,
                  extra_right: Optional[Batch] = None,
                  right_chunk: Optional[HChunk] = None,
                  body_op: Optional[StageOp] = None,
                  stats: Optional[ooc.PrefetchStats] = None
                  ) -> ChunkSource:
    """A run of chunk-local ops (plus an optional binary body op with a
    materialized right side) as one chunk function, streamed with
    ``ooc_inflight`` chunks in flight and a right-sized retry of a chunk
    that overflows.

    Right and full joins run per chunk as inner and left joins, track
    which right rows matched ANY chunk (``kernels.right_match_mask``,
    OR-ed on the host) and append the unmatched right rows as a final
    synthetic chunk: the cross-chunk form of hash_join's own
    synthesis."""
    chunk_rows = cs.chunk_rows
    depth = config.ooc_inflight

    join_how = (body_op.params.get("how", "inner")
                if body_op is not None and body_op.kind == "join" else None)
    track_right = join_how in ("right", "full")
    if track_right:
        body_exec = StageOp("join", dict(
            body_op.params, how="left" if join_how == "full" else "inner"))
        lkeys = list(body_op.params["left_keys"])
        rkeys = list(body_op.params["right_keys"])
    else:
        body_exec = body_op

    def fn(b: Batch, scale: int):
        need_all = torch.zeros((), dtype=torch.int32, device=device)
        for op in ops:
            b, need = _local_op(b, op, scale)
            need_all = torch.maximum(need_all, need)
        matched = None
        if track_right:
            matched = kernels.right_match_mask(b, extra_right, lkeys, rkeys)
        if body_exec is not None:
            b, need = _body_binary(b, extra_right, body_exec, scale)
            need_all = torch.maximum(need_all, need)
        return b, need_all, matched

    # the output schema from one empty chunk; for right-tracking joins
    # the LEFT side's column names too (the synthesized rows' naming)
    probe_b, _, _ = fn(_chunk_to_batch(HChunk.empty_like(cs.schema), 1,
                                       device), 1)
    out_schema = chunk_schema(_batch_to_chunk(probe_b))
    left_names: List[str] = []
    if track_right:
        # unmatched right rows carry RIGHT key bytes in the left key
        # column: widen it to max(left, right), as the in-memory
        # hash_join keeps the full width
        for lk, rk in zip(lkeys, rkeys):
            rc = extra_right.columns.get(rk)
            spec = out_schema.get(lk)
            if (spec is not None and spec["kind"] == "str"
                    and hasattr(rc, "max_len")):
                spec["max_len"] = max(spec["max_len"], int(rc.max_len))
        lp = _chunk_to_batch(HChunk.empty_like(cs.schema), 1, device)
        for op in ops:
            lp, _ = _local_op(lp, op, 1)
        left_names = list(lp.columns.keys())
    out_cap = _ops_out_capacity(chunk_rows, ops)
    if body_op is not None and body_op.kind == "join":
        out_cap = body_op.params["out_capacity"]

    def _slices(oc: HChunk) -> Iterator[HChunk]:
        # oversized outputs are cut so that downstream chunk functions
        # keep their capacity (out_cap is the declared per-chunk bound)
        for s in range(0, max(oc.n, 1), out_cap):
            e = min(s + out_cap, oc.n)
            if e > s or oc.n == 0:
                yield _slice_hchunk(oc, s, e)
            if oc.n == 0:
                return

    def it():
        matched_acc = (np.zeros((extra_right.capacity,), bool)
                       if track_right else None)
        pending: deque = deque()

        def drain(entry) -> Iterator[HChunk]:
            chunk, (out, need, matched) = entry
            scale = 1
            need_i = int(need)
            while need_i > 0:
                if need_i >= _UNSCALABLE:
                    raise OOCError(
                        "a fixed-capacity op (with_capacity) overflowed "
                        "in streamed execution; raise the declared "
                        "capacity")
                scale = max(scale + 1, need_i)
                out, need, matched = fn(
                    _chunk_to_batch(chunk, chunk_rows, device), scale)
                need_i = int(need)
            if matched_acc is not None:
                matched_acc[:] |= matched.cpu().numpy()
            yield from _slices(
                _widen_strs(_batch_to_chunk(out), out_schema))

        for chunk in _read_ahead(cs, config.ooc_prefetch_depth, stats):
            # this chunk's copy and work are queued before the previous
            # chunk is read back
            pending.append((chunk, fn(_chunk_to_batch(chunk, chunk_rows,
                                                      device), 1)))
            if len(pending) >= depth:
                yield from drain(pending.popleft())
        while pending:
            yield from drain(pending.popleft())
        if track_right:
            synth = _synth_unmatched_right(
                right_chunk, matched_acc, out_schema, left_names,
                lkeys, rkeys)
            if synth.n:
                yield from _slices(synth)

    return ChunkSource(it, out_schema, out_cap, on_host=False)


def _widen_strs(oc: HChunk, schema) -> HChunk:
    """Zero-pad string columns up to the schema's max_len (per-chunk join
    outputs carry the left key width; the declared schema may be wider to
    hold unmatched right keys)."""
    cols = dict(oc.cols)
    changed = False
    for k, spec in schema.items():
        if spec["kind"] != "str" or k not in cols:
            continue
        d, ln = cols[k]
        if d.shape[1] < spec["max_len"]:
            nd = np.zeros((d.shape[0], spec["max_len"]), np.uint8)
            nd[:, : d.shape[1]] = d
            cols[k] = (nd, ln)
            changed = True
    return HChunk(cols, oc.n) if changed else oc


def _synth_unmatched_right(right_chunk: HChunk, matched: "np.ndarray",
                           out_schema, left_names, lkeys, rkeys) -> HChunk:
    """The unmatched right rows of a streamed right / full join, made on
    the host: the left key columns carry the right key values, the other
    left columns are zero, the right non-key columns pass through (the
    names and widths of hash_join's output)."""
    n = right_chunk.n
    idx = np.nonzero(~matched[:n])[0]
    u = len(idx)
    key_map = dict(zip(lkeys, rkeys))
    rkeyset = set(rkeys)
    cols: Dict[str, Any] = {}
    # hash_join's naming: a right non-key column keeps its name unless a
    # left column has it (then + "_r")
    rnames = {}
    for k in right_chunk.cols:
        if k in rkeyset:
            continue
        rnames[k] = k if k not in left_names else k + "_r"

    def fit_str(data, lens, spec):
        L = spec["max_len"]
        outd = np.zeros((u, L), np.uint8)
        w = min(L, data.shape[1])
        outd[:, :w] = data[idx][:, :w]
        return outd, np.minimum(lens[idx], L).astype(np.int32)

    for name, spec in out_schema.items():
        src = None
        if name in key_map:
            src = right_chunk.cols[key_map[name]]
        else:
            for k, nm in rnames.items():
                if nm == name:
                    src = right_chunk.cols[k]
                    break
        if src is not None:
            if spec["kind"] == "str":
                cols[name] = fit_str(src[0], src[1], spec)
            else:
                cols[name] = src[idx].astype(np.dtype(spec["dtype"]))
        elif spec["kind"] == "str":
            cols[name] = (np.zeros((u, spec["max_len"]), np.uint8),
                          np.zeros((u,), np.int32))
        else:
            cols[name] = np.zeros((u,) + tuple(spec.get("shape", ())),
                                  np.dtype(spec["dtype"]))
    return HChunk(cols, u)


# ---------------------------------------------------------------------------
# binary body ops (right side materialized)


def _body_binary(left: Batch, right: Batch, op: StageOp, scale: int):
    k, p = op.kind, op.params
    no = torch.zeros((), dtype=torch.int32, device=left.device)
    if k == "join":
        out, need_rows = kernels.hash_join(
            left, right, list(p["left_keys"]), list(p["right_keys"]),
            out_capacity=p["out_capacity"] * scale,
            how=p.get("how", "inner"))
        need = -(-need_rows.long() // p["out_capacity"])
        return out, need.to(torch.int32)
    if k == "apply2":
        return p["fn"](left, right), no
    if k == "semi_anti":
        return kernels.semi_anti_join(
            left, right, sorted(left.names), sorted(right.names),
            anti=p["anti"]), no
    raise _unsupported(k)


def _materialize_small(cs: ChunkSource, config, what: str, device
                       ) -> Tuple[Batch, HChunk]:
    """A (small) chunk stream as ONE device batch: the build side of a
    streamed join, at most ``ooc_join_build_rows`` rows.  Returns (the
    device batch, the merged host chunk), the host copy for a right or
    full join's unmatched rows."""
    frags = [c for c in cs if c.n]
    total = sum(f.n for f in frags)
    limit = config.ooc_join_build_rows
    if total > limit:
        raise StreamExecutionError(
            f"the {what} side of a streamed binary op holds {total} rows "
            f"> JobConfig.ooc_join_build_rows={limit}; streamed joins "
            f"materialize that side on device — shrink it (pre-aggregate/"
            f"filter) or raise the knob")
    merged = _concat_hchunks(cs.schema, frags)
    return _chunk_to_batch(merged, max(total, 1), device), merged


# ---------------------------------------------------------------------------
# whole-stream ops


def _stream_global(cs: ChunkSource, op: StageOp, config, device,
                   spill_dir: Optional[str],
                   stats: Optional[ooc.PrefetchStats] = None,
                   sorts: Optional[List[Dict[str, Any]]] = None
                   ) -> ChunkSource:
    k, p = op.kind, op.params
    knobs = dict(n_buckets=config.ooc_hash_buckets,
                 depth=config.ooc_inflight,
                 prefetch=config.ooc_prefetch_depth, stats=stats,
                 device=device)
    if k == "sort":
        keys = [tuple(x) for x in p["keys"]]

        def it_sort():
            # the sort's shape (buckets, the in-core tier, the chunks
            # scattered in pass B and by re-bucketing: one hist_buckets
            # call each) goes to the job's end event
            info: Dict[str, Any] = {}
            if sorts is not None:
                sorts.append(info)
            return ooc.external_sort(
                cs, keys, spill_dir=_fresh_spill(spill_dir),
                depth=config.ooc_inflight,
                incore_bytes=config.ooc_incore_bytes,
                prefetch=config.ooc_prefetch_depth, stats=stats,
                device=device, info=info)

        return ChunkSource(it_sort, cs.schema, cs.chunk_rows, on_host=False)
    if k == "group":
        keys = list(p["keys"])
        aggs = dict(p["aggs"])
        schema = _probe_schema(
            lambda b: kernels.group_aggregate(b, keys, aggs), cs.schema,
            device)
        return ChunkSource(lambda: ooc.streaming_group_aggregate(
            cs, keys, aggs, **knobs), schema, cs.chunk_rows, on_host=False)
    if k == "dgroup_local":
        # user Decomposable aggregates over streams
        keys = list(p["keys"])
        decs = dict(p["decs"])
        schema = _probe_schema(
            lambda b: kernels.group_decompose_local(b, keys, decs, {}),
            cs.schema, device)
        return ChunkSource(lambda: ooc.streaming_group_decomposable(
            cs, keys, decs, **knobs), schema, cs.chunk_rows, on_host=False)
    if k == "group_top_k":
        keys = list(p["keys"])
        return ChunkSource(lambda: ooc.streaming_group_topk(
            cs, keys, p["k"], p["by"], p["descending"], **knobs),
            cs.schema, cs.chunk_rows, on_host=False)
    if k == "group_rank":
        # medians do not compose: the whole-group machinery materializes
        # each key bucket and runs the in-memory kernel on it
        keys = list(p["keys"])

        def rank_fn(b):
            return kernels.group_rank_select(b, keys, p["by"], p["rank"],
                                             p["out"])

        schema = _probe_schema(rank_fn, cs.schema, device)
        return ChunkSource(lambda: ooc.streaming_group_whole(
            cs, keys, rank_fn, schema,
            max_bucket_rows=config.ooc_group_bucket_rows,
            what="group_rank", **knobs), schema, cs.chunk_rows,
            on_host=False)
    if k == "group_apply":
        # the general per-group result selector, with the in-memory
        # executor's measured-need retry per bucket: the kernel's
        # (num_groups, max_group, total_out) right-size a retry
        keys = list(p["keys"])
        G0, C0, O0 = p["max_groups"], p["group_capacity"], p["out_capacity"]
        R0 = p["out_rows"]

        def apply_at(b, scale):
            return kernels.group_regroup_apply(b, keys, p["fn"], G0 * scale,
                                               C0 * scale, R0, O0 * scale)

        def bucket_fn(b):
            scale = 1
            for _ in range(6):
                out, ng, ms, tot = apply_at(b, scale)
                ng, ms, tot = int(ng), int(ms), int(tot)
                need = max(ng // max(G0, 1), ms // max(C0, 1),
                           tot // max(O0, 1)) + 1
                if ng <= G0 * scale and ms <= C0 * scale \
                        and tot <= O0 * scale:
                    return out
                scale = max(scale * 2, need)
            raise StreamExecutionError(
                f"group_apply bucket still overflowing at scale {scale}")

        schema = _probe_schema(lambda b: apply_at(b, 1)[0], cs.schema,
                               device)
        return ChunkSource(lambda: ooc.streaming_group_whole(
            cs, keys, bucket_fn, schema,
            max_bucket_rows=config.ooc_group_bucket_rows,
            what="group_apply", **knobs), schema, cs.chunk_rows,
            on_host=False)
    if k == "distinct":
        keys = tuple(p["keys"])
        return ChunkSource(lambda: ooc.streaming_distinct(cs, keys, **knobs),
                           cs.schema, cs.chunk_rows, on_host=False)
    if k == "take":
        n = p["n"]

        def it_take():
            left = n
            for chunk in cs:
                if chunk.n <= left:
                    left -= chunk.n
                    yield chunk
                    if left == 0:
                        return  # stop BEFORE pulling another chunk
                else:
                    yield _slice_hchunk(chunk, 0, left)
                    return

        return ChunkSource(it_take, cs.schema, cs.chunk_rows, cs.on_host)
    if k == "skip":
        n = p["n"]

        def it_skip():
            left = n
            for chunk in cs:
                if left >= chunk.n:
                    left -= chunk.n
                    continue
                if left > 0:
                    yield _slice_hchunk(chunk, left, chunk.n)
                    left = 0
                else:
                    yield chunk

        return ChunkSource(it_skip, cs.schema, cs.chunk_rows, cs.on_host)
    if k == "sliding_window":
        # a rolling carry of the last w - 1 rows across chunks: each
        # emitted block's windows start at every position with w rows
        # after it, and consecutive blocks overlap by w - 1 rows, so the
        # window starts run on with no duplicates
        w = p["w"]
        for name, spec in cs.schema.items():
            if spec["kind"] == "str":
                raise StreamExecutionError(
                    f"streamed sliding_window over string column "
                    f"{name!r} is not supported (windowed strings have "
                    f"no chunk representation); project to dense "
                    f"columns first")
        schema = {name: {"kind": "dense", "dtype": spec["dtype"],
                         "shape": [w] + list(spec.get("shape", ()))}
                  for name, spec in cs.schema.items()}

        def windows(block: HChunk) -> HChunk:
            n_out = block.n - w + 1
            idx = np.arange(n_out)[:, None] + np.arange(w)[None, :]
            cols = {name: v[idx] for name, v in block.cols.items()}
            return HChunk(cols, n_out)

        def it_sw():
            carry: Optional[HChunk] = None
            for chunk in cs:
                if chunk.n == 0:
                    continue
                block = (chunk if carry is None
                         else _concat_hchunks(cs.schema, [carry, chunk]))
                if block.n >= w:
                    yield windows(block)
                    carry = _slice_hchunk(block, block.n - (w - 1),
                                          block.n)
                else:
                    carry = block
            # windows crossing the dataset end drop (in-memory semantics)

        return ChunkSource(it_sw, schema, cs.chunk_rows, cs.on_host)
    if k in ("take_while", "skip_while"):
        fn = p["fn"]
        taking = k == "take_while"

        def it_while():
            skipping = not taking
            for chunk in cs:
                if chunk.n == 0:
                    continue
                if not taking and not skipping:
                    yield chunk
                    continue
                b = _chunk_to_batch(chunk, cs.chunk_rows, device)
                mask = fn(dict(b.columns))[:chunk.n].cpu().numpy().astype(
                    bool)
                fails = np.nonzero(~mask)[0]
                cut = int(fails[0]) if fails.size else chunk.n
                if taking:
                    if cut:
                        yield _slice_hchunk(chunk, 0, cut)
                    if cut < chunk.n:
                        return  # the first failing row ends the stream
                else:
                    if cut < chunk.n:
                        skipping = False
                        yield _slice_hchunk(chunk, cut, chunk.n)

        return ChunkSource(it_while, cs.schema, cs.chunk_rows, on_host=False)
    if k == "row_index":
        col = p["column"]
        schema = dict(cs.schema)
        # int64: the streamed engine is for row counts past 2**31
        schema[col] = {"kind": "dense", "dtype": "int64", "shape": []}

        def it_idx():
            off = 0
            for chunk in cs:
                cols = dict(chunk.cols)
                cols[col] = np.arange(off, off + chunk.n, dtype=np.int64)
                off += chunk.n
                yield HChunk(cols, chunk.n)

        return ChunkSource(it_idx, schema, cs.chunk_rows, cs.on_host)
    raise _unsupported(k)


# ---------------------------------------------------------------------------
# graph execution


def _fresh_spill(spill_dir: Optional[str]) -> Optional[str]:
    if spill_dir is None:
        return None
    return tempfile.mkdtemp(prefix="sort-", dir=spill_dir)


def _concat_sources(a: ChunkSource, b: ChunkSource) -> ChunkSource:
    # full schema equality (dtypes and string widths, not just names):
    # mixed widths would fail deep inside a later sort
    if a.schema != b.schema:
        raise StreamExecutionError(
            f"concat schema mismatch (columns must agree in dtype and "
            f"string max_len): {a.schema} vs {b.schema}")

    def it():
        yield from a
        yield from b

    return ChunkSource(it, a.schema, max(a.chunk_rows, b.chunk_rows),
                       a.on_host and b.on_host)


def _zip_sources(a: ChunkSource, b: ChunkSource,
                 suffix: str = "_r") -> ChunkSource:
    """Positional zip of two chunk streams with two aligned cursors:
    fragments are cut at common boundaries so each emitted chunk pairs
    row i of one side with row i of the other; the stream ends with the
    shorter side (LINQ Zip, ``kernels.zip2``)."""
    names = set(a.schema)
    schema = dict(a.schema)
    for k_, spec in b.schema.items():
        schema[k_ if k_ not in names else k_ + suffix] = dict(spec)

    def it():
        ita, itb = iter(a), iter(b)
        fa = fb = None

        def pull(it_):
            for c in it_:
                if c.n:
                    return c
            return None

        while True:
            fa = fa or pull(ita)
            fb = fb or pull(itb)
            if fa is None or fb is None:
                return   # the shorter side ends the stream
            n = min(fa.n, fb.n)
            left = _slice_hchunk(fa, 0, n)
            right = _slice_hchunk(fb, 0, n)
            cols = dict(left.cols)
            for k_, v in right.cols.items():
                cols[k_ if k_ not in names else k_ + suffix] = v
            yield HChunk(cols, n)
            fa = _slice_hchunk(fa, n, fa.n) if fa.n > n else None
            fb = _slice_hchunk(fb, n, fb.n) if fb.n > n else None

    return ChunkSource(it, schema, max(a.chunk_rows, b.chunk_rows),
                       a.on_host and b.on_host)


def _spill_stage(cs: ChunkSource, job_root: str, label: str) -> ChunkSource:
    """Materialize a multi-consumer stage once (a Tee) as a store under
    the job's directory, removed when the job's output stream ends."""
    path = tempfile.mkdtemp(prefix=f"tee-{label}-", dir=job_root)
    target = os.path.join(path, "data")
    ooc.write_chunks_to_store(target, iter(cs), cs.schema)
    return ChunkSource.from_store(target, cs.chunk_rows)


def _pdata_chunks(pd: PData, chunk_rows: int) -> ChunkSource:
    """A device PData mixed into a streamed query: its valid rows, in
    partition order, copied to the host once and cut into chunks (string
    columns keep their width)."""
    cols, counts = pdata_to_numpy(pd)
    rows: Dict[str, Any] = {}
    for k, v in cols.items():
        if isinstance(v, tuple):
            rows[k] = tuple(np.concatenate([x[p, :n] for p, n in
                                            enumerate(counts)])
                            for x in v)
        else:
            rows[k] = np.concatenate([v[p, :n] for p, n in
                                      enumerate(counts)])
    return ChunkSource.from_chunk(HChunk(rows, int(counts.sum())),
                                  chunk_rows)


def _resolve_source(data: Any, config) -> ChunkSource:
    if isinstance(data, StreamSource):
        return data.cs
    if isinstance(data, ChunkSource):
        return data
    if isinstance(data, PData):
        return _pdata_chunks(data, config.ooc_chunk_rows)
    raise StreamExecutionError(
        f"cannot stream source of type {type(data).__name__}")


def _split_leg_ops(ops: List[StageOp]) -> List[Tuple[str, Any]]:
    """[(kind, payload)]: kind "local" (a list of ops) or "global" (one
    op)."""
    out: List[Tuple[str, Any]] = []
    run: List[StageOp] = []
    for op in ops:
        if op.kind in _LOCAL_KINDS:
            run.append(op)
            continue
        if run:
            out.append(("local", run))
            run = []
        if op.kind in _STREAM_KINDS:
            out.append(("global", op))
        else:
            raise _unsupported(op.kind)
    if run:
        out.append(("local", run))
    return out


def run_stream_graph(graph: StageGraph, config, device,
                     spill_dir: Optional[str] = None,
                     event_log=None) -> ChunkSource:
    """Execute a one-partition StageGraph over chunk streams on
    ``device``; returns the output stage's ChunkSource.

    The result is SINGLE-DRAIN: the job's temporary state (Tee spills,
    sort spill buckets) lives under one job directory, removed when the
    returned stream ends or is closed early (``take``).  Events:
    ``stream_tee_spill`` per Tee; at the end ``prefetch_stall`` when the
    prefetch pipelines stalled, and one ``stream_stage_done`` for the
    job with its wall, its prefetch counters and the shape of each
    external sort that ran (``ooc.external_sort``'s ``info``)."""
    ev = event_log or (lambda e: None)
    job_root = tempfile.mkdtemp(prefix="dryad-stream-", dir=spill_dir)
    # sort buckets spill to disk only when the caller opted into spills;
    # otherwise they stay in host memory
    sort_spill = job_root if spill_dir is not None else None
    # one prefetch-stats box per job, fed by every pipeline of the graph
    stats = ooc.PrefetchStats()
    sorts: List[Dict[str, Any]] = []
    t0 = time.perf_counter()
    consumers: Dict[int, int] = {}
    for st in graph.stages:
        for sid in st.input_stage_ids():
            consumers[sid] = consumers.get(sid, 0) + 1

    results: Dict[int, ChunkSource] = {}
    try:
        for st in graph.topo_order():
            legs_cs: List[ChunkSource] = []
            for leg in st.legs:
                if leg.exchange is not None:
                    raise StreamExecutionError(
                        "streamed plans must be planned with npartitions=1 "
                        "(found an exchange)")
                if isinstance(leg.src, int):
                    cs = results[leg.src]
                elif leg.src[0] == "source":
                    cs = _resolve_source(leg.src[1], config)
                else:
                    raise StreamExecutionError(
                        "placeholders (do_while bodies) are not yet streamed")
                for kind, payload in _split_leg_ops(list(leg.ops)):
                    if kind == "local":
                        cs = _stream_local(cs, payload, config, device,
                                           stats=stats)
                    else:
                        cs = _stream_global(cs, payload, config, device,
                                            sort_spill, stats=stats,
                                            sorts=sorts)
                legs_cs.append(cs)

            cur = legs_cs[0]
            rest = legs_cs[1:]
            for op in st.body:
                if op.kind in ("join", "apply2", "semi_anti"):
                    right_b, right_h = _materialize_small(
                        rest.pop(0), config, "right/build", device)
                    cur = _stream_local(cur, [], config, device,
                                        extra_right=right_b,
                                        right_chunk=right_h, body_op=op,
                                        stats=stats)
                elif op.kind == "concat":
                    cur = _concat_sources(cur, rest.pop(0))
                elif op.kind == "zip":
                    cur = _zip_sources(cur, rest.pop(0),
                                       op.params.get("suffix", "_r"))
                elif op.kind in _STREAM_KINDS:
                    cur = _stream_global(cur, op, config, device, sort_spill,
                                         stats=stats, sorts=sorts)
                elif op.kind in _LOCAL_KINDS:
                    cur = _stream_local(cur, [op], config, device,
                                        stats=stats)
                else:
                    raise _unsupported(op.kind)

            if consumers.get(st.id, 0) > 1:
                cur = _spill_stage(cur, job_root, st.label or str(st.id))
                ev({"event": "stream_tee_spill", "stage": st.id,
                    "label": st.label})
            results[st.id] = cur
    except BaseException:
        shutil.rmtree(job_root, ignore_errors=True)
        raise

    out = results[graph.out_stage]

    def final_it():
        try:
            yield from out
        finally:
            shutil.rmtree(job_root, ignore_errors=True)
            snap = stats.snapshot()
            if snap["stalls"]:
                ev({"event": "prefetch_stall", **snap})
            ev({"event": "stream_stage_done", "stage": graph.out_stage,
                "label": "stream", "wall_s": time.perf_counter() - t0,
                "prefetch_stalls": snap["stalls"],
                "prefetch_stall_s": snap["stall_s"],
                "prefetch_chunks": snap["chunks"], "sorts": sorts})

    return ChunkSource(final_it, out.schema, out.chunk_rows, on_host=False)


# ---------------------------------------------------------------------------
# terminal helpers


def chunks_to_table(cs: ChunkSource) -> Dict[str, Any]:
    """Drain a chunk stream to a host table (the collect terminal):
    string columns become lists of bytes, as ``exec.data.pdata_to_host``
    gives them."""
    frags = [c for c in cs if c.n]
    out: Dict[str, Any] = {}
    for k, spec in cs.schema.items():
        if spec["kind"] == "str":
            vals: List[bytes] = []
            for f in frags:
                d, ln = f.cols[k]
                vals.extend(unpack_rows(np.ascontiguousarray(d),
                                        np.ascontiguousarray(ln)))
            out[k] = vals
        else:
            out[k] = (np.concatenate([f.cols[k] for f in frags])
                      if frags else
                      np.zeros((0,) + tuple(spec.get("shape", ())),
                               np.dtype(spec["dtype"])))
    return out


def stream_scalar(cs: ChunkSource, kind: str, column: str):
    """A scalar terminal over a chunk stream: per-chunk host reductions
    combined as they come (sum / min / max / mean / any / all)."""
    acc = None
    cnt = 0
    for chunk in cs:
        if chunk.n == 0:
            continue
        v = chunk.cols[column]
        if isinstance(v, tuple):
            raise StreamExecutionError(
                f"scalar aggregate over string column {column!r}")
        if kind in ("sum", "mean"):
            s = v.sum(axis=0)
            acc = s if acc is None else acc + s
            cnt += chunk.n
        elif kind == "min":
            m = v.min(axis=0)
            acc = m if acc is None else np.minimum(acc, m)
        elif kind == "max":
            m = v.max(axis=0)
            acc = m if acc is None else np.maximum(acc, m)
        elif kind == "any":
            acc = bool(acc) or bool(np.any(v))
        elif kind == "all":
            acc = (True if acc is None else bool(acc)) and bool(np.all(v))
        else:
            raise ValueError(kind)
    if kind == "mean":
        return None if not cnt else acc / cnt
    if kind == "any":
        return bool(acc)
    if kind == "all":
        return True if acc is None else bool(acc)
    if kind == "sum" and acc is None:
        return 0  # as in memory: the sum over an empty dataset is 0
    return acc
