"""Streamed (larger than the card) execution of PLANNED StageGraphs over
the worker gang — the port of ``dryad_tpu/runtime/stream_plan.py``.

A cluster Context's streamed query (``read_store_stream``,
``read_text_stream`` and ``from_stream``, spooled into a store the
workers reach) is planned like any other cluster query, at the gang's
``nparts``, exchanges included, and every gang worker runs the plan over
chunk streams of its own partitions:

* each partition streams its own subset of the source store's
  partitions (store partition p -> partition p mod P), so a rank reads
  only its own;
* a leg's trailing chunk-local and partial-safe ops (``_WAVE_FUSABLE``:
  row-local ops, group and distinct partials) run per chunk inside the
  wave; whole-stream leg ops (take, skip, row_index, sort, ...) apply per
  partition first, through ``exec/stream_exec``'s machinery;
* a leg's exchange runs as lockstep chunk WAVES: each wave takes one
  chunk of every local partition, runs the fused ops and ONE hash,
  range or broadcast exchange across the gang (``parallel/shuffle.py``
  over the gang mesh: the pack kernels, the host-staged all_to_all, the
  unpack kernel), and the received rows go to per-partition bucket
  stores — spill files under the job's directory, or host memory
  compacted by the stage's merge for group partials;
* the stage BODY then runs per partition over its bucket stream through
  the one-partition streamed executor: a join materializes its
  bucket-aligned right side on the card, exactly as the one-process
  path does;
* the terminals are the gang's parallel collect and parallel store
  writers; loop state (``do_while``) and ``cache()`` stay resident on the
  workers under ``keep_token``.

The reference's channels stream every operator alike
(DryadVertex/.../channelinterface.h:212); this gives the gang the same
property through one lowering.

Mirrored determinism is the contract, as in ``runtime/exec_common.py``:
every rank runs the same waves, stages and retries in the same order.
A wave's continuation is one all-gather of the ranks' live streams, the
wave's need channels (capacity scale, send slack, measured slot) are
max-reduced across the gang (``Mesh.all_reduce_max``, the JAX package's
in-program ``pmax``), range bounds are cut from all-gathered samples,
and a global take is one all-gather of the prefix counts.  One rank that
skipped a collective would stall every other in gloo.

The JAX package compiles one wave program per (scale, slack, slot) and
memoizes it; the port compiles nothing per shape, so the wave is a plain
function (``_wave``) and has no program cache.
"""

from __future__ import annotations

import shutil
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from dryad_tpu_torch.analysis.diagnostics import DiagnosticError
from dryad_tpu_torch.plan.stages import Exchange, Stage, StageOp

__all__ = ["execute_stream_plan", "has_stream_sources", "StreamPlanError"]


class StreamPlanError(DiagnosticError):
    """A streamed-plan contract violation.  Every raise carries the stable
    code of the static rule that catches the same condition before
    submission (DTA002 / DTA003), or a DTA9xx runtime-only code for
    data-dependent overflows and internal invariants
    (``analysis/diagnostics.CODES``; ``tests/test_torch_stream_cluster.py``
    holds the mapping)."""


# leg-op kinds safe to apply PER CHUNK inside a wave: chunk-local ops,
# and partial aggregations whose merge runs after the exchange
_WAVE_FUSABLE = {"fn", "filter", "mean_fin", "flat_tokens", "flat_map",
                 "apply", "recap", "group", "dgroup_partial",
                 "dgroup_local", "distinct"}

# whole-group kinds (group_apply, group_rank) stream through
# exec/ooc.streaming_group_whole — post-exchange bucket streams are
# key-aligned, so each partition holds complete groups; zip pairs
# per-partition streams by position; a global take coordinates across
# the gang through one all-gather (_global_take).  Nothing is refused
# (channelinterface.h:212: the reference's channels stream every
# operator), so the JAX package's empty ``_UNSUPPORTED`` table and its
# two raise sites have no counterpart here.


class _StreamSpec:
    """The graph-visible stand-in of a streamed store source."""

    def __init__(self, spec: Dict[str, Any]):
        self.spec = spec

    @property
    def capacity(self) -> int:
        return self.spec["chunk_rows"]


def has_stream_sources(source_specs: Dict[str, Dict[str, Any]]) -> bool:
    return any(s.get("kind") == "store_stream"
               for s in source_specs.values())


# ---------------------------------------------------------------------------
# per-stage results: one re-iterable ChunkSource per LOCAL partition


class _DevStreams:
    def __init__(self, streams: List[Any]):
        self.streams = streams  # [P_loc] ChunkSources, partition-aligned

    @property
    def schema(self):
        return self.streams[0].schema

    @property
    def chunk_rows(self):
        return self.streams[0].chunk_rows


def _source_streams(spec: Dict[str, Any], mesh, config) -> _DevStreams:
    """A store's partitions as per-local-partition chunk streams: store
    partition p is served by global partition p mod P, so output
    partition ids line up with bucket ids and a rank reads only its
    own partitions."""
    from dryad_tpu_torch.exec import ooc
    from dryad_tpu_torch.io.store import store_meta
    path = spec["path"]
    chunk_rows = spec["chunk_rows"]
    P = mesh.nparts
    meta = store_meta(path)
    streams = []
    for d in range(mesh.local_nparts):
        g = mesh.part_start + d
        parts = [p for p in range(meta["npartitions"]) if p % P == g]
        streams.append(ooc.ChunkSource.from_store(path, chunk_rows,
                                                  partitions=parts))
    return _DevStreams(streams)


def _resident_streams(pd, mesh, config) -> _DevStreams:
    """A PData of this rank (loop state, a cache, a columns / text /
    store source joining a streamed plan) as one host chunk per local
    partition."""
    from dryad_tpu_torch.exec.ooc import ChunkSource, chunk_schema
    from dryad_tpu_torch.runtime.stream_cluster import (_read_local_shards,
                                                        local_batch_chunks)
    cols, counts = _read_local_shards(pd)
    chunks = local_batch_chunks(cols, counts)
    schema = chunk_schema(chunks[0])
    cap = max(pd.capacity, 1)
    return _DevStreams([
        ChunkSource((lambda c=c: iter([c])), schema, cap) for c in chunks])


# ---------------------------------------------------------------------------
# wave exchange


def _wave_chunk_op(b, op: StageOp, scale: int):
    """One wave-fusable op on one partition's chunk batch: (batch, need
    scale as a 0-d int32 tensor)."""
    from dryad_tpu_torch.exec import stream_exec
    from dryad_tpu_torch.ops import kernels
    k, p = op.kind, op.params
    no = torch.zeros((), dtype=torch.int32, device=b.device)
    if k in stream_exec._LOCAL_KINDS:
        out, need = stream_exec._local_op(b, op, scale)
        return out, need.to(torch.int32)
    if k == "group":
        return kernels.group_aggregate(b, list(p["keys"]),
                                       dict(p["aggs"])), no
    if k == "dgroup_partial":
        return kernels.group_decompose_partial(
            b, list(p["keys"]), p["decs"], p["box"]), no
    if k == "dgroup_local":
        return kernels.group_decompose_local(
            b, list(p["keys"]), p["decs"], p["box"]), no
    if k == "distinct":
        return kernels.distinct(b, list(p["keys"]) or None), no
    raise StreamPlanError(f"op {k!r} cannot ride a wave program",
                          code="DTA901", span=op.span)


def _wave(parts: List[Any], leg_ops: List[StageOp], ex: Exchange,
          scale: int, slack: int, slot_rows: Optional[int],
          bounds: Optional[torch.Tensor], mesh):
    """One wave on this rank: the fused leg ops on each local partition's
    chunk, then the leg's exchange across the gang.  Returns (the local
    destinations' batches, [need scale, need slack, slot used] max-reduced
    across the gang)."""
    from dryad_tpu_torch.parallel import shuffle
    out_cap = max(1, ex.out_capacity) * scale
    need_local = torch.zeros((), dtype=torch.int32, device=mesh.device)
    fused = []
    for b in parts:
        for op in leg_ops:
            b, need = _wave_chunk_op(b, op, scale)
            need_local = torch.maximum(need_local, need)
        fused.append(b)
    slot = torch.zeros((), dtype=torch.int32, device=mesh.device)
    if ex.kind == "hash":
        # empty keys = whole row; sorted so both legs of a set op agree
        keys = list(ex.keys) or sorted(fused[0].names)
        out, nr, nsl, slot = shuffle.hash_exchange(
            fused, keys, out_cap, send_slack=slack, slot_rows=slot_rows,
            mesh=mesh, axis=ex.axis)
    elif ex.kind == "range":
        out, nr, nsl, slot = shuffle.range_exchange(
            fused, ex.bounds_key or ex.keys[0], bounds, out_cap,
            descending=ex.descending, send_slack=slack,
            slot_rows=slot_rows, mesh=mesh)
    elif ex.kind == "broadcast":
        out, nr, nsl = shuffle.broadcast_gather(fused, out_cap, mesh)
    else:
        raise StreamPlanError(f"exchange kind {ex.kind!r}", code="DTA902")
    exch_scale = -(-nr.to(torch.int64) // max(1, ex.out_capacity))
    need_scale = torch.maximum(need_local.to(torch.int64), exch_scale)
    info = torch.stack([need_scale, nsl.to(torch.int64),
                        slot.to(torch.int64)])
    # the gang's pmax: every rank takes the same retry decision
    return out, mesh.all_reduce_max(info)


def _compact_fn_for(stage: Stage):
    """The bucket compaction from the stage's FIRST body group op
    (merging already-merged partials is sound: the merges are
    associative — sum of sums, min of mins, a decomposable merge)."""
    from dryad_tpu_torch.ops import kernels
    for op in stage.body:
        if op.kind == "group":
            keys, aggs = list(op.params["keys"]), dict(op.params["aggs"])
            return lambda b: kernels.group_aggregate(b, keys, aggs)
        if op.kind == "dgroup_merge":
            keys = list(op.params["keys"])
            decs, box = op.params["decs"], op.params["box"]
            return lambda b: kernels.group_decompose_merge(
                b, keys, decs, box, False)
        if op.kind == "distinct":
            keys = list(op.params["keys"]) or None
            return lambda b: kernels.distinct(b, keys)
    return None


def _pow2(n: int) -> int:
    c = 1
    while c < max(n, 1):
        c *= 2
    return c


def _run_leg_waves(dev: _DevStreams, leg_ops: List[StageOp], ex: Exchange,
                   mesh, config, bounds_arr, compact_fn, job_root: str,
                   ws: Dict[str, Any], stats=None) -> _DevStreams:
    """Lockstep chunk waves for one leg's exchange; returns per-partition
    bucket streams holding ALL received rows (spilled to disk, or in
    host memory compacted for group partials).  ``ws``: the job's wave
    counters (``execute_stream_plan``)."""
    from dryad_tpu_torch.exec import ooc
    from dryad_tpu_torch.exec.ooc import ChunkSource, HChunk
    from dryad_tpu_torch.runtime.stream_cluster import _host_allgather
    device = mesh.device
    chunk_rows = dev.chunk_rows
    schema = dev.schema

    # the bucket schema is the EXCHANGED row schema: the wave ops over an
    # empty chunk (which also fills a decomposable's state box)
    probe_b = ooc._chunk_to_batch(ooc.HChunk.empty_like(schema), 1, device)
    for op in leg_ops:
        probe_b, _ = _wave_chunk_op(probe_b, op, 1)
    out_schema = ooc.chunk_schema(ooc._batch_to_chunk(probe_b))

    spill = None if compact_fn is not None else \
        tempfile.mkdtemp(prefix="wave-", dir=job_root)
    if compact_fn is not None:
        ws["compacted_legs"] += 1
    store = ooc._BucketStore(out_schema, mesh.local_nparts, spill_dir=spill)
    out_cap = max(1, ex.out_capacity)

    def compact_bucket(d: int) -> None:
        merged = ooc._concat_hchunks(out_schema, store.fragments(d))
        out = ooc._batch_to_chunk(compact_fn(
            ooc._chunk_to_batch(merged, _pow2(merged.n), device)))
        if out.n > out_cap:
            raise StreamPlanError(
                f"bucket {mesh.part_start + d} holds {out.n} distinct "
                f"groups > exchange capacity {out_cap}; raise chunk_rows",
                code="DTA903")
        store._ram[d] = [out]
        ws["compactions"] += 1

    slack = config.initial_send_slack
    scale = 1
    # measured send slots (the role of DrDynamicDistributor.cpp:388):
    # wave 1 ships the structural slack and MEASURES the real per-slot
    # need; later waves ship that slot, quantized to 16 rows, so the
    # bytes on the wire converge to the useful bytes
    slot_rows: Optional[int] = None
    bounds = (ooc._bounds_tensor(bounds_arr, device)
              if ex.kind == "range" else None)
    # per-partition read-ahead: the next wave's chunk reads overlap this
    # wave's exchange (host-made chunks only: the thread touches no CUDA
    # state)
    its = [ooc._read_ahead(cs, config.ooc_prefetch_depth, stats)
           for cs in dev.streams]
    while True:
        chunks = [next(it, None) for it in its]
        live = _host_allgather(
            np.asarray([sum(c is not None for c in chunks)], np.int32),
            mesh)
        if int(live.sum()) == 0:
            break
        ws["waves"] += 1
        # every partition's batch with its columns in the schema's order:
        # the exchange packs each partition's columns in its own order
        # and unpacks every one by the first's (and another rank's), and
        # a store's chunks, a spilled bucket's and an empty one may each
        # come in another order
        chunks = [HChunk({k: c.cols[k] for k in schema}, c.n)
                  if c is not None else HChunk.empty_like(schema)
                  for c in chunks]
        for attempt in range(config.max_capacity_retries + 1):
            parts = [ooc._chunk_to_batch(c, chunk_rows, device)
                     for c in chunks]
            out, info = _wave(parts, leg_ops, ex, scale, slack, slot_rows,
                              bounds, mesh)
            ws["attempts"][ex.kind] = ws["attempts"].get(ex.kind, 0) + 1
            need_scale, need_slack, slot_used = (int(x) for x in
                                                 info.tolist())
            if need_scale == 0 and need_slack == 0:
                if ex.kind != "broadcast":
                    # exact slots for the NEXT wave, never below this
                    # wave's measured need
                    q = max(16, -(-slot_used // 16) * 16)
                    slot_rows = max(slot_rows or 0, q)
                break
            ws["retries"] += 1
            scale = max(scale, need_scale)
            if slot_rows is not None:
                # a measured slot overflowed (the data drifted): resize
                # from the fresh measurement
                slot_rows = max(16, -(-slot_used // 16) * 16)
            else:
                slack = max(slack, min(need_slack, mesh.nparts))
        else:
            raise StreamPlanError(
                "wave exchange still overflowing after "
                f"{config.max_capacity_retries} retries (scale={scale})",
                code="DTA904")
        for d, b in enumerate(out):
            hc = ooc._batch_to_chunk(b)
            if hc.n == 0:
                continue
            store.append(d, hc)
            if spill is not None:
                ws["spilled_bytes"] += sum(
                    (v[0].nbytes + v[1].nbytes) if isinstance(v, tuple)
                    else v.nbytes for v in hc.cols.values())
            if compact_fn is not None and store.rows(d) > out_cap:
                compact_bucket(d)
    # waves done: release the spill WRITE handles (fragments() reads by
    # name): a long-lived worker running many streamed jobs must not
    # collect open files
    store.close()

    def bucket_source(d: int) -> ChunkSource:
        # a retried wave may have delivered fragments above the declared
        # bound: re-slice, so downstream chunk functions keep their
        # capacities
        bound = max(out_cap, chunk_rows)

        def it():
            for frag in store.fragments(d):
                for s in range(0, max(frag.n, 1), bound):
                    e = min(s + bound, frag.n)
                    if e > s:
                        yield ooc._slice_hchunk(frag, s, e)
        return ChunkSource(it, out_schema, bound)

    return _DevStreams([bucket_source(d) for d in range(mesh.local_nparts)])


def _put_aligned(chunks, schema, capacity: int, mesh):
    """This rank's per-partition host chunks (None: an exhausted stream)
    as one PData [P_loc, capacity] on the mesh's device, zero padded."""
    from dryad_tpu_torch.exec.data import stack_partitions
    from dryad_tpu_torch.exec.ooc import HChunk, _chunk_to_batch
    empty = HChunk.empty_like(schema)
    return stack_partitions([
        _chunk_to_batch(c if c is not None else empty, capacity,
                        mesh.device) for c in chunks])


# ---------------------------------------------------------------------------
# leg / body streaming through the one-partition machinery


def _global_take(dev: _DevStreams, n: int, mesh) -> _DevStreams:
    """A global take over the gang's streams.  Every partition drains AT
    MOST n rows of its stream (the pull stops early: chunks past the
    bound are never fetched); ONE all-gather of the per-partition counts
    then gives partition g exactly ``clip(n - rows_before_g, 0, local)``
    rows in partition-major order — the order the streamed ``collect`` /
    ``to_store`` emit rows in, so ``take(n)`` is the head of the
    streamed output (after a range-exchanged ``order_by``, the exact
    global top n).  The kept rows stay on the host, at most n a
    partition."""
    from dryad_tpu_torch.exec.ooc import ChunkSource, _slice_hchunk
    from dryad_tpu_torch.runtime.stream_cluster import _host_allgather
    schema, chunk_rows = dev.schema, dev.chunk_rows
    frags_per_dev: List[List[Any]] = []
    counts: List[int] = []
    for cs in dev.streams:
        frags: List[Any] = []
        got = 0
        for c in cs:
            if c.n == 0:
                continue
            take = min(c.n, n - got)
            frags.append(c if take == c.n else _slice_hchunk(c, 0, take))
            got += take
            if got >= n:
                break           # stop BEFORE pulling another chunk
        frags_per_dev.append(frags)
        counts.append(got)
    allc = _host_allgather(np.asarray(counts, np.int64), mesh
                           ).reshape(-1)          # [P] partition-major
    outs: List[Any] = []
    for d, frags in enumerate(frags_per_dev):
        before = int(allc[: mesh.part_start + d].sum())
        keep = max(0, min(n - before, counts[d]))
        kept: List[Any] = []
        acc = 0
        for c in frags:
            if acc >= keep:
                break
            t = min(c.n, keep - acc)
            kept.append(c if t == c.n else _slice_hchunk(c, 0, t))
            acc += t
        outs.append(ChunkSource(lambda ks=tuple(kept): iter(ks),
                                schema, chunk_rows))
    return _DevStreams(outs)


def _apply_leg_ops(dev: _DevStreams, ops: List[StageOp], config, job_root,
                   mesh, stats=None) -> _DevStreams:
    """Leg ops with whole-stream semantics over a stage input's
    per-partition streams: chunk-local runs and per-partition globals
    apply per partition through exec/stream_exec; a GLOBAL take
    coordinates across the gang at once (every rank walks the same
    stages in the same order, so the all-gather lines up)."""
    from dryad_tpu_torch.exec import stream_exec
    device = mesh.device
    for kind, payload in stream_exec._split_leg_ops(list(ops)):
        if kind == "local":
            dev = _DevStreams([
                stream_exec._stream_local(cs, payload, config, device,
                                          stats=stats)
                for cs in dev.streams])
            continue
        if payload.kind == "take" and payload.params.get("global"):
            dev = _global_take(dev, payload.params["n"], mesh)
            continue
        dev = _DevStreams([
            stream_exec._stream_global(cs, payload, config, device,
                                       job_root, stats=stats)
            for cs in dev.streams])
    return dev


def _run_body(legs_out: List[_DevStreams], body: List[StageOp], config,
              job_root, mesh, stats=None) -> _DevStreams:
    """A stage body over the (bucket-aligned) per-partition streams;
    per-partition ops stream independently, a global take coordinates
    through ``_global_take``."""
    from dryad_tpu_torch.exec import stream_exec
    device = mesh.device
    dpp = len(legs_out[0].streams)
    cur = legs_out[0]
    rest = list(legs_out[1:])
    for op in body:
        if op.kind in ("join", "apply2", "semi_anti"):
            r = rest.pop(0)
            outs = []
            for d in range(dpp):
                right_b, right_h = stream_exec._materialize_small(
                    r.streams[d], config, "right/build", device)
                outs.append(stream_exec._stream_local(
                    cur.streams[d], [], config, device, extra_right=right_b,
                    right_chunk=right_h, body_op=op, stats=stats))
            cur = _DevStreams(outs)
        elif op.kind == "concat":
            r = rest.pop(0)
            cur = _DevStreams([
                stream_exec._concat_sources(cur.streams[d], r.streams[d])
                for d in range(dpp)])
        elif op.kind == "zip":
            r = rest.pop(0)
            cur = _DevStreams([
                stream_exec._zip_sources(cur.streams[d], r.streams[d],
                                         op.params.get("suffix", "_r"))
                for d in range(dpp)])
        elif op.kind == "take" and op.params.get("global"):
            cur = _global_take(cur, op.params["n"], mesh)
        elif op.kind in stream_exec._STREAM_KINDS \
                or op.kind == "dgroup_merge":
            cur = _DevStreams([
                _body_stream_global(cur.streams[d], op, config, job_root,
                                    device, stats=stats)
                for d in range(dpp)])
        elif op.kind in stream_exec._LOCAL_KINDS:
            cur = _DevStreams([
                stream_exec._stream_local(cur.streams[d], [op], config,
                                          device, stats=stats)
                for d in range(dpp)])
        else:
            raise StreamPlanError(
                f"op {op.kind!r} unsupported over cluster streams",
                code="DTA003", span=op.span)
    return cur


def _body_stream_global(cs, op: StageOp, config, job_root, device,
                        stats=None):
    from dryad_tpu_torch.exec import ooc, stream_exec
    if op.kind != "dgroup_merge":
        return stream_exec._stream_global(cs, op, config, device, job_root,
                                          stats=stats)
    # the decomposable reduce-side merge over a bucket stream: merge the
    # partial-state rows (one partition's bucket holds whole keys),
    # finalizing as the op says
    from dryad_tpu_torch.ops import kernels
    keys = list(op.params["keys"])
    decs, box = op.params["decs"], op.params["box"]
    final = op.params["finalize"]

    def run(b):
        return kernels.group_decompose_merge(b, keys, decs, box, final)

    rows = cs.chunk_rows

    def it():
        merged = ooc._concat_hchunks(cs.schema, list(cs))
        out = ooc._batch_to_chunk(run(
            ooc._chunk_to_batch(merged, _pow2(merged.n), device)))
        # one chunk at most ``rows`` rows, as the stream declares
        for s in range(0, max(out.n, 1), rows):
            e = min(s + rows, out.n)
            if e > s:
                yield ooc._slice_hchunk(out, s, e)

    probe = ooc._batch_to_chunk(run(
        ooc._chunk_to_batch(ooc.HChunk.empty_like(cs.schema), 1, device)))
    return ooc.ChunkSource(it, ooc.chunk_schema(probe), rows,
                           on_host=False)


# ---------------------------------------------------------------------------
# the runner


def execute_stream_plan(plan_json: str, fn_table, source_specs, mesh,
                        event_log=None, store_path: Optional[str] = None,
                        store_partitioning: Optional[Dict[str, Any]] = None,
                        collect: Any = True, config=None,
                        keep_token: Optional[str] = None,
                        release: tuple = (),
                        store_compression: Optional[str] = None):
    """The streamed counterpart of ``runtime/exec_common.execute_plan``:
    the same submission contract (``(table, extras)`` back to the
    worker loop), the plan run as chunk waves and per-partition bucket
    streams.  ``extras["stream"]`` counts the job's waves, capacity
    retries, exchange attempts by kind (``attempts``), bytes spilled to
    bucket stores, legs whose buckets compact in host memory
    (``compacted_legs``) and their compactions, and gives each range
    leg's bounds (``bounds``: one list of P - 1 lanes a range
    exchange)."""
    from dryad_tpu_torch.exec import ooc
    from dryad_tpu_torch.exec.stream_exec import chunks_to_table
    from dryad_tpu_torch.plan.serialize import graph_from_json
    from dryad_tpu_torch.runtime import exec_common
    from dryad_tpu_torch.runtime.sources import (MissingResidentToken,
                                                 build_source)
    from dryad_tpu_torch.runtime.stream_cluster import (_MAX_SAMPLES,
                                                        _gathered_bounds,
                                                        _host_allgather,
                                                        _sample_pass,
                                                        _write_partitions)
    from dryad_tpu_torch.utils.config import JobConfig

    config = config or JobConfig()
    ev = event_log or (lambda e: None)
    for tok in release:
        exec_common._RESIDENT.pop(tok, None)

    sources: Dict[str, Any] = {}
    for key, spec in source_specs.items():
        if spec.get("kind") == "store_stream":
            sources[key] = _StreamSpec(spec)
        elif spec.get("kind") == "resident":
            tok = spec["token"]
            if tok not in exec_common._RESIDENT:
                raise MissingResidentToken(tok)
            sources[key] = exec_common._RESIDENT[tok]
        else:
            sources[key] = build_source(
                spec, mesh, verify=config.store_verify_checksums,
                resident=exec_common._RESIDENT)
    graph = graph_from_json(plan_json, fn_table=fn_table, sources=sources)

    start, dpp = mesh.part_start, mesh.local_nparts
    job_root = tempfile.mkdtemp(prefix="dryad-splan-")
    wave_stats: Dict[str, Any] = {"waves": 0, "retries": 0,
                                  "attempts": {}, "spilled_bytes": 0,
                                  "compacted_legs": 0, "compactions": 0,
                                  "bounds": []}

    def as_dev_streams(x) -> _DevStreams:
        if isinstance(x, _DevStreams):
            return x
        if isinstance(x, _StreamSpec):
            return _source_streams(x.spec, mesh, config)
        # a PData of this rank (loop state, columns, stores)
        return _resident_streams(x, mesh, config)

    try:
        results: Dict[int, _DevStreams] = {}
        stage_stats: List[Tuple[int, Any, Dict[str, Any]]] = []
        for st in graph.topo_order():
            t0 = time.time()
            # per-stage prefetch accounting: stalls measured while this
            # stage's waves and legs drain surface on its
            # stream_stage_done
            stats = ooc.PrefetchStats()
            legs_out: List[_DevStreams] = []
            for leg in st.legs:
                if isinstance(leg.src, int):
                    src = results[leg.src]
                elif leg.src[0] == "source":
                    src = as_dev_streams(leg.src[1])
                else:
                    raise StreamPlanError(
                        "placeholders are not supported in streamed "
                        "cluster plans (do_while ships loop state as "
                        "residents)", code="DTA002")
                if leg.exchange is None:
                    legs_out.append(_apply_leg_ops(src, list(leg.ops),
                                                   config, job_root, mesh,
                                                   stats=stats))
                    continue
                # whole-stream leg ops run first, per partition; the
                # trailing wave-fusable suffix rides the waves
                ops = list(leg.ops)
                cut = len(ops)
                while cut > 0 and ops[cut - 1].kind in _WAVE_FUSABLE:
                    cut -= 1
                pre, fus = ops[:cut], ops[cut:]
                pre_dev = src
                if pre:
                    pre_dev = _apply_leg_ops(src, pre, config, job_root,
                                             mesh, stats=stats)
                bounds = np.zeros((0,), np.uint32)
                if leg.exchange.kind == "range":
                    # sampled global quantile bounds (the role of
                    # DryadLinqSampler.cs:42) from the exchange's own
                    # input streams
                    key = leg.exchange.bounds_key or leg.exchange.keys[0]
                    samples = [_sample_pass(cs, key)[0]
                               for cs in pre_dev.streams]
                    merged = (np.concatenate(samples) if samples
                              else np.zeros((0,), np.uint32))
                    if len(merged) > _MAX_SAMPLES:
                        merged = merged[np.linspace(
                            0, len(merged) - 1,
                            _MAX_SAMPLES).astype(np.int64)]
                    bounds = _gathered_bounds(merged, mesh, mesh.nparts)
                    wave_stats["bounds"].append(
                        [int(x) for x in bounds.tolist()])
                compact = _compact_fn_for(st) if any(
                    o.kind in ("group", "dgroup_partial", "dgroup_local")
                    for o in fus) else None
                legs_out.append(_run_leg_waves(
                    pre_dev, fus, leg.exchange, mesh, config, bounds,
                    compact, job_root, wave_stats, stats=stats))
            out = _run_body(legs_out, list(st.body), config, job_root,
                            mesh, stats=stats)
            results[st.id] = out
            snap = stats.snapshot()
            ev({"event": "stream_stage_done", "stage": st.id,
                "label": st.label, "wall_s": round(time.time() - t0, 4),
                "prefetch_stalls": snap["stalls"],
                "prefetch_stall_s": snap["stall_s"]})
            if snap["stalls"]:
                ev({"event": "prefetch_stall", "stage": st.id, **snap})
            # exchange-free stages compose LAZY streams, whose prefetchers
            # stall later, when the final drain (or a later stage's
            # waves) pulls: keep the stats to report those late stalls
            stage_stats.append((st.id, stats, snap))

        final = results[graph.out_stage]
        extras: Dict[str, Any] = {}
        drained: Optional[List[List[Any]]] = None

        def drain() -> List[List[Any]]:
            nonlocal drained
            if drained is None:
                drained = [list(cs) for cs in final.streams]
            return drained

        if keep_token is not None:
            # the (small: loop state, a cache) result resident on the
            # gang, at a MIRRORED capacity: the all-gathered max, pow2
            chunks = [ooc._concat_hchunks(final.schema, frags)
                      for frags in drain()]
            local_max = max([c.n for c in chunks] + [1])
            gmax = int(_host_allgather(
                np.asarray([local_max], np.int64), mesh).max())
            pd = _put_aligned(chunks, final.schema, _pow2(gmax), mesh)
            exec_common._RESIDENT[keep_token] = pd
            extras["resident_capacity"] = pd.capacity

        table = None
        if collect == "count":
            # a streamed count may pass 2**32: (hi, lo) words, as the JAX
            # package carries them
            local = sum(c.n for frags in drain() for c in frags)
            arr = np.asarray([[local >> 32, local & 0xFFFFFFFF]], np.int64)
            allc = _host_allgather(arr, mesh)
            table = int(sum((int(h) << 32) | int(lo)
                            for h, lo in allc.reshape(-1, 2)))
        elif collect:
            merged_out: List[Any] = [c for frags in drain() for c in frags]
            table = chunks_to_table(ooc.ChunkSource(
                lambda: iter(merged_out), final.schema,
                max(final.chunk_rows, 1)))
        if store_path is not None:
            part_chunks = [ooc._concat_hchunks(final.schema, frags)
                           for frags in drain()]
            _write_partitions(store_path, final.schema, part_chunks,
                              list(range(start, start + dpp)), mesh,
                              partitioning=store_partitioning,
                              compression=store_compression,
                              capacity=final.chunk_rows)

        # late stalls: every consumer above has drained by now — emit the
        # per-stage delta beyond what the stage's own stream_stage_done
        # carried (obs/analyze folds prefetch_stall events into the
        # report's totals only, so nothing counts twice)
        for sid, stats, snap in stage_stats:
            late = stats.snapshot()
            d_stalls = late["stalls"] - snap["stalls"]
            if d_stalls > 0:
                ev({"event": "prefetch_stall", "stage": sid,
                    "stalls": d_stalls,
                    "stall_s": round(late["stall_s"] - snap["stall_s"], 6),
                    "chunks": late["chunks"], "late": True})
        extras["stream"] = wave_stats
        return table, extras
    finally:
        shutil.rmtree(job_root, ignore_errors=True)
