"""Host <-> gang plumbing for SPMD jobs, streamed or in memory — the
port of ``dryad_tpu/runtime/stream_cluster.py``.

Used by ``runtime/stream_plan.py`` (the streamed gang runner) and
``runtime/exec_common.py`` (the parallel collect and store output): the
per-rank host all_gather, a wave's chunks placed on this rank's
partitions, a rank's own partitions read back, the parallel partition
writes with rank 0's commit, and the range bounds cut from samples
gathered across the gang (the role of DryadLinqSampler.cs:42).

In a gang (``runtime/exec_common.py``) every worker holds its own
partitions ``[start, start + P_loc)`` of the job's output.  The parallel
collect ships each worker's rows in its reply, and the driver
concatenates them in worker order, which is partition order.  The
parallel store output has every worker write its own partition files
into ``<path>.tmp`` (an ``hdfs://`` target: every worker uploads its own
parts through WebHDFS); one all_gather brings every partition's count
and checksum to rank 0, which writes ``meta.json`` and commits the
rename, and a last all_gather keeps every worker from replying before
the commit — the reference's per-vertex output writers and job-end
commit (DrOutputVertex, DrVertex.h:325-351).  The store is byte for
byte what ``io.store.write_store`` writes for the same partitions.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["StreamJobError", "local_batch_chunks", "_read_local_shards",
           "_write_partitions"]

_SAMPLES_PER_CHUNK = 512
_MAX_SAMPLES = 8192


class StreamJobError(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# host <-> gang plumbing (worker side)


def _host_allgather(arr: np.ndarray, mesh) -> np.ndarray:
    """This rank's host array [k, ...] -> [world, k, ...], every rank's
    in rank order (one ``Mesh.all_gather``; the identity plus a leading
    axis at world 1).  Integers travel as int64 (gloo has no unsigned
    32-bit type) and come back in their own dtype."""
    arr = np.ascontiguousarray(arr)
    if not mesh.gang:
        return arr[None]
    wire = arr.astype(np.float64 if arr.dtype.kind == "f" else np.int64)
    got = mesh.all_gather(torch.from_numpy(wire)).numpy()
    return got.astype(arr.dtype)


def _split_local(chunk, schema, dpp: int, chunk_rows: int):
    """Block-split one host chunk across this rank's ``dpp`` partitions:
    ``(cols [dpp, chunk_rows, ...] zero-padded, counts [dpp])``."""
    n = chunk.n if chunk is not None else 0
    base, rem = divmod(n, dpp)
    sizes = [base + (1 if d < rem else 0) for d in range(dpp)]
    offs = np.cumsum([0] + sizes)
    cols: Dict[str, Any] = {}
    for k, spec in schema.items():
        if spec["kind"] == "str":
            L = spec["max_len"]
            sd = np.zeros((dpp, chunk_rows, L), np.uint8)
            sl = np.zeros((dpp, chunk_rows), np.int32)
            if n:
                d, ln = chunk.cols[k]
                for p in range(dpp):
                    sd[p, :sizes[p]] = d[offs[p]:offs[p + 1]]
                    sl[p, :sizes[p]] = ln[offs[p]:offs[p + 1]]
            cols[k] = (sd, sl)
        else:
            dt = np.dtype(spec["dtype"])
            tail = tuple(spec.get("shape", ()))
            sa = np.zeros((dpp, chunk_rows) + tail, dt)
            if n:
                v = chunk.cols[k]
                for p in range(dpp):
                    sa[p, :sizes[p]] = v[offs[p]:offs[p + 1]]
            cols[k] = sa
    return cols, np.asarray(sizes, np.int32)


def _put_wave(chunk, schema, chunk_rows: int, mesh) -> List[Any]:
    """One rank-local chunk block-split over this rank's partitions: one
    ``chunk_rows``-row Batch per local partition on the mesh's device,
    zero padded (the JAX package fills its addressable shards of the
    global batch; here a rank's partitions are the list it hands an
    exchange)."""
    from dryad_tpu_torch.exec.ooc import HChunk, _chunk_to_batch
    cols, counts = _split_local(chunk, schema, mesh.local_nparts,
                                chunk_rows)
    out = []
    for d, n in enumerate(int(c) for c in counts):
        out.append(_chunk_to_batch(HChunk(
            {k: ((v[0][d, :n], v[1][d, :n]) if isinstance(v, tuple)
                 else v[d, :n]) for k, v in cols.items()}, n),
            chunk_rows, mesh.device))
    return out


def _read_local_shards(pd) -> Tuple[Dict[str, Any], np.ndarray]:
    """This rank's partitions of a PData on the host: ``(columns,
    counts)`` in ``exec.data.pdata_to_numpy``'s layout (a gang rank's
    PData holds only its own partitions, so this is one copy per
    column)."""
    from dryad_tpu_torch.exec.data import pdata_to_numpy
    return pdata_to_numpy(pd)


def local_batch_chunks(cols: Dict[str, Any], counts) -> List[Any]:
    """One trimmed ``exec.ooc.HChunk`` per local partition of
    ``_read_local_shards``' host columns (views, no copies)."""
    from dryad_tpu_torch.exec.ooc import HChunk
    chunks = []
    for p, n in enumerate(int(c) for c in counts):
        chunks.append(HChunk({k: ((v[0][p, :n], v[1][p, :n])
                                  if isinstance(v, tuple) else v[p, :n])
                              for k, v in cols.items()}, n))
    return chunks


def _write_partitions(out_path: str, schema: Dict[str, Any],
                      chunks: Sequence[Any], part_ids: Sequence[int], mesh,
                      partitioning: Optional[Dict[str, Any]] = None,
                      compression: Optional[str] = None,
                      capacity: Optional[int] = None) -> None:
    """Every rank writes its own partitions (``chunks``, store partition
    ``part_ids``) into ``out_path + ".tmp"``; rank 0 merges the meta and
    commits.  Checksums cover the uncompressed segments (the store's read
    contract).

    An ``hdfs://`` target is written the same way: every rank uploads
    its own parts through WebHDFS into the shared temp directory, and
    rank 0 writes the manifest and makes the (atomic) HDFS rename — the
    reference's per-vertex HDFS writers (DrHdfsClient.cpp, write side).
    ``s3://`` is refused: many writers have no atomic commit there."""
    from dryad_tpu_torch.io.fnv import checksum_segments
    from dryad_tpu_torch.io.store import (_part_path, _write_part,
                                          build_meta, chunk_segments,
                                          segments_blob)
    from dryad_tpu_torch.utils.atomic import atomic_write_json
    if compression not in (None, "gzip"):
        raise StreamJobError(f"unknown compression {compression!r}")
    if out_path.startswith("s3://"):
        raise StreamJobError(
            "cluster parallel output to s3:// is not supported (no "
            "atomic multi-object commit across writers); use a shared "
            "filesystem or hdfs:// target")
    hdfs = out_path.startswith("hdfs://")
    if hdfs:
        from dryad_tpu_torch.io.webhdfs import hdfs_client, hdfs_part_path
        hc, hpath = hdfs_client(out_path)
        hpath = hpath.rstrip("/")
        tmp = hpath + ".tmp"
    else:
        tmp = out_path + ".tmp"
    # a stale temp directory of a crashed job must not ride the rename:
    # rank 0 clears it, and the all_gather is the fence
    if mesh.rank == 0:
        if hdfs:
            hc.delete(tmp, recursive=True)
        elif os.path.exists(tmp):
            shutil.rmtree(tmp)
    _host_allgather(np.zeros((1,), np.int32), mesh)
    if hdfs:
        hc.mkdirs(tmp)     # idempotent: every writer may race to make it
    else:
        os.makedirs(tmp, exist_ok=True)
    mine = []
    for g, ch in zip(part_ids, chunks):
        segs = chunk_segments(schema, ch.cols)
        if hdfs:
            hc.create(hdfs_part_path(tmp, g),
                      segments_blob(segs, compression))
        else:
            _write_part((_part_path(tmp, g), segs, compression))
        mine.append((ch.n, checksum_segments(segs)))
    # (count, checksum hi, checksum lo) of every partition, in partition
    # order, doubling as the write barrier
    info = np.asarray([[n, c >> 32, c & 0xFFFFFFFF] for n, c in mine],
                      np.int64).reshape(-1, 3)
    every = _host_allgather(info, mesh).reshape(-1, 3).tolist()
    if mesh.rank == 0:
        meta = build_meta(schema, [int(n) for n, _, _ in every],
                          ["%016x" % ((hi << 32) | lo)
                           for _, hi, lo in every],
                          partitioning=partitioning,
                          compression=compression, capacity=capacity)
        if hdfs:
            hc.create(tmp + "/meta.json",
                      json.dumps(meta, indent=1).encode())
            hc.delete(hpath, recursive=True)
            hc.rename(tmp, hpath)
        else:
            atomic_write_json(os.path.join(tmp, "meta.json"), meta,
                              indent=1)
            if os.path.exists(out_path):
                shutil.rmtree(out_path)
            os.rename(tmp, out_path)
    # no rank replies (or starts the next job's waves) before the commit
    _host_allgather(np.zeros((1,), np.int32), mesh)


# ---------------------------------------------------------------------------
# range bounds across the gang


def _sample_pass(cs, key: Optional[str]):
    """One pass over a local stream: (lane samples, chunks, rows), at
    most ``_SAMPLES_PER_CHUNK`` evenly spread rows a chunk and
    ``_MAX_SAMPLES`` in all.  No samples when ``key`` is None."""
    from dryad_tpu_torch.exec import ooc
    samples: List[np.ndarray] = []
    nchunks = 0
    rows = 0
    for chunk in cs:
        nchunks += 1
        rows += chunk.n
        if key is None or chunk.n == 0:
            continue
        spec = cs.schema[key]
        take = min(chunk.n, _SAMPLES_PER_CHUNK)
        idx = np.linspace(0, chunk.n - 1, take).astype(np.int64)
        col = chunk.cols[key]
        if spec["kind"] == "str":
            lane = ooc._host_sort_lanes(spec, (col[0][idx], col[1][idx]))[0]
        else:
            lane = ooc._host_sort_lanes(spec, col[idx])[0]
        samples.append(lane)
    s = (np.concatenate(samples) if samples
         else np.zeros((0,), np.uint32))
    if len(s) > _MAX_SAMPLES:
        s = s[np.linspace(0, len(s) - 1, _MAX_SAMPLES).astype(np.int64)]
    return s, nchunks, rows


def _gathered_bounds(samples: np.ndarray, mesh, n_buckets: int
                     ) -> np.ndarray:
    """Every rank's samples all-gathered and cut into global quantile
    bounds (``exec.ooc._bounds_from_samples``), bit-equal on every rank
    — the distributed sampling stage (DryadLinqSampler.cs:42,
    DrDynamicRangeDistributor.h:23)."""
    from dryad_tpu_torch.exec import ooc
    padded = np.zeros((_MAX_SAMPLES + 1,), np.uint32)
    padded[0] = len(samples)
    padded[1:1 + len(samples)] = samples
    every = _host_allgather(padded, mesh)          # [world, 1 + SMAX]
    merged = np.concatenate([row[1:1 + int(row[0])] for row in every])
    return ooc._bounds_from_samples(merged, n_buckets)
