"""A gang rank's own partitions on the host, and the parallel store
output — the first part of the port of ``dryad_tpu/runtime/
stream_cluster.py`` (its ``local_batch_chunks``, ``_read_local_shards``
and ``_write_partitions``).

In a gang (``runtime/exec_common.py``) every worker holds its own
partitions ``[start, start + P_loc)`` of the job's output.  The parallel
collect ships each worker's rows in its reply, and the driver
concatenates them in worker order, which is partition order.  The
parallel store output has every worker write its own partition files
into ``<path>.tmp``; one all_gather brings every partition's count and
checksum to rank 0, which writes ``meta.json`` and commits the rename,
and a last all_gather keeps every worker from replying before the
commit — the reference's per-vertex output writers and job-end commit
(DrOutputVertex, DrVertex.h:325-351).  The store is byte for byte what
``io.store.write_store`` writes for the same partitions.

The streamed half of the JAX module (chunk waves over streamed sources
across the gang) is ROADMAP Queue 1 item 11b.6.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["local_batch_chunks", "_read_local_shards", "_write_partitions"]


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
    contract).  Only local paths: a remote store's commit across
    writers is ROADMAP Queue 1 item 11b.6."""
    from dryad_tpu_torch.io.fnv import checksum_segments
    from dryad_tpu_torch.io.store import (_part_path, _write_part,
                                          build_meta, chunk_segments)
    from dryad_tpu_torch.utils.atomic import atomic_write_json
    if compression not in (None, "gzip"):
        raise ValueError(f"unknown compression {compression!r}")
    if "://" in out_path:
        raise ValueError(
            f"gang parallel output to {out_path!r}: a remote store's "
            f"commit across writers comes with ROADMAP Queue 1 item 11b.6; "
            f"write to a shared local path")
    tmp = out_path + ".tmp"
    # a stale temp directory of a crashed job must not ride the rename:
    # rank 0 clears it, and the all_gather is the fence
    if mesh.rank == 0 and os.path.exists(tmp):
        shutil.rmtree(tmp)
    mesh.all_gather(torch.zeros(1, dtype=torch.int32))
    os.makedirs(tmp, exist_ok=True)
    mine = []
    for g, ch in zip(part_ids, chunks):
        segs = chunk_segments(schema, ch.cols)
        _write_part((_part_path(tmp, g), segs, compression))
        mine.append((ch.n, checksum_segments(segs)))
    # (count, checksum hi, checksum lo) of every partition, in partition
    # order, doubling as the write barrier
    info = torch.tensor([[n, c >> 32, c & 0xFFFFFFFF] for n, c in mine],
                        dtype=torch.int64)
    every = mesh.all_gather(info).reshape(-1, 3).tolist()
    if mesh.rank == 0:
        meta = build_meta(schema, [int(n) for n, _, _ in every],
                          ["%016x" % ((hi << 32) | lo)
                           for _, hi, lo in every],
                          partitioning=partitioning,
                          compression=compression, capacity=capacity)
        atomic_write_json(os.path.join(tmp, "meta.json"), meta, indent=1)
        if os.path.exists(out_path):
            shutil.rmtree(out_path)
        os.rename(tmp, out_path)
    # no rank replies before the commit
    mesh.all_gather(torch.zeros(1, dtype=torch.int32))
