"""Partitioned columnar dataset store on the local filesystem — the port
of the local part of ``dryad_tpu/io/store.py``.

Layout (one directory per dataset), the JAX package's byte for byte:

    meta.json        — schema, npartitions, counts, bytes, capacity,
                       partitioning, compression, fnv64 checksums
    part-00000.bin   — partition 0's valid rows, every column in sorted
                       column order (a string column as its data, then
                       its lengths), raw or as one level-1 gzip stream

So either package reads the other's stores: the part files are
identical, and so is ``meta.json`` but for ``native_io``, which names the
checksum engine that ran (the port's is always its C source,
``io/fnv.py``).

On the card a write copies each column's whole ``[P, cap, ...]`` tensor
to the host once and slices the partitions there; a read builds each
column's ``[P, cap, ...]`` array on the host and copies it to the card
once.  Partition files are written, read and checksummed in parallel on
a thread pool (file IO, zlib and the C checksum release the interpreter
lock).

A manifest is append-aware: ``generation`` counts the ``append_store``
commits of a local store, and ``part_generations[p]`` the generation that
added partition p, so an incremental refresh holding watermark W scans
``parts_since(meta, W)`` only.  ``s3://`` paths go to ``io/s3_store.py``
(the same layout as objects, committed by writing ``meta.json`` last) and
``hdfs://`` paths to ``io/webhdfs.py`` (committed by a rename); both
append nothing.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import shutil
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dryad_tpu_torch.data.columnar import StringColumn
from dryad_tpu_torch.exec.data import PData, _local_parts, \
    pdata_from_numpy, pdata_to_numpy
from dryad_tpu_torch.io.fnv import checksum_segments
from dryad_tpu_torch.utils.atomic import atomic_write_json

__all__ = ["write_store", "read_store", "store_meta", "build_meta",
           "schema_row_bytes", "pdata_schema", "chunk_segments",
           "segments_blob", "fill_segments", "verify_checksums",
           "StoreIntegrityError", "is_remote_store",
           "remote_read_part_views", "append_store", "store_generation",
           "parts_since", "pdata_part_segments"]

_FORMAT_VERSION = 3
_REMOTE_SCHEMES = ("s3://", "hdfs://")
# the checksum engine recorded in meta.json's native_io
_ENGINE = "dryad_tpu_torch host_fnv.c"
_IO_THREADS = 8


class StoreIntegrityError(RuntimeError):
    """A partition file's content does not match its recorded checksum
    (fnv64 chained over the partition's segments)."""


def is_remote_store(path: str) -> bool:
    """True for a store served by a remote adapter (``s3://`` objects,
    ``hdfs://`` WebHDFS) rather than the local filesystem."""
    return path.startswith(_REMOTE_SCHEMES)


def remote_read_part_views(path: str, meta: Dict[str, Any], p: int):
    """(segments, column views) of one remote partition, as
    ``_alloc_part`` gives them, filled: the building block of
    ``read_store`` and ``ooc.ChunkSource.from_store``."""
    if path.startswith("s3://"):
        from dryad_tpu_torch.io.s3_store import s3_read_part_views
        return s3_read_part_views(path, meta, p)
    from dryad_tpu_torch.io.webhdfs import hdfs_read_part_views
    return hdfs_read_part_views(path, meta, p)


def _part_path(path: str, p: int) -> str:
    return os.path.join(path, f"part-{p:05d}.bin")


def _parallel(fn: Callable, items: Sequence) -> list:
    """``fn`` over ``items`` on the IO thread pool, in order; every
    exception is raised."""
    if len(items) <= 1:
        return [fn(x) for x in items]
    with concurrent.futures.ThreadPoolExecutor(
            max_workers=min(_IO_THREADS, len(items))) as pool:
        return list(pool.map(fn, items))


def schema_row_bytes(schema: Dict[str, Any]) -> int:
    """Uncompressed payload bytes of ONE row under a store schema (a
    string column: max_len data bytes + a 4-byte length)."""
    total = 0
    for spec in schema.values():
        if spec["kind"] == "str":
            total += int(spec["max_len"]) + 4
        else:
            total += (np.dtype(spec["dtype"]).itemsize
                      * int(np.prod(spec.get("shape", ()), dtype=np.int64)))
    return total


def build_meta(schema: Dict[str, Any], counts: List[int],
               checksums: List[str],
               partitioning: Optional[Dict[str, Any]] = None,
               compression: Optional[str] = None,
               capacity: Optional[int] = None,
               generation: int = 0,
               part_generations: Optional[List[int]] = None
               ) -> Dict[str, Any]:
    """The meta.json of a store, key for key the JAX package's.  A fresh
    write is generation 0; ``append_store`` passes the bumped generation
    and the generation that added each partition."""
    rb = schema_row_bytes(schema)
    return {
        "format_version": _FORMAT_VERSION,
        "npartitions": len(counts),
        "counts": list(counts),
        "bytes": [int(c) * rb for c in counts],
        "capacity": capacity if capacity is not None
        else max(list(counts) or [1]),
        "schema": schema,
        "partitioning": partitioning or {"kind": "none"},
        "compression": compression,
        "checksum_algo": "fnv64",
        "checksums": checksums,
        "native_io": _ENGINE,
        "generation": int(generation),
        "part_generations": (list(part_generations)
                             if part_generations is not None
                             else [0] * len(counts)),
    }


def store_generation(meta: Dict[str, Any]) -> int:
    """The append watermark of a manifest (0 for a store written before
    the field existed: it was never appended to)."""
    return int(meta.get("generation", 0))


def parts_since(meta: Dict[str, Any], watermark: int) -> List[int]:
    """Store partitions committed AFTER ``watermark``: the delta an
    incremental refresh scans.  ``-1`` (no state yet) gives every
    partition, ``store_generation(meta)`` none."""
    gens = meta.get("part_generations") or [0] * int(meta["npartitions"])
    return [p for p, g in enumerate(gens) if int(g) > watermark]


def _col_order(schema: Dict[str, Any]) -> List[str]:
    return sorted(schema.keys())


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def pdata_schema(pd: PData) -> Dict[str, Any]:
    """Store schema of a PData's columns, in their order."""
    schema: Dict[str, Any] = {}
    for k, v in pd.batch.columns.items():
        if isinstance(v, StringColumn):
            schema[k] = {"kind": "str", "max_len": int(v.data.shape[2])}
        else:
            schema[k] = {"kind": "dense", "dtype": _np_dtype(v.dtype).name,
                         "shape": list(v.shape[2:])}
    return schema


def chunk_segments(schema: Dict[str, Any],
                   cols: Dict[str, Any]) -> List[np.ndarray]:
    """One partition's host column segments in file order (sorted
    columns; a string column as (data, lengths))."""
    segs: List[np.ndarray] = []
    for k in _col_order(schema):
        v = cols[k]
        if schema[k]["kind"] == "str":
            segs.append(np.ascontiguousarray(v[0]))
            segs.append(np.ascontiguousarray(v[1]))
        else:
            segs.append(np.ascontiguousarray(v))
    return segs


def segments_blob(segs: Sequence[np.ndarray],
                  compression: Optional[str]) -> bytes:
    """A partition's segments as one part file's bytes: concatenated, or
    one level-1 gzip stream with a zero mtime (the bytes the JAX
    package's native engine writes)."""
    raw = [_raw(np.ascontiguousarray(s)) for s in segs]
    if compression != "gzip":
        return b"".join(raw)
    z = zlib.compressobj(1, zlib.DEFLATED, 31)
    return b"".join([z.compress(r) for r in raw] + [z.flush()])


def fill_segments(segs: Sequence[np.ndarray], data: bytes,
                  what: str) -> None:
    """Fill preallocated segments from one (decompressed) blob, the
    inverse of ``segments_blob``; the size is checked first."""
    expected = sum(s.nbytes for s in segs)
    if expected != len(data):
        raise IOError(f"partition size mismatch: expected {expected} "
                      f"bytes, {what} holds {len(data)}")
    off = 0
    for s in segs:
        nb = s.nbytes
        s.reshape(-1)[:] = np.frombuffer(data, dtype=s.dtype, count=s.size,
                                         offset=off)
        off += nb


def _raw(s: np.ndarray) -> np.ndarray:
    """A contiguous array's bytes as a flat uint8 view (for file IO)."""
    return s.reshape(-1).view(np.uint8)


def _write_part(job: Tuple[str, List[np.ndarray], Optional[str]]) -> None:
    path, segs, compression = job
    with open(path, "wb") as f:
        f.write(segments_blob(segs, compression))


def _read_part(job: Tuple[str, List[np.ndarray], Optional[str]]) -> None:
    path, segs, compression = job
    with open(path, "rb") as f:
        data = f.read()
    if compression == "gzip":
        data = zlib.decompress(data, wbits=31)
    fill_segments(segs, data, path)


def _host_rows(v, p: int, n: int):
    """Partition p's first n rows of a host column ((data, lengths) for a
    string column): views, no copies."""
    if isinstance(v, tuple):
        return v[0][p, :n], v[1][p, :n]
    return v[p, :n]


def pdata_part_segments(pd: PData, schema: Dict[str, Any]
                        ) -> Tuple[List[List[np.ndarray]], List[int]]:
    """Each partition's valid rows as file-order segments, and the
    counts: one device-to-host copy per column, then host views."""
    cols, counts = pdata_to_numpy(pd)
    counts = [int(n) for n in counts]
    return [chunk_segments(schema, {k: _host_rows(v, p, n)
                                    for k, v in cols.items()})
            for p, n in enumerate(counts)], counts


def write_store(path: str, pd: PData,
                partitioning: Optional[Dict[str, Any]] = None,
                compression: Optional[str] = None) -> None:
    """Persist a PData (ToStore), committed atomically: the store is
    written into ``path + ".tmp"`` and renamed into place.
    ``compression="gzip"`` writes level-1 gzip part files; the checksums
    are over the uncompressed segments."""
    if compression not in (None, "gzip"):
        raise ValueError(f"unknown compression {compression!r}")
    if path.startswith("s3://"):
        from dryad_tpu_torch.io.s3_store import s3_write_store
        return s3_write_store(path, pd, partitioning=partitioning,
                              compression=compression)
    if path.startswith("hdfs://"):
        from dryad_tpu_torch.io.webhdfs import hdfs_write_store
        return hdfs_write_store(path, pd, partitioning=partitioning,
                                compression=compression)
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    schema = pdata_schema(pd)
    segments, counts = pdata_part_segments(pd, schema)
    _parallel(_write_part, [(_part_path(tmp, p), segs, compression)
                            for p, segs in enumerate(segments)])
    checksums = ["%016x" % c for c in _parallel(checksum_segments,
                                                segments)]
    meta = build_meta(schema, counts, checksums,
                      partitioning=partitioning, compression=compression,
                      capacity=pd.capacity)
    atomic_write_json(os.path.join(tmp, "meta.json"), meta, indent=1)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)


def append_store(path: str, pd: PData) -> int:
    """Append a PData to an EXISTING local store as a new generation;
    returns the committed generation.

    The non-empty partitions land as part files past the current
    ``npartitions`` under their final names, then ONE atomic replace of
    ``meta.json`` publishes the extended manifest at ``generation + 1``:
    a crash before it leaves orphan part files that no manifest names
    (a retry overwrites them), so no reader or watermark sees a torn
    append.  The schema must equal the store's (string widths too); a
    hash or range claim drops to ``none``, as the appended rows were not
    placed."""
    if is_remote_store(path):
        raise NotImplementedError(
            "append_store supports local stores only (remote adapters "
            "commit whole stores; re-write via write_store)")
    meta = store_meta(path)
    schema = pdata_schema(pd)
    if schema != meta["schema"]:
        raise ValueError(
            f"append schema mismatch for {path}: store has "
            f"{meta['schema']}, appended data has {schema}")
    compression = meta.get("compression")
    base = int(meta["npartitions"])
    segments, counts = pdata_part_segments(pd, schema)
    # empty partitions would lengthen the manifest forever
    kept = [(segs, n) for segs, n in zip(segments, counts) if n]
    if not kept:
        return store_generation(meta)
    segments = [segs for segs, _ in kept]
    new_counts = [n for _, n in kept]
    _parallel(_write_part, [(_part_path(path, base + i), segs, compression)
                            for i, segs in enumerate(segments)])
    checksums = ["%016x" % c for c in _parallel(checksum_segments,
                                                segments)]
    gen = store_generation(meta) + 1
    gens = list(meta.get("part_generations") or [0] * base)
    part = meta.get("partitioning") or {"kind": "none"}
    new_meta = build_meta(
        meta["schema"], list(meta["counts"]) + new_counts,
        list(meta.get("checksums") or []) + checksums,
        partitioning=part if part.get("kind") == "none"
        else {"kind": "none"},
        compression=compression,
        capacity=max(int(meta.get("capacity", 1)), max(new_counts)),
        generation=gen,
        part_generations=gens + [gen] * len(new_counts))
    atomic_write_json(os.path.join(path, "meta.json"), new_meta, indent=1)
    return gen


def store_meta(path: str) -> Dict[str, Any]:
    if path.startswith("s3://"):
        from dryad_tpu_torch.io.s3_store import s3_store_meta
        return s3_store_meta(path)
    if path.startswith("hdfs://"):
        from dryad_tpu_torch.io.webhdfs import hdfs_store_meta
        return hdfs_store_meta(path)
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)


def verify_checksums(path: str, meta: Dict[str, Any],
                     segments: List[List[np.ndarray]],
                     partitions: Optional[Sequence[int]] = None) -> None:
    """Hold freshly read partitions to their recorded fnv64 checksums;
    raise StoreIntegrityError naming the first partition that differs.
    ``segments[i]`` is partition ``partitions[i]`` (default: partition
    i).  A store without checksums (before format 3) is accepted as
    is."""
    recorded = meta.get("checksums")
    if not recorded:
        return
    got = ["%016x" % c for c in _parallel(checksum_segments, segments)]
    ids = range(len(got)) if partitions is None else partitions
    for p, g in zip(ids, got):
        r = recorded[p]
        if g != r:
            raise StoreIntegrityError(
                f"partition {p} of {path}: checksum {g} != recorded {r} — "
                f"file corrupted or tampered")


def _alloc_part(schema: Dict[str, Any], n: int
                ) -> Tuple[List[np.ndarray], Dict[str, Any]]:
    """One partition's n rows, allocated per column in file order:
    (segments, name -> array or (data, lengths))."""
    segs: List[np.ndarray] = []
    cols: Dict[str, Any] = {}
    for k in _col_order(schema):
        spec = schema[k]
        if spec["kind"] == "str":
            d = np.empty((n, spec["max_len"]), np.uint8)
            ln = np.empty((n,), np.int32)
            segs.extend([d, ln])
            cols[k] = (d, ln)
        else:
            a = np.empty((n,) + tuple(spec["shape"]),
                         np.dtype(spec["dtype"]))
            segs.append(a)
            cols[k] = a
    return segs, cols


def _stack(schema: Dict[str, Any], parts: List[Dict[str, Any]],
           counts: List[int], cap: int) -> Dict[str, Any]:
    """Per-partition host rows -> ``[P, cap, ...]`` host columns (zero
    padding), in the schema's column order."""
    P = len(parts)
    out: Dict[str, Any] = {}
    for k, spec in schema.items():
        if spec["kind"] == "str":
            sd = np.zeros((P, cap, spec["max_len"]), np.uint8)
            sl = np.zeros((P, cap), np.int32)
            for p in range(P):
                sd[p, :counts[p]], sl[p, :counts[p]] = parts[p][k]
            out[k] = (sd, sl)
        else:
            a = np.zeros((P, cap) + tuple(spec["shape"]),
                         np.dtype(spec["dtype"]))
            for p in range(P):
                a[p, :counts[p]] = parts[p][k]
            out[k] = a
    return out


def read_store(path: str, mesh, capacity: Optional[int] = None,
               partitions: Optional[Sequence[int]] = None,
               verify: bool = True) -> PData:
    """Load a store as a PData on the mesh's device (FromStore).

    When the partitions read are as many as the mesh's, store partition
    p becomes partition p VERBATIM, so a persisted hash or range
    placement stays true (``Context.from_store`` keeps the claim then).
    Otherwise the rows are concatenated and re-blocked evenly, and the
    claim is dropped.  ``partitions`` reads only those store partitions
    (an incremental refresh's delta).  A gang rank (``parallel/mesh.py``)
    gets only its own partitions, at the capacity the whole mesh's read
    gives them: the store's own ones verbatim, or its blocks of the
    re-blocked rows."""
    meta = store_meta(path)
    schema = meta["schema"]
    part_ids = (list(range(int(meta["npartitions"]))) if partitions is None
                else list(partitions))
    counts = [int(meta["counts"][p]) for p in part_ids]
    nparts = mesh.nparts
    local = _local_parts(mesh)
    verbatim = len(counts) == nparts
    if verbatim:
        cap = capacity or max(int(meta.get("capacity", 0)),
                              max(counts or [0]), 1)
        part_ids = [part_ids[g] for g in local]
        counts = [counts[g] for g in local]
    if is_remote_store(path):
        views = _parallel(lambda p: remote_read_part_views(path, meta, p),
                          part_ids)
        segments = [segs for segs, _ in views]
        parts = [cols for _, cols in views]
    else:
        segments, parts = [], []
        for n in counts:
            segs, cols = _alloc_part(schema, n)
            segments.append(segs)
            parts.append(cols)
        comp = meta.get("compression")
        _parallel(_read_part, [(_part_path(path, p), segs, comp)
                               for p, segs in zip(part_ids, segments)])
    if verify:
        verify_checksums(path, meta, segments, partitions=part_ids)
    if verbatim:
        if cap < max(counts or [0]):
            raise ValueError(f"capacity {cap} < max partition count "
                             f"{max(counts)}")
        return pdata_from_numpy(_stack(schema, parts, counts, cap),
                                np.asarray(counts, np.int32), mesh.device)
    # another partition count: concatenate, then re-block evenly
    total = sum(counts)
    base, rem = divmod(total, nparts)
    sizes = [base + (1 if p < rem else 0) for p in range(nparts)]
    offs = np.cumsum([0] + sizes)
    cap = capacity or max(1, max(sizes))
    sizes = [sizes[g] for g in local]
    if cap < max(sizes):
        raise ValueError(f"capacity {cap} < max partition count "
                         f"{max(sizes)}")
    concat: Dict[str, Any] = {}
    for k, spec in schema.items():
        if spec["kind"] == "str":
            concat[k] = (np.concatenate([c[k][0] for c in parts]),
                         np.concatenate([c[k][1] for c in parts]))
        else:
            concat[k] = np.concatenate([c[k] for c in parts])
    blocks = [{k: ((v[0][offs[p]:offs[p + 1]], v[1][offs[p]:offs[p + 1]])
                   if isinstance(v, tuple) else v[offs[p]:offs[p + 1]])
               for k, v in concat.items()} for p in local]
    return pdata_from_numpy(_stack(schema, blocks, sizes, cap),
                            np.asarray(sizes, np.int32), mesh.device)
