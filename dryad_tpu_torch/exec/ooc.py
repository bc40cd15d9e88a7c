"""Out-of-core chunked execution: device <-> host memory <-> disk streaming
— the port of ``dryad_tpu/exec/ooc.py``.

A dataset too large for the device lives in host memory (or a store on
disk) as a stream of CHUNKS, and only a few chunks are on the device at a
time:

* ``ChunkSource`` is a re-iterable stream of host chunks (``HChunk``:
  numpy columns, a string column as a ``(data [n, L] u8, lengths [n]
  i32)`` pair) from host arrays, a store, text files or a generator;
* ``stream_through`` moves each chunk to the device, runs a function on
  it and keeps up to ``depth`` chunks in flight; ``prefetch_iter`` reads
  the next chunks on a background thread meanwhile (host work only: the
  thread touches no CUDA state);
* an exchange becomes a per-chunk bucket scatter on the device (a range
  or hash bucket per row, the rows grouped by a stable sort, the bucket
  sizes from ``hopper_kernels.hist_buckets``) followed by accumulation of
  each bucket's rows on the host, in memory or in spill files;
* the merge phases (``external_sort``, the streamed group-bys,
  ``streaming_distinct``) work bucket by bucket, recursing or compacting
  on the device until a bucket fits one chunk.

The device holds O(chunk_rows) rows whatever the data size.  One device
per stream: the Context's, or ``device=`` (CUDA unless the caller asks
for the CPU).  The JAX package's compiled-program memos (``fifo_memo``,
``_GROUP_FNS_CACHE``, the ``lru_cache``'d ``_make_*_fn``) have no
counterpart: nothing here is compiled.  ``transfers`` counts the bytes
and chunks every host <-> device copy of this module moves.

The re-streaming cache tier at the end (``cache_source`` and its
helpers) is ``Dataset.cache()``'s store-backed form for streamed data.
Stores may be local, ``s3://`` or ``hdfs://`` (``io/store.py``'s
dispatch); text may be local, ``http://``, ``s3://`` or ``hdfs://``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import queue as _queue
import shutil
import threading
import time
from collections import deque
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from dryad_tpu_torch.data.columnar import Batch, StringColumn, _as_bytes, \
    pack_bytes_list, pack_lines
from dryad_tpu_torch.io.fnv import checksum_segments
from dryad_tpu_torch.io.store import _alloc_part, _part_path, _read_part, \
    _write_part, build_meta, chunk_segments, is_remote_store, \
    remote_read_part_views, schema_row_bytes, store_meta, verify_checksums
from dryad_tpu_torch.ops import hopper_kernels as hk
from dryad_tpu_torch.ops import kernels
from dryad_tpu_torch.ops.hashing import hash_batch_keys
from dryad_tpu_torch.parallel.mesh import resolve_device
from dryad_tpu_torch.parallel.shuffle import range_dest_lane
from dryad_tpu_torch.utils.atomic import atomic_write_json
from dryad_tpu_torch.utils.config import JobConfig

__all__ = [
    "HChunk", "ChunkSource", "stream_through", "stream_map",
    "external_sort", "streaming_group_aggregate", "streaming_group_whole",
    "streaming_group_decomposable", "streaming_group_topk",
    "streaming_distinct", "write_chunks_to_store", "OOCError",
    "PrefetchStats", "prefetch_iter", "transfers", "reset_transfers",
    "cache_entry_paths", "cached_chunk_source", "write_chunk_cache",
    "adopt_chunk_cache", "invalidate_cache_entry", "cache_source",
]


class OOCError(RuntimeError):
    pass


# bytes and chunks copied host -> device and device -> host by
# _chunk_to_batch / _batch_to_chunk (the streamed path's copies), since
# the last reset_transfers()
transfers = {"h2d_bytes": 0, "h2d_chunks": 0, "d2h_bytes": 0,
             "d2h_chunks": 0}


def reset_transfers() -> None:
    for k in transfers:
        transfers[k] = 0


# ---------------------------------------------------------------------------
# host chunk representation

# a host column is a dense ndarray [n, ...] or a (data [n, L] u8,
# lengths [n] i32) pair for strings
HostCol = Any


@dataclasses.dataclass
class HChunk:
    """One host-resident chunk of rows (trimmed: no padding)."""

    cols: Dict[str, HostCol]
    n: int

    @staticmethod
    def empty_like(schema: Dict[str, Any]) -> "HChunk":
        cols: Dict[str, HostCol] = {}
        for k, spec in schema.items():
            if spec["kind"] == "str":
                cols[k] = (np.zeros((0, spec["max_len"]), np.uint8),
                           np.zeros((0,), np.int32))
            else:
                cols[k] = np.zeros((0,) + tuple(spec.get("shape", ())),
                                   np.dtype(spec["dtype"]))
        return HChunk(cols, 0)


def chunk_schema(chunk: HChunk) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in chunk.cols.items():
        if isinstance(v, tuple):
            out[k] = {"kind": "str", "max_len": int(v[0].shape[1])}
        else:
            out[k] = {"kind": "dense", "dtype": v.dtype.name,
                      "shape": list(v.shape[1:])}
    return out


def _concat_hchunks(schema, frags: Sequence[HChunk]) -> HChunk:
    if not frags:
        return HChunk.empty_like(schema)
    if len(frags) == 1:
        return frags[0]
    cols: Dict[str, HostCol] = {}
    for k, spec in schema.items():
        if spec["kind"] == "str":
            cols[k] = (np.concatenate([f.cols[k][0] for f in frags]),
                       np.concatenate([f.cols[k][1] for f in frags]))
        else:
            cols[k] = np.concatenate([f.cols[k] for f in frags])
    return HChunk(cols, sum(f.n for f in frags))


def _slice_hchunk(chunk: HChunk, s: int, e: int) -> HChunk:
    cols = {k: ((v[0][s:e], v[1][s:e]) if isinstance(v, tuple) else v[s:e])
            for k, v in chunk.cols.items()}
    return HChunk(cols, e - s)


def _to_device(a: np.ndarray, capacity: int, device) -> torch.Tensor:
    """[capacity, ...] on ``device``: ``a``'s rows, then zero rows."""
    n = a.shape[0]
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:          # e.g. np.frombuffer of a file read
        a = a.copy()
    t = torch.from_numpy(a)
    if n == capacity:
        out = t.to(device)
    else:
        out = torch.empty((capacity,) + tuple(a.shape[1:]), dtype=t.dtype,
                          device=device)
        out[:n].copy_(t)
        out[n:].zero_()
    transfers["h2d_bytes"] += a.nbytes
    return out


def _chunk_to_batch(chunk: HChunk, capacity: int, device) -> Batch:
    """A host chunk as a ``capacity``-row Batch on ``device`` (the chunk's
    rows copied to the device, zero padding after them)."""
    if chunk.n > capacity:
        raise OOCError(f"chunk of {chunk.n} rows > capacity {capacity}")
    cols: Dict[str, Any] = {}
    for k, v in chunk.cols.items():
        if isinstance(v, tuple):
            cols[k] = StringColumn(_to_device(v[0], capacity, device),
                                   _to_device(v[1], capacity, device))
        else:
            cols[k] = _to_device(v, capacity, device)
    transfers["h2d_chunks"] += 1
    return Batch(cols, torch.tensor(chunk.n, dtype=torch.int32,
                                    device=device))


def _to_host(t: torch.Tensor, n: int) -> np.ndarray:
    a = t[:n].cpu().numpy()
    transfers["d2h_bytes"] += a.nbytes
    return a


def _batch_to_chunk(batch: Batch) -> HChunk:
    """A device Batch's valid rows on the host: the count read first,
    then exactly ``count`` rows of each column copied back (a slice of a
    tensor is free, so the JAX package's pow2 slice program has no
    counterpart)."""
    n = int(batch.count)
    cols: Dict[str, HostCol] = {}
    for k, v in batch.columns.items():
        if isinstance(v, StringColumn):
            cols[k] = (_to_host(v.data, n), _to_host(v.lengths, n))
        else:
            cols[k] = _to_host(v, n)
    transfers["d2h_chunks"] += 1
    return HChunk(cols, n)


# ---------------------------------------------------------------------------
# chunk sources


class ChunkSource:
    """A re-iterable stream of HChunks with a fixed schema.

    Callers iterate it several times (a sampling pass, then a scatter
    pass), so ``make_iter`` must return a fresh iterator per call.
    ``on_host`` says that the chunks are made by host work alone (reads,
    unpacking, a generator): only such a source is read ahead on the
    prefetch thread, which must touch no CUDA state; a source whose
    chunks come off the device is read in the consumer's thread."""

    def __init__(self, make_iter: Callable[[], Iterator[HChunk]],
                 schema: Dict[str, Any], chunk_rows: int,
                 on_host: bool = True):
        self._make_iter = make_iter
        self.schema = schema
        self.chunk_rows = chunk_rows
        self.on_host = on_host
        # restart-stable content identity of the SOURCE data, when one
        # exists (stores and text files set it): the re-streaming cache
        # folds it into its keys, so changed source data never serves a
        # stale entry
        self.fingerprint: Optional[str] = None

    def __iter__(self) -> Iterator[HChunk]:
        return self._make_iter()

    # -- constructors ------------------------------------------------------

    @staticmethod
    def from_arrays(columns: Dict[str, Any], chunk_rows: int | None = None,
                    str_max_len: int = 64) -> "ChunkSource":
        """Slice host arrays (dense ndarrays, or lists of str / bytes
        packed as strings of at most ``str_max_len`` bytes) into
        chunks."""
        if chunk_rows is None:
            chunk_rows = JobConfig().ooc_chunk_rows
        conv: Dict[str, HostCol] = {}
        n = None
        for k, v in columns.items():
            if isinstance(v, (list, tuple)):
                conv[k] = pack_bytes_list(_as_bytes(v), str_max_len, len(v))
                n = len(v)
            else:
                arr = np.asarray(v)
                conv[k] = arr
                n = len(arr)
        return ChunkSource.from_chunk(HChunk(conv, n or 0), chunk_rows)

    @staticmethod
    def from_chunk(whole: HChunk, chunk_rows: int) -> "ChunkSource":
        """Slice one host chunk into chunks of ``chunk_rows`` rows (an
        empty one gives one empty chunk, which carries the schema)."""

        def it():
            for s in range(0, max(whole.n, 1), chunk_rows):
                e = min(s + chunk_rows, whole.n)
                if e > s or whole.n == 0:
                    yield _slice_hchunk(whole, s, e)
                if whole.n == 0:
                    return

        return ChunkSource(it, chunk_schema(whole), chunk_rows)

    # an uncompressed hdfs:// partition of at least this many bytes
    # streams by ranged reads (unverified) instead of the verified
    # whole-part read: anything that fits host memory comfortably keeps
    # its checksum
    RANGED_STREAM_MIN_BYTES = 256 << 20

    @staticmethod
    def from_store(path: str, chunk_rows: int,
                   partitions: Optional[Sequence[int]] = None
                   ) -> "ChunkSource":
        """Stream a store (``io/store.py`` layout, written by either
        package; local, ``s3://`` or ``hdfs://``) partition by partition,
        each checksummed when read and sliced into chunks: a partition
        must fit host memory, the store need not.  The exception is an
        uncompressed ``hdfs://`` partition past
        ``RANGED_STREAM_MIN_BYTES``: it streams by one ranged read per
        column segment per chunk, so it need not fit either, and its
        checksum (over whole segments) goes unverified.  A remote
        partition's read is issued again on a transient failure
        (``io/providers.retry_transient``).  ``partitions`` restricts to
        those store partitions."""
        meta = store_meta(path)
        schema = meta["schema"]
        part_ids = (list(range(meta["npartitions"]))
                    if partitions is None else list(partitions))
        comp = meta.get("compression")
        ranged = set()
        if path.startswith("hdfs://") and comp != "gzip":
            rb = schema_row_bytes(schema)
            ranged = {p for p in part_ids if int(meta["counts"][p]) * rb
                      >= ChunkSource.RANGED_STREAM_MIN_BYTES}

        def it():
            for p in part_ids:
                cnt = int(meta["counts"][p])
                if p in ranged:
                    from dryad_tpu_torch.io.webhdfs import hdfs_part_chunks
                    for cols, n in hdfs_part_chunks(path, meta, p,
                                                    chunk_rows):
                        yield HChunk(cols, n)
                    continue
                if is_remote_store(path):
                    # the provider clients retry each request already:
                    # two more tries of the whole part bound the stack
                    from dryad_tpu_torch.io.providers import retry_transient
                    segs, cols = retry_transient(
                        lambda p=p: remote_read_part_views(path, meta, p),
                        what=f"remote part {p} of {path}", retries=2)
                else:
                    segs, cols = _alloc_part(schema, cnt)
                    _read_part((_part_path(path, p), segs, comp))
                verify_checksums(path, meta, [segs], partitions=[p])
                whole = HChunk(cols, cnt)
                for s in range(0, cnt, chunk_rows):
                    yield _slice_hchunk(whole, s, min(s + chunk_rows, cnt))

        src = ChunkSource(it, schema, chunk_rows)
        src.fingerprint = hashlib.sha256(repr(
            ("store", path, meta.get("counts"), meta.get("checksums"),
             sorted(part_ids))).encode()).hexdigest()
        return src

    @staticmethod
    def from_text(paths, chunk_rows: int, max_line_len: int = 256,
                  column: str = "line") -> "ChunkSource":
        """Stream text files line by line, ``chunk_rows`` lines a chunk,
        4 MB of a file in memory at a time (``pack_lines`` on each
        block's whole lines: split on b"\\n", a trailing b"\\r" trimmed,
        lines cut at ``max_line_len``).  A trailing unterminated line
        counts.  A ``http://``, ``s3://`` or ``hdfs://`` path arrives by
        ranged reads of the same 4 MB (``io/providers.open_blocks``)."""
        from dryad_tpu_torch.io.providers import open_blocks
        paths = [paths] if isinstance(paths, str) else list(paths)
        schema = {column: {"kind": "str", "max_len": max_line_len}}

        def it():
            pend: List[Tuple[np.ndarray, np.ndarray]] = []
            have = 0

            def take(n):
                nonlocal pend, have
                d = np.concatenate([x for x, _ in pend])
                ln = np.concatenate([y for _, y in pend])
                pend = [(d[n:], ln[n:])] if d.shape[0] > n else []
                have = d.shape[0] - n
                return HChunk({column: (d[:n], ln[:n])}, n)

            for path in paths:
                rem = b""
                for blk in open_blocks(path, 1 << 22):
                    cut = blk.rfind(b"\n")
                    if cut < 0:
                        rem += blk
                        continue
                    d, ln = pack_lines(rem + blk[:cut + 1], max_line_len)
                    rem = blk[cut + 1:]
                    pend.append((d, ln))
                    have += d.shape[0]
                    while have >= chunk_rows:
                        yield take(chunk_rows)
                if rem:
                    d, ln = pack_lines(rem, max_line_len)
                    pend.append((d, ln))
                    have += d.shape[0]
            while have:
                yield take(min(have, chunk_rows))

        src = ChunkSource(it, schema, chunk_rows)
        try:
            # nanosecond mtime: a same-second same-size rewrite must
            # change the key
            sig = [(p, os.path.getsize(p), os.stat(p).st_mtime_ns)
                   for p in paths]
            src.fingerprint = hashlib.sha256(
                repr(("text", sig, max_line_len, column)).encode()
            ).hexdigest()
        except OSError:
            pass
        return src

    @staticmethod
    def from_generator(gen: Callable[[int], Dict[str, Any]], n_chunks: int,
                       chunk_rows: int, str_max_len: int = 64
                       ) -> "ChunkSource":
        """Chunks made on the fly: ``gen(i)`` -> a column dict (how inputs
        larger than host memory are produced without holding them)."""
        first = ChunkSource.from_arrays(gen(0), chunk_rows, str_max_len)

        def it():
            for i in range(n_chunks):
                yield from ChunkSource.from_arrays(gen(i), chunk_rows,
                                                   str_max_len)

        return ChunkSource(it, first.schema, chunk_rows)


# ---------------------------------------------------------------------------
# host read-ahead on a background thread


class PrefetchStats:
    """Thread-safe per-job counters of the prefetch pipeline.  ``stalls``
    counts the times the consumer WAITED for the producer thread (the
    queue was empty while the producer still ran), ``stall_s`` sums the
    waits; the wait for the very first chunk is not a stall."""

    def __init__(self):
        self._lock = threading.Lock()
        self.stalls = 0
        self.stall_s = 0.0
        self.chunks = 0

    def _stall(self, dt: float) -> None:
        with self._lock:
            self.stalls += 1
            self.stall_s += dt

    def _chunk(self) -> None:
        with self._lock:
            self.chunks += 1

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"stalls": self.stalls,
                    "stall_s": round(self.stall_s, 6),
                    "chunks": self.chunks}


def prefetch_iter(it: Iterator[HChunk], depth: int | None = None,
                  stats: Optional[PrefetchStats] = None
                  ) -> Iterator[HChunk]:
    """Pull up to ``depth`` chunks ahead of the consumer on a background
    thread: while the consumer keeps the device busy with chunk i, the
    next chunks' reads and unpacking proceed (file reads, zlib and the C
    checksum release the interpreter lock).  ``depth`` <= 0 is the plain
    synchronous iterator; the default is ``JobConfig.ooc_prefetch_depth``.
    Closing the consumer early stops the thread promptly, and an
    exception in the producer is raised in the consumer."""
    if depth is None:
        depth = JobConfig().ooc_prefetch_depth
    if depth <= 0:
        yield from it
        return
    q: "_queue.Queue" = _queue.Queue(maxsize=depth)
    stop = threading.Event()
    end = object()
    box: Dict[str, BaseException] = {}

    def pump():
        try:
            for item in it:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.05)
                        break
                    except _queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:            # surfaces in the consumer
            box["exc"] = e
        finally:
            while not stop.is_set():
                try:
                    q.put(end, timeout=0.05)
                    return
                except _queue.Full:
                    continue

    t = threading.Thread(target=pump, daemon=True,
                         name="dryad-ooc-prefetch")
    t.start()
    first = True
    try:
        while True:
            if (stats is not None and not first and q.empty()
                    and t.is_alive()):
                t0 = time.monotonic()
                item = q.get()
                stats._stall(time.monotonic() - t0)
            else:
                item = q.get()
            if item is end:
                break
            first = False
            if stats is not None:
                stats._chunk()
            yield item
        exc = box.get("exc")
        if exc is not None:
            raise exc
    finally:
        stop.set()


def _read_ahead(src: ChunkSource, prefetch: int | None,
                stats: Optional[PrefetchStats]) -> Iterator[HChunk]:
    """``src``'s chunks, read ahead on the prefetch thread when they are
    made on the host alone."""
    return prefetch_iter(iter(src), prefetch if src.on_host else 0, stats)


# ---------------------------------------------------------------------------
# the chunk pipeline through the device


def stream_through(chunks: Iterable[HChunk], device_fn, capacity: int,
                   device, depth: int = 2, prefetch: int | None = None,
                   stats: Optional[PrefetchStats] = None
                   ) -> Iterator[Any]:
    """Stream chunks through ``device_fn`` (Batch -> anything on the
    device), keeping up to ``depth`` chunks in flight: chunk i + 1 is
    copied over and its work queued before chunk i's result is handed
    back (and read back by the caller).  ``chunks`` is read ahead on the
    prefetch thread, so pass host-made chunks only."""
    pending: deque = deque()
    for chunk in prefetch_iter(iter(chunks), prefetch, stats):
        pending.append(device_fn(_chunk_to_batch(chunk, capacity, device)))
        if len(pending) >= depth:
            yield pending.popleft()
    while pending:
        yield pending.popleft()


def stream_map(src: ChunkSource, batch_fn, out_capacity: int | None = None,
               depth: int = 2, device="cuda") -> ChunkSource:
    """Lazy chunk-wise map: ``batch_fn`` (Batch -> Batch on the device)
    on every chunk; it may change row counts and columns (the output
    schema is probed on one empty chunk)."""
    device = resolve_device(device)
    cap = out_capacity or src.chunk_rows
    out_schema = chunk_schema(_batch_to_chunk(batch_fn(_chunk_to_batch(
        HChunk.empty_like(src.schema), 1, device))))

    def it():
        for out in stream_through(iter(src), batch_fn, src.chunk_rows,
                                  device, depth=depth,
                                  prefetch=None if src.on_host else 0):
            yield _batch_to_chunk(out)

    return ChunkSource(it, out_schema, cap, on_host=False)


# ---------------------------------------------------------------------------
# host-side ordering mirror (sampled bounds, rare oversize-bucket merges)


def _host_sort_lanes(spec, col: HostCol, descending: bool = False
                     ) -> List[np.ndarray]:
    """Numpy mirror of ``ops.kernels.sort_lanes_for``: uint32 lanes whose
    unsigned lexicographic order is the column's sort order, bit for bit
    the port's device lanes (which carry them as int64 in [0, 2**32))."""
    if spec["kind"] == "str":
        data, lens = col
        L = data.shape[1]
        mask = np.arange(L)[None, :] < lens[:, None]
        b = np.where(mask, data, 0).astype(np.uint32)
        pad = (-L) % 4
        lens_u = lens.astype(np.uint32)
        fold_len = pad >= 2 and L <= 0xFFFF
        if fold_len:
            # kernels._string_sort_lanes' length folding
            cols = [b, (lens_u >> 8)[:, None], (lens_u & 0xFF)[:, None]]
            if pad == 3:
                cols.append(np.zeros((b.shape[0], 1), np.uint32))
            b = np.concatenate(cols, axis=1)
        elif pad:
            b = np.pad(b, ((0, 0), (0, pad)))
        b4 = b.reshape(b.shape[0], -1, 4)
        lanes = list(np.moveaxis(
            (b4[..., 0] << 24) | (b4[..., 1] << 16) |
            (b4[..., 2] << 8) | b4[..., 3], -1, 0))
        if not fold_len:
            lanes.append(lens_u)
    else:
        arr = col
        if np.issubdtype(arr.dtype, np.floating):
            bits = arr.astype(np.float32).view(np.uint32)
            sign = bits >> 31
            bits = np.where(sign == 1, ~bits, bits | np.uint32(0x80000000))
            lanes = [bits]
        elif arr.dtype in (np.int64, np.uint64):
            u = arr.astype(np.int64)
            hi = (u >> 32).astype(np.uint32)
            if arr.dtype == np.int64:
                hi = hi ^ np.uint32(0x80000000)
            lanes = [hi, u.astype(np.uint32)]
        elif np.issubdtype(arr.dtype, np.signedinteger):
            lanes = [arr.astype(np.uint32) ^ np.uint32(0x80000000)]
        else:
            lanes = [arr.astype(np.uint32)]
    if descending:
        lanes = [np.invert(l) for l in lanes]
    return lanes


def _host_sort_order(schema, chunk: HChunk,
                     keys: Sequence[Tuple[str, bool]]) -> np.ndarray:
    lanes: List[np.ndarray] = []
    for name, desc in keys:
        lanes.extend(_host_sort_lanes(schema[name], chunk.cols[name], desc))
    return np.lexsort(tuple(reversed(lanes)))


# ---------------------------------------------------------------------------
# external sort


def _collect_samples(src: ChunkSource, key: str,
                     samples_per_chunk: int = 512
                     ) -> Tuple[np.ndarray, int]:
    """One streaming pass: (lane samples, total row count).  Lanes are
    computed on the host for at most ``samples_per_chunk`` evenly spread
    rows of each chunk, with ``_host_sort_lanes`` (lane 0 of the device
    lanes)."""
    spec = src.schema[key]
    samples: List[np.ndarray] = []
    total = 0
    for chunk in src:
        if chunk.n == 0:
            continue
        total += chunk.n
        take = min(chunk.n, samples_per_chunk)
        idx = np.linspace(0, chunk.n - 1, take).astype(np.int64)
        col = chunk.cols[key]
        if spec["kind"] == "str":
            lane = _host_sort_lanes(spec, (col[0][idx], col[1][idx]))[0]
        else:
            lane = _host_sort_lanes(spec, col[idx])[0]
        samples.append(lane)
    if not samples:
        return np.zeros((0,), np.uint32), 0
    return np.concatenate(samples), total


def _bounds_from_samples(samples: np.ndarray, n_buckets: int) -> np.ndarray:
    if len(samples) == 0:
        return np.zeros((n_buckets - 1,), np.uint32)
    s = np.sort(samples.astype(np.uint64))
    qs = np.asarray([len(s) * (i + 1) // n_buckets
                     for i in range(n_buckets - 1)], np.int64)
    return s[np.minimum(qs, len(s) - 1)].astype(np.uint32)


def _sample_bounds(src: ChunkSource, key: str, n_buckets: int,
                   samples_per_chunk: int = 512) -> np.ndarray:
    samples, _ = _collect_samples(src, key, samples_per_chunk)
    return _bounds_from_samples(samples, n_buckets)


def _scatter_by_dest(b: Batch, dest: torch.Tensor, n_buckets: int):
    """A chunk's rows grouped by destination bucket (a stable sort on the
    bucket id; padding rows carry ``n_buckets`` and sort last) and the
    per-bucket counts from ``hist_buckets`` (the kernel on the card)."""
    grouped = kernels.permute_by_sort(b, [dest.long()])
    return grouped, hk.hist_buckets(dest.contiguous(), n_buckets)


def _range_scatter(b: Batch, key: str, bounds: torch.Tensor,
                   n_buckets: int):
    """Rows grouped by range bucket: searchsorted(bounds, lane, right) of
    the key's first ascending sort lane."""
    dest = kernels.searchsorted_small(bounds, range_dest_lane(b.columns[key]),
                                      side="right")
    dest = torch.where(b.valid_mask(), dest, n_buckets)
    return _scatter_by_dest(b, dest, n_buckets)


def _hash_scatter(b: Batch, keys: Sequence[str], n_buckets: int):
    """Rows grouped by hash bucket: the low 32-bit hash lane mod
    ``n_buckets``."""
    _, lo = hash_batch_keys(b, list(keys))
    dest = (lo % n_buckets).to(torch.int32)
    dest = torch.where(b.valid_mask(), dest, n_buckets)
    return _scatter_by_dest(b, dest, n_buckets)


def _bucket_frags(grouped: Batch, hist: torch.Tensor
                  ) -> List[HChunk]:
    """A scattered chunk on the host, cut into its buckets' fragments."""
    gh = _batch_to_chunk(grouped)
    h = hist.cpu().numpy()
    offs = np.cumsum(np.concatenate([[0], h]))
    return [_slice_hchunk(gh, int(offs[i]), int(offs[i + 1]))
            for i in range(h.shape[0])]


def _bounds_tensor(bounds: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(bounds.astype(np.int64)).to(device)


class _BucketStore:
    """Per-bucket fragment accumulator: host memory, or spill files on
    disk (the host-side materialization of a streamed exchange)."""

    def __init__(self, schema, n_buckets: int,
                 spill_dir: Optional[str] = None):
        self.schema = schema
        self.n_buckets = n_buckets
        self.spill_dir = spill_dir
        self._ram: List[List[HChunk]] = [[] for _ in range(n_buckets)]
        self._files: List[Any] = []
        if spill_dir:
            os.makedirs(spill_dir, exist_ok=True)
            self._files = [open(os.path.join(spill_dir, f"bucket-{i:05d}"),
                                "wb") for i in range(n_buckets)]
            self._frag_rows: List[List[int]] = [[] for _ in range(n_buckets)]

    def append(self, bucket: int, frag: HChunk) -> None:
        if frag.n == 0:
            return
        if not self.spill_dir:
            self._ram[bucket].append(frag)
            return
        f = self._files[bucket]
        for k in sorted(self.schema):
            v = frag.cols[k]
            if self.schema[k]["kind"] == "str":
                f.write(np.ascontiguousarray(v[0]).tobytes())
                f.write(np.ascontiguousarray(v[1]).tobytes())
            else:
                f.write(np.ascontiguousarray(v).tobytes())
        self._frag_rows[bucket].append(frag.n)

    def fragments(self, bucket: int) -> List[HChunk]:
        if not self.spill_dir:
            return self._ram[bucket]
        if not self._files[bucket].closed:
            self._files[bucket].flush()
        out: List[HChunk] = []
        with open(self._files[bucket].name, "rb") as f:
            for n in self._frag_rows[bucket]:
                cols: Dict[str, HostCol] = {}
                for k in sorted(self.schema):
                    spec = self.schema[k]
                    if spec["kind"] == "str":
                        L = spec["max_len"]
                        d = np.frombuffer(f.read(n * L), np.uint8
                                          ).reshape(n, L)
                        ln = np.frombuffer(f.read(n * 4), np.int32)
                        cols[k] = (d, ln)
                    else:
                        dt = np.dtype(spec["dtype"])
                        tshape = tuple(spec.get("shape", ()))
                        cnt = n * int(np.prod(tshape, dtype=np.int64) or 1)
                        cols[k] = np.frombuffer(
                            f.read(cnt * dt.itemsize), dt
                        ).reshape((n,) + tshape)
                out.append(HChunk(cols, n))
        return out

    def rows(self, bucket: int) -> int:
        if not self.spill_dir:
            return sum(f.n for f in self._ram[bucket])
        return sum(self._frag_rows[bucket])

    def clear(self, bucket: int) -> None:
        if not self.spill_dir:
            self._ram[bucket] = []

    def close(self) -> None:
        """Release the WRITE handles; fragments() keeps reading by name."""
        for f in self._files:
            if not f.closed:
                f.close()


def _sorted_bucket_chunks(schema, frags: List[HChunk],
                          keys: Sequence[Tuple[str, bool]],
                          chunk_rows: int, device,
                          rebucket_depth: int = 2,
                          rebuckets: Optional[List[int]] = None
                          ) -> Iterator[HChunk]:
    """Yield a bucket's rows fully sorted, in chunks of <= chunk_rows.

    Fits one chunk -> one device sort.  Oversize -> re-bucket on
    resampled bounds (``rebuckets`` counts the chunks scattered so);
    when the bounds degenerate (heavy lane skew), a host lexsort over
    the exact device sort-lane order."""
    total = sum(f.n for f in frags)
    if total == 0:
        return
    if total <= chunk_rows:
        merged = _concat_hchunks(schema, frags)
        yield _batch_to_chunk(kernels.sort_by_columns(
            _chunk_to_batch(merged, total, device), list(keys)))
        return
    key0, desc0 = keys[0]
    if rebucket_depth > 0:
        sub_n = max(2, -(-total // chunk_rows) * 2)
        sub = ChunkSource(lambda: iter(frags), schema, chunk_rows)
        bounds = _sample_bounds(sub, key0, sub_n)
        if len(np.unique(bounds)) > 1:  # non-degenerate: recurse
            tb = _bounds_tensor(bounds, device)
            store = _BucketStore(schema, sub_n)
            for frag in frags:
                for s in range(0, frag.n, chunk_rows):
                    piece = _slice_hchunk(frag, s,
                                          min(s + chunk_rows, frag.n))
                    grouped, hist = _range_scatter(
                        _chunk_to_batch(piece, chunk_rows, device), key0,
                        tb, sub_n)
                    if rebuckets is not None:
                        rebuckets.append(1)
                    for i, fr in enumerate(_bucket_frags(grouped, hist)):
                        store.append(i, fr)
            order = range(sub_n - 1, -1, -1) if desc0 else range(sub_n)
            for i in order:
                yield from _sorted_bucket_chunks(
                    schema, store.fragments(i), keys, chunk_rows, device,
                    rebucket_depth - 1, rebuckets)
            return
    # degenerate lane: exact host merge over the full sort-lane order
    merged = _concat_hchunks(schema, frags)
    order = _host_sort_order(schema, merged, keys)
    for s in range(0, total, chunk_rows):
        idx = order[s: s + chunk_rows]
        cols = {k: ((v[0][idx], v[1][idx]) if isinstance(v, tuple)
                    else v[idx]) for k, v in merged.cols.items()}
        yield HChunk(cols, len(idx))


def _schema_row_bytes(schema) -> int:
    # floored at 1 so an empty schema cannot zero the in-core estimate
    return max(schema_row_bytes(schema), 1)


def external_sort(src: ChunkSource, keys: Sequence[Tuple[str, bool]],
                  n_buckets: int | None = None,
                  spill_dir: Optional[str] = None,
                  depth: int | None = None,
                  incore_bytes: int = 0,
                  prefetch: int | None = None,
                  stats: Optional[PrefetchStats] = None,
                  device="cuda",
                  info: Optional[Dict[str, Any]] = None
                  ) -> Iterator[HChunk]:
    """Globally sort an arbitrarily large chunk stream; yields sorted
    chunks in order, with O(chunk_rows) rows on the device (but for the
    in-core tier).

    Pass A samples range bounds on the primary key's first lane and
    counts the rows; pass B scatters each chunk into range buckets on the
    device (``depth`` chunks in flight) and accumulates the buckets on the
    host (``spill_dir``: on disk); pass C sorts each bucket on the device
    (re-bucketing an oversize one) and emits them in bucket order, so the
    concatenation is sorted: the TeraSort plan.  ``incore_bytes`` > 0
    (``JobConfig.ooc_incore_bytes``): data that fits skips passes B and C
    for ONE device sort.  ``info``, when given, receives the bucket
    count, whether the in-core tier ran, the chunks scattered in pass B
    and the chunks a re-bucketing scattered."""
    if depth is None:
        depth = JobConfig().ooc_inflight
    device = resolve_device(device)
    chunk_rows = src.chunk_rows
    key0, desc0 = keys[0]
    info = {} if info is None else info
    info.update({"n_buckets": 0, "incore": False, "scattered": 0,
                 "rebucketed": 0})

    # pass A: one streaming pass collects samples AND the row count
    samples, total = _collect_samples(src, key0)

    if incore_bytes > 0 and total * _schema_row_bytes(src.schema) \
            <= incore_bytes:
        info["incore"] = True
        merged = _concat_hchunks(src.schema, list(src))
        out = _batch_to_chunk(kernels.sort_by_columns(
            _chunk_to_batch(merged, max(merged.n, 1), device), list(keys)))
        for s in range(0, max(out.n, 1), chunk_rows):
            e = min(s + chunk_rows, out.n)
            if e > s:
                yield _slice_hchunk(out, s, e)
        return
    nb = n_buckets or max(2, -(-total // chunk_rows) * 2)
    info["n_buckets"] = nb
    bounds = _bounds_tensor(_bounds_from_samples(samples, nb), device)

    # pass B: scatter into buckets, ``depth`` chunks in flight
    store = _BucketStore(src.schema, nb, spill_dir=spill_dir)
    pending: deque = deque()

    def drain_one():
        for i, fr in enumerate(_bucket_frags(*pending.popleft())):
            store.append(i, fr)

    for chunk in _read_ahead(src, prefetch, stats):
        pending.append(_range_scatter(
            _chunk_to_batch(chunk, chunk_rows, device), key0, bounds, nb))
        info["scattered"] += 1
        if len(pending) >= depth:
            drain_one()
    while pending:
        drain_one()

    # pass C: per-bucket sort, emitted in bucket order
    rebuckets: List[int] = []
    order = range(nb - 1, -1, -1) if desc0 else range(nb)
    try:
        for i in order:
            yield from _sorted_bucket_chunks(
                src.schema, store.fragments(i), keys, chunk_rows, device,
                rebuckets=rebuckets)
            info["rebucketed"] = len(rebuckets)
            store.clear(i)
    finally:
        store.close()


# ---------------------------------------------------------------------------
# streamed reductions: ONE scatter / accumulate / compact / finalize
# pipeline that the streamed group-by, the user-decomposable group-by
# and distinct ride: per chunk a LOCAL device reduction, a hash scatter
# of its rows into key buckets, host accumulation with device COMPACTION
# whenever a bucket would outgrow a chunk, then a per-bucket FINALIZE.


def _resolve_bucket_knobs(n_buckets, depth):
    cfg = JobConfig()
    return (cfg.ooc_hash_buckets if n_buckets is None else n_buckets,
            cfg.ooc_inflight if depth is None else depth)


def _probe_schema(fn, schema, device) -> Dict[str, Any]:
    """The output schema of a Batch -> Batch device function, from one
    empty one-row-capacity chunk."""
    return chunk_schema(_batch_to_chunk(fn(_chunk_to_batch(
        HChunk.empty_like(schema), 1, device))))


def _hash_bucketed_reduce(src: ChunkSource, keys: Sequence[str],
                          local_fn, compact_fn, final_fn,
                          row_schema, n_buckets: int, depth: int,
                          what: str, device, prefetch: int | None = None,
                          stats: Optional[PrefetchStats] = None
                          ) -> Iterator[HChunk]:
    """``local_fn``: per-chunk device reduction; ``compact_fn``: the
    associative device re-reduction of a bucket's accumulated rows;
    ``final_fn``: the per-bucket finishing pass (each Batch -> Batch).
    ``row_schema`` is ``local_fn``'s output schema.  A bucket's distinct
    reduced rows must fit one chunk: raise ``n_buckets`` otherwise."""
    chunk_rows = src.chunk_rows
    buckets: List[List[HChunk]] = [[] for _ in range(n_buckets)]
    bucket_rows = [0] * n_buckets

    def compact_bucket(i: int) -> None:
        merged = _concat_hchunks(row_schema, buckets[i])
        out = _batch_to_chunk(compact_fn(
            _chunk_to_batch(merged, max(merged.n, 1), device)))
        buckets[i] = [out]
        bucket_rows[i] = out.n

    def add_rows(ph: HChunk) -> None:
        frags = _bucket_frags(*_hash_scatter(
            _chunk_to_batch(ph, chunk_rows, device), keys, n_buckets))
        for i, frag in enumerate(frags):
            if frag.n == 0:
                continue
            if bucket_rows[i] + frag.n > chunk_rows:
                compact_bucket(i)
                if bucket_rows[i] + frag.n > chunk_rows:
                    raise OOCError(
                        f"{what} bucket {i} holds {bucket_rows[i]} "
                        f"reduced rows; with {frag.n} incoming it exceeds "
                        f"chunk capacity {chunk_rows}; raise n_buckets")
            buckets[i].append(frag)
            bucket_rows[i] += frag.n

    pending: deque = deque()
    for chunk in _read_ahead(src, prefetch, stats):
        pending.append(local_fn(_chunk_to_batch(chunk, chunk_rows, device)))
        if len(pending) >= depth:
            add_rows(_batch_to_chunk(pending.popleft()))
    while pending:
        add_rows(_batch_to_chunk(pending.popleft()))

    for i in range(n_buckets):
        if bucket_rows[i] == 0:
            continue
        merged = _concat_hchunks(row_schema, buckets[i])
        yield _batch_to_chunk(final_fn(
            _chunk_to_batch(merged, merged.n, device)))


def streaming_group_aggregate(src: ChunkSource, keys: Sequence[str],
                              aggs: Dict[str, Tuple[str, Optional[str]]],
                              n_buckets: int | None = None,
                              depth: int | None = None,
                              prefetch: int | None = None,
                              stats: Optional[PrefetchStats] = None,
                              device="cuda") -> Iterator[HChunk]:
    """GroupBy + builtin aggregates over an arbitrarily large chunk
    stream: per chunk a partial aggregate on the device, hash-scattered
    into ``n_buckets`` key buckets; a bucket that outgrows a chunk is
    merged on the device, and each bucket is merged and finalized at the
    end.  A bucket's distinct keys must fit one chunk."""
    from dryad_tpu_torch.plan.planner import _decompose_aggs
    n_buckets, depth = _resolve_bucket_knobs(n_buckets, depth)
    device = resolve_device(device)
    keys = list(keys)
    partial, final, mean_cols = _decompose_aggs(dict(aggs))

    def pagg(b):
        return kernels.group_aggregate(b, keys, partial)

    def merge(b):
        return kernels.group_aggregate(b, keys, final)

    def final_fn(b):
        m = merge(b)
        return Batch(kernels.mean_finalize_columns(dict(m.columns),
                                                   mean_cols), m.count)

    yield from _hash_bucketed_reduce(
        src, keys, pagg, merge, final_fn,
        _probe_schema(pagg, src.schema, device), n_buckets, depth, "group",
        device, prefetch=prefetch, stats=stats)


def streaming_group_whole(src: ChunkSource, keys: Sequence[str],
                          bucket_fn, out_schema: Dict[str, Any],
                          n_buckets: int | None = None,
                          depth: int | None = None,
                          max_bucket_rows: int | None = None,
                          what: str = "group_whole",
                          prefetch: int | None = None,
                          stats: Optional[PrefetchStats] = None,
                          device="cuda") -> Iterator[HChunk]:
    """Whole-group operators (``group_apply``'s user fn, ``group_median``)
    over an arbitrarily large chunk stream.  They do not compose, so RAW
    rows hash-scatter into ``n_buckets`` key buckets (every row of a key
    lands in one bucket), each bucket accumulates on the host, and one
    device batch per bucket goes through ``bucket_fn``.  A bucket holds at
    most ``max_bucket_rows`` rows (``JobConfig.ooc_group_bucket_rows``):
    with no compaction to fall back on, that bound is the contract."""
    n_buckets, depth = _resolve_bucket_knobs(n_buckets, depth)
    device = resolve_device(device)
    if max_bucket_rows is None:
        max_bucket_rows = JobConfig().ooc_group_bucket_rows
    chunk_rows = src.chunk_rows
    buckets: List[List[HChunk]] = [[] for _ in range(n_buckets)]
    bucket_rows = [0] * n_buckets

    for chunk in _read_ahead(src, prefetch, stats):
        if chunk.n == 0:
            continue
        frags = _bucket_frags(*_hash_scatter(
            _chunk_to_batch(chunk, chunk_rows, device), keys, n_buckets))
        for i, frag in enumerate(frags):
            if frag.n == 0:
                continue
            if bucket_rows[i] + frag.n > max_bucket_rows:
                raise OOCError(
                    f"{what} bucket {i} holds {bucket_rows[i]} raw rows; "
                    f"with {frag.n} incoming it exceeds "
                    f"ooc_group_bucket_rows={max_bucket_rows} (whole "
                    f"groups cannot be compacted) — raise n_buckets or "
                    f"the knob")
            buckets[i].append(frag)
            bucket_rows[i] += frag.n

    for i in range(n_buckets):
        if bucket_rows[i] == 0:
            continue
        merged = _concat_hchunks(src.schema, buckets[i])
        buckets[i] = []
        yield _batch_to_chunk(bucket_fn(_chunk_to_batch(merged, merged.n,
                                                        device)))


def streaming_group_decomposable(src: ChunkSource, keys: Sequence[str],
                                 decs: Dict[str, Any],
                                 n_buckets: int | None = None,
                                 depth: int | None = None,
                                 prefetch: int | None = None,
                                 stats: Optional[PrefetchStats] = None,
                                 device="cuda") -> Iterator[HChunk]:
    """GroupBy with USER-DEFINED Decomposable aggregates over a chunk
    stream: per-chunk seed + merge, hash scatter of the flattened states
    into key buckets, merge compaction on the device, finalize per
    bucket (the streamed form of the planner's dgroup lowering)."""
    n_buckets, depth = _resolve_bucket_knobs(n_buckets, depth)
    device = resolve_device(device)
    keys_l = list(keys)
    box: Dict[str, Any] = {}

    def pagg(b):
        return kernels.group_decompose_partial(b, keys_l, decs, box)

    def merge(b):
        return kernels.group_decompose_merge(b, keys_l, decs, box, False)

    def fin(b):
        return kernels.group_decompose_merge(b, keys_l, decs, box, True)

    # the partial-state schema probe also fills the treespec box before
    # any merge runs
    yield from _hash_bucketed_reduce(
        src, keys, pagg, merge, fin, _probe_schema(pagg, src.schema, device),
        n_buckets, depth, "decomposable-group", device, prefetch=prefetch,
        stats=stats)


def streaming_group_topk(src: ChunkSource, keys: Sequence[str], k: int,
                         by: str, descending: bool = True,
                         n_buckets: int | None = None,
                         depth: int | None = None,
                         prefetch: int | None = None,
                         stats: Optional[PrefetchStats] = None,
                         device="cuda") -> Iterator[HChunk]:
    """Per-group top-k rows over a chunk stream.  Top-k of accumulated
    top-ks is the global top-k, so buckets accumulate candidate rows and
    re-compact with ``group_top_k`` when they outgrow a chunk; a bucket
    keeps at most k x (its distinct keys) rows."""
    n_buckets, depth = _resolve_bucket_knobs(n_buckets, depth)
    device = resolve_device(device)
    chunk_rows = src.chunk_rows
    keys_l = list(keys)

    def topk(b):
        return kernels.group_top_k(b, keys_l, k, by, descending)

    buckets: List[List[HChunk]] = [[] for _ in range(n_buckets)]
    bucket_rows = [0] * n_buckets

    def compact_bucket(i: int) -> None:
        merged = _concat_hchunks(src.schema, buckets[i])
        out = _batch_to_chunk(topk(_chunk_to_batch(merged, max(merged.n, 1),
                                                   device)))
        if out.n > chunk_rows:
            raise OOCError(
                f"top-{k} bucket {i} holds {out.n} rows (> chunk capacity "
                f"{chunk_rows}) even after compaction; raise n_buckets")
        buckets[i] = [out]
        bucket_rows[i] = out.n

    def add_rows(ch: HChunk) -> None:
        frags = _bucket_frags(*_hash_scatter(
            _chunk_to_batch(ch, chunk_rows, device), keys_l, n_buckets))
        for i, frag in enumerate(frags):
            if frag.n == 0:
                continue
            if bucket_rows[i] + frag.n > chunk_rows:
                compact_bucket(i)
            buckets[i].append(frag)
            bucket_rows[i] += frag.n

    pending: deque = deque()
    for chunk in _read_ahead(src, prefetch, stats):
        # local pre-trim: a chunk never contributes more than top-k per
        # group it holds
        pending.append(topk(_chunk_to_batch(chunk, chunk_rows, device)))
        if len(pending) >= depth:
            add_rows(_batch_to_chunk(pending.popleft()))
    while pending:
        add_rows(_batch_to_chunk(pending.popleft()))

    for i in range(n_buckets):
        if bucket_rows[i] == 0:
            continue
        compact_bucket(i)
        yield buckets[i][0]


def streaming_distinct(src: ChunkSource, keys: Sequence[str] = (),
                       n_buckets: int | None = None,
                       depth: int | None = None,
                       prefetch: int | None = None,
                       stats: Optional[PrefetchStats] = None,
                       device="cuda") -> Iterator[HChunk]:
    """Distinct rows over a chunk stream: per chunk a local dedup on the
    device, survivors hash-scattered into key buckets, buckets re-deduped
    on the device when they outgrow a chunk (a bucket's distinct rows
    must fit one chunk)."""
    n_buckets, depth = _resolve_bucket_knobs(n_buckets, depth)
    device = resolve_device(device)
    key_names = tuple(keys) or tuple(sorted(src.schema))
    dkeys = list(keys) or None

    def dd(b):
        return kernels.distinct(b, dkeys)

    yield from _hash_bucketed_reduce(src, key_names, dd, dd, dd,
                                     src.schema, n_buckets, depth,
                                     "distinct", device, prefetch=prefetch,
                                     stats=stats)


# ---------------------------------------------------------------------------
# chunked store output


def write_chunks_to_store(path: str, chunks: Iterable[HChunk],
                          schema: Dict[str, Any],
                          partitioning: Optional[Dict[str, Any]] = None,
                          compression: Optional[str] = None
                          ) -> Dict[str, Any]:
    """Stream chunks to a store (``io/store.py`` layout), one partition
    file per chunk, committed atomically by a temp-dir rename (an
    ``hdfs://`` store by WebHDFS's rename, each chunk uploaded as it is
    drained); host memory stays O(chunk_rows) on the write side too.
    ``s3://`` is refused: an unbounded chunk stream has no atomic
    multi-object commit.  Returns the store's meta."""
    if compression not in (None, "gzip"):
        raise ValueError(f"unknown compression {compression!r}")
    store_schema: Dict[str, Any] = {}
    for k, spec in schema.items():
        if spec["kind"] == "str":
            store_schema[k] = {"kind": "str", "max_len": spec["max_len"]}
        else:
            store_schema[k] = {"kind": "dense", "dtype": spec["dtype"],
                               "shape": list(spec.get("shape", ()))}
    if path.startswith("hdfs://"):
        from dryad_tpu_torch.io.webhdfs import _write_chunks_hdfs
        return _write_chunks_hdfs(path, chunks, store_schema,
                                  partitioning=partitioning,
                                  compression=compression)
    if path.startswith("s3://"):
        raise OOCError(
            "streamed writes to s3:// are not supported (no atomic "
            "multi-object commit for an unbounded chunk stream); "
            "to_store to a local or hdfs:// path instead")
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    counts: List[int] = []
    checksums: List[str] = []
    for p, chunk in enumerate(chunks):
        segs = chunk_segments(store_schema, chunk.cols)
        _write_part((_part_path(tmp, p), segs, compression))
        checksums.append("%016x" % checksum_segments(segs))
        counts.append(chunk.n)
    meta = build_meta(store_schema, counts, checksums,
                      partitioning=partitioning, compression=compression)
    atomic_write_json(os.path.join(tmp, "meta.json"), meta, indent=1)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    return meta


# ---------------------------------------------------------------------------
# the store-backed re-streaming chunk cache (Dataset.cache() of streamed
# or edge-scale data)
#
# A loop-invariant intermediate is kept as a LOCAL chunked store in the
# io/store.py layout: the cold pass writes one part file per chunk (each
# with its fnv64 checksum in meta.json), warm passes re-stream it with
# local sequential reads, and a restarted job with an intact entry skips
# the cold pass.  A ``cache.json`` sidecar records the producing query's
# stable fingerprint: a changed query or changed source data misses, and
# a corrupt chunk (checksum mismatch on read) falls back to a clean
# re-stream of the producer, never wrong rows.


def cache_entry_paths(root: str, key: str) -> Tuple[str, str, str]:
    """(entry dir, data store path, sidecar path) for a cache key."""
    entry = os.path.join(root, "ooc-cache-" + key[:16])
    return entry, os.path.join(entry, "data"), os.path.join(entry,
                                                           "cache.json")


def cached_chunk_source(root: str, key: str
                        ) -> Optional[Tuple[ChunkSource, Dict[str, Any]]]:
    """The validated warm entry: (a ChunkSource re-streaming its data
    store, the sidecar), or None when the entry is absent, carries
    another key (stale) or its store meta does not read.  Chunk checksums
    are verified lazily, as each partition is read."""
    _entry, data, side = cache_entry_paths(root, key)
    try:
        with open(side) as f:
            sc = json.load(f)
        if sc.get("key") != key:
            return None
        cs = ChunkSource.from_store(data, int(sc["chunk_rows"]))
    except Exception:
        return None
    return cs, sc


def _commit_sidecar(root: str, key: str, chunk_rows: int,
                    meta: Dict[str, Any]) -> Dict[str, Any]:
    """Sidecar-LAST commit of both cold-write paths: an entry without a
    matching sidecar reads as a miss, so a crash mid-write never serves a
    half-written entry."""
    _entry, _data, side = cache_entry_paths(root, key)
    sidecar = {"key": key, "chunk_rows": int(chunk_rows),
               "rows": int(sum(meta["counts"])),
               "bytes": int(sum(meta.get("bytes", [])))}
    atomic_write_json(side, sidecar)
    return sidecar


def write_chunk_cache(root: str, key: str, src: ChunkSource,
                      chunk_rows: int | None = None) -> Dict[str, Any]:
    """Cold pass: drain the producing stream into the entry's data store,
    then commit the sidecar.  Returns the sidecar."""
    entry, data, _side = cache_entry_paths(root, key)
    os.makedirs(entry, exist_ok=True)
    meta = write_chunks_to_store(data, iter(src), src.schema)
    return _commit_sidecar(root, key, chunk_rows or src.chunk_rows, meta)


def adopt_chunk_cache(root: str, key: str, chunk_rows: int
                      ) -> Dict[str, Any]:
    """Sidecar commit for an entry whose data store another writer made
    (the in-memory ``to_store``): read its meta, record the key and the
    chunk size to read it with."""
    _entry, data, _side = cache_entry_paths(root, key)
    return _commit_sidecar(root, key, chunk_rows, store_meta(data))


def invalidate_cache_entry(root: str, key: str) -> None:
    entry, _, _ = cache_entry_paths(root, key)
    shutil.rmtree(entry, ignore_errors=True)


def cache_source(root: str, key: str, chunk_rows: int, schema,
                 make_producer: Callable[[], Iterable[HChunk]],
                 on_event=None) -> ChunkSource:
    """The re-streaming cache read: a re-iterable ChunkSource serving
    each pass from the validated local entry (``ooc_cache_hit``), first
    rebuilding a missing or stale entry from ``make_producer``
    (``ooc_cache_write``).  A checksum mismatch mid-stream wipes the entry
    (``ooc_cache_invalid``) and continues from a clean re-stream of the
    producer, skipping exactly the rows already served (they passed their
    checksums): streamed one-partition execution is deterministic in row
    order.  The producer runs device work, so the source is not read
    ahead on the prefetch thread."""
    ev = on_event or (lambda e: None)

    def it():
        got = cached_chunk_source(root, key)
        if got is None:
            # entry missing or stale: rebuild it from the producer
            src = make_producer()
            if not isinstance(src, ChunkSource):
                src = ChunkSource(lambda s=src: iter(s), schema,
                                  chunk_rows)
            sc = write_chunk_cache(root, key, src, chunk_rows=chunk_rows)
            ev({"event": "ooc_cache_write",
                "path": cache_entry_paths(root, key)[0],
                "rows": sc["rows"], "bytes": sc["bytes"]})
            got = cached_chunk_source(root, key)
            if got is None:               # unwritable root: stream direct
                yield from make_producer()
                return
        inner, sc = got
        ev({"event": "ooc_cache_hit",
            "path": cache_entry_paths(root, key)[0],
            "rows": sc.get("rows"), "bytes": sc.get("bytes")})
        yielded = 0
        restream = False
        try:
            for c in inner:
                yield c
                yielded += c.n
        except GeneratorExit:
            raise
        except Exception as e:
            # a corrupt or vanished chunk: what was served passed its
            # checksum, so wipe the entry and go on from the producer at
            # the exact row
            ev({"event": "ooc_cache_invalid",
                "path": cache_entry_paths(root, key)[0],
                "error": repr(e)[:200], "rows_served": yielded})
            invalidate_cache_entry(root, key)
            restream = True
        if restream:
            skip = yielded
            for c in make_producer():
                if c.n == 0:
                    continue
                if skip >= c.n:
                    skip -= c.n
                    continue
                if skip:
                    c = _slice_hchunk(c, skip, c.n)
                    skip = 0
                yield c

    src = ChunkSource(it, schema, chunk_rows, on_host=False)
    # the entry key is itself a restart-stable content identity, so a
    # query DERIVED from a cached stream gets a restart-stable key too
    src.fingerprint = "ooc-cache:" + key
    return src
