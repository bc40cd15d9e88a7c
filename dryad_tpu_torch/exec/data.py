"""Partitioned datasets on the logical mesh.

The counterpart of ``dryad_tpu/exec/data.py``: a dataset in flight is a
stacked Batch whose columns carry a leading partition dimension
``[P, capacity, ...]`` and whose count is ``[P]``.  In the JAX package
partition p lives on device p; here all P partitions share one device.

``pdata_from_numpy`` / ``pdata_to_numpy`` carry a JAX ``PData``'s arrays
(``np.asarray`` of every ``[P, cap, ...]`` leaf, plus the counts) into the
port's tensors and back.  In a dataflow system the data is the state, so
this is the port's counterpart of a weight conversion.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from dryad_tpu_torch.data.columnar import (Batch, StringColumn, _as_bytes,
                                           _is_string_list, map_column,
                                           pack_bytes_list, unpack_rows)

__all__ = ["PData", "pdata_from_host", "pdata_from_packed_strings",
           "pdata_to_host", "shrink_pdata",
           "maybe_shrink_for_collect", "pdata_from_numpy", "pdata_to_numpy",
           "split_partitions", "stack_partitions"]


@dataclasses.dataclass
class PData:
    """Stacked per-partition batch: columns [P, cap, ...], count [P]."""

    batch: Batch
    nparts: int

    @property
    def capacity(self) -> int:
        for c in self.batch.columns.values():
            return c.data.shape[1] if isinstance(c, StringColumn) \
                else c.shape[1]
        raise ValueError("empty PData")

    @property
    def counts(self) -> torch.Tensor:
        return self.batch.count  # [P]


def split_partitions(pd: PData) -> List[Batch]:
    """The P per-partition Batches of a PData (views, no copies)."""
    return [Batch({k: map_column(v, lambda x, p=p: x[p])
                   for k, v in pd.batch.columns.items()}, pd.batch.count[p])
            for p in range(pd.nparts)]


def stack_partitions(parts: List[Batch]) -> PData:
    """Stack P same-shaped per-partition Batches into a PData."""
    cols: Dict[str, Any] = {}
    for k, v in parts[0].columns.items():
        if isinstance(v, StringColumn):
            cols[k] = StringColumn(
                torch.stack([b.columns[k].data for b in parts]),
                torch.stack([b.columns[k].lengths for b in parts]))
        else:
            cols[k] = torch.stack([b.columns[k] for b in parts])
    count = torch.stack([b.count.to(torch.int32) for b in parts])
    return PData(Batch(cols, count), len(parts))


def _local_parts(mesh) -> range:
    """The global indices of the partitions this process builds: all of
    them, or a gang rank's own (``parallel/mesh.py``)."""
    n = getattr(mesh, "local_nparts", mesh.nparts)
    start = getattr(mesh, "part_start", 0)
    return range(start, start + n)


def _block_slices(n: int, parts: int):
    """Contiguous block partitioning, row order partition-major."""
    base, rem = divmod(n, parts)
    out, start = [], 0
    for p in range(parts):
        size = base + (1 if p < rem else 0)
        out.append((start, start + size))
        start += size
    return out


def pdata_from_host(columns: Mapping[str, Any], mesh,
                    capacity: int | None = None,
                    str_max_len: int = 64) -> PData:
    """Build a PData from host columns (block-partitioned rows over the
    mesh's ``nparts``).  A gang rank builds only its own partitions, at
    the capacity the whole mesh's build gives them."""
    nparts = mesh.nparts
    n = None
    for v in columns.values():
        n = len(v)
        break
    if n is None:
        raise ValueError("no columns")
    slices = _block_slices(n, nparts)
    max_block = max(1, max(e - s for s, e in slices))
    cap = capacity or max_block
    if cap < max_block:
        raise ValueError(
            f"capacity {cap} too small: {n} rows over {nparts} partitions "
            f"needs per-partition capacity >= {max_block}")
    local = _local_parts(mesh)
    if len(local) != nparts:
        # a gang rank: its partitions' rows only
        lo, hi = slices[local[0]][0], slices[local[-1]][1]
        columns = {k: v[lo:hi] for k, v in columns.items()}
        slices = [(s - lo, e - lo) for s, e in slices[local[0]:local[-1] + 1]]
        n, nparts = hi - lo, len(local)
    # rows [s, e) of partition p land at stacked row p*cap + (i - s)
    dst = np.concatenate([np.arange(e - s) + p * cap
                          for p, (s, e) in enumerate(slices)]).astype(np.int64)
    cols: Dict[str, Any] = {}
    for k, v in columns.items():
        if _is_string_list(v, n):
            data, lens = pack_bytes_list(_as_bytes(v), str_max_len, max(n, 1))
            sd = np.zeros((nparts * cap, str_max_len), np.uint8)
            sl = np.zeros((nparts * cap,), np.int32)
            sd[dst] = data[:n]
            sl[dst] = lens[:n]
            cols[k] = (sd.reshape(nparts, cap, str_max_len),
                       sl.reshape(nparts, cap))
        else:
            arr = np.asarray(v)
            stacked = np.zeros((nparts * cap,) + arr.shape[1:], arr.dtype)
            stacked[dst] = arr
            cols[k] = stacked.reshape((nparts, cap) + arr.shape[1:])
    counts = np.asarray([e - s for s, e in slices], np.int32)
    return pdata_from_numpy(cols, counts, mesh.device)


def pdata_from_packed_strings(data: np.ndarray, lens: np.ndarray, mesh,
                              column: str = "line",
                              capacity: int | None = None) -> PData:
    """A one-string-column PData from an already packed [n, max_len] byte
    matrix (``columnar.pack_lines``), block-partitioned like
    ``pdata_from_host``, with no per-row Python work (a gang rank: its
    own partitions)."""
    nparts = mesh.nparts
    n, max_len = data.shape
    slices = _block_slices(n, nparts)
    max_block = max(1, max(e - s for s, e in slices))
    cap = capacity or max_block
    if cap < max_block:
        raise ValueError(f"capacity {cap} < max block {max_block}")
    local = _local_parts(mesh)
    slices = [slices[g] for g in local]
    nparts = len(local)
    sd = np.zeros((nparts, cap, max_len), np.uint8)
    sl = np.zeros((nparts, cap), np.int32)
    for p, (s, e) in enumerate(slices):
        sd[p, : e - s] = data[s:e]
        sl[p, : e - s] = lens[s:e]
    counts = np.asarray([e - s for s, e in slices], np.int32)
    return pdata_from_numpy({column: (sd, sl)}, counts, mesh.device)


def _tensor(a, dtype, device) -> torch.Tensor:
    a = np.ascontiguousarray(a, dtype)
    if not a.flags.writeable:   # e.g. np.asarray of a JAX array
        a = a.copy()
    return torch.from_numpy(a).to(device)


def pdata_from_numpy(columns: Mapping[str, Any], counts, device) -> PData:
    """numpy state -> PData.  ``columns`` maps a name to a ``[P, cap, ...]``
    array, or to a ``(data [P, cap, L] u8, lengths [P, cap] i32)`` pair
    for a string column — the leaves of a JAX ``PData`` after
    ``np.asarray``, the state columns ``{out}@{i}`` of a decomposable
    partial included.  ``counts`` is ``[P]``."""
    cols: Dict[str, Any] = {}
    for k, v in columns.items():
        if isinstance(v, tuple):
            cols[k] = StringColumn(_tensor(v[0], np.uint8, device),
                                   _tensor(v[1], np.int32, device))
        else:
            cols[k] = _tensor(v, None, device)
    count = _tensor(counts, np.int32, device)
    return PData(Batch(cols, count), int(count.shape[0]))


def pdata_to_numpy(pd: PData) -> Tuple[Dict[str, Any], np.ndarray]:
    """PData -> (columns, counts) in ``pdata_from_numpy``'s layout."""
    cols: Dict[str, Any] = {}
    for k, v in pd.batch.columns.items():
        if isinstance(v, StringColumn):
            cols[k] = (v.data.cpu().numpy(), v.lengths.cpu().numpy())
        else:
            cols[k] = v.cpu().numpy()
    return cols, pd.counts.cpu().numpy()


def shrink_bucket_cap(counts: np.ndarray, cap: int,
                      min_capacity: int = 1024,
                      waste_factor: int = 4) -> int | None:
    """Shrink-before-collect policy: pow2 bucket >= max count when the
    capacity is grossly oversized, else None (no shrink)."""
    max_n = int(counts.max()) if counts.size else 0
    if cap <= min_capacity or cap <= waste_factor * max(max_n, 1):
        return None
    bucket = 1
    while bucket < max(max_n, 1):
        bucket *= 2
    return min(bucket, cap)


def shrink_pdata(pd: PData, new_cap: int) -> PData:
    """Reduce per-partition capacity (on the device) before the host
    transfer; new_cap must cover max(counts)."""
    return PData(pd.batch.map(lambda x: x[:, :new_cap]), pd.nparts)


def maybe_shrink_for_collect(pd: PData, config, mesh=None) -> PData:
    """``pd`` at the shrunk capacity when it is grossly oversized.  On a
    gang ``mesh`` the decision reads every partition's count (ONE
    all-gather), so every rank shrinks alike."""
    counts = pd.counts if mesh is None else mesh.gather_parts(pd.counts)
    new_cap = shrink_bucket_cap(counts.cpu().numpy(), pd.capacity,
                                config.collect_shrink_min_capacity,
                                config.collect_shrink_waste_factor)
    return pd if new_cap is None else shrink_pdata(pd, new_cap)


def pdata_to_host(pd: PData) -> Dict[str, Any]:
    """Collect valid rows to the host, partition order preserved."""
    cols, counts = pdata_to_numpy(pd)
    out: Dict[str, Any] = {}
    for k, v in cols.items():
        if isinstance(v, tuple):
            data, lens = v
            vals: List[bytes] = []
            for p in range(pd.nparts):
                n = int(counts[p])
                vals.extend(unpack_rows(data[p, :n], lens[p, :n]))
            out[k] = vals
        else:
            out[k] = np.concatenate(
                [v[p, :counts[p]] for p in range(pd.nparts)], axis=0)
    return out
