"""Columnar record batches with static capacity, as torch tensors.

The PyTorch counterpart of ``dryad_tpu/data/columnar.py``.  A dataset
partition is a ``Batch``:

* every column is a fixed-capacity tensor whose leading dim is the row
  capacity,
* ``count`` (a 0-d int32 tensor on the batch's device) says how many
  leading rows are valid; rows past ``count`` are padding with
  unspecified contents,
* a variable-length bytes column is a ``StringColumn``: a padded
  ``[capacity, max_len] uint8`` matrix plus a ``[capacity] int32`` length
  vector.

The host-side packing helpers (``pack_bytes_list`` / ``unpack_rows``) are
the numpy forms of the reference package's native string packing; the
port keeps its own copy so it never imports the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from dryad_tpu_torch.parallel.mesh import resolve_device

__all__ = ["StringColumn", "Batch", "batch_from_numpy", "batch_to_numpy",
           "pack_bytes_list", "unpack_rows", "string_column_from_list"]


@dataclasses.dataclass
class StringColumn:
    """``data[i, :lengths[i]]`` are the bytes of row ``i``."""

    data: torch.Tensor      # [capacity, max_len] uint8
    lengths: torch.Tensor   # [capacity] int32

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    @property
    def max_len(self) -> int:
        return self.data.shape[1]


Column = Any  # torch.Tensor | StringColumn


def map_column(col: Column, fn) -> Column:
    """Apply a tensor function to every leaf of a column."""
    if isinstance(col, StringColumn):
        return StringColumn(fn(col.data), fn(col.lengths))
    return fn(col)


@dataclasses.dataclass
class Batch:
    """A fixed-capacity columnar record batch.

    Invariants: all columns share the leading dimension (the capacity);
    ``count`` is an int32 scalar tensor with 0 <= count <= capacity; rows
    at index >= count are padding with unspecified contents."""

    columns: Dict[str, Column]
    count: torch.Tensor

    @property
    def capacity(self) -> int:
        for c in self.columns.values():
            return c.capacity if isinstance(c, StringColumn) else c.shape[0]
        raise ValueError("Batch has no columns")

    @property
    def device(self) -> torch.device:
        return self.count.device

    @property
    def names(self) -> List[str]:
        return list(self.columns)

    def valid_mask(self) -> torch.Tensor:
        """[capacity] bool — True for valid rows."""
        return torch.arange(self.capacity, dtype=torch.int32,
                            device=self.device) < self.count

    def map(self, fn) -> "Batch":
        """Apply a tensor function to every column leaf (not the count)."""
        return Batch({k: map_column(v, fn) for k, v in self.columns.items()},
                     self.count)

    def with_columns(self, new: Mapping[str, Column]) -> "Batch":
        """These columns added (or replaced), the count kept."""
        cols = dict(self.columns)
        cols.update(new)
        return Batch(cols, self.count)

    def with_count(self, count) -> "Batch":
        return Batch(self.columns, torch.as_tensor(count, dtype=torch.int32,
                                                   device=self.device))

    def pad_to(self, capacity: int) -> "Batch":
        """Grow (or keep) capacity; padding rows are zeros."""
        cur = self.capacity
        if capacity == cur:
            return self
        if capacity < cur:
            raise ValueError(f"pad_to smaller than capacity ({capacity} < "
                             f"{cur})")
        extra = capacity - cur

        def pad(x):
            return torch.cat([x, x.new_zeros((extra,) + tuple(x.shape[1:]))])
        return self.map(pad)

    def gather(self, idx: torch.Tensor, count=None) -> "Batch":
        """Row gather; ``idx`` is [new_capacity] int32/int64.  Keeps the
        count unless one is given."""
        return Batch(self.map(lambda x: x.index_select(0, idx)).columns,
                     self.count if count is None else
                     torch.as_tensor(count, dtype=torch.int32,
                                     device=self.device))


# -- host-side packing (numpy) ------------------------------------------------


def _as_bytes(items: Sequence) -> List[bytes]:
    return [x.encode() if isinstance(x, str) else bytes(x) for x in items]


def pack_bytes_list(items: Sequence[bytes], max_len: int, capacity: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Pack byte strings into padded (data [capacity, max_len] u8, lens
    [capacity] i32); longer strings are truncated to ``max_len``.  One
    vectorized scatter of the concatenated bytes, no per-row loop."""
    n = len(items)
    if n > capacity:
        raise ValueError(f"{n} items > capacity {capacity}")
    data = np.zeros((capacity, max_len), np.uint8)
    lens = np.zeros((capacity,), np.int32)
    if n == 0:
        return data, lens
    full = np.fromiter((len(b) for b in items), np.int64, n)
    flat = np.frombuffer(b"".join(items), np.uint8)
    starts = np.concatenate([[0], np.cumsum(full)[:-1]])
    row = np.repeat(np.arange(n), full)
    col = np.arange(flat.shape[0]) - np.repeat(starts, full)
    keep = col < max_len
    data[row[keep], col[keep]] = flat[keep]
    lens[:n] = np.minimum(full, max_len)
    return data, lens


def unpack_rows(data: np.ndarray, lens: np.ndarray) -> List[bytes]:
    """Padded byte matrix -> list of per-row bytes."""
    n, L = data.shape
    cl = np.clip(lens[:n].astype(np.int64), 0, L)
    packed = data[np.arange(L)[None, :] < cl[:, None]].tobytes()
    offs = np.concatenate([[0], np.cumsum(cl)])
    return [packed[offs[i]:offs[i + 1]] for i in range(n)]


def string_column_from_list(strings: Sequence, capacity: int, max_len: int,
                            device) -> StringColumn:
    data, lens = pack_bytes_list(_as_bytes(strings), max_len, capacity)
    return StringColumn(torch.from_numpy(data).to(device),
                        torch.from_numpy(lens).to(device))


def _is_string_list(v, n: int) -> bool:
    return isinstance(v, (list, tuple)) and (
        n == 0 or isinstance(v[0], (str, bytes)))


def batch_from_numpy(columns: Mapping[str, Any], capacity: int | None = None,
                     str_max_len: int = 64, device="cuda") -> Batch:
    """Build a Batch from host data on ``device`` (CUDA unless the caller
    asks for the CPU).  Lists of str/bytes become StringColumns;
    everything else goes through ``np.asarray``."""
    n = None
    for v in columns.values():
        n = len(v)
        break
    if n is None:
        raise ValueError("no columns")
    cap = capacity or n
    device = resolve_device(device)
    cols: Dict[str, Column] = {}
    for k, v in columns.items():
        if len(v) != n:
            raise ValueError("ragged column lengths")
        if _is_string_list(v, n):
            cols[k] = string_column_from_list(v, cap, str_max_len, device)
        else:
            arr = np.asarray(v)
            pad = [(0, cap - n)] + [(0, 0)] * (arr.ndim - 1)
            cols[k] = torch.from_numpy(np.pad(arr, pad)).to(device)
    return Batch(cols, torch.tensor(n, dtype=torch.int32, device=device))


def batch_to_numpy(batch: Batch) -> Dict[str, Any]:
    """Valid rows of a Batch on the host (numpy arrays / byte lists)."""
    n = int(batch.count)
    out: Dict[str, Any] = {}
    for k, v in batch.columns.items():
        if isinstance(v, StringColumn):
            out[k] = unpack_rows(v.data[:n].cpu().numpy(),
                                 v.lengths[:n].cpu().numpy())
        else:
            out[k] = v[:n].cpu().numpy()
    return out
