"""Abstract domain of the static cost model (``analysis/cost.py``) — the
port of ``dryad_tpu/analysis/domain.py``.

The cost interpreter propagates two things over the plan:

* an :class:`Interval` of TOTAL valid row counts (lo certain, hi a sound
  upper bound, ``None`` = unbounded);
* a concrete column schema (:class:`ColSpec` per column) with the static
  per-partition capacity.  Every batch is a fixed-shape padded tensor,
  so when the schema is known the bytes of a stage output are KNOWN:
  ``nparts * (capacity * row_bytes + 4)`` is what the executor measures
  as ``out_bytes`` (every leaf's ``numel * element_size`` over the
  ``[P, cap, ...]`` batch, the int32 count vector included).

The byte formula is the port's own: its column dtypes (int64, float64
and bool are kept, where the JAX package, with x64 off, narrows the
64-bit ones), its string layout (``[cap, max_len]`` uint8 data and
``[cap]`` int32 lengths) and its count.  Schemas propagate through the
port's ops and user callables by running them on tensors on
``torch.device("meta")`` (:func:`abstract_batch`): shapes and dtypes
only, zero bytes, zero FLOPs, nothing on the card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

__all__ = ["Interval", "ColSpec", "AbsState", "schema_row_bytes",
           "schema_from_columns", "abstract_batch", "schema_of_abstract",
           "part_bytes", "out_bytes", "fmt_bytes"]

# the executor materializes the [P] int32 count vector with every batch
_COUNT_BYTES_PER_PART = 4
META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class Interval:
    """Integer interval [lo, hi]; ``hi=None`` means unbounded above.
    ``lo`` is a certain lower bound, ``hi`` a sound upper bound."""

    lo: int = 0
    hi: Optional[int] = None

    @staticmethod
    def exact(v: int) -> "Interval":
        return Interval(int(v), int(v))

    @staticmethod
    def upto(hi: Optional[int]) -> "Interval":
        return Interval(0, None if hi is None else int(hi))

    @property
    def bounded(self) -> bool:
        return self.hi is not None

    def __add__(self, other: "Interval") -> "Interval":
        hi = (None if self.hi is None or other.hi is None
              else self.hi + other.hi)
        return Interval(self.lo + other.lo, hi)

    def scale(self, k: int) -> "Interval":
        return Interval(self.lo * k,
                        None if self.hi is None else self.hi * k)

    def mul(self, other: "Interval") -> "Interval":
        hi = (None if self.hi is None or other.hi is None
              else self.hi * other.hi)
        return Interval(self.lo * other.lo, hi)

    def clamp_hi(self, cap: Optional[int]) -> "Interval":
        """Intersect with [0, cap] (a capacity bound)."""
        if cap is None:
            return self
        hi = cap if self.hi is None else min(self.hi, cap)
        return Interval(min(self.lo, hi), hi)

    def relax_lo(self) -> "Interval":
        """Drop the lower bound (ops that may shed rows)."""
        return Interval(0, self.hi)

    def contains(self, v: int) -> bool:
        return v >= self.lo and (self.hi is None or v <= self.hi)

    def union(self, other: "Interval") -> "Interval":
        hi = (None if self.hi is None or other.hi is None
              else max(self.hi, other.hi))
        return Interval(min(self.lo, other.lo), hi)

    def as_tuple(self) -> Tuple[int, Optional[int]]:
        return (self.lo, self.hi)


@dataclasses.dataclass(frozen=True)
class ColSpec:
    """Static description of one column's device representation.

    * dense: ``[capacity, *shape]`` of torch dtype ``dtype`` (its name:
      "int32", "float32", "int64", "bool", ...) — row_bytes = itemsize x
      prod(shape);
    * str: ``[capacity, repeat?, max_len]`` uint8 data + int32 lengths —
      row_bytes = repeat x (max_len + 4).

    ``repeat`` models window axes (sliding_window) on either kind.
    """

    kind: str                      # "dense" | "str"
    dtype: str = "int32"
    shape: Tuple[int, ...] = ()
    max_len: int = 0
    repeat: int = 1

    @property
    def row_bytes(self) -> int:
        if self.kind == "str":
            return self.repeat * (self.max_len + 4)
        n = 1
        for d in self.shape:
            n *= int(d)
        return self.repeat * getattr(torch, self.dtype).itemsize * n


Schema = Dict[str, ColSpec]


def schema_row_bytes(schema: Schema) -> int:
    return sum(c.row_bytes for c in schema.values())


def part_bytes(schema: Schema, capacity: int) -> int:
    """Device bytes of ONE partition of a materialized batch."""
    return capacity * schema_row_bytes(schema) + _COUNT_BYTES_PER_PART


def out_bytes(schema: Schema, capacity: int, nparts: int) -> int:
    """Exact bytes of a [P, cap, ...] stage output: the number the
    executor reports as ``out_bytes``."""
    return nparts * part_bytes(schema, capacity)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def schema_from_columns(columns: Dict[str, Any],
                        lead_dims: int = 1) -> Schema:
    """From a Batch's columns (tensors or StringColumns, on any device,
    meta included).  ``lead_dims``: leading dims before the per-row shape
    (1 for a partition's [cap, ...], 2 for a stacked PData's
    [P, cap, ...])."""
    out: Schema = {}
    for k, v in columns.items():
        data = getattr(v, "data", None)
        if isinstance(data, torch.Tensor) and hasattr(v, "lengths"):
            # StringColumn: data [..., cap, (repeat,) max_len]
            rep = 1
            for d in data.shape[lead_dims:-1]:
                rep *= int(d)
            out[k] = ColSpec("str", max_len=int(data.shape[-1]),
                             repeat=rep)
        else:
            out[k] = ColSpec("dense", dtype=_dtype_name(v.dtype),
                             shape=tuple(int(d)
                                         for d in v.shape[lead_dims:]))
    return out


def abstract_batch(schema: Schema, capacity: int):
    """A partition's Batch of tensors on the meta device: the abstract
    value a stage op is run over (shapes and dtypes, no data).  Window
    (repeat > 1) columns are not rebuilt; the model treats the UDFs
    after a window as approximate."""
    from dryad_tpu_torch.data.columnar import Batch, StringColumn
    cols: Dict[str, Any] = {}
    for k, spec in schema.items():
        mid = () if spec.repeat == 1 else (spec.repeat,)
        if spec.kind == "str":
            cols[k] = StringColumn(
                torch.empty((capacity,) + mid + (spec.max_len,),
                            dtype=torch.uint8, device=META),
                torch.empty((capacity,) + mid, dtype=torch.int32,
                            device=META))
        else:
            cols[k] = torch.empty((capacity,) + mid + spec.shape,
                                  dtype=getattr(torch, spec.dtype),
                                  device=META)
    return Batch(cols, torch.empty((), dtype=torch.int32, device=META))


def schema_of_abstract(batch_or_cols: Any) -> Tuple[Schema, int]:
    """(schema, capacity) of an op's result on meta tensors — a Batch or
    a columns dict."""
    cols = getattr(batch_or_cols, "columns", batch_or_cols)
    schema = schema_from_columns(cols, lead_dims=1)
    cap = 0
    for v in cols.values():
        data = getattr(v, "data", None)
        lead = data if isinstance(data, torch.Tensor) else v
        cap = int(lead.shape[0])
        break
    return schema, cap


@dataclasses.dataclass
class AbsState:
    """Abstract value of one dataflow edge: total valid rows across all
    partitions, the static per-partition capacity, and (when known) the
    concrete column schema.  ``approx`` marks a state whose schema could
    not be derived (an opaque UDF, an unknown source): byte predictions
    downstream of it are reported unbounded instead of wrong."""

    rows: Interval
    capacity: int
    schema: Optional[Schema] = None
    approx: bool = False
    notes: List[str] = dataclasses.field(default_factory=list)

    def rows_clamped(self, nparts: int) -> Interval:
        return self.rows.clamp_hi(
            self.capacity * nparts if self.capacity else None)

    def part_bytes(self) -> Optional[int]:
        if self.schema is None:
            return None
        return part_bytes(self.schema, self.capacity)

    def note(self, msg: str) -> "AbsState":
        if msg not in self.notes:
            self.notes.append(msg)
        return self


def fmt_bytes(b: Optional[float]) -> str:
    if b is None:
        return "?"
    if b == 0:
        return "0"
    units = ["B", "KiB", "MiB", "GiB", "TiB"]
    i = min(int(math.log(max(b, 1), 1024)), len(units) - 1)
    v = b / (1024 ** i)
    return f"{v:.0f}{units[i]}" if v >= 10 else f"{v:.1f}{units[i]}"
