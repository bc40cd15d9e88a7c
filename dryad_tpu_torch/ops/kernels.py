"""Per-partition operator kernels over columnar Batches — the subset of
``dryad_tpu/ops/kernels.py`` that the WordCount path runs.

Idioms carried over from the JAX package:
  * validity is a prefix: ``count`` valid rows, then padding;
  * group-by = 64-bit key hash (or an exact 32-bit order lane for a
    single dense key) -> sort -> segment boundaries -> boundary-carry
    aggregation (one prefix sum, adjacent differences on the dense
    group-end rows).

What changes in PyTorch: ``jax.lax.sort`` with several keys and carried
values becomes an argsort of one folded int64 key (two 32-bit lanes
``(k0 - 2**31) << 32 | k1`` order exactly like the pair) or a chain of
stable argsorts, followed by ``index_select`` of whatever rides along.
32-bit lanes are int64 tensors in [0, 2**32) (see ``ops/hashing``);
packed rows are int32 word matrices ``[cap, W]``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import torch

from dryad_tpu_torch.data.columnar import Batch, StringColumn
from dryad_tpu_torch.ops.hashing import (M32, canon_zero, from_u32,
                                         hash_batch_keys, to_u32)
from dryad_tpu_torch.ops.hopper_kernels import prefix_sum

__all__ = ["group_aggregate", "mean_finalize_columns", "AGG_KINDS",
           "NotPortedYet"]

AGG_KINDS = ("sum", "count", "min", "max", "mean", "any", "all")

_SIGN = 0x80000000


class NotPortedYet(NotImplementedError):
    """A part of the JAX package that a later slice of the port brings."""

    def __init__(self, what: str, slice_name: str):
        super().__init__(f"{what} is not ported yet; it comes with the "
                         f"{slice_name} slice (ROADMAP.md)")


# ---------------------------------------------------------------------------
# packed row transport: columns <-> one int32 word matrix [cap, W]


def _pack_columns_u32(cols: Dict[str, Any]) -> Tuple[torch.Tensor, List]:
    """Columns -> int32 word matrix [cap, W] (the 32-bit words' bits) +
    a reassembly spec.  Strings pack 4 bytes a word little-endian (the
    JAX bitcast layout) plus a length word."""
    parts: List[torch.Tensor] = []
    spec: List[Tuple] = []
    for name, v in cols.items():
        if isinstance(v, StringColumn):
            L = v.max_len
            L4 = -(-L // 4) * 4
            d = v.data
            if L4 != L:
                d = torch.nn.functional.pad(d, (0, L4 - L))
            w = d.contiguous().view(torch.int32)          # [cap, L4/4]
            parts.append(w)
            parts.append(v.lengths.to(torch.int32)[:, None])
            spec.append((name, "str", L, w.shape[1] + 1))
        else:
            tail = tuple(v.shape[1:])
            flat = v.reshape(v.shape[0], -1)
            size = flat.element_size()
            if size == 4:
                w = flat.contiguous().view(torch.int32)
            elif size == 8:
                w = flat.contiguous().view(torch.int32)   # 2 words each
            elif size == 2:
                # bit-level widening: a numeric cast would round halves
                w = flat.contiguous().view(torch.int16).to(torch.int32) \
                    & 0xFFFF
            else:   # bool / u8 / i8 round-trip through a numeric cast
                w = flat.to(torch.int32)
            parts.append(w)
            spec.append((name, "dense", (v.dtype, tail), w.shape[1]))
    return torch.cat(parts, dim=1), spec


def _unpack_columns_u32(words: torch.Tensor, spec: List) -> Dict[str, Any]:
    cols: Dict[str, Any] = {}
    i = 0
    n = words.shape[0]
    for name, kind, meta, k in spec:
        w = words[:, i:i + k]
        i += k
        if kind == "str":
            L = meta
            data = w[:, :-1].contiguous().view(torch.uint8)[:, :L]
            cols[name] = StringColumn(data.contiguous(),
                                      w[:, -1].contiguous())
        else:
            dtype, tail = meta
            size = torch.empty((), dtype=dtype).element_size()
            if size in (4, 8):
                flat = w.contiguous().view(dtype)
            elif size == 2:
                flat = w.to(torch.int16).view(dtype)
            else:
                flat = w.to(dtype)
            cols[name] = flat.reshape((n,) + tail) if tail else flat[:, 0]
    return cols


# ---------------------------------------------------------------------------
# segment machinery


def _lane_differs(*lanes: torch.Tensor) -> torch.Tensor:
    """Per-row "key differs from the previous row" over sorted key lanes
    (row 0 always True)."""
    d = None
    for l in lanes:
        dl = l[1:] != l[:-1]
        d = dl if d is None else (d | dl)
    one = torch.ones(1, dtype=torch.bool, device=lanes[0].device)
    return torch.cat([one, d])


def _sentinel_fold(hi: torch.Tensor, lo: torch.Tensor, valid: torch.Tensor):
    """Fold invalid rows to the all-ones 64-bit hash so they sort last."""
    return (torch.where(valid, hi, M32), torch.where(valid, lo, M32))


def _segment_flags(differs: torch.Tensor, n_valid):
    """First/last row of each segment among the valid prefix of sorted
    rows, and the number of segments."""
    cap = differs.shape[0]
    idx = torch.arange(cap, dtype=torch.int32, device=differs.device)
    svalid = idx < n_valid
    is_start = svalid & differs
    one = torch.ones(1, dtype=torch.bool, device=differs.device)
    nxt_start = torch.cat([is_start[1:], one])
    is_end = svalid & (nxt_start | (idx + 1 == n_valid))
    num_groups = is_start.sum(dtype=torch.int32)
    return is_start, is_end, num_groups


def _sort_order(key_lanes: Sequence[torch.Tensor],
                stable: bool = True) -> torch.Tensor:
    """Permutation sorting rows by 32-bit ``key_lanes`` (most significant
    first, each an int64 lane in [0, 2**32)), lexicographically unsigned.
    Pairs of lanes fold into one int64 key; more keys chain stable sorts
    from the least significant pair."""
    keys = list(key_lanes)
    folded: List[torch.Tensor] = []
    while keys:
        if len(keys) >= 2 and len(keys) % 2 == 0:
            k0, k1 = keys[0], keys[1]
            folded.append(((k0 - _SIGN) << 32) | k1)
            keys = keys[2:]
        else:
            folded.append(keys[0])
            keys = keys[1:]
    if len(folded) == 1:
        return torch.sort(folded[0], stable=stable).indices
    order = torch.sort(folded[-1], stable=True).indices
    for k in reversed(folded[:-1]):
        order = order.index_select(
            0, torch.sort(k.index_select(0, order), stable=True).indices)
    return order


def _sort_carrying(key_lanes, values, stable: bool = True):
    """Sort by ``key_lanes`` returning (sorted key lanes, sorted values) —
    the argsort + gather form of the JAX value-carry sort."""
    order = _sort_order(key_lanes, stable)
    return ([k.index_select(0, order) for k in key_lanes],
            [v.index_select(0, order) for v in values])


def _stable_front(flag: torch.Tensor) -> torch.Tensor:
    """Permutation listing the rows where ``flag`` is True first, each
    group in index order (the stable valid-first sort)."""
    return torch.sort((~flag).to(torch.int32), stable=True).indices


def _mask_rows(col, keep: torch.Tensor):
    """Zero rows where ``keep`` is False (strings get zero data+length)."""
    if isinstance(col, StringColumn):
        return StringColumn(torch.where(keep[:, None], col.data, 0),
                            torch.where(keep, col.lengths, 0))
    m = keep.reshape(keep.shape + (1,) * (col.dim() - 1))
    return torch.where(m, col, torch.zeros((), dtype=col.dtype,
                                           device=col.device))


def _shift_fwd(a: torch.Tensor, fill) -> torch.Tensor:
    """[fill, a[0], ..., a[-2]] — previous-row view on dense outputs."""
    return torch.cat([torch.full((1,), fill, dtype=a.dtype, device=a.device),
                      a[:-1]])


# ---------------------------------------------------------------------------
# dense order lanes


def _dense_sort_lane(col: torch.Tensor) -> torch.Tensor:
    """A <= 32-bit dense column as one 32-bit lane whose unsigned order is
    the column's ascending order (the JAX package's _dense_sort_lanes for
    the dtypes _lanes_reconstructible admits)."""
    if col.dtype.is_floating_point:
        bits = to_u32(col.to(torch.float32))
        neg = (bits >> 31) == 1
        return torch.where(neg, bits ^ M32, bits | _SIGN)
    if col.dtype in (torch.int8, torch.int16, torch.int32):
        return (col.to(torch.int64) & M32) ^ _SIGN
    return col.to(torch.int64) & M32      # bool and unsigned


def _lanes_reconstructible(col) -> bool:
    """Can the column be rebuilt exactly from one sort lane?  1-D dense
    <= 32-bit columns other than half floats (their f32 cast is not
    bit-injective on NaN payloads)."""
    if isinstance(col, StringColumn) or col.dim() != 1:
        return False
    return col.dtype not in (torch.int64, torch.uint64, torch.float64,
                             torch.float16, torch.bfloat16)


def _dense_lanes_invert(b: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of _dense_sort_lane."""
    if dtype.is_floating_point:
        neg = (b >> 31) == 0
        bits = torch.where(neg, b ^ M32, b ^ _SIGN)
        return from_u32(bits).view(torch.float32).to(dtype)
    if dtype in (torch.int8, torch.int16, torch.int32):
        return from_u32(b ^ _SIGN).to(dtype)
    if dtype == torch.bool:
        return b != 0
    return b.to(dtype)


def _dense_key_lane(kcol: torch.Tensor) -> torch.Tensor:
    """Order lane of a dense GROUPING key; -0.0 (and subnormals, see
    hashing.canon_zero) group with +0.0."""
    if kcol.dtype.is_floating_point:
        kcol = canon_zero(kcol)
    return _dense_sort_lane(kcol)


def _dense_fast_key(batch: Batch, key_names: Sequence[str]) -> bool:
    """Single <= 32-bit 1-D dense key: group by its exact order lane."""
    return (len(key_names) == 1
            and _lanes_reconstructible(batch.columns[key_names[0]]))


# ---------------------------------------------------------------------------
# group aggregation


def _boundary_eligible(batch: Batch, aggs) -> Tuple[bool, str | None]:
    """Can this agg set run on the boundary-carry path?  (ok, the single
    min/max order column or None)."""
    minmax: set = set()
    for _out, (kind, vname) in aggs.items():
        if kind == "count":
            continue
        col = batch.columns[vname]
        if isinstance(col, StringColumn) or col.dim() != 1:
            return False, None
        if kind in ("sum", "mean"):
            if col.element_size() != 4:
                return False, None
        elif kind in ("min", "max"):
            if not _lanes_reconstructible(col):
                return False, None
            minmax.add(vname)
        elif kind in ("any", "all"):
            pass
        else:
            return False, None
    if len(minmax) > 1:
        return False, None
    return True, (next(iter(minmax)) if minmax else None)


def _matmul_group_eligible(batch: Batch, key_names, aggs) -> bool:
    """The JAX package's gate for its one-hot small-key lowering."""
    if not _dense_fast_key(batch, key_names):
        return False
    kd = batch.columns[key_names[0]].dtype
    if kd.is_floating_point or kd == torch.bool:
        return False
    if batch.capacity >= (1 << 24):
        return False
    for _out, (kind, vname) in aggs.items():
        if kind == "count":
            continue
        if kind not in ("sum", "mean"):
            return False
        col = batch.columns[vname]
        if isinstance(col, StringColumn) or col.dtype != torch.float32:
            return False
    return True


def group_aggregate(batch: Batch, key_names: Sequence[str],
                    aggs: Dict[str, Tuple[str, str | None]]) -> Batch:
    """GroupBy + decomposable aggregation (count, integer sum/mean,
    min/max over one order column, any/all) on the boundary-carry path.

    aggs: out_name -> (kind, value_column | None).  The output batch has
    the key columns (one representative row per group) and one column per
    aggregate; count = number of groups.  The JAX package's small-key and
    segmented-scan lowerings, and f32 sums (its compensated prefix_sum2
    kernel), come with the GroupByReduce slice and raise here."""
    for _o, (kind, _v) in aggs.items():
        if kind not in AGG_KINDS:
            raise ValueError(f"unknown aggregate kind {kind!r}")
    if _matmul_group_eligible(batch, key_names, aggs):
        raise NotPortedYet("the small-key (one-hot) group lowering",
                           "GroupByReduce")
    ok, minmax_col = _boundary_eligible(batch, aggs)
    if not ok:
        raise NotPortedYet("the segmented-scan group lowering",
                           "GroupByReduce")
    for _o, (kind, vname) in aggs.items():
        if kind in ("sum", "mean") and \
                batch.columns[vname].dtype == torch.float32:
            raise NotPortedYet("f32 group sums (prefix_sum2)",
                               "GroupByReduce")
    return _group_aggregate_boundary(batch, key_names, aggs, minmax_col)


def _int_bits(a: torch.Tensor) -> torch.Tensor:
    """A 4-byte integer column's bits as int32 (prefix_sum's dtype)."""
    return a if a.dtype == torch.int32 else from_u32(to_u32(a))


def _group_aggregate_boundary(batch: Batch, key_names: Sequence[str],
                              aggs: Dict[str, Tuple[str, str | None]],
                              minmax_col: str | None) -> Batch:
    """Boundary-carry group aggregation, scan-free:

      * ONE sort by the grouping lanes (+ the min/max order lane, so a
        segment's min sits at its first row and its max at its last);
      * integer sums ride ONE prefix_sum (Hopper kernel) over the sorted,
        masked values; per-group sums are adjacent differences of that
        prefix on the dense group-end rows (exact under 32-bit wrap);
      * counts are adjacent differences of the end rows' sorted index;
      * a stable valid-first sort densifies the segment-end rows."""
    valid = batch.valid_mask()
    cap = batch.capacity
    dev = batch.device
    n_valid = batch.count
    idx = torch.arange(cap, dtype=torch.int32, device=dev)

    kcol0 = batch.columns[key_names[0]]
    dense_fast = _dense_fast_key(batch, key_names)
    if dense_fast:
        key_lanes = [(~valid).to(torch.int64), _dense_key_lane(kcol0)]
    else:
        key_lanes = list(_sentinel_fold(*hash_batch_keys(batch, key_names),
                                        valid))
    if minmax_col is not None:
        key_lanes.append(_dense_sort_lane(batch.columns[minmax_col]))
    order = _sort_order(key_lanes, stable=False)
    skeys = [k.index_select(0, order) for k in key_lanes]
    if dense_fast:
        differs = _lane_differs(skeys[1])
    else:
        differs = _lane_differs(skeys[0], skeys[1])
    _is_start, is_end, num_groups = _segment_flags(differs, n_valid)
    svord = skeys[2] if minmax_col is not None else None
    svalid = idx < n_valid

    # integer prefix sums over the sorted value columns (int32 bits)
    sum_cols: Dict[str, torch.Tensor] = {}
    for _out, (kind, vname) in aggs.items():
        if kind in ("sum", "mean") and vname not in sum_cols:
            sum_cols[vname] = _int_bits(batch.columns[vname])
        elif kind in ("any", "all") and "#i:" + vname not in sum_cols:
            sum_cols["#i:" + vname] = batch.columns[vname].to(torch.int32)
    csums: Dict[str, torch.Tensor] = {}
    for name, v in sum_cols.items():
        sv = v.index_select(0, order)
        csums[name] = prefix_sum(torch.where(svalid, sv, 0))

    # densify segment-END rows to the front, in group order
    dperm = _stable_front(is_end)
    gmask = idx < num_groups
    out_cols: Dict[str, Any] = {}
    if dense_fast:
        out_cols[key_names[0]] = _mask_rows(_dense_lanes_invert(
            skeys[1].index_select(0, dperm), kcol0.dtype), gmask)
    else:
        words, spec = _pack_columns_u32(
            {k: batch.columns[k] for k in key_names})
        kw = words.index_select(0, order.index_select(0, dperm))
        kcols = _unpack_columns_u32(kw, spec)
        for k in key_names:
            out_cols[k] = _mask_rows(kcols[k], gmask)
    if minmax_col is not None:
        mm_dtype = batch.columns[minmax_col].dtype
        vmax = _dense_lanes_invert(svord.index_select(0, dperm), mm_dtype)
        # the order lane of the row after each end = the next group's min
        nxt = torch.cat([svord[1:], svord[-1:]]).index_select(0, dperm)
        vmin = _dense_lanes_invert(_shift_fwd(nxt, 0), mm_dtype)
        v0 = _dense_lanes_invert(svord[:1], mm_dtype)
        vmin = torch.where(idx == 0, v0, vmin)
    dcs: Dict[str, torch.Tensor] = {}
    for name, c in csums.items():
        c = to_u32(c.index_select(0, dperm))
        d = from_u32((c - _shift_fwd(c, 0)) & M32)
        v = batch.columns[name[3:]] if name.startswith("#i:") \
            else batch.columns[name]
        dcs[name] = d if name.startswith("#i:") or v.dtype == torch.int32 \
            else d.view(v.dtype)
    didx = dperm.to(torch.int32)
    cnt_g = didx - _shift_fwd(didx, -1)

    for out_name, (kind, vname) in aggs.items():
        if kind == "count":
            o = cnt_g
        elif kind == "sum":
            o = dcs[vname]
        elif kind == "mean":
            o = dcs[vname].to(torch.float32) / torch.clamp(cnt_g, min=1)
        elif kind == "min":
            o = vmin
        elif kind == "max":
            o = vmax
        elif kind == "any":
            o = dcs["#i:" + vname] > 0
        else:   # all
            o = dcs["#i:" + vname] == cnt_g
        out_cols[out_name] = _mask_rows(o, gmask)
    return Batch(out_cols, num_groups)


def mean_finalize_columns(cols: dict, mean_cols: Sequence[str]) -> dict:
    """Finalize decomposed means: replace {m}__sum/{m}__cnt partial columns
    with their quotient."""
    out = dict(cols)
    for m in mean_cols:
        s = out.pop(m + "__sum")
        c = out.pop(m + "__cnt")
        cf = torch.clamp(c, min=1).reshape(c.shape + (1,) * (s.dim() - 1))
        out[m] = s / cf.to(s.dtype) if s.dtype.is_floating_point \
            else s.to(torch.float32) / cf
    return out
