"""Per-partition operator kernels over columnar Batches — the subset of
``dryad_tpu/ops/kernels.py`` that the WordCount, GroupByReduce, TeraSort
and PageRank paths run: compaction (``where``), group aggregation in its
three lowerings, user-defined decomposable aggregation, the sort lanes
and ``sort_by_columns``, ``take``, ``distinct``, the group-contents
operators ``group_top_k`` / ``group_rank_select`` and the general
per-group selector ``group_regroup_apply``, the generic SelectMany
``flat_map_expand``, the equi-join ``hash_join`` (inner and left, with
the lookup-table form), the set operators' ``semi_anti_join`` and
``concat2``, and ``scalar_aggregate``.

Idioms carried over from the JAX package:
  * validity is a prefix: ``count`` valid rows, then padding;
  * compaction = stable sort of the drop mask;
  * group-by = 64-bit key hash (or an exact 32-bit order lane for a
    single dense key) -> sort -> segment boundaries -> segment reduces:
    boundary-carry (one prefix sum, adjacent differences on the dense
    group-end rows), a segmented associative scan, or, for small-span
    integer keys, one one-hot matrix product.

What changes in PyTorch: ``jax.lax.sort`` with several keys and carried
values becomes an argsort of one folded int64 key (two 32-bit lanes
``(k0 - 2**31) << 32 | k1`` order exactly like the pair) or a chain of
stable argsorts, followed by ``index_select`` of whatever rides along.
32-bit lanes are int64 tensors in [0, 2**32) (see ``ops/hashing``);
packed rows are int32 word matrices ``[cap, W]``.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

from dryad_tpu_torch.data.columnar import Batch, StringColumn, map_column
from dryad_tpu_torch.ops.hashing import (M32, canon_zero, from_u32,
                                         hash_batch_keys, mul32, to_u32)
from dryad_tpu_torch.ops.hopper_kernels import prefix_sum, prefix_sum2
from dryad_tpu_torch.ops.scan import associative_scan

__all__ = ["compact", "filter_rows", "permute_by_sort", "take",
           "searchsorted_small", "sort_lanes_for", "sort_by_columns",
           "group_aggregate", "group_decompose_partial",
           "group_decompose_merge", "group_decompose_local",
           "resolve_dec_spec", "distinct", "group_top_k",
           "group_rank_select", "group_regroup_apply", "flat_map_expand",
           "mean_finalize_columns", "AGG_KINDS",
           "canon_nan", "minimum", "maximum",
           "searchsorted_big", "hash_join", "lookup_join", "general_join",
           "semi_anti_join", "concat2", "zip2", "scalar_aggregate"]

AGG_KINDS = ("sum", "count", "min", "max", "mean", "any", "all")

_SIGN = 0x80000000


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
                # an empty slice keeps its offset (odd for a 64-bit
                # column after an odd number of words): fresh storage
                flat = (w.contiguous() if n else w.new_empty(w.shape)
                        ).view(dtype)
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


def _sort_segments_carry(hi: torch.Tensor, lo: torch.Tensor,
                         valid: torch.Tensor, n_valid):
    """Hash segmentation: an unstable sort of the rows by the 64-bit hash
    (invalid rows fold to the all-ones sentinel and sort last; nothing
    downstream reads the order of rows within a segment).  Returns
    (order, is_start, is_end, num_groups) over the sorted rows; callers
    gather what rides along with ``order``."""
    hi_s, lo_s = _sentinel_fold(hi, lo, valid)
    order = _sort_order([hi_s, lo_s], stable=False)
    return (order,) + _segment_flags(
        _lane_differs(hi_s.index_select(0, order),
                      lo_s.index_select(0, order)), n_valid)


def _sort_segments_dense(key_lane: torch.Tensor, valid: torch.Tensor,
                         n_valid):
    """Dense-key segmentation by the EXACT 32-bit order lane of a single
    key, an explicit invalid flag most significant (a real key may hit
    the all-ones lane, so no sentinel fold).  Unstable: no caller reads
    the in-segment order.  Returns (order, sorted key lane, is_start,
    is_end, num_groups)."""
    order = _sort_order([(~valid).to(torch.int64), key_lane], stable=False)
    skey = key_lane.index_select(0, order)
    return (order, skey) + _segment_flags(_lane_differs(skey), n_valid)


def _hash_sort_segments(hi: torch.Tensor, lo: torch.Tensor,
                        valid: torch.Tensor,
                        extra_lanes: Sequence[torch.Tensor] = ()):
    """Stable sort by 64-bit hash (invalid rows last); equal-hash runs of
    valid rows are segments.  ``extra_lanes`` order rows WITHIN a segment
    and are given LEAST significant first, as the JAX package's
    ``jnp.lexsort`` takes them (``_sort_order`` wants them most
    significant first, so they are reversed here).  Returns (order, seg,
    is_start, num_groups); seg is n for invalid rows.  Keys colliding in
    all 64 bits merge — P ~ n^2 / 2^64, as in the JAX package."""
    n = hi.shape[0]
    hi_s, lo_s = _sentinel_fold(hi, lo, valid)
    order = _sort_order([hi_s, lo_s] + list(extra_lanes)[::-1])
    svalid = valid.index_select(0, order)
    is_start = svalid & _lane_differs(hi_s.index_select(0, order),
                                      lo_s.index_select(0, order))
    seg = torch.cumsum(is_start.to(torch.int32), 0, dtype=torch.int32) - 1
    seg = torch.where(svalid, seg, n)
    return order, seg, is_start, is_start.sum(dtype=torch.int32)


def _group_segments(batch: Batch, key_names: Sequence[str]):
    """Sort the batch by key hash: (sorted batch, seg, is_start,
    num_groups)."""
    hi, lo = hash_batch_keys(batch, key_names)
    order, seg, is_start, num_groups = _hash_sort_segments(
        hi, lo, batch.valid_mask())
    return batch.gather(order), seg, is_start, num_groups


def _segments_by_keys_and_lanes(batch: Batch, key_names: Sequence[str],
                                extra_lanes: Sequence[torch.Tensor]):
    """_hash_sort_segments by the keys' hash, rows ordered within a
    segment by ``extra_lanes`` (least significant first)."""
    hi, lo = hash_batch_keys(batch, key_names)
    return _hash_sort_segments(hi, lo, batch.valid_mask(), extra_lanes)


def _segment_bounds(is_start: torch.Tensor, num_groups, n_valid):
    """(start_pos, end_excl) of each segment over segment-sorted rows: the
    g-th True of ``is_start`` starts segment g, and segments tile the
    valid prefix.  Slots past num_groups hold no segment."""
    cap = is_start.shape[0]
    start_pos = _stable_front(is_start)
    idx = torch.arange(cap, device=is_start.device)
    end_excl = torch.where(idx + 1 < num_groups, torch.roll(start_pos, -1),
                           n_valid)
    return start_pos, end_excl


def _segment_rows(is_start: torch.Tensor, num_groups, n_valid):
    """(first, last) sorted row index of each segment; 0 past
    num_groups."""
    start_pos, end_excl = _segment_bounds(is_start, num_groups, n_valid)
    idx = torch.arange(is_start.shape[0], device=is_start.device)
    live = idx < num_groups
    return (torch.where(live, start_pos, 0),
            torch.where(live, torch.clamp(end_excl - 1, min=0), 0))


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
# sort lanes: a column as 32-bit lanes (most significant first) whose
# unsigned lexicographic order is the column's order.  Lanes are int64 in
# [0, 2**32), so the JAX package's ``~l`` for a descending lane is
# ``l ^ M32`` here (``~l`` on int64 would go negative and sort first).


_SIGNED_INTS = (torch.int8, torch.int16, torch.int32)


def searchsorted_small(bounds: torch.Tensor, q: torch.Tensor,
                       side: str = "left") -> torch.Tensor:
    """Insertion points of ``q`` in a SMALL sorted ``bounds`` (partition
    split points): one ``torch.searchsorted``; int32."""
    if bounds.numel() == 0:
        return torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    return torch.searchsorted(bounds, q, right=(side == "right")).to(
        torch.int32)


def _dense_sort_lanes(col: torch.Tensor,
                      descending: bool = False) -> List[torch.Tensor]:
    """A dense column's sort lanes.  Floats go through an f32 cast (so
    float64 keys order as their f32 values) and the sign-flip total
    order: -NaN < -inf < ... < -0.0 < +0.0 < ... < +inf < +NaN.  64-bit
    integers take two lanes, (hi ^ sign, lo)."""
    if col.dtype.is_floating_point:
        bits = to_u32(col.to(torch.float32))
        neg = (bits >> 31) == 1
        lanes = [torch.where(neg, bits ^ M32, bits | _SIGN)]
    elif col.dtype in (torch.int64, torch.uint64):
        u = col.view(torch.int64)
        hi = (u >> 32) & M32
        if col.dtype == torch.int64:
            hi = hi ^ _SIGN
        lanes = [hi, u & M32]
    elif col.dtype in _SIGNED_INTS:
        lanes = [(col.to(torch.int64) & M32) ^ _SIGN]
    else:                                  # bool and unsigned
        lanes = [col.to(torch.int64) & M32]
    if descending:
        lanes = [l ^ M32 for l in lanes]
    return lanes


def _string_fold_len(max_len: int) -> bool:
    """Does a string column's length fold into its last lane's pad bytes
    (at least two of them spare)?"""
    return (-max_len) % 4 >= 2 and max_len <= 0xFFFF


def _string_sort_lanes(col: StringColumn,
                       descending: bool = False) -> List[torch.Tensor]:
    """Lexicographic byte order as lanes of 4 bytes each, big-endian
    (``b0 << 24 | b1 << 16 | b2 << 8 | b3``: NOT the little-endian packed
    transport words).  Bytes past a row's length are masked to 0, so a
    shorter string sorts first among equal prefixes, the length breaking
    the tie: folded as a u16 into the last lane's spare pad bytes when
    there are two or more (L = 10, TeraSort: 3 lanes), else a lane of its
    own (L = 11, 12)."""
    L = col.max_len
    dev = col.data.device
    mask = torch.arange(L, device=dev)[None, :] < col.lengths[:, None]
    b = torch.where(mask, col.data, 0).to(torch.int64)
    pad = (-L) % 4
    lens = col.lengths.to(torch.int64) & M32
    fold = _string_fold_len(L)
    if fold:
        parts = [b, (lens >> 8)[:, None], (lens & 0xFF)[:, None]]
        if pad == 3:
            parts.append(torch.zeros_like(lens)[:, None])
        b = torch.cat(parts, dim=1)
    elif pad:
        b = torch.nn.functional.pad(b, (0, pad))
    b4 = b.reshape(b.shape[0], -1, 4)
    w = (b4[..., 0] << 24) | (b4[..., 1] << 16) | (b4[..., 2] << 8) \
        | b4[..., 3]                                        # [cap, lanes]
    lanes = list(w.t().contiguous().unbind(0))
    if not fold:
        lanes.append(lens)
    if descending:
        lanes = [l ^ M32 for l in lanes]
    return lanes


def sort_lanes_for(col, descending: bool = False) -> List[torch.Tensor]:
    if isinstance(col, StringColumn):
        return _string_sort_lanes(col, descending)
    return _dense_sort_lanes(col, descending)


def _lanes_reconstructible(col) -> bool:
    """Can the column be rebuilt exactly from its sort lanes?  Strings
    (byte lanes + length, folded or not) and 1-D dense <= 32-bit columns
    other than half floats (their f32 cast is not bit-injective on NaN
    payloads)."""
    if isinstance(col, StringColumn):
        return True
    if col.dim() != 1:
        return False
    return col.dtype not in (torch.int64, torch.uint64, torch.float64,
                             torch.float16, torch.bfloat16)


def _dense_lanes_invert(b: torch.Tensor, dtype,
                        descending: bool = False) -> torch.Tensor:
    """Inverse of _dense_sort_lanes for the reconstructible dtypes (one
    lane)."""
    if descending:
        b = b ^ M32
    if dtype.is_floating_point:
        neg = (b >> 31) == 0
        bits = torch.where(neg, b ^ M32, b ^ _SIGN)
        return from_u32(bits).view(torch.float32).to(dtype)
    if dtype in _SIGNED_INTS:
        return from_u32(b ^ _SIGN).to(dtype)
    if dtype == torch.bool:
        return b != 0
    return b.to(dtype)


def _string_lanes_invert(lanes: Sequence[torch.Tensor], max_len: int,
                         descending: bool = False) -> StringColumn:
    """Inverse of _string_sort_lanes (folded and separate-length
    layouts).  Rows whose lanes are sentinels come back as garbage: the
    caller masks them."""
    ls = [l ^ M32 for l in lanes] if descending else list(lanes)
    L = max_len
    fold = _string_fold_len(L)
    byte_lanes = ls if fold else ls[:-1]
    w = torch.stack(byte_lanes, dim=1)                     # [cap, nl]
    b4 = torch.stack([(w >> 24) & 0xFF, (w >> 16) & 0xFF, (w >> 8) & 0xFF,
                      w & 0xFF], dim=2)                    # [cap, nl, 4]
    flat = b4.reshape(w.shape[0], -1)
    data = flat[:, :L].to(torch.uint8)
    if fold:
        lens = (flat[:, L] << 8) | flat[:, L + 1]
    else:
        lens = ls[-1]
    return StringColumn(data.contiguous(), from_u32(lens))


def _dense_key_lane(kcol: torch.Tensor) -> torch.Tensor:
    """Order lane of a dense GROUPING key; -0.0 (and subnormals, see
    hashing.canon_zero) group with +0.0."""
    if kcol.dtype.is_floating_point:
        kcol = canon_zero(kcol)
    return _dense_sort_lanes(kcol)[0]


def _dense_fast_key(batch: Batch, key_names: Sequence[str]) -> bool:
    """Single <= 32-bit 1-D dense key: group by its exact order lane."""
    if len(key_names) != 1:
        return False
    col = batch.columns[key_names[0]]
    return not isinstance(col, StringColumn) and _lanes_reconstructible(col)


# ---------------------------------------------------------------------------
# filtering / compaction


def permute_by_sort(batch: Batch, key_lanes: Sequence[torch.Tensor],
                    count=None) -> Batch:
    """Stable sort of the batch's rows by 32-bit ``key_lanes`` (most
    significant first), moving every column along."""
    return batch.gather(_sort_order(list(key_lanes)),
                        batch.count if count is None else count)


def compact(batch: Batch, keep: torch.Tensor) -> Batch:
    """Move the valid rows where ``keep`` to the front, in their order;
    count = the number kept."""
    keep = keep & batch.valid_mask()
    return permute_by_sort(batch, [(~keep).to(torch.int64)],
                           count=keep.sum(dtype=torch.int32))


def filter_rows(batch: Batch, predicate) -> Batch:
    """predicate: dict[str, Column] -> bool[capacity]."""
    return compact(batch, predicate(dict(batch.columns)))


def take(batch: Batch, n) -> Batch:
    """The first ``n`` valid rows of one partition."""
    return Batch(batch.columns, torch.clamp(batch.count, max=n))


# ---------------------------------------------------------------------------
# sorting


def sort_by_columns(batch: Batch, keys: Sequence[Tuple[str, bool]]) -> Batch:
    """Stable sort of the valid rows by (column, descending) keys; padding
    stays at the end.

    Invalid rows: in the TeraSort shape (one ascending string key whose
    length folds into its last lane) every lane of an invalid row is set
    to all-ones, which no valid row reaches (its length bytes are below
    0xFFFF), so no invalid lane is sorted; otherwise an explicit invalid
    lane is the most significant key.  Key columns the lanes determine
    (strings, 1-D dense <= 32-bit) are rebuilt from the sorted lanes, as
    in the JAX package, so their valid rows come out canonical (string
    bytes past the length zero); the other columns are gathered."""
    lanes: List[torch.Tensor] = []
    recon: Dict[str, Tuple[int, int, bool]] = {}
    for name, desc in keys:
        col = batch.columns[name]
        ls = sort_lanes_for(col, desc)
        if name not in recon and _lanes_reconstructible(col):
            recon[name] = (len(lanes), len(ls), desc)
        lanes.extend(ls)
    invalid = ~batch.valid_mask()
    col0 = batch.columns[keys[0][0]]
    if (len(keys) == 1 and not keys[0][1]
            and isinstance(col0, StringColumn)
            and _string_fold_len(col0.max_len)):
        lanes = [torch.where(invalid, M32, l) for l in lanes]
        base = 0
    else:
        lanes = [invalid.to(torch.int64)] + lanes
        base = 1
    order = _sort_order(lanes, stable=True)
    valid_sorted = batch.valid_mask()
    out: Dict[str, Any] = {}
    for name, col in batch.columns.items():
        if name not in recon:
            out[name] = map_column(col, lambda x: x.index_select(0, order))
            continue
        off, cnt, desc = recon[name]
        kl = [l.index_select(0, order)
              for l in lanes[base + off: base + off + cnt]]
        if isinstance(col, StringColumn):
            newcol = _string_lanes_invert(kl, col.max_len, desc)
        else:
            newcol = _dense_lanes_invert(kl[0], col.dtype, desc)
        # padding rows may hold sentinel lanes: zero them
        out[name] = _mask_rows(newcol, valid_sorted)
    return Batch(out, batch.count)


# ---------------------------------------------------------------------------
# group aggregation


def _boundary_eligible(batch: Batch, aggs) -> Tuple[bool, str | None]:
    """Can this agg set run on the boundary-carry path?  (ok, the single
    min/max order column or None).  Sum/mean/any/all columns are 1-D
    4-byte dense; all min/max share ONE 1-D reconstructible column."""
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
    """Static half of the small-key gate: a single integer dense key,
    sums/means over f32 columns only (f32 counts are exact below 2**24
    rows), a partition small enough that counts stay exact."""
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
    """GroupBy + decomposable aggregation.

    aggs: out_name -> (kind, value_column | None), kind in AGG_KINDS.  The
    output batch has the key columns (one representative row per group)
    and one column per aggregate; count = number of groups.

    Lowering, as in the JAX package: small-span integer keys take the
    one-hot product (a runtime span check, _group_aggregate_smallkey);
    else the boundary-carry path when the agg set allows it; else the
    segmented scan (_group_aggregate_scan).

    NaN: the boundary path ranks float min/max by the total order
    -NaN < -inf < ... < +inf < +NaN; the scan path's torch.minimum /
    maximum propagate any NaN to both extremes (jnp.minimum's rule), so
    groups holding NaN answer differently across the two lowerings."""
    for _o, (kind, _v) in aggs.items():
        if kind not in AGG_KINDS:
            raise ValueError(f"unknown aggregate kind {kind!r}")
    ok, minmax_col = _boundary_eligible(batch, aggs)
    if ok:
        fallback = lambda b: _group_aggregate_boundary(  # noqa: E731
            b, key_names, aggs, minmax_col)
    else:
        fallback = lambda b: _group_aggregate_scan(  # noqa: E731
            b, key_names, aggs)
    if _matmul_group_eligible(batch, key_names, aggs):
        return _group_aggregate_smallkey(batch, key_names, aggs, fallback)
    return fallback(batch)


_SMALLKEY_SLOTS = 512      # one-hot width: a key span <= this takes the
                           # product
_SMALLKEY_CHUNK = 16384    # rows per accumulation step (bounds the
                           # [chunk, slots] f32 one-hot at 32 MB)


@contextlib.contextmanager
def _full_f32_matmul():
    """f32 products in full f32 for the duration, whatever the caller set:
    TF32 (or bf16 on the CPU) would round the summed values to a 10-bit
    (8-bit) mantissa."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _group_aggregate_smallkey(batch: Batch, key_names: Sequence[str],
                              aggs: Dict[str, Tuple[str, str | None]],
                              fallback) -> Batch:
    """One-hot group aggregation for small-span integer keys: per-group
    sums are ONE product of the [slots, rows] one-hot with the value
    columns, chunk by chunk (the JAX package's MXU lowering; here a plain
    torch.matmul in full f32).  The span is a runtime property: the JAX
    package branches with lax.cond, the port reads ``use`` on the host —
    one sync per call — and runs the sort ``fallback`` on wide spans."""
    kcol = batch.columns[key_names[0]]
    cap = batch.capacity
    dev = batch.device
    valid = batch.valid_mask()
    S = _SMALLKEY_SLOTS
    if cap == 0:
        return fallback(batch)
    info = torch.iinfo(kcol.dtype)
    kmin = torch.where(valid, kcol, info.max).min().to(torch.int64)
    kmax = torch.where(valid, kcol, info.min).max().to(torch.int64)
    # the true span, in int64 (a span past 2**31 is simply wide; JAX's
    # wrapped i32 span lands negative and takes the same fallback)
    span = kmax - kmin + 1
    use = (batch.count > 0) & (span >= 1) & (span <= S)
    if not bool(use):
        return fallback(batch)

    slot = torch.clamp(kcol.to(torch.int64) - kmin, 0, S - 1)
    slot = torch.where(valid, slot, S)          # padding matches nothing
    vals: Dict[str, torch.Tensor] = {}
    shapes: Dict[str, Tuple] = {}
    for _o, (kind, vname) in aggs.items():
        if kind != "count" and vname not in vals:
            v = batch.columns[vname]
            shapes[vname] = tuple(v.shape[1:])
            # padding rows hold unspecified bytes (NaN included) and
            # 0 * NaN = NaN in the product: zero the values themselves
            vals[vname] = _mask_rows(v, valid).reshape(cap, -1)
    names = list(vals)
    vcat = torch.cat([vals[n] for n in names], dim=1) if names else None
    iota = torch.arange(S, device=dev)
    cnts = torch.zeros(S, dtype=torch.float32, device=dev)
    sums = torch.zeros((S, vcat.shape[1] if names else 1),
                       dtype=torch.float32, device=dev)
    with _full_f32_matmul():
        for c0 in range(0, cap, _SMALLKEY_CHUNK):
            oh = (slot[c0:c0 + _SMALLKEY_CHUNK, None] == iota[None, :]) \
                .to(torch.float32)                        # [chunk, S]
            cnts = cnts + oh.sum(dim=0)
            if names:
                sums = sums + torch.matmul(
                    oh.t(), vcat[c0:c0 + _SMALLKEY_CHUNK])   # [S, m]
    nonempty = cnts > 0
    num_groups = nonempty.sum(dtype=torch.int32)
    order = _stable_front(nonempty)                   # [S], tiny
    rank = torch.arange(S, dtype=torch.int32, device=dev)
    gvalid_s = rank < num_groups

    def place(a_s: torch.Tensor) -> torch.Tensor:
        """[S, ...] slot-ordered -> [cap, ...] group-compacted."""
        g = _mask_rows(a_s.index_select(0, order), gvalid_s)
        if cap >= S:
            return torch.cat([g, g.new_zeros((cap - S,) + g.shape[1:])])
        return g[:cap]

    out_cols: Dict[str, Any] = {
        key_names[0]: place((kmin + rank).to(kcol.dtype))}
    cnt_g = place(cnts).to(torch.int32)
    col_sums: Dict[str, torch.Tensor] = {}
    off = 0
    for n in names:
        m = vals[n].shape[1]
        col_sums[n] = place(sums[:, off:off + m]).reshape(
            (cap,) + shapes[n])
        off += m
    for out_name, (kind, vname) in aggs.items():
        if kind == "count":
            out_cols[out_name] = cnt_g
        elif kind == "sum":
            out_cols[out_name] = col_sums[vname]
        else:   # mean
            c = torch.clamp(cnt_g, min=1).reshape(
                (cap,) + (1,) * len(shapes[vname]))
            out_cols[out_name] = col_sums[vname] / c.to(torch.float32)
    return Batch(out_cols, num_groups)


def _int_bits(a: torch.Tensor) -> torch.Tensor:
    """A 4-byte integer column's bits as int32 (prefix_sum's dtype)."""
    return a if a.dtype == torch.int32 else from_u32(to_u32(a))


def _group_aggregate_boundary(batch: Batch, key_names: Sequence[str],
                              aggs: Dict[str, Tuple[str, str | None]],
                              minmax_col: str | None) -> Batch:
    """Boundary-carry group aggregation, scan-free:

      * ONE sort by the grouping lanes (+ the min/max order lane, so a
        segment's min sits at its first row and its max at its last);
      * sums ride ONE prefix per summed column over the sorted, masked
        values: integers the ``prefix_sum`` kernel (exact under 32-bit
        wrap), f32 the compensated ``prefix_sum2`` kernel, whose (hi, lo)
        lanes are BOTH differenced, so a group's error stays near ulp of
        its own sum instead of ulp of the global prefix;
      * per-group sums are adjacent differences of the prefix on the
        dense group-end rows; counts those of the end rows' sorted index;
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
        key_lanes.append(_dense_sort_lanes(batch.columns[minmax_col])[0])
    order = _sort_order(key_lanes, stable=False)
    skeys = [k.index_select(0, order) for k in key_lanes]
    if dense_fast:
        differs = _lane_differs(skeys[1])
    else:
        differs = _lane_differs(skeys[0], skeys[1])
    _is_start, is_end, num_groups = _segment_flags(differs, n_valid)
    svord = skeys[2] if minmax_col is not None else None
    svalid = idx < n_valid

    # prefix sums over the sorted value columns: (prefix,) for integers,
    # (hi, lo) for f32
    sum_cols: Dict[str, torch.Tensor] = {}
    for _out, (kind, vname) in aggs.items():
        if kind in ("sum", "mean") and vname not in sum_cols:
            sum_cols[vname] = batch.columns[vname]
        elif kind in ("any", "all") and "#i:" + vname not in sum_cols:
            sum_cols["#i:" + vname] = batch.columns[vname].to(torch.int32)
    csums: Dict[str, Tuple[torch.Tensor, ...]] = {}
    for name, v in sum_cols.items():
        if name == minmax_col:
            # the min/max column is also summed: its sorted values are
            # rebuilt from the sorted order lane instead of gathered
            sv = _dense_lanes_invert(svord, v.dtype)
        else:
            sv = v.index_select(0, order)
        if sv.dtype == torch.float32:
            csums[name] = prefix_sum2(torch.where(svalid, sv, 0.0))
        else:
            csums[name] = (prefix_sum(torch.where(svalid, _int_bits(sv),
                                                  0)),)

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
        if len(c) == 2:
            # difference BOTH compensated lanes
            hi, lo = (l.index_select(0, dperm) for l in c)
            dcs[name] = (hi - _shift_fwd(hi, 0)) + (lo - _shift_fwd(lo, 0))
            continue
        c = to_u32(c[0].index_select(0, dperm))
        d = from_u32((c - _shift_fwd(c, 0)) & M32)
        v = sum_cols[name]
        dcs[name] = d if v.dtype == torch.int32 else d.view(v.dtype)
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


def canon_nan(x: torch.Tensor) -> torch.Tensor:
    """Every NaN of a float tensor as the positive quiet NaN (f32 bits
    0x7FC00000), the bits the JAX package's ``jnp.minimum`` /
    ``jnp.maximum`` give; ATen's vectorized CPU kernels return
    0xFFFFFFFF from 16 elements up, which the sort lanes' total order
    would rank below every number."""
    if not x.dtype.is_floating_point:
        return x
    return torch.where(torch.isnan(x), float("nan"), x)


def minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.minimum`` (NaN propagates) with ``canon_nan``'s NaN."""
    return canon_nan(torch.minimum(a, b))


def maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.maximum`` (NaN propagates) with ``canon_nan``'s NaN."""
    return canon_nan(torch.maximum(a, b))


# min / max NaN bits are canonicalized once, on the scan's output (a NaN
# propagates through every pass whatever its bits)
_SCAN_OPS = {"sum": torch.add, "isum": torch.add, "min": torch.minimum,
             "max": torch.maximum}


def _group_aggregate_scan(batch: Batch, key_names: Sequence[str],
                          aggs: Dict[str, Tuple[str, str | None]]) -> Batch:
    """Segmented-scan group aggregation — the general path (2-D value
    columns, 8-byte sums, several or string min/max columns): ONE sort
    groups the rows, ONE segmented scan carries every aggregate's running
    reduce (each group's total lands on its last row), a stable
    valid-first sort densifies the group-end rows.  A single <= 32-bit
    dense key groups by its exact order lane, sorted unstable."""
    valid = batch.valid_mask()
    cap = batch.capacity
    dev = batch.device
    n_valid = batch.count
    idx = torch.arange(cap, dtype=torch.int32, device=dev)

    kcol0 = batch.columns[key_names[0]]
    dense_fast = _dense_fast_key(batch, key_names)
    needed_vals = list(dict.fromkeys(
        v for _, v in aggs.values() if v and v not in
        (key_names if dense_fast else ())))
    needed = needed_vals if dense_fast else \
        list(dict.fromkeys(list(key_names) + needed_vals))
    if dense_fast:
        order, skey, is_start, is_end, num_groups = _sort_segments_dense(
            _dense_key_lane(kcol0), valid, n_valid)
    else:
        hi, lo = hash_batch_keys(batch, key_names)
        order, is_start, is_end, num_groups = _sort_segments_carry(
            hi, lo, valid, n_valid)
    scols = {k: map_column(batch.columns[k],
                           lambda x: x.index_select(0, order))
             for k in needed}
    if dense_fast and key_names[0] in (v for _, v in aggs.values() if v):
        # the key doubles as an agg value (count over the key): rebuild
        # its sorted values from the (canonicalized) key lane
        scols[key_names[0]] = _dense_lanes_invert(skey, kcol0.dtype)

    scan_in: List[Tuple[torch.Tensor, Any]] = [
        ((idx < n_valid).to(torch.int32), torch.add)]     # run_cnt
    slots: Dict[Tuple[str, str | None], int] = {}

    def _slot(kind, vname, arr):
        if (kind, vname) not in slots:
            slots[(kind, vname)] = len(scan_in)
            scan_in.append((arr, _SCAN_OPS[kind]))

    for _out, (kind, vname) in aggs.items():
        if kind in ("sum", "mean"):
            _slot("sum", vname, scols[vname])
        elif kind in ("min", "max"):
            _slot(kind, vname, scols[vname])
        elif kind in ("any", "all"):
            _slot("isum", vname, scols[vname].to(torch.int32))
    scanned = _seg_scan_multi(scan_in, is_start)
    run_cnt = scanned[0]

    dense_in: Dict[str, Any] = ({} if dense_fast
                                else {k: scols[k] for k in key_names})
    for out_name, (kind, vname) in aggs.items():
        if kind == "count":
            o = run_cnt
        elif kind in ("sum", "mean"):
            s = scanned[slots[("sum", vname)]]
            if kind == "sum":
                o = s
            else:
                c = torch.clamp(run_cnt, min=1).reshape(
                    (cap,) + (1,) * (s.dim() - 1))
                o = s / c.to(s.dtype) if s.dtype.is_floating_point \
                    else s.to(torch.float32) / c
        elif kind in ("min", "max"):
            o = canon_nan(scanned[slots[(kind, vname)]])
        elif kind == "any":
            o = scanned[slots[("isum", vname)]] > 0
        else:   # all
            o = scanned[slots[("isum", vname)]] == run_cnt
        dense_in[out_name] = o

    dperm = _stable_front(is_end)
    gmask = idx < num_groups
    out_cols = {name: _mask_rows(map_column(
        v, lambda x: x.index_select(0, dperm)), gmask)
        for name, v in dense_in.items()}
    if dense_fast:
        out_cols[key_names[0]] = _mask_rows(_dense_lanes_invert(
            skey.index_select(0, dperm), kcol0.dtype), gmask)
    return Batch(out_cols, num_groups)


# ---------------------------------------------------------------------------
# segmented scans (the port's associative_scan, ops/scan.py)


def _bcast(flag: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return flag.reshape(flag.shape + (1,) * (like.dim() - 1))


def _seg_scan_multi(vals_ops, is_start: torch.Tensor) -> List[torch.Tensor]:
    """Running segment reduces for SEVERAL (value, op) pairs in ONE scan:
    the log2(cap) passes and the boundary flags are shared instead of
    paid per aggregate.  Rows are segment-sorted, ``is_start`` marks each
    segment's first row; each segment's total sits at its last row."""

    def comb(a, b):
        fa, va = a[0], a[1:]
        fb, vb = b[0], b[1:]
        out = [torch.where(_bcast(fb, xa), xb, op(xa, xb))
               for xa, xb, (_, op) in zip(va, vb, vals_ops)]
        return (fa | fb,) + tuple(out)

    res = associative_scan(comb, (is_start,) + tuple(v for v, _ in vals_ops))
    return list(res[1:])


def _seg_scan_reduce(v: torch.Tensor, is_start: torch.Tensor, op,
                     reverse: bool = False) -> torch.Tensor:
    """Per-row running ``op``-reduce within each segment (one pair of
    ``_seg_scan_multi``).  The segment total sits at its last row; with
    ``reverse=True`` (the flags then marking segment ENDS) at its first
    row."""
    if reverse:
        return _seg_scan_multi([(v.flip(0), op)], is_start.flip(0))[0].flip(0)
    return _seg_scan_multi([(v, op)], is_start)[0]


# ---------------------------------------------------------------------------
# user-defined decomposable aggregation (IDecomposable parity)


def _segmented_merge(seg: torch.Tensor, states, merge_fn):
    """Reduce an associative ``merge_fn`` over each segment: one scan over
    rows carrying (segment id, state) whose combine keeps the right
    operand where the segments differ, so each segment's LAST row ends up
    holding the whole segment's reduction."""

    def combine(a, b):
        sa, va = a
        sb, vb = b
        same = sa == sb
        leaves_b, spec = pytree.tree_flatten(vb)
        merged = pytree.tree_leaves(merge_fn(va, vb))
        return sb, pytree.tree_unflatten(
            [torch.where(_bcast(same, x), x, y)
             for x, y in zip(merged, leaves_b)], spec)

    _, scanned = associative_scan(combine, (seg, states))
    return scanned


def _group_states(batch: Batch, key_names: Sequence[str],
                  decs: Dict[str, Tuple], state_box: Dict):
    """Seed + segmented merge: (key out_cols, out -> per-group merged
    state pytree, num_groups).  Publishes each state's treespec into
    ``state_box``."""
    sb, seg, is_start, num_groups = _group_segments(batch, key_names)
    first, last = _segment_rows(is_start, num_groups, batch.count)
    rep = sb.gather(first)
    out_cols = {k: rep.columns[k] for k in key_names}
    merged_states = {}
    for out_name, (seed, merge_fn, _fin) in decs.items():
        states = seed(dict(sb.columns))
        state_box[out_name] = pytree.tree_structure(states)
        scanned = _segmented_merge(seg, states, merge_fn)
        merged_states[out_name] = pytree.tree_map(
            lambda l: l.index_select(0, last), scanned)
    return out_cols, merged_states, num_groups


def _group_mask(cap: int, num_groups, dev) -> torch.Tensor:
    """Rows [0, num_groups) of a [cap] output."""
    return torch.arange(cap, device=dev) < num_groups


def _emit_states(out_cols, out_name, merged, gmask) -> None:
    for i, leaf in enumerate(pytree.tree_leaves(merged)):
        out_cols[f"{out_name}@{i}"] = _mask_rows(leaf, gmask)


def _emit_finalized(out_cols, out_name, fin, merged, gmask) -> None:
    val = fin(merged) if fin is not None else merged
    named = val if isinstance(val, dict) else {out_name: val}
    for cname, v in named.items():
        out_cols[cname] = _mask_rows(v, gmask)


def resolve_dec_spec(spec):
    """Dec spec -> (seed, merge, finalize): a ``plan.expr.Decomposable``,
    a ("__builtin__", kind, col) tag rebuilt here on the executing side,
    or already a triple (direct kernel callers)."""
    if isinstance(spec, tuple) and len(spec) == 3 and \
            spec[0] == "__builtin__":
        # imported here: the planner sits above the ops layer
        from dryad_tpu_torch.plan.planner import _builtin_as_decomposable
        d = _builtin_as_decomposable(spec[1], spec[2])
        return (d.seed, d.merge, d.finalize)
    if hasattr(spec, "seed"):
        return (spec.seed, spec.merge, spec.finalize)
    return spec


def _resolve_decs(decs):
    return {k: resolve_dec_spec(v) for k, v in decs.items()}


def group_decompose_partial(batch: Batch, key_names: Sequence[str],
                            decs: Dict[str, Any], state_box: Dict) -> Batch:
    """Map-side combine for user-defined decomposable aggregates.
    ``seed(columns)`` maps the row columns to a state pytree (vectorized
    over rows), ``merge(a, b)`` is the associative combine.  Output: the
    key columns + each state's leaves as columns ``{out}@{i}``; the
    treespecs go into ``state_box`` for the merge stage."""
    decs = _resolve_decs(decs)
    out_cols, merged_states, num_groups = _group_states(
        batch, key_names, decs, state_box)
    gmask = _group_mask(batch.capacity, num_groups, batch.device)
    for out_name, merged in merged_states.items():
        _emit_states(out_cols, out_name, merged, gmask)
    return Batch(out_cols, num_groups)


def group_decompose_local(batch: Batch, key_names: Sequence[str],
                          decs: Dict[str, Any], state_box: Dict) -> Batch:
    """Single-pass decomposable GroupBy over co-located input: seed, merge
    and finalize in one op."""
    decs = _resolve_decs(decs)
    out_cols, merged_states, num_groups = _group_states(
        batch, key_names, decs, state_box)
    gmask = _group_mask(batch.capacity, num_groups, batch.device)
    for out_name, merged in merged_states.items():
        _emit_finalized(out_cols, out_name, decs[out_name][2], merged, gmask)
    return Batch(out_cols, num_groups)


def group_decompose_merge(batch: Batch, key_names: Sequence[str],
                          decs: Dict[str, Any], state_box: Dict,
                          finalize: bool) -> Batch:
    """Reduce-side merge of partial states (columns ``{out}@{i}``), then
    finalize when ``finalize``."""
    decs = _resolve_decs(decs)
    sb, seg, is_start, num_groups = _group_segments(batch, key_names)
    first, last = _segment_rows(is_start, num_groups, batch.count)
    rep = sb.gather(first)
    out_cols = {k: rep.columns[k] for k in key_names}
    gmask = _group_mask(batch.capacity, num_groups, batch.device)
    for out_name, (_seed, merge_fn, fin) in decs.items():
        spec = state_box[out_name]
        states = pytree.tree_unflatten(
            [sb.columns[f"{out_name}@{i}"] for i in range(spec.num_leaves)],
            spec)
        merged = pytree.tree_map(lambda l: l.index_select(0, last),
                                 _segmented_merge(seg, states, merge_fn))
        if finalize:
            _emit_finalized(out_cols, out_name, fin, merged, gmask)
        else:
            _emit_states(out_cols, out_name, merged, gmask)
    return Batch(out_cols, num_groups)


# ---------------------------------------------------------------------------
# distinct and the group-contents operators (they read the order of rows
# within a segment, so their sorts are stable)


def distinct(batch: Batch, key_names: Sequence[str] | None = None) -> Batch:
    """One representative row per distinct key (all columns kept): the
    first row, in arrival order, of each 64-bit key-hash segment; groups
    in hash order.  Empty ``key_names`` = all columns."""
    keys = list(key_names) if key_names else sorted(batch.names)
    hi, lo = hash_batch_keys(batch, keys)
    hi_s, lo_s = _sentinel_fold(hi, lo, batch.valid_mask())
    order = _sort_order([hi_s, lo_s], stable=True)
    is_start, _is_end, num_groups = _segment_flags(
        _lane_differs(hi_s.index_select(0, order),
                      lo_s.index_select(0, order)), batch.count)
    rep = batch.gather(order.index_select(0, _stable_front(is_start)),
                       num_groups)
    gmask = rep.valid_mask()
    return Batch({k: _mask_rows(v, gmask) for k, v in rep.columns.items()},
                 num_groups)


def group_top_k(batch: Batch, key_names: Sequence[str], k: int, by: str,
                descending: bool = True) -> Batch:
    """Per-group top-k rows by the ``by`` column (all columns kept): rows
    sorted by (key hash, ``by``), each segment keeps its first k.  Ties
    keep arrival order (the sort is stable).  The output fits the input
    capacity by construction."""
    lanes = sort_lanes_for(batch.columns[by], descending)
    order, seg, is_start, num_groups = _segments_by_keys_and_lanes(
        batch, key_names, tuple(reversed(lanes)))
    cap = batch.capacity
    sb = batch.gather(order)
    start_pos, _ = _segment_bounds(is_start, num_groups, batch.count)
    idx = torch.arange(cap, device=batch.device)
    rel = idx - start_pos.index_select(0, torch.clamp(seg, 0, cap - 1))
    keep = (idx < batch.count) & (rel < k)
    return compact(sb, keep)


def group_rank_select(batch: Batch, key_names: Sequence[str], by: str,
                      rank: str = "median", out: str | None = None) -> Batch:
    """One row per group: the key columns + ``out`` (default ``by``)
    holding the group's element at a sorted rank of ``by``: "median" is
    the LOWER median (element (n-1)//2 of the ascending order, always an
    element of the group), "min" / "max" the ends."""
    lanes = sort_lanes_for(batch.columns[by], False)
    order, _seg, is_start, num_groups = _segments_by_keys_and_lanes(
        batch, key_names, tuple(reversed(lanes)))
    cap = batch.capacity
    sb = batch.gather(order)
    start_pos, end_excl = _segment_bounds(is_start, num_groups, batch.count)
    if rank == "median":
        pos = start_pos + (end_excl - start_pos - 1) // 2
    elif rank == "min":
        pos = start_pos
    elif rank == "max":
        pos = end_excl - 1
    else:
        raise ValueError(f"unknown rank {rank!r}")
    gvalid = torch.arange(cap, device=batch.device) < num_groups
    sel = torch.where(gvalid, torch.clamp(pos, 0, cap - 1), 0)
    rep = sb.gather(torch.where(gvalid, start_pos, 0))
    out_cols: Dict[str, Any] = {k: rep.columns[k] for k in key_names}
    out_cols[out or by] = map_column(sb.columns[by],
                                     lambda x: x.index_select(0, sel))
    return Batch(out_cols, num_groups)


def _flat_take(col, perm: torch.Tensor):
    """Rows ``perm`` of a [n, m, ...] column flattened to [n*m, ...]."""
    if isinstance(col, StringColumn):
        return StringColumn(
            col.data.reshape((-1, col.data.shape[-1])).index_select(0, perm),
            col.lengths.reshape(-1).index_select(0, perm))
    return col.reshape((-1,) + tuple(col.shape[2:])).index_select(0, perm)


def _unstring(cols: Dict[str, Any]) -> Dict[str, Any]:
    """String columns as (data, lengths) tuples: ``torch.func.vmap`` maps
    over tensors in tuples and dicts only."""
    return {k: (v.data, v.lengths) if isinstance(v, StringColumn) else v
            for k, v in cols.items()}


def _restring(cols: Dict[str, Any]) -> Dict[str, Any]:
    return {k: StringColumn(*v) if isinstance(v, tuple) else v
            for k, v in cols.items()}


def group_regroup_apply(batch: Batch, key_names: Sequence[str], fn,
                        max_groups: int, group_capacity: int,
                        out_rows: int, out_capacity: int):
    """The general per-group result selector: regroup the rows into a
    dense [G, C] layout (G = min(max_groups, cap) groups of at most
    C = min(group_capacity, cap) rows) and map ``fn`` over the groups
    with ``torch.func.vmap`` (the JAX package's ``jax.vmap``).

    ``fn(cols, count) -> (out_cols, mask)`` sees ONE group: its columns
    as [C, ...] tensors / StringColumns (rows >= count unspecified) and
    its row count, a 0-d int32 tensor; out_cols are [out_rows, ...] and
    mask is [out_rows] bool.  The group's key columns are attached to
    every emitted row unless ``fn`` emits a column of the same name.  The
    emitted rows of all groups, in group order then row order, are
    compacted into min(out_capacity, G * out_rows) rows.  Groups past G
    and rows past C are not seen by ``fn``: the three measured needs
    say so.

    Returns (batch, num_groups, max_group_size, total_out_rows).  Memory:
    the regroup holds G x C cells per column."""
    sb, _seg, is_start, num_groups = _group_segments(batch, key_names)
    cap = batch.capacity
    dev = batch.device
    start_pos, end_excl = _segment_bounds(is_start, num_groups, batch.count)
    idx = torch.arange(cap, device=dev)
    sizes = torch.where(idx < num_groups, end_excl - start_pos, 0)
    max_size = sizes.max().to(torch.int32)

    # a partition cannot hold more groups (or a larger group) than rows
    G, C, R = min(max_groups, cap), min(group_capacity, cap), out_rows
    gstart = start_pos[:G]
    gsizes = torch.clamp(sizes[:G], max=C).to(torch.int32)
    gvalid = torch.arange(G, device=dev) < num_groups
    gidx = torch.clamp(gstart[:, None] + torch.arange(C, device=dev)[None],
                       0, cap - 1).reshape(-1)
    group_cols = {k: map_column(v, lambda x: x.index_select(0, gidx).reshape(
        (G, C) + tuple(x.shape[1:]))) for k, v in sb.columns.items()}

    def one_group(cols, count):
        out, mask = fn(_restring(cols), count)
        return _unstring(out), mask

    out_cols, mask = torch.func.vmap(one_group)(_unstring(group_cols), gsizes)
    out_cols = _restring(out_cols)              # [G, R, ...]
    flat_mask = (mask & gvalid[:, None]).reshape(-1)
    total = flat_mask.sum(dtype=torch.int32)
    perm = _stable_front(flat_mask)[:out_capacity]
    # an emitted row's group is its flat position // R: the key columns
    # come straight from the group's first sorted row
    key_rows = torch.where(gvalid, gstart, 0).index_select(
        0, torch.div(perm, R, rounding_mode="floor"))
    cols: Dict[str, Any] = {
        k: map_column(sb.columns[k], lambda x: x.index_select(0, key_rows))
        for k in key_names if k not in out_cols}
    cols.update({k: _flat_take(v, perm) for k, v in out_cols.items()})
    out = Batch(cols, torch.clamp(total, max=out_capacity))
    return out, num_groups, max_size, total


def flat_map_expand(batch: Batch, fn, out_capacity: int
                    ) -> Tuple[Batch, torch.Tensor]:
    """Generic SelectMany: ``fn(cols) -> (out_cols, mask)`` with every
    output column [cap, m, ...] and mask [cap, m]; the valid rows' masked
    cells, flattened row-major, compacted into min(out_capacity, cap * m)
    rows.  Returns (batch, need): need is the total when it exceeds
    ``out_capacity``, else 0."""
    out_cols, mask = fn(dict(batch.columns))
    mask = mask & batch.valid_mask()[:, None]
    flat_mask = mask.reshape(-1)
    total = flat_mask.sum(dtype=torch.int32)
    perm = _stable_front(flat_mask)[:out_capacity]
    out = Batch({k: _flat_take(v, perm) for k, v in out_cols.items()},
                torch.clamp(total, max=out_capacity))
    return out, torch.where(total > out_capacity, total, 0).to(torch.int32)


# ---------------------------------------------------------------------------
# join


def searchsorted_big(table: torch.Tensor, q: torch.Tensor,
                     side: str = "left") -> torch.Tensor:
    """Insertion points of ``q`` in a LARGE sorted ``table`` (join
    candidate ranges): one ``torch.searchsorted``, a binary search per
    query; int64.  32-bit lanes are int64 in [0, 2**32), so the order is
    the unsigned one and the all-ones sentinel stays the largest value."""
    if table.numel() == 0:
        return torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    return torch.searchsorted(table, q, right=(side == "right"))


def _keys_equal(a: Batch, a_idx: torch.Tensor, a_names: Sequence[str],
                b: Batch, b_idx: torch.Tensor,
                b_names: Sequence[str]) -> torch.Tensor:
    """Row a_idx[i] of ``a`` and row b_idx[i] of ``b`` have equal keys
    (strings: equal lengths and bytes below the length)."""
    eq = torch.ones(a_idx.shape, dtype=torch.bool, device=a_idx.device)
    for an, bn in zip(a_names, b_names):
        ca, cb = a.columns[an], b.columns[bn]
        if isinstance(ca, StringColumn):
            la = ca.lengths.index_select(0, a_idx)
            lb = cb.lengths.index_select(0, b_idx)
            L = min(ca.max_len, cb.max_len)
            da = ca.data.index_select(0, a_idx)[:, :L]
            db = cb.data.index_select(0, b_idx)[:, :L]
            m = torch.arange(L, device=la.device)[None, :] < la[:, None]
            beq = torch.where(m, da == db, True).all(dim=1)
            eq = eq & (la == lb) & beq
        else:
            eq = eq & (ca.index_select(0, a_idx) == cb.index_select(0, b_idx))
    return eq


def _packed_gather(cols: Dict[str, Any], idx: torch.Tensor) -> Dict[str, Any]:
    """Rows ``idx`` of every column: one ``index_select`` per column (the
    JAX package packs the columns into one word matrix first, a trade
    made for the TPU's per-row gather cost)."""
    return {k: map_column(v, lambda x: x.index_select(0, idx))
            for k, v in cols.items()}


def _join_out_names(left: Batch, right: Batch, right_keys, suffix: str):
    """(right column, output name) of the right side's non-key columns,
    suffixed where a left column has the name; shared by both join
    lowerings."""
    names = list(left.names)
    rkeyset = set(right_keys)
    rmap = []
    for k in right.names:
        if k in rkeyset:
            continue
        name = k if k not in names else k + suffix
        rmap.append((k, name))
        names.append(name)
    return rmap


def _folded_hash(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """A 64-bit hash's two lanes as one int64 whose signed order is the
    pair's unsigned order."""
    return ((hi - _SIGN) << 32) | lo


def lookup_join(left: Batch, right: Batch, left_keys: Sequence[str],
                right_keys: Sequence[str], out_capacity: int,
                suffix: str = "_r", how: str = "inner"
                ) -> Tuple[Batch, torch.Tensor, torch.Tensor]:
    """Join against a right side with at most one row per key hash (a
    lookup table: the PageRank rank table).  Returns ``(batch, need,
    dups)``: ``dups`` is the 0-d "two valid right rows share a 64-bit
    key hash" flag, read off the same sort (a key's right rows sit
    together at the head of its run); where it is set the batch is not
    the join and the caller takes ``hash_join``'s general form.

    Each left row is its own output row, so the join is a merge: ONE
    stable sort of both sides' rows (the right rows first) by 64-bit key
    hash puts a key's right row, if any, at the head of its run, and every
    left row reads the right row at its run's head.  The JAX package
    forward-fills the right payload with a segmented max over u32 words
    (zeros elsewhere); the port reads the head's row instead, which is
    the same row, with no unsigned compare of int32 bits.

    Match verification: when both sides' key columns pack to the same
    word layout (same dtype / string max_len), a left row matches only if
    its packed key words equal the head right row's, so a 64-bit hash
    collision is rejected; otherwise the hash pair alone decides, as in
    the JAX package.  ``how="left"`` keeps unmatched left rows with the
    right columns zero-filled."""
    lvalid, rvalid = left.valid_mask(), right.valid_mask()
    lhi, llo = _sentinel_fold(*hash_batch_keys(left, left_keys), lvalid)
    rhi, rlo = _sentinel_fold(*hash_batch_keys(right, right_keys), rvalid)
    cl, cr = left.capacity, right.capacity
    n = cl + cr
    dev = left.device
    hi = torch.cat([rhi, lhi])
    lo = torch.cat([rlo, llo])
    order = torch.sort(_folded_hash(hi, lo), stable=True).indices
    n_valid = left.count + right.count
    is_start, _is_end, _ng = _segment_flags(
        _lane_differs(hi.index_select(0, order), lo.index_select(0, order)),
        n_valid)
    # each row's run head: the start position of its run, scattered by
    # run number (rows that start no run write a dump slot)
    idx = torch.arange(n, device=dev)
    run = torch.clamp(torch.cumsum(is_start, 0) - 1, min=0)
    starts = torch.zeros(n + 1, dtype=torch.int64, device=dev).scatter_(
        0, torch.where(is_start, run, n), idx)
    head = order.index_select(0, starts.index_select(0, run))
    rrow = torch.clamp(head, max=cr - 1)
    lrow = torch.clamp(order - cr, min=0)
    present = (head < cr) & rvalid.index_select(0, rrow)

    lkw, lspec = _pack_columns_u32({k: left.columns[k] for k in left_keys})
    rkw, rspec = _pack_columns_u32(
        {ln: right.columns[rn] for ln, rn in zip(left_keys, right_keys)})
    verify = (len(set(left_keys)) == len(left_keys)
              and [e[1:] for e in lspec] == [e[1:] for e in rspec])
    if verify:
        present = present & (lkw.index_select(0, lrow)
                             == rkw.index_select(0, rrow)).all(dim=1)

    is_right = order < cr
    dups = (~is_start[1:] & is_right[1:] & is_right[:-1]
            & (idx[1:] < n_valid)).any()
    is_left = ~is_right & (idx < n_valid)
    keep = is_left & present if how == "inner" else is_left
    total = keep.sum(dtype=torch.int32)
    sel = _stable_front(keep)
    if n >= out_capacity:
        sel = sel[:out_capacity]
    else:
        sel = torch.cat([sel, sel.new_zeros(out_capacity - n)])
    cnt = torch.clamp(total, max=out_capacity)
    gmask = torch.arange(out_capacity, device=dev) < cnt
    cols = _packed_gather(dict(left.columns), lrow.index_select(0, sel))
    cols = {k: _mask_rows(v, gmask) for k, v in cols.items()}
    rkeep = gmask & present.index_select(0, sel)
    rcols = _packed_gather({name: right.columns[k]
                            for k, name in _join_out_names(
                                left, right, right_keys, suffix)},
                           rrow.index_select(0, sel))
    cols.update({k: _mask_rows(v, rkeep) for k, v in rcols.items()})
    need = torch.where(total > out_capacity, total, 0).to(torch.int32)
    return Batch(cols, cnt), need, dups


def hash_join(left: Batch, right: Batch, left_keys: Sequence[str],
              right_keys: Sequence[str], out_capacity: int,
              suffix: str = "_r", how: str = "inner",
              right_unique: bool = False) -> Tuple[Batch, torch.Tensor]:
    """Equi-join of one partition's left and right rows; output columns =
    left columns + right non-key columns (right name suffixed on
    collision).  Returns ``(batch, need)``: ``need`` is 0 when every
    candidate pair fit ``out_capacity``, else the candidate count, so the
    executor can right-size the retry.

    ``how="left"``: a left row without a match emits ONE row with the
    right columns zero-filled.  ``how="right"`` mirrors it: a right row
    without a match emits ONE row whose left key columns carry the right
    keys and whose other left columns are zero-filled, appended after
    the matched rows; ``how="full"`` does both.

    Candidates are found on one 32-bit hash lane (``hi ^ lo * 0x9E3779B9``
    mod 2**32): the right side sorted by (invalid, lane) — stable, so
    candidates keep row order — two binary searches per left row, output
    slots mapped to (left row, candidate) through a prefix sum of the
    multiplicities; real-key equality then drops the collisions, and the
    kept slots are compacted.

    ``right_unique=True`` declares the right side a lookup table:
    ``lookup_join`` runs, and its result stands when no two valid right
    rows share a 64-bit key hash, else this general join runs.  The JAX
    package picks with ``lax.cond`` on the device; the port reads the
    flag on the host (the executor reads every partition's at once).
    The lookup form is for inner and left joins only, as in the JAX
    package."""
    if how not in ("inner", "left", "right", "full"):
        raise ValueError(f"unknown join how={how!r}")
    if right_unique and how in ("inner", "left"):
        out, need, dups = lookup_join(left, right, left_keys, right_keys,
                                      out_capacity, suffix, how)
        if not bool(dups):
            return out, need
    return general_join(left, right, left_keys, right_keys, out_capacity,
                        suffix, how)


def general_join(left: Batch, right: Batch, left_keys: Sequence[str],
                 right_keys: Sequence[str], out_capacity: int,
                 suffix: str = "_r", how: str = "inner"
                 ) -> Tuple[Batch, torch.Tensor]:
    """``hash_join`` for any right side (duplicate keys included)."""
    if how not in ("inner", "left", "right", "full"):
        raise ValueError(f"unknown join how={how!r}")
    cl, cr = left.capacity, right.capacity
    dev = left.device
    lhi, llo = hash_batch_keys(left, left_keys)
    rhi, rlo = hash_batch_keys(right, right_keys)
    lh = lhi ^ mul32(llo, 0x9E3779B9)
    rh = rhi ^ mul32(rlo, 0x9E3779B9)
    lvalid, rvalid = left.valid_mask(), right.valid_mask()
    order = torch.sort(((~rvalid).to(torch.int64) << 32) | rh,
                       stable=True).indices
    # padding rows take the all-ones sentinel; a valid row hashing to it
    # is just one more candidate, dropped by the key check
    rkey = torch.where(torch.arange(cr, device=dev) < right.count,
                       rh.index_select(0, order), M32)
    start = searchsorted_big(rkey, lh, side="left")
    stop = searchsorted_big(rkey, lh, side="right")
    mult = torch.where(lvalid, stop - start, 0)
    left_synth = how in ("left", "full")
    if left_synth:
        # an unmatched left row still takes one (synthetic) output slot
        synth_row = lvalid & (mult == 0)
        mult = torch.where(synth_row, 1, mult)

    # output slot -> (left row, right candidate) via the prefix sums
    cum = torch.cumsum(mult, 0)
    total = cum[-1]
    t = torch.arange(out_capacity, device=dev)
    lid = torch.clamp(searchsorted_big(cum, t, side="right"), max=cl - 1)
    base = cum.index_select(0, lid) - mult.index_select(0, lid)
    rid = torch.clamp(start.index_select(0, lid) + (t - base), 0, cr - 1)
    slot_valid = t < total
    rid_abs = order.index_select(0, rid)
    # true key equality drops hash collisions and candidates that landed
    # in the right side's padding
    keep_match = slot_valid & (rid < right.count) & _keys_equal(
        left, lid, left_keys, right, rid_abs, right_keys)
    keep = keep_match
    if left_synth:
        synth_slot = slot_valid & synth_row.index_select(0, lid)
        keep = keep | synth_slot
    out_cols = _packed_gather(dict(left.columns), lid)
    rpayload = {name: right.columns[k]
                for k, name in _join_out_names(left, right, right_keys,
                                               suffix)}
    for name, g in _packed_gather(rpayload, rid_abs).items():
        out_cols[name] = _mask_rows(g, ~synth_slot) if left_synth else g
    out = compact(Batch(out_cols, torch.full((), out_capacity,
                                             dtype=torch.int32,
                                             device=dev)), keep)
    need = torch.where(total > out_capacity, total, 0).to(torch.int32)
    if how in ("right", "full"):
        out, need = _append_unmatched_right(out, need, total, left, right,
                                            left_keys, right_keys, rid_abs,
                                            keep_match, out_capacity, suffix)
    return out, need


def _append_unmatched_right(out: Batch, need: torch.Tensor, total, left,
                            right, left_keys, right_keys, rid_abs,
                            keep_match, out_capacity: int, suffix: str):
    """The right / full join's tail: every right row that no VERIFIED
    match kept gets one output row after the matched ones, its left key
    columns carrying the right keys (a string key at the right key's full
    width: ``concat2`` pads the narrower side, where truncating would
    corrupt a longer unmatched right key) and its other left columns
    zero-filled.  A match dropped only by the capacity leaves its right
    row unmatched, inflating the count: harmless, the need already forces
    a right-sized retry then.  The need becomes matched + unmatched."""
    matched = torch.zeros(right.capacity, dtype=torch.int32,
                          device=right.device).scatter_reduce_(
        0, rid_abs, keep_match.to(torch.int32), "amax")
    ru = compact(right, matched == 0)
    u = ru.count
    key_map = dict(zip(left_keys, right_keys))
    synth: Dict[str, Any] = {}
    for k, v in left.columns.items():
        if k in key_map:
            rv = ru.columns[key_map[k]]
            synth[k] = rv if isinstance(v, StringColumn) else rv.to(v.dtype)
        elif isinstance(v, StringColumn):
            synth[k] = StringColumn(
                v.data.new_zeros((right.capacity, v.max_len)),
                v.lengths.new_zeros((right.capacity,)))
        else:
            synth[k] = v.new_zeros((right.capacity,) + tuple(v.shape[1:]))
    for k, name in _join_out_names(left, right, right_keys, suffix):
        synth[name] = ru.columns[k]
    merged = concat2(out, Batch(synth, u))
    keep_rows = torch.arange(out_capacity, device=out.device)
    out = merged.gather(keep_rows, torch.clamp(merged.count,
                                               max=out_capacity))
    need = torch.where(total + u > out_capacity, total + u, need).to(
        torch.int32)
    return out, need


def zip2(a: Batch, b: Batch, suffix: str = "_r") -> Batch:
    """Positional pairing within a partition, the shorter side's count
    (LINQ Zip): ``a``'s columns, then ``b``'s (suffixed on a name clash),
    capacity the smaller of the two."""
    cap = min(a.capacity, b.capacity)
    cols = {k: map_column(v, lambda x: x[:cap]) for k, v in a.columns.items()}
    for k, v in b.columns.items():
        cols[k if k not in cols else k + suffix] = map_column(
            v, lambda x: x[:cap])
    return Batch(cols, torch.minimum(a.count, b.count).to(torch.int32))


# ---------------------------------------------------------------------------
# set membership, semi / anti join, concat


def _hash_membership(hi: torch.Tensor, lo: torch.Tensor, flag: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """bool [n] in ORIGINAL row order: does the row's 64-bit-hash segment
    hold a flagged row?  ONE stable sort by the folded hash (invalid rows
    fold to the all-ones sentinel and sort last), a per-segment max of
    the flag (segments are the runs of equal hash among the valid
    prefix), read back by each row through the sort order.  The JAX
    package spreads the answer with two segmented max-scans and restores
    the order with a second sort, trades made for the TPU's scatter cost;
    the membership is the same."""
    n = hi.shape[0]
    hi_s, lo_s = _sentinel_fold(hi, lo, valid)
    order = torch.sort(_folded_hash(hi_s, lo_s), stable=True).indices
    is_start, _is_end, _ng = _segment_flags(
        _lane_differs(hi_s.index_select(0, order),
                      lo_s.index_select(0, order)),
        valid.sum(dtype=torch.int32))
    seg = torch.cumsum(is_start, 0) - 1
    # rows past the valid prefix belong to no segment: a dump slot
    seg = torch.where(torch.arange(n, device=hi.device)
                      < valid.sum(), seg, n)
    hit = torch.zeros(n + 1, dtype=torch.int32, device=hi.device
                      ).scatter_reduce_(0, seg, flag.to(torch.int32)
                                        .index_select(0, order), "amax")
    member = torch.empty(n, dtype=torch.bool, device=hi.device)
    member[order] = hit.index_select(0, seg) > 0
    return member


def semi_anti_join(left: Batch, right: Batch, left_keys: Sequence[str],
                   right_keys: Sequence[str], anti: bool = False) -> Batch:
    """Keep the left rows whose key does (semi) / does not (anti) appear
    in ``right``, in their order: membership on the full 64-bit key hash
    over the union of both sides' rows, the right ones flagged."""
    lhi, llo = hash_batch_keys(left, left_keys)
    rhi, rlo = hash_batch_keys(right, right_keys)
    lvalid, rvalid = left.valid_mask(), right.valid_mask()
    member = _hash_membership(
        torch.cat([lhi, rhi]), torch.cat([llo, rlo]),
        torch.cat([torch.zeros_like(lvalid), rvalid]),
        torch.cat([lvalid, rvalid]))[:left.capacity]
    return compact(left, lvalid & (~member if anti else member))


def concat2(a: Batch, b: Batch) -> Batch:
    """The valid rows of ``a``, then the valid rows of ``b`` (``a``'s
    column order; string columns padded to the wider ``max_len``), in a
    batch of capacity ``a.capacity + b.capacity``."""
    ca, cb = a.capacity, b.capacity
    i = torch.arange(ca + cb, device=a.device)
    src = torch.where(i < a.count, torch.clamp(i, max=ca - 1),
                      torch.clamp(ca + (i - a.count), max=ca + cb - 1))
    cols: Dict[str, Any] = {}
    for k in a.names:
        va, vb = a.columns[k], b.columns[k]
        if isinstance(va, StringColumn):
            L = max(va.max_len, vb.max_len)
            data = torch.cat([
                torch.nn.functional.pad(va.data, (0, L - va.max_len)),
                torch.nn.functional.pad(vb.data, (0, L - vb.max_len))])
            cols[k] = StringColumn(
                data.index_select(0, src),
                torch.cat([va.lengths, vb.lengths]).index_select(0, src))
        else:
            cols[k] = torch.cat([va, vb]).index_select(0, src)
    return Batch(cols, (a.count + b.count).to(torch.int32))


# ---------------------------------------------------------------------------
# whole-batch (scalar) aggregation


def _sum_dtype(dtype: torch.dtype) -> torch.dtype:
    """A sum's dtype, as ``jnp.sum`` gives it: integers narrower than 32
    bits and bool widen to int32, the rest keep their dtype (torch's own
    sum would widen every integer to int64)."""
    if dtype == torch.bool or (not dtype.is_floating_point
                               and torch.iinfo(dtype).bits < 32):
        return torch.int32
    return dtype


def _scalar_neutral(kind: str, dtype: torch.dtype):
    """The fill of a masked min / max: the dtype's largest / smallest
    finite value (the JAX package's ``_neutral_for``)."""
    info = torch.finfo(dtype) if dtype.is_floating_point \
        else torch.iinfo(dtype)
    return info.max if kind == "min" else info.min


def scalar_aggregate(batch: Batch, aggs: Dict[str, Tuple[str, str | None]]
                     ) -> Dict[str, torch.Tensor]:
    """Masked full-batch reductions: out_name -> (kind, value_column |
    None); a vector column reduces over rows, per element.  ``mean`` of
    an integer column is the f32 sum over the count; an empty batch's
    mean is 0, its min / max the neutral fill."""
    valid = batch.valid_mask()
    out: Dict[str, torch.Tensor] = {}
    for out_name, (kind, vname) in aggs.items():
        if kind == "count":
            out[out_name] = batch.count
            continue
        v = batch.columns[vname]
        m = valid.reshape(valid.shape + (1,) * (v.dim() - 1))
        if kind in ("sum", "mean"):
            s = torch.where(m, v, 0).sum(dim=0, dtype=_sum_dtype(v.dtype))
            if kind == "sum":
                out[out_name] = s
            else:
                c = torch.clamp(batch.count, min=1)
                out[out_name] = s / c.to(s.dtype) \
                    if s.dtype.is_floating_point \
                    else s.to(torch.float32) / c
        elif kind in ("min", "max"):
            filled = torch.where(m, v, _scalar_neutral(kind, v.dtype))
            out[out_name] = filled.amin(dim=0) if kind == "min" \
                else filled.amax(dim=0)
        elif kind in ("any", "all"):
            vb = v if v.dtype == torch.bool else v != 0
            if kind == "any":
                out[out_name] = (m & vb).any(dim=0)
            else:
                out[out_name] = (~m | vb).all(dim=0)
        else:
            raise ValueError(kind)
    return out


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
