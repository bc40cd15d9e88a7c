"""Text ops: tokenization, the WordCount SelectMany — the PyTorch port of
``dryad_tpu/ops/text.py``.

Tokens never cross row boundaries, so everything is per-row work on the
``[cap, L]`` byte grid.  ``tokenize_group_count`` is the fused
SelectMany + GroupBy + Count: tokens are hashed in place on the grid (two
32-bit polynomial window hashes), grouped by hash, and bytes are
extracted only for one representative per group.

PyTorch forms of the JAX constructs: the reversed ``cummin`` is
``torch.cummin`` on a flipped tensor; the batched stable row sort is
``torch.sort(dim=1, stable=True)``; the slot-order value-carry sort is a
scatter to each token's slot (slots are unique), whose bases come from
the ``prefix_sum`` Hopper kernel; 32-bit hash lanes are int64 in
[0, 2**32) (``ops/hashing``).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from dryad_tpu_torch.data.columnar import Batch, StringColumn
from dryad_tpu_torch.ops.hashing import M32
from dryad_tpu_torch.ops.hopper_kernels import prefix_sum
from dryad_tpu_torch.ops.kernels import (_lane_differs, _segment_flags,
                                         _sort_carrying, _stable_front)

__all__ = ["split_tokens", "tokenize_group_count", "lower_ascii"]

_DELIMS = b" \t\r\n.,;:!?\"'()[]{}<>"
_I32_MAX = (1 << 31) - 1


def lower_ascii(col: StringColumn) -> StringColumn:
    return StringColumn(_lower_grid(col.data), col.lengths)


def _is_delim(b: torch.Tensor, delims: bytes) -> torch.Tensor:
    table = torch.zeros(256, dtype=torch.bool, device=b.device)
    table[list(delims)] = True
    return table[b.long()]


def _lower_grid(g: torch.Tensor) -> torch.Tensor:
    is_upper = (g >= ord("A")) & (g <= ord("Z"))
    return torch.where(is_upper, g + 32, g)


def _token_grid(batch: Batch, column: str, delims: bytes,
                max_token_len: int, lower: bool = False):
    """Per-row token structure on the [cap, L] byte grid: (grid, is_start,
    lenpos, tok_cnt_row).  ``lenpos[r, i]`` is the clamped length of the
    token starting at byte i, meaningful where ``is_start``."""
    col: StringColumn = batch.columns[column]
    L = col.max_len
    dev = col.data.device
    pos = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    in_row = (pos < col.lengths[:, None]) & batch.valid_mask()[:, None]
    grid = torch.where(in_row, col.data, ord(" ")).to(torch.uint8)
    # delimiter classification sees the raw bytes; lowering comes after
    nondelim = ~_is_delim(grid, delims)
    if lower:
        grid = _lower_grid(grid)
    prev_nd = torch.nn.functional.pad(nondelim[:, :-1], (1, 0))
    is_start = nondelim & ~prev_nd
    delim_pos = torch.where(~nondelim, pos, L)
    next_delim = torch.flip(torch.cummin(torch.flip(delim_pos, [1]), 1).values,
                            [1])
    lenpos = torch.clamp(next_delim - pos, max=max_token_len)
    return grid, is_start, lenpos, is_start.sum(dim=1, dtype=torch.int32)


def _token_slots(is_start, extra_grids, tok_cnt_row, cap: int, L: int,
                 out_capacity: int, max_tokens_per_row: int | None):
    """Per-START-cell lanes in flat token-slot order: (1) a batched stable
    row sort on ~is_start puts a row's k-th token at column k; (2) token
    (row, k) goes to slot base_excl[row] + k, base from the prefix_sum
    kernel.  Returns (slot lanes [out_capacity] per extra grid,
    num_tokens, rows over the per-row bound)."""
    dev = is_start.device
    K = min(max_tokens_per_row or (L // 2 + 1), L // 2 + 1)
    col_k = torch.sort((~is_start).to(torch.int32), dim=1,
                       stable=True).indices[:, :K]           # [cap, K]
    cnt_k = torch.clamp(tok_cnt_row, max=K)
    base_incl = prefix_sum(cnt_k)                           # [cap] i32
    num_tokens = base_incl[cap - 1] if cap else \
        torch.zeros((), dtype=torch.int32, device=dev)
    base_excl = (base_incl - cnt_k).to(torch.int64)
    kk = torch.arange(K, device=dev)[None, :]
    slot = base_excl[:, None] + kk                          # [cap, K]
    keep = (kk < cnt_k[:, None]) & (slot < out_capacity)
    dst = torch.where(keep, slot, out_capacity).reshape(-1)
    out = []
    for g in extra_grids:
        lane = torch.gather(g, 1, col_k).reshape(-1)
        buf = torch.zeros(out_capacity + 1, dtype=g.dtype, device=dev)
        buf[dst] = lane
        out.append(buf[:out_capacity])
    # rows beyond the static per-row token bound lose tokens: a NEED
    over_row = (torch.max(tok_cnt_row) > K) if cap else \
        torch.zeros((), dtype=torch.bool, device=dev)
    return out, num_tokens, over_row


def _extract_bytes(flat: torch.Tensor, start_pos, tok_len, T: int,
                   max_token_len: int) -> torch.Tensor:
    """Token bytes: a [T, max_token_len] window gather from the flat byte
    grid, zero past each token's length."""
    N = flat.shape[0]
    w = torch.arange(max_token_len, device=flat.device)[None, :]
    idx = torch.clamp(start_pos.long()[:, None] + w, 0, max(N - 1, 0))
    tok = flat[idx] if N else torch.zeros((T, max_token_len),
                                          dtype=torch.uint8,
                                          device=flat.device)
    return torch.where(w < tok_len[:, None], tok, 0).to(torch.uint8)


def _poslen_lanes(abs_pos, lenpos, one_lane: bool) -> List[torch.Tensor]:
    """(abs_pos, len) as carry lanes: packed (abs_pos << 5 | len) when
    positions fit 2**27 and lengths fit 5 bits, else two lanes."""
    if one_lane:
        return [(abs_pos << 5) | lenpos.to(torch.int64)]
    return [abs_pos, lenpos.to(torch.int64)]


def _poslen_decode(lanes, one_lane: bool, valid):
    if one_lane:
        pk = lanes[0]
        start_pos = pk >> 5
        tok_len = torch.where(valid, pk & 0x1F, 0)
    else:
        start_pos = lanes[0]
        tok_len = torch.where(valid, lanes[1], 0)
    return start_pos, tok_len.to(torch.int32)


def _one_lane_ok(cap: int, L: int, max_token_len: int) -> bool:
    return cap * L < (1 << 27) and max_token_len < 32


def _abs_pos(cap: int, L: int, dev) -> torch.Tensor:
    """[cap, L] int64 flat byte position of every grid cell."""
    return torch.arange(cap * L, dtype=torch.int64, device=dev).reshape(cap, L)


def split_tokens(batch: Batch, column: str, out_capacity: int,
                 max_token_len: int = 24, delims: bytes = _DELIMS,
                 max_tokens_per_row: int | None = None
                 ) -> Tuple[Batch, torch.Tensor]:
    """Split a string column into a batch of tokens (one row per token).

    Returns ``(tokens_batch, need)``: tokens longer than ``max_token_len``
    are truncated; ``need`` (i32 scalar) is nonzero when tokens beyond
    ``out_capacity`` (or rows beyond ``max_tokens_per_row``) were dropped
    — the executor retries the stage with scaled capacity."""
    col: StringColumn = batch.columns[column]
    cap, L = col.capacity, col.max_len
    dev = col.data.device
    grid, is_start, lenpos, tok_cnt_row = _token_grid(
        batch, column, delims, max_token_len)
    one_lane = _one_lane_ok(cap, L, max_token_len)
    lanes_in = _poslen_lanes(_abs_pos(cap, L, dev), lenpos, one_lane)
    slots, num_tokens, over_row = _token_slots(
        is_start, lanes_in, tok_cnt_row, cap, L, out_capacity,
        max_tokens_per_row)
    t = torch.arange(out_capacity, dtype=torch.int32, device=dev)
    n_out = torch.clamp(num_tokens, max=out_capacity)
    start_pos, tok_len = _poslen_decode(slots, one_lane, t < n_out)
    tok_bytes = _extract_bytes(grid.reshape(-1), start_pos, tok_len,
                               out_capacity, max_token_len)
    out = Batch({column: StringColumn(tok_bytes, tok_len)},
                n_out.to(torch.int32))
    need = torch.where(num_tokens > out_capacity, num_tokens, 0)
    need = torch.where(over_row, torch.clamp(need, min=out_capacity * 2),
                       need)
    return out, need.to(torch.int32)


# two independent odd bases for the 64-bit-budget polynomial pair
_HB1 = 0x85EBCA6B
_HB2 = 0xC2B2AE35


def _window_hashes(grid: torch.Tensor, lenpos: torch.Tensor, W: int):
    """Per-CELL polynomial hashes of the token starting at each byte:
    h(cell) = sum_{d < len} (byte[d]+1) * B**d (mod 2**32), for two odd
    bases.  Each term is under 2**41 and at most W <= 2**16 of them are
    summed, so the int64 sum is exact before the final 32-bit mask."""
    cap, L = grid.shape
    padg = torch.nn.functional.pad(grid, (0, W)).to(torch.int64)
    h1 = torch.zeros((cap, L), dtype=torch.int64, device=grid.device)
    h2 = torch.zeros_like(h1)
    p1 = 1
    p2 = 1
    for d in range(W):
        b = padg[:, d:L + d] + 1
        m = d < lenpos
        h1 += torch.where(m, b * p1, 0)
        h2 += torch.where(m, b * p2, 0)
        p1 = (p1 * _HB1) & M32
        p2 = (p2 * _HB2) & M32
    h1 &= M32
    # fold the length (cheap extra discrimination for truncated tokens)
    h2 = (h2 & M32) ^ ((lenpos.to(torch.int64) * 0x9E3779B9) & M32)
    return h1, h2


def tokenize_group_count(batch: Batch, column: str, out_capacity: int,
                         vocab_capacity: int, count_name: str,
                         max_token_len: int = 24, delims: bytes = _DELIMS,
                         lower: bool = False,
                         max_tokens_per_row: int | None = None
                         ) -> Tuple[Batch, torch.Tensor]:
    """Fused SelectMany(split) -> GroupBy(token) -> Count.

    Returns (groups batch [vocab_capacity] with columns (column,
    count_name), need) — need covers token overflow, per-row overflow and
    vocabulary overflow.  Grouping is by the 64-bit polynomial hash pair
    without byte verification, the JAX package's collision budget."""
    col: StringColumn = batch.columns[column]
    cap, L = col.capacity, col.max_len
    dev = col.data.device
    grid, is_start, lenpos, tok_cnt_row = _token_grid(
        batch, column, delims, max_token_len, lower=lower)
    h1g, h2g = _window_hashes(grid, lenpos, max_token_len)
    one_lane = _one_lane_ok(cap, L, max_token_len)
    extra = [h1g, h2g] + _poslen_lanes(_abs_pos(cap, L, dev), lenpos,
                                       one_lane)
    slots, num_tokens, over_row = _token_slots(
        is_start, extra, tok_cnt_row, cap, L, out_capacity,
        max_tokens_per_row)

    # group the token stream by hash pair; counts are index differences
    # of the dense group-end rows
    t = torch.arange(out_capacity, dtype=torch.int32, device=dev)
    n_tok = torch.clamp(num_tokens, max=out_capacity)
    tvalid = t < n_tok
    h1 = torch.where(tvalid, slots[0], M32)
    h2 = torch.where(tvalid, slots[1], M32)
    (sh1, sh2), scarry = _sort_carrying([h1, h2], slots[2:], stable=False)
    _is_s, is_end, num_groups = _segment_flags(_lane_differs(sh1, sh2),
                                               n_tok)
    dperm = _stable_front(is_end)
    dl = [c.index_select(0, dperm) for c in scarry]
    didx = dperm.to(torch.int32)
    cnt_g = didx - torch.cat([torch.full((1,), -1, dtype=torch.int32,
                                         device=dev), didx[:-1]])

    # representative byte extraction at VOCABULARY size only
    V = vocab_capacity
    gv = torch.arange(V, dtype=torch.int32, device=dev) < \
        torch.clamp(num_groups, max=V)

    def _v(a):
        if a.shape[0] >= V:
            return a[:V]
        return torch.cat([a, a.new_zeros(V - a.shape[0])])

    start_pos, tok_len = _poslen_decode([_v(a) for a in dl], one_lane, gv)
    tok_bytes = _extract_bytes(grid.reshape(-1), start_pos, tok_len, V,
                               max_token_len)
    counts = torch.where(gv, _v(cnt_g), 0).to(torch.int32)
    out = Batch({column: StringColumn(tok_bytes, tok_len),
                 count_name: counts},
                torch.clamp(num_groups, max=V).to(torch.int32))
    need = torch.where(num_tokens > out_capacity, num_tokens, 0).long()
    factor = -(-num_groups.long() // V)
    vocab_need = torch.clamp(factor * out_capacity, max=_I32_MAX)
    need = torch.where(num_groups > V, torch.maximum(need, vocab_need), need)
    need = torch.where(over_row, torch.clamp(need, min=out_capacity * 2),
                       need)
    return out, need.to(torch.int32)
