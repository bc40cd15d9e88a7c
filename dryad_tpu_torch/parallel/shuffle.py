"""Hash, range and broadcast exchange across the logical partitions of
one device — the port of the pack form of
``dryad_tpu/parallel/shuffle.py``.

The JAX package runs each exchange inside ``shard_map`` with one
``all_to_all`` over the mesh.  Here the P partitions share one device, so
an exchange takes the list of per-partition Batches:

  PACK (all P source partitions at once): the per-destination counts
  [P, D] (ONE ``hist_buckets`` launch), their exclusive prefix per row
  (ONE ``prefix_sum`` over the flattened counts, less each row's base),
  one stable sort by destination of every row, the packed u32 words of
  every column gathered in that order into one [P, cap, W] buffer, and
  the send-slot grid (ONE ``slot_expand`` launch), all inside the
  profiler range ``dryad.exchange.pack``;
  ALL_TO_ALL: none on one device — ``slot_expand`` stores each (source,
  destination) block straight at its place in the receive layout
  [P_dst, P_src*C, W];
  UNPACK (per destination): the valid prefix of every source block,
  densely (``slot_compact`` kernel), unpacked into columns.

A hash exchange sends row r to lo(hash(keys[r])) % P; a range exchange
to the partition whose sampled split points bracket the row's first sort
lane (``range_exchange``).  A broadcast (``broadcast_gather``) gives
every partition all partitions' valid rows: the JAX package's
``all_gather`` + compaction is ONE ``slot_compact`` launch over the
stacked partitions here.  The JAX package's gather form of the
exchange exists only for backends
without its kernels; the port has no such backend.  The NEED channels are
kept: capacity shortfalls come back as the measured requirement, and the
executor retries at that size instead of dropping rows.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch.profiler import record_function

from dryad_tpu_torch.data.columnar import Batch, StringColumn
from dryad_tpu_torch.ops.hashing import hash_batch_keys
from dryad_tpu_torch.ops.hopper_kernels import (hist_buckets_batched,
                                                prefix_sum, slot_compact,
                                                slot_expand_batched)
from dryad_tpu_torch.ops.kernels import (_pack_columns_u32,
                                         _unpack_columns_u32,
                                         searchsorted_small, sort_lanes_for)

__all__ = ["exchange_by_dest", "hash_exchange", "range_dest_lane",
           "range_dest", "range_exchange", "broadcast_gather"]


def _canonical_hash_dest(lo: torch.Tensor, nparts: int) -> torch.Tensor:
    """Destination partition of a key's lo-hash on a 1-D mesh — the JAX
    package's mixed-radix mapping reduces to lo % P."""
    return (lo % nparts).to(torch.int32)


def exchange_by_dest(parts: List[Batch], dests: List[torch.Tensor],
                     out_capacity: int, send_slack: int = 2
                     ) -> Tuple[List[Batch], torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """Send each valid row of partition p to partition ``dests[p][row]``
    (1-D mesh: one hop — the pack form of the JAX package's
    ``_exchange_one_axis``).

    Returns ``(batches, need_recv_rows, need_slack, slot_used)`` as 0-d
    int32 tensors: the NEEDs are 0 when everything fit, else the measured
    requirement (max rows a destination must hold / the send-slot slack
    factor that would fit); ``slot_used`` is the max rows any source sent
    one destination."""
    D = len(parts)
    cap = parts[0].capacity
    # per-destination send slots: sized for the whole batch going to one
    # destination would square the buffer, so slack x the fair share,
    # raised by the executor's retry from the measured need
    C = max(1, min(cap, -(-send_slack * cap // D)))

    # invalid rows go to the sentinel bucket D, which nothing counts
    dest = torch.stack([torch.where(b.valid_mask(), d.to(torch.int32), D)
                        for b, d in zip(parts, dests)])      # [P, cap]
    packed = [_pack_columns_u32(b.columns) for b in parts]
    spec = packed[0][1]
    with record_function("dryad.exchange.pack"):
        counts_m = hist_buckets_batched(dest, D)             # [src, dst]
        # exclusive offsets of every row from one scan: the flat
        # exclusive prefix less its row's first entry (exact: 32-bit
        # addition is modular)
        excl = prefix_sum(counts_m.view(-1)).view(D, D) - counts_m
        offsets = excl - excl[:, :1]
        order = torch.sort(dest, dim=1, stable=True).indices  # (dest, row)
        words = torch.empty((D, cap, packed[0][0].shape[1]),
                            dtype=torch.int32, device=dest.device)
        for p, (w, _spec) in enumerate(packed):
            torch.index_select(w, 0, order[p], out=words[p])
        # the all_to_all: block (d, p) lands at recv[d, p*C:(p+1)*C]
        recv = slot_expand_batched(words, offsets, C)      # [dst, src*C, W]
    send_counts = torch.clamp(counts_m, max=C)
    recv_counts = send_counts.t().contiguous()             # [dst, src]
    totals = recv_counts.sum(dim=1, dtype=torch.int32)

    out = []
    for d in range(D):
        ow = slot_compact(recv[d], recv_counts[d], C, out_capacity)
        out.append(Batch(_unpack_columns_u32(ow, spec),
                         torch.clamp(totals[d], max=out_capacity)))

    # measured requirements, pre-truncation so they are exact even when
    # this run dropped rows
    max_total = counts_m.sum(dim=0).max().to(torch.int32)
    need_recv = torch.where(max_total > out_capacity, max_total, 0)
    max_cnt = counts_m.max().to(torch.int32)
    need_slack = torch.where(max_cnt > C, -(-max_cnt * D // cap), 0)
    return out, need_recv, need_slack.to(torch.int32), max_cnt


def hash_exchange(parts: List[Batch], keys: Sequence[str],
                  out_capacity: int, send_slack: int = 2):
    """Repartition rows by key hash (HashPartition / shuffle for GroupBy):
    row r goes to partition lo(hash(keys[r])) % P."""
    D = len(parts)
    dests = [_canonical_hash_dest(hash_batch_keys(b, keys)[1], D)
             for b in parts]
    return exchange_by_dest(parts, dests, out_capacity, send_slack)


def range_dest_lane(col) -> torch.Tensor:
    """The ordering lane range partitioning decides on: the column's FIRST
    ascending sort lane (``ops.kernels.sort_lanes_for``).  Order-preserving
    for numerics; for strings the first 4 bytes, so rows equal in the lane
    go to one destination and the partitions' local full-key sorts still
    make a global order."""
    return sort_lanes_for(col, descending=False)[0]


def range_dest(col, bounds: torch.Tensor,
               descending: bool = False) -> torch.Tensor:
    """Each row's destination: searchsorted(bounds, lane, right), or
    P - 1 - that for a descending primary key.  ``bounds`` is the [P-1]
    split points over the ordering lane (int64 lanes in [0, 2**32))."""
    dest = searchsorted_small(bounds, range_dest_lane(col), side="right")
    return bounds.shape[0] - dest if descending else dest


def range_exchange(parts: List[Batch], key: str, bounds: torch.Tensor,
                   out_capacity: int, descending: bool = False,
                   send_slack: int = 2):
    """Repartition by ranges of ``key`` (``range_dest``), with ``bounds``
    from the executor's sampling (``Executor._range_bounds``)."""
    dests = [range_dest(b.columns[key], bounds, descending) for b in parts]
    return exchange_by_dest(parts, dests, out_capacity, send_slack)


def broadcast_gather(parts: List[Batch], out_capacity: int
                     ) -> Tuple[List[Batch], torch.Tensor, torch.Tensor]:
    """Replicate every partition's valid rows to every partition (the
    broadcast join's right side, the k-means centroids): partition-major,
    in row order within a partition, ``out_capacity`` rows.

    The JAX package all-gathers the P partitions and compacts them with a
    2-key sort on (invalid flag, row index).  Here the P partitions lie
    stacked on one card, so the compaction is ONE ``slot_compact`` over
    their packed words [P*cap, W] with each partition a source block of
    C = cap rows: it packs each block's valid prefix in source order,
    which is that sort's order.  Every partition gets the same Batch.

    Returns ``(batches, need_recv_rows, need_slack = 0)``: the need is the
    total when it exceeds ``out_capacity``, else 0."""
    cap = parts[0].capacity
    words, spec = _pack_columns_u32(
        {k: _cat_column([b.columns[k] for b in parts])
         for k in parts[0].names})
    counts = torch.stack([b.count.to(torch.int32) for b in parts])
    total = counts.sum(dtype=torch.int32)
    out = slot_compact(words, counts, cap, out_capacity)
    batch = Batch(_unpack_columns_u32(out, spec),
                  torch.clamp(total, max=out_capacity))
    need = torch.where(total > out_capacity, total, 0).to(torch.int32)
    return [batch] * len(parts), need, torch.zeros_like(need)


def _cat_column(cols: list):
    """One column of every partition, stacked row-wise [P*cap, ...]."""
    if isinstance(cols[0], StringColumn):
        return StringColumn(torch.cat([c.data for c in cols]),
                            torch.cat([c.lengths for c in cols]))
    return torch.cat(cols)
