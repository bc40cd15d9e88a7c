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
  [P_dst, P_src*C, W]; across the processes of a gang (a ``mesh`` with
  world > 1) ONE host-staged all_to_all of that grid and the counts,
  then a reorder of the received blocks into global source order;
  UNPACK (all P destinations at once): the valid prefix of every source
  block, densely (ONE ``slot_compact`` launch into [P_dst, out_cap, W]),
  unpacked into columns once; each destination's Batch holds views [d]
  of them.

A hash exchange sends row r to lo(hash(keys[r])) % P, which on a mesh
of several axes is the JAX package's mixed-radix destination, so its one
hop puts every row where the JAX package's hop per axis does.  With
``axis`` set (the hierarchical aggregation's combine stages) it changes
only the row's coordinate on that mesh axis, to (lo // radix) % size,
keeping its others: on one card that is the same exchange to another
destination; on a gang the ``dp`` hop stays inside each worker (no row
crosses a process) and the ``dcn`` hop, whose coordinate is the rank,
is the only one with a cross-process all_to_all.  A range exchange
to the partition whose sampled split points bracket the row's first sort
lane (``range_exchange``).  A broadcast (``broadcast_gather``) gives
every partition all partitions' valid rows: the JAX package's
``all_gather`` + compaction is ONE ``slot_compact`` launch over the
stacked partitions here.  The hot-key-salted join exchange
(``skew_join_exchange``) is a hash exchange of the left side with hot
keys spread over every partition, a broadcast of the right side's hot
rows and a hash exchange of the rest; the zip exchange
(``zip_exchange``) moves right rows to the partition holding the same
global row index on the left.  The JAX package's gather form of the
exchange exists only for backends
without its kernels; the port has no such backend.  The NEED channels are
kept: capacity shortfalls come back as the measured requirement, and the
executor retries at that size instead of dropping rows.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch.profiler import record_function

from dryad_tpu_torch.data.columnar import Batch, StringColumn, map_column
from dryad_tpu_torch.ops.hashing import hash_batch_keys
from dryad_tpu_torch.ops.hopper_kernels import (hist_buckets_batched,
                                                prefix_sum,
                                                slot_compact_batched,
                                                slot_expand_batched)
from dryad_tpu_torch.ops.kernels import (_pack_columns_u32,
                                         _unpack_columns_u32, compact,
                                         concat2, searchsorted_small,
                                         sort_lanes_for, zip2)

__all__ = ["send_slot_rows", "exchange_by_dest", "hash_exchange",
           "range_dest_lane",
           "range_dest", "range_exchange", "broadcast_gather",
           "skew_join_exchange", "zip_exchange"]


def _canonical_hash_dest(lo: torch.Tensor, nparts: int) -> torch.Tensor:
    """Destination partition of a key's lo-hash on a 1-D mesh — the JAX
    package's mixed-radix mapping reduces to lo % P."""
    return (lo % nparts).to(torch.int32)


def send_slot_rows(cap: int, D: int, send_slack: int,
                   slot_rows: int | None = None) -> int:
    """The rows C of each (source, destination) send slot: a measured
    ``slot_rows`` where one is given, else the structural slack x the
    fair share (sized for a whole partition going to one destination, the
    buffer would be squared); never more than the partition's capacity."""
    if slot_rows is not None:
        return max(1, min(cap, slot_rows))
    return max(1, min(cap, -(-send_slack * cap // D)))


def exchange_by_dest(parts: List[Batch], dests: List[torch.Tensor],
                     out_capacity: int, send_slack: int = 2,
                     slot_rows: int | None = None, mesh=None,
                     fanout: int | None = None
                     ) -> Tuple[List[Batch], torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """Send each valid row of partition p to partition ``dests[p][row]``
    (1-D mesh: one hop — the pack form of the JAX package's
    ``_exchange_one_axis``).  The send slots hold ``send_slot_rows``
    rows: a measured ``slot_rows`` (the executor's probe or the feedback
    of an earlier run) or the structural slack; a measured slot that
    falls short comes back as ``need_slack`` like the slack's.

    Returns ``(batches, need_recv_rows, need_slack, slot_used)`` as 0-d
    int32 tensors: the NEEDs are 0 when everything fit, else the measured
    requirement (max rows a destination must hold / the send-slot slack
    factor that would fit); ``slot_used`` is the max rows any source sent
    one destination (the measured slot an executor feeds back).

    On a gang ``mesh`` (``parallel/mesh.py``, world > 1) ``parts`` are
    this rank's P_loc partitions and the destinations run over all P:
    the counts are [P_loc, P], the grid [P, P_loc*C, W] holds each
    destination rank's block contiguously, and ONE host-staged
    all_to_all sends every rank its block and the counts it needs.  The
    received grid is reordered rank-major into [P_loc, P*C, W], source
    blocks in global source order, and ONE ``slot_compact`` unpacks it:
    every row lands where the one-process exchange puts it.  The NEEDs
    are then this rank's; the executor's all-reduce (max) of its info
    vector makes them the gang's.

    ``fanout`` is the number of destinations a source can reach (an axis
    exchange's axis size; default all of them): the send slots and the
    slack need are sized by it, as the JAX package sizes a hop by its
    axis."""
    S = len(parts)
    gang = mesh is not None and mesh.gang
    D = mesh.nparts if gang else S
    fan = fanout or D
    cap = parts[0].capacity
    C = send_slot_rows(cap, fan, send_slack, slot_rows)
    # the all_to_all: block (d, p) lands at recv[d, p*C:(p+1)*C]
    recv, counts_m, spec = _pack(parts, dests, D, C)   # [dst, src*C, W]
    if gang:
        recv, counts_in = _cross_exchange(recv, counts_m, C, mesh)
    else:
        counts_in = counts_m.t()                           # [dst, src]
    return _unpack(recv, counts_in, counts_m, C, out_capacity, fan, cap,
                   spec)


def _pack(parts: List[Batch], dests: List[torch.Tensor], D: int, C: int):
    """The pack side of an exchange to ``D`` destinations: (the send grid
    [D, S*C, W] whose block (d, p) holds partition p's rows for d, the
    counts [S, D], the packed columns' spec)."""
    S = len(parts)
    cap = parts[0].capacity
    # invalid rows go to the sentinel bucket D, which nothing counts
    dest = torch.stack([torch.where(b.valid_mask(), d.to(torch.int32), D)
                        for b, d in zip(parts, dests)])      # [S, cap]
    packed = [_pack_columns_u32(b.columns) for b in parts]
    with record_function("dryad.exchange.pack"):
        counts_m = hist_buckets_batched(dest, D)             # [src, dst]
        # exclusive offsets of every row from one scan: the flat
        # exclusive prefix less its row's first entry (exact: 32-bit
        # addition is modular)
        excl = prefix_sum(counts_m.view(-1)).view(S, D) - counts_m
        offsets = excl - excl[:, :1]
        order = torch.sort(dest, dim=1, stable=True).indices  # (dest, row)
        words = torch.empty((S, cap, packed[0][0].shape[1]),
                            dtype=torch.int32, device=dest.device)
        for p, (w, _spec) in enumerate(packed):
            torch.index_select(w, 0, order[p], out=words[p])
        grid = slot_expand_batched(words, offsets, C)
    return grid, counts_m, packed[0][1]


def _unpack(recv: torch.Tensor, counts_in: torch.Tensor,
            counts_m: torch.Tensor, C: int, out_capacity: int, fan: int,
            cap: int, spec) -> Tuple[List[Batch], torch.Tensor,
                                     torch.Tensor, torch.Tensor]:
    """The unpack side: the valid prefix of every source block of
    ``recv`` [Dd, S*C, W] (``counts_in`` [Dd, S] unclamped) in ONE
    ``slot_compact``, and the NEEDs measured before truncation, so they
    are exact even when this run dropped rows (``counts_m``: what this
    process sent from partitions of capacity ``cap``, ``fan``
    destinations a source)."""
    recv_counts = torch.clamp(counts_in, max=C).contiguous()
    totals = recv_counts.sum(dim=1, dtype=torch.int32)
    out = _unpack_dests(slot_compact_batched(recv, recv_counts, C,
                                             out_capacity), spec,
                        torch.clamp(totals, max=out_capacity))
    max_total = counts_in.sum(dim=1).max().to(torch.int32)
    need_recv = torch.where(max_total > out_capacity, max_total, 0)
    max_cnt = counts_m.max().to(torch.int32)
    need_slack = torch.where(max_cnt > C, -(-max_cnt * fan // cap), 0)
    return out, need_recv, need_slack.to(torch.int32), max_cnt


def _rank_exchange(parts: List[Batch], ranks: List[torch.Tensor],
                   out_capacity: int, send_slack: int,
                   slot_rows: int | None, mesh
                   ) -> Tuple[List[Batch], torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """The ``dcn`` hop on a gang: local partition l's row goes to rank
    ``ranks[l][row]``, to ITS local partition l (the row keeps its inner
    coordinates).  The pack kernels see R destinations a source: counts
    [L, R], a grid [R, L*C, W] holding each destination rank's blocks
    contiguously; ONE host-staged all_to_all sends every rank its blocks
    and counts, and destination l's received blocks, one per source
    rank, are in global source order, so ONE ``slot_compact`` unpacks
    them as the one-card axis exchange does."""
    L, R = len(parts), mesh.world
    cap = parts[0].capacity
    C = send_slot_rows(cap, R, send_slack, slot_rows)
    grid, counts_m, spec = _pack(parts, ranks, R, C)
    n_words = grid[0].numel()
    got = mesh.all_to_all(torch.cat([grid.view(R, n_words),
                                     counts_m.t().contiguous()], 1))
    recv = got[:, :n_words].reshape(R, L, C, grid.shape[2]) \
        .permute(1, 0, 2, 3).contiguous().view(L, R * C, grid.shape[2])
    counts_in = got[:, n_words:].t()                     # [l dst, src rank]
    return _unpack(recv, counts_in, counts_m, C, out_capacity, R, cap, spec)


def _cross_exchange(grid: torch.Tensor, counts_m: torch.Tensor, C: int,
                    mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gang's all_to_all of an exchange: ``grid`` [P, P_loc*C, W]
    (destination-major, so rank r's destinations are one contiguous
    block) and this rank's unclamped counts [P_loc, P] go out in ONE
    host-staged all_to_all; returns this rank's receive grid
    [P_loc, P*C, W] with source blocks in global source order, and its
    counts [P_loc dst, P src]."""
    R, L = mesh.world, mesh.local_nparts
    W = grid.shape[2]
    n_words = L * L * C * W
    # per destination rank: its block of the grid, then the counts its
    # destinations get from this rank's sources, [L dst, L src]
    cnt = counts_m.view(L, R, L).permute(1, 2, 0)
    buf = torch.cat([grid.view(R, n_words), cnt.reshape(R, L * L)], 1)
    got = mesh.all_to_all(buf)                       # [R src rank, ...]
    recv = got[:, :n_words].view(R, L, L * C, W).permute(1, 0, 2, 3) \
        .reshape(L, R * L * C, W)
    counts_in = got[:, n_words:].view(R, L, L).permute(1, 0, 2) \
        .reshape(L, R * L)
    return recv, counts_in


def _unpack_dests(ow: torch.Tensor, spec, counts: torch.Tensor
                  ) -> List[Batch]:
    """One Batch per destination from a compaction's [Dd, rows, W] words:
    the columns unpacked once from the [Dd*rows, W] view, destination d's
    Batch holding their views [d] and the count ``counts[d]``."""
    Dd, rows, W = ow.shape
    cols = _unpack_columns_u32(ow.view(Dd * rows, W), spec)
    return [Batch({k: map_column(v, lambda x, d=d: x.view(
        (Dd, rows) + tuple(x.shape[1:]))[d]) for k, v in cols.items()},
        counts[d]) for d in range(Dd)]


def _nparts(parts: List[Batch], mesh) -> int:
    """P: every partition of the gang on a gang mesh, else the list's."""
    return mesh.nparts if mesh is not None and mesh.gang else len(parts)


def hash_exchange(parts: List[Batch], keys: Sequence[str],
                  out_capacity: int, send_slack: int = 2,
                  slot_rows: int | None = None, mesh=None,
                  axis: str | None = None):
    """Repartition rows by key hash (HashPartition / shuffle for GroupBy):
    row r goes to partition lo(hash(keys[r])) % P.

    With ``axis`` set, the exchange touches only that axis of ``mesh``
    (the hierarchical aggregation's hops): the row keeps its source
    partition's coordinates on the other axes and takes
    (lo // radix) % size on this one, the same mixed-radix key -> place
    mapping as the global form, so the last hop leaves each key where
    the global exchange puts it."""
    if axis is None:
        D = _nparts(parts, mesh)
        dests = [_canonical_hash_dest(hash_batch_keys(b, keys)[1], D)
                 for b in parts]
        return exchange_by_dest(parts, dests, out_capacity, send_slack,
                                slot_rows, mesh=mesh)
    if mesh is None or axis not in mesh.axis_names:
        raise ValueError(f"exchange over axis {axis!r}: the mesh has axes "
                         f"{mesh.axis_names if mesh is not None else ()}")
    radix, size = mesh.axis_radix(axis), mesh.axis_size(axis)
    coords = [(hash_batch_keys(b, keys)[1] // radix) % size for b in parts]
    if mesh.gang and axis == mesh.axis_names[0]:
        # the dcn coordinate is the rank
        return _rank_exchange(parts, coords, out_capacity, send_slack,
                              slot_rows, mesh)
    # an inner axis stays inside this process: partition q's row goes to
    # q with its coordinate on ``axis`` replaced (local indices on a gang)
    dests = []
    for q, c in enumerate(coords):
        g = q + mesh.part_start
        dests.append(g - (g // radix) % size * radix + c * radix
                     - mesh.part_start)
    return exchange_by_dest(parts, dests, out_capacity, send_slack,
                            slot_rows, fanout=size)


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
                   send_slack: int = 2, slot_rows: int | None = None,
                   mesh=None):
    """Repartition by ranges of ``key`` (``range_dest``), with ``bounds``
    from the executor's sampling (``Executor._range_bounds``)."""
    dests = [range_dest(b.columns[key], bounds, descending) for b in parts]
    return exchange_by_dest(parts, dests, out_capacity, send_slack,
                            slot_rows, mesh=mesh)


def broadcast_gather(parts: List[Batch], out_capacity: int, mesh=None
                     ) -> Tuple[List[Batch], torch.Tensor, torch.Tensor]:
    """Replicate every partition's valid rows to every partition (the
    broadcast join's right side, the k-means centroids): partition-major,
    in row order within a partition, ``out_capacity`` rows.

    The JAX package all-gathers the P partitions and compacts them with a
    2-key sort on (invalid flag, row index).  Here the P partitions lie
    stacked on one card, so the compaction is ONE ``slot_compact`` over
    their packed words [1, P*cap, W] (one destination) with each
    partition a source block of C = cap rows: it packs each block's
    valid prefix in source order, which is that sort's order.  Every
    partition gets the same Batch.  On a gang ``mesh`` each rank packs
    its P_loc partitions and ONE host-staged all_gather (words and counts
    together) stacks all P of them in partition order before the same
    one compaction.

    Returns ``(batches, need_recv_rows, need_slack = 0)``: the need is the
    total when it exceeds ``out_capacity``, else 0."""
    cap = parts[0].capacity
    words, spec = _pack_columns_u32(
        {k: _cat_column([b.columns[k] for b in parts])
         for k in parts[0].names})
    counts = torch.stack([b.count.to(torch.int32) for b in parts])
    if mesh is not None and mesh.gang:
        n = words.numel()
        got = mesh.all_gather(torch.cat([words.reshape(-1), counts]))
        words = got[:, :n].reshape(-1, words.shape[1])
        counts = got[:, n:].reshape(-1)
    total = counts.sum(dtype=torch.int32)
    (batch,) = _unpack_dests(slot_compact_batched(
        words[None], counts[None], cap, out_capacity), spec,
        torch.clamp(total, max=out_capacity)[None])
    need = torch.where(total > out_capacity, total, 0).to(torch.int32)
    return [batch] * len(parts), need, torch.zeros_like(need)


def _cat_column(cols: list):
    """One column of every partition, stacked row-wise [P*cap, ...]."""
    if isinstance(cols[0], StringColumn):
        return StringColumn(torch.cat([c.data for c in cols]),
                            torch.cat([c.lengths for c in cols]))
    return torch.cat(cols)


def _left_heavy_hitters(lo: torch.Tensor, valid: torch.Tensor, topk: int,
                        hot_factor: float, mesh=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Globally hot key hashes from per-partition heavy hitters.  ``lo``
    and ``valid`` are [P, cap]: every partition's lo-hashes and valid
    flags.

    Each partition nominates its top-``topk`` most frequent lo-hashes
    (a local run count over its sorted lo-hashes); a candidate's global
    count sums the counts of every partition that NOMINATED it (not a
    true global count, as in the JAX package), and a candidate is hot
    when that exceeds ``hot_factor`` x the balanced per-partition share.
    The JAX package's all_gather of the candidates is the [P, topk]
    result itself here, and its psum of the valid counts a sum.  Ties
    among equal counts pick any of them, as ``argsort`` does there.  On a
    gang ``mesh`` ``lo`` / ``valid`` are this rank's [P_loc, cap] and
    ONE all_gather brings every rank's candidates, counts and valid
    total, so every rank holds the same global result.
    Returns (cand [P*topk] int64, hot [P*topk] bool)."""
    Ploc, cap = lo.shape
    k = min(topk, cap)
    dev = lo.device
    # invalid rows take a key above every lo-hash and sort last
    s = torch.sort(torch.where(valid, lo, 1 << 32), dim=1).values
    sval = s < (1 << 32)
    first = torch.ones((Ploc, 1), dtype=torch.bool, device=dev)
    is_start = sval & torch.cat([first, s[:, 1:] != s[:, :-1]], dim=1)
    # run number of every valid row; the rest go to a dump slot
    seg = torch.where(sval, torch.cumsum(is_start, 1) - 1, cap)
    counts = torch.zeros((Ploc, cap + 1), dtype=torch.int32, device=dev
                         ).scatter_add_(1, seg, sval.to(torch.int32))
    rep = torch.zeros((Ploc, cap + 1), dtype=torch.int64, device=dev
                      ).scatter_(1, torch.where(is_start, seg, cap), s)
    cnts, top = torch.topk(counts[:, :cap], k, dim=1)
    cand = rep.gather(1, top).reshape(-1)
    cnts = cnts.reshape(-1)
    n_valid = valid.sum()
    P = Ploc
    if mesh is not None and mesh.gang:
        P = mesh.nparts
        m = cand.numel()
        got = mesh.all_gather(torch.cat([cand, cnts.to(torch.int64),
                                         n_valid.reshape(1)]))
        cand, cnts = got[:, :m].reshape(-1), got[:, m:2 * m].reshape(-1)
        n_valid = got[:, 2 * m].sum()
    eq = cand[:, None] == cand[None, :]
    global_cnt = (eq * cnts[None, :]).sum(dim=1)
    share = torch.clamp(n_valid // P, min=1)
    hot = (cnts > 0) & (global_cnt.to(torch.float32)
                        > hot_factor * share.to(torch.float32))
    return cand, hot


def _is_member(lo: torch.Tensor, cand: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Rows whose lo-hash is one of the masked-in candidates (-1 never
    equals a lo-hash in [0, 2**32))."""
    return torch.isin(lo, torch.where(mask, cand, -1))


def skew_join_exchange(left: List[Batch], right: List[Batch], left_keys,
                       right_keys, left_cap: int, right_cap: int,
                       hot_factor: float = 4.0, topk: int = 8,
                       send_slack: int = 2, mesh=None):
    """Hot-key-salted join repartition: the escape a 95 %-hot join key
    needs, where one destination would otherwise hold ~all left rows.

    Left rows of HOT keys spread over ALL partitions ((canonical + i) % P,
    i the row's position in its partition after the leg's ops); the right
    side splits: its hot-key rows are replicated to every partition (ONE
    ``slot_compact``, ``broadcast_gather``), the rest hash-exchange
    canonically, so every matching pair still meets exactly once.  Each
    partition's left capacity then tracks ~N/P instead of ~N.  The output
    placement is NOT hash by key any more; the planner allows salting
    only on stages whose placement no later stage trusted
    (``Stage.salt_ok``).  Both right parts are appended with ``concat2``,
    so the right side's capacity becomes 2 x ``right_cap``.

    Returns (left', right', need_left_rows, need_right_rows,
    need_slack)."""
    P = _nparts(left, mesh)
    llo = torch.stack([hash_batch_keys(b, list(left_keys))[1]
                       for b in left])
    lvalid = torch.stack([b.valid_mask() for b in left])
    cand, hot = _left_heavy_hitters(llo, lvalid, topk, hot_factor, mesh)
    is_hot_l = _is_member(llo, cand, hot)
    base = _canonical_hash_dest(llo, P)
    salt = torch.arange(llo.shape[1], dtype=torch.int32,
                        device=llo.device) % P
    ldest = torch.where(is_hot_l, (base + salt) % P, base)
    lout, lnr, lnsl, _ls = exchange_by_dest(left, list(ldest), left_cap,
                                            send_slack, mesh=mesh)

    r_hot, r_non = [], []
    for b in right:
        hot_r = _is_member(hash_batch_keys(b, list(right_keys))[1], cand,
                           hot)
        # compact keeps valid rows only
        r_hot.append(compact(b, hot_r))
        r_non.append(compact(b, ~hot_r))
    # hot right rows must be visible on every salted destination
    rh, rnr1, _ = broadcast_gather(r_hot, right_cap, mesh)
    # compaction REORDERED the rows: hash_exchange takes the destinations
    # from the compacted batches' own keys
    rn, rnr2, rnsl, _rs = hash_exchange(r_non, list(right_keys), right_cap,
                                        send_slack, mesh=mesh)
    rout = [concat2(h, n) for h, n in zip(rh, rn)]
    return (lout, rout, lnr, torch.maximum(rnr1, rnr2),
            torch.maximum(lnsl, rnsl))


def zip_exchange(a: List[Batch], b: List[Batch], suffix: str = "_r",
                 send_slack: int = 2, mesh=None
                 ) -> Tuple[List[Batch], torch.Tensor, torch.Tensor]:
    """Globally aligned positional Zip (LINQ Zip across partitions): the
    right row with global index g pairs with the left row with global
    index g, whatever the two sides' per-partition counts.  Right rows
    go to the partition whose left rows cover g (``searchsorted`` over
    the left side's running ends, on the device); rows past the left
    side's total are dropped (shorter-side semantics; ``zip2`` trims the
    other side).

    The JAX package re-sorts the received rows by (invalid, g); here the
    exchange already delivers them source partition by source partition,
    each source's rows in row order, which is g order, so no column
    carries g and no sort runs.

    Returns (batches, need_recv, need_slack).  A destination never
    receives more rows than its left count, so a receive shortfall
    cannot happen by scaling; only send slots can fall short.  On a gang
    ``mesh`` ONE all_gather brings both sides' counts of every partition
    (the global row index), and the exchange crosses ranks."""
    P = _nparts(a, mesh)
    zero = torch.zeros((), dtype=torch.int32, device=a[0].device)
    if P == 1:   # one partition: already globally aligned
        return [zip2(a[0], b[0], suffix)], zero, zero
    if mesh is not None and mesh.gang:
        got = mesh.all_gather(torch.stack(
            [x.count for x in a] + [x.count for x in b]).to(torch.int64)
        ).view(mesh.world, 2, len(a))
        counts_a = got[:, 0].reshape(-1)
        counts_b = got[:, 1].reshape(-1)
        first = mesh.part_start
    else:
        counts_a = torch.stack([x.count for x in a]).to(torch.int64)
        counts_b = torch.stack([x.count for x in b]).to(torch.int64)
        first = 0
    ends_a = torch.cumsum(counts_a, 0)
    starts_b = torch.cumsum(counts_b, 0) - counts_b
    dests = []
    for p, x in enumerate(b):
        g = starts_b[first + p] + torch.arange(x.capacity, device=x.device)
        d = searchsorted_small(ends_a, g, side="right")
        dests.append(torch.where(g < ends_a[-1], d, P))  # past the end: drop
    recv, need_recv, need_slack, _slot = exchange_by_dest(
        b, dests, a[0].capacity, send_slack, mesh=mesh)
    return ([zip2(x, r, suffix) for x, r in zip(a, recv)], need_recv,
            need_slack)
