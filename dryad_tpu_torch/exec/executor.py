"""Stage-graph executor over the logical mesh — the port of the stage loop
of ``dryad_tpu/exec/executor.py``.

The JAX package runs each stage as ONE jit(shard_map) program whose
``per_shard`` body applies each leg's ops and exchange, then the body ops,
on every device.  Here the P partitions share one device: each leg is a
Python loop over the partitions for its ops and one batched exchange
across all of them, then a loop for the body ops; a two-input body op
(``join``, ``zip``, ``apply2``, ``semi_anti``, ``concat``) takes the
other legs' partitions.  Every op returns a NEED
vector ``[need_scale, need_slack]`` that stays on the device; the
executor reads it with the stage's info vector (the exchanges' own share
of the need beside it; see below for when) and, on overflow, re-runs the
stage at the measured scale and send-slot slack instead of dropping rows.
An overflow no scale can fix (a ``with_capacity`` truncation, a zip
alignment shortfall) raises ``CapacityError``.  A saltable join stage
whose exchanges fall short by at least ``salt_trigger_factor`` x their
capacity re-runs with the hot-key-salted exchange instead
(``shuffle.skew_join_exchange``), and stays salted in later runs of the
same plan.  ``stage_log`` keeps each stage's attempts, exchanging legs,
final capacity scale, whether it ran salted, each attempt's send-slot
rows and their sources, the slot probes it ran and each exchanging leg's
received rows per destination from the last ``run``.

Each hash or range exchange ships measured send slots where it can, in
the JAX package's order of sources: the slot an earlier run of the same
stage measured (``_slot_hints``: feedback keyed by the stage's
fingerprint and the leg), else, for a first-wave pure hash leg of at
least ``JobConfig.exchange_probe_min_mb``, a counts-only probe (ONE
batched ``hist_buckets`` over the [P, cap] destinations and one scalar
read, ``_probe_slot_rows``), else the structural slack.  Every attempt
feeds its exchanges' measured slots back through the attempt's info read
(the settle's, under deferral).  A measured slot that meets other data
and falls short is a send-slack shortfall like any other, and the stage
retries.

A range exchange splits on bounds sampled from the output of its
``bounds_from`` stage (``_range_bounds``), once per stage before the
retry loop and on the device.  The global positional ops (``take``,
``row_index``, ``skip``, ``take_while``, ``skip_while``) need every
partition's count or "clean" flag, ``sliding_window`` the next
partition's first rows and count (its halo), ``zip`` both sides' counts,
and the
lookup-join choice every partition's duplicate flag, so the executor
applies those over the whole partition list (``_POSITIONAL``,
``_join_global``, ``shuffle.zip_exchange``); only the duplicate flags
are read on the host.  The other two-input body ops (``apply2`` of
``cross_apply``, the set operators' ``semi_anti`` and ``concat``) pair
each partition with the other leg's same partition.  A broadcast leg
hands every partition the same replicated Batch.  ``run`` binds a
do_while body's placeholder to the previous iteration's output.

``run`` executes a graph through a lineage-tracked ``exec.recovery.Run``.
With ``JobConfig.deferred_needs`` (the default) a stage's first attempt
reads nothing back: its info vector stays on the device, and the Run
reads every stage's in ONE batched read at job end (``Run._settle``),
then replays an overflowed stage and every stage computed from it
synchronously.  Without it, or with ``spill_dir``, each attempt reads its
info at once (``host_reads`` counts the reads of either kind).  Each
stage's attempts, the settle's among them, fold into ONE ``stage_log``
entry; ``settle_replayed`` marks a stage the settle re-ran.

Every attempt's output has a static byte size, ``out_bytes`` (each
leaf's ``numel * element_size``, no device read).  A run given a cost
report (``run(..., cost_report=)``, ``analysis/cost.py``) cross-checks
each stage that settled without overflow against its prediction and
emits ``cost_model_miss`` for rows or bytes outside it.  With
``JobConfig(adaptive="on")`` each accepted synchronous attempt leaves
its measured rows as ``adapt.stats.StageStats`` in the run's one-slot
box, for the rewrite rules.  The executor counts stage runs, their
wall, their output bytes and capacity retries in ``obs.metrics``'s
registry.

Each ``stage_done`` carries ``compile_s``: the seconds the attempt
spent compiling kernels at their first use (``ops/_build.py``), 0.0
once they are built.  The port has no compiled-stage cache, so there is
no ``cache_hit``.  With ``JobConfig.profile_dir`` every ``run`` is
wrapped in ``torch.profiler.profile`` (host activity, and CUDA activity
on a CUDA device) and writes a Chrome trace under that directory.  On
CUDA the window opens with ``_PROFILE_PAD_LAUNCHES`` launches of a
one-element kernel, and a profile in which one of the run's own kernel
launches has no device record raises rather than write a trace with
records missing.

Per-run state lives on the run (``exec.recovery.Run``): its stage log,
its host reads and probes, its adaptive rewrites and whether one moved
its output's placement.  Several runs may share one executor at once
(the job service's fleet threads, a run started from another run's event
sink): the executor's ``stage_log`` and ``_last_run_*`` are the values
of the run that ended last, set when it ends; ``host_reads`` and
``probes_run`` are totals over every run, added under ``_cache_lock``,
which also guards the shared slot caches (``_slot_feedback``,
``_slot_probe_cache``), as the JAX executor's ``_cache_lock`` does.

On a gang mesh (``parallel/mesh.Mesh`` with world > 1: one worker
process of several, each holding ``local_nparts`` of the ``nparts``
partitions) every read across partitions is gang-wide: the exchanges
cross processes (``shuffle``'s ``mesh`` argument), the positional ops,
the range samples and the sliding window's halo gather what the other
ranks hold, the slot probe and every info read take the all-reduce
(max) of every rank's, with per-partition entries at their global
place.  Every rank then takes the same decisions, and the output is
the one-process run's partitions.  At world 1 each collective is the
identity.

Not ported yet (a later slice, see ROADMAP.md): remembered capacity
scales.
"""

from __future__ import annotations

import collections
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import torch

from dryad_tpu_torch.data.columnar import Batch, StringColumn, map_column
from dryad_tpu_torch.exec.data import PData, split_partitions, \
    stack_partitions
from dryad_tpu_torch.obs.metrics import REGISTRY, family_counter
from dryad_tpu_torch.ops import _build, kernels
from dryad_tpu_torch.ops.hashing import M32, hash_batch_keys
from dryad_tpu_torch.ops.hopper_kernels import hist_buckets_batched
from dryad_tpu_torch.ops.text import lower_ascii, split_tokens, \
    tokenize_group_count
from dryad_tpu_torch.parallel import shuffle
from dryad_tpu_torch.parallel.mesh import STAGED
from dryad_tpu_torch.plan.stages import Exchange, Stage, StageGraph, StageOp
from dryad_tpu_torch.utils.config import JobConfig

__all__ = ["Executor", "CapacityError"]

# stage-loop metrics, resolved once (get-or-create handles are stable)
_M_STAGE_RUNS = family_counter(REGISTRY, "stage_runs")
_M_RUN_S = family_counter(REGISTRY, "run_seconds")
_M_SHUFFLE_B = family_counter(REGISTRY, "shuffle_bytes")
_M_CAP_RETRIES = family_counter(REGISTRY, "cap_retries")
_M_COMPILE_S = family_counter(REGISTRY, "compile_seconds")


class CapacityError(RuntimeError):
    pass


def _no_event(_e: dict) -> None:
    pass


# the no-op sink admits no level: spans and the resource sampler skip all
# their work for a run with no event log
_no_event.level = -1


# torch.profiler on the H100 can drop the first device records of a
# window (a contiguous run of them, more after many profiler sessions in
# one process).  A profiled run on CUDA opens its window with this many
# launches of a one-element kernel, which take that loss, and is held to
# a device record for each of its own launches
_PROFILE_PAD_LAUNCHES = 1024


def _launches_without_record(events, skip: int = 0) -> Tuple[int, int]:
    """A profile's device records, and how many of its kernel launches
    (host-side runtime or driver calls), past the first ``skip`` in
    launch (correlation id) order, have no device record with their
    correlation id: records the profiler dropped."""
    launched, recorded = [], set()
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            recorded.add(e.correlation_id())
        elif "Launch" in e.name() and "Kernel" in e.name():
            launched.append(e.correlation_id())
    return len(recorded), sum(c not in recorded
                              for c in sorted(launched)[skip:])


# sentinel need: the overflow source cannot be fixed by scaling
_UNSCALABLE = 1 << 30
# op kinds whose overflow a larger capacity scale fixes (exchanges too)
_SCALABLE_OVERFLOW_KINDS = {"flat_tokens", "flat_map", "join", "zip",
                            "group_apply"}
# slot feedback is kept for a stage's first legs only, as in the JAX
# package (its info vector has a fixed width)
_SLOT_FEEDBACK_LEGS = 4


def _quantize_slot_rows(slot: int) -> int:
    """A measured slot rounded UP to a grid of about 1/16 of its size (the
    JAX package's compile-cache grid; here it leaves a measured slot some
    room for data that drifts between runs)."""
    g = max(16, 1 << max(int(slot).bit_length() - 4, 0))
    return -(-int(slot) // g) * g


def _leaves(b: Batch) -> List[torch.Tensor]:
    """Every tensor of a batch: the columns' (a string's data and
    lengths), then the count."""
    out = []
    for v in b.columns.values():
        out.extend((v.data, v.lengths) if isinstance(v, StringColumn)
                   else (v,))
    return out + [b.count]


def _out_bytes(pd: PData) -> int:
    """Bytes of a stage output on the device: every leaf's numel x
    element size, the [P] count vector included (shape metadata, no
    device read)."""
    return sum(t.numel() * t.element_size() for t in _leaves(pd.batch))


def _stage_overflow_scalable(stage: Stage) -> bool:
    kinds = ({op.kind for leg in stage.legs for op in leg.ops}
             | {op.kind for op in stage.body})
    return bool(kinds & _SCALABLE_OVERFLOW_KINDS) or any(
        leg.exchange is not None for leg in stage.legs)


def _needs(dev, ns=None, nsl=None) -> torch.Tensor:
    """Pack an int32[2] (need_scale, need_slack) vector."""
    z = torch.zeros((), dtype=torch.int32, device=dev)
    return torch.stack([z if ns is None else ns.to(torch.int32),
                        z if nsl is None else nsl.to(torch.int32)])


def _scale_need(need_rows: torch.Tensor, base_capacity: int) -> torch.Tensor:
    """Rows needed -> capacity scale needed (0 stays 0)."""
    return (-(-need_rows.long() // max(base_capacity, 1))).to(torch.int32)


def _apply_op(b: Batch, op: StageOp, scale: int,
              index: int = 0) -> Tuple[Batch, torch.Tensor]:
    """Apply one StageOp to partition ``index``'s batch; returns (batch,
    needs) where needs = int32[2] (need_scale, need_slack): 0 = fits,
    > 0 = the measured requirement for a right-sized retry."""
    k, p = op.kind, op.params
    dev = b.device
    if k == "fn":
        return Batch(dict(p["fn"](dict(b.columns))), b.count), _needs(dev)
    if k == "apply":
        return (p["fn"](b, index) if p["with_index"] else p["fn"](b)), \
            _needs(dev)
    if k == "flat_map":
        out, need_rows = kernels.flat_map_expand(
            b, p["fn"], p["out_capacity"] * scale)
        return out, _needs(dev, _scale_need(need_rows, p["out_capacity"]))
    if k == "group_apply":
        G0, C0, O0 = p["max_groups"], p["group_capacity"], p["out_capacity"]
        out, ng, ms, tot = kernels.group_regroup_apply(
            b, list(p["keys"]), p["fn"], G0 * scale, C0 * scale,
            p["out_rows"], O0 * scale)
        # the largest of the three needs: more groups, a larger group or
        # more output rows than this scale holds
        ns = torch.maximum(torch.maximum(
            torch.where(ng > G0 * scale, _scale_need(ng, G0), 0),
            torch.where(ms > C0 * scale, _scale_need(ms, C0), 0)),
            torch.where(tot > O0 * scale, _scale_need(tot, O0), 0))
        return out, _needs(dev, ns)
    if k == "filter":
        return kernels.compact(b, p["fn"](dict(b.columns))), _needs(dev)
    if k == "mean_fin":
        return Batch(kernels.mean_finalize_columns(dict(b.columns),
                                                   p["cols"]), b.count), \
            _needs(dev)
    if k == "flat_tokens":
        mtr = p.get("max_tokens_per_row")
        out, need_rows = split_tokens(
            b, p["column"], out_capacity=p["out_capacity"] * scale,
            max_token_len=p["max_token_len"], delims=p["delims"],
            max_tokens_per_row=(mtr * scale if mtr else None))
        if p["lower"]:
            out = Batch({p["column"]: lower_ascii(out.columns[p["column"]])},
                        out.count)
        return out, _needs(dev, _scale_need(need_rows, p["out_capacity"]))
    if k == "tokens_group_count":
        mtr = p.get("max_tokens_per_row")
        out, need_rows = tokenize_group_count(
            b, p["column"], out_capacity=p["out_capacity"] * scale,
            vocab_capacity=p["vocab_capacity"] * scale,
            count_name=p["count_name"], max_token_len=p["max_token_len"],
            delims=p["delims"], lower=p["lower"],
            max_tokens_per_row=(mtr * scale if mtr else None))
        return out, _needs(dev, _scale_need(need_rows, p["out_capacity"]))
    if k == "group":
        return kernels.group_aggregate(b, list(p["keys"]),
                                       dict(p["aggs"])), _needs(dev)
    if k == "dgroup_local":
        return kernels.group_decompose_local(
            b, list(p["keys"]), p["decs"], p["box"]), _needs(dev)
    if k == "dgroup_partial":
        return kernels.group_decompose_partial(
            b, list(p["keys"]), p["decs"], p["box"]), _needs(dev)
    if k == "dgroup_merge":
        return kernels.group_decompose_merge(
            b, list(p["keys"]), p["decs"], p["box"], p["finalize"]), \
            _needs(dev)
    if k == "group_top_k":
        return kernels.group_top_k(b, list(p["keys"]), p["k"], p["by"],
                                   p["descending"]), _needs(dev)
    if k == "group_rank":
        return kernels.group_rank_select(b, list(p["keys"]), p["by"],
                                         p["rank"], p["out"]), _needs(dev)
    if k == "distinct":
        return kernels.distinct(b, list(p["keys"]) or None), _needs(dev)
    if k == "sort":
        return kernels.sort_by_columns(b, list(p["keys"])), _needs(dev)
    if k == "recap":
        cap = p["capacity"]
        if cap >= b.capacity:
            return b.pad_to(cap), _needs(dev)
        trunc = b.map(lambda x: x[:cap])
        return (trunc.with_count(torch.clamp(b.count, max=cap)),
                _needs(dev, torch.where(b.count > cap, _UNSCALABLE, 0)))
    raise ValueError(f"unknown op kind {k}")


# two-input body ops other than the join: (partition, the other leg's
# partition, params) -> batch; none of them can overflow
_TWO_INPUT_OPS = {
    # the user's fn(batch, other) per partition (cross_apply)
    "apply2": lambda b, o, p: p["fn"](b, o),
    # canonical (sorted) column order on both sides: the two legs may
    # carry the same columns in different insertion order
    "semi_anti": lambda b, o, p: kernels.semi_anti_join(
        b, o, sorted(b.names), sorted(o.names), anti=p["anti"]),
    "concat": lambda b, o, p: kernels.concat2(b, o),
}


def _join_global(lparts: List[Batch], rparts: List[Batch], op: StageOp,
                 scale: int) -> Tuple[List[Batch], torch.Tensor]:
    """The ``join`` body op over every partition.  With ``right_unique``
    every partition runs ``lookup_join`` and the P duplicate flags it
    returns are read in ONE host sync; a partition whose right side has
    a duplicate hash takes the general join instead (the JAX package
    picks each partition's lowering with ``lax.cond``).  The join's need
    is the largest partition's."""
    p = op.params
    lk, rk = list(p["left_keys"]), list(p["right_keys"])
    how, cap = p["how"], p["out_capacity"] * scale

    def general(lb, rb):
        return kernels.general_join(lb, rb, lk, rk, out_capacity=cap,
                                    how=how)

    if p["right_unique"] and how in ("inner", "left"):
        looked = [kernels.lookup_join(lb, rb, lk, rk, out_capacity=cap,
                                      how=how)
                  for lb, rb in zip(lparts, rparts)]
        dups = torch.stack([d for _, _, d in looked]).tolist()
        results = [general(lb, rb) if dup else (out, nr)
                   for lb, rb, (out, nr, _), dup
                   in zip(lparts, rparts, looked, dups)]
    else:
        results = [general(lb, rb) for lb, rb in zip(lparts, rparts)]
    need = torch.stack([nr for _, nr in results]).max()
    return ([out for out, _ in results],
            _needs(need.device, _scale_need(need, p["out_capacity"])))


def _starts(parts: List[Batch], mesh) -> torch.Tensor:
    """[P_loc] global row index of each local partition's first row (the
    exclusive prefix of every partition's count, on the device; a gang
    all-gathers the counts first)."""
    counts = mesh.gather_parts(
        torch.stack([b.count for b in parts]).to(torch.int64))
    return mesh.local(torch.cumsum(counts, 0) - counts)


def _take_global(parts: List[Batch], p, mesh) -> List[Batch]:
    """The first ``n`` rows over all partitions in partition order:
    partition p keeps clip(n - sum_{q<p} count_q, 0, count_p)."""
    n = p["n"]
    local = [kernels.take(b, n) for b in parts]
    counts = torch.stack([b.count for b in local])
    keep = torch.minimum(torch.clamp(n - _starts(local, mesh), min=0),
                         counts).to(torch.int32)
    return [Batch(b.columns, keep[q]) for q, b in enumerate(local)]


def _row_index_global(parts: List[Batch], p, mesh) -> List[Batch]:
    """A global int32 row-index column: each partition's rows count on
    from the rows of the partitions before it."""
    starts = _starts(parts, mesh)
    return [Batch(dict(b.columns, **{p["column"]: (
        starts[q] + torch.arange(b.capacity, device=b.device)).to(
            torch.int32)}), b.count) for q, b in enumerate(parts)]


def _skip_global(parts: List[Batch], p, mesh) -> List[Batch]:
    """Drop the first ``n`` rows over all partitions: partition q drops
    its first clip(n - start_q, 0, count_q) rows."""
    starts = _starts(parts, mesh)
    out = []
    for q, b in enumerate(parts):
        drop = torch.minimum(torch.clamp(p["n"] - starts[q], min=0),
                             b.count)
        out.append(kernels.compact(
            b, torch.arange(b.capacity, device=b.device) >= drop))
    return out


def _while_global(parts: List[Batch], p, mesh, take: bool
                  ) -> List[Batch]:
    """take_while / skip_while over the global row order: the prefix is
    each partition's rows before its first failing row, and counts only
    while every earlier partition is clean (no failing row; a gang
    all-gathers every partition's first failing row and count)."""
    firsts = []
    for b in parts:
        valid = b.valid_mask()
        fail = ~p["fn"](dict(b.columns)) & valid
        idx = torch.arange(b.capacity, device=b.device)
        firsts.append(torch.minimum(
            torch.where(fail, idx, b.capacity).min(), b.count))
    first = torch.stack(firsts)
    counts = torch.stack([b.count for b in parts])
    if mesh.gang:
        both = mesh.gather_parts(torch.stack([first.to(torch.int32),
                                              counts.to(torch.int32)], 1))
        first, counts = both[:, 0], both[:, 1]
    clean = (first >= counts).to(torch.int32)
    # every partition before q clean: the exclusive running product
    before_clean = torch.cat([clean.new_ones(1),
                              torch.cumprod(clean, 0)[:-1]]) > 0
    prefix = mesh.local(torch.where(before_clean, first, 0))
    out = []
    for q, b in enumerate(parts):
        if take:
            out.append(b.with_count(prefix[q]))
        else:
            out.append(kernels.compact(
                b, torch.arange(b.capacity, device=b.device) >= prefix[q]))
    return out


def _window_take(x: torch.Tensor, nx: torch.Tensor, halo: int,
                 widx: torch.Tensor) -> torch.Tensor:
    """Rows ``widx`` [cap, w] of ``x`` with the first ``halo`` rows of
    ``nx`` appended (zero rows where ``nx`` holds fewer)."""
    head = nx[:halo]
    if head.shape[0] < halo:
        head = torch.cat([head, head.new_zeros(
            (halo - head.shape[0],) + tuple(head.shape[1:]))])
    ext = torch.cat([x, head])
    return ext.index_select(0, widx.reshape(-1)).reshape(
        tuple(widx.shape) + tuple(x.shape[1:]))


def _halo_from_next_rank(parts: List[Batch], halo: int, mesh) -> Batch:
    """The next rank's first partition as a halo source: its first
    min(halo, cap) rows and its count, packed into ONE int32 buffer and
    sent to the rank before (``Mesh.from_next``; the last rank gets
    zeros, and takes no halo)."""
    b0 = parts[0]
    n = min(halo, b0.capacity)
    words, spec = kernels._pack_columns_u32(
        {k: map_column(v, lambda x: x[:n]) for k, v in b0.columns.items()})
    W = words.shape[1]
    got = mesh.from_next(torch.cat([words.reshape(-1),
                                    b0.count.to(torch.int32).reshape(1)]))
    return Batch(kernels._unpack_columns_u32(got[:-1].view(n, W), spec),
                 got[-1])


def _sliding_window_global(parts: List[Batch], p, mesh
                           ) -> Tuple[List[Batch], torch.Tensor]:
    """Windows of ``w`` consecutive rows in global row order: row i of
    partition q becomes rows i .. i + w - 1, the rows past its count
    taken from partition q + 1's first w - 1 (the halo; the JAX package
    sends them with a ``ppermute``).  Windows crossing the dataset's end
    are dropped, so the last partition takes no halo, and padding rows
    never enter a window.  A partition before the last whose next one
    holds fewer than w - 1 rows is an unscalable shortfall, as in the JAX
    package.  Reads nothing on the host.  On a gang the last local
    partition's next one is the next rank's first
    (``_halo_from_next_rank``)."""
    w = p["w"]
    halo = w - 1
    dev = parts[0].device
    if halo == 0:
        return [b.map(lambda x: x[:, None]) for b in parts], _needs(dev)
    P = len(parts)
    last_rank = mesh.rank == mesh.world - 1
    remote = _halo_from_next_rank(parts, halo, mesh) if mesh.gang else None
    needs = _needs(dev)
    out = []
    for q, b in enumerate(parts):
        nxt = parts[(q + 1) % P]
        if q == P - 1 and remote is not None:
            nxt = remote
        cap = b.capacity
        if q == P - 1 and last_rank:
            avail = torch.zeros((), dtype=torch.int32, device=dev)
        else:
            avail = torch.clamp(nxt.count, max=halo)
            needs = torch.maximum(needs, _needs(dev, torch.where(
                nxt.count < halo, _UNSCALABLE, 0)))
        # the halo lands at position count: rows past count are padding
        ext = torch.arange(cap + halo, device=dev)
        src = torch.where(ext < b.count, torch.clamp(ext, max=cap - 1),
                          torch.clamp(cap + (ext - b.count),
                                      max=cap + halo - 1))
        widx = src.index_select(0, (
            torch.arange(cap, device=dev)[:, None]
            + torch.arange(w, device=dev)[None, :]).reshape(-1)).reshape(
            cap, w)
        cols = {}
        for k, v in b.columns.items():
            nv = nxt.columns[k]
            if isinstance(v, StringColumn):
                cols[k] = StringColumn(
                    _window_take(v.data, nv.data, halo, widx),
                    _window_take(v.lengths, nv.lengths, halo, widx))
            else:
                cols[k] = _window_take(v, nv, halo, widx)
        out.append(Batch(cols, torch.clamp(b.count + avail - halo, 0, cap)
                         .to(torch.int32)))
    return out, needs


# single-input ops over the whole partition list: (partitions, params,
# mesh) -> partitions; each needs every partition's count or "clean"
# flag, and none can overflow
_POSITIONAL = {
    "take": _take_global,
    "row_index": _row_index_global,
    "skip": _skip_global,
    "take_while": lambda parts, p, mesh: _while_global(parts, p, mesh,
                                                       take=True),
    "skip_while": lambda parts, p, mesh: _while_global(parts, p, mesh,
                                                       take=False),
}


def _sample_lanes(col, counts: torch.Tensor, S: int) -> torch.Tensor:
    """[P, S] ordering lanes: partition p's first min(count, S) samples
    evenly spread over its valid rows.  The stride is overflow-safe in
    int32, as the JAX package computes it: i*(cnt//take) +
    (i*(cnt%take))//take, clipped to cap - 1."""
    if isinstance(col, StringColumn):
        P, cap, L = col.data.shape
        flat = StringColumn(col.data.reshape(P * cap, L),
                            col.lengths.reshape(P * cap))
        lane = shuffle.range_dest_lane(flat).reshape(P, cap)
    else:
        lane = shuffle.range_dest_lane(col)
        cap = lane.shape[1]
    cnt = counts.to(torch.int64)[:, None]
    take = torch.clamp(torch.clamp(cnt, max=S), min=1)
    i = torch.arange(S, device=lane.device)[None, :]
    idx = torch.clamp(i * (cnt // take) + (i * (cnt % take)) // take,
                      0, cap - 1)
    return torch.gather(lane, 1, idx)


def _fuse_stage_ops(ops: List[StageOp]) -> List[StageOp]:
    """flat_tokens immediately followed by a count-only group over the
    token column becomes ONE fused op: bytes are then extracted only for
    group representatives (ops/text.tokenize_group_count)."""
    out = []
    i = 0
    while i < len(ops):
        op = ops[i]
        if (op.kind == "flat_tokens" and i + 1 < len(ops)
                and ops[i + 1].kind == "group"):
            g = ops[i + 1]
            aggs = dict(g.params["aggs"])
            if (list(g.params["keys"]) == [op.params["column"]]
                    and len(aggs) == 1
                    and all(kind == "count" and v is None
                            for kind, v in aggs.values())):
                p = dict(op.params)
                p["count_name"] = next(iter(aggs))
                p["vocab_capacity"] = max(1 << 16, p["out_capacity"] // 32)
                out.append(StageOp("tokens_group_count", p))
                i += 2
                continue
        out.append(op)
        i += 1
    return out


def _apply_exchange(parts: List[Batch], ex: Exchange, scale: int,
                    slack: int, bounds: Optional[torch.Tensor],
                    slot_rows: Optional[int] = None, mesh=None
                    ) -> Tuple[List[Batch], torch.Tensor, torch.Tensor]:
    """Returns (batches, needs[2], slot_used): the exchange's measured
    max send-slot rows (0 for a broadcast), fed back to later runs of the
    stage.  A hash exchange with ``axis`` set moves rows over that mesh
    axis only (``shuffle.hash_exchange``)."""
    cap = ex.out_capacity * scale
    slot = torch.zeros((), dtype=torch.int32, device=parts[0].device)
    if ex.kind == "hash":
        # empty keys = whole row; sorted so both legs of a set op agree
        keys = list(ex.keys) or sorted(parts[0].names)
        out, nr, nsl, slot = shuffle.hash_exchange(
            parts, keys, cap, send_slack=slack, slot_rows=slot_rows,
            mesh=mesh, axis=ex.axis)
    elif ex.kind == "range":
        out, nr, nsl, slot = shuffle.range_exchange(
            parts, ex.bounds_key, bounds, cap, descending=ex.descending,
            send_slack=slack, slot_rows=slot_rows, mesh=mesh)
    elif ex.kind == "broadcast":
        out, nr, nsl = shuffle.broadcast_gather(parts, cap, mesh)
    else:
        raise ValueError(ex.kind)
    return (out, _needs(nr.device, _scale_need(nr, ex.out_capacity), nsl),
            slot.to(torch.int32))


class Executor:
    """Executes StageGraphs on a logical mesh."""

    def __init__(self, mesh, event_log: Optional[Callable[[dict], None]]
                 = None, config: JobConfig | None = None):
        self.mesh = mesh
        self.nparts = mesh.nparts
        self.config = config or JobConfig()
        # the process-default event sink; a Run may pass its own
        self._event = event_log or _no_event
        # the stage log of the run that ended last (``Run.stage_log``: one
        # entry per stage it ran, with its attempts, the deferred one and
        # the settle's replays among them, and its final scale / slack),
        # set when that run ends
        self.stage_log: List[Dict] = []
        # host reads of stages' info vectors over every run: one per
        # synchronous attempt, one per deferred settle
        self.host_reads = 0
        # guards the shared caches below and the totals: runs on other
        # threads (the job service's fleet) share this executor
        self._cache_lock = threading.RLock()
        # (stage fingerprint, leg) -> the max send-slot rows the leg's
        # exchange last measured (LRU)
        self._slot_feedback: "collections.OrderedDict" = \
            collections.OrderedDict()
        # probe results over live input tensors (LRU), and the number of
        # probes that ran over every run (each one batched hist_buckets
        # launch)
        self._slot_probe_cache: "collections.OrderedDict" = \
            collections.OrderedDict()
        self.probes_run = 0
        # the adaptive rewrites of the run that ended last, and whether one
        # of them flipped a join's broadcast (each run keeps its own:
        # ``Run.rewrites`` / ``Run.placement_changed``)
        self._last_run_rewrites = 0
        self._last_run_placement_changed = False
        # the Chrome traces of the runs profiled under
        # JobConfig.profile_dir, in run order
        self.profile_paths: List[str] = []
        # whether a Run ends with a job_done event: a farm worker's
        # executor runs one task of a job, not a job (runtime/worker.py)
        self._emit_job_done = True

    def apply_config(self, config) -> None:
        """Re-point a persistent executor at a new job's JobConfig (a
        worker process keeps one executor across the tasks it runs; its
        slot feedback and probe caches carry over)."""
        self.config = config or JobConfig()

    def _tally(self, run, name: str) -> None:
        """Count one ``name`` ("host_reads" or "probes_run") for ``run``
        (a ``Run``) and in the executor's total."""
        setattr(run, name, getattr(run, name) + 1)
        with self._cache_lock:
            setattr(self, name, getattr(self, name) + 1)

    def _probe_slot_rows(self, pd: PData, keys, slack: int,
                         run, axis: Optional[str] = None) -> int:
        """Counts-only pre-hop of a first-wave pure hash exchange: every
        partition's destination counts in ONE batched ``hist_buckets``
        over the [P, cap] destinations, their max, one scalar read.  The
        exchange then ships the measured slot instead of the structural
        slack.  Quantized up to C_struct / 16 rows (at least 16), where
        C_struct = ceil(slack * cap / D), D the destinations a source
        reaches (P; an ``axis`` exchange's axis size, whose destination
        is the row's coordinate on the axis); cached by the input's live
        tensors, so probing the same data again reads nothing."""
        b0 = pd.batch
        cap, D = pd.capacity, self.nparts
        Ploc = pd.nparts
        radix = 1
        if axis is not None:
            radix, D = self.mesh.axis_radix(axis), self.mesh.axis_size(axis)
        # the same live tensors (ids whose objects are all still alive)
        leaves = _leaves(b0)
        rkey = (tuple(keys), slack, axis, tuple(id(x) for x in leaves))
        with self._cache_lock:
            hit = self._slot_probe_cache.get(rkey)
            if hit is not None:
                rows, refs = hit
                if all(r() is not None for r in refs):
                    self._slot_probe_cache.move_to_end(rkey)
                    return rows
                del self._slot_probe_cache[rkey]  # a recycled id: no hit
        # every partition's rows hashed at once, as one [P * cap] batch
        flat = Batch({k: map_column(b0.columns[k], lambda x: x.reshape(
            (Ploc * cap,) + tuple(x.shape[2:]))) for k in keys}, b0.count)
        lo = hash_batch_keys(flat, keys)[1].reshape(Ploc, cap)
        valid = (torch.arange(cap, device=lo.device)[None, :]
                 < b0.count[:, None])
        dest = torch.where(valid, (lo // radix % D).to(torch.int32), D)
        # the one read (of the gang's max, on a gang)
        slot = int(self.mesh.all_reduce_max(
            hist_buckets_batched(dest, D).max()))
        self._tally(run, "probes_run")
        c_struct = max(1, -(-slack * cap // D))
        q = max(16, c_struct // 16)
        rows = max(1, min(c_struct, -(-slot // q) * q))
        with self._cache_lock:
            self._slot_probe_cache[rkey] = (
                rows, tuple(weakref.ref(x) for x in leaves))
            while len(self._slot_probe_cache) > 256:
                self._slot_probe_cache.popitem(last=False)
        return rows

    def _note_slot_feedback(self, stage: Stage, slots: List[int]) -> None:
        """Keep each hash / range leg's measured send-slot rows from an
        attempt's info read (``slots``: one per leg, 0 where nothing was
        measured), for the next attempt and the next run of the stage."""
        fp = stage.fingerprint()
        with self._cache_lock:
            for li, leg in enumerate(stage.legs[:_SLOT_FEEDBACK_LEGS]):
                ex = leg.exchange
                if ex is None or ex.kind == "broadcast" or slots[li] <= 0:
                    continue
                self._slot_feedback[(fp, li)] = slots[li]
                self._slot_feedback.move_to_end((fp, li))
            while len(self._slot_feedback) > 512:
                self._slot_feedback.popitem(last=False)

    def _slot_hints(self, stage: Stage, inputs: List[PData], slack: int,
                    salted: bool, run
                    ) -> List[Tuple[Optional[int], Optional[str]]]:
        """(send-slot rows or None, source) per leg; None, None for a leg
        without a hash or range exchange.  The sources, in order:

        1. "feedback": the slot this leg's exchange measured in an earlier
           attempt or run of the same stage (any hash or range leg);
        2. "probe": ``_probe_slot_rows`` for a pure hash leg (no ops;
           over its mesh axis, if any) whose input holds at least
           ``exchange_probe_min_mb`` MB;
        3. "slack": None, the structural ceil(slack * cap / P).

        A salted attempt, one partition, or ``exchange_probe_min_mb < 0``
        ships the structural slack on every leg.  A probe counts in
        ``run`` (the calling ``Run``)."""
        thresh = self.config.exchange_probe_min_mb
        measured = not (thresh < 0 or salted or self.nparts < 2)
        fp = stage.fingerprint() if measured else None
        hints = []
        for li, (leg, inp) in enumerate(zip(stage.legs, inputs)):
            ex = leg.exchange
            if ex is None or ex.kind not in ("hash", "range"):
                hints.append((None, None))
                continue
            with self._cache_lock:
                fb = (self._slot_feedback.get((fp, li))
                      if measured and li < _SLOT_FEEDBACK_LEGS else None)
            if fb is not None:
                hints.append((_quantize_slot_rows(fb), "feedback"))
            elif (measured and ex.kind == "hash" and not leg.ops
                  and _out_bytes(inp) * self.mesh.world / (1 << 20)
                  >= thresh):
                keys = list(ex.keys) or sorted(inp.batch.names)
                hints.append((self._probe_slot_rows(inp, keys, slack,
                                                    run, ex.axis), "probe"))
            else:
                hints.append((None, "slack"))
        return hints

    def _range_bounds(self, src: PData, key: str) -> torch.Tensor:
        """[P-1] split points over the ordering lane of ``key``, on the
        device: each partition samples at most
        ``range_samples_per_partition`` lanes, invalid sample slots fold
        to the all-ones sentinel and sort last, and the bounds are the
        n_tot * p // P-th of the sorted samples (zeros when no row was
        sampled).  The same bounds as the JAX package's, bit for bit; a
        gang all-gathers every rank's [P_loc, S] samples and counts in
        partition order first, so every rank sorts the same samples."""
        dev = self.mesh.device
        if self.nparts == 1:
            return torch.zeros(0, dtype=torch.int64, device=dev)
        S = self.config.range_samples_per_partition
        lanes = _sample_lanes(src.batch.columns[key], src.counts, S)
        counts = src.counts
        if self.mesh.gang:
            both = self.mesh.gather_parts(torch.cat(
                [lanes, counts.to(torch.int64)[:, None]], 1))
            lanes, counts = both[:, :S], both[:, S]
        take = torch.clamp(counts.to(torch.int64), max=S)          # [P]
        valid = torch.arange(S, device=dev)[None, :] < take[:, None]
        flat = torch.where(valid, lanes, M32).reshape(-1)
        srt = torch.sort(flat).values
        n_tot = take.sum()
        qs = n_tot * torch.arange(1, self.nparts, device=dev) // self.nparts
        bounds = srt.index_select(0, torch.clamp(qs, 0, flat.shape[0] - 1))
        return torch.where(n_tot > 0, bounds, 0)

    def _run_ops(self, parts: List[Batch], ops: List[StageOp], scale: int,
                 slack: int, needs: torch.Tensor, others=()):
        others = list(others)
        mesh = self.mesh
        for op in _fuse_stage_ops(ops):
            if op.kind in _POSITIONAL:
                parts = _POSITIONAL[op.kind](parts, op.params, mesh)
                continue
            if op.kind == "sliding_window":
                parts, nd = _sliding_window_global(parts, op.params, mesh)
                needs = torch.maximum(needs, nd)
                continue
            if op.kind == "zip":
                parts, nr, nsl = shuffle.zip_exchange(
                    parts, others.pop(0), op.params["suffix"], slack,
                    mesh=mesh)
                # a destination holds at most its own left rows, so the
                # receive side fits by construction: only send slots can
                # fall short under skewed right-side counts
                needs = torch.maximum(needs, _needs(
                    nr.device, torch.where(nr > 0, _UNSCALABLE, 0), nsl))
                continue
            if op.kind == "join":
                parts, nd = _join_global(parts, others.pop(0), op, scale)
                needs = torch.maximum(needs, nd)
                continue
            if op.kind in _TWO_INPUT_OPS:
                parts = [_TWO_INPUT_OPS[op.kind](b, o, op.params)
                         for b, o in zip(parts, others.pop(0))]
                continue
            outs = []
            for q, b in enumerate(parts, mesh.part_start):
                b, nd = _apply_op(b, op, scale, q)
                needs = torch.maximum(needs, nd)
                outs.append(b)
            parts = outs
        return parts, needs

    def _run_once(self, stage: Stage, inputs: List[PData], scale: int,
                  slack: int, bounds: Optional[torch.Tensor], salted: bool,
                  hints: List[Tuple[Optional[int], Optional[str]]]):
        """One attempt of a stage: (output, [need_scale, need_slack, the
        exchanges' need_scale, each leg's measured send-slot rows (0 where
        none), the output's rows per partition, then each exchanging leg's
        received rows per destination] on the device (the info vector),
        [(send-slot rows, source)] of each hash / range / zip exchange).
        The exchanges' need is kept apart so that the salting trigger
        reacts to exchange skew only: a join-output shortfall must scale,
        not salt."""
        dev = self.mesh.device
        P = self.nparts
        needs = torch.zeros(2, dtype=torch.int32, device=dev)
        exch_need = torch.zeros((), dtype=torch.int32, device=dev)
        slots = [torch.zeros((), dtype=torch.int32, device=dev)
                 for _ in stage.legs]
        shipped = []
        legs = []
        for leg, inp in zip(stage.legs, inputs):
            parts, needs = self._run_ops(split_partitions(inp), leg.ops,
                                         scale, slack, needs)
            legs.append(parts)
        if salted:
            # both exchanges of the salted form ship the structural slack
            shipped = [(shuffle.send_slot_rows(lg[0].capacity, P, slack),
                        "slack") for lg in legs]
            # both legs' hash exchanges rewritten jointly: the left one
            # spreads hot keys, the right one replicates its hot rows
            lex, rex = stage.legs[0].exchange, stage.legs[1].exchange
            lout, rout, lnr, rnr, nsl = shuffle.skew_join_exchange(
                legs[0], legs[1], lex.keys, rex.keys,
                lex.out_capacity * scale, rex.out_capacity * scale,
                hot_factor=self.config.salt_hot_factor,
                topk=self.config.salt_topk, send_slack=slack,
                mesh=self.mesh)
            nd = _needs(dev, torch.maximum(
                _scale_need(lnr, lex.out_capacity),
                _scale_need(rnr, rex.out_capacity)), nsl)
            needs = torch.maximum(needs, nd)
            exch_need = torch.maximum(exch_need, nd[0])
            legs = [lout, rout]
            exchanged = legs
        else:
            exchanged = []
            for i, leg in enumerate(stage.legs):
                if leg.exchange is None:
                    continue
                rows, source = hints[i]
                if source is not None:
                    ex = leg.exchange
                    fan = self.mesh.axis_size(ex.axis) if ex.axis else P
                    shipped.append((shuffle.send_slot_rows(
                        legs[i][0].capacity, fan, slack, rows), source))
                legs[i], nd, slots[i] = _apply_exchange(
                    legs[i], leg.exchange, scale, slack, bounds, rows,
                    self.mesh)
                needs = torch.maximum(needs, nd)
                exch_need = torch.maximum(exch_need, nd[0])
                exchanged.append(legs[i])
        if any(op.kind == "zip" for op in stage.body):
            # the zip's own exchange sends the right leg's rows
            shipped.append((shuffle.send_slot_rows(legs[1][0].capacity, P,
                                                   slack), "slack"))
        parts, needs = self._run_ops(legs[0], stage.body, scale, slack,
                                     needs, legs[1:])
        out = stack_partitions(parts)
        # per-partition entries at their global place: the gang's
        # all-reduce (max) of the info vector gathers them
        place = self.mesh.place
        recv = [b.count.to(torch.int32) for leg in exchanged for b in leg]
        recv = torch.stack(recv) if recv else out.counts[:0]
        if recv.numel() and self.mesh.gang:
            recv = torch.cat([place(r) for r in recv.view(-1, len(parts))])
        return out, torch.cat([torch.stack(
            [needs[0], needs[1], exch_need] + slots), place(out.counts),
            recv]), shipped

    @staticmethod
    def _leg_input(leg, results: Dict[int, PData],
                   bindings: Dict[str, PData]) -> PData:
        if isinstance(leg.src, int):
            return results[leg.src]
        kind, v = leg.src
        if kind == "source":
            return v
        if kind == "placeholder":
            try:
                return bindings[v]
            except KeyError:
                raise KeyError(f"unbound placeholder {v!r}") from None
        raise ValueError(leg.src)

    def _decide(self, stage: Stage, scale: int, slack: int, salted: bool,
                need_scale: int, need_slack: int, need_exch: int):
        """The JAX package's retry policy (``_decide_needs``), shared by
        the attempt loop and ``Run._settle``: ``("ok",)`` when the attempt
        fit, else ``("retry", scale, slack, salted)``; raises
        CapacityError for an overflow no scale fixes."""
        if need_scale <= 0 and need_slack <= 0:
            return ("ok",)
        if need_scale >= _UNSCALABLE or not _stage_overflow_scalable(stage):
            raise CapacityError(
                f"stage {stage.id} ({stage.label}) overflowed a fixed "
                f"capacity (a with_capacity truncation, a sliding_window "
                f"halo or a zip alignment shortfall): retrying at a larger "
                f"scale cannot succeed; raise the declared capacity "
                f"instead")
        slack = max(slack, min(need_slack, self.nparts))
        if (not salted and stage.salt_ok and self.nparts > 1
                and need_exch >= self.config.salt_trigger_factor * scale):
            # hot-key exchange skew: salting spreads the hot keys, so the
            # retry needs about twice the balanced share, not the hot
            # destination's whole load
            new_scale = max(stage._capacity_scale,
                            -(-need_exch * 2 // self.nparts))
            if need_scale > need_exch:
                new_scale = max(new_scale, need_scale)
            return "retry", new_scale, slack, True
        # right-size from the measured requirement: ONE retry at the exact
        # need instead of a blind doubling ladder
        return "retry", max(scale, need_scale), slack, salted

    @staticmethod
    def _log_attempt(run, stage: Stage, shipped, salted: bool,
                     probes: int, job, staged: int = 0) -> None:
        """Fold one attempt into the stage's entry of ``run.stage_log``
        (made at its first attempt of the current Run.output())."""
        ent = run._log_at.get(stage.id)
        if ent is None:
            # a zip body op runs an exchange of its own
            kinds = [leg.exchange.kind for leg in stage.legs
                     if leg.exchange is not None] + [
                "zip" for op in stage.body if op.kind == "zip"]
            ent = {"stage": stage.id, "label": stage.label,
                   "exchange": kinds[0] if kinds else None,
                   "exchanges": len(kinds),
                   "broadcasts": kinds.count("broadcast"),
                   "attempts": 0, "scale": None, "slack": None,
                   "salted": salted,
                   # each salted attempt broadcast the hot right rows
                   "salted_attempts": 0,
                   # per attempt, each hash / range / zip exchange's
                   # send-slot rows and where they came from
                   "slot_rows": [], "slot_source": [],
                   # slot probes run (one hist_buckets launch each)
                   "probes": 0, "recv_rows": [],
                   # per attempt, the bytes its probes and exchanges
                   # staged across a gang's processes (0 in one process)
                   "staged_bytes": [],
                   # the deferred settle dropped and re-ran this stage
                   # (it overflowed, or an input of it did)
                   "settle_replayed": False, "job": job}
            run._log_at[stage.id] = ent
            run.stage_log.append(ent)
        ent["attempts"] += 1
        ent["salted_attempts"] += salted
        ent["slot_rows"].append([c for c, _ in shipped])
        ent["slot_source"].append([src for _, src in shipped])
        ent["probes"] += probes
        ent["staged_bytes"].append(staged)

    def _log_settled(self, run, stage: Stage, scale: int, slack: int,
                     salted: bool, info: List[int]) -> None:
        """The knobs of the stage's attempt that stands, and its
        exchanging legs' received rows per destination (from ``info``),
        in ``run``'s stage log."""
        P, L = self.nparts, len(stage.legs)
        run._log_at[stage.id].update(
            scale=scale, slack=slack, salted=salted,
            recv_rows=[info[i:i + P]
                       for i in range(3 + L + P, len(info), P)])

    def _check_cost(self, stage: Stage, scale: int, rows_total: int,
                    out_bytes: int, report=None, event=None) -> None:
        """Cross-check one settled (non-overflowing) stage against the
        calling run's static cost prediction: ``cost_model_miss`` events
        for rows or bytes outside it (``analysis.cost.
        check_stage_measurement``).  ``report`` and ``event`` are the
        run's own, never the executor's; the run passes no report for a
        stage that read a rescaled one.  The prediction describes the
        PLANNED capacities, which bound every op's rows: a stage that
        settled at a larger scale, or read one that did, ran past them on
        purpose and is not checked (the JAX package checks its rows and
        reports a join that retried past its planned capacity as a miss:
        ROADMAP Queue 3)."""
        if report is None or scale != 1:
            return
        est = report.stage(stage.id)
        if est is None:
            return
        from dryad_tpu_torch.analysis.cost import check_stage_measurement
        ev = event if event is not None else self._event
        for miss in check_stage_measurement(est, scale, rows_total,
                                            out_bytes, self.nparts):
            ev(miss)

    def _run_stage(self, stage: Stage, run, cost_report=None) -> PData:
        """Run one stage of ``run`` (an ``exec.recovery.Run``) whose inputs
        are materialized.  With the run's deferral list (``run._defer``)
        the first attempt reads nothing back: its record (the stage, its
        info vector on the device, its knobs, its output bytes, the
        enqueue time) is appended for ``Run._settle``.  Otherwise every
        attempt reads its info once, emits ``stage_done`` to the run's
        sink and retries right-sized on overflow; the accepted attempt is
        cross-checked against ``cost_report`` and, with
        ``JobConfig(adaptive="on")``, leaves its ``StageStats`` in the
        run's one-slot box (cleared first, so a deferred or failed attempt
        leaves None).  The attempts fold into the run's ``stage_log``
        entry, tagged with the run's ``job``."""
        ev, defer, stats_box = run._event, run._defer, run._stats_box
        stats_box[0] = None
        inputs = [self._leg_input(leg, run._results, run.bindings)
                  for leg in stage.legs]
        bounds = None
        for leg in stage.legs:
            ex = leg.exchange
            if ex is not None and ex.kind == "range":
                bounds = self._range_bounds(run._results[ex.bounds_from],
                                            ex.bounds_key)
                break
        scale = stage._capacity_scale
        slack = stage._send_slack or self.config.initial_send_slack
        salted = stage._salted
        retries = self.config.max_capacity_retries
        L = len(stage.legs)
        P = self.nparts
        for attempt in range(retries + 1):
            probes = run.probes_run
            c0 = _build.compile_seconds()
            staged0 = STAGED["bytes"]
            t0 = time.perf_counter()
            hints = self._slot_hints(stage, inputs, slack, salted, run)
            out, info, shipped = self._run_once(stage, inputs, scale, slack,
                                                bounds, salted, hints)
            self._log_attempt(run, stage, shipped, salted,
                              run.probes_run - probes, run.job,
                              STAGED["bytes"] - staged0)
            compile_s = round(_build.compile_seconds() - c0, 4)
            # the gang's ranks hold equal shapes: world x one rank's bytes
            nbytes = _out_bytes(out) * self.mesh.world
            _M_STAGE_RUNS.inc()
            _M_SHUFFLE_B.inc(nbytes)
            if compile_s:
                _M_COMPILE_S.inc(compile_s)
            if defer is not None and attempt == 0:
                # optimistic: the info vector stays on the device until
                # the settle reads every stage's at once (which counts a
                # capacity retry, if any)
                enqueue_s = round(time.perf_counter() - t0, 4)
                _M_RUN_S.inc(enqueue_s)
                defer.append({"stage": stage, "info": info, "scale": scale,
                              "slack": slack, "salted": salted,
                              "out_bytes": nbytes, "cost_report": cost_report,
                              "compile_s": compile_s,
                              "enqueue_s": enqueue_s})
                stage._capacity_scale = scale
                stage._send_slack = slack
                stage._salted = salted
                return out
            # the attempt's ONE read of its info: a gang reads the
            # all-reduce (max) of every rank's, so every rank decides alike
            info = self.mesh.all_reduce_max(info).tolist()
            self._tally(run, "host_reads")
            # the measured slots ride that read back to later attempts
            # and runs of this stage
            self._note_slot_feedback(stage, info[3:3 + L])
            need_scale, need_slack, need_exch = info[:3]
            of = need_scale > 0 or need_slack > 0
            rows = info[3 + L:3 + L + P]
            wall = time.perf_counter() - t0
            _M_RUN_S.inc(wall)
            if of:
                _M_CAP_RETRIES.inc()
            ev({"event": "stage_done", "stage": stage.id,
                "label": stage.label, "attempt": attempt, "scale": scale,
                "slack": slack, "overflow": of, "need_scale": need_scale,
                "need_slack": need_slack, "need_exchange": need_exch,
                "salted": salted, "rows": rows, "out_bytes": nbytes,
                "compile_s": compile_s, "wall_s": round(wall, 4)})
            decision = self._decide(stage, scale, slack, salted,
                                    need_scale, need_slack, need_exch)
            if decision[0] == "ok":
                stage._capacity_scale = scale
                stage._send_slack = slack
                stage._salted = salted
                self._log_settled(run, stage, scale, slack, salted, info)
                self._check_cost(stage, scale, sum(rows), nbytes,
                                 report=cost_report, event=ev)
                if self.config.adaptive == "on":
                    from dryad_tpu_torch.adapt.stats import StageStats
                    stats_box[0] = StageStats(
                        stage.id, tuple(rows), capacity=out.capacity,
                        out_bytes=nbytes, wall_s=round(wall, 4))
                return out
            _, scale, slack, salted = decision
        raise CapacityError(
            f"stage {stage.id} ({stage.label}) still overflowing after "
            f"{retries} capacity retries (scale={scale}, slack={slack})")

    def run(self, graph: StageGraph,
            bindings: Optional[Dict[str, PData]] = None,
            spill_dir: Optional[str] = None,
            cost_report=None, event_log=None, job=None,
            failure_budget: Optional[int] = None,
            checkpoint=None, pause=None,
            runs: Optional[list] = None) -> PData:
        """Execute a graph with lineage-tracked recovery
        (``exec.recovery.Run``); ``bindings`` maps a placeholder's name to
        its data (a do_while body's loop-carried input).  With
        ``spill_dir`` every stage output is also written as a store, and a
        later Run over the same plan resumes from it.  ``cost_report``
        (``analysis.cost.estimate_graph`` of this graph) arms the
        per-stage cross-check and seeds the adaptive rules' priors.
        ``event_log`` / ``job`` / ``failure_budget`` are the run's own:
        its events go to ``event_log`` (else the executor's sink), tagged
        with ``job``.  ``checkpoint`` / ``pause`` are the job service's
        stage-boundary hooks (``Run``).  ``runs``, a list, gets the Run
        appended, for a caller that reads the run's own state afterwards
        (another run may end on this executor meanwhile); ``Dataset``
        runs through here and not through a Run of its own, since this
        method is the hook that wraps every run (timing, logging, the
        cost cross-check).  With ``JobConfig.profile_dir`` the run is
        profiled (``_profiled``)."""
        from dryad_tpu_torch.exec.recovery import Run
        run = Run(self, graph, bindings, spill_dir=spill_dir,
                  failure_budget=failure_budget, cost_report=cost_report,
                  event=event_log, job=job, checkpoint=checkpoint,
                  pause=pause)
        if runs is not None:
            runs.append(run)
        if self.config.profile_dir:
            return self._profiled(run.output)
        return run.output()

    def _profiled(self, fn):
        """``fn()`` under ``torch.profiler.profile`` — host activity, and
        CUDA activity on a CUDA device — with the Chrome trace written to
        ``JobConfig.profile_dir/run-<pid>-<n>.trace.json`` (``n`` counts
        this executor's profiled runs, whose paths ``profile_paths``
        keeps).  On CUDA the window opens with ``_PROFILE_PAD_LAUNCHES``
        launches of a one-element add (in a ``dryad.profile.pad``
        range), synchronized, and a profile in which a launch of the run
        has no device record (``_launches_without_record``) raises
        RuntimeError instead of writing the trace.  Profilers do not
        nest: no other ``torch.profiler`` may be active around the
        call."""
        import os

        from torch.profiler import ProfilerActivity, profile, \
            record_function
        acts = [ProfilerActivity.CPU]
        on_cuda = self.mesh.device.type == "cuda"
        if on_cuda:
            acts.append(ProfilerActivity.CUDA)
            pad = torch.zeros(1, device=self.mesh.device)
        with profile(activities=acts) as prof:
            if on_cuda:
                with record_function("dryad.profile.pad"):
                    for _ in range(_PROFILE_PAD_LAUNCHES):
                        pad.add_(1)
                    torch.cuda.synchronize(self.mesh.device)
            out = fn()
            if on_cuda:
                torch.cuda.synchronize(self.mesh.device)
        if on_cuda:
            n, lost = _launches_without_record(
                prof.profiler.kineto_results.events(),
                skip=_PROFILE_PAD_LAUNCHES)
            if lost or not n:
                raise RuntimeError(
                    f"JobConfig.profile_dir: the profile of a run on the "
                    f"card lacks device records ({lost} of the run's "
                    f"kernel launches without one; is another profiler "
                    f"active?); no trace written")
        os.makedirs(self.config.profile_dir, exist_ok=True)
        path = os.path.join(self.config.profile_dir,
                            f"run-{os.getpid()}-"
                            f"{len(self.profile_paths) + 1}.trace.json")
        prof.export_chrome_trace(path)
        self.profile_paths.append(path)
        return out
