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
executor reads it once per stage attempt (the one host sync, with the
exchanges' own share of the need beside it) and, on overflow, re-runs the
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
feeds its exchanges' measured slots back through the attempt's one host
read.  A measured slot that meets other data and falls short is a
send-slack shortfall like any other, and the stage retries.

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

Not ported yet (later slices, see ROADMAP.md): lineage recovery and the
deferred settle, adaptivity, the cost cross-check and remembered capacity
scales.
"""

from __future__ import annotations

import collections
import weakref
from typing import Dict, List, Optional, Tuple

import torch

from dryad_tpu_torch.data.columnar import Batch, StringColumn, map_column
from dryad_tpu_torch.exec.data import PData, split_partitions, \
    stack_partitions
from dryad_tpu_torch.ops import kernels
from dryad_tpu_torch.ops.hashing import M32, hash_batch_keys
from dryad_tpu_torch.ops.hopper_kernels import hist_buckets_batched
from dryad_tpu_torch.ops.text import lower_ascii, split_tokens, \
    tokenize_group_count
from dryad_tpu_torch.parallel import shuffle
from dryad_tpu_torch.plan.stages import Exchange, Stage, StageGraph, StageOp
from dryad_tpu_torch.utils.config import JobConfig

__all__ = ["Executor", "CapacityError"]

class CapacityError(RuntimeError):
    pass


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


def _starts(parts: List[Batch]) -> torch.Tensor:
    """[P] global row index of each partition's first row (the exclusive
    prefix of the counts, on the device)."""
    counts = torch.stack([b.count for b in parts]).to(torch.int64)
    return torch.cumsum(counts, 0) - counts


def _take_global(parts: List[Batch], p) -> List[Batch]:
    """The first ``n`` rows over all partitions in partition order:
    partition p keeps clip(n - sum_{q<p} count_q, 0, count_p)."""
    n = p["n"]
    local = [kernels.take(b, n) for b in parts]
    counts = torch.stack([b.count for b in local])
    keep = torch.minimum(torch.clamp(n - _starts(local), min=0),
                         counts).to(torch.int32)
    return [Batch(b.columns, keep[q]) for q, b in enumerate(local)]


def _row_index_global(parts: List[Batch], p) -> List[Batch]:
    """A global int32 row-index column: each partition's rows count on
    from the rows of the partitions before it."""
    starts = _starts(parts)
    return [Batch(dict(b.columns, **{p["column"]: (
        starts[q] + torch.arange(b.capacity, device=b.device)).to(
            torch.int32)}), b.count) for q, b in enumerate(parts)]


def _skip_global(parts: List[Batch], p) -> List[Batch]:
    """Drop the first ``n`` rows over all partitions: partition q drops
    its first clip(n - start_q, 0, count_q) rows."""
    starts = _starts(parts)
    out = []
    for q, b in enumerate(parts):
        drop = torch.minimum(torch.clamp(p["n"] - starts[q], min=0),
                             b.count)
        out.append(kernels.compact(
            b, torch.arange(b.capacity, device=b.device) >= drop))
    return out


def _while_global(parts: List[Batch], p, take: bool) -> List[Batch]:
    """take_while / skip_while over the global row order: the prefix is
    each partition's rows before its first failing row, and counts only
    while every earlier partition is clean (no failing row)."""
    firsts = []
    for b in parts:
        valid = b.valid_mask()
        fail = ~p["fn"](dict(b.columns)) & valid
        idx = torch.arange(b.capacity, device=b.device)
        firsts.append(torch.minimum(
            torch.where(fail, idx, b.capacity).min(), b.count))
    first = torch.stack(firsts)
    counts = torch.stack([b.count for b in parts])
    clean = (first >= counts).to(torch.int32)
    # every partition before q clean: the exclusive running product
    before_clean = torch.cat([clean.new_ones(1),
                              torch.cumprod(clean, 0)[:-1]]) > 0
    prefix = torch.where(before_clean, first, 0)
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


def _sliding_window_global(parts: List[Batch], p
                           ) -> Tuple[List[Batch], torch.Tensor]:
    """Windows of ``w`` consecutive rows in global row order: row i of
    partition q becomes rows i .. i + w - 1, the rows past its count
    taken from partition q + 1's first w - 1 (the halo; the JAX package
    sends them with a ``ppermute``).  Windows crossing the dataset's end
    are dropped, so the last partition takes no halo, and padding rows
    never enter a window.  A partition before the last whose next one
    holds fewer than w - 1 rows is an unscalable shortfall, as in the JAX
    package.  Reads nothing on the host."""
    w = p["w"]
    halo = w - 1
    dev = parts[0].device
    if halo == 0:
        return [b.map(lambda x: x[:, None]) for b in parts], _needs(dev)
    P = len(parts)
    needs = _needs(dev)
    out = []
    for q, b in enumerate(parts):
        nxt = parts[(q + 1) % P]
        cap = b.capacity
        if q == P - 1:
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


# single-input ops over the whole partition list: (partitions, params) ->
# partitions; each needs every partition's count or "clean" flag, and
# none can overflow
_POSITIONAL = {
    "take": _take_global,
    "row_index": _row_index_global,
    "skip": _skip_global,
    "take_while": lambda parts, p: _while_global(parts, p, take=True),
    "skip_while": lambda parts, p: _while_global(parts, p, take=False),
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
                    slot_rows: Optional[int] = None
                    ) -> Tuple[List[Batch], torch.Tensor, torch.Tensor]:
    """Returns (batches, needs[2], slot_used): the exchange's measured
    max send-slot rows (0 for a broadcast), fed back to later runs of the
    stage."""
    cap = ex.out_capacity * scale
    slot = torch.zeros((), dtype=torch.int32, device=parts[0].device)
    if ex.kind == "hash":
        # empty keys = whole row; sorted so both legs of a set op agree
        keys = list(ex.keys) or sorted(parts[0].names)
        out, nr, nsl, slot = shuffle.hash_exchange(
            parts, keys, cap, send_slack=slack, slot_rows=slot_rows)
    elif ex.kind == "range":
        out, nr, nsl, slot = shuffle.range_exchange(
            parts, ex.bounds_key, bounds, cap, descending=ex.descending,
            send_slack=slack, slot_rows=slot_rows)
    elif ex.kind == "broadcast":
        out, nr, nsl = shuffle.broadcast_gather(parts, cap)
    else:
        raise ValueError(ex.kind)
    return (out, _needs(nr.device, _scale_need(nr, ex.out_capacity), nsl),
            slot.to(torch.int32))


class Executor:
    """Executes StageGraphs on a logical mesh."""

    def __init__(self, mesh, config: JobConfig | None = None):
        self.mesh = mesh
        self.nparts = mesh.nparts
        self.config = config or JobConfig()
        # per stage of the last run: label, attempts, final scale / slack
        self.stage_log: List[Dict] = []
        # (stage fingerprint, leg) -> the max send-slot rows the leg's
        # exchange last measured (LRU)
        self._slot_feedback: "collections.OrderedDict" = \
            collections.OrderedDict()
        # probe results over live input tensors (LRU), and the number of
        # probes that ran (each one batched hist_buckets launch)
        self._slot_probe_cache: "collections.OrderedDict" = \
            collections.OrderedDict()
        self.probes_run = 0

    def _probe_slot_rows(self, pd: PData, keys, slack: int) -> int:
        """Counts-only pre-hop of a first-wave pure hash exchange: every
        partition's destination counts in ONE batched ``hist_buckets``
        over the [P, cap] destinations, their max, one scalar read.  The
        exchange then ships the measured slot instead of the structural
        slack.  Quantized up to C_struct / 16 rows (at least 16), where
        C_struct = ceil(slack * cap / P); cached by the input's live
        tensors, so probing the same data again reads nothing."""
        b0 = pd.batch
        cap, D = pd.capacity, self.nparts
        # the same live tensors (ids whose objects are all still alive)
        leaves = _leaves(b0)
        rkey = (tuple(keys), slack, tuple(id(x) for x in leaves))
        hit = self._slot_probe_cache.get(rkey)
        if hit is not None:
            rows, refs = hit
            if all(r() is not None for r in refs):
                self._slot_probe_cache.move_to_end(rkey)
                return rows
            del self._slot_probe_cache[rkey]    # a recycled id: no hit
        # every partition's rows hashed at once, as one [P * cap] batch
        flat = Batch({k: map_column(b0.columns[k], lambda x: x.reshape(
            (D * cap,) + tuple(x.shape[2:]))) for k in keys}, b0.count)
        lo = hash_batch_keys(flat, keys)[1].reshape(D, cap)
        valid = (torch.arange(cap, device=lo.device)[None, :]
                 < b0.count[:, None])
        dest = torch.where(valid, (lo % D).to(torch.int32), D)
        slot = int(hist_buckets_batched(dest, D).max())  # the one read
        self.probes_run += 1
        c_struct = max(1, -(-slack * cap // D))
        q = max(16, c_struct // 16)
        rows = max(1, min(c_struct, -(-slot // q) * q))
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
        for li, leg in enumerate(stage.legs[:_SLOT_FEEDBACK_LEGS]):
            ex = leg.exchange
            if ex is None or ex.kind == "broadcast" or slots[li] <= 0:
                continue
            self._slot_feedback[(fp, li)] = slots[li]
            self._slot_feedback.move_to_end((fp, li))
        while len(self._slot_feedback) > 512:
            self._slot_feedback.popitem(last=False)

    def _slot_hints(self, stage: Stage, inputs: List[PData], slack: int,
                    salted: bool
                    ) -> List[Tuple[Optional[int], Optional[str]]]:
        """(send-slot rows or None, source) per leg; None, None for a leg
        without a hash or range exchange.  The sources, in order:

        1. "feedback": the slot this leg's exchange measured in an earlier
           attempt or run of the same stage (any hash or range leg);
        2. "probe": ``_probe_slot_rows`` for a pure hash leg (no ops)
           whose input holds at least ``exchange_probe_min_mb`` MB;
        3. "slack": None, the structural ceil(slack * cap / P).

        A salted attempt, one partition, or ``exchange_probe_min_mb < 0``
        ships the structural slack on every leg."""
        thresh = self.config.exchange_probe_min_mb
        measured = not (thresh < 0 or salted or self.nparts < 2)
        fp = stage.fingerprint() if measured else None
        hints = []
        for li, (leg, inp) in enumerate(zip(stage.legs, inputs)):
            ex = leg.exchange
            if ex is None or ex.kind not in ("hash", "range"):
                hints.append((None, None))
                continue
            fb = (self._slot_feedback.get((fp, li))
                  if measured and li < _SLOT_FEEDBACK_LEGS else None)
            if fb is not None:
                hints.append((_quantize_slot_rows(fb), "feedback"))
            elif (measured and ex.kind == "hash" and not leg.ops
                  and sum(t.numel() * t.element_size()
                          for t in _leaves(inp.batch)) / (1 << 20)
                  >= thresh):
                keys = list(ex.keys) or sorted(inp.batch.names)
                hints.append((self._probe_slot_rows(inp, keys, slack),
                              "probe"))
            else:
                hints.append((None, "slack"))
        return hints

    def _range_bounds(self, src: PData, key: str) -> torch.Tensor:
        """[P-1] split points over the ordering lane of ``key``, on the
        device: each partition samples at most
        ``range_samples_per_partition`` lanes, invalid sample slots fold
        to the all-ones sentinel and sort last, and the bounds are the
        n_tot * p // P-th of the sorted samples (zeros when no row was
        sampled).  The same bounds as the JAX package's, bit for bit."""
        dev = self.mesh.device
        if self.nparts == 1:
            return torch.zeros(0, dtype=torch.int64, device=dev)
        S = self.config.range_samples_per_partition
        lanes = _sample_lanes(src.batch.columns[key], src.counts, S)
        take = torch.clamp(src.counts.to(torch.int64), max=S)      # [P]
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
        for op in _fuse_stage_ops(ops):
            if op.kind in _POSITIONAL:
                parts = _POSITIONAL[op.kind](parts, op.params)
                continue
            if op.kind == "sliding_window":
                parts, nd = _sliding_window_global(parts, op.params)
                needs = torch.maximum(needs, nd)
                continue
            if op.kind == "zip":
                parts, nr, nsl = shuffle.zip_exchange(
                    parts, others.pop(0), op.params["suffix"], slack)
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
            for q, b in enumerate(parts):
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
        none), then each exchanging leg's received rows per destination]
        on the device, [(send-slot rows, source)] of each hash / range /
        zip exchange).  The exchanges' need is kept apart so that the salting
        trigger reacts to exchange skew only: a join-output shortfall must
        scale, not salt."""
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
                topk=self.config.salt_topk, send_slack=slack)
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
                    shipped.append((shuffle.send_slot_rows(
                        legs[i][0].capacity, P, slack, rows), source))
                legs[i], nd, slots[i] = _apply_exchange(
                    legs[i], leg.exchange, scale, slack, bounds, rows)
                needs = torch.maximum(needs, nd)
                exch_need = torch.maximum(exch_need, nd[0])
                exchanged.append(legs[i])
        if any(op.kind == "zip" for op in stage.body):
            # the zip's own exchange sends the right leg's rows
            shipped.append((shuffle.send_slot_rows(legs[1][0].capacity, P,
                                                   slack), "slack"))
        parts, needs = self._run_ops(legs[0], stage.body, scale, slack,
                                     needs, legs[1:])
        recv = [b.count.to(torch.int32) for leg in exchanged for b in leg]
        return stack_partitions(parts), torch.stack(
            [needs[0], needs[1], exch_need] + slots + recv), shipped

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
        """The JAX package's retry policy (``_decide_needs``): None when
        the attempt fit, else the (scale, slack, salted) of the retry;
        raises CapacityError for an overflow no scale fixes."""
        if need_scale <= 0 and need_slack <= 0:
            return None
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
            return new_scale, slack, True
        # right-size from the measured requirement: ONE retry at the exact
        # need instead of a blind doubling ladder
        return max(scale, need_scale), slack, salted

    def _run_stage(self, stage: Stage, results: Dict[int, PData],
                   bindings: Dict[str, PData]) -> PData:
        inputs = [self._leg_input(leg, results, bindings)
                  for leg in stage.legs]
        exchanges = [leg.exchange for leg in stage.legs
                     if leg.exchange is not None]
        bounds = None
        for ex in exchanges:
            if ex.kind == "range":
                bounds = self._range_bounds(results[ex.bounds_from],
                                            ex.bounds_key)
                break
        scale = stage._capacity_scale
        slack = stage._send_slack or self.config.initial_send_slack
        salted = stage._salted
        salted_attempts = 0
        probes = self.probes_run
        shipped = []
        retries = self.config.max_capacity_retries
        L = len(stage.legs)
        for attempt in range(retries + 1):
            hints = self._slot_hints(stage, inputs, slack, salted)
            out, info, slots = self._run_once(stage, inputs, scale, slack,
                                              bounds, salted, hints)
            info = info.tolist()   # the attempt's ONE host sync
            # the measured slots ride that read back to later attempts
            # and runs of this stage
            self._note_slot_feedback(stage, info[3:3 + L])
            shipped.append(slots)
            salted_attempts += salted
            retry = self._decide(stage, scale, slack, salted, *info[:3])
            if retry is None:
                stage._capacity_scale = scale
                stage._send_slack = slack
                stage._salted = salted
                P = self.nparts
                # a zip body op runs an exchange of its own
                kinds = [ex.kind for ex in exchanges] + [
                    "zip" for op in stage.body if op.kind == "zip"]
                self.stage_log.append({
                    "stage": stage.id, "label": stage.label,
                    "exchange": kinds[0] if kinds else None,
                    "exchanges": len(kinds),
                    "broadcasts": kinds.count("broadcast"),
                    "attempts": attempt + 1, "scale": scale,
                    "slack": slack, "salted": salted,
                    # each salted attempt broadcast the hot right rows
                    "salted_attempts": salted_attempts,
                    # per attempt, each hash / range / zip exchange's
                    # send-slot rows and where they came from
                    "slot_rows": [[c for c, _ in a] for a in shipped],
                    "slot_source": [[s for _, s in a] for a in shipped],
                    # slot probes run (one hist_buckets launch each)
                    "probes": self.probes_run - probes,
                    "recv_rows": [info[i:i + P]
                                  for i in range(3 + L, len(info), P)]})
                return out
            scale, slack, salted = retry
        raise CapacityError(
            f"stage {stage.id} ({stage.label}) still overflowing after "
            f"{retries} capacity retries (scale={scale}, slack={slack})")

    def run(self, graph: StageGraph,
            bindings: Optional[Dict[str, PData]] = None) -> PData:
        """Run every stage in order; ``bindings`` maps a placeholder's
        name to its data (a do_while body's loop-carried input)."""
        results: Dict[int, PData] = {}
        self.stage_log = []
        for stage in graph.topo_order():
            results[stage.id] = self._run_stage(stage, results,
                                                bindings or {})
        return results[graph.out_stage]
