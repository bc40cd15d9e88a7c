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
final capacity scale, whether it ran salted and each exchanging leg's
received rows per destination from the last ``run``.

A range exchange splits on bounds sampled from the output of its
``bounds_from`` stage (``_range_bounds``), once per stage before the
retry loop and on the device.  The global positional ops (``take``,
``row_index``, ``skip``, ``take_while``, ``skip_while``) need every
partition's count or "clean" flag, ``zip`` both sides' counts, and the
lookup-join choice every partition's duplicate flag, so the executor
applies those over the whole partition list (``_POSITIONAL``,
``_join_global``, ``shuffle.zip_exchange``); only the duplicate flags
are read on the host.  The other two-input body ops (``apply2`` of
``cross_apply``, the set operators' ``semi_anti`` and ``concat``) pair
each partition with the other leg's same partition.  A broadcast leg
hands every partition the same replicated Batch.  ``run`` binds a
do_while body's placeholder to the previous iteration's output.

Not ported yet (later slices, see ROADMAP.md): lineage recovery and the
deferred settle, adaptivity, the cost cross-check, slot feedback and
probes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from dryad_tpu_torch.data.columnar import Batch, StringColumn
from dryad_tpu_torch.exec.data import PData, split_partitions, \
    stack_partitions
from dryad_tpu_torch.ops import kernels
from dryad_tpu_torch.ops.hashing import M32
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
_SCALABLE_OVERFLOW_KINDS = {"flat_tokens", "join", "zip"}


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


def _apply_op(b: Batch, op: StageOp, scale: int) -> Tuple[Batch,
                                                          torch.Tensor]:
    """Apply one StageOp to one partition's batch; returns (batch, needs)
    where needs = int32[2] (need_scale, need_slack): 0 = fits, > 0 = the
    measured requirement for a right-sized retry."""
    k, p = op.kind, op.params
    dev = b.device
    if k == "fn":
        return Batch(dict(p["fn"](dict(b.columns))), b.count), _needs(dev)
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
                    slack: int, bounds: Optional[torch.Tensor]
                    ) -> Tuple[List[Batch], torch.Tensor]:
    """Returns (batches, needs[2])."""
    cap = ex.out_capacity * scale
    if ex.kind == "hash":
        # empty keys = whole row; sorted so both legs of a set op agree
        keys = list(ex.keys) or sorted(parts[0].names)
        out, nr, nsl, _slot = shuffle.hash_exchange(
            parts, keys, cap, send_slack=slack)
    elif ex.kind == "range":
        out, nr, nsl, _slot = shuffle.range_exchange(
            parts, ex.bounds_key, bounds, cap, descending=ex.descending,
            send_slack=slack)
    elif ex.kind == "broadcast":
        out, nr, nsl = shuffle.broadcast_gather(parts, cap)
    else:
        raise ValueError(ex.kind)
    return out, _needs(nr.device, _scale_need(nr, ex.out_capacity), nsl)


class Executor:
    """Executes StageGraphs on a logical mesh."""

    def __init__(self, mesh, config: JobConfig | None = None):
        self.mesh = mesh
        self.nparts = mesh.nparts
        self.config = config or JobConfig()
        # per stage of the last run: label, attempts, final scale / slack
        self.stage_log: List[Dict] = []

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
            for b in parts:
                b, nd = _apply_op(b, op, scale)
                needs = torch.maximum(needs, nd)
                outs.append(b)
            parts = outs
        return parts, needs

    def _run_once(self, stage: Stage, inputs: List[PData], scale: int,
                  slack: int, bounds: Optional[torch.Tensor], salted: bool
                  ) -> Tuple[PData, torch.Tensor]:
        """One attempt of a stage: (output, [need_scale, need_slack, the
        exchanges' need_scale, then each exchanging leg's received rows
        per destination] on the device).  The exchanges' need is kept
        apart so that the salting trigger reacts to exchange skew only:
        a join-output shortfall must scale, not salt."""
        dev = self.mesh.device
        needs = torch.zeros(2, dtype=torch.int32, device=dev)
        exch_need = torch.zeros((), dtype=torch.int32, device=dev)
        legs = []
        for leg, inp in zip(stage.legs, inputs):
            parts, needs = self._run_ops(split_partitions(inp), leg.ops,
                                         scale, slack, needs)
            legs.append(parts)
        if salted:
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
                legs[i], nd = _apply_exchange(legs[i], leg.exchange, scale,
                                              slack, bounds)
                needs = torch.maximum(needs, nd)
                exch_need = torch.maximum(exch_need, nd[0])
                exchanged.append(legs[i])
        parts, needs = self._run_ops(legs[0], stage.body, scale, slack,
                                     needs, legs[1:])
        recv = [b.count.to(torch.int32) for leg in exchanged for b in leg]
        return stack_partitions(parts), torch.stack(
            [needs[0], needs[1], exch_need] + recv)

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
                f"capacity (a with_capacity truncation or a zip alignment "
                f"shortfall): retrying at a larger scale cannot succeed; "
                f"raise the declared capacity instead")
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
        retries = self.config.max_capacity_retries
        for attempt in range(retries + 1):
            out, info = self._run_once(stage, inputs, scale, slack, bounds,
                                       salted)
            info = info.tolist()   # the attempt's ONE host sync
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
                    "recv_rows": [info[i:i + P]
                                  for i in range(3, len(info), P)]})
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
