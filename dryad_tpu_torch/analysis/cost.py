"""Static cost & resource model: abstract interpretation over the
lowered StageGraph — the port of ``dryad_tpu/analysis/cost.py``.

Every partition lives in a fixed device budget and every exchange buffer
is statically sized, so per-stage device footprints are decidable
before a job runs.  This module walks the physical plan with the
:mod:`~dryad_tpu_torch.analysis.domain` interval domain:

* row counts propagate as intervals seeded from the sources' real
  counts (a PData's ``counts``) and ``with_capacity`` bounds;
* column schemas propagate CONCRETELY: the structured ops and the user's
  callables run on meta tensors (``domain.abstract_batch``) through the
  SAME functions the executor calls — shapes and dtypes only, no data,
  nothing on the card — so predicted ``out_bytes`` equal the executor's
  measurement to the byte unless an op cannot run that way (then the
  state turns approximate and the bounds widen instead of lying);
* per-op working-set multipliers (sort scratch, join build side,
  exchange send slots) model the peak per-partition footprint for the
  DTA2xx findings.

The executor's stage-op fusion (``exec.executor._fuse_stage_ops``) is
applied first, so the model sees the ops that will actually run.

Outputs: a machine-readable :class:`CostReport` (cross-checked at run
time through ``Executor.run(..., cost_report=)``, which emits a
``cost_model_miss`` event for a stage outside its prediction; read by
``adapt/`` as priors) and the DTA2xx findings
(:func:`cost_diagnostics`, :func:`cache_diagnostic`).  The serialized-
plan pass (``estimate_plan_json``) waits for ``plan/serialize.py``
(ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from dryad_tpu_torch.analysis.diagnostics import Diagnostic
from dryad_tpu_torch.analysis.domain import (AbsState, ColSpec, Interval,
                                             abstract_batch, fmt_bytes,
                                             out_bytes, schema_from_columns,
                                             schema_of_abstract)

__all__ = ["StageCostEstimate", "CostReport", "estimate_graph",
           "estimate_query", "cost_diagnostics", "cache_diagnostic",
           "check_stage_measurement", "COST_CODES"]

# DTA2xx codes this model emits (a subset of diagnostics.CODES)
COST_CODES = ("DTA200", "DTA201", "DTA202", "DTA203", "DTA204",
              "DTA205")

# fraction of device_hbm_bytes a cache()'d dataset may occupy before the
# DTA204 edge-scale warning fires (cache residency is permanent, unlike
# a stage's transient working set)
CACHE_HBM_FRACTION = 0.5

# coarse per-op working-set multipliers over the op's OUTPUT bytes:
# sort-based kernels build key lanes + a permutation payload alongside
# the data; joins hold build + probe + output; the tokenizer builds a
# slot grid.  These feed the memory findings only — out_bytes
# predictions stay exact — so they are upper-bound-ish, not measurements.
_WORK_MULT = {
    "sort": 3.0, "group": 3.0, "distinct": 3.0, "group_top_k": 3.0,
    "group_rank": 3.0, "dgroup_local": 3.0, "dgroup_partial": 3.0,
    "dgroup_merge": 3.0, "join": 2.0, "semi_anti": 2.0,
    "group_apply": 2.0, "flat_tokens": 2.0, "tokens_group_count": 2.0,
    "flat_map": 2.0,
}

# body ops that consume the other legs
_BINARY = ("join", "semi_anti", "concat", "apply2", "zip")


@dataclasses.dataclass
class StageCostEstimate:
    """Predicted resources of one stage."""

    stage: int
    label: str
    rows: Interval                    # total output rows, all partitions
    capacity: int                     # per-partition output capacity
    out_bytes: Interval               # materialized output bytes (total)
    work_bytes: Interval              # peak per-DEVICE working set
    approx: bool = False
    notes: Tuple[str, ...] = ()

    def to_payload(self) -> dict:
        return {"stage": self.stage, "label": self.label,
                "rows": list(self.rows.as_tuple()),
                "capacity": self.capacity,
                "out_bytes": list(self.out_bytes.as_tuple()),
                "work_bytes": list(self.work_bytes.as_tuple()),
                "approx": self.approx, "notes": list(self.notes)}

    @staticmethod
    def from_payload(d: dict) -> "StageCostEstimate":
        return StageCostEstimate(
            d["stage"], d.get("label", ""),
            Interval(*d["rows"]), d.get("capacity", 0),
            Interval(*d["out_bytes"]), Interval(*d["work_bytes"]),
            d.get("approx", False), tuple(d.get("notes", ())))


@dataclasses.dataclass
class CostReport:
    """Machine-readable output of one cost pass.

    ``stages`` follows plan topo order; ``stage`` / ``bounds`` /
    ``rows_bounds`` / ``capacity_of`` are what the executor's
    cross-check and the adaptive rules read."""

    nparts: int
    stages: List[StageCostEstimate] = dataclasses.field(
        default_factory=list)
    device_hbm_bytes: int = 0
    # the plan reads a chunk-streamed source: the device holds
    # O(chunk_rows) rows by construction, so the model has no stages
    streamed: bool = False

    def __post_init__(self):
        self._by_stage = {s.stage: s for s in self.stages}

    def stage(self, sid: int) -> Optional[StageCostEstimate]:
        return self._by_stage.get(sid)

    def rows_bounds(self, sid: int) -> Optional[Tuple[int, Optional[int]]]:
        s = self._by_stage.get(sid)
        return s.rows.as_tuple() if s is not None else None

    def capacity_of(self, sid: int) -> int:
        s = self._by_stage.get(sid)
        return s.capacity if s is not None else 0

    @property
    def peak_work(self) -> Interval:
        out = Interval(0, 0)
        for s in self.stages:
            hi = (None if out.hi is None or s.work_bytes.hi is None
                  else max(out.hi, s.work_bytes.hi))
            out = Interval(max(out.lo, s.work_bytes.lo), hi)
        return out

    def to_payload(self) -> dict:
        return {"nparts": self.nparts,
                "device_hbm_bytes": self.device_hbm_bytes,
                "streamed": self.streamed,
                "stages": [s.to_payload() for s in self.stages]}

    @staticmethod
    def from_payload(d: dict) -> "CostReport":
        return CostReport(
            d.get("nparts", 1),
            [StageCostEstimate.from_payload(s)
             for s in d.get("stages", ())],
            d.get("device_hbm_bytes", 0), d.get("streamed", False))

    def render(self) -> str:
        if self.streamed:
            return ("streamed plan: device working set is O(chunk_rows)"
                    " — the in-memory cost model does not apply")
        lines = [f"{'stage':>6} {'label':<16} {'cap':>9} "
                 f"{'rows':>19} {'out_bytes':>15} {'work/dev':>15}"]
        for s in self.stages:
            rows = f"[{s.rows.lo}, " + (
                f"{s.rows.hi}]" if s.rows.hi is not None else "inf)")
            ob = (fmt_bytes(s.out_bytes.hi)
                  if s.out_bytes.hi is not None else "?")
            wk = (fmt_bytes(s.work_bytes.hi)
                  if s.work_bytes.hi is not None else "?")
            flag = " ~" if s.approx else ""
            lines.append(f"{s.stage:>6} {s.label:<16} {s.capacity:>9} "
                         f"{rows:>19} {ob:>15} {wk:>15}{flag}")
        pk = self.peak_work
        budget = (f" / budget {fmt_bytes(self.device_hbm_bytes)}"
                  if self.device_hbm_bytes else "")
        lines.append(
            f"peak per-device working set: {fmt_bytes(pk.lo)}"
            + (f"..{fmt_bytes(pk.hi)}" if pk.hi is not None else "..?")
            + budget + ("  (~ = approximate)" if any(
                s.approx for s in self.stages) else ""))
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# source seeding


class _Streamed(Exception):
    """The plan reads a chunk-streamed source: the device holds
    O(chunk_rows) rows by construction, so the in-memory model does not
    apply."""


def _source_state(data: Any, nparts: int) -> AbsState:
    """Abstract value of a bound source: a PData's real row count (one
    copy of its [P] counts to the host, no kernel) and schema; anything
    else widens to approximate.  A chunk-streamed source (a
    ``StreamSource``, which wraps its ChunkSource as ``.cs``) ends the
    pass."""
    if getattr(data, "cs", None) is not None:
        raise _Streamed()
    batch = getattr(data, "batch", None)
    if batch is not None:                       # PData
        schema = schema_from_columns(batch.columns, lead_dims=2)
        total = int(data.counts.cpu().sum())
        return AbsState(Interval.exact(total), int(data.capacity), schema)
    cap = int(getattr(data, "capacity", 0) or 0)
    return AbsState(Interval.upto(cap * nparts or None), cap, None,
                    approx=True, notes=["opaque source"])


# ---------------------------------------------------------------------------
# abstract op transfer functions


def _eval_abs(f, *args):
    """``f`` run on meta tensors, with the model's failure contract: the
    result, or None on any exception (the caller widens the state to
    approximate).  An op that reads a value on the host, or a UDF that
    leaves the meta device, lands here."""
    try:
        return f(*args)
    except Exception:
        return None


def _abs_of_result(res: Any, rows: Interval, nparts: int,
                   fallback: AbsState, what: str) -> AbsState:
    """Build the post-op state from an op's result on meta tensors (a
    Batch or a columns dict), widening to the (approximate) fallback on
    failure."""
    if res is None:
        out = AbsState(rows, fallback.capacity, fallback.schema,
                       approx=True, notes=list(fallback.notes))
        return out.note(f"{what}: not statically traceable — byte "
                        f"bounds widened")
    schema, cap = schema_of_abstract(res)
    st = AbsState(rows.clamp_hi(cap * nparts), cap, schema,
                  approx=fallback.approx, notes=list(fallback.notes))
    return st


def _abs_batch(s: AbsState):
    return abstract_batch(s.schema, s.capacity)


def _dist_lo(rows: Interval) -> Interval:
    """Rows interval after a distinct/group-style reduction: at least
    one group survives when the input is provably non-empty."""
    return Interval(1 if rows.lo >= 1 else 0, rows.hi)


def _abs_op(s: AbsState, op, nparts: int, config,
            others: List[AbsState]) -> AbsState:
    """Transfer function of one StageOp (mirrors executor._apply_op and
    its partition-list ops)."""
    from dryad_tpu_torch.ops import kernels
    from dryad_tpu_torch.ops.text import split_tokens, tokenize_group_count
    k, p = op.kind, op.params
    rows = s.rows_clamped(nparts)
    known = s.schema is not None

    if k == "fn":
        res = (_eval_abs(lambda c: p["fn"](dict(c)),
                         _abs_batch(s).columns) if known else None)
        return _abs_of_result(res, rows, nparts, s,
                              f"udf {p.get('label', 'map')!r}")
    if k == "filter":
        return AbsState(rows.relax_lo(), s.capacity, s.schema,
                        s.approx, list(s.notes))
    if k == "flat_tokens":
        cap = int(p["out_capacity"])
        res = (_eval_abs(
            lambda b: split_tokens(
                b, p["column"], out_capacity=cap,
                max_token_len=p["max_token_len"], delims=p["delims"],
                max_tokens_per_row=p.get("max_tokens_per_row"))[0],
            _abs_batch(s)) if known else None)
        fb = AbsState(Interval.upto(cap * nparts), cap,
                      {p["column"]: ColSpec("str",
                                            max_len=p["max_token_len"])},
                      s.approx, list(s.notes))
        return _abs_of_result(res, Interval.upto(cap * nparts), nparts,
                              fb, "flat_tokens")
    if k == "tokens_group_count":
        vcap = int(p["vocab_capacity"])
        # valid vocab rows per partition cannot exceed the tokens that
        # fed them (the token capacity), even though the OUTPUT batch is
        # padded to vocab_capacity — rows and bytes bound separately
        rcap = min(vcap, int(p["out_capacity"]))
        res = (_eval_abs(
            lambda b: tokenize_group_count(
                b, p["column"], out_capacity=int(p["out_capacity"]),
                vocab_capacity=vcap, count_name=p["count_name"],
                max_token_len=p["max_token_len"], delims=p["delims"],
                lower=p["lower"],
                max_tokens_per_row=p.get("max_tokens_per_row"))[0],
            _abs_batch(s)) if known else None)
        fb = AbsState(Interval.upto(rcap * nparts), vcap, None, s.approx,
                      list(s.notes))
        out = _abs_of_result(res, Interval.upto(rcap * nparts), nparts,
                             fb, "tokens_group_count")
        return AbsState(out.rows.clamp_hi(rcap * nparts), out.capacity,
                        out.schema, out.approx, out.notes)
    if k == "group":
        res = (_eval_abs(
            lambda b: kernels.group_aggregate(b, list(p["keys"]),
                                              dict(p["aggs"])),
            _abs_batch(s)) if known else None)
        return _abs_of_result(res, _dist_lo(rows), nparts, s, "group")
    if k in ("dgroup_local", "dgroup_partial", "dgroup_merge"):
        if k == "dgroup_merge":
            res = (_eval_abs(
                lambda b: kernels.group_decompose_merge(
                    b, list(p["keys"]), p["decs"], p["box"],
                    p["finalize"]), _abs_batch(s)) if known else None)
        else:
            fn = (kernels.group_decompose_local if k == "dgroup_local"
                  else kernels.group_decompose_partial)
            res = (_eval_abs(
                lambda b: fn(b, list(p["keys"]), p["decs"], p["box"]),
                _abs_batch(s)) if known else None)
        return _abs_of_result(res, _dist_lo(rows), nparts, s, k)
    if k == "mean_fin":
        res = (_eval_abs(
            lambda c: kernels.mean_finalize_columns(dict(c), p["cols"]),
            _abs_batch(s).columns) if known else None)
        return _abs_of_result(res, rows, nparts, s, "mean_fin")
    if k == "group_apply":
        ocap = int(p["out_capacity"])
        res = (_eval_abs(
            lambda b: kernels.group_regroup_apply(
                b, list(p["keys"]), p["fn"], p["max_groups"],
                p["group_capacity"], p["out_rows"], ocap)[0],
            _abs_batch(s)) if known else None)
        fb = AbsState(Interval.upto(ocap * nparts), ocap, None, s.approx,
                      list(s.notes))
        return _abs_of_result(res, Interval.upto(ocap * nparts), nparts,
                              fb, "group_apply")
    if k == "group_top_k":
        return AbsState(rows.relax_lo(), s.capacity, s.schema, s.approx,
                        list(s.notes))
    if k == "group_rank":
        res = (_eval_abs(
            lambda b: kernels.group_rank_select(b, list(p["keys"]),
                                                p["by"], p["rank"],
                                                p["out"]),
            _abs_batch(s)) if known else None)
        return _abs_of_result(res, _dist_lo(rows), nparts, s,
                              "group_rank")
    if k == "distinct":
        return AbsState(_dist_lo(rows), s.capacity, s.schema, s.approx,
                        list(s.notes))
    if k == "sort":
        return s
    if k == "take":
        n = int(p["n"])
        return AbsState(Interval(min(rows.lo, n),
                                 n if rows.hi is None
                                 else min(rows.hi, n)),
                        s.capacity, s.schema, s.approx, list(s.notes))
    if k == "skip":
        return AbsState(Interval(max(0, rows.lo - int(p["n"])), rows.hi),
                        s.capacity, s.schema, s.approx, list(s.notes))
    if k in ("take_while", "skip_while"):
        return AbsState(rows.relax_lo(), s.capacity, s.schema, s.approx,
                        list(s.notes))
    if k == "recap":
        cap = int(p["capacity"])
        return AbsState(rows.clamp_hi(cap * nparts), cap, s.schema,
                        s.approx, list(s.notes))
    if k == "row_index":
        schema = (dict(s.schema, **{p["column"]: ColSpec("dense",
                                                         "int32")})
                  if known else None)
        return AbsState(rows, s.capacity, schema, s.approx,
                        list(s.notes))
    if k == "sliding_window":
        w = int(p["w"])
        schema = None
        if known:
            schema = {kk: dataclasses.replace(cs, repeat=cs.repeat * w)
                      for kk, cs in s.schema.items()}
        return AbsState(rows.relax_lo(), s.capacity, schema, s.approx,
                        list(s.notes))
    if k == "apply":
        if known:
            # the executor hands a with_index fn the partition index as a
            # Python int
            res = _eval_abs((lambda b: p["fn"](b, 0)) if p.get("with_index")
                            else p["fn"], _abs_batch(s))
        else:
            res = None
        out_rows = Interval.upto(rows.hi)   # apply may reshape rows
        st = _abs_of_result(res, out_rows, nparts, s,
                            f"apply {p.get('label', '')!r}")
        return AbsState(st.rows.clamp_hi(st.capacity * nparts
                                         if st.capacity else None),
                        st.capacity, st.schema, st.approx, st.notes)
    if k == "flat_map":
        cap = int(p["out_capacity"])
        res = (_eval_abs(
            lambda b: kernels.flat_map_expand(b, p["fn"], cap)[0],
            _abs_batch(s)) if known else None)
        fb = AbsState(Interval.upto(cap * nparts), cap, None, s.approx,
                      list(s.notes))
        return _abs_of_result(res, Interval.upto(cap * nparts), nparts,
                              fb, f"flat_map {p.get('label', '')!r}")
    # -- binary ops (consume `others`) ------------------------------------
    if k == "join":
        r = others[0]
        ocap = int(p["out_capacity"])
        hi = ocap * nparts
        if rows.hi is not None and r.rows.hi is not None:
            hi = min(hi, max(rows.hi, 1) * max(r.rows.hi, 1))
        lo = rows.lo if p.get("how") in ("left", "full") else 0
        res = None
        if known and r.schema is not None:
            res = _eval_abs(
                lambda lb, rb: kernels.hash_join(
                    lb, rb, list(p["left_keys"]), list(p["right_keys"]),
                    out_capacity=ocap, how=p.get("how", "inner"),
                    right_unique=p.get("right_unique", False))[0],
                _abs_batch(s), _abs_batch(r))
        fb = AbsState(Interval(lo, hi), ocap, None,
                      s.approx or r.approx,
                      list(s.notes) + list(r.notes))
        return _abs_of_result(res, Interval(lo, hi), nparts, fb, "join")
    if k == "semi_anti":
        return AbsState(rows.relax_lo(), s.capacity, s.schema,
                        s.approx or others[0].approx, list(s.notes))
    if k == "concat":
        r = others[0]
        res = None
        if known and r.schema is not None:
            res = _eval_abs(kernels.concat2, _abs_batch(s),
                            _abs_batch(r))
        fb = AbsState(rows + r.rows_clamped(nparts),
                      s.capacity + r.capacity, None,
                      s.approx or r.approx,
                      list(s.notes) + list(r.notes))
        return _abs_of_result(res, rows + r.rows_clamped(nparts),
                              nparts, fb, "concat")
    if k == "zip":
        r = others[0]
        schema = None
        if known and r.schema is not None:
            suffix = p.get("suffix", "_r")
            schema = dict(s.schema)
            for kk, cs in r.schema.items():
                schema[kk + suffix if kk in schema else kk] = cs
        # the zip exchange sends the right side's rows to the left
        # side's partitions: the output keeps the LEFT capacity (the JAX
        # model's min of the two capacities misses the executor's bytes
        # whenever the right side is narrower: ROADMAP Queue 3)
        cap = s.capacity
        hi = (None if rows.hi is None or r.rows.hi is None
              else min(rows.hi, r.rows.hi))
        return AbsState(Interval(0, hi).clamp_hi(cap * nparts), cap,
                        schema, s.approx or r.approx,
                        list(s.notes) + list(r.notes))
    if k == "apply2":
        r = others[0]
        res = None
        if known and r.schema is not None:
            res = _eval_abs(p["fn"], _abs_batch(s), _abs_batch(r))
        out_rows = Interval.upto(rows.hi)
        st = _abs_of_result(res, out_rows, nparts, s,
                            f"apply2 {p.get('label', '')!r}")
        return AbsState(st.rows.clamp_hi(st.capacity * nparts
                                         if st.capacity else None),
                        st.capacity, st.schema, st.approx, st.notes)
    # unknown op kind: pass through, widened
    return AbsState(Interval.upto(rows.hi), s.capacity, s.schema, True,
                    list(s.notes) + [f"unknown op kind {k!r}"])


def _abs_exchange(s: AbsState, ex, nparts: int, config) -> AbsState:
    cap = int(ex.out_capacity)
    if ex.kind == "broadcast":
        return AbsState(s.rows_clamped(nparts).scale(nparts)
                        .clamp_hi(cap * nparts), cap, s.schema,
                        s.approx, list(s.notes))
    # hash/range: rows conserved, re-placed; capacity re-declared
    return AbsState(s.rows_clamped(nparts).clamp_hi(cap * nparts), cap,
                    s.schema, s.approx, list(s.notes))


# ---------------------------------------------------------------------------
# the stage walk


def _add_hi(hi: Optional[int], s: AbsState,
            mult: float = 1.0) -> Optional[int]:
    """Accumulate one abstract value's per-device bytes into the
    working-set upper bound (None once any contribution is unknown)."""
    pb = s.part_bytes()
    if pb is None or hi is None:
        return None
    return hi + int(pb * mult)


def estimate_graph(graph, nparts: int, config=None) -> CostReport:
    """Abstractly interpret a lowered StageGraph.  Returns a CostReport
    whose stage ids match the graph's (and — because planning is
    deterministic — any re-plan of the same query).  Runs every op on
    meta tensors (``hopper_kernels.shape_only``: a kernel wrapper takes
    its plain version on them): nothing is computed, and nothing is
    allocated or launched on the card.  A plan over a chunk-streamed
    source gets a report with ``streamed`` set and no stages."""
    hbm = int(getattr(config, "device_hbm_bytes", 0) or 0)
    slack = int(getattr(config, "initial_send_slack", 2) or 2)
    report = CostReport(nparts, [], device_hbm_bytes=hbm)
    try:
        _estimate_stages(graph, nparts, config, report, slack)
    except _Streamed:
        return CostReport(nparts, [], device_hbm_bytes=hbm, streamed=True)
    report.__post_init__()
    return report


def _estimate_stages(graph, nparts: int, config, report: CostReport,
                     slack: int) -> None:
    """``estimate_graph``'s walk: every stage's estimate appended to
    ``report``."""
    from dryad_tpu_torch.exec.executor import _fuse_stage_ops
    from dryad_tpu_torch.ops.hopper_kernels import shape_only
    states: Dict[int, AbsState] = {}
    with torch.no_grad(), shape_only():
        for st in graph.topo_order():
            leg_states: List[AbsState] = []
            work_lo, work_hi = 0, 0
            notes: List[str] = []
            exchange_unbounded = False
            for leg in st.legs:
                if isinstance(leg.src, int):
                    s = states[leg.src]
                    s = AbsState(s.rows, s.capacity, s.schema, s.approx,
                                 [])
                elif leg.src[0] == "source":
                    s = _source_state(leg.src[1], nparts)
                else:                                   # placeholder
                    s = AbsState(Interval.upto(None), 0, None,
                                 approx=True,
                                 notes=[f"placeholder "
                                        f"{leg.src[1]!r}: rows "
                                        f"unbounded"])
                # the leg input is resident for the whole stage
                in_pb = s.part_bytes()
                if in_pb is not None:
                    work_lo += in_pb
                work_hi = _add_hi(work_hi, s)
                for op in _fuse_stage_ops(list(leg.ops)):
                    s = _abs_op(s, op, nparts, config, [])
                    work_hi = _add_hi(work_hi, s,
                                      _WORK_MULT.get(op.kind, 1.0))
                if leg.exchange is not None:
                    if s.rows.hi is None:
                        exchange_unbounded = True
                    s = _abs_exchange(s, leg.exchange, nparts, config)
                    mult = (1.0 if leg.exchange.kind == "broadcast"
                            else 1.0 + slack)
                    work_hi = _add_hi(work_hi, s, mult)
                notes.extend(s.notes)
                leg_states.append(s)
            cur, rest = leg_states[0], leg_states[1:]
            for op in _fuse_stage_ops(list(st.body)):
                if op.kind in _BINARY:
                    cur = _abs_op(cur, op, nparts, config, rest)
                    rest = []
                else:
                    cur = _abs_op(cur, op, nparts, config, [])
                work_hi = _add_hi(work_hi, cur,
                                  _WORK_MULT.get(op.kind, 1.0))
                notes.extend(n for n in cur.notes if n not in notes)
            states[st.id] = cur
            ob = cur.part_bytes()
            if ob is not None:
                obt = out_bytes(cur.schema, cur.capacity, nparts)
                out_iv = Interval.exact(obt)
                work_lo += ob
            else:
                out_iv = Interval.upto(None)
            if exchange_unbounded:
                notes.append("unbounded rows reach an exchange")
            report.stages.append(StageCostEstimate(
                st.id, st.label, cur.rows_clamped(nparts),
                cur.capacity, out_iv,
                Interval(work_lo, work_hi), approx=cur.approx
                or ob is None, notes=tuple(dict.fromkeys(notes))))


def estimate_query(node, nparts: int, config=None) -> CostReport:
    """Plan ``node`` exactly as a terminal call would and estimate the
    result.  Planning is deterministic, so the report's stage ids line
    up with the graph the executor will run."""
    from dryad_tpu_torch.plan.planner import plan_query
    graph = plan_query(node, nparts, config=config)
    return estimate_graph(graph, nparts, config=config)


# ---------------------------------------------------------------------------
# DTA2xx diagnostics


def cost_diagnostics(report: CostReport, config=None) -> List[Diagnostic]:
    """The DTA2xx findings of one cost pass: provable OOM (error),
    possible OOM/spill (warn), unbounded fan-out at an exchange (warn),
    and the per-stage cost table summary (info).  The working set is the
    JAX package's per device, which is one partition: on the port's one
    card the P partitions' outputs sit side by side, so the findings hold
    for the JAX package's mesh, as its own gate computes them."""
    out: List[Diagnostic] = []
    if report.streamed:
        return out
    hbm = report.device_hbm_bytes
    worst: Optional[StageCostEstimate] = None
    for s in report.stages:
        if hbm and s.work_bytes.lo > hbm:
            out.append(Diagnostic(
                "DTA201", "error",
                f"stage {s.stage} ({s.label}) provably exceeds the "
                f"device HBM budget: certain per-device footprint "
                f"{fmt_bytes(s.work_bytes.lo)} > device_hbm_bytes="
                f"{fmt_bytes(hbm)} — repartition over more devices, "
                f"or lower capacities",
                node=f"stage{s.stage}:{s.label}"))
        elif hbm and (s.work_bytes.hi is None
                      or s.work_bytes.hi > hbm):
            bound = (fmt_bytes(s.work_bytes.hi)
                     if s.work_bytes.hi is not None else "unbounded")
            out.append(Diagnostic(
                "DTA202", "warn",
                f"stage {s.stage} ({s.label}) may exceed the device "
                f"HBM budget (predicted spill): per-device working set "
                f"up to {bound} vs device_hbm_bytes={fmt_bytes(hbm)}",
                node=f"stage{s.stage}:{s.label}"))
        if "unbounded rows reach an exchange" in s.notes:
            out.append(Diagnostic(
                "DTA203", "warn",
                f"stage {s.stage} ({s.label}): an input with no static "
                f"row bound feeds an exchange — the exchange buffer is "
                f"sized blind; bound it with with_capacity()/assume_* "
                f"or seed the source with real statistics",
                node=f"stage{s.stage}:{s.label}"))
        if worst is None or (s.work_bytes.hi is not None
                             and (worst.work_bytes.hi is None
                                  or s.work_bytes.hi
                                  > worst.work_bytes.hi)):
            worst = s
    if report.stages:
        pk = report.peak_work
        out.append(Diagnostic(
            "DTA205", "info",
            f"predicted cost: {len(report.stages)} stage(s), peak "
            f"per-device working set {fmt_bytes(pk.lo)}"
            + (f"..{fmt_bytes(pk.hi)}" if pk.hi is not None else "..?")
            + (f" (driver: stage {worst.stage} {worst.label})"
               if worst is not None else "")
            + " — Dataset.cost().render() for the full table",
            None, node="cost"))
    return out


def cache_diagnostic(report: CostReport, config=None
                     ) -> Optional[Diagnostic]:
    """DTA204: ``cache()`` of edge-scale data (more than
    ``CACHE_HBM_FRACTION`` of the device budget).  Applies to the
    MATERIALIZED bytes of the cached dataset (the last stage's output),
    not a transient working set.

    The severity follows ``JobConfig.ooc_restream_cache``, as in the JAX
    package: with the store-backed re-streaming tier on (the default)
    ``cache()`` LOWERS to a local chunked store instead of pinning the
    card, so the finding is informational; with the tier off it warns,
    the result pinning device memory for the Context's lifetime."""
    hbm = int(getattr(config, "device_hbm_bytes", 0) or 0)
    if not hbm or report.streamed or not report.stages:
        return None
    last = report.stages[-1]
    ob = last.out_bytes.hi
    if ob is None or ob <= CACHE_HBM_FRACTION * hbm:
        return None
    scale = (f"{fmt_bytes(ob)} ({100.0 * ob / hbm:.0f}% of "
             f"device_hbm_bytes={fmt_bytes(hbm)})")
    if getattr(config, "ooc_restream_cache", False):
        return Diagnostic(
            "DTA204", "info",
            f"edge-scale cache(): {scale} lowers to the store-backed "
            f"re-streaming cache tier (local chunked cache, per-chunk "
            f"fingerprints; iterations re-stream local sequential "
            f"reads) — set JobConfig.ooc_cache_dir for restart reuse, "
            f"or ooc_restream_cache=False to pin device-resident",
            node=f"stage{last.stage}:{last.label}")
    return Diagnostic(
        "DTA204", "warn",
        f"cache() would pin {scale} in device memory for the Context's "
        f"lifetime (ooc_restream_cache is off) — re-enable the "
        f"re-streaming cache tier, or persist with to_store() and "
        f"read_store_stream() (the >HBM path) instead of cache() at "
        f"this scale",
        node=f"stage{last.stage}:{last.label}")


# ---------------------------------------------------------------------------
# runtime cross-check (executor-side model validation)


def check_stage_measurement(est: StageCostEstimate, scale: int,
                            rows: int, out_bytes: int,
                            nparts: int) -> List[dict]:
    """Compare one stage's MEASURED (rows, out_bytes) against the static
    prediction; returns ``cost_model_miss`` payload dicts (empty = the
    model held).

    Rows are checked unconditionally — a rows miss means a transfer
    function is unsound.  Bytes are checked only at capacity scale 1:
    the model predicts the PLANNED shapes exactly, and the executor's
    overflow retries right-size capacities from measured need (its own
    adaptive behavior, reported via the stage's ``scale``), so a scaled
    batch validates nothing about the model.  Approximate stages are
    skipped: their bounds were widened on purpose."""
    out: List[dict] = []
    if est.approx:
        return out
    if not est.rows.contains(int(rows)):
        out.append({"event": "cost_model_miss", "stage": est.stage,
                    "label": est.label, "what": "rows",
                    "measured": int(rows),
                    "predicted": list(est.rows.as_tuple())})
    if int(scale) == 1 and est.out_bytes.hi is not None \
            and not est.out_bytes.contains(int(out_bytes)):
        out.append({"event": "cost_model_miss", "stage": est.stage,
                    "label": est.label, "what": "out_bytes",
                    "measured": int(out_bytes), "scale": int(scale),
                    "predicted": list(est.out_bytes.as_tuple())})
    return out
