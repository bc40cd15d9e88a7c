"""EXPLAIN ANALYZE — the executed plan annotated with measured actuals;
the port of ``dryad_tpu/obs/analyze.py``.

This module walks a recorded event stream and produces per-stage
ACTUALS (rows, output bytes, wall/compile split, capacity retries,
lineage replays, spills, adaptive rewrites fired) side by side with the
static cost model's predictions (the ``cost_report`` event,
``analysis/cost.py``) and the runtime cross-check's verdicts
(``cost_model_miss``).

Surfaces:

* ``Dataset.explain(analyze=True)`` / ``Dataset.analyze()`` — execute
  the query once under an explicit event capture and annotate
  (api/dataset.py);
* ``EXPLAIN ANALYZE <query>`` through ``sql.explain`` and the SQL CLI
  (dryad_tpu_torch/sql);
* ``python -m dryad_tpu_torch.obs analyze events.jsonl [--job ID]`` —
  post hoc over any recorded JSONL;
* the HTML viewer's "EXPLAIN ANALYZE" section (utils/viewer.py).

On the port's deferred path (``JobConfig.deferred_needs``) a stage's
``wall_s`` is the host's enqueue time, as in the JAX package: the
device's time is in the ``JobConfig.profile_dir`` trace.  A stage's
``compile_s`` is the kernel build at first use (``ops/_build.py``); the
port has no compiled-stage cache, so ``cache_hits`` stays 0.

The cost model predicts bytes for the PLANNED capacities.  A stage that
settled at a larger scale is not compared; a stage computed at scale 1
from one that did, whose capacity is its input's passed through, is
compared with the prediction scaled by that input's realized capacity
factor (the JAX package compares it with the planned bytes and reads it
out of bounds).  Every other field is the JAX package's.

Totals (``run_s``/``compile_s``/``out_bytes_total``/``stage_runs``) are
accumulated in EVENT ORDER with the same truthiness rules as
``obs/metrics.metrics_from_events`` — bit-identical float sums, so a
derived-metrics dashboard and an ANALYZE table never disagree about the
same stream.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["StageActuals", "AnalyzeReport", "analyze_events"]


@dataclasses.dataclass
class StageActuals:
    """Measured actuals of one executed stage, annotated with the
    static cost model's prediction for it (when a ``cost_report``
    covered the stage's run)."""

    stage: int
    label: str = ""
    runs: int = 0                 # stage executions (incl. overflow runs)
    retries: int = 0              # capacity-overflow retries
    replays: int = 0              # lineage replays
    spills: int = 0               # durable spills (+ stream Tee spills)
    rewrites: Tuple[str, ...] = ()  # adaptive rewrite kinds on this stage
    rows: int = 0                 # measured output rows (last settled run)
    out_bytes: int = 0            # measured output bytes (last settled run)
    wall_s: float = 0.0           # summed across runs
    compile_s: float = 0.0
    cache_hits: int = 0           # compiled-stage cache hits
    prefetch_stalls: int = 0      # chunk-prefetch stalls (streamed)
    prefetch_stall_s: float = 0.0
    scale: int = 1
    deferred: bool = False
    settled: bool = False         # >= 1 non-overflow run recorded
    streamed: bool = False        # stream_stage_done (no HBM prediction)
    # static prediction for the run that produced the actuals (None when
    # no cost_report covered this stage, or the estimate was approx)
    pred_rows: Optional[Tuple[int, Optional[int]]] = None
    pred_bytes: Optional[Tuple[int, Optional[int]]] = None
    approx: bool = False
    # predicted-vs-actual verdicts: measured value inside the interval?
    # delta is measured vs the predicted UPPER bound (bytes predictions
    # are exact at scale 1, so this reads as a plain % error)
    rows_in_bounds: Optional[bool] = None
    bytes_in_bounds: Optional[bool] = None
    bytes_delta_pct: Optional[float] = None
    misses: Tuple[str, ...] = ()  # cost_model_miss "what" fields

    def to_payload(self) -> dict:
        d = dataclasses.asdict(self)
        d["rewrites"] = list(self.rewrites)
        d["misses"] = list(self.misses)
        for k in ("pred_rows", "pred_bytes"):
            if d[k] is not None:
                d[k] = list(d[k])
        return d

    @staticmethod
    def from_payload(d: dict) -> "StageActuals":
        d = dict(d)
        d["rewrites"] = tuple(d.get("rewrites") or ())
        d["misses"] = tuple(d.get("misses") or ())
        for k in ("pred_rows", "pred_bytes"):
            if d.get(k) is not None:
                d[k] = tuple(d[k])
        return StageActuals(**d)


@dataclasses.dataclass
class AnalyzeReport:
    """Per-stage actuals for one event stream (see module docstring).
    ``stages`` follows first-execution order; the scalar totals mirror
    ``metrics_from_events`` exactly (same event-order accumulation)."""

    stages: List[StageActuals] = dataclasses.field(default_factory=list)
    job: Optional[str] = None
    wall_s: float = 0.0           # job_done wall (0 when never emitted)
    run_s: float = 0.0            # == dryad_run_seconds_total
    compile_s: float = 0.0        # == dryad_compile_seconds_total
    out_bytes_total: int = 0      # == dryad_shuffle_bytes_total
    stage_runs: int = 0           # == dryad_stage_runs_total
    predicted: bool = False       # a cost_report covered this stream
    misses: int = 0               # cost_model_miss events seen
    rewrites: int = 0             # graph_rewrite events seen
    # out-of-core re-streaming cache + prefetch pipeline (streamed runs)
    ooc_cache_hits: int = 0       # passes served from the local cache
    ooc_cache_writes: int = 0     # cold cache writes
    prefetch_stalls: int = 0      # host-IO-bound waits in the pipeline
    prefetch_stall_s: float = 0.0
    # continuous queries (inc/): standing-query refreshes in the stream,
    # and how many fell back to a full re-run
    inc_refreshes: int = 0        # == dryad_inc_refreshes_total
    inc_fallbacks: int = 0        # == dryad_inc_fallbacks_total

    def __post_init__(self):
        self._events: List[dict] = []   # source stream (not serialized)

    def stage(self, sid: int) -> Optional[StageActuals]:
        return next((s for s in self.stages if s.stage == sid), None)

    @property
    def settled(self) -> List[StageActuals]:
        return [s for s in self.stages if s.settled]

    def to_payload(self) -> dict:
        return {"job": self.job, "wall_s": round(self.wall_s, 6),
                "run_s": round(self.run_s, 6),
                "compile_s": round(self.compile_s, 6),
                "out_bytes_total": self.out_bytes_total,
                "stage_runs": self.stage_runs,
                "predicted": self.predicted, "misses": self.misses,
                "rewrites": self.rewrites,
                "ooc_cache_hits": self.ooc_cache_hits,
                "ooc_cache_writes": self.ooc_cache_writes,
                "prefetch_stalls": self.prefetch_stalls,
                "prefetch_stall_s": round(self.prefetch_stall_s, 6),
                "inc_refreshes": self.inc_refreshes,
                "inc_fallbacks": self.inc_fallbacks,
                "stages": [s.to_payload() for s in self.stages]}

    @staticmethod
    def from_payload(d: dict) -> "AnalyzeReport":
        return AnalyzeReport(
            [StageActuals.from_payload(s) for s in d.get("stages", ())],
            d.get("job"), d.get("wall_s", 0.0), d.get("run_s", 0.0),
            d.get("compile_s", 0.0), d.get("out_bytes_total", 0),
            d.get("stage_runs", 0), d.get("predicted", False),
            d.get("misses", 0), d.get("rewrites", 0),
            d.get("ooc_cache_hits", 0), d.get("ooc_cache_writes", 0),
            d.get("prefetch_stalls", 0), d.get("prefetch_stall_s", 0.0),
            d.get("inc_refreshes", 0), d.get("inc_fallbacks", 0))

    def render(self) -> str:
        """The ANALYZE table: one row per executed stage, measured
        actuals against the static prediction."""
        lines = [f"{'stage':>6} {'label':<16} {'runs':>4} {'rows':>10} "
                 f"{'pred rows':>17} {'out MiB':>8} {'Δbytes%':>8} "
                 f"{'compile_s':>9} {'wall_s':>8} {'spl':>3} {'rpl':>3} "
                 f"{'rw':>3}  flags"]
        for s in self.stages:
            if s.pred_rows is None:
                pr = "—"
            else:
                lo, hi = s.pred_rows
                pr = (f"[{lo}, {hi}]" if hi is not None
                      else f"[{lo}, inf)")
                if s.approx:
                    pr = "~" + pr
            delta = ("—" if s.bytes_delta_pct is None
                     else f"{s.bytes_delta_pct:+.1f}")
            flags = []
            if s.runs and s.cache_hits == s.runs:
                flags.append("cache")
            if s.deferred:
                flags.append("deferred")
            if s.streamed:
                flags.append("streamed")
            if s.prefetch_stalls:
                flags.append(f"io-stall x{s.prefetch_stalls}")
            if not s.settled and s.runs:
                flags.append("overflowed")
            if s.rows_in_bounds is False:
                flags.append("rows!pred")
            if s.misses:
                flags.append("MISS:" + ",".join(s.misses))
            lines.append(
                f"{s.stage:>6} {s.label[:16]:<16} {s.runs:>4} "
                f"{s.rows:>10} {pr:>17} "
                f"{s.out_bytes / (1 << 20):>8.2f} {delta:>8} "
                f"{s.compile_s:>9.3f} {s.wall_s:>8.3f} {s.spills:>3} "
                f"{s.replays:>3} {len(s.rewrites):>3}  "
                f"{' '.join(flags)}")
        n_set = len(self.settled)
        inb = [s for s in self.settled if s.bytes_in_bounds]
        cmp_n = len([s for s in self.settled
                     if s.bytes_in_bounds is not None])
        lines.append(
            f"{len(self.stages)} stage(s), {self.stage_runs} run(s); "
            f"wall {self.wall_s:.3f}s (run {self.run_s:.3f}s, compile "
            f"{self.compile_s:.3f}s); {self.rewrites} adaptive "
            f"rewrite(s); {self.misses} cost-model miss(es)"
            + (f"; predictions contained {len(inb)}/{cmp_n} settled "
               f"stage(s)" if self.predicted else
               "; no cost_report in the stream — actuals only")
            + (f"; {n_set}/{len(self.stages)} settled" if self.stages
               else ""))
        if (self.ooc_cache_hits or self.ooc_cache_writes
                or self.prefetch_stalls):
            lines.append(
                f"out-of-core: {self.ooc_cache_hits} stream cache "
                f"hit(s), {self.ooc_cache_writes} cold write(s); "
                f"{self.prefetch_stalls} prefetch stall(s) "
                f"({self.prefetch_stall_s:.3f}s waiting on host IO)")
        if self.inc_refreshes or self.inc_fallbacks:
            lines.append(
                f"continuous: {self.inc_refreshes} standing-query "
                f"refresh(es), {self.inc_fallbacks} full-rescan "
                f"fallback(s)")
        return "\n".join(lines)


def _contains(iv: Tuple[int, Optional[int]], v: int) -> bool:
    lo, hi = iv
    return lo <= v and (hi is None or v <= hi)


# a partition's row count in a stage's output bytes
# (analysis/domain._COUNT_BYTES_PER_PART)
_COUNT_BYTES = 4


def _plan_inputs(plan_json: str) -> Dict[int, List[int]]:
    """Each stage's input stages read with no exchange, from a ``plan``
    event's plan (an exchange declares its own capacity)."""
    import json
    return {st["id"]: [leg["src"]["stage"] for leg in st["legs"]
                       if isinstance(leg["src"], dict)
                       and "stage" in leg["src"]
                       and leg.get("exchange") is None]
            for st in json.loads(plan_json)["stages"]}


def _capacity_factor(est: Optional[dict], scale: int, out_bytes: int,
                     nparts: int, inputs) -> float:
    """A settled stage's realized capacity over its planned one.  At a
    scale above 1 it is measured: the stage's bytes past the count words
    over the predicted ones.  At scale 1 the stage carries the factor of
    an input read with no exchange whose planned capacity equals its own
    (a capacity passed through unchanged: the rescaled join's rows reach
    a sort at the join's realized capacity); otherwise it is 1.
    ``inputs`` pairs each such input's estimate with its factor."""
    if scale > 1:
        hi = None if est is None else est["out_bytes"][1]
        per = None if hi is None else hi - _COUNT_BYTES * nparts
        if not per or per <= 0:
            return float(scale)
        return (out_bytes - _COUNT_BYTES * nparts) / per
    f = 1.0
    for u_est, u_f in inputs:
        if (u_f != 1 and est is not None and u_est is not None
                and u_est.get("capacity") == est.get("capacity")):
            f = max(f, u_f)
    return f


def _rescaled(iv: Tuple[int, Optional[int]], f: float, nparts: int
              ) -> Tuple[int, Optional[int]]:
    """A byte prediction for planned capacities at ``f`` times them:
    the row bytes scale, the count words do not."""
    lo, hi = iv
    if f == 1 or hi is None:
        return iv
    c = _COUNT_BYTES * nparts

    def g(v):
        return v if v <= c else int(round((v - c) * f)) + c

    return g(lo), g(hi)


def analyze_events(events, job: Optional[str] = None) -> AnalyzeReport:
    """Build the :class:`AnalyzeReport` for one recorded stream.

    ``job`` filters a multi-job (service) JSONL to one job's records
    first — the same filter as the obs CLI's ``--job``.  Each
    ``stage_done`` is paired with the ``cost_report`` of ITS run (the
    report event precedes its run's stage events; a stream holding
    several runs re-pairs at each report, exactly like the soundness
    sweep in tests/test_cost.py)."""
    from dryad_tpu_torch.utils.events import EventLog
    if isinstance(events, EventLog):
        events = events.events
    events = list(events)
    if job is not None:
        events = [e for e in events if e.get("job") == job]
    rep = AnalyzeReport(job=job)
    rep._events = events
    by_id: Dict[Any, StageActuals] = {}
    pred: Dict[int, dict] = {}          # current run's cost_report stages
    nparts = 1                          # ... and its partition count
    rewrites: Dict[Any, List[str]] = {}  # stage -> rewrite kinds
    ups: Dict[int, List[int]] = {}      # current run's plan: input stages
    # each settled stage's realized capacity over its planned one
    factor: Dict[Any, float] = {}

    def entry(e) -> StageActuals:
        sid = e.get("stage")
        s = by_id.get(sid)
        if s is None:
            s = by_id[sid] = StageActuals(stage=sid)
            rep.stages.append(s)
        if e.get("label"):
            s.label = str(e["label"])
        return s

    for e in events:
        k = e.get("event")
        if k == "cost_report":
            rep.predicted = True
            pred = {s["stage"]: s
                    for s in (e.get("report") or {}).get("stages", ())}
            nparts = int((e.get("report") or {}).get("nparts") or 1)
        elif k == "plan" and e.get("plan"):
            ups = _plan_inputs(e["plan"])
            factor = {}
        elif k in ("stage_done", "stream_stage_done"):
            s = entry(e)
            s.runs += 1
            rep.stage_runs += 1
            wall = float(e.get("wall_s") or 0.0)
            s.wall_s += wall
            # totals mirror metrics_from_events EXACTLY: same event
            # order, same truthiness gates — bit-identical float sums
            if e.get("wall_s"):
                rep.run_s += e["wall_s"]
            comp = e.get("compile_s")
            s.compile_s += float(comp or 0.0)
            if comp:
                rep.compile_s += comp
            if e.get("out_bytes"):
                rep.out_bytes_total += e["out_bytes"]
            if e.get("cache_hit"):
                s.cache_hits += 1
            s.scale = max(s.scale, int(e.get("scale") or 1))
            s.deferred = s.deferred or bool(e.get("deferred"))
            if k == "stream_stage_done":
                s.streamed = s.settled = True
                s.prefetch_stalls += int(e.get("prefetch_stalls") or 0)
                s.prefetch_stall_s += float(
                    e.get("prefetch_stall_s") or 0.0)
                continue
            if e.get("overflow"):
                s.retries += 1
                continue                 # predictions hold at scale 1
            s.settled = True
            if e.get("rows") is not None:
                s.rows = int(sum(e["rows"]))
            s.out_bytes = int(e.get("out_bytes") or 0)
            est = pred.get(s.stage)
            scale = int(e.get("scale") or 1)
            f = _capacity_factor(est, scale, s.out_bytes, nparts,
                                 [(pred.get(u), factor.get(u, 1))
                                  for u in ups.get(s.stage, ())])
            factor[s.stage] = f
            if est is not None and scale == 1:
                s.approx = bool(est.get("approx"))
                s.pred_rows = tuple(est["rows"])
                s.pred_bytes = _rescaled(tuple(est["out_bytes"]), f,
                                         nparts)
                s.rows_in_bounds = _contains(s.pred_rows, s.rows)
                s.bytes_in_bounds = _contains(s.pred_bytes, s.out_bytes)
                hi = s.pred_bytes[1]
                if hi:
                    s.bytes_delta_pct = round(
                        100.0 * (s.out_bytes - hi) / hi, 1)
        elif k == "stage_replay":
            entry(e).replays += 1
        elif k == "stage_spilled":
            entry(e).spills += 1
        elif k == "stream_tee_spill":
            entry(e).spills += 1
        elif k == "cost_model_miss":
            rep.misses += 1
            s = by_id.get(e.get("stage"))
            if s is not None:
                s.misses = s.misses + (str(e.get("what")),)
        elif k == "ooc_cache_hit":
            rep.ooc_cache_hits += 1
        elif k == "ooc_cache_write":
            rep.ooc_cache_writes += 1
        elif k == "prefetch_stall":
            # job-level summary record (the per-stage split already
            # rides stream_stage_done fields — do not double-count the
            # stage rows, only the report totals)
            rep.prefetch_stalls += int(e.get("stalls") or 1)
            rep.prefetch_stall_s += float(e.get("stall_s") or 0.0)
        elif k == "inc_refresh":
            rep.inc_refreshes += 1
        elif k == "inc_fallback_rescan":
            rep.inc_fallbacks += 1
        elif k == "graph_rewrite":
            # a rewrite usually reshapes a stage that has NOT run yet —
            # buffer by id and attach after the walk, when the
            # (possibly later-executing) stage has its entry
            rep.rewrites += 1
            rewrites.setdefault(e.get("stage"),
                                []).append(str(e.get("kind", "?")))
        elif k == "job_done" and e.get("wall_s") is not None:
            rep.wall_s += float(e["wall_s"])
    for sid, kinds in rewrites.items():
        s = by_id.get(sid)
        if s is not None:
            s.rewrites = s.rewrites + tuple(kinds)
    return rep
