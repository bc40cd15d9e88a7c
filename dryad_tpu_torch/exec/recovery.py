"""Replay-based fault tolerance — the port of ``dryad_tpu/exec/recovery.py``:
lineage-tracked runs with recomputation on demand, the deferred settle,
and durable spill with resume.

A ``Run`` memoizes each stage's output and knows each stage's inputs
(the lineage).  Losing an output (``invalidate``: a fault, a preemption,
a test) drops its memo entry, and asking for it again recomputes it from
the surviving ancestors, within ``JobConfig.failure_budget``.  Stages are
deterministic (fixed hash constants, seeded sampling), so a replay gives
the same rows.  With ``spill_dir`` every stage output is also written as
a store (``io/store.py``), recovery reloads it instead of recomputing,
and a new Run over the same plan, in this process or another, resumes
from it.

With ``JobConfig.deferred_needs`` (the default; off with ``spill_dir``,
whose writes read every stage back anyway, and whose stores must never
hold a truncated output) no stage reads its info vector back when it
runs: ``_settle`` reads every stage's in ONE device-to-host read at job
end, emits the ``stage_done`` events, feeds the measured send slots back,
and, where a stage overflowed, sets its right-sized knobs, drops it and
every stage computed from it, and replays them synchronously.

With ``JobConfig(adaptive="on")`` a Run builds an
``adapt.manager.AdaptiveManager`` and takes the synchronous path (each
stage's rows are needed on the host when it materializes): after each
stage it computes, the manager may rewrite the stages not yet run, and
the walk re-reads the graph's edges at every step.  An adaptive run
writes a ``.fp`` file (the stage's fingerprint) beside each spill and
loads no spill without one; every run loads a spill with a ``.fp`` only
when it names the stage's current fingerprint.  ``cost_report`` (an
``analysis.cost.CostReport`` of the graph) is cross-checked at each
stage that settles without overflow, the settle's included; a rewrite
drops the predictions of the stages it reshaped.

A Run is the per-job state: the event sink (``event=``, else the
executor's), tagged with ``job=`` when given, the failure budget, the
memo, the adaptive manager, the cost report and the one-slot stats box
all live on it, never on the shared executor.  A Run with an event
sink emits the executed plan first (a ``plan`` event,
``plan/serialize.graph_to_json``).

Telemetry (``obs/``): ``output()`` runs inside a ``run`` job span, and
each stage computed inside a ``stage <id>:<label>`` span (kind
``stage``) parented to it, the settle inside a ``settle`` span (its one
info read and any replay; ``replayed``: the stages it re-ran).  On the
deferred path a stage span covers the host's enqueue only, as in the JAX
package; the device's time is found through the launches made inside
the stage's spans (the executor's ``op.*`` and ``exchange.*``), which,
like every span, are stamped on the profiler's clock (``obs/trace.py``).
Spans are recorded when the sink's level is 2; a run whose sink is the
executor's no-op one sends them to the installed process sink
(``trace.install``), if any, so a run with no event log of its own can
be traced.  A resource sampler (``obs/profile.py``, every
``JobConfig.resource_sample_s``) runs for the duration of ``output()``
and is joined before it returns; it reads the device's allocated bytes
without synchronizing.  ``job_done`` carries the metrics registry's
snapshot (``metrics``: cumulative process counters) and, at level 2, the
job span's trace id (``trace``).

The run also owns its stage log (``stage_log``, one entry per stage it
ran), its counts of host reads and slot probes (added to the executor's
totals as they happen), its adaptive rewrites (``rewrites``) and whether
one of them moved its output's placement (``placement_changed``).  When
``output()`` ends, returning or raising, the executor's ``stage_log``
and ``_last_run_*`` take this run's values, so several runs may share
one executor at once.

The job service's hooks (``service/durable``): ``checkpoint(run, sid)``
is called after each stage this run computes, once its spill is written;
``pause`` (a ``threading.Event``) is checked before each stage is
computed, and when it is set the run raises ``HandoffPause`` at that
boundary, its settled stages spilled and checkpointed for a successor
to resume.  Spill writes and reads hold the process-wide
``_SPILL_IO_LOCK``: fleet threads spill at once.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import threading
import time
from typing import Dict, List, Optional

import torch

from dryad_tpu_torch.exec.data import PData
from dryad_tpu_torch.exec.executor import _M_CAP_RETRIES, CapacityError, \
    _no_event
from dryad_tpu_torch.obs import profile as _profile
from dryad_tpu_torch.obs import trace
from dryad_tpu_torch.obs.metrics import REGISTRY
from dryad_tpu_torch.plan.serialize import graph_to_json
from dryad_tpu_torch.plan.stages import StageGraph

__all__ = ["Run", "FailureBudgetExceeded", "HandoffPause"]

# spill writes and reads from several fleet threads at once take turns:
# they are disk-bound, and each one's host staging is large
_SPILL_IO_LOCK = threading.Lock()


class FailureBudgetExceeded(RuntimeError):
    pass


class HandoffPause(RuntimeError):
    """Raised at a stage boundary when the run's ``pause`` event is set
    (the job service hands off to a successor): every settled stage is
    already spilled and checkpointed, so the successor resumes from this
    boundary."""

    def __init__(self, sid: int):
        self.stage = sid
        super().__init__(f"run paused at stage {sid} boundary for "
                         f"daemon handoff")


def _tagged(sink, job):
    """``sink`` with every event tagged ``"job": job``, carrying the
    sink's level (``trace.leveled``), so spans and the sampler gate on
    the wrapped log's level as they would on the log itself."""
    def tag(e):
        e.setdefault("job", job)
        sink(e)
    return trace.leveled(tag, getattr(sink, "level", None))


class Run:
    """One execution of a StageGraph with lineage-based recovery."""

    def __init__(self, executor, graph: StageGraph,
                 bindings: Optional[Dict[str, PData]] = None,
                 spill_dir: Optional[str] = None,
                 failure_budget: Optional[int] = None,
                 spill_compression: Optional[str] = None,
                 cost_report=None, event=None, job=None,
                 checkpoint=None, pause=None):
        cfg = executor.config
        self.ex = executor
        self.graph = graph
        self.bindings = bindings or {}
        self.spill_dir = spill_dir
        self.cost_report = cost_report
        self.job = job
        self.checkpoint = checkpoint
        self.pause = pause
        # this run's own state (see the module docstring)
        self.stage_log: List[Dict] = []
        self._log_at: Dict[int, Dict] = {}
        self.host_reads = 0
        self.probes_run = 0
        self.rewrites = 0
        self.placement_changed = False
        sink = event if event is not None else executor._event
        self._event = (_tagged(sink, job)
                       if job is not None and sink is not _no_event
                       else sink)
        # the spans' sink: the run's own, else (None) the process sink
        self._span_sink = None if sink is _no_event else self._event
        # the adaptive boundary hook's measured stats: a one-slot box of
        # THIS run (a concurrent run on the same executor has its own)
        self._stats_box = [None]
        self.adapt = None
        if cfg.adaptive == "on":
            from dryad_tpu_torch.adapt.manager import (AdaptiveManager,
                                                       levels_of_mesh)
            self.adapt = AdaptiveManager(
                graph, cfg, executor.nparts,
                levels=levels_of_mesh(executor.mesh), event=self._event,
                cost_report=cost_report)
        self.spill_compression = (spill_compression
                                  if spill_compression is not None
                                  else cfg.spill_compression)
        self.failure_budget = (failure_budget if failure_budget is not None
                               else cfg.failure_budget)
        self.failures = 0
        self._results: Dict[int, PData] = {}
        # an adaptive run needs each stage's rows when it materializes:
        # the synchronous path, for this run only
        self._defer = ([] if cfg.deferred_needs and not spill_dir
                       and self.adapt is None else None)
        if spill_dir:
            os.makedirs(spill_dir, exist_ok=True)
        # the EXECUTED plan in the event stream, so a viewer draws the
        # DAG that actually ran (a re-planned graph gets fresh stage ids,
        # and a separately serialized plan would not match the stage
        # events).  Serialization never blocks execution: only the
        # serializer's own failures are dropped.
        if sink is not _no_event:
            try:
                plan_json = graph_to_json(graph)
            except (TypeError, ValueError, RecursionError):
                plan_json = None
            if plan_json is not None:
                self._event({"event": "plan", "plan": plan_json})

    # -- public ------------------------------------------------------------

    def output(self) -> PData:
        """The graph's output, computed (or restored) as needed, then
        settled.  ``stage_log`` holds this call's stages; when the call
        ends the executor's ``stage_log`` and ``_last_run_*`` are this
        run's."""
        t0 = time.time()
        self._log_at = {}
        self.stage_log = []
        # the sampler starts no thread without a level-2 consumer
        sampler = _profile.start(self._event,
                                 self.ex.config.resource_sample_s,
                                 device=self.ex.mesh.device, role="driver")
        try:
            # the job span: every stage span of this run parents into it;
            # it stays bound past the with-block, so job_done can carry
            # its trace id (the null span below level 2 has none)
            with trace.span("run", "job", sink=self._span_sink,
                            stages=len(self.graph.stages)) as jsp:
                # an adaptive rewrite may redirect the output to an
                # appended stage mid-walk: walk until the output stage
                # stands still
                while True:
                    out_sid = self.graph.out_stage
                    out = self.result(out_sid)
                    if self.graph.out_stage == out_sid:
                        break
                if self._defer:
                    if trace.ACTIVE:
                        with trace.scope("settle", "settle") as ssp:
                            out = self._settle(ssp)
                    else:
                        out = self._settle()
        finally:
            _profile.stop(sampler)
            applied = self.adapt.applied if self.adapt is not None else []
            self.rewrites = len(applied)
            self.placement_changed = any(
                e.get("kind") in ("broadcast_promote", "broadcast_demote")
                for e in applied)
            with self.ex._cache_lock:
                self.ex.stage_log = self.stage_log
                self.ex._last_run_rewrites = self.rewrites
                self.ex._last_run_placement_changed = \
                    self.placement_changed
        reach, frontier = set(), [self.graph.out_stage]
        while frontier:
            sid = frontier.pop()
            if sid not in reach:
                reach.add(sid)
                frontier.extend(self.graph.stage(sid).input_stage_ids())
        self._event({"event": "progress",
                     "done": len(reach & set(self._results)),
                     "total": len(reach), "pct": 100.0})
        # "metrics" are the process's cumulative counters (the Prometheus
        # model), not this job's deltas.  A farm worker's executor sets
        # _emit_job_done=False (runtime/worker.py): a 16-task farm is one
        # job, not 16
        if getattr(self.ex, "_emit_job_done", True):
            done = {"event": "job_done",
                    "wall_s": round(time.time() - t0, 4),
                    "stages": len(self.graph.stages),
                    "replays": self.failures,
                    "metrics": REGISTRY.snapshot()}
            trace_id = getattr(jsp, "trace_id", None)
            if trace_id:
                done["trace"] = trace_id
            self._event(done)
        return out

    def _settle(self, sp=None) -> PData:
        """Resolve every deferred info vector in ONE device-to-host read.

        The vectors differ in length from stage to stage, so they are
        concatenated on the device and read with one ``tolist``.  Each
        record's ``stage_done`` is emitted as the synchronous path would
        have, and every overflow goes through the shared retry policy in
        order (an overflow no scale fixes raises CapacityError here).
        Overflowed stages get their right-sized knobs and are dropped
        with every stage computed from them (their inputs were
        truncated), then the output is computed again, synchronously.
        The measured send slots feed back, but a stage's whose input was
        truncated.  ``sp`` (the ``settle`` span) gets the number of
        stages replayed."""
        deferred, self._defer = self._defer, None    # the replay is sync
        # a gang reads the all-reduce (max) of every rank's vectors, so
        # every rank takes the same decisions
        flat = self.ex.mesh.all_reduce_max(
            torch.cat([r["info"] for r in deferred])).tolist()
        self.ex._tally(self, "host_reads")
        P = self.ex.nparts
        bad: Dict[int, tuple] = {}
        slots, clean = [], []
        off = 0
        for rec in deferred:
            stage = rec["stage"]
            n = rec["info"].numel()
            info, off = flat[off:off + n], off + n
            L = len(stage.legs)
            slots.append((stage, info[3:3 + L]))
            need_scale, need_slack, need_exch = info[:3]
            of = need_scale > 0 or need_slack > 0
            self._event({
                "event": "stage_done", "stage": stage.id,
                "label": stage.label, "attempt": 0, "scale": rec["scale"],
                "slack": rec["slack"], "overflow": of,
                "need_scale": need_scale, "need_slack": need_slack,
                "need_exchange": need_exch, "salted": rec["salted"],
                "rows": info[3 + L:3 + L + P],
                "out_bytes": rec["out_bytes"], "compile_s": rec["compile_s"],
                "deferred": True, "wall_s": rec["enqueue_s"]})
            self.ex._log_settled(self, stage, rec["scale"], rec["slack"],
                                 rec["salted"], info)
            if not of:
                clean.append((rec, sum(info[3 + L:3 + L + P])))
            else:
                _M_CAP_RETRIES.inc()
                decision = self.ex._decide(
                    stage, rec["scale"], rec["slack"], rec["salted"],
                    need_scale, need_slack, need_exch)
                if decision[0] == "retry":
                    bad[stage.id] = decision
        # every overflowed stage and everything computed from it (its
        # inputs were truncated)
        dirty = set(bad)
        changed = bool(bad)
        while changed:
            changed = False
            for sid in list(self._results):
                if sid not in dirty and any(
                        d in dirty for d in
                        self.graph.stage(sid).input_stage_ids()):
                    dirty.add(sid)
                    changed = True
        # the measured send slots feed back, but for a stage computed
        # from a truncated input, whose slots measure that input (the JAX
        # package feeds those back too, and its replay then ships a slot
        # too small and retries once more)
        for stage, measured in slots:
            if not any(d in dirty for d in stage.input_stage_ids()):
                self.ex._note_slot_feedback(stage, measured)
        # the cost cross-check of every stage that settled clean on whole
        # inputs (a dirty one is checked on its synchronous replay)
        for rec, rows in clean:
            if rec["stage"].id not in dirty:
                self.ex._check_cost(rec["stage"], rec["scale"], rows,
                                    rec["out_bytes"],
                                    report=rec["cost_report"],
                                    event=self._event)
        if bad:
            # the settle replay IS a capacity retry: a zero budget means
            # the first overflow is surfaced, not healed
            if self.ex.config.max_capacity_retries == 0:
                st = self.graph.stage(min(bad))
                raise CapacityError(
                    f"stage {st.id} ({st.label}) still overflowing after "
                    f"0 capacity retries (deferred settle)")
            for sid, (_, scale, slack, salted) in bad.items():
                st = self.graph.stage(sid)
                st._capacity_scale = scale
                st._send_slack = slack
                st._salted = salted
            for sid in dirty:
                self._results.pop(sid, None)
                ent = self._log_at.get(sid)
                if ent is not None:
                    ent["settle_replayed"] = True
            self._event({"event": "settle_replay", "stages": sorted(dirty)})
        if sp is not None:
            sp.set(replayed=len(dirty))
        return self.result(self.graph.out_stage)

    def result(self, sid: int) -> PData:
        """Materialize stage ``sid`` on demand: each step walks from
        ``sid`` to its deepest missing ancestor and restores (from the
        spill) or computes exactly that one stage."""
        while sid not in self._results:
            cur = sid
            while True:
                spilled = self._load_spill(cur)
                if spilled is not None:
                    self._results[cur] = spilled
                    break
                missing = [d for d in
                           self.graph.stage(cur).input_stage_ids()
                           if d not in self._results]
                if not missing:
                    self._compute(cur)
                    break
                cur = missing[0]
        return self._results[sid]

    def _compute(self, sid: int) -> None:
        """Run one ready stage (every input materialized), then the
        adaptive boundary hook: the stages not yet run may be rewritten
        from this one's measured rows before any of them runs (Dryad's
        ``NotifyUpstreamVertexCompleted``).  A set ``pause`` raises
        ``HandoffPause`` before the stage runs; ``checkpoint`` is called
        once it is spilled."""
        if self.pause is not None and self.pause.is_set():
            raise HandoffPause(sid)
        stage = self.graph.stage(sid)
        # a stage is cross-checked only on planned inputs: none of its
        # ancestors ran rescaled (their outputs exceed the prediction's
        # capacities, on purpose)
        planned, todo, seen = True, stage.input_stage_ids(), set()
        while todo and planned:
            a = todo.pop()
            if a not in seen:
                seen.add(a)
                up = self.graph.stage(a)
                planned = up._capacity_scale == 1
                todo.extend(up.input_stage_ids())
        # one span per stage computed (its attempts; on the deferred path
        # the host's enqueue only: the device time lands in the settle)
        with trace.span(f"stage {stage.id}:{stage.label}", "stage",
                        sink=self._span_sink, stage=stage.id,
                        label=stage.label,
                        deferred=self._defer is not None):
            out = self.ex._run_stage(
                stage, self,
                cost_report=self.cost_report if planned else None)
        self._results[sid] = out
        self._save_spill(sid, out)
        if self.checkpoint is not None:
            self.checkpoint(self, sid)
        total = len(self.graph.stages)
        self._event({"event": "progress", "done": len(self._results),
                     "total": total, "stage": sid,
                     "pct": round(100.0 * len(self._results) / total, 1)})
        st = self._stats_box[0]
        if self.adapt is not None and st is not None and st.stage == sid:
            n_before = len(self.adapt.applied)
            self.adapt.on_stage_materialized(st, set(self._results))
            # a rewrite reshapes stages the static model never saw: drop
            # their predictions, so the cross-check cannot miss against
            # pre-rewrite bounds
            if self.cost_report is not None:
                for ev in self.adapt.applied[n_before:]:
                    for rid in ([ev.get("stage")]
                                + list(ev.get("new_stages", ()))
                                + list(ev.get("orphaned", ()))):
                        self.cost_report._by_stage.pop(rid, None)

    def invalidate(self, sid: int, count_failure: bool = True,
                   drop_spill: bool = False) -> None:
        """Report a lost stage output (a fault, a preemption, a test).
        Counted failures beyond the budget raise FailureBudgetExceeded;
        ``drop_spill`` also deletes the stage's spilled store."""
        if count_failure:
            self.failures += 1
            self._event({"event": "stage_replay", "stage": sid,
                         "label": self.graph.stage(sid).label,
                         "failures": self.failures})
            if self.failures > self.failure_budget:
                raise FailureBudgetExceeded(
                    f"{self.failures} failures > budget "
                    f"{self.failure_budget}")
        self._results.pop(sid, None)
        if drop_spill and self.spill_dir:
            p = self._spill_path(sid)
            if os.path.exists(p):
                shutil.rmtree(p)

    # -- spill -------------------------------------------------------------

    def _spill_path(self, sid: int) -> str:
        return os.path.join(self.spill_dir, f"stage-{sid:04d}")

    def _stage_fp(self, sid: int) -> str:
        return hashlib.sha256(
            self.graph.stage(sid).fingerprint().encode()).hexdigest()

    def _save_spill(self, sid: int, pd: PData) -> None:
        if not self.spill_dir:
            return
        from dryad_tpu_torch.io.store import write_store
        with _SPILL_IO_LOCK:
            write_store(self._spill_path(sid), pd,
                        compression=self.spill_compression)
        if self.adapt is not None:
            # an adaptive run may have reshaped this stage; a resume
            # replans without the rewrite, so record the shape that ran
            with open(self._spill_path(sid) + ".fp", "w") as f:
                f.write(self._stage_fp(sid))
        self._event({"event": "stage_spilled", "stage": sid})

    def _load_spill(self, sid: int) -> Optional[PData]:
        """The spilled output of ``sid``, or None.  A spill that carries a
        ``.fp`` file (an adaptive run writes one) loads only when it names
        this stage's current fingerprint, and an adaptive run loads no
        spill without one (this run may already have rewritten the
        stage); a refusal recomputes, never wrong rows.  Fingerprints of
        stages with UDFs name the callables by object id, so a resume in
        a new process recomputes those."""
        if not self.spill_dir:
            return None
        p = self._spill_path(sid)
        if not os.path.exists(p):
            return None
        fp_file = p + ".fp"
        if os.path.exists(fp_file):
            try:
                with open(fp_file) as f:
                    ok = f.read().strip() == self._stage_fp(sid)
            except OSError:
                ok = False
        else:
            ok = self.adapt is None
        if not ok:
            return None
        from dryad_tpu_torch.io.store import read_store
        with _SPILL_IO_LOCK:
            pd = read_store(p, self.ex.mesh)
        self._event({"event": "stage_restored", "stage": sid})
        return pd
