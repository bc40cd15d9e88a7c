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

A Run is the per-job state: the event sink (``event=``, else the
executor's), tagged with ``job=`` when given, the failure budget and the
memo all live on it, never on the shared executor.  Left out until their
ROADMAP items come: adaptive rewrites and the cost report (Queue 1 item
8); the plan event, spans, the resource sampler and the metrics snapshot
in ``job_done``, checkpoint and pause (item 10).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import time
from typing import Dict, Optional

import torch

from dryad_tpu_torch.exec.data import PData
from dryad_tpu_torch.exec.executor import CapacityError
from dryad_tpu_torch.plan.stages import StageGraph

__all__ = ["Run", "FailureBudgetExceeded"]


class FailureBudgetExceeded(RuntimeError):
    pass


def _tagged(sink, job):
    """``sink`` with every event tagged ``"job": job``."""
    def tag(e):
        e.setdefault("job", job)
        sink(e)
    return tag


class Run:
    """One execution of a StageGraph with lineage-based recovery."""

    def __init__(self, executor, graph: StageGraph,
                 bindings: Optional[Dict[str, PData]] = None,
                 spill_dir: Optional[str] = None,
                 failure_budget: Optional[int] = None,
                 spill_compression: Optional[str] = None,
                 event=None, job=None):
        cfg = executor.config
        self.ex = executor
        self.graph = graph
        self.bindings = bindings or {}
        self.spill_dir = spill_dir
        self.job = job
        sink = event if event is not None else executor._event
        self._event = _tagged(sink, job) if job is not None else sink
        self.spill_compression = (spill_compression
                                  if spill_compression is not None
                                  else cfg.spill_compression)
        self.failure_budget = (failure_budget if failure_budget is not None
                               else cfg.failure_budget)
        self.failures = 0
        self._results: Dict[int, PData] = {}
        self._defer = ([] if cfg.deferred_needs and not spill_dir
                       else None)
        if spill_dir:
            os.makedirs(spill_dir, exist_ok=True)

    # -- public ------------------------------------------------------------

    def output(self) -> PData:
        """The graph's output, computed (or restored) as needed, then
        settled.  The executor's ``stage_log`` holds this call's
        stages."""
        t0 = time.time()
        self.ex._log_at = {}
        self.ex.stage_log = []
        out = self.result(self.graph.out_stage)
        if self._defer:
            out = self._settle()
        reach, frontier = set(), [self.graph.out_stage]
        while frontier:
            sid = frontier.pop()
            if sid not in reach:
                reach.add(sid)
                frontier.extend(self.graph.stage(sid).input_stage_ids())
        self._event({"event": "progress",
                     "done": len(reach & set(self._results)),
                     "total": len(reach), "pct": 100.0})
        self._event({"event": "job_done",
                     "wall_s": round(time.time() - t0, 4),
                     "stages": len(self.graph.stages),
                     "replays": self.failures})
        return out

    def _settle(self) -> PData:
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
        truncated."""
        deferred, self._defer = self._defer, None    # the replay is sync
        flat = torch.cat([r["info"] for r in deferred]).tolist()
        self.ex.host_reads += 1
        P = self.ex.nparts
        bad: Dict[int, tuple] = {}
        slots = []
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
                "rows": info[3 + L:3 + L + P], "deferred": True,
                "wall_s": rec["enqueue_s"]})
            self.ex._log_settled(stage, rec["scale"], rec["slack"],
                                 rec["salted"], info)
            if of:
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
                ent = self.ex._log_at.get(sid)
                if ent is not None:
                    ent["settle_replayed"] = True
            self._event({"event": "settle_replay", "stages": sorted(dirty)})
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
        """Run one ready stage (every input materialized)."""
        stage = self.graph.stage(sid)
        out = self.ex._run_stage(stage, self._results, self.bindings,
                                 defer=self._defer, event=self._event,
                                 job=self.job)
        self._results[sid] = out
        self._save_spill(sid, out)
        total = len(self.graph.stages)
        self._event({"event": "progress", "done": len(self._results),
                     "total": total, "stage": sid,
                     "pct": round(100.0 * len(self._results) / total, 1)})

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
        write_store(self._spill_path(sid), pd,
                    compression=self.spill_compression)
        self._event({"event": "stage_spilled", "stage": sid})

    def _load_spill(self, sid: int) -> Optional[PData]:
        """The spilled output of ``sid``, or None.  A spill that carries a
        ``.fp`` file (the JAX package writes one for an adaptively
        rewritten stage) loads only when it names this stage's
        fingerprint; a miss recomputes, never wrong rows."""
        if not self.spill_dir:
            return None
        p = self._spill_path(sid)
        if not os.path.exists(p):
            return None
        fp_file = p + ".fp"
        if os.path.exists(fp_file):
            try:
                with open(fp_file) as f:
                    if f.read().strip() != self._stage_fp(sid):
                        return None
            except OSError:
                return None
        from dryad_tpu_torch.io.store import read_store
        pd = read_store(p, self.ex.mesh)
        self._event({"event": "stage_restored", "stage": sid})
        return pd
