"""Per-job driver state for the service daemon — the port of
``dryad_tpu/service/job.py``.

One ``ServiceJob`` is the daemon-resident half of what used to be a
whole driver process in the reference's one-GM-per-job model: identity
(job id, tenant, app, priority), the per-job EventLog (its OWN JSONL
under ``jobs/<id>/``, archived into the shared history dir on close —
the multi-job dashboard's data), the per-job JobConfig (forensics
bundles land in the job's directory, never a neighbor's), the task
list and collected results, and the completion latch API waiters block
on.  Everything here composes with the per-job refactor of
``exec/recovery.Run``: the job's ``event`` sink tags every record with
the job id, so streams from concurrent jobs can never interleave
anonymously even when they share one executor or one fleet.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from dryad_tpu_torch.utils.events import EventLog

__all__ = ["ServiceJob", "JOB_STATES"]

JOB_STATES = ("queued", "running", "done", "failed", "cancelled")


class _JobLog(EventLog):
    """An EventLog that stamps the owning job's id — and tenant — on
    EVERY record at the sink itself, including the log's own close-time
    emissions (``job_archived``), so a job's JSONL is job-tagged end to
    end and concurrent jobs' streams can never interleave anonymously.
    The tenant stamp makes the archived stream self-sufficient for
    post-hoc SLO derivation (``obs/slo.slo_from_events``): the
    Run-emitted ``job_done`` of an in-process query job carries no
    tenant of its own, and without the sink stamp an archive would
    count a tenant's failures (service-emitted, tenant-tagged) while
    dropping its successes."""

    def __init__(self, job_id: str, *a, tenant: Optional[str] = None,
                 **kw):
        self.job_id = job_id
        self.tenant = tenant
        super().__init__(*a, **kw)

    def __call__(self, e: Dict[str, Any]) -> None:
        e = dict(e)
        e.setdefault("job", self.job_id)
        if self.tenant is not None:
            e.setdefault("tenant", self.tenant)
        super().__call__(e)


class ServiceJob:
    """One admitted job (see module docstring)."""

    def __init__(self, job_id: str, tenant: str, app: str, seq: int,
                 priority: int, n_tasks: int, job_dir: str, config,
                 history_dir: Optional[str] = None,
                 params: Optional[Dict[str, Any]] = None,
                 combine: Optional[Callable[[List], Any]] = None,
                 payload: Optional[Dict[str, Any]] = None,
                 run_local: Optional[Callable] = None,
                 clock=None):
        self.id = job_id
        self.tenant = tenant
        self.app = app
        self.seq = seq
        self.priority = priority
        self.params = params or {}
        self.state = "queued"
        self.error: Optional[str] = None
        self.n_tasks = n_tasks
        self.pending = deque(range(n_tasks))
        self.results: List[Any] = [None] * n_tasks
        self.done_tasks = 0
        self.result: Any = None
        self.rewrites = 0
        self.submitted_ts = time.time()
        self.started_ts: Optional[float] = None
        self.finished_ts: Optional[float] = None
        # cluster-fleet payload: {"plan": plan_json, "sources": [per-task
        # source dicts]}; in-process jobs carry run_local instead (a
        # callable executed on a fleet thread with the shared executor)
        self.payload = payload
        self.combine = combine
        self.run_local = run_local
        # durability hooks (service/durable): the daemon sets
        # ``journal`` on admitted jobs so dispatch/terminal transitions
        # land in the write-ahead journal; ``pause`` is the rolling-
        # upgrade handoff signal the in-process Run checks at stage
        # boundaries (exec/recovery.HandoffPause)
        self.journal = None
        self.pause = threading.Event()
        # per-request phase waterfall (obs/latency.py): the daemon
        # hands in the clock it started at submit ENTRY so the
        # precheck/bind/cache segments measured before this object
        # existed are part of the partition; standalone construction
        # (tests, submit_tasks) starts one here.  ``waterfall`` is the
        # settled record the daemon's LatencyTracker folds on terminal.
        from dryad_tpu_torch.obs.latency import PhaseClock
        self.phases = clock if clock is not None else PhaseClock()
        self.waterfall: Optional[Dict[str, Any]] = None
        # per-job driver state: own JSONL + forensics dir + history
        # archive on close (EventLog(app=...) names the dashboard row)
        self.dir = job_dir
        os.makedirs(job_dir, exist_ok=True)
        self.log = _JobLog(job_id,
                           os.path.join(job_dir, "events.jsonl"),
                           history_dir=history_dir, app=app,
                           tenant=tenant)
        self.config = config.replace(
            forensics_dir=os.path.join(job_dir, "bundles"))
        self._done = threading.Event()
        self._lock = threading.Lock()
        # live progress (the Dryad GM web UI's per-job view, multi-
        # jobbed): the latest settled-stages fraction from the Run's
        # ``progress`` events (in-process jobs) or the tasks-done
        # fraction (cluster-fleet jobs); ``_waiters`` wakes long-poll/
        # SSE followers of this job's event stream (service/http.py)
        self._progress = 0.0
        self._waiters = threading.Condition()

    # -- event routing -----------------------------------------------------

    def event(self, e: Dict[str, Any]) -> None:
        """The job's event sink: every record lands in the job's own
        log, which tags it with the job id at the sink (:class:`_JobLog`
        — no extra copy here).  Spans gate on the log's level via the
        ``level`` attribute.

        Recorded events additionally drive the LIVE view: ``progress``
        records refresh the per-job progress fraction + gauge and every
        append wakes this job's stream followers.  Gated on the log
        actually admitting the record, so a level-0 job keeps the whole
        live path a no-op (zero events built, zero wakeups)."""
        self.log(e)
        if not self.log.admits(e.get("event")):
            return
        if e.get("event") == "progress" and e.get("pct") is not None:
            self._set_progress(float(e["pct"]))
        self._notify()

    def _set_progress(self, pct: float) -> None:
        from dryad_tpu_torch.obs.metrics import REGISTRY, family_gauge
        self._progress = max(self._progress, min(100.0, pct))
        family_gauge(REGISTRY, "job_progress",
                     job=self.id).set(round(self._progress / 100.0, 4))

    def _notify(self) -> None:
        with self._waiters:
            self._waiters.notify_all()

    def events_since(self, after: int,
                     timeout: Optional[float] = None
                     ) -> "tuple[List[Dict[str, Any]], int]":
        """``(events[after:], next_cursor)`` — the long-poll/SSE read
        side.  With no fresh events and the job still live, blocks up
        to ``timeout`` for the next append.  The in-memory event list
        is append-only, so a snapshot slice is safe cross-thread."""
        if (timeout and len(self.log.events) <= after
                and self.state in ("queued", "running")):
            with self._waiters:
                if len(self.log.events) <= after \
                        and self.state in ("queued", "running"):
                    self._waiters.wait(timeout)
        evs = list(self.log.events[after:])
        return evs, after + len(evs)

    @property
    def level(self) -> int:
        return self.log.level

    def __call__(self, e: Dict[str, Any]) -> None:   # sink protocol
        self.event(e)

    # -- lifecycle ---------------------------------------------------------

    def mark_phase(self, phase: str) -> None:
        """End request phase ``phase`` now (``mark_once`` semantics —
        the fleets' repeated per-task dispatches must not carve the run
        wall).  At level >= 2 each mark also lands in the log as a
        ``latency_phase`` record for live followers; the construction
        is gated so a level-0/1 job builds nothing extra."""
        self.phases.mark_once(phase)
        if self.log.admits("latency_phase"):
            self.event({"event": "latency_phase", "phase": phase})

    def _settle_waterfall(self, ok: bool) -> None:
        """Settle the phase clock into the job's ``latency_waterfall``
        (called under ``_lock`` on the terminal transition, BEFORE the
        log closes so the record reaches the archive).  The final
        "fetch" mark closes the partition at the submit→result instant;
        the compile share of the run segment comes from the
        ``stage_done`` records ``exec/recovery.py`` settled into this
        log, the trace exemplar from the Run's job span / ``job_done``
        trace stamp."""
        if self.waterfall is not None:
            return
        self.phases.mark("fetch")
        compile_s = 0.0
        trace_id = None
        for e in self.log.events:
            k = e.get("event")
            if k == "stage_done":
                compile_s += float(e.get("compile_s") or 0.0)
            if trace_id is None and k in ("span", "job_done") \
                    and e.get("trace"):
                trace_id = e.get("trace")
        self.waterfall = self.phases.waterfall(
            job=self.id, tenant=self.tenant, app=self.app, ok=ok,
            compile_s=compile_s, trace=trace_id)
        if self.log.admits("latency_waterfall"):
            self.event(self.waterfall)

    def mark_started(self) -> None:
        with self._lock:
            if self.started_ts is None:
                self.started_ts = time.time()
                self.event({"event": "job_started", "tenant": self.tenant,
                            "app": self.app, "tasks": self.n_tasks})
                self._journal("job_dispatched")

    def _journal(self, what: str) -> None:
        """Write-ahead a lifecycle transition (no-op without a journal;
        a journal write failure must never wedge the job)."""
        j = self.journal
        if j is None:
            return
        try:
            if what == "job_dispatched":
                j.job_dispatched(self.id)
            else:
                wall = (round(self.finished_ts
                              - (self.started_ts or self.submitted_ts),
                              4) if self.finished_ts else None)
                j.job_terminal(self.id, self.state, error=self.error,
                               wall_s=wall)
        except Exception:
            pass

    def task_result(self, idx: int, table: Any) -> bool:
        """Record one task's table; True when the job just completed."""
        with self._lock:
            if self.results[idx] is None:
                self.results[idx] = table
                self.done_tasks += 1
            done = self.done_tasks >= self.n_tasks
        # cluster-fleet progress is task-grained (each task is a whole
        # per-worker plan run); same gauge + wakeup as the in-process
        # path's progress events.  Gated like its driving record
        # (task_done, level 1) so a level-0 job stays a no-op.
        if self.n_tasks and self.log.admits("task_done"):
            self._set_progress(100.0 * self.done_tasks / self.n_tasks)
            self._notify()
        return done

    def finish(self, ok: bool, error: Optional[str] = None,
               emit_job_done: bool = True) -> None:
        """Terminal transition: combine results, emit the terminal
        event, close (and thereby archive) the per-job log, release
        waiters.  Idempotent."""
        with self._lock:
            if self.state in ("done", "failed", "cancelled"):
                return
            self.finished_ts = time.time()
            if ok:
                self.state = "done"
                if self.combine is not None:
                    try:
                        self.result = self.combine(list(self.results))
                    except Exception as e:        # combine is user code
                        self.state = "failed"
                        self.error = f"combine failed: {e!r}"
                if self.state == "done" and emit_job_done:
                    self.event({"event": "job_done",
                                "wall_s": round(self.finished_ts
                                                - (self.started_ts
                                                   or self.submitted_ts),
                                                4),
                                "tasks": self.n_tasks,
                                "tenant": self.tenant})
            else:
                self.state = "failed"
                self.error = error
            if self.state == "failed":
                self.event({"event": "job_failed", "tenant": self.tenant,
                            "error": (error or self.error
                                      or "unknown")[:2000]})
            self._settle_waterfall(self.state == "done")
            self._release_inputs()
        self._journal("terminal")
        self.log.close()
        self._done.set()
        self._notify()          # stream followers see the terminal state

    def _release_inputs(self) -> None:
        """Drop the job's input-sized state on terminal transition (the
        farm payload with per-task source columns, the planned-graph
        closure, the per-task tables).  Only ``result`` serves the
        status/result API — without this, the daemon's terminal-job
        retention window would hold whole job INPUTS in RAM, not just
        rows of metadata."""
        self.payload = None
        self.run_local = None
        self.results = []

    def cancel(self) -> bool:
        """Cancel a queued/running job: queued tasks are dropped;
        in-flight task replies will be ignored.  True if it transitioned."""
        with self._lock:
            if self.state in ("done", "failed", "cancelled"):
                return False
            self.state = "cancelled"
            self.pending.clear()
            self.finished_ts = time.time()
            self.event({"event": "job_cancelled", "tenant": self.tenant})
            self._release_inputs()
        self._journal("terminal")
        self.log.close()
        self._done.set()
        self._notify()
        return True

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    # -- introspection -----------------------------------------------------

    @property
    def progress_pct(self) -> float:
        """Live progress fraction (0..100): settled stages (in-process,
        from the Run's ``progress`` events) or finished tasks (cluster
        fleet); a done job is always 100."""
        if self.state == "done":
            return 100.0
        return round(self._progress, 1)

    def to_row(self, with_result: bool = False) -> Dict[str, Any]:
        row = {"job": self.id, "tenant": self.tenant, "app": self.app,
               "priority": self.priority, "state": self.state,
               "progress_pct": self.progress_pct,
               "tasks_done": self.done_tasks, "tasks": self.n_tasks,
               "submitted_ts": round(self.submitted_ts, 3),
               "wall_s": (round(self.finished_ts - self.started_ts, 4)
                          if self.finished_ts and self.started_ts
                          else None),
               "error": self.error, "dir": self.dir,
               "rewrites": self.rewrites}
        if with_result and self.state == "done":
            row["result"] = self.result
        return row
