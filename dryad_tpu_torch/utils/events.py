"""Job event log — the port of ``dryad_tpu/utils/events.py``.

Structured JSONL in the role of the reference's Calypso reporter: every
stage execution, settle replay, lineage replay, spill, restore, span and
resource sample is an event, and ``job_report`` renders the per-stage
summary.  With ``history_dir`` a log archives its job on ``close()``
(``obs/history.archive_job``: events, plan, metrics, summary), and a
closed log stops being the process's span sink.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["EventLog", "job_report"]


# event kinds by verbosity level (DRYAD_LOGGING_LEVEL): 0 = errors only,
# 1 = + stage / job lifecycle, 2 = all.  The levels are the JAX package's;
# every kind the port emits must be listed (an unknown kind defaults to
# level 0, so it would bypass the filter): tests/test_torch_events.py
# checks the ``{"event": ...}`` literals of the port against this table.
# The kinds of layers the port has not yet (the cluster, the service,
# out-of-core, adaptivity) keep their levels for when those come.
_LEVELS = {
    # failures / teardown verdicts — visible even at level 0
    "stage_replay": 0, "worker_failed": 0, "job_failed": 0,
    "worker_wedged": 0, "task_timeout": 0, "worker_ping_timeout": 0,
    "task_forensics": 0, "service_error": 0,
    # stage / job lifecycle and scheduling decisions
    "stage_done": 1, "plan": 1, "stage_spilled": 1, "stage_restored": 1,
    "task_done": 1, "task_duplicated": 1, "task_reassigned": 1,
    "lint_finding": 1, "settle_replay": 1, "stage_retry": 1,
    "cost_report": 1, "cost_model_miss": 1,
    "stream_stage_done": 1, "stream_tee_spill": 1, "job_done": 1,
    "ooc_cache_write": 1, "ooc_cache_hit": 1, "ooc_cache_invalid": 1,
    "job_archived": 1, "diagnosis_skew": 1, "diagnosis_slow_worker": 1,
    "graph_rewrite": 1,
    "job_submitted": 1, "job_started": 1, "job_cancelled": 1,
    "job_rejected": 1, "service_started": 1, "service_stopped": 1,
    "journal_replay": 1, "job_resumed": 1, "job_readmitted": 1,
    "handoff_started": 1, "handoff_ready": 1, "handoff_adopted": 1,
    "handoff_paused": 1, "chaos_fault": 1,
    "analyze_report": 1, "slo_breach": 1, "regression_suspect": 1,
    "standing_query_registered": 1, "standing_query_cancelled": 1,
    "inc_refresh": 1, "inc_state_write": 1, "inc_fallback_rescan": 1,
    "sql_query": 1, "sql_lowered": 2,
    "latency_waterfall": 1, "latency_phase": 2,
    "reuse_verdict": 1, "scan_shared": 1,
    # chatter: progress ticks, spans, samples, per-stage statistics
    "progress": 2, "task_duplicate_ignored": 2,
    "task_duplicate_failed_ignored": 2, "task_locality_dispatch": 2,
    "span": 2, "resource_sample": 2, "prefetch_stall": 2,
    "adapt_stats": 2, "adapt_skipped": 2,
}


class EventLog:
    """In-memory + optional JSONL-file event sink.

    ``level`` filters by verbosity (default: env ``DRYAD_LOGGING_LEVEL``
    or 2 = everything); unknown event kinds always pass.  A context
    manager, so a failing job cannot leak the JSONL handle::

        with EventLog(path) as log:
            ctx = Context(event_log=log)
            ...
    """

    def __init__(self, path: Optional[str] = None,
                 level: Optional[int] = None,
                 history_dir: Optional[str] = None,
                 app: Optional[str] = None):
        # the append and the write happen under one lock, so two threads'
        # JSONL lines (a run's and its resource sampler's) never
        # interleave
        self._lock = threading.Lock()
        self.events: List[Dict[str, Any]] = []
        self.path = path
        self._f = open(path, "a") if path else None
        self.closed = False
        # job-history archiving (obs/history.py): close() snapshots the
        # job into history_dir under the app's name
        # (JobConfig.history_dir wires this through the Context)
        self.history_dir = history_dir
        self.app = app
        self.level = (level if level is not None
                      else int(os.environ.get("DRYAD_LOGGING_LEVEL", "2")))

    def admits(self, kind: Optional[str]) -> bool:
        """Would an event of ``kind`` pass this log's level filter?"""
        return _LEVELS.get(kind, 0) <= self.level

    def __call__(self, event: Dict[str, Any]) -> None:
        if not self.admits(event.get("event")):
            return
        e = dict(event)
        e.setdefault("ts", round(time.time(), 4))
        with self._lock:
            self.events.append(e)
            # an event after close keeps its in-memory record only
            if self._f is not None and not self.closed:
                self._f.write(json.dumps(e) + "\n")
                self._f.flush()

    def close(self) -> None:
        if self.closed:
            return
        if self.history_dir:
            # archive BEFORE closing, so the job_archived pointer lands in
            # this log's own JSONL too.  An archive that cannot be written
            # (a full disk, a bad path) never fails the finished job: the
            # log records why instead
            from dryad_tpu_torch.obs.history import archive_job
            try:
                self({"event": "job_archived",
                      "path": archive_job(self.history_dir, self.events,
                                          app=self.app)})
            except (OSError, TypeError, ValueError) as e:
                self({"event": "job_archived", "path": None,
                      "error": repr(e)})
        with self._lock:
            self.closed = True
            if self._f is not None:
                self._f.close()
                self._f = None
        # a closed log stops being the process span sink, or later jobs'
        # spans would pile into this dead in-memory list
        from dryad_tpu_torch.obs import trace
        trace.uninstall(self)

    def __enter__(self) -> "EventLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def of_type(self, kind: str) -> List[Dict[str, Any]]:
        return [e for e in self.events if e.get("event") == kind]


def job_report(events) -> str:
    """A per-stage execution summary of an event stream: runs, capacity
    retries, lineage replays, spills, the largest scale and the summed
    wall of each stage, in the order stages first appear."""
    if isinstance(events, EventLog):
        events = events.events
    stages: Dict[Any, Dict[str, Any]] = {}
    order = []
    kinds = ("stage_done", "stage_replay", "stage_retry",
             "stream_stage_done", "stream_tee_spill")
    for e in events:
        if e.get("event") in kinds:
            sid = e.get("stage")
            if sid not in stages:
                stages[sid] = {"label": e.get("label", "?"), "runs": 0,
                               "retries": 0, "replays": 0, "spills": 0,
                               "wall_s": 0.0, "scale": 1}
                order.append(sid)
            s = stages[sid]
            if e.get("label"):
                s["label"] = e["label"]
            if e["event"] in ("stage_done", "stream_stage_done"):
                s["runs"] += 1
                s["wall_s"] += e.get("wall_s", 0.0)
                s["scale"] = max(s["scale"], e.get("scale", 1))
                if e.get("overflow"):
                    s["retries"] += 1
            elif e["event"] == "stage_replay":
                s["replays"] += 1
            elif e["event"] == "stream_tee_spill":
                s["spills"] += 1
    lines = [f"{'stage':>6} {'label':<16} {'runs':>4} {'retries':>7} "
             f"{'replays':>7} {'spills':>6} {'scale':>5} {'wall_s':>8}"]
    for sid in order:
        s = stages[sid]
        lines.append(f"{sid:>6} {s['label']:<16} {s['runs']:>4} "
                     f"{s['retries']:>7} {s['replays']:>7} "
                     f"{s['spills']:>6} {s['scale']:>5} "
                     f"{s['wall_s']:>8.3f}")
    return "\n".join(lines)
