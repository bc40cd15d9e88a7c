"""Daemon-start recovery — the port of
``dryad_tpu/service/durable/recover.py``: replay the journal over the
last checkpoint and restore everything the previous daemon was holding.

One pass restores four kinds of state:

* **tenant fair-share ledgers** — journaled ``tenant_charge`` records
  rebuild ``used_slot_s``/``failures`` floors, so a restart neither
  forgets a tenant's consumption nor double-charges a failure budget;
* **terminal jobs** — indexed into the read-surface archive so
  ``GET /status/<id>`` / ``GET /jobs`` resolve jobs that finished
  before the restart (404 only for never-seen ids);
* **standing queries** — journal registrations (net of cancels) merged
  with the on-disk ``standing/*.json`` files (pre-journal dirs), each
  recompiled against the current catalog;
* **live jobs** — re-built from their journaled spec and re-admitted
  in original ``seq`` order (fair-share order preserved).  A job that
  was RUNNING resumes from lineage + spill (the rebuilt graph reloads
  settled stages through ``Run._load_spill``'s fingerprint check and
  re-executes only the rest); a job that cannot be rebuilt — callable/
  raw-task payloads don't persist, an app vanished, SQL no longer
  compiles — fails WITH FORENSICS (a terminal ``job_failed`` carrying
  the reason plus the last driver checkpoint).  Never silently
  dropped.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

from dryad_tpu_torch.service.durable.checkpoint import JobCheckpoint
from dryad_tpu_torch.service.durable.journal import TERMINAL_STATES

__all__ = ["recover", "job_spec", "archive_row_from_events"]


def job_spec(job, kind: str) -> Dict[str, Any]:
    """The journaled (JSON-able) rebuild spec for one admitted job.
    ``recoverable`` is False when the inputs cannot be rebuilt from
    the spec alone (driver callables, pre-serialized task payloads,
    params that don't serialize)."""
    params: Optional[Dict[str, Any]] = None
    recoverable = kind in ("app", "sql")
    if recoverable:
        try:
            params = json.loads(json.dumps(job.params))
        except (TypeError, ValueError):
            params, recoverable = None, False
    return {"id": job.id, "tenant": job.tenant, "app": job.app,
            "seq": job.seq, "priority": job.priority,
            "n_tasks": job.n_tasks, "kind": kind, "params": params,
            "recoverable": recoverable,
            "submitted_ts": round(job.submitted_ts, 3)}


def archive_row_from_spec(ent: Dict[str, Any]) -> Dict[str, Any]:
    """A /jobs-shaped row for a journaled terminal job."""
    spec = ent.get("spec") or {}
    state = ent["phase"]
    return {"job": ent["id"], "tenant": spec.get("tenant", "?"),
            "app": spec.get("app", "?"),
            "priority": spec.get("priority", 0), "state": state,
            "progress_pct": 100.0 if state == "done" else 0.0,
            "tasks_done": 0, "tasks": spec.get("n_tasks", 0),
            "submitted_ts": spec.get("submitted_ts"),
            "wall_s": ent.get("wall_s"), "error": ent.get("error"),
            "dir": None, "rewrites": 0, "archived": True}


def archive_row_from_events(jid: str, job_dir: str
                            ) -> Optional[Dict[str, Any]]:
    """Pre-journal compat: derive a terminal row from a persisted job
    dir's ``events.jsonl``.  None when the dir holds no terminal event
    (a pre-journal crash left it unfinished — without a journaled spec
    there is nothing to rebuild, and inventing a failure would clobber
    a dir some OTHER live daemon may be writing)."""
    path = os.path.join(job_dir, "events.jsonl")
    row: Dict[str, Any] = {"job": jid, "tenant": "?", "app": "?",
                           "priority": 0, "state": None,
                           "progress_pct": 0.0, "tasks_done": 0,
                           "tasks": 0, "submitted_ts": None,
                           "wall_s": None, "error": None,
                           "dir": job_dir, "rewrites": 0,
                           "archived": True}
    try:
        with open(path) as f:
            for line in f:
                try:
                    e = json.loads(line)
                except ValueError:
                    continue
                k = e.get("event")
                if k == "job_submitted":
                    row["tenant"] = e.get("tenant", "?")
                    row["app"] = e.get("app", "?")
                    row["tasks"] = e.get("tasks", 0)
                    row["submitted_ts"] = e.get("ts")
                elif k == "job_done":
                    row["state"] = "done"
                    row["progress_pct"] = 100.0
                    row["wall_s"] = e.get("wall_s")
                elif k == "job_failed":
                    row["state"] = "failed"
                    row["error"] = e.get("error")
                elif k == "job_cancelled":
                    row["state"] = "cancelled"
    except OSError:
        return None
    return row if row["state"] in TERMINAL_STATES else None


def _forensics(service, spec: Dict[str, Any]) -> str:
    """The fail-with-forensics trailer: whatever durable driver state
    the lost job left behind, so the failure is diagnosable."""
    jdir = os.path.join(service.jobs_dir, spec["id"])
    ck = JobCheckpoint.load(os.path.join(jdir, "checkpoint.json"))
    spill = os.path.join(jdir, "spill")
    bits = [f"job dir: {jdir}"]
    if ck is not None:
        bits.append(f"last driver checkpoint: settled stages "
                    f"{ck.get('settled')}, failure budget left "
                    f"{ck.get('budget_left')}")
    bits.append("spill: " + (
        "present" if os.path.isdir(spill) else "none"))
    return "\n  ".join(bits)


def _rebuild_runner(service, spec: Dict[str, Any]):
    """(run_local, payload, combine, n_tasks) rebuilt from the spec
    through the paths submission uses, so a recovered job is
    plan-cache-warm and lint-gated like a fresh one (a cluster fleet's
    job gets its farm payload, an in-process one its runner)."""
    from dryad_tpu_torch.service.apps import get_app
    params = dict(spec.get("params") or {})
    if spec["kind"] == "sql":
        from dryad_tpu_torch import sql as _sql
        from dryad_tpu_torch.analysis.canon import semantic_fingerprint
        _mode, bound = _sql.compile_query(service.catalog, params["sql"])
        if bound.emit_every is not None:
            raise ValueError("journaled one-shot job re-compiled to a "
                             "standing query")
        fp = service.catalog.fingerprint()
        semfp = semantic_fingerprint(service.catalog, bound)
        if service.cluster is not None:
            from dryad_tpu_torch.service.daemon import _sql_combine
            payload, limit, _ = service._build_sql_farm_payload(
                bound, semfp, fp)
            return None, payload, _sql_combine(limit), 1
        run_local, _ = service._build_sql_local_runner(bound, semfp, fp)
        return run_local, None, None, 1
    service_app = get_app(spec["app"])
    if service.cluster is not None:
        payload = service._build_farm_payload(service_app, params)
        return (None, payload, service_app.combine,
                len(payload["sources"]))
    tasks = service_app.make_tasks(dict(params), service.nparts)
    return (service._build_local_runner(service_app, params, tasks),
            None, None, 1)


def recover(service) -> Dict[str, Any]:
    """The one recovery pass (see module docstring).  Returns (and
    logs, as ``journal_replay``) a summary.  Never raises for a
    per-job failure — only a corrupt journal refuses recovery, and
    that happened earlier, when the journal was opened."""
    from dryad_tpu_torch.obs.metrics import (REGISTRY, family_counter,
                                       family_gauge)
    t0 = time.time()
    jrn = service.journal
    state = jrn.recovered
    summary = {"records": state.counter, "torn": jrn.was_torn,
               "clean": jrn.was_clean, "epochs": state.epochs,
               "resumed": 0, "readmitted": 0, "failed": 0,
               "standing": 0, "terminal_indexed": 0,
               "dup_terminals": len(state.dup_terminals)}

    # terminal jobs -> the read-surface archive (restart blindness fix)
    for jid, ent in state.jobs.items():
        if ent["phase"] in TERMINAL_STATES and ent["phase"] != "rejected":
            row = archive_row_from_spec(dict(ent, id=jid))
            row["dir"] = os.path.join(service.jobs_dir, jid)
            service._archive[jid] = row
    # pre-journal job dirs (or dirs journaled by an older epoch whose
    # checkpoint aged them out): index whatever left a terminal event
    try:
        for name in sorted(os.listdir(service.jobs_dir)):
            if name in state.jobs or name in service._archive:
                continue
            jdir = os.path.join(service.jobs_dir, name)
            if not os.path.isdir(jdir):
                continue
            row = archive_row_from_events(name, jdir)
            if row is not None:
                service._archive[name] = row
    except OSError:
        pass
    summary["terminal_indexed"] = len(service._archive)

    # tenant fair-share ledgers: floors, not increments — replay is
    # idempotent and a tenant's budget is never double-charged
    for tenant, tot in state.tenants.items():
        service.admission.restore_tenant(
            tenant, used_slot_s=tot.get("used_slot_s", 0.0),
            failures=int(tot.get("failures", 0)))

    # sequence high-water: new submissions must not collide with
    # journaled ids
    with service._jobs_lock:
        service._seq = max(service._seq, state.seq)

    # standing queries: one unified restore (journal net-of-cancels
    # merged with the persisted registration files)
    if service.standing is not None:
        summary["standing"] = service.standing.restore(state.standing)

    prior = jrn.prior_owner
    if jrn.was_handoff is not None:
        service.log({"event": "handoff_adopted",
                     "from_ver": jrn.was_handoff.get("ver"),
                     "to_ver": jrn.version,
                     "prior_pid": (prior or {}).get("pid")})

    # live jobs, original admission order
    live = state.live_jobs()
    for ent in live:
        spec = ent["spec"]
        jid = ent["id"]
        was_running = ent["phase"] == "running"
        if spec is not None and spec.get("kind") == "refresh":
            # a standing refresh is DERIVED work: its registration was
            # restored above and the scheduler kicks a fresh refresh
            # immediately — cancel the stale one instead of failing it
            # against the tenant (journaled, so it never resurrects)
            service.journal.job_terminal(
                jid, "cancelled",
                error="standing refresh superseded across restart")
            service.log({"event": "job_cancelled", "job": jid,
                         "tenant": spec.get("tenant"),
                         "superseded": True})
            summary["superseded"] = summary.get("superseded", 0) + 1
            continue
        if spec is None or not spec.get("recoverable"):
            why = ("its payload does not persist (driver callables "
                   "and raw task payloads journal no rebuild spec)"
                   if spec is not None else
                   "its admission record is missing from the journal")
            _fail_forensics(service, jid, spec, why, summary)
            continue
        try:
            run_local, payload, combine, n_tasks = \
                _rebuild_runner(service, spec)
        except Exception as e:
            # whatever stops the rebuild (a vanished app or table, a
            # query that no longer compiles) fails the job with forensics
            _fail_forensics(service, jid, spec,
                            f"its plan no longer rebuilds: {e!r}",
                            summary)
            continue
        job = service._restore_job(spec, n_tasks, run_local=run_local,
                                   payload=payload, combine=combine)
        kind = "job_resumed" if was_running else "job_readmitted"
        ck = JobCheckpoint.load(os.path.join(job.dir,
                                             "checkpoint.json"))
        ev = {"event": kind, "tenant": job.tenant, "app": job.app,
              "seq": job.seq,
              "settled_stages": (ck or {}).get("settled"),
              "spill": os.path.isdir(os.path.join(job.dir, "spill"))}
        job.event(dict(ev))
        service.log(dict(ev, job=jid))
        family_counter(REGISTRY, "jobs_recovered",
                       outcome=("resumed" if was_running
                                else "readmitted")).inc()
        summary["resumed" if was_running else "readmitted"] += 1

    wall = time.time() - t0
    summary["wall_s"] = round(wall, 4)
    family_gauge(REGISTRY, "recovery_seconds").set(round(wall, 4))
    if (state.counter or summary["terminal_indexed"]
            or summary["standing"] or live):
        service.log(dict(summary, event="journal_replay",
                         prior_owner=prior))
    return summary


def _fail_forensics(service, jid: str, spec: Optional[Dict[str, Any]],
                    why: str, summary: Dict[str, Any]) -> None:
    """Terminal-with-forensics for a job recovery cannot rebuild: the
    tenant gets a real failed row (and journal terminal record), never
    a silent drop."""
    from dryad_tpu_torch.obs.metrics import REGISTRY, family_counter
    spec = spec or {"id": jid, "tenant": "?", "app": "?", "seq": 0,
                    "priority": 0, "n_tasks": 0}
    err = (f"lost across daemon restart: {why}\n  "
           + _forensics(service, spec))
    job = service._restore_job(spec, spec.get("n_tasks") or 1,
                               admit=False)
    job.pending.clear()
    job.finish(False, error=err)
    service._job_terminal(job)
    family_counter(REGISTRY, "jobs_recovered", outcome="failed").inc()
    summary["failed"] += 1
