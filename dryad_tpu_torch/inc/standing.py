"""The service-resident half of continuous queries — the port of
``dryad_tpu/inc/standing.py``: registrations, the refresh scheduler,
and the job-shaped streaming surface.

A ``SELECT ... EMIT EVERY n`` submission registers a
:class:`StandingQuery` instead of running once.  The entry is
JOB-SHAPED — it carries the same id/tenant/app/state/log/``events_since``
surface as a :class:`~dryad_tpu_torch.service.job.ServiceJob` — so the whole
existing HTTP read side (``GET /status/<id>``, ``GET /events/<id>``,
the ``/events/<id>/stream`` SSE channel, ``POST /cancel/<id>``) works
on a standing id unchanged: followers of the stream receive one
``inc_refresh`` record per refresh carrying the result DELTA.

Each refresh is submitted as a NORMAL fair-share job under the
registering tenant (app ``inc-refresh``), so admission quotas, the
dashboard, and per-tenant SLO attainment all apply per refresh with
zero new machinery.  Registrations persist as JSON under
``<service_dir>/standing/`` (write-temp + rename, the store commit
discipline) and the aggregate state under ``<service_dir>/inc_state/``
is fingerprint-keyed (inc/state.py) — a daemon restart reloads both
and resumes every standing query from its last COMMITTED watermark:
chunks appended while the daemon was down are exactly the next delta.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from dryad_tpu_torch.service.job import _JobLog
from dryad_tpu_torch.service.tenancy import (MalformedJobError, ServiceRejected,
                                       ServiceStoppedError)

__all__ = ["StandingQuery", "StandingManager"]

# floor between generation polls of one entry's store manifest: a
# sub-100ms EMIT EVERY must not turn the scheduler into a meta.json
# hot loop
_MIN_POLL_S = 0.05


class StandingQuery:
    """One registered standing query (see module docstring).  States:
    ``running`` (scheduling refreshes) -> ``cancelled`` (unregistered)
    or ``stopped`` (daemon shut down; a restart resumes it)."""

    def __init__(self, sid: str, tenant: str, priority: int, query: str,
                 norm: str, emit_every: float, standing_dir: str,
                 history_dir: Optional[str] = None,
                 created_ts: Optional[float] = None):
        self.id = sid
        self.tenant = tenant
        self.app = "standing"
        self.priority = priority
        self.query = query
        self.norm = norm
        self.emit_every = float(emit_every)
        self.state = "running"
        self.error: Optional[str] = None
        self.created_ts = (float(created_ts) if created_ts is not None
                           else time.time())
        self.dir = standing_dir
        self.log = _JobLog(sid, os.path.join(standing_dir,
                                             f"{sid}.jsonl"),
                           history_dir=history_dir, app="standing",
                           tenant=tenant)
        # scheduler bookkeeping (mutated only under the manager's lock
        # or by the single in-flight refresh job)
        self.next_due = 0.0           # first refresh runs immediately
        self.inflight: Optional[str] = None   # refresh job id
        self.refreshes = 0
        self.fallbacks = 0
        self.last_generation: Optional[int] = None
        self.last_mode: Optional[str] = None
        self.last_rows = 0
        self.last_wall_s = 0.0
        self._waiters = threading.Condition()

    # -- sink protocol (same contract as ServiceJob) -----------------------

    def event(self, e: Dict[str, Any]) -> None:
        # records teed from a refresh job arrive stamped with THAT
        # job's id; the standing stream re-tags them with its own so a
        # follower of this id sees a self-consistent job-tagged stream
        # (the underlying refresh id moves to ``refresh``)
        if e.get("job") not in (None, self.id):
            e = dict(e, refresh=e["job"], job=self.id)
        self.log(e)
        if not self.log.admits(e.get("event")):
            return
        self._notify()

    def __call__(self, e: Dict[str, Any]) -> None:
        self.event(e)

    @property
    def level(self) -> int:
        return self.log.level

    def _notify(self) -> None:
        with self._waiters:
            self._waiters.notify_all()

    def events_since(self, after: int,
                     timeout: Optional[float] = None
                     ) -> "tuple[List[Dict[str, Any]], int]":
        """Long-poll/SSE read side, mirroring ServiceJob: blocks while
        the standing query is live and no fresh events exist, so the
        SSE channel idles between refreshes instead of spinning."""
        if (timeout and len(self.log.events) <= after
                and self.state == "running"):
            with self._waiters:
                if len(self.log.events) <= after \
                        and self.state == "running":
                    self._waiters.wait(timeout)
        evs = list(self.log.events[after:])
        return evs, after + len(evs)

    # -- lifecycle ---------------------------------------------------------

    def note_refresh(self, res) -> None:
        """Fold one completed refresh's RefreshResult into the entry."""
        self.refreshes += 1
        if res.mode in ("rescan", "rebuild"):
            self.fallbacks += 1
        self.last_generation = res.generation
        self.last_mode = res.mode
        self.last_rows = res.rows
        self.last_wall_s = res.wall_s

    def cancel(self) -> bool:
        """Unregister: stop scheduling, close the log (SSE followers
        see the terminal frame).  True if it transitioned."""
        if self.state != "running":
            return False
        self.state = "cancelled"
        self.event({"event": "standing_query_cancelled",
                    "refreshes": self.refreshes})
        self.log.close()
        self._notify()
        return True

    def stop(self) -> None:
        """Daemon shutdown: the registration survives on disk and a
        restart resumes it; only the live entry winds down."""
        if self.state != "running":
            return
        self.state = "stopped"
        self.log.close()
        self._notify()

    # -- introspection -----------------------------------------------------

    @property
    def progress_pct(self) -> float:
        return 100.0 if self.refreshes else 0.0

    def to_row(self, with_result: bool = False) -> Dict[str, Any]:
        """Job-row-shaped status (the GET /status/<id> payload for a
        standing id), extended with the standing-specific fields."""
        return {"job": self.id, "tenant": self.tenant, "app": self.app,
                "priority": self.priority, "state": self.state,
                "progress_pct": self.progress_pct,
                "tasks_done": self.refreshes, "tasks": self.refreshes,
                "submitted_ts": round(self.created_ts, 3),
                "wall_s": (round(self.last_wall_s, 4)
                           if self.refreshes else None),
                "error": self.error, "dir": self.dir, "rewrites": 0,
                "standing": True, "query": self.norm,
                "emit_every": self.emit_every,
                "refreshes": self.refreshes,
                "fallbacks": self.fallbacks,
                "watermark": self.last_generation,
                "mode": self.last_mode, "rows": self.last_rows}


class StandingManager:
    """Registry + scheduler (see module docstring).  Owned by an
    in-process JobService; ``start()`` spins the tick thread."""

    def __init__(self, service, load: bool = True):
        self.service = service
        self.dir = os.path.join(service.root, "standing")
        self.state_dir = os.path.join(service.root, "inc_state")
        for d in (self.dir, self.state_dir):
            os.makedirs(d, exist_ok=True)
        self.entries: Dict[str, StandingQuery] = {}
        self._bounds: Dict[str, Any] = {}     # sid -> BoundSelect
        self._lock = threading.Lock()
        self._seq = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # a durable daemon passes load=False and calls restore() from
        # the ONE journal-replay pass instead (service/durable/recover)
        if load:
            self.restore({})

    # -- registration ------------------------------------------------------

    def register(self, query: str, norm: str, bound, tenant: str,
                 priority: int = 0, persist: bool = True,
                 sid: Optional[str] = None,
                 created_ts: Optional[float] = None) -> str:
        """Register one standing query; returns its id.  ``bound`` is
        the compiled BoundSelect (``emit_every`` set).  Rejections are
        the typed service errors — zero state is left behind."""
        svc = self.service
        t = svc.catalog.get(bound.base_table)
        if t is None or t.kind != "store":
            raise MalformedJobError("sql", ValueError(
                f"standing query base table {bound.base_table!r} must "
                f"be a store-backed registration (got "
                f"{'missing' if t is None else t.kind}) — only stores "
                f"grow"))
        with self._lock:
            if sid is None:
                self._seq += 1
                sid = f"{tenant}-standing-{self._seq}"
            sq = StandingQuery(sid, tenant, priority, query, norm,
                               float(bound.emit_every), self.dir,
                               history_dir=svc.history_dir,
                               created_ts=created_ts)
            self.entries[sid] = sq
            self._bounds[sid] = bound
        if persist:
            self._persist(sq)
        reg = {"event": "standing_query_registered", "query": norm,
               "emit_every": sq.emit_every, "tenant": tenant,
               "table": bound.base_table, "resumed": not persist}
        sq.event(reg)
        svc.log(dict(reg, job=sid))
        return sid

    def _persist(self, sq: StandingQuery) -> None:
        from dryad_tpu_torch.utils.atomic import atomic_write_json
        rec = {"id": sq.id, "tenant": sq.tenant,
               "priority": sq.priority, "query": sq.query,
               "emit_every": sq.emit_every,
               "created_ts": sq.created_ts}
        atomic_write_json(os.path.join(self.dir, f"{sq.id}.json"), rec)
        # unified recovery (service/durable): the registration also
        # lands in the service journal so ONE replay pass restores
        # queued jobs AND standing queries together
        j = self.service.journal
        if j is not None:
            j.standing_registered(rec)

    def _disk_regs(self) -> Dict[str, Dict[str, Any]]:
        """{sid: registration record} from the persisted JSON files."""
        out: Dict[str, Dict[str, Any]] = {}
        for name in sorted(os.listdir(self.dir)):
            if not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(self.dir, name)) as f:
                    rec = json.load(f)
                out[rec["id"]] = rec
            except Exception as e:
                self.service.log({"event": "service_error",
                                  "where": "standing_load",
                                  "file": name, "error": repr(e)})
        return out

    def restore(self, journal_regs: Dict[str, Dict[str, Any]]) -> int:
        """Restart resume: recompile each persisted registration — the
        on-disk JSON files merged with the journal's net-of-cancels
        view (``journal_regs``, which wins per id) — against the
        CURRENT catalog.  One that no longer compiles (its table was
        dropped) stays on disk but is skipped with a service error
        event — never a daemon-killing raise.  Returns the count
        actually resumed."""
        from dryad_tpu_torch import sql as _sql
        regs = self._disk_regs()
        regs.update(journal_regs or {})
        n = 0
        for sid, rec in sorted(regs.items(),
                               key=lambda kv: (kv[1].get("created_ts")
                                               or 0.0, kv[0])):
            try:
                tail = sid.rsplit("-", 1)[-1]
                if tail.isdigit():
                    self._seq = max(self._seq, int(tail))
                _mode, bound = _sql.compile_query(self.service.catalog,
                                                  rec["query"])
                if bound.emit_every is None:
                    raise ValueError("registration lost its EMIT EVERY")
                self.register(rec["query"],
                              _sql.normalize_query(rec["query"]), bound,
                              rec["tenant"],
                              priority=int(rec.get("priority", 0)),
                              persist=False, sid=sid,
                              created_ts=rec.get("created_ts"))
                n += 1
            except Exception as e:
                self.service.log({"event": "service_error",
                                  "where": "standing_load",
                                  "file": f"{sid}.json", "error": repr(e)})
        return n

    # -- scheduling --------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop,
                                        name="standing-scheduler",
                                        daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(_MIN_POLL_S):
            now = time.time()
            with self._lock:
                due = [sq for sq in self.entries.values()
                       if sq.state == "running" and sq.inflight is None
                       and now >= sq.next_due]
            for sq in due:
                try:
                    self._kick(sq, now)
                except Exception as e:      # never kill the scheduler
                    sq.next_due = now + max(sq.emit_every, _MIN_POLL_S)
                    self.service.log({"event": "service_error",
                                      "where": "standing_kick",
                                      "job": sq.id, "error": repr(e)})

    def _kick(self, sq: StandingQuery, now: float) -> None:
        """One due entry: skip the refresh entirely when the store has
        not grown past the last refreshed generation (a cheap manifest
        read — the common idle case costs no job submission at all),
        else submit the refresh as a normal fair-share job."""
        svc = self.service
        sq.next_due = now + max(sq.emit_every, _MIN_POLL_S)
        bound = self._bounds[sq.id]
        if sq.last_generation is not None:
            from dryad_tpu_torch.io.store import store_generation, store_meta
            t = svc.catalog.get(bound.base_table)
            try:
                if (t is not None and
                        store_generation(store_meta(t.path))
                        <= sq.last_generation):
                    return
            except OSError:
                return                      # store briefly mid-commit

        def run_local(service, job, _sq=sq, _bound=bound):
            return self._refresh(service, job, _sq, _bound)

        try:
            job = svc._new_job("inc-refresh", sq.tenant, sq.priority, 1,
                               run_local=run_local)
            sq.inflight = job.id
            svc._admit(job, kind="refresh")
        except (ServiceRejected, ServiceStoppedError):
            # over quota (or stopping): the registration stands, the
            # refresh just waits for the next due tick
            sq.inflight = None

    def _refresh(self, service, job, sq: StandingQuery, bound):
        """The refresh job's run_local: executes on a fleet thread
        against the SHARED warm executor; events tee to both the
        refresh job's log and the standing entry's stream."""
        from dryad_tpu_torch.inc.refresh import run_refresh, table_payload
        from dryad_tpu_torch.obs.metrics import REGISTRY, family_counter
        try:
            # the refresh's scans and its delta query run on the
            # service's shared executor
            ctx = service._context(job.config)
            ctx.executor = service.executor
            res = run_refresh(ctx, service.catalog, bound, sq.norm,
                              self.state_dir, event=_Tee(job, sq),
                              job=job.id)
            sq.note_refresh(res)
            family_counter(REGISTRY, "inc_refreshes", job=sq.id).inc()
            if res.mode in ("rescan", "rebuild"):
                family_counter(REGISTRY, "inc_fallbacks",
                               job=sq.id).inc()
            out = table_payload(res.table)
            out.update(mode=res.mode, code=res.code,
                       generation=res.generation,
                       delta_rows=res.delta_rows,
                       changed_rows=res.changed_rows)
            return out
        finally:
            sq.inflight = None

    # -- control / introspection -------------------------------------------

    def get(self, sid: str) -> Optional[StandingQuery]:
        with self._lock:
            return self.entries.get(sid)

    def cancel(self, sid: str) -> bool:
        """Unregister a standing query: its persisted registration file
        goes away (a restart will NOT resume it) and its stream gets
        the terminal frame.  The fingerprint-keyed aggregate state is
        left behind on purpose — re-registering the same query over the
        same table resumes from the committed watermark."""
        with self._lock:
            sq = self.entries.get(sid)
        if sq is None or not sq.cancel():
            return False
        try:
            os.unlink(os.path.join(self.dir, f"{sid}.json"))
        except OSError:
            pass
        j = self.service.journal
        if j is not None:
            j.standing_cancelled(sid)
        self.service.log({"event": "standing_query_cancelled",
                          "job": sid, "tenant": sq.tenant,
                          "refreshes": sq.refreshes})
        return True

    def rows(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [sq.to_row() for sq in self.entries.values()]

    def stop(self) -> None:
        """Daemon shutdown: stop the scheduler FIRST (no new refresh
        submissions race the closing fleet), then wind down the live
        entries.  Registrations stay on disk for the next daemon."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        with self._lock:
            entries = list(self.entries.values())
        for sq in entries:
            sq.stop()


class _Tee:
    """Event sink fanning one refresh's stream to both the refresh
    job's log and the standing entry (sink protocol: ``__call__`` +
    ``level`` — spans gate on the wider of the two levels)."""

    def __init__(self, *sinks):
        self.sinks = sinks
        self.level = max(s.level for s in sinks)

    def __call__(self, e: Dict[str, Any]) -> None:
        for s in self.sinks:
            s(e)
