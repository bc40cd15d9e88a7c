"""The persistent job-service daemon — the port of
``dryad_tpu/service/daemon.py``: one process, many concurrent jobs, one
shared fleet.

``JobService`` admits jobs from many tenants through the fair-share
:class:`~dryad_tpu_torch.service.admission.AdmissionQueue`, gives each
job its own driver state (:class:`~dryad_tpu_torch.service.job.
ServiceJob`, and the job's own ``exec/recovery.Run``), and shares what
should be shared.  Two fleet shapes:

* **in-process** (``cluster=None``): ``slots`` fleet threads over ONE
  ``Executor`` on one mesh of ``device`` (its slot feedback and probe
  caches), the :class:`FileCache` of serialized SQL plans, and the scan
  registry (``_load_table``: one loaded PData per table and content
  fingerprint, the caller that ``Catalog.dataset(loader=)`` was written
  for).  Every fleet thread launches on the device's default stream, so
  kernel launches from two jobs run in the stream's order.
  ``JobService(config, device="cuda")`` runs on the CUDA card; without
  CUDA it raises unless the caller passes ``device="cpu"``.
* **cluster** (``cluster=LocalCluster(...)``): a single multiplexing
  dispatch loop over the cluster's control sockets — tasks from MANY
  jobs interleave on the shared worker processes (each on its own
  device, their executors persisting across jobs), replies route back
  to each job's driver state by the envelope's ``protocol.JOB_ID`` tag.
  The daemon holds no device: a job's plan and deferred sources are
  built here (``_build_farm_payload``, ``_build_sql_farm_payload``, the
  serialized plan memoized in the FileCache) and its sources are
  materialized by the workers.  ``submit_tasks`` submits a serialized
  plan with per-task sources.  Standing queries and ``submit_callable``
  need the in-process fleet.
"""

from __future__ import annotations

import json
import os
import re
import select
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional

from dryad_tpu_torch.obs.metrics import (REGISTRY, family_counter,
                                         family_gauge, family_histogram)
from dryad_tpu_torch.service.admission import AdmissionQueue
from dryad_tpu_torch.service.apps import get_app, task_capacity
from dryad_tpu_torch.service.job import ServiceJob
from dryad_tpu_torch.service.tenancy import (MalformedJobError,
                                             ServiceConfig,
                                             ServiceRejected,
                                             ServiceStoppedError)
from dryad_tpu_torch.utils.events import EventLog

__all__ = ["JobService"]

# legal tenant/app names: they are composed into job ids and on-disk
# paths, so no separators or dot-prefixes (path traversal)
_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")

# the logical partitions of every job (a Context's default)
NPARTS = 8


def _now() -> float:
    return time.time()


def _pkg_version() -> str:
    import dryad_tpu_torch
    return dryad_tpu_torch.__version__


class JobService:
    """See module docstring.  ``config`` is a ServiceConfig; ``cluster``
    (optional) a started ClusterBackend whose workers serve the fleet —
    pass ``own_cluster=True`` if the service should shut it down on
    close; a job's tasks then run on ``cluster.devices_per_process``
    partitions of one worker's device.  Without a cluster, jobs run on
    ``NPARTS`` logical partitions of ``device`` through one shared
    executor.  ``catalog`` (an ``sql.Catalog``) wins over
    ``ServiceConfig.catalog_path``."""

    def __init__(self, config: ServiceConfig, cluster=None,
                 own_cluster: bool = False, device="cuda", catalog=None):
        from dryad_tpu_torch.exec.executor import Executor
        from dryad_tpu_torch.parallel.mesh import Mesh, resolve_device
        from dryad_tpu_torch.utils.config import JobConfig
        self.cluster = cluster
        self._own_cluster = own_cluster
        if cluster is not None:
            # the workers hold the devices; a job's task runs on one
            # worker's partitions
            self.mesh = self.device = None
            self.nparts = cluster.devices_per_process
        else:
            # the device first: without CUDA nothing is created on disk
            self.mesh = Mesh(resolve_device(device), NPARTS)
            self.device = self.mesh.device
            self.nparts = NPARTS
        self.config = config
        self.job_config = config.job_config or JobConfig()
        # SQL front end: the table registry POST /sql resolves against
        if catalog is None:
            from dryad_tpu_torch.sql import Catalog
            catalog = (Catalog.load(config.catalog_path)
                       if config.catalog_path else Catalog())
        self.catalog = catalog
        root = os.path.abspath(os.path.expanduser(config.service_dir))
        self.root = root
        self.jobs_dir = os.path.join(root, "jobs")
        self.history_dir = os.path.join(root, "history")
        for d in (self.jobs_dir, self.history_dir):
            os.makedirs(d, exist_ok=True)
        # the daemon's own lifecycle log (rejections included: a refused
        # submission starts zero work, so it has no job log to land in)
        self.log = EventLog(os.path.join(root, "service.jsonl"))
        from dryad_tpu_torch.utils.compile_cache import FileCache
        self.plan_cache = FileCache(os.path.join(root, "cache"))
        # cross-job scan sharing: loaded table PData keyed by (name,
        # content fingerprint); queued or concurrent jobs over the same
        # table content pay ONE load, and a re-registration with other
        # content misses, never serving stale rows
        from collections import OrderedDict
        self._scan_cache: "OrderedDict" = OrderedDict()
        self._scan_lock = threading.Lock()
        self._scan_cap = 16
        self.admission = AdmissionQueue(config.quota)
        # durability (service/durable): the write-ahead journal records
        # every admission / terminal / charge BEFORE the daemon acts on
        # it; opening it replays what the previous daemon left (recover()
        # below restores it).  A corrupt journal raises JournalError
        # (DTA914) HERE.  ``_archive`` indexes pre-restart terminal jobs.
        self._archive: Dict[str, dict] = {}
        self.journal = None
        self.recovery: Optional[dict] = None
        if config.durable:
            from dryad_tpu_torch.service.durable import Journal
            self.journal = Journal(
                os.path.join(root, "durable"), fsync=config.journal_fsync,
                compact_every=config.journal_compact_every)
            self.admission.journal = self.journal
        # per-tenant SLOs (obs/slo.py) and tail latency (obs/latency.py):
        # every terminal job folds in (GET /slo, GET /latency)
        from dryad_tpu_torch.obs.latency import LatencyTracker
        from dryad_tpu_torch.obs.slo import SloTracker
        self.slo = SloTracker(config.slo_objective)
        self.latency = LatencyTracker(registry=REGISTRY)
        self._slo_breaching: set = set()
        # record + transition check are atomic per tenant: two fleet
        # threads retiring one tenant's jobs must not both emit the
        # once-per-transition slo_breach
        self._slo_lock = threading.Lock()
        self.jobs: Dict[str, ServiceJob] = {}
        self._jobs_lock = threading.Lock()
        self._seq = 0
        self._stopping = False
        if cluster is not None:
            self.executor = None
            self._fleet = _ClusterFleet(self)
        else:
            # ONE executor shared by every job (per-job state lives on
            # each job's Run)
            self.executor = Executor(self.mesh, config=self.job_config)
            self._fleet = _LocalFleet(self, config.slots)
        self.log({"event": "service_started",
                  "fleet": ("cluster" if cluster is not None
                            else "in-process"),
                  "slots": self.slots, "dir": root,
                  "device": (cluster.device if cluster is not None
                             else str(self.device))})
        self._fleet.start()
        # standing queries: each refresh is a fair-share job on the shared
        # executor, so they ride the in-process fleet only.  Started after
        # the fleet, so resumed registrations refresh at once; with a
        # journal they restore in the one recovery pass below
        if cluster is None:
            from dryad_tpu_torch.inc.standing import StandingManager
            self.standing = StandingManager(self,
                                            load=self.journal is None)
            self.standing.start()
        else:
            self.standing = None
        if self.journal is not None:
            from dryad_tpu_torch.service.durable import recover
            self.recovery = recover(self)

    @property
    def slots(self) -> int:
        if self.cluster is not None:
            return len(self.cluster.sockets)
        return self.config.slots

    def _context(self, config=None):
        """A Context on the service's device and partitions for lowering,
        planning and the lint gate (its own executor; jobs run on the
        shared one); the daemon's sinks are explicit, so the process span
        sink is left alone."""
        from dryad_tpu_torch.api.dataset import Context
        return Context(device=self.device, nparts=self.nparts,
                       config=config or self.job_config,
                       install_trace=False)

    # -- submission --------------------------------------------------------

    def _reject_teardown(self, job: ServiceJob, err) -> None:
        """Zero-work rejection teardown: the job's directory state goes
        away and the refusal lands in the SERVICE log only (no history
        archive — the job never existed as far as tenants see)."""
        job.log.history_dir = None
        job.log.close()
        try:
            os.unlink(job.log.path)
            os.rmdir(job.dir)
        except OSError:
            pass
        self.log({"event": "job_rejected", "tenant": job.tenant,
                  "app": job.app, "code": err.code, "error": str(err)})

    def _journal_rejected(self, job: ServiceJob, err) -> None:
        """Terminal-journal a zero-work rejection so an admitted-but-
        refused id can never resurrect as a live job at recovery.
        ("rejected" is terminal in the journal but excluded from the
        archive index — as far as tenants see, the job never existed.)"""
        if self.journal is not None:
            try:
                self.journal.job_terminal(job.id, "rejected",
                                          error=str(err))
            except Exception:
                pass

    def _admit(self, job: ServiceJob, kind: str = "app") -> str:
        # write-ahead FIRST: the journal must know the job before any
        # daemon state does, or a crash in this window loses it
        if self.journal is not None:
            from dryad_tpu_torch.service.durable.recover import job_spec
            job.journal = self.journal
            self.journal.job_admitted(job_spec(job, kind))
        try:
            self.admission.submit(job)
        except ServiceRejected as e:
            self._journal_rejected(job, e)
            self._reject_teardown(job, e)
            raise
        with self._jobs_lock:
            self.jobs[job.id] = job
            self._prune_terminal_locked()
        if self._stopping:
            # close() may have swept between _new_job's check and this
            # registration — its sweep can no longer see us, so take the
            # FULL rejection path ourselves (nobody holds the id yet)
            self.admission.retire(job)
            with self._jobs_lock:
                self.jobs.pop(job.id, None)
            err = ServiceStoppedError()
            self._journal_rejected(job, err)
            self._reject_teardown(job, err)
            raise err
        if self.journal is not None:
            self.journal.job_queued(job.id, job.seq)
        job.event({"event": "job_submitted", "tenant": job.tenant,
                   "app": job.app, "priority": job.priority,
                   "tasks": job.n_tasks})
        self.log({"event": "job_submitted", "job": job.id,
                  "tenant": job.tenant, "app": job.app})
        self._fleet.wake()
        return job.id

    def _prune_terminal_locked(self) -> None:
        """Keep at most ``max_terminal_jobs`` TERMINAL jobs resident
        (holds self._jobs_lock): the oldest drop from the live table and
        their per-job metric series leave the registry — a persistent
        daemon's memory must not scale with lifetime job count.  Disk
        state (job dir, history archive) is untouched."""
        cap = self.config.max_terminal_jobs
        term = [j for j in self.jobs.values()
                if j.state in ("done", "failed", "cancelled")]
        if len(term) <= cap:
            return
        term.sort(key=lambda j: j.seq)
        for j in term[:len(term) - cap]:
            del self.jobs[j.id]
            REGISTRY.prune(job=j.id)

    @staticmethod
    def _check_names(app: str, tenant: str) -> None:
        """tenant/app are caller-supplied strings composed into the
        on-disk job path: reject anything that could traverse outside
        service_dir ("../..", separators) or mangle the id format —
        BEFORE any per-name state (admission tenant records included)
        exists anywhere."""
        for field, val in (("tenant", tenant), ("app", app)):
            if not _NAME_RE.match(val):
                raise MalformedJobError(app, ValueError(
                    f"illegal {field} name {val!r} (allowed: letters, "
                    f"digits, then . _ - up to 64 chars)"))

    def _new_job(self, app: str, tenant: str, priority: int,
                 n_tasks: int, **kw) -> ServiceJob:
        if self._stopping:
            raise ServiceStoppedError()
        self._check_names(app, tenant)
        with self._jobs_lock:
            self._seq += 1
            seq = self._seq
        jid = f"{tenant}-{app}-{seq}"
        return ServiceJob(jid, tenant, app, seq, priority, n_tasks,
                          os.path.join(self.jobs_dir, jid),
                          self.job_config, history_dir=self.history_dir,
                          **kw)

    def submit(self, app: str, params: Optional[dict] = None,
               tenant: str = "default", priority: int = 0) -> str:
        """Submit a registered app; returns the job id.  Raises the typed
        DTA91x rejections (tenancy.py), and the lint gate's
        DiagnosticError for a statically rejected plan, with zero work
        started."""
        from dryad_tpu_torch.analysis.diagnostics import (DiagnosticError,
                                                          LintError)
        from dryad_tpu_torch.obs.latency import PhaseClock
        clock = PhaseClock()             # submit-entry instant
        service_app = get_app(app)       # DTA910 before any state
        self._check_names(app, tenant)   # ... so is a bad tenant name
        if self._stopping:               # DTA913 before any state too
            raise ServiceStoppedError()
        # advisory quota precheck BEFORE building the plan (submit()'s
        # atomic check stays authoritative)
        self.admission.precheck(tenant)
        clock.mark("precheck")
        params = dict(params or {})
        try:
            if self.cluster is not None:
                payload = self._build_farm_payload(service_app, params)
            else:
                # build (and so validate) the tasks NOW: bad params
                # reject the SUBMISSION, not the running job
                tasks = service_app.make_tasks(dict(params), self.nparts)
                run_local = self._build_local_runner(service_app, params,
                                                     tasks)
        except (ServiceRejected, DiagnosticError, LintError):
            raise                        # already typed (DTA910/2xx/9xx)
        except (ValueError, TypeError, KeyError, IndexError) as e:
            # the app's builders choking on the PARAMS is a malformed job
            # spec (DTA910); anything else propagates untyped
            raise MalformedJobError(app, e)
        clock.mark("bind")               # plan/payload build + lint
        if self.cluster is not None:
            job = self._new_job(app, tenant, priority,
                                len(payload["sources"]), params=params,
                                payload=payload,
                                combine=service_app.combine, clock=clock)
        else:
            job = self._new_job(app, tenant, priority, 1, params=params,
                                run_local=run_local, clock=clock)
        return self._admit(job)

    def submit_tasks(self, plan_json: str, per_task_sources: List[dict],
                     tenant: str = "default", priority: int = 0,
                     app: str = "custom",
                     combine: Optional[Callable] = None) -> str:
        """Python-API submission of a pre-serialized plan + per-task
        sources (cluster fleet only) — the raw TaskFarm surface behind
        the admission queue."""
        if self.cluster is None:
            raise ValueError("submit_tasks needs a cluster fleet")
        job = self._new_job(app, tenant, priority, len(per_task_sources),
                            payload={"plan": plan_json,
                                     "sources": list(per_task_sources)},
                            combine=combine)
        return self._admit(job, kind="tasks")

    def submit_callable(self, fn: Callable, tenant: str = "default",
                        priority: int = 0, app: str = "callable") -> str:
        """In-process submission of a driver callable ``fn(env)`` where
        ``env`` carries the shared ``executor``/``mesh`` and the job's
        ``event`` sink / ``job_id`` / ``config`` (tests and embedders)."""
        if self.cluster is not None:
            raise ValueError("submit_callable needs the in-process fleet")

        def run_local(service, job, _fn=fn):
            import types
            env = types.SimpleNamespace(
                executor=service.executor, mesh=service.mesh,
                event=job.event, job_id=job.id, config=job.config,
                service=service)
            return _fn(env)

        job = self._new_job(app, tenant, priority, 1,
                            run_local=run_local)
        return self._admit(job, kind="callable")

    # -- SQL submission (the sql/ front end) -------------------------------

    def submit_sql(self, query: str, tenant: str = "default",
                   priority: int = 0) -> str:
        """Submit a SQL query over the daemon's registered catalog.

        The query compiles AT SUBMISSION TIME (parse -> bind -> lower
        -> plan -> pre-submit lint/cost gate), so a malformed query is
        a typed :class:`~dryad_tpu_torch.sql.SqlError` rejection (DTA3xx,
        line:column spans, HTTP 400) with ZERO work started and zero
        failure-budget charge — exactly like the app surfaces.  The
        lowered plan rides the shared FileCache keyed on the SEMANTIC
        fingerprint of the bound statement (analysis/canon.py — plus
        catalog fingerprint, nparts, config, version): any query that
        canonicalizes to the same plan — reordered predicates,
        different aliases, shuffled SELECT list, from ANY tenant —
        skips lower/plan/serialize entirely (only parse + bind +
        canonicalization run), and its tables come from the scan
        registry already loaded.  A hit is surfaced as a DTA501
        ``reuse_verdict`` event and the ``plan_reuse`` counter."""
        from dryad_tpu_torch import sql as _sql
        from dryad_tpu_torch.obs.latency import PhaseClock
        clock = PhaseClock()             # submit-entry instant
        self._check_names("sql", tenant)
        if self._stopping:
            raise ServiceStoppedError()
        self.admission.precheck(tenant)
        clock.mark("precheck")
        norm = _sql.normalize_query(query)
        # ONE compile (parse -> bind, DTA3xx typed rejections included)
        # per submission: the standing-query gate, the semantic
        # fingerprint, and the cold-path lowering all reuse it
        _mode, bound = _sql.compile_query(self.catalog, query)
        if bound.emit_every is not None:
            # continuous queries: an EMIT EVERY clause registers a
            # standing query instead of running once
            if self.standing is None:
                raise MalformedJobError("sql", ValueError(
                    "standing queries (EMIT EVERY) need the "
                    "in-process fleet"))
            return self.standing.register(query, norm, bound,
                                          tenant=tenant,
                                          priority=priority)
        # one fingerprint pair per submission (they content-hash inline
        # tables): the cache key and both event records share them
        fp = self.catalog.fingerprint()
        from dryad_tpu_torch.analysis.canon import semantic_fingerprint
        semfp = semantic_fingerprint(self.catalog, bound)
        clock.mark("bind")               # parse + bind + fingerprints
        try:
            if self.cluster is not None:
                payload, limit, cached = \
                    self._build_sql_farm_payload(bound, semfp, fp)
            else:
                run_local, cached = \
                    self._build_sql_local_runner(bound, semfp, fp)
        except _sql.SchemaOnlyTableError as e:
            # querying a schema-only (EXPLAIN-only) table is a client
            # mistake — the documented DTA910 / HTTP 400, never a 500
            raise MalformedJobError("sql", e)
        # a DTA501 hit spent the builder on cache probe + plan rebuild;
        # a miss spent it on lower/plan/serialize — attribute the whole
        # builder wall to whichever actually dominated it
        clock.mark("cache_lookup" if cached else "bind")
        if self.cluster is not None:
            job = self._new_job("sql", tenant, priority, 1,
                                params={"sql": norm}, payload=payload,
                                combine=_sql_combine(limit), clock=clock)
        else:
            job = self._new_job("sql", tenant, priority, 1,
                                params={"sql": norm}, run_local=run_local,
                                clock=clock)
        job.event({"event": "sql_query", "query": norm, "catalog": fp,
                   "semantic": semfp, "cached_plan": cached})
        self.log({"event": "sql_query", "job": job.id, "tenant": tenant,
                  "query": norm, "catalog": fp, "semantic": semfp,
                  "cached_plan": cached})
        if cached:
            verdict = (f"DTA501: equivalent to cached plan {semfp}, "
                       f"zero compile")
            job.event({"event": "reuse_verdict", "code": "DTA501",
                       "fingerprint": semfp, "message": verdict})
            self.log({"event": "reuse_verdict", "job": job.id,
                      "tenant": tenant, "code": "DTA501",
                      "fingerprint": semfp})
            family_counter(REGISTRY, "plan_reuse", tenant=tenant).inc()
        return self._admit(job, kind="sql")

    def explain_sql(self, query: str) -> str:
        """EXPLAIN a query against the service catalog WITHOUT running
        it: the offline plan text plus the semantic-reuse verdict —
        whether this query would hit the fingerprint-keyed plan cache
        (``DTA501 ... zero compile``) on submission."""
        from dryad_tpu_torch import sql as _sql
        from dryad_tpu_torch.analysis.canon import semantic_fingerprint
        _mode, bound = _sql.compile_query(self.catalog, query)
        out = _sql.offline_explain(self.catalog, query,
                                   nparts=self.nparts)
        semfp = semantic_fingerprint(self.catalog, bound)
        key = self._sql_cache_key(semfp, self.catalog.fingerprint())
        if self.plan_cache.get(key) is not None:
            out += (f"\nreuse: DTA501 equivalent to cached plan "
                    f"{semfp}, zero compile\n")
        else:
            out += (f"\nreuse: no cached equivalent (semantic "
                    f"fingerprint {semfp})\n")
        return out

    def _sql_cache_key(self, semfp: str, fp: str) -> str:
        """The plan cache's key: the semantic and catalog fingerprints,
        the partitions, the base JobConfig (planning reads it) and the
        package version, which changes with the port's code, so a
        restarted daemon never serves a plan lowered by other code."""
        return json.dumps(
            {"semantic": semfp, "catalog": fp,
             "nparts": self.nparts, "config": repr(self.job_config),
             "ver": _pkg_version()},
            sort_keys=True)

    def _load_table(self, name: str):
        """PData for one catalog table, shared across jobs: the scan
        registry keys on (table, content fingerprint), so queued or
        concurrent jobs whose canonical scan prefixes read the same
        source content pay exactly ONE cold scan — the first loader
        emits an io span into the service log, every subsequent user
        records ``scan_shared`` and bumps the counter."""
        from dryad_tpu_torch.obs import trace
        from dryad_tpu_torch.sql.catalog import table_fingerprint
        t = self.catalog.get(name)
        key = (name, table_fingerprint(t) if t is not None else "?")
        with self._scan_lock:
            ent = self._scan_cache.get(key)
            if ent is None:
                ent = {"lock": threading.Lock(), "pdata": None}
                # content-addressed: a re-registration of ``name`` with
                # different content gets a new key — drop the stale one
                for k in [k for k in self._scan_cache
                          if k[0] == name and k != key]:
                    del self._scan_cache[k]
                self._scan_cache[key] = ent
                while len(self._scan_cache) > self._scan_cap:
                    self._scan_cache.popitem(last=False)
            else:
                self._scan_cache.move_to_end(key)
        with ent["lock"]:
            if ent["pdata"] is None:
                sp = trace.start(f"scan {name}", "io", sink=self.log,
                                 table=name)
                ent["pdata"] = self.catalog.load_pdata(
                    self.mesh, name, self.job_config)
                trace.finish(sp)
            else:
                self.log({"event": "scan_shared", "table": name,
                          "fingerprint": key[1]})
                family_counter(REGISTRY, "scan_shared",
                               table=name).inc()
        return ent["pdata"]

    def _cluster_context(self):
        """A cluster Context for lowering and planning a fleet job: ONE
        task runs on ONE worker's partitions, so its sources and plan
        are sized to the cluster's ``devices_per_process``, not to a
        cluster Context's ``nparts`` (the gang's).  It lowers and plans
        only: it never submits."""
        import types

        from dryad_tpu_torch.api.dataset import Context
        dpp = self.cluster.devices_per_process
        one_worker = types.SimpleNamespace(
            n_processes=1, devices_per_process=dpp, nparts=dpp)
        return Context(cluster=one_worker, config=self.job_config,
                       install_trace=False)

    def _build_sql_farm_payload(self, bound, semfp: str, fp: str):
        """(payload, limit, cache_hit) for the cluster fleet.  The
        FileCache entry holds the SERIALIZED plan plus its deferred
        source specs verbatim — a warm submission does zero compile work
        of any kind on the daemon."""
        import pickle

        from dryad_tpu_torch import sql as _sql
        key = self._sql_cache_key(semfp, fp)
        cached = self.plan_cache.get(key)
        if cached is not None:
            # pickled, not JSON: inline-table source specs carry numpy
            # columns.  The cache dir is daemon-owned state (the job
            # dirs' trust domain) and FileCache's magic + sha256 header
            # already turns a torn or corrupt entry into a miss
            meta = pickle.loads(cached)
            return ({"plan": meta["plan"], "sources": [meta["sources"]]},
                    meta["limit"], True)
        from dryad_tpu_torch.plan.planner import plan_query
        from dryad_tpu_torch.runtime.shiplan import serialize_for_cluster
        ctx = self._cluster_context()
        ds, _handles = _sql.lower(ctx, self.catalog, bound)
        graph = plan_query(ds.node, self.nparts, hosts=1,
                           config=self.job_config)
        ctx._pre_submit_lint(ds.node, cluster=True, graph=graph)
        plan_json, specs = serialize_for_cluster(graph, ctx.fn_table)
        try:
            self.plan_cache.put(key, pickle.dumps(
                {"plan": plan_json, "sources": specs,
                 "limit": bound.limit}))
        except (pickle.PicklingError, TypeError, AttributeError):
            pass     # an unpicklable source spec just skips the cache
        return ({"plan": plan_json, "sources": [specs]}, bound.limit,
                False)

    def _build_sql_local_runner(self, bound, semfp: str, fp: str):
        """(run_local, cache_hit) for the in-process fleet.  A cache
        hit rebuilds the StageGraph from the stored plan JSON
        (row-expression callables self-decode via the shippable-value
        protocol) and re-binds only the source slots — through the
        shared scan registry (:meth:`_load_table`), so concurrent hits
        over one table pay one load — with zero lower/plan work.  An
        entry that no longer rebuilds (a table gone, a ref that no longer
        resolves) is recompiled like a miss."""
        from dryad_tpu_torch import sql as _sql
        key = self._sql_cache_key(semfp, fp)
        cached = self.plan_cache.get(key)
        graph = cost_rep = None
        limit = None
        hit = False
        if cached is not None:
            from dryad_tpu_torch.plan.serialize import graph_from_json
            from dryad_tpu_torch.runtime.shiplan import (PlanShipError,
                                                         resolve_fn_table)
            meta = json.loads(cached.decode())
            try:
                src = {slot: self._load_table(tname)
                       for slot, tname in meta["tables"].items()}
                graph = graph_from_json(
                    meta["plan"], fn_table=resolve_fn_table(meta["plan"]),
                    sources=src)
                limit = meta["limit"]
                hit = True
            except (KeyError, ValueError, TypeError, AttributeError,
                    ImportError, PlanShipError):
                graph = None        # stale entry -> recompile below
        if graph is None:
            from dryad_tpu_torch.plan.planner import plan_query
            ctx = self._context()
            ds, handles = _sql.lower(ctx, self.catalog, bound,
                                     loader=self._load_table)
            graph = plan_query(ds.node, ctx.nparts, hosts=ctx.hosts,
                               levels=ctx.levels, config=self.job_config)
            cost_rep = ctx._pre_submit_lint(ds.node, cluster=False,
                                            graph=graph)
            limit = bound.limit
            self._sql_cache_put(key, graph, handles, limit)

        def run_local(service, job, _graph=graph, _cost=cost_rep,
                      _limit=limit):
            from dryad_tpu_torch.exec.data import (
                maybe_shrink_for_collect, pdata_to_host)
            pd = service.executor.run(_graph, cost_report=_cost,
                                      event_log=job, job=job.id,
                                      **service._durable_run_kw(job))
            table = pdata_to_host(
                maybe_shrink_for_collect(pd, config=job.config))
            return _sql_combine(_limit)([table])

        return run_local, hit

    def _sql_cache_put(self, key: str, graph, handles: Dict[int, str],
                       limit) -> None:
        """Best-effort FileCache write for the in-process path: the
        plan JSON plus a source-slot -> table-name map for warm
        rebinding.  Skipped (never fatal) when a slot's table is
        unknown or an op param can't serialize."""
        from dryad_tpu_torch import sql as _sql
        from dryad_tpu_torch.plan.serialize import graph_to_json
        from dryad_tpu_torch.runtime.shiplan import (PlanShipError,
                                                     _collect_refs)
        tables = _sql.source_tables(graph, handles)
        if any(t is None for t in tables.values()):
            return
        try:
            plan_json = graph_to_json(graph, _collect_refs(graph, {}))
            self.plan_cache.put(key, json.dumps(
                {"plan": plan_json, "tables": tables,
                 "limit": limit}).encode())
        except (PlanShipError, TypeError):
            pass

    # -- payload building --------------------------------------------------

    def _plan_cache_key(self, app: str, params: dict) -> str:
        """Restart-persistent plan-cache key of an app's farm plan: the
        base JobConfig (planning reads it) and the package version salt
        it, so a restarted daemon with other config or code never ships
        an old lowering."""
        return json.dumps(
            {"app": app, "nparts": self.nparts, "params": params,
             "config": repr(self.job_config), "ver": _pkg_version()},
            sort_keys=True, default=str)

    def _build_farm_payload(self, service_app, params: dict) -> dict:
        """(plan, per-task sources) for the cluster fleet.  The
        serialized plan is memoized in the shared FileCache keyed by
        (app, nparts, params, config, version): the Nth same-shaped
        submission — across daemon restarts too — pays zero planning
        (the workers' persistent executors keep their caches).  A miss
        runs the pre-submit lint/cost gate (JobConfig.lint) like every
        other submission surface.  Each task's columns ride its source
        spec; the worker packs them (``runtime/sources.build_source``)."""
        from dryad_tpu_torch.runtime.sources import columns_spec
        tasks = service_app.make_tasks(params, self.nparts)
        cap = task_capacity(tasks, self.nparts)
        key = self._plan_cache_key(service_app.name, params)
        cached = self.plan_cache.get(key)
        if cached is not None:
            meta = json.loads(cached.decode())
            plan_json, src_key = meta["plan"], meta["src_key"]
        else:
            from dryad_tpu_torch.plan.planner import plan_query
            from dryad_tpu_torch.runtime.shiplan import \
                serialize_for_cluster
            ctx = self._cluster_context()
            q = service_app.build_query(ctx, tasks[0], params,
                                        capacity=cap)
            graph = plan_query(q.node, self.nparts, hosts=1,
                               config=self.job_config)
            ctx._pre_submit_lint(q.node, cluster=True, graph=graph)
            plan_json, specs = serialize_for_cluster(graph, ctx.fn_table)
            (src_key,) = specs.keys()
            self.plan_cache.put(key, json.dumps(
                {"plan": plan_json, "src_key": src_key}).encode())
        sources = [{src_key: columns_spec(
            t, self.nparts, capacity=cap,
            str_max_len=service_app.str_max_len)} for t in tasks]
        return {"plan": plan_json, "sources": sources}

    def _build_local_runner(self, service_app, params: dict,
                            tasks: List[dict]) -> Callable:
        """In-process driver: the whole job is ONE admission unit run on
        a fleet thread against the SHARED executor with per-job driver
        state (event sink + job tag + failure budget on the Run).

        Query building, planning, and the pre-submit lint/cost gate all
        run HERE — at submission time, on the caller's thread — so a
        statically rejected plan is a typed rejection from submit()
        with zero work started and zero failure-budget charge."""
        from dryad_tpu_torch.plan.planner import plan_query
        cols = {k: [x for t in tasks for x in t[k]] for k in tasks[0]}
        ctx = self._context()
        q = service_app.build_query(ctx, cols, params)
        graph = plan_query(q.node, ctx.nparts, hosts=ctx.hosts,
                           levels=ctx.levels, config=self.job_config)
        cost_rep = ctx._pre_submit_lint(q.node, cluster=False,
                                        graph=graph)

        def run_local(service, job):
            from dryad_tpu_torch.exec.data import (
                maybe_shrink_for_collect, pdata_to_host)
            # the job ITSELF is the sink (sink protocol: __call__ +
            # .level) — a bound method would hide the log's level from
            # span gating and add a redundant copy per event
            pd = service.executor.run(graph, cost_report=cost_rep,
                                      event_log=job, job=job.id,
                                      **service._durable_run_kw(job))
            table = pdata_to_host(
                maybe_shrink_for_collect(pd, config=job.config))
            return service_app.combine([table])

        return run_local

    # -- job control -------------------------------------------------------

    def job(self, job_id: str) -> ServiceJob:
        """Resolve a job OR standing-query id: standing entries are
        job-shaped (inc/standing.py), so every read surface — status,
        long-poll events, the SSE stream — serves both through here."""
        with self._jobs_lock:
            j = self.jobs.get(job_id)
        if j is not None:
            return j
        if self.standing is not None:
            sq = self.standing.get(job_id)
            if sq is not None:
                return sq
        raise KeyError(f"unknown job {job_id!r}")

    def status(self, job_id: str, with_result: bool = False) -> dict:
        """Status row for a live job, a standing query, or a job that
        went terminal before a daemon restart (the recovery pass
        indexed those from the journal + persisted job dirs — 404 only
        for ids this service dir has never seen)."""
        try:
            return self.job(job_id).to_row(with_result=with_result)
        except KeyError:
            row = self._archive.get(job_id)
            if row is not None:
                return dict(row)
            raise

    def result(self, job_id: str):
        return self.job(job_id).result

    def wait(self, job_id: str, timeout: Optional[float] = None) -> dict:
        try:
            job = self.job(job_id)
        except KeyError:
            # terminal before a restart: already settled, nothing to
            # wait for — serve the archived row (result not retained)
            row = self._archive.get(job_id)
            if row is not None:
                return dict(row)
            raise
        job.wait(timeout)
        return job.to_row(with_result=True)

    def cancel(self, job_id: str) -> bool:
        # a standing id unregisters the continuous query (its persisted
        # registration goes away too — restart will not resume it)
        if self.standing is not None \
                and self.standing.get(job_id) is not None:
            return self.standing.cancel(job_id)
        job = self.job(job_id)
        ok = job.cancel()
        if ok:
            self.admission.retire(job)
            self.log({"event": "job_cancelled", "job": job.id,
                      "tenant": job.tenant})
            family_gauge(REGISTRY, "queue_depth", job=job.id).set(0)
        return ok

    def list_jobs(self) -> List[dict]:
        with self._jobs_lock:
            rows = [j.to_row() for j in self.jobs.values()]
            live = {r["job"] for r in rows}
        # pre-restart terminal jobs (recovery's archive index): listed
        # after the live table, marked {"archived": true}
        rows.extend(dict(r) for jid, r in self._archive.items()
                    if jid not in live)
        return rows

    def standing_rows(self) -> List[dict]:
        """Status rows of every registered standing query
        (``GET /standing``); empty on the cluster fleet."""
        return self.standing.rows() if self.standing is not None else []

    # -- durability (service/durable) --------------------------------------

    def _durable_run_kw(self, job: ServiceJob) -> dict:
        """Per-run durability hooks for in-process query jobs: the
        handoff pause event always (it costs one Event check per stage
        boundary); spill + driver checkpoint only with
        ``durable_spill`` (resume-from-lineage needs every stage's
        output on disk)."""
        kw = {"pause": job.pause}
        if self.config.durable_spill:
            from dryad_tpu_torch.service.durable import JobCheckpoint
            kw["spill_dir"] = os.path.join(job.dir, "spill")
            kw["checkpoint"] = JobCheckpoint(
                os.path.join(job.dir, "checkpoint.json"), job=job.id)
        return kw

    def _restore_job(self, spec: dict, n_tasks: int, run_local=None,
                     payload=None, combine=None,
                     admit: bool = True) -> ServiceJob:
        """Recovery: rebuild one journaled job under its ORIGINAL id
        and seq (fair-share order preserved) and re-admit it past the
        quota walls it already passed once.  ``admit=False`` builds the
        job without queueing it (the fail-with-forensics path)."""
        job = ServiceJob(spec["id"], spec["tenant"], spec["app"],
                         int(spec.get("seq", 0)),
                         int(spec.get("priority", 0)), n_tasks,
                         os.path.join(self.jobs_dir, spec["id"]),
                         self.job_config, history_dir=self.history_dir,
                         params=dict(spec.get("params") or {}),
                         run_local=run_local, payload=payload,
                         combine=combine)
        job.journal = self.journal
        with self._jobs_lock:
            self.jobs[job.id] = job
        if admit:
            self.admission.submit(job, force=True)
            if self.journal is not None:
                self.journal.job_queued(job.id, job.seq)
            self._fleet.wake()
        return job

    def handoff(self) -> dict:
        """Rolling upgrade, outgoing-daemon side: stop admitting
        (DTA913), pause running in-process jobs at their next
        checkpointed stage boundary, stop the fleet, and mark the
        journal ready for adoption.  Jobs are NOT failed — the
        successor daemon opening the same service dir adopts the
        journal and resumes/readmits them (stale lowerings are
        impossible: the plan-cache key salts in config + package
        version).  Returns a summary for the operator."""
        if self._stopping:
            return {"paused": 0, "queued": 0, "already_stopped": True}
        self._stopping = True
        self.log({"event": "handoff_started", "ver": _pkg_version()})
        if self.standing is not None:
            self.standing.stop()
        paused = queued = 0
        with self._jobs_lock:
            jobs = list(self.jobs.values())
        for j in jobs:
            if j.state == "running":
                j.pause.set()
                paused += 1
            elif j.state == "queued":
                queued += 1
        self._fleet.stop()
        if self.journal is not None:
            self.journal.handoff_ready()
            # NOT a clean close: the successor must see live state to
            # adopt, and the journal keeps the epoch open on purpose
            self.journal.close(clean=False)
        self.log({"event": "handoff_ready", "paused": paused,
                  "queued": queued})
        self.log.close()
        return {"paused": paused, "queued": queued,
                "journal": (self.journal.dir
                            if self.journal is not None else None)}

    def crash(self) -> None:
        """TEST/BENCH hook: die the way SIGKILL would — no terminal
        journaling, no clean journal close, no job teardown, the LOCK
        file left in place.  In-memory job objects wind down (threads
        must not leak into the test process) but nothing they do past
        this point reaches the journal, exactly like a killed daemon."""
        self._stopping = True
        if self.journal is not None:
            self.journal.close(clean=False, release_lock=False)
        if self.standing is not None:
            self.standing.stop()
        for j in list(self.jobs.values()):
            j.pause.set()        # stop in-flight runs at a boundary
        # joined to completion: a successor daemon in the SAME process
        # must not compute a job alongside a wound-down fleet thread
        self._fleet.stop(timeout=None)
        self.log.close()

    # -- per-tenant SLOs (obs/slo.py) --------------------------------------

    def _job_terminal(self, job: ServiceJob) -> None:
        """Fold one terminal job into its tenant's rolling SLO window,
        refresh the live gauges, and emit ``slo_breach`` on the
        transition into burn > 1.  Cancellations are neither good nor
        bad (the tenant asked for them); tenants without a declared SLO
        record nothing — at any logging level this path builds zero
        events unless a breach actually transitions."""
        if job.state == "cancelled":
            return
        # fold the settled phase waterfall (job.finish() built it before
        # closing the log) into the live tail-latency tracker — SLO-less
        # tenants still get percentiles + p99 attribution
        if job.waterfall is not None:
            self.latency.record(job.waterfall)
        wall = ((job.finished_ts - (job.started_ts or job.submitted_ts))
                if job.finished_ts else None)
        with self._slo_lock:
            row = self.slo.record(job.tenant, job.state == "done", wall)
            if row is None:
                return
            family_gauge(REGISTRY, "slo_attainment",
                         tenant=job.tenant).set(row["attainment"])
            family_gauge(REGISTRY, "slo_burn",
                         tenant=job.tenant).set(row["burn_rate"])
            if row["breaching"]:
                if job.tenant not in self._slo_breaching:
                    self._slo_breaching.add(job.tenant)
                    self.log({"event": "slo_breach",
                              "tenant": job.tenant,
                              "attainment": row["attainment"],
                              "burn_rate": row["burn_rate"],
                              "target": row["target"],
                              "latency_s": row["latency_s"],
                              "window": row["window"],
                              "jobs": row["jobs"]})
            else:
                self._slo_breaching.discard(job.tenant)

    def slo_snapshot(self) -> Dict[str, dict]:
        """{tenant: attainment/burn row} for every SLO-declaring tenant
        that has recorded terminal jobs (``GET /slo``)."""
        return self.slo.snapshot()

    def latency_snapshot(self) -> Dict[str, dict]:
        """{tenant: p50/p95/p99 + dominant-phase breakdown + slowest-
        request exemplar} from the live tracker (``GET /latency``)."""
        return self.latency.snapshot()

    # -- dashboard / metrics -----------------------------------------------

    def metrics_text(self) -> str:
        return REGISTRY.render()

    def dashboard_html(self) -> str:
        """The live multi-job dashboard: the obs/history index page
        (archived runs + deltas) promoted with the daemon's running-jobs
        and tenant-shares tables on top."""
        import html as _html

        from dryad_tpu_torch.obs.history import history_index, index_html
        rows = []
        for r in reversed(self.list_jobs()):
            pct = float(r.get("progress_pct") or 0.0)
            bar = (
                f'<td><div style="background: var(--grid); '
                f'width: 120px; height: 10px; border-radius: 4px">'
                f'<div style="background: var(--series); height: 10px; '
                f'border-radius: 4px; width: {pct:.1f}%"></div></div>'
                f'<span style="font-size: 11px; color: var(--ink2)">'
                f'{pct:.0f}%</span></td>')
            rows.append(
                f"<tr><td>{_html.escape(r['job'])}</td>"
                f"<td>{_html.escape(r['tenant'])}</td>"
                f"<td>{_html.escape(r['app'])}</td>"
                f"<td>{_html.escape(r['state'])}</td>"
                f"{bar}"
                f"<td>{r['tasks_done']}/{r['tasks']}</td>"
                f"<td>{r['wall_s'] if r['wall_s'] is not None else '—'}"
                f"</td></tr>")
        shares = self.admission.shares()
        slo = self.slo_snapshot()
        lat = self.latency_snapshot()
        srows = []
        for t, v in sorted(shares.items()):
            lt = lat.get(t)
            if lt is None:
                lcol = "<td>—</td><td>—</td><td>—</td>"
            else:
                ex = lt.get("exemplar") or {}
                dom = lt.get("dominant") or "—"
                if ex.get("job"):
                    dom = (f'<a href="/events/{_html.escape(str(ex["job"]))}"'
                           f' title="slowest: {_html.escape(str(ex["job"]))}'
                           f' ({ex.get("wall_s")}s)">'
                           f"{_html.escape(dom)}</a>")
                lcol = (f"<td>{lt['p50_s']:.3f}</td>"
                        f"<td>{lt['p99_s']:.3f}</td>"
                        f"<td>{dom}</td>")
            s = slo.get(t)
            if s is None:
                scol = "<td>—</td><td>—</td><td>—</td>"
            else:
                bcls = "critical" if s["breaching"] else "ink2"
                scol = (
                    f"<td>{s['target']:.2f}"
                    + (f" / {s['latency_s']:g}s" if s["latency_s"]
                       else "")
                    + f"</td><td>{s['attainment']:.3f}</td>"
                    f'<td style="color: var(--{bcls})">'
                    f"{s['burn_rate']:.2f}"
                    + (" &#9888;" if s["breaching"] else "")
                    + "</td>")
            srows.append(
                f"<tr><td>{_html.escape(t)}</td><td>{v[0]:.3f}</td>"
                f"<td>{v[1]}</td><td>{v[2]}</td>{scol}{lcol}</tr>")
        qrows = []
        for r in self.standing_rows():
            qrows.append(
                f"<tr><td>{_html.escape(r['job'])}</td>"
                f"<td>{_html.escape(r['tenant'])}</td>"
                f"<td>{_html.escape(r['state'])}</td>"
                f"<td>{r['emit_every']:g}s</td>"
                f"<td>{r['refreshes']}</td>"
                f"<td>{_html.escape(r['mode'] or '—')}</td>"
                f"<td>{r['rows']}</td>"
                f"<td><code>{_html.escape(r['query'])}</code></td></tr>")
        standing_tbl = (
            "<h2>standing queries</h2><table><tr><th>id</th>"
            "<th>tenant</th><th>state</th><th>every</th>"
            "<th>refreshes</th><th>last&nbsp;mode</th><th>rows</th>"
            "<th>query</th></tr>" + "".join(qrows) + "</table>"
            if qrows else "")
        extra = (
            "<h2>jobs</h2><table><tr><th>job</th><th>tenant</th>"
            "<th>app</th><th>state</th><th>progress</th><th>tasks</th>"
            "<th>wall&nbsp;s</th></tr>" + "".join(rows) + "</table>"
            + standing_tbl +
            "<h2>tenants</h2><table><tr><th>tenant</th>"
            "<th>slot&nbsp;s</th><th>running</th><th>failures</th>"
            "<th>SLO</th><th>attainment</th><th>burn</th>"
            "<th>p50&nbsp;s</th><th>p99&nbsp;s</th><th>p99&nbsp;phase</th>"
            "</tr>"
            + "".join(srows) + "</table><h2>history</h2>")
        return index_html(history_index(self.history_dir),
                          title="dryad job service", extra_html=extra)

    # -- lifecycle ---------------------------------------------------------

    def close(self, cancel_pending: bool = True) -> None:
        """Stop admitting (DTA913), optionally cancel queued jobs, stop
        the fleet, and close the service log."""
        if self._stopping:
            return
        self._stopping = True
        # wind the standing scheduler down FIRST so no new refresh jobs
        # race the closing fleet (registrations stay on disk — the next
        # daemon resumes them from their committed watermarks)
        if self.standing is not None:
            self.standing.stop()
        if cancel_pending:
            for job in self.list_jobs():
                j = self.jobs.get(job["job"])
                if j is not None and j.state == "queued":
                    self.cancel(j.id)
        self._fleet.stop()
        # the fleet is gone: any job still non-terminal (in flight when
        # the daemon stopped) can never finish — fail it NOW so waiters
        # release and its log closes/archives instead of hanging forever
        for row in self.list_jobs():
            j = self.jobs.get(row["job"])
            if j is not None and j.state in ("queued", "running"):
                j.pending.clear()
                j.finish(False, error="service stopped with the job "
                                      "in flight")
                self.admission.retire(j)
                self._job_terminal(j)
        # clean close LAST: every terminal transition above journaled
        # first, so a restart over this dir recovers nothing live
        if self.journal is not None:
            self.journal.close(clean=True)
        self.log({"event": "service_stopped"})
        self.log.close()
        if self._own_cluster and self.cluster is not None:
            self.cluster.shutdown()

    def __enter__(self) -> "JobService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _sql_combine(limit):
    """Combine for SQL jobs: one task's host table -> JSON-able rows
    (bytes decode utf-8, numpy scalars to Python), trimmed to LIMIT
    (the executor returns all valid rows; Dataset.collect's trim
    happens here for service jobs)."""

    def combine(tables):
        table = next((t for t in tables if t), {}) or {}
        out = {}
        n = None
        for k, v in table.items():
            vals = list(v if limit is None else v[:limit])
            out[k] = [x.decode("utf-8", "replace")
                      if isinstance(x, (bytes, bytearray))
                      else (x.item() if hasattr(x, "item") else x)
                      for x in vals]
            n = len(out[k])
        return {"table": out, "rows": n or 0}

    return combine


# -- fleets ------------------------------------------------------------------


class _LocalFleet:
    """In-process fleet: ``slots`` driver threads pulling admission
    units; each unit is a whole job's driver run on the shared
    executor."""

    def __init__(self, service: JobService, slots: int):
        self.service = service
        self.slots = max(1, slots)
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

    def start(self) -> None:
        for i in range(self.slots):
            t = threading.Thread(target=self._worker, name=f"fleet-{i}",
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def wake(self) -> None:
        pass          # workers poll the admission queue's condition

    def stop(self, timeout: Optional[float] = 10) -> None:
        """``timeout=None`` joins to completion — crash() needs the
        worker threads fully wound down before a successor daemon can
        start in the SAME process (two fleets computing the same job
        concurrently is an in-process artifact no real SIGKILL has)."""
        self._stop.set()
        for t in self._threads:
            while t.is_alive():
                t.join(timeout=10 if timeout is None else timeout)
                if timeout is not None:
                    break

    def _worker(self) -> None:
        from dryad_tpu_torch.exec.recovery import HandoffPause
        svc = self.service
        while not self._stop.is_set():
            unit = svc.admission.next_unit(wait=0.2)
            if unit is None:
                continue
            job, idx = unit
            # snapshot the runner FIRST: a cancel() racing this check
            # releases job.run_local (terminal jobs drop their inputs),
            # and calling through a stale None would charge the tenant's
            # failure budget for a cancellation
            fn = job.run_local
            if job.state == "cancelled" or fn is None:
                svc.admission.on_done(job, idx, 0.0)
                svc.admission.retire(job)
                continue
            job.mark_started()
            family_gauge(REGISTRY, "queue_depth",
                         job=job.id).set(len(job.pending))
            job.mark_phase("dispatch")   # pick -> this thread's hands
            t0 = _now()
            ok, err = True, None
            try:
                res = fn(svc, job)
            except HandoffPause as hp:
                # rolling upgrade: the run stopped AT a stage boundary
                # with its settled work spilled + checkpointed.  Charge
                # the measured wall (fair-share currency), leave the
                # job RUNNING and un-retired — the successor daemon
                # adopts it from the journal and resumes from spill.
                wall = _now() - t0
                svc.admission.on_done(job, idx, wall, ok=True)
                ev = {"event": "handoff_paused", "stage": hp.stage,
                      "wall_s": round(wall, 4)}
                job.event(dict(ev))
                svc.log(dict(ev, job=job.id, tenant=job.tenant))
                continue
            except Exception:
                ok, err = False, traceback.format_exc()
            wall = _now() - t0
            job.mark_phase("run")
            svc.admission.on_done(job, idx, wall, ok=ok)
            svc.admission.retire(job)
            family_histogram(REGISTRY, "task_seconds",
                             job=job.id).observe(wall)
            family_gauge(REGISTRY, "queue_depth", job=job.id).set(0)
            if ok:
                # the per-job Run already emitted job_done for query
                # jobs; only bare callables need the service to emit it
                saw = any(e.get("event") == "job_done"
                          for e in job.log.events)
                job.result = res
                job.finish(True, emit_job_done=not saw)
            else:
                job.finish(False, error=err)
            # count by the ACTUAL terminal state: a job cancelled while
            # its run was executing must not land in the completed (or
            # failed) tally, and keeps no result
            if job.state == "done":
                family_counter(REGISTRY, "jobs", job=job.id).inc()
            elif job.state == "failed":
                family_counter(REGISTRY, "jobs_failed",
                               job=job.id).inc()
            else:
                job.result = None
            svc._job_terminal(job)


class _ClusterFleet:
    """Cluster fleet: ONE dispatch loop multiplexing tasks from many
    concurrent jobs over the shared worker processes (the multi-job
    extension of runtime/farm.TaskFarm's single-run loop).  Frames route back to
    their job by the envelope's ``protocol.JOB_ID`` tag; a worker loss
    costs only its in-flight tasks (reassigned through the admission
    queue, fair-share preserved); a task failure fails only ITS job —
    forensics land under that job's directory and every other job keeps
    running."""

    def __init__(self, service: JobService):
        self.service = service
        self.cl = service.cluster
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._inflight: Dict[int, tuple] = {}      # pid -> (job, idx, t0)
        self._idle: set = set()
        self._ping_t: Dict[int, float] = {}
        self._dead: set = set()

    def wake(self) -> None:
        pass                      # the loop polls at 100ms

    def start(self) -> None:
        from dryad_tpu_torch.runtime import protocol
        job = self.cl.next_job_id()
        for pid, sock in list(self.cl.sockets.items()):
            try:
                sock.setblocking(True)
                protocol.send_msg(sock, {"cmd": "ping", "job": job})
                sock.setblocking(False)
                self._ping_t[pid] = _now()
            except OSError:
                self._dead.add(pid)
        self._thread = threading.Thread(target=self._loop,
                                        name="fleet-cluster", daemon=True)
        self._thread.start()

    def stop(self, timeout: Optional[float] = 15) -> None:
        """``timeout=None`` joins to completion (``crash()``)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    # -- dispatch ----------------------------------------------------------

    def _wire_of(self, job: ServiceJob) -> int:
        """The job's wire id (the ``protocol.JOB_ID`` tag on its task
        envelopes).  Reply routing goes through the per-worker in-flight
        record — which holds the ServiceJob itself — so no wire-id→job
        map needs to exist (or be pruned) daemon-side."""
        w = getattr(job, "_wire", None)
        if w is None:
            w = self.cl.next_job_id()
            job._wire = w
        return w

    def _dispatch(self, job: ServiceJob, idx: int, pid: int) -> bool:
        from dryad_tpu_torch.obs import trace
        from dryad_tpu_torch.runtime import protocol
        wire = self._wire_of(job)
        job.mark_started()
        sp = getattr(job, "_span", None)
        if sp is None and job.log.level >= 2:
            sp = trace.start(f"job {job.id}", "farm", sink=job,
                             job=job.id, tasks=job.n_tasks)
            job._span = sp
        sock = self.cl.sockets[pid]
        msg = protocol.attach_trace(
            protocol.attach_job(
                {"cmd": "run_task", "plan": job.payload["plan"],
                 "sources": job.payload["sources"][idx], "task": idx,
                 "config": job.config}, wire),
            trace.ctx_of(sp) if sp is not None else None)
        try:
            sock.setblocking(True)
            protocol.send_msg(sock, msg)
            sock.setblocking(False)
        except OSError:
            self._worker_lost(pid)
            return False
        self._inflight[pid] = (job, idx, _now())
        self._idle.discard(pid)
        job.mark_phase("dispatch")   # first send only (mark_once):
        # later tasks' sends land inside the run segment, not carved out
        family_gauge(REGISTRY, "queue_depth",
                     job=job.id).set(len(job.pending))
        return True

    def _worker_lost(self, pid: int) -> None:
        self._dead.add(pid)
        self._idle.discard(pid)
        self._ping_t.pop(pid, None)
        unit = self._inflight.pop(pid, None)
        if unit is not None:
            job, idx, _t0 = unit
            if job.state == "running":
                job.event({"event": "task_reassigned", "task": idx,
                           "worker": pid})
                self.service.admission.requeue(job, idx)
            else:
                self.service.admission.on_done(job, idx, 0.0)

    def _fail_job(self, job: ServiceJob, idx: int, pid: int,
                  reply: dict, wall: float) -> None:
        from dryad_tpu_torch.obs import flight
        bpath = None
        try:
            bpath = flight.persist_reply_forensics(
                reply, job.config, job.log, job.event)
        except Exception:
            pass
        err = str(reply.get("error") or "task failed")
        if bpath:
            err += (f"\nforensics bundle: {bpath}\n  reproduce locally: "
                    f"python -m dryad_tpu_torch.obs replay {bpath}")
        self.service.admission.on_done(job, idx, wall, ok=False)
        job.pending.clear()
        job.mark_phase("run")
        job.finish(False, error=f"task {idx} failed on worker {pid}:\n"
                                + err)
        self.service.admission.retire(job)
        family_counter(REGISTRY, "jobs_failed", job=job.id).inc()
        family_gauge(REGISTRY, "queue_depth", job=job.id).set(0)
        self.service._job_terminal(job)

    def _on_reply(self, pid: int, reply: dict) -> None:
        from dryad_tpu_torch.obs import trace
        from dryad_tpu_torch.runtime import protocol
        if "pong" in reply:
            self._ping_t.pop(pid, None)
            # a stale pong (buffered from a pre-daemon epoch of a
            # reused cluster) must not idle a worker that is BUSY with
            # our task — the next dispatch would clobber its in-flight
            # record and strand the task forever
            if pid not in self._inflight:
                self._idle.add(pid)
            return
        if "hb" in reply:
            return
        unit = self._inflight.get(pid)
        if (unit is None or getattr(unit[0], "_wire", None)
                != protocol.extract_job(reply)):
            # stale frame from an earlier epoch of this cluster (e.g. a
            # losing speculative duplicate of a pre-daemon TaskFarm
            # run): ignore it WITHOUT touching the in-flight record or
            # the idle set — popping here would silently discard a live
            # task and double-book the still-busy worker
            return
        job, idx, t0 = unit
        self._inflight.pop(pid)
        self._idle.add(pid)
        idx = reply.get("task", idx)
        wall = _now() - t0
        if job.state != "running":
            # cancelled/failed mid-flight: charge fair-share, drop reply
            self.service.admission.on_done(job, idx, wall,
                                           ok=bool(reply.get("ok")))
            return
        for e in reply.get("events") or ():
            job.event(dict(e, worker=pid))
        if not reply.get("ok"):
            self._fail_job(job, idx, pid, reply, wall)
            return
        if reply.get("rewrites"):
            job.rewrites += int(reply["rewrites"])
        done_ev = {"event": "task_done", "task": idx, "worker": pid,
                   "wall_s": round(wall, 4)}
        if reply.get("launches"):
            # the kernels the task launched in its worker (a field of the
            # port's: the workers' counters are in other processes)
            done_ev["launches"] = reply["launches"]
        job.event(done_ev)
        family_histogram(REGISTRY, "task_seconds",
                         job=job.id).observe(wall)
        family_counter(REGISTRY, "tasks", job=job.id).inc()
        self.service.admission.on_done(job, idx, wall, ok=True)
        done = job.task_result(idx, reply.get("table"))
        if done:
            trace.finish(getattr(job, "_span", None),
                         done=job.n_tasks)
            job.mark_phase("run")    # last reply landed; finish() owns
            job.finish(True)         # the fetch (combine) segment
            self.service.admission.retire(job)
            family_counter(REGISTRY, "jobs", job=job.id).inc()
            family_gauge(REGISTRY, "queue_depth", job=job.id).set(0)
            self.service._job_terminal(job)

    # -- the loop ----------------------------------------------------------

    def _live_pids(self) -> List[int]:
        return [p for p in self.cl.sockets if p not in self._dead]

    def _loop(self) -> None:
        svc = self.service
        while not self._stop.is_set():
            try:
                self._tick(svc)
            except Exception:
                # the ONE dispatch thread must survive anything — a
                # transient error (full disk killing a log write, a
                # socket edge case) wedging it would strand every job
                # while submissions keep being accepted
                try:
                    svc.log({"event": "service_error", "error":
                             "fleet loop error (recovered):\n"
                             + traceback.format_exc()[-2000:]})
                except Exception:
                    pass
                time.sleep(0.2)

    def _tick(self, svc) -> None:
        """One iteration of the dispatch loop: reap timeouts/deaths,
        fill idle workers fair-share, drain replies (~100ms)."""
        timeout_s = svc.config.task_timeout_s
        now = _now()
        # per-task timeout: a wedged worker is retired (its socket
        # severed) and the task reassigns elsewhere — farm semantics
        for pid, (job, idx, t0) in list(self._inflight.items()):
            if now - t0 > timeout_s:
                job.event({"event": "task_timeout", "task": idx,
                           "worker": pid, "timeout_s": timeout_s})
                self.cl.retire_worker(pid)
                self._worker_lost(pid)
        # startup-ping timeout: a worker that never pongs would
        # otherwise just never enter the idle set — with every
        # worker wedged that way jobs would queue forever with no
        # verdict; retire it like a wedged task
        for pid, t0 in list(self._ping_t.items()):
            if now - t0 > min(30.0, timeout_s):
                svc.log({"event": "worker_ping_timeout",
                         "worker": pid})
                self.cl.retire_worker(pid)
                self._worker_lost(pid)
        # process deaths
        for pid, proc in self.cl.worker_procs().items():
            if pid not in self._dead and proc.poll() is not None:
                self._worker_lost(pid)
        live = self._live_pids()
        if not live:
            for row in svc.list_jobs():
                j = svc.jobs.get(row["job"])
                if j is not None and j.state in ("queued", "running"):
                    j.pending.clear()
                    j.finish(False, error="all fleet workers died"
                             + self.cl.log_tails())
                    svc.admission.retire(j)
                    svc._job_terminal(j)
            time.sleep(0.5)
            return
        # fill idle workers from the fair-share queue (belt+braces:
        # a worker with an in-flight task is never dispatch-eligible
        # even if something wrongly idled it)
        self._idle -= set(self._inflight)
        while self._idle:
            unit = svc.admission.next_unit()
            if unit is None:
                break
            job, idx = unit
            if job.state == "cancelled":
                svc.admission.on_done(job, idx, 0.0)
                svc.admission.retire(job)
                continue
            if not self._dispatch(job, idx, min(self._idle)):
                svc.admission.requeue(job, idx)
        # replies
        socks = {self.cl.sockets[p]: p for p in self._live_pids()}
        if not socks:
            return
        try:
            ready, _, _ = select.select(list(socks), [], [], 0.1)
        except (OSError, ValueError):
            return
        for sock in ready:
            pid = socks[sock]
            frames, ok = self.cl.recv_frames_any(pid)
            for reply in frames:
                self._on_reply(pid, reply)
            if not ok:
                self._worker_lost(pid)
