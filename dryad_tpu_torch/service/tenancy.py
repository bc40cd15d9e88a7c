"""Tenancy model for the multi-tenant job service — the port of
``dryad_tpu/service/tenancy.py``.

The reference runs one Graph Manager process per job (PAPER.md layer 3)
— tenancy there is whatever the cluster scheduler grants each GM.  A
persistent daemon admitting many jobs needs the contract made explicit:
per-tenant fair-share weights, admission quotas, and failure budgets,
validated at construction like JobConfig, plus the TYPED rejections the
admission queue raises when a quota is exhausted (code-carrying DTA91x
errors, analysis/diagnostics.py — a rejected submission starts ZERO
work and tells the client exactly which wall it hit).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from dryad_tpu_torch.analysis.diagnostics import DiagnosticError

__all__ = ["TenantQuota", "ServiceConfig", "ServiceRejected",
           "QueueFullError", "FailureBudgetError", "UnknownAppError",
           "MalformedJobError", "ServiceStoppedError"]


class ServiceRejected(DiagnosticError):
    """Base for typed admission rejections: carries the stable DTA9xx
    code and the tenant, and guarantees zero work was started."""

    def __init__(self, message: str, code: str, tenant: str = ""):
        self.tenant = tenant
        super().__init__(message, code=code)


class UnknownAppError(ServiceRejected):
    def __init__(self, app: str, known):
        super().__init__(
            f"unknown service app {app!r} (registered: "
            f"{sorted(known)})", code="DTA910")


class MalformedJobError(ServiceRejected):
    """Params the app's task/query builders choke on — same DTA910
    family as an unknown app ("unknown app or malformed job spec"), so
    the HTTP front end maps it to 400, never a 500."""

    def __init__(self, app: str, cause: BaseException):
        super().__init__(
            f"malformed job spec for app {app!r}: {cause!r}",
            code="DTA910")


class QueueFullError(ServiceRejected):
    def __init__(self, tenant: str, queued: int, cap: int):
        super().__init__(
            f"tenant {tenant!r} admission queue is full "
            f"({queued}/{cap} jobs queued) — backpressure, resubmit "
            f"later", code="DTA911", tenant=tenant)


class FailureBudgetError(ServiceRejected):
    def __init__(self, tenant: str, failures: int, budget: int):
        super().__init__(
            f"tenant {tenant!r} exhausted its failure budget "
            f"({failures} task failures > {budget}) — submissions "
            f"refused until the operator resets it", code="DTA912",
            tenant=tenant)


class ServiceStoppedError(ServiceRejected):
    def __init__(self):
        super().__init__("job service is draining/stopped — submission "
                         "refused", code="DTA913")


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """Per-tenant admission contract.

    ``share`` is the weighted-fair-queuing weight: with tenants A
    (share=3) and B (share=1) both backlogged, A's tasks get ~3/4 of
    the fleet's slot-seconds.  ``worker_slots`` caps the tenant's
    CONCURRENT tasks on the fleet (0 = no cap).  ``max_queued_jobs``
    is the backpressure wall (DTA911 beyond it);
    ``max_concurrent_jobs`` caps RUNNING jobs — excess jobs queue, they
    are not rejected.  ``failure_budget`` caps cumulative task failures
    charged to the tenant (0 = unlimited); beyond it submissions are
    refused (DTA912) until reset.

    The ``slo_*`` fields declare the tenant's service-level objective
    (dryad_tpu_torch/obs/slo.py): ``slo_target`` is the required good-job
    fraction over a rolling window of ``slo_window`` terminal jobs
    (0 = no SLO declared, nothing tracked); ``slo_latency_s``
    additionally requires good jobs to finish within that wall
    (0 = success-only).  The daemon tracks rolling attainment and
    error-budget burn rate, serves them at ``GET /slo``, folds them
    into the dashboard tenant table, and emits ``slo_breach`` on the
    transition past burn rate 1.0."""

    share: float = 1.0
    max_concurrent_jobs: int = 4
    max_queued_jobs: int = 16
    worker_slots: int = 0
    failure_budget: int = 0
    slo_latency_s: float = 0.0
    slo_target: float = 0.0
    slo_window: int = 64

    def __post_init__(self):
        checks = [
            (self.share > 0, "share > 0"),
            (self.max_concurrent_jobs >= 1, "max_concurrent_jobs >= 1"),
            (self.max_queued_jobs >= 1, "max_queued_jobs >= 1"),
            (self.worker_slots >= 0, "worker_slots >= 0"),
            (self.failure_budget >= 0, "failure_budget >= 0"),
            (0.0 <= self.slo_target < 1.0, "0 <= slo_target < 1"),
            (self.slo_latency_s >= 0, "slo_latency_s >= 0"),
            (self.slo_window >= 1, "slo_window >= 1"),
        ]
        for ok, msg in checks:
            if not ok:
                raise ValueError(f"TenantQuota: {msg}")


@dataclasses.dataclass
class ServiceConfig:
    """Daemon-level knobs (the per-JOB knobs stay on JobConfig, which
    rides each submission).

    ``service_dir`` roots the daemon's state: ``jobs/<id>/`` (per-job
    event log + forensics bundles), ``history/`` (the archived multi-job
    dashboard data), ``cache/`` (the shared FileCache of serialized
    plans), and ``service.jsonl`` (the daemon's own lifecycle log)."""

    service_dir: str
    slots: int = 2                     # in-process fleet concurrency
    default_quota: TenantQuota = dataclasses.field(
        default_factory=TenantQuota)
    tenants: Dict[str, TenantQuota] = dataclasses.field(
        default_factory=dict)
    job_config: Optional[object] = None   # base JobConfig for jobs
    # cluster fleet: a task running longer than this retires its worker
    # (its socket severed) and the task reassigns elsewhere
    task_timeout_s: float = 600.0
    # serialized sql.Catalog (Catalog.save JSON) the daemon loads at
    # startup: the tables POST /sql queries resolve FROM clauses
    # against (a Catalog object passed to JobService(...) wins)
    catalog_path: Optional[str] = None
    # daemon-resident retention for TERMINAL jobs: beyond this many,
    # the oldest finished/failed/cancelled jobs drop from the live jobs
    # table and their per-job metric series are pruned from the
    # registry (a persistent daemon must not grow per-unique-job-id
    # state without bound).  Their directories and history archives
    # remain on disk — the dashboard's archive table still lists them.
    max_terminal_jobs: int = 256
    # durability (service/durable): with ``durable`` on, every
    # admission/terminal/charge lands in the write-ahead journal under
    # ``<service_dir>/durable/`` BEFORE the daemon acts on it, and a
    # restarted daemon replays it — queued jobs re-admitted in order,
    # running jobs resumed, terminal jobs indexed for the read surfaces.
    # ``durable_spill`` additionally gives every in-process job a
    # per-stage spill dir + driver checkpoint (resume re-executes only
    # unsettled stages) — off by default because it writes every
    # stage's output to disk.  ``journal_fsync`` trades append
    # durability for latency; ``journal_compact_every`` is the
    # checkpoint-compaction period in records.
    durable: bool = True
    durable_spill: bool = False
    journal_fsync: bool = True
    journal_compact_every: int = 512

    def quota(self, tenant: str) -> TenantQuota:
        return self.tenants.get(tenant, self.default_quota)

    def slo_objective(self, tenant: str):
        """The tenant's declared SLO as an
        :class:`~dryad_tpu_torch.obs.slo.SloObjective` (inactive when the
        quota declares none) — the daemon's SloTracker resolves
        through this, so per-tenant quota overrides apply."""
        from dryad_tpu_torch.obs.slo import SloObjective
        q = self.quota(tenant)
        return SloObjective(q.slo_latency_s, q.slo_target,
                            q.slo_window)

    @staticmethod
    def tenants_from_json(obj: Dict[str, dict]) -> Dict[str, TenantQuota]:
        """{"tenant": {"share": 2, ...}, ...} -> quota map (the CLI's
        --tenants file format, docs/service.md)."""
        return {name: TenantQuota(**(kw or {}))
                for name, kw in obj.items()}
