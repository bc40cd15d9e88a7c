"""Multi-tenant job service — the port of ``dryad_tpu/service`` on the
in-process fleet: one persistent daemon, many concurrent jobs, one
shared device.

:class:`JobService` admits jobs from many tenants through a weighted
fair-share :class:`~dryad_tpu_torch.service.admission.AdmissionQueue`
with per-tenant quotas and typed DTA91x rejections, gives every job its
own driver state (event log, metrics labels, forensics dir, failure
budget, its own ``exec/recovery.Run``), and shares the fleet threads'
one executor, the scan registry of loaded tables and the
:class:`~dryad_tpu_torch.utils.compile_cache.FileCache` of serialized
SQL plans.  ``service/durable`` journals the daemon's own state,
``inc/standing.py`` runs standing queries on it.

Front end: ``python -m dryad_tpu_torch.service serve|submit|status|
cancel|list|wait`` over HTTP (``service/http.py``); the dashboard at
``/`` is the obs/history index promoted to a live multi-job view.
``JobService(cluster=)`` runs jobs as farm tasks on a cluster's workers
(the cluster fleet).
"""

from dryad_tpu_torch.service.admission import AdmissionQueue
from dryad_tpu_torch.service.apps import APPS, ServiceApp, get_app
from dryad_tpu_torch.service.daemon import JobService
from dryad_tpu_torch.service.job import ServiceJob
from dryad_tpu_torch.service.tenancy import (FailureBudgetError,
                                             MalformedJobError,
                                             QueueFullError, ServiceConfig,
                                             ServiceRejected,
                                             ServiceStoppedError,
                                             TenantQuota, UnknownAppError)

__all__ = ["JobService", "ServiceConfig", "TenantQuota", "ServiceJob",
           "AdmissionQueue", "APPS", "ServiceApp", "get_app",
           "ServiceRejected", "QueueFullError", "FailureBudgetError",
           "UnknownAppError", "MalformedJobError", "ServiceStoppedError"]
