"""Per-tenant SLO tracking: rolling attainment + error-budget burn rate —
the port of ``dryad_tpu/obs/slo.py``.

A service "serving millions of users" is operated on objectives, not on
raw event streams: each tenant declares what a GOOD job is (finished
successfully, and — when a latency objective is set — within
``latency_s`` wall) and what fraction of jobs must be good
(``target``, e.g. 0.99).  The tracker keeps a rolling window of
terminal jobs per tenant and derives:

* **attainment** — the good fraction over the window;
* **burn rate** — ``(1 - attainment) / (1 - target)``: how fast the
  error budget is being spent.  1.0 means exactly on budget; above 1.0
  the tenant is burning budget faster than the objective allows (the
  standard SRE multiwindow-burn alert input); the service daemon emits
  a ``slo_breach`` event on the transition past 1.0.

Two derivations from one implementation (the ``obs/metrics.py``
pattern): the service daemon feeds a LIVE tracker on every terminal job
(gauges ``dryad_slo_attainment_ratio`` / ``dryad_slo_burn_rate``,
served at ``GET /slo``), and :func:`slo_from_events` rebuilds the same
rows from recorded ``job_done`` / ``job_failed`` events — so history
archives answer the same SLO questions post-hoc.

Objectives ride :class:`~dryad_tpu_torch.service.tenancy.TenantQuota`
(``slo_latency_s`` / ``slo_target`` / ``slo_window``); this module
stays dependency-free so offline tools can import it without the
service stack.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Callable, Dict, Optional

__all__ = ["SloObjective", "SloTracker", "burn_rate", "slo_from_events"]


@dataclasses.dataclass(frozen=True)
class SloObjective:
    """One tenant's declared objective.  ``target`` is the required
    good fraction (0 = no SLO declared — nothing is tracked);
    ``latency_s`` additionally requires good jobs to finish within that
    wall (0 = success-only SLO); ``window`` is the rolling number of
    terminal jobs the attainment is computed over."""

    latency_s: float = 0.0
    target: float = 0.0
    window: int = 64

    def __post_init__(self):
        if not (0.0 <= self.target < 1.0):
            raise ValueError("SloObjective: 0 <= target < 1")
        if self.latency_s < 0:
            raise ValueError("SloObjective: latency_s >= 0")
        if self.window < 1:
            raise ValueError("SloObjective: window >= 1")

    @property
    def active(self) -> bool:
        return self.target > 0.0

    def good(self, ok: bool, wall_s: Optional[float]) -> bool:
        """Did one terminal job meet the objective?"""
        if not ok:
            return False
        if self.latency_s <= 0:
            return True
        return wall_s is not None and wall_s <= self.latency_s


def burn_rate(attainment: float, target: float) -> float:
    """Error-budget burn rate: observed bad fraction over the budgeted
    bad fraction.  1.0 = spending exactly on budget; > 1.0 = burning
    faster than the objective allows."""
    budget = 1.0 - target
    return (1.0 - attainment) / budget if budget > 0 else 0.0


class SloTracker:
    """Rolling per-tenant attainment/burn over terminal jobs.

    ``objective_of(tenant) -> SloObjective`` resolves each tenant's
    declared objective (the service passes its quota table); tenants
    whose objective is inactive record nothing and report nothing.
    Thread-safe: fleets record from several threads."""

    def __init__(self, objective_of: Callable[[str], SloObjective]):
        self._objective_of = objective_of
        self._lock = threading.Lock()
        self._windows: Dict[str, deque] = {}   # tenant -> deque[bool]

    def objective(self, tenant: str) -> SloObjective:
        return self._objective_of(tenant)

    def record(self, tenant: str, ok: bool,
               wall_s: Optional[float] = None) -> Optional[dict]:
        """Fold one terminal job in; returns the tenant's refreshed row
        (:meth:`row`) or None when the tenant declares no SLO."""
        obj = self._objective_of(tenant)
        if not obj.active:
            return None
        good = obj.good(ok, wall_s)
        with self._lock:
            w = self._windows.get(tenant)
            if w is None or w.maxlen != obj.window:
                w = deque(w or (), maxlen=obj.window)
                self._windows[tenant] = w
            w.append(good)
        return self.row(tenant)

    def row(self, tenant: str) -> Optional[dict]:
        obj = self._objective_of(tenant)
        if not obj.active:
            return None
        with self._lock:
            w = tuple(self._windows.get(tenant) or ())
        jobs = len(w)
        good = sum(w)
        att = (good / jobs) if jobs else 1.0
        burn = burn_rate(att, obj.target)
        return {"tenant": tenant, "target": obj.target,
                "latency_s": obj.latency_s, "window": obj.window,
                "jobs": jobs, "good": good,
                "attainment": round(att, 4),
                "burn_rate": round(burn, 3),
                "breaching": burn > 1.0}

    def snapshot(self) -> Dict[str, dict]:
        """{tenant: row} for every tenant that has recorded jobs."""
        with self._lock:
            tenants = list(self._windows)
        out = {}
        for t in tenants:
            r = self.row(t)
            if r is not None:
                out[t] = r
        return out


def slo_from_events(events,
                    objective_of: Callable[[str], SloObjective]
                    ) -> SloTracker:
    """Rebuild a tracker from recorded events (history archives, per-job
    JSONLs): every tenant-tagged ``job_done`` is a good-candidate
    terminal job (its ``wall_s`` checked against the latency objective),
    every tenant-tagged ``job_failed`` a bad one.  Cancellations are
    neither — matching the live daemon's accounting."""
    from dryad_tpu_torch.utils.events import EventLog
    if isinstance(events, EventLog):
        events = events.events
    tr = SloTracker(objective_of)
    for e in events:
        tenant = e.get("tenant")
        if tenant is None:
            continue
        k = e.get("event")
        if k == "job_done":
            tr.record(str(tenant), True, e.get("wall_s"))
        elif k == "job_failed":
            tr.record(str(tenant), False, e.get("wall_s"))
    return tr
