"""Admission queue: weighted fair-share + priority scheduling across
tenants, with quota enforcement and typed backpressure — the port of
``dryad_tpu/service/admission.py``.

The scheduling unit is a TASK (one independently dispatchable slice of a
job — a farm task on the cluster fleet, or the whole driver run for an
in-process job).  Tenant selection is classic weighted fair queuing:
every completed task charges its wall seconds to its tenant, and the
next idle slot goes to the backlogged tenant with the smallest virtual
time ``used_slot_s / share`` — so shares converge to the configured
weights whenever demand exceeds capacity, and an unopposed tenant gets
the whole fleet (work-conserving).  Within a tenant, jobs order by
(priority desc, submit order) and a job's tasks are FIFO.

This is the DryadLINQ-era gap the ROADMAP names: the reference delegates
cross-job arbitration to the cluster scheduler (one GM per job); a
persistent multi-job daemon must arbitrate itself.

Thread-safety: every public method takes the internal lock; the fleet
loops call :meth:`next_unit` / :meth:`on_done` from their own threads
while submissions arrive from API/HTTP threads.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Tuple

from dryad_tpu_torch.service.tenancy import (FailureBudgetError, QueueFullError,
                                       TenantQuota)

__all__ = ["AdmissionQueue"]


class _TenantState:
    __slots__ = ("name", "jobs", "running_tasks", "used_slot_s",
                 "failures")

    def __init__(self, name: str):
        self.name = name
        self.jobs: List = []          # admitted, not yet fully dispatched
        self.running_tasks = 0
        self.used_slot_s = 0.0
        self.failures = 0


class AdmissionQueue:
    """Fair-share admission across tenants (see module docstring).

    ``quota_of`` maps a tenant name to its :class:`TenantQuota`
    (ServiceConfig.quota).  Jobs are any objects with the attributes the
    queue reads/writes: ``tenant``, ``priority``, ``seq``, ``state``
    ("queued" -> "running" on first dispatch), and ``pending`` (a deque
    of task indices the queue pops)."""

    def __init__(self, quota_of: Callable[[str], TenantQuota]):
        self._quota_of = quota_of
        self._lock = threading.Lock()
        self._tenants = {}
        # wakes fleet loops blocked in next_unit(wait=...)
        self._ready = threading.Condition(self._lock)
        # optional write-ahead journal (service/durable): when the
        # daemon sets it, every on_done charge is journaled so a
        # restart restores each tenant's fair-share virtual time and
        # failure count instead of zeroing them
        self.journal = None

    def _state(self, tenant: str) -> _TenantState:
        st = self._tenants.get(tenant)
        if st is None:
            st = self._tenants[tenant] = _TenantState(tenant)
        return st

    # -- submission --------------------------------------------------------

    def precheck(self, tenant: str) -> None:
        """Raise the typed rejection a submission from ``tenant`` would
        hit RIGHT NOW (advisory — :meth:`submit` re-checks atomically).
        The daemon calls this before paying for plan/payload building,
        so a rejected submission does zero work of any kind.  Read-only:
        a tenant the queue has never seen allocates NO state here (this
        runs for every raw submission string, valid or not)."""
        with self._lock:
            st = self._tenants.get(tenant)
            if st is None:
                return            # fresh tenant: nothing to wall on yet
            q = self._quota_of(tenant)
            if q.failure_budget and st.failures > q.failure_budget:
                raise FailureBudgetError(tenant, st.failures,
                                         q.failure_budget)
            queued = sum(1 for j in st.jobs if j.state == "queued")
            if queued >= q.max_queued_jobs:
                raise QueueFullError(tenant, queued, q.max_queued_jobs)

    def submit(self, job, force: bool = False) -> None:
        """Admit ``job`` or raise a typed rejection (QueueFullError /
        FailureBudgetError) with ZERO work started.  ``force`` skips
        the quota walls: recovery re-admitting journaled jobs must
        never re-reject work the daemon already accepted (the quotas
        were enforced at original admission)."""
        with self._lock:
            q = self._quota_of(job.tenant)
            st = self._state(job.tenant)
            if not force:
                if q.failure_budget and st.failures > q.failure_budget:
                    raise FailureBudgetError(job.tenant, st.failures,
                                             q.failure_budget)
                queued = sum(1 for j in st.jobs if j.state == "queued")
                if queued >= q.max_queued_jobs:
                    raise QueueFullError(job.tenant, queued,
                                         q.max_queued_jobs)
            # WFQ idle catch-up: a tenant returning from idle must not
            # cash in the virtual time it "saved" while absent (it would
            # monopolize the fleet until it caught up) — fast-forward it
            # to the slowest ACTIVE tenant's virtual time
            if not st.jobs and st.running_tasks == 0:
                active = [t.used_slot_s / self._quota_of(t.name).share
                          for t in self._tenants.values()
                          if t.jobs or t.running_tasks]
                if active:
                    st.used_slot_s = max(st.used_slot_s,
                                         min(active) * q.share)
            # measured queue wait (obs/latency.py): stamp the enqueue
            # instant; _pick stamps first dispatch and the pair feeds
            # the dryad_queue_wait_seconds histogram — the autoscaling
            # signal — without inferring from wall-clock event ts
            try:
                job.enqueued_ns = time.monotonic_ns()
            except AttributeError:
                pass              # slotted test stubs: no stamp, no wait
            st.jobs.append(job)
            st.jobs.sort(key=lambda j: (-j.priority, j.seq))
            self._ready.notify_all()

    # -- scheduling --------------------------------------------------------

    def _runnable_job(self, st: _TenantState, q: TenantQuota):
        """The tenant's next dispatchable job, honoring the
        concurrent-jobs cap for jobs that have not started yet."""
        running = sum(1 for j in st.jobs if j.state == "running")
        for j in st.jobs:
            if not j.pending:
                continue
            if j.state == "running" or running < q.max_concurrent_jobs:
                return j
        return None

    def next_unit(self, wait: Optional[float] = None
                  ) -> Optional[Tuple[object, int]]:
        """Pop the next (job, task_idx) to dispatch, or None when
        nothing is runnable (optionally blocking up to ``wait`` s for a
        submission).  Marks the job running and charges the tenant's
        running-task count; the caller MUST pair every unit with
        :meth:`on_done` or :meth:`requeue`."""
        with self._lock:
            unit = self._pick()
            if unit is None and wait:
                self._ready.wait(timeout=wait)
                unit = self._pick()
            return unit

    def _pick(self):
        best = None
        best_vt = None
        for st in self._tenants.values():
            q = self._quota_of(st.name)
            if q.worker_slots and st.running_tasks >= q.worker_slots:
                continue
            job = self._runnable_job(st, q)
            if job is None:
                continue
            vt = st.used_slot_s / q.share
            if best is None or vt < best_vt or (vt == best_vt
                                                and st.name < best.name):
                best, best_vt = st, vt
        if best is None:
            return None
        q = self._quota_of(best.name)
        job = self._runnable_job(best, q)
        try:
            task = job.pending.popleft()
        except IndexError:
            # a concurrent cancel() (which holds only the JOB's lock)
            # cleared the deque between _runnable_job's check and here —
            # nothing to dispatch; the fleet loop just polls again
            return None
        if job.state == "queued":
            # never clobber a concurrent terminal transition: a job
            # cancelled in this window must stay "cancelled" so the
            # fleet's dispatch guard drops the unit instead of running
            # a job its waiters were already told is cancelled
            job.state = "running"
            # first dispatch: settle the measured queue wait (enqueue
            # stamp from submit()) into the histogram and close the
            # waterfall's queue segment.  The metrics registry and the
            # PhaseClock are leaf locks — safe under the queue lock.
            now = time.monotonic_ns()
            try:
                job.dispatched_ns = now
            except AttributeError:
                pass
            enq = getattr(job, "enqueued_ns", None)
            if enq is not None:
                from dryad_tpu_torch.obs.metrics import (REGISTRY,
                                                   family_histogram)
                family_histogram(REGISTRY, "queue_wait",
                                 tenant=best.name).observe(
                                     (now - enq) / 1e9)
            ph = getattr(job, "phases", None)
            if ph is not None:
                ph.mark_once("queue")
        best.running_tasks += 1
        if not job.pending:
            # fully dispatched; completion is the job's own accounting.
            # Keep running jobs out of the queue list so the
            # concurrent-jobs cap counts only jobs still holding queued
            # tasks plus this one until its tasks land.
            pass
        return job, task

    def on_done(self, job, task_idx: int, wall_s: float,
                ok: bool = True) -> None:
        """Account one finished unit: charge the tenant's virtual time
        with the measured wall (the fair-share currency) and count
        failures toward the budget."""
        with self._lock:
            st = self._state(job.tenant)
            st.running_tasks = max(0, st.running_tasks - 1)
            st.used_slot_s += max(0.0, float(wall_s))
            if not ok:
                st.failures += 1
            self._ready.notify_all()
        # journal the charge OUTSIDE the queue lock (the journal has
        # its own lock and fsyncs; fair-share picking must not wait on
        # the disk)
        if self.journal is not None:
            try:
                self.journal.tenant_charge(job.tenant, wall_s, ok=ok)
            except Exception:
                pass      # a full disk must not take the fleet down

    def requeue(self, job, task_idx: int) -> None:
        """Return a dispatched-but-lost unit (worker death/timeout) to
        the FRONT of its job's task queue."""
        with self._lock:
            st = self._state(job.tenant)
            st.running_tasks = max(0, st.running_tasks - 1)
            job.pending.appendleft(task_idx)
            if job not in st.jobs:
                st.jobs.append(job)
                st.jobs.sort(key=lambda j: (-j.priority, j.seq))
            self._ready.notify_all()

    def retire(self, job) -> None:
        """Drop a completed/failed/cancelled job from its tenant queue
        (queued tasks are abandoned)."""
        with self._lock:
            st = self._state(job.tenant)
            if job in st.jobs:
                st.jobs.remove(job)
            self._ready.notify_all()

    # -- introspection / operations ----------------------------------------

    def depths(self):
        """{tenant: queued task count} — the queue-depth gauge feed."""
        with self._lock:
            return {st.name: sum(len(j.pending) for j in st.jobs)
                    for st in self._tenants.values()}

    def shares(self):
        """{tenant: (used_slot_s, running_tasks, failures)} snapshot."""
        with self._lock:
            return {st.name: (round(st.used_slot_s, 4), st.running_tasks,
                              st.failures)
                    for st in self._tenants.values()}

    def reset_failures(self, tenant: str) -> None:
        with self._lock:
            self._state(tenant).failures = 0

    def restore_tenant(self, tenant: str, used_slot_s: float = 0.0,
                       failures: int = 0) -> None:
        """Recovery: re-seed a tenant's ledgers from the replayed
        journal.  FLOORS, not increments — replaying twice (or racing a
        live charge) must never double-charge a budget."""
        with self._lock:
            st = self._state(tenant)
            st.used_slot_s = max(st.used_slot_s, float(used_slot_s))
            st.failures = max(st.failures, int(failures))
