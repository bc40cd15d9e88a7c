"""Task-farm scheduling with straggler speculation — the port of
``dryad_tpu/runtime/farm.py``.

The counterpart of the reference's per-vertex scheduling + speculative
duplication: DrStageStatistics fits robust completion statistics and
requests duplicates for outliers (DrStageStatistics.cpp:403-534, capped
at 20% duplication), DrVertex::RequestDuplicate reruns the vertex
elsewhere, first finisher wins, and a failed machine only costs the
vertices that ran there (ReactToFailedVertex).

Gang-SPMD stages cannot speculate one shard (every collective is a
barrier), so speculation lives where tasks ARE independent: map-style
per-partition tasks farmed over the worker processes.  Each task runs on
one worker's own device (its logical partitions there; no collective
across processes), so tasks are freely duplicable, reassignable, and
survive the loss of any worker without a gang restart.  Each reply
carries the kernel launches its task made (``launches``, a field of the
port's: the workers' counters are in other processes), and ``task_done``
records them.
"""

from __future__ import annotations

import select
import statistics
import time
from typing import Any, Callable, Dict, List, Optional

from dryad_tpu_torch.runtime import protocol
from dryad_tpu_torch.runtime.cluster import WorkerFailure

__all__ = ["TaskFarm", "FarmError"]


class FarmError(RuntimeError):
    pass


def _norm_host(h: str) -> str:
    """Case-insensitive, FQDN-insensitive host matching: block reports
    may say ``dn0.cluster.local`` while the worker registered ``dn0``.
    IP addresses keep all their dots (stripping ``10.0.0.4`` to ``10``
    would collide every same-subnet worker)."""
    h = h.strip().lower()
    first = h.split(".", 1)[0]
    return h if first.isdigit() else first


class _Task:
    __slots__ = ("idx", "sources", "runs", "delays", "result", "duplicated",
                 "pref", "spans", "dup_pid")

    def __init__(self, idx: int, sources: Dict[str, Dict[str, Any]],
                 host_pids: Dict[str, set]):
        self.idx = idx
        self.sources = sources
        self.runs: Dict[int, float] = {}   # worker -> dispatch time
        self.delays: Dict[int, float] = {}  # worker -> commanded test delay
        self.spans: Dict[int, Any] = {}    # worker -> open dispatch span
        self.result: Optional[Dict[str, Any]] = None
        self.duplicated = False
        self.dup_pid: Optional[int] = None   # the speculative copy's pid
        # soft locality hints from the task's source specs: an explicit
        # worker pid (the worker that wrote/holds the store partitions)
        # and/or block-holding HOST names (hdfs GETFILEBLOCKLOCATIONS
        # metadata) resolved to worker pids through the cluster's
        # worker->host map (Interfaces.cs:98-152 affinity-list role).
        # Unknown hosts resolve to nothing — a hint can never make a
        # task undispatchable.
        self.pref: set = set()
        for s in sources.values():
            if not isinstance(s, dict):
                continue
            if s.get("preferred_worker") is not None:
                self.pref.add(s["preferred_worker"])
            for h in (s.get("preferred_hosts") or ()):
                self.pref |= host_pids.get(_norm_host(h), set())


class TaskFarm:
    """Farm one plan over many independent per-task sources.

    ``run(plan_json, per_task_sources)`` executes the SAME plan once per
    task, each with its own source bindings, and returns the per-task host
    tables in task order.  Straggler speculation: once ``min_samples``
    tasks have completed, a running task whose elapsed time exceeds
    median + max(sigma * 1.4826 * MAD, rel_margin * median, abs_margin)
    is duplicated onto an idle worker (at most ``duplication_budget`` of
    the task count, the reference's 20% cap); the first finisher wins.
    A dead worker's in-flight tasks are reassigned, not failed.
    """

    def __init__(self, cluster, duplication_budget: Optional[float] = None,
                 outlier_sigma: Optional[float] = None,
                 min_samples: Optional[int] = None,
                 rel_margin: Optional[float] = None,
                 abs_margin_s: Optional[float] = None,
                 config=None,
                 delay_hook: Optional[Callable[[int, int], float]] = None,
                 worker_hosts: Optional[Dict[int, str]] = None,
                 job_label: Optional[str] = None):
        from dryad_tpu_torch.utils.config import JobConfig
        cfg = config or JobConfig()
        self.config = cfg
        self.cluster = cluster
        # per-job metric namespacing (obs/metrics.PER_JOB_FAMILIES): when
        # the caller names the job (the service daemon always does), the
        # queue-depth gauge and task histogram carry a job label so
        # concurrent jobs' scrapes never merge; unset = the historical
        # unlabeled families
        self.job_label = job_label
        self._job_labels = ({"job": job_label} if job_label is not None
                            else {})
        self.duplication_budget = (
            duplication_budget if duplication_budget is not None
            else (cfg.speculation_duplication_budget
                  if cfg.speculation_enabled else 0.0))
        self.outlier_sigma = (outlier_sigma if outlier_sigma is not None
                              else cfg.speculation_outlier_sigma)
        self.min_samples = (min_samples if min_samples is not None
                            else (cfg.speculation_min_samples
                                  if cfg.speculation_enabled else 10**9))
        self.rel_margin = (rel_margin if rel_margin is not None
                           else cfg.speculation_rel_margin)
        self.abs_margin_s = (abs_margin_s if abs_margin_s is not None
                             else cfg.speculation_abs_margin_s)
        self.task_timeout_s = cfg.farm_task_timeout_s
        # test hook: delay_hook(task_idx, worker_id) -> seconds the worker
        # should sleep before executing (simulates a slow machine)
        self.delay_hook = delay_hook
        # worker pid -> machine name, for resolving block->host locality
        # hints (source spec ``preferred_hosts``) to dispatchable workers;
        # defaults to the cluster's own map (LocalCluster: every worker on
        # this machine)
        self.worker_hosts = worker_hosts
        self.events: List[dict] = []

    def _emit(self, e: dict) -> None:
        self.events.append(e)
        if self.cluster.event_log is not None:
            self.cluster.event_log(dict(e))

    def _persist_forensics(self, reply: dict):
        """Persist a failing reply's flight-recorder bundle and emit
        the task_forensics breadcrumb (obs/flight.py); returns the
        bundle path (None when the reply carries no bundle)."""
        from dryad_tpu_torch.obs import flight
        return flight.persist_reply_forensics(
            reply, self.config, self.cluster.event_log, self._emit)

    # -- scheduling --------------------------------------------------------

    def _threshold(self, durations: List[float]) -> Optional[float]:
        if len(durations) < self.min_samples:
            return None
        med = statistics.median(durations)
        mad = statistics.median([abs(d - med) for d in durations])
        margin = max(self.outlier_sigma * 1.4826 * mad,
                     self.rel_margin * med, self.abs_margin_s)
        return med + margin

    def run(self, plan_json: str,
            per_task_sources: List[Dict[str, Dict[str, Any]]],
            timeout: Optional[float] = None,
            task_timeout_s: Optional[float] = None
            ) -> List[Dict[str, Any]]:
        """``timeout`` bounds the whole farm run (None = unbounded);
        ``task_timeout_s`` overrides JobConfig.farm_task_timeout_s for
        legitimately slow tasks."""
        from dryad_tpu_torch.obs import trace
        from dryad_tpu_torch.obs.metrics import REGISTRY, family_gauge

        cl = self.cluster
        if not cl.alive():
            cl.restart()
        job = cl.next_job_id()
        # the farm span roots every per-dispatch sched span; its context
        # rides each task envelope to the workers (runtime/protocol
        # TRACE_CTX), so worker task/stage/io spans link back here.  It
        # must finish on EVERY exit path or the sched spans it parents
        # would dangle in the stream.  The sink inherits the attached
        # EventLog's level — and with NO log attached, level 0: no
        # consumer means zero span work, and no trace_ctx means the
        # workers skip theirs too.
        tsink = trace.leveled(self._emit,
                              getattr(cl.event_log, "level", None)
                              if cl.event_log is not None else 0)
        queue_gauge = family_gauge(REGISTRY, "queue_depth",
                                   **self._job_labels)
        farm_span = trace.start("farm", "farm", sink=tsink,
                                job=job, tasks=len(per_task_sources))
        # driver-side resource sampler for the farm's duration (workers
        # run their own per-task samplers); gated by the same sink level
        # as the spans, so an untraced farm starts no thread
        from dryad_tpu_torch.obs import profile as _profile
        sampler = _profile.start(
            tsink, getattr(self.config, "resource_sample_s", 0.0) or 0.0,
            role="driver", job=job)
        try:
            out = self._run(plan_json, per_task_sources, timeout,
                            task_timeout_s, job, farm_span, tsink,
                            queue_gauge)
        except BaseException as e:
            trace.finish(farm_span, error=type(e).__name__)
            raise
        finally:
            _profile.stop(sampler)
            # an idle farm has no queue — a stale depth would misfire
            # any dashboard alerting on it
            queue_gauge.set(0)
        trace.finish(farm_span, done=len(out))
        return out

    def _run(self, plan_json: str,
             per_task_sources: List[Dict[str, Dict[str, Any]]],
             timeout: Optional[float], task_timeout_s: Optional[float],
             job: int, farm_span, tsink, queue_gauge
             ) -> List[Dict[str, Any]]:
        from dryad_tpu_torch.obs import trace
        from dryad_tpu_torch.obs.metrics import REGISTRY, family_histogram

        cl = self.cluster
        task_hist = family_histogram(REGISTRY, "task_seconds",
                                     **self._job_labels)
        hosts = (self.worker_hosts if self.worker_hosts is not None
                 else (cl.worker_hosts()
                       if hasattr(cl, "worker_hosts") else {}))
        host_pids: Dict[str, set] = {}
        for pid, h in hosts.items():
            host_pids.setdefault(_norm_host(h), set()).add(pid)
        tasks = [_Task(i, s, host_pids)
                 for i, s in enumerate(per_task_sources)]
        todo: List[_Task] = list(tasks)
        n_done = 0
        durations: List[float] = []
        # 0 budget = speculation off; otherwise floor at one duplicate so
        # small farms can still speculate (the fraction cap is the
        # reference's 20% rule, DrStageStatistics.cpp)
        dup_cap = (0 if self.duplication_budget <= 0
                   else max(1, int(self.duplication_budget * len(tasks))))
        dups_used = 0
        # a worker is idle only once it answers THIS job's ping: a pong
        # proves it drained any still-running losing duplicate from a
        # previous farm run, so per-task timers never include stale queue
        # time (which would falsely retire a healthy worker)
        idle: set = set()
        ping_t: Dict[int, float] = {}
        for pid in list(cl.sockets):
            sock = cl.sockets[pid]
            try:
                sock.setblocking(True)
                protocol.send_msg(sock, {"cmd": "ping", "job": job})
                sock.setblocking(False)
                ping_t[pid] = time.time()
            except OSError:
                pass   # handled as dead below
        dead: set = set()
        running: Dict[int, _Task] = {}   # worker -> task
        # overall farm deadline only when the caller passes one explicitly;
        # the config knob is PER-TASK (reference per-vertex semantics) and
        # is enforced against each dispatched run below
        deadline = None if timeout is None else time.time() + timeout
        task_timeout = (task_timeout_s if task_timeout_s is not None
                        else self.task_timeout_s)

        def dispatch(task: _Task, pid: int) -> bool:
            delay = (self.delay_hook(task.idx, pid)
                     if self.delay_hook else 0.0)
            sock = cl.sockets[pid]
            # driver-side dispatch span: covers queue + wire + worker
            # execution; the worker's own task span (child) subtracts to
            # the queue/transit share (obs/critical_path.py)
            sp = trace.start(f"task {task.idx}", "sched",
                             parent=farm_span, sink=tsink,
                             task=task.idx, worker=pid)
            try:
                sock.setblocking(True)
                protocol.send_msg(sock, protocol.attach_trace(
                    protocol.attach_job(
                        {"cmd": "run_task", "plan": plan_json,
                         "sources": task.sources,
                         "task": task.idx,
                         "config": self.config, "delay_s": delay}, job),
                    trace.ctx_of(sp if sp is not None else farm_span)))
                sock.setblocking(False)
            except OSError:
                trace.finish(sp, error="dispatch_failed")
                worker_lost(pid)
                return False
            task.runs[pid] = time.time()
            task.delays[pid] = delay
            if sp is not None:
                task.spans[pid] = sp
            running[pid] = task
            idle.discard(pid)
            return True

        n_workers_total = len(cl.sockets)   # gang + elastic at farm start

        def worker_lost(pid: int) -> None:
            dead.add(pid)
            idle.discard(pid)
            task = running.pop(pid, None)
            if task is not None:
                trace.finish(task.spans.pop(pid, None), error="worker_lost")
            if (task is not None and task.result is None
                    and task not in todo):
                task.runs.pop(pid, None)
                todo.insert(0, task)
                self._emit({"event": "task_reassigned", "task": task.idx,
                            "worker": pid})
            if len(dead) >= n_workers_total:
                raise WorkerFailure(
                    "all workers died during task farm" + cl.log_tails())

        while n_done < len(tasks):
            queue_gauge.set(len(todo))
            if deadline is not None and time.time() > deadline:
                raise FarmError(
                    f"task farm timed out; {len(tasks) - n_done} tasks "
                    f"unfinished")
            # per-task timeout: a run stuck past the task timeout means its
            # worker is wedged — retire that worker (the reference abandons
            # the vertex's process, ReactToFailedVertex) so the task
            # reassigns elsewhere and a half-written reply can't wedge the
            # next job's blocking send.  A pid still in `running` has not
            # replied, so this applies even when a duplicate already won the
            # task.  Commanded test delays (delay_hook) extend the budget —
            # they simulate slowness, not a wedge.
            now = time.time()
            for pid, t in list(running.items()):
                budget = task_timeout + t.delays.get(pid, 0.0)
                if now - t.runs.get(pid, now) > budget:
                    self._emit({"event": "task_timeout", "task": t.idx,
                                "worker": pid, "timeout_s": task_timeout})
                    cl.retire_worker(pid)
                    worker_lost(pid)
            # a worker that never answered the idle-gate ping within the
            # task budget is wedged on prior work — retire it too
            for pid, t0 in list(ping_t.items()):
                if pid not in dead and now - t0 > task_timeout:
                    self._emit({"event": "worker_ping_timeout",
                                "worker": pid, "timeout_s": task_timeout})
                    ping_t.pop(pid, None)
                    cl.retire_worker(pid)
                    worker_lost(pid)
            # fill idle workers: fresh tasks first, then speculate.  A task
            # reassigned by worker-loss/timeout may since have finished via
            # a surviving duplicate — skip those.  Locality-aware matching:
            # an idle worker takes a task that PREFERS it when one exists
            # (an explicit worker hint, or a block->host hint resolving to
            # that worker's machine), but preference never blocks — an
            # idle worker with no preferring task takes the queue head
            # (fall back freely; reference weighted affinity,
            # Interfaces.cs:98-152)
            while todo and idle:
                pair = next((t for t in todo
                             if t.result is None and t.pref & idle),
                            None)
                if pair is not None:
                    todo.remove(pair)
                    pid = min(pair.pref & idle)
                    if dispatch(pair, pid):
                        self._emit({"event": "task_locality_dispatch",
                                    "task": pair.idx, "worker": pid})
                    else:
                        todo.insert(0, pair)
                    continue
                t = todo.pop(0)
                if t.result is not None:
                    continue
                if not dispatch(t, min(idle)):
                    todo.insert(0, t)
            if not todo and idle and dups_used < dup_cap:
                thr = self._threshold(durations)
                if thr is not None:
                    now = time.time()
                    cands = [t for t in running.values()
                             if t.result is None and not t.duplicated
                             and now - min(t.runs.values()) > thr]
                    if cands:
                        worst = max(cands,
                                    key=lambda t: now - min(t.runs.values()))
                        pid = min(idle)
                        # burn the budget slot only if the clone actually
                        # dispatched — a failed send must leave the
                        # straggler cloneable elsewhere
                        if dispatch(worst, pid):
                            worst.duplicated = True
                            worst.dup_pid = pid
                            dups_used += 1
                            self._emit({"event": "task_duplicated",
                                        "task": worst.idx, "worker": pid,
                                        "elapsed_s": round(
                                            now - min(worst.runs.values()),
                                            3),
                                        "threshold_s": round(thr, 3)})

            # liveness + replies (gang AND elastic workers)
            for pid, proc in cl.worker_procs().items():
                if pid not in dead and proc.poll() is not None:
                    worker_lost(pid)
            live = {cl.sockets[pid]: pid for pid in cl.sockets
                    if pid not in dead}
            if not live:
                raise WorkerFailure("no live workers" + cl.log_tails())
            ready, _, _ = select.select(list(live), [], [], 0.1)
            for sock in ready:
                pid = live[sock]
                frames, ok = cl.recv_frames(pid, job)
                if not ok:
                    worker_lost(pid)
                    continue
                for reply in frames:
                    if "pong" in reply:      # idle-gate ping answered
                        ping_t.pop(pid, None)
                        idle.add(pid)
                        continue
                    running.pop(pid, None)
                    idle.add(pid)
                    t = (tasks[reply["task"]]
                         if reply.get("task") is not None else None)
                    # forward the worker's span/event records (tagged
                    # with the emitting worker) — losing duplicates
                    # included: their spans ARE the straggler evidence
                    for e in reply.get("events") or ():
                        self._emit(dict(e, worker=pid))
                    if not reply.get("ok"):
                        # a losing duplicate's failure costs nothing once
                        # the winner delivered (first-finisher-wins)
                        if t is not None:
                            trace.finish(t.spans.pop(pid, None),
                                         error="task_failed")
                        if t is not None and t.result is not None:
                            self._emit({"event":
                                        "task_duplicate_failed_ignored",
                                        "task": t.idx, "worker": pid})
                            continue
                        # persist the worker's flight-recorder bundle
                        # BEFORE raising: the error message points the
                        # operator at the local reproduction
                        bpath = self._persist_forensics(reply)
                        raise FarmError(
                            f"task {reply.get('task')} failed on worker "
                            f"{pid}:\n{reply.get('error')}"
                            + (f"\nforensics bundle: {bpath}\n"
                               f"  reproduce locally: python -m "
                               f"dryad_tpu_torch.obs replay {bpath}"
                               if bpath else ""))
                    took = time.time() - t.runs.get(pid, time.time())
                    trace.finish(t.spans.pop(pid, None),
                                 won=t.result is None)
                    if t.result is None:
                        t.result = reply["table"]
                        n_done += 1
                        durations.append(took)
                        task_hist.observe(took)
                        done_ev = {"event": "task_done", "task": t.idx,
                                   "worker": pid,
                                   "wall_s": round(took, 3)}
                        if reply.get("rewrites"):
                            # adaptive rewrites the worker applied while
                            # running this task (adapt/); the per-rewrite
                            # graph_rewrite events were forwarded
                            # worker-tagged above
                            done_ev["rewrites"] = reply["rewrites"]
                        if reply.get("launches"):
                            # the kernels this task launched in the
                            # worker (the winning copy's)
                            done_ev["launches"] = reply["launches"]
                        if t.duplicated:
                            # which copy won (straggler metrics —
                            # DrStageStatistics outcome accounting);
                            # keyed on the RECORDED duplicate pid, not
                            # dispatch order: a lost original's runs
                            # entry is popped by worker_lost
                            done_ev["dup_won"] = pid == t.dup_pid
                        self._emit(done_ev)
                    else:
                        ign = {"event": "task_duplicate_ignored",
                               "task": t.idx, "worker": pid}
                        if reply.get("launches"):
                            ign["launches"] = reply["launches"]
                        self._emit(ign)
        return [t.result for t in tasks]
