"""Dependency-free metrics registry with Prometheus text exposition —
the port of ``dryad_tpu/obs/metrics.py``.

Two views of one set of families:

* a process-global :data:`REGISTRY` the executor, the adaptive manager
  and the re-streaming cache increment in place, rendered by
  :func:`metrics_dump` (and served at the live viewer's ``/metrics``);
  ``Registry.snapshot`` is the flat dict ``job_done`` carries;
* :func:`metrics_from_events` — the same families RE-DERIVED from a
  recorded EventLog stream, so a process that holds only the JSONL
  (the viewer, ``python -m dryad_tpu_torch.obs metrics``) exposes them
  too.

The family table is the JAX package's whole (names and help text), so
one scraper dashboard reads both packages; nothing in the port counts
the families of layers it does not have yet (the task farm, the
service, continuous queries).  Counters, gauges and histograms only;
no client library.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
           "FAMILIES", "PER_JOB_FAMILIES", "family_counter",
           "family_gauge", "family_histogram", "metrics_dump",
           "metrics_from_events"]

_DEF_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                5.0, 10.0, 30.0, 60.0)

# canonical metric families: name + help defined ONCE, shared by the
# live instrumentation (executor/farm/compile_cache) and the
# event-derived mirror below — a rename on one side cannot silently
# diverge /metrics between a viewer that ran the job and one that only
# holds the JSONL
FAMILIES = {
    "tasks": ("dryad_farm_tasks_total", "completed farm tasks"),
    "straggler_dups": ("dryad_farm_straggler_duplicates_total",
                       "speculative duplicates by outcome"),
    "spec_launches": ("dryad_farm_speculative_launches_total",
                      "straggler duplicates dispatched"),
    "task_retries": ("dryad_farm_task_retries_total",
                     "task re-dispatches by cause"),
    "task_seconds": ("dryad_task_seconds", "farm task wall"),
    "queue_depth": ("dryad_farm_queue_depth",
                    "tasks awaiting dispatch"),
    "stage_runs": ("dryad_stage_runs_total", "stage executions"),
    "cap_retries": ("dryad_stage_capacity_retries_total",
                    "capacity-overflow retries"),
    "stage_replays": ("dryad_stage_replays_total", "lineage replays"),
    "graph_rewrites": ("dryad_graph_rewrites_total",
                       "adaptive stage-graph rewrites applied"),
    "shuffle_bytes": ("dryad_shuffle_bytes_total",
                      "bytes materialized by stage outputs"),
    "compile_seconds": ("dryad_compile_seconds_total",
                        "stage-program compile wall"),
    "run_seconds": ("dryad_run_seconds_total", "stage run wall"),
    "cache_hits": ("dryad_compile_cache_hits_total",
                   "compiled-stage cache hits"),
    "cache_misses": ("dryad_compile_cache_misses_total",
                     "compiled-stage cache misses"),
    "persistent_cache": ("dryad_persistent_compile_cache_enabled",
                         "1 when the on-disk XLA cache is active"),
    "tee_spills": ("dryad_stream_tee_spills_total",
                   "stream Tee spills"),
    "ooc_cache_hits": ("dryad_ooc_cache_hits_total",
                       "re-streaming cache passes served from the "
                       "local chunk cache"),
    "ooc_cache_writes": ("dryad_ooc_cache_writes_total",
                         "re-streaming cache cold writes"),
    "prefetch_stalls": ("dryad_ooc_prefetch_stalls_total",
                        "chunk-prefetch stalls (host IO was the "
                        "bottleneck)"),
    "inc_refreshes": ("dryad_inc_refreshes_total",
                      "standing-query refreshes committed"),
    "inc_fallbacks": ("dryad_inc_fallbacks_total",
                      "standing-query refreshes that fell back to a "
                      "full re-run"),
    "jobs": ("dryad_jobs_total", "completed jobs"),
    "jobs_failed": ("dryad_jobs_failed_total", "failed jobs"),
    "job_progress": ("dryad_job_progress_ratio",
                     "per-job progress fraction (settled stages or "
                     "tasks over total, 0..1)"),
    "slo_attainment": ("dryad_slo_attainment_ratio",
                       "rolling fraction of a tenant's jobs meeting "
                       "its SLO"),
    "slo_burn": ("dryad_slo_burn_rate",
                 "SLO error-budget burn rate (>1 = burning faster "
                 "than the objective allows)"),
    "io_requests": ("dryad_io_requests_total",
                    "IO provider operations"),
    "io_bytes": ("dryad_io_bytes_total", "IO provider bytes moved"),
    "io_seconds": ("dryad_io_seconds_total", "IO provider wall"),
    # semantic cross-job reuse (analysis/canon.py + service/daemon.py):
    # DTA501 plan-cache hits keyed on the semantic fingerprint, and
    # cold scans avoided by the shared scan registry
    "plan_reuse": ("dryad_semantic_plan_reuse_total",
                   "semantic plan-cache hits (DTA501: equivalent "
                   "query served from the fingerprint-keyed cache)"),
    "scan_shared": ("dryad_scan_shares_total",
                    "cold scans avoided by the shared scan registry "
                    "(concurrent/queued jobs over one table)"),
    # tail-latency observability (obs/latency.py): submit->result wall
    # per tenant (and per tenant+phase when the phase label is set),
    # and the measured admission-queue wait (enqueue stamp -> first
    # dispatch stamp) — the autoscaling signal
    "request_seconds": ("dryad_request_seconds",
                        "service request submit->result wall "
                        "(per tenant; phase label = one waterfall "
                        "segment's share)"),
    "queue_wait": ("dryad_queue_wait_seconds",
                   "admission queue wait, enqueue to first dispatch"),
    # durable service (service/durable): what one journal replay did
    # with the jobs it found (outcome = resumed | readmitted | failed),
    # and how long the whole recovery pass took
    "jobs_recovered": ("dryad_jobs_recovered_total",
                       "jobs restored by journal replay, by outcome"),
    "recovery_seconds": ("dryad_recovery_seconds",
                         "wall of the last journal-replay recovery "
                         "pass"),
}


# families the runtime ALSO exposes with a per-job label when a job id
# is known (the multi-tenant service labels its live instrumentation and
# metrics_from_events(by_job=True) groups the derived mirror the same
# way).  Every key must exist in FAMILIES — drift-tested so a renamed
# family cannot silently lose its per-job view.
PER_JOB_FAMILIES = ("queue_depth", "task_seconds", "graph_rewrites",
                    "cache_hits", "cache_misses", "tasks", "jobs",
                    "jobs_failed", "stage_runs", "shuffle_bytes",
                    "compile_seconds", "run_seconds", "job_progress")


def family_counter(reg: "Registry", key: str, **labels) -> "Counter":
    """Get-or-create the canonical counter family ``key`` on ``reg``."""
    name, help_ = FAMILIES[key]
    return reg.counter(name, help_, **labels)


def family_gauge(reg: "Registry", key: str, **labels) -> "Gauge":
    name, help_ = FAMILIES[key]
    return reg.gauge(name, help_, **labels)


def family_histogram(reg: "Registry", key: str, **labels) -> "Histogram":
    name, help_ = FAMILIES[key]
    return reg.histogram(name, help_, **labels)


def _fmt(v: float) -> str:
    """Prometheus number formatting: integers without the trailing .0."""
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _esc(v: Any) -> str:
    return (str(v).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _label_str(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{_esc(v)}"' for k, v in labels) + "}"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_: str,
                 labels: Tuple[Tuple[str, str], ...]):
        self.name, self.help, self.labels = name, help_, labels
        self._lock = threading.Lock()

    def sample_lines(self) -> List[str]:  # pragma: no cover - abstract
        raise NotImplementedError


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name, help_, labels):
        super().__init__(name, help_, labels)
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self.value += n

    def sample_lines(self) -> List[str]:
        return [f"{self.name}{_label_str(self.labels)} {_fmt(self.value)}"]


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name, help_, labels):
        super().__init__(name, help_, labels)
        self.value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    def sample_lines(self) -> List[str]:
        return [f"{self.name}{_label_str(self.labels)} {_fmt(self.value)}"]


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help_, labels, buckets=None):
        super().__init__(name, help_, labels)
        self.buckets = tuple(sorted(buckets or _DEF_BUCKETS))
        self.counts = [0] * len(self.buckets)
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        with self._lock:
            self.count += 1
            self.sum += v
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self.counts[i] += 1

    def sample_lines(self) -> List[str]:
        out = []
        base = list(self.labels)
        # bucket counts are kept cumulative by observe() (every bucket
        # with v <= le increments), matching the exposition contract
        for b, c in zip(self.buckets, self.counts):
            lbl = _label_str(tuple(base + [("le", _fmt(b))]))
            out.append(f"{self.name}_bucket{lbl} {c}")
        lbl = _label_str(tuple(base + [("le", "+Inf")]))
        out.append(f"{self.name}_bucket{lbl} {self.count}")
        out.append(f"{self.name}_sum{_label_str(self.labels)} "
                   f"{_fmt(self.sum)}")
        out.append(f"{self.name}_count{_label_str(self.labels)} "
                   f"{self.count}")
        return out


class Registry:
    """Name+labels-keyed metric store; get-or-create accessors so call
    sites never pre-register."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: "Dict[Tuple[str, tuple], _Metric]" = {}

    def _get(self, cls, name: str, help_: str, labels: Dict[str, Any],
             **kw) -> _Metric:
        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, help_, key[1], **kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name} already registered as "
                                f"{m.kind}")
            return m

    def counter(self, name: str, help_: str = "", **labels) -> Counter:
        return self._get(Counter, name, help_, labels)

    def gauge(self, name: str, help_: str = "", **labels) -> Gauge:
        return self._get(Gauge, name, help_, labels)

    def histogram(self, name: str, help_: str = "",
                  buckets: Optional[Iterable[float]] = None,
                  **labels) -> Histogram:
        return self._get(Histogram, name, help_, labels, buckets=buckets)

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()

    def prune(self, **labels) -> int:
        """Drop every metric whose label set contains all of ``labels``
        (e.g. ``prune(job=jid)``); returns the number removed.  A
        persistent multi-job process (the service daemon) retires a
        terminal job's per-job series with this so unique job-id labels
        cannot grow the registry without bound."""
        want = {(k, str(v)) for k, v in labels.items()}
        with self._lock:
            dead = [key for key in self._metrics
                    if want <= set(key[1])]
            for key in dead:
                del self._metrics[key]
        return len(dead)

    def merge_from(self, other: "Registry") -> "Registry":
        """Copy families from ``other`` that this registry does not
        already hold (event-derived metrics win over live ones, so a
        viewer that both recorded and ran never double-counts)."""
        with other._lock:
            theirs = dict(other._metrics)
        with self._lock:
            for key, m in theirs.items():
                self._metrics.setdefault(key, m)
        return self

    def render(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        with self._lock:
            metrics = sorted(self._metrics.items())
        out: List[str] = []
        seen_family = set()
        for (name, _labels), m in metrics:
            if name not in seen_family:
                seen_family.add(name)
                if m.help:
                    out.append(f"# HELP {name} {m.help}")
                out.append(f"# TYPE {name} {m.kind}")
            out.extend(m.sample_lines())
        return "\n".join(out) + ("\n" if out else "")

    def snapshot(self) -> Dict[str, Any]:
        """Flat {name{labels}: value} dict — what job_done embeds."""
        with self._lock:
            metrics = sorted(self._metrics.items())
        out: Dict[str, Any] = {}
        for (name, labels), m in metrics:
            key = name + _label_str(labels)
            if isinstance(m, Histogram):
                out[key] = {"count": m.count, "sum": round(m.sum, 6)}
            else:
                out[key] = round(m.value, 6)
        return out


REGISTRY = Registry()


def metrics_dump() -> str:
    """The process-global registry in Prometheus text format."""
    return REGISTRY.render()


def metrics_from_events(events, registry: Optional[Registry] = None,
                        by_job: bool = False) -> Registry:
    """Derive the counter families from a recorded event stream (the
    post-hoc path: a viewer holding only the JSONL).  Families mirror
    the live instrumentation so scrape dashboards work on either.

    ``by_job=True`` additionally GROUPS the :data:`PER_JOB_FAMILIES` by
    each event's ``job`` tag (the per-job namespacing the service daemon
    stamps on every event) — events without a tag keep the unlabeled
    family, so single-job streams render unchanged."""
    r = registry or Registry()

    def C(key: str, e: dict, **labels) -> Counter:
        if (by_job and key in PER_JOB_FAMILIES
                and e.get("job") is not None):
            labels["job"] = str(e["job"])
        return family_counter(r, key, **labels)

    def H(key: str, e: dict) -> Histogram:
        if (by_job and key in PER_JOB_FAMILIES
                and e.get("job") is not None):
            return family_histogram(r, key, job=str(e["job"]))
        return family_histogram(r, key)

    for e in events:
        k = e.get("event")
        if k == "task_done":
            C("tasks", e).inc()
            if e.get("wall_s") is not None:
                H("task_seconds", e).observe(e["wall_s"])
            if "dup_won" in e:
                family_counter(r, "straggler_dups",
                               result="won" if e["dup_won"] else "lost"
                               ).inc()
        elif k == "task_duplicated":
            family_counter(r, "spec_launches").inc()
        elif k in ("task_reassigned", "task_timeout",
                   "worker_ping_timeout"):
            family_counter(r, "task_retries", reason=k).inc()
        elif k in ("stage_done", "stream_stage_done"):
            C("stage_runs", e).inc()
            if e.get("overflow"):
                family_counter(r, "cap_retries").inc()
            if e.get("out_bytes"):
                C("shuffle_bytes", e).inc(e["out_bytes"])
            if e.get("compile_s"):
                C("compile_seconds", e).inc(e["compile_s"])
            if e.get("wall_s"):
                C("run_seconds", e).inc(e["wall_s"])
            if "cache_hit" in e:
                C("cache_hits", e).inc(1 if e["cache_hit"] else 0)
                C("cache_misses", e).inc(0 if e["cache_hit"] else 1)
        elif k in ("stage_replay", "settle_replay"):
            family_counter(r, "stage_replays").inc()
        elif k == "graph_rewrite":
            C("graph_rewrites", e,
              rule=e.get("rule", "?"), kind=e.get("kind", "?")).inc()
        elif k == "stream_tee_spill":
            family_counter(r, "tee_spills").inc()
        elif k == "ooc_cache_hit":
            family_counter(r, "ooc_cache_hits").inc()
        elif k == "ooc_cache_write":
            family_counter(r, "ooc_cache_writes").inc()
        elif k == "prefetch_stall":
            family_counter(r, "prefetch_stalls").inc(
                int(e.get("stalls", 1)))
        elif k == "inc_refresh":
            family_counter(r, "inc_refreshes").inc()
        elif k == "inc_fallback_rescan":
            family_counter(r, "inc_fallbacks").inc()
        elif k == "latency_waterfall":
            # derived mirror of the daemon's live LatencyTracker feed
            # (+ the queue-wait histogram admission measures live; here
            # it re-derives from the waterfall's queue segment)
            tenant = str(e.get("tenant") or "?")
            if e.get("wall_us") is not None:
                family_histogram(r, "request_seconds", tenant=tenant
                                 ).observe(int(e["wall_us"]) / 1e6)
            agg: Dict[str, int] = {}
            for p in e.get("phases") or []:
                name = str(p.get("phase", "?"))
                agg[name] = agg.get(name, 0) + int(p.get("us") or 0)
            for name, us in agg.items():
                family_histogram(r, "request_seconds", tenant=tenant,
                                 phase=name).observe(us / 1e6)
            if "queue" in agg:
                family_histogram(r, "queue_wait", tenant=tenant
                                 ).observe(agg["queue"] / 1e6)
        elif k == "job_done":
            C("jobs", e).inc()
        elif k == "job_failed":
            C("jobs_failed", e).inc()
        elif k in ("job_resumed", "job_readmitted"):
            # derived mirror of recovery's live jobs_recovered counter
            # (recover.py counts fail-with-forensics under job_failed's
            # own record, so only the two success outcomes appear here)
            family_counter(r, "jobs_recovered",
                           outcome=("resumed" if k == "job_resumed"
                                    else "readmitted")).inc()
        elif k == "journal_replay":
            if e.get("wall_s") is not None:
                family_gauge(r, "recovery_seconds"
                             ).set(float(e["wall_s"]))
        elif k == "progress" and e.get("pct") is not None:
            # the derived mirror of the service's live progress gauge:
            # the LAST progress record wins (gauge semantics)
            labels = ({"job": str(e["job"])}
                      if by_job and e.get("job") is not None else {})
            family_gauge(r, "job_progress",
                         **labels).set(float(e["pct"]) / 100.0)
        elif k == "span" and e.get("kind") == "io":
            a = e.get("attrs") or {}
            op = e.get("name", "io")
            family_counter(r, "io_requests", op=op).inc()
            if a.get("bytes"):
                family_counter(r, "io_bytes", op=op).inc(a["bytes"])
            if e.get("dur_s"):
                family_counter(r, "io_seconds", op=op).inc(e["dur_s"])
    return r
