"""dryad_tpu_torch.obs — the telemetry layer (tracing, metrics, profiling,
analysis), the port of ``dryad_tpu/obs``.

* ``obs.trace``   — the Span API, emitted as ordinary EventLog events so
  one JSONL stream carries everything;
* ``obs.metrics`` — a dependency-free counter/gauge/histogram registry
  with Prometheus text exposition (live at the viewer's ``/metrics``,
  post hoc via ``metrics_from_events``);
* ``obs.profile`` — the resource sampler and the skew / slow-worker
  diagnosis;
* ``obs.analyze`` — EXPLAIN ANALYZE (per-stage actuals against the cost
  model); ``obs.history`` — the job-history archive; ``obs.latency`` —
  phase waterfalls and tail-latency sketches;
* ``obs.chrome`` / ``obs.critical_path`` — exporters / analyzers:
  ``python -m dryad_tpu_torch.obs trace events.jsonl -o trace.json``
  (load in Perfetto) and ``python -m dryad_tpu_torch.obs critical-path
  events.jsonl``.

``obs.flight`` — the worker's flight recorder, its forensics bundles
and their replay (``python -m dryad_tpu_torch.obs replay <bundle>``).
``obs.slo`` — the per-tenant SLO tracker of the job service (not
imported here, as in the JAX package).
"""

from dryad_tpu_torch.obs import flight  # noqa: F401
from dryad_tpu_torch.obs import history  # noqa: F401
from dryad_tpu_torch.obs import profile  # noqa: F401
from dryad_tpu_torch.obs import trace  # noqa: F401
from dryad_tpu_torch.obs.analyze import analyze_events  # noqa: F401
from dryad_tpu_torch.obs.chrome import chrome_trace  # noqa: F401
from dryad_tpu_torch.obs.critical_path import critical_path, \
    render_text  # noqa: F401
from dryad_tpu_torch.obs.flight import capture_bundle, load_bundle, \
    persist_bundle, replay_bundle  # noqa: F401
from dryad_tpu_torch.obs.history import archive_job, \
    history_index  # noqa: F401
from dryad_tpu_torch.obs.metrics import REGISTRY, Registry, \
    metrics_dump, metrics_from_events  # noqa: F401
from dryad_tpu_torch.obs.profile import ResourceSampler, \
    diagnose_events  # noqa: F401
from dryad_tpu_torch.obs.trace import Span, current_ctx, ctx_of, finish, \
    install, span, start, tracing, tracing_enabled  # noqa: F401

__all__ = ["trace", "Span", "span", "start", "finish", "tracing",
           "install", "current_ctx", "ctx_of", "tracing_enabled",
           "REGISTRY", "Registry", "metrics_dump", "metrics_from_events",
           "chrome_trace", "critical_path", "render_text",
           "analyze_events", "flight", "capture_bundle", "persist_bundle",
           "load_bundle", "replay_bundle", "profile", "ResourceSampler",
           "diagnose_events", "history", "archive_job", "history_index"]
