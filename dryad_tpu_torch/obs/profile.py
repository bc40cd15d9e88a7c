"""Continuous resource profiling + sibling-relative diagnosis — the port
of ``dryad_tpu/obs/profile.py``.

Two pieces, both feeding the ONE JSONL event stream:

* :class:`ResourceSampler` — a background thread emitting periodic
  ``resource_sample`` events (RSS, CPU%, the run's device bytes, gc
  counts) while a Run computes.  One sample is taken at start and one
  at stop, so even a millisecond run leaves a record, and ``stop()``
  joins the thread, so none outlives its run.  ``device_bytes`` is
  ``torch.cuda.memory_allocated`` of the run's CUDA device, read only
  when CUDA is already initialized: a sampler never initializes CUDA and
  never synchronizes.  A CPU run's samples carry no ``device_bytes``
  (the JAX package counts its live arrays there; the port reports no
  device figure from the host).
* :func:`diagnose_events` — data skew (one partition holding >=
  ``skew_factor`` x the rows of its sibling median, from ``stage_done``
  per-partition rows) and slow workers (from ``task_done``, which the
  port emits once it has workers), as ``diagnosis_skew`` /
  ``diagnosis_slow_worker`` records.

Everything is best-effort: a failed sample never fails the job (the
same contract as spans, ``obs/trace.py``).
"""

from __future__ import annotations

import gc
import os
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from dryad_tpu_torch.adapt.thresholds import (SKEW_SIBLING_MEDIAN_FACTOR,
                                              sibling_median, skew_ratio)

__all__ = ["ResourceSampler", "start", "stop", "sample_now",
           "diagnose_events"]


def _rss_bytes() -> Optional[int]:
    """Resident set size: /proc on Linux, ru_maxrss (peak) fallback."""
    try:
        with open(f"/proc/{os.getpid()}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    try:
        import resource
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        # Linux reports KiB, macOS bytes; both are an upper bound here
        return rss * 1024 if rss < 1 << 40 else rss
    except Exception:
        return None


def _device_bytes(device) -> Optional[int]:
    """Bytes the caching allocator holds for tensors on ``device`` (a
    CUDA device), or None: a CPU device, or CUDA not initialized yet
    (reading would initialize it)."""
    try:
        if device is None or torch.device(device).type != "cuda" \
                or not torch.cuda.is_initialized():
            return None
        return int(torch.cuda.memory_allocated(device))
    except Exception:
        return None


def sample_now(cpu_prev: Optional[tuple] = None, *, device=None,
               **tags: Any) -> Dict[str, Any]:
    """One ``resource_sample`` event.  ``cpu_prev`` is the previous
    ``(wall, cpu_seconds)`` pair for the CPU%% delta (None on the first
    sample); ``device`` the run's device (``device_bytes``)."""
    e: Dict[str, Any] = {"event": "resource_sample", **tags}
    rss = _rss_bytes()
    if rss is not None:
        e["rss_bytes"] = rss
    dev = _device_bytes(device)
    if dev is not None:
        e["device_bytes"] = dev
    t = os.times()
    now, cpu = time.time(), t.user + t.system
    if cpu_prev is not None and now > cpu_prev[0]:
        e["cpu_pct"] = round(100.0 * (cpu - cpu_prev[1])
                             / (now - cpu_prev[0]), 1)
    e["_cpu_state"] = (now, cpu)    # stripped by the sampler before emit
    e["gc_counts"] = list(gc.get_count())
    return e


class ResourceSampler:
    """Background ``resource_sample`` emitter; ``start()``/``stop()``
    bracket the profiled scope.  The sink is any event callable (an
    EventLog, a Run's job-tagging sink)."""

    def __init__(self, sink, interval_s: float, *, device=None,
                 **tags: Any):
        self._sink = sink
        self._device = device
        self._interval = max(float(interval_s), 0.01)
        self._tags = tags
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._cpu_prev: Optional[tuple] = None

    def _emit_one(self) -> None:
        try:
            e = sample_now(self._cpu_prev, device=self._device,
                           **self._tags)
            self._cpu_prev = e.pop("_cpu_state", None)
            self._sink(e)
        except Exception:
            pass                  # telemetry must never fail the job

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            self._emit_one()

    def start(self) -> "ResourceSampler":
        self._emit_one()          # guarantee >=1 sample per scope
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="dryad-resource-sampler")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            # the loop wakes at once on the set event: the join returns
            # within one sample's work
            self._thread.join()
            self._thread = None
        self._emit_one()          # final reading at scope end


def start(sink, interval_s: float, *, device=None, **tags: Any
          ) -> Optional[ResourceSampler]:
    """Gated constructor: None (no sampler, zero threads) when there is
    no sink, sampling is disabled (``interval_s <= 0``), or the sink's
    explicit verbosity level filters level-2 events anyway — the same
    no-consumer-means-no-work contract spans follow (obs/trace.py)."""
    if sink is None or not interval_s or interval_s <= 0:
        return None
    lvl = getattr(sink, "level", None)
    if isinstance(lvl, int) and lvl < 2:
        return None
    return ResourceSampler(sink, interval_s, device=device,
                           **tags).start()


def stop(sampler: Optional[ResourceSampler]) -> None:
    """None-safe stop."""
    if sampler is not None:
        sampler.stop()


# -- sibling-relative diagnosis ----------------------------------------------

def diagnose_events(events, skew_factor: float = SKEW_SIBLING_MEDIAN_FACTOR,
                    slow_factor: float = 2.0,
                    min_tasks: int = 2) -> List[Dict[str, Any]]:
    """Skew / slow-worker findings from a recorded event stream.

    The skew threshold is the SHARED constant
    ``adapt.thresholds.SKEW_SIBLING_MEDIAN_FACTOR`` — the same multiple
    the adaptive runtime ACTS on (``adapt/rules.SkewRepartition``), so a
    flagged partition is exactly one an adaptive run would have
    repartitioned for, and vice versa.

    Returns event-shaped records (kinds ``diagnosis_skew`` and
    ``diagnosis_slow_worker``); callers may render them
    (``viewer.diagnose``) or archive them (``obs/history``)."""
    out: List[Dict[str, Any]] = []
    # data skew: one partition >= skew_factor x the sibling median of
    # per-partition row counts (rows x fixed row width = bytes, so the
    # row ratio IS the bytes ratio for a columnar stage output)
    worst: Dict[Any, Dict[str, Any]] = {}
    for e in events:
        if e.get("event") != "stage_done":
            continue
        rows = e.get("rows")
        if not isinstance(rows, list) or len(rows) < 2:
            continue
        rows = [int(r) for r in rows]
        peak = max(rows)
        # the SHARED median/ratio math (adapt/thresholds.py): detection
        # here and action (adapt/rules.SkewRepartition via
        # StageStats.is_skewed) must compute the same number
        med = sibling_median(rows)
        ratio = skew_ratio(rows)
        if ratio < skew_factor or peak < 2:
            continue
        rec = {"event": "diagnosis_skew", "stage": e.get("stage"),
               "label": e.get("label", "?"),
               "partition": rows.index(peak), "rows_max": peak,
               "rows_sibling_median": med,
               "ratio": round(ratio, 1)}
        prev = worst.get(e.get("stage"))
        if prev is None or rec["ratio"] > prev["ratio"]:
            worst[e.get("stage")] = rec
    out.extend(worst[k] for k in sorted(worst, key=str))
    # slow workers: mean task wall vs the median of the other workers'
    # means (the farm's sibling-relative straggler evidence, post-hoc)
    walls: Dict[Any, List[float]] = {}
    for e in events:
        if e.get("event") == "task_done" and e.get("wall_s") is not None \
                and e.get("worker") is not None:
            walls.setdefault(e["worker"], []).append(float(e["wall_s"]))
    if len(walls) >= 2:
        means = {w: sum(v) / len(v) for w, v in walls.items()}
        for w, m in sorted(means.items(), key=str):
            if len(walls[w]) < min_tasks:
                continue
            sib = sorted(v for k, v in means.items() if k != w)
            med = sib[len(sib) // 2]
            if med > 0 and m >= slow_factor * med:
                out.append({"event": "diagnosis_slow_worker", "worker": w,
                            "tasks": len(walls[w]),
                            "mean_s": round(m, 3),
                            "sibling_median_s": round(med, 3),
                            "ratio": round(m / med, 1)})
    return out
