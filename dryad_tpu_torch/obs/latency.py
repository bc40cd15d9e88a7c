"""Tail-latency observability: per-request phase waterfalls, streaming
percentiles, and p99 attribution — the port of
``dryad_tpu/obs/latency.py``.

A request records monotonic phase marks (admission precheck ->
bind/lower -> plan-cache lookup -> queue wait -> dispatch -> compile ->
run -> result fetch) into a :class:`PhaseClock`; on its terminal
transition the clock settles into ONE ``latency_waterfall`` event whose
segments partition the measured submit->result wall EXACTLY, pinned to
integer microseconds so the partition is exact arithmetic.

A :class:`LatencyTracker` folds settled waterfalls into per-tenant /
per-phase :class:`QuantileSketch` percentiles and slowest-request
exemplars, and :func:`latency_from_events` rebuilds the identical
tracker from an archived stream.  The port has no service yet (ROADMAP
Queue 1 item 10.5), so nothing in it records waterfalls; the module is
the library a service and the obs CLI use.
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = ["PHASES", "PhaseClock", "QuantileSketch", "LatencyTracker",
           "latency_from_events", "render_text", "render_waterfall"]

# canonical request-phase order (presentation only — a waterfall lists
# its segments in the order they actually happened, repeats allowed:
# a cold SQL submit legitimately records "bind" twice)
PHASES = ("precheck", "bind", "cache_lookup", "queue", "dispatch",
          "compile", "run", "fetch")


# -- per-request phase marks -------------------------------------------------


class PhaseClock:
    """Monotonic phase marks for ONE service request.

    ``mark(phase)`` ends ``phase`` now: the segment it records runs from
    the previous mark (or the clock's construction — the submit-entry
    instant) to this one.  Segments are pinned to integer microseconds
    as offsets from t0, so consecutive-offset differences telescope and
    ``sum(seg_us) == wall_us`` holds exactly, always.
    """

    __slots__ = ("t0_ns", "_marks", "_lock")

    def __init__(self) -> None:
        self.t0_ns = time.monotonic_ns()
        self._marks: List[Tuple[str, int]] = []
        self._lock = threading.Lock()

    def mark(self, phase: str) -> None:
        with self._lock:
            self._marks.append((str(phase), time.monotonic_ns()))

    def mark_once(self, phase: str) -> None:
        """``mark``, but a no-op if ``phase`` was already marked — the
        fleet paths use this so a multi-task job's repeated dispatches
        don't carve its run wall into bogus dispatch segments."""
        with self._lock:
            if any(p == phase for p, _ in self._marks):
                return
            self._marks.append((str(phase), time.monotonic_ns()))

    def segments(self) -> Tuple[List[Tuple[str, int]], int]:
        """``([(phase, us)], wall_us)`` — an exact partition of
        t0 → last mark in integer microseconds."""
        with self._lock:
            marks = list(self._marks)
        out: List[Tuple[str, int]] = []
        prev_us = 0
        for phase, t in marks:
            off_us = (t - self.t0_ns) // 1000
            out.append((phase, int(off_us - prev_us)))
            prev_us = off_us
        return out, int(prev_us)

    def waterfall(self, job: Optional[str] = None,
                  tenant: Optional[str] = None,
                  app: Optional[str] = None, ok: bool = True,
                  compile_s: float = 0.0,
                  trace: Optional[str] = None) -> Dict[str, Any]:
        """Settle the clock into a ``latency_waterfall`` record.

        ``compile_s`` (the per-stage compile wall ``exec/recovery.py``
        already settles into ``stage_done`` events) is carved OUT of the
        run segment into its own "compile" segment — the carve moves
        microseconds between two segments, so the exact partition is
        preserved by construction.
        """
        segs, wall_us = self.segments()
        if compile_s and compile_s > 0:
            for i in range(len(segs) - 1, -1, -1):
                if segs[i][0] == "run":
                    carve = min(segs[i][1], int(compile_s * 1e6))
                    if carve > 0:
                        segs[i] = ("run", segs[i][1] - carve)
                        segs.insert(i, ("compile", carve))
                    break
        wf: Dict[str, Any] = {"event": "latency_waterfall",
                              "ok": bool(ok), "wall_us": wall_us,
                              "wall_s": round(wall_us / 1e6, 6),
                              "phases": [{"phase": p, "us": u}
                                         for p, u in segs]}
        if job is not None:
            wf["job"] = job
        if tenant is not None:
            wf["tenant"] = tenant
        if app is not None:
            wf["app"] = app
        if trace:
            wf["trace"] = trace
        return wf


# -- streaming percentiles ---------------------------------------------------


def _geometric_bounds(lo: float = 0.001, hi: float = 120.0,
                      ratio: float = 1.25) -> Tuple[float, ...]:
    out = [lo]
    while out[-1] < hi:
        out.append(out[-1] * ratio)
    return tuple(out)


SKETCH_BOUNDS = _geometric_bounds()


class QuantileSketch:
    """Dependency-free fixed-bucket streaming quantile estimate.

    Geometric bucket bounds (ratio 1.25, 1ms..120s by default): within
    the covered range a quantile estimate lands in the true value's
    bucket, so relative error is bounded by the bucket ratio (≤ 25%),
    tightened by linear interpolation inside the bucket and clamping to
    the observed min/max.  Deterministic: the same observation stream
    always yields bit-identical estimates (the re-derivation contract).
    """

    __slots__ = ("bounds", "counts", "count", "total", "vmin", "vmax")

    def __init__(self, bounds: Tuple[float, ...] = SKETCH_BOUNDS):
        self.bounds = tuple(bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.total = 0.0
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None

    def observe(self, v: float) -> None:
        v = max(0.0, float(v))
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.total += v
        self.vmin = v if self.vmin is None else min(self.vmin, v)
        self.vmax = v if self.vmax is None else max(self.vmax, v)

    def quantile(self, q: float) -> float:
        if self.count == 0:
            return 0.0
        target = min(1.0, max(0.0, float(q))) * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = (self.bounds[i] if i < len(self.bounds)
                      else (self.vmax if self.vmax is not None
                            else self.bounds[-1]))
                frac = (target - cum) / c
                est = lo + frac * (hi - lo)
                if self.vmin is not None:
                    est = max(est, self.vmin)
                if self.vmax is not None:
                    est = min(est, self.vmax)
                return est
            cum += c
        return self.vmax or 0.0

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


# -- live aggregation + exemplars --------------------------------------------


class _TenantLatency:
    __slots__ = ("sketch", "phase_us", "phase_sketch", "exemplars",
                 "n_ok", "n_fail")

    def __init__(self, window: int):
        self.sketch = QuantileSketch()
        self.phase_us: Dict[str, int] = {}
        self.phase_sketch: Dict[str, QuantileSketch] = {}
        self.exemplars: deque = deque(maxlen=window)
        self.n_ok = 0
        self.n_fail = 0


def _phase_order(name: str) -> Tuple[int, str]:
    return (PHASES.index(name) if name in PHASES else len(PHASES), name)


class LatencyTracker:
    """Per-tenant tail-latency aggregation over settled waterfalls.

    Thread-safe; ``registry`` (the daemon passes the live one) receives
    ``dryad_request_seconds`` Histogram observations per tenant and per
    (tenant, phase).  Keeps the last ``window`` requests' (job id, trace
    id, dominant phase) per tenant — ``snapshot()``'s exemplar is the
    slowest of the window, the "what do I click for p99" link.
    """

    def __init__(self, window: int = 64, registry=None):
        self._lock = threading.Lock()
        self._tenants: Dict[str, _TenantLatency] = {}
        self.window = int(window)
        self._registry = registry

    def record(self, wf: Dict[str, Any]) -> None:
        if not wf or wf.get("event") != "latency_waterfall":
            return
        tenant = str(wf.get("tenant") or "?")
        wall_us = int(wf.get("wall_us") or 0)
        wall_s = wall_us / 1e6
        agg: Dict[str, int] = {}
        for p in wf.get("phases") or []:
            name = str(p.get("phase", "?"))
            agg[name] = agg.get(name, 0) + int(p.get("us") or 0)
        dominant = max(agg, key=agg.get) if agg else None
        with self._lock:
            st = self._tenants.get(tenant)
            if st is None:
                st = self._tenants[tenant] = _TenantLatency(self.window)
            st.sketch.observe(wall_s)
            if wf.get("ok", True):
                st.n_ok += 1
            else:
                st.n_fail += 1
            for name, us in agg.items():
                st.phase_us[name] = st.phase_us.get(name, 0) + us
                sk = st.phase_sketch.get(name)
                if sk is None:
                    sk = st.phase_sketch[name] = QuantileSketch()
                sk.observe(us / 1e6)
            st.exemplars.append({"job": wf.get("job"),
                                 "trace": wf.get("trace"),
                                 "wall_us": wall_us,
                                 "dominant": dominant})
        if self._registry is not None:
            from dryad_tpu_torch.obs.metrics import family_histogram
            family_histogram(self._registry, "request_seconds",
                             tenant=tenant).observe(wall_s)
            for name, us in agg.items():
                family_histogram(self._registry, "request_seconds",
                                 tenant=tenant,
                                 phase=name).observe(us / 1e6)

    def _row(self, tenant: str, st: _TenantLatency) -> Dict[str, Any]:
        total_us = sum(st.phase_us.values())
        phases = []
        for name in sorted(st.phase_us, key=_phase_order):
            us = st.phase_us[name]
            phases.append({"phase": name,
                           "total_s": round(us / 1e6, 6),
                           "share": round(us / total_us, 4)
                           if total_us else 0.0,
                           "p95_s": round(
                               st.phase_sketch[name].quantile(0.95), 6)})
        dominant = (max(st.phase_us, key=st.phase_us.get)
                    if st.phase_us else None)
        ex = (max(st.exemplars, key=lambda r: r["wall_us"])
              if st.exemplars else None)
        if ex is not None:
            ex = dict(ex)
            ex["wall_s"] = round(ex.pop("wall_us") / 1e6, 6)
        sk = st.sketch
        return {"tenant": tenant, "count": sk.count, "ok": st.n_ok,
                "failed": st.n_fail,
                "p50_s": round(sk.quantile(0.50), 6),
                "p95_s": round(sk.quantile(0.95), 6),
                "p99_s": round(sk.quantile(0.99), 6),
                "mean_s": round(sk.mean, 6),
                "max_s": round(sk.vmax or 0.0, 6),
                "dominant": dominant, "phases": phases, "exemplar": ex}

    def row(self, tenant: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            st = self._tenants.get(tenant)
            return self._row(tenant, st) if st is not None else None

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {t: self._row(t, st)
                    for t, st in sorted(self._tenants.items())}


def latency_from_events(events: Iterable[Dict[str, Any]],
                        window: int = 64,
                        registry=None) -> LatencyTracker:
    """Rebuild a :class:`LatencyTracker` from recorded events (history
    archives, per-job JSONLs) — the post-hoc mirror of the daemon's
    live tracker.  Folding the same ``latency_waterfall`` records in
    the same order yields a bit-identical snapshot."""
    from dryad_tpu_torch.utils.events import EventLog
    if isinstance(events, EventLog):
        events = events.events
    tr = LatencyTracker(window=window, registry=registry)
    for e in events:
        if isinstance(e, dict) and e.get("event") == "latency_waterfall":
            tr.record(e)
    return tr


# -- rendering ---------------------------------------------------------------


def render_waterfall(wf: Dict[str, Any], width: int = 40) -> str:
    """ASCII bar chart for one ``latency_waterfall`` record."""
    wall_us = max(1, int(wf.get("wall_us") or 0))
    lines = [f"job={wf.get('job', '?')} tenant={wf.get('tenant', '?')} "
             f"wall={wf.get('wall_s')}s ok={wf.get('ok', True)}"
             + (f" trace={wf['trace']}" if wf.get("trace") else "")]
    for p in wf.get("phases") or []:
        us = int(p.get("us") or 0)
        bar = "#" * max(1 if us else 0, round(width * us / wall_us))
        lines.append(f"  {p.get('phase', '?'):<12} {us / 1e6:>9.4f}s "
                     f"{100.0 * us / wall_us:>5.1f}%  {bar}")
    lines.append(f"  {'total':<12} {wall_us / 1e6:>9.4f}s")
    return "\n".join(lines)


def render_text(tracker) -> str:
    """Per-tenant percentile + phase-attribution table (the CLI/daemon
    text view of ``snapshot()``)."""
    snap = (tracker.snapshot() if isinstance(tracker, LatencyTracker)
            else dict(tracker))
    lines = [f"{'tenant':<14} {'n':>5} {'p50_s':>8} {'p95_s':>8} "
             f"{'p99_s':>8} {'max_s':>8}  dominant"]
    for tenant, r in snap.items():
        lines.append(f"{tenant:<14} {r['count']:>5} {r['p50_s']:>8.3f} "
                     f"{r['p95_s']:>8.3f} {r['p99_s']:>8.3f} "
                     f"{r['max_s']:>8.3f}  {r['dominant'] or '-'}")
        for ph in r["phases"]:
            lines.append(f"    {ph['phase']:<12} {ph['total_s']:>9.3f}s "
                         f"{100.0 * ph['share']:>5.1f}%  "
                         f"p95 {ph['p95_s']:.3f}s")
        ex = r.get("exemplar")
        if ex:
            lines.append(f"    slowest: job={ex.get('job')} "
                         f"wall={ex.get('wall_s')}s "
                         f"dominant={ex.get('dominant')} "
                         f"trace={ex.get('trace') or '-'}")
    return "\n".join(lines)
