"""Dependency-free metrics registry with Prometheus text exposition —
the port of ``dryad_tpu/obs/metrics.py``'s live half.

A process-global :data:`REGISTRY` the executor and the adaptive manager
increment in place, rendered by :func:`metrics_dump`.  Counters, gauges
and histograms only, with the JAX package's family names, so one
scraper dashboard reads both packages.  Deriving the families from a
recorded event stream (``metrics_from_events``) comes with the rest of
``obs/`` (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
           "FAMILIES", "family_counter", "family_gauge",
           "family_histogram", "metrics_dump"]

_DEF_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                5.0, 10.0, 30.0, 60.0)

# the metric families the port's executor, adaptive manager and
# re-streaming cache count, name and help as in the JAX package's table
FAMILIES = {
    "stage_runs": ("dryad_stage_runs_total", "stage executions"),
    "cap_retries": ("dryad_stage_capacity_retries_total",
                    "capacity-overflow retries"),
    "graph_rewrites": ("dryad_graph_rewrites_total",
                       "adaptive stage-graph rewrites applied"),
    "shuffle_bytes": ("dryad_shuffle_bytes_total",
                      "bytes materialized by stage outputs"),
    "run_seconds": ("dryad_run_seconds_total", "stage run wall"),
    "ooc_cache_hits": ("dryad_ooc_cache_hits_total",
                       "re-streaming cache passes served from the "
                       "local chunk cache"),
    "ooc_cache_writes": ("dryad_ooc_cache_writes_total",
                         "re-streaming cache cold writes"),
}


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


REGISTRY = Registry()


def metrics_dump() -> str:
    """The process-global registry in Prometheus text format."""
    return REGISTRY.render()
