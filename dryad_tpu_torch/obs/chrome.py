"""Chrome trace-event exporter: EventLog span events -> Perfetto — the port
of ``dryad_tpu/obs/chrome.py``.

``python -m dryad_tpu_torch.obs trace events.jsonl -o trace.json``
converts the ``"span"`` records of an EventLog JSONL stream into the
Chrome trace-event JSON format (load the output at
https://ui.perfetto.dev).  Spans become complete ("ph": "X") events; the
process lane is the emitting worker (driver = pid 0), and overlapping
spans within a process are laid out on greedily-allocated tracks.
``resource_sample`` events (obs/profile.py) become per-process COUNTER
tracks ("ph": "C"): memory (RSS + device MiB) and CPU%.
``graph_rewrite`` events (dryad_tpu_torch/adapt) render as instant
events ("ph": "i") on the emitting process's lane, marking the moments
the running DAG changed shape.  The device's own timeline is the
``JobConfig.profile_dir`` trace (``exec/executor.py``).
"""

from __future__ import annotations

from typing import Any, Dict, List

__all__ = ["chrome_trace"]


def _pid_of(e: Dict[str, Any]) -> int:
    """Process lane: forwarded worker events carry a ``worker`` tag;
    worker-side emitters also self-tag ``worker_pid``; driver-emitted
    events (all of the port's, which has no workers yet) carry
    neither."""
    w = e.get("worker")
    if w is None:
        w = e.get("worker_pid")
    if w is None:
        w = (e.get("attrs") or {}).get("worker_pid")
    try:
        return int(w) + 1 if w is not None else 0
    except (TypeError, ValueError):
        return 0


def chrome_trace(events) -> Dict[str, Any]:
    """Build the Chrome trace dict from an event iterable."""
    events = list(events)
    spans = [e for e in events
             if e.get("event") == "span" and e.get("t0") is not None
             and e.get("dur_s") is not None]
    samples = [e for e in events
               if e.get("event") == "resource_sample"
               and e.get("ts") is not None]
    out: List[Dict[str, Any]] = []
    named_pids = set()

    def ensure_name(pid: int) -> None:
        if pid not in named_pids:
            named_pids.add(pid)
            out.append({"ph": "M", "name": "process_name", "pid": pid,
                        "tid": 0,
                        "args": {"name": ("driver" if pid == 0
                                          else f"worker {pid - 1}")}})

    # lane allocation per process: first track whose last span ended
    # before this one starts (spans sorted by start time)
    lanes: Dict[int, List[float]] = {}
    for e in sorted(spans, key=lambda e: (float(e["t0"]),
                                          -float(e["dur_s"]))):
        pid = _pid_of(e)
        t0, dur = float(e["t0"]), float(e["dur_s"])
        ends = lanes.setdefault(pid, [])
        for tid, end in enumerate(ends):
            if end <= t0 + 1e-9:
                break
        else:
            tid = len(ends)
            ends.append(0.0)
        ends[tid] = t0 + dur
        ensure_name(pid)
        args = {"trace": e.get("trace"), "span": e.get("span")}
        if e.get("parent"):
            args["parent"] = e["parent"]
        args.update(e.get("attrs") or {})
        out.append({"name": e.get("name", "?"),
                    "cat": e.get("kind", "internal"), "ph": "X",
                    "ts": round(t0 * 1e6, 1),
                    "dur": max(round(dur * 1e6, 1), 1.0),
                    "pid": pid, "tid": tid, "args": args})
    # adaptive rewrites -> instant events on the emitting process's job
    # lane (a rewrite is a point decision, not a duration): the viewer
    # shows WHEN the graph changed shape relative to the stage spans
    rewrites = [e for e in events
                if e.get("event") == "graph_rewrite"
                and e.get("ts") is not None]
    for e in sorted(rewrites, key=lambda e: float(e["ts"])):
        pid = _pid_of(e)
        ensure_name(pid)
        out.append({"name": f"rewrite:{e.get('kind', '?')}",
                    "cat": "adapt", "ph": "i", "s": "p",
                    "ts": round(float(e["ts"]) * 1e6, 1),
                    "pid": pid, "tid": 0,
                    "args": {"rule": e.get("rule"),
                             "stage": e.get("stage"),
                             "trigger_stage": e.get("trigger_stage")}})
    # resource samples -> per-process counter tracks
    for e in sorted(samples, key=lambda e: float(e["ts"])):
        pid = _pid_of(e)
        ensure_name(pid)
        ts = round(float(e["ts"]) * 1e6, 1)
        mem: Dict[str, float] = {}
        if e.get("rss_bytes") is not None:
            mem["rss_mb"] = round(float(e["rss_bytes"]) / (1 << 20), 2)
        if e.get("device_bytes") is not None:
            mem["device_mb"] = round(float(e["device_bytes"])
                                     / (1 << 20), 2)
        if mem:
            out.append({"ph": "C", "name": "memory", "pid": pid,
                        "tid": 0, "ts": ts, "args": mem})
        if e.get("cpu_pct") is not None:
            out.append({"ph": "C", "name": "cpu", "pid": pid, "tid": 0,
                        "ts": ts,
                        "args": {"cpu_pct": float(e["cpu_pct"])}})
    return {"traceEvents": out, "displayTimeUnit": "ms"}
