"""Critical-path analysis over the span tree — the port of
``dryad_tpu/obs/critical_path.py`` (the Artemis question: what was the
critical path of this job?).

Walk the span tree over the job's wall-clock interval and, at every
moment, attribute the time to the DEEPEST active span on the
longest-running chain (among concurrently-active siblings, the one that
ends last is the one the job waited on).  The segments partition the
job wall exactly: their durations sum to the trace envelope, so "top
segments" is an honest decomposition, not a sample.

Also computes the per-stage queue / compile / run / io breakdown:
compile and run walls from the stage events, io from io-kind spans
ascribed to their nearest stage/task ancestor, queue from the gap
between a dispatch span (kind "sched") and the task span it parents.
On the port's deferred path a stage span covers the host's enqueue
only, so the path names where the HOST spent the job's wall.

When a stream carries no spans (tracing off) the stages themselves are
synthesized into spans from their ``stage_done`` events, so the CLI
still prints a useful path.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

__all__ = ["critical_path", "render_text"]


def _span_records(events) -> List[Dict[str, Any]]:
    spans = []
    for e in events:
        if (e.get("event") == "span" and e.get("t0") is not None
                and e.get("dur_s") is not None):
            spans.append(dict(e, _end=float(e["t0"]) + float(e["dur_s"])))
    if spans:
        return spans
    # fallback: synthesize stage spans from stage_done events (ts is the
    # stage END on the sync path; wall_s its duration)
    for i, e in enumerate(ev for ev in events
                          if ev.get("event") == "stage_done"
                          and ev.get("ts") is not None):
        wall = float(e.get("wall_s") or 0.0)
        t0 = float(e["ts"]) - wall
        spans.append({"event": "span", "kind": "stage",
                      "name": f"stage {e.get('stage')}:"
                              f"{e.get('label', '?')}",
                      "span": f"synth-{i}", "t0": t0, "dur_s": wall,
                      "_end": t0 + wall,
                      "attrs": {"stage": e.get("stage")}})
    return spans


def _decompose(sid: Optional[str], name: str, kind: str,
               kids: Dict[Optional[str], list], lo: float, hi: float,
               segments: List[Dict[str, Any]]) -> None:
    """Attribute [lo, hi) to this span's own work and, where a child is
    active, recurse into the child that ends last (the waited-on one)."""
    ks = sorted((k for k in kids.get(sid, ())
                 if k["_end"] > lo + 1e-9 and float(k["t0"]) < hi - 1e-9),
                key=lambda k: float(k["t0"]))
    cur = lo
    while cur < hi - 1e-9:
        active = [k for k in ks
                  if float(k["t0"]) <= cur + 1e-9 and k["_end"] > cur]
        if active:
            nxt = max(active, key=lambda k: k["_end"])
            # a later-starting sibling that OUTLASTS the chosen child
            # preempts the chain at its start — from that moment the job
            # is waiting on it, not on the earlier-finishing child
            # (sibling farm tasks A=[0,5], B=[2,10]: A owns [0,2] only)
            preempt = [float(k["t0"]) for k in ks
                       if float(k["t0"]) > cur + 1e-9
                       and k["_end"] > nxt["_end"]]
            end = min([nxt["_end"], hi] + preempt)
            _decompose(nxt.get("span"), nxt.get("name", "?"),
                       nxt.get("kind", "internal"), kids,
                       max(cur, float(nxt["t0"])), end, segments)
            cur = end
            ks = [k for k in ks if k["_end"] > cur + 1e-9]
        else:
            starts = [float(k["t0"]) for k in ks
                      if float(k["t0"]) > cur + 1e-9]
            nxt_t = min(starts) if starts else hi
            nxt_t = min(nxt_t, hi)
            segments.append({"name": name, "kind": kind, "span": sid,
                             "t0": cur, "t1": nxt_t})
            cur = nxt_t


def _merge(segments: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    for s in segments:
        if out and out[-1]["span"] == s["span"] \
                and abs(out[-1]["t1"] - s["t0"]) < 1e-9:
            out[-1]["t1"] = s["t1"]
        else:
            out.append(dict(s))
    for s in out:
        s["self_s"] = round(s["t1"] - s["t0"], 6)
    return [s for s in out if s["self_s"] > 0]


def _related(a_sid, b_sid, by_id) -> bool:
    """True when one span is an ancestor of the other (chain walk with
    a cycle guard); the root pseudo-segment (span None) relates to
    everything."""
    if a_sid is None or b_sid is None:
        return True

    def ancestors(sid):
        seen = set()
        while sid is not None and sid not in seen:
            seen.add(sid)
            sp = by_id.get(sid)
            sid = sp.get("parent") if sp is not None else None
        return seen

    return a_sid in ancestors(b_sid) or b_sid in ancestors(a_sid)


def _absorb_slivers(segments: List[Dict[str, Any]], by_id,
                    min_s: float = 1e-3) -> List[Dict[str, Any]]:
    """Fold sub-``min_s`` segments into a time-adjacent neighbor.

    The chain walk is exact, so a parent span resuming between two long
    children shows up as a microscopic sliver (e.g. a 5.5e-05 s "run"
    between a stage end and the job end) that crowds real work out of
    the top list.  Each sliver's interval is handed to the neighbor on
    its own parent/child chain when one exists (the time belongs to
    that call path), else to the longer neighbor — the segments still
    partition [lo, hi) exactly, so sum(self_s) == total_s holds."""
    segs = [dict(s) for s in segments]
    changed = True
    while changed and len(segs) > 1:
        changed = False
        for i, s in enumerate(segs):
            if s["t1"] - s["t0"] >= min_s:
                continue
            prev_ = segs[i - 1] if i > 0 else None
            next_ = segs[i + 1] if i + 1 < len(segs) else None
            if prev_ is not None and _related(s["span"], prev_["span"],
                                              by_id):
                target = prev_
            elif next_ is not None and _related(s["span"], next_["span"],
                                                by_id):
                target = next_
            elif prev_ is None:
                target = next_
            elif next_ is None:
                target = prev_
            else:
                target = (prev_ if (prev_["t1"] - prev_["t0"])
                          >= (next_["t1"] - next_["t0"]) else next_)
            if target is prev_:
                target["t1"] = s["t1"]
            else:
                target["t0"] = s["t0"]
            del segs[i]
            changed = True
            break
    for s in segs:
        s["self_s"] = round(s["t1"] - s["t0"], 6)
    return segs


def _stage_breakdown(events, spans, by_id) -> List[Dict[str, Any]]:
    """Per-stage queue / compile / run / io rows."""
    rows: Dict[Any, Dict[str, Any]] = {}

    def row(key, label):
        r = rows.get(key)
        if r is None:
            r = rows[key] = {"stage": key, "label": label, "queue_s": 0.0,
                             "compile_s": 0.0, "run_s": 0.0, "io_s": 0.0}
        return r

    for e in events:
        if e.get("event") == "stage_done":
            r = row(e.get("stage"), e.get("label", "?"))
            r["compile_s"] += float(e.get("compile_s") or 0.0)
            r["run_s"] += float(e.get("wall_s") or 0.0)
        elif e.get("event") == "stream_stage_done":
            r = row(e.get("stage"), e.get("label", "?"))
            r["run_s"] += float(e.get("wall_s") or 0.0)

    def ancestor_stage(sp) -> Optional[Any]:
        seen = set()
        while sp is not None and sp.get("span") not in seen:
            seen.add(sp.get("span"))
            if sp.get("kind") in ("stage", "task", "sched"):
                a = sp.get("attrs") or {}
                if sp.get("kind") == "stage" and "stage" in a:
                    return a["stage"]
                if "task" in a:
                    return f"task {a['task']}"
            sp = by_id.get(sp.get("parent"))
        return None

    # one pass: per-parent total of worker task-span durations (a per-
    # sched rescan would make the live viewer's render O(tasks * spans))
    task_dur_under: Dict[Any, float] = {}
    for sp in spans:
        if sp.get("kind") == "task" and sp.get("parent"):
            task_dur_under[sp["parent"]] = (
                task_dur_under.get(sp["parent"], 0.0)
                + float(sp.get("dur_s") or 0.0))
    for sp in spans:
        a = sp.get("attrs") or {}
        if sp.get("kind") == "io":
            key = ancestor_stage(sp)
            r = row(key if key is not None else "(ingest)",
                    "io outside any stage" if key is None else "")
            r["io_s"] += float(sp.get("dur_s") or 0.0)
        elif sp.get("kind") == "task" and "task" in a:
            r = row(f"task {a['task']}", "farm task")
            r["run_s"] += float(sp.get("dur_s") or 0.0)
        elif sp.get("kind") == "sched" and "task" in a:
            # queue+transit = dispatch-to-reply minus the worker's own
            # execution span (its child)
            child = task_dur_under.get(sp.get("span"), 0.0)
            r = row(f"task {a['task']}", "farm task")
            r["queue_s"] += max(float(sp.get("dur_s") or 0.0) - child,
                                0.0)
    out = []
    for key in sorted(rows, key=str):
        r = rows[key]
        for f in ("queue_s", "compile_s", "run_s", "io_s"):
            r[f] = round(r[f], 6)
        out.append(r)
    return out


def critical_path(events, top: int = 10,
                  min_segment_s: float = 1e-3) -> Dict[str, Any]:
    """Compute the critical-path decomposition of an event stream.

    Returns ``{"total_s", "segments" (time order), "top" (by self
    time), "per_stage"}``; ``total_s`` is the trace envelope (root span
    duration) and always equals ``sum(seg.self_s)``.  Segments shorter
    than ``min_segment_s`` are folded into their parent-chain neighbor
    (``_absorb_slivers``; pass 0 to keep every raw segment)."""
    events = list(events)
    spans = _span_records(events)
    if not spans:
        return {"total_s": 0.0, "segments": [], "top": [],
                "per_stage": _stage_breakdown(events, [], {})}
    by_id = {s.get("span"): s for s in spans}
    kids: Dict[Optional[str], list] = {}
    for s in spans:
        p = s.get("parent")
        kids.setdefault(p if p in by_id else None, []).append(s)
    lo = min(float(s["t0"]) for s in spans)
    hi = max(s["_end"] for s in spans)
    segments: List[Dict[str, Any]] = []
    _decompose(None, "(driver)", "root", kids, lo, hi, segments)
    segments = _merge(segments)
    if min_segment_s > 0:
        segments = _absorb_slivers(segments, by_id, min_segment_s)
    ranked = sorted(segments, key=lambda s: -s["self_s"])[:top]
    return {"total_s": round(hi - lo, 6), "segments": segments,
            "top": ranked,
            "per_stage": _stage_breakdown(events, spans, by_id)}


def render_text(result: Dict[str, Any], top: int = 10) -> str:
    total = result["total_s"]
    lines = [f"critical path: {total:.3f}s total across "
             f"{len(result['segments'])} segment(s)"]
    for i, s in enumerate(result["top"][:top], 1):
        pct = 100.0 * s["self_s"] / total if total > 0 else 0.0
        lines.append(f"  {i:>2}. {s['self_s']:>9.3f}s {pct:>5.1f}%  "
                     f"[{s['kind']}] {s['name']}")
    if result["per_stage"]:
        lines.append("")
        lines.append(f"{'stage':>10} {'label':<18} {'queue_s':>8} "
                     f"{'compile_s':>9} {'run_s':>8} {'io_s':>8}")
        for r in result["per_stage"]:
            lines.append(f"{str(r['stage']):>10} {str(r['label'])[:18]:<18}"
                         f" {r['queue_s']:>8.3f} {r['compile_s']:>9.3f} "
                         f"{r['run_s']:>8.3f} {r['io_s']:>8.3f}")
    return "\n".join(lines)
