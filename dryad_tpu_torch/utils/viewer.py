"""Self-contained HTML job viewer — the port of
``dryad_tpu/utils/viewer.py`` (the JobBrowser role at 1% of the size).

The views render from the EventLog into ONE static HTML file with
inline SVG — no dependencies:

* stage DAG (topological layers, status-ringed nodes for retries/replays)
* per-run Gantt (time from job start, overflow attempts marked)
* per-stage table (runs, retries, replays, scale, slack, wall time)
* FAILURE DIAGNOSIS: worker errors, wedged-gang verdicts, replay
  history, worker log tails, skew findings — rendered from the
  structured job_failed / worker_wedged / worker_failed / stage_replay
  events (the port, with no workers yet, emits the last kind)
* the static checker's findings, the predicted cost, EXPLAIN ANALYZE,
  the critical path, adaptive rewrites and latency waterfalls

LIVE VIEW: ``python -m dryad_tpu_torch.utils.viewer events.jsonl --serve
8123`` serves the report re-rendered from the JSONL stream on every
refresh (EventLog flushes per event), auto-refreshing every 2 s; a
history DIRECTORY (``JobConfig.history_dir``) serves its index page.
The HTML is the JAX package's, with the obs CLI named
``python -m dryad_tpu_torch.obs``.
"""

from __future__ import annotations

import html
import json
from typing import Any, Dict, List, Optional

__all__ = ["job_report_html", "diagnose", "serve_live", "serve_history"]

# palette roles (light, dark) — single accent series + reserved status hues
_ROLES = {
    "surface": ("#fcfcfb", "#1a1a19"),
    "ink": ("#0b0b0b", "#ffffff"),
    "ink2": ("#52514e", "#c3c2b7"),
    "grid": ("#e4e3df", "#33332f"),
    "series": ("#2a78d6", "#3987e5"),
    "warning": ("#fab219", "#fab219"),
    "critical": ("#d03b3b", "#d03b3b"),
}


def _stage_deps_from_plan(plan_json: str) -> Dict[int, List[int]]:
    d = json.loads(plan_json)
    deps: Dict[int, List[int]] = {}
    for st in d["stages"]:
        deps[st["id"]] = [leg["src"]["stage"] for leg in st["legs"]
                          if isinstance(leg["src"], dict)
                          and "stage" in leg["src"]]
    return deps


def _layers(deps: Dict[int, List[int]]) -> Dict[int, int]:
    """Longest-path layering (topological depth)."""
    depth: Dict[int, int] = {}

    def d(sid: int) -> int:
        if sid not in depth:
            depth[sid] = 0  # break cycles defensively
            depth[sid] = 1 + max((d(p) for p in deps.get(sid, [])
                                  if p in deps), default=-1)
        return depth[sid]

    for sid in deps:
        d(sid)
    return depth


def _collect_stages(events) -> Dict[int, Dict[str, Any]]:
    stages: Dict[int, Dict[str, Any]] = {}
    for e in events:
        if e.get("event") not in ("stage_done", "stage_replay",
                                  "stage_restored", "stage_spilled"):
            continue
        sid = e.get("stage")
        s = stages.setdefault(sid, {
            "label": e.get("label", f"stage {sid}"), "runs": [],
            "retries": 0, "replays": 0, "scale": 1, "slack": 2,
            "wall_s": 0.0, "compile_s": 0.0, "rows": 0, "out_bytes": 0})
        if e.get("label"):
            s["label"] = e["label"]
        if e["event"] == "stage_done":
            wall = float(e.get("wall_s", 0.0))
            end = float(e.get("ts", 0.0))
            s["runs"].append({"start": end - wall, "end": end,
                              "overflow": bool(e.get("overflow")),
                              "scale": e.get("scale", 1),
                              "attempt": e.get("attempt", 0),
                              "slack": e.get("slack"),
                              "need_scale": e.get("need_scale", 0),
                              "need_slack": e.get("need_slack", 0),
                              "salted": e.get("salted", False),
                              "deferred": bool(e.get("deferred")),
                              "dispatches": e.get("dispatches"),
                              "compile_s": e.get("compile_s", 0.0)})
            s["wall_s"] += wall
            s["compile_s"] += float(e.get("compile_s", 0.0))
            if e.get("rows") is not None:
                s["rows"] = int(sum(e["rows"]))
            if e.get("out_bytes"):
                s["out_bytes"] = int(e["out_bytes"])
            s["scale"] = max(s["scale"], e.get("scale", 1))
            s["slack"] = max(s["slack"], e.get("slack", 2))
            if e.get("overflow"):
                s["retries"] += 1
        elif e["event"] == "stage_replay":
            s["replays"] += 1
    return stages


def _svg_dag(stages, deps, order) -> str:
    if not deps:
        deps = {sid: [] for sid in order}
    depth = _layers(deps)
    cols: Dict[int, List[int]] = {}
    for sid in order:
        cols.setdefault(depth.get(sid, 0), []).append(sid)
    ncols = max(cols) + 1 if cols else 1
    nrows = max(len(v) for v in cols.values()) if cols else 1
    W, H = 170, 64
    width, height = ncols * W + 30, nrows * H + 20
    pos = {}
    for c, sids in cols.items():
        for r, sid in enumerate(sids):
            pos[sid] = (20 + c * W, 14 + r * H)
    parts = [f'<svg role="img" aria-label="stage DAG" width="{width}" '
             f'height="{height}" viewBox="0 0 {width} {height}">']
    for sid, ps in deps.items():
        if sid not in pos:
            continue
        x2, y2 = pos[sid]
        for p in ps:
            if p not in pos:
                continue
            x1, y1 = pos[p]
            parts.append(
                f'<line x1="{x1 + 128}" y1="{y1 + 19}" x2="{x2}" '
                f'y2="{y2 + 19}" stroke="var(--grid)" stroke-width="2"/>')
    for sid in order:
        if sid not in pos:
            continue
        x, y = pos[sid]
        s = stages[sid]
        ring = ""
        badge = ""
        if s["replays"]:
            ring = ' stroke="var(--critical)" stroke-width="2"'
            badge = "&#8635; replayed"       # color never alone: icon+word
        elif s["retries"]:
            ring = ' stroke="var(--warning)" stroke-width="2"'
            badge = "&#9888; retried"
        label = html.escape(str(s["label"]))[:18]
        parts.append(
            f'<a href="#stage-{sid}">'
            f'<g><rect x="{x}" y="{y}" rx="6" width="128" height="38" '
            f'fill="var(--node)"{ring}/>'
            f'<title>stage {sid} {label}: {len(s["runs"])} run(s), '
            f'{s["retries"]} retries, {s["replays"]} replays, '
            f'{s["wall_s"]:.3f}s</title>'
            f'<text x="{x + 8}" y="{y + 16}" class="t1">{sid} '
            f'{label}</text>'
            f'<text x="{x + 8}" y="{y + 31}" class="t2">'
            f'{s["wall_s"]:.2f}s {badge}</text></g></a>')
    parts.append("</svg>")
    return "".join(parts)


def _svg_gantt(stages, order) -> str:
    runs = [(sid, r) for sid in order for r in stages[sid]["runs"]]
    if not runs:
        return "<p>no stage runs recorded</p>"
    t0 = min(r["start"] for _, r in runs)
    t1 = max(r["end"] for _, r in runs)
    span = max(t1 - t0, 1e-6)
    LABEL, BAR, ROW = 150, 560, 26
    height = len(runs) * ROW + 34
    width = LABEL + BAR + 90
    parts = [f'<svg role="img" aria-label="stage Gantt" width="{width}" '
             f'height="{height}" viewBox="0 0 {width} {height}">']
    for frac in (0.0, 0.25, 0.5, 0.75, 1.0):   # recessive time grid
        x = LABEL + frac * BAR
        parts.append(f'<line x1="{x}" y1="8" x2="{x}" '
                     f'y2="{height - 26}" stroke="var(--grid)"/>'
                     f'<text x="{x}" y="{height - 10}" class="t2" '
                     f'text-anchor="middle">{frac * span:.2f}s</text>')
    for i, (sid, r) in enumerate(runs):
        y = 10 + i * ROW
        x = LABEL + (r["start"] - t0) / span * BAR
        w = max((r["end"] - r["start"]) / span * BAR, 2)
        s = stages[sid]
        fill = "var(--warning)" if r["overflow"] else "var(--series)"
        note = " (overflow &#9888;)" if r["overflow"] else ""
        label = html.escape(str(s["label"]))[:20]
        parts.append(
            f'<g class="bar"><text x="{LABEL - 8}" y="{y + 13}" '
            f'class="t1" text-anchor="end">{sid} {label}</text>'
            f'<rect x="{x:.1f}" y="{y}" width="{w:.1f}" height="16" '
            f'rx="4" fill="{fill}"/>'
            f'<title>stage {sid} {label}: '
            f'{r["end"] - r["start"]:.3f}s at scale {r["scale"]}'
            f'{note}</title>'
            f'<text x="{x + w + 6:.1f}" y="{y + 13}" class="t2">'
            f'{r["end"] - r["start"]:.3f}s{note}</text></g>')
    parts.append("</svg>")
    return "".join(parts)


def _table(stages, order) -> str:
    head = ("<tr><th>stage</th><th>label</th><th>runs</th><th>retries</th>"
            "<th>replays</th><th>scale</th><th>slack</th>"
            "<th>rows</th><th>out&nbsp;MiB</th><th>compile&nbsp;s</th>"
            "<th>wall&nbsp;s</th></tr>")
    rows = []
    for sid in order:
        s = stages[sid]
        rows.append(
            f"<tr><td><a href='#stage-{sid}'>{sid}</a></td>"
            f"<td>{html.escape(str(s['label']))}</td>"
            f"<td>{len(s['runs'])}</td><td>{s['retries']}</td>"
            f"<td>{s['replays']}</td><td>{s['scale']}</td>"
            f"<td>{s['slack']}</td><td>{s['rows']}</td>"
            f"<td>{s['out_bytes'] / (1 << 20):.1f}</td>"
            f"<td>{s['compile_s']:.3f}</td>"
            f"<td>{s['wall_s']:.3f}</td></tr>")
    return f"<table>{head}{''.join(rows)}</table>"


def _stage_details(stages, order, events) -> str:
    """Per-stage drill-down (the JobBrowser vertex view role,
    JobBrowser/JOM/jobinfo.cs:3539): attempt history with the capacity
    knobs, measured needs, dispatch counts and compile/run split, plus
    this stage's replay records — every DAG node and table row links
    here."""
    replays: Dict[int, List[dict]] = {}
    for e in events:
        if e.get("event") in ("stage_replay", "stage_restored",
                              "stage_spilled", "settle_replay"):
            if e.get("event") == "settle_replay":
                for sid in e.get("stages", ()):
                    replays.setdefault(sid, []).append(e)
            else:
                replays.setdefault(e.get("stage"), []).append(e)
    blocks = []
    for sid in order:
        s = stages[sid]
        rows = []
        for r in s["runs"]:
            flags = []
            if r.get("deferred"):
                flags.append("deferred")
            if r.get("salted"):
                flags.append("salted")
            if r.get("overflow"):
                flags.append("&#9888; overflow")
            rows.append(
                f"<tr><td>{r.get('attempt', 0)}</td>"
                f"<td>{r.get('scale', 1)}</td>"
                f"<td>{'' if r.get('slack') is None else r['slack']}</td>"
                f"<td>{r.get('need_scale') or 0}/"
                f"{r.get('need_slack') or 0}</td>"
                f"<td>{'' if r.get('dispatches') is None else r['dispatches']}"
                f"</td>"
                f"<td>{r.get('compile_s') or 0:.3f}</td>"
                f"<td>{r['end'] - r['start']:.3f}</td>"
                f"<td>{' '.join(flags)}</td></tr>")
        rep = "".join(
            f"<li>{html.escape(e.get('event', ''))} "
            f"(failures so far: {e.get('failures', '?')})</li>"
            for e in replays.get(sid, ()))
        rep_html = f"<ul>{rep}</ul>" if rep else ""
        blocks.append(
            f'<details id="stage-{sid}" class="stage">'
            f'<summary>stage {sid} — '
            f'{html.escape(str(s["label"]))}: {len(s["runs"])} attempt(s),'
            f' {s["replays"]} replay(s), {s["wall_s"]:.3f}s</summary>'
            f'<table><tr><th>attempt</th><th>scale</th><th>slack</th>'
            f'<th>need&nbsp;scale/slack</th><th>dispatches</th>'
            f'<th>compile&nbsp;s</th><th>wall&nbsp;s</th><th>flags</th>'
            f'</tr>{"".join(rows)}</table>{rep_html}</details>')
    return ("<h2>Stage drill-down</h2>" + "".join(blocks)) if blocks \
        else ""


def diagnose(events) -> List[Dict[str, Any]]:
    """Failure-diagnosis records from the event stream: what failed,
    where, why, and what the runtime did about it (replay/teardown) —
    plus the Artemis-style sibling-relative findings (data skew, slow
    workers, obs/profile.diagnose_events) and forensics-bundle
    breadcrumbs (task_forensics, obs/flight.py)."""
    from dryad_tpu_torch.utils.events import EventLog
    if isinstance(events, EventLog):
        events = events.events
    events = list(events)
    out: List[Dict[str, Any]] = []
    for e in events:
        k = e.get("event")
        if k == "job_failed":
            first = (e.get("error") or "").strip().splitlines()
            out.append({
                "kind": "worker error", "workers": e.get("workers"),
                "headline": first[-1] if first else "(no message)",
                "detail": e.get("error", ""),
                "log_tails": e.get("log_tails", "")})
        elif k == "worker_wedged":
            out.append({
                "kind": "wedged gang member",
                "workers": e.get("workers"),
                "headline": f"{e.get('why', '')} — gang torn down for "
                            f"replay", "detail": "",
                "log_tails": e.get("log_tails", "")})
        elif k == "worker_failed":
            out.append({"kind": "worker process death",
                        "workers": [e.get("worker")],
                        "headline": e.get("error", "process exited"),
                        "detail": "",
                        "log_tails": e.get("log_tails", "")})
        elif k == "stage_replay":
            out.append({"kind": "stage replay",
                        "workers": None, "stage": e.get("stage"),
                        "headline": f"stage {e.get('stage')} replayed "
                                    f"(attempt {e.get('attempt', '?')})",
                        "detail": "", "log_tails": ""})
        elif k == "regression_suspect":
            # archive-time regression watch (obs/history.py): this run
            # measured past the app's history baseline
            out.append({
                "kind": "perf regression", "workers": None,
                "headline": f"{e.get('what')} "
                            f"{e.get('measured')} is "
                            f"{e.get('ratio')}x the baseline median "
                            f"{e.get('baseline_median')} over "
                            f"{e.get('baseline_runs')} prior run(s) "
                            f"of {e.get('app')}",
                "detail": "", "log_tails": ""})
        elif k == "task_forensics":
            out.append({
                "kind": "forensics bundle",
                "workers": ([e.get("worker")]
                            if e.get("worker") is not None else None),
                "headline": f"{e.get('error_type', 'failure')}: "
                            f"{e.get('error', '')} — reproduce with "
                            f"python -m dryad_tpu_torch.obs replay "
                            f"{e.get('path', '<bundle>')}",
                "detail": "", "log_tails": ""})
    from dryad_tpu_torch.obs.profile import diagnose_events
    for e in diagnose_events(events):
        if e["event"] == "diagnosis_skew":
            out.append({
                "kind": "data skew", "workers": None,
                "stage": e.get("stage"),
                "headline": f"stage {e.get('stage')} "
                            f"({e.get('label')}): partition "
                            f"{e.get('partition')} holds "
                            f"{e.get('ratio')}x the rows/bytes of its "
                            f"sibling median ({e.get('rows_max')} vs "
                            f"{e.get('rows_sibling_median')})",
                "detail": "", "log_tails": ""})
        elif e["event"] == "diagnosis_slow_worker":
            out.append({
                "kind": "slow worker", "workers": [e.get("worker")],
                "headline": f"worker {e.get('worker')} averaged "
                            f"{e.get('mean_s')}s/task over "
                            f"{e.get('tasks')} task(s) — "
                            f"{e.get('ratio')}x its siblings' median "
                            f"({e.get('sibling_median_s')}s)",
                "detail": "", "log_tails": ""})
    return out


def _lint_html(events) -> str:
    """Static-analysis findings ("lint_finding" events, emitted by the
    JobConfig.lint pre-submit gate in api/dataset.py) as a Diagnostics
    section — present only when the stream carries findings."""
    recs = [e for e in events if e.get("event") == "lint_finding"]
    if not recs:
        return ""
    sev_rank = {"error": 0, "warn": 1, "info": 2}
    icon = {"error": "&#10006; error", "warn": "&#9888; warn",
            "info": "&#8505; info"}
    rows = []
    for e in sorted(recs, key=lambda e: (sev_rank.get(e.get("severity"),
                                                      3),
                                         e.get("code", ""))):
        sev = e.get("severity", "info")
        cls = ("critical" if sev == "error"
               else "warning" if sev == "warn" else "ink2")
        rows.append(
            f'<tr><td style="color: var(--{cls})">'
            f'{icon.get(sev, sev)}</td>'
            f'<td>{html.escape(str(e.get("code", "")))}</td>'
            f'<td>{html.escape(str(e.get("message", "")))}</td>'
            f'<td>{html.escape(str(e.get("span") or ""))}</td></tr>')
    head = ("<tr><th>severity</th><th>code</th><th>finding</th>"
            "<th>source</th></tr>")
    return ("<h2>Diagnostics (static analysis)</h2>"
            f"<table class='lint'>{head}{''.join(rows)}</table>")


def _cost_html(events) -> str:
    """"Predicted cost" section: the pre-submit static cost analysis
    (``cost_report`` events, analysis/cost.py via the JobConfig.lint
    gate) as a per-stage table, plus any runtime ``cost_model_miss``
    cross-check verdicts — present only when a cost pass ran."""
    reps = [e for e in events if e.get("event") == "cost_report"]
    if not reps:
        return ""
    from dryad_tpu_torch.analysis.cost import CostReport
    from dryad_tpu_torch.analysis.domain import fmt_bytes
    try:
        rep = CostReport.from_payload(reps[-1]["report"])
    except Exception:
        return ""
    if rep.streamed:
        body = ("<p>streamed plan: device working set is "
                "O(chunk_rows) — the HBM cost model does not apply</p>")
    else:
        rows = []
        for s in rep.stages:
            rv = (f"[{s.rows.lo}, {s.rows.hi}]"
                  if s.rows.hi is not None else f"[{s.rows.lo}, ∞)")
            ob = (fmt_bytes(s.out_bytes.hi)
                  if s.out_bytes.hi is not None else "?")
            wk = (fmt_bytes(s.work_bytes.hi)
                  if s.work_bytes.hi is not None else "?")
            rows.append(
                f"<tr><td>{s.stage}</td>"
                f"<td>{html.escape(str(s.label))}</td>"
                f"<td>{s.capacity}</td><td>{html.escape(rv)}</td>"
                f"<td>{ob}</td><td>{wk}</td>"
                f"<td>{'~' if s.approx else ''}</td></tr>")
        pk = rep.peak_work
        budget = (f" / budget {fmt_bytes(rep.device_hbm_bytes)}"
                  if rep.device_hbm_bytes else "")
        body = ("<table><tr><th>stage</th><th>label</th><th>cap</th>"
                "<th>rows</th><th>out bytes</th><th>work/dev</th>"
                "<th>~</th></tr>" + "".join(rows) + "</table>"
                f"<p>peak per-device working set {fmt_bytes(pk.lo)}"
                + (f"..{fmt_bytes(pk.hi)}" if pk.hi is not None
                   else "..?") + budget
                + " &nbsp;(~ = approximate)</p>")
    misses = [e for e in events if e.get("event") == "cost_model_miss"]
    if misses:
        li = "".join(
            f"<li>stage {e.get('stage')} "
            f"({html.escape(str(e.get('label', '')))}): "
            f"measured {html.escape(str(e.get('what')))}="
            f"{e.get('measured')} outside predicted "
            f"{html.escape(str(e.get('predicted')))}</li>"
            for e in misses)
        body += (f'<p style="color: var(--warning)">&#9888; '
                 f'{len(misses)} cost-model miss(es) — the static '
                 f'prediction did not contain the measured value:</p>'
                 f"<ul>{li}</ul>")
    else:
        body += ("<p class='ink2'>runtime cross-check: no "
                 "cost-model misses</p>")
    return "<h2>Predicted cost (static analysis)</h2>" + body


def _analyze_html(events) -> str:
    """"EXPLAIN ANALYZE" section (obs/analyze.py): measured per-stage
    actuals against the static cost model's predictions, with the
    runtime cross-check's verdicts inline.  Rendered when the stream
    carries a ``cost_report`` (without one the per-stage table already
    shows the plain actuals)."""
    from dryad_tpu_torch.obs.analyze import analyze_events
    if not any(e.get("event") == "cost_report" for e in events):
        return ""
    rep = analyze_events(events)
    if not rep.stages:
        return ""
    rows = []
    for s in rep.stages:
        if s.pred_rows is None:
            pr = "—"
        else:
            lo, hi = s.pred_rows
            pr = ("~" if s.approx else "") + (
                f"[{lo}, {hi}]" if hi is not None else f"[{lo}, ∞)")
        delta = ("—" if s.bytes_delta_pct is None
                 else f"{s.bytes_delta_pct:+.1f}%")
        dcls = ("warning" if s.bytes_in_bounds is False
                or s.rows_in_bounds is False else "ink2")
        flags = " ".join(
            (["cache"] if s.runs and s.cache_hits == s.runs else [])
            + list(s.rewrites)
            + [f"&#9888; miss: {m}" for m in s.misses])
        rows.append(
            f"<tr><td>{s.stage}</td>"
            f"<td>{html.escape(str(s.label))}</td><td>{s.runs}</td>"
            f"<td>{s.rows}</td><td>{html.escape(pr)}</td>"
            f"<td>{s.out_bytes / (1 << 20):.2f}</td>"
            f'<td style="color: var(--{dcls})">{delta}</td>'
            f"<td>{s.compile_s:.3f}</td><td>{s.wall_s:.3f}</td>"
            f"<td>{s.spills}</td><td>{s.replays}</td>"
            f"<td>{html.escape(flags)}</td></tr>")
    inb = len([s for s in rep.settled if s.bytes_in_bounds])
    cmp_n = len([s for s in rep.settled
                 if s.bytes_in_bounds is not None])
    verdict = (f"<p class='ink2'>predictions contained {inb}/{cmp_n} "
               f"settled stage(s); {rep.misses} cost-model miss(es); "
               f"{rep.rewrites} adaptive rewrite(s)</p>")
    head = ("<tr><th>stage</th><th>label</th><th>runs</th>"
            "<th>rows</th><th>pred rows</th><th>out&nbsp;MiB</th>"
            "<th>Δbytes</th><th>compile&nbsp;s</th><th>wall&nbsp;s</th>"
            "<th>spills</th><th>replays</th><th>flags</th></tr>")
    return ("<h2>EXPLAIN ANALYZE (measured vs predicted)</h2>"
            + verdict + f"<table>{head}{''.join(rows)}</table>")


def _critical_path_html(events) -> str:
    """Critical-path section (the Artemis question): top path segments
    plus the per-stage queue/compile/run/io split, computed from the
    span events (obs/critical_path.py).  Absent when the stream carries
    no timing at all."""
    from dryad_tpu_torch.obs.critical_path import critical_path
    res = critical_path(events)
    if not res["segments"] and not res["per_stage"]:
        return ""
    total = res["total_s"]
    rows = []
    for i, s in enumerate(res["top"][:10], 1):
        pct = 100.0 * s["self_s"] / total if total > 0 else 0.0
        bar = (f'<div style="background: var(--series); height: 10px; '
               f'width: {max(pct, 0.5):.1f}%"></div>')
        rows.append(f"<tr><td>{i}</td>"
                    f"<td>{html.escape(str(s['name']))}</td>"
                    f"<td>{html.escape(str(s['kind']))}</td>"
                    f"<td>{s['self_s']:.3f}</td><td>{pct:.1f}%</td>"
                    f"<td style='min-width: 160px; text-align: left'>"
                    f"{bar}</td></tr>")
    seg_html = ""
    if rows:
        seg_html = (f"<p>total {total:.3f}s across "
                    f"{len(res['segments'])} segment(s)</p>"
                    "<table><tr><th>#</th><th>segment</th><th>kind</th>"
                    "<th>self&nbsp;s</th><th>%</th><th></th></tr>"
                    + "".join(rows) + "</table>")
    brows = []
    for r in res["per_stage"]:
        brows.append(f"<tr><td>{html.escape(str(r['stage']))}</td>"
                     f"<td>{html.escape(str(r['label']))}</td>"
                     f"<td>{r['queue_s']:.3f}</td>"
                     f"<td>{r['compile_s']:.3f}</td>"
                     f"<td>{r['run_s']:.3f}</td>"
                     f"<td>{r['io_s']:.3f}</td></tr>")
    br_html = ""
    if brows:
        br_html = ("<h3>per-stage time (queue / compile / run / io)</h3>"
                   "<table><tr><th>stage</th><th>label</th>"
                   "<th>queue&nbsp;s</th><th>compile&nbsp;s</th>"
                   "<th>run&nbsp;s</th><th>io&nbsp;s</th></tr>"
                   + "".join(brows) + "</table>")
    if not seg_html and not br_html:
        return ""
    return "<h2>Critical path</h2>" + seg_html + br_html


def _diagnosis_html(events) -> str:
    recs = diagnose(events)
    if not recs:
        return ""
    blocks = []
    for r in recs:
        who = (f" — worker(s) {r['workers']}" if r.get("workers") else "")
        body = ""
        if r["detail"]:
            body += (f"<details><summary>traceback</summary>"
                     f"<pre>{html.escape(r['detail'])}</pre></details>")
        if r["log_tails"]:
            body += (f"<details><summary>worker log tails</summary>"
                     f"<pre>{html.escape(r['log_tails'])}</pre></details>")
        link = (f' <a href="#stage-{r["stage"]}">&#8594; stage '
                f'{r["stage"]}</a>'
                if r.get("stage") is not None else "")
        blocks.append(
            f'<div class="diag"><b>{html.escape(r["kind"])}</b>'
            f'{html.escape(who)}<div class="hl">'
            f'{html.escape(r["headline"])}{link}</div>{body}</div>')
    return "<h2>Diagnosis</h2>" + "".join(blocks)


def _adaptive_html(events) -> str:
    """"Adaptive rewrites" section: one row per applied graph_rewrite
    (dryad_tpu_torch/adapt), with the before/after stage topology behind a
    disclosure — the JobBrowser's dynamic-manager decisions view."""
    rewrites = [e for e in events if e.get("event") == "graph_rewrite"]
    skipped = [e for e in events if e.get("event") == "adapt_skipped"]
    if not rewrites and not skipped:
        return ""
    rows = []
    for e in rewrites:
        topo = json.dumps({"before": e.get("before"),
                            "after": e.get("after")}, indent=1)
        detail = {k: v for k, v in e.items()
                  if k not in ("event", "rule", "kind", "stage",
                               "trigger_stage", "before", "after", "ts",
                               "worker")}
        rows.append(
            f"<tr><td>{html.escape(str(e.get('rule', '?')))}</td>"
            f"<td>{html.escape(str(e.get('kind', '?')))}</td>"
            f"<td>{e.get('stage', '?')}</td>"
            f"<td>{e.get('trigger_stage', '?')}</td>"
            f"<td>{html.escape(json.dumps(detail))}</td>"
            f"<td><details><summary>topology</summary>"
            f"<pre>{html.escape(topo)}</pre></details></td></tr>")
    out = ("<h2>Adaptive rewrites</h2>"
           "<table class='lint'><tr><th>rule</th><th>kind</th>"
           "<th>stage</th><th>trigger</th><th>detail</th>"
           "<th>before &#8594; after</th></tr>"
           + "".join(rows) + "</table>") if rows else ""
    if skipped:
        li = "".join(
            f"<li><b>{html.escape(str(e.get('rule', '?')))}</b> "
            f"stage {e.get('stage', '?')}: "
            f"{html.escape(str(e.get('reason', '')))}</li>"
            for e in skipped)
        out += (f"<details><summary>{len(skipped)} declined "
                f"rewrite(s)</summary><ul>{li}</ul></details>")
    return out


_PHASE_COLORS = {"precheck": "#8da0cb", "bind": "#66c2a5",
                 "cache_lookup": "#a6d854", "queue": "#fc8d62",
                 "dispatch": "#ffd92f", "compile": "#e78ac3",
                 "run": "#4c78a8", "fetch": "#b3b3b3"}


def _latency_html(events) -> str:
    """"Latency waterfall" section: one stacked bar per recorded
    ``latency_waterfall`` (obs/latency.py) — the request's
    submit→result wall partitioned into phases — plus the per-tenant
    percentile/attribution table re-derived from the same records."""
    wfs = [e for e in events if e.get("event") == "latency_waterfall"]
    if not wfs:
        return ""
    from dryad_tpu_torch.obs.latency import latency_from_events
    bars = []
    for wf in wfs[:20]:
        wall_us = max(1, int(wf.get("wall_us") or 0))
        segs = "".join(
            f'<div title="{html.escape(str(p.get("phase", "?")))}: '
            f'{int(p.get("us") or 0) / 1e6:.4f}s" style="background: '
            f'{_PHASE_COLORS.get(p.get("phase"), "#999")}; '
            f'width: {100.0 * int(p.get("us") or 0) / wall_us:.2f}%; '
            f'height: 14px"></div>'
            for p in wf.get("phases") or [])
        bars.append(
            f'<div style="margin: 4px 0">'
            f'<span style="color: var(--ink2); font-size: 12px">'
            f'{html.escape(str(wf.get("job", "?")))} '
            f'({html.escape(str(wf.get("tenant", "?")))}) '
            f'{wf.get("wall_s")}s</span>'
            f'<div style="display: flex; width: 480px; border: 1px '
            f'solid var(--grid); border-radius: 4px; overflow: hidden">'
            f'{segs}</div></div>')
    legend = " ".join(
        f'<span style="white-space: nowrap"><span style="display: '
        f'inline-block; width: 10px; height: 10px; background: {c}">'
        f'</span> {p}</span>' for p, c in _PHASE_COLORS.items())
    rows = []
    for tenant, r in latency_from_events(events).snapshot().items():
        ex = r.get("exemplar") or {}
        rows.append(
            f"<tr><td>{html.escape(tenant)}</td><td>{r['count']}</td>"
            f"<td>{r['p50_s']:.3f}</td><td>{r['p95_s']:.3f}</td>"
            f"<td>{r['p99_s']:.3f}</td>"
            f"<td>{html.escape(str(r['dominant'] or '—'))}</td>"
            f"<td>{html.escape(str(ex.get('job') or '—'))}</td></tr>")
    return ("<h2>Latency waterfall</h2>"
            f'<div style="color: var(--ink2); font-size: 12px">'
            f"{legend}</div>" + "".join(bars)
            + "<table><tr><th>tenant</th><th>n</th><th>p50&nbsp;s</th>"
              "<th>p95&nbsp;s</th><th>p99&nbsp;s</th><th>dominant</th>"
              "<th>slowest</th></tr>" + "".join(rows) + "</table>")


def job_report_html(events, plan_json: Optional[str] = None,
                    path: Optional[str] = None, title: str = "dryad job",
                    live_refresh_s: Optional[float] = None) -> str:
    """Render the event stream as a self-contained HTML report; optionally
    write it to ``path``.  ``plan_json`` (plan/serialize.graph_to_json)
    adds real DAG edges; without it stages are laid out flat."""
    from dryad_tpu_torch.utils.events import EventLog
    if isinstance(events, EventLog):
        events = events.events
    stages = _collect_stages(events)
    order = sorted(stages)
    deps: Dict[int, List[int]] = {}
    # DAG edges come from the executed plans recorded in the event stream
    # (exec/recovery.py emits one "plan" event per run); an explicitly
    # passed plan_json is merged on top
    for e in events:
        if e.get("event") == "plan" and e.get("plan"):
            deps.update(_stage_deps_from_plan(e["plan"]))
    if plan_json:
        deps.update(_stage_deps_from_plan(plan_json))
    total_wall = sum(s["wall_s"] for s in stages.values())
    retries = sum(s["retries"] for s in stages.values())
    replays = sum(s["replays"] for s in stages.values())
    tasks = [e for e in events if e.get("event") == "task_done"]
    dups = [e for e in events if e.get("event") == "task_duplicated"]

    def roles(mode: int) -> str:
        extra = {"node": ("#eef3fa", "#23292f")}
        vals = {**{k: v[mode] for k, v in _ROLES.items()},
                **{k: v[mode] for k, v in extra.items()}}
        return ";".join(f"--{k}:{v}" for k, v in vals.items())

    tiles = [("stages", len(stages)), ("total wall", f"{total_wall:.2f}s"),
             ("retries", retries), ("replays", replays)]
    if tasks:
        tiles += [("farm tasks", len(tasks)), ("speculated", len(dups))]
    tile_html = "".join(
        f'<div class="tile"><div class="v">{v}</div>'
        f'<div class="k">{k}</div></div>' for k, v in tiles)
    _live_meta = (f'<meta http-equiv="refresh" '
                  f'content="{live_refresh_s:g}">'
                  if live_refresh_s else "")

    doc = f"""<!DOCTYPE html>
<html><head><meta charset="utf-8">{_live_meta}<title>{html.escape(title)}</title>
<style>
  :root {{ color-scheme: light; {roles(0)} }}
  @media (prefers-color-scheme: dark) {{ :root {{ color-scheme: dark;
    {roles(1)} }} }}
  body {{ background: var(--surface); color: var(--ink);
    font: 14px/1.45 system-ui, sans-serif; margin: 24px; }}
  h1 {{ font-size: 18px; }} h2 {{ font-size: 15px; margin-top: 28px; }}
  .tiles {{ display: flex; gap: 12px; flex-wrap: wrap; }}
  .tile {{ border: 1px solid var(--grid); border-radius: 8px;
    padding: 10px 16px; min-width: 90px; }}
  .tile .v {{ font-size: 20px; font-weight: 600; }}
  .tile .k {{ color: var(--ink2); font-size: 12px; }}
  svg text.t1 {{ fill: var(--ink); font: 12px system-ui; }}
  svg text.t2 {{ fill: var(--ink2); font: 11px system-ui; }}
  svg g.bar:hover rect {{ opacity: .75; }}
  table {{ border-collapse: collapse; }}
  th, td {{ border: 1px solid var(--grid); padding: 4px 10px;
    text-align: right; }}
  th {{ color: var(--ink2); font-weight: 600; }}
  td:nth-child(2), th:nth-child(2) {{ text-align: left; }}
  table.lint th, table.lint td {{ text-align: left; }}
  .diag {{ border: 1px solid var(--critical); border-radius: 8px;
    padding: 10px 14px; margin: 8px 0; }}
  .diag .hl {{ color: var(--critical); }}
  .diag pre {{ overflow-x: auto; font-size: 11px; }}
</style></head>
<body>
<h1>{html.escape(title)}</h1>
<div class="tiles">{tile_html}</div>
{_diagnosis_html(events)}
{_lint_html(events)}
{_cost_html(events)}
{_analyze_html(events)}
{_adaptive_html(events)}
{_critical_path_html(events)}
{_latency_html(events)}
<h2>Stage DAG</h2>{_svg_dag(stages, deps, order)}
<h2>Gantt (time from job start)</h2>{_svg_gantt(stages, order)}
<h2>Per-stage table</h2>{_table(stages, order)}
{_stage_details(stages, order, events)}
</body></html>"""
    if path:
        with open(path, "w") as f:
            f.write(doc)
    return doc


def _read_jsonl(path: str) -> List[Dict[str, Any]]:
    """Tolerant JSONL load: a partially-written trailing line (the
    writer may be mid-flush while a live refresh reads) is skipped
    instead of breaking the view."""
    events: List[Dict[str, Any]] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    events.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    except FileNotFoundError:
        pass
    return events


def serve_live(jsonl_path: str, port: int = 0,
               refresh_s: float = 2.0):
    """Serve the report over HTTP, re-rendered from the JSONL event
    stream on every request (EventLog flushes per event, so an open
    browser follows a RUNNING job — the live JobBrowser model).
    ``/metrics`` exposes Prometheus text metrics: the counter families
    derived from the event stream (task/retry/straggler/shuffle-bytes/
    compile-cache), merged with this process's live registry (queue
    depth and friends when the job runs in-process).
    Returns the bound (server, port); call server.serve_forever()."""
    import http.server

    def render() -> bytes:
        return job_report_html(_read_jsonl(jsonl_path), title=jsonl_path,
                               live_refresh_s=refresh_s).encode()

    def render_metrics() -> bytes:
        from dryad_tpu_torch.obs.metrics import REGISTRY, metrics_from_events
        reg = metrics_from_events(_read_jsonl(jsonl_path))
        return reg.merge_from(REGISTRY).render().encode()

    class H(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            if self.path.split("?", 1)[0] == "/metrics":
                body = render_metrics()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            else:
                body = render()
                ctype = "text/html; charset=utf-8"
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", port), H)
    return srv, srv.server_address[1]


def serve_history(history_dir: str, port: int = 0):
    """Serve the job-history index page (obs/history.py), re-rendered
    from the directory on every request — the JobBrowser job-list view.
    Returns (server, port)."""
    import http.server

    def render() -> bytes:
        from dryad_tpu_torch.obs.history import history_index, index_html
        return index_html(history_index(history_dir),
                          title=history_dir).encode()

    class H(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            body = render()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", port), H)
    return srv, srv.server_address[1]


def main(argv=None) -> int:
    import argparse
    import os

    ap = argparse.ArgumentParser(
        description="dryad_tpu_torch job viewer: render an EventLog JSONL to "
                    "HTML (or a job-history DIRECTORY to its index "
                    "page), or serve it live")
    ap.add_argument("events", help="EventLog JSONL path, or a job "
                                   "history directory "
                                   "(JobConfig.history_dir)")
    ap.add_argument("-o", "--out", help="write static HTML here")
    ap.add_argument("--serve", type=int, metavar="PORT",
                    help="serve live (re-rendered per refresh)")
    args = ap.parse_args(argv)
    if os.path.isdir(args.events):
        # job-history index mode (obs/history.py)
        if args.serve is not None:
            srv, port = serve_history(args.events, args.serve)
            print(f"history index: http://127.0.0.1:{port}/", flush=True)
            srv.serve_forever()
            return 0
        from dryad_tpu_torch.obs.history import history_index, index_html
        out = args.out or os.path.join(args.events, "index.html")
        with open(out, "w") as f:
            f.write(index_html(history_index(args.events),
                               title=args.events))
        print(out)
        return 0
    if args.serve is not None:
        srv, port = serve_live(args.events, args.serve)
        print(f"live viewer: http://127.0.0.1:{port}/", flush=True)
        srv.serve_forever()
        return 0
    events = _read_jsonl(args.events)
    out = args.out or (args.events + ".html")
    job_report_html(events, path=out, title=args.events)
    print(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
