"""Job history: archive every run, compare runs of the same app — the
port of ``dryad_tpu/obs/history.py``.

``archive_job`` snapshots one finished job — ``events.jsonl``, the
executed ``plan.json``, a metrics snapshot, the diagnosis findings, and
any forensics ``bundles/`` (none until ``obs/flight.py`` is ported) —
into a history directory (one subdirectory per job); ``history_index``
lists the archive with wall / compile / run / io splits and the DELTA
versus the previous run of the same app, so a regression shows up as a
number the moment the job lands.  ``BENCH_trend.jsonl`` records in the
directory join the index as the seed trajectory.

Entry points: ``EventLog(history_dir=...)`` (or
``JobConfig.history_dir``, wired by api.Context) archives on log close;
``python -m dryad_tpu_torch.obs history <dir>`` prints the index;
``python -m dryad_tpu_torch.utils.viewer <dir> --serve PORT`` serves the
index page.
"""

from __future__ import annotations

import html as _html
import json
import os
import shutil
import time
from typing import Any, Dict, List, Optional

__all__ = ["archive_job", "history_index", "render_history_text",
           "index_html", "regression_findings"]

_SPLIT_KEYS = ("wall_s", "compile_s", "run_s", "io_s")

# regression watch (the "did this run get slower?" archive-time gate):
# a run whose wall/compile/run split reaches FACTOR x the median of the
# app's recent ok runs — or that starts spilling when the baseline did
# not — is flagged with a ``regression_suspect`` finding the moment it
# archives (viewer.diagnose + the history index surface it).  The
# baseline window and the sub-hundredth-of-a-second floor keep one
# noisy micro-run from crying wolf.
REGRESSION_FACTOR = 1.5
_REGRESSION_BASELINE_RUNS = 5
_REGRESSION_MIN_BASELINE_S = 0.02


def _job_summary(events, app: Optional[str]) -> Dict[str, Any]:
    """Wall/compile/run/io split + failure verdict from one stream."""
    compile_s = run_s = io_s = 0.0
    wall = None
    tasks = stages = spills = 0
    failure = None
    status = "ok"
    for e in events:
        k = e.get("event")
        if k in ("stage_done", "stream_stage_done"):
            stages += 1
            compile_s += float(e.get("compile_s") or 0.0)
            run_s += float(e.get("wall_s") or 0.0)
        elif k in ("stage_spilled", "stream_tee_spill"):
            spills += 1
        elif k == "task_done":
            tasks += 1
        elif k == "span" and e.get("kind") == "io":
            io_s += float(e.get("dur_s") or 0.0)
        elif k == "job_done" and e.get("wall_s") is not None:
            wall = (wall or 0.0) + float(e["wall_s"])
        elif k in ("job_failed", "worker_wedged", "worker_failed"):
            status = "failed"
            failure = failure or (e.get("error") or e.get("why")
                                  or "worker failure")
        elif k == "task_forensics":
            status = "failed"
            failure = failure or (e.get("error")
                                  or f"task {e.get('task')} failed")
    if wall is None:
        ts = [float(e["ts"]) for e in events if e.get("ts") is not None]
        wall = round(max(ts) - min(ts), 4) if len(ts) >= 2 else 0.0
    return {"app": app or "job", "status": status,
            "failure": (str(failure).strip().splitlines()[-1][:200]
                        if failure else None),
            "wall_s": round(wall, 4), "compile_s": round(compile_s, 4),
            "run_s": round(run_s, 4), "io_s": round(io_s, 4),
            "stages": stages, "tasks": tasks, "spills": spills}


def regression_findings(history_dir: str, summary: Dict[str, Any],
                        factor: float = REGRESSION_FACTOR
                        ) -> List[Dict[str, Any]]:
    """``regression_suspect`` findings for one fresh summary vs the
    app's history baseline (the median of its last
    ``_REGRESSION_BASELINE_RUNS`` ok runs): a wall/compile/run split at
    ``factor`` x the baseline, or spills appearing where the baseline
    had none (or doubling where it had some).  Empty for failed runs,
    anonymous apps, and first runs (no baseline = nothing to regress
    against)."""
    import statistics
    app = summary.get("app")
    if summary.get("status") != "ok" or app in (None, "job"):
        return []
    prior: List[Dict[str, Any]] = []
    try:
        names = sorted(os.listdir(history_dir))
    except OSError:
        return []
    for name in names:
        p = os.path.join(history_dir, name, "summary.json")
        if not os.path.isfile(p):
            continue
        try:
            with open(p) as f:
                s = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        if s.get("app") == app and s.get("status") == "ok":
            prior.append(s)
    if not prior:
        return []
    prior.sort(key=lambda s: float(s.get("ts") or 0.0))
    prior = prior[-_REGRESSION_BASELINE_RUNS:]
    out: List[Dict[str, Any]] = []

    def finding(what, measured, baseline):
        out.append({"event": "regression_suspect", "app": app,
                    "what": what, "measured": measured,
                    "baseline_median": baseline,
                    "ratio": (round(measured / baseline, 2)
                              if baseline else None),
                    "baseline_runs": len(prior), "factor": factor})

    for key in ("wall_s", "compile_s", "run_s"):
        base = statistics.median(float(p.get(key) or 0.0)
                                 for p in prior)
        cur = float(summary.get(key) or 0.0)
        if base >= _REGRESSION_MIN_BASELINE_S and cur >= factor * base:
            finding(key, round(cur, 4), round(base, 4))
    sbase = statistics.median(int(p.get("spills") or 0) for p in prior)
    scur = int(summary.get("spills") or 0)
    if (sbase == 0 and scur > 0) or (sbase > 0
                                     and scur >= factor * sbase
                                     and scur > sbase):
        finding("spills", scur, sbase)
    return out


def archive_job(history_dir: str, events, app: Optional[str] = None,
                plan_json: Optional[str] = None) -> str:
    """Archive one job's stream into ``history_dir/<app>-<ts>/``;
    returns the job directory.  Forensics bundles referenced by
    ``task_forensics`` events are copied into ``bundles/``."""
    from dryad_tpu_torch.obs.metrics import metrics_from_events
    from dryad_tpu_torch.obs.profile import diagnose_events
    from dryad_tpu_torch.utils.events import EventLog
    if isinstance(events, EventLog):
        events = events.events
    events = list(events)
    ts = time.time()
    summary = _job_summary(events, app)
    summary["ts"] = round(ts, 3)
    base = f"{summary['app']}-{int(ts * 1000)}"
    job_dir = os.path.join(history_dir, base)
    n = 0
    while os.path.exists(job_dir):        # same-millisecond collision
        n += 1
        job_dir = os.path.join(history_dir, f"{base}.{n}")
    bundles_dir = os.path.join(job_dir, "bundles")
    os.makedirs(job_dir, exist_ok=True)
    bundles = []
    for e in events:
        if e.get("event") == "task_forensics" and e.get("path"):
            try:
                os.makedirs(bundles_dir, exist_ok=True)
                dst = os.path.join(bundles_dir,
                                   os.path.basename(e["path"]))
                shutil.copyfile(e["path"], dst)
                bundles.append(os.path.basename(dst))
            except OSError:
                pass
    summary["bundles"] = bundles
    if plan_json is None:
        plan_json = next((e["plan"] for e in reversed(events)
                          if e.get("event") == "plan" and e.get("plan")),
                         None)
    if plan_json:
        with open(os.path.join(job_dir, "plan.json"), "w") as f:
            f.write(plan_json)
    with open(os.path.join(job_dir, "metrics.json"), "w") as f:
        json.dump(metrics_from_events(events).snapshot(), f, indent=1)
    # regression watch: compare THIS run against the app's baseline
    # BEFORE this archive joins the index (the findings land in the
    # archived stream like diagnosis findings, so viewer.diagnose()
    # over the archive surfaces them)
    regs = regression_findings(history_dir, summary)
    summary["regressions"] = [r["what"] for r in regs]
    findings = diagnose_events(events) + regs
    with open(os.path.join(job_dir, "events.jsonl"), "w") as f:
        for e in events + findings + [
                {"event": "job_archived", "path": job_dir,
                 "app": summary["app"], "ts": summary["ts"]}]:
            f.write(json.dumps(e, default=str) + "\n")
    summary["findings"] = len(findings)
    with open(os.path.join(job_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return job_dir


def _trend_entries(path: str) -> List[Dict[str, Any]]:
    """BENCH_trend.jsonl records as index entries (the perf smoke's
    seed trajectory, bench.py)."""
    out = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                out.append({"app": r.get("app", "bench-smoke"),
                            "status": "ok", "failure": None,
                            "ts": float(r.get("ts") or 0.0),
                            "wall_s": float(r.get("wall_s") or 0.0),
                            "compile_s": float(r.get("compile_s") or 0.0),
                            "run_s": float(r.get("run_s") or 0.0),
                            "io_s": float(r.get("io_s") or 0.0),
                            "stages": r.get("stages", 0),
                            "tasks": r.get("tasks", 0),
                            "dir": os.path.basename(path),
                            "bundles": [], "findings": 0})
    except OSError:
        pass
    return out


def history_index(history_dir: str) -> List[Dict[str, Any]]:
    """All archived jobs (plus any BENCH_trend.jsonl trajectory), time
    order, each with split deltas vs the PREVIOUS run of the same app:
    ``d_wall_pct`` etc. (None on an app's first run)."""
    entries: List[Dict[str, Any]] = []
    for name in sorted(os.listdir(history_dir)):
        p = os.path.join(history_dir, name, "summary.json")
        if not os.path.isfile(p):
            continue
        try:
            with open(p) as f:
                s = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        s["dir"] = name
        entries.append(s)
    entries.extend(_trend_entries(
        os.path.join(history_dir, "BENCH_trend.jsonl")))
    entries.sort(key=lambda s: float(s.get("ts") or 0.0))
    prev: Dict[str, Dict[str, Any]] = {}
    for s in entries:
        # the anonymous default bucket gets NO deltas: unrelated
        # pipelines archived without an app name would otherwise read
        # as regressions of each other (name jobs via EventLog(app=...))
        p = (None if s.get("app") in (None, "job")
             else prev.get(s.get("app")))
        for k in _SPLIT_KEYS:
            dk = "d_" + k.replace("_s", "_pct")
            if p is not None and float(p.get(k) or 0.0) > 0:
                s[dk] = round(100.0 * (float(s.get(k) or 0.0)
                                       - float(p[k])) / float(p[k]), 1)
            else:
                s[dk] = None
        prev[s.get("app")] = s
    return entries


def _when(ts: float) -> str:
    try:
        return time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(ts))
    except (OverflowError, OSError, ValueError):
        return "?"


def render_history_text(entries: List[Dict[str, Any]]) -> str:
    lines = [f"{'when':<19} {'app':<18} {'status':<7} {'wall_s':>8} "
             f"{'Δwall%':>7} {'compile':>8} {'run':>8} {'io':>8} "
             f"{'bundles':>7}"]
    for s in entries:
        dw = s.get("d_wall_pct")
        lines.append(
            f"{_when(float(s.get('ts') or 0.0)):<19} "
            f"{str(s.get('app'))[:18]:<18} {s.get('status', '?'):<7} "
            f"{float(s.get('wall_s') or 0.0):>8.3f} "
            f"{(f'{dw:+.1f}' if dw is not None else '—'):>7} "
            f"{float(s.get('compile_s') or 0.0):>8.3f} "
            f"{float(s.get('run_s') or 0.0):>8.3f} "
            f"{float(s.get('io_s') or 0.0):>8.3f} "
            f"{len(s.get('bundles') or ()):>7}")
        if s.get("failure"):
            lines.append(f"{'':<19}   ↳ {s['failure']}")
        if s.get("regressions"):
            lines.append(f"{'':<19}   ↳ regression suspect: "
                         f"{', '.join(s['regressions'])} (vs the app's "
                         f"history baseline)")
    return "\n".join(lines)


def index_html(entries: List[Dict[str, Any]],
               title: str = "dryad job history",
               extra_html: str = "") -> str:
    """The history index page (the JobBrowser job-list view): one row
    per archived job, failure headlines inline, split deltas vs the
    previous run of the same app.  ``extra_html`` is injected above the
    archive table (a service's running-jobs and tenant tables, when the
    port has a service)."""
    rows = []
    for s in reversed(entries):       # newest first
        dw = s.get("d_wall_pct")
        delta = ("—" if dw is None else f"{dw:+.1f}%")
        dcls = ("critical" if dw is not None and dw > 10
                else "ink2" if dw is None or dw > -10 else "series")
        status = s.get("status", "?")
        scls = "critical" if status == "failed" else "ink2"
        fail = (f'<div class="hl">{_html.escape(str(s["failure"]))}'
                f'</div>' if s.get("failure") else "")
        if s.get("regressions"):
            fail += (f'<div class="rg">&#9888; regression suspect: '
                     f'{_html.escape(", ".join(s["regressions"]))}'
                     f'</div>')
        bundles = len(s.get("bundles") or ())
        rows.append(
            f"<tr><td>{_when(float(s.get('ts') or 0.0))}</td>"
            f"<td>{_html.escape(str(s.get('app')))}"
            f"{fail}</td>"
            f'<td style="color: var(--{scls})">{status}</td>'
            f"<td>{float(s.get('wall_s') or 0.0):.3f}</td>"
            f'<td style="color: var(--{dcls})">{delta}</td>'
            f"<td>{float(s.get('compile_s') or 0.0):.3f}</td>"
            f"<td>{float(s.get('run_s') or 0.0):.3f}</td>"
            f"<td>{float(s.get('io_s') or 0.0):.3f}</td>"
            f"<td>{bundles}</td>"
            f"<td>{_html.escape(str(s.get('dir') or ''))}</td></tr>")
    head = ("<tr><th>when</th><th>app / failure</th><th>status</th>"
            "<th>wall&nbsp;s</th><th>Δwall</th><th>compile&nbsp;s</th>"
            "<th>run&nbsp;s</th><th>io&nbsp;s</th><th>bundles</th>"
            "<th>dir</th></tr>")
    from dryad_tpu_torch.utils.viewer import _ROLES
    roles = ";".join(f"--{k}:{v[0]}" for k, v in _ROLES.items())
    droles = ";".join(f"--{k}:{v[1]}" for k, v in _ROLES.items())
    return f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{_html.escape(title)}</title>
<style>
  :root {{ color-scheme: light; {roles} }}
  @media (prefers-color-scheme: dark) {{ :root {{ color-scheme: dark;
    {droles} }} }}
  body {{ background: var(--surface); color: var(--ink);
    font: 14px/1.45 system-ui, sans-serif; margin: 24px; }}
  h1 {{ font-size: 18px; }}
  table {{ border-collapse: collapse; }}
  th, td {{ border: 1px solid var(--grid); padding: 4px 10px;
    text-align: right; }}
  th {{ color: var(--ink2); font-weight: 600; }}
  td:nth-child(2), th:nth-child(2), td:nth-child(10) {{
    text-align: left; }}
  .hl {{ color: var(--critical); font-size: 12px; }}
  .rg {{ color: var(--warning); font-size: 12px; }}
</style></head>
<body><h1>{_html.escape(title)}</h1>
{extra_html}
<p>{len(entries)} archived run(s); Δwall compares each run to the
previous run of the same app.</p>
<table>{head}{''.join(rows)}</table>
</body></html>"""
