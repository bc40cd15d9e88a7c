"""Observability CLI — ``python -m dryad_tpu_torch.obs <cmd> ...``, the
port of ``python -m dryad_tpu.obs``.

The post-hoc tools over recorded telemetry:

* ``trace``          export Chrome trace-event JSON (open in Perfetto;
                     includes resource-sample counter tracks)
* ``critical-path``  print the job's critical-path decomposition
* ``metrics``        print Prometheus text metrics derived from events
* ``analyze``        EXPLAIN ANALYZE over a recorded stream: per-stage
                     measured actuals vs the static cost model
                     (obs/analyze.py)
* ``latency``        per-tenant tail-latency percentiles + dominant-
                     phase attribution from recorded
                     ``latency_waterfall`` events (obs/latency.py);
                     with ``--job`` also renders that job's phase
                     waterfall bar
* ``history``        list a job-history directory with cross-run deltas

``replay`` (re-executing a task-failure forensics bundle) comes with
``obs/flight.py``.  ``trace`` / ``critical-path`` / ``metrics`` /
``analyze`` / ``latency`` accept ``--job <id>``: a multi-job JSONL
(every record job-tagged) is filtered to that one job's records first.

Exit codes: 0 success, 2 malformed input (missing/unreadable files,
empty event streams, a --job id matching no records).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# the post-hoc tool surface (``python -m dryad_tpu_torch.analysis
# --selfcheck`` checks that docs/observability.md names each)
OBS_COMMANDS = ("trace", "critical-path", "metrics", "analyze",
                "latency", "history")


def _fail(msg: str) -> int:
    print(f"dryad_tpu_torch.obs: {msg}", file=sys.stderr)
    return 2


def _load_events(path: str):
    """Events or None (malformed): missing file, or a file from which
    not a single event parses."""
    if not os.path.isfile(path):
        return None
    from dryad_tpu_torch.utils.viewer import _read_jsonl
    events = _read_jsonl(path)
    return events or None


def _cmd_history(args) -> int:
    if not os.path.isdir(args.dir):
        return _fail(f"{args.dir!r} is not a history directory")
    from dryad_tpu_torch.obs.history import (history_index, index_html,
                                             render_history_text)
    entries = history_index(args.dir)
    print(render_history_text(entries))
    if args.html:
        with open(args.html, "w") as f:
            f.write(index_html(entries, title=args.dir))
        print(f"\nindex page: {args.html}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dryad_tpu_torch.obs",
        description="telemetry tools over an EventLog JSONL stream")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def _events_args(p):
        p.add_argument("events", help="EventLog JSONL path")
        p.add_argument("--job", default=None,
                       help="filter to this job id's records (multi-"
                            "job service JSONL)")

    t = sub.add_parser("trace", help="export Chrome trace-event JSON")
    _events_args(t)
    t.add_argument("-o", "--out",
                   help="output path (default: <events>.trace.json)")

    c = sub.add_parser("critical-path",
                       help="critical-path decomposition")
    _events_args(c)
    c.add_argument("--top", type=int, default=10,
                   help="segments to print (default 10)")
    c.add_argument("--json", action="store_true",
                   help="machine-readable output")

    m = sub.add_parser("metrics",
                       help="Prometheus text metrics from events")
    _events_args(m)

    a = sub.add_parser("analyze",
                       help="EXPLAIN ANALYZE: measured per-stage "
                            "actuals vs the static cost model "
                            "(obs/analyze.py)")
    _events_args(a)
    a.add_argument("--json", action="store_true",
                   help="machine-readable report payload")

    la = sub.add_parser("latency",
                        help="tail-latency percentiles + phase "
                             "attribution from latency_waterfall "
                             "events (obs/latency.py)")
    _events_args(la)
    la.add_argument("--json", action="store_true",
                    help="machine-readable snapshot payload")

    h = sub.add_parser("history",
                       help="list a job-history directory "
                            "(obs/history.py) with cross-run deltas")
    h.add_argument("dir", help="history directory "
                               "(JobConfig.history_dir)")
    h.add_argument("--html", help="also write the index page here")

    args = ap.parse_args(argv)
    if args.cmd == "history":
        return _cmd_history(args)

    events = _load_events(args.events)
    if events is None:
        return _fail(f"{args.events!r} is missing or holds no "
                     f"parseable events")
    if getattr(args, "job", None):
        events = [e for e in events if e.get("job") == args.job]
        if not events:
            return _fail(f"no records tagged job={args.job!r} in "
                         f"{args.events!r}")
    if args.cmd == "analyze":
        from dryad_tpu_torch.obs.analyze import analyze_events
        rep = analyze_events(events, job=None)   # already filtered
        if args.json:
            json.dump(rep.to_payload(), sys.stdout)
            print()
        else:
            print(rep.render())
        return 0
    if args.cmd == "trace":
        from dryad_tpu_torch.obs.chrome import chrome_trace
        out = args.out or (args.events + ".trace.json")
        with open(out, "w") as f:
            json.dump(chrome_trace(events), f)
        print(out)
        return 0
    if args.cmd == "critical-path":
        from dryad_tpu_torch.obs.critical_path import critical_path, \
            render_text
        res = critical_path(events, top=args.top)
        if args.json:
            json.dump(res, sys.stdout)
            print()
        else:
            print(render_text(res, top=args.top))
        return 0
    if args.cmd == "metrics":
        from dryad_tpu_torch.obs.metrics import metrics_from_events
        sys.stdout.write(metrics_from_events(events).render())
        return 0
    if args.cmd == "latency":
        from dryad_tpu_torch.obs.latency import (latency_from_events,
                                                 render_text,
                                                 render_waterfall)
        wfs = [e for e in events
               if e.get("event") == "latency_waterfall"]
        if not wfs:
            return _fail(f"no latency_waterfall records in "
                         f"{args.events!r}"
                         + (f" for job={args.job!r}" if args.job
                            else ""))
        tr = latency_from_events(events)
        if args.json:
            json.dump(tr.snapshot(), sys.stdout)
            print()
        else:
            if args.job:
                for wf in wfs:
                    print(render_waterfall(wf))
                print()
            print(render_text(tr))
        return 0
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
