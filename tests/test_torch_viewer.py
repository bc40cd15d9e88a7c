"""The port's HTML job viewer (``utils/viewer.py``) against the JAX
package's: ``job_report_html`` and ``diagnose`` on one recorded port
stream and on hand-built streams equal the JAX package's output after
the one rewrite of the obs CLI's name (``python -m dryad_tpu.obs`` ->
``python -m dryad_tpu_torch.obs``); the live and history servers answer
on port 0 (mirrors ``tests/test_viewer.py``)."""

import json
import os
import threading
import urllib.request

import numpy as np
import pytest

from dryad_tpu.utils import viewer as jviewer
from dryad_tpu_torch import Context as TContext
from dryad_tpu_torch import JobConfig
from dryad_tpu_torch.obs import history, trace
from dryad_tpu_torch.utils import viewer
from dryad_tpu_torch.utils.events import EventLog
from tests.torch_threads import one_torch_thread  # noqa: F401

P = 8


@pytest.fixture(autouse=True)
def no_trace_sink():
    yield
    trace.install(None)


def _port_cli(doc: str) -> str:
    return doc.replace("python -m dryad_tpu.obs",
                       "python -m dryad_tpu_torch.obs")


def _recorded():
    """A port run at level 2 under lint "warn": a filtered group-by
    feeding a sort (plan, cost report, spans, samples, stage events), then
    EXPLAIN ANALYZE of it (an analyze_report)."""
    log = EventLog(level=2)
    ctx = TContext(device="cpu", nparts=P, event_log=log,
                   config=JobConfig(lint="warn", resource_sample_s=0.01))
    rng = np.random.default_rng(0)
    ds = (ctx.from_columns({"k": rng.integers(0, 20, 5000).astype(np.int32),
                            "v": rng.integers(0, 100, 5000)
                            .astype(np.int32)})
          .where(lambda c: c["v"] > 10)
          .group_by(["k"], {"s": ("sum", "v")})
          .order_by([("s", True)]))
    ds.collect()
    ds.analyze()
    log.close()
    return log.events


PLAN = json.dumps({"version": 1, "stages": [
    {"id": 0, "label": "src", "legs": [{"src": {"source": True}, "ops": [],
                                       "exchange": None}], "body": []},
    {"id": 1, "label": "join", "legs": [{"src": {"stage": 0}, "ops": [],
                                        "exchange": None}], "body": []},
], "out_stage": 1})


def _done(stage, label, attempt, scale, overflow, ts, **kw):
    return dict({"event": "stage_done", "stage": stage, "label": label,
                 "attempt": attempt, "scale": scale, "slack": 2,
                 "overflow": overflow, "need_scale": 3 if overflow else 0,
                 "need_slack": 0, "salted": False, "rows": [9, 1],
                 "out_bytes": 80 * scale, "compile_s": 0.5,
                 "dispatches": 2, "wall_s": 0.3, "ts": ts}, **kw)


STREAMS = {
    "replays": [
        {"event": "plan", "plan": PLAN, "ts": 100.0},
        _done(0, "src", 0, 1, False, 101.0),
        _done(1, "join", 0, 1, True, 102.0),
        _done(1, "join", 1, 4, False, 103.0),
        {"event": "stage_replay", "stage": 1, "label": "join",
         "failures": 1, "ts": 104.0},
        _done(1, "join", 0, 4, False, 105.0),
        {"event": "settle_replay", "stages": [1], "ts": 105.5},
        {"event": "stage_spilled", "stage": 0, "ts": 106.0},
    ],
    "failures": [
        _done(0, "groupby", 0, 1, False, 100.0,
              rows=[100, 2, 3, 2, 1, 2, 3, 2]),
        {"event": "worker_wedged", "workers": [1],
         "why": "sent no heartbeat for >6s", "what": "job 3",
         "log_tails": "worker-1.log: stuck"},
        {"event": "job_failed", "what": "job", "workers": [0],
         "error": "Traceback ...\nValueError: bad UDF",
         "log_tails": "[worker-0] something"},
        {"event": "worker_failed", "worker": 2, "error": "exit 9"},
        {"event": "task_forensics", "worker": 1, "path": "/b/t1.bundle",
         "error_type": "ValueError", "error": "bad UDF"},
        {"event": "regression_suspect", "what": "wall_s", "measured": 9.0,
         "ratio": 3.0, "baseline_median": 3.0, "baseline_runs": 4,
         "app": "wc"},
        {"event": "task_done", "task": 0, "worker": 1, "wall_s": 0.5},
        {"event": "task_done", "task": 1, "worker": 2, "wall_s": 0.6},
    ],
    "adaptive": [
        {"event": "graph_rewrite", "stage": 1, "kind": "repartition_shrink",
         "rule": "SkewRepartition", "ts": 100.0},
        {"event": "adapt_skipped", "stage": 2, "rule": "BroadcastManager",
         "why": "ratio", "ts": 100.1},
        {"event": "lint_finding", "code": "DTA010", "severity": "info",
         "message": "capacity hazard", "node": "join", "span": None},
        {"event": "latency_waterfall", "job": "j-1", "tenant": "acme",
         "ok": True, "wall_us": 3000, "wall_s": 0.003,
         "phases": [{"phase": "queue", "us": 1000},
                    {"phase": "run", "us": 2000}]},
    ],
}


@pytest.mark.parametrize("name", ["recorded"] + sorted(STREAMS))
def test_job_report_html_equals_jax(devices8, name, tmp_path):
    ev = _recorded() if name == "recorded" else STREAMS[name]
    out = str(tmp_path / "job.html")
    doc = viewer.job_report_html(ev, path=out, title="t")
    assert doc == _port_cli(jviewer.job_report_html(ev, title="t"))
    with open(out) as f:
        assert f.read() == doc
    assert viewer.diagnose(ev) == [
        {k: (_port_cli(v) if isinstance(v, str) else v)
         for k, v in r.items()} for r in jviewer.diagnose(ev)]
    assert viewer.job_report_html(ev, plan_json=PLAN) == _port_cli(
        jviewer.job_report_html(ev, plan_json=PLAN))
    assert "python -m dryad_tpu.obs" not in doc
    if name == "recorded":
        for section in ("Gantt", "Critical path",
                        "EXPLAIN ANALYZE (measured vs predicted)",
                        "Predicted cost"):
            assert section in doc
    if name == "failures":
        assert "python -m dryad_tpu_torch.obs replay" in doc
        assert "ValueError: bad UDF" in doc and "data skew" in doc


def _get(url):
    resp = urllib.request.urlopen(url, timeout=10)
    return resp.headers["Content-Type"], resp.read().decode()


def test_serve_live_answers_on_port_0(tmp_path):
    p = str(tmp_path / "ev.jsonl")
    with EventLog(p, level=2) as log:
        for e in STREAMS["replays"]:
            log(e)
    srv, port = viewer.serve_live(p, 0)
    assert port > 0
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        ctype, body = _get(f"http://127.0.0.1:{port}/")
        assert "text/html" in ctype and 'http-equiv="refresh"' in body
        assert body == viewer.job_report_html(
            viewer._read_jsonl(p), title=p, live_refresh_s=2.0)
        # a running job appends; the next refresh sees it
        with open(p, "a") as f:
            f.write(json.dumps({"event": "job_failed", "what": "job",
                                "workers": [1],
                                "error": "RuntimeError: mid-run"}) + "\n")
        assert "RuntimeError: mid-run" in _get(
            f"http://127.0.0.1:{port}/")[1]
        ctype, text = _get(f"http://127.0.0.1:{port}/metrics")
        assert "text/plain" in ctype
        assert "dryad_stage_runs_total 4" in text
        assert "dryad_stage_replays_total 2" in text
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)
    assert not t.is_alive()


def test_serve_history_answers_on_port_0(tmp_path):
    hist = str(tmp_path / "hist")
    for app in ("wc", "wc", "pr"):
        history.archive_job(hist, STREAMS["replays"], app=app)
    srv, port = viewer.serve_history(hist, 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        ctype, body = _get(f"http://127.0.0.1:{port}/")
        assert "text/html" in ctype and "3 archived run(s)" in body
        assert body == history.index_html(history.history_index(hist),
                                          title=hist)
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)
    assert not t.is_alive()


def test_viewer_main_and_tolerant_reader(tmp_path, capsys):
    p = str(tmp_path / "ev.jsonl")
    with open(p, "w") as f:
        for e in STREAMS["replays"]:
            f.write(json.dumps(e) + "\n")
        f.write('{"event": "job_failed", "err')        # mid-flush
    assert len(viewer._read_jsonl(p)) == len(STREAMS["replays"])
    assert viewer._read_jsonl(str(tmp_path / "missing")) == []
    assert viewer.main([p]) == 0
    assert os.path.exists(p + ".html")
    hist = str(tmp_path / "hist")
    history.archive_job(hist, STREAMS["replays"], app="wc")
    assert viewer.main([hist]) == 0
    assert os.path.exists(os.path.join(hist, "index.html"))
    assert capsys.readouterr().out.strip().endswith("index.html")
