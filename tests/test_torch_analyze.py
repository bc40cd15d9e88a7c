"""The port's EXPLAIN ANALYZE (``obs/analyze.py``, ``Dataset.analyze`` /
``explain(analyze=True)``, SQL ``EXPLAIN ANALYZE``) against the JAX
package's on the same plans and numpy inputs: per stage the rows, output
bytes, predicted intervals, in-bounds flags, runs, retries and settled
flags equal exactly (32-bit and string columns only: the port keeps
64-bit widths, ROADMAP Queue 3); times are left out.  Mirrors
``tests/test_analyze.py``."""

import numpy as np
import pytest

from dryad_tpu import Context as JContext
from dryad_tpu import sql as jsql
from dryad_tpu.obs.analyze import analyze_events as j_analyze_events
from dryad_tpu.utils.config import JobConfig as JJobConfig
from dryad_tpu.utils.events import EventLog as JEventLog
from dryad_tpu_torch import Context as TContext
from dryad_tpu_torch import JobConfig, sql
from dryad_tpu_torch.analysis import LintError
from dryad_tpu_torch.exec.ooc import ChunkSource
from dryad_tpu_torch.obs import trace
from dryad_tpu_torch.obs.analyze import AnalyzeReport, analyze_events
from dryad_tpu_torch.obs.metrics import metrics_from_events
from dryad_tpu_torch.utils.events import EventLog
from tests.test_torch_cost import J_APPS, T_APPS
from tests.torch_threads import one_torch_thread  # noqa: F401

P = 8
# every per-stage field but the times
FIELDS = ("stage", "label", "runs", "retries", "replays", "spills",
          "rewrites", "rows", "out_bytes", "scale", "deferred", "settled",
          "streamed", "pred_rows", "pred_bytes", "approx",
          "rows_in_bounds", "bytes_in_bounds", "bytes_delta_pct")
TOTALS = ("out_bytes_total", "stage_runs", "predicted", "rewrites")


@pytest.fixture(autouse=True)
def no_trace_sink():
    yield
    trace.install(None)


def _fields(rep):
    return [{k: s.get(k) for k in FIELDS}
            for s in rep.to_payload()["stages"]]


def _same(trep, jrep):
    """Every field but the times, ``cache_hits`` (the port has no
    compiled-stage cache, so its stages never hit one) and the misses:
    the JAX runtime cross-check also checks a stage computed from a
    stage that retried past its planned capacity, and misses there
    (ROADMAP Queue 3, "Two faults of the JAX cost model"); the port
    checks only stages on planned inputs, so it reports no miss where
    the JAX package reports one on such a stage alone.  Such a stage's
    byte prediction differs too: the port scales it to the rescaled
    input's realized capacity and reads it in bounds, the JAX package
    keeps the planned one and reads it out of bounds (ROADMAP Queue 3,
    the earlier repairs)."""
    tf, jf = _fields(trep), _fields(jrep)
    for i, (t, j) in enumerate(zip(tf, jf)):
        if t["pred_bytes"] != j["pred_bytes"]:
            assert t["scale"] == 1 and any(u["scale"] > 1
                                           for u in jf[:i])
            assert t["bytes_in_bounds"] and j["bytes_in_bounds"] is False
            for k in ("pred_bytes", "bytes_in_bounds", "bytes_delta_pct"):
                del t[k], j[k]
    assert tf == jf
    assert all(s.cache_hits == 0 for s in trep.stages)
    tp, jp = trep.to_payload(), jrep.to_payload()
    assert {k: tp[k] for k in TOTALS} == {k: jp[k] for k in TOTALS}
    assert trep.misses == 0
    for i, s in enumerate(jrep.stages):
        if s.misses:
            assert s.scale == 1 and any(u.scale > 1
                                        for u in jrep.stages[:i])


# -- the event walk -----------------------------------------------------------

def _done(stage, rows, out_bytes, scale=1, overflow=False, **kw):
    return dict({"event": "stage_done", "stage": stage,
                 "label": f"s{stage}", "rows": rows,
                 "out_bytes": out_bytes, "wall_s": 0.1, "compile_s": 0.2,
                 "scale": scale, "overflow": overflow}, **kw)


def _pred(stage, rows, out_bytes, approx=False):
    return {"stage": stage, "label": f"s{stage}", "rows": list(rows),
            "capacity": 0, "out_bytes": list(out_bytes),
            "work_bytes": [0, None], "approx": approx, "notes": []}


STREAMS = {
    "pairs": [
        {"event": "cost_report",
         "report": {"stages": [_pred(0, (0, 100), (64, 64)),
                               _pred(1, (5, None), (10, 20))]}},
        _done(0, rows=[3, 4], out_bytes=64),
        _done(1, rows=[9], out_bytes=30),
        {"event": "stage_replay", "stage": 0},
        {"event": "stage_spilled", "stage": 1},
        {"event": "cost_model_miss", "stage": 1, "what": "out_bytes"},
        {"event": "graph_rewrite", "stage": 1, "kind": "shrink"},
        {"event": "job_done", "wall_s": 1.5}],
    "overflow": [
        {"event": "cost_report",
         "report": {"stages": [_pred(0, (0, 10), (8, 8))]}},
        _done(0, rows=[50], out_bytes=999, overflow=True),
        _done(0, rows=[50], out_bytes=400, scale=2)],
    "streamed": [
        {"event": "stream_stage_done", "stage": 0, "label": "scan",
         "wall_s": 0.5, "out_bytes": 12, "prefetch_stalls": 2,
         "prefetch_stall_s": 0.25},
        {"event": "ooc_cache_hit"}, {"event": "ooc_cache_write"},
        {"event": "prefetch_stall", "stalls": 2, "stall_s": 0.25},
        {"event": "stream_tee_spill", "stage": 0}],
    "jobs": [_done(0, rows=[1], out_bytes=4, job="a"),
             _done(0, rows=[9], out_bytes=8, job="b")],
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_analyze_events_equals_jax(name):
    ev = STREAMS[name]
    for job in (None, "a"):
        t, j = analyze_events(ev, job=job), j_analyze_events(ev, job=job)
        assert t.to_payload() == j.to_payload()
        assert t.render() == j.render()
        back = AnalyzeReport.from_payload(t.to_payload())
        assert back.to_payload() == t.to_payload()
    rep = analyze_events(STREAMS["pairs"])
    s0, s1 = rep.stage(0), rep.stage(1)
    assert s0.bytes_in_bounds and s0.replays == 1
    assert s1.bytes_in_bounds is False and s1.misses == ("out_bytes",)


# -- Dataset.analyze over the BASELINE apps -----------------------------------

@pytest.mark.parametrize("app", sorted(T_APPS))
def test_dataset_analyze_equals_jax(devices8, app):
    """``Dataset.analyze()`` on tests/test_torch_cost.py's five BASELINE
    queries: every per-stage field but the times equal the JAX
    package's; the predictions contain the measured actuals (zero
    misses); the totals equal the event-derived metrics."""
    tctx = TContext(device="cpu", nparts=P)
    trep = T_APPS[app](tctx).analyze()
    jrep = J_APPS[app](JContext(config=JJobConfig())).analyze()
    _same(trep, jrep)
    assert trep.predicted and trep.misses == 0 and trep.settled
    compared = [s for s in trep.settled if s.bytes_in_bounds is not None]
    assert compared and all(s.bytes_in_bounds and s.rows_in_bounds
                            for s in compared)
    d = metrics_from_events(trep._events).snapshot()
    assert trep.stage_runs == d["dryad_stage_runs_total"]
    assert round(trep.run_s, 6) == d["dryad_run_seconds_total"]
    assert trep.out_bytes_total == d["dryad_shuffle_bytes_total"]


def _kv(ctx, n=600, seed=0):
    rng = np.random.RandomState(seed)
    return ctx.from_columns(
        {"k": rng.randint(0, 12, n).astype(np.int32),
         "v": rng.randint(0, 1000, n).astype(np.int32),
         "s": [b"x%d" % (i % 7) for i in range(n)]})


def _retrying(ctx):
    """A retrying order_by feeding a group_by (tests/test_torch_events.py's
    query, with a string column): stage_done, overflow and settle
    replay."""
    return _kv(ctx).order_by([("k", False), ("v", True)]).group_by(
        ["v"], {"n": ("count", None)})


def test_explain_analyze_text_and_report_event(devices8):
    out = []
    for ctx, log in ((TContext, EventLog), (JContext, JEventLog)):
        lg = log(level=1)
        c = (ctx(device="cpu", nparts=P, event_log=lg) if ctx is TContext
             else ctx(event_log=lg))
        text = _retrying(c).explain(analyze=True)
        assert "EXPLAIN ANALYZE (executed):" in text
        assert "0 cost-model miss(es)" in text
        (rec,) = lg.of_type("analyze_report")
        out.append(AnalyzeReport.from_payload(rec["report"]))
    _same(*out)
    assert any(s.retries for s in out[0].stages)


def test_analyze_with_lint_warn_equals_jax(devices8):
    """Under lint "warn" the gate's cost pass feeds the report (one
    cost_report, in the context's log and the capture)."""
    tlog, jlog = EventLog(level=1), JEventLog(level=1)
    trep = _retrying(TContext(device="cpu", nparts=P, event_log=tlog,
                              config=JobConfig(lint="warn"))).analyze()
    jrep = _retrying(JContext(event_log=jlog,
                              config=JJobConfig(lint="warn"))).analyze()
    _same(trep, jrep)
    assert len(tlog.of_type("cost_report")) == 1
    assert len(tlog.of_type("analyze_report")) == 1


def test_analyze_refusals(devices8, monkeypatch):
    """local_debug and streamed plans refuse; a lint="error" refusal
    raises before the executor runs."""
    with pytest.raises(ValueError, match="local_debug"):
        _kv(TContext(device="cpu", nparts=P, local_debug=True)).analyze()
    ctx = TContext(device="cpu", nparts=P)
    src = ChunkSource.from_arrays({"k": np.arange(50, dtype=np.int32)}, 16)
    with pytest.raises(ValueError, match="streamed"):
        ctx.from_stream(src).analyze()
    ctx = TContext(device="cpu", nparts=P,
                   config=JobConfig(lint="error", device_hbm_bytes=1 << 20))
    ctx.executor.run = lambda *a, **k: pytest.fail("ANALYZE ran the plan")
    big = ctx.from_columns({"x": np.zeros(8, np.float32)}) \
        .with_capacity(1 << 22)
    with pytest.raises(LintError) as ei:
        big.order_by([("x", True)]).analyze()
    assert ei.value.report.by_code("DTA201")


def test_analyze_without_a_cost_model_reports_actuals(devices8,
                                                      monkeypatch):
    """A cost model that cannot shape the plan never blocks ANALYZE: the
    report carries the actuals alone."""
    import dryad_tpu_torch.analysis.cost as cost

    def refuse(*a, **k):
        raise NotImplementedError("no abstract rule")
    monkeypatch.setattr(cost, "estimate_graph", refuse)
    rep = _retrying(TContext(device="cpu", nparts=P)).analyze()
    assert not rep.predicted and rep.settled
    assert "actuals only" in rep.render()


# -- SQL EXPLAIN ANALYZE ------------------------------------------------------

JOIN_Q = ("SELECT l.okey, SUM(l.price * l.qty) AS revenue, COUNT(*) AS n "
          "FROM lineitem l JOIN orders o ON l.okey = o.okey "
          "WHERE o.flag = 1 GROUP BY l.okey")
QUERIES = {
    "join": JOIN_Q,
    "topk": JOIN_Q + " ORDER BY revenue DESC LIMIT 5",
    "string": "SELECT tag, COUNT(*) AS n, MAX(qty) AS q FROM lineitem "
              "WHERE tag != 'void' GROUP BY tag ORDER BY tag",
}


def _catalog(pkg, n=2000, n_orders=40, seed=0):
    """Half the lineitems on order key 0 (the hot key: the join's
    exchange overflows and retries), int32 prices and quantities, a
    string tag; orders with a flag."""
    rng = np.random.RandomState(seed)
    okey = np.where(rng.rand(n) < 0.5, 0,
                    rng.randint(1, n_orders, n)).astype(np.int32)
    li = {"okey": okey, "price": rng.randint(1, 100, n).astype(np.int32),
          "qty": rng.randint(1, 10, n).astype(np.int32),
          "tag": [[b"void", b"ok", b"ok"][i % 3] for i in range(n)]}
    orders = {"okey": np.arange(n_orders, dtype=np.int32),
              "flag": (np.arange(n_orders) % 2).astype(np.int32)}
    return pkg.Catalog().register_columns("lineitem", li) \
        .register_columns("orders", orders)


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_sql_explain_analyze_equals_jax(devices8, name):
    text = "EXPLAIN ANALYZE " + QUERIES[name]
    reps = []
    for pkg, ctx in ((sql, lambda lg: TContext(device="cpu", nparts=P,
                                               event_log=lg)),
                     (jsql, lambda lg: JContext(event_log=lg))):
        lg = (EventLog if pkg is sql else JEventLog)(level=1)
        out = pkg.explain(ctx(lg), _catalog(pkg), text)
        assert "EXPLAIN ANALYZE (executed):" in out
        (rec,) = lg.of_type("analyze_report")
        reps.append(AnalyzeReport.from_payload(rec["report"]))
    _same(*reps)
    rep = reps[0]
    assert rep.misses == 0 and all(s.settled for s in rep.stages)
    if name != "string":
        (join,) = [s for s in rep.stages if s.label == "join"]
        assert (join.runs, join.retries) == (2, 1)


def test_stage_on_rescaled_input_predicted_in_bounds():
    """EXPLAIN ANALYZE of a join that retries at a scale above 1 and
    feeds the group-by stage at its realized capacity: that stage's byte
    prediction, scaled by the capacity factor, contains the measured
    bytes (the planned one does not); the stages behind the ordering's
    exchange keep the cost model's prediction, and every settled stage
    at scale 1 is in bounds."""
    ds = sql.query(TContext(device="cpu", nparts=P), _catalog(sql),
                   QUERIES["topk"])
    rep = ds.analyze()
    (report,) = [e["report"] for e in rep._events
                 if e.get("event") == "cost_report"]
    planned = {s["stage"]: tuple(s["out_bytes"]) for s in report["stages"]}
    (join,) = [s for s in rep.stages if s.label == "join"]
    assert join.scale > 1
    (fed,) = [s for s in rep.settled if s.scale == 1
              and s.pred_bytes != planned[s.stage]]
    assert fed.label == "sort-input" and fed.bytes_in_bounds
    assert fed.out_bytes > planned[fed.stage][1]
    rest = [s for s in rep.settled if s.stage not in (join.stage,
                                                      fed.stage)]
    assert rest and all(s.pred_bytes == planned[s.stage] for s in rest)
    assert all(s.bytes_in_bounds for s in rep.settled if s.scale == 1)
    text = sql.explain(TContext(device="cpu", nparts=P), _catalog(sql),
                       "EXPLAIN ANALYZE " + QUERIES["topk"])
    assert "predictions contained 3/3 settled stage(s)" in text
