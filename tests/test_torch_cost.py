"""The port's static cost model (``analysis/cost.py``, ``analysis/domain.py``)
against the JAX package's (mirrors ``tests/test_cost.py``).

Soundness is the contract: a stage's predicted row interval contains its
measured rows, and its predicted bytes equal the executor's measured
``out_bytes`` at capacity scale 1 (the executor then emits no
``cost_model_miss``).  Against the JAX report on the same plans and
numpy inputs: row intervals, capacities and ``approx`` flags equal, and
bytes equal on plans whose columns are all 32-bit or strings (the port
keeps 64-bit columns, which the JAX package narrows: ROADMAP Queue 3).
Tolerance: none, every number is an integer."""

import json

import numpy as np
import pytest
import torch

from dryad_tpu import Context as JContext
from dryad_tpu.adapt.rules import BroadcastManager as JBroadcastManager
from dryad_tpu.adapt.rules import RuleContext as JRuleContext
from dryad_tpu.adapt.rewrite import PlanRewriter as JPlanRewriter
from dryad_tpu.adapt.stats import StageStats as JStageStats
from dryad_tpu.analysis.cost import CostReport as JCostReport
from dryad_tpu.analysis.cost import cache_diagnostic as jcache_diagnostic
from dryad_tpu.analysis.cost import cost_diagnostics as jcost_diagnostics
from dryad_tpu.analysis.cost import estimate_graph as jestimate_graph
from dryad_tpu.plan import expr as JE
from dryad_tpu.plan.planner import plan_query as jplan_query
from dryad_tpu.utils.config import JobConfig as JJobConfig
from dryad_tpu_torch import Context as TContext
from dryad_tpu_torch import Decomposable
from dryad_tpu_torch import JobConfig
from dryad_tpu_torch.adapt.rewrite import PlanRewriter
from dryad_tpu_torch.adapt.rules import (BroadcastManager, RuleContext,
                                         rows_bounds)
from dryad_tpu_torch.adapt.stats import StageStats
from dryad_tpu_torch.analysis.cost import (CostReport, StageCostEstimate,
                                           cache_diagnostic,
                                           check_stage_measurement,
                                           cost_diagnostics, estimate_graph)
from dryad_tpu_torch.analysis.domain import (ColSpec, Interval,
                                             abstract_batch, out_bytes,
                                             schema_from_columns)
from dryad_tpu_torch.ops import hopper_kernels as hk
from dryad_tpu_torch.plan import expr as E
from dryad_tpu_torch.plan.planner import plan_query
from dryad_tpu_torch.utils.events import EventLog
from tests.torch_threads import one_torch_thread  # noqa: F401

P = 8
# a predicted byte bound may not exceed 4x the measured bytes on the
# BASELINE apps (tests/test_cost.py's bound)
TIGHTNESS = 4.0


def _tctx(log=None, **cfg):
    return TContext(device="cpu", nparts=P, config=JobConfig(**cfg),
                    event_log=log)


def _jctx(**cfg):
    return JContext(config=JJobConfig(**cfg))


def _kv(n=512, seed=0):
    rng = np.random.RandomState(seed)
    return {"k": rng.randint(0, 32, n).astype(np.int32),
            "v": rng.rand(n).astype(np.float32)}


# ---------------------------------------------------------------------------
# domain


def test_interval_algebra():
    assert Interval.exact(5).contains(5)
    assert not Interval.exact(5).contains(4)
    assert Interval.upto(None).contains(10 ** 12)
    assert (Interval(2, 6) + Interval(1, None)).as_tuple() == (3, None)
    assert Interval(2, 6).scale(3).as_tuple() == (6, 18)
    assert Interval(2, 6).mul(Interval(3, None)).as_tuple() == (6, None)
    assert Interval(2, None).clamp_hi(10).as_tuple() == (2, 10)
    assert Interval(8, 9).clamp_hi(4).as_tuple() == (4, 4)
    assert Interval(3, 7).relax_lo().as_tuple() == (0, 7)
    assert Interval(1, 4).union(Interval(2, None)).as_tuple() == (1, None)
    assert Interval.upto(7).bounded and not Interval.upto(None).bounded


def test_out_bytes_formula():
    # [P, cap] f32 + the [P] int32 count: nparts * (cap * 4 + 4)
    assert out_bytes({"v": ColSpec("dense", "float32")}, 100, 8) == \
        8 * (100 * 4 + 4)
    # the port keeps int64 and bool at their own widths
    assert out_bytes({"v": ColSpec("dense", "int64", (3,))}, 10, 2) == \
        2 * (10 * 24 + 4)
    assert out_bytes({"b": ColSpec("dense", "bool")}, 10, 1) == 14
    # a string column: repeat * (max_len + 4) per row
    assert out_bytes({"s": ColSpec("str", max_len=16)}, 10, 2) == \
        2 * (10 * 20 + 4)
    assert out_bytes({"s": ColSpec("str", max_len=16, repeat=3)}, 1, 1) \
        == 3 * 20 + 4


def test_abstract_batch_is_meta_and_round_trips():
    schema = {"k": ColSpec("dense", "int64"),
              "x": ColSpec("dense", "float32", (4,)),
              "s": ColSpec("str", max_len=9)}
    b = abstract_batch(schema, 17)
    assert b.count.device.type == "meta"
    assert all(t.device.type == "meta" for t in
               (b.columns["k"], b.columns["x"], b.columns["s"].data))
    assert schema_from_columns(b.columns) == schema
    assert b.capacity == 17


# ---------------------------------------------------------------------------
# the soundness sweep over the BASELINE apps, and parity with JAX


def _apps(pkg):
    """The five BASELINE app queries of tests/test_cost.py, built with
    ``pkg``'s apps (``dryad_tpu`` or ``dryad_tpu_torch``)."""
    from importlib import import_module

    def app(name):
        return import_module(f"{pkg}.apps.{name}")

    def wordcount(ctx):
        rng = np.random.RandomState(0)
        vocab = ["alpha", "beta", "gamma", "delta", "epsilon"]
        lines = [" ".join(rng.choice(vocab, rng.randint(1, 8)))
                 for _ in range(200)]
        ds = ctx.from_columns({"line": [ln.encode() for ln in lines]},
                              str_max_len=64)
        return app("wordcount").wordcount_query(ds,
                                                tokens_per_partition=2048)

    def terasort(ctx):
        ts = app("terasort")
        return ts.terasort_query(
            ctx.from_columns(ts.gen_records(512), str_max_len=10))

    def groupbyreduce(ctx):
        g = app("groupbyreduce")
        return g.groupbyreduce_query(ctx.from_columns(g.gen_pairs(1024,
                                                                  16)))

    def kmeans(ctx):
        km = app("kmeans")
        pts_cols, _ = km.gen_points(256, 4, 3)
        pts = ctx.from_columns(pts_cols)
        cents = ctx.from_columns({"cid": np.arange(3, dtype=np.int32),
                                  "cx": np.zeros((3, 4), np.float32)})
        return (pts.cross_apply(cents, km._assign_fn,
                                host_fn=km._assign_host)
                .group_by(["cid"], {"cx": ("mean", "x")})
                .with_capacity(3))

    def pagerank_join(ctx):
        edges = ctx.from_columns(app("pagerank").gen_graph(32, 64))
        deg = edges.group_by(["src"], {"deg": ("count", None)})
        edges_deg = edges.join(deg, ["src"], ["src"], expansion=2.0,
                               right_unique=True)
        ranks = ctx.from_columns(
            {"node": np.arange(32, dtype=np.int32),
             "rank": np.full(32, 1 / 32, np.float32)})
        contribs = edges_deg.join(ranks, ["src"], ["node"], expansion=2.0,
                                  right_unique=True)
        return (contribs
                .select(lambda c: {"node": c["dst"],
                                   "c": c["rank"] / c["deg"]})
                .group_by(["node"], {"s": ("sum", "c")})
                .with_capacity(64))

    return {"wordcount": wordcount, "terasort": terasort,
            "groupbyreduce": groupbyreduce, "kmeans": kmeans,
            "pagerank-join": pagerank_join}


T_APPS, J_APPS = _apps("dryad_tpu_torch"), _apps("dryad_tpu")


def _run_checked(ctx, ds):
    """Plan ``ds``, estimate it and run it with the report: (report,
    the stage_done events, the cost_model_miss events)."""
    log = EventLog()
    graph = ds.plan()
    rep = estimate_graph(graph, P, config=ctx.config)
    ctx.executor.run(graph, cost_report=rep, event_log=log)
    return rep, log.of_type("stage_done"), log.of_type("cost_model_miss")


@pytest.mark.parametrize("app", sorted(T_APPS))
def test_soundness_sweep(devices8, app):
    """Predicted per-stage bytes equal the measured ``out_bytes`` at
    scale 1, within 4x of it; rows inside their interval; the run's
    cross-check stays silent."""
    ctx = _tctx()
    rep, done, misses = _run_checked(ctx, T_APPS[app](ctx))
    assert misses == [], f"{app}: cost model missed: {misses}"
    checked = 0
    for e in done:
        est = rep.stage(e["stage"])
        if est is None or est.approx or e["scale"] != 1:
            continue
        lo, hi = est.out_bytes.as_tuple()
        assert lo == hi == e["out_bytes"], (app, e["stage"])
        assert hi <= TIGHTNESS * e["out_bytes"]
        assert est.rows.contains(sum(e["rows"]))
        checked += 1
    assert checked >= 1, f"{app}: no stage was cross-checked"


@pytest.mark.parametrize("app", sorted(T_APPS))
def test_sweep_report_equals_jax(devices8, app):
    """Stage by stage: label, row interval, capacity and approx flag equal
    the JAX report's; bytes too (every sweep plan's columns are 32-bit or
    strings)."""
    tctx, jctx = _tctx(), _jctx()
    tg = T_APPS[app](tctx).plan()
    jg = jplan_query(J_APPS[app](jctx).node, P, config=jctx.config)
    tr = estimate_graph(tg, P, config=tctx.config)
    jr = jestimate_graph(jg, P, config=jctx.config)
    assert len(tr.stages) == len(jr.stages) >= 1
    for t, j in zip(tr.stages, jr.stages):
        assert (t.stage, t.label, t.rows.as_tuple(), t.capacity,
                t.approx) == (j.stage, j.label, j.rows.as_tuple(),
                              j.capacity, j.approx)
        assert t.out_bytes.as_tuple() == j.out_bytes.as_tuple()
        assert t.work_bytes.as_tuple() == j.work_bytes.as_tuple()


def test_cost_model_runs_on_meta_tensors_only(devices8, monkeypatch):
    """Every kernel wrapper the model reaches sees meta tensors (the
    plain version, shapes only): on the card nothing would launch."""
    seen = []
    real = hk._on_card

    def spy(name, *ts):
        seen.append((name, {t.device.type for t in ts}))
        return real(name, *ts)

    ctx = _tctx()
    ds = T_APPS["groupbyreduce"](ctx)
    monkeypatch.setattr(hk, "_on_card", spy)
    rep = ds.cost()
    assert rep.stages and seen
    assert all(devs == {"meta"} for _, devs in seen)


# ---------------------------------------------------------------------------
# out_bytes equals the executor's measurement, across the operators


def _wide(n=400, seed=1):
    rng = np.random.RandomState(seed)
    return {"k": rng.randint(0, 40, n).astype(np.int32),
            "v": rng.randint(-100, 100, n).astype(np.int32),
            "f": rng.rand(n).astype(np.float32),
            "s": ["w%d" % i for i in rng.randint(0, 30, n)]}


def _dec():
    return Decomposable(
        seed=lambda c: (c["v"].to(torch.int64), torch.ones_like(c["v"])),
        merge=lambda a, b: (a[0] + b[0], a[1] + b[1]),
        finalize=lambda s: {"tot": s[0], "n": s[1]})


def _top1(cols, count):
    v = cols["v"]
    return ({"best": v.max()[None]},
            torch.ones(1, dtype=torch.bool, device=v.device))


def _pair(cols):
    k = cols["k"]
    return ({"x": torch.stack([k, k + 1], 1)},
            torch.ones(k.shape[0], 2, dtype=torch.bool, device=k.device))


OPS = {
    "order_by": lambda d, o: d.order_by([("v", True), ("k", False)]),
    "distinct": lambda d, o: d.distinct(["k"]),
    "group_mean_minmax": lambda d, o: d.group_by(
        ["k"], {"m": ("mean", "f"), "lo": ("min", "v"),
                "hi": ("max", "v"), "n": ("count", None)}),
    "group_string_key": lambda d, o: d.group_by(["s"],
                                                {"t": ("sum", "v")}),
    "group_decomposable": lambda d, o: d.group_by(["k"], {"a": _dec()}),
    "group_top_k": lambda d, o: d.group_top_k(["k"], 2, "v"),
    "group_median": lambda d, o: d.group_median(["k"], "v"),
    "join_inner": lambda d, o: d.join(o, ["k"], ["k2"]),
    "join_left_unique": lambda d, o: d.join(
        o.distinct(["k2"]), ["k"], ["k2"], how="left", right_unique=True),
    "join_full": lambda d, o: d.join(o, ["k"], ["k2"], how="full",
                                     expansion=4.0),
    "join_broadcast": lambda d, o: d.join(o, ["k"], ["k2"],
                                          broadcast=True, expansion=4.0),
    "union": lambda d, o: d.select(lambda c: {"k": c["k"]}).union(
        o.select(lambda c: {"k": c["k2"]})),
    "except": lambda d, o: d.select(lambda c: {"k": c["k"]}).except_(
        o.select(lambda c: {"k": c["k2"]})),
    "concat": lambda d, o: d.concat(d.where(lambda c: c["v"] > 0)),
    "zip": lambda d, o: d.zip_with(o),
    "row_index_skip": lambda d, o: d.with_row_index().skip(17).take(50),
    "take_while": lambda d, o: d.take_while(lambda c: c["v"] > -90),
    "flat_map": lambda d, o: d.flat_map(_pair, out_capacity=200),
    "group_apply": lambda d, o: d.group_apply(["k"], _top1,
                                              group_capacity=64),
    "sliding_window": lambda d, o: d.sliding_window(3),
    "apply_with_index": lambda d, o: d.apply_with_partition_index(
        lambda b, i: b.with_columns({"p": torch.full_like(
            b.columns["k"], i)})),
    "cross_apply": lambda d, o: d.cross_apply(
        o.take(3), lambda b, r: b.with_columns(
            {"r": b.columns["k"] + r.columns["k2"][:1].sum()})),
    "wide_int64": lambda d, o: d.select(lambda c: {
        "k": c["k"].to(torch.int64), "x": c["f"].to(torch.float64),
        "b": c["v"] > 0}).group_by(["k"], {"x": ("sum", "x"),
                                           "n": ("count", None)}),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_out_bytes_equals_measured(devices8, op):
    """Every non-approximate stage's predicted bytes equal the executor's
    measured ``out_bytes`` at scale 1, and no cost_model_miss fires."""
    ctx = _tctx()
    rng = np.random.RandomState(2)
    d = ctx.from_columns(_wide(), capacity=64)
    o = ctx.from_columns({"k2": rng.randint(0, 40, 300).astype(np.int32),
                          "w": rng.rand(300).astype(np.float32)})
    rep, done, misses = _run_checked(ctx, OPS[op](d, o))
    assert misses == [], misses
    exact = [e for e in done if e["scale"] == 1
             and not rep.stage(e["stage"]).approx]
    for e in exact:
        assert rep.stage(e["stage"]).out_bytes.as_tuple() == \
            (e["out_bytes"], e["out_bytes"])
    assert exact, f"{op}: no exact stage"


def test_overflow_retry_is_not_a_miss(devices8):
    """An undersized flat_tokens capacity settles at scale > 1: the
    executor's own adaptation, not a model miss (bytes are checked at
    scale 1 only)."""
    from dryad_tpu_torch.apps.wordcount import wordcount_query
    ctx = _tctx(deferred_needs=False)
    ds = ctx.from_columns({"line": [b"a b c d e f g h"] * 64},
                          str_max_len=32)
    rep, done, misses = _run_checked(ctx, wordcount_query(
        ds, tokens_per_partition=16))
    assert any(e["scale"] > 1 for e in done)
    assert misses == []


def test_a_wrong_prediction_is_a_miss(devices8):
    """The cross-check has teeth: a report whose bytes are off by one
    row's worth makes the executor emit cost_model_miss, deferred and
    synchronous."""
    for deferred in (True, False):
        ctx = _tctx(deferred_needs=deferred)
        ds = ctx.from_columns(_kv()).group_by(["k"], {"s": ("sum", "v")})
        graph = ds.plan()
        rep = estimate_graph(graph, P)
        est = rep.stages[-1]
        est.out_bytes = Interval.exact(est.out_bytes.hi + 8)
        log = EventLog()
        ctx.executor.run(graph, cost_report=rep, event_log=log)
        (m,) = log.of_type("cost_model_miss")
        assert m["what"] == "out_bytes" and m["stage"] == est.stage


# ---------------------------------------------------------------------------
# DTA2xx findings where the JAX package raises them


def _codes(diags):
    return sorted((d.code, d.severity) for d in diags)


def _both_reports(tq, jq, **cfg):
    tctx, jctx = _tctx(**cfg), _jctx(**cfg)
    tr = estimate_graph(tq(tctx).plan(), P, config=tctx.config)
    jr = jestimate_graph(jplan_query(jq(jctx).node, P, config=jctx.config),
                         P, config=jctx.config)
    return tr, jr, tctx.config, jctx.config


def test_dta201_provable_oom(devices8):
    def q(ctx):
        return (ctx.from_columns({"x": np.zeros(8, np.float32)})
                .with_capacity(1 << 22).order_by([("x", True)]))
    tr, jr, tc, jc = _both_reports(q, q, device_hbm_bytes=1 << 20)
    td, jd = cost_diagnostics(tr, tc), jcost_diagnostics(jr, jc)
    assert _codes(td) == _codes(jd)
    assert ("DTA201", "error") in _codes(td)
    assert any(d.node.startswith("stage") and "device_hbm_bytes"
               in d.message for d in td if d.code == "DTA201")


def test_dta202_predicted_spill_warn(devices8):
    def q(ctx):
        return ctx.from_columns(_kv(1024)).group_by(["k"],
                                                    {"s": ("sum", "v")})
    rep0 = estimate_graph(q(_tctx()).plan(), P)
    lo = max(s.work_bytes.lo for s in rep0.stages)
    hi = max(s.work_bytes.hi for s in rep0.stages)
    assert lo < hi
    tr, jr, tc, jc = _both_reports(q, q, device_hbm_bytes=(lo + hi) // 2)
    td, jd = cost_diagnostics(tr, tc), jcost_diagnostics(jr, jc)
    assert _codes(td) == _codes(jd)
    assert ("DTA202", "warn") in _codes(td)
    assert "DTA201" not in {c for c, _ in _codes(td)}


def test_dta203_unbounded_fanout_at_exchange(devices8):
    tph = E.Placeholder(parents=(), name="__loop", _npartitions=P)
    jph = JE.Placeholder(parents=(), name="__loop", _npartitions=P)
    tg = plan_query(E.GroupByAgg(parents=(tph,), keys=("k",),
                                 aggs={"s": ("sum", "v")}), P)
    jg = jplan_query(JE.GroupByAgg(parents=(jph,), keys=("k",),
                                   aggs={"s": ("sum", "v")}), P)
    td = cost_diagnostics(estimate_graph(tg, P))
    jd = jcost_diagnostics(jestimate_graph(jg, P))
    assert _codes(td) == _codes(jd)
    assert ("DTA203", "warn") in _codes(td)
    # a source with real statistics through the same shape: no DTA203
    clean = cost_diagnostics(estimate_graph(_tctx().from_columns(_kv())
                                            .group_by(["k"], {"s": (
                                                "sum", "v")}).plan(), P))
    assert "DTA203" not in {d.code for d in clean}


def _big_cache(ctx):
    return ctx.from_columns({"x": np.zeros((64, 4096), np.float32)})


def test_dta204_edge_scale_cache(devices8):
    """cache() of edge-scale data with the re-streaming tier off warns in
    both packages (the result would pin the card); a small cache stays
    silent."""
    tr, jr, tc, jc = _both_reports(_big_cache, _big_cache,
                                   device_hbm_bytes=1 << 20,
                                   ooc_restream_cache=False)
    td, jd = cache_diagnostic(tr, tc), jcache_diagnostic(jr, jc)
    assert (td.code, td.severity) == (jd.code, jd.severity) == \
        ("DTA204", "warn")

    def small(ctx):
        return ctx.from_columns(_kv(64))
    tr, jr, tc, jc = _both_reports(small, small, device_hbm_bytes=1 << 30)
    assert cache_diagnostic(tr, tc) is None is jcache_diagnostic(jr, jc)


def test_dta204_restream_tier_on(devices8):
    """With the re-streaming tier on (the default) the same cache() lowers
    to the local chunked store, and both packages report it as info; a
    streamed plan has no in-memory model and no finding."""
    tr, jr, tc, jc = _both_reports(_big_cache, _big_cache,
                                   device_hbm_bytes=1 << 20)
    assert tc.ooc_restream_cache and jc.ooc_restream_cache
    td, jd = cache_diagnostic(tr, tc), jcache_diagnostic(jr, jc)
    assert (td.code, td.severity) == (jd.code, jd.severity) == \
        ("DTA204", "info")
    from dryad_tpu_torch.exec.ooc import ChunkSource
    streamed = _tctx(device_hbm_bytes=1 << 20).from_stream(
        ChunkSource.from_arrays({"x": np.zeros((64, 4096), np.float32)}))
    rep = estimate_graph(streamed.plan(), P, config=tc)
    assert rep.streamed and not rep.stages
    assert cache_diagnostic(rep, tc) is None and \
        cost_diagnostics(rep, tc) == []


def test_dta205_cost_summary_info(devices8):
    def q(ctx):
        return ctx.from_columns(_kv()).group_by(["k"], {"s": ("sum", "v")})
    tr, jr, tc, jc = _both_reports(q, q)
    td, jd = cost_diagnostics(tr, tc), jcost_diagnostics(jr, jc)
    assert _codes(td) == _codes(jd) == [("DTA205", "info")]


# ---------------------------------------------------------------------------
# the runtime cross-check's contract, the payload, the priors


def test_check_stage_measurement_contract():
    est = StageCostEstimate(0, "s", Interval(10, 20), 32,
                            Interval.exact(1000), Interval(0, 4000))
    assert check_stage_measurement(est, 1, 15, 1000, 8) == []
    # rows outside: always a miss, any scale
    m = check_stage_measurement(est, 2, 25, 1000, 8)
    assert [x["what"] for x in m] == ["rows"]
    # bytes outside at scale 1: a miss
    m = check_stage_measurement(est, 1, 15, 999, 8)
    assert [x["what"] for x in m] == ["out_bytes"]
    assert all(x["event"] == "cost_model_miss" for x in m)
    # bytes outside at scale > 1: executor adaptation, not a model miss
    assert check_stage_measurement(est, 2, 15, 4000, 8) == []
    # approximate estimates were widened on purpose: skipped entirely
    approx = StageCostEstimate(0, "s", Interval(10, 20), 32,
                               Interval.upto(None), Interval(0, None),
                               approx=True)
    assert check_stage_measurement(approx, 1, 999, 999, 8) == []


def test_cost_report_payload_round_trip():
    rep = CostReport(8, [StageCostEstimate(
        0, "groupby", Interval(1, 64), 16, Interval.exact(528),
        Interval(528, 2000), notes=("n1",))], device_hbm_bytes=123)
    back = CostReport.from_payload(
        json.loads(json.dumps(rep.to_payload())))
    assert back.nparts == 8 and back.device_hbm_bytes == 123
    assert (back.stage(0).rows, back.stage(0).out_bytes) == \
        (Interval(1, 64), Interval.exact(528))
    assert back.capacity_of(0) == 16
    assert back.stage(0).notes == ("n1",)
    assert "groupby" in back.render()
    # the JAX package's payload of the same report reads back equal
    jrep = JCostReport.from_payload(rep.to_payload())
    assert CostReport.from_payload(jrep.to_payload()).to_payload() == \
        rep.to_payload()


def test_rows_bounds_prior():
    rep = CostReport(8, [StageCostEstimate(
        3, "s", Interval(2, 40), 8, Interval.exact(100),
        Interval(0, 100))])
    ctx = RuleContext(rw=None, stats={}, config=JobConfig(), nparts=8,
                      levels=(), cost=rep)
    assert rows_bounds(ctx, 3) == (2, 40)
    assert rows_bounds(ctx, 9) is None
    ctx.stats[3] = StageStats(3, (5, 5), capacity=8, out_bytes=100)
    assert rows_bounds(ctx, 3) == (10, 10)


class _Cap:
    def __init__(self, capacity):
        self.capacity = capacity


def test_rows_bounds_prior_reaches_broadcast_manager():
    """The promote needs both sides' rows: with the build side measured
    and the probe side's interval from the cost report, the rule promotes
    one boundary earlier — in both packages alike."""
    def plan(X, pq):
        lsrc = X.Source(parents=(), data=_Cap(16384), _npartitions=8)
        rsrc = X.Source(parents=(), data=_Cap(4096), _npartitions=8)
        left = X.GroupByAgg(parents=(lsrc,), keys=("a",),
                            aggs={"s": ("sum", "v")})
        right = X.GroupByAgg(parents=(rsrc,), keys=("b",),
                             aggs={"w": ("max", "w")})
        return pq(X.Join(parents=(left, right), left_keys=("s",),
                         right_keys=("w",)), 8)

    out = []
    for X, pq, Rep, Est, Ctx, RW, St, BM, Cfg in (
            (E, plan_query, CostReport, StageCostEstimate, RuleContext,
             PlanRewriter, StageStats, BroadcastManager, JobConfig),
            (JE, jplan_query, JCostReport, None, JRuleContext,
             JPlanRewriter, JStageStats, JBroadcastManager, JJobConfig)):
        g = plan(X, pq)
        join = next(s for s in g.stages if s.body
                    and s.body[0].kind == "join")
        lsrc, rsrc = join.legs[0].src, join.legs[1].src
        payload = CostReport(8, [StageCostEstimate(
            lsrc, "groupby", Interval(8000, 16000), 16384,
            Interval.upto(None), Interval(0, None))]).to_payload()
        rep = Rep.from_payload(payload)
        st = St(rsrc, (5,) * 8, capacity=4096)
        ctx = Ctx(rw=RW(g, {rsrc}), stats={rsrc: st},
                  config=Cfg(adaptive="on"), nparts=8, levels=(), cost=rep)
        evs = BM().on_stage_done(ctx, st)
        # without the prior the rule waits for the probe side
        ctx0 = Ctx(rw=RW(plan(X, pq), {rsrc}), stats={rsrc: st},
                   config=Cfg(adaptive="on"), nparts=8, levels=())
        assert BM().on_stage_done(ctx0, st) == []
        out.append(evs)
    assert [e["kind"] for e in out[0]] == ["broadcast_promote"]
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# the JAX model's misses, repaired in the port (ROADMAP Queue 3)


@pytest.mark.parametrize("op", ["join_inner", "zip"])
def test_jax_model_misses_the_port_repairs(devices8, op):
    """Same plan, same numpy inputs.  The JAX package's cross-check
    reports a miss: ``join_inner`` retries past its planned output
    capacity (scale 11) and the JAX check still holds its rows to the
    planned capacity; ``zip`` keeps the left side's capacity, which the
    JAX zip transfer function takes as the smaller of the two.  The port
    checks only stages on planned capacities and gives the zip the left
    capacity: no miss, and the zip's bytes exact."""
    from dryad_tpu.utils.events import EventLog as JEventLog
    rng = np.random.RandomState(2)
    ocols = {"k2": rng.randint(0, 40, 300).astype(np.int32),
             "w": rng.rand(300).astype(np.float32)}
    jlog = JEventLog(level=2)
    jctx = JContext(config=JJobConfig(lint="warn"), event_log=jlog)
    OPS[op](jctx.from_columns(_wide(), capacity=64),
            jctx.from_columns(ocols)).collect()
    jmiss = [e["what"] for e in jlog.events
             if e["event"] == "cost_model_miss"]
    assert jmiss == {"join_inner": ["rows"], "zip": ["out_bytes"]}[op]
    ctx = _tctx()
    rep, done, misses = _run_checked(ctx, OPS[op](
        ctx.from_columns(_wide(), capacity=64), ctx.from_columns(ocols)))
    assert misses == []
    if op == "zip":
        e = done[-1]
        assert rep.stage(e["stage"]).out_bytes.as_tuple() == \
            (e["out_bytes"], e["out_bytes"])
    else:
        assert done[-1]["scale"] > 1
