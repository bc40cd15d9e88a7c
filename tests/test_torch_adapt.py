"""The port's adaptive execution (``adapt/``: the three connection
managers, the rewrite window, the manager; ``exec/recovery.Run``'s
boundary hook) against the JAX package's (mirrors ``tests/test_adapt.py``).

Rule level: the same plan, built by each package's planner (or by hand,
for the hierarchical merge chain only a multi-level mesh plans), and the
same synthetic stats give the same ``graph_rewrite`` / ``adapt_skipped``
events — kind, stage, capacities, slack, the before / after snapshots —
and the same rewritten stages.  End to end (P = 8, the same numpy
inputs): the same rewrite events as the JAX package's run, rows equal
with adaptation on and off.  Tolerance: none; integer rows compare
exactly, as sorted tuples."""

import os
import types

import numpy as np
import pytest

from dryad_tpu import Context as JContext
from dryad_tpu.adapt import manager as jmanager
from dryad_tpu.adapt import rewrite as jrewrite
from dryad_tpu.adapt import rules as jrules
from dryad_tpu.adapt import stats as jstats
from dryad_tpu.adapt import thresholds as jthresholds
from dryad_tpu.plan import expr as JE
from dryad_tpu.plan import stages as jstages
from dryad_tpu.plan.planner import plan_query as jplan_query
from dryad_tpu.utils.config import JobConfig as JJobConfig
from dryad_tpu_torch import Context as TContext
from dryad_tpu_torch import JobConfig
from dryad_tpu_torch.adapt import manager as tmanager
from dryad_tpu_torch.adapt import rewrite as trewrite
from dryad_tpu_torch.adapt import rules as trules
from dryad_tpu_torch.adapt import stats as tstats
from dryad_tpu_torch.adapt import thresholds as tthresholds
from dryad_tpu_torch.exec.data import pdata_to_host
from dryad_tpu_torch.exec.recovery import Run
from dryad_tpu_torch.obs.metrics import REGISTRY, family_counter, \
    metrics_dump
from dryad_tpu_torch.plan import expr as TE
from dryad_tpu_torch.plan import stages as tstages
from dryad_tpu_torch.plan.planner import plan_query as tplan_query
from dryad_tpu_torch.utils.events import EventLog
from tests.torch_threads import one_torch_thread  # noqa: F401

P = 8

T = types.SimpleNamespace(E=TE, plan=tplan_query, st=tstages, rules=trules,
                          rw=trewrite, stats=tstats, mgr=tmanager,
                          Cfg=JobConfig)
J = types.SimpleNamespace(E=JE, plan=jplan_query, st=jstages, rules=jrules,
                          rw=jrewrite, stats=jstats, mgr=jmanager,
                          Cfg=JJobConfig)


class _Cap:
    """Minimal Source.data: capacity only (planning never reads more)."""

    def __init__(self, capacity):
        self.capacity = capacity


def _src(X, cap=4096):
    return X.E.Source(parents=(), data=_Cap(cap), _npartitions=P)


def _ctx_for(X, graph, executed, stats, config=None, levels=()):
    return X.rules.RuleContext(
        rw=X.rw.PlanRewriter(graph, executed),
        stats={s.stage: s for s in stats},
        config=config or X.Cfg(adaptive="on"), nparts=P, levels=levels)


def _snapshot(X, g):
    return ([X.rw.describe_stage(s) for s in g.stages], g.out_stage)


# ---------------------------------------------------------------------------
# thresholds and stats


def test_thresholds_and_stats_equal_jax():
    assert tthresholds.SKEW_SIBLING_MEDIAN_FACTOR == \
        jthresholds.SKEW_SIBLING_MEDIAN_FACTOR
    assert JobConfig().adapt_skew_factor == JJobConfig().adapt_skew_factor
    for rows in ([4000, 100, 120, 90, 110, 100, 95, 105], [100, 110],
                 [7], [], [0, 0, 0], [3, 1, 1, 1]):
        assert tthresholds.sibling_median(rows) == \
            jthresholds.sibling_median(rows)
        assert tthresholds.skew_ratio(rows) == jthresholds.skew_ratio(rows)
        t = tstats.StageStats(0, tuple(rows), capacity=9, out_bytes=5)
        j = jstats.StageStats(0, tuple(rows), capacity=9, out_bytes=5)
        assert t.event() == j.event()
        assert t.is_skewed(4.0) == j.is_skewed(4.0)
        assert (t.total_rows, t.peak_rows) == (j.total_rows, j.peak_rows)


def test_adaptive_config_fields_equal_jax():
    for f in ("adaptive", "adapt_skew_factor", "adapt_agg_collapse_rows",
              "adapt_agg_expand_rows", "adapt_shrink_factor",
              "adapt_broadcast_max_ratio", "device_hbm_bytes"):
        assert getattr(JobConfig(), f) == getattr(JJobConfig(), f), f
    for bad in ({"adaptive": "maybe"}, {"adapt_skew_factor": 0.5},
                {"adapt_broadcast_max_ratio": 0}, {"device_hbm_bytes": -1}):
        with pytest.raises(ValueError):
            JobConfig(**bad)


# ---------------------------------------------------------------------------
# the rewrite window


def test_rewriter_refuses_executed_prefix():
    g = tplan_query(TE.HashRepartition(parents=(_src(T),), keys=("k",)), P)
    rw = trewrite.PlanRewriter(g, executed={0})
    with pytest.raises(trewrite.RewriteError):
        rw.check(0)
    with pytest.raises(trewrite.RewriteError):
        rw.check(99)


def test_rewriter_fresh_ids_and_redirect():
    g = tplan_query(TE.HashRepartition(parents=(_src(T),), keys=("k",)), P)
    n0 = len(g.stages)
    rw = trewrite.PlanRewriter(g, executed=set())
    st = rw.new_stage([], [], "inserted")
    assert st.id == n0 and g.stages[n0] is st
    old_out = g.out_stage
    assert rw.redirect_consumers(old_out, st.id) >= 1
    assert g.out_stage == st.id


# ---------------------------------------------------------------------------
# the rules on synthetic stats, against the JAX package


def _two_stage(X):
    """stage0 group_by -> stage1 hash_partition on another key."""
    g1 = X.E.GroupByAgg(parents=(_src(X),), keys=("k",),
                        aggs={"s": ("sum", "v")})
    return X.plan(X.E.HashRepartition(parents=(g1,), keys=("s",)), P)


def _join(X, broadcast=False):
    left = X.E.GroupByAgg(parents=(_src(X, 16384),), keys=("a",),
                          aggs={"s": ("sum", "v")})
    right = X.E.GroupByAgg(parents=(_src(X),), keys=("b",),
                           aggs={"w": ("max", "w")})
    g = X.plan(X.E.Join(parents=(left, right), left_keys=("s",),
                        right_keys=("w",), broadcast_right=broadcast), P)
    join = next(s for s in g.stages if s.body and s.body[0].kind == "join")
    return g, join


def _hand_chain(X):
    """hashpartition(v) -> group partial + hash(k)@dp -> merge -> hash(k)
    @dcn -> final: the two-level merge chain the JAX planner lowers on a
    two-level mesh, built by hand with each package's stage classes."""
    S = X.st
    group = S.StageOp("group", {"keys": ("k",), "aggs": {"s": ("sum", "v")}})

    def merge():
        return S.StageOp("group", {"keys": ("k",),
                                   "aggs": {"s": ("sum", "s")}})

    stages = [
        S.Stage(0, [S.Leg(("source", _Cap(4096)), [],
                          S.Exchange("hash", keys=("v",),
                                     out_capacity=4096))],
                [], "hashpartition"),
        S.Stage(1, [S.Leg(0, [group], S.Exchange(
            "hash", keys=("k",), out_capacity=4096, axis="dp"))],
                [merge()], "groupby-dp"),
        S.Stage(2, [S.Leg(1, [], S.Exchange(
            "hash", keys=("k",), out_capacity=4096, axis="dcn"))],
                [merge()], "groupby-dcn"),
    ]
    return S.StageGraph(stages, 2)


def _flat_merge(X, mean=True):
    hp = X.E.HashRepartition(parents=(_src(X),), keys=("v",))
    aggs = {"s": ("sum", "v")}
    if mean:
        aggs["m"] = ("mean", "v")
    return X.plan(X.E.GroupByAgg(parents=(hp,), keys=("k",), aggs=aggs), P)


def _case(name, X):
    """(events, graph) of one rule case run with package X."""
    Stats = X.stats.StageStats
    if name.startswith("skew_"):
        if name == "skew_pre_salt":
            g, _ = _join(X)
            st = Stats(0, (3000, 10, 10, 10, 10, 10, 10, 10), capacity=4096)
        elif name == "skew_expanding_leg":
            grp = X.E.GroupByAgg(parents=(_src(X),), keys=("k",),
                                 aggs={"s": ("sum", "v")})
            fm = X.E.FlatMap(parents=(grp,), fn=lambda b: b,
                             out_capacity=8192)
            g = X.plan(X.E.HashRepartition(parents=(fm,), keys=("k",)), P)
            st = Stats(0, (10,) * 8, capacity=4096)
        else:
            g = _two_stage(X)
            cap0 = g.stage(1).legs[0].exchange.out_capacity
            rows = ((100,) * 8 if name == "skew_shrink"
                    else (cap0 - 70, 10, 10, 10, 10, 10, 10, 10))
            st = Stats(0, rows, capacity=cap0)
        evs = X.rules.SkewRepartition().on_stage_done(
            _ctx_for(X, g, {0}, [st]), st)
        return evs, g
    if name.startswith("broadcast_"):
        g, join = _join(X, broadcast=name != "broadcast_promote")
        if name == "broadcast_demote_relied":
            join.placement_relied = True
        lsrc, rsrc = join.legs[0].src, join.legs[1].src
        rows = (5,) * 8 if name == "broadcast_promote" else (500,) * 8
        stats = [Stats(lsrc, ((2000,) if name == "broadcast_promote"
                              else (500,)) * 8, capacity=16384),
                 Stats(rsrc, rows, capacity=4096)]
        evs = X.rules.BroadcastManager().on_stage_done(
            _ctx_for(X, g, {lsrc, rsrc}, stats), stats[-1])
        return evs, g
    levels = (("dp", 4), ("dcn", 2))
    if name in ("agg_collapse", "agg_collapse_big_rows"):
        g = _hand_chain(X)
        rows = (64,) * 8 if name == "agg_collapse" else (4096,) * 8
        st = Stats(0, rows, capacity=4096)
    else:
        g = _flat_merge(X, mean=name == "agg_expand")
        st = Stats(0, (1 << 18,) * 8, capacity=1 << 18)
        if name == "agg_expand_three_levels":
            levels = (("core", 2), ("dp", 2), ("dcn", 2))
    cfg = X.Cfg(adaptive="on", adapt_agg_expand_rows=1 << 20)
    evs = X.rules.DynamicAggregationTree().on_stage_done(
        _ctx_for(X, g, {0}, [st], config=cfg, levels=levels), st)
    return evs, g


CASES = {
    "skew_shrink": "repartition_shrink",
    "skew_send_slack": "send_slack",
    "skew_pre_salt": "pre_salt",
    "skew_expanding_leg": None,
    "broadcast_promote": "broadcast_promote",
    "broadcast_demote": "broadcast_demote",
    "broadcast_demote_relied": None,
    "agg_collapse": "agg_tree_collapse",
    "agg_collapse_big_rows": None,
    "agg_expand": "agg_tree_expand",
    "agg_expand_three_levels": "agg_tree_expand",
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_rule_equals_jax(name):
    """Events (kind, stage, cap_after, slack_after, before / after
    snapshots, orphaned and new stages) and the rewritten graph equal the
    JAX package's."""
    tev, tg = _case(name, T)
    jev, jg = _case(name, J)
    assert tev == jev
    assert _snapshot(T, tg) == _snapshot(J, jg)
    kinds = [e["kind"] for e in tev if e["event"] == "graph_rewrite"]
    if CASES[name] is None:
        assert kinds == [] and any(e["event"] == "adapt_skipped"
                                   for e in tev)
    else:
        assert CASES[name] in kinds


def test_shrink_capacity_grid():
    """The shrunk capacity is a multiple of 128 rows covering the
    measured total (the JAX package's grid)."""
    evs, g = _case("skew_shrink", T)
    (e,) = [e for e in evs if e["kind"] == "repartition_shrink"]
    assert e["cap_after"] == 896 and e["cap_after"] % 128 == 0
    assert g.stage(1).legs[0].exchange.out_capacity == 896


def test_agg_tree_declines_on_the_ports_mesh(devices8):
    """The port's Mesh is one axis: ``levels_of_mesh`` gives (), so the
    expansion finds no second level and a flat plan has no merge chain
    to collapse: the rule declines at any size."""
    ctx = TContext(device="cpu", nparts=P)
    levels = tmanager.levels_of_mesh(ctx.mesh)
    assert levels == ()
    g = _flat_merge(T)
    before = _snapshot(T, g)
    for rows in ((1,) * 8, (1 << 18,) * 8):
        st = tstats.StageStats(0, rows, capacity=1 << 18)
        assert trules.DynamicAggregationTree().on_stage_done(
            _ctx_for(T, g, {0}, [st], levels=levels), st) == []
    assert _snapshot(T, g) == before


def test_default_rules_order():
    assert [type(r).__name__ for r in trules.default_rules()] == \
        [type(r).__name__ for r in jrules.default_rules()] == \
        ["DynamicAggregationTree", "BroadcastManager", "SkewRepartition"]


def test_manager_emits_stats_rewrites_and_survives_rule_bugs():
    g = _two_stage(T)
    events = []

    class Boom:
        name = "boom"

        def on_stage_done(self, ctx, st):
            raise ValueError("rule bug")

    mgr = tmanager.AdaptiveManager(g, JobConfig(adaptive="on"), P,
                                   event=events.append,
                                   rules=[Boom(), trules.SkewRepartition()])
    counter = family_counter(REGISTRY, "graph_rewrites",
                             rule="skew_repartition",
                             kind="repartition_shrink")
    c0 = counter.value
    st = tstats.StageStats(0, (100,) * 8, capacity=g.stage(1).legs[0]
                           .exchange.out_capacity)
    mgr.on_stage_materialized(st, {0})
    kinds = [e["event"] for e in events]
    assert kinds[0] == "adapt_stats" and all("ts" in e for e in events)
    assert any(e["event"] == "adapt_skipped" and e["rule"] == "boom"
               and "rule bug" in e["reason"] for e in events)
    assert mgr.rewrite_count == 1 == kinds.count("graph_rewrite")
    assert counter.value == c0 + 1
    assert "dryad_graph_rewrites_total" in metrics_dump()


# ---------------------------------------------------------------------------
# end to end, against the JAX package's runs


def _hot(n=40_000):
    rng = np.random.default_rng(0)
    k = np.where(rng.random(n) < 0.9, 0,
                 rng.integers(1, 1000, n)).astype(np.int32)
    return {"k": k, "v": rng.integers(0, 10, n).astype(np.int32)}


def _shrink_query(ctx):
    return (ctx.from_columns(_hot()).group_by(["k"], {"s": ("sum", "v")})
            .hash_partition(["s"]))


def _jkey(c):
    return {"j": c["a"] % 40, "s": c["s"]}


def _jkey2000(c):
    return {"j": c["a"] % 2000, "s": c["s"]}


def _ren(c):
    return {"bb": c["b"], "w": c["w"]}


def _promote_query(ctx):
    rng = np.random.default_rng(2)
    a = rng.integers(0, 4000, 30_000).astype(np.int32)
    v = rng.integers(0, 10, 30_000).astype(np.int32)
    b = np.arange(40, dtype=np.int32)
    big = ctx.from_columns({"a": a, "v": v}).group_by(
        ["a"], {"s": ("sum", "v")})
    small = (ctx.from_columns({"b": b, "w": b * 3})
             .group_by(["b"], {"w": ("max", "w")}).select(_ren, label="ren"))
    return big.select(_jkey, label="jkey").join(small, ["j"], ["bb"])


def _demote_query(ctx):
    rng = np.random.default_rng(3)
    a = rng.integers(0, 2000, 20_000).astype(np.int32)
    v = rng.integers(0, 10, 20_000).astype(np.int32)
    b = np.arange(2000, dtype=np.int32)
    left = (ctx.from_columns({"a": a, "v": v})
            .group_by(["a"], {"s": ("sum", "v")})
            .select(_jkey2000, label="jkey"))
    right = (ctx.from_columns({"b": b, "w": b * 3})
             .group_by(["b"], {"w": ("max", "w")}).select(_ren, label="ren"))
    return left.join(right, ["j"], ["bb"], broadcast=True)


def _slack_query(ctx):
    k = np.arange(30_000, dtype=np.int32)
    return (ctx.from_columns({"k": k}).where(lambda c: c["k"] < 1875)
            .order_by([("k", False)]))


E2E = {"shrink": (_shrink_query, "repartition_shrink"),
       "promote": (_promote_query, "broadcast_promote"),
       "demote": (_demote_query, "broadcast_demote"),
       "send_slack": (_slack_query, "send_slack")}


def _rewrites(events):
    return [{k: v for k, v in e.items() if k != "ts"} for e in events
            if e.get("event") == "graph_rewrite"]


def _rows(t):
    names = sorted(t)
    return sorted(zip(*[np.asarray(t[c]).tolist() for c in names]))


@pytest.mark.parametrize("case", sorted(E2E))
def test_e2e_equals_jax_and_adaptive_off(devices8, case):
    """The rewrite events of an adaptive run equal the JAX package's on
    the same inputs, and the rows equal the non-adaptive run's (and the
    JAX package's)."""
    query, kind = E2E[case]
    tev, toff_ev, jev = [], [], []
    on = query(TContext(device="cpu", nparts=P, event_log=tev.append,
                        config=JobConfig(adaptive="on"))).collect()
    off = query(TContext(device="cpu", nparts=P,
                         event_log=toff_ev.append)).collect()
    jon = query(JContext(event_log=jev.append,
                         config=JJobConfig(adaptive="on"))).collect()
    assert kind in [e["kind"] for e in _rewrites(tev)]
    assert _rewrites(tev) == _rewrites(jev)
    assert _rows(on) == _rows(off) == _rows(jon)
    assert not [e for e in toff_ev
                if e["event"].startswith("adapt")
                or e["event"] == "graph_rewrite"]


def test_e2e_shrink_runs_smaller(devices8):
    def bytes_of(cfg):
        log = EventLog()
        _shrink_query(TContext(device="cpu", nparts=P, event_log=log,
                               config=cfg)).collect()
        return [e["out_bytes"] for e in log.of_type("stage_done")
                if e["label"] == "hashpartition"][-1]
    assert bytes_of(JobConfig(adaptive="on")) < bytes_of(JobConfig())


def test_adaptive_run_is_synchronous(devices8):
    """adaptive="on" turns the deferred settle off for the run: one NEED
    read per attempt (the default context reads once per run)."""
    on = TContext(device="cpu", nparts=P, config=JobConfig(adaptive="on"))
    _shrink_query(on).collect()
    attempts = sum(e["attempts"] for e in on.executor.stage_log)
    assert on.executor.host_reads == attempts == 2
    off = TContext(device="cpu", nparts=P)
    _shrink_query(off).collect()
    assert off.executor.host_reads == 1


def test_adaptive_off_leaves_the_plan_as_planned(devices8):
    """adaptive="off" (the default): no adapt event, and the executed
    graph's stages keep the fingerprints of a fresh planning."""
    ev = []
    ctx = TContext(device="cpu", nparts=P, event_log=ev.append)
    ds = _shrink_query(ctx)
    graph = ds.plan()
    before = [s.fingerprint() for s in graph.stages]
    ctx.executor.run(graph)
    assert [s.fingerprint() for s in graph.stages] == before
    assert not [e for e in ev if e["event"].startswith("adapt")
                or e["event"] == "graph_rewrite"]
    assert ctx.executor._last_run_rewrites == 0


def test_cache_after_a_promote_drops_the_claim(devices8):
    """A promoted join keeps its probe side in place: the output is not
    hash-placed by the join key, so cache() drops the claim."""
    ctx = TContext(device="cpu", nparts=P, config=JobConfig(adaptive="on"))
    ds = _promote_query(ctx)
    assert ds.node.partitioning.kind == "hash"
    cached = ds.cache()
    assert ctx.executor._last_run_placement_changed
    assert cached.node.partitioning.kind == "none"
    plain = TContext(device="cpu", nparts=P)
    assert _promote_query(plain).cache().node.partitioning.kind == "hash"


def test_replay_after_rewrite_is_consistent(devices8):
    """Invalidate the rewritten consumer's result: the lineage replay
    recomputes through the REWRITTEN stage and agrees."""
    ctx = TContext(device="cpu", nparts=P, config=JobConfig(adaptive="on"))
    graph = _shrink_query(ctx).plan()
    run = Run(ctx.executor, graph)
    first = pdata_to_host(run.output())
    assert run.adapt is not None and run.adapt.rewrite_count >= 1
    run.invalidate(graph.out_stage)
    again = pdata_to_host(run.result(graph.out_stage))
    assert _rows(first) == _rows(again)


def test_spill_resume_refuses_rewrite_shaped_outputs(devices8, tmp_path):
    """An adaptive run spills rewrite-shaped outputs with a ``.fp`` file;
    a resume over a fresh (un-rewritten) plan refuses those and loads the
    others; a non-adaptive resume afterwards loads what the second run
    wrote.  Rows stay exact throughout."""
    spill = str(tmp_path / "spill")
    ctx = TContext(device="cpu", nparts=P, config=JobConfig(adaptive="on"))
    ds = _shrink_query(ctx)
    run1 = Run(ctx.executor, ds.plan(), spill_dir=spill)
    first = pdata_to_host(run1.output())
    assert run1.adapt.rewrite_count >= 1
    assert any(f.endswith(".fp") for f in os.listdir(spill))
    log = EventLog()
    run2 = Run(ctx.executor, ds.plan(), spill_dir=spill, event=log)
    second = pdata_to_host(run2.output())
    rewritten = {e["stage"] for e in run1.adapt.applied}
    restored = {e["stage"] for e in log.of_type("stage_restored")}
    assert restored and restored.isdisjoint(rewritten)
    off = TContext(device="cpu", nparts=P)
    third = pdata_to_host(Run(off.executor, _shrink_query(off).plan(),
                              spill_dir=spill).output())
    assert _rows(first) == _rows(second) == _rows(third)


def test_adaptive_run_refuses_bare_spills(devices8, tmp_path):
    """A spill without a ``.fp`` (a non-adaptive run's) is never loaded by
    an adaptive run: it recomputes every stage."""
    spill = str(tmp_path / "spill")
    off = TContext(device="cpu", nparts=P)
    Run(off.executor, _shrink_query(off).plan(), spill_dir=spill).output()
    assert not any(f.endswith(".fp") for f in os.listdir(spill))
    log = EventLog()
    on = TContext(device="cpu", nparts=P, config=JobConfig(adaptive="on"))
    Run(on.executor, _shrink_query(on).plan(), spill_dir=spill,
        event=log).output()
    assert log.of_type("stage_restored") == []
    assert len(log.of_type("stage_done")) == 2


def test_rewrites_drop_their_cost_predictions(devices8):
    """A rewrite reshapes a stage the static model never saw: its
    prediction is dropped, so the cross-check stays silent."""
    from dryad_tpu_torch.analysis.cost import estimate_graph
    log = EventLog()
    ctx = TContext(device="cpu", nparts=P, config=JobConfig(adaptive="on"))
    graph = _shrink_query(ctx).plan()
    rep = estimate_graph(graph, P, config=ctx.config)
    ctx.executor.run(graph, cost_report=rep, event_log=log)
    (rw,) = log.of_type("graph_rewrite")
    assert rep.stage(rw["stage"]) is None and rep.stage(0) is not None
    assert log.of_type("cost_model_miss") == []


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 12, rehearsed on the CPU


def _counting_plain_off_meta(monkeypatch):
    """Every kernel wrapper's plain version bumps the kernel's launch
    counter for data tensors, as the kernel does on the card; on the cost
    model's meta tensors it bumps nothing, as on the card nothing
    launches."""
    from dryad_tpu_torch.ops import hopper_kernels as hk
    for name, plain in (("hist_buckets", "hist_buckets_batched_plain"),
                        ("prefix_sum", "prefix_sum_plain"),
                        ("prefix_sum2", "prefix_sum2_plain"),
                        ("slot_expand", "slot_expand_batched_plain"),
                        ("slot_compact", "slot_compact_batched_plain")):
        real = getattr(hk, plain)

        def bump(*a, _real=real, _name=name):
            if a[0].device.type != "meta":
                hk.launches[_name] += 1
            return _real(*a)
        monkeypatch.setattr(hk, plain, bump)


def test_chip_smoke_phase12_rehearsal(devices8, monkeypatch, tmp_path):
    """chip_smoke.py's phase 12 on the CPU at reduced sizes (the cells at
    30,000 / 120,000 lineitems and 20,000 orders, the BASELINE apps small,
    the oracle cells at 2,000 rows): each cell records its rewrite with
    adaptation on and none off, rows equal between the modes and numpy,
    no cost_model_miss in the eight cost-checked runs, the card path and
    local_debug agree, and every kernel's calls are held."""
    import torch

    import chip_smoke
    from dryad_tpu_torch.apps import groupbyreduce as tgbr
    from dryad_tpu_torch.apps import kmeans as tkm
    from dryad_tpu_torch.apps import pagerank as tpr
    from dryad_tpu_torch.apps import terasort as tts
    from dryad_tpu_torch.apps import wordcount as twc
    from dryad_tpu_torch.ops import hopper_kernels as hk

    _counting_plain_off_meta(monkeypatch)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda: {})
    monkeypatch.setattr(chip_smoke, "profile_path", lambda *a, **k: {
        "wall_s": 1.0, "device_ms": None})
    monkeypatch.setattr(chip_smoke, "PR_ITERS", 3)
    monkeypatch.setattr(chip_smoke, "KM_ITERS", 2)
    port = types.SimpleNamespace(
        Context=lambda device="cuda", **kw: TContext(device="cpu", **kw),
        JobConfig=JobConfig)
    runs = {}

    def held(label, launches, captured):
        runs[label] = (launches, chip_smoke.hold_run(hk, label, captured))

    cells = chip_smoke.adapt_cells(port, hk, chip_smoke.phase12_cells(
        30_000, 120_000, 20_000), str(tmp_path), held)
    (shrink,) = cells["adaptshrink6m"]["on"]["rewrites"]
    assert (shrink["kind"], shrink["cap_before"], shrink["cap_after"]) == \
        ("repartition_shrink", 131072, 1024)
    assert [r["kind"] for r in cells["q17promote6m"]["on"]["rewrites"]] \
        == ["broadcast_promote"]
    assert [r["kind"] for r in cells["demote1m"]["on"]["rewrites"]] == \
        ["broadcast_demote"]
    for label, c in cells.items():
        assert c["off"]["rewrites"] == [] and c["off"]["cost"]["misses"] == 0
        # adaptive runs read every stage attempt back, the others once
        assert c["on"]["need_reads_warm"][0] > c["off"]["need_reads_warm"][0]
    launched = {k: {m: c[m]["launches"] for m in ("off", "on")}
                for k, c in cells.items()}
    # the shrink changes capacities only: the same launches
    assert launched["adaptshrink6m"]["on"] == \
        launched["adaptshrink6m"]["off"]
    # the promote drops both of the join's hash exchanges for one
    # broadcast (one slot_compact); the demote does the reverse
    on, off = launched["q17promote6m"]["on"], launched["q17promote6m"]["off"]
    assert on["slot_expand"] == 2 and on["slot_compact"] == 3
    assert off["slot_expand"] >= 4 and off["slot_compact"] == \
        off["slot_expand"]
    on, off = launched["demote1m"]["on"], launched["demote1m"]["off"]
    assert off["slot_compact"] > off["slot_expand"] >= 2
    assert on["slot_compact"] == on["slot_expand"] >= 4

    lines = chip_smoke.bench_corpus(400)
    counts = chip_smoke.oracle(lines)
    gdata = tgbr.gen_pairs(20_000, 100, seed=0)
    recs = tts.gen_records(5_000, seed=0)
    edges = tpr.gen_graph(500, 5_000, seed=0)
    pts, _ = tkm.gen_points(4_000, chip_smoke.KM_DIM, chip_smoke.KM_K)

    def wc_ok(out):
        assert dict(zip(out["line"], map(int, out["n"]))) == counts

    cost = chip_smoke.cost_runs(port, hk, {
        "zipf50k": (lambda c: twc.wordcount_query(
            c.from_columns({"line": lines}), tokens_per_partition=800)
            .collect(), wc_ok),
        "app10k": (lambda c: tgbr.groupbyreduce_query(
            c.from_columns(gdata)).collect(), lambda out: None),
        "terasort1m": (lambda c: tts.terasort_query(c.from_columns(
            recs, str_max_len=10)).collect(), lambda out: None),
        "pagerank100k": (lambda c: tpr.pagerank(c, edges, 500, n_iters=3),
                         lambda out: chip_smoke.check_pagerank(
                             out, edges, 500, tpr)),
        "kmeans500k": (lambda c: tkm.kmeans(c, pts, chip_smoke.KM_K,
                                            n_iters=2), lambda out: None),
    }, held)
    assert all(r["misses"] == 0 and r["stages"] >= 1
               for r in cost.values())
    oracle = chip_smoke.oracle_runs(
        port, hk, chip_smoke.phase12_cells(2_000, 2_000, 2_000), twc,
        lines[:200], held)
    assert set(oracle) == {"adaptshrink6m", "q17promote6m", "demote1m",
                           "wordcount_bench12"}
    assert {k for _, errs in runs.values() for k in errs} == \
        set(chip_smoke.TPU_KERNEL)
    assert all(e == 0.0 for _, errs in runs.values() for e in errs.values())
