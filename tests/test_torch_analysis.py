"""The port's static analysis (``dryad_tpu_torch.analysis``: the plan
verifier, the UDF lint, the serialized-plan lint and the pre-submit gate)
against the JAX package's (``dryad_tpu.analysis``).

The DAGs of ``tests/test_analysis.py`` are built in both packages (the
same module-level UDFs, each package's Context, Decomposable, chunk
source and nodes) and checked: the findings agree as multisets of (code,
severity, node).  ``lint_udf`` gives the same codes on the same lines for
the same UDF sources, plus the torch cases: a captured tensor on the card
at any size, a large CPU tensor, torch's global-generator calls.  Also:
``JobConfig.lint="error"`` refuses before anything runs, the port's apps
check clean, and the code sets are the JAX package's."""

import inspect
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

import dryad_tpu
import dryad_tpu.analysis as janalysis
import dryad_tpu.exec.ooc as jooc
import dryad_tpu.plan.expr as JE
import dryad_tpu_torch
import dryad_tpu_torch.analysis as tanalysis
import dryad_tpu_torch.exec.ooc as tooc
import dryad_tpu_torch.plan.expr as TE
from dryad_tpu_torch import JobConfig
from dryad_tpu_torch.analysis import LintError, check_plan_json
from dryad_tpu_torch.analysis.udf_lint import lint_udf
from dryad_tpu_torch.utils.events import EventLog
from tests.torch_threads import one_torch_thread  # noqa: F401

P = 8
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX = types.SimpleNamespace(
    name="jax", an=janalysis, E=JE, ChunkSource=jooc.ChunkSource,
    Decomposable=dryad_tpu.Decomposable,
    Context=lambda **kw: dryad_tpu.Context(**kw))
PORT = types.SimpleNamespace(
    name="port", an=tanalysis, E=TE, ChunkSource=tooc.ChunkSource,
    Decomposable=dryad_tpu_torch.Decomposable,
    Context=lambda **kw: dryad_tpu_torch.Context(device="cpu", nparts=P,
                                                 **kw))


# module-level (shippable) UDFs: the same objects in both packages ----------

def doubler(c):
    return {"k": c["k"], "v": c["v"] * 2}


def nondet_udf(c):
    return {"k": c["k"], "v": c["v"] + time.time()}


def fixed_seed_udf(c):
    rng = np.random.RandomState(0)
    return {"k": c["k"], "v": c["v"] + rng.randn()}


def kw_seeded_udf(c):
    rng = np.random.default_rng(seed=42)
    return {"k": c["k"], "v": c["v"] + rng.random()}


def identity_dep_udf(c):
    return {"k": c["k"], "v": c["v"] + id(c)}


def set_iter_udf(c):
    s = 0
    for x in {1, 2, 3}:
        s += x
    return {"k": c["k"], "v": c["v"] + s}


_LEAKY_STATE = []


def leaky_udf(c):
    _LEAKY_STATE.append(1)
    return {"k": c["k"], "v": c["v"]}


_STATE = {"k": []}


def sub_mut_udf(c):
    _STATE["k"].append(1)
    return c


_BIG_CONST = np.zeros(32768, np.float32)       # 128 KiB: over the line
_SMALL_CONST = np.zeros(16, np.float32)


def big_capture_udf(c):
    return {"k": c["k"], "v": c["v"] + _BIG_CONST[0]}


def small_capture_udf(c):
    return {"k": c["k"], "v": c["v"] + _SMALL_CONST[0]}


def shadowing_udf(c):
    _BIG_CONST = c["v"] * 2        # noqa: N806 — shadows the module array
    return {"k": c["k"], "v": _BIG_CONST}


def param_udf(c, _BIG_CONST=0):    # noqa: N803
    return {"k": c["k"], "v": c["v"] + _BIG_CONST}


import time as _aliased_time  # noqa: E402
from datetime import datetime as _aliased_dt  # noqa: E402

import math as _aliased_math  # noqa: E402
import numpy.random as _aliased_npr  # noqa: E402


def aliased_time_udf(c):
    return {"k": c["k"], "v": c["v"] + _aliased_time.time()}


def aliased_datetime_udf(c):
    return {"k": c["k"], "v": c["v"] + _aliased_dt.now().second}


def aliased_nprandom_udf(c):
    return {"k": c["k"], "v": c["v"] + _aliased_npr.rand()}


def aliased_math_udf(c):
    return {"k": c["k"], "v": _aliased_math.sqrt(c["v"])}


def inline_import_alias_udf(c):
    import random as r
    return {"k": c["k"], "v": c["v"] + r.random()}


def aliased_seeded_udf(c):
    rng = _aliased_npr.RandomState(0)
    return {"k": c["k"], "v": c["v"] + rng.randn()}


def fm_fn(c):
    return {"k": c["k"]}, None


SHARED_UDFS = [doubler, nondet_udf, fixed_seed_udf, kw_seeded_udf,
               identity_dep_udf, set_iter_udf, leaky_udf, sub_mut_udf,
               big_capture_udf, small_capture_udf, shadowing_udf,
               param_udf, aliased_time_udf, aliased_datetime_udf,
               aliased_nprandom_udf, aliased_math_udf,
               inline_import_alias_udf, aliased_seeded_udf, fm_fn]


# -- the DAGs of tests/test_analysis.py, in either package -------------------

def _kv(ctx):
    return ctx.from_columns({"k": np.arange(8, dtype=np.int32),
                             "v": np.arange(8, dtype=np.float32)})


def _stream(ns, ctx):
    cs = ns.ChunkSource(lambda: iter([]),
                        {"k": {"kind": "num", "dtype": "int32"}}, 8)
    return ctx.from_stream(cs)


def _dec(ns):
    return ns.Decomposable(seed=doubler, merge=doubler)


_LAMBDA = lambda c: {"k": c["k"]}  # noqa: E731


def _tee(ns, ctx):
    base = _kv(ctx).select(doubler)
    return base.where(doubler).concat(base.where(doubler))


def _tee_hazard(ns, ctx):
    q = _kv(ctx).flat_map(fm_fn, out_capacity=16)
    return q.group_by(["k"], {"s": ("sum", "v")}).concat(
        q.group_by(["k"], {"s": ("max", "v")}))


def _placeholder(ns, ctx):
    ph = ns.E.Placeholder(parents=(), name="__loop", _npartitions=ctx.nparts)
    return ns.E.Concat(parents=(_stream(ns, ctx).node, ph))


def _one_pass(ns, ctx):
    return (_stream(ns, ctx).select(nondet_udf).select(lambda c: dict(c))
            .hash_partition(["k"]).hash_partition(["k"]).take(3))


# name -> (build(ns, ctx) -> Dataset | Node, cluster, context kwargs(ns))
DAGS = {
    "dta002_placeholder": (_placeholder, True, None),
    "dta010_flat_map": (lambda ns, c: _kv(c).flat_map(fm_fn, out_capacity=16),
                        False, None),
    "dta010_capped": (lambda ns, c: _kv(c).flat_map(
        fm_fn, out_capacity=16).with_capacity(32), False, None),
    "dta010_join": (lambda ns, c: _kv(c).join(_kv(c), ["k"], ["k"]), False,
                    None),
    "dta010_bcast": (lambda ns, c: _kv(c).join(_kv(c), ["k"], ["k"],
                                               broadcast=True), False, None),
    "dta011_hash": (lambda ns, c: _kv(c).hash_partition(["k"])
                    .hash_partition(["k"]), False, None),
    "dta011_range": (lambda ns, c: _kv(c).order_by([("k", False)])
                     .range_partition(["k"]), False, None),
    "dta011_other_key": (lambda ns, c: _kv(c).hash_partition(["k"])
                         .hash_partition(["v"]), False, None),
    "dta012_tee": (_tee, False, None),
    "dta012_tee_hazard_once": (_tee_hazard, False, None),
    "dta013_unsound": (lambda ns, c: _kv(c).hash_partition(["k"])
                       .assume_hash_partition(["v"]), False, None),
    "dta013_sound": (lambda ns, c: _kv(c).hash_partition(["k"])
                     .assume_hash_partition(["k"]), False, None),
    "dta017_group": (lambda ns, c: _kv(c).hash_partition(["k"]).group_by(
        ["k"], {"s": ("sum", "v")}), False, None),
    "dta017_assume": (lambda ns, c: _kv(c).assume_hash_partition(["k"])
                      .distinct(["k"]), False, None),
    "dta017_range": (lambda ns, c: _kv(c).range_partition(["k"])
                     .order_by([("k", False)]), False, None),
    "dta017_range_desc": (lambda ns, c: _kv(c).range_partition(["k"])
                          .order_by([("k", True)]), False, None),
    "dta017_join": (lambda ns, c: _kv(c).hash_partition(["k"]).join(
        _kv(c).select(doubler), ["k"], ["k"]), False, None),
    "dta017_natural": (lambda ns, c: _kv(c).group_by(
        ["k"], {"s": ("sum", "v")}).group_by(["k"], {"n": ("count", None)}),
        False, None),
    "dta017_other_key": (lambda ns, c: _kv(c).hash_partition(["v"])
                         .group_by(["k"], {"s": ("sum", "v")}), False, None),
    "dta017_no_consumer": (lambda ns, c: _kv(c).hash_partition(["k"]),
                           False, None),
    "dta017_bcast_join": (lambda ns, c: _kv(c).hash_partition(["k"]).join(
        _kv(c).select(doubler), ["k"], ["k"], broadcast=True), False, None),
    "dta014_lambda": (lambda ns, c: _kv(c).select(_LAMBDA), True, None),
    "dta014_local": (lambda ns, c: _kv(c).select(_LAMBDA), False, None),
    "dta014_module_fn": (lambda ns, c: _kv(c).select(doubler), True, None),
    "dta014_registered": (lambda ns, c: _kv(c).select(_LAMBDA), True,
                          lambda ns: {"fn_table": {"my_fn": _LAMBDA}}),
    "dta016_decomposable": (lambda ns, c: _kv(c).group_by(
        ["k"], {"agg": _dec(ns)}), True, None),
    "all_in_one_pass": (_one_pass, True, None),
}
for _udf in SHARED_UDFS[:-1]:
    DAGS[f"udf_{_udf.__name__}"] = (
        (lambda ns, c, f=_udf: _kv(c).select(f)), False, None)


def _report(ns, name):
    build, cluster, ctx_kw = DAGS[name]
    ctx = ns.Context(**(ctx_kw(ns) if ctx_kw else {}))
    q = build(ns, ctx)
    if isinstance(q, (JE.Node, TE.Node)):
        return ns.an.check_plan(q, cluster=cluster)
    return q.check(cluster=cluster)


def _findings(rep):
    return sorted((d.code, d.severity, d.node) for d in rep)


@pytest.mark.parametrize("name", sorted(DAGS))
def test_check_plan_matches_jax(name):
    got, want = _report(PORT, name), _report(JAX, name)
    assert _findings(got) == _findings(want)
    # the spans point at the same files (this one, or a UDF here)
    assert sorted({os.path.basename(d.span.file) for d in got if d.span}) \
        == sorted({os.path.basename(d.span.file) for d in want if d.span})


def test_dag_expectations_on_the_port():
    """Spot values of tests/test_analysis.py, on the port."""
    codes = {n: _report(PORT, n).codes() for n in DAGS}
    assert "DTA010" in codes["dta010_flat_map"]
    assert "DTA010" not in codes["dta010_capped"]
    assert {d.severity for d in _report(PORT, "dta010_join")
            .by_code("DTA010")} == {"info"}
    assert "DTA011" not in codes["dta011_other_key"]
    assert "DTA017" in codes["dta017_join"]
    assert "DTA017" not in codes["dta017_bcast_join"]
    assert "DTA014" not in codes["dta014_registered"]
    assert "DTA014" not in codes["dta014_local"]
    assert {"DTA011", "DTA014", "DTA101"} <= codes["all_in_one_pass"]
    assert len(_report(PORT, "dta012_tee_hazard_once")
               .by_code("DTA010")) == 1
    d = _report(PORT, "dta011_hash").by_code("DTA011")[0]
    assert d.span.file == __file__
    rep = _report(PORT, "all_in_one_pass")
    sevs = [d.severity for d in rep]
    assert sevs == sorted(sevs, key=["error", "warn", "info"].index)


def test_dta003_mirrors_unsupported_map(monkeypatch):
    from dryad_tpu_torch.analysis import plan_rules
    ctx = PORT.Context()
    q = _stream(PORT, ctx).zip_with(_stream(PORT, ctx))
    assert "DTA003" not in q.check(cluster=True).codes()
    monkeypatch.setattr(plan_rules, "_UNSUPPORTED", {"zip": "testing"})
    assert "DTA003" in q.check(cluster=True).codes()


def test_check_runs_nothing():
    ctx = PORT.Context()
    ctx.executor.run = lambda *a, **k: pytest.fail("check() executed")
    rep = _one_pass(PORT, ctx).check(cluster=True)
    assert rep.errors
    rep = _kv(ctx).select(doubler).check(cost=True)
    assert rep.clean and "DTA205" in rep.codes()


# -- the UDF lint ------------------------------------------------------------

@pytest.mark.parametrize("fn", SHARED_UDFS, ids=lambda f: f.__name__)
def test_lint_udf_matches_jax(fn):
    from dryad_tpu.analysis.udf_lint import lint_udf as jlint_udf
    got = [(d.code, d.severity, d.span.line) for d in lint_udf(fn)]
    want = [(d.code, d.severity, d.span.line) for d in jlint_udf(fn)]
    assert got == want
    src, first = inspect.getsourcelines(fn)
    assert all(first <= line < first + len(src) for _c, _s, line in got)


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports itself as on the card (no card here)."""

    @property
    def is_cuda(self):
        return True


_CARD_T = torch.Tensor._make_subclass(_CudaTyped, torch.zeros(4))
_BIG_T = torch.zeros(32768)                        # 128 KiB
_SMALL_T = torch.zeros(16)


def card_tensor_udf(c):
    return {"k": c["k"], "v": c["v"] + _CARD_T[0]}


def big_tensor_udf(c):
    return {"k": c["k"], "v": c["v"] + _BIG_T[0]}


def small_tensor_udf(c):
    return {"k": c["k"], "v": c["v"] + _SMALL_T[0]}


def torch_rand_udf(c):
    return {"k": c["k"], "v": c["v"] + torch.rand(1)}


def torch_randn_like_udf(c):
    return {"k": c["k"], "v": torch.randn_like(c["v"])}


def torch_randint_udf(c):
    return {"k": c["k"] + torch.randint(0, 5, (1,)), "v": c["v"]}


def torch_randperm_udf(c):
    return {"k": c["k"][torch.randperm(len(c["k"]))], "v": c["v"]}


def torch_normal_udf(c):
    return {"k": c["k"], "v": c["v"] + torch.normal(0.0, 1.0, (1,))}


def torch_alias_udf(c):
    import torch as T
    return {"k": c["k"], "v": c["v"] + T.rand(1)}


_GEN = torch.Generator().manual_seed(0)


def torch_seeded_udf(c):
    return {"k": c["k"], "v": c["v"] + torch.rand(1, generator=_GEN)}


def torch_clean_udf(c):
    return {"k": c["k"], "v": torch.sqrt(c["v"]) + torch.ones(1)}


TORCH_UDFS = {card_tensor_udf: {"DTA105"}, big_tensor_udf: {"DTA105"},
              small_tensor_udf: set(), torch_rand_udf: {"DTA101"},
              torch_randn_like_udf: {"DTA101"},
              torch_randint_udf: {"DTA101"},
              torch_randperm_udf: {"DTA101"}, torch_normal_udf: {"DTA101"},
              torch_alias_udf: {"DTA101"}, torch_seeded_udf: set(),
              torch_clean_udf: set()}


@pytest.mark.parametrize("fn", list(TORCH_UDFS), ids=lambda f: f.__name__)
def test_lint_udf_torch_cases(fn):
    """A tensor on the card is a DTA105 capture at any size, a CPU tensor
    from DTA105_NDARRAY_BYTES; torch's global-generator calls are DTA101
    unless they name a generator; the findings point inside the UDF."""
    found = lint_udf(fn)
    assert {d.code for d in found} == TORCH_UDFS[fn]
    src, first = inspect.getsourcelines(fn)
    assert all(first <= d.span.line < first + len(src) for d in found)
    if fn is card_tensor_udf:
        assert "device array" in found[0].message
    if found:
        q = _kv(PORT.Context()).select(fn)
        assert TORCH_UDFS[fn] <= q.check().codes()


# -- the pre-submit gate -------------------------------------------------------

def test_lint_error_refuses_before_anything_runs():
    """lint="error": an unshippable UDF of a cluster submission and a plan
    provably over the device budget (DTA201) raise LintError before the
    executor is called."""
    from dryad_tpu_torch.ops import hopper_kernels as hk
    ctx = PORT.Context(config=JobConfig(lint="error"))
    q = _kv(ctx).select(lambda c: dict(c))
    with pytest.raises(LintError) as ei:
        ctx._pre_submit_lint(q.node, cluster=True)
    assert "DTA014" in str(ei.value)
    assert len(q.collect()["k"]) == 8     # no error finding locally
    ctx = PORT.Context(config=JobConfig(lint="error", device_hbm_bytes=4096))
    ctx.executor.run = lambda *a, **k: pytest.fail("the gate let it run")
    before = dict(hk.launches)
    big = ctx.from_columns({"k": np.arange(20_000, dtype=np.int32) % 7,
                            "v": np.ones(20_000, np.float32)})
    q = big.join(big, ["k"], ["k"]).group_by(["k"], {"s": ("sum", "v")})
    with pytest.raises(LintError) as ei:
        q.collect()
    assert "DTA201" in ei.value.report.codes()
    assert dict(hk.launches) == before


def test_lint_warn_runs_and_logs():
    """lint="warn": the job runs; the findings, the cost report and the
    plan are events, and the run is cross-checked (no cost_model_miss)."""
    ev = EventLog()
    ctx = PORT.Context(config=JobConfig(lint="warn"), event_log=ev)
    out = _kv(ctx).hash_partition(["k"]).hash_partition(["k"]).collect()
    assert sorted(np.asarray(out["k"])) == list(range(8))
    findings = ev.of_type("lint_finding")
    assert any(e["code"] == "DTA011" for e in findings)
    assert all(e["span"] and e["severity"] in ("error", "warn", "info")
               for e in findings if e["code"] == "DTA011")
    kinds = [e["event"] for e in ev.events]
    assert kinds.count("cost_report") == 1 and kinds.count("plan") == 1
    assert "cost_model_miss" not in kinds
    # a streamed plan takes the gate too (its cost report says streamed)
    ev2 = EventLog()
    sctx = PORT.Context(config=JobConfig(lint="warn"), event_log=ev2)
    cs = tooc.ChunkSource.from_arrays(
        {"k": np.arange(100, dtype=np.int32) % 3}, 32)
    assert sctx.from_stream(cs).count() == 100
    rep = ev2.of_type("cost_report")
    assert len(rep) == 1 and rep[0]["report"]["streamed"]


def test_lint_off_by_default():
    assert JobConfig().lint == "off"
    with pytest.raises(ValueError):
        JobConfig(lint="loud")
    ev = EventLog()
    _kv(PORT.Context(event_log=ev)).collect()
    assert not ev.of_type("lint_finding") and not ev.of_type("cost_report")


def test_explain_verify():
    ctx = PORT.Context()
    q = _kv(ctx).hash_partition(["k"]).hash_partition(["k"])
    out = q.explain(verify=True)
    assert "diagnostics:" in out and "DTA011" in out
    assert "DTA011" not in q.explain()
    assert "predicted cost:" in q.explain(cost=True)


# -- the port's apps check clean ---------------------------------------------

def _app_pipelines(ctx):
    from dryad_tpu_torch.apps.groupbyreduce import (gen_pairs,
                                                    groupbyreduce_query)
    from dryad_tpu_torch.apps.kmeans import (_assign_fn, _assign_host,
                                             gen_points)
    from dryad_tpu_torch.apps.pagerank import gen_graph
    from dryad_tpu_torch.apps.terasort import gen_records, terasort_query
    from dryad_tpu_torch.apps.wordcount import wordcount_query
    out = {}
    lines = ctx.from_columns({"line": [b"a b c", b"b c"]}, str_max_len=16)
    out["wordcount"] = wordcount_query(lines, tokens_per_partition=64)
    out["terasort"] = terasort_query(
        ctx.from_columns(gen_records(64), str_max_len=10))
    out["groupbyreduce"] = groupbyreduce_query(
        ctx.from_columns(gen_pairs(64, 4)))
    pts_cols, _ = gen_points(64, 4, 3)
    cents = ctx.from_columns({"cid": np.arange(3, dtype=np.int32),
                              "cx": np.zeros((3, 4), np.float32)})
    out["kmeans-step"] = (ctx.from_columns(pts_cols)
                          .cross_apply(cents, _assign_fn,
                                       host_fn=_assign_host)
                          .group_by(["cid"], {"cx": ("mean", "x")})
                          .with_capacity(3))
    edges = ctx.from_columns(gen_graph(32, 64))
    deg = edges.group_by(["src"], {"deg": ("count", None)})
    ranks = ctx.from_columns({"node": np.arange(32, dtype=np.int32),
                              "rank": np.full(32, 1 / 32, np.float32)})
    contribs = (edges.join(deg, ["src"], ["src"], expansion=2.0,
                           right_unique=True)
                .join(ranks, ["src"], ["node"], expansion=2.0,
                      right_unique=True))
    out["pagerank-step"] = (contribs
                            .select(lambda c: {"node": c["dst"],
                                               "c": c["rank"] / c["deg"]})
                            .group_by(["node"], {"s": ("sum", "c")})
                            .with_capacity(64))
    return out


@pytest.mark.parametrize("app", ["wordcount", "terasort", "groupbyreduce",
                                 "kmeans-step", "pagerank-step"])
def test_apps_check_clean(app):
    q = _app_pipelines(PORT.Context())[app]
    rep = q.check()
    assert rep.clean, rep.render()
    crep = q.check(cost=True)
    assert crep.clean, crep.render()
    assert "DTA205" in crep.codes()


# -- codes, dedup, the serialized-plan lint and its CLI -----------------------

def test_code_sets_equal_jax():
    assert tanalysis.CODES == janalysis.CODES
    assert tanalysis.STATIC_RULE_CODES == janalysis.STATIC_RULE_CODES
    assert tanalysis.RUNTIME_ONLY_CODES == janalysis.RUNTIME_ONLY_CODES
    assert [(r.code, r.name) for r in tanalysis.RULES] == \
        [(r.code, r.name) for r in janalysis.RULES]
    assert {r.code for r in tanalysis.RULES} <= set(tanalysis.CODES)
    assert not tanalysis.STATIC_RULE_CODES & tanalysis.RUNTIME_ONLY_CODES


def test_report_dedup_consumer_count():
    from dryad_tpu_torch.analysis.diagnostics import (DiagnosticReport,
                                                      Span)
    rep = DiagnosticReport()
    sp = Span("q.py", 7)
    for _ in range(2):
        rep.add("DTA010", "warn", "capacity is a static guess", span=sp,
                node="FlatMap:fm")
    rep.add("DTA010", "warn", "capacity is a static guess",
            span=Span("q.py", 9), node="FlatMap:fm2")
    rep.add("DTA102", "warn", "id() depends on placement", span=sp)
    rep.add("DTA102", "warn", "hash() is salted per process", span=sp)
    rep.dedup()
    assert len(rep.by_code("DTA102")) == 2
    d10 = rep.by_code("DTA010")
    assert len(d10) == 2
    assert [d.message for d in d10 if d.span == sp] == \
        ["capacity is a static guess [x2 consumer paths]"]
    rep.dedup()
    assert [d.message for d in rep.by_code("DTA010")] == \
        [d.message for d in d10]


def _plan_jsons():
    from dryad_tpu_torch.plan.serialize import graph_to_json
    ctx = PORT.Context()
    fn = lambda c: dict(c)  # noqa: E731
    return {
        "anonymous": graph_to_json(_kv(ctx).select(fn).take(2).plan()),
        "named": graph_to_json(_kv(ctx).select(fn).plan(), {id(fn): "myfn"}),
        "clean": graph_to_json(_kv(ctx).group_by(
            ["k"], {"n": ("count", None)}).plan()),
        "decomposable": graph_to_json(_kv(ctx).group_by(
            ["k"], {"d": _dec(PORT)}).plan()),
    }


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("name", ["anonymous", "named", "clean",
                                  "decomposable"])
def test_check_plan_json_matches_jax(name, stream):
    js = _plan_jsons()[name]
    got = check_plan_json(js, stream=stream)
    want = janalysis.check_plan_json(js, stream=stream)
    assert _findings(got) == _findings(want)
    assert [str(d.span) for d in got.sorted()] == \
        [str(d.span) for d in want.sorted()]
    expect = {"anonymous": {"DTA905"}, "named": {"DTA905"}, "clean": set(),
              "decomposable": {"DTA016"}}[name]
    assert got.codes() == expect
    assert bool(got.errors) == (name in ("anonymous", "decomposable"))


def test_analysis_cli(tmp_path, capsys):
    from dryad_tpu_torch.analysis.__main__ import main
    plans = _plan_jsons()
    for name, rc in (("anonymous", 1), ("named", 0), ("clean", 0)):
        p = tmp_path / f"{name}.json"
        p.write_text(plans[name])
        assert main([str(p)]) == rc
    assert main([str(tmp_path / "clean.json"), "--cost", "--nparts",
                 "8"]) == 0
    assert "peak per-device working set" in capsys.readouterr().out
    golden = os.path.join(ROOT, "docs", "plans", "sql_join_revenue.json")
    out = subprocess.run([sys.executable, "-m", "dryad_tpu_torch.analysis",
                          golden, "--cost", "--nparts", "8"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("no findings")
    assert json.loads(open(golden).read())["out_stage"] == 3
