"""The port's JSON plan (``dryad_tpu_torch.plan.serialize``) and its
creation spans, against the JAX package's wire format and the committed
plans in ``docs/plans/``.

The SQL golden plans are the port's ``sql.offline_plan_json`` byte for
byte once the shipped class refs' package prefix is rewritten
(``"dryad_tpu.`` -> ``"dryad_tpu_torch.``; their spans point into the
``.sql`` text); ``wordcount.json`` / ``terasort.json`` carry absolute
spans into the JAX package's apps, so they are held to the port's plans
with the spans left out.  ``estimate_plan_json`` gives the JAX package's
table on all four.  The port's plans round-trip; every executor run
emits its ``plan`` event."""

import json
import os

import numpy as np
import pytest

from dryad_tpu.analysis.cost import estimate_plan_json as jestimate_plan_json
from dryad_tpu_torch import Context as TContext
from dryad_tpu_torch import Decomposable, JobConfig, sql
from dryad_tpu_torch.analysis.cost import estimate_plan_json
from dryad_tpu_torch.apps import terasort as tts
from dryad_tpu_torch.apps import wordcount as twc
from dryad_tpu_torch.plan import expr as E
from dryad_tpu_torch.plan.serialize import (graph_from_json, graph_to_json,
                                            import_ref, ship_ref_of)
from dryad_tpu_torch.plan.stages import Leg, Stage, StageOp
from dryad_tpu_torch.utils.events import EventLog
from tests.torch_threads import one_torch_thread  # noqa: F401

P = 8
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLANS = os.path.join(ROOT, "docs", "plans")
SQL_GOLDEN = ("sql_join_revenue", "sql_scan_topk")


def _tctx(**kw):
    return TContext(device="cpu", nparts=P, **kw)


def _golden(name, port_prefix=True):
    with open(os.path.join(PLANS, name + ".json")) as f:
        text = f.read()
    return text.replace('"dryad_tpu.', '"dryad_tpu_torch.') \
        if port_prefix else text


def _strip_spans(js):
    d = json.loads(js)
    for st in d["stages"]:
        for op in [o for leg in st["legs"] for o in leg["ops"]] + st["body"]:
            op.pop("span", None)
    return d


def _slots(js):
    d = json.loads(js)
    return {f"{st['id']}:{i}": None for st in d["stages"]
            for i, leg in enumerate(st["legs"]) if "source" in leg["src"]}


def doubler(c):
    return {"k": c["k"], "v": c["v"] * 2}


def _kv(ctx, n=64):
    return ctx.from_columns({"k": np.arange(n, dtype=np.int32) % 7,
                             "v": np.arange(n, dtype=np.int32)})


# -- the committed plans ------------------------------------------------------

@pytest.mark.parametrize("name", SQL_GOLDEN)
def test_sql_golden_plans_byte_for_byte(name):
    cat = sql.Catalog.load(os.path.join(PLANS, "sql_catalog.json"))
    with open(os.path.join(PLANS, name + ".sql")) as f:
        text = f.read()
    js = sql.offline_plan_json(cat, text, nparts=8, origin=name + ".sql")
    assert js == _golden(name)


@pytest.mark.parametrize("name", SQL_GOLDEN)
def test_sql_golden_plans_round_trip(name):
    """The golden rebuilds with an empty fn_table (its row expressions
    are data) and re-serializes byte for byte."""
    js = _golden(name)
    g = graph_from_json(js, fn_table={}, sources=_slots(js))
    assert graph_to_json(g) == js
    ops = [o for st in g.stages for leg in st.legs for o in leg.ops]
    assert all(o.span and o.span[0] == name + ".sql" for o in ops)
    assert all(ship_ref_of(o.params["fn"]).startswith("dryad_tpu_torch.")
               for o in ops if "fn" in o.params)


def _wordcount_plan():
    ctx = _tctx()
    lines = ctx.from_columns({"line": [b"a b c", b"b c"]}, str_max_len=16)
    return twc.wordcount_query(lines, tokens_per_partition=128).plan()


def _terasort_plan():
    ctx = _tctx()
    return tts.terasort_query(ctx.from_columns(tts.gen_records(64),
                                               str_max_len=10)).plan()


APP_PLANS = {"wordcount": _wordcount_plan, "terasort": _terasort_plan}


@pytest.mark.parametrize("name", sorted(APP_PLANS))
def test_app_golden_plans_without_spans(name):
    """The port's app plans are the committed JAX plans, spans apart; the
    port's spans point into its own apps (a user-shaped sample)."""
    graph = APP_PLANS[name]()
    js = graph_to_json(graph)
    assert _strip_spans(js) == _strip_spans(_golden(name, False))
    spans = {o.span[0] for st in graph.stages
             for o in [o for leg in st.legs for o in leg.ops] + st.body
             if o.span}
    assert spans and all(s.endswith(os.path.join("dryad_tpu_torch", "apps",
                                                  name + ".py"))
                         or s.endswith("test_torch_plan_serialize.py")
                         for s in spans)


ALL_GOLDEN = SQL_GOLDEN + ("terasort", "wordcount")


@pytest.mark.parametrize("nparts", [1, 8])
@pytest.mark.parametrize("name", ALL_GOLDEN)
def test_estimate_plan_json_matches_jax(name, nparts):
    js = _golden(name, port_prefix=False)
    got = estimate_plan_json(js, nparts=nparts)
    want = jestimate_plan_json(js, nparts=nparts)
    assert [(s.stage, s.label, s.capacity, s.rows.as_tuple(),
             s.out_bytes.as_tuple(), s.approx) for s in got.stages] == \
        [(s.stage, s.label, s.capacity, s.rows.as_tuple(),
          s.out_bytes.as_tuple(), s.approx) for s in want.stages]
    assert got.render() == want.render()
    assert any(s.capacity for s in got.stages)


# -- round trips of the port's plans ------------------------------------------

def _graphs():
    ctx = _tctx()
    kv = _kv(ctx)
    other = _kv(ctx, 20).select(doubler)
    dec = Decomposable(seed=lambda c: c["v"], merge=lambda a, b: a + b)
    return {
        "join_group_sort": kv.join(other, ["k"], ["k"], how="left")
        .group_by(["k"], {"s": ("sum", "v"), "n": ("count", None)})
        .order_by([("s", True)]).take(3),
        "decomposable": kv.group_by(["k"], {"d": dec}),
        "setops_distinct": kv.union(other).distinct(["k"]),
        "strings": ctx.from_columns({"s": [b"x", b"y\xff"], "v": np.arange(
            2, dtype=np.int32)}).where(lambda c: c["v"] > 0),
    }


@pytest.mark.parametrize("name", ["join_group_sort", "decomposable",
                                  "setops_distinct", "strings"])
def test_port_plans_round_trip(name):
    """graph_to_json -> graph_from_json (callables re-bound by name, the
    sources by slot) -> graph_to_json is the identity, and the rebuilt
    stages fingerprint as the originals."""
    graph = _graphs()[name].plan()
    js = graph_to_json(graph)
    d = json.loads(js)

    def refs(v, out):
        if isinstance(v, dict):
            for key in ("__fn__", "__opaque__"):
                if key in v:
                    out.add(v[key])
            for x in v.values():
                refs(x, out)
        elif isinstance(v, list):
            for x in v:
                refs(x, out)
    found = set()
    refs(d, found)
    # bind each reference to the object it named
    objs = {}
    for st in graph.stages:
        for op in [o for leg in st.legs for o in leg.ops] + st.body:
            for k, v in op.params.items():
                objs[f"fn_{id(v):x}"] = v
                objs[f"{op.kind}.{k}"] = v
                if isinstance(v, dict):
                    # an opaque leaf inside a dict param is named after
                    # the param (a Decomposable among the aggregates)
                    for vv in v.values():
                        objs[f"fn_{id(vv):x}"] = vv
                        objs[f"{op.kind}.{k}"] = vv
    fns = {r: objs[r] for r in found}
    srcs = {f"{st.id}:{i}": leg.src[1] for st in graph.stages
            for i, leg in enumerate(st.legs)
            if isinstance(leg.src, tuple) and leg.src[0] == "source"}
    g2 = graph_from_json(js, fn_table=fns, sources=srcs)
    assert graph_to_json(g2) == js
    assert [s.fingerprint() for s in g2.stages] == \
        [s.fingerprint() for s in graph.stages]


def test_unbound_references_are_refused():
    graph = _graphs()["strings"].plan()
    js = graph_to_json(graph)
    with pytest.raises(KeyError, match="fn_table"):
        graph_from_json(js, fn_table={}, sources=_slots(js))
    with pytest.raises(KeyError, match="source binding"):
        graph_from_json(_golden("sql_scan_topk"), fn_table={})


def test_registered_names_and_refs():
    """A callable named in fn_names serializes by that name and rebinds
    through Context(fn_table=)-style tables; import_ref names importable
    objects only."""
    ctx = _tctx(fn_table={"double": doubler})
    assert ctx.fn_table == {"double": doubler}
    graph = _kv(ctx).select(doubler).plan()
    js = graph_to_json(graph, {id(doubler): "double"})
    assert '"__fn__": "double"' in js
    g2 = graph_from_json(js, fn_table=ctx.fn_table, sources={
        "0:0": graph.stages[0].legs[0].src[1]})
    assert g2.stages[0].legs[0].ops[0].params["fn"] is doubler
    assert import_ref(doubler) == f"{__name__}:doubler"
    assert import_ref(lambda c: c) is None
    assert ship_ref_of(doubler) is None


# -- spans ----------------------------------------------------------------------

def test_node_and_op_spans_point_at_the_query_line():
    ctx = _tctx()
    q = _kv(ctx).select(doubler)
    file, line, func = q.node.span
    assert file == __file__ and line > 0 and func == \
        "test_node_and_op_spans_point_at_the_query_line"
    graph = q.plan()
    ops = [o for st in graph.stages for leg in st.legs for o in leg.ops]
    assert any(o.span and o.span[0] == __file__ for o in ops)
    js = graph_to_json(graph, {id(doubler): "doubler"})
    g2 = graph_from_json(js, fn_table={"doubler": doubler},
                         sources={"0:0": None})
    assert [o.span for st in g2.stages for leg in st.legs
            for o in leg.ops] == [o.span for o in ops]


def test_span_not_in_fingerprint():
    a = StageOp("fn", {"fn": doubler}, span=("a.py", 1, "f"))
    b = StageOp("fn", {"fn": doubler}, span=("b.py", 9, "g"))
    sa = Stage(id=0, legs=[Leg("x", [a], None)])
    sb = Stage(id=0, legs=[Leg("x", [b], None)])
    assert sa.fingerprint() == sb.fingerprint()


def test_internal_frames_are_skipped():
    """A node built inside the package (a Context helper) takes the
    user's frame; a frame in the package's apps/ counts as the user's."""
    ds = _tctx().from_columns({"k": np.arange(4, dtype=np.int32)})
    assert ds.node.span[0] == __file__
    g = twc.wordcount_query(_tctx().from_columns({"line": [b"a"]}))
    assert g.node.span[0].endswith(os.path.join("apps", "wordcount.py"))
    assert E.Partitioning.none().kind == "none"


# -- the Run's plan event -------------------------------------------------------

def _plan_events(ev):
    return [e["plan"] for e in ev.events if e["event"] == "plan"]


@pytest.mark.parametrize("path", ["collect", "adaptive", "spill",
                                  "eager_needs", "do_while"])
def test_every_run_emits_its_plan(path, tmp_path):
    """Each executor run emits one ``plan`` event before its stages, the
    graph it runs (ids match the stage events) serialized by
    graph_to_json."""
    ev = EventLog()
    cfg = {"adaptive": JobConfig(adaptive="on"),
           "eager_needs": JobConfig(deferred_needs=False)}.get(path)
    ctx = _tctx(event_log=ev, config=cfg,
                spill_dir=str(tmp_path) if path == "spill" else None)
    q = _kv(ctx, 200).group_by(["k"], {"s": ("sum", "v")})
    if path == "do_while":
        init = q.with_capacity(32)
        ctx.do_while(init, lambda d: d.select(lambda c: {
            "k": c["k"], "s": c["s"] + 1}).with_capacity(32),
            n_iters=3).collect()
        # the init's run, one a superstep, the final collect's
        assert len(_plan_events(ev)) == 1 + 3 + 1
        return
    q.collect()
    plans = _plan_events(ev)
    assert len(plans) == 1
    kinds = [e["event"] for e in ev.events]
    assert kinds.index("plan") < kinds.index("stage_done")
    d = json.loads(plans[0])
    done = {e["stage"] for e in ev.events if e["event"] == "stage_done"}
    assert done <= {st["id"] for st in d["stages"]} or \
        ev.of_type("graph_rewrite")
    assert plans[0] == graph_to_json(q.plan()) or path == "adaptive"


def test_plan_event_needs_a_sink():
    """A Run without an event sink serializes nothing."""
    import dryad_tpu_torch.exec.recovery as rec
    calls = []
    orig = rec.graph_to_json
    rec.graph_to_json = lambda g: calls.append(1) or orig(g)
    try:
        _kv(_tctx()).group_by(["k"], {"s": ("sum", "v")}).collect()
        assert calls == []
        _kv(_tctx(event_log=EventLog())).collect()
        assert calls == [1]
    finally:
        rec.graph_to_json = orig
