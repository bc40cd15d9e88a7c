"""The resident PageRank (``apps/pagerank.pagerank_resident``) over a
Graph500 Kronecker graph, the graph's generator and the ``do_while``
loop's spans, on the CPU at scale 10 (1,024 vertex ids, 16,384 generated
edges), and TPC-H Q1 at SF 0.01: each against the benchmark's plain
reference (``portbench/reference/``), with its limits, and the controls
(the references one step below the configurations' precision) failing
them."""

import json
import os

import numpy as np
import pytest
import torch

import dryad_tpu_torch as port
from dryad_tpu_torch.apps.pagerank import pagerank_resident
from dryad_tpu_torch.obs import trace
from portbench import resident
from portbench.generators import graph500, tpch
from portbench.jobs import tpch_q1
from portbench.reference import pagerank as pr_ref
from portbench.reference import tpch_q1 as q1_ref
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = (7, 2**40 + 3)
CPU = torch.device("cpu")


def _json(*path):
    with open(os.path.join(ROOT, "portbench", *path)) as f:
        return json.load(f)


CFG = dict(_json("configs", "graph500_22.json"), scale=10)
TRAFFIC = _json("traffic", "pagerank.json")
PARAMS = TRAFFIC["params"]


class Collector(list):
    """An in-memory span sink at level 2."""

    level = 2

    def __call__(self, e):
        if e.get("event") == "span":
            self.append(e)


@pytest.fixture(autouse=True)
def no_trace_sink():
    trace.install(None)
    yield
    trace.install(None)


def _tables(seed):
    return graph500.make(CFG, TRAFFIC["reads"], seed, CPU)


def _pagerank(tables, sink=None):
    """The job, with ``sink`` installed once its Context is made (a new
    Context installs its own log, None here, as the process sink)."""
    ctx = resident.context(port, CFG, CPU)
    src = resident.sources(ctx, tables)
    if sink is not None:
        trace.install(sink)
    return pagerank_resident(ctx, src["vertices"], src["edges"],
                             n_iters=PARAMS["supersteps"],
                             damping=PARAMS["damping"])


@pytest.fixture(scope="module")
def graphs():
    return {seed: _tables(seed) for seed in SEEDS}


@pytest.fixture(scope="module")
def ranked(graphs):
    return {seed: _pagerank(t) for seed, t in graphs.items()}


def test_config_states_the_traffic_parameters():
    assert (CFG["supersteps"], CFG["damping"]) == (PARAMS["supersteps"],
                                                   PARAMS["damping"])
    assert CFG["reduced"] == []


@pytest.mark.parametrize("seed", SEEDS)
def test_resident_pagerank_equals_reference(graphs, ranked, seed):
    want = pr_ref.reference(graphs[seed], PARAMS)
    nums = pr_ref.compare(ranked[seed], want)
    assert nums["pr_vertices_gap"] == 0
    assert nums["pr_ranks_off"] == 0
    assert want["dangling"] == 0
    assert ranked[seed]["rank"].dtype == np.float32
    # the ranks of a graph without dangling vertices sum to 1
    assert abs(float(ranked[seed]["rank"].astype(np.float64).sum()) - 1
               ) < 1e-5


@pytest.mark.parametrize("seed", SEEDS)
def test_bfloat16_control_fails(graphs, seed):
    nums = pr_ref.control(graphs[seed], PARAMS)
    assert nums["pr_ranks_off"] > 0
    assert nums["pr_vertices_gap"] == 0


@pytest.mark.parametrize("fault", ["missing", "repeated", "foreign",
                                   "rank"])
def test_comparison_sees_each_fault(graphs, ranked, fault):
    seed = SEEDS[0]
    got = {k: v.copy() for k, v in ranked[seed].items()}
    if fault == "missing":
        got = {k: v[1:] for k, v in got.items()}
    elif fault == "repeated":
        got = {k: np.concatenate([v, v[:1]]) for k, v in got.items()}
    elif fault == "foreign":
        absent = sorted(set(range(1 << CFG["scale"])) - set(got["id"]))[0]
        got["id"][0] = absent
    else:
        got["rank"][0] *= 1 + 2 * pr_ref.RTOL
    nums = pr_ref.compare(got, pr_ref.reference(graphs[seed], PARAMS))
    key = "pr_ranks_off" if fault == "rank" else "pr_vertices_gap"
    assert nums[key] > 0


def _edges(tables):
    t = tables["edges"]
    src, dst = (pr_ref._col(t, c) for c in ("src", "dst"))
    return src, dst


@pytest.mark.parametrize("seed", SEEDS)
def test_graph_is_simple_undirected(graphs, seed):
    src, dst = _edges(graphs[seed])
    assert bool((src != dst).all())                      # no self-loop
    key = src * (1 << CFG["scale"]) + dst
    assert key.unique().numel() == key.numel()           # no repeat
    back = dst * (1 << CFG["scale"]) + src
    assert torch.equal(key.sort().values, back.sort().values)  # both ways
    ids = pr_ref._col(graphs[seed]["vertices"], "id")
    deg = torch.bincount(src, minlength=1 << CFG["scale"])
    assert bool((deg[ids] >= 1).all())
    assert int((deg > 0).sum()) == ids.numel()           # no vertex left out
    assert ids.unique().numel() == ids.numel()
    assert graphs[seed]["edges"]["rows"] == src.numel()
    assert graphs[seed]["vertices"]["counts"].sum() == ids.numel()


@pytest.mark.parametrize("seed", SEEDS)
def test_first_level_quadrants(seed):
    """The first bit level's quadrants, before the labels are permuted,
    within 5 standard errors of A, B, C, D."""
    src, dst = graph500.kronecker(dict(CFG, scale=12), seed, CPU)
    q = (src & 1) * 2 + (dst & 1)
    freq = torch.bincount(q, minlength=4).double() / q.numel()
    for f, p in zip(freq.tolist(), CFG["initiator"]):
        assert abs(f - p) < 5 * (p * (1 - p) / q.numel()) ** 0.5


def test_generator_is_seeded():
    a, b = _tables(SEEDS[0]), _tables(SEEDS[0])
    for t in a:
        for c in a[t]["columns"]:
            assert torch.equal(a[t]["columns"][c], b[t]["columns"][c])
    c = _tables(SEEDS[1])
    assert not torch.equal(a["edges"]["columns"]["src"],
                           c["edges"]["columns"]["src"])


def _span_tree(spans):
    by_id = {s["span"]: s for s in spans}
    return by_id, [s for s in spans if s["name"] == "loop"]


def test_loop_spans(graphs):
    sink = Collector()
    _pagerank(graphs[SEEDS[0]], sink)
    trace.install(None)
    by_id, loops = _span_tree(sink)
    assert len(loops) == 1
    loop = loops[0]
    n = PARAMS["supersteps"]
    assert loop["attrs"] == {"iters": n, "stages": 3, "planned": 1,
                             "iters_run": n}
    assert "parent" not in loop               # a root of its own trace
    iters = [s for s in sink if s["name"] == "loop.iter"]
    assert sorted(s["attrs"]["i"] for s in iters) == list(range(n))
    for it in iters:
        assert it["parent"] == loop["span"]
        assert it["trace"] == loop["trace"]
        assert loop["start_ns"] <= it["start_ns"] <= it["end_ns"] \
            <= loop["end_ns"]
        runs = [s for s in sink if s["name"] == "run"
                and s.get("parent") == it["span"]]
        assert len(runs) == 1
        below = [s for s in sink if s.get("parent") == runs[0]["span"]]
        assert any(s["name"].startswith("stage ") for s in below)
    # every run of the loop's iterations is below a loop.iter
    in_loop = [s for s in sink if s["name"] == "run"
               and by_id.get(s.get("parent"), {}).get("name")
               == "loop.iter"]
    assert len(in_loop) == n


def test_loop_spans_stop_with_cond():
    sink = Collector()
    ctx = port.Context(device="cpu", nparts=4)
    trace.install(sink)
    init = ctx.from_columns({"k": np.arange(8, dtype=np.int32),
                             "v": np.zeros(8, np.int64)})
    seen = []

    def cond(table):
        seen.append(int(table["v"][0]))
        return len(seen) < 3

    out = ctx.do_while(init, lambda d: d.select(
        lambda c: {"k": c["k"], "v": c["v"] + 1}), n_iters=5,
        cond=cond).collect()
    trace.install(None)
    assert sorted(out["v"].tolist()) == [3] * 8
    (loop,) = [s for s in sink if s["name"] == "loop"]
    assert loop["attrs"]["iters"] == 5 and loop["attrs"]["iters_run"] == 3
    assert len([s for s in sink if s["name"] == "loop.iter"]) == 3


def test_loop_builds_no_span_with_tracing_off(graphs, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a Span was built with tracing off")

    monkeypatch.setattr(trace.Span, "__init__", refuse)
    assert not trace.ACTIVE
    out = _pagerank(graphs[SEEDS[0]])
    assert len(out["id"]) == graphs[SEEDS[0]]["vertices"]["rows"]


@pytest.fixture(scope="module")
def q1_tables():
    cfg = dict(_json("configs", "tpch_sf30.json"), scale_factor=0.01)
    reads = _json("traffic", "q1.json")["reads"]
    return cfg, tpch.make(cfg, reads, 2**33 + 9, CPU)


@pytest.mark.parametrize("answer", ["port", "f32_control"])
def test_q1_against_reference(q1_tables, answer):
    cfg, tables = q1_tables
    params = _json("traffic", "q1.json")["params"]
    want = q1_ref.reference(tables, params)
    assert len(want) == 4                     # A/F, N/F, N/O, R/F
    if answer == "port":
        ctx, src = tpch_q1.setup(port, cfg, tables, CPU)
        nums = q1_ref.compare(tpch_q1.run(ctx, src, params)[0], want)
        assert nums == {"q1_cells_wrong": 0, "q1_groups_gap": 0}
    else:
        nums = q1_ref.control(tables, params)
        assert nums["q1_cells_wrong"] > 0 and nums["q1_groups_gap"] == 0
