"""The port's spans where the work happens (``obs/trace.py`` and its call
sites in ``api/``, ``exec/``, ``parallel/`` and ``ops/``): a small
Q3-shaped query (two joins, a group-by, a top 10, ``collect``) and a
string ``order_by`` materialised by ``cache()`` (a range exchange whose
settle replays the sort stage), each run with a span collector installed
through ``trace.install`` and again with no sink at all."""

import collections
import time

import numpy as np
import pytest
import torch

from dryad_tpu_torch import Context
from dryad_tpu_torch.obs import trace
from dryad_tpu_torch.obs.chrome import chrome_trace
from dryad_tpu_torch.obs.critical_path import critical_path
from dryad_tpu_torch.ops import kernels
from dryad_tpu_torch.parallel import shuffle
from tests.torch_threads import one_torch_thread  # noqa: F401

P = 4
CLOCK = []


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


def _equals(col, word: bytes):
    want = torch.tensor(list(word), dtype=torch.uint8)
    return (col.lengths == len(word)) & (col.data[:, :len(word)]
                                         == want).all(1)


def q3(ctx):
    """TPC-H Q3's shape over a few thousand generated rows."""
    rng = np.random.default_rng(7)
    nc, no, nl = 300, 1_500, 6_000
    cust = ctx.from_columns({
        "c_custkey": np.arange(nc, dtype=np.int64),
        "c_mktsegment": [b"BUILDING" if i % 5 == 0 else b"MACHINERY"
                         for i in range(nc)]})
    orders = ctx.from_columns({
        "o_orderkey": np.arange(no, dtype=np.int64),
        "o_custkey": rng.integers(0, nc, no).astype(np.int64),
        "o_orderdate": rng.integers(0, 100, no).astype(np.int32),
        "o_shippriority": np.zeros(no, np.int32)})
    lines = ctx.from_columns({
        "l_orderkey": rng.integers(0, no, nl).astype(np.int64),
        "l_price": rng.integers(100, 10_000, nl).astype(np.int64),
        "l_shipdate": rng.integers(0, 100, nl).astype(np.int32)})
    c = (cust.where(lambda c: _equals(c["c_mktsegment"], b"BUILDING"))
         .select(lambda c: {"c_custkey": c["c_custkey"]}))
    o = (orders.where(lambda c: c["o_orderdate"] < 50)
         .join(c, ["o_custkey"], ["c_custkey"], right_unique=True)
         .select(lambda c: {"o_orderkey": c["o_orderkey"],
                            "o_orderdate": c["o_orderdate"],
                            "o_shippriority": c["o_shippriority"]}))
    return (lines.where(lambda c: c["l_shipdate"] > 50)
            .select(lambda c: {"l_orderkey": c["l_orderkey"],
                               "rev": c["l_price"]})
            .join(o, ["l_orderkey"], ["o_orderkey"], right_unique=True)
            .group_by(["l_orderkey", "o_orderdate", "o_shippriority"],
                      {"revenue": ("sum", "rev")})
            .order_by([("revenue", True), ("o_orderdate", False)])
            .take(10).collect())


def sort_cache(ctx):
    """A string ``order_by`` of 10-byte keys with 90-byte payloads,
    ``cache()``d on the partitions; half the keys are one key, so its
    destination overflows and the settle replays the sort stage."""
    rng = np.random.default_rng(11)
    n = 4_000
    keys = [b"MMMMMMMMMM" if i % 2 else
            bytes(rng.integers(32, 127, 10).astype(np.uint8))
            for i in range(n)]
    pay = [b"%089d" % i + b"\n" for i in range(n)]
    out = ctx.from_columns({"key": keys, "payload": pay},
                           str_max_len=90).order_by([("key", False)]) \
        .cache()
    return out.node.data.counts.tolist()


# each query, and the (span, an op or exchange it nests under) pairs its
# jobs must hold
JOBS = {"q3": (q3, {("hash", "exchange.hash"), ("hash", "op.join"),
                    ("hash", "op.group"), ("sort", "op.sort"),
                    ("sort", "op.filter")}),
        "sort": (sort_cache, {("sort", "op.sort"),
                              ("sort", "exchange.range"),
                              ("sort", "exchange.bounds")})}


def traced(job: str, runs: int = 1):
    """``runs`` jobs of ``job`` with a collector installed: (the span
    events, the context, each exchange's packed row words in call
    order); ``time.time_ns()`` before and after them in ``CLOCK``."""
    ctx = Context(device="cpu", nparts=P)
    sink = Collector()
    trace.install(sink)
    words = []
    real = shuffle.exchange_by_dest

    def exchange_by_dest(parts, *a, **kw):
        words.append(kernels._pack_columns_u32(parts[0].columns)[0]
                     .shape[1])
        return real(parts, *a, **kw)

    shuffle.exchange_by_dest = exchange_by_dest
    try:
        CLOCK[:] = [time.time_ns()]
        for _ in range(runs):
            JOBS[job][0](ctx)
        CLOCK.append(time.time_ns())
    finally:
        shuffle.exchange_by_dest = real
        trace.install(None)
    return list(sink), ctx, words


def _tree(spans):
    by = {s["span"]: s for s in spans}
    kids = collections.defaultdict(list)
    for s in spans:
        kids[s.get("parent")].append(s)
    return by, kids


def _ancestors(s, by):
    up = by.get(s.get("parent"))
    while up is not None:
        yield up
        up = by.get(up.get("parent"))


@pytest.mark.parametrize("job", sorted(JOBS))
def test_stages_hold_ops_and_exchanges(job):
    spans, _ctx, _w = traced(job)
    by, kids = _tree(spans)
    stages = [s for s in spans if s["kind"] == "stage"]
    assert stages
    for st in stages:
        assert any(k["name"].startswith(("op.", "exchange."))
                   for k in kids[st["span"]]), st["name"]
    for s in spans:
        if s["name"].startswith(("op.", "exchange.")):
            # one span per call over the partitions, never per partition
            assert s["attrs"]["kind"] == s["name"].split(".", 1)[1]
        if s["name"].startswith("op."):
            assert s["attrs"]["parts"] == P
    # a settle holds the info read, and the replay's stages
    (settle,) = [s for s in spans if s["name"] == "settle"]
    assert settle["attrs"]["replayed"] == len(
        [s for s in kids[settle["span"]] if s["kind"] == "stage"])
    assert (settle["attrs"]["replayed"] > 0) == (job == "sort")


@pytest.mark.parametrize("job", sorted(JOBS))
def test_hash_and_sort_under_their_callers(job):
    spans, _ctx, _w = traced(job)
    by, _kids = _tree(spans)
    found = set()
    for s in spans:
        if s["name"] in ("hash", "sort"):
            names = [a["name"] for a in _ancestors(s, by)]
            assert any(n.startswith(("op.", "exchange.")) for n in names)
            # a sort inside a sort is one span
            assert s["name"] not in names
            for n in names:
                found.add((s["name"], n))
            assert s["attrs"]["rows"] > 0
            assert s["attrs"]["keys" if s["name"] == "hash"
                              else "lanes"] > 0
    assert JOBS[job][1] <= found


@pytest.mark.parametrize("job", sorted(JOBS))
def test_children_within_parents_one_trace_per_job(job):
    spans, _ctx, _w = traced(job, runs=2)
    by, _kids = _tree(spans)
    for s in spans:
        # one clock, the profiler's: time.time_ns()
        assert CLOCK[0] <= s["start_ns"] <= s["end_ns"] <= CLOCK[1]
        # t0 and dur_s come from the same pair of stamps
        assert s["t0"] == round(s["start_ns"] / 1e9, 6)
        assert s["dur_s"] == round((s["end_ns"] - s["start_ns"]) / 1e9, 6)
        up = by.get(s.get("parent"))
        if up is not None:
            assert up["start_ns"] <= s["start_ns"] <= s["end_ns"] <= \
                up["end_ns"], (s["name"], up["name"])
            assert s["trace"] == up["trace"]
    roots = [s for s in spans if s.get("parent") is None]
    assert [r["name"] for r in roots] == ["query", "query"]
    assert len({s["trace"] for s in spans}) == 2
    for r in roots:
        mine = {s["name"].split(" ")[0] for s in spans
                if s["trace"] == r["trace"]}
        assert {"query", "plan", "run", "stage", "settle"} <= mine
        assert ("collect" if job == "q3" else "cache") in mine
    plan = [s for s in spans if s["name"] == "plan"]
    assert all(s["attrs"]["stages"] >= 1 for s in plan)


@pytest.mark.parametrize("job", sorted(JOBS))
def test_exchange_bytes_are_the_send_grids(job):
    spans, ctx, words = traced(job)
    by, _kids = _tree(spans)
    log = {e["stage"]: e for e in ctx.executor.stage_log}
    ex = sorted((s for s in spans
                 if s["name"] in ("exchange.hash", "exchange.range")),
                key=lambda s: s["start_ns"])
    assert ex and len(ex) == len(words)
    seen = collections.Counter()
    for s, w in zip(ex, words):
        (stage,) = [a for a in _ancestors(s, by) if a["kind"] == "stage"][:1]
        sid = stage["attrs"]["stage"]
        k, ent = seen[sid], log[sid]
        seen[sid] += 1
        slot = ent["slot_rows"][k // ent["exchanges"]][k % ent["exchanges"]]
        assert s["attrs"]["slot_rows"] == slot
        assert s["attrs"]["bytes"] == P * P * slot * w * 4
        packs = [c for c in spans if c.get("parent") == s["span"]
                 and c["name"] == "pack"]
        assert sum(c["attrs"]["bytes"] for c in packs) == s["attrs"]["bytes"]
    if job == "sort":
        # two strings of 90 bytes at most: 23 words and a length each
        assert set(words) == {48}


@pytest.mark.parametrize("job", sorted(JOBS))
def test_exporters_read_the_spans(job):
    spans, _ctx, _w = traced(job)
    out = chrome_trace(spans)["traceEvents"]
    assert len([e for e in out if e["ph"] == "X"]) == len(spans)
    cp = critical_path(spans)
    assert cp["segments"]
    assert abs(sum(x["self_s"] for x in cp["segments"])
               - cp["total_s"]) < 1e-5


@pytest.mark.parametrize("job", sorted(JOBS))
def test_no_sink_builds_no_span(job, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a Span was built with tracing off")

    monkeypatch.setattr(trace.Span, "__init__", refuse)
    ctx = Context(device="cpu", nparts=P)
    assert not trace.ACTIVE
    out = JOBS[job][0](ctx)
    assert out
