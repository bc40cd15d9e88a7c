"""The span window's attribution (``spantrace``) on synthetic spans and
device records, its readers on the CPU, and, on a card, the clock the
program's spans and the profiler share."""

import pytest
import torch
from conftest import TINY

from portbench import bench, spantrace


def span(sid, name, s, e, parent=None, kind="internal", trace="t1",
         **attrs):
    out = {"event": "span", "span": sid, "name": name, "kind": kind,
           "trace": trace, "start_ns": s, "end_ns": e, "attrs": attrs}
    if parent:
        out["parent"] = parent
    return out


# one job: query > run > stage > op.join > hash, and an exchange with its
# own hash; a second job's run after it
SPANS = [
    span("q", "query", 0, 1000, kind="query"),
    span("r", "run", 10, 900, "q", kind="job"),
    span("s", "stage 1:join", 20, 800, "r", kind="stage"),
    span("x", "exchange.hash", 30, 300, "s", bytes=1 << 30),
    span("xh", "hash", 40, 200, "x"),
    span("j", "op.join", 400, 700, "s"),
    span("jh", "hash", 450, 600, "j"),
    span("c", "collect", 920, 990, "q"),
    span("q2", "query", 2000, 3000, kind="query", trace="t2"),
    span("r2", "run", 2010, 2900, "q2", kind="job", trace="t2"),
    span("p2", "plan", 2001, 2005, "q2", trace="t2"),
]


def joined(records, launches, syncs=()):
    prof = {"records": [(f"k{c}", s, e, c) for c, s, e in records],
            "launches": launches, "syncs": list(syncs), "clock": None}
    st = spantrace.joined(SPANS, prof, 0, 3000)
    st["jobs"] = 2
    return st


def test_launch_goes_to_the_innermost_span():
    st = joined([(1, 100, 110), (2, 120, 130), (3, 130, 140)],
                {1: 50, 2: 250, 3: 500})
    assert st["rec_path"] == ["stage 1:join/exchange.hash/hash",
                              "stage 1:join/exchange.hash",
                              "stage 1:join/op.join/hash"]
    assert st["other_job"] == 0


def test_launch_outside_every_span_is_none():
    st = joined([(1, 100, 110), (2, 1500, 1600)], {1: 950, 2: 1200})
    assert st["rec_path"] == ["collect", spantrace.NONE]
    bd = spantrace.breakdown(st)
    assert bd["device_spans"][-1] == [spantrace.NONE, 100e-9]
    assert ["collect", 10e-9] in bd["device_spans"]


def test_record_without_a_launch_is_counted_not_dropped():
    st = joined([(1, 100, 110), (9, 200, 260)], {1: 50})
    assert st["no_launch"] == 1
    assert st["rec_path"][1] == spantrace.NONE
    assert st["busy_s"] == pytest.approx(70e-9)
    assert st["by_path"][spantrace.NONE] == pytest.approx(60e-9)
    assert spantrace.breakdown(st)["device_spans"][-1][1] == \
        pytest.approx(60e-9)


def test_shares_are_unions_of_intervals():
    # two overlapping records in the exchange's hash, one in the
    # exchange itself, one in the join's hash, one in no hash
    st = joined([(1, 100, 200), (2, 150, 250), (3, 240, 300),
                 (4, 400, 500), (5, 600, 700)],
                {1: 50, 2: 60, 3: 250, 4: 500, 5: 420})
    m = spantrace.metrics(st)
    busy = 200 + 100 + 100
    assert st["busy_s"] == pytest.approx(busy / 1e9)
    # [100, 300] under exchange.hash, counted once though nested
    assert m["exchange_device_pct"] == pytest.approx(100 * 200 / busy)
    # [100, 250] and [400, 500] under a hash, wherever it nests
    assert m["hash_device_pct"] == pytest.approx(100 * 250 / busy)
    assert m["sort_device_pct"] == 0.0
    assert spantrace.below_stage_pct(st) == pytest.approx(100.0)
    assert m["exchange_gib_per_job"] == pytest.approx(0.5)
    assert m["plan_span_ms_per_job"] == pytest.approx(4 / 2 / 1e6)
    assert m["collect_span_ms_per_job"] == pytest.approx(70 / 2 / 1e6)


def test_syncs_by_innermost_span_and_inside_runs():
    st = joined([(1, 100, 110)], {1: 50},
                syncs=[("cudaStreamSynchronize", 455),
                       ("cudaStreamSynchronize", 950),
                       ("cudaDeviceSynchronize", 1500),
                       ("cudaStreamSynchronize", 2500)])
    bd = spantrace.breakdown(st)
    assert sorted(bd["syncs_by_span"]) == sorted(
        [["stage 1:join/op.join/hash", 1], ["collect", 1],
         [spantrace.NONE, 1], ["run", 1]])
    # inside the two jobs' run spans: two syncs over two jobs
    assert spantrace.metrics(st)["host_syncs_per_job"] == 1.0


def test_idle_gaps_named_by_the_span_open_at_their_midpoint():
    st = joined([(1, 0, 420), (2, 440, 3000)], {1: 50, 2: 500})
    (gap,) = spantrace.breakdown(st)["idle_spans"]
    assert gap == ["stage 1:join/op.join", pytest.approx(20e-9)]


def test_cpu_no_device_readers():
    """No device records on the CPU: the device readers return None,
    the span readers read the spans."""
    st = joined([], {})
    m = st["metrics"] = spantrace.metrics(st)
    for name in ("exchange_device_pct", "hash_device_pct",
                 "sort_device_pct", "host_syncs_per_job"):
        assert m[name] is None
        assert bench.reader(name).read({"spans": st}) is None
    assert m["exchange_gib_per_job"] == pytest.approx(0.5)


@pytest.mark.parametrize("cell_name", sorted(TINY))
def test_traced_tiny_cell_reads_its_spans(cell_name, capsys):
    import time
    cell = bench.Cell(cell_name, overrides=TINY[cell_name])
    res = bench.run(cell, 2**33 + 11, 0.5, True, "cpu", time.perf_counter())
    m = res["metrics"]
    assert res["correct"] is True
    for name in ("exchange_device_pct", "hash_device_pct",
                 "sort_device_pct", "host_syncs_per_job"):
        assert name not in m
    assert m["exchange_gib_per_job"]["value"] > 0
    assert m["plan_span_ms_per_job"]["value"] > 0
    assert ("collect_span_ms_per_job" in m) == (cell_name == "tpch.q3")
    assert {"device_spans", "idle_spans", "syncs_by_span",
            "device_ops", "idle_gaps"} == set(res["breakdown"])
    assert "spantrace {" in capsys.readouterr().err
    # the breakdown's function is the harness's own again
    assert bench.breakdown.__module__ == bench.__name__


def test_program_without_spans_takes_no_window(monkeypatch):
    """A program whose trace module has no ``scope`` (the parent of
    this harness's span window) gets no window and no new keys."""
    import time

    from dryad_tpu_torch.obs import trace
    monkeypatch.delattr(trace, "scope")
    name = "terasort.100b"
    cell = bench.Cell(name, overrides=TINY[name])
    res = bench.run(cell, 2**33 + 13, 0.5, True, "cpu", time.perf_counter())
    assert res["correct"] is True
    assert "exchange_gib_per_job" not in res["metrics"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.card
def test_program_clock_is_the_profilers(card):
    """A pad launch inside two ``time.time_ns()`` reads: the profiler's
    clock less the program's lies within 20 us."""
    from dryad_tpu_torch.obs import trace
    sink = spantrace.Collector()

    def run_jobs():
        with trace.tracing(sink), trace.scope("probe", "op"):
            torch.ones(8, device=card).sum()
        return None

    _out, prof, launched, lost = spantrace.window(run_jobs, card)
    lo, hi = prof["clock"]
    assert -20_000 < lo <= hi < 20_000
    (sp,) = sink
    st = spantrace.joined(list(sink), prof, sp["start_ns"], sp["end_ns"])
    assert st["records"] and set(st["rec_path"]) == {"probe"}
