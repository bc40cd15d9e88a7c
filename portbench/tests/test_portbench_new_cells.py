"""The cells ``pagerank.g500s22`` and ``tpch.q1`` end to end: each job at a
tiny size on the CPU against its reference, the result line's keys
traced and untraced, the loop's four metrics on synthetic records, runs
whose path is broken underneath, and a program without the resident
PageRank failing the cell before any job.  The ``card`` tests run both
cells at their own sizes on three seeds, with their controls."""

import json
import subprocess
import sys
import time

import pytest
import torch
from conftest import ROOT

from portbench import bench, control

TINY = {"pagerank.g500s22": {"scale": 10}, "tpch.q1": {"scale_factor": 0.01}}
CELLS = sorted(TINY)
LOOP = ("superstep_ms", "loop_device_pct", "superstep_host_syncs",
        "scan2_roofline_pct")
SEEDS = (2600000011, 2**31 + 29, 2**40 + 31)
_RUNS: dict = {}


def run_tiny(cell_name, trace):
    """One tiny run of the cell (made once per mode)."""
    if (cell_name, trace) not in _RUNS:
        cell = bench.Cell(cell_name, overrides=TINY[cell_name])
        _RUNS[cell_name, trace] = cell, bench.run(
            cell, 2**33 + 5, 0.3, trace, "cpu", time.perf_counter())
    return _RUNS[cell_name, trace]


@pytest.mark.parametrize("cell_name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_equals_reference(cell_name, trace):
    _cell, res = run_tiny(cell_name, trace)
    assert res["correct"] is True
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert all(v["value"] == 0 for v in res["checks"].values())


@pytest.mark.parametrize("cell_name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(cell_name, trace):
    cell, res = run_tiny(cell_name, trace)
    extra = {"card", "checks", "setup_parts_s"} | (
        {"breakdown"} if trace else set())
    assert set(res) == {"correct", "attempted", "failed", "metrics",
                        "device"} | extra
    assert list(res)[-1] == "checks"
    want = {m["name"] for m in cell.metrics(trace)}
    assert want, "every cell reports a metric in each mode"
    if trace:
        # the CPU has no device trace: only the host-clock ones read
        assert set(res["metrics"]) <= want
        assert ("superstep_ms" in res["metrics"]) == (
            cell_name == "pagerank.g500s22")
        for name in LOOP[1:]:
            assert name not in res["metrics"]
    else:
        assert set(res["metrics"]) == want == {"rows_per_s",
                                               "peak_mem_gib", "setup_s"}
    json.dumps(res)


def test_benchmark_entries():
    cell = bench.Cell("pagerank.g500s22")
    got = {m["name"]: m for m in cell.metrics(True)}
    for name in LOOP:
        assert got[name]["workloads"] == ["pagerank.g500s22"]
        assert got[name]["moves"] == "rows_per_s"
    assert cell.entry["chips"] == 1 and cell.config["reduced"] == []
    q1 = bench.Cell("tpch.q1")
    assert q1.entry["chips"] == 1 and q1.metrics(True)
    assert not set(LOOP) & {m["name"] for m in q1.metrics(True)}


def test_superstep_ms_on_the_cpu():
    _cell, res = run_tiny("pagerank.g500s22", True)
    assert res["metrics"]["superstep_ms"]["value"] > 0
    assert res["metrics"]["superstep_ms"]["unit"] == "ms"


def _window(loop_spans=True):
    """A span window: one job, a loop with two iterations, device records
    and syncs at known times."""
    spans = [{"name": "query", "kind": "query", "span": "q",
              "start_ns": 0, "end_ns": 100}]
    if loop_spans:
        spans += [{"name": "loop", "kind": "loop", "span": "l", "parent": "q",
                   "start_ns": 10, "end_ns": 90},
                  {"name": "loop.iter", "kind": "loop", "span": "i0",
                   "parent": "l", "start_ns": 10, "end_ns": 40},
                  {"name": "loop.iter", "kind": "loop", "span": "i1",
                   "parent": "l", "start_ns": 50, "end_ns": 90}]
    from portbench import spantrace
    records = [("k", 0, 10, 1), ("k", 20, 40, 2), ("k", 60, 70, 3)]
    launches = {1: 5, 2: 15, 3: 55}
    syncs = [("cudaStreamSynchronize", 30), ("cudaStreamSynchronize", 60),
             ("cudaStreamSynchronize", 80), ("cudaMemcpy", 95)]
    return spantrace.joined(spans, {"records": records, "clock": None,
                                    "launches": launches, "syncs": syncs},
                            0, 100)


def test_loop_metrics_on_a_synthetic_window():
    st = _window()
    rec = {"spans": st, "trace": {"records": [], "least": {}}}
    # iterations of 30 and 40 ns
    assert bench.reader("superstep_ms").read(rec) == pytest.approx(35e-6)
    # busy 40 ns, 30 of them launched inside an iteration
    assert bench.reader("loop_device_pct").read(rec) == pytest.approx(75.0)
    # three syncs fall inside the iterations: 1.5 a superstep
    assert bench.reader("superstep_host_syncs").read(rec) == 1.5


def test_loop_metrics_read_nothing_without_loop_spans():
    """A program without the loop's spans (the parent) reports none of
    them and raises nothing."""
    rec = {"spans": _window(loop_spans=False),
           "trace": {"records": [], "least": {}}}
    for name in LOOP[:3]:
        assert bench.reader(name).read(rec) is None
    assert bench.reader("superstep_ms").read({"spans": None,
                                              "trace": None}) is None


def test_scan2_roofline_on_synthetic_records():
    n = 1 << 20
    from portbench import roofline
    least = roofline.least_seconds("prefix_sum2", (torch.empty(n),))
    ns = 2 * round(least * 1e9)
    tr = {"records": [("scan2_lookback_kernel", 0, ns),
                      ("scan_lookback_kernel", 0, 10**6)],
          "least": {"prefix_sum2": (1, least)}}
    assert bench.reader("scan2_roofline_pct").read(
        {"trace": tr}) == pytest.approx(100 * least * 1e9 / ns)
    tr["least"] = {}
    assert bench.reader("scan2_roofline_pct").read({"trace": tr}) is None
    assert bench.reader("scan2_roofline_pct").read({"trace": None}) is None


def test_program_without_resident_pagerank_fails_before_any_job(
        monkeypatch):
    from dryad_tpu_torch.apps import pagerank
    monkeypatch.delattr(pagerank, "pagerank_resident")
    cell = bench.Cell("pagerank.g500s22", overrides=TINY["pagerank.g500s22"])
    with pytest.raises(ImportError):
        bench.run(cell, 3, 0.3, False, "cpu", time.perf_counter())


def _rank_off(monkeypatch):
    """One vertex's rank altered where the app returns it."""
    from dryad_tpu_torch.apps import pagerank
    real = pagerank.pagerank_resident

    def bad(*a, **kw):
        out = real(*a, **kw)
        out["rank"] = out["rank"].copy()
        out["rank"][0] *= 1.001
        return out

    monkeypatch.setattr(pagerank, "pagerank_resident", bad)


def _one_superstep_fewer(monkeypatch):
    from dryad_tpu_torch.api import dataset
    real = dataset.Context.do_while

    def short(self, init, body, n_iters, cond=None):
        return real(self, init, body, n_iters - 1, cond)

    monkeypatch.setattr(dataset.Context, "do_while", short)


def _exchange_left_out(monkeypatch):
    """Every exchange keeps each row on its own partition."""
    from dryad_tpu_torch.parallel import shuffle
    orig = shuffle.exchange_by_dest

    def stay(parts, dests, *a, **kw):
        return orig(parts, [torch.full_like(d, p)
                            for p, d in enumerate(dests)], *a, **kw)

    monkeypatch.setattr(shuffle, "exchange_by_dest", stay)


def _half_left_out(monkeypatch):
    """Half of every source's rows left out."""
    from dryad_tpu_torch.api import dataset
    from_pdata = dataset.Context.from_pdata

    def half(self, pd, *a, **kw):
        pd.batch.count = pd.batch.count // 2
        return from_pdata(self, pd, *a, **kw)

    monkeypatch.setattr(dataset.Context, "from_pdata", half)


# (an exchange that keeps every row home makes the PageRank job raise: its
# rank table outgrows the loop's fixed capacity)
FAULTS = {"pagerank.g500s22": {"rank_off": _rank_off,
                               "one_superstep_fewer": _one_superstep_fewer,
                               "half_left_out": _half_left_out},
          "tpch.q1": {"exchange_left_out": _exchange_left_out,
                      "half_left_out": _half_left_out}}


@pytest.mark.parametrize("cell_name,fault", [
    (c, f) for c in CELLS for f in sorted(FAULTS[c])])
def test_broken_path_is_not_correct(monkeypatch, cell_name, fault):
    FAULTS[cell_name][fault](monkeypatch)
    cell = bench.Cell(cell_name, overrides=TINY[cell_name])
    res = bench.run(cell, 2**35 + 1, 0.2, False, "cpu", time.perf_counter())
    assert res["correct"] is False


@pytest.mark.parametrize("cell_name", CELLS)
def test_control_fails_tiny(cell_name):
    cell = bench.Cell(cell_name, overrides=TINY[cell_name])
    nums = control.readings(cell, SEEDS[0], "cpu")
    assert any(nums[k] > cell.reference.LIMITS[k] for k in nums)


def _run_on_card(cell_name, seed, trace):
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        cell_name, "--seed", str(seed), "--seconds", "3",
                        "--trace", str(trace)], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    return json.loads(p.stdout.strip().splitlines()[-1]), p.stderr


@pytest.mark.card
@pytest.mark.parametrize("cell_name", CELLS)
def test_new_cell_correct_on_card(card, cell_name):
    for seed in SEEDS:
        res, _err = _run_on_card(cell_name, seed, 0)
        assert res["correct"] is True and res["device"]["platform"] == "gpu"


@pytest.mark.card
def test_pagerank_traced_on_card(card):
    res, err = _run_on_card("pagerank.g500s22", SEEDS[0], 1)
    assert res["correct"] is True
    m = res["metrics"]
    for name in LOOP:
        assert m[name]["value"] is not None
    assert 0 < m["scan2_roofline_pct"]["value"] <= 100
    assert 0 < m["loop_device_pct"]["value"] <= 100


@pytest.mark.card
@pytest.mark.parametrize("cell_name", CELLS)
def test_control_fails_at_cell_size(card, cell_name):
    cell = bench.Cell(cell_name)
    for seed in SEEDS:
        nums = control.readings(cell, seed, card)
        assert any(nums[k] > cell.reference.LIMITS[k] for k in nums)
        torch.cuda.empty_cache()
