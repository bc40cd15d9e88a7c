"""Each cell end to end: the job at a tiny size on the CPU against its
reference, the result line's keys, and a run that finds no card."""

import json
import subprocess
import sys
import time

import pytest
from conftest import ROOT, TINY

from portbench import bench

CELLS = sorted(TINY)
CONTRACT = {"correct", "attempted", "failed", "metrics", "device"}
DEVICE = {"platform", "kind", "count", "memory_peak_bytes"}


def run_tiny(cell_name, trace, seed=2**33 + 5, seconds=0.5):
    cell = bench.Cell(cell_name, overrides=TINY[cell_name])
    return cell, bench.run(cell, seed, seconds, trace, "cpu",
                           time.perf_counter())


@pytest.mark.parametrize("cell_name", CELLS)
def test_tiny_cell_equals_reference(cell_name):
    _cell, res = run_tiny(cell_name, trace=False)
    assert res["correct"] is True
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert all(v["value"] == 0 for v in res["checks"].values())


@pytest.mark.parametrize("cell_name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(cell_name, trace):
    cell, res = run_tiny(cell_name, trace)
    extra = {"card", "checks", "setup_parts_s"} | (
        {"breakdown"} if trace else set())
    assert set(res) == CONTRACT | extra
    assert list(res)[-1] == "checks"     # the numbers compared come last
    assert set(res["device"]) == DEVICE | (
        {"busy_s", "window_s"} if trace else set())
    want = {m["name"] for m in cell.metrics(trace)}
    assert set(res["metrics"]) <= want
    if not trace:
        assert set(res["metrics"]) == want
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    json.dumps(res)


@pytest.mark.parametrize("cell_name", CELLS)
def test_traced_counters(cell_name):
    _cell, res = run_tiny(cell_name, trace=True)
    m = res["metrics"]
    assert m["stage_attempts_per_stage"]["value"] >= 1
    assert m["host_reads_per_job"]["value"] >= 1
    assert 0 < m["exchange_slot_fill_pct"]["value"] <= 100
    assert m["plan_ms_per_job"]["value"] > 0
    assert ("collect_ms_per_job" in m) == (cell_name == "tpch.q3")
    # no device here: no device metric is reported from the CPU
    for name in ("kernel_time_pct", "kernel_roofline_pct",
                 "device_idle_pct"):
        assert name not in m


def test_no_card_no_result():
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "terasort.100b", "--seed", "3", "--seconds", "1",
                        "--trace", "1"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300,
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin"})
    assert p.returncode != 0
    assert "{" not in p.stdout
    assert "needs 1 CUDA device" in p.stderr


@pytest.mark.card
@pytest.mark.parametrize("cell_name", CELLS)
def test_cell_correct_on_card(card, cell_name):
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        cell_name, "--seed", "2147483659", "--seconds", "3",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
