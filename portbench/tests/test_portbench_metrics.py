"""The metric arithmetic on synthetic records, and the kernels' byte
formulas against PERF.md's kernel-table bounds."""

import pytest
import torch
from conftest import TINY

from portbench import bench, devtrace, roofline


def reader(name):
    return bench.reader(name).read


def jobs(lat_ms, gap_ms=0.0):
    out, t = [], 1_000_000
    for lat in lat_ms:
        out.append({"t0": t, "t1": t + int(lat * 1e6), "stages": [],
                    "host_reads": 1})
        t += int((lat + gap_ms) * 1e6)
    return out


def test_rate_over_window():
    rec = {"jobs": jobs([500.0, 500.0, 1000.0], gap_ms=250.0),
           "rows_per_job": 1_000_000}
    # 3 jobs in 2.5 s (the gaps between jobs count)
    assert reader("rows_per_s")(rec) == pytest.approx(1_200_000)


def test_union_and_gaps():
    iv = [(0, 10), (5, 15), (20, 30), (29, 31), (50, 60)]
    assert devtrace.union_seconds(iv, 0, 100) == 15 + 11 + 10
    assert devtrace.union_seconds(iv, 8, 55) == 7 + 11 + 5
    assert devtrace.gaps(iv, 0, 70) == [(15, 20), (31, 50), (60, 70)]
    assert devtrace.gaps([], 3, 9) == [(3, 9)]


def test_idle_and_kernel_shares():
    tr = {"records": [("hist_small_x", 0, 10), ("other", 10, 40),
                      ("slot_compact_v2", 60, 80)],
          "lo_ns": 0, "hi_ns": 100, "busy_s": 60e-9, "window_s": 100e-9,
          "least": {"hist_buckets": (1, 5e-9), "slot_compact": (1, 10e-9)}}
    rec = {"trace": tr}
    assert reader("device_idle_pct")(rec) == pytest.approx(40.0)
    assert reader("kernel_time_pct")(rec) == pytest.approx(50.0)
    assert reader("kernel_roofline_pct")(rec) == pytest.approx(50.0)
    assert reader("kernel_roofline_pct")({"trace": None}) is None


def test_slot_fill_and_attempts():
    stage = {"attempts": 2, "slot_rows": [[4, 2], [8, 2]],
             "recv_rows": [[10, 6], [1, 1]]}
    out = {"attempts": 1, "slot_rows": [[]], "recv_rows": []}
    rec = {"jobs": [{"stages": [stage, out], "host_reads": 2}]}
    # P = 2: shipped (4 + 2 + 8 + 2) * 2 * 2 = 64 rows, received 18
    assert reader("exchange_slot_fill_pct")(rec) == pytest.approx(
        100 * 18 / 64)
    assert reader("stage_attempts_per_stage")(rec) == pytest.approx(1.5)
    assert reader("host_reads_per_job")(rec) == pytest.approx(2.0)


def ms(name, args):
    return roofline.least_seconds(name, args) * 1e3


def test_kernel_table_bounds():
    # hist_buckets: [8, 65,536] ids at B = 8 -> 0.000626 ms
    bid = roofline.Shape(torch.empty((8, 65536), dtype=torch.int32,
                                     device="meta"))
    assert round(ms("hist_buckets", (bid, 8)), 6) == 0.000626
    # prefix_sum int32 [1,250,000] -> 0.002985; prefix_sum2 f32
    # [250,000] -> 0.000896
    x = roofline.Shape(torch.empty(1_250_000, dtype=torch.int32,
                                   device="meta"))
    assert round(ms("prefix_sum", (x,)), 6) == 0.002985
    x = roofline.Shape(torch.empty(250_000, device="meta"))
    assert round(ms("prefix_sum2", (x,)), 6) == 0.000896
    # slot_compact [8, 131,072, 8] -> [8, 1,250,000, 8]: every slice's
    # 1,250,000 rows written, the valid rows read.  The table does not
    # give the timed call's counts; 5,198 valid rows per (destination,
    # source) block is what its 0.09870 ms implies, and the empty and
    # the full grid bracket it.
    recv = roofline.Shape(torch.empty((8, 131072, 8), dtype=torch.int32,
                                      device="meta"))
    C = 131072 // 8
    at = lambda c: ms("slot_compact", (  # noqa: E731
        recv, torch.full((8, 8), c, dtype=torch.int32), C, 1_250_000))
    assert round(at(5198), 5) == 0.09870
    assert at(0) < 0.09870 < at(C)


def test_shape_log_keeps_no_data():
    log = roofline.ShapeLog()
    big = torch.zeros((8, 100_000, 8), dtype=torch.int32)
    offs = torch.zeros((8, 8), dtype=torch.int32)
    log.setdefault("slot_expand", []).append((0, (big, offs, 16)))
    (_size, (w, o, c)), = log["slot_expand"]
    assert isinstance(w, roofline.Shape) and w.shape == (8, 100_000, 8)
    assert o is offs and c == 16
    assert roofline.kernel_of("void slot_expand_v4<4>(int*)") == \
        "slot_expand"
    assert roofline.kernel_of("at::native::add_kernel") is None


def test_retried_profile_window_counts_only_its_own_calls(monkeypatch):
    """A profile window that lacks device records is taken again, jobs
    and all; the kernel calls recorded in the dropped window are dropped
    with it, so the roofline pairs the kept window's calls with its
    records."""
    name = "terasort.100b"
    cell = bench.Cell(name, overrides=TINY[name])
    dev = torch.device("cpu")
    tables = cell.gen.make(cell.config, cell.traffic["reads"], 2**33 + 1,
                           dev)
    ctx, src = cell.job.setup(bench.import_port(), cell.config, tables, dev)
    client = bench.Client(cell, ctx, src, lambda: None)
    seen = []     # each window's calls by kernel, as it closed

    def window(run_jobs, device):
        jobs, log = run_jobs()
        seen.append({k: len(v) for k, v in log.items()})
        lost = 3 if len(seen) == 1 else 0      # the first window drops
        return (jobs, log), [("slot_compact_v2_x", 0, 10**6)], 0, 40, lost

    monkeypatch.setattr(devtrace, "window", window)
    tr = bench.trace_jobs(client, 2, torch.device("cuda"))
    assert len(seen) == 2
    calls = {k: n for k, (n, _t) in tr["least"].items()}
    # each window's two jobs made the same calls; only one window counts
    assert seen[0] == seen[1] == calls
    assert calls["slot_compact"] >= 2
