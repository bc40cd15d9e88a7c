"""The port's out-of-core apps at the JAX tests' sizes
(``tests/test_ooc_apps.py``): PageRank and k-means over a store at least
10 times a 128 KB device budget, through the streamed ``do_while``
(PageRank through the re-streaming chunk cache), held to the numpy
oracles the JAX tests use; the streamed ``do_while`` with ``cond``; and
a CPU rehearsal of ``chip_smoke.py``'s phase 13 at reduced sizes, which
checks its counts (launches, scattered chunks, cache events)."""

import os
import types

import numpy as np
import torch

from dryad_tpu import Context as JContext
from dryad_tpu.apps import kmeans as jkmeans
from dryad_tpu.utils.config import JobConfig as JJobConfig
from dryad_tpu_torch import Context as TContext
from dryad_tpu_torch import JobConfig
from dryad_tpu_torch.apps import kmeans as tkmeans
from dryad_tpu_torch.apps import pagerank as tpagerank
from dryad_tpu_torch.io.store import store_meta
from dryad_tpu_torch.utils.events import EventLog
from tests.torch_threads import one_torch_thread  # noqa: F401

BUDGET = 128 << 10          # the JAX tests' device-memory budget
ITERS = 3



def _assert_10x(path):
    assert sum(store_meta(path)["bytes"]) >= 10 * BUDGET


def test_pagerank_stream_10x_budget(tmp_path):
    """test_pagerank_ooc_10x_budget's graph (1,000 nodes, 163,840 edges
    with the ring, seed 3): the edges stream from the store into the
    re-streaming cache (one cold write for the edges, one for the
    out-degrees), every superstep re-streams it, and the ranks are within
    rtol 2e-3 of pagerank_numpy."""
    n_nodes = 1000
    n_edges = (10 * BUDGET) // 8
    edges = tpagerank.gen_graph(n_nodes, n_edges - n_nodes, seed=3)
    estore = str(tmp_path / "edges")
    TContext(device="cpu", nparts=8).from_columns(edges).to_store(estore)
    _assert_10x(estore)
    log = EventLog(level=2)
    ctx = TContext(device="cpu", event_log=log, config=JobConfig(
        ooc_chunk_rows=1 << 15, device_hbm_bytes=BUDGET,
        ooc_cache_dir=str(tmp_path / "cc")))
    out = tpagerank.pagerank_stream(ctx, ctx.read_store_stream(
        estore).cache(), n_nodes, n_iters=ITERS)
    exp = tpagerank.pagerank_numpy(edges, n_nodes, n_iters=ITERS)
    got = np.zeros(n_nodes)
    got[np.asarray(out["node"])] = np.asarray(out["rank"], np.float64)
    np.testing.assert_allclose(got, exp, rtol=2e-3, atol=1e-6)
    kinds = [e["event"] for e in log.events
             if e["event"].startswith("ooc_cache")]
    assert kinds.count("ooc_cache_write") == 2
    assert kinds.count("ooc_cache_hit") >= 2 * ITERS


def test_kmeans_stream_10x_budget(tmp_path, capsys):
    """test_kmeans_ooc_10x_budget's points (dim 16, k = 4, 20,480 points,
    seed 1, the first 4 as init, 16,384-row chunks, 3 iterations) held
    within 1e-3 of kmeans_numpy (PERF.md §2's k-means gate); the port's
    largest error is printed beside the JAX package's on the same data
    (that test holds the JAX one to 2e-4)."""
    dim, k = 16, 4
    n_pts = (10 * BUDGET) // (dim * 4)
    pts, _ = tkmeans.gen_points(n_pts, dim, k, seed=1)
    pstore = str(tmp_path / "pts")
    TContext(device="cpu", nparts=8).from_columns(pts).to_store(pstore)
    _assert_10x(pstore)
    init = np.asarray(pts["x"])[:k].copy()
    exp = tkmeans.kmeans_numpy(pts, k, n_iters=ITERS, init_centers=init)
    ctx = TContext(device="cpu", config=JobConfig(
        ooc_chunk_rows=1 << 14, device_hbm_bytes=BUDGET))
    got = tkmeans.kmeans_stream(ctx, ctx.read_store_stream(
        pstore, chunk_rows=1 << 14), k, init, n_iters=ITERS)
    jctx = JContext(config=JJobConfig(ooc_chunk_rows=1 << 14,
                                      device_hbm_bytes=BUDGET))
    jgot = jkmeans.kmeans_stream(jctx, jctx.read_store_stream(
        pstore, chunk_rows=1 << 14), k, init, n_iters=ITERS)
    err, jerr = np.abs(got - exp).max(), np.abs(jgot - exp).max()
    with capsys.disabled():
        print(f"\nkmeans_stream max |err| vs kmeans_numpy: port {err:.3g}, "
              f"JAX package {jerr:.3g}")
    np.testing.assert_allclose(got, exp, rtol=1e-3, atol=1e-3)


def test_streamed_do_while_cond_stops_early(tmp_path):
    """The streamed do_while honors ``cond`` (a predicate on the loop
    state collected to the host), as the in-memory one does."""
    store = str(tmp_path / "src")
    TContext(device="cpu", nparts=2).from_columns(
        {"v": np.arange(64, dtype=np.int32)}).to_store(store)
    ctx = TContext(device="cpu", config=JobConfig(ooc_chunk_rows=16))
    src = ctx.read_store_stream(store, chunk_rows=16)
    seen = []

    def body(state):
        return (src.take(1).zip_with(state)
                .select(lambda c: {"x": c["x"] + 1}))

    def cond(t):
        seen.append(int(np.asarray(t["x"])[0]))
        return seen[-1] < 3

    out = ctx.do_while(ctx.from_columns({"x": np.asarray([0], np.int32)}),
                       body, n_iters=10, cond=cond).collect()
    assert int(np.asarray(out["x"])[0]) == 3 and seen == [1, 2, 3]


def test_chip_smoke_phase13_rehearsal(monkeypatch, tmp_path):
    """chip_smoke.py's phase 13 on the CPU at reduced sizes (the card's
    synchronize and sync-debug switch stubbed, no profile, no peak
    memory) with every
    plain kernel version bumping its launch counter: each run equals its
    oracle, hist_buckets launches
    once per scattered chunk in the streamed TeraSort (none at the
    in-core tier), the cache events of the streamed PageRank come as on
    the card, and every captured kernel call is held."""
    import chip_smoke
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
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda m: None)
    port = types.SimpleNamespace(
        Context=lambda device="cuda", **kw: TContext(device="cpu", **kw),
        JobConfig=JobConfig)
    runs = {}

    def held(label, launches, captured):
        runs[label] = (launches, chip_smoke.hold_run(hk, label, captured))

    monkeypatch.setattr(chip_smoke, "PR_ITERS", 3)
    monkeypatch.setattr(chip_smoke, "STREAM_PR_ITERS", 3)
    monkeypatch.setattr(chip_smoke, "KM_ITERS", 2)
    lines = chip_smoke.bench_corpus(3_000)
    sizes = chip_smoke.Phase13Sizes(
        records=60_000, small_records=20_000, record_chunk=8_192,
        app_records=30_000, nodes=2_000, points=20_000, point_chunk=4_096,
        lineitems=120_000, stream_chunk=4_096, text_chunk=1_024)
    out = chip_smoke.phase13_runs(port, hk, sizes, str(tmp_path), lines,
                                  chip_smoke.oracle(lines), held,
                                  device="cpu")
    tera = out["terasortooc10m"]
    sort = tera["depth2"]["sort"]
    assert sort["scattered"] == -(-60_000 // 8_192)
    assert tera["depth2"]["cold"]["launches"]["hist_buckets"] == \
        sort["scattered"] + sort["rebucketed"]
    assert tera["incore"]["launches"]["hist_buckets"] == 0
    assert tera["app"]["sort"]["scattered"] == -(-30_000 // 8_192)
    assert {(run, nb) for run, _n, nb in out["scatter_calls"]} == {
        ("terasortooc10m", sort["n_buckets"]), ("pagerankstream100k", 64),
        ("kmeansstream500k", 64)}
    pr = out["pagerankstream100k"]
    assert pr["cold"]["cache_writes"] == 2 and pr["cold"]["cache_hits"] >= 6
    assert pr["warm"]["cache_writes"] == 0
    for how in ("right", "full"):
        assert out["q13stream1m5"][how]["unmatched_customers"] == 1_000
    assert out["readtextstream1m"]["words"] == 12
    launched = {k for _, errs in runs.values() for k in errs}
    assert {"hist_buckets", "prefix_sum", "prefix_sum2"} <= launched
    assert all(e == 0.0 for _, errs in runs.values() for e in errs.values())
    assert os.listdir(str(tmp_path)) == []
