"""A CPU rehearsal of ``chip_smoke.py``'s phase 20 (the streamed gang and
the SSH backend): phase 13's runs at reduced sizes keep their stores,
then phase 20's cells stream them on a ``LocalCluster(2, 4,
device="cpu")`` and an ``SshCluster`` over ``bash -c`` (60,000 TeraSort
records in 8,192-row chunks, 3,000 text lines, PageRank on 2,000 nodes
for 3 supersteps, Q13 over 120,000 lineitems' orders, 4,000 zipf
lines), with the plain kernel versions the driver's replay calls
counting as launches.  The workers' plain versions count nothing here,
so the rehearsal checks the cells' results, the mirrored wave counters
and range bounds, the spool, the cache events and the SSH restart; the
workers' launch checks run on the card only."""

import os
import sys
import types

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)
import chip_smoke  # noqa: E402

from dryad_tpu_torch import Context, JobConfig, make_mesh  # noqa: E402
from dryad_tpu_torch.apps import wordcount as twc  # noqa: E402
from dryad_tpu_torch.ops import hopper_kernels as hk  # noqa: E402
from tests.test_torch_gang_smoke import _counting  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401


def test_chip_smoke_phase20_rehearsal(monkeypatch, tmp_path):
    _counting(monkeypatch)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda m: None)
    monkeypatch.setattr(chip_smoke, "PR_ITERS", 3)
    monkeypatch.setattr(chip_smoke, "STREAM_PR_ITERS", 3)
    monkeypatch.setattr(chip_smoke, "KM_ITERS", 2)
    monkeypatch.setattr(chip_smoke, "STREAM_TAKE", 100)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")

    def ctx(device="cuda", **kw):
        return Context(**kw) if "cluster" in kw else Context(device="cpu",
                                                             **kw)
    port = types.SimpleNamespace(
        Context=ctx, JobConfig=JobConfig,
        make_mesh=lambda device="cuda", *a, **kw: make_mesh("cpu", *a, **kw))
    runs = {}

    def held(label, launches, captured=None, errs=None):
        if errs is None:
            errs = chip_smoke.hold_run(hk, label, captured)
        runs[label] = (launches, errs)

    text = chip_smoke.bench_corpus(3_000)
    sizes = chip_smoke.Phase13Sizes(
        records=60_000, small_records=20_000, record_chunk=8_192,
        app_records=30_000, nodes=2_000, points=20_000, point_chunk=4_096,
        lineitems=120_000, stream_chunk=4_096, text_chunk=1_024)
    kept = {}
    t13 = tmp_path / "p13"
    t13.mkdir()
    chip_smoke.phase13_runs(port, hk, sizes, str(t13), text,
                            chip_smoke.oracle(text), held, device="cpu",
                            keep=kept)
    assert sorted(kept) == ["pagerank", "q13", "tera", "text"]
    assert os.path.isdir(kept["tera"]["src"])
    zipf = chip_smoke.zipf_corpus(4_000)
    counts = chip_smoke.oracle(zipf)
    zipf_out = twc.wordcount_query(
        Context(device="cpu").from_columns({"line": zipf}, str_max_len=96),
        tokens_per_partition=-(-len(zipf) // 8) * 10).collect()
    t20 = tmp_path / "p20"
    t20.mkdir()
    # main keeps the gang up for phase 21 (which runs its cells on it)
    kept20 = {}
    try:
        out = chip_smoke.phase20_runs(port, hk, twc, zipf, counts, kept,
                                      zipf_out, str(t20), held, device="cpu",
                                      keep=kept20)
        assert kept20["cluster"].alive()
    finally:
        if "cluster" in kept20:
            kept20["cluster"].shutdown()
    assert sorted(out) == sorted(
        ["gang_stream_terasort10m", "gang_stream_wordcount1m",
         "gang_stream_pagerank100k", "gang_stream_q13_1m5",
         "ssh_gang_zipf50k", "stream_gang_replay"])
    tera = out["gang_stream_terasort10m"]
    assert tera["bounds_equal_numpy_cut"] and len(tera["bounds"]) == 1
    assert tera["equal_phase13_rows"] and "want" not in kept["tera"]
    assert tera["waves"] == 1 and tera["hdfs_parts"] == 8
    assert tera["exchange_attempts"]["range"] >= 1
    assert all(s["collectives"] > 0 for s in tera["staged"].values())
    wc = out["gang_stream_wordcount1m"]
    assert wc["compacted_legs"] >= 1 and wc["spooled_stores"] == 2
    pr = out["gang_stream_pagerank100k"]
    assert pr["cache_writes_hits"] == [(2, 0), (0, 2)]
    assert pr["max_rel_diff_inprocess"] <= 1e-6
    q13 = out["gang_stream_q13_1m5"]
    for how in ("right", "full"):
        assert q13[how]["unmatched_customers"] == 1_000
    assert q13["zip"]["rows"] == 30_000
    ssh = out["ssh_gang_zipf50k"]
    assert ssh["staging_s"] > 0 and ssh["restart_wall_s"] > 0
    assert "warm_wall_s" not in pr and "warm_wall_s" in tera
    rep = out["stream_gang_replay"]
    assert all(rep["replay_launches"][k] for k in chip_smoke.TPU_KERNEL)
    assert all(e == 0.0 for e in rep["max_abs_err"].values())
    # the replay's calls are the workers' shapes: 4 local partitions
    # exchanging into all 8
    assert rep["first_call_shapes"]["slot_expand"][0][0] == 4
    assert "stream_gang" in runs
    # phase 20 deletes nothing of phase 13's: main removes both
    assert os.path.isdir(kept["tera"]["src"])
