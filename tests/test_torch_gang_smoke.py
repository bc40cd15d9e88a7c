"""A CPU rehearsal of ``chip_smoke.py``'s phase 19 (the gang): its
functions run on a ``LocalCluster(2, 4, device="cpu")`` at reduced sizes
(4,000 WordCount lines, 20,000 TeraSort records, PageRank on 1,000
nodes for 3 supersteps, 40,000 lineitems), with the plain kernel
versions the driver's replay calls counting as launches.  The workers'
plain versions count nothing here, so the rehearsal checks the cells'
results, the mirrored stage logs, the resident state, the healing and
both watchdog holds; the launch checks run on the card only."""

import os
import sys
import types

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)
import chip_smoke  # noqa: E402

from dryad_tpu_torch import Context, JobConfig, make_mesh  # noqa: E402
from dryad_tpu_torch.apps import pagerank as tpr  # noqa: E402
from dryad_tpu_torch.apps import terasort as tts  # noqa: E402
from dryad_tpu_torch.apps import wordcount as twc  # noqa: E402
from dryad_tpu_torch.ops import hopper_kernels as hk  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

BATCHED = {"hist_buckets": "hist_buckets_batched",
           "prefix_sum": "prefix_sum", "prefix_sum2": "prefix_sum2",
           "slot_expand": "slot_expand_batched",
           "slot_compact": "slot_compact_batched"}


def _counting(monkeypatch):
    """Each batched plain version the wrappers call bumps its kernel's
    counter (a meta tensor's call launches nothing)."""
    for name, fn in BATCHED.items():
        plain = getattr(hk, fn + "_plain")

        def wrap(*a, _p=plain, _k=name, **kw):
            if not any(getattr(x, "is_meta", False) for x in a):
                hk._launched(_k)
            return _p(*a, **kw)
        monkeypatch.setattr(hk, fn + "_plain", wrap)


def test_chip_smoke_phase19_rehearsal(monkeypatch, tmp_path):
    _counting(monkeypatch)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "PR_ITERS", 3)
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

    lines = chip_smoke.zipf_corpus(4_000)
    counts = chip_smoke.oracle(lines)
    tera = tts.gen_records(20_000, seed=0)
    edges = tpr.gen_graph(1_000, 10_000, seed=0)
    out = chip_smoke.phase19_runs(port, hk, twc, tts, lines, counts,
                                  (tera, 10), edges, 1_000, tpr, 40_000,
                                  str(tmp_path), held, device="cpu")
    assert sorted(out) == sorted(
        ["gang_zipf50k", "gang_terasort1m", "gang_pagerank100k",
         "gang_skewjoin6m", "gang_store_cache", "gang_watchdog",
         "gang_replay"])
    for label in ("gang_zipf50k", "gang_terasort1m", "gang_pagerank100k",
                  "gang_skewjoin6m"):
        line = out[label]
        assert line["processes"] == 2 and line["nparts"] == 8
        # every exchange crossed the processes: staged collectives ran
        assert all(s["collectives"] > 0 for s in line["staged"].values())
        assert line["exchanges"] > 0
    pr = out["gang_pagerank100k"]
    assert pr["jobs"] == 3 + 3          # cache, init, 3 supersteps, collect
    assert pr["bit_equal_inprocess"]
    assert pr["superstep_message_bytes_max"] < chip_smoke.GANG_STEP_BYTES
    join = out["gang_skewjoin6m"]["join_stage"]
    assert join["attempts"] == 2 and join["salted"]
    assert out["gang_terasort1m"]["bounds_bit_equal_inprocess"]
    assert out["gang_store_cache"]["healed_through"] == \
        "MissingResidentToken"
    assert out["gang_watchdog"]["frozen_wedged"].startswith(
        "sent no heartbeat")
    rep = out["gang_replay"]
    assert all(rep["replay_launches"][k] for k in chip_smoke.TPU_KERNEL)
    assert all(e == 0.0 for e in rep["max_abs_err"].values())
    # the replay's calls are the workers' shapes: 4 local partitions
    # exchanging into all 8
    (hist,) = rep["first_call_shapes"]["hist_buckets"]
    assert hist[0] == 4
    assert np.isclose(out["gang_pagerank100k"]["rank_sum"], 1.0, atol=1e-2)
    assert "gang" in runs
