"""A CPU rehearsal of ``chip_smoke.py``'s phase 21 (multi-axis meshes and
hierarchical group aggregation): its functions run with the Context on
the CPU and a ``LocalCluster(2, 4, device="cpu")`` at reduced sizes
(GroupByReduce's 20,000 rows on 300 keys, 3,000 WordCount lines), with
the plain kernel versions the driver calls counting as launches.  The
workers' plain versions count nothing here, so the rehearsal checks the
cells' results against phase 4's one-axis tables and the oracles, the
combine stages, the gang's mirrored stage logs and staged bytes, and
the collapse on every worker; the workers' launch checks run on the
card only."""

import os
import sys
import types

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)
import chip_smoke  # noqa: E402

from dryad_tpu_torch import (Context, Decomposable, JobConfig,  # noqa: E402
                             make_mesh)
from dryad_tpu_torch.apps import groupbyreduce as tgbr  # noqa: E402
from dryad_tpu_torch.apps import wordcount as twc  # noqa: E402
from dryad_tpu_torch.ops import hopper_kernels as hk  # noqa: E402
from tests.test_torch_gang_smoke import _counting  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401


def test_chip_smoke_phase21_rehearsal(monkeypatch, tmp_path):
    _counting(monkeypatch)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")

    def ctx(device="cuda", **kw):
        return Context(**kw) if "cluster" in kw else Context(device="cpu",
                                                             **kw)
    port = types.SimpleNamespace(
        Context=ctx, JobConfig=JobConfig, Decomposable=Decomposable,
        make_mesh=lambda device="cuda", *a, **kw: make_mesh("cpu", *a, **kw))
    runs = {}

    def held(label, launches, captured=None, errs=None):
        if errs is None:
            errs = chip_smoke.hold_run(hk, label, captured)
        runs[label] = (launches, errs)

    variants = chip_smoke.gbr_variants(port, tgbr)
    data = tgbr.gen_pairs(20_000, 300, seed=0)
    flat = {}
    for vname in ("app10k", "decomposable10k"):
        c = Context(device="cpu", nparts=chip_smoke.NPARTS)
        flat[vname] = variants[vname][1](c.from_columns(data)).collect()
    lines = chip_smoke.zipf_corpus(3_000)
    counts = chip_smoke.oracle(lines)
    # the gang is handed in, as main hands phase 20's over, and stays up
    from dryad_tpu_torch.runtime import LocalCluster
    cl = LocalCluster(n_processes=2, devices_per_process=4, device="cpu")
    try:
        out = chip_smoke.phase21_runs(port, hk, data, variants, flat, twc,
                                      lines, counts, held, str(tmp_path),
                                      device="cpu", cluster=cl)
        assert cl.alive()
    finally:
        cl.shutdown()
    assert sorted(out) == sorted(
        ["mesh2d_app10k", "mesh3d_app10k", "mesh2d_decomposable10k",
         "mesh2d_wordcount", "gang_mesh_app10k", "gang_adaptive_collapse",
         "mesh_gang_replay"])
    assert out["mesh3d_app10k"]["combine_stages"] == [
        "groupby-dp", "groupby-host", "groupby-dcn"]
    assert out["mesh2d_decomposable10k"]["combine_stages"] == [
        "dgroupby-dp", "dgroupby-dcn"]
    assert out["mesh2d_app10k"]["mesh"] == {"dcn": 2, "dp": 4}
    for label in ("mesh2d_app10k", "mesh3d_app10k", "mesh2d_wordcount"):
        # one exchange a level
        assert out[label]["launches"]["slot_expand"] == len(
            out[label]["combine_stages"])
    gang = out["gang_mesh_app10k"]
    assert gang["processes"] == 2 and gang["groups"] == 300
    for staged in gang["staged_bytes"].values():
        assert staged["groupby-dp"] == [0] and staged["groupby-dcn"][0] > 0
    ad = out["gang_adaptive_collapse"]
    assert "agg_tree_collapse" in ad["rewrites"]
    assert len(set(ad["worker_rewrites"].values())) == 1
    rep = out["mesh_gang_replay"]
    assert all(rep["replay_launches"][k] for k in chip_smoke.EXCHANGE)
    assert all(e == 0.0 for e in rep["max_abs_err"].values())
    assert "mesh_gang" in runs and "mesh2d_wordcount" in runs

