"""The PageRank slice end to end: ``apps/pagerank.py`` through the port's
user entry points (``dryad_tpu_torch``, device="cpu", nparts=8 — every
kernel wrapper runs its plain version) against the JAX app on its
8-device CPU mesh and the float64 ``pagerank_numpy``, the plans both
packages make for it, and a CPU rehearsal of chip_smoke.py's phase 7.

Tolerance: the node sets are exactly 0..n-1; each rank of the port and
of the JAX app within rtol 2e-3 of ``pagerank_numpy`` (the JAX app test's
tolerance) and port and JAX within 1e-4 relative of each other (their f32
group sums add in different orders); the ranks sum to 1 within 1e-2.
Plans match exactly: stages, legs, exchanges, op kinds and capacities."""

import numpy as np
import pytest

import dryad_tpu.api.dataset as jds
import dryad_tpu_torch
import dryad_tpu_torch.api.dataset as tds
from dryad_tpu import Context as JContext
from dryad_tpu.apps import pagerank as jpr
from dryad_tpu_torch import Context as TContext
from dryad_tpu_torch.apps import pagerank as tpr
from dryad_tpu_torch.ops import hopper_kernels as hk
from tests.torch_threads import one_torch_thread  # noqa: F401

P = 8
SIZES = {"64x400": (64, 400), "2000x20000": (2000, 20_000)}


def _run(module, pr, ctx, edges, n, monkeypatch):
    """The app on ``ctx``, recording every plan it makes."""
    graphs = []
    real = module.plan_query

    def recording(*a, **kw):
        graphs.append(real(*a, **kw))
        return graphs[-1]

    monkeypatch.setattr(module, "plan_query", recording)
    out = pr.pagerank(ctx, edges, n, n_iters=10)
    monkeypatch.setattr(module, "plan_query", real)
    return out, graphs


@pytest.fixture(scope="module")
def runs(devices8):
    mp = pytest.MonkeyPatch()
    got = {}
    for name, (n, e) in SIZES.items():
        edges = tpr.gen_graph(n, e)
        jedges = jpr.gen_graph(n, e)
        for c in ("src", "dst"):
            np.testing.assert_array_equal(edges[c], jedges[c])
        got[name] = (edges, n,
                     _run(tds, tpr, TContext(device="cpu", nparts=P), edges,
                          n, mp),
                     _run(jds, jpr, JContext(), jedges, n, mp))
    mp.undo()
    return got


def _ranks(out, n):
    nodes = np.asarray(out["node"])
    assert np.array_equal(np.sort(nodes), np.arange(n))
    r = np.empty(n)
    r[nodes] = np.asarray(out["rank"], np.float64)
    return r


@pytest.mark.parametrize("size", list(SIZES))
def test_pagerank_matches_jax_and_numpy(runs, size):
    edges, n, (tout, _), (jout, _) = runs[size]
    ref = tpr.pagerank_numpy(edges, n, 10)
    np.testing.assert_allclose(ref, jpr.pagerank_numpy(edges, n, 10),
                               rtol=0)
    t, j = _ranks(tout, n), _ranks(jout, n)
    np.testing.assert_allclose(t, ref, rtol=2e-3)
    np.testing.assert_allclose(j, ref, rtol=2e-3)
    np.testing.assert_allclose(t, j, rtol=1e-4)
    assert abs(t.sum() - 1.0) < 1e-2


def _sig(graph):
    """A stage graph as plain data: per stage its label, legs (source,
    op kinds with any capacity, exchange kind / keys / capacity), body
    ops, placement_relied and salt_ok; and the output stage."""
    def ops(seq):
        return [(op.kind, op.params.get("capacity"),
                 op.params.get("out_capacity"),
                 op.params.get("right_unique")) for op in seq]

    stages = []
    for st in graph.stages:
        legs = [(leg.src if isinstance(leg.src, int) else leg.src[0],
                 ops(leg.ops),
                 leg.exchange and (leg.exchange.kind,
                                   tuple(leg.exchange.keys),
                                   leg.exchange.out_capacity))
                for leg in st.legs]
        stages.append((st.label, legs, ops(st.body), st.placement_relied,
                       st.salt_ok))
    return stages, graph.out_stage


@pytest.mark.parametrize("size", list(SIZES))
def test_pagerank_plans_match_jax(runs, size):
    """Every plan the app makes (the cached edges-with-degree join, the
    rank table's materialization, the do_while body, the final collect)
    has the JAX package's stages, legs, exchanges and capacities.  The
    body's left leg (the cached join, hash-placed on src) exchanges
    nothing; only the rank table does."""
    edges, n, (_, tg), (_, jg) = runs[size]
    assert [_sig(g) for g in tg] == [_sig(g) for g in jg]
    assert len(tg) == 4
    body = tg[2]
    join = body.stages[0]
    assert join.label == "join"
    assert [leg.exchange is None for leg in join.legs] == [True, False]
    assert [leg.src[0] for leg in join.legs] == ["source", "placeholder"]
    cache = tg[0]
    assert [st.label for st in cache.stages] == \
        ["tee:Source", "groupby", "join"]
    assert [leg.exchange is None for leg in cache.stages[2].legs] == \
        [False, True]


def _counting_plain(monkeypatch):
    """Every kernel wrapper's plain version bumps the kernel's launch
    counter, as the kernel does on the card."""
    for name, plain in (("hist_buckets", "hist_buckets_batched_plain"),
                        ("prefix_sum", "prefix_sum_plain"),
                        ("prefix_sum2", "prefix_sum2_plain"),
                        ("slot_expand", "slot_expand_batched_plain"),
                        ("slot_compact", "slot_compact_batched_plain")):
        real = getattr(hk, plain)

        def bump(*a, _real=real, _name=name):
            hk.launches[_name] += 1
            return _real(*a)
        monkeypatch.setattr(hk, plain, bump)


def test_chip_smoke_pagerank_rehearsal(devices8, monkeypatch):
    """chip_smoke.py's phase 7 at 2,000 nodes on the CPU: its oracle
    accepts the run and rejects a changed rank or a lost node; every
    kernel's counter rises; hist_buckets and slot_expand count one per
    exchanging leg and attempt over the executor's logs of every run of
    the job, which the check holds (and refuses one off)."""
    import chip_smoke
    _counting_plain(monkeypatch)
    n = 2000
    edges = tpr.gen_graph(n, 10 * n)
    out, launches, load, query, runs = chip_smoke.run_pagerank(
        dryad_tpu_torch, hk, tpr, edges, n, device="cpu")
    sizes = chip_smoke.check_pagerank(out, edges, n, tpr)
    assert sizes["max_rel_err"] <= 2e-3 and load > 0 and query > 0
    assert all(launches[k] > 0 for k in chip_smoke.TPU_KERNEL)
    stages = chip_smoke.loop_stages(runs)
    assert len(stages["supersteps"]) == 10
    # per superstep: the join's rank leg and the group-by's exchange
    assert all(sum(st["exchanges"] for st in step) == 2
               for step in stages["supersteps"])
    attempts = stages["exchange_attempts"]
    assert attempts >= 2 + 2 * 10
    chip_smoke.check_per_exchange("pagerank", launches, attempts)
    with pytest.raises(AssertionError):
        chip_smoke.check_per_exchange("pagerank", launches, attempts + 1)
    bad = dict(out)
    bad["rank"] = np.array(out["rank"]) * np.float32(1.01)
    with pytest.raises(AssertionError, match="rank"):
        chip_smoke.check_pagerank(bad, edges, n, tpr)
    bad = {k: np.asarray(v)[1:] for k, v in out.items()}
    with pytest.raises(AssertionError, match="node set"):
        chip_smoke.check_pagerank(bad, edges, n, tpr)


def test_chip_smoke_profile_path_refuses_a_kernel_without_device_time(
        monkeypatch, tmp_path):
    """A profiled path (PageRank's included) fails at once when a kernel
    that launched shows no device time in its window (it is not taken
    again), and passes when the window sees every launched kernel; a
    kernel that did not launch may show none."""
    import chip_smoke
    takes = []

    def fake(run, label, out_dir, pack):
        takes.append(label)
        seen = len(takes) >= 2
        return {"launches": {"slot_compact": 1, "prefix_sum2": 0},
                "port_kernels_ms": {"slot_compact": 0.1 if seen else 0.0}}

    monkeypatch.setattr(chip_smoke, "profile_run", fake)
    with pytest.raises(AssertionError, match="slot_compact"):
        chip_smoke.profile_path(None, "pagerank100k", str(tmp_path),
                                pack=False)
    assert takes == ["pagerank100k"]
    prof = chip_smoke.profile_path(None, "pagerank100k", str(tmp_path),
                                   pack=False)
    assert prof["port_kernels_ms"] == {"slot_compact": 0.1}
    assert len(takes) == 2
