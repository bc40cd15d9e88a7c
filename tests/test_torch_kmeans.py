"""The k-means slice end to end: ``apps/kmeans.py`` through the port's
user entry points (``dryad_tpu_torch``, device="cpu", nparts=8 — every
kernel wrapper runs its plain version) against the JAX app on its
8-device CPU mesh and the float64 ``kmeans_numpy``, the plans both
packages make for it, the assignment function on its own, and a CPU
rehearsal of chip_smoke.py's phase 8.

Tolerance: port and JAX app within 1e-5 absolute (the same f32 distance
products and group means, added in other orders); both within rtol and
atol 1e-3 of ``kmeans_numpy`` (the JAX app test's tolerance).  Plans
match exactly: stages, legs, exchanges, op kinds and capacities."""

import numpy as np
import pytest

import jax

import dryad_tpu.api.dataset as jds
import dryad_tpu_torch
import dryad_tpu_torch.api.dataset as tds
from dryad_tpu import Context as JContext
from dryad_tpu.apps import kmeans as jkm
from dryad_tpu.data import columnar as jcol
from dryad_tpu_torch import Context as TContext
from dryad_tpu_torch.apps import kmeans as tkm
from dryad_tpu_torch.data import columnar as tcol
from dryad_tpu_torch.ops import hopper_kernels as hk
from test_torch_pagerank import _counting_plain

P = 8


def test_gen_points_matches_jax():
    for args in ((2000, 8, 5, 1), (777, 3, 16, 0)):
        (tp, tc), (jp, jc) = tkm.gen_points(*args), jkm.gen_points(*args)
        np.testing.assert_array_equal(tp["x"], jp["x"])
        np.testing.assert_array_equal(tc, jc)


def _run(module, km, ctx, pts, k, iters, init, monkeypatch):
    """The app on ``ctx``, recording every plan it makes."""
    graphs = []
    real = module.plan_query

    def recording(*a, **kw):
        graphs.append(real(*a, **kw))
        return graphs[-1]

    monkeypatch.setattr(module, "plan_query", recording)
    out = km.kmeans(ctx, pts, k, n_iters=iters, init_centers=init)
    monkeypatch.setattr(module, "plan_query", real)
    return out, graphs


@pytest.fixture(scope="module")
def runs(devices8):
    """tests/test_apps.py's k-means case (2,000 points, dim 8, k = 5, 8
    iterations, seed 1) in both packages."""
    mp = pytest.MonkeyPatch()
    pts, _ = tkm.gen_points(2000, 8, 5, seed=1)
    init = pts["x"][:5].copy()
    got = (pts, init,
           _run(tds, tkm, TContext(device="cpu", nparts=P), pts, 5, 8, init,
                mp),
           _run(jds, jkm, JContext(), pts, 5, 8, init, mp))
    mp.undo()
    return got


def test_kmeans_matches_jax_and_numpy(runs):
    pts, init, (t, _), (j, _) = runs
    ref = tkm.kmeans_numpy(pts, 5, 8, init)
    np.testing.assert_array_equal(ref, jkm.kmeans_numpy(pts, 5, 8, init))
    assert t.shape == j.shape == (5, 8)
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(t, ref, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(j, ref, rtol=1e-3, atol=1e-3)


def _sig(graph):
    """A stage graph as plain data: per stage its label, legs (source,
    op kinds with any capacity, exchange kind / keys / capacity), body
    ops, placement_relied and salt_ok; and the output stage."""
    def ops(seq):
        return [(op.kind, op.params.get("capacity"),
                 op.params.get("out_capacity"), op.params.get("label"))
                for op in seq]

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


def test_kmeans_plans_match_jax(runs):
    """Every plan the app makes (the centroid table's materialization,
    the do_while body, the final collect) has the JAX package's stages,
    legs, exchanges and capacities.  The body's first stage keeps the
    points in place and broadcasts the centroid table (capacity 5 x 8);
    the group-by hash-exchanges its partial means."""
    _, _, (_, tg), (_, jg) = runs
    assert [_sig(g) for g in tg] == [_sig(g) for g in jg]
    assert len(tg) == 3
    body = tg[1]
    assert [st.label for st in body.stages] == \
        ["cross_apply", "groupby", "output"]
    cross = body.stages[0]
    assert [leg.src[0] for leg in cross.legs] == ["source", "placeholder"]
    assert cross.legs[0].exchange is None
    assert (cross.legs[1].exchange.kind,
            cross.legs[1].exchange.out_capacity) == ("broadcast", 5 * P)
    assert [op.kind for op in cross.body] == ["apply2"]
    assert body.stages[1].legs[0].exchange.kind == "hash"


@pytest.mark.parametrize("n,kcount", [(37, 5), (64, 3), (0, 5)])
def test_assign_fn_matches_jax(devices8, n, kcount):
    """The assignment on one partition: a padded point batch (its padding
    holds NaN, which must not reach a valid row) and a centroid table
    with rows past its count; each valid row's cid equals the JAX
    function's, and the points pass through."""
    rng = np.random.RandomState(n + kcount)
    cap, kcap = 64, 8
    x = rng.randn(n, 4).astype(np.float32)
    cents = {"cid": rng.permutation(kcap).astype(np.int32)[:kcount],
             "cx": (rng.randn(kcount, 4) * 3).astype(np.float32)}
    jp = jcol.batch_from_numpy({"x": x}, capacity=cap)
    jc = jcol.batch_from_numpy(cents, capacity=kcap)
    tp = tcol.batch_from_numpy({"x": x}, capacity=cap, device="cpu")
    tc = tcol.batch_from_numpy(cents, capacity=kcap, device="cpu")
    tp.columns["x"][n:] = float("nan")
    tc.columns["cx"][kcount:] = -1e30
    j = jax.jit(jkm._assign_fn)(jp, jc)
    t = tkm._assign_fn(tp, tc)
    assert int(t.count) == int(j.count) == n
    np.testing.assert_array_equal(t.columns["cid"].numpy()[:n],
                                  np.asarray(j.columns["cid"])[:n])
    np.testing.assert_array_equal(t.columns["x"].numpy()[:n], x)
    host = tkm._assign_host({"x": x}, cents)
    np.testing.assert_array_equal(t.columns["cid"].numpy()[:n],
                                  host["cid"])


def test_chip_smoke_kmeans_rehearsal(devices8, monkeypatch):
    """chip_smoke.py's k-means run at 20,000 points on the CPU: its oracle
    accepts the run and rejects a moved centroid or a lost cid; each
    iteration broadcasts once and hash-exchanges once; slot_compact
    launches once per hash exchange plus once per broadcast, which the
    check holds (and refuses one off either way)."""
    import chip_smoke
    _counting_plain(monkeypatch)
    pts, _ = tkm.gen_points(20_000, chip_smoke.KM_DIM, chip_smoke.KM_K,
                            seed=0)
    cents, launches, load, query, runs = chip_smoke.run_kmeans(
        dryad_tpu_torch, hk, tkm, pts, device="cpu")
    sizes = chip_smoke.check_kmeans(cents, pts, tkm)
    assert sizes["max_abs_dev"] <= 1e-3 and load > 0 and query > 0
    assert all(launches[k] > 0 for k in chip_smoke.EXCHANGE)
    stages = chip_smoke.loop_stages(runs)
    assert len(stages["supersteps"]) == chip_smoke.KM_ITERS
    assert stages["broadcast_attempts"] == chip_smoke.KM_ITERS
    attempts = stages["exchange_attempts"]
    assert attempts >= chip_smoke.KM_ITERS
    assert launches["slot_compact"] == attempts + chip_smoke.KM_ITERS
    chip_smoke.check_per_exchange("kmeans", launches, attempts,
                                  chip_smoke.KM_ITERS)
    for b in (chip_smoke.KM_ITERS - 1, chip_smoke.KM_ITERS + 1):
        with pytest.raises(AssertionError):
            chip_smoke.check_per_exchange("kmeans", launches, attempts, b)
    with pytest.raises(AssertionError, match="off kmeans_numpy"):
        chip_smoke.check_kmeans(cents + 2e-3, pts, tkm)
    with pytest.raises(AssertionError, match="cid"):
        chip_smoke.check_kmeans(cents[1:], pts, tkm)


def test_chip_smoke_phase8_rehearsal(devices8, monkeypatch):
    """The set operators, the broadcast join and the scalars of phase 8
    at reduced sizes on the CPU: each oracle accepts the port's result
    and rejects a changed one; the broadcast join launches slot_compact
    once per broadcast and no other exchange kernel."""
    import chip_smoke
    from dryad_tpu_torch.apps import groupbyreduce as gbr
    _counting_plain(monkeypatch)
    port = dryad_tpu_torch
    left, right = chip_smoke.setop_tables(20_000)
    out, launches, _l, _q, runs = chip_smoke.run_app(
        port, hk, lambda ctx: chip_smoke.setop_queries(ctx, left, right),
        device="cpu")
    sizes = chip_smoke.check_setops(out, left, right)
    assert sizes["out_rows"]["concat"] == 40_000
    st = chip_smoke.loop_stages(runs)
    chip_smoke.check_per_exchange("setops", launches,
                                  st["exchange_attempts"],
                                  st["broadcast_attempts"])
    bad = {op: dict(t) for op, t in out.items()}
    bad["intersect"] = {k: v[1:] for k, v in out["intersect"].items()}
    with pytest.raises(AssertionError, match="intersect"):
        chip_smoke.check_setops(bad, left, right)

    bleft, bright = chip_smoke.bcast_tables(gbr, 40_000)
    out, launches, _l, _q, runs = chip_smoke.run_app(
        port, hk, lambda ctx: chip_smoke.bcast_join(ctx, bleft, bright),
        device="cpu")
    st = chip_smoke.loop_stages(runs)
    assert st["broadcast_attempts"] == 1 and st["exchange_attempts"] == 0
    assert launches["slot_compact"] == 1
    assert all(launches[k] == 0 for k in chip_smoke.PACK)
    chip_smoke.check_per_exchange("bcastjoin", launches, 0, 1)
    hashed = chip_smoke.run_app(port, hk, lambda ctx: chip_smoke.bcast_join(
        ctx, bleft, bright, broadcast=False), device="cpu")[0]
    assert chip_smoke.check_bcast_join(out, hashed, bleft)["rows"] == 40_000
    bad = dict(out, w=np.asarray(out["w"]) + (np.arange(40_000) == 7))
    with pytest.raises(AssertionError, match="rows differ"):
        chip_smoke.check_bcast_join(bad, hashed, bleft)

    data = gbr.gen_pairs(40_000, 10_000, seed=0)
    nan_data = chip_smoke.nan_minmax_data()
    out, launches, _l, _q, runs = chip_smoke.run_app(
        port, hk, lambda ctx: chip_smoke.scalar_queries(port, ctx, data,
                                                        nan_data),
        device="cpu")
    chip_smoke.check_scalars(out, data, nan_data)
    st = chip_smoke.loop_stages(runs)
    chip_smoke.check_per_exchange("scalars", launches,
                                  st["exchange_attempts"],
                                  st["broadcast_attempts"])
    for key, wrong in (("sum_k", out["sum_k"] + 1),
                       ("nan_max", np.float32(0.0)),
                       ("mean_v", out["mean_v"] + 1e-3)):
        with pytest.raises(AssertionError, match=key):
            chip_smoke.check_scalars(dict(out, **{key: wrong}), data,
                                     nan_data)
