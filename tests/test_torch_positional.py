"""The port's positional operators: ``zip_with`` (the realigning
``parallel/shuffle.zip_exchange`` and ``ops/kernels.zip2``),
``with_row_index``, ``skip``, ``take_while`` and ``skip_while``, against
the JAX package on its 8-device CPU mesh with the same numpy inputs
(mirrors ``tests/test_operators_ext.py``), and against numpy in global
row order.

Tolerance: none.  Every output compares IN ORDER, column by column, as
exact values (integers and f32 carried unchanged)."""

import numpy as np
import pytest

from dryad_tpu import Context as JContext
from dryad_tpu_torch import Context as TContext

P = 8


def _cols(n=100, seed=0):
    rng = np.random.RandomState(seed)
    return {"k": rng.randint(0, 10, n).astype(np.int32),
            "v": rng.randn(n).astype(np.float32),
            "i": np.arange(n, dtype=np.int32)}


def _run(ctx, build, n=100, seed=0, capacity=32):
    """build(dataset) collected; one partition takes every row."""
    return build(ctx.from_columns(
        _cols(n, seed), capacity=capacity if ctx.nparts > 1 else None)
    ).collect()


def _both(build, nparts=P, **kw):
    """(port table, JAX table), each column a numpy array."""
    t = _run(TContext(device="cpu", nparts=nparts), build, **kw)
    j = _run(JContext(), build, **kw)
    return ({k: np.asarray(v) for k, v in t.items()},
            {k: np.asarray(v) for k, v in j.items()})


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for c in want:
        np.testing.assert_array_equal(got[c], want[c], err_msg=c)


@pytest.mark.parametrize("nparts", [1, 8])
def test_zip_aligned(devices8, nparts):
    """Both sides from one dataset: pairs row for row."""
    def q(d):
        return d.select(lambda c: {"x": c["k"]}).zip_with(
            d.select(lambda c: {"y": c["v"]}))

    got, want = _both(q, nparts)
    _assert_same(got, want)
    c = _cols()
    np.testing.assert_array_equal(got["x"], c["k"])
    np.testing.assert_array_equal(got["y"], c["v"])


def _misaligned(d, e):
    left = d.where(lambda x: x["v"] > 0.2)
    right = e.where(lambda x: x["v"] < 0.5).select(
        lambda x: {"k2": x["k"], "v2": x["v"], "i": x["i"]})
    return left.zip_with(right)


def test_zip_misaligned_partitions(devices8):
    """The two sides filtered differently have different per-partition
    counts: the realignment pairs global row g with global row g (a
    clashing column name takes the suffix)."""
    outs = []
    for ctx in (TContext(device="cpu", nparts=P), JContext()):
        a = ctx.from_columns(_cols(120, 1), capacity=32)
        b = ctx.from_columns(_cols(120, 2), capacity=32)
        outs.append({k: np.asarray(v)
                     for k, v in _misaligned(a, b).collect().items()})
    _assert_same(*outs)
    ca, cb = _cols(120, 1), _cols(120, 2)
    la, rb = ca["v"] > 0.2, cb["v"] < 0.5
    n = min(la.sum(), rb.sum())
    np.testing.assert_array_equal(outs[0]["i"], ca["i"][la][:n])
    np.testing.assert_array_equal(outs[0]["i_r"], cb["i"][rb][:n])
    np.testing.assert_array_equal(outs[0]["v2"], cb["v"][rb][:n])


@pytest.mark.parametrize("longer", ["left", "right"])
def test_zip_shorter_side(devices8, longer):
    """As many rows as the shorter side, whichever it is."""
    def q(d):
        a = d.select(lambda c: {"x": c["i"]})
        b = d.where(lambda c: c["i"] % 3 == 0).select(
            lambda c: {"y": c["i"]})
        return a.zip_with(b) if longer == "left" else b.zip_with(a)

    got, want = _both(q)
    _assert_same(got, want)
    thirds = np.arange(0, 100, 3, dtype=np.int32)
    assert len(next(iter(got.values()))) == len(thirds)
    np.testing.assert_array_equal(got["x" if longer == "left" else "y"],
                                  np.arange(len(thirds), dtype=np.int32)
                                  if longer == "left" else thirds)


def test_zip_send_slot_skew_retries_slack(devices8):
    """Every left row lies in the last partition, so each right partition
    sends all its rows to one destination: the send slots fall short and
    the stage retries with more slack (never a receive shortfall)."""
    t = TContext(device="cpu", nparts=P)

    def q(d):
        return d.where(lambda c: c["i"] >= 700).select(
            lambda c: {"x": c["i"]}).zip_with(
            d.select(lambda c: {"y": c["i"]}))

    got = {k: np.asarray(v) for k, v in
           _run(t, q, n=800, capacity=100).items()}
    (st,) = [s for s in t.executor.stage_log if s["label"] == "zip"]
    assert st["attempts"] == 2 and st["slack"] > 2 and st["scale"] == 1
    np.testing.assert_array_equal(got["x"], np.arange(700, 800))
    np.testing.assert_array_equal(got["y"], np.arange(100))
    want = {k: np.asarray(v) for k, v in
            _run(JContext(), q, n=800, capacity=100).items()}
    _assert_same(got, want)


@pytest.mark.parametrize("filtered", [False, True])
def test_with_row_index(devices8, filtered):
    def q(d):
        if filtered:
            d = d.where(lambda c: c["k"] > 3)
        return d.with_row_index()

    got, want = _both(q)
    _assert_same(got, want)
    n = len(got["i"])
    np.testing.assert_array_equal(got["row_index"], np.arange(n))
    assert got["row_index"].dtype == np.int32


@pytest.mark.parametrize("n", [0, 1, 37, 99, 100, 1000])
def test_skip(devices8, n):
    got, want = _both(lambda d: d.where(lambda c: c["k"] != 4).skip(n))
    _assert_same(got, want)
    c = _cols()
    np.testing.assert_array_equal(got["i"], c["i"][c["k"] != 4][n:])


# (predicate, what it does to the global order)
PREDICATES = {
    "fails_midway": lambda c: c["v"] > -1.2,
    "never_fails": lambda c: c["v"] > -100.0,
    "fails_first": lambda c: c["i"] > 0,
    "fails_late": lambda c: c["i"] < 63,
}


@pytest.mark.parametrize("op", ["take_while", "skip_while"])
@pytest.mark.parametrize("pred", sorted(PREDICATES))
def test_take_skip_while(devices8, op, pred):
    fn = PREDICATES[pred]
    got, want = _both(lambda d: getattr(d, op)(fn))
    _assert_same(got, want)
    c = _cols()
    ok = np.asarray(fn({k: v for k, v in c.items()}))
    first = int(np.argmin(ok)) if not ok.all() else len(ok)
    sel = slice(0, first) if op == "take_while" else slice(first, None)
    np.testing.assert_array_equal(got["i"], c["i"][sel])


def test_positional_chain_matches_numpy(devices8):
    """Phase 9's zip6m query at a small size: two differently filtered
    sides zipped, a row index, skip, take_while; and skip_while on a row
    index."""
    n = 4000

    def cols():
        rng = np.random.RandomState(6)
        return {"price": rng.randint(1, 100, n).astype(np.int32),
                "qty": rng.randint(1, 10, n).astype(np.int32),
                "i": np.arange(n, dtype=np.int32)}

    def q(ctx):
        li = ctx.from_columns(cols())
        a = li.where(lambda c: c["qty"] > 4)
        b = li.where(lambda c: c["price"] > 50)
        z = a.zip_with(b).with_row_index().skip(300).take_while(
            lambda c: c["row_index"] < 1000).collect()
        s = li.with_row_index().skip_while(
            lambda c: c["row_index"] < 1500).collect()
        return z, s

    (tz, ts), (jz, js) = (q(TContext(device="cpu", nparts=P)),
                          q(JContext()))
    for got, want in ((tz, jz), (ts, js)):
        _assert_same({k: np.asarray(v) for k, v in got.items()},
                     {k: np.asarray(v) for k, v in want.items()})
    c = cols()
    a, b = c["i"][c["qty"] > 4], c["i"][c["price"] > 50]
    m = min(len(a), len(b))
    np.testing.assert_array_equal(np.asarray(tz["i"]), a[:m][300:1000])
    np.testing.assert_array_equal(np.asarray(tz["i_r"]), b[:m][300:1000])
    np.testing.assert_array_equal(np.asarray(tz["row_index"]),
                                  np.arange(300, 1000))
    np.testing.assert_array_equal(np.asarray(ts["i"]), c["i"][1500:])


def test_positional_plans_match_jax(devices8):
    """Zip is two legs and no exchange, the single-input positional ops
    are row-local ops: the plan equals the JAX package's."""
    from dryad_tpu.plan.planner import plan_query as jplan_query

    def q(d):
        return _misaligned(d, d).with_row_index().skip(3).take_while(
            lambda c: c["row_index"] < 9).skip_while(
            lambda c: c["row_index"] < 5)

    t = q(TContext(device="cpu", nparts=P).from_columns(_cols()))
    jctx = JContext()
    j = q(jctx.from_columns(_cols()))
    assert t.explain() == jplan_query(j.node, P).explain()
