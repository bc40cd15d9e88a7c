"""The port's terminal scalars — ``count``, ``sum``, ``min``, ``max``,
``mean``, ``any``, ``all``, ``first`` and ``aggregate`` (``api/dataset``,
per-partition partials from ``kernels.scalar_aggregate`` combined on the
host) — against the JAX package on its 8-device CPU mesh for 32-bit
columns and against numpy for 64-bit ones (the JAX package runs without
x64 and would cut them to 32 bits), with the same numpy inputs.

Tolerance: integer results, counts, min / max (NaN bits included), any /
all and first exactly.  An f32 sum or mean adds in another order than
the JAX package and numpy: within 16·2^-24·Σ|v| of the float64 value
(the GroupByReduce bound, PERF.md §2), and port against JAX within twice
that."""

import numpy as np
import pytest

import jax
import torch

from dryad_tpu import Context as JContext
from dryad_tpu import Decomposable as JDecomposable
from dryad_tpu.data import columnar as jcol
from dryad_tpu.ops import kernels as jkern
from dryad_tpu_torch import Context as TContext
from dryad_tpu_torch import Decomposable as TDecomposable
from dryad_tpu_torch.data import columnar as tcol
from dryad_tpu_torch.ops import kernels as tkern

P = 8
EPS = 2.0**-24
KINDS = ("sum", "min", "max", "mean", "any", "all")


def _data(n, seed=0):
    rng = np.random.RandomState(seed)
    return {"i": rng.randint(-1000, 1000, n).astype(np.int32),
            "f": rng.randn(n).astype(np.float32),
            "b": rng.rand(n) < 0.3,
            "x": rng.randn(n, 4).astype(np.float32)}


def _both(cols, query):
    """(port result, JAX result) of ``query`` on ``from_columns(cols)``."""
    return (query(TContext(device="cpu", nparts=P).from_columns(cols)),
            query(JContext().from_columns(cols)))


def _close(got, want, v):
    """An f32 sum or mean within the bound of the float64 value."""
    bound = 16 * EPS * np.abs(np.asarray(v, np.float64)).sum(axis=0)
    return np.all(np.abs(np.asarray(got, np.float64) - want) <= bound)


def _f64(kind, v):
    v = np.asarray(v, np.float64)
    return v.sum(axis=0) if kind == "sum" else v.mean(axis=0)


# every kind on every column, but min / max / mean of a bool column,
# which the JAX package refuses too
CASES = [(kind, col) for kind in KINDS for col in ("i", "f", "b", "x")
         if not (col == "b" and kind in ("min", "max", "mean"))]


@pytest.mark.parametrize("kind,col", CASES)
@pytest.mark.parametrize("n", [1, 5, 1000])
def test_scalars_match_jax(devices8, kind, col, n):
    """Every terminal scalar on int32, f32, bool and a [n, 4] f32 column,
    with partitions left empty at n = 1 and 5.  The JAX package's masked
    reductions refuse a vector column once a partition holds more than
    one row (the [cap] mask does not broadcast against [cap, 4]), so the
    vector column is held to numpy alone there; the port reduces it per
    element."""
    cols = _data(n)
    if col == "x" and n > P:
        t = getattr(TContext(device="cpu", nparts=P).from_columns(cols),
                    kind)(col)
        j = None
    else:
        t, j = _both(cols, lambda ds: getattr(ds, kind)(col))
    v = cols[col]
    if j is None:
        if kind in ("sum", "mean"):
            assert _close(t, _f64(kind, v), v) and np.shape(t) == (4,)
        elif kind in ("min", "max"):
            np.testing.assert_array_equal(t, getattr(v, kind)(axis=0))
        else:
            assert t == bool(getattr(np, kind)(v != 0))
        return
    if kind in ("any", "all"):
        assert type(t) is bool and t == j == bool(getattr(np, kind)(v != 0))
        return
    assert np.shape(t) == np.shape(j)
    if col in ("f", "x") and kind in ("sum", "mean"):
        want = _f64(kind, v)
        assert _close(t, want, v) and _close(j, want, v)
        assert np.all(np.abs(np.asarray(t, np.float64) - np.asarray(j))
                      <= 2 * 16 * EPS * np.abs(v.astype(np.float64))
                      .sum(axis=0))
        return
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j))
    if kind == "mean":      # integer mean: the f32 sum over the count
        np.testing.assert_allclose(t, v.astype(np.float64).mean(axis=0),
                                   rtol=1e-6)
    else:
        np.testing.assert_array_equal(
            t, getattr(v, {"sum": "sum", "min": "min", "max": "max"}[kind])(
                axis=0))


def test_count_and_first_match_jax(devices8):
    cols = _data(333)
    for t, j in (_both(cols, lambda ds: ds.count()),
                 _both(cols, lambda ds: ds.where(
                     lambda c: c["i"] > 990).count())):
        assert t == j
    assert _both(cols, lambda ds: ds.count())[0] == 333
    t, j = _both(cols, lambda ds: ds.where(lambda c: c["i"] > 0).first())
    first = int(np.flatnonzero(cols["i"] > 0)[0])
    assert sorted(t) == sorted(j)
    for k in t:
        np.testing.assert_array_equal(np.asarray(t[k]), np.asarray(j[k]))
        np.testing.assert_array_equal(np.asarray(t[k]), cols[k][first])


@pytest.mark.parametrize("kind", KINDS)
def test_empty_dataset_matches_jax(devices8, kind):
    """No row left: count 0, sum 0, min / max / mean None, any False, all
    True, as in the JAX package."""
    cols = _data(64)
    t, j = _both(cols, lambda ds: getattr(
        ds.where(lambda c: c["i"] > 5000), kind)("f"))
    if kind in ("min", "max", "mean"):
        assert t is None and j is None
    else:
        assert np.asarray(t).tolist() == np.asarray(j).tolist()
    assert _both(cols, lambda ds: ds.where(
        lambda c: c["i"] > 5000).count()) == (0, 0)


@pytest.mark.parametrize("kind", ["min", "max", "sum", "mean"])
def test_nan_scalars_match_jax_and_numpy(devices8, kind):
    """A NaN in one partition: min / max / sum / mean are NaN with the
    bits numpy gives, in both packages."""
    cols = _data(400, seed=3)
    cols["f"][123] = np.nan
    t, j = _both(cols, lambda ds: getattr(ds, kind)("f"))
    want = getattr(np, kind)(cols["f"])
    bits = [np.float32(x).view(np.uint32) for x in (t, j, want)]
    assert np.isnan(want) and bits[0] == bits[1] == bits[2]


@pytest.mark.parametrize("kind", ["sum", "min", "max", "mean"])
def test_64bit_scalars_match_numpy(kind):
    """int64 and float64 columns keep 64 bits in the port (the JAX
    package would cut them): held to numpy."""
    rng = np.random.RandomState(9)
    cols = {"l": rng.randint(-2**40, 2**40, 500).astype(np.int64),
            "d": rng.randn(500)}
    ds = TContext(device="cpu", nparts=P).from_columns(cols)
    for c in cols:
        got = getattr(ds, kind)(c)
        want = getattr(cols[c], kind)()
        if c == "d" and kind in ("sum", "mean"):
            np.testing.assert_allclose(got, want, rtol=1e-12)
        elif kind == "mean":
            # an integer mean is the f32 sum over the count
            np.testing.assert_allclose(got, want, rtol=1e-6)
        else:
            assert got == want


@pytest.mark.parametrize("n,cap", [(0, 8), (5, 8), (64, 64)])
def test_scalar_aggregate_kernel_matches_jax(devices8, n, cap):
    """One partition's partials, every kind at once, padding rows holding
    values that would change each result."""
    rng = np.random.RandomState(n)
    cols = {"i": rng.randint(-50, 50, n).astype(np.int32),
            "f": rng.randn(n).astype(np.float32),
            "b": rng.rand(n) < 0.5}
    aggs = {"n": ("count", None), "si": ("sum", "i"), "sf": ("sum", "f"),
            "mi": ("mean", "i"), "mf": ("mean", "f"), "lo": ("min", "i"),
            "hi": ("max", "f"), "an": ("any", "b"), "al": ("all", "b")}
    jb = jcol.batch_from_numpy(cols, capacity=cap)
    tb = tcol.batch_from_numpy(cols, capacity=cap, device="cpu")
    # garbage in the padding rows
    for k, v in tb.columns.items():
        v[n:] = (True if v.dtype == torch.bool else 77)
    j = jax.jit(lambda b: jkern.scalar_aggregate(b, aggs))(jb)
    t = tkern.scalar_aggregate(tb, aggs)
    assert sorted(t) == sorted(j)
    for k in aggs:
        got, want = t[k].numpy(), np.asarray(j[k])
        if k in ("sf", "mf"):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        else:
            assert got.tolist() == want.tolist(), k


def _dec(mod, lib):
    """A user Decomposable: (count, sum of f, max of i) -> a dict."""
    return mod(lambda c: (lib.ones_like(c["i"]), c["f"], c["i"]),
               lambda a, b: (a[0] + b[0], a[1] + b[1],
                             lib.maximum(a[2], b[2])),
               lambda s: {"n": s[0], "mean": s[1] / s[0], "hi": s[2]})


def test_aggregate_matches_jax(devices8):
    """``aggregate`` runs the decomposable protocol over one global
    group: the same count and max, the mean within the f32 bound."""
    import jax.numpy as jnp
    cols = _data(900, seed=4)
    t = TContext(device="cpu", nparts=P).from_columns(cols).aggregate(
        _dec(TDecomposable, torch))
    j = JContext().from_columns(cols).aggregate(_dec(JDecomposable, jnp))
    assert sorted(t) == sorted(j) == ["hi", "mean", "n"]
    assert int(t["n"]) == int(j["n"]) == 900
    assert int(t["hi"]) == int(j["hi"]) == int(cols["i"].max())
    want = cols["f"].astype(np.float64).mean()
    bound = 16 * EPS * np.abs(cols["f"].astype(np.float64)).sum() / 900
    assert abs(float(t["mean"]) - want) <= bound
    assert abs(float(j["mean"]) - want) <= bound
