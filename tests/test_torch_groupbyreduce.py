"""The GroupByReduce slice end to end: the app through the port
(``dryad_tpu_torch``, device="cpu", nparts=8 — every kernel wrapper runs
its plain version) against the JAX app on the 8-device CPU mesh and
against a numpy oracle, at 20,000 rows and 300 keys.

Tolerances: keys, counts, min/max and the group count match exactly.
An f32 group sum is within 16 x 2**-24 x sum_group |v| + 16 x 2**-48 x P
of the float64 group sum (P = sum |v| over all rows, at least any
partition's), a mean within that bound / count; port and JAX within
twice the bound of each other."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dryad_tpu import Context as JContext
from dryad_tpu import Decomposable as JDec
from dryad_tpu.apps import groupbyreduce as jgbr
from dryad_tpu.plan.planner import plan_query
from dryad_tpu_torch import Context as TContext
from dryad_tpu_torch import Decomposable as TDec
from dryad_tpu_torch.apps import groupbyreduce as tgbr

N, KEYS = 20_000, 300
EPS = 2.0**-24


def _oracle(k, v):
    """Per key (as numpy arrays over 0..max key): count, float64 sum,
    sum |v|, min, max."""
    m = int(k.max()) + 1
    v64 = v.astype(np.float64)
    cnt = np.bincount(k, minlength=m)
    s = np.bincount(k, weights=v64, minlength=m)
    a = np.bincount(k, weights=np.abs(v64), minlength=m)
    lo = np.full(m, np.inf, np.float32)
    hi = np.full(m, -np.inf, np.float32)
    np.minimum.at(lo, k, v)
    np.maximum.at(hi, k, v)
    return cnt, s, a, lo, hi


def _check(out, k, v, jout=None):
    """The collected table against the oracle (and JAX's, if given)."""
    cnt, s, a, lo, hi = _oracle(k, v)
    keys = np.flatnonzero(cnt)
    o = np.argsort(out["k"])
    np.testing.assert_array_equal(out["k"][o], keys)
    np.testing.assert_array_equal(out["n"][o], cnt[keys])
    np.testing.assert_array_equal(out["lo"][o], lo[keys])
    np.testing.assert_array_equal(out["hi"][o], hi[keys])
    P = float(np.abs(v.astype(np.float64)).sum())
    bound = 16 * EPS * a[keys] + 16 * 2.0**-48 * P
    assert (np.abs(out["s"][o] - s[keys]) <= bound).all()
    assert (np.abs(out["m"][o] - s[keys] / cnt[keys])
            <= bound / cnt[keys]).all()
    if jout is not None:
        jo = np.argsort(jout["k"])
        np.testing.assert_array_equal(np.asarray(jout["k"])[jo], keys)
        for c in ("n", "lo", "hi"):
            np.testing.assert_array_equal(np.asarray(jout[c])[jo],
                                          out[c][o])
        assert (np.abs(np.asarray(jout["s"])[jo] - out["s"][o])
                <= 2 * bound).all()
        assert (np.abs(np.asarray(jout["m"])[jo] - out["m"][o])
                <= 2 * bound / cnt[keys]).all()


def test_groupbyreduce_matches_jax_and_oracle(devices8):
    jout = jgbr.groupbyreduce(JContext(), N, KEYS)
    tout = tgbr.groupbyreduce(TContext(device="cpu", nparts=8), N, KEYS)
    d = tgbr.gen_pairs(N, KEYS)
    jd = jgbr.gen_pairs(N, KEYS)
    np.testing.assert_array_equal(d["k"], jd["k"])
    np.testing.assert_array_equal(d["v"], jd["v"])
    _check(tout, d["k"], d["v"], jout)


def _jstats():
    return JDec(
        lambda c: (jnp.ones(c["v"].shape[0], jnp.int32), c["v"], c["v"],
                   c["v"]),
        lambda a, b: (a[0] + b[0], a[1] + b[1], jnp.minimum(a[2], b[2]),
                      jnp.maximum(a[3], b[3])),
        lambda s: {"n": s[0], "s": s[1], "m": s[1] / s[0], "lo": s[2],
                   "hi": s[3]})


def _tstats():
    return TDec(
        lambda c: (torch.ones(c["v"].shape[0], dtype=torch.int32,
                              device=c["v"].device), c["v"], c["v"],
                   c["v"]),
        lambda a, b: (a[0] + b[0], a[1] + b[1], torch.minimum(a[2], b[2]),
                      torch.maximum(a[3], b[3])),
        lambda s: {"n": s[0], "s": s[1], "m": s[1] / s[0], "lo": s[2],
                   "hi": s[3]})


@pytest.mark.parametrize("variant", ["builtin", "decomposable"])
def test_groupbyreduce_where_select_matches_jax(devices8, variant):
    """where + select in front of the group_by; the aggregates as the
    app's builtin kinds, or as one user Decomposable beside a builtin
    count (which then rides the decomposable path too)."""
    d = tgbr.gen_pairs(N, KEYS, seed=1)

    def query(ctx, dec, pkg):
        ds = ctx.from_columns(d).where(lambda c: c["v"] > -1.0)
        ds = ds.select(lambda c: {"k": c["k"] * 2, "v": c["v"] * 2})
        if variant == "builtin":
            return tgbr.groupbyreduce_query(ds) if pkg == "t" \
                else jgbr.groupbyreduce_query(ds)
        return ds.group_by(["k"], {"d": dec, "n2": ("count", None)})

    jq = query(JContext(), _jstats(), "j")
    tq = query(TContext(device="cpu", nparts=8), _tstats(), "t")
    assert tq.explain() == plan_query(jq.node, 8).explain()
    jout, tout = jq.collect(), tq.collect()
    keep = d["v"] > -1.0
    k, v = d["k"][keep] * 2, d["v"][keep] * 2
    _check(tout, k, v, jout)
    if variant == "decomposable":
        np.testing.assert_array_equal(tout["n2"], tout["n"])


def test_select_where_keep_rows_and_partitioning():
    """where keeps the valid rows in order within each partition; select
    replaces the columns."""
    d = tgbr.gen_pairs(1_000, 50, seed=2)
    ctx = TContext(device="cpu", nparts=8)
    out = (ctx.from_columns(d).where(lambda c: c["k"] % 3 == 0)
           .select(lambda c: {"k": c["k"], "w": c["v"] + 1}).collect())
    keep = d["k"] % 3 == 0
    assert set(out) == {"k", "w"}
    np.testing.assert_array_equal(out["k"], d["k"][keep])
    np.testing.assert_array_equal(out["w"], d["v"][keep] + 1)


@pytest.mark.parametrize("nparts", [1, 3])
def test_groupbyreduce_other_partition_counts(nparts):
    """One partition plans the group locally (and a Decomposable as
    dgroup_local); three hash to a non-power-of-two mesh."""
    d = tgbr.gen_pairs(3_000, 97, seed=3)
    ctx = TContext(device="cpu", nparts=nparts)
    _check(tgbr.groupbyreduce(ctx, 3_000, 97, seed=3), d["k"], d["v"])
    out = ctx.from_columns(d).group_by(["k"], {"d": _tstats()}).collect()
    _check(out, d["k"], d["v"])
