"""The port's group aggregation (dryad_tpu_torch/ops/kernels.py) in its
three lowerings — boundary-carry (the prefix_sum / prefix_sum2 kernels),
segmented scan, small-key one-hot product — against the JAX package's
ops/kernels.py on the same inputs, plus the packed-word transport both
exchanges use.

Tolerances: keys, counts, integer sums, min/max, any/all and the group
count match exactly (groups compared as sets).  Integer means agree to
f32 rounding of the same quotient.  An f32 group sum is within
16 x 2**-24 x sum_group |v| + 16 x 2**-48 x P of the float64 group sum
(P = sum |v| over the batch; the small-key product sums in another order:
64 x 2**-24 x sum_group |v|); a mean within that bound / count; port and
JAX within twice the bound of each other."""

import numpy as np
import pytest
import torch

import jax

from dryad_tpu.data import columnar as jcol
from dryad_tpu.ops import kernels as jkern
from dryad_tpu_torch.data import columnar as tcol
from dryad_tpu_torch.ops import kernels as tkern
from tests.torch_threads import one_torch_thread  # noqa: F401

N, CAP = 3_000, 3_200
EPS = 2.0**-24


def _cols(key_kind, rng):
    if key_kind == "str":
        vocab = [b"w%d" % i for i in range(300)] + [b"", b"\x00x"]
        k = [vocab[i] for i in rng.randint(0, len(vocab), N)]
    elif key_kind == "f32":
        k = rng.randint(-40, 40, N).astype(np.float32) / 4
        k[::13] = -0.0
    else:
        k = rng.randint(-500, 500, N).astype(np.int32)
    return {"k": k,
            "v": rng.randint(-2**31, 2**31 - 1, N).astype(np.int32),
            "m": rng.randint(-1000, 1000, N).astype(np.int32),
            "f": rng.rand(N) < 0.3}


AGGS = {"n": ("count", None), "s": ("sum", "v"), "mu": ("mean", "m"),
        "lo": ("min", "m"), "hi": ("max", "m"), "a": ("any", "f"),
        "al": ("all", "f")}


def _table(batch, keys):
    c = int(batch.count)
    out = {}
    cols = {}
    for name, v in batch.columns.items():
        if hasattr(v, "lengths"):
            d, l = np.asarray(v.data)[:c], np.asarray(v.lengths)[:c]
            cols[name] = [bytes(d[i, :l[i]]) for i in range(c)]
        else:
            cols[name] = np.asarray(v)[:c].tolist()
    for i in range(c):
        key = tuple(cols[k][i] for k in keys)
        assert key not in out
        out[key] = {n: cols[n][i] for n in cols if n not in keys}
    return out


@pytest.mark.parametrize("key_kind", ["str", "i32", "f32"])
def test_group_aggregate_matches_jax(key_kind):
    rng = np.random.RandomState(11)
    cols = _cols(key_kind, rng)
    aggs = dict(AGGS)
    jb = jcol.batch_from_numpy(cols, capacity=CAP, str_max_len=8)
    tb = tcol.batch_from_numpy(cols, capacity=CAP, str_max_len=8,
                               device="cpu")
    ok, mm = jkern._boundary_eligible(jb, aggs)
    assert ok and mm == "m"
    jout = jax.jit(lambda b: jkern._group_aggregate_boundary(
        b, ["k"], aggs, mm))(jb)
    tout = tkern.group_aggregate(tb, ["k"], aggs)
    jt, tt = _table(jout, ["k"]), _table(tout, ["k"])
    assert tt.keys() == jt.keys()
    for key in jt:
        for name in ("n", "s", "lo", "hi", "a", "al"):
            assert tt[key][name] == jt[key][name], (key, name)
        assert np.float32(tt[key]["mu"]) == np.float32(jt[key]["mu"])


def test_group_count_only_string_key_matches_jax():
    """WordCount's final merge: string key, sum of int32 partial counts."""
    rng = np.random.RandomState(12)
    words = [b"tok%d" % i for i in rng.randint(0, 700, N)]
    cols = {"line": words, "n": rng.randint(1, 50, N).astype(np.int32)}
    aggs = {"n": ("sum", "n")}
    jb = jcol.batch_from_numpy(cols, capacity=CAP, str_max_len=24)
    tb = tcol.batch_from_numpy(cols, capacity=CAP, str_max_len=24,
                               device="cpu")
    jout = jax.jit(lambda b: jkern.group_aggregate(b, ["line"], aggs))(jb)
    tout = tkern.group_aggregate(tb, ["line"], aggs)
    assert _table(tout, ["line"]) == _table(jout, ["line"])


def test_pack_unpack_roundtrip_and_jax_layout():
    """Packed words: the string bytes' little-endian words are the JAX
    package's, and every column survives the round trip bit for bit."""
    rng = np.random.RandomState(4)
    n = 64
    cols = {"s": [bytes(rng.randint(1, 256, int(rng.randint(0, 11)))
                        .astype(np.uint8)) for _ in range(n)],
            "i": rng.randint(-2**31, 2**31 - 1, n).astype(np.int32),
            "f": rng.randn(n).astype(np.float32),
            "h": rng.randn(n).astype(np.float16),
            "b": rng.rand(n) < 0.5,
            "i8": rng.randint(-128, 128, n).astype(np.int8),
            "v2": rng.randint(0, 9, (n, 3)).astype(np.int32)}
    tb = tcol.batch_from_numpy(cols, str_max_len=10, device="cpu")
    jb = jcol.batch_from_numpy(cols, str_max_len=10)
    words, spec = tkern._pack_columns_u32(tb.columns)
    jlanes, _ = jkern._pack_columns_u32(dict(jb.columns))
    jwords = np.stack([np.asarray(l) for l in jlanes], axis=1)
    np.testing.assert_array_equal(words.numpy().view(np.uint32), jwords)
    back = tkern._unpack_columns_u32(words, spec)
    for k, v in tb.columns.items():
        if hasattr(v, "lengths"):
            assert torch.equal(back[k].data, v.data)
            assert torch.equal(back[k].lengths, v.lengths)
        else:
            assert back[k].dtype == v.dtype
            assert torch.equal(back[k], v)     # no NaNs in these inputs


# ---------------------------------------------------------------------------
# f32 sums and means, the three lowerings


def _rows(batch, keys):
    """key tuple -> {column: value} over the valid groups (numpy)."""
    c = int(batch.count)
    cols = {}
    for name, v in batch.columns.items():
        if hasattr(v, "lengths"):
            d, l = np.asarray(v.data)[:c], np.asarray(v.lengths)[:c]
            cols[name] = [bytes(d[i, :l[i]]) for i in range(c)]
        else:
            cols[name] = np.asarray(v)[:c]
    out = {}
    for i in range(c):
        key = tuple(cols[k][i] if isinstance(cols[k], list)
                    else cols[k][i].item() for k in keys)
        assert key not in out
        out[key] = {n: cols[n][i] for n in cols if n not in keys}
    return out


def _oracle(cols, keys, vname, n):
    """key tuple -> (float64 sum, sum |v|, count) over the first n rows."""
    acc = {}
    v = np.asarray(cols[vname])[:n].astype(np.float64)
    for i in range(n):
        key = tuple(cols[k][i] if isinstance(cols[k], list)
                    else np.asarray(cols[k])[i].item() for k in keys)
        s, a, c = acc.get(key, (0.0, 0.0, 0))
        acc[key] = (s + v[i], a + np.abs(v[i]), c + 1)
    return acc


def _check_f32(tout, jout, cols, keys, aggs, n, c_eps=16):
    """Groups equal; every f32 sum/mean within the bound of the oracle,
    port and JAX within twice it; everything else exact."""
    tt, jt = _rows(tout, keys), _rows(jout, keys)
    assert tt.keys() == jt.keys()
    for out, (kind, vname) in aggs.items():
        if kind not in ("sum", "mean") or \
                np.asarray(cols[vname]).dtype != np.float32:
            for key in jt:
                np.testing.assert_array_equal(tt[key][out], jt[key][out])
            continue
        orc = _oracle(cols, keys, vname, n)
        assert set(orc) == set(tt)
        P = np.abs(np.asarray(cols[vname])[:n].astype(np.float64)).sum()
        for key, (s, a, c) in orc.items():
            bound = c_eps * EPS * a + 16 * 2.0**-48 * P
            want = s
            if kind == "mean":
                bound, want = bound / c, s / c
            got, jgot = float(tt[key][out]), float(jt[key][out])
            assert abs(got - want) <= bound, (key, out, got, want, bound)
            assert abs(jgot - want) <= bound, (key, out, jgot, want, bound)
            assert abs(got - jgot) <= 2 * bound


def _f32_cols(key_kind, rng):
    cols = _cols(key_kind, rng)
    w = (rng.randn(N) * 10).astype(np.float32)
    w[rng.randint(0, N, 20)] = 3e7        # a large prefix before small groups
    cols["w"] = w
    return cols


F32_AGGS = {"n": ("count", None), "s": ("sum", "w"), "mu": ("mean", "w"),
            "lo": ("min", "w"), "hi": ("max", "w"), "si": ("sum", "v")}


@pytest.mark.parametrize("key_kind", ["str", "i32", "f32"])
def test_group_f32_sums_and_means_match_jax(key_kind):
    """The boundary path's f32 branch: prefix_sum2, both lanes
    differenced, the min/max column rebuilt from its order lane."""
    rng = np.random.RandomState(21)
    cols = _f32_cols(key_kind, rng)
    n = N - 37
    jb = jcol.batch_from_numpy(cols, capacity=CAP, str_max_len=8)
    jb = jb.with_count(n)
    tb = tcol.batch_from_numpy(cols, capacity=CAP, str_max_len=8,
                               device="cpu")
    tb = tcol.Batch(tb.columns, torch.tensor(n, dtype=torch.int32))
    assert jkern._boundary_eligible(jb, F32_AGGS) == (True, "w")
    jout = jax.jit(lambda b: jkern.group_aggregate(b, ["k"], F32_AGGS))(jb)
    tout = tkern.group_aggregate(tb, ["k"], F32_AGGS)
    _check_f32(tout, jout, cols, ["k"], F32_AGGS, n)


# the inputs of the three lowerings the port used to refuse: the small-key
# product (int key, count), f32 sums over a string key (prefix_sum2), and
# the segmented scan (two min/max columns; the string min/max of the old
# case is refused by the JAX package itself)
REFUSED = [(["k"], {"n": ("count", None)}),
           (["k2"], {"s": ("sum", "x")}),
           (["x"], {"lo": ("min", "k"), "hi": ("max", "x")})]


@pytest.mark.parametrize("keys,aggs", REFUSED)
def test_formerly_unported_lowerings_match_jax(keys, aggs):
    cols = {"k": np.arange(10, dtype=np.int32),
            "x": np.ones(10, np.float32), "k2": [b"a"] * 10}
    jout = jkern.group_aggregate(jcol.batch_from_numpy(cols), keys, aggs)
    tout = tkern.group_aggregate(
        tcol.batch_from_numpy(cols, device="cpu"), keys, aggs)
    assert _table(tout, keys) == _table(jout, keys)


def _scan_cols(key_kind, rng):
    cols = _cols(key_kind, rng)
    cols["x2"] = (rng.randn(N, 3) * 5).astype(np.float32)
    cols["b"] = rng.randint(-2**40, 2**40, N).astype(np.int64)
    cols["w"] = rng.randn(N).astype(np.float32)
    return cols


SCAN_AGGS = {"n": ("count", None), "lo": ("min", "m"), "hi": ("max", "w"),
             "sx": ("sum", "x2"), "mx": ("mean", "x2"), "sb": ("sum", "b"),
             "mb": ("mean", "b"), "a": ("any", "f"), "al": ("all", "f")}


@pytest.mark.parametrize("key_kind", ["str", "i32", "f32"])
def test_group_scan_lowering_matches_jax(key_kind):
    """Two min/max columns, a 2-D f32 value column and int64 sums take
    the segmented scan in both packages.  (JAX runs without x64 here, so
    the int64 sums are held against a numpy oracle instead.)"""
    rng = np.random.RandomState(22)
    cols = _scan_cols(key_kind, rng)
    n = N - 5
    jaggs = {k: v for k, v in SCAN_AGGS.items() if v[1] != "b"}
    jb = jcol.batch_from_numpy({k: v for k, v in cols.items() if k != "b"},
                               capacity=CAP, str_max_len=8).with_count(n)
    tb = tcol.batch_from_numpy(cols, capacity=CAP, str_max_len=8,
                               device="cpu")
    tb = tcol.Batch(tb.columns, torch.tensor(n, dtype=torch.int32))
    assert not jkern._boundary_eligible(jb, jaggs)[0]
    assert not tkern._boundary_eligible(tb, SCAN_AGGS)[0]
    jout = jax.jit(lambda b: jkern.group_aggregate(b, ["k"], jaggs))(jb)
    tout = tkern.group_aggregate(tb, ["k"], SCAN_AGGS)
    tt, jt = _rows(tout, ["k"]), _rows(jout, ["k"])
    assert tt.keys() == jt.keys()
    for key in jt:
        for name in ("n", "lo", "hi", "a", "al"):
            np.testing.assert_array_equal(tt[key][name], jt[key][name])
    bsum = {}
    for i in range(n):
        key = (cols["k"][i] if key_kind == "str" else cols["k"][i].item(),)
        bsum[key] = bsum.get(key, 0) + int(cols["b"][i])
    for key, want in bsum.items():
        assert int(tt[key]["sb"]) == want
        cnt = int(tt[key]["n"])
        assert np.float32(tt[key]["mb"]) == np.float32(
            np.float32(want) / np.float32(cnt))
    for j in range(3):
        one = dict(cols, x2=np.ascontiguousarray(cols["x2"][:, j]))
        for key, (s, a, c) in _oracle(one, ["k"], "x2", n).items():
            bound = 16 * EPS * a
            for t in (tt, jt):
                assert abs(float(t[key]["sx"][j]) - s) <= bound
                assert abs(float(t[key]["mx"][j]) - s / c) <= bound / c


def test_group_nan_minmax_follows_each_lowering():
    """The JAX package's pinned NaN divergence, matched side by side: the
    boundary path ranks by total order (+NaN only as max, -NaN only as
    min), the scan path propagates NaN to both extremes."""
    kcol = np.repeat(np.arange(4, dtype=np.int32), 4)
    v = np.array([1., 2., 3., 4., 5., np.nan, 7., 8.,
                  9., -np.nan, 11., 12., 13., 14., 15., 16.], np.float32)
    cols = {"k": kcol, "v": v}
    aggs = {"lo": ("min", "v"), "hi": ("max", "v")}
    jb = jcol.batch_from_numpy(cols)
    tb = tcol.batch_from_numpy(cols, device="cpu")
    for jfn, tfn in (
            (lambda b: jkern._group_aggregate_boundary(b, ["k"], aggs, "v"),
             lambda b: tkern._group_aggregate_boundary(b, ["k"], aggs, "v")),
            (lambda b: jkern._group_aggregate_scan(b, ["k"], aggs),
             lambda b: tkern._group_aggregate_scan(b, ["k"], aggs))):
        jt, tt = _rows(jfn(jb), ["k"]), _rows(tfn(tb), ["k"])
        assert tt.keys() == jt.keys() == {(0,), (1,), (2,), (3,)}
        for key in jt:
            for name in ("lo", "hi"):
                a, b = tt[key][name], jt[key][name]
                assert (np.isnan(a) and np.isnan(b)) or a == b, (key, name)
    tt = _rows(tkern.group_aggregate(tb, ["k"], aggs), ["k"])
    assert tt[(1,)]["lo"] == 5 and np.isnan(tt[(1,)]["hi"])
    st = _rows(tkern._group_aggregate_scan(tb, ["k"], aggs), ["k"])
    assert np.isnan(st[(1,)]["lo"]) and np.isnan(st[(2,)]["hi"])


SMALL_AGGS = {"n": ("count", None), "m": ("mean", "x"), "s": ("sum", "w")}


@pytest.mark.parametrize("span", ["small", "wide", "near_overflow"])
def test_smallkey_matches_jax(span):
    """Span <= 512 takes the one-hot product in both packages; wider
    spans (and the i32-wrapping one) fall back to the sort lowering."""
    rng = np.random.RandomState(5)
    n = 3_000
    keys = {"small": rng.randint(-40, 77, n),
            "wide": rng.randint(-2**30, 2**30, n),
            "near_overflow": np.full(n, 2**31 - 5)}[span].astype(np.int32)
    cols = {"k": keys, "x": rng.rand(n, 4).astype(np.float32),
            "w": rng.randn(n).astype(np.float32)}
    jb = jcol.batch_from_numpy(cols).with_count(n - 11)
    tb = tcol.batch_from_numpy(cols, device="cpu")
    tb = tcol.Batch(tb.columns, torch.tensor(n - 11, dtype=torch.int32))
    assert jkern._matmul_group_eligible(jb, ["k"], SMALL_AGGS)
    assert tkern._matmul_group_eligible(tb, ["k"], SMALL_AGGS)
    jout = jkern.group_aggregate(jb, ["k"], SMALL_AGGS)
    tout = tkern.group_aggregate(tb, ["k"], SMALL_AGGS)
    c_eps = 64 if span == "small" else 16
    _check_f32(tout, jout, cols, ["k"], {"n": SMALL_AGGS["n"],
                                         "s": SMALL_AGGS["s"]},
               n - 11, c_eps=c_eps)
    tt, jt = _rows(tout, ["k"]), _rows(jout, ["k"])
    for key in jt:
        np.testing.assert_allclose(tt[key]["m"], jt[key]["m"], rtol=1e-5,
                                   atol=1e-6)


def test_smallkey_empty_single_and_nan_padding():
    aggs = {"n": ("count", None), "s": ("sum", "v")}
    empty = tcol.Batch({"k": torch.zeros(64, dtype=torch.int32),
                        "v": torch.ones(64)}, torch.tensor(0))
    assert int(tkern.group_aggregate(empty, ["k"], aggs).count) == 0
    one = tcol.Batch({"k": torch.full((64,), 7, dtype=torch.int32),
                      "v": torch.ones(64)}, torch.tensor(5))
    o1 = tkern.group_aggregate(one, ["k"], aggs)
    assert int(o1.count) == 1
    assert (int(o1.columns["k"][0]), int(o1.columns["n"][0]),
            float(o1.columns["s"][0])) == (7, 5, 5.0)
    v = torch.full((64,), float("nan"))
    v[:5] = torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0])
    nan = tcol.Batch({"k": torch.full((64,), 9, dtype=torch.int32), "v": v},
                     torch.tensor(5))
    out = tkern.group_aggregate(nan, ["k"], {"s": ("sum", "v")})
    assert int(out.count) == 1 and float(out.columns["s"][0]) == 15.0


def test_smallkey_product_stays_full_f32():
    """A caller's lower matmul precision neither reaches the product nor
    survives it."""
    rng = np.random.RandomState(6)
    n = 5_000
    k = rng.randint(0, 100, n).astype(np.int32)
    v = (1 + rng.rand(n) * 2.0**-12).astype(np.float32)   # low bits matter
    tb = tcol.batch_from_numpy({"k": k, "v": v}, device="cpu")
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        out = tkern.group_aggregate(tb, ["k"], {"s": ("sum", "v")})
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(prev)
    want = np.bincount(k, weights=v.astype(np.float64), minlength=100)
    absw = np.bincount(k, weights=np.abs(v.astype(np.float64)),
                       minlength=100)
    got = dict(zip(out.columns["k"][:100].tolist(),
                   out.columns["s"][:100].tolist()))
    for key, s in got.items():
        assert abs(s - want[key]) <= 64 * EPS * absw[key]


@pytest.mark.parametrize("dtype", [torch.int8, torch.int16, torch.uint8])
def test_smallkey_gate_takes_narrow_int_keys(dtype, monkeypatch):
    """The span check runs in int64: narrow key dtypes with a small span
    take the product (the sort fallback is made to fail here)."""
    def no_sort(*a, **k):
        raise AssertionError("took the sort fallback")

    monkeypatch.setattr(tkern, "_group_aggregate_boundary", no_sort)
    k = torch.tensor([-3, 5, 100, 5, 7], dtype=torch.int64).to(dtype)
    b = tcol.Batch({"k": k, "v": torch.arange(5.0)}, torch.tensor(5))
    out = tkern.group_aggregate(b, ["k"], {"n": ("count", None),
                                           "s": ("sum", "v")})
    got = {int(kk): (int(n), float(s)) for kk, n, s in zip(
        out.columns["k"][:4], out.columns["n"][:4], out.columns["s"][:4])}
    want = {}
    for i, kk in enumerate(k.tolist()):
        n, s = want.get(kk, (0, 0.0))
        want[kk] = (n + 1, s + i)
    assert int(out.count) == 4 and got == want
