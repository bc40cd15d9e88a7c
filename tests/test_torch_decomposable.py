"""User-defined decomposable aggregation and the row-local operators of
the port (dryad_tpu_torch/ops/kernels.py, ops/scan.py) against the JAX
package's ops/kernels.py on the same inputs.

A Decomposable is written twice, in jnp and in torch: its state is a
(sum, count, min, max) tuple and its finalize returns a dict of columns.
Tolerances: keys, counts, min/max, compaction and the group count match
exactly; an f32 sum within 16 x 2**-24 x sum_group |v| of the float64
group sum (the two packages' segmented scans add in different trees), a
mean within that bound / count."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dryad_tpu.data import columnar as jcol
from dryad_tpu.ops import kernels as jkern
from dryad_tpu.plan.expr import Decomposable as JDec
from dryad_tpu_torch.data import columnar as tcol
from dryad_tpu_torch.ops import kernels as tkern
from dryad_tpu_torch.ops.scan import associative_scan
from dryad_tpu_torch.plan.expr import Decomposable as TDec

EPS = 2.0**-24
N, CAP = 2_000, 2_100


def _jstats():
    return JDec(
        lambda c: (c["v"], jnp.ones(c["v"].shape[0], jnp.int32), c["v"],
                   c["v"]),
        lambda a, b: (a[0] + b[0], a[1] + b[1], jnp.minimum(a[2], b[2]),
                      jnp.maximum(a[3], b[3])),
        lambda s: {"s": s[0], "n": s[1], "mu": s[0] / s[1], "lo": s[2],
                   "hi": s[3]})


def _tstats():
    return TDec(
        lambda c: (c["v"], torch.ones(c["v"].shape[0], dtype=torch.int32),
                   c["v"], c["v"]),
        lambda a, b: (a[0] + b[0], a[1] + b[1], torch.minimum(a[2], b[2]),
                      torch.maximum(a[3], b[3])),
        lambda s: {"s": s[0], "n": s[1], "mu": s[0] / s[1], "lo": s[2],
                   "hi": s[3]})


def _cols(seed, n=N, key_kind="str"):
    rng = np.random.RandomState(seed)
    if key_kind == "str":
        vocab = [b"g%d" % i for i in range(150)]
        k = [vocab[i] for i in rng.randint(0, len(vocab), n)]
    else:
        k = rng.randint(-300, 300, n).astype(np.int32)
    return {"k": k, "v": (rng.randn(n) * 3).astype(np.float32)}


def _pair(cols, n_valid, cap=CAP):
    jb = jcol.batch_from_numpy(cols, capacity=cap, str_max_len=8) \
        .with_count(n_valid)
    tb = tcol.batch_from_numpy(cols, capacity=cap, str_max_len=8,
                               device="cpu")
    return jb, tcol.Batch(tb.columns, torch.tensor(n_valid,
                                                   dtype=torch.int32))


def _rows(batch):
    c = int(batch.count)
    cols = {}
    for name, v in batch.columns.items():
        if hasattr(v, "lengths"):
            d, l = np.asarray(v.data)[:c], np.asarray(v.lengths)[:c]
            cols[name] = [bytes(d[i, :l[i]]) for i in range(c)]
        else:
            cols[name] = np.asarray(v)[:c].tolist()
    return {cols["k"][i]: {n: cols[n][i] for n in cols if n != "k"}
            for i in range(c)}


def _oracle(cols, n):
    out = {}
    k = cols["k"]
    for i in range(n):
        key = k[i] if isinstance(k, list) else int(k[i])
        v = float(cols["v"][i])
        s, a, c, lo, hi = out.get(key, (0.0, 0.0, 0, np.inf, -np.inf))
        out[key] = (s + v, a + abs(v), c + 1, min(lo, v), max(hi, v))
    return out


def _check_final(rows, orc):
    assert set(rows) == set(orc)
    for key, (s, a, c, lo, hi) in orc.items():
        r = rows[key]
        assert (r["n"], r["lo"], r["hi"]) == (c, np.float32(lo),
                                              np.float32(hi))
        assert abs(r["s"] - s) <= 16 * EPS * a
        assert abs(r["mu"] - s / c) <= 16 * EPS * a / c


@pytest.mark.parametrize("key_kind", ["str", "i32"])
def test_decompose_local_matches_jax_and_oracle(key_kind):
    cols = _cols(1, key_kind=key_kind)
    jb, tb = _pair(cols, N - 9)
    jout = jax.jit(lambda b: jkern.group_decompose_local(
        b, ["k"], {"d": _jstats()}, {}))(jb)
    box = {}
    tout = tkern.group_decompose_local(tb, ["k"], {"d": _tstats()}, box)
    assert set(tout.columns) == {"k", "s", "n", "mu", "lo", "hi"}
    assert box["d"].num_leaves == 4
    orc = _oracle(cols, N - 9)
    _check_final(_rows(tout), orc)
    _check_final(_rows(jout), orc)


def test_decompose_partial_then_merge_across_packages():
    """Partials of two batches from each package; the valid partial rows
    concatenated (the exchange) and merged by the port and by JAX — the
    port's merge also takes the JAX package's partial states."""
    a, b = _cols(2), _cols(3)
    jbox, tbox = {}, {}
    jparts, tparts = [], []
    for cols, n in ((a, N - 1), (b, N - 400)):
        jb, tb = _pair(cols, n)
        jparts.append(jax.jit(lambda b: jkern.group_decompose_partial(
            b, ["k"], {"d": _jstats()}, jbox))(jb))
        tparts.append(tkern.group_decompose_partial(
            tb, ["k"], {"d": _tstats()}, tbox))
    # the partial states agree group by group
    for jp, tp in zip(jparts, tparts):
        jr, tr = _rows(jp), _rows(tp)
        assert jr.keys() == tr.keys()
        for key in jr:
            assert [tr[key][f"d@{i}"] for i in (1, 2, 3)] == \
                [jr[key][f"d@{i}"] for i in (1, 2, 3)]
            assert abs(tr[key]["d@0"] - jr[key]["d@0"]) <= 1e-4

    def concat(parts):
        rows = [_rows(p) for p in parts]
        keys = [k for r in rows for k in r]
        out = {"k": keys}
        for i in range(4):
            out[f"d@{i}"] = np.asarray([r[k][f"d@{i}"] for r in rows
                                        for k in r],
                                       np.int32 if i == 1 else np.float32)
        return out, len(keys)

    merged_in, m = concat(jparts)
    jb, tb = _pair(merged_in, m, cap=m + 7)
    jout = jax.jit(lambda b: jkern.group_decompose_merge(
        b, ["k"], {"d": _jstats()}, jbox, True))(jb)
    tout = tkern.group_decompose_merge(tb, ["k"], {"d": _tstats()}, tbox,
                                       True)
    orc = _oracle({"k": a["k"][:N - 1] + b["k"][:N - 400],
                   "v": np.concatenate([a["v"][:N - 1], b["v"][:N - 400]])},
                  2 * N - 401)
    _check_final(_rows(tout), orc)
    _check_final(_rows(jout), orc)
    # and merging without finalize keeps the state columns
    keep = tkern.group_decompose_merge(tb, ["k"], {"d": _tstats()}, tbox,
                                       False)
    assert set(keep.columns) == {"k", "d@0", "d@1", "d@2", "d@3"}


def test_builtin_specs_resolve_in_torch():
    cols = _cols(4, key_kind="i32")
    jb, tb = _pair(cols, N)
    decs = {"n": ("__builtin__", "count", None),
            "s": ("__builtin__", "sum", "v"),
            "m": ("__builtin__", "mean", "v"),
            "lo": ("__builtin__", "min", "v"),
            "hi": ("__builtin__", "max", "v")}
    jr = _rows(jax.jit(lambda b: jkern.group_decompose_local(
        b, ["k"], decs, {}))(jb))
    tr = _rows(tkern.group_decompose_local(tb, ["k"], decs, {}))
    assert jr.keys() == tr.keys()
    for key in jr:
        for c in ("n", "lo", "hi"):
            assert tr[key][c] == jr[key][c]
        np.testing.assert_allclose([tr[key]["s"], tr[key]["m"]],
                                   [jr[key]["s"], jr[key]["m"]],
                                   rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n_valid", [0, 1, 777, N])
def test_compact_matches_jax(n_valid):
    rng = np.random.RandomState(n_valid)
    cols = {"k": _cols(5)["k"], "v": rng.randn(N).astype(np.float32),
            "x": rng.randint(0, 9, (N, 3)).astype(np.int32)}
    keep = rng.rand(CAP) < 0.4
    jb, tb = _pair(cols, n_valid)
    jout = jkern.compact(jb, jnp.asarray(keep))
    tout = tkern.compact(tb, torch.from_numpy(keep))
    c = int(jout.count)
    assert int(tout.count) == c == int(keep[:n_valid].sum())
    np.testing.assert_array_equal(tout.columns["v"][:c].numpy(),
                                  np.asarray(jout.columns["v"])[:c])
    np.testing.assert_array_equal(tout.columns["x"][:c].numpy(),
                                  np.asarray(jout.columns["x"])[:c])
    tk = tout.columns["k"]
    jk = jout.columns["k"]
    np.testing.assert_array_equal(tk.lengths[:c].numpy(),
                                  np.asarray(jk.lengths)[:c])
    np.testing.assert_array_equal(tk.data[:c].numpy(),
                                  np.asarray(jk.data)[:c])
    # stable keep-first order
    idx = np.flatnonzero(keep[:n_valid])
    np.testing.assert_array_equal(tout.columns["v"][:c].numpy(),
                                  cols["v"][idx])


def test_filter_rows_and_permute_by_sort():
    cols = _cols(6, key_kind="i32")
    jb, tb = _pair(cols, N - 3)
    jout = jkern.filter_rows(jb, lambda c: c["v"] > 0.5)
    tout = tkern.filter_rows(tb, lambda c: c["v"] > 0.5)
    c = int(jout.count)
    assert int(tout.count) == c
    np.testing.assert_array_equal(tout.columns["k"][:c].numpy(),
                                  np.asarray(jout.columns["k"])[:c])
    lane = (torch.from_numpy(cols["k"].astype(np.int64)) & 0xFFFFFFFF) \
        ^ 0x80000000
    lane = torch.cat([lane, torch.full((CAP - N,), 0xFFFFFFFF)])
    srt = tkern.permute_by_sort(tb, [lane])
    ks = srt.columns["k"].numpy()
    np.testing.assert_array_equal(ks[:N], np.sort(cols["k"], kind="stable"))


def test_associative_scan_and_segmented_reduces():
    rng = np.random.RandomState(7)
    for n in (0, 1, 2, 5, 1000, 1025):
        x = torch.from_numpy(rng.randint(-50, 50, n).astype(np.int64))
        got = associative_scan(lambda a, b: a + b, x)
        assert torch.equal(got, torch.cumsum(x, 0))
    n = 777
    v = torch.from_numpy(rng.randint(-1000, 1000, n).astype(np.int32))
    starts = rng.rand(n) < 0.1
    starts[0] = True
    seg = np.cumsum(starts) - 1
    fwd = tkern._seg_scan_reduce(v, torch.from_numpy(starts), torch.maximum)
    ends = np.append(starts[1:], True)
    bwd = tkern._seg_scan_reduce(v, torch.from_numpy(ends), torch.minimum,
                                 reverse=True)
    jf = jax.jit(lambda x, f: jkern._seg_scan_reduce(x, f, jnp.maximum))(
        v.numpy(), starts)
    jbk = jax.jit(lambda x, f: jkern._seg_scan_reduce(
        x, f, jnp.minimum, reverse=True))(v.numpy(), ends)
    np.testing.assert_array_equal(fwd.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(bwd.numpy(), np.asarray(jbk))
    vn = v.numpy()
    for s in range(seg[-1] + 1):
        rows = np.flatnonzero(seg == s)
        assert fwd[rows[-1]] == vn[rows].max()
        assert bwd[rows[0]] == vn[rows].min()
    multi = tkern._seg_scan_multi([(v, torch.add), (v.float(),
                                                    torch.maximum)],
                                  torch.from_numpy(starts))
    jm = jax.jit(lambda x, f: jkern._seg_scan_multi(
        [(x, jnp.add), (x.astype(jnp.float32), jnp.maximum)], f))(vn, starts)
    for t, j in zip(multi, jm):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_jax_partial_states_carry_into_the_port_exchange_and_merge():
    """A JAX partial (key + state columns ``d@i``) of two partitions,
    carried as numpy state into a port PData (``pdata_from_numpy``),
    hash-exchanged by the port and merged + finalized there."""
    from dryad_tpu_torch.exec.data import pdata_from_numpy, split_partitions
    from dryad_tpu_torch.parallel.shuffle import hash_exchange

    parts = [_cols(8, key_kind="i32"), _cols(9, key_kind="i32")]
    jbox, tbox = {}, {}
    jp = [jax.jit(lambda b: jkern.group_decompose_partial(
        b, ["k"], {"d": _jstats()}, jbox))(_pair(c, N)[0]) for c in parts]
    # the port's partial of the same input fills its own state box
    tkern.group_decompose_partial(_pair(parts[0], N)[1], ["k"],
                                  {"d": _tstats()}, tbox)
    cols = {name: np.stack([np.asarray(p.columns[name]) for p in jp])
            for name in jp[0].columns}
    pd = pdata_from_numpy(cols, [int(p.count) for p in jp], "cpu")
    assert set(pd.batch.columns) == {"k", "d@0", "d@1", "d@2", "d@3"}
    moved, need_rows, need_slack, _ = hash_exchange(
        split_partitions(pd), ["k"], CAP)
    assert int(need_rows) == 0 and int(need_slack) == 0
    rows = {}
    for b in moved:
        rows.update(_rows(tkern.group_decompose_merge(
            b, ["k"], {"d": _tstats()}, tbox, True)))
    _check_final(rows, _oracle({"k": np.concatenate([c["k"] for c in parts]),
                                "v": np.concatenate([c["v"] for c in parts])},
                               2 * N))
