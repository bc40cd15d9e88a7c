"""The port's sort family (dryad_tpu_torch/ops/kernels.py sort lanes,
``sort_by_columns``, ``take``, ``distinct``, ``group_top_k``,
``group_rank_select``; the executor's sampled range bounds;
``parallel/shuffle.range_dest``) against the JAX package's functions on
the same numpy inputs.

The JAX lanes are uint32 and the port's int64 in [0, 2**32): every lane
is held bit for bit with the JAX output cast through ``np.uint32``.  The
JAX tests run without x64, so int64 columns arrive there as int32: the
port's int64 lanes and orders are held against numpy instead.
Tolerance: none anywhere; everything here is integer or moved bits."""

import collections

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dryad_tpu.data import columnar as jcol
from dryad_tpu.exec import executor as jexec
from dryad_tpu.exec.data import PData as JPData
from dryad_tpu.ops import kernels as jkern
from dryad_tpu.parallel import shuffle as jshuffle
from dryad_tpu.utils.config import JobConfig as JJobConfig
from dryad_tpu_torch import Context as TContext
from dryad_tpu_torch import JobConfig as TJobConfig
from dryad_tpu_torch.data import columnar as tcol
from dryad_tpu_torch.exec import executor as texec
from dryad_tpu_torch.exec.data import pdata_from_numpy
from dryad_tpu_torch.ops import kernels as tkern
from dryad_tpu_torch.parallel import shuffle as tshuffle

M32 = 0xFFFFFFFF
P = 8


def _u32(lanes):
    """JAX lanes -> one uint64 matrix [lanes, n] (exact)."""
    return np.stack([np.asarray(l).astype(np.uint32) for l in lanes]
                    ).astype(np.uint64)


def _i64(lanes):
    return np.stack([l.numpy() for l in lanes]).astype(np.uint64)


def _dense(dtype, rng, n=400):
    if dtype == "bool":
        return rng.rand(n) < 0.5
    if dtype == "float32":
        a = (rng.randn(n) * 100).astype(np.float32)
        a[:8] = [0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1e-3, -1e-3]
        return a
    info = np.iinfo(dtype)
    a = rng.randint(info.min, int(info.max) + 1, n, dtype=np.int64).astype(
        dtype)
    a[:2] = [info.min, info.max]
    return a


DENSE = ["int8", "int16", "int32", "uint32", "bool", "float32"]


@pytest.mark.parametrize("desc", [False, True])
@pytest.mark.parametrize("dtype", DENSE)
def test_dense_lanes_match_jax(dtype, desc):
    a = _dense(dtype, np.random.RandomState(1))
    got = tkern.sort_lanes_for(torch.from_numpy(a), desc)
    want = jkern.sort_lanes_for(jnp.asarray(a), desc)
    assert all(l.dtype == torch.int64 for l in got)
    np.testing.assert_array_equal(_i64(got), _u32(want))


def _lex_order(lanes):
    """Stable ascending lexicographic order of [lanes, n] uint64 lanes."""
    return np.lexsort(tuple(lanes[::-1]))


@pytest.mark.parametrize("desc", [False, True])
def test_int64_lanes_order_like_numpy(desc):
    """Two lanes, (hi ^ sign, lo); their order is the int64 order (JAX
    has no int64 without x64, so numpy is the reference)."""
    rng = np.random.RandomState(2)
    a = rng.randint(-2**62, 2**62, 500, dtype=np.int64)
    a[:6] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, -1, 0, 1,
             2**32]
    a[6:20] = a[20:34]                      # ties
    lanes = _i64(tkern.sort_lanes_for(torch.from_numpy(a), desc))
    assert lanes.shape[0] == 2 and lanes.max() <= M32
    hi = ((a >> 32) & M32).astype(np.uint64) ^ 0x80000000
    lo = (a & M32).astype(np.uint64)
    want = np.stack([hi, lo]) ^ (M32 if desc else 0)
    np.testing.assert_array_equal(lanes, want)
    rank = np.unique(a, return_inverse=True)[1]   # -a would overflow
    key = -rank if desc else rank
    np.testing.assert_array_equal(a[_lex_order(lanes)],
                                  a[np.argsort(key, kind="stable")])


def test_float64_orders_as_its_f32_cast():
    """Float keys go through an f32 cast: a float64 column gets the lane
    of its f32 value (the JAX package sees float64 as float32)."""
    rng = np.random.RandomState(3)
    a = rng.randn(300) * 1e3
    a[:3] = [np.nan, np.inf, -np.inf]
    got = tkern.sort_lanes_for(torch.from_numpy(a))
    want = jkern.sort_lanes_for(jnp.asarray(a.astype(np.float32)))
    np.testing.assert_array_equal(_i64(got), _u32(want))


def _strings(L, rng, n=300, garbage=True):
    """(data [n, L] u8, lengths [n] i32): lengths 0..L, the bytes past a
    row's length random garbage (unless ``garbage`` is False)."""
    lens = np.concatenate([np.arange(L + 1),
                           rng.randint(0, L + 1, n - L - 1)]).astype(np.int32)
    data = rng.randint(0, 256, (n, L)).astype(np.uint8)
    data[: n // 3] = data[n // 3: 2 * (n // 3)]       # shared prefixes
    if not garbage:
        data[np.arange(L)[None, :] >= lens[:, None]] = 0
    return data, lens


@pytest.mark.parametrize("desc", [False, True])
@pytest.mark.parametrize("L", [9, 10, 11, 12])
def test_string_lanes_match_jax(L, desc):
    """Big-endian 4-byte lanes, bytes past the length masked to 0, the
    length folded into the last lane when it has two spare bytes (L = 9:
    with one zero byte after it; L = 10: TeraSort's 3 lanes) and a lane
    of its own otherwise (L = 11, 12)."""
    data, lens = _strings(L, np.random.RandomState(L))
    got = tkern.sort_lanes_for(tcol.StringColumn(torch.from_numpy(data),
                                                 torch.from_numpy(lens)),
                               desc)
    want = jkern.sort_lanes_for(jcol.StringColumn(jnp.asarray(data),
                                                  jnp.asarray(lens)), desc)
    n_lanes = {9: 3, 10: 3, 11: 4, 12: 4}[L]
    assert len(got) == n_lanes == len(want)
    np.testing.assert_array_equal(_i64(got), _u32(want))
    # big-endian: the first lane of b"\x01\x02\x03\x04..." is 0x01020304
    row = np.flatnonzero(lens >= 4)[0]
    first = int.from_bytes(bytes(data[row, :4]), "big")
    assert int(got[0][row]) == (first ^ M32 if desc else first)


@pytest.mark.parametrize("desc", [False, True])
@pytest.mark.parametrize("dtype", DENSE)
def test_dense_invert_round_trips(dtype, desc):
    a = _dense(dtype, np.random.RandomState(4))
    t = torch.from_numpy(a)
    (lane,) = tkern.sort_lanes_for(t, desc)
    back = tkern._dense_lanes_invert(lane, t.dtype, desc)
    assert back.dtype == t.dtype
    np.testing.assert_array_equal(back.numpy().view(np.uint8),
                                  a.view(np.uint8))
    jback = jkern._dense_lanes_invert(
        [jnp.asarray(lane.numpy().astype(np.uint32))], jnp.asarray(a).dtype,
        desc)
    np.testing.assert_array_equal(np.asarray(jback).view(np.uint8),
                                  a.view(np.uint8))


@pytest.mark.parametrize("desc", [False, True])
@pytest.mark.parametrize("L", [9, 10, 11, 12])
def test_string_invert_round_trips(L, desc):
    """The inverse gives back the column with the bytes past each length
    zeroed (the forward lanes masked them), as the JAX inverse does."""
    data, lens = _strings(L, np.random.RandomState(20 + L))
    col = tcol.StringColumn(torch.from_numpy(data), torch.from_numpy(lens))
    back = tkern._string_lanes_invert(tkern.sort_lanes_for(col, desc), L,
                                      desc)
    canon = data.copy()
    canon[np.arange(L)[None, :] >= lens[:, None]] = 0
    np.testing.assert_array_equal(back.data.numpy(), canon)
    np.testing.assert_array_equal(back.lengths.numpy(), lens)
    assert back.data.dtype == torch.uint8 and back.lengths.dtype == \
        torch.int32
    jback = jkern._string_lanes_invert(
        [jnp.asarray(l.numpy().astype(np.uint32))
         for l in tkern.sort_lanes_for(col, desc)], L, desc)
    np.testing.assert_array_equal(np.asarray(jback.data), canon)
    np.testing.assert_array_equal(np.asarray(jback.lengths), lens)


# ---------------------------------------------------------------------------
# sort_by_columns


def _rows(batch):
    """The valid prefix as a list of row tuples (bytes for strings, each
    dense value's bits)."""
    c = int(batch.count)
    cols = []
    for name in sorted(batch.columns):
        v = batch.columns[name]
        if hasattr(v, "lengths"):
            d, l = np.asarray(v.data)[:c], np.asarray(v.lengths)[:c]
            cols.append([bytes(d[i, :l[i]]) for i in range(c)])
        else:
            a = np.asarray(v)[:c]
            cols.append([a[i].tobytes() for i in range(c)])
    return list(zip(*cols))


def _key_runs_equal(trows, jrows, key_idx):
    """Same sort-key sequence in order; rows tied on every sort key equal
    as multisets."""
    assert len(trows) == len(jrows)
    tk = [tuple(r[i] for i in key_idx) for r in trows]
    jk = [tuple(r[i] for i in key_idx) for r in jrows]
    assert tk == jk
    runs_t, runs_j = collections.defaultdict(collections.Counter), \
        collections.defaultdict(collections.Counter)
    for k, rt, rj in zip(tk, trows, jrows):
        runs_t[k][rt] += 1
        runs_j[k][rj] += 1
    assert runs_t == runs_j


def _sort_cols(rng, n):
    data, lens = _strings(12, rng, n)
    words = [bytes(data[i, :lens[i]]) for i in range(n)]
    tera = [bytes(r) for r in rng.randint(32, 127, (n, 10)).astype(np.uint8)]
    tera[: n // 4] = tera[n // 4: n // 2]                 # duplicate keys
    return {"s": words, "t": tera,
            "k": rng.randint(-5, 5, n).astype(np.int32),
            "b": rng.randint(-3, 3, n).astype(np.int8),
            "f": rng.choice(np.array([0.5, -0.0, 0.0, np.inf, -2.0,
                                      np.nan], np.float32), n),
            "p": rng.randint(0, 2**31, n).astype(np.int32)}


SORTS = {
    "terasort": [("t", False)],
    "one_desc": [("k", True)],
    "two": [("k", True), ("f", False)],
    "three": [("s", True), ("b", False), ("f", True)],
    "string_desc": [("t", True)],
}


@pytest.mark.parametrize("cap", [700, 900])
@pytest.mark.parametrize("case", list(SORTS))
def test_sort_by_columns_matches_jax(case, cap):
    """1-, 2- and 3-key sorts; cap 900 adds 200 padding rows, which must
    stay out of the valid prefix both ways."""
    n = 700
    cols = _sort_cols(np.random.RandomState(7), cap)
    keys = SORTS[case]
    # rows past n are padding holding real-looking rows
    jb = jcol.batch_from_numpy(cols, str_max_len=12)
    jb = jcol.Batch(jb.columns, jnp.int32(n))
    tb = tcol.batch_from_numpy(cols, str_max_len=12, device="cpu")
    tb = tcol.Batch(tb.columns, torch.tensor(n, dtype=torch.int32))
    jout = jkern.sort_by_columns(jb, keys)
    tout = tkern.sort_by_columns(tb, keys)
    assert int(tout.count) == n
    names = sorted(cols)
    _key_runs_equal(_rows(tout), _rows(jout),
                    [names.index(k) for k, _ in keys])


def test_sort_by_columns_is_stable():
    """Ties keep arrival order: the port's whole row order is numpy's
    stable lexsort on (k desc, b asc)."""
    n = 600
    cols = _sort_cols(np.random.RandomState(8), n)
    tb = tcol.batch_from_numpy(cols, capacity=n, str_max_len=12,
                               device="cpu")
    out = tkern.sort_by_columns(tb, [("k", True), ("b", False)])
    order = np.lexsort((cols["b"], -cols["k"].astype(np.int64)))
    np.testing.assert_array_equal(out.columns["p"].numpy(),
                                  cols["p"][order])


def test_sort_by_int64_key_like_numpy():
    """int64 keys (two lanes, gathered rather than rebuilt) in both
    directions against numpy's stable sort."""
    rng = np.random.RandomState(9)
    n = 500
    k = rng.randint(-2**40, 2**40, n, dtype=np.int64)
    k[::7] = k[1::7][: len(k[::7])]
    p = np.arange(n, dtype=np.int32)
    tb = tcol.batch_from_numpy({"k": k, "p": p}, capacity=n + 50,
                               device="cpu")
    for desc in (False, True):
        out = tkern.sort_by_columns(tb, [("k", desc)])
        order = np.argsort(-k if desc else k, kind="stable")
        np.testing.assert_array_equal(out.columns["k"][:n].numpy(),
                                      k[order])
        np.testing.assert_array_equal(out.columns["p"][:n].numpy(),
                                      p[order])


# ---------------------------------------------------------------------------
# sampled bounds and destinations


def _bounds_state(kind, rng):
    """[P, cap] numpy state with an empty partition and one fuller than
    16 (the stride case when S = 16)."""
    cap = 500
    counts = np.array([500, 0, 37, 499, 1, 16, 17, 250], np.int32)
    if kind == "str":
        data = rng.randint(32, 127, (P, cap, 10)).astype(np.uint8)
        lens = rng.randint(0, 11, (P, cap)).astype(np.int32)
        return {"key": (data, lens)}, counts
    if kind == "f32":
        return {"key": (rng.randn(P, cap) * 50).astype(np.float32)}, counts
    return {"key": rng.randint(-10**6, 10**6, (P, cap)).astype(np.int32)}, \
        counts


def _jax_pdata(cols, counts):
    jc = {k: (jcol.StringColumn(jnp.asarray(v[0]), jnp.asarray(v[1]))
              if isinstance(v, tuple) else jnp.asarray(v))
          for k, v in cols.items()}
    return JPData(jcol.Batch(jc, jnp.asarray(counts)), P)


@pytest.mark.parametrize("S", [4096, 16])
@pytest.mark.parametrize("kind", ["str", "i32", "f32"])
def test_sample_lanes_and_range_bounds_match_jax(devices8, kind, S):
    """S = 4096 takes every valid row of a partition, S = 16 strides
    through the larger ones; partition 1 is empty."""
    cols, counts = _bounds_state(kind, np.random.RandomState(30))
    jpd = _jax_pdata(cols, counts)
    tpd = pdata_from_numpy(cols, counts, "cpu")
    jl = jexec._sample_lanes(jpd.batch.columns["key"], jpd.counts, S)
    tl = texec._sample_lanes(tpd.batch.columns["key"], tpd.counts, S)
    np.testing.assert_array_equal(tl.numpy().astype(np.uint64),
                                  np.asarray(jl).astype(np.uint32)
                                  .astype(np.uint64))
    from dryad_tpu import Context as JContext
    jb = JContext(config=JJobConfig(range_samples_per_partition=S)) \
        .executor._range_bounds(jpd, "key")
    tctx = TContext(device="cpu", nparts=P,
                    config=TJobConfig(range_samples_per_partition=S))
    tb = tctx.executor._range_bounds(tpd, "key")
    assert tb.shape == (P - 1,) and tb.dtype == torch.int64
    np.testing.assert_array_equal(tb.numpy().astype(np.uint64),
                                  np.asarray(jb).astype(np.uint64))


def test_range_bounds_of_no_rows_are_zero():
    cols, _ = _bounds_state("i32", np.random.RandomState(31))
    tpd = pdata_from_numpy(cols, np.zeros(P, np.int32), "cpu")
    tb = TContext(device="cpu", nparts=P).executor._range_bounds(tpd, "key")
    assert tb.tolist() == [0] * (P - 1)


def test_range_samples_per_partition_checked():
    with pytest.raises(ValueError, match="range_samples_per_partition"):
        TJobConfig(range_samples_per_partition=1)


@pytest.mark.parametrize("desc", [False, True])
@pytest.mark.parametrize("kind", ["str", "i32", "f32"])
def test_range_dest_matches_jax(devices8, kind, desc):
    cols, counts = _bounds_state(kind, np.random.RandomState(32))
    jpd = _jax_pdata(cols, counts)
    tpd = pdata_from_numpy(cols, counts, "cpu")
    bounds = TContext(device="cpu", nparts=P).executor._range_bounds(
        tpd, "key")
    for p in range(P):
        if kind == "str":
            tc = tcol.StringColumn(tpd.batch.columns["key"].data[p],
                                   tpd.batch.columns["key"].lengths[p])
            jc = jcol.StringColumn(jpd.batch.columns["key"].data[p],
                                   jpd.batch.columns["key"].lengths[p])
        else:
            tc = tpd.batch.columns["key"][p]
            jc = jpd.batch.columns["key"][p]
        got = tshuffle.range_dest(tc, bounds, desc)
        jb = jnp.asarray(bounds.numpy().astype(np.uint32))
        want = jkern.searchsorted_small(jb, jshuffle.range_dest_lane(jc),
                                        side="right").astype(jnp.int32)
        if desc:
            want = (P - 1) - want
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.min() >= 0 and got.max() <= P - 1


# ---------------------------------------------------------------------------
# take, distinct and the group-contents operators


def _group_cols(rng, n=900):
    words = [b"g%d" % i for i in range(40)] + [b""]
    return {"k": rng.randint(0, 25, n).astype(np.int32),
            "s": [words[i] for i in rng.randint(0, len(words), n)],
            "v": rng.randint(-6, 6, n).astype(np.int32),
            "f": rng.choice(np.array([1.5, -1.0, 0.0, 2.25], np.float32), n),
            "row": np.arange(n, dtype=np.int32)}


def _both(cols, cap):
    return (jcol.batch_from_numpy(cols, capacity=cap, str_max_len=6),
            tcol.batch_from_numpy(cols, capacity=cap, str_max_len=6,
                                  device="cpu"))


def test_take_matches_jax():
    cols = _group_cols(np.random.RandomState(40))
    jb, tb = _both(cols, 1000)
    for n in (0, 17, 900, 5000):
        assert _rows(tkern.take(tb, n)) == _rows(jkern.take(jb, n))


@pytest.mark.parametrize("keys", [("k",), ("s",), ("s", "v"), ()])
def test_distinct_matches_jax(keys):
    """The same representatives (their non-key columns too: the first
    row in arrival order), in the same (hash) order."""
    cols = _group_cols(np.random.RandomState(41))
    jb, tb = _both(cols, 1000)
    jout = jkern.distinct(jb, list(keys) or None)
    tout = tkern.distinct(tb, list(keys) or None)
    assert _rows(tout) == _rows(jout)
    if keys == ("k",):
        first = {}
        for i, k in enumerate(cols["k"]):
            first.setdefault(int(k), i)
        assert sorted(tout.columns["row"][:int(tout.count)].tolist()) == \
            sorted(first.values())


@pytest.mark.parametrize("k,by,desc", [(3, "v", True), (2, "f", False),
                                       (1, "s", True), (50, "v", False)])
def test_group_top_k_matches_jax(k, by, desc):
    """Ties in ``by`` are common here (12 values over 900 rows)."""
    cols = _group_cols(np.random.RandomState(42))
    jb, tb = _both(cols, 1000)
    jout = jkern.group_top_k(jb, ["k"], k, by, desc)
    tout = tkern.group_top_k(tb, ["k"], k, by, desc)
    assert collections.Counter(_rows(tout)) == \
        collections.Counter(_rows(jout))
    if by == "s":
        return
    # ties keep arrival order: a group's kept rows are the first k of a
    # stable sort by ``by``
    trows = tcol.batch_to_numpy(tout)
    for g in (0, 7):
        mine = sorted(int(r) for r, kk in zip(trows["row"], trows["k"])
                      if kk == g)
        idx = np.flatnonzero(cols["k"] == g)
        v = cols[by][idx].astype(np.float64)
        order = np.argsort(-v if desc else v, kind="stable")
        assert mine == sorted(idx[order[:k]].tolist())


@pytest.mark.parametrize("rank", ["median", "min", "max"])
@pytest.mark.parametrize("by", ["v", "s"])
def test_group_rank_select_matches_jax(rank, by):
    cols = _group_cols(np.random.RandomState(43))
    jb, tb = _both(cols, 1000)
    jout = jkern.group_rank_select(jb, ["k"], by, rank, "m")
    tout = tkern.group_rank_select(tb, ["k"], by, rank, "m")
    assert sorted(tout.columns) == ["k", "m"]
    assert collections.Counter(_rows(tout)) == \
        collections.Counter(_rows(jout))
    if by == "v" and rank == "median":
        got = dict(zip(tout.columns["k"][:int(tout.count)].tolist(),
                       tout.columns["m"][:int(tout.count)].tolist()))
        for g in range(25):
            v = np.sort(cols["v"][cols["k"] == g])
            assert got[g] == v[(len(v) - 1) // 2]
