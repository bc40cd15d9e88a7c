"""The port's set operators — ``union``, ``intersect``, ``except_`` (the
``SetOp`` lowering: per-leg distinct, whole-row hash exchanges, then
``concat`` / ``semi_anti`` + distinct) and ``concat`` — and their kernels
(``kernels._hash_membership``, ``semi_anti_join``, ``concat2``) against
the JAX package on its 8-device CPU mesh with the same numpy inputs, and
against numpy's sets of rows.

Tolerance: none.  Set results compare as sets of whole rows (both
packages deduplicate unstably by hash, so the row order is unspecified);
``concat`` as a multiset; kernels on the valid prefix, in order."""

import collections

import numpy as np
import pytest

import jax
import torch

from dryad_tpu import Context as JContext
from dryad_tpu.data import columnar as jcol
from dryad_tpu.ops import kernels as jkern
from dryad_tpu.parallel.mesh import make_mesh
from dryad_tpu.plan.planner import plan_query as jplan_query
from dryad_tpu_torch import Context as TContext
from dryad_tpu_torch.data import columnar as tcol
from dryad_tpu_torch.ops import kernels as tkern
from tests.torch_threads import one_torch_thread  # noqa: F401

P = 8
OPS = ("union", "intersect", "except_", "concat")


def _tables(case, rng):
    """(left, right) host columns: duplicates inside each side, a half
    overlap; "empty_left" / "empty_right" give one side no row (through a
    filter, so it still has a capacity); "strings" carries strings of
    different widths; "reordered" gives the right side its columns in
    another insertion order."""
    nl, nr = 700, 500
    lk = rng.randint(0, 120, nl).astype(np.int32)
    rk = rng.randint(60, 180, nr).astype(np.int32)
    left = {"k": lk, "tag": (lk % 7).astype(np.int32)}
    right = {"k": rk, "tag": (rk % 7).astype(np.int32)}
    if case == "strings":
        left["s"] = [b"w%d" % (k % 13) for k in lk.tolist()]
        right["s"] = [b"w%d" % (k % 13) + (b"" if k % 2 else b"-long")
                      for k in rk.tolist()]
    if case == "reordered":
        right = {"tag": right["tag"], "k": right["k"]}
    return left, right


def _widths(case):
    return (8, 16) if case == "strings" else (8, 8)


def _load(ctx, case, left, right):
    lw, rw = _widths(case)
    a = ctx.from_columns(left, str_max_len=lw)
    b = ctx.from_columns(right, str_max_len=rw)
    if case == "empty_left":
        a = a.where(lambda c: c["k"] < 0)
    if case == "empty_right":
        b = b.where(lambda c: c["k"] < 0)
    return a, b


def _rows(t, names):
    return collections.Counter(
        zip(*[[bytes(x) if isinstance(x, (bytes, np.bytes_)) else
               (x.item() if hasattr(x, "item") else x)
               for x in t[c]] for c in names]))


def _host_rows(table, names, empty):
    if empty:
        return collections.Counter()
    return collections.Counter(zip(*[list(table[c]) if c == "s"
                                     else np.asarray(table[c]).tolist()
                                     for c in names]))


def _oracle(op, left, right, case, names):
    lrows = _host_rows(left, names, case == "empty_left")
    rrows = _host_rows(right, names, case == "empty_right")
    if op == "concat":
        return lrows + rrows
    ls, rs = set(lrows), set(rrows)
    res = {"union": ls | rs, "intersect": ls & rs,
           "except_": ls - rs}[op]
    return collections.Counter(res)


def _query(ds_a, ds_b, op):
    return getattr(ds_a, op)(ds_b)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("case", ["ints", "empty_left", "empty_right",
                                  "strings", "reordered"])
def test_set_ops_match_jax(devices8, op, case):
    """Each operator against the JAX package and numpy's sets of rows
    (a multiset for concat); set results hold no row twice."""
    rng = np.random.RandomState(len(case) * 7 + len(op))
    left, right = _tables(case, rng)
    names = ["k", "tag"] + (["s"] if case == "strings" else [])
    outs = []
    for ctx in (TContext(device="cpu", nparts=P), JContext()):
        a, b = _load(ctx, case, left, right)
        outs.append(_query(a, b, op).collect())
    t, j = outs
    assert sorted(t) == sorted(j) == sorted(names)
    want = _oracle(op, left, right, case, names)
    assert _rows(t, names) == _rows(j, names) == want
    if op != "concat":
        assert max(_rows(t, names).values(), default=1) == 1


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("nparts", [1, 8])
def test_set_op_plans_match_jax(devices8, op, nparts):
    """The plans are the JAX package's: stage labels, each leg's ops and
    exchange (kind, keys, capacity), the body ops and the output
    capacity."""
    rng = np.random.RandomState(1)
    left, right = _tables("ints", rng)
    sigs = []
    for ctx in (TContext(device="cpu", nparts=nparts),
                JContext(mesh=make_mesh(n=nparts))):
        a, b = _load(ctx, "ints", left, right)
        q = _query(a, b, op)
        g = jplan_query(q.node, nparts) if isinstance(ctx, JContext) \
            else q.plan()
        sigs.append([(st.label,
                      [([o.kind for o in leg.ops],
                        leg.exchange and (leg.exchange.kind,
                                          tuple(leg.exchange.keys),
                                          leg.exchange.out_capacity))
                       for leg in st.legs],
                      [o.kind for o in st.body]) for st in g.stages])
    assert sigs[0] == sigs[1]
    assert sigs[0][-1][0] == ("except" if op == "except_" else op)


def _batches(rng, nl, nr, cap_l, cap_r):
    """One partition's left and right batches in both packages: int keys
    with duplicates and an overlap, a payload column."""
    lk = rng.randint(0, 40, nl).astype(np.int32)
    rk = rng.randint(20, 60, nr).astype(np.int32)
    left = {"k": lk, "p": rng.randint(-9, 9, nl).astype(np.int32)}
    right = {"k": rk, "q": rng.rand(nr).astype(np.float32)}
    return ((jcol.batch_from_numpy(left, capacity=cap_l),
             jcol.batch_from_numpy(right, capacity=cap_r)),
            (tcol.batch_from_numpy(left, capacity=cap_l, device="cpu"),
             tcol.batch_from_numpy(right, capacity=cap_r, device="cpu")))


def _valid(batch):
    c = int(np.asarray(batch.count))
    return {k: np.asarray(v)[:c] for k, v in batch.columns.items()}


@pytest.mark.parametrize("anti", [False, True])
@pytest.mark.parametrize("sizes", [(90, 70), (0, 70), (90, 0), (1, 1)])
def test_semi_anti_join_matches_jax(devices8, anti, sizes):
    """The kept left rows, in their order, and the count."""
    rng = np.random.RandomState(sum(sizes) + anti)
    (jl, jr), (tl, tr) = _batches(rng, *sizes, 96, 80)
    j = jax.jit(lambda a, b: jkern.semi_anti_join(a, b, ["k"], ["k"],
                                                  anti=anti))(jl, jr)
    t = tkern.semi_anti_join(tl, tr, ["k"], ["k"], anti=anti)
    assert int(t.count) == int(j.count)
    jv, tv = _valid(j), _valid(t)
    for k in jv:
        np.testing.assert_array_equal(tv[k], jv[k])


@pytest.mark.parametrize("n", [0, 1, 37, 300])
def test_hash_membership_matches_jax(devices8, n):
    """Membership of each row's 64-bit-hash segment in the flagged rows,
    in original order: flags on valid and invalid rows, hash collisions
    by construction (equal (hi, lo) pairs), an invalid tail."""
    rng = np.random.RandomState(n)
    cap = 320
    hi = rng.randint(0, 6, cap).astype(np.uint32) * np.uint32(0x9E3779B1)
    lo = rng.randint(0, 4, cap).astype(np.uint32)
    flag = rng.rand(cap) < 0.2
    valid = np.arange(cap) < n
    want = np.asarray(jax.jit(jkern._hash_membership)(
        hi, lo, flag.astype(np.int32), valid))
    got = tkern._hash_membership(
        torch.from_numpy(hi.astype(np.int64)),
        torch.from_numpy(lo.astype(np.int64)),
        torch.from_numpy(flag), torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy()[:n], want[:n])


@pytest.mark.parametrize("counts", [(5, 7), (0, 7), (5, 0), (16, 12)])
def test_concat2_matches_jax(devices8, counts):
    """a's valid rows then b's, string columns padded to the wider
    max_len, b's columns read by a's names."""
    rng = np.random.RandomState(sum(counts))
    na, nb = counts
    a = {"k": rng.randint(-5, 5, na).astype(np.int32),
         "s": [b"x" * int(i) for i in rng.randint(0, 6, na)]}
    b = {"s": [b"yy" * int(i) for i in rng.randint(0, 6, nb)],
         "k": rng.randint(-5, 5, nb).astype(np.int32)}
    ja = jcol.batch_from_numpy(a, capacity=16, str_max_len=6)
    jb = jcol.batch_from_numpy(b, capacity=12, str_max_len=11)
    ta = tcol.batch_from_numpy(a, capacity=16, str_max_len=6, device="cpu")
    tb = tcol.batch_from_numpy(b, capacity=12, str_max_len=11, device="cpu")
    j = jax.jit(jkern.concat2)(ja, jb)
    t = tkern.concat2(ta, tb)
    assert t.names == ["k", "s"] and t.capacity == 28
    assert int(t.count) == int(j.count) == na + nb
    c = na + nb
    np.testing.assert_array_equal(t.columns["k"].numpy()[:c],
                                  np.asarray(j.columns["k"])[:c])
    ts, js = t.columns["s"], j.columns["s"]
    assert ts.max_len == js.max_len == 11
    np.testing.assert_array_equal(ts.lengths.numpy()[:c],
                                  np.asarray(js.lengths)[:c])
    np.testing.assert_array_equal(ts.data.numpy()[:c],
                                  np.asarray(js.data)[:c])
