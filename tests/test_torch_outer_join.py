"""The port's right and full outer joins (``ops/kernels.general_join``'s
unmatched-right tail, ``Dataset.join(how="right"|"full")``) and
``group_join``, against the JAX package on the same numpy inputs: the
kernel jitted on its own, the queries on its 8-device CPU mesh (mirrors
``tests/test_outer_join.py``).

Tolerance: none.  Outputs compare as multisets of whole rows (integer,
string and exactly carried f32 data), with equal counts and needs."""

import collections

import numpy as np
import pytest

import jax

from dryad_tpu import Context as JContext
from dryad_tpu.data import columnar as jcol
from dryad_tpu.ops import kernels as jkern
from dryad_tpu_torch import Context as TContext
from dryad_tpu_torch.data import columnar as tcol
from dryad_tpu_torch.ops import kernels as tkern

P = 8
HOWS = ["right", "full"]


def _table_rows(t):
    """Multiset of a collected table's rows, columns in sorted order."""
    names = sorted(t)
    cols = [[bytes(x) for x in t[c]] if isinstance(t[c], list)
            else np.asarray(t[c]).tolist() for c in names]
    return collections.Counter(zip(*cols))


def _both(query):
    """query(ctx) collected through the port and the JAX package."""
    return (_table_rows(query(TContext(device="cpu", nparts=P)).collect()),
            _table_rows(query(JContext()).collect()))


def _sides(c, seed=0):
    rng = np.random.RandomState(seed)
    left = c.from_columns(
        {"k": rng.randint(0, 12, 80).astype(np.int32),
         "lv": rng.randn(80).astype(np.float32)}, capacity=32)
    right = c.from_columns(
        {"k": rng.randint(6, 18, 60).astype(np.int32),
         "rv": np.arange(60, dtype=np.int32)}, capacity=32)
    return left, right


def _oracle(lk, lcols, rk, rcols, how):
    """The outer join by nested loops: matched pairs, then the unmatched
    rows of the kept side(s) with the other side zero-filled (an
    unmatched right row's key in the left key column)."""
    out = collections.Counter()
    matched_r = set()
    for i, k in enumerate(lk):
        hits = [j for j, r in enumerate(rk) if r == k]
        for j in hits:
            matched_r.add(j)
            out[(k,) + tuple(c[i] for c in lcols)
                + tuple(c[j] for c in rcols)] += 1
        if not hits and how == "full":
            out[(k,) + tuple(c[i] for c in lcols)
                + tuple(0 for _ in rcols)] += 1
    for j, k in enumerate(rk):
        if j not in matched_r:
            out[(k,) + tuple(0 for _ in lcols)
                + tuple(c[j] for c in rcols)] += 1
    return out


@pytest.mark.parametrize("how", HOWS)
def test_outer_join_matches_jax(devices8, how):
    """Overlapping integer keys with duplicates on both sides."""
    def q(c):
        l, r = _sides(c)
        return l.join(r, ["k"], expansion=16.0, how=how)

    got, want = _both(q)
    assert got == want
    rng = np.random.RandomState(0)
    lk = rng.randint(0, 12, 80).tolist()
    lv = rng.randn(80).astype(np.float32).tolist()
    rk = rng.randint(6, 18, 60).tolist()
    # rows as (k, lv, rv): the sorted column order of the output
    assert got == _oracle(lk, [lv], rk, [list(range(60))], how)


@pytest.mark.parametrize("how", HOWS)
def test_outer_join_disjoint_keys(devices8, how):
    """No key in common: a right join is the right rows with zero-filled
    left columns, a full join both sides zero-filled on the other."""
    def q(c):
        l = c.from_columns({"k": np.arange(0, 20, dtype=np.int32),
                            "lv": np.ones(20, np.float32)}, capacity=8)
        r = c.from_columns({"k": np.arange(100, 130, dtype=np.int32),
                            "rv": np.arange(30, dtype=np.int32)}, capacity=8)
        return l.join(r, ["k"], expansion=8.0, how=how)

    got, want = _both(q)
    assert got == want
    assert sum(got.values()) == (30 if how == "right" else 50)


@pytest.mark.parametrize("how", HOWS)
def test_outer_join_string_keys(devices8, how):
    words_l = [b"apple", b"pear", b"fig", b"plum", b"apple", b"kiwi"] * 4
    words_r = [b"fig", b"mango", b"apple", b"dates"] * 3

    def q(c):
        l = c.from_columns({"w": list(words_l),
                            "lv": np.arange(len(words_l), dtype=np.int32)},
                           capacity=8)
        r = c.from_columns({"w": list(words_r),
                            "rv": np.arange(len(words_r), dtype=np.int32)},
                           capacity=8)
        return l.join(r, ["w"], expansion=16.0, how=how)

    got, want = _both(q)
    assert got == want
    # (lv, rv, w): every unmatched right word is there with lv = 0
    unmatched = {w for (lv, rv, w) in got if lv == 0
                 and w in (b"mango", b"dates")}
    assert unmatched == {b"mango", b"dates"}


@pytest.mark.parametrize("how", HOWS)
def test_outer_join_different_key_names(devices8, how):
    """The left key column carries the right key for unmatched right
    rows."""
    def q(c):
        l = c.from_columns({"a": np.arange(10, dtype=np.int32),
                            "lv": np.arange(10, dtype=np.int32) * 2},
                           capacity=4)
        r = c.from_columns({"b": np.arange(5, 15, dtype=np.int32),
                            "rv": np.arange(10, dtype=np.int32) * 3},
                           capacity=4)
        return l.join(r, ["a"], ["b"], expansion=4.0, how=how)

    got, want = _both(q)
    assert got == want
    # (a, lv, rv): right keys 10-14 match nothing
    assert {(a, rv) for a, lv, rv in got if a >= 10} == \
        {(b, (b - 5) * 3) for b in range(10, 15)}


@pytest.mark.parametrize("how", HOWS)
def test_outer_join_mismatched_string_widths(devices8, how):
    """Unmatched right keys LONGER than the left key column's width come
    through whole: the kernel against the JAX one, same rows and need."""
    left = {"k": [b"ab", b"cd"], "lv": np.arange(2, dtype=np.int32)}
    right = {"k": [b"ab", b"mangosteen"],
             "rv": np.arange(2, dtype=np.int32) + 7}
    outs = []
    for col, kern, kw in ((jcol, jkern, {}), (tcol, tkern, {"device": "cpu"})):
        lb = col.batch_from_numpy(left, capacity=2, str_max_len=2, **kw)
        rb = col.batch_from_numpy(right, capacity=2, str_max_len=10, **kw)
        fn = lambda a, b, k=kern: k.hash_join(a, b, ["k"], ["k"],  # noqa
                                               out_capacity=8, how=how)
        out, need = (jax.jit(fn) if kern is jkern else fn)(lb, rb)
        n = int(out.count)
        data = np.asarray(out.columns["k"].data)
        lens = np.asarray(out.columns["k"].lengths)
        outs.append((int(need), sorted(
            (bytes(data[i, :lens[i]]), int(np.asarray(out.columns["lv"])[i]),
             int(np.asarray(out.columns["rv"])[i])) for i in range(n))))
    assert outs[0] == outs[1]
    want = [(b"ab", 0, 7), (b"mangosteen", 0, 8)]
    if how == "full":
        want.insert(1, (b"cd", 1, 0))
    assert outs[1] == (0, want)


def _kernel_sides(case, rng):
    nl = 0 if case == "empty_left" else 120
    nr = 0 if case == "empty_right" else 80
    lk = rng.randint(-30, 30, nl).astype(np.int32)
    rk = rng.randint(-20, 40, nr).astype(np.int32)
    if case == "unique":
        rk = rng.permutation(np.arange(-20, 60, dtype=np.int32))[:nr]
    left = {"k": lk, "a": rng.randint(-2**31, 0, nl).astype(np.int32),
            "v": (-rng.rand(nl) * 1e3).astype(np.float32)}
    right = {"k": rk, "v": (-rng.rand(nr) - 1e-3).astype(np.float32),
             "w": rng.randint(-2**31, -1, nr).astype(np.int32)}
    return left, right


def _kernel_both(left, right, how, out_cap, unique=False):
    lcap, rcap = 128, 96
    jl = jcol.batch_from_numpy(left, capacity=lcap)
    jr = jcol.batch_from_numpy(right, capacity=rcap)
    tl = tcol.batch_from_numpy(left, capacity=lcap, device="cpu")
    tr = tcol.batch_from_numpy(right, capacity=rcap, device="cpu")
    jout, jneed = jax.jit(lambda a, b: jkern.hash_join(
        a, b, ["k"], ["k"], out_capacity=out_cap, how=how,
        right_unique=unique))(jl, jr)
    tout, tneed = tkern.hash_join(tl, tr, ["k"], ["k"], out_capacity=out_cap,
                                  how=how, right_unique=unique)
    assert tout.capacity == out_cap
    assert int(tout.count) == int(jout.count)
    assert int(tneed) == int(jneed)

    def rows(b):
        c = int(np.asarray(b.count))
        return collections.Counter(zip(*[np.asarray(b.columns[k])[:c]
                                         .tolist() for k in sorted(
                                             b.columns)]))
    return rows(tout), rows(jout), int(tneed)


@pytest.mark.parametrize("unique", [False, True])
@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("case", ["dup", "unique", "empty_left",
                                  "empty_right"])
def test_outer_hash_join_kernel_matches_jax(devices8, case, how, unique):
    """The kernel on one partition, right_unique declared or not (an
    outer join never takes the lookup form): the JAX kernel's rows,
    count and need, and the nested-loop join's rows."""
    left, right = _kernel_sides(case, np.random.RandomState(len(case)))
    trows, jrows, need = _kernel_both(left, right, how, 512, unique)
    assert trows == jrows
    assert need == 0
    # rows as (a, k, v, v_r, w)
    want = collections.Counter()
    for (k, a, v, vr, w), n in _oracle(
            left["k"].tolist(), [left["a"].tolist(), left["v"].tolist()],
            right["k"].tolist(), [right["v"].tolist(), right["w"].tolist()],
            how).items():
        want[(a, k, v, vr, w)] += n
    assert trows == want


@pytest.mark.parametrize("how", HOWS)
def test_outer_hash_join_overflow_need_matches_jax(devices8, how):
    """Too small an out_capacity: the need equals the JAX package's
    (candidate pairs + the right rows left unmatched, which counts the
    right rows whose matches the capacity dropped too, so it can exceed
    the output), a retry at the need fits and gives the whole join, and
    the kept rows are real output rows."""
    left, right = _kernel_sides("dup", np.random.RandomState(5))
    trows, jrows, need = _kernel_both(left, right, how, 40)
    full, _, _ = _kernel_both(left, right, how, 512)
    retry, _, fits = _kernel_both(left, right, how, need)
    assert fits == 0 and retry == full
    assert need >= sum(full.values()) > 40
    assert sum(trows.values()) == sum(jrows.values()) == 40
    assert not trows - full


def test_full_join_broadcast_request_ignored(devices8):
    """broadcast=True must not replicate the right side of a full join
    (its unmatched right rows would come out once per partition)."""
    def q(c):
        l, r = _sides(c, seed=3)
        return l.join(r, ["k"], expansion=16.0, broadcast=True, how="full")

    t = TContext(device="cpu", nparts=P)
    (join,) = [st for st in q(t).plan().stages if st.label == "join"]
    kinds = [leg.exchange.kind for leg in join.legs]
    assert kinds == ["hash", "hash"]
    got, want = _both(q)
    assert got == want


@pytest.mark.parametrize("nparts", [1, 8])
def test_group_join_with_empty_groups(devices8, nparts):
    """Each left row with its right group's aggregates; a left key with no
    right rows gets count 0 and a zero sum."""
    rng = np.random.RandomState(11)
    lcols = {"k": np.arange(40, dtype=np.int32),
             "name": rng.randint(0, 100, 40).astype(np.int32)}
    rcols = {"ck": rng.randint(0, 25, 300).astype(np.int32),
             "x": rng.randint(-50, 50, 300).astype(np.int32),
             "f": (rng.randint(-64, 64, 300) / 4).astype(np.float32)}

    def q(c):
        return c.from_columns(lcols).group_join(
            c.from_columns(rcols), ["k"],
            {"n": ("count", None), "s": ("sum", "x"), "fs": ("sum", "f")},
            right_keys=["ck"])

    got = _table_rows(q(TContext(device="cpu", nparts=nparts)).collect())
    assert got == _table_rows(q(JContext()).collect())
    want = collections.Counter()
    for k, name in zip(lcols["k"].tolist(), lcols["name"].tolist()):
        sel = rcols["ck"] == k
        # sorted columns: fs, k, n, name, s
        want[(float(rcols["f"][sel].sum()), k, int(sel.sum()), name,
              int(rcols["x"][sel].sum()))] += 1
    assert got == want
    assert any(n == 0 for (_fs, _k, n, _name, _s) in got)
