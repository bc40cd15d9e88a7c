"""The port's equi-join (dryad_tpu_torch/ops/kernels.py ``hash_join``, its
lookup-table form ``lookup_join``), the two-leg join stage, ``do_while``
and ``with_capacity`` against the JAX package on the same numpy inputs.

Tolerance: none.  Join outputs compare as multisets of the valid prefix
(both packages sort unstably by hash), with equal counts and equal needs;
an overflowing join's kept rows are a sub-multiset of the full join.
Loop results compare as multisets of whole rows (integer data)."""

import collections

import numpy as np
import pytest

import jax

from dryad_tpu import Context as JContext
from dryad_tpu.data import columnar as jcol
from dryad_tpu.exec.executor import CapacityError as JCapacityError
from dryad_tpu.ops import kernels as jkern
from dryad_tpu.plan.planner import plan_query as jplan_query
from dryad_tpu_torch import Context as TContext
from dryad_tpu_torch.data import columnar as tcol
from dryad_tpu_torch.exec.executor import CapacityError
from dryad_tpu_torch.ops import kernels as tkern
from tests.torch_threads import one_torch_thread  # noqa: F401

P = 8
LCAP, RCAP = 320, 128


def _sides(case, rng):
    """(left columns, right columns): signed keys, negative int and float
    payloads, a right column whose name clashes with a left one."""
    nl, nr = (0 if case == "empty_left" else 300,
              0 if case == "empty_right" else 100)
    if case.startswith("str"):
        vocab = [b"", b"a", b"\x80\xff", b"key-with-8"] + \
            [b"w%d" % i for i in range(120)]
        lk = [vocab[i] for i in rng.randint(0, len(vocab), nl)]
        if case == "str_dup":
            rk = [vocab[i] for i in rng.randint(0, len(vocab), nr)]
        else:
            rk = [vocab[i] for i in rng.permutation(len(vocab))[:nr]]
    else:
        lk = rng.randint(-60, 60, nl).astype(np.int32)
        if case == "int_dup":
            rk = rng.randint(-50, 50, nr).astype(np.int32)
        else:
            rk = rng.permutation(np.arange(-50, 50, dtype=np.int32))[:nr]
    left = {"k": lk, "a": rng.randint(-2**31, 0, nl).astype(np.int32),
            "v": (-rng.rand(nl) * 1e3).astype(np.float32)}
    right = {"k": rk, "v": (-rng.rand(nr) - 1e-3).astype(np.float32),
             "w": rng.randint(-2**31, -1, nr).astype(np.int32)}
    return left, right


def _rows(batch):
    """Multiset of the valid rows (whole rows, strings as bytes)."""
    c = int(np.asarray(batch.count))
    cols = []
    for name in sorted(batch.columns):
        v = batch.columns[name]
        if hasattr(v, "lengths"):
            d, ln = np.asarray(v.data)[:c], np.asarray(v.lengths)[:c]
            cols.append([bytes(d[i, :ln[i]]) for i in range(c)])
        else:
            cols.append(np.asarray(v)[:c].tolist())
    return collections.Counter(zip(*cols)) if cols else collections.Counter()


def _join_both(left, right, how, unique, out_cap):
    jl = jcol.batch_from_numpy(left, capacity=LCAP, str_max_len=12)
    jr = jcol.batch_from_numpy(right, capacity=RCAP, str_max_len=12)
    tl = tcol.batch_from_numpy(left, capacity=LCAP, str_max_len=12,
                               device="cpu")
    tr = tcol.batch_from_numpy(right, capacity=RCAP, str_max_len=12,
                               device="cpu")
    jout, jneed = jax.jit(lambda a, b: jkern.hash_join(
        a, b, ["k"], ["k"], out_capacity=out_cap, how=how,
        right_unique=unique))(jl, jr)
    tout, tneed = tkern.hash_join(tl, tr, ["k"], ["k"], out_capacity=out_cap,
                                  how=how, right_unique=unique)
    assert sorted(tout.columns) == sorted(jout.columns) == \
        ["a", "k", "v", "v_r", "w"]
    assert int(tout.count) == int(jout.count)
    assert int(tneed) == int(jneed)
    return _rows(tout), _rows(jout), int(tneed)


def _expected(left, right, how):
    """The join by nested loops, as a multiset of sorted-name rows."""
    rk = list(right["k"])
    out = collections.Counter()
    for i, k in enumerate(left["k"]):
        lrow = (left["a"][i].item(), k if isinstance(k, bytes) else k.item(),
                left["v"][i].item())
        hits = [j for j, r in enumerate(rk) if r == k]
        for j in hits:
            out[lrow[:2] + (lrow[2], right["v"][j].item(),
                            right["w"][j].item())] += 1
        if not hits and how == "left":
            out[lrow + (0.0, 0)] += 1
    return out


@pytest.mark.parametrize("unique", [True, False])
@pytest.mark.parametrize("how", ["inner", "left"])
@pytest.mark.parametrize("case", ["int", "int_dup", "str", "str_dup",
                                  "empty_left", "empty_right"])
def test_hash_join_matches_jax(devices8, monkeypatch, case, how, unique):
    """Both lowerings: the lookup join's result stands exactly when
    right_unique is declared and no two right rows share a key;
    duplicates take the general join (the JAX package's lax.cond
    fallback)."""
    rng = np.random.RandomState(sum(map(ord, case)))
    left, right = _sides(case, rng)
    calls = collections.Counter()
    for name in ("lookup_join", "general_join"):
        real = getattr(tkern, name)
        monkeypatch.setattr(
            tkern, name, lambda *a, _n=name, _f=real, **k:
            calls.update([_n]) or _f(*a, **k))
    trows, jrows, need = _join_both(left, right, how, unique, 2 * LCAP)
    assert trows == jrows == _expected(left, right, how)
    assert need == 0
    dup = case.endswith("_dup")
    assert calls["lookup_join"] == int(unique)
    assert calls["general_join"] == int(not unique or dup)


@pytest.mark.parametrize("unique", [True, False])
@pytest.mark.parametrize("case", ["int", "int_dup", "str"])
def test_hash_join_overflow_need_matches_jax(devices8, case, unique):
    """Too small an out_capacity: equal counts and needs in both
    packages, and the kept rows are real join rows."""
    left, right = _sides(case, np.random.RandomState(5))
    trows, jrows, need = _join_both(left, right, "inner", unique, 50)
    full = _expected(left, right, "inner")
    assert need == sum(full.values()) > 50
    assert sum(trows.values()) == sum(jrows.values()) == 50
    assert not trows - full and not jrows - full


def test_right_has_duplicates_reads_only_valid_rows():
    """``lookup_join``'s duplicate flag: valid right rows only, whether or
    not a left row shares the key."""
    r = tcol.batch_from_numpy({"k": np.array([3, -1, 7], np.int32)},
                              capacity=6, device="cpu")
    r.columns["k"][3:] = 3          # padding repeats a real key
    for lkeys in ([], [3, -1], [5]):
        left = tcol.batch_from_numpy({"k": np.array(lkeys, np.int32)},
                                     capacity=4, device="cpu")
        left.columns["k"][len(lkeys):] = -1   # padding repeats a key too
        flags = []
        for k2 in (7, -1):
            r.columns["k"][2] = k2
            flags.append(bool(tkern.lookup_join(left, r, ["k"], ["k"],
                                                8)[2]))
        assert flags == [False, True]


def _pairs(ctx, n=400, seed=0):
    rng = np.random.RandomState(seed)
    return ctx.from_columns({
        "k": rng.randint(-30, 30, n).astype(np.int32),
        "x": rng.randint(-1000, 1000, n).astype(np.int32)})


def _plan(ds):
    """The dataset's stage graph, from either package's planner."""
    if isinstance(ds.ctx, TContext):
        return ds.plan()
    return jplan_query(ds.node, ds.ctx.nparts, config=ds.ctx.config)


def _table_rows(t, cols):
    return collections.Counter(zip(*[np.asarray(t[c]).tolist()
                                     for c in cols]))


@pytest.mark.parametrize("how", ["inner", "left"])
@pytest.mark.parametrize("unique", [True, False])
def test_join_stage_matches_jax(devices8, how, unique):
    """The two-leg stage through the user entry points: both legs
    hash-exchanged, the body joins; against the JAX package."""
    rng = np.random.RandomState(3)
    dim = {"k": rng.permutation(np.arange(-40, 40, dtype=np.int32))[:50],
           "y": (-rng.rand(50)).astype(np.float32)}
    outs = []
    for ctx in (TContext(device="cpu", nparts=P), JContext()):
        q = _pairs(ctx).join(ctx.from_columns(dim), ["k"], how=how,
                             right_unique=unique)
        outs.append(q.collect())
        plan = _plan(q)
        assert [len(st.legs) for st in plan.stages] == [2]
        assert [leg.exchange.keys for leg in plan.stages[0].legs] == \
            [("k",), ("k",)]
        assert plan.stages[0].salt_ok
    cols = ("k", "x", "y")
    assert _table_rows(outs[0], cols) == _table_rows(outs[1], cols)


@pytest.mark.parametrize("how", ["inner", "left"])
def test_join_stage_mixed_duplicate_partitions_match_jax(devices8,
                                                         monkeypatch, how):
    """right_unique with duplicates in SOME partitions: every partition
    runs the lookup join, those with a duplicate key take the general
    join too, and the result is the JAX package's."""
    rng = np.random.RandomState(4)
    keys = rng.permutation(np.arange(-40, 40, dtype=np.int32))[:50]
    keys = np.concatenate([keys, keys[:2]])     # two keys twice
    dim = {"k": keys, "y": (-rng.rand(len(keys))).astype(np.float32)}
    calls = collections.Counter()
    for name in ("lookup_join", "general_join"):
        real = getattr(tkern, name)
        monkeypatch.setattr(
            tkern, name, lambda *a, _n=name, _f=real, **k:
            calls.update([_n]) or _f(*a, **k))
    tctx = TContext(device="cpu", nparts=P)
    outs = [_pairs(ctx).join(ctx.from_columns(dim), ["k"], how=how,
                             right_unique=True).collect()
            for ctx in (tctx, JContext())]
    (join,) = [s for s in tctx.executor.stage_log if s["label"] == "join"]
    attempts = join["attempts"]
    assert calls["lookup_join"] == attempts * P
    # the final attempt's two duplicated keys sit in one or two partitions
    # (an attempt whose exchange overflowed may have dropped their rows)
    assert 1 <= calls["general_join"] <= 2 * attempts
    cols = ("k", "x", "y")
    assert _table_rows(outs[0], cols) == _table_rows(outs[1], cols)


def test_join_on_placed_sides_skips_both_exchanges(devices8):
    """A group_by output is hash-placed by its key: joining two of them on
    that key plans no exchange, and both stages are marked relied on."""
    t = TContext(device="cpu", nparts=P)
    a = _pairs(t).group_by(["k"], {"n": ("count", None)})
    b = _pairs(t, seed=1).group_by(["k"], {"s": ("sum", "x")})
    q = a.join(b, ["k"], right_unique=True)
    plan = q.plan()
    join = [st for st in plan.stages if st.label == "join"][0]
    assert all(leg.exchange is None for leg in join.legs)
    assert not join.salt_ok
    assert all(plan.stages[leg.src].placement_relied for leg in join.legs)
    j = JContext()
    jq = _pairs(j).group_by(["k"], {"n": ("count", None)}).join(
        _pairs(j, seed=1).group_by(["k"], {"s": ("sum", "x")}), ["k"],
        right_unique=True)
    cols = ("k", "n", "s")
    assert _table_rows(q.collect(), cols) == _table_rows(jq.collect(), cols)


def test_joins_not_ported_raise(devices8):
    """Right and full joins, ported since, give the JAX package's rows
    (they raised before); the broadcast join plans a broadcast right leg
    instead of raising."""
    t = TContext(device="cpu", nparts=P)
    j = JContext()
    a, b = _pairs(t), _pairs(t, seed=1)
    cols = ("k", "x", "x_r")
    for how in ("right", "full"):
        got = a.join(b, ["k"], expansion=12.0, how=how).collect()
        want = _pairs(j).join(_pairs(j, seed=1), ["k"], expansion=12.0,
                              how=how).collect()
        assert _table_rows(got, cols) == _table_rows(want, cols)
    join = a.join(b, ["k"], broadcast=True).plan().stages[-1]
    assert [leg.exchange and leg.exchange.kind for leg in join.legs] == \
        [None, "broadcast"]


def test_skewed_join_raises_where_jax_would_salt(devices8):
    """Every left row on one key: the left exchange needs 8x its
    capacity, past the salting trigger (4x), so the stage switches to
    the salted exchange, as the JAX package's does (the port raised
    here before salting was ported); every row matches its one right
    row."""
    t = TContext(device="cpu", nparts=P)
    left = t.from_columns({"k": np.zeros(800, np.int32),
                           "x": np.arange(800, dtype=np.int32)})
    right = t.from_columns({"k": np.arange(8, dtype=np.int32),
                            "y": np.arange(8, dtype=np.int32) + 5})
    out = left.join(right, ["k"], expansion=8.0).collect()
    assert sorted(out["x"].tolist()) == list(range(800))
    assert (np.asarray(out["y"]) == 5).all()
    (join,) = [s for s in t.executor.stage_log if s["label"] == "join"]
    assert join["salted"] and join["attempts"] == 2


def _loop_body(ds, cap):
    """One superstep over (k, v): v <- (sum of v over k) % 97 + 1, the
    keys kept, the capacity held."""
    return (ds.group_by(["k"], {"v": ("sum", "v")})
              .select(lambda c: {"k": c["k"], "v": c["v"] % 97 + 1})
              .with_capacity(cap))


@pytest.mark.parametrize("n_iters", [0, 1, 3])
def test_do_while_matches_jax(devices8, n_iters):
    rng = np.random.RandomState(4)
    cols = {"k": rng.randint(0, 40, 300).astype(np.int32),
            "v": rng.randint(0, 50, 300).astype(np.int32)}
    outs = []
    for ctx in (TContext(device="cpu", nparts=P), JContext()):
        init = ctx.from_columns(cols).with_capacity(64)
        outs.append(ctx.do_while(init, lambda d: _loop_body(d, 64),
                                 n_iters=n_iters).collect())
    assert _table_rows(outs[0], ("k", "v")) == _table_rows(outs[1], ("k", "v"))
    # the oracle: n_iters supersteps on the host
    want = collections.Counter(zip(cols["k"].tolist(), cols["v"].tolist()))
    for _ in range(n_iters):
        s = collections.Counter()
        for (k, v), c in want.items():
            s[k] += v * c
        want = collections.Counter({(k, v % 97 + 1): 1 for k, v in s.items()})
    assert _table_rows(outs[0], ("k", "v")) == want


def test_do_while_cond_stops_early(devices8):
    """``cond`` sees the current table after each iteration; the loop
    stops at the first False."""
    cols = {"k": np.arange(16, dtype=np.int32),
            "v": np.zeros(16, np.int32)}
    seen = []

    def body(d):
        return d.select(lambda c: {"k": c["k"], "v": c["v"] + 1})

    def cond(t):
        seen.append(int(np.max(t["v"])))
        return seen[-1] < 3

    outs = []
    for ctx in (TContext(device="cpu", nparts=P), JContext()):
        seen.clear()
        outs.append(ctx.do_while(ctx.from_columns(cols), body, n_iters=10,
                                 cond=cond).collect())
        assert seen == [1, 2, 3]
    assert np.asarray(outs[0]["v"]).tolist() == [3] * 16
    assert _table_rows(outs[0], ("k", "v")) == _table_rows(outs[1], ("k", "v"))


def test_do_while_guards(devices8):
    t = TContext(device="cpu", nparts=P)
    ds = t.from_columns({"k": np.arange(40, dtype=np.int32),
                         "v": np.arange(40, dtype=np.int32)})
    # the body changes the per-partition capacity (no with_capacity)
    with pytest.raises(ValueError, match="preserve per-partition capacity"):
        t.do_while(ds, lambda d: d.with_capacity(17), n_iters=2)
    with pytest.raises(ValueError, match="max_loop_iterations"):
        t.do_while(ds, lambda d: d, n_iters=1001)


def test_with_capacity_pads_and_refuses_truncation(devices8):
    cols = {"k": np.arange(100, dtype=np.int32)}
    t, j = TContext(device="cpu", nparts=P), JContext()
    padded = t.from_columns(cols).with_capacity(40)
    assert padded._materialize().capacity == 40
    np.testing.assert_array_equal(np.sort(padded.collect()["k"]),
                                  cols["k"])
    # 13 rows a partition, kept to 5: rows would be lost
    with pytest.raises(CapacityError):
        t.from_columns(cols).with_capacity(5).collect()
    with pytest.raises(JCapacityError):
        j.from_columns(cols).with_capacity(5).collect()
    # truncating padding only is fine
    fits = t.from_columns(cols, capacity=30).with_capacity(13)
    assert fits._materialize().capacity == 13
    assert sorted(fits.collect()["k"].tolist()) == list(range(100))


def test_cache_keeps_the_partitioning_claim():
    t = TContext(device="cpu", nparts=P)
    g = _pairs(t).group_by(["k"], {"n": ("count", None)}).cache()
    assert g.node.partitioning.kind == "hash"
    assert g.node.partitioning.keys == ("k",)
    # a group_by on the cached key needs no exchange
    again = g.group_by(["k"], {"m": ("sum", "n")})
    assert not any(leg.exchange for st in again.plan().stages
                   for leg in st.legs)
    assert sum(again.collect()["m"].tolist()) == 400
    assert sum(g.collect()["n"].tolist()) == 400
