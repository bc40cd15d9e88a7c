"""The port's hot-key-salted join exchange
(``parallel/shuffle.skew_join_exchange`` with ``_left_heavy_hitters``)
and the executor's salting policy, against the JAX package on its
8-device CPU mesh with the same numpy inputs (mirrors
``tests/test_skew.py``).

Tolerance: none.  The hot set compares as a set of lo-hashes (ties among
equal candidate counts pick any of them in both packages); exchanged rows
compare per destination as multisets of whole rows, with equal counts and
needs; query results compare as multisets of integer rows."""

import collections

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as PS

from dryad_tpu import Context as JContext
from dryad_tpu.exec.executor import _squeeze
from dryad_tpu.ops.hashing import hash_batch_keys as jhash_batch_keys
from dryad_tpu.parallel import shuffle as jshuffle
from dryad_tpu.parallel.mesh import PARTITION_AXIS, make_mesh
from dryad_tpu_torch import Context as TContext
from dryad_tpu_torch.exec.data import split_partitions
from dryad_tpu_torch.ops.hashing import hash_batch_keys
from dryad_tpu_torch.parallel import shuffle
from tests.torch_threads import one_torch_thread  # noqa: F401

P = 8


def _skewed(n=40_000, hot_frac=0.9, seed=0):
    """``tests/test_skew.py``'s data: hot_frac of the keys 0, the rest
    uniform over [1, 1000)."""
    rng = np.random.default_rng(seed)
    k = np.where(rng.random(n) < hot_frac, 0,
                 rng.integers(1, 1000, n)).astype(np.int32)
    v = rng.integers(0, 10, n).astype(np.int32)
    return k, v


def _keys(case, n=4000, seed=1):
    """Left keys for the hot-set cases, 500 a partition: one 90 %-hot
    key; a moderate skew; no skew.  In the moderate case key 1 has 250
    rows in each even partition (1000 in all); key 2 has 185 in each of
    partitions 0-3 and 5 in each of 4-7, where keys 3 (100) and 100 + p
    (145) rank above it.  Against a share of 500 rows a partition, a
    factor of 1.5 (750 rows) makes key 1 hot, and key 2 hot only when
    partitions 4-7 nominate it too (topk 8: 760 rows; topk 2: the 740
    rows of the partitions that nominated it)."""
    rng = np.random.RandomState(seed)
    if case == "one_hot":
        return np.where(rng.rand(n) < 0.9, 7,
                        rng.randint(0, 500, n)).astype(np.int32)
    k = rng.randint(1000, 100_000, n).astype(np.int32)
    if case == "moderate":
        blk = n // P
        for p in range(P):
            b = p * blk
            if p % 2 == 0:
                k[b:b + 250] = 1
            if p < 4:
                k[b + 250:b + 435] = 2
            else:
                k[b + 250:b + 255] = 2
                k[b + 255:b + 355] = 3
                k[b + 355:b + 500] = 100 + p
    return k


# (case, topk, factor) -> how many distinct keys are hot
HOT_KEYS = {("one_hot", 8, 4.0): 1, ("one_hot", 2, 1.5): 1,
            ("one_hot", 8, 1.5): 1, ("moderate", 8, 4.0): 0,
            ("moderate", 2, 1.5): 1, ("moderate", 8, 1.5): 2,
            ("uniform", 8, 4.0): 0, ("uniform", 2, 1.5): 0,
            ("uniform", 8, 1.5): 0}


def _jax_shard(fn, *pds, n_out):
    mesh = make_mesh()
    f = jax.jit(jax.shard_map(
        lambda *bs: fn(*[_squeeze(b) for b in bs]), mesh=mesh,
        in_specs=(PS(PARTITION_AXIS),) * len(pds),
        out_specs=(PS(PARTITION_AXIS),) * n_out, check_vma=False))
    return f(*[pd.batch for pd in pds])


@pytest.mark.parametrize("case,topk,factor", sorted(HOT_KEYS))
def test_left_heavy_hitters_matches_jax(devices8, case, topk, factor):
    """The hot lo-hashes equal the JAX package's, as a set, and are as
    many as the keys that the data makes hot."""
    cols = {"k": _keys(case)}
    jpd = JContext().from_columns(cols)._materialize()
    tpd = TContext(device="cpu", nparts=P).from_columns(cols)._materialize()

    def per_shard(b):
        _, lo = jhash_batch_keys(b, ["k"])
        cand, hot = jshuffle._left_heavy_hitters(
            lo, b.valid_mask(), (PARTITION_AXIS,), topk, factor)
        return cand[None], hot[None]

    jcand, jhot = _jax_shard(per_shard, jpd, n_out=2)
    jcand, jhot = np.asarray(jcand)[0], np.asarray(jhot)[0]
    parts = split_partitions(tpd)
    cand, hot = shuffle._left_heavy_hitters(
        torch.stack([hash_batch_keys(b, ["k"])[1] for b in parts]),
        torch.stack([b.valid_mask() for b in parts]), topk, factor)
    got = set(cand[hot].tolist())
    want = set(int(x) for x in jcand[jhot].astype(np.uint32))
    assert got == want
    assert len(got) == HOT_KEYS[case, topk, factor]


def _rows(cols, count):
    """Multiset of one partition's valid rows."""
    names = sorted(cols)
    return collections.Counter(zip(*[np.asarray(cols[k])[:count].tolist()
                                     for k in names]))


@pytest.mark.parametrize("hot_frac", [0.9, 0.3, 0.0])
def test_skew_join_exchange_matches_jax(devices8, hot_frac):
    """Per destination, the left and right rows and counts and the needs
    equal the JAX package's ``skew_join_exchange`` under ``shard_map``;
    every (left, right) pair with equal keys meets exactly once."""
    k, v = _skewed(n=4000, hot_frac=hot_frac, seed=2)
    rk = np.arange(1000, dtype=np.int32)
    lcols = {"k": k, "v": v}
    rcols = {"k": rk, "w": rk * 3 + 1}
    lcap, rcap = 1500, 200
    jctx, tctx = JContext(), TContext(device="cpu", nparts=P)
    jl, jr = (jctx.from_columns(c)._materialize() for c in (lcols, rcols))
    tl, tr = (tctx.from_columns(c)._materialize() for c in (lcols, rcols))

    def per_shard(lb, rb):
        lo, ro, lnr, rnr, nsl = jshuffle.skew_join_exchange(
            lb, rb, ["k"], ["k"], lcap, rcap)
        return (lo.columns["k"][None], lo.columns["v"][None],
                lo.count[None], ro.columns["k"][None],
                ro.columns["w"][None], ro.count[None], lnr[None],
                rnr[None], nsl[None])

    j = [np.asarray(x) for x in _jax_shard(per_shard, jl, jr, n_out=9)]
    lout, rout, lnr, rnr, nsl = shuffle.skew_join_exchange(
        split_partitions(tl), split_partitions(tr), ["k"], ["k"], lcap, rcap)
    assert [int(b.count) for b in lout] == j[2].tolist()
    assert [int(b.count) for b in rout] == j[5].tolist()
    assert rout[0].capacity == 2 * rcap
    assert ([int(lnr)] * P, [int(rnr)] * P, [int(nsl)] * P) == \
        (j[6].tolist(), j[7].tolist(), j[8].tolist())
    for p in range(P):
        assert _rows({"k": lout[p].columns["k"], "v": lout[p].columns["v"]},
                     int(lout[p].count)) == \
            _rows({"k": j[0][p], "v": j[1][p]}, int(j[2][p]))
        assert _rows({"k": rout[p].columns["k"], "w": rout[p].columns["w"]},
                     int(rout[p].count)) == \
            _rows({"k": j[3][p], "w": j[4][p]}, int(j[5][p]))
    # every left row meets its one right row on exactly one partition
    if int(lnr) == 0:
        met = collections.Counter()
        for p in range(P):
            rkeys = set(rout[p].columns["k"][:int(rout[p].count)].tolist())
            for key in lout[p].columns["k"][:int(lout[p].count)].tolist():
                met[key] += key in rkeys
        assert met == collections.Counter(k.tolist())


def _join_query(ctx, k, v, w_of):
    right = ctx.from_columns({"k": np.arange(1000, dtype=np.int32),
                              "w": w_of(np.arange(1000, dtype=np.int32))})
    return ctx.from_columns({"k": k, "v": v}).join(right, ["k"], ["k"])


def _join_log(ctx):
    (st,) = [s for s in ctx.executor.stage_log if s["label"] == "join"]
    return st


def test_hot_key_join_salts_instead_of_scaling(devices8):
    """A 90 %-hot join key switches the stage to the salted exchange at
    the second attempt; every row matches, as in the JAX package."""
    k, v = _skewed()
    t = TContext(device="cpu", nparts=P)
    out = _join_query(t, k, v, lambda x: x * 3).collect()
    assert len(out["k"]) == len(k)
    assert (np.asarray(out["w"]) == np.asarray(out["k"]) * 3).all()
    st = _join_log(t)
    assert st["salted"] and st["attempts"] == 2 and st["salted_attempts"] == 1
    jout = _join_query(JContext(), k, v, lambda x: x * 3).collect()
    cols = ("k", "v", "w")
    assert collections.Counter(zip(*[out[c].tolist() for c in cols])) == \
        collections.Counter(zip(*[np.asarray(jout[c]).tolist()
                                  for c in cols]))


def test_95pct_hot_join_capacity_stays_near_balanced(devices8):
    """A 95 %-hot key over 8 partitions: the final capacity is ~N/P per
    partition, not ~N, and every partition receives fewer than 2N/P
    left rows."""
    n = 40_000
    k, v = _skewed(n=n, hot_frac=0.95, seed=3)
    t = TContext(device="cpu", nparts=P)
    out = _join_query(t, k, v, lambda x: x + 5).collect()
    assert len(out["k"]) == n
    assert (np.asarray(out["w"]) == np.asarray(out["k"]) + 5).all()
    st = _join_log(t)
    assert st["salted"]
    assert st["scale"] * (n // P) < n / 2, st
    left_recv = st["recv_rows"][0]
    assert sum(left_recv) == n and max(left_recv) < 2 * n / P, st


def test_relied_placement_does_not_salt(devices8):
    """A join whose placement a shuffle-free group_by trusts never salts:
    it scales instead, and the group result stays exact, as in the JAX
    package."""
    k, v = _skewed(n=20_000, hot_frac=0.9, seed=5)

    def q(ctx):
        right = ctx.from_columns({"k": np.arange(1000, dtype=np.int32),
                                  "w": np.ones(1000, np.int32)})
        joined = ctx.from_columns({"k": k, "v": v}).join(right, ["k"])
        return joined.group_by(["k"], {"s": ("sum", "v")})

    t = TContext(device="cpu", nparts=P)
    assert q(t).explain().count("=>hash") == 2
    out = q(t).collect()
    got = dict(zip(out["k"].tolist(), out["s"].tolist()))
    assert got == {int(kk): int(v[k == kk].sum()) for kk in np.unique(k)}
    st = _join_log(t)
    assert not st["salted"] and st["attempts"] == 2
    assert not any(s["salted"] for s in t.executor.stage_log)
    jout = q(JContext()).collect()
    assert got == dict(zip(np.asarray(jout["k"]).tolist(),
                           np.asarray(jout["s"]).tolist()))


def test_join_output_shortfall_scales_not_salts(devices8):
    """Uniform keys with many matches each: the join's OUTPUT overflows
    (16 right rows a key: a need of 4x or more, past the salting
    trigger),
    its exchanges fit (room for every row), so the stage scales once;
    the salting trigger reads the exchanges' need only."""
    rng = np.random.RandomState(4)
    k = rng.randint(0, 10, 800).astype(np.int32)

    def q(ctx):
        right = ctx.from_columns(
            {"k": np.repeat(np.arange(10, dtype=np.int32), 16),
             "w": np.arange(160, dtype=np.int32)}, capacity=160)
        return ctx.from_columns({"k": k, "v": np.arange(800, dtype=np.int32)},
                                capacity=800).join(right, ["k"])

    t = TContext(device="cpu", nparts=P)
    got = q(t).collect()
    st = _join_log(t)
    assert not st["salted"] and st["attempts"] == 2
    assert st["scale"] >= t.config.salt_trigger_factor
    assert len(got["k"]) == 16 * len(k)
    cols = ("k", "v", "w")
    jout = q(JContext()).collect()
    assert collections.Counter(zip(*[got[c].tolist() for c in cols])) == \
        collections.Counter(zip(*[np.asarray(jout[c]).tolist()
                                  for c in cols]))


def test_salted_is_sticky_across_runs(devices8):
    """A plan run twice: the second run starts salted and fits at once."""
    k, v = _skewed(n=20_000, seed=6)
    t = TContext(device="cpu", nparts=P)
    graph = _join_query(t, k, v, lambda x: x).plan()
    counts = []
    for _ in range(2):
        pd = t.executor.run(graph)
        counts.append(int(pd.counts.sum()))
        st = _join_log(t)
        assert st["salted"]
        counts.append(st["attempts"])
    assert counts == [len(k), 2, len(k), 1]


def test_salted_cache_drops_partitioning_claim(devices8):
    """A cached result of a salted run claims no hash placement, so a
    later group_by keeps its exchange and stays exact."""
    k, v = _skewed(n=20_000, hot_frac=0.9, seed=9)
    t = TContext(device="cpu", nparts=P)
    cached = _join_query(t, k, v, lambda x: x).cache()
    q = cached.group_by(["k"], {"s": ("sum", "v")})
    assert "=>hash" in q.explain()
    out = q.collect()
    assert dict(zip(out["k"].tolist(), out["s"].tolist())) == \
        {int(kk): int(v[k == kk].sum()) for kk in np.unique(k)}


@pytest.mark.parametrize("label", ["skewjoin6m", "skewjoin6m_relied",
                                   "q13_outer", "zip6m"])
def test_chip_smoke_phase9_rehearsal(devices8, monkeypatch, label):
    """chip_smoke.py's phase 9 runs at 120,000 lineitems on the CPU: each
    oracle accepts the port's result (the join stage salted or not as
    predicted) and rejects a changed one; every kernel the run must
    launch rises, and the launches match the executor's log of hash
    exchanges and broadcasts (a salted attempt's hot-row broadcast
    among them)."""
    import chip_smoke
    import dryad_tpu_torch
    from dryad_tpu_torch.ops import hopper_kernels as hk
    from test_torch_pagerank import _counting_plain
    _counting_plain(monkeypatch)
    app, check, rows, must = chip_smoke.phase9_runs(
        *chip_smoke.tpch_tables(120_000))[label]
    out, launches, load, query, runs = chip_smoke.run_app(
        dryad_tpu_torch, hk, app, device="cpu")
    assert all(launches[k] > 0 for k in must) and load > 0 and query > 0
    st = chip_smoke.loop_stages(runs)
    chip_smoke.check_per_exchange(label, launches, st["exchange_attempts"],
                                  st["broadcast_attempts"])
    sizes = check(out, runs)
    if label == "skewjoin6m":
        assert st["broadcast_attempts"] == 1 and sizes["join_salted"]
        with pytest.raises(AssertionError):
            chip_smoke.check_per_exchange(label, launches,
                                          st["exchange_attempts"], 0)
    first = next(iter(out))
    t = out[first]
    col = next(c for c in t if c not in ("custkey", "okey"))
    bad = dict(out, **{first: dict(t, **{col: np.asarray(t[col]) + 1})})
    with pytest.raises(AssertionError):
        check(bad, runs)
