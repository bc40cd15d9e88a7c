"""The TeraSort slice end to end: the app and the sort family through the
port's user entry points (``dryad_tpu_torch``, device="cpu", nparts=8 —
every kernel wrapper runs its plain version) against the JAX package on
its 8-device CPU mesh and against Python / numpy oracles, at a few
thousand rows.

Tolerance: none.  Sorted outputs match in order; the per-partition row
counts of a range-exchanged result match the JAX package's (they hold
its sampled bounds and its range exchange together); the group-contents
results match as multisets of whole rows."""

import collections

import numpy as np
import pytest

from dryad_tpu import Context as JContext
from dryad_tpu.apps import terasort as jts
from dryad_tpu_torch import Context as TContext
from dryad_tpu_torch.apps import terasort as tts
from dryad_tpu_torch.exec.data import pdata_to_numpy

P = 8


def _tctx():
    return TContext(device="cpu", nparts=P)


def _counts_j(ds):
    return np.asarray(ds._materialize().counts).tolist()


def _counts_t(ds):
    return pdata_to_numpy(ds._materialize())[1].tolist()


def _exchanges(ds):
    return sum(leg.exchange is not None for st in ds.plan().stages
               for leg in st.legs)


def test_terasort_matches_oracle_and_jax(devices8):
    n = 3000
    recs = tts.gen_records(n)
    jrecs = jts.gen_records(n)
    assert recs["key"] == jrecs["key"]
    np.testing.assert_array_equal(recs["payload"], jrecs["payload"])
    want = sorted(zip(recs["key"], recs["payload"].tolist()))
    tctx = _tctx()
    tout = tts.terasort(tctx, n)
    assert list(zip(tout["key"], tout["payload"].tolist())) == want
    jout = jts.terasort(JContext(), n)
    assert tout["key"] == jout["key"]
    np.testing.assert_array_equal(tout["payload"], jout["payload"])
    # the plan: a materialized input, then one range exchange + sort
    log = [(s["label"], s["exchange"]) for s in tctx.executor.stage_log]
    assert log == [("sort-input", None), ("orderby", "range")]
    # same bounds, same exchange: the same rows in every partition
    tq = tts.terasort_query(tctx.from_columns(recs, str_max_len=10))
    jq = jts.terasort_query(JContext().from_columns(jrecs, str_max_len=10))
    assert _counts_t(tq) == _counts_j(jq)


def _mk(ctx, n=200, seed=0, cap=64):
    """tests/test_query_e2e.py's data."""
    rng = np.random.RandomState(seed)
    cols = {"k": rng.randint(0, 12, n).astype(np.int32),
            "v": rng.randn(n).astype(np.float32),
            "w": rng.randint(0, 5, n).astype(np.int32)}
    return ctx.from_columns(cols, capacity=cap), cols


ORDERS = {
    "v": [("v", False)],
    "k_desc_v": [("k", True), ("v", False)],
    "w_k_desc_v_desc": [("w", False), ("k", True), ("v", True)],
    "v_desc": [("v", True)],
}


@pytest.mark.parametrize("case", list(ORDERS))
def test_order_by_matches_jax(devices8, case):
    keys = ORDERS[case]
    tds, cols = _mk(_tctx())
    jds, _ = _mk(JContext())
    tout = tds.order_by(keys).collect()
    jout = jds.order_by(keys).collect()
    for c in ("k", "v", "w"):
        np.testing.assert_array_equal(tout[c], np.asarray(jout[c]))
    sk = tuple((-cols[c].astype(np.float64) if d else cols[c])
               for c, d in reversed(keys))
    order = np.lexsort(sk)
    for c in ("k", "v", "w"):
        np.testing.assert_array_equal(tout[c], cols[c][order])
    assert _counts_t(tds.order_by(keys)) == _counts_j(jds.order_by(keys))


def test_skewed_order_by_retries_and_is_right(devices8):
    """12 primary-key values over 20,000 rows: the range exchange sends a
    tie run to one destination, which overflows its receive capacity;
    the stage runs again at the measured scale and the result is
    right."""
    rng = np.random.RandomState(11)
    n = 20_000
    cols = {"k": rng.randint(0, 12, n).astype(np.int32),
            "v": rng.randint(0, 1000, n).astype(np.int32)}
    tctx = _tctx()
    tout = tctx.from_columns(cols).order_by(
        [("k", False), ("v", True)]).collect()
    (ob,) = [s for s in tctx.executor.stage_log if s["label"] == "orderby"]
    assert ob["attempts"] >= 2 and ob["scale"] >= 2
    order = np.lexsort((-cols["v"], cols["k"]))
    np.testing.assert_array_equal(tout["k"], cols["k"][order])
    np.testing.assert_array_equal(tout["v"], cols["v"][order])
    jout = JContext().from_columns(cols).order_by(
        [("k", False), ("v", True)]).collect()
    np.testing.assert_array_equal(tout["v"], np.asarray(jout["v"]))


def test_range_partition_and_assume_order_by_elide_the_exchange(devices8):
    """order_by on a prefix of the claimed ascending range keys plans no
    exchange; a descending key or a key beyond the claim keeps it."""
    tds, cols = _mk(_tctx())
    plain = tds.order_by([("v", False)])
    rp = tds.range_partition(["v"])
    elided = rp.order_by([("v", False)])
    assert _exchanges(plain) == 1
    assert _exchanges(elided) == _exchanges(rp) == 1
    assert _exchanges(rp.order_by([("v", True)])) == 2
    assert _exchanges(rp.order_by([("v", False), ("k", False)])) == 2
    # the stage whose placement the elision trusted is marked
    graph = elided.plan()
    assert [st.placement_relied for st in graph.stages] == \
        [False, True, False]
    want = np.sort(cols["v"])
    np.testing.assert_array_equal(elided.collect()["v"], want)
    np.testing.assert_array_equal(plain.collect()["v"], want)
    # a claim over already sorted data: one local sort, no exchange
    srt, _ = _mk(_tctx())
    claimed = srt.order_by([("v", False)]).assume_order_by(["v", "k"])
    again = claimed.order_by([("v", False)])
    assert _exchanges(again) == _exchanges(claimed) == 1
    np.testing.assert_array_equal(again.collect()["v"], want)
    jds, _ = _mk(JContext())
    jout = jds.range_partition(["v"]).order_by([("v", False)]).collect()
    np.testing.assert_array_equal(elided.collect()["v"],
                                  np.asarray(jout["v"]))
    assert _counts_t(rp) == _counts_j(jds.range_partition(["v"]))


@pytest.mark.parametrize("n", [17, 0, 500])
def test_order_by_take_matches_jax(devices8, n):
    tds, cols = _mk(_tctx())
    jds, _ = _mk(JContext())
    keys = [("k", True), ("v", False)]
    tout = tds.order_by(keys).take(n).collect()
    jout = jds.order_by(keys).take(n).collect()
    assert len(tout["v"]) == min(n, 200)
    for c in ("k", "v", "w"):
        np.testing.assert_array_equal(tout[c], np.asarray(jout[c]))


def test_take_keeps_the_first_rows_in_partition_order():
    tds, cols = _mk(_tctx(), n=200, cap=64)
    out = tds.take(30).collect()
    np.testing.assert_array_equal(out["v"], cols["v"][:30])


def _multiset(table, cols):
    return collections.Counter(zip(*[np.asarray(table[c]).tolist()
                                     for c in cols]))


def test_distinct_group_top_k_group_median_match_jax(devices8):
    rng = np.random.RandomState(12)
    n = 3000
    cols = {"k": rng.randint(0, 60, n).astype(np.int32),
            "v": rng.randint(0, 40, n).astype(np.int32),
            "row": np.arange(n, dtype=np.int32)}
    tds = _tctx().from_columns(cols)
    jds = JContext().from_columns(cols)
    tout = tds.distinct(["k"]).collect()
    jout = jds.distinct(["k"]).collect()
    assert _multiset(tout, cols) == _multiset(jout, cols)
    first = {}
    for i, k in enumerate(cols["k"].tolist()):
        first.setdefault(k, i)
    assert dict(zip(tout["k"].tolist(), tout["row"].tolist())) == first
    tout = tds.group_top_k(["k"], 3, "v").collect()
    jout = jds.group_top_k(["k"], 3, "v").collect()
    assert _multiset(tout, cols) == _multiset(jout, cols)
    tout = tds.group_median(["k"], "v").collect()
    jout = jds.group_median(["k"], "v").collect()
    assert _multiset(tout, ("k", "v")) == _multiset(jout, ("k", "v"))
    for k, v in zip(tout["k"].tolist(), tout["v"].tolist()):
        g = np.sort(cols["v"][cols["k"] == k])
        assert v == g[(len(g) - 1) // 2]
    # already hash-placed by k: no second exchange
    hk = tds.hash_partition(["k"])
    assert _exchanges(hk.group_top_k(["k"], 3, "v")) == 1
    assert _exchanges(hk.distinct(["k"])) == 1
    assert _exchanges(tds.distinct(["k"])) == 1


def test_one_partition_plans_no_exchange():
    ctx = TContext(device="cpu", nparts=1)
    rng = np.random.RandomState(13)
    cols = {"k": rng.randint(0, 9, 300).astype(np.int32),
            "v": rng.randint(0, 99, 300).astype(np.int32)}
    ds = ctx.from_columns(cols)
    q = ds.order_by([("k", True), ("v", False)])
    assert _exchanges(q) == 0
    out = q.collect()
    order = np.lexsort((cols["v"], -cols["k"]))
    np.testing.assert_array_equal(out["v"], cols["v"][order])
    assert _exchanges(ds.range_partition(["k"])) == 0
    assert _exchanges(ds.distinct(["k"]).group_median(["k"], "v")) == 0


@pytest.mark.parametrize("name", ["terasort1m", "orderby_desc2m", "topk10k",
                                  "distinct10k"])
def test_chip_smoke_sort_oracles(name):
    """chip_smoke.py's phase 6 oracles, at a small size on the CPU: they
    accept the port's output and reject it with two rows swapped (or one
    value changed), and the per-exchange check holds launches to the
    executor's attempts, retries included."""
    import chip_smoke
    from dryad_tpu_torch.apps import groupbyreduce as tgbr
    (data, sml), queries, check = chip_smoke.sort_runs(
        tts, tgbr, 2_000, 4_000)[name]
    ctx = _tctx()
    ds = ctx.from_columns(data, str_max_len=sml)
    outs, stages = [], []
    for q in queries:
        outs.append(q(ds).collect())
        stages += chip_smoke.exchanging_stages([ctx.executor.stage_log])
    sizes = check(outs, data)
    assert sizes["rows"] == len(data["key" if "key" in data else "k"])
    bad = [dict(o) for o in outs]
    col = "payload" if name == "terasort1m" else "v"
    v = np.array(bad[0][col])
    v[[0, -1]] = v[[-1, 0]] if v[0] != v[-1] else (v[0] + 1, v[-1])
    bad[0][col] = v
    with pytest.raises(AssertionError):
        check(bad, data)
    attempts = sum(st["retries"] + 1 for st in stages)
    launches = {"hist_buckets": attempts, "slot_expand": attempts,
                "slot_compact": attempts}
    chip_smoke.check_per_exchange(name, launches, attempts)
    with pytest.raises(AssertionError):
        chip_smoke.check_per_exchange(name, launches, attempts + 1)
