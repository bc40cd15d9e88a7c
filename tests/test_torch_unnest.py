"""The unnest-and-regroup slice as a whole: chip_smoke.py's phase-10
queries (orders with their lineitems nested, hash-repartitioned,
unnested by ``flat_map``, claimed hash-placed, net added per partition,
then each order's top two lines by ``group_apply``, TPC-H Q1's shape over
``fork_on`` branches, a 7-row ``sliding_window`` over ship order, the
partition-index tag) through the port and through the JAX package on its
8-device CPU mesh with the same numpy orders, and a CPU rehearsal of
phase 10 itself (its oracles, its launch accounting with the slot probe
apart, its cold / warm slot sources).

Tolerance: the top-two rows, the windows, counts and integer sums
exactly (values are carried, or integer); f32 sums within 16 x 2^-24 x
sum|v| of the group (the mean within that over its count), as PERF.md §2
states, between the two packages and against numpy."""

import collections

import numpy as np
import pytest

import jax.numpy as jnp

import chip_smoke as cs
import dryad_tpu_torch
from dryad_tpu import Context as JContext
from dryad_tpu_torch import Context as TContext
from dryad_tpu_torch import JobConfig
from dryad_tpu_torch.ops import hopper_kernels as hk
from test_torch_pagerank import _counting_plain

P = 8
EPS = 2.0 ** -24


def _rows(t):
    names = sorted(t)
    return collections.Counter(zip(*[np.asarray(t[c]).tolist()
                                     for c in names]))


# -- the JAX package's form of each phase-10 query ---------------------------


def j_unnest(c):
    okey = c["okey"]
    n = okey.shape[0]
    line = jnp.arange(1, cs.LINES + 1, dtype=jnp.int32)
    out = {"okey": jnp.broadcast_to(okey[:, None], (n, cs.LINES)),
           "line": jnp.broadcast_to(line[None, :], (n, cs.LINES))}
    out.update({k: c[k] for k in cs.LINE_COLS})
    return out, line[None, :] <= c["nlines"][:, None]


def j_add_net(b):
    return b.with_columns({"net": b.columns["price"]
                           * (1 - b.columns["disc"])})


def j_top2(cols, count):
    net, line = cols["net"], cols["line"]
    valid = jnp.arange(net.shape[0]) < count
    top = jnp.lexsort((line, jnp.where(valid, -net, jnp.inf)))[:2]
    return ({k: v[top] for k, v in cols.items() if k != "okey"},
            jnp.arange(2) < count)


def j_lineitems(ctx, orders, claim=True):
    n = len(orders["okey"])
    li = ctx.from_columns(orders).hash_partition(["okey"]).flat_map(
        j_unnest, cs.li_capacity(n))
    if claim:
        li = li.assume_hash_partition(["okey"])
    return li.apply_per_partition(j_add_net, preserves_partitioning=True)


def j_queries(orders):
    n = len(orders["okey"])

    def q1(ctx):
        branches = j_lineitems(ctx, orders).fork_on("flag", [0, 1, 2])
        outs = [b.group_by(["status"], cs.Q1_AGGS).select(
            lambda c, f=f: dict(c, flag=jnp.full_like(c["status"], f)))
            for f, b in enumerate(branches)]
        return outs[0].concat(outs[1]).concat(outs[2]).collect()

    return {
        "unnest": lambda ctx: j_lineitems(ctx, orders).group_apply(
            ["okey"], j_top2, group_capacity=8, out_rows=2,
            max_groups=cs.max_groups(n)).collect(),
        "unnest_shuffled": lambda ctx: j_lineitems(
            ctx, orders, False).group_apply(
            ["okey"], j_top2, group_capacity=8, out_rows=2,
            max_groups=cs.max_groups(n)).collect(),
        "q1fork": q1,
        "window": lambda ctx: j_lineitems(ctx, orders).select(
            lambda c: {k: c[k] for k in ("shipdate", "okey", "line",
                                         "net")}).order_by(
            [("shipdate", False), ("okey", False),
             ("line", False)]).sliding_window(cs.LINES).collect(),
    }


def t_queries(orders):
    return {
        "unnest": lambda ctx: cs.unnest_query(ctx, orders, True),
        "unnest_shuffled": lambda ctx: cs.unnest_query(ctx, orders, False),
        "q1fork": lambda ctx: cs.q1fork_query(ctx, orders),
        "window": lambda ctx: cs.window_query(ctx, orders, True),
    }


@pytest.mark.parametrize("name", ["unnest", "unnest_shuffled", "q1fork",
                                  "window"])
def test_slice_matches_jax(devices8, name):
    """Each phase-10 query at 2,000 orders: the port's result is the JAX
    package's (top two lines as row multisets, windows in order, Q1's
    counts and integer sums exactly and its f32 sums within the group
    bound of each other)."""
    orders = cs.nested_orders(2000, seed=1)
    got = t_queries(orders)[name](TContext(device="cpu", nparts=P))
    want = j_queries(orders)[name](JContext())
    got = {k: np.asarray(v) for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    assert sorted(got) == sorted(want)
    if name == "window":
        for c in want:
            np.testing.assert_array_equal(got[c], want[c], err_msg=c)
        return
    if name != "q1fork":
        assert _rows(got) == _rows(want)
        return
    og = np.lexsort((got["status"], got["flag"]))
    ow = np.lexsort((want["status"], want["flag"]))
    for c in ("flag", "status", "count_order", "sum_qty"):
        np.testing.assert_array_equal(got[c][og], want[c][ow], err_msg=c)
    li = cs.flat_lineitems(orders)
    for c, src in (("sum_base_price", "price"), ("sum_disc_price", "net"),
                   ("avg_disc", "disc")):
        for i, j in zip(og, ow):
            g = ((li["flag"] == got["flag"][i])
                 & (li["status"] == got["status"][i]))
            bound = 16 * EPS * np.abs(li[src][g].astype(np.float64)).sum()
            if c == "avg_disc":
                bound /= g.sum()
            assert abs(float(got[c][i]) - float(want[c][j])) <= bound, c


LABELS = ["unnest6m", "unnest6m_shuffled", "q1fork6m", "window6m",
          "partidx6m"]


@pytest.mark.parametrize("label", LABELS)
def test_chip_smoke_phase10_rehearsal(devices8, monkeypatch, label):
    """chip_smoke.py's phase 10 at 20,000 orders on the CPU (the probe's
    threshold at 0 MB, so the orders repartition probes at this size):
    each oracle accepts the cold run (the probe's slot) and the warm run
    in the same context (the feedback slot) and rejects a changed value;
    every kernel the run must launch rises, and the launches match the
    executor's log with the probe's hist_buckets apart."""
    _counting_plain(monkeypatch)
    orders = cs.nested_orders(20_000)
    li = cs.flat_lineitems(orders)
    app, warm_app, check, must = cs.phase10_runs(orders, li)[label]
    ctx = TContext(device="cpu", nparts=P,
                   config=JobConfig(exchange_probe_min_mb=0))
    out, launches, load, query, runs = cs.run_app(
        dryad_tpu_torch, hk, app, device="cpu", ctx=ctx)
    assert all(launches[k] > 0 for k in must) and load > 0 and query > 0
    st = cs.loop_stages(runs)
    assert st["probes"] == 1
    cs.check_per_exchange(label, launches, st["exchange_attempts"],
                          st["broadcast_attempts"], st["probes"])
    with pytest.raises(AssertionError):
        cs.check_per_exchange(label, launches, st["exchange_attempts"],
                              st["broadcast_attempts"], 0)
    sizes = check(out, runs, False)
    assert sizes
    col = next(c for c in sorted(out) if c != "okey")
    bad = dict(out, **{col: np.asarray(out[col]) + 1})
    with pytest.raises(AssertionError):
        check(bad, runs, False)
    if warm_app is None:
        return
    wout, wl, _, _, wruns = cs.run_app(dryad_tpu_torch, hk, warm_app,
                                       device="cpu", ctx=ctx)
    check(wout, wruns, True)
    assert cs.loop_stages(wruns)["probes"] == 0
    with pytest.raises(AssertionError):
        check(wout, runs, True)   # the cold log shows the probe
