"""The port's general per-group result selector, ``Dataset.group_apply``
(``ops/kernels.group_regroup_apply``, mapped over groups with
``torch.func.vmap``), against the JAX package on its 8-device CPU mesh
with the same numpy inputs (mirrors ``tests/test_group_apply.py``): a
non-decomposable reduction (second largest), multi-row output, each of
the three measured needs retrying (max groups, group size, output rows),
a vector column, a string key, and a prior hash claim skipping the
exchange.

Tolerance: none.  Outputs compare as multisets of whole rows: integer,
string and f32 values are carried, never computed, so they are exact;
the JAX package leaves the output's row order unspecified."""

import collections

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from dryad_tpu import Context as JContext
from dryad_tpu_torch import Context as TContext
from dryad_tpu_torch.data.columnar import Batch, StringColumn
from dryad_tpu_torch.ops import kernels as tkern
from tests.torch_threads import one_torch_thread  # noqa: F401

P = 8


def _cols(n=100, seed=0, nkeys=10):
    rng = np.random.RandomState(seed)
    return {"k": rng.randint(0, nkeys, n).astype(np.int32),
            "v": rng.randint(-50, 50, n).astype(np.int32),
            "f": rng.randn(n).astype(np.float32)}


def _rows(t):
    """Multiset of a collected table's rows, columns in sorted order (a
    vector column's row as a tuple)."""
    names = sorted(t)
    cols = []
    for c in names:
        v = t[c]
        if isinstance(v, list):
            cols.append([bytes(x) for x in v])
        else:
            a = np.asarray(v)
            cols.append([tuple(r) for r in a.tolist()] if a.ndim > 1
                        else a.tolist())
    return collections.Counter(zip(*cols))


def _both(tquery, jquery, cols, capacity=64):
    """(port rows, JAX rows, port context) of the queries on ``cols``."""
    t = TContext(device="cpu", nparts=P)
    got = tquery(t.from_columns(cols, capacity=capacity)).collect()
    want = jquery(JContext().from_columns(cols, capacity=capacity)).collect()
    return _rows(got), _rows(want), t


def _stage(ctx, label="group_apply"):
    (st,) = [s for s in ctx.executor.stage_log if s["label"] == label]
    return st


# -- the per-group functions, in each package's array library ------------


def t_second_largest(cols, count):
    v = cols["v"]
    masked = torch.where(torch.arange(v.shape[0]) < count, v,
                         torch.iinfo(torch.int32).min)
    s = torch.sort(masked, descending=True).values
    return ({"second": torch.where(count >= 2, s[1], s[0])[None]},
            torch.ones(1, dtype=torch.bool))


def j_second_largest(cols, count):
    v = cols["v"]
    masked = jnp.where(jnp.arange(v.shape[0]) < count, v,
                       jnp.iinfo(jnp.int32).min)
    s = jnp.sort(masked)[::-1]
    return ({"second": jnp.where(count >= 2, s[1], s[0])[None]},
            jnp.ones((1,), jnp.bool_))


def t_top3(cols, count):
    """Up to 3 rows a group: the top-3 v with their f (ties by row)."""
    v = cols["v"]
    C = v.shape[0]
    masked = torch.where(torch.arange(C) < count, v,
                         torch.iinfo(torch.int32).min)
    take = torch.argsort(masked, stable=True).flip(0)[:3]
    return ({"v": v[take], "f": cols["f"][take]},
            torch.arange(3) < torch.clamp(count, max=3))


def j_top3(cols, count):
    v = cols["v"]
    C = v.shape[0]
    masked = jnp.where(jnp.arange(C) < count, v, jnp.iinfo(jnp.int32).min)
    take = jnp.argsort(masked)[::-1][:3]
    return ({"v": v[take], "f": cols["f"][take]},
            jnp.arange(3) < jnp.minimum(count, 3))


def test_second_largest(devices8):
    """A NON-decomposable per-group reduction."""
    got, want, _ = _both(
        lambda d: d.group_apply(["k"], t_second_largest, group_capacity=64),
        lambda d: d.group_apply(["k"], j_second_largest, group_capacity=64),
        _cols())
    assert got == want
    c = _cols()
    true = {int(k): int(np.sort(c["v"][c["k"] == k])[::-1][1])
            for k in np.unique(c["k"])}
    assert {k: s for k, s in got} == true


def test_multi_row_output(devices8):
    """out_rows = 3: each group emits min(count, 3) rows, equal as a
    multiset to the JAX package's and to the port's group_top_k (the
    values are distinct within most groups; ties pick equal v)."""
    got, want, t = _both(
        lambda d: d.group_apply(["k"], t_top3, group_capacity=64,
                                out_rows=3),
        lambda d: d.group_apply(["k"], j_top3, group_capacity=64,
                                out_rows=3), _cols())
    assert got == want
    top = t.from_columns(_cols(), capacity=64).group_top_k(
        ["k"], 3, "v").collect()
    assert sorted((k, v) for _f, k, v in got) == sorted(
        zip(top["k"].tolist(), top["v"].tolist()))


# need -> (group_apply arguments, the partition-level quantity it bounds)
NEEDS = {
    # ~40 rows a group against 4
    "group_capacity": dict(nkeys=3, n=120, kw=dict(group_capacity=4)),
    # ~10 groups a partition against 2
    "max_groups": dict(nkeys=10, n=100, kw=dict(group_capacity=64,
                                                max_groups=2)),
    # 3 rows a group, ~10 groups a partition, against 4 output rows
    "out_capacity": dict(nkeys=10, n=100, kw=dict(group_capacity=64,
                                                  out_rows=3,
                                                  out_capacity=4)),
}


@pytest.mark.parametrize("need", sorted(NEEDS))
def test_capacity_retry_each_need(devices8, need):
    """A capacity below the partition's measured need retries ONCE at the
    measured scale (never truncates), and the result is the JAX
    package's."""
    spec = NEEDS[need]
    cols = _cols(spec["n"], nkeys=spec["nkeys"])
    fns = (t_top3, j_top3) if need == "out_capacity" else (
        t_second_largest, j_second_largest)
    got, want, t = _both(
        lambda d: d.group_apply(["k"], fns[0], **spec["kw"]),
        lambda d: d.group_apply(["k"], fns[1], **spec["kw"]), cols)
    assert got == want
    st = _stage(t)
    assert st["attempts"] == 2 and st["scale"] > 1
    # the measured need, scaled: the largest partition's groups, group or
    # output rows over the declared bound
    recv = np.asarray(st["recv_rows"][0])
    assert recv.sum() == spec["n"]
    if need == "group_capacity":
        biggest = max(collections.Counter(cols["k"].tolist()).values())
        assert st["scale"] == -(-biggest // 4)


def test_max_groups_smaller_than_groups(devices8):
    """max_groups 1 against every key: the retry sizes the regroup for the
    most groups any partition holds; rows equal the JAX package's and the
    numpy second-largest."""
    cols = _cols(200, seed=3, nkeys=40)
    got, want, t = _both(
        lambda d: d.group_apply(["k"], t_second_largest, group_capacity=64,
                                max_groups=1),
        lambda d: d.group_apply(["k"], j_second_largest, group_capacity=64,
                                max_groups=1), cols, capacity=64)
    assert got == want and len(got) == len(np.unique(cols["k"]))
    st = _stage(t)
    assert st["attempts"] == 2 and st["scale"] > 1


def test_vector_column(devices8):
    """A [n, 3] column rides the regroup; fn emits each group's row with
    the largest v, vector and all."""
    rng = np.random.RandomState(5)
    cols = dict(_cols(96, seed=5, nkeys=7),
                vec=rng.randn(96, 3).astype(np.float32))

    def t_fn(c, count):
        v = torch.where(torch.arange(c["v"].shape[0]) < count, c["v"],
                        torch.iinfo(torch.int32).min)
        i = torch.argmax(v)
        return {"v": v[i][None], "vec": c["vec"][i][None]}, \
            torch.ones(1, dtype=torch.bool)

    def j_fn(c, count):
        v = jnp.where(jnp.arange(c["v"].shape[0]) < count, c["v"],
                      jnp.iinfo(jnp.int32).min)
        i = jnp.argmax(v)
        return {"v": v[i][None], "vec": c["vec"][i][None]}, \
            jnp.ones((1,), jnp.bool_)

    got, want, _ = _both(lambda d: d.group_apply(["k"], t_fn, 32),
                         lambda d: d.group_apply(["k"], j_fn, 32), cols)
    assert got == want and len(got) == 7


def test_string_key(devices8):
    """Groups keyed by a string column: the key's bytes come back on every
    emitted row."""
    words = [f"w{i % 9:02d}".encode() for i in range(90)]
    cols = {"s": words, "v": np.arange(90, dtype=np.int32) * 7 % 61}

    def t_fn(c, count):
        v = torch.where(torch.arange(c["v"].shape[0]) < count, c["v"], -1)
        return {"top": torch.max(v)[None], "n": count[None]}, \
            torch.ones(1, dtype=torch.bool)

    def j_fn(c, count):
        v = jnp.where(jnp.arange(c["v"].shape[0]) < count, c["v"], -1)
        return {"top": jnp.max(v)[None], "n": count[None]}, \
            jnp.ones((1,), jnp.bool_)

    got, want, _ = _both(lambda d: d.group_apply(["s"], t_fn, 16),
                         lambda d: d.group_apply(["s"], j_fn, 16), cols,
                         capacity=16)
    assert got == want
    assert sorted(n for n, _s, _t in got) == [10] * 9


@pytest.mark.parametrize("claim", ["hash_partition", "assume"])
def test_prior_hash_claim_skips_exchange(devices8, claim):
    """After a hash repartition on the key (or a claim of one on data so
    placed), group_apply runs with no exchange of its own, relying on the
    placement; the rows equal the unclaimed query's and JAX's."""
    def tq(d, fn):
        h = d.hash_partition(["k"])
        if claim == "assume":
            h = h.select(lambda c: dict(c)).assume_hash_partition(["k"])
        return h.group_apply(["k"], fn, group_capacity=64)

    got, want, t = _both(lambda d: tq(d, t_second_largest),
                         lambda d: tq(d, j_second_largest), _cols())
    assert got == want
    plain, _, _ = _both(
        lambda d: d.group_apply(["k"], t_second_largest, 64),
        lambda d: d.group_apply(["k"], j_second_largest, 64), _cols())
    assert got == plain
    ds = tq(t.from_columns(_cols(), capacity=64), t_second_largest)
    assert ds.explain().count("=>hash") == 1
    graph = ds.plan()
    assert [s.label for s in graph.stages] == ["hashpartition", "output"]
    assert graph.stages[0].placement_relied
    assert not any(s["label"] == "group_apply"
                   for s in t.executor.stage_log)


def test_regroup_kernel_needs_and_order(devices8):
    """The kernel alone on one partition: the three measured needs, the
    output capacity min(out_capacity, G * out_rows), and the emitted rows
    in group order then row order."""
    k = torch.tensor([3, 1, 3, 2, 3, 1, 0, 0], dtype=torch.int32)
    v = torch.arange(8, dtype=torch.int32)
    b = Batch({"k": k, "v": v}, torch.tensor(7, dtype=torch.int32))

    def fn(c, count):
        return {"v": c["v"][:2]}, torch.arange(2) < count

    out, ng, ms, tot = tkern.group_regroup_apply(b, ["k"], fn, 8, 2, 2, 5)
    # groups 3 (3 rows), 1 (2), 2 (1), 0 (1): 2 + 2 + 1 + 1 rows emitted
    assert (int(ng), int(ms), int(tot)) == (4, 3, 6)
    assert out.capacity == 5 and int(out.count) == 5
    out2, _, _, tot2 = tkern.group_regroup_apply(b, ["k"], fn, 3, 8, 2, 100)
    assert out2.capacity == 6 and int(out2.count) == int(tot2)
    n2 = int(out2.count)
    got = list(zip(out2.columns["k"][:n2].tolist(),
                   out2.columns["v"][:n2].tolist()))
    # three of the four groups fit, in group order, each its first rows
    # in row order
    firsts = {0: [6], 1: [1, 5], 2: [3], 3: [0, 2]}
    keys = list(dict.fromkeys(k for k, _ in got))
    assert len(keys) == 3
    assert got == [(k, v) for k in keys for v in firsts[k]]
    s = StringColumn(torch.zeros(8, 4, dtype=torch.uint8),
                     torch.ones(8, dtype=torch.int32))
    bs = Batch({"s": s, "v": v}, torch.tensor(8, dtype=torch.int32))
    o3, ng3, *_ = tkern.group_regroup_apply(
        bs, ["s"], lambda c, n: ({"n": n[None]},
                                 torch.ones(1, dtype=torch.bool)), 4, 8, 1,
        4)
    assert int(ng3) == 1 and o3.columns["n"][0] == 8
    assert isinstance(o3.columns["s"], StringColumn)
