"""The port's remaining single-input operators against the JAX package on
its 8-device CPU mesh with the same numpy inputs (mirrors
``tests/test_operators_ext.py``): ``flat_map`` (``ops/kernels.
flat_map_expand``) with its overflow retry, ``sliding_window`` (the halo
taken from the next partition) for w = 1, 4 and 7 and its unscalable
shortfall, ``apply_per_partition`` with and without
``preserves_partitioning``, ``apply_with_partition_index``, ``fork_by`` /
``fork`` / ``fork_on`` over one materialized parent, and
``assume_hash_partition`` skipping the exchange.  Plans compare with the
JAX planner's ``explain``.

Tolerance: none.  Values are carried, never computed: outputs compare
exactly, in global row order where the operator defines one (sliding
windows, the partition-index tag) and as multisets of rows elsewhere."""

import collections

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from dryad_tpu import Context as JContext
from dryad_tpu.exec.executor import CapacityError as JCapacityError
from dryad_tpu.plan.planner import plan_query as jplan_query
from dryad_tpu_torch import Context as TContext
from dryad_tpu_torch.exec.executor import CapacityError
from tests.torch_threads import one_torch_thread  # noqa: F401

P = 8


def _cols(n=100, seed=0):
    rng = np.random.RandomState(seed)
    return {"k": rng.randint(0, 10, n).astype(np.int32),
            "v": rng.randn(n).astype(np.float32),
            "i": np.arange(n, dtype=np.int32)}


def _np(t):
    return {k: (v if isinstance(v, list) else np.asarray(v))
            for k, v in t.items()}


def _rows(t):
    names = sorted(t)
    cols = [[bytes(x) for x in t[c]] if isinstance(t[c], list)
            else np.asarray(t[c]).tolist() for c in names]
    return collections.Counter(zip(*cols))


def _both(tquery, jquery, n=100, seed=0, capacity=32):
    """(port context, port table, JAX table)."""
    t = TContext(device="cpu", nparts=P)
    got = tquery(t.from_columns(_cols(n, seed), capacity=capacity))
    want = jquery(JContext().from_columns(_cols(n, seed), capacity=capacity))
    return t, _np(got.collect()), _np(want.collect())


def _same_plan(tds, jds):
    assert tds.explain() == jplan_query(jds.node, P).explain()


# -- flat_map --------------------------------------------------------------


def t_expand(cols):
    """Row r becomes k % 3 rows tagged 0, 1, ... (the JAX test's fn)."""
    k = cols["k"]
    tags = torch.arange(3)[None, :].expand(k.shape[0], 3)
    return ({"k": k[:, None].expand(-1, 3), "tag": tags,
             "i": cols["i"][:, None].expand(-1, 3)},
            tags < (k % 3)[:, None])


def j_expand(cols):
    k = cols["k"]
    tags = jnp.broadcast_to(jnp.arange(3)[None, :], (k.shape[0], 3))
    return ({"k": jnp.broadcast_to(k[:, None], (k.shape[0], 3)), "tag": tags,
             "i": jnp.broadcast_to(cols["i"][:, None], (k.shape[0], 3))},
            tags < (k % 3)[:, None])


@pytest.mark.parametrize("out_capacity", [128, 6])
def test_flat_map(devices8, out_capacity):
    """Rows in row-major order within each partition; an out_capacity
    below a partition's rows retries once at the measured scale."""
    t, got, want = _both(lambda d: d.flat_map(t_expand, out_capacity),
                         lambda d: d.flat_map(j_expand, out_capacity))
    for c in want:
        np.testing.assert_array_equal(got[c], want[c], err_msg=c)
    c = _cols()
    reps = c["k"] % 3
    np.testing.assert_array_equal(got["i"], np.repeat(c["i"], reps))
    np.testing.assert_array_equal(
        got["tag"], np.concatenate([np.arange(r) for r in reps]))
    (st,) = t.executor.stage_log
    assert st["attempts"] == (1 if out_capacity == 128 else 2)


def test_flat_map_strings_and_claim(devices8):
    """A string column flattens with its lengths; flat_map drops the hash
    claim, so a group-by after it exchanges again (as in JAX)."""
    words = [f"w{i % 7}".encode() * (1 + i % 3) for i in range(60)]

    def cols(c):
        return c.from_columns({"s": words,
                               "n": np.arange(60, dtype=np.int32) % 3},
                              capacity=16)

    def tq(c):
        def fn(x):
            s = x["s"]
            m = (torch.arange(2)[None, :] <= x["n"][:, None])
            L = s.data.shape[1]
            return ({"s": type(s)(s.data[:, None].expand(-1, 2, L),
                                  s.lengths[:, None].expand(-1, 2))}, m)
        return cols(c).hash_partition(["s"]).flat_map(fn, 64).group_by(
            ["s"], {"c": ("count", None)})

    def jq(c):
        def fn(x):
            s = x["s"]
            m = jnp.arange(2)[None, :] <= x["n"][:, None]
            return ({"s": type(s)(
                jnp.broadcast_to(s.data[:, None], (s.data.shape[0], 2,
                                                   s.data.shape[1])),
                jnp.broadcast_to(s.lengths[:, None],
                                 (s.data.shape[0], 2)))}, m)
        return cols(c).hash_partition(["s"]).flat_map(fn, 64).group_by(
            ["s"], {"c": ("count", None)})

    t, j = TContext(device="cpu", nparts=P), JContext()
    assert _rows(tq(t).collect()) == _rows(jq(j).collect())
    _same_plan(tq(t), jq(j))
    assert tq(t).explain().count("=>hash") == 2
    want = collections.Counter()
    for i, w in enumerate(words):
        want[w] += min(i % 3, 1) + 1
    assert dict(_rows(tq(t).collect())) == {
        (c, w): 1 for w, c in want.items()}


# -- sliding_window --------------------------------------------------------


@pytest.mark.parametrize("w", [1, 4, 7])
def test_sliding_window(devices8, w):
    """Every window of w consecutive rows in global row order, N - w + 1
    of them, the halo taken from the next partition; padding never enters
    a window."""
    def q(d):
        return d.where(lambda c: c["k"] != 3).select(
            lambda c: {"v": c["v"], "i": c["i"]}).sliding_window(w)

    _, got, want = _both(q, q)
    for c in want:
        assert got[c].shape == want[c].shape
        np.testing.assert_array_equal(got[c], want[c], err_msg=c)
    c = _cols()
    keep = c["k"] != 3
    np.testing.assert_array_equal(
        got["i"], np.lib.stride_tricks.sliding_window_view(c["i"][keep], w))
    np.testing.assert_array_equal(
        got["v"], np.lib.stride_tricks.sliding_window_view(c["v"][keep], w))


def test_sliding_window_short_next_partition_raises(devices8):
    """A partition whose next partition holds fewer than w - 1 rows cannot
    take its halo: an unscalable shortfall in both packages, raised at
    once (no retry)."""
    def q(d):
        return d.where(lambda c: c["i"] % 13 < 2).sliding_window(4)

    t = TContext(device="cpu", nparts=P)
    with pytest.raises(CapacityError, match="sliding_window"):
        q(t.from_columns(_cols(), capacity=32)).collect()
    with pytest.raises(JCapacityError):
        q(JContext().from_columns(_cols(), capacity=32)).collect()
    # the same windows fit when every next partition holds the halo
    _, got, want = _both(lambda d: d.where(
        lambda c: c["i"] % 13 < 3).sliding_window(4),
        lambda d: d.where(lambda c: c["i"] % 13 < 3).sliding_window(4))
    np.testing.assert_array_equal(got["i"], want["i"])


# -- apply_per_partition ----------------------------------------------------


@pytest.mark.parametrize("preserves", [False, True])
def test_apply_per_partition(devices8, preserves):
    """A user Batch -> Batch fn on every partition; the hash claim carries
    over only when the fn says it preserves it, so the group-by after it
    exchanges (or not) as in JAX."""
    def tfn(b):
        return b.with_columns({"w": b.columns["v"] * 2})

    def jfn(b):
        return b.with_columns({"w": b.columns["v"] * 2})

    def q(d, fn):
        return d.hash_partition(["k"]).apply_per_partition(
            fn, preserves_partitioning=preserves).group_by(
            ["k"], {"n": ("count", None), "m": ("max", "w")})

    t, got, want = _both(lambda d: q(d, tfn), lambda d: q(d, jfn))
    assert _rows(got) == _rows(want)
    tds = q(t.from_columns(_cols(), capacity=32), tfn)
    _same_plan(tds, q(JContext().from_columns(_cols(), capacity=32), jfn))
    assert tds.explain().count("=>hash") == (1 if preserves else 2)


def test_apply_with_partition_index(devices8):
    """fn(batch, partition_index): each row tagged with its partition, in
    order, as in JAX; after a hash repartition the tag is lo(hash) % P."""
    def tfn(b, idx):
        return b.with_columns({"part": torch.full((b.capacity,), idx,
                                                  dtype=torch.int32)})

    def jfn(b, idx):
        return b.with_columns({"part": jnp.full((b.capacity,), idx,
                                                jnp.int32)})

    _, got, want = _both(lambda d: d.apply_with_partition_index(tfn),
                         lambda d: d.apply_with_partition_index(jfn))
    for c in want:
        np.testing.assert_array_equal(got[c], want[c], err_msg=c)
    assert set(got["part"].tolist()) == set(range(P))
    t, got, want = _both(
        lambda d: d.hash_partition(["k"]).apply_with_partition_index(tfn),
        lambda d: d.hash_partition(["k"]).apply_with_partition_index(jfn))
    assert _rows(got) == _rows(want)
    from dryad_tpu_torch.ops.hashing import hash_columns
    lo = hash_columns([torch.from_numpy(got["k"])])[1].numpy()
    np.testing.assert_array_equal(got["part"], lo % P)


# -- fork -------------------------------------------------------------------


def _shared(d):
    """The forked parent: a labelled select, so its stage is findable."""
    return d.select(lambda c: {"k": c["k"], "v": c["v"] * 2},
                    label="shared_scan")


def _stages_running(ds, label):
    return [s for s in ds.plan().stages
            if any(o.params.get("label") == label
                   for leg in s.legs for o in leg.ops)]


FORKS = {
    "fork_by": lambda d: (lambda t, f: t.concat(f))(
        *_shared(d).fork_by(lambda c: c["v"] > 0)),
    "fork3": lambda d: (lambda a, b, c: a.concat(b).concat(c))(
        *_shared(d).fork(lambda c: c["k"] < 3, lambda c: c["k"] >= 7,
                         lambda c: c["v"] > 1.0)),
    "fork_on": lambda d: (lambda a, b, c: a.concat(b).concat(c))(
        *[x.group_by(["k"], {"n": ("count", None)})
          for x in _shared(d).fork_on("k", [1, 4, 8])]),
}


@pytest.mark.parametrize("name", sorted(FORKS))
def test_fork_materializes_parent_once(devices8, name):
    """Each branch is a where over the one shared parent; the planner's
    consumer count materializes the parent ONCE (one tee stage), and the
    rows and the plan are the JAX package's."""
    t, got, want = _both(FORKS[name], FORKS[name])
    assert _rows(got) == _rows(want)
    tds = FORKS[name](t.from_columns(_cols(), capacity=32))
    _same_plan(tds, FORKS[name](JContext().from_columns(_cols(),
                                                         capacity=32)))
    tees = _stages_running(tds, "shared_scan")
    assert len(tees) == 1 and tees[0].label.startswith("tee")
    c = _cols()
    if name == "fork_by":
        assert sorted(got["k"].tolist()) == sorted(c["k"].tolist())
    if name == "fork_on":
        assert dict(zip(got["k"].tolist(), got["n"].tolist())) == {
            k: int((c["k"] == k).sum()) for k in (1, 4, 8)}


# -- assume_hash_partition ---------------------------------------------------


def test_assume_hash_partition_skips_exchange(devices8):
    """Data placed by a hash repartition, reloaded without its claim, then
    declared: the group-by plans and runs with no exchange and counts
    right."""
    t = TContext(device="cpu", nparts=P)
    pre = t.from_columns(_cols(), capacity=32).hash_partition(
        ["k"])._materialize()
    loaded = t.from_pdata(pre)
    g = loaded.assume_hash_partition(["k"]).group_by(["k"],
                                                     {"n": ("count", None)})
    assert "=>hash" not in g.explain()
    out = g.collect()
    assert not any(s["exchange"] for s in t.executor.stage_log)
    ref = collections.Counter(_cols()["k"].tolist())
    assert dict(zip(out["k"].tolist(), out["n"].tolist())) == dict(ref)
    unclaimed = loaded.group_by(["k"], {"n": ("count", None)})
    assert unclaimed.explain().count("=>hash") == 1
    j = JContext()
    jpre = j.from_pdata(j.from_columns(_cols(), capacity=32).hash_partition(
        ["k"])._materialize())
    _same_plan(g, jpre.assume_hash_partition(["k"]).group_by(
        ["k"], {"n": ("count", None)}))
