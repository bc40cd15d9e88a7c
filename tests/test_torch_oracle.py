"""The port's sequential oracle (``oracle.run_oracle``) and
``Context(local_debug=True)``, against the JAX package's oracle on the
same numpy inputs (mirrors ``tests/test_oracle_local_debug.py``'s role:
the reference's LocalDebug runs every query through LINQ-to-objects).

One plan per node kind, Source to CrossApply.  User callables that the
oracle hands columns (select, where, take_while) are written once and run
in both packages (numpy there, CPU tensors here); device callables
(apply_per_partition, cross_apply without host_fn, flat_map, group_apply,
Decomposable) are written once per package.  Integers, keys and strings
compare bit-exact as row multisets (orders as lists where the operator
defines one); f32 values within 16 * 2^-24 * sum|v| of the JAX oracle's.
The local_debug terminals are held to the port's executor on the CPU."""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dryad_tpu import Context as JContext
from dryad_tpu.data.columnar import Batch as JBatch
from dryad_tpu.oracle import run_oracle as jrun_oracle
from dryad_tpu.plan.expr import Decomposable as JDecomposable
from dryad_tpu_torch import Context as TContext
from dryad_tpu_torch import Decomposable, JobConfig
from dryad_tpu_torch import oracle as toracle
from dryad_tpu_torch.data.columnar import Batch
from dryad_tpu_torch.oracle import run_oracle
from tests.torch_threads import one_torch_thread  # noqa: F401

P = 8
EPS = 2.0 ** -24


def _cols(n=200, seed=0):
    rng = np.random.RandomState(seed)
    return {"k": rng.randint(0, 12, n).astype(np.int32),
            "v": rng.randint(-50, 50, n).astype(np.int32),
            "f": (rng.rand(n) * 10).astype(np.float32),
            "s": [b"w%d" % i for i in rng.randint(0, 9, n)]}


def _right(n=60, seed=1):
    rng = np.random.RandomState(seed)
    return {"k2": rng.randint(0, 16, n).astype(np.int32),
            "g": rng.rand(n).astype(np.float32)}


def _lines(n=50, seed=2):
    rng = np.random.RandomState(seed)
    vocab = ["Alpha", "beta", "gamma", "delta,", "eps.", "zeta"]
    return [" ".join(rng.choice(vocab, rng.randint(0, 7))).encode()
            for _ in range(n)]


def _norm(v):
    if isinstance(v, (bytes, str)):
        return v.encode() if isinstance(v, str) else v
    a = np.asarray(v)
    return tuple(a.ravel().tolist()) if a.ndim else a.item()


def _table_rows(t):
    names = sorted(t)
    n = len(next(iter(t.values()))) if t else 0
    return names, [tuple(_norm(t[c][i]) for c in names) for i in range(n)]


def _close(a, b, scale):
    if isinstance(a, float) or isinstance(b, float):
        return abs(a - b) <= 16 * EPS * scale
    if isinstance(a, tuple) and isinstance(b, tuple):
        return len(a) == len(b) and all(_close(x, y, scale)
                                        for x, y in zip(a, b))
    return a == b


def _assert_same(got, want, ordered=False, scale=1.0):
    """Row multisets (or lists) equal: exact but f32 within the bound
    (``scale`` = sum |v| behind the widest float)."""
    gn, grows = _table_rows(got)
    wn, wrows = _table_rows(want)
    assert gn == wn
    assert len(grows) == len(wrows)
    if not ordered:
        grows, wrows = sorted(grows, key=repr), sorted(wrows, key=repr)
    bad = [(g, w) for g, w in zip(grows, wrows) if not _close(g, w, scale)]
    assert not bad, bad[:3]


# -- per-package device callables -----------------------------------------


def _t_pair(c):
    k = c["k"]
    return ({"x": torch.stack([k, k + 1], 1)},
            (k[:, None] + torch.arange(2)[None, :]) % 3 != 0)


def _j_pair(c):
    k = jnp.asarray(c["k"])
    return ({"x": jnp.stack([k, k + 1], 1)},
            (k[:, None] + jnp.arange(2)[None, :]) % 3 != 0)


def _t_top(cols, count):
    v = torch.where(torch.arange(cols["v"].shape[0]) < count, cols["v"],
                    torch.iinfo(torch.int32).min)
    return {"best": v.max()[None]}, torch.ones(1, dtype=torch.bool)


def _j_top(cols, count):
    v = jnp.where(jnp.arange(cols["v"].shape[0]) < count, cols["v"],
                  jnp.iinfo(jnp.int32).min)
    return {"best": v.max()[None]}, jnp.ones(1, dtype=bool)


def _t_dec():
    return Decomposable(seed=lambda c: (c["v"], c["f"]),
                        merge=lambda a, b: (torch.maximum(a[0], b[0]),
                                            a[1] + b[1]),
                        finalize=lambda s: {"vmax": s[0], "fsum": s[1]})


def _j_dec():
    return JDecomposable(seed=lambda c: (c["v"], c["f"]),
                         merge=lambda a, b: (jnp.maximum(a[0], b[0]),
                                             a[1] + b[1]),
                         finalize=lambda s: {"vmax": s[0], "fsum": s[1]})


def _t_tag(b):
    return Batch(dict(b.columns, t=b.columns["k"] * 10 + 1), b.count)


def _j_tag(b):
    return JBatch(dict(b.columns, t=b.columns["k"] * 10 + 1), b.count)


def _t_cross(b, r):
    return Batch(dict(b.columns, rs=b.columns["k"]
                      + r.columns["k2"][:1].to(torch.int32)), b.count)


def _j_cross(b, r):
    return JBatch(dict(b.columns, rs=b.columns["k"]
                       + r.columns["k2"][:1].astype(jnp.int32)), b.count)


def _host_tag(t):
    return dict(t, t=np.asarray(t["k"]) * 10 + 1)


def _host_cross(t, r):
    return dict(t, rs=np.asarray(t["k"]) + np.asarray(r["k2"])[0])


# -- the plans, one per node kind -----------------------------------------

PLANS = {
    "source": lambda d, r, ln, X: d,
    "map": lambda d, r, ln, X: d.select(
        lambda c: {"k": c["k"], "w": c["v"] * 2 + c["k"], "f": c["f"]}),
    "filter": lambda d, r, ln, X: d.where(lambda c: c["v"] > 3),
    "flat_tokens": lambda d, r, ln, X: ln.split_words(
        "line", out_capacity=64, lower=True),
    "apply_host_fn": lambda d, r, ln, X: d.apply_per_partition(
        X["tag"], host_fn=_host_tag),
    "apply_device_fn": lambda d, r, ln, X: d.apply_per_partition(
        X["tag"]),
    "flat_map": lambda d, r, ln, X: d.flat_map(X["pair"],
                                               out_capacity=128),
    "zip": lambda d, r, ln, X: d.zip_with(r),
    "sliding_window": lambda d, r, ln, X: d.select(
        lambda c: {"k": c["k"], "v": c["v"]}).sliding_window(3),
    "with_row_index": lambda d, r, ln, X: d.with_row_index(),
    "assume_partition": lambda d, r, ln, X: d.hash_partition(
        ["k"]).assume_hash_partition(["k"]),
    "skip": lambda d, r, ln, X: d.skip(37),
    "take_while": lambda d, r, ln, X: d.take_while(lambda c: c["v"] > -45),
    "skip_while": lambda d, r, ln, X: d.skip_while(lambda c: c["v"] < 40),
    "group_by": lambda d, r, ln, X: d.group_by(
        ["k"], {"n": ("count", None), "sv": ("sum", "v"),
                "sf": ("sum", "f"), "lo": ("min", "v"), "hi": ("max", "f"),
                "m": ("mean", "f")}),
    "group_by_string": lambda d, r, ln, X: d.group_by(
        ["s"], {"n": ("count", None), "sv": ("sum", "v")}),
    "group_decomposable": lambda d, r, ln, X: d.group_by(
        ["k"], {"a": X["dec"]}),
    "group_apply": lambda d, r, ln, X: d.group_apply(
        ["k"], X["top"], group_capacity=8),
    "group_top_k": lambda d, r, ln, X: d.group_top_k(["k"], 2, "v"),
    "group_median": lambda d, r, ln, X: d.group_median(["k"], "v"),
    "join_inner": lambda d, r, ln, X: d.join(r, ["k"], ["k2"],
                                             expansion=4.0),
    "join_left": lambda d, r, ln, X: d.join(r, ["k"], ["k2"], how="left",
                                            expansion=4.0),
    "join_right": lambda d, r, ln, X: d.join(r, ["k"], ["k2"], how="right",
                                             expansion=4.0),
    "join_full": lambda d, r, ln, X: d.join(r, ["k"], ["k2"], how="full",
                                            expansion=4.0),
    "order_by": lambda d, r, ln, X: d.order_by([("k", True), ("v", False),
                                                ("s", True)]),
    "distinct": lambda d, r, ln, X: d.distinct(["k", "s"]),
    "union": lambda d, r, ln, X: d.select(lambda c: {"k": c["k"]}).union(
        r.select(lambda c: {"k": c["k2"]})),
    "intersect": lambda d, r, ln, X: d.select(
        lambda c: {"k": c["k"]}).intersect(
            r.select(lambda c: {"k": c["k2"]})),
    "except": lambda d, r, ln, X: d.select(lambda c: {"k": c["k"]}).except_(
        r.select(lambda c: {"k": c["k2"]})),
    "concat": lambda d, r, ln, X: d.concat(d.where(lambda c: c["v"] < 0)),
    "hash_partition": lambda d, r, ln, X: d.hash_partition(["s"]),
    "range_partition": lambda d, r, ln, X: d.range_partition(["v"]),
    "broadcast": lambda d, r, ln, X: r.broadcast(),
    "take": lambda d, r, ln, X: d.take(25),
    "with_capacity": lambda d, r, ln, X: d.where(
        lambda c: c["v"] > 0).with_capacity(32),
    "cross_apply_host_fn": lambda d, r, ln, X: d.cross_apply(
        r, X["cross"], host_fn=_host_cross),
    "cross_apply_device_fn": lambda d, r, ln, X: d.cross_apply(
        r, X["cross"]),
}
ORDERED = {"order_by", "with_row_index", "skip", "take_while",
           "skip_while", "zip", "sliding_window", "take", "flat_tokens"}
TX = {"tag": _t_tag, "pair": _t_pair, "top": _t_top, "dec": _t_dec(),
      "cross": _t_cross}
JX = {"tag": _j_tag, "pair": _j_pair, "top": _j_top, "dec": _j_dec(),
      "cross": _j_cross}


def _build(ctx, X):
    return (ctx.from_columns(_cols(), capacity=40),
            ctx.from_columns(_right()),
            ctx.from_columns({"line": _lines()}))


@pytest.mark.parametrize("kind", sorted(PLANS))
def test_oracle_equals_jax_oracle(devices8, kind):
    t = PLANS[kind](*_build(TContext(device="cpu", nparts=P), TX), TX)
    j = PLANS[kind](*_build(JContext(), JX), JX)
    got, want = run_oracle(t.node), jrun_oracle(j.node)
    scale = float(np.abs(_cols()["f"]).sum() + np.abs(_right()["g"]).sum())
    _assert_same(got, want, ordered=kind in ORDERED, scale=scale)


@pytest.mark.parametrize("kind", sorted(PLANS))
def test_local_debug_collect_equals_executor(devices8, kind):
    """``Context(local_debug=True).collect()`` runs the oracle, and equals
    the port's executor on the CPU on every plan."""
    dbg = TContext(device="cpu", nparts=P, local_debug=True)
    ex = TContext(device="cpu", nparts=P)
    got = PLANS[kind](*_build(dbg, TX), TX).collect()
    want = PLANS[kind](*_build(ex, TX), TX).collect()
    scale = float(np.abs(_cols()["f"]).sum() + np.abs(_right()["g"]).sum())
    _assert_same(got, want, ordered=kind in ("order_by", "take"),
                 scale=scale)
    assert dbg.executor.stage_log == [] and dbg.executor.host_reads == 0


@pytest.mark.parametrize("kind", ["apply_device_fn", "cross_apply_device_fn"])
def test_device_udf_goes_through_apply_device_fn(devices8, kind,
                                                 monkeypatch):
    """With no host_fn, the oracle runs the same torch callable on the
    port's CPU Batches (``_apply_device_fn``), even for a cuda-bound
    Context's plan."""
    seen = []
    real = toracle._apply_device_fn

    def spy(fn, tables, with_index=False):
        out = real(fn, tables, with_index)
        seen.append(fn)
        return out

    monkeypatch.setattr(toracle, "_apply_device_fn", spy)
    ctx = TContext(device="cpu", nparts=P, local_debug=True)
    out = PLANS[kind](*_build(ctx, TX), TX).collect()
    assert seen == [TX["tag"] if kind == "apply_device_fn"
                    else TX["cross"]]
    assert len(out["k"]) == 200


def test_apply_with_index_sees_partition_zero(devices8):
    ctx = TContext(device="cpu", nparts=P, local_debug=True)
    out = ctx.from_columns(_cols()).apply_with_partition_index(
        lambda b, i: Batch(dict(b.columns, p=b.columns["k"] * 0 + i),
                           b.count)).collect()
    assert set(out["p"].tolist()) == {0}


# -- the terminal calls under local_debug ----------------------------------


def _pair_ctx():
    return (TContext(device="cpu", nparts=P, local_debug=True),
            TContext(device="cpu", nparts=P))


def test_local_debug_count_and_scalars(devices8):
    dbg, ex = _pair_ctx()
    cols = _cols()
    d, e = dbg.from_columns(cols), ex.from_columns(cols)
    assert d.where(lambda c: c["v"] > 0).count() == \
        e.where(lambda c: c["v"] > 0).count()
    assert d.count() == e.count() == 200
    for kind, col in (("sum", "v"), ("min", "v"), ("max", "f"),
                      ("any", "v"), ("all", "v")):
        assert getattr(d, kind)(col) == getattr(e, kind)(col), kind
    assert abs(d.sum("f") - e.sum("f")) <= 16 * EPS * np.abs(
        cols["f"]).sum()
    assert abs(d.mean("f") - e.mean("f")) <= 16 * EPS * np.abs(
        cols["f"]).mean()
    assert _norm(d.first()["s"]) == _norm(e.first()["s"])


def test_local_debug_cache_and_do_while(devices8):
    """``cache`` keeps the oracle's table on the host; ``do_while`` runs
    the body plan through the oracle with the loop's table bound, and
    ``cond`` stops it; both equal the executor's."""
    def body(ds):
        return ds.select(lambda c: {"k": c["k"], "v": c["v"] + c["k"]}) \
            .with_capacity(32)

    def cond(t):
        return int(np.asarray(t["v"]).max()) < 90

    outs = []
    for ctx in _pair_ctx():
        base = ctx.from_columns(
            {"k": np.arange(40, dtype=np.int32) % 7,
             "v": np.arange(40, dtype=np.int32)}, capacity=32)
        cached = base.where(lambda c: c["v"] % 2 == 0).cache()
        loop = ctx.do_while(cached, body, n_iters=10, cond=cond)
        outs.append((cached.collect(), loop.collect(), loop.count()))
    (c1, l1, n1), (c2, l2, n2) = outs
    _assert_same(c1, c2)
    _assert_same(l1, l2)
    assert n1 == n2 == 20 and int(np.asarray(l1["v"]).max()) >= 90


def test_local_debug_read_text(devices8, tmp_path):
    """read_text keeps the lines as host bytes only under local_debug;
    WordCount over them equals the executor's."""
    from dryad_tpu_torch.apps.wordcount import wordcount_query
    path = tmp_path / "t.txt"
    path.write_bytes(b"\n".join(_lines(300)) + b"\n")
    dbg, ex = _pair_ctx()
    ds_d, ds_e = dbg.read_text(str(path)), ex.read_text(str(path))
    assert ds_d.node.host is not None and ds_e.node.host is None
    assert ds_d.node.host["line"] == _lines(300)
    got = wordcount_query(ds_d, tokens_per_partition=512).collect()
    want = wordcount_query(ds_e, tokens_per_partition=512).collect()
    _assert_same(got, want)


def test_from_columns_keeps_a_reference(devices8):
    """The oracle's host table is the caller's columns, never a copy."""
    cols = _cols()
    ds = TContext(device="cpu", nparts=P).from_columns(cols)
    assert all(ds.node.host[k] is cols[k] for k in cols)


def test_local_debug_sources_stay_on_the_contexts_device(devices8):
    ctx = TContext(device="cpu", nparts=P, local_debug=True,
                   config=JobConfig())
    ds = ctx.from_columns(_cols())
    assert ds.node.data.batch.count.device.type == "cpu"
    assert collections.Counter(ds.collect()["k"].tolist()) == \
        collections.Counter(_cols()["k"].tolist())


def test_oracle_udfs_get_copies(devices8):
    """A select fn that works in place changes neither the caller's
    columns nor what another consumer of the same node reads."""
    cols = _cols()
    before = cols["v"].copy()
    ctx = TContext(device="cpu", nparts=P, local_debug=True)
    base = ctx.from_columns(cols)

    def bump(c):
        c["v"].add_(1000)
        return {"v": c["v"]}

    out = base.select(bump).concat(base.select(lambda c: {"v": c["v"]}))
    got = np.sort(out.collect()["v"])
    assert np.array_equal(cols["v"], before)
    assert np.array_equal(got, np.sort(np.concatenate([before + 1000,
                                                       before])))
