"""The port's broadcast exchange (``parallel/shuffle.broadcast_gather``,
ONE ``slot_compact`` over the stacked partitions), ``Dataset.broadcast``,
the broadcast join (``join(broadcast=True)`` and
``JobConfig.broadcast_join_threshold``) and ``cross_apply``, against the
JAX package on its 8-device CPU mesh with the same numpy inputs.

Tolerance: none.  A broadcast's rows compare in order (partition-major,
row order within a partition, in both packages); joins and cross_apply
outputs compare as multisets of whole rows (integer and exactly
representable float data)."""

import collections

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as PS

from dryad_tpu import Context as JContext
from dryad_tpu.data.columnar import Batch as JBatch
from dryad_tpu.exec.executor import _expand, _squeeze
from dryad_tpu.parallel import shuffle as jshuffle
from dryad_tpu.parallel.mesh import PARTITION_AXIS, make_mesh
from dryad_tpu.plan.planner import plan_query as jplan_query
from dryad_tpu.utils.config import JobConfig as JJobConfig
from dryad_tpu_torch import Context as TContext
from dryad_tpu_torch import JobConfig
from dryad_tpu_torch.data.columnar import Batch as TBatch
from dryad_tpu_torch.exec.data import pdata_to_numpy, split_partitions
from dryad_tpu_torch.ops import hopper_kernels as hk
from dryad_tpu_torch.parallel import shuffle
from tests.torch_threads import one_torch_thread  # noqa: F401

P = 8


def _cols(case, rng):
    """Block-partitioned rows (50 a partition) and the filter that thins
    them: every case keeps a ragged count per partition; "empty" leaves
    partition 3 with no row, "strings" carries a string column."""
    n = 400
    cols = {"i": np.arange(n, dtype=np.int32),
            "v": (rng.randint(-1000, 1000, n) / 8).astype(np.float32),
            "w": rng.randint(-2**31, 2**31 - 1, (n, 2)).astype(np.int32)}
    if case == "strings":
        vocab = [b"", b"a", b"\x80\xff", b"key-with-9"] + \
            [b"s%d" % i for i in range(40)]
        cols["s"] = [vocab[j] for j in rng.randint(0, len(vocab), n)]
    return cols


def _keep(case):
    """Row filter by the global row index ``i`` (torch and jax alike):
    the first rows of each partition stay, a different number per
    partition."""
    def keep(c):
        i = c["i"]
        ok = (i % 50) < (i // 50) * 6 + 1
        return ok & (i // 50 != 3) if case == "empty" else ok
    return keep


def _partition_rows(cols, counts):
    """Per partition, the list of its valid rows in order."""
    out = []
    for p in range(len(counts)):
        rows = []
        for r in range(int(counts[p])):
            row = []
            for k in sorted(cols):
                v = cols[k]
                if isinstance(v, tuple):
                    d, ln = v
                    row.append(bytes(d[p, r, :ln[p, r]]))
                else:
                    row.append(v[p, r].tobytes())
            rows.append(tuple(row))
        out.append(rows)
    return out


def _plan(ds):
    """Either package's plan of a dataset, with its context's config."""
    if hasattr(ds, "plan"):
        return ds.plan()
    return jplan_query(ds.node, ds.ctx.nparts, config=ds.ctx.config)


def _jax_broadcast_gather(jpd, out_capacity):
    """The JAX package's broadcast_gather on its mesh: (per-partition
    numpy columns, counts, need)."""
    mesh = make_mesh()

    def per_shard(b):
        out, need, slack = jshuffle.broadcast_gather(_squeeze(b),
                                                     out_capacity)
        return _expand(out), need[None], slack[None]

    fn = jax.jit(jax.shard_map(per_shard, mesh=mesh,
                               in_specs=(PS(PARTITION_AXIS),),
                               out_specs=(PS(PARTITION_AXIS),) * 3,
                               check_vma=False))
    out, need, slack = fn(jpd.batch)
    cols = {k: ((np.asarray(v.data), np.asarray(v.lengths))
                if hasattr(v, "lengths") else np.asarray(v))
            for k, v in out.columns.items()}
    assert not np.asarray(slack).any()
    return cols, np.asarray(out.count), np.asarray(need)


@pytest.mark.parametrize("case,out_cap", [("uniform", 400),
                                          ("empty", 400),
                                          ("strings", 400),
                                          ("uniform", 97),
                                          ("empty", 1)])
def test_broadcast_gather_matches_jax(devices8, monkeypatch, case, out_cap):
    """Every partition gets every partition's valid rows, partition-major
    and in row order, cut to ``out_capacity`` with the total as the need
    when it does not fit — the JAX package's rows, counts and need; ONE
    slot_compact call; every partition the same contiguous tensors."""
    rng = np.random.RandomState(5)
    cols = _cols(case, rng)
    keep = _keep(case)
    jpd = JContext().from_columns(cols, str_max_len=12).where(
        keep)._materialize()
    tpd = TContext(device="cpu", nparts=P).from_columns(
        cols, str_max_len=12).where(keep)._materialize()
    calls = []
    real = hk.slot_compact_batched_plain
    monkeypatch.setattr(hk, "slot_compact_batched_plain",
                        lambda *a: calls.append(a) or real(*a))
    parts, need, slack = shuffle.broadcast_gather(split_partitions(tpd),
                                                  out_cap)
    assert len(calls) == 1
    words, counts, C, out_rows = calls[0]
    assert (words.shape[:2], counts.shape, C, out_rows) == (
        (1, P * tpd.capacity), (1, P), tpd.capacity, out_cap)
    assert int(slack) == 0
    first = parts[0]
    for b in parts:
        assert b is first
    for v in first.columns.values():
        for t in ((v.data, v.lengths) if hasattr(v, "lengths") else (v,)):
            assert t.is_contiguous() and t.shape[0] == out_cap

    jcols, jcounts, jneed = _jax_broadcast_gather(jpd, out_cap)
    tcols = {k: ((np.stack([v.data.numpy()] * P),
                  np.stack([v.lengths.numpy()] * P))
                 if hasattr(v, "lengths") else np.stack([v.numpy()] * P))
             for k, v in first.columns.items()}
    tcounts = np.full(P, int(first.count))
    assert tcounts.tolist() == jcounts.tolist()
    assert [int(need)] * P == jneed.tolist()
    assert _partition_rows(tcols, tcounts) == _partition_rows(jcols, jcounts)
    # the order is the source order: partition-major, then row order
    src_cols, src_counts = pdata_to_numpy(tpd)
    want = [r for rows in _partition_rows(src_cols, src_counts)
            for r in rows]
    total = len(want)
    assert int(need) == (total if total > out_cap else 0)
    assert _partition_rows(tcols, tcounts)[0] == want[:out_cap]
    if case == "empty":
        assert int(src_counts[3]) == 0


@pytest.mark.parametrize("nparts", [1, 8])
def test_dataset_broadcast_matches_jax(devices8, nparts):
    """``broadcast()`` replicates the rows to every partition (a stage of
    its own at P > 1, nothing at P = 1); the collected table is the
    JAX package's, row for row."""
    rng = np.random.RandomState(6)
    cols = _cols("strings", rng)
    keep = _keep("uniform")
    jctx = JContext(mesh=make_mesh(n=nparts))
    tctx = TContext(device="cpu", nparts=nparts)
    jt = jctx.from_columns(cols, str_max_len=12).where(keep).broadcast()
    tt = tctx.from_columns(cols, str_max_len=12).where(keep).broadcast()
    tplan = tt.plan()
    assert [st.label for st in tplan.stages] == \
        [st.label for st in _plan(jt).stages]
    if nparts > 1:
        ex = tplan.stages[0].legs[0].exchange
        assert (ex.kind, ex.out_capacity) == ("broadcast", 50 * nparts)
    assert tt.node.partitioning.kind == "replicated"
    got, want = tt.collect(), jt.collect()
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.asarray(got[k]).tolist() == np.asarray(want[k]).tolist()
    n = int(keep({"i": np.arange(400)}).sum())
    assert len(got["i"]) == n * nparts


def _pairs(ctx, n, seed, cap=None):
    rng = np.random.RandomState(seed)
    return ctx.from_columns({"k": rng.randint(-40, 40, n).astype(np.int32),
                             "x": rng.randint(0, 1000, n).astype(np.int32)},
                            capacity=cap)


def _dim(ctx, dup: bool):
    """A small right side: unique keys -30..29, or with duplicates."""
    k = np.arange(-30, 30, dtype=np.int32)
    if dup:
        k = np.concatenate([k, k[::3]])
    return ctx.from_columns({"k": k, "y": (k * 7 + 1).astype(np.int32)})


def _table_rows(t, cols):
    return collections.Counter(zip(*[np.asarray(t[c]).tolist()
                                     for c in cols]))


def _join_oracle(left, right, how):
    out = collections.Counter()
    for k, x in zip(left["k"].tolist(), left["x"].tolist()):
        ys = [y for rk, y in zip(right["k"].tolist(), right["y"].tolist())
              if rk == k]
        for y in ys:
            out[(k, x, y)] += 1
        if not ys and how == "left":
            out[(k, x, 0)] += 1
    return out


@pytest.mark.parametrize("form", ["flag", "threshold"])
@pytest.mark.parametrize("how", ["inner", "left"])
@pytest.mark.parametrize("dup", [False, True])
def test_broadcast_join_matches_jax(devices8, form, how, dup):
    """The broadcast join equals the JAX package's, the hash-join plan's
    result and a nested-loop oracle as multisets; its plan replicates the
    right leg (exchange kind broadcast, out_capacity = its capacity x P),
    leaves the left leg in place, is never saltable, and keeps the left
    side's placement claim, so a group_by on the left's hash keys after
    it needs no exchange — in both packages."""
    flag = form == "flag"
    # threshold form: the right side's 80 replicated slots against the
    # left's 75 a partition
    tcfg = JobConfig(broadcast_join_threshold=0.0 if flag else 2.0)
    jcfg = JJobConfig(broadcast_join_threshold=0.0 if flag else 2.0)
    res = {}
    for name, ctx in (("port", TContext(device="cpu", nparts=P,
                                        config=tcfg)),
                      ("jax", JContext(config=jcfg))):
        left = _pairs(ctx, 600, 1).hash_partition(["k"])
        q = left.join(_dim(ctx, dup), ["k"], broadcast=flag, how=how,
                      expansion=2.0)
        plan = _plan(q)
        join = [st for st in plan.stages if st.label == "join"][0]
        assert [leg.exchange and (leg.exchange.kind,
                                  leg.exchange.out_capacity)
                for leg in join.legs] == \
            [None, ("broadcast", (10 if dup else 8) * P)]
        assert not join.salt_ok
        g = _plan(q.group_by(["k"], {"n": ("count", None)}))
        assert [st.label for st in g.stages][-2:] == ["join", "output"]
        out = g.stages[-1]
        assert [(leg.exchange, [op.kind for op in leg.ops])
                for leg in out.legs] == [(None, ["group"])]
        res[name] = (q.collect(), [st.label for st in g.stages])
    tout, tlabels = res["port"]
    jout, jlabels = res["jax"]
    assert tlabels == jlabels
    cols = ("k", "x", "y")
    assert _table_rows(tout, cols) == _table_rows(jout, cols)
    t = TContext(device="cpu", nparts=P)
    hashed = _pairs(t, 600, 1).hash_partition(["k"]).join(
        _dim(t, dup), ["k"], how=how, expansion=2.0)
    assert all(leg.exchange is None or leg.exchange.kind == "hash"
               for st in hashed.plan().stages for leg in st.legs)
    assert _table_rows(tout, cols) == _table_rows(hashed.collect(), cols)
    rng = np.random.RandomState(1)
    left = {"k": rng.randint(-40, 40, 600).astype(np.int32),
            "x": rng.randint(0, 1000, 600).astype(np.int32)}
    k = np.arange(-30, 30, dtype=np.int32)
    if dup:
        k = np.concatenate([k, k[::3]])
    assert _table_rows(tout, cols) == _join_oracle(
        left, {"k": k, "y": k * 7 + 1}, how)


def test_broadcast_threshold_only_below_the_ratio():
    """Auto-broadcast only when the right side's replicated capacity is at
    most threshold x the left's: 8 x 8 slots against 75 broadcast, 75 x 8
    do not."""
    t = TContext(device="cpu", nparts=P,
                 config=JobConfig(broadcast_join_threshold=1.0))
    small = _pairs(t, 600, 1).join(_dim(t, False), ["k"]).plan()
    big = _pairs(t, 600, 1).join(_pairs(t, 600, 2), ["k"]).plan()
    kinds = [[leg.exchange and leg.exchange.kind for leg in st.legs]
             for p in (small, big) for st in p.stages
             if st.label == "join"]
    assert kinds == [[None, "broadcast"], ["hash", "hash"]]


def _tfn(b, o):
    """Each left row, with the other side's valid count and the sum of its
    valid ``y`` (torch)."""
    import torch
    s = torch.where(o.valid_mask(), o.columns["y"], 0).sum(dtype=torch.int32)
    return TBatch({"k": b.columns["k"],
                   "z": b.columns["x"] * o.count + s}, b.count)


def _jfn(b, o):
    s = jnp.where(o.valid_mask(), o.columns["y"], 0).sum(dtype=jnp.int32)
    return JBatch({"k": b.columns["k"],
                   "z": b.columns["x"] * o.count + s}, b.count)


@pytest.mark.parametrize("nparts", [1, 8])
def test_cross_apply_matches_jax(devices8, nparts):
    """``cross_apply`` sees the whole right side in every partition: a
    two-leg stage (left in place, right broadcast at P > 1, the body
    ``apply2``), equal to the JAX package's output and to the oracle."""
    outs = []
    for ctx, fn in ((TContext(device="cpu", nparts=nparts), _tfn),
                    (JContext(mesh=make_mesh(n=nparts)), _jfn)):
        left = _pairs(ctx, 500, 2)
        right = _dim(ctx, True).where(lambda c: c["k"] % 2 == 0)
        q = left.cross_apply(right, fn, label="count_right")
        st = _plan(q).stages[0]
        assert st.label == "cross_apply"
        assert [op.kind for op in st.body] == ["apply2"]
        assert st.legs[0].exchange is None
        ex = st.legs[1].exchange
        assert (ex is None) if nparts == 1 else \
            ((ex.kind, ex.out_capacity) == ("broadcast", 10 * nparts))
        assert q.node.partitioning.kind == "none"
        outs.append(q.collect())
    assert _table_rows(outs[0], ("k", "z")) == _table_rows(outs[1],
                                                           ("k", "z"))
    rng = np.random.RandomState(2)
    k = rng.randint(-40, 40, 500).astype(np.int32)
    x = rng.randint(0, 1000, 500).astype(np.int32)
    rk = np.concatenate([np.arange(-30, 30), np.arange(-30, 30)[::3]])
    rk = rk[rk % 2 == 0]
    s = int((rk * 7 + 1).sum())
    assert _table_rows(outs[0], ("k", "z")) == collections.Counter(
        zip(k.tolist(), (x * len(rk) + s).tolist()))
