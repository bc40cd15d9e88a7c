"""The port's hash exchange (dryad_tpu_torch/parallel/shuffle.py, which
runs the hist_buckets, prefix_sum, slot_expand and slot_compact wrappers)
against the JAX exchange on the 8-device CPU mesh, through
``hash_partition`` in both packages.  Tolerance: none — every
destination partition must hold the same multiset of rows and the same
count (the order inside a partition is unspecified in both)."""

import collections

import numpy as np
import pytest

from dryad_tpu import Context as JContext
from dryad_tpu.exec.data import pdata_to_host as j_to_host
from dryad_tpu_torch import Context as TContext
from dryad_tpu_torch.exec.data import (pdata_from_numpy, pdata_to_host,
                                       pdata_to_numpy, split_partitions,
                                       stack_partitions)
from dryad_tpu_torch.parallel import shuffle

P = 8


def _rows_per_partition(cols, counts):
    """[P] multisets of row tuples from pdata_to_numpy-layout columns."""
    out = []
    for p in range(len(counts)):
        n = int(counts[p])
        rows = []
        for i in range(n):
            row = []
            for k in sorted(cols):
                v = cols[k]
                if isinstance(v, tuple):
                    d, l = v
                    row.append(bytes(d[p, i, :l[p, i]]))
                else:
                    row.append(v[p, i].tobytes())
            rows.append(tuple(row))
        out.append(collections.Counter(rows))
    return out


def _jax_numpy(pd):
    cols = {}
    for k, v in pd.batch.columns.items():
        cols[k] = ((np.asarray(v.data), np.asarray(v.lengths))
                   if hasattr(v, "lengths") else np.asarray(v))
    return cols, np.asarray(pd.batch.count)


def _data(kind, n, rng):
    if kind == "skew":
        # every row one key: one destination needs n > capacity rows, and
        # one source's send slot overflows (both NEED channels)
        return {"k": np.full(n, 7, np.int32),
                "v": rng.randn(n).astype(np.float32)}
    words = [b"w%d" % i for i in range(400)]
    return {"k": rng.randint(-1000, 1000, n).astype(np.int32),
            "s": [words[i] for i in rng.randint(0, 400, n)],
            "v": rng.randn(n).astype(np.float32)}


@pytest.mark.parametrize("kind,keys", [("uniform", ["k"]),
                                       ("uniform", ["s"]),
                                       ("uniform", ["s", "k"]),
                                       ("skew", ["k"])])
def test_hash_partition_matches_jax(devices8, kind, keys):
    rng = np.random.RandomState(3)
    n = 1_600
    cols = _data(kind, n, rng)
    jpd = (JContext().from_columns(cols, str_max_len=8)
           .hash_partition(keys)._materialize())
    tpd = (TContext(device="cpu", nparts=P).from_columns(cols, str_max_len=8)
           .hash_partition(keys)._materialize())
    jrows = _rows_per_partition(*_jax_numpy(jpd))
    trows = _rows_per_partition(*pdata_to_numpy(tpd))
    assert [sum(c.values()) for c in trows] == \
        [sum(c.values()) for c in jrows]
    assert trows == jrows
    assert sum(sum(c.values()) for c in trows) == n


def test_exchange_on_jax_state(devices8):
    """State carried over from a JAX PData (its numpy leaves) goes
    through the port's exchange with the same result, and round-trips."""
    rng = np.random.RandomState(5)
    cols = _data("uniform", 1_000, rng)
    jsrc = JContext().from_columns(cols, str_max_len=8)
    jcols, jcounts = _jax_numpy(jsrc.node.data)
    tpd = pdata_from_numpy(jcols, jcounts, "cpu")
    back, bcounts = pdata_to_numpy(tpd)
    np.testing.assert_array_equal(bcounts, jcounts)
    for k in jcols:
        if isinstance(jcols[k], tuple):
            for a, b in zip(back[k], jcols[k]):
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(back[k], jcols[k])
    parts, need_recv, need_slack, _ = shuffle.hash_exchange(
        split_partitions(tpd), ["s"], out_capacity=tpd.capacity * 2)
    assert int(need_recv) == 0 and int(need_slack) == 0
    jout = jsrc.hash_partition(["s"])._materialize()
    tout = stack_partitions(parts)
    assert _rows_per_partition(*pdata_to_numpy(tout)) == \
        _rows_per_partition(*_jax_numpy(jout))
    assert sorted(map(tuple, zip(*[pdata_to_host(tout)[k]
                                   for k in ("s", "k")]))) == \
        sorted(map(tuple, zip(*[j_to_host(jout)[k] for k in ("s", "k")])))


def test_exchange_needs_are_measured():
    """A too-small receive capacity reports the rows it needs; a send
    slot overflow reports the slack factor that would fit, and only the
    rows that fit their slots arrive."""
    rng = np.random.RandomState(6)
    pd = TContext(device="cpu", nparts=P).from_columns(
        _data("skew", 800, rng)).node.data
    parts, need_recv, need_slack, slot = shuffle.hash_exchange(
        split_partitions(pd), ["k"], out_capacity=pd.capacity)
    assert int(need_recv) == 800
    assert int(slot) == 100            # every source sends all 100 rows
    assert int(need_slack) == P        # ceil(100 * 8 / 100)
    # with room to receive, each source still ships only its C = 25 slots
    parts, need_recv, need_slack, _ = shuffle.hash_exchange(
        split_partitions(pd), ["k"], out_capacity=1_000)
    assert int(need_recv) == 0 and int(need_slack) == P
    assert sorted(int(b.count) for b in parts) == [0] * (P - 1) + [P * 25]
