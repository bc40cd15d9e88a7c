"""The port's boundary-carry group aggregation
(dryad_tpu_torch/ops/kernels.py, which runs the prefix_sum kernel)
against the JAX package's ops/kernels.py on the same inputs, plus the
packed-word transport both exchanges use.  Tolerance: none — keys,
counts, integer sums, min/max, any/all and the group count must match
exactly (groups compared as sets: the order follows the sort key, which
is the same in both, but the comparison does not rely on it); means
agree to float32 rounding of the same integer quotient."""

import numpy as np
import pytest
import torch

import jax

from dryad_tpu.data import columnar as jcol
from dryad_tpu.ops import kernels as jkern
from dryad_tpu_torch.data import columnar as tcol
from dryad_tpu_torch.ops import kernels as tkern

N, CAP = 3_000, 3_200


def _cols(key_kind, rng):
    if key_kind == "str":
        vocab = [b"w%d" % i for i in range(300)] + [b"", b"\x00x"]
        k = [vocab[i] for i in rng.randint(0, len(vocab), N)]
    elif key_kind == "f32":
        k = rng.randint(-40, 40, N).astype(np.float32) / 4
        k[::13] = -0.0
    else:
        k = rng.randint(-500, 500, N).astype(np.int32)
    return {"k": k,
            "v": rng.randint(-2**31, 2**31 - 1, N).astype(np.int32),
            "m": rng.randint(-1000, 1000, N).astype(np.int32),
            "f": rng.rand(N) < 0.3}


AGGS = {"n": ("count", None), "s": ("sum", "v"), "mu": ("mean", "m"),
        "lo": ("min", "m"), "hi": ("max", "m"), "a": ("any", "f"),
        "al": ("all", "f")}


def _table(batch, keys):
    c = int(batch.count)
    out = {}
    cols = {}
    for name, v in batch.columns.items():
        if hasattr(v, "lengths"):
            d, l = np.asarray(v.data)[:c], np.asarray(v.lengths)[:c]
            cols[name] = [bytes(d[i, :l[i]]) for i in range(c)]
        else:
            cols[name] = np.asarray(v)[:c].tolist()
    for i in range(c):
        key = tuple(cols[k][i] for k in keys)
        assert key not in out
        out[key] = {n: cols[n][i] for n in cols if n not in keys}
    return out


@pytest.mark.parametrize("key_kind", ["str", "i32", "f32"])
def test_group_aggregate_matches_jax(key_kind):
    rng = np.random.RandomState(11)
    cols = _cols(key_kind, rng)
    aggs = dict(AGGS)
    jb = jcol.batch_from_numpy(cols, capacity=CAP, str_max_len=8)
    tb = tcol.batch_from_numpy(cols, capacity=CAP, str_max_len=8,
                               device="cpu")
    ok, mm = jkern._boundary_eligible(jb, aggs)
    assert ok and mm == "m"
    jout = jax.jit(lambda b: jkern._group_aggregate_boundary(
        b, ["k"], aggs, mm))(jb)
    tout = tkern.group_aggregate(tb, ["k"], aggs)
    jt, tt = _table(jout, ["k"]), _table(tout, ["k"])
    assert tt.keys() == jt.keys()
    for key in jt:
        for name in ("n", "s", "lo", "hi", "a", "al"):
            assert tt[key][name] == jt[key][name], (key, name)
        assert np.float32(tt[key]["mu"]) == np.float32(jt[key]["mu"])


def test_group_count_only_string_key_matches_jax():
    """WordCount's final merge: string key, sum of int32 partial counts."""
    rng = np.random.RandomState(12)
    words = [b"tok%d" % i for i in rng.randint(0, 700, N)]
    cols = {"line": words, "n": rng.randint(1, 50, N).astype(np.int32)}
    aggs = {"n": ("sum", "n")}
    jb = jcol.batch_from_numpy(cols, capacity=CAP, str_max_len=24)
    tb = tcol.batch_from_numpy(cols, capacity=CAP, str_max_len=24,
                               device="cpu")
    jout = jax.jit(lambda b: jkern.group_aggregate(b, ["line"], aggs))(jb)
    tout = tkern.group_aggregate(tb, ["line"], aggs)
    assert _table(tout, ["line"]) == _table(jout, ["line"])


@pytest.mark.parametrize("keys,aggs", [
    (["k"], {"n": ("count", None)}),      # small-key one-hot lowering
    (["k2"], {"s": ("sum", "x")}),        # f32 sums (prefix_sum2)
    (["x"], {"s": ("min", "k2")}),        # segmented-scan lowering
])
def test_unported_lowerings_raise(keys, aggs):
    b = tcol.batch_from_numpy({"k": np.arange(10, dtype=np.int32),
                               "x": np.ones(10, np.float32),
                               "k2": [b"a"] * 10}, device="cpu")
    with pytest.raises(NotImplementedError, match="GroupByReduce"):
        tkern.group_aggregate(b, keys, aggs)


def test_pack_unpack_roundtrip_and_jax_layout():
    """Packed words: the string bytes' little-endian words are the JAX
    package's, and every column survives the round trip bit for bit."""
    rng = np.random.RandomState(4)
    n = 64
    cols = {"s": [bytes(rng.randint(1, 256, int(rng.randint(0, 11)))
                        .astype(np.uint8)) for _ in range(n)],
            "i": rng.randint(-2**31, 2**31 - 1, n).astype(np.int32),
            "f": rng.randn(n).astype(np.float32),
            "h": rng.randn(n).astype(np.float16),
            "b": rng.rand(n) < 0.5,
            "i8": rng.randint(-128, 128, n).astype(np.int8),
            "v2": rng.randint(0, 9, (n, 3)).astype(np.int32)}
    tb = tcol.batch_from_numpy(cols, str_max_len=10, device="cpu")
    jb = jcol.batch_from_numpy(cols, str_max_len=10)
    words, spec = tkern._pack_columns_u32(tb.columns)
    jlanes, _ = jkern._pack_columns_u32(dict(jb.columns))
    jwords = np.stack([np.asarray(l) for l in jlanes], axis=1)
    np.testing.assert_array_equal(words.numpy().view(np.uint32), jwords)
    back = tkern._unpack_columns_u32(words, spec)
    for k, v in tb.columns.items():
        if hasattr(v, "lengths"):
            assert torch.equal(back[k].data, v.data)
            assert torch.equal(back[k].lengths, v.lengths)
        else:
            assert back[k].dtype == v.dtype
            assert torch.equal(back[k], v)     # no NaNs in these inputs
