"""Two edges of the port against the JAX package: exchanges with one-row
send slots (inputs of 32 rows or fewer at P = 8, where
C = max(1, ceil(2 cap / P)) = 1), and float min/max over NaNs (the NaN
bits the group-by returns, and where an ``order_by`` then puts them).

Tolerance: none.  Group and distinct results compare as multisets of
whole rows, sorted results in order, floats by their bits."""

import collections

import numpy as np
import pytest
import torch

from dryad_tpu import Context as JContext
from dryad_tpu_torch import Context as TContext
from dryad_tpu_torch.ops import hopper_kernels as hk
from tests.torch_threads import one_torch_thread  # noqa: F401

P = 8


def test_slot_expand_plain_is_contiguous_at_one_row_slots():
    words = torch.arange(3 * 5 * 2, dtype=torch.int32).view(3, 5, 2)
    offs = torch.tensor([[0, 2, 4, 5]] * 3, dtype=torch.int32)
    out = hk.slot_expand_batched_plain(words, offs, 1)
    assert out.shape == (4, 3, 2) and out.is_contiguous()
    assert all(out[d].is_contiguous() for d in range(4))
    assert torch.equal(out[1, 2], words[2, 2])


@pytest.mark.parametrize("dtype", [torch.int64, torch.float64])
def test_unpack_of_no_rows_keeps_64bit_columns(dtype):
    """Unpacking zero rows (an exchange or broadcast into capacity 0)
    gives empty columns, also for a 64-bit column that starts after an
    odd number of words (its empty slice has an odd storage offset)."""
    from dryad_tpu_torch.ops.kernels import (_pack_columns_u32,
                                             _unpack_columns_u32)
    cols = {"a": torch.zeros(4, dtype=torch.int32),
            "b": torch.zeros((4, 2), dtype=dtype)}
    words, spec = _pack_columns_u32(cols)
    out = _unpack_columns_u32(words[:0], spec)
    assert out["a"].shape == (0,) and out["b"].shape == (0, 2)
    assert out["b"].dtype == dtype


def _rows(t, cols):
    return collections.Counter(zip(*[np.asarray(t[c]).tolist()
                                     for c in cols]))


QUERIES = {
    "group_by": (lambda ds: ds.group_by(["k"], {"n": ("count", None),
                                                "s": ("sum", "v")}),
                 ("k", "n", "s"), False),
    "order_by": (lambda ds: ds.order_by([("k", True), ("v", False)]),
                 ("k", "v"), True),
    "distinct": (lambda ds: ds.distinct(["k"]), ("k", "v"), False),
}


@pytest.mark.parametrize("n", [0, 1, 8, 32])
@pytest.mark.parametrize("query", list(QUERIES))
def test_small_exchanges_match_jax(devices8, query, n):
    rng = np.random.RandomState(n)
    cols = {"k": rng.randint(-5, 5, n).astype(np.int32),
            "v": rng.randint(-100, 100, n).astype(np.int32)}
    q, names, ordered = QUERIES[query]
    tout = q(TContext(device="cpu", nparts=P).from_columns(cols)).collect()
    jout = q(JContext().from_columns(cols)).collect()
    if ordered:
        for c in names:
            np.testing.assert_array_equal(tout[c], np.asarray(jout[c]))
    else:
        assert _rows(tout, names) == _rows(jout, names)
    assert len(tout["k"]) == len(np.asarray(jout["k"])) <= n


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32).tolist()


def test_nan_min_max_bits_match_jax(devices8):
    """The final stage merges two min/max columns with the segmented scan,
    whose minimum / maximum propagate a NaN: the port's NaN must carry the
    JAX package's bits (0x7FC00000), so a later order_by ranks it where
    the JAX package does (last, above +inf)."""
    import chip_smoke
    data = chip_smoke.nan_minmax_data()
    want = chip_smoke.nan_minmax_oracle(data)
    assert any(0x7FC00000 in w for w in want.values())
    outs = []
    for ctx in (TContext(device="cpu", nparts=P), JContext()):
        g = ctx.from_columns(data).group_by(["k"], {"mn": ("min", "v"),
                                                    "mx": ("max", "v")})
        out = g.collect()
        outs.append(dict(zip(np.asarray(out["k"]).tolist(),
                             zip(_bits(out["mn"]), _bits(out["mx"])))))
        outs.append(_bits(g.order_by([("mx", False)]).collect()["mx"]))
    assert outs[0] == outs[2] == want
    assert outs[1] == outs[3]
    assert outs[1][-1] == 0x7FC00000


def test_nan_min_max_beside_a_decomposable_matches_jax(devices8):
    """A group_by mixing a user Decomposable with builtin min / max runs
    every aggregate through the segmented merge, where the builtin kinds
    become Decomposables (planner._builtin_as_decomposable): the NaN bits
    match the JAX package's too."""
    import jax.numpy as jnp

    from dryad_tpu.plan.expr import Decomposable as JDec
    from dryad_tpu_torch import Decomposable as TDec
    import chip_smoke
    data = chip_smoke.nan_minmax_data()
    aggs = {"mn": ("min", "v"), "mx": ("max", "v")}
    tq = TContext(device="cpu", nparts=P).from_columns(data).group_by(
        ["k"], {**aggs, "n": TDec(lambda c: torch.ones_like(c["k"]),
                                  lambda a, b: a + b)})
    jq = JContext().from_columns(data).group_by(
        ["k"], {**aggs, "n": JDec(lambda c: jnp.ones_like(c["k"]),
                                  lambda a, b: a + b)})
    got = []
    for out in (tq.collect(), jq.collect()):
        got.append(dict(zip(np.asarray(out["k"]).tolist(),
                            zip(_bits(out["mn"]), _bits(out["mx"]),
                                np.asarray(out["n"]).tolist()))))
    assert got[0] == got[1]
    assert sum(v[1] == 0x7FC00000 for v in got[0].values()) >= 20


def test_chip_smoke_nan_hold_on_the_cpu(monkeypatch):
    """chip_smoke.py's NaN min/max hold, run through the port on the CPU,
    passes; with the scan's min / max NaNs left as ATen's (whose
    vectorized CPU kernels give a NaN the bits 0xFFFFFFFF) it fails."""
    import chip_smoke
    import dryad_tpu_torch
    from dryad_tpu_torch.ops import kernels as tkern
    got = chip_smoke.check_nan_minmax(dryad_tpu_torch, device="cpu")
    assert got["nan_max_groups"] > 0 and got["groups"] == 24
    monkeypatch.setattr(tkern, "canon_nan", lambda x: x)
    with pytest.raises(AssertionError, match="nan min/max"):
        chip_smoke.check_nan_minmax(dryad_tpu_torch, device="cpu")
