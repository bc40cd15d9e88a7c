"""The port's four kernel wrappers (dryad_tpu_torch/ops/hopper_kernels.py)
on CPU tensors — where they run their plain PyTorch versions — against
the JAX package's Pallas wrappers, both in interpreter mode (the real
Pallas kernel bodies) and through their XLA fallbacks.

Tolerances: every integer result must match exactly; f32 prefix sums
agree within 1e-5 x max|prefix| (the bound tests/test_pallas_kernels.py
uses: the two scans add in different orders).  slot_expand is compared on
valid slots only (j < min(count, C)) and slot_compact on the valid prefix
only — the rest is padding whose contents the JAX wrappers leave
unspecified.  The CUDA kernels themselves run in chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dryad_tpu.ops import pallas_kernels as jk
from dryad_tpu_torch.ops import hopper_kernels as tk

MODES = ["fallback", "interpret"]


def _jax(mode, fn):
    """Run ``fn`` as one compiled program, in the given Pallas mode (the
    mode is read while tracing, so each call traces afresh)."""
    if mode == "interpret":
        with jk.force_interpret():
            return np.asarray(jax.jit(fn)())
    return np.asarray(jax.jit(fn)())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n,nb", [(1, 5), (127, 8), (5_000, 37),
                                  (20_001, 8), (3_000, 600)])
def test_hist_buckets_matches_jax(mode, n, nb):
    rng = np.random.RandomState(n + nb)
    bid = rng.randint(0, nb, n).astype(np.int32)
    bid[::7] = nb          # invalid-row sentinel
    bid[::11] = -3         # negatives are ignored too
    want = _jax(mode, lambda: jk.hist_buckets(jnp.asarray(bid), nb))
    got = tk.hist_buckets(torch.from_numpy(bid), nb).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_hist_buckets_empty():
    got = tk.hist_buckets(torch.zeros(0, dtype=torch.int32), 4)
    np.testing.assert_array_equal(got.numpy(), np.zeros(4, np.int32))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.float32])
@pytest.mark.parametrize("n", [5, 40_000])
def test_prefix_sum_matches_jax(mode, dtype, n):
    rng = np.random.RandomState(n)
    if dtype == np.float32:
        x = rng.rand(n).astype(dtype)
    elif dtype == np.int32:
        # large magnitudes force the modular wrap
        x = rng.randint(-2**31, 2**31 - 1, n).astype(dtype)
    else:
        x = rng.randint(0, 2**32 - 1, n, dtype=np.int64).astype(dtype)
    want = _jax(mode, lambda: jk.prefix_sum(jnp.asarray(x)))
    tx = torch.from_numpy(x.view(np.int32)).view(torch.uint32) \
        if dtype == np.uint32 else torch.from_numpy(x)
    got = tk.prefix_sum(tx)
    got = (got.view(torch.int32).numpy().view(np.uint32)
           if dtype == np.uint32 else got.numpy())
    assert got.dtype == want.dtype
    if dtype == np.float32:
        ref = np.cumsum(x.astype(np.float64))
        tol = 1e-5 * np.abs(ref).max()
        assert np.abs(got - want).max() <= tol
        assert np.abs(got - ref).max() <= tol
    else:
        np.testing.assert_array_equal(got, want)


def _runs(rng, cap, D, skew):
    """Per-destination counts summing to <= cap (some zero, some over C)
    and their exclusive prefix, as the exchange produces them."""
    w = rng.rand(D) ** skew
    w[rng.rand(D) < 0.25] = 0.0
    counts = np.floor(w / max(w.sum(), 1e-9) * cap * 0.9).astype(np.int32)
    offsets = (np.cumsum(counts) - counts).astype(np.int32)
    return counts, offsets


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("cap,W,D,C", [(64, 3, 1, 5), (500, 4, 8, 16),
                                       (500, 8, 8, 3), (1_000, 5, 16, 40),
                                       (300, 2, 8, 300)])
def test_slot_expand_matches_jax(mode, cap, W, D, C):
    rng = np.random.RandomState(cap + D + C)
    words = rng.randint(-2**31, 2**31 - 1, (cap, W)).astype(np.int32)
    counts, offsets = _runs(rng, cap, D, 3.0)
    want = _jax(mode, lambda: jk.slot_expand(
        jnp.asarray(words.view(np.uint32)), jnp.asarray(offsets), C))
    got = tk.slot_expand(torch.from_numpy(words), torch.from_numpy(offsets),
                         C).numpy()
    assert got.shape == (D * C, W)
    want = want.view(np.int32).reshape(D, C, W)
    got = got.reshape(D, C, W)
    for d in range(D):
        k = min(int(counts[d]), C)
        np.testing.assert_array_equal(got[d, :k], want[d, :k])


def test_slot_expand_reads_zero_pad_past_end():
    """A run starting near the end reads the C zero pad rows, never an
    earlier destination's rows."""
    words = torch.arange(1, 13, dtype=torch.int32).reshape(6, 2)
    got = tk.slot_expand(words, torch.tensor([0, 5, 9], dtype=torch.int32),
                         3).numpy()
    want = np.array([[1, 2], [3, 4], [5, 6],
                     [11, 12], [0, 0], [0, 0],
                     [0, 0], [0, 0], [0, 0]], np.int32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("D,C,W,out_rows", [(8, 16, 4, 200), (8, 16, 4, 40),
                                            (1, 10, 3, 12), (16, 5, 2, 90),
                                            (4, 32, 7, 20)])
def test_slot_compact_matches_jax(mode, D, C, W, out_rows):
    rng = np.random.RandomState(D * C + out_rows)
    words = rng.randint(-2**31, 2**31 - 1, (D * C, W)).astype(np.int32)
    counts = rng.randint(0, C + 1, D).astype(np.int32)
    counts[0] = 0
    counts[D // 2] = C + 7             # >= C: clamped to C, so the next
                                       # block's start does not move
    want = _jax(mode, lambda: jk.slot_compact(
        jnp.asarray(words.view(np.uint32)), jnp.asarray(counts), C,
        out_rows)).view(np.int32)
    got = tk.slot_compact(torch.from_numpy(words), torch.from_numpy(counts),
                          C, out_rows).numpy()
    assert got.shape == (out_rows, W)
    total = int(np.minimum(counts, C).sum())
    k = min(total, out_rows)
    np.testing.assert_array_equal(got[:k], want[:k])
    # the port's contract: zeros at and past the total
    assert (got[k:] == 0).all()
    # and the valid prefix is each block's prefix in source order
    ref = np.concatenate([words[s * C: s * C + min(int(counts[s]), C)]
                          for s in range(D)])[:out_rows]
    np.testing.assert_array_equal(got[:k], ref)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    tk.reset_launches()
    tk.hist_buckets(torch.zeros(10, dtype=torch.int32), 2)
    tk.prefix_sum(torch.ones(10, dtype=torch.int32))
    assert sum(tk.launches.values()) == 0


def test_wrappers_refuse_other_devices_and_bad_input():
    meta = torch.empty(16, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tk.hist_buckets(meta, 4)
    with pytest.raises(TypeError):
        tk.prefix_sum(torch.ones(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        tk.slot_compact(torch.zeros((10, 2), dtype=torch.int32),
                        torch.zeros(3, dtype=torch.int32), 4, 8)
    with pytest.raises(ValueError):
        tk.slot_expand(torch.zeros((8, 2), dtype=torch.int32)[:, :1],
                       torch.zeros(2, dtype=torch.int32), 4)
