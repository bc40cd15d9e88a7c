"""The port's five kernel wrappers (dryad_tpu_torch/ops/hopper_kernels.py)
on CPU tensors — where they run their plain PyTorch versions — against
the JAX package's Pallas wrappers, both in interpreter mode (the real
Pallas kernel bodies) and through their XLA fallbacks.

Tolerances: every integer result must match exactly; f32 prefix sums
agree within 1e-5 x max|prefix| (the bound tests/test_pallas_kernels.py
uses: the two scans add in different orders).  The compensated scan
``prefix_sum2`` is held to its error bound, not to bits: on a dyadic grid
(k/256, |k| < 2**15, where a float64 cumsum is exact) |hi + lo - ref| <=
2**-40 x sum_{i<=j} |x_i| for the port and the JAX function alike — a
plain f32 scan misses that by orders of magnitude; and group sums
differenced from both lanes meet the group bound 16 x 2**-24 x
sum_group |v| + 16 x 2**-48 x sum |v| even after a prefix of ~1e9.
slot_expand is compared on valid slots only (j < min(count, C)) and
slot_compact on the valid prefix only — the rest is padding whose
contents the JAX wrappers leave unspecified.  The CUDA kernels themselves run in chip_smoke.py."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dryad_tpu.ops import pallas_kernels as jk
from dryad_tpu_torch.ops import hopper_kernels as tk
from tests.torch_threads import one_torch_thread  # noqa: F401

MODES = ["fallback", "interpret"]


def _jax(mode, fn):
    """Run ``fn`` as one compiled program, in the given Pallas mode (the
    mode is read while tracing, so each call traces afresh)."""
    if mode == "interpret":
        with jk.force_interpret():
            return jax.tree.map(np.asarray, jax.jit(fn)())
    return jax.tree.map(np.asarray, jax.jit(fn)())


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


def _dyadic(n, seed):
    """f32 values k/256, -2**13 <= k < 2**15: exact in a float64 cumsum,
    and drifting upward so the prefix outgrows f32's exact range."""
    rng = np.random.RandomState(seed)
    return (rng.randint(-2**13, 2**15, n) / 256).astype(np.float32)


def _dd_err(hi, lo, x):
    """(|hi + lo - exact prefix|, the 2**-40 x sum|x| bound) per prefix."""
    ref = np.cumsum(x.astype(np.float64))
    got = np.asarray(hi).astype(np.float64) + np.asarray(lo)
    return np.abs(got - ref), 2.0**-40 * np.cumsum(np.abs(x.astype(
        np.float64)))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", [5, 40_000, 70_000])
def test_prefix_sum2_matches_jax_within_bound(mode, n):
    x = _dyadic(n, n)
    jhi, jlo = _jax(mode, lambda: jk.prefix_sum2(jnp.asarray(x)))
    hi, lo = tk.prefix_sum2(torch.from_numpy(x))
    assert hi.dtype == lo.dtype == torch.float32
    assert hi.shape == lo.shape == (n,)
    for h, l in ((hi.numpy(), lo.numpy()), (jhi, jlo)):
        err, bound = _dd_err(h, l, x)
        assert (err <= bound).all(), err.max()
    if n >= 40_000:
        # the bound has teeth: a plain f32 scan misses it
        err, bound = _dd_err(tk.prefix_sum_plain(torch.from_numpy(x)),
                             0.0, x)
        assert (err > 2.0**10 * bound).any()


def _cancellation_case():
    """1,000 values of 1e6 (the prefix climbs to 1e9), then 10,000 groups
    of 16 values in [0, 1/8): group sums about 1."""
    rng = np.random.RandomState(3)
    G, g = 10_000, 16
    small = (rng.rand(G * g) / 8).astype(np.float32)
    x = np.concatenate([np.full(1000, 1e6, np.float32), small])
    ends = 1000 + g * np.arange(1, G + 1) - 1
    grp = small.astype(np.float64).reshape(G, g)
    bound = (16 * 2.0**-24 * np.abs(grp).sum(1)
             + 16 * 2.0**-48 * np.abs(x.astype(np.float64)).sum())
    return x, ends, grp.sum(1), bound


def _group_sums(hi, lo, ends):
    """Each group's sum from the prefix at its end and the one before
    it, both lanes differenced in f32 (the boundary path's arithmetic)."""
    hi, lo = np.asarray(hi, np.float32), np.asarray(lo, np.float32)
    a, b = ends - 16, ends
    return ((hi[b] - hi[a]) + (lo[b] - lo[a])).astype(np.float64)


@pytest.mark.parametrize("mode", MODES)
def test_prefix_sum2_group_sums_survive_cancellation(mode):
    x, ends, want, bound = _cancellation_case()
    hi, lo = tk.prefix_sum2(torch.from_numpy(x))
    jhi, jlo = _jax(mode, lambda: jk.prefix_sum2(jnp.asarray(x)))
    for h, l in ((hi.numpy(), lo.numpy()), (jhi, jlo)):
        err = np.abs(_group_sums(h, l, ends) - want)
        assert (err <= bound).all(), (err.max(), bound.min())
    # the same differencing over a plain f32 prefix errs by ~ulp(1e9)
    plain = tk.prefix_sum(torch.from_numpy(x)).numpy()
    err = np.abs(_group_sums(plain, np.zeros_like(plain), ends) - want)
    assert (err > bound).any()
    assert err.max() > 8


def test_prefix_sum2_empty_and_dd_add_is_the_jax_combine():
    hi, lo = tk.prefix_sum2(torch.zeros(0))
    assert hi.shape == lo.shape == (0,)
    rng = np.random.RandomState(9)
    a = [rng.randn(1000).astype(np.float32) * s for s in (1e6, 1e-3)]
    b = [rng.randn(1000).astype(np.float32) * s for s in (1e3, 1e-6)]
    want = jk._dd_add(*(jnp.asarray(v) for v in a + b))
    got = tk.dd_add(*(torch.from_numpy(v) for v in a + b))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


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
    tk.prefix_sum2(torch.ones(10))
    assert set(tk.launches) == {"hist_buckets", "prefix_sum", "prefix_sum2",
                                "slot_expand", "slot_compact", "hash_keys",
                                "seg_scan"}
    assert sum(tk.launches.values()) == 0


CSRC = Path(tk.__file__).resolve().parent / "csrc"


def _constants(path):
    """``constexpr int kName = <int>;`` definitions of one CUDA source."""
    return {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", path.read_text())}


@pytest.mark.parametrize("name", ["prefix_sum", "prefix_sum2"])
def test_scan_constants_mirror_the_cuda_sources(name):
    """The wrappers' tile and scratch layout are the CUDA sources' own:
    kTile = kThreads * kItems, the shared header's head words, and the
    source's words a tile."""
    c = _constants(CSRC / f"{name}.cu")
    head = _constants(CSRC / "scan_lookback.cuh")["kHeadWords"]
    assert tk._SCAN_TILE == c["kThreads"] * c["kItems"]
    assert tk._SCAN_HEAD_WORDS == head
    assert tk._SCAN_SCRATCH_WORDS[name] == c["kScratchWordsPerTile"]
    assert '#include "scan_lookback.cuh"' in (CSRC / f"{name}.cu"
                                               ).read_text()


@pytest.mark.parametrize("name", ["prefix_sum", "prefix_sum2"])
@pytest.mark.parametrize("n,tiles", [(0, 0), (1, 1), (8, 1), (4096, 1),
                                     (4097, 2), (1_250_000, 306),
                                     (20_000_001, 4883)])
def test_scan_scratch_words(name, n, tiles):
    """Head + words a tile x ceil(n / kTile) 64-bit words; none for one
    tile, which the kernel runs without a look-back."""
    c = _constants(CSRC / f"{name}.cu")
    head = _constants(CSRC / "scan_lookback.cuh")["kHeadWords"]
    assert -(-n // (c["kThreads"] * c["kItems"])) == tiles
    want = head + c["kScratchWordsPerTile"] * tiles if tiles > 1 else 0
    assert tk._scan_scratch_words(name, n) == want


def test_scan_scratch_is_kept_per_scan_and_stream(monkeypatch):
    """One zeroed buffer per (scan, device, stream), reused while big
    enough and replaced by a larger zeroed one (a power of two) when not;
    none for one tile.  (The host side only: the kernel clears it.)"""
    monkeypatch.setattr(tk, "_scan_scratch_bufs", {})
    x = torch.zeros(3 * tk._SCAN_TILE)
    assert tk._scan_scratch("prefix_sum", x[:tk._SCAN_TILE], 7) is None
    a = tk._scan_scratch("prefix_sum", x, 7)
    assert a.dtype == torch.int64 and a.numel() == 8 and not a.any()
    assert tk._scan_scratch("prefix_sum", x[:5000], 7) is a
    assert tk._scan_scratch("prefix_sum", x, 8) is not a
    assert tk._scan_scratch("prefix_sum2", x, 7) is not a
    big = torch.zeros(40 * tk._SCAN_TILE)
    b = tk._scan_scratch("prefix_sum2", big, 7)
    assert b.numel() == 128 and not b.any()
    assert len(tk._scan_scratch_bufs) == 3


_SCANS = {"prefix_sum": tk.prefix_sum, "prefix_sum2": tk.prefix_sum2}


@pytest.mark.parametrize("name", sorted(_SCANS))
@pytest.mark.parametrize("bad,err", [
    (lambda: torch.ones(4, dtype=torch.int64), TypeError),
    (lambda: torch.ones(4, dtype=torch.float64), TypeError),
    (lambda: torch.ones(4, dtype=torch.int16), TypeError),
    (lambda: torch.ones(4, dtype=torch.bool), TypeError),
    (lambda: torch.ones((2, 4)), ValueError),
    (lambda: torch.ones(()), ValueError),
    (lambda: torch.ones(8)[::2], ValueError),
    (lambda: torch.empty(4, device="meta"), ValueError),
])
def test_scan_wrappers_refuse_bad_input(name, bad, err):
    """Bad dtype, rank, layout or device raises before any launch."""
    tk.reset_launches()
    with pytest.raises(err):
        _SCANS[name](bad())
    assert sum(tk.launches.values()) == 0


def test_wrappers_refuse_other_devices_and_bad_input():
    meta = torch.empty(16, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tk.hist_buckets(meta, 4)
    with pytest.raises(TypeError):
        tk.prefix_sum(torch.ones(4, dtype=torch.int64))
    with pytest.raises(TypeError):
        tk.prefix_sum2(torch.ones(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        tk.prefix_sum2(torch.ones(8)[::2])
    with pytest.raises(ValueError):
        tk.prefix_sum2(torch.empty(4, device="meta"))
    with pytest.raises(ValueError):
        tk.slot_compact(torch.zeros((10, 2), dtype=torch.int32),
                        torch.zeros(3, dtype=torch.int32), 4, 8)
    with pytest.raises(ValueError):
        tk.slot_expand(torch.zeros((8, 2), dtype=torch.int32)[:, :1],
                       torch.zeros(2, dtype=torch.int32), 4)
