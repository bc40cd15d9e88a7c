"""The exchange's batched compaction (``slot_compact_batched`` in
dryad_tpu_torch/ops/hopper_kernels.py) on CPU tensors — where it runs its
plain PyTorch version — against the JAX package's one-destination Pallas
wrapper ``slot_compact`` called on each destination, in interpreter mode
(the real Pallas kernel body) and through its XLA fallback; and the
exchanges of dryad_tpu_torch/parallel/shuffle.py, which unpack with ONE
compaction per exchange, against the per-destination form rebuilt from
one-destination ``slot_compact`` calls.

Tolerance: none — every result is integer.  Against JAX only each
destination's valid prefix is compared (min(total, out_rows) rows): the
padding past it is unspecified in the JAX wrapper.  The port must hold
zeros there.  The JAX wrapper takes counts at or below C (it clamps
those above C to C) and no negative counts: negative counts are held to
a numpy reference, which treats them as empty blocks, as the port's
contract says.  The CUDA kernel itself runs in chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dryad_tpu.ops import pallas_kernels as jk
from dryad_tpu_torch import Context
from dryad_tpu_torch.data.columnar import Batch, StringColumn
from dryad_tpu_torch.exec.data import split_partitions
from dryad_tpu_torch.ops import hopper_kernels as tk
from dryad_tpu_torch.ops.kernels import _pack_columns_u32, _unpack_columns_u32
from dryad_tpu_torch.parallel import shuffle
from tests.torch_threads import one_torch_thread  # noqa: F401

MODES = ["fallback", "interpret"]


def _jax(mode, fn):
    """Run ``fn`` as one compiled program in the given Pallas mode."""
    if mode == "interpret":
        with jk.force_interpret():
            return jax.tree.map(np.asarray, jax.jit(fn)())
    return jax.tree.map(np.asarray, jax.jit(fn)())


def _counts(rng, Dd, S, C, lo=0):
    """[Dd, S] counts in [lo, C + 3] with the edges above C, 0 and C set
    (a negative one first where ``lo`` < 0), rotated over the
    destinations so that even S = 1 or 2 sees each edge somewhere."""
    cnt = rng.randint(lo, C + 4, (Dd, S))
    edges = ([lo] if lo < 0 else []) + [C + 3, 0, C]
    for d in range(Dd):
        for i in range(min(S, len(edges))):
            cnt[d, (d + i) % S] = edges[(d + i) % len(edges)]
    return cnt.astype(np.int32)


def _reference(recv, counts, C, out_rows):
    """numpy: each destination's blocks' valid prefixes (counts clamped to
    [0, C]) in source order, cut to out_rows, zeros after."""
    Dd, _rows, W = recv.shape
    out = np.zeros((Dd, out_rows, W), np.int32)
    for d in range(Dd):
        rows = np.concatenate(
            [recv[d, s * C: s * C + int(np.clip(c, 0, C))]
             for s, c in enumerate(counts[d])])[:out_rows]
        out[d, :len(rows)] = rows
    return out


def _out_rows(kind, counts, C):
    """Below, at and far above the largest destination total."""
    top = int(np.clip(counts, 0, C).sum(1).max())
    return {"below": top // 2, "at": top, "above": 3 * top + 2 * C + 5}[kind]


# (Dd, S, C, W): Dd in {1, 3, 8}, S in {1, 2, 8, 16}, C in {1, 5, 16},
# W in {1, 3, 7, 46}
_CASES = [(1, 1, 5, 3), (1, 16, 16, 46), (3, 2, 1, 7), (3, 8, 5, 1),
          (3, 16, 1, 46), (8, 8, 16, 7), (8, 16, 5, 3), (8, 2, 16, 1),
          (8, 8, 1, 46)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("Dd,S,C,W", _CASES)
@pytest.mark.parametrize("kind", ["below", "at", "above"])
def test_slot_compact_batched_matches_jax(mode, Dd, S, C, W, kind):
    """Each destination's valid prefix equals the JAX wrapper's on that
    destination, the padding after it is zero, and the whole output is
    the numpy reference."""
    rng = np.random.RandomState(Dd * 1000 + S * 100 + C * 10 + W)
    recv = rng.randint(-2**31, 2**31 - 1, (Dd, S * C, W)).astype(np.int32)
    counts = _counts(rng, Dd, S, C)
    out_rows = _out_rows(kind, counts, C)
    got = tk.slot_compact_batched(torch.from_numpy(recv),
                                  torch.from_numpy(counts), C,
                                  out_rows).numpy()
    assert got.shape == (Dd, out_rows, W) and got.dtype == np.int32
    want = _jax(mode, lambda: jnp.stack([jk.slot_compact(
        jnp.asarray(recv[d].view(np.uint32)), jnp.asarray(counts[d]), C,
        out_rows) for d in range(Dd)])).view(np.int32)
    for d in range(Dd):
        k = min(int(np.minimum(counts[d], C).sum()), out_rows)
        np.testing.assert_array_equal(got[d, :k], want[d, :k])
        assert (got[d, k:] == 0).all()
    np.testing.assert_array_equal(got, _reference(recv, counts, C, out_rows))


@pytest.mark.parametrize("Dd,S,C,W", _CASES)
def test_negative_counts_are_empty_blocks(Dd, S, C, W):
    """Negative counts clamp to 0 (an empty block), counts above C to C,
    at out_rows 0, below and above the totals."""
    rng = np.random.RandomState(S * C + W)
    recv = rng.randint(-2**31, 2**31 - 1, (Dd, S * C, W)).astype(np.int32)
    counts = _counts(rng, Dd, S, C, lo=-4)
    assert (counts < 0).any()
    for out_rows in (0, _out_rows("below", counts, C),
                     _out_rows("above", counts, C)):
        got = tk.slot_compact_batched(torch.from_numpy(recv),
                                      torch.from_numpy(counts), C, out_rows)
        np.testing.assert_array_equal(
            got.numpy(), _reference(recv, counts, C, out_rows))


@pytest.mark.parametrize("Dd,S,C,W", _CASES)
def test_batched_slices_are_the_one_destination_calls(Dd, S, C, W):
    """Slice d of the batched call is ``slot_compact`` of destination d,
    and the one-destination call is the batched call with Dd = 1:
    captured under the kernel's name with its batched arguments."""
    rng = np.random.RandomState(W * 7 + S)
    recv = torch.from_numpy(rng.randint(-2**31, 2**31 - 1, (Dd, S * C, W)
                                        ).astype(np.int32))
    counts = torch.from_numpy(_counts(rng, Dd, S, C, lo=-1))
    out_rows = _out_rows("below", counts.numpy(), C) + 1
    tk.capture = {}
    try:
        got = tk.slot_compact_batched(recv, counts, C, out_rows)
        one = [tk.slot_compact(recv[d], counts[d], C, out_rows)
               for d in range(Dd)]
        cap = tk.capture
    finally:
        tk.capture = None
    for d in range(Dd):
        assert torch.equal(got[d], one[d])
    assert [(n, a[0].shape, a[1].shape, a[2], a[3])
            for n, a in cap["slot_compact"]] == \
        [(Dd * out_rows * W, (Dd, S * C, W), (Dd, S), C, out_rows)] + \
        [(out_rows * W, (1, S * C, W), (1, S), C, out_rows)] * Dd


def _zero(shape):
    return torch.zeros(shape, dtype=torch.int32)


_BAD = [
    (lambda: (_zero((2, 8, 3)).long(), _zero((2, 2)), 4, 5), TypeError),
    (lambda: (_zero((2, 8, 3)), _zero((2, 2)).long(), 4, 5), TypeError),
    (lambda: (_zero((8, 3)), _zero((2, 2)), 4, 5), ValueError),
    (lambda: (_zero((2, 8, 3)), _zero(4), 4, 5), ValueError),
    (lambda: (_zero((2, 8, 3)), _zero((3, 2)), 4, 5), ValueError),
    (lambda: (_zero((0, 8, 3)), _zero((0, 2)), 4, 5), ValueError),
    (lambda: (_zero((2, 8, 3)), _zero((2, 0)), 4, 5), ValueError),
    (lambda: (_zero((2, 9, 3)), _zero((2, 2)), 4, 5), ValueError),
    (lambda: (_zero((2, 8, 3)), _zero((2, 2)), 0, 5), ValueError),
    (lambda: (_zero((2, 8, 3)), _zero((2, 2)), 4, -1), ValueError),
    (lambda: (_zero((1, 4097, 3)), _zero((1, 4097)), 1, 5), ValueError),
    (lambda: (_zero((2, 8, 6))[:, :, :3], _zero((2, 2)), 4, 5), ValueError),
    (lambda: (_zero((2, 8, 3)), _zero((2, 4))[:, ::2], 4, 5), ValueError),
    (lambda: (torch.zeros((2, 8, 3), dtype=torch.int32, device="meta"),
              torch.zeros((2, 2), dtype=torch.int32, device="meta"), 4, 5),
     ValueError),
]


@pytest.mark.parametrize("i", range(len(_BAD)))
def test_wrapper_refuses_bad_input(i):
    """Bad dtype, rank, shape, layout or device, S above 4,096 sources
    (the kernel's starts live in shared memory), C < 1 or out_rows < 0
    raises before any launch."""
    make, err = _BAD[i]
    tk.reset_launches()
    with pytest.raises(err):
        tk.slot_compact_batched(*make())
    assert sum(tk.launches.values()) == 0


def test_most_sources_are_accepted():
    """S = 4,096 sources, the most the kernel's shared memory holds."""
    S = tk._MAX_COMPACT_SOURCES
    assert (S + 1) * 8 + 64 <= 48 * 1024
    counts = torch.ones((2, S), dtype=torch.int32)
    recv = torch.arange(2 * S, dtype=torch.int32).view(2, S, 1)
    got = tk.slot_compact_batched(recv, counts, 1, S + 3)
    assert torch.equal(got[:, :S], recv) and not got[:, S:].any()


# ---------------------------------------------------------------------------
# the exchanges


def _cols(rng, n):
    """Every packed column kind: int32, int64 (2 words), float32, bool
    (a numeric cast), int16 (bit widening), a [n, 3] vector, a string."""
    words = [b"w%d" % i for i in range(40)] + [b"longer-word-%d" % i
                                               for i in range(5)]
    return {"k": rng.randint(0, 50, n).astype(np.int32),
            "big": rng.randint(-2**40, 2**40, n).astype(np.int64),
            "v": rng.randn(n).astype(np.float32),
            "flag": rng.rand(n) < 0.5,
            "h": rng.randint(-2**15, 2**15, n).astype(np.int16),
            "vec": rng.randn(n, 3).astype(np.float32),
            "s": [words[i] for i in rng.randint(0, len(words), n)]}


def _parts(P, n, seed):
    rng = np.random.RandomState(seed)
    pd = Context(device="cpu", nparts=P).from_columns(
        _cols(rng, n), str_max_len=16).node.data
    return split_partitions(pd)


class _Spy:
    """Records every batched compaction's arguments, then runs it."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = tk.slot_compact_batched_plain

        def spy(*a):
            self.calls.append(a)
            return real(*a)
        monkeypatch.setattr(tk, "slot_compact_batched_plain", spy)


def _per_destination(call, spec, out_capacity):
    """The exchange's unpack as it was: per destination, one
    ``slot_compact`` call, its own columns unpacked, its own count."""
    recv, counts, C, _rows = call
    totals = counts.clamp(0, C).sum(1, dtype=torch.int32)
    return [Batch(_unpack_columns_u32(
        tk.slot_compact(recv[d], counts[d], C, out_capacity), spec),
        torch.clamp(totals[d], max=out_capacity))
        for d in range(recv.shape[0])]


def _same_columns(got: Batch, want: Batch, out_capacity):
    assert got.count.dtype == want.count.dtype == torch.int32
    assert got.count.shape == () and int(got.count) == int(want.count)
    assert list(got.columns) == list(want.columns)
    for k, v in got.columns.items():
        w = want.columns[k]
        pairs = ([(v.data, w.data), (v.lengths, w.lengths)]
                 if isinstance(v, StringColumn) else [(v, w)])
        for a, b in pairs:
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.shape[0] == out_capacity and a.is_contiguous()
            assert torch.equal(a, b), k


@pytest.mark.parametrize("P,n,out_capacity,slack", [
    (8, 1_600, 400, 2),      # fits
    (8, 1_600, 150, 2),      # receive overflow: rows dropped
    (3, 700, 500, 1),        # send-slot shortfall at slack 1
    (1, 300, 300, 2),
    (8, 20, 8, 2),           # one-row send slots
])
def test_hash_exchange_equals_per_destination_form(monkeypatch, P, n,
                                                   out_capacity, slack):
    """hash_exchange makes ONE compaction; each destination's Batch
    equals, column for column, the one its own ``slot_compact`` call
    and unpack give, and holds views of the shared columns."""
    parts = _parts(P, n, P * n + out_capacity)
    spec = _pack_columns_u32(parts[0].columns)[1]
    spy = _Spy(monkeypatch)
    got, need, need_slack, _slot = shuffle.hash_exchange(
        parts, ["k"], out_capacity, send_slack=slack)
    assert len(spy.calls) == 1
    want = _per_destination(spy.calls[0], spec, out_capacity)
    for g, w in zip(got, want):
        _same_columns(g, w, out_capacity)
    # destination d's columns are views [d] of one tensor per column
    base = got[0].columns["v"]
    for d, g in enumerate(got):
        assert g.columns["v"].data_ptr() == base.data_ptr() \
            + d * out_capacity * base.element_size()
    total = sum(int(b.count) for b in parts)
    # every row arrived, or a need says what would have held it
    assert (sum(int(g.count) for g in got) == total) != bool(
        int(need) or int(need_slack))


def _bounds(P):
    """Split points over key k's ordering lane: k < 7, < 14, ..."""
    return shuffle.range_dest_lane(torch.tensor(
        [7 * (i + 1) for i in range(P - 1)], dtype=torch.int32))


@pytest.mark.parametrize("P", [1, 3, 8])
def test_range_exchange_equals_per_destination_form(monkeypatch, P):
    parts = _parts(P, 900, P)
    spec = _pack_columns_u32(parts[0].columns)[1]
    bounds = _bounds(P)
    spy = _Spy(monkeypatch)
    got = shuffle.range_exchange(parts, "k", bounds, 600)[0]
    assert len(spy.calls) == 1
    for g, w in zip(got, _per_destination(spy.calls[0], spec, 600)):
        _same_columns(g, w, 600)


@pytest.mark.parametrize("P,out_capacity", [(1, 300), (3, 900), (8, 900),
                                            (8, 77), (8, 0)])
def test_broadcast_gather_equals_per_destination_form(monkeypatch, P,
                                                      out_capacity):
    """A broadcast is ONE compaction with one destination (Dd = 1), the
    same Batch for every partition."""
    parts = _parts(P, 600, P + out_capacity)
    spec = _pack_columns_u32(parts[0].columns)[1]
    spy = _Spy(monkeypatch)
    got, need, _slack = shuffle.broadcast_gather(parts, out_capacity)
    assert len(spy.calls) == 1 and spy.calls[0][0].shape[0] == 1
    (want,) = _per_destination(spy.calls[0], spec, out_capacity)
    assert all(g is got[0] for g in got)
    _same_columns(got[0], want, out_capacity)
    total = sum(int(b.count) for b in parts)
    assert int(need) == (total if total > out_capacity else 0)


def test_one_compaction_per_exchange(monkeypatch):
    """One ``slot_compact`` launch per hash, range or zip exchange and per
    broadcast; a salted join exchange is two hash exchanges and one
    broadcast, so three."""
    parts = _parts(8, 800, 3)
    bounds = _bounds(8)
    spy = _Spy(monkeypatch)
    runs = [
        (lambda: shuffle.hash_exchange(parts, ["k"], 400), 1),
        (lambda: shuffle.range_exchange(parts, "k", bounds, 400), 1),
        (lambda: shuffle.broadcast_gather(parts, 1000), 1),
        (lambda: shuffle.zip_exchange(parts, parts), 1),
        (lambda: shuffle.skew_join_exchange(parts, parts, ["k"], ["k"], 400,
                                            400), 3),
    ]
    for run, want in runs:
        spy.calls.clear()
        run()
        assert len(spy.calls) == want
