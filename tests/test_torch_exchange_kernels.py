"""The exchange's two batched kernels (``hist_buckets_batched`` and
``slot_expand_batched`` in dryad_tpu_torch/ops/hopper_kernels.py) on CPU
tensors — where they run their plain PyTorch versions — against the JAX
package's per-partition Pallas wrappers ``hist_buckets`` / ``slot_expand``
called on each partition, in interpreter mode (the real Pallas kernel
bodies) and through their XLA fallbacks; and the batched exchange
(dryad_tpu_torch/parallel/shuffle.py) against the per-partition exchange
it replaced.

Tolerance: none — every result is integer.  slot_expand is compared on
valid slots only (j < the run's rows in its slot), as in
tests/test_torch_kernels.py: the padding past them is unspecified in the
JAX wrappers, whose two modes differ there.  The exchange must be
bit-identical to the per-partition one, padding rows included.  The CUDA
kernels themselves run in chip_smoke.py."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dryad_tpu.ops import pallas_kernels as jk
from dryad_tpu_torch import Context
from dryad_tpu_torch.data.columnar import Batch
from dryad_tpu_torch.exec.data import split_partitions
from dryad_tpu_torch.ops import hopper_kernels as tk
from dryad_tpu_torch.ops.kernels import _pack_columns_u32, _unpack_columns_u32
from dryad_tpu_torch.parallel import shuffle
from tests.torch_threads import one_torch_thread  # noqa: F401

MODES = ["fallback", "interpret"]
CSRC = Path(tk.__file__).resolve().parent / "csrc"


def _jax(mode, fn):
    """Run ``fn`` as one compiled program in the given Pallas mode."""
    if mode == "interpret":
        with jk.force_interpret():
            return jax.tree.map(np.asarray, jax.jit(fn)())
    return jax.tree.map(np.asarray, jax.jit(fn)())


def _ids(rng, P, n, nb):
    bid = rng.randint(0, nb, (P, n)).astype(np.int32)
    bid[:, ::7] = nb          # invalid-row sentinel
    bid[:, ::11] = -3         # negatives are ignored too
    return bid


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("P", [1, 3, 8])
@pytest.mark.parametrize("n,nb", [(1, 5), (1_003, 8), (5_001, 37),
                                  (2_000, 600)])
def test_hist_buckets_batched_matches_jax(mode, P, n, nb):
    bid = _ids(np.random.RandomState(P * n + nb), P, n, nb)
    want = _jax(mode, lambda: jnp.stack(
        [jk.hist_buckets(jnp.asarray(bid[p]), nb) for p in range(P)]))
    got = tk.hist_buckets_batched(torch.from_numpy(bid), nb).numpy()
    assert got.dtype == np.int32 and got.shape == (P, nb)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("P,n", [(1, 0), (3, 0), (4, 1), (8, 1_003)])
def test_hist_buckets_batched_rows_are_the_one_row_calls(P, n):
    """Row p is hist_buckets(bid[p]); a row of no ids counts zeros."""
    bid = torch.from_numpy(_ids(np.random.RandomState(n + P), P, n, 8))
    got = tk.hist_buckets_batched(bid, 8)
    assert got.shape == (P, 8)
    for p in range(P):
        assert torch.equal(got[p], tk.hist_buckets(bid[p], 8))
    if n == 0:
        assert not got.any()


def _runs(rng, P, D, cap):
    """[P, D] run starts and the rows of each run that hold real rows
    (the valid slots), with the edges set: a run at cap, past cap,
    negative, and one reading into the zero pad."""
    offs = np.zeros((P, D), np.int64)
    rows = np.zeros((P, D), np.int64)
    for p in range(P):
        cnt = rng.randint(0, 2 * cap // D + 2, D)
        cnt = np.floor(cnt / max(cnt.sum(), 1) * cap * 0.9).astype(np.int64)
        offs[p] = np.cumsum(cnt) - cnt
        rows[p] = cnt
    for i, (v, r) in enumerate([(cap, 0), (cap + 5, 0), (-4, 0),
                                (cap - 1, 1)]):
        offs.flat[(2 * i + 1) % offs.size] = v
        rows.flat[(2 * i + 1) % offs.size] = r
    return offs.astype(np.int32), rows


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("P", [1, 3, 8])
@pytest.mark.parametrize("W", [1, 2, 3, 7, 8])
@pytest.mark.parametrize("C", [8, 13])
def test_slot_expand_batched_matches_jax(mode, P, W, C):
    cap, D = 203, 4          # cap not a multiple of 4
    rng = np.random.RandomState(P * 100 + W * 10 + C)
    words = rng.randint(-2**31, 2**31 - 1, (P, cap, W)).astype(np.int32)
    offs, rows = _runs(rng, P, D, cap)
    want = _jax(mode, lambda: jnp.stack([jk.slot_expand(
        jnp.asarray(words[p].view(np.uint32)), jnp.asarray(offs[p]), C)
        for p in range(P)])).view(np.int32).reshape(P, D, C, W)
    got = tk.slot_expand_batched(torch.from_numpy(words),
                                 torch.from_numpy(offs), C).numpy()
    assert got.shape == (D, P * C, W)
    got = got.reshape(D, P, C, W)
    for p in range(P):
        for d in range(D):
            k = min(int(rows[p, d]), C)
            np.testing.assert_array_equal(got[d, p, :k], want[p, d, :k])


@pytest.mark.parametrize("P,W,C", [(1, 7, 5), (3, 7, 12), (8, 2, 13),
                                   (2, 1, 3)])
def test_slot_expand_batched_blocks_are_the_one_partition_calls(P, W, C):
    """Block (d, p) of the receive layout is block d of
    slot_expand(words[p], offsets[p]) — padding and the zero pad
    included."""
    cap, D = 37, 3
    rng = np.random.RandomState(P + W + C)
    words = torch.from_numpy(
        rng.randint(-2**31, 2**31 - 1, (P, cap, W)).astype(np.int32))
    offs = torch.from_numpy(_runs(rng, P, D, cap)[0])
    got = tk.slot_expand_batched(words, offs, C).view(D, P, C, W)
    for p in range(P):
        one = tk.slot_expand(words[p], offs[p], C).view(D, C, W)
        assert torch.equal(got[:, p], one)


def test_cpu_batched_calls_count_nothing_and_are_captured():
    """CPU tensors take the plain versions and count no launch; a
    batched call is captured under the kernel's name with its batched
    arguments, and a one-row call as the batched call with P = 1."""
    tk.reset_launches()
    tk.capture = {}
    try:
        bid = torch.zeros((3, 10), dtype=torch.int32)
        tk.hist_buckets_batched(bid, 4)
        tk.hist_buckets(bid[0], 4)
        words = torch.zeros((2, 6, 3), dtype=torch.int32)
        offs = torch.zeros((2, 4), dtype=torch.int32)
        tk.slot_expand_batched(words, offs, 5)
        tk.slot_expand(words[0], offs[0], 5)
        cap = tk.capture
    finally:
        tk.capture = None
    assert sum(tk.launches.values()) == 0
    assert [a[0].shape for _s, a in cap["hist_buckets"]] == [(3, 10),
                                                             (1, 10)]
    assert [(s, a[0].shape, a[1].shape) for s, a in cap["slot_expand"]] == \
        [(4 * 2 * 5 * 3, (2, 6, 3), (2, 4)), (4 * 5 * 3, (1, 6, 3), (1, 4))]


_BAD = {
    "hist_buckets_batched": [
        (lambda: (torch.zeros((2, 4), dtype=torch.int64), 3), TypeError),
        (lambda: (torch.zeros(4, dtype=torch.int32), 3), ValueError),
        (lambda: (torch.zeros((0, 4), dtype=torch.int32), 3), ValueError),
        (lambda: (torch.zeros((2, 8), dtype=torch.int32)[:, ::2], 3),
         ValueError),
        (lambda: (torch.zeros((2, 4), dtype=torch.int32), -1), ValueError),
        (lambda: (torch.zeros((2, 4), dtype=torch.int32, device="meta"), 3),
         ValueError),
    ],
    "slot_expand_batched": [
        (lambda: (torch.zeros((2, 4, 3), dtype=torch.int64),
                  torch.zeros((2, 2), dtype=torch.int32), 2), TypeError),
        (lambda: (torch.zeros((4, 3), dtype=torch.int32),
                  torch.zeros((2, 2), dtype=torch.int32), 2), ValueError),
        (lambda: (torch.zeros((2, 4, 3), dtype=torch.int32),
                  torch.zeros((3, 2), dtype=torch.int32), 2), ValueError),
        (lambda: (torch.zeros((2, 4, 3), dtype=torch.int32),
                  torch.zeros((2, 0), dtype=torch.int32), 2), ValueError),
        (lambda: (torch.zeros((2, 4, 3), dtype=torch.int32),
                  torch.zeros((2, 2), dtype=torch.int32), 0), ValueError),
        (lambda: (torch.zeros((2, 4, 3), dtype=torch.int32),
                  torch.zeros((2, 70_000), dtype=torch.int32), 1),
         ValueError),
        (lambda: (torch.zeros((2, 4, 6), dtype=torch.int32)[:, :, :3],
                  torch.zeros((2, 2), dtype=torch.int32), 2), ValueError),
        (lambda: (torch.zeros((2, 4, 3), dtype=torch.int32, device="meta"),
                  torch.zeros((2, 2), dtype=torch.int32, device="meta"), 2),
         ValueError),
    ],
}


@pytest.mark.parametrize("name,i", [(k, i) for k, v in _BAD.items()
                                    for i in range(len(v))])
def test_batched_wrappers_refuse_bad_input(name, i):
    """Bad dtype, rank, shape, layout, size or device raises before any
    launch."""
    make, err = _BAD[name][i]
    tk.reset_launches()
    with pytest.raises(err):
        getattr(tk, name)(*make())
    assert sum(tk.launches.values()) == 0


def _constants(path):
    return {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", path.read_text())}


def test_hist_constants_mirror_the_cuda_source():
    """The wrapper's route gate and block sizing are the source's own."""
    c = _constants(CSRC / "hist_buckets.cu")
    assert tk._HIST_SMALL_BUCKETS == c["kMaxSmallBuckets"]
    assert tk._HIST_IDS_PER_BLOCK == c["kThreads"] * c["kVecs"] * 4


@pytest.mark.parametrize("P,n,want", [(1, 0, 1), (1, 1, 1), (1, 4096, 1),
                                      (1, 4097, 2), (8, 65_536, 16),
                                      (1, 1_250_001, 306),
                                      (1, 20_000_000, 1056),
                                      (8, 20_000_000, 132),
                                      (2_000, 10**6, 1)])
def test_hist_blocks_per_row(P, n, want):
    assert tk._hist_blocks_per_row(P, n) == want


def test_hist_scratch_is_kept_per_stream_and_tickets_stay_apart(monkeypatch):
    """One (tickets, partials) pair per (device, stream): tickets zeroed,
    each buffer a power of two, reused while big enough and replaced
    when not; tickets never share memory with partials.  (The host side
    only: the kernel sets the tickets back to zero.)"""
    monkeypatch.setattr(tk, "_hist_scratch_bufs", {})
    x = torch.zeros((8, 4), dtype=torch.int32)
    t1, p1 = tk._hist_scratch(x, 7, 8, 1024)
    assert t1.dtype == p1.dtype == torch.int32
    assert t1.numel() == 8 and p1.numel() == 1024 and not t1.any()
    t2, p2 = tk._hist_scratch(x, 7, 3, 100)
    assert t2 is t1 and p2 is p1
    t3, p3 = tk._hist_scratch(x, 7, 5, 2448)
    assert t3 is t1 and p3 is not p1 and p3.numel() == 4096
    t4, p4 = tk._hist_scratch(x, 7, 9, 10)
    assert t4.numel() == 16 and not t4.any() and p4 is p3
    t5, _p5 = tk._hist_scratch(x, 8, 1, 2)
    assert t5 is not t4 and t5.numel() == 1
    assert len(tk._hist_scratch_bufs) == 2
    for t, p in tk._hist_scratch_bufs.values():
        assert t.untyped_storage().data_ptr() != p.untyped_storage(
            ).data_ptr()


# ---------------------------------------------------------------------------
# the exchange, against the per-partition form it replaced


def _per_partition_exchange(parts, dests, out_capacity, send_slack=2):
    """The exchange as it was: each source partition's hist_buckets,
    prefix_sum, sort and slot_expand on its own, then the send buffers
    stacked and permuted to the receive layout."""
    D = len(parts)
    cap = parts[0].capacity
    C = max(1, min(cap, -(-send_slack * cap // D)))
    send, counts_all, spec = [], [], None
    for b, dest in zip(parts, dests):
        dest = torch.where(b.valid_mask(), dest.to(torch.int32), D)
        words, spec = _pack_columns_u32(b.columns)
        counts = tk.hist_buckets(dest, D)
        offsets = tk.prefix_sum(counts) - counts
        order = torch.sort(dest, stable=True).indices
        send.append(tk.slot_expand(words.index_select(0, order), offsets, C))
        counts_all.append(counts)
    W = send[0].shape[1]
    counts_m = torch.stack(counts_all)
    recv = (torch.stack(send).view(D, D, C, W).transpose(0, 1)
            .contiguous().view(D, D * C, W))
    recv_counts = torch.clamp(counts_m, max=C).t().contiguous()
    totals = recv_counts.sum(dim=1, dtype=torch.int32)
    out = [Batch(_unpack_columns_u32(tk.slot_compact(
        recv[d], recv_counts[d], C, out_capacity), spec),
        torch.clamp(totals[d], max=out_capacity)) for d in range(D)]
    max_total = counts_m.sum(dim=0).max().to(torch.int32)
    need_recv = torch.where(max_total > out_capacity, max_total, 0)
    max_cnt = counts_m.max().to(torch.int32)
    need_slack = torch.where(max_cnt > C, -(-max_cnt * D // cap), 0)
    return out, need_recv, need_slack.to(torch.int32), max_cnt


def _same_batch(a: Batch, b: Batch):
    assert int(a.count) == int(b.count)
    assert a.count.dtype == b.count.dtype
    assert list(a.columns) == list(b.columns)
    for k, v in a.columns.items():
        w = b.columns[k]
        if hasattr(v, "lengths"):
            assert torch.equal(v.data, w.data)
            assert torch.equal(v.lengths, w.lengths)
        else:
            assert v.dtype == w.dtype and torch.equal(v, w)


@pytest.mark.parametrize("P,n,keys,out_rows,slack", [
    (8, 1_600, 400, 1_600, 2),     # string + int + float columns
    (8, 800, 1, 800, 2),           # one key: both NEEDs fire
    (8, 800, 1, 1_000, 2),
    (3, 1_000, 50, 700, 1),
    (1, 500, 20, 500, 2),
    (8, 3_000, 10_000, 500, 3),    # receive overflow: rows dropped
])
def test_batched_exchange_is_bit_identical_to_per_partition(
        P, n, keys, out_rows, slack):
    rng = np.random.RandomState(n + keys + P)
    words = [b"w%d" % i for i in range(40)]
    cols = {"k": rng.randint(0, keys, n).astype(np.int32),
            "s": [words[i] for i in rng.randint(0, 40, n)],
            "v": rng.randn(n).astype(np.float32)}
    pd = Context(device="cpu", nparts=P).from_columns(
        cols, str_max_len=7).node.data
    parts = split_partitions(pd)
    dests = [shuffle._canonical_hash_dest(
        shuffle.hash_batch_keys(b, ["k"])[1], P) for b in parts]
    got = shuffle.exchange_by_dest(parts, dests, out_rows, slack)
    want = _per_partition_exchange(parts, dests, out_rows, slack)
    for g, w in zip(got[0], want[0]):
        _same_batch(g, w)
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype and g.shape == w.shape == ()
        assert int(g) == int(w)
