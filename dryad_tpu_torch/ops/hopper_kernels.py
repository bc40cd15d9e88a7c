"""Hand-written Hopper kernels for the data-plane hot spots, with their
plain PyTorch versions.

The port's counterparts of the five TPU kernels in
``dryad_tpu/ops/pallas_kernels.py``:

  * ``hist_buckets`` — counts of ids in [0, n_buckets) (exchange slot
    sizing), ``hist_buckets_batched`` for P rows of ids in one launch;
  * ``prefix_sum`` — inclusive 1-D scan, modular for 32-bit integers
    (tokenizer slot bases, boundary-carry integer group sums, exchange
    offsets);
  * ``prefix_sum2`` — compensated (double-single) f32 inclusive scan
    returning a (hi, lo) pair per prefix (boundary-carry f32 group sums);
  * ``slot_expand`` / ``slot_compact`` — the exchange's send-slot grid
    and receive-side compaction; ``slot_expand_batched`` expands all P
    source partitions in one launch, straight into the receive layout,
    and ``slot_compact_batched`` compacts every destination's receive
    buffer in one launch.

A one-row (one-partition) call of a batched kernel is the batched call
with P = 1: one kernel, one launch counter, one capture name.

Each kernel is CUDA C++ for ``sm_90a`` under ``csrc/`` (its file says what
it replaces, what bounds it and how it is built), compiled by ``_build`` on
first use and called through ``ctypes`` on PyTorch's current stream.

A wrapper takes the plain version ONLY for a tensor that lies on the CPU
(the tests).  A CUDA tensor gets the kernel or an exception: there is no
fallback, no switch and no size gate.  ``launches`` counts, per kernel,
the wrapper calls that launched it, so a run can show that its main path
went through the kernels; ``capture`` records a batched call under the
kernel's own name with its batched arguments.

32-bit packed words travel as ``torch.int32`` tensors holding the bits
(PyTorch's ``uint32`` lacks most kernels); ``prefix_sum`` also takes
``torch.uint32``.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from dryad_tpu_torch.ops import _build
from dryad_tpu_torch.ops.scan import associative_scan

__all__ = ["hist_buckets", "hist_buckets_batched", "prefix_sum",
           "prefix_sum2", "slot_expand", "slot_expand_batched",
           "slot_compact", "slot_compact_batched", "hist_buckets_plain",
           "hist_buckets_batched_plain", "prefix_sum_plain",
           "prefix_sum2_plain", "slot_expand_plain",
           "slot_expand_batched_plain", "slot_compact_plain",
           "slot_compact_batched_plain", "dd_add", "launches",
           "reset_launches"]

launches = {"hist_buckets": 0, "prefix_sum": 0, "prefix_sum2": 0,
            "slot_expand": 0, "slot_compact": 0}

_SCAN_TILE = 4096            # kTile of csrc/prefix_sum.cu and prefix_sum2.cu
_SCAN_HEAD_WORDS = 2         # lookback::kHeadWords of csrc/scan_lookback.cuh
# kScratchWordsPerTile of each scan's source
_SCAN_SCRATCH_WORDS = {"prefix_sum": 1, "prefix_sum2": 2}
_HIST_SMALL_BUCKETS = 32     # kMaxSmallBuckets of csrc/hist_buckets.cu
_HIST_IDS_PER_BLOCK = 4096   # its kThreads x kVecs x 4 ids a block pass
_HIST_MAX_BLOCKS = 132 * 8   # one wave of 256-thread blocks on an H100
_MAX_COMPACT_SOURCES = 4096  # starts[S + 1] of csrc/slot_compact.cu in
                             # shared memory (8 bytes each, under 48 KB)


# chip_smoke.py's hook, not API: a dict gets every wrapper call's
# (size, args), listed by kernel.
capture = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# set inside ``shape_only()``: meta tensors may take the plain versions
_shape_only = threading.local()


@contextlib.contextmanager
def shape_only():
    """Within this block (the static cost model's shape-only run,
    ``analysis/cost.py``) a wrapper given meta tensors runs its plain
    version on them: shapes and dtypes only, no data, nothing computed and
    nothing launched.  Outside it a meta tensor is refused like any other
    device but cpu and cuda."""
    prev = getattr(_shape_only, "on", False)
    _shape_only.on = True
    try:
        yield
    finally:
        _shape_only.on = prev


def _capture(name: str, size: int, *args) -> None:
    # a shape-only call launches nothing: there is no call to hold
    if capture is not None and not getattr(_shape_only, "on", False):
        capture.setdefault(name, []).append((size, args))


def _check(name: str, t: torch.Tensor, dtypes, ndim: int) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _on_card(name: str, *ts: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (plain version) and, inside ``shape_only()``, for meta tensors;
    anything else, or a mix, raises."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on different devices {devs}")
    kind = next(iter(devs)).type
    if kind == "cpu" or (kind == "meta"
                         and getattr(_shape_only, "on", False)):
        return False
    if kind == "cuda":
        return True
    raise ValueError(f"{name}: unsupported device {devs}")


def _ok(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def _stream(t: torch.Tensor) -> int:
    """The current stream of ``t``'s device, as the raw handle."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _scan_scratch_words(name: str, n: int) -> int:
    """64-bit words of the look-back scratch a scan of n values needs: the
    head (ticket, blocks done), then each tile's words; 0 when one tile
    covers n (the kernel then touches no scratch)."""
    tiles = -(-n // _SCAN_TILE)
    if tiles <= 1:
        return 0
    return _SCAN_HEAD_WORDS + _SCAN_SCRATCH_WORDS[name] * tiles


# (scan, device index, stream) -> its look-back scratch.  A scan's kernel
# needs the scratch's head and flags zero at launch and leaves them so,
# and launches on one stream run in order, so one zeroed buffer serves
# every call of that scan on that stream: no allocation and no clearing
# per call.  Process-wide, like the streams it follows.
_scan_scratch_bufs = {}


def _scan_scratch(name: str, x: torch.Tensor, stream: int):
    """The scratch for one scan launch on ``stream`` (None for a single
    tile), replaced by a larger zeroed one when n outgrows it.  The caller
    holds it until the launch is queued: a replaced buffer is freed in
    stream order only after that."""
    words = _scan_scratch_words(name, x.numel())
    if not words:
        return None
    key = (name, x.get_device(), stream)
    buf = _scan_scratch_bufs.get(key)
    if buf is None or buf.numel() < words:
        buf = torch.zeros(1 << (words - 1).bit_length(), dtype=torch.int64,
                          device=x.device)
        _scan_scratch_bufs[key] = buf
    return buf


# ---------------------------------------------------------------------------
# hist_buckets


def _hist_blocks_per_row(P: int, n: int) -> int:
    """Blocks a row of ids gets: one per _HIST_IDS_PER_BLOCK ids, at most
    one wave of _HIST_MAX_BLOCKS over the P rows, at least one."""
    return max(1, min(-(-n // _HIST_IDS_PER_BLOCK),
                      _HIST_MAX_BLOCKS // P))


# (device index, stream) -> (tickets, partials) of the small-bucket
# route.  The kernel needs the P tickets zero at launch and leaves them so,
# so one zeroed buffer serves every call on the stream; the partials are
# written before they are read.  Tickets and partials are separate
# buffers, so a queued call's partials never land on a later call's
# tickets, whatever the sizes.
_hist_scratch_bufs = {}


def _hist_scratch(bid: torch.Tensor, stream: int, P: int, words: int):
    """(tickets >= P int32 zeros, partials >= ``words`` int32) for one
    launch on ``stream``, each replaced by a larger one when outgrown (a
    power of two; new tickets zeroed).  The caller holds them until the
    launch is queued."""
    key = (bid.get_device(), stream)
    tickets, partials = _hist_scratch_bufs.get(key, (None, None))
    if tickets is None or tickets.numel() < P:
        tickets = torch.zeros(1 << (P - 1).bit_length(), dtype=torch.int32,
                              device=bid.device)
    if partials is None or partials.numel() < words:
        partials = torch.empty(1 << (words - 1).bit_length(),
                               dtype=torch.int32, device=bid.device)
    _hist_scratch_bufs[key] = (tickets, partials)
    return tickets, partials


def hist_buckets_plain(bid: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """bincount of the ids in [0, n_buckets); others fold into a dropped
    bucket."""
    oob = torch.where((bid < 0) | (bid > n_buckets),
                      torch.full_like(bid, n_buckets), bid)
    return torch.bincount(oob.long(), minlength=n_buckets + 1
                          )[:n_buckets].to(torch.int32)


def hist_buckets_batched_plain(bid: torch.Tensor,
                               n_buckets: int) -> torch.Tensor:
    """``hist_buckets_plain`` of each row, stacked: one bincount over the
    rows' ids shifted to row p's own n_buckets + 1 bins."""
    P = bid.shape[0]
    oob = torch.where((bid < 0) | (bid > n_buckets),
                      torch.full_like(bid, n_buckets), bid).long()
    oob += torch.arange(P, device=bid.device)[:, None] * (n_buckets + 1)
    return torch.bincount(oob.reshape(-1), minlength=P * (n_buckets + 1)
                          ).view(P, n_buckets + 1)[:, :n_buckets].to(
                              torch.int32)


def hist_buckets_batched(bid: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Counts of each bucket id in [0, n_buckets), row by row, in one
    launch; other ids (the invalid-row sentinel ``n_buckets``, negatives)
    are ignored.  bid: i32 [P, n] -> i32 [P, n_buckets]; row p is
    ``hist_buckets(bid[p], n_buckets)``."""
    _check("hist_buckets", bid, (torch.int32,), 2)
    if n_buckets < 0:
        raise ValueError(f"hist_buckets: n_buckets {n_buckets} < 0")
    P, n = bid.shape
    if not 1 <= P <= 65535:
        raise ValueError(f"hist_buckets: 1 to 65535 rows, got {P}")
    _capture("hist_buckets", bid.numel(), bid, n_buckets)
    if not _on_card("hist_buckets", bid):
        return hist_buckets_batched_plain(bid, n_buckets)
    out = torch.empty((P, n_buckets), dtype=torch.int32, device=bid.device)
    if n_buckets == 0:
        return out
    bpr = _hist_blocks_per_row(P, n)
    stream = _stream(bid)
    tickets = partials = None
    if bpr > 1 and n_buckets <= _HIST_SMALL_BUCKETS:
        tickets, partials = _hist_scratch(bid, stream, P,
                                          P * bpr * n_buckets)
    lib = _build.library("hist_buckets")
    _ok("hist_buckets", lib.dryad_hist_buckets(
        bid.data_ptr(), P, n, n_buckets, bpr, out.data_ptr(),
        None if tickets is None else tickets.data_ptr(),
        None if partials is None else partials.data_ptr(), stream))
    launches["hist_buckets"] += 1
    return out


def hist_buckets(bid: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Counts of each bucket id in [0, n_buckets); other ids (the invalid
    row sentinel ``n_buckets``, negatives) are ignored.  bid: i32 [n] ->
    i32 [n_buckets].  The one-row call of ``hist_buckets_batched``."""
    _check("hist_buckets", bid, (torch.int32,), 1)
    return hist_buckets_batched(bid[None], n_buckets)[0]


# ---------------------------------------------------------------------------
# prefix_sum

_SCAN_DTYPES = (torch.int32, torch.uint32, torch.float32)


def prefix_sum_plain(x: torch.Tensor) -> torch.Tensor:
    """cumsum with an explicit accumulation dtype; 32-bit integers wrap
    modulo 2**32 like the kernel."""
    if x.dtype == torch.float32:
        return torch.cumsum(x, 0, dtype=torch.float32)
    c = torch.cumsum(x.to(torch.int64), 0, dtype=torch.int64) & 0xFFFFFFFF
    if x.dtype == torch.uint32:
        return c.to(torch.uint32)
    return (c - ((c >> 31) << 32)).to(torch.int32)


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive 1-D prefix sum of f32 / i32 / u32 [n] -> same."""
    _check("prefix_sum", x, _SCAN_DTYPES, 1)
    _capture("prefix_sum", x.numel(), x)
    if not _on_card("prefix_sum", x):
        return prefix_sum_plain(x)
    n = x.numel()
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    if n == 0:
        return y
    lib = _build.library("prefix_sum")
    fn = (lib.dryad_prefix_sum_f32 if x.dtype == torch.float32
          else lib.dryad_prefix_sum_u32)
    stream = _stream(x)
    scratch = _scan_scratch("prefix_sum", x, stream)
    _ok("prefix_sum", fn(x.data_ptr(), y.data_ptr(), n,
                         scratch if scratch is None else scratch.data_ptr(),
                         stream))
    launches["prefix_sum"] += 1
    return y


# ---------------------------------------------------------------------------
# prefix_sum2


def dd_add(hi1: torch.Tensor, lo1: torch.Tensor, hi2: torch.Tensor,
           lo2: torch.Tensor):
    """Double-single (compensated) f32 add: Knuth's TwoSum of the high
    parts + Dekker's renormalisation — the JAX package's ``_dd_add``
    (``pallas_kernels.py:205``) step for step, and the kernel's combine.
    (hi1, lo1) is the earlier operand."""
    s = hi1 + hi2
    bb = s - hi1
    err = (hi1 - (s - bb)) + (hi2 - bb)
    lo = lo1 + lo2 + err
    hi_n = s + lo
    lo_n = lo - (hi_n - s)
    return hi_n, lo_n


def prefix_sum2_plain(x: torch.Tensor):
    """``dd_add`` as a log-step (Hillis–Steele) inclusive scan in f32."""
    return associative_scan(lambda a, b: dd_add(a[0], a[1], b[0], b[1]),
                            (x, torch.zeros_like(x)))


def prefix_sum2(x: torch.Tensor):
    """Compensated inclusive prefix sum of f32 [n] -> (hi, lo), each f32
    [n]: hi + lo is the prefix to about twice f32's precision.  Callers
    that difference two prefixes difference BOTH lanes."""
    _check("prefix_sum2", x, (torch.float32,), 1)
    _capture("prefix_sum2", x.numel(), x)
    if not _on_card("prefix_sum2", x):
        return prefix_sum2_plain(x)
    n = x.numel()
    hi = torch.empty(n, dtype=x.dtype, device=x.device)
    lo = torch.empty(n, dtype=x.dtype, device=x.device)
    if n == 0:
        return hi, lo
    lib = _build.library("prefix_sum2")
    stream = _stream(x)
    scratch = _scan_scratch("prefix_sum2", x, stream)
    _ok("prefix_sum2", lib.dryad_prefix_sum2_f32(
        x.data_ptr(), hi.data_ptr(), lo.data_ptr(), n,
        scratch if scratch is None else scratch.data_ptr(), stream))
    launches["prefix_sum2"] += 1
    return hi, lo


# ---------------------------------------------------------------------------
# exchange pack/unpack


def _check_offsets(name: str, t: torch.Tensor) -> None:
    _check(name, t, (torch.int32,), 1)
    if t.numel() < 1:
        raise ValueError(f"{name}: needs at least one block")


def slot_expand_plain(words: torch.Tensor, offsets: torch.Tensor,
                      C: int) -> torch.Tensor:
    """Index gather from the source padded with C zero rows."""
    D = offsets.shape[0]
    return slot_expand_batched_plain(words[None], offsets[None], C).view(
        D * C, words.shape[1])


def slot_expand_batched_plain(words: torch.Tensor, offsets: torch.Tensor,
                              C: int) -> torch.Tensor:
    """``slot_expand_plain`` of each partition, in the receive layout
    [D, P*C, W]: one index gather from every partition padded with C zero
    rows, straight in receive order, contiguous as the kernel's output
    is."""
    P, cap, W = words.shape
    D = offsets.shape[1]
    xp = torch.cat([words, words.new_zeros((P, C, W))], 1).view(
        P * (cap + C), W)
    start = offsets.long().clamp(0, cap) + torch.arange(
        P, device=words.device)[:, None] * (cap + C)          # [P, D]
    src = start.t()[:, :, None] + torch.arange(C, device=words.device)
    return xp.index_select(0, src.reshape(-1)).view(D, P * C, W)


def slot_expand_batched(words: torch.Tensor, offsets: torch.Tensor,
                        C: int) -> torch.Tensor:
    """Send-slot expansion of P partitions at once, in the receive layout.
    ``words`` is P dest-sorted packed row matrices [P, cap, W] (32-bit
    words as int32); in partition p, destination d's rows start at
    ``offsets[p, d]`` (i32 [P, D]).  Returns [D, P*C, W]: rows
    [p*C, (p+1)*C) of block d are the C rows of partition p starting at
    clip(offsets[p, d], 0, cap), padded with C zero rows — what
    ``slot_expand(words[p], offsets[p], C)`` puts in its block d.  Slots
    past a run's count are for the receiver to mask."""
    _check("slot_expand", words, (torch.int32,), 3)
    _check("slot_expand", offsets, (torch.int32,), 2)
    P, cap, W = words.shape
    D = offsets.shape[1]
    if offsets.shape[0] != P or not 1 <= P <= 65535:
        raise ValueError(f"slot_expand: offsets {tuple(offsets.shape)} is "
                         f"not [P, D] for P={P} (1 to 65535)")
    if not 1 <= D <= 65535:
        raise ValueError(f"slot_expand: 1 to 65535 destinations, got {D}")
    if C < 1:
        raise ValueError(f"slot_expand: C must be >= 1, got {C}")
    _capture("slot_expand", D * P * C * W, words, offsets, C)
    if not _on_card("slot_expand", words, offsets):
        return slot_expand_batched_plain(words, offsets, C)
    out = torch.empty((D, P * C, W), dtype=torch.int32, device=words.device)
    lib = _build.library("slot_expand")
    _ok("slot_expand", lib.dryad_slot_expand(
        words.data_ptr(), P, cap, W, offsets.data_ptr(), D, C,
        out.data_ptr(), _stream(words)))
    launches["slot_expand"] += 1
    return out


def slot_expand(words: torch.Tensor, offsets: torch.Tensor,
                C: int) -> torch.Tensor:
    """Send-slot expansion: ``words`` is the dest-sorted packed row matrix
    [cap, W] (32-bit words as int32); destination d's rows start at
    ``offsets[d]`` (i32 [D]).  Returns [D*C, W] whose block d holds the C
    rows starting at clip(offsets[d], 0, cap) of ``words`` padded with C
    zero rows; slots past the run's count are for the receiver to mask.
    The one-partition call of ``slot_expand_batched``."""
    _check("slot_expand", words, (torch.int32,), 2)
    _check_offsets("slot_expand", offsets)
    return slot_expand_batched(words[None], offsets[None], C).view(
        offsets.shape[0] * C, words.shape[1])


def slot_compact_plain(words: torch.Tensor, counts: torch.Tensor, C: int,
                       out_rows: int) -> torch.Tensor:
    """Each block's valid prefix, in block order, written densely from row
    0 (the kept rows' running starts are exactly 0, 1, 2, ...); rows past
    ``out_rows`` are dropped and the rest stays zero."""
    return slot_compact_batched_plain(words[None], counts[None], C,
                                      out_rows)[0]


def slot_compact_batched_plain(recv: torch.Tensor, counts: torch.Tensor,
                               C: int, out_rows: int) -> torch.Tensor:
    """``slot_compact_plain`` of each destination, stacked: one mask over
    every destination's slots, the kept rows copied to their positions
    (destination d's k-th kept row to row k of slice d)."""
    Dd, SC, W = recv.shape
    S = counts.shape[1]
    cnt = counts.long().clamp(0, C)
    j = torch.arange(C, device=recv.device)
    keep = (j[None, None, :] < cnt[:, :, None]).reshape(Dd, S * C)[:, :SC]
    if SC > S * C:      # rows past the last block are never valid
        keep = torch.cat([keep, keep.new_zeros((Dd, SC - S * C))], 1)
    pos = torch.cumsum(keep, 1) - 1
    keep &= pos < out_rows
    out = recv.new_zeros((Dd * out_rows, W))
    dest = (pos + torch.arange(Dd, device=recv.device)[:, None] * out_rows)
    out[dest[keep]] = recv[keep]
    return out.view(Dd, out_rows, W)


def slot_compact_batched(recv: torch.Tensor, counts: torch.Tensor, C: int,
                         out_rows: int) -> torch.Tensor:
    """Receive-slot compaction of Dd destinations at once.  ``recv`` is
    the receive grid [Dd, S*C, W] (32-bit words as int32, as
    ``slot_expand_batched`` writes it); in destination d, source block
    s's valid rows are the prefix min(counts[d, s], C) of rows
    [s*C, (s+1)*C) (counts i32 [Dd, S]).  Returns [Dd, out_rows, W]:
    slice d holds destination d's valid rows dense at the front in source
    order and zeros after its total; rows past ``out_rows`` are
    dropped."""
    _check("slot_compact", recv, (torch.int32,), 3)
    _check("slot_compact", counts, (torch.int32,), 2)
    Dd, rows, W = recv.shape
    S = counts.shape[1]
    if counts.shape[0] != Dd or not 1 <= Dd <= 65535:
        raise ValueError(f"slot_compact: counts {tuple(counts.shape)} is "
                         f"not [Dd, S] for Dd={Dd} (1 to 65535)")
    if not 1 <= S <= _MAX_COMPACT_SOURCES:
        raise ValueError(f"slot_compact: 1 to {_MAX_COMPACT_SOURCES} "
                         f"source blocks, got {S}")
    if C < 1 or rows != S * C:
        raise ValueError(f"slot_compact: recv {tuple(recv.shape)} is not "
                         f"[Dd, S*C, W] for S={S}, C={C}")
    if out_rows < 0:
        raise ValueError(f"slot_compact: out_rows {out_rows} < 0")
    _capture("slot_compact", Dd * out_rows * W, recv, counts, C, out_rows)
    if not _on_card("slot_compact", recv, counts):
        return slot_compact_batched_plain(recv, counts, C, out_rows)
    out = torch.empty((Dd, out_rows, W), dtype=torch.int32,
                      device=recv.device)
    lib = _build.library("slot_compact")
    _ok("slot_compact", lib.dryad_slot_compact(
        recv.data_ptr(), counts.data_ptr(), Dd, S, C, W, out_rows,
        out.data_ptr(), _stream(recv)))
    launches["slot_compact"] += 1
    return out


def slot_compact(words: torch.Tensor, counts: torch.Tensor, C: int,
                 out_rows: int) -> torch.Tensor:
    """Receive-slot compaction: ``words`` is the received slot buffer
    [S*C, W] where source block s's valid rows are the prefix
    min(counts[s], C) of rows [s*C, (s+1)*C).  Returns [out_rows, W] with
    the valid rows dense at the front in source order and zeros after the
    total; rows past ``out_rows`` are dropped.  The one-destination call
    of ``slot_compact_batched``."""
    _check("slot_compact", words, (torch.int32,), 2)
    _check_offsets("slot_compact", counts)
    return slot_compact_batched(words[None], counts[None], C, out_rows)[0]
