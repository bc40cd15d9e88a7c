"""Hand-written Hopper kernels for the data-plane hot spots, with their
plain PyTorch versions.

The port's counterparts of the five TPU kernels in
``dryad_tpu/ops/pallas_kernels.py``:

  * ``hist_buckets`` — counts of ids in [0, n_buckets) (exchange slot
    sizing);
  * ``prefix_sum`` — inclusive 1-D scan, modular for 32-bit integers
    (tokenizer slot bases, boundary-carry integer group sums, exchange
    offsets);
  * ``prefix_sum2`` — compensated (double-single) f32 inclusive scan
    returning a (hi, lo) pair per prefix (boundary-carry f32 group sums);
  * ``slot_expand`` / ``slot_compact`` — the exchange's send-slot grid
    and receive-side compaction.

Each kernel is CUDA C++ for ``sm_90a`` under ``csrc/`` (its file says what
it replaces, what bounds it and how it is built), compiled by ``_build`` on
first use and called through ``ctypes`` on PyTorch's current stream.

A wrapper takes the plain version ONLY for a tensor that lies on the CPU
(the tests).  A CUDA tensor gets the kernel or an exception: there is no
fallback, no switch and no size gate.  ``launches`` counts, per kernel,
the wrapper calls that launched it, so a run can show that its main path
went through the kernels.

32-bit packed words travel as ``torch.int32`` tensors holding the bits
(PyTorch's ``uint32`` lacks most kernels); ``prefix_sum`` also takes
``torch.uint32``.
"""

from __future__ import annotations

import torch

from dryad_tpu_torch.ops import _build
from dryad_tpu_torch.ops.scan import associative_scan

__all__ = ["hist_buckets", "prefix_sum", "prefix_sum2", "slot_expand",
           "slot_compact", "hist_buckets_plain", "prefix_sum_plain",
           "prefix_sum2_plain", "slot_expand_plain", "slot_compact_plain",
           "dd_add", "launches", "reset_launches"]

launches = {"hist_buckets": 0, "prefix_sum": 0, "prefix_sum2": 0,
            "slot_expand": 0, "slot_compact": 0}

_SCAN_TILE = 4096            # kTile of csrc/prefix_sum.cu and prefix_sum2.cu
_SCAN_HEAD_WORDS = 2         # lookback::kHeadWords of csrc/scan_lookback.cuh
# kScratchWordsPerTile of each scan's source
_SCAN_SCRATCH_WORDS = {"prefix_sum": 1, "prefix_sum2": 2}
_MAX_COMPACT_SOURCES = 4096  # starts[D + 1] of csrc/slot_compact.cu in
                             # shared memory (8 bytes each, under 48 KB)


# chip_smoke.py's hook, not API: a dict gets every wrapper call's
# (size, args), listed by kernel.
capture = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _capture(name: str, size: int, *args) -> None:
    if capture is not None:
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
    (plain version); anything else, or a mix, raises."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on different devices {devs}")
    kind = next(iter(devs)).type
    if kind == "cpu":
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


def hist_buckets_plain(bid: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """bincount of the ids in [0, n_buckets); others fold into a dropped
    bucket."""
    oob = torch.where((bid < 0) | (bid > n_buckets),
                      torch.full_like(bid, n_buckets), bid)
    return torch.bincount(oob.long(), minlength=n_buckets + 1
                          )[:n_buckets].to(torch.int32)


def hist_buckets(bid: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Counts of each bucket id in [0, n_buckets); other ids (the invalid
    row sentinel ``n_buckets``, negatives) are ignored.  bid: i32 [n] ->
    i32 [n_buckets]."""
    _check("hist_buckets", bid, (torch.int32,), 1)
    if n_buckets < 0:
        raise ValueError(f"hist_buckets: n_buckets {n_buckets} < 0")
    _capture("hist_buckets", bid.numel(), bid, n_buckets)
    if not _on_card("hist_buckets", bid):
        return hist_buckets_plain(bid, n_buckets)
    out = torch.empty(n_buckets, dtype=torch.int32, device=bid.device)
    lib = _build.library("hist_buckets")
    _ok("hist_buckets", lib.dryad_hist_buckets(
        bid.data_ptr(), bid.numel(), n_buckets, out.data_ptr(),
        _stream(bid)))
    launches["hist_buckets"] += 1
    return out


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
    cap, W = words.shape
    D = offsets.shape[0]
    xp = torch.cat([words, words.new_zeros((C, W))])
    start = offsets.long().clamp(0, cap)
    src = (start[:, None] + torch.arange(C, device=words.device)[None, :])
    return xp.index_select(0, src.reshape(-1)).reshape(D * C, W)


def slot_expand(words: torch.Tensor, offsets: torch.Tensor,
                C: int) -> torch.Tensor:
    """Send-slot expansion: ``words`` is the dest-sorted packed row matrix
    [cap, W] (32-bit words as int32); destination d's rows start at
    ``offsets[d]`` (i32 [D]).  Returns [D*C, W] whose block d holds the C
    rows starting at clip(offsets[d], 0, cap) of ``words`` padded with C
    zero rows; slots past the run's count are for the receiver to mask."""
    _check("slot_expand", words, (torch.int32,), 2)
    _check_offsets("slot_expand", offsets)
    if C < 1:
        raise ValueError(f"slot_expand: C must be >= 1, got {C}")
    if offsets.shape[0] > 65535:
        raise ValueError("slot_expand: at most 65535 destinations")
    _capture("slot_expand", offsets.shape[0] * C * words.shape[1], words,
             offsets, C)
    if not _on_card("slot_expand", words, offsets):
        return slot_expand_plain(words, offsets, C)
    cap, W = words.shape
    D = offsets.shape[0]
    out = torch.empty((D * C, W), dtype=torch.int32, device=words.device)
    lib = _build.library("slot_expand")
    _ok("slot_expand", lib.dryad_slot_expand(
        words.data_ptr(), cap, W, offsets.data_ptr(), D, C, out.data_ptr(),
        _stream(words)))
    launches["slot_expand"] += 1
    return out


def slot_compact_plain(words: torch.Tensor, counts: torch.Tensor, C: int,
                       out_rows: int) -> torch.Tensor:
    """Index scatter of each block's valid prefix to its running start;
    everything else, and the dump row for dropped rows, stays zero."""
    S, W = words.shape
    cnt = counts.long().clamp(0, C)
    starts = torch.cumsum(cnt, 0) - cnt
    idx = torch.arange(S, device=words.device)
    blk, j = idx // C, idx % C
    dest = starts[blk] + j
    keep = (j < cnt[blk]) & (dest < out_rows)
    out = words.new_zeros((out_rows + 1, W))
    out[torch.where(keep, dest, torch.full_like(dest, out_rows))] = words
    return out[:out_rows]


def slot_compact(words: torch.Tensor, counts: torch.Tensor, C: int,
                 out_rows: int) -> torch.Tensor:
    """Receive-slot compaction: ``words`` is the received slot buffer
    [D*C, W] where source block s's valid rows are the prefix
    min(counts[s], C) of rows [s*C, (s+1)*C).  Returns [out_rows, W] with
    the valid rows dense at the front in source order and zeros after the
    total; rows past ``out_rows`` are dropped."""
    _check("slot_compact", words, (torch.int32,), 2)
    _check_offsets("slot_compact", counts)
    D = counts.shape[0]
    if C < 1 or words.shape[0] != D * C:
        raise ValueError(f"slot_compact: words {tuple(words.shape)} is not "
                         f"[D*C, W] for D={D}, C={C}")
    if out_rows < 0:
        raise ValueError(f"slot_compact: out_rows {out_rows} < 0")
    if D > _MAX_COMPACT_SOURCES:
        raise ValueError(f"slot_compact: at most {_MAX_COMPACT_SOURCES} "
                         f"source blocks")
    _capture("slot_compact", out_rows * words.shape[1], words, counts, C,
             out_rows)
    if not _on_card("slot_compact", words, counts):
        return slot_compact_plain(words, counts, C, out_rows)
    W = words.shape[1]
    out = torch.empty((out_rows, W), dtype=torch.int32, device=words.device)
    lib = _build.library("slot_compact")
    _ok("slot_compact", lib.dryad_slot_compact(
        words.data_ptr(), counts.data_ptr(), D, C, W, out_rows,
        out.data_ptr(), _stream(words)))
    launches["slot_compact"] += 1
    return out
