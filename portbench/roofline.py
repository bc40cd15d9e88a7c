"""The yardstick of the port's hand-written kernels: the card's peaks, the
bytes and operations each kernel call needs, and a recorder of the calls.

The peaks are those of one NVIDIA H100 SXM (NVIDIA's data sheet, at the
full 700 W): 3.35 TB/s of HBM3 bandwidth and 67 TFLOP/s of float32
outside the tensor cores, at which the kernels' int32 adds are counted
too.  A call's least time is the larger of its bytes over the bandwidth
and its operations over the operation rate.  Bytes count each input byte
read once and each output byte written once.

``ShapeLog`` goes in the port's ``ops.hopper_kernels.capture`` hook.  The
hook hands it every call's arguments; it keeps the shape and dtype of
each tensor and, for the small index tensors whose values decide the
work (a ``slot_expand`` call's offsets, a ``slot_compact`` call's
counts), the tensor itself.  It never holds a call's data, so recording
changes no peak.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
KERNELS = ("hist_buckets", "prefix_sum", "prefix_sum2", "slot_expand",
           "slot_compact")
# substrings of each kernel's compiled device function names
DEVICE_NAMES = {
    "hist_buckets": ("hist_small", "hist_shared", "hist_global"),
    "prefix_sum": ("scan_lookback",),
    "prefix_sum2": ("scan2_lookback",),
    "slot_expand": ("slot_expand_v4",),
    "slot_compact": ("slot_compact_v2",),
}
SMALL = 1 << 16     # elements: a tensor this small is kept, not described


class Shape:
    """A tensor's shape and dtype, without its data."""

    def __init__(self, t):
        self.shape = tuple(t.shape)
        self.dtype = t.dtype

    def numel(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def describe(a):
    if hasattr(a, "shape") and hasattr(a, "dtype"):
        return a if a.numel() <= SMALL else Shape(a)
    return a


class _Calls(list):
    def append(self, call):
        size, args = call
        super().append((size, tuple(describe(a) for a in args)))


class ShapeLog(dict):
    """A ``capture`` mapping: kernel -> [(size, described args)]."""

    def setdefault(self, key, default=None):
        if key not in self:
            self[key] = _Calls()
        return self[key]


def kernel_of(device_name: str):
    """The kernel a device function belongs to, or None."""
    for k, subs in DEVICE_NAMES.items():
        if any(s in device_name for s in subs):
            return k
    return None


def work(name: str, args) -> tuple:
    """(bytes the call must move, operations it does) for its arguments
    (tensors or ``Shape``s; the offsets and counts as tensors)."""
    if name == "hist_buckets":
        bid, nb = args      # [P, n]
        return 4 * bid.numel() + 4 * bid.shape[0] * nb, bid.numel()
    if name == "prefix_sum":
        (x,) = args
        return 8 * x.numel(), x.numel()
    if name == "prefix_sum2":
        # f32 in, (hi, lo) out; one TwoSum combine (10 f32 adds) an element
        (x,) = args
        return 12 * x.numel(), 10 * x.numel()
    if name == "slot_expand":
        # rows read: in each partition the union of the runs
        # [start, min(start + C, cap)), which overlap where C exceeds the
        # fair share; rows written: P*D*C
        words, offs, C = args   # [P, cap, W], [P, D]
        P, cap, W = words.shape
        real = 0
        for row in offs.long().clamp(0, cap).tolist():
            reach = 0
            for s in sorted(row):
                s, e = max(s, reach), min(s + C, cap)
                real += max(e - s, 0)
                reach = max(reach, e)
        return 4 * W * (real + offs.numel() * C) + 4 * offs.numel(), 0
    if name == "slot_compact":
        # every destination's out_rows written, its valid rows (at most
        # out_rows) read
        recv, counts, C, out_rows = args    # [Dd, S*C, W], [Dd, S]
        W = recv.shape[2]
        valid = int(counts.long().clamp(0, C).sum(1).clamp(
            max=out_rows).sum())
        return (4 * W * (valid + counts.shape[0] * out_rows)
                + 4 * counts.numel()), 0
    raise KeyError(name)


def least_seconds(name: str, args) -> float:
    b, o = work(name, args)
    return max(b / PEAK_BYTES_PER_S, o / PEAK_OPS_PER_S)


def least_by_kernel(log: dict) -> dict:
    """kernel -> (calls, summed least seconds) over a ``ShapeLog``."""
    return {k: (len(calls), sum(least_seconds(k, a) for _s, a in calls))
            for k, calls in log.items()}
