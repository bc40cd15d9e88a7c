"""The device trace of a few jobs, from ``torch.profiler``, reduced to
what the per-layer readers take: each device record (kernel, copy or
memset) with its name and interval, the host's own spans beside them,
and the union of busy intervals.

torch.profiler on the H100 can drop a contiguous run of a window's first
and last device records.  So a window opens with ``PAD_HEAD`` launches of
a one-element add and a sync, and closes with ``PAD_TAIL`` more; the
pads' records are left out by correlation id.  A window in which a kernel
launch of the jobs has no device record is taken again, jobs and all, at
most ``WINDOWS`` times, and then the run fails: a trace with records
missing would read the card as idler than it was.
"""

from __future__ import annotations

import time

PAD_HEAD, PAD_TAIL, WINDOWS = 1024, 8192, 3


def union_seconds(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``(start, end)`` intervals clipped to
    [lo, hi] (any unit in, the same unit out)."""
    return sum(e - s for s, e in merged(intervals, lo, hi))


def merged(intervals, lo: float, hi: float) -> list:
    """The union of the intervals clipped to [lo, hi], as disjoint
    sorted intervals."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(intervals, lo: float, hi: float) -> list:
    """The idle stretches of [lo, hi] between the merged intervals."""
    out, at = [], lo
    for s, e in merged(intervals, lo, hi):
        if s > at:
            out.append((at, s))
        at = e
    if hi > at:
        out.append((at, hi))
    return out


def profile_jobs(run_jobs, device):
    """``run_jobs()`` (which returns its host spans in
    ``time.perf_counter_ns`` units) under the profiler, in a window that
    has every device record of its kernel launches: at most ``WINDOWS``
    tries.  Returns ``(spans, records, offset_ns)`` of the window kept:
    ``records`` are ``(name, start_ns, end_ns)`` of every device record of
    the jobs in the profiler's clock, and ``offset_ns`` takes a host time
    to that clock.  A dropped window's spans are dropped with it."""
    for _ in range(WINDOWS):
        spans, records, offset, launched, lost = window(run_jobs, device)
        if launched and not lost:
            return spans, records, offset
    raise RuntimeError(f"every one of {WINDOWS} profile windows lacks "
                       f"device records: {lost} of {launched} kernel "
                       f"launches of the jobs have none")


def window(run_jobs, device):
    """One profile window around ``run_jobs()``: ``(spans, records,
    offset_ns, launched, lost)``, the last two the jobs' kernel launches
    and those of them with no device record."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    pad = torch.zeros(1, device=device)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        h0 = time.perf_counter_ns()
        for _ in range(PAD_HEAD):
            pad.add_(1)
        torch.cuda.synchronize()
        spans = run_jobs()
        torch.cuda.synchronize()
        for _ in range(PAD_TAIL):
            pad.add_(1)
        torch.cuda.synchronize()
    launched, recorded, dev = [], set(), []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            recorded.add(e.correlation_id())
            dev.append(e)
        elif "Launch" in e.name() and "Kernel" in e.name():
            launched.append((e.correlation_id(), e.start_ns()))
    launched.sort()
    head, tail = launched[:PAD_HEAD], launched[len(launched) - PAD_TAIL:]
    own = launched[PAD_HEAD:len(launched) - PAD_TAIL]
    lost = sum(c not in recorded for c, _ in own)
    pads = {c for c, _ in head + tail}
    records = [(e.name(), e.start_ns(), e.end_ns()) for e in dev
               if e.correlation_id() not in pads]
    offset = head[0][1] - h0 if head else 0
    return spans, records, offset, len(own), lost
