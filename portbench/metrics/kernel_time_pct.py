"""The kernels: the five hand-written kernels' share of the device's busy
time in the traced jobs, in %, from the profiler's device records by
kernel name."""

from portbench import devtrace, roofline


def read(rec):
    tr = rec["trace"]
    if not tr or not tr["records"] or not tr["busy_s"]:
        return None
    ours = [(s, e) for n, s, e in tr["records"] if roofline.kernel_of(n)]
    if not ours:
        return None
    t = devtrace.union_seconds(ours, tr["lo_ns"], tr["hi_ns"]) / 1e9
    return 100.0 * t / tr["busy_s"]
