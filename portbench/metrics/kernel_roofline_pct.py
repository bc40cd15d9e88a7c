"""The kernels: the five hand-written kernels' least time over their
measured device time in the traced jobs, in %.  Each call's least time
is the larger of its bytes over 3.35 TB/s and its operations over 67
TOP/s (``roofline.py``), from the shapes the capture hook recorded."""

from portbench import roofline


def read(rec):
    tr = rec["trace"]
    if not tr or not tr["records"]:
        return None
    measured = sum(e - s for n, s, e in tr["records"]
                   if roofline.kernel_of(n)) / 1e9
    least = sum(t for _calls, t in tr["least"].values())
    if not measured or not least:
        return None
    return 100.0 * least / measured
