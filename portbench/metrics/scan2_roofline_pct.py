"""The kernels: ``prefix_sum2``'s least time over its measured device time
(its ``scan2_lookback`` records) in the traced jobs, in %.  Each call's
least time is the larger of its bytes over 3.35 TB/s and its operations
over 67 TOP/s (``roofline.py``), from the shapes the capture hook
recorded."""

from portbench import roofline


def read(rec):
    tr = rec["trace"]
    if not tr or not tr["records"] or "prefix_sum2" not in tr["least"]:
        return None
    measured = sum(e - s for n, s, e in tr["records"]
                   if roofline.kernel_of(n) == "prefix_sum2") / 1e9
    least = tr["least"]["prefix_sum2"][1]
    if not measured or not least:
        return None
    return 100.0 * least / measured
