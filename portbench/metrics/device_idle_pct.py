"""The device: the share of the traced window (the traced jobs' first
start to last end) in which no kernel, copy or memset ran, in %: one
minus the union of the profiler's device intervals over the window."""


def read(rec):
    tr = rec["trace"]
    if not tr or not tr["records"] or not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
