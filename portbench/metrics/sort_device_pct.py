"""The operators (``ops/kernels.py``): the share of the span window's busy
device time under a ``sort`` span (lanes, sorts and their gathers), in %
(``spantrace``)."""

from portbench import spantrace


def read(rec):
    st = spantrace.of(rec)
    return None if st is None else st["metrics"]["sort_device_pct"]
