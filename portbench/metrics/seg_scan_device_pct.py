"""The operators (``ops/kernels.py``, the group op's scan lowering): the
share of the span window's busy device time under a ``seg_scan`` span, in
% (``spantrace``).  None where the program opens no such span."""

from portbench import spantrace


def read(rec):
    st = spantrace.of(rec)
    if st is None or not any(s["name"] == "seg_scan" for s in st["spans"]):
        return None
    return spantrace.share(st, lambda s: s == "seg_scan")
