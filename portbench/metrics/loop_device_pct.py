"""The loop (``Context.do_while``): the share of the span window's busy
device time under a ``loop.iter`` span, in % (``spantrace``); the rest is
the degrees, the cached join, the loop's first table and the collect.
None where the program opens no such span."""

from portbench import spantrace


def read(rec):
    st = spantrace.of(rec)
    if st is None or not any(s["name"] == "loop.iter" for s in st["spans"]):
        return None
    return spantrace.share(st, lambda s: s == "loop.iter")
