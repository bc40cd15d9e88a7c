"""The operators (``ops/hashing.py``): the share of the span window's busy
device time under a ``hash`` span, wherever it nests, in %
(``spantrace``)."""

from portbench import spantrace


def read(rec):
    st = spantrace.of(rec)
    return None if st is None else st["metrics"]["hash_device_pct"]
