"""The exchange: GiB per job of the send grids the exchanges built, the sum
of the ``exchange.*`` spans' ``bytes`` (from shapes) in the span window
(``spantrace``)."""

from portbench import spantrace


def read(rec):
    st = spantrace.of(rec)
    return None if st is None else st["metrics"]["exchange_gib_per_job"]
