"""The exchange: the share of the span window's busy device time under an
``exchange.*`` span (its ``hash``, ``pack`` and ``unpack`` included), in %
(``spantrace``)."""

from portbench import spantrace


def read(rec):
    st = spantrace.of(rec)
    return None if st is None else st["metrics"]["exchange_device_pct"]
