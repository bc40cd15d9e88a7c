"""Host packing: ms per job in the program's ``collect`` span (the shrink,
the copy to the host and the unpacking) in the span window
(``spantrace``)."""

from portbench import spantrace


def read(rec):
    st = spantrace.of(rec)
    return None if st is None else st["metrics"]["collect_span_ms_per_job"]
