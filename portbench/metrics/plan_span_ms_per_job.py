"""The API and planner: ms per job in the program's ``plan`` span (the
planning, the lint and the cost report, up to the executor's run) in
the span window (``spantrace``)."""

from portbench import spantrace


def read(rec):
    st = spantrace.of(rec)
    return None if st is None else st["metrics"]["plan_span_ms_per_job"]
