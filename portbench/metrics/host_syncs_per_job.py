"""The executor: synchronising runtime calls (``spantrace.SYNCS``) inside
the jobs' ``run`` spans, per job of the span window (``spantrace``)."""

from portbench import spantrace


def read(rec):
    st = spantrace.of(rec)
    return None if st is None else st["metrics"]["host_syncs_per_job"]
