"""The loop (``Context.do_while``): synchronising runtime calls
(``spantrace.SYNCS``) inside the ``loop.iter`` spans, per superstep, in
the span window (``spantrace``).  None without a device trace, or where
the program opens no such span."""

from portbench import spantrace


def read(rec):
    st = spantrace.of(rec)
    if st is None or not st["records"]:
        return None
    iters = sum(1 for s in st["spans"] if s["name"] == "loop.iter")
    if not iters:
        return None
    return sum(1 for _n, path, _in_run in st["syncs"]
               if "loop.iter" in path.split("/")) / iters
