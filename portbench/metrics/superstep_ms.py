"""The loop (``Context.do_while``): mean wall time of a superstep in ms,
the program's ``loop.iter`` spans (one around each iteration's run) in
the span window (``spantrace``).  None where the program opens no such
span."""

from portbench import spantrace


def read(rec):
    st = spantrace.of(rec)
    if st is None:
        return None
    ns = [s["end_ns"] - s["start_ns"] for s in st["spans"]
          if s["name"] == "loop.iter"]
    return sum(ns) / len(ns) / 1e6 if ns else None
