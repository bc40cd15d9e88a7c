"""The executor: attempts per stage over the window's jobs, from the
stage log (1 when no stage retried; a capacity retry or a settle replay
adds one)."""


def read(rec):
    stages = [s for j in rec["jobs"] for s in j["stages"]]
    if not stages:
        return None
    return sum(s["attempts"] for s in stages) / len(stages)
