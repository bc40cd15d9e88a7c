"""Host packing: ms per job from the executor's ``run`` returning to the
job's end, for a job whose terminal is ``collect`` (the harness's own
span: the shrink, the copy to the host and the unpacking)."""


def read(rec):
    if rec["terminal"] != "collect":
        return None
    spans = [j["t1"] - j["t_ret"] for j in rec["jobs"] if "t_ret" in j]
    return sum(spans) / len(spans) / 1e6 if spans else None
