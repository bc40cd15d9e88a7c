"""The API and planner layer: ms per job from the job's start to its
first call of the executor's ``run`` (the harness's own span)."""


def read(rec):
    spans = [j["t_run"] - j["t0"] for j in rec["jobs"] if "t_run" in j]
    return sum(spans) / len(spans) / 1e6 if spans else None
