"""Input rows of every job completed in the window, over the window's
seconds (the first job's start to the last job's end, host clock)."""


def read(rec):
    jobs = rec["jobs"]
    return len(jobs) * rec["rows_per_job"] / (
        (jobs[-1]["t1"] - jobs[0]["t0"]) / 1e9)
