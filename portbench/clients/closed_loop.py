"""One client in a closed loop: it submits a job, waits for its terminal
and a device sync, and submits the next, until ``seconds`` have passed;
the job running then completes and counts."""

from __future__ import annotations

import time


def window(submit, seconds: float, traffic: dict) -> list:
    """The window's job records, each from ``submit()`` (which runs one
    job to its end and returns its record, with ``t1`` its end on the
    ``time.perf_counter_ns`` clock)."""
    jobs = []
    deadline = time.perf_counter_ns() + int(seconds * 1e9)
    while not jobs or jobs[-1]["t1"] < deadline:
        jobs.append(submit())
    return jobs
