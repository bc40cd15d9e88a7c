"""The executor: device-to-host reads of the stages' info vectors per job
(the run's ``host_reads``), over the window's jobs."""


def read(rec):
    reads = [j["host_reads"] for j in rec["jobs"] if "host_reads" in j]
    return sum(reads) / len(reads) if reads else None
