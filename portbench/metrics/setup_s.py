"""Seconds from the process's start to the first timed job's start:
imports, the tables made on the device, the warm-up jobs (and, in a
fresh checkout, the kernels' build)."""


def read(rec):
    return rec["setup_s"]
