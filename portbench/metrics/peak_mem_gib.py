"""torch.cuda.max_memory_allocated over the window, reset at its start,
in GiB; the resident tables are included."""


def read(rec):
    return rec["peak_bytes"] / 2**30
