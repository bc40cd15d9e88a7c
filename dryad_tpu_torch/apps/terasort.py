"""TeraSort — BASELINE.md config 2, on the PyTorch port.

Sampled split points, a range exchange on the key, and a local sort in
each partition: the planner's OrderBy lowering (``plan/planner.py``,
``parallel/shuffle.range_exchange``).  Records are a 10-byte printable
key (a string column) and an int32 payload.  Same signatures and data as
``dryad_tpu/apps/terasort.py``; its out-of-core form is not ported yet
(ROADMAP.md)."""

from __future__ import annotations

import numpy as np

from dryad_tpu_torch.api.dataset import Context, Dataset

__all__ = ["gen_records", "terasort_query", "terasort"]


def gen_records(n: int, seed: int = 0, key_len: int = 10):
    """Random printable keys (TeraGen equivalent)."""
    rng = np.random.RandomState(seed)
    keys_arr = rng.randint(ord(" "), ord("~") + 1, (n, key_len),
                           dtype=np.uint8)
    keys = [bytes(k) for k in keys_arr]
    payload = rng.randint(0, 2**31, n).astype(np.int32)
    return {"key": keys, "payload": payload}


def terasort_query(ds: Dataset) -> Dataset:
    return ds.order_by([("key", False)])


def terasort(ctx: Context, n: int, seed: int = 0):
    recs = gen_records(n, seed)
    ds = ctx.from_columns(recs, str_max_len=10)
    return terasort_query(ds).collect()
