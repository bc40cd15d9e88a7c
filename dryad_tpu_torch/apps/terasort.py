"""TeraSort — BASELINE.md config 2, on the PyTorch port.

Sampled split points, a range exchange on the key, and a local sort in
each partition: the planner's OrderBy lowering (``plan/planner.py``,
``parallel/shuffle.range_exchange``).  Records are a 10-byte printable
key (a string column) and an int32 payload.  Same signatures and data as
``dryad_tpu/apps/terasort.py``.  ``terasort_ooc`` is the out-of-core
form: records generated chunk by chunk and sorted by
``exec/ooc.external_sort``, O(chunk_rows) rows on the device whatever
``n``."""

from __future__ import annotations

import numpy as np

from dryad_tpu_torch.api.dataset import Context, Dataset

__all__ = ["gen_records", "terasort_query", "terasort", "terasort_ooc"]


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


def terasort_ooc(n: int, chunk_rows: int, out_store: str | None = None,
                 seed: int = 0, n_buckets: int | None = None,
                 spill_dir: str | None = None, depth: int = 2,
                 device="cuda", info: dict | None = None):
    """Out-of-core TeraSort: records generated chunk by chunk (chunk i
    from seed ``seed * 1_000_003 + i``, the input never held whole),
    externally sorted with a bounded device working set, and streamed to
    ``out_store`` when given.  Returns the output store's meta, or an
    iterator of sorted host chunks.  ``info`` receives
    ``external_sort``'s counts."""
    from dryad_tpu_torch.exec import ooc

    n_chunks = -(-n // chunk_rows)

    def gen(i: int):
        rows = min(chunk_rows, n - i * chunk_rows)
        return gen_records(rows, seed=seed * 1_000_003 + i)

    src = ooc.ChunkSource.from_generator(gen, n_chunks, chunk_rows,
                                         str_max_len=10)
    sorted_chunks = ooc.external_sort(src, [("key", False)],
                                      n_buckets=n_buckets,
                                      spill_dir=spill_dir, depth=depth,
                                      device=device, info=info)
    if out_store is None:
        return sorted_chunks
    return ooc.write_chunks_to_store(
        out_store, sorted_chunks, src.schema,
        partitioning={"kind": "range", "keys": ["key"]})
