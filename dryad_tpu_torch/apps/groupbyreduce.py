"""GroupByReduce — BASELINE.md config 3, on the PyTorch port.

Associative aggregation through the IDecomposable path: per-partition
combine, hash exchange of the partials, merge — planned by GroupByAgg's
decomposition.  Same signatures and data as
``dryad_tpu/apps/groupbyreduce.py``."""

from __future__ import annotations

import numpy as np

from dryad_tpu_torch.api.dataset import Context, Dataset

__all__ = ["gen_pairs", "groupbyreduce_query", "groupbyreduce"]


def gen_pairs(n: int, n_keys: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    return {"k": rng.randint(0, n_keys, n).astype(np.int32),
            "v": rng.randn(n).astype(np.float32)}


def groupbyreduce_query(ds: Dataset) -> Dataset:
    return ds.group_by(["k"], {
        "n": ("count", None), "s": ("sum", "v"), "m": ("mean", "v"),
        "lo": ("min", "v"), "hi": ("max", "v")})


def groupbyreduce(ctx: Context, n: int, n_keys: int, seed: int = 0):
    ds = ctx.from_columns(gen_pairs(n, n_keys, seed))
    return groupbyreduce_query(ds).collect()
