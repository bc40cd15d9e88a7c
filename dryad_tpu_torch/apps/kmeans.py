"""k-means on dense vectors — BASELINE.md config 5, on the PyTorch port.

Each iteration broadcasts the centroid table to every partition
(``cross_apply``: ONE ``slot_compact`` launch on the card), assigns each
point to its nearest centroid with one [cap, k] distance product, and
averages the points per centroid with a hash group-by (the partial means
hash-exchanged, then merged), under ``Context.do_while``: the broadcast +
all-reduce loop of the reference.  Same signatures and data as
``dryad_tpu/apps/kmeans.py``.  ``kmeans_stream`` is the out-of-core
form: the points stream, and the k-row centroid table iterates as a host
table through the streamed ``do_while``.

A cluster that loses every point drops out of the dataflow app's output
(its group is empty), while ``kmeans_numpy`` keeps its old centroid; the
JAX app does the same."""

from __future__ import annotations

import numpy as np
import torch

from dryad_tpu_torch.api.dataset import Context, Dataset
from dryad_tpu_torch.data.columnar import Batch
from dryad_tpu_torch.ops.kernels import _full_f32_matmul

__all__ = ["gen_points", "kmeans", "kmeans_stream", "kmeans_numpy"]


def gen_points(n: int, dim: int, k: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, dim).astype(np.float32) * 5
    assign = rng.randint(0, k, n)
    pts = centers[assign] + rng.randn(n, dim).astype(np.float32)
    return {"x": pts}, centers


def _assign_fn(points: Batch, cents: Batch) -> Batch:
    """Nearest-centroid assignment: one [cap, k] distance matrix from a
    product (||p-c||^2 = ||p||^2 - 2 p.c + ||c||^2; the argmin ignores
    ||p||^2).  The product is a library matmul, as the JAX package leaves
    it to XLA, in full f32: TF32 would round the distances to a 10-bit
    mantissa.  Padding rows are zeroed first (0 x NaN is NaN in the
    product) and centroid rows past the count never win; centroid rows
    arrive in hash order after the first iteration, so the argmin row
    maps back through ``cid``."""
    x = points.columns["x"]  # [cap, dim]
    c = cents.columns["cx"]  # [kcap, dim]
    kvalid = torch.arange(c.shape[0], device=c.device) < cents.count
    xm = torch.where(points.valid_mask()[:, None], x, 0.0)
    cm = torch.where(kvalid[:, None], c, 0.0)
    with _full_f32_matmul():
        dots = xm @ cm.T  # [cap, kcap]
    d = (cm * cm).sum(dim=1)[None, :] - 2.0 * dots
    d = torch.where(kvalid[None, :], d, torch.inf)
    row = torch.argmin(d, dim=1)
    cid = cents.columns["cid"].index_select(0, row).to(torch.int32)
    return Batch({"cid": cid, "x": x}, points.count)


def _assign_host(points: dict, cents: dict) -> dict:
    x = np.asarray(points["x"])
    c = np.asarray(cents["cx"])
    d = ((x[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    cid = np.asarray(cents["cid"])[d.argmin(1)].astype(np.int32)
    return {"cid": cid, "x": x}


def kmeans(ctx: Context, points: dict, k: int, n_iters: int = 10,
           init_centers: np.ndarray | None = None) -> np.ndarray:
    if init_centers is None:
        init_centers = np.asarray(points["x"])[:k].copy()
    pts = ctx.from_columns(points)
    cents0 = ctx.from_columns(
        {"cid": np.arange(k, dtype=np.int32),
         "cx": np.asarray(init_centers, np.float32)})
    # centroids are hash-distributed; any partition may hold several cids,
    # so size for the worst case (k is small)
    k_cap = k

    def body(cents: Dataset) -> Dataset:
        assigned = pts.cross_apply(cents, _assign_fn, host_fn=_assign_host,
                                   label="assign")
        return (assigned.group_by(["cid"], {"cx": ("mean", "x")})
                .with_capacity(k_cap))

    out = ctx.do_while(cents0.with_capacity(k_cap), body, n_iters=n_iters)
    t = out.collect()
    order = np.argsort(t["cid"])
    return np.asarray(t["cx"])[order]


def kmeans_stream(ctx: Context, pts_ds: Dataset, k: int,
                  init_centers: np.ndarray, n_iters: int = 10
                  ) -> np.ndarray:
    """k-means over streamed points: ``pts_ds`` is a STREAMED dataset
    (``read_store_stream``, optionally ``.cache()``-d); each iteration
    streams the points through the assignment (the centroid table
    materialized on the device as the build side) and a streamed
    group-by mean.  The device holds O(chunk_rows) points whatever
    their number."""
    cents0 = ctx.from_columns(
        {"cid": np.arange(k, dtype=np.int32),
         "cx": np.asarray(init_centers, np.float32)})

    def body(cents: Dataset) -> Dataset:
        assigned = pts_ds.cross_apply(cents, _assign_fn,
                                      host_fn=_assign_host, label="assign")
        return assigned.group_by(["cid"], {"cx": ("mean", "x")})

    t = ctx.do_while(cents0, body, n_iters=n_iters).collect()
    order = np.argsort(t["cid"])
    return np.asarray(t["cx"])[order]


def kmeans_numpy(points: dict, k: int, n_iters: int = 10,
                 init_centers: np.ndarray | None = None):
    x = np.asarray(points["x"])
    c = np.asarray(init_centers if init_centers is not None else x[:k].copy(),
                   np.float64)
    for _ in range(n_iters):
        d = ((x[:, None, :] - c[None, :, :]) ** 2).sum(-1)
        a = d.argmin(1)
        for j in range(k):
            sel = x[a == j]
            if len(sel):
                c[j] = sel.mean(0)
    return c
